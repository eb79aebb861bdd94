"""Hash partitioning (the exchange itself is not ported yet)."""
