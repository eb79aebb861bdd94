"""Distributed layer: device mesh, Spark hash partitioning, the exchange
and the distributed operators over it."""

from . import mesh  # noqa: F401
from . import spark_hash  # noqa: F401
from . import shuffle  # noqa: F401
