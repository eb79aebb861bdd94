"""Limb arithmetic of the port (PyTorch twins of the JAX package's
``utils/int128.py`` and ``utils/int256.py``)."""
