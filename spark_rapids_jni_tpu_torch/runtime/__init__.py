"""Host runtime of the port: error types and the native library loader."""

from .errors import CapacityExceededError, CastException

__all__ = ["CapacityExceededError", "CastException"]
