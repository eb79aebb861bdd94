"""Host runtime of the port: error types, the native library loader,
the telemetry base (``metrics``, ``events``, ``spans``) and the
streamed Parquet scan (``scan``)."""

from .errors import CapacityExceededError, CastException
from . import events  # noqa: F401  (bounded event journal)
from . import metrics  # noqa: F401  (process-wide telemetry registry)
from . import native  # noqa: F401  (ctypes loader of the host libraries)
from . import spans  # noqa: F401  (causal span tracing)

__all__ = ["CapacityExceededError", "CastException", "events", "metrics", "native", "spans"]
