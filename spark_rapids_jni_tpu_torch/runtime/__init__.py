"""Host runtime of the port: error types, the native library loader,
the telemetry base (``metrics``, ``events``, ``spans``), the
streamed Parquet scan (``scan``), and the fused-execution runtime
(``pipeline``, ``resource``, ``faultinj``, ``flight``, ``trace``,
``explain``)."""

from .errors import CapacityExceededError, CastException, RetryOOMError
from . import events  # noqa: F401  (bounded event journal)
from . import metrics  # noqa: F401  (process-wide telemetry registry)
from . import native  # noqa: F401  (ctypes loader of the host libraries)
from . import spans  # noqa: F401  (causal span tracing)

__all__ = [
    "CapacityExceededError",
    "CastException",
    "RetryOOMError",
    "events",
    "metrics",
    "native",
    "spans",
]
