"""Host runtime of the port: error types, the native library loader,
the telemetry base (``metrics``, ``events``, ``spans``), live
introspection (``diag``, ``sampler``, ``traceview``), the streamed
Parquet scan (``scan``), and the fused-execution runtime
(``pipeline``, ``resource``, ``faultinj``, ``flight``, ``trace``,
``explain``)."""

from .errors import CapacityExceededError, CastException, RetryOOMError
from . import diag  # noqa: F401  (live diagnostics endpoint)
from . import events  # noqa: F401  (bounded event journal)
from . import flight  # noqa: F401  (failure flight recorder)
from . import metrics  # noqa: F401  (process-wide telemetry registry)
from . import native  # noqa: F401  (ctypes loader of the host libraries)
from . import pipeline  # noqa: F401  (fused query pipelines + plan cache)
from . import resource  # noqa: F401  (task-scoped resource manager)
from . import sampler  # noqa: F401  (span-stack sampling profiler)
from . import spans  # noqa: F401  (causal span tracing)
from . import traceview  # noqa: F401  (journal -> Chrome-trace JSON)

__all__ = [
    "CapacityExceededError",
    "CastException",
    "RetryOOMError",
    "diag",
    "events",
    "flight",
    "metrics",
    "native",
    "pipeline",
    "resource",
    "sampler",
    "spans",
    "traceview",
]
