"""Op-level tracing: NVTX ranges (the port's twin of the JAX package's
``runtime/trace.py`` ``op_range``).

The reference instruments hot host paths with NVTX ranges
(CUDF_FUNC_RANGE() on the parquet footer path, NativeParquetJni.cpp:
140,534,563,588,678) so nsight timelines show where host time goes.
Every API facade entry runs inside an ``op_range`` (api.py wires it
next to the fault-injection point).

On a machine with a CUDA card the range is ``torch.cuda.nvtx.range``.
Without one it is a null context: NVTX has no meaning on the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def op_range(name: str):
    """Named span for profiler timelines (NVTX push/pop)."""
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()
