"""Op-level tracing: NVTX ranges and profiler timelines (the port's twin
of the JAX package's ``runtime/trace.py``).

The reference instruments hot host paths with NVTX ranges
(CUDF_FUNC_RANGE() on the parquet footer path, NativeParquetJni.cpp:
140,534,563,588,678) so nsight timelines show where host time goes.
The wiring here:

- ``op_range(name)``: ``torch.cuda.nvtx.range`` on a machine with a
  CUDA card, a null context without one (NVTX has no meaning on the
  CPU). While a ``timeline`` records, the range is also a
  ``torch.profiler.record_function`` span, so it shows in the
  timeline's Chrome trace beside the kernels it launched;
- every API facade entry and every ``Pipeline.run`` runs inside an
  ``op_range`` (api.py wires it next to the fault-injection point);
- ``timeline(log_dir)``: a ``torch.profiler`` capture of a block,
  written into ``log_dir`` as a Chrome trace;
- ``annotate_function(name)``: the decorator form of ``op_range``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading

import torch

_lock = threading.Lock()
# sprtcheck: guarded-by=_lock
_recording = 0  # timelines open in this process
_trace_ids = itertools.count(1)


def op_range(name: str):
    """Named span for profiler timelines (NVTX push/pop; also a
    profiler span while a ``timeline`` records)."""
    nvtx = torch.cuda.is_available()
    if not _recording:
        return torch.cuda.nvtx.range(name) if nvtx else contextlib.nullcontext()
    stack = contextlib.ExitStack()
    if nvtx:
        stack.enter_context(torch.cuda.nvtx.range(name))
    stack.enter_context(torch.profiler.record_function(name))
    return stack


@contextlib.contextmanager
def timeline(log_dir: str, device="cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` as ``timeline-<pid>-<n>.trace.json`` (open at
    ui.perfetto.dev or chrome://tracing). ``device`` is where the
    block's tensors lie: on a card the trace holds the CPU and the CUDA
    activity, ``device="cpu"`` records the CPU alone. Yields the
    profiler; its ``trace_path`` is set once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    from ..columnar.column import resolve_device

    global _recording
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"timeline-{os.getpid()}-{next(_trace_ids)}.trace.json")
    with _lock:
        _recording += 1
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        with _lock:
            _recording -= 1
    prof.export_chrome_trace(path)
    prof.trace_path = path


def annotate_function(name: str):
    """Decorator form of ``op_range``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with op_range(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
