"""The traced slice of a ``--trace 1`` run: a bounded number of batches run
by the cell's tasks under ``torch.profiler``, reduced to what the
per-layer metrics and the result's ``breakdown`` read. The slice probes
the window's last first stage (q5's build side): a stage made once a pass
would weigh on a part of a pass out of its share.

- ``busy_s``: the union of the device's operation intervals (kernels,
  copies, sets) in the slice;
- ``window_s``: the slice's length on the host clock, from the first
  task's start to the last result on the host (the device is idle at
  both ends, since the slice starts and ends synchronised);
- ``kernels``: every device operation as (start us, end us, name);
- ``device_ops``: the ten device operations that took most time, by
  the names the profiler gives, summed;
- ``idle_gaps``: the device's idle gaps inside the slice, each named
  by the innermost host operation (of any thread) running at its
  middle, summed by that name, the ten longest.
"""

from __future__ import annotations

import time

import numpy as np
import torch

TOP = 10
# the idle gaps named one by one; the rest are summed under SHORTER
NAMED_GAPS = 500
SHORTER = "(shorter gaps)"
NO_HOST_OP = "(no host op recorded)"


def _profiler(on_card: bool):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    # host ops of every task's thread, not only the main thread's
    return profile(activities=acts,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def merged(intervals):
    """Sorted (start, end) intervals merged where they overlap."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_slice(gen, query, entry, n_tasks: int, n_batches: int, streams, dev) -> dict:
    from torch.autograd import DeviceType

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
    with _profiler(on_card) as prof:
        t0 = time.perf_counter()
        log = gen.drive(query, entry, n_tasks, list(range(min(n_batches, len(query.batches)))),
                        passes=1, streams=streams, merge=False, begin=False)
        if on_card:
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    events = prof.events()
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == DeviceType.CUDA)
    busy = merged([(s, e) for s, e, _ in kernels])
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_name = {}
    for s, e, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    device_ops = sorted(([n[:160], v] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP]

    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.time_range.end > e.time_range.start]
    gaps = [(b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    gaps.sort(reverse=True)
    named = {}
    if host:
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        hd = he - hs
        for length, mid in gaps[:NAMED_GAPS]:
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = host[cover[np.argmin(hd[cover])]][2] if len(cover) else NO_HOST_OP
            named[name] = named.get(name, 0.0) + length / 1e6
    rest = sum(g[0] for g in gaps[NAMED_GAPS:]) / 1e6
    if rest:
        named[SHORTER] = rest
    idle_gaps = sorted(([n[:160], v] for n, v in named.items()), key=lambda x: -x[1])[:TOP]
    return {"log": log, "busy_s": busy_s, "window_s": window_s, "kernels": kernels,
            "device_ops": device_ops, "idle_gaps": idle_gaps}
