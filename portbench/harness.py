"""The benchmark's core: one run of one cell of ``BENCHMARK.json``.

Everything a cell needs is found by name, so a later cell, configuration,
traffic mix or per-layer metric is new files and new entries alone:

- configuration ``<c>``: ``configs/<c>.json`` (sizes, source, guarantees,
  what is assumed and reduced), ``configs/<c>_ref.py`` (the data made from
  the seed, the plain reference and its lower-precision control; it
  imports nothing of the port) and ``configs/<c>.py`` (the port's side:
  the tables over that data, one callable per entry, the final merge);
- traffic mix ``<t>``: ``traffic/<t>.json``, the parameters that the
  generator it names (``generators/<g>.py``) reads;
- per-layer metric ``<m>``: ``metrics/<m>.py``, whose ``read(ctx)``
  returns a number or None when it finds nothing to read.

A run: the data from the seed, the port's query over it, a warm-up of
every batch shape on every task (and of the query's first stage of a
pass, if it has one), the measured window, an optional traced
slice, then the program's state freed and every answer that came back
held against the reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import random
import statistics
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# top-level module names no module of a run may load: the JAX stack, the
# JAX package (a whole name: the port's own name starts with it) and the
# JAX package's harness
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_rapids_jni_tpu", "benchmarks", "chip_smoke")
GIB = float(1 << 30)
# final merges of the window's passes that a run checks
MERGES = 3


def load_spec(repo: str = REPO) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(*parts: str):
    """A module of the benchmark by its file, under a private name (a
    metric's file name holds dots)."""
    path = os.path.join(HERE, *parts)
    name = "portbench_" + "_".join(parts).replace(".", "_").replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """One cell's files, found by the names in BENCHMARK.json.
    ``overrides`` replaces keys of the configuration's and the traffic
    mix's data (the tests run the cells at small sizes on the CPU)."""

    def __init__(self, spec: dict, workload: str, overrides: dict | None = None):
        overrides = overrides or {}
        self.spec = spec
        self.workload = find(spec["workloads"], workload, "workload")
        self.config = find(spec["configs"], self.workload["config"], "config")
        name = self.config["name"]
        self.cfg = {**load_json("configs", name + ".json"), **overrides.get("config", {})}
        self.traffic = {**load_json("traffic", self.workload["traffic"] + ".json"),
                        **overrides.get("traffic", {})}
        self.ref = load_module("configs", name + "_ref.py")
        self.port = load_module("configs", name + ".py")
        self.generator = load_module("generators", self.traffic["generator"] + ".py")
        self.end_to_end = [m for m in spec["end_to_end"] if self.has(m)]
        self.per_layer = [m for m in spec["per_layer"] if self.has(m)]

    def has(self, metric: dict) -> bool:
        """Whether the cell reports ``metric``: its ``workloads``, or
        every cell that reports the end-to-end metric it moves."""
        if "workloads" in metric:
            return self.workload["name"] in metric["workloads"]
        moves = metric.get("moves")
        if moves is None:
            return True
        return any(m["name"] == moves and self.has(m) for m in self.spec["end_to_end"])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _p95(values):
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def _same(got, want) -> bool:
    return got is not None and got == want


def check(log, ref_batch, ref_final) -> dict:
    """Every answer that came back, against the reference's answer for
    its batch, and every final merge against the reference's merge of
    the same batches. Counts: answers that differ, batches whose call
    raised, finals that differ or raised."""
    wrong = sum(1 for b in log.batches if b["error"] is None
                and not _same(b["answer"], ref_batch[b["index"]]))
    raised = sum(1 for b in log.batches if b["error"] is not None)
    finals_wrong = sum(1 for f in log.finals if f["error"] is not None
                       or not _same(f["answer"], ref_final(f["indices"])))
    return {"wrong_batches": wrong, "failed_batches": raised, "wrong_finals": finals_wrong}


def graph_pool_free_bytes(dev) -> int:
    """Bytes of the device's private (CUDA graph) pools' segments that no
    live tensor holds."""
    return sum(s["total_size"] - s["allocated_size"] for s in torch.cuda.memory_snapshot()
               if s["device"] == dev.index and tuple(s["segment_pool_id"]) != (0, 0))


def count_ops(call) -> int:
    """torch ops that ``call()`` dispatches on this thread."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.count += 1
            return func(*args, **(kwargs or {}))

    counter = Counter()
    with counter:
        call()
    return counter.count


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, spec=None,
             device: str = "cuda", overrides: dict | None = None, wrap_entry=None,
             t_process: float | None = None) -> tuple:
    """One run of a cell: (the result line as a dict, the window's Log).
    ``wrap_entry(entry, query)`` lets a test break the timed path."""
    t_process = time.perf_counter() if t_process is None else t_process
    spec = spec or load_spec()
    cell = Cell(spec, workload, overrides)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    traffic = cell.traffic
    n_tasks = int(traffic["tasks"])

    stamps = [("imports", time.perf_counter())]
    data = cell.ref.make_data(cell.cfg, seed, dev)
    _sync(dev)
    stamps.append(("data", time.perf_counter()))
    query = cell.port.prepare(data, cell.cfg, traffic, dev)
    _sync(dev)
    stamps.append(("query", time.perf_counter()))
    # the resident inputs (a build side is each pass's own work)
    input_bytes = torch.cuda.memory_allocated(dev) if on_card else 0
    entry = query.entries[traffic["entry"]]
    if wrap_entry is not None:
        entry = wrap_entry(entry, query)
    streams = [torch.cuda.Stream(dev) for _ in range(n_tasks)] if on_card else None
    gen = cell.generator
    n_batches = len(query.batches)

    # warm-up: every batch shape on every task's stream (the final merges
    # run after the window, so none warms here)
    warm = gen.drive(query, entry, n_tasks, gen.warm_schedule(query.batches, n_tasks),
                     passes=1, streams=streams, merge=False)
    _sync(dev)
    stamps.append(("warm-up", time.perf_counter()))

    from spark_rapids_jni_tpu_torch.runtime import metrics as port_metrics

    setup_peak = torch.cuda.max_memory_reserved(dev) if on_card else 0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        pool_free = graph_pool_free_bytes(dev)
    misses0 = port_metrics.counter_value("pipeline.plan_cache_miss")
    gc.collect()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    print("set-up s: " + ", ".join(
        f"{name} {t - last:.3f}" for (name, t), (_, last)
        in zip(stamps, [("process", t_process)] + stamps)), file=sys.stderr, flush=True)
    rng = random.Random(seed)

    def pick(finished):
        """The window's last finished pass and MERGES - 1 more drawn from
        the seed: every pass merges the same batches."""
        if len(finished) <= MERGES:
            return list(finished)
        return sorted(rng.sample(finished[:-1], MERGES - 1), key=lambda f: f[0]) + [finished[-1]]

    log = gen.drive(query, entry, n_tasks, list(range(n_batches)), deadline=t0 + seconds,
                    streams=streams, pick=pick)
    _sync(dev)
    t_end = t0 + seconds
    window_peak = torch.cuda.max_memory_reserved(dev) if on_card else 0
    if on_card:
        # what the tasks held beyond the inputs at the window's peak: the
        # allocations above them, and the CUDA graph pools' reserved
        # bytes that no live tensor holds (the captured chains' scratch,
        # which the allocation counters do not see)
        pool_free = max(pool_free, graph_pool_free_bytes(dev))
        work_bytes = torch.cuda.max_memory_allocated(dev) - input_bytes + pool_free
        print(f"memory: inputs {input_bytes}, peak allocated "
              f"{torch.cuda.max_memory_allocated(dev)}, graph pools' free {pool_free}, "
              f"peak reserved {window_peak}", file=sys.stderr, flush=True)
    misses = port_metrics.counter_value("pipeline.plan_cache_miss") - misses0
    done = [b for b in log.batches if b["error"] is None and b["end"] <= t_end]
    merges = sorted((f["end"] - f["start"]) * 1e3 for f in log.finals)
    stages = [round((st["end"] - st["start"]) * 1e3, 3) for st in log.stages]
    lat = sorted((b["end"] - b["start"]) * 1e3 for b in done)
    ends = sorted(b["end"] for b in done)
    gap = max((b - a for a, b in zip([t0] + ends, ends)), default=0.0) * 1e3
    print(f"window: {len(done)} batches done, {len(log.finals)} merges"
          + (f", batch ms median {lat[len(lat) // 2]:.3f}, max {lat[-1]:.3f}, "
             f"longest wait for a result {gap:.3f}" if lat else "")
          + (f", merge ms median {merges[len(merges) // 2]:.3f}" if merges else "")
          + (f", first stage of each pass ms {stages}" if stages else ""),
          file=sys.stderr, flush=True)
    metrics = {}
    if not trace:
        values = {
            "rows_per_s": sum(b["rows"] for b in done) / seconds,
            "batch_p95_ms": _p95(lat),
            "peak_work_gib": work_bytes / GIB if on_card else None,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_line = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)}
    breakdown, ctx = None, None
    logs = [warm, log]
    if trace:
        sl = load_module("tracing.py").profile_slice(
            gen, query, entry, n_tasks, int(traffic["profile_batches"]), streams, dev)
        logs.append(sl["log"])
        ctx = {"counters": {"pipeline.plan_cache_miss": misses},
               "ops_per_batch": count_ops(lambda: entry(0)), "slice": sl, "query": query,
               "cfg": cell.cfg, "traffic": traffic, "peaks": load_json("peaks.json")}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"] + ".py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_line["busy_s"] = sl["busy_s"]
        device_line["window_s"] = sl["window_s"]
        breakdown = {"device_ops": sl["device_ops"], "idle_gaps": sl["idle_gaps"]}
        if on_card:
            device_line["memory_peak_bytes"] = max(device_line["memory_peak_bytes"],
                                                   torch.cuda.max_memory_reserved(dev))

    # the program's state goes before the reference runs
    del entry, query, warm, ctx
    from spark_rapids_jni_tpu_torch.runtime import pipeline as port_pipeline

    port_pipeline.plan_cache_clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref_all = cell.ref.Reference(data, cell.cfg, cell.port.batch_bounds(cell.cfg, traffic))
    ref_batch = {i: ref_all.batch_answer(i)
                 for i in sorted({b["index"] for lg in logs for b in lg.batches})}
    finals = {}

    def ref_final(indices):
        key = tuple(sorted(indices))
        if key not in finals:
            finals[key] = ref_all.final_answer([ref_batch[i] for i in key])
        return finals[key]

    checks = {}
    for lg in logs:
        for k, v in check(lg, ref_batch, ref_final).items():
            checks[k] = checks.get(k, 0) + v
    attempted = sum(1 for b in log.batches if b["start"] < t_end)
    failed = sum(1 for b in log.batches if b["start"] < t_end and b["error"] is not None)
    correct = all(v == 0 for v in checks.values()) and len(done) > 0
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_line}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    return result, log

