"""Process-wide telemetry registry: named counters, gauges, timers and
histograms (the port's copy of the JAX package's ``runtime/metrics.py``:
same instruments, same sink modes and environment knobs, same JSONL
schema, so one dashboard reads both packages).

The reference repo's observability is NVTX ranges plus the CUPTI fault
tool; the upstream spark-rapids plugin layers per-operator ``GpuMetric``
accumulators on top so the Spark UI can answer "which op burned the
time, how many retries fired". This module is that accumulator layer:

- ``counter(name)`` / ``gauge(name)`` / ``timer(name)`` /
  ``histogram(name)``: get-or-create named instruments. Counters are
  monotonic ints, gauges are last-set floats, timers fold each
  observation into min/max/sum/count (the GpuMetric histogram shape,
  without per-sample storage), histograms additionally bucket each
  observation into fixed log-spaced bins so ``quantile(q)`` answers
  p50/p95/p99 live — still without per-sample storage.
- ``record_op`` folds one op sample (``op.<Class.method>`` timer +
  call/row/byte counters + the ``op_end`` journal event); producers
  such as ``ops/regex.py`` and ``runtime/scan.py`` publish their own
  counters, gauges and timers into the same registry.

The JAX package also hooks XLA's compile entry here
(``install_compile_hook``, with ``set_compile_context``) to count
compiles and persistent-cache hits. Eager PyTorch has no compile
boundary to hook, so the port drops the hook and its two context
helpers; the ``compile.*`` names stay in the documented vocabulary and
simply never fire here.

Sink control — ``SPARK_JNI_TPU_METRICS`` env var, resolved lazily at
first use (override programmatically with ``configure()``):

- ``off``: recording disabled; the fast path is one enabled() check,
- ``mem`` (default): in-memory only; read with ``snapshot()`` /
  ``report()`` or export with ``dump_jsonl(path)``,
- ``/path.jsonl``: ``mem`` plus a streaming JSONL sink — journal
  events append as they happen and the final registry snapshot is
  flushed at interpreter exit (atexit), so a crashed run still leaves
  its event trail on disk.

Stable JSONL schema (version ``SCHEMA_VERSION``; validated by
``validate_line`` / ``validate_jsonl``; documented in
docs/OBSERVABILITY.md). v2 adds the causal span fields
(``runtime/spans.py``) to every event line; v1 lines (no span fields)
remain accepted so pre-v2 journals stay readable:

    {"v":2,"kind":"counter","name":str,"value":int>=0}
    {"v":2,"kind":"gauge","name":str,"value":number}
    {"v":2,"kind":"timer","name":str,"count":int>0,
     "sum_ms":num,"min_ms":num,"max_ms":num}
    {"v":2,"kind":"histogram","name":str,"count":int>0,
     "sum_ms":num,"min_ms":num,"max_ms":num,"buckets":{le:int}}
     # buckets: CUMULATIVE counts keyed by the bucket's upper bound
     # (formatted float, plus the final "+Inf" == count), written in
     # ascending bound order — the Prometheus histogram shape
    {"v":2,"kind":"event","event":str,"op":str|null,"ts":unix_seconds,
     "span_id":int,"parent_id":int|null,"task_id":int|null,
     "attrs":object}
"""

from __future__ import annotations

import atexit
import bisect
import json
import math
import os
import threading
from typing import Dict, Optional

_ENV_VAR = "SPARK_JNI_TPU_METRICS"
SCHEMA_VERSION = 2  # v2: events carry span_id/parent_id/task_id
_ACCEPTED_VERSIONS = (1, SCHEMA_VERSION)  # v1 journals stay readable

_KINDS = ("counter", "gauge", "timer", "histogram", "event")


# --------------------------------------------------------------------
# instruments


class Counter:
    """Monotonic named counter (GpuMetric SUM accumulator analog)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1):
        with _lock:
            self.value += int(n)


class Gauge:
    """Last-written value (e.g. a pool size or capacity watermark)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float):
        with _lock:
            self.value = float(v)


class Timer:
    """Wall/device duration accumulator: min/max/sum/count over
    observations in milliseconds — enough to answer total/mean/worst
    without per-sample storage."""

    __slots__ = ("name", "count", "sum_ms", "min_ms", "max_ms")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0

    def observe(self, ms: float):
        ms = float(ms)
        with _lock:
            self.count += 1
            self.sum_ms += ms
            self.min_ms = min(self.min_ms, ms)
            self.max_ms = max(self.max_ms, ms)


# Fixed log-spaced bucket layout shared by EVERY histogram — one
# global layout (vs per-instrument) keeps the JSONL/Prometheus series
# comparable across instruments and processes. Bounds are upper edges:
# bucket k holds observations in (HIST_BOUNDS[k-1], HIST_BOUNDS[k]];
# everything past the last bound lands in the +Inf overflow bucket.
# growth 2^(1/4) per bucket bounds the quantile estimate's relative
# error at sqrt(growth)-1 ~ 9% (the estimate is the geometric midpoint
# of the bucket containing the target rank) — the "one histogram
# bucket" tolerance the serving SLO acceptance is stated in.
HIST_FIRST_MS = 0.01
HIST_GROWTH = 2.0 ** 0.25
HIST_BUCKETS = 124  # top bound ~ 2.1e7 ms (~5.9 h): serving e2e fits
HIST_BOUNDS = tuple(
    HIST_FIRST_MS * HIST_GROWTH ** i for i in range(HIST_BUCKETS)
)


def _bucket_index(ms: float) -> int:
    """Index into a histogram's counts array for one observation."""
    if ms <= HIST_FIRST_MS:
        return 0
    return bisect.bisect_left(HIST_BOUNDS, ms)


class Histogram:
    """Fixed log-bucketed latency distribution (milliseconds): the
    GpuMetric histogram accumulator with live quantile estimation and
    no per-sample storage. ``observe`` is O(log buckets) under the
    registry lock; ``quantile(q)`` walks the cumulative counts and
    returns the geometric midpoint of the bucket holding the target
    rank (clamped to the observed min/max), so the estimate is within
    one bucket — a ``HIST_GROWTH`` factor — of the true sample
    quantile."""

    __slots__ = ("name", "counts", "count", "sum_ms", "min_ms", "max_ms")

    def __init__(self, name: str):
        self.name = name
        # counts[k] = observations in bucket k; counts[-1] = overflow
        self.counts = [0] * (HIST_BUCKETS + 1)
        self.count = 0
        self.sum_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0

    def observe(self, ms: float):
        ms = float(ms)
        idx = _bucket_index(ms)
        with _lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum_ms += ms
            self.min_ms = min(self.min_ms, ms)
            self.max_ms = max(self.max_ms, ms)

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 <= q <= 1) in ms; None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile out of range: {q!r}")
        with _lock:
            n = self.count
            if n == 0:
                return None
            counts = list(self.counts)
            lo_obs, hi_obs = self.min_ms, self.max_ms
        # the (ceil(q*(n-1))+1)-th smallest sample: same order-statistic
        # family numpy's default linear interpolation draws from, so
        # the two agree to within one bucket on continuous data
        target = int(math.ceil(q * (n - 1))) + 1
        cum = 0
        for k, c in enumerate(counts):
            cum += c
            if cum >= target:
                if k >= HIST_BUCKETS:  # overflow bucket: no upper edge
                    return hi_obs
                hi = HIST_BOUNDS[k]
                lo = HIST_BOUNDS[k - 1] if k else hi / HIST_GROWTH
                est = math.sqrt(lo * hi)
                return min(max(est, lo_obs), hi_obs)
        return hi_obs  # unreachable: cum(n buckets) == n >= target

    def cumulative_buckets(self) -> "list[tuple[str, int]]":
        """Non-empty buckets as ``(le, cumulative_count)`` in bound
        order, ending with ``("+Inf", count)`` — the exposition shape
        shared by ``snapshot()``, the JSONL dump, and ``prom_text``.
        Empty buckets are elided (the layout is fixed and huge; the
        cumulative values lose nothing by skipping flat runs)."""
        with _lock:
            counts = list(self.counts)
            n = self.count
        out = []
        cum = 0
        for k, c in enumerate(counts[:-1]):
            if c:
                cum += c
                out.append((f"{HIST_BOUNDS[k]:.6g}", cum))
        out.append(("+Inf", n))
        return out


# --------------------------------------------------------------------
# registry (process-wide; one lock — instruments are touched at host
# op boundaries, never inside a device program)

_lock = threading.RLock()
# sprtcheck: guarded-by=_lock
_counters: Dict[str, Counter] = {}
# sprtcheck: guarded-by=_lock
_gauges: Dict[str, Gauge] = {}
# sprtcheck: guarded-by=_lock
_timers: Dict[str, Timer] = {}
# sprtcheck: guarded-by=_lock
_histograms: Dict[str, Histogram] = {}


class _Noop:
    """Returned by the factories when the sink is ``off``: producers
    (resource retry driver, collect points, faultinj) can publish
    unconditionally and still honor the off switch."""

    __slots__ = ()

    def inc(self, n: int = 1):
        pass

    def set(self, v: float):
        pass

    def observe(self, ms: float):
        pass

    def quantile(self, q: float):
        return None

    def cumulative_buckets(self):
        return []


_NOOP = _Noop()


def counter(name: str) -> Counter:
    if not enabled():
        return _NOOP
    with _lock:
        c = _counters.get(name)
        if c is None:
            c = _counters[name] = Counter(name)
        return c


def gauge(name: str) -> Gauge:
    if not enabled():
        return _NOOP
    with _lock:
        g = _gauges.get(name)
        if g is None:
            g = _gauges[name] = Gauge(name)
        return g


def timer(name: str) -> Timer:
    if not enabled():
        return _NOOP
    with _lock:
        t = _timers.get(name)
        if t is None:
            t = _timers[name] = Timer(name)
        return t


def histogram(name: str) -> Histogram:
    if not enabled():
        return _NOOP
    with _lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = Histogram(name)
        return h


def counter_value(name: str) -> int:
    """Read a counter without creating it (0 when absent)."""
    c = _counters.get(name)
    return 0 if c is None else c.value


def gauge_value(name: str) -> float:
    """Read a gauge without creating it (0.0 when absent)."""
    g = _gauges.get(name)
    return 0.0 if g is None else g.value


def timer_stats(name: str) -> Optional[dict]:
    """{"count","sum_ms","min_ms","max_ms"} or None when absent."""
    t = _timers.get(name)
    if t is None or t.count == 0:
        return None
    return {
        "count": t.count,
        "sum_ms": t.sum_ms,
        "min_ms": t.min_ms,
        "max_ms": t.max_ms,
    }


def histogram_stats(name: str) -> Optional[dict]:
    """{"count","sum_ms","min_ms","max_ms","p50","p95","p99"} or None
    when absent/empty — the read side for ``/sessions`` rows, ``/slo``
    and the report, without creating the instrument."""
    h = _histograms.get(name)
    if h is None or h.count == 0:
        return None
    return {
        "count": h.count,
        "sum_ms": h.sum_ms,
        "min_ms": h.min_ms,
        "max_ms": h.max_ms,
        "p50": h.quantile(0.5),
        "p95": h.quantile(0.95),
        "p99": h.quantile(0.99),
    }


def histogram_quantile(name: str, q: float) -> Optional[float]:
    """Estimated quantile of a histogram (None when absent/empty)."""
    h = _histograms.get(name)
    if h is None:
        return None
    return h.quantile(q)


def histogram_totals() -> "tuple[int, int]":
    """(instrument count, total observations) — the cheap health
    aggregate shared by ``report()``'s footer and ``/healthz``."""
    with _lock:
        return (
            len(_histograms),
            sum(h.count for h in _histograms.values()),
        )


def drop_gauges(prefix: str) -> None:
    """Remove every gauge whose name starts with ``prefix``. For
    publishers of VARIABLE-CARDINALITY gauge families (the per-device
    ``device.<d>.*`` collect metrics): a re-publish over a smaller
    member set must not leave the old members' last values looking
    current in snapshot()/report()/flight bundles."""
    with _lock:
        for k in [k for k in _gauges if k.startswith(prefix)]:
            del _gauges[k]


def reset() -> None:
    """Drop all instruments (tests). The event journal has its own
    ``events.clear()``; sink mode is untouched."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _timers.clear()
        _histograms.clear()


# --------------------------------------------------------------------
# sink mode

_mode: Optional[str] = None  # None = unresolved; "off" | "mem" | path
_sink_lock = threading.Lock()
_sink_file = None
_atexit_armed = False
_sink_errors = 0  # file-sink write/flush failures (observability of loss)

# file-sink size-capped rotation: a long-running
# stream must not grow the journal without bound. When the active sink
# file exceeds SPARK_JNI_TPU_METRICS_MAX_MB (default 256), it rotates
# to <path>.1 (one generation kept — the pair bounds disk at ~2x the
# cap) and a fresh file continues the stream. traceview.load_journal
# and validate_jsonl read the rotated pair.
_MAX_MB_ENV = "SPARK_JNI_TPU_METRICS_MAX_MB"
DEFAULT_SINK_MAX_MB = 256
_sink_bytes = 0  # bytes written to the CURRENT sink generation
_sink_max_bytes: Optional[int] = None  # resolved lazily from the env
_rotations = 0


def sink_write_errors() -> int:
    """How many file-sink write/flush attempts failed since process
    start — a nonzero count means the on-disk journal is INCOMPLETE
    even though the run "worked" (the sink degrades to mem rather than
    failing the workload). Surfaced by ``report()``."""
    return _sink_errors


def sink_rotations() -> int:
    """How many times the size-capped file sink rotated to <path>.1
    (also counted by the ``journal.rotations`` counter)."""
    return _rotations


def rotated_paths(path: str) -> "list[str]":
    """The readable generations of a (possibly rotated) sink stream,
    oldest first — THE definition of the rotation layout, shared by
    every reader (``validate_jsonl`` here, ``traceview.load_journal``)
    so they cannot drift from the rotation that writes it."""
    paths = [path]
    if os.path.exists(path + ".1"):
        paths.insert(0, path + ".1")
    return paths


def _sink_cap_bytes() -> int:
    global _sink_max_bytes
    if _sink_max_bytes is None:
        raw = os.environ.get(_MAX_MB_ENV, "").strip()
        try:
            mb = float(raw) if raw else DEFAULT_SINK_MAX_MB
        except ValueError:
            import logging

            logging.getLogger("spark_rapids_jni_tpu_torch.metrics").warning(
                "unparseable %s value %r; using %d MB",
                _MAX_MB_ENV, raw, DEFAULT_SINK_MAX_MB,
            )
            mb = DEFAULT_SINK_MAX_MB
        _sink_max_bytes = max(int(mb * 1024 * 1024), 4096)
    return _sink_max_bytes


def _maybe_rotate_locked() -> None:
    """Rotate the sink file to <path>.1 once it exceeds the size cap.
    Caller holds _sink_lock and the sink file is open. Rotation
    failures count as sink errors and the stream keeps appending to
    the oversized file — loss of the bound, never loss of events."""
    global _sink_file, _sink_bytes, _sink_errors, _rotations
    if _sink_bytes < _sink_cap_bytes() or _sink_file is None:
        return
    path = _sink_file.name
    try:
        _sink_file.close()
        os.replace(path, path + ".1")
        _sink_file = open(path, "a", buffering=1)
        _sink_bytes = 0
        _rotations += 1
    except OSError:
        _sink_errors += 1
        if _sink_file is None or _sink_file.closed:
            try:
                _sink_file = open(path, "a", buffering=1)
            except OSError:
                _sink_file = None
        return
    counter("journal.rotations").inc()


def _normalize_mode(m: str) -> str:
    """Map a raw mode string to off/mem/path. Disable-intent spellings
    ("OFF", "0", "false", "none") all disable; a value that is neither
    a known keyword nor path-shaped falls back to mem with a warning
    instead of silently creating a stray file named after the typo."""
    m = m.strip()  # shell command substitution loves stray whitespace
    low = m.lower()
    if low in ("off", "0", "false", "none", "no", "disabled"):
        return "off"
    if low in ("mem", "memory", "on", "true", "1"):
        return "mem"
    if os.sep in m or low.endswith(".jsonl"):
        return m
    import logging

    logging.getLogger("spark_rapids_jni_tpu_torch.metrics").warning(
        "unrecognized %s value %r (expected off|mem|/path.jsonl); "
        "using mem", _ENV_VAR, m,
    )
    return "mem"


def mode() -> str:
    """Resolve the sink mode (lazily, from SPARK_JNI_TPU_METRICS)."""
    global _mode
    if _mode is None:
        m = os.environ.get(_ENV_VAR, "").strip() or "mem"
        _set_mode(_normalize_mode(m))
    return _mode


def _close_sink_locked():
    """Close the sink handle, swallowing I/O errors — close() flushes
    and can re-raise (e.g. ENOSPC), and no sink-teardown path is
    allowed to fail the workload. Caller holds _sink_lock."""
    global _sink_file, _sink_errors
    if _sink_file is not None:
        try:
            _sink_file.close()
        except OSError:
            _sink_errors += 1
        _sink_file = None


def _set_mode(m: str):
    global _mode, _atexit_armed, _sink_max_bytes
    with _sink_lock:
        if _sink_file is not None and _sink_file.name != m:
            _close_sink_locked()
        _mode = m
        _sink_max_bytes = None  # re-resolve the rotation cap lazily
    if m not in ("off", "mem"):
        # file sink: flush the registry snapshot at interpreter exit so
        # the on-disk journal ends with the final counter/timer state
        if not _atexit_armed:
            atexit.register(_flush_file_sink)
            _atexit_armed = True


def configure(m: str) -> str:
    """Set the sink mode programmatically (tests / the Java facade):
    ``off``, ``mem``, or a JSONL path. Returns the previous mode."""
    prev = mode()
    _set_mode(_normalize_mode(m))
    return prev


def enabled() -> bool:
    return mode() != "off"


def _write_line(obj: dict) -> None:
    """Append one JSONL line to the file sink (no-op in off/mem). An
    unwritable sink path degrades to mem with one warning — telemetry
    must never fail the workload it observes."""
    global _sink_file, _sink_errors, _sink_bytes
    m = mode()
    if m in ("off", "mem"):
        return
    try:
        with _sink_lock:
            if _sink_file is None:
                _sink_file = open(m, "a", buffering=1)
                try:
                    _sink_bytes = os.path.getsize(m)
                except OSError:
                    _sink_bytes = 0
            line = json.dumps(obj, default=str) + "\n"
            _sink_file.write(line)
            _sink_bytes += len(line)
            _maybe_rotate_locked()
    except OSError as e:
        with _sink_lock:  # the counter of LOSS must not itself lose
            _sink_errors += 1
        import logging

        logging.getLogger("spark_rapids_jni_tpu_torch.metrics").warning(
            "metrics sink %s unwritable (%s); falling back to mem", m, e
        )
        _set_mode("mem")


def _flush_file_sink() -> None:
    m = _mode
    if m is None or m in ("off", "mem"):
        return
    for line in _snapshot_lines():
        _write_line(line)
    with _sink_lock:
        _close_sink_locked()


# --------------------------------------------------------------------
# op samples (the facade wrapper's single call)


def _rows_bytes(obj) -> "tuple[int, int]":
    """Best-effort (rows, device bytes) of a Column/Table/sequence
    thereof — metadata reads only, never a device sync."""
    rows = nbytes = 0
    if obj is None:
        return 0, 0
    seq = obj if isinstance(obj, (list, tuple)) else (obj,)
    for x in seq:
        cols = None
        if hasattr(x, "columns") and hasattr(x, "num_rows"):  # Table
            rows = max(rows, int(x.num_rows))
            cols = x.columns
        elif hasattr(x, "dtype") and hasattr(x, "data") and hasattr(
            x, "is_varlen"
        ):  # Column
            rows = max(rows, len(x))
            cols = (x,)
        if cols is not None:
            for c in cols:
                data = getattr(c, "data", None)
                nbytes += int(getattr(data, "nbytes", 0) or 0)
    return rows, nbytes


def record_op(
    op: str,
    wall_ms: float,
    rows_in: int = 0,
    bytes_in: int = 0,
    rows_out: int = 0,
    bytes_out: int = 0,
    ok: bool = True,
    error: Optional[str] = None,
) -> None:
    """One op sample: fold the wall time into the op's timer, bump the
    call/row/byte counters, and journal the ``op_end`` event. The api
    facade wrapper calls this for every entry; other host drivers
    (resource executors, benchmarks) may call it for theirs."""
    if not enabled():
        return
    timer(f"op.{op}").observe(wall_ms)
    counter(f"op.{op}.calls").inc()
    if rows_in:
        counter(f"op.{op}.rows_in").inc(rows_in)
    if bytes_in:
        counter(f"op.{op}.bytes_in").inc(bytes_in)
    if rows_out:
        counter(f"op.{op}.rows_out").inc(rows_out)
    if bytes_out:
        counter(f"op.{op}.bytes_out").inc(bytes_out)
    if not ok:
        counter(f"op.{op}.errors").inc()
    from . import events as _events

    _events.emit(
        "op_end",
        op=op,
        wall_ms=round(float(wall_ms), 3),
        rows_in=rows_in,
        bytes_in=bytes_in,
        rows_out=rows_out,
        bytes_out=bytes_out,
        ok=bool(ok),
        **({"error": error} if error else {}),
    )


# --------------------------------------------------------------------
# snapshot / report / dump


def snapshot() -> dict:
    """Point-in-time copy of every instrument:
    ``{"counters": {name: int}, "gauges": {name: float},
    "timers": {name: {count, sum_ms, min_ms, max_ms}},
    "histograms": {name: {count, sum_ms, min_ms, max_ms,
    buckets: {le: cumulative}}}}``. Histogram buckets are cumulative
    (Prometheus shape), keyed by formatted upper bound, ending with
    ``"+Inf" == count``; empty buckets are elided."""
    with _lock:
        return {
            "counters": {k: c.value for k, c in _counters.items()},
            "gauges": {k: g.value for k, g in _gauges.items()},
            "timers": {
                k: {
                    "count": t.count,
                    "sum_ms": t.sum_ms,
                    "min_ms": t.min_ms,
                    "max_ms": t.max_ms,
                }
                for k, t in _timers.items()
                if t.count
            },
            "histograms": {
                k: {
                    "count": h.count,
                    "sum_ms": h.sum_ms,
                    "min_ms": h.min_ms,
                    "max_ms": h.max_ms,
                    "buckets": dict(h.cumulative_buckets()),
                }
                for k, h in _histograms.items()
                if h.count
            },
        }


def snapshot_delta(before: dict, after: dict) -> dict:
    """Difference of two ``snapshot()``s, dropping unchanged entries —
    the per-case telemetry attachment of the benchmark harness."""
    out: dict = {}
    counters = {
        k: v - before.get("counters", {}).get(k, 0)
        for k, v in after.get("counters", {}).items()
        if v != before.get("counters", {}).get(k, 0)
    }
    if counters:
        out["counters"] = counters
    gauges = {
        k: v
        for k, v in after.get("gauges", {}).items()
        if v != before.get("gauges", {}).get(k)
    }
    if gauges:
        out["gauges"] = gauges
    timers = {}
    for k, t in after.get("timers", {}).items():
        b = before.get("timers", {}).get(k, {"count": 0, "sum_ms": 0.0})
        dc = t["count"] - b["count"]
        if dc:
            timers[k] = {
                "count": dc,
                "sum_ms": round(t["sum_ms"] - b["sum_ms"], 3),
            }
    if timers:
        out["timers"] = timers
    hists = {}
    for k, h in after.get("histograms", {}).items():
        b = before.get("histograms", {}).get(
            k, {"count": 0, "sum_ms": 0.0}
        )
        dc = h["count"] - b["count"]
        if dc:
            hists[k] = {
                "count": dc,
                "sum_ms": round(h["sum_ms"] - b["sum_ms"], 3),
            }
    if hists:
        out["histograms"] = hists
    return out


def report() -> str:
    """Aligned text table of the registry — the human end of the Spark
    UI metrics pane. Timers sorted by total time, counters by name."""
    snap = snapshot()
    lines = []
    timers = sorted(
        snap["timers"].items(), key=lambda kv: -kv[1]["sum_ms"]
    )
    if timers:
        w = max(len("timer"), max(len(k) for k, _ in timers))
        lines.append(
            f"{'timer':<{w}}  {'count':>7}  {'total_ms':>10}  "
            f"{'mean_ms':>9}  {'min_ms':>9}  {'max_ms':>9}"
        )
        for k, t in timers:
            lines.append(
                f"{k:<{w}}  {t['count']:>7d}  {t['sum_ms']:>10.2f}  "
                f"{t['sum_ms'] / t['count']:>9.2f}  {t['min_ms']:>9.2f}  "
                f"{t['max_ms']:>9.2f}"
            )
    hists = [
        (k, histogram_stats(k))
        for k in sorted(snap.get("histograms", {}))
    ]
    hists = [(k, s) for k, s in hists if s]
    if hists:
        if lines:
            lines.append("")
        w = max(len("histogram"), max(len(k) for k, _ in hists))
        lines.append(
            f"{'histogram':<{w}}  {'count':>7}  {'p50_ms':>9}  "
            f"{'p95_ms':>9}  {'p99_ms':>9}  {'max_ms':>9}"
        )
        for k, s in hists:
            lines.append(
                f"{k:<{w}}  {s['count']:>7d}  {s['p50']:>9.2f}  "
                f"{s['p95']:>9.2f}  {s['p99']:>9.2f}  {s['max_ms']:>9.2f}"
            )
    if snap["counters"]:
        if lines:
            lines.append("")
        items = sorted(snap["counters"].items())
        w = max(len("counter"), max(len(k) for k, _ in items))
        lines.append(f"{'counter':<{w}}  {'value':>12}")
        for k, v in items:
            lines.append(f"{k:<{w}}  {v:>12d}")
    if snap["gauges"]:
        if lines:
            lines.append("")
        items = sorted(snap["gauges"].items())
        w = max(len("gauge"), max(len(k) for k, _ in items))
        lines.append(f"{'gauge':<{w}}  {'value':>14}")
        for k, v in items:
            lines.append(f"{k:<{w}}  {v:>14.3f}")
    # journal/sink health footer: silently dropped ring entries or a
    # degraded file sink must never read as "nothing happened"
    from . import events as _events

    n_ev, n_drop = len(_events.events()), _events.dropped()
    if lines or n_ev or n_drop or _sink_errors:
        if lines:
            lines.append("")
        lines.append(
            f"journal: {n_ev} events buffered, {n_drop} dropped "
            f"(ring capacity {_events.capacity()})"
        )
        lines.append(
            f"sink: {mode()} ({_sink_errors} write errors, "
            f"{_rotations} rotations)"
        )
        # tail-latency health: an operator reading only the footer
        # still sees whether distributions exist and whether any job
        # blew its SLO (the serving engine bumps this counter)
        n_h, n_obs = histogram_totals()
        lines.append(
            f"histograms: {n_h} instruments, {n_obs} observations; "
            f"slo violations: {counter_value('serving.slo_violations')}"
        )
    return "\n".join(lines) if lines else "(no telemetry recorded)"


def _snapshot_lines():
    snap = snapshot()
    for k, v in sorted(snap["counters"].items()):
        yield {"v": SCHEMA_VERSION, "kind": "counter", "name": k, "value": v}
    for k, v in sorted(snap["gauges"].items()):
        yield {"v": SCHEMA_VERSION, "kind": "gauge", "name": k, "value": v}
    for k, t in sorted(snap["timers"].items()):
        yield {
            "v": SCHEMA_VERSION,
            "kind": "timer",
            "name": k,
            "count": t["count"],
            "sum_ms": t["sum_ms"],
            "min_ms": t["min_ms"],
            "max_ms": t["max_ms"],
        }
    for k, h in sorted(snap.get("histograms", {}).items()):
        yield {
            "v": SCHEMA_VERSION,
            "kind": "histogram",
            "name": k,
            "count": h["count"],
            "sum_ms": h["sum_ms"],
            "min_ms": h["min_ms"],
            "max_ms": h["max_ms"],
            "buckets": h["buckets"],
        }


def dump_jsonl(path: str) -> int:
    """Write the full telemetry state — registry snapshot plus the
    event journal — as schema-stable JSONL. Returns the line count.
    Written atomically (temp + rename); dumping onto the active file
    sink's own path replaces the stream with the current state (the
    sink handle is closed first and reopens append on the next event,
    so nothing keeps writing into the unlinked old file)."""
    from . import events as _events

    global _sink_file
    n = 0
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        for line in _snapshot_lines():
            f.write(json.dumps(line, default=str) + "\n")
            n += 1
        for ev in _events.events():
            f.write(json.dumps(ev, default=str) + "\n")
            n += 1
    with _sink_lock:
        if _sink_file is not None and os.path.abspath(
            _sink_file.name
        ) == os.path.abspath(path):
            _close_sink_locked()
        os.replace(tmp, path)
    return n


# --------------------------------------------------------------------
# schema validation


def validate_line(obj) -> None:
    """Raise ValueError unless ``obj`` is a schema-valid JSONL record."""
    from . import events as _events

    if not isinstance(obj, dict):
        raise ValueError(f"line is not an object: {obj!r}")
    if obj.get("v") not in _ACCEPTED_VERSIONS:
        raise ValueError(f"bad schema version: {obj.get('v')!r}")
    kind = obj.get("kind")
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    num = (int, float)
    if kind == "counter":
        if not isinstance(obj.get("name"), str):
            raise ValueError(f"counter without name: {obj!r}")
        v = obj.get("value")
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"counter value must be int >= 0: {obj!r}")
    elif kind == "gauge":
        if not isinstance(obj.get("name"), str):
            raise ValueError(f"gauge without name: {obj!r}")
        if not isinstance(obj.get("value"), num):
            raise ValueError(f"gauge value must be numeric: {obj!r}")
    elif kind == "timer":
        if not isinstance(obj.get("name"), str):
            raise ValueError(f"timer without name: {obj!r}")
        c = obj.get("count")
        if not isinstance(c, int) or c <= 0:
            raise ValueError(f"timer count must be int > 0: {obj!r}")
        for fld in ("sum_ms", "min_ms", "max_ms"):
            if not isinstance(obj.get(fld), num):
                raise ValueError(f"timer {fld} must be numeric: {obj!r}")
        if obj["min_ms"] > obj["max_ms"]:
            raise ValueError(f"timer min_ms > max_ms: {obj!r}")
    elif kind == "histogram":
        if not isinstance(obj.get("name"), str):
            raise ValueError(f"histogram without name: {obj!r}")
        c = obj.get("count")
        if not isinstance(c, int) or c <= 0:
            raise ValueError(f"histogram count must be int > 0: {obj!r}")
        for fld in ("sum_ms", "min_ms", "max_ms"):
            if not isinstance(obj.get(fld), num):
                raise ValueError(
                    f"histogram {fld} must be numeric: {obj!r}"
                )
        if obj["min_ms"] > obj["max_ms"]:
            raise ValueError(f"histogram min_ms > max_ms: {obj!r}")
        b = obj.get("buckets")
        if not isinstance(b, dict) or not b:
            raise ValueError(
                f"histogram buckets must be a non-empty object: {obj!r}"
            )
        prev = -1
        for le, cum in b.items():  # insertion order == bound order
            if not isinstance(le, str):
                raise ValueError(f"histogram le must be str: {obj!r}")
            if not isinstance(cum, int) or isinstance(cum, bool):
                raise ValueError(
                    f"histogram bucket count must be int: {obj!r}"
                )
            if cum < prev:
                raise ValueError(
                    f"histogram buckets not cumulative: {obj!r}"
                )
            prev = cum
        if list(b)[-1] != "+Inf" or b["+Inf"] != c:
            raise ValueError(
                f"histogram buckets must end with +Inf == count: {obj!r}"
            )
    else:  # event
        if obj.get("event") not in _events.EVENT_NAMES:
            raise ValueError(f"unknown event {obj.get('event')!r}")
        if not isinstance(obj.get("ts"), num):
            raise ValueError(f"event ts must be numeric: {obj!r}")
        if obj.get("op") is not None and not isinstance(obj["op"], str):
            raise ValueError(f"event op must be str|null: {obj!r}")
        if not isinstance(obj.get("attrs"), dict):
            raise ValueError(f"event attrs must be an object: {obj!r}")
        if obj["v"] >= 2:
            # v2: causal span stamping is mandatory on every event
            sid = obj.get("span_id")
            if not isinstance(sid, int) or isinstance(sid, bool):
                raise ValueError(f"v2 event span_id must be int: {obj!r}")
            for fld in ("parent_id", "task_id"):
                x = obj.get(fld)
                if x is not None and (
                    not isinstance(x, int) or isinstance(x, bool)
                ):
                    raise ValueError(
                        f"v2 event {fld} must be int|null: {obj!r}"
                    )


def validate_jsonl(path: str, include_rotated: bool = True) -> int:
    """Validate every line of a dump/sink file; returns line count.
    A size-capped sink rotates to ``<path>.1`` (``_maybe_rotate_locked``)
    — when that sibling exists it is validated too (rotated-out lines
    are the same stream), counted into the total."""
    paths = rotated_paths(path) if include_rotated else [path]
    n = 0
    for p in paths:
        with open(p) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(f"{p}:{i}: not JSON: {e}") from None
                try:
                    validate_line(obj)
                except ValueError as e:
                    raise ValueError(f"{p}:{i}: {e}") from None
                n += 1
    return n
