"""Bounded ring-buffer event journal — the structured, queryable
counterpart of the profiler timeline (the port's copy of the JAX
package's ``runtime/events.py``: same schema, same ``EVENT_NAMES``).

Where ``runtime/metrics.py`` aggregates (counters/timers answer "how
much"), this journal keeps the last N discrete happenings in order
("what exactly, and when"): op begin/end with rows/bytes, capacity
overflows with their per-stage breakdown, retry re-plans, exhausted
retries (RetryOOMError), injected faults, compile-cache hits/misses,
and task-scope closes. Producers are all host-side seams — the api
facade wrapper, the resource retry driver, the faultinj interceptor,
the distributed collect points — so emission never happens inside a
device program.

Events are plain dicts in the dump schema (metrics.SCHEMA_VERSION;
see docs/OBSERVABILITY.md). Since schema v2 every event is stamped
with the causal identity of the span that emitted it
(``runtime/spans.py`` — the Dapper-style trace dimension):

    {"v": 2, "kind": "event", "event": <EVENT_NAMES>, "op": str|null,
     "ts": unix_seconds, "span_id": int, "parent_id": int|null,
     "task_id": int|null, "attrs": {...}}

v1 lines (no span fields) still validate — old journals stay
readable.

The buffer is a bounded deque (default 8192; ``set_capacity``) so a
long-running process keeps a recent-history window at O(1) cost. With
the file sink active (``SPARK_JNI_TPU_METRICS=/path.jsonl``) every
event also streams to disk as it is emitted, surviving crashes that
would lose the in-memory ring; the on-disk stream is size-capped too
(``SPARK_JNI_TPU_METRICS_MAX_MB``, default 256 — runtime/metrics.py
rotates the file to ``<path>.1`` and counts ``journal.rotations``),
so a long-running stream bounds BOTH its memory and its disk.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional

from . import metrics as _metrics
from . import spans as _spans  # no import cycle: spans pulls events lazily

# The documented event vocabulary (validate_line enforces membership).
EVENT_NAMES = frozenset(
    {
        "op_begin",  # facade entry; attrs: rows_in, bytes_in
        "op_end",  # facade exit; attrs: wall_ms, rows/bytes in/out, ok
        "capacity_overflow",  # a bounded contract dropped rows;
        #   attrs: stages {name: count}, source
        "retry_replan",  # resource retry driver grew a plan;
        #   attrs: attempt, injected, plan
        "retry_oom",  # retries exhausted -> RetryOOMError;
        #   attrs: task_id, retries, reason
        "injected_fault",  # faultinj fired; attrs: type, type_name
        "compile_cache_hit",  # persistent XLA cache served a program
        "compile_cache_miss",  # a real XLA compile ran; attrs: wall_ms
        "task_done",  # resource task scope closed; attrs: TaskMetrics
        "plan_cache_hit",  # pipeline plan cache reused an executable;
        #   attrs: plan (chain signature) — distinct from the XLA
        #   compile_cache_* pair: a plan hit never reaches the XLA
        #   compile boundary at all (runtime/pipeline.py)
        "plan_cache_miss",  # a pipeline chain was traced + compiled;
        #   attrs: plan, wall_ms (the compile_cache_* events emitted
        #   during the build carry source="plan_build" + the same plan
        #   signature, so journal readers can tell a plan build's XLA
        #   compiles from ambient eager-op compiles)
        "span_end",  # a causal span closed (runtime/spans.py); attrs:
        #   kind (task/op/run_plan/retry_round/plan_build/
        #   collect_stage), wall_ms — the event's own span_id IS the
        #   span, so traceview renders it as a named slice
        "device_metrics",  # per-device task metrics published at a
        #   distributed collect (parallel/distributed.py); attrs:
        #   n_dev, occupied_slots [per device], key_skew (max/mean),
        #   overflow {stage: count}
        "capacity_feedback",  # the capacity-feedback planner changed
        #   a chain's geometric buckets at retirement
        #   (runtime/pipeline.py); attrs: plan (chain signature hash),
        #   knobs {knob: {from, to}}, waste_pct — emitted only on
        #   tighten/widen transitions, not per chunk
        "stream_retire",  # a streamed pipeline chunk retired in order
        #   (runtime/pipeline.py Pipeline.stream): the deferred
        #   overflow sync + driver-side collect completed for chunk
        #   ``attrs.chunk``; stamped with the chunk's op span so the
        #   dispatch->retire slice and its retry rounds chain up to
        #   the stream span. attrs: chunk, window, retries, wall_ms
        "program_cache_bypass",  # an executor call fell back to the
        #   eager trace-per-call path instead of its cached jitted
        #   program (runtime/resource.py _use_program); attrs: op
        #   (Resource.<executor>), reason — knob_off (feedback off /
        #   no retrying scope), string_key_staging (a varlen column
        #   without a pinned width cannot trace), unconverged_plan
        #   (the feedback memo has not observed this site yet). Every
        #   eager fallback journals — there is no silent bypass.
        "plan_cache_evict",  # an LRU bound pushed a plan-keyed entry
        #   out (runtime/pipeline.py): the executable cache at
        #   _PLAN_CACHE_CAP or its device's CUDA-graph byte bound, or
        #   the capacity-feedback side table at _PLAN_FEEDBACK_CAP;
        #   attrs: plan (evicted signature hash), table
        #   (executable|feedback), freed_bytes (executable: the bytes
        #   the graph bound counted for it, its pool's with the
        #   device's last graph; 0 for an eager program) — under
        #   cross-tenant sharing a
        #   tenant whose hot plan was pushed out by another tenant's
        #   churn reads WHICH and WHEN here, not just a later miss
        "session_open",  # a serving session opened (serving/session
        #   .py); attrs: session, budget, knobs
        "session_close",  # a serving session closed; attrs: session,
        #   jobs, rejected, plan_cache {hits, misses}
        "admission_reject",  # the admission controller refused a job
        #   up front (serving/admission.py); attrs: session, reason
        #   (over_budget|queue_full|deadline), estimate_bytes — the
        #   refusal that replaces a mid-flight RetryOOMError
        "admission_decision",  # the admission controller let a job in
        #   (serving/server.py _admit, emitted under the job's span so
        #   the decision is a child of the job); attrs: session, job,
        #   verdict (admitted|queued), estimate_bytes — the accept-side
        #   twin of admission_reject, which fires under the same span
        #   on the refusal path
        "scan_plan",  # a parquet scan plan was built (runtime/scan.py
        #   ScanPlan): footers parsed once, columns pruned through the
        #   filter-schema DSL, row groups pruned against footer min/max
        #   stats; attrs: files, columns, predicate, row_groups,
        #   row_groups_pruned, rows, bytes_planned, bytes_skipped —
        #   the journal twin of the scan.* counters, emitted before
        #   the first byte of page data is read
        "stage_metrics",  # ANALYZE mode (runtime/pipeline.py): one
        #   chain stage's attribution for one chunk attempt, stamped
        #   with the stage's span (so it chains stage -> run_plan ->
        #   op -> stream/task); attrs: stage, stage_kind, rows, bytes,
        #   wall_ms, chain_wall_ms (the per-stage walls PARTITION it),
        #   chunk (streams), and under a shard device_rows/
        #   device_bytes vectors + skew (max/mean device rows) — the
        #   per-stage flame + skew-map source
        "slo_violation",  # a finished serving job blew its SLO
        #   (serving/server.py via runtime/flight.py's slow-job
        #   trigger): its e2e wall exceeded SPARK_JNI_TPU_SLO_FLIGHT x
        #   the session's admission-time latency estimate, or its own
        #   deadline_s; attrs: session, job, e2e_ms, threshold_ms,
        #   reason (slow|deadline), bundle (flight bundle name, null
        #   when the recorder is unarmed)
    }
)

DEFAULT_CAPACITY = 8192

_lock = threading.Lock()
# sprtcheck: guarded-by=_lock
_buf: "collections.deque[dict]" = collections.deque(maxlen=DEFAULT_CAPACITY)
_dropped = 0  # events pushed out of the ring (observability of loss)


def emit(event: str, op: Optional[str] = None, _span=None, **attrs) -> None:
    """Journal one event (no-op when the metrics sink is ``off``).
    ``attrs`` must be JSON-representable; non-serializable values are
    stringified at dump time. Every event is stamped with the causal
    identity of the current span (``runtime/spans.py``) — or of
    ``_span`` when a scope journals its own close event (task_done,
    span_end) and must stamp with ITSELF rather than whatever is
    current at emit time."""
    if not _metrics.enabled():
        return
    sp = _span if _span is not None else _spans.current()
    rec = {
        "v": _metrics.SCHEMA_VERSION,
        "kind": "event",
        "event": event,
        "op": op,
        "ts": time.time(),
        "span_id": sp.sid,
        "parent_id": sp.parent_id,
        "task_id": sp.task_id,
        "attrs": attrs,
    }
    global _dropped
    with _lock:
        if _buf.maxlen is not None and len(_buf) == _buf.maxlen:
            _dropped += 1
        _buf.append(rec)
    _metrics._write_line(rec)


def events() -> List[dict]:
    """Copy of the journal, oldest first."""
    with _lock:
        return list(_buf)


def recent(n: int = 50) -> List[dict]:
    """The last ``n`` events, oldest first."""
    with _lock:
        return list(_buf)[-n:]


def of_kind(event: str) -> List[dict]:
    """All journaled events with the given name, oldest first."""
    with _lock:
        return [e for e in _buf if e["event"] == event]


def dropped() -> int:
    """How many events the bounded ring has evicted since clear()."""
    return _dropped


def capacity() -> int:
    """Current ring bound (``set_capacity`` changes it)."""
    with _lock:
        return _buf.maxlen or 0


def set_capacity(n: int) -> None:
    """Re-bound the ring (keeps the newest events; a shrink that
    discards older events counts them as dropped)."""
    global _buf, _dropped
    with _lock:
        before = len(_buf)
        _buf = collections.deque(_buf, maxlen=int(n))
        _dropped += before - len(_buf)


def clear() -> None:
    global _dropped
    with _lock:
        _buf.clear()
        _dropped = 0
