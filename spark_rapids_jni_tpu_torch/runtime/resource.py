"""Task-scoped resource manager + adaptive capacity retry (the port's
twin of the single-device part of the JAX package's
``runtime/resource.py``).

The RmmSpark / SparkResourceAdaptor equivalent. The reference pairs its
kernels with a resource adaptor that tracks per-task GPU memory,
injects OOMs for testing (RmmSpark.forceRetryOOM), and drives a retry
state machine so an undersized allocation becomes a retry instead of a
task failure (reference: RmmSpark.java, SparkResourceAdaptor JNI). The
port keeps the JAX package's model of the recoverable-OOM class: an
undersized bounded contract (``capacity`` group slots, join output
rows, a pinned string width). Padded operators report overflow counts
next to their results; this module closes the loop:

- ``with resource.task(budget):`` opens a task scope that records
  requested capacities and estimated device bytes per op,
- executors (``join_padded``, ``guard``, and every fused chain through
  ``run_plan`` / ``run_plan_deferred``) re-plan on overflow, on an
  eager ``CapacityExceededError`` or on an injected ``"retry_oom"``
  fault: capacities grow geometrically (x2 at minimum, with
  count-informed jumps — every overflow count bounds the true need
  from above) and the op re-executes,
- callers get a correct result, or one ``RetryOOMError`` after the
  retry bound / byte budget is exhausted — rows never drop,
- the testing surface mirrors the reference: ``force_retry_oom``
  (RmmSpark.forceRetryOOM) plus the faultinj config kind
  ``"retry_oom"`` (runtime/faultinj.py injectionType 3); per-task
  metrics (retries, final plans, bytes, wall time) are queryable from
  Python (``metrics()``),
- the mesh executors ``group_by``, ``join`` and ``shuffle`` run the
  distributed operators (``parallel/distributed.py``,
  ``parallel/shuffle.py``) over a device mesh the same way: this is how
  a plugin sizes a bucket, by count-informed re-plans under the task's
  budget, never by a wrong answer. Their feedback memo and program
  cache key on the mesh shape.

State machine per op invocation::

    RUN -> (ovf == 0)            -> DONE
    RUN -> (ovf > 0 | injected)  -> REPLAN -> charge budget -> RUN
    REPLAN with retries exhausted, budget exceeded, or no knob left
        -> RetryOOMError(metrics)
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from . import events as _events
from . import faultinj
from . import flight as _flight
from . import metrics as _metrics
from . import spans as _spans
from ..ops._strategy import fusing
from .errors import CapacityExceededError, RetryOOMError

DEFAULT_MAX_RETRIES = 5
GROWTH = 2  # geometric re-plan factor


def _retry_oom(t: "Task", op: str, msg: str) -> RetryOOMError:
    """Build the terminal RetryOOMError AND publish it: the journal
    event carries the task's retry count at raise time (identical to
    ``TaskMetrics.retries`` — nothing retries after this), so the
    telemetry stream is sufficient to diagnose an exhausted task
    without catching the exception."""
    _metrics.counter("resource.retry_oom_errors").inc()
    _events.emit(
        "retry_oom",
        op=op,
        task_id=t.task_id,
        retries=t.metrics.retries,
        injected_ooms=t.metrics.injected_ooms,
        budget=t.budget,
        reason=msg,
    )
    err = RetryOOMError(msg, metrics=t.metrics)
    # flight recorder (runtime/flight.py): a RetryOOMError is recorded
    # at RAISE time, while the failing span stack is still open and the
    # journal tail still holds the retry trail — even a caller that
    # catches it leaves the diagnostics bundle behind
    _flight.maybe_record(err, task=t)
    return err


# --------------------------------------------------------------------
# metrics model


@dataclasses.dataclass
class OpAttempt:
    """One execution attempt of one op under a task scope."""

    op: str
    attempt: int  # 0 = first execution, >0 = retries
    plan: dict  # knob -> requested value for this attempt
    est_bytes: int
    wall_ms: float = 0.0
    overflow: Optional[Dict[str, int]] = None  # per-stage counts seen
    injected: bool = False  # synthetic OOM (faultinj / force_retry_oom)
    ok: bool = False


@dataclasses.dataclass
class TaskMetrics:
    """Per-task counters, the queryable surface of the manager
    (RmmSpark.getAndResetNumRetryThrow and friends)."""

    task_id: int
    budget: Optional[int]
    retries: int = 0  # re-executions, any cause
    injected_ooms: int = 0  # of which synthetic
    num_retry_throw: int = 0  # get-and-reset counter (RmmSpark parity)
    peak_bytes: int = 0  # max estimated plan bytes charged
    wall_ms: float = 0.0  # task scope wall time (set at close)
    attempts: List[OpAttempt] = dataclasses.field(default_factory=list)
    final_plans: Dict[str, dict] = dataclasses.field(default_factory=dict)


class Task:
    """A task scope: budget, retry bound, forced-OOM queue, metrics."""

    def __init__(
        self,
        task_id: int,
        budget: Optional[int] = None,
        max_retries: int = DEFAULT_MAX_RETRIES,
        retries_enabled: bool = True,
    ):
        self.metrics = TaskMetrics(task_id, budget)
        self.budget = budget
        self.max_retries = max_retries
        self.retries_enabled = retries_enabled
        self._lock = threading.Lock()
        self._forced_skip = 0
        self._forced_ooms = 0
        self._t0 = time.perf_counter()
        self._open = True
        self._span = None  # causal task span, set by start_task
        # signature hashes of every fused/sliced plan resolved under
        # this scope (pipeline._get_executable adds; GIL-atomic set) —
        # the flight recorder renders these plans' explains into the
        # failing task's bundle (explain.txt)
        self.plans_touched: set = set()

    @property
    def task_id(self) -> int:
        return self.metrics.task_id

    def force_retry_oom(self, num_ooms: int = 1, skip_count: int = 0):
        """Queue ``num_ooms`` synthetic retryable OOMs after skipping
        the next ``skip_count`` executor invocations —
        RmmSpark.forceRetryOOM(threadId, numOOMs, oomMode, skipCount)
        with the task standing in for the dedicated thread."""
        with self._lock:
            self._forced_skip = int(skip_count)
            self._forced_ooms = int(num_ooms)

    def _take_forced_oom(self) -> bool:
        with self._lock:
            if self._forced_skip > 0:
                self._forced_skip -= 1
                return False
            if self._forced_ooms > 0:
                self._forced_ooms -= 1
                return True
            return False

    def _note_retry(self, injected: bool):
        with self._lock:
            self.metrics.retries += 1
            self.metrics.num_retry_throw += 1
            if injected:
                self.metrics.injected_ooms += 1

    def _record_bytes(self, est_bytes: int):
        """Track the high-water mark of estimated plan bytes (every
        attempt, including the first — RmmSpark.getMaxMemoryEstimated
        must reflect non-retrying tasks too)."""
        with self._lock:
            self.metrics.peak_bytes = max(self.metrics.peak_bytes, est_bytes)

    def _charge(self, est_bytes: int, op: str):
        """Admission check for a RE-PLAN: grown plans must fit the task
        budget. The caller's initial plan is deliberately not refused —
        a budget bounds the manager's growth, it must not fail a call
        that would have worked without a scope."""
        self._record_bytes(est_bytes)
        if self.budget is not None and est_bytes > self.budget:
            raise _retry_oom(
                self,
                op,
                f"task {self.task_id}: plan for {op} needs ~{est_bytes} "
                f"bytes > budget {self.budget}; retries so far: "
                f"{self.metrics.retries}",
            )

    def get_and_reset_num_retry(self) -> int:
        with self._lock:
            n = self.metrics.num_retry_throw
            self.metrics.num_retry_throw = 0
            return n

    def _refresh_wall(self):
        """Keep wall_ms live while the scope is open (queries of a
        running task must not read 0)."""
        if self._open:
            self.metrics.wall_ms = (time.perf_counter() - self._t0) * 1000

    def close(self):
        if self._open:
            self.metrics.wall_ms = (time.perf_counter() - self._t0) * 1000
            self._open = False


# --------------------------------------------------------------------
# task registry (thread-local active stack + id-keyed lookup for the
# Java facade, which addresses tasks by Spark task id, not by scope)

_task_ids = itertools.count(1)
_registry_lock = threading.Lock()
# sprtcheck: guarded-by=_registry_lock
_tasks: Dict[int, Task] = {}  # open tasks by id
# sprtcheck: guarded-by=_registry_lock
_done: Dict[int, Task] = {}  # recently closed (bounded)
_DONE_KEEP = 64
_tls = threading.local()


def _stack() -> List[Task]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def start_task(
    task_id: Optional[int] = None,
    budget: Optional[int] = None,
    max_retries: int = DEFAULT_MAX_RETRIES,
    retries_enabled: bool = True,
) -> Task:
    """Open (or re-enter) a task scope on the current thread — the
    imperative form behind ``task()`` and the JNI facade's
    currentThreadIsDedicatedToTask(taskId)."""
    created = False
    with _registry_lock:
        if task_id is not None and task_id in _tasks:
            t = _tasks[task_id]
        else:
            if task_id is None:
                task_id = next(_task_ids)
            t = Task(task_id, budget, max_retries, retries_enabled)
            # open the task's causal span BEFORE publishing the task:
            # a concurrent re-entry by id must never observe
            # _span=None and skip adoption (spans.open_span touches
            # only this thread's contextvar + the leaf id lock — no
            # lock-order hazard). Every journal event inside the scope
            # chains up to this span; task_done serves as its close
            # event (runtime/spans.py)
            t._span = _spans.open_span(
                "task", f"task[{task_id}]", task_id=task_id
            )
            _tasks[task_id] = t
            created = True
    if not created and t._span is not None:
        # re-entry by id, possibly from ANOTHER thread (the JNI
        # currentThreadIsDedicatedToTask form): adopt the task span
        # into this context so events emitted here stamp the task, not
        # the ambient root (contextvars don't cross threads)
        _spans.adopt(t._span)
    st = _stack()
    # re-entry must not push a duplicate: task_done pops the task once,
    # and a leftover entry would keep a closed task as current_task()
    if t not in st:
        st.append(t)
    return t


def task_done(task_id: int) -> TaskMetrics:
    """Close a task scope (RmmSpark.taskDone): finalizes wall time,
    moves the task to the recently-done metrics ring."""
    with _registry_lock:
        t = _tasks.pop(task_id, None) or _done.get(task_id)
        if t is None:
            raise KeyError(f"unknown task id {task_id}")
        was_open = t._open
        t.close()
        _done[task_id] = t
        while len(_done) > _DONE_KEEP:
            _done.pop(next(iter(_done)))
    st = _stack()
    st[:] = [x for x in st if x is not t]  # every occurrence
    global _last_task
    _last_task = t
    if was_open:
        # publish the closed task's metrics — the journal form of the
        # RmmSpark accessors, so a run report needs no live task
        # registry. First close only: task_done() is re-callable on an
        # already-closed task and must not inflate the counters.
        m = t.metrics
        _metrics.counter("resource.tasks_done").inc()
        _metrics.timer("resource.task_wall").observe(m.wall_ms)
        # task_done is the task SPAN's close event: stamped with the
        # span itself (wall_ms makes it a complete slice in traceview)
        _events.emit(
            "task_done",
            task_id=m.task_id,
            retries=m.retries,
            injected_ooms=m.injected_ooms,
            peak_bytes=m.peak_bytes,
            wall_ms=round(m.wall_ms, 3),
            ops=sorted({a.op for a in m.attempts}),
            final_plans=m.final_plans,
            _span=getattr(t, "_span", None),
        )
        if getattr(t, "_span", None) is not None:
            _spans.close_span(t._span, emit_end=False)
    return t.metrics


_last_task: Optional[Task] = None


@contextlib.contextmanager
def task(
    budget: Optional[int] = None,
    *,
    max_retries: int = DEFAULT_MAX_RETRIES,
    retries_enabled: bool = True,
    task_id: Optional[int] = None,
):
    """``with resource.task(budget):`` — ops executed through this
    module's executors inside the scope get adaptive capacity retry
    bounded by ``budget`` (estimated bytes; None = unbounded) and
    ``max_retries`` re-executions per op invocation.
    ``retries_enabled=False`` keeps the recording but turns every
    overflow back into the op's ordinary error (today's behavior)."""
    t = start_task(task_id, budget, max_retries, retries_enabled)
    try:
        yield t
    except BaseException as e:
        # flight recorder: ANY exception escaping a task scope —
        # RetryOOMError (already recorded at raise, dedup'd by the
        # marker), an escaping CapacityExceededError, or an arbitrary
        # unhandled failure — leaves a diagnostics bundle while the
        # task span is still open (runtime/flight.py)
        _flight.maybe_record(e, task=t)
        raise
    finally:
        task_done(t.task_id)


@contextlib.contextmanager
def use_task(t: Task):
    """Activate an ALREADY-OPEN task on the current thread for the
    duration of the block — the serving interleaver's per-slice form
    of ``currentThreadIsDedicatedToTask``: the dispatch thread hops
    between tenants' tasks without opening/closing their scopes, so
    each slice's ops charge the right budget and stamp the right task
    span. The task stays open on exit (the owner calls ``task_done``);
    entry adopts the task span into this context, exit detaches it so
    the slice's journal events never leak into the next tenant's."""
    st = _stack()
    pushed = t not in st
    if pushed:
        st.append(t)
    if t._span is not None:
        _spans.adopt(t._span)
    try:
        yield t
    finally:
        if t._span is not None:
            _spans.detach(t._span)
        if pushed:
            st[:] = [x for x in st if x is not t]


def current_task() -> Optional[Task]:
    st = _stack()
    return st[-1] if st else None


def metrics(task_id: Optional[int] = None) -> Optional[TaskMetrics]:
    """Metrics of ``task_id``, the current scope, or — outside any
    scope — the most recently closed task. ``wall_ms`` reads live for
    a still-open task."""
    if task_id is not None:
        with _registry_lock:
            t = _tasks.get(task_id) or _done.get(task_id)
    else:
        t = current_task() or _last_task
    if t is None:
        return None
    t._refresh_wall()
    return t.metrics


def force_retry_oom(
    num_ooms: int = 1, skip_count: int = 0, task_id: Optional[int] = None
):
    """Programmatic synthetic-OOM injection (RmmSpark.forceRetryOOM):
    the next ``num_ooms`` executor invocations of the addressed task
    (after ``skip_count`` skips) behave as if capacity had run out."""
    t = None
    if task_id is not None:
        with _registry_lock:
            t = _tasks.get(task_id)
    else:
        t = current_task()
    if t is None:
        raise KeyError(f"no open task (task_id={task_id})")
    t.force_retry_oom(num_ooms, skip_count)


def get_and_reset_num_retry(task_id: int) -> int:
    """RmmSpark.getAndResetNumRetryThrow(taskId)."""
    with _registry_lock:
        t = _tasks.get(task_id) or _done.get(task_id)
    if t is None:
        raise KeyError(f"unknown task id {task_id}")
    return t.get_and_reset_num_retry()


def reset() -> None:
    """Drop all task state AND the executor feedback memo (tests)."""
    global _last_task
    with _registry_lock:
        _tasks.clear()
        _done.clear()
    _tls.stack = []
    _last_task = None
    exec_feedback_clear()


# --------------------------------------------------------------------
# executor capacity-feedback memo: keyed on (op, call-site signature,
# plan-knob signature), it records each successful invocation's
# FINAL-attempt observations quantized to the pipeline planner's
# geometric buckets (``next_pow2`` capacities), so a warm call starts
# from the previous call's observed need instead of the caller's
# guess. Undersized spikes still flow through the count-informed retry
# driver — a warm tighten can never drop rows, only re-plan. Gated on
# the shared capacity-feedback knob (``SPARK_JNI_TPU_CAPACITY_FEEDBACK``
# / ``pipeline.set_capacity_feedback``) AND a retrying task scope.

# distinct-key placement skew (max/mean of the per-shard merge need)
# at which the group_by re-planner reaches for a salted re-shuffle
# instead of growing merge slots
EXEC_SKEW_THRESHOLD = 2.0
MAX_SHUFFLE_SALT = 2  # salt re-rolls per invocation before growing

_exec_feedback_lock = threading.Lock()
# sprtcheck: guarded-by=_exec_feedback_lock
_exec_feedback: Dict[tuple, dict] = {}


def _feedback_on() -> bool:
    """The shared capacity-feedback knob (lazy import: pipeline
    imports this module at its top level)."""
    from .pipeline import capacity_feedback

    return capacity_feedback()


def _exec_memo_key(
    op: str, mesh_sig: tuple, plan: dict, site: tuple = ()
) -> tuple:
    """(op, mesh shape, call-site signature, plan-knob signature): the
    knob signature is the plan's STRUCTURE — knob names, and for
    dict-valued knobs (pinned width maps) the column set — and
    ``site`` is the executor's own identity (key columns, agg
    signature, join spec), so two call sites whose plans differ in
    shape OR that group/join different columns never share
    observations (a 1M-group site must not warm-start a 10-group
    site's bucket), while chunk-to-chunk calls of one site always
    do."""
    knobs = []
    for k in sorted(plan):
        v = plan[k]
        knobs.append((k, tuple(sorted(v)) if isinstance(v, dict) else None))
    return (op, mesh_sig, site, tuple(knobs))


def exec_feedback_table() -> "List[dict]":
    """Diagnostic copy of the executor feedback memo (tests, /plans
    consumers): one row per (op, mesh, knob-signature) site."""
    with _exec_feedback_lock:
        return [
            {
                "op": fb["op"],
                "mesh": key[1],
                "knobs": {k: dict(r) for k, r in fb["knobs"].items()},
                "tighten": fb["tighten"],
                "widen": fb["widen"],
                "waste_pct": fb["waste_pct"],
                "chunks": fb["chunks"],
            }
            for key, fb in _exec_feedback.items()
        ]


def exec_feedback_clear() -> None:
    """Drop every executor feedback observation AND the cached warm
    executor programs (tests)."""
    with _exec_feedback_lock:
        _exec_feedback.clear()
    with _exec_prog_lock:
        _exec_progs.clear()
        _exec_prog_stats.clear()


# Warm executor programs: once the feedback memo holds a call site's
# plan stable, the executor runs through a cached program for that
# (op, static plan) point whose size staging is hoisted inside it (one
# scalar read per call instead of a reduction plus a read). Gated like
# the memo (knob on + retrying scope) plus a CONVERGED plan; every
# eager fallback journals a ``program_cache_bypass`` event.
_EXEC_PROG_CAP = 64  # distinct (mesh, plan) programs held (LRU)

_exec_prog_lock = threading.Lock()
# sprtcheck: guarded-by=_exec_prog_lock
_exec_progs: Dict[tuple, object] = {}
# sprtcheck: guarded-by=_exec_prog_lock
_exec_prog_stats: Dict[tuple, dict] = {}


def _exec_adaptive() -> bool:
    """True when the executor adaptive layer (memo + warm program
    cache) is armed: feedback knob on AND a retrying task scope."""
    t = current_task()
    return (
        t is not None and t.retries_enabled and _feedback_on()
    )


def _widths_sig(d: Optional[dict]) -> Optional[tuple]:
    """Hashable identity of a width-map knob for a program-cache key."""
    return None if d is None else tuple(sorted(d.items()))


def _plan_point(plan: dict) -> dict:
    """JSON-safe copy of a plan's static point (diagnostics rows)."""
    return {
        k: (dict(v) if isinstance(v, dict) else v)
        for k, v in plan.items()
    }


def _exec_program(key: tuple, op: str, mesh_sig: tuple, plan: dict,
                  build):
    """Shared cached-program layer for the executor family: look up
    (or build) the program for one (op, mesh, static-plan)
    ``key``. A hit refreshes LRU recency; a miss calls ``build()``
    (which returns the program callable — nothing runs here) and
    evicts the least-recently-used entries past ``_EXEC_PROG_CAP``
    together with their stats rows. The returned callable times its
    FIRST invocation into the entry's ``build_wall_ms`` so the
    program-cache table prices what a cold program cost."""
    with _exec_prog_lock:
        fn = _exec_progs.pop(key, None)
        hit = fn is not None
        if hit:
            _exec_progs[key] = fn  # LRU: a hit refreshes recency
            st = _exec_prog_stats.get(key)
            if st is not None:
                st["hits"] += 1
        else:
            jfn = build()
            st = {
                "op": op,
                "mesh": mesh_sig,
                "plan": _plan_point(plan),
                "hits": 0,
                "build_wall_ms": None,
            }
            done: list = []

            def fn(*args, _jfn=jfn, _st=st, _done=done):
                if _done:
                    return _jfn(*args)
                t0 = time.perf_counter()
                out = _jfn(*args)
                _st["build_wall_ms"] = round(
                    (time.perf_counter() - t0) * 1e3, 3
                )
                _done.append(True)
                return out

            while len(_exec_progs) >= _EXEC_PROG_CAP:
                old = next(iter(_exec_progs))
                _exec_progs.pop(old)
                _exec_prog_stats.pop(old, None)
            _exec_progs[key] = fn
            _exec_prog_stats[key] = st
    _metrics.counter(
        "resource.program_cache_hit"
        if hit
        else "resource.program_cache_miss"
    ).inc()
    return fn


def program_cache_table() -> "List[dict]":
    """Diagnostic copy of the warm executor program cache (/plans,
    flight bundle): one row per cached (op, mesh, plan-point) program
    with its hit count and first-call build wall."""
    with _exec_prog_lock:
        return [
            {
                "op": st["op"],
                "mesh": st["mesh"],
                "plan": _plan_point(st["plan"]),
                "hits": st["hits"],
                "build_wall_ms": st["build_wall_ms"],
            }
            for st in _exec_prog_stats.values()
        ]


def _use_program(
    op: str, adaptive: bool, converged: bool, pinned: bool
) -> bool:
    """Gate for the cached-program path, shared by the executor
    family. Every eager fallback is journaled (``program_cache_bypass``
    with the dominant reason) — there is no silent bypass path."""
    if adaptive and converged and pinned:
        return True
    if not adaptive:
        reason = "knob_off"
    elif not pinned:
        reason = "string_key_staging"
    else:
        reason = "unconverged_plan"
    _events.emit(
        "program_cache_bypass", op=f"Resource.{op}", reason=reason
    )
    return False



def _join_padded_program(l_on, r_on, how, plan):
    """Cached single-device ``join_padded`` program: ``(left, right,
    left_occupied, right_occupied) -> (res, occ, needed_max)``. The
    max reduces inside the program and ONE int32 scalar syncs out (the
    retry driver's overflow check)."""
    cap = plan["capacity"]
    key = ("join_padded", l_on, r_on, how, cap)

    def build():
        from ..ops.join import join_padded as _jp

        # sprtcheck: dispatch-path
        def run(left, right, left_occupied, right_occupied):
            res, occ, needed = _jp(
                left,
                right,
                list(l_on),
                list(r_on),
                cap,
                how,
                left_occupied,
                right_occupied,
                with_stats=True,
            )
            return res, occ, needed.max().to(torch.int32)

        return run

    return _exec_program(key, "join_padded", (), plan, build)



def _exec_feedback_for(key: tuple) -> Optional[dict]:
    with _exec_feedback_lock:
        fb = _exec_feedback.get(key)
        if fb is None:
            return None
        return {k: dict(r) for k, r in fb["knobs"].items()}


def _apply_exec_feedback(key: tuple, plan: dict) -> dict:
    """Warm-start ``plan`` from the memo — the executor twin of the
    pipeline planner's ``_initial_plan`` feedback pass. Scalar knobs
    start from the observed geometric bucket: tightened below the
    caller's default, or widened past it only when the raw observation
    itself exceeded it (the default would have overflowed). Width-map
    knobs take the elementwise max of the caller's pin and the
    remembered final widths (a width can only have grown through a
    retry — re-learning that retry every chunk is the waste this memo
    removes); a remembered dropped wire pin stays dropped. ``salt``
    starts at the last successful re-roll. Applied only under a
    retrying scope with the feedback knob on (see the memo banner)."""
    t = current_task()
    if t is None or not t.retries_enabled or not _feedback_on():
        return plan
    fb = _exec_feedback_for(key)
    if fb is None:
        return plan
    new = dict(plan)
    for k, rec in fb.items():
        if k not in plan:
            continue
        cur, bucket = plan[k], rec["bucket"]
        if k == "salt":
            new[k] = max(int(cur), int(bucket))
        elif k.endswith("widths"):
            if cur and bucket is None and k.endswith("wire_widths"):
                new[k] = None  # a retry learned the pin must drop
            elif cur and bucket:
                new[k] = {
                    ci: max(int(w), int(bucket.get(ci, w)))
                    for ci, w in cur.items()
                }
            elif not cur and bucket and k.endswith("string_widths"):
                # an unpinned caller adopts the remembered widths
                # outright (PERF round-16 hot target #4): the warm
                # string-key join/shuffle then satisfies _pins_ok and
                # executes through the cached-program layer instead of
                # re-staging widths eagerly every chunk. An undersized
                # adoption is safe — it surfaces as a string_width
                # overflow and the ordinary retry ladder doubles it.
                new[k] = {ci: int(w) for ci, w in bucket.items()}
        elif bucket is None:
            continue  # scalar never observed
        elif cur is None:
            # no caller default (a derived worst case): the observed
            # bucket replaces it outright
            new[k] = int(bucket)
        elif rec["observed"] > int(cur):
            new[k] = int(bucket)  # widen: the default would overflow
        else:
            new[k] = min(int(bucket), int(cur))  # tighten
    return new


def _record_exec_feedback(
    key: tuple, op: str, plan: Optional[dict], observed: dict
) -> None:
    """Fold one successful invocation's final-attempt state into the
    memo. ``plan`` is the knob set the overflow-free attempt ran with
    (granted); ``observed`` maps scalar knobs to their exact observed
    need (from the ``with_stats`` vectors) — scalars without an
    observation memoize their final granted value (a grown capacity is
    itself the observation that the default was short). Publishes the
    waste gauge and the ``capacity_feedback`` journal event with
    ``source="executor"`` plus the shared tighten/widen counters."""
    if plan is None:
        return
    t = current_task()
    if t is None or not t.retries_enabled or not _feedback_on():
        return
    from .pipeline import _quantize_knob  # lazy (import-cycle safe)

    changes: Dict[str, tuple] = {}
    wastes: List[float] = []
    with _exec_feedback_lock:
        fb = _exec_feedback.setdefault(
            key,
            {
                "op": op,
                "knobs": {},
                "tighten": 0,
                "widen": 0,
                "waste_pct": 0.0,
                "chunks": 0,
            },
        )
        for k, granted in plan.items():
            prev = fb["knobs"].get(k)
            if k.endswith("widths"):
                bucket = None if granted is None else dict(granted)
                obs_w = observed.get(k)
                if obs_w and k.endswith("string_widths"):
                    # observed per-column byte widths (input-offset
                    # reductions that rode the attempt's overflow
                    # sync) fold in elementwise, quantized to the
                    # width bucket ladder — an UNPINNED call thereby
                    # seeds a pin map the next call adopts, the same
                    # way capacities are observed
                    bucket = dict(bucket or {})
                    if prev is not None and prev["bucket"]:
                        # widths are monotone: a previously learned
                        # pin never shrinks under a new observation
                        for ci, w in prev["bucket"].items():
                            if int(w) > int(bucket.get(ci, 0)):
                                bucket[ci] = int(w)
                    for ci, w in obs_w.items():
                        q = int(_quantize_knob(k, int(w)))
                        if q > int(bucket.get(ci, 0)):
                            bucket[ci] = q
                rec = {"observed": granted, "bucket": bucket}
                if prev is not None and prev["bucket"] != rec["bucket"]:
                    # widths only grow and wire pins only drop through
                    # retries: any change is a widen the next chunk
                    # skips re-learning
                    fb["widen"] += 1
                    changes[k] = (prev["bucket"], rec["bucket"])
                fb["knobs"][k] = rec
                continue
            if k == "salt":
                fb["knobs"][k] = {
                    "observed": int(granted), "bucket": int(granted)
                }
                if prev is not None and prev["bucket"] != int(granted):
                    changes[k] = (prev["bucket"], int(granted))
                continue
            obs = observed.get(k)
            if obs is None:
                obs = granted
            if obs is None:
                continue  # never granted, never observed: nothing to say
            obs = int(obs)
            bucket = int(_quantize_knob(k, obs))
            base = (
                prev["bucket"] if prev is not None
                else (int(granted) if granted is not None else None)
            )
            fb["knobs"][k] = {"observed": obs, "bucket": bucket}
            if base is None or bucket < base:
                fb["tighten"] += 1
                if base != bucket:
                    changes[k] = (base, bucket)
            elif bucket > base:
                fb["widen"] += 1
                changes[k] = (base, bucket)
            if granted:
                wastes.append(
                    100.0 * (1.0 - min(obs, int(granted)) / int(granted))
                )
        fb["chunks"] += 1
        if wastes:
            fb["waste_pct"] = round(sum(wastes) / len(wastes), 1)
        waste = fb["waste_pct"]
    if wastes:
        _metrics.gauge("resource.capacity_waste_pct").set(waste)
    if changes:
        tighten = sum(
            1 for a, b in changes.values()
            if isinstance(b, int) and (a is None or b < a)
        )
        widen = len(changes) - tighten
        if tighten:
            _metrics.counter("capacity.tighten").inc(tighten)
        if widen:
            _metrics.counter("capacity.widen").inc(widen)
        _events.emit(
            "capacity_feedback",
            op=f"Resource.{op}",
            source="executor",
            knobs={
                k: {"from": a, "to": b} for k, (a, b) in changes.items()
            },
            waste_pct=waste,
        )



# --------------------------------------------------------------------
# byte estimation (admission / budget accounting)


def _col_wire_bytes(col, width: Optional[int]) -> int:
    """Approximate per-row wire bytes of one column: the planes the
    exchanges and padded results actually allocate."""
    if col.is_varlen:
        if width is None:
            n = max(len(col), 1)
            width = max(int(col.data.shape[0]) // n, 1)  # avg payload
        return int(width) + 4  # char matrix row + int32 length
    data = col.data
    per = data.element_size()
    for d in data.shape[1:]:
        per *= int(d)  # multi-limb planes (DECIMAL128)
    return per + 1  # + validity byte


def _table_row_bytes(table, widths: Optional[dict]) -> int:
    w = widths or {}
    return sum(
        _col_wire_bytes(c, w.get(i)) for i, c in enumerate(table.columns)
    )


# --------------------------------------------------------------------
# generic retry engine


def _double_widths(widths: Optional[dict], needed: Optional[int] = None):
    if not widths:
        return widths
    return {
        k: max(GROWTH * int(v), int(needed or 0)) for k, v in widths.items()
    }


def _run_with_retry(op: str, attempt_fn, replan_fn, estimate_fn, plan: dict):
    """Host-side retry driver shared by every executor.

    ``attempt_fn(plan)`` executes the op and returns ``(value,
    stage_counts)`` with host-int per-stage overflow counts (all zero =
    success); it may instead raise ``CapacityExceededError`` (eager
    detection). ``replan_fn(plan, counts, exc)`` returns the grown plan
    or None when no knob can absorb the overflow. ``estimate_fn(plan)``
    prices a plan for the budget check.

    Causal tracing (runtime/spans.py): each invocation runs under a
    ``run_plan`` span; each execution attempt (attempt 0 included)
    closes a ``retry_round`` child span, so a journal reader — or the
    traceview timeline — sees the retry rounds as child slices of one
    run, all chaining up to the owning task span."""
    with _spans.span("run_plan", op):
        return _retry_loop(op, attempt_fn, replan_fn, estimate_fn, plan)


def _record_attempt(
    t, op, plan, estimate_fn, attempt, wall_ms, counts, injected, ok
):
    """Task-metrics bookkeeping shared by the serial and deferred
    drivers: byte high-water mark + the OpAttempt row."""
    if t is None:
        return
    est = estimate_fn(plan)
    t._record_bytes(est)  # first attempts count into peak too
    t.metrics.attempts.append(
        OpAttempt(op, attempt, dict(plan), est, wall_ms, counts,
                  injected, ok)
    )


def _publish_overflow(op: str, counts, exc) -> None:
    """Publish a failed attempt's overflow breakdown — previously this
    died inside the (private) TaskMetrics attempt list. An exc
    carrying a breakdown was already published at the collect sync
    point that raised it (distributed.py); republishing here would
    double-count the stages."""
    if not _metrics.enabled():
        return
    tripped = {k: int(v) for k, v in (counts or {}).items() if v}
    if exc is not None and getattr(exc, "breakdown", None) is None:
        if not tripped and exc.stage:
            short = (
                int(exc.needed) - int(exc.granted)
                if exc.needed is not None and exc.granted is not None
                else 1
            )
            tripped[exc.stage] = max(short, 1)
    if tripped:
        for k, v in tripped.items():
            _metrics.counter(f"overflow.{k}").inc(v)
        _events.emit(
            "capacity_overflow", op=op, source="resource",
            stages=tripped,
        )


def _resolve_failure(
    t, op, plan, counts, exc, injected, attempt, retrying, max_retries,
    replan_fn, estimate_fn,
):
    """The shared failure policy of the serial and deferred retry
    drivers: given one failed attempt, return the plan for the next
    attempt — or raise exactly the terminal error the serial loop
    always raised. Charging, retry counters, and the retry_replan
    journal event happen here so the two drivers cannot drift."""
    if not retrying:
        # no scope / retries disabled: surface exactly what the
        # direct call would have raised (collect's overflow check)
        if exc is not None:
            raise exc
        tripped = {k: v for k, v in counts.items() if v}
        raise CapacityExceededError(
            f"{op}: overflow with retries disabled — per-stage "
            f"indicator counts: {tripped}; raise the bound feeding "
            "the overflowing stage(s), or run inside an enabled "
            "resource.task scope",
            stage=max(tripped, key=tripped.get),
            breakdown=counts,
        )
    if attempt >= max_retries:
        raise _retry_oom(
            t,
            op,
            f"task {t.task_id}: {op} still overflowing after "
            f"{attempt} retries (last per-stage counts: "
            f"{counts if counts else exc}); budget="
            f"{t.budget}",
        )
    if injected:
        new_plan = dict(plan)  # same-size retry, reference semantics
    else:
        new_plan = replan_fn(plan, counts, exc)
        if new_plan is None or new_plan == plan:
            if exc is not None:
                # no knob can absorb the op's own eager error:
                # surface it unchanged (a caller catching the op's
                # error type must still see it — guard(), or an
                # executor whose relevant knob was never pinned)
                raise exc
            raise _retry_oom(
                t,
                op,
                f"task {t.task_id}: {op} overflowed but no capacity "
                f"knob can grow further (plan={plan}, counts="
                f"{counts})",
            )
    t._note_retry(injected)
    _metrics.counter("resource.retries").inc()
    if injected:
        _metrics.counter("resource.injected_ooms").inc()
    _events.emit(
        "retry_replan",
        op=op,
        task_id=t.task_id,
        attempt=attempt,
        injected=injected,
        plan=new_plan,
    )
    t._charge(estimate_fn(new_plan), op)
    return new_plan


def _retry_loop(op: str, attempt_fn, replan_fn, estimate_fn, plan: dict):
    t = current_task()
    retrying = t is not None and t.retries_enabled
    max_retries = t.max_retries if retrying else 0
    attempt = 0
    while True:
        injected = False
        value, counts, exc = None, None, None
        t0 = time.perf_counter()
        _round = _spans.open_span("retry_round", f"{op}#r{attempt}")
        try:
            try:
                # synthetic OOMs first: config-file driven (faultinj
                # kind "retry_oom"), then the programmatic
                # RmmSpark-style queue
                faultinj.inject_point(f"Resource.{op}")
                if t is not None and t._take_forced_oom():
                    raise faultinj.RetryOOMInjected(f"Resource.{op}")
                value, counts = attempt_fn(plan)
            except faultinj.RetryOOMInjected:
                # flag BEFORE the non-retrying re-raise: the round's
                # span_end must say injected=true for the exact round
                # an injected OOM escaped from
                injected = True
                if not retrying:
                    raise
            except CapacityExceededError as e:
                if not retrying:
                    raise
                exc = e
        finally:
            _spans.close_span(_round, attempt=attempt, injected=injected)
        wall_ms = (time.perf_counter() - t0) * 1000
        ok = not injected and exc is None and not any(
            (counts or {}).values()
        )
        _record_attempt(
            t, op, plan, estimate_fn, attempt, wall_ms, counts,
            injected, ok,
        )
        if not ok:
            _publish_overflow(op, counts, exc)
        if ok:
            if t is not None:
                t.metrics.final_plans[op] = dict(plan)
            return value
        plan = _resolve_failure(
            t, op, plan, counts, exc, injected, attempt, retrying,
            max_retries, replan_fn, estimate_fn,
        )
        attempt += 1


def run_plan(op: str, attempt_fn, replan_fn, estimate_fn, plan: dict):
    """Public form of the retry driver for host-side plan executors
    outside this module — ``runtime/pipeline.py`` runs every fused
    chain through it, so pipelines inherit the whole scope surface:
    budget charging, count-informed re-plans (each re-plan re-runs
    the chain at the grown static sizes), forced/injected OOMs
    (``Resource.<op>`` faultinj rules), per-task attempt metrics, and
    the terminal ``RetryOOMError``. Contract identical to the internal
    executors: ``attempt_fn(plan) -> (value, host_counts)`` with all-
    zero counts meaning success; ``replan_fn(plan, counts, exc)``
    returns the grown plan or None; ``estimate_fn(plan)`` prices a
    plan in bytes for the budget check."""
    return _run_with_retry(op, attempt_fn, replan_fn, estimate_fn, plan)


class DeferredPlan:
    """One in-flight op invocation under the deferred-check retry
    driver (``run_plan_deferred``): attempt 0's DISPATCH has happened
    — device compute is queued behind JAX async dispatch, the overflow
    counts are still device-resident — and the overflow check has not.
    ``retire()`` performs the deferred host sync and, on overflow or a
    dispatch-time injected OOM, the standard retry loop: count-
    informed re-plan + synchronous re-execution, each re-execution
    wrapped in its own ``retry_round`` span. In-order retirement is
    the caller's contract (``Pipeline.stream`` retires oldest-first),
    and the task scope captured at dispatch must still be open at
    retirement — the streaming loop runs inside the scope."""

    def __init__(
        self, op, dispatch_fn, sync_fn, replan_fn, estimate_fn, plan,
        task, value, injected, exc, span, t0,
    ):
        self.op = op
        self._dispatch = dispatch_fn
        self._sync = sync_fn
        self._replan = replan_fn
        self._estimate = estimate_fn
        self.plan = dict(plan)
        self._task = task
        self._value = value
        self._injected0 = injected
        self._exc0 = exc
        self._span = span  # the run_plan span, open dispatch->retire
        self._t0 = t0
        self.retries = 0  # re-executions performed at retirement
        self._done = False

    def retire(self):
        """Sync the deferred overflow counts and finish the
        invocation: returns the overflow-free value, or raises exactly
        what the serial driver would have (CapacityExceededError
        outside a retrying scope, RetryOOMError on exhaustion)."""
        if self._done:
            raise RuntimeError(
                f"{self.op}: deferred plan already retired"
            )
        self._done = True
        t = self._task
        retrying = t is not None and t.retries_enabled
        max_retries = t.max_retries if retrying else 0
        _spans.adopt(self._span)
        try:
            plan = self.plan
            value, injected, exc = self._value, self._injected0, self._exc0
            attempt, t0 = 0, self._t0
            # attempt 0's deferred check: the one host sync this
            # driver exists to move off the dispatch path. Its wall
            # spans dispatch -> retirement (queue time included — that
            # is the deferral); later attempts are synchronous.
            try:
                counts = (
                    {} if (injected or exc is not None)
                    else self._sync(value)
                )
            except CapacityExceededError as e:
                # eager detection inside the sync (allowed by the
                # attempt contract): same absorption as the serial
                # driver — re-plan under a retrying scope, surface
                # unchanged otherwise
                if not retrying:
                    raise
                counts, exc = {}, e
            while True:
                wall_ms = (time.perf_counter() - t0) * 1000
                ok = (
                    not injected and exc is None
                    and not any(counts.values())
                )
                _record_attempt(
                    t, self.op, plan, self._estimate, attempt, wall_ms,
                    counts, injected, ok,
                )
                if ok:
                    if t is not None:
                        t.metrics.final_plans[self.op] = dict(plan)
                    self.plan = plan
                    # release every reference that pins the chunk or
                    # its padded result planes: the caller may keep the
                    # DeferredPlan (or its containing bookkeeping)
                    # alive past retirement — a window=K stream must
                    # hold at most K chunks' device buffers
                    # (estimate_bytes stays valid: the estimate closure
                    # captures plain ints, runtime/pipeline.py)
                    self._value = None
                    self._dispatch = self._sync = None
                    return value
                _publish_overflow(self.op, counts, exc)
                plan = _resolve_failure(
                    t, self.op, plan, counts, exc, injected, attempt,
                    retrying, max_retries, self._replan, self._estimate,
                )
                # re-execution at retirement: the WHOLE synchronous
                # attempt — dispatch, device wait, and count sync —
                # runs under its own retry_round span (serial-driver
                # parity: the round's wall is the attempt's wall, not
                # just the enqueue; the adopted run_plan span is
                # current, so the round chains to this invocation,
                # not to the stream loop)
                attempt += 1
                self.retries = attempt
                injected, exc, value, counts = False, None, None, {}
                t0 = time.perf_counter()
                _round = _spans.open_span(
                    "retry_round", f"{self.op}#r{attempt}"
                )
                try:
                    try:
                        faultinj.inject_point(f"Resource.{self.op}")
                        if t is not None and t._take_forced_oom():
                            raise faultinj.RetryOOMInjected(
                                f"Resource.{self.op}"
                            )
                        value = self._dispatch(plan)
                        counts = self._sync(value)
                    except faultinj.RetryOOMInjected:
                        injected = True  # retrying is True here:
                        # _resolve_failure absorbed the previous
                        # failure, so a same-size retry follows
                    except CapacityExceededError as e:
                        exc = e  # eager detection: next loop pass
                        # feeds it to _resolve_failure (serial parity)
                finally:
                    _spans.close_span(
                        _round, attempt=attempt, injected=injected
                    )
        finally:
            _spans.close_span(self._span, deferred=True)

    def estimate_bytes(self) -> int:
        """Byte estimate of this invocation's current plan. The
        streaming executor sums these across its window and records
        the total (``Task._record_bytes``): with K chunks in flight
        the device-resident footprint is K plans' worth, which the
        serial one-op-at-a-time watermark would under-report."""
        return int(self._estimate(self.plan))

    def abandon(self) -> None:
        """Close the invocation's spans without retiring it — the
        streaming executor unwinds still-in-flight chunks when an
        earlier chunk's retirement raises. The dispatched value is
        dropped; no attempt is recorded."""
        if self._done:
            return
        self._done = True
        self._value = None  # drop the dispatched planes with the spans
        self._dispatch = self._sync = None
        _spans.close_span(self._span, deferred=True, abandoned=True)


# sprtcheck: dispatch-path — phase 1 must only enqueue: the deferred
# count sync belongs to retire(); a host sync here re-serializes the
# stream window (PR 6, 0.80x)
def run_plan_deferred(
    op: str, dispatch_fn, sync_fn, replan_fn, estimate_fn, plan: dict
) -> DeferredPlan:
    """Deferred-check variant of ``run_plan`` for streaming executors
    (``runtime/pipeline.py`` ``Pipeline.stream``). Phase 1 — here —
    runs attempt 0's DISPATCH immediately: the synthetic-OOM injection
    points fire (faultinj ``Resource.<op>`` rules and the forced-OOM
    queue, same as the serial driver), ``dispatch_fn(plan)`` queues
    the device compute and returns a value whose overflow counts are
    still DEVICE-RESIDENT — no host sync on the dispatch path. Phase 2
    is the caller's in-order retirement stage: ``retire()`` host-syncs
    the counts via ``sync_fn(value) -> {stage: int}`` and, on failure,
    re-plans and re-executes synchronously (``retry_round`` spans wrap
    each re-execution at retirement). The ``run_plan`` span stays open
    across dispatch -> retire — traceview shows in-flight invocations
    overlapping. Outside a retrying scope an injected OOM still raises
    AT DISPATCH (serial parity); a genuine overflow surfaces as the
    same CapacityExceededError, at retirement instead of at the
    collect sync."""
    t = current_task()
    retrying = t is not None and t.retries_enabled
    t0 = time.perf_counter()
    rp_span = _spans.open_span("run_plan", op)
    injected, exc, value = False, None, None
    try:
        _round = _spans.open_span("retry_round", f"{op}#r0")
        try:
            try:
                faultinj.inject_point(f"Resource.{op}")
                if t is not None and t._take_forced_oom():
                    raise faultinj.RetryOOMInjected(f"Resource.{op}")
                value = dispatch_fn(plan)
            except faultinj.RetryOOMInjected:
                injected = True
                if not retrying:
                    raise
            except CapacityExceededError as e:
                if not retrying:
                    raise
                exc = e
        finally:
            _spans.close_span(_round, attempt=0, injected=injected)
    except BaseException:
        _spans.close_span(rp_span, deferred=True)
        raise
    # keep the run_plan span OPEN but off this context's stack: the
    # next chunk's spans must be siblings, not children; retire()
    # re-adopts it
    _spans.detach(rp_span)
    return DeferredPlan(
        op, dispatch_fn, sync_fn, replan_fn, estimate_fn, plan, t,
        value, injected, exc, rp_span, t0,
    )


# --------------------------------------------------------------------
# executors over the bounded entry points



def guard(op: str, fn, estimate=None):
    """Run an arbitrary nullary op under the current task scope's
    accounting and synthetic-OOM surface: the call is recorded in the
    task metrics, faultinj ``Resource.<op>`` rules and forced OOMs
    retry it (same-size — there is no capacity knob to grow), and any
    ``CapacityExceededError`` it raises propagates unchanged (no knob
    means no re-plan). This is the cheapest way to put an already-correct op inside
    a task's metrics, and the happy-path overhead measurement point
    (benchmarks ``resource_scope``): one dict check, one time stamp,
    one metrics append per call."""

    def attempt(plan):
        return fn(), {}

    return _run_with_retry(
        op,
        attempt,
        lambda p, c, e: None,
        estimate or (lambda p: 0),
        {},
    )


def join_padded(
    left,
    right,
    left_on: Sequence[int],
    right_on: Sequence[int],
    capacity: int,
    how: str = "inner",
    left_occupied=None,
    right_occupied=None,
):
    """Adaptive single-device bounded join (``ops/join.py
    join_padded``): grows ``capacity`` to the reported true match count
    until the padded output holds every match. Returns ``(result,
    occupied)``. Warm calls under the capacity-feedback knob start
    from the previously observed true match count, and with a
    converged plan run through a cached program whose max reduction
    of ``needed`` is hoisted inside it."""
    from ..ops.join import join_padded as _join_padded

    plan = {"capacity": int(capacity)}
    l_on_t = tuple(int(k) for k in left_on)
    r_on_t = tuple(int(k) for k in right_on)
    memo_key = _exec_memo_key(
        "join_padded",
        (),
        plan,
        (l_on_t, r_on_t, str(how)),
    )
    warm = _apply_exec_feedback(memo_key, plan)
    converged = warm is not plan  # the memo has observed this site
    plan = warm
    # the cached program takes no width pins: its key/gather staging
    # host-syncs on any varlen column, so the program gate requires a
    # fully fixed-width pair of sides
    pinned = not any(c.is_varlen for c in left.columns) and not any(
        c.is_varlen for c in right.columns
    )
    holder: Dict[str, object] = {}

    def attempt(p):
        if _use_program(
            "join_padded", _exec_adaptive(), converged, pinned
        ):
            res, occ, mx_dev = _join_padded_program(
                l_on_t, r_on_t, str(how), p
            )(left, right, left_occupied, right_occupied)
            mx = int(mx_dev)  # ONE scalar sync
        else:
            res, occ, needed = _join_padded(
                left,
                right,
                list(left_on),
                list(right_on),
                p["capacity"],
                how,
                left_occupied,
                right_occupied,
                with_stats=True,
            )
            mx = int(needed.max())
        holder["plan"], holder["observed"] = dict(p), mx
        short = max(mx - p["capacity"], 0)
        return (res, occ), {"join_output": short}

    def replan(p, counts, exc):
        needed = p["capacity"] + (counts or {}).get("join_output", 0)
        if exc is not None and exc.needed:
            needed = max(needed, exc.needed)
        cap = max(GROWTH * p["capacity"], needed)
        return {"capacity": cap} if cap > p["capacity"] else None

    def estimate(p):
        lb = _table_row_bytes(left, None)
        rb = _table_row_bytes(right, None)
        return int(p["capacity"]) * (lb + rb)

    value = _run_with_retry("join_padded", attempt, replan, estimate, plan)
    obs = {}
    if holder.get("observed") is not None:
        obs["capacity"] = max(int(holder["observed"]), 1)
    _record_exec_feedback(memo_key, "join_padded", holder.get("plan"), obs)
    return value


# --------------------------------------------------------------------
# mesh executors: the distributed group-by / join / shuffle under the
# retry driver, with the feedback memo and program cache keyed by mesh


def _mesh_sig(mesh) -> tuple:
    """Hashable mesh identity for the memo key: observations from an
    8-shard mesh must never warm-start a 2-shard plan."""
    if mesh is None:
        return ()
    return tuple(sorted((str(a), int(s)) for a, s in mesh.shape.items()))


def _row_table(table):
    """A table with the row layout of ``table`` (the first shard of a
    sharded one) for the byte estimates."""
    return table.shards[0] if hasattr(table, "shards") else table


def _varlen_width_maxes(table) -> Optional[dict]:
    """Device-resident per-column max byte length of every varlen column
    of ``table`` (``{col_idx: int32 scalar}``, over every shard of a
    sharded one), or None when it has none. The reductions ride the
    attempt's one overflow read, so observing widths costs no extra
    host sync. Dead padding rows have zero length: the max only
    over-pins, never truncates."""
    parts = table.shards if hasattr(table, "shards") else [table]
    first = parts[0].columns[0].device if parts[0].columns else torch.device("cpu")
    out = {}
    for ci, c in enumerate(parts[0].columns):
        if not c.is_varlen:
            continue
        maxes = [(p.columns[ci].offsets[1:] - p.columns[ci].offsets[:-1]).max().to(first)
                 for p in parts if int(p.columns[ci].offsets.shape[0]) >= 2]
        if maxes:
            out[ci] = torch.stack(maxes).max().to(torch.int32)
    return out or None


def _host_ints(tree):
    """ONE device -> host read of every tensor in a nested dict / list /
    tuple (ints for scalars, int lists for vectors)."""
    leaves = []

    def enc(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("T", tuple(x.shape))
        if isinstance(x, dict):
            return ("D", [(k, enc(v)) for k, v in x.items()])
        if isinstance(x, (list, tuple)):
            return ("L", [enc(v) for v in x])
        return ("C", x)

    spec = enc(tree)
    if leaves:
        dev = leaves[0].device
        flat = torch.cat([t.reshape(-1).to(dev).to(torch.int64) for t in leaves]).tolist()
    else:
        flat = []
    it = iter(flat)

    def dec(s):
        if s[0] == "T":
            n = 1
            for d in s[1]:
                n *= d
            vals = [next(it) for _ in range(n)]
            return vals[0] if not s[1] else vals
        if s[0] == "D":
            return {k: dec(v) for k, v in s[1]}
        if s[0] == "L":
            return [dec(v) for v in s[1]]
        return s[1]

    return dec(spec)


def _group_by_program(mesh, axis, keys, aggs_sig, plan):
    """Cached ``distributed_group_by`` program for one (mesh, static
    plan) point: ``(table, occupied) -> (res, occ, ovf, stats)``. The
    mesh programs run their operator in its sync-free form
    (``ops/_strategy.fusing``), as the JAX package's run theirs under
    jit: no eager size check raises inside, every shortfall is
    counted."""
    widths = plan["string_widths"]
    wire = plan["wire_widths"]
    cap, mcap, salt = plan["capacity"], plan["merge_capacity"], plan["salt"]
    key = ("group_by", mesh, axis, keys, aggs_sig, cap, mcap, salt,
           _widths_sig(widths), _widths_sig(wire))

    def build():
        from ..ops.aggregate import Agg
        from ..parallel.distributed import distributed_group_by

        aggs = [Agg(o, c) for o, c in aggs_sig]

        # sprtcheck: dispatch-path
        def run(table, occupied):
            with fusing():
                return distributed_group_by(
                    table, list(keys), aggs, mesh, axis=axis, capacity=cap, occupied=occupied,
                    string_widths=widths, wire_widths=wire, merge_capacity=mcap,
                    shuffle_salt=salt, overflow_detail=True, with_stats=True,
                )

        return run

    return _exec_program(key, "group_by", _mesh_sig(mesh), plan, build)


def _join_program(mesh, axis, l_on, r_on, how, plan):
    """Cached ``distributed_join`` program for one (mesh, static plan)
    point: ``(left, right, left_occupied, right_occupied) -> (res, occ,
    ovf, stats)``. Used only when every varlen column of both sides
    carries a pinned width (no eager width staging inside)."""
    lw, rw = plan["left_string_widths"], plan["right_string_widths"]
    lwire, rwire = plan["left_wire_widths"], plan["right_wire_widths"]
    scap, ocap = plan["shuffle_capacity"], plan["out_capacity"]
    key = ("join", mesh, axis, l_on, r_on, how, scap, ocap, _widths_sig(lw), _widths_sig(rw),
           _widths_sig(lwire), _widths_sig(rwire))

    def build():
        from ..parallel.distributed import distributed_join

        # sprtcheck: dispatch-path
        def run(left, right, left_occupied, right_occupied):
            with fusing():
                return distributed_join(
                    left, right, list(l_on), list(r_on), mesh, how=how, axis=axis,
                    left_occupied=left_occupied, right_occupied=right_occupied,
                    shuffle_capacity=scap, out_capacity=ocap, left_string_widths=lw,
                    right_string_widths=rw, left_wire_widths=lwire, right_wire_widths=rwire,
                    overflow_detail=True, with_stats=True,
                )

        return run

    return _exec_program(key, "join", _mesh_sig(mesh), plan, build)


def _shuffle_program(mesh, axis, keys, plan):
    """Cached ``hash_shuffle`` program for one (mesh, static plan)
    point: ``(table, occupied) -> (out, occ, ovf, fill)``; the max
    bucket fill reduces inside, so the warm path pays the same single
    host read as the eager adaptive path."""
    widths, wire = plan["string_widths"], plan["wire_widths"]
    cap = plan["capacity"]
    key = ("shuffle", mesh, axis, keys, cap, _widths_sig(widths), _widths_sig(wire))

    def build():
        from ..parallel.shuffle import hash_shuffle

        # sprtcheck: dispatch-path
        def run(table, occupied):
            with fusing():
                out, occ, ovf = hash_shuffle(table, list(keys), mesh, axis=axis, capacity=cap,
                                             occupied=occupied, string_widths=widths,
                                             wire_widths=wire)
            return out, occ, ovf, _max_bucket_fill(mesh, occ, cap)

        return run

    return _exec_program(key, "shuffle", _mesh_sig(mesh), plan, build)


def _max_bucket_fill(mesh, occ, cap: int) -> torch.Tensor:
    """The observed max (sender, destination) bucket fill of a shuffle's
    received masks (int32 scalar on the first mesh device)."""
    first = mesh.devices[0]
    fills = torch.stack([o.reshape(-1, cap).sum(1).max().to(first) if o.numel() else
                         torch.zeros((), dtype=torch.int64, device=first) for o in occ])
    return fills.max().to(torch.int32)


def _merge_skew(stats: Optional[dict]) -> float:
    """max/mean distinct-key placement skew of the last attempt's
    per-shard merge-need vector (0.0 when unobserved)."""
    if not stats:
        return 0.0
    v = stats.get("merge_groups_per_dev")
    if v is None or len(v) == 0:
        return 0.0
    mean = float(sum(int(x) for x in v)) / len(v)
    return float(max(int(x) for x in v)) / mean if mean > 0 else 0.0


def _estimate_group_by_bytes(table, n_dev: int, plan: dict) -> int:
    # dominant allocations: the phase-2 exchanged partials (every shard
    # can receive all senders' padded phase-1 outputs) plus the phase-3
    # merge planes at their own capacity
    row_b = _table_row_bytes(_row_table(table), plan.get("string_widths"))
    cap = int(plan["capacity"])
    mc = plan.get("merge_capacity")
    merge_rows = (n_dev * cap + 1) if mc is None else int(mc)
    return n_dev * n_dev * cap * row_b + n_dev * merge_rows * row_b


def _estimate_join_bytes(left, right, n_dev: int, plan: dict) -> int:
    lb = _table_row_bytes(_row_table(left), plan.get("left_string_widths"))
    rb = _table_row_bytes(_row_table(right), plan.get("right_string_widths"))
    sc = plan.get("shuffle_capacity")
    if sc is None:
        sc = max(left.num_rows, right.num_rows) // max(n_dev, 1)
    shuffled = n_dev * n_dev * int(sc) * (lb + rb)
    out = n_dev * int(plan["out_capacity"]) * (lb + rb)
    return shuffled + out


def group_by(
    table,
    key_indices: Sequence[int],
    aggs,
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    occupied=None,
    string_widths: Optional[dict] = None,
    wire_widths: Optional[dict] = None,
    collect: bool = True,
    merge_capacity: Optional[int] = None,
    shuffle_salt: int = 0,
):
    """Adaptive ``distributed_group_by``: an undersized ``capacity`` /
    ``merge_capacity`` / pinned width becomes retries with grown plans
    instead of an error. Returns the collected Table (``collect=True``)
    or the padded ``(result, occupied)`` pair, both overflow-free.

    A ``final_merge`` overflow grows the per-shard ``merge_capacity``
    count-informed, never the quadratic widen through ``capacity``;
    when the per-shard merge-need vector shows a placement skew at or
    above ``EXEC_SKEW_THRESHOLD``, the re-plan re-rolls the phase-2
    placement with a salted seed instead (``capacity.repartition``
    counts it). Salting is ``collect=True``-only: with
    ``collect=False`` the padded shards flow onward and may
    co-partition against unsalted exchanges. Under the capacity-feedback
    knob and a retrying scope, a warm call starts from the previous
    call's observations (the executor feedback memo)."""
    from ..parallel.distributed import collect_group_by, distributed_group_by
    from ..parallel.mesh import axis_size as _axis_size

    n_dev = _axis_size(mesh, axis)
    n_local = table.num_rows // max(n_dev, 1)
    plan = {
        "capacity": int(capacity) if capacity is not None else max(n_local, 1),
        "merge_capacity": None if merge_capacity is None else int(merge_capacity),
        "salt": int(shuffle_salt),
        "string_widths": dict(string_widths) if string_widths else None,
        "wire_widths": dict(wire_widths) if wire_widths else None,
    }
    keys_t = tuple(int(k) for k in key_indices)
    aggs_sig = tuple((a.op, a.column) for a in aggs)
    cols0 = _row_table(table).columns
    varlen_used = sorted(ci for ci in {*keys_t, *(c for _, c in aggs_sig if c is not None)}
                         if cols0[ci].is_varlen)
    memo_key = _exec_memo_key("group_by", _mesh_sig(mesh), plan, (keys_t, aggs_sig))
    warm = _apply_exec_feedback(memo_key, plan)
    # the memo rewrote the plan: it has observed this site before
    converged = warm is not plan
    if converged:
        # memo-derived buckets stay inside the always-safe ceilings
        plan = warm
        plan["capacity"] = min(plan["capacity"], max(n_local, 1))
        if plan["merge_capacity"] is not None:
            plan["merge_capacity"] = min(plan["merge_capacity"], n_dev * plan["capacity"] + 1)
    if not collect:
        # a salted placement is private to a COLLECTED result
        plan["salt"] = int(shuffle_salt)
    holder: Dict[str, object] = {}

    def _prog_ok(p):
        w = p["string_widths"] or {}
        return all(ci in w for ci in varlen_used)

    def attempt(p):
        if _use_program("group_by", _exec_adaptive(), converged, _prog_ok(p)):
            res, occ, ovf, stats = _group_by_program(mesh, axis, keys_t, aggs_sig, p)(
                table, occupied)
        else:
            res, occ, ovf, stats = distributed_group_by(
                table, key_indices, aggs, mesh, axis=axis, capacity=p["capacity"],
                occupied=occupied, string_widths=p["string_widths"],
                wire_widths=p["wire_widths"], merge_capacity=p["merge_capacity"],
                shuffle_salt=p["salt"], overflow_detail=True, with_stats=True,
            )
        # ONE host read: the overflow counts and the observation vectors
        hc, hs = _host_ints((ovf, stats))
        holder["plan"], holder["stats"] = dict(p), hs
        return (res, occ), {k: int(v) for k, v in hc.items()}

    def replan(p, counts, exc):
        new = dict(p)
        grew = False
        c = counts or {}
        needed = exc.needed if exc is not None else None
        if c.get("input_truncation") or (exc is not None and exc.stage == "string_width"):
            w = _double_widths(p["string_widths"], needed)
            if w != p["string_widths"]:
                new["string_widths"], grew = w, True
        if c.get("shuffle"):
            w = _double_widths(p["string_widths"])
            if w != p["string_widths"]:
                new["string_widths"], grew = w, True
            if p["wire_widths"]:
                # full storage width is always round-trip safe
                new["wire_widths"], grew = None, True
        if c.get("local_groups"):
            # the counts bound the true per-shard need from above:
            # count-informed jump, x2 floor, local row count ceiling
            want = p["capacity"] + c.get("local_groups", 0)
            cap = min(max(GROWTH * p["capacity"], want), max(n_local, 1))
            if cap > p["capacity"]:
                new["capacity"], grew = cap, True
        if c.get("final_merge"):
            skew = _merge_skew(holder.get("stats"))
            if collect and skew >= EXEC_SKEW_THRESHOLD and p["salt"] < MAX_SHUFFLE_SALT:
                new["salt"], grew = p["salt"] + 1, True
                _metrics.counter("capacity.repartition").inc()
            else:
                eff = (p["merge_capacity"] if p["merge_capacity"] is not None
                       else n_dev * p["capacity"] + 1)
                want = eff + c.get("final_merge", 0)
                mc = min(max(GROWTH * eff, want), n_dev * new["capacity"] + 1)
                if mc > eff:
                    new["merge_capacity"], grew = mc, True
        return new if grew else None

    value = _run_with_retry("group_by", attempt, replan,
                            lambda p: _estimate_group_by_bytes(table, n_dev, p), plan)
    stats = holder.get("stats") or {}
    obs = {}
    if "local_groups_per_dev" in stats:
        obs["capacity"] = int(max(stats["local_groups_per_dev"]))
    if "merge_groups_per_dev" in stats:
        obs["merge_capacity"] = int(max(stats["merge_groups_per_dev"]))
    final_plan = holder.get("plan")
    if final_plan is not None and not collect:
        # a caller-forced collect=False salt must not clobber a learned one
        final_plan = {k: v for k, v in final_plan.items() if k != "salt"}
    _record_exec_feedback(memo_key, "group_by", final_plan, obs)
    res, occ = value
    return collect_group_by(res, occ, n_dev=n_dev) if collect else (res, occ)


def join(
    left,
    right,
    left_on: Sequence[int],
    right_on: Sequence[int],
    mesh,
    how: str = "inner",
    axis: str = "data",
    left_occupied=None,
    right_occupied=None,
    shuffle_capacity: Optional[int] = None,
    out_capacity: Optional[int] = None,
    left_string_widths: Optional[dict] = None,
    right_string_widths: Optional[dict] = None,
    left_wire_widths: Optional[dict] = None,
    right_wire_widths: Optional[dict] = None,
    collect: bool = True,
):
    """Adaptive ``distributed_join``: undersized ``out_capacity`` /
    ``shuffle_capacity`` / pinned widths retry with grown plans. Under
    the capacity-feedback knob and a retrying scope, a warm call starts
    from the previous call's observations (the true per-shard output
    need rides the overflow read)."""
    from ..parallel.distributed import collect_table, distributed_join
    from ..parallel.mesh import axis_size as _axis_size

    n_dev = _axis_size(mesh, axis)
    nl_local = left.num_rows // max(n_dev, 1)
    nr_local = right.num_rows // max(n_dev, 1)
    plan = {
        "shuffle_capacity": shuffle_capacity,
        "out_capacity": (int(out_capacity) if out_capacity is not None
                         else max(nl_local, nr_local)),
        "left_string_widths": dict(left_string_widths) if left_string_widths else None,
        "right_string_widths": dict(right_string_widths) if right_string_widths else None,
        "left_wire_widths": dict(left_wire_widths) if left_wire_widths else None,
        "right_wire_widths": dict(right_wire_widths) if right_wire_widths else None,
    }
    l_on_t = tuple(int(k) for k in left_on)
    r_on_t = tuple(int(k) for k in right_on)
    memo_key = _exec_memo_key("join", _mesh_sig(mesh), plan, (l_on_t, r_on_t, str(how)))
    warm = _apply_exec_feedback(memo_key, plan)
    converged = warm is not plan
    if converged:
        plan = warm
        if plan["shuffle_capacity"] is not None:
            plan["shuffle_capacity"] = min(int(plan["shuffle_capacity"]),
                                           max(nl_local, nr_local, 1))
    holder: Dict[str, object] = {}
    lcols, rcols = _row_table(left).columns, _row_table(right).columns

    def _pins_ok(p):
        lw = p["left_string_widths"] or {}
        rw = p["right_string_widths"] or {}
        return (all(ci in lw for ci, c in enumerate(lcols) if c.is_varlen)
                and all(ci in rw for ci, c in enumerate(rcols) if c.is_varlen))

    def attempt(p):
        # the stats vectors feed only the memo: off the adaptive path
        # nothing consumes them
        ws = _exec_adaptive()
        if _use_program("join", ws, converged, _pins_ok(p)):
            res, occ, ovf, stats = _join_program(mesh, axis, l_on_t, r_on_t, str(how), p)(
                left, right, left_occupied, right_occupied)
            hc, hs = _host_ints((ovf, stats))
            holder["stats"] = hs
        else:
            ret = distributed_join(
                left, right, left_on, right_on, mesh, how=how, axis=axis,
                left_occupied=left_occupied, right_occupied=right_occupied,
                shuffle_capacity=p["shuffle_capacity"], out_capacity=p["out_capacity"],
                left_string_widths=p["left_string_widths"],
                right_string_widths=p["right_string_widths"],
                left_wire_widths=p["left_wire_widths"],
                right_wire_widths=p["right_wire_widths"],
                overflow_detail=True, with_stats=ws,
            )
            if ws:
                res, occ, ovf, stats = ret
                # an unpinned side's width maxes ride the same read and
                # seed the memo, so the next call pins into the program
                lw_obs = None if p["left_string_widths"] else _varlen_width_maxes(left)
                rw_obs = None if p["right_string_widths"] else _varlen_width_maxes(right)
                hc, hs, hlw, hrw = _host_ints((ovf, stats, lw_obs, rw_obs))
                holder["stats"] = hs
                if hlw:
                    holder["left_widths"] = {int(ci): int(w) for ci, w in hlw.items()}
                if hrw:
                    holder["right_widths"] = {int(ci): int(w) for ci, w in hrw.items()}
            else:
                res, occ, ovf = ret
                hc = _host_ints(ovf)
        holder["plan"] = dict(p)
        return (res, occ), {k: int(v) for k, v in hc.items()}

    def _grow_side(new, p, side, grew):
        w = _double_widths(p[f"{side}_string_widths"])
        if w != p[f"{side}_string_widths"]:
            new[f"{side}_string_widths"], grew = w, True
        if p[f"{side}_wire_widths"]:
            new[f"{side}_wire_widths"], grew = None, True
        sc = p["shuffle_capacity"]
        if sc is not None:
            cap = min(GROWTH * sc, max(nl_local, nr_local, 1))
            if cap > sc:
                new["shuffle_capacity"], grew = cap, True
        return grew

    def replan(p, counts, exc):
        new = dict(p)
        grew = False
        c = counts or {}
        if c.get("left_shuffle"):
            grew = _grow_side(new, p, "left", grew)
        if c.get("right_shuffle"):
            grew = _grow_side(new, p, "right", grew)
        needed = exc.needed if exc is not None and exc.stage == "join_output" else None
        if c.get("join_output") or needed is not None:
            # the count bounds the true need from above: one retry
            # suffices even for a badly skewed shard
            cap = max(GROWTH * p["out_capacity"], p["out_capacity"] + c.get("join_output", 0),
                      needed or 0)
            if cap > p["out_capacity"]:
                new["out_capacity"], grew = cap, True
        if exc is not None and exc.stage == "string_width":
            for side in ("left", "right"):
                w = _double_widths(p[f"{side}_string_widths"], exc.needed)
                if w != p[f"{side}_string_widths"]:
                    new[f"{side}_string_widths"], grew = w, True
        return new if grew else None

    value = _run_with_retry("join", attempt, replan,
                            lambda p: _estimate_join_bytes(left, right, n_dev, p), plan)
    stats = holder.get("stats") or {}
    obs = {}
    if "out_needed_per_dev" in stats:
        obs["out_capacity"] = int(max(stats["out_needed_per_dev"]))
    if holder.get("left_widths"):
        obs["left_string_widths"] = holder["left_widths"]
    if holder.get("right_widths"):
        obs["right_string_widths"] = holder["right_widths"]
    _record_exec_feedback(memo_key, "join", holder.get("plan"), obs)
    res, occ = value
    return collect_table(res, occ, n_dev=n_dev) if collect else (res, occ)


def shuffle(
    table,
    key_indices: Sequence[int],
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    occupied=None,
    string_widths: Optional[dict] = None,
    wire_widths: Optional[dict] = None,
):
    """Adaptive ``hash_shuffle``: returns an overflow-free padded
    ``(table, occupied)`` pair, growing bucket capacity / pinned widths
    (and dropping wire pins) as needed. The re-planner never salts the
    placement: murmur3(key) ownership is this op's result contract.
    Under the capacity-feedback knob and a retrying scope, warm calls
    start from the observed max bucket fill of the previous call."""
    from ..parallel.mesh import axis_size as _axis_size
    from ..parallel.shuffle import hash_shuffle

    n_dev = _axis_size(mesh, axis)
    n_local = table.num_rows // max(n_dev, 1)
    plan = {
        "capacity": int(capacity) if capacity is not None else n_local,
        "string_widths": dict(string_widths) if string_widths else None,
        "wire_widths": dict(wire_widths) if wire_widths else None,
    }
    keys_t = tuple(int(k) for k in key_indices)
    memo_key = _exec_memo_key("shuffle", _mesh_sig(mesh), plan, (keys_t,))
    warm = _apply_exec_feedback(memo_key, plan)
    converged = warm is not plan
    if converged:
        plan = warm
        plan["capacity"] = min(plan["capacity"], max(n_local, 1))
    holder: Dict[str, object] = {}
    cols0 = _row_table(table).columns

    def _pins_ok(p):
        w = p["string_widths"] or {}
        return all(ci in w for ci, c in enumerate(cols0) if c.is_varlen)

    def attempt(p):
        adaptive = _exec_adaptive()
        if _use_program("shuffle", adaptive, converged, _pins_ok(p)):
            out, occ, ovf, fill = _shuffle_program(mesh, axis, keys_t, p)(table, occupied)
            ho, hf = _host_ints((ovf, fill))
            holder["fill"] = int(hf)
        else:
            out, occ, ovf = hash_shuffle(table, key_indices, mesh, axis=axis,
                                         capacity=p["capacity"], occupied=occupied,
                                         string_widths=p["string_widths"],
                                         wire_widths=p["wire_widths"])
            if adaptive:
                # on a drop-free attempt the receive-side occupancy IS
                # the true bucket need; widths ride the same read
                fill = _max_bucket_fill(mesh, occ, p["capacity"])
                wobs = None if p["string_widths"] else _varlen_width_maxes(table)
                ho, hf, hw = _host_ints((ovf, fill, wobs))
                holder["fill"] = int(hf)
                if hw:
                    holder["widths"] = {int(ci): int(w) for ci, w in hw.items()}
            else:
                ho = _host_ints(ovf)
        holder["plan"] = dict(p)
        return (out, occ), {"shuffle": int(ho)}

    def replan(p, counts, exc):
        # one count merges bucket drops and width truncations: grow
        # every knob that can absorb the overflow
        new = dict(p)
        grew = False
        needed = exc.needed if exc is not None else None
        w = _double_widths(p["string_widths"], needed)
        if w != p["string_widths"]:
            new["string_widths"], grew = w, True
        if p["wire_widths"]:
            new["wire_widths"], grew = None, True
        want = p["capacity"] + (counts or {}).get("shuffle", 0)
        cap = min(max(GROWTH * p["capacity"], want), n_local)
        if cap > p["capacity"]:
            new["capacity"], grew = cap, True
        return new if grew else None

    def estimate(p):
        row_b = _table_row_bytes(_row_table(table), p.get("string_widths"))
        return n_dev * n_dev * int(p["capacity"]) * row_b

    value = _run_with_retry("shuffle", attempt, replan, estimate, plan)
    obs = {}
    if holder.get("fill") is not None:
        obs["capacity"] = int(holder["fill"])
    if holder.get("widths"):
        obs["string_widths"] = holder["widths"]
    _record_exec_feedback(memo_key, "shuffle", holder.get("plan"), obs)
    return value
