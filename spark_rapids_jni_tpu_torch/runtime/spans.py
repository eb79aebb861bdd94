"""Causal span tracing: the Dapper/Spark-TaskMetrics trace model for
the host-side runtime (the port's copy of the JAX package's
``runtime/spans.py``: pure Python, same names, same ids, same registry).

The journal (``runtime/events.py``) records *what* happened — a flat
ordered ring of discrete events. Nothing in it says *why*: an
``injected_fault`` cannot be traced back to the retry round that took
it, a ``compile_cache_miss`` not to the plan build that triggered it, a
``capacity_overflow`` not to the task whose budget it was charged
against. This module adds the causal dimension the way Dapper (and
Spark's driver-side TaskMetrics aggregation) does: every host control
scope opens a **span** — a node with a monotonic process-unique id, a
parent link, and the owning task id — and every journal event emitted
while a span is current is stamped with that span's identity
(``span_id`` / ``parent_id`` / ``task_id``, JSONL schema v2).

Span hierarchy (kinds)::

    task                      resource.task scope (or the per-context
      |                       ambient root when no scope is open)
      +- op                   api.py facade entry / Pipeline.run
      +- run_plan             resource retry driver invocation
      |    +- retry_round     one execution attempt (attempt 0 incl.)
      +- plan_build           pipeline trace+compile of a chain
      +- collect_stage        driver-side collect sync point

Propagation is a ``contextvars.ContextVar`` holding an immutable stack
tuple — thread-safe (each thread sees its own stack) and async-safe,
with zero per-op boilerplate: the existing choke points (facade
wrapper, resource driver, pipeline build, distributed collect) open
spans; producers never do.

Emission discipline: a span does NOT journal its own begin — its close
emits one ``span_end`` event carrying ``wall_ms`` (Chrome-trace
"complete event" shape: end timestamp + duration reconstruct the
slice). Spans whose scope already closes with a schema'd event reuse
it instead (``emit_end=False``): the facade op span closes via its
``op_end``, the task span via ``task_done`` — both carry ``wall_ms``
and are emitted while the span is still current, so their ``span_id``
IS the span. ``runtime/traceview.py`` renders all three close shapes
as named slices.

The stack is maintained even with the metrics sink ``off`` (the flight
recorder's "active span stack at failure" must work regardless); only
journal emission is gated, inside ``events.emit``.

Live-span registry: contextvar stacks are visible only to
their own thread, but live introspection (``runtime/diag.py``
``/spans``, the ``runtime/sampler.py`` sampling profiler) needs ANY
thread to snapshot EVERY thread's in-flight task→op→run_plan chain.
Every stack mutation therefore also mirrors the stack into a
process-wide, lock-guarded map keyed by thread ident — spans weakly
held (a dead context must not pin its spans), entries pruned lazily on
close/adoption/snapshot so the cross-thread ``adopt()`` path stays
correct: a task span adopted by a second thread appears under BOTH
idents until one closes it, after which every snapshot drops it.
Streaming chunk spans that leave the stack via ``detach`` (open
dispatch→retirement, runtime/pipeline.py) are tracked in a parallel
weak table so an in-flight chunk's op/run_plan span still resolves to
its task root in the ``/spans`` tree.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

# the documented span vocabulary (docs/OBSERVABILITY.md span model)
KINDS = (
    "task",
    "op",
    "run_plan",
    "retry_round",
    "plan_build",
    "collect_stage",
    "stream",  # Pipeline.stream window: parents the per-chunk op
    #   spans, which stay open dispatch->retirement so the rendered
    #   timeline shows chunks overlapping (runtime/pipeline.py)
    "stage",  # one ANALYZE-mode chain stage (runtime/pipeline.py):
    #   opened per stage at the analyzed sync under the chunk's
    #   run_plan span; its wall is that stage's slice of the chain
    #   wall (the slices PARTITION it), and the stage's stage_metrics
    #   journal event is stamped with it
    "job",  # a serving job's whole life (serving/server.py): opens at
    #   the admission offer, survives queueing, parents the job's task
    #   span (so every interleaved slice chains up through it), and
    #   closes at retire/fail with the time-in-state breakdown in its
    #   span_end attrs — the unit traceview renders per-session tracks
    #   from, and the unit the flight recorder's slow-job trigger ships
)


@dataclasses.dataclass(eq=False)  # identity semantics: spans are nodes
class Span:
    sid: int
    parent_id: Optional[int]
    kind: str
    name: str
    task_id: Optional[int]
    t0: float  # perf_counter at open (duration basis)
    ts0: float  # wall clock at open (flight-recorder context)
    closed: bool = False  # set by close_span; lets OTHER contexts that
    # adopted this span (cross-thread task re-entry) prune it lazily —
    # a contextvar stack can only be mutated from its own thread


_ids = itertools.count(1)
_ids_lock = threading.Lock()
_stack: "contextvars.ContextVar[Tuple[Span, ...]]" = contextvars.ContextVar(
    "sprt_span_stack", default=()
)

# ---- live-span registry (process-wide; any thread can snapshot) ----
# thread ident -> (thread name, tuple of weakref.ref(Span), outermost
# first). Written by _set_stack on EVERY stack mutation of that thread;
# read under _live_lock by live_stacks(). Spans are weakly held — the
# contextvar owns them; a context that vanished with open spans must
# not be pinned alive by its registry mirror.
_live_lock = threading.Lock()
# sprtcheck: guarded-by=_live_lock
_live: Dict[int, Tuple[str, Tuple["weakref.ref[Span]", ...]]] = {}
# open spans detached from their context (streaming chunks between
# dispatch and retirement): sid -> weakref — still in flight, still
# part of the live tree, on no thread's stack
# sprtcheck: guarded-by=_live_lock
_detached: Dict[int, "weakref.ref[Span]"] = {}


def _set_stack(st: Tuple[Span, ...]) -> None:
    """The single mutation point for this context's stack: update the
    contextvar AND mirror the stack into the process-wide registry so
    live introspection (diag /spans, the sampler) can see it from any
    thread. An empty stack removes the thread's entry."""
    _stack.set(st)
    ident = threading.get_ident()
    with _live_lock:
        if st:
            _live[ident] = (
                threading.current_thread().name,
                tuple(weakref.ref(s) for s in st),
            )
        else:
            _live.pop(ident, None)


def _next_id() -> int:
    # itertools.count.__next__ is atomic under CPython, but the GIL is
    # an implementation detail — a span id collision would silently
    # merge two traces, so pay the explicit lock
    with _ids_lock:
        return next(_ids)


def current() -> Span:
    """The innermost OPEN span of this context. Spans closed from
    another thread (a cross-thread ``task_done``) are pruned lazily
    here — the closer cannot reach this context's stack. A context
    that never opened a span gets a lazy ambient ROOT of kind ``task``
    (name ``ambient``) so every journal event — even from code running
    outside any resource scope — has a chain terminating at a task
    span."""
    st = _stack.get()
    if st and st[-1].closed:
        while st and st[-1].closed:
            st = st[:-1]
        _set_stack(st)
    if st:
        return st[-1]
    root = Span(
        _next_id(), None, "task", "ambient", None,
        time.perf_counter(), time.time(),
    )
    _set_stack((root,))
    return root


def current_ids() -> Tuple[int, Optional[int], Optional[int]]:
    """(span_id, parent_id, task_id) of the current span — the three
    fields ``events.emit`` stamps onto every schema-v2 journal line."""
    s = current()
    return s.sid, s.parent_id, s.task_id


def open_span(kind: str, name: str, task_id: Optional[int] = None) -> Span:
    """Push a new span under the current one. ``task_id`` defaults to
    the parent's (inheritance down the tree); a task span sets its
    own."""
    parent = current()
    s = Span(
        _next_id(),
        parent.sid,
        kind,
        name,
        task_id if task_id is not None else parent.task_id,
        time.perf_counter(),
        time.time(),
    )
    _set_stack(_stack.get() + (s,))
    return s


def close_span(s: Span, emit_end: bool = True, **attrs) -> float:
    """Close ``s``: journal its ``span_end`` (unless the scope's own
    close event serves — ``emit_end=False``) and pop it, plus any
    leaked children above it, from this context's stack. Closing a
    span that is not on the current context's stack (imperative
    task_done from another thread) just emits. Returns wall_ms."""
    wall_ms = (time.perf_counter() - s.t0) * 1000
    if emit_end:
        from . import events as _events

        _events.emit(
            "span_end",
            op=s.name,
            _span=s,
            kind=s.kind,
            wall_ms=round(wall_ms, 3),
            **attrs,
        )
    s.closed = True  # other contexts that adopted s prune it lazily
    with _live_lock:
        _detached.pop(s.sid, None)  # a closed span is no longer in flight
    st = _stack.get()
    if s in st:
        _set_stack(st[: st.index(s)])
    return wall_ms


def detach(s: Span) -> None:
    """Remove an OPEN span (and any children still above it) from this
    context's stack WITHOUT closing it — the streaming executor's
    per-chunk spans stay open across dispatch -> retirement while
    later chunks' spans must open as SIBLINGS under the stream span,
    not as children of an earlier chunk. Parent links were fixed at
    ``open_span`` time, so a detached span keeps its place in the
    tree; re-enter it with ``adopt`` and close it with ``close_span``
    as usual."""
    st = _stack.get()
    if s in st:
        # the span (and any children detached with it) stays in flight:
        # keep it visible to live introspection via the detached table
        with _live_lock:
            for d in st[st.index(s):]:
                if not d.closed:
                    _detached[d.sid] = weakref.ref(d)
        _set_stack(st[: st.index(s)])


def adopt(s: Span) -> None:
    """Push an EXISTING open span onto this context's stack — the
    cross-thread task re-entry path (resource.start_task by id from a
    thread other than the creator's): contextvars do not propagate
    across threads, so without adoption the re-entering thread's
    events would stamp ambient instead of the task. No-op for a
    closed or already-present span."""
    if s.closed:
        return
    with _live_lock:
        _detached.pop(s.sid, None)  # back on a context stack
    st = _stack.get()
    if s not in st:
        _set_stack(st + (s,))


@contextlib.contextmanager
def span(
    kind: str,
    name: str,
    task_id: Optional[int] = None,
    emit_end: bool = True,
    **attrs,
):
    """``with spans.span("run_plan", op):`` — the context form every
    choke point uses."""
    s = open_span(kind, name, task_id)
    try:
        yield s
    finally:
        close_span(s, emit_end=emit_end, **attrs)


def active_stack() -> List[dict]:
    """The open spans of this context, outermost first — the flight
    recorder's "where was the program when it died" artifact."""
    return [dataclasses.asdict(s) for s in _stack.get()]


# --------------------------------------------------------------------
# live introspection (diag /spans + the sampling profiler)


def live_stacks() -> Dict[int, Tuple[str, List[Span]]]:
    """Snapshot of every thread's OPEN span stack: ``{thread_ident:
    (thread_name, [spans outermost first])}``. Callable from any
    thread (the registry is the cross-thread mirror of the per-context
    stacks). Dead threads' entries and spans closed since the mirror
    was written are pruned here — the lazy half of the close/adoption
    pruning contract."""
    alive = {t.ident for t in threading.enumerate()}
    out: Dict[int, Tuple[str, List[Span]]] = {}
    with _live_lock:
        for ident in [i for i in _live if i not in alive]:
            del _live[ident]
        items = list(_live.items())
    for ident, (name, refs) in items:
        spans_ = [s for r in refs if (s := r()) is not None and not s.closed]
        if spans_:
            out[ident] = (name, spans_)
    return out


def detached_spans() -> List[Span]:
    """Open spans currently on NO thread's stack (streaming chunks
    between dispatch and retirement) — still in flight, still part of
    the live tree. Dead/closed entries are pruned here."""
    out: List[Span] = []
    with _live_lock:
        for sid in list(_detached):
            s = _detached[sid]()
            if s is None or s.closed:
                del _detached[sid]
            else:
                out.append(s)
    return out


def live_tree() -> dict:
    """JSON-able snapshot of the whole in-flight span forest — the
    payload of the diag ``/spans`` endpoint: per-thread stacks plus
    detached streaming spans, each span with its ids, kind/name,
    owning task, and age. Parent links are included so a reader can
    resolve every in-flight op/run_plan chain to its task root."""
    now_pc, now_ts = time.perf_counter(), time.time()

    def node(s: Span) -> dict:
        return {
            "span_id": s.sid,
            "parent_id": s.parent_id,
            "kind": s.kind,
            "name": s.name,
            "task_id": s.task_id,
            "age_ms": round((now_pc - s.t0) * 1000, 3),
            "opened_unix": s.ts0,
        }

    threads = [
        {
            "thread_ident": ident,
            "thread_name": name,
            "stack": [node(s) for s in stack],
        }
        for ident, (name, stack) in sorted(live_stacks().items())
    ]
    return {
        "ts": now_ts,
        "threads": threads,
        "detached": [
            node(s) for s in sorted(detached_spans(), key=lambda s: s.sid)
        ],
    }


def reset() -> None:
    """Drop this context's stack and restart the id sequence (tests).
    Other live contexts keep their (now orphaned) stacks; ids restart,
    so never call this mid-trace outside tests."""
    global _ids
    _set_stack(())
    with _live_lock:
        _live.clear()
        _detached.clear()
    with _ids_lock:
        _ids = itertools.count(1)
