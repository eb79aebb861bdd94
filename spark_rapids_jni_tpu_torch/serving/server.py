"""The fair interleaver: one dispatch thread, many tenants (the port's
copy of the JAX package's ``serving/server.py``, over the port's
CUDA-graph runtime).

``Server`` multiplexes ``Pipeline.stream``-style windows across every
active session's jobs on a SINGLE dispatch thread — the serving form
of the streaming executor's overlap contract. Each scheduler turn
visits sessions in round-robin order and gives the session's
oldest job ONE slice: dispatch the next chunk if the job's window has
room (plan lookup + graph replay enqueue only — the slice is sync-free
per the sprtcheck dispatch-path contract), else retire the oldest
in-flight chunk (the ONE deferred host sync plus the driver-side
collect).
Retirement fans out to per-session waiters through each ``Job``'s
completion event; admission (admission.py) ran before the first
slice, so a slice never discovers an over-capacity tenant mid-flight.

On a card every tenant's replays run on the device's one replay stream
under one lock (``runtime/pipeline._GraphProgram``), so tenants sharing
a plan shape are safe and all replays are serialised; the first chunk
of a new plan captures its graph on the dispatch thread, and every
tenant waits for that capture. A device error in one tenant's slice
(a ``torch.cuda.OutOfMemoryError`` included) fails that job only: the
loop catches it in ``_slice`` and goes on serving the others.

Every slice runs inside the owning session's ``contextvars.Context``
(knob isolation) under ``resource.use_task`` (budget + journal
attribution), so work interleaved at chunk granularity still charges
the right tenant and stamps the right task span.

Single-writer discipline: all scheduling state (``_intake``,
``_closing``, ``_sessions``, ``_active``) mutates under ``_lock``;
the dispatch loop is the only writer of job execution state, so jobs
need no locks of their own beyond the completion event. That is also
why ``close_session`` does NOT tear down inline: a client-thread
``_fail`` could race the loop mid-``_slice`` on the same job, so
teardown is enqueued on ``_closing`` and the loop runs it between
slices (``shutdown`` tears down inline only after joining the loop).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..runtime import diag as _diag
from ..runtime import events as _events
from ..runtime import flight as _flight
from ..runtime import metrics as _metrics
from ..runtime import pipeline as _pipeline
from ..runtime import resource as _resource
from ..runtime import spans as _spans
from .admission import AdmissionController, AdmissionRejected
from .session import Session

_job_ids = itertools.count(1)


class ServerClosedError(RuntimeError):
    pass


class Job:
    """One admitted (or queued) unit of work: a pipeline mapped over a
    chunk sequence with an in-flight window, owned by one session.
    ``result()`` blocks the submitting tenant until the dispatch
    thread delivers the per-chunk results (input order, same values
    as ``Pipeline.stream``) or the failure that ended the job."""

    def __init__(self, session: Session, pipe, chunks, window, collect):
        self.job_id = next(_job_ids)
        self.session = session
        self.pipe = pipe
        # kept LAZY on the client thread: a chunk source may be a
        # generator doing real work per element (a prefetched parquet
        # scan — runtime/scan.py); the dispatch thread materializes it
        # at admission (_admit), where a decode error fails only this
        # job instead of raising on submit
        self.chunks: Any = chunks
        self.window = int(window)
        self.collect = bool(collect)
        self.state = "submitted"  # -> queued|active -> done|failed
        self.estimate = 0  # priced at intake (admission reservation)
        self.sig: Optional[str] = None
        self.fb_on = False
        self.task: Optional[_resource.Task] = None
        self.next_idx = 0
        self.inflight: List[dict] = []
        self.results: List[Any] = []
        self._exc: Optional[BaseException] = None
        self._event = threading.Event()
        # -- SLO engine state. Written by the dispatch
        # thread only (single-writer, like the execution state above);
        # the submit instant is the one client-thread write, made
        # before the job is published to intake.
        self.deadline_s: Optional[float] = None  # queue TTL AND e2e SLO
        self.t_submit = time.perf_counter()
        self.t_activate: Optional[float] = None
        self.t_mark = 0.0  # last accounted instant (state attribution)
        # time-in-state attribution, summing to the e2e wall: queued
        # (submit -> activation), dispatch (enqueue-slice walls),
        # retire (retire-slice walls minus the host sync), device
        # (the retire sync + between-slice gaps — in-flight chunks
        # executing while the loop serves other tenants)
        self.states = {
            "queued_ms": 0.0,
            "dispatch_ms": 0.0,
            "device_ms": 0.0,
            "retire_ms": 0.0,
        }
        self._sync_ms = 0.0  # last retire slice's host-sync portion
        self.e2e_ms: Optional[float] = None  # set when the span closes
        self.span: Optional[_spans.Span] = None  # the job span
        self.slo_ref_ms: Optional[float] = None  # admission-time est.
        self.slo_bundle: Optional[str] = None
        self._slo_checked = False  # the trigger never double-records

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[Any]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} not done within {timeout}s"
            )
        if self._exc is not None:
            raise self._exc
        return self.results


class Server:
    """The serving driver. ``start()`` spins the dispatch thread and
    registers the ``/sessions`` provider; ``open_session`` /
    ``submit`` / ``close_session`` are the tenant API (thread-safe);
    ``shutdown()`` drains nothing — it fails every still-pending job,
    wherever it is parked (intake, the admission queue, active), so
    waiters unblock deterministically."""

    def __init__(
        self,
        capacity_bytes: int,
        *,
        max_queue: int = 16,
        default_deadline_s: float = 30.0,
    ):
        self.admission = AdmissionController(
            capacity_bytes,
            max_queue=max_queue,
            default_deadline_s=default_deadline_s,
        )
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # sprtcheck: guarded-by=_lock
        self._sessions: Dict[int, Session] = {}
        # submitted-but-not-yet-priced jobs (client threads append,
        # the dispatch thread drains — admission runs on the dispatch
        # thread so pricing sees a consistent reservation ledger)
        # sprtcheck: guarded-by=_lock
        self._intake: List[tuple] = []  # (job, deadline_s)
        # session-close requests (session, done_event): client threads
        # append, the dispatch thread tears down between slices — a
        # client-side teardown could race _slice on the same job
        # sprtcheck: guarded-by=_lock
        self._closing: List[tuple] = []
        # admitted jobs in arrival order per session, the round-robin
        # universe; _rr rotates the session visit order
        # sprtcheck: guarded-by=_lock
        self._active: Dict[int, List[Job]] = {}
        self._rr: List[int] = []
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- tenant API ----------------------------------------------------

    def start(self) -> "Server":
        with self._lock:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="sprt-serving-dispatch", daemon=True
        )
        self._thread.start()
        _diag.set_sessions_provider(self.sessions_table)
        return self

    def open_session(self, name: Optional[str] = None, **kw) -> Session:
        s = Session(name, **kw)
        with self._lock:
            if not self._running:
                raise ServerClosedError("server not running")
            self._sessions[s.session_id] = s
            self._active.setdefault(s.session_id, [])
            self._rr.append(s.session_id)
        _metrics.gauge("serving.sessions").set(len(self._sessions))
        return s

    def close_session(self, session: Session) -> None:
        """Tear down ``session``, failing its pending jobs. Blocks
        until the dispatch thread has run the teardown (between
        slices — a client-side teardown could race a slice on the
        same job); runs inline only once the loop has stopped."""
        with self._lock:
            done: Optional[threading.Event] = None
            if self._running:
                done = threading.Event()
                self._closing.append((session, done))
                self._wake.notify()
        if done is not None:
            done.wait()
            return
        self._teardown_session(session)

    def _teardown_session(self, session: Session) -> None:
        """Remove every trace of ``session`` — scheduling tables,
        intake, the admission queue — and fail its pending jobs.
        Dispatch-thread only while the loop runs (see close_session);
        the shutdown path calls it after joining the loop."""
        sid = session.session_id
        with self._lock:
            self._sessions.pop(sid, None)
            pending = self._active.pop(sid, [])
            self._rr = [i for i in self._rr if i != sid]
            pending += [
                j for j, _ in self._intake if j.session is session
            ]
            self._intake = [
                (j, d) for j, d in self._intake
                if j.session is not session
            ]
        # queued-at-admission jobs hold no reservation: purge, never
        # promote, or they would leak headroom with no owner to run
        pending += self.admission.purge_session(session)
        for job in pending:
            # the owner is walking away: unwind in-flight device work
            # and unblock any other waiter on the job
            if not job.done():
                self._fail(job, ServerClosedError(
                    f"session {session.name!r} closed with job "
                    f"{job.job_id} pending"
                ))
        session.close()
        _metrics.gauge("serving.sessions").set(len(self._sessions))

    def submit(
        self,
        session: Session,
        pipe,
        chunks: Sequence[Any],
        *,
        window: int = 2,
        collect: bool = True,
        deadline_s: Optional[float] = None,
    ) -> Job:
        """Enqueue a job for ``session``. Returns immediately; the
        admission verdict and the results both arrive through the
        ``Job`` (an up-front rejection raises ``AdmissionRejected``
        from ``result()``)."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        job = Job(session, pipe, chunks, window, collect)
        job.deadline_s = deadline_s  # queue TTL and, once active, e2e SLO
        session._bump("jobs")
        _metrics.counter("serving.jobs").inc()
        with self._lock:
            if not self._running:
                raise ServerClosedError("server not running")
            if session.session_id not in self._sessions:
                raise ServerClosedError(
                    f"session {session.name!r} is closed"
                )
            self._intake.append((job, deadline_s))
            self._wake.notify()
        return job

    def shutdown(self) -> None:
        with self._lock:
            if not self._running:
                return
            self._running = False
            self._wake.notify()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _diag.set_sessions_provider(None)
        # the loop is gone: tear down inline. Per-session teardown
        # covers active + intake + queued-at-admission jobs; drain()
        # (never promote(), which would reserve headroom for jobs
        # nobody will ever run) catches queue entries whose owner
        # already left, and the final sweep anything else.
        with self._lock:
            closing = self._closing
            self._closing = []
        for s in list(self._sessions.values()):
            self._teardown_session(s)
        leftovers = self.admission.drain()
        with self._lock:
            leftovers += [j for j, _ in self._intake]
            self._intake = []
            for jobs in self._active.values():
                leftovers += jobs
                jobs.clear()
        for job in leftovers:
            if not job.done():
                self._fail(job, ServerClosedError("server shut down"))
        for _, done in closing:
            # racing close_session callers: their session was torn
            # down above — unblock them
            done.set()
        _metrics.gauge("serving.active_jobs").set(0)

    def sessions_table(self) -> List[dict]:
        with self._lock:
            sessions = list(self._sessions.values())
            active = {
                sid: len(jobs) for sid, jobs in self._active.items()
            }
        rows = []
        for s in sessions:
            row = s.row()
            row["active_jobs"] = active.get(s.session_id, 0)
            rows.append(row)
        rows.append({"admission": self.admission.stats()})
        return rows

    # -- the dispatch loop ---------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._lock:
                if not self._running:
                    return
                closing = self._closing
                self._closing = []
            # teardown happens HERE, between slices, never under a
            # client thread (close_session blocks on the event): the
            # loop cannot be mid-_slice on a job it is failing
            for session, done in closing:
                try:
                    self._teardown_session(session)
                finally:
                    done.set()
            with self._lock:
                intake = self._intake
                self._intake = []
                order = list(self._rr)
                if self._rr:
                    # rotate: the session served first this turn goes
                    # last next turn — arrival order never becomes a
                    # permanent priority
                    self._rr.append(self._rr.pop(0))
            for job, deadline_s in intake:
                self._admit(job, deadline_s)
            # promote() re-reserved capacity for every promoted job;
            # each must activate or fail, or the ledger drifts (a
            # leaked reservation shrinks the device forever; a checked
            # contract)
            # sprtcheck: acquires=admission-reservation release=_activate,_fail
            promoted, expired = self.admission.promote()
            for job in promoted:
                try:
                    self._activate(job)
                except BaseException as e:
                    # one tenant's activation failure must not kill
                    # the dispatch loop or strand its sibling
                    # promotions' reservations
                    self._fail(job, e)
            for job in expired:
                self._fail(job, AdmissionRejected(
                    job.session.name, "deadline", job.estimate
                ))
            did_work = False
            for sid in order:
                with self._lock:
                    jobs = self._active.get(sid, [])
                    job = jobs[0] if jobs else None
                if job is not None:
                    did_work = True
                    self._slice(job)
            with self._lock:
                n_active = sum(len(v) for v in self._active.values())
            _metrics.gauge("serving.active_jobs").set(n_active)
            if not did_work:
                with self._lock:
                    if (
                        self._running
                        and not self._intake
                        and not self._closing
                        and not any(self._active.values())
                    ):
                        # deadline granularity: queued jobs must still
                        # expire while the device idles
                        self._wake.wait(timeout=0.05)

    # -- intake: pricing + admission -----------------------------------

    def _admit(self, job: Job, deadline_s: Optional[float]) -> None:
        with self._lock:
            live = job.session.session_id in self._sessions
        if not live:
            # submitted while a close request was in flight: the
            # teardown ran before this intake drain, so fail here —
            # queueing it would park a job nobody will ever slice
            self._fail(job, ServerClosedError(
                f"session {job.session.name!r} is closed"
            ), release=False)
            return
        # the job span opens HERE — at the admission offer, on the
        # dispatch thread — backdated to the submit instant so the
        # rendered job slice covers intake wait too. It stays open
        # (detached) across queueing and every interleaved slice; the
        # admission decision events below fire while it is current, so
        # they journal as its children.
        sp = _spans.open_span("job", f"job:{job.session.name}#{job.job_id}")
        backdate = time.perf_counter() - job.t_submit
        sp.t0 -= backdate
        sp.ts0 -= backdate
        sp.session = job.session.name  # sampler folds session:<name>
        job.span = sp
        try:
            # materialize a lazy chunk source HERE, on the dispatch
            # thread inside the job's failure domain: a scan-backed
            # source (Pipeline.scan_parquet chunks) decodes pages as
            # it drains, and a decode error must fail THIS job — not
            # escape on the client's submit call, not kill the loop
            job.session.run_in_context(self._materialize, job)
            job.session.run_in_context(self._price, job)
            # an "admitted" verdict reserves capacity; the job must
            # reach _activate (or give the reservation back) on every
            # path out, exception edges included
            # sprtcheck: acquires=admission-reservation release=_activate,_mark_queued,_fail,release
            verdict = self.admission.offer(job, deadline_s)
        except BaseException as e:  # AdmissionRejected or a pricing bug
            # admission_reject already journaled under the span; _fail
            # closes it with the rejected/failed state (offer raises
            # only on its reject paths — nothing reserved to return)
            self._fail(job, e, release=False)
            return
        try:
            _events.emit(
                "admission_decision",
                session=job.session.name,
                job=job.job_id,
                verdict=verdict,
                estimate_bytes=int(job.estimate),
            )
            _spans.detach(sp)  # survives queueing off any context stack
            if verdict == "admitted":
                self._activate(job)
            else:
                self._mark_queued(job)
        except BaseException as e:
            # an admitted offer holds its reservation: before the job
            # went active, give it back by hand; once active, _fail's
            # own release arm owns it. Either way it must not leak.
            if verdict == "admitted" and job.state != "active":
                self.admission.release(job)
            self._fail(job, e)
            return

    def _mark_queued(self, job: Job) -> None:
        """The queued verdict's bookkeeping: a queued job holds NO
        reservation (promote() re-reserves at promotion), so queueing
        discharges the admission obligation without touching the
        ledger."""
        job.state = "queued"

    @staticmethod
    def _materialize(job: Job) -> None:
        """Drain a lazy chunk source into the job's list (idempotent
        for plain lists). A generator source that raises mid-drain
        unwinds through its own finally (a prefetched scan joins its
        decode workers there) before the error reaches _admit's
        failure path."""
        if not isinstance(job.chunks, list):
            job.chunks = list(job.chunks)

    @staticmethod
    def _price(job: Job) -> None:
        """Cost estimate from the capacity-feedback observations: the
        initial plan the job's FIRST chunk would get (warm-started
        when the session's feedback knob is on), through the same
        estimator the retry driver budgets with, times the in-flight
        window. Runs inside the session context — the feedback knob
        and hence the signature are the tenant's own."""
        pipe, chunks = job.pipe, job.chunks
        job.fb_on = _pipeline.capacity_feedback()
        job.sig = pipe.signature_hash() if job.fb_on else None
        if not chunks:
            job.estimate = 0
            return
        n_rows = max(c.num_rows for c in chunks)
        _, row_b = pipe._estimate_basis(chunks[0])
        plan0 = pipe._initial_plan(
            n_rows,
            _pipeline._feedback_for(job.sig) if job.fb_on else None,
        )
        per_chunk = pipe._estimate_from_basis(n_rows, row_b, plan0)
        job.estimate = per_chunk * min(job.window, len(chunks))

    def _activate(self, job: Job) -> None:
        with self._lock:
            live = job.session.session_id in self._sessions
            if live:
                job.state = "active"
                self._active.setdefault(job.session.session_id, [])
                self._active[job.session.session_id].append(job)
        if not live:
            # promoted after its owner closed: offer()/promote()
            # reserved headroom for it — return the reservation, or
            # the orphan would shrink device capacity forever
            self.admission.release(job)
            self._fail(job, ServerClosedError(
                f"session {job.session.name!r} closed before job "
                f"{job.job_id} activated"
            ), release=False)
            return
        job.task = job.session.run_in_context(self._open_task, job)
        now = time.perf_counter()
        job.t_activate = job.t_mark = now
        queued_ms = (now - job.t_submit) * 1000
        job.states["queued_ms"] = queued_ms
        sess = job.session.name
        _metrics.histogram("serving.queue_wait_ms").observe(queued_ms)
        _metrics.histogram(
            f"serving.session.{sess}.queue_wait_ms"
        ).observe(queued_ms)
        # the admission-time latency estimate the slow-job trigger
        # multiplies: the session's live e2e median (None until the
        # session has completed-job history — only the deadline arm of
        # the trigger can fire for a tenant's first jobs)
        job.slo_ref_ms = _metrics.histogram_quantile(
            f"serving.session.{sess}.e2e_ms", 0.5
        )

    @staticmethod
    def _open_task(job: Job) -> _resource.Task:
        # open the job's task scope inside the session context, then
        # deactivate it: start_task pushes onto the dispatch thread's
        # stack and adopts the span, but the slice protocol
        # (resource.use_task) owns activation — a lingering entry
        # would charge the NEXT session's slice to this tenant.
        # Adopting the JOB span first parents the task span under it,
        # so every interleaved slice (op -> task -> job) resolves
        # through the job span up to the dispatch ambient root.
        if job.span is not None:
            # sprtcheck: acquires=job-span-adoption release=detach
            _spans.adopt(job.span)
        try:
            t = _resource.start_task(
                None, job.session.budget, job.session.max_retries, True
            )
            st = _resource._stack()
            st[:] = [x for x in st if x is not t]
            if t._span is not None:
                _spans.detach(t._span)
        finally:
            # a start_task failure must not strand the job span on the
            # dispatch thread's stack — it would misparent every later
            # tenant's slices under this job
            if job.span is not None:
                _spans.detach(job.span)
        return t

    # -- one scheduler slice -------------------------------------------

    @staticmethod
    @contextlib.contextmanager
    def _adopt_job(job: Job):
        """Put the job span under this slice's stack (inside the
        session context, so the live-registry mirror the sampler reads
        shows op -> task -> job for the slice's duration), detached
        again on exit like the task span."""
        if job.span is not None and not job.span.closed:
            _spans.adopt(job.span)
        try:
            yield
        finally:
            if job.span is not None and not job.span.closed:
                _spans.detach(job.span)

    def _slice(self, job: Job) -> None:
        try:
            now = time.perf_counter()
            if job.t_mark:
                # between-slice gap: the job's in-flight chunks were
                # executing on the device while the loop served other
                # tenants — the device-blocked share of its life
                job.states["device_ms"] += (now - job.t_mark) * 1000
            kind = None
            if (
                job.next_idx < len(job.chunks)
                and len(job.inflight) < job.window
            ):
                job.session.run_in_context(self._dispatch_one, job)
                kind = "dispatch_ms"
            elif job.inflight:
                job.session.run_in_context(self._retire_one, job)
                kind = "retire_ms"
            end = time.perf_counter()
            job.t_mark = end
            if kind is not None:
                slice_ms = (end - now) * 1000
                if kind == "retire_ms":
                    # the one host sync inside the retire slice is
                    # device time; only the driver-side collect +
                    # bookkeeping around it is retire time
                    sync = min(job._sync_ms, slice_ms)
                    job._sync_ms = 0.0
                    job.states["device_ms"] += sync
                    job.states["retire_ms"] += slice_ms - sync
                else:
                    job.states[kind] += slice_ms
                _metrics.histogram("serving.slice_ms").observe(slice_ms)
                _metrics.histogram(
                    f"serving.session.{job.session.name}.slice_ms"
                ).observe(slice_ms)
            if job.next_idx >= len(job.chunks) and not job.inflight:
                self._finish(job)
        except BaseException as e:
            self._fail(job, e)

    # sprtcheck: dispatch-path — the serving half of the streaming
    # contract: a slice that dispatches must only enqueue (plan
    # lookup/build + graph replay); the one host sync belongs to
    # _retire_one, or a deep window across N tenants serializes
    def _dispatch_one(self, job: Job) -> None:
        pipe = job.pipe
        chunk = job.chunks[job.next_idx]
        op_name = f"Pipeline.{pipe.name}"
        # the job span underlies the task span for this slice so the
        # sampler's folded stacks carry the session dimension; detached
        # again on exit (adopt_job is slice-scoped, like use_task)
        with self._adopt_job(job), _resource.use_task(job.task):
            t0 = time.perf_counter()
            rows_in, bytes_in = _metrics._rows_bytes(chunk)
            plan0 = pipe._initial_plan(
                chunk.num_rows,
                _pipeline._feedback_for(job.sig) if job.fb_on else None,
            )
            dispatch, sync, holder = pipe._dispatch_fns(chunk, False)
            n_est, row_b = pipe._estimate_basis(chunk)
            # sprtcheck: acquires=op-span release=close_span,detach
            sp = _spans.open_span("op", op_name)
            try:
                deferred = _resource.run_plan_deferred(
                    f"pipeline.{pipe.name}",
                    dispatch,
                    sync,
                    pipe._replan,
                    lambda p, _n=n_est, _rb=row_b: (
                        pipe._estimate_from_basis(_n, _rb, p)
                    ),
                    plan0,
                )
            except BaseException as exc:
                # close FIRST: a raise out of the metrics recording
                # must not strand the op span half-open
                _spans.close_span(sp, emit_end=False)
                if _metrics.enabled() and isinstance(exc, Exception):
                    _metrics.record_op(
                        op_name,
                        (time.perf_counter() - t0) * 1000,
                        rows_in=rows_in,
                        bytes_in=bytes_in,
                        ok=False,
                        error=type(exc).__name__,
                    )
                raise
            _spans.detach(sp)
            job.inflight.append({
                "index": job.next_idx,
                "chunk": chunk,
                "deferred": deferred,
                "holder": holder,
                "span": sp,
                "t0": t0,
                "rows_in": rows_in,
                "bytes_in": bytes_in,
            })
            job.next_idx += 1
            job.task._record_bytes(sum(
                e["deferred"].estimate_bytes() for e in job.inflight
            ))

    def _retire_one(self, job: Job) -> None:
        pipe = job.pipe
        op_name = f"Pipeline.{pipe.name}"
        with self._adopt_job(job), _resource.use_task(job.task):
            e = job.inflight.pop(0)
            # sprtcheck: acquires=op-span-adoption release=close_span
            _spans.adopt(e["span"])
            try:
                t_sync = time.perf_counter()
                out_tbl, live, nested = e["deferred"].retire()[:3]
                job._sync_ms = (time.perf_counter() - t_sync) * 1000
                # retirement drops the references that pin the chunk
                e["chunk"] = None
                e["holder"]["table"] = None
                if job.fb_on and e["holder"].get("stats"):
                    _pipeline._record_feedback(
                        job.sig, pipe.name,
                        e["holder"]["plan"], e["holder"]["stats"],
                    )
                # the same retirement tail as Pipeline.stream: a
                # from_json terminal assembles, a padded result compacts
                # at the sizes the one transfer brought, collect=False
                # hands back the padded pair
                out = pipe._collect(
                    out_tbl, live, nested, e["holder"], job.collect
                )
                wall_ms = (time.perf_counter() - e["t0"]) * 1000
                _events.emit(
                    "stream_retire",
                    op=op_name,
                    chunk=e["index"],
                    window=job.window,
                    shard_devices=0,
                    retries=e["deferred"].retries,
                    wall_ms=round(wall_ms, 3),
                )
                if _metrics.enabled():
                    rows_out, bytes_out = _metrics._rows_bytes(
                        out if job.collect else out_tbl
                    )
                    _metrics.record_op(
                        op_name,
                        wall_ms,
                        rows_in=e["rows_in"],
                        bytes_in=e["bytes_in"],
                        rows_out=rows_out,
                        bytes_out=bytes_out,
                    )
                job.results.append(out)
            except Exception as exc:
                if _metrics.enabled():
                    _metrics.record_op(
                        op_name,
                        (time.perf_counter() - e["t0"]) * 1000,
                        rows_in=e["rows_in"],
                        bytes_in=e["bytes_in"],
                        ok=False,
                        error=type(exc).__name__,
                    )
                raise
            finally:
                _spans.close_span(e["span"], emit_end=False)

    # -- completion ----------------------------------------------------

    def _finish(self, job: Job) -> None:
        with self._lock:
            jobs = self._active.get(job.session.session_id, [])
            jobs[:] = [j for j in jobs if j is not job]
        self.admission.release(job)
        job.session.run_in_context(self._close_task, job)
        job.state = "done"
        job.session._bump("done")
        job.session.publish_cache_counters()
        _metrics.counter("serving.jobs_done").inc()
        # span close (e2e + breakdown attrs, e2e histograms) and the
        # SLO check happen BEFORE the waiter unblocks, so a client that
        # returns from result() reads fully-published telemetry
        self._close_job_span(job, "done")
        self._maybe_slo(job)
        job._event.set()

    @staticmethod
    def _close_task(job: Job) -> None:
        if job.task is not None:
            _resource.task_done(job.task.task_id)

    def _close_job_span(self, job: Job, state: str) -> None:
        """Close the job span with the time-in-state breakdown in its
        span_end attrs — what traceview renders and the slow-job
        flight bundle ships. Accounts the tail (last mark -> now),
        stamps ``e2e_ms``, and publishes the e2e histograms for
        completed jobs. No-op for jobs that never reached ``_admit``
        (no span) or whose span already closed."""
        sp = job.span
        if sp is None or sp.closed:
            return
        now = time.perf_counter()
        if job.t_mark:
            job.states["device_ms"] += (now - job.t_mark) * 1000
            job.t_mark = now
        elif job.t_activate is None:
            # never activated (rejected, expired in queue, torn down):
            # its whole life was queued
            job.states["queued_ms"] = (now - job.t_submit) * 1000
        job.e2e_ms = (now - job.t_submit) * 1000
        sess = job.session.name
        _spans.close_span(
            sp,
            session=sess,
            job=job.job_id,
            task=job.task.task_id if job.task is not None else None,
            state=state,
            e2e_ms=round(job.e2e_ms, 3),
            **{k: round(v, 3) for k, v in job.states.items()},
        )
        if state == "done":
            _metrics.histogram("serving.e2e_ms").observe(job.e2e_ms)
            _metrics.histogram(
                f"serving.session.{sess}.e2e_ms"
            ).observe(job.e2e_ms)

    def _maybe_slo(self, job: Job) -> None:
        """The slow-job trigger (runtime/flight.py): evaluated exactly
        once, at job completion, and only while armed
        (``SPARK_JNI_TPU_SLO_FLIGHT``). A completed job whose e2e wall
        exceeded ``multiplier x`` its admission-time latency estimate
        (the session e2e median captured at activation) or its own
        ``deadline_s`` counts ``serving.slo_violations``, journals
        ``slo_violation``, and records ONE flight bundle carrying the
        job's span tree and time-in-state breakdown."""
        if job._slo_checked or job.e2e_ms is None:
            return
        job._slo_checked = True
        mult = _flight.slo_multiplier()
        if mult is None:
            return
        e2e = job.e2e_ms
        if job.deadline_s is not None and e2e > job.deadline_s * 1000:
            reason, threshold = "deadline", job.deadline_s * 1000
        elif job.slo_ref_ms is not None and e2e > mult * job.slo_ref_ms:
            reason, threshold = "slow", mult * job.slo_ref_ms
        else:
            return
        _metrics.counter("serving.slo_violations").inc()
        breakdown = {k: round(v, 3) for k, v in job.states.items()}
        job.slo_bundle = _flight.record_slow_job(
            session=job.session.name,
            job_id=job.job_id,
            e2e_ms=round(e2e, 3),
            threshold_ms=round(threshold, 3),
            reason=reason,
            breakdown=breakdown,
            span_tree=self._job_span_tree(job),
            task=job.task,
        )
        _events.emit(
            "slo_violation",
            session=job.session.name,
            job=job.job_id,
            e2e_ms=round(e2e, 3),
            threshold_ms=round(threshold, 3),
            reason=reason,
            bundle=job.slo_bundle,
        )

    @staticmethod
    def _job_span_tree(job: Job) -> List[dict]:
        """The job's resolved span tree, reconstructed from the event
        journal: every journaled span whose parent chain reaches the
        job span, as ``{span_id, parent_id, events: [names]}`` nodes
        (root first, then ascending span id). Best effort — spans
        whose events the bounded ring already evicted are absent."""
        root = job.span.sid if job.span is not None else None
        if root is None:
            return []
        parents: Dict[int, Optional[int]] = {root: job.span.parent_id}
        names: Dict[int, List[str]] = {root: [f"job:{job.job_id}"]}
        for ev in _events.events():
            sid = ev.get("span_id")
            if sid is None:
                continue
            parents.setdefault(sid, ev.get("parent_id"))
            label = ev["event"]
            if ev.get("op"):
                label = f"{label}({ev['op']})"
            names.setdefault(sid, [])
            if sid != root and label not in names[sid]:
                names[sid].append(label)

        def reaches(sid: int) -> bool:
            seen = set()
            while sid is not None and sid not in seen:
                if sid == root:
                    return True
                seen.add(sid)
                sid = parents.get(sid)
            return False

        return [
            {
                "span_id": sid,
                "parent_id": parents[sid],
                "events": names.get(sid, []),
            }
            for sid in sorted(parents, key=lambda s: (s != root, s))
            if reaches(sid)
        ]

    def _fail(
        self, job: Job, exc: BaseException, *, release: bool = True
    ) -> None:
        """End a job on ``exc``: unwind in-flight device work, leave a
        flight bundle for post-admission failures (the task-stamped
        bundle the chaos tests resolve), release the admission
        reservation, and unblock the waiter."""
        with self._lock:
            jobs = self._active.get(job.session.session_id)
            if jobs is not None:
                jobs[:] = [j for j in jobs if j is not job]
        for e in job.inflight:
            e["deferred"].abandon()
            _spans.adopt(e["span"])
            _spans.close_span(e["span"], emit_end=False)
        job.inflight = []
        if job.task is not None:
            # the task scope was open when the failure struck: record
            # the bundle BEFORE closing it so the bundle carries the
            # task id (flight.py name stamping) and its metrics
            if not isinstance(exc, AdmissionRejected):
                _flight.maybe_record(exc, task=job.task)
            job.session.run_in_context(self._close_task, job)
        released = release and job.state in ("active", "done")
        if released:
            self.admission.release(job)
        job.state = "failed"
        if isinstance(exc, AdmissionRejected):
            job.state = "rejected"
        else:
            job.session._bump("failed")
            _metrics.counter("serving.jobs_failed").inc()
        job.session.publish_cache_counters()
        # a failed/rejected job still closes its span (state in the
        # span_end attrs distinguishes it) but never feeds the e2e
        # histograms or the SLO trigger — latency SLOs are a contract
        # about completed work
        self._close_job_span(job, job.state)
        job._exc = exc
        job._event.set()
