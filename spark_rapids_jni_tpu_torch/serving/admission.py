"""Admission control: overload surfaces at the door, not mid-flight
(the port's copy of the JAX package's ``serving/admission.py``: the same
verdicts, reasons, queue and counters).

Every job arriving at the server carries a byte estimate priced from
the SAME machinery the retry driver budgets with: the chain's initial
plan (warm-started from the capacity-feedback observations when the
session's feedback knob is on) through ``Pipeline._estimate_from_
basis``, times the job's in-flight window. The controller then makes
the call the un-served library forces every tenant to discover the
hard way:

- the estimate exceeds the session's own budget → ``AdmissionRejected
  (reason=over_budget)`` — this job would march into RetryOOMError
  no matter how idle the device is, so refuse it before any device
  work queues;
- the estimate exceeds ``capacity_bytes`` outright → ``Admission
  Rejected(reason=over_capacity)`` — no amount of released headroom
  could ever admit it, so queueing it would only head-of-line-block
  every tenant behind it until its deadline;
- it fits the device headroom (``capacity_bytes`` minus reservations
  of everything already admitted) → admit, reserving the estimate
  until the job releases;
- no headroom but queue room → queue FIFO with a deadline; the server
  promotes head-of-line when releases free headroom (FIFO, no
  overtaking — a small job never starves a big one at the head), and
  expires entries past their deadline as ``reason=deadline``;
- queue full → ``AdmissionRejected(reason=queue_full)`` — bounded
  queueing is the backpressure contract: under sustained overload the
  client sees fast rejection, not unbounded latency.

All state mutates on the server's dispatch thread; ``_lock`` guards
the read side (``/metrics`` gauges and ``stats()`` scrape from any
thread).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..runtime import events as _events
from ..runtime import metrics as _metrics

DEFAULT_QUEUE_DEPTH = 16
DEFAULT_DEADLINE_S = 30.0


class AdmissionRejected(RuntimeError):
    """A job was refused up front. ``reason`` is one of
    ``over_budget`` / ``over_capacity`` / ``queue_full`` /
    ``deadline``."""

    def __init__(self, session: str, reason: str, estimate: int):
        super().__init__(
            f"session {session!r}: admission rejected ({reason}, "
            f"estimate {estimate} bytes)"
        )
        self.session = session
        self.reason = reason
        self.estimate = estimate


class AdmissionController:
    def __init__(
        self,
        capacity_bytes: int,
        *,
        max_queue: int = DEFAULT_QUEUE_DEPTH,
        default_deadline_s: float = DEFAULT_DEADLINE_S,
    ):
        if capacity_bytes <= 0:
            raise ValueError(
                f"capacity_bytes must be > 0, got {capacity_bytes}"
            )
        self.capacity_bytes = int(capacity_bytes)
        self.max_queue = int(max_queue)
        self.default_deadline_s = float(default_deadline_s)
        self._lock = threading.Lock()
        # sprtcheck: guarded-by=_lock
        self._inflight_bytes = 0
        # FIFO of queued jobs: (deadline_monotonic, job)
        # sprtcheck: guarded-by=_lock
        self._queue: List[tuple] = []

    # -- the decision --------------------------------------------------

    def offer(self, job, deadline_s: Optional[float] = None) -> str:
        """Admit, queue, or reject ``job`` (which carries ``session``,
        ``estimate``). Returns ``"admitted"`` or ``"queued"``; raises
        ``AdmissionRejected`` otherwise. Dispatch-thread only."""
        est = int(job.estimate)
        budget = job.session.budget
        if budget is not None and est > budget:
            self._reject(job, "over_budget")
        if est > self.capacity_bytes:
            # promote() could never admit this even on an idle device:
            # queueing it would head-of-line-block every tenant behind
            # it (strict FIFO) until its deadline — refuse now instead
            self._reject(job, "over_capacity")
        with self._lock:
            # a non-empty queue bars the fast path: arrivals admit
            # directly only when nobody is waiting — otherwise a small
            # late job would overtake the queued head (FIFO contract)
            if (
                not self._queue
                and self._inflight_bytes + est <= self.capacity_bytes
            ):
                self._inflight_bytes += est
                depth = len(self._queue)
                inflight = self._inflight_bytes
                admitted = True
            elif len(self._queue) < self.max_queue:
                ttl = (
                    self.default_deadline_s
                    if deadline_s is None else float(deadline_s)
                )
                self._queue.append((time.monotonic() + ttl, job))
                depth = len(self._queue)
                inflight = self._inflight_bytes
                admitted = False
            else:
                depth = None
                admitted = False
        if depth is None:
            self._reject(job, "queue_full")
        self._publish(depth, inflight)
        if admitted:
            _metrics.counter("admission.admitted").inc()
            return "admitted"
        _metrics.counter("admission.queued").inc()
        job.session._bump("queued")
        return "queued"

    def promote(self) -> tuple:
        """Expire queued jobs past their deadline and admit as many
        head-of-line survivors as the freed headroom fits. Returns
        ``(admitted_jobs, expired_jobs)``; the caller activates the
        former and fails the latter (each expired job already counted
        and journaled here). Dispatch-thread only."""
        now = time.monotonic()
        admitted, expired = [], []
        with self._lock:
            keep = []
            for deadline, job in self._queue:
                if deadline < now:
                    expired.append(job)
                else:
                    keep.append((deadline, job))
            self._queue = keep
            while self._queue:
                _, job = self._queue[0]
                est = int(job.estimate)
                if self._inflight_bytes + est > self.capacity_bytes:
                    break  # strict FIFO: no overtaking past the head
                self._queue.pop(0)
                self._inflight_bytes += est
                admitted.append(job)
            depth = len(self._queue)
            inflight = self._inflight_bytes
        for job in expired:
            _metrics.counter("admission.timeouts").inc()
            self._journal_reject(job, "deadline")
        if admitted:
            _metrics.counter("admission.admitted").inc(len(admitted))
        self._publish(depth, inflight)
        return admitted, expired

    def release(self, job) -> None:
        """Return an admitted job's reservation (completion, failure,
        or cancellation of a queued-then-expired job never calls
        this — only admitted reservations release)."""
        with self._lock:
            self._inflight_bytes = max(
                0, self._inflight_bytes - int(job.estimate)
            )
            depth = len(self._queue)
            inflight = self._inflight_bytes
        self._publish(depth, inflight)

    def drain(self) -> list:
        """Remove and return EVERY queued job (server shutdown).
        Queued entries hold no reservation — the caller fails them,
        nothing to release. Call only after the dispatch thread has
        stopped (or from it)."""
        with self._lock:
            jobs = [job for _, job in self._queue]
            self._queue = []
            inflight = self._inflight_bytes
        self._publish(0, inflight)
        return jobs

    def purge_session(self, session) -> list:
        """Remove and return the queued jobs owned by ``session``
        (session teardown), preserving the FIFO order of every other
        tenant's entries. Queued entries hold no reservation.
        Dispatch-thread only."""
        with self._lock:
            mine = [
                job for _, job in self._queue if job.session is session
            ]
            self._queue = [
                (d, job) for d, job in self._queue
                if job.session is not session
            ]
            depth = len(self._queue)
            inflight = self._inflight_bytes
        self._publish(depth, inflight)
        return mine

    # -- bookkeeping ---------------------------------------------------

    def _reject(self, job, reason: str) -> None:
        _metrics.counter("admission.rejected").inc()
        self._journal_reject(job, reason)
        raise AdmissionRejected(job.session.name, reason, job.estimate)

    @staticmethod
    def _journal_reject(job, reason: str) -> None:
        job.session._bump("rejected")
        _events.emit(
            "admission_reject",
            session=job.session.name,
            reason=reason,
            estimate_bytes=int(job.estimate),
        )

    @staticmethod
    def _publish(depth: int, inflight: int) -> None:
        _metrics.gauge("admission.queue_depth").set(depth)
        _metrics.gauge("admission.inflight_bytes").set(inflight)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity_bytes": self.capacity_bytes,
                "inflight_bytes": self._inflight_bytes,
                "queue_depth": len(self._queue),
                "max_queue": self.max_queue,
            }
