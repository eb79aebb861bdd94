"""Serving sessions: the tenant half of the Session/Context split (the
port's copy of the JAX package's ``serving/session.py``).

Every process-wide knob a pipeline consults (scan strategy and
batching in ``ops/_strategy``, the capacity-feedback switch and the
ANALYZE mode in ``runtime/pipeline``) has a contextvar twin: the
context value resolves FIRST, the process override second, the env
var last.
A ``Session`` owns a ``contextvars.Context`` with its knobs applied,
and the server runs every slice of that tenant's work inside it — so
two tenants interleaved on the single dispatch thread each see their
own strategy, their own feedback switch, and their own slice of the
shared plan cache's hit/miss accounting, while the process-wide
setters stay the single-caller surface they always were.

The session does NOT own a device or a cache: plan/program caches
stay shared cross-tenant (a CUDA graph captured for tenant A's chain
shape is a pure dictionary hit for tenant B's identical chain — the
whole point of sharing), and the per-session accounting sink installed
via ``pipeline.set_context_cache_accounting`` is how each tenant's
share of that shared cache becomes visible on ``/sessions``.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import Optional

from ..ops import _strategy
from ..runtime import events as _events
from ..runtime import metrics as _metrics
from ..runtime import pipeline as _pipeline
from ..runtime import resource as _resource

_session_ids = itertools.count(1)


class Session:
    """One tenant's handle on the serving driver.

    Construction applies the knobs inside a fresh
    ``contextvars.Context`` (copied from the creator's); the server
    runs every dispatch/retire slice of this tenant's jobs via
    ``run_in_context``. Mutable counters are written from the
    dispatch thread and read by any thread hitting ``/sessions``;
    all live behind ``_lock`` except ``_cache_acct``, whose bumps are
    GIL-atomic single-writer increments (see its declaration).
    """

    def __init__(
        self,
        name: Optional[str] = None,
        *,
        budget: Optional[int] = None,
        max_retries: int = _resource.DEFAULT_MAX_RETRIES,
        scan_strategy: Optional[str] = None,
        scan_batching: Optional[bool] = None,
        capacity_feedback: Optional[bool] = None,
        analyze: Optional[bool] = None,
    ):
        self.session_id = next(_session_ids)
        self.name = name or f"session{self.session_id}"
        self.budget = budget
        self.max_retries = int(max_retries)
        self.knobs = {
            "scan_strategy": scan_strategy,
            "scan_batching": scan_batching,
            "capacity_feedback": capacity_feedback,
            "analyze": analyze,
        }
        self._lock = threading.Lock()
        # sprtcheck: guarded-by=_lock
        self._stats = {
            "jobs": 0,          # submitted
            "done": 0,          # completed (results delivered)
            "failed": 0,        # raised mid-flight (post-admission)
            "rejected": 0,      # refused at admission
            "queued": 0,        # ever queued at admission
        }
        # publish_cache_counters' delta ledger: what has already been
        # synced to the serving.session.<name>.* counters
        # sprtcheck: guarded-by=_lock
        self._published = {"hits": 0, "misses": 0}
        # the shared plan cache's per-tenant view: _get_executable
        # bumps this dict (installed via set_context_cache_accounting)
        # from the dispatch thread WITHOUT this lock — single writer,
        # GIL-atomic int bumps — so deliberately NOT guarded-by=_lock;
        # scrape-thread reads may trail the writer by a bump, which is
        # fine for a monotone counter pair
        self._cache_acct = {"hits": 0, "misses": 0}
        # per-tenant ANALYZE stage sink: the analyzed sync
        # accumulates {"<stage>:<kind>": {rows, bytes, wall_ms,
        # chunks}} here (installed via set_context_stage_sink) — same
        # single-writer GIL-atomic discipline as _cache_acct, so
        # deliberately NOT guarded-by=_lock
        self._stage_sink: dict = {}
        self.closed = False
        self.opened_at = time.time()
        self._ctx = contextvars.copy_context()
        self._ctx.run(self._apply_knobs)
        _events.emit(
            "session_open",
            session=self.name,
            budget=budget,
            knobs={k: v for k, v in self.knobs.items() if v is not None},
        )

    def _apply_knobs(self) -> None:
        # runs INSIDE self._ctx: the contextvar writes live in the
        # session's Context object, never in the caller's
        _strategy.set_context_scan_strategy(self.knobs["scan_strategy"])
        _strategy.set_context_scan_batching(self.knobs["scan_batching"])
        _pipeline.set_context_capacity_feedback(
            self.knobs["capacity_feedback"]
        )
        _pipeline.set_context_cache_accounting(self._cache_acct)
        # ANALYZE is tenant-scoped like every other knob: tenant A
        # analyzing its chains must never slice tenant B's programs
        # (the knob folds into the plan key inside this context only)
        _pipeline.set_context_analyze(self.knobs["analyze"])
        _pipeline.set_context_stage_sink(self._stage_sink)

    def run_in_context(self, fn, *args):
        """Run ``fn`` inside this session's Context — the server's
        per-slice entry point. Single-threaded by construction (one
        dispatch thread); ``Context.run`` would raise on concurrent
        re-entry, which is the invariant, not a hazard."""
        return self._ctx.run(fn, *args)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    def publish_cache_counters(self) -> None:
        """Sync this tenant's plan-cache hit/miss deltas to the
        ``serving.session.<name>.*`` counters (the per-tenant rows the
        acceptance criteria put on ``/metrics``)."""
        with self._lock:
            dh = self._cache_acct.get("hits", 0) - self._published["hits"]
            dm = (
                self._cache_acct.get("misses", 0)
                - self._published["misses"]
            )
            self._published["hits"] += dh
            self._published["misses"] += dm
        if dh:
            _metrics.counter(
                f"serving.session.{self.name}.plan_cache_hit"
            ).inc(dh)
        if dm:
            _metrics.counter(
                f"serving.session.{self.name}.plan_cache_miss"
            ).inc(dm)

    def row(self) -> dict:
        """One ``/sessions`` row (JSON-safe copy). The latency columns
        read this tenant's live histograms: ``latency_ms``
        carries the e2e p50/p95/p99 quantile estimates, ``queue_wait``
        the admission-queue wait; both None until the session has
        completed (resp. activated) at least one job."""
        with self._lock:
            stats = dict(self._stats)
        # unlocked by design: _cache_acct is the dispatch thread's —
        # see its declaration
        cache = {
            "hits": self._cache_acct.get("hits", 0),
            "misses": self._cache_acct.get("misses", 0),
        }
        e2e = _metrics.histogram_stats(
            f"serving.session.{self.name}.e2e_ms"
        )
        qw = _metrics.histogram_stats(
            f"serving.session.{self.name}.queue_wait_ms"
        )
        return {
            "session": self.name,
            "session_id": self.session_id,
            "closed": self.closed,
            "budget": self.budget,
            "knobs": {
                k: v for k, v in self.knobs.items() if v is not None
            },
            "uptime_s": round(time.time() - self.opened_at, 3),
            "plan_cache": cache,
            "latency_ms": None if e2e is None else {
                "p50": e2e["p50"], "p95": e2e["p95"], "p99": e2e["p99"],
            },
            # unlocked shallow copy, same contract as plan_cache: the
            # per-tenant ANALYZE stage table (empty unless this
            # session ran with analyze on)
            "stages": {k: dict(v) for k, v in self._stage_sink.items()},
            "queue_wait": None if qw is None else {
                "p50": qw["p50"], "max": qw["max_ms"],
            },
            **stats,
        }

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.publish_cache_counters()
        with self._lock:
            stats = dict(self._stats)
        cache = dict(self._cache_acct)
        _events.emit(
            "session_close",
            session=self.name,
            jobs=stats["jobs"],
            rejected=stats["rejected"],
            plan_cache=cache,
        )
