"""Always-on span-stack sampling profiler: "where is this process
spending its wall time, right now" (the port's copy of the JAX
package's ``runtime/sampler.py``: pure Python, same knob, same folded
format, same read-outs).

The journal records *what happened* only after a dump. This module is
the live leg: a daemon thread, armed by ``SPARK_JNI_TPU_SAMPLER=<hz>``
(default rate ``DEFAULT_HZ`` = 19, a prime, so the sampler cannot
phase-lock with millisecond-periodic work), wakes at the configured
rate and samples

- the **live-span registry** (``spans.live_stacks()``): every
  thread's open task->op->run_plan/retry_round chain, plus detached
  streaming-chunk and serving-job spans, and
- the **host Python frames under each leaf span** via
  ``sys._current_frames()``: the innermost ``MAX_FRAMES`` frames,
  named ``file:function``, so a stack says not just "inside
  op Pipeline.q1" but *where inside it* (a graph replay, the
  driver-side collect, a lock).

Each observation folds into a bounded table of collapsed stacks
(``task:...;op:...;run_plan:...;py:file:fn;...`` keyed strings with
sample counts, the flamegraph "folded" format), with wall time
attributed as ``count / hz`` seconds. A serving job's span folds as
``session:<name>``, so one tenant's share of the dispatch thread is
one flamegraph subtree. Accounting: the ``sampler.samples`` counter is
every recorded thread-stack observation; ``sampler.dropped`` counts
the ticks the sampler could not take on schedule (the loop overran its
period) plus observations discarded because the folded table hit
``MAX_STACKS``: loss is observable, never silent.

Reading it out:

- ``collapsed()``: cumulative folded-stack text (one ``stack count``
  per line, flamegraph.pl / speedscope compatible),
- ``perfetto()``: the same tree rendered as Chrome-trace JSON by
  reusing ``runtime/traceview.to_chrome_trace``: each trie node
  becomes a synthetic ``span_end`` journal record whose wall is its
  sample weight, children laid out flame-graph style,
- ``capture(seconds, fmt=...)``: the on-demand window behind the
  diag ``/profile?seconds=N`` endpoint: diffs the folded table across
  the window (starting a temporary sampler at ``DEFAULT_HZ`` when
  disarmed) and returns just that window's stacks,
- ``flight_text()``: the ``sampler.txt`` flight-bundle section: the
  last capture's collapsed stacks, falling back to the cumulative
  table, empty when the sampler never ran (a disarmed process).

Cost: one ``live_stacks()`` + ``sys._current_frames()`` walk per tick,
against a 52 ms period at the default 19 Hz.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

_ENV_VAR = "SPARK_JNI_TPU_SAMPLER"
_LOG = logging.getLogger("spark_rapids_jni_tpu_torch.sampler")

DEFAULT_HZ = 19.0  # prime: cannot phase-lock with ms-periodic work
MAX_FRAMES = 8  # innermost host frames folded under the leaf span
MAX_STACKS = 4096  # folded-table bound; past it samples count as dropped

_lock = threading.Lock()
# sprtcheck: guarded-by=_lock
_folded: Dict[str, int] = {}  # collapsed stack -> sample count
_samples = 0  # thread-stack observations recorded
_dropped = 0  # overrun ticks + table-overflow observations
_hz: float = DEFAULT_HZ
_thread: Optional[threading.Thread] = None
_stop = threading.Event()
_last_capture: Optional[str] = None  # collapsed text of the last window
# lifecycle arbitration: start/stop/capture are check-then-act on the
# daemon thread, and the diag /profile endpoint is multi-threaded —
# without one lock two concurrent captures on a disarmed process could
# spawn two loops (double-counted walls) or stop the daemon under the
# other's window
_lifecycle = threading.Lock()
_capture_users = 0  # captures in flight on a capture-started daemon
_capture_started = False  # daemon owned by capture, not by start()


def armed_hz() -> Optional[float]:
    """The env-configured sample rate, or None when disarmed. A bare
    truthy spelling ("1", "on", "true") arms at DEFAULT_HZ; "0"/"off"
    and friends disarm; an unparseable value disarms with a warning
    (a typo must not start a surprise profiler)."""
    raw = os.environ.get(_ENV_VAR, "").strip()
    if not raw:
        return None
    low = raw.lower()
    if low in ("off", "0", "false", "none", "no", "disabled"):
        return None
    if low in ("on", "true", "default"):
        return DEFAULT_HZ
    try:
        hz = float(raw)
    except ValueError:
        _LOG.warning(
            "unparseable %s value %r (expected a rate in Hz); sampler "
            "stays disarmed", _ENV_VAR, raw,
        )
        return None
    return hz if hz > 0 else None


def running() -> bool:
    t = _thread
    return t is not None and t.is_alive()


def hz() -> float:
    """The rate the running (or last-started) sampler uses."""
    return _hz


def maybe_start() -> bool:
    """Arm from the environment (package import calls this): start the
    daemon thread iff SPARK_JNI_TPU_SAMPLER sets a rate. Idempotent."""
    rate = armed_hz()
    if rate is None:
        return False
    start(rate)
    return True


def start(rate: Optional[float] = None) -> None:
    """Start the sampling daemon at ``rate`` Hz (default: the env rate
    or DEFAULT_HZ). Idempotent while running at the same rate; a
    different rate restarts the thread."""
    global _capture_started
    with _lifecycle:
        _capture_started = False  # explicitly started: user-owned now
        _start_locked(rate)


def _start_locked(rate: Optional[float]) -> None:
    global _thread, _hz
    rate = float(rate if rate is not None else (armed_hz() or DEFAULT_HZ))
    if running() and _hz == rate:
        return
    _stop_locked()
    _hz = rate
    _stop.clear()
    t = threading.Thread(
        target=_loop, name="sprt-sampler", daemon=True
    )
    _thread = t
    t.start()


def stop() -> None:
    """Stop the sampling daemon (accumulated stacks are kept)."""
    with _lifecycle:
        _stop_locked()


def _stop_locked() -> None:
    global _thread
    t = _thread
    if t is None:
        return
    _stop.set()
    if t is not threading.current_thread():
        t.join(timeout=2.0)
    _thread = None


def reset() -> None:
    """Drop accumulated stacks and counts (tests)."""
    global _samples, _dropped, _last_capture
    with _lock:
        _folded.clear()
        _samples = 0
        _dropped = 0
        _last_capture = None


def stats() -> dict:
    """{"running", "hz", "samples", "dropped", "stacks"} — the
    /healthz sampler block."""
    with _lock:
        return {
            "running": running(),
            "hz": _hz if running() else None,
            "samples": _samples,
            "dropped": _dropped,
            "stacks": len(_folded),
        }


# --------------------------------------------------------------------
# the sampling loop


def _frame_label(frame) -> str:
    code = frame.f_code
    return f"py:{os.path.basename(code.co_filename)}:{code.co_name}"


def _fold_thread(stack, frame) -> str:
    # serving slices fold with the TENANT dimension: the
    # job span underlying a slice's stack (server._adopt_job) folds as
    # session:<name>, so one tenant's share of the dispatch thread is
    # one flamegraph subtree. Non-serving stacks are unchanged.
    parts = [
        f"session:{getattr(s, 'session', s.name)}"
        if s.kind == "job" else f"{s.kind}:{s.name}"
        for s in stack
    ]
    if frame is not None:
        labels: List[str] = []
        f = frame
        while f is not None and len(labels) < MAX_FRAMES:
            labels.append(_frame_label(f))
            f = f.f_back
        parts.extend(reversed(labels))  # outermost -> innermost
    return ";".join(parts)


def sample_once() -> int:
    """Take one sample of every thread with an open span stack;
    returns how many thread-stacks were recorded. Public so tests and
    the capture path can sample deterministically."""
    global _samples, _dropped
    from . import metrics as _metrics
    from . import spans as _spans

    stacks = _spans.live_stacks()
    # detached streaming chunks are in flight on NO thread: fold them
    # with no host frames (their wall is device/retirement wait)
    detached = _spans.detached_spans()
    n = 0
    # the frames map holds this very frame too: left to die with it, the
    # two would keep every sampled thread's frames, and the tensors in
    # their locals, alive until the garbage collector broke the cycle
    frames = sys._current_frames()
    try:
        keys = [_fold_thread(stack, frames.get(ident)) for ident, (_name, stack) in stacks.items()]
    finally:
        del frames
    with _lock:
        for key in keys:
            if key in _folded or len(_folded) < MAX_STACKS:
                _folded[key] = _folded.get(key, 0) + 1
                _samples += 1
                n += 1
            else:
                _dropped += 1
        for s in detached:
            if s.kind == "job":
                # a parked serving job (queued, or between slices):
                # same tenant dimension as its on-stack folds
                key = f"session:{getattr(s, 'session', s.name)};" \
                      f"job:{s.name} (detached)"
            else:
                key = f"{s.kind}:{s.name} (detached)"
            if key in _folded or len(_folded) < MAX_STACKS:
                _folded[key] = _folded.get(key, 0) + 1
                _samples += 1
                n += 1
            else:
                _dropped += 1
    if n:
        _metrics.counter("sampler.samples").inc(n)
    return n


def _loop() -> None:
    global _dropped
    from . import metrics as _metrics

    period = 1.0 / _hz
    next_t = time.monotonic() + period
    while not _stop.is_set():
        wait = next_t - time.monotonic()
        if wait > 0:
            if _stop.wait(wait):
                return
        try:
            sample_once()
        except Exception:  # noqa: BLE001 — profiling must never kill work
            _LOG.warning("sampler tick failed", exc_info=True)
        next_t += period
        now = time.monotonic()
        if now > next_t:  # overran: count the ticks we cannot take
            missed = int((now - next_t) / period) + 1
            with _lock:
                _dropped += missed
            _metrics.counter("sampler.dropped").inc(missed)
            next_t = now + period


# --------------------------------------------------------------------
# read-out: collapsed text, Perfetto JSON, windowed capture


def _snapshot_folded() -> Dict[str, int]:
    with _lock:
        return dict(_folded)


def _collapse(folded: Dict[str, int]) -> str:
    """Folded-stack text: ``stack count`` per line, heaviest first —
    flamegraph.pl / speedscope "collapsed" input."""
    lines = [
        f"{stack} {count}"
        for stack, count in sorted(
            folded.items(), key=lambda kv: (-kv[1], kv[0])
        )
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def collapsed() -> str:
    """Cumulative collapsed stacks since arm/reset."""
    return _collapse(_snapshot_folded())


def _perfetto_events(folded: Dict[str, int], rate: float) -> List[dict]:
    """Render a folded table as synthetic schema-shaped ``span_end``
    journal records laid out flame-graph style (each node's wall =
    its sample weight / rate, children packed left-to-right inside
    their parent) — the input ``traceview.to_chrome_trace`` already
    knows how to emit, so the sampler needs no emitter of its own."""
    # trie: node key = tuple of labels root->here
    weights: Dict[Tuple[str, ...], int] = {}
    for stack, count in folded.items():
        labels = tuple(stack.split(";"))
        for i in range(1, len(labels) + 1):
            key = labels[:i]
            weights[key] = weights.get(key, 0) + count
    period = 1.0 / rate
    ids: Dict[Tuple[str, ...], int] = {}
    starts: Dict[Tuple[str, ...], float] = {}
    cursor: Dict[Tuple[str, ...], float] = {}  # next child offset
    events: List[dict] = []
    for key in sorted(weights):  # parents sort before their children
        ids[key] = len(ids) + 1
        parent = key[:-1]
        if parent:
            start = cursor.get(parent, starts[parent])
        else:
            start = cursor.get((), 0.0)
        dur_s = weights[key] * period
        starts[key] = start
        cursor[parent if parent else ()] = start + dur_s
        kind = key[-1].split(":", 1)[0]
        events.append({
            "v": 2,
            "kind": "event",
            "event": "span_end",
            "op": key[-1],
            "ts": start + dur_s,  # close events carry the END stamp
            "span_id": ids[key],
            "parent_id": ids[parent] if parent else None,
            "task_id": None,
            "attrs": {
                "kind": kind if kind in ("task", "op") else "sample",
                "wall_ms": round(dur_s * 1000, 3),
                "samples": weights[key],
            },
        })
    return events


def perfetto(folded: Optional[Dict[str, int]] = None) -> dict:
    """The folded table as Chrome-trace/Perfetto JSON (synthetic time
    axis: slice width = attributed wall, not when the samples
    happened). Loadable at ui.perfetto.dev like a traceview trace."""
    from . import traceview as _traceview

    if folded is None:
        folded = _snapshot_folded()
    return _traceview.to_chrome_trace(_perfetto_events(folded, _hz))


def capture(seconds: float, fmt: str = "collapsed"):
    """Sample for ``seconds`` and return ONLY that window's stacks —
    the in-process form of ``/profile?seconds=N``. Runs against the
    armed daemon when one is live; otherwise starts a temporary
    sampler (env rate or DEFAULT_HZ) for the window. ``fmt``:
    ``collapsed`` (str) or ``perfetto`` (dict)."""
    global _last_capture, _capture_users, _capture_started
    if fmt not in ("collapsed", "perfetto"):
        raise ValueError(f"unknown profile fmt {fmt!r}")
    seconds = min(max(float(seconds), 0.05), 300.0)
    with _lifecycle:
        # overlapping captures share one capture-owned daemon; the
        # LAST one out stops it (never a daemon the user start()ed)
        _capture_users += 1
        if not running():
            _capture_started = True
            _start_locked(None)
    try:
        before = _snapshot_folded()
        time.sleep(seconds)
        sample_once()  # the window always ends on a fresh observation
        after = _snapshot_folded()
    finally:
        with _lifecycle:
            _capture_users -= 1
            if _capture_users == 0 and _capture_started:
                _capture_started = False
                _stop_locked()
    window = {
        k: v - before.get(k, 0)
        for k, v in after.items()
        if v != before.get(k, 0)
    }
    _last_capture = _collapse(window)
    if fmt == "perfetto":
        return perfetto(window)
    return _last_capture


def flight_text() -> str:
    """The ``sampler.txt`` flight-bundle section: the last capture's
    collapsed stacks, else the cumulative table, else empty (sampler
    never armed — a bundle from a disarmed process says so by being
    empty)."""
    if _last_capture:
        return _last_capture
    if _samples:
        return collapsed()
    return ""
