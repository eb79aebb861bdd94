"""In-process diagnostics endpoint: pull-based live introspection (the
port's copy of the JAX package's ``runtime/diag.py``: stdlib Python,
same knob, same endpoints, same Prometheus exposition).

The upstream spark-rapids plugin exposes Spark's live UI: TaskMetrics
and SQL metrics you can look at while a query runs. The journal and
the flight recorder are post-hoc: you learn what a process was doing
after it dumped a journal or crashed into a bundle. This module is the
live window: an opt-in, **loopback-only** stdlib ``http.server``
thread,

    SPARK_JNI_TPU_DIAG=<port>        # 0 = ephemeral; unset = off

serving (all GET, all read-only except the bounded /profile capture):

    /healthz             pid, uptime, sink mode + write errors,
                         journal buffered/dropped/rotations, sampler
                         state, flight arming + bundle count
    /metrics             the WHOLE registry as Prometheus text
                         exposition v0.0.4 — scrapeable by a stock
                         Prometheus; names map 1:1 from the
                         docs/OBSERVABILITY.md vocabulary (see
                         ``prom_name``)
    /spans               the live span forest (``spans.live_tree()``):
                         every thread's in-flight task→op→run_plan
                         chain + detached streaming chunks, JSON
    /plans               the planner caches, JSON dict with four keys:
                         ``explain`` (the fused plans' rendered
                         EXPLAIN text — ``pipeline.render_plan_rows``,
                         the same view the flight bundle's explain.txt
                         and the explain CLI show),
                         ``plans`` (``pipeline.plan_cache_table()`` —
                         which fused plans are live and how hot; each
                         row carries the plan's capacity-feedback
                         state when the planner has observations
                         for it), ``exec_feedback``
                         (``resource.exec_feedback_table()`` — the
                         executor retry driver's converged sizes), and
                         ``exec_programs``
                         (``resource.program_cache_table()`` — the
                         warm executor program cache: per-entry
                         op/mesh/plan point, hit count, build
                         wall)
    /flight              flight-recorder bundle list (newest first);
                         /flight/<bundle> a bundle's MANIFEST;
                         /flight/<bundle>/<file> one bundle file raw
    /profile?seconds=N   on-demand sampler capture (&fmt=collapsed |
                         perfetto), default 1 s, capped at 60
    /slo                 the serving SLO view: every histogram's
                         count/p50/p95/p99/max, the
                         ``serving.slo_violations`` counter, the
                         slow-job flight trigger's arming, and the
                         most recent ``slo_violation`` journal events

Security model: the server binds ``127.0.0.1`` only (a serving host
exposes it via its own authenticated proxy or not at all), the flight
fetch path is allowlisted to ``flight_*`` bundle names and their
files (no traversal), and /profile's window is capped. Every request
bumps the ``diag.requests`` counter. Handler failures return 500 and
never propagate — introspection must not kill the process it
inspects.

Prometheus naming (the 1:1 vocabulary mapping): registry names are
``[A-Za-z0-9._]``; ``prom_name`` maps ``.`` → ``_`` and ``_`` →
``__`` (injective, so a scraped series maps back to exactly one
vocabulary name — ``prom_to_vocab`` inverts it), prefixes everything
with ``sprt_``, and appends the conventional suffixes: counters
``_total``, timers a ``_ms`` summary (``_ms_count``/``_ms_sum``) plus
``_ms_min``/``_ms_max`` gauges, gauges bare, histograms a real
Prometheus **histogram** — cumulative ``_bucket{le="..."}`` series
(ending ``le="+Inf"``) plus ``_sum``/``_count`` (histogram vocabulary
names already carry their ``_ms`` unit, so no extra suffix is added).
The sprtcheck ``telemetry-vocab`` rule keeps the underlying vocabulary
pinned both directions, so the exposition can never name a series the
docs don't.
"""

from __future__ import annotations

import contextlib
import http.server
import json
import logging
import os
import re
import socketserver
import threading
import time
import urllib.parse
from typing import Dict, List, Optional

_ENV_VAR = "SPARK_JNI_TPU_DIAG"
_LOG = logging.getLogger("spark_rapids_jni_tpu_torch.diag")

MAX_PROFILE_SECONDS = 60.0

_server: Optional["_DiagServer"] = None
_thread: Optional[threading.Thread] = None
_t0 = time.time()  # process arming time (uptime basis)


# --------------------------------------------------------------------
# Prometheus text exposition v0.0.4


def prom_name(name: str) -> str:
    """Injective vocabulary-name -> Prometheus-name mapping: ``.`` →
    ``_``, ``_`` → ``__``, anything else unexpected → ``_``; prefixed
    ``sprt_``. Injective because the two replacements cannot collide:
    a single ``_`` in the output always came from ``.``, a double
    always from ``_``."""
    out = []
    for ch in name:
        if ch.isalnum():
            out.append(ch)
        elif ch == ".":
            out.append("_")
        elif ch == "_":
            out.append("__")
        else:  # not in the vocabulary today; keep the series legal
            out.append("_")
    return "sprt_" + "".join(out)


def prom_to_vocab(series: str) -> str:
    """Invert ``prom_name`` (suffixes like ``_total`` already
    stripped): ``__`` → ``_``, remaining ``_`` → ``.``."""
    body = series[len("sprt_"):] if series.startswith("sprt_") else series
    return body.replace("__", "\x00").replace("_", ".").replace("\x00", "_")


def prom_text(snap: Optional[dict] = None) -> str:
    """The whole registry as Prometheus text exposition v0.0.4."""
    from . import metrics as _metrics

    if snap is None:
        snap = _metrics.snapshot()
    lines: List[str] = []

    def fmt(v: float) -> str:
        return repr(int(v)) if float(v).is_integer() else repr(float(v))

    for name, v in sorted(snap.get("counters", {}).items()):
        s = prom_name(name) + "_total"
        lines.append(f"# TYPE {s} counter")
        lines.append(f"{s} {fmt(v)}")
    for name, v in sorted(snap.get("gauges", {}).items()):
        s = prom_name(name)
        lines.append(f"# TYPE {s} gauge")
        lines.append(f"{s} {fmt(v)}")
    for name, t in sorted(snap.get("timers", {}).items()):
        s = prom_name(name) + "_ms"
        lines.append(f"# TYPE {s} summary")
        lines.append(f"{s}_sum {fmt(t['sum_ms'])}")
        lines.append(f"{s}_count {fmt(t['count'])}")
        for fld in ("min", "max"):
            g = f"{s}_{fld}"
            lines.append(f"# TYPE {g} gauge")
            lines.append(f"{g} {fmt(t[f'{fld}_ms'])}")
    for name, h in sorted(snap.get("histograms", {}).items()):
        # a REAL Prometheus histogram: cumulative le-labeled buckets
        # ending at +Inf, then _sum/_count. The vocabulary name already
        # ends in _ms (the unit), so no suffix is appended — prom_name
        # alone maps it back through prom_to_vocab
        s = prom_name(name)
        lines.append(f"# TYPE {s} histogram")
        for le, cum in h.get("buckets", {}).items():
            lines.append(f'{s}_bucket{{le="{le}"}} {fmt(cum)}')
        lines.append(f"{s}_sum {fmt(h['sum_ms'])}")
        lines.append(f"{s}_count {fmt(h['count'])}")
    return "\n".join(lines) + "\n"


_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? ([0-9.eE+-]+|NaN)$"
)


def parse_prom_text(text: str) -> Dict[str, float]:
    """Minimal v0.0.4 parser: ``{series: value}``, what the tests and
    a curl check re-parse a scrape with. Unlabeled samples
    key by their bare series name (unchanged); a labeled sample — the
    histogram ``_bucket{le="..."}`` series — keys by the full
    ``name{labels}`` text verbatim, so distinct buckets of one
    histogram never collide and bare-name lookups keep working. Raises
    ValueError on a line that is neither a comment nor a valid
    sample."""
    out: Dict[str, float] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            raise ValueError(f"line {i}: not a Prometheus sample: {line!r}")
        key = m.group(1) + (m.group(2) or "")
        out[key] = float(m.group(3))
    return out


# --------------------------------------------------------------------
# the HTTP server


class _DiagServer(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True


_BUNDLE_RE = re.compile(r"^flight_[A-Za-z0-9_]+$")
_FILE_RE = re.compile(r"^[A-Za-z0-9_.]+$")


def _flight_index() -> List[dict]:
    from . import flight as _flight

    return _flight.bundle_index()


# /sessions provider: the serving driver (spark_rapids_jni_tpu_torch/
# serving) registers its live sessions_table here at start and clears
# it at close — diag stays import-acyclic (serving imports runtime,
# never the reverse)
_sessions_provider = None


def set_sessions_provider(fn) -> None:
    """Register (or clear, with None) the callable behind
    ``/sessions``. It must return a JSON-serializable list of
    per-session rows; exceptions surface as the endpoint's 500."""
    global _sessions_provider
    _sessions_provider = fn


def _flight_count() -> int:
    """Bundle COUNT only — /healthz is the cheap liveness probe and
    must not parse MAX_BUNDLES manifests per scrape like the full
    ``/flight`` index does."""
    from . import flight as _flight

    root = _flight.flight_dir()
    if root is None or not os.path.isdir(root):
        return 0
    try:
        return sum(
            1 for n in os.listdir(root) if n.startswith("flight_")
        )
    except OSError:
        return 0


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "sprt-diag/1"

    def log_message(self, fmt, *args):  # stderr chatter -> debug log
        _LOG.debug("%s " + fmt, self.address_string(), *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        self._send(
            code,
            json.dumps(obj, indent=2, default=str).encode() + b"\n",
            "application/json",
        )

    def _text(self, body: str, code: int = 200, ctype="text/plain") -> None:
        self._send(code, body.encode(), f"{ctype}; charset=utf-8")

    def do_GET(self):  # noqa: N802 — http.server API
        from . import metrics as _metrics

        _metrics.counter("diag.requests").inc()
        url = urllib.parse.urlsplit(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            self._route(parts, urllib.parse.parse_qs(url.query))
        except BrokenPipeError:  # client went away mid-write
            pass
        except Exception as e:  # noqa: BLE001 — introspection never kills
            _LOG.warning("diag handler failed for %s", self.path,
                         exc_info=True)
            with contextlib.suppress(OSError):
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)

    def _route(self, parts: List[str], q: Dict[str, list]) -> None:
        from . import events as _events
        from . import flight as _flight
        from . import metrics as _metrics
        from . import sampler as _sampler
        from . import spans as _spans

        if parts == ["healthz"]:
            self._json({
                "ok": True,
                "pid": os.getpid(),
                "uptime_s": round(time.time() - _t0, 3),
                "sink": {
                    "mode": _metrics.mode(),
                    "write_errors": _metrics.sink_write_errors(),
                    "rotations": _metrics.sink_rotations(),
                },
                "journal": {
                    "buffered": len(_events.events()),
                    "dropped": _events.dropped(),
                    "capacity": _events.capacity(),
                },
                "sampler": _sampler.stats(),
                "flight": {
                    "dir": _flight.flight_dir(),
                    "bundles": _flight_count(),
                },
                # tail-latency health at a glance: how many
                # latency distributions are live and whether any job
                # has blown its SLO, without a Prometheus scrape
                "histograms": dict(zip(
                    ("instruments", "observations"),
                    _metrics.histogram_totals(),
                )),
                "slo_violations": _metrics.counter_value(
                    "serving.slo_violations"
                ),
            })
        elif parts == ["metrics"]:
            self._text(prom_text(), ctype="text/plain; version=0.0.4")
        elif parts == ["spans"]:
            self._json(_spans.live_tree())
        elif parts == ["plans"]:
            from . import pipeline as _pipeline
            from . import resource as _resource

            # the three planner caches side by side: fused-chain plans
            # (with their feedback rows), the executor feedback memo,
            # and the warm executor program cache, plus the rendered
            # EXPLAIN of the fused plans: the same text the flight
            # bundle's explain.txt and the
            # ``python -m spark_rapids_jni_tpu_torch.explain`` CLI show
            rows = _pipeline.plan_cache_table()
            self._json({
                "plans": rows,
                "explain": _pipeline.render_plan_rows(rows),
                "exec_feedback": _resource.exec_feedback_table(),
                "exec_programs": _resource.program_cache_table(),
            })
        elif parts == ["sessions"]:
            fn = _sessions_provider
            self._json({
                "serving": fn is not None,
                "sessions": [] if fn is None else fn(),
            })
        elif parts == ["profile"]:
            seconds = min(
                float(q.get("seconds", ["1"])[0]), MAX_PROFILE_SECONDS
            )
            fmt = q.get("fmt", ["collapsed"])[0]
            out = _sampler.capture(seconds, fmt=fmt)
            if fmt == "perfetto":
                self._json(out)
            else:
                self._text(out)
        elif parts == ["slo"]:
            # the serving SLO view: live latency distributions with
            # their estimated tails, the violation counter, and the
            # most recent slo_violation journal events (each names the
            # flight bundle it recorded, when the recorder was armed)
            snap = _metrics.snapshot()
            self._json({
                "slo_flight_multiplier": _flight.slo_multiplier(),
                "slo_violations": _metrics.counter_value(
                    "serving.slo_violations"
                ),
                "histograms": {
                    name: _metrics.histogram_stats(name)
                    for name in sorted(snap.get("histograms", {}))
                },
                "recent_violations": [
                    ev for ev in _events.events()
                    if ev.get("event") == "slo_violation"
                ][-32:],
            })
        elif parts and parts[0] == "flight":
            self._route_flight(parts[1:])
        else:
            self._json({"error": f"no such endpoint: /{'/'.join(parts)}",
                        "endpoints": ["/healthz", "/metrics", "/spans",
                                      "/plans", "/sessions", "/slo",
                                      "/flight", "/profile"]},
                       code=404)

    def _route_flight(self, rest: List[str]) -> None:
        from . import flight as _flight

        if not rest:
            self._json(_flight_index())
            return
        # allowlist, not sanitization: a fetch path is exactly a
        # bundle name (optionally + one file inside it)
        root = _flight.flight_dir()
        if root is None:
            self._json({"error": "flight recorder not armed "
                        "(SPARK_JNI_TPU_FLIGHT unset)"}, code=404)
            return
        if not _BUNDLE_RE.match(rest[0]) or len(rest) > 2 or (
            len(rest) == 2 and not _FILE_RE.match(rest[1])
        ):
            self._json({"error": "bad flight path"}, code=400)
            return
        bundle = os.path.join(root, rest[0])
        if not os.path.isdir(bundle):
            self._json({"error": f"no such bundle: {rest[0]}"}, code=404)
            return
        if len(rest) == 1:
            with open(os.path.join(bundle, "MANIFEST.json")) as f:
                self._json(json.load(f))
            return
        path = os.path.join(bundle, rest[1])
        if not os.path.isfile(path):
            self._json({"error": f"no such file: {rest[1]}"}, code=404)
            return
        with open(path, "rb") as f:
            body = f.read()
        self._send(200, body, "application/octet-stream")


# --------------------------------------------------------------------
# lifecycle


def port() -> Optional[int]:
    """The bound port of the running server, or None."""
    s = _server
    return s.server_address[1] if s is not None else None


def running() -> bool:
    return _server is not None


def armed_port() -> Optional[int]:
    """The env-configured port, or None when disarmed (unset / blank /
    a non-integer, which warns — a typo must not open a port)."""
    raw = os.environ.get(_ENV_VAR, "").strip()
    if not raw or raw.lower() in ("off", "false", "none", "no"):
        return None
    try:
        return int(raw)
    except ValueError:
        _LOG.warning(
            "unparseable %s value %r (expected a port); diag endpoint "
            "stays off", _ENV_VAR, raw,
        )
        return None


def maybe_start() -> Optional[int]:
    """Arm from the environment (package import calls this): serve
    iff SPARK_JNI_TPU_DIAG names a port. Returns the bound port. A
    bind failure (EADDRINUSE — two processes sharing one exported
    port, the multi-executor layout) degrades to a warning: an opt-in
    diagnostics feature must never make the package unimportable."""
    p = armed_port()
    if p is None:
        return None
    try:
        return start(p)
    except OSError as e:
        _LOG.warning(
            "diagnostics endpoint could not bind 127.0.0.1:%d (%s); "
            "staying off", p, e,
        )
        return None


def start(port_: int = 0) -> int:
    """Start the loopback diagnostics server (idempotent; returns the
    bound port — pass 0 for an ephemeral one, the test form)."""
    global _server, _thread
    if _server is not None:
        return _server.server_address[1]
    srv = _DiagServer(("127.0.0.1", int(port_)), _Handler)
    t = threading.Thread(
        target=srv.serve_forever, name="sprt-diag", daemon=True,
        kwargs={"poll_interval": 0.2},
    )
    _server = srv
    _thread = t
    t.start()
    bound = srv.server_address[1]
    _LOG.info("diagnostics endpoint on 127.0.0.1:%d", bound)
    return bound


def stop() -> None:
    global _server, _thread
    srv, t = _server, _thread
    _server = _thread = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None:
        t.join(timeout=2.0)
