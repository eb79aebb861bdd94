"""Journal -> Chrome-trace converter: render the causal span tree as a
timeline with NO profiler session (the port's copy of the JAX
package's ``runtime/traceview.py``: pure Python, same mapping, same
output for the same journal).

``trace.timeline`` (``torch.profiler``) shows device truth but needs a
live profiling session and knows nothing about tasks, retries, or
injected faults. The event journal carries a full causal span tree
(``runtime/spans.py``), and every span's close event carries
``wall_ms``: enough to reconstruct named slices with durations from
the journal alone. This module converts a journal (the in-memory ring,
a streaming file sink, or a ``dump_jsonl`` file) into
Chrome-trace/Perfetto JSON, loadable at ``ui.perfetto.dev`` or
``chrome://tracing``::

    python -m spark_rapids_jni_tpu_torch.traceview /tmp/metrics.jsonl
    python -m spark_rapids_jni_tpu_torch.traceview /tmp/metrics.jsonl \\
        -o trace.json --check --min-spans 10

Mapping:

- span closes (``span_end``, ``op_end``, ``task_done``: each carries
  ``wall_ms`` and is stamped with its OWN span id) become complete
  ``"X"`` slices: start = event ts - wall_ms, nested by parent links,
  one track (tid) per task id. Retry rounds therefore appear as child
  slices of their ``run_plan`` span, plan builds under their pipeline
  op, collects at the query tail.
- serving jobs (``span_end`` with ``kind: job``) get per-SESSION
  tracks: the job slice, backdated to submit, encloses every
  interleaved op slice of its task, with the admission-queue wait
  visible as the gap before the first one.
- point happenings (``injected_fault``, ``capacity_overflow``,
  ``retry_replan``, ``retry_oom``, ``plan_cache_*``,
  ``device_metrics``) become ``"i"`` instant events at their
  timestamp.
- spans that never closed (the ambient root; a crash mid-span) are
  SYNTHESIZED: any span id referenced as a parent but missing a close
  event gets a slice spanning its children, marked
  ``args.synthesized``, so parent links always resolve in the
  rendered trace.

``check_trace`` is the machine gate: the JSON parses, holds at least N
real (non-synthesized) complete spans, every event is span-stamped,
and every parent id resolves.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

# journal events that close a span (each carries attrs.wall_ms and is
# stamped with the span it closes — see runtime/spans.py emission
# discipline)
SPAN_CLOSE_EVENTS = {"span_end", "op_end", "task_done"}  # sprtcheck: guarded-by=frozen
# begin markers: the information is already in the close slice
_SKIP_EVENTS = {"op_begin"}  # sprtcheck: guarded-by=frozen

_KIND_BY_EVENT = {"op_end": "op", "task_done": "task"}  # sprtcheck: guarded-by=frozen


def load_journal(path: str) -> List[dict]:
    """Event records of a JSONL journal file (sink stream or
    ``dump_jsonl`` output); counter/gauge/timer snapshot lines are
    skipped. Malformed lines are skipped too — a crash may truncate
    the final line of a streaming sink, and the readable prefix is
    exactly what a post-mortem needs. A size-capped sink rotates to
    ``<path>.1`` (runtime/metrics.py) — when that sibling exists its
    (older) events are read first, so the rendered timeline covers
    the whole rotated pair in order."""
    from . import metrics as _metrics

    paths = _metrics.rotated_paths(path)
    out = []
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and rec.get("kind") == "event":
                    out.append(rec)
    return out


def _slice_bounds(ev: dict) -> Tuple[float, float]:
    """(start_us, end_us) of a span-close event on the unix clock."""
    end_us = float(ev["ts"]) * 1e6
    dur_us = max(float(ev.get("attrs", {}).get("wall_ms", 0.0)), 0.0) * 1000
    return end_us - dur_us, end_us


def to_chrome_trace(events: List[dict]) -> dict:
    """Build the Chrome-trace dict from journal event records (any mix
    of v1/v2 — v1 events render without causal links)."""
    slices: List[dict] = []
    instants: List[dict] = []
    counters: List[dict] = []
    tids = {}  # tid -> thread label
    child_bounds: Dict[int, List[float]] = {}
    child_tid: Dict[int, int] = {}

    # serving jobs render as PER-SESSION tracks: a job
    # span's close event names its session and its task in attrs, so a
    # prepass maps every serving task id — and the job span ids
    # themselves, whose events carry no task id — onto a session
    # track. The job slice (backdated to submit) encloses its
    # interleaved op slices there, and the admission-queue wait shows
    # as the gap before the first one. Non-serving work keeps its
    # per-task track.
    session_of_task: Dict[int, str] = {}
    session_of_span: Dict[int, str] = {}
    for ev in events:
        attrs = ev.get("attrs", {}) or {}
        if ev.get("event") == "span_end" and attrs.get("kind") == "job":
            sess = attrs.get("session")
            if sess is None:
                continue
            if ev.get("span_id") is not None:
                session_of_span[ev["span_id"]] = str(sess)
            if attrs.get("task") is not None:
                session_of_task[int(attrs["task"])] = str(sess)
    session_tid = {
        s: 1_000_000 + i
        for i, s in enumerate(sorted(
            set(session_of_span.values()) | set(session_of_task.values())
        ))
    }
    for s, tid in session_tid.items():
        tids[tid] = f"session {s}"

    def tid_of(ev) -> int:
        sid, pid_ = ev.get("span_id"), ev.get("parent_id")
        if sid in session_of_span:
            return session_tid[session_of_span[sid]]
        if pid_ in session_of_span:
            # an event journaled directly under a job span (admission
            # decision/reject, slo_violation) belongs on its track
            return session_tid[session_of_span[pid_]]
        t = ev.get("task_id")
        if t is not None and int(t) in session_of_task:
            return session_tid[session_of_task[int(t)]]
        return int(t) if t is not None else 0

    for ev in events:
        name = ev.get("event")
        if name in _SKIP_EVENTS:
            continue
        attrs = ev.get("attrs", {}) or {}
        sid = ev.get("span_id")
        pid_ = ev.get("parent_id")
        tid = tid_of(ev)
        tids.setdefault(
            tid, f"task {tid}" if tid else "untasked (ambient)"
        )
        args = {"span_id": sid, "parent_id": pid_, **attrs}
        if name in SPAN_CLOSE_EVENTS and "wall_ms" in attrs:
            start_us, end_us = _slice_bounds(ev)
            cat = attrs.get("kind") or _KIND_BY_EVENT.get(name, "span")
            slices.append({
                "name": ev.get("op") or name,
                "cat": cat,
                "ph": "X",
                "ts": start_us,
                "dur": end_us - start_us,
                "pid": 1,
                "tid": tid,
                "args": args,
            })
            if pid_ is not None:
                child_bounds.setdefault(pid_, []).extend(
                    (start_us, end_us)
                )
                child_tid.setdefault(pid_, tid)
        else:
            ts_us = float(ev["ts"]) * 1e6
            instants.append({
                "name": f"{name}" + (f": {ev['op']}" if ev.get("op") else ""),
                "cat": name,
                "ph": "i",
                "s": "t",
                "ts": ts_us,
                "pid": 1,
                "tid": tid,
                "args": args,
            })
            if pid_ is not None:
                child_bounds.setdefault(pid_, []).extend((ts_us, ts_us))
                child_tid.setdefault(pid_, tid)
            if name == "stage_metrics" and attrs.get("device_rows"):
                # mesh skew map: an analyzed sharded
                # stage's per-device row/byte vectors render as
                # Chrome counter ("C") track sets — one multi-series
                # track per stage, one series per device, so an
                # unbalanced join/group_by reads as a skew heatmap
                label = ev.get("op") or "pipeline"
                stage_lbl = (
                    f"{label} s{attrs.get('stage')}:"
                    f"{attrs.get('stage_kind')}"
                )
                counters.append({
                    "name": f"{stage_lbl} device rows",
                    "ph": "C",
                    "ts": ts_us,
                    "pid": 1,
                    "tid": tid,
                    "args": {
                        f"dev{d}": int(v)
                        for d, v in enumerate(attrs["device_rows"])
                    },
                })
                if attrs.get("device_bytes"):
                    counters.append({
                        "name": f"{stage_lbl} device bytes",
                        "ph": "C",
                        "ts": ts_us,
                        "pid": 1,
                        "tid": tid,
                        "args": {
                            f"dev{d}": int(v)
                            for d, v in enumerate(attrs["device_bytes"])
                        },
                    })

    # synthesize never-closed spans referenced as parents (ambient
    # roots; spans cut off by a crash): span their children so every
    # parent link resolves to a rendered slice
    closed = {s["args"]["span_id"] for s in slices}
    for missing in sorted(set(child_bounds) - closed):
        bounds = child_bounds[missing]
        tid = child_tid.get(missing, 0)
        slices.append({
            "name": f"span {missing} (never closed)",
            "cat": "synthesized",
            "ph": "X",
            "ts": min(bounds),
            "dur": max(max(bounds) - min(bounds), 1.0),
            "pid": 1,
            "tid": tid,
            "args": {
                "span_id": missing,
                "parent_id": None,
                "synthesized": True,
            },
        })

    # normalize to a zero-based clock (Perfetto renders absolute unix
    # microseconds poorly)
    all_ev = slices + instants + counters
    base = min((e["ts"] for e in all_ev), default=0.0)
    for e in all_ev:
        e["ts"] = round(e["ts"] - base, 3)

    # the process label names the journal format, which both packages
    # share: one journal renders to one trace whichever package reads it
    meta = [{
        "ph": "M",
        "name": "process_name",
        "pid": 1,
        "args": {"name": "spark_rapids_jni_tpu journal"},
    }]
    for tid, label in sorted(tids.items()):
        meta.append({
            "ph": "M",
            "name": "thread_name",
            "pid": 1,
            "tid": tid,
            "args": {"name": label},
        })
    return {
        "displayTimeUnit": "ms",
        "otherData": {"base_unix_us": base, "schema": "sprt-journal-v2"},
        "traceEvents": meta + sorted(all_ev, key=lambda e: e["ts"]),
    }


def check_trace(trace, min_spans: int = 1) -> List[str]:
    """Machine validation of a rendered trace: structurally Chrome-trace, at least ``min_spans`` real
    (non-synthesized) complete spans, every event span-stamped, every
    parent id resolving to a rendered span. Returns problems (empty =
    pass)."""
    problems: List[str] = []
    if not isinstance(trace, dict) or not isinstance(
        trace.get("traceEvents"), list
    ):
        return ["not a Chrome-trace object (no traceEvents list)"]
    evs = [e for e in trace["traceEvents"] if e.get("ph") in ("X", "i")]
    slices = [e for e in evs if e["ph"] == "X"]
    real = [s for s in slices if not s["args"].get("synthesized")]
    if len(real) < min_spans:
        problems.append(
            f"only {len(real)} complete spans (< {min_spans} required)"
        )
    known = {s["args"].get("span_id") for s in slices}
    for e in evs:
        args = e.get("args", {})
        if args.get("span_id") is None:
            problems.append(
                f"event {e.get('name')!r} @{e.get('ts')} carries no "
                "span_id (pre-v2 journal line?)"
            )
            continue
        parent = args.get("parent_id")
        if parent is not None and parent not in known:
            problems.append(
                f"event {e.get('name')!r} @{e.get('ts')} has "
                f"unresolvable parent_id {parent}"
            )
    # to_chrome_trace synthesizes a slice for every UNKNOWN parent id,
    # so the per-event check above cannot fire on its own output — the
    # integrity signal there is the synthesized-span COUNT. Legitimate
    # never-closed spans are few (one ambient root per thread, plus
    # crash-cut spans); a broken stamper (id-counter reset, cross-
    # context mixing) manufactures one per garbage id
    synth = [s for s in slices if s["args"].get("synthesized")]
    if len(synth) > max(8, len(real) // 4):
        problems.append(
            f"{len(synth)} synthesized (never-closed/unknown) spans vs "
            f"{len(real)} complete — parent stamping looks broken "
            "(ambient roots should be few)"
        )
    for d in (e for e in slices if e["dur"] < 0):
        problems.append(f"negative duration slice {d.get('name')!r}")
    return problems


def span_stats(events: List[dict], top: int = 10) -> dict:
    """Top-N spans by CUMULATIVE wall, per kind and per name, from
    journal event records — the "summarize a bundle without opening
    Perfetto" view. Every span-close event
    carries ``wall_ms``; cumulative is the honest aggregate because
    spans nest (a run_plan's wall is inside its op's) and repeat (one
    op span per chunk)."""
    by_kind: Dict[str, List[float]] = {}
    by_name: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("event") not in SPAN_CLOSE_EVENTS:
            continue
        attrs = ev.get("attrs", {}) or {}
        if "wall_ms" not in attrs:
            continue
        wall = float(attrs["wall_ms"])
        kind = attrs.get("kind") or _KIND_BY_EVENT.get(
            ev.get("event"), "span"
        )
        name = ev.get("op") or ev.get("event")
        by_kind.setdefault(kind, []).append(wall)
        by_name.setdefault(f"{kind}:{name}", []).append(wall)

    def table(d):
        rows = [
            {
                "name": k,
                "count": len(v),
                "total_ms": round(sum(v), 3),
                "max_ms": round(max(v), 3),
                "mean_ms": round(sum(v) / len(v), 3),
            }
            for k, v in d.items()
        ]
        rows.sort(key=lambda r: -r["total_ms"])
        return rows[:top]

    return {"by_kind": table(by_kind), "by_name": table(by_name)}


def render_stats(stats: dict) -> str:
    out = []
    for title, rows in (
        ("by kind", stats["by_kind"]), ("by name", stats["by_name"]),
    ):
        out.append(f"top spans by cumulative wall ({title}):")
        if not rows:
            out.append("  (no closed spans)")
        for r in rows:
            out.append(
                f"  {r['total_ms']:>12.3f} ms  n={r['count']:<6} "
                f"max={r['max_ms']:.3f} mean={r['mean_ms']:.3f}  "
                f"{r['name']}"
            )
    return "\n".join(out) + "\n"


def convert(
    journal_path: str, out_path: Optional[str] = None
) -> Tuple[str, dict, int]:
    """File-to-file conversion; returns (out_path, trace, n_events)."""
    events = load_journal(journal_path)
    trace = to_chrome_trace(events)
    out = out_path or f"{journal_path}.trace.json"
    with open(out, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return out, trace, len(events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.traceview",
        description="Convert a telemetry journal (JSONL sink or "
        "dump_jsonl file) into Chrome-trace JSON for ui.perfetto.dev",
    )
    ap.add_argument("journal", help="journal JSONL path")
    ap.add_argument(
        "-o", "--out", default=None,
        help="output path (default: <journal>.trace.json)",
    )
    ap.add_argument(
        "--check", action="store_true",
        help="validate the emitted trace (parses, enough complete "
        "spans, parent ids resolve); exit 1 on failure",
    )
    ap.add_argument(
        "--min-spans", type=int, default=10,
        help="minimum complete (non-synthesized) spans for --check",
    )
    ap.add_argument(
        "--stats", type=int, nargs="?", const=10, default=None,
        metavar="N",
        help="print the top-N spans by cumulative wall (per kind and "
        "per name) after converting (default N=10)",
    )
    args = ap.parse_args(argv)

    try:
        events = load_journal(args.journal)
    except OSError as e:
        print(f"error: cannot read {args.journal}: {e}", file=sys.stderr)
        return 2
    if not events:
        print(
            f"error: {args.journal} holds no journal events — was the "
            "run executed with SPARK_JNI_TPU_METRICS pointing at this "
            "file (or dumped with metrics.dump_jsonl)?",
            file=sys.stderr,
        )
        return 2
    trace = to_chrome_trace(events)
    out = args.out or f"{args.journal}.trace.json"
    with open(out, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    n_x = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    n_i = sum(1 for e in trace["traceEvents"] if e.get("ph") == "i")
    print(
        f"{args.journal}: {len(events)} events -> {out} "
        f"({n_x} spans, {n_i} instants); open at ui.perfetto.dev"
    )
    if args.stats is not None:
        print(render_stats(span_stats(events, top=args.stats)), end="")
    if args.check:
        problems = check_trace(trace, min_spans=args.min_spans)
        if problems:
            for p in problems:
                print(f"traceview check: {p}", file=sys.stderr)
            return 1
        print(f"traceview check OK (>= {args.min_spans} complete spans)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
