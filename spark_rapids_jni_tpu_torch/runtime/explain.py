"""EXPLAIN CLI (the port's copy of the JAX package's
``runtime/explain.py``): render the fused-plan introspection view away
from the code that built the plans.

Two sources, one renderer family (``runtime/pipeline.py``'s
``render_plan_rows`` / the journal reconstruction below):

``python -m spark_rapids_jni_tpu_torch.explain --port 17807``
    scrape a live diag server's ``/plans`` endpoint (``runtime/diag.py``,
    armed by ``SPARK_JNI_TPU_DIAG``; the JAX package's serves the same
    document) and print its rendered explain — the text a flight
    bundle's ``explain.txt`` carries, from ``plan_cache_table()``
    rows.

``python -m spark_rapids_jni_tpu_torch.explain journal.jsonl``
    reconstruct the view from a journal file (a metrics sink, a
    bundle's ``journal_tail.jsonl``): per-plan build/hit activity
    (``plan_cache_miss``/``plan_cache_hit``), capacity-feedback
    transitions (``capacity_feedback``), the scan ingress summary
    (``scan_plan``), and — when the run was ANALYZE-mode — the
    per-stage cost table aggregated from ``stage_metrics`` events,
    device skew included. No live process needed: the journal is the
    bundle-mailed form of the same story.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional


def fetch_plans(port: int, host: str = "127.0.0.1", timeout: float = 10.0) -> dict:
    """GET the diag server's ``/plans`` JSON document."""
    import urllib.request

    url = f"http://{host}:{port}/plans"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def render_live(doc: dict) -> str:
    """Render a ``/plans`` scrape: prefer the server's own rendered
    explain (same renderer, no drift); fall back to rendering its raw
    rows for older servers."""
    text = doc.get("explain")
    if text:
        return text
    from .pipeline import render_plan_rows

    return render_plan_rows(doc.get("plans") or [])


def _iter_events(path: str):
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # journal tails may end mid-line on a crash
            if rec.get("kind") == "event":
                yield rec


def render_journal(path: str) -> str:
    """Reconstruct the explain view from journal events alone."""
    plans: "Dict[str, dict]" = {}
    scans: List[dict] = []
    stages: "Dict[tuple, dict]" = {}
    for rec in _iter_events(path):
        ev = rec.get("event")
        attrs = rec.get("attrs") or {}
        if ev in ("plan_cache_miss", "plan_cache_hit", "capacity_feedback"):
            sig = attrs.get("plan")
            if not sig:
                continue
            row = plans.setdefault(sig, {
                "op": rec.get("op"), "hits": 0, "misses": 0,
                "build_wall_ms": 0.0, "feedback": None,
            })
            if ev == "plan_cache_hit":
                row["hits"] += 1
            elif ev == "plan_cache_miss":
                row["misses"] += 1
                row["build_wall_ms"] += float(attrs.get("wall_ms") or 0.0)
            else:
                row["feedback"] = {
                    "knobs": attrs.get("knobs"),
                    "waste_pct": attrs.get("waste_pct"),
                }
        elif ev == "scan_plan":
            scans.append(attrs)
        elif ev == "stage_metrics":
            key = (rec.get("op"), attrs.get("stage"), attrs.get("stage_kind"))
            st = stages.setdefault(key, {
                "chunks": 0, "rows": 0, "bytes": 0, "wall_ms": 0.0,
                "skew": None,
            })
            st["chunks"] += 1
            st["rows"] += int(attrs.get("rows") or 0)
            st["bytes"] += int(attrs.get("bytes") or 0)
            st["wall_ms"] += float(attrs.get("wall_ms") or 0.0)
            if attrs.get("skew") is not None:
                st["skew"] = max(st["skew"] or 0.0, float(attrs["skew"]))
    out: List[str] = [f"== explain (journal {path}) =="]
    for s in scans:
        out.append(
            f"scan: files={s.get('files')} rows={s.get('rows')} "
            f"row_groups={s.get('row_groups')} "
            f"pruned={s.get('row_groups_pruned')} "
            f"bytes_planned={s.get('bytes_planned')} "
            f"bytes_skipped={s.get('bytes_skipped')} "
            f"predicate={s.get('predicate')}"
        )
    if not plans:
        out.append("plan cache: no plan events in journal")
    for sig, row in plans.items():
        out.append(
            f"plan {sig} op={row['op']} hits={row['hits']} "
            f"builds={row['misses']} "
            f"build_wall={round(row['build_wall_ms'], 3)}ms"
        )
        fb = row["feedback"]
        if fb:
            out.append(
                f"  feedback: waste={fb['waste_pct']}% "
                f"knobs={fb['knobs']}"
            )
    if stages:
        out.append("analyze stage table (from stage_metrics):")
        for (op, idx, kind), st in sorted(
            stages.items(), key=lambda kv: (str(kv[0][0]), kv[0][1] or 0)
        ):
            line = (
                f"  {op} stage {idx}:{kind} chunks={st['chunks']} "
                f"rows={st['rows']} bytes={st['bytes']} "
                f"wall={round(st['wall_ms'], 3)}ms"
            )
            if st["skew"] is not None:
                line += f" max_device_skew={st['skew']}"
            out.append(line)
    return "\n".join(out) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.explain",
        description="Render fused-plan EXPLAIN from a live diag port "
        "or a journal file.",
    )
    ap.add_argument(
        "journal", nargs="?", default=None,
        help="journal JSONL (a metrics sink or a flight bundle's "
        "journal_tail.jsonl)",
    )
    ap.add_argument(
        "--port", type=int, default=None,
        help="live diag server port: scrape /plans and render it",
    )
    ap.add_argument(
        "--host", default="127.0.0.1",
        help="diag server host (default 127.0.0.1)",
    )
    args = ap.parse_args(argv)
    if (args.port is None) == (args.journal is None):
        ap.error("pass exactly one source: a journal path or --port")
    if args.port is not None:
        try:
            doc = fetch_plans(args.port, args.host)
        except OSError as e:
            print(f"explain: cannot reach diag server: {e}",
                  file=sys.stderr)
            return 1
        sys.stdout.write(render_live(doc))
        return 0
    try:
        sys.stdout.write(render_journal(args.journal))
    except OSError as e:
        print(f"explain: cannot read journal: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
