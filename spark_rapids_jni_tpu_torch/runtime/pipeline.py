"""Fused query pipelines: one program per chunk, with a plan cache (the
port's twin of the single-device part of the JAX package's
``runtime/pipeline.py``).

- ``Pipeline()`` records a chain of facade ops (filter -> casts ->
  JSON/regex -> decimal arithmetic -> join / group_by -> row
  conversion, plus generic ``map`` guard stages) as a LAZY plan —
  nothing executes at build time,
- ``run(table)`` runs the whole chain as ONE program for the chunk's
  shapes: the padded chain with every stage in its sync-free form
  (``ops/_strategy.fusing``), so no stage waits for the host,
- a process-wide **plan cache** keyed on (op-chain signature, static
  plan knobs, the input tensors' structure, shapes, dtypes and
  devices) reuses the built program across chunks:
  the first chunk of a shape builds, every following chunk is a
  dictionary hit (``pipeline.plan_cache_hit`` / ``plan_cache_miss``
  counters and journal events),
- execution runs under ``runtime/resource.py``'s retry scopes: inside
  ``with resource.task():`` an undersized static capacity (group slots,
  join output rows, a pinned string width) re-plans geometrically /
  count-informed and RE-RUNS the chain at the grown static sizes.
  Outside a scope, overflow raises ``CapacityExceededError``.

The program's form on the card is a CUDA graph: the padded chain is
captured once per plan over static input buffers and replayed per
chunk (inputs copied in, outputs cloned out), one launch of the whole
chain instead of ~2,000 dispatches. It was chosen by measurement on the
H100 against the same chain dispatched eagerly with no host sync
inside (PERF.md, Findings, PR 7: the q1 chain ran 5-12 % faster as a
replayed graph, with ~100 host ops a chunk instead of ~1,900). The
chunk and the join build tables are both copied into the graph's
static buffers on every call, and the graphs of a device replay one
at a time on one stream. On the CPU, and for ANALYZE mode's per-stage
slices, the same callable runs eagerly. A chain a graph cannot capture
(a ``map`` stage that reads a value to the host) raises
``PipelineError`` naming the stage — it never quietly runs eager.

Filter semantics under fusion: a ``filter`` stage cannot compact rows
without a host sync, so it becomes a live-row mask that flows down the
chain. ``group_by`` separates dead rows into a synthetic liveness group
(masked keys + a leading liveness key column, one extra capacity slot)
so they can never merge with genuine null-key groups; ``join`` passes
the mask as ``left_occupied``. The collect compacts at the end, exactly
equal to the eager chain.

Every count the host needs — overflow counts, observed sizes, the live
row count, the live payload bytes — rides ONE int64 vector the chain
computes last; dispatch starts its copy to page-locked memory and
records an event, and the deferred sync waits on that event alone, so
retiring chunk i never waits for chunk i+1's queued work.

``stream(shard=...)`` splits every chunk over a device mesh inside its
one program: the chunk pads to a mesh multiple (dead rows masked by the
live mask) and is cut into P row blocks, row-local stages run per
shard, ``group_by`` lowers to the two-phase distributed aggregate and
``join`` to a broadcast or co-partitioned distributed join (the
exchange of ``parallel/shuffle.py``), and the result gathers back onto
the first mesh device before the tail vector. When every shard shares
one card the sharded chain is one CUDA graph like any other; over
several cards it runs eagerly. ``donate=True`` is accepted with the
JAX package's checks, but torch has no buffer donation: it promises
only that the pipeline drops its own references to the chunk.
"""

from __future__ import annotations

import contextvars
import dataclasses
import dis
import functools
import hashlib
import os
import threading
import time
import types
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import events as _events
from . import metrics as _metrics
from . import resource as _resource
from . import spans as _spans
from . import trace as _trace

# ---------------------------------------------------------------------
# plan cache (process-wide, bounded). Key = (chain signature, static
# plan items, donate, input structure + shapes). A hit
# means the SAME chain at the SAME static sizes saw the SAME chunk
# shapes — the built program is reusable verbatim.

_PLAN_CACHE_CAP = 128
# a captured graph holds its chain's device memory (its private pool)
# for as long as it is cached, so graph entries get a tighter LRU cap
_GRAPH_CACHE_CAP = 16
# capacity-feedback rows outlive programs, so the side table gets its
# own, wider LRU cap
_PLAN_FEEDBACK_CAP = 256
# sprtcheck: guarded-by=_plan_lock
_plan_cache: "Dict[tuple, Any]" = {}
# side table mirroring _plan_cache keys: per-entry bookkeeping the hot
# path never reads (signature hash, static plan, hit count, build
# cost) — the flight recorder's plan_cache.json and plan_cache_table()
# sprtcheck: guarded-by=_plan_lock
_plan_stats: "Dict[tuple, dict]" = {}
# capacity-feedback side table, keyed by chain signature hash: per-knob
# observed exact sizes + the geometric bucket the NEXT chunk's initial
# plan starts from, plus tighten/widen counts and the last occupancy
# sprtcheck: guarded-by=_plan_lock
_plan_feedback: "Dict[str, dict]" = {}
# one CUDA graph memory pool, one stream and one lock per device,
# shared by every captured chain: a replay's intermediates are dead
# once its outputs are cloned, so the next graph reuses that memory
# instead of each graph holding its own chain-sized pool (a store_sales
# chain is ~13 GB at 2 Mi rows). The stream is shared too: the
# allocator reuses a freed block only on the stream it was freed on.
# The lock serialises captures and replays across threads, since every
# replay writes the shared pool and its graph's static buffers. The
# fourth entry holds the pool's live graphs: once the last one is
# released (the plan cache cleared or turned over), the allocators drop
# the pool, and capturing into its id again fails, so the next capture
# takes a fresh pool id.
# sprtcheck: guarded-by=_plan_lock
_graph_pools: "Dict[str, list]" = {}
_plan_lock = threading.Lock()


def plan_cache_clear() -> None:
    """Drop every cached program and the capacity-feedback side table
    (tests)."""
    with _plan_lock:
        _plan_cache.clear()
        _plan_stats.clear()
        _plan_feedback.clear()


def plan_cache_size() -> int:
    with _plan_lock:
        return len(_plan_cache)


def plan_cache_table() -> "List[dict]":
    """Diagnostic copy of the plan cache's bookkeeping, hottest first:
    one row per cached program with the chain signature hash, the
    pipeline name, the static plan knobs, input shapes, hit count, and
    build wall time — what the flight recorder snapshots."""
    with _plan_lock:
        rows = [dict(s) for s in _plan_stats.values()]
        for r in rows:
            fb = _plan_feedback.get(r["sig"])
            r["feedback"] = None if fb is None else _feedback_row(fb)
    return sorted(rows, key=lambda r: -r["hits"])


def _json_safe(v):
    """Recursively coerce a plan/param value to JSON-renderable types
    (tuples -> lists; anything opaque -> its repr)."""
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return repr(v)


def _render_feedback(fb: Optional[dict], indent: str = "  ") -> "List[str]":
    """Shared text renderer for one capacity-feedback row."""
    if not fb:
        return [f"{indent}feedback: none recorded"]
    lines = [
        f"{indent}feedback: chunks={fb['chunks']} "
        f"tighten={fb['tighten']} widen={fb['widen']} "
        f"occupancy={fb['occupancy_pct']}% waste={fb['waste_pct']}%"
    ]
    for k in sorted(fb.get("knobs", ())):
        r = fb["knobs"][k]
        lines.append(f"{indent}  {k}: observed={r['observed']} bucket={r['bucket']}")
    return lines


def render_plan_rows(rows: "List[dict]") -> str:
    """Text view of ``plan_cache_table()`` rows — the shared renderer
    behind ``Pipeline.explain()``'s cached-plans section, the flight
    bundle's ``explain.txt`` and the explain CLI."""
    if not rows:
        return "plan cache: empty\n"
    out: "List[str]" = []
    for r in rows:
        out.append(
            f"plan {r['sig']} pipeline={r['pipeline']} "
            f"hits={r['hits']} build={r['build_wall_ms']}ms "
            f"donate={int(bool(r.get('donate')))} form={r.get('form')}"
            + ("" if r.get("shard") is None else f" shard={r['shard']!r}")
        )
        stages = r.get("stages") or []
        if stages:
            out.append("  stages: " + " -> ".join(stages))
        plan = r.get("plan") or {}
        if plan:
            out.append("  knobs: " + " ".join(
                f"{k}={_json_safe(v)}" for k, v in sorted(plan.items())
            ))
        out.extend(_render_feedback(r.get("feedback")))
    return "\n".join(out) + "\n"


def render_explain(doc: dict) -> str:
    """Text renderer for a ``Pipeline.explain(fmt="json")`` document."""
    out = [
        f"== Pipeline {doc['pipeline']} [sig {doc['signature']}] ==",
        f"analyze={'on' if doc['analyze'] else 'off'} "
        f"capacity_feedback={'on' if doc['capacity_feedback'] else 'off'}",
    ]
    for s in doc["stages"]:
        params = " ".join(
            f"{k}={v}" for k, v in sorted(s["params"].items()) if v is not None
        )
        out.append(f"  stage {s['index']}: {s['kind']}" + (f" ({params})" if params else ""))
    plan = doc.get("plan") or {}
    if plan:
        out.append("plan points:")
        for k in sorted(plan):
            out.append(f"  {k} = {plan[k]}")
    shard = doc.get("shard")
    if shard:
        out.append(f"shard: axis={shard['axis']} devices={shard['devices']}")
        for i, choice in sorted(shard.get("broadcast", {}).items()):
            out.append(f"  join stage {i}: {choice}")
    out.extend(_render_feedback(doc.get("feedback"), indent=""))
    scan = doc.get("scan")
    if scan:
        out.append("scan:")
        for k in sorted(scan):
            out.append(f"  {k} = {scan[k]}")
    out.append("cached plans:")
    out.append(render_plan_rows(doc.get("plans") or []).rstrip("\n"))
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------
# capacity feedback planner: at retirement every successful chunk
# records its OBSERVED exact sizes per plan knob; the next chunk of the
# same chain starts from those observations quantized to geometric
# buckets (pow2 string-width buckets for byte widths, next_pow2 for row
# capacities / pair counts), so the plan cache stays log-bounded while
# granted capacity tracks real occupancy. An undersized chunk re-plans
# through the count-informed retry driver; rows are never dropped.

FEEDBACK_ENV = "SPARK_JNI_TPU_CAPACITY_FEEDBACK"
_FEEDBACK_MODES = ("on", "off")
_feedback_override: Optional[bool] = None
# per-context override, resolved BEFORE the process override: two
# tenants interleaved on one thread never share this knob, and it folds
# into every plan signature
_ctx_feedback: "contextvars.ContextVar[Optional[bool]]" = (
    contextvars.ContextVar("sprt_capacity_feedback", default=None)
)
# per-context plan-cache accounting sink: when a context installs a
# dict here, every plan-cache hit/miss under it ALSO counts into it
_ctx_cache_account: "contextvars.ContextVar[Optional[dict]]" = (
    contextvars.ContextVar("sprt_plan_cache_account", default=None)
)


def capacity_feedback() -> bool:
    """Resolved capacity-feedback knob: the context override, else the
    in-process override, else ``SPARK_JNI_TPU_CAPACITY_FEEDBACK``
    (default off). A malformed value raises."""
    ctx = _ctx_feedback.get()
    if ctx is not None:
        return ctx
    if _feedback_override is not None:
        return _feedback_override
    raw = os.environ.get(FEEDBACK_ENV, "off").strip().lower()
    if raw not in _FEEDBACK_MODES:
        raise ValueError(f"{FEEDBACK_ENV}={raw!r}: expected one of {_FEEDBACK_MODES}")
    return raw == "on"


def set_capacity_feedback(on: Optional[bool]) -> None:
    """Override (or clear, with None) the feedback knob in-process."""
    global _feedback_override
    _feedback_override = None if on is None else bool(on)


def set_context_capacity_feedback(on: Optional[bool]) -> None:
    """Set (or clear, with None) the CURRENT CONTEXT's feedback knob."""
    _ctx_feedback.set(None if on is None else bool(on))


def set_context_cache_accounting(sink: Optional[dict]) -> None:
    """Install (or clear) the current context's plan-cache accounting
    sink: a dict whose ``"hits"`` / ``"misses"`` keys _get_executable
    increments next to the process-wide counters."""
    _ctx_cache_account.set(sink)


# ---------------------------------------------------------------------
# ANALYZE mode: per-stage cost attribution inside a fused chain. With
# the knob on, dispatch runs the chain as one program per stage, back
# to back, each ending in an in-chain probe (live rows, live varlen
# bytes) and an event; the sync times each stage's completion, so the
# per-stage walls partition the chain wall. The knob folds into every
# plan signature; ``off`` is the zero-overhead path.

ANALYZE_ENV = "SPARK_JNI_TPU_ANALYZE"
_ANALYZE_MODES = ("on", "off")
_analyze_override: Optional[bool] = None
_ctx_analyze: "contextvars.ContextVar[Optional[bool]]" = (
    contextvars.ContextVar("sprt_analyze", default=None)
)
# per-context stage-metrics sink: every analyzed stage under the
# context also folds its rows/bytes/wall into it
_ctx_stage_sink: "contextvars.ContextVar[Optional[dict]]" = (
    contextvars.ContextVar("sprt_stage_sink", default=None)
)


def analyze_mode() -> bool:
    """Resolved ANALYZE knob: the context override, else the in-process
    override, else ``SPARK_JNI_TPU_ANALYZE`` (default off). The
    per-call ``run/stream(analyze=...)`` argument lands in the context
    override for the call."""
    ctx = _ctx_analyze.get()
    if ctx is not None:
        return ctx
    if _analyze_override is not None:
        return _analyze_override
    raw = os.environ.get(ANALYZE_ENV, "off").strip().lower()
    if raw not in _ANALYZE_MODES:
        raise ValueError(f"{ANALYZE_ENV}={raw!r}: expected one of {_ANALYZE_MODES}")
    return raw == "on"


def set_analyze(on: Optional[bool]) -> None:
    """Override (or clear, with None) the ANALYZE knob in-process."""
    global _analyze_override
    _analyze_override = None if on is None else bool(on)


def set_context_analyze(on: Optional[bool]) -> None:
    """Set (or clear, with None) the CURRENT CONTEXT's ANALYZE knob."""
    _ctx_analyze.set(None if on is None else bool(on))


def set_context_stage_sink(sink: Optional[dict]) -> None:
    """Install (or clear) the current context's stage-metrics sink:
    ``{"<stage>:<kind>": {rows, bytes, wall_ms, chunks}}``."""
    _ctx_stage_sink.set(sink)


def _quantize_knob(key: str, observed: int) -> int:
    """Geometric bucket for one observed knob need: byte widths ride the
    string pad buckets (pow2, floor 8); row capacities and pair counts
    ride bare next_pow2 (floor 1)."""
    from ..columnar.strings import bucket_length
    from ..ops.ragged import next_pow2

    tail = key.split(".", 1)[1] if "." in key else key
    if "width" in tail:
        return bucket_length(max(int(observed), 1))
    return max(next_pow2(max(int(observed), 1)), 1)


def feedback_table() -> "Dict[str, dict]":
    """Diagnostic copy of the capacity-feedback side table keyed by
    chain signature hash."""
    with _plan_lock:
        return {sig: _feedback_row(fb) for sig, fb in _plan_feedback.items()}


def _feedback_row(fb: dict) -> dict:
    knobs = {k: {"observed": r["observed"], "bucket": r["bucket"]} for k, r in fb["knobs"].items()}
    return {
        "pipeline": fb["pipeline"],
        "knobs": knobs,
        "tighten": fb["tighten"],
        "widen": fb["widen"],
        "occupancy_pct": fb["occupancy_pct"],
        "waste_pct": fb["waste_pct"],
        "chunks": fb["chunks"],
    }


def _feedback_for(sig: str) -> Optional[dict]:
    """{knob: {"observed", "bucket"}} snapshot for _initial_plan."""
    with _plan_lock:
        fb = _plan_feedback.get(sig)
        return None if fb is None else dict(fb["knobs"])


def _record_feedback(sig: str, name: str, plan: dict, stats: dict) -> None:
    """Retirement hook: fold one successful chunk's observed exact sizes
    into the side table, count bucket transitions, and publish the
    waste gauge. ``plan`` is the knob set the FINAL (overflow-free)
    attempt ran with; ``stats`` the observed needs synced with the
    overflow counts. Wire-pin knobs (``{i}.wire``, the sharded stream's
    droppable phase-2 pins) have no observation: their FINAL plan value
    is recorded, so a pin a re-plan dropped stays dropped for the chunks
    behind it."""
    wire = {k: v for k, v in plan.items() if k.endswith(".wire")}
    stats = {k: int(v) for k, v in stats.items() if k in plan and not k.endswith(".wire")}
    if not stats and not wire:
        return
    changes: Dict[str, tuple] = {}
    wastes = []
    fb_evicted: Optional[str] = None
    with _plan_lock:
        fb = _plan_feedback.get(sig)
        if fb is None:
            if len(_plan_feedback) >= _PLAN_FEEDBACK_CAP:
                fb_evicted = next(iter(_plan_feedback))
                _plan_feedback.pop(fb_evicted)
            fb = _plan_feedback[sig] = {
                "pipeline": name,
                "knobs": {},
                "tighten": 0,
                "widen": 0,
                "occupancy_pct": 0.0,
                "waste_pct": 0.0,
                "chunks": 0,
            }
        else:
            # dict-order LRU: reinsert so the coldest sig is first
            _plan_feedback.pop(sig)
            _plan_feedback[sig] = fb
        occs = []
        for k, v in wire.items():
            fb["knobs"][k] = {"observed": None, "bucket": v}
        for k, obs in stats.items():
            granted = int(plan[k])
            bucket = _quantize_knob(k, obs)
            prev = fb["knobs"].get(k)
            # the transition the NEXT chunk will see
            base = prev["bucket"] if prev is not None else granted
            fb["knobs"][k] = {"observed": obs, "bucket": bucket}
            if bucket < base:
                fb["tighten"] += 1
                changes[k] = (base, bucket)
            elif bucket > base:
                fb["widen"] += 1
                changes[k] = (base, bucket)
            if granted > 0:
                occ = min(obs, granted) / granted
                occs.append(occ)
                wastes.append(100.0 * (1.0 - occ))
        fb["chunks"] += 1
        if occs:
            fb["occupancy_pct"] = round(100.0 * sum(occs) / len(occs), 1)
            fb["waste_pct"] = round(sum(wastes) / len(wastes), 1)
        waste = fb["waste_pct"]
    if fb_evicted is not None:
        _metrics.counter("pipeline.plan_cache_evict").inc()
        _events.emit("plan_cache_evict", op=f"Pipeline.{name}", plan=fb_evicted, table="feedback")
    if wastes:
        _metrics.gauge("pipeline.capacity_waste_pct").set(waste)
    if changes:
        tighten = sum(1 for a, b in changes.values() if b < a)
        widen = len(changes) - tighten
        if tighten:
            _metrics.counter("capacity.tighten").inc(tighten)
        if widen:
            _metrics.counter("capacity.widen").inc(widen)
        _events.emit(
            "capacity_feedback",
            op=f"Pipeline.{name}",
            plan=sig,
            knobs={k: {"from": a, "to": b} for k, (a, b) in changes.items()},
            waste_pct=waste,
        )


# ---------------------------------------------------------------------
# tensor trees: a chunk, a chain state, or a program's outputs as a flat
# tensor list plus a rebuild function (the graph form's static buffers
# and the plan key's shape signature)


def _flatten(obj):
    """(tensor leaves, structure spec) of a Table/Column/list/dict tree."""
    from ..columnar.column import Column
    from ..columnar.table import Table

    from ..parallel.mesh import ShardedTable

    leaves: List[torch.Tensor] = []

    def enc(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("T",)
        if isinstance(x, ShardedTable):
            return ("Sharded", x.mesh, tuple(enc(t) for t in x.shards))
        if isinstance(x, Table):
            return ("Table", tuple(enc(c) for c in x.columns), x.names)
        if isinstance(x, Column):
            return ("Col", x.dtype, enc(x.data), enc(x.validity), enc(x.offsets))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(enc(v) for v in x))
        if isinstance(x, dict):
            return ("dict", tuple((k, enc(v)) for k, v in x.items()))
        return ("C", x)

    return leaves, enc(obj)


def _unflatten(spec, leaves: Sequence[torch.Tensor]):
    """Inverse of ``_flatten``: rebuild the tree over ``leaves``."""
    from ..columnar.column import Column
    from ..columnar.table import Table

    from ..parallel.mesh import ShardedTable

    it = iter(leaves)

    def dec(s):
        tag = s[0]
        if tag == "T":
            return next(it)
        if tag == "Sharded":
            return ShardedTable([dec(t) for t in s[2]], s[1])
        if tag == "Table":
            return Table([dec(c) for c in s[1]], s[2])
        if tag == "Col":
            return Column(s[1], dec(s[2]), dec(s[3]), dec(s[4]))
        if tag in ("list", "tuple"):
            vals = [dec(v) for v in s[1]]
            return vals if tag == "list" else tuple(vals)
        if tag == "dict":
            return {k: dec(v) for k, v in s[1]}
        return s[1]

    return dec(spec)


def _avals_key(tree) -> tuple:
    """Hashable (structure, per-tensor shape/dtype/device) identity."""
    leaves, spec = _flatten(tree)
    return (repr(spec), tuple((tuple(t.shape), str(t.dtype), str(t.device)) for t in leaves))


# ---------------------------------------------------------------------
# chain state threaded through the stages


@dataclasses.dataclass
class _State:
    table: Any  # columnar Table
    live: Optional[torch.Tensor]  # bool [n] live-row mask (None = all)
    sides: tuple  # bound side tables (join builds)
    counts: Dict[str, torch.Tensor]  # overflow indicators, int32 scalars
    stats: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # observed exact needs per plan knob (scalars reusing the overflow
    # reductions) — the capacity-feedback planner's input
    nested: Any = None  # terminal nested result pieces (from_json)


class PipelineError(RuntimeError):
    pass


# ---------------------------------------------------------------------
# sharded streaming window: ``Pipeline.stream(shard=...)`` splits every
# in-flight chunk over a mesh INSIDE the chunk's one program — row-local
# stages run per shard, group_by lowers to the two-phase distributed
# aggregate (its phase-2 exchange takes the stage's wire pins), join to
# a broadcast or co-partitioned distributed join. Retirement stays one
# batched transfer per chunk, with per-device occupancy accounting.


class _ShardSpec:
    """Resolved mesh context of a sharded stream: the axis name, the
    shard count and the Mesh. ``key()`` is the plan-cache identity: a
    chunk built for an 8-shard mesh never reuses a one-device program,
    nor one built for other devices."""

    __slots__ = ("axis", "n_dev", "mesh")

    def __init__(self, axis: str, n_dev: int, mesh):
        self.axis = axis
        self.n_dev = n_dev
        self.mesh = mesh

    def key(self) -> tuple:
        return ("shard", self.axis, self.n_dev, tuple(str(d) for d in self.mesh.devices))


# stages a sharded window cannot lower, each with the reason the
# validation error names
# sprtcheck: guarded-by=frozen
_SHARD_INCOMPATIBLE = {
    "from_json": "returns nested pieces with no occupancy sidecar",
    "to_rows": "emits JCUDF rows with no live-mask discipline",
}

# per-device byte budget under which a sharded join's build side
# replicates (broadcast) instead of co-partitioning through the hash
# exchange; a stage's explicit ``broadcast=`` always wins
BCAST_BUDGET_ENV = "SPARK_JNI_TPU_BCAST_BUDGET"


def broadcast_budget() -> int:
    """Resolved per-device broadcast budget in bytes (default 4 MiB).
    A malformed value raises."""
    raw = os.environ.get(BCAST_BUDGET_ENV, "").strip()
    if not raw:
        return 1 << 22
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{BCAST_BUDGET_ENV}={raw!r}: expected an int byte count")


def _pad_rows_traced(table, m: int):
    """Append ``m`` dead rows with no host sync (static ``m``): fixed
    planes zero-extend, varlen columns gain zero-length rows (payload
    untouched), validity extends False. The caller masks the padding
    dead through the chain's live mask."""
    from ..columnar.column import Column
    from ..columnar.table import Table

    cols = []
    for c in table.columns:
        v = c.validity
        if v is not None:
            v = torch.cat([v, torch.zeros((m,), dtype=v.dtype, device=v.device)])
        if c.is_varlen:
            offs = torch.cat([c.offsets, c.offsets[-1:].expand(m)])
            cols.append(Column(c.dtype, c.data, v, offs))
        else:
            pad = torch.zeros((m,) + tuple(c.data.shape[1:]), dtype=c.data.dtype,
                              device=c.data.device)
            cols.append(Column(c.dtype, torch.cat([c.data, pad]), v))
    return Table(cols, table.names)


def _shard_constrain(table, live, shard: _ShardSpec):
    """Cut the chunk (and its live mask) into the mesh's P row blocks,
    block i on ``mesh.devices[i]`` (no host sync inside the chain)."""
    from ..parallel.mesh import shard_table, shard_vector

    st = shard_table(table, shard.mesh)
    return st, None if live is None else shard_vector(live, shard.mesh, table.num_rows)


def _shard_prologue(st: "_State", shard: _ShardSpec) -> "_State":
    """Pad the chunk to a multiple of the mesh size (dead rows masked by
    the live mask) and cut it into shards. The pad amount is a pure
    function of the chunk's shape, so same-shape chunks share a plan."""
    n = st.table.num_rows
    pad = (-n) % shard.n_dev
    if pad:
        dev = _table_device(st.table)
        st.table = _pad_rows_traced(st.table, pad)
        keep = torch.arange(n + pad, device=dev) < n
        st.live = keep if st.live is None else torch.cat([st.live, keep[n:]])
    st.table, st.live = _shard_constrain(st.table, st.live, shard)
    return st


def _gather_state(st: "_State", shard: _ShardSpec) -> "_State":
    """The sharded chain's epilogue: every shard's live row count joins
    the stats (``shard.live.<d>``, the per-device occupancy the
    retirement publishes), then the shards gather onto the first mesh
    device."""
    from ..parallel.mesh import ShardedTable

    if not isinstance(st.table, ShardedTable):
        return st
    first = shard.mesh.devices[0]
    for d, part in enumerate(st.table.shards):
        if st.live is None:
            cnt = torch.full((), part.num_rows, dtype=torch.int64, device=first)
        else:
            cnt = st.live[d].sum().to(first)
        st.stats[f"shard.live.{d}"] = cnt
    if st.live is not None:
        st.live = torch.cat([v.to(first) for v in st.live])
    st.table = st.table.gather()
    return st


def _stage_probe(st: "_State", shard: Optional[_ShardSpec] = None) -> torch.Tensor:
    """ANALYZE-mode per-stage observation, computed in the chain at the
    tail of a stage: int64 [2] (live rows after the stage, live varlen
    bytes), and under a sharded stream [2 + 2P]: the same per shard
    (rows, then bytes) behind them, the mesh skew map's raw data. No
    sync: the host reads it at the chunk's one transfer."""
    from ..parallel.mesh import ShardedTable

    sharded = isinstance(st.table, ShardedTable)
    parts = st.table.shards if sharded else [st.table]
    lives = (st.live if sharded else [st.live]) if st.live is not None else [None] * len(parts)
    dev = _table_device(st.table)
    rows_d, bytes_d = [], []
    for part, live in zip(parts, lives):
        n = part.num_rows
        rows = (live.sum().to(torch.int64) if live is not None
                else torch.full((), n, dtype=torch.int64, device=dev))
        nbytes = torch.zeros((), dtype=torch.int64, device=dev)
        for c in part.columns:
            if not getattr(c, "is_varlen", False) or len(c) != n or n == 0:
                continue
            lens = c.string_lengths().to(torch.int64)
            if live is not None:
                lens = torch.where(live, lens, 0)
            nbytes = nbytes + lens.sum().to(dev)
        rows_d.append(rows.to(dev))
        bytes_d.append(nbytes)
    head = [torch.stack(rows_d).sum(), torch.stack(bytes_d).sum()]
    if shard is None or not sharded:
        return torch.stack(head)
    return torch.cat([torch.stack(head), torch.stack(rows_d), torch.stack(bytes_d)])


def _table_device(table) -> torch.device:
    if hasattr(table, "mesh"):
        return table.mesh.devices[0]
    for c in table.columns:
        data = getattr(c, "data", None)
        if isinstance(data, torch.Tensor):
            return data.device
    return torch.device("cpu")


# ---------------------------------------------------------------------
# map-stage plan identity: a Python function folds into the plan key by
# its code, the globals it reads, its defaults and its closure state


_fn_tokens = iter(range(1, 1 << 62))  # process-unique closure ids


def _foldable_const(v, depth: int = 0) -> Optional[str]:
    """Stable repr for a module-global binding that can ride the
    structural signature: hashable immutables, and small tensors/arrays
    by CONTENT. None = not foldable (a live value — token the entry)."""
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return repr(v)
    if depth < 2 and isinstance(v, (tuple, frozenset)):
        items = sorted(v, key=repr) if isinstance(v, frozenset) else v
        parts = [_foldable_const(x, depth + 1) for x in items]
        if all(p is not None for p in parts):
            return f"{type(v).__name__}({','.join(parts)})"
    if isinstance(v, (np.ndarray, torch.Tensor)) and _numel(v) <= _ARRAY_FOLD_MAX:
        # small constant lookup tables fold by CONTENT, so an entry
        # reading one stays structurally reusable; rebinding OR mutating
        # it changes the hash and re-plans
        try:
            h = _array_content_hash(v)
        except Exception:
            return None
        return f"arr({v.dtype},{tuple(v.shape)},{h})"
    return None


def _numel(v) -> int:
    return int(v.numel()) if isinstance(v, torch.Tensor) else int(v.size)


# the memo two concurrent signature() calls race on: its own leaf lock;
# the weakref finalizer routes through _array_hash_evict so the GC-time
# pop also takes the lock
_array_hash_lock = threading.Lock()
# sprtcheck: guarded-by=_array_hash_lock
_array_hash_cache: Dict[int, tuple] = {}


def _array_hash_evict(key: int) -> None:
    """weakref.finalize callback: drop a dead tensor's memoized hash."""
    with _array_hash_lock:
        _array_hash_cache.pop(key, None)


def _tensor_digest(t: torch.Tensor) -> str:
    """Content hash of a tensor computed ON ITS DEVICE: its bytes as
    int64 lanes times two fixed pseudo-random weight vectors, summed
    with wraparound, plus the byte count — one sync reads the three
    words."""
    b = t.detach().contiguous().view(-1).view(torch.uint8).to(torch.int64)
    n = b.shape[0]
    g = torch.Generator().manual_seed(0x5EED)
    w = torch.randint(-(1 << 62), 1 << 62, (2, max(n, 1)), generator=g, dtype=torch.int64)
    w = w[:, :n].to(b.device)
    words = torch.stack([(b * w[0]).sum(), ((b + 1) * w[1]).sum(),
                         torch.tensor(n, device=b.device)]).tolist()
    return hashlib.sha1(repr(words).encode()).hexdigest()[:16]


def _array_content_hash(v) -> str:
    """Content hash of a small constant. A torch tensor hashes on its
    device and is memoized per object AND its version counter (an
    in-place mutation bumps the version, so it re-hashes); a mutable
    numpy array always re-hashes."""
    if not isinstance(v, torch.Tensor):
        return hashlib.sha1(np.asarray(v).tobytes()).hexdigest()[:16]
    version = v._version
    with _array_hash_lock:
        hit = _array_hash_cache.get(id(v))
    if hit is not None and hit[0] == version:
        return hit[1]
    h = _tensor_digest(v)
    if hit is None:
        try:
            # finalizer FIRST: an entry must never outlive its tensor,
            # or a reused id would alias hashes
            weakref.finalize(v, _array_hash_evict, id(v))
        except TypeError:
            return h
    with _array_hash_lock:
        _array_hash_cache[id(v)] = (version, h)
    return h


_ARRAY_FOLD_MAX = 1024  # elements; larger array globals token instead


_STRUCTURE_GLOBALS = (
    types.ModuleType,
    types.FunctionType,
    types.BuiltinFunctionType,
    type,
)


_MISSING = object()
_ATTR_OPS = ("LOAD_ATTR", "LOAD_METHOD")

# builtins that read state the static fold cannot see — an entry using
# one degrades to a token
_DYNAMIC_LOOKUPS = frozenset(
    {"getattr", "globals", "vars", "eval", "exec", "locals", "__import__"}
)


_HEAPTYPE = 1 << 9  # Py_TPFLAGS_HEAPTYPE: Python-defined class

# heap classes from these packages fold by qualname anyway: their attr
# namespaces are immutable by convention
_TRUSTED_CLASS_ROOTS = ("torch", "numpy")


def _structure_repr(path: str, v) -> Optional[str]:
    """Identity fold for a bare structural use (``helper(x)``,
    ``torch.where(...)``); None = not safely foldable, token the entry.
    A plain function folds its CODE hash, so rebinding the helper
    between builds re-plans. Builtins and C extension types fold
    module+qualname. Heap classes and bare modules are MUTABLE attr
    namespaces and return None."""
    if isinstance(v, types.ModuleType):
        return None
    ident = f"{getattr(v, '__module__', '?')}.{getattr(v, '__qualname__', '?')}"
    if isinstance(v, types.FunctionType):
        h = _code_fingerprint(v.__code__).hex()[:8]
        return f"{path}=fn:{ident}:{h}"
    if isinstance(v, type):
        if v.__flags__ & _HEAPTYPE:
            root = (getattr(v, "__module__", "") or "").split(".")[0]
            if root in _TRUSTED_CLASS_ROOTS:
                return f"{path}=cls:{ident}"
            return None
        return f"{path}=cls:{ident}"
    self_obj = getattr(v, "__self__", None)
    if self_obj is not None and not isinstance(self_obj, types.ModuleType):
        # a BOUND builtin method: its __self__ is live state
        return None
    return f"{path}=bfn:{ident}"


def _code_objects(code):
    """``code`` plus every nested code object reachable through its
    co_consts, in definition order."""
    yield code
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            yield from _code_objects(c)


@functools.lru_cache(maxsize=512)
def _code_fingerprint(code) -> bytes:
    """Structural digest of ``code`` and its nested code objects:
    bytecode + consts + NAMES (two bodies can differ only in the
    attribute they load)."""
    h = hashlib.sha1()
    for c in _code_objects(code):
        h.update(c.co_code)
        h.update(repr(c.co_consts).encode())
        h.update(repr(c.co_names).encode())
    return h.digest()


@functools.lru_cache(maxsize=512)
def _has_imports(code) -> bool:
    """True when ``code`` (or a nested code object) executes an
    ``import`` statement: reads through the imported local are invisible
    to the fold, so the entry must token."""
    return any(
        ins.opname in ("IMPORT_NAME", "IMPORT_FROM")
        for c in _code_objects(code)
        for ins in dis.get_instructions(c)
    )


@functools.lru_cache(maxsize=512)
def _global_reads(code) -> tuple:
    """((name, (attr, ...)), ...): every LOAD_GLOBAL in ``code`` and its
    nested code objects with the maximal trailing attribute chain."""
    reads = []
    for c in _code_objects(code):
        instrs = [i for i in dis.get_instructions(c) if i.opname != "CACHE"]
        for idx, ins in enumerate(instrs):
            if ins.opname != "LOAD_GLOBAL":
                continue
            attrs = []
            j = idx + 1
            while j < len(instrs) and instrs[j].opname in _ATTR_OPS:
                attrs.append(instrs[j].argval)
                j += 1
            reads.append((ins.argval, tuple(attrs)))
    return tuple(reads)


def _fold_globals(fn, _seen: frozenset = frozenset()) -> Optional[tuple]:
    """('name=repr', ...) for the module-global reads in ``fn``'s
    bytecode (nested code objects included) with their CURRENT values;
    None when any read resolves to a live value. An attribute read
    through a module/class global dereferences at key time; a folded
    helper function recursively folds its own global reads and
    defaults."""
    if fn.__code__ in _seen:
        return ()  # recursion cycle: already folded higher up
    _seen = _seen | {fn.__code__}
    g = fn.__globals__
    if _has_imports(fn.__code__):
        return None
    folded = []
    for name, attrs in _global_reads(fn.__code__):
        if name not in g:
            if name in _DYNAMIC_LOOKUPS:
                return None
            continue  # builtins resolve at call time; structure
        v = g[name]
        path = name
        k = 0
        while isinstance(v, _STRUCTURE_GLOBALS):
            if k < len(attrs):
                v = getattr(v, attrs[k], _MISSING)
                path += f".{attrs[k]}"
                k += 1
            else:
                r = _structure_repr(path, v)
                if r is None:
                    return None
                folded.append(r)
                if isinstance(v, types.FunctionType):
                    sub = _fold_function_state(path, v, _seen)
                    if sub is None:
                        return None
                    folded.extend(sub)
                break  # bare structural use: called / passed along
        else:
            if v is _MISSING:
                return None  # unresolvable read — degrade to a token
            r = _foldable_const(v)
            if r is None:
                return None
            folded.append(f"{path}={r}")
    return tuple(folded)


def _fold_function_state(path: str, v, seen: frozenset):
    """The state a folded helper function reads, prefixed by its access
    path; None (token) when the helper closes over cells or reads
    anything the fold cannot see. Functions of the trusted numeric
    packages stop the recursion."""
    root = (getattr(v, "__module__", "") or "").split(".")[0]
    if root in _TRUSTED_CLASS_ROOTS:
        return ()
    if v.__closure__:
        return None  # closure cells hold live state
    sub = _fold_globals(v, seen)
    if sub is None:
        return None
    d = _fold_defaults(v)
    if d is None:
        return None
    return tuple(f"{path}::{e}" for e in sub + d)


def _fold_defaults(fn) -> Optional[tuple]:
    """('default<i>=repr', ...) for the entry's default arguments;
    None when any is not foldable. Resolved at key time."""
    out = []
    for i, v in enumerate(getattr(fn, "__defaults__", None) or ()):
        r = _foldable_const(v)
        if r is None:
            return None
        out.append(f"default{i}={r}")
    for k, v in (getattr(fn, "__kwdefaults__", None) or {}).items():
        r = _foldable_const(v)
        if r is None:
            return None
        out.append(f"kwdefault:{k}={r}")
    return tuple(out)


# step kinds whose plan identity rides a compiled-artifact fingerprint
# param instead of the raw source string
_FINGERPRINT_KEYED = frozenset({"rlike", "regexp_extract", "get_json"})
_RAW_SOURCE_PARAMS = ("pattern", "path")
# step kinds whose program depends on the string-scan strategy knobs
_SCAN_KEYED = frozenset({"rlike", "regexp_extract", "from_json"})


@dataclasses.dataclass(frozen=True)
class _Step:
    kind: str
    params: tuple  # static, hashable (sorted (k, v) pairs)
    fn: Optional[Callable] = None  # filter predicate / map body
    fn_token: Optional[int] = None  # monotonic id for closure fns

    # sprtcheck: plan-key-fold — the scan-strategy knob family keys here
    def signature(self) -> str:
        params = self.params
        if self.kind in _FINGERPRINT_KEYED:
            # regex/json entries key on the compiled-artifact
            # fingerprint, not the raw source string
            params = tuple(kv for kv in params if kv[0] not in _RAW_SOURCE_PARAMS)
        if self.kind in _SCAN_KEYED:
            from ..ops._strategy import monoid_max_states, scan_batching, scan_strategy

            params = params + ((
                "scan",
                f"{scan_strategy()}:{monoid_max_states()}:{int(scan_batching())}",
            ),)
        sig = f"{self.kind}{params}"
        if self.fn is not None:
            code = getattr(self.fn, "__code__", None)
            name = (
                f"{getattr(self.fn, '__module__', '?')}."
                f"{getattr(self.fn, '__qualname__', '?')}"
            )
            consts = _fold_globals(self.fn) if self.fn_token is None else None
            if consts is not None:
                d = _fold_defaults(self.fn)
                consts = None if d is None else consts + d
            if consts is None and self.fn_token is None:
                # a read global holds a live value AT KEY TIME: degrade
                # this step to a one-shot token, memoized so the same
                # Pipeline object still reuses its plan across chunks
                object.__setattr__(self, "fn_token", next(_fn_tokens))
            if self.fn_token is None:
                # value-free callables identify STRUCTURALLY (module +
                # qualname + bytecode + consts + folded globals), folded
                # at plan-key time, inside the run that builds
                body = hashlib.sha1(
                    _code_fingerprint(code) + ";".join(consts).encode()
                ).hexdigest()[:16]
                sig += f"<{name}:{body}>"
            else:
                # closures capture live values: a MONOTONIC token keeps
                # two different closures from sharing a plan
                sig += f"<{name}:t{self.fn_token}>"
        return sig


def _sig_hash(sig: str) -> str:
    """The journal/plan hash form of a chain signature."""
    return hashlib.sha1(sig.encode()).hexdigest()[:12]


def _p(**kw) -> tuple:
    return tuple(sorted(kw.items()))


def _check_out(out):
    """Column-placement arg of the cast/json stages, checked at BUILD
    time."""
    if out not in (None, "append"):
        raise ValueError(f"out={out!r}: expected None (replace in place) or 'append'")
    return out


def pad_string_payloads(table, caps: Dict[int, int]):
    """Zero-pad each string column's payload buffer to a static
    ``num_rows * caps[col]`` bytes (offsets untouched; Arrow permits
    oversized buffers) so every same-row-count chunk presents IDENTICAL
    shapes to the plan cache. Raises if a chunk's real payload exceeds
    its cap — silent truncation is never an option."""
    from ..columnar.column import Column
    from ..columnar.table import Table

    cols = list(table.columns)
    n = table.num_rows
    for ci, cap in caps.items():
        c = cols[ci]
        if not c.is_varlen:
            raise TypeError(f"column {ci} is not varlen ({c.dtype})")
        want = n * int(cap)
        have = int(c.data.shape[0])
        if have > want:
            raise ValueError(
                f"column {ci} payload is {have} B, above the static "
                f"cap {want} B ({cap} B/row) — raise caps[{ci}]"
            )
        if have < want:
            data = torch.cat([c.data, torch.zeros(want - have, dtype=c.data.dtype,
                                                  device=c.data.device)])
            cols[ci] = Column(c.dtype, data, c.validity, c.offsets)
    return Table(cols, table.names)


# ---------------------------------------------------------------------
# the two program forms


class _EagerProgram:
    """The padded chain dispatched op by op, sync-free
    (``ops/_strategy.fusing``)."""

    form = "eager"

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, chunk, sides):
        from ..ops._strategy import fusing

        with fusing():
            return self._fn(chunk, sides)


def _graph_pool(dev) -> list:
    """[memory pool, stream, lock, live graphs] shared by the device's
    graphs; a pool with no live graph is replaced by a fresh one."""
    with _plan_lock:
        got = _graph_pools.get(str(dev))
        if got is None:
            got = _graph_pools[str(dev)] = [
                torch.cuda.graph_pool_handle(), torch.cuda.Stream(device=dev),
                threading.Lock(), weakref.WeakSet(),
            ]
        elif not got[3]:
            got[0] = torch.cuda.graph_pool_handle()
        return got


class _GraphProgram:
    """The padded chain captured once as a CUDA graph over static input
    buffers — the chunk's tensors and the join build tables' both. A
    call copies the chunk and the build tables in, replays, and clones
    the outputs out: the plan-cache key holds only their shapes, so a
    second pipeline with same-shaped build tables replays this graph
    over its own tables. Every graph of a device captures into one
    shared pool and replays on one stream, under one lock held from the
    copy-in to the clone, so concurrent callers take turns; the caller's
    stream waits for the replay. The capture runs after one warm-up run
    on that stream, which uploads every lookup table the chain reads; a
    stage that syncs the host or moves data from pageable memory cannot
    be captured and raises PipelineError naming it."""

    form = "graph"

    def __init__(self, fn, where: dict, labels: List[str], chunk, sides):
        from ..ops._strategy import fusing

        leaves, self._in_spec = _flatten((chunk, sides))
        dev = leaves[0].device
        pool, self._stream, self._lock, graphs = _graph_pool(dev)
        caller = torch.cuda.current_stream(dev)
        with self._lock:
            self._stream.wait_stream(caller)
            # the static buffers belong to the replay stream, the only
            # stream that reads or writes them
            with torch.cuda.stream(self._stream), fusing():
                self._static_in = [t.clone() for t in leaves]
                static_chunk, static_sides = _unflatten(self._in_spec, self._static_in)
                fn(static_chunk, static_sides)  # warm-up: tables, allocator pools
            # capture through the low-level calls: the torch.cuda.graph
            # context would first empty the allocator's cache (seconds
            # when tens of GB are cached) and collect garbage
            self._graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(self._stream), fusing():
                    self._graph.capture_begin(pool, capture_error_mode="thread_local")
                    try:
                        out = fn(static_chunk, static_sides)
                    finally:
                        self._graph.capture_end()
            except Exception as e:
                i = where.get("stage")
                label = labels[i] if i is not None and i < len(labels) else "?"
                raise PipelineError(
                    f"stage {label} cannot run inside a CUDA graph: it syncs the "
                    f"host or copies from pageable memory ({type(e).__name__}: {e})"
                ) from e
            with _plan_lock:
                graphs.add(self)
            caller.wait_stream(self._stream)
        self._out, self._out_spec = _flatten(out)

    def __call__(self, chunk, sides):
        leaves, _ = _flatten((chunk, sides))
        caller = torch.cuda.current_stream(self._static_in[0].device)
        with self._lock:
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                for dst, src in zip(self._static_in, leaves):
                    dst.copy_(src, non_blocking=True)
                self._graph.replay()
            caller.wait_stream(self._stream)
            outs = [t.clone() for t in self._out]
            # the next replay, from any thread, waits for these clones
            self._stream.wait_stream(caller)
        return _unflatten(self._out_spec, outs)


class _Pending:
    """The chunk's one device -> host transfer, started at dispatch: the
    tail vector copied into page-locked memory behind an event (on the
    CPU, the vector itself)."""

    __slots__ = ("host", "event")

    def __init__(self, tail: torch.Tensor):
        if tail.device.type == "cuda":
            self.host = torch.empty(tail.shape, dtype=tail.dtype, pin_memory=True)
            self.host.copy_(tail, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = tail, None

    def values(self) -> List[int]:
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


def _tail_vector(st: "_State", dev) -> "tuple[torch.Tensor, tuple]":
    """The chain's last computation: every count the host needs as one
    int64 vector, and its layout (count keys, stat keys, and for the
    collect: whether a live mask exists, the varlen columns' live
    bytes, the masked columns' null counts)."""
    from ..parallel.distributed import live_tail

    ckeys, skeys = tuple(st.counts), tuple(st.stats)
    parts = [st.counts[k].reshape(1).to(torch.int64) for k in ckeys]
    parts += [st.stats[k].reshape(1).to(torch.int64) for k in skeys]
    n_masked = 0
    if st.nested is None and st.live is not None:
        parts.append(live_tail(st.table, st.live))
    elif st.nested is None:
        # no live mask: the collect drops all-valid masks and cuts each
        # capacity-sized payload to its real bytes (the null counts and
        # the payload ends ride along)
        for c in st.table.columns:
            if getattr(c, "validity", None) is not None:
                parts.append((~c.validity).sum().reshape(1).to(torch.int64))
                n_masked += 1
        for c in st.table.columns:
            if getattr(c, "is_varlen", False):
                parts.append(c.offsets[-1:].to(torch.int64))
    tail = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64, device=dev)
    return tail, (ckeys, skeys, n_masked)


class Pipeline:
    """Lazy fused op chain — build once, ``run()`` per chunk.

    Stage methods return ``self`` for chaining; ``run(table)`` executes
    (see module docstring). Stages index columns of the CURRENT working
    table (casts replace in place by default; decimal arithmetic
    appends its {overflow, result} pair like DecimalUtils)."""

    def __init__(self, name: str = "pipeline"):
        self.name = name
        self._steps: List[_Step] = []
        self._sides: List[Any] = []  # join build tables, run() inputs

    # -- builders ------------------------------------------------------

    def _add(self, kind: str, params: tuple, fn=None) -> "Pipeline":
        token = None
        if fn is not None:
            # closure freevars and bound-method receivers are fixed
            # properties of the function object: they force a
            # process-unique token here; globals and defaults are
            # classified later, at plan-key time (_Step.signature)
            code = getattr(fn, "__code__", None)
            if (
                code is None
                or getattr(fn, "__self__", None) is not None  # bound method
                or code.co_freevars
            ):
                token = next(_fn_tokens)
        self._steps.append(_Step(kind, params, fn, token))
        return self

    def filter(self, predicate: Callable) -> "Pipeline":
        """WHERE stage: ``predicate(table) -> bool [n]`` (tensor or
        BOOL8 Column; null predicate rows drop, Spark semantics). Under
        fusion this becomes a live-row mask, compacted at collect."""
        return self._add("filter", _p(), predicate)

    def map(self, fn: Callable, name: str = "map") -> "Pipeline":
        """Generic guard stage: ``fn(table) -> Table`` with no host
        syncs. The live mask passes through untouched."""
        return self._add("map", _p(name=name), fn)

    def select(self, columns: Sequence[int]) -> "Pipeline":
        """Project/reorder columns of the working table."""
        return self._add("select", _p(columns=tuple(int(c) for c in columns)))

    def cast_to_integer(
        self, col: int, dtype, strip: bool = True, width: int = 32,
        out: Optional[str] = None,
    ) -> "Pipeline":
        """CastStrings.toInteger on column ``col`` (non-ANSI). ``width``
        statically pins the char-matrix bytes; longer live strings count
        as overflow and re-plan the width under a resource scope."""
        return self._add(
            "cast_int",
            _p(col=int(col), dtype=dtype, strip=bool(strip), width=int(width),
               out=_check_out(out)),
        )

    def cast_to_decimal(
        self, col: int, precision: int, scale: int, strip: bool = True,
        width: int = 32, out: Optional[str] = None,
    ) -> "Pipeline":
        return self._add(
            "cast_decimal",
            _p(col=int(col), precision=int(precision), scale=int(scale),
               strip=bool(strip), width=int(width), out=_check_out(out)),
        )

    def cast_to_float(
        self, col: int, dtype, width: int = 32, out: Optional[str] = None
    ) -> "Pipeline":
        return self._add(
            "cast_float", _p(col=int(col), dtype=dtype, width=int(width), out=_check_out(out))
        )

    def get_json_object(
        self, col: int, path: str, width: int = 64, out: Optional[str] = None,
    ) -> "Pipeline":
        """JSONPath extraction with a statically pinned char width. Plan
        identity keys on the PARSED step tuple, not the raw path."""
        from ..ops.get_json_object import parse_path

        return self._add(
            "get_json", _p(col=int(col), path=str(path), steps=parse_path(path),
                           width=int(width), out=_check_out(out))
        )

    def from_json(
        self, col: int, width: int = 32, key_width: int = 8,
        value_width: int = 16, max_pairs: int = 4,
    ) -> "Pipeline":
        """MapUtils.extractRawMapFromJsonString as a TERMINAL stage: the
        analysis and the bounded pair gather run in the chain
        (``ops/map_utils.from_json_traced``), the exact string pack at
        collect (``assemble_from_json``); ``run``/``stream`` return the
        List<Struct<String,String>> result. ``width`` / ``key_width`` /
        ``value_width`` / ``max_pairs`` are re-plannable. Must be the
        last stage; cannot follow a filter/join."""
        if int(key_width) > int(width) or int(value_width) > int(width):
            raise ValueError(
                f"from_json key_width={key_width}/value_width="
                f"{value_width} exceed width={width}: key/value spans "
                "are substrings of the document, so widths above the "
                "input char width cannot match anything"
            )
        return self._add(
            "from_json",
            _p(col=int(col), width=int(width), kwidth=int(key_width),
               vwidth=int(value_width), maxp=int(max_pairs)),
        )

    def rlike(
        self, col: int, pattern: str, width: int = 32, out: Optional[str] = None,
    ) -> "Pipeline":
        """Regex.rlike on string column ``col`` -> BOOL8. The plan key
        carries the compiled DFA fingerprint; ``width`` pins the
        char-matrix bytes."""
        from ..ops.regex import pattern_fingerprint

        return self._add(
            "rlike",
            _p(col=int(col), pattern=str(pattern), dfa=pattern_fingerprint(pattern),
               width=int(width), out=_check_out(out)),
        )

    def regexp_extract(
        self, col: int, pattern: str, idx: int = 1, width: int = 32,
        out: Optional[str] = None,
    ) -> "Pipeline":
        """Regex.regexpExtract on string column ``col`` -> STRING (group
        ``idx``); same keying and pinned-width contract as ``rlike``."""
        from ..ops.regex import extraction_fingerprint

        return self._add(
            "regexp_extract",
            _p(col=int(col), pattern=str(pattern), idx=int(idx),
               dfa=extraction_fingerprint(pattern), width=int(width), out=_check_out(out)),
        )

    def multiply128(self, a: int, b: int, product_scale: int) -> "Pipeline":
        """DecimalUtils.multiply128(cols a, b) — appends the {overflow
        BOOL8, result DECIMAL128} pair to the working table."""
        return self._add("dec_mul", _p(a=int(a), b=int(b), scale=int(product_scale)))

    def add128(self, a: int, b: int, target_scale: int) -> "Pipeline":
        return self._add("dec_add", _p(a=int(a), b=int(b), scale=int(target_scale)))

    def subtract128(self, a: int, b: int, target_scale: int) -> "Pipeline":
        return self._add("dec_sub", _p(a=int(a), b=int(b), scale=int(target_scale)))

    def join(
        self,
        right,
        left_on: Sequence[int],
        right_on: Sequence[int],
        how: str = "inner",
        capacity: Optional[int] = None,
        left_string_widths: Optional[dict] = None,
        right_string_widths: Optional[dict] = None,
        broadcast: Optional[bool] = None,
    ) -> "Pipeline":
        """Bounded equi-join against a build-side Table bound at plan
        time. The working table becomes the padded join output; its
        occupancy mask becomes the chain's live mask. ``capacity``
        (output rows, default left rows) re-plans on overflow under a
        task scope. Varlen columns on either side need pinned widths
        (col index -> bytes). ``broadcast`` only matters to a sharded
        stream: True replicates the build side to every shard, False
        co-partitions both sides through the hash exchange, None picks
        broadcast when the build side fits ``broadcast_budget()``."""

        def _w(d):
            return None if not d else tuple(sorted((int(k), int(v)) for k, v in d.items()))

        side_idx = len(self._sides)
        self._sides.append(right)
        return self._add(
            "join",
            _p(side=side_idx, left_on=tuple(int(c) for c in left_on),
               right_on=tuple(int(c) for c in right_on), how=str(how),
               capacity=None if capacity is None else int(capacity),
               left_string_widths=_w(left_string_widths),
               right_string_widths=_w(right_string_widths),
               broadcast=None if broadcast is None else bool(broadcast)),
        )

    def group_by(
        self,
        keys: Sequence[int],
        aggs,
        capacity: Optional[int] = None,
        string_widths: Optional[dict] = None,
        wire_widths: Optional[dict] = None,
    ) -> "Pipeline":
        """GROUP BY (ops/aggregate.py group_by_padded). ``capacity``
        bounds the group count statically (default: the chunk's row
        count — never overflows); ``string_widths`` pins varlen key /
        min-max value widths (col index -> bytes). Dead (filtered) rows
        collapse into one discarded liveness group. ``wire_widths``
        (col index -> bits) only matters to a sharded stream: it pins
        integer key columns to a narrow dtype on the phase-2 exchange (a
        value that does not round-trip re-plans the pins away)."""
        return self._add(
            "group_by",
            _p(keys=tuple(int(k) for k in keys),
               aggs=tuple(aggs),
               capacity=None if capacity is None else int(capacity),
               string_widths=None if not string_widths else tuple(
                   sorted((int(k), int(v)) for k, v in string_widths.items())
               ),
               wire_widths=None if not wire_widths else tuple(
                   sorted((int(k), int(v)) for k, v in wire_widths.items())
               )),
        )

    def to_rows(self) -> "Pipeline":
        """RowConversion.convertToRows terminal (fixed-width schemas;
        single batch). Requires no preceding filter/join."""
        return self._add("to_rows", _p())

    # -- signature / static plan --------------------------------------

    # sprtcheck: plan-key-fold — the admission-mode and analyze knobs
    # key here
    def signature(self) -> str:
        # the capacity-feedback and ANALYZE knobs fold in AT KEY TIME:
        # flipping one between runs re-plans
        sig = "|".join(s.signature() for s in self._steps)
        return f"cfb:{int(capacity_feedback())}|an:{int(analyze_mode())}|{sig}"

    def signature_hash(self) -> str:
        return _sig_hash(self.signature())

    def explain(self, fmt: str = "text", *, shard=None):
        """EXPLAIN: the structured description of this chain's plan —
        ordered stages with their static params, the plan points a chunk
        would start from (data-dependent capacity defaults shown
        symbolically), the capacity-feedback state recorded for this
        chain, and every live plan-cache entry this signature owns (each
        row names its program's form: ``graph`` on a card, ``eager`` on
        the CPU). ``fmt="json"`` returns the document;
        ``fmt="text"`` renders it."""
        if fmt not in ("text", "json"):
            raise ValueError(f"explain fmt={fmt!r}: expected 'text' or 'json'")
        spec = self._resolve_shard(shard)
        bchoices = self._bcast_choices(spec)
        sig_str = self.signature()
        sig = _sig_hash(sig_str)
        fb_sig = _sig_hash(sig_str + self._shard_suffix(spec, bchoices))
        fb_snap = _feedback_for(fb_sig)
        with _plan_lock:
            fb = _plan_feedback.get(fb_sig)
            feedback = None if fb is None else _feedback_row(fb)
        plan = self._initial_plan(1, None, shard_n=1 if spec is None else spec.n_dev,
                                  bcast=bchoices)
        for i, s in enumerate(self._steps):
            if s.kind in ("join", "group_by") and dict(s.params).get("capacity") is None:
                plan[f"{i}.capacity"] = (
                    "chunk_rows" if spec is None else f"chunk_rows/{spec.n_dev}")
        if fb_snap:
            for k, rec in fb_snap.items():
                if k in plan:
                    plan[k] = rec["bucket"]
        doc = {
            "pipeline": self.name,
            "signature": sig,
            "analyze": analyze_mode(),
            "capacity_feedback": capacity_feedback(),
            "stages": [
                {"index": i, "kind": s.kind, "params": {k: _json_safe(v) for k, v in s.params}}
                for i, s in enumerate(self._steps)
            ],
            "plan": {k: _json_safe(v) for k, v in plan.items()},
            "shard": None if spec is None else {
                "axis": spec.axis,
                "devices": spec.n_dev,
                "broadcast": {str(i): ("broadcast" if v else "co-partition")
                              for i, v in sorted(bchoices.items())},
            },
            "feedback": feedback,
            "plans": [r for r in plan_cache_table() if r["sig"] == sig],
        }
        return doc if fmt == "json" else render_explain(doc)

    def _initial_plan(self, n_rows: int, feedback: Optional[dict] = None, shard_n: int = 1,
                      bcast: Optional[dict] = None) -> dict:
        """Static knobs per step index (the re-plannable sizes).
        ``feedback`` (the per-knob observation snapshot of this chain's
        signature) replaces each default with the observed geometric
        bucket: tightened when the bucket is below the default, WIDENED
        past it only when the raw observation exceeded the default.
        ``shard_n`` (a sharded stream's mesh size) makes the group_by and
        join capacity defaults the per-shard share; ``bcast`` (the
        resolved {join stage: 0|1} placements) rides the plan as a static
        ``{i}.bcast`` knob that is never re-planned, and the group_by
        wire pins become the droppable ``{i}.wire`` knob."""
        per_dev = max(-(-max(n_rows, 1) // max(shard_n, 1)), 1)
        default_cap = per_dev if shard_n > 1 else max(n_rows, 1)
        plan: dict = {}
        for i, s in enumerate(self._steps):
            kw = dict(s.params)
            if s.kind in ("cast_int", "cast_decimal", "cast_float", "get_json", "rlike",
                          "regexp_extract"):
                plan[f"{i}.width"] = int(kw["width"])
            elif s.kind == "from_json":
                plan[f"{i}.width"] = int(kw["width"])
                plan[f"{i}.kwidth"] = int(kw["kwidth"])
                plan[f"{i}.vwidth"] = int(kw["vwidth"])
                plan[f"{i}.maxp"] = int(kw["maxp"])
            elif s.kind == "join":
                cap = kw["capacity"]
                plan[f"{i}.capacity"] = int(cap if cap is not None else default_cap)
                for ci, w in (kw["left_string_widths"] or ()):
                    plan[f"{i}.lwidth.{ci}"] = int(w)
                for ci, w in (kw["right_string_widths"] or ()):
                    plan[f"{i}.rwidth.{ci}"] = int(w)
                if shard_n > 1:
                    plan[f"{i}.bcast"] = int((bcast or {}).get(i, 0))
            elif s.kind == "group_by":
                cap = kw["capacity"]
                plan[f"{i}.capacity"] = int(cap if cap is not None else default_cap)
                for ci, w in (kw["string_widths"] or ()):
                    plan[f"{i}.width.{ci}"] = int(w)
                if shard_n > 1:
                    plan[f"{i}.wire"] = kw["wire_widths"]
        if feedback:
            for k, default in plan.items():
                rec = feedback.get(k)
                if rec is None:
                    continue
                if k.endswith(".wire"):
                    if rec["bucket"] is None:
                        # a re-plan dropped these pins: they stay dropped
                        plan[k] = None
                    continue
                if rec["observed"] > default:
                    plan[k] = rec["bucket"]  # widen: default would overflow
                else:
                    plan[k] = min(rec["bucket"], default)  # tighten
        return plan

    # -- the chain -----------------------------------------------------

    def _apply_per_shard(self, i: int, step: _Step, st: _State, plan: dict) -> _State:
        """A row-local stage of a sharded chain: the stage on every shard,
        its counts and stats folded by max over the shards (each is a
        max over rows, so the fold equals the stage over the whole
        chunk)."""
        from ..parallel.mesh import ShardedTable

        mesh = st.table.mesh
        first = mesh.devices[0]
        tables, lives, counts, stats = [], [], {}, {}
        for s, part in enumerate(st.table.shards):
            sub = _State(part, None if st.live is None else st.live[s], st.sides, {}, {})
            sub = self._apply_step(i, step, sub, plan)
            tables.append(sub.table)
            lives.append(sub.live)
            for src, dst in ((sub.counts, counts), (sub.stats, stats)):
                for k, v in src.items():
                    dst.setdefault(k, []).append(v.to(first))
        for k, vs in counts.items():
            m = torch.stack(vs).max(0).values
            st.counts[k] = st.counts[k] + m if k in st.counts else m
        for k, vs in stats.items():
            m = torch.stack(vs).max(0).values
            st.stats[k] = torch.maximum(st.stats[k], m) if k in st.stats else m
        if any(v is not None for v in lives):
            lives = [torch.ones(t.num_rows, dtype=torch.bool, device=d) if v is None else v
                     for v, t, d in zip(lives, tables, mesh.devices)]
        else:
            lives = None
        st.table, st.live = ShardedTable(tables, mesh), lives
        return st

    def _apply_step(self, i: int, step: _Step, st: _State, plan: dict,
                    shard: Optional[_ShardSpec] = None):
        from ..columnar.column import Column
        from ..columnar.dtypes import INT64
        from ..columnar.table import Table
        from ..parallel.mesh import ShardedTable

        kw = dict(step.params)
        kind = step.kind
        if st.nested is not None:
            raise PipelineError("from_json is a terminal stage: no stage may follow it")
        sharded = shard is not None and isinstance(st.table, ShardedTable)
        if sharded and kind not in ("join", "group_by"):
            return self._apply_per_shard(i, step, st, plan)

        def place(col_obj, src: int):
            cols = list(st.table.columns)
            names = st.table.names
            if kw.get("out") == "append":
                cols.append(col_obj)
                names = None  # appended column has no name to give
            else:
                cols[src] = col_obj  # in-place: schema names survive
            st.table = Table(cols, names)

        def live_max_len(cols, lives):
            """int32 max live byte length over column parts (None when
            every part is empty)."""
            maxes = []
            for c, live in zip(cols, lives):
                if len(c) == 0:
                    continue
                lens = c.string_lengths()
                if live is not None:
                    lens = torch.where(live, lens, 0)
                maxes.append(lens.max().to(torch.int32).to(cols[0].device))
            return torch.stack(maxes).max() if maxes else None

        def parts_of(tbl, live, ci):
            if isinstance(tbl, ShardedTable):
                lives = live if live is not None else [None] * len(tbl.shards)
                return [p.columns[ci] for p in tbl.shards], lives
            return [tbl.columns[ci]], [live]

        def note_width_overflow(col, width: int, key: str = None, parts=None):
            cols, lives = parts if parts is not None else ([col], [st.live])
            mx = live_max_len(cols, lives)
            if mx is None:
                return
            over = torch.clamp(mx - width, min=0)
            key = key or f"{i}.width"
            st.counts[key] = st.counts[key] + over if key in st.counts else over
            # the same reduction feeds the capacity-feedback planner
            st.stats[key] = torch.maximum(st.stats[key], mx) if key in st.stats else mx

        if kind == "filter":
            pred = step.fn(st.table)
            if isinstance(pred, Column):  # BOOL8 Column; nulls drop
                mask = pred.data.to(torch.bool)
                if pred.validity is not None:
                    mask = mask & pred.validity
            else:
                mask = pred.to(torch.bool)
            st.live = mask if st.live is None else (st.live & mask)
        elif kind == "map":
            st.table = step.fn(st.table)
        elif kind == "select":
            names = st.table.names
            st.table = Table(
                [st.table.columns[c] for c in kw["columns"]],
                None if names is None else tuple(names[c] for c in kw["columns"]),
            )
        elif kind in ("cast_int", "cast_decimal", "cast_float"):
            from ..ops import cast_string as _cs

            src = st.table.columns[kw["col"]]
            width = plan[f"{i}.width"]
            note_width_overflow(src, width)
            if kind == "cast_int":
                out = _cs.string_to_integer(src, kw["dtype"], False, kw["strip"], width=width)
            elif kind == "cast_decimal":
                out = _cs.string_to_decimal(
                    src, kw["precision"], kw["scale"], False, kw["strip"], width=width
                )
            else:
                out = _cs.string_to_float(src, kw["dtype"], False, width=width)
            place(out, kw["col"])
        elif kind == "get_json":
            from ..ops import get_json_object as _gjo

            src = st.table.columns[kw["col"]]
            width = plan[f"{i}.width"]
            note_width_overflow(src, width)
            place(_gjo.get_json_object(src, kw["path"], width=width, out_width=width), kw["col"])
        elif kind == "from_json":
            from ..columnar import strings as _strs
            from ..ops import map_utils as _mu
            from ..ops._strategy import scan_strategy as _scan_strategy

            if st.live is not None:
                raise PipelineError(
                    "from_json cannot follow a filter/join stage: the "
                    "nested result carries no occupancy sidecar"
                )
            src = st.table.columns[kw["col"]]
            width = plan[f"{i}.width"]
            note_width_overflow(src, width)
            chars, lengths = _strs.to_char_matrix(src, width)
            pieces, jcounts, jstats = _mu.from_json_traced(
                chars, lengths, src.validity_or_true(),
                plan[f"{i}.kwidth"], plan[f"{i}.vwidth"], plan[f"{i}.maxp"],
                _scan_strategy() != "serial",
            )
            for k, c in jcounts.items():
                st.counts[f"{i}.{k}"] = c
            for k, s_obs in jstats.items():
                st.stats[f"{i}.{k}"] = s_obs
            st.nested = pieces
        elif kind == "rlike":
            from ..ops import regex as _regex

            src = st.table.columns[kw["col"]]
            width = plan[f"{i}.width"]
            note_width_overflow(src, width)
            place(_regex.rlike(src, kw["pattern"], width=width), kw["col"])
        elif kind == "regexp_extract":
            from ..ops import regex as _regex

            src = st.table.columns[kw["col"]]
            width = plan[f"{i}.width"]
            note_width_overflow(src, width)
            place(_regex.regexp_extract(src, kw["pattern"], kw["idx"], width=width), kw["col"])
        elif kind in ("dec_mul", "dec_add", "dec_sub"):
            from ..ops import decimal as _dec

            fn = {"dec_mul": _dec.multiply128, "dec_add": _dec.add128,
                  "dec_sub": _dec.subtract128}[kind]
            pair = fn(st.table.columns[kw["a"]], st.table.columns[kw["b"]], kw["scale"])
            st.table = Table(list(st.table.columns) + list(pair.columns))
        elif kind == "join":
            from ..columnar import strings as _strs
            from ..ops.join import join_padded

            right = st.sides[kw["side"]]
            cap = plan[f"{i}.capacity"]

            def side_widths(tbl2, declared, tag, live_mask):
                # every varlen column's pinned width from the plan or
                # the stage's declaration; the live-masked observed
                # width folds into the chain's counts/stats
                ws = {}
                pinned = dict(declared or ())
                cols0 = tbl2.shards[0].columns if isinstance(tbl2, ShardedTable) else tbl2.columns
                for ci, c in enumerate(cols0):
                    if not c.is_varlen:
                        continue
                    w = plan.get(f"{i}.{tag}.{ci}", pinned.get(ci))
                    if w is None:
                        raise PipelineError(
                            f"join stage {i}: varlen column {ci} of the "
                            f"{'left' if tag == 'lwidth' else 'right'} "
                            "side needs a pinned width "
                            "(left/right_string_widths={col: bytes})"
                        )
                    mx = live_max_len(*parts_of(tbl2, live_mask, ci))
                    if mx is not None:
                        key = f"{i}.{tag}.{ci}"
                        over = torch.clamp(mx - w, min=0)
                        st.counts[key] = st.counts[key] + over if key in st.counts else over
                        st.stats[key] = (
                            torch.maximum(st.stats[key], mx) if key in st.stats else mx
                        )
                    ws[ci] = int(w)
                return ws

            l_w = side_widths(st.table, kw["left_string_widths"], "lwidth", st.live)
            r_w = side_widths(right, kw["right_string_widths"], "rwidth", None)
            if not sharded:
                l_mats = {ci: _strs.to_char_matrix(st.table.columns[ci], w)
                          for ci, w in l_w.items()} or None
                r_mats = {ci: _strs.to_char_matrix(right.columns[ci], w)
                          for ci, w in r_w.items()} or None
                res, occ, needed = join_padded(
                    st.table, right, list(kw["left_on"]), list(kw["right_on"]), cap, kw["how"],
                    left_occupied=st.live, with_stats=True, left_mats=l_mats, right_mats=r_mats,
                )
                need = needed.max().to(torch.int32)
                st.counts[f"{i}.capacity"] = torch.clamp(need - cap, min=0)
                st.stats[f"{i}.capacity"] = need
            else:
                # ``capacity`` is the per-shard output grant; width
                # truncations are already counted per column above (the
                # exchange pins the same widths), so join_output is the
                # one knob-mapped stage. Broadcast replicates the build
                # side; co-partitioned exchanges both sides by key, the
                # build side padded to a mesh multiple (dead rows masked)
                from ..parallel import distributed as _dist

                common = dict(how=kw["how"], axis=shard.axis, left_occupied=st.live,
                              out_capacity=cap, left_string_widths=l_w or None,
                              right_string_widths=r_w or None, overflow_detail=True,
                              with_stats=True)
                if plan.get(f"{i}.bcast"):
                    res, occ, ovf, jstats = _dist.distributed_join_broadcast(
                        st.table, right, list(kw["left_on"]), list(kw["right_on"]), shard.mesh,
                        **common)
                else:
                    right2, r_occ = right, None
                    padr = (-right.num_rows) % shard.n_dev
                    if padr:
                        right2 = _pad_rows_traced(right, padr)
                        r_occ = torch.arange(right.num_rows + padr,
                                             device=_table_device(right)) < right.num_rows
                    res, occ, ovf, jstats = _dist.distributed_join(
                        st.table, right2, list(kw["left_on"]), list(kw["right_on"]), shard.mesh,
                        right_occupied=r_occ, **common)
                st.counts[f"{i}.capacity"] = ovf["join_output"].to(torch.int32)
                st.stats[f"{i}.capacity"] = jstats["out_needed_per_dev"].max().to(torch.int32)
            st.table, st.live = res, occ
        elif kind == "group_by" and sharded:
            # the two-phase distributed aggregate: per-shard partials, a
            # wire-pinned phase-2 exchange, per-shard merge. Capacity
            # shortfalls (phase-1 groups, final merge) re-plan the
            # per-shard grant; string truncations are counted per column
            # here; an integer wire pin that does not round-trip shows
            # only in the exchange stage and re-plans the droppable pins
            from ..parallel import distributed as _dist

            cap = plan[f"{i}.capacity"]
            keys = list(kw["keys"])
            aggs = list(kw["aggs"])
            widths = {}
            for ci in sorted({*keys, *(a.column for a in aggs if a.column is not None)}):
                if st.table.shards[0].columns[ci].is_varlen:
                    w = plan.get(f"{i}.width.{ci}")
                    if w is None:
                        raise PipelineError(
                            f"group_by stage {i}: varlen column {ci} needs "
                            "a pinned width (string_widths={col: bytes})"
                        )
                    note_width_overflow(None, w, key=f"{i}.width.{ci}",
                                        parts=parts_of(st.table, st.live, ci))
                    widths[ci] = int(w)
            res, occ, ovf, gstats = _dist.distributed_group_by(
                st.table, keys, aggs, shard.mesh, axis=shard.axis, capacity=cap,
                occupied=st.live, string_widths=widths or None,
                wire_widths=dict(plan[f"{i}.wire"] or ()) or None, overflow_detail=True,
                with_stats=True,
            )
            st.counts[f"{i}.capacity"] = (ovf["local_groups"] + ovf["final_merge"]).to(torch.int32)
            st.counts[f"{i}.wire"] = ovf["shuffle"].to(torch.int32)
            st.stats[f"{i}.capacity"] = gstats["local_groups_per_dev"].max().to(torch.int32)
            st.table, st.live = res, occ
        elif kind == "group_by":
            from ..columnar import strings as _strs
            from ..ops.aggregate import group_by_padded
            from ..ops.join import _mask_key_columns

            cap = plan[f"{i}.capacity"]
            keys = list(kw["keys"])
            aggs = list(kw["aggs"])
            tbl = st.table
            # pinned-width char matrices for varlen key / value columns
            mats = {}
            for ci in sorted({*keys, *(a.column for a in aggs if a.column is not None)}):
                if tbl.columns[ci].is_varlen:
                    w = plan.get(f"{i}.width.{ci}")
                    if w is None:
                        raise PipelineError(
                            f"group_by stage {i}: varlen column {ci} needs "
                            "a pinned width (string_widths={col: bytes})"
                        )
                    note_width_overflow(tbl.columns[ci], w, key=f"{i}.width.{ci}")
                    mats[ci] = _strs.to_char_matrix(tbl.columns[ci], w)
            if st.live is None:
                res, occ, ng = group_by_padded(
                    tbl, tuple(keys), tuple(aggs), cap, key_mats=mats or None, pad_payload=True,
                )
                granted = cap
            else:
                # dead rows: null the real keys and lead with a liveness
                # key so they form one synthetic group that can never
                # merge with genuine null-key groups; it takes one slot
                masked = _mask_key_columns(tbl, keys, st.live)
                live_col = Column(INT64, st.live.to(torch.int64))
                tbl2 = Table([live_col] + list(masked.columns))
                keys2 = [0] + [k + 1 for k in keys]
                aggs2 = [
                    dataclasses.replace(a, column=None if a.column is None else a.column + 1)
                    for a in aggs
                ]
                mats2 = {ci + 1: m for ci, m in mats.items()}
                granted = cap + 1
                res, occ, ng = group_by_padded(
                    tbl2, tuple(keys2), tuple(aggs2), granted, key_mats=mats2 or None,
                    pad_payload=True,
                )
                occ = occ & (res.columns[0].data == 1)
                res = Table(list(res.columns[1:]))
            st.counts[f"{i}.capacity"] = torch.clamp(ng - granted, min=0).to(torch.int32)
            # observed need in plan-knob units: the synthetic dead-rows
            # slot is occupied only when the chunk had dead rows
            if granted != cap:
                synth = (~st.live).any().to(torch.int32)
                st.stats[f"{i}.capacity"] = (ng - synth).to(torch.int32)
            else:
                st.stats[f"{i}.capacity"] = ng.to(torch.int32)
            st.table, st.live = res, occ
        elif kind == "to_rows":
            from ..ops.row_conversion import convert_to_rows

            if st.live is not None:
                raise PipelineError(
                    "to_rows cannot follow a filter/join stage: JCUDF "
                    "rows carry no occupancy mask; collect first"
                )
            rows = convert_to_rows(st.table)
            if len(rows) != 1:
                raise PipelineError(
                    "to_rows inside a pipeline supports single-batch fixed-width tables"
                )
            st.table = Table(rows)
        else:  # pragma: no cover
            raise PipelineError(f"unknown stage kind {kind!r}")
        return st

    def _chain_fn(self, plan: dict, shard: Optional[_ShardSpec] = None):
        """(run_chain, where): the whole chain over ``(chunk, sides)``,
        ending in the tail vector; ``where["stage"]`` names the stage
        running (for the capture error). Under ``shard`` the chunk is cut
        into shards first and gathered back before the tail."""
        where: dict = {}

        def run_chain(chunk, sides):
            st = _State(chunk, None, tuple(sides), {})
            if shard is not None:
                st = _shard_prologue(st, shard)
            for i, step in enumerate(self._steps):
                where["stage"] = i
                st = self._apply_step(i, step, st, plan, shard)
            where["stage"] = None
            if shard is not None:
                st = _gather_state(st, shard)
            tail, layout = _tail_vector(st, _table_device(chunk))
            return st.table, st.live, st.nested, tail, layout

        return run_chain, where

    def _stage_fn(self, stage: int, plan: dict, shard: Optional[_ShardSpec] = None):
        """ANALYZE-mode slice: ONE stage over the threaded ``(table,
        live, counts, stats, nested)`` state, returning the new state and
        the stage probe. Under ``shard`` the first slice cuts the chunk
        into shards and the last gathers them after its probe."""
        step = self._steps[stage]
        last = len(self._steps) - 1

        def run_stage(state, sides):
            table, live, counts, stats, nested = state
            st = _State(table, live, tuple(sides), dict(counts), dict(stats), nested)
            if shard is not None and stage == 0:
                st = _shard_prologue(st, shard)
            st = self._apply_step(stage, step, st, plan, shard)
            probe = _stage_probe(st, shard)
            if shard is not None and stage == last:
                st = _gather_state(st, shard)
            return (st.table, st.live, st.counts, st.stats, st.nested), probe

        return run_stage

    def _stage_labels(self) -> "List[str]":
        return [f"{i}:{s.kind}" for i, s in enumerate(self._steps)]

    # -- program cache -------------------------------------------------

    def _get_executable(
        self, chunk, plan: dict, donate: bool, stage: Optional[int] = None,
        sig_str: Optional[str] = None, shard: Optional[_ShardSpec] = None,
    ):
        """Plan-cache lookup / build. ``stage=None`` is the whole-chain
        program over ``(chunk, sides)``; an int is the ANALYZE-mode slice
        of that one stage over ``(state, sides)`` — same cache, same
        counters, with a trailing ``("stage", i)`` key component."""
        sides = tuple(self._sides)
        plan_key = tuple(sorted(plan.items()))
        if sig_str is None:
            sig_str = self.signature()
        dev = _table_device(chunk if stage is None else chunk[0])
        # the card runs the whole chain as a CUDA graph; the CPU, the
        # ANALYZE slices and a chain sharded over several cards run it
        # eagerly (the device and the shard layout are in the key)
        one_card = shard is None or shard.mesh.shared_device == dev
        form = "graph" if (dev.type == "cuda" and stage is None and one_card) else "eager"
        key = (sig_str, plan_key, bool(donate), _avals_key((chunk, sides)),
               None if shard is None else shard.key())
        if stage is not None:
            key = key + (("stage", stage),)
        sig = _sig_hash(sig_str)
        scope = _resource.current_task()
        if scope is not None:
            # the failing task's flight bundle renders every plan it
            # touched (GIL-atomic add; runtime/flight.py)
            scope.plans_touched.add(sig)
        with _plan_lock:
            exe = _plan_cache.get(key)
            if exe is not None:
                # LRU refresh: dict order is the eviction order
                _plan_cache.pop(key)
                _plan_cache[key] = exe
                st = _plan_stats.get(key)
                if st is not None:
                    st["hits"] += 1
        if exe is not None:
            _metrics.counter("pipeline.plan_cache_hit").inc()
            acct = _ctx_cache_account.get()
            if acct is not None:
                acct["hits"] = acct.get("hits", 0) + 1
            _events.emit("plan_cache_hit", op=f"Pipeline.{self.name}", plan=sig)
            return exe
        t0 = time.perf_counter()
        with _spans.span("plan_build", f"Pipeline.{self.name}", plan=sig):
            if stage is not None:
                exe = _EagerProgram(self._stage_fn(stage, plan, shard))
            elif form == "graph":
                fn, where = self._chain_fn(plan, shard)
                exe = _GraphProgram(fn, where, self._stage_labels(), chunk, sides)
            else:
                exe = _EagerProgram(self._chain_fn(plan, shard)[0])
        wall_ms = (time.perf_counter() - t0) * 1000
        _metrics.counter("pipeline.plan_cache_miss").inc()
        acct = _ctx_cache_account.get()
        if acct is not None:
            acct["misses"] = acct.get("misses", 0) + 1
        _metrics.timer("pipeline.plan_build").observe(wall_ms)
        _events.emit("plan_cache_miss", op=f"Pipeline.{self.name}", plan=sig,
                     wall_ms=round(wall_ms, 3))
        evicted_sig: Optional[str] = None
        with _plan_lock:
            graphs = [k for k, v in _plan_cache.items() if v.form == "graph"]
            if len(_plan_cache) >= _PLAN_CACHE_CAP or (
                form == "graph" and len(graphs) >= _GRAPH_CACHE_CAP
            ):
                evicted = graphs[0] if form == "graph" and graphs else next(iter(_plan_cache))
                _plan_cache.pop(evicted)
                est = _plan_stats.pop(evicted, None)
                evicted_sig = est["sig"] if est else _sig_hash(evicted[0])
            _plan_cache[key] = exe
            _plan_stats[key] = {
                "sig": sig,
                "pipeline": self.name,
                "plan": dict(plan_key),
                "donate": bool(donate),
                "form": form,
                "shard": None if shard is None else shard.key(),
                "avals": str(key[3]),
                "hits": 0,
                "build_wall_ms": round(wall_ms, 3),
                # which chain stages this program covers
                "stages": (
                    self._stage_labels() if stage is None
                    else [f"{stage}:{self._steps[stage].kind}"]
                ),
            }
        if evicted_sig is not None:
            _metrics.counter("pipeline.plan_cache_evict").inc()
            _events.emit("plan_cache_evict", op=f"Pipeline.{self.name}", plan=evicted_sig,
                         table="executable")
        return exe

    # -- execution -----------------------------------------------------

    @staticmethod
    def _estimate_basis(table) -> tuple:
        """(num_rows, row_bytes) of a chunk — captured ONCE at dispatch so
        the per-chunk estimate closure holds two ints, not the chunk."""
        return table.num_rows, _resource._table_row_bytes(table, None)

    @staticmethod
    def _estimate_from_basis(n_rows: int, row_b: int, plan: dict) -> int:
        est = n_rows * row_b
        for k, v in plan.items():
            if k.endswith(".capacity"):
                est += int(v) * row_b
        return est

    def _replan(self, plan: dict, counts, exc) -> Optional[dict]:
        new = dict(plan)
        grew = False
        for k, c in (counts or {}).items():
            if not c:
                continue
            cur = plan.get(k)
            if cur is None:
                continue
            if k.endswith(".wire"):
                # a non-round-tripping wire pin cannot be grown usefully:
                # full storage width always round-trips
                new[k], grew = None, True
                continue
            if "width" in k.split(".", 1)[1]:
                from ..columnar.strings import bucket_length

                want = bucket_length(int(cur) + int(c))
            else:
                # the overflow count bounds the true need from above:
                # count-informed jump, geometric floor
                want = max(_resource.GROWTH * int(cur), int(cur) + int(c))
            if want > cur:
                new[k], grew = want, True
        return new if grew else None

    def _check_donate(self, donate: bool) -> None:
        scope = _resource.current_task()
        if donate and scope is not None and scope.retries_enabled:
            raise PipelineError(
                "donate=True cannot run under a retrying resource scope: "
                "a capacity re-plan re-executes the same chunk, whose "
                "buffers the first attempt already donated. Disable "
                "donation, or open the scope with retries_enabled=False"
            )

    def _dispatch_fns(self, table, donate: bool, analyze: bool = False,
                      shard: Optional[_ShardSpec] = None):
        """(dispatch, sync, holder) triple for one chunk — the two phases
        the deferred retry driver splits apart, plus the mailbox.
        ``dispatch`` looks up / builds the program and queues the chunk,
        returning ``(table, live, nested, pending, layout)`` with the
        tail vector's copy in flight; ``sync`` waits for that one copy
        and turns it into host ints. ``holder`` carries the last-synced
        plan, observed stats and collect sizes out of the retry driver.

        ``analyze=True`` swaps in the stage-sliced pair: dispatch queues
        one program per stage back to back (each followed by an event),
        and sync times each stage's completion under a ``stage`` span
        before the one batched transfer, then emits the per-stage
        ``stage_metrics`` events and ``pipeline.stage.*`` metrics."""
        holder: Dict[str, Any] = {"table": table}

        if analyze:
            # sprtcheck: dispatch-path — every slice is looked up/built
            # and ENQUEUED here; the waits and the transfer live in sync
            def dispatch(plan):
                holder["plan"] = dict(plan)
                sig_str = self.signature()
                sides = tuple(self._sides)
                src = holder["table"]
                dev = _table_device(src)
                state = (src, None, {}, {}, None)
                probes, marks = [], []
                for i in range(len(self._steps)):
                    exe = self._get_executable(state, plan, False, stage=i, sig_str=sig_str,
                                               shard=shard)
                    state, probe = exe(state, sides)
                    probes.append(probe)
                    if dev.type == "cuda":
                        ev = torch.cuda.Event()
                        ev.record()
                        marks.append(ev)
                holder["probes"], holder["marks"] = probes, marks
                table2, live, counts, stats, nested = state
                st = _State(table2, live, (), counts, stats, nested)
                tail, layout = _tail_vector(st, dev)
                return table2, live, nested, tail, layout

            def sync(value):
                probes = holder.pop("probes", None) or []
                marks = holder.pop("marks", None) or []
                walls: List[float] = []
                stage_spans: List[Any] = []
                prev = time.perf_counter()
                for i in range(len(probes)):
                    kind = self._steps[i].kind
                    sp = _spans.open_span("stage", f"Pipeline.{self.name}.s{i}.{kind}")
                    if marks:
                        marks[i].synchronize()
                    now = time.perf_counter()
                    walls.append((now - prev) * 1000.0)
                    prev = now
                    _spans.close_span(sp, stage=i, stage_kind=kind)
                    stage_spans.append(sp)
                # the probes ride the chain's ONE transfer with the tail
                dev0 = value[3].device
                values = torch.cat([value[3]] + [p.reshape(-1).to(dev0) for p in probes]).tolist()
                layout = value[4]
                nt = value[3].shape[0]
                hp, at = [], nt
                for p in probes:
                    hp.append(values[at:at + p.numel()])
                    at += p.numel()
                counts = self._unpack(values[:nt], layout, holder)
                self._emit_stage_metrics(hp, walls, stage_spans, holder)
                return counts

            return dispatch, sync, holder

        # sprtcheck: dispatch-path — everything reachable from here
        # (plan lookup, build, enqueue) is sync-free; the ONE host
        # transfer's wait lives in sync() below, which the streaming
        # executor defers
        def dispatch(plan):
            holder["plan"] = dict(plan)
            src = holder["table"]
            exe = self._get_executable(src, plan, donate, shard=shard)
            if donate:
                holder["table"] = None  # the pipeline keeps no reference
            table2, live, nested, tail, layout = exe(src, tuple(self._sides))
            return table2, live, nested, _Pending(tail), layout

        def sync(value):
            return self._unpack(value[3].values(), value[4], holder)

        return dispatch, sync, holder

    @staticmethod
    def _unpack(values: List[int], layout: tuple, holder: dict) -> Dict[str, int]:
        """Split the tail vector's host ints: overflow counts (returned),
        observed stats and the collect's sizes (into ``holder``)."""
        ckeys, skeys, n_masked = layout
        nc, ns = len(ckeys), len(skeys)
        holder["stats"] = dict(zip(skeys, values[nc:nc + ns]))
        holder["collect"] = values[nc + ns:]
        holder["n_masked"] = n_masked
        return dict(zip(ckeys, values[:nc]))

    def _emit_stage_metrics(self, probes, walls, stage_spans, holder) -> None:
        """Publish one analyzed attempt's per-stage observations:
        ``stage_metrics`` journal events (one per stage, stamped with
        that stage's span), the ``pipeline.stage.<kind>.*`` metric
        family, and the per-context stage sink when one is installed."""
        op_name = f"Pipeline.{self.name}"
        chain_wall = sum(walls)
        sink = _ctx_stage_sink.get()
        chunk = holder.get("chunk")
        for i, (p, w) in enumerate(zip(probes, walls)):
            kind = self._steps[i].kind
            rows, nbytes = int(p[0]), int(p[1])
            attrs: Dict[str, Any] = {
                "stage": i,
                "stage_kind": kind,
                "rows": rows,
                "bytes": nbytes,
                "wall_ms": round(w, 3),
                "chain_wall_ms": round(chain_wall, 3),
            }
            if chunk is not None:
                attrs["chunk"] = chunk
            skew = None
            if len(p) > 2:
                # under a sharded stream: per-shard rows, then bytes
                n_dev = (len(p) - 2) // 2
                dev_rows = [int(x) for x in p[2:2 + n_dev]]
                attrs["device_rows"] = dev_rows
                attrs["device_bytes"] = [int(x) for x in p[2 + n_dev:]]
                mean = sum(dev_rows) / len(dev_rows)
                skew = round(max(dev_rows) / mean, 3) if mean > 0 else 0.0
                attrs["skew"] = skew
            _events.emit("stage_metrics", op=op_name, _span=stage_spans[i], **attrs)
            _metrics.counter(f"pipeline.stage.{kind}.rows").inc(rows)
            _metrics.counter(f"pipeline.stage.{kind}.bytes").inc(nbytes)
            _metrics.timer(f"pipeline.stage.{kind}.wall_ms").observe(w)
            if skew is not None:
                _metrics.gauge(f"pipeline.stage.{kind}.device_skew").set(skew)
            if sink is not None:
                row = sink.setdefault(
                    f"{i}:{kind}", {"rows": 0, "bytes": 0, "wall_ms": 0.0, "chunks": 0}
                )
                row["rows"] += rows
                row["bytes"] += nbytes
                row["wall_ms"] = round(row["wall_ms"] + w, 3)
                row["chunks"] += 1

    @staticmethod
    def _collect(out_tbl, live, nested, holder: dict, collect: bool):
        """The retirement tail: assemble a from_json terminal, compact a
        padded result at the sizes the tail vector brought (no further
        sync), or hand back the padded pair."""
        from ..columnar.column import Column
        from ..columnar.table import Table
        from ..parallel.distributed import _gather_live, compact_validity

        if nested is not None:
            if not collect:
                raise PipelineError("collect=False is meaningless after a from_json terminal stage")
            from ..ops.map_utils import assemble_from_json

            return assemble_from_json(nested)
        if not collect:
            return out_tbl, live
        sizes = holder.get("collect") or []
        stats = holder.get("stats") or {}
        per_dev = [stats[k] for k in sorted((k for k in stats if k.startswith("shard.live.")),
                                            key=lambda k: int(k.rsplit(".", 1)[1]))]
        if per_dev:
            # a sharded chunk's retirement: per-device occupancy and
            # key-skew gauges next to its one batched transfer
            from ..parallel.distributed import _publish_device_metrics

            _publish_device_metrics(per_dev, len(per_dev), None)
        with _spans.span("collect_stage", "collect_table"):
            if live is not None:
                return _gather_live(out_tbl, live, sizes[0], sizes[1:])
            n_masked = holder.get("n_masked", 0)
            ends = iter(sizes[n_masked:])
            cols = [
                Column(c.dtype, c.data[:next(ends)], c.validity, c.offsets) if c.is_varlen else c
                for c in out_tbl.columns
            ]
            return compact_validity(Table(cols, out_tbl.names), sizes[:n_masked])

    def run(
        self, table, *, collect: bool = True, donate: bool = False,
        analyze: Optional[bool] = None,
    ):
        """Execute the chain on one chunk. Returns the collected compact
        Table by default; ``collect=False`` returns the padded ``(table,
        live)`` pair (live may be None). ``donate=True`` drops the
        pipeline's references to the chunk after dispatch (torch has no
        buffer donation; incompatible with capacity retries).

        ``analyze=True`` runs the chain ANALYZE-mode: stage-sliced
        execution with per-stage row/byte/wall attribution. ``None``
        defers to the ambient ``analyze_mode()`` knob."""
        if analyze is not None:
            tok = _ctx_analyze.set(bool(analyze))
            try:
                return self.run(table, collect=collect, donate=donate)
            finally:
                _ctx_analyze.reset(tok)
        an = analyze_mode()
        self._check_donate(donate)
        if an and donate:
            raise PipelineError(
                "analyze mode is incompatible with donate=True: the "
                "stage-sliced programs re-read the chunk's buffers "
                "across slices"
            )
        t0 = time.perf_counter()
        rows_in, bytes_in = _metrics._rows_bytes(table)
        fb_on = capacity_feedback()
        sig = self.signature_hash() if fb_on else None
        plan0 = self._initial_plan(table.num_rows, _feedback_for(sig) if fb_on else None)
        op = f"pipeline.{self.name}"
        n_est, row_b = self._estimate_basis(table)
        dispatch, sync, holder = self._dispatch_fns(table, donate, analyze=an)
        del table  # the holder owns the chunk (donate drops it there)

        def attempt(plan):
            value = dispatch(plan)
            return (value[0], value[1], value[2]), sync(value)

        # op span: the run_plan/retry_round/plan_build/collect_stage
        # spans below all chain up to it; record_op's op_end closes it.
        # The op range names the run on NVTX and profiler timelines.
        with _spans.span("op", f"Pipeline.{self.name}", emit_end=False), \
                _trace.op_range(f"Pipeline.{self.name}"):
            try:
                value = _resource.run_plan(
                    op, attempt, self._replan,
                    lambda p: self._estimate_from_basis(n_est, row_b, p), plan0,
                )
                out_tbl, live, nested = value
                if fb_on and holder.get("stats"):
                    _record_feedback(sig, self.name, holder["plan"], holder["stats"])
                out = self._collect(out_tbl, live, nested, holder, collect)
            except Exception as e:
                if _metrics.enabled():
                    _metrics.record_op(
                        f"Pipeline.{self.name}", (time.perf_counter() - t0) * 1000,
                        rows_in=rows_in, bytes_in=bytes_in, ok=False, error=type(e).__name__,
                    )
                raise
            if _metrics.enabled():
                rows_out, bytes_out = _metrics._rows_bytes(out if collect else out_tbl)
                _metrics.record_op(
                    f"Pipeline.{self.name}", (time.perf_counter() - t0) * 1000,
                    rows_in=rows_in, bytes_in=bytes_in, rows_out=rows_out, bytes_out=bytes_out,
                )
        return out

    # -- streaming execution ------------------------------------------

    def _resolve_shard(self, shard) -> Optional[_ShardSpec]:
        """Validate and resolve ``shard``: an ``(axis_name, n_devices)``
        pair over the first n CUDA devices (raising past the count), or
        a ``parallel.mesh.Mesh`` (how P shards share one card). None or a
        one-shard request runs unsharded."""
        from ..parallel.mesh import Mesh, make_mesh

        if shard is None:
            return None
        mesh = None
        if isinstance(shard, Mesh):
            mesh, axis, n = shard, shard.axis_names[0], shard.size
        else:
            try:
                axis, n = shard
                axis, n = str(axis), int(n)
            except (TypeError, ValueError):
                raise ValueError(
                    f"shard={shard!r}: expected an (axis_name, n_devices) pair, e.g. "
                    "('devices', 8), or a Mesh"
                )
            if n < 1:
                raise ValueError(f"shard device count must be >= 1, got {n}")
        if n == 1:
            return None
        if mesh is None:
            n_avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n > n_avail:
                raise ValueError(f"shard=({axis!r}, {n}): only {n_avail} device(s) available")
        bad = sorted({s.kind for s in self._steps if s.kind in _SHARD_INCOMPATIBLE})
        if bad:
            detail = "; ".join(f"{k} {_SHARD_INCOMPATIBLE[k]}" for k in bad)
            raise PipelineError(
                f"sharded stream cannot lower stage(s) {bad}: {detail} — run those unsharded"
            )
        if mesh is None:
            mesh = make_mesh(n, axis_names=(axis,))
        return _ShardSpec(axis, n, mesh)

    # sprtcheck: plan-key-fold — the budget's choices land in {i}.bcast
    def _bcast_choices(self, spec: Optional[_ShardSpec]) -> dict:
        """Each join stage's build-side placement under a sharded stream:
        {stage index: 1 (broadcast) or 0 (co-partition)}. A stage's
        explicit ``broadcast=`` wins (True is rejected for full/right
        joins: unmatched build rows would emit once per shard); otherwise
        broadcast when the build side fits ``broadcast_budget()`` and the
        join kind allows it. The choices fold into the plan and the
        feedback key, so the two lowerings never share a program or
        observations."""
        if spec is None:
            return {}
        choices: dict = {}
        for i, s in enumerate(self._steps):
            if s.kind != "join":
                continue
            kw = dict(s.params)
            how = kw["how"]
            forced = kw.get("broadcast")
            if forced is not None:
                if forced and how in ("full", "right"):
                    raise PipelineError(
                        f"join stage {i}: broadcast=True cannot run how={how!r} — unmatched "
                        "rows of the replicated build side would emit once per device; "
                        "co-partition (broadcast=False)"
                    )
                choices[i] = int(bool(forced))
                continue
            side = self._sides[kw["side"]]
            fits = _resource._table_row_bytes(side, None) * side.num_rows <= broadcast_budget()
            choices[i] = int(fits and how not in ("full", "right"))
        return choices

    @staticmethod
    def _shard_suffix(spec: Optional[_ShardSpec], bchoices: dict) -> str:
        """The feedback-key suffix of a sharded stream: per-shard
        observations never warm-start the one-device plan (or another
        mesh size's), a broadcast join's never the co-partitioned one's."""
        if spec is None:
            return ""
        suffix = f"|shard:{spec.axis}:{spec.n_dev}"
        if bchoices:
            suffix += "|bcast:" + ",".join(f"{i}:{v}" for i, v in sorted(bchoices.items()))
        return suffix

    def stream(
        self,
        tables,
        *,
        window: int = 2,
        collect: bool = True,
        donate: bool = False,
        shard=None,
        analyze: Optional[bool] = None,
    ):
        """Streaming chunk executor: map the chain over ``tables``
        keeping up to ``window`` chunks IN FLIGHT, so device compute, the
        collect and host prep of the next chunk overlap. Per chunk, the
        plan lookup and dispatch happen immediately (the device queues
        the work); the tail vector's wait and the collect are DEFERRED to
        an in-order retirement stage. Capacity retry survives the
        deferral (``resource.run_plan_deferred``): an overflow found at
        retirement re-plans count-informed and re-executes THAT chunk
        synchronously — inputs stay referenced until their chunk
        retires. ``window=1`` is the serial loop.

        ``shard=("devices", n)`` (the first n CUDA devices) or
        ``shard=<parallel.mesh.Mesh>`` splits every chunk over the mesh
        inside its one program (see the module docstring): group_by
        lowers to the two-phase distributed aggregate (pin integer keys
        with the stage's ``wire_widths``), join to a broadcast build
        side when it fits the per-device budget (or the stage forces
        ``broadcast=``) and a co-partitioned exchange otherwise, with the
        per-shard capacities re-planned like every other knob. Results
        are value-identical to the unsharded stream, with group and join
        rows in hash-placement order. from_json / to_rows raise up front.

        Returns the per-chunk results in input order: collected compact
        Tables, or padded ``(table, live)`` pairs with
        ``collect=False``."""
        if analyze is not None:
            tok = _ctx_analyze.set(bool(analyze))
            try:
                return self.stream(tables, window=window, collect=collect, donate=donate,
                                   shard=shard)
            finally:
                _ctx_analyze.reset(tok)
        window = int(window)
        if window < 1:
            raise ValueError(f"stream window must be >= 1, got {window}")
        an = analyze_mode()
        self._check_donate(donate)
        if an and donate:
            raise PipelineError(
                "analyze mode is incompatible with donate=True: the "
                "stage-sliced programs re-read the chunk's buffers "
                "across slices"
            )
        spec = self._resolve_shard(shard)
        bchoices = self._bcast_choices(spec)
        scope = _resource.current_task()
        op_name = f"Pipeline.{self.name}"
        op = f"pipeline.{self.name}"
        fb_on = capacity_feedback()
        sig = _sig_hash(self.signature() + self._shard_suffix(spec, bchoices)) if fb_on else None
        n_dev = 0 if spec is None else spec.n_dev
        _metrics.gauge("pipeline.stream_window").set(window)
        # 0 for an unsharded stream: the gauge never keeps reporting an
        # earlier sharded stream's mesh size
        _metrics.gauge("pipeline.shard_devices").set(n_dev)
        inflight: List[dict] = []
        results: List[Any] = []

        def retire_oldest():
            e = inflight.pop(0)
            _metrics.gauge("pipeline.inflight").set(len(inflight))
            # re-enter the chunk's op span: the deferred sync, any
            # retries, the collect and the close events chain to it
            _spans.adopt(e["span"])
            try:
                out_tbl, live, nested = e["deferred"].retire()[:3]
                # retirement drops the references that pin the chunk
                e["chunk"] = None
                holder = e["holder"]
                holder["table"] = None
                if fb_on and holder.get("stats"):
                    _record_feedback(sig, self.name, holder["plan"], holder["stats"])
                if scope is not None and inflight:
                    # a retirement re-plan may have grown this chunk's
                    # plan while later chunks were queued: re-record the
                    # concurrent sum with the final plan
                    scope._record_bytes(
                        e["deferred"].estimate_bytes()
                        + sum(x["deferred"].estimate_bytes() for x in inflight)
                    )
                out = self._collect(out_tbl, live, nested, holder, collect)
                wall_ms = (time.perf_counter() - e["t0"]) * 1000
                _events.emit(
                    "stream_retire", op=op_name, chunk=e["index"], window=window,
                    shard_devices=n_dev, retries=e["deferred"].retries, wall_ms=round(wall_ms, 3),
                )
                if _metrics.enabled():
                    rows_out, bytes_out = _metrics._rows_bytes(out if collect else out_tbl)
                    _metrics.record_op(
                        op_name, wall_ms, rows_in=e["rows_in"], bytes_in=e["bytes_in"],
                        rows_out=rows_out, bytes_out=bytes_out,
                    )
                return out
            except Exception as exc:
                if _metrics.enabled():
                    _metrics.record_op(
                        op_name, (time.perf_counter() - e["t0"]) * 1000,
                        rows_in=e["rows_in"], bytes_in=e["bytes_in"], ok=False,
                        error=type(exc).__name__,
                    )
                raise
            finally:
                _spans.close_span(e["span"], emit_end=False)

        with _spans.span("stream", f"{op_name}.stream", window=window):
            try:
                for idx, chunk in enumerate(tables):
                    while len(inflight) >= window:
                        results.append(retire_oldest())
                    t0 = time.perf_counter()
                    rows_in, bytes_in = _metrics._rows_bytes(chunk)
                    plan0 = self._initial_plan(chunk.num_rows,
                                               _feedback_for(sig) if fb_on else None,
                                               shard_n=max(n_dev, 1), bcast=bchoices)
                    dispatch, sync, holder = self._dispatch_fns(chunk, donate, analyze=an,
                                                                shard=spec)
                    holder["chunk"] = idx
                    n_est, row_b = self._estimate_basis(chunk)
                    sp = _spans.open_span("op", op_name)
                    try:
                        deferred = _resource.run_plan_deferred(
                            op, dispatch, sync, self._replan,
                            lambda p, _n=n_est, _rb=row_b: self._estimate_from_basis(_n, _rb, p),
                            plan0,
                        )
                    except BaseException as exc:
                        # the chunk is not in `inflight` yet, so the
                        # outer unwind cannot close this span for us
                        if _metrics.enabled() and isinstance(exc, Exception):
                            _metrics.record_op(
                                op_name, (time.perf_counter() - t0) * 1000,
                                rows_in=rows_in, bytes_in=bytes_in, ok=False,
                                error=type(exc).__name__,
                            )
                        _spans.close_span(sp, emit_end=False)
                        raise
                    # the op span leaves the stack OPEN so the next
                    # chunk's span opens as a sibling
                    _spans.detach(sp)
                    inflight.append({
                        "index": idx,
                        "chunk": None if donate else chunk,
                        "deferred": deferred,
                        "holder": holder,
                        "span": sp,
                        "t0": t0,
                        "rows_in": rows_in,
                        "bytes_in": bytes_in,
                    })
                    del chunk
                    _metrics.gauge("pipeline.inflight").set(len(inflight))
                    if scope is not None:
                        # K chunks in flight: the device-resident
                        # footprint is the SUM of their plan estimates
                        scope._record_bytes(sum(e["deferred"].estimate_bytes() for e in inflight))
                while inflight:
                    results.append(retire_oldest())
            except BaseException as exc:
                # unwind chunks still in flight: drop their work, close
                # their spans with a failed op sample
                while inflight:
                    e = inflight.pop(0)
                    e["deferred"].abandon()
                    _spans.adopt(e["span"])
                    if _metrics.enabled():
                        _metrics.record_op(
                            op_name, (time.perf_counter() - e["t0"]) * 1000,
                            rows_in=e["rows_in"], bytes_in=e["bytes_in"], ok=False,
                            error=type(exc).__name__,
                        )
                    _spans.close_span(e["span"], emit_end=False)
                _metrics.gauge("pipeline.inflight").set(0)
                raise
        return results

    def run_chunks(self, tables, *, window: int = 1, **kw):
        """Map the chain over an iterable of chunks — a wrapper over
        ``stream`` whose default ``window=1`` retires each chunk before
        the next dispatches."""
        return self.stream(tables, window=window, **kw)

    def scan_parquet(
        self,
        paths,
        *,
        columns=None,
        predicate=None,
        window: int = 2,
        prefetch_depth: int = 2,
        workers: Optional[int] = None,
        device="cuda",
        **kw,
    ):
        """Run the chain over a streamed parquet scan
        (``runtime/scan.py``): footers planned once (column pruning,
        row-group pruning against footer min/max stats for a simple
        numeric ``predicate``), surviving row groups decoded ahead by the
        prefetch pool onto ``device`` and fed through ``stream``'s
        window. A predicate also prepends a residual per-row filter
        stage, so results are exactly the predicate's rows. Returns the
        per-chunk results in row-group order, like ``stream``."""
        from . import scan as _scan

        plan = _scan.ScanPlan(paths, columns=columns, predicate=predicate, device=device)
        try:
            chain = self
            residual = plan.residual_filter()
            if residual is not None:
                # chain copy with the residual filter PREPENDED: scan
                # predicates see the raw file columns
                chain = Pipeline(self.name)
                chain.filter(residual)
                chain._steps.extend(self._steps)
                chain._sides = list(self._sides)
            source = _scan.prefetch_chunks(plan, depth=prefetch_depth, workers=workers)
            try:
                return chain.stream(source, window=window, **kw)
            finally:
                source.close()  # join decode workers first
        finally:
            plan.close()
