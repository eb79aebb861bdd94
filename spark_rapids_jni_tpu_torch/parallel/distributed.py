"""Distributed relational operators over a device mesh (the port's twin
of the JAX package's ``parallel/distributed.py``).

- ``distributed_group_by``: the two-phase hash aggregate: per-shard
  partial aggregation (``group_by_padded``), a hash-partition exchange
  of the partial groups by key (``shuffle.py``, Spark-exact murmur3
  placement), then a per-shard final merge. Count/sum merge by summing
  partials, min/max by re-reducing, mean as (sum, count) divided at the
  end: Spark's Partial/Final aggregate split.
- ``distributed_join``: exchange both sides by key, then the bounded
  local sort-merge join (``join_padded``) per shard;
  ``distributed_join_broadcast`` replicates the build side instead.
- ``distributed_sort``: Spark's RangePartitioning (sampled splitters,
  ``partition_exchange``) + a stable local sort per shard.

Inputs and outputs follow ``parallel/mesh.py``: a row-sharded table is
a ``ShardedTable`` of P per-shard Tables, a row-sharded mask a list of
P tensors; overflow counts and per-device observation vectors live on
the first mesh device. Every operator keeps padded static shapes and
occupancy masks and reads nothing to the host inside a fused chain;
outside one, the eager size checks (an output capacity that would drop
matches, a pinned width a string exceeds) raise as in the JAX package.

The driver-side collect of padded results (``collect_table`` /
``collect_group_by``) keeps the result on its device: ONE batched
device -> host transfer reads the live count, each varlen column's
live payload bytes and the overflow counts, then the live rows gather
on the device at those host-known sizes. A sharded result gathers its
shards onto the first mesh device first. With the shrink knob off
(``set_collect_shrink(False)`` / ``SPARK_JNI_TPU_COLLECT_SHRINK=off``)
the planes move to the host whole and compact there, the JAX package's
retained path; both give the same Table.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import strings as strs
from ..columnar.column import Column
from ..columnar.dtypes import DECIMAL128, FLOAT64, INT64
from ..columnar.table import Table
from ..ops._strategy import fused
from ..ops.aggregate import Agg, _decimal_mean_from_sum, _result_dtype, group_by_padded
from ..ops.join import _first_true, _join_names, _mask_key_columns, join_padded
from ..ops.sort import SortKey, order_keys, stable_lex_order
from ..runtime import events as _events
from ..runtime import metrics as _metrics
from ..runtime import spans as _spans
from ..runtime.errors import CapacityExceededError
from ..utils import int256 as u256
from . import exchange, spark_hash
from . import shuffle as shuffle_mod
from .mesh import Mesh, ShardedTable, axis_size, replicate_table, shard_table, shard_vector

# Stage names of the per-stage overflow breakdown (``overflow_detail=
# True``): each key maps to the bounded contract that dropped/truncated
# at that stage, so runtime/resource.py can grow exactly the knob that
# overflowed.
GROUP_BY_STAGES = (
    "input_truncation",  # live input row wider than its pinned width
    "local_groups",      # phase-1 groups past per-shard ``capacity``
    "shuffle",           # phase-2 bucket drops / width truncation
    "final_merge",       # phase-3 groups past the derived merge bound
)
JOIN_STAGES = (
    "left_shuffle",      # left-side exchange drops / width truncation
    "right_shuffle",     # right-side exchange drops / width truncation
    "join_output",       # matches past ``out_capacity``
)
# broadcast-join overflow stages: no exchange runs, so the shuffle
# stages are replaced by the two sides' width-truncation counts
BROADCAST_JOIN_STAGES = (
    "left_truncation",   # live left row wider than its pinned width
    "right_truncation",  # live right (build) row wider than its pin
    "join_output",       # matches past ``out_capacity``
)


def _per_dev(mesh: Mesh, values) -> torch.Tensor:
    """int32 [P] on the first mesh device: one scalar per shard."""
    first = mesh.devices[0]
    return torch.stack([v.reshape(()).to(first).to(torch.int32) for v in values])


def _local_table_from_planes(out, slots, vpos, dtypes):
    """Rebuild one shard's Table from exchanged planes (the
    ``shuffle._exchange(as_planes=True)`` layout). Varlen columns repack
    at a static byte capacity (rows * width); returns (table, mats)
    where ``mats[i]`` is the -1-padded char matrix of column i, reusable
    by key lowering (join_padded's left_mats/right_mats, order_keys)."""
    cols, mats = [], {}
    for i, dt in enumerate(dtypes):
        v = out[vpos[i]] if i in vpos else None
        kind, pos = slots[i]
        if kind == "fixed":
            cols.append(Column(dt, out[pos], v))
            continue
        chars_u8, lengths = out[pos], out[pos + 1]
        n, L = chars_u8.shape
        # the wire plane is uint8: restore the -1 past-end sentinel the
        # order keys and parsers rely on
        pos_ar = torch.arange(L, dtype=torch.int32, device=chars_u8.device)[None, :]
        chars = torch.where(pos_ar < lengths[:, None], chars_u8.to(torch.int32), -1)
        mats[i] = (chars, lengths)
        cols.append(strs.from_char_matrix(chars, lengths, v, total=int(n) * int(L),
                                          dtype=None if dt.kind == "string" else dt))
    return Table(cols), mats


def _planes_general(st: ShardedTable, widths: dict, occupied=None):
    """Decompose every shard (possibly holding string columns) into
    exchange-layout planes: fixed-width column -> its data; string
    column -> (uint8 char matrix at the pinned ``widths[i]``, lengths).
    Same slot layout as ``shuffle._plan_exchange``. Returns (arrays per
    shard, slots, vcols, valids per shard, dtypes, trunc) where
    ``trunc`` counts live rows whose bytes exceed the pinned width."""
    mesh = st.mesh
    first = st.shards[0]
    slots, pos = {}, 0
    for i, c in enumerate(first.columns):
        slots[i] = ("var", pos) if c.is_varlen else ("fixed", pos)
        pos += 2 if c.is_varlen else 1
    vcols = tuple(i for i in range(first.num_columns)
                  if any(s.columns[i].validity is not None for s in st.shards))
    arrays, valids, truncs = [], [], []
    for s, shard in enumerate(st.shards):
        planes = []
        trunc = torch.zeros((), dtype=torch.int32, device=mesh.devices[s])
        for i, c in enumerate(shard.columns):
            if c.is_varlen:
                L = widths[i]
                chars, lengths = strs.to_char_matrix(c, L)
                over = c.string_lengths() > L
                if occupied is not None:
                    over = over & occupied[s]
                trunc = trunc + over.sum().to(torch.int32)
                planes.append(torch.where(chars >= 0, chars, 0).to(torch.uint8))
                planes.append(lengths)
            else:
                planes.append(c.data)
        arrays.append(planes)
        valids.append([shard.columns[i].validity_or_true() for i in vcols])
        truncs.append(trunc)
    dtypes = tuple(c.dtype for c in first.columns)
    return arrays, slots, vcols, valids, dtypes, exchange.psum(mesh, truncs).to(torch.int32)


def _result_planes(res: Table, res_widths: dict):
    """Lower a shard-local group-by result to wire planes: fixed
    columns as they are, string columns as (uint8 chars, lengths)."""
    outs = []
    for j, c in enumerate(res.columns):
        if c.is_varlen:
            chars, lengths = strs.to_char_matrix(c, res_widths[j])
            outs.append(torch.where(chars >= 0, chars, 0).to(torch.uint8))
            outs.append(lengths)
        else:
            outs.append(c.data)
    return outs


def _partial_aggs(aggs: Sequence[Agg], src_dtypes: Sequence):
    """Map each requested agg to partial aggs + a final-merge plan.

    Returns (partials, plan, dec_checks):
    - plan[i] = (mode, partial positions, source dtype) rebuilding
      output i from the re-aggregated partials: 'sum'/'min'/'max'
      re-reduce one partial, 'mean' divides the summed sum by the summed
      count (decimal means use the source dtype for Spark's p+4/s+4).
    - dec_checks pairs (sum_partial_pos, count_partial_pos) for every
      DECIMAL sum partial: a shard whose partial sum overflowed emits a
      NULL partial, which the merge's null-skipping sum would drop; the
      check columns detect that and null the group (Spark's non-ANSI
      overflow -> null)."""
    partials: List[Agg] = []
    plan: List[Tuple] = []
    dec_checks: List[Tuple[int, int]] = []

    def add(a: Agg) -> int:
        partials.append(a)
        return len(partials) - 1

    for a, dt in zip(aggs, src_dtypes):
        is_dec = dt is not None and dt.kind == "decimal"
        if a.op == "count":
            plan.append(("sum", [add(a)], dt))
        elif a.op == "sum":
            s = add(a)
            plan.append(("sum", [s], dt))
            if is_dec:
                dec_checks.append((s, add(Agg("count", a.column))))
        elif a.op in ("min", "max"):
            plan.append((a.op, [add(a)], dt))
        elif a.op == "mean":
            s = add(Agg("sum", a.column))
            c = add(Agg("count", a.column))
            plan.append(("mean", [s, c], dt))
            if is_dec:
                dec_checks.append((s, c))
        else:
            raise NotImplementedError(f"distributed {a.op}")
    return partials, plan, dec_checks


def _string_widths(st: ShardedTable, cols, pinned: Optional[dict]) -> dict:
    """Pinned char-matrix width per varlen column in ``cols``: the
    caller's pin, else the bucketed global max length (one host read;
    inside a fused chain a pin is required)."""
    widths = {}
    for ci in sorted(cols):
        if not st.shards[0].columns[ci].is_varlen:
            continue
        if pinned and ci in pinned:
            widths[ci] = int(pinned[ci])
            continue
        if fused():
            raise TypeError(f"string column {ci} has a data-dependent char-matrix width; "
                            f"pass string_widths={{{ci}: <max_bytes>}} to keep it sync-free")
        lens = [s.columns[ci].string_lengths() for s in st.shards]
        mx = shuffle_mod._global_max(st.mesh, lens)
        widths[ci] = strs.bucket_length(max(mx if st.num_rows else 1, 1))
    return widths


def distributed_group_by(
    table,
    key_indices: Sequence[int],
    aggs: Sequence[Agg],
    mesh: Mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    occupied=None,
    string_widths: Optional[dict] = None,
    wire_widths: Optional[dict] = None,
    overflow_detail: bool = False,
    merge_capacity: Optional[int] = None,
    shuffle_salt: int = 0,
    with_stats: bool = False,
):
    """Two-phase distributed GROUP BY over ``mesh``. Group KEY columns
    may be strings: they ride every stage as pinned-width char-matrix
    planes (``string_widths``: column index -> max bytes; overruns count
    into the overflow). Aggregate VALUE columns may be strings only for
    min/max.

    Returns (padded result ShardedTable, occupied masks, overflow):
    ``overflow`` is an int32 count of groups/rows lost to any bounded
    contract (phase-1 group capacity, shuffle buckets, final merge),
    checked (raise) by ``collect_group_by``; with
    ``overflow_detail=True`` a dict of per-stage counts keyed by
    ``GROUP_BY_STAGES``. Per shard, ``capacity`` group slots (default:
    the local row count).

    Capacity accounting: with ``occupied`` given, the granted phase-1
    capacity is ``capacity + 1``: the dead rows collapse into one
    synthetic group with a slot of its own. Size ``capacity`` to the
    real group count and grow ``capacity`` itself on "local_groups"
    overflow, never the bump. Groups land on the shard owning
    murmur3(key): the global result is the union of occupied slots.

    ``wire_widths`` (original col index -> bits) pins integer GROUP-KEY
    columns to a narrow wire dtype on the phase-2 exchange.
    ``merge_capacity`` pins the phase-3 per-shard group slots (default
    the always-safe ``P * capacity + 1``); ``shuffle_salt`` re-seeds the
    phase-2 placement (equal keys still co-locate). ``with_stats=True``
    appends a dict of int32 [P] observation vectors:
    ``local_groups_per_dev`` (phase-1 real group need),
    ``merge_groups_per_dev`` (phase-3 need, uncapped) and
    ``shuffle_recv_per_dev`` (live partials received)."""
    st = shard_table(table, mesh)
    P = shuffle_mod._shard_list(st, mesh, axis)[1]
    occ_in = None if occupied is None else shard_vector(occupied, mesh, st.num_rows)
    # project to the referenced columns: the result carries keys + aggs
    used = sorted({*key_indices, *(a.column for a in aggs if a.column is not None)})
    remap = {c: i for i, c in enumerate(used)}
    st = ShardedTable([Table([s.columns[c] for c in used]) for s in st.shards], mesh)
    key_indices = [remap[k] for k in key_indices]
    aggs = [Agg(a.op, None if a.column is None else remap[a.column]) for a in aggs]
    if string_widths:
        string_widths = {remap[c]: w for c, w in string_widths.items() if c in remap}
    first = st.shards[0]
    for a in aggs:
        if a.column is not None and first.columns[a.column].is_varlen \
                and a.op not in ("min", "max"):
            raise NotImplementedError(
                f"distributed {a.op} over a string column (min/max and string group keys "
                "are supported)")
    strip_live = occ_in is not None
    if strip_live:
        # dead rows' keys lower to zeroed null operands -> one group
        shards = []
        for s, shard in enumerate(st.shards):
            masked = _mask_key_columns(shard, key_indices, occ_in[s])
            live = Column(INT64, occ_in[s].to(torch.int64))
            shards.append(Table([live] + list(masked.columns)))
        st = ShardedTable(shards, mesh)
        key_indices = [0] + [k + 1 for k in key_indices]
        aggs = [Agg(a.op, None if a.column is None else a.column + 1) for a in aggs]
        if string_widths:
            string_widths = {c + 1: w for c, w in string_widths.items()}
    n_local = st.shards[0].num_rows
    if capacity is None:
        capacity = max(n_local, 1)
    if strip_live:
        # the synthetic all-dead-rows group (liveness 0, sorts first)
        # takes a phase-1 slot of its own
        capacity += 1
    first = st.shards[0]
    partials, plan, dec_checks = _partial_aggs(
        aggs, [None if a.column is None else first.columns[a.column].dtype for a in aggs])
    nk = len(key_indices)
    varlen_used = set(key_indices) | {a.column for a in aggs
                                      if a.column is not None and first.columns[a.column].is_varlen}
    widths = _string_widths(st, varlen_used, string_widths)

    # Phase 1: per-shard partial aggregation over the plane rebuild
    arrays, slots, valid_cols, valids, dtypes, trunc0 = _planes_general(st, widths, occ_in)
    res_dtypes = tuple(dtypes[ki] for ki in key_indices) + tuple(
        _result_dtype(a, None if a.column is None else dtypes[a.column]) for a in partials)
    res_widths = {j: widths[ki] for j, ki in enumerate(key_indices) if ki in widths}
    for j, a in enumerate(partials):
        if a.column is not None and a.column in widths:
            res_widths[nk + j] = widths[a.column]
    res_slots, pos = {}, 0
    for j, dt in enumerate(res_dtypes):
        res_slots[j] = ("fixed", pos) if dt.is_fixed_width else ("var", pos)
        pos += 1 if dt.is_fixed_width else 2
    n_res_planes, n_res_cols = pos, len(res_dtypes)
    vpos1 = {c: len(arrays[0]) + j for j, c in enumerate(valid_cols)}
    p_shards, p_occ, ovf1, need1 = [], [], [], []
    for s in range(P):
        tbl_l, mats = _local_table_from_planes(list(arrays[s]) + list(valids[s]), slots, vpos1,
                                               dtypes)
        res, occ, ng = group_by_padded(tbl_l, tuple(key_indices), tuple(partials), capacity,
                                       key_mats=mats or None, pad_payload=True)
        ng = ng.to(torch.int32)
        outs = _result_planes(res, res_widths)
        out_valid = [c.validity_or_true() for c in res.columns]
        # the plane round trip the JAX package's shard_map boundary takes
        vpos_g = {j: n_res_planes + j for j in range(n_res_cols)}
        partial_res, _ = _local_table_from_planes(outs + out_valid, res_slots, vpos_g, res_dtypes)
        p_shards.append(partial_res)
        p_occ.append(occ)
        ovf1.append(torch.clamp(ng - capacity, min=0))
        # observed REAL phase-1 need: the synthetic dead-rows group holds
        # a slot only when the shard held dead rows
        synth = (arrays[s][0] == 0).any().to(torch.int32) if strip_live else 0
        need1.append(ng - synth)
    ovf1 = exchange.psum(mesh, ovf1).to(torch.int32)

    # Phase 2: exchange the partial groups by key. Dead slots get
    # validity False on every column and liveness 0, so they never
    # merge with real null-key groups.
    shuffle_st = ShardedTable(
        [Table([Column(INT64, p_occ[s].to(torch.int64))] + list(p_shards[s].columns))
         for s in range(P)], mesh)
    key_for_shuffle = [0] + [1 + i for i in range(nk)]  # liveness + keys
    # place on the REAL key columns only: the input-liveness key must
    # not perturb the murmur3(key) placement
    shuffle_keys = list(range(2 if strip_live else 1, 1 + nk))
    shuffle_widths = {1 + j: w for j, w in res_widths.items()}
    shuffle_wire = None
    if wire_widths:
        shuffle_wire = {}
        for orig_ci, bits in wire_widths.items():
            ci = remap.get(orig_ci)
            if ci is None:
                continue
            if strip_live:
                ci += 1
            if ci in key_indices:
                shuffle_wire[1 + key_indices.index(ci)] = bits
        shuffle_wire = shuffle_wire or None
    s_arrays, s_slots, s_cap, s_trunc, s_wc = shuffle_mod._plan_exchange(
        shuffle_st, None, p_occ, shuffle_widths, wire_widths=shuffle_wire)
    pids = shuffle_mod._hash_pids(shuffle_st, shuffle_keys, s_arrays, s_slots, P,
                                  seed=spark_hash.salted_seed(shuffle_salt))
    s_out, s_slots2, s_vpos, occ2, ovf_sh = shuffle_mod._exchange(
        shuffle_st, s_arrays, s_slots, pids, P, s_cap, p_occ, s_trunc, as_planes=True,
        wire_casts=s_wc)

    # Phase 3: the final merge per shard, grouping again by (liveness, keys)
    final_aggs: List[Agg] = []
    for a in partials:
        ci = 1 + nk + len(final_aggs)
        final_aggs.append(Agg("sum", ci) if a.op in ("count", "sum") else Agg(a.op, ci))
    check_pos = []
    n_partial_cols = 1 + nk + len(partials)
    for k, (sp, cp) in enumerate(dec_checks):
        check_pos.append((sp, len(final_aggs)))
        final_aggs.append(Agg("sum", n_partial_cols + k))
    s_dtypes = shuffle_st.dtypes
    # a shard can receive up to P * capacity distinct groups (every
    # sender's padded output) plus the dead-slot group, unless the caller
    # pinned ``merge_capacity``; undershoots count into final_merge
    final_capacity = P * capacity + 1 if merge_capacity is None else int(merge_capacity)
    final_res_dtypes = res_dtypes + (INT64,) * len(dec_checks)
    final_res_slots = dict(res_slots)
    pos_f = n_res_planes
    for k in range(len(dec_checks)):
        final_res_slots[n_res_cols + k] = ("fixed", pos_f)
        pos_f += 1
    vpos_gf = {j: pos_f + j for j in range(len(final_res_dtypes))}
    out_shards, final_occ, ovf3, need3 = [], [], [], []
    for s in range(P):
        occ = occ2[s]
        tbl_l, mats = _local_table_from_planes(list(s_out[s]), s_slots2, s_vpos, s_dtypes)
        cols = []
        for c in tbl_l.columns:
            # dead shuffle slots: force invalid so they group separately
            v = occ if c.validity is None else (c.validity & occ)
            cols.append(Column(c.dtype, c.data, v, c.offsets))
        cols[0] = Column(INT64, torch.where(occ, tbl_l.columns[0].data, 0))
        for sp, cp in dec_checks:
            sv = cols[1 + nk + sp].validity_or_true()
            cd = cols[1 + nk + cp].data
            cols.append(Column(INT64, (~sv & (cd > 0) & occ).to(torch.int64)))
        res, occ_out, ng = group_by_padded(Table(cols), tuple(key_for_shuffle),
                                           tuple(final_aggs), final_capacity,
                                           key_mats=mats or None, pad_payload=True)
        ng = ng.to(torch.int32)
        occ_out = occ_out & (res.columns[0].data == 1)
        rest = Table(list(res.columns[1:]))
        outs = _result_planes(rest, res_widths)
        out_valid = [c.validity_or_true() for c in rest.columns]
        res_tbl, _ = _local_table_from_planes(outs + out_valid, final_res_slots, vpos_gf,
                                              final_res_dtypes)
        nk_out = nk
        if strip_live:
            # drop the input-liveness key: its ==0 group is the dead rows
            occ_out = occ_out & (res_tbl.columns[0].data == 1)
            res_tbl = Table(list(res_tbl.columns[1:]))
            nk_out -= 1
        out_shards.append(Table(_apply_final_plan(res_tbl, nk_out, plan, check_pos)))
        final_occ.append(occ_out)
        ovf3.append(torch.clamp(ng - final_capacity, min=0))
        need3.append(ng)
    ovf3 = exchange.psum(mesh, ovf3).to(torch.int32)
    if overflow_detail:
        overflow = dict(zip(GROUP_BY_STAGES, (trunc0, ovf1, ovf_sh, ovf3)))
    else:
        overflow = trunc0 + ovf1 + ovf_sh + ovf3
    result = ShardedTable(out_shards, mesh)
    if not with_stats:
        return result, final_occ, overflow
    stats = {
        "local_groups_per_dev": _per_dev(mesh, need1),
        "merge_groups_per_dev": _per_dev(mesh, need3),
        "shuffle_recv_per_dev": _per_dev(mesh, [o.sum() for o in occ2]),
    }
    return result, final_occ, overflow, stats


def _apply_final_plan(res: Table, nk: int, plan, check_pos=()) -> List[Column]:
    """Rebuild the requested outputs from merged partials. A nonzero
    decimal overflow indicator (``check_pos``) nulls its group."""
    checks = dict(check_pos)

    def _ok_mask(sum_pos):
        if sum_pos not in checks:
            return None
        return res.columns[nk + checks[sum_pos]].data == 0

    out = list(res.columns[:nk])
    for mode, pos, src_dt in plan:
        if mode in ("sum", "min", "max"):
            col = res.columns[nk + pos[0]]
            ok = _ok_mask(pos[0])
            if ok is not None:
                col = Column(col.dtype, col.data, col.validity_or_true() & ok, col.offsets)
            out.append(col)
        elif src_dt is not None and src_dt.kind == "decimal":
            # Spark decimal avg: HALF_UP (sum * 10^4) / count at scale
            # s + 4, type DECIMAL(min(38, p + 4), s + 4)
            s = res.columns[nk + pos[0]]
            c = res.columns[nk + pos[1]]
            q, ovf = _decimal_mean_from_sum(u256.from_i128_limbs(s.data), c.data)
            validity = s.validity_or_true() & (c.data > 0) & ~ovf
            ok = _ok_mask(pos[0])
            if ok is not None:
                validity = validity & ok
            dt = DECIMAL128(min(38, src_dt.precision + 4), src_dt.scale + 4)
            out.append(Column(dt, u256.to_i128_limbs(q), validity))
        else:  # mean: sum / count in float64
            s = res.columns[nk + pos[0]]
            c = res.columns[nk + pos[1]]
            mean = s.data.to(torch.float64) / torch.clamp(c.data, min=1).to(torch.float64)
            out.append(Column(FLOAT64, mean, s.validity_or_true() & (c.data > 0)))
    return out


def _check_join_keys(left_dtypes, right_dtypes, left_on, right_on) -> None:
    if len(left_on) != len(right_on):
        raise ValueError("left_on and right_on must have equal length")
    for li, ri in zip(left_on, right_on):
        lt, rt = left_dtypes[li], right_dtypes[ri]
        if lt != rt:
            # co-partitioning hashes raw key bytes: int32 and int64 of
            # equal value hash differently, so require exact dtypes
            raise TypeError(f"distributed join key dtype mismatch: {lt} vs {rt}; "
                            "cast to a common type first (Spark does the same)")


def _local_joins(mesh, l_parts, r_parts, left_on, right_on, out_capacity, how):
    """Run the bounded local join per shard over (table, mats, occupied)
    parts; returns per-shard (datas, valids, occ, needed), varlen outputs
    as (chars, lengths) at their static width."""
    outs = []
    for s in range(mesh.size):
        lt, l_mats, lo_ = l_parts[s]
        rt, r_mats, ro_ = r_parts[s]
        res, occ, needed = join_padded(lt, rt, list(left_on), list(right_on), out_capacity, how,
                                       lo_, ro_, with_stats=True, left_mats=l_mats,
                                       right_mats=r_mats)
        datas, valids = [], []
        for c in res.columns:
            if c.is_varlen:
                # the static width survives as payload bytes / rows
                L = int(c.data.shape[0]) // out_capacity
                datas.append(strs.to_char_matrix(c, L))
            else:
                datas.append(c.data)
            valids.append(c.validity_or_true())
        outs.append((datas, valids, occ, needed.reshape(()).to(torch.int64)))
    return outs


def _join_result(mesh, outs, out_dtypes, names, out_capacity, label):
    """(ShardedTable, occupied, join_output overflow, needed per shard)
    from the per-shard join outputs; outside a fused chain a shard that
    needs more than ``out_capacity`` rows raises."""
    shards, occ, needed = [], [], []
    for datas, valids, o, nd in outs:
        cols = []
        for i, dt in enumerate(out_dtypes):
            if dt.kind in ("string", "binary"):
                chars, lengths = datas[i]
                cols.append(strs.from_char_matrix(
                    chars, lengths, valids[i], total=int(chars.shape[0]) * int(chars.shape[1]),
                    dtype=None if dt.kind == "string" else dt))
            else:
                cols.append(Column(dt, datas[i], valids[i]))
        shards.append(Table(cols, names))
        occ.append(o)
        needed.append(nd)
    need_vec = torch.stack([n.to(mesh.devices[0]) for n in needed])
    join_ovf = torch.clamp(need_vec - out_capacity, min=0).sum().to(torch.int32)
    if not fused():
        mx = int(need_vec.max())
        if mx > out_capacity:
            raise CapacityExceededError(
                f"{label}: a shard needs {mx} output rows > out_capacity={out_capacity}; "
                "raise out_capacity",
                stage="join_output", needed=mx, granted=out_capacity,
            )
    return ShardedTable(shards, mesh), occ, join_ovf, need_vec.to(torch.int32)


def distributed_join(
    left,
    right,
    left_on: Sequence[int],
    right_on: Sequence[int],
    mesh: Mesh,
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
    overflow_detail: bool = False,
    with_stats: bool = False,
):
    """Shuffle join over the mesh: hash-partition both sides by key
    (Spark-exact murmur3, so equal keys co-locate), then the bounded
    local sort-merge join (``join_padded``) per shard: the shuffled hash
    join the spark-rapids plugin runs above cudf.

    String columns ride the exchange as char-matrix planes; inside a
    fused chain pin their widths (``left_string_widths`` /
    ``right_string_widths``; overruns count into the overflow).
    ``left_wire_widths`` / ``right_wire_widths`` pin integer planes to a
    narrow wire dtype with no host sync.

    Returns (padded result ShardedTable, occupied masks, overflow).
    ``out_capacity`` bounds each shard's output rows (default: the
    post-exchange local row count of the larger side); matches past it
    are dropped but counted in ``overflow`` (dict per ``JOIN_STAGES``
    with ``overflow_detail=True``), and outside a fused chain a short
    capacity raises. ``with_stats=True`` appends int32 [P] vectors
    ``out_needed_per_dev`` (true output need), ``left_recv_per_dev`` and
    ``right_recv_per_dev`` (live rows received)."""
    lst = shard_table(left, mesh)
    rst = shard_table(right, mesh)
    _check_join_keys(lst.dtypes, rst.dtypes, left_on, right_on)
    P = shuffle_mod._shard_list(lst, mesh, axis)[1]

    def _hash_exchange(st, keys, occupied, widths, wire_w):
        occ = None if occupied is None else shard_vector(occupied, mesh, st.num_rows)
        arrays, slots, cap_, trunc, wc = shuffle_mod._plan_exchange(
            st, shuffle_capacity, occ, widths, wire_widths=wire_w)
        pids = shuffle_mod._hash_pids(st, keys, arrays, slots, P)
        return shuffle_mod._exchange(st, arrays, slots, pids, P, cap_, occ, trunc,
                                     as_planes=True, wire_casts=wc)

    l_out, l_slots, l_vpos, l_occ, l_ovf = _hash_exchange(
        lst, left_on, left_occupied, left_string_widths, left_wire_widths)
    r_out, r_slots, r_vpos, r_occ, r_ovf = _hash_exchange(
        rst, right_on, right_occupied, right_string_widths, right_wire_widths)
    l_dtypes, r_dtypes = lst.dtypes, rst.dtypes
    if out_capacity is None:
        out_capacity = max(int(l_occ[0].shape[0]), int(r_occ[0].shape[0]))
    semi = how in ("left_semi", "left_anti")
    out_dtypes = list(l_dtypes) if semi else list(l_dtypes) + list(r_dtypes)
    l_parts, r_parts = [], []
    for s in range(P):
        lt, l_mats = _local_table_from_planes(l_out[s], l_slots, l_vpos, l_dtypes)
        rt, r_mats = _local_table_from_planes(r_out[s], r_slots, r_vpos, r_dtypes)
        l_parts.append((lt, l_mats, l_occ[s]))
        r_parts.append((rt, r_mats, r_occ[s]))
    outs = _local_joins(mesh, l_parts, r_parts, left_on, right_on, out_capacity, how)
    names = lst.names if semi else _join_names(lst.shards[0], rst.shards[0])
    result, occ, join_ovf, need = _join_result(mesh, outs, out_dtypes, names, out_capacity,
                                               "distributed_join")
    if overflow_detail:
        overflow = dict(zip(JOIN_STAGES, (l_ovf, r_ovf, join_ovf)))
    else:
        overflow = l_ovf + r_ovf + join_ovf
    if not with_stats:
        return result, occ, overflow
    stats = {
        "out_needed_per_dev": need,
        "left_recv_per_dev": _per_dev(mesh, [o.sum() for o in l_occ]),
        "right_recv_per_dev": _per_dev(mesh, [o.sum() for o in r_occ]),
    }
    return result, occ, overflow, stats


def distributed_join_broadcast(
    left,
    right,
    left_on: Sequence[int],
    right_on: Sequence[int],
    mesh: Mesh,
    how: str = "inner",
    axis: str = "data",
    left_occupied=None,
    right_occupied=None,
    out_capacity: Optional[int] = None,
    left_string_widths: Optional[dict] = None,
    right_string_widths: Optional[dict] = None,
    overflow_detail: bool = False,
    with_stats: bool = False,
):
    """Broadcast join over the mesh: the probe (left) side shards by
    rows, the build (right) side is copied to every device, and each
    shard runs the bounded local join against the whole build table:
    the plugin's broadcast-hash join, for build sides that fit a
    per-device budget. String columns on BOTH sides need pinned widths.

    Replication means an unmatched build row exists on every shard, so
    ``full`` and ``right`` joins are rejected (co-partition them with
    ``distributed_join``). Returns ``(padded ShardedTable, occupied
    masks, overflow)``; ``overflow_detail=True`` splits the count per
    ``BROADCAST_JOIN_STAGES``; ``with_stats=True`` appends
    ``{"out_needed_per_dev": int32 [P]}``."""
    if isinstance(right, ShardedTable):
        right = right.gather()
    ldt = left.dtypes if isinstance(left, ShardedTable) else tuple(c.dtype for c in left.columns)
    _check_join_keys(ldt, tuple(c.dtype for c in right.columns), left_on, right_on)
    if how in ("full", "right"):
        raise ValueError(
            f"broadcast join cannot run how={how!r}: unmatched rows of the replicated build "
            "side would emit once per device; co-partition instead (distributed_join)")
    P = axis_size(mesh, axis)
    if left.num_rows % P != 0:
        raise ValueError(f"broadcast join probe side has {left.num_rows} rows, not divisible "
                         f"by the {P}-device mesh; pad the probe side")
    lst = shard_table(left, mesh)
    for tag, cols, widths in (("left", lst.shards[0].columns, left_string_widths),
                              ("right", right.columns, right_string_widths)):
        for i, c in enumerate(cols):
            if c.is_varlen and (widths is None or i not in widths):
                raise ValueError(f"broadcast join: varlen {tag} column {i} needs a pinned "
                                 f"width ({tag}_string_widths={{col: bytes}})")
    l_occ = shard_vector(left_occupied, mesh, lst.num_rows)
    l_arrays, l_slots, l_vcols, l_valids, l_dtypes, l_trunc = _planes_general(
        lst, left_string_widths or {}, l_occ)
    # the build side, once per distinct device
    copies = replicate_table(right, mesh)
    r_occ_all = (torch.ones(right.num_rows, dtype=torch.bool, device=right.columns[0].device)
                 if right_occupied is None else right_occupied)
    r_cache, r_parts_dev, r_truncs = {}, [], []
    for s, d in enumerate(mesh.devices):
        key = str(d)
        if key not in r_cache:
            one = Mesh([d])
            r_occ = [r_occ_all.to(d, non_blocking=True)]
            arr, r_slots, r_vcols, r_valids, r_dtypes, r_trunc = _planes_general(
                ShardedTable([copies[s]], one), right_string_widths or {}, r_occ)
            r_vpos = {c: len(arr[0]) + j for j, c in enumerate(r_vcols)}
            rt, r_mats = _local_table_from_planes(list(arr[0]) + list(r_valids[0]), r_slots,
                                                  r_vpos, r_dtypes)
            r_cache[key] = (rt, r_mats, r_occ[0])
            r_truncs.append(r_trunc)
        r_parts_dev.append(r_cache[key])
    r_trunc = r_truncs[0].to(mesh.devices[0])
    if out_capacity is None:
        out_capacity = max(lst.shards[0].num_rows, 1)
    semi = how in ("left_semi", "left_anti")
    out_dtypes = list(l_dtypes) if semi else list(l_dtypes) + list(right.columns[i].dtype
                                                                    for i in range(
                                                                        right.num_columns))
    l_vpos = {c: len(l_arrays[0]) + j for j, c in enumerate(l_vcols)}
    l_parts = []
    for s in range(P):
        lt, l_mats = _local_table_from_planes(list(l_arrays[s]) + list(l_valids[s]), l_slots,
                                              l_vpos, l_dtypes)
        l_parts.append((lt, l_mats, l_occ[s]))
    outs = _local_joins(mesh, l_parts, r_parts_dev, left_on, right_on, out_capacity, how)
    names = lst.names if semi else _join_names(lst.shards[0], right)
    result, occ, join_ovf, need = _join_result(mesh, outs, out_dtypes, names, out_capacity,
                                               "broadcast join")
    if overflow_detail:
        overflow = dict(zip(BROADCAST_JOIN_STAGES, (l_trunc, r_trunc, join_ovf)))
    else:
        overflow = l_trunc + r_trunc + join_ovf
    if not with_stats:
        return result, occ, overflow
    return result, occ, overflow, {"out_needed_per_dev": need}


def distributed_sort(
    table,
    keys,
    mesh: Mesh,
    axis: str = "data",
    occupied=None,
    capacity: Optional[int] = None,
    samples_per_shard: int = 64,
    string_widths: Optional[dict] = None,
):
    """Distributed ORDER BY: Spark's RangePartitioning + local sort.

    1. every shard contributes a strided sample of its sort-key operands
       (``order_keys``, so direction and null placement are already
       plain ascending operand order),
    2. splitters = quantiles of the gathered global sample,
    3. each row's destination = the number of splitters <= its key
       (equal keys never straddle shards),
    4. one ``partition_exchange``, then a stable local sort per shard
       with dead slots last.

    Returns (padded sorted ShardedTable, occupied masks, overflow):
    shard d holds global range d, live rows first, so the live prefixes
    in shard order are the ORDER BY result. ``capacity`` is the
    per-(sender, destination) bucket bound (default 4x the balanced
    share); outside a fused chain a skew that overflows it raises."""
    keys = [k if isinstance(k, SortKey) else SortKey(k) for k in keys]
    st, P = shuffle_mod._shard_list(table, mesh, axis)
    n = st.num_rows
    n_local = n // P if P else 0
    if capacity is None:
        capacity = max(4 * ((n_local + P - 1) // max(P, 1)), 16)
    occ = None if occupied is None else shard_vector(occupied, mesh, n)
    occ_in = shard_vector(occupied, mesh, n)
    arrays, slots, capacity, trunc, _wc = shuffle_mod._plan_exchange(
        st, capacity, occ, string_widths)

    def _key_mat(s, ci):
        kind, pos = slots[ci]
        if kind != "str":
            return None
        chars_u8, lengths = arrays[s][pos], arrays[s][pos + 1]
        L = chars_u8.shape[1]
        pos_ar = torch.arange(L, dtype=torch.int32, device=chars_u8.device)[None, :]
        return torch.where(pos_ar < lengths[:, None], chars_u8.to(torch.int32), -1), lengths

    # operand lowering per shard; dead rows' operands go to the maximum
    # so they cannot skew the splitters
    operands = []
    for s in range(P):
        ops = []
        for k in keys:
            ops.extend(order_keys(st.shards[s].columns[k.column], k.ascending,
                                  k.nulls_first_resolved, _key_mat(s, k.column)))
        top = []
        for op in ops:
            big = (torch.iinfo(op.dtype).max if not op.is_floating_point() else float("inf"))
            top.append(torch.where(occ_in[s], op, torch.full_like(op, big)))
        operands.append(top)
    # strided global sample -> splitters (small, on the first device)
    first = mesh.devices[0]
    stride = max(n_local // samples_per_shard, 1)
    sample_parts = []
    for s in range(P):
        lo = s * n_local
        g0 = -(-lo // stride) * stride  # first sampled global row in the shard
        local = torch.arange(g0 - lo, n_local, stride, device=mesh.devices[s])
        sample_parts.append([op[local].to(first) for op in operands[s]])
    sample_ops = [torch.cat([sp[k] for sp in sample_parts]) for k in range(len(operands[0]))]
    s_n = int(sample_ops[0].shape[0])
    perm, _words = stable_lex_order(sample_ops)
    split_pos = torch.tensor([((i + 1) * s_n) // P for i in range(P - 1)], dtype=torch.int64,
                             device=first)
    splitters = [op[perm][split_pos] for op in sample_ops]
    bins = []
    for s in range(P):
        dev = mesh.devices[s]
        sp_s = [sp.to(dev) for sp in splitters]
        b = torch.zeros(n_local, dtype=torch.int32, device=dev)
        for j in range(P - 1):
            # splitter_j <= row  <=>  not (row < splitter_j)
            lt = torch.zeros(n_local, dtype=torch.bool, device=dev)
            eq = torch.ones(n_local, dtype=torch.bool, device=dev)
            for op, sp in zip(operands[s], sp_s):
                sj = sp[j]
                lt = lt | (eq & (op < sj))
                eq = eq & (op == sj)
            b = b + (~lt).to(torch.int32)
        bins.append(b)
    out, slots2, vpos, occ2, overflow = shuffle_mod._exchange(
        st, arrays, slots, bins, P, capacity, occ, trunc, as_planes=True)
    dtypes = st.dtypes
    shards, out_occ = [], []
    for s in range(P):
        t, mats = _local_table_from_planes(out[s], slots2, vpos, dtypes)
        occ_l = occ2[s]
        ops = [(~occ_l).to(torch.int8)]  # liveness first: dead last
        for k in keys:
            ops.extend(order_keys(t.columns[k.column], k.ascending, k.nulls_first_resolved,
                                  mats.get(k.column)))
        perm_l, _w = stable_lex_order(ops)
        cols = []
        for i, dt in enumerate(dtypes):
            kind, pos = slots2[i]
            v = out[s][vpos[i]][perm_l] if i in vpos else None
            if kind == "fixed":
                cols.append(Column(dt, out[s][pos][perm_l], v))
            else:
                chars, lengths = mats[i]
                cols.append(strs.from_char_matrix(
                    chars[perm_l], lengths[perm_l], v,
                    total=int(chars.shape[0]) * int(chars.shape[1]),
                    dtype=None if dt.kind == "string" else dt))
        shards.append(Table(cols, st.names))
        out_occ.append(occ_l[perm_l])
    if not fused():
        live_in = torch.stack([o.sum().to(first) for o in occ_in]).sum()
        live_out = torch.stack([o.sum().to(first) for o in out_occ]).sum()
        lost = int(live_in - live_out)
        if lost:
            raise CapacityExceededError(
                f"distributed_sort: {lost} rows dropped by a skewed partition exceeding "
                f"capacity={capacity}; raise capacity",
                stage="sort_exchange", granted=capacity,
            )
    return ShardedTable(shards, mesh), out_occ, overflow



def compact_validity(table: Table, invalid_counts: Optional[Sequence[int]] = None) -> Table:
    """Drop all-True validity masks (the JAX package's
    ``Table.compact_validity``). ``invalid_counts`` — the null count of
    each masked column, in column order — comes from a caller that
    already synced it; otherwise one batched host sync reads it."""
    masked = [i for i, c in enumerate(table.columns) if c.validity is not None]
    if not masked:
        return table
    if invalid_counts is None:
        invalid_counts = torch.stack(
            [(~table.columns[i].validity).sum() for i in masked]
        ).tolist()
    cols = list(table.columns)
    for bad, i in zip(invalid_counts, masked):
        if not bad:
            c = cols[i]
            cols[i] = Column(c.dtype, c.data, None, c.offsets)
    return Table(cols, table.names)


def live_tail(result: Table, occupied) -> torch.Tensor:
    """int64 [1 + n_varlen] device vector: the live row count, then
    each varlen column's live payload bytes (null rows count 0) — what
    the compaction needs to know on the host. No sync."""
    parts = [occupied.sum().reshape(1).to(torch.int64)]
    for c in result.columns:
        if c.is_varlen:
            lens = torch.where(occupied, c.string_lengths(), 0)
            parts.append(lens.sum().reshape(1).to(torch.int64))
    return torch.cat(parts)


def _publish_device_metrics(per_dev, n_dev: int, overflow) -> None:
    """Per-device task metrics at the driver-side collect: each device's
    occupied-slot count (``device.<d>.occupied_slots``), the key-skew
    gauge (max/mean occupied slots) and one ``device_metrics`` journal
    event with the per-stage overflow counts."""
    if not _metrics.enabled() or n_dev <= 0 or not per_dev:
        return
    mean = sum(per_dev) / len(per_dev)
    skew = max(per_dev) / mean if mean > 0 else 0.0
    _metrics.drop_gauges("device.")
    for d, v in enumerate(per_dev):
        _metrics.gauge(f"device.{d}.occupied_slots").set(v)
    _metrics.gauge("collect.key_skew").set(skew)
    if isinstance(overflow, dict):
        ovf = {k: int(v) for k, v in overflow.items()}
    elif overflow is not None:
        ovf = {"total": int(overflow)}
    else:
        ovf = {}
    _events.emit(
        "device_metrics",
        n_dev=n_dev,
        occupied_slots=list(per_dev),
        key_skew=round(skew, 4),
        overflow=ovf,
    )


def _check_overflow(overflow) -> None:
    """Raise CapacityExceededError when a host-synced overflow count
    (an int, or a per-stage dict) is nonzero."""
    if overflow is None:
        return
    if isinstance(overflow, dict):
        counts = {k: int(v) for k, v in overflow.items()}
        tripped = {k: v for k, v in counts.items() if v}
        if not tripped:
            return
        for k, v in tripped.items():
            _metrics.counter(f"overflow.{k}").inc(v)
        _events.emit("capacity_overflow", source="collect", stages=tripped)
        per_stage = ", ".join(f"{k}={v}" for k, v in tripped.items())
        raise CapacityExceededError(
            "pipeline overflow detected — rows/groups dropped or truncated "
            f"by stage (indicator counts): {per_stage}. Raise the bound "
            "feeding the overflowing stage(s) and rerun, or run under a "
            "runtime.resource task scope to re-plan automatically",
            stage=max(tripped, key=tripped.get),
            breakdown=counts,
        )
    lost = int(overflow)
    if lost:
        _metrics.counter("overflow.unattributed").inc(lost)
        _events.emit("capacity_overflow", source="collect", stages={"unattributed": lost})
        raise CapacityExceededError(
            f"pipeline overflow detected (indicator count={lost}): rows/groups "
            "were dropped or truncated by a bounded contract (join capacity, "
            "group capacity, or pinned string width); raise the undersized "
            "bound and rerun"
        )


def _gather_live(result: Table, occupied, n_live: int, varlen_bytes: Sequence[int]) -> Table:
    """The live rows of ``result`` in order, gathered on its device at
    host-known sizes (no sync)."""
    idx = _first_true(occupied, n_live) if n_live else occupied.new_zeros(0, dtype=torch.int64)
    cols = []
    vi = 0
    for c in result.columns:
        valid = None if c.validity is None else c.validity[idx]
        if not c.is_varlen:
            cols.append(Column(c.dtype, c.data[idx], valid))
            continue
        total = int(varlen_bytes[vi])
        vi += 1
        lens = c.string_lengths()[idx]
        offsets = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0, dtype=torch.int32)])
        row = torch.repeat_interleave(
            torch.arange(n_live, device=idx.device), lens.long(), output_size=total
        )
        pos = torch.arange(total, device=idx.device) - offsets[:-1].long()[row]
        data = c.data[c.offsets[idx].long()[row] + pos]
        cols.append(Column(c.dtype, data.to(torch.uint8), valid, offsets))
    return Table(cols, result.names)


COLLECT_SHRINK_ENV = "SPARK_JNI_TPU_COLLECT_SHRINK"
_SHRINK_MODES = ("on", "off")
_shrink_override: Optional[bool] = None


def collect_shrink() -> bool:
    """Resolved shrink-collect knob: the in-process override, else
    ``SPARK_JNI_TPU_COLLECT_SHRINK`` (default on). A malformed value
    raises."""
    if _shrink_override is not None:
        return _shrink_override
    raw = os.environ.get(COLLECT_SHRINK_ENV, "on").strip().lower()
    if raw not in _SHRINK_MODES:
        raise ValueError(f"{COLLECT_SHRINK_ENV}={raw!r}: expected one of {_SHRINK_MODES}")
    return raw == "on"


def set_collect_shrink(on: Optional[bool]) -> None:
    """Override (or clear, with None) the shrink knob in-process."""
    global _shrink_override
    _shrink_override = None if on is None else bool(on)


def _count_transfer(nbytes: int) -> None:
    """Publish the byte volume of one driver transfer."""
    if _metrics.enabled():
        _metrics.counter("collect.bytes_transferred").inc(int(nbytes))


def _host_compact(result: Table, occupied) -> Table:
    """The retained host-compaction path: every plane moves to the host
    whole, the live rows compact there with numpy, and the dense Table
    goes back to the result's device."""
    dev = occupied.device
    planes = [(c.data.cpu(), None if c.validity is None else c.validity.cpu(),
               None if c.offsets is None else c.offsets.cpu()) for c in result.columns]
    occ = occupied.cpu().numpy()
    _count_transfer(occ.nbytes + sum(int(t.numel()) * t.element_size()
                                     for pl in planes for t in pl if t is not None))
    idx = np.flatnonzero(occ)
    cols = []
    for c, (data_h, valid_h, offs_h) in zip(result.columns, planes):
        valid = None if valid_h is None else valid_h.numpy()[idx]
        if c.is_varlen:
            offs = offs_h.numpy().astype(np.int64)
            lens = (offs[1:] - offs[:-1])[idx]
            if valid is not None:
                lens = np.where(valid, lens, 0)
            new_offs = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])
            total = int(new_offs[-1])
            src = np.repeat(offs[idx], lens) + (np.arange(total, dtype=np.int64)
                                                - np.repeat(new_offs[:-1], lens))
            data = data_h.numpy()[src] if total else np.zeros(0, np.uint8)
            cols.append(Column(c.dtype, torch.from_numpy(data.astype(np.uint8)).to(dev),
                               None if valid is None else torch.from_numpy(valid).to(dev),
                               torch.from_numpy(new_offs.astype(np.int32)).to(dev)))
            continue
        cols.append(Column(c.dtype, torch.from_numpy(data_h.numpy()[idx]).to(dev),
                           None if valid is None else torch.from_numpy(valid).to(dev)))
    return Table(cols, result.names)


def _as_global(result, occupied, n_dev):
    """A sharded result gathered onto its first mesh device (with its
    masks), and its mesh size as the default ``n_dev``."""
    if isinstance(result, ShardedTable):
        dev = result.mesh.devices[0]
        if occupied is not None:
            occupied = torch.cat([o.to(dev) for o in occupied])
        return result.gather(), occupied, result.mesh.size if n_dev is None else n_dev
    if isinstance(occupied, (list, tuple)):
        occupied = torch.cat(list(occupied))
    return result, occupied, n_dev


def collect_table(result, occupied=None, overflow=None, n_dev: Optional[int] = None) -> Table:
    """Compact any padded result (a distributed join / group-by / sort /
    shuffle, ``join_padded``, ``group_by_padded``, or a fused
    runtime/pipeline.py chain) into a dense Table: the driver-side
    collect at a query tail (one sync). ``occupied=None`` means every
    row is live: the table passes through with all-True validity masks
    dropped. Pass the op's ``overflow`` to enforce the bounded
    contracts: any undersized capacity raises here instead of returning
    a plausible short answer. ``n_dev`` (default: the mesh size of a
    sharded result) turns on the per-device occupancy metrics."""
    result, occupied, n_dev = _as_global(result, occupied, n_dev)
    if occupied is None and overflow is None:
        with _spans.span("collect_stage", "collect_table"):
            return compact_validity(result)
    return collect_group_by(result, occupied, overflow, n_dev=n_dev)


def collect_group_by(result, occupied, overflow=None, n_dev: Optional[int] = None) -> Table:
    """Compact a padded result into a dense Table (one sync). Raises if
    ``overflow`` (an int tensor, or a per-stage dict of them) is
    nonzero; the dict form names WHICH stage's bounded contract dropped
    rows. With ``n_dev`` given (a sharded result gives its mesh size),
    per-device occupancy metrics are published first: even an
    overflowing collect leaves them behind."""
    result, occupied, n_dev = _as_global(result, occupied, n_dev)
    with _spans.span("collect_stage", "collect_group_by"):
        if occupied is None:
            occupied = torch.ones(
                result.num_rows, dtype=torch.bool,
                device=result.columns[0].device if result.columns else "cpu",
            )
        # ONE batched transfer: the live count, the varlen live bytes,
        # the overflow counts and the per-device occupancy
        parts = [live_tail(result, occupied)]
        keys = None
        if isinstance(overflow, dict):
            keys = list(overflow)
            parts += [torch.as_tensor(overflow[k], device=occupied.device).reshape(1)
                      .to(torch.int64) for k in keys]
        elif overflow is not None:
            parts.append(torch.as_tensor(overflow, device=occupied.device).reshape(1)
                         .to(torch.int64))
        per_dev_on = n_dev is not None and n_dev > 0 and result.num_rows > 0
        if per_dev_on:
            split = torch.tensor_split(occupied.to(torch.int64), n_dev)
            parts.append(torch.stack([p.sum() for p in split]))
        sizes = torch.cat(parts)
        host = sizes.tolist()
        _count_transfer(int(sizes.numel()) * sizes.element_size())
        n_var = sum(1 for c in result.columns if c.is_varlen)
        n_live, varlen_bytes = host[0], host[1:1 + n_var]
        rest = host[1 + n_var:]
        if keys is not None:
            ovf, rest = dict(zip(keys, rest[:len(keys)])), rest[len(keys):]
        elif overflow is not None:
            ovf, rest = rest[0], rest[1:]
        else:
            ovf = None
        if per_dev_on:
            _publish_device_metrics(rest, n_dev, ovf)
        _check_overflow(ovf)
        if collect_shrink():
            # shrink-wrapped: the live rows gather on the result's device
            # at the host-known sizes; only the sizes crossed to the host
            return _gather_live(result, occupied, n_live, varlen_bytes)
        return _host_compact(result, occupied)
