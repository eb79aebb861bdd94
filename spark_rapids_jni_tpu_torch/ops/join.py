"""Equi-joins with Spark semantics (PyTorch twin of the JAX package's
``ops/join.py``).

The design is the JAX package's sort-merge join, in three dense phases:

1. both sides lower to order-key operands (ops/sort.py), so Spark key
   equality is exact operand equality: NaN == NaN, -0.0 == 0.0, and a
   null key matches nothing (its count is zeroed),
2. every probe row finds its equal-key run [lo, lo + cnt) in the
   sorted build side through the merged-rank probe: one stable sort of
   both sides' order words, build rows first, gives each probe row its
   build-rank bounds from a cumsum and each key run's start
   (``_merged_rank_probe``),
3. match expansion: output row j belongs to the probe row whose
   exclusive start is the last one at or before j (a ``searchsorted``),
   and pairs with build row ``r_perm[lo + j - start]``.

Where the JAX package takes a binary search for float keys, the port
maps floats to integers with the same order and equality
(``sort._integer_key``) and takes the merged probe for every key set;
lo, cnt and r_perm are the JAX package's (tests/test_torch_join.py
holds them equal for NaN, -0.0 and null keys). The JAX package packs
rows into 32-bit words for its gathers (a TPU gather costs the same per
index whatever the width); the port gathers column by column, with the
same results.

Join types: inner, left, right, full, left_semi, left_anti. Output is
the left columns then the right columns (semi/anti: left only); outer
misses are null. ``join`` syncs the host once for its output size (and
once more for a full join's unmatched right rows); ``join_padded``
keeps a fixed ``capacity`` and an occupied mask instead.

Validity form: a column of the probe (left) side that had no mask keeps
none in ``join``'s output, as in the JAX package's fused inner/left
path; its other paths give an all-true mask there. The values are
equal through ``Column.validity_or_true()``. Every column of
``join_padded``'s output has a mask.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..columnar import strings as strs
from ..columnar.column import Column
from ..columnar.table import Table
from .sort import gather, gather_column, order_keys, stable_lex_order

_HOWS = ("inner", "left", "right", "full", "left_semi", "left_anti")


def _check_args(how: str, left_on, right_on) -> None:
    if how not in _HOWS:
        raise ValueError(f"how={how!r}, expected one of {_HOWS}")
    if len(left_on) != len(right_on):
        raise ValueError("left_on and right_on must have equal length")


def _join_names(left: Table, right: Table):
    """left names + right names, or None if either side is unnamed."""
    if left.names is None or right.names is None:
        return None
    return tuple(left.names) + tuple(right.names)


def _check_key_pair(lc: Column, rc: Column) -> None:
    """Paired key columns must lower to positionally identical operand
    layouts, or the lexicographic compare would silently misalign."""
    lt, rt = lc.dtype, rc.dtype
    ok = lt.kind == rt.kind
    if ok and lt.kind == "decimal":
        ok = lt.bits == rt.bits and lt.scale == rt.scale
    if not ok:
        raise TypeError(f"join key dtype mismatch: {lt} vs {rt}; cast one side first")


def _pad_mat(mat, L: int):
    """Widen a (chars, lengths) matrix to width L with the -1 past-end
    sentinel (a no-op when already that wide)."""
    chars, lengths = mat
    cur = int(chars.shape[1])
    if cur == L:
        return mat
    pad = torch.full((chars.shape[0], L - cur), -1, dtype=chars.dtype, device=chars.device)
    return torch.cat([chars, pad], dim=1), lengths


def _pair_key_operands(left, right, left_on, right_on, left_mats=None, right_mats=None):
    """Ascending order-key operands for both sides, position-aligned: a
    null-flag operand on every key (maskless columns too) and string
    keys padded to one shared char-matrix width. Also returns each
    side's char matrices (column index -> (chars, lengths)) for the
    output gathers.

    ``left_mats``/``right_mats`` supply prebuilt matrices; a pair's two
    widths are aligned by sentinel padding. Without them the width comes
    from the longest string of the pair (one host sync)."""
    l_ops: List[torch.Tensor] = []
    r_ops: List[torch.Tensor] = []
    l_mats, r_mats = dict(left_mats or {}), dict(right_mats or {})
    for lk, rk in zip(left_on, right_on):
        lc, rc = left.columns[lk], right.columns[rk]
        _check_key_pair(lc, rc)
        mats = (None, None)
        if lc.is_varlen:
            lm, rm = l_mats.get(lk), r_mats.get(rk)
            if (lm is None) != (rm is None):
                raise ValueError(
                    f"string key pair (left col {lk}, right col {rk}): prebuilt char "
                    "matrices were supplied for only one side; supply both or neither"
                )
            if lm is not None:
                L = max(int(lm[0].shape[1]), int(rm[0].shape[1]))
                mats = (_pad_mat(lm, L), _pad_mat(rm, L))
            else:
                longest = [c.string_lengths().max() for c in (lc, rc) if len(c)]
                # host sync: the pair's longest string sizes the matrices
                width = int(torch.stack(longest).max()) if longest else 1
                L = strs.bucket_length(max(width, 1))
                mats = (strs.to_char_matrix(lc, L), strs.to_char_matrix(rc, L))
            l_mats[lk], r_mats[rk] = mats
        for col, mat, ops in ((lc, mats[0], l_ops), (rc, mats[1], r_ops)):
            ops.extend(order_keys(col, True, True, mat, force_null_key=True))
    return l_ops, r_ops, l_mats, r_mats


def _merged_rank_probe(r_ops, l_ops):
    """(lo, cnt, r_perm), int64: for each probe row the run [lo, lo +
    cnt) of equal-key rows in the stably sorted build side, and that
    sort's permutation.

    Both sides' operands are concatenated, build rows first, and sorted
    once (``stable_lex_order``). Stability puts every build row before
    the probe rows of its key, which is the JAX package's side-flag
    tiebreak. Then, over the sorted order:

    - rank_incl[p] = build rows at or before p; for a probe row it is
      the run's upper bound,
    - the lower bound is the build rank just before the run's start
      (runs compare the words only), read back through each row's run
      id (a cumsum, a scatter and a gather). The JAX package carries it
      with a running max, the same values; torch's ``cummax`` scan took
      ~6.8 ms at 4.65 M rows on an H100 (PERF.md),
    - scatters by sorted position give each probe row its bounds and
      each build row its place in r_perm."""
    m, n = r_ops[0].shape[0], l_ops[0].shape[0]
    dev = r_ops[0].device
    total = m + n
    if total == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z, z
    perm, words = stable_lex_order([torch.cat([r, lo]) for r, lo in zip(r_ops, l_ops)])
    is_build = (perm < m).to(torch.int64)
    rank_incl = torch.cumsum(is_build, 0)
    sw = words[perm]
    boundary = torch.ones(total, dtype=torch.bool, device=dev)
    boundary[1:] = (sw[1:] != sw[:-1]).any(dim=1)
    run = torch.cumsum(boundary, 0) - 1
    run_lo = torch.empty(total + 1, dtype=torch.int64, device=dev)
    run_lo[torch.where(boundary, run, total)] = rank_incl - is_build  # spare slot: non-starts
    lo_at = run_lo[run]
    by_row = torch.empty((2, total), dtype=torch.int64, device=dev)
    by_row[:, perm] = torch.stack([lo_at, rank_incl - lo_at])
    slot = torch.where(is_build.bool(), rank_incl - 1, m)
    r_perm = torch.empty(m + 1, dtype=torch.int64, device=dev)
    r_perm[slot] = perm  # probe rows all land in the spare slot m
    return by_row[0, m:], by_row[1, m:], r_perm[:m]


def _null_key_rows(table: Table, keys: Sequence[int]) -> torch.Tensor:
    """bool [n]: any join key is null (such rows never match)."""
    out = torch.zeros(table.num_rows, dtype=torch.bool, device=table.columns[0].device)
    for ki in keys:
        v = table.columns[ki].validity
        if v is not None:
            out = out | ~v
    return out


def _mask_key_columns(table: Table, keys: Sequence[int], occupied) -> Table:
    """View of ``table`` whose key columns' validity is ANDed with
    ``occupied``, so dead (padding) rows lower to null keys and never
    match. Non-key columns are untouched."""
    if occupied is None:
        return table
    cols = list(table.columns)
    for ki in keys:
        c = cols[ki]
        cols[ki] = Column(c.dtype, c.data, c.validity_or_true() & occupied, c.offsets)
    return Table(cols, table.names)


def _probe(
    left, right, left_on, right_on, left_occupied=None, right_occupied=None,
    left_mats=None, right_mats=None,
):
    """The probe phase shared by ``join`` and ``join_padded``: operand
    lowering (dead rows masked to null keys), the merged-rank probe,
    and null or dead probe rows' counts zeroed. Returns (lo, cnt,
    r_perm, l_mats, r_mats, live_l)."""
    n = left.num_rows
    live_l = left_occupied
    if live_l is None:
        live_l = torch.ones(n, dtype=torch.bool, device=left.columns[0].device)
    l_masked = _mask_key_columns(left, left_on, left_occupied)
    r_masked = _mask_key_columns(right, right_on, right_occupied)
    l_ops, r_ops, l_mats, r_mats = _pair_key_operands(
        l_masked, r_masked, left_on, right_on, left_mats, right_mats
    )
    lo, cnt, r_perm = _merged_rank_probe(r_ops, l_ops)
    cnt = torch.where(_null_key_rows(l_masked, left_on) | ~live_l, 0, cnt)
    return lo, cnt, r_perm, l_mats, r_mats, live_l


def _expand(lo, cnt, emit, r_perm, size: int):
    """Match expansion to ``size`` output rows: (left_out, right_out,
    matched, right_sorted_idx, total). Probe row i fills ``emit[i]``
    rows from its exclusive start on; rows past the true total
    ``total`` repeat the last probe row and match nothing, and rows
    past ``size`` are dropped, as ``jnp.repeat(total_repeat_length=)``
    does in the JAX package."""
    n, m = lo.shape[0], r_perm.shape[0]
    dev = lo.device
    iota = torch.arange(size, dtype=torch.int64, device=dev)
    if n == 0:
        z = torch.zeros(size, dtype=torch.int64, device=dev)
        return z, z, torch.zeros(size, dtype=torch.bool, device=dev), z, z.new_zeros(())
    ends = torch.cumsum(emit, 0)
    starts = ends - emit
    total = ends[-1]
    left_out = torch.searchsorted(starts, iota, right=True) - 1
    matched = (cnt[left_out] > 0) & (iota < total)
    right_sorted_idx = lo[left_out] + iota - starts[left_out]
    if m > 0:
        right_out = torch.where(matched, r_perm[right_sorted_idx.clamp(0, m - 1)], 0)
    else:
        right_out = torch.zeros(size, dtype=torch.int64, device=dev)
    return left_out, right_out, matched, right_sorted_idx, total


def _null_column(c: Column, k: int) -> Column:
    """``k`` null rows of ``c``'s type (zero data, empty strings)."""
    dev = c.device
    invalid = torch.zeros(k, dtype=torch.bool, device=dev)
    if c.is_varlen:
        empty = torch.zeros(0, dtype=torch.uint8, device=dev)
        return Column(c.dtype, empty, invalid, torch.zeros(k + 1, dtype=torch.int32, device=dev))
    zeros = torch.zeros((k,) + c.data.shape[1:], dtype=c.data.dtype, device=dev)
    return Column(c.dtype, zeros, invalid)


def _gather_side(table: Table, idx, miss, mats=None, pad_payload: bool = False) -> List[Column]:
    """Gather rows ``idx``; ``miss`` rows become null (``miss=None``: no
    row is missed, and a column without a mask keeps none). An empty
    source with a non-empty index (an outer join against an empty side)
    yields all-null columns. ``mats`` are the key char matrices of the
    operand lowering; ``pad_payload`` keeps varlen payloads at a fixed
    capacity."""
    n, k = table.num_rows, int(idx.shape[0])
    if n == 0 and k > 0:
        return [_null_column(c, k) for c in table.columns]
    safe = idx.clamp(0, max(n - 1, 0))
    cols = []
    for i, c in enumerate(table.columns):
        g = gather_column(c, safe, None if mats is None else mats.get(i), pad_payload)
        if miss is not None:
            g = Column(g.dtype, g.data, g.validity_or_true() & ~miss, g.offsets)
        cols.append(g)
    return cols


def _append_rows(base: Column, extra: Column) -> Column:
    """Concatenate two columns of the same dtype."""
    validity = torch.cat([base.validity_or_true(), extra.validity_or_true()])
    if base.is_varlen:
        data = torch.cat([base.data, extra.data])
        offsets = torch.cat([base.offsets, extra.offsets[1:] + base.offsets[-1]])
        return Column(base.dtype, data, validity, offsets)
    return Column(base.dtype, torch.cat([base.data, extra.data]), validity)


def _full_tail(out_cols, left: Table, right: Table, tail_idx, k: int):
    """Extend a left-join result with k unmatched right rows (their
    left side null)."""
    nl = left.num_columns
    new_cols = [_append_rows(c, _null_column(c, k)) for c in out_cols[:nl]]
    for j, c in enumerate(out_cols[nl:]):
        new_cols.append(_append_rows(c, gather_column(right.columns[j], tail_idx)))
    return new_cols


def _unmatched_build_rows(matched, right_sorted_idx, m: int) -> torch.Tensor:
    """bool [m] in build-sorted order: no output row pairs with it."""
    hits = torch.where(matched, right_sorted_idx.clamp(0, m - 1), m)
    ones = torch.ones_like(hits)
    counts = torch.zeros(m + 1, dtype=torch.int64, device=hits.device).index_add_(0, hits, ones)
    return counts[:m] == 0


def join(
    left: Table,
    right: Table,
    left_on: Sequence[int],
    right_on: Sequence[int],
    how: str = "inner",
) -> Table:
    """Equi-join. Returns left columns followed by right columns
    (semi/anti: left columns only)."""
    _check_args(how, left_on, right_on)
    if how == "right":
        # right join = mirrored left join with columns re-ordered
        mirrored = join(right, left, right_on, left_on, "left")
        nr = right.num_columns
        return Table(mirrored.columns[nr:] + mirrored.columns[:nr], _join_names(left, right))

    n, m = left.num_rows, right.num_rows
    lo, cnt, r_perm, l_mats, r_mats, _live = _probe(left, right, left_on, right_on)

    if how in ("left_semi", "left_anti"):
        keep = (cnt > 0) if how == "left_semi" else (cnt == 0)
        # host sync: the kept count sizes the index list
        return gather(left, torch.nonzero(keep).squeeze(1), l_mats)

    emit = cnt.clamp(min=1) if how in ("left", "full") else cnt
    # host sync: the output size (join is the host driver; join_padded
    # keeps a fixed capacity instead)
    total = int(emit.sum()) if n else 0
    left_out, right_out, matched, right_sorted_idx, _ = _expand(lo, cnt, emit, r_perm, total)
    out_cols = _gather_side(left, left_out, None, l_mats)
    out_cols += _gather_side(right, right_out, ~matched, r_mats)

    if how == "full" and m:
        # append right rows nobody matched (their left side all null)
        keep_tail = _unmatched_build_rows(matched, right_sorted_idx, m)
        tail_sorted = torch.nonzero(keep_tail).squeeze(1)  # host sync: the tail's size
        k = int(tail_sorted.shape[0])
        if k:
            out_cols = _full_tail(out_cols, left, right, r_perm[tail_sorted], k)
    return Table(out_cols, _join_names(left, right))


def _first_true(keep: torch.Tensor, size: int) -> torch.Tensor:
    """Row ids of the first ``size`` True entries of ``keep``, then 0s:
    ``jnp.nonzero(keep, size=size, fill_value=0)`` with no host sync."""
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (rank < size), rank, size)
    out = torch.zeros(size + 1, dtype=torch.int64, device=keep.device)
    out[slot] = torch.arange(keep.shape[0], device=keep.device)
    return out[:size]


def join_padded(
    left: Table,
    right: Table,
    left_on: Sequence[int],
    right_on: Sequence[int],
    capacity: int,
    how: str = "inner",
    left_occupied=None,
    right_occupied=None,
    with_stats: bool = False,
    left_mats=None,
    right_mats=None,
):
    """Bounded equi-join: the output padded to ``capacity`` rows plus an
    occupied mask (rows past the true match count are dead; matches
    past ``capacity`` are dropped). With integer keys it syncs nothing
    but the sort's varying-word check.

    ``left_occupied``/``right_occupied`` mark live input rows: dead rows
    never match and are never emitted. ``left_mats``/``right_mats``
    (column index -> (chars, lengths)) supply prebuilt char matrices for
    varlen columns; the output's varlen columns then carry a payload of
    fixed capacity. ``with_stats=True`` also returns the true
    (unclamped) output row count, so callers can detect overflow."""
    _check_args(how, left_on, right_on)
    if how == "right":
        out = join_padded(
            right, left, right_on, left_on, capacity, "left",
            right_occupied, left_occupied, with_stats, right_mats, left_mats,
        )
        nr = right.num_columns
        cols = out[0].columns[nr:] + out[0].columns[:nr]
        return (Table(cols, _join_names(left, right)),) + tuple(out[1:])

    m = right.num_rows
    padded = left_mats is not None or right_mats is not None
    lo, cnt, r_perm, l_mats, r_mats, live_l = _probe(
        left, right, left_on, right_on, left_occupied, right_occupied, left_mats, right_mats
    )
    iota_cap = torch.arange(capacity, dtype=torch.int64, device=lo.device)

    if how in ("left_semi", "left_anti"):
        keep = (cnt > 0) if how == "left_semi" else live_l & (cnt == 0)
        count = keep.sum()
        occ = iota_cap < count
        out_cols = _gather_side(left, _first_true(keep, capacity), ~occ, l_mats, padded)
        tbl = Table(out_cols, left.names)
        return (tbl, occ, count) if with_stats else (tbl, occ)

    emit = cnt.clamp(min=1) if how in ("left", "full") else cnt
    emit = torch.where(live_l, emit, 0)
    left_out, right_out, matched, right_sorted_idx, total = _expand(
        lo, cnt, emit, r_perm, capacity
    )
    in_main = iota_cap < total
    occ, needed = in_main, total
    right_miss = ~matched
    if how == "full" and m > 0:
        # append live right rows nobody matched (their left side null)
        live_r_sorted = True if right_occupied is None else right_occupied[r_perm]
        keep_tail = _unmatched_build_rows(matched, right_sorted_idx, m) & live_r_sorted
        tail_rank = torch.cumsum(keep_tail.to(torch.int64), 0) - 1
        k_tail = keep_tail.sum()
        tail_pos = torch.where(keep_tail, total + tail_rank, capacity).clamp(max=capacity)
        # scatters into one spare slot past the end, which is cut off
        # (``mode="drop"`` in the JAX package)
        right_out = torch.cat([right_out, right_out.new_zeros(1)]).index_put_((tail_pos,), r_perm)
        right_miss = torch.cat([right_miss, right_miss.new_zeros(1)]).index_put_(
            (tail_pos,), torch.zeros_like(keep_tail)
        )
        right_out, right_miss = right_out[:capacity], right_miss[:capacity]
        occ = iota_cap < total + k_tail
        needed = total + k_tail
    out_cols = _gather_side(left, left_out, ~in_main, l_mats, padded)
    out_cols += _gather_side(right, right_out, right_miss, r_mats, padded)
    tbl = Table(out_cols, _join_names(left, right))
    return (tbl, occ, needed) if with_stats else (tbl, occ)
