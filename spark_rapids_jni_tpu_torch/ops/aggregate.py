"""Group-by aggregation with Spark semantics (PyTorch twin of the JAX
package's ``ops/aggregate.py``).

As in the JAX package, a group-by sorts by group key and reduces over
the sorted runs:

1. group keys lower to order-key operands (ops/sort.py — Spark group
   equality becomes exact equality: nulls group together, NaN with
   NaN, -0.0 with 0.0),
2. one stable lexicographic sort gives the row permutation
   (``sort.stable_lex_order``),
3. group boundaries and ids come from adjacent differences of the
   sorted order words and a cumsum,
4. per-group [start, end] spans come from a binary search over the
   segment ids,
5. sums and counts are segment sums (ops/segmented.py); min/max of
   every dtype is a segmented argext scan over the sort's order keys,
   so NaN-greatest, null placement and decimal/string ordering follow
   the sort's Spark semantics.

Spark aggregate semantics:
- count skips nulls, returns INT64, never null; count(*) counts rows,
- sum/min/max skip nulls; all-null or empty group -> null,
- sum(int) -> INT64 (wraps on overflow, non-ANSI), sum(float) ->
  FLOAT64, sum(decimal(p,s)) -> DECIMAL128(min(38, p+10), s) with
  overflow -> null, accumulated exactly in 256-bit limbs,
- min/max(float): NaN is greatest,
- mean(int/float) -> FLOAT64 = sum/count; decimal mean is Spark's
  avg(DECIMAL(p, s)) -> DECIMAL(p + 4, s + 4) HALF_UP.

``group_by`` reads the group count once (its one host sync, as in the
JAX package) and then sizes every per-group tensor to it;
``group_by_padded`` keeps the JAX package's fixed ``capacity`` form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..columnar import strings as strs
from ..columnar.column import Column
from ..columnar.dtypes import DECIMAL128, FLOAT64, INT64, DType
from ..columnar.table import Table
from ..utils import int256 as u256
from ..utils.int128 import M32, lsr
from ._strategy import fused
from .segmented import (
    boundary_from_operands,
    group_starts,
    seg_ids_from_boundary,
    seg_scan_argext,
    seg_sum,
)
from .sort import _string_key_matrices, gather_column, order_keys, stable_lex_order


@dataclasses.dataclass(frozen=True)
class Agg:
    """One aggregate: op in {'count', 'sum', 'min', 'max', 'mean'};
    column=None only for count(*) ('count' with no column)."""

    op: str
    column: Optional[int] = None


def _result_dtype(agg: Agg, dtype: Optional[DType]) -> DType:
    if agg.op == "count":
        return INT64
    if agg.op == "mean":
        if dtype.kind == "decimal":
            # Spark's avg(DECIMAL(p, s)) -> DECIMAL(p + 4, s + 4)
            # (bounded at 38), HALF_UP division of sum by count
            return DECIMAL128(min(38, dtype.precision + 4), dtype.scale + 4)
        return FLOAT64
    if agg.op == "sum":
        if dtype.kind in ("int", "bool"):
            return INT64
        if dtype.kind == "float":
            return FLOAT64
        if dtype.kind == "decimal":
            return DECIMAL128(min(38, dtype.precision + 10), dtype.scale)
        raise NotImplementedError(f"sum over {dtype}")
    if agg.op in ("min", "max"):
        if dtype.kind in (
            "int", "bool", "float", "date", "timestamp", "decimal", "string", "binary",
        ):
            return dtype
        raise NotImplementedError(f"{agg.op} over {dtype}")
    raise ValueError(f"unknown aggregate op {agg.op!r}")


def _decimal_mean_from_sum(total, count):
    """(u256 sum, int64 count) -> (u256 quotient at scale s+4, overflow
    bool): HALF_UP of sum * 10^4 / count."""
    num = u256.mul(total, u256.pow10(4))
    cnt = torch.clamp(count, min=1)
    q = u256.divide_and_round(num, (cnt, 0), torch.zeros_like(cnt, dtype=torch.bool))
    overflow = ~_fits_i128(q) | u256.is_greater_than_decimal_38(q)
    return q, overflow


def _decompose_limbs32(data: torch.Tensor, dtype: DType):
    """Decimal storage -> 8 int64 tensors holding the unsigned 32-bit
    limbs of the sign-extended 256-bit value. Summing each limb
    independently stays exact below 2^63 for < 2^31 rows; one carry
    propagation after the segment sums rebuilds the 256-bit total."""
    if dtype.num_limbs == 2:
        lo, hi = data[:, 0], data[:, 1]
    else:
        lo = data.to(torch.int64)
        hi = lo >> 63
    limbs = []
    for w in (lo, hi):
        limbs.append(w & M32)
        limbs.append(lsr(w, 32))
    sign = torch.where(hi < 0, M32, 0)
    limbs.extend([sign] * 4)
    return limbs


def _carry_propagate(limb_sums):
    """8 int64 partial limb sums -> u256 (mod 2^256)."""
    carry = 0
    outs = []
    for k in range(8):
        t = limb_sums[k] + carry
        outs.append(t & M32)
        carry = t >> 32
    return tuple(outs[k] | (outs[k + 1] << 32) for k in range(0, 8, 2))


def _fits_i128(a) -> torch.Tensor:
    """True where the signed 256-bit value fits in 128 bits."""
    ext = a[1] >> 63
    return (a[2] == ext) & (a[3] == ext)


def _sorted_groups(table: Table, key_indices, mats):
    """(int64 perm, int32 seg): the stable group-key order and each
    sorted row's group id."""
    operands = []
    for ki in key_indices:
        operands.extend(order_keys(table.columns[ki], True, True, mats.get(ki)))
    perm, words = stable_lex_order(operands)
    seg = seg_ids_from_boundary(boundary_from_operands([words[perm]]))
    return perm, seg


def _aggregate(table, key_indices, aggs, capacity, mats, perm, seg, num_groups, pad_payload=False):
    """The result table padded to ``capacity`` groups, and the occupied
    mask."""
    n = table.num_rows
    dev = seg.device
    starts_all = group_starts(seg, capacity + 1)
    starts = starts_all[:capacity]
    ends = starts_all[1:] - 1  # inclusive; ends < starts for empties
    sizes = (starts_all[1:] - starts).to(torch.int64).clamp(min=0)
    safe_n = max(n - 1, 0)
    occupied = torch.arange(capacity, dtype=torch.int32, device=dev) < num_groups

    # group key columns: each group's first sorted row
    rows0 = perm[starts.clamp(0, safe_n).long()]
    out_cols = []
    for ki in key_indices:
        kc = gather_column(table.columns[ki], rows0, mats.get(ki), pad_payload)
        if kc.dtype.kind == "float":
            # Spark normalizes float group keys: -0.0 -> 0.0, one NaN
            d = torch.where(kc.data == 0, torch.zeros_like(kc.data), kc.data)
            d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
            kc = Column(kc.dtype, d, kc.validity)
        out_cols.append(kc)

    perm_state = {}
    dec_totals = {}

    def col_perm(ci):
        """(permuted data or None, permuted validity, nonnull counts,
        permuted char matrix or None) of aggregate source ci."""
        if ci not in perm_state:
            c = table.columns[ci]
            data = mat_p = None
            if c.is_varlen:
                if ci not in mats:
                    mats[ci] = strs.to_char_matrix(c)
                chars, lengths = mats[ci]
                mat_p = (chars[perm], lengths[perm])
            else:
                data = c.data[perm]
            if c.validity is None:
                valid = torch.ones(n, dtype=torch.bool, device=dev)
                nonnull = sizes
            else:
                valid = c.validity[perm]
                nonnull = seg_sum(valid.to(torch.int64), seg, starts, ends)
            perm_state[ci] = (data, valid, nonnull, mat_p)
        return perm_state[ci]

    def decimal_total(ci, data, valid):
        """Exact u256 per-group sum of decimal column ci (shared by its
        sum and mean): the four 32-bit limbs of each value and its sign
        limb (the top four limbs are all the sign limb) summed, then
        carried."""
        if ci not in dec_totals:
            limbs = _decompose_limbs32(data, table.columns[ci].dtype)
            sums = [seg_sum(torch.where(valid, limb, 0), seg, starts, ends) for limb in limbs[:5]]
            dec_totals[ci] = _carry_propagate(sums + [sums[4]] * 3)
        return dec_totals[ci]

    for agg in aggs:
        if agg.op == "count" and agg.column is None:
            out_cols.append(Column(INT64, sizes))
            continue
        c = table.columns[agg.column]
        data, valid, nonnull, mat_p = col_perm(agg.column)
        rdt = _result_dtype(agg, c.dtype)
        group_validity = nonnull > 0

        if agg.op == "count":
            out_cols.append(Column(INT64, nonnull))
        elif agg.op == "sum" and c.dtype.kind == "decimal":
            total = decimal_total(agg.column, data, valid)
            overflow = ~_fits_i128(total) | u256.is_greater_than_decimal_38(total)
            out_cols.append(Column(rdt, u256.to_i128_limbs(total), group_validity & ~overflow))
        elif agg.op == "mean" and c.dtype.kind == "decimal":
            # Spark decimal avg: (sum * 10^4) / count, HALF_UP, at scale s + 4
            q, overflow = _decimal_mean_from_sum(decimal_total(agg.column, data, valid), nonnull)
            out_cols.append(Column(rdt, u256.to_i128_limbs(q), group_validity & ~overflow))
        elif agg.op in ("sum", "mean"):
            if data is None:
                raise NotImplementedError(f"{agg.op} over {c.dtype}")
            acc = torch.float64 if agg.op == "mean" or c.dtype.kind == "float" else torch.int64
            x = torch.where(valid, data, torch.zeros_like(data)).to(acc)
            s = seg_sum(x, seg, starts, ends)
            if agg.op == "mean":
                s = s / torch.clamp(nonnull, min=1).to(torch.float64)
            out_cols.append(Column(rdt, s, group_validity))
        elif agg.op in ("min", "max"):
            # one argext scan serves every dtype; nulls sit on the losing
            # side so any valid row beats them
            is_min = agg.op == "min"
            pc = Column(c.dtype, c.data, valid, c.offsets) if c.is_varlen else Column(c.dtype, data, valid)
            ops = order_keys(
                pc, ascending=True, nulls_first=not is_min, char_matrix=mat_p, force_null_key=True
            )
            win = seg_scan_argext(ops, seg, is_max=not is_min)
            win_g = win[ends.clamp(0, safe_n).long()]
            orig_rows = perm[win_g.clamp(0, safe_n).long()]
            if fused():
                # no payload-size sync in a fused chain: gather from the
                # pinned-width char matrix into a capacity-sized payload
                kc = gather_column(c, orig_rows, mats.get(agg.column), True)
            else:
                kc = gather_column(c, orig_rows)
            out_cols.append(Column(rdt, kc.data, group_validity, kc.offsets))
        else:
            raise ValueError(f"unknown aggregate op {agg.op!r}")

    # padded slots: mark invalid so downstream masking is uniform
    out_cols = [
        Column(c.dtype, c.data, occupied if c.validity is None else (c.validity & occupied), c.offsets)
        for c in out_cols
    ]
    return Table(out_cols), occupied


def _empty_column(dt: DType, rows: int, validity, dev) -> Column:
    if not dt.is_fixed_width:
        return Column(
            dt,
            torch.zeros(0, dtype=torch.uint8, device=dev),
            validity,
            torch.zeros(rows + 1, dtype=torch.int32, device=dev),
        )
    shape = (rows, 2) if dt.num_limbs == 2 else (rows,)
    return Column(dt, torch.zeros(shape, dtype=dt.torch_dtype, device=dev), validity)


def _empty_padded(table, key_indices, aggs, capacity):
    """group_by_padded on an empty table."""
    dev = table.columns[0].device
    occupied = torch.zeros(capacity, dtype=torch.bool, device=dev)
    out_cols = [_empty_column(table.columns[ki].dtype, capacity, occupied, dev) for ki in key_indices]
    for a in aggs:
        dt = _result_dtype(a, None if a.column is None else table.columns[a.column].dtype)
        validity = None if (a.op == "count" and dt.is_fixed_width) else occupied
        out_cols.append(_empty_column(dt, capacity, validity, dev))
    return Table(out_cols), occupied, torch.zeros((), dtype=torch.int32, device=dev)


def group_by_padded(
    table: Table,
    key_indices: Tuple[int, ...],
    aggs: Tuple[Agg, ...],
    capacity: int,
    key_mats=None,
    pad_payload: bool = False,
):
    """Returns (result Table padded to ``capacity``, occupied bool
    [capacity], num_groups int32 scalar tensor). Groups beyond
    ``capacity`` are dropped; the first ``capacity`` groups in key order
    stay exact.

    ``key_mats`` (column index -> (chars, lengths)) supplies the string
    key columns' char matrices; without it each is built here (one host
    sync for its width). ``pad_payload=True`` gives string key outputs a
    payload of capacity x matrix width bytes instead of the exact size."""
    if table.num_rows == 0:
        return _empty_padded(table, key_indices, aggs, capacity)
    mats = dict(key_mats) if key_mats is not None else _string_key_matrices(table, key_indices)
    perm, seg = _sorted_groups(table, key_indices, mats)
    num_groups = seg[-1] + 1
    result, occupied = _aggregate(
        table, key_indices, aggs, capacity, mats, perm, seg, num_groups, pad_payload
    )
    return result, occupied, num_groups


def group_by(
    table: Table,
    key_indices: Sequence[int],
    aggs: Sequence[Agg],
    capacity: Optional[int] = None,
) -> Table:
    """GROUP BY: a compact result table (one row per group, key columns
    first, then one column per aggregate). Raises if ``capacity`` is
    given and the data has more groups."""
    n = table.num_rows
    if n == 0:
        dev = table.columns[0].device
        cols = [_empty_column(table.columns[ki].dtype, 0, None, dev) for ki in key_indices]
        for a in aggs:
            dt = _result_dtype(a, None if a.column is None else table.columns[a.column].dtype)
            cols.append(_empty_column(dt, 0, None, dev))
        return Table(cols)
    mats = _string_key_matrices(table, key_indices)
    perm, seg = _sorted_groups(table, key_indices, mats)
    # size staging: one deliberate host sync reads the group count
    g = int(seg[-1]) + 1
    if capacity is not None and g > capacity:
        raise ValueError(f"{g} groups exceed capacity {capacity}")
    result, _occupied = _aggregate(table, key_indices, aggs, g, mats, perm, seg, g)
    return result
