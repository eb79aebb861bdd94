"""Window functions over sorted partitions (PyTorch twin of the JAX
package's ``ops/window.py``).

One multi-key sort (partition keys, then order keys), then every
window function is a segmented scan over the sorted runs, then one
back-gather to the input row order (Spark's window-exec contract):

  row_number    idx - partition_start + 1
  rank          last order-key change - partition_start + 1
  dense_rank    1 + segmented count of order-key changes
  sum/count/
  min/max       running frame (UNBOUNDED PRECEDING..CURRENT ROW) = a
                forward segmented scan; the whole partition = forward
                + backward scans combined
  lead/lag      a static shift with a partition guard

The scans are the JAX package's Hillis-Steele passes (log2(n) shifted
combines), so float sums add in its order and match it bit for bit.

Two cases follow Spark where the JAX package fails (ROADMAP Queue 3,
defects 1-2): ``WindowSpec('count')`` with ``col=None`` is count(*),
and lead/lag with an offset of at least the row count is all null.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..columnar.column import Column
from ..columnar.dtypes import INT32, INT64
from ..columnar.table import Table
from . import segmented as seg_ops
from .sort import SortKey, _string_key_matrices, gather, order_keys, sort_order


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """One window function over the shared partition/order clause.

    kind: row_number | rank | dense_rank | sum | count | min | max |
          lead | lag | first_value | last_value
    col: input column index (None for row_number/rank/dense_rank/count(*))
    frame: 'running' (UNBOUNDED PRECEDING..CURRENT ROW, Spark's default
           with an ORDER BY) or 'partition' (UNBOUNDED..UNBOUNDED) —
           aggregates only
    offset: lead/lag distance (positive)
    """

    kind: str
    col: Optional[int] = None
    frame: str = "running"
    offset: int = 1


def _cummax_start(markers: torch.Tensor) -> torch.Tensor:
    """int32 [n]: position of the last marked row at or before i (0
    before the first mark)."""
    idx = torch.arange(markers.shape[0], dtype=torch.int32, device=markers.device)
    return torch.cummax(torch.where(markers, idx, 0), dim=0).values


def _seg_scan(x: torch.Tensor, boundary: torch.Tensor, op: str) -> torch.Tensor:
    """Inclusive forward segmented scan with a reset at boundaries:
    Hillis-Steele, log2(n) shifted combines, all elementwise."""
    n = x.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    start = _cummax_start(boundary)
    acc = x
    shift = 1
    while shift < n:
        # filler values in the first `shift` slots are never taken
        prev = torch.cat([acc[:shift], acc[:-shift]])
        take = (idx - shift) >= start
        if op == "sum":
            acc = torch.where(take, acc + prev, acc)
        elif op == "min":
            acc = torch.where(take, torch.minimum(acc, prev), acc)
        elif op == "max":
            acc = torch.where(take, torch.maximum(acc, prev), acc)
        else:
            raise ValueError(op)
        shift *= 2
    return acc


def _shift_k(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """``x`` shifted by ``k`` rows (k > 0: down, lag; k < 0: up, lead),
    ``fill`` in the vacated rows; |k| >= n leaves only fill."""
    n = x.shape[0]
    if k == 0:
        return x
    if abs(k) >= n:
        return torch.full_like(x, fill)
    pad = torch.full((abs(k),) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    if k > 0:  # lag
        return torch.cat([pad, x[:-k]])
    return torch.cat([x[-k:], pad])  # lead


_RANKING = ("row_number", "rank", "dense_rank")


def _spec_out_dtype(spec: WindowSpec, table: Table):
    if spec.kind in _RANKING:
        return INT32
    if spec.kind == "count":
        return INT64
    return table.columns[spec.col].dtype


def _check_spec_types(table: Table, specs):
    for spec in specs:
        if spec.kind in _RANKING or spec.col is None:
            continue  # count(*) reads no column
        col = table.columns[spec.col]
        if col.is_varlen or col.dtype.num_limbs != 1:
            # multi-limb (DECIMAL128) aggregation needs carry-aware limb
            # arithmetic; varlen values cannot ride the scans
            raise NotImplementedError(
                f"window {spec.kind} over {col.dtype} is not supported "
                "(single-limb fixed-width columns only)"
            )


def window(
    table: Table,
    partition_by: Sequence[int],
    order_by: Sequence[SortKey],
    specs: Sequence[WindowSpec],
):
    """Evaluate ``specs`` over PARTITION BY partition_by ORDER BY
    order_by; returns one Column per spec, in the table's input row
    order (Spark window-exec contract)."""
    n = table.num_rows
    specs = tuple(specs)
    _check_spec_types(table, specs)
    if n == 0:
        dev = table.columns[0].device
        return [
            Column(dt, torch.zeros((0,), dtype=dt.torch_dtype, device=dev), None)
            for dt in (_spec_out_dtype(s, table) for s in specs)
        ]
    return _window_impl(table, tuple(partition_by), tuple(order_by), specs)


def _window_impl(table: Table, partition_by: tuple, order_by: tuple, specs: tuple):
    n = table.num_rows
    dev = table.columns[0].device
    part_keys = [SortKey(c) for c in partition_by]
    mats = _string_key_matrices(table, [k.column for k in part_keys + list(order_by)])
    perm = sort_order(table, part_keys + list(order_by), mats)
    sorted_tbl = gather(table, perm)
    smats = {ci: (m[0][perm.long()], m[1][perm.long()]) for ci, m in mats.items()}

    # partition boundaries from the sorted partition-key operands;
    # order-key changes from partition + order operands
    def operands(keys):
        ops = []
        for k in keys:
            ops.extend(
                order_keys(sorted_tbl.columns[k.column], k.ascending, k.nulls_first_resolved,
                           smats.get(k.column))
            )
        return ops

    p_ops = operands(part_keys)
    o_ops = p_ops + operands(order_by)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    pb = seg_ops.boundary_from_operands(p_ops) if p_ops else idx == 0
    ob = seg_ops.boundary_from_operands(o_ops) if order_by else pb

    p_start = _cummax_start(pb)
    o_start = _cummax_start(ob | pb)  # rank: last order-key change at or before i

    inv = torch.empty(n, dtype=torch.int64, device=dev)
    inv[perm.long()] = torch.arange(n, dtype=torch.int64, device=dev)

    def unsort(arr):
        return arr[inv]

    def rev_scan_sum(x):
        return _seg_scan(x.flip(0), _next_boundary_rev(pb), "sum").flip(0)

    out = []
    for spec in specs:
        k = spec.kind
        if k == "row_number":
            out.append(Column(INT32, unsort(idx - p_start + 1), None))
            continue
        if k == "rank":
            out.append(Column(INT32, unsort(o_start - p_start + 1), None))
            continue
        if k == "dense_rank":
            oc = (ob & ~pb).to(torch.int32)
            vals = seg_ops.seg_cumsum(oc, seg_ops.seg_ids_from_boundary(pb)) + 1
            out.append(Column(INT32, unsort(vals.to(torch.int32)), None))
            continue
        src = sorted_tbl.columns[spec.col] if spec.col is not None else None
        if k == "count":
            x = (
                torch.ones(n, dtype=torch.int64, device=dev)
                if src is None
                else src.validity_or_true().to(torch.int64)
            )
            vals = _seg_scan(x, pb, "sum")
            if spec.frame == "partition":
                vals = vals + rev_scan_sum(x) - x
            out.append(Column(INT64, unsort(vals), None))
            continue
        if k in ("sum", "min", "max"):
            data, valid = src.data, src.validity
            if k == "sum":
                x = data if valid is None else torch.where(valid, data, torch.zeros_like(data))
                vals = _seg_scan(x, pb, "sum")
                if spec.frame == "partition":
                    vals = vals + rev_scan_sum(x) - x
            else:
                if data.is_floating_point():
                    ident = float("inf") if k == "min" else float("-inf")
                else:
                    info = torch.iinfo(data.dtype)
                    ident = info.max if k == "min" else info.min
                x = data if valid is None else torch.where(valid, data, torch.full_like(data, ident))
                vals = _seg_scan(x, pb, k)
                if spec.frame == "partition":
                    bwd = _seg_scan(x.flip(0), _next_boundary_rev(pb), k).flip(0)
                    vals = torch.minimum(vals, bwd) if k == "min" else torch.maximum(vals, bwd)
            # validity: any valid row so far in the frame (running) or in
            # the partition; SQL aggregates over all-null frames are null
            if valid is None:
                out_valid = None
            else:
                v32 = valid.to(torch.int32)
                seen = _seg_scan(v32, pb, "sum")
                if spec.frame == "partition":
                    seen = seen + rev_scan_sum(v32) - v32
                out_valid = unsort(seen > 0)
            out.append(Column(src.dtype, unsort(vals), out_valid))
            continue
        if k in ("lead", "lag"):
            kk = spec.offset if k == "lag" else -spec.offset
            shifted = _shift_k(src.data, kk, 0)
            same = _shift_k(p_start, kk, -1) == p_start  # source row in the same partition
            in_bounds = (idx - spec.offset >= 0) if k == "lag" else (idx + spec.offset < n)
            ok = same & in_bounds
            sh_valid = _shift_k(src.validity_or_true(), kk, False)
            out.append(
                Column(src.dtype, unsort(torch.where(ok, shifted, torch.zeros_like(shifted))),
                       unsort(ok & sh_valid))
            )
            continue
        if k in ("first_value", "last_value"):
            # first: the value at the partition start carried forward;
            # last over the running frame is the current row; last over
            # the whole partition is first_value of the reversed scan
            base_valid = src.validity
            if k == "first_value":
                vals = _carry_value(pb, src.data)
                vv = None if base_valid is None else _carry_value(pb, base_valid)
            elif spec.frame == "partition":
                rb = _next_boundary_rev(pb)
                vals = _carry_value(rb, src.data.flip(0)).flip(0)
                vv = None if base_valid is None else _carry_value(rb, base_valid.flip(0)).flip(0)
            else:
                vals, vv = src.data, base_valid
            out.append(Column(src.dtype, unsort(vals), None if vv is None else unsort(vv)))
            continue
        raise ValueError(f"unsupported window function: {k}")
    return out


def _next_boundary_rev(pb: torch.Tensor) -> torch.Tensor:
    """Boundary flags for the REVERSED array: a segment's last row (the
    next row starts a new segment, or the input ends)."""
    last = torch.cat([pb[1:], torch.ones(1, dtype=pb.dtype, device=pb.device)])
    return last.flip(0)


def _carry_value(markers: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` at the last marker <= i, via one gather of the carried
    marker positions."""
    return values[_cummax_start(markers).long()]
