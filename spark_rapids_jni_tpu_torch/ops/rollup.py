"""ROLLUP / GROUPING SETS aggregation on the group-by operator (PyTorch
twin of the JAX package's ``ops/rollup.py``).

Spark lowers ROLLUP(a, b, c) to an Expand of k+1 projections followed
by one hash aggregate over n * (k+1) rows. Here, as in the JAX
package, each grouping set is its own sort-based group-by over the
original n rows; the results are unioned with the dropped key columns
null-filled and a Spark-convention grouping id attached.

One case follows Spark where the JAX package does not (ROADMAP Queue 3,
defect 3): the empty grouping set over 0 rows is Spark's one
grand-total row (counts 0, every other aggregate null), not 0 rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..columnar.column import Column
from ..columnar.dtypes import INT32
from ..columnar.table import Table
from .aggregate import Agg, _empty_column, _result_dtype, group_by
from .row_conversion import _concat_col


def _null_key_like(col: Column, rows: int) -> Column:
    """An all-null column of col's dtype with ``rows`` rows."""
    dev = col.device
    invalid = torch.zeros(rows, dtype=torch.bool, device=dev)
    if col.is_varlen:
        return Column(
            col.dtype,
            torch.zeros(0, dtype=torch.uint8, device=dev),
            invalid,
            torch.zeros(rows + 1, dtype=torch.int32, device=dev),
        )
    shape = (rows,) if col.dtype.num_limbs == 1 else (rows, col.dtype.num_limbs)
    return Column(col.dtype, torch.zeros(shape, dtype=col.data.dtype, device=dev), invalid)


def _concat_cols(cols: Sequence[Column]) -> Column:
    return _concat_col(list(cols))


def _grand_total_of_nothing(table: Table, aggs: Sequence[Agg]):
    """The global aggregate over 0 rows: one row, counts 0, every other
    aggregate null."""
    dev = table.columns[0].device
    cols = []
    for a in aggs:
        dt = _result_dtype(a, None if a.column is None else table.columns[a.column].dtype)
        if a.op == "count":
            cols.append(Column(dt, torch.zeros(1, dtype=torch.int64, device=dev)))
        else:
            cols.append(_empty_column(dt, 1, torch.zeros(1, dtype=torch.bool, device=dev), dev))
    return cols


def grouping_sets(
    table: Table,
    key_indices: Sequence[int],
    sets: Sequence[Sequence[int]],
    aggs: Sequence[Agg],
    capacity: Optional[int] = None,
) -> Table:
    """One group-by per grouping set, unioned. Output columns: the full
    key list (dropped keys null), one column per agg, and a trailing
    INT32 ``grouping_id`` (Spark convention: bit i set when key i is
    NOT part of the set, MSB = first key)."""
    key_indices = list(key_indices)
    dev = table.columns[0].device
    parts, gids = [], []
    k = len(key_indices)
    for subset in sets:
        subset = list(subset)
        if subset:
            res = group_by(table, subset, aggs, capacity)
            agg_cols, rows = res.columns[len(subset):], res.num_rows
        elif table.num_rows == 0:
            res, agg_cols, rows = None, _grand_total_of_nothing(table, aggs), 1
        else:
            # global aggregate: group by a synthesized constant key
            const = Column(INT32, torch.zeros(table.num_rows, dtype=torch.int32, device=dev))
            res = group_by(Table(list(table.columns) + [const]), [len(table.columns)], aggs,
                           capacity)
            agg_cols, rows = res.columns[1:], res.num_rows
        out_cols = []
        for ki in key_indices:
            if ki in subset:
                out_cols.append(res.columns[subset.index(ki)])
            else:
                out_cols.append(_null_key_like(table.columns[ki], rows))
        out_cols.extend(agg_cols)
        gid = sum(1 << (k - 1 - i) for i, ki in enumerate(key_indices) if ki not in subset)
        gids.append(torch.full((rows,), gid, dtype=torch.int32, device=dev))
        parts.append(out_cols)
    unioned = [_concat_cols([p[c] for p in parts]) for c in range(len(parts[0]))]
    unioned.append(Column(INT32, torch.cat(gids), None))
    return Table(unioned)


def rollup(
    table: Table,
    key_indices: Sequence[int],
    aggs: Sequence[Agg],
    capacity: Optional[int] = None,
) -> Table:
    """ROLLUP(k1..kn): grouping sets [k1..kn], [k1..kn-1], ..., []."""
    sets = [list(key_indices)[:i] for i in range(len(key_indices), -1, -1)]
    return grouping_sets(table, key_indices, sets, aggs, capacity)
