"""Row filtering, the WHERE clause (PyTorch twin of the JAX package's
``ops/filter.py``): the kept rows' indices, then one gather. Null
predicate rows drop (Spark WHERE semantics: NULL is not TRUE)."""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..columnar.table import Table
from .sort import gather


def filter_table(table: Table, predicate: Column | torch.Tensor) -> Table:
    """Keep rows where the predicate is TRUE (nulls drop)."""
    if isinstance(predicate, Column):
        mask = predicate.data.to(torch.bool)
        if predicate.validity is not None:
            mask = mask & predicate.validity
    else:
        mask = predicate.to(torch.bool)
    if mask.shape[0] != table.num_rows:
        raise ValueError(f"predicate has {mask.shape[0]} rows, table {table.num_rows}")
    # size staging: one deliberate host sync (the kept count sizes the
    # index list), as in the JAX package's filter_table
    idx = torch.nonzero(mask).squeeze(1)
    return gather(table, idx)
