"""Device Table: an ordered collection of equal-length Columns (PyTorch
twin of the JAX package's ``columnar/table.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .column import Column


@dataclasses.dataclass
class Table:
    columns: List[Column]
    names: Optional[tuple] = None  # optional column names

    def __post_init__(self):
        if self.names is not None:
            self.names = tuple(self.names)
        lens = {len(c) for c in self.columns}
        if len(lens) > 1:
            raise ValueError(f"columns have unequal lengths: {sorted(lens)}")

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def num_rows(self) -> int:
        return 0 if not self.columns else len(self.columns[0])

    def column(self, i_or_name) -> Column:
        if isinstance(i_or_name, str):
            if self.names is None or i_or_name not in self.names:
                raise KeyError(f"no column named {i_or_name!r}; names={self.names}")
            return self.columns[self.names.index(i_or_name)]
        return self.columns[i_or_name]

    def __getitem__(self, i_or_name) -> Column:
        return self.column(i_or_name)

    def to_pylists(self) -> List[list]:
        return [c.to_pylist() for c in self.columns]

    # sprtcheck: host-side — a collect boundary: one batched read of the null counts
    def compact_validity(self, invalid_counts: Optional[Sequence[int]] = None) -> "Table":
        """Drop all-True validity masks. ``invalid_counts`` — the null
        count of each masked column, in column order — comes from a
        caller that already read it; otherwise one batched host sync
        reads it."""
        masked = [i for i, c in enumerate(self.columns) if c.validity is not None]
        if not masked:
            return self
        if invalid_counts is None:
            invalid_counts = torch.stack(
                [(~self.columns[i].validity).sum() for i in masked]
            ).tolist()
        cols = list(self.columns)
        for bad, i in zip(invalid_counts, masked):
            if not bad:
                c = cols[i]
                cols[i] = Column(c.dtype, c.data, None, c.offsets)
        return Table(cols, self.names)

    @staticmethod
    def from_pylists(cols: Sequence[Sequence], dtypes, names=None, device="cuda") -> "Table":
        return Table(
            [Column.from_pylist(v, t, device=device) for v, t in zip(cols, dtypes)], names
        )
