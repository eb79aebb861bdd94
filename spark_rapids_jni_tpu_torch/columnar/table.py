"""Device Table: an ordered collection of equal-length Columns (PyTorch
twin of the JAX package's ``columnar/table.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from .column import Column


@dataclasses.dataclass
class Table:
    columns: List[Column]

    def __post_init__(self):
        lens = {len(c) for c in self.columns}
        if len(lens) > 1:
            raise ValueError(f"columns have unequal lengths: {sorted(lens)}")

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def num_rows(self) -> int:
        return 0 if not self.columns else len(self.columns[0])

    def to_pylists(self) -> List[list]:
        return [c.to_pylist() for c in self.columns]

    @staticmethod
    def from_pylists(cols: Sequence[Sequence], dtypes, device="cuda") -> "Table":
        return Table([Column.from_pylist(v, t, device=device) for v, t in zip(cols, dtypes)])
