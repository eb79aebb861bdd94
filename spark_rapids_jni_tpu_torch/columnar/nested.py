"""Nested (list / struct) device columns (the port's twin of the JAX
package's ``columnar/nested.py``).

The Arrow-style nesting the MapUtils surface and the nested Parquet
reader need: from_json returns ``List<Struct<String,String>>`` (the
reference's map_utils.cu:623-632 assembles lists of structs of two
string children; MapUtils.java:33-41), and a nested Parquet root
assembles into these.

- ``StructColumn``: children share the row axis; struct-level validity
  ANDs over child access at read time (children keep their own masks).
- ``ListColumn``: ``offsets`` int32 [n+1] into the child's row axis,
  plus list-level validity.

Plain dataclasses over tensors: torch needs no pytree registration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _valid_host(validity: Optional[torch.Tensor], n: int) -> np.ndarray:
    if validity is None:
        return np.ones(n, np.bool_)
    return validity.cpu().numpy()


@dataclasses.dataclass
class StructColumn:
    children: Tuple[Any, ...]
    validity: Optional[torch.Tensor] = None  # bool [n]; None => all valid
    names: Tuple[str, ...] = ()

    def __len__(self) -> int:
        return len(self.children[0])

    def validity_or_true(self) -> torch.Tensor:
        if self.validity is not None:
            return self.validity
        return torch.ones(len(self), dtype=torch.bool, device=self.device)

    @property
    def device(self) -> torch.device:
        return self.children[0].device

    def to_pylist(self):
        cols = [c.to_pylist() for c in self.children]
        valid = _valid_host(self.validity, len(self))
        return [tuple(c[i] for c in cols) if valid[i] else None for i in range(len(self))]


@dataclasses.dataclass
class ListColumn:
    offsets: torch.Tensor  # int32 [n+1] into child rows
    child: Any  # Column / StructColumn / ListColumn
    validity: Optional[torch.Tensor] = None  # bool [n]; None => all valid

    def __len__(self) -> int:
        return int(self.offsets.shape[0]) - 1

    def validity_or_true(self) -> torch.Tensor:
        if self.validity is not None:
            return self.validity
        return torch.ones(len(self), dtype=torch.bool, device=self.device)

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to_pylist(self):
        kid = self.child.to_pylist()
        offs = self.offsets.cpu().numpy()
        valid = _valid_host(self.validity, len(self))
        return [
            list(kid[offs[i] : offs[i + 1]]) if valid[i] else None for i in range(len(self))
        ]
