"""Carry a table across from numpy and back.

This system has no weights; what crosses from the JAX package (or any
Arrow producer) into the port is column data. The form is one dict per
column::

    {"dtype": (kind, bits, precision, scale),
     "data": np.ndarray, "validity": np.ndarray | None,
     "offsets": np.ndarray | None}

with the layout of ``columnar/column.py``: fixed-width ``data`` is
``[n]`` (``[n, 2]`` int64 limbs for DECIMAL128), varlen ``data`` is the
uint8 payload with int32 ``[n + 1]`` offsets, validity is bool ``[n]``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .column import Column, resolve_device
from .dtypes import DType
from .table import Table


def _to_device(arr, np_dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np_dtype, copy=True)).to(dev)


def column_from_numpy(spec: Dict, device="cuda") -> Column:
    dev = resolve_device(device)
    dtype = DType(*spec["dtype"])
    validity = spec.get("validity")
    v = None if validity is None else _to_device(validity, np.bool_, dev)
    if dtype.kind in ("string", "binary"):
        return Column(
            dtype,
            _to_device(spec["data"], np.uint8, dev),
            v,
            _to_device(spec["offsets"], np.int32, dev),
        )
    return Column(dtype, _to_device(spec["data"], dtype.np_dtype, dev), v)


def table_from_numpy(columns: Sequence[Dict], device="cuda") -> Table:
    """Table on ``device`` from per-column numpy dicts (see module doc)."""
    return Table([column_from_numpy(spec, device) for spec in columns])


def column_to_numpy(col: Column) -> Dict:
    dt = col.dtype
    return {
        "dtype": (dt.kind, dt.bits, dt.precision, dt.scale),
        "data": col.data.cpu().numpy(),
        "validity": None if col.validity is None else col.validity.cpu().numpy(),
        "offsets": None if col.offsets is None else col.offsets.cpu().numpy(),
    }


def table_to_numpy(table: Table) -> List[Dict]:
    """Per-column numpy dicts of ``table`` (the inverse of
    ``table_from_numpy``)."""
    return [column_to_numpy(c) for c in table.columns]
