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
Nested columns (``columnar/nested.py``) nest the same dicts::

    {"list": child, "offsets": np.ndarray, "validity": ...}
    {"struct": [child, ...], "names": (...), "validity": ...}
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .column import Column, resolve_device
from .dtypes import DType
from .nested import ListColumn, StructColumn
from .table import Table


def _to_device(arr, np_dtype, dev, pinned=False) -> torch.Tensor:
    if not pinned:
        return torch.from_numpy(np.array(arr, np_dtype, copy=True)).to(dev)
    src = np.asarray(arr, np_dtype)
    host = torch.empty(src.shape, dtype=torch.from_numpy(src[:0]).dtype, pin_memory=True)
    host.numpy()[...] = src
    return host.to(dev, non_blocking=True)


def column_from_numpy(spec: Dict, device="cuda", pinned=False):
    """Column on ``device`` from one numpy dict. ``pinned`` stages each
    array through page-locked host memory and copies it without
    blocking, on the current stream (the caller orders its use)."""
    dev = resolve_device(device)
    validity = spec.get("validity")
    v = None if validity is None else _to_device(validity, np.bool_, dev, pinned)
    if "list" in spec:
        return ListColumn(
            _to_device(spec["offsets"], np.int32, dev, pinned),
            column_from_numpy(spec["list"], dev, pinned),
            v,
        )
    if "struct" in spec:
        kids = tuple(column_from_numpy(c, dev, pinned) for c in spec["struct"])
        return StructColumn(kids, v, tuple(spec["names"]))
    dtype = DType(*spec["dtype"])
    if dtype.kind in ("string", "binary"):
        return Column(
            dtype,
            _to_device(spec["data"], np.uint8, dev, pinned),
            v,
            _to_device(spec["offsets"], np.int32, dev, pinned),
        )
    return Column(dtype, _to_device(spec["data"], dtype.np_dtype, dev, pinned), v)


def table_from_numpy(columns: Sequence[Dict], device="cuda", pinned=False) -> Table:
    """Table on ``device`` from per-column numpy dicts (see module doc);
    ``pinned`` as in ``column_from_numpy``."""
    return Table([column_from_numpy(spec, device, pinned) for spec in columns])


def _host(t):
    return None if t is None else t.cpu().numpy()


def column_to_numpy(col) -> Dict:
    if isinstance(col, ListColumn):
        return {"list": column_to_numpy(col.child), "offsets": _host(col.offsets),
                "validity": _host(col.validity)}
    if isinstance(col, StructColumn):
        return {"struct": [column_to_numpy(c) for c in col.children], "names": col.names,
                "validity": _host(col.validity)}
    dt = col.dtype
    return {
        "dtype": (dt.kind, dt.bits, dt.precision, dt.scale),
        "data": _host(col.data),
        "validity": _host(col.validity),
        "offsets": _host(col.offsets),
    }


def table_to_numpy(table: Table) -> List[Dict]:
    """Per-column numpy dicts of ``table`` (the inverse of
    ``table_from_numpy``)."""
    return [column_to_numpy(c) for c in table.columns]
