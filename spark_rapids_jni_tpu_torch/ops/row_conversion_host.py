"""Host JCUDF row codec over the native C++ library (the port's twin of
the JAX package's ``ops/row_conversion_host.py``).

The reference's row conversion exists so a CPU can consume accelerator
tables (UDF fallback and interop; reference RowConversion.java:44-117
spells out the layout). ``ops/row_conversion.py`` is the device half;
this module is the host half: numpy in, numpy out, no device, backed by
``native/jcudf_rows.cpp`` (``sp_jcudf_encode_fixed``,
``sp_jcudf_decode_fixed``). The port compiles that one source into its
own library (``kernels/_build.py``) and loads it with ``ctypes``. Both
halves write the same bytes (tests/test_torch_row_conversion_host.py).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from ..columnar.dtypes import DType
from ..kernels import _build
from .row_conversion import RowLayout, compute_row_layout

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("jcudf_rows")
    lib.sp_jcudf_encode_fixed.restype = ctypes.c_int32
    lib.sp_jcudf_encode_fixed.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(_U8P), _I32P, _I32P, ctypes.POINTER(_U8P),
        ctypes.c_int32, ctypes.c_int32, _U8P,
    ]
    lib.sp_jcudf_decode_fixed.restype = ctypes.c_int32
    lib.sp_jcudf_decode_fixed.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _U8P, _I32P, _I32P, ctypes.c_int32, ctypes.POINTER(_U8P), ctypes.POINTER(_U8P),
    ]
    return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _fixed_layout(dtypes: Sequence[DType]) -> RowLayout:
    layout = compute_row_layout(list(dtypes))
    if layout.var_cols:
        raise TypeError(
            "host JCUDF codec handles fixed-width schemas; route "
            "variable-width tables through ops/row_conversion.py"
        )
    return layout


def encode_rows(
    datas: Sequence[np.ndarray],
    dtypes: Sequence[DType],
    valids: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> np.ndarray:
    """Fixed-width numpy columns -> JCUDF row bytes, uint8 [n, row_size].

    ``datas[i]`` is the little-endian element buffer of column i
    (DECIMAL128 as [n, 2] int64 limbs); ``valids[i]`` a bool mask or
    None for all-valid."""
    layout = _fixed_layout(dtypes)
    ncols = len(layout.col_sizes)
    n = len(datas[0]) if ncols else 0
    bufs = [np.ascontiguousarray(d) for d in datas]
    # the C ABI carries no buffer lengths: short or wrong-dtype buffers
    # are caught here, before the copies
    for i, b in enumerate(bufs):
        want = n * layout.col_sizes[i]
        if b.nbytes != want:
            raise ValueError(
                f"column {i}: buffer holds {b.nbytes} bytes, layout expects {want} "
                f"(n_rows={n} x {layout.col_sizes[i]}B for {dtypes[i]})"
            )
    vbufs = []  # keeps the validity buffers alive through the call
    valid_ptrs = (_U8P * ncols)()
    for i in range(ncols):
        v = None if valids is None else valids[i]
        if v is None:
            valid_ptrs[i] = ctypes.cast(None, _U8P)
            continue
        vb = np.ascontiguousarray(np.asarray(v, np.uint8))
        if vb.size != n:
            raise ValueError(f"column {i}: validity has {vb.size} rows, data has {n}")
        vbufs.append(vb)
        valid_ptrs[i] = _u8p(vb)
    sizes = np.asarray(layout.col_sizes, np.int32)
    offs = np.asarray(layout.col_starts, np.int32)
    data_ptrs = (_U8P * ncols)(*[_u8p(b.view(np.uint8)) for b in bufs])
    out = np.empty((n, layout.fixed_only_row_size), np.uint8)
    rc = _lib().sp_jcudf_encode_fixed(
        n, ncols, layout.fixed_only_row_size, data_ptrs, _i32p(sizes), _i32p(offs),
        valid_ptrs, layout.validity_offset, layout.validity_bytes, _u8p(out.reshape(-1)),
    )
    if rc != 0:
        raise ValueError(f"jcudf encode failed (code {rc})")
    return out


def decode_rows(rows: np.ndarray, dtypes: Sequence[DType]):
    """JCUDF row bytes [n, row_size] (or flat) -> (datas, valids), lists
    of numpy arrays; every validity is a bool array."""
    layout = _fixed_layout(dtypes)
    row_size = layout.fixed_only_row_size
    rows = np.ascontiguousarray(rows, np.uint8)
    if rows.ndim == 1:
        if rows.size % row_size:
            raise ValueError("row buffer size not a multiple of row size")
        rows = rows.reshape(-1, row_size)
    if rows.shape[1] != row_size:
        raise ValueError(f"row width {rows.shape[1]} != layout width {row_size}")
    n, ncols = rows.shape[0], len(layout.col_sizes)
    datas: List[np.ndarray] = []
    valids: List[np.ndarray] = []
    data_ptrs = (_U8P * ncols)()
    valid_ptrs = (_U8P * ncols)()
    for i, dt in enumerate(dtypes):
        d = np.empty((n, 2) if dt.num_limbs == 2 else (n,), dt.np_dtype)
        v = np.empty(n, np.uint8)
        datas.append(d)
        valids.append(v)
        data_ptrs[i] = _u8p(d.view(np.uint8).reshape(-1))
        valid_ptrs[i] = _u8p(v)
    sizes = np.asarray(layout.col_sizes, np.int32)
    offs = np.asarray(layout.col_starts, np.int32)
    rc = _lib().sp_jcudf_decode_fixed(
        n, ncols, row_size, _u8p(rows.reshape(-1)), _i32p(sizes), _i32p(offs),
        layout.validity_offset, data_ptrs, valid_ptrs,
    )
    if rc != 0:
        raise ValueError(f"jcudf decode failed (code {rc})")
    return datas, [v.astype(bool) for v in valids]
