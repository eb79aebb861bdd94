"""The native JNI backend's kernel plugins (``csrc/native/``): their
builds and a wrapper per kernel family over torch tensors, with the
family's plain PyTorch version beside it.

The JNI library's native backend (``csrc/host/native_backend.cpp``)
dlopens a plugin and calls its C interface (``sprt_plugin.h``) with no
Python in the process; ``runtime/jni_backend.init_native`` registers it.
The wrappers here call the same C functions on tensors the caller
holds, on PyTorch's current stream: the port's own ops call them on
CUDA tensors (``ops/row_conversion`` for fixed-width rows,
``ops/cast_string`` for the integer and float casts, ``ops/decimal``
for add, subtract and multiply), and ``chip_smoke.py`` times each
kernel and holds it against its plain version. A wrapper launches the
CUDA plugin's kernel on CUDA tensors and takes the plain version on CPU
tensors; there is no fallback from one to the other, and a build or
launch failure raises. The plain versions are the port's own torch
code, the counterparts of the JAX functions the kernels match:

- ``cast_integer``: ``ops/cast_string._parse_integer``;
- ``cast_float64``: ``ops/cast_string._parse_float``;
- ``decimal128``: ``ops/decimal._add_sub_scales_any`` and
  ``_multiply_scales_any``;
- ``to_rows`` / ``from_rows``: ``ops/row_conversion``'s fixed-width
  layout (``compute_row_layout``, ``_fixed_section``, ``_decode_fixed``).

None of them replaces a Pallas kernel: they replace the XLA programs
``native/pjrt/export_ops.py`` exports for the JAX package's C++ PJRT
backend (``REPLACES``).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..columnar.dtypes import DType
from . import _build

# the launch counter of each family (sprt_plugin.h SPRTK_*)
FAMILIES = {"cast_integer": 0, "cast_float64": 1, "decimal128": 2, "to_rows": 3, "from_rows": 4}
# the AOT-exported program each family takes the place of
REPLACES = {
    "cast_integer": "native/pjrt/export_ops.py:135",
    "cast_float64": "native/pjrt/export_ops.py:160",
    "decimal128": "native/pjrt/export_ops.py:176",
    "to_rows": "native/pjrt/export_ops.py:202",
    "from_rows": "native/pjrt/export_ops.py:209",
}
DEC_OPS = {"add": 0, "sub": 1, "mul": 2}
NO_ROW = 0xFFFFFFFF  # status[0] when no row failed
# the string casts' tiles (sprt_rowops.h kFloatTileRows, kFloatStageSpan,
# kIntTileRows, kIntStageSpan): rows a tile, and the chars of a tile
# staged in shared memory; a row ending past them is read from global
# memory
FLOAT_TILE_ROWS = 1024
FLOAT_STAGE_SPAN = 16384 - 32
INT_TILE_ROWS = 1024
INT_STAGE_SPAN = 16384 - 32


def plugin_name(device) -> str:
    """The plugin the backend loads for ``device``: the CUDA plugin for a
    card, the host plugin only for the CPU."""
    return "sprt_native_host" if torch.device(device).type == "cpu" else "sprt_native_cuda"


def plugin_path(device) -> str:
    """The built plugin for ``device`` (compiled on first use)."""
    name = plugin_name(device)
    _build.build(name)
    return _build.library_path(name)


class RowsDesc(ctypes.Structure):
    """sprt_rowops.h ``RowsDesc``: the scalars of a row layout and
    pointers to its per-column arrays (``rows_desc`` keeps them alive
    on the object)."""

    _fields_ = [
        ("ncols", ctypes.c_int32),
        ("row_size", ctypes.c_int32),
        ("validity_offset", ctypes.c_int32),
        ("validity_bytes", ctypes.c_int32),
        ("start", ctypes.POINTER(ctypes.c_int32)),
        ("size", ctypes.POINTER(ctypes.c_int32)),
        ("data", ctypes.POINTER(ctypes.c_void_p)),
        ("valid", ctypes.POINTER(ctypes.c_void_p)),
    ]


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "sprtk_error_string": ([_I], ctypes.c_char_p),
    "sprtk_preload": ([], _I),
    "sprtk_launches": ([_I], ctypes.c_longlong),
    "sprtk_reset_launches": ([], None),
    "sprtk_row_layout": ([ctypes.POINTER(RowsDesc), _I, ctypes.POINTER(ctypes.c_int32)], _I),
    "sprtk_cast_to_integer": ([_P, _P, _P, _I64, _I, _I, _I, _P, _P, _P, _P], _I),
    "sprtk_cast_to_float64": ([_P, _P, _P, _I64, _P, _P, _P, _P], _I),
    "sprtk_decimal128": ([_I, _P, _P, _P, _P, _I64, _I, _I, _I, _P, _P, _P, _P], _I),
    "sprtk_to_rows": ([ctypes.POINTER(RowsDesc), _I64, _I64, _P, _P], _I),
    "sprtk_from_rows": ([ctypes.POINTER(RowsDesc), _P, _I64, _P], _I),
}


def plugin(name: str = "sprt_native_cuda") -> ctypes.CDLL:
    """A plugin (``sprt_native_cuda`` or ``sprt_native_host``), built on
    first use, with its signatures set and, for the CUDA plugin, every
    kernel loaded (``sprtk_preload``): a graph capture never meets a
    first load. The backend's dlopen of the same file gets the same
    image, so both share its launch counters
    (``runtime/jni_backend.native_counts`` reads them too)."""
    lib = _build.load(name)
    if getattr(lib, "_sprtk_bound", False):  # bound since _build last loaded it
        return lib
    for fn_name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = args, res
    _run(lib, "sprtk_preload")
    lib._sprtk_bound = True
    return lib


def launch_counts() -> dict:
    """The CUDA plugin's launches by kernel family (since it was loaded
    or its ``sprtk_reset_launches``)."""
    lib = plugin()
    return {name: int(lib.sprtk_launches(i)) for name, i in FAMILIES.items()}


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _run(lib, fn_name: str, *args) -> None:
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: {lib.sprtk_error_string(rc).decode()}")


def _status_plain(bad: torch.Tensor, invalid: torch.Tensor) -> torch.Tensor:
    """int64 [2]: the first bad row (NO_ROW: none) and the invalid count,
    the kernels' status words."""
    n = bad.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=bad.device)
    first = torch.where(bad, idx, torch.full_like(idx, NO_ROW)).amin() if n else idx.new_tensor(
        NO_ROW)
    return torch.stack([first, invalid.sum(dtype=torch.int64)])


def _check_strings(chars, offsets, valid):
    if chars.dtype != torch.uint8 or offsets.dtype != torch.int32:
        raise TypeError(f"strings must be uint8 bytes and int32 offsets, got {chars.dtype}, "
                        f"{offsets.dtype}")
    if valid is not None and valid.dtype != torch.bool:
        raise TypeError(f"validity must be bool, got {valid.dtype}")
    devs = {t.device for t in (chars, offsets, valid) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"the string buffers lie on several devices: {devs}")


# ---- (a) string -> INT8/16/32/64


def cast_integer_plain(chars, offsets, valid, bits: int, ansi: bool, strip: bool):
    """The plain version: ``ops/cast_string._parse_integer`` over the
    char matrix, narrowed as ``string_to_integer`` narrows. Returns
    (values, validity, status)."""
    from ..columnar.column import Column
    from ..columnar.dtypes import STRING
    from ..columnar.strings import to_char_matrix
    from ..ops.cast_string import _parse_integer

    col = Column(STRING, chars, valid, offsets)
    ch, lengths = to_char_matrix(col)
    in_valid = col.validity_or_true()
    mag, negative, ok = _parse_integer(ch, lengths, in_valid, bits, ansi, strip)
    dt = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}[bits]
    value = torch.where(negative, -mag, mag).to(dt)
    value = torch.where(ok, value, torch.zeros_like(value))
    return value, ok, _status_plain(~ok & in_valid, ~ok)


def cast_integer(chars, offsets, valid, bits: int, ansi: bool, strip: bool):
    """(values, validity, status) of the cast of each string to a
    ``bits``-wide integer: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check_strings(chars, offsets, valid)
    if bits not in (8, 16, 32, 64):
        raise ValueError(f"no {bits}-bit integer target")
    if chars.device.type == "cpu":
        return cast_integer_plain(chars, offsets, valid, bits, ansi, strip)
    n = offsets.shape[0] - 1
    dt = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}[bits]
    out = torch.empty(n, dtype=dt, device=chars.device)
    ok = torch.empty(n, dtype=torch.bool, device=chars.device)
    status = torch.empty(2, dtype=torch.int32, device=chars.device)
    with torch.cuda.device(chars.device):
        _run(plugin(), "sprtk_cast_to_integer", _ptr(chars), _ptr(offsets), _ptr(valid), n,
             bits, int(ansi), int(strip), _ptr(out), _ptr(ok), _ptr(status), _stream(chars))
    return out, ok, status.view(torch.uint32).to(torch.int64)


# ---- (b) string -> FLOAT64


def cast_float64_plain(chars, offsets, valid):
    """The plain version: ``ops/cast_string._parse_float``, with 0.0 at
    invalid rows as ``string_to_float`` gives. Returns (values,
    validity, status)."""
    from ..columnar.column import Column
    from ..columnar.dtypes import STRING
    from ..columnar.strings import to_char_matrix
    from ..ops.cast_string import _parse_float

    col = Column(STRING, chars, valid, offsets)
    ch, lengths = to_char_matrix(col)
    value, ok, except_ = _parse_float(ch, lengths, col.validity_or_true())
    value = torch.where(ok, value, 0.0)
    return value, ok, _status_plain(except_, ~ok)


def cast_float64(chars, offsets, valid):
    """(values, validity, status) of the FLOAT64 cast of each string:
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_strings(chars, offsets, valid)
    if chars.device.type == "cpu":
        return cast_float64_plain(chars, offsets, valid)
    n = offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.float64, device=chars.device)
    ok = torch.empty(n, dtype=torch.bool, device=chars.device)
    status = torch.empty(2, dtype=torch.int32, device=chars.device)
    with torch.cuda.device(chars.device):
        _run(plugin(), "sprtk_cast_to_float64", _ptr(chars), _ptr(offsets), _ptr(valid), n,
             _ptr(out), _ptr(ok), _ptr(status), _stream(chars))
    return out, ok, status.view(torch.uint32).to(torch.int64)


# ---- (c) DECIMAL128 add / subtract / multiply


def decimal128_plain(op: str, a, b, a_valid, b_valid, a_scale: int, b_scale: int,
                     out_scale: int):
    """The plain version: ``ops/decimal._add_sub_scales_any`` /
    ``_multiply_scales_any``, the overflow masked as ``_result_table``
    masks it. Returns (overflow int8, limbs int64 [n, 2], validity or
    None)."""
    from ..ops import decimal

    if op == "mul":
        overflow, limbs = decimal._multiply_scales_any(a, b, a_scale, b_scale, out_scale)
    else:
        overflow, limbs = decimal._add_sub_scales_any(a, b, a_scale, b_scale, out_scale,
                                                      op == "sub")
    valid = None
    if a_valid is not None or b_valid is not None:
        ones = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
        valid = (ones if a_valid is None else a_valid) & (ones if b_valid is None else b_valid)
        overflow = overflow & valid
    return overflow.to(torch.int8), limbs, valid


def decimal128(op: str, a, b, a_valid, b_valid, a_scale: int, b_scale: int, out_scale: int):
    """(overflow, limbs, validity) of ``a op b`` over DECIMAL128 limbs
    int64 [n, 2] at Spark scales: the kernel on CUDA tensors, the plain
    version on CPU tensors. The caller keeps the scale guards of
    ``ops/decimal`` (a rescale divisor of at most 10^38)."""
    if op not in DEC_OPS:
        raise ValueError(f"unknown decimal op {op!r}")
    for t in (a, b):
        if t.dtype != torch.int64 or t.dim() != 2 or t.shape[1] != 2 or not t.is_contiguous():
            raise TypeError("DECIMAL128 limbs must be contiguous int64 [n, 2]")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("the operands differ in rows or device")
    if a.device.type == "cpu":
        return decimal128_plain(op, a, b, a_valid, b_valid, a_scale, b_scale, out_scale)
    n = a.shape[0]
    overflow = torch.empty(n, dtype=torch.int8, device=a.device)
    out = torch.empty((n, 2), dtype=torch.int64, device=a.device)
    valid = None
    if a_valid is not None or b_valid is not None:
        valid = torch.empty(n, dtype=torch.bool, device=a.device)
    with torch.cuda.device(a.device):
        _run(plugin(), "sprtk_decimal128", DEC_OPS[op], _ptr(a), _ptr(b), _ptr(a_valid),
             _ptr(b_valid), n, a_scale, b_scale, out_scale, _ptr(overflow), _ptr(out),
             _ptr(valid), _stream(a))
    return overflow, out, valid


# ---- (d) JCUDF fixed-width rows


def rows_desc(dtypes: Sequence[DType], lib=None) -> RowsDesc:
    """The row kernels' layout of a fixed-width schema of any width (the
    plugin's ``sprtk_row_layout``, the rules of
    ``ops/row_conversion.compute_row_layout``), its data and validity
    pointers NULL."""
    n = len(dtypes)
    if n < 1 or not all(dt.is_fixed_width for dt in dtypes):
        raise ValueError("the row kernels take one or more fixed-width columns")
    sizes = (ctypes.c_int32 * n)(*[dt.size_bytes for dt in dtypes])
    d = RowsDesc()
    d._arrays = ((ctypes.c_int32 * n)(), (ctypes.c_int32 * n)(), (ctypes.c_void_p * n)(),
                 (ctypes.c_void_p * n)())
    d.start, d.size, d.data, d.valid = (ctypes.cast(a, f[1]) for a, f in
                                        zip(d._arrays, RowsDesc._fields_[4:]))
    _run(lib or plugin(), "sprtk_row_layout", ctypes.byref(d), n, sizes)
    return d


def to_rows_plain(columns) -> torch.Tensor:
    """The plain version: ``ops/row_conversion._fixed_section`` of the
    columns, uint8 [n, row_size]."""
    from ..columnar.table import Table
    from ..ops.row_conversion import _fixed_section, compute_row_layout

    table = Table(list(columns))
    layout = compute_row_layout([c.dtype for c in table.columns])
    return _fixed_section(table, layout, layout.fixed_only_row_size)


def to_rows(columns) -> torch.Tensor:
    """uint8 [n, row_size] JCUDF rows of fixed-width Columns (any
    number): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    columns = list(columns)
    dev = columns[0].data.device
    if dev.type == "cpu":
        return to_rows_plain(columns)
    d = rows_desc([c.dtype for c in columns])
    n = columns[0].data.shape[0]
    keep = []  # contiguous copies of strided buffers, alive until the launch
    for i, c in enumerate(columns):
        if c.data.device != dev or c.data.shape[0] != n:
            raise ValueError(f"column {i}: rows or device differ from column 0")
        if c.validity is not None and c.validity.dtype != torch.bool:
            raise TypeError(f"column {i}: validity must be bool, got {c.validity.dtype}")
        data = c.data.contiguous()
        valid = None if c.validity is None else c.validity.contiguous()
        keep.append((data, valid))
        d.data[i] = data.data_ptr()
        d.valid[i] = None if valid is None else valid.data_ptr()
    rows = torch.empty((n, d.row_size), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _run(plugin(), "sprtk_to_rows", ctypes.byref(d), 0, n, rows.data_ptr(), _stream(rows))
    return rows


def from_rows_plain(rows: torch.Tensor, dtypes: Sequence[DType]) -> List[Tuple]:
    """The plain version: ``ops/row_conversion._decode_fixed``; (data,
    validity) per column."""
    from ..ops.row_conversion import _decode_fixed, compute_row_layout

    schema = tuple(dtypes)
    cols, valid = _decode_fixed(rows, schema, compute_row_layout(schema))
    return [(cols[i], valid[i]) for i in range(len(schema))]


def from_rows(rows: torch.Tensor, dtypes: Sequence[DType]) -> List[Tuple]:
    """(data, validity) per column of uint8 [n, row_size] JCUDF rows:
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError("rows must be uint8 [n, row_size]")
    if rows.device.type == "cpu":
        return from_rows_plain(rows, dtypes)
    d = rows_desc(dtypes)
    if rows.shape[1] != d.row_size:
        raise TypeError(f"rows must be uint8 [n, {d.row_size}]")
    rows = rows.contiguous()
    if rows.data_ptr() % 8:  # a row buffer at an odd byte of its storage
        rows = rows.clone()
    n = rows.shape[0]
    out = []
    for i, dt in enumerate(dtypes):
        shape = (n, 2) if dt.num_limbs > 1 else (n,)
        data = torch.empty(shape, dtype=dt.torch_dtype, device=rows.device)
        valid = torch.empty(n, dtype=torch.bool, device=rows.device)
        d.data[i], d.valid[i] = data.data_ptr(), valid.data_ptr()
        out.append((data, valid))
    with torch.cuda.device(rows.device):
        _run(plugin(), "sprtk_from_rows", ctypes.byref(d), rows.data_ptr(), n, _stream(rows))
    return out
