"""Delta-Lake clustering: Z-order bit interleave and Hilbert index
(PyTorch twin of the JAX package's ``ops/zorder.py``; reference:
src/main/cpp/src/zorder.cu interleave_bits:132-215, hilbert_index
:217-264, Skilling transform :87-125; Java API ZOrder.java:41-88).

The interleave is a dense bit transpose: every column unpacks to an
MSB-first ``[rows, nbits]`` bit matrix, the columns stack to
``[rows, nbits, ncols]`` (whose row-major flattening is the
interleaved bit order), and each run of 8 bits packs back to a byte
with integer weights. The Hilbert transform's bit counts are static
per call, so the Skilling loops unroll into straight-line lane ops over
all rows at once.

Torch on CUDA has no usable shifts for uint32 or uint64: the interleave
reads each column's storage as bytes (``Tensor.view(torch.uint8)``) and
shifts uint8, and the Hilbert lanes ride as non-negative int64 whose
bit 63 lands in the int64 sign bit, which is the JAX package's
uint64 -> int64 reinterpretation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar.column import Column, resolve_device
from ..columnar.dtypes import BINARY, INT64
from ..columnar.table import Table

def _to_bits_msb_first(col: Column) -> torch.Tensor:
    """uint8 [rows, nbits] 0/1 bit matrix of the raw storage bytes read
    big-endian (bit-reinterpreted, so floats interleave their IEEE-754
    pattern like the reference's raw byte reads, zorder.cu:190-197),
    most significant bit first; null rows read as 0. The bytes are
    the storage's own (``Tensor.view(torch.uint8)``, little-endian,
    DECIMAL128's lo limb first), reversed to big-endian; each byte
    unpacks with uint8 shifts."""
    n = len(col)
    raw = col.data.contiguous().view(torch.uint8).reshape(n, -1).flip(1)
    if col.validity is not None:
        raw = torch.where(col.validity[:, None], raw, 0)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=raw.device)
    return ((raw[:, :, None] >> shifts) & 1).reshape(n, -1)


def _interleave(bit_planes: torch.Tensor) -> torch.Tensor:
    """bit_planes: uint8 [rows, nbits, ncols] -> packed uint8
    [rows * nbits * ncols / 8]. Row-major flattening of (bit, col) is
    the interleaved MSB-first bit stream (column 0 most significant,
    zorder.cu:183-186)."""
    rows = bit_planes.shape[0]
    by = bit_planes.reshape(rows, -1, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=by.device)
    return (by * weights).sum(dim=-1, dtype=torch.uint8).reshape(-1)


def interleave_bits(tbl: Table, num_rows: int = None, device="cuda") -> Column:
    """Z-order interleave: list<uint8> column, one ``ncols * sizeof(T)``
    byte entry per row (ZOrder.java:41-55; zorder.cu:132-215). With no
    input columns, emits ``num_rows`` empty entries (ZOrder.java:42-47)
    on ``device``; otherwise the result lies on the columns' device."""
    if tbl.num_columns == 0:
        n = num_rows or 0
        dev = resolve_device(device)
        return Column(
            BINARY,
            torch.zeros(0, dtype=torch.uint8, device=dev),
            None,
            torch.zeros(n + 1, dtype=torch.int32, device=dev),
        )
    t0 = tbl.columns[0].dtype
    if not t0.is_fixed_width:
        raise TypeError("Only fixed width columns can be used")
    for c in tbl.columns:
        if (c.dtype.kind, c.dtype.bits) != (t0.kind, t0.bits):
            raise TypeError("All columns of the input table must be the same type.")
    num_rows = tbl.num_rows
    ncols = tbl.num_columns
    stride = t0.size_bytes * ncols
    if num_rows * stride > 2**31 - 1:
        raise ValueError("Input is too large to process")
    dev = tbl.columns[0].device
    if num_rows == 0:
        return Column(
            BINARY,
            torch.zeros(0, dtype=torch.uint8, device=dev),
            None,
            torch.zeros(1, dtype=torch.int32, device=dev),
        )
    planes = torch.stack([_to_bits_msb_first(c) for c in tbl.columns], dim=2)
    payload = _interleave(planes)
    offsets = torch.arange(num_rows + 1, dtype=torch.int32, device=dev) * stride
    return Column(BINARY, payload, None, offsets)


# ---------------------------------------------------------------------------
# Hilbert


def _hilbert(data, valid, num_bits: int, ncols: int) -> torch.Tensor:
    """Skilling transposed index + bit distribution, unrolled over the
    static (num_bits, ncols) grid; all row lanes in parallel
    (zorder.cu hilbert_transposed_index:87-125, to_hilbert_index:68-85).
    The uint32 lanes of the JAX package ride as non-negative int64."""
    mask = (1 << num_bits) - 1
    x = [
        torch.where(valid[i], data[i].to(torch.int64) & mask, 0)
        for i in range(ncols)
    ]

    m = 1 << (num_bits - 1)
    # inverse undo
    q = m
    while q > 1:
        p = q - 1
        for i in range(ncols):
            cond = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p  # 0 when i == 0
            new_x0 = torch.where(cond, x[0] ^ p, x[0] ^ t)
            if i > 0:
                x[i] = torch.where(cond, x[i], x[i] ^ t)
            x[0] = new_x0
        q >>= 1

    # gray encode
    for i in range(1, ncols):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = m
    while q > 1:
        t = torch.where((x[ncols - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(ncols):
        x[i] = x[i] ^ t

    # distribute bits: b[bit i of entry j] MSB-first across dims; bit 63
    # lands in the int64 sign bit
    b = torch.zeros_like(x[0])
    b_index = num_bits * ncols - 1
    for i in range(num_bits):
        bit = num_bits - 1 - i
        for j in range(ncols):
            b = b | (((x[j] >> bit) & 1) << b_index)
            b_index -= 1
    return b


def hilbert_index(num_bits: int, tbl: Table, num_rows: int = None, device="cuda") -> Column:
    """Hilbert curve index as INT64 (ZOrder.java:70-83; zorder.cu:217-264).
    All input columns must be INT32; nulls read as 0. With no input
    columns, a column of ``num_rows`` zero longs on ``device``."""
    if tbl.num_columns == 0:
        # ZOrder.java:73-76 corner case: a column of zero longs
        dev = resolve_device(device)
        return Column(INT64, torch.zeros(num_rows or 0, dtype=torch.int64, device=dev))
    if not (0 < num_bits <= 32):
        raise ValueError("the number of bits must be >0 and <= 32.")
    if num_bits * tbl.num_columns > 64:
        raise ValueError("we only support up to 64 bits of output right now.")
    for c in tbl.columns:
        if c.dtype.np_dtype != np.dtype(np.int32):
            raise TypeError("All columns of the input table must be INT32.")
    data = [c.data for c in tbl.columns]
    valid = [c.validity_or_true() for c in tbl.columns]
    return Column(INT64, _hilbert(data, valid, num_bits, tbl.num_columns))
