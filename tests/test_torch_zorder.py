"""The port's ZOrder (``ops/zorder.py``, ``api.ZOrder``) against the
pure-Python oracles of tests/test_zorder.py and the JAX package's
``ops/zorder.py`` on the same numpy inputs, exactly: every fixed width,
floats by their IEEE bits, DECIMAL128 by both limbs, nulls, 0 rows,
0 columns and every error."""

import os
import random
import struct
import sys

import numpy as np
import pytest

from spark_rapids_jni_tpu.ops import zorder as jz

from spark_rapids_jni_tpu_torch import (
    DECIMAL32,
    DECIMAL64,
    DECIMAL128,
    FLOAT32,
    FLOAT64,
    INT8,
    INT16,
    INT32,
    INT64,
    STRING,
    Column,
    Table,
)
from spark_rapids_jni_tpu_torch.api import ZOrder
from spark_rapids_jni_tpu_torch.ops import zorder as pz

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity import jax_table  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


# ---- the oracles of tests/test_zorder.py


def oracle_interleave(rows, nbits):
    """rows: per-row lists of column values as unsigned ints of width
    nbits -> bytes per row (MSB first, column 0 most significant)."""
    out = []
    for row in rows:
        bits = [(v >> (nbits - 1 - b)) & 1 for b in range(nbits) for v in row]
        by = bytearray()
        for i in range(0, len(bits), 8):
            v = 0
            for bit in bits[i : i + 8]:
                v = (v << 1) | bit
            by.append(v)
        out.append(bytes(by))
    return out


def oracle_hilbert(point, num_bits):
    """Skilling 2004 'Programming the Hilbert curve', scalar."""
    n = len(point)
    x = list(point)
    m = 1 << (num_bits - 1)
    q = m
    while q > 1:
        p = q - 1
        for i in range(n):
            if x[i] & q:
                x[0] ^= p
            else:
                t = (x[0] ^ x[i]) & p
                x[0] ^= t
                x[i] ^= t
        q >>= 1
    for i in range(1, n):
        x[i] ^= x[i - 1]
    t = 0
    q = m
    while q > 1:
        if x[n - 1] & q:
            t ^= q - 1
        q >>= 1
    for i in range(n):
        x[i] ^= t
    b = 0
    for i in range(num_bits):
        for j in range(n):
            b = (b << 1) | ((x[j] >> (num_bits - 1 - i)) & 1)
    return b


def wrap64(v):
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def col(values, dtype, validity=None):
    return Column.from_numpy(values, dtype, validity=validity, device="cpu")


def spec_of(cols):
    """Interop form of port columns (for the JAX side)."""
    from spark_rapids_jni_tpu_torch.columnar.interop import table_to_numpy

    return table_to_numpy(Table(cols))


def same_as_jax(fn_port, fn_jax, cols):
    got = fn_port(Table(cols))
    want = fn_jax(jax_table(spec_of(cols)))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    if want.offsets is not None:
        np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    assert (got.validity is None) == (want.validity is None)
    return got


# ---- interleave


@pytest.mark.parametrize("dtype,nbits", [(INT8, 8), (INT16, 16), (INT32, 32), (INT64, 64)])
def test_interleave_vs_oracle_and_jax(dtype, nbits):
    rng = random.Random(nbits)
    n, ncols = 37, 3
    cols = [[rng.randrange(-(2 ** (nbits - 1)), 2 ** (nbits - 1)) for _ in range(n)]
            for _ in range(ncols)]
    tcols = [col(np.array(c, dtype.np_dtype), dtype) for c in cols]
    got = same_as_jax(pz.interleave_bits, jz.interleave_bits, tcols).to_pylist()
    rows = [[cols[c][r] & ((1 << nbits) - 1) for c in range(ncols)] for r in range(n)]
    assert got == oracle_interleave(rows, nbits)


def test_interleave_single_column_identity():
    vals = [0, 1, 255, -1, 1234567, -1234567]
    got = pz.interleave_bits(Table([Column.from_pylist(vals, INT32, device="cpu")])).to_pylist()
    assert got == [(v & 0xFFFFFFFF).to_bytes(4, "big") for v in vals]


def test_interleave_known_pattern():
    tbl = Table([Column.from_pylist([-128], INT8, device="cpu"),
                 Column.from_pylist([0x01], INT8, device="cpu")])
    assert pz.interleave_bits(tbl).to_pylist() == [bytes([0b10000000, 0b00000001])]


@pytest.mark.parametrize("dtype", [INT8, INT32, INT64, FLOAT64])
def test_interleave_nulls_read_as_zero(dtype):
    rng = np.random.default_rng(3)
    n = 41
    vals = [rng.integers(-100, 100, n).astype(dtype.np_dtype) for _ in range(3)]
    masks = [rng.random(n) > 0.3, None, rng.random(n) > 0.5]
    cols = [col(v, dtype, m) for v, m in zip(vals, masks)]
    got = same_as_jax(pz.interleave_bits, jz.interleave_bits, cols).to_pylist()
    nb = dtype.bits
    rows = []
    for r in range(n):
        row = []
        for v, m in zip(vals, masks):
            raw = int(v[r:r + 1].view(f"u{nb // 8}")[0])
            row.append(raw if m is None or m[r] else 0)
        rows.append(row)
    assert got == oracle_interleave(rows, nb)


@pytest.mark.parametrize("dtype,fmt", [(FLOAT32, ">f"), (FLOAT64, ">d")])
def test_interleave_floats_use_ieee_bits(dtype, fmt):
    vals = [1.5, -2.5, 0.0, -0.0, float("inf"), float("nan"), 1e-45 if dtype is FLOAT32 else 5e-324]
    got = same_as_jax(pz.interleave_bits, jz.interleave_bits,
                      [col(np.array(vals, dtype.np_dtype), dtype)]).to_pylist()
    assert got == [struct.pack(fmt, v) for v in vals]


def test_interleave_floats_two_columns():
    rng = np.random.default_rng(5)
    cols = [col(rng.normal(size=19).astype(np.float32), FLOAT32) for _ in range(2)]
    same_as_jax(pz.interleave_bits, jz.interleave_bits, cols)


@pytest.mark.parametrize("dtype", [DECIMAL32(9, 2), DECIMAL64(18, 4)])
def test_interleave_narrow_decimals(dtype):
    rng = np.random.default_rng(6)
    cols = [col(rng.integers(-10**8, 10**8, 23).astype(dtype.np_dtype), dtype) for _ in range(2)]
    same_as_jax(pz.interleave_bits, jz.interleave_bits, cols)


def test_interleave_decimal128():
    vals = [1, -1, 10**30, None, -(10**37)]
    c = Column.from_pylist(vals, DECIMAL128(38, 0), device="cpu")
    got = pz.interleave_bits(Table([c])).to_pylist()
    assert got == [((v or 0) & ((1 << 128) - 1)).to_bytes(16, "big") for v in vals]
    c2 = Column.from_pylist([5, None, 7, 8, -9], DECIMAL128(38, 0), device="cpu")
    same_as_jax(pz.interleave_bits, jz.interleave_bits, [c, c2])


def test_interleave_zero_rows():
    c = pz.interleave_bits(Table([Column.from_pylist([], INT32, device="cpu")]))
    assert c.to_pylist() == []
    assert c.offsets.tolist() == [0] and c.data.numel() == 0


def test_interleave_no_columns():
    c = pz.interleave_bits(Table([]), num_rows=4, device="cpu")
    assert c.to_pylist() == [b"", b"", b"", b""]
    assert ZOrder.interleaveBits(2, device="cpu").to_pylist() == [b"", b""]
    assert pz.interleave_bits(Table([]), device="cpu").to_pylist() == []


def test_interleave_errors():
    a = Column.from_pylist([1], INT8, device="cpu")
    with pytest.raises(TypeError, match="same type"):
        pz.interleave_bits(Table([a, Column.from_pylist([1], INT16, device="cpu")]))
    with pytest.raises(TypeError, match="same type"):
        pz.interleave_bits(Table([Column.from_pylist([1], INT32, device="cpu"),
                                  Column.from_pylist([1.0], FLOAT32, device="cpu")]))
    with pytest.raises(TypeError, match="fixed width"):
        pz.interleave_bits(Table([Column.from_pylist(["a"], STRING, device="cpu")]))


def test_interleave_size_limit():
    """More than 2^31 - 1 output bytes raise before any work (a view:
    no memory is touched)."""
    import torch

    n = (2**31) // 24 + 1
    big = torch.zeros(1, dtype=torch.int64).expand(n)
    cols = [Column(INT64, big) for _ in range(3)]
    with pytest.raises(ValueError, match="too large"):
        pz.interleave_bits(Table(cols))


# ---- hilbert


@pytest.mark.parametrize("num_bits,ncols", [(2, 2), (8, 2), (10, 3), (16, 4), (32, 2), (21, 3)])
def test_hilbert_vs_oracle_and_jax(num_bits, ncols):
    rng = random.Random(num_bits * 10 + ncols)
    n = 53
    lo, hi = (-(1 << 31), 1 << 31) if num_bits >= 21 else (0, 1 << num_bits)
    cols = [[rng.randrange(lo, hi) for _ in range(n)] for _ in range(ncols)]
    tcols = [col(np.array(c, np.int32), INT32) for c in cols]
    got = same_as_jax(lambda t: pz.hilbert_index(num_bits, t),
                      lambda t: jz.hilbert_index(num_bits, t), tcols).to_pylist()
    mask = (1 << num_bits) - 1
    cols = [[v & mask for v in c] for c in cols]
    assert got == [wrap64(oracle_hilbert([cols[c][r] for c in range(ncols)], num_bits))
                   for r in range(n)]


def test_hilbert_sign_bit_lands_in_int64():
    """64 output bits: bit 63 of the index is the int64 sign bit."""
    vals = [np.array([2**31 - 1, -1, 0, -(2**31)], np.int32) for _ in range(2)]
    got = same_as_jax(lambda t: pz.hilbert_index(32, t),
                      lambda t: jz.hilbert_index(32, t), [col(v, INT32) for v in vals])
    assert (got.data < 0).any()


def test_hilbert_2d_locality_golden():
    xs = Column.from_pylist([0, 0, 1, 1], INT32, device="cpu")
    ys = Column.from_pylist([0, 1, 1, 0], INT32, device="cpu")
    assert ZOrder.hilbertIndex(2, 4, xs, ys).to_pylist() == [0, 3, 2, 1]


def test_hilbert_nulls_as_zero():
    rng = np.random.default_rng(8)
    n = 29
    vals = [rng.integers(0, 1 << 10, n).astype(np.int32) for _ in range(3)]
    masks = [rng.random(n) > 0.4, None, rng.random(n) > 0.4]
    got = same_as_jax(lambda t: pz.hilbert_index(10, t), lambda t: jz.hilbert_index(10, t),
                      [col(v, INT32, m) for v, m in zip(vals, masks)]).to_pylist()
    want = [oracle_hilbert([int(v[r]) if m is None or m[r] else 0 for v, m in zip(vals, masks)], 10)
            for r in range(n)]
    assert got == want


def test_hilbert_zero_rows_and_no_columns():
    assert pz.hilbert_index(4, Table([col(np.zeros(0, np.int32), INT32)])).to_pylist() == []
    got = pz.hilbert_index(4, Table([]), num_rows=3, device="cpu")
    assert got.to_pylist() == [0, 0, 0] and got.data.dtype == INT64.torch_dtype
    assert pz.hilbert_index(40, Table([]), device="cpu").to_pylist() == []


def test_hilbert_errors():
    one = Column.from_pylist([1], INT32, device="cpu")
    with pytest.raises(ValueError, match="64 bits"):
        pz.hilbert_index(32, Table([one, one, one]))
    for bad in (0, 33, -1):
        with pytest.raises(ValueError, match=">0 and <= 32"):
            pz.hilbert_index(bad, Table([one]))
    with pytest.raises(TypeError, match="INT32"):
        pz.hilbert_index(4, Table([Column.from_pylist([1], INT64, device="cpu")]))


def test_chip_smoke_numpy_oracles_match_jax():
    """chip_smoke's phase-19 oracles (independent numpy) and its range
    ids, held to the JAX package at a small size."""
    spec = chip_smoke.lineitem_spec(3000, seed=4)
    keys = [spec[i]["data"] for i in chip_smoke.ZORDER_KEYS]
    ids = [chip_smoke.range_ids(k, ranges=50) for k in keys]
    assert all(i.min() >= 0 and i.max() < 50 for i in ids)
    rng = np.random.default_rng(1)
    masks = [rng.random(3000) > 0.1 for _ in keys]
    for cols, dt in ((keys, INT64), (ids, INT32)):
        for valid in (None, masks):
            tcols = [col(c, dt, None if valid is None else valid[i]) for i, c in enumerate(cols)]
            got = same_as_jax(pz.interleave_bits, jz.interleave_bits, tcols)
            np.testing.assert_array_equal(got.data.numpy(),
                                          chip_smoke.interleave_numpy(cols, valid).reshape(-1))
            if dt is INT32:
                got = same_as_jax(lambda t: pz.hilbert_index(10, t),
                                  lambda t: jz.hilbert_index(10, t), tcols)
                np.testing.assert_array_equal(got.data.numpy(),
                                              chip_smoke.hilbert_numpy(cols, 10, valid))
