"""The native backend's JCUDF row kernels, tile by tile on the host,
against the JAX package's ``convert_to_rows`` / ``convert_from_rows``.

The host plugin (csrc/native/host_plugin.cpp) runs the CUDA plugin's
tile transposes in loops: the same windows of a row
(``sprt_rowops.h plan_window``), tile heights, staging layouts and
per-column byte placement (``tile_offset``, ``validity_byte``,
``tile_unpack``). Its
``sprtk_to_rows`` / ``sprtk_from_rows`` are called here directly on
numpy buffers, and through the JNI library's native backend
(``init_native(device="cpu")``), on seeded tables whose row counts
straddle a tile (1, 31, 33, one past a tile, a tail), at a row offset,
with 8-byte rows, DECIMAL128 values at rows that start 8 bytes off a
16-byte boundary, validity bytes across a word, 64 and 65 columns, the
reference's 212-column nvbench schema (several windows), and all-null
and mask-less columns. Every comparison is exact."""

import ctypes

import jax  # noqa: F401  (JAX on the CPU, set by conftest)
import numpy as np
import pytest

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.kernels import _build, native
from spark_rapids_jni_tpu_torch.runtime import jni_backend as jb

import torch_parity  # noqa: F401  (one torch thread per test process)
from torch_parity import numpy_form, port_dtype

_CYCLE = [jd.INT8, jd.INT16, jd.INT32, jd.INT64, jd.BOOL8,
          jd.INT8, jd.INT16, jd.INT32, jd.INT64]  # benchmarks/suites.py:38
_MIXED = [jd.INT64, jd.INT32, jd.INT8, jd.DECIMAL128(38, 2), jd.FLOAT64, jd.INT16, jd.BOOL8]
_K = {8: 1, 32: 3, 64: 4}  # cudf type ids of the integer columns the test factories make


@pytest.fixture(scope="module")
def host():
    """The host plugin with its signatures set, its counters at 0."""
    lib = native.plugin("sprt_native_host")
    lib.sprtk_reset_launches()
    return lib


def table(schema, n, seed, nulls=0.25):
    """A JAX Table of seeded values; a mask on every other column
    (``nulls`` of the rows null, 1.0: all null)."""
    rng = np.random.default_rng(seed)
    cols = []
    for i, dt in enumerate(schema):
        valid = (rng.random(n) >= nulls) if i % 2 == 0 and nulls else None
        if dt.kind == "bool":
            cols.append(Column.from_numpy(rng.integers(0, 2, n, np.int8), dt, valid))
        elif dt.kind == "float":
            cols.append(Column.from_numpy(rng.normal(size=n) * 1e9, dt, valid))
        elif dt.kind == "decimal":
            hi = rng.integers(-(2**40), 2**40, n).astype(object)
            vals = rng.integers(-(2**62), 2**62, n) * hi
            cols.append(Column.from_pylist(
                [None if valid is not None and not valid[k] else int(v) for k, v in
                 enumerate(vals)], dt))
        else:
            info = np.iinfo(dt.np_dtype)
            cols.append(Column.from_numpy(rng.integers(info.min, info.max, n, dt.np_dtype,
                                                       endpoint=True), dt, valid))
    return Table(cols)


def desc_of(host, jt):
    """The plugin's RowsDesc of the table's columns, keeping the host
    arrays it points to."""
    form = numpy_form(jt)
    d = native.rows_desc([port_dtype(c.dtype) for c in jt.columns], lib=host)
    keep = []
    for i, c in enumerate(form):
        data = np.ascontiguousarray(c["data"])
        valid = None if c["validity"] is None else np.ascontiguousarray(c["validity"], np.bool_)
        keep.append((data, valid))
        d.data[i] = data.ctypes.data
        d.valid[i] = None if valid is None else valid.ctypes.data
    d._keep = keep
    return d


def to_rows_direct(host, jt, row0=0, n=None):
    d = desc_of(host, jt)
    n = len(jt.columns[0].data) - row0 if n is None else n
    rows = np.full((n, d.row_size), 0xA5, np.uint8)  # garbage: every byte must be written
    assert host.sprtk_to_rows(ctypes.byref(d), row0, n, rows.ctypes.data, None) == 0
    return rows


def from_rows_direct(host, rows, schema):
    """(data, validity) per column of the rows, through the plugin."""
    d = native.rows_desc([port_dtype(dt) for dt in schema], lib=host)
    n = rows.shape[0]
    out = []
    for i, dt in enumerate(schema):
        shape = (n, 2) if dt.kind == "decimal" and dt.bits == 128 else (n,)
        data = np.full(shape, 0x5A, port_dtype(dt).np_dtype)
        valid = np.full(n, 7, np.uint8)
        d.data[i], d.valid[i] = data.ctypes.data, valid.ctypes.data
        out.append((data, valid))
    rows = np.ascontiguousarray(rows)
    assert host.sprtk_from_rows(ctypes.byref(d), rows.ctypes.data, n, None) == 0
    return out


def jax_rows(jt):
    batches = jrc.convert_to_rows(jt)
    assert len(batches) == 1
    row_size = jrc.compute_row_layout([c.dtype for c in jt.columns]).fixed_only_row_size
    return np.asarray(jrc.row_batch_bytes(batches[0])).reshape(-1, row_size), batches


def assert_round_trip(host, jt):
    """The plugin's rows equal the JAX package's, byte for byte, and its
    columns from those rows equal ``convert_from_rows``'s."""
    schema = [c.dtype for c in jt.columns]
    want, batches = jax_rows(jt)
    np.testing.assert_array_equal(to_rows_direct(host, jt), want)
    jback = jrc.convert_from_rows(batches, schema)
    for (data, valid), jc in zip(from_rows_direct(host, want, schema), jback.columns):
        jd_ = np.asarray(jc.data)
        np.testing.assert_array_equal(data.view(np.uint8).reshape(-1),
                                      np.ascontiguousarray(jd_.astype(data.dtype)).view(
                                          np.uint8).reshape(-1))
        np.testing.assert_array_equal(valid.astype(bool), np.asarray(jc.validity))


@pytest.mark.parametrize("n", [1, 31, 33, 600])
def test_mixed_schema_tile_edges(host, n):
    """A 48-byte mixed row (R = 256 a tile): one row, under and over a
    warp, and two tiles and a tail."""
    assert_round_trip(host, table(_MIXED, n, seed=n))


def test_row_offset(host):
    """Rows [row0, row0 + n) of longer columns, as the backend's batches
    ask for them."""
    jt = table(_MIXED, 700, seed=5)
    row0, n = 96, 517
    sub = Table([Column(c.dtype, c.data[row0:row0 + n],
                        None if c.validity is None else c.validity[row0:row0 + n])
                 for c in jt.columns])
    want, _ = jax_rows(sub)
    np.testing.assert_array_equal(to_rows_direct(host, jt, row0, n), want)


def test_single_int8_column(host):
    """An 8-byte row: one word, its validity byte and six zero bytes."""
    jt = table([jd.INT8], 300, seed=8)
    assert jrc.compute_row_layout([jd.INT8]).fixed_only_row_size == 8
    assert_round_trip(host, jt)


def test_decimal128_at_8_byte_aligned_rows(host):
    """(DECIMAL128, INT8): 24-byte rows, so every odd row's DECIMAL128
    starts 8 bytes off a 16-byte boundary."""
    jt = table([jd.DECIMAL128(38, 4), jd.INT8], 257, seed=9)
    assert jrc.compute_row_layout([c.dtype for c in jt.columns]).fixed_only_row_size == 24
    assert_round_trip(host, jt)


@pytest.mark.parametrize("n_cols", [9, 17])
def test_validity_bytes_across_a_word(host, n_cols):
    """Two and three validity bytes, INT8 columns: the validity starts at
    byte 9 or 17, so its bytes share a word with the last columns."""
    assert_round_trip(host, table([jd.INT8] * n_cols, 97, seed=n_cols, nulls=0.5))


@pytest.mark.parametrize("n_cols", [64, 65])
def test_64_and_65_columns(host, n_cols):
    """The former kernel's cap and one past it (cycled types)."""
    schema = [_CYCLE[i % len(_CYCLE)] for i in range(n_cols)]
    assert_round_trip(host, table(schema, 75, seed=n_cols))


def test_212_column_nvbench_schema(host):
    """The reference's 212-column table: a ~1 KB row cut into several
    windows (at most 128 columns and 512 bytes each), each launched on
    its own."""
    schema = [_CYCLE[i % len(_CYCLE)] for i in range(212)]
    jt = table(schema, 70, seed=212)
    d = native.rows_desc([port_dtype(dt) for dt in schema], lib=host)
    host.sprtk_reset_launches()
    assert_round_trip(host, jt)
    to_launches = host.sprtk_launches(native.FAMILIES["to_rows"])
    assert to_launches == host.sprtk_launches(native.FAMILIES["from_rows"])
    assert to_launches >= -(-d.row_size // (8 * 64))  # a window holds at most 64 words
    assert to_launches >= 2


def test_all_null_and_maskless_columns(host):
    """An all-null column, a mask of all-valid bytes, and columns with no
    mask at all: bits 0, 1 and 1."""
    rng = np.random.default_rng(4)
    n = 300
    jt = Table([
        Column.from_numpy(rng.integers(0, 9, n, np.int64), jd.INT64, np.zeros(n, bool)),
        Column.from_numpy(rng.integers(0, 9, n, np.int32), jd.INT32, np.ones(n, bool)),
        Column.from_numpy(rng.integers(0, 9, n, np.int16), jd.INT16),
        Column.from_numpy(rng.integers(0, 2, n, np.int8), jd.BOOL8),
    ])
    assert_round_trip(host, jt)
    rows = to_rows_direct(host, jt)
    vo = jrc.compute_row_layout([c.dtype for c in jt.columns]).validity_offset
    assert (rows[:, vo] == 0b1110).all()


def test_windows_cover_the_row(host):
    """plan_window's windows, read back through the rows they write:
    a schema whose data crosses 512 bytes (34 DECIMAL128) writes every
    byte of every row, and the launches count one per window."""
    schema = [jd.DECIMAL128(38, 0)] * 34 + [jd.INT8] * 3
    jt = table(schema, 40, seed=34)
    host.sprtk_reset_launches()
    assert_round_trip(host, jt)
    assert host.sprtk_launches(native.FAMILIES["to_rows"]) == 2  # 544 + 8 bytes: 512 + 40


# -- through the JNI library's native backend over the host plugin


@pytest.fixture(scope="module")
def backend():
    _build.build("sprt_jni", "sprt_native_host")
    lib = jb.register(device="cpu")
    jb.init_native(device="cpu")
    lib.sprt_get_accel_backend.restype = ctypes.POINTER(jb.SprtBackend)
    yield lib
    jb.uninit_native()


def _call(lib, op, args):
    flat = np.concatenate([np.ravel(np.asarray(a, np.int64)) for a in args])
    rc, out, err, _row, _s = jb.call_backend(lib.sprt_get_accel_backend(), op, flat)
    assert rc == 0, (op, rc, err)
    return out


def _make(lib, col):
    """A backend column of a JAX integer column (the test factories)."""
    n = len(col.data)
    data = np.asarray(col.data).astype(np.int64)
    valid = [] if col.validity is None else [np.asarray(col.validity).astype(np.int64)]
    if col.dtype.bits == 64:
        return _call(lib, "test.make_long_column", [[n], data, *valid])[0]
    return _call(lib, "test.make_int_column", [[n, _K[col.dtype.bits]], data, *valid])[0]


@pytest.mark.parametrize("n_cols", [6, 212])
def test_backend_rows_match_jax(backend, n_cols):
    """``row_conversion.to_rows`` through the native backend: a schema
    past the former 64-column cap is no longer declined; the first eight
    columns come back through ``row_conversion.from_rows`` (INT8, INT32
    and INT64 cycled: the types the test factories make)."""
    schema = [(jd.INT8, jd.INT32, jd.INT64)[i % 3] for i in range(n_cols)]
    jt = table(schema, 45, seed=n_cols)
    hs = [_make(backend, c) for c in jt.columns]
    (tbl,) = _call(backend, "test.make_table", [hs])
    (rows,) = _call(backend, "row_conversion.to_rows", [[tbl]])
    want, batches = jax_rows(jt)
    got = jb.native_column(backend, rows, device="cpu")
    np.testing.assert_array_equal(got.data.numpy(), want.reshape(-1))
    if n_cols <= 8:
        ids = [_K[dt.bits] for dt in schema]
        back = _call(backend, "row_conversion.from_rows", [[rows], ids, [0] * n_cols])
        jback = jrc.convert_from_rows(batches, schema)
        for h, jc in zip(back, jback.columns):
            c = jb.native_column(backend, h, device="cpu")
            np.testing.assert_array_equal(c.data.numpy().view(np.uint8),
                                          np.asarray(jc.data).astype(c.data.numpy().dtype)
                                          .view(np.uint8))
            np.testing.assert_array_equal(c.validity.numpy(), np.asarray(jc.validity))
            _call(backend, "handle.release", [[h]])
    for h in hs + [tbl, rows]:
        _call(backend, "handle.release", [[h]])
    assert jb.native_counts(backend)["live_bytes"] == 0
