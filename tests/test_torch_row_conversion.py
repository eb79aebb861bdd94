"""Port's JCUDF row conversion vs the JAX package on fixed-width tables:
row bytes, row offsets and batch splits byte for byte, and the columns
that come back from rows. Every comparison is exact. The string tables
are in test_torch_row_conversion_strings.py."""

import numpy as np
import pytest

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc

from torch_parity import (
    assert_same_batches,
    assert_same_table,
    port_dtype,
    round_trip_both,
    to_port,
)

_INT_TYPES = [jd.INT8, jd.INT16, jd.INT32, jd.INT64, jd.BOOL8,
              jd.INT8, jd.INT16, jd.INT32, jd.INT64]  # benchmarks/suites.py:38


def lineitem(n, seed=7):
    """The lineitem batch of __graft_entry__._lineitem_table."""
    rng = np.random.default_rng(seed)
    dec = jd.DECIMAL64(12, 2)
    spec = [
        (rng.integers(1, 6_000_000, n, np.int64), jd.INT64),
        (rng.integers(1, 200_000, n, np.int64), jd.INT64),
        (rng.integers(1, 10_000, n, np.int64), jd.INT64),
        (rng.integers(1, 8, n, np.int32), jd.INT32),
        (rng.integers(100, 5100, n, np.int64), dec),
        (rng.integers(90_000, 10_500_000, n, np.int64), dec),
        (rng.integers(0, 11, n, np.int64), dec),
        (rng.integers(0, 9, n, np.int64), dec),
        (rng.integers(8000, 12000, n, np.int32), jd.DATE32),
        (rng.integers(8030, 12030, n, np.int32), jd.DATE32),
        (rng.integers(8060, 12060, n, np.int32), jd.DATE32),
    ]
    return Table([Column.from_numpy(a, t) for a, t in spec])


def cycled(n, n_cols, seed=0, nulls=False):
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(n_cols):
        dt = _INT_TYPES[i % len(_INT_TYPES)]
        if dt.kind == "bool":
            data = rng.integers(0, 2, n, np.int8)
        else:
            info = np.iinfo(dt.np_dtype)
            data = rng.integers(info.min // 2, info.max // 2, n, dt.np_dtype)
        valid = (rng.random(n) > 0.25) if (nulls and i % 3 == 0) else None
        cols.append(Column.from_numpy(data, dt, valid))
    return Table(cols)


def test_row_layouts_match():
    schemas = [
        [c.dtype for c in lineitem(1).columns],
        [c.dtype for c in cycled(1, 53).columns],
        [jd.INT64, jd.STRING, jd.INT32, jd.STRING, jd.BOOL8, jd.STRING],
        [jd.INT8, jd.DECIMAL128(38, 3), jd.STRING, jd.INT16, jd.FLOAT64, jd.BOOL8],
        [jd.STRING],
    ]
    for schema in schemas:
        want = jrc.compute_row_layout(schema)
        got = prc.compute_row_layout([port_dtype(d) for d in schema])
        assert dict(vars(got)) == dict(vars(want))


@pytest.mark.parametrize("n", [1, 33, 1000])
def test_lineitem_bytes_and_round_trip(n):
    tbl, pback = round_trip_both(lineitem(n))
    # the round trip gives back the input, with explicit validity masks
    for c_in, c_out in zip(interop.table_to_numpy(to_port(tbl)),
                           interop.table_to_numpy(pback)):
        np.testing.assert_array_equal(c_out["data"], c_in["data"])
        assert c_out["validity"].all()


def test_cycled_53_columns():
    round_trip_both(cycled(300, 53))


def test_cycled_with_nulls_and_floats():
    rng = np.random.default_rng(3)
    n = 200
    base = cycled(n, 12, seed=5, nulls=True)
    f = rng.normal(size=n)
    f[::9] = np.nan
    extra = [
        Column.from_numpy(f, jd.FLOAT64, rng.random(n) > 0.4),
        Column.from_numpy(f.astype(np.float32), jd.FLOAT32),
        Column.from_pylist(
            [None if i % 5 == 0 else (i - 100) * 10**30 for i in range(n)],
            jd.DECIMAL128(38, 4),
        ),
    ]
    round_trip_both(Table(list(base.columns) + extra))


def test_fixed_width_optimized_pair():
    tbl = lineitem(130)
    schema = [c.dtype for c in tbl.columns]
    jrows = jrc.convert_to_rows_fixed_width_optimized(tbl)
    prows = prc.convert_to_rows_fixed_width_optimized(to_port(tbl))
    assert_same_batches(jrows, prows)
    jback = jrc.convert_from_rows_fixed_width_optimized(jrows, schema)
    pback = prc.convert_from_rows_fixed_width_optimized(
        prows, [port_dtype(d) for d in schema]
    )
    assert_same_table(jback, pback)
    with pytest.raises(ValueError):
        prc.convert_to_rows_fixed_width_optimized(to_port(cycled(2, 100)))
    strings = Table([Column.from_pylist(["a", None], jd.STRING)])
    with pytest.raises(TypeError):
        prc.convert_to_rows_fixed_width_optimized(to_port(strings))


@pytest.mark.parametrize("max_batch_bytes", [640, 8000])
def test_multi_batch_fixed(max_batch_bytes):
    # lineitem rows are 80 bytes: 8 or 96 rows per batch
    round_trip_both(lineitem(300), max_batch_bytes)


def test_plan_batches_matches():
    rng = np.random.default_rng(12)
    sizes = (rng.integers(1, 20, 500) * 8).astype(np.int64)
    for cap in (200, 1000, 5000, 10**6):
        assert prc._plan_batches(sizes, cap) == jrc._plan_batches(sizes, cap)
    with pytest.raises(ValueError):
        prc._plan_batches(np.array([64, 800]), 100)


def test_empty_table():
    tbl = lineitem(0)
    rows = prc.convert_to_rows(to_port(tbl))
    assert len(rows) == 1 and rows[0].data.numel() == 0
    assert rows[0].offsets.tolist() == [0]
