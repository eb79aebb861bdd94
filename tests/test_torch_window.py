"""The port's window functions against the JAX package: the same seeded
tables go through ``spark_rapids_jni_tpu.ops.window.window`` and its
torch twin on the CPU, tolerance 0 (float sums included: both run the
same Hillis-Steele scan, so the additions happen in one order).

Every ``WindowSpec`` kind runs under both frames, over a table with
nulls and ties, partitioned by a few keys and as one partition. The
JAX package fails on two inputs Spark defines (ROADMAP Queue 3,
defects 1-2); those rows are held to a numpy Spark oracle instead."""

import functools

import numpy as np
import pytest

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops import window as jwin
from spark_rapids_jni_tpu.ops.sort import SortKey as JSortKey

from spark_rapids_jni_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_jni_tpu_torch.columnar.table import Table as PTable
from spark_rapids_jni_tpu_torch.ops import window as pwin
from spark_rapids_jni_tpu_torch.ops.sort import SortKey as PSortKey

from torch_parity import assert_same_table, to_port

N = 257
KINDS = ("row_number", "rank", "dense_rank", "sum", "count", "min", "max", "lead", "lag",
         "first_value", "last_value")
FRAMES = ("running", "partition")
VALUE_COL = {"count": 3}  # count reads the int column; the others the float column


def window_table(n=N, seed=0):
    """part INT32 (nulls), order INT64 (ties, nulls), value FLOAT64
    (nulls, NaN, -0.0), value INT64 (nulls)."""
    rng = np.random.default_rng(seed)
    fval = rng.normal(size=n) * 1e3
    fval[::19] = np.nan
    fval[3::29] = -0.0
    return Table([
        Column.from_numpy(rng.integers(0, 5, n).astype(np.int32), jd.INT32, rng.random(n) > 0.1),
        Column.from_numpy(rng.integers(0, 20, n), jd.INT64, rng.random(n) > 0.1),
        Column.from_numpy(fval, jd.FLOAT64, rng.random(n) > 0.15),
        Column.from_numpy(rng.integers(-50, 50, n), jd.INT64, rng.random(n) > 0.2),
    ])


def all_specs():
    return [(k, f, VALUE_COL.get(k, 2)) for k in KINDS for f in FRAMES]


@functools.lru_cache(maxsize=None)
def both(partitioned: bool):
    """Every spec through one window call of each package."""
    tbl = window_table()
    parts = [0] if partitioned else []
    specs = all_specs()
    jout = jwin.window(
        tbl, parts, [JSortKey(1), JSortKey(2, ascending=False)],
        [jwin.WindowSpec(k, None if k in ("row_number", "rank", "dense_rank") else c, f,
                         2 if k in ("lead", "lag") else 1)
         for k, f, c in specs],
    )
    pout = pwin.window(
        to_port(tbl), parts, [PSortKey(1), PSortKey(2, ascending=False)],
        [pwin.WindowSpec(k, None if k in ("row_number", "rank", "dense_rank") else c, f,
                         2 if k in ("lead", "lag") else 1)
         for k, f, c in specs],
    )
    return dict(zip(specs, zip(jout, pout)))


@pytest.mark.parametrize("partitioned", [True, False], ids=["many", "one"])
@pytest.mark.parametrize("kind,frame,col", all_specs())
def test_window_spec_matches(kind, frame, col, partitioned):
    jcol, pcol = both(partitioned)[(kind, frame, col)]
    assert_same_table(Table([jcol]), PTable([pcol]))


def test_string_keys_match():
    rng = np.random.default_rng(4)
    words = ["", "a", "ab", "b", "é", "zz"]
    tbl = Table([
        Column.from_pylist([words[i] if i else None for i in rng.integers(0, 6, 60)], jd.STRING),
        Column.from_pylist([str(i % 7) for i in range(60)], jd.STRING),
        Column.from_numpy(rng.integers(0, 9, 60), jd.INT64),
    ])
    specs_j = [jwin.WindowSpec("rank"), jwin.WindowSpec("sum", 2, "partition")]
    specs_p = [pwin.WindowSpec("rank"), pwin.WindowSpec("sum", 2, "partition")]
    jout = jwin.window(tbl, [0], [JSortKey(1, ascending=False)], specs_j)
    pout = pwin.window(to_port(tbl), [0], [PSortKey(1, ascending=False)], specs_p)
    assert_same_table(Table(jout), PTable(pout))


def test_empty_table_matches():
    tbl = Table([Column.from_pylist([], jd.INT32), Column.from_pylist([], jd.FLOAT64)])
    specs = [("row_number", None), ("sum", 1), ("min", 1)]
    jout = jwin.window(tbl, [0], [], [jwin.WindowSpec(k, c) for k, c in specs])
    pout = pwin.window(to_port(tbl), [0], [], [pwin.WindowSpec(k, c) for k, c in specs])
    assert_same_table(Table(jout), PTable(pout))


def test_decimal128_rejected_like_jax():
    tbl = Table([
        Column.from_pylist([1, 1, 2], jd.INT64),
        Column.from_pylist([1, 2, 3], jd.DECIMAL128(38, 2)),
    ])
    with pytest.raises(NotImplementedError):
        jwin.window(tbl, [0], [], [jwin.WindowSpec("sum", col=1)])
    with pytest.raises(NotImplementedError):
        pwin.window(to_port(tbl), [0], [], [pwin.WindowSpec("sum", col=1)])


# ---------------------------------------------------------------------
# reference defects 1-2: held to Spark semantics (numpy oracle)


def _sorted_positions(part, order):
    """Spark's sort of (part, order), both ascending with nulls first:
    the permutation, and each sorted row's partition start."""
    perm = np.lexsort((order, part))
    p = part[perm]
    start = np.zeros(len(p), np.int64)
    for i in range(1, len(p)):
        start[i] = start[i - 1] if p[i] == p[i - 1] else i
    return perm, start


@pytest.mark.parametrize("frame", FRAMES)
def test_count_star_is_row_count(frame):
    """Defect 1: ``WindowSpec('count')`` with no column is count(*);
    the JAX package raises a TypeError."""
    import spark_rapids_jni_tpu_torch as port

    rng = np.random.default_rng(9)
    part = rng.integers(0, 4, 50).astype(np.int32)
    order = rng.permutation(50).astype(np.int64)  # no ties: ROWS == RANGE
    tbl = PTable([PColumn.from_numpy(part, port.INT32, device="cpu"),
                  PColumn.from_numpy(order, port.INT64, device="cpu")])
    [got] = pwin.window(tbl, [0], [PSortKey(1)], [pwin.WindowSpec("count", None, frame)])
    perm, start = _sorted_positions(part, order)
    sizes = np.bincount(part, minlength=4)
    want = np.empty(50, np.int64)
    for pos, row in enumerate(perm):
        want[row] = pos - start[pos] + 1 if frame == "running" else sizes[part[row]]
    assert got.validity is None
    np.testing.assert_array_equal(got.data.numpy(), want)
    jtbl = Table([Column.from_numpy(part, jd.INT32), Column.from_numpy(order, jd.INT64)])
    with pytest.raises(TypeError):
        jwin.window(jtbl, [0], [JSortKey(1)], [jwin.WindowSpec("count", None, frame)])


@pytest.mark.parametrize("kind,offset", [("lead", 7), ("lag", 7), ("lead", 30), ("lag", 9)])
def test_lead_lag_past_the_table_is_null(kind, offset):
    """Defect 2: an offset of at least the row count reaches no row, so
    every result is null. At exactly the row count the JAX package
    agrees; past it, it fails with a shape error."""
    import spark_rapids_jni_tpu_torch as port

    n = 7
    tbl = PTable([PColumn.from_numpy(np.zeros(n, np.int32), port.INT32, device="cpu"),
                  PColumn.from_numpy(np.arange(n), port.INT64, device="cpu")])
    [got] = pwin.window(tbl, [0], [PSortKey(1)], [pwin.WindowSpec(kind, 1, offset=offset)])
    np.testing.assert_array_equal(got.validity.numpy(), np.zeros(n, bool))
    np.testing.assert_array_equal(got.data.numpy(), np.zeros(n, np.int64))
    jtbl = Table([Column.from_numpy(np.zeros(n, np.int32), jd.INT32),
                  Column.from_numpy(np.arange(n), jd.INT64)])
    spec = jwin.WindowSpec(kind, 1, offset=offset)
    if offset == n:
        [jcol] = jwin.window(jtbl, [0], [JSortKey(1)], [spec])
        assert_same_table(Table([jcol]), PTable([got]))
    else:
        with pytest.raises(TypeError):
            jwin.window(jtbl, [0], [JSortKey(1)], [spec])
