"""The port's ROLLUP / GROUPING SETS against the JAX package: the same
seeded tables go through ``spark_rapids_jni_tpu.ops.rollup`` and its
torch twin on the CPU, tolerance 0. The empty grouping set over 0 rows
(ROADMAP Queue 3, defect 3) is held to Spark's one grand-total row."""

import numpy as np
import pytest

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops import rollup as jroll
from spark_rapids_jni_tpu.ops.aggregate import Agg as JAgg

from spark_rapids_jni_tpu_torch.ops import rollup as proll
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg as PAgg

from torch_parity import assert_same_table, to_port

AGGS = (("sum", 2), ("count", 2), ("min", 3), ("max", 3), ("count", None))


def rollup_table(n=120, seed=0):
    """k0 INT32 (nulls), k1 STRING (nulls), v INT64 (nulls), w FLOAT64."""
    rng = np.random.default_rng(seed)
    words = ["a", "bb", "", "é"]
    return Table([
        Column.from_numpy(rng.integers(0, 3, n).astype(np.int32), jd.INT32, rng.random(n) > 0.1),
        Column.from_pylist([words[i] if i < 4 else None for i in rng.integers(0, 5, n)],
                           jd.STRING),
        Column.from_numpy(rng.integers(-100, 100, n), jd.INT64, rng.random(n) > 0.2),
        Column.from_numpy(rng.normal(size=n), jd.FLOAT64),
    ])


def aggs(mod):
    cls = JAgg if mod is jroll else PAgg
    return tuple(cls(op, c) for op, c in AGGS)


@pytest.mark.parametrize("keys", [[0], [0, 1], [1, 0]], ids=str)
def test_rollup_matches(keys):
    tbl = rollup_table()
    want = jroll.rollup(tbl, keys, aggs(jroll))
    got = proll.rollup(to_port(tbl), keys, aggs(proll))
    assert_same_table(want, got)


@pytest.mark.parametrize("sets", [[[0], [1]], [[1], []], [[0, 1], [0], [1], []]], ids=str)
def test_grouping_sets_match(sets):
    tbl = rollup_table(seed=3)
    want = jroll.grouping_sets(tbl, [0, 1], sets, aggs(jroll))
    got = proll.grouping_sets(to_port(tbl), [0, 1], sets, aggs(proll))
    assert_same_table(want, got)


def test_empty_input_non_global_sets_match():
    tbl = rollup_table(n=0)
    want = jroll.grouping_sets(tbl, [0, 1], [[0], [0, 1]], aggs(jroll))
    got = proll.grouping_sets(to_port(tbl), [0, 1], [[0], [0, 1]], aggs(proll))
    assert_same_table(want, got, validity_or_true=True)


def test_empty_input_has_one_grand_total_row():
    """Defect 3: Spark's global aggregate over no rows is one row (every
    count 0, every other aggregate null); the JAX package gives none."""
    tbl = rollup_table(n=0)
    got = proll.rollup(to_port(tbl), [0, 1], aggs(proll))
    assert got.num_rows == 1
    rows = [c.to_pylist()[0] for c in got.columns]
    # k0, k1, sum, count, min, max, count(*), grouping_id
    assert rows == [None, None, None, 0, None, None, 0, 3]
    want = jroll.rollup(tbl, [0, 1], aggs(jroll))
    assert want.num_rows == 0
