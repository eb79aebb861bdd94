"""The store_sales chain of chip_smoke.py (BASELINE.md config 4) at a
small size: chip_smoke's Parquet writer -> the port's reader -> casts ->
get_json_object -> filter -> group-by, exact against the same eager
chain on the JAX package (as tests/test_store_sales.py runs it) and
against the oracle."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.columnar.dtypes import INT32 as JINT32
from spark_rapids_jni_tpu.ops import aggregate as jagg
from spark_rapids_jni_tpu.ops import cast_string as jcast
from spark_rapids_jni_tpu.ops import filter as jfilter
from spark_rapids_jni_tpu.ops import get_json_object as jgjo
from spark_rapids_jni_tpu.ops.parquet_reader import ParquetReader as JReader

from spark_rapids_jni_tpu_torch import Table
from spark_rapids_jni_tpu_torch.api import ParquetReader

from torch_parity import assert_same_table

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

ROWS, RG = 4096, 1024


@pytest.fixture(scope="module")
def store_sales(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ss") / "store_sales.parquet")
    oracles = chip_smoke.write_store_sales(path, ROWS, RG)
    return path, oracles


def _jax_chain(t):
    """sf10_store_sales.py's query, eager, on the JAX package; returns
    every stage's result."""
    c = t.columns
    w = chip_smoke.SS_WIDTHS
    qty = jcast.string_to_integer(c[1], JINT32, strip=True, width=w[0])
    price = jcast.string_to_decimal(c[2], 9, 2, width=w[1])
    channel = jgjo.get_json_object(c[3], "$.channel", width=w[2])
    web = np.array([v == "web" for v in channel.to_pylist()])
    keep = jnp.asarray(web & np.asarray(price.validity_or_true()))
    filtered = jfilter.filter_table(JTable([c[0], qty, price, channel]), keep)
    Agg = jagg.Agg
    res = jagg.group_by(filtered, [0], [Agg("sum", 2), Agg("count", 2)])
    return {"casts": JTable([qty, price, channel]), "filter": filtered, "group_by": res}


def test_row_groups_match_oracle(store_sales):
    """Each row group: the port's reader equals the JAX package's, and
    the port's chain equals the oracle; the fold equals the totals."""
    path, oracles = store_sales
    total = {}
    with JReader(path) as jreader, ParquetReader(path, device="cpu") as preader:
        assert preader.num_row_groups == len(oracles) == ROWS // RG
        for rg in range(preader.num_row_groups):
            pt = preader.read_row_group(rg)
            assert_same_table(jreader.read_row_group(rg), pt)
            part = chip_smoke.ss_result(chip_smoke.ss_chain(pt))
            assert part == oracles[rg]
            chip_smoke.ss_fold(total, part)
    want_total = {}
    for o in oracles:
        chip_smoke.ss_fold(want_total, o)
    assert total == want_total


def test_chain_matches_jax(store_sales):
    """Every stage over the whole file (one shape for the JAX side's
    compiles), the DECIMAL32 sum's type included."""
    from spark_rapids_jni_tpu.ops.parquet_reader import read_table as jread_table
    from spark_rapids_jni_tpu_torch import INT32
    from spark_rapids_jni_tpu_torch.api import Aggregation, Filter, read_table
    from spark_rapids_jni_tpu_torch.ops.cast_string import string_to_decimal, string_to_integer
    from spark_rapids_jni_tpu_torch.ops.get_json_object import get_json_object

    path, oracles = store_sales
    jt, pt = jread_table(path), read_table(path, device="cpu")
    assert_same_table(jt, pt)
    want = _jax_chain(jt)
    w = chip_smoke.SS_WIDTHS
    c = pt.columns
    qty = string_to_integer(c[1], INT32, strip=True, width=w[0])
    price = string_to_decimal(c[2], 9, 2, strip=True, width=w[1])
    channel = get_json_object(c[3], "$.channel", width=w[2])
    assert_same_table(want["casts"], Table([qty, price, channel]))
    keep = chip_smoke.string_equals(channel, "web") & price.validity_or_true()
    filtered = Filter.apply(Table([c[0], qty, price, channel]), keep)
    assert_same_table(want["filter"], filtered)
    Agg = Aggregation.Agg
    res = Aggregation.groupBy(filtered, [0], [Agg("sum", 2), Agg("count", 2)])
    assert_same_table(want["group_by"], res)
    assert_same_table(want["group_by"], chip_smoke.ss_chain(pt))
    assert price.dtype.bits == 32 and res.columns[1].dtype.bits == 128
    assert (res.columns[1].dtype.precision, res.columns[1].dtype.scale) == (19, 2)
    want_total = {}
    for o in oracles:
        chip_smoke.ss_fold(want_total, o)
    assert {k: tuple(v) for k, v in want_total.items()} == chip_smoke.ss_result(res)


def test_generator_matches_benchmark_draws():
    """ss_gen_chunk draws what sf10_store_sales.py's gen_chunk draws."""
    g = chip_smoke.ss_gen_chunk(1000, 1003)
    rng = np.random.default_rng(1003)
    np.testing.assert_array_equal(g["store"], rng.integers(1, 64, 1000).astype(np.int32))
    qty_i, price_u, price_f = (rng.integers(1, 100, 1000), rng.integers(1, 500, 1000),
                               rng.integers(0, 100, 1000))
    np.testing.assert_array_equal(g["qty_i"], qty_i)
    np.testing.assert_array_equal(g["cents"], price_u * 100 + price_f)
    np.testing.assert_array_equal(g["chan"], rng.integers(0, 3, 1000))
