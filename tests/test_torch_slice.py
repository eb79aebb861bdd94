"""The port's slice end to end at a small size, against the JAX chain:
a lineitem batch -> Spark HashPartitioning ids over (l_partkey,
l_suppkey) into 200 partitions -> JCUDF rows -> columns. Every
comparison is exact."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu import api as jax_api
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.parallel import spark_hash as jax_hash

from spark_rapids_jni_tpu_torch import api as port_api
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.kernels import murmur3 as port_kernel
from spark_rapids_jni_tpu_torch.parallel import spark_hash as port_hash

from torch_parity import assert_same_batches, assert_same_table, port_dtype, to_port

NUM_PARTITIONS = 200  # Spark's default spark.sql.shuffle.partitions
KEYS = (1, 2)  # l_partkey, l_suppkey: TPC-H q9's lineitem x partsupp


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


def keys(tbl):
    return type(tbl)([tbl.columns[i] for i in KEYS])


@pytest.mark.parametrize("n", [1000, 4096])
def test_slice_matches_jax_chain(n):
    tbl = lineitem(n)
    port = to_port(tbl)
    schema = [c.dtype for c in tbl.columns]

    want_pids = np.asarray(jax_hash.partition_ids(keys(tbl), NUM_PARTITIONS))
    got_pids = port_hash.partition_ids(keys(port), NUM_PARTITIONS)
    np.testing.assert_array_equal(got_pids.numpy(), want_pids)
    assert got_pids.dtype == torch.int32

    jrows = jax_api.RowConversion.convertToRows(tbl)
    prows = port_api.RowConversion.convertToRows(port)
    assert_same_batches(jrows, prows)
    jback = jax_api.RowConversion.convertFromRows(jrows, schema)
    pback = port_api.RowConversion.convertFromRows(prows, [port_dtype(d) for d in schema])
    assert_same_table(jback, pback)
    for c_in, c_out in zip(interop.table_to_numpy(port), interop.table_to_numpy(pback)):
        np.testing.assert_array_equal(c_out["data"], c_in["data"])


def test_fixed_width_optimized_api():
    tbl = lineitem(257)
    schema = [c.dtype for c in tbl.columns]
    jrows = jax_api.RowConversion.convertToRowsFixedWidthOptimized(tbl)
    prows = port_api.RowConversion.convertToRowsFixedWidthOptimized(to_port(tbl))
    assert_same_batches(jrows, prows)
    assert_same_table(
        jax_api.RowConversion.convertFromRowsFixedWidthOptimized(jrows, schema),
        port_api.RowConversion.convertFromRowsFixedWidthOptimized(
            prows, [port_dtype(d) for d in schema]
        ),
    )


def test_cpu_wrapper_takes_plain_version(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: the launch
    counter stays at 0 and the kernel's library is never loaded."""
    def no_build(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")

    monkeypatch.setattr(port_kernel._build, "load", no_build)
    monkeypatch.setattr(port_kernel, "launches", 0)
    port = to_port(lineitem(512))
    words, valids, plan = port_kernel.table_plan(keys(port))
    out = port_kernel.hash_planes(words, valids, plan, port_hash.DEFAULT_SEED)
    np.testing.assert_array_equal(
        out.numpy(),
        port_kernel.hash_planes_plain(words, valids, plan, port_hash.DEFAULT_SEED).numpy(),
    )
    port_hash.partition_ids(keys(port), NUM_PARTITIONS)
    port_hash.partition_ids(port, NUM_PARTITIONS)
    assert port_kernel.launches == 0


def test_all_lineitem_columns_hash():
    tbl = lineitem(700, seed=3)
    want = np.asarray(jax_hash.hash_columns(tbl)).astype(np.uint32)
    got = port_hash.hash_columns(to_port(tbl)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_bad_plans():
    w = torch.zeros((3, 8), dtype=torch.int32)
    v = torch.zeros((1, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        port_kernel.hash_planes(w, v, (((0, 2), 8, -1),), 42)  # planes not consecutive
    with pytest.raises(ValueError):
        port_kernel.hash_planes(w, v, (((0,), 4, 1),), 42)  # no validity plane 1
    with pytest.raises(TypeError):
        port_kernel.hash_planes(w.to(torch.int64), v, (((0,), 4, -1),), 42)
