"""Port's Spark Murmur3 hashing vs the JAX package: the plain torch chain
and partition ids against ``parallel/spark_hash`` and the Pallas kernel
run in interpret mode. Every comparison is exact."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.kernels import murmur3 as jax_kernel
from spark_rapids_jni_tpu.parallel import spark_hash as jax_hash

from spark_rapids_jni_tpu_torch.kernels import murmur3 as port_kernel
from spark_rapids_jni_tpu_torch.parallel import spark_hash as port_hash

from torch_parity import hash_u32, to_port


def check_table(tbl, seed=42, interpret=True):
    want = hash_u32(jax_hash.hash_columns(tbl, seed))
    got = hash_u32(port_hash.hash_columns(to_port(tbl), seed))
    np.testing.assert_array_equal(got, want)
    if interpret:
        kern = hash_u32(jax_kernel.hash_columns(tbl, seed, interpret=True))
        np.testing.assert_array_equal(got, kern)


@pytest.mark.parametrize("n", [7, 1024, 2500])
def test_int_columns(n):
    rng = np.random.default_rng(0)
    tbl = Table(
        [
            Column.from_numpy(
                rng.integers(-(2**31), 2**31, n, np.int64).astype(np.int32), jd.INT32
            ),
            Column.from_numpy(rng.integers(-(2**62), 2**62, n), jd.INT64),
        ]
    )
    check_table(tbl)


def test_floats_and_decimals():
    rng = np.random.default_rng(1)
    n = 1500
    f32 = rng.normal(size=n).astype(np.float32)
    f32[::5] = np.nan
    f32[::13] = -0.0
    f64 = rng.normal(size=n)
    f64[::7] = np.nan
    f64[::11] = -0.0
    f64[3] = np.inf
    f64[4] = -np.inf
    tbl = Table(
        [
            Column.from_numpy(f32, jd.FLOAT32),
            Column.from_numpy(f64, jd.FLOAT64),
            Column.from_numpy(rng.integers(-(10**17), 10**17, n), jd.DECIMAL64(18, 2)),
        ]
    )
    check_table(tbl)


def test_nulls_skip_column():
    rng = np.random.default_rng(2)
    n = 1100
    valid = rng.random(n) > 0.3
    tbl = Table(
        [
            Column.from_numpy(rng.integers(0, 100, n), jd.INT64, valid),
            Column.from_numpy(rng.integers(0, 100, n).astype(np.int32), jd.INT32),
            Column.from_numpy(rng.normal(size=n), jd.FLOAT64, rng.random(n) > 0.5),
        ]
    )
    check_table(tbl)


@pytest.mark.parametrize(
    "seed", [0, 42, 12345, jax_hash.salted_seed(1), jax_hash.salted_seed(7)]
)
def test_seed_variation(seed):
    rng = np.random.default_rng(3)
    n = 300
    tbl = Table(
        [
            Column.from_numpy(np.arange(n, dtype=np.int64), jd.INT64),
            Column.from_numpy(
                rng.integers(-(2**31), 2**31, n, np.int64).astype(np.int32),
                jd.INT32,
                rng.random(n) > 0.2,
            ),
        ]
    )
    check_table(tbl, seed=seed)


def test_salted_seed_matches():
    for salt in range(0, 9):
        assert port_hash.salted_seed(salt) == jax_hash.salted_seed(salt)
    assert port_hash.DEFAULT_SEED == jax_hash.DEFAULT_SEED == 42


def test_small_int_kinds():
    rng = np.random.default_rng(4)
    n = 700
    tbl = Table(
        [
            Column.from_numpy(rng.integers(-128, 128, n).astype(np.int8), jd.INT8),
            Column.from_numpy(rng.integers(-(2**15), 2**15, n).astype(np.int16), jd.INT16),
            Column.from_numpy(rng.integers(0, 2, n).astype(np.int8), jd.BOOL8),
            Column.from_numpy(rng.integers(-5000, 30000, n).astype(np.int32), jd.DATE32),
            Column.from_numpy(rng.integers(-(2**50), 2**50, n), jd.TIMESTAMP_MICROS),
            Column.from_numpy(
                rng.integers(-(10**8), 10**8, n).astype(np.int32), jd.DECIMAL32(9, 3)
            ),
        ]
    )
    check_table(tbl)


def _strings(rng, n):
    pool = ["", "a", "ab", "abc", "abcd", "abcde", "Spark", "héllo", "日本語テキスト",
            "exactly-eight", "0123456789abc", "x" * 31]
    vals = [pool[i] for i in rng.integers(0, len(pool), n)]
    return [None if rng.random() < 0.2 else v for v in vals]


def test_strings_with_nulls_and_empties():
    rng = np.random.default_rng(5)
    n = 400
    tbl = Table(
        [
            Column.from_numpy(rng.integers(0, 1000, n), jd.INT64),
            Column.from_pylist(_strings(rng, n), jd.STRING),
            Column.from_pylist(_strings(rng, n), jd.STRING),
        ]
    )
    check_table(tbl)


def _dec128_values(rng, n, big):
    edge = [0, 1, -1, 127, 128, -128, -129, 255, 256, -256, 2**63 - 1, -(2**63)]
    if big:
        edge += [10**37, -(10**37), 2**64, -(2**64), 2**100 + 7, -(2**100) - 7]
    lim = 10**37 if big else 10**17
    vals = [int(x) for x in rng.integers(-(2**62), 2**62, n)]
    vals = [v * (lim // 2**62 or 1) for v in vals]
    vals[: len(edge)] = edge
    return [None if i % 9 == 4 else v for i, v in enumerate(vals)]


@pytest.mark.parametrize("precision", [10, 18, 19, 38])
def test_decimal128(precision):
    rng = np.random.default_rng(precision)
    n = 260
    dt = jd.DECIMAL128(precision, 2)
    tbl = Table(
        [
            Column.from_pylist(_dec128_values(rng, n, precision > 18), dt),
            Column.from_numpy(rng.integers(0, 50, n).astype(np.int32), jd.INT32),
        ]
    )
    check_table(tbl)


@pytest.mark.parametrize("num_partitions", [200, 7, 1])
def test_partition_ids(num_partitions):
    rng = np.random.default_rng(6)
    n = 2048
    tbl = Table(
        [
            Column.from_numpy(rng.integers(1, 200_000, n), jd.INT64),
            Column.from_numpy(rng.integers(1, 10_000, n), jd.INT64),
        ]
    )
    want = np.asarray(jax_hash.partition_ids(tbl, num_partitions))
    got = port_hash.partition_ids(to_port(tbl), num_partitions).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < num_partitions
    # negative hashes are where a C-style remainder would go wrong
    assert (hash_u32(port_hash.hash_columns(to_port(tbl))) >= 2**31).any()


def test_pmod_negative_hashes():
    h = np.array([-1, -199, -200, -201, 0, 199, 2**31 - 1, -(2**31)], np.int32)
    want = np.asarray(jax_hash.pmod(h, 200))
    got = port_hash.pmod(torch.from_numpy(h), 200).numpy()
    np.testing.assert_array_equal(got, want)


def test_spark_golden_values():
    # Spark: SELECT hash(1) = -559580957, hash(0) = 933211791 (seed 42)
    from spark_rapids_jni_tpu_torch import Column as PC, INT32, Table as PT

    t = PT([PC.from_numpy(np.array([1, 0], np.int32), INT32, device="cpu")])
    np.testing.assert_array_equal(
        port_hash.hash_columns(t).numpy(), np.array([-559580957, 933211791], np.int32)
    )


def test_column_word_planes_match():
    rng = np.random.default_rng(8)
    n = 128
    f64 = rng.normal(size=n)
    f64[::3] = np.nan
    f64[1::5] = -0.0
    tbl = Table(
        [
            Column.from_numpy(f64, jd.FLOAT64),
            Column.from_numpy(rng.integers(-(10**9), 10**9, n), jd.DECIMAL64(12, 2)),
            Column.from_numpy(rng.integers(-100, 100, n).astype(np.int16), jd.INT16),
        ]
    )
    port = to_port(tbl)
    for jc, pc in zip(tbl.columns, port.columns):
        jw, jl = jax_hash.column_word_planes(jc)
        pw, pl = port_hash.column_word_planes(pc)
        assert jl == pl
        for a, b in zip(jw, pw):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_table_plan_matches_jax():
    rng = np.random.default_rng(9)
    n = 64
    tbl = Table(
        [
            Column.from_numpy(rng.integers(0, 9, n), jd.INT64, rng.random(n) > 0.5),
            Column.from_numpy(rng.integers(0, 9, n).astype(np.int32), jd.INT32),
            Column.from_numpy(rng.normal(size=n).astype(np.float32), jd.FLOAT32,
                              rng.random(n) > 0.5),
        ]
    )
    jw, jv, jplan = jax_kernel.table_plan(tbl)
    pw, pv, pplan = port_kernel.table_plan(to_port(tbl))
    assert jplan == pplan
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
