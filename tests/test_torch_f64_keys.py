"""DOUBLE keys in the JAX package's exact-bits form: a FLOAT64 column
whose int64 storage holds ``doubleToLongBits`` (``f64_bits_column``).
The port carries that storage through interop as bits, hashes it as
bits in the plain chain and in the kernel's lowering, and builds the
same column with its own ``f64_bits_column``. Every comparison is
exact (tolerance 0) against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.kernels import murmur3 as jax_kernel
from spark_rapids_jni_tpu.parallel import spark_hash as jax_hash

from spark_rapids_jni_tpu_torch import FLOAT32, FLOAT64, Column, Table
from spark_rapids_jni_tpu_torch.kernels import murmur3 as port_kernel
from spark_rapids_jni_tpu_torch.parallel import spark_hash as port_hash

from torch_parity import hash_u32, to_port

# the values of the reproduction: the parent port hashed them as
# float64 values converted from the bits, placing four of six rows on
# other partitions than the JAX package
REPRO = [0.0, -0.0, 1.5, np.nan, 1e300, -3.25]
# tests/test_shuffle.py's bits-column edge values, with more NaN
# payloads, -inf and the largest double
EDGES = np.concatenate([
    [0.1, np.pi, 1e300, -1e-300, 5e-324, -0.0, np.nan, np.inf, -np.inf, 0.0,
     1.7976931348623157e308],
    np.array([0x7FF0000000000001, -1, 0x7FF8000000000123], np.int64).view(np.float64),
])
SEEDS = (0, 42, 12345, port_hash.salted_seed(1))


def seeded_doubles(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n) * 10.0 ** rng.integers(-300, 300, n)
    v[: len(EDGES)] = EDGES
    return v


@pytest.mark.parametrize("parts", [200, 7, 1])
def test_jax_bits_form_partition_ids(parts):
    tbl = JTable([jax_hash.f64_bits_column(REPRO)])
    want = np.asarray(jax_hash.partition_ids(tbl, parts))
    got = port_hash.partition_ids(to_port(tbl), parts).numpy()
    np.testing.assert_array_equal(got, want)
    if parts == 200:
        np.testing.assert_array_equal(want, [5, 5, 149, 15, 9, 62])


@pytest.mark.parametrize("seed", SEEDS)
def test_jax_bits_form_beside_other_keys(seed):
    """The bits-form key with nulls, chained after an INT64 key, through
    the plain chain and the JAX Pallas kernel (interpret mode)."""
    n = 600
    rng = np.random.default_rng(seed % 1000)
    valid = rng.random(n) > 0.25
    tbl = JTable([
        JColumn.from_numpy(rng.integers(-(2**62), 2**62, n), jd.INT64),
        jax_hash.f64_bits_column(seeded_doubles(n, 3), validity=valid),
    ])
    want = hash_u32(jax_hash.hash_columns(tbl, seed))
    np.testing.assert_array_equal(hash_u32(port_hash.hash_columns(to_port(tbl), seed)), want)
    np.testing.assert_array_equal(
        hash_u32(jax_kernel.hash_columns(tbl, seed, interpret=True)), want)


@pytest.mark.parametrize("form", ["numpy", "list", "tensor"])
def test_port_f64_bits_column_matches_jax(form):
    vals = seeded_doubles(257, 5)
    valid = np.arange(257) % 5 != 0
    arg = {"numpy": vals, "list": vals.tolist(), "tensor": torch.from_numpy(vals)}[form]
    got = port_hash.f64_bits_column(arg, validity=valid, device="cpu")
    want = jax_hash.f64_bits_column(vals, validity=valid)
    assert got.dtype == FLOAT64 and got.data.dtype == torch.int64
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.validity.numpy(), valid)
    np.testing.assert_array_equal(
        hash_u32(port_hash.hash_columns(Table([got]))),
        hash_u32(jax_hash.hash_columns(JTable([want]))))


def test_port_f64_bits_column_edge_bits():
    got = port_hash.f64_bits_column(EDGES, device="cpu").data.numpy()
    want = EDGES.view(np.int64).copy()
    want[EDGES == 0.0] = 0
    want[np.isnan(EDGES)] = 0x7FF8000000000000
    np.testing.assert_array_equal(got, want)
    assert got[4] == 1  # 5e-324 keeps its subnormal bits
    np.testing.assert_array_equal(got, np.asarray(jax_hash.f64_bits_column(EDGES).data))


@pytest.mark.parametrize("dtype,bits", [(FLOAT64, 64), (FLOAT32, 32)])
def test_direct_bits_column_hashes(dtype, bits):
    """A Column built directly with integer storage under a float dtype
    hashes as those bits, as the JAX package's ``column_word_planes``
    reads it (FLOAT64: the int64 branch; FLOAT32: its bitcast of the
    integer storage gives the same bits)."""
    rng = np.random.default_rng(bits)
    ints = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), 300, dtype=f"int{bits}")
    jdt = jd.FLOAT64 if bits == 64 else jd.FLOAT32
    want = hash_u32(jax_hash.hash_columns(JTable([JColumn(jdt, ints)])))
    got = port_hash.hash_columns(Table([Column(dtype, torch.from_numpy(ints))]))
    np.testing.assert_array_equal(hash_u32(got), want)
    # interop keeps the integer storage of the JAX form
    port = to_port(JTable([JColumn(jdt, ints)])).columns[0]
    assert port.data.dtype == getattr(torch, f"int{bits}")
    np.testing.assert_array_equal(port.data.numpy(), ints)


def test_interop_keeps_float_values():
    """A float column with float storage is unchanged by the bits rule."""
    vals = seeded_doubles(64, 9)
    port = to_port(JTable([JColumn.from_numpy(vals, jd.FLOAT64)])).columns[0]
    assert port.data.dtype == torch.float64
    np.testing.assert_array_equal(port.data.numpy().view(np.int64), vals.view(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_per_plane_chains(seed):
    rng = np.random.default_rng(seed % 997)
    n = 1000
    x32 = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    x64 = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    lo = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    hi = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    cases = [
        (port_hash.hash_int32(torch.from_numpy(x32), seed),
         jax_hash.hash_int32(jnp.asarray(x32), seed)),
        (port_hash.hash_int64(torch.from_numpy(x64), seed),
         jax_hash.hash_int64(jnp.asarray(x64), seed)),
        (port_hash.hash_int64_words(torch.from_numpy(lo), torch.from_numpy(hi), seed),
         jax_hash.hash_int64_words(jnp.asarray(lo), jnp.asarray(hi), seed)),
    ]
    for got, want in cases:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(hash_u32(got), hash_u32(want))
    # a per-row running seed, as the chain passes it
    run = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    np.testing.assert_array_equal(
        hash_u32(port_hash.hash_int32(torch.from_numpy(x32), torch.from_numpy(run))),
        hash_u32(jax_hash.hash_int32(jnp.asarray(x32), jnp.asarray(run.view(np.uint32)))))


def test_kernel_lowering_of_the_bits_form():
    """``murmur3.table_plan`` of a bits-form column gives the planes of a
    float64 column of the same values, and the same hash."""
    vals = seeded_doubles(999, 11)
    valid = np.arange(999) % 3 != 1
    as_float = Column.from_numpy(vals, FLOAT64, validity=valid, device="cpu")
    as_bits = port_hash.f64_bits_column(vals, validity=valid, device="cpu")
    wf, vf, pf = port_kernel.table_plan(Table([as_float]))
    wb, vb, pb = port_kernel.table_plan(Table([as_bits]))
    assert pf == pb
    assert torch.equal(wf, wb) and torch.equal(vf, vb)
    np.testing.assert_array_equal(
        hash_u32(port_kernel.hash_planes(wb, vb, pb, 42)),
        hash_u32(jax_hash.hash_columns(JTable([jax_hash.f64_bits_column(vals, valid)]))))
