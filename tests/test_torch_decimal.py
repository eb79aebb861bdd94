"""The port's limb arithmetic and DECIMAL128 operators against the JAX
package, exactly: the same limbs, made from a seed, go through
``spark_rapids_jni_tpu.utils.int128/int256`` and ``ops/decimal.py`` and
through their torch twins on the CPU. Every output limb, overflow flag
and validity bit must be equal (tolerance 0).

Edge limbs ride every case: ±(10^38 - 1), the int64 limb -1, INT64_MIN
(2^63 and -2^63 as DECIMAL128) and 2^64 - 1 — the operands on which a
hidden arithmetic right shift or signed compare would show."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column, DECIMAL128, Table
from spark_rapids_jni_tpu.ops import decimal as jdec
from spark_rapids_jni_tpu.utils import int128 as j128
from spark_rapids_jni_tpu.utils import int256 as j256

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch.ops import decimal as pdec
from spark_rapids_jni_tpu_torch.utils import int128 as p128
from spark_rapids_jni_tpu_torch.utils import int256 as p256

from torch_parity import assert_same_table, to_port

EDGE_VALUES = [
    10**38 - 1, -(10**38 - 1), -1, 2**63, -(2**63), 2**64 - 1, -(2**64 - 1), 0, 1,
]
EDGE_U64 = [0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1, 10**19, 0x8000000000000001]


def u64_array(rng, n):
    """uint64 [n]: random 64-bit values with the edge values in front."""
    v = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    v[: len(EDGE_U64)] = np.array(EDGE_U64, dtype=np.uint64)
    return v


def as_port(x):
    """A JAX uint64/int64 array (or a tuple of them) as int64 tensors."""
    if isinstance(x, tuple):
        return tuple(as_port(t) for t in x)
    return torch.from_numpy(np.asarray(x).view(np.int64).copy())


def assert_limbs_equal(port, jax):
    if isinstance(port, tuple):
        assert len(port) == len(jax)
        for i, (p, j) in enumerate(zip(port, jax)):
            np.testing.assert_array_equal(
                np.broadcast_to(np.asarray(p), np.shape(j)).view(np.int64),
                np.asarray(j).view(np.int64), err_msg=f"limb {i}")
        return
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax))


def rand_values(rng, n, digits_hi=38):
    vals = [rng.randrange(10 ** rng.randint(1, digits_hi)) * rng.choice((1, -1)) for _ in range(n)]
    vals[: len(EDGE_VALUES)] = EDGE_VALUES
    return vals


def dec_col(values, precision, scale, nulls=None):
    vals = list(values)
    for i in nulls or ():
        vals[i] = None
    return Column.from_pylist(vals, DECIMAL128(precision, scale))


def both(*jax_cols):
    """JAX columns and the same columns as port columns on the CPU."""
    return jax_cols, to_port(Table(list(jax_cols))).columns


# ---------------------------------------------------------------------------
# int128


def test_int128_helpers_match():
    rng = np.random.default_rng(0)
    a, b = u64_array(rng, 64), u64_array(rng, 64)[::-1].copy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pa, pb = as_port(ja), as_port(jb)
    assert_limbs_equal(p128.mul64(pa, pb), j128.mul64(ja, jb))
    A, B = (ja, jb), (jb, ja)
    PA, PB = (pa, pb), (pb, pa)
    for name in ("add", "sub", "lt", "gt", "le", "ge", "eq"):
        assert_limbs_equal(getattr(p128, name)(PA, PB), getattr(j128, name)(A, B))
    assert_limbs_equal(p128.neg(PA), j128.neg(A))
    assert_limbs_equal(p128.add_u64(PA, pb), j128.add_u64(A, jb))
    assert_limbs_equal(p128.mul_u64(PA, pb), j128.mul_u64(A, jb))
    assert_limbs_equal(p128.is_zero(PA), j128.is_zero(A))
    assert_limbs_equal(p128.digit_count(PA), j128.digit_count(A))
    small = (jnp.asarray(np.array(EDGE_U64, np.uint64)), jnp.zeros(len(EDGE_U64), jnp.uint64))
    assert_limbs_equal(p128.digit_count(as_port(small)), j128.digit_count(small))
    assert_limbs_equal(p128.const(10**38 - 1), j128.from_int(10**38 - 1, (1,)))
    assert_limbs_equal(p256.const(-(10**38 - 1)), j256.from_int(-(10**38 - 1), (1,)))
    assert_limbs_equal(p128.pow10_table("cpu"), j128.pow10_table())
    limbs = np.stack([a.view(np.int64), b.view(np.int64)], axis=1)
    (jm, jn) = j128.from_signed_limbs(jnp.asarray(limbs))
    (pm, pn) = p128.from_signed_limbs(torch.from_numpy(limbs))
    assert_limbs_equal(pm, jm)
    assert_limbs_equal(pn, jn)
    assert_limbs_equal(p128.to_signed_limbs(pm, pn), j128.to_signed_limbs(jm, jn))


# ---------------------------------------------------------------------------
# int256


@pytest.fixture(scope="module")
def u256_operands():
    rng = np.random.default_rng(1)
    n = 96
    limbs = [u64_array(rng, n) for _ in range(4)]
    limbs[2][40:] = 0  # a band of small and negative magnitudes too
    limbs[3][40:] = 0
    limbs[3][70:] = np.uint64(2**64 - 1)
    limbs[2][70:] = np.uint64(2**64 - 1)
    j = tuple(jnp.asarray(x) for x in limbs)
    return j, as_port(j)


def test_int256_arith_matches(u256_operands):
    ja, pa = u256_operands
    jb = tuple(x[::-1] for x in ja)
    pb = tuple(x.flip(0) for x in pa)
    assert_limbs_equal(p256.add(pa, pb), j256.add(ja, jb))
    assert_limbs_equal(p256.mul(pa, pb), j256.mul(ja, jb))
    assert_limbs_equal(p256.neg(pa), j256.neg(ja))
    assert_limbs_equal(p256.abs_(pa)[0], j256.abs_(ja)[0])
    assert_limbs_equal(p256.lt_unsigned(pa, pb), j256.lt_unsigned(ja, jb))
    assert_limbs_equal(p256.eq(pa, pb), j256.eq(ja, jb))
    assert_limbs_equal(p256.is_zero(pa), j256.is_zero(ja))
    assert_limbs_equal(p256.precision10(pa), j256.precision10(ja))
    assert_limbs_equal(p256.is_greater_than_decimal_38(pa), j256.is_greater_than_decimal_38(ja))
    big = j256.from_int(10**77, (1,))
    assert_limbs_equal(p256.lt_unsigned(pa, p256.const(10**77)), j256.lt_unsigned(ja, big))
    inc = np.resize(np.array([0, 1, -1], np.int64), ja[0].shape[0])
    assert_limbs_equal(p256.add_small(pa, torch.from_numpy(inc)), j256.add_small(ja, jnp.asarray(inc)))
    full = np.arange(6)
    jm = tuple(ja[i % 4] for i in full)
    pm = tuple(pa[i % 4] for i in full)
    assert_limbs_equal(tuple(p256._mul_full(pa, pm)), tuple(j256._mul_full(ja, jm)))


def test_int256_division_matches(u256_operands):
    ja, pa = u256_operands
    rng = np.random.default_rng(2)
    n = ja[0].shape[0]
    d_lo, d_hi = u64_array(rng, n), rng.integers(0, 1 << 64, n, dtype=np.uint64)
    d_hi[n // 2:] = 0  # 64-bit divisors too
    d_lo[d_lo == 0] = 7
    jd = (jnp.asarray(d_lo), jnp.asarray(d_hi))
    pd = as_port(jd)
    assert_limbs_equal(p256.divmod_u128(pa, *pd), j256.divmod_u128(ja, *jd))
    neg = rng.random(n) < 0.5
    assert_limbs_equal(
        p256.divide_and_round(pa, pd, torch.from_numpy(neg)),
        j256.divide_and_round(ja, jd, jnp.asarray(neg)),
    )
    assert_limbs_equal(
        p256.integer_divide(pa, pd, torch.from_numpy(neg)),
        j256.integer_divide(ja, jd, jnp.asarray(neg)),
    )
    exps = rng.integers(0, 39, n).astype(np.int32)
    jmag = j256.abs_(ja)[0]
    assert_limbs_equal(
        p256.divmod_pow10(p256.abs_(pa)[0], torch.from_numpy(exps)),
        j256.divmod_pow10(jmag, jnp.asarray(exps)),
    )
    assert_limbs_equal(
        p256.divide_and_round_pow10(pa, torch.from_numpy(exps)),
        j256.divide_and_round_pow10(ja, jnp.asarray(exps)),
    )
    for old, new in ((2, 6), (6, 2), (0, 38), (4, 4)):
        assert_limbs_equal(
            p256.set_scale_and_round(pa, old, new), j256.set_scale_and_round(ja, old, new)
        )


# ---------------------------------------------------------------------------
# ops/decimal.py


def _assert_op(jax_fn, port_fn, jcols, pcols, *args):
    want = jax_fn(*jcols, *args)
    got = port_fn(*pcols, *args)
    assert got.names == want.names
    assert_same_table(want, got)
    return want


@pytest.mark.parametrize(
    "pa,sa,pb,sb,ps,regime",
    [
        (12, 2, 13, 2, 4, "i128"),  # q1's (12,2) x (13,2)
        (18, 6, 19, 0, 6, "i128"),
        (38, 3, 38, 4, 7, "noshift"),
        (26, 4, 13, 2, 6, "noshift"),  # q1's (26,4) x (13,2)
        (38, 2, 38, 3, 4, "scales_any"),
        (38, 10, 38, 10, 6, "scales_any"),
        (38, 34, 38, 19, 17, "scales_any"),
    ],
)
def test_multiply128_matches(pa, sa, pb, sb, ps, regime):
    rng = random.Random(pa * 1000 + sa * 100 + ps)
    n = 48
    av = rand_values(rng, n, min(pa, 38))
    bv = rand_values(rng, n, min(pb, 38))[::-1]
    if regime != "i128":
        # overflow rows: a product in [10^38, 10^77) and the largest
        # i128 products (|a*b| < 2^254 < 10^77, so the noshift kernel's
        # third regime has no i128 input; its compare is held at the
        # int256 level above), and one beyond 10^76 where precision10
        # returns its -1 sentinel
        av[-4:] = [10**20, 2**127 - 1, -(2**127), 15 * 10**37]
        bv[-4:] = [10**20, 2**127 - 1, -(2**127), 2**127 - 1]
    else:
        av = [v % 10**pa for v in av]
        bv = [v % 10**pb for v in bv]
    jcols, pcols = both(dec_col(av, pa, sa, nulls=(5,)), dec_col(bv, pb, sb))
    want = _assert_op(jdec.multiply128, pdec.multiply128, jcols, pcols, ps)
    over = np.asarray(want.columns[0].data)
    if regime != "i128":
        assert over.any()


@pytest.mark.parametrize("a_s,b_s,ts", [(2, 5, 5), (10, 3, 6), (6, 6, 2), (0, 0, 0), (38, 0, 1)])
def test_add_sub128_matches(a_s, b_s, ts):
    rng = random.Random(a_s * 100 + b_s * 10 + ts)
    n = 48
    av, bv = rand_values(rng, n), rand_values(rng, n)[::-1]
    jcols, pcols = both(dec_col(av, 38, a_s), dec_col(bv, 38, b_s, nulls=(3, 9)))
    _assert_op(jdec.add128, pdec.add128, jcols, pcols, ts)
    _assert_op(jdec.subtract128, pdec.subtract128, jcols, pcols, ts)


@pytest.mark.parametrize("a_s,b_s,ts,sub", [(2, 3, 4, False), (6, 0, 2, True), (10, 10, 6, True)])
def test_add_sub_runtime_scales_match(a_s, b_s, ts, sub):
    rng = random.Random(a_s * 100 + b_s * 10 + ts + sub)
    av, bv = rand_values(rng, 32), rand_values(rng, 32)[::-1]
    (ja, jb), (pa, pb) = both(dec_col(av, 38, a_s), dec_col(bv, 38, b_s))
    want = jdec._add_sub_scales_any(ja.data, jb.data, jnp.int32(a_s), jnp.int32(b_s), jnp.int32(ts), sub)
    got = pdec._add_sub_scales_any(pa.data, pb.data, a_s, b_s, ts, sub)
    assert_limbs_equal(got, want)


@pytest.mark.parametrize("a_s,b_s,qs", [(1, 1, 6), (6, 0, 2), (0, 2, 38), (0, 0, 0)])
def test_divide128_matches(a_s, b_s, qs):
    rng = random.Random(a_s * 100 + b_s * 10 + qs)
    n = 40
    av = rand_values(rng, n)
    bv = rand_values(rng, n, 30)[::-1]
    bv[0] = bv[11] = 0  # zero divisors
    jcols, pcols = both(dec_col(av, 38, a_s, nulls=(7,)), dec_col(bv, 38, b_s))
    want = _assert_op(jdec.divide128, pdec.divide128, jcols, pcols, qs)
    assert np.asarray(want.columns[0].data)[0] == 1


@pytest.mark.parametrize("a_s,b_s", [(2, 3), (10, 2)])
def test_integer_divide128_matches(a_s, b_s):
    rng = random.Random(a_s * 10 + b_s)
    n = 40
    av = rand_values(rng, n)
    bv = rand_values(rng, n, 20)[::-1]
    bv[4] = 0
    jcols, pcols = both(dec_col(av, 38, a_s), dec_col(bv, 38, b_s, nulls=(2,)))
    _assert_op(jdec.integer_divide128, pdec.integer_divide128, jcols, pcols)


def test_decimal_guards_match():
    (ja, jb), (pa, pb) = both(dec_col([1], 38, 38), dec_col([1], 38, -40))
    for fn in (jdec.add128, pdec.add128):
        with pytest.raises(ValueError, match="256-bit"):
            fn(*((ja, jb) if fn is jdec.add128 else (pa, pb)), 0)
    with pytest.raises(ValueError, match="divisor too big"):
        pdec.multiply128(pa, pa, 0)
    with pytest.raises(TypeError, match="not a DECIMAL128"):
        pdec.add128(pa, port.Column.from_pylist([1], port.INT64, device="cpu"), 0)


@pytest.mark.parametrize("scales_as", ["int", "tensor"])
def test_multiply_runtime_scales_match(scales_as):
    """The generic multiply with scales given at run time (0-d tensors)
    or as Python ints, against the JAX kernel with traced scales."""
    rng = random.Random(11)
    av, bv = rand_values(rng, 32), rand_values(rng, 32)[::-1]
    (ja, jb), (pa, pb) = both(dec_col(av, 38, 2), dec_col(bv, 38, 3))
    want = jdec._multiply_scales_any(ja.data, jb.data, jnp.int32(2), jnp.int32(3), jnp.int32(4))
    scales = (2, 3, 4) if scales_as == "int" else tuple(torch.tensor(s) for s in (2, 3, 4))
    got = pdec._multiply_scales_any(pa.data, pb.data, *scales)
    assert_limbs_equal(got, want)
