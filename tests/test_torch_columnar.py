"""The columnar, limb, word and string-span names the port shares with
the JAX package: ``Column.num_rows`` / ``has_nulls`` / ``null_count``,
``bool_column``, ``Table.compact_validity``, ``MAX_PRECISION``, the
``u128`` / ``from_int`` / ``zeros`` limb constructors of both widths,
``rowgather.words_lt`` / ``words_eq`` and ``strings.live_span_stats``.
Each is held to the JAX package at tolerance 0 on the same seeded
numpy inputs, nulls and empty columns included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import column as jcolumn
from spark_rapids_jni_tpu.columnar import dtypes as jdtypes
from spark_rapids_jni_tpu.columnar import strings as jstrings
from spark_rapids_jni_tpu.ops import rowgather as jrowgather
from spark_rapids_jni_tpu.utils import int128 as j128
from spark_rapids_jni_tpu.utils import int256 as j256

from spark_rapids_jni_tpu_torch.columnar import column as pcolumn
from spark_rapids_jni_tpu_torch.columnar import dtypes as pdtypes
from spark_rapids_jni_tpu_torch.columnar import strings as pstrings
from spark_rapids_jni_tpu_torch.ops import rowgather as prowgather
from spark_rapids_jni_tpu_torch.utils import int128 as p128
from spark_rapids_jni_tpu_torch.utils import int256 as p256

from torch_parity import assert_same_table, jax_table, to_port


def _spec(kind, n, p_null, seed):
    rng = np.random.default_rng(seed)
    valid = None if p_null is None else rng.random(n) >= p_null
    if kind == "string":
        lens = rng.integers(0, 9, n)
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        data = rng.integers(97, 123, int(offsets[-1])).astype(np.uint8)
        return {"dtype": ("string", 0, None, None), "data": data, "validity": valid,
                "offsets": offsets}
    if kind == "decimal128":
        lo = rng.integers(-(2**62), 2**62, n)
        data = np.stack([lo, np.where(lo < 0, -1, 0)], 1).astype(np.int64)
        return {"dtype": ("decimal", 128, 38, 2), "data": data, "validity": valid,
                "offsets": None}
    dt = {"int32": ("int", 32, None, None), "float64": ("float", 64, None, None)}[kind]
    data = rng.normal(size=n) if kind == "float64" else rng.integers(-9, 9, n).astype(np.int32)
    return {"dtype": dt, "data": data, "validity": valid, "offsets": None}


COLUMNS = {
    "int32 no mask": ("int32", 300, None),
    "float64 with nulls": ("float64", 300, 0.3),
    "string with nulls": ("string", 250, 0.5),
    "decimal128 all valid mask": ("decimal128", 200, 0.0),
    "empty with mask": ("int32", 0, 0.5),
    "all null": ("float64", 50, 1.0),
}


@pytest.mark.parametrize("case", sorted(COLUMNS))
def test_column_accessors(case):
    kind, n, p_null = COLUMNS[case]
    spec = [_spec(kind, n, p_null, seed=len(case))]
    jcol, pcol = jax_table(spec).columns[0], to_port(jax_table(spec)).columns[0]
    assert (pcol.num_rows, pcol.has_nulls, pcol.null_count()) == (
        jcol.num_rows, jcol.has_nulls, jcol.null_count())
    assert isinstance(pcol.null_count(), int)


@pytest.mark.parametrize("with_validity", [False, True])
def test_bool_column(with_validity):
    rng = np.random.default_rng(4)
    mask = rng.random(129) > 0.5
    valid = rng.random(129) > 0.2 if with_validity else None
    jcol = jcolumn.bool_column(jnp.asarray(mask), None if valid is None else jnp.asarray(valid))
    pcol = pcolumn.bool_column(torch.from_numpy(mask),
                               None if valid is None else torch.from_numpy(valid))
    assert pcol.dtype == pdtypes.BOOL8 and pcol.data.dtype == torch.int8
    np.testing.assert_array_equal(pcol.data.numpy(), np.asarray(jcol.data))
    if valid is not None:
        np.testing.assert_array_equal(pcol.validity.numpy(), np.asarray(jcol.validity))
    assert pcol.null_count() == jcol.null_count()


TABLES = {
    # masks all true on some columns and not on others, a string among them
    "mixed": [("int32", 0.0), ("float64", 0.4), ("string", 0.0), ("decimal128", 0.1)],
    "no masks": [("int32", None), ("string", None)],
    "all true": [("float64", 0.0), ("string", 0.0)],
}


@pytest.mark.parametrize("case", sorted(TABLES))
def test_compact_validity(case):
    spec = [_spec(kind, 100, p, seed=i) for i, (kind, p) in enumerate(TABLES[case])]
    jtbl = jax_table(spec)
    ptbl = to_port(jtbl)
    want = jtbl.compact_validity()
    assert_same_table(want, ptbl.compact_validity())
    # the fast path: null counts the caller already read
    counts = [c.null_count() for c in ptbl.columns if c.has_nulls]
    assert_same_table(want, ptbl.compact_validity(counts))
    if case == "no masks":
        assert ptbl.compact_validity() is ptbl


def test_max_precision():
    assert pdtypes.MAX_PRECISION == jdtypes.MAX_PRECISION


def _limbs(limbs):
    return [np.asarray(x).astype(np.uint64) for x in limbs]


def _port_limbs(limbs):
    return [x.numpy().view(np.uint64) for x in limbs]


@pytest.mark.parametrize("value", [0, -1, 10**38, 10**77])
def test_from_int_both_widths(value):
    for shape in ((), (3,), (2, 2)):
        for jmod, pmod in ((j128, p128), (j256, p256)):
            got = _port_limbs(pmod.from_int(value, shape, device="cpu"))
            want = _limbs(jmod.from_int(value, shape))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def test_u128_and_zeros():
    rng = np.random.default_rng(8)
    lo = rng.integers(0, 2**64, 17, dtype=np.uint64)
    hi = rng.integers(0, 2**64, 17, dtype=np.uint64)
    got = p128.u128(torch.from_numpy(lo.view(np.int64)), torch.from_numpy(hi.view(np.int64)))
    for g, w in zip(_port_limbs(got), _limbs(j128.u128(lo, hi))):
        np.testing.assert_array_equal(g, w)
    # Python-int limbs, at and above 2^63
    got = p128.u128(2**64 - 1, 2**63, device="cpu")
    for g, w in zip(_port_limbs(got), _limbs(j128.u128(2**64 - 1, 2**63))):
        np.testing.assert_array_equal(g, w)
    for jz, pz in ((j128.zeros((4,)), p128.zeros((4,), device="cpu")),
                   (j256.zeros(), p256.zeros(device="cpu")),
                   (j256.zeros((2, 3)), p256.zeros((2, 3), device="cpu"))):
        for g, w in zip(_port_limbs(pz), _limbs(jz)):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("W", [0, 3])
def test_words_lt_eq(W):
    """uint32 word rows with many ties: the JAX functions on uint32, the
    port's on the int32 words holding the same bits."""
    rng = np.random.default_rng(W)
    n = 500
    pick = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    a = pick[rng.integers(0, 5, (n, W))]
    b = np.where(rng.random((n, W)) < 0.5, a, pick[rng.integers(0, 5, (n, W))])
    want_lt = np.asarray(jrowgather.words_lt(jnp.asarray(a), jnp.asarray(b)))
    want_eq = np.asarray(jrowgather.words_eq(jnp.asarray(a), jnp.asarray(b)))
    pa, pb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    np.testing.assert_array_equal(prowgather.words_lt(pa, pb).numpy(), want_lt)
    np.testing.assert_array_equal(prowgather.words_eq(pa, pb).numpy(), want_eq)
    if W:
        # the port's own int64 order words compare as their operands do
        x = rng.integers(-3, 3, (n, 2)).astype(np.int64)
        y = rng.integers(-3, 3, (n, 2)).astype(np.int64)
        wx = prowgather.pack_order_words([torch.from_numpy(x[:, 0]), torch.from_numpy(x[:, 1])])
        wy = prowgather.pack_order_words([torch.from_numpy(y[:, 0]), torch.from_numpy(y[:, 1])])
        lex = np.array([tuple(r) < tuple(s) for r, s in zip(x, y)])
        np.testing.assert_array_equal(prowgather.words_lt(wx, wy).numpy(), lex)


@pytest.mark.parametrize("n,p_keep", [(300, 0.6), (40, 0.0), (0, 0.5)])
def test_live_span_stats(n, p_keep):
    spec = _spec("string", n, 0.2, seed=n)
    keep = np.random.default_rng(n + 1).random(n) < p_keep
    jt, jm = jstrings.live_span_stats(jnp.asarray(spec["offsets"]), jnp.asarray(keep))
    pt, pm = pstrings.live_span_stats(torch.from_numpy(spec["offsets"]), torch.from_numpy(keep))
    assert pt.dtype == torch.int32 and pm.dtype == torch.int32
    assert (int(pt), int(pm)) == (int(jt), int(jm))
