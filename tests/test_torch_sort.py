"""The port's sort, gather, order-word packing and filter against the
JAX package, exactly: the same seeded table goes through
``spark_rapids_jni_tpu.ops.sort``/``filter``/``rowgather`` and their
torch twins on the CPU. Permutations, data, validity bits, string
bytes and offsets must be equal (tolerance 0).

The table carries what makes a multi-key sort hard to get exactly
right: heavy key ties (stability decides the order), NaN, -0.0 and
infinities, nulls, DECIMAL128 limbs of both signs, strings with shared
prefixes and empty strings."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops import filter as jfilter
from spark_rapids_jni_tpu.ops import rowgather as jrow
from spark_rapids_jni_tpu.ops import sort as jsort

from spark_rapids_jni_tpu_torch.columnar import strings as pstrings
from spark_rapids_jni_tpu_torch.ops import filter as pfilter
from spark_rapids_jni_tpu_torch.ops import rowgather as prow
from spark_rapids_jni_tpu_torch.ops import sort as psort

from torch_parity import assert_same_table, to_port

N = 300
WORDS = ["", "a", "ab", "abc", "abd", "b", "ba", "zzzzzzzz", "zzzzzzzza", "été", "A"]


def mixed_table(n=N, seed=0):
    """Every key type the sort takes, with ties, NaN/-0.0/inf and nulls."""
    rng = np.random.default_rng(seed)
    f64 = rng.choice([-1.5, -0.0, 0.0, 2.0, np.nan, np.inf, -np.inf, 1e300], n)
    f32 = rng.choice([-2.0, -0.0, 0.0, 3.5, np.nan], n).astype(np.float32)
    d128 = [int(v) for v in rng.choice([-(10**38 - 1), -(2**63), -1, 0, 1, 2**63, 2**64 - 1, 10**38 - 1], n)]
    valid = lambda p: rng.random(n) > p  # noqa: E731
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    strs_valid = valid(0.15)
    cols = [
        Column.from_numpy(rng.integers(-3, 4, n).astype(np.int32), jd.INT32, valid(0.2)),
        Column.from_numpy(rng.integers(-(2**62), 2**62, n) // (2**60), jd.INT64),
        Column.from_numpy(f64, jd.FLOAT64, valid(0.1)),
        Column.from_numpy(f32, jd.FLOAT32),
        Column.from_numpy(rng.integers(-5, 5, n), jd.DECIMAL64(12, 2)),
        Column.from_pylist([v if ok else None for v, ok in zip(d128, valid(0.1))], jd.DECIMAL128(38, 2)),
        Column.from_pylist([w if ok else None for w, ok in zip(words, strs_valid)], jd.STRING),
        Column.from_numpy(rng.integers(0, 2, n).astype(np.int8), jd.BOOL8),
        Column.from_numpy(rng.integers(10_000, 10_004, n).astype(np.int32), jd.DATE32),
    ]
    return Table(cols)


@pytest.fixture(scope="module")
def tables():
    jt = mixed_table()
    return jt, to_port(jt)


KEY_SETS = {
    "int_asc": [jsort.SortKey(0)],
    "int_desc_nulls_first": [jsort.SortKey(0, ascending=False, nulls_first=True)],
    "float64_asc": [jsort.SortKey(2)],
    "float64_desc": [jsort.SortKey(2, ascending=False)],
    "float32_desc_nulls_last": [jsort.SortKey(3, ascending=False, nulls_first=False)],
    "decimals": [jsort.SortKey(4), jsort.SortKey(5, ascending=False)],
    "string_asc": [jsort.SortKey(6)],
    "string_desc_nulls_first": [jsort.SortKey(6, ascending=False, nulls_first=True)],
    "multi": [jsort.SortKey(8), jsort.SortKey(7, ascending=False), jsort.SortKey(6), jsort.SortKey(1)],
    "ties_only": [jsort.SortKey(7)],
}


def _port_keys(keys):
    return [psort.SortKey(k.column, k.ascending, k.nulls_first) for k in keys]


@pytest.mark.parametrize("name", sorted(KEY_SETS))
def test_sort_order_and_table_match(tables, name):
    jt, pt = tables
    keys = KEY_SETS[name]
    want = np.asarray(jsort.sort_order(jt, keys))
    got = psort.sort_order(pt, _port_keys(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert_same_table(jsort.sort_table(jt, keys), psort.sort_table(pt, _port_keys(keys)))


@pytest.mark.parametrize("col", range(9))
@pytest.mark.parametrize("ascending,nulls_first", [(True, True), (False, False), (False, True)])
def test_order_keys_match(tables, col, ascending, nulls_first):
    jt, pt = tables
    want = jsort.order_keys(jt.columns[col], ascending, nulls_first, force_null_key=True)
    got = psort.order_keys(pt.columns[col], ascending, nulls_first, force_null_key=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_order_words_match():
    rng = np.random.default_rng(3)
    n = 128
    np_ops = [
        rng.integers(-128, 128, n).astype(np.int8),
        rng.integers(-(2**31), 2**31, n).astype(np.int32),
        rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
        rng.integers(-(2**15), 2**15, n).astype(np.int16),
        rng.integers(0, 256, n).astype(np.uint8),
    ]
    np_ops[2][:3] = [-(2**63), -1, 2**63 - 1]
    want = np.asarray(jrow.pack_order_words([jnp.asarray(o) for o in np_ops]))
    p_ops = [torch.from_numpy(o.copy()) for o in np_ops]
    # the port's 8-byte words hold the JAX package's byte stream of
    # 4-byte words, row by row, zero-padded to whole 8-byte words
    wide = prow.pack_order_words(p_ops).numpy().view(np.uint64)
    assert wide.shape == (n, -(-want.shape[1] // 2))
    jax_rows = want.astype(">u4").reshape(n, -1)
    for r in range(n):
        assert wide[r].astype(">u8").tobytes() == jax_rows[r].tobytes().ljust(wide.shape[1] * 8, b"\0")
    assert prow.orderable_ops(p_ops) and jrow.orderable_ops([jnp.asarray(o) for o in np_ops])
    for bad in (np.zeros(2, np.float64), np.zeros(2, np.bool_), np.zeros(2, np.uint64)):
        assert not prow.orderable_ops([torch.from_numpy(bad)])
        assert not jrow.orderable_ops([jnp.asarray(bad)])
    with pytest.raises(TypeError):
        prow.pack_order_words([torch.zeros(2, dtype=torch.float32)])


@pytest.mark.parametrize("col", [0, 5, 6])
def test_gather_column_match(tables, col):
    jt, pt = tables
    perm = np.random.default_rng(col).permutation(N)[: N // 2].astype(np.int32)
    want = jsort.gather_column(jt.columns[col], jnp.asarray(perm))
    got = psort.gather_column(pt.columns[col], torch.from_numpy(perm))
    assert_same_table(Table([want]), type(pt)([got]))
    got_take = pstrings.take(pt.columns[6], torch.from_numpy(perm))
    assert_same_table(Table([jsort.gather_column(jt.columns[6], jnp.asarray(perm))]), type(pt)([got_take]))


def test_filter_table_match(tables):
    jt, pt = tables
    rng = np.random.default_rng(5)
    keep = rng.random(N) < 0.4
    pred_valid = rng.random(N) > 0.2
    jpred = Column.from_numpy(keep.astype(np.int8), jd.BOOL8, pred_valid)
    ppred = to_port(Table([jpred])).columns[0]
    assert_same_table(jfilter.filter_table(jt, jpred), pfilter.filter_table(pt, ppred))
    # a bare mask, and a mask that keeps nothing
    assert_same_table(
        jfilter.filter_table(jt, jnp.asarray(keep)), pfilter.filter_table(pt, torch.from_numpy(keep))
    )
    none = np.zeros(N, bool)
    assert_same_table(
        jfilter.filter_table(jt, jnp.asarray(none)), pfilter.filter_table(pt, torch.from_numpy(none))
    )
    with pytest.raises(ValueError, match="predicate has"):
        pfilter.filter_table(pt, torch.ones(3, dtype=torch.bool))


def test_empty_and_identity_sorts():
    jt = Table([Column.from_numpy(np.zeros(0, np.int32), jd.INT32)])
    pt = to_port(jt)
    assert psort.sort_order(pt, [psort.SortKey(0)]).shape == (0,)
    jt3 = mixed_table(5, seed=1)
    pt3 = to_port(jt3)
    np.testing.assert_array_equal(psort.sort_order(pt3, []).numpy(), np.asarray(jsort.sort_order(jt3, [])))
