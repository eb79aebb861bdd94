"""The port's group-by and segmented scans against the JAX package: the
same seeded tables go through ``spark_rapids_jni_tpu.ops.aggregate`` /
``ops.segmented`` and their torch twins on the CPU.

Every key, count, integer and decimal result, validity bit, string
byte and offset must be equal (tolerance 0). Float sums and means are
held exactly too: the port runs float segment sums as the same
segmented Hillis-Steele scan, so its additions happen in the JAX
package's order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops import aggregate as jagg
from spark_rapids_jni_tpu.ops import segmented as jseg

from spark_rapids_jni_tpu_torch.ops import aggregate as pagg
from spark_rapids_jni_tpu_torch.ops import segmented as pseg

from torch_parity import assert_same_table, to_port

N = 400
WORDS = ["", "a", "ab", "abc", "b", "zzzzzzzzz", "é"]


def agg_table(n=N, seed=0):
    rng = np.random.default_rng(seed)
    valid = lambda p: rng.random(n) > p  # noqa: E731
    fkey = rng.choice([-0.0, 0.0, 1.5, np.nan, -np.inf], n)
    fval = rng.normal(size=n) * 1e3
    fval[::17] = np.nan
    fval[5::23] = np.inf
    d128 = [int(v) for v in rng.choice([-(10**38 - 1), -(2**63), -1, 0, 7, 2**63, 2**64 - 1, 10**38 - 1], n)]
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    return Table([
        Column.from_numpy(rng.integers(0, 4, n).astype(np.int32), jd.INT32, valid(0.1)),   # 0 key
        Column.from_pylist([w if ok else None for w, ok in zip(words, valid(0.1))], jd.STRING),  # 1 key
        Column.from_numpy(fkey, jd.FLOAT64, valid(0.1)),                                   # 2 key
        Column.from_numpy(rng.integers(-(2**62), 2**62, n), jd.INT64, valid(0.2)),        # 3
        Column.from_numpy(fval, jd.FLOAT64, valid(0.2)),                                   # 4
        Column.from_numpy(rng.integers(-(10**17), 10**17, n), jd.DECIMAL64(18, 2)),       # 5
        Column.from_pylist([v if ok else None for v, ok in zip(d128, valid(0.2))], jd.DECIMAL128(38, 3)),  # 6
        Column.from_pylist([w if ok else None for w, ok in zip(words[::-1], valid(0.3))], jd.STRING),  # 7
        Column.from_numpy(rng.integers(0, 2, n).astype(np.int8), jd.BOOL8),                # 8
    ])


@pytest.fixture(scope="module")
def tables():
    jt = agg_table()
    return jt, to_port(jt)


ALL_AGGS = [
    jagg.Agg("count"), jagg.Agg("count", 3),
    jagg.Agg("sum", 3), jagg.Agg("mean", 3), jagg.Agg("min", 3), jagg.Agg("max", 3),
    jagg.Agg("sum", 4), jagg.Agg("mean", 4), jagg.Agg("min", 4), jagg.Agg("max", 4),
    jagg.Agg("sum", 5), jagg.Agg("mean", 5), jagg.Agg("min", 5),
    jagg.Agg("sum", 6), jagg.Agg("mean", 6), jagg.Agg("max", 6),
    jagg.Agg("min", 7), jagg.Agg("max", 7), jagg.Agg("count", 7),
    jagg.Agg("sum", 8),
]

KEY_SETS = {"int": [0], "string": [1], "int_string": [0, 1], "all3": [2, 1, 0]}


def _port_aggs(aggs):
    return [pagg.Agg(a.op, a.column) for a in aggs]


@pytest.mark.parametrize("name", sorted(KEY_SETS))
def test_group_by_matches(tables, name):
    jt, pt = tables
    keys = KEY_SETS[name]
    want = jagg.group_by(jt, keys, ALL_AGGS)
    got = pagg.group_by(pt, keys, _port_aggs(ALL_AGGS))
    assert_same_table(want, got)


def test_group_by_padded_matches(tables):
    jt, pt = tables
    aggs = [jagg.Agg("sum", 6), jagg.Agg("count"), jagg.Agg("max", 7), jagg.Agg("mean", 4)]
    for cap in (3, 64):  # fewer slots than groups, and spare slots
        want, wocc, wng = jagg.group_by_padded(jt, (0, 1), tuple(aggs), cap)
        got, gocc, gng = pagg.group_by_padded(pt, (0, 1), tuple(_port_aggs(aggs)), cap)
        np.testing.assert_array_equal(gocc.numpy(), np.asarray(wocc))
        assert int(gng) == int(wng)
        occ = np.asarray(wocc)
        for w, g in zip(want.columns, got.columns):
            np.testing.assert_array_equal(g.validity.numpy(), np.asarray(w.validity))
            if w.offsets is None:  # padded slots hold don't-care data
                np.testing.assert_array_equal(g.data.numpy()[occ], np.asarray(w.data)[occ])
            else:
                np.testing.assert_array_equal(g.offsets.numpy()[: occ.sum() + 1],
                                              np.asarray(w.offsets)[: occ.sum() + 1])


def test_capacity_error_and_empty(tables):
    jt, pt = tables
    with pytest.raises(ValueError, match="groups exceed capacity 2"):
        pagg.group_by(pt, [0], [pagg.Agg("count")], capacity=2)
    with pytest.raises(ValueError, match="groups exceed capacity 2"):
        jagg.group_by(jt, [0], [jagg.Agg("count")], capacity=2)
    ok_w = jagg.group_by(jt, [0], [jagg.Agg("sum", 3)], capacity=5)
    ok_p = pagg.group_by(pt, [0], [pagg.Agg("sum", 3)], capacity=5)
    assert_same_table(ok_w, ok_p)
    empty = Table([c for c in agg_table(0).columns])
    aggs = [jagg.Agg("count"), jagg.Agg("sum", 6), jagg.Agg("min", 7), jagg.Agg("mean", 4)]
    assert_same_table(jagg.group_by(empty, [1, 0], aggs), pagg.group_by(to_port(empty), [1, 0], _port_aggs(aggs)))
    with pytest.raises(ValueError, match="unknown aggregate op"):
        pagg.group_by(pt, [0], [pagg.Agg("median", 3)])


def test_decimal_sum_helpers_match():
    rng = np.random.default_rng(4)
    lo = rng.integers(-(2**63), 2**63 - 1, 64, dtype=np.int64)
    hi = rng.integers(-(2**63), 2**63 - 1, 64, dtype=np.int64)
    lo[:3], hi[:3] = [-(2**63), -1, 0], [-1, -1, -(2**63)]
    limbs = np.stack([lo, hi], axis=1)
    for data, dt in ((limbs, jd.DECIMAL128(38, 2)), (lo, jd.DECIMAL64(18, 2))):
        want = jagg._decompose_limbs32(jnp.asarray(data), dt)
        got = pagg._decompose_limbs32(torch.from_numpy(data.copy()), dt)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.broadcast_to(g.numpy(), np.shape(w)), np.asarray(w))
    sums = [rng.integers(0, 2**40, 16) for _ in range(8)]
    want = jagg._carry_propagate([jnp.asarray(s) for s in sums])
    got = pagg._carry_propagate([torch.from_numpy(s) for s in sums])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int64))


@pytest.fixture(scope="module")
def segments():
    rng = np.random.default_rng(6)
    n = 333
    boundary = rng.random(n) < 0.1
    boundary[0] = True
    return n, boundary, rng


def test_segmented_primitives_match(segments):
    n, boundary, rng = segments
    jseg_ids = jseg.seg_ids_from_boundary(jnp.asarray(boundary))
    pseg_ids = pseg.seg_ids_from_boundary(torch.from_numpy(boundary))
    np.testing.assert_array_equal(pseg_ids.numpy(), np.asarray(jseg_ids))
    cap = int(np.asarray(jseg_ids)[-1]) + 3
    for c in (cap, 5000):  # the binary search and the scatter form
        np.testing.assert_array_equal(
            pseg.group_starts(pseg_ids, c).numpy(), np.asarray(jseg.group_starts(jseg_ids, c))
        )
    starts_all = np.array(jseg.group_starts(jseg_ids, cap + 1))
    starts, ends = starts_all[:cap], starts_all[1:] - 1
    ints = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)  # sums wrap mod 2^64
    floats = rng.normal(size=n) * 10.0 ** rng.integers(-5, 15, n)
    floats[::41] = np.inf
    floats[3::53] = -0.0
    for x in (ints, floats):
        np.testing.assert_array_equal(
            pseg.seg_cumsum(torch.from_numpy(x), pseg_ids).numpy(),
            np.asarray(jseg.seg_cumsum(jnp.asarray(x), jseg_ids)),
        )
        np.testing.assert_array_equal(
            pseg.seg_sum(torch.from_numpy(x), pseg_ids, torch.from_numpy(starts), torch.from_numpy(ends)).numpy(),
            np.asarray(jseg.seg_sum(jnp.asarray(x), jseg_ids, jnp.asarray(starts), jnp.asarray(ends))),
        )
    ops = [rng.integers(0, 3, n).astype(np.int8), rng.choice([-1.0, 0.0, -0.0, 2.0], n)]
    for is_max in (False, True):
        np.testing.assert_array_equal(
            pseg.seg_scan_argext([torch.from_numpy(o) for o in ops], pseg_ids, is_max).numpy(),
            np.asarray(jseg.seg_scan_argext([jnp.asarray(o) for o in ops], jseg_ids, is_max)),
        )
    b_ops = [o[::-1].copy() for o in ops]
    for g, w in zip(pseg.lex_lt([torch.from_numpy(o) for o in ops], [torch.from_numpy(o) for o in b_ops]),
                    jseg.lex_lt([jnp.asarray(o) for o in ops], [jnp.asarray(o) for o in b_ops])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sorted_ops = [np.sort(rng.integers(0, 4, n)), rng.integers(0, 2, (n, 3))]
    np.testing.assert_array_equal(
        pseg.boundary_from_operands([torch.from_numpy(o) for o in sorted_ops]).numpy(),
        np.asarray(jseg.boundary_from_operands([jnp.asarray(o) for o in sorted_ops])),
    )
