"""The port's equi-joins (``ops/join.py``) on the CPU, held exactly
(tolerance 0) against the JAX package's ``join``/``join_padded`` and
against a Python row oracle (tests/test_join.py's, Spark semantics:
null keys never match, NaN == NaN, -0.0 == 0.0, duplicate keys cross).

The inputs are ``chip_smoke.join_spec``'s, the generator of the card
run's join phase, at a few dozen rows. Every distinct shape costs the
JAX package a compile, so the JAX side runs one shape per key layout,
shared across the six join types; the oracle takes more cases. Output
validity is compared through ``validity_or_true()``: a probe-side
column without a mask keeps none in the port's ``join`` output, where
some of the JAX package's paths give an all-true mask (ops/join.py)."""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from spark_rapids_jni_tpu.ops import aggregate as jagg
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu.columnar import strings as jstrs

from spark_rapids_jni_tpu_torch import Table
from spark_rapids_jni_tpu_torch.api import Join
from spark_rapids_jni_tpu_torch.columnar import strings as pstrs
from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy
from spark_rapids_jni_tpu_torch.ops import aggregate as pagg
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from spark_rapids_jni_tpu_torch.ops.sort import gather

from torch_parity import assert_same_table, jax_table

HOWS = cs.HOWS
N_LEFT, N_RIGHT = 48, 40


@pytest.fixture(scope="module")
def sides():
    """(left spec, right spec, left occupied, right occupied)."""
    rng = np.random.default_rng(5)
    return (cs.join_spec(N_LEFT, 1), cs.join_spec(N_RIGHT, 2, long_strings=True),
            rng.random(N_LEFT) < 0.75, rng.random(N_RIGHT) < 0.75)


def port_tables(*specs):
    return [table_from_numpy(s, device="cpu") for s in specs]


def test_join_spec_covers_the_key_kinds(sides):
    left, right, _, _ = sides
    lt, rt = port_tables(left, right)
    floats = torch.cat([lt.columns[2].data, rt.columns[2].data])
    assert torch.isnan(floats).any() and torch.isinf(floats).any()
    assert torch.signbit(floats[floats == 0]).any() and not torch.signbit(floats[floats == 0]).all()
    assert not lt.columns[0].validity.all() and not rt.columns[3].validity.all()
    # the two sides' string keys bucket to different char-matrix widths
    assert pstrs.to_char_matrix(lt.columns[1])[0].shape[1] == 8
    assert pstrs.to_char_matrix(rt.columns[1])[0].shape[1] == 32


@pytest.mark.parametrize("layout", sorted(cs.JOIN_KEYS))
def test_probe_matches_jax(sides, layout):
    """The probe triple (lo, cnt, r_perm) equals the JAX package's, as
    values: float keys (NaN, -0.0, nulls) go through the port's merged
    probe where the JAX package takes its binary search."""
    left, right, _, _ = sides
    lk, rk = cs.JOIN_KEYS[layout]
    want = jjoin._probe(jax_table(left), jax_table(right), lk, rk)
    got = pjoin._probe(*port_tables(left, right), lk, rk)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


# join_spec's fixed-width columns, and where each key layout lands in them
FIXED = (0, 2, 3, 4, 6)
FIXED_KEYS = {"int64": 0, "float64": 1, "decimal128": 2}


def fixed_specs(sides):
    left, right, _, _ = sides
    return [[c for i, c in enumerate(spec) if i in FIXED] for spec in (left, right)]


def jax_join_padded(jl, jr, lk, rk, capacity, how, with_stats=False, **arrays):
    """The JAX package's join_padded, jitted as its distributed caller
    runs it (one compile per call instead of one per eager op);
    ``arrays`` are its occupied masks and char matrices."""
    fn = partial(jjoin.join_padded, left_on=lk, right_on=rk, capacity=capacity, how=how,
                 with_stats=with_stats)
    return jax.jit(fn)(jl, jr, **arrays)


def assert_same_padded(jax_out, port_out):
    for w, g in zip(jax_out[1:], port_out[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert_same_table(jax_out[0], port_out[0], validity_or_true=True)


@pytest.mark.parametrize("layout", sorted(FIXED_KEYS))
def test_join_padded_matches_jax(sides, layout):
    """All six join types through ``join_padded`` equal the JAX
    package's, occupied mask and padding rows included; for INT64 keys
    also with occupied masks on both sides, ``with_stats``, and a
    capacity that truncates the matches."""
    lspec, rspec = fixed_specs(sides)
    jl, jr = jax_table(lspec), jax_table(rspec)
    pl, pr = port_tables(lspec, rspec)
    k = [FIXED_KEYS[layout]]
    cap = N_LEFT * N_RIGHT // 4
    for how in HOWS:
        assert_same_padded(jax_join_padded(jl, jr, k, k, cap, how),
                           pjoin.join_padded(pl, pr, k, k, cap, how))
    if layout != "int64":
        return
    _, _, occ_l, occ_r = sides
    for how in HOWS:
        got = pjoin.join_padded(pl, pr, k, k, cap, how, torch.from_numpy(occ_l),
                                torch.from_numpy(occ_r), with_stats=True)
        assert_same_padded(jax_join_padded(jl, jr, k, k, cap, how, True,
                                           left_occupied=jnp.asarray(occ_l),
                                           right_occupied=jnp.asarray(occ_r)), got)
    got = pjoin.join_padded(pl, pr, k, k, 64, "inner", with_stats=True)
    assert int(got[2]) > 64 and int(got[1].sum()) == 64
    assert_same_padded(jax_join_padded(jl, jr, k, k, 64, "inner", True), got)


def test_join_matches_jax(sides):
    """All six join types through ``join`` over INT64 keys with nulls and
    duplicates and fixed-width payloads (the JAX package's fused
    inner/left path) equal the JAX package's outputs."""
    lspec, rspec = fixed_specs(sides)
    jl, jr = jax_table(lspec), jax_table(rspec)
    pl, pr = port_tables(lspec, rspec)
    for how in HOWS:
        assert_same_table(jjoin.join(jl, jr, [0], [0], how), Join.join(pl, pr, [0], [0], how),
                          validity_or_true=True)


def test_full_join_string_keys_and_payload_match_jax(sides):
    """A full ``join`` with a STRING + INT32 key pair whose string keys
    bucket to different widths, and a string payload: the JAX package's
    char-matrix path, and the unmatched right rows' string tail."""
    left, right, _, _ = sides
    lk, rk = cs.JOIN_KEYS["string+int32"]
    pl, pr = port_tables(left, right)
    assert_same_table(jjoin.join(jax_table(left), jax_table(right), lk, rk, "full"),
                      Join.join(pl, pr, lk, rk, "full"), validity_or_true=True)


def char_mats(strs, tbl, widths):
    return {i: strs.to_char_matrix(tbl.columns[i], w) for i, w in widths.items()}


def test_join_padded_string_keys_match_jax(sides):
    """All six join types through ``join_padded`` over the STRING + INT32
    key pair with prebuilt char matrices of different widths: the
    output's string columns carry padded payloads."""
    left, right, _, _ = sides
    lk, rk = cs.JOIN_KEYS["string+int32"]
    jl, jr = jax_table(left), jax_table(right)
    pl, pr = port_tables(left, right)
    widths = ({1: 16, 5: 16}, {1: 32, 5: 16})
    jm = [char_mats(jstrs, t, w) for t, w in zip((jl, jr), widths)]
    pm = [char_mats(pstrs, t, w) for t, w in zip((pl, pr), widths)]
    cap = 128
    for how in HOWS:
        got = pjoin.join_padded(pl, pr, lk, rk, cap, how, left_mats=pm[0], right_mats=pm[1])
        assert got[0].columns[5].data.shape[0] == cap * 16  # the padded payload
        assert_same_padded(jax_join_padded(jl, jr, lk, rk, cap, how, left_mats=jm[0],
                                           right_mats=jm[1]), got)


@pytest.mark.parametrize("side", ["left", "right"])
def test_empty_side_matches_jax(sides, side):
    lspec, rspec = fixed_specs(sides)
    empty = [dict(c, data=c["data"][:0],
                  validity=None if c["validity"] is None else c["validity"][:0])
             for c in (lspec if side == "left" else rspec)]
    specs = (empty, rspec) if side == "left" else (lspec, empty)
    jl, jr = (jax_table(s) for s in specs)
    pl, pr = port_tables(*specs)
    for how in HOWS:
        assert_same_padded(jax_join_padded(jl, jr, [0], [0], 16, how),
                           pjoin.join_padded(pl, pr, [0], [0], 16, how))
    for how in ("inner", "full"):
        assert_same_table(jjoin.join(jl, jr, [0], [0], how), Join.join(pl, pr, [0], [0], how),
                          validity_or_true=True)


def test_padded_string_payload_groups_like_jax(sides):
    """``group_by_padded(pad_payload=True)`` over a padded string payload
    from ``join_padded`` equals the JAX package's, payload capacity
    included."""
    left, right, _, _ = sides
    lk, rk = cs.JOIN_KEYS["string+int32"]
    widths = ({1: 16, 5: 16}, {1: 32, 5: 16})
    jl, jr = jax_table(left), jax_table(right)
    pl, pr = port_tables(left, right)
    jm = [char_mats(jstrs, t, w) for t, w in zip((jl, jr), widths)]
    pm = [char_mats(pstrs, t, w) for t, w in zip((pl, pr), widths)]
    jt, _ = jax_join_padded(jl, jr, lk, rk, 128, "left", left_mats=jm[0], right_mats=jm[1])
    pt, _ = pjoin.join_padded(pl, pr, lk, rk, 128, "left", left_mats=pm[0], right_mats=pm[1])
    jkeys = {0: jstrs.to_char_matrix(jt.columns[5], 16)}
    pkeys = {0: pstrs.to_char_matrix(pt.columns[5], 16)}

    def jax_group(col, val, mats):
        return jagg.group_by_padded(type(jt)([col, val]), (0,),
                                    (jagg.Agg("sum", 1), jagg.Agg("count")), 32, mats, True)

    jg = jax.jit(jax_group)(jt.columns[5], jt.columns[6], jkeys)
    pg = pagg.group_by_padded(Table([pt.columns[5], pt.columns[6]]), (0,),
                              (pagg.Agg("sum", 1), pagg.Agg("count")), 32, pkeys, True)
    assert pg[0].columns[0].data.shape[0] == 32 * 16
    np.testing.assert_array_equal(pg[1].numpy(), np.asarray(jg[1]))
    assert int(pg[2]) == int(jg[2])
    assert_same_table(jg[0], pg[0])


# ---- against a Python row oracle (tests/test_join.py:36-94) ----

def norm(v):
    if isinstance(v, float):
        if math.isnan(v):
            return ("nan",)
        if v == 0:
            return 0.0
    return v


def oracle_join(lrows, rrows, lk, rk, how, lw, rw):
    """Row-tuple oracle: the sorted multiset of result rows."""
    out = []
    matched_r = set()
    for lrow in lrows:
        lkey = tuple(norm(lrow[i]) for i in lk)
        if any(lrow[i] is None for i in lk):
            hits = []
        else:
            hits = [
                j for j, rrow in enumerate(rrows)
                if not any(rrow[i] is None for i in rk)
                and tuple(norm(rrow[i]) for i in rk) == lkey
            ]
        if how == "left_semi":
            if hits:
                out.append(lrow)
            continue
        if how == "left_anti":
            if not hits:
                out.append(lrow)
            continue
        if hits:
            for j in hits:
                matched_r.add(j)
                out.append(lrow + rrows[j])
        elif how in ("left", "full"):
            out.append(lrow + (None,) * rw)
    if how == "full":
        for j, rrow in enumerate(rrows):
            if j not in matched_r:
                out.append((None,) * lw + rrow)
    return sorted(out, key=lambda r: tuple(str(x) for x in r))


def expected(lt, rt, lk, rk, how):
    lrows, rrows = list(zip(*lt.to_pylists())), list(zip(*rt.to_pylists()))
    lw, rw = lt.num_columns, rt.num_columns
    if how == "right":
        want = oracle_join(rrows, lrows, rk, lk, "left", rw, lw)
        return sorted((r[rw:] + r[:rw] for r in want), key=lambda r: tuple(str(x) for x in r))
    return oracle_join(lrows, rrows, lk, rk, how, lw, rw)


def got_rows(tbl, occ=None):
    rows = zip(*tbl.to_pylists())
    if occ is not None:
        rows = (r for r, live in zip(rows, occ.tolist()) if live)
    return sorted(rows, key=lambda r: tuple(str(x) for x in r))


def as_str(rows):
    return [tuple(map(str, r)) for r in rows]


def compact(spec, occ):
    return gather(table_from_numpy(spec, device="cpu"), torch.from_numpy(np.flatnonzero(occ)))


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("layout", sorted(cs.JOIN_KEYS))
def test_join_matches_oracle(layout, seed):
    """Every join type through ``join`` and ``join_padded``, and
    ``join_padded`` with occupied masks against ``join`` of the
    compacted inputs, equal the row oracle."""
    n, m = 33, 29
    lspec, rspec = cs.join_spec(n, seed), cs.join_spec(m, seed + 50, long_strings=True)
    lt, rt = port_tables(lspec, rspec)
    lk, rk = cs.JOIN_KEYS[layout]
    rng = np.random.default_rng(seed)
    occ_l, occ_r = rng.random(n) < 0.7, rng.random(m) < 0.7
    lc, rc = compact(lspec, occ_l), compact(rspec, occ_r)
    for how in HOWS:
        want = as_str(expected(lt, rt, lk, rk, how))
        assert as_str(got_rows(Join.join(lt, rt, lk, rk, how))) == want, how
        t, occ = pjoin.join_padded(lt, rt, lk, rk, n * m + m, how)
        assert as_str(got_rows(t, occ)) == want, how
        t, occ = pjoin.join_padded(lt, rt, lk, rk, n * m + m, how, torch.from_numpy(occ_l),
                                   torch.from_numpy(occ_r))
        assert as_str(got_rows(t, occ)) == as_str(expected(lc, rc, lk, rk, how)), how


def test_nan_and_signed_zero_keys():
    """tests/test_join.py::test_nan_key_matches_nan on the port."""
    from spark_rapids_jni_tpu_torch import FLOAT64, INT64

    lt = Table.from_pylists([[float("nan"), 1.0, -0.0, None], [1, 2, 3, 4]], [FLOAT64, INT64],
                            device="cpu")
    rt = Table.from_pylists([[float("nan"), 0.0, None], [10, 20, 30]], [FLOAT64, INT64],
                            device="cpu")
    got = got_rows(Join.join(lt, rt, [0], [0], "inner"))
    assert as_str(got) == [("-0.0", "3", "0.0", "20"), ("nan", "1", "nan", "10")]


def test_argument_errors():
    from spark_rapids_jni_tpu_torch import INT64, STRING

    lt = Table.from_pylists([[1], [2]], [INT64, INT64], device="cpu")
    rt = Table.from_pylists([[1], ["a"]], [INT64, STRING], device="cpu")
    with pytest.raises(ValueError, match="equal length"):
        pjoin.join_padded(lt, rt, [0, 1], [0], 8, "inner")
    with pytest.raises(ValueError, match="how="):
        Join.join(lt, rt, [0], [0], "outer")
    with pytest.raises(TypeError, match="dtype mismatch"):
        Join.join(lt, rt, [1], [1])
