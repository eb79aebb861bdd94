"""The port's JSON scans and get_json_object against the JAX package's
(exact), over chip_smoke's phase-11 batch and hand-made documents, plus
the oracle cases of tests/test_get_json_object.py run on the port."""

import json
import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.ops import _json_scans as jscans
from spark_rapids_jni_tpu.ops import get_json_object as jgjo

from spark_rapids_jni_tpu_torch import STRING, Column, Table
from spark_rapids_jni_tpu_torch.columnar.strings import to_char_matrix
from spark_rapids_jni_tpu_torch.ops import _json_scans as pscans
from spark_rapids_jni_tpu_torch.ops import get_json_object as pgjo

from torch_parity import assert_same_table, jax_table

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

N = 384


@pytest.fixture(scope="module")
def batch():
    spec = chip_smoke.cast_json_spec(N, seed=31)
    return jax_table(spec), spec


def _port_col(spec):
    from spark_rapids_jni_tpu_torch.columnar.interop import column_from_numpy

    return column_from_numpy(spec, device="cpu")


@pytest.mark.parametrize("col", [2, 3])
def test_structure_fields_match(batch, col):
    jt, spec = batch
    from spark_rapids_jni_tpu.columnar.strings import to_char_matrix as jcm

    jchars, _ = jcm(jt.columns[col])
    pchars, _ = to_char_matrix(_port_col(spec[col]))
    np.testing.assert_array_equal(pchars.numpy(), np.asarray(jchars))
    js, ps = jscans.structure(jchars), pscans.structure(pchars)
    for f in ("idx", "esc", "quote", "outside", "open_b", "close_b", "d", "q_after", "nonws",
              "past_end"):
        got = getattr(ps, f).numpy()
        want = np.broadcast_to(np.asarray(getattr(js, f)), got.shape)
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("fn", ["carry_last", "carry_last_excl"])
@pytest.mark.parametrize("pmax", [1, 5, 1000])
def test_carry_last_match(pmax, fn):
    rng = np.random.default_rng(pmax)
    n, L = 64, 48
    mask = rng.random((n, L)) < 0.2
    payload = rng.integers(0, pmax + 1, (n, L)).astype(np.int32)
    idx = np.broadcast_to(np.arange(L, dtype=np.int32)[None, :], (n, L))
    jh, jv = getattr(jscans, fn)(jnp.asarray(mask), jnp.asarray(payload), pmax,
                                 jnp.asarray(idx))
    ph, pv = getattr(pscans, fn)(torch.from_numpy(mask), torch.from_numpy(payload), pmax,
                                 torch.from_numpy(idx.copy()))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("width,length", [(8, False), (16, True), (48, True)])
def test_funnel_align_matches(width, length):
    rng = np.random.default_rng(width)
    n, L = 200, 48
    mat = rng.integers(-1, 128, (n, L)).astype(np.int32)
    start = rng.integers(-3, L + 3, n).astype(np.int32)
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    want = jscans.funnel_align(jnp.asarray(mat), jnp.asarray(start), width,
                               length=jnp.asarray(lens) if length else None)
    got = pscans.funnel_align(torch.from_numpy(mat), torch.from_numpy(start), width,
                              length=torch.from_numpy(lens) if length else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


EXTRA_PATHS = ["$.coupon.extra.deep[1].z", "$.promo.tags[1]"]


@pytest.mark.parametrize("path", chip_smoke.JSON_PATHS + EXTRA_PATHS)
def test_get_json_object_matches_jax(batch, path):
    """Column 2 buckets to 512 bytes; column 3 (documents of at most 64
    bytes) to 64, the other side of a bucket step, for the first path."""
    jt, spec = batch
    for col in (2, 3) if path == chip_smoke.JSON_PATHS[0] else (2,):
        want = jgjo.get_json_object(jt.columns[col], path)
        got = pgjo.get_json_object(_port_col(spec[col]), path)
        assert_same_table(JTable([want]), Table([got]))


def test_get_json_object_pinned_widths_match_jax(batch):
    jt, spec = batch
    want = jgjo.get_json_object(jt.columns[2], "$.coupon", width=512, out_width=512)
    got = pgjo.get_json_object(_port_col(spec[2]), "$.coupon", width=512, out_width=512)
    assert_same_table(JTable([want]), Table([got]))


# ---- oracle cases of tests/test_get_json_object.py, on the port ----


def test_parse_path():
    assert pgjo.parse_path("$.a.b") == (("key", "a"), ("key", "b"))
    assert pgjo.parse_path("$[3].x") == (("index", 3), ("key", "x"))
    assert pgjo.parse_path("$['k with space'][0]") == (("key", "k with space"), ("index", 0))
    for bad in ("a.b", "$.."):
        with pytest.raises(ValueError):
            pgjo.parse_path(bad)


def _run(rows, path):
    return pgjo.get_json_object(Column.from_pylist(rows, STRING, device="cpu"), path).to_pylist()


ORACLE = [
    (['{"a": 1, "b": "x"}', '{"b": "y"}', None, '{"a": null}'], "$.a", ["1", None, None, "null"]),
    (['{"a": 1, "b": "x"}', '{"b": "y"}', None, '{"a": null}'], "$.b", ["x", "y", None, None]),
    (['{"a": {"b": {"c": 42}}}', '{"a": {"b": 7}}', '{"a": 1}'], "$.a.b.c", ["42", None, None]),
    (['{"a": {"b": {"c": 42}}}', '{"a": {"b": 7}}', '{"a": 1}'], "$.a.b", ['{"c":42}', "7", None]),
    (['{"a": [10, 20, 30]}', '{"a": []}', '{"a": [5]}'], "$.a[0]", ["10", None, "5"]),
    (['{"a": [10, 20, 30]}', '{"a": []}', '{"a": [5]}'], "$.a[2]", ["30", None, None]),
    (['{"a": [{"x": 1}, {"x": 2}]}'], "$.a[1].x", ["2"]),
    (['{"a": [{"x": 1}, {"x": 2}]}'], "$.a[0]", ['{"x":1}']),
    (['{"k with space": "v"}'], "$['k with space']", ["v"]),
    (['{"a": "line1\\nline2", "b": "q\\"end", "c": "back\\\\slash"}'], "$.a", ["line1\nline2"]),
    (['{"a": "line1\\nline2", "b": "q\\"end", "c": "back\\\\slash"}'], "$.b", ['q"end']),
    (['{"a": "line1\\nline2", "b": "q\\"end", "c": "back\\\\slash"}'], "$.c", ["back\\slash"]),
    (['{"a": 1}', "not json at all", "", '{"a": {"deep": 1}}'], "$.zzz", [None] * 4),
    (['{"a": 1}', "not json at all", "", '{"a": {"deep": 1}}'], "$.a",
     ["1", None, None, '{"deep":1}']),
    (['{"k": 1, "k": 2}'], "$.k", ["1"]),
    (['{"a": {"b": 99}, "b": 1}'], "$.b", ["1"]),
    (['{"a": "has , comma and } brace", "b": 2}'], "$.a", ["has , comma and } brace"]),
    (['{"a": "has , comma and } brace", "b": 2}'], "$.b", ["2"]),
    (['{"a": "\\u0041"}', '{"a": "\\u00e9"}', '{"a": "\\u4e2d\\u6587"}', '{"a": "x\\u0031y"}',
      '{"a": "\\ud83d\\ude00"}', '{"a": "pre\\u0041post"}'], "$.a",
     ["A", "é", "中文", "x1y", "\U0001F600", "preApost"]),
    (['{"a": "\\uZZ99"}'], "$.a", ["\\uZZ99"]),
    (['{"a": "tab\\there\\u0021\\n"}'], "$.a", ["tab\there!\n"]),
    (['{"a": { "b" : [ 1 ,  2 , {"c" : "x y"} ] }}', '{"a":{"t":"keep  spaces", "n": 1.5e2 }}'],
     "$.a", ['{"b":[1,2,{"c":"x y"}]}', '{"t":"keep  spaces","n":1.5e2}']),
    (['{"a": {"q": "he \\" said", "r" : 2}}'], "$.a", ['{"q":"he \\" said","r":2}']),
]


@pytest.mark.parametrize("case", range(len(ORACLE)))
def test_oracle_case(case):
    rows, path, want = ORACLE[case]
    assert _run(rows, path) == want


def test_nested_container_escapes_stay_raw():
    rows = ['{"a": {"s": "x\\ny", "q": "he said \\"hi\\""}}']
    assert json.loads(_run(rows, "$.a")[0]) == {"s": "x\ny", "q": 'he said "hi"'}
    assert _run(rows, "$.a.q") == ['he said "hi"']


def test_random_vs_json_oracle():
    rng = random.Random(0)

    def gen_value(depth):
        r = rng.random()
        if depth > 2 or r < 0.4:
            return rng.choice([17, -3.5, True, False, None, "plain", "sp ace", ""])
        if r < 0.7:
            return {f"k{i}": gen_value(depth + 1) for i in range(rng.randint(0, 3))}
        return [gen_value(depth + 1) for _ in range(rng.randint(0, 3))]

    docs = [{f"f{i}": gen_value(0) for i in range(rng.randint(1, 4))} for _ in range(60)]
    rows = [json.dumps(d) for d in docs]
    for path, nav in [
        ("$.f0", lambda d: d.get("f0", KeyError)),
        ("$.f1", lambda d: d.get("f1", KeyError)),
        ("$.f0.k0", lambda d: d.get("f0", {}).get("k0", KeyError)
         if isinstance(d.get("f0"), dict) else KeyError),
        ("$.f0[0]", lambda d: d["f0"][0]
         if isinstance(d.get("f0"), list) and d["f0"] else KeyError),
    ]:
        got = _run(rows, path)
        for i, doc in enumerate(docs):
            want = nav(doc)
            if want is KeyError:
                assert got[i] is None, (path, i, got[i], rows[i])
            elif isinstance(want, str):
                assert got[i] == want, (path, i, got[i], want)
            elif want is None:
                assert got[i] == "null"
            elif isinstance(want, bool):
                assert got[i] == ("true" if want else "false")
            else:
                assert got[i] is not None and json.loads(got[i]) == want, (path, i, got[i])


@pytest.mark.parametrize("L", [48, 256, 257, 512])
def test_lane_scans_match_jax_on_both_sides_of_the_width_switch(L):
    """lane_cummax and lane_count change form at LANE_SCAN_MAX_L; both
    forms equal lax.cummax and cumsum."""
    from jax import lax

    from spark_rapids_jni_tpu_torch.ops import segmented

    rng = np.random.default_rng(L)
    x = rng.integers(-1, L, (40, L)).astype(np.int32)
    flags = rng.integers(-1, 2, (40, L)).astype(np.int8)
    np.testing.assert_array_equal(pscans.lane_cummax(torch.from_numpy(x)).numpy(),
                                  np.asarray(lax.cummax(jnp.asarray(x), axis=1)))
    np.testing.assert_array_equal(segmented.lane_count(torch.from_numpy(flags)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(flags, jnp.int32), axis=1)))
