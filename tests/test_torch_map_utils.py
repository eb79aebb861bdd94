"""The port's from_json (MapUtils) against the JAX package's (exact): the
cases of tests/test_map_utils.py run on the port under both scan
strategies, the analysis and the traced entry against the JAX
package's, the regex-compile tables, lane_scan, the value carries and
the grammar masks. The JAX side compiles per shape, so its comparisons
run over a few batched columns."""

import functools
import json as pyjson
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu import STRING as JSTRING
from spark_rapids_jni_tpu.columnar.strings import to_char_matrix as jchar_matrix
from spark_rapids_jni_tpu.ops import _json_scans as jscans
from spark_rapids_jni_tpu.ops import map_utils as jmu
from spark_rapids_jni_tpu.ops import segmented as jseg
from spark_rapids_jni_tpu.regex import compile as jrc
from spark_rapids_jni_tpu.runtime.errors import JsonParsingException as JJsonError

from spark_rapids_jni_tpu_torch import STRING, Column
from spark_rapids_jni_tpu_torch.api import MapUtils
from spark_rapids_jni_tpu_torch.columnar.interop import column_from_numpy
from spark_rapids_jni_tpu_torch.columnar.strings import to_char_matrix
from spark_rapids_jni_tpu_torch.ops import _json_scans as pscans
from spark_rapids_jni_tpu_torch.ops import _strategy
from spark_rapids_jni_tpu_torch.ops import map_utils as pmu
from spark_rapids_jni_tpu_torch.ops import segmented as pseg
from spark_rapids_jni_tpu_torch.regex import compile as prc
from spark_rapids_jni_tpu_torch.runtime.errors import JsonParsingException

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
import torch_parity  # noqa: F401,E402  (one torch thread per test process)

STRATEGIES = ["auto", "serial"]


@pytest.fixture(params=STRATEGIES)
def strategy(request):
    _strategy.set_scan_strategy(request.param)
    yield request.param
    _strategy.set_scan_strategy(None)


def from_json(rows):
    return MapUtils.extractRawMapFromJsonString(Column.from_pylist(rows, STRING, device="cpu"))


# ---- the cases of tests/test_map_utils.py, on the port ----

SIMPLE = [
    '{"Zipcode" : 704 , "ZipCodeType" : "STANDARD" , "City" : "PARC'
    ' PARQUE" , "State" : "PR"}',
    "{}",
    None,
    '{"category": "reference", "index": [4,{},null,{"a":[{ }, {}] } '
    '], "author": "Nigel Rees", "title": "{}[], <=semantic-symbols-string", '
    '"price": 8.95}',
]
UTF8 = [
    '{"Zipcóde" : 704 , "ZípCodeTypé" : "STANDARD" , "City" : "PARC PARQUE" , "Stâte" : "PR"}',
    "{}",
    None,
    '{"Zipcóde" : 704 , "ZípCodeTypé" : "\U00029e3d" , "City" : "\U0001f3f3" , '
    '"Stâte" : "\U0001f3f3"}',
]
ESCAPED = ['{"a": "x\\"y", "b{": "}:,{", "c": "\\\\"}']
SCALARS = ['{"t": true, "f": false, "n": null, "neg": -1.5e10, "s": ""}']
NESTED = ['{ "outer" : { "in" : [1, 2], "s": "a,b" } , "z" : 9 }']
EMPTIES = [None, "{}", "  { } ", None]
DUPLICATES = ['{"k": 1, "k": 2}']
MALFORMED = [
    "", "   ", "[1, 2]", '{"a": 1', '{"a": "x}', '{"a" 1}', '{"a": }', '{"a": 1}}',
    '{} {"a": 1}', '{"a": 1}]', '{"a": "x" "y"}', '{"a": 1 2}', '{"a": [1}{2]}',
    '{"a": [1}]}', '{"a" "b": 1}', '{"a": {}x}', '{"a": "x"y}', '{"a": 1"b"}',
    '{"a": 12[3]}', '{"a": x"y"}', '{"a": tru}', '{"a": 1.2.3}', '{"a": 01}', '{"a": 1e}',
    '{"a": .5}', '{"a": nan}',
]
DEEP_BAD = [
    '{"a": {"x" 1}}', '{"a": {"x": 1,}}', '{"a": [1, ]}', '{"a": [1 2]}', '{"a": {"k": }}',
    '{"a": {: 1}}', '{"a": [1, tru]}', '{"a": [01]}', '{"a": [1.]}', '{"a": {"k": 1 "j": 2}}',
    '{"a": ["x": 1]}', '{"a": {"k"}}', '{"a": "bad\\qescape"}', '{"a": "trunc\\u12"}',
    '{"a": [[[{"deep" 1}]]]}',
]
DEEP_GOOD = [
    '{"a": {"x": 1, "y": [2, 3]}}',
    '{"a": [{"k": "v"}, [1, 2], "s", -1.5e-3, true, false, null]}',
    '{"a": {}, "b": []}',
    '{"a": [[], {}, [{}]]}',
    '{"a": "esc \\" \\\\ \\/ \\b \\f \\n \\r \\t \\u0041"}',
    '{"a": {"nested": {"more": {"deep": [0]}}}}',
]


def large_batch():
    rng = random.Random(42)
    rows = []
    for i in range(500):
        if i % 17 == 0:
            rows.append(None)
            continue
        obj = {}
        for _k in range(rng.randrange(0, 6)):
            key = f"key_{rng.randrange(100)}"
            kind = rng.randrange(4)
            if kind == 0:
                obj[key] = rng.randrange(-(10**9), 10**9)
            elif kind == 1:
                obj[key] = "v" * rng.randrange(0, 20)
            elif kind == 2:
                obj[key] = None
            else:
                obj[key] = [1, {"x": "y"}]
        rows.append(pyjson.dumps(obj))
    return rows


def test_simple_input(strategy):
    out = from_json(SIMPLE).to_pylist()
    assert out[0] == [("Zipcode", "704"), ("ZipCodeType", "STANDARD"), ("City", "PARC PARQUE"),
                      ("State", "PR")]
    assert out[1] == [] and out[2] is None
    assert out[3] == [
        ("category", "reference"),
        ("index", '[4,{},null,{"a":[{ }, {}] } ]'),
        ("author", "Nigel Rees"),
        ("title", "{}[], <=semantic-symbols-string"),
        ("price", "8.95"),
    ]


def test_utf8(strategy):
    out = from_json(UTF8).to_pylist()
    assert out[0] == [("Zipcóde", "704"), ("ZípCodeTypé", "STANDARD"), ("City", "PARC PARQUE"),
                      ("Stâte", "PR")]
    assert out[1] == [] and out[2] is None
    assert out[3] == [("Zipcóde", "704"), ("ZípCodeTypé", "\U00029e3d"),
                      ("City", "\U0001f3f3"), ("Stâte", "\U0001f3f3")]


def test_escaped_quotes_and_braces_in_strings(strategy):
    assert from_json(ESCAPED).to_pylist()[0] == [("a", 'x\\"y'), ("b{", "}:,{"), ("c", "\\\\")]


def test_scalar_values_raw(strategy):
    assert from_json(SCALARS).to_pylist()[0] == [
        ("t", "true"), ("f", "false"), ("n", "null"), ("neg", "-1.5e10"), ("s", "")]


def test_nested_object_value_spans_whole(strategy):
    assert from_json(NESTED).to_pylist()[0] == [
        ("outer", '{ "in" : [1, 2], "s": "a,b" }'), ("z", "9")]


def test_all_null_and_empty_objects(strategy):
    assert from_json(EMPTIES).to_pylist() == [None, [], [], None]


@pytest.mark.parametrize("bad", MALFORMED)
def test_malformed_raises(strategy, bad):
    with pytest.raises(JsonParsingException) as ei:
        from_json(["{}", bad])
    assert ei.value.row_with_error == 1


def test_error_reports_first_bad_row(strategy):
    with pytest.raises(JsonParsingException) as ei:
        from_json(['{"k": 1}', "nope", "also bad"])
    assert ei.value.row_with_error == 1
    assert "nope" in str(ei.value)


def test_empty_column(strategy):
    assert from_json([]).to_pylist() == []


def test_duplicate_keys_kept_in_order(strategy):
    assert from_json(DUPLICATES).to_pylist()[0] == [("k", "1"), ("k", "2")]


def test_large_batch_roundtrip_against_python_oracle(strategy):
    rows = large_batch()
    out = from_json(rows).to_pylist()
    for i, r in enumerate(rows):
        if r is None:
            assert out[i] is None
            continue
        exp = [(k, v if isinstance(v, str) else pyjson.dumps(v))
               for k, v in pyjson.loads(r).items()]
        assert out[i] == exp, (i, r, out[i], exp)


@pytest.mark.parametrize("bad", DEEP_BAD)
def test_full_depth_validation_rejects(strategy, bad):
    with pytest.raises(JsonParsingException):
        from_json([bad])


@pytest.mark.parametrize("good", DEEP_GOOD)
def test_full_depth_validation_accepts(strategy, good):
    assert len(from_json([good])) == 1


# ---- the port against the JAX package ----

VALID_ROWS = (SIMPLE + UTF8 + ESCAPED + SCALARS + NESTED + EMPTIES + DUPLICATES + DEEP_GOOD
              + large_batch())


def _list_buffers(col):
    """name -> numpy of a List<Struct<String,String>> (JAX or port)."""
    kv = col.child.children
    out = {"offsets": np.asarray(col.offsets),
           "validity": None if col.validity is None else np.asarray(col.validity)}
    for name, c in zip(("key", "value"), kv):
        out[f"{name} data"] = np.asarray(c.data)
        out[f"{name} offsets"] = np.asarray(c.offsets)
        out[f"{name} validity"] = None if c.validity is None else np.asarray(c.validity)
    return out


def assert_same_lists(jcol, pcol):
    want, got = _list_buffers(jcol), _list_buffers(pcol)
    for k, w in want.items():
        if w is None or got[k] is None:
            assert w is None and got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@functools.lru_cache(maxsize=None)
def jax_from_json(rows):
    return jmu.from_json(JColumn.from_pylist(list(rows), JSTRING))


@pytest.mark.parametrize("rows", ["mirror cases", "chip_smoke batch"])
def test_from_json_matches_jax(strategy, rows):
    if rows == "mirror cases":
        values = VALID_ROWS
    else:
        values = column_from_numpy(chip_smoke.from_json_spec(512, seed=7)[1], "cpu").to_pylist()
    got = from_json(values)
    assert_same_lists(jax_from_json(tuple(values)), got)


def test_row_sliced_analysis_matches_jax(strategy, monkeypatch):
    """Analysed in row slices (as batches past _ANALYZE_POSITIONS char
    positions are), from_json gives the JAX package's result."""
    monkeypatch.setattr(pmu, "_ANALYZE_POSITIONS", 7 * 256)
    got = from_json(VALID_ROWS)
    assert_same_lists(jax_from_json(tuple(VALID_ROWS)), got)


def _bad_batch():
    """Valid and malformed documents of every kind in one column."""
    rows = VALID_ROWS[:40] + MALFORMED + DEEP_BAD
    rng = np.random.default_rng(3)
    return [rows[i] for i in rng.permutation(len(rows))]


@functools.lru_cache(maxsize=None)
def _jax_analysis():
    col = JColumn.from_pylist(_bad_batch(), JSTRING)
    chars, lengths = jchar_matrix(col)
    return chars, jmu._analyze(chars, lengths, col.validity_or_true(), True)


@pytest.mark.parametrize("monoid", [True, False])
def test_analysis_matches_jax(monoid):
    """Every field of the analysis, errors included, over a batch that
    mixes valid and malformed rows: the port under either strategy
    against the JAX package's monoid path (its own tests pin its serial
    path to it)."""
    jchars, want = _jax_analysis()
    col = Column.from_pylist(_bad_batch(), STRING, device="cpu")
    chars, lengths = to_char_matrix(col)
    np.testing.assert_array_equal(chars.numpy(), np.asarray(jchars))
    got = pmu._analyze(chars, lengths, col.validity_or_true(), monoid)
    np.testing.assert_array_equal(got.row_err.numpy(), np.asarray(want.row_err))
    np.testing.assert_array_equal(got.pairs_per_row.numpy(), np.asarray(want.pairs_per_row))
    colon = np.asarray(want.colon)
    np.testing.assert_array_equal(got.colon.numpy(), colon)
    assert np.asarray(want.row_err).sum() == len(MALFORMED) + len(DEEP_BAD)
    for f in ("k_start", "k_len", "v_start", "v_len", "v_kind"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[colon],
                                      np.asarray(getattr(want, f))[colon], err_msg=f)


def test_traced_entry_matches_jax():
    """from_json_traced + assemble_from_json at pinned widths, overflow
    counts and stats included, against the JAX package's."""
    rows = [r for r in VALID_ROWS if r is None or len(r) <= 64][:200]
    jcol = JColumn.from_pylist(rows, JSTRING)
    pcol = Column.from_pylist(rows, STRING, device="cpu")
    jchars, jlens = jchar_matrix(jcol)
    pchars, plens = to_char_matrix(pcol)
    jp, jc, js = jmu.from_json_traced(jchars, jlens, jcol.validity_or_true(), 4, 16, 2, True)
    pp, pc, ps = pmu.from_json_traced(pchars, plens, pcol.validity_or_true(), 4, 16, 2, True)
    for d_want, d_got in ((jc, pc), (js, ps)):
        assert {k: int(v) for k, v in d_got.items()} == {k: int(v) for k, v in d_want.items()}
    assert int(pc["kwidth"]) > 0 and int(pc["maxp"]) > 0  # the overflow counts are live
    for k in ("kchars", "klen", "vchars", "vlen", "list_offsets", "err_row"):
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]), err_msg=k)
    assert_same_lists(jmu.assemble_from_json(jp), pmu.assemble_from_json(pp))
    bad = ['{"a": 1}', '{"a" 1}', None]
    jcol = JColumn.from_pylist(bad, JSTRING)
    pcol = Column.from_pylist(bad, STRING, device="cpu")
    jchars, jlens = jchar_matrix(jcol)
    pchars, plens = to_char_matrix(pcol)
    jp, _, _ = jmu.from_json_traced(jchars, jlens, jcol.validity_or_true(), 8, 8, 1, True)
    pp, _, _ = pmu.from_json_traced(pchars, plens, pcol.validity_or_true(), 8, 8, 1, True)
    with pytest.raises(JJsonError) as want:
        jmu.assemble_from_json(jp)
    with pytest.raises(JsonParsingException) as got:
        pmu.assemble_from_json(pp)
    assert (got.value.row_with_error, got.value.context) == (
        want.value.row_with_error, want.value.context)


# ---- regex-compile tables ----

PATTERNS = [r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?|true|false|null",
            r"a+b?c{2,3}", r"^[a-z]\d\w*$", r"(ab|cd)*x", r"[^,;]+\s?"]


def test_scalar_token_monoid_tables_match():
    p, j = prc.scalar_token_monoid(), jrc.scalar_token_monoid()
    for f in ("n_elems", "class_of", "gen_of_class", "reset_of_class", "compose", "acc_at0"):
        np.testing.assert_array_equal(np.asarray(getattr(p, f)), np.asarray(getattr(j, f)),
                                      err_msg=f)
    tp, tj = pscans._scalar_monoid_tables(), jscans._scalar_monoid_tables()
    for a, b in zip(tp, tj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_compile_tables_match(pattern):
    past, jast = prc.parse(pattern)[0], jrc.parse(pattern)[0]
    pn, jn = prc.compile_nfa(past), jrc.compile_nfa(jast)
    for f in ("first_mask", "last_mask", "nullable", "follow_masks", "class_masks", "class_of",
              "position_intervals"):
        assert getattr(pn, f) == getattr(jn, f), f
    for mode in ("search", "anchored"):
        pd_, jd = prc.compile_regex(pattern, mode), jrc.compile_regex(pattern, mode)
        for f in ("transition", "accepting", "class_of"):
            assert getattr(pd_, f) == getattr(jd, f), f"{mode} {f}"
        pm = prc.compile_monoid(pd_, with_resets=True)
        jm = jrc.compile_monoid(jd, with_resets=True)
        assert (pm is None) == (jm is None)
        if pm is not None:
            for f in ("elems", "compose", "gen_of_class", "reset_of_class", "acc_at0"):
                np.testing.assert_array_equal(getattr(pm, f), getattr(jm, f), err_msg=f)


# ---- lane_scan, carries and grammar masks ----


def _stacked_comp():
    """Two monoids' compose tables concatenated, with their bases."""
    ms = [jrc.scalar_token_monoid(), jrc.compile_monoid(jrc.compile_regex("a+b?", "search"))]
    comp = np.concatenate([np.asarray(m.compose, np.int32).reshape(-1) for m in ms])
    sizes = [int(m.n_elems) for m in ms]
    base = np.array([0, sizes[0] ** 2], np.int32).reshape(2, 1, 1)
    mk = np.array(sizes, np.int32).reshape(2, 1, 1)
    return comp, base, mk, sizes


@pytest.mark.parametrize("L", [48, 257])
def test_lane_scan_matches_associative_scan(L):
    rng = np.random.default_rng(L)
    n = 40
    x = rng.integers(-5, 50, (n, L)).astype(np.int32)
    d = rng.integers(-2, 40, (n, L)).astype(np.int32)
    open_b = rng.random((n, L)) < 0.3
    curly = rng.random((n, L)) < 0.5
    kcomb_p, kw_p = pscans._kind_lane(torch.from_numpy(open_b), torch.from_numpy(curly),
                                      torch.from_numpy(d))
    kcomb_j, kw_j = jscans._kind_lane(jnp.asarray(open_b), jnp.asarray(curly), jnp.asarray(d))
    np.testing.assert_array_equal(kw_p.numpy(), np.asarray(kw_j).view(np.int64))
    comp, base, mk, sizes = _stacked_comp()
    ids = np.stack([rng.integers(0, s, (n, L)) for s in sizes]).astype(np.int32)
    got = pseg.lane_scan([
        (torch.maximum, torch.from_numpy(x), False),
        (torch.minimum, torch.from_numpy(x), True),
        (kcomb_p, kw_p, False),
        (pseg.stacked_monoid_combine(torch.from_numpy(comp), torch.from_numpy(base),
                                     torch.from_numpy(mk)), torch.from_numpy(ids), False),
    ], axis=-1)
    stacked = jseg.stacked_monoid_combine(jnp.asarray(comp), jnp.asarray(base), jnp.asarray(mk))

    @jax.jit
    def jax_side(x, kw, ids):
        return [
            jax.lax.cummax(x, axis=1),
            jax.lax.cummin(x, axis=1, reverse=True),
            jax.lax.associative_scan(kcomb_j, kw, axis=1),
            jax.lax.associative_scan(stacked, ids, axis=2),
            jax.lax.associative_scan(kcomb_j, kw, axis=1, reverse=True),
        ]

    want = jax_side(jnp.asarray(x), kw_j, jnp.asarray(ids))
    got.append(pseg.associative_scan(kcomb_p, kw_p, axis=1, rev=True))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.view(np.int64) if w.dtype == np.uint64 else w)


def _mask_payload(seed, n, L, pmax):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, L)) < 0.2
    payload = rng.integers(0, pmax + 1, (n, L)).astype(np.int32)
    idx = np.broadcast_to(np.arange(L, dtype=np.int32)[None, :], (n, L)).copy()
    return mask, payload, idx


@pytest.mark.parametrize("fn", ["carry_next", "carry_next_excl"])
@pytest.mark.parametrize("L,pmax", [(48, 1), (48, 1000), (300, 257)])
def test_carry_next_matches(fn, L, pmax):
    mask, payload, idx = _mask_payload(L + pmax, 32, L, pmax)
    jh, jv = getattr(jscans, fn)(jnp.asarray(mask), jnp.asarray(payload), pmax, jnp.asarray(idx))
    ph, pv = getattr(pscans, fn)(torch.from_numpy(mask), torch.from_numpy(payload), pmax,
                                 torch.from_numpy(idx))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("fn", ["carry_last_multi", "carry_next_multi"])
@pytest.mark.parametrize("L", [48, 300])
def test_carry_multi_and_views_match(fn, L):
    """The packed multi-carries (spilling past one int32 group), their
    exclusive reads, positions and excl_last / excl_next."""
    mask, _, idx = _mask_payload(L, 32, L, 1)
    rng = np.random.default_rng(L + 1)
    pmaxes = [257, L, 1, 63, L + 1, 1000, 1]
    pays = [rng.integers(0, p + 1, (32, L)).astype(np.int32) for p in pmaxes]
    jspecs = [(jnp.asarray(p), m) for p, m in zip(pays, pmaxes)]
    pspecs = [(torch.from_numpy(p), m) for p, m in zip(pays, pmaxes)]
    want = getattr(jscans, fn)(jnp.asarray(mask), jspecs, jnp.asarray(idx), with_idx=True)
    got = getattr(pscans, fn)(torch.from_numpy(mask), pspecs, torch.from_numpy(idx),
                              with_idx=True)
    excl = pscans.excl_last if fn == "carry_last_multi" else pscans.excl_next
    jexcl = jscans.excl_last if fn == "carry_last_multi" else jscans.excl_next
    for (gh, gv), (wh, wv) in zip(got, want):
        np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        for g, w in zip(excl((gh, gv)), jexcl((wh, wv))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lanes_fn = "carry_last_lanes" if fn == "carry_last_multi" else "carry_next_lanes"
    plan, pdec = getattr(pscans, lanes_fn)(torch.from_numpy(mask), pspecs, torch.from_numpy(idx))
    jlan, jdec = getattr(jscans, lanes_fn)(jnp.asarray(mask), jspecs, jnp.asarray(idx))
    assert len(plan) == len(jlan) >= 2
    pv_, jv_ = pdec(pseg.lane_scan(plan, axis=1)), jdec(jseg.lane_scan(jlan, axis=1))
    for i in range(len(pmaxes)):
        for a, b in zip(pv_.pair(i, excl=True), jv_.pair(i, excl=True)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pv_.pos(excl=True), jv_.pos(excl=True)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@functools.lru_cache(maxsize=None)
def _grammar_chars():
    col = column_from_numpy(chip_smoke.from_json_spec(256, seed=9)[1], "cpu")
    rows = col.to_pylist()[:200] + MALFORMED + DEEP_BAD
    pchars, _ = to_char_matrix(Column.from_pylist(rows, STRING, device="cpu"))
    jchars, _ = jchar_matrix(JColumn.from_pylist(rows, JSTRING))
    np.testing.assert_array_equal(pchars.numpy(), np.asarray(jchars))
    return pchars, jchars


def test_structure_position_scans_match():
    pchars, jchars = _grammar_chars()
    ps, js = pscans.structure(pchars), jscans.structure(jchars)
    for f in ("prev_nonws", "prev_nonws_x", "next_nonws", "prev_quote_x"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)


def _grammar_side(chars, lib, monoid):
    """grammar_masks, the kind-word and token lanes and
    deep_grammar_errors of one package, the carries filled as _analyze
    fills them: name -> array."""
    is_jax = lib == "jax"
    scans = jscans if is_jax else pscans

    def i32(a):
        return a.astype(jnp.int32) if is_jax else a.to(torch.int32)

    st = scans.structure(chars)
    idx = st.idx
    pre, flags, okpred = scans.grammar_masks(chars, st.nonws, st.esc, st.quote, st.outside,
                                             st.open_b, st.close_b, st.d, st.past_end, idx)
    (p_pair,) = scans.carry_last_multi(st.nonws, [(flags, 63)], idx)
    pre.p = scans.excl_last(p_pair)
    pred = scans.carry_last_excl(st.nonws, i32(okpred), 1, idx)
    pre.b = scans.carry_last(pre.open_q, i32((~pred[0]) | (pred[1] != 0)), 1, idx)
    n1 = scans.carry_next_excl(st.nonws, i32(pre.is_colon), 1, idx)
    pre.n2 = scans.carry_next_excl(st.quote, i32(n1[0] & (n1[1] != 0)), 1, idx)
    out = {"flags": flags}
    if monoid:
        pre.kind_words = scans._kind_words_monoid(st.open_b, pre.curly_open, st.d)
        comb, ids = scans._token_lane(chars, pre.scalar_start, pre.scalar_char)
        pre.tok_pref = (jax.lax.associative_scan(comb, ids, axis=1) if is_jax
                        else pseg.associative_scan(comb, ids, axis=1))
        out["tok"] = scans._token_errors_monoid(chars, pre.scalar_start, pre.scalar_char,
                                                pre.scalar_end)
        out["kind"] = pre.kind_words
    for f in ("structural", "open_q", "close_q", "scalar_start", "scalar_char", "scalar_end",
              "is_colon", "is_comma", "curly_open", "curly_close", "d_before"):
        out[f] = getattr(pre, f)
    out["errors"] = scans.deep_grammar_errors(chars, pre, monoid)
    return out


@functools.lru_cache(maxsize=None)
def _jax_grammar():
    return jax.jit(functools.partial(_grammar_side, lib="jax", monoid=True))(_grammar_chars()[1])


@pytest.mark.parametrize("monoid", [True, False])
def test_grammar_masks_and_errors_match(monoid):
    """The port under either strategy against the JAX package's monoid
    path (its own tests pin its serial walk to it; jitting that walk
    here would cost a minute of compile)."""
    want = _jax_grammar()
    got = _grammar_side(_grammar_chars()[0], "torch", monoid)
    for k, w in want.items():
        if k not in got:
            continue
        w = np.asarray(w)
        np.testing.assert_array_equal(got[k].numpy(), w.view(np.int64) if w.dtype == np.uint64
                                      else w, err_msg=k)
    assert got["errors"].sum() >= len(DEEP_BAD) - 3
