"""The port's ``regexp_extract`` (``ops/regex.py``, ``api.Regex``)
against Python ``re`` and the JAX package, exactly, on every execution
path: the batched monoid chain (stacked tail feasibility), the monoid
segment-by-segment path (``SPARK_JNI_TPU_SCAN_BATCH=off``), the plain
monoid span for non-decomposable group 0, and the serial all-starts
walks. The cases are tests/test_regex.py's and tests/test_regex_monoid.py's."""

import re

import numpy as np
import pytest

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu.columnar.dtypes import STRING as JSTRING
from spark_rapids_jni_tpu.ops import _strategy as jstrategy
from spark_rapids_jni_tpu.ops import regex as jregex

from spark_rapids_jni_tpu_torch import STRING, Column
from spark_rapids_jni_tpu_torch.api import Regex
from spark_rapids_jni_tpu_torch.ops import _strategy as pstrategy
from spark_rapids_jni_tpu_torch.ops import regex as pregex
from spark_rapids_jni_tpu_torch.regex.compile import RegexUnsupported
from spark_rapids_jni_tpu_torch.runtime import metrics
import torch_parity  # noqa: F401,E402  (one torch thread per test process)

MODES = {  # the JAX package's strategy arms: (strategy, batching)
    "serial": ("serial", True),
    "monoid_batched": ("monoid", True),
    "monoid_per_segment": ("monoid", False),
    "auto": ("auto", True),
}


def set_mode(mode):
    strat, batch = MODES[mode] if mode else (None, None)
    for mod in (pstrategy, jstrategy):
        mod.set_scan_strategy(strat)
        mod.set_scan_batching(batch)


@pytest.fixture(params=sorted(MODES))
def mode(request):
    set_mode(request.param)
    yield request.param
    set_mode(None)


def port_col(values):
    return Column.from_pylist(values, STRING, device="cpu")


def re_extract(pattern, subjects, idx):
    out = []
    for s in subjects:
        m = re.search(pattern, s)
        out.append(m.group(idx) if m else "")
    return out


SUBJECTS = [
    "", "a", "abc", "xxabcz", "aab", "banana", "12345", "a1b2c3", "foo@bar.com", "  spaced  ",
    "aaaabbbb", "x" * 50, "tab\there", "new\nline", "price: $42.50", "id=9981;",
    "id=7;host=h1.example.com", "<tag>body</tag>", "a\n", "abc\n", "\n",
]
# the Java terminator edges ($ before a final \r\n or \r) and nulls:
# held to the JAX package
JAVA_SUBJECTS = SUBJECTS + ["ab\r\n", "x\r", "\r\n", "aab\r", None, "<a><b>\r\n",
                            "id=12;host=h.x.y\n", "a" * 40 + "b\r"]

RE_CASES = [  # (pattern, group indexes), leftmost-longest == leftmost-first here
    (r"\d+", (0,)), (r"[a-z]+", (0,)), (r"^\w+", (0,)), (r"a+", (0,)),
    (r"id=(\d+);", (0, 1)), (r"(\d+)px", (0, 1)), (r"^([a-z]+)@", (1,)), (r"<(\w+)>", (0, 1)),
    (r"id=(\d+);host=([\w.]+)", (0, 1, 2)), (r"a(b+?)", (0, 1)), (r"<(.+?)>", (0, 1)),
    (r"^(a+)b", (0, 1)), (r"([a-z]+)@([a-z]+)", (0, 1, 2)), (r"(a?)(b*)", (0, 1, 2)),
    (r"(\d+)", (0, 1)), (r"x*", (0,)), (r"(a|b)+c", (0,)), (r"(\d+?)", (0, 1)),
    (r"(\w+)://([\w.]+)/(\S*)", (0, 1, 2, 3)), (r"(\d+)-(\d+)", (1, 2)),
    (r"\[(\w+)\] (\w+): (.*)", (1, 2, 3)), (r"([a-z]+)(\d*)", (0, 1, 2)),
    (r"(\w+)=(\w+)", (1, 2)), (r"(a+?)(a*)b", (1, 2)), (r"<(.+?)>(.*)", (1, 2)),
    (r"(\d+?)(\d*)0", (1, 2)),
]
EXTRA_SUBJECTS = ["width: 240px", "px", "x10px y20px", "user@host", "User@host", "@host",
                  "https://spark.apache.org/docs", "ftp://host.example.com/", "2024-07",
                  "x 123-456 y", "7-8-9", "[INFO] worker: started ok", "key=value", "a=b=c",
                  "aaab", "ab", "b ", "<x> rest", "<a><b>", "<>", "12300", "10", "500", "1234",
                  "abbb"]


@pytest.mark.parametrize("pattern,idxs", RE_CASES)
def test_extract_matches_re(mode, pattern, idxs):
    subs = SUBJECTS + EXTRA_SUBJECTS
    col = port_col(subs)
    for idx in idxs:
        got = pregex.regexp_extract(col, pattern, idx).to_pylist()
        assert got == re_extract(pattern, subs, idx), (pattern, idx)


def test_group_index_defaults_to_one():
    col = port_col(["id=42;", "nope", None])
    assert Regex.regexpExtract(col, r"id=(\d+);").to_pylist() == ["42", "", None]


def test_no_match_is_empty_not_null(mode):
    assert pregex.regexp_extract(port_col(["zzz", None]), r"\d+", 0).to_pylist() == ["", None]


def test_leftmost_longest_documented_deviation(mode):
    col = port_col(["ab"])
    assert pregex.regexp_extract(col, r"(a|ab)", 0).to_pylist() == ["ab"]


def test_dollar_before_final_terminators(mode):
    subs = ["a\r\n", "a\r", "a\n", "a\r\nb", "a\n\r", "a", "a\n\n", "ab\n"]
    out = pregex.regexp_extract(port_col(subs), r"a$", 0).to_pylist()
    assert out == ["a", "a", "a", "", "", "a", "", ""]


def test_group_errors():
    col = port_col(["ab"])
    with pytest.raises(RegexUnsupported):
        pregex.regexp_extract(col, r"(a)(b)", 3)  # only 2 groups
    for bad in (10, -1):
        with pytest.raises(RegexUnsupported):
            pregex.regexp_extract(col, r"(a)", bad)
    for pat in (r"(a(b)c)", r"(ab)+x", r"(a)|b"):
        with pytest.raises(RegexUnsupported):
            pregex.regexp_extract(col, pat, 1)


def test_nondecomposable_group0_uses_plain_span(mode):
    """Group 0 of a pattern with a nested or quantified group falls
    back to the plain leftmost-longest span."""
    subs = ["xabcabcx", "abc", "zz", "ab\r\n"]
    got = pregex.regexp_extract(port_col(subs), r"(a(b)c)+", 0).to_pylist()
    assert got == ["abcabc", "abc", "", ""]


def test_wide_rows(mode):
    subs = ["a" * 150 + "id=77;host=q.r" + "b" * 20, "x" * 140, "<" + "y" * 135 + ">"]
    col = port_col(subs)
    for pattern, idx in ((r"id=(\d+);host=([\w.]+)", 2), (r"<(.+?)>", 1), (r"(x+)", 1)):
        assert pregex.regexp_extract(col, pattern, idx).to_pylist() == re_extract(
            pattern, subs, idx)


def test_batched_telemetry_and_fallback():
    prev = metrics.configure("mem")
    try:
        col = port_col(["id=1;x", "nope"])
        b0 = metrics.counter_value("regex.strategy.monoid_batched")
        set_mode("monoid_batched")
        pregex.regexp_extract(col, r"id=(\d+)", 1)
        assert metrics.counter_value("regex.strategy.monoid_batched") == b0 + 1
        m0 = metrics.counter_value("regex.strategy.monoid")
        set_mode("monoid_per_segment")
        pregex.regexp_extract(col, r"id=(\d+)", 1)
        assert metrics.counter_value("regex.strategy.monoid") == m0 + 1
        assert metrics.gauge_value("regex.monoid_states") >= 1
    finally:
        set_mode(None)
        metrics.configure(prev)


def test_tail_stack_shape():
    mono = pregex._extract_monoid(r"id=(\d+);host=([\w.]+)", None)
    assert mono is not None and mono.tails is not None
    assert mono.tails.K == len(mono.segs) - 1
    j = jregex._extract_monoid(r"id=(\d+);host=([\w.]+)", None)
    for name in ("genbg", "comp_flat", "base", "mk", "ebase", "acc_flat"):
        np.testing.assert_array_equal(getattr(mono.tails, name), getattr(j.tails, name))


def test_auto_threshold_and_forced_monoid(monkeypatch):
    monkeypatch.setenv("SPARK_JNI_TPU_MONOID_MAX_STATES", "4")
    pat = r"id=\d+;host=[\w.]+"
    assert pregex._rlike_monoid_tables(pat, 4) is None
    col = port_col(["id=1;host=a.b", "nope"])
    for mode in ("auto", "monoid_batched"):
        set_mode(mode)
        try:
            assert [bool(x) for x in pregex.rlike(col, pat).to_pylist()] == [True, False]
            assert pregex.regexp_extract(col, r"id=(\d+);host=([\w.]+)", 1).to_pylist() == [
                "1", ""]
        finally:
            set_mode(None)


JAX_CASES = [  # one subject column (one char width) keeps the JAX compiles few
    (r"id=(\d+);host=([\w.]+)", 2), (r"(a*)b$", 1), (r"<(.+?)>", 1), (r"ab(c?)x?$", 0),
    (r"(\w+)$", 1),
]


@pytest.mark.parametrize("mode_name", ["serial", "monoid_batched", "monoid_per_segment"])
def test_extract_equals_jax(mode_name):
    """Each path against the JAX package on Java's terminators and
    nulls: data, offsets and validity."""
    jc = JColumn.from_pylist(JAVA_SUBJECTS, JSTRING)
    pc = port_col(JAVA_SUBJECTS)
    set_mode(mode_name)
    try:
        for pattern, idx in JAX_CASES:
            want = jregex.regexp_extract(jc, pattern, idx)
            got = pregex.regexp_extract(pc, pattern, idx)
            np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
            n = int(want.offsets[-1])
            np.testing.assert_array_equal(got.data.numpy()[:n], np.asarray(want.data)[:n])
            np.testing.assert_array_equal(got.validity.numpy(), np.asarray(want.validity))
    finally:
        set_mode(None)


def test_internal_span_paths_agree():
    """The spans of every path on the same char matrix: the serial
    all-starts walk, the monoid spans (plain and $-anchored), and the
    serial/monoid single-start runs and feasibility scans."""
    import torch

    from spark_rapids_jni_tpu_torch.columnar.strings import to_char_matrix
    from spark_rapids_jni_tpu_torch.regex.compile import compile_ast

    chars, lengths = to_char_matrix(port_col(JAVA_SUBJECTS))
    L = chars.shape[1]
    for pattern in (r"a(b+?)", r"(a*)b$", r"<(.+?)>", r"x*", r"c$", r"(\d+)"):
        mono = pregex._extract_monoid(pattern, None)
        want = pregex._match_spans(pattern, chars, lengths)
        got = pregex._spans_monoid(mono, chars, lengths)
        for a, b in zip(got, want):
            assert torch.equal(a, b), pattern
        has, start, _end = want
        whole = pregex._compiled(pattern, "anchored")
        serial = pregex._run_from(whole, whole.on("cpu").cls[pregex._byte_index(chars)],
                                  start, lengths)
        assert torch.equal(serial, pregex._run_from_mono(mono.w, L, chars, start, lengths))
        b_next = serial
        for (node, _g), (_dm, gm) in zip(pregex._split_segments(
                pregex.parse(pattern)[0]), mono.segs):
            ser = pregex._Serial(compile_ast(node, "anchored"))
            a = pregex._feasible_from(ser, ser.on("cpu").cls[pregex._byte_index(chars)],
                                      lengths, b_next)
            b = pregex._feasible_from_monoid(gm, L, chars, lengths, b_next)
            assert torch.equal(a, b), pattern
