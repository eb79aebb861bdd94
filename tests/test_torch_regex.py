"""The port's ``rlike`` (``ops/regex.py``, ``api.Regex``) against Python
``re`` and the JAX package's ``ops/regex.py``, exactly, under each of
the JAX package's strategy knobs: the monoid reduction, the serial
bit-parallel NFA (both B-mask tables, several follow-union chunks) and
the serial DFA walk (rows past the unroll bound too). The fingerprints
must equal the JAX strings."""

import os
import random
import re
import sys

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
from spark_rapids_jni_tpu_torch.regex.compile import RegexUnsupported, compile_regex

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
import torch_parity  # noqa: F401,E402  (one torch thread per test process)

STRATEGIES = ("serial", "monoid", "auto")

SUBJECTS = [
    "", "a", "abc", "xxabcz", "aab", "banana", "12345", "a1b2c3", "foo@bar.com",
    "  spaced  ", "UPPER lower", "colour color", "aaaabbbb", "x" * 50, "tab\there",
    "new\nline", "price: $42.50", "id=9981;", "abc\n", "c\n", "\n", "héllo",
]
PATTERNS = [
    r"abc", r"a+b", r"^a", r"c$", r"^abc$", r"[a-c]+", r"[^a-z ]+", r"\d{2,4}", r"(foo|bar)",
    r"\w+@\w+\.\w+", r"colou?r", r"a.c", r"\s\w", r"x{10,}", r"^$", r"\$\d+", r"(a|b)*abb",
    r"id=\d+;", r"a*?b", r"é", r"^(ab|c)+$", r"x*",
]
# Java-only line terminators (Python's $ knows only \n): held to the JAX package
JAVA_SUBJECTS = SUBJECTS + ["abc\r\n", "abc\r", "c\r", "\r\n", "aab\r\n", "xxabc\n\n", None,
                            "x" * 31 + "y" * 30 + "z" * 10, "ab" * 70 + "c\r"]


@pytest.fixture(params=STRATEGIES)
def strategy(request):
    pstrategy.set_scan_strategy(request.param)
    jstrategy.set_scan_strategy(request.param)
    yield request.param
    pstrategy.set_scan_strategy(None)
    jstrategy.set_scan_strategy(None)


def port_col(values):
    return Column.from_pylist(values, STRING, device="cpu")


def bools(col):
    return [None if x is None else bool(x) for x in col.to_pylist()]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_rlike_matches_re(strategy, pattern):
    got = bools(pregex.rlike(port_col(SUBJECTS), pattern))
    assert got == [bool(re.search(pattern, s)) for s in SUBJECTS], pattern


def test_rlike_dfa_walk_matches_re():
    col = port_col(SUBJECTS)
    for pattern in PATTERNS:
        got = bools(pregex._rlike_dfa(col, pattern))
        assert got == [bool(re.search(pattern, s)) for s in SUBJECTS], pattern


def test_rlike_wide_rows_past_unroll_bound(strategy):
    """Rows past the JAX package's unroll bound (its lax.scan form) walk
    the same eager loop."""
    subs = ["a" * 200 + "bc", "x" * 300, "ab" * 90 + "abb", "c" * 150 + "\n"]
    col = port_col(subs)
    assert pregex._bucketed_width(col, None) > jregex._UNROLL_MAX
    for pattern in (r"a+bc", r"(a|b)*abb", r"c$", r"x{10,}"):
        got = bools(pregex.rlike(col, pattern))
        assert got == [bool(re.search(pattern, s)) for s in subs], pattern
        assert bools(pregex._rlike_dfa(col, pattern)) == got


def test_rlike_null_propagates(strategy):
    assert bools(Regex.rlike(port_col(["abc", None, "xbc"]), "^a")) == [True, None, False]


def test_rlike_empty_column(strategy):
    out = pregex.rlike(port_col([]), "a+")
    assert out.data.shape == (0,) and out.to_pylist() == []


def test_regexp_like_alias():
    col = port_col(SUBJECTS)
    assert bools(pregex.regexp_like(col, r"a.c")) == bools(pregex.rlike(col, r"a.c"))


def test_rlike_fuzz_vs_re(strategy):
    rnd = random.Random(7)
    checked = 0
    for _ in range(300):
        pat = "".join(rnd.choice("abc.|*+?()") for _ in range(rnd.randint(1, 8)))
        try:
            re.compile(pat)
            compile_regex(pat)
        except (re.error, RegexUnsupported):
            continue
        subs = ["".join(rnd.choice("abcd") for _ in range(rnd.randint(0, 6))) for _ in range(8)]
        got = bools(pregex.rlike(port_col(subs), pat))
        assert got == [bool(re.search(pat, s)) for s in subs], (pat, subs)
        checked += 1
    assert checked > 40


def test_nfa_class_mask_table_and_follow_chunks():
    """Both B-mask tables of the JAX package's rule (intervals up to the
    budget, class masks beyond) and more than one 16-bit follow chunk."""
    many = r"[acegikmoqsuwy]{8}"  # 13 intervals x 8 positions > the budget
    wide = r"a{20}b?[bc]{20}"  # 41 positions: three follow chunks
    assert pregex._compiled_nfa(many)[0].nfa.n_intervals > pregex._INTERVAL_BUDGET
    assert pregex._compiled_nfa(wide)[0].nfa.n_positions > 2 * pregex._FOLLOW_CHUNK
    assert pregex._compiled_nfa(r"x{30}y{30}z{10}") is None  # past 63: the DFA walk
    subs = ["acegikmo", "acegikm", "xxacegikmoqq", "a" * 20 + "c" * 20, "a" * 20 + "b" * 21,
            "a" * 19 + "b" * 20, ""]
    col = port_col(subs)
    for pat in (many, wide):
        tables = pregex._compiled_nfa(pat)[0]
        via_classes = np.asarray(tables.nfa.class_masks, np.int64)[np.asarray(tables.nfa.class_of)]
        np.testing.assert_array_equal(pregex._bmasks_intervals(tables.nfa.position_intervals),
                                      via_classes)
        got = bools(pregex._rlike_nfa(col, pregex._compiled_nfa(pat)))
        assert got == [bool(re.search(pat, s)) for s in subs], pat


def test_unsupported_syntax_raises():
    col = port_col(["x"])
    for pat in [r"a*+", r"(?i)x", r"(?:x)", r"\1", r"a(?=b)", r"^a|b", r"a|b$", "[é]"]:
        with pytest.raises(RegexUnsupported):
            pregex.rlike(col, pat)


def test_non_ascii_literal_matches_utf8():
    assert bools(pregex.rlike(port_col(["héllo", "hello", None, "é"]), "é")) == [
        True, False, None, True]


def test_dollar_before_final_terminators(strategy):
    subs = ["a\r\n", "a\r", "a\n", "a\r\nb", "a\n\r", "a", "a\n\n", "ab\n"]
    got = bools(pregex.rlike(port_col(subs), r"a$"))
    # Java semantics: $ matches before one FINAL terminator (\r\n, \r, \n)
    assert got == [True, True, True, False, False, True, False, False]


JAX_PATTERNS = [r"c$", r"^abc$", r"b?c$", r"[ab]+c", r"id=\d+;", r"^(ab|c)+$", r"(a|b)*abb",
                r"x{30}y{30}z{10}", r"a{24}[bc]{24}"]


def test_rlike_equals_jax(strategy):
    """Every path against the JAX package on the same subjects, Java's
    line terminators, nulls and a wide row included."""
    jc = JColumn.from_pylist(JAVA_SUBJECTS, JSTRING)
    pc = port_col(JAVA_SUBJECTS)
    for pattern in JAX_PATTERNS:
        want = np.asarray(jregex.rlike(jc, pattern).data)
        got = pregex.rlike(pc, pattern)
        np.testing.assert_array_equal(got.data.numpy(), want, err_msg=pattern)
        np.testing.assert_array_equal(got.validity.numpy(), np.asarray(jc.validity))


def test_rlike_pinned_width_equals_jax():
    jc = JColumn.from_pylist(JAVA_SUBJECTS, JSTRING)
    pc = port_col(JAVA_SUBJECTS)
    for pattern in (r"c$", r"x{10,}"):
        for strat in ("serial", "monoid"):
            pstrategy.set_scan_strategy(strat)
            jstrategy.set_scan_strategy(strat)
            try:
                want = np.asarray(jregex.rlike(jc, pattern, width=16).data)
                got = pregex.rlike(pc, pattern, width=16).data.numpy()
            finally:
                pstrategy.set_scan_strategy(None)
                jstrategy.set_scan_strategy(None)
            np.testing.assert_array_equal(got, want, err_msg=f"{pattern} {strat}")


FINGERPRINT_PATTERNS = PATTERNS + JAX_PATTERNS + [r"[0-9]+", r"\d+", r"(\w+)@(\w+)\.com",
                                                  r"<(.+?)>", r"(a(b)c)"]


def test_fingerprints_equal_jax():
    for pattern in FINGERPRINT_PATTERNS:
        for mode in ("rlike", "anchored"):
            assert pregex.pattern_fingerprint(pattern, mode) == jregex.pattern_fingerprint(
                pattern, mode), (pattern, mode)
        assert pregex.extraction_fingerprint(pattern) == jregex.extraction_fingerprint(pattern)
    assert pregex.pattern_fingerprint(r"[0-9]+") == pregex.pattern_fingerprint(r"\d+")


def test_chip_smoke_fingerprints_are_the_jax_strings():
    for pattern, (pfp, efp) in chip_smoke.REGEX_FINGERPRINTS.items():
        assert (jregex.pattern_fingerprint(pattern), jregex.extraction_fingerprint(pattern)) == (
            pfp, efp)


def test_chip_smoke_subjects_are_the_benchmarks():
    """The card's numpy-built subjects are benchmarks/regex_scan.py's
    ``_subjects`` byte for byte."""
    from benchmarks.regex_scan import _subjects

    for kind in ("narrow", "wide"):
        spec = chip_smoke.regex_subjects(3001, kind)
        want = _subjects(3001, kind)
        assert chip_smoke.regex_subjects_python(3001, kind) == want
        assert spec["data"].tobytes() == "".join(want).encode()
        lens = np.diff(spec["offsets"])
        assert lens.tolist() == [len(s) for s in want]
    assert list(chip_smoke.REGEX_PATTERNS) == ["tiny", "small", "medium", "large"]


def test_chip_smoke_mixed_pass_agrees_across_strategies():
    """The card-vs-CPU pass of phase 18 at a small size on the CPU:
    every strategy gives the serial results, and the rlike results are
    Python re's on rows without Java-only terminators."""
    from spark_rapids_jni_tpu_torch.columnar.interop import column_from_numpy

    short_spec = chip_smoke.regex_mixed_spec(512, seed=18)
    long_spec = chip_smoke.regex_mixed_spec(64, seed=19, long_rows=True)
    short = column_from_numpy(short_spec, "cpu")
    out = chip_smoke.regex_mixed_results(short, column_from_numpy(long_spec, "cpu"))
    for key, val in out.items():
        assert val == out[("serial", True) + key[2:]], key
    rows = short.to_pylist()
    for op, pat, _g in chip_smoke.REGEX_MIXED_CASES:
        if op != "rlike":
            continue
        got = out[("serial", True, op, pat, None)]
        for s, g in zip(rows, got):
            if s is not None and "\r" not in s:
                assert bool(g) == bool(re.search(pat, s)), (pat, s)
