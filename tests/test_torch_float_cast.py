"""The port's string -> float cast against the JAX package's (exact),
the float cases of tests/test_cast_string.py run on the port, digit
strings above 2^63, and chip_smoke's string->float axis generator and
oracle.

One stated exception to exactness: on the CPU, XLA flushes subnormal
results to zero, so the JAX package gives +-0.0 where the true value
lies below the output type's minimum normal (2.2250738585072014e-308 for
FLOAT64, 1.1754944e-38 for FLOAT32). The port keeps IEEE subnormals, as
the reference's CUDA doubles do (ROADMAP Queue 3). On those rows the
port is held to the JAX package's own two-table formula
(``cast_string.py`` value assembly) evaluated in numpy float64, and its
validity and ANSI flags to the JAX package's."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu import STRING as JSTRING
from spark_rapids_jni_tpu.columnar.dtypes import DType as JDType
from spark_rapids_jni_tpu.ops import cast_string as jcast
from spark_rapids_jni_tpu.runtime.errors import CastException as JCastException

from spark_rapids_jni_tpu_torch import FLOAT32, FLOAT64, STRING, Column
from spark_rapids_jni_tpu_torch.api import CastStrings
from spark_rapids_jni_tpu_torch.columnar.interop import column_from_numpy
from spark_rapids_jni_tpu_torch.ops import cast_string as pcast
from spark_rapids_jni_tpu_torch.runtime.errors import CastException

from torch_parity import jax_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

MIN_NORMAL = {64: 2.2250738585072014e-308, 32: float(np.finfo(np.float32).tiny)}


def cast_f(vals, dtype=FLOAT64, ansi=False):
    col = Column.from_pylist(vals, STRING, device="cpu")
    return pcast.string_to_float(col, dtype, ansi_mode=ansi).to_pylist()


def two_table(s):
    """The JAX package's subnormal value assembly (cast_string.py:
    692-710) for one plain decimal string, evaluated in numpy float64
    (which keeps subnormals): digits / 10^(nd10-1+shift) *
    10^(nd10-308), the digits and exponent as the parser keeps them."""
    s = s.strip().lower()
    neg = s.startswith("-")
    s = s.lstrip("+-")
    mant, _, exp = s.partition("e")
    whole, _, frac = mant.partition(".")
    digits = (whole + frac).lstrip("0") or "0"
    exp_ten = int(exp or 0) - len(frac) + max(len(digits) - 19, 0)
    d = int(digits[:19])
    nd10 = len(str(d))
    shift = -307 - exp_ten
    assert shift > 0 and d
    if shift > 36:
        val = 0.0
    else:
        val = float((np.float64(d) / np.float64(float(10 ** (nd10 - 1 + shift))))
                    * np.float64(pcast._POW10_SUBNEG[nd10 - 1]))
    return -val if neg else val


def true_value(s):
    """The correctly rounded double of a decimal string (an f/d suffix
    dropped)."""
    return float(s.strip().rstrip("fFdD"))


# ---- the float cases of tests/test_cast_string.py, on the port ----


def test_float_basic():
    out = cast_f(["0", "1.5", "-2.25", "+3", "1e3", "1.5e-2", "007.5"])
    assert out == [0.0, 1.5, -2.25, 3.0, 1000.0, 0.015, 7.5]


def test_float_exact_vs_python():
    cases = ["3.141592653589793", "2.718281828459045", "1e308", "2.3e-308",
             "123456789.123456789", "0.1", "9007199254740993"]
    for s, v in zip(cases, cast_f(cases)):
        assert v == float(s), (s, v, float(s))


def test_float_nan_inf():
    out = cast_f(["nan", "NaN", "inf", "-inf", "Infinity", "-INFINITY", "+inf"])
    assert math.isnan(out[0]) and math.isnan(out[1])
    assert out[2:] == [math.inf, -math.inf, math.inf, -math.inf, math.inf]


def test_float_nan_must_be_whole_string():
    assert cast_f([" nan", "nanx", "-nan"]) == [None, None, None]


def test_float_inf_no_trailing():
    assert cast_f(["infx", "infinity2", "inf ", "infini"]) == [None] * 4


def test_float_suffix_and_whitespace():
    assert cast_f(["1.5f", "1.5F", "2.5d", "2.5D", "  1.5  ", "1.5f  "]) == [
        1.5, 1.5, 2.5, 2.5, 1.5, 1.5]
    # quirk: f/d suffix NOT allowed when the parsed digits are all zero
    assert cast_f(["0f", "0.0d"]) == [None, None]
    out = cast_f(["0", "-0.0", "0e5"])
    assert out == [0.0, -0.0, 0.0] and math.copysign(1, out[1]) == -1


def test_float_invalid():
    assert cast_f(["", "abc", "1.2.3", "1e", "1e+", "--1", "1 2", None]) == [None] * 8


def test_float_exponent_cap():
    # manual exponents are read up to 4 digits; a 5th becomes trailing junk
    assert cast_f(["1e12345"]) == [None]
    # 1e-309 is a subnormal: the reference's value, not the JAX CPU's 0.0
    assert cast_f(["1e309", "1e-309", "-1e400"]) == [math.inf, two_table("1e-309"), -math.inf]


def test_float_many_digits():
    s = "1234567890123456789012345"  # 25 digits: kept 19(+1), rest -> exp
    [v] = cast_f([s])
    assert v == pytest.approx(float(s), rel=1e-15)


def test_float_subnormal():
    # sub-min-normal magnitudes are IEEE subnormals (the JAX CPU gives
    # 0.0 here); the min normal double itself is exact
    out = cast_f(["4.9e-324", "1e-320", "2.2250738585072014e-308"])
    assert out[0] == two_table("4.9e-324") == 5e-324
    assert out[1] == two_table("1e-320") and 0 < out[1] < MIN_NORMAL[64]
    assert out[2] == 2.2250738585072014e-308


def test_float32_narrowing():
    out = cast_f(["1.1", "3.4028235e38", "3.5e38"], FLOAT32)
    assert out[0] == float(np.float32(1.1))
    assert out[1] == float(np.float32(3.4028235e38))
    assert out[2] == math.inf  # overflows float32 -> inf on narrowing


def test_float_ansi_throws():
    with pytest.raises(CastException) as e:
        cast_f(["1.5", "junk"], ansi=True)
    assert e.value.row_with_error == 1
    # quirk: inf-with-garbage is null but NOT an ANSI error
    assert cast_f(["infx"], ansi=True) == [None]


def test_float_19_digit_mantissa_exact():
    s = "6249979066121302517"
    assert cast_f([s]) == [float(s)]


# ---- digit strings above 2^63: unsigned digits, rounded conversion ----

BIG_DIGITS = [
    "9223372036854775807", "9223372036854775808", "9223372036854776832",
    "9223372036854776833", "9223372036854777856", "9999999999999999999",
    "12345678901234567890", "18446744073709551615", "18446744073709551616",
    "99999999999999999999", "18446744073709551609e-3", "-9223372036854776833.0",
]


def test_digits_above_2_63_correctly_rounded():
    """19 and 20 significant digits above 9.22e18 come out as the
    correctly rounded doubles (2^63 + 1024 is a tie that rounds to even;
    2^63 + 1025 rounds up only through the sticky bit)."""
    for s, v in zip(BIG_DIGITS, cast_f(BIG_DIGITS)):
        assert v == float(s), (s, v, float(s))


def test_u64_to_f64_matches_numpy():
    rng = np.random.default_rng(5)
    u = np.concatenate([
        rng.integers(0, 2**63, 2000, dtype=np.uint64) | np.uint64(2**63),
        rng.integers(0, 2**63, 2000, dtype=np.uint64),
        np.array([2**63, 2**64 - 1, 2**63 + 1024, 2**63 + 1025, 0, 1], np.uint64),
    ])
    got = pcast._u64_to_f64(torch.from_numpy(u.view(np.int64))).numpy()
    np.testing.assert_array_equal(got, u.astype(np.float64))


# ---- the port against the JAX package ----

SUBNORMALS = ["4.9e-324", "-4.9e-324", "1e-320", "2.2250738585072011e-308", "1e-309",
              "-1e-310", "123456789e-320", "1e-40", "1.4e-45", "-3e-39", "1.17549435e-38"]
CASES = sorted(set(chip_smoke.FLOAT_CASES + BIG_DIGITS + SUBNORMALS + [
    "0", "1.5", "-2.25", "+3", "1e3", "1.5e-2", "007.5", "3.141592653589793", "1e308",
    "2.3e-308", "123456789.123456789", "0.1", "9007199254740993", "1.1", "junk",
])) + [None]


def assert_float_parity(jcol, pcol, bits, plain):
    """Port vs JAX, row by row: data bits (NaN as NaN, the sign of zero),
    validity. Rows where JAX flushed a subnormal result to +-0.0 are held
    instead to the JAX package's float64 value narrowed in numpy, or,
    where that value is itself a flushed subnormal, to ``two_table``
    (``plain``: the row strings). Returns the count of those rows."""
    pdt = FLOAT32 if bits == 32 else FLOAT64
    want = jcast.string_to_float(jcol, JDType("float", bits))
    want64 = np.asarray(jcast.string_to_float(jcol, JDType("float", 64)).data)
    got = pcast.string_to_float(pcol, pdt)
    wv = np.asarray(want.validity_or_true())
    np.testing.assert_array_equal(got.validity_or_true().numpy(), wv)
    w, g = np.asarray(want.data), got.data.numpy()
    flushed = wv & (w == 0) & (g != 0)
    same = (w == g) | (np.isnan(w) & np.isnan(g))
    same &= (np.signbit(w) == np.signbit(g)) | np.isnan(w)
    bad = ~same & ~flushed & wv
    assert not bad.any(), [(plain[i], w[i], g[i]) for i in np.flatnonzero(bad)]
    for i in np.flatnonzero(flushed):
        assert 0 < abs(true_value(plain[i])) < MIN_NORMAL[bits], plain[i]
        v64 = want64[i] if want64[i] != 0 else two_table(plain[i])
        want_v = np.float64(v64).astype(g.dtype)
        assert g[i] == want_v and want_v != 0, (plain[i], g[i], want_v)
    return int(flushed.sum())


@pytest.mark.parametrize("bits", [32, 64])
def test_cases_match_jax(bits):
    jcol = JColumn.from_pylist(CASES, JSTRING)
    pcol = Column.from_pylist(CASES, STRING, device="cpu")
    flushed = assert_float_parity(jcol, pcol, bits, CASES)
    # the subnormal rows really are the exception, and only they
    assert flushed >= (5 if bits == 64 else 3)


@pytest.mark.parametrize("bits", [32, 64])
def test_chip_smoke_batch_matches_jax(bits):
    spec = chip_smoke.float_spec(512, seed=31)
    plain = column_from_numpy(spec, "cpu")
    assert_float_parity(jax_table([spec]).columns[0], plain, bits, plain.to_pylist())


def test_ansi_error_matches_jax():
    spec = chip_smoke.float_spec(512, seed=31)
    with pytest.raises(JCastException) as want:
        jcast.string_to_float(jax_table([spec]).columns[0], JDType("float", 64), ansi_mode=True)
    with pytest.raises(CastException) as got:
        CastStrings.toFloat(column_from_numpy(spec, "cpu"), True, FLOAT64)
    assert (got.value.row_with_error, got.value.string_with_error) == (
        want.value.row_with_error, want.value.string_with_error)


F64_SUBNORMALS = SUBNORMALS[:7]


def test_subnormal_validity_and_ansi_flags_match_jax():
    """The subnormal rows differ in value only: validity and the ANSI
    error flags are the JAX package's."""
    rows = F64_SUBNORMALS + ["x"]
    jchars, jlens = jcast.to_char_matrix(JColumn.from_pylist(rows, JSTRING))
    pchars, plens = pcast.to_char_matrix(Column.from_pylist(rows, STRING, device="cpu"))
    jv, jval, jexc = jcast._parse_float(jchars, jlens, np.ones(len(rows), bool))
    pv, pval, pexc = pcast._parse_float(pchars, plens, torch.ones(len(rows), dtype=torch.bool))
    np.testing.assert_array_equal(pval.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(pexc.numpy(), np.asarray(jexc))
    assert (np.asarray(jv)[:-1] == 0).all()
    assert [float(v) for v in pv.numpy()[:-1]] == [two_table(s) for s in F64_SUBNORMALS]


# ---- chip_smoke's string->float axis ----


def test_float_axis_generator_and_oracle():
    """The phase-14 generator gives benchmarks/suites.py's strings for
    the same draws, and the port's cast equals the oracle on every one
    of 64 Ki rows."""
    n = 1 << 16
    spec, oracle = chip_smoke.float_axis_strings(n, seed=21)
    col = column_from_numpy(spec, "cpu")
    rng = np.random.default_rng(21)
    whole, frac = rng.integers(-1_000_000, 1_000_000, n), rng.integers(0, 10_000, n)
    want = np.char.add(np.char.add(whole.astype("U8"), "."),
                       np.char.zfill(frac.astype("U4"), 4)).tolist()
    assert col.to_pylist() == want
    got = CastStrings.toFloat(col, False, FLOAT32)
    assert got.validity is None
    np.testing.assert_array_equal(got.data.numpy().view(np.int32), oracle.view(np.int32))
    np.testing.assert_array_equal(oracle, np.array(want, np.float64).astype(np.float32))
