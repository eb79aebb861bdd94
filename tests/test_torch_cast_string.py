"""The port's string -> integer / decimal casts against the JAX
package's (exact), over chip_smoke's phase-11 batch, plus the oracle
cases of tests/test_cast_string.py run on the port."""

import os
import sys

import pytest

from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.columnar.dtypes import DType as JDType
from spark_rapids_jni_tpu.ops import cast_string as jcast
from spark_rapids_jni_tpu.runtime.errors import CastException as JCastException

from spark_rapids_jni_tpu_torch import INT8, INT16, INT32, INT64, STRING, Column, Table
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType
from spark_rapids_jni_tpu_torch.columnar.interop import column_from_numpy
from spark_rapids_jni_tpu_torch.ops import cast_string as pcast
from spark_rapids_jni_tpu_torch.runtime.errors import CapacityExceededError, CastException

from torch_parity import assert_same_table, jax_table

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

N = 512


@pytest.fixture(scope="module")
def batch():
    spec = chip_smoke.cast_json_spec(N, seed=41)
    return jax_table(spec), [column_from_numpy(s, device="cpu") for s in spec]


INT_CASES = [(bits, strip) for bits in (8, 16, 32, 64) for strip in (True, False)]


@pytest.mark.parametrize("bits,strip", INT_CASES)
def test_string_to_integer_matches_jax(batch, bits, strip):
    jt, pc = batch
    want = jcast.string_to_integer(jt.columns[0], JDType("int", bits), strip=strip)
    got = pcast.string_to_integer(pc[0], DType("int", bits), strip=strip)
    assert_same_table(JTable([want]), Table([got]))


DEC_CASES = [(p, s, strip) for p, s in chip_smoke.CAST_DECIMALS + ((6, -2), (38, 0))
             for strip in (True, False)]


@pytest.mark.parametrize("precision,scale,strip", DEC_CASES)
def test_string_to_decimal_matches_jax(batch, precision, scale, strip):
    jt, pc = batch
    want = jcast.string_to_decimal(jt.columns[1], precision, scale, strip=strip)
    got = pcast.string_to_decimal(pc[1], precision, scale, strip=strip)
    assert_same_table(JTable([want]), Table([got]))


def test_pinned_width_matches_jax(batch):
    jt, pc = batch
    want = jcast.string_to_decimal(jt.columns[1], 38, 10, width=64)
    got = pcast.string_to_decimal(pc[1], 38, 10, width=64)
    assert_same_table(JTable([want]), Table([got]))
    with pytest.raises(CapacityExceededError) as e:
        pcast.string_to_integer(pc[0], INT32, width=4)
    assert e.value.stage == "string_width" and e.value.granted == 4


@pytest.mark.parametrize("kind", ["integer", "decimal"])
def test_ansi_error_matches_jax(batch, kind):
    jt, pc = batch
    if kind == "integer":
        jcall = lambda: jcast.string_to_integer(jt.columns[0], JDType("int", 32), ansi_mode=True)
        pcall = lambda: pcast.string_to_integer(pc[0], INT32, ansi_mode=True)
    else:
        jcall = lambda: jcast.string_to_decimal(jt.columns[1], 9, 2, ansi_mode=True)
        pcall = lambda: pcast.string_to_decimal(pc[1], 9, 2, ansi_mode=True)
    with pytest.raises(JCastException) as want:
        jcall()
    with pytest.raises(CastException) as got:
        pcall()
    assert (got.value.row_with_error, got.value.string_with_error) == (
        want.value.row_with_error, want.value.string_with_error)


# ---- oracle cases of tests/test_cast_string.py, on the port ----


def _ints(vals, dtype=INT32, ansi=False, strip=True):
    col = Column.from_pylist(vals, STRING, device="cpu")
    return pcast.string_to_integer(col, dtype, ansi_mode=ansi, strip=strip).to_pylist()


def _dec(vals, precision, scale, ansi=False, strip=True):
    col = Column.from_pylist(vals, STRING, device="cpu")
    return pcast.string_to_decimal(col, precision, scale, ansi_mode=ansi,
                                   strip=strip).to_pylist()


INT_ORACLE = [
    (["0", "42", "-1", "+17", "007"], {}, [0, 42, -1, 17, 7]),
    (["abc", "", "12a", "a12", "1-2", "--1", "++2", "+"], {}, [None] * 8),
    ([" 12", "12 ", "\t 12 \r\n", " +3 ", " - 3"], {}, [12, 12, 12, 3, None]),
    ([" 12", "12 ", "12"], {"strip": False}, [None, None, 12]),
    (["123.456", "123.", ".", "1.2.3", "12.x", "-1.9"], {}, [123, 123, 0, None, None, -1]),
    (["2147483647", "-2147483648", "2147483648", "-2147483649"], {"dtype": INT32},
     [2147483647, -2147483648, None, None]),
    (["127", "-128", "128", "-129"], {"dtype": INT8}, [127, -128, None, None]),
    (["9223372036854775807", "-9223372036854775808", "9223372036854775808"],
     {"dtype": INT64}, [9223372036854775807, -9223372036854775808, None]),
    (["0000000000000000000000000001", "00000"], {"dtype": INT8}, [1, 0]),
    ([None, "5", None], {}, [None, 5, None]),
    (["5", None, "6"], {"ansi": True}, [5, None, 6]),
    (["32767", "-32768", "32768"], {"dtype": INT16}, [32767, -32768, None]),
]


@pytest.mark.parametrize("case", range(len(INT_ORACLE)))
def test_integer_oracle(case):
    vals, kw, want = INT_ORACLE[case]
    assert _ints(vals, **kw) == want


@pytest.mark.parametrize("vals,row,text", [
    (["123.456"], 0, "123.456"),
    (["5", None, "bad", "6"], 2, "bad"),
])
def test_integer_ansi_oracle(vals, row, text):
    with pytest.raises(CastException) as e:
        _ints(vals, ansi=True)
    assert (e.value.row_with_error, e.value.string_with_error) == (row, text)


DEC_ORACLE = [
    (["1", "-1", "0", "12.34", "-12.34"], 6, 2, [100, -100, 0, 1234, -1234]),
    (["0.12", "0.15", "0.19", "-0.15"], 5, 1, [1, 2, 2, -2]),
    (["99.99"], 4, 1, [1000]),
    (["0.6", "0.4"], 5, 0, [1, 0]),
    (["12345.67"], 4, 2, [None]),
    (["9999.99", "10000.00"], 6, 2, [999999, None]),
    (["1.23e2", "1.23E+2", "12300e-2", "1e3"], 8, 1, [1230, 1230, 1230, 10000]),
    (["1e-3"], 8, 4, [10]),
    (["123456"], 6, -2, [1235]),
    (["123e3"], 6, -2, [1230]),
    (["0.012"], 6, 5, [1200]),
    (["12e5"], 10, 2, [120000000]),
    (["", "abc", "1..2", "1.2.3", "++1", "1e1e1", "1 2", None], 8, 2, [None] * 8),
    ([" 1.5 ", "\t2.5\n"], 6, 2, [150, 250]),
    (["1e", "1e+", "1e "], 6, 2, [100, 100, 100]),
    (["1e2 ", "1e+ 2"], 6, 2, [None, None]),
    (["."], 6, 2, [0]),
    (["9" * 38], 38, 0, [int("9" * 38)]),
    (["-" + "9" * 38], 38, 0, [-int("9" * 38)]),
    (["1" + "0" * 37 + ".5"], 38, 0, [10**37 + 1]),
    (["1" + "0" * 37 + ".4"], 38, 0, [10**37]),
    (["0000001.5", "000000"], 8, 1, [15, 0]),
    (["1.23456", "9.99999", "-1.23456", "-9.99999"], 5, 4, [12346, None, -12346, None]),
    (["123456", "999999", "-123456", "-999999"], 5, 0, [None] * 4),
    (["1.234", "0.12345", "-1.034", "-0.001234567890123456"], 6, 5,
     [123400, 12345, -103400, -123]),
    (["1.234e-1", "0.12345e1", "-1.034e-2", "-0.001234567890123456e2"], 6, 5,
     [12340, 123450, -1034, -12346]),
    (["1234e-1", "12345e1", "-1234.5678", "-0.001234567890123456e6"], 6, -2,
     [1, 1235, -12, -12]),
    (["813847339", "043469773", "null"], 8, -3, [813847, 43470, None]),
    (["123456789012345678901234567890123456.01"], 38, 2,
     [12345678901234567890123456789012345601]),
    (["8.483315330475049E-4"], 15, 1, [0]),
    (["8.483315330475049E-2"], 15, 1, [1]),
    (["-1.0E14"], 15, 1, [None]),
    (["-1.0E14"], 16, 1, [-1000000000000000]),
    (["8.575859E8"], 15, 1, [8575859000]),
    (["10.0"], 3, 1, [100]),
    (["1e3000000000"], 6, 2, [None]),
    (["1e-3000000000"], 6, 2, [None]),
    (["1e-3000000000"], 15, 2, [0]),
]


@pytest.mark.parametrize("case", range(len(DEC_ORACLE)))
def test_decimal_oracle(case):
    vals, p, s, want = DEC_ORACLE[case]
    assert _dec(vals, p, s) == want


def test_decimal_no_strip_and_ansi_oracle():
    assert _dec([" 1.5"], 6, 2, strip=False) == [None]
    with pytest.raises(CastException) as e:
        _dec(["1.5", "oops"], 8, 2, ansi=True)
    assert (e.value.row_with_error, e.value.string_with_error) == (1, "oops")


@pytest.mark.parametrize("precision,bits", [(5, 32), (15, 64), (30, 128)])
def test_decimal_storage_widths(precision, bits):
    col = Column.from_pylist(["1.5"], STRING, device="cpu")
    assert pcast.string_to_decimal(col, precision, 1).dtype.bits == bits
