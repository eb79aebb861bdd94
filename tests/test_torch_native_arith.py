"""The native kernels' redesigned per-row arithmetic (csrc/native/
sprt_rowops.h), run by the host plugin, against the JAX package.

The host plugin (csrc/native/host_plugin.cpp) runs the CUDA plugin's
per-row code in loops: the DECIMAL128 plan and its regimes (``dec_plan``:
|a| * |b| in four partial products, digits counted from the bit length,
the rescale by precomputed reciprocals), and the one-pass float parse
over the CUDA kernel's string tiles (``kFloatTileRows`` rows a tile, the
span its buffer holds staged and the rows past it read in place:
``staged_end``). Its ``sprtk_decimal128`` / ``sprtk_cast_to_float64``
are called here directly on numpy buffers and held, with tolerance 0,
to the JAX functions the kernels match: ``_add_sub_scales_any`` /
``_multiply_scales_any`` at products and sums of 10^k - 1, 10^k and
10^k + 1 (k = 0..76) and at every scale triple of
tests/test_torch_native_backend.py (``chip_smoke.DEC_SCALES``), and
``string_to_float`` (with its ANSI error row) over long mantissas,
exponent edges, the suffix and whitespace quirks, strings longer than a
staging buffer and the tile partition's edges. One stated exception, as
in test_torch_native_backend.py: where the JAX package on the CPU
flushes a subnormal FLOAT64 result to +-0.0, the row is held to the
port's torch ``_parse_float``, which keeps it."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar.dtypes import DType as JDType
from spark_rapids_jni_tpu.ops import cast_string as jcast
from spark_rapids_jni_tpu.ops import decimal as jdec
from spark_rapids_jni_tpu.runtime.errors import CastException as JCastException

from spark_rapids_jni_tpu_torch import FLOAT64, STRING, Column
from spark_rapids_jni_tpu_torch.kernels import native
from spark_rapids_jni_tpu_torch.ops import cast_string as pcast

import torch_parity  # noqa: F401  (one torch thread per test process)
from torch_parity import jax_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

MIN_NORMAL = 2.2250738585072014e-308
TILE = native.FLOAT_TILE_ROWS
SPAN = native.FLOAT_STAGE_SPAN
DEC_ROWS = 2048  # one shape for every decimal call: one JAX compile per op

_JAX_DEC = {
    "add": jax.jit(lambda a, b, sa, sb, ts: jdec._add_sub_scales_any(a, b, sa, sb, ts, False)),
    "sub": jax.jit(lambda a, b, sa, sb, ts: jdec._add_sub_scales_any(a, b, sa, sb, ts, True)),
    "mul": jax.jit(jdec._multiply_scales_any),
}


@pytest.fixture(scope="module")
def host():
    """The host plugin with its signatures set."""
    return native.plugin("sprt_native_host")


def _p(a):
    return None if a is None else a.ctypes.data


# -- DECIMAL128


def boundary_operands():
    """Operand pairs whose products and sums sit at 10^k - 1, 10^k and
    10^k + 1 (chip_smoke.decimal_edge_operands: factor pairs for k =
    0..76, the edge values against each other), and for add / subtract
    the pairs (10^k -+ 1, 0), (10^k, +-1) and (10^k - 1, 1) for k <= 38,
    whose sums the (38, 0, 0) triple raises to 10^76; DEC_ROWS rows."""
    sums = []
    for k in range(39):
        p = 10**k
        sums += [(p - 1, 0), (p + 1, 0), (p, 1), (p, -1), (p - 1, 1), (-p, -1)]
    a, b = chip_smoke.decimal_edge_operands(rows=DEC_ROWS - len(sums), seed=71)
    a += [x for x, _ in sums]
    b += [y for _, y in sums]
    return chip_smoke.int128_limbs(a), chip_smoke.int128_limbs(b)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_decimal_boundaries_match_jax(host, op):
    a, b = boundary_operands()
    rng = np.random.default_rng(72)
    va = (rng.random(DEC_ROWS) >= 0.1).astype(np.uint8)
    vb = (rng.random(DEC_ROWS) >= 0.1).astype(np.uint8)
    both = (va & vb).astype(bool)
    n_overflow = 0
    for sa, sb, ts in chip_smoke.DEC_SCALES[op]:
        overflow = np.empty(DEC_ROWS, np.int8)
        out = np.empty((DEC_ROWS, 2), np.int64)
        out_valid = np.empty(DEC_ROWS, np.uint8)
        rc = host.sprtk_decimal128(native.DEC_OPS[op], _p(a), _p(b), _p(va), _p(vb), DEC_ROWS,
                                   sa, sb, ts, _p(overflow), _p(out), _p(out_valid), None)
        assert rc == 0
        wo, wr = _JAX_DEC[op](jnp.asarray(a), jnp.asarray(b), jnp.int32(sa), jnp.int32(sb),
                              jnp.int32(ts))
        label = f"{op} ({sa}, {sb}, {ts})"
        np.testing.assert_array_equal(out, np.asarray(wr), err_msg=label)
        np.testing.assert_array_equal(overflow.astype(bool), np.asarray(wo) & both,
                                      err_msg=label)
        np.testing.assert_array_equal(out_valid.astype(bool), both, err_msg=label)
        n_overflow += int(overflow.sum())
    assert n_overflow > 0


# -- string -> FLOAT64


def host_cast(host, spec):
    """(values, validity, status) of the host plugin's cast over an
    interop STRING spec."""
    offsets = np.ascontiguousarray(spec["offsets"], np.int32)
    n = len(offsets) - 1
    chars = np.ascontiguousarray(spec["data"], np.uint8)
    if chars.size == 0:
        chars = np.zeros(1, np.uint8)
    valid = None if spec["validity"] is None else spec["validity"].astype(np.uint8)
    out = np.empty(n, np.float64)
    ok = np.empty(n, np.uint8)
    status = np.empty(2, np.uint32)
    rc = host.sprtk_cast_to_float64(_p(chars), _p(offsets), _p(valid), n, _p(out), _p(ok),
                                    _p(status), None)
    assert rc == 0
    return out, ok.astype(bool), status


def assert_cast_matches_jax(host, values, seed, nulls=0.05):
    """The host plugin's cast of ``values`` (None: null, and ``nulls`` of
    the rows nulled besides) against JAX string_to_float: values bit for
    bit (the JAX CPU's flushed subnormals held to the port's torch
    parse), validity, the invalid count, and the first ANSI error row
    against the row of the JAX package's CastException. The references
    parse each distinct row once (in the order rows first appear, so the
    first erroneous one is the first erroneous row)."""
    spec = chip_smoke.string_spec_from_list(values, np.random.default_rng(seed), nulls)
    got, ok, status = host_cast(host, spec)
    offs, data = spec["offsets"], spec["data"]
    valid = np.ones(len(got), bool) if spec["validity"] is None else spec["validity"]
    rows = [bytes(data[offs[i]:offs[i + 1]]).decode() if valid[i] else None
            for i in range(len(got))]
    first = {}
    index = np.array([first.setdefault(r, len(first)) for r in rows])
    uspec = chip_smoke.string_spec_from_list(list(first))
    jcol = jax_table([uspec]).columns[0]
    want = jcast.string_to_float(jcol, JDType("float", 64), ansi_mode=False)
    wv = np.ones(len(first), bool) if want.validity is None else np.asarray(want.validity)
    np.testing.assert_array_equal(ok, wv[index])
    w = np.asarray(want.data)[index]
    port = Column(STRING, torch.from_numpy(uspec["data"]),
                  None if uspec["validity"] is None else torch.from_numpy(uspec["validity"]),
                  torch.from_numpy(uspec["offsets"]))
    t = pcast.string_to_float(port, FLOAT64).data.numpy()[index]
    flushed = ok & (w == 0) & (np.abs(got) <= MIN_NORMAL) & (got != 0)
    same = got.view(np.int64) == w.view(np.int64)
    assert np.all(same | flushed)
    np.testing.assert_array_equal(got.view(np.int64), t.view(np.int64))
    assert int(status[1]) == int((~ok).sum())
    try:
        jcast.string_to_float(jcol, JDType("float", 64), ansi_mode=True)
        want_row = 0xFFFFFFFF
    except JCastException as e:
        want_row = int(np.flatnonzero(index == e.row_with_error)[0])
    assert int(status[0]) == want_row
    return got, ok, flushed


def digits(rng, n):
    return "".join(str(d) for d in rng.integers(0, 10, n))


def test_float_long_mantissas_match_jax(host):
    """20-40 significant digits: the 19 kept, the 20th taken or not, the
    rest truncated into the exponent, with leading zeros before and
    after the dot."""
    rng = np.random.default_rng(73)
    values = []
    for _ in range(600):
        m = digits(rng, int(rng.integers(20, 41)))
        dot = int(rng.integers(0, len(m) + 1))
        lead = "0" * int(rng.integers(0, 4))
        frac_lead = "0" * int(rng.integers(0, 30)) if dot == 0 else ""
        e = f"e{int(rng.integers(-60, 60))}" if rng.random() < 0.4 else ""
        values.append(f"{rng.choice(['', '-', '+'])}{lead}{m[:dot]}.{frac_lead}{m[dot:]}{e}")
    values += ["18446744073709551615", "18446744073709551616", "184467440737095516150",
               "1844674407370955161", "18446744073709551609", "99999999999999999999.5",
               "0." + "0" * 40 + "12345678901234567890123"]
    got, ok, _ = assert_cast_matches_jax(host, values, seed=74)
    assert ok.sum() > 500


def test_float_exponent_edges_match_jax(host):
    """Exponents at the +-308 and -324 edges, four-digit exponents and
    long mantissas whose truncation moves the exponent across them."""
    values = ["1e308", "1.7976931348623157e308", "1.7976931348623158e308",
              "1.7976931348623159e308", "9.9e307", "1e309", "-1e308", "17976931348623157e292",
              "2.2250738585072014e-308", "2.2250738585072011e-308", "2.225073858507201e-308",
              "4.9e-324", "4.9406564584124654e-324", "2.4703282292062328e-324",
              "2.4703282292062327e-324", "1e-324", "9e-325", "1e-323", "-4.9e-324",
              "123456789012345678901234e-330", "0.000000000000000000001e-303",
              "1e-0308", "1e+0308", "1e-9999", "1e9999", "1e-1000", "1e12345",
              "1234567890123456789e289", "1234567890123456789e290", "1e-307", "1e-306",
              "9999999999999999999e-326", "1e-343", "1e-344", "5e-324", "3e-324"]
    assert_cast_matches_jax(host, values * 3, seed=75, nulls=0.0)


def test_float_suffix_and_whitespace_quirks_match_jax(host):
    values = ["1.5f", "1.5F", "2.5d", "2.5D", "1.5 f", "1.5ff", "1.5fd", "0f", "0.0d", "-0F",
              "1e5f", "1e5 d", "1e+f", "f", "d", ".f", "5.f", " 1.5 ", "\t-2.25\n",
              "\r+7\r", "1.5\t\t", "  \n1e3", "1 2", "- 1", "+-1", "--1", "1.5f  ", "1.5  f",
              "nan", " nan", "nan ", "NaN", "-nan", "inf", "-Infinity", "infinity ", "INF",
              "infx", "", " ", ".", "-.", ".5", "5.", "1.2.3", "1e", "1e+", "e5", "0x1A",
              "1,5", "12a", "007.5", "0.000", "-0", "00000000000000000000000001"]
    assert_cast_matches_jax(host, values * 4, seed=76)


def test_float_strings_longer_than_a_buffer_match_jax(host):
    """Strings past the staged span: one alone, several in a row, a row
    that ends exactly at the span's end and one that ends a byte past it
    (at the tile shape ``native`` states, which is the header's)."""
    with open(os.path.join(ROOT, "spark_rapids_jni_tpu_torch", "kernels", "csrc", "native",
                           "sprt_rowops.h")) as fh:
        header = fh.read()
    assert f"kFloatTileRows = {TILE};" in header
    assert f"kFloatStageBytes = {SPAN + 32};" in header
    rng = np.random.default_rng(77)
    long_rows = ["0" * (SPAN + 100) + "1.5", "  " + digits(rng, SPAN + 500) + "e-3  ",
                 digits(rng, SPAN * 2) + "." + digits(rng, 30), "-" + "9" * (SPAN + 7) + "d"]
    exact = "1" + "0" * (SPAN - 11) + ".5"          # SPAN - 8 bytes
    values = ["1.25"] * 3 + long_rows[:1] + ["2.5"] * 10 + long_rows
    values += [None] * (TILE - len(values))
    values += [exact, "1234567", "12345678"]  # the second tile: ends at SPAN - 1, SPAN + 7
    values += ["3.75"] * (TILE - 3)
    values += [exact[:-1], "123456789", "7"]  # the third: ends at SPAN, then one past
    got, ok, _ = assert_cast_matches_jax(host, values, seed=78, nulls=0.0)
    assert ok[:18].all() and ok[TILE:].all()


@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 2 * TILE + 3])
def test_float_tile_partition_edges_match_jax(host, n):
    """Row counts at a tile's edges over chip_smoke's quirk strings, with
    empty strings and nulls; past one tile, a first tile of numbers and
    nulls only, so that the first ANSI error lies in a later tile."""
    spec = chip_smoke.float_spec(n, seed=80 + n)
    offs, data = spec["offsets"], spec["data"]
    values = [bytes(data[offs[i]:offs[i + 1]]).decode() for i in range(n)]
    for i in range(0, n, 5):
        values[i] = ""
    for i in range(3, n, 11):
        values[i] = None
    if n > TILE:
        rng = np.random.default_rng(79 + n)
        values[:TILE] = [None if i % 9 == 0 else f"{rng.normal():.5g}" for i in range(TILE)]
    assert_cast_matches_jax(host, values, seed=81 + n, nulls=0.0 if n > TILE else 0.05)
