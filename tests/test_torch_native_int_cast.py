"""The native integer cast's one-pass parse (csrc/native/sprt_rowops.h
``parse_integer``), run by the host plugin, against the JAX package.

The host plugin (csrc/native/host_plugin.cpp) walks the CUDA kernel's
string tiles (``kIntTileRows`` rows a tile, the span its buffer holds
staged and parsed with eight-byte digit runs, the rows past it parsed in
place a byte at a time: ``staged_end``) with the same per-row code. Its
``sprtk_cast_to_integer`` is called here directly on numpy buffers and
held, with tolerance 0, to the JAX package's ``string_to_integer`` (and,
under ANSI, its ``_parse_integer`` and the row of its ``CastException``):
values, validity, the invalid count and the first row made invalid. The
inputs: every string of up to four bytes over ``0 1 9 . + - space \\t a``,
row counts at the tile partition's edges, strings longer than a staging
buffer, the store_sales form ``"  qq "`` and runs of 20-30 digits. The
JAX side parses each distinct string once (in the order rows first
appear, so that the first invalid one is the first invalid row)."""

import itertools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar.dtypes import DType as JDType
from spark_rapids_jni_tpu.columnar.strings import to_char_matrix as j_to_char_matrix
from spark_rapids_jni_tpu.ops import cast_string as jcast
from spark_rapids_jni_tpu.runtime.errors import CastException as JCastException

from spark_rapids_jni_tpu_torch.kernels import native

import torch_parity  # noqa: F401  (one torch thread per test process)
from torch_parity import jax_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TILE = native.INT_TILE_ROWS
SPAN = native.INT_STAGE_SPAN
ALPHABET = "019.+- \ta"
INT_DTYPES = {8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}


@pytest.fixture(scope="module")
def host():
    """The host plugin with its signatures set."""
    return native.plugin("sprt_native_host")


def _p(a):
    return None if a is None else a.ctypes.data


def host_cast(host, spec, bits, ansi, strip):
    """(values, validity, status) of the host plugin's cast over an
    interop STRING spec."""
    offsets = np.ascontiguousarray(spec["offsets"], np.int32)
    n = len(offsets) - 1
    chars = np.ascontiguousarray(spec["data"], np.uint8)
    if chars.size == 0:
        chars = np.zeros(1, np.uint8)
    valid = None if spec["validity"] is None else spec["validity"].astype(np.uint8)
    out = np.empty(n, INT_DTYPES[bits])
    ok = np.empty(n, np.uint8)
    status = np.empty(2, np.uint32)
    rc = host.sprtk_cast_to_integer(_p(chars), _p(offsets), _p(valid), n, bits, int(ansi),
                                    int(strip), _p(out), _p(ok), _p(status), None)
    assert rc == 0
    return out, ok.astype(bool), status


def jax_cast(jcol, bits, ansi, strip):
    """The JAX package's (values, validity) of the cast: string_to_integer
    outside ANSI; under it (where string_to_integer raises instead) its
    _parse_integer with ANSI on, narrowed as string_to_integer narrows."""
    out_type = JDType("int", bits)
    if not ansi:
        col = jcast.string_to_integer(jcol, out_type, ansi_mode=False, strip=strip)
        n = col.data.shape[0]
        ok = np.ones(n, bool) if col.validity is None else np.asarray(col.validity)
        return np.asarray(col.data), ok
    chars, lengths = j_to_char_matrix(jcol, None)
    mag, negative, ok = jcast._parse_integer(chars, lengths, jcol.validity_or_true(), bits,
                                             True, strip)
    signed = mag.astype(jnp.int64)
    value = jnp.where(negative, -signed, signed).astype(out_type.jnp_dtype)
    return np.asarray(jnp.where(ok, value, jnp.zeros_like(value))), np.asarray(ok)


def jax_first_error(jcol, bits, strip):
    """The row of the JAX package's ANSI CastException (0xFFFFFFFF: none)."""
    try:
        jcast.string_to_integer(jcol, JDType("int", bits), ansi_mode=True, strip=strip)
    except JCastException as e:
        return e.row_with_error
    return 0xFFFFFFFF


def assert_matches_jax(host, values, bits, strips=(True,), seed=0, nulls=0.0):
    """The host plugin's cast of ``values`` (None: null; ``nulls`` of the
    rows nulled besides) against the JAX package, for each of ``strips``,
    outside ANSI and under it. Returns the valid rows of each (strip,
    ansi)."""
    spec = chip_smoke.string_spec_from_list(values, np.random.default_rng(seed), nulls)
    offs, data = spec["offsets"], spec["data"]
    valid = np.ones(len(offs) - 1, bool) if spec["validity"] is None else spec["validity"]
    rows = [bytes(data[offs[i]:offs[i + 1]]) if valid[i] else None
            for i in range(len(offs) - 1)]
    first = {}
    index = np.array([first.setdefault(r, len(first)) for r in rows])
    uvals = [None if r is None else r.decode() for r in first]
    if max(len(r or b"") for r in first) <= 64:  # shapes shared across tests: JAX compiles once
        uvals += [None] * (-len(uvals) % 2048)
    jcol = jax_table([chip_smoke.string_spec_from_list(uvals)]).columns[0]
    counts = {}
    for strip, ansi in itertools.product(strips, (False, True)):
        label = f"int{bits} strip {strip} ansi {ansi}"
        got, ok, status = host_cast(host, spec, bits, ansi, strip)
        want, want_ok = jax_cast(jcol, bits, ansi, strip)
        np.testing.assert_array_equal(ok, want_ok[index], err_msg=label)
        np.testing.assert_array_equal(got, want[index], err_msg=label)
        assert int(status[1]) == int((~ok).sum()), label
        bad = np.flatnonzero(~ok & valid)
        assert int(status[0]) == (int(bad[0]) if bad.size else 0xFFFFFFFF), label
        counts[(strip, ansi)] = int(ok.sum())
    for strip in strips:  # the first row made invalid is the ANSI error's row
        u = jax_first_error(jcol, bits, strip)
        want_row = int(np.flatnonzero(index == u)[0]) if u != 0xFFFFFFFF else u
        _, _, status = host_cast(host, spec, bits, True, strip)
        assert int(status[0]) == want_row, f"int{bits} strip {strip}"
    return counts


def short_strings():
    """Every string of 0 to 4 bytes over ALPHABET (7,381 strings)."""
    return ["".join(t) for k in range(5) for t in itertools.product(ALPHABET, repeat=k)]


@pytest.mark.parametrize("bits", [8, 64])
@pytest.mark.parametrize("strip", [False, True])
def test_every_short_string_matches_jax(host, bits, strip):
    values = short_strings()
    counts = assert_matches_jax(host, values, bits, strips=(strip,))
    assert counts[(strip, False)] > counts[(strip, True)] > 0


@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 2 * TILE + 3])
def test_tile_partition_edges_match_jax(host, n):
    """Row counts at a tile's edges over phase 11's integer strings
    (chip_smoke.int_cast_spec: INT_CASES and integers in whitespace, 5 %
    nulls), at a width that changes with n; past one tile, a first tile
    of integers and nulls only, so that the first invalid row lies in a
    later tile."""
    spec = chip_smoke.int_cast_spec(n, seed=90 + n)
    offs, data = spec["offsets"], spec["data"]
    valid = np.ones(n, bool) if spec["validity"] is None else spec["validity"]
    values = [bytes(data[offs[i]:offs[i + 1]]).decode() if valid[i] else None
              for i in range(n)]
    if n > TILE:
        rng = np.random.default_rng(91 + n)
        values[:TILE] = [None if i % 9 == 0 else f" {int(rng.integers(-99, 99))} "
                         for i in range(TILE)]
    bits = {1: 8, TILE - 1: 16, TILE: 32}.get(n, 64)
    assert_matches_jax(host, values, bits)


def test_strings_longer_than_a_buffer_match_jax(host):
    """Strings past the staged span (at the tile shape ``native`` states,
    which is the header's): one alone, several in a row, a row that ends
    exactly at the span's end and one that ends a byte past it."""
    with open(os.path.join(ROOT, "spark_rapids_jni_tpu_torch", "kernels", "csrc", "native",
                           "sprt_rowops.h")) as fh:
        header = fh.read()
    assert f"kIntTileRows = {TILE};" in header
    assert f"kIntStageBytes = {SPAN + 32};" in header
    long_rows = ["0" * (SPAN + 100) + "12", "  " + "0" * (SPAN + 500) + "-7  ",
                 "-" + "0" * (SPAN * 2) + "99." + "5" * 30, "1" * (SPAN + 7),
                 " " * (SPAN + 3) + "42 ", "7." + "0" * SPAN]
    exact = "  " + "0" * (SPAN - 14) + "1.5"  # SPAN - 9 bytes
    values = ["12"] * 3 + long_rows[:1] + ["25"] * 10 + long_rows
    values += [None] * (TILE - len(values))
    values += [exact, "1234567", "12345678"]  # the second tile: ends at SPAN - 2, SPAN + 6
    values += ["37"] * (TILE - 3)
    values += [exact + " ", "12345678", "7"]  # the third: ends at SPAN, then one past
    counts = assert_matches_jax(host, values, 64, strips=(False, True))
    assert counts[(True, False)] > TILE


def test_store_sales_form_matches_jax(host):
    """One store_sales row group's quantity strings "  qq " (cut to a few
    tiles) to INT32: every row valid and equal to the generator's
    quantity."""
    n = 4 * TILE + 5
    spec = chip_smoke.ss_quantity_spec(n)
    got, ok, status = host_cast(host, spec, 32, False, True)
    assert ok.all() and list(status) == [0xFFFFFFFF, 0]
    np.testing.assert_array_equal(got, chip_smoke.ss_gen_chunk(n, 1000)["qty_i"])
    offs, data = spec["offsets"], spec["data"]
    values = [bytes(data[offs[i]:offs[i + 1]]).decode() for i in range(n)]
    assert_matches_jax(host, values, 32, seed=92, nulls=0.05)


def test_long_digit_runs_match_jax(host):
    """20-30 digits with and without leading zeros, before a dot and
    after it: the 19-significant-digit limit, the widths' limits and the
    eight-byte runs' chunks at every alignment."""
    rng = np.random.default_rng(93)
    values = []
    for _ in range(1500):
        m = "".join(str(d) for d in rng.integers(0, 10, int(rng.integers(20, 31))))
        zeros = "0" * int(rng.integers(0, 14)) if rng.random() < 0.5 else ""
        cut = int(rng.integers(1, len(m) + 1))
        body = m[:cut] if rng.random() < 0.5 else f"{m[:cut]}.{m[cut:]}"
        lead = " " * int(rng.integers(0, 9)) if rng.random() < 0.5 else ""
        values.append(f"{lead}{rng.choice(['', '-', '+'])}{zeros}{body}")
    for k in range(1, 20):
        for v in (10**k - 1, 10**k, 2**63 - 1, 2**63):
            values += [str(v), f"-{v}", "0" * k + str(v), f"{v}.{'9' * k}"]
    for bits in (8, 64):
        counts = assert_matches_jax(host, values, bits, seed=94, nulls=0.05)
        assert counts[(True, False)] > 0
