"""The JNI library's native backend (kernels/csrc/host/native_backend.cpp)
over its host plugin, against the JAX package.

The backend is registered as the accelerated one with
``init_native(device="cpu")``, which loads the host plugin: the same
per-row C++ (csrc/native/sprt_rowops.h) that the CUDA plugin's kernels
run, in loops. Ops are driven through the C ``SprtBackend`` pointer with
the JAX backend's arguments, on columns built by the ``test.*``
factories from seeded numpy inputs with edge values, and each result is
copied out and held, with tolerance 0, to the JAX function the kernel
matches: ``_parse_integer`` and ``_parse_float`` (through
``string_to_integer`` / ``string_to_float``), ``_add_sub_scales_any`` /
``_multiply_scales_any`` and the fixed-width JCUDF rows. One stated
exception: where the JAX package on the CPU flushes a subnormal FLOAT64
result to +-0.0, the row is held to the port's torch ``_parse_float``,
which keeps it (tests/test_torch_float_cast.py holds that to the JAX
formula). Then the fall-through to the Python backend through the JNI
entry points, the ops the backend declines, the test readers, the init
contract and ``native/tests/backend_smoke.cpp`` run as a process with no
Python."""

import ctypes
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar.dtypes import DType as JDType
from spark_rapids_jni_tpu.ops import cast_string as jcast
from spark_rapids_jni_tpu.ops import decimal as jdec
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.runtime.errors import CastException as JCastException

from spark_rapids_jni_tpu_torch import FLOAT64, STRING, Column
from spark_rapids_jni_tpu_torch.columnar.interop import column_to_numpy
from spark_rapids_jni_tpu_torch.kernels import _build, native
from spark_rapids_jni_tpu_torch.ops import cast_string as pcast
from spark_rapids_jni_tpu_torch.runtime import jni_backend as jb

import torch_parity  # noqa: F401  (one torch thread per test process)
from torch_parity import jax_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

UNSUPPORTED = -2
N = 512  # rows of each seeded column
K = {"INT8": 1, "INT16": 2, "INT32": 3, "INT64": 4, "BOOL8": 8, "FLOAT32": 9, "FLOAT64": 10,
     "DECIMAL128": 27}
MIN_NORMAL = 2.2250738585072014e-308


@pytest.fixture(scope="module")
def lib():
    """The port's sprt_jni with the Python backend registered (the
    default one) and the native backend over the host plugin (the
    accelerated one); unregistered again on teardown."""
    _build.build("sprt_jni", "sprt_native_host", "backend_smoke")
    lib = jb.register(device="cpu")
    jb.init_native(device="cpu")
    lib.sprt_get_accel_backend.restype = ctypes.POINTER(jb.SprtBackend)
    lib.sprt_get_backend.restype = ctypes.POINTER(jb.SprtBackend)
    yield lib
    jb.uninit_native()


@pytest.fixture
def nat(lib):
    """Calls through the accelerated pointer; every handle a test makes
    is released after it, and the live bytes come back to where they
    were."""
    before = jb.native_counts(lib)["live_bytes"]
    made = []

    def call(op, *args, ok=True):
        flat = np.concatenate([np.ravel(np.asarray(a, np.int64)) for a in flatten(args)])
        rc, out, err, row, s = jb.call_backend(lib.sprt_get_accel_backend(), op, flat)
        if ok:
            assert rc == 0, (op, rc, err)
        if rc == 0 and op not in jb.SCALAR_OPS:
            made.extend(out)
        return out if ok else (rc, out, err, row, s)

    call.lib = lib
    yield call
    for h in made:
        call("handle.release", h)
    assert jb.native_counts(lib)["live_bytes"] == before


def flatten(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from flatten(a)
        else:
            yield a


def read(lib, h):
    return jb.native_column(lib, h, device="cpu")


def strings(values, seed):
    """(port Column, JAX Column, make_string_column args) of ``values``
    with 5 % more nulls drawn from ``seed``."""
    spec = chip_smoke.string_spec_from_list(values, np.random.default_rng(seed), 0.05)
    port = Column(STRING, torch.from_numpy(spec["data"]),
                  None if spec["validity"] is None else torch.from_numpy(spec["validity"]),
                  torch.from_numpy(spec["offsets"]))
    jcol = jax_table([spec]).columns[0]
    return port, jcol, jb.pack_string_rows(spec["data"], spec["offsets"], spec["validity"])


def int_strings(seed=1):
    rng = np.random.default_rng(seed)
    ws = ["", " ", "\t", "\n ", "\r"]
    cases = list(chip_smoke.INT_CASES) + ["1.5", " -1.9 ", "+0012.", ".5", "1.2.3", "- 5"]
    rand = [f"{ws[a]}{v}{ws[b]}" for a, b, v in zip(
        rng.integers(0, 5, N), rng.integers(0, 5, N), rng.integers(-(2**63), 2**63 - 1, N))]
    small = [str(v) for v in rng.integers(-40000, 40000, N // 4)]
    return cases + rand[: N - len(cases) - len(small)] + small


def same(got: Column, want_data, want_valid):
    want_valid = np.ones(len(got), bool) if want_valid is None else np.asarray(want_valid)
    np.testing.assert_array_equal(got.validity_or_true().numpy(), want_valid)
    g = got.data.numpy()
    w = np.asarray(want_data)
    np.testing.assert_array_equal(g.view(np.uint8), w.astype(g.dtype).view(np.uint8))


# -- (a) string -> integer


@pytest.mark.parametrize("bits,strip", [(8, True), (16, True), (32, True), (64, True),
                                        (32, False)])
def test_cast_to_integer_matches_jax(nat, bits, strip):
    _port, jcol, args = strings(int_strings(), seed=2)
    h = nat("test.make_string_column", args)[0]
    got = read(nat.lib, nat("cast.to_integer", h, 0, int(strip), K[f"INT{bits}"])[0])
    want = jcast.string_to_integer(jcol, JDType("int", bits), ansi_mode=False, strip=strip)
    same(got, want.data, want.validity)
    assert got.validity is not None and not bool(got.validity.all())


def test_cast_to_integer_ansi(nat):
    values = int_strings()
    _port, jcol, args = strings(values, seed=2)
    h = nat("test.make_string_column", args)[0]
    with pytest.raises(JCastException) as e:
        jcast.string_to_integer(jcol, JDType("int", 32), ansi_mode=True, strip=True)
    rc, _, _, row, s = nat("cast.to_integer", h, 1, 1, K["INT32"], ok=False)
    assert rc == 1 and (row, s) == (e.value.row_with_error, e.value.string_with_error)
    # rows that are all valid under ANSI (nulls too): the values, no error
    clean = values[len(chip_smoke.INT_CASES) + 6:]
    _port, jcol, args = strings(clean, seed=3)
    h = nat("test.make_string_column", args)[0]
    got = read(nat.lib, nat("cast.to_integer", h, 1, 1, K["INT64"])[0])
    want = jcast.string_to_integer(jcol, JDType("int", 64), ansi_mode=True, strip=True)
    same(got, want.data, want.validity)


# -- (b) string -> FLOAT64


def float_strings(seed=4):
    spec = chip_smoke.float_spec(N, seed)
    offs, data = spec["offsets"], spec["data"]
    vals = [bytes(data[offs[i]:offs[i + 1]]).decode() for i in range(N)]
    return list(chip_smoke.FLOAT_CASES) + vals[len(chip_smoke.FLOAT_CASES):]


def test_cast_to_float_matches_jax(nat):
    port, jcol, args = strings(float_strings(), seed=5)
    h = nat("test.make_string_column", args)[0]
    got = read(nat.lib, nat("cast.to_float", h, 0, K["FLOAT64"])[0])
    want = jcast.string_to_float(jcol, JDType("float", 64), ansi_mode=False)
    torch_want = pcast.string_to_float(port, FLOAT64)
    wv = np.ones(len(got), bool) if want.validity is None else np.asarray(want.validity)
    np.testing.assert_array_equal(got.validity_or_true().numpy(), wv)
    g, w = got.data.numpy(), np.asarray(want.data)
    same_bits = g.view(np.int64) == w.view(np.int64)
    # the JAX CPU's flushed subnormals: held to the port's torch parse
    flushed = wv & (w == 0) & (np.abs(g) <= MIN_NORMAL) & (g != 0)
    assert flushed.sum() >= 3 and np.all(same_bits | flushed)
    t = torch_want.data.numpy()
    np.testing.assert_array_equal(g.view(np.int64), t.view(np.int64))
    assert np.isnan(g).any() and np.isinf(g).any() and (np.signbit(g) & (g == 0)).any()


def test_cast_to_float_ansi(nat):
    _port, jcol, args = strings(float_strings(), seed=5)
    h = nat("test.make_string_column", args)[0]
    with pytest.raises(JCastException) as e:
        jcast.string_to_float(jcol, JDType("float", 64), ansi_mode=True)
    rc, _, _, row, s = nat("cast.to_float", h, 1, K["FLOAT64"], ok=False)
    assert rc == 1 and (row, s) == (e.value.row_with_error, e.value.string_with_error)


# -- (c) DECIMAL128


def decimal_limbs(seed):
    """int64 [N, 2] two's-complement limbs: zeros, +-1, +-5 and +-15 at
    powers of ten (rounding ties), values of every digit count to 38,
    10^38 - 1 and 10^38 and their negatives, and random 127-bit values."""
    rng = np.random.default_rng(seed)
    vals = [0, 1, -1, 5, -5, 15, -15, 10**38 - 1, -(10**38 - 1), 10**38, -(10**38),
            2**127 - 1, -(2**127)]
    vals += [int(s) * 5 * 10 ** int(k) for s, k in zip(rng.choice([-1, 1], 40),
                                                       rng.integers(0, 37, 40))]
    digits = rng.integers(1, 39, N)
    vals += [int(s) * int(rng.integers(1, 10)) * 10 ** (int(d) - 1) + int(rng.integers(0, 10**9))
             for s, d in zip(rng.choice([-1, 1], N), digits)]
    vals = vals[:N]
    u = [v & ((1 << 128) - 1) for v in vals]
    return np.array([[x & (2**64 - 1), x >> 64] for x in u], np.uint64).view(np.int64)


def decimal_args(limbs, scale, valid):
    return [len(limbs), scale, limbs[:, 0], limbs[:, 1], valid.astype(np.int64)]


_JAX_DEC = {
    "add": jax.jit(lambda a, b, sa, sb, ts: jdec._add_sub_scales_any(a, b, sa, sb, ts, False)),
    "sub": jax.jit(lambda a, b, sa, sb, ts: jdec._add_sub_scales_any(a, b, sa, sb, ts, True)),
    "mul": jax.jit(jdec._multiply_scales_any),
}
_DEC_OP = {"add": "decimal.add128", "sub": "decimal.subtract128", "mul": "decimal.multiply128"}
DEC_SCALES = {
    "add": [(2, 2, 2), (2, 3, 3), (3, 2, 2), (0, 5, 1), (2, 2, 4), (38, 0, 0), (10, 40, 3),
            (-3, 2, 1)],
    "mul": [(2, 2, 4), (2, 2, 2), (10, 10, 6), (19, 19, 0), (0, 0, 5), (2, 3, 1), (30, 10, 2),
            (6, 2, 0)],
}
DEC_SCALES["sub"] = DEC_SCALES["add"]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_decimal_matches_jax(nat, op):
    a, b = decimal_limbs(6), decimal_limbs(7)[::-1].copy()
    rng = np.random.default_rng(8)
    va, vb = rng.random(N) > 0.1, rng.random(N) > 0.1
    n_overflow = 0
    for sa, sb, ts in DEC_SCALES[op]:
        ha = nat("test.make_decimal_column", decimal_args(a, sa, va))[0]
        hb = nat("test.make_decimal_column", decimal_args(b, sb, vb))[0]
        oflow, res = nat(_DEC_OP[op], ha, hb, ts)
        got_o, got_r = read(nat.lib, oflow), read(nat.lib, res)
        wo, wr = _JAX_DEC[op](jnp.asarray(a), jnp.asarray(b), jnp.int32(sa), jnp.int32(sb),
                              jnp.int32(ts))
        both = va & vb
        same(got_o, np.asarray(wo) & both, both)
        same(got_r, np.asarray(wr), both)
        assert got_r.dtype.scale == ts
        n_overflow += int(got_o.data.numpy().sum())
    assert n_overflow > 0


def test_decimal_guards_and_masks(nat):
    a = decimal_limbs(9)[:4]
    ha = nat("test.make_decimal_column", [4, 20, a[:, 0], a[:, 1]])[0]
    hb = nat("test.make_decimal_column", [4, 20, a[:, 0], a[:, 1]])[0]
    hc = nat("test.make_decimal_column", [4, -60, a[:, 0], a[:, 1]])[0]
    h3 = nat("test.make_decimal_column", [3, 2, a[:3, 0], a[:3, 1]])[0]
    rc, _, err, _, _ = nat("decimal.multiply128", ha, hb, 1, ok=False)
    assert (rc, err) == (1, "divisor too big")
    rc, *_ = nat("decimal.add128", ha, hb, -19, ok=False)  # a rescale past 10^38: declined
    assert rc == UNSUPPORTED
    rc, _, err, _, _ = nat("decimal.add128", ha, hc, 20, ok=False)
    assert rc == 1 and "256-bit" in err
    rc, _, err, _, _ = nat("decimal.add128", ha, h3, 2, ok=False)
    assert (rc, err) == (1, "mismatched row counts")
    rc, *_ = nat("decimal.divide128", ha, hb, 2, 0, ok=False)
    assert rc == UNSUPPORTED
    # no masks in: none out; a mask on one side: the overflow masked too
    oflow, res = nat("decimal.add128", ha, hb, 20)
    assert read(nat.lib, oflow).validity is None and read(nat.lib, res).validity is None
    hv = nat("test.make_decimal_column", [4, 20, a[:, 0], a[:, 1], [1, 0, 1, 0]])[0]
    oflow, res = nat("decimal.add128", ha, hv, 20)
    assert read(nat.lib, res).validity.tolist() == [True, False, True, False]
    assert read(nat.lib, oflow).data.tolist()[1::2] == [0, 0]


# -- (d) JCUDF rows


def jax_rows(port_cols):
    """The JAX package's rows of the same columns (as the port copied
    them out of the backend)."""
    return jrc.convert_to_rows(jax_table([column_to_numpy(c) for c in port_cols]))


def test_rows_narrow_schema_match_jax(nat):
    rng = np.random.default_rng(10)
    n = 300
    i64 = rng.integers(-(2**63), 2**63 - 1, n)
    i32 = rng.integers(-(2**31), 2**31 - 1, n)
    i8 = rng.integers(-128, 128, n)
    v64, v8 = rng.random(n) > 0.2, rng.random(n) > 0.3
    c64 = nat("test.make_long_column", n, i64, v64.astype(np.int64))[0]
    c32 = nat("test.make_int_column", n, K["INT32"], i32)[0]
    c8 = nat("test.make_int_column", n, K["INT8"], i8, v8.astype(np.int64))[0]
    cols = [read(nat.lib, h) for h in (c64, c32, c8)]
    tbl = nat("test.make_table", c64, c32, c8)[0]
    rows = nat("row_conversion.to_rows", tbl)
    want = jax_rows(cols)
    assert len(rows) == len(want) == 1
    got = read(nat.lib, rows[0])
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want[0].data).view(np.uint8))
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want[0].offsets))
    back = nat("row_conversion.from_rows_fixed_width", rows[0], K["INT64"], K["INT32"],
               K["INT8"], 0, 0, 0)
    jback = jrc.convert_from_rows(want, [JDType("int", 64), JDType("int", 32), JDType("int", 8)])
    for h, jc in zip(back, jback.columns):
        same(read(nat.lib, h), jc.data, jc.validity)
        assert read(nat.lib, h).validity is not None


def test_rows_wide_schema_match_jax(nat):
    """(DECIMAL128, INT64, FLOAT64, INT32, INT16, INT8, BOOL8), nulls in
    most: the layout pads INT16 and BOOL8 after wider columns."""
    rng = np.random.default_rng(11)
    n = 200
    dec = decimal_limbs(12)[:n]
    vd = rng.random(n) > 0.2
    _p, _j, fargs = strings([repr(float(x)) for x in rng.normal(size=n) * 1e6], seed=13)
    _p, _j, sargs = strings([str(x) for x in rng.integers(-40000, 40000, n)], seed=14)
    hs = [
        nat("test.make_decimal_column", decimal_args(dec, 3, vd))[0],
        nat("test.make_long_column", n, rng.integers(-(2**40), 2**40, n),
            (rng.random(n) > 0.5).astype(np.int64))[0],
        nat("cast.to_float", nat("test.make_string_column", fargs)[0], 0, K["FLOAT64"])[0],
        nat("test.make_int_column", n, K["INT32"], rng.integers(-(2**31), 2**31 - 1, n))[0],
        nat("cast.to_integer", nat("test.make_string_column", sargs)[0], 0, 1, K["INT16"])[0],
        nat("test.make_int_column", n, K["INT8"], rng.integers(-128, 128, n),
            (rng.random(n) > 0.5).astype(np.int64))[0],
    ]
    oflow, _res = nat("decimal.multiply128", hs[0], hs[0], 6)
    hs.append(oflow)
    cols = [read(nat.lib, h) for h in hs]
    rows = nat("row_conversion.to_rows", nat("test.make_table", *hs)[0])
    want = jax_rows(cols)
    got = read(nat.lib, rows[0])
    assert got.offsets[1] == 48  # 16 + 8 + 8 + 4 + 2 + 1 + 1 bytes, a validity byte, padding
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want[0].data).view(np.uint8))
    ids = [K["DECIMAL128"], K["INT64"], K["FLOAT64"], K["INT32"], K["INT16"], K["INT8"],
           K["BOOL8"]]
    back = nat("row_conversion.from_rows", rows[0], ids, [-3, 0, 0, 0, 0, 0, 0])
    schema = [JDType("decimal", 128, 38, 3), JDType("int", 64), JDType("float", 64),
              JDType("int", 32), JDType("int", 16), JDType("int", 8), JDType("bool", 8)]
    jback = jrc.convert_from_rows(want, schema)
    for h, jc, src in zip(back, jback.columns, cols):
        got_c = read(nat.lib, h)
        same(got_c, jc.data, jc.validity)
        assert torch.equal(got_c.validity, src.validity_or_true())
    assert read(nat.lib, back[0]).dtype.scale == 3


# -- the fall-through, the declines, the readers


def _env():
    """A JNIEnv for the stub jni.h, whose members never touch it."""
    return ctypes.create_string_buffer(64)


def test_jni_entry_points_fall_through_to_python(nat):
    lib = nat.lib
    to_int = lib.Java_com_nvidia_spark_rapids_jni_CastStrings_toInteger
    to_int.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_uint8,
                       ctypes.c_uint8, ctypes.c_int]
    to_int.restype = ctypes.c_long
    to_float = lib.Java_com_nvidia_spark_rapids_jni_CastStrings_toFloat
    to_float.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_uint8,
                         ctypes.c_int]
    to_float.restype = ctypes.c_long
    env = _env()
    values = ["12", " 34 ", "x", None, "1.5"]
    # a Python-registry handle: the native backend declines it, Python serves it
    py_h = jb.REGISTRY.put(Column.from_pylist(values, STRING, device="cpu"))
    out = to_int(env, None, py_h, 0, 1, K["INT32"])
    assert 0 < out < (1 << 40)
    assert jb.REGISTRY.get(out).to_pylist() == [12, 34, None, None, 1]
    # FLOAT32 is left to Python too
    out32 = to_float(env, None, py_h, 0, K["FLOAT32"])
    assert 0 < out32 < (1 << 40) and jb.REGISTRY.get(out32).to_pylist()[0] == 12.0
    for h in (py_h, out, out32):
        jb.REGISTRY.release(h)
    # a native handle: served natively, no Python handle made
    n_py = len(jb.REGISTRY)
    _p, _j, args = strings(values, seed=15)
    h = nat("test.make_string_column", args)[0]
    native_out = to_int(env, None, h, 0, 1, K["INT32"])
    assert native_out >= (1 << 40) and len(jb.REGISTRY) == n_py
    got = read(lib, native_out)
    nat("handle.release", native_out)
    assert got.to_pylist()[:3] == [12, 34, None]
    # FLOAT32 of a native handle: declined, and the Python backend cannot
    # read a native handle (the JAX design's limit): the call fails
    assert to_float(env, None, h, 0, K["FLOAT32"]) == 0


def test_ops_outside_the_set_are_declined(nat):
    _p, _j, args = strings(["1", "2"], seed=16)
    s = nat("test.make_string_column", args)[0]
    c64 = nat("test.make_long_column", 2, [1, 2])[0]
    tbl = nat("test.make_table", c64, s)[0]
    declined = [
        ("cast.to_decimal", [s, 0, 1, 9, 2]),
        ("cast.to_float", [s, 0, K["FLOAT32"]]),
        ("row_conversion.to_rows", [tbl]),  # a string column in the rows
        ("regex.rlike", [s, *jb.pack_string("1")]),
        ("rmm.start_task", [7]),
        ("cast.to_integer", [c64, 0, 1, K["INT32"]]),  # not a string column
        ("test.get_long_at", [s, 0]),
    ]
    for op, args in declined:
        assert nat(op, *args, ok=False)[0] == UNSUPPORTED, op
    # handles the backend does not hold are not its to release
    assert nat("handle.release", 12345, ok=False)[0] == UNSUPPORTED
    # the op table is the JAX C++ backend's (native/jni/pjrt_backend.cpp)
    ops = {}
    for name in ("native/jni/pjrt_backend.cpp", "spark_rapids_jni_tpu_torch/kernels/csrc/host/"
                 "native_backend.cpp"):
        with open(os.path.join(ROOT, name)) as f:
            ops[name] = set(re.findall(r'op == "([a-z_.0-9]+)"', f.read()))
    assert [len(v) for v in ops.values()] == [20, 20]
    assert len({frozenset(v) for v in ops.values()}) == 1
    assert ops[name] <= set(jb._OPS)


def test_test_readers(nat):
    dec = np.array([[7, 0], [-3, -1]], np.int64)
    hd = nat("test.make_decimal_column", [2, 4, dec[:, 0], dec[:, 1], [1, 0]])[0]
    _p, _j, fargs = strings(["2.9", "-2.9"], seed=17)
    hf = nat("cast.to_float", nat("test.make_string_column", fargs)[0], 0, K["FLOAT64"])[0]
    _p, _j, sargs = strings(["hello", None, "x" * 70], seed=18)
    hs = nat("test.make_string_column", sargs)[0]
    assert nat("test.get_long_at", hd, 1) == [-3]  # the low limb, even under a null
    assert nat("test.is_null_at", hd, 1) == [1] and nat("test.is_null_at", hd, 0) == [0]
    assert nat("test.get_long_at", hf, 0) == [2] and nat("test.get_long_at", hf, 1) == [-2]
    assert nat("test.row_count", hs) == [3]
    assert nat("test.get_string_at", hs, 0) == jb.pack_string("hello")
    assert nat("test.get_string_at", hs, 1) == [-1]
    assert nat("test.get_string_at", hs, 2) == jb.pack_string("x" * 56)
    tbl = nat("test.make_table", hd, hf)[0]
    assert nat("test.row_count", tbl) == [2]
    col = nat("test.table_column", tbl, 1)[0]
    assert nat("test.get_long_at", col, 1) == [-2]
    rc, _, err, _, _ = nat("test.table_column", tbl, 2, ok=False)
    assert (rc, err) == (1, "bad table column index")
    rc, _, err, _, _ = nat("test.get_long_at", hd, 2, ok=False)
    assert (rc, err) == (1, "row index out of range")


# -- the kernels' wrappers: the plain versions the card is held to


def test_wrappers_take_the_plain_versions_on_cpu_tensors(nat):
    port, _j, args = strings(int_strings(), seed=19)
    h = nat("test.make_string_column", args)[0]
    got = read(nat.lib, nat("cast.to_integer", h, 0, 1, K["INT64"])[0])
    value, ok, status = native.cast_integer(port.data, port.offsets, port.validity, 64, False,
                                            True)
    assert torch.equal(value, got.data) and torch.equal(ok, got.validity_or_true())
    assert int(status[1]) == int((~ok).sum()) and int(status[0]) < len(ok)
    a = torch.from_numpy(decimal_limbs(20))
    o1, r1, v1 = native.decimal128("mul", a, a, None, None, 2, 2, 4)
    o2, r2, _v = native.decimal128_plain("mul", a, a, None, None, 2, 2, 4)
    assert v1 is None and torch.equal(o1, o2) and torch.equal(r1, r2)
    from spark_rapids_jni_tpu_torch.columnar.dtypes import INT8, INT64

    cols = [Column(INT64, torch.arange(5, dtype=torch.int64)),
            Column(INT8, torch.arange(5, dtype=torch.int8), torch.tensor([1, 0, 1, 0, 1]) > 0)]
    rows = native.to_rows(cols)
    assert rows.shape == (5, 16)
    back = native.from_rows(rows, [INT64, INT8])
    assert torch.equal(back[0][0], cols[0].data) and torch.equal(back[1][1], cols[1].validity)


# -- the process with no Python, the init contract, the teardown


def test_backend_smoke_runs_with_no_python(lib):
    exe = _build.library_path("backend_smoke")
    plugin = native.plugin_path("cpu")
    proc = subprocess.run([exe, plugin, "unused-exports-dir", "device=i:0", "--bench"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "no Python in process" in proc.stdout and "cpp_dispatch_per_call" in proc.stdout
    needed = subprocess.run(["readelf", "-d", exe], capture_output=True, text=True).stdout
    assert "NEEDED" in needed and "python" not in needed.lower()


def test_init_contract(lib):
    lib.sprt_pjrt_backend_init.argtypes = [ctypes.c_char_p] * 3
    assert lib.sprt_pjrt_backend_init(None, b"", b"") != 0  # no plugin
    not_a_plugin = _build.library_path("sprt_jni").encode()
    assert lib.sprt_pjrt_backend_init(not_a_plugin, b"", b"device=i:0") != 0
    assert lib.sprt_pjrt_backend_init(b"/no/such/plugin.so", b"", b"") != 0
    # a device the plugin refuses: an error, not a registration
    assert lib.sprt_pjrt_backend_init(native.plugin_path("cpu").encode(), b"",
                                      b"device=i:1") == 2
    assert native.plugin_name("cpu") == "sprt_native_host"
    assert native.plugin_name("cuda") == native.plugin_name("cuda:0") == "sprt_native_cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            jb.init_native()
    assert lib.sprt_get_accel_backend()  # the failed inits left the registration alone


def test_unregistered_after_uninit(lib):
    jb.uninit_native()
    try:
        assert not lib.sprt_get_accel_backend()
        # the default backend takes the factories again
        rc, out, _e, _r, _s = jb.call_backend(lib.sprt_get_backend(), "test.make_long_column",
                                              [2, 5, 6])
        assert rc == 0 and out[0] < (1 << 40)
        jb.REGISTRY.release(out[0])
    finally:
        jb.init_native(device="cpu")
    assert lib.sprt_get_accel_backend()
    assert jb.native_counts(lib)["live_bytes"] == 0
