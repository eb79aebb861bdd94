"""The port's JNI dispatch backend (runtime/jni_backend.py) without a JVM:
build the port's own JNI library (``sprt_jni``: ``native/jni/`` by g++,
without its PJRT half), register the port's backend into it, and drive
ops through the C ``SprtBackend.call`` pointer, the path the JNI entry
points take (native/jni/sprt_jni_common.hpp run_op).

The first cases are tests/test_jni_backend.py's, one for one. Then each
op family runs one scenario twice: through the JAX package's handlers
(its ``_OPS``) and through the port's C dispatch, on the same inputs
(built by the ``test.*`` factories from a numpy seed). Every column,
null mask, offset, limb, scalar result and error must be equal."""

import ctypes
import os

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.runtime import jni_backend as jjb

from spark_rapids_jni_tpu_torch import Column, Table
from spark_rapids_jni_tpu_torch.columnar.dtypes import INT32, INT64, STRING
from spark_rapids_jni_tpu_torch.columnar.nested import ListColumn
from spark_rapids_jni_tpu_torch.kernels import _build
from spark_rapids_jni_tpu_torch.runtime import jni_backend, metrics

import torch_parity  # noqa: F401  (one torch thread per test process)
from torch_parity import assert_same_batches, assert_same_table


@pytest.fixture(scope="module")
def lib():
    lib = jni_backend.register(device="cpu")
    lib.sprt_get_backend.restype = ctypes.POINTER(jni_backend.SprtBackend)
    lib.sprt_get_accel_backend.restype = ctypes.c_void_p
    return lib


@pytest.fixture(scope="module")
def backend(lib):
    return lib.sprt_get_backend()


def _call(backend, op, args):
    arr = (ctypes.c_long * len(args))(*args)
    res = jni_backend.SprtCallResult()
    res.error_row = -1
    rc = backend.contents.call(op.encode(), arr, len(args), ctypes.byref(res))
    return rc, res


def _text(ptr):
    return ctypes.cast(ptr, ctypes.c_char_p).value


_pack = jni_backend.pack_string


# -- tests/test_jni_backend.py, case by case, on the port


def test_cast_to_integer_through_c_dispatch(backend):
    col = Column.from_pylist(["12", " 34 ", "bad", None], STRING, device="cpu")
    h = jni_backend.REGISTRY.put(col)
    rc, res = _call(backend, "cast.to_integer", [h, 0, 1, 3])  # INT32 id=3
    assert rc == 0 and res.n_handles == 1
    out = jni_backend.REGISTRY.get(res.handles[0])
    assert out.to_pylist() == [12, 34, None, None]
    assert out.dtype == INT32


def test_cast_ansi_error_carries_row_and_string(backend):
    col = Column.from_pylist(["1", "oops", "3"], STRING, device="cpu")
    h = jni_backend.REGISTRY.put(col)
    rc, res = _call(backend, "cast.to_integer", [h, 1, 1, 4])  # ansi INT64
    assert rc == 1
    assert res.error_row == 1
    assert _text(res.error_str) == b"oops"


def test_row_conversion_round_trip_through_c_dispatch(backend):
    tbl = Table([
        Column.from_numpy(np.arange(8, dtype=np.int64), INT64, device="cpu"),
        Column.from_numpy(np.arange(8, dtype=np.int32) * 3, INT32, device="cpu"),
    ])
    h = jni_backend.REGISTRY.put(tbl)
    rc, res = _call(backend, "row_conversion.to_rows", [h])
    assert rc == 0 and res.n_handles == 1
    rc, res = _call(backend, "row_conversion.from_rows", [res.handles[0], 4, 3, 0, 0])
    assert rc == 0
    back = jni_backend.REGISTRY.get(res.handles[0])
    assert back.columns[0].to_pylist() == list(range(8))
    assert back.columns[1].to_pylist() == [3 * i for i in range(8)]


def test_unknown_op_reports_error(backend):
    rc, res = _call(backend, "no.such_op", [])
    assert rc == 1
    assert b"unknown op" in _text(res.error)


def test_regex_rlike_through_c_dispatch(backend):
    col = Column.from_pylist(["id=12;", "nope", None], STRING, device="cpu")
    h = jni_backend.REGISTRY.put(col)
    rc, res = _call(backend, "regex.rlike", [h] + _pack(r"id=\d+;"))
    assert rc == 0
    assert jni_backend.REGISTRY.get(res.handles[0]).to_pylist() == [True, False, None]


def test_regex_extract_through_c_dispatch(backend):
    col = Column.from_pylist(["id=12;", "x"], STRING, device="cpu")
    h = jni_backend.REGISTRY.put(col)
    rc, res = _call(backend, "regex.extract", [h, 1] + _pack(r"id=(\d+);"))
    assert rc == 0
    assert jni_backend.REGISTRY.get(res.handles[0]).to_pylist() == ["12", ""]


def test_handle_release(backend):
    h = jni_backend.REGISTRY.put(Column.from_pylist(["1"], STRING, device="cpu"))
    n0 = len(jni_backend.REGISTRY)
    rc, _ = _call(backend, "handle.release", [h])
    assert rc == 0
    assert len(jni_backend.REGISTRY) == n0 - 1


# -- the library and the table


def test_ops_table_matches_jax():
    assert set(jni_backend._OPS) == set(jjb._OPS)
    assert len(jni_backend._OPS) == 41


def test_library_is_built_from_native_without_pjrt(lib):
    srcs = _build.sources("sprt_jni")
    names = [os.path.basename(s) for s in srcs]
    assert "pjrt_backend.cpp" not in names and "pjrt_executor.cpp" not in names
    assert sum(n.endswith("Jni.cpp") for n in names) == 10
    assert "native_backend.cpp" in names
    assert os.path.exists(_build.library_path("sprt_jni"))
    # the PJRT bootstrap's symbol is the port's native backend
    # (native_backend.cpp, which replaced pjrt_absent.cpp): given a NULL
    # kernel plugin it fails and registers nothing, so run_op reaches Python
    assert lib.sprt_pjrt_backend_init(None, None, None) != 0
    assert not lib.sprt_get_accel_backend()


def test_register_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jni_backend.register()


def test_bootstrap_source_registers_through_embed_python(lib, backend):
    n0 = len(jni_backend._KEEPALIVE)
    src = jni_backend.bootstrap_source(device="cpu")
    assert "spark_rapids_jni_tpu_torch.runtime.jni_backend" in src
    assert "spark_rapids_jni_tpu." not in src
    # the interpreter is running: the library finds it and runs the
    # script under the GIL, which registers the backend again
    assert lib.sprt_embed_python(None, src.encode()) == 0
    assert len(jni_backend._KEEPALIVE) == n0 + 2
    rc, res = _call(lib.sprt_get_backend(), "test.make_long_column", [2, 5, 6])
    assert rc == 0
    assert jni_backend.REGISTRY.get(res.handles[0]).to_pylist() == [5, 6]


# -- every op family against the JAX package's handlers

SCALAR_OPS = jni_backend.SCALAR_OPS


class Side:
    """One package's dispatch: records every (op, outcome) of a
    scenario. An outcome is ("ok", results) or ("err", message); the
    results of an op that returns handles are the objects they named
    when the op returned."""

    def __init__(self, call, registry):
        self.call = call
        self.registry = registry
        self.log = []

    def __call__(self, op, *args, compare=True):
        try:
            got = self.call(op, [int(a) for a in args])
            objs = got if op in SCALAR_OPS else [self.registry.get(h) for h in got]
            out = ("ok", objs)
        except Exception as e:  # noqa: BLE001 — the error is the outcome
            got, out = None, ("err", str(e))
        self.log.append((op, out, compare))
        return got


def _jax_side():
    return Side(lambda op, args: list(jjb._OPS[op](args)), jjb.REGISTRY)


def _port_side(backend):
    def call(op, args):
        rc, res = _call(backend, op, args)
        if rc != 0:
            raise RuntimeError(_text(res.error).decode())
        return [res.handles[i] for i in range(res.n_handles)]

    return Side(call, jni_backend.REGISTRY)


def _list_buffers(col):
    kv = col.child.children
    out = {"offsets": col.offsets, "validity": col.validity}
    for name, c in zip(("key", "value"), kv):
        out.update({f"{name} data": c.data, f"{name} offsets": c.offsets,
                    f"{name} validity": c.validity})
    return {k: None if v is None else np.asarray(v) for k, v in out.items()}


def assert_same_lists(jcol, pcol):
    want, got = _list_buffers(jcol), _list_buffers(pcol)
    for k, w in want.items():
        if w is None or got[k] is None:
            assert w is None and got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _same_object(j, p):
    if isinstance(p, Table):
        assert_same_table(j, p)
    elif isinstance(p, ListColumn):
        assert_same_lists(j, p)
    else:
        assert_same_table(JTable([j]), Table([p]))


def _assert_same_runs(js, ps):
    assert len(js.log) == len(ps.log)
    for (op, jo, cmp), (_, po, _) in zip(js.log, ps.log):
        assert jo[0] == po[0], (op, jo, po)
        if not cmp:
            continue
        if jo[0] == "err" or op in SCALAR_OPS:
            assert jo[1] == po[1], op
            continue
        assert len(jo[1]) == len(po[1]), op
        if op.startswith("row_conversion.to_rows"):
            # JCUDF row batches: the same bytes and row offsets
            assert_same_batches(jo[1], po[1])
            continue
        for j, p in zip(jo[1], po[1]):
            _same_object(j, p)


def _strings(side, values):
    args = [len(values)]
    for v in values:
        args += _pack(v)
    return side("test.make_string_column", *args)[0]


def _longs(side, vals, valid):
    return side("test.make_long_column", len(vals), *vals, *valid)[0]


def _ints(side, vals, valid, type_id=3):
    return side("test.make_int_column", len(vals), type_id, *vals, *valid)[0]


def _decimals(side, rng, n, scale):
    lo = rng.integers(-(10**15), 10**15, n)
    hi = np.where(lo < 0, -1, 0)
    valid = rng.random(n) > 0.2
    return side("test.make_decimal_column", n, scale, *lo, *hi, *valid)[0]


def _cast_scenario(side, rng):
    words = ["12", " -34 ", "7.25", "1e3", "-0", "bad", "", "99999999999", "3.5e-2",
             "+17", "NaN", "inf", "0x1F", " 42"]
    vals = [None if rng.random() < 0.1 else words[i] for i in rng.integers(0, len(words), 48)]
    h = _strings(side, vals)
    for type_id in (1, 2, 3, 4):
        side("cast.to_integer", h, 0, 1, type_id)
    side("cast.to_integer", h, 0, 0, 4)
    side("cast.to_integer", h, 1, 1, 4)  # ANSI: the first bad row's error
    side("cast.to_decimal", h, 0, 1, 9, 2)
    side("cast.to_decimal", h, 0, 1, 38, 4)
    side("cast.to_float", h, 0, 10)
    side("cast.to_float", h, 0, 9)


def _decimal_scenario(side, rng):
    a = _decimals(side, rng, 40, 2)
    b = _decimals(side, rng, 40, 3)
    side("decimal.multiply128", a, b, 4)
    side("decimal.add128", a, b, 3)
    side("decimal.subtract128", a, b, 2)
    side("decimal.divide128", a, b, 5, 0)
    side("decimal.divide128", a, b, 0, 1)


def _row_scenario(side, rng):
    n = 24
    valid = rng.random(n) > 0.25
    a = _longs(side, rng.integers(-(10**12), 10**12, n), valid)
    b = _ints(side, rng.integers(-1000, 1000, n), rng.random(n) > 0.1)
    c = _decimals(side, rng, n, 2)
    t = side("test.make_table", a, b, c)[0]
    for to_op, from_op in (("row_conversion.to_rows", "row_conversion.from_rows"),
                           ("row_conversion.to_rows_fixed_width",
                            "row_conversion.from_rows_fixed_width")):
        rows = side(to_op, t)[0]
        side(from_op, rows, 4, 3, 27, 0, 0, 2)


def _zorder_scenario(side, rng):
    cols = [_ints(side, rng.integers(-(2**31), 2**31 - 1, 32), rng.random(32) > 0.2)
            for _ in range(3)]
    side("zorder.interleave_bits", *cols)
    side("zorder.interleave_bits_empty", 5)
    side("zorder.hilbert_index", 10, *cols[:2])
    side("zorder.hilbert_index", 21, *cols)
    side("zorder.hilbert_index", 4)


def _map_scenario(side, rng):
    docs = []
    for i in range(32):
        kv = ", ".join(f'"k{int(rng.integers(0, 9))}": {int(rng.integers(-99, 99))}'
                       for _ in range(int(rng.integers(0, 4))))
        docs.append(None if i % 11 == 5 else "{" + kv + "}")
    side("map_utils.from_json", _strings(side, docs))
    side("map_utils.from_json", _strings(side, ['{"a": 1}', '{"b": ']))


def _regex_scenario(side, rng):
    subj = [None if rng.random() < 0.1 else
            f"id={int(rng.integers(0, 999))};" if rng.random() < 0.6 else "no id here"
            for _ in range(40)]
    h = _strings(side, subj)
    side("regex.rlike", h, *_pack(r"id=\d+;"))
    side("regex.rlike", h, *_pack(r"^no"))
    side("regex.extract", h, 1, *_pack(r"id=(\d+);"))
    side("regex.extract", h, 0, *_pack(r"[a-z]+"))


def _rmm_scenario(side, rng):
    tid = 7001
    side("rmm.start_task", tid)
    side("rmm.force_retry_oom", tid, 2, 1)
    side("rmm.get_and_reset_num_retry", tid)
    for which in (0, 1, 2):
        side("rmm.metric", tid, which)
    side("rmm.metric", tid, 3, compare=False)  # the task's wall time
    side("rmm.metric", tid, 9)
    side("rmm.task_done", tid)
    side("rmm.metric", 424242, 0)


def _profiler_scenario(side, rng, tmp):
    side("profiler.disable")
    side("profiler.enable")
    side("profiler.reset")
    side("profiler.counter", *_pack("no.such.counter"))
    side("profiler.op_count", *_pack("CastStrings.toInteger"))
    side("profiler.op_time_ms", *_pack("CastStrings.toInteger"))
    side("profiler.event_count")
    side("profiler.dump", *_pack(str(tmp)), compare=False)
    side("profiler.reset")
    side("profiler.disable")


def _test_support_scenario(side, rng):
    s = _strings(side, ["alpha", None, "", "a longer string of several words", "é"])
    n = _longs(side, [5, -6, 7], [1, 0, 1])
    i8 = _ints(side, [1, -2, 3], [], type_id=1)
    d = _decimals(side, rng, 3, 1)
    t = side("test.make_table", n, i8, d)[0]
    side("test.table_column", t, 2)
    side("test.row_count", s)
    for row in range(5):
        side("test.is_null_at", s, row)
        side("test.get_string_at", s, row)
    side("test.get_long_at", n, 0)
    side("test.get_long_at", n, 2)
    side("handle.release", s)


SCENARIOS = {
    "cast": _cast_scenario, "decimal": _decimal_scenario, "row_conversion": _row_scenario,
    "zorder": _zorder_scenario, "map_utils": _map_scenario, "regex": _regex_scenario,
    "rmm": _rmm_scenario, "profiler": _profiler_scenario,
    "test_support": _test_support_scenario,
}


@pytest.fixture
def profiler_state():
    from spark_rapids_jni_tpu.runtime import metrics as jmetrics

    prev = (jmetrics.configure("off"), metrics.configure("off"))
    yield
    jmetrics.configure(prev[0])
    metrics.configure(prev[1])


@pytest.mark.parametrize("family", sorted(SCENARIOS))
def test_handlers_match_jax(family, backend, profiler_state, tmp_path):
    sides = {"jax": _jax_side(), "port": _port_side(backend)}
    for name, side in sides.items():
        rng = np.random.default_rng(2024)
        if family == "profiler":
            _profiler_scenario(side, rng, tmp_path / f"{name}.jsonl")
        else:
            SCENARIOS[family](side, rng)
    covered = {op for op, _, _ in sides["port"].log}
    assert all(op in jni_backend._OPS for op in covered)
    _assert_same_runs(sides["jax"], sides["port"])
