"""Python-side backend for the JNI dispatch table (the port's copy of
the JAX package's ``runtime/jni_backend.py``).

Registers a ctypes callback into the port's JNI library ``sprt_jni``
(``kernels/_build.py``: ``native/jni/`` built by the host compiler,
without its PJRT half) through ``sprt_register_backend``, so the JNI
layer's generic ``call(op, args[])`` dispatch routes into the port's
ops. Handles are indices into a process-local registry of
Columns/Tables, mirroring cudf-java's native-handle ownership
(reference: src/main/java/.../CastStrings.java:95-99 pass raw longs).
The ``_OPS`` table has the JAX package's op names, one for one.

Ops run on the device of the columns they are handed; the ``test.*``
column factories put their columns on the device ``register`` was
given (``"cuda"`` unless the caller asks for the CPU).
``bootstrap_source`` is the script ``sprt_embed_python``
(``native/jni/embed_python.cpp``) runs to register this backend from a
host that starts without Python.

``init_native`` registers the library's other backend, the native one
(``kernels/csrc/host/native_backend.cpp``), which ``run_op`` tries
first: its ops run the hand-written kernels of a plugin it dlopens, with
no Python in the call, and what it declines falls through to this
backend. ``native_column`` copies a native handle's buffers into a port
Column, for tests and checks.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..columnar.column import Column, resolve_device
from ..columnar.table import Table

_MAX_HANDLES = 8


class SprtCallResult(ctypes.Structure):
    _fields_ = [
        ("handles", ctypes.c_long * _MAX_HANDLES),
        ("n_handles", ctypes.c_int),
        ("error", ctypes.c_char_p),
        ("error_row", ctypes.c_int),
        ("error_str", ctypes.c_char_p),
    ]


_CALL_TYPE = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_long),
    ctypes.c_int,
    ctypes.POINTER(SprtCallResult),
)


class SprtBackend(ctypes.Structure):
    _fields_ = [("call", _CALL_TYPE)]


class HandleRegistry:
    """Process-local object registry: handle (int) <-> Column/Table."""

    def __init__(self):
        self._objects: Dict[int, object] = {}
        self._next = itertools.count(1)
        self._lock = threading.Lock()

    def put(self, obj) -> int:
        with self._lock:
            h = next(self._next)
            self._objects[h] = obj
            return h

    def get(self, handle: int):
        return self._objects[int(handle)]

    def release(self, handle: int) -> None:
        with self._lock:
            self._objects.pop(int(handle), None)

    def __len__(self):
        return len(self._objects)


REGISTRY = HandleRegistry()

# cudf DType native ids used on the JNI wire (reference CastStrings.java
# passes DType.getTypeId().getNativeId()); subset we dispatch on.
# sprtcheck: guarded-by=frozen
_CUDF_TYPE_IDS = {
    1: "INT8",
    2: "INT16",
    3: "INT32",
    4: "INT64",
    9: "FLOAT32",
    10: "FLOAT64",
}


def _dtype_from_id(type_id: int, scale: int = 0):
    from ..columnar import dtypes as dt

    name = _CUDF_TYPE_IDS.get(int(type_id))
    if name:
        return getattr(dt, name)
    # decimal ids in cudf's type_id enum: DECIMAL32=25, DECIMAL64=26,
    # DECIMAL128=27 (STRING=23, LIST=24)
    if type_id == 25:
        return dt.DECIMAL32(9, -scale)
    if type_id == 26:
        return dt.DECIMAL64(18, -scale)
    if type_id == 27:
        return dt.DECIMAL128(38, -scale)
    raise ValueError(f"unsupported cudf type id {type_id}")


def _op_cast_to_integer(args):
    from ..ops import cast_string

    col = REGISTRY.get(args[0])
    out = cast_string.string_to_integer(
        col,
        _dtype_from_id(args[3]),
        ansi_mode=bool(args[1]),
        strip=bool(args[2]),
    )
    return [REGISTRY.put(out)]


def _op_cast_to_decimal(args):
    from ..ops import cast_string

    col = REGISTRY.get(args[0])
    out = cast_string.string_to_decimal(
        col,
        int(args[3]),
        int(args[4]),
        ansi_mode=bool(args[1]),
        strip=bool(args[2]),
    )
    return [REGISTRY.put(out)]


def _op_cast_to_float(args):
    from ..ops import cast_string

    col = REGISTRY.get(args[0])
    out = cast_string.string_to_float(
        col, _dtype_from_id(args[2]), ansi_mode=bool(args[1])
    )
    return [REGISTRY.put(out)]


def _op_decimal_multiply128(args):
    from ..ops import decimal

    a, b = REGISTRY.get(args[0]), REGISTRY.get(args[1])
    out = decimal.multiply128(a, b, int(args[2]))
    return [REGISTRY.put(c) for c in out.columns]


def _op_decimal_divide128(args):
    from ..ops import decimal

    a, b = REGISTRY.get(args[0]), REGISTRY.get(args[1])
    # args[3]: isIntegerDivide (DecimalUtils.java integerDivide128
    # dispatches through the same binding with quotient scale 0)
    if int(args[3]):
        out = decimal.integer_divide128(a, b)
    else:
        out = decimal.divide128(a, b, int(args[2]))
    return [REGISTRY.put(c) for c in out.columns]


def _op_decimal_add128(args):
    from ..ops import decimal

    a, b = REGISTRY.get(args[0]), REGISTRY.get(args[1])
    out = decimal.add128(a, b, int(args[2]))
    return [REGISTRY.put(c) for c in out.columns]


def _op_decimal_subtract128(args):
    from ..ops import decimal

    a, b = REGISTRY.get(args[0]), REGISTRY.get(args[1])
    out = decimal.subtract128(a, b, int(args[2]))
    return [REGISTRY.put(c) for c in out.columns]


def _op_to_rows(args):
    from ..ops import row_conversion

    tbl = REGISTRY.get(args[0])
    return [REGISTRY.put(c) for c in row_conversion.convert_to_rows(tbl)]


def _op_from_rows(args):
    from ..ops import row_conversion

    col = REGISTRY.get(args[0])
    n = (len(args) - 1) // 2
    schema = [
        _dtype_from_id(args[1 + i], args[1 + n + i]) for i in range(n)
    ]
    out = row_conversion.convert_from_rows([col], schema)
    return [REGISTRY.put(out)]


def _op_interleave_bits(args):
    from ..ops import zorder

    cols = [REGISTRY.get(h) for h in args]
    return [REGISTRY.put(zorder.interleave_bits(Table(cols)))]


def _op_interleave_bits_empty(args):
    from ..ops import zorder

    return [REGISTRY.put(zorder.interleave_bits(Table([]), int(args[0]), device=_device))]


def _op_hilbert_index(args):
    from ..ops import zorder

    cols = [REGISTRY.get(h) for h in args[1:]]
    return [REGISTRY.put(zorder.hilbert_index(int(args[0]), Table(cols), device=_device))]


def _op_from_json(args):
    from ..ops import map_utils

    col = REGISTRY.get(args[0])
    return [REGISTRY.put(map_utils.from_json(col))]


def _unpack_string(args, start):
    """Decode a string packed into int64 args: args[start] = byte
    length, args[start+1:] = UTF-8 bytes packed 8 per int64,
    little-endian (the JNI side packs with the same layout —
    native/jni/RegexJni.cpp)."""
    nbytes = int(args[start])
    words = args[start + 1 : start + 1 + (nbytes + 7) // 8]
    raw = b"".join(
        int(w & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little") for w in words
    )
    return raw[:nbytes].decode("utf-8")


def pack_string(s):
    """The inverse of ``_unpack_string``: [byte length, UTF-8 bytes 8
    per int64, little-endian, signed as the ABI's int64 slots carry
    them]; ``None`` packs as [-1]. ``s`` is a str or its bytes."""
    if s is None:
        return [-1]
    raw = s.encode("utf-8") if isinstance(s, str) else s
    out = [len(raw)]
    for off in range(0, len(raw), 8):
        out.append(int.from_bytes(raw[off : off + 8].ljust(8, b"\0"), "little", signed=True))
    return out


def _op_rlike(args):
    from ..ops import regex

    col = REGISTRY.get(args[0])
    pattern = _unpack_string(args, 1)
    return [REGISTRY.put(regex.rlike(col, pattern))]


def _op_regexp_extract(args):
    from ..ops import regex

    col = REGISTRY.get(args[0])
    idx = int(args[1])
    pattern = _unpack_string(args, 2)
    return [REGISTRY.put(regex.regexp_extract(col, pattern, idx))]


def _op_release(args):
    REGISTRY.release(args[0])
    return []


# --- resource manager ops (RmmSparkJni.cpp): the task-scoped adaptive
# retry manager's control surface, addressed by Spark task id. Scalar
# results ride handles[0] like the test accessors.


def _op_rmm_start_task(args):
    from . import resource

    resource.start_task(int(args[0]))
    return []


def _op_rmm_task_done(args):
    from . import resource

    resource.task_done(int(args[0]))
    return []


def _op_rmm_force_retry_oom(args):
    from . import resource

    resource.force_retry_oom(
        num_ooms=int(args[1]), skip_count=int(args[2]), task_id=int(args[0])
    )
    return []


def _op_rmm_get_and_reset_num_retry(args):
    from . import resource

    return [resource.get_and_reset_num_retry(int(args[0]))]


def _op_rmm_metric(args):
    from . import resource

    m = resource.metrics(int(args[0]))
    if m is None:
        raise KeyError(f"unknown task id {int(args[0])}")
    which = int(args[1])
    if which == 0:
        return [m.retries]
    if which == 1:
        return [m.injected_ooms]
    if which == 2:
        return [m.peak_bytes]
    if which == 3:
        return [int(m.wall_ms)]
    raise ValueError(f"unknown rmm metric id {which}")


# --- profiler ops (ProfilerJni.cpp): the process-wide telemetry
# registry's control surface (runtime/metrics.py + runtime/events.py),
# mirroring how RmmSparkJni fronts the resource manager. String args
# (metric names, dump paths) cross the int64 dispatch with the packed
# layout of RegexJni.cpp; scalar results ride handles[0].


# mode the profiler disabled away from, so enable() restores an armed
# file sink instead of downgrading it to mem
_profiler_prev_mode = None


def _op_profiler_enable(args):
    global _profiler_prev_mode
    from . import metrics

    # only upgrade when off: enable() on an already-recording process
    # (e.g. an armed SPARK_JNI_TPU_METRICS file sink) must not close
    # and replace the active sink. After disable(), restore whatever
    # sink was active before it.
    if not metrics.enabled():
        metrics.configure(_profiler_prev_mode or "mem")
        _profiler_prev_mode = None
    return []


def _op_profiler_disable(args):
    global _profiler_prev_mode
    from . import metrics

    prev = metrics.configure("off")
    if prev != "off":
        _profiler_prev_mode = prev
    return []


def _op_profiler_counter(args):
    from . import metrics

    return [int(metrics.counter_value(_unpack_string(args, 0)))]


def _op_profiler_op_count(args):
    from . import metrics

    st = metrics.timer_stats(f"op.{_unpack_string(args, 0)}")
    return [0 if st is None else int(st["count"])]


def _op_profiler_op_time_ms(args):
    from . import metrics

    st = metrics.timer_stats(f"op.{_unpack_string(args, 0)}")
    return [0 if st is None else int(round(st["sum_ms"]))]


def _op_profiler_event_count(args):
    from . import events

    return [len(events.events())]


def _op_profiler_dump(args):
    from . import metrics

    return [metrics.dump_jsonl(_unpack_string(args, 0))]


def _op_profiler_reset(args):
    from . import events, metrics

    metrics.reset()
    events.clear()
    return []


# --- test-support ops (TestSupportJni.cpp): column factories and
# accessors the JVM smoke test uses in place of cudf-java's column
# factories (reference tests build inputs with ColumnVector.fromStrings)


def _op_test_make_string_column(args):
    from ..columnar.dtypes import STRING

    n = int(args[0])
    vals = []
    i = 1
    for _ in range(n):
        ln = int(args[i])
        if ln < 0:
            vals.append(None)
            i += 1
        else:
            vals.append(_unpack_string(args, i))
            i += 1 + (ln + 7) // 8
    return [REGISTRY.put(Column.from_pylist(vals, STRING, device=_device))]


def _op_test_make_long_column(args):
    from ..columnar.dtypes import INT64

    n = int(args[0])
    vals = [int(a) for a in args[1 : 1 + n]]
    valid = args[1 + n : 1 + 2 * n]
    if len(valid) == n:
        vals = [v if bool(f) else None for v, f in zip(vals, valid)]
    return [REGISTRY.put(Column.from_pylist(vals, INT64, device=_device))]


def _op_test_make_decimal_column(args):
    from ..columnar.dtypes import DECIMAL128

    n = int(args[0])
    scale = int(args[1])
    lo = torch.tensor([int(a) for a in args[2 : 2 + n]], dtype=torch.int64)
    hi = torch.tensor([int(a) for a in args[2 + n : 2 + 2 * n]], dtype=torch.int64)
    dev = resolve_device(_device)
    valid = None
    if len(args) >= 2 + 3 * n:
        valid = torch.from_numpy(
            np.array([bool(a) for a in args[2 + 2 * n : 2 + 3 * n]], np.bool_)
        ).to(dev)
    return [
        REGISTRY.put(
            Column(DECIMAL128(38, scale), torch.stack([lo, hi], dim=-1).to(dev), valid)
        )
    ]


def _op_test_make_int_column(args):
    from ..columnar import dtypes as dt

    n = int(args[0])
    dtype = {1: dt.INT8, 3: dt.INT32}[int(args[1])]
    vals = [int(a) for a in args[2 : 2 + n]]
    valid = args[2 + n : 2 + 2 * n]
    if len(valid) == n:
        vals = [v if bool(f) else None for v, f in zip(vals, valid)]
    return [REGISTRY.put(Column.from_pylist(vals, dtype, device=_device))]


def _op_test_table_column(args):
    tbl = REGISTRY.get(args[0])
    return [REGISTRY.put(tbl.columns[int(args[1])])]


def _op_test_make_table(args):
    return [REGISTRY.put(Table([REGISTRY.get(h) for h in args]))]


def _op_test_row_count(args):
    return [len(REGISTRY.get(args[0]))]


def _op_test_is_null_at(args):
    col = REGISTRY.get(args[0])
    return [0 if col.to_pylist()[int(args[1])] is not None else 1]


def _op_test_get_long_at(args):
    col = REGISTRY.get(args[0])
    return [int(col.to_pylist()[int(args[1])])]


def _op_test_get_string_at(args):
    col = REGISTRY.get(args[0])
    v = col.to_pylist()[int(args[1])]
    # dispatch ABI: 7 words of payload
    return pack_string(None if v is None else v.encode("utf-8")[:56])


# ops whose result slots carry values, not handles
# sprtcheck: guarded-by=frozen
SCALAR_OPS = frozenset({
    "rmm.get_and_reset_num_retry", "rmm.metric", "profiler.counter", "profiler.op_count",
    "profiler.op_time_ms", "profiler.event_count", "profiler.dump", "test.row_count",
    "test.is_null_at", "test.get_long_at", "test.get_string_at",
})

# sprtcheck: guarded-by=frozen
_OPS = {
    "cast.to_integer": _op_cast_to_integer,
    "cast.to_decimal": _op_cast_to_decimal,
    "cast.to_float": _op_cast_to_float,
    "decimal.multiply128": _op_decimal_multiply128,
    "decimal.divide128": _op_decimal_divide128,
    "decimal.add128": _op_decimal_add128,
    "decimal.subtract128": _op_decimal_subtract128,
    "row_conversion.to_rows": _op_to_rows,
    "row_conversion.to_rows_fixed_width": _op_to_rows,
    "row_conversion.from_rows": _op_from_rows,
    "row_conversion.from_rows_fixed_width": _op_from_rows,
    "zorder.interleave_bits": _op_interleave_bits,
    "zorder.interleave_bits_empty": _op_interleave_bits_empty,
    "zorder.hilbert_index": _op_hilbert_index,
    "map_utils.from_json": _op_from_json,
    "regex.rlike": _op_rlike,
    "regex.extract": _op_regexp_extract,
    "handle.release": _op_release,
    "rmm.start_task": _op_rmm_start_task,
    "rmm.task_done": _op_rmm_task_done,
    "rmm.force_retry_oom": _op_rmm_force_retry_oom,
    "rmm.get_and_reset_num_retry": _op_rmm_get_and_reset_num_retry,
    "rmm.metric": _op_rmm_metric,
    "profiler.enable": _op_profiler_enable,
    "profiler.disable": _op_profiler_disable,
    "profiler.counter": _op_profiler_counter,
    "profiler.op_count": _op_profiler_op_count,
    "profiler.op_time_ms": _op_profiler_op_time_ms,
    "profiler.event_count": _op_profiler_event_count,
    "profiler.dump": _op_profiler_dump,
    "profiler.reset": _op_profiler_reset,
    "test.make_string_column": _op_test_make_string_column,
    "test.make_long_column": _op_test_make_long_column,
    "test.make_table": _op_test_make_table,
    "test.make_decimal_column": _op_test_make_decimal_column,
    "test.make_int_column": _op_test_make_int_column,
    "test.table_column": _op_test_table_column,
    "test.row_count": _op_test_row_count,
    "test.is_null_at": _op_test_is_null_at,
    "test.get_long_at": _op_test_get_long_at,
    "test.get_string_at": _op_test_get_string_at,
}

# keep ctypes objects alive for the lifetime of the registration;
# register() can be driven from several executor threads (the JVM
# facade dlopens per session), and two unlocked extends can lose one
# list's callback to a GC'd ctypes trampoline — a segfault in C
_register_lock = threading.Lock()
# sprtcheck: guarded-by=_register_lock
_KEEPALIVE = []
# where the test.* factories put their columns (set by register)
_device = "cuda"
# malloc'd error strings handed to C must outlive the call; the C side
# frees them — allocate with libc malloc+strcpy
_libc = ctypes.CDLL(None)
_libc.malloc.restype = ctypes.c_void_p
_libc.malloc.argtypes = [ctypes.c_size_t]


def _c_strdup(s: str) -> int:
    b = s.encode("utf-8", "replace")
    p = _libc.malloc(len(b) + 1)
    ctypes.memmove(p, b, len(b))
    ctypes.memset(p + len(b), 0, 1)
    return p


def _call(name, args_ptr, n_args, result):
    try:
        op = name.decode()
        args = [args_ptr[i] for i in range(n_args)]
        r = result.contents
        r.n_handles = 0
        r.error = None
        r.error_row = -1
        r.error_str = None
        fn = _OPS.get(op)
        if fn is None:
            ctypes.cast(
                ctypes.addressof(r) + SprtCallResult.error.offset,
                ctypes.POINTER(ctypes.c_void_p),
            )[0] = _c_strdup(f"unknown op {op}")
            return 1
        handles = fn(args)
        for i, h in enumerate(handles[:_MAX_HANDLES]):
            r.handles[i] = h
        r.n_handles = len(handles)
        return 0
    except Exception as e:  # noqa: BLE001 — must not unwind into C
        from .errors import CastException

        r = result.contents
        if isinstance(e, CastException):
            r.error_row = e.row_with_error
            ctypes.cast(
                ctypes.addressof(r) + SprtCallResult.error_str.offset,
                ctypes.POINTER(ctypes.c_void_p),
            )[0] = _c_strdup(e.string_with_error)
        ctypes.cast(
            ctypes.addressof(r) + SprtCallResult.error.offset,
            ctypes.POINTER(ctypes.c_void_p),
        )[0] = _c_strdup(str(e))
        return 1


def register(lib_path: Optional[str] = None, device="cuda") -> ctypes.CDLL:
    """dlopen the JNI library and register this Python backend into its
    dispatch table. The library is the port's own ``sprt_jni`` build
    (``kernels/_build.load``) unless ``lib_path`` names another;
    ``device`` is where the ``test.*`` factories put their columns.
    Returns the loaded library (exposes ``sprt_get_backend`` for
    tests)."""
    global _device

    resolve_device(device)  # no card: raise here, not in a factory
    if lib_path is None:
        from ..kernels import _build

        lib = _build.load("sprt_jni")
    else:
        lib = ctypes.CDLL(lib_path)
    cb = _CALL_TYPE(_call)
    backend = SprtBackend(call=cb)
    with _register_lock:
        _KEEPALIVE.extend([cb, backend])
        _device = str(device)
    lib.sprt_register_backend(ctypes.byref(backend))
    return lib


def bootstrap_source(lib_path: Optional[str] = None, device="cuda") -> str:
    """The Python text ``sprt_embed_python(libpython, bootstrap)``
    (``native/jni/embed_python.cpp``) runs to register this backend:
    it puts the port's checkout on ``sys.path`` and calls
    ``register(lib_path, device)``. ``lib_path`` is the library the
    host loaded (None: the port's ``sprt_jni`` build)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return (
        "import sys\n"
        f"if {root!r} not in sys.path:\n"
        f"    sys.path.insert(0, {root!r})\n"
        "import spark_rapids_jni_tpu_torch.runtime.jni_backend as _b\n"
        f"_b.register({lib_path!r}, device={str(device)!r})\n"
    )


# ---- the native backend (kernels/csrc/host/native_backend.cpp)

# the native column store's kinds: cudf type ids, then its own
_NATIVE_ROWS, _NATIVE_TABLE = 100, 101


def init_native(device="cuda") -> ctypes.CDLL:
    """What ``TestSupport.initPjrtBackend`` does from Java: build the
    kernel plugin for ``device`` (the CUDA plugin on a card; the host
    plugin only for ``device="cpu"``) and call the JNI library's
    ``sprt_pjrt_backend_init(plugin, "", "device=i:<ordinal>")``, which
    registers the native backend as the accelerated one in the port's
    ``sprt_jni``. Raises without a card unless the CPU is asked for.
    Returns the library."""
    from ..kernels import _build, native

    dev = resolve_device(device)
    plugin = native.plugin_path(dev)
    lib = _build.load("sprt_jni")
    lib.sprt_pjrt_backend_init.argtypes = [ctypes.c_char_p] * 3
    options = f"device=i:{dev.index or 0}".encode()
    rc = lib.sprt_pjrt_backend_init(plugin.encode(), b"", options)
    if rc != 0:
        raise RuntimeError(f"sprt_pjrt_backend_init({plugin!r}) returned {rc}")
    _set_native_signatures(lib)
    return lib


def uninit_native() -> None:
    """Register NULL as the accelerated backend of the port's
    ``sprt_jni``: every op goes to the default backend again. Native
    handles stay valid and releasable once the backend is registered
    again."""
    from ..kernels import _build

    lib = _build.load("sprt_jni")
    lib.sprt_register_accel_backend.argtypes = [ctypes.c_void_p]
    lib.sprt_register_accel_backend(None)


def _set_native_signatures(lib) -> None:
    lib.sprt_native_column.argtypes = [ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.sprt_native_copy_out.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
    lib.sprt_native_live_bytes.restype = ctypes.c_long
    lib.sprt_native_launches.restype = ctypes.c_long
    lib.sprt_native_launches.argtypes = [ctypes.c_int]
    lib.sprt_native_reset_launches.argtypes = []


def native_counts(lib) -> dict:
    """The active plugin's launches by kernel family and its live bytes."""
    from ..kernels import native

    _set_native_signatures(lib)
    out = {name: int(lib.sprt_native_launches(i)) for name, i in native.FAMILIES.items()}
    out["live_bytes"] = int(lib.sprt_native_live_bytes())
    return out


# sprtcheck: host-side — copies a native handle's buffers out for a check, after the op
def native_column(lib, handle: int, device="cuda") -> Column:
    """A copy of the native handle's column as a port Column on
    ``device``: its values, validity (None when the backend holds no
    mask) and offsets; packed rows come back as a BINARY column with
    their row offsets."""
    from ..columnar import dtypes as dt

    _set_native_signatures(lib)
    info = (ctypes.c_long * 8)()
    if lib.sprt_native_column(handle, info) != 0:
        raise KeyError(f"the native backend holds no handle {handle}")
    kind, scale, rows, row_size, nbytes, has_valid, has_offsets, _children = info
    if kind == _NATIVE_TABLE:
        raise TypeError("a native table handle: read its columns (test.table_column)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()  # the blocks are free on every stream

    def part(i, count, dtype):
        t = torch.empty(count, dtype=dtype, device=dev)
        rc = lib.sprt_native_copy_out(handle, i, t.data_ptr())
        if rc != 0:
            raise RuntimeError(f"sprt_native_copy_out({handle}, {i}) returned {rc}")
        return t

    validity = part(1, rows, torch.uint8).view(torch.bool) if has_valid else None
    if kind == 23 and has_offsets:
        return Column(dt.STRING, part(0, nbytes, torch.uint8), validity,
                      part(2, rows + 1, torch.int32))
    if kind == _NATIVE_ROWS:
        offsets = torch.arange(rows + 1, dtype=torch.int32, device=dev) * row_size
        return Column(dt.BINARY, part(0, nbytes, torch.uint8), None, offsets)
    if kind == 27:
        return Column(dt.DECIMAL128(38, scale), part(0, 2 * rows, torch.int64).view(rows, 2),
                      validity)
    dtype = {
        1: dt.INT8, 2: dt.INT16, 3: dt.INT32, 4: dt.INT64, 8: dt.BOOL8, 9: dt.FLOAT32,
        10: dt.FLOAT64, 25: dt.DECIMAL32(9, scale), 26: dt.DECIMAL64(18, scale),
    }[kind]
    return Column(dtype, part(0, rows, dtype.torch_dtype), validity)


def pack_string_rows(data: np.ndarray, offsets: np.ndarray, validity=None) -> np.ndarray:
    """``test.make_string_column``'s arguments for a whole column at once
    (the per-string layout of ``pack_string``, a null as [-1]): int64
    [n, then each row's length and words]."""
    data = np.asarray(data, np.uint8)
    offsets = np.asarray(offsets, np.int64)
    n = len(offsets) - 1
    lens = np.diff(offsets)
    if validity is not None:
        lens = np.where(validity, lens, -1)
    words = np.where(lens > 0, (lens + 7) // 8, 0)
    slot = 1 + np.concatenate([[0], np.cumsum(1 + words)[:-1]]).astype(np.int64)
    out = np.zeros(1 + int((1 + words).sum()), np.int64)
    out[0] = n
    out[slot] = lens
    live = lens > 0
    row = np.repeat(np.arange(n)[live], lens[live])
    pos = np.arange(len(row)) - np.repeat(np.cumsum(lens[live]) - lens[live], lens[live])
    raw = out.view(np.uint8)
    raw[8 * (slot[row] + 1) + pos] = data[offsets[row] + pos]
    return out


def call_backend(backend, op: str, args) -> tuple:
    """One call through a C ``SprtBackend`` pointer (run_op's path) with
    int64 ``args``: a list, or an int64 array passed without a copy.
    Returns (rc, handles or values, error, error_row, error_str); the C
    strings are freed here."""
    if isinstance(args, np.ndarray):
        arr = np.ascontiguousarray(args, dtype=np.int64)
        ptr, n = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(arr)
    else:
        ptr, n = (ctypes.c_long * len(args))(*[int(a) for a in args]), len(args)
    res = SprtCallResult()
    res.error_row = -1
    rc = backend.contents.call(op.encode(), ptr, n, ctypes.byref(res))
    texts = []
    for field in ("error", "error_str"):
        slot = ctypes.cast(ctypes.addressof(res) + getattr(SprtCallResult, field).offset,
                           ctypes.POINTER(ctypes.c_void_p))
        texts.append(None if not slot[0] else ctypes.string_at(slot[0]).decode("utf-8", "replace"))
        if slot[0]:
            _libc.free(ctypes.c_void_p(slot[0]))
            slot[0] = None
    return rc, [res.handles[i] for i in range(res.n_handles)], texts[0], res.error_row, texts[1]
