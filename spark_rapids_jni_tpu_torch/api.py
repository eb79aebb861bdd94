"""API façade of the port: the reference's Java class surface, one
Python class per Java class (PyTorch twin of the JAX package's
``api.py``, with its signatures). The port carries ``CastStrings``,
``DecimalUtils``, ``MapUtils``, ``JSONUtils``, ``RowConversion``,
``ZOrder``, the Parquet ingress (``ParquetFooter``, ``ParquetReader``,
``read_table``, and the streamed scan ``ScanPlan``, ``prefetch_chunks``,
``scan_chunks``), the relational extensions ``SortOrder``,
``Aggregation``, ``Filter`` and ``Join``, and ``Regex``; the fused
``Pipeline`` with ``pad_string_payloads``, and the task-scoped resource
manager ``RmmSpark`` with its terminal ``RetryOOMError``.

Every op class's entries run through ``_instrument``: the fault shim
(``runtime/faultinj.py``), an NVTX range (``runtime/trace.py``) and a
telemetry op sample with its causal span."""

from __future__ import annotations

import functools
import time
from typing import List, Optional, Sequence

from .columnar.column import Column
from .columnar.dtypes import DType
from .columnar.nested import ListColumn
from .columnar.table import Table
from .ops import aggregate as _aggregate
from .ops import cast_string as _cast_string
from .ops import decimal as _decimal
from .ops import filter as _filter
from .ops import get_json_object as _get_json_object
from .ops import join as _join
from .ops import map_utils as _map_utils
from .ops import regex as _regex
from .ops import row_conversion as _row_conversion
from .ops import sort as _sort
from .ops import zorder as _zorder
from .ops.parquet_footer import ParquetFooter  # noqa: F401
from .ops.parquet_reader import ParquetReader, read_table  # noqa: F401
from .runtime.scan import ScanPlan, prefetch_chunks, scan_chunks  # noqa: F401  (streamed scan)
from .runtime import events as _events
from .runtime import faultinj as _faultinj
from .runtime import metrics as _metrics
from .runtime import pipeline as _pipeline
from .runtime import resource as _resource
from .runtime import spans as _spans
from .runtime import trace as _trace
from .runtime.errors import RetryOOMError  # noqa: F401  (terminal retry error)


class CastStrings:
    """CastStrings.java:36-99 — Spark-exact string casts."""

    @staticmethod
    def toInteger(cv: Column, ansi_enabled: bool, strip: bool, dtype: DType) -> Column:
        return _cast_string.string_to_integer(cv, dtype, ansi_mode=ansi_enabled, strip=strip)

    @staticmethod
    def toDecimal(
        cv: Column, ansi_enabled: bool, strip: bool, precision: int, scale: int
    ) -> Column:
        return _cast_string.string_to_decimal(
            cv, precision, scale, ansi_mode=ansi_enabled, strip=strip
        )

    @staticmethod
    def toFloat(cv: Column, ansi_enabled: bool, dtype: DType) -> Column:
        return _cast_string.string_to_float(cv, dtype, ansi_mode=ansi_enabled)


class DecimalUtils:
    """DecimalUtils.java:41-137 — DECIMAL128 arithmetic returning a
    2-column table {BOOL8 overflow, DECIMAL128 result}."""

    @staticmethod
    def multiply128(a: Column, b: Column, product_scale: int) -> Table:
        return _decimal.multiply128(a, b, product_scale)

    @staticmethod
    def divide128(a: Column, b: Column, quotient_scale: int) -> Table:
        return _decimal.divide128(a, b, quotient_scale)

    @staticmethod
    def integerDivide128(a: Column, b: Column) -> Table:
        return _decimal.integer_divide128(a, b)

    @staticmethod
    def add128(a: Column, b: Column, target_scale: int) -> Table:
        return _decimal.add128(a, b, target_scale)

    @staticmethod
    def subtract128(a: Column, b: Column, target_scale: int) -> Table:
        return _decimal.subtract128(a, b, target_scale)


class MapUtils:
    """MapUtils.java:47-50 — JSON object to raw key/value map."""

    @staticmethod
    def extractRawMapFromJsonString(cv: Column) -> ListColumn:
        return _map_utils.from_json(cv)


class JSONUtils:
    """get_json_object — JSONPath extraction (ops/get_json_object.py)."""

    @staticmethod
    def getJsonObject(cv: Column, path: str) -> Column:
        return _get_json_object.get_json_object(cv, path)


class RowConversion:
    """RowConversion.java:35-173 — Table <-> JCUDF row bytes."""

    @staticmethod
    def convertToRows(table: Table) -> List[Column]:
        return _row_conversion.convert_to_rows(table)

    @staticmethod
    def convertToRowsFixedWidthOptimized(table: Table) -> List[Column]:
        return _row_conversion.convert_to_rows_fixed_width_optimized(table)

    @staticmethod
    def convertFromRows(vec: Sequence[Column], schema: Sequence[DType]) -> Table:
        return _row_conversion.convert_from_rows(vec, schema)

    @staticmethod
    def convertFromRowsFixedWidthOptimized(
        vec: Sequence[Column], schema: Sequence[DType]
    ) -> Table:
        return _row_conversion.convert_from_rows_fixed_width_optimized(vec, schema)


class ZOrder:
    """ZOrder.java:41-83 — Delta-Lake clustering indexes. With no
    columns the result is made on ``device`` (default the card);
    otherwise on the columns' device."""

    @staticmethod
    def interleaveBits(num_rows: int, *columns: Column, device="cuda") -> Column:
        return _zorder.interleave_bits(Table(list(columns)), num_rows, device=device)

    @staticmethod
    def hilbertIndex(num_bits: int, num_rows: int, *columns: Column, device="cuda") -> Column:
        return _zorder.hilbert_index(num_bits, Table(list(columns)), num_rows, device=device)


# ---- relational extensions (BASELINE.md staged configs 2-3; no Java
# counterpart in the reference — the plugin calls cudf directly) ----


class SortOrder:
    """ORDER BY over a Table (ops/sort.py)."""

    SortKey = _sort.SortKey

    @staticmethod
    def sort(table: Table, keys) -> Table:
        return _sort.sort_table(table, keys)

    @staticmethod
    def order(table: Table, keys):
        return _sort.sort_order(table, keys)


class Aggregation:
    """GROUP BY over a Table (ops/aggregate.py)."""

    Agg = _aggregate.Agg

    @staticmethod
    def groupBy(
        table: Table, keys: Sequence[int], aggs, capacity: Optional[int] = None
    ) -> Table:
        return _aggregate.group_by(table, keys, aggs, capacity)


class Filter:
    """WHERE-clause row compaction (ops/filter.py)."""

    @staticmethod
    def apply(table: Table, predicate) -> Table:
        return _filter.filter_table(table, predicate)


class Join:
    """Equi-joins (ops/join.py)."""

    @staticmethod
    def join(
        left: Table,
        right: Table,
        left_on: Sequence[int],
        right_on: Sequence[int],
        how: str = "inner",
    ) -> Table:
        return _join.join(left, right, left_on, right_on, how)


class Regex:
    """Spark regex ops (ops/regex.py over regex/compile.py)."""

    @staticmethod
    def rlike(cv: Column, pattern: str) -> Column:
        return _regex.rlike(cv, pattern)

    @staticmethod
    def regexpExtract(cv: Column, pattern: str, idx: int = 1) -> Column:
        # Spark's regexp_extract defaults the group index to 1
        return _regex.regexp_extract(cv, pattern, idx)


# ---- fused execution and the resource manager ----

Pipeline = _pipeline.Pipeline
pad_string_payloads = _pipeline.pad_string_payloads


def _serving():
    # lazy: the serving driver is the front door and pulls the
    # diag/flight stack; importing the facade must not
    from . import serving as _srv

    return _srv


def serving_server(capacity_bytes: int, **kw):
    """Start a multi-tenant serving driver over this process's device
    (``spark_rapids_jni_tpu_torch/serving``): admission-controlled,
    fair-interleaved concurrent ``resource.task`` serving. Returns the
    started ``Server``; open tenants with ``server.open_session`` and
    submit ``Pipeline`` work with ``server.submit``."""
    return _serving().Server(capacity_bytes, **kw).start()


class RmmSpark:
    """RmmSpark.java — task-scoped resource manager control surface
    (runtime/resource.py). Not routed through the fault shim: it is the
    control plane that reacts to faults, not an op. Python callers
    normally use ``runtime.resource`` directly (``with
    resource.task(budget): ...``); this class keeps the Java argument
    orders."""

    task = staticmethod(_resource.task)
    metrics = staticmethod(_resource.metrics)

    @staticmethod
    def currentThreadIsDedicatedToTask(task_id: int):
        _resource.start_task(task_id)

    @staticmethod
    def taskDone(task_id: int):
        return _resource.task_done(task_id)

    @staticmethod
    def forceRetryOOM(task_id: int, num_ooms: int = 1, skip_count: int = 0):
        _resource.force_retry_oom(num_ooms, skip_count, task_id=task_id)

    @staticmethod
    def getAndResetNumRetryThrow(task_id: int) -> int:
        return _resource.get_and_reset_num_retry(task_id)

    @staticmethod
    def getMaxMemoryEstimated(task_id: int) -> int:
        m = _resource.metrics(task_id)
        if m is None:
            raise KeyError(f"unknown task id {task_id}")
        return m.peak_bytes


def _instrument(cls):
    """Route every facade entry through the fault-injection shim, an
    NVTX range and a telemetry op sample — the op boundary is the analog
    of the CUDA API boundary the reference's CUPTI callback intercepts
    (faultinj.cu:154-341), of its NVTX function ranges
    (NativeParquetJni.cpp CUDF_FUNC_RANGE), and of the plugin's
    per-operator GpuMetric accumulators. With SPARK_JNI_TPU_METRICS=off
    the extra cost is one enabled() check plus one (emission-free) span
    push/pop: the flight recorder's active stack names the op anyway."""
    for name, member in list(vars(cls).items()):
        if not isinstance(member, staticmethod):
            continue
        raw = member.__func__
        op_name = f"{cls.__name__}.{name}"

        def wrapper(*args, __raw=raw, __op=op_name, **kwargs):
            if not _metrics.enabled():
                with _spans.span("op", __op, emit_end=False):
                    _faultinj.inject_point(__op)
                    with _trace.op_range(__op):
                        return __raw(*args, **kwargs)
            rows_in, bytes_in = _metrics._rows_bytes(args)
            # causal span for the op: every journal event inside the
            # call — op_begin/op_end, injected faults — is stamped with
            # it; record_op's op_end is its close event
            with _spans.span("op", __op, emit_end=False):
                _faultinj.inject_point(__op)
                _events.emit("op_begin", op=__op, rows_in=rows_in, bytes_in=bytes_in)
                t0 = time.perf_counter()
                try:
                    with _trace.op_range(__op):
                        out = __raw(*args, **kwargs)
                except Exception as e:
                    _metrics.record_op(
                        __op, (time.perf_counter() - t0) * 1000, rows_in=rows_in,
                        bytes_in=bytes_in, ok=False, error=type(e).__name__,
                    )
                    raise
                rows_out, bytes_out = _metrics._rows_bytes(out)
                _metrics.record_op(
                    __op, (time.perf_counter() - t0) * 1000, rows_in=rows_in,
                    bytes_in=bytes_in, rows_out=rows_out, bytes_out=bytes_out,
                )
            return out

        functools.wraps(raw)(wrapper)
        setattr(cls, name, staticmethod(wrapper))
    return cls


for _cls in (
    CastStrings,
    DecimalUtils,
    MapUtils,
    JSONUtils,
    RowConversion,
    ZOrder,
    SortOrder,
    Aggregation,
    Filter,
    Join,
    Regex,
):
    _instrument(_cls)
