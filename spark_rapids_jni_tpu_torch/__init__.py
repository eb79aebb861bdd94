"""spark_rapids_jni_tpu_torch: the PyTorch/CUDA port of
spark_rapids_jni_tpu for NVIDIA Hopper.

Same columnar layout, module structure and names as the JAX package,
which stays the reference the port is tested against. The port imports
neither JAX nor the JAX package. Constructors default to
``device="cuda"`` and raise when no card is present; ops run on the
device of their input tensors.

Layer map of the ported slices:
  api.RowConversion               JCUDF row round trip (ops/row_conversion)
  api.DecimalUtils                DECIMAL128 arithmetic (ops/decimal, utils/)
  api.SortOrder, Aggregation,     ORDER BY, GROUP BY, WHERE (ops/sort,
    Filter                          ops/aggregate, ops/filter, ops/segmented)
  api.Join                        equi-joins (ops/join)
  api.CastStrings                 string -> integer / decimal (ops/cast_string)
  api.JSONUtils                   get_json_object (ops/get_json_object,
                                    ops/_json_scans)
  api.ParquetFooter, ParquetReader,
    read_table                    Parquet ingress over native/parquet_*.cpp
                                    (ops/parquet_footer, ops/parquet_reader,
                                    runtime/native)
  api.ScanPlan, prefetch_chunks,  footer-pruned, prefetched Parquet scan
    scan_chunks                     (runtime/scan: decode threads, pinned
                                    copies on a side stream)
  api.MapUtils                    from_json (ops/map_utils)
  api.Regex                       rlike, regexp_extract (ops/regex,
                                    regex/compile)
  api.ZOrder                      Z-order interleave, Hilbert index
                                    (ops/zorder)
  api.Pipeline, pad_string_payloads  fused chains, one program per chunk
                                    (runtime/pipeline, parallel/distributed
                                    collect, runtime/explain)
  api.RmmSpark, RetryOOMError     task-scoped retry runtime (runtime/resource,
                                    faultinj, flight, trace)
  ops/window, ops/rollup          window functions, ROLLUP / GROUPING SETS
  runtime/metrics, events, spans  telemetry: counters/gauges/timers, the
                                    event journal, causal spans
  runtime/diag, sampler,          live introspection: the loopback diag
    traceview, trace                server, the span-stack sampler, journal
                                    -> Chrome trace, torch.profiler timelines
  api.serving_server              the multi-tenant serving driver (serving/:
                                    admission, sessions, the fair interleaver)
  ops/row_conversion_host         host JCUDF codec over native/jcudf_rows.cpp
  parallel/spark_hash             Spark HashPartitioning placement
  parallel/mesh, exchange,        the device mesh, the exchange (all_to_all,
    shuffle, distributed            psum), hash_shuffle, distributed
                                    group-by / join / sort, sharded collects;
                                    runtime/resource mesh executors
  kernels/murmur3 + csrc/         the hand-written Hopper Murmur3 kernel
  columnar/                       DType, Column, Table, strings, interop
"""

from .columnar.dtypes import (
    DType,
    BOOL8,
    INT8,
    INT16,
    INT32,
    INT64,
    FLOAT32,
    FLOAT64,
    STRING,
    BINARY,
    DECIMAL32,
    DECIMAL64,
    DECIMAL128,
    TIMESTAMP_MICROS,
    DATE32,
)
from .columnar.column import Column
from .columnar.table import Table
from .columnar.interop import table_from_numpy, table_to_numpy
from . import api, kernels, ops, parallel, runtime, utils  # noqa: F401
from .api import (
    Aggregation,
    CastStrings,
    DecimalUtils,
    Filter,
    Join,
    JSONUtils,
    ParquetFooter,
    ParquetReader,
    Pipeline,
    Regex,
    RetryOOMError,
    RmmSpark,
    RowConversion,
    ScanPlan,
    SortOrder,
    ZOrder,
    pad_string_payloads,
    prefetch_chunks,
    read_table,
    scan_chunks,
)

# live introspection: the diagnostics endpoint (SPARK_JNI_TPU_DIAG=<port>,
# loopback-only) and the span-stack sampling profiler
# (SPARK_JNI_TPU_SAMPLER=<hz>) arm from the environment at import, opt-in,
# so the unarmed cost is two env reads. Both packages read the same
# variables: when the JAX package already holds a fixed port, this bind
# fails, logs a warning and leaves the port's server off.
from .runtime import diag as _diag  # noqa: E402
from .runtime import sampler as _sampler  # noqa: E402

_diag.maybe_start()
_sampler.maybe_start()

__version__ = "0.1.0"

__all__ = [
    "Column",
    "Table",
    "DType",
    "BOOL8",
    "INT8",
    "INT16",
    "INT32",
    "INT64",
    "FLOAT32",
    "FLOAT64",
    "STRING",
    "BINARY",
    "DECIMAL32",
    "DECIMAL64",
    "DECIMAL128",
    "TIMESTAMP_MICROS",
    "DATE32",
    "table_from_numpy",
    "table_to_numpy",
    "Aggregation",
    "CastStrings",
    "DecimalUtils",
    "Filter",
    "Join",
    "JSONUtils",
    "ParquetFooter",
    "ParquetReader",
    "Pipeline",
    "Regex",
    "RetryOOMError",
    "RmmSpark",
    "RowConversion",
    "ScanPlan",
    "SortOrder",
    "ZOrder",
    "pad_string_payloads",
    "prefetch_chunks",
    "read_table",
    "scan_chunks",
]
