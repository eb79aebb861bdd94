#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the first rung of BASELINE.md's config ladder: a TPC-H
lineitem batch at 4 Mi rows (the reference nvbench's larger row axis)
-> Spark HashPartitioning ids over (l_partkey, l_suppkey) into 200
partitions (TPC-H q9's lineitem x partsupp exchange at Spark's default
``spark.sql.shuffle.partitions``) through the hand-written Murmur3
kernel -> JCUDF rows -> columns.

Phases, each fatal on failure:
  1. device: a CUDA card must be present; prints its name and power limit
  2. build: compiles every kernel source of the port (one nvcc each) and
     the host libraries (the JCUDF codec; the Parquet footer parser and
     page decoder, whose zlib and zstd it probes), all at once
  3. kernel parity: the kernel against its plain PyTorch version on the
     card, exact, over a matrix of types, nulls, seeds and row counts;
     times both with CUDA events
  4. main path: counts set to 0, the path driven through the public
     entry points, counts read; partition ids against the plain version
     and an independent numpy Murmur3, the round trip exact
  5. two more shapes: the reference's 212-column fixed-width nvbench
     table and bench.py's strings table, both at 1 Mi rows, exact
  6. card against CPU: a mixed 64 Ki-row batch (ties, NaN, -0.0, nulls,
     strings, DECIMAL64/128 with overflow rows) through sort, filter,
     group-by and the decimal operators on the card and on the CPU;
     the results must be equal
  7. the second path, TPC-H q1 at SF10 (BASELINE.md config 2): 59,986,052
     lineitem rows in 4 Mi-row batches on the card through filter ->
     DECIMAL128 products -> group-by -> sort, every batch and the merge of
     all batches exactly equal to a host oracle; per-stage times, rows/s,
     a profile and the peak device memory
  8. joins, card against CPU: all six join types through ``join`` and
     ``join_padded`` over 64 Ki-row sides (INT64 keys with nulls and
     duplicates, STRING + INT32 keys of different pad widths, FLOAT64 keys
     with NaN and -0.0, a DECIMAL128 key, empty sides, occupied masks, a
     truncating capacity); the results must be equal
  9. the third path, TPC-H q5 at SF10 (BASELINE.md config 3 on one card):
     region, nation, 100,000 suppliers, 1,500,000 customers, 15,000,000
     orders and ~60 M lineitem rows resident on the card; the build side
     once, then per 4 Mi-row lineitem batch two joins, the revenue product
     and a group-by, then the merge and ORDER BY revenue DESC; every
     batch and the final rows exactly equal to a host oracle; stage
     times, rows/s, ops per batch, a profile and the peak device memory
  10. the host JCUDF codec (native/jcudf_rows.cpp, built with the host
     compiler) over the 4 Mi-row batch of phase 4: byte-exact against the
     card's convertToRows, and its decode gives the columns back
  11. casts and JSON, card against CPU: a mixed 64 Ki-row batch of
     integer, decimal and JSON strings (whitespace, signs, type bounds,
     rounding, exponents, escapes, surrogate pairs, nested containers,
     misses, malformed rows, nulls) through CastStrings.toInteger /
     toDecimal and JSONUtils.getJsonObject on the card and on the CPU;
     the results must be equal, and the ANSI casts must raise the same
     CastException
  12. the fourth path, store_sales at SF10 (BASELINE.md config 4 on one
     card): 28,800,000 rows of benchmarks/sf10_store_sales.py's
     generator written to a Parquet file (dictionary pages, snappy) in
     14 row groups, read back through the port's ParquetReader (host
     decode by native/parquet_pages.cpp, built with the host compiler)
     and run through toInteger -> toDecimal -> get_json_object -> filter
     -> group-by; every row group and the folded per-store totals exactly
     equal to the oracle; end-to-end and device-chain rows/s, per-stage
     ms, ops per row group, a profile and the peak device memory
  13. float casts and from_json, card against CPU: a mixed 64 Ki-row batch
     of float strings (every quirk of the reference's parser: nan/inf
     forms, f/d suffixes, the 4-digit exponent cap, 19-25 digit
     mantissas above 2^63, subnormals, whitespace, signs, nulls) through
     CastStrings.toFloat (FLOAT32, FLOAT64) and of JSON objects (escapes,
     surrogate pairs, nested values, every scalar kind, empty objects,
     duplicate keys, nulls) through MapUtils.extractRawMapFromJsonString
     under both scan strategies; the results must be equal, and the ANSI
     cast and a malformed document must raise the same row
  14. the reference's string->float axis (cast_string_to_float nvbench,
     FLOAT32 at 1 Mi and 100 Mi rows): benchmarks/suites.py-shaped
     strings, the 100 Mi-row column resident on the card and cast in
     16 Mi-row chunks, every row exact against a host oracle; rows/s,
     per-chunk ms, ops, a profile and the peak device memory
  15. from_json over SF10 store_sales: extractRawMapFromJsonString over
     ss_attrs_json of phase 12's file (28,800,000 rows, the reader's
     footer pruned to that column), every row group exact against the
     generator; rows/s, per-row-group ms, ops, a profile, peak memory
  16. nested Parquet: one 2 Mi-row row group of LIST<INT32>,
     STRUCT<INT64, STRING> and MAP<STRING, STRING> (nulls and empties at
     every level; definition and repetition levels) read on the card and
     on the CPU, both exact against the generator; decode and h2d ms
  17. rung 4 through the streamed scan: ScanPlan over phase 12's file ->
     prefetch_chunks (default workers, depth 2; decode threads, pinned
     copies on a side stream) -> the store_sales chain, every row group
     and the totals exact, in turns with the synchronous read loop (both
     end-to-end rows/s), the scan metrics, the decode pool size and the
     machine's cores, peak memory, and scan_chunks once more
  18. Regex at benchmarks/regex_scan.py's axes (rlike over 1 Mi narrow
     rows for its four patterns and 256 Ki wide rows; regexp_extract over
     256 Ki rows), under serial and monoid (extraction also unbatched),
     every row exact against Python re; ms, rows/s, torch ops; then card
     against CPU over mixed rows (nulls, empties, line terminators,
     anchors, lazy quantifiers, a 70-position pattern) and the
     fingerprints against the JAX package's strings
  19. ZOrder on rung 1's 4 Mi-row lineitem batch: interleaveBits over the
     three INT64 keys, interleaveBits and hilbertIndex(10) over their
     INT32 range ids in [0, 1000), with and without nulls, exact against
     numpy oracles; ms, rows/s and the share of the byte bound
  20. window and rollup, card against CPU: every WindowSpec kind under
     both frames, ROLLUP and GROUPING SETS over the mixed 64 Ki-row batch,
     exact; one window over rung 1's 4 Mi-row lineitem batch, timed
  21. rung 5, q1 at SF10 through the fused Pipeline (benchmarks/
     sf10_q1.py's chain: filter -> map(decimal products) -> group-by):
     Pipeline.run and stream(window=2) (the chain replayed as a CUDA
     graph), then two threads on streams of their own sharing the
     Pipeline, every batch exact against the host oracle and the eager
     run of the same chain in the same call; rows/s, torch ops per
     chunk, the idle share, plan-cache misses and hits (one miss per
     chain and shape), peak memory; the chain's eager sync-free form
     and one chunk's dispatch under sync debug mode "error"
  22. one q5 lineitem batch through the Pipeline (two joins, the
     revenue product, group-by), exact against phase 9's result; two
     Pipelines of one join chain over two same-shaped supplier tables
     share one plan, each exact against its own eager chain
  23. store_sales at SF10 through Pipeline.scan_parquet over phase 12's
     file, in turns with phase 17's eager prefetched loop, exact against
     the oracles
  24. the retry runtime on the card: RmmSpark.forceRetryOOM mid-stream,
     an undersized group-by capacity that re-plans, a retry_oom fault
     from a faultinj rule file (results exact), and RetryOOMError past a
     byte budget and past the retry bound
  25. the exchange, card against CPU: over 8 shards on the card and 8
     on the CPU (``Mesh([dev] * 8)``), the mixed and join batches of 64 Ki
     rows through hash_shuffle (string keys, a truncating wire pin, a
     salt, an undersized bucket), partition_exchange, the distributed
     group-by (every agg, string keys, overflow_detail), the co-
     partitioned joins of every kind, the broadcast joins and the
     distributed sort: each shard's live rows, occupancy and every
     overflow count equal; the kernel against its plain version on the
     exchange's own key planes
  26. rung 3 in its full form, TPC-H q5 at SF10 over the exchange: phase
     9's tables on 8 shards of the card; the build (orders of 1994 JOIN
     customer) once, then per 4 Mi lineitem batch JOIN the build, JOIN
     supplier, the region mask, the revenue product and the distributed
     group-by, all through the mesh executors under one task scope with
     the capacity-feedback memo; every batch and the final rows exact
     against the host oracle; rows/s beside phase 9's, the exchange's
     ms per step and bytes, padding waste, re-plans, torch ops, the idle
     share, peak memory, murmur3 launches and the kernel at this shape
  27. the mesh executors (resource.group_by / join / shuffle) over 8
     shards under the retry runtime: undersized capacities that re-plan,
     RmmSpark.forceRetryOOM, a faultinj retry_oom rule (results exact
     against the one-card eager ops), RetryOOMError past a byte budget;
     the memo and program-cache rows
  28. the sharded stream: phase 21's q1 chain and phase 22's q5 join
     chain (broadcast and co-partitioned build sides) through
     Pipeline.stream(window=2, shard=<8-shard Mesh>) in turns with the
     unsharded stream, value-identical; rows/s, ops per chunk, plan
     misses and hits; one sharded graph dispatch under sync debug mode
  29. the serving driver (api.serving_server) with the diag server up and
     the sampler armed at 19 Hz: four tenants, each submitting from its
     own client thread: phase 21's q1 chain (2 jobs of 4 chunks), phase
     22's q5 join chain (2 jobs of 3 lineitem batches), the store_sales
     chain over a lazy scan of 4 of phase 12's row groups (1 job), and a
     shuffle write (q1's filter and products at 2 Mi-row chunks, then
     HashPartitioning ids over l_orderkey into 200 partitions through
     the murmur3 kernel; 2 jobs of 4 chunks); every job exact against
     its host oracle and the serial single-tenant run of the same
     chunks; /healthz, /metrics, /sessions, /slo, /plans, /spans and
     /profile scraped while they run; per tenant e2e p50/p99, rows/s
     served and serial, the time in each state, slices per job, plan-
     cache misses and hits, the admission estimate beside the measured
     peak; the time-in-state closure; the device idle share; the
     sampler's cost in turns; one warm dispatch slice under sync debug
     mode "error"; a burst at 1/8 of the priced bytes that queues and
     rejects at admission; one slow-job flight bundle; a trace.timeline
     of one q1 chunk and the phase's journal through traceview
  30. one JSON line of kernel numbers (with murmur3's launches on every
     path: rung 1, the exchange paths 26-28 and serving launch it, the
     others 0), the card line, then the verdict

Exits non-zero, printing no verdict, without a card or without the port
beside it. Data is made from fixed seeds.
"""

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

try:  # the names the Pipeline stage functions below read (an import in
    # a stage function's body would hide its reads from the plan key)
    from spark_rapids_jni_tpu_torch import INT32 as PortINT32
    from spark_rapids_jni_tpu_torch import Column as PortColumn
    from spark_rapids_jni_tpu_torch import Table as PortTable
    from spark_rapids_jni_tpu_torch.api import DecimalUtils as PortDecimalUtils
    from spark_rapids_jni_tpu_torch.columnar.strings import to_char_matrix
    from spark_rapids_jni_tpu_torch.parallel import spark_hash as port_spark_hash
except ImportError:  # chip_smoke.py without the port beside it: main() fails
    PortINT32 = PortColumn = PortTable = PortDecimalUtils = to_char_matrix = None
    port_spark_hash = None

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N_MAIN = 1 << 22  # 4 Mi rows
N_WIDE = 1 << 20  # 1 Mi rows
NUM_PARTITIONS = 200
KEYS = (1, 2)  # l_partkey, l_suppkey
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (data sheet)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def lineitem_spec(n, seed=7):
    """__graft_entry__._lineitem_table's batch in the interop form."""
    rng = np.random.default_rng(seed)
    i64, i32 = ("int", 64, None, None), ("int", 32, None, None)
    dec, date = ("decimal", 64, 12, 2), ("date", 32, None, None)
    draws = [
        (1, 6_000_000, np.int64, i64), (1, 200_000, np.int64, i64),
        (1, 10_000, np.int64, i64), (1, 8, np.int32, i32),
        (100, 5100, np.int64, dec), (90_000, 10_500_000, np.int64, dec),
        (0, 11, np.int64, dec), (0, 9, np.int64, dec),
        (8000, 12000, np.int32, date), (8030, 12030, np.int32, date),
        (8060, 12060, np.int32, date),
    ]
    return [
        {"dtype": dt, "data": rng.integers(lo, hi, n, npt), "validity": None, "offsets": None}
        for lo, hi, npt, dt in draws
    ]


def categorical_strings(rng, choices, n):
    enc = [c.encode() for c in choices]
    width = max(len(e) for e in enc)
    lut = np.zeros((len(enc), width), np.uint8)
    for i, e in enumerate(enc):
        lut[i, : len(e)] = np.frombuffer(e, np.uint8)
    lens_lut = np.array([len(e) for e in enc], np.int64)
    idx = rng.integers(0, len(enc), n)
    lens = lens_lut[idx]
    data = lut[idx][np.arange(width)[None, :] < lens[:, None]]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return {"dtype": ("string", 0, None, None), "data": data, "validity": None,
            "offsets": offsets}


def strings_spec(n):
    """bench.py's _strings_table (same seed and draw order)."""
    rng = np.random.default_rng(11)
    flags = categorical_strings(rng, ["A", "N", "R"], n)
    modes = categorical_strings(
        rng, ["AIR", "TRUCK", "MAIL", "SHIP", "RAIL", "REG AIR", "FOB"], n
    )
    return [
        {"dtype": ("int", 64, None, None), "data": rng.integers(1, 6_000_000, n, np.int64),
         "validity": None, "offsets": None},
        flags,
        {"dtype": ("int", 32, None, None), "data": rng.integers(1, 50, n, np.int32),
         "validity": None, "offsets": None},
        modes,
    ]


def cycled_table(port, n, n_cols=212, seed=0):
    """The reference's fixed-width nvbench table: 212 columns cycling
    benchmarks/suites.py's nine int/bool types, made on the card."""
    types = [port.INT8, port.INT16, port.INT32, port.INT64, port.BOOL8,
             port.INT8, port.INT16, port.INT32, port.INT64]
    g = torch.Generator(device="cuda").manual_seed(seed)
    cols = []
    for i in range(n_cols):
        dt = types[i % len(types)]
        if dt.kind == "bool":
            lo, hi = 0, 2
        else:
            info = np.iinfo(dt.np_dtype)
            lo, hi = info.min // 2, info.max // 2
        data = torch.randint(lo, hi, (n,), generator=g, device="cuda", dtype=torch.int64)
        cols.append(port.Column(dt, data.to(dt.torch_dtype)))
    return port.Table(cols)


def type_matrix_spec(n, seed):
    """Every fixed-width key type the kernel takes, with NaN, -0.0 and
    infinities, and nullable columns."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(size=n).astype(np.float32)
    f64 = rng.normal(size=n)
    for f in (f32, f64):
        f[::7] = np.nan
        f[3::11] = -0.0
        f[5::13] = np.inf
    d128 = np.stack([rng.integers(-(10**17), 10**17, n), np.zeros(n, np.int64)], 1)
    d128[:, 1] = np.where(d128[:, 0] < 0, -1, 0)  # sign-extended hi limb
    valid = lambda p: rng.random(n) > p  # noqa: E731
    cols = [
        (("int", 32, None, None), rng.integers(-(2**31), 2**31, n).astype(np.int32), None),
        (("int", 64, None, None), rng.integers(-(2**62), 2**62, n), valid(0.3)),
        (("float", 32, None, None), f32, None),
        (("float", 64, None, None), f64, valid(0.5)),
        (("decimal", 64, 18, 2), rng.integers(-(10**17), 10**17, n), None),
        (("decimal", 128, 18, 2), d128, valid(0.2)),
        (("bool", 8, None, None), rng.integers(0, 2, n).astype(np.int8), None),
        (("int", 16, None, None), rng.integers(-(2**15), 2**15, n).astype(np.int16), valid(0.1)),
    ]
    return [{"dtype": dt, "data": d, "validity": v, "offsets": None} for dt, d, v in cols]


def time_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, reps=3):
    """Median host-clock ms of ``fn`` ending in a device sync, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def profile_stage(label, fn, top=6):
    """One run of ``fn`` under torch.profiler: device busy time (union of
    kernel intervals), the device idle share of the window from the
    first host op to the last kernel end, and the kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in events if e.device_type == DeviceType.CUDA
    )
    if not dev:
        print(f"profile [{label}]: no device events; device busy not measured")
        return
    busy = union_us([(s, e) for s, e, _ in dev])
    start = min(e.time_range.start for e in events)
    window = max(e for _, e, _ in dev) - start
    by_name = {}
    for s, e, name in dev:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s), c + 1)
    print(f"profile [{label}]: {len(dev)} kernels, device busy {busy:.1f} us of a "
          f"{window:.1f} us window (idle {1 - busy / window:.3f})")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t:10.1f} us  x{c:<4d} {name[:100]}")


def union_us(intervals):
    """Length of the union of sorted (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, intervals[0][0], intervals[0][1]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def murmur3_numpy_int64_pairs(a, b, seed=42):
    """Independent numpy Spark Murmur3 of (long a, long b) rows."""
    M = np.uint64(0xFFFFFFFF)

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & M

    def mix(h, k):
        k = (k * np.uint64(0xCC9E2D51)) & M
        k = (rotl(k, 15) * np.uint64(0x1B873593)) & M
        h = rotl(h ^ k, 13)
        return (h * np.uint64(5) + np.uint64(0xE6546B64)) & M

    def fmix(h, length):
        h ^= np.uint64(length)
        h ^= h >> np.uint64(16)
        h = (h * np.uint64(0x85EBCA6B)) & M
        h ^= h >> np.uint64(13)
        h = (h * np.uint64(0xC2B2AE35)) & M
        return h ^ (h >> np.uint64(16))

    h = np.full(a.shape, seed, np.uint64)
    for x in (a, b):
        u = x.astype(np.int64).view(np.uint64)
        h = fmix(mix(mix(h, u & M), u >> np.uint64(32)), 8)
    return h.astype(np.uint32).view(np.int32)


N_MIXED = 1 << 16  # 64 Ki rows
Q1_BATCH = 1 << 22  # 4 Mi rows, benchmarks/sf10_q1.py's chunk
SF10_LINEITEM_ROWS = 59_986_052  # TPC-H SF10 lineitem
Q1_CUTOFF = 10_470  # l_shipdate <= date '1998-09-02', days since epoch
Q1_RF = np.array([65, 82, 78], np.uint8)  # l_returnflag A R N
Q1_LS = np.array([79, 70], np.uint8)  # l_linestatus O F


def mixed_spec(n, seed=3):
    """A mixed batch in the interop form: heavy key ties, NaN, -0.0 and
    infinities, nulls, strings with shared prefixes and empty strings,
    DECIMAL64 and DECIMAL128 (some near 10^38, so sums, products and
    quotients overflow, and zero divisors)."""
    rng = np.random.default_rng(seed)

    def col(dt, data, p_null=0.0, offsets=None):
        valid = rng.random(n) >= p_null if p_null else None
        return {"dtype": dt, "data": data, "validity": valid, "offsets": offsets}

    def strings(vocab):
        s = categorical_strings(rng, vocab, n)
        return s["data"], s["offsets"]

    def dec128(max_hi, p_small):
        """int64 [n, 2] limbs of values below max_hi * 2^64 in
        magnitude, a share of them small, both signs."""
        lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        hi = rng.integers(0, max_hi, n, dtype=np.uint64)
        small = rng.random(n) < p_small
        hi[small] = 0
        lo[small] %= np.uint64(10**6)
        neg = rng.random(n) < 0.5
        lo_n = ~lo + np.uint64(1)
        hi_n = ~hi + (lo == 0).astype(np.uint64)
        lo, hi = np.where(neg, lo_n, lo), np.where(neg, hi_n, hi)
        return np.stack([lo, hi], axis=1).view(np.int64)

    f_key = rng.choice([-0.0, 0.0, 1.5, np.nan, -np.inf, np.inf], n)
    f_val = rng.normal(size=n) * 1e3
    f_val[::97] = np.nan
    f_val[5::131] = np.inf
    f_val[7::89] = -0.0
    b = dec128(10**11, 0.3)
    b[::50] = 0  # zero divisors
    i18 = rng.integers(-(10**18) + 1, 10**18, n)
    i19 = rng.integers(-(2**63) + 1, 2**63 - 1, n)
    s_data, s_offs = strings(["", "a", "ab", "abc", "b", "ba", "zzzzzzzz", "zzzzzzzzz", "é"])
    return [
        col(("int", 32, None, None), rng.integers(0, 8, n).astype(np.int32), 0.1),
        col(("string", 0, None, None), s_data, 0.1, s_offs),
        col(("float", 64, None, None), f_key, 0.1),
        col(("int", 64, None, None), rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64), 0.2),
        col(("float", 64, None, None), f_val, 0.2),
        col(("decimal", 64, 18, 2), rng.integers(-(10**17), 10**17, n)),
        col(("decimal", 128, 38, 2), dec128(5_421_010_862_427_522_170, 0.3), 0.1),
        col(("decimal", 128, 38, 3), b),
        col(("decimal", 128, 18, 2), np.stack([i18, i18 >> 63], axis=1)),
        col(("decimal", 128, 19, 0), np.stack([i19, i19 >> 63], axis=1), 0.05),
        col(("date", 32, None, None), rng.integers(10_000, 10_004, n).astype(np.int32)),
    ]


def mixed_ops(t, pred):
    """Every operator of the q1 slice over the mixed batch: name ->
    result Table."""
    from spark_rapids_jni_tpu_torch import INT32, Column, Table
    from spark_rapids_jni_tpu_torch.api import Aggregation, DecimalUtils, Filter, SortOrder

    Agg, Key = Aggregation.Agg, SortOrder.SortKey
    aggs = [Agg("count"), Agg("count", 3)]
    for c, ops in ((3, "sum mean min max"), (4, "sum mean min max"), (5, "sum mean min"),
                   (6, "sum mean max"), (1, "min max")):
        aggs += [Agg(op, c) for op in ops.split()]
    c = t.columns
    perm = SortOrder.order(t, [Key(1), Key(2, False), Key(0, True, False), Key(6, False)])
    return {
        "sort_order": Table([Column(INT32, perm)]),
        "sort_table": SortOrder.sort(t, [Key(10), Key(3, False), Key(4)]),
        "filter_table": Filter.apply(t, pred),
        "group_by int,string": Aggregation.groupBy(t, [0, 1], aggs),
        "group_by float": Aggregation.groupBy(t, [2], aggs),
        "multiply128 i128": DecimalUtils.multiply128(c[8], c[9], 2),
        "multiply128 noshift": DecimalUtils.multiply128(c[6], c[7], 5),
        "multiply128 scales_any": DecimalUtils.multiply128(c[6], c[7], 4),
        "add128": DecimalUtils.add128(c[6], c[7], 3),
        "divide128": DecimalUtils.divide128(c[6], c[7], 6),
    }


def same_array(a, b) -> bool:
    """Equal shape, dtype and values; floats compare NaN with NaN (the
    NaN payload may differ between devices) and -0.0 apart from 0.0."""
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        nan = np.isnan(a)
        return bool(np.array_equal(a, b, equal_nan=True)
                    and np.array_equal(np.signbit(a) & ~nan, np.signbit(b) & ~nan))
    return a.tobytes() == b.tobytes()


def card_vs_cpu(n):
    """The port's q1 operators on the card and on the CPU over one mixed
    batch: every column's data, validity and offsets must be equal."""
    from spark_rapids_jni_tpu_torch import BOOL8, Column
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy, table_to_numpy

    spec = mixed_spec(n)
    rng = np.random.default_rng(4)
    keep, keep_valid = rng.random(n) < 0.4, rng.random(n) > 0.2
    results = {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        t = table_from_numpy(spec, device=dev)
        pred = Column.from_numpy(keep.astype(np.int8), BOOL8, keep_valid, device=dev)
        results[dev] = {k: table_to_numpy(v) for k, v in mixed_ops(t, pred).items()}
    for name, want in results["cpu"].items():
        got = results["cuda"][name]
        if len(got) != len(want):
            raise AssertionError(f"card vs cpu [{name}]: column count")
        for i, (g, w) in enumerate(zip(got, want)):
            for key in ("data", "validity", "offsets"):
                if not same_array(g[key], w[key]):
                    raise AssertionError(f"card vs cpu [{name}]: column {i} {key} differs")
    rows = {k: len(v[0]["data"]) for k, v in results["cpu"].items()}
    print(f"card vs cpu: {len(rows)} operators exact at {n} rows in "
          f"{time.perf_counter() - t0:.1f} s; output rows {json.dumps(rows)}", flush=True)

    # the decimal operators' times on the card; divide128 runs the
    # 256-step long division over every row
    from spark_rapids_jni_tpu_torch.api import DecimalUtils

    for rows_n in (n, Q1_BATCH):
        spec_n = spec if rows_n == n else mixed_spec(rows_n, seed=5)
        c = table_from_numpy(spec_n[6:10], device="cuda").columns
        ms = {
            "multiply128 i128": host_ms(lambda: DecimalUtils.multiply128(c[2], c[3], 2)),
            "multiply128 noshift": host_ms(lambda: DecimalUtils.multiply128(c[0], c[1], 5)),
            "multiply128 scales_any": host_ms(lambda: DecimalUtils.multiply128(c[0], c[1], 4)),
            "add128": host_ms(lambda: DecimalUtils.add128(c[0], c[1], 3)),
            "divide128": host_ms(lambda: DecimalUtils.divide128(c[0], c[1], 6)),
        }
        print(f"decimal ms at {rows_n} rows (host clock, median of 3): {json.dumps(ms)}",
              flush=True)
        del c


def q1_batch_arrays(rng, n):
    """One lineitem batch of benchmarks/sf10_q1.py's draw (:91-107, same
    order of draws): 1-byte CHAR keys, DECIMAL64(12,2) measures as
    unscaled int64, DATE32 ship date."""
    return {
        "rf": Q1_RF[rng.integers(0, 3, n)],
        "ls": Q1_LS[rng.integers(0, 2, n)],
        "qty": rng.integers(100, 5100, n),
        "price": rng.integers(90_000, 10_500_000, n),
        "disc": rng.integers(0, 11, n),
        "tax": rng.integers(0, 9, n),
        "ship": rng.integers(10_000, 10_500, n).astype(np.int32),
    }


def q1_table(arrays, device):
    """The batch as a port Table on ``device``; both CHAR(1) key columns
    share one offsets tensor."""
    from spark_rapids_jni_tpu_torch import DATE32, DECIMAL64, STRING, Column, Table

    def put(a):
        return torch.from_numpy(a).to(device)

    n = len(arrays["qty"])
    offs = torch.arange(n + 1, dtype=torch.int32, device=device)
    dec = DECIMAL64(12, 2)
    return Table([
        Column(STRING, put(arrays["rf"]), None, offs),
        Column(STRING, put(arrays["ls"]), None, offs),
        *(Column(dec, put(arrays[k])) for k in ("qty", "price", "disc", "tax")),
        Column(DATE32, put(arrays["ship"])),
    ])


def widen(data, precision):
    """DECIMAL(12,2) int64 storage as DECIMAL128(precision, 2) limbs.
    lineitem is DECIMAL(12,2); the 1 - x and 1 + x literals type as
    DECIMAL(13,2)."""
    from spark_rapids_jni_tpu_torch import DECIMAL128, Column

    return Column(DECIMAL128(precision, 2), torch.stack([data, data >> 63], dim=-1))


def disc_price(price, disc):
    """l_extendedprice * (1 - l_discount) over DECIMAL(12,2) storage:
    (12,2) x (13,2) -> (26,4), multiply128's i128 regime. Returns its
    {overflow, product} Table (q1's sum_disc_price, q5's revenue)."""
    from spark_rapids_jni_tpu_torch.api import DecimalUtils

    return DecimalUtils.multiply128(widen(price, 12), widen(100 - disc, 13), 4)


def q1_run(t, tick=None):
    """TPC-H q1 over one batch through the port's entry points (the
    chain of tests/test_tpch_q1.py with benchmarks/sf10_q1.py's static
    types). ``tick(stage)`` is called after each stage. Returns (sorted
    result Table, bool tensor: did any product overflow)."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.api import Aggregation, DecimalUtils, Filter, SortOrder

    tick = tick or (lambda stage: None)
    f = Filter.apply(t, t.columns[6].data <= Q1_CUTOFF)
    tick("filter")
    qty, price, disc, tax = f.columns[2:6]
    m1 = disc_price(price.data, disc.data)
    # (26,4) x (13,2) -> (38,6): the noshift regime
    m2 = DecimalUtils.multiply128(m1.columns[1], widen(100 + tax.data, 13), 6)
    overflow = (m1.columns[0].data != 0).any() | (m2.columns[0].data != 0).any()
    work = Table([f.columns[0], f.columns[1], qty, price, m1.columns[1], m2.columns[1], disc])
    tick("decimal")
    Agg = Aggregation.Agg
    g = Aggregation.groupBy(work, [0, 1], [
        Agg("sum", 2), Agg("sum", 3), Agg("sum", 4), Agg("sum", 5),
        Agg("mean", 2), Agg("mean", 3), Agg("mean", 6), Agg("count"),
    ])
    tick("group_by")
    out = SortOrder.sort(g, [SortOrder.SortKey(0), SortOrder.SortKey(1)])
    tick("sort")
    return out, overflow


def op_counts(run):
    """torch ops dispatched by ``run(tick)`` between its ``tick(stage)``
    calls: stage -> count."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.count += 1
            return func(*args, **(kwargs or {}))

    counts, last = {}, [0]
    counter = Counter()

    def tick(stage):
        counts[stage] = counter.count - last[0]
        last[0] = counter.count

    with counter:
        run(tick)
    return counts


def q1_op_counts(t):
    """torch ops dispatched per q1 stage over one batch, and by one of
    the decimal avgs' long divisions (``utils.int256.divide_and_round``
    over 6 group rows, as ``group_by`` calls it)."""
    from spark_rapids_jni_tpu_torch.utils import int256 as u256

    counts = op_counts(lambda tick: q1_run(t, tick))
    dev = t.columns[0].device
    num = tuple(torch.full((6,), 10**12, dtype=torch.int64, device=dev) for _ in range(4))
    cnt = torch.full((6,), 10**6, dtype=torch.int64, device=dev)

    def division(tick):
        u256.divide_and_round(num, (cnt, 0), torch.zeros(6, dtype=torch.bool, device=dev))
        tick("one avg division")

    counts.update(op_counts(division))
    return counts


def q1_oracle(arrays):
    """Exact per-group sums of one batch on the host, numpy int64 (a
    batch of 4 Mi rows of values below 1.14e11 cannot overflow):
    {(returnflag, linestatus): [sum_qty, sum_price, sum_disc_price,
    sum_charge, sum_disc, count]} as Python ints."""
    keep = arrays["ship"] <= Q1_CUTOFF
    price = arrays["price"]
    disc_price = price * (100 - arrays["disc"])  # scale 4
    charge = disc_price * (100 + arrays["tax"])  # scale 6
    out = {}
    for rf in Q1_RF:
        for ls in Q1_LS:
            sel = keep & (arrays["rf"] == rf) & (arrays["ls"] == ls)
            if sel.any():
                sums = [int(x[sel].sum()) for x in (arrays["qty"], price, disc_price, charge,
                                                    arrays["disc"])]
                out[(chr(rf), chr(ls))] = sums + [int(sel.sum())]
    return out


def avg_half_up(total: int, count: int) -> int:
    """Spark's avg(DECIMAL(12,2)) -> DECIMAL(16,6): total * 10^4 / count
    rounded HALF_UP (away from zero), in exact integers."""
    q, r = divmod(abs(total) * 10**4, count)
    q += 2 * r >= count
    return -q if total < 0 else q


def q1_expected_rows(groups):
    """q1's sorted result rows from exact per-group sums."""
    rows = []
    for key in sorted(groups):
        s_qty, s_price, s_dp, s_ch, s_disc, cnt = groups[key]
        rows.append([key[0], key[1], s_qty, s_price, s_dp, s_ch, avg_half_up(s_qty, cnt),
                     avg_half_up(s_price, cnt), avg_half_up(s_disc, cnt), cnt])
    return rows


def q1_rows(out):
    """Rows of a q1 result table as Python values."""
    return [list(r) for r in zip(*out.to_pylists())]


def q1_sf10(counters, card):
    """The q1 path at SF10: batches drawn on the host, copied to the
    card, then timed stage by stage and held against the host oracle
    per batch and merged."""
    sizes = [Q1_BATCH] * (SF10_LINEITEM_ROWS // Q1_BATCH)
    sizes.append(SF10_LINEITEM_ROWS - sum(sizes))
    rng = np.random.default_rng(42)
    t0 = time.perf_counter()
    host = [q1_batch_arrays(rng, n) for n in sizes]
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tables = [q1_table(a, "cuda") for a in host]
    torch.cuda.synchronize()
    data_bytes = torch.cuda.memory_allocated() - base
    print(f"q1 data: {len(sizes)} batches, {sum(sizes)} rows, drawn in {gen_s:.1f} s, "
          f"{data_bytes} bytes on the card ({data_bytes / sum(sizes):.1f} B/row)", flush=True)

    q1_run(tables[0])  # warm-up: first launches of every op, outside the timing
    torch.cuda.synchronize()
    for name in counters:
        counters[name].launches = 0
    stage_ms = {s: [] for s in ("filter", "decimal", "group_by", "sort")}
    outs = []
    total_s = 0.0
    for t in tables:
        last = [time.perf_counter()]

        def tick(stage):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stage_ms[stage].append((now - last[0]) * 1e3)
            last[0] = now

        start = last[0]
        outs.append(q1_run(t, tick))
        total_s += last[0] - start
    launches = {name: c.launches for name, c in counters.items()}

    merged_got, merged_want = {}, {}
    for i, ((out, overflow), arrays) in enumerate(zip(outs, host)):
        if bool(overflow):
            raise AssertionError(f"q1 batch {i}: a decimal product overflowed")
        want_groups = q1_oracle(arrays)
        got = q1_rows(out)
        if got != q1_expected_rows(want_groups):
            raise AssertionError(f"q1 batch {i}: result differs from the host oracle:\n{got}")
        for row in got:  # the sums and counts merge; an avg is held per batch
            acc = merged_got.setdefault((row[0], row[1]), [0] * 5)
            for j, v in enumerate(row[2:6] + [row[9]]):
                acc[j] += v
        for key, vals in want_groups.items():
            acc = merged_want.setdefault(key, [0] * 6)
            for j, v in enumerate(vals):
                acc[j] += v
    want_merged = {k: v[:4] + [v[5]] for k, v in merged_want.items()}
    if merged_got != want_merged or len(merged_got) != 6:
        raise AssertionError(f"q1 merge differs from the host oracle: {merged_got}")
    final = q1_expected_rows(merged_want)

    med = {s: float(np.median(v)) for s, v in stage_ms.items()}
    print(f"q1 sf10: {len(sizes)} batches exact against the host oracle, merge exact; "
          f"kernel launches on the path {json.dumps(launches)}")
    print(f"q1 sf10 per-stage ms (median over batches): {json.dumps(med)}")
    print(f"q1 sf10: {sum(sizes)} rows in {total_s * 1e3:.1f} ms, "
          f"{sum(sizes) / total_s:.4g} rows/s; batch ms min/median/max "
          f"{min(map(sum, zip(*stage_ms.values()))):.2f}/"
          f"{float(np.median([sum(x) for x in zip(*stage_ms.values())])):.2f}/"
          f"{max(map(sum, zip(*stage_ms.values()))):.2f}")
    print(f"q1 sf10 result (SF10 merged, avg at scale 6): {json.dumps(final)}")
    print(f"q1 torch ops dispatched per batch: {json.dumps(q1_op_counts(tables[0]))}")
    profile_stage("q1 batch (4 Mi rows)", lambda: q1_run(tables[0]), top=10)
    print(f"q1 sf10 peak device memory: {torch.cuda.max_memory_allocated()} bytes "
          f"(batches resident: {data_bytes}); card: {card}", flush=True)
    return launches


HOWS = ("inner", "left", "right", "full", "left_semi", "left_anti")
JOIN_KEYS = {  # key layout -> (left_on, right_on) over join_spec's columns
    "int64": ([0], [0]),
    "string+int32": ([1, 4], [1, 4]),
    "float64": ([2], [2]),
    "decimal128": ([3], [3]),
}
M64 = (1 << 64) - 1


def string_column_spec(words):
    """Interop form of a STRING column holding ``words``."""
    enc = [w.encode() for w in words]
    offsets = np.concatenate([[0], np.cumsum([len(e) for e in enc])]).astype(np.int32)
    return {"dtype": ("string", 0, None, None), "validity": None, "offsets": offsets,
            "data": np.frombuffer(b"".join(enc), np.uint8).copy()}


def join_spec(n, seed, long_strings=False):
    """One side of the join phase in the interop form. Keys repeat ~8
    times (cross products) and are null in 10 % of rows: 0 INT64; 1
    STRING, with empty strings (``long_strings`` adds 20-byte keys, so
    the two sides' char matrices bucket to different widths); 2 FLOAT64
    with NaN, -0.0, 0.0 and infinities; 3 DECIMAL128(38,2) beyond 64
    bits; 4 INT32 in 0..3 (no nulls). Payloads: 5 STRING (20 % null),
    6 INT64 (no mask)."""
    rng = np.random.default_rng(seed)
    k = max(n // 8, 1)

    def col(spec, p_null):
        spec["validity"] = rng.random(n) >= p_null if p_null else None
        return spec

    draws = rng.integers(0, k, n)
    words = [str(x) for x in draws]
    for i in np.flatnonzero(rng.random(n) < 0.02):
        words[i] = ""
    if long_strings:
        for i in np.flatnonzero(rng.random(n) < 0.05):
            words[i] = f"long-key-{draws[i]:011d}"
    floats = rng.integers(-(k // 2), k // 2 + 1, n) / 4.0
    special, p = rng.random(n), max(0.002, 1.5 / n)  # a few of each even in small tables
    for i, v in enumerate((np.nan, -0.0, 0.0, np.inf, -np.inf)):
        floats[(special >= p * i) & (special < p * (i + 1))] = v
    dec = [int(x) * 10**20 for x in rng.integers(-(k // 2), k // 2 + 1, n)]
    limbs = np.array([[v & M64, (v >> 64) & M64] for v in dec], np.uint64).view(np.int64)
    payload = [f"payload-{x}" if x % 5 else "" for x in rng.integers(0, 1000, n)]

    def fixed(dt, data):
        return {"dtype": dt, "data": data, "validity": None, "offsets": None}

    return [
        col(fixed(("int", 64, None, None), draws.astype(np.int64)), 0.1),
        col(string_column_spec(words), 0.1),
        col(fixed(("float", 64, None, None), floats), 0.1),
        col(fixed(("decimal", 128, 38, 2), limbs), 0.1),
        fixed(("int", 32, None, None), rng.integers(0, 4, n).astype(np.int32)),
        col(string_column_spec(payload), 0.2),
        fixed(("int", 64, None, None), rng.integers(-(2**62), 2**62, n)),
    ]


def join_results(left, right, occ_l, occ_r):
    """Every join of the card-vs-CPU phase over one device's tables:
    name -> (Table, occupied mask or None). All six hows through ``join``
    and ``join_padded`` for each key layout of ``JOIN_KEYS`` and for an
    empty side; ``join_padded`` with occupied masks on both sides; and a
    ``join_padded`` whose capacity truncates."""
    from spark_rapids_jni_tpu_torch.api import Join
    from spark_rapids_jni_tpu_torch.ops.join import join_padded
    from spark_rapids_jni_tpu_torch.ops.sort import gather

    none = torch.zeros(0, dtype=torch.int64, device=occ_l.device)
    out = {}
    layouts = [(label, left, right, keys) for label, keys in JOIN_KEYS.items()]
    layouts += [("empty left", gather(left, none), right, JOIN_KEYS["int64"]),
                ("empty right", left, gather(right, none), JOIN_KEYS["int64"])]
    for label, lt, rt, (lk, rk) in layouts:
        for how in HOWS:
            j = Join.join(lt, rt, lk, rk, how)
            out[f"join {label} {how}"] = (j, None)
            out[f"join_padded {label} {how}"] = join_padded(lt, rt, lk, rk, j.num_rows + 16, how)
            if label == "int64":
                out[f"join_padded {label} {how} occupied"] = join_padded(
                    lt, rt, lk, rk, j.num_rows + 16, how, occ_l, occ_r)
    inner = out["join int64 inner"][0].num_rows
    tbl, occ, needed = join_padded(left, right, [0], [0], inner // 2, "inner", with_stats=True)
    if int(needed) != inner:
        raise AssertionError(f"join_padded needed {int(needed)} rows, join gave {inner}")
    out["join_padded int64 inner truncated"] = (tbl, occ)
    return out


def join_card_vs_cpu(n):
    """The join phase: ``join_results`` on the card and on the CPU over
    the same inputs; every output column and occupied mask must be
    equal."""
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy, table_to_numpy

    specs = (join_spec(n, 21), join_spec(n, 22, long_strings=True))
    rng = np.random.default_rng(23)
    occ = (rng.random(n) < 0.8, rng.random(n) < 0.8)
    t0 = time.perf_counter()
    results = {}
    for dev in ("cuda", "cpu"):
        lt, rt = (table_from_numpy(s, device=dev) for s in specs)
        masks = [torch.from_numpy(o).to(dev) for o in occ]
        res = join_results(lt, rt, *masks)
        results[dev] = {k: (table_to_numpy(t), None if o is None else o.cpu().numpy())
                        for k, (t, o) in res.items()}
    for name, (want, want_occ) in results["cpu"].items():
        got, got_occ = results["cuda"][name]
        if len(got) != len(want) or not same_array(got_occ, want_occ):
            raise AssertionError(f"join card vs cpu [{name}]: columns or occupied mask differ")
        for i, (g, w) in enumerate(zip(got, want)):
            for key in ("data", "validity", "offsets"):
                if not same_array(g[key], w[key]):
                    raise AssertionError(f"join card vs cpu [{name}]: column {i} {key} differs")
    print(f"join card vs cpu: {len(results['cpu'])} joins exact at {n} rows a side in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---- TPC-H q5 (BASELINE.md config 3, on one card) ----

Q5_REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
Q5_NATIONS = (  # TPC-H clause 4.2.3: (n_name, n_regionkey); n_nationkey is the index
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
)
Q5_REGION = "ASIA"
Q5_DATE_LO, Q5_DATE_HI = 8766, 9131  # [1994-01-01, 1995-01-01), days since epoch
Q5_SF10 = {"n_supp": 100_000, "n_cust": 1_500_000, "n_ord": 15_000_000}
Q5_BATCH = 1 << 22  # 4 Mi lineitem rows, the q1 chunk
Q5_STAGES = ("build", "join_orders", "join_supplier", "decimal", "group_by", "merge+sort")


def q5_data(n_supp, n_cust, n_ord, seed=5):
    """TPC-H q5's columns with dbgen's shapes (clause 4.2), drawn on the
    host from ``seed``: sparse order keys (8 of every 32), customer keys
    off multiples of 3, order dates in [1992-01-01, 1998-08-02], 1-7
    lines per order, l_extendedprice = quantity (1-50) x a retail price
    in [900.00, 2098.99], discount 0.00-0.10; DECIMAL(12,2) as unscaled
    int64."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_ord)
    active = rng.integers(0, n_cust - n_cust // 3, n_ord)
    orderkey = 32 * (i // 8) + i % 8 + 1
    lines = rng.integers(1, 8, n_ord)
    l_orderkey = np.repeat(orderkey, lines)
    n_li = len(l_orderkey)
    return {
        "s_nationkey": rng.integers(0, 25, n_supp),
        "c_nationkey": rng.integers(0, 25, n_cust),
        "o_orderkey": orderkey,
        "o_custkey": 3 * (active // 2) + active % 2 + 1,
        "o_orderdate": rng.integers(8035, 10441, n_ord).astype(np.int32),
        "l_orderkey": l_orderkey,
        "l_suppkey": rng.integers(1, n_supp + 1, n_li),
        "l_extendedprice": rng.integers(1, 51, n_li) * rng.integers(90_000, 209_900, n_li),
        "l_discount": rng.integers(0, 11, n_li),
    }


def q5_tables(d, device, batch=Q5_BATCH):
    """The q5 tables on ``device``; lineitem as a list of tables of at
    most ``batch`` rows."""
    from spark_rapids_jni_tpu_torch import DATE32, DECIMAL64, INT64, STRING, Column, Table

    def put(a, dt=INT64):
        return Column(dt, torch.from_numpy(np.ascontiguousarray(a)).to(device))

    dec = DECIMAL64(12, 2)
    n_li = len(d["l_orderkey"])
    return {
        "region": Table([put(np.arange(5)),
                         Column.from_pylist(list(Q5_REGIONS), STRING, device=device)]),
        "nation": Table([put(np.arange(25)),
                         Column.from_pylist([nm for nm, _ in Q5_NATIONS], STRING, device=device),
                         put(np.array([r for _, r in Q5_NATIONS]))]),
        "supplier": Table([put(np.arange(1, len(d["s_nationkey"]) + 1)), put(d["s_nationkey"])]),
        "customer": Table([put(np.arange(1, len(d["c_nationkey"]) + 1)), put(d["c_nationkey"])]),
        "orders": Table([put(d["o_orderkey"]), put(d["o_custkey"]),
                         put(d["o_orderdate"], DATE32)]),
        "lineitem": [
            Table([put(d["l_orderkey"][lo:lo + batch]), put(d["l_suppkey"][lo:lo + batch]),
                   put(d["l_extendedprice"][lo:lo + batch], dec),
                   put(d["l_discount"][lo:lo + batch], dec)])
            for lo in range(0, n_li, batch)
        ],
    }


def string_equals(col, literal):
    """bool [n]: the string column equals ``literal`` (nulls: False),
    over its padded char matrix."""
    from spark_rapids_jni_tpu_torch.columnar.strings import to_char_matrix

    chars, _lengths = to_char_matrix(col)
    lit = list(literal.encode())
    if len(lit) > chars.shape[1]:
        return torch.zeros(chars.shape[0], dtype=torch.bool, device=chars.device)
    want = torch.full((chars.shape[1],), -1, dtype=chars.dtype, device=chars.device)
    want[: len(lit)] = torch.tensor(lit, dtype=chars.dtype)
    return (chars == want).all(dim=1) & col.validity_or_true()


def q5_build(t, tick=None):
    """q5's build side, once per query: ASIA's nations, their customers,
    the orders of 1994 joined to them. Returns the intermediate tables;
    ``build`` is (o_orderkey, c_nationkey, n_name)."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.api import Filter, Join

    region = t["region"]
    asia = Filter.apply(region, string_equals(region.columns[1], Q5_REGION))
    # n_nationkey, n_name, n_regionkey, r_regionkey, r_name
    nations = Join.join(t["nation"], asia, [2], [0])
    # c_custkey, c_nationkey + nations' columns
    cust = Join.join(t["customer"], nations, [1], [0])
    cust = Table([cust.columns[0], cust.columns[1], cust.columns[3]])
    date = t["orders"].columns[2].data
    orders = Filter.apply(t["orders"], (date >= Q5_DATE_LO) & (date < Q5_DATE_HI))
    # o_orderkey, o_custkey, o_orderdate, c_custkey, c_nationkey, n_name
    oc = Join.join(orders, cust, [1], [0])
    build = Table([oc.columns[0], oc.columns[4], oc.columns[5]])
    if tick:
        tick("build")
    return {"asia": asia, "nations": nations, "customers": cust, "orders": orders,
            "build": build}


def q5_batch(li, build, supplier, tick=None):
    """q5 over one lineitem batch: join the build on l_orderkey, join
    supplier on (l_suppkey, c_nationkey), revenue, sum by n_name.
    Returns the intermediate tables; ``partial`` is (n_name, revenue)."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.api import Aggregation, Join

    tick = tick or (lambda stage: None)
    # l_orderkey, l_suppkey, l_extendedprice, l_discount, o_orderkey, c_nationkey, n_name
    j1 = Join.join(li, build, [0], [0])
    tick("join_orders")
    # + s_suppkey, s_nationkey
    j2 = Join.join(j1, supplier, [1, 5], [0, 1])
    tick("join_supplier")
    revenue = disc_price(j2.columns[2].data, j2.columns[3].data)
    tick("decimal")
    partial = Aggregation.groupBy(Table([j2.columns[6], revenue.columns[1]]), [0],
                                  [Aggregation.Agg("sum", 1)])
    tick("group_by")
    return {"join_orders": j1, "join_supplier": j2, "revenue": revenue, "partial": partial}


def concat_tables(tables):
    """Rows of ``tables`` (one schema, exact string payloads) in order."""
    from spark_rapids_jni_tpu_torch import Column, Table

    cols = []
    for parts in zip(*(t.columns for t in tables)):
        offsets = None
        if parts[0].is_varlen:
            offs, base = [parts[0].offsets[:1]], 0
            for c in parts:
                offs.append(c.offsets[1:] + base)
                base += c.data.shape[0]
            offsets = torch.cat(offs)
        cols.append(Column(parts[0].dtype, torch.cat([c.data for c in parts]),
                           torch.cat([c.validity_or_true() for c in parts]), offsets))
    return Table(cols)


def q5_merge(partials, tick=None):
    """Sum the batches' partial rows by n_name, ORDER BY revenue DESC."""
    from spark_rapids_jni_tpu_torch.api import Aggregation, SortOrder

    g = Aggregation.groupBy(concat_tables(partials), [0], [Aggregation.Agg("sum", 1)])
    out = SortOrder.sort(g, [SortOrder.SortKey(1, ascending=False)])
    if tick:
        tick("merge+sort")
    return out


def q5_oracle(d, lo=0, hi=None):
    """Exact q5 revenue (scale 4) by n_name over lineitem rows [lo, hi),
    numpy int64 on the host (a 4 Mi-row batch sums below 4.4e15)."""
    l_orderkey = d["l_orderkey"][lo:hi]
    k = l_orderkey - 1
    order = (k // 32) * 8 + k % 32  # o_orderkey = 32 * (i // 8) + i % 8 + 1
    date = d["o_orderdate"][order]
    c_nat = d["c_nationkey"][d["o_custkey"][order] - 1]
    s_nat = d["s_nationkey"][d["l_suppkey"][lo:hi] - 1]
    region = np.array([r for _, r in Q5_NATIONS])[c_nat]
    keep = ((date >= Q5_DATE_LO) & (date < Q5_DATE_HI) & (c_nat == s_nat)
            & (region == Q5_REGIONS.index(Q5_REGION)))
    revenue = d["l_extendedprice"][lo:hi] * (100 - d["l_discount"][lo:hi])
    out = {}
    for nk in np.unique(c_nat[keep]):
        out[Q5_NATIONS[nk][0]] = int(revenue[keep & (c_nat == nk)].sum())
    return out


def q5_rows(out):
    """(n_name, revenue) rows of a q5 result table as Python values."""
    return [tuple(r) for r in zip(*out.to_pylists())]


def q5_final_rows(revenue_by_name):
    """q5's final ORDER BY revenue DESC over exact sums (ties keep
    n_name order, as the stable sort over the group-by output does)."""
    return sorted(revenue_by_name.items(), key=lambda kv: (-kv[1], kv[0]))


def q5_sf10(counters, card):
    """The q5 path at SF10: tables drawn on the host and copied to the
    card, the query timed stage by stage, every batch's partial result
    and the final rows held against the host oracle."""
    t0 = time.perf_counter()
    d = q5_data(**Q5_SF10)
    gen_s = time.perf_counter() - t0
    n_li = len(d["l_orderkey"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = q5_tables(d, "cuda")
    torch.cuda.synchronize()
    data_bytes = torch.cuda.memory_allocated() - base
    print(f"q5 data: lineitem {n_li} rows in {len(t['lineitem'])} batches, orders "
          f"{len(d['o_orderkey'])}, customer {len(d['c_nationkey'])}, supplier "
          f"{len(d['s_nationkey'])}; drawn in {gen_s:.1f} s, {data_bytes} bytes on the card",
          flush=True)

    warm = q5_build(t)  # warm-up: first launches of every op, outside the timing
    q5_batch(t["lineitem"][0], warm["build"], t["supplier"])
    torch.cuda.synchronize()
    del warm
    for name in counters:
        counters[name].launches = 0
    stage_ms = {s: [] for s in Q5_STAGES}
    last = [time.perf_counter()]

    def tick(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_ms[stage].append((now - last[0]) * 1e3)
        last[0] = now

    start = last[0]
    built = q5_build(t, tick)
    parts = [q5_batch(li, built["build"], t["supplier"], tick) for li in t["lineitem"]]
    final = q5_merge([p["partial"] for p in parts], tick)
    total_s = last[0] - start
    launches = {name: c.launches for name, c in counters.items()}

    for i, p in enumerate(parts):
        if bool(p["revenue"].columns[0].data.any()):
            raise AssertionError(f"q5 batch {i}: a revenue product overflowed")
        want = sorted(q5_oracle(d, i * Q5_BATCH, (i + 1) * Q5_BATCH).items())
        if q5_rows(p["partial"]) != want:
            raise AssertionError(f"q5 batch {i}: partial result differs from the host oracle")
    want_final = q5_final_rows(q5_oracle(d))
    if q5_rows(final) != want_final or len(want_final) != 5:
        raise AssertionError(f"q5 final differs from the host oracle: {q5_rows(final)}")

    med = {s: float(np.median(v)) for s, v in stage_ms.items()}
    b = built
    print(f"q5 sf10: build rows asia {b['asia'].num_rows}, nations {b['nations'].num_rows}, "
          f"customers {b['customers'].num_rows}, orders of 1994 {b['orders'].num_rows}, "
          f"build {b['build'].num_rows}; batch 0 rows after join_orders "
          f"{parts[0]['join_orders'].num_rows}, after join_supplier "
          f"{parts[0]['join_supplier'].num_rows}")
    print(f"q5 sf10: {len(parts)} batch partials and the final rows exact against the host "
          f"oracle; kernel launches on the q5 path {json.dumps(launches)}")
    print(f"q5 sf10 per-stage ms (build and merge+sort once, the rest median over batches): "
          f"{json.dumps(med)}")
    print(f"q5 SF10 lineitem rows/s: {n_li / total_s:.4g} ({n_li} rows in "
          f"{total_s * 1e3:.1f} ms, build to final sort)")
    print(f"q5 sf10 result (revenue at scale 4): {json.dumps(q5_rows(final))}")
    li0 = t["lineitem"][0]
    counts = op_counts(lambda tick: q5_batch(li0, built["build"], t["supplier"], tick))
    print(f"q5 torch ops dispatched per batch: {json.dumps(counts)}")
    profile_stage("q5 batch (4 Mi rows)", lambda: q5_batch(li0, built["build"], t["supplier"]),
                  top=10)
    print(f"q5 sf10 peak device memory: {torch.cuda.max_memory_allocated()} bytes "
          f"(tables resident: {data_bytes}); card: {card}", flush=True)
    ctx = {"build": built["build"], "supplier": t["supplier"], "lineitem0": li0,
           "partial0": parts[0]["partial"], "want0": sorted(q5_oracle(d, 0, Q5_BATCH).items()),
           "tables": t, "data": d, "rows_per_s": n_li / total_s}
    return launches, ctx


def host_codec(spec, rows, card):
    """The host JCUDF codec over the rung-1 lineitem batch: its rows must
    equal the card's convertToRows bytes, and its decode must give the
    columns back."""
    from spark_rapids_jni_tpu_torch.columnar.dtypes import DType
    from spark_rapids_jni_tpu_torch.ops import row_conversion_host as host
    from spark_rapids_jni_tpu_torch.ops.row_conversion import row_batch_bytes

    dtypes = [DType(*s["dtype"]) for s in spec]
    datas = [s["data"] for s in spec]
    times = {"encode": [], "decode": []}
    for _ in range(3):
        t0 = time.perf_counter()
        host_rows = host.encode_rows(datas, dtypes)
        t1 = time.perf_counter()
        back, valids = host.decode_rows(host_rows, dtypes)
        times["encode"].append((t1 - t0) * 1e3)
        times["decode"].append((time.perf_counter() - t1) * 1e3)
    card_rows = np.concatenate([row_batch_bytes(r) for r in rows])
    if host_rows.tobytes() != card_rows.tobytes():
        raise AssertionError("host JCUDF rows differ from the card's convertToRows bytes")
    for i, (d, b, v) in enumerate(zip(datas, back, valids)):
        if not np.array_equal(d, b) or not v.all():
            raise AssertionError(f"host JCUDF decode differs at column {i}")
    n = len(datas[0])
    ms = {k: float(np.median(v)) for k, v in times.items()}
    print(f"host codec: {n} rows x {host_rows.shape[1]} B byte-exact against the card's "
          f"convertToRows, decode exact; host ms (median of 3) {json.dumps(ms)}; card: {card}",
          flush=True)


# ---- casts, JSON and store_sales (BASELINE.md config 4) ----

INT_CASES = [
    "0", "-0", "+7", "  42 ", "\t-13\n", " 5", "5 ", "1.5", "-1.9", "7.", ".", "", " ", "+",
    "-", "1e3", "12a", "a12", "1 2", "12é", "١٢", "--1", "+-1", "0x1F", "000000000000000000000012",
    "127", "128", "-128", "-129", "32767", "32768", "-32768", "-32769",
    "2147483647", "2147483648", "-2147483648", "-2147483649",
    "9223372036854775807", "9223372036854775808", "-9223372036854775808",
    "-9223372036854775809", "99999999999999999999", "  -00012.999  ",
]
DEC_CASES = [
    "1.235", "1.234", "-1.235", "1.245", "0.005", "-0.005", "0.004", "1.2E+3", "-5e-3", "1e2",
    "2.5e-1", ".5", "5.", "-.5", "+.25", "1e", "1e+", "e5", "1.2.3", "1,000", "12345678.9",
    "1234567.891", "9999999.995", "9999999.994", "99999999999999999999.5", "1.5e10", "  3.14  ",
    "3.14 x", "", " ", "0e0", "1E-40", "123456789012345678901234567890.12345", "-0.0000000001",
    "0.00000000000000000000000000000000000000001", "12345678901234567890123456789012345678",
    "1e37", "1e38", "-1e-10", "99999999999999.99995", "١.٥", "1é", "00001.50000",
]
JSON_DOCS = [
    '{"channel": "web", "coupon": {"code": "C012"}, "promo": true, "items": [1, "two", {"k": [3, 4]}]}',
    '{"promo":false,"channel":"store","items":[],"coupon":{"code":"C\\u00e9"}}',
    '  { "channel" : "catalog" , "items" : [ 10 , 20 , [ 30 ] ] , "promo" : null }  ',
    '{"channel": "w\\"eb", "coupon": {"code": "a\\\\b\\/c\\nd"}, "promo": "yes"}',
    '{"channel": "\\ud83d\\ude00", "items": [{"a": 1}, {"b": [1, 2]}, "x"]}',
    '{"channel": "\\u00e9t\\u00e9", "coupon": {"code": 7.5e2}, "items": [true, false]}',
    '{"channel": "é", "coupon": null, "promo": {"pct": 10, "tags": ["a", "b"]}}',
    '{"promo": 1, "channel": "dup1", "channel": "dup2", "items": [ "x" , "y" ]}',
    '{"channel": "web"',
    'not json',
    '[1, 2, 3]',
    '{"channel": web}',
    '"just a string"',
    '{"coupon": {"code": "C001", "extra": {"deep": [1, {"z": "\\t"}]}}, "channel": "store"}',
    '{"items": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], '
    '"channel": "web", "coupon": {"code": "LONGCODE-0123456789"}}',
    '{"coupon": {"code": "C777", "note": "a long note, long enough to push the document past '
    '128 bytes and so its char matrix to the next bucket"}, "channel": "catalog", "items": [0], '
    '"memo": "and a top-level memo past 256 bytes, where the lane scans give way to the '
    'torch scans"}',
]
JSON_PATHS = ["$.channel", "$.coupon.code", "$['promo']", "$.items[1]", "$.items[2]",
              "$.coupon", "$.items", "$.missing", "$.items[9]", "$[1]"]
CAST_DECIMALS = ((9, 2), (18, 4), (38, 10))


def string_spec_from_list(values, rng=None, p_null=0.0):
    """Interop form of a STRING column holding ``values`` (None: null),
    a share ``p_null`` of rows nulled besides."""
    valid = np.array([v is not None for v in values])
    if p_null:
        valid &= rng.random(len(values)) >= p_null
    spec = string_column_spec(["" if v is None else v for v in values])
    spec["validity"] = None if valid.all() else valid
    return spec


def cast_json_spec(n, seed=11):
    """Three STRING columns in the interop form, ``n`` rows each, drawn
    from the hand-made cases above and random values, with nulls:
    0 integer strings, 1 decimal strings, 2 JSON documents (one longer
    than 256 bytes, so the char matrix buckets to 512, past the width
    ``segmented.LANE_SCAN_MAX_L`` where the lane scans give way to
    torch's), 3 the same documents with every one longer than 64 bytes
    replaced (bucket 64, the lane scans)."""
    rng = np.random.default_rng(seed)
    ws = np.array(["", " ", "  ", "\t", "\n", "\r"])

    def pick(cases, random_values):
        take = rng.random(n) < 0.5
        case = np.array(cases, dtype=object)[rng.integers(0, len(cases), n)]
        return [c if t else r for c, t, r in zip(case, take, random_values)]

    ints = [f"{ws[a]}{v}{ws[b]}" for a, b, v in zip(
        rng.integers(0, 6, n), rng.integers(0, 6, n), rng.integers(-(10**12), 10**12, n))]
    mant = rng.integers(0, 10**12, n)
    frac = rng.integers(0, 10**6, n)
    exps = rng.integers(-12, 12, n)
    decs = [
        f"{'-' if s else ''}{m}.{f:06d}" + (f"e{e}" if k else "")
        for s, m, f, e, k in zip(rng.random(n) < 0.5, mant % 10 ** rng.integers(1, 13, n), frac,
                                 exps, rng.random(n) < 0.2)
    ]
    docs = [
        f'{{"channel": "{c}", "coupon": {{"code": "C{k:03d}"}}, "promo": {p}}}'
        for c, k, p in zip(np.array(["web", "store", "catalog"])[rng.integers(0, 3, n)],
                           rng.integers(0, 1000, n),
                           np.array(["true", "false"])[rng.integers(0, 2, n)])
    ]
    docs = pick(JSON_DOCS, docs)
    short = [d if len(d.encode()) <= 64 else '{"channel": "store"}' for d in docs]
    return [
        string_spec_from_list(pick(INT_CASES, ints), rng, 0.05),
        string_spec_from_list(pick(DEC_CASES, decs), rng, 0.05),
        string_spec_from_list(docs, rng, 0.05),
        string_spec_from_list(short, rng, 0.05),
    ]


def cast_json_ops(t):
    """Every cast and JSON path of phase 11 over one device's table:
    name -> Column."""
    from spark_rapids_jni_tpu_torch.api import CastStrings, JSONUtils
    from spark_rapids_jni_tpu_torch.columnar.dtypes import DType
    from spark_rapids_jni_tpu_torch.ops.cast_string import string_to_decimal, string_to_integer
    from spark_rapids_jni_tpu_torch.ops.get_json_object import get_json_object

    c = t.columns
    out = {}
    max_int = int(c[0].string_lengths().max())
    for bits in (8, 16, 32, 64):
        dt = DType("int", bits)
        out[f"toInteger INT{bits}"] = CastStrings.toInteger(c[0], False, True, dt)
    out["toInteger INT32 no strip"] = CastStrings.toInteger(c[0], False, False, DType("int", 32))
    out[f"toInteger INT64 width {max_int}"] = string_to_integer(
        c[0], DType("int", 64), strip=True, width=max_int)
    for p, s in CAST_DECIMALS:
        out[f"toDecimal ({p},{s})"] = CastStrings.toDecimal(c[1], False, True, p, s)
    out["toDecimal (9,2) no strip"] = CastStrings.toDecimal(c[1], False, False, 9, 2)
    out["toDecimal (38,10) width 64"] = string_to_decimal(c[1], 38, 10, strip=True, width=64)
    for col, label in ((2, "bucket 512"), (3, "bucket 64")):
        for path in JSON_PATHS:
            out[f"getJsonObject {path} {label}"] = JSONUtils.getJsonObject(c[col], path)
    out["get_json_object $.channel width 512 out_width 512"] = get_json_object(
        c[2], "$.channel", width=512, out_width=512)
    return out


def ansi_errors(t):
    """(row, string) of the CastException each ANSI-mode cast raises."""
    from spark_rapids_jni_tpu_torch.api import CastStrings
    from spark_rapids_jni_tpu_torch.columnar.dtypes import DType
    from spark_rapids_jni_tpu_torch.runtime.errors import CastException

    got = {}
    for name, cast in (
        ("toInteger INT32", lambda: CastStrings.toInteger(t.columns[0], True, True,
                                                           DType("int", 32))),
        ("toDecimal (9,2)", lambda: CastStrings.toDecimal(t.columns[1], True, True, 9, 2)),
    ):
        try:
            cast()
        except CastException as e:
            got[name] = (e.row_with_error, e.string_with_error)
        else:
            raise AssertionError(f"ANSI {name} raised no CastException")
    return got


def cast_json_card_vs_cpu(n):
    """Phase 11: the casts and get_json_object on the card and on the CPU
    over one mixed batch; data, string bytes, offsets and validity (as
    ``validity_or_true()``) must be equal, and the ANSI casts must raise
    the same CastException."""
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy

    spec = cast_json_spec(n)
    t0 = time.perf_counter()
    results, errors = {}, {}
    for dev in ("cuda", "cpu"):
        t = table_from_numpy(spec, device=dev)
        res = cast_json_ops(t)
        results[dev] = {
            k: (c.data.cpu().numpy(), c.validity_or_true().cpu().numpy(),
                None if c.offsets is None else c.offsets.cpu().numpy(), c.dtype)
            for k, c in res.items()
        }
        errors[dev] = ansi_errors(t)
    nulls = {}
    for name, want in results["cpu"].items():
        got = results["cuda"][name]
        if got[3] != want[3]:
            raise AssertionError(f"cast/json card vs cpu [{name}]: dtype {got[3]} != {want[3]}")
        for i, key in enumerate(("data", "validity", "offsets")):
            if not same_array(got[i], want[i]):
                raise AssertionError(f"cast/json card vs cpu [{name}]: {key} differs")
        nulls[name] = int((~want[1]).sum())
    if errors["cuda"] != errors["cpu"]:
        raise AssertionError(f"ANSI errors differ: card {errors['cuda']}, cpu {errors['cpu']}")
    print(f"cast/json card vs cpu: {len(nulls)} results exact at {n} rows in "
          f"{time.perf_counter() - t0:.1f} s; ANSI errors equal {json.dumps(errors['cpu'])}; "
          f"null rows {json.dumps(nulls)}", flush=True)


# ---- store_sales at SF10 (benchmarks/sf10_store_sales.py) ----

SS_ROWS = 28_800_000  # SF10 store_sales
SS_RG = 1 << 21  # 2 Mi-row row groups
SS_STORES = 64  # ss_store_sk drawn from [1, 64)
SS_CHANNELS = ("web", "store", "catalog")
SS_WIDTHS = (8, 8, 48)  # the benchmark's CAPS for columns 1-3
SS_STAGES = ("decode", "h2d", "cast_integer", "cast_decimal", "get_json_object", "filter",
             "group_by")


def ss_gen_chunk(n, seed):
    """One row group of sf10_store_sales.py's gen_chunk (:92-108): the
    same generator, seed and order of draws."""
    rng = np.random.default_rng(seed)
    store = rng.integers(1, SS_STORES, n).astype(np.int32)
    qty_i = rng.integers(1, 100, n)
    price_u = rng.integers(1, 500, n)
    price_f = rng.integers(0, 100, n)
    chan = rng.integers(0, 3, n)
    return {"store": store, "qty_i": qty_i, "price_u": price_u, "price_f": price_f,
            "chan": chan, "cents": price_u * 100 + price_f}


def ss_oracle(g):
    """Per-store [sum(cents), count] over the web rows of one generated
    chunk (sf10_store_sales.py:132-141): {store: (cents, count)}."""
    web = g["chan"] == 0
    s = g["store"][web]
    cents = np.bincount(s, weights=g["cents"][web], minlength=SS_STORES)
    counts = np.bincount(s, minlength=SS_STORES)
    return {k: (int(cents[k]), int(counts[k])) for k in np.flatnonzero(counts)}


# -- a minimal Parquet writer (thrift compact footer, dictionary pages,
# RLE_DICTIONARY v1 data pages, literal-only snappy), for test data --

_T_I32, _T_I64, _T_BINARY, _T_LIST, _T_STRUCT = 5, 6, 8, 9, 12


def _uvarint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zz(v):
    return (v << 1) ^ (v >> 63)


def _tval(ttype, v):
    if ttype in (_T_I32, _T_I64):
        return _uvarint(_zz(v))
    if ttype == _T_BINARY:
        b = v.encode() if isinstance(v, str) else v
        return _uvarint(len(b)) + b
    return v  # an encoded struct or list


def _tstruct(fields):
    """Thrift compact struct of (field id, type, value), ids ascending."""
    out, last = bytearray(), 0
    for fid, ttype, v in fields:
        delta = fid - last
        out += bytes([(delta << 4) | ttype]) if 0 < delta <= 15 else (
            bytes([ttype]) + _uvarint(_zz(fid)))
        out += _tval(ttype, v)
        last = fid
    return bytes(out + b"\0")


def _tlist(etype, values):
    n = len(values)
    head = bytes([(n << 4) | etype]) if n < 15 else bytes([0xF0 | etype]) + _uvarint(n)
    return head + b"".join(_tval(etype, v) for v in values)


def snappy_literal(payload):
    """A raw snappy block of one literal element."""
    n = len(payload)
    if n == 0:
        return _uvarint(0)
    if n <= 60:
        tag = bytes([(n - 1) << 2])
    else:
        tag = bytes([63 << 2]) + (n - 1).to_bytes(4, "little")
    return _uvarint(n) + tag + payload


def rle_bitpacked(indices, bit_width):
    """One bit-packed run of the RLE/bit-packed hybrid."""
    groups = -(-len(indices) // 8)
    pad = np.zeros(groups * 8, "<u4")
    pad[: len(indices)] = indices
    bits = np.unpackbits(pad.view(np.uint8).reshape(-1, 4), axis=1, bitorder="little")
    return _uvarint((groups << 1) | 1) + np.packbits(
        bits[:, :bit_width].reshape(-1), bitorder="little").tobytes()


class ParquetWriter:
    """Writes REQUIRED INT32 and UTF8 BYTE_ARRAY columns as pyarrow's
    defaults do for this schema: per column chunk a PLAIN dictionary page
    then v1 data pages of RLE_DICTIONARY indices, SNAPPY pages (literal
    runs) and a thrift-compact footer."""

    PAGE_ROWS = 1 << 17

    def __init__(self, path, schema):
        self.f = open(path, "wb")
        self.f.write(b"PAR1")
        self.schema = schema  # [(name, "int32" | "string")]
        self.row_groups = []
        self.num_rows = 0

    def _page(self, header, payload):
        comp = snappy_literal(payload)
        head = _tstruct([(1, _T_I32, header[0]), (2, _T_I32, len(payload)),
                         (3, _T_I32, len(comp)), header[1]])
        self.f.write(head + comp)
        return len(head) + len(payload), len(head) + len(comp)

    def _chunk(self, name, kind, dictionary, indices):
        start = self.f.tell()
        if kind == "int32":
            plain = np.asarray(dictionary, "<i4").tobytes()
        else:
            plain = b"".join(len(b).to_bytes(4, "little") + b for b in dictionary)
        unc, comp = self._page((2, (7, _T_STRUCT, _tstruct(
            [(1, _T_I32, len(dictionary)), (2, _T_I32, 0)]))), plain)
        data_off = self.f.tell()
        bw = max(int(len(dictionary) - 1).bit_length(), 1)
        for lo in range(0, len(indices), self.PAGE_ROWS):
            part = indices[lo:lo + self.PAGE_ROWS]
            u, c = self._page((0, (5, _T_STRUCT, _tstruct(
                [(1, _T_I32, len(part)), (2, _T_I32, 8), (3, _T_I32, 3), (4, _T_I32, 3)]))),
                bytes([bw]) + rle_bitpacked(part, bw))
            unc, comp = unc + u, comp + c
        meta = _tstruct([
            (1, _T_I32, 1 if kind == "int32" else 6),
            (2, _T_LIST, _tlist(_T_I32, [0, 3, 8])),
            (3, _T_LIST, _tlist(_T_BINARY, [name])),
            (4, _T_I32, 1),  # SNAPPY
            (5, _T_I64, len(indices)),
            (6, _T_I64, unc),
            (7, _T_I64, comp),
            (9, _T_I64, data_off),
            (11, _T_I64, start),
        ])
        return _tstruct([(2, _T_I64, start), (3, _T_STRUCT, meta)]), start, comp, unc

    def write_row_group(self, columns, n):
        """``columns``: per schema column (dictionary values, int32 [n]
        indices); string dictionaries are lists of bytes."""
        chunks = [self._chunk(name, kind, d, idx)
                  for (name, kind), (d, idx) in zip(self.schema, columns)]
        self.row_groups.append(_tstruct([
            (1, _T_LIST, _tlist(_T_STRUCT, [c[0] for c in chunks])),
            (2, _T_I64, sum(c[3] for c in chunks)),
            (3, _T_I64, n),
            (5, _T_I64, chunks[0][1]),
            (6, _T_I64, sum(c[2] for c in chunks)),
        ]))
        self.num_rows += n

    def close(self):
        schema = [_tstruct([(4, _T_BINARY, "schema"), (5, _T_I32, len(self.schema))])]
        for name, kind in self.schema:
            fields = [(1, _T_I32, 1 if kind == "int32" else 6), (3, _T_I32, 0),
                      (4, _T_BINARY, name)]
            if kind == "string":
                fields.append((6, _T_I32, 0))  # UTF8
            schema.append(_tstruct(fields))
        footer = _tstruct([
            (1, _T_I32, 1),
            (2, _T_LIST, _tlist(_T_STRUCT, schema)),
            (3, _T_I64, self.num_rows),
            (4, _T_LIST, _tlist(_T_STRUCT, self.row_groups)),
            (6, _T_BINARY, "spark_rapids_jni_tpu_torch chip_smoke"),
        ])
        self.f.write(footer + len(footer).to_bytes(4, "little") + b"PAR1")
        self.f.close()


SS_SCHEMA = [("ss_store_sk", "int32"), ("ss_quantity_str", "string"),
             ("ss_sales_price_str", "string"), ("ss_attrs_json", "string")]


def dense_dictionary(keys):
    """(distinct keys ascending, int32 index of each row's key) of
    small non-negative integer keys."""
    present = np.zeros(int(keys.max()) + 1, bool)
    present[keys] = True
    remap = np.cumsum(present, dtype=np.int32) - 1
    return np.flatnonzero(present), remap[keys]


def ss_dictionary_columns(g):
    """The four columns of one generated chunk as (dictionary, indices):
    each string dictionary is built from its distinct keys with the same
    formatter as sf10_store_sales.py builds the rows."""
    keys, idx = dense_dictionary(g["store"])
    out = [(keys.astype(np.int32), idx)]
    for key, fmt in (
        (g["qty_i"], lambda k: [f"  {v} ".encode() for v in k]),
        (g["cents"], lambda k: [f"{v // 100}.{v % 100:02d}".encode() for v in k]),
        (g["chan"], lambda k: [f'{{"promo": false, "channel": "{SS_CHANNELS[v]}"}}'.encode()
                               for v in k]),
    ):
        keys, idx = dense_dictionary(key)
        out.append((fmt(keys.tolist()), idx))
    return out


def write_store_sales(path, rows, rg_rows):
    """Generate store_sales row group by row group (seeds 1000 + g) into
    a Parquet file; returns the per-row-group oracles."""
    w = ParquetWriter(path, SS_SCHEMA)
    oracles = []
    for g, lo in enumerate(range(0, rows, rg_rows)):
        n = min(rg_rows, rows - lo)
        chunk = ss_gen_chunk(n, 1000 + g)
        w.write_row_group(ss_dictionary_columns(chunk), n)
        oracles.append(ss_oracle(chunk))
    w.close()
    return oracles


def ss_chain(t, tick=None):
    """The eager store_sales query of sf10_store_sales.py:146-164 over one
    row group through the port's façade: casts, get_json_object, filter
    channel == "web" with a valid price, group by store: sum and count
    of the price."""
    from spark_rapids_jni_tpu_torch import INT32, Table
    from spark_rapids_jni_tpu_torch.api import Aggregation, Filter
    from spark_rapids_jni_tpu_torch.ops.cast_string import string_to_decimal, string_to_integer
    from spark_rapids_jni_tpu_torch.ops.get_json_object import get_json_object

    tick = tick or (lambda stage: None)
    c = t.columns
    qty = string_to_integer(c[1], INT32, strip=True, width=SS_WIDTHS[0])
    tick("cast_integer")
    price = string_to_decimal(c[2], 9, 2, strip=True, width=SS_WIDTHS[1])
    tick("cast_decimal")
    channel = get_json_object(c[3], "$.channel", width=SS_WIDTHS[2])
    tick("get_json_object")
    keep = string_equals(channel, "web") & price.validity_or_true()
    web = Filter.apply(Table([c[0], qty, price, channel]), keep)
    tick("filter")
    Agg = Aggregation.Agg
    out = Aggregation.groupBy(web, [0], [Agg("sum", 2), Agg("count", 2)])
    tick("group_by")
    return out


def ss_result(res):
    """{store: (sum of cents, count)} of one row group's result."""
    keys, sums, counts = res.to_pylists()
    return {int(k): (int(s or 0), int(c)) for k, s, c in zip(keys, sums, counts)
            if k is not None}


def ss_fold(total, part):
    for k, (s, c) in part.items():
        a = total.setdefault(k, [0, 0])
        a[0] += s
        a[1] += c


def scan_forms(elems=SS_RG * SS_WIDTHS[2], widths=(48, 256, 512, 1024)):
    """CUDA-event ms of the lane-scan forms over about ``elems`` int32
    elements at each width L (rows = elems // L; L = 48 is
    get_json_object's shape in store_sales): the port's shifted-max
    scan in its narrow dtype and in int32 against torch.cummax, and the
    prefix count as a triangular product against torch.cumsum (the two
    forms ``segmented.lane_count`` chooses between by width). The
    values must agree."""
    from spark_rapids_jni_tpu_torch.ops import _json_scans, segmented

    g = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for L in widths:
        n = elems // L
        x = torch.randint(-1, L, (n, L), dtype=torch.int32, device="cuda", generator=g)
        xn = x.to(_json_scans.narrow_dtype(-1, L))
        flags = x > L // 2
        if not torch.equal(_json_scans.lane_cummax(xn).to(torch.int32), torch.cummax(x, 1).values):
            raise AssertionError(f"lane_cummax differs from torch.cummax at L={L}")
        want = torch.cumsum(flags, 1, dtype=torch.int32)
        if not (torch.equal(segmented.count_product(flags), want)
                and torch.equal(segmented.lane_count(flags), want)):
            raise AssertionError(f"lane counts differ from torch.cumsum at L={L}")
        out[f"[{n}, {L}]"] = {
            f"lane_cummax {xn.dtype}".replace("torch.", ""): time_ms(
                lambda: _json_scans.lane_cummax(xn), 10),
            "lane_cummax int32": time_ms(lambda: _json_scans.lane_cummax(x), 10),
            "torch.cummax int32": time_ms(lambda: torch.cummax(x, 1), 10),
            "count_product": time_ms(lambda: segmented.count_product(flags), 10),
            "torch.cumsum int32": time_ms(lambda: torch.cumsum(flags, 1, dtype=torch.int32), 10),
        }
        del x, xn, flags, want
    print(f"lane scans, CUDA-event ms (mean of 10): {json.dumps(out)}", flush=True)


def store_sales_sf10(counters, card, path, rows=SS_ROWS, rg_rows=SS_RG):
    """Phase 12: store_sales at SF10 written to a Parquet file at
    ``path`` (phase 15 reads it again), read back through the port's
    reader and run through the query, every row group and the folded
    totals exactly equal to the oracle; end-to-end and device-chain
    rows/s, per-stage ms, ops, a profile, peak memory. Returns the
    kernel launches and the per-row-group oracles (phase 17's)."""
    from spark_rapids_jni_tpu_torch.api import ParquetReader
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy
    from spark_rapids_jni_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    oracles = write_store_sales(path, rows, rg_rows)
    print(f"store_sales data: {rows} rows in {len(oracles)} row groups written in "
          f"{time.perf_counter() - t0:.1f} s, {os.path.getsize(path)} bytes; host "
          f"libraries: {_build.describe_host_libraries()}", flush=True)
    want_total = {}
    for o in oracles:
        ss_fold(want_total, o)

    with ParquetReader(path) as r:  # warm-up: one row group, outside the clock
        ss_chain(r.read_row_group(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in counters:
        counters[name].launches = 0
    stage_ms = {s: [] for s in SS_STAGES}
    last = [0.0]

    def tick(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_ms[stage].append((now - last[0]) * 1e3)
        last[0] = now

    resident, got_total = [], {}
    start = last[0] = time.perf_counter()
    with ParquetReader(path) as r:
        for rg in range(r.num_row_groups):
            specs = r.read_row_group_host(rg)
            tick("decode")
            t = table_from_numpy(specs, "cuda")
            tick("h2d")
            part = ss_result(ss_chain(t, tick))
            if part != oracles[rg]:
                raise AssertionError(f"store_sales row group {rg} differs from the oracle")
            ss_fold(got_total, part)
            resident.append(t)
    e2e_s = time.perf_counter() - start
    launches = {name: c.launches for name, c in counters.items()}
    if got_total != want_total:
        raise AssertionError("store_sales folded totals differ from the oracle")
    resident_bytes = sum(
        c.data.numel() * c.data.element_size()
        + (0 if c.offsets is None else 4 * c.offsets.numel())
        for t in resident for c in t.columns)

    torch.cuda.synchronize()
    chain_total = {}
    t0 = time.perf_counter()
    for t in resident:
        ss_fold(chain_total, ss_result(ss_chain(t)))
    chain_s = time.perf_counter() - t0
    if chain_total != want_total:
        raise AssertionError("store_sales device-chain totals differ from the oracle")

    med = {s: float(np.median(v)) for s, v in stage_ms.items()}
    print(f"store_sales sf10: {len(resident)} row groups and the folded totals exact "
          f"against the oracle ({len(want_total)} stores); kernel launches on the "
          f"store_sales path {json.dumps(launches)}")
    print(f"store_sales sf10 per-row-group ms (median over row groups): {json.dumps(med)}")
    print(f"store_sales SF10 rows/s end to end: {rows / e2e_s:.4g} ({rows} rows in "
          f"{e2e_s * 1e3:.1f} ms, file open to last fold, decode and copy included)")
    print(f"store_sales SF10 device-chain rows/s: {rows / chain_s:.4g} ({rows} rows in "
          f"{chain_s * 1e3:.1f} ms over {resident_bytes} bytes resident on the card)")
    t0 = resident[0]
    print(f"store_sales torch ops dispatched per row group: "
          f"{json.dumps(op_counts(lambda tick: ss_chain(t0, tick)))}")
    profile_stage(f"store_sales row group ({t0.num_rows} rows)", lambda: ss_chain(t0),
                  top=10)
    print(f"store_sales sf10 peak device memory: {torch.cuda.max_memory_allocated()} "
          f"bytes; card: {card}", flush=True)
    del resident
    scan_forms()
    return launches, oracles


# ---- float casts, from_json and nested Parquet (the rest of config 4's
# string layer) ----

FLOAT_CASES = [
    "0", "-0", "-0.0", "+3", "1.5", "-2.25", "007.5", "1e3", "1.5e-2", "1E+308", "1e+0308",
    "nan", "NaN", "NAN", " nan", "nan ", "nanx", "-nan", "+nan",
    "inf", "-inf", "+inf", "Inf", "  inf", "Infinity", "-INFINITY", "infx", "infinity2",
    "inf ", "infini", "-infinityy",
    "1.5f", "1.5F", "2.5d", "2.5D", "1e5f", "1.5ff", "1.5f  ", "0f", "0.0d", "-0F", "f", "d",
    "1e1234", "1e12345", "1e309", "-1e400", "1e-400", "9.9e308", "1.7976931348623157e308",
    "9223372036854775807", "9223372036854775808", "9999999999999999999", "12345678901234567890",
    "18446744073709551615", "18446744073709551616", "99999999999999999999",
    "1234567890123456789012345", "-1234567890123456789012345e-5", "12345678901234567890.5",
    "0.000000000000000000001234567890123456789", "6249979066121302517",
    "4.9e-324", "-4.9e-324", "1e-320", "2.2250738585072014e-308", "2.2250738585072011e-308",
    "1e-309", "-1e-310", "1e-40", "1.17549435e-38", "1.4e-45", "3.4028235e38", "3.5e38",
    "  1.5  ", "\t-2.25\n", "\r+7\r", "--1", "+-1", "- 1", "1 2", "", " ", ".", "-.", ".5",
    "5.", "-.5e1", "1.2.3", "1e", "1e+", "e5", "0x1A", "١.٥", "1,5", "12a",
]


def float_spec(n, seed):
    """Interop STRING column of ``n`` float strings: the quirk cases
    above and random values (repr of random doubles over 60 decades,
    float32 values, integers), with nulls."""
    rng = np.random.default_rng(seed)
    mags = rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)
    randoms = np.where(
        rng.random(n) < 0.5,
        [repr(float(v)) for v in mags],
        [repr(float(np.float32(v))) for v in mags],
    ).tolist()
    ints = rng.integers(-(10**18), 10**18, n)
    values = [c if r < 0.3 else (v if r < 0.8 else str(i)) for c, r, v, i in zip(
        np.array(FLOAT_CASES, dtype=object)[rng.integers(0, len(FLOAT_CASES), n)],
        rng.random(n), randoms, ints)]
    return string_spec_from_list(values, rng, 0.05)


JSON_KEYS = ["a", "channel", "promo", 'k\\"q', "é", "\\ud83d\\ude00", "tab\\tkey", "", "dup"]
JSON_SCALARS = ["0", "-1", "12.5e-3", "1E+9", "-0.25", "true", "false", "null", '""', '"x"',
                '"esc \\\\ \\/ \\b \\f \\n \\r \\t \\" \\u0041"', '"\\ud83d\\ude00 and \\u00e9"',
                '"é and 😀 raw"', "123456789012345678901234567890"]


def json_doc(rng, depth=0):
    """One random JSON object: escaped and non-ASCII keys, duplicate
    keys, every scalar kind, nested objects and arrays, empty
    containers, spacing."""
    sp = [" ", "", "  ", "\t", "\n"][rng.integers(0, 5)]
    items = []
    for _ in range(rng.integers(0, 5)):
        r = rng.random()
        if r < 0.6 or depth > 2:
            v = JSON_SCALARS[rng.integers(0, len(JSON_SCALARS))]
        elif r < 0.8:
            v = json_doc(rng, depth + 1)
        else:
            v = "[" + ", ".join(JSON_SCALARS[rng.integers(0, len(JSON_SCALARS))]
                                for _ in range(rng.integers(0, 4))) + "]"
        key = JSON_KEYS[rng.integers(0, len(JSON_KEYS))]
        items.append(f'"{key}"{sp}:{sp}{v}')
    return "{" + sp + ("," + sp).join(items) + sp + "}"


def from_json_spec(n, seed):
    """Two interop STRING columns of ``n`` valid JSON objects with nulls:
    0 with some documents past 256 bytes (char matrix bucket 512, where
    the lane scans give way to torch's), 1 with every document longer
    than 64 bytes replaced (bucket 64)."""
    rng = np.random.default_rng(seed)
    docs = [json_doc(rng) for _ in range(n)]
    docs = [d if len(d.encode()) <= 256 else '{"a": [1, {"x": "y"}], "b": {}}' for d in docs]
    for i in rng.integers(0, n, 64):
        docs[i] = '{"memo": "' + "long value " * 25 + '", "k": [1, {"x": "y"}]}'
    short = [d if len(d.encode()) <= 64 else '{"channel": "store"}' for d in docs]
    return [string_spec_from_list(docs, rng, 0.05), string_spec_from_list(short, rng, 0.05)]


def list_arrays(col):
    """The buffers of a List<Struct<String,String>> result: name -> numpy."""
    kv = col.child.children
    return {
        "list offsets": col.offsets.cpu().numpy(),
        "list validity": col.validity_or_true().cpu().numpy(),
        "key data": kv[0].data.cpu().numpy(), "key offsets": kv[0].offsets.cpu().numpy(),
        "value data": kv[1].data.cpu().numpy(), "value offsets": kv[1].offsets.cpu().numpy(),
        "child validity": np.concatenate([c.validity_or_true().cpu().numpy() for c in kv]),
    }


def float_json_ops(floats, docs):
    """Every float cast and from_json of phase 13 over one device's
    columns: name -> {buffer: numpy}."""
    from spark_rapids_jni_tpu_torch import FLOAT32, FLOAT64
    from spark_rapids_jni_tpu_torch.api import CastStrings, MapUtils
    from spark_rapids_jni_tpu_torch.ops import _strategy

    out = {}
    for dt in (FLOAT32, FLOAT64):
        c = CastStrings.toFloat(floats, False, dt)
        out[f"toFloat FLOAT{dt.bits}"] = {
            "data": c.data.cpu().numpy(), "validity": c.validity_or_true().cpu().numpy()}
    for strategy in ("auto", "serial"):
        _strategy.set_scan_strategy(strategy)
        try:
            for i, col in enumerate(docs):
                got = MapUtils.extractRawMapFromJsonString(col)
                out[f"from_json {strategy} column {i}"] = list_arrays(got)
        finally:
            _strategy.set_scan_strategy(None)
    return out


def float_json_errors(floats, docs, bad_row):
    """(row, text) of the CastException of the ANSI float cast and of the
    JsonParsingException of a document column with row ``bad_row``
    malformed, under both strategies."""
    from spark_rapids_jni_tpu_torch import FLOAT64, Column
    from spark_rapids_jni_tpu_torch.api import CastStrings, MapUtils
    from spark_rapids_jni_tpu_torch.ops import _strategy
    from spark_rapids_jni_tpu_torch.runtime.errors import CastException, JsonParsingException

    got = {}
    try:
        CastStrings.toFloat(floats, True, FLOAT64)
    except CastException as e:
        got["toFloat ANSI"] = [e.row_with_error, e.string_with_error]
    else:
        raise AssertionError("ANSI toFloat raised no CastException")
    bad = b'{"a": [1}]}'
    offs = docs.offsets.cpu().numpy().astype(np.int64)
    data = docs.data.cpu().numpy()
    data = np.concatenate([data[:offs[bad_row]], np.frombuffer(bad, np.uint8),
                           data[offs[bad_row + 1]:]])
    offs[bad_row + 1:] += len(bad) - (offs[bad_row + 1] - offs[bad_row])
    valid = docs.validity_or_true().clone()
    valid[bad_row] = True
    col = Column(docs.dtype, torch.from_numpy(data).to(docs.device), valid,
                 torch.from_numpy(offs.astype(np.int32)).to(docs.device))
    for strategy in ("auto", "serial"):
        _strategy.set_scan_strategy(strategy)
        try:
            MapUtils.extractRawMapFromJsonString(col)
        except JsonParsingException as e:
            got[f"from_json {strategy}"] = [e.row_with_error, e.context]
        else:
            raise AssertionError("a malformed document raised no JsonParsingException")
        finally:
            _strategy.set_scan_strategy(None)
    return got


def float_json_card_vs_cpu(n):
    """Phase 13: toFloat (FLOAT32 and FLOAT64) and from_json (both scan
    strategies) on the card and on the CPU over one mixed batch; every
    buffer must be equal, and the ANSI cast and a malformed document
    must raise the same row."""
    from spark_rapids_jni_tpu_torch.columnar.interop import column_from_numpy

    floats_spec = float_spec(n, seed=13)
    docs_spec = from_json_spec(n, seed=14)
    t0 = time.perf_counter()
    results, errors = {}, {}
    for dev in ("cuda", "cpu"):
        floats = column_from_numpy(floats_spec, dev)
        docs = [column_from_numpy(s, dev) for s in docs_spec]
        results[dev] = float_json_ops(floats, docs)
        errors[dev] = float_json_errors(floats, docs[1], n // 2 + 7)
    pairs = {}
    for name, want in results["cpu"].items():
        for key, w in want.items():
            if not same_array(results["cuda"][name][key], w):
                raise AssertionError(f"float/from_json card vs cpu [{name}]: {key} differs")
        if "list offsets" in want:
            pairs[name] = int(want["list offsets"][-1])
    if errors["cuda"] != errors["cpu"]:
        raise AssertionError(f"errors differ: card {errors['cuda']}, cpu {errors['cpu']}")
    print(f"float/from_json card vs cpu: {len(results['cpu'])} results exact at {n} rows in "
          f"{time.perf_counter() - t0:.1f} s; pairs {json.dumps(pairs)}; errors equal "
          f"{json.dumps({k: v[0] for k, v in errors['cpu'].items()})}", flush=True)


F_ROWS = (1 << 20, 104_857_600)  # the reference's {1 Mi, 100 Mi} nvbench axis
F_CHUNK = 1 << 24  # 16 Mi-row device batches, as benchmarks/suites.py streams them


def _digit_table(count, width):
    """uint8 [count, width]: the decimal digits of 0..count-1 right-aligned
    (zero bytes before the leading digit), and the digit counts."""
    v = np.arange(count)
    ndig = np.ones(count, np.int64)
    for k in range(1, width):
        ndig += v >= 10**k
    cols = [v // 10 ** (width - 1 - j) % 10 + ord("0") for j in range(width)]
    table = np.stack(cols, axis=1).astype(np.uint8)
    table[np.arange(width)[None, :] < (width - ndig)[:, None]] = 0
    return table, ndig


def float_axis_strings(n, seed):
    """``benchmarks/suites.py::_float_strings``-shaped strings (whole part
    in [-1e6, 1e6), '.', a zero-padded 4-digit fraction) for the same
    draws, built by numpy digit arithmetic: right-aligned 13-byte
    records from digit tables, then the live bytes. Returns (interop
    STRING spec, float32 oracle), the oracle (sign * (|whole| * 10^4 +
    frac)) / 10^4 in float64, narrowed to float32: correctly rounded, as
    the parse is."""
    rng = np.random.default_rng(seed)
    whole = rng.integers(-1_000_000, 1_000_000, n)
    frac = rng.integers(0, 10_000, n)
    neg = whole < 0
    a = np.abs(whole)
    wtab, wlen = _digit_table(1_000_001, 7)
    ftab, _ = _digit_table(10_000, 4)
    ftab[ftab == 0] = ord("0")  # the fraction keeps its leading zeros
    mat = np.zeros((n, 13), np.uint8)
    mat[:, 1:8] = wtab[a]
    mat[:, 8] = ord(".")
    mat[:, 9:] = ftab[frac]
    wl = wlen[a]
    rows = np.flatnonzero(neg)
    mat[rows, 7 - wl[rows]] = ord("-")
    lens = (wl + 5 + neg).astype(np.int32)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    data = mat[np.arange(13)[None, :] >= (13 - lens)[:, None]]
    oracle = (np.where(neg, -1.0, 1.0) * (a * 1e4 + frac) / 1e4).astype(np.float32)
    spec = {"dtype": ("string", 0, None, None), "data": data, "offsets": offsets,
            "validity": None}
    return spec, oracle


def float_axis(counters, card):
    """Phase 14: FLOAT32 casts of the reference's string->float axis at
    1 Mi and 100 Mi rows (the 100 Mi column resident on the card, cast
    in 16 Mi-row chunks), every row exact against the oracle; rows/s at
    both sizes, per-chunk ms, ops per chunk, a profile and the peak
    device memory."""
    from spark_rapids_jni_tpu_torch import FLOAT32
    from spark_rapids_jni_tpu_torch.api import CastStrings
    from spark_rapids_jni_tpu_torch.columnar.interop import column_from_numpy

    def check(col, oracle, label):
        res = CastStrings.toFloat(col, False, FLOAT32)
        want = torch.from_numpy(oracle).to("cuda")
        if res.validity is not None or not torch.equal(res.data.view(torch.int32),
                                                       want.view(torch.int32)):
            raise AssertionError(f"float axis {label}: differs from the oracle")

    t0 = time.perf_counter()
    spec, oracle = float_axis_strings(F_ROWS[0], seed=21)
    small = column_from_numpy(spec, "cuda")
    check(small, oracle, "1 Mi")
    small_ms = host_ms(lambda: CastStrings.toFloat(small, False, FLOAT32), 5)

    chunks, oracles, payload = [], [], 0
    for i, lo in enumerate(range(0, F_ROWS[1], F_CHUNK)):
        spec, oracle = float_axis_strings(min(F_CHUNK, F_ROWS[1] - lo), seed=100 + i)
        payload += spec["data"].nbytes
        chunks.append(column_from_numpy(spec, "cuda"))
        oracles.append(oracle)
    gen_s = time.perf_counter() - t0
    resident = sum(c.data.numel() + 4 * c.offsets.numel() for c in chunks)
    CastStrings.toFloat(chunks[0], False, FLOAT32)  # warm-up outside the clock
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in counters:
        counters[name].launches = 0
    chunk_ms = []
    start = time.perf_counter()
    for c in chunks:
        t = time.perf_counter()
        CastStrings.toFloat(c, False, FLOAT32)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t) * 1e3)
    total_s = time.perf_counter() - start
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, (c, o) in enumerate(zip(chunks, oracles)):
        check(c, o, f"100 Mi chunk {i}")
    print(f"float axis: 1 Mi and {F_ROWS[1]} rows exact against the oracle (strings made and "
          f"copied in {gen_s:.1f} s; {payload} payload bytes, {resident} bytes resident); "
          f"kernel launches on the path {json.dumps(launches)}")
    print(f"float axis FLOAT32 rows/s: 1 Mi {F_ROWS[0] / small_ms * 1e3:.4g} ({small_ms:.3f} ms, "
          f"median of 5); 100 Mi {F_ROWS[1] / total_s:.4g} ({total_s * 1e3:.1f} ms in "
          f"{len(chunks)} chunks of <= {F_CHUNK} rows)")
    print(f"float axis per-chunk ms: {json.dumps([round(m, 3) for m in chunk_ms])}")
    print(f"float axis torch ops dispatched per 16 Mi chunk: "
          f"{json.dumps(op_counts(lambda tick: (CastStrings.toFloat(chunks[0], False, FLOAT32), tick('toFloat'))))}")
    profile_stage(f"toFloat chunk ({len(chunks[0])} rows)",
                  lambda: CastStrings.toFloat(chunks[0], False, FLOAT32), top=8)
    print(f"float axis peak device memory: {peak} bytes over the 100 Mi sweep; card: {card}",
          flush=True)
    return launches


def from_json_expected(chan):
    """The from_json buffers of ``{"promo": false, "channel": "<c>"}``
    rows with channel indices ``chan``: name -> numpy."""
    n = len(chan)
    names = [c.encode() for c in SS_CHANNELS]
    vlen = np.stack([np.full(n, 5), np.array([len(b) for b in names])[chan]], 1).reshape(-1)
    table = np.zeros((len(names), 12), np.uint8)
    for i, b in enumerate(names):
        row = b"false" + b
        table[i, :len(row)] = np.frombuffer(row, np.uint8)
    vals = table[chan]
    vdata = vals[np.arange(12)[None, :] < (5 + vlen[1::2])[:, None]]
    klen = np.tile([5, 7], n)
    return {
        "list offsets": np.arange(0, 2 * n + 1, 2, dtype=np.int32),
        "list validity": np.ones(n, bool),
        "key data": np.tile(np.frombuffer(b"promochannel", np.uint8), n),
        "key offsets": np.concatenate([[0], np.cumsum(klen)]).astype(np.int32),
        "value data": vdata,
        "value offsets": np.concatenate([[0], np.cumsum(vlen)]).astype(np.int32),
        "child validity": np.ones(4 * n, bool),
    }


def from_json_sf10(counters, card, path, rg_rows=SS_RG):
    """Phase 15: MapUtils.extractRawMapFromJsonString over ss_attrs_json
    of phase 12's file, read through the port's ParquetReader with the
    footer pruned to that column; every row group exact against the
    generator; rows/s, per-row-group ms, ops, a profile, peak memory."""
    from spark_rapids_jni_tpu_torch.api import MapUtils, ParquetReader
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy
    from spark_rapids_jni_tpu_torch.ops.parquet_footer import StructElement, ValueElement

    schema = StructElement()
    schema.add_child("ss_attrs_json", ValueElement())
    with ParquetReader(path, schema) as r:  # warm-up, outside the clock
        MapUtils.extractRawMapFromJsonString(r.read_row_group(0).columns[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in counters:
        counters[name].launches = 0
    stage_ms = {s: [] for s in ("decode", "h2d", "from_json")}
    resident, rows, e2e_s = [], 0, 0.0
    with ParquetReader(path, schema) as r:
        for rg in range(r.num_row_groups):
            t = time.perf_counter()
            specs = r.read_row_group_host(rg)
            t1 = time.perf_counter()
            col = table_from_numpy(specs, "cuda").columns[0]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out = MapUtils.extractRawMapFromJsonString(col)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for s, a, b in (("decode", t, t1), ("h2d", t1, t2), ("from_json", t2, t3)):
                stage_ms[s].append((b - a) * 1e3)
            e2e_s += t3 - t
            if out.validity is not None:
                raise AssertionError(f"from_json row group {rg}: rows came back null")
            got = list_arrays(out)
            want = from_json_expected(ss_gen_chunk(len(col), 1000 + rg)["chan"])
            for key, w in want.items():
                if not same_array(got[key], w):
                    raise AssertionError(f"from_json row group {rg}: {key} differs from the "
                                         "generator")
            rows += len(col)
            resident.append(col)
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for col in resident:
        MapUtils.extractRawMapFromJsonString(col)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    med = {s: float(np.median(v)) for s, v in stage_ms.items()}
    c0 = resident[0]
    print(f"from_json sf10: {rows} rows in {len(resident)} row groups exact against the "
          f"generator; kernel launches on the path {json.dumps(launches)}")
    print(f"from_json sf10 per-row-group ms (median over row groups): {json.dumps(med)}")
    print(f"from_json SF10 rows/s: end to end {rows / e2e_s:.4g} (decode, copy and "
          f"from_json, {e2e_s * 1e3:.1f} ms); on the card {rows / chain_s:.4g} "
          f"({chain_s * 1e3:.1f} ms over the resident column, char width "
          f"{int(c0.string_lengths().max())} bytes before bucketing)")
    print(f"from_json torch ops dispatched per row group: "
          f"{json.dumps(op_counts(lambda tick: (MapUtils.extractRawMapFromJsonString(c0), tick('from_json'))))}")
    profile_stage(f"from_json row group ({len(c0)} rows)",
                  lambda: MapUtils.extractRawMapFromJsonString(c0), top=10)
    print(f"from_json sf10 peak device memory: {peak} bytes; card: {card}", flush=True)
    return launches


# -- nested Parquet: definition and repetition levels (RLE / bit-packed
# hybrid), PLAIN pages --

NESTED_SCHEMA = [
    # (name, num_children, repetition 0 req / 1 opt / 2 rep, converted, physical)
    ("ints", 1, 1, 3, None), ("list", 1, 2, None, None), ("element", 0, 1, None, 1),
    ("st", 2, 1, None, None), ("a", 0, 1, None, 2), ("b", 0, 1, 0, 6),
    ("attrs", 1, 1, 1, None), ("key_value", 2, 2, None, None), ("key", 0, 0, 0, 6),
    ("value", 0, 1, 0, 6),
]
NESTED_LEAVES = [  # (path, physical type, max_def, max_rep)
    (("ints", "list", "element"), 1, 3, 1), (("st", "a"), 2, 2, 0), (("st", "b"), 6, 2, 0),
    (("attrs", "key_value", "key"), 6, 2, 1), (("attrs", "key_value", "value"), 6, 3, 1),
]


def _strings(rng, n, max_len=12):
    """(uint8 payload, int32 lengths) of ``n`` random ASCII strings."""
    lens = rng.integers(0, max_len + 1, n).astype(np.int32)
    mat = rng.integers(97, 123, (n, max_len)).astype(np.uint8)
    return mat[np.arange(max_len)[None, :] < lens[:, None]], lens


def _take_strings(payload, lens, keep):
    """(payload, lens) of the strings of (payload, lens) at ``keep`` (a
    bool mask or indices), in order."""
    idx = np.flatnonzero(keep) if keep.dtype == bool else keep
    starts = (np.cumsum(lens) - lens)[idx]
    sel = lens[idx]
    within = np.arange(int(sel.sum())) - np.repeat(np.cumsum(sel) - sel, sel)
    return payload[np.repeat(starts, sel) + within], sel


def nested_gen(n, seed):
    """Three nested columns of ``n`` rows with nulls and empties at every
    level, as Dremel level streams per leaf and as the interop form the
    reader must give back. LIST<INT32> ``ints``; STRUCT<a INT64, b
    STRING> ``st``; MAP<STRING, STRING> ``attrs`` holding the store_sales
    attrs pairs (promo, channel) with null values."""
    rng = np.random.default_rng(seed)
    leaves, expected = [], []

    # ints: null 10 %, empty 10 %, else 1-4 elements, 10 % of them null
    state = rng.choice(3, n, p=[0.1, 0.1, 0.8])  # 0 null, 1 empty, 2 elements
    k = np.where(state == 2, rng.integers(1, 5, n), 0)
    ent = np.maximum(k, 1)
    row = np.repeat(np.arange(n), ent)
    within = np.arange(len(row)) - np.repeat(np.cumsum(ent) - ent, ent)
    elem_null = rng.random(len(row)) < 0.1
    defs = np.where(state[row] == 0, 0, np.where(state[row] == 1, 1, np.where(elem_null, 2, 3)))
    vals = rng.integers(-(2**31), 2**31, len(row)).astype(np.int32)
    leaves.append({"defs": defs, "reps": (within > 0).astype(np.int32),
                   "values": vals[defs == 3].tobytes()})
    is_elem = defs >= 2
    expected.append({"list": {"dtype": ("int", 32, None, None), "data": vals[is_elem],
                              "validity": defs[is_elem] == 3, "offsets": None},
                     "offsets": np.concatenate([[0], np.cumsum(k)]).astype(np.int32),
                     "validity": state != 0})

    # st: null 10 %; a and b each null 10 % inside a valid struct
    sv = rng.random(n) >= 0.1
    a_ok = sv & (rng.random(n) >= 0.1)
    b_ok = sv & (rng.random(n) >= 0.1)
    a = rng.integers(-(2**63), 2**63 - 1, n)
    bpay, blen = _strings(rng, n)
    bpay, blen = _take_strings(bpay, blen, b_ok)
    leaves.append({"defs": np.where(a_ok, 2, sv.astype(np.int64)), "reps": None,
                   "values": a[a_ok].tobytes()})
    leaves.append({"defs": np.where(b_ok, 2, sv.astype(np.int64)), "reps": None,
                   "strings": (bpay, blen)})
    all_blen = np.zeros(n, np.int32)
    all_blen[b_ok] = blen
    expected.append({"struct": [
        {"dtype": ("int", 64, None, None), "data": np.where(a_ok, a, 0), "validity": a_ok,
         "offsets": None},
        {"dtype": ("string", 0, None, None), "data": bpay, "validity": b_ok,
         "offsets": np.concatenate([[0], np.cumsum(all_blen)]).astype(np.int32)},
    ], "names": ("a", "b"), "validity": sv})

    # attrs: null 5 %, empty 5 %, else (promo, channel) with values null
    # 5 % of the time
    mstate = rng.choice(3, n, p=[0.05, 0.05, 0.9])
    pairs = np.where(mstate == 2, 2, 0)
    ent = np.maximum(pairs, 1)
    row = np.repeat(np.arange(n), ent)
    within = np.arange(len(row)) - np.repeat(np.cumsum(ent) - ent, ent)
    is_pair = mstate[row] == 2
    kdefs = np.where(mstate[row] == 0, 0, np.where(is_pair, 2, 1))
    vnull = rng.random(len(row)) < 0.05
    vdefs = np.where(is_pair, np.where(vnull, 2, 3), kdefs)
    chan = rng.integers(0, 3, n)
    promo = rng.integers(0, 2, n)
    words = [b"promo", b"channel", b"false", b"true"] + [c.encode() for c in SS_CHANNELS]
    wpay = np.frombuffer(b"".join(words), np.uint8)
    wlen = np.array([len(w) for w in words], np.int32)
    kword = np.where(within == 0, 0, 1)[is_pair]
    vword = np.where(within == 0, 2 + promo[row], 4 + chan[row])[is_pair]
    kpay, klen = _take_strings(wpay, wlen, kword)
    vsel = vword[vdefs[is_pair] == 3]
    vpay, vlen_ok = _take_strings(wpay, wlen, vsel)
    leaves.append({"defs": kdefs, "reps": (within > 0).astype(np.int32), "strings": (kpay, klen)})
    leaves.append({"defs": vdefs, "reps": (within > 0).astype(np.int32),
                   "strings": (vpay, vlen_ok)})
    vlen_all = np.zeros(int(is_pair.sum()), np.int32)
    vlen_all[vdefs[is_pair] == 3] = vlen_ok
    expected.append({"list": {"struct": [
        {"dtype": ("string", 0, None, None), "data": kpay, "validity": None,
         "offsets": np.concatenate([[0], np.cumsum(klen)]).astype(np.int32)},
        {"dtype": ("string", 0, None, None), "data": vpay, "validity": vdefs[is_pair] == 3,
         "offsets": np.concatenate([[0], np.cumsum(vlen_all)]).astype(np.int32)},
    ], "names": ("key", "value"), "validity": None},
        "offsets": np.concatenate([[0], np.cumsum(pairs)]).astype(np.int32),
        "validity": mstate != 0})
    return leaves, expected


def _levels(levels, max_level):
    """A v1 page's level section: 4-byte length, one bit-packed run."""
    run = rle_bitpacked(np.asarray(levels, np.uint32), max(int(max_level).bit_length(), 1))
    return len(run).to_bytes(4, "little") + run


def _plain_strings(payload, lens):
    """PLAIN BYTE_ARRAY values: a 4-byte length before each string."""
    width = int(lens.max()) + 4 if len(lens) else 4
    mat = np.zeros((len(lens), width), np.uint8)
    mat[:, :4] = lens.astype("<u4").view(np.uint8).reshape(-1, 4)
    offs = np.concatenate([[0], np.cumsum(lens)])
    col = np.arange(width - 4)[None, :]
    live = col < lens[:, None]
    mat[:, 4:][live] = payload[(offs[:-1, None] + col)[live]]
    return mat[np.arange(width)[None, :] < (lens + 4)[:, None]].tobytes()


def write_nested(path, n, seed=16):
    """One row group of ``nested_gen(n, seed)`` as a Parquet file:
    per leaf one v1 data page (SNAPPY literal) of repetition levels,
    definition levels and PLAIN values. Returns the expected columns."""
    leaves, expected = nested_gen(n, seed)
    f = open(path, "wb")
    f.write(b"PAR1")
    chunks, total = [], 0
    for (names, ptype, max_def, max_rep), leaf in zip(NESTED_LEAVES, leaves):
        body = b""
        if max_rep:
            body += _levels(leaf["reps"], max_rep)
        body += _levels(leaf["defs"], max_def)
        body += leaf["values"] if "values" in leaf else _plain_strings(*leaf["strings"])
        comp = snappy_literal(body)
        nv = len(leaf["defs"])
        head = _tstruct([(1, _T_I32, 0), (2, _T_I32, len(body)), (3, _T_I32, len(comp)),
                         (5, _T_STRUCT, _tstruct([(1, _T_I32, nv), (2, _T_I32, 0),
                                                  (3, _T_I32, 3), (4, _T_I32, 3)]))])
        start = f.tell()
        f.write(head + comp)
        size = len(head) + len(comp)
        total += size
        meta = _tstruct([
            (1, _T_I32, ptype), (2, _T_LIST, _tlist(_T_I32, [0, 3])),
            (3, _T_LIST, _tlist(_T_BINARY, list(names))), (4, _T_I32, 1),
            (5, _T_I64, nv), (6, _T_I64, len(head) + len(body)), (7, _T_I64, size),
            (9, _T_I64, start),
        ])
        chunks.append(_tstruct([(2, _T_I64, start), (3, _T_STRUCT, meta)]))
    schema = [_tstruct([(4, _T_BINARY, "schema"), (5, _T_I32, 3)])]
    for name, nch, rep, conv, ptype in NESTED_SCHEMA:
        fields = [] if ptype is None else [(1, _T_I32, ptype)]
        fields += [(3, _T_I32, rep), (4, _T_BINARY, name)]
        if nch:
            fields.append((5, _T_I32, nch))
        if conv is not None:
            fields.append((6, _T_I32, conv))
        schema.append(_tstruct(fields))
    rg = _tstruct([(1, _T_LIST, _tlist(_T_STRUCT, chunks)), (2, _T_I64, total),
                   (3, _T_I64, n)])
    footer = _tstruct([
        (1, _T_I32, 1), (2, _T_LIST, _tlist(_T_STRUCT, schema)), (3, _T_I64, n),
        (4, _T_LIST, _tlist(_T_STRUCT, [rg])),
        (6, _T_BINARY, "spark_rapids_jni_tpu_torch chip_smoke"),
    ])
    f.write(footer + len(footer).to_bytes(4, "little") + b"PAR1")
    f.close()
    return expected


def _rows_of(spec):
    if "list" in spec:
        return len(spec["offsets"]) - 1
    if "struct" in spec:
        return _rows_of(spec["struct"][0])
    return len(spec["offsets"]) - 1 if spec["offsets"] is not None else len(spec["data"])


def same_nested(got, want, label):
    """Exact equality of two interop trees; fixed-width data compared
    where valid (a null slot's value is unspecified)."""
    n = _rows_of(want)
    if _rows_of(got) != n:
        raise AssertionError(f"{label}: {_rows_of(got)} rows, not {n}")
    valid = np.ones(n, bool) if want["validity"] is None else want["validity"]
    got_valid = np.ones(n, bool) if got["validity"] is None else got["validity"]
    if not np.array_equal(got_valid, valid):
        raise AssertionError(f"{label}: validity differs")
    if "list" in want:
        if not np.array_equal(got["offsets"], want["offsets"]):
            raise AssertionError(f"{label}: list offsets differ")
        same_nested(got["list"], want["list"], label + ".element")
    elif "struct" in want:
        if tuple(got["names"]) != tuple(want["names"]):
            raise AssertionError(f"{label}: struct names differ")
        for g, w, nm in zip(got["struct"], want["struct"], want["names"]):
            same_nested(g, w, f"{label}.{nm}")
    elif tuple(got["dtype"]) != tuple(want["dtype"]):
        raise AssertionError(f"{label}: dtype {got['dtype']} != {want['dtype']}")
    elif want["offsets"] is not None:
        if not (np.array_equal(got["offsets"], want["offsets"])
                and np.array_equal(got["data"], want["data"])):
            raise AssertionError(f"{label}: string bytes or offsets differ")
    elif not np.array_equal(got["data"][valid], want["data"][valid]):
        raise AssertionError(f"{label}: values differ")


NESTED_ROWS = SS_RG  # one 2 Mi-row row group, the rung-4 size


def nested_parquet(counters, card, path, n=NESTED_ROWS):
    """Phase 16: one row group of LIST<INT32>, STRUCT<INT64, STRING> and
    MAP<STRING, STRING> with nulls and empties at every level, read on
    the card and on the CPU; both equal to each other and to the
    generator; decode and h2d ms."""
    from spark_rapids_jni_tpu_torch.api import ParquetReader
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy, table_to_numpy

    t0 = time.perf_counter()
    expected = write_nested(path, n)
    write_s = time.perf_counter() - t0
    for name in counters:
        counters[name].launches = 0
    with ParquetReader(path) as r:
        r.read_row_group_host(0)  # warm-up outside the clock
        t = time.perf_counter()
        specs = r.read_row_group_host(0)
        t1 = time.perf_counter()
        card_t = table_from_numpy(specs, "cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    with ParquetReader(path, device="cpu") as r:
        cpu_t = r.read_row_group(0)
    launches = {name: c.launches for name, c in counters.items()}
    for g_card, g_cpu, w, nm in zip(table_to_numpy(card_t), table_to_numpy(cpu_t), expected,
                                    ("ints", "st", "attrs")):
        same_nested(g_card, w, f"nested card {nm}")
        same_nested(g_cpu, w, f"nested cpu {nm}")
        same_nested(g_card, g_cpu, f"nested card vs cpu {nm}")
    print(f"nested parquet: {n} rows x 3 nested columns ({os.path.getsize(path)} bytes, written "
          f"in {write_s:.1f} s) read on the card and on the CPU, both exact against the "
          f"generator; decode {(t1 - t) * 1e3:.2f} ms, h2d {(t2 - t1) * 1e3:.2f} ms; kernel "
          f"launches on the path {json.dumps(launches)}; card: {card}", flush=True)
    return launches


# ---- the streamed scan, Regex and ZOrder (phases 17-19) ----

SS_COLUMNS = [name for name, _ in SS_SCHEMA]  # the four columns ss_chain reads


def ss_run_chunks(chunks, oracles, label):
    """ss_chain over each chunk of an iterator of store_sales row groups,
    every row group and the folded totals exact against the oracles;
    returns the number of rows."""
    total, want, rows = {}, {}, 0
    for o in oracles:
        ss_fold(want, o)
    rg = -1
    for rg, t in enumerate(chunks):
        part = ss_result(ss_chain(t))
        if rg >= len(oracles) or part != oracles[rg]:
            raise AssertionError(f"{label}: row group {rg} differs from the oracle")
        ss_fold(total, part)
        rows += t.num_rows
    if rg + 1 != len(oracles) or total != want:
        raise AssertionError(f"{label}: {rg + 1} row groups, folded totals "
                             f"{'equal' if total == want else 'differ'}")
    return rows


def scan_sf10(counters, card, path, oracles):
    """Phase 17: rung 4 through the streamed scan. ScanPlan over phase
    12's SF10 file -> prefetch_chunks (default workers, depth 2) ->
    ss_chain -> ss_fold, every row group and the totals exact, in turns
    with phase 12's synchronous read loop (sync, prefetched, prefetched,
    sync); then the scan's metrics, the pool size and the card
    machine's cores, the peak device memory, the same scan at depth =
    workers, scan_chunks once more, and one row group's copy pageable
    against page-locked."""
    from spark_rapids_jni_tpu_torch.api import ParquetReader, ScanPlan, prefetch_chunks, scan_chunks
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy
    from spark_rapids_jni_tpu_torch.runtime import metrics
    from spark_rapids_jni_tpu_torch.runtime.scan import default_workers

    def sync():
        with ParquetReader(path) as r:
            return ss_run_chunks((r.read_row_group(g) for g in range(r.num_row_groups)),
                                 oracles, "synchronous read")

    def pow2_payloads(chunks):
        for t in chunks:
            for c in t.columns:
                size = int(c.data.shape[0])
                if c.is_varlen and (size < 8 or size & (size - 1)):
                    raise AssertionError(f"chunk payload of {size} bytes is not a power of two")
            yield t

    def prefetched(depth=2, workers=None):
        with ScanPlan(path, columns=SS_COLUMNS) as plan:
            gen = prefetch_chunks(plan, depth=depth, workers=workers)
            try:
                return ss_run_chunks(pow2_payloads(gen), oracles, f"prefetched depth {depth}")
            finally:
                gen.close()

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = fn(*args)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    workers = default_workers()
    rates = {"sync": [], "prefetched": []}
    launches = None
    for kind in ("sync", "prefetched", "prefetched", "sync"):
        if kind == "prefetched" and launches is None:
            metrics.reset()
            torch.cuda.reset_peak_memory_stats()
            for name in counters:
                counters[name].launches = 0
            rows, s = timed(prefetched)
            torch.cuda.synchronize()
            launches = {name: c.launches for name, c in counters.items()}
            peak = torch.cuda.max_memory_allocated()
            stall = metrics.timer_stats("scan.stall_ms")
            depth_gauge = metrics.gauge_value("scan.prefetch_depth")
            bytes_read = metrics.counter_value("scan.bytes_read")
        else:
            rows, s = timed(sync if kind == "sync" else prefetched)
        rates[kind].append(rows / s)
        print(f"scan sf10 [{kind}]: {rows} rows in {s * 1e3:.1f} ms, {rows / s:.4g} rows/s "
              f"end to end", flush=True)
    deep_rows, deep_s = timed(prefetched, workers, workers)
    with_scan_chunks = ss_run_chunks(scan_chunks(path, columns=SS_COLUMNS), oracles, "scan_chunks")
    # the copy of one row group's host arrays: pageable (phase 12's
    # path) against the scan's page-locked staging, in turns
    with ParquetReader(path) as r:
        specs = r.read_row_group_host(0)
    spec_bytes = sum(a.nbytes for sp in specs for a in (sp["data"], sp["validity"], sp["offsets"])
                     if a is not None)
    copy_ms = {"pageable": [], "pinned": []}
    for kind in ("pageable", "pinned", "pinned", "pageable"):
        _n, s = timed(lambda: table_from_numpy(specs, "cuda", pinned=kind == "pinned").num_rows)  # noqa: B023
        copy_ms[kind].append(s * 1e3)
    if not (rows == deep_rows == with_scan_chunks == SS_ROWS):
        raise AssertionError("scan row counts differ")
    print(f"scan sf10: all {len(oracles)} row groups and the folded totals exact under the "
          f"synchronous loop, prefetch_chunks and scan_chunks; kernel launches on the scan "
          f"path {json.dumps(launches)}")
    print(f"scan sf10 rows/s end to end: prefetched (depth 2, {workers} workers) "
          f"{json.dumps(rates['prefetched'])}, synchronous {json.dumps(rates['sync'])}; "
          f"prefetched at depth {workers}: {deep_rows / deep_s:.4g}")
    print(f"scan sf10 metrics (first prefetched run): scan.stall_ms {json.dumps(stall)}, "
          f"scan.prefetch_depth {depth_gauge}, scan.bytes_read {bytes_read}; decode workers "
          f"{workers}, os.sched_getaffinity {len(os.sched_getaffinity(0))} cores")
    print(f"scan sf10 copy of one row group ({spec_bytes} bytes, host clock, synced, in turns): "
          f"{json.dumps(copy_ms)} ms; page-locked staging includes its host memcpy")
    print(f"scan sf10 peak device memory: {peak} bytes; card: {card}", flush=True)
    return launches


REGEX_PATTERNS = {  # benchmarks/regex_scan.py:79-84, the DFA-size axis
    "tiny": r"[ab]+c",
    "small": r"id=\d+;host=[\w.]+",
    "medium": r"(foo|bar|baz)\d{2,8}end",
    "large": r"a{24}[bc]{24}",
}
REGEX_EXTRACT = (r"id=(\d+);host=([\w.]+)", 2)
REGEX_ROWS = {"narrow": 1 << 20, "wide": 1 << 18, "extract": 1 << 18}
# pattern -> (pattern_fingerprint, extraction_fingerprint) as the JAX
# package computes them (tests/test_torch_regex.py holds these constants
# to the JAX package)
REGEX_FINGERPRINTS = {
    r"[ab]+c": ("3d4c1914daac9d32:00", "b155c18cabc9701d"),
    r"id=\d+;host=[\w.]+": ("045095851b951f89:00", "ee008b9e1ac57714"),
    r"(foo|bar|baz)\d{2,8}end": ("c71a37405f8691cf:00", "93e1f8a6c3ca5864"),
    r"a{24}[bc]{24}": ("80389456e7483ed9:00", "36132d7ef246f541"),
    r"id=(\d+);host=([\w.]+)": ("045095851b951f89:00", "7c57e94b00127099"),
    r"^(\w+?)(\d*)$": ("37eb4ebe30e3989f:11", "f62a36095e3cc5f9"),
    r"x{30}y{30}z{10}": ("f49187b700396adb:00", "eeb5a2090d5220c2"),
}


def _left_digits(v, width):
    """uint8 [n, width] decimal digits of ``v`` left-aligned, and their
    counts."""
    table, ndig = _digit_table(int(v.max()) + 1, width)
    mat, lens = table[v], ndig[v]
    shift = (width - lens)[:, None] + np.arange(width)[None, :]
    return np.take_along_axis(mat, np.minimum(shift, width - 1), 1), lens


def _const_piece(text, n):
    b = np.frombuffer(text.encode(), np.uint8)
    return np.broadcast_to(b, (n, len(b))), np.full(n, len(b), np.int64)


def ragged_concat(pieces, n):
    """Interop STRING spec of rows made of pieces ``(uint8 [n, w]
    left-aligned bytes, lengths [n])`` laid end to end."""
    width = sum(m.shape[1] for m, _ in pieces)
    out = np.zeros((n, width), np.uint8)
    cur = np.zeros(n, np.int64)
    rows = np.arange(n)[:, None]
    for mat, lens in pieces:
        w = mat.shape[1]
        live = np.arange(w)[None, :] < lens[:, None]
        pos = np.minimum(cur[:, None] + np.arange(w)[None, :], width - 1)
        out[np.broadcast_to(rows, live.shape)[live], pos[live]] = mat[live]
        cur += lens
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(cur, out=offsets[1:])
    data = out[np.arange(width)[None, :] < cur[:, None]]
    return {"dtype": ("string", 0, None, None), "data": data, "offsets": offsets,
            "validity": None}


def regex_subjects(n, kind):
    """benchmarks/regex_scan.py's ``_subjects(n, kind)`` (:60-74) built by
    numpy: "id={i};host=h{i % 97}.example.com" when i % 3, else
    "bad {i}"; the wide kind appends 90 x's."""
    i = np.arange(n)
    good = (i % 3) != 0
    head_id, _ = _const_piece("id=", n)
    head_bad, _ = _const_piece("bad ", n)
    head = np.where(good[:, None], np.pad(head_id, ((0, 0), (0, 1))), head_bad)
    host, host_len = _const_piece(";host=h", n)
    dom, dom_len = _const_piece(".example.com", n)
    hd, hl = _left_digits(i % 97, 2)
    pieces = [
        (head, np.where(good, 3, 4)),
        _left_digits(i, len(str(n - 1))),
        (host, np.where(good, host_len, 0)),
        (hd, np.where(good, hl, 0)),
        (dom, np.where(good, dom_len, 0)),
    ]
    if kind == "wide":
        pieces.append(_const_piece("x" * 90, n))
    return ragged_concat(pieces, n)


def regex_subjects_python(n, kind):
    """The benchmark's own list comprehension (the oracle's input)."""
    pad = "x" * 90 if kind == "wide" else ""
    return [(f"id={i};host=h{i % 97}.example.com" if i % 3 else f"bad {i}") + pad
            for i in range(n)]


REGEX_MIXED_PIECES = ["a", "b", "c", "ab", "abc", "id=", "12", "7", ";", "host=", "h.x",
                      "foo", "bar", "end", "<", ">", " ", "\n", "\r\n", "\r", "é", "xyz", "x"]
REGEX_MIXED_CASES = [  # (op, pattern, group) for the card-vs-CPU pass
    ("rlike", r"[ab]+c", None), ("rlike", r"^ab", None), ("rlike", r"c$", None),
    ("rlike", r"^(ab|c)+$", None), ("rlike", r"id=\d+;", None), ("rlike", r"x*$", None),
    ("extract", r"id=(\d+);host=([\w.]+)", 2), ("extract", r"<(.+?)>", 1),
    ("extract", r"^(\w+?)(\d*)$", 1), ("extract", r"(a+?)(b*)c$", 2),
    ("extract", r"(\d+)", 0), ("extract", r"(foo|bar)(\d*)end", 1),
]
REGEX_LONG_PATTERN = r"x{30}y{30}z{10}"  # 70 Glushkov positions: the serial DFA walk


def regex_mixed_spec(n, seed, long_rows=False):
    """Mixed subjects: 1-6 random pieces (terminators \\n, \\r\\n, \\r
    among them), empties and nulls; ``long_rows`` adds rows around the
    70-position pattern."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = rng.integers(0, 7)
        s = "".join(REGEX_MIXED_PIECES[j] for j in rng.integers(0, len(REGEX_MIXED_PIECES), k))
        if long_rows and rng.random() < 0.3:
            s = "x" * int(rng.integers(28, 32)) + "y" * int(rng.integers(29, 31)) + "z" * 10 + s
        rows.append(s)
    valid = rng.random(n) > 0.1
    enc = [s.encode() for s in rows]
    lens = np.array([len(b) if v else 0 for b, v in zip(enc, valid)], np.int64)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    data = np.frombuffer(b"".join(b for b, v in zip(enc, valid) if v), np.uint8).copy()
    return {"dtype": ("string", 0, None, None), "data": data, "offsets": offsets,
            "validity": valid}


def regex_mixed_results(short, long_col):
    """Every case of the card-vs-CPU pass over one device's columns,
    under each strategy (and extraction unbatched): host lists."""
    from spark_rapids_jni_tpu_torch.api import Regex
    from spark_rapids_jni_tpu_torch.ops import regex
    from spark_rapids_jni_tpu_torch.ops._strategy import set_scan_batching, set_scan_strategy

    out = {}
    try:
        for strat, batch in (("serial", True), ("monoid", True), ("monoid", False), ("auto", True)):
            set_scan_strategy(strat)
            set_scan_batching(batch)
            for op, pat, g in REGEX_MIXED_CASES:
                res = Regex.rlike(short, pat) if op == "rlike" else regex.regexp_extract(short, pat, g)
                out[(strat, batch, op, pat, g)] = res.to_pylist()
            out[(strat, batch, "rlike", REGEX_LONG_PATTERN, None)] = Regex.rlike(
                long_col, REGEX_LONG_PATTERN).to_pylist()
    finally:
        set_scan_strategy(None)
        set_scan_batching(None)
    return out


def regex_phase(counters, card):
    """Phase 18: Regex at benchmarks/regex_scan.py's axes. rlike over 1 Mi
    narrow rows (L = 32) for each of its four patterns, over 256 Ki wide
    rows (L = 128) with the small pattern, and regexp_extract(group 2)
    over 256 Ki narrow rows, each under serial and monoid (extraction
    also unbatched); every row exact against Python re, ms, rows/s and
    torch ops per case, the regex.strategy counters; then card against
    CPU over a mixed 64 Ki batch and the fingerprints against the JAX
    package's strings."""
    import re

    from spark_rapids_jni_tpu_torch import Column
    from spark_rapids_jni_tpu_torch.api import Regex
    from spark_rapids_jni_tpu_torch.columnar.interop import column_from_numpy
    from spark_rapids_jni_tpu_torch.ops import regex
    from spark_rapids_jni_tpu_torch.ops._strategy import set_scan_batching, set_scan_strategy
    from spark_rapids_jni_tpu_torch.runtime import metrics

    metrics.reset()
    for name in counters:
        counters[name].launches = 0
    cases = []
    subjects = {}
    for kind, n in (("narrow", REGEX_ROWS["narrow"]), ("wide", REGEX_ROWS["wide"])):
        py = regex_subjects_python(n, kind)
        spec = regex_subjects(n, kind)
        if spec["data"].tobytes() != "".join(py).encode():
            raise AssertionError(f"numpy {kind} subjects differ from regex_scan._subjects")
        subjects[kind] = (py, column_from_numpy(spec, "cuda"))
    for key, pat in REGEX_PATTERNS.items():
        cases.append((f"rlike {key} narrow", "narrow", REGEX_ROWS["narrow"], pat, None))
    cases.append(("rlike small wide", "wide", REGEX_ROWS["wide"], REGEX_PATTERNS["small"], None))
    cases.append(("regexp_extract narrow", "narrow", REGEX_ROWS["extract"], *REGEX_EXTRACT))
    report = {}
    try:
        for label, kind, n, pat, group in cases:
            py, full = subjects[kind]
            col = full if n == len(py) else Column(full.dtype, full.data, None,
                                                   full.offsets[: n + 1])
            if group is None:
                want = [bool(re.search(pat, s)) for s in py[:n]]
                fn = lambda: Regex.rlike(col, pat)  # noqa: E731
                check = lambda res: [bool(x) for x in res.to_pylist()] == want  # noqa: E731
                arms = (("serial", True), ("monoid", True))
            else:
                want = [m.group(group) if (m := re.search(pat, s)) else "" for s in py[:n]]
                fn = lambda: regex.regexp_extract(col, pat, group)  # noqa: E731
                check = lambda res: res.to_pylist() == want  # noqa: E731
                arms = (("serial", True), ("monoid", True), ("monoid", False))
            for strat, batch in arms:
                set_scan_strategy(strat)
                set_scan_batching(batch)
                if not check(fn()):
                    raise AssertionError(f"regex {label} [{strat}] differs from Python re")
                ms = host_ms(fn, 3)
                ops = op_counts(lambda tick: (fn(), tick("ops")))["ops"]
                arm = strat if batch else f"{strat} unbatched"
                report[f"{label} [{arm}]"] = {"ms": round(ms, 3), "rows_per_s": float(f"{n / (ms / 1e3):.4g}"),
                                              "ops": ops}
                print(f"regex [{label}, {arm}]: {n} rows exact against Python re; {ms:.3f} ms, "
                      f"{n / (ms / 1e3):.4g} rows/s, {ops} torch ops", flush=True)
    finally:
        set_scan_strategy(None)
        set_scan_batching(None)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    snap = metrics.snapshot()
    strat_counts = {k: v for k, v in snap["counters"].items() if k.startswith("regex.strategy.")}
    print(f"regex counters: {json.dumps(strat_counts)}, regex.monoid_states "
          f"{snap['gauges'].get('regex.monoid_states')}; kernel launches on the regex path "
          f"{json.dumps(launches)}; card: {card}")

    # card against CPU over a mixed batch, every strategy
    short_spec = regex_mixed_spec(N_MIXED, seed=18)
    long_spec = regex_mixed_spec(N_MIXED // 8, seed=19, long_rows=True)
    got = regex_mixed_results(column_from_numpy(short_spec, "cuda"), column_from_numpy(long_spec, "cuda"))
    want = regex_mixed_results(column_from_numpy(short_spec, "cpu"), column_from_numpy(long_spec, "cpu"))
    for key in want:
        if got[key] != want[key]:
            raise AssertionError(f"regex card != cpu: {key}")
    ref = {k: v for k, v in want.items() if k[0] == "serial"}
    for key, val in want.items():
        if val != ref[("serial", True) + key[2:]]:
            raise AssertionError(f"regex strategies disagree: {key}")
    for pat, (pfp, efp) in REGEX_FINGERPRINTS.items():
        if (regex.pattern_fingerprint(pat), regex.extraction_fingerprint(pat)) != (pfp, efp):
            raise AssertionError(f"regex fingerprints of {pat!r} differ from the JAX package's")
    print(f"regex card vs cpu: {len(want)} results over {N_MIXED} + {N_MIXED // 8} mixed rows "
          f"equal, strategies agree; {len(REGEX_FINGERPRINTS)} fingerprints equal the JAX "
          f"package's", flush=True)
    return launches


ZORDER_RANGES = 1000  # spark.databricks.io.skipping.mdc.rangeId.max's default
ZORDER_KEYS = (0, 1, 2)  # l_orderkey, l_partkey, l_suppkey of lineitem_spec
ZORDER_HILBERT_BITS = 10


def range_ids(keys, ranges=ZORDER_RANGES):
    """int32 range partition ids in [0, ranges) of an int64 key column:
    rank of the key among ``ranges - 1`` quantile bounds (OPTIMIZE ZORDER
    BY's range partitioning)."""
    bounds = np.quantile(keys, np.arange(1, ranges) / ranges, method="lower")
    return np.searchsorted(bounds, keys, side="left").astype(np.int32)


def interleave_numpy(cols, valid=None):
    """Independent Z-order oracle: big-endian bit planes of each column
    (nulls read as 0), interleaved column-major per bit, packed MSB
    first; uint8 [n, ncols * itemsize]."""
    n = len(cols[0])
    planes = []
    for i, c in enumerate(cols):
        c = c.copy()
        if valid is not None and valid[i] is not None:
            c[~valid[i]] = 0
        be = c.astype(c.dtype.newbyteorder(">")).view(np.uint8).reshape(n, -1)
        planes.append(np.unpackbits(be, axis=1))
    stream = np.stack(planes, axis=2).reshape(n, -1)
    return np.packbits(stream, axis=1)


def hilbert_numpy(cols, num_bits, valid=None):
    """Independent Hilbert oracle in numpy uint64 (zorder.cu's Skilling
    transform, hilbert_transposed_index:87-125)."""
    one = np.uint64(1)
    x = []
    for i, c in enumerate(cols):
        v = c.astype(np.int64).view(np.uint64) & np.uint64((1 << num_bits) - 1)
        if valid is not None and valid[i] is not None:
            v = np.where(valid[i], v, np.uint64(0))
        x.append(v)
    ncols = len(x)
    m = one << np.uint64(num_bits - 1)
    q = m
    while q > one:
        p = q - one
        for i in range(ncols):
            hit = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            x0 = np.where(hit, x[0] ^ p, x[0] ^ t)
            if i:
                x[i] = np.where(hit, x[i], x[i] ^ t)
            x[0] = x0
        q >>= one
    for i in range(1, ncols):
        x[i] = x[i] ^ x[i - 1]
    t = np.zeros_like(x[0])
    q = m
    while q > one:
        t = np.where((x[ncols - 1] & q) != 0, t ^ (q - one), t)
        q >>= one
    x = [v ^ t for v in x]
    out = np.zeros_like(x[0])
    k = num_bits * ncols - 1
    for b in range(num_bits - 1, -1, -1):
        for j in range(ncols):
            out |= ((x[j] >> np.uint64(b)) & one) << np.uint64(k)
            k -= 1
    return out.view(np.int64)


def zorder_phase(counters, card, n=N_MAIN):
    """Phase 19: ZOrder on rung 1's lineitem batch: interleaveBits over
    (l_orderkey, l_partkey, l_suppkey) as INT64, and interleaveBits and
    hilbertIndex(10) over the same keys as INT32 range ids in [0, 1000)
    (OPTIMIZE ZORDER BY's shape), each also with nulls; every output
    exact against numpy oracles; ms, rows/s and the share of the byte
    bound at 3.35 TB/s."""
    from spark_rapids_jni_tpu_torch import INT32, INT64, Column
    from spark_rapids_jni_tpu_torch.api import ZOrder

    spec = lineitem_spec(n)
    keys = [spec[i]["data"] for i in ZORDER_KEYS]
    ids = [range_ids(k) for k in keys]
    rng = np.random.default_rng(19)
    masks = [rng.random(n) > 0.1 for _ in keys]
    for name in counters:
        counters[name].launches = 0
    results = {}
    for label, cols, dt in (("int64 keys", keys, INT64), ("int32 range ids", ids, INT32)):
        for nulls in (False, True):
            valid = masks if nulls else None
            dev = [Column.from_numpy(c, dt, validity=None if valid is None else valid[i])
                   for i, c in enumerate(cols)]
            tag = f"{label}{', nulls' if nulls else ''}"
            ops = [("interleaveBits", lambda: ZOrder.interleaveBits(n, *dev),  # noqa: B023
                    interleave_numpy(cols, valid).reshape(-1))]
            if dt is INT32:
                ops.append(("hilbertIndex", lambda: ZOrder.hilbertIndex(  # noqa: B023
                    ZORDER_HILBERT_BITS, n, *dev), hilbert_numpy(cols, ZORDER_HILBERT_BITS, valid)))
            for op, fn, want in ops:
                out = fn()
                if not np.array_equal(out.data.cpu().numpy().reshape(-1), want.reshape(-1)):
                    raise AssertionError(f"zorder {op} [{tag}] differs from the numpy oracle")
                if op == "interleaveBits":
                    stride = dt.size_bytes * len(cols)
                    if not np.array_equal(out.offsets.cpu().numpy(), np.arange(n + 1) * stride):
                        raise AssertionError(f"zorder {op} [{tag}] offsets")
                ms = time_ms(fn, 10)
                nbytes = sum(c.nbytes for c in cols) + (n * len(cols) if nulls else 0)
                nbytes += out.data.numel() * out.data.element_size()
                if out.offsets is not None:
                    nbytes += 4 * out.offsets.numel()
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                results[f"{op} [{tag}]"] = {"ms": ms, "rows_per_s": n / (ms / 1e3),
                                            "bound_ms": bound, "bound_share": bound / ms}
                print(f"zorder {op} [{tag}]: {n} rows exact against numpy; {ms:.3f} ms "
                      f"(CUDA events, mean of 10), {n / (ms / 1e3):.4g} rows/s, {nbytes} bytes, "
                      f"bound {bound:.4f} ms, {bound / ms:.4f} of it", flush=True)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    print(f"zorder: kernel launches on the zorder path {json.dumps(launches)}; card: {card}",
          flush=True)
    return launches


# ---- window and rollup, and rung 5: the chains through the fused
# Pipeline (benchmarks/sf10_q1.py, sf10_store_sales.py) ----

WINDOW_KINDS = ("row_number", "rank", "dense_rank", "sum", "count", "min", "max", "lead", "lag",
                "first_value", "last_value")


def window_rollup_ops(t):
    """Every WindowSpec kind under both frames (over the INT64, FLOAT64
    and DECIMAL64 columns of the mixed batch, count(*) too), a window
    over a string partition key, ROLLUP and GROUPING SETS: name ->
    result Table."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.api import Aggregation, SortOrder
    from spark_rapids_jni_tpu_torch.ops.rollup import grouping_sets, rollup
    from spark_rapids_jni_tpu_torch.ops.window import WindowSpec, window

    Key, Agg = SortOrder.SortKey, Aggregation.Agg
    specs = [WindowSpec("count", None, "partition")]
    for kind in WINDOW_KINDS:
        cols = (None,) if kind in ("row_number", "rank", "dense_rank") else (3, 4, 5)
        for frame in ("running", "partition"):
            specs += [WindowSpec(kind, c, frame, 3 if kind in ("lead", "lag") else 1)
                      for c in cols]
    aggs = [Agg("sum", 3), Agg("count"), Agg("min", 4), Agg("max", 5), Agg("mean", 4)]
    return {
        "window": Table(window(t, [0], [Key(10), Key(2, False)], specs)),
        "window string partition": Table(window(
            t, [1], [Key(3)], [WindowSpec("rank"), WindowSpec("sum", 4, "partition")])),
        "rollup": rollup(t, [0, 1], aggs),
        "grouping_sets": grouping_sets(t, [0, 1, 10], [[0], [1, 10], []], aggs),
    }


def window_phase(counters, card, full):
    """Phase 20: window and rollup on the card against the CPU over the
    mixed 64 Ki-row batch, exact; then one window over rung 1's 4 Mi-row
    lineitem batch (PARTITION BY l_suppkey ORDER BY l_orderkey:
    row_number, rank, a running sum, lag, a partition max), timed."""
    from spark_rapids_jni_tpu_torch.api import SortOrder
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy, table_to_numpy
    from spark_rapids_jni_tpu_torch.ops.window import WindowSpec, window

    spec = mixed_spec(N_MIXED)
    t0 = time.perf_counter()
    results = {dev: {k: table_to_numpy(v) for k, v in
                     window_rollup_ops(table_from_numpy(spec, device=dev)).items()}
               for dev in ("cuda", "cpu")}
    for name, want in results["cpu"].items():
        got = results["cuda"][name]
        if len(got) != len(want):
            raise AssertionError(f"window card vs cpu [{name}]: column count")
        for i, (g, w) in enumerate(zip(got, want)):
            for key in ("data", "validity", "offsets"):
                if not same_array(g[key], w[key]):
                    raise AssertionError(f"window card vs cpu [{name}]: column {i} {key} differs")
    shapes = {k: [len(v), len(v[0]["data"])] for k, v in results["cpu"].items()}
    print(f"window/rollup card vs cpu: exact at {N_MIXED} rows in "
          f"{time.perf_counter() - t0:.1f} s; [columns, rows] {json.dumps(shapes)}", flush=True)

    Key = SortOrder.SortKey
    specs = [WindowSpec("row_number"), WindowSpec("rank"), WindowSpec("sum", 5),
             WindowSpec("lag", 4), WindowSpec("max", 5, "partition")]

    def run():
        return window(full, [2], [Key(0)], specs)

    run()
    torch.cuda.synchronize()
    for name in counters:
        counters[name].launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    # spot check against numpy: rows of one supplier in l_orderkey order
    supp = full.columns[2].data.cpu().numpy()
    okey = full.columns[0].data.cpu().numpy()
    price = full.columns[5].data.cpu().numpy()
    rows = np.flatnonzero(supp == supp[0])
    rows = rows[np.argsort(okey[rows], kind="stable")]
    if (out[0].data.cpu().numpy()[rows] != np.arange(1, len(rows) + 1)).any() or \
            (out[2].data.cpu().numpy()[rows] != np.cumsum(price[rows])).any():
        raise AssertionError("window over lineitem differs from numpy on one partition")
    ms = host_ms(run)
    print(f"window lineitem: {N_MAIN} rows, {len(specs)} specs in {ms:.3f} ms, "
          f"{N_MAIN / (ms / 1e3):.4g} rows/s; torch ops "
          f"{json.dumps(op_counts(lambda tick: (run(), tick('window'))))}; kernel launches "
          f"{json.dumps(launches)}", flush=True)
    profile_stage("window lineitem (4 Mi rows)", run)
    return launches


def q1_ship_filter(t):
    """q1's WHERE l_shipdate <= date '1998-09-02'."""
    return t.columns[6].data <= Q1_CUTOFF


def q1_prep(t):
    """q1's map stage (benchmarks/sf10_q1.py:64-75): the decimal products
    at their true static precisions; drops the ship column."""
    qty, price, disc, tax = t.columns[2:6]
    dp = disc_price(price.data, disc.data).columns[1]  # (26,4)
    ch = PortDecimalUtils.multiply128(dp, widen(100 + tax.data, 13), 6).columns[1]  # (38,6)
    return PortTable([t.columns[0], t.columns[1], qty, price, dp, ch, disc])


def q1_aggs():
    from spark_rapids_jni_tpu_torch.api import Aggregation

    Agg = Aggregation.Agg
    return [Agg("sum", 2), Agg("sum", 3), Agg("sum", 4), Agg("sum", 5), Agg("sum", 6),
            Agg("count", 2)]


def q1_pipeline(name, capacity=8):
    """benchmarks/sf10_q1.py's fused chain (:77-90): filter ->
    map(q1_decimal_prep) -> group_by with the avgs folded on the host."""
    from spark_rapids_jni_tpu_torch.api import Pipeline

    return (Pipeline(name).filter(q1_ship_filter).map(q1_prep, name="q1_decimal_prep")
            .group_by((0, 1), q1_aggs(), capacity=capacity, string_widths={0: 8, 1: 8}))


def q1_chain_eager(t):
    """The same chain through the eager façade: filter, the products,
    group-by."""
    from spark_rapids_jni_tpu_torch.api import Aggregation, Filter

    return Aggregation.groupBy(q1_prep(Filter.apply(t, q1_ship_filter(t))), [0, 1], q1_aggs())


def q1_chain_rows(groups):
    """Expected rows of the q1 chain from q1_oracle's exact sums."""
    return [[k[0], k[1]] + v for k, v in sorted(groups.items())]


def plan_counts():
    from spark_rapids_jni_tpu_torch.runtime import metrics

    return (metrics.counter_value("pipeline.plan_cache_miss"),
            metrics.counter_value("pipeline.plan_cache_hit"))


def assert_sync_free(pipe, table, label):
    """The pipeline's chain run eagerly in its sync-free form, then the
    dispatch of one chunk (a replay of its cached graph), under CUDA's
    sync debug mode "error": any host sync on either path raises."""
    from spark_rapids_jni_tpu_torch.ops._strategy import fusing
    from spark_rapids_jni_tpu_torch.runtime import pipeline as pl

    # the plan run() starts from, so the dispatch replays a cached graph
    feedback = pl._feedback_for(pipe.signature_hash()) if pl.capacity_feedback() else None
    plan = pipe._initial_plan(table.num_rows, feedback)
    chain = pipe._chain_fn(plan)[0]
    dispatch, sync, _holder = pipe._dispatch_fns(table, False)
    misses = plan_counts()[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with fusing():
            chain(table, tuple(pipe._sides))
        value = dispatch(plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if any(sync(value).values()):
        raise AssertionError(f"{label}: overflow in the sync-free check")
    if plan_counts()[0] != misses:
        raise AssertionError(f"{label}: the sync-free check built a plan")
    print(f"{label}: the eager sync-free chain and one graph dispatch ran under sync debug "
          f"mode 'error' with no host sync", flush=True)


def concurrent_runs(pipe, tables, want, rows_of, label, n_threads=2, passes=2):
    """``n_threads`` threads, each on a CUDA stream of its own, run every
    table through one graph-form Pipeline ``passes`` times at once; every
    result must equal ``want``. Returns the wall time."""
    import threading

    errors, streams = [], [torch.cuda.Stream() for _ in range(n_threads)]
    torch.cuda.synchronize()

    def work(k):
        try:
            with torch.cuda.stream(streams[k]):
                outs = [pipe.run(t) for _ in range(passes) for t in tables]
                got = [rows_of(o) for o in outs]
            for i, g in enumerate(got):
                if g != want[i % len(tables)]:
                    errors.append(f"thread {k} run {i}")
        except Exception as e:  # noqa: BLE001 -- re-raised below
            errors.append(f"thread {k}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{label}: concurrent runs differ: {errors[:4]}")
    print(f"{label}: {n_threads} threads x {passes * len(tables)} runs, each on its own "
          f"stream, all exact in {s * 1e3:.1f} ms", flush=True)
    return s


def q1_pipeline_phase(counters, card):
    """Phase 21: q1 at SF10 (phase 7's batches, drawn again from the same
    seed) through the same chain eagerly and through the Pipeline (its
    CUDA graph form): ``run``, ``stream(window=2)`` and two threads
    sharing the Pipeline, every batch exact against the host oracle and
    the eager chain; rows/s, torch ops per chunk, the idle share, plan-
    cache misses and hits, peak memory. Returns the launches and a few
    batches for phase 24."""
    from spark_rapids_jni_tpu_torch.runtime import pipeline as pl

    sizes = [Q1_BATCH] * (SF10_LINEITEM_ROWS // Q1_BATCH)
    sizes.append(SF10_LINEITEM_ROWS - sum(sizes))
    rng = np.random.default_rng(42)
    host = [q1_batch_arrays(rng, n) for n in sizes]
    tables = [q1_table(a, "cuda") for a in host]
    want = [q1_chain_rows(q1_oracle(a)) for a in host]
    rows = sum(sizes)
    q1_chain_eager(tables[0])  # first launches of every op
    torch.cuda.synchronize()
    for name in counters:
        counters[name].launches = 0

    def check(outs, label):
        for i, (out, w) in enumerate(zip(outs, want)):
            got = q1_rows(out)
            if got != w:
                raise AssertionError(f"q1 {label} batch {i} differs from the host oracle: {got}")

    def sweep(label, fn=None, each=None):
        """One pass over the batches: ``fn()`` for all of them at once,
        or ``each(t)`` per batch with a sync after each (then the
        steady rate leaves out the batches that built a plan)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0, h0 = plan_counts()
        t0 = time.perf_counter()
        steady_rows, steady_s = 0, 0.0
        if each is None:
            outs = fn()
        else:
            outs = []
            for t in tables:
                m_before = plan_counts()[0]
                tc = time.perf_counter()
                outs.append(each(t))
                torch.cuda.synchronize()
                if plan_counts()[0] == m_before:
                    steady_rows += t.num_rows
                    steady_s += time.perf_counter() - tc
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        m1, h1 = plan_counts()
        check(outs, label)
        res = {"rows/s": rows / s, "ms": s * 1e3, "misses": m1 - m0, "hits": h1 - h0,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "reserved_bytes": torch.cuda.memory_reserved()}
        if steady_s:
            res["steady rows/s"] = steady_rows / steady_s
        print(f"q1 pipeline [{label}]: {json.dumps(res)}", flush=True)
        return res, outs

    stats = {}
    stats["eager chain"], eager_outs = sweep("eager chain", each=q1_chain_eager)
    for i, (e, w) in enumerate(zip(eager_outs, want)):
        if q1_rows(e) != w:
            raise AssertionError(f"q1 eager chain batch {i} differs")
    n_shapes = len(set(sizes))
    pipe = q1_pipeline("q1_sf10")
    stats["run"], _ = sweep("run", each=pipe.run)
    stats["stream"], _ = sweep("stream(window=2)", lambda: pipe.stream(tables, window=2))
    if stats["run"]["misses"] != n_shapes or stats["stream"]["misses"]:
        raise AssertionError(f"q1 pipeline: plan-cache misses {stats['run']['misses']} + "
                             f"{stats['stream']['misses']} for {n_shapes} shapes")
    if stats["run"]["hits"] != len(tables) - n_shapes:
        raise AssertionError(f"q1 pipeline: {stats['run']['hits']} hits")
    m0, _ = plan_counts()
    concurrent_runs(pipe, tables, want, q1_rows, "q1 pipeline")
    if plan_counts()[0] != m0:
        raise AssertionError("q1 pipeline: the concurrent runs built a plan")
    stats["eager chain again"], _ = sweep("eager chain (again)", each=q1_chain_eager)
    launches = {name: c.launches for name, c in counters.items()}
    t0 = tables[0]
    builds = {r["pipeline"]: r["build_wall_ms"] for r in pl.plan_cache_table()
              if r["pipeline"] == "q1_sf10"}
    print(f"q1 pipeline: {len(tables)} batches x 4 sweeps and 2 threads exact against the host "
          f"oracle and the eager chain; plan builds ms {json.dumps(builds)}; kernel launches "
          f"{json.dumps(launches)}")
    ops = {
        "eager chain": op_counts(lambda tick: (q1_chain_eager(t0), tick("chunk")))["chunk"],
        "pipeline": op_counts(lambda tick: (pipe.run(t0), tick("chunk")))["chunk"],
    }
    print(f"q1 torch ops per chunk: {json.dumps(ops)}", flush=True)
    assert_sync_free(pipe, t0, "q1 pipeline")
    profile_stage("q1 eager chain (4 Mi rows)", lambda: q1_chain_eager(t0), top=4)
    profile_stage("q1 pipeline (4 Mi rows)", lambda: pipe.run(t0), top=4)
    print(f"q1 pipeline card: {card}", flush=True)
    return launches, {"tables": tables[:4], "want": want[:4]}


def q5_revenue(t):
    """q5's map stage: l_extendedprice * (1 - l_discount) appended."""
    return PortTable(list(t.columns)
                     + [disc_price(t.columns[2].data, t.columns[3].data).columns[1]])


def sides_check(li, build, supplier):
    """Two Pipelines of one join chain over same-shaped supplier tables
    with different nation keys: the second hits the first one's plan
    (the build tables are inputs of the program, not part of it), and
    each result is exact against its own eager chain. Run in turns, so
    each replay follows one over the other table."""
    from spark_rapids_jni_tpu_torch import Column
    from spark_rapids_jni_tpu_torch.api import Aggregation, Pipeline

    nk = supplier.columns[1]
    other = PortTable([supplier.columns[0],
                       Column(nk.dtype, (nk.data + 1) % len(Q5_NATIONS), nk.validity, None)])
    aggs = [Aggregation.Agg("sum", 2), Aggregation.Agg("count", 0)]

    def pipe(sup):
        return (Pipeline("q5_sides")
                .join(build, [0], [0], "inner", right_string_widths={2: 16})
                .join(sup, [1, 5], [0, 1], "inner", left_string_widths={6: 16})
                .group_by([6], aggs, capacity=32, string_widths={6: 16}))

    def eager(sup):
        return q5_rows(Aggregation.groupBy(q5_batch(li, build, sup)["join_supplier"], [6], aggs))

    want = {"first": eager(supplier), "other": eager(other)}
    pipes = {"first": pipe(supplier), "other": pipe(other)}
    m0, h0 = plan_counts()
    for label in ("first", "other", "first", "other"):
        if q5_rows(pipes[label].run(li)) != want[label]:
            raise AssertionError(f"q5 sides: the Pipeline over the {label} supplier table "
                                 f"differs from its eager chain")
    m1, h1 = plan_counts()
    if (m1 - m0, h1 - h0) != (1, 3) or want["first"] == want["other"]:
        raise AssertionError(f"q5 sides: misses {m1 - m0}, hits {h1 - h0} over 4 runs, "
                             f"or the two tables give one result")
    print(f"q5 sides: two Pipelines of one join chain over two same-shaped supplier tables "
          f"share one plan (1 miss, 3 hits), each exact against its eager chain", flush=True)


def q5_pipeline_phase(counters, card, ctx):
    """Phase 22: one q5 lineitem batch (phase 9's first) through the
    Pipeline: join the build on l_orderkey, join supplier on (l_suppkey,
    c_nationkey), the revenue product, group-by n_name; against phase
    9's result for the batch and the host oracle, exact. Then
    ``sides_check``: one join chain over two same-shaped supplier
    tables."""
    from spark_rapids_jni_tpu_torch.api import Aggregation, Pipeline

    build, supplier = ctx["build"], ctx["supplier"]
    li = ctx["lineitem0"]

    pipe = (Pipeline("q5_batch")
            .join(build, [0], [0], "inner", right_string_widths={2: 16})
            .join(supplier, [1, 5], [0, 1], "inner", left_string_widths={6: 16})
            .map(q5_revenue, name="q5_revenue")
            .group_by([6], [Aggregation.Agg("sum", 9)], capacity=32, string_widths={6: 16}))
    pipe.run(li)
    torch.cuda.synchronize()
    sides_check(li, build, supplier)
    for name in counters:
        counters[name].launches = 0
    m0, h0 = plan_counts()
    out = pipe.run(li)
    torch.cuda.synchronize()
    m1, h1 = plan_counts()
    launches = {name: c.launches for name, c in counters.items()}
    got = q5_rows(out)
    if got != q5_rows(ctx["partial0"]) or got != ctx["want0"]:
        raise AssertionError(f"q5 pipeline batch 0 differs from phase 9's result: {got}")
    ms = {"pipeline": host_ms(lambda: pipe.run(li)),
          "eager": host_ms(lambda: q5_batch(li, build, supplier))}
    ops = {"pipeline": op_counts(lambda tick: (pipe.run(li), tick("b")))["b"],
           "eager": op_counts(lambda tick: (q5_batch(li, build, supplier), tick("b")))["b"]}

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    peaks = {"pipeline": peak(lambda: pipe.run(li)),
             "eager": peak(lambda: q5_batch(li, build, supplier))}
    print(f"q5 pipeline: batch 0 ({li.num_rows} rows) exact against phase 9 and the host "
          f"oracle; plan-cache misses {m1 - m0}, hits {h1 - h0}; "
          f"ms {json.dumps(ms)}, rows/s pipeline {li.num_rows / (ms['pipeline'] / 1e3):.4g}, "
          f"eager {li.num_rows / (ms['eager'] / 1e3):.4g}; torch ops {json.dumps(ops)}; "
          f"peak bytes {json.dumps(peaks)}; kernel launches {json.dumps(launches)}", flush=True)
    profile_stage("q5 pipeline batch (4 Mi rows)", lambda: pipe.run(li), top=4)
    return launches


def ss_is_web(t):
    """channel == "web" over the width-pinned char matrix, AND a valid
    price (the eager chain's filter, with no host sync)."""
    chars, lengths = to_char_matrix(t.columns[3], SS_WIDTHS[2])
    hit = (lengths == 3) & (chars[:, 0] == 119) & (chars[:, 1] == 101) & (chars[:, 2] == 98)
    return hit & t.columns[2].validity_or_true()


def ss_pipeline(name):
    """benchmarks/sf10_store_sales.py's fused chain (:157-165)."""
    from spark_rapids_jni_tpu_torch import INT32
    from spark_rapids_jni_tpu_torch.api import Aggregation, Pipeline

    Agg = Aggregation.Agg
    return (Pipeline(name)
            .cast_to_integer(1, INT32, strip=True, width=SS_WIDTHS[0])
            .cast_to_decimal(2, 9, 2, width=SS_WIDTHS[1])
            .get_json_object(3, "$.channel", width=SS_WIDTHS[2])
            .filter(ss_is_web)
            .group_by([0], (Agg("sum", 2), Agg("count", 2)), capacity=SS_STORES + 1))


def ss_pipeline_phase(counters, card, path, oracles):
    """Phase 23: store_sales at SF10 through Pipeline.scan_parquet over
    phase 12's file (footers planned once, row groups prefetched, the
    chain over each through stream's window), in turns with phase 17's
    eager prefetched loop; every row group and the totals exact against
    the oracles; rows/s, ops per chunk, the idle share, plan-cache
    misses and hits, peak memory."""
    from spark_rapids_jni_tpu_torch.api import ParquetReader, ScanPlan, prefetch_chunks
    from spark_rapids_jni_tpu_torch.runtime import pipeline as pl

    want = {}
    for o in oracles:
        ss_fold(want, o)

    def eager():
        with ScanPlan(path, columns=SS_COLUMNS) as plan:
            gen = prefetch_chunks(plan)
            try:
                return ss_run_chunks(gen, oracles, "eager prefetched")
            finally:
                gen.close()

    pipe = ss_pipeline("ss_sf10")

    def fused():
        outs = pipe.scan_parquet(path, columns=SS_COLUMNS, window=2)
        total = {}
        for rg, res in enumerate(outs):
            part = ss_result(res)
            if part != oracles[rg]:
                raise AssertionError(f"store_sales pipeline row group {rg} differs")
            ss_fold(total, part)
        if len(outs) != len(oracles) or total != want:
            raise AssertionError("store_sales pipeline totals differ from the oracle")
        return SS_ROWS

    for name in counters:
        counters[name].launches = 0
    rates = {"eager": [], "pipeline": []}
    stats = {}
    for kind in ("pipeline", "eager", "eager", "pipeline"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0, h0 = plan_counts()
        t0 = time.perf_counter()
        n = fused() if kind == "pipeline" else eager()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        m1, h1 = plan_counts()
        rates[kind].append(n / s)
        stats.setdefault(kind, []).append({"misses": m1 - m0, "hits": h1 - h0,
                                           "peak_bytes": torch.cuda.max_memory_allocated()})
    launches = {name: c.launches for name, c in counters.items()}
    rows = [r for r in pl.plan_cache_table() if r["pipeline"] == "ss_sf10"]
    first = stats["pipeline"][0]
    if first["misses"] != len(rows) or first["hits"] != len(oracles) - len(rows) \
            or stats["pipeline"][1]["misses"]:
        raise AssertionError(f"store_sales pipeline plan cache: {json.dumps(stats)}, "
                             f"{len(rows)} shapes")
    with ParquetReader(path) as r:
        t0 = r.read_row_group(0)
    pipe.run(t0)  # this chunk's shape builds its plan outside the count
    ops = {"eager chain": op_counts(lambda tick: (ss_chain(t0), tick("rg")))["rg"],
           "pipeline": op_counts(lambda tick: (pipe.run(t0), tick("rg")))["rg"]}
    print(f"store_sales pipeline: {len(oracles)} row groups x 2 scans exact against the "
          f"oracles; {len(rows)} chunk shapes; rows/s end to end "
          f"{json.dumps(rates)}; plan cache and peak bytes {json.dumps(stats)}; torch ops per "
          f"row group {json.dumps(ops)}; kernel launches {json.dumps(launches)}", flush=True)
    profile_stage("store_sales eager chain (one row group)", lambda: ss_chain(t0), top=4)
    profile_stage("store_sales pipeline (one row group)", lambda: pipe.run(t0), top=4)
    return launches


def retry_phase(counters, card, ctx):
    """Phase 24: the retry runtime on the card over q1 batches: a forced
    retryable OOM mid-stream (RmmSpark.forceRetryOOM), an undersized
    group_by capacity that re-plans, an injected fault through faultinj's
    rule file — each exactly equal to the oracle — and RetryOOMError past
    the budget and past the retry bound."""
    from spark_rapids_jni_tpu_torch.api import RetryOOMError, RmmSpark
    from spark_rapids_jni_tpu_torch.runtime import events, faultinj, resource

    tables, want = ctx["tables"], ctx["want"]

    def check(outs, label):
        for i, (out, w) in enumerate(zip(outs, want)):
            if q1_rows(out) != w:
                raise AssertionError(f"retry [{label}] batch {i} differs from the oracle")

    for name in counters:
        counters[name].launches = 0
    res = {}
    with RmmSpark.task(max_retries=3) as task:
        RmmSpark.forceRetryOOM(task.task_id, num_ooms=1, skip_count=1)
        check(q1_pipeline("retry_forced").stream(tables, window=2), "forced OOM")
        res["forced"] = (task.metrics.retries, task.metrics.injected_ooms)
    retired = [e["attrs"]["retries"] for e in events.of_kind("stream_retire")
               if e["op"] == "Pipeline.retry_forced"]
    if res["forced"] != (1, 1) or retired[-len(tables):] != [0, 1, 0, 0]:
        raise AssertionError(f"forced OOM mid-stream: {res['forced']}, retires {retired}")
    with resource.task() as task:
        check(q1_pipeline("retry_small", capacity=2).stream(tables, window=2), "capacity")
        res["capacity"] = (task.metrics.retries,
                           task.metrics.final_plans["pipeline.retry_small"]["2.capacity"])
    if res["capacity"][0] < 1 or res["capacity"][1] < 6:
        raise AssertionError(f"undersized capacity: {res['capacity']}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cfg = os.path.join(ROOT, "build", "chip_smoke_faults.json")
    with open(cfg, "w") as f:
        json.dump({"opFaults": {"Resource.pipeline.retry_fault": {
            "injectionType": "retry_oom", "interceptionCount": 2}}}, f)
    os.environ["FAULT_INJECTOR_CONFIG_PATH"] = cfg
    faultinj.reset()
    try:
        with resource.task() as task:
            check(q1_pipeline("retry_fault").stream(tables, window=2), "faultinj")
            res["faultinj"] = task.metrics.injected_ooms
    finally:
        del os.environ["FAULT_INJECTOR_CONFIG_PATH"]
        faultinj.reset()
        os.remove(cfg)
    if res["faultinj"] != 2:
        raise AssertionError(f"faultinj retry_oom: {res['faultinj']} injected")
    for label, kw, forced in (("budget", {"budget": 4096}, 0), ("bound", {"max_retries": 2}, 5)):
        try:
            with resource.task(**kw) as task:
                resource.force_retry_oom(forced)
                q1_pipeline(f"retry_{label}", capacity=2).run(tables[0])
        except RetryOOMError as e:
            res[label] = f"RetryOOMError after {e.metrics.retries} retries"
        else:
            raise AssertionError(f"no RetryOOMError past the {label}")
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    print(f"retry on the card: {json.dumps(res)}; every result exact; kernel launches "
          f"{json.dumps(launches)}; card: {card}", flush=True)
    return launches


# ---- the exchange: Spark-hash shuffle over a mesh of 8 shards ----

N_SHARDS = 8  # shards of the exchange phases, all on the one card
Q5_ASIA = Q5_REGIONS.index(Q5_REGION)


def card_mesh(device="cuda", n=N_SHARDS):
    """A mesh of ``n`` shards on one device (``Mesh([dev] * n)``)."""
    from spark_rapids_jni_tpu_torch.parallel.mesh import Mesh

    return Mesh([device] * n)


def pad_rows(table, multiple):
    """(table padded with dead rows to a multiple of ``multiple``, live
    mask or None)."""
    from spark_rapids_jni_tpu_torch.runtime.pipeline import _pad_rows_traced

    n = table.num_rows
    pad = (-n) % multiple
    if not pad:
        return table, None
    dev = table.columns[0].device
    return _pad_rows_traced(table, pad), torch.arange(n + pad, device=dev) < n


def shard_live_rows(sharded, occ):
    """Each shard's live rows in order, in the interop numpy form."""
    from spark_rapids_jni_tpu_torch.columnar.interop import table_to_numpy
    from spark_rapids_jni_tpu_torch.parallel.distributed import collect_table

    return [table_to_numpy(collect_table(s, o)) for s, o in zip(sharded.shards, occ)]


def host_overflow(ovf):
    if isinstance(ovf, dict):
        return {k: int(v) for k, v in ovf.items()}
    return int(ovf)


EXCHANGE_AGGS = (("sum", 3), ("count", None), ("min", 4), ("max", 1), ("mean", 5),
                 ("sum", 6), ("mean", 4), ("count", 2))


def exchange_ops(t, lt, rt, occ, occ_l, occ_r, mesh):
    """Every exchange operator over one device's tables on an 8-shard
    mesh: name -> (ShardedTable, occupied masks, overflow)."""
    from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
    from spark_rapids_jni_tpu_torch.ops.sort import SortKey
    from spark_rapids_jni_tpu_torch.parallel import distributed as D
    from spark_rapids_jni_tpu_torch.parallel import shuffle as S

    n_local = t.num_rows // mesh.size
    out = {
        # strings, a wire pin that truncates, a salt, an undersized bucket
        "hash_shuffle": S.hash_shuffle(
            t, [0, 1, 3], mesh, capacity=n_local // mesh.size // 2, occupied=occ,
            string_widths={1: 16}, wire_widths={3: 16}, salt=1),
        "hash_shuffle fixed keys": S.hash_shuffle(t, [3, 10], mesh, occupied=occ),
        "hash_shuffle decimal128 key": S.hash_shuffle(t, [6], mesh, compress=True),
        "partition_exchange": S.partition_exchange(
            t, (t.columns[10].data % mesh.size).to(torch.int32), mesh, occupied=occ,
            string_widths={1: 16}),
        "group_by": D.distributed_group_by(
            t, [0, 1], [Agg(a, c) for a, c in EXCHANGE_AGGS], mesh, occupied=occ,
            string_widths={1: 16}, overflow_detail=True),
        "group_by small capacity": D.distributed_group_by(
            t, [10], [Agg("sum", 5), Agg("count")], mesh, capacity=2, overflow_detail=True),
        "sort": D.distributed_sort(t, [SortKey(1), SortKey(3, False)], mesh, occupied=occ,
                                   string_widths={1: 16}),
    }
    widths = {1: 32, 5: 16}
    # per-shard output rows: ~1.3x the densest shard's need at 64 Ki
    # rows a side (the empty-string key makes the string layout skewed)
    cap = lt.num_rows
    for how in HOWS:
        out[f"join {how}"] = D.distributed_join(
            lt, rt, [0], [0], mesh, how, left_occupied=occ_l, right_occupied=occ_r,
            out_capacity=cap, left_string_widths=widths, right_string_widths=widths,
            overflow_detail=True)
    out["join string+int32 inner"] = D.distributed_join(
        lt, rt, [1, 4], [1, 4], mesh, "inner", out_capacity=3 * cap, left_string_widths=widths,
        right_string_widths=widths, left_wire_widths={4: 8}, right_wire_widths={4: 8},
        overflow_detail=True)
    small = rt.num_rows // 16
    rt_small = head_rows(rt, small)
    for how in ("inner", "left", "left_semi", "left_anti"):
        out[f"broadcast {how}"] = D.distributed_join_broadcast(
            lt, rt_small, [0], [0], mesh, how, left_occupied=occ_l,
            right_occupied=occ_r[:small], out_capacity=cap, left_string_widths=widths,
            right_string_widths=widths, overflow_detail=True)
    return out


def head_rows(t, n):
    """The first ``n`` rows of ``t`` (varlen payloads kept whole)."""
    from spark_rapids_jni_tpu_torch import Column, Table

    return Table([Column(c.dtype, c.data if c.is_varlen else c.data[:n],
                         None if c.validity is None else c.validity[:n],
                         None if c.offsets is None else c.offsets[:n + 1])
                  for c in t.columns], t.names)


def exchange_card_vs_cpu(n, card):
    """Phase 25: hash_shuffle, partition_exchange, distributed group-by,
    joins (co-partitioned and broadcast) and sort over 8 shards on the
    card and 8 shards on the CPU, same inputs: each shard's live rows and
    occupancy and every overflow count must be equal. Then the kernel
    against its plain version on the exchange's own key planes."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy
    from spark_rapids_jni_tpu_torch.kernels import murmur3

    spec = mixed_spec(n)
    specs = (join_spec(n, 21), join_spec(n, 22, long_strings=True))
    rng = np.random.default_rng(25)
    masks = [rng.random(n) < p for p in (0.7, 0.8, 0.8)]
    t0 = time.perf_counter()
    results, tables = {}, {}
    for dev in ("cuda", "cpu"):
        t = table_from_numpy(spec, device=dev)
        lt, rt = (table_from_numpy(s, device=dev) for s in specs)
        occ, occ_l, occ_r = (torch.from_numpy(m).to(dev) for m in masks)
        res = exchange_ops(t, lt, rt, occ, occ_l, occ_r, card_mesh(dev))
        results[dev] = {k: (shard_live_rows(r[0], r[1]), [o.cpu().numpy() for o in r[1]],
                            host_overflow(r[2])) for k, r in res.items()}
        tables[dev] = t
    for name, (want, want_occ, want_ovf) in results["cpu"].items():
        got, got_occ, got_ovf = results["cuda"][name]
        if got_ovf != want_ovf:
            raise AssertionError(f"exchange card vs cpu [{name}]: overflow {got_ovf} != {want_ovf}")
        for s, (g, w, go, wo) in enumerate(zip(got, want, got_occ, want_occ)):
            if not same_array(go, wo) or len(g) != len(w):
                raise AssertionError(f"exchange card vs cpu [{name}]: shard {s} occupancy")
            for i, (gc, wc) in enumerate(zip(g, w)):
                for key in ("data", "validity", "offsets"):
                    if not same_array(gc[key], wc[key]):
                        raise AssertionError(
                            f"exchange card vs cpu [{name}]: shard {s} column {i} {key}")
    # the kernel against its plain version on the exchange's key planes
    t = tables["cuda"]
    words, valids, plan = murmur3.table_plan(Table([t.columns[3], t.columns[10]]))
    got = murmur3.hash_planes(words, valids, plan, 42)
    if not torch.equal(got, murmur3.hash_planes_plain(words, valids, plan, 42)):
        raise AssertionError("exchange: murmur3 kernel != plain on the exchange's key planes")
    ovf = {k: v[2] for k, v in results["cpu"].items()
           if (any(v[2].values()) if isinstance(v[2], dict) else v[2])}
    live = {k: sum(len(s[0]["data"]) if s else 0 for s in v[0])
            for k, v in results["cpu"].items()}
    print(f"exchange card vs cpu: {len(live)} operators over {N_SHARDS} shards exact shard by "
          f"shard at {n} rows in {time.perf_counter() - t0:.1f} s; live rows "
          f"{json.dumps(live)}; nonzero overflow {json.dumps(ovf)}; kernel == plain on the "
          f"exchange key planes; card: {card}", flush=True)


def q5_exchange_build(t, mesh, exe):
    """q5's build side over the exchange, once per query: the customers
    carry their nation's name and region (the 25-row nation table joined
    on the card), then orders of 1994 (a live mask) JOIN customer on
    o_custkey = c_custkey through the mesh executor, collected and padded
    to a mesh multiple: (o_orderkey, o_custkey, c_custkey, c_nationkey,
    n_name, n_regionkey) and its live mask."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.api import Join

    # c_custkey, c_nationkey, n_nationkey, n_name, n_regionkey
    cust = Join.join(t["customer"], t["nation"], [1], [0])
    cust = Table([cust.columns[0], cust.columns[1], cust.columns[3], cust.columns[4]])
    orders = t["orders"]
    date = orders.columns[2].data
    live = (date >= Q5_DATE_LO) & (date < Q5_DATE_HI)
    n_local = orders.num_rows // mesh.size
    t1 = exe.join(Table(orders.columns[:2]), cust, [1], [0], mesh, left_occupied=live,
                  shuffle_capacity=n_local // mesh.size + n_local // (4 * mesh.size),
                  out_capacity=n_local // 4, right_string_widths={2: 16})
    return pad_rows(t1, mesh.size)


Q5_JOIN_CAPACITIES = {  # per 4 Mi lineitem batch over 8 shards: (shuffle, output) rows
    "join_orders": (73_728, 98_304),
    "join_supplier": (12_288, 8_192),
}


def q5_exchange_batch(li, build, build_live, supplier, mesh, exe, tick=None, caps=None):
    """q5 over one lineitem batch on the mesh, the JAX package's q5
    shape (tests/test_tpch_q5.py): lineitem JOIN the build on l_orderkey,
    JOIN supplier on (l_suppkey, c_nationkey) = (s_suppkey,
    s_nationkey), the region mask, the revenue product, then the
    distributed group-by on n_name, every step through the resource
    executors; ``caps`` (default ``Q5_JOIN_CAPACITIES``) gives each
    join's starting (shuffle, output) capacities per shard. Returns
    (collected (n_name, revenue) Table, the padded join outputs, whether
    a live product overflowed)."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.api import Aggregation
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardedTable

    tick = tick or (lambda stage: None)
    caps = caps or Q5_JOIN_CAPACITIES
    li, li_live = pad_rows(li, mesh.size)
    sc, oc = caps["join_orders"]
    # l_orderkey, l_suppkey, price, disc, o_orderkey, o_custkey, c_custkey,
    # c_nationkey, n_name, n_regionkey
    j1, occ1 = exe.join(li, build, [0], [0], mesh, left_occupied=li_live,
                        right_occupied=build_live, shuffle_capacity=sc, out_capacity=oc,
                        right_string_widths={4: 16}, collect=False)
    tick("join_orders")
    sc, oc = caps["join_supplier"]
    # + s_suppkey, s_nationkey
    j2, occ2 = exe.join(j1, supplier, [1, 7], [0, 1], mesh, left_occupied=occ1,
                        shuffle_capacity=sc, out_capacity=oc, left_string_widths={8: 16},
                        collect=False)
    tick("join_supplier")
    parts, live, overflow = [], [], []
    for s, part in enumerate(j2.shards):
        rev = disc_price(part.columns[2].data, part.columns[3].data)
        keep = occ2[s] & (part.columns[9].data == Q5_ASIA)
        overflow.append((rev.columns[0].data.to(torch.bool) & keep).any())
        parts.append(Table([part.columns[8], rev.columns[1]]))
        live.append(keep)
    tick("region+revenue")
    out = exe.group_by(ShardedTable(parts, mesh), [0], [Aggregation.Agg("sum", 1)], mesh,
                       capacity=32, occupied=live, string_widths={0: 16})
    tick("group_by")
    return out, {"join_orders": (j1, occ1), "join_supplier": (j2, occ2)}, torch.stack(overflow).any()


def exchange_breakdown(li, mesh, capacity):
    """One lineitem batch's exchange on l_orderkey (join_orders' left
    side) step by step, each step ended by a device sync (host clock,
    ms): plan (wire planes), hash (murmur3 placement), pack (the send
    buckets), move (all_to_all), unpack (receive masks and tables).
    Also the bytes of every send bucket."""
    from spark_rapids_jni_tpu_torch import Column, Table
    from spark_rapids_jni_tpu_torch.parallel import exchange
    from spark_rapids_jni_tpu_torch.parallel import shuffle as S
    from spark_rapids_jni_tpu_torch.parallel.mesh import shard_table

    P = mesh.size
    ms = {}
    mark = [time.perf_counter()]

    def step(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] = ms.get(name, 0.0) + (now - mark[0]) * 1e3
        mark[0] = now

    torch.cuda.synchronize()
    mark[0] = time.perf_counter()
    st = shard_table(li, mesh)
    arrays, slots, cap, trunc, wc = S._plan_exchange(st, capacity, None, None)
    step("plan")
    pids = S._hash_pids(st, [0], arrays, slots, P)
    step("hash")
    packed, counts = [], []
    for s in range(P):
        pk, cnt = S._pack_buckets(arrays[s], pids[s], P, cap)
        packed.append(pk)
        counts.append(cnt)
    step("pack")
    recv = [exchange.all_to_all(mesh, [packed[s][k] for s in range(P)])
            for k in range(len(packed[0]))]
    rc = exchange.all_to_all(mesh, [c.reshape(P, 1) for c in counts])
    step("move")
    slot = torch.arange(cap, device=li.columns[0].device)
    shards = []
    for j in range(P):
        occ = (slot[None, :] < torch.clamp(rc[j].reshape(P), max=cap)[:, None]).reshape(-1)
        shards.append((Table([Column(c.dtype, r[j].reshape(-1, *r[j].shape[2:]))
                              for c, r in zip(li.columns, recv)]), occ))
    step("unpack")
    nbytes = sum(int(p.numel()) * p.element_size() for pk in packed for p in pk)
    return ms, nbytes


def q5_exchange_sf10(counters, card, ctx):
    """Phase 26: TPC-H q5 at SF10 over the exchange: phase 9's tables on
    a mesh of 8 shards on the card, the build once, then every 4 Mi
    lineitem batch through ``q5_exchange_batch`` under one resource task
    scope with the capacity-feedback memo on; every batch and the final
    rows exact against the host oracle. Prints rows/s beside phase 9's
    one-card eager rung 3, the exchange's per-step ms and bytes, padding
    waste and re-plans, torch ops per batch, the idle share, peak
    memory, murmur3 launches per batch and the kernel at this shape."""
    from spark_rapids_jni_tpu_torch.kernels import murmur3
    from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
    from spark_rapids_jni_tpu_torch.runtime import resource

    t, d = ctx["tables"], ctx["data"]
    mesh = card_mesh()
    lis = t["lineitem"]
    n_li = sum(x.num_rows for x in lis)
    pl.set_capacity_feedback(True)
    resource.exec_feedback_clear()
    try:
        with resource.task() as task:
            build, build_live = q5_exchange_build(t, mesh, resource)
            q5_exchange_batch(lis[0], build, build_live, t["supplier"], mesh, resource)
            torch.cuda.synchronize()
            warm_retries = task.metrics.retries
            for name in counters:
                counters[name].launches = 0
            stage_ms = {}
            last = [time.perf_counter()]

            def tick(stage):
                torch.cuda.synchronize()
                now = time.perf_counter()
                stage_ms.setdefault(stage, []).append((now - last[0]) * 1e3)
                last[0] = now

            torch.cuda.reset_peak_memory_stats()
            start = last[0]
            build, build_live = q5_exchange_build(t, mesh, resource)
            tick("build")
            parts, waste = [], {"join_orders": [0, 0], "join_supplier": [0, 0]}
            for i, li in enumerate(lis):
                out, joins, over = q5_exchange_batch(li, build, build_live, t["supplier"],
                                                     mesh, resource, tick)
                if bool(over):
                    raise AssertionError(f"q5 exchange batch {i}: a revenue product overflowed")
                parts.append(out)
                for k, (_j, occ) in joins.items():
                    waste[k][0] += sum(int(o.numel()) for o in occ)
                    waste[k][1] += sum(int(o.sum()) for o in occ)
            final = q5_merge(parts, tick)
            total_s = last[0] - start
            launches = {name: c.launches for name, c in counters.items()}
            retries = task.metrics.retries - warm_retries
            peak = torch.cuda.max_memory_allocated()
            for i, p in enumerate(parts):
                want = sorted(q5_oracle(d, i * Q5_BATCH, (i + 1) * Q5_BATCH).items())
                if sorted(q5_rows(p)) != want:
                    raise AssertionError(f"q5 exchange batch {i}: differs from the host oracle")
            want_final = q5_final_rows(q5_oracle(d))
            if q5_rows(final) != want_final:
                raise AssertionError(f"q5 exchange final differs: {q5_rows(final)}")
            if launches["murmur3_chain"] < len(lis):
                raise AssertionError(f"q5 exchange: murmur3 launches {launches}")
            memo = resource.exec_feedback_table()
            progs = resource.program_cache_table()
            li0 = lis[0]
            counts = op_counts(lambda tk: (q5_exchange_batch(
                li0, build, build_live, t["supplier"], mesh, resource), tk("batch")))
            profile_stage("q5 exchange batch (4 Mi rows, 8 shards)", lambda: q5_exchange_batch(
                li0, build, build_live, t["supplier"], mesh, resource), top=8)
    finally:
        pl.set_capacity_feedback(None)
    med = {s: float(np.median(v)) for s, v in stage_ms.items()}
    brk, nbytes = exchange_breakdown(li0, mesh, Q5_JOIN_CAPACITIES["join_orders"][0])
    brk = {k: round(v, 3) for k, v in brk.items()}
    # the kernel at the exchange's shape: l_orderkey's two int32 word planes
    from spark_rapids_jni_tpu_torch import Table

    w, v, plan = murmur3.table_plan(Table([li0.columns[0]]))
    k_ms = time_ms(lambda: murmur3.hash_planes(w, v, plan, 42), 50)
    p_ms = time_ms(lambda: murmur3.hash_planes_plain(w, v, plan, 42), 10)
    k_bytes = 4 * w.numel() + v.numel() + 4 * w.shape[1]
    k_ops = w.shape[1] * (11 * w.shape[0] + 10 * len(plan))
    k_bound = max(k_bytes / HBM_BYTES_PER_S, k_ops / INT_OPS_PER_S) * 1e3
    eager = ctx["rows_per_s"]
    print(f"q5 exchange sf10: {len(parts)} batches over {N_SHARDS} shards on one card and the "
          f"final rows exact against the host oracle; lineitem rows/s {n_li / total_s:.4g} "
          f"({n_li} rows in {total_s * 1e3:.1f} ms, build to final sort) against phase 9's "
          f"one-card eager rung 3 {eager:.4g} in this call", flush=True)
    print(f"q5 exchange per-stage ms (build and merge+sort once, the rest median over "
          f"batches): {json.dumps(med)}")
    print(f"q5 exchange of one batch on l_orderkey (capacity "
          f"{Q5_JOIN_CAPACITIES['join_orders'][0]}), ms per step: {json.dumps(brk)}; send "
          f"bucket bytes {nbytes}")
    print(f"q5 exchange padding: granted slots vs live rows "
          f"{json.dumps({k: {'granted': g, 'live': lv, 'waste': round(1 - lv / g, 4)} for k, (g, lv) in waste.items()})}; "
          f"re-plans in the timed run {retries} (warm-up {warm_retries}); "
          f"memo rows {json.dumps(memo)}; program-cache rows {json.dumps(progs)}")
    print(f"q5 exchange torch ops per batch {counts['batch']}; peak device memory {peak} bytes; "
          f"murmur3 launches {json.dumps(launches)} ({launches['murmur3_chain'] / len(lis):.2f} "
          f"per batch); kernel at the l_orderkey exchange shape ({w.shape[1]} rows, "
          f"{k_bytes} bytes): {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {k_bound:.4f} ms; "
          f"card: {card}", flush=True)
    return launches, {"ms": k_ms, "plain_ms": p_ms, "bound_ms": k_bound, "bytes": k_bytes,
                      "build": build, "build_live": build_live}


def mesh_executors_phase(counters, card, q1_ctx, q5_ctx):
    """Phase 27: the mesh executors over 8 shards on the card under the
    retry runtime: group_by over phase 21's q1 batches from an undersized
    capacity (the first batch re-plans, the memo starts the rest wide
    enough), join and shuffle with undersized capacities, a forced retry
    (RmmSpark.forceRetryOOM) and a faultinj ``retry_oom`` rule, every
    result exact against the one-card eager op; then RetryOOMError past
    a byte budget. Prints the memo and program-cache rows."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.api import Aggregation, Join, RetryOOMError, RmmSpark
    from spark_rapids_jni_tpu_torch.columnar.interop import table_to_numpy
    from spark_rapids_jni_tpu_torch.ops.sort import SortKey, sort_table
    from spark_rapids_jni_tpu_torch.parallel import spark_hash
    from spark_rapids_jni_tpu_torch.parallel.distributed import collect_table
    from spark_rapids_jni_tpu_torch.runtime import faultinj, resource
    from spark_rapids_jni_tpu_torch.runtime import pipeline as pl

    mesh = card_mesh()
    Agg = Aggregation.Agg
    aggs = [Agg("sum", 2), Agg("sum", 3), Agg("count")]
    tables = [Table(tb.columns[:4]) for tb in q1_ctx["tables"]]
    want_gb = [sorted(q5_rows_all(Aggregation.groupBy(tb, [0, 1], aggs))) for tb in tables]
    li, sup = q5_ctx["lineitem0"], q5_ctx["supplier"]

    def sorted_rows(tb):
        keys = [SortKey(i) for i in range(tb.num_columns)]
        return [x["data"].tobytes() for x in table_to_numpy(sort_table(tb, keys))]

    want_join = sorted_rows(Join.join(li, sup, [1], [0]))
    # undersized on purpose: the exchange buckets at 3/4 and 1/2 of the
    # balanced share, the join output at 1/8 of the rows a shard gets
    bucket = li.num_rows // mesh.size // mesh.size

    def run_all(label):
        for i, tb in enumerate(tables):
            got = resource.group_by(tb, [0, 1], aggs, mesh, capacity=2,
                                    string_widths={0: 8, 1: 8})
            if sorted(q5_rows_all(got)) != want_gb[i]:
                raise AssertionError(f"mesh executors [{label}] group_by batch {i} differs")
        got = resource.join(li, sup, [1], [0], mesh, shuffle_capacity=3 * bucket // 4,
                            out_capacity=li.num_rows // mesh.size // 8)
        if sorted_rows(got) != want_join:
            raise AssertionError(f"mesh executors [{label}] join differs")
        out, occ = resource.shuffle(li, [1], mesh, capacity=bucket // 2)
        for s, (part, o) in enumerate(zip(out.shards, occ)):
            pids = spark_hash.partition_ids(Table([part.columns[1]]), mesh.size)
            if bool((o & (pids != s)).any()):
                raise AssertionError(f"mesh executors [{label}] shuffle: a row on shard {s} "
                                     "hashes elsewhere")
        if sorted_rows(collect_table(out, occ)) != sorted_rows(li):
            raise AssertionError(f"mesh executors [{label}] shuffle lost or changed rows")

    for name in counters:
        counters[name].launches = 0
    res = {}
    pl.set_capacity_feedback(True)
    resource.exec_feedback_clear()
    try:
        with resource.task() as task:
            run_all("re-plan")
            res["re-plan"] = {"retries": task.metrics.retries,
                              "final_plans": {k: v for k, v in task.metrics.final_plans.items()
                                              if k in ("group_by", "join", "shuffle")}}
        memo = resource.exec_feedback_table()
        progs = resource.program_cache_table()
        with RmmSpark.task(max_retries=3) as task:
            RmmSpark.forceRetryOOM(task.task_id, num_ooms=1, skip_count=2)
            run_all("forced OOM")
            res["forced"] = (task.metrics.retries, task.metrics.injected_ooms)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        cfg = os.path.join(ROOT, "build", "chip_smoke_mesh_faults.json")
        with open(cfg, "w") as f:
            json.dump({"opFaults": {"Resource.join": {
                "injectionType": "retry_oom", "interceptionCount": 2}}}, f)
        os.environ["FAULT_INJECTOR_CONFIG_PATH"] = cfg
        faultinj.reset()
        try:
            with resource.task() as task:
                run_all("faultinj")
                res["faultinj"] = task.metrics.injected_ooms
        finally:
            del os.environ["FAULT_INJECTOR_CONFIG_PATH"]
            faultinj.reset()
            os.remove(cfg)
        resource.exec_feedback_clear()  # a cold plan, so the capacity must re-plan
        try:
            with resource.task(budget=4096):
                resource.group_by(tables[0], [0, 1], aggs, mesh, capacity=2,
                                  string_widths={0: 8, 1: 8})
        except RetryOOMError as e:
            res["budget"] = f"RetryOOMError after {e.metrics.retries} retries"
        else:
            raise AssertionError("no RetryOOMError past the byte budget")
    finally:
        pl.set_capacity_feedback(None)
    if res["forced"][1] != 1 or res["faultinj"] != 2 or res["re-plan"]["retries"] < 3:
        raise AssertionError(f"mesh executors: {json.dumps(res)}")
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    print(f"mesh executors over {N_SHARDS} shards: {json.dumps(res)}; every result exact; "
          f"memo rows {json.dumps(memo)}; program-cache rows {json.dumps(progs)}; kernel "
          f"launches {json.dumps(launches)}; card: {card}", flush=True)
    return launches


def q5_rows_all(out):
    """Every row of a result table as a tuple of Python values."""
    return [tuple(r) for r in zip(*out.to_pylists())]


def sharded_stream_phase(counters, card, q1_ctx, q5_ctx):
    """Phase 28: phase 21's q1 chain over phase 21's first four batches
    and phase 22's q5 join chain over four lineitem batches through
    ``Pipeline.stream(window=2, shard=<8-shard Mesh on the card>)``, each
    against the unsharded stream of the same chain in the same call, the
    q5 chain under both build placements (broadcast, co-partitioned);
    results value-identical (groups compared sorted) and the q1 batches
    exact against the host oracle. Rows/s, ops per chunk, plan misses
    and hits; one sharded dispatch (a graph replay) under sync debug
    mode "error"."""
    from spark_rapids_jni_tpu_torch.api import Aggregation, Pipeline
    from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
    from spark_rapids_jni_tpu_torch.runtime import resource

    mesh = card_mesh()
    q1_tables, q1_want = q1_ctx["tables"], q1_ctx["want"]
    lis = q5_ctx["tables"]["lineitem"][:4]
    build, supplier = q5_ctx["build"], q5_ctx["tables"]["supplier"]

    def q5_pipe(name, bcast):
        return (Pipeline(name)
                .join(build, [0], [0], "inner", right_string_widths={2: 16}, broadcast=bcast)
                .join(supplier, [1, 5], [0, 1], "inner", left_string_widths={6: 16},
                      broadcast=bcast)
                .map(q5_revenue, name="q5_revenue")
                .group_by([6], [Aggregation.Agg("sum", 9)], capacity=32,
                          string_widths={6: 16}))

    chains = [("q1", q1_pipeline("q1_sharded"), q1_tables),
              ("q5 broadcast", q5_pipe("q5_sharded_bcast", True), lis),
              ("q5 co-partitioned", q5_pipe("q5_sharded_copart", False), lis)]
    for name in counters:
        counters[name].launches = 0
    report = {}
    pl.set_capacity_feedback(True)
    try:
        with resource.task():
            for label, pipe, tables in chains:
                report[label] = stream_turns(label, pipe, tables, mesh, q1_want)
            sharded_sync_free(chains[2][1], lis[0], mesh)
    finally:
        pl.set_capacity_feedback(None)
    launches = {name: c.launches for name, c in counters.items()}
    print(f"sharded stream over {N_SHARDS} shards (stream window=2, in turns with the "
          f"unsharded stream): every chunk value-identical; {json.dumps(report)}; kernel "
          f"launches {json.dumps(launches)}; card: {card}", flush=True)
    profile_stage("q5 co-partitioned sharded stream chunk",
                  lambda: chains[2][1].stream([lis[0]], shard=mesh), top=6)
    return launches


def stream_turns(label, pipe, tables, mesh, q1_want):
    """The chain's sharded and unsharded streams in turns (sharded,
    unsharded, unsharded, sharded): every chunk value-identical (q1 also
    against the oracle); rows/s, plan misses and hits, ops per chunk."""
    rows = sum(tb.num_rows for tb in tables)
    stats, outs = {}, {}
    for kind in ("sharded", "unsharded", "unsharded", "sharded"):
        shard = mesh if kind == "sharded" else None
        torch.cuda.synchronize()
        m0, h0 = plan_counts()
        t0 = time.perf_counter()
        outs[kind] = pipe.stream(tables, window=2, shard=shard)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        m1, h1 = plan_counts()
        stats.setdefault(kind, []).append({"rows_s": rows / s, "misses": m1 - m0,
                                           "hits": h1 - h0})
    for i, (a, b) in enumerate(zip(outs["unsharded"], outs["sharded"])):
        if sorted(q5_rows_all(a)) != sorted(q5_rows_all(b)):
            raise AssertionError(f"sharded stream [{label}] chunk {i} differs from the "
                                 "unsharded stream")
        if label == "q1" and sorted(q1_rows(b)) != q1_want[i]:
            raise AssertionError(f"sharded stream [q1] chunk {i} differs from the oracle")
    t0 = tables[0]
    ops = {"sharded": op_counts(lambda tk: (pipe.stream([t0], shard=mesh), tk("c")))["c"],
           "unsharded": op_counts(lambda tk: (pipe.stream([t0]), tk("c")))["c"]}
    return {"rows_s": {k: [round(x["rows_s"]) for x in v] for k, v in stats.items()},
            "plan_misses_hits": {k: [(x["misses"], x["hits"]) for x in v]
                                 for k, v in stats.items()},
            "ops_per_chunk": ops}


def sharded_stream_dispatch(pipe, table, mesh):
    """(dispatch, sync, plan) of one sharded chunk at the stream's plan."""
    spec = pipe._resolve_shard(mesh)
    bch = pipe._bcast_choices(spec)
    plan = pipe._initial_plan(table.num_rows, None, shard_n=spec.n_dev, bcast=bch)
    dispatch, sync, _holder = pipe._dispatch_fns(table, False, shard=spec)
    return dispatch, sync, plan


def sharded_sync_free(pipe, table, mesh):
    """One sharded chunk's dispatch (its cached graph replayed) under
    CUDA's sync debug mode "error": a host sync raises."""
    dispatch, sync, plan = sharded_stream_dispatch(pipe, table, mesh)
    sync(dispatch(plan))  # builds the plan outside the check
    dispatch, sync, plan = sharded_stream_dispatch(pipe, table, mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        value = dispatch(plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if any(sync(value).values()):
        raise AssertionError("sharded stream: overflow in the sync-free check")
    print("sharded stream: one sharded dispatch ran under sync debug mode 'error' with no host "
          "sync", flush=True)


# ---- the serving driver: four tenants on one card (phase 29) ----

SERVE_SHUFFLE_ROWS = Q1_BATCH // 2  # the shuffle-write tenant's 2 Mi-row chunks
SERVE_SS_ROW_GROUPS = 4  # row groups of phase 12's file the store_sales tenant scans
SERVE_MARGIN = 4 << 30  # device bytes the server keeps out of its capacity
SAMPLER_HZ = 19.0  # the sampler's default rate
SAMPLER_TURNS = ("off", "on", "on", "off", "off", "on")  # the sampler in the rounds after the first
SERVE_OOM_BYTES = 1 << 46  # an allocation no card holds: a real CUDA OOM mid-flight


def q1_shuffle_prep(t):
    """q1's decimal products with l_orderkey (column 7) kept for the
    shuffle write."""
    return PortTable(list(q1_prep(t).columns) + [t.columns[7]])


def q1_shuffle_ids(t):
    """A Spark shuffle write's placement: HashPartitioning ids over
    l_orderkey into 200 partitions (the murmur3 kernel), appended."""
    pids = port_spark_hash.partition_ids(PortTable([t.columns[7]]), NUM_PARTITIONS)
    return PortTable(list(t.columns) + [PortColumn(PortINT32, pids)])


def q1_shuffle_pipeline(name):
    """q1's filter and decimal products, then the shuffle write's
    partition ids: a second executable beside the q1 tenant's."""
    from spark_rapids_jni_tpu_torch.api import Pipeline

    return (Pipeline(name).filter(q1_ship_filter).map(q1_shuffle_prep, name="q1_decimal_prep")
            .map(q1_shuffle_ids, name="partition_ids"))


def oom_stage(t):
    """A map stage whose allocation no card can hold: a real
    torch.cuda.OutOfMemoryError inside a served job."""
    torch.empty(SERVE_OOM_BYTES, dtype=torch.uint8, device=t.columns[0].data.device)
    return t


def q1_shuffle_chunk(arrays, l_orderkey, device):
    """A q1 batch with l_orderkey appended as column 7 (INT64)."""
    from spark_rapids_jni_tpu_torch import INT64, Column, Table

    t = q1_table(arrays, device)
    key = Column(INT64, torch.from_numpy(np.ascontiguousarray(l_orderkey)).to(device))
    return Table(list(t.columns) + [key])


def q1_shuffle_check(out, arrays, l_orderkey, label):
    """One chunk of the shuffle tenant against its host arrays: the kept
    rows in order, their decimal products, and partition ids equal to
    the plain Murmur3 chain's over the kept l_orderkey."""
    from spark_rapids_jni_tpu_torch import Table
    from spark_rapids_jni_tpu_torch.kernels import murmur3

    keep = arrays["ship"] <= Q1_CUTOFF
    n = int(keep.sum())
    cols = out.columns
    if out.num_rows != n or len(cols) != 9:
        raise AssertionError(f"{label}: {out.num_rows} rows x {len(cols)} columns, want {n} x 9")
    dev = cols[0].data.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    price, disc, tax = (arrays[k][keep] for k in ("price", "disc", "tax"))
    dp = price * (100 - disc)
    want = {"rf": (cols[0].data, arrays["rf"][keep]), "ls": (cols[1].data, arrays["ls"][keep]),
            "qty": (cols[2].data, arrays["qty"][keep]), "price": (cols[3].data, price),
            "disc_price": (cols[4].data[:, 0], dp), "charge": (cols[5].data[:, 0], dp * (100 + tax)),
            "disc": (cols[6].data, disc), "l_orderkey": (cols[7].data, l_orderkey[keep])}
    for name, (got, w) in want.items():
        if not torch.equal(got, put(w)):
            raise AssertionError(f"{label}: column {name} differs from the host arrays")
    if bool(cols[4].data[:, 1].any()) or bool(cols[5].data[:, 1].any()):
        raise AssertionError(f"{label}: a product's high limb is not 0")
    words, valids, plan = murmur3.table_plan(Table([cols[7]]))
    plain = port_spark_hash.pmod(
        murmur3.hash_planes_plain(words, valids, plan, port_spark_hash.DEFAULT_SEED),
        NUM_PARTITIONS)
    if not torch.equal(cols[8].data, plain):
        raise AssertionError(f"{label}: partition ids differ from the plain Murmur3 chain's")


def same_tables(a, b):
    """Two collected results hold the same values: each column's data,
    validity and offsets (a string payload up to its last offset)."""
    if a.num_rows != b.num_rows or len(a.columns) != len(b.columns):
        return False
    for x, y in zip(a.columns, b.columns):
        if not torch.equal(x.validity_or_true(), y.validity_or_true()):
            return False
        if x.offsets is None:
            if not torch.equal(x.data, y.data):
                return False
        elif not (torch.equal(x.offsets, y.offsets)
                  and torch.equal(x.data[:int(x.offsets[-1])], y.data[:int(y.offsets[-1])])):
            return False
    return True


def ss_serve_source(path, n_rg, drain=None):
    """The store_sales tenant's lazy chunk source: phase 12's file through
    ScanPlan -> prefetch_chunks, its first ``n_rg`` row groups. Records
    the wall of its drain into ``drain`` (first request to last chunk)."""
    from spark_rapids_jni_tpu_torch.api import ScanPlan, prefetch_chunks

    t0 = time.perf_counter()
    with ScanPlan(path, columns=SS_COLUMNS) as plan:
        gen = prefetch_chunks(plan)
        try:
            for i, chunk in enumerate(gen):
                if i == n_rg:
                    break
                yield chunk
        finally:
            gen.close()
    if drain is not None:
        drain.append((t0, time.perf_counter()))


def serve_tenants(q1_ctx, q5_ctx, ss_path, ss_oracles, shuffle_rows=SERVE_SHUFFLE_ROWS,
                  device="cuda"):
    """The four tenants of phase 29. Each: its Pipeline, one chunk-source
    factory per job, the rows of each job, and ``check(job, i, out)``
    holding chunk ``i`` of job ``job`` against its host oracle."""
    from spark_rapids_jni_tpu_torch.api import Aggregation, Pipeline

    q1_tabs, q1_want = q1_ctx["tables"][:4], q1_ctx["want"][:4]
    li, d = q5_ctx["tables"]["lineitem"], q5_ctx["data"]
    q5_pipe = (Pipeline("q5")
               .join(q5_ctx["build"], [0], [0], "inner", right_string_widths={2: 16})
               .join(q5_ctx["supplier"], [1, 5], [0, 1], "inner", left_string_widths={6: 16})
               .map(q5_revenue, name="q5_revenue")
               .group_by([6], [Aggregation.Agg("sum", 9)], capacity=32, string_widths={6: 16}))
    q5_want = [sorted(q5_oracle(d, i * Q5_BATCH, (i + 1) * Q5_BATCH).items()) for i in range(6)]
    rng = np.random.default_rng(29)
    sh_arrays = [q1_batch_arrays(rng, shuffle_rows) for _ in range(4)]
    sh_keys = [d["l_orderkey"][i * shuffle_rows:(i + 1) * shuffle_rows] for i in range(4)]
    sh_tabs = [q1_shuffle_chunk(a, k, device) for a, k in zip(sh_arrays, sh_keys)]
    drains = []

    def q1_check(job, i, out):
        if q1_rows(out) != q1_want[i]:
            raise AssertionError(f"serving q1 job {job} chunk {i} differs from the host oracle")

    def q5_check(job, i, out):
        if q5_rows(out) != q5_want[3 * job + i]:
            raise AssertionError(f"serving q5 job {job} batch {i} differs from the host oracle")

    def ss_check(job, i, out):
        if ss_result(out) != ss_oracles[i]:
            raise AssertionError(f"serving store_sales row group {i} differs from the oracle")

    def sh_check(job, i, out):
        q1_shuffle_check(out, sh_arrays[i], sh_keys[i], f"serving q1_shuffle job {job} chunk {i}")

    ss_rows = sum(min(SS_RG, SS_ROWS - i * SS_RG) for i in range(SERVE_SS_ROW_GROUPS))
    return {
        "q1": {"pipe": q1_pipeline("q1"), "sources": [lambda: q1_tabs] * 2,
               "rows": [sum(t.num_rows for t in q1_tabs)] * 2, "check": q1_check},
        "q5": {"pipe": q5_pipe, "sources": [lambda: li[0:3], lambda: li[3:6]],
               "rows": [sum(t.num_rows for t in li[0:3]), sum(t.num_rows for t in li[3:6])],
               "check": q5_check},
        "store_sales": {"pipe": ss_pipeline("store_sales"),
                        "sources": [lambda: ss_serve_source(ss_path, SERVE_SS_ROW_GROUPS,
                                                            drains)],
                        "rows": [ss_rows], "check": ss_check, "drains": drains,
                        # submitted once the others are in flight: its scan
                        # drains on the dispatch thread while they wait
                        "submit_delay_s": 0.05},
        "q1_shuffle": {"pipe": q1_shuffle_pipeline("q1_shuffle"), "sources": [lambda: sh_tabs] * 2,
                       "rows": [sum(t.num_rows for t in sh_tabs)] * 2, "check": sh_check},
    }


def serve_round(srv, sessions, tenants, during=None, rejects=None):
    """Every tenant's jobs submitted at once from the tenant's own client
    thread. ``during()`` runs on this thread while they are served. A job
    refused at admission raises unless ``rejects`` (a list) collects it.
    Returns the round's wall seconds and {tenant: ([(source index, job)],
    wall s)}."""
    import threading

    from spark_rapids_jni_tpu_torch.serving import AdmissionRejected

    out, errors = {}, []
    gate = threading.Barrier(len(tenants) + 1)

    def client(name, spec):
        try:
            gate.wait()
            t0 = time.perf_counter()
            time.sleep(spec.get("submit_delay_s", 0.0))
            jobs = [srv.submit(sessions[name], spec["pipe"], src(), window=2)
                    for src in spec["sources"]]
            done = []
            for k, j in enumerate(jobs):
                try:
                    j.result(timeout=600)
                    done.append((k, j))
                except AdmissionRejected as e:
                    if rejects is None:
                        raise
                    rejects.append((name, e.reason, e.estimate))
            out[name] = (done, time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=item, name=f"client-{item[0]}")
               for item in tenants.items()]
    for th in threads:
        th.start()
    gate.wait()
    t0 = time.perf_counter()
    try:
        if during is not None:
            during(lambda: any(th.is_alive() for th in threads))
    finally:
        for th in threads:
            th.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"serving round: {errors}")
    return wall, out


def check_round(tenants, out, serial=None):
    """Every job's results against its tenant's oracle and, when given,
    the serial single-tenant run of the same chunks."""
    for name, (jobs, _) in out.items():
        spec = tenants[name]
        for k, job in jobs:
            for i, res in enumerate(job.results):
                spec["check"](k, i, res)
                if serial is not None and not same_tables(res, serial[name][k][i]):
                    raise AssertionError(f"serving {name} job {k} chunk {i} differs from the "
                                         f"serial run of the same chunks")


def closure_error(job):
    """|queued + dispatch + device + retire - e2e| of a finished job, ms."""
    return abs(sum(job.states.values()) - job.e2e_ms)


def device_busy(fn):
    """``fn()`` under torch.profiler: (device busy us as the union of
    kernel intervals, the window from the first host op to the last
    kernel end in us, kernel count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA)
    if not dev:
        return None
    window = max(e for _, e in dev) - min(e.time_range.start for e in events)
    return union_us(dev), window, len(dev)


def spans_resolve(tree, pending):
    """Walk every in-flight ``Pipeline.*`` op span of one ``/spans``
    scrape up its parents: it must pass its task span and reach its job
    span. ``pending`` maps an op span id to its consecutive failed
    scrapes (a span moving between a thread's stack and the detached set
    between the two reads of one scrape misses once). Returns the ops
    resolved."""
    nodes = [s for th in tree["threads"] for s in th["stack"]] + tree["detached"]
    by_id = {s["span_id"]: s for s in nodes}
    resolved = 0
    for s in nodes:
        if s["kind"] != "op" or not s["name"].startswith("Pipeline."):
            continue
        cur, kinds = s, []
        while cur is not None and cur["kind"] != "job":
            kinds.append(cur["kind"])
            cur = by_id.get(cur["parent_id"])
        if cur is not None and "task" in kinds:
            resolved += 1
            pending.pop(s["span_id"], None)
        else:
            pending[s["span_id"]] = pending.get(s["span_id"], 0) + 1
            if pending[s["span_id"]] >= 3:
                raise AssertionError(f"/spans: op span {s['name']} does not resolve to its task "
                                     f"and job in 3 scrapes: {kinds}")
    return resolved


def scrape_during(port, sessions_expected, seen, alive):
    """The diag scrapes while the counted round runs: /healthz,
    /metrics, /sessions, /slo, /plans once each, /profile?seconds=1 on a
    thread of its own, and /spans until the round's clients are done."""
    import threading
    import urllib.request

    from spark_rapids_jni_tpu_torch.runtime import diag

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
            return r.read().decode()

    prof = {}

    def profile():
        try:
            prof["text"] = get("/profile?seconds=1")
        except Exception as e:  # noqa: BLE001 -- re-raised below
            prof["error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=profile, name="scrape-profile")
    th.start()
    health = json.loads(get("/healthz"))
    if not health["ok"] or not health["sampler"]["running"]:
        raise AssertionError(f"/healthz: {health}")
    diag.parse_prom_text(get("/metrics"))
    rows = [r for r in json.loads(get("/sessions"))["sessions"] if "session" in r]
    if len(rows) != sessions_expected:
        raise AssertionError(f"/sessions: {len(rows)} rows, want {sessions_expected}")
    slo = json.loads(get("/slo"))
    plans = json.loads(get("/plans"))
    if set(plans) != {"plans", "explain", "exec_feedback", "exec_programs"} or "histograms" not in slo:
        raise AssertionError("/plans or /slo: unexpected document")
    pending = {}
    seen["spans_scrapes"] = 0
    seen["ops_resolved"] = 0
    while th.is_alive() or alive():
        seen["ops_resolved"] += spans_resolve(json.loads(get("/spans")), pending)
        seen["spans_scrapes"] += 1
        time.sleep(0.05)
    th.join()
    if "error" in prof:
        raise AssertionError(f"/profile: {prof['error']}")
    if "session:" not in prof["text"]:
        raise AssertionError(f"/profile?seconds=1 shows no session: frame: {prof['text'][:300]}")
    seen["profile_stacks"] = len(prof["text"].splitlines())
    seen["plans"] = len(plans["plans"])


def tenant_stats(tenants, out, slices=None):
    """Per tenant: jobs, rows, e2e ms of each job, the time-in-state ms
    summed over its jobs, served rows/s over its client's wall, slices
    per job, the largest gap between two slices of one job."""
    stats = {}
    for name, (jobs, wall) in out.items():
        spec = tenants[name]
        rows = sum(spec["rows"][k] for k, _ in jobs)
        st = {"jobs": len(jobs), "rows": rows, "e2e_ms": [j.e2e_ms for _, j in jobs],
              "states_ms": {k: sum(j.states[k] for _, j in jobs) for k in jobs[0][1].states},
              "served_rows/s": rows / wall}
        if slices is not None:
            marks = [slices.get(j.job_id, []) for _, j in jobs]
            st["slices_per_job"] = sum(len(m) for m in marks) / len(jobs)
            st["max_slice_gap_ms"] = max(
                [(b[1] - a[2]) * 1e3 for m in marks for a, b in zip(m, m[1:])] or [0.0])
        stats[name] = st
    return stats


def serving_phase(counters, card, q1_ctx, q5_ctx, ss_path, ss_oracles, tmp):
    """Phase 29: the multi-tenant serving driver on the card. Four
    sessions (q1, q5, store_sales through a lazy scan source, and a
    shuffle-write tenant that places rows with the murmur3 kernel), each
    submitting from its own client thread to one ``api.serving_server``
    with the diag server up and the sampler armed at 19 Hz: every job
    exact against its host oracle and the serial single-tenant run of
    the same chunks; the diag scrapes while it runs; rows/s, e2e
    p50/p99 and the time in each state per tenant, the time-in-state
    closure, slices per job, plan-cache misses and hits, the admission
    estimate beside the measured peak, the device idle share, the
    sampler's cost in turns; one warm dispatch slice under sync debug
    mode "error"; a 1/8-capacity burst that queues and rejects at the
    door; one slow-job flight bundle; a ``trace.timeline`` of one q1
    chunk and the phase's journal through ``traceview``. Returns the
    kernel launches of the counted round."""
    import urllib.request

    from spark_rapids_jni_tpu_torch.api import Pipeline, serving_server
    from spark_rapids_jni_tpu_torch.runtime import diag, flight, metrics, sampler, trace, traceview
    from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
    from spark_rapids_jni_tpu_torch.serving import Server

    tenants = serve_tenants(q1_ctx, q5_ctx, ss_path, ss_oracles)
    journal = os.path.join(tmp, "serving_journal.jsonl")
    prev_mode = metrics.configure(journal)
    port = diag.start(0)
    sampler.start(SAMPLER_HZ)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _total = torch.cuda.mem_get_info()
    srv = serving_server(free - SERVE_MARGIN)
    sessions = {name: srv.open_session(name) for name in tenants}
    servers = [srv]
    env_keys = (flight._ENV_VAR, flight.SLO_ENV_VAR)
    env_prev = {k: os.environ.get(k) for k in env_keys}

    def scrape(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
            return r.read().decode()

    try:
        # ---- the counted round: counts at 0, four tenants at once
        slices, seen = {}, {}
        orig_slice = Server._slice

        def timed_slice(self, job):
            t0 = time.perf_counter()
            try:
                orig_slice(self, job)
            finally:
                slices.setdefault(job.job_id, []).append((job.session.name, t0,
                                                          time.perf_counter()))

        m0 = plan_counts()[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        served_base = torch.cuda.memory_allocated()
        for name in counters:
            counters[name].launches = 0
        Server._slice = timed_slice
        try:
            wall, out = serve_round(srv, sessions, tenants, during=lambda alive: scrape_during(
                port, len(tenants), seen, alive))
        finally:
            Server._slice = orig_slice
        launches = {name: c.launches for name, c in counters.items()}
        served_peak = torch.cuda.max_memory_allocated()
        builds = plan_counts()[0] - m0
        check_round(tenants, out)
        n_done = sum(len(jobs) for jobs, _ in out.values())
        prom = diag.parse_prom_text(scrape("/metrics"))
        e2e_count = prom[diag.prom_name("serving.e2e_ms") + "_count"]
        if e2e_count != n_done or prom[diag.prom_name("serving.jobs_done") + "_total"] != n_done:
            raise AssertionError(f"/metrics: serving.e2e_ms count {e2e_count}, "
                                 f"{n_done} jobs done")
        counted = tenant_stats(tenants, out, slices)
        drain = tenants["store_sales"]["drains"][-1]
        for name, st in counted.items():
            gaps = [(b[1] - a[2]) * 1e3 for marks in slices.values()
                    for a, b in zip(marks, marks[1:])
                    if a[0] == name and a[2] < drain[1] and b[1] > drain[0]]
            st["max_slice_gap_during_scan_drain_ms"] = max(gaps or [0.0])
        estimates = {name: [j.estimate for _, j in jobs] for name, (jobs, _) in out.items()}
        rows_table = {r["session"]: r for r in srv.sessions_table() if "session" in r}
        plan_builds = {r["pipeline"]: r["build_wall_ms"] for r in pl.plan_cache_table()
                       if r["pipeline"] in tenants}
        all_jobs = [j for jobs, _ in out.values() for _, j in jobs]

        # ---- each tenant's first job alone from a cold plan cache: its
        # peak over the memory allocated before (the graph's warm-up run
        # and capture included); the cleared graphs' pool is released
        # and the next capture takes a fresh one
        cold_peaks = {}
        for name, spec in tenants.items():
            pl.plan_cache_clear()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            spec["pipe"].stream(spec["sources"][0](), window=2)
            torch.cuda.synchronize()
            cold_peaks[name] = torch.cuda.max_memory_allocated() - base

        # ---- the serial single-tenant runs of the same jobs (warm)
        serial, serial_s, peaks = {}, {}, {}
        for name, spec in tenants.items():
            serial[name], serial_s[name], peaks[name] = [], 0.0, 0
            for src in spec["sources"]:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                serial[name].append(spec["pipe"].stream(src(), window=2))
                torch.cuda.synchronize()
                serial_s[name] += time.perf_counter() - t0
                peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() - base)
        check_round(tenants, out, serial)

        # ---- the sampler's cost: rounds with it disarmed and armed, in turns
        turns = {"on": [], "off": []}
        for state in SAMPLER_TURNS:
            if state == "on":
                sampler.start(SAMPLER_HZ)
            else:
                sampler.stop()
            w, o = serve_round(srv, sessions, tenants)
            check_round(tenants, o, serial)
            turns[state].append(sum(sum(tenants[n]["rows"][k] for k, _ in jobs)
                                    for n, (jobs, _) in o.items()) / w)
            all_jobs += [j for jobs, _ in o.values() for _, j in jobs]
            for name, st in tenant_stats(tenants, o).items():
                counted[name]["e2e_ms"] += st["e2e_ms"]
        sampler.start(SAMPLER_HZ)
        # queued + dispatch + device + retire must close on the e2e wall
        closure = [(closure_error(j), max(0.5, 0.005 * j.e2e_ms), j.e2e_ms) for j in all_jobs]
        if any(err > bound for err, bound, _ in closure):
            raise AssertionError(f"time-in-state closure: {[c for c in closure if c[0] > c[1]]}")

        # ---- a real CUDA OOM inside one tenant's job fails that job only
        oom_session = srv.open_session("oom")
        doomed = srv.submit(oom_session, Pipeline("oom").map(oom_stage, name="oom"),
                            q1_ctx["tables"][:2])
        fine = srv.submit(sessions["q1"], tenants["q1"]["pipe"], q1_ctx["tables"][:4])
        try:
            doomed.result(timeout=600)
        except torch.cuda.OutOfMemoryError as e:
            oom_msg = str(e).splitlines()[0][:120]
        else:
            raise AssertionError("the OOM tenant's job did not fail")
        for i, res in enumerate(fine.result(timeout=600)):
            tenants["q1"]["check"](0, i, res)
        if not srv._thread.is_alive():
            raise AssertionError("a tenant's OOM stopped the dispatch loop")

        # ---- the device idle share over one served round
        prof_out = {}
        busy = device_busy(lambda: prof_out.setdefault(
            "r", serve_round(srv, sessions, tenants)))
        check_round(tenants, prof_out["r"][1], serial)

        # ---- one warm dispatch slice under sync debug mode "error"
        orig_dispatch = Server._dispatch_one
        strict = []

        def strict_dispatch(self, job):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                orig_dispatch(self, job)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            strict.append(job.job_id)

        sync_session = srv.open_session("sync_free")
        q1_tabs = q1_ctx["tables"][:2]
        m0 = plan_counts()[0]
        Server._dispatch_one = strict_dispatch
        try:
            got = srv.submit(sync_session, tenants["q1"]["pipe"], q1_tabs).result(timeout=600)
        finally:
            Server._dispatch_one = orig_dispatch
        if len(strict) != 2 or plan_counts()[0] != m0:
            raise AssertionError(f"sync-free check: {len(strict)} slices, a plan was built")
        for i, res in enumerate(got):
            tenants["q1"]["check"](0, i, res)

        # ---- the slow-job trigger: one job past its deadline, one bundle
        fdir = os.path.join(tmp, "flight")
        os.environ[flight._ENV_VAR] = fdir
        os.environ[flight.SLO_ENV_VAR] = "3"
        slo_job = srv.submit(sync_session, tenants["q1"]["pipe"], q1_tabs[:1], deadline_s=0.001)
        slo_job.result(timeout=600)
        for k in env_keys:
            os.environ.pop(k)
        bundles = [b for b in os.listdir(fdir)
                   if os.path.exists(os.path.join(fdir, b, "slo.json"))]
        if len(bundles) != 1 or slo_job.slo_bundle != os.path.join(fdir, bundles[0]):
            raise AssertionError(f"slow-job bundles: {bundles}")
        with open(os.path.join(slo_job.slo_bundle, "slo.json")) as f:
            slo = json.load(f)
        with open(os.path.join(slo_job.slo_bundle, "sampler.txt")) as f:
            samp = f.read()
        if slo["reason"] != "deadline" or len(slo["span_tree"]) < 2 or "session:" not in samp:
            raise AssertionError(f"slow-job bundle: {slo['reason']}, "
                                 f"{len(slo['span_tree'])} tree nodes, sampler.txt {samp[:200]!r}")

        # ---- overload: a burst at 1/8 of the priced estimates
        burst = {name: dict(spec, sources=(spec["sources"] * 2)[:2])
                 for name, spec in tenants.items()}
        burst_est = sum(sum((estimates[name] * 2)[:2]) for name in burst)
        srv2 = Server(burst_est // 8, max_queue=4).start()
        servers.append(srv2)
        sessions2 = {name: srv2.open_session(name) for name in burst}
        q0, r0 = (metrics.counter_value("admission.queued"),
                  metrics.counter_value("admission.rejected"))
        rejects = []
        _, o2 = serve_round(srv2, sessions2, burst, rejects=rejects)
        queued = metrics.counter_value("admission.queued") - q0
        rejected = metrics.counter_value("admission.rejected") - r0
        for name, (jobs, _) in o2.items():
            for k, job in jobs:
                for i, res in enumerate(job.results):
                    burst[name]["check"](k, i, res)
                    if not same_tables(res, serial[name][k % len(serial[name])][i]):
                        raise AssertionError(f"burst {name} job {k} chunk {i} differs")
        if queued < 1 or rejected < 1:
            raise AssertionError(f"1/8-capacity burst: queued {queued}, rejected {rejected}")
        admitted = sum(len(jobs) for jobs, _ in o2.values())

        # ---- trace.timeline over one q1 chunk; the journal through traceview
        with trace.timeline(os.path.join(tmp, "timeline")) as prof:
            tenants["q1"]["pipe"].run(q1_tabs[0])
        with open(prof.trace_path) as f:
            tl = json.load(f)["traceEvents"]
        n_kernels = sum(1 for e in tl if e.get("cat") == "kernel")
        if n_kernels < 1 or not any(e.get("name") == "Pipeline.q1" for e in tl):
            raise AssertionError(f"timeline: {n_kernels} kernel events, Pipeline.q1 range "
                                 f"{any(e.get('name') == 'Pipeline.q1' for e in tl)}")
    finally:
        for s in servers:
            s.shutdown()
        sampler.stop()
        diag.stop()
        metrics.configure(prev_mode)
        for k, v in env_prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _, trace_doc, n_events = traceview.convert(journal, os.path.join(tmp, "serving.trace.json"))
    problems = traceview.check_trace(trace_doc, min_spans=10)
    if problems:
        raise AssertionError(f"traceview of the phase's journal: {problems[:5]}")

    for name, st in counted.items():
        e2e = np.asarray(st.pop("e2e_ms"))
        st["e2e_p50_ms"] = float(np.percentile(e2e, 50))
        st["e2e_p99_ms"] = float(np.percentile(e2e, 99))
        st["e2e_jobs"] = len(e2e)
        st["serial_rows/s"] = sum(tenants[name]["rows"]) / serial_s[name]
        st["plan_cache"] = rows_table[name]["plan_cache"]
        st["estimate_bytes"] = estimates[name]
        st["cold_peak_bytes"] = cold_peaks[name]
        st["warm_peak_bytes"] = peaks[name]
        st["plan_build_ms"] = plan_builds.get(name)
        print(f"serving [{name}]: {json.dumps(st)}", flush=True)
    total_rows = sum(sum(t["rows"]) for t in tenants.values())
    print(f"serving: {n_done} jobs of 4 tenants exact against their host oracles and their "
          f"serial runs; counted round {wall * 1e3:.1f} ms, {total_rows / wall:.4g} rows/s, "
          f"{builds} plans built in it on the dispatch thread, "
          f"store_sales scan drained there in {(drain[1] - drain[0]) * 1e3:.1f} ms; served "
          f"peak bytes {served_peak} ({served_peak - served_base} over the {served_base} "
          f"allocated before); "
          f"kernel launches {json.dumps(launches)}", flush=True)
    print(f"serving: time-in-state closure within max(0.5 ms, 0.5 %) for {len(all_jobs)} jobs "
          f"(largest error {max(c[0] for c in closure):.4f} ms, "
          f"{max(c[0] / c[2] for c in closure):.2e} of e2e); device busy "
          + (f"{busy[0]:.1f} us of a {busy[1]:.1f} us served window (idle "
             f"{1 - busy[0] / busy[1]:.3f}, {busy[2]} kernels)" if busy else "not measured")
          + f"; sampler at {SAMPLER_HZ:g} Hz rows/s on {json.dumps(turns['on'])} off "
          f"{json.dumps(turns['off'])}", flush=True)
    print(f"serving scrapes: /healthz /metrics /sessions /slo /plans ok; /spans "
          f"{seen['spans_scrapes']} scrapes, {seen['ops_resolved']} in-flight op spans resolved "
          f"to task and job; /profile?seconds=1 {seen['profile_stacks']} stacks with session "
          f"frames; one warm dispatch slice x2 under sync debug mode 'error'; burst at 1/8 of "
          f"{burst_est} priced bytes: {admitted} admitted exact, queued {queued}, rejected "
          f"{rejected} {json.dumps(rejects)}; a real OOM ({oom_msg}) failed its job only; "
          f"slow-job bundle {os.path.basename(slo_job.slo_bundle)}"
          f" ({len(slo['span_tree'])} span-tree nodes, sampler.txt {len(samp.splitlines())} "
          f"stacks); timeline {n_kernels} kernel events; traceview {n_events} events, "
          f"check ok; card: {card}", flush=True)
    return launches


def main() -> int:
    phase_t = [time.perf_counter()]

    def phase_done(label):
        now = time.perf_counter()
        print(f"phase {label}: {now - phase_t[0]:.1f} s wall", flush=True)
        phase_t[0] = now

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    import spark_rapids_jni_tpu_torch as port
    from spark_rapids_jni_tpu_torch.api import RowConversion
    from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy
    from spark_rapids_jni_tpu_torch.kernels import _build, murmur3
    from spark_rapids_jni_tpu_torch.parallel import spark_hash

    # ---- 2. build
    sources = _build.kernel_sources() + sorted(_build.HOST_SOURCES)
    t0 = time.perf_counter()
    logs = _build.build(*sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.2f} s; host libraries: "
          f"{_build.describe_host_libraries()}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 3. kernel parity, exact
    max_err = 0
    n_cases = 0
    seeds = (0, 42, 12345, spark_hash.salted_seed(1))

    def parity(table, seed):
        nonlocal max_err, n_cases
        words, valids, plan = murmur3.table_plan(table)
        got = murmur3.hash_planes(words, valids, plan, seed)
        want = murmur3.hash_planes_plain(words, valids, plan, seed)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        n_cases += 1
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain: n={table.num_rows} seed={seed} plan={plan}")

    for n in (7, 1024, 2500, N_MAIN):
        matrix = table_from_numpy(type_matrix_spec(n, seed=n), device="cuda")
        for seed in seeds:
            parity(matrix, seed)
            for col in matrix.columns:
                parity(port.Table([col]), seed)
    spec = lineitem_spec(N_MAIN)
    full = table_from_numpy(spec, device="cuda")
    for seed in seeds:
        parity(full, seed)
    print(f"kernel parity: {n_cases} cases exact (max |diff| {max_err})", flush=True)

    keys = port.Table([full.columns[i] for i in KEYS])
    kw, kv, kplan = murmur3.table_plan(keys)
    seed = spark_hash.DEFAULT_SEED
    timings = {}
    for label, (w, v, plan) in (("keys", (kw, kv, kplan)),
                                ("all11", murmur3.table_plan(full))):
        n = w.shape[1]
        ms = time_ms(lambda: murmur3.hash_planes(w, v, plan, seed), 50)
        plain_ms = time_ms(lambda: murmur3.hash_planes_plain(w, v, plan, seed), 10)
        nbytes = 4 * w.numel() + v.numel() + 4 * n
        ops = n * (11 * w.shape[0] + 10 * len(plan))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
        timings[label] = {
            "W": w.shape[0], "V": v.shape[0], "n": n, "ms": ms, "plain_ms": plain_ms,
            "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print(f"murmur3 timing [{label}]: {json.dumps(timings[label])}", flush=True)

    # ---- 4. main path, counted
    schema = [c.dtype for c in full.columns]
    torch.cuda.synchronize()
    murmur3.launches = 0
    pids = spark_hash.partition_ids(keys, NUM_PARTITIONS)
    rows = RowConversion.convertToRows(full)
    back = RowConversion.convertFromRows(rows, schema)
    torch.cuda.synchronize()
    main_launches = murmur3.launches
    if main_launches < 1:
        raise AssertionError("the main path did not launch the murmur3 kernel")

    plain_pids = spark_hash.pmod(murmur3.hash_planes_plain(kw, kv, kplan, seed), NUM_PARTITIONS)
    if not torch.equal(pids, plain_pids):
        raise AssertionError("partition ids differ from the plain version")
    if pids.shape != (N_MAIN,) or int(pids.min()) < 0 or int(pids.max()) >= NUM_PARTITIONS:
        raise AssertionError("partition ids out of range")
    a = full.columns[KEYS[0]].data[:4096].cpu().numpy()
    b = full.columns[KEYS[1]].data[:4096].cpu().numpy()
    ref = murmur3_numpy_int64_pairs(a, b)
    ref_pids = ((ref.astype(np.int64) % NUM_PARTITIONS) + NUM_PARTITIONS) % NUM_PARTITIONS
    if not np.array_equal(pids[:4096].cpu().numpy(), ref_pids):
        raise AssertionError("partition ids differ from the numpy Murmur3 reference")
    golden = port.Table([port.Column.from_numpy(np.array([1, 0], np.int32), port.INT32)])
    if spark_hash.hash_columns(golden).cpu().tolist() != [-559580957, 933211791]:
        raise AssertionError("Spark golden hash(1), hash(0) mismatch")

    def check_round_trip(src, got, label):
        if len(got.columns) != len(src.columns):
            raise AssertionError(f"{label}: column count")
        for i, (c_in, c_out) in enumerate(zip(src.columns, got.columns)):
            same = torch.equal(c_in.data, c_out.data) and (
                c_in.offsets is None or torch.equal(c_in.offsets, c_out.offsets)
            )
            if not same or not bool(c_out.validity.all()):
                raise AssertionError(f"{label}: round trip differs at column {i}")

    check_round_trip(full, back, "lineitem 4Mi")
    row_bytes = sum(int(r.data.numel()) for r in rows)

    stages = {
        "partition_ids": host_ms(lambda: spark_hash.partition_ids(keys, NUM_PARTITIONS), 5),
        "convertToRows": host_ms(lambda: RowConversion.convertToRows(full), 5),
        "convertFromRows": host_ms(lambda: RowConversion.convertFromRows(rows, schema), 5),
    }
    for name, ms in stages.items():
        print(f"main path [{name}]: {ms:.3f} ms, {N_MAIN / (ms / 1e3):.4g} rows/s")
    print(f"main path: {N_MAIN} rows, {row_bytes} row bytes, murmur3 launches {main_launches}",
          flush=True)
    profile_stage("partition_ids", lambda: spark_hash.partition_ids(keys, NUM_PARTITIONS))
    profile_stage("convertToRows", lambda: RowConversion.convertToRows(full))
    profile_stage("convertFromRows", lambda: RowConversion.convertFromRows(rows, schema))

    # ---- 5. two more shapes, exact round trips
    for label, table in (
        ("212 cols x 1Mi", cycled_table(port, N_WIDE)),
        ("strings 1Mi", table_from_numpy(strings_spec(N_WIDE), device="cuda")),
    ):
        sch = [c.dtype for c in table.columns]
        r = RowConversion.convertToRows(table)
        check_round_trip(table, RowConversion.convertFromRows(r, sch), label)
        nbytes = sum(int(x.data.numel()) for x in r)
        to_ms = host_ms(lambda: RowConversion.convertToRows(table))
        from_ms = host_ms(lambda: RowConversion.convertFromRows(r, sch))
        print(f"{label}: {len(r)} batch(es), {nbytes} row bytes; convertToRows "
              f"{to_ms:.3f} ms, convertFromRows {from_ms:.3f} ms, exact", flush=True)
        del table, r

    phase_done("1-5 device, build, kernel parity, main path, shapes")

    # ---- 6. card against CPU, exact
    card_vs_cpu(N_MIXED)
    phase_done("6 card vs cpu")

    counters = {"murmur3_chain": murmur3}
    launches = {"rung 1": main_launches}
    # ---- 7. the q1 path at SF10, counted
    launches["q1"] = q1_sf10(counters, card)["murmur3_chain"]
    phase_done("7 q1 sf10")

    # ---- 8. joins, card against CPU, exact
    join_card_vs_cpu(N_MIXED)
    phase_done("8 join card vs cpu")

    # ---- 9. the q5 path at SF10, counted
    q5_launches, q5_ctx = q5_sf10(counters, card)
    launches["q5"] = q5_launches["murmur3_chain"]
    phase_done("9 q5 sf10")

    # ---- 10. host JCUDF codec against the card's rows
    host_codec(spec, rows, card)
    phase_done("10 host codec")

    # ---- 11. casts and get_json_object, card against CPU, exact
    cast_json_card_vs_cpu(N_MIXED)
    phase_done("11 cast/json card vs cpu")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        ss_path = os.path.join(tmp, "store_sales.parquet")
        # ---- 12. store_sales at SF10 through Parquet, counted
        ss_launches, ss_oracles = store_sales_sf10(counters, card, ss_path)
        launches["store_sales"] = ss_launches["murmur3_chain"]
        phase_done("12 store_sales sf10")

        # ---- 13. float casts and from_json, card against CPU, exact
        float_json_card_vs_cpu(N_MIXED)
        phase_done("13 float/from_json card vs cpu")

        # ---- 14. the reference's string->float axis, counted
        launches["float_cast"] = float_axis(counters, card)["murmur3_chain"]
        phase_done("14 float axis")

        # ---- 15. from_json over SF10 store_sales, counted
        launches["from_json"] = from_json_sf10(counters, card, ss_path)["murmur3_chain"]
        phase_done("15 from_json sf10")

        # ---- 16. nested Parquet, card and CPU against the generator
        launches["nested_parquet"] = nested_parquet(
            counters, card, os.path.join(tmp, "nested.parquet"))["murmur3_chain"]
        phase_done("16 nested parquet")

        # ---- 17. rung 4 through the streamed scan, counted
        launches["scan"] = scan_sf10(counters, card, ss_path, ss_oracles)["murmur3_chain"]
        phase_done("17 scan sf10")

        # ---- 18. Regex at the regex_scan axes, counted; card against CPU
        launches["regex"] = regex_phase(counters, card)["murmur3_chain"]
        phase_done("18 regex")

        # ---- 19. ZOrder on rung 1's lineitem batch, counted
        launches["zorder"] = zorder_phase(counters, card)["murmur3_chain"]
        phase_done("19 zorder")

        # ---- 20. window and rollup, card against CPU; window over rung 1's batch
        launches["window"] = window_phase(counters, card, full)["murmur3_chain"]
        phase_done("20 window/rollup")

        # ---- 21. q1 SF10 through Pipeline.run, stream and two threads, counted
        q1_launches, q1_ctx = q1_pipeline_phase(counters, card)
        launches["q1_pipeline"] = q1_launches["murmur3_chain"]
        phase_done("21 q1 pipeline")

        # ---- 22. one q5 lineitem batch through the Pipeline, counted
        launches["q5_pipeline"] = q5_pipeline_phase(counters, card, q5_ctx)["murmur3_chain"]
        phase_done("22 q5 pipeline")

        # ---- 23. store_sales SF10 through Pipeline.scan_parquet, counted
        launches["ss_pipeline"] = ss_pipeline_phase(
            counters, card, ss_path, ss_oracles)["murmur3_chain"]
        phase_done("23 store_sales pipeline")

        # ---- 24. the retry runtime on the card, counted
        launches["retry"] = retry_phase(counters, card, q1_ctx)["murmur3_chain"]
        phase_done("24 retry")

        # ---- 25. the exchange over 8 shards, card against CPU, exact
        exchange_card_vs_cpu(N_MIXED, card)
        phase_done("25 exchange card vs cpu")

        # ---- 26. q5 at SF10 over the exchange, counted
        q5x_launches, exchange_shape = q5_exchange_sf10(counters, card, q5_ctx)
        launches["q5_exchange"] = q5x_launches["murmur3_chain"]
        phase_done("26 q5 exchange sf10")

        # ---- 27. the mesh executors under the retry runtime, counted
        launches["mesh_executors"] = mesh_executors_phase(
            counters, card, q1_ctx, q5_ctx)["murmur3_chain"]
        phase_done("27 mesh executors")

        # ---- 28. the sharded stream against the unsharded one, counted
        launches["sharded_stream"] = sharded_stream_phase(
            counters, card, q1_ctx, q5_ctx)["murmur3_chain"]
        phase_done("28 sharded stream")

        # ---- 29. four tenants through the serving driver, counted
        launches["serving"] = serving_phase(
            counters, card, q1_ctx, q5_ctx, ss_path, ss_oracles, tmp)["murmur3_chain"]
        del q1_ctx, q5_ctx
        phase_done("29 serving")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    on_exchange = ("rung 1", "q5_exchange", "mesh_executors", "sharded_stream", "serving")
    for path, count in launches.items():
        if (count >= 1) != (path in on_exchange):
            raise AssertionError(f"murmur3 launches on the {path} path: {count}")

    # ---- 30. kernel numbers, card, verdict
    k = timings["keys"]
    print(json.dumps({"kernels": [{
        "name": "murmur3_chain",
        "route": "cuda",
        "source": "spark_rapids_jni_tpu_torch/kernels/csrc/murmur3.cu",
        "replaces": "spark_rapids_jni_tpu/kernels/murmur3.py:101",
        "launches": main_launches,
        "launches_by_path": launches,
        "exchange_shape": {k: exchange_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bytes")},
        "max_abs_err": max_err,
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
