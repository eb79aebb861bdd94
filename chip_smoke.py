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
  2. build: compiles every kernel source of the port (one nvcc each)
  3. kernel parity: the kernel against its plain PyTorch version on the
     card, exact, over a matrix of types, nulls, seeds and row counts;
     times both with CUDA events
  4. main path: counts set to 0, the path driven through the public
     entry points, counts read; partition ids against the plain version
     and an independent numpy Murmur3, the round trip exact
  5. two more shapes: the reference's 212-column fixed-width nvbench
     table and bench.py's strings table, both at 1 Mi rows, exact
  6. one JSON line of kernel numbers, the card line, then the verdict

Exits non-zero, printing no verdict, without a card or without the port
beside it. Data is made from fixed seeds.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

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
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
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


def main() -> int:
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
    sources = sorted(f[:-3] for f in os.listdir(_build.SRC_DIR) if f.endswith(".cu"))
    t0 = time.perf_counter()
    logs = _build.build(*sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.2f} s", flush=True)
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
    full = table_from_numpy(lineitem_spec(N_MAIN), device="cuda")
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

    def stage_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        best = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best.append((time.perf_counter() - t) * 1e3)
        return float(np.median(best))

    stages = {
        "partition_ids": stage_ms(lambda: spark_hash.partition_ids(keys, NUM_PARTITIONS)),
        "convertToRows": stage_ms(lambda: RowConversion.convertToRows(full)),
        "convertFromRows": stage_ms(lambda: RowConversion.convertFromRows(rows, schema)),
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
        to_ms = stage_ms(lambda: RowConversion.convertToRows(table), reps=3)
        from_ms = stage_ms(lambda: RowConversion.convertFromRows(r, sch), reps=3)
        print(f"{label}: {len(r)} batch(es), {nbytes} row bytes; convertToRows "
              f"{to_ms:.3f} ms, convertFromRows {from_ms:.3f} ms, exact", flush=True)
        del table, r

    # ---- 6. kernel numbers, card, verdict
    k = timings["keys"]
    print(json.dumps({"kernels": [{
        "name": "murmur3_chain",
        "route": "cuda",
        "source": "spark_rapids_jni_tpu_torch/kernels/csrc/murmur3.cu",
        "replaces": "spark_rapids_jni_tpu/kernels/murmur3.py:101",
        "launches": main_launches,
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
