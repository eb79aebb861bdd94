"""The port's streamed Parquet scan (``runtime/scan.py``: ``ScanPlan``,
``prefetch_chunks``, ``scan_chunks``) against the JAX package's, on
pyarrow files with statistics: the same chunks, pruned row groups and
bytes, ``explain()``, ``residual_filter`` masks, journal event and
metrics, and the same decoded (power-of-two padded) chunks. Then the
prefetcher's own contract: in-order delivery, a worker's error raised
at its chunk's turn, at most ``depth`` chunks decoded ahead, workers
joined on close, and the card as the default device."""

import gc
import threading
import time
import weakref

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu.runtime import events as jevents
from spark_rapids_jni_tpu.runtime import metrics as jmetrics
from spark_rapids_jni_tpu.runtime import scan as jscan

from spark_rapids_jni_tpu_torch.api import ParquetReader, ScanPlan, prefetch_chunks, scan_chunks
from spark_rapids_jni_tpu_torch.runtime import events as pevents
from spark_rapids_jni_tpu_torch.runtime import metrics as pmetrics
from spark_rapids_jni_tpu_torch.runtime import scan as pscan


@pytest.fixture(autouse=True)
def _clean_state():
    prev = (jmetrics.configure("mem"), pmetrics.configure("mem"))
    for m, e in ((jmetrics, jevents), (pmetrics, pevents)):
        m.reset()
        e.clear()
    yield
    for m, e, p in ((jmetrics, jevents, prev[0]), (pmetrics, pevents, prev[1])):
        m.reset()
        e.clear()
        m.configure(p)


def write(tmp_path, table, name="t.parquet", **kw):
    path = str(tmp_path / name)
    pq.write_table(table, path, **kw)
    return path


def arange_file(tmp_path, n=1000, rg=100, **kw):
    arrow = pa.table({"x": pa.array(np.arange(n, dtype=np.int64))})
    return write(tmp_path, arrow, row_group_size=rg, **kw)


def mixed_file(tmp_path):
    rng = np.random.default_rng(11)
    n = 1200
    vals = [None if (200 <= i < 300 or i % 97 == 0) else int(i) for i in range(n)]
    arrow = pa.table({
        "x": pa.array(vals, pa.int64()),
        "f": pa.array(rng.normal(size=n).astype(np.float32)),
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
        "s": pa.array([None if i % 13 == 0 else f"name-{i % 37}" * (i % 4) for i in range(n)]),
    })
    return write(tmp_path, arrow, row_group_size=100, compression="SNAPPY")


def chunk_arrays(tbl):
    """(names, per column (data, validity, offsets)) as numpy."""
    out = []
    for c in tbl.columns:
        out.append(tuple(None if t is None else np.asarray(t if not isinstance(t, torch.Tensor)
                                                           else t.numpy())
                         for t in (c.data, c.validity, c.offsets)))
    return tuple(tbl.names or ()), out


def same_chunks(jchunks, pchunks):
    assert len(jchunks) == len(pchunks)
    for a, b in zip(jchunks, pchunks):
        na, ca = chunk_arrays(a)
        nb, cb = chunk_arrays(b)
        assert na == nb
        for x, y in zip(ca, cb):
            for u, v in zip(x, y):
                assert (u is None) == (v is None)
                if u is not None:
                    np.testing.assert_array_equal(v, u)


def mask_event(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "span_id", "parent_id", "task_id")}


PREDICATES = [
    None, ("x", ">", 450), ("x", "==", 250), [("x", ">=", 300), ("x", "<", 520)],
    ("x", "!=", 7), ("x", ">", -10**6), ("f", "<", -3.0), ("i", "<=", -49), ("x", ">", 10**6),
    [("i", ">", 0), ("f", ">=", 0.0)],
]


@pytest.mark.parametrize("predicate", PREDICATES, ids=str)
def test_plan_equals_jax(tmp_path, predicate):
    path = mixed_file(tmp_path)
    with jscan.ScanPlan(path, predicate=predicate) as a, ScanPlan(
            path, predicate=predicate, device="cpu") as b:
        assert [(rg, nb) for _r, rg, nb in b.chunks] == [(rg, nb) for _r, rg, nb in a.chunks]
        for attr in ("names", "total_rows", "row_groups_total", "row_groups_pruned",
                     "bytes_planned", "bytes_skipped"):
            assert getattr(b, attr) == getattr(a, attr), attr
        assert b.explain() == a.explain()
        assert b.explain("json") == a.explain("json")
        with pytest.raises(ValueError, match="explain fmt"):
            b.explain("yaml")
        assert [mask_event(e) for e in pevents.of_kind("scan_plan")] == [
            mask_event(e) for e in jevents.of_kind("scan_plan")]
        ja, pb = list(jscan.prefetch_chunks(a, workers=3)), list(pscan.prefetch_chunks(b, workers=3))
        same_chunks(ja, pb)
        fa, fb = a.residual_filter(), b.residual_filter()
        assert (fa is None) == (fb is None) == (predicate is None)
        if fa is not None:
            for x, y in zip(ja, pb):
                np.testing.assert_array_equal(fb(y).numpy(), np.asarray(fa(x)))
    for name in ("scan.row_groups_pruned", "scan.bytes_skipped", "scan.bytes_read"):
        assert pmetrics.counter_value(name) == jmetrics.counter_value(name), name
    stall = pmetrics.timer_stats("scan.stall_ms")
    assert (stall["count"] if stall else 0) == len(pb)


def test_no_stats_row_groups_never_skipped(tmp_path):
    arrow = pa.table({"x": pa.array(np.arange(1000, dtype=np.int64))})
    path = write(tmp_path, arrow, row_group_size=100, write_statistics=False)
    with ScanPlan(path, predicate=("x", ">", 10_000), device="cpu") as plan:
        assert plan.row_groups_pruned == 0 and len(plan.chunks) == 10
        chunks = list(prefetch_chunks(plan))
        rf = plan.residual_filter()
        assert sum(int(rf(c).sum()) for c in chunks) == 0


def test_all_null_group_skips_but_mixed_does_not(tmp_path):
    path = mixed_file(tmp_path)  # rows 200..299 all null in x
    with ScanPlan(path, predicate=("x", ">", -10**6), device="cpu") as plan:
        assert [rg for _r, rg, _b in plan.chunks] == [0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11]
        got = []
        rf = plan.residual_filter()
        for c in prefetch_chunks(plan):
            keep = rf(c)
            got.extend(c.columns[0].data[keep].tolist())
    want = [i for i in range(1200) if not (200 <= i < 300 or i % 97 == 0)]
    assert got == want  # null predicate rows drop (Spark filter semantics)


def test_group_unsatisfiable_edge_cases():
    for args in ((">", 99, 0, 99), (">=", 99, 0, 99), ("<", 100, 100, 199), ("<=", 100, 100, 199),
                 ("==", 250, 0, 99), ("==", 50, 0, 99), ("!=", 7, 7, 7), ("!=", 7, 7, 8)):
        assert pscan._group_unsatisfiable(*args) == jscan._group_unsatisfiable(*args), args
    assert pscan._group_unsatisfiable(">", 99, 0, 99)
    assert not pscan._group_unsatisfiable("!=", 7, 7, 8)


def test_predicate_validation_errors_match_jax(tmp_path):
    arrow = pa.table({
        "x": pa.array([1, 2, 3], pa.int64()),
        "s": pa.array(["a", "b", "c"]),
        "ll": pa.array([[1], [], [2]], pa.list_(pa.int64())),
        "u": pa.array(np.array([1, 2, 3], np.uint32), pa.uint32()),
    })
    path = write(tmp_path, arrow)
    a = write(tmp_path, pa.table({"x": pa.array([1], pa.int64())}), "a.parquet")
    b = write(tmp_path, pa.table({"y": pa.array([1], pa.int64())}), "b.parquet")
    cases = [
        (ValueError, "no such column", dict(columns=["x", "nope"])),
        (ValueError, "not in the scanned columns", dict(columns=["s"], predicate=("x", ">", 1))),
        (ValueError, "supported ops", dict(predicate=("x", "~", 1))),
        (TypeError, "only numeric", dict(predicate=("s", "==", "a"))),
        (TypeError, "nested", dict(predicate=("ll", ">", 1))),
        (TypeError, "unsupported type", dict(predicate=("u", ">", 1))),
        (TypeError, "unsupported type", dict(predicate=("s", ">", 1))),
        (ValueError, "want", dict(predicate=[("x", ">")])),
    ]
    for exc, match, kw in cases:
        with pytest.raises(exc, match=match) as pe:
            ScanPlan(path, device="cpu", **kw)
        with pytest.raises(exc) as je:
            jscan.ScanPlan(path, **kw)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="one schema"):
        ScanPlan([a, b], device="cpu")
    with pytest.raises(ValueError, match="at least one path"):
        ScanPlan([], device="cpu")


def two_files(tmp_path):
    mk = lambda lo: pa.table({  # noqa: E731
        "x": pa.array(np.arange(lo, lo + 200, dtype=np.int64)),
        "s": pa.array([f"s{i}" for i in range(lo, lo + 200)]),
        "y": pa.array(np.arange(lo, lo + 200, dtype=np.int32) * -1),
    })
    a = write(tmp_path, mk(0), "a.parquet", row_group_size=100)
    b = write(tmp_path, mk(200), "b.parquet", row_group_size=100)
    return a, b


def test_multi_file_pruned_columns_in_order(tmp_path):
    a, b = two_files(tmp_path)
    chunks = list(scan_chunks([a, b], columns=["x", "s"], workers=2, device="cpu"))
    assert list(chunks[0].names) == ["x", "s"]
    rows = [v for c in chunks for v in c.columns[0].data.tolist()]
    assert rows == list(range(400))
    for c in chunks:  # payload padded to a power of two, offsets untouched
        size = c.columns[1].data.shape[0]
        assert size & (size - 1) == 0 and size >= int(c.columns[1].offsets[-1])
    (ev,) = pevents.of_kind("scan_plan")
    assert ev["attrs"]["files"] == 2 and ev["attrs"]["row_groups"] == 4
    jchunks = list(jscan.scan_chunks([a, b], columns=["x", "s"], workers=2))
    same_chunks(jchunks, chunks)


def test_columns_follow_the_requested_order(tmp_path):
    """Chunks carry the requested columns in the requested order, the
    order their names give, and a predicate resolves to its own column.
    (The JAX package keeps the file's order under the requested names:
    ROADMAP Queue 3 logs it.)"""
    a, b = two_files(tmp_path)
    with ScanPlan([a, b], columns=["s", "y", "x"], predicate=("x", ">=", 250),
                  device="cpu") as plan:
        assert [(plan.readers.index(r), rg) for r, rg, _b in plan.chunks] == [(1, 0), (1, 1)]
        chunks = list(prefetch_chunks(plan, workers=2))
        rf = plan.residual_filter()
        assert [c.dtype.kind for c in chunks[0].columns] == ["string", "int", "int"]
        x = [v for c in chunks for v in c.columns[2].data[rf(c)].tolist()]
        y = [v for c in chunks for v in c.columns[1].data[rf(c)].tolist()]
        s = [v for c in chunks for v in Column_strings(c.columns[0], rf(c))]
    assert x == list(range(250, 400))
    assert y == [-v for v in range(250, 400)]
    assert s == [f"s{i}" for i in range(250, 400)]


def Column_strings(col, keep):
    vals = col.to_pylist()
    return [v for v, k in zip(vals, keep.tolist()) if k]


def test_prefetch_nested_and_decimal_match_reader(tmp_path):
    import decimal

    arrow = pa.table({
        "d": pa.array([decimal.Decimal("12.34"), None, decimal.Decimal("-9.99")] * 50,
                      pa.decimal128(10, 2)),
        "ls": pa.array([[{"a": i, "b": f"x{i}"}] if i % 3 else [] for i in range(150)],
                       pa.list_(pa.struct([("a", pa.int64()), ("b", pa.string())]))),
        "flat": pa.array(np.arange(150, dtype=np.int64)),
    })
    path = write(tmp_path, arrow, row_group_size=40)
    chunks = list(scan_chunks(path, workers=2, device="cpu"))
    with ParquetReader(path, device="cpu") as r:
        want = list(r.iter_row_groups())
    assert len(chunks) == len(want) == 4
    for got, exp in zip(chunks, want):
        assert [c.to_pylist() for c in got.columns] == [c.to_pylist() for c in exp.columns]


def test_pad_varlen_pow2_equals_jax():
    from spark_rapids_jni_tpu import Column as JColumn
    from spark_rapids_jni_tpu import Table as JTable
    from spark_rapids_jni_tpu.columnar.dtypes import INT32 as JINT32
    from spark_rapids_jni_tpu.columnar.dtypes import STRING as JSTRING

    from spark_rapids_jni_tpu_torch import INT32, STRING, Column, Table

    for payload in ([], ["a"], ["abcdefgh"], ["abc", "defgh", None, "ij"], ["x" * 33]):
        ints = list(range(len(payload)))
        jt = JTable([JColumn.from_pylist(payload, JSTRING), JColumn.from_pylist(ints, JINT32)])
        pt = Table([Column.from_pylist(payload, STRING, device="cpu"),
                    Column.from_pylist(ints, INT32, device="cpu")])
        same_chunks([jscan._pad_varlen_pow2(jt, ["s", "n"])],
                    [pscan._pad_varlen_pow2(pt, ["s", "n"])])
    fixed = Table([Column.from_pylist([1, 2], INT32, device="cpu")])
    assert pscan._pad_varlen_pow2(fixed, ["n"]).columns[0] is fixed.columns[0]
    for n in (0, 1, 2, 3, 8, 9, 1000):
        assert pscan._next_pow2(n) == jscan._next_pow2(n)


# ---- the prefetcher's contract


def slow_decode(monkeypatch, delay_of):
    """Wrap the port's decode with a per-row-group delay; returns the
    list of started row groups (thread-safe appends)."""
    started = []
    real = pscan._decode

    def decode(reader, rg, plan, streams):
        started.append(rg)
        time.sleep(delay_of(rg))
        return real(reader, rg, plan, streams)

    monkeypatch.setattr(pscan, "_decode", decode)
    return started


def test_in_order_delivery_with_out_of_order_decodes(tmp_path, monkeypatch):
    path = arange_file(tmp_path, n=800, rg=100)
    slow_decode(monkeypatch, lambda rg: 0.02 * (8 - rg))  # later groups finish first
    with ScanPlan(path, device="cpu") as plan:
        got = [c.columns[0].data[0].item() for c in prefetch_chunks(plan, depth=8, workers=4)]
    assert got == list(range(0, 800, 100))
    stall = pmetrics.timer_stats("scan.stall_ms")
    assert stall["count"] == 8 and stall["max_ms"] > 0


def test_at_most_depth_chunks_decoded_ahead(tmp_path, monkeypatch):
    path = arange_file(tmp_path, n=1200, rg=100)
    started = slow_decode(monkeypatch, lambda rg: 0.0)
    depth = 3
    ahead = []
    with ScanPlan(path, device="cpu") as plan:
        for consumed, _chunk in enumerate(prefetch_chunks(plan, depth=depth, workers=4), 1):
            time.sleep(0.05)  # the consumer is slow: decodes run ahead, up to the bound
            ahead.append(len(started) - consumed)
            assert 0 <= pmetrics.gauge_value("scan.prefetch_depth") <= depth
    # once the consumer holds chunk 1, the workers have started exactly
    # ``depth`` more, and never more than that
    assert ahead[0] == depth and max(ahead) <= depth


def test_consumed_chunk_is_not_retained(tmp_path):
    path = arange_file(tmp_path, n=400, rg=100)
    src = prefetch_chunks(ScanPlan(path, device="cpu"), depth=1, workers=1)
    c0 = next(src)
    ref = weakref.ref(c0)
    c1 = next(src)
    del c0
    gc.collect()
    assert ref() is None  # the prefetcher holds no shadow copy
    src.close()
    del c1


def corrupt_row_group(path, rg):
    with ParquetReader(path, device="cpu") as r:
        info = r._chunk_info(rg, 0)
    with open(path, "r+b") as f:
        f.seek(info["offset"])
        f.write(b"\xff" * min(64, info["size"]))


def test_decode_error_raised_at_its_turn(tmp_path):
    path = arange_file(tmp_path, n=3000, rg=500, compression="SNAPPY")
    corrupt_row_group(path, 2)
    got = []
    src = scan_chunks(path, workers=3, depth=4, device="cpu")
    with pytest.raises(RuntimeError):
        for c in src:
            got.append(c.columns[0].data[0].item())
    assert got == [0, 500]  # chunks before the failing one arrive, in order; none after
    assert not [t for t in threading.enumerate() if t.name.startswith("scan-prefetch")]


def test_worker_error_of_any_type_is_delivered(tmp_path, monkeypatch):
    path = arange_file(tmp_path, n=500, rg=100)

    def decode(reader, rg, plan, streams):
        if rg == 3:
            raise KeyError("decode failed")
        return real(reader, rg, plan, streams)

    real = pscan._decode
    monkeypatch.setattr(pscan, "_decode", decode)
    got = []
    with pytest.raises(KeyError, match="decode failed"):
        for c in scan_chunks(path, workers=2, device="cpu"):
            got.append(c.columns[0].data[0].item())
    assert got == [0, 100, 200]


def test_early_close_joins_workers(tmp_path):
    path = arange_file(tmp_path)
    src = scan_chunks(path, workers=3, depth=2, device="cpu")
    next(src)
    src.close()  # mid-stream abandon: workers join, footers close
    assert not [t for t in threading.enumerate() if t.name.startswith("scan-prefetch")]
    plan = ScanPlan(path, device="cpu")
    gen = prefetch_chunks(plan, workers=4)
    next(gen)
    gen.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("scan-prefetch")]
    plan.close()


def test_empty_plan_and_all_pruned(tmp_path):
    path = arange_file(tmp_path)
    assert list(scan_chunks(path, predicate=("x", ">", 10_000), device="cpu")) == []
    with ScanPlan(path, predicate=("x", ">", 10_000), device="cpu") as plan:
        assert plan.chunks == [] and plan.row_groups_pruned == 10
        assert list(prefetch_chunks(plan)) == []


def test_default_workers():
    import os

    assert pscan.default_workers() == jscan.default_workers()
    assert 1 <= pscan.default_workers() <= 4
    assert pscan.default_workers() <= max(1, len(os.sched_getaffinity(0)) - 1) or \
        len(os.sched_getaffinity(0)) == 1


def test_scan_defaults_to_the_card(tmp_path):
    path = arange_file(tmp_path, n=200, rg=100)
    if torch.cuda.is_available():
        with ScanPlan(path) as plan:
            (c, *_rest) = list(prefetch_chunks(plan))
            assert c.columns[0].data.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScanPlan(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scan_chunks(path)
