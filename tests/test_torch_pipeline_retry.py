"""The port's fused Pipeline under the task-scoped retry runtime: capacity
and width overflow (raises outside a scope, re-plans and re-runs inside
one, rows never drop), injected OOMs (``RmmSpark.forceRetryOOM`` and the
faultinj ``"retry_oom"`` kind) in ``run`` and mid-stream,
``RetryOOMError`` past the budget, capacity feedback, ANALYZE rows
against an eager oracle, and ``scan_parquet`` over a pyarrow file. Every
result is held to the eager chain or the feedback-off run, exactly."""

import json

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch import INT32, INT64, STRING
from spark_rapids_jni_tpu_torch.api import (
    Aggregation,
    CastStrings,
    Filter,
    Pipeline,
    RetryOOMError,
    RmmSpark,
)
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
from spark_rapids_jni_tpu_torch.runtime import events, faultinj, metrics, resource
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.runtime.errors import CapacityExceededError

from test_torch_pipeline import same_tables


@pytest.fixture(autouse=True)
def telemetry():
    prev = metrics.configure("mem")
    metrics.reset()
    events.clear()
    resource.reset()
    faultinj.reset()
    pl.plan_cache_clear()
    yield metrics
    pl.set_capacity_feedback(None)
    pl.plan_cache_clear()
    faultinj.reset()
    metrics.reset()
    events.clear()
    resource.reset()
    metrics.configure(prev)


def chunk(seed, n=128, groups=10, strings=True):
    """k INT32 in [0, groups), v INT64, and (with ``strings``) s STRING
    of data-dependent length — whose payload size changes the chunk's
    shape, so chains over it plan per payload size."""
    rng = np.random.default_rng(seed)
    cols = [
        port.Column.from_numpy(rng.integers(0, groups, n).astype(np.int32), INT32, device="cpu"),
        port.Column.from_numpy(rng.integers(0, 100, n), INT64, device="cpu"),
    ]
    if strings:
        cols.append(port.Column.from_pylist(
            [str(int(x)) * int(x % 4 + 1) for x in rng.integers(0, 999, n)], STRING,
            device="cpu"))
    return port.Table(cols)


def eager_group(t):
    return Aggregation.groupBy(Filter.apply(t, t.columns[0].data >= 1), [0],
                               [Agg("sum", 1), Agg("count", 1)])


def grouped(name, capacity=16):
    return (Pipeline(name).filter(lambda tb: tb.columns[0].data >= 1)
            .group_by([0], [Agg("sum", 1), Agg("count", 1)], capacity=capacity))


# ---------------------------------------------------------------------
# capacity and width overflow


def test_capacity_overflow_outside_scope_raises():
    with pytest.raises(CapacityExceededError) as ei:
        grouped("ov", capacity=2).run(chunk(0))
    assert ei.value.stage == "1.capacity"


def test_capacity_replan_reruns_with_grown_plan():
    t = chunk(1)
    with resource.task():
        out = grouped("rp", capacity=2).run(t)
        m = resource.metrics()
    assert m.retries >= 1 and m.final_plans["pipeline.rp"]["1.capacity"] >= 9
    same_tables(out, eager_group(t))


def test_width_replan_reruns():
    t = chunk(2)
    p = Pipeline("wd").cast_to_integer(2, INT64, width=4)
    with pytest.raises(CapacityExceededError):
        p.run(t)
    with resource.task():
        out = p.run(t)
        assert resource.metrics().final_plans["pipeline.wd"]["0.width"] == 16
    want = port.Table([t.columns[0], t.columns[1],
                       CastStrings.toInteger(t.columns[2], False, True, INT64)])
    same_tables(out, want)


def test_retry_oom_error_past_the_budget():
    with pytest.raises(RetryOOMError) as ei:
        with resource.task(budget=10):
            grouped("bud", capacity=2).run(chunk(3))
    # the re-plan is charged against the budget: refused after one retry
    assert ei.value.metrics is not None and ei.value.metrics.retries == 1
    with pytest.raises(RetryOOMError):
        with resource.task(max_retries=1):
            RmmSpark.forceRetryOOM(resource.current_task().task_id, 3)
            grouped("bound").run(chunk(3))


# ---------------------------------------------------------------------
# injected OOMs


def test_force_retry_oom_in_run():
    t = chunk(4)
    with RmmSpark.task() as task:
        RmmSpark.forceRetryOOM(task.task_id, num_ooms=2)
        out = grouped("fo").run(t)
        assert RmmSpark.getAndResetNumRetryThrow(task.task_id) == 2
        assert resource.metrics().injected_ooms == 2
    same_tables(out, eager_group(t))


def test_stream_mid_window_forced_oom_retries_only_that_chunk():
    chunks = [chunk(10 + i) for i in range(4)]
    p = grouped("sfo")
    serial = p.run_chunks(chunks)
    with resource.task(max_retries=3):
        resource.force_retry_oom(num_ooms=1, skip_count=1)
        streamed = p.stream(chunks, window=2)
        assert resource.metrics().injected_ooms == 1
    for a, b in zip(serial, streamed):
        same_tables(a, b)
    rets = events.of_kind("stream_retire")
    assert [e["attrs"]["retries"] for e in rets[-4:]] == [0, 1, 0, 0]


def test_faultinj_retry_oom_kind_inside_stream(tmp_path, monkeypatch):
    cfg = tmp_path / "faults.json"
    cfg.write_text(json.dumps({"opFaults": {"Resource.pipeline.sfi": {
        "injectionType": "retry_oom", "interceptionCount": 1}}}))
    monkeypatch.setenv("FAULT_INJECTOR_CONFIG_PATH", str(cfg))
    faultinj.reset()
    chunks = [chunk(20 + i) for i in range(3)]
    with resource.task(max_retries=3):
        streamed = grouped("sfi").stream(chunks, window=2)
        assert resource.metrics().injected_ooms == 1
    for c, s in zip(chunks, streamed):
        same_tables(s, eager_group(c))
    inj = events.of_kind("injected_fault")
    assert inj and inj[0]["attrs"]["type_name"] == "retry_oom"


def test_stream_capacity_replan_at_retirement():
    chunks = [chunk(30 + i) for i in range(3)]
    small = Pipeline("sr").group_by([0], [Agg("sum", 1)], capacity=1)
    with pytest.raises(CapacityExceededError):
        small.stream(chunks, window=2)
    with resource.task():
        out = small.stream(chunks, window=2)
        assert resource.metrics().final_plans["pipeline.sr"]["0.capacity"] > 1
    for c, o in zip(chunks, out):
        same_tables(o, Aggregation.groupBy(c, [0], [Agg("sum", 1)]))


def test_stream_window_bytes_watermark():
    chunks = [chunk(40 + i) for i in range(4)]
    p = grouped("wm")
    with resource.task():
        p.run(chunks[0])
        single = resource.metrics().peak_bytes
    with resource.task():
        p.stream(chunks, window=2)
        assert resource.metrics().peak_bytes == 2 * single


# ---------------------------------------------------------------------
# capacity feedback


def test_feedback_tightens_and_converges():
    pl.set_capacity_feedback(True)
    p = Pipeline("cfb").group_by([0], [Agg("sum", 1)])  # default capacity = n
    chunks = [chunk(i, n=256, strings=False) for i in range(4)]
    with resource.task():
        outs = [p.run(c) for c in chunks]
        assert resource.metrics().retries == 0
    fb = pl.feedback_table()[p.signature_hash()]
    assert fb["knobs"]["0.capacity"] == {"observed": 10, "bucket": 16}
    assert fb["tighten"] == 1 and fb["chunks"] == 4
    assert metrics.counter_value("pipeline.plan_cache_miss") == 2
    pl.set_capacity_feedback(False)
    for c, o in zip(chunks, outs):
        same_tables(p.run(c), o)


def test_feedback_spike_replans_count_informed():
    pl.set_capacity_feedback(True)
    p = Pipeline("spk").group_by([0], [Agg("count")])
    with resource.task():
        p.run(chunk(0, n=256, groups=4, strings=False))
        p.run(chunk(1, n=256, groups=4, strings=False))  # tightened to bucket 4
        spike = chunk(2, n=256, groups=40, strings=False)
        out = p.run(spike)  # re-plans count-informed
        assert resource.metrics().retries == 1
    same_tables(out, Aggregation.groupBy(spike, [0], [Agg("count")]))
    assert pl.feedback_table()[p.signature_hash()]["widen"] == 1


# ---------------------------------------------------------------------
# ANALYZE


def test_analyze_stage_rows_bytes_match_eager_oracle():
    t = chunk(50)
    p = Pipeline("an").filter(lambda tb: tb.columns[0].data >= 3).group_by(
        [0], [Agg("sum", 1)], capacity=16)
    out = p.run(t, analyze=True)
    sm = [e for e in events.of_kind("stage_metrics") if e["op"] == "Pipeline.an"]
    assert [e["attrs"]["stage_kind"] for e in sm] == ["filter", "group_by"]
    keys = t.columns[0].data.numpy()
    lens = np.diff(t.columns[2].offsets.numpy())
    live = keys >= 3
    assert sm[0]["attrs"]["rows"] == int(live.sum())
    assert sm[0]["attrs"]["bytes"] == int(lens[live].sum())
    assert sm[1]["attrs"]["rows"] == len(set(keys[live].tolist()))
    assert sm[1]["attrs"]["bytes"] == 0
    walls = [e["attrs"]["wall_ms"] for e in sm]
    assert abs(sum(walls) - sm[0]["attrs"]["chain_wall_ms"]) <= 0.01
    same_tables(out, p.run(t, analyze=False))
    assert metrics.counter_value("pipeline.stage.filter.rows") == int(live.sum())


def test_analyze_stream_tags_chunks_and_keys_apart():
    p = grouped("ans")
    p.run(chunk(60, strings=False))
    m0 = metrics.counter_value("pipeline.plan_cache_miss")
    p.stream([chunk(61, strings=False), chunk(62, strings=False)], window=2, analyze=True)
    # the sliced programs are new entries (the knob folds into the key)
    assert metrics.counter_value("pipeline.plan_cache_miss") == m0 + 2
    sm = [e for e in events.of_kind("stage_metrics") if e["op"] == "Pipeline.ans"]
    assert sorted({e["attrs"]["chunk"] for e in sm}) == [0, 1]


# ---------------------------------------------------------------------
# scan_parquet


def test_scan_parquet_matches_eager_over_the_file(tmp_path):
    rng = np.random.default_rng(70)
    n = 3000
    tbl = pa.table({
        "k": pa.array(rng.integers(0, 6, n).astype(np.int32)),
        "v": pa.array(rng.integers(-50, 50, n)),
        "s": pa.array([f"x{i % 13}" for i in range(n)]),
    })
    path = str(tmp_path / "t.parquet")
    pq.write_table(tbl, path, row_group_size=1000)
    p = (Pipeline("scan").filter(lambda tb: tb.columns[0].data >= 1)
         .group_by([0], [Agg("sum", 1), Agg("count", 2)], capacity=8,
                   string_widths={2: 8}))
    m0 = metrics.counter_value("pipeline.plan_cache_miss")
    outs = p.scan_parquet(path, window=2, device="cpu", workers=2)
    assert len(outs) == 3
    # one miss for the chain and shape, hits on every later chunk
    assert metrics.counter_value("pipeline.plan_cache_miss") == m0 + 1
    for i, out in enumerate(outs):
        sl = tbl.slice(1000 * i, 1000)
        chunk_t = port.Table([
            port.Column.from_numpy(sl["k"].to_numpy(), INT32, device="cpu"),
            port.Column.from_numpy(sl["v"].to_numpy(), INT64, device="cpu"),
            port.Column.from_pylist(sl["s"].to_pylist(), STRING, device="cpu"),
        ])
        ft = Filter.apply(chunk_t, chunk_t.columns[0].data >= 1)
        same_tables(out, Aggregation.groupBy(ft, [0], [Agg("sum", 1), Agg("count", 2)]))


def test_scan_parquet_predicate_prepends_residual_filter(tmp_path):
    n = 2000
    tbl = pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                    "v": pa.array(np.arange(n, dtype=np.int64) % 7)})
    path = str(tmp_path / "p.parquet")
    pq.write_table(tbl, path, row_group_size=500)
    p = Pipeline("scanp").group_by([1], [Agg("count")], capacity=8)
    outs = p.scan_parquet(path, predicate=("k", ">=", 1200), device="cpu", workers=1)
    total = sum(sum(o.columns[1].to_pylist()) for o in outs)
    assert total == n - 1200 and len(outs) == 2  # two row groups pruned
