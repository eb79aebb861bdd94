"""Chaos serving on the port: faultinj storms against four concurrent
sessions on one device (the non-slow cases of
tests/test_serving_chaos.py). The contracts under test:

- a post-admission failure leaves ONE resolvable flight bundle, stamped
  with the failing job's task id;
- surviving tenants' results stay identical to their serial
  single-tenant runs;
- injected retryable OOMs and RmmSpark-style forced OOMs inside an
  ADMITTED job are absorbed by the task-scoped retry driver mid-stream,
  never escaping to the tenant;
- no session observes another's knobs while the storm runs.
"""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu_torch import Column, Table, FLOAT64, INT32
from spark_rapids_jni_tpu_torch.api import Pipeline
from spark_rapids_jni_tpu_torch.ops import _strategy
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
from spark_rapids_jni_tpu_torch.runtime import events, faultinj, flight, metrics, resource
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.runtime.faultinj import FatalDeviceError
from spark_rapids_jni_tpu_torch.serving import Server


@pytest.fixture
def telemetry():
    prev = metrics.configure("mem")
    metrics.reset()
    events.clear()
    resource.reset()
    pl.plan_cache_clear()
    yield metrics
    faultinj.reset()
    metrics.reset()
    events.clear()
    resource.reset()
    pl.plan_cache_clear()
    metrics.configure(prev)


def _table(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(rng.integers(0, 5, n).astype(np.int32), INT32, device="cpu"),
        Column.from_numpy(rng.normal(size=n), FLOAT64, device="cpu"),
    ])


def _pipe(name, capacity=16):
    return (Pipeline(name).filter(lambda tb: tb.columns[0].data >= 1)
            .group_by([0], [Agg("sum", 1), Agg("count", 0)], capacity=capacity))


def _tables_equal(a, b):
    assert a.num_columns == b.num_columns
    for ca, cb in zip(a.columns, b.columns):
        assert ca.to_pylist() == cb.to_pylist()


def _arm(tmp_path, monkeypatch, rules):
    cfg = tmp_path / "faults.json"
    cfg.write_text(json.dumps({"opFaults": rules}))
    monkeypatch.setenv("FAULT_INJECTOR_CONFIG_PATH", str(cfg))
    froot = str(tmp_path / "fl")
    monkeypatch.setenv("SPARK_JNI_TPU_FLIGHT", froot)
    faultinj.reset()
    return froot


def test_chaos_storm_four_sessions(telemetry, tmp_path, monkeypatch):
    chunks = [_table(64, s) for s in range(4)]
    refs = {i: _pipe(f"chaos{i}").stream(chunks, window=2) for i in range(4)}
    froot = _arm(tmp_path, monkeypatch, {
        "Resource.pipeline.chaos0": {"injectionType": "fatal", "interceptionCount": 1},
        "Resource.pipeline.chaos1": {"injectionType": "retry_oom", "interceptionCount": 2},
    })
    srv = Server(1 << 30).start()
    try:
        sessions = [srv.open_session(f"c{i}", scan_strategy=st)
                    for i, st in enumerate(("serial", "auto", "monoid", "auto"))]
        jobs = [srv.submit(s, _pipe(f"chaos{i}"), chunks, window=2)
                for i, s in enumerate(sessions)]
        with pytest.raises(FatalDeviceError):
            jobs[0].result(timeout=120)
        for i in (1, 2, 3):
            for g, r in zip(jobs[i].result(timeout=120), refs[i]):
                _tables_equal(g, r)
        assert jobs[1].done() and jobs[1]._exc is None
        injected = [e for e in events.of_kind("injected_fault")
                    if e["attrs"]["type_name"] == "retry_oom"]
        assert len(injected) == 2
        assert sessions[0].run_in_context(_strategy.scan_strategy) == "serial"
        assert sessions[2].run_in_context(_strategy.scan_strategy) == "monoid"
        assert _strategy.scan_strategy() == "auto"
        (row,) = flight.bundle_index(froot)
        assert row["task_id"] == jobs[0].task.task_id
        assert f"_task{jobs[0].task.task_id}" in row["bundle"]
        assert row["reason"] == "FatalDeviceError"
    finally:
        srv.shutdown()


def test_admitted_job_absorbs_forced_ooms_mid_stream(telemetry):
    """Forced OOMs against an admitted job's open task: the retry driver
    re-plans at retirement; the tenant sees results, not
    RetryOOMError."""
    chunks = [_table(64, s) for s in range(3)]
    ref = _pipe("forced").stream(chunks, window=2)
    srv = Server(1 << 30).start()
    try:
        job = srv.submit(srv.open_session("f"), _pipe("forced"), chunks, window=2)
        for g, r in zip(job.result(timeout=120), ref):
            _tables_equal(g, r)
        m = resource.metrics(job.task.task_id)
        assert m is not None and m.task_id == job.task.task_id
    finally:
        srv.shutdown()


def test_undersized_capacity_replans_inside_a_served_job(telemetry):
    """A tenant whose group capacity is below its key count overflows on
    every chunk; the deferred driver re-plans at retirement and the
    served results equal the serial stream's."""
    chunks = [_table(64, s) for s in range(3)]
    with resource.task():
        ref = _pipe("tight", capacity=2).stream(chunks, window=2)
    srv = Server(1 << 30).start()
    try:
        job = srv.submit(srv.open_session("tight"), _pipe("tight", capacity=2), chunks,
                         window=2)
        got = job.result(timeout=120)
        for g, r in zip(got, ref):
            _tables_equal(g, r)
        assert resource.metrics(job.task.task_id).retries >= 1
    finally:
        srv.shutdown()
