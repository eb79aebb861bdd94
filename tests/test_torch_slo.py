"""The port's serving SLO engine on the CPU: the Prometheus histogram
round trip, job-span chains under interleaved serving with the
time-in-state breakdown closing on the e2e wall, the slow-job flight
trigger (deadline and multiplier arms, never double-recording) and the
``/slo`` diag view: the non-slow cases of tests/test_slo.py that touch
the serving path."""

import glob
import json
import os
import time
import urllib.request

import numpy as np
import pytest

from spark_rapids_jni_tpu_torch import Column, Table, FLOAT64, INT32
from spark_rapids_jni_tpu_torch.api import Pipeline
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
from spark_rapids_jni_tpu_torch.runtime import diag, events, flight, metrics, resource
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.serving import Server, ServerClosedError


@pytest.fixture
def telemetry():
    prev = metrics.configure("mem")
    metrics.reset()
    events.clear()
    resource.reset()
    pl.plan_cache_clear()
    yield metrics
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


def _pipe(name="svp"):
    return (Pipeline(name).filter(lambda tb: tb.columns[0].data >= 1)
            .group_by([0], [Agg("sum", 1), Agg("count", 0)], capacity=16))


def test_prometheus_histogram_round_trip(telemetry):
    h = metrics.histogram("t.rt_ms")
    for v in (0.5, 3.0, 3.1, 40.0, 900.0):
        h.observe(v)
    text = diag.prom_text()
    series = diag.parse_prom_text(text)
    s = diag.prom_name("t.rt_ms")
    assert f"# TYPE {s} histogram" in text
    assert series[s + "_count"] == 5
    assert series[s + "_sum"] == pytest.approx(946.6)
    values = [v for k, v in series.items() if k.startswith(s + "_bucket{")]
    assert values and values == sorted(values)
    assert series[s + '_bucket{le="+Inf"}'] == 5


def _job_span_ends(session_name):
    return [e for e in events.of_kind("span_end")
            if e["attrs"].get("kind") == "job" and e["attrs"].get("session") == session_name]


def test_job_spans_resolve_under_interleaving(telemetry):
    srv = Server(1 << 30).start()
    try:
        a, b = srv.open_session("ila"), srv.open_session("ilb")
        chunks = [_table(64, s) for s in range(4)]
        ja = srv.submit(a, _pipe(), chunks, window=1)
        jb = srv.submit(b, _pipe(), chunks, window=1)
        ja.result(timeout=300)
        jb.result(timeout=300)
    finally:
        srv.shutdown()
    for sess, job in (("ila", ja), ("ilb", jb)):
        (end,) = _job_span_ends(sess)
        assert end["attrs"]["state"] == "done" and end["attrs"]["job"] == job.job_id
        assert end["attrs"]["e2e_ms"] == pytest.approx(job.e2e_ms, rel=1e-3)
        assert sum(job.states.values()) == pytest.approx(job.e2e_ms, rel=5e-3, abs=0.5)
        assert job.states["dispatch_ms"] > 0 and job.states["retire_ms"] > 0
    assert metrics.histogram_stats("serving.e2e_ms")["count"] == 2
    for sess in ("ila", "ilb"):
        assert metrics.histogram_stats(f"serving.session.{sess}.e2e_ms")["count"] == 1


def test_queued_job_span_closes_on_mid_flight_close(telemetry):
    srv = Server(1 << 30).start()
    try:
        s = srv.open_session("purged")
        with srv.admission._lock:
            srv.admission._inflight_bytes = srv.admission.capacity_bytes
        job = srv.submit(s, _pipe(), [_table(64, 7)], window=1)
        deadline = time.time() + 60
        while time.time() < deadline and srv.admission.stats()["queue_depth"] < 1:
            time.sleep(0.01)
        srv.close_session(s)
        with pytest.raises(ServerClosedError):
            job.result(timeout=30)
    finally:
        srv.shutdown()
    (end,) = _job_span_ends("purged")
    assert end["attrs"]["state"] != "done"
    assert job.states["queued_ms"] == pytest.approx(job.e2e_ms, rel=5e-3, abs=0.5)
    assert job.states["dispatch_ms"] == 0
    assert metrics.histogram_stats("serving.e2e_ms") is None


def test_failed_job_span_closes_without_histogram(telemetry):
    srv = Server(1 << 30).start()
    try:
        s = srv.open_session("broken")
        bad = Table([Column.from_pylist([1, 2, 3], INT32, device="cpu")])
        job = srv.submit(s, _pipe(), [bad], window=1)
        with pytest.raises(Exception):  # noqa: B017 — the span contract is tested
            job.result(timeout=60)
    finally:
        srv.shutdown()
    (end,) = _job_span_ends("broken")
    assert end["attrs"]["state"] not in ("done", "running")
    assert job.e2e_ms is not None
    assert metrics.histogram_stats("serving.e2e_ms") is None


def _run_one(srv, session, deadline_s=None):
    job = srv.submit(session, _pipe(), [_table(64, 3)], window=1, deadline_s=deadline_s)
    job.result(timeout=300)
    return job


def test_deadline_miss_records_exactly_one_bundle(telemetry, monkeypatch, tmp_path):
    monkeypatch.setenv(flight._ENV_VAR, str(tmp_path))
    monkeypatch.setenv(flight.SLO_ENV_VAR, "3")
    srv = Server(1 << 30).start()
    try:
        s = srv.open_session("slo")
        job = _run_one(srv, s, deadline_s=0.0005)
        assert job.e2e_ms > 0.5 and job.slo_bundle
        with open(os.path.join(job.slo_bundle, "slo.json")) as f:
            slo = json.load(f)
        assert slo["reason"] == "deadline"
        assert slo["session"] == "slo" and slo["job"] == job.job_id
        assert set(slo["breakdown"]) == set(job.states)
        (end,) = _job_span_ends("slo")
        assert slo["span_tree"][0]["span_id"] == end["span_id"]
        assert slo["span_tree"][0]["events"] == [f"job:{job.job_id}"]
        assert len(slo["span_tree"]) >= 2
        assert [ev for n in slo["span_tree"][1:] for ev in n["events"]]
        (vio,) = events.of_kind("slo_violation")
        assert vio["attrs"]["reason"] == "deadline"
        assert vio["attrs"]["bundle"] == job.slo_bundle
        assert metrics.counter_value("serving.slo_violations") == 1
        srv._maybe_slo(job)  # a finished job never records twice
        assert metrics.counter_value("serving.slo_violations") == 1
        assert len(glob.glob(str(tmp_path / "flight_*" / "slo.json"))) == 1
        assert os.path.exists(os.path.join(job.slo_bundle, "sampler.txt"))
    finally:
        srv.shutdown()


def test_multiplier_arm_needs_history_then_fires(telemetry, monkeypatch, tmp_path):
    monkeypatch.setenv(flight._ENV_VAR, str(tmp_path))
    monkeypatch.setenv(flight.SLO_ENV_VAR, "1e-6")
    srv = Server(1 << 30).start()
    try:
        s = srv.open_session("hist")
        first = _run_one(srv, s)
        assert first.slo_bundle is None and not events.of_kind("slo_violation")
        second = _run_one(srv, s)
        assert second.slo_bundle
        with open(os.path.join(second.slo_bundle, "slo.json")) as f:
            assert json.load(f)["reason"] == "slow"
        assert metrics.counter_value("serving.slo_violations") == 1
    finally:
        srv.shutdown()


def test_trigger_unarmed_records_nothing(telemetry, monkeypatch, tmp_path):
    monkeypatch.setenv(flight._ENV_VAR, str(tmp_path))
    monkeypatch.delenv(flight.SLO_ENV_VAR, raising=False)
    srv = Server(1 << 30).start()
    try:
        job = _run_one(srv, srv.open_session("calm"), deadline_s=0.0005)
        assert job.slo_bundle is None and not events.of_kind("slo_violation")
        assert metrics.counter_value("serving.slo_violations") == 0
        assert glob.glob(str(tmp_path / "flight_*")) == []
    finally:
        srv.shutdown()


def test_slo_endpoint_lists_the_violation(telemetry, monkeypatch, tmp_path):
    monkeypatch.setenv(flight._ENV_VAR, str(tmp_path))
    monkeypatch.setenv(flight.SLO_ENV_VAR, "3")
    srv = Server(1 << 30).start()
    port = diag.start(0)
    try:
        job = _run_one(srv, srv.open_session("slov"), deadline_s=0.0005)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/slo", timeout=60) as r:
            body = json.loads(r.read().decode())
        assert body["slo_flight_multiplier"] == 3.0 and body["slo_violations"] == 1
        assert body["histograms"]["serving.e2e_ms"]["count"] == 1
        (vio,) = body["recent_violations"]
        assert vio["attrs"]["bundle"] == job.slo_bundle
    finally:
        diag.stop()
        srv.shutdown()


@pytest.mark.parametrize("raw,want", [
    ("", None), ("off", None), ("FALSE", None), ("none", None), ("0", None), ("-2", None),
    ("bogus", None), ("3", 3.0), ("2.5", 2.5), ("1e-6", 1e-6),
])
def test_slo_multiplier_parsing(monkeypatch, raw, want):
    monkeypatch.setenv(flight.SLO_ENV_VAR, raw)
    assert flight.slo_multiplier() == want
