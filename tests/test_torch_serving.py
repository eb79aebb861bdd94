"""The port's multi-tenant serving driver (``serving/``) on the CPU: the
Session/Context knob split, the fair interleaver's result fidelity,
the per-tenant plan-cache accounting, the ``/sessions`` diag view and
the lifecycle (the port-side cases of tests/test_serving.py), the lazy
chunk source, a device OOM that fails one job only, a warm dispatch
slice with no host sync, and the parity test: three tenants through the
JAX package's ``Server`` and the port's, the same verdicts, estimates,
per-session stats and results."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.api import Pipeline as JPipeline
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops.aggregate import Agg as JAgg
from spark_rapids_jni_tpu.runtime import events as jevents
from spark_rapids_jni_tpu.runtime import metrics as jmetrics
from spark_rapids_jni_tpu.runtime import pipeline as jpl
from spark_rapids_jni_tpu.runtime import resource as jres
from spark_rapids_jni_tpu.serving import Server as JServer

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch import Column, Table, FLOAT64, INT32
from spark_rapids_jni_tpu_torch.api import Pipeline, serving_server
from spark_rapids_jni_tpu_torch.ops import _strategy
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
from spark_rapids_jni_tpu_torch.runtime import diag, events, metrics, resource
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.serving import (
    AdmissionRejected,
    Server,
    ServerClosedError,
)
from spark_rapids_jni_tpu_torch.serving.server import Job

from test_torch_pipeline_sync_free import HostTraffic
from torch_parity import assert_same_result, to_port


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


@pytest.fixture
def server(telemetry):
    srv = Server(1 << 30).start()
    yield srv
    srv.shutdown()


def _table(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(rng.integers(0, 5, n).astype(np.int32), INT32, device="cpu"),
        Column.from_numpy(rng.normal(size=n), FLOAT64, device="cpu"),
    ])


def _pipe(name="svp", capacity=16):
    return (Pipeline(name).filter(lambda tb: tb.columns[0].data >= 1)
            .group_by([0], [Agg("sum", 1), Agg("count", 0)], capacity=capacity))


def _tables_equal(a, b):
    assert a.num_columns == b.num_columns
    for ca, cb in zip(a.columns, b.columns):
        assert ca.to_pylist() == cb.to_pylist()


def _row(srv, name):
    (row,) = [r for r in srv.sessions_table() if r.get("session") == name]
    return row


# ---- the session/context split


def test_session_knobs_do_not_leak(server):
    s1 = server.open_session("iso1", scan_strategy="serial", capacity_feedback=True)
    s2 = server.open_session("iso2", scan_strategy="monoid")
    assert s1.run_in_context(_strategy.scan_strategy) == "serial"
    assert s2.run_in_context(_strategy.scan_strategy) == "monoid"
    assert s1.run_in_context(pl.capacity_feedback) is True
    assert s2.run_in_context(pl.capacity_feedback) is False
    assert _strategy.scan_strategy() == "auto"
    assert pl.capacity_feedback() is False
    with pytest.raises(ValueError):
        _strategy.set_context_scan_strategy("bogus")


def test_use_task_activates_and_restores(telemetry):
    t = resource.start_task(budget=None)
    resource._stack().remove(t)
    assert resource.current_task() is None
    with resource.use_task(t):
        assert resource.current_task() is t
    assert resource.current_task() is None
    resource.task_done(t.task_id)


def test_serving_server_facade(telemetry):
    srv = serving_server(1 << 20, max_queue=3)
    try:
        assert isinstance(srv, Server) and srv._running
        assert srv.admission.max_queue == 3
        assert port.api.serving_server is serving_server
    finally:
        srv.shutdown()
    assert not srv._running


# ---- result fidelity and accounting


def test_interleaved_results_bit_identical_to_serial(server):
    chunks = [_table(64, s) for s in range(4)]
    ref = _pipe().stream(chunks, window=2)
    sessions = [server.open_session(f"t{i}") for i in range(4)]
    jobs = [server.submit(s, _pipe(), chunks, window=2) for s in sessions]
    for job in jobs:
        got = job.result(timeout=120)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _tables_equal(g, r)
        assert sum(job.states.values()) == pytest.approx(job.e2e_ms, rel=5e-3, abs=0.5)


def test_per_tenant_plan_cache_accounting(server):
    chunks = [_table(64, s) for s in range(3)]
    _pipe().stream(chunks, window=2)  # warms the shared cache
    s1, s2 = server.open_session("acct1"), server.open_session("acct2")
    server.submit(s1, _pipe(), chunks, window=2).result(timeout=120)
    server.submit(s2, _pipe(), chunks, window=2).result(timeout=120)
    for name in ("acct1", "acct2"):
        assert _row(server, name)["plan_cache"] == {"hits": 3, "misses": 0}
        assert metrics.counter_value(f"serving.session.{name}.plan_cache_hit") == 3


def test_server_rejects_over_budget_job(server):
    s = server.open_session("broke", budget=16)
    job = server.submit(s, _pipe(), [_table(64)], window=1)
    with pytest.raises(AdmissionRejected) as ei:
        job.result(timeout=60)
    assert ei.value.reason == "over_budget"
    assert _row(server, "broke")["rejected"] == 1


def test_lazy_chunk_source_drains_on_the_dispatch_thread(server):
    """A generator source is materialized at admission on the dispatch
    thread; one that raises fails only its own job."""
    chunks = [_table(64, s) for s in range(3)]
    ref = _pipe().stream(chunks, window=2)
    seen = []

    def lazy():
        for c in chunks:
            seen.append(threading.current_thread().name)
            yield c

    def broken():
        yield chunks[0]
        raise OSError("page decode failed")

    good = server.submit(server.open_session("lazy"), _pipe(), lazy(), window=2)
    bad = server.submit(server.open_session("broken"), _pipe(), broken(), window=2)
    for g, r in zip(good.result(timeout=120), ref):
        _tables_equal(g, r)
    assert set(seen) == {"sprt-serving-dispatch"}
    with pytest.raises(OSError, match="page decode failed"):
        bad.result(timeout=60)


def _oom(t):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 13.00 GiB")


def test_device_oom_fails_only_that_job(server):
    """A real device OOM inside one tenant's dispatch fails that job;
    the loop keeps serving the other tenants, exactly."""
    chunks = [_table(64, s) for s in range(3)]
    ref = _pipe().stream(chunks, window=2)
    doomed = server.submit(server.open_session("oom"),
                           Pipeline("oom").map(_oom, name="oom"), chunks, window=2)
    fine = server.submit(server.open_session("fine"), _pipe(), chunks, window=2)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        doomed.result(timeout=60)
    for g, r in zip(fine.result(timeout=120), ref):
        _tables_equal(g, r)
    assert server._thread.is_alive()
    assert _row(server, "oom")["failed"] == 1
    after = server.submit(server.open_session("after"), _pipe(), chunks[:1], window=1)
    _tables_equal(after.result(timeout=60)[0], ref[0])


def test_warm_dispatch_slice_is_sync_free(server, monkeypatch):
    """The serving half of the streaming contract: once a plan is warm,
    a dispatch slice only enqueues (no op that would sync or copy host
    data on a CUDA tensor)."""
    chunks = [_table(64, s) for s in range(2)]
    s = server.open_session("sf")
    server.submit(s, _pipe(), chunks, window=2).result(timeout=60)
    hits = []
    orig = Server._dispatch_one

    def watched(self, job):
        with HostTraffic() as watch:
            orig(self, job)
        hits.append(dict(watch.hits))

    monkeypatch.setattr(Server, "_dispatch_one", watched)
    server.submit(s, _pipe(), chunks, window=2).result(timeout=60)
    assert hits == [{}, {}]


# ---- the /sessions diag view


def test_diag_sessions_endpoint(server):
    port_ = diag.start(0)
    try:
        server.open_session("viewme", capacity_feedback=True)
        with urllib.request.urlopen(f"http://127.0.0.1:{port_}/sessions", timeout=60) as r:
            body = json.loads(r.read().decode())
        assert body["serving"] is True
        assert "viewme" in [row["session"] for row in body["sessions"] if "session" in row]
        (adm,) = [row["admission"] for row in body["sessions"] if "admission" in row]
        assert adm["capacity_bytes"] == 1 << 30
    finally:
        diag.stop()


def test_diag_sessions_unserved(telemetry):
    port_ = diag.start(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port_}/sessions", timeout=60) as r:
            assert json.loads(r.read().decode()) == {"serving": False, "sessions": []}
    finally:
        diag.stop()


# ---- lifecycle


def test_close_session_fails_pending_and_submit_after(server):
    s = server.open_session("gone")
    server.close_session(s)
    with pytest.raises(ServerClosedError):
        server.submit(s, _pipe(), [_table(16)])
    assert s.closed
    (ev,) = events.of_kind("session_close")
    assert ev["attrs"]["session"] == "gone"
    assert events.of_kind("session_open")


def _park_in_queue(srv, session):
    """Fill the device headroom so the next submit parks in the
    admission queue, then wait until it is there."""
    with srv.admission._lock:
        srv.admission._inflight_bytes = srv.admission.capacity_bytes
    job = srv.submit(session, _pipe(), [_table(64, 7)], window=1)
    deadline = time.time() + 60
    while time.time() < deadline:
        if srv.admission.stats()["queue_depth"] >= 1:
            return job
        time.sleep(0.01)
    raise AssertionError("job never reached the admission queue")


def test_shutdown_fails_queued_at_admission_jobs(telemetry):
    srv = Server(1 << 30).start()
    job = _park_in_queue(srv, srv.open_session("parked"))
    srv.shutdown()
    with pytest.raises(ServerClosedError):
        job.result(timeout=30)
    adm = srv.sessions_table()[-1]["admission"]
    assert adm["queue_depth"] == 0
    assert adm["inflight_bytes"] == adm["capacity_bytes"]


def test_close_session_purges_queued_jobs(telemetry):
    srv = Server(1 << 30).start()
    try:
        s = srv.open_session("leaver")
        job = _park_in_queue(srv, s)
        srv.close_session(s)
        with pytest.raises(ServerClosedError):
            job.result(timeout=30)
        adm = srv.sessions_table()[-1]["admission"]
        assert adm["queue_depth"] == 0
        assert adm["inflight_bytes"] == adm["capacity_bytes"]
        with srv.admission._lock:
            srv.admission._inflight_bytes = 0
        chunks = [_table(64, 8)]
        got = srv.submit(srv.open_session("stayer"), _pipe(), chunks, window=1).result(
            timeout=120)
        _tables_equal(got[0], _pipe().stream(chunks, window=1)[0])
    finally:
        srv.shutdown()


def test_activate_refuses_orphan_promotion(telemetry):
    srv = Server(1 << 20).start()
    try:
        s = srv.open_session("orphan")
        srv.close_session(s)
        job = Job(s, _pipe(), [], 1, True)
        job.estimate = 512
        with srv.admission._lock:
            srv.admission._inflight_bytes = 512  # promote() reserved
        srv._activate(job)
        with pytest.raises(ServerClosedError):
            job.result(timeout=30)
        assert srv.admission.stats()["inflight_bytes"] == 0
    finally:
        srv.shutdown()


def test_close_session_with_inflight_job_unblocks_waiter(server):
    chunks = [_table(64, i) for i in range(6)]
    s = server.open_session("mid")
    job = server.submit(s, _pipe(), chunks, window=2)
    server.close_session(s)
    assert s.closed
    try:
        res = job.result(timeout=120)
    except ServerClosedError:
        pass  # torn down mid-flight: waiter unblocked, not hung
    else:
        assert len(res) == len(chunks)
    ref = _pipe().stream(chunks[:2], window=2)
    got = server.submit(server.open_session("after"), _pipe(), chunks[:2], window=2).result(
        timeout=120)
    for g, r in zip(got, ref):
        _tables_equal(g, r)


def test_shutdown_unblocks_waiters(telemetry):
    srv = Server(1 << 30).start()
    s = srv.open_session("w")
    srv.submit(s, _pipe(), [_table(64, 1)], window=1).result(timeout=120)
    srv.shutdown()
    assert srv.sessions_table()[-1]["admission"]["inflight_bytes"] == 0


# ---- parity with the JAX package's server

TENANTS = (("ta", 1024, 8), ("tb", 2048, 16), ("tc", 4096, 32))  # name, rows a chunk, capacity


def _jax_chunk(n, seed):
    rng = np.random.default_rng(seed)
    return JTable([
        JColumn.from_numpy(rng.integers(0, 12, n).astype(np.int32), jd.INT32),
        JColumn.from_pylist([None if x % 9 == 0 else int(x) for x in rng.integers(0, 1000, n)],
                            jd.INT64),
        JColumn.from_numpy(rng.normal(size=n), jd.FLOAT64),
    ])


def _chain(P, A, name, capacity):
    return (P(name).filter(lambda tb: tb.columns[0].data >= 2)
            .group_by([0], [A("sum", 1), A("count", 1), A("max", 2)], capacity=capacity))


def _serve(server_cls, pipe_cls, agg_cls, tables, capacity_bytes):
    """Open the three tenants, park the dispatch loop in a gate job's
    lazy source so the three jobs reach admission in one intake drain,
    and return the verdicts, estimates, session rows and results."""
    srv = server_cls(capacity_bytes).start()
    gate = threading.Event()

    def held():
        gate.wait(60)
        yield from ()

    try:
        sessions = {name: srv.open_session(name) for name, _, _ in TENANTS}
        srv.submit(srv.open_session("gate"), _chain(pipe_cls, agg_cls, "gate", 8), held())
        time.sleep(0.2)  # the loop is inside the gate's drain now
        jobs = {name: srv.submit(sessions[name], _chain(pipe_cls, agg_cls, name, cap),
                                 tables[name], window=2)
                for name, _, cap in TENANTS}
        gate.set()
        results = {name: job.result(timeout=300) for name, job in jobs.items()}
        rows = {}
        for r in srv.sessions_table():
            if r.get("session") in sessions:
                rows[r["session"]] = {k: r[k] for k in ("plan_cache", "jobs", "done", "failed",
                                                        "rejected", "queued", "knobs", "budget")}
        return ({name: job.estimate for name, job in jobs.items()}, rows, results)
    finally:
        gate.set()
        srv.shutdown()


def _decisions(evs):
    return [(e["attrs"]["session"], e["attrs"]["verdict"], e["attrs"]["estimate_bytes"])
            for e in evs if e["attrs"]["session"] != "gate"]


def test_three_tenants_match_the_jax_server(telemetry):
    jtabs = {name: [_jax_chunk(n, 100 * i + k) for k in range(2)]
             for i, (name, n, _) in enumerate(TENANTS)}
    ptabs = {name: [to_port(t) for t in ts] for name, ts in jtabs.items()}
    # room for the first two tenants' reservations or the third's: the
    # third queues until both release
    row_b = resource._table_row_bytes(ptabs["ta"][0], None)
    est = {name: 2 * (n + cap) * row_b for name, n, cap in TENANTS}
    capacity = max(est["ta"] + est["tb"], est["tc"])
    assert capacity < sum(est.values())

    jprev = jmetrics.configure("mem")
    jmetrics.reset()
    jevents.clear()
    jres.reset()
    jpl.plan_cache_clear()
    try:
        j_est, j_rows, j_res = _serve(JServer, JPipeline, JAgg, jtabs, capacity)
        j_dec = _decisions(jevents.of_kind("admission_decision"))
    finally:
        jmetrics.reset()
        jevents.clear()
        jres.reset()
        jpl.plan_cache_clear()
        jmetrics.configure(jprev)
    p_est, p_rows, p_res = _serve(Server, Pipeline, Agg, ptabs, capacity)
    p_dec = _decisions(events.of_kind("admission_decision"))

    assert p_est == j_est == est
    assert p_dec == j_dec == [("ta", "admitted", est["ta"]), ("tb", "admitted", est["tb"]),
                              ("tc", "queued", est["tc"])]
    assert p_rows == j_rows
    assert p_rows["tc"]["queued"] == 1
    # ta's capacity (8) is below its 10 keys: both of its chunks
    # overflow, re-plan at retirement and re-execute on the grown plan
    assert {n: r["plan_cache"] for n, r in p_rows.items()} == {
        "ta": {"hits": 2, "misses": 2}, "tb": {"hits": 1, "misses": 1},
        "tc": {"hits": 1, "misses": 1}}
    for name in p_res:
        assert len(p_res[name]) == len(j_res[name]) == 2
        for jt, pt in zip(j_res[name], p_res[name]):
            assert_same_result(jt, pt)
