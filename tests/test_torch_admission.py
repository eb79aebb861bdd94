"""The port's admission controller (``serving/admission.py``) and the
bounded plan-keyed tables serving leans on: the port-side cases of
tests/test_serving.py's admission, eviction and flight-prune tests,
plus one parity test that drives the JAX package's controller and the
port's through the same offer/promote/release sequence."""

import os

import numpy as np
import pytest

from spark_rapids_jni_tpu.serving.admission import AdmissionController as JController
from spark_rapids_jni_tpu.serving.admission import AdmissionRejected as JRejected

from spark_rapids_jni_tpu_torch import Column, Table, FLOAT64, INT32
from spark_rapids_jni_tpu_torch.api import Pipeline
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
from spark_rapids_jni_tpu_torch.runtime import events, flight, metrics, resource
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.serving import AdmissionRejected
from spark_rapids_jni_tpu_torch.serving.admission import AdmissionController


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


class _StubSession:
    def __init__(self, name="stub", budget=None):
        self.name = name
        self.budget = budget
        self.bumps = []

    def _bump(self, key, n=1):
        self.bumps.append(key)


class _StubJob:
    def __init__(self, estimate, session=None):
        self.estimate = estimate
        self.session = session or _StubSession()


def test_admission_over_budget_rejects_up_front(telemetry):
    ctl = AdmissionController(1 << 20)
    with pytest.raises(AdmissionRejected) as ei:
        ctl.offer(_StubJob(4096, _StubSession(budget=1024)))
    assert ei.value.reason == "over_budget"
    assert metrics.counter_value("admission.rejected") == 1
    (ev,) = events.of_kind("admission_reject")
    assert ev["attrs"]["reason"] == "over_budget"


def test_admission_queue_then_promote_fifo(telemetry):
    ctl = AdmissionController(1000, max_queue=2)
    a, b, c = _StubJob(800), _StubJob(600), _StubJob(100)
    assert ctl.offer(a) == "admitted"
    assert ctl.offer(b) == "queued"
    assert ctl.offer(c) == "queued"
    assert ctl.promote() == ([], [])  # c fits but must not overtake b
    ctl.release(a)
    admitted, _ = ctl.promote()
    assert admitted == [b, c]
    assert metrics.counter_value("admission.admitted") == 3
    assert metrics.counter_value("admission.queued") == 2


def test_admission_queue_full_and_deadline(telemetry):
    ctl = AdmissionController(100, max_queue=1, default_deadline_s=0.0)
    assert ctl.offer(_StubJob(90)) == "admitted"
    queued = _StubJob(50)
    assert ctl.offer(queued) == "queued"
    with pytest.raises(AdmissionRejected) as ei:
        ctl.offer(_StubJob(10))
    assert ei.value.reason == "queue_full"
    _, expired = ctl.promote()
    assert expired == [queued]
    assert metrics.counter_value("admission.timeouts") == 1
    assert metrics.gauge_value("admission.queue_depth") == 0


def test_admission_over_capacity_rejects_up_front(telemetry):
    ctl = AdmissionController(1000, max_queue=4)
    with pytest.raises(AdmissionRejected) as ei:
        ctl.offer(_StubJob(1001))
    assert ei.value.reason == "over_capacity"
    assert ctl.stats()["queue_depth"] == 0
    (ev,) = events.of_kind("admission_reject")
    assert ev["attrs"]["reason"] == "over_capacity"
    with pytest.raises(ValueError):
        AdmissionController(0)


def test_admission_drain_and_purge_session(telemetry):
    ctl = AdmissionController(1000, max_queue=4)
    leaver, stayer = _StubSession("leaver"), _StubSession("stayer")
    assert ctl.offer(_StubJob(900, stayer)) == "admitted"
    q1, q2, q3 = _StubJob(500, leaver), _StubJob(400, stayer), _StubJob(300, leaver)
    for q in (q1, q2, q3):
        assert ctl.offer(q) == "queued"
    assert ctl.purge_session(leaver) == [q1, q3]
    assert ctl.stats()["queue_depth"] == 1
    assert ctl.drain() == [q2]
    assert ctl.stats() == {"capacity_bytes": 1000, "inflight_bytes": 900, "queue_depth": 0,
                           "max_queue": 4}


def _run_sequence(ctl_cls, rejected_cls, seed):
    """One seeded offer/promote/release sequence; the trace of verdicts,
    promotions, expiries and ledger states."""
    rng = np.random.default_rng(seed)
    ctl = ctl_cls(4000, max_queue=3, default_deadline_s=30.0)
    sessions = [_StubSession(f"s{i}", budget=[None, 2500][i % 2]) for i in range(3)]
    live, trace = [], []
    for step in range(60):
        r = rng.random()
        if r < 0.6:
            job = _StubJob(int(rng.integers(1, 3000)), sessions[int(rng.integers(0, 3))])
            job.step = step
            try:
                v = ctl.offer(job)
                if v == "admitted":
                    live.append(job)
                trace.append(("offer", step, v))
            except rejected_cls as e:
                trace.append(("offer", step, e.reason, e.estimate))
        elif r < 0.8 and live:
            ctl.release(live.pop(int(rng.integers(0, len(live)))))
            trace.append(("release", step))
        else:
            admitted, expired = ctl.promote()
            live.extend(admitted)
            trace.append(("promote", [j.step for j in admitted], [j.step for j in expired]))
        trace.append(ctl.stats())
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_admission_sequence_matches_jax(telemetry, seed):
    got = _run_sequence(AdmissionController, AdmissionRejected, seed)
    assert got == _run_sequence(JController, JRejected, seed)
    verdicts = {t[2] for t in got if isinstance(t, tuple) and t[0] == "offer"}
    assert verdicts >= {"admitted", "queued", "over_budget"}


# ---- bounded plan-keyed tables journal their evictions


def _table(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(rng.integers(0, 5, n).astype(np.int32), INT32, device="cpu"),
        Column.from_numpy(rng.normal(size=n), FLOAT64, device="cpu"),
    ])


def test_plan_feedback_table_is_lru_bounded(telemetry, monkeypatch):
    monkeypatch.setattr(pl, "_PLAN_FEEDBACK_CAP", 4)
    for i in range(6):
        pl._record_feedback(f"sig{i}", "fbcap", {"0.capacity": 16}, {"0.capacity": 8})
    assert len(pl.feedback_table()) == 4
    evs = events.of_kind("plan_cache_evict")
    assert [e["attrs"]["plan"] for e in evs] == ["sig0", "sig1"]
    assert all(e["attrs"]["table"] == "feedback" for e in evs)
    pl._record_feedback("sig2", "fbcap", {"0.capacity": 16}, {"0.capacity": 8})
    pl._record_feedback("sig9", "fbcap", {"0.capacity": 16}, {"0.capacity": 8})
    sigs = set(pl.feedback_table())
    assert "sig2" in sigs and "sig3" not in sigs


def test_executable_cache_eviction_journals(telemetry, monkeypatch):
    monkeypatch.setattr(pl, "_PLAN_CACHE_CAP", 1)
    t = _table(32)
    for name, cap in (("evict_a", 16), ("evict_b", 32)):
        (Pipeline(name).filter(lambda tb: tb.columns[0].data >= 1)
         .group_by([0], [Agg("sum", 1), Agg("count", 0)], capacity=cap)).run(t)
    assert metrics.counter_value("pipeline.plan_cache_evict") >= 1
    evs = [e for e in events.of_kind("plan_cache_evict") if e["attrs"]["table"] == "executable"]
    assert evs and evs[0]["attrs"]["plan"]


def test_flight_prune_spares_other_processes(tmp_path, monkeypatch):
    root = tmp_path / "fl"
    root.mkdir()
    monkeypatch.setattr(flight, "MAX_BUNDLES", 2)
    pid = os.getpid()
    for i in range(4):
        (root / f"flight_20260101T000000Z_p{pid}_{i}").mkdir()
        (root / f"flight_20260101T000000Z_p99999_{i}").mkdir()
    flight._prune(str(root))
    names = sorted(os.listdir(str(root)))
    assert [n for n in names if f"_p{pid}_" in n] == [
        f"flight_20260101T000000Z_p{pid}_2", f"flight_20260101T000000Z_p{pid}_3"]
    assert len([n for n in names if "_p99999_" in n]) == 4
