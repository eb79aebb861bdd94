"""The port's task-scoped retry runtime (``runtime/resource.py``)
against the JAX package's: the same scenarios run through both, and the
results, the raised error types and the task metrics (retries, injected
OOMs, attempt trail, final plans, peak bytes) must be equal.

Scenarios run against stub ops (the retry state machine) and against
the bounded join (``resource.join_padded`` over equal seeded tables)."""

import numpy as np
import pytest

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.runtime import errors as jerr
from spark_rapids_jni_tpu.runtime import faultinj as jfi
from spark_rapids_jni_tpu.runtime import pipeline as jpl
from spark_rapids_jni_tpu.runtime import resource as jres

from spark_rapids_jni_tpu_torch.runtime import errors as perr
from spark_rapids_jni_tpu_torch.runtime import faultinj as pfi
from spark_rapids_jni_tpu_torch.runtime import pipeline as ppl
from spark_rapids_jni_tpu_torch.runtime import resource as pres

from torch_parity import assert_same_table, to_port

BOTH = (
    ("jax", jres, jfi, jerr, jpl),
    ("port", pres, pfi, perr, ppl),
)


@pytest.fixture(autouse=True)
def _clean_state():
    for _, res, fi, _, pl in BOTH:
        res.reset()
        fi.reset()
        pl.set_capacity_feedback(None)
    yield
    for _, res, fi, _, pl in BOTH:
        res.reset()
        fi.reset()
        pl.set_capacity_feedback(None)


def _summary(m):
    """The comparable part of a TaskMetrics (ids and walls differ)."""
    return {
        "retries": m.retries,
        "injected_ooms": m.injected_ooms,
        "num_retry_throw": m.num_retry_throw,
        "peak_bytes": m.peak_bytes,
        "final_plans": m.final_plans,
        "attempts": [(a.op, a.attempt, a.plan, a.est_bytes, a.overflow, a.injected, a.ok)
                     for a in m.attempts],
    }


def _stub(fail_times, stage="local_groups"):
    calls = {"n": 0}

    def attempt(plan):
        calls["n"] += 1
        if calls["n"] <= fail_times:
            return None, {stage: 7}
        return ("ok", dict(plan)), {stage: 0}

    return attempt, calls


def _grow(plan, counts, exc):
    return {"capacity": plan["capacity"] * 2}


def _est(plan):
    return plan["capacity"] * 100


def _run(res, err, scenario):
    """Run ``scenario(res)``; return (value or error type name, task
    metrics summary or None)."""
    try:
        out = scenario(res)
    except (err.RetryOOMError, err.CapacityExceededError) as e:
        out = type(e).__name__
        m = getattr(e, "metrics", None)
        return out, None if m is None else _summary(m)
    m = res.metrics()
    return out, None if m is None else _summary(m)


SCENARIOS = {
    "converges": lambda r: _in_task(r, {}, lambda: r._run_with_retry(
        "stub", _stub(2)[0], _grow, _est, {"capacity": 1})),
    "retry_bound": lambda r: _in_task(r, {"max_retries": 2}, lambda: r._run_with_retry(
        "stub", _stub(10)[0], _grow, _est, {"capacity": 1})),
    "budget": lambda r: _in_task(r, {"budget": 350}, lambda: r._run_with_retry(
        "stub", _stub(10)[0], _grow, _est, {"capacity": 1})),
    "no_knob": lambda r: _in_task(r, {}, lambda: r._run_with_retry(
        "stub", _stub(10)[0], lambda p, c, e: None, _est, {"capacity": 1})),
    "retries_disabled": lambda r: _in_task(r, {"retries_enabled": False},
                                           lambda: r._run_with_retry(
        "stub", _stub(1)[0], _grow, _est, {"capacity": 1})),
    "forced_oom": lambda r: _in_task(r, {}, lambda: (r.force_retry_oom(2), r._run_with_retry(
        "stub", _stub(0)[0], _grow, _est, {"capacity": 3}))[1]),
    "forced_oom_skip": lambda r: _in_task(r, {}, lambda: (
        r.force_retry_oom(1, skip_count=1),
        r.guard("first", lambda: 1),
        r.guard("second", lambda: 2),
    )[1:]),
    "guard": lambda r: _in_task(r, {}, lambda: r.guard("g", lambda: "v", estimate=lambda p: 64)),
    "forced_past_bound": lambda r: _in_task(r, {"max_retries": 1}, lambda: (
        r.force_retry_oom(3), r.guard("g", lambda: 1))[1]),
}


def _in_task(res, kw, body):
    with res.task(**kw):
        return body()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_state_machine_matches(name):
    got = {}
    for tag, res, _fi, err, _pl in BOTH:
        got[tag] = _run(res, err, SCENARIOS[name])
    assert got["port"] == got["jax"]


def test_outside_scope_raises_like_direct_call():
    for _tag, res, _fi, err, _pl in BOTH:
        with pytest.raises(err.CapacityExceededError) as ei:
            res._run_with_retry("stub", _stub(1)[0], _grow, _est, {"capacity": 1})
        assert ei.value.stage == "local_groups"
        assert ei.value.breakdown == {"local_groups": 7}


def test_guard_propagates_capacity_error_unchanged():
    for _tag, res, _fi, err, _pl in BOTH:
        exc = err.CapacityExceededError("boom", stage="string_width", needed=9, granted=4)

        def op():
            raise exc

        with res.task():
            with pytest.raises(err.CapacityExceededError) as ei:
                res.guard("g", op)
        assert ei.value is exc


def test_registry_and_java_facade_counters():
    for _tag, res, _fi, _err, _pl in BOTH:
        t = res.start_task(77, budget=10**6)
        assert res.current_task() is t
        res.force_retry_oom(1, task_id=77)
        res.guard("g", lambda: 1)
        assert res.get_and_reset_num_retry(77) == 1
        assert res.get_and_reset_num_retry(77) == 0
        m = res.task_done(77)
        assert m.retries == 1 and m.injected_ooms == 1
        assert res.current_task() is None
        assert res.metrics(77) is m


def test_use_task_activates_open_task():
    """A task opened on another thread (the serving interleaver's case)
    is current only inside ``use_task`` and stays open after it."""
    import threading

    for _tag, res, _fi, _err, _pl in BOTH:
        opened = []
        th = threading.Thread(target=lambda: opened.append(res.start_task(5)))
        th.start()
        th.join()
        t = opened[0]
        assert res.current_task() is None
        with res.use_task(t):
            assert res.current_task() is t
            res.force_retry_oom(1)
            res.guard("g", lambda: 1)
        assert res.current_task() is None
        assert res.task_done(5).injected_ooms == 1


def test_faultinj_retry_oom_kind_drives_retry(tmp_path, monkeypatch):
    cfg = tmp_path / "fi.json"
    cfg.write_text('{"opFaults": {"Resource.g": {"injectionType": "retry_oom", '
                   '"interceptionCount": 2}}}')
    monkeypatch.setenv("FAULT_INJECTOR_CONFIG_PATH", str(cfg))
    got = {}
    for tag, res, fi, err, _pl in BOTH:
        fi.reset()
        got[tag] = _run(res, err, lambda r: _in_task(r, {}, lambda: r.guard("g", lambda: 3)))
    assert got["port"] == got["jax"]
    assert got["port"][1]["injected_ooms"] == 2


# ---------------------------------------------------------------------
# join_padded: grows to the reported need, rows never drop


def _join_sides(seed=0):
    rng = np.random.default_rng(seed)
    left = Table([
        Column.from_numpy(rng.integers(0, 6, 40), jd.INT64, rng.random(40) > 0.1),
        Column.from_numpy(rng.normal(size=40), jd.FLOAT64),
    ])
    right = Table([
        Column.from_numpy(rng.integers(0, 6, 30), jd.INT64),
        Column.from_numpy(rng.integers(-9, 9, 30).astype(np.int32), jd.INT32),
    ])
    return left, right


@pytest.mark.parametrize("how", ["inner", "left", "full", "left_semi"])
def test_join_padded_grows_to_need(how):
    left, right = _join_sides()
    with jres.task():
        jt, jocc = jres.join_padded(left, right, [0], [0], 4, how)
        jm = _summary(jres.metrics())
    with pres.task():
        pt, pocc = pres.join_padded(to_port(left), to_port(right), [0], [0], 4, how)
        pm = _summary(pres.metrics())
    assert pm == jm
    np.testing.assert_array_equal(pocc.numpy(), np.asarray(jocc))
    assert_same_table(jt, pt, validity_or_true=True)


def test_join_padded_feedback_converges_and_uses_program():
    left, right = _join_sides(3)
    for _tag, res, _fi, _err, pl in BOTH:
        pl.set_capacity_feedback(True)
    rows = {}
    for tag, res, _fi, _err, _pl in BOTH:
        lt, rt = (left, right) if tag == "jax" else (to_port(left), to_port(right))
        with res.task():
            for _ in range(3):
                res.join_padded(lt, rt, [0], [0], 2, "inner")
            rows[tag] = [(r["op"], r["knobs"], r["chunks"]) for r in res.exec_feedback_table()]
            rows[tag + "_prog"] = [(r["op"], r["plan"], r["hits"])
                                   for r in res.program_cache_table()]
            rows[tag + "_m"] = _summary(res.metrics())
    assert rows["port"] == rows["jax"]
    assert rows["port_prog"] == rows["jax_prog"]
    assert rows["port_m"] == rows["jax_m"]
    assert rows["port_prog"] and rows["port_prog"][0][2] >= 1


def test_join_padded_outside_scope_raises():
    left, right = _join_sides()
    for tag, res, _fi, err, _pl in BOTH:
        lt, rt = (left, right) if tag == "jax" else (to_port(left), to_port(right))
        with pytest.raises(err.CapacityExceededError):
            res.join_padded(lt, rt, [0], [0], 2, "inner")


def test_deferred_plan_retires_and_rejects_twice():
    for _tag, res, _fi, _err, _pl in BOTH:
        attempt, calls = _stub(1)

        def dispatch(plan):
            return attempt(plan)

        def sync(value):
            return value[1]

        with res.task():
            d = res.run_plan_deferred("d", dispatch, sync, _grow, _est, {"capacity": 1})
            value, counts = d.retire()
            assert value == ("ok", {"capacity": 2}) and counts == {"local_groups": 0}
            assert d.retries == 1 and d.estimate_bytes() == 200
            with pytest.raises(RuntimeError):
                d.retire()


# ---------------------------------------------------------------------
# the driver-side collect of a padded result


@pytest.mark.parametrize("how", ["inner", "full"])
def test_collect_table_matches_jax(how):
    from spark_rapids_jni_tpu.ops.join import join_padded as jjp
    from spark_rapids_jni_tpu.parallel import distributed as jdist

    from spark_rapids_jni_tpu_torch.ops.join import join_padded as pjp
    from spark_rapids_jni_tpu_torch.parallel import distributed as pdist

    left, right = _join_sides(5)
    left = Table(list(left.columns) + [Column.from_pylist(
        [None if i % 9 == 0 else "s" * (i % 5) for i in range(40)], jd.STRING)])
    jt, jocc = jjp(left, right, [0], [0], 96, how)
    pt, pocc = pjp(to_port(left), to_port(right), [0], [0], 96, how)
    assert_same_table(jdist.collect_table(jt, jocc), pdist.collect_table(pt, pocc),
                      validity_or_true=True)
    assert_same_table(jdist.collect_group_by(jt, jocc), pdist.collect_group_by(pt, pocc),
                      validity_or_true=True)


def test_collect_overflow_and_no_mask():
    import torch

    from spark_rapids_jni_tpu_torch.parallel import distributed as pdist

    left, _ = _join_sides(6)
    t = to_port(left)
    occ = torch.ones(t.num_rows, dtype=torch.bool)
    with pytest.raises(perr.CapacityExceededError) as ei:
        pdist.collect_table(t, occ, overflow={"join_output": torch.tensor(3),
                                              "string_width": torch.tensor(0)})
    assert ei.value.stage == "join_output"
    with pytest.raises(perr.CapacityExceededError):
        pdist.collect_table(t, occ, overflow=torch.tensor(1))
    dense = pdist.collect_table(t)  # no mask: all-valid masks dropped
    assert dense.columns[1].validity is None and dense.num_rows == t.num_rows
