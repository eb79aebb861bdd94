"""The port's mesh executors (``runtime/resource.py`` ``group_by``,
``join``, ``shuffle`` over an 8-shard mesh) against the JAX package's
on its 8 virtual CPU devices: the same scenarios through both (an
undersized capacity or width that re-plans, a forced retry, a byte
budget, the feedback memo and the program cache), and the collected
results, the task metrics (the attempt trail with each plan, overflow
and byte estimate, the final plans) and the memo and program-cache rows
must be equal, tolerance 0.

The JAX executors call the distributed operators eagerly, and an eager
``shard_map`` compiles per op; here each of those operators runs
jitted once per static plan point instead, with the host-side checks
its eager form makes (a join whose output capacity is short raises)
kept, so the executors see exactly what they see eagerly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops.aggregate import Agg as JAgg
from spark_rapids_jni_tpu.parallel import distributed as jdist
from spark_rapids_jni_tpu.parallel import mesh as jmesh_mod
from spark_rapids_jni_tpu.parallel import shuffle as jshuf
from spark_rapids_jni_tpu.runtime import errors as jerr
from spark_rapids_jni_tpu.runtime import pipeline as jpl
from spark_rapids_jni_tpu.runtime import resource as jres

from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg as PAgg
from spark_rapids_jni_tpu_torch.parallel import spark_hash
from spark_rapids_jni_tpu_torch.parallel.distributed import collect_table
from spark_rapids_jni_tpu_torch.parallel.mesh import Mesh
from spark_rapids_jni_tpu_torch.runtime import errors as perr
from spark_rapids_jni_tpu_torch.runtime import pipeline as ppl
from spark_rapids_jni_tpu_torch.runtime import resource as pres

from torch_parity import jax_table, numpy_form

P = 8
N = 128


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


@pytest.fixture(scope="module")
def jitted_ops():
    """The JAX package's distributed operators, each jitted once per
    static argument point (the join keeps its eager output check)."""
    cache = {}
    orig_gb, orig_join, orig_shuf = (jdist.distributed_group_by, jdist.distributed_join,
                                     jshuf.hash_shuffle)

    def group_by(table, key_indices, aggs, mesh, axis="data", occupied=None, **kw):
        key = ("gb", tuple(key_indices), tuple(aggs), axis, _freeze(kw), occupied is None)
        if key not in cache:
            cache[key] = jax.jit(lambda t, o: orig_gb(t, list(key_indices), list(aggs), mesh,
                                                      axis=axis, occupied=o, **kw))
        return cache[key](table, occupied)

    def join(left, right, left_on, right_on, mesh, how="inner", axis="data", left_occupied=None,
             right_occupied=None, with_stats=False, **kw):
        key = ("join", tuple(left_on), tuple(right_on), how, axis, _freeze(kw),
               left_occupied is None, right_occupied is None)
        if key not in cache:
            cache[key] = jax.jit(lambda a, b, lo, ro: orig_join(
                a, b, list(left_on), list(right_on), mesh, how=how, axis=axis, left_occupied=lo,
                right_occupied=ro, with_stats=True, **kw))
        res, occ, ovf, stats = cache[key](left, right, left_occupied, right_occupied)
        need = stats["out_needed_per_dev"]
        # the eager form's output check (skipped under a trace, as in the
        # JAX package: its cached join program is jitted)
        mx = None if isinstance(need, jax.core.Tracer) else int(jnp.max(need))
        if mx is not None and mx > kw["out_capacity"]:
            raise jerr.CapacityExceededError(
                f"distributed_join: a shard needs {mx} output rows > "
                f"out_capacity={kw['out_capacity']}; raise out_capacity",
                stage="join_output", needed=mx, granted=kw["out_capacity"])
        return (res, occ, ovf, stats) if with_stats else (res, occ, ovf)

    def shuffle(table, key_indices, mesh, axis="data", occupied=None, **kw):
        key = ("shuffle", tuple(key_indices), axis, _freeze(kw), occupied is None)
        if key not in cache:
            cache[key] = jax.jit(lambda t, o: orig_shuf(t, list(key_indices), mesh, axis=axis,
                                                        occupied=o, **kw))
        return cache[key](table, occupied)

    mp = pytest.MonkeyPatch()
    mp.setattr(jdist, "distributed_group_by", group_by)
    mp.setattr(jdist, "distributed_join", join)
    mp.setattr(jshuf, "hash_shuffle", shuffle)
    yield
    mp.undo()


@pytest.fixture(autouse=True)
def _clean_state():
    for res, pl in ((jres, jpl), (pres, ppl)):
        res.reset()
        res.exec_feedback_clear()
        pl.set_capacity_feedback(None)
    yield
    for res, pl in ((jres, jpl), (pres, ppl)):
        res.reset()
        res.exec_feedback_clear()
        pl.set_capacity_feedback(None)


def spec(n=N, seed=5):
    rng = np.random.default_rng(seed)
    return [
        {"dtype": ("int", 64, None, None), "data": rng.integers(0, 24, n),
         "validity": rng.random(n) > 0.1, "offsets": None},
        {"dtype": ("int", 64, None, None), "data": rng.integers(-1000, 1000, n),
         "validity": None, "offsets": None},
        {"dtype": ("int", 32, None, None), "data": rng.integers(0, 6, n).astype(np.int32),
         "validity": None, "offsets": None},
    ]


def both(scenario):
    """Run ``scenario(res, table, other, mesh, Agg)`` through the JAX
    package and through the port; returns {side: (value, metrics)}."""
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            res, mesh, Agg = jres, jmesh_mod.make_mesh(P), JAgg
            table, other = jax_table(spec()), jax_table(spec(64, seed=6))
        else:
            res, mesh, Agg = pres, Mesh(["cpu"] * P), PAgg
            table = interop.table_from_numpy(spec(), device="cpu")
            other = interop.table_from_numpy(spec(64, seed=6), device="cpu")
        with res.task(max_retries=6) as task:
            value = scenario(res, table, other, mesh, Agg)
        out[side] = (value, task.metrics)
    return out


def summary(m):
    return {
        "retries": m.retries,
        "injected_ooms": m.injected_ooms,
        "final_plans": m.final_plans,
        "attempts": [(a.op, a.attempt, a.plan, a.est_bytes, a.overflow, a.injected, a.ok)
                     for a in m.attempts],
    }


def rows(tbl):
    """A collected Table's columns as (data, validity) lists, JAX or port."""
    form = numpy_form(tbl) if not hasattr(tbl.columns[0].data, "numpy") else \
        interop.table_to_numpy(tbl)
    out = []
    for c in form:
        valid = np.ones(len(c["data"]), bool) if c["validity"] is None else c["validity"]
        out.append((np.asarray(c["data"]).tolist(), np.asarray(valid).tolist()))
    return out


def test_group_by_replans_like_jax(jitted_ops):
    """capacity=1: the local_groups overflow (a sum over shards, an upper
    bound on the need) grows the per-shard capacity in one re-plan."""
    got = both(lambda res, t, o, mesh, Agg: res.group_by(
        t, [0], [Agg("sum", 1), Agg("count")], mesh, capacity=1))
    assert summary(got["port"][1]) == summary(got["jax"][1])
    assert got["port"][1].retries >= 1
    assert rows(got["port"][0]) == rows(got["jax"][0])


def test_join_replans_like_jax(jitted_ops):
    """A short output capacity raises inside the attempt (the re-plan
    takes the reported need)."""
    got = both(lambda res, t, o, mesh, Agg: res.join(
        t, o, [0], [0], mesh, shuffle_capacity=16, out_capacity=8))
    assert summary(got["port"][1]) == summary(got["jax"][1])
    assert got["port"][1].retries >= 1
    assert rows(got["port"][0]) == rows(got["jax"][0])


def test_shuffle_replans_like_jax(jitted_ops):
    got = both(lambda res, t, o, mesh, Agg: res.shuffle(t, [0, 1], mesh, capacity=1))
    assert summary(got["port"][1]) == summary(got["jax"][1])
    (pout, pocc), (jout, jocc) = got["port"][0], got["jax"][0]
    m = len(pocc[0])
    jocc = np.asarray(jocc)
    for s in range(P):
        np.testing.assert_array_equal(pocc[s].numpy(), jocc[s * m:(s + 1) * m])
        # every live row sits on the shard its Spark hash names
        h = spark_hash.partition_ids(type(pout.shards[s])(pout.shards[s].columns[:2]), P)
        assert not bool((pocc[s] & (h != s)).any())
    assert rows(collect_table(pout, pocc)) == rows(jdist.collect_table(jout, jocc))


def test_forced_retry_and_budget_like_jax(jitted_ops):
    def forced(res, t, o, mesh, Agg):
        res.force_retry_oom(1)
        return res.group_by(t, [0], [Agg("sum", 1), Agg("count")], mesh, capacity=24)

    got = both(forced)
    assert summary(got["port"][1]) == summary(got["jax"][1])
    assert got["port"][1].injected_ooms == 1
    for res, err, mesh, t, Agg in (
            (jres, jerr, jmesh_mod.make_mesh(P), jax_table(spec()), JAgg),
            (pres, perr, Mesh(["cpu"] * P), interop.table_from_numpy(spec(), device="cpu"),
             PAgg)):
        with pytest.raises(err.RetryOOMError):
            with res.task(budget=4096):
                res.group_by(t, [0], [Agg("sum", 1), Agg("count")], mesh, capacity=1)


def _rows_of(table_rows):
    return sorted(zip(*[d for d, _ in table_rows]))


def test_memo_and_program_cache_like_jax(jitted_ops):
    """With the capacity-feedback knob on, the second call of a site
    starts from the first call's observations and runs through the
    cached program: the memo rows, the program-cache rows and the task
    metrics match the JAX package's."""
    def twice(res, t, o, mesh, Agg):
        first = res.group_by(t, [0], [Agg("sum", 1), Agg("count")], mesh, capacity=24)
        second = res.group_by(t, [0], [Agg("sum", 1), Agg("count")], mesh, capacity=24)
        return first, second

    for pl in (jpl, ppl):
        pl.set_capacity_feedback(True)
    got = both(twice)
    assert summary(got["port"][1]) == summary(got["jax"][1])
    for (pv, jv) in zip(got["port"][0], got["jax"][0]):
        assert _rows_of(rows(pv)) == _rows_of(rows(jv))
    memo = {s: r.exec_feedback_table() for s, r in (("port", pres), ("jax", jres))}
    assert memo["port"] == memo["jax"] and memo["port"][0]["chunks"] == 2
    progs = {s: [{k: v for k, v in row.items() if k != "build_wall_ms"}
                 for row in r.program_cache_table()] for s, r in (("port", pres), ("jax", jres))}
    assert progs["port"] == progs["jax"] and progs["port"][0]["hits"] == 0


def test_skew_salt_knobs_are_the_jax_packages():
    assert (pres.EXEC_SKEW_THRESHOLD, pres.MAX_SHUFFLE_SALT) == (jres.EXEC_SKEW_THRESHOLD,
                                                                  jres.MAX_SHUFFLE_SALT)
    stats = {"merge_groups_per_dev": [1, 1, 1, 9]}
    assert pres._merge_skew(stats) == jres._merge_skew(stats) == 3.0
    assert pres._merge_skew(None) == jres._merge_skew(None) == 0.0
    assert dataclasses.is_dataclass(pres.OpAttempt)
    t = interop.table_from_numpy(spec(), device="cpu")
    assert pres._mesh_sig(Mesh(["cpu"] * P)) == jres._mesh_sig(jmesh_mod.make_mesh(P))
    assert pres._estimate_group_by_bytes(t, P, {"capacity": 4, "merge_capacity": None}) == \
        jres._estimate_group_by_bytes(jax_table(spec()), P, {"capacity": 4,
                                                             "merge_capacity": None})
    plan = {"shuffle_capacity": None, "out_capacity": 16}
    assert pres._estimate_join_bytes(t, t, P, plan) == \
        jres._estimate_join_bytes(jax_table(spec()), jax_table(spec()), P, plan)
    assert torch.is_tensor(pres._max_bucket_fill(Mesh(["cpu"] * 2),
                                                 [torch.ones(4, dtype=torch.bool)] * 2, 2))


def test_warm_join_program_counts_like_jax(jitted_ops):
    """A converged join runs through the cached program in its sync-free
    form (the JAX package's runs jitted): a short output capacity is
    counted, not raised, and the re-plan takes the count, as in the JAX
    package; the second call joins a larger build side than the memo
    saw."""
    # the second build side has the first one's shape (the JAX program
    # of the first call is reused) but every key is 0: one shard needs
    # far more output rows than the memo saw
    hot = [dict(c, data=np.zeros_like(c["data"])) if i == 2 else c
           for i, c in enumerate(spec(64, seed=6))]

    def warm(res, t, o, mesh, Agg):
        first = res.join(t, o, [2], [2], mesh, shuffle_capacity=64, out_capacity=256)
        build = jax_table(hot) if res is jres else interop.table_from_numpy(hot, device="cpu")
        second = res.join(t, build, [2], [2], mesh, shuffle_capacity=64, out_capacity=256)
        return first, second

    for pl in (jpl, ppl):
        pl.set_capacity_feedback(True)
    got = both(warm)
    assert summary(got["port"][1]) == summary(got["jax"][1])
    assert any(a.overflow and a.overflow.get("join_output") for a in got["port"][1].attempts)
    for pv, jv in zip(got["port"][0], got["jax"][0]):
        assert _rows_of(rows(pv)) == _rows_of(rows(jv))
