"""The port's distributed joins (``parallel/distributed.py``) on 8 CPU
shards against the JAX package's on its 8 virtual CPU devices: the
co-partitioned join of every kind (string payloads, occupied rows on
both sides, a short output counted inside a fused chain), a string +
int32 key join and the broadcast join, shard by shard with tolerance 0,
with the per-stage overflow counts and the observation vectors. The
JAX side runs as one jitted program per family."""

import jax
import torch
import pytest

from spark_rapids_jni_tpu.parallel import distributed as jd
from spark_rapids_jni_tpu.parallel import mesh as jmesh_mod

from spark_rapids_jni_tpu_torch.ops._strategy import fusing
from spark_rapids_jni_tpu_torch.parallel import distributed as pd
from spark_rapids_jni_tpu_torch.runtime.errors import CapacityExceededError

from test_torch_distributed import P, _jax_inputs, _same_stats, cpu_mesh, port_inputs
from test_torch_distributed import data  # noqa: F401  (the shared seeded inputs)
from torch_parity import assert_same_shards, host_counts

HOWS = ("inner", "left", "right", "full", "left_semi", "left_anti")
WIDTHS = dict(left_string_widths={2: 16}, right_string_widths={1: 16})
JOINS = {f"int64 key {how}": ([0], [0], how, dict(out_capacity=256, shuffle_capacity=12))
         for how in HOWS}
# the inner join's output capacity is short: its matches past it are
# dropped and counted (the other kinds are exact)
JOINS["int64 key inner"] = ([0], [0], "inner", dict(out_capacity=16, shuffle_capacity=12))
# the kinds differ only inside the local join, which the co-partitioned
# cases cover; the broadcast cases hold the replicated build side
BROADCASTS = {how: dict(out_capacity=64) for how in ("left", "left_anti")}


@pytest.fixture(scope="module")
def jax_joins(data):
    jm = jmesh_mod.make_mesh(P)

    def run(lt, rt, lo, ro):
        out = {name: jd.distributed_join(lt, rt, lk, rk, jm, how, left_occupied=lo,
                                         right_occupied=ro, overflow_detail=True,
                                         with_stats=True, **WIDTHS, **kw)
               for name, (lk, rk, how, kw) in JOINS.items()}
        out["string+int32 keys inner"] = jd.distributed_join(
            lt, rt, [2, 1], [1, 2], jm, "inner", out_capacity=64, overflow_detail=True,
            **WIDTHS)
        return out

    return jax.jit(run)(*_jax_inputs(data))


@pytest.fixture(scope="module")
def jax_broadcasts(data):
    jm = jmesh_mod.make_mesh(P)

    def run(lt, rt, lo, ro):
        out = {f"broadcast {how}": jd.distributed_join_broadcast(
            lt, rt, [0, 1], [0, 2], jm, how, left_occupied=lo, right_occupied=ro,
            overflow_detail=True, with_stats=True, **WIDTHS, **kw)
            for how, kw in BROADCASTS.items()}
        return out

    return jax.jit(run)(*_jax_inputs(data))


@pytest.mark.parametrize("name", sorted(JOINS) + ["string+int32 keys inner"])
def test_join_matches_jax(data, jax_joins, name):
    lt, rt, lo, ro = port_inputs(data)
    if name == "string+int32 keys inner":
        out = pd.distributed_join(lt, rt, [2, 1], [1, 2], cpu_mesh(), "inner", out_capacity=64,
                                  overflow_detail=True, **WIDTHS)
    else:
        lk, rk, how, kw = JOINS[name]
        # a short output capacity raises outside a fused chain; inside
        # one it is counted, as under jit
        with fusing():
            out = pd.distributed_join(lt, rt, lk, rk, cpu_mesh(), how, left_occupied=lo,
                                      right_occupied=ro, overflow_detail=True, with_stats=True,
                                      **WIDTHS, **kw)
        _same_stats(jax_joins[name][3], out[3])
    jres = jax_joins[name]
    assert host_counts(out[2]) == host_counts(jres[2])
    assert_same_shards(jres[0], jres[1], out[0], out[1])


def test_join_output_short_raises_outside_a_fused_chain(data):
    lt, rt, lo, ro = port_inputs(data)
    with pytest.raises(CapacityExceededError) as e:
        pd.distributed_join(lt, rt, [0], [0], cpu_mesh(), "inner", left_occupied=lo,
                            right_occupied=ro, out_capacity=16, **WIDTHS)
    assert e.value.stage == "join_output" and e.value.needed > 16
    with pytest.raises(TypeError, match="dtype mismatch"):
        pd.distributed_join(lt, rt, [1], [0], cpu_mesh(), **WIDTHS)


@pytest.mark.parametrize("how", sorted(BROADCASTS))
def test_broadcast_join_matches_jax(data, jax_broadcasts, how):
    lt, rt, lo, ro = port_inputs(data)
    out = pd.distributed_join_broadcast(lt, rt, [0, 1], [0, 2], cpu_mesh(), how,
                                        left_occupied=lo, right_occupied=ro,
                                        overflow_detail=True, with_stats=True, **WIDTHS,
                                        **BROADCASTS[how])
    jres = jax_broadcasts[f"broadcast {how}"]
    assert host_counts(out[2]) == host_counts(jres[2])
    assert_same_shards(jres[0], jres[1], out[0], out[1])
    _same_stats(jres[3], out[3])


def test_broadcast_join_rejects_outer_build_rows(data):
    lt, rt, _, _ = port_inputs(data)
    for how in ("full", "right"):
        with pytest.raises(ValueError, match="broadcast join cannot run"):
            pd.distributed_join_broadcast(lt, rt, [0], [0], cpu_mesh(), how, **WIDTHS)
    with pytest.raises(ValueError, match="pinned width"):
        pd.distributed_join_broadcast(lt, rt, [0], [0], cpu_mesh())


def test_multi_device_mesh_matches_shared_device(data):
    """The operators over a mesh whose shards sit on different devices
    (the multi-card path: per-shard packs, peer-copy all_to_all, a build
    side copied per device) give what the one-device mesh gives; on the
    CPU "cpu" and "cpu:0" are distinct devices."""
    from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
    from spark_rapids_jni_tpu_torch.ops.sort import SortKey
    from spark_rapids_jni_tpu_torch.parallel.mesh import Mesh

    lt, rt, lo, ro = port_inputs(data)
    mixed = Mesh(["cpu", "cpu:0"] * (P // 2))
    runs = {
        "join": lambda m: pd.distributed_join(lt, rt, [0], [0], m, "full", left_occupied=lo,
                                              right_occupied=ro, out_capacity=256, **WIDTHS),
        "broadcast": lambda m: pd.distributed_join_broadcast(
            lt, rt, [0], [0], m, "left", left_occupied=lo, out_capacity=64, **WIDTHS),
        "group_by": lambda m: pd.distributed_group_by(
            lt, [2], [Agg("sum", 1), Agg("max", 3)], m, occupied=lo, string_widths={2: 16}),
        "sort": lambda m: pd.distributed_sort(lt, [SortKey(0)], m, occupied=lo,
                                              string_widths={2: 16}),
    }
    for name, run in runs.items():
        a, b = run(mixed), run(cpu_mesh())
        assert int(a[2]) == int(b[2]), name
        for sa, sb, oa, ob in zip(a[0].shards, b[0].shards, a[1], b[1]):
            assert torch.equal(oa, ob), name
            for ca, cb in zip(sa.columns, sb.columns):
                x, y = ca.data, cb.data
                if x.is_floating_point():
                    x, y = x.view(torch.int64), y.view(torch.int64)
                assert torch.equal(x, y), name
