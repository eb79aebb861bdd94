"""The port's distributed operators (``parallel/distributed.py``) on 8
CPU shards against the JAX package's on its 8 virtual CPU devices: the
two-phase group-by (every aggregate, string keys, the per-stage
overflow breakdown, the observation vectors), the range-partitioned
sort and the sharded collects, shard by shard with tolerance 0 (the
joins are in ``test_torch_distributed_join.py``). Each operator family
runs its JAX side as one jitted program (eager ``shard_map`` calls
compile per op)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops.aggregate import Agg as JAgg
from spark_rapids_jni_tpu.ops.sort import SortKey as JSortKey
from spark_rapids_jni_tpu.parallel import distributed as jd
from spark_rapids_jni_tpu.parallel import mesh as jmesh_mod

from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg as PAgg
from spark_rapids_jni_tpu_torch.ops.sort import SortKey as PSortKey
from spark_rapids_jni_tpu_torch.parallel import distributed as pd
from spark_rapids_jni_tpu_torch.parallel.mesh import Mesh
from spark_rapids_jni_tpu_torch.runtime import metrics
from spark_rapids_jni_tpu_torch.runtime.errors import CapacityExceededError

from torch_parity import assert_same_shards, host_counts, jax_table, numpy_form

P = 8
N = 128
M = 64


def _strings(rng, n, words, p_null):
    idx = rng.integers(0, len(words), n)
    lens = np.array([len(words[i]) for i in idx])
    return {"dtype": ("string", 0, None, None),
            "data": np.frombuffer(b"".join(words[i] for i in idx), np.uint8).copy(),
            "validity": rng.random(n) > p_null,
            "offsets": np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)}


def left_spec(n=N, seed=1):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n)
    f[::9] = np.nan
    f[4::11] = -0.0
    return [
        {"dtype": ("int", 64, None, None), "data": rng.integers(0, 10, n),
         "validity": rng.random(n) > 0.1, "offsets": None},
        {"dtype": ("int", 32, None, None), "data": rng.integers(-50, 300, n).astype(np.int32),
         "validity": None, "offsets": None},
        _strings(rng, n, [b"", b"a", b"hello", b"abcdefghijk", b"xy"], 0.1),
        {"dtype": ("float", 64, None, None), "data": f, "validity": rng.random(n) > 0.2,
         "offsets": None},
        {"dtype": ("decimal", 64, 12, 2), "data": rng.integers(-10**6, 10**6, n),
         "validity": rng.random(n) > 0.2, "offsets": None},
    ]


def right_spec(m=M, seed=2):
    rng = np.random.default_rng(seed)
    return [
        {"dtype": ("int", 64, None, None), "data": rng.integers(0, 12, m),
         "validity": rng.random(m) > 0.1, "offsets": None},
        _strings(rng, m, [b"q", b"zz", b"longer-string"], 0.2),
        {"dtype": ("int", 32, None, None), "data": rng.integers(0, 9, m).astype(np.int32),
         "validity": None, "offsets": None},
    ]


GB_AGGS = (("sum", 1), ("count", None), ("min", 3), ("max", 2), ("mean", 3), ("sum", 4),
           ("mean", 4), ("count", 0))
# name -> (keys, aggs, kwargs); occupied rows are passed to every variant.
# One variant, one JAX compile: short phase-1 and merge capacities (both
# overflow stages count), a wire pin on the int key and a salted
# placement
GROUP_BYS = {
    "int+string keys, every agg, undersized, wire pin, salt": (
        [0, 2], GB_AGGS, dict(string_widths={2: 16}, capacity=4, merge_capacity=3,
                              wire_widths={0: 8}, shuffle_salt=1)),
}
SORTS = {
    "int asc": [(1, True, None)],
    "string desc, int64": [(2, False, None), (0, True, None)],
    "float asc nulls last": [(3, True, False)],
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return left_spec(), right_spec(), rng.random(N) > 0.25, rng.random(M) > 0.2


def _jax_inputs(data):
    ls, rs, lo, ro = data
    return jax_table(ls), jax_table(rs), jnp.asarray(lo), jnp.asarray(ro)


@pytest.fixture(scope="module")
def jax_group_bys(data):
    jm = jmesh_mod.make_mesh(P)

    def run(t, o):
        return {name: jd.distributed_group_by(t, keys, [JAgg(a, c) for a, c in aggs], jm,
                                              occupied=o, overflow_detail=True,
                                              with_stats=True, **kw)
                for name, (keys, aggs, kw) in GROUP_BYS.items()}

    lt, _, lo, _ = _jax_inputs(data)
    return jax.jit(run)(lt, lo)


@pytest.fixture(scope="module")
def jax_sorts(data):
    jm = jmesh_mod.make_mesh(P)

    def run(lt, lo):
        return {name: jd.distributed_sort(lt, [JSortKey(*k) for k in keys], jm, occupied=lo,
                                          string_widths={2: 16}, capacity=24)
                for name, keys in SORTS.items()}

    lt, _, lo, _ = _jax_inputs(data)
    return jax.jit(run)(lt, lo)


def cpu_mesh():
    return Mesh(["cpu"] * P)


def port_inputs(data):
    ls, rs, lo, ro = data
    return (interop.table_from_numpy(ls, device="cpu"), interop.table_from_numpy(rs, device="cpu"),
            torch.from_numpy(lo), torch.from_numpy(ro))


def _same_stats(jstats, pstats):
    assert sorted(jstats) == sorted(pstats)
    for k in jstats:
        np.testing.assert_array_equal(pstats[k].numpy(), np.asarray(jstats[k]), err_msg=k)


@pytest.mark.parametrize("name", sorted(GROUP_BYS))
def test_group_by_matches_jax(data, jax_group_bys, name):
    keys, aggs, kw = GROUP_BYS[name]
    lt, _, lo, _ = port_inputs(data)
    res, occ, ovf, stats = pd.distributed_group_by(lt, keys, [PAgg(a, c) for a, c in aggs],
                                                   cpu_mesh(), occupied=lo, overflow_detail=True,
                                                   with_stats=True, **kw)
    jres, jocc, jovf, jstats = jax_group_bys[name]
    assert host_counts(ovf) == host_counts(jovf)
    assert_same_shards(jres, jocc, res, occ)
    _same_stats(jstats, stats)


@pytest.mark.parametrize("name", sorted(SORTS))
def test_sort_matches_jax(data, jax_sorts, name):
    lt, _, lo, _ = port_inputs(data)
    res, occ, ovf = pd.distributed_sort(lt, [PSortKey(*k) for k in SORTS[name]], cpu_mesh(),
                                        occupied=lo, string_widths={2: 16}, capacity=24)
    jres, jocc, jovf = jax_sorts[name]
    assert int(ovf) == int(jovf)
    assert_same_shards(jres, jocc, res, occ)


def dense_rows(jax_tbl, jax_occ):
    """The live rows of a JAX padded result, compacted on the host (the
    JAX package's retained collect path): per column (data, validity,
    offsets) of the dense table."""
    occ = np.asarray(jax_occ)
    idx = np.flatnonzero(occ)
    out = []
    for c in numpy_form(jax_tbl):
        valid = None if c["validity"] is None else np.asarray(c["validity"])[idx]
        if c["offsets"] is None:
            out.append((np.asarray(c["data"])[idx], valid, None))
            continue
        o = np.asarray(c["offsets"]).astype(np.int64)
        lens = (o[1:] - o[:-1])[idx]
        if valid is not None:
            lens = np.where(valid, lens, 0)
        data = np.concatenate([np.asarray(c["data"])[o[i]:o[i] + n] for i, n in zip(idx, lens)]
                              or [np.zeros(0, np.uint8)])
        out.append((data, valid, np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)))
    return out


@pytest.mark.parametrize("shrink", [True, False])
def test_sharded_collect_matches_jax(data, jax_sorts, shrink):
    """``collect_group_by`` / ``collect_table`` of a sharded result
    (shards gathered onto the first mesh device, per-device occupancy
    published) give the JAX result's live rows; the shrink knob changes
    only where the compaction runs."""
    lt, _, lo, _ = port_inputs(data)
    keys = SORTS["string desc, int64"]
    pd.set_collect_shrink(shrink)
    try:
        res = pd.distributed_sort(lt, [PSortKey(*k) for k in keys], cpu_mesh(), occupied=lo,
                                  string_widths={2: 16}, capacity=24)
        jres = jax_sorts["string desc, int64"]
        want = dense_rows(jres[0], jres[1])
        for got in (pd.collect_group_by(*res), pd.collect_table(res[0], res[1])):
            for g, (wd, wv, wo) in zip(interop.table_to_numpy(got), want):
                np.testing.assert_array_equal(g["data"], wd)
                np.testing.assert_array_equal(g["validity"], wv)
                if wo is not None:
                    np.testing.assert_array_equal(g["offsets"], wo)
        assert metrics.gauge("collect.key_skew").value > 0
    finally:
        pd.set_collect_shrink(None)


def test_sharded_collect_raises_on_overflow(data):
    lt, _, lo, _ = port_inputs(data)
    keys, aggs, kw = GROUP_BYS["int+string keys, every agg, undersized, wire pin, salt"]
    gb = pd.distributed_group_by(lt, keys, [PAgg(a, c) for a, c in aggs], cpu_mesh(),
                                 occupied=lo, overflow_detail=True, **kw)
    with pytest.raises(CapacityExceededError) as e:
        pd.collect_group_by(gb[0], gb[1], gb[2])
    assert e.value.breakdown["local_groups"] > 0


def test_collect_shrink_knob(monkeypatch):
    monkeypatch.setenv(pd.COLLECT_SHRINK_ENV, "off")
    assert pd.collect_shrink() is False
    monkeypatch.setenv(pd.COLLECT_SHRINK_ENV, "sideways")
    with pytest.raises(ValueError, match="expected one of"):
        pd.collect_shrink()
    pd.set_collect_shrink(True)
    try:
        assert pd.collect_shrink() is True
    finally:
        pd.set_collect_shrink(None)
