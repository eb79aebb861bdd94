"""TPC-H q5 over the port's exchange on 8 CPU shards: ``chip_smoke``'s
phase-26 chain (``q5_exchange_build`` / ``q5_exchange_batch``: the
build once, then per lineitem batch two distributed joins, the region
mask, the revenue product and the distributed group-by, every step
through the mesh executors) held exactly against the host oracle that
gates the card run; and the JAX package's distributed q5 chain of
``tests/test_tpch_q5.py`` at its own sizes (64 customers, 128 orders,
512 lineitem rows) against the same chain through the port's
distributed operators, tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar.dtypes import DATE32, FLOAT64, INT64
from spark_rapids_jni_tpu.ops.aggregate import Agg as JAgg
from spark_rapids_jni_tpu.parallel import distributed as jdist
from spark_rapids_jni_tpu.parallel import mesh as jmesh_mod

from spark_rapids_jni_tpu_torch import Column as PColumn
from spark_rapids_jni_tpu_torch import Table as PTable
from spark_rapids_jni_tpu_torch.columnar import dtypes as pdt
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg as PAgg
from spark_rapids_jni_tpu_torch.parallel import distributed as pdist
from spark_rapids_jni_tpu_torch.parallel.mesh import Mesh, ShardedTable
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.runtime import resource

from test_tpch_q5 import ASIA_NATIONS, D0, D1, _data, _oracle
from torch_parity import numpy_form

SCALE = {"n_supp": 200, "n_cust": 600, "n_ord": 6000}
BATCH = 15_000  # two lineitem batches, the second shorter (padded to 8 shards)
CAPS = {"join_orders": (256, 512), "join_supplier": (64, 128)}  # per shard; re-plans if short
P = 8


@pytest.fixture(scope="module")
def q5_run():
    """The phase-26 chain at a small scale, under one task scope with the
    capacity-feedback memo on, as the card runs it."""
    d = cs.q5_data(**SCALE)
    t = cs.q5_tables(d, "cpu", BATCH)
    mesh = Mesh(["cpu"] * P)
    pl.set_capacity_feedback(True)
    resource.exec_feedback_clear()
    try:
        with resource.task() as task:
            build, build_live = cs.q5_exchange_build(t, mesh, resource)
            parts = []
            for li in t["lineitem"]:
                out, joins, over = cs.q5_exchange_batch(li, build, build_live, t["supplier"],
                                                        mesh, resource, caps=CAPS)
                assert not bool(over)
                parts.append(out)
            memo = resource.exec_feedback_table()
    finally:
        pl.set_capacity_feedback(None)
    return d, parts, cs.q5_merge(parts), task.metrics, memo


def test_q5_exchange_matches_oracle(q5_run):
    d, parts, final, _metrics, _memo = q5_run
    assert len(parts) == 2
    for i, p in enumerate(parts):
        assert sorted(cs.q5_rows(p)) == sorted(cs.q5_oracle(d, i * BATCH, (i + 1) * BATCH).items())
    want = cs.q5_final_rows(cs.q5_oracle(d))
    assert cs.q5_rows(final) == want and len(want) == 5


def test_q5_exchange_runs_through_the_executors(q5_run):
    """Every join and group-by of the chain went through the mesh
    executors: the memo holds one row per call site (the build join,
    the two batch joins, the group-by), each keyed by the 8-shard mesh."""
    _d, _parts, _final, metrics, memo = q5_run
    assert sorted(r["op"] for r in memo) == ["group_by", "join", "join", "join"]
    assert all(r["mesh"] == (("data", P),) for r in memo)
    assert {a.op for a in metrics.attempts} == {"join", "group_by"}


def _port_table(cols, dtypes, names):
    return PTable([PColumn.from_numpy(np.asarray(v), t, device="cpu")
                   for v, t in zip(cols, dtypes)], names)


def _port_chain(cust, orders, li, supp):
    """tests/test_tpch_q5.py's chain through the port's distributed
    operators on 8 CPU shards."""
    mesh = Mesh(["cpu"] * P)
    i64, d32, f64 = pdt.INT64, pdt.DATE32, pdt.FLOAT64
    t_cust = _port_table(cust.values(), [i64, i64], tuple(cust))
    t_ord = _port_table(orders.values(), [i64, i64, d32], tuple(orders))
    t_li = _port_table(li.values(), [i64, i64, f64, f64], tuple(li))
    t_supp = _port_table(supp.values(), [i64, i64], tuple(supp))
    odate = t_ord.columns[2].data
    ord_occ = (odate >= D0) & (odate < D1)
    t1, occ1, ovf1 = pdist.distributed_join(t_ord, t_cust, [1], [0], mesh, "inner",
                                            left_occupied=ord_occ)
    t2, occ2, ovf2 = pdist.distributed_join(t_li, t1, [0], [0], mesh, "inner",
                                            right_occupied=occ1, shuffle_capacity=256)
    t3, occ3, ovf3 = pdist.distributed_join(t2, t_supp, [1, 8], [0, 1], mesh, "inner",
                                            left_occupied=occ2, shuffle_capacity=256)
    shards, live = [], []
    asia = torch.from_numpy(ASIA_NATIONS)
    for s, part in enumerate(t3.shards):
        price, disc = part.columns[2].data, part.columns[3].data
        rev = PColumn(f64, price * (1.0 - disc))
        shards.append(PTable(list(part.columns) + [rev]))
        live.append(occ3[s] & torch.isin(part.columns[10].data, asia))
    res, occ, ovf4 = pdist.distributed_group_by(ShardedTable(shards, mesh), [10],
                                                [PAgg("sum", 11), PAgg("count")], mesh,
                                                occupied=live)
    return pdist.collect_group_by(res, occ, ovf1 + ovf2 + ovf3 + ovf4)


def _jax_chain(cust, orders, li, supp):
    """tests/test_tpch_q5.py's chain on the JAX package's 8 virtual
    devices, jitted once."""
    jm = jmesh_mod.make_mesh(P)

    def table(d, dtypes):
        return Table([Column.from_numpy(v, t) for v, t in zip(d.values(), dtypes)],
                     tuple(d.keys()))

    def run(t_ord, t_cust, t_li, t_supp):
        odate = t_ord.columns[2].data
        ord_occ = (odate >= D0) & (odate < D1)
        t1, occ1, ovf1 = jdist.distributed_join(t_ord, t_cust, [1], [0], jm, "inner",
                                                left_occupied=ord_occ)
        t2, occ2, ovf2 = jdist.distributed_join(t_li, t1, [0], [0], jm, "inner",
                                                right_occupied=occ1, shuffle_capacity=256)
        t3, occ3, ovf3 = jdist.distributed_join(t2, t_supp, [1, 8], [0, 1], jm, "inner",
                                                left_occupied=occ2, shuffle_capacity=256)
        s_nat = t3.columns[10].data
        asia = jnp.isin(s_nat, jnp.asarray(ASIA_NATIONS))
        revenue = Column(FLOAT64, t3.columns[2].data * (1.0 - t3.columns[3].data))
        t3r = Table(list(t3.columns) + [revenue])
        res, occ, ovf4 = jdist.distributed_group_by(t3r, [10], [JAgg("sum", 11), JAgg("count")],
                                                    jm, occupied=occ3 & asia)
        return res, occ, ovf1 + ovf2 + ovf3 + ovf4

    res, occ, ovf = jax.jit(run)(table(orders, [INT64, INT64, DATE32]), table(cust, [INT64, INT64]),
                                 table(li, [INT64, INT64, FLOAT64, FLOAT64]),
                                 table(supp, [INT64, INT64]))
    return jdist.collect_group_by(res, occ, ovf)


def test_q5_distributed_chain_matches_jax():
    cust, orders, li, supp = _data(13)
    got = _port_chain(cust, orders, li, supp)
    want = _jax_chain(cust, orders, li, supp)
    from spark_rapids_jni_tpu_torch.columnar.interop import table_to_numpy

    for g, w in zip(table_to_numpy(got), numpy_form(want)):
        assert g["dtype"] == w["dtype"]
        np.testing.assert_array_equal(g["data"], w["data"])
    rows = dict(zip(got.columns[0].to_pylist(), got.columns[1].to_pylist()))
    oracle = {int(k): v for k, v in _oracle(cust, orders, li, supp).items()}
    assert set(rows) == set(oracle)
    for k, v in oracle.items():
        assert abs(rows[k] - v) <= 1e-6 * max(1.0, abs(v))
