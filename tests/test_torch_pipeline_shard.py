"""The sharded stream (``Pipeline.stream(shard=...)``) on 8 CPU shards:
value-identical to the unsharded stream (the q1 chain, the q5 join chain
under both build placements), held to the JAX package's sharded stream
on its 8 virtual devices with tolerance 0, sync-free in its fused form,
and with the JAX package's validation: from_json / to_rows are refused
by name and ``("devices", n)`` past the device count raises."""

import os
import sys

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.api import Pipeline as JPipeline
from spark_rapids_jni_tpu.columnar import dtypes as jdt
from spark_rapids_jni_tpu.ops.aggregate import Agg as JAgg
from spark_rapids_jni_tpu.runtime.pipeline import PipelineError as JPipelineError

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch.api import Aggregation, Pipeline
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg as PAgg
from spark_rapids_jni_tpu_torch.parallel.mesh import Mesh
from spark_rapids_jni_tpu_torch.runtime import events, metrics
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.runtime import resource

from test_torch_pipeline_sync_free import sharded_dispatch_traffic
from torch_parity import numpy_form, to_port

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

P = 8
MESH = Mesh(["cpu"] * P)


def rows(tbl):
    return [tuple(r) for r in zip(*tbl.to_pylists())]


@pytest.fixture(scope="module")
def q1_tables():
    rng = np.random.default_rng(42)
    return [chip_smoke.q1_table(chip_smoke.q1_batch_arrays(rng, n), "cpu") for n in (3000, 2001)]


@pytest.fixture(scope="module")
def q5():
    d = chip_smoke.q5_data(n_supp=200, n_cust=3000, n_ord=20000)
    t = chip_smoke.q5_tables(d, "cpu", batch=1 << 13)
    return t, chip_smoke.q5_build(t)


def q5_pipe(name, t, built, bcast):
    return (Pipeline(name)
            .join(built["build"], [0], [0], "inner", right_string_widths={2: 16}, broadcast=bcast)
            .join(t["supplier"], [1, 5], [0, 1], "inner", left_string_widths={6: 16},
                  broadcast=bcast)
            .map(chip_smoke.q5_revenue, name="q5_revenue")
            .group_by([6], [Aggregation.Agg("sum", 9)], capacity=32, string_widths={6: 16}))


def test_q1_sharded_stream_equals_unsharded(q1_tables):
    pipe = chip_smoke.q1_pipeline("shard_q1")
    plain = pipe.stream(q1_tables, window=2)
    sharded = pipe.stream(q1_tables, window=2, shard=MESH)
    for a, b in zip(plain, sharded):
        assert sorted(rows(a)) == sorted(rows(b))
    assert metrics.gauge("pipeline.shard_devices").value == P
    retire = [e for e in events.of_kind("stream_retire") if e["op"] == "Pipeline.shard_q1"]
    assert retire[-1]["attrs"]["shard_devices"] == P
    assert metrics.gauge("device.0.occupied_slots").value >= 0


@pytest.mark.parametrize("bcast", [True, False], ids=["broadcast", "co-partitioned"])
def test_q5_sharded_stream_equals_unsharded(q5, bcast):
    t, built = q5
    pipe = q5_pipe(f"shard_q5_{bcast}", t, built, bcast)
    chunks = t["lineitem"][:2]
    with resource.task():
        plain = pipe.stream(chunks, window=2)
        sharded = pipe.stream(chunks, window=2, shard=MESH)
    for a, b in zip(plain, sharded):
        assert sorted(rows(a)) == sorted(rows(b)) and len(rows(a)) > 0
    plans = [r for r in pl.plan_cache_table() if r["pipeline"] == f"shard_q5_{bcast}"]
    assert {r["shard"] is None for r in plans} == {True, False}
    sharded_plan = next(r["plan"] for r in plans if r["shard"] is not None)
    assert sharded_plan["0.bcast"] == int(bcast) and sharded_plan["1.bcast"] == int(bcast)


def _jax_chunks():
    rng = np.random.default_rng(7)
    out = []
    for n in (45, 45):  # one shape (one JAX compile per placement), padded to 8 shards
        out.append(JTable([
            JColumn.from_numpy(rng.integers(0, 6, n).astype(np.int32), jdt.INT32),
            JColumn.from_pylist([int(x) if x % 7 else None for x in rng.integers(0, 100, n)],
                                jdt.INT64),
            JColumn.from_numpy(rng.normal(size=n), jdt.FLOAT64),
        ]))
    return out


def _build_side():
    return JTable([JColumn.from_numpy(np.arange(6, dtype=np.int32), jdt.INT32),
                   JColumn.from_numpy(np.arange(6, dtype=np.int64) * 10, jdt.INT64)])


def _chain(P_, A, side, bcast):
    return (P_("jx_shard").filter(lambda tb: tb.columns[1].data >= 10)
            .join(side, [0], [0], "inner", capacity=64, broadcast=bcast)
            .group_by([0], [A("sum", 1), A("count"), A("max", 2), A("sum", 4)], capacity=8,
                      wire_widths={0: 8}))


def test_sharded_stream_matches_jax():
    """The JAX package's sharded stream and the port's over the same
    chunks, the join co-partitioned through the exchange: the same
    groups in the same order (hash placement, then key order per shard),
    exactly. (The broadcast lowering differs only in placing the build
    side; it is held to the unsharded stream above.)"""
    bcast = False
    chunks = _jax_chunks()
    side = _build_side()
    want = _chain(JPipeline, JAgg, side, bcast).stream(chunks, window=2, shard=("devices", P))
    got = _chain(Pipeline, PAgg, to_port(side), bcast).stream([to_port(c) for c in chunks],
                                                               window=2, shard=MESH)
    for w, g in zip(want, got):
        wf, gf = numpy_form(w), interop.table_to_numpy(g)
        assert [c["dtype"] for c in wf] == [c["dtype"] for c in gf]
        for wc, gc in zip(wf, gf):
            np.testing.assert_array_equal(gc["data"], wc["data"])
            if wc["validity"] is not None or gc["validity"] is not None:
                wv = np.ones(len(wc["data"]), bool) if wc["validity"] is None else wc["validity"]
                gv = np.ones(len(gc["data"]), bool) if gc["validity"] is None else gc["validity"]
                np.testing.assert_array_equal(gv, wv)


def test_incompatible_stages_are_named():
    t = port.Table([port.Column.from_pylist(['{"a": 1}'], port.STRING, device="cpu")])
    for pipe, name in ((Pipeline("fj").from_json(0), "from_json"),
                       (Pipeline("tr").to_rows(), "to_rows")):
        with pytest.raises(pl.PipelineError, match=name):
            pipe.stream([t], shard=MESH)
        jpipe = JPipeline("jx").from_json(0) if name == "from_json" else JPipeline("jx").to_rows()
        with pytest.raises(JPipelineError, match=name):
            jpipe.stream([], shard=("devices", 2))


def test_device_count_bound_like_jax():
    """``("devices", n)`` resolves over the real devices and raises past
    the count, as the JAX package does over its devices; one shard runs
    unsharded; a malformed request raises ValueError on both."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    pipe = Pipeline("dev").filter(lambda tb: tb.columns[0].data > 0)
    with pytest.raises(ValueError, match=f"only {have} device"):
        pipe.stream([], shard=("devices", max(have + 1, 2)))
    with pytest.raises(ValueError, match="only 8 device"):
        JPipeline("jdev").stream([], shard=("devices", 9))
    for bad in (("devices",), 3):
        for p in (pipe, JPipeline("jbad")):
            with pytest.raises(ValueError, match="expected an"):
                p.stream([], shard=bad)
    assert pipe._resolve_shard(("devices", 1)) is None
    assert pipe._resolve_shard(Mesh(["cpu"])) is None
    assert pipe._resolve_shard(MESH).n_dev == P


def test_broadcast_true_rejected_for_outer_joins():
    side = port.Table([port.Column.from_pylist([1], port.INT32, device="cpu")])
    pipe = Pipeline("bc").join(side, [0], [0], "full", broadcast=True)
    with pytest.raises(pl.PipelineError, match="broadcast=True cannot run"):
        pipe.stream([side], shard=MESH)


@pytest.mark.parametrize("bcast", [True, False], ids=["broadcast", "co-partitioned"])
def test_sharded_q5_chain_is_sync_free(q5, bcast):
    t, built = q5
    assert sharded_dispatch_traffic(q5_pipe(f"shard_sf_q5_{bcast}", t, built, bcast),
                                    t["lineitem"][0], MESH) == {}


def test_sharded_feedback_and_wire_replan():
    """Under the capacity-feedback knob the sharded stream keeps its own
    observations (the ``|shard:`` suffix); a wire pin that does not
    round-trip re-plans to full width, stays dropped for the next chunk,
    and the result is exact."""
    rng = np.random.default_rng(3)
    chunks = [port.Table([port.Column.from_numpy(rng.integers(0, 1000, 256), port.INT64,
                                                 device="cpu"),
                          port.Column.from_numpy(rng.integers(0, 9, 256), port.INT64,
                                                 device="cpu")]) for _ in range(2)]
    pipe = Pipeline("shard_fb").group_by([0], [PAgg("sum", 1)], capacity=64,
                                         wire_widths={0: 8})
    pl.set_capacity_feedback(True)
    try:
        with resource.task() as task:
            got = pipe.stream(chunks, window=1, shard=MESH)
            assert task.metrics.final_plans["pipeline.shard_fb"]["0.wire"] is None
            want = pipe.stream(chunks, window=1)
        doc = pipe.explain("json", shard=MESH)
    finally:
        pl.set_capacity_feedback(None)
    for a, b in zip(got, want):
        assert sorted(rows(a)) == sorted(rows(b))
    assert doc["shard"] == {"axis": "data", "devices": P, "broadcast": {}}
    assert doc["feedback"]["knobs"]["0.wire"]["bucket"] is None
    assert doc["plan"]["0.wire"] is None
    assert "shard: axis=data devices=8" in pipe.explain(shard=MESH)


def test_sharded_stream_over_distinct_devices(q5):
    """A mesh whose shards sit on different devices (the multi-card
    layout: the chunk's blocks move to their devices, the exchange
    copies between them; on the CPU "cpu" and "cpu:0" are distinct
    devices) gives the one-device mesh's results."""
    t, built = q5
    mixed = Mesh(["cpu", "cpu:0"] * (P // 2))
    assert mixed.shared_device is None
    pipe = q5_pipe("shard_mixed", t, built, False)
    chunks = t["lineitem"][:1]
    with resource.task():
        a = pipe.stream(chunks, shard=mixed)
        b = pipe.stream(chunks, shard=MESH)
    assert rows(a[0]) == rows(b[0]) and len(rows(a[0])) > 0
