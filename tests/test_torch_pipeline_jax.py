"""The port's fused Pipeline against the JAX package's ``Pipeline`` on
the same seeded chunks: a subset of the equivalence matrix (each JAX
chain compiles one XLA program per shape, so the chains are few and the
tables small), the stream, and the plan-key folding of a ``map``
stage's Python function (code, globals, defaults, closures; tensors and
arrays by content)."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.api import Pipeline as JPipeline
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops.aggregate import Agg as JAgg

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch.api import Pipeline as PPipeline
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg as PAgg
from spark_rapids_jni_tpu_torch.runtime import metrics
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl

from torch_parity import assert_same_result as assert_same
from torch_parity import to_port


def mixed(n=48, seed=0):
    rng = np.random.default_rng(seed)
    return JTable([
        JColumn.from_numpy(rng.integers(0, 5, n).astype(np.int32), jd.INT32),
        JColumn.from_pylist([int(x) if x % 7 else None for x in rng.integers(0, 100, n)], jd.INT64),
        JColumn.from_numpy(rng.normal(size=n), jd.FLOAT64),
        JColumn.from_pylist([str(int(x)) if x % 5 else f"  {int(x)} "
                             for x in rng.integers(0, 10_000, n)], jd.STRING),
        JColumn.from_pylist([int(x) - 500 for x in rng.integers(0, 1000, n)],
                            jd.DECIMAL128(12, 2)),
    ])


def both_chains(build):
    return build(JPipeline, JAgg), build(PPipeline, PAgg)


def test_filter_cast_group_by_matches_jax():
    def build(P, A):
        return (P("x1").filter(lambda tb: tb.columns[0].data >= 2)
                .cast_to_integer(3, jd.INT32 if P is JPipeline else port.INT32, width=16)
                .group_by([0], [A("sum", 1), A("count", 3), A("min", 2), A("max", 3),
                                A("mean", 4)], capacity=16))

    jp, pp = both_chains(build)
    t = mixed()
    assert_same(jp.run(t), pp.run(to_port(t)))


def test_join_group_by_stream_matches_jax():
    right = JTable([JColumn.from_pylist([0, 1, 2, 3, 2], jd.INT32),
                    JColumn.from_pylist([100, 200, 300, None, 500], jd.INT64)])

    def build(P, A):
        r = right if P is JPipeline else to_port(right)
        return (P("x2").filter(lambda tb: tb.columns[0].data != 4)
                .join(r, [0], [0], "inner", capacity=128, left_string_widths={3: 8})
                .group_by([0], [A("sum", 6), A("count", 1), A("sum", 4)], capacity=8))

    jp, pp = both_chains(build)
    chunks = [mixed(48, seed=s) for s in (1, 2, 3)]
    want = jp.stream(chunks, window=2)
    got = pp.stream([to_port(c) for c in chunks], window=2)
    for j, p in zip(want, got):
        assert_same(j, p)


def test_json_cast_float_matches_jax():
    docs = ['{"v": "1.5", "c": "web"}', '{"v": "-2.25", "c": "app"}', None,
            '{"v": "37", "c": "web"}', '{"c": "web"}', '{"v": "1e3", "c": "x"}']

    def build(P, A):
        f32 = jd.FLOAT32 if P is JPipeline else port.FLOAT32
        return (P("x3").get_json_object(0, "$.c", width=32, out="append")
                .get_json_object(0, "$.v", width=32).cast_to_float(0, f32, width=16))

    jp, pp = both_chains(build)
    t = JTable([JColumn.from_pylist(docs, jd.STRING)])
    assert_same(jp.run(t), pp.run(to_port(t)))


def test_signatures_and_explain_stages_match_jax():
    def build(P, A):
        return (P("x4").filter(lambda tb: tb.columns[0].data >= 2)
                .cast_to_decimal(3, 9, 2, width=16).rlike(3, "a+b", width=8)
                .group_by([0], [A("count")], capacity=4))

    jp, pp = both_chains(build)
    jdoc, pdoc = jp.explain(fmt="json"), pp.explain(fmt="json")
    assert [s["kind"] for s in pdoc["stages"]] == [s["kind"] for s in jdoc["stages"]]
    assert pdoc["plan"] == jdoc["plan"]
    assert len(pp.signature_hash()) == len(jp.signature_hash()) == 12


# ---------------------------------------------------------------------
# the map stage's plan identity

_K = 1
_LUT = torch.tensor([0, 1, 2], dtype=torch.int32)


def _pred_const(tb):
    return tb.columns[0].data >= _K


def _pred_lut(tb):
    return tb.columns[0].data >= _LUT[1]


def _pred_default(tb, k=2):
    return tb.columns[0].data >= k


def _table():
    return port.Table([port.Column.from_pylist([0, 1, 2, 3], port.INT32, device="cpu")])


def _misses():
    return metrics.counter_value("pipeline.plan_cache_miss")


@pytest.fixture(autouse=True)
def _mem_metrics():
    prev = metrics.configure("mem")
    metrics.reset()
    pl.plan_cache_clear()
    yield
    metrics.configure(prev)


def test_rebuilt_chain_reuses_plan_and_rebinding_replans():
    global _K
    m0 = _misses()
    PPipeline("m").filter(_pred_const).run(_table())
    PPipeline("m").filter(_pred_const).run(_table())  # structural reuse
    assert _misses() == m0 + 1
    old = _K
    try:
        _K = 2
        assert PPipeline("m").filter(_pred_const).run(_table()).num_rows == 2
        assert _misses() == m0 + 2
    finally:
        _K = old


def test_tensor_global_folds_by_content_and_mutation_replans():
    m0 = _misses()
    PPipeline("lut").filter(_pred_lut).run(_table())
    PPipeline("lut").filter(_pred_lut).run(_table())
    assert _misses() == m0 + 1
    _LUT[1] = 3  # in place: the version counter moves, the hash re-reads
    try:
        assert PPipeline("lut").filter(_pred_lut).run(_table()).num_rows == 1
        assert _misses() == m0 + 2
    finally:
        _LUT[1] = 1


def test_defaults_fold_and_closures_token():
    m0 = _misses()
    PPipeline("d").filter(_pred_default).run(_table())
    PPipeline("d").filter(_pred_default).run(_table())
    assert _misses() == m0 + 1
    k = 1
    closure = PPipeline("c").filter(lambda tb: tb.columns[0].data >= k)
    closure.run(_table())
    closure.run(_table())  # the same object reuses its token
    PPipeline("c").filter(lambda tb: tb.columns[0].data >= k).run(_table())
    assert _misses() == m0 + 3


def test_content_hash_is_stable_and_sensitive():
    a = torch.arange(10, dtype=torch.int64)
    b = torch.arange(10, dtype=torch.int64)
    assert pl._array_content_hash(a) == pl._array_content_hash(b)
    b[3] = -1
    assert pl._array_content_hash(a) != pl._array_content_hash(b)
    assert pl._array_content_hash(np.arange(4)) == pl._array_content_hash(np.arange(4))
