"""The port's fused Pipeline (``runtime/pipeline.py``) against the port's
own eager façade chain: the ``docs/PIPELINE.md`` equivalence matrix
(casts, decimal arithmetic, JSON extraction, regex, joins, string / int
/ float / decimal group keys with genuine null keys next to filtered
rows, from_json, to_rows). Results must be equal exactly: data, offsets
and validity (a missing mask equals an all-true one).

Also: the plan cache (one miss per chain and shape, hits after), the
``stream`` window (no added miss, results equal to ``run_chunks``), and
the argument checks."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch import DECIMAL128, FLOAT32, FLOAT64, INT32, INT64, STRING
from spark_rapids_jni_tpu_torch.api import (
    Aggregation,
    CastStrings,
    DecimalUtils,
    Filter,
    JSONUtils,
    Join,
    MapUtils,
    Pipeline,
    Regex,
    RowConversion,
)
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
from spark_rapids_jni_tpu_torch.runtime import events, metrics, resource
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl


@pytest.fixture(autouse=True)
def telemetry():
    prev = metrics.configure("mem")
    metrics.reset()
    events.clear()
    resource.reset()
    yield metrics
    metrics.reset()
    events.clear()
    resource.reset()
    metrics.configure(prev)


def col(values, dtype):
    return port.Column.from_pylist(values, dtype, device="cpu")


def same_tables(a, b):
    """Exact equality of two port Tables through the numpy interop form:
    data, validity and offsets. A missing validity mask equals an
    all-true one, and the fixed-width data under a null row (undefined
    in Arrow) is not compared."""
    wa, wb = interop.table_to_numpy(a), interop.table_to_numpy(b)
    assert len(wa) == len(wb)
    for i, (x, y) in enumerate(zip(wa, wb)):
        assert x["dtype"] == y["dtype"], i
        n = len(x["offsets"]) - 1 if x["offsets"] is not None else len(x["data"])
        for c in (x, y):
            if c["validity"] is None:
                c["validity"] = np.ones(n, bool)
            if c["offsets"] is None and len(c["validity"]) == len(c["data"]):
                c["data"] = c["data"].copy()
                c["data"][~c["validity"]] = 0
        for key in ("data", "validity", "offsets"):
            if x[key] is None or y[key] is None:
                assert x[key] is None and y[key] is None, (i, key)
                continue
            np.testing.assert_array_equal(x[key], y[key], err_msg=f"col {i} {key}")


def mixed_table(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return port.Table([
        port.Column.from_numpy(rng.integers(0, 5, n).astype(np.int32), INT32, device="cpu"),
        col([int(x) if x % 7 else None for x in rng.integers(0, 100, n)], INT64),
        port.Column.from_numpy(rng.normal(size=n), FLOAT64, device="cpu"),
        col([str(int(x)) if x % 5 else f"  {int(x)} " for x in rng.integers(0, 10_000, n)],
            STRING),
        col([int(x) - 500 for x in rng.integers(0, 1000, n)], DECIMAL128(12, 2)),
    ])


# ---------------------------------------------------------------------
# the equivalence matrix


def test_equiv_filter_cast_group_by():
    t = mixed_table()
    aggs = [Agg("sum", 1), Agg("count", 3), Agg("min", 2), Agg("max", 3)]
    p = (Pipeline("eq1").filter(lambda tb: tb.columns[0].data >= 2)
         .cast_to_integer(3, INT32, width=16).group_by([0], aggs, capacity=16))
    ft = Filter.apply(t, t.columns[0].data >= 2)
    cast = CastStrings.toInteger(ft.columns[3], False, True, INT32)
    ref = Aggregation.groupBy(port.Table(list(ft.columns[:3]) + [cast] + list(ft.columns[4:])),
                              [0], aggs)
    same_tables(p.run(t), ref)


def test_equiv_decimal_chain():
    t = mixed_table(48, seed=3)
    p = (Pipeline("eqdec").multiply128(4, 4, 4).add128(4, 4, 2)
         .filter(lambda tb: tb.columns[0].data != 1)
         .group_by([0], [Agg("sum", 6), Agg("count", 8), Agg("mean", 6)], capacity=8))
    mul = DecimalUtils.multiply128(t.columns[4], t.columns[4], 4)
    add = DecimalUtils.add128(t.columns[4], t.columns[4], 2)
    work = port.Table(list(t.columns) + list(mul.columns) + list(add.columns))
    ft = Filter.apply(work, work.columns[0].data != 1)
    ref = Aggregation.groupBy(ft, [0], [Agg("sum", 6), Agg("count", 8), Agg("mean", 6)])
    same_tables(p.run(t), ref)


def test_equiv_string_keys_null_keys_next_to_filtered_rows():
    keys = ["aa", None, "b", "aa", None, "ccc", "b", "aa", None, "é"]
    live = [1, 1, 0, 1, 1, 1, 1, 0, 0, 1]
    vals = [1.5, 2.0, 3.25, 4.0, 5.5, 6.0, 7.75, 8.0, 9.0, -1.0]
    t = port.Table([col(keys, STRING), col(vals, FLOAT64), col(live, INT32)])
    aggs = [Agg("sum", 1), Agg("mean", 1), Agg("count", 0), Agg("min", 0), Agg("max", 0)]
    p = (Pipeline("eqsk").filter(lambda tb: tb.columns[2].data == 1)
         .group_by([0], aggs, capacity=8, string_widths={0: 8}))
    ft = Filter.apply(t, t.columns[2].data == 1)
    ref = Aggregation.groupBy(port.Table(ft.columns[:2]), [0], aggs)
    same_tables(p.run(t), ref)


@pytest.mark.parametrize("key_kind", ["int", "float", "decimal"])
def test_equiv_group_keys_with_nulls(key_kind):
    rng = np.random.default_rng(7)
    n = 50
    raw = rng.integers(0, 4, n)
    if key_kind == "int":
        key = col([int(x) if x else None for x in raw], INT64)
    elif key_kind == "float":
        key = col([[None, -0.0, 0.0, float("nan")][x] for x in raw], FLOAT64)
    else:
        key = col([int(x) * 10**20 if x else None for x in raw], DECIMAL128(38, 0))
    t = port.Table([key, port.Column.from_numpy(rng.integers(-9, 9, n), INT64, device="cpu"),
                    port.Column.from_numpy(rng.integers(0, 2, n).astype(np.int32), INT32,
                                           device="cpu")])
    p = (Pipeline(f"eqk{key_kind}").filter(lambda tb: tb.columns[2].data == 1)
         .group_by([0], [Agg("sum", 1), Agg("count")], capacity=8))
    ft = Filter.apply(t, t.columns[2].data == 1)
    same_tables(p.run(t), Aggregation.groupBy(ft, [0], [Agg("sum", 1), Agg("count")]))


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "full"])
def test_equiv_join_chain(how):
    left = mixed_table(40, seed=5)
    right = port.Table([col([0, 1, 2, 3, 2, None], INT32), col([100, 200, 300, 400, 500, 9], INT64)])
    p = (Pipeline(f"eqj{how}").filter(lambda tb: tb.columns[0].data != 4)
         .join(right, [0], [0], how, capacity=128, left_string_widths={3: 8}))
    ft = Filter.apply(left, left.columns[0].data != 4)
    same_tables(p.run(left), Join.join(ft, right, [0], [0], how))


def test_equiv_join_then_group_by():
    left = mixed_table(40, seed=6)
    right = port.Table([col([0, 1, 2, 3, 2], INT32), col([100, 200, 300, 400, 500], INT64)])
    p = (Pipeline("eqjg").filter(lambda tb: tb.columns[0].data != 4)
         .join(right, [0], [0], "inner", capacity=128, left_string_widths={3: 8})
         .group_by([0], [Agg("sum", 6), Agg("count", 1)], capacity=8))
    ft = Filter.apply(left, left.columns[0].data != 4)
    j = Join.join(ft, right, [0], [0], "inner")
    same_tables(p.run(left), Aggregation.groupBy(j, [0], [Agg("sum", 6), Agg("count", 1)]))


def test_equiv_json_cast_float():
    docs = ['{"v": "1.5", "c": "web"}', '{"v": "-2.25", "c": "app"}', None,
            '{"v": "37", "c": "web"}', '{"c": "web"}']
    t = port.Table([col(docs, STRING)])
    p = (Pipeline("eqjson").get_json_object(0, "$.c", width=32, out="append")
         .get_json_object(0, "$.v", width=32).cast_to_float(0, FLOAT32, width=16))
    c = JSONUtils.getJsonObject(t.columns[0], "$.c")
    v = CastStrings.toFloat(JSONUtils.getJsonObject(t.columns[0], "$.v"), False, FLOAT32)
    same_tables(p.run(t), port.Table([v, c]))


def test_equiv_cast_decimal_and_filter():
    t = port.Table([col(["1.25", " 7 ", "x", None, "-3.5", "12.345"], STRING),
                    col([1, 0, 1, 1, 1, 1], INT32)])
    p = (Pipeline("eqcd").cast_to_decimal(0, 9, 2, width=8)
         .filter(lambda tb: tb.columns[1].data == 1))
    cast = CastStrings.toDecimal(t.columns[0], False, True, 9, 2)
    work = port.Table([cast, t.columns[1]])
    same_tables(p.run(t), Filter.apply(work, work.columns[1].data == 1))


def test_equiv_regex_stages():
    subj = ["id=12;host=h1.example.com", "bad 3", None, "id=7;host=h9.example.com", ""]
    t = port.Table([col(subj, STRING), col(subj, STRING)])
    p = (Pipeline("eqre").rlike(0, r"id=\d+", width=32)
         .regexp_extract(1, r"id=(\d+);host=([\w.]+)", 2, width=32))
    want = port.Table([Regex.rlike(t.columns[0], r"id=\d+"),
                       Regex.regexpExtract(t.columns[1], r"id=(\d+);host=([\w.]+)", 2)])
    same_tables(p.run(t), want)


def test_equiv_select_and_map():
    t = mixed_table(20, seed=9)
    p = (Pipeline("eqsel").select([4, 0])
         .map(lambda tb: port.Table([tb.columns[1], tb.columns[0]]), name="swap"))
    same_tables(p.run(t), port.Table([t.columns[0], t.columns[4]]))


def test_equiv_from_json_terminal():
    docs = ['{"a": 1, "b": "x"}', None, '{"k": [1, 2], "z": null}', "{}", '{"long": "valuevalue"}']
    t = port.Table([col(docs, STRING)])
    got = Pipeline("eqfj").from_json(0, width=32, key_width=8, value_width=16).run(t)
    assert got.to_pylist() == MapUtils.extractRawMapFromJsonString(t.columns[0]).to_pylist()


def test_equiv_to_rows():
    t = port.Table([col([1, 2, None, 4], INT32), col([7.5, None, 9.25, 1.0], FLOAT64)])
    got = Pipeline("eqrc").to_rows().run(t)
    ref = RowConversion.convertToRows(t)
    assert len(ref) == 1
    np.testing.assert_array_equal(got.columns[0].data.numpy(), ref[0].data.numpy())
    np.testing.assert_array_equal(got.columns[0].offsets.numpy(), ref[0].offsets.numpy())


def test_stage_order_errors():
    t = port.Table([col([1, 2], INT32)])
    with pytest.raises(pl.PipelineError, match="to_rows"):
        Pipeline("bad").filter(lambda tb: tb.columns[0].data > 1).to_rows().run(t)
    docs = port.Table([col(['{"a": 1}'], STRING)])
    with pytest.raises(pl.PipelineError, match="terminal"):
        Pipeline("bad2").from_json(0).select([0]).run(docs)
    with pytest.raises(pl.PipelineError, match="pinned width"):
        Pipeline("bad3").group_by([0], [Agg("count")]).run(port.Table([col(["a"], STRING)]))
    with pytest.raises(ValueError, match="out="):
        Pipeline("bad4").cast_to_integer(0, INT32, out="x")


# ---------------------------------------------------------------------
# plan cache and the stream window


def _stream_pipeline(name):
    return (Pipeline(name).filter(lambda tb: tb.columns[0].data >= 1)
            .group_by([0], [Agg("sum", 1), Agg("count", 1)], capacity=8))


def test_plan_cache_one_miss_per_chain_and_shape():
    t = mixed_table(32, seed=7)
    p = _stream_pipeline("pc")
    m0 = metrics.counter_value("pipeline.plan_cache_miss")
    r1 = p.run(t)
    assert metrics.counter_value("pipeline.plan_cache_miss") == m0 + 1
    h0 = metrics.counter_value("pipeline.plan_cache_hit")
    for _ in range(3):
        same_tables(p.run(mixed_table(32, seed=7)), r1)
    assert metrics.counter_value("pipeline.plan_cache_hit") == h0 + 3
    assert metrics.counter_value("pipeline.plan_cache_miss") == m0 + 1
    p.run(mixed_table(16, seed=7))  # a new shape is a new entry
    assert metrics.counter_value("pipeline.plan_cache_miss") == m0 + 2
    hits = events.of_kind("plan_cache_hit")
    assert all(e["attrs"]["plan"] == p.signature_hash() for e in hits)
    for e in events.of_kind("plan_cache_miss"):
        metrics.validate_line(e)
    row = [r for r in pl.plan_cache_table() if r["pipeline"] == "pc"]
    assert len(row) == 2 and row[0]["hits"] == 3 and row[0]["form"] == "eager"


def test_stream_window2_adds_no_miss_and_equals_run_chunks():
    chunks = [mixed_table(64, seed=100 + i) for i in range(5)]
    p = _stream_pipeline("st1")
    serial = p.run_chunks(chunks)
    m0 = metrics.counter_value("pipeline.plan_cache_miss")
    h0 = metrics.counter_value("pipeline.plan_cache_hit")
    streamed = p.stream(chunks, window=2)
    assert metrics.counter_value("pipeline.plan_cache_miss") == m0
    assert metrics.counter_value("pipeline.plan_cache_hit") == h0 + len(chunks)
    for a, b in zip(serial, streamed):
        same_tables(a, b)
    rets = events.of_kind("stream_retire")
    assert [e["attrs"]["chunk"] for e in rets[-5:]] == [0, 1, 2, 3, 4]
    assert metrics.gauge_value("pipeline.stream_window") == 2


def test_stream_collect_false_returns_padded_pairs():
    chunks = [mixed_table(32, seed=1), mixed_table(32, seed=2)]
    p = _stream_pipeline("stp")
    out = p.stream(chunks, window=2, collect=False)
    for (tbl, live), ref in zip(out, p.run_chunks(chunks)):
        assert tbl.num_rows == 9 and live.dtype == torch.bool
        assert int(live.sum()) == ref.num_rows


def test_argument_checks():
    chunks = [mixed_table(16, seed=1)]
    p = _stream_pipeline("args")
    with resource.task():
        with pytest.raises(pl.PipelineError, match="donate"):
            p.stream(chunks, window=2, donate=True)
        with pytest.raises(pl.PipelineError, match="donate"):
            p.run(chunks[0], donate=True)
    with pytest.raises(ValueError, match="window"):
        p.stream(chunks, window=0)
    # ("devices", n) resolves over the CUDA devices: none here, one on
    # the card's machine, so four shards raise as in the JAX package
    with pytest.raises(ValueError, match=r"only \d+ device\(s\) available"):
        p.stream(chunks, shard=("devices", 4))
    same_tables(p.stream(chunks, shard=("devices", 1))[0], p.run(chunks[0]))
    same_tables(p.run(mixed_table(16, seed=1), donate=True), p.run(chunks[0]))
    with pytest.raises(pl.PipelineError, match="analyze"):
        p.run(chunks[0], donate=True, analyze=True)


def test_pad_string_payloads():
    t = port.Table([col(["ab", None, "cde"], STRING), col([1, 2, 3], INT32)])
    padded = pl.pad_string_payloads(t, {0: 4})
    assert padded.columns[0].data.shape[0] == 12
    assert padded.columns[0].to_pylist() == ["ab", None, "cde"]
    with pytest.raises(ValueError, match="cap"):
        pl.pad_string_payloads(t, {0: 1})
    with pytest.raises(TypeError):
        pl.pad_string_payloads(t, {1: 4})


@pytest.mark.parametrize("how", ["inner", "left"])
def test_same_chain_over_other_build_tables_reuses_the_plan(how):
    """Two pipelines with one join chain and same-shaped but different
    build tables share one plan-cache entry, and each result is its own
    eager chain's: the build tables are inputs of the program, not part
    of it."""
    left = mixed_table(40, seed=8)
    rights = [port.Table([col([0, 1, 2, 3, 2, None], INT32), col([100, 200, 300, 400, 500, 9], INT64)]),
              port.Table([col([4, 3, None, 1, 1, 0], INT32), col([7, 8, 9, 10, 11, 12], INT64)])]
    m0 = metrics.counter_value("pipeline.plan_cache_miss")
    h0 = metrics.counter_value("pipeline.plan_cache_hit")
    for right in rights:
        p = (Pipeline(f"sides_{how}").filter(lambda tb: tb.columns[0].data != 2)
             .join(right, [0], [0], how, capacity=128, left_string_widths={3: 8}))
        ft = Filter.apply(left, left.columns[0].data != 2)
        same_tables(p.run(left), Join.join(ft, right, [0], [0], how))
    assert metrics.counter_value("pipeline.plan_cache_miss") == m0 + 1
    assert metrics.counter_value("pipeline.plan_cache_hit") == h0 + 1


def test_program_form_follows_the_device():
    """The CPU runs the whole chain and ANALYZE's per-stage slices
    eagerly (a card runs the whole chain as a CUDA graph)."""
    t = mixed_table(24, seed=9)
    p = _stream_pipeline("form_cpu")
    p.run(t)
    p.run(t, analyze=True)
    rows = [r for r in pl.plan_cache_table() if r["pipeline"] == "form_cpu"]
    assert len(rows) == 3 and {r["form"] for r in rows} == {"eager"}


def test_concurrent_threads_share_one_pipeline():
    """Threads running one Pipeline at once each get their own chunk's
    result: the plan cache and its programs hold no per-call state."""
    import threading

    p = _stream_pipeline("threads")
    chunks = [mixed_table(48, seed=200 + i) for i in range(8)]
    want = [p.run(c) for c in chunks]
    got: dict = {}

    def work(k):
        for _ in range(3):
            for i in range(k, len(chunks), 2):
                got.setdefault(i, []).append(p.run(chunks[i]))

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert sorted(got) == list(range(len(chunks)))
    for i, outs in got.items():
        assert len(outs) == 3
        for out in outs:
            same_tables(out, want[i])


def test_flatten_round_trip_frees_its_leaves_without_a_collection():
    """A tree taken apart by ``_flatten`` and rebuilt by ``_unflatten``
    over new leaves (as a graph's output clones are) holds its tensors
    only through its own references: with the cyclic collector off, the
    leaves go as soon as the tree does. A stream's retired chunks thus
    leave the card at retirement, as admission prices them."""
    import gc
    import weakref

    t = mixed_table(16, seed=7)
    leaves, spec = pl._flatten((t, [t.columns[0].data], {"k": t.columns[1].data}))
    clones = [x.clone() for x in leaves]
    refs = [weakref.ref(x) for x in clones]
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        tree = pl._unflatten(spec, clones)
        del clones
        same_tables(tree[0], t)
        assert torch.equal(tree[1][0], t.columns[0].data)
        assert tree[2]["k"] is refs[-1]()
        assert all(r() is not None for r in refs)
        del tree
        assert [r() is None for r in refs] == [True] * len(refs)
        del leaves
    finally:
        if was_enabled:
            gc.enable()
