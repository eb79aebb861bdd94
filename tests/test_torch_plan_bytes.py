"""The CUDA-graph plan cache's byte bound and admission's charge for a
capture, on the CPU. No graph exists here, so a stub program stands in
for ``pipeline._GraphProgram``: it runs the chain eagerly and reports
static bytes and a pool's reserved bytes the way a capture measures
them."""

import threading
import weakref

import numpy as np
import pytest

from spark_rapids_jni_tpu_torch import FLOAT64, INT32, Column, Table
from spark_rapids_jni_tpu_torch.api import Pipeline
from spark_rapids_jni_tpu_torch.runtime import events, metrics, resource
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.serving.admission import AdmissionController
from spark_rapids_jni_tpu_torch.serving.server import Job, Server


def _table(n, seed=0):
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(rng.integers(0, 5, n).astype(np.int32), INT32, device="cpu"),
        Column.from_numpy(rng.normal(size=n), FLOAT64, device="cpu"),
    ])


def _pipe(name="pb"):
    return Pipeline(name).filter(lambda tb: tb.columns[0].data >= 1)


def _static(n):
    return pl._tensor_bytes(pl._flatten((_table(n), ()))[0])


class _Stub(pl._EagerProgram):
    """A graph program's accounting without a card: the pool grows by
    ``growth`` bytes a row at each capture."""

    form = "graph"
    growth = 0
    out = 0

    def __init__(self, fn, where, labels, chunk, sides, graph_bytes=None):
        super().__init__(fn)
        self.device = "cpu"
        got = pl._graph_pools.setdefault("cpu", [None, None, None, weakref.WeakSet(), 0])
        if got[0] is None:
            got[0] = object()
        grow = self.growth * chunk.num_rows
        got[4] += grow
        self.pool_bytes = got[4]
        self.static_bytes = pl._tensor_bytes(pl._flatten((chunk, sides))[0])
        self.out_bytes = self.out
        self.graph_bytes = self.static_bytes + grow if graph_bytes is None else graph_bytes


@pytest.fixture
def graphs(monkeypatch):
    """Graph form on the CPU with a stub program; yields the bound dict."""
    prev = metrics.configure("mem")
    metrics.reset()
    events.clear()
    resource.reset()
    pl.plan_cache_clear()
    bound = {"cpu": 1 << 40}
    monkeypatch.setattr(pl, "_captures", lambda dev: True)
    monkeypatch.setattr(pl, "_graph_bound", lambda dev: bound[str(dev)])
    monkeypatch.setattr(pl, "_graph_bounds", bound)
    monkeypatch.setattr(pl, "_graph_pools", {})
    monkeypatch.setattr(pl, "_graph_bytes_seen", {})
    monkeypatch.setattr(pl, "_GraphProgram", _Stub)
    monkeypatch.setattr(pl, "_graph_entry", lambda dev: [None, None, threading.RLock()])
    monkeypatch.setattr(_Stub, "growth", 0)
    monkeypatch.setattr(_Stub, "out", 0)
    yield bound
    pl.plan_cache_clear()
    metrics.reset()
    events.clear()
    resource.reset()
    metrics.configure(prev)


def _evicts():
    return [e["attrs"] for e in events.of_kind("plan_cache_evict")
            if e["attrs"]["table"] == "executable"]


# ---- the eviction choice over (key, form, bytes) entries


def test_evictions_follow_lru_order_until_the_need_fits():
    entries = [("a", "graph", 10), ("b", "graph", 10), ("c", "graph", 10)]
    assert pl._graph_evictions(entries, 50, 40, 100) == [("a", 10), ("b", 10)]
    # a kept graph is passed over, and the next coldest goes instead
    assert pl._graph_evictions(entries, 50, 40, 100, {"a"}) == [("b", 10), ("c", 10)]


def test_the_last_graph_takes_the_pool_with_it():
    entries = [("a", "graph", 10), ("b", "graph", 20)]
    assert pl._graph_evictions(entries, 50, 90, 100) == [("a", 10), ("b", 70)]
    # ... but not while a kept graph holds the pool
    assert pl._graph_evictions(entries, 50, 90, 100, {"b"}) == [("a", 10)]


def test_an_eager_entry_never_counts_or_goes():
    entries = [("e", "eager", 1000), ("a", "graph", 10), ("f", "eager", 1000)]
    assert pl._graph_total(entries, 5) == 15
    assert pl._graph_evictions(entries, 5, 0, 14) == [("a", 15)]
    assert pl._graph_evictions([("e", "eager", 1000)], 0, 10**6, 1) == []


def test_nothing_goes_when_the_plan_fits():
    entries = [("a", "graph", 10), ("b", "graph", 10)]
    assert pl._graph_evictions(entries, 30, 50, 100) == []


# ---- the bound on the plan cache, with stub graphs


def test_the_cached_graphs_stay_within_the_bound(graphs):
    _Stub.growth = 100
    graphs["cpu"] = 3 * (_static(70) + 100 * 70)
    p = _pipe()
    for n in range(60, 70):
        p.run(_table(n))
        assert 0 < pl.graph_cache_bytes() <= graphs["cpu"]
    assert _evicts()


def test_an_eviction_event_carries_the_bytes_it_freed(graphs, monkeypatch):
    monkeypatch.setattr(pl, "_GRAPH_PRIOR", 0)  # evict by the measured bytes alone
    graphs["cpu"] = _static(65) + _static(66) + 8
    p = _pipe()
    e0 = metrics.counter_value("pipeline.plan_cache_evict")
    for n in (64, 65, 66):
        p.run(_table(n))
    assert [e["freed_bytes"] for e in _evicts()] == [_static(64)]
    assert metrics.counter_value("pipeline.plan_cache_evict") == e0 + 1
    assert pl.graph_cache_bytes() == _static(65) + _static(66)


def test_a_hit_moves_a_graph_to_the_back_of_the_line(graphs, monkeypatch):
    monkeypatch.setattr(pl, "_GRAPH_PRIOR", 0)
    graphs["cpu"] = _static(64) + _static(66) + _static(67) + 8
    p = _pipe()
    for n in (64, 65, 66, 64, 67):
        p.run(_table(n))
    assert [e["freed_bytes"] for e in _evicts()] == [_static(65)]
    assert pl.graph_cache_bytes() == _static(64) + _static(66) + _static(67)
    h0 = metrics.counter_value("pipeline.plan_cache_hit")
    p.run(_table(64))
    assert metrics.counter_value("pipeline.plan_cache_hit") == h0 + 1


def test_plan_cache_clear_zeroes_the_graph_bytes(graphs):
    _Stub.growth = 10
    p = _pipe()
    for n in (64, 65):
        p.run(_table(n))
    assert pl.graph_cache_bytes() == _static(64) + _static(65) + 10 * (64 + 65)
    pl.plan_cache_clear()
    assert pl.graph_cache_bytes() == 0 and pl._graph_pools["cpu"][0] is None
    assert len(pl._graph_bytes_seen) == 2  # the measurements outlive the plans


def test_a_graph_past_the_bound_alone_runs_uncached(graphs):
    _Stub.growth = 100
    graphs["cpu"] = 100 * 64  # the pool alone outgrows it
    t = _table(64, seed=3)
    got = _pipe().run(t)
    assert pl.plan_cache_size() == 0 and pl.graph_cache_bytes() == 0
    assert [e["freed_bytes"] for e in _evicts()] == [_static(64) + 100 * 64]
    keep = t.columns[0].data.numpy() >= 1
    assert got.columns[0].data.tolist() == t.columns[0].data.numpy()[keep].tolist()
    assert got.columns[1].data.tolist() == t.columns[1].data.numpy()[keep].tolist()


def test_plan_table_rows_carry_graph_bytes(graphs):
    _Stub.growth = 10
    _pipe("rows").run(_table(64))
    (row,) = [r for r in pl.plan_cache_table() if r["pipeline"] == "rows"]
    assert row["form"] == "graph"
    assert row["graph_bytes"] == _static(64) + 640
    assert row["pool_bytes"] == 640 and row["warm_ms"] >= 0 and row["capture_ms"] >= 0
    assert f"form=graph graph_bytes={row['graph_bytes']}" in pl.render_plan_rows([row])


def test_a_recapture_reuses_the_measured_graph_bytes(graphs):
    _Stub.growth = 10
    p = _pipe()
    p.run(_table(64))
    key = next(iter(pl._graph_bytes_seen))
    pl._graph_bytes_seen[key] = (4242, 0)  # as measured at the first capture
    pl.plan_cache_clear()
    p.run(_table(64))
    (row,) = pl.plan_cache_table()
    assert row["graph_bytes"] == 4242 and not row["oom_release"]


def test_a_build_out_of_memory_releases_the_cache_once(graphs, monkeypatch):
    import torch

    released, tries = [], []

    class _Oom(_Stub):
        def __init__(self, *args, **kw):
            tries.append(1)
            if len(tries) == 1:
                raise torch.cuda.OutOfMemoryError("pool allocation")
            super().__init__(*args, **kw)

    monkeypatch.setattr(pl, "_GraphProgram", _Oom)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: released.append(len(tries)))
    _pipe("oom").run(_table(64))
    (row,) = pl.plan_cache_table()
    assert released == [1] and len(tries) == 2 and row["oom_release"]


def test_the_count_cap_still_bounds_eager_entries(graphs, monkeypatch):
    monkeypatch.setattr(pl, "_captures", lambda dev: False)
    monkeypatch.setattr(pl, "_PLAN_CACHE_CAP", 2)
    p = _pipe()
    for n in (64, 65, 66):
        p.run(_table(n))
    assert pl.plan_cache_size() == 2
    assert [e["freed_bytes"] for e in _evicts()] == [0]


def test_graph_bytes_records_are_lru_capped(graphs, monkeypatch):
    monkeypatch.setattr(pl, "_PLAN_FEEDBACK_CAP", 2)
    p = _pipe()
    for n in (64, 65, 66):
        p.run(_table(n))
    seen = pl._graph_bytes_seen
    assert sorted(b for b, _ in seen.values()) == [_static(65), _static(66)]


def test_graph_cache_bytes_counts_the_shared_pool_once(graphs):
    _Stub.growth = 7
    p = _pipe()
    for n in (64, 65, 66):
        p.run(_table(n))
    assert pl.graph_cache_bytes() == sum(_static(n) for n in (64, 65, 66)) + 7 * (64 + 65 + 66)
    assert pl.graph_cache_bytes("cpu") == pl.graph_cache_bytes()


def test_tensor_bytes_counts_each_storage_once():
    import torch

    a = torch.zeros(10, dtype=torch.int64)
    b = torch.zeros(4, dtype=torch.int32)
    assert pl._tensor_bytes([a, b, a]) == 96
    assert pl._tensor_bytes([b]) == 16


# ---- admission's charge for a capture


def _priced(pipe, chunks):
    job = Job(None, pipe, chunks, 2, True)
    Server._price(job)
    return job.estimate


def _base(pipe, chunks):
    n = max(c.num_rows for c in chunks)
    per_chunk = pipe._estimate_from_basis(n, pipe._estimate_basis(chunks[0])[1],
                                          pipe._initial_plan(n))
    return per_chunk * min(2, len(chunks))


def test_price_adds_the_recorded_bytes_of_an_uncached_plan(graphs):
    p, chunks = _pipe(), [_table(64, seed=i) for i in range(3)]
    key = p._plan_key(chunks[0], p._initial_plan(64), False)
    pl._graph_bytes_seen[key] = (12345, 10)
    # the capture, and one chunk's outputs per result kept and in flight
    assert _priced(p, chunks) == _base(p, chunks) + 12345 + 10 * (3 + 2)
    # a chunk of another shape captures a graph of its own: both are charged
    other = _table(32, seed=9)
    pl._graph_bytes_seen[p._plan_key(other, p._initial_plan(32), False)] = (500, 30)
    assert _priced(p, chunks + [other]) == _base(p, chunks + [other]) + 12345 + 500 + 30 * (4 + 2)


def test_price_adds_no_capture_for_a_cached_plan(graphs):
    _Stub.out = 7
    p, chunks = _pipe(), [_table(64, seed=i) for i in range(3)]
    p.run(chunks[0])
    assert pl._graph_bytes_seen
    assert _priced(p, chunks) == _base(p, chunks) + 7 * (3 + 2)


def test_price_adds_the_chunks_a_lazy_source_drained(graphs, monkeypatch):
    monkeypatch.setattr(pl, "_device_bytes", lambda tree: 777 * len(tree))
    p, chunks = _pipe(), [_table(64, seed=i) for i in range(3)]
    pl.plan_cache_clear()
    for source, drained in ((iter(chunks), 777 * 3), (list(chunks), 0)):
        job = Job(None, p, source, 2, True)
        Server._materialize(job)
        Server._price(job)
        prior = pl._GRAPH_PRIOR * (_base(p, chunks) // 2)
        assert job.estimate == _base(p, chunks) + prior + drained


def test_price_uses_the_prior_before_any_capture(graphs):
    p, chunks = _pipe(), [_table(64, seed=i) for i in range(3)]
    per_chunk = _base(p, chunks) // 2
    assert _priced(p, chunks) == _base(p, chunks) + pl._GRAPH_PRIOR * per_chunk
    # a chain that parses strings at a width knob takes the larger prior
    s = Pipeline("strings").cast_to_integer(1, INT32, width=8)
    per_chunk = _base(s, chunks) // 2
    assert _priced(s, chunks) == _base(s, chunks) + pl._GRAPH_PRIOR_STRINGS * per_chunk


def test_price_adds_nothing_on_the_cpu(graphs, monkeypatch):
    monkeypatch.setattr(pl, "_captures", lambda dev: dev.type == "cuda")
    p, chunks = _pipe(), [_table(64, seed=i) for i in range(3)]
    pl._graph_bytes_seen[p._plan_key(chunks[0], p._initial_plan(64), False)] = (12345, 10)
    assert _priced(p, chunks) == _base(p, chunks)
    job = Job(None, p, iter(chunks), 2, True)  # a lazy source's chunks on the CPU
    Server._materialize(job)
    Server._price(job)
    assert job.drained and job.estimate == _base(p, chunks)


class _Session:
    name, budget = "s", None

    def _bump(self, key, n=1):
        pass


class _Job:
    def __init__(self, estimate, keys=()):
        self.estimate, self.session, self.plan_keys = estimate, _Session(), keys


def test_admission_room_is_net_of_the_graph_cache(graphs):
    p, a, b = _pipe(), _table(64), _table(65, seed=1)
    p.run(a)
    p.run(b)
    held = pl.graph_cache_bytes()
    assert held == _static(64) + _static(65)
    cap = held + 100
    ctl = AdmissionController(cap)
    first = _Job(100, keys=(p._plan_key(a, p._initial_plan(64), False),))
    assert ctl.offer(first) == "admitted" and pl.graph_cache_bytes() == held
    # it fits beside the jobs in flight only once the graph first runs
    # goes too: it waits, and no graph goes for nothing
    second = _Job(_static(65) + 1)
    assert ctl.offer(second) == "queued"
    assert ctl.promote() == ([], []) and pl.graph_cache_bytes() == held and not _evicts()
    # with nothing in flight the coldest graph makes room for it
    ctl.release(first)
    assert ctl.promote() == ([second], [])
    assert pl.graph_cache_bytes() == _static(65)
    assert [(e["freed_bytes"]) for e in _evicts()] == [_static(64)]
    # an idle device admits any job within its capacity at once
    ctl.release(second)
    assert AdmissionController(cap).offer(_Job(cap)) == "admitted"
    assert pl.graph_cache_bytes() == 0
