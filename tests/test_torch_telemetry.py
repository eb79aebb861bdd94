"""The port's telemetry base (``runtime/metrics.py``, ``events.py``,
``spans.py``) against the JAX package's, exactly.

Each scenario drives the same calls through one package's three
modules and returns what a reader of the telemetry sees: snapshots,
reports, journal events and JSONL lines, with the time fields (``ts``,
``wall_ms``, ``t0``, ``ts0``) masked. Every scenario runs through both
packages and the results must be equal; the oracle assertions of
tests/test_metrics.py and tests/test_spans.py that need no unported
module run on the port's modules as well.
"""

import json
import threading

import pytest

from spark_rapids_jni_tpu.runtime import events as jevents
from spark_rapids_jni_tpu.runtime import metrics as jmetrics
from spark_rapids_jni_tpu.runtime import spans as jspans

from spark_rapids_jni_tpu_torch.runtime import events as pevents
from spark_rapids_jni_tpu_torch.runtime import metrics as pmetrics
from spark_rapids_jni_tpu_torch.runtime import spans as pspans

JAX = (jmetrics, jevents, jspans)
PORT = (pmetrics, pevents, pspans)
_TIME_KEYS = {"ts", "wall_ms", "t0", "ts0", "age_ms", "opened_unix"}


def mask(obj):
    """``obj`` with every time-valued field replaced by a marker."""
    if isinstance(obj, dict):
        return {k: ("<t>" if k in _TIME_KEYS else mask(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v) for v in obj]
    return obj


def fresh(mods):
    m, e, s = mods
    m.configure("mem")
    m.reset()
    e.clear()
    e.set_capacity(e.DEFAULT_CAPACITY)
    s.reset()


@pytest.fixture
def both():
    """Fresh in-memory telemetry and span context in both packages;
    restores each package's prior sink mode after."""
    prev = (jmetrics.configure("mem"), pmetrics.configure("mem"))
    for mods in (JAX, PORT):
        fresh(mods)
    yield
    for mods, p in ((JAX, prev[0]), (PORT, prev[1])):
        fresh(mods)
        mods[0].configure(p)


def lines(path):
    with open(path) as f:
        return [mask(json.loads(ln)) for ln in f if ln.strip()]


# ---- scenarios: (metrics, events, spans, tmp_path, monkeypatch) -> result


def sc_counters_gauges_timers(m, e, s, tmp, mp):
    m.counter("c").inc()
    m.counter("c").inc(4)
    m.gauge("g").set(2.5)
    m.timer("t").observe(2.0)
    m.timer("t").observe(8.0)
    snap = m.snapshot()
    assert snap["counters"]["c"] == 5
    assert snap["gauges"]["g"] == 2.5
    t = snap["timers"]["t"]
    assert (t["count"], t["sum_ms"], t["min_ms"], t["max_ms"]) == (2, 10.0, 2.0, 8.0)
    assert m.counter_value("never") == 0
    assert m.timer_stats("never") is None
    return snap, m.timer_stats("t"), m.gauge_value("g"), m.gauge_value("never")


def sc_snapshot_delta(m, e, s, tmp, mp):
    m.counter("a").inc(2)
    m.timer("t").observe(1.0)
    m.gauge("g").set(1.0)
    before = m.snapshot()
    m.counter("a").inc(3)
    m.counter("b").inc()
    m.timer("t").observe(4.0)
    m.gauge("g").set(7.0)
    m.histogram("h").observe(3.0)
    d = m.snapshot_delta(before, m.snapshot())
    assert d["counters"] == {"a": 3, "b": 1}
    assert d["gauges"] == {"g": 7.0}
    assert d["timers"]["t"] == {"count": 1, "sum_ms": 4.0}
    assert m.snapshot_delta(m.snapshot(), m.snapshot()) == {}
    return d


def sc_report(m, e, s, tmp, mp):
    # the sink footer counts process-wide write errors and rotations,
    # which an earlier test file in this process may have left nonzero
    mp.setattr(m, "_sink_errors", 0)
    mp.setattr(m, "_rotations", 0)
    empty = m.report()
    assert empty == "(no telemetry recorded)"
    m.counter("resource.retries").inc(3)
    m.timer("op.Aggregation.groupBy").observe(12.5)
    m.gauge("scan.prefetch_depth").set(2)
    for v in (0.5, 1.0, 4.0, 40.0):
        m.histogram("serving.e2e_ms").observe(v)
    rep = m.report()
    header = [ln for ln in rep.splitlines() if ln.startswith("timer")][0]
    assert "count" in header and "total_ms" in header
    assert "resource.retries" in rep
    return empty, rep


def sc_off_mode(m, e, s, tmp, mp):
    m.configure("off")
    m.record_op("X.y", 1.0, rows_in=5)
    e.emit("op_begin", op="X.y")
    m.counter("c").inc(5)
    m.gauge("g").set(1.0)
    m.timer("t").observe(2.0)
    m.histogram("h").observe(2.0)
    assert not m.enabled()
    snap = m.snapshot()
    assert snap == {"counters": {}, "gauges": {}, "timers": {}, "histograms": {}}
    assert e.events() == []
    return snap, m.histogram("h").quantile(0.5), m.histogram("h").cumulative_buckets()


def sc_mem_mode(m, e, s, tmp, mp):
    m.record_op("X.y", 2.0, rows_in=5, rows_out=3, bytes_in=40, bytes_out=24)
    m.record_op("X.y", 1.0, ok=False, error="boom")
    assert m.counter_value("op.X.y.calls") == 2
    assert m.counter_value("op.X.y.rows_in") == 5
    ev = e.of_kind("op_end")
    assert len(ev) == 2 and ev[0]["op"] == "X.y" and ev[0]["attrs"]["rows_out"] == 3
    return m.snapshot(), mask(e.events())


def sc_file_sink(m, e, s, tmp, mp):
    path = str(tmp / "sink.jsonl")
    m.configure(path)
    m.record_op("X.y", 1.5, rows_in=2)
    e.emit("retry_replan", op="X.y", attempt=0, injected=False, plan={})
    streamed = lines(path)
    assert {x["event"] for x in streamed} == {"op_end", "retry_replan"}
    m._flush_file_sink()
    assert m.validate_jsonl(path) >= 3
    out = lines(path)
    assert {x["kind"] for x in out} == {"event", "counter", "timer"}
    m.configure("mem")
    return streamed, out


def sc_unwritable_sink(m, e, s, tmp, mp):
    before = m.sink_write_errors()
    m.configure(str(tmp / "no-such-dir" / "deeper" / "sink.jsonl"))
    e.emit("op_begin", op="X.y")  # must not raise
    assert m.mode() == "mem"
    assert len(e.events()) == 1
    assert m.sink_write_errors() == before + 1
    return m.mode(), m.sink_write_errors() - before, f"{before + 1} write errors" in m.report()


def sc_env_resolution(m, e, s, tmp, mp):
    seen = []
    mp.setenv("SPARK_JNI_TPU_METRICS", "off")
    mp.setattr(m, "_mode", None)
    seen.append(m.mode())
    mp.delenv("SPARK_JNI_TPU_METRICS")
    m._mode = None
    seen.append(m.mode())
    for value in ("OFF", "0", "false", "None", "mem", "on", "bogus-value"):
        mp.setenv("SPARK_JNI_TPU_METRICS", value)
        m._mode = None
        seen.append(m.mode())
    spaced = str(tmp / "spaced.jsonl")
    seen.append(m.configure(f" {spaced}\n"))
    assert m.mode() == spaced
    m.configure("mem")
    assert seen[:2] == ["off", "mem"] and seen[2:6] == ["off"] * 4
    return seen


def sc_dump_onto_live_sink(m, e, s, tmp, mp):
    path = str(tmp / "live.jsonl")
    m.configure(path)
    m.counter("c").inc(2)
    e.emit("op_begin", op="X.y")
    n = m.dump_jsonl(path)
    assert m.validate_jsonl(path) == n
    e.emit("op_begin", op="X.z")
    assert m.validate_jsonl(path) == n + 1
    out = lines(path)
    m.configure("mem")
    return n, out


def sc_jsonl_round_trip(m, e, s, tmp, mp):
    m.counter("c").inc(2)
    m.gauge("g").set(1.5)
    m.timer("t").observe(3.0)
    for v in (0.02, 0.5, 0.5, 7.0, 1e9):
        m.histogram("h").observe(v)
    e.emit("op_begin", op="X.y", rows_in=1, bytes_in=8)
    path = str(tmp / "dump.jsonl")
    n = m.dump_jsonl(path)
    assert n == m.validate_jsonl(path) == 5
    out = lines(path)
    counter = [x for x in out if x["kind"] == "counter"][0]
    assert counter == {"v": m.SCHEMA_VERSION, "kind": "counter", "name": "c", "value": 2}
    ev = [x for x in out if x["kind"] == "event"][0]
    assert ev["attrs"] == {"rows_in": 1, "bytes_in": 8} and isinstance(ev["span_id"], int)
    return out


MALFORMED = [
    ["not an object"],
    {"v": 99, "kind": "counter", "name": "x", "value": 1},
    {"v": 1, "kind": "nope", "name": "x"},
    {"v": 1, "kind": "counter", "name": "x", "value": -1},
    {"v": 1, "kind": "counter", "name": "x", "value": 1.5},
    {"v": 1, "kind": "gauge", "name": "x", "value": "1"},
    {"v": 1, "kind": "timer", "name": "x", "count": 0, "sum_ms": 0, "min_ms": 0, "max_ms": 0},
    {"v": 1, "kind": "timer", "name": "x", "count": 1, "sum_ms": 1, "min_ms": 5, "max_ms": 1},
    {"v": 2, "kind": "histogram", "name": "h", "count": 2, "sum_ms": 1, "min_ms": 0.5,
     "max_ms": 0.5, "buckets": {"0.5": 2, "+Inf": 1}},
    {"v": 2, "kind": "histogram", "name": "h", "count": 2, "sum_ms": 1, "min_ms": 0.5,
     "max_ms": 0.5, "buckets": {}},
    {"v": 1, "kind": "event", "event": "made_up", "op": None, "ts": 0.0, "attrs": {}},
    {"v": 1, "kind": "event", "event": "op_end", "op": 3, "ts": 0.0, "attrs": {}},
    {"v": 1, "kind": "event", "event": "op_end", "op": None, "ts": 0.0, "attrs": None},
    {"v": 2, "kind": "event", "event": "op_end", "op": None, "ts": 0.0, "attrs": {}},
    {"v": 2, "kind": "event", "event": "op_end", "op": None, "ts": 0.0, "span_id": 1,
     "parent_id": "root", "task_id": None, "attrs": {}},
]


def sc_validate_rejects(m, e, s, tmp, mp):
    errors = []
    for bad in MALFORMED:
        with pytest.raises(ValueError) as exc:
            m.validate_line(bad)
        errors.append(str(exc.value))
    # a v1 event WITHOUT span fields stays valid: old journals readable
    m.validate_line({"v": 1, "kind": "event", "event": "op_end", "op": None, "ts": 0.0,
                     "attrs": {}})
    return errors


def sc_event_ring(m, e, s, tmp, mp):
    e.set_capacity(4)
    for i in range(10):
        e.emit("op_begin", op=f"X.{i}")
    evs = e.events()
    assert [x["op"] for x in evs] == ["X.6", "X.7", "X.8", "X.9"]
    assert e.dropped() == 6
    mp.setattr(m, "_sink_errors", 0)
    mp.setattr(m, "_rotations", 0)
    rep = m.report()
    assert "6 dropped" in rep and "ring capacity 4" in rep
    e.set_capacity(2)
    assert len(e.events()) == 2 and e.dropped() == 8
    out = mask(e.recent(1)), e.capacity(), rep
    e.set_capacity(e.DEFAULT_CAPACITY)
    return out


def sc_histograms(m, e, s, tmp, mp):
    h = m.histogram("serving.queue_wait_ms")
    for v in (0.001, 0.01, 0.02, 0.3, 0.3, 5.0, 70.0, 1e3, 5e7):
        h.observe(v)
    with pytest.raises(ValueError):
        h.quantile(1.5)
    q = [h.quantile(x) for x in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0)]
    assert q[-1] == 5e7 and q == sorted(q)
    m.gauge("device.0.occupied_slots").set(3)
    m.gauge("device.1.occupied_slots").set(4)
    m.gauge("collect.key_skew").set(1.5)
    m.drop_gauges("device.")
    return (q, h.cumulative_buckets(), m.histogram_stats("serving.queue_wait_ms"),
            m.histogram_quantile("serving.queue_wait_ms", 0.5), m.histogram_totals(),
            m.histogram_stats("never"), m.snapshot()["gauges"])


def sc_sink_rotation(m, e, s, tmp, mp):
    mp.setenv("SPARK_JNI_TPU_METRICS_MAX_MB", "0.001")  # clamps to 4096 bytes
    path = str(tmp / "rot.jsonl")
    m.configure(path)
    rot0 = m.sink_rotations()
    for i in range(80):
        e.emit("op_begin", op=f"X.{i}", pad="p" * 40)
    rotations = m.sink_rotations() - rot0
    assert rotations >= 1
    paths = m.rotated_paths(path)
    assert paths == [path + ".1", path]
    n = m.validate_jsonl(path)
    assert n == sum(len(lines(p)) for p in paths)
    m.configure("mem")
    return rotations, [p[len(str(tmp)):] for p in paths], m.counter_value("journal.rotations") > 0


def sc_span_tree(m, e, s, tmp, mp):
    root = s.current()
    assert root.kind == "task" and root.name == "ambient"
    assert root.parent_id is None and root.task_id is None
    ids = []
    with s.span("op", "A", emit_end=False) as a:
        assert a.parent_id == root.sid and s.current() is a
        with s.span("run_plan", "B", emit_end=False) as b:
            assert b.parent_id == a.sid and b.sid > a.sid > root.sid
            ids.append((b.sid, b.parent_id, b.task_id))
        assert s.current() is a
    assert s.current() is root
    with s.span("task", "task[9]", task_id=9, emit_end=False):
        with s.span("op", "C", emit_end=False) as c:
            assert c.task_id == 9
            ids.append(s.current_ids())
            st = s.active_stack()
    return ids, mask(st), s.KINDS


def sc_span_leaks(m, e, s, tmp, mp):
    a = s.open_span("op", "a")
    s.open_span("op", "leaked")  # never closed by its owner
    s.close_span(a, emit_end=False)
    assert s.current().name == "ambient"
    with s.span("task", "task[1]", task_id=1, emit_end=False):
        with s.span("run_plan", "op", emit_end=False):
            st = s.active_stack()
    assert [x["name"] for x in st][-2:] == ["task[1]", "op"]
    return mask(st)


def sc_span_end_event(m, e, s, tmp, mp):
    with s.span("collect_stage", "collect_table", rows=3):
        e.emit("capacity_overflow", op="collect_table", stages={"join": 2}, source="test")
    evs = e.events()
    for ev in evs:
        m.validate_line(ev)
    end = e.of_kind("span_end")[0]
    assert end["op"] == "collect_table" and end["attrs"]["kind"] == "collect_stage"
    assert end["attrs"]["wall_ms"] >= 0 and end["span_id"] > 0
    assert end["parent_id"] is not None
    # the event emitted inside the span is stamped with the span
    assert evs[0]["span_id"] == end["span_id"]
    path = str(tmp / "spans.jsonl")
    n = m.dump_jsonl(path)
    assert m.validate_jsonl(path) == n
    return mask(evs), lines(path)


def sc_cross_thread_adopt(m, e, s, tmp, mp):
    task = s.open_span("task", "task[5]", task_id=5)
    seen = {}

    def other():
        s.adopt(task)
        with s.span("op", "remote", emit_end=False) as op:
            seen["op"] = (op.parent_id == task.sid, op.task_id)
            e.emit("op_begin", op="remote")
        seen["live"] = sorted(
            (len(st), [x.name for x in st]) for _n, st in s.live_stacks().values()
        )
        s.detach(task)

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    ev = e.of_kind("op_begin")[0]
    assert ev["task_id"] == 5
    s.close_span(task, emit_end=False)
    s.adopt(task)  # no-op: closed
    return seen, ev["task_id"], s.current().name, [x.name for x in s.detached_spans()]


def sc_detach_and_live_tree(m, e, s, tmp, mp):
    with s.span("stream", "stream", emit_end=False) as st:
        chunk = s.open_span("op", "chunk0")
        s.open_span("run_plan", "chunk0.plan")
        s.detach(chunk)
        assert s.current() is st
        tree = s.live_tree()
        detached = [x.name for x in s.detached_spans()]
        s.adopt(chunk)
        assert s.current() is chunk
        s.close_span(chunk, emit_end=True, retries=0)
    after = s.live_tree()
    return mask(tree), detached, mask(after), mask(e.events())


def sc_off_keeps_span_stack(m, e, s, tmp, mp):
    m.configure("off")
    with s.span("task", "task[2]", task_id=2):
        with s.span("op", "Dummy.op"):
            stack = s.active_stack()
    assert e.events() == []
    assert [x["kind"] for x in stack][-2:] == ["task", "op"]
    m.configure("mem")
    return mask(stack)


SCENARIOS = [
    sc_counters_gauges_timers, sc_snapshot_delta, sc_report, sc_off_mode, sc_mem_mode,
    sc_file_sink, sc_unwritable_sink, sc_env_resolution, sc_dump_onto_live_sink,
    sc_jsonl_round_trip, sc_validate_rejects, sc_event_ring, sc_histograms, sc_sink_rotation,
    sc_span_tree, sc_span_leaks, sc_span_end_event, sc_cross_thread_adopt,
    sc_detach_and_live_tree, sc_off_keeps_span_stack,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_scenario_matches_jax(both, scenario, tmp_path, monkeypatch):
    got = {}
    for label, mods in (("jax", JAX), ("port", PORT)):
        (tmp_path / label).mkdir()
        fresh(mods)
        with monkeypatch.context() as mp:
            got[label] = mask(scenario(*mods, tmp_path / label, mp))
        fresh(mods)
    assert got["port"] == got["jax"]


def test_event_names_equal_jax():
    assert pevents.EVENT_NAMES == jevents.EVENT_NAMES
    assert pmetrics.SCHEMA_VERSION == jmetrics.SCHEMA_VERSION
    assert pmetrics.HIST_BOUNDS == jmetrics.HIST_BOUNDS
    assert pspans.KINDS == jspans.KINDS


def test_compile_hook_is_dropped():
    """Eager torch has no compile boundary: the port carries no hook and
    no compile context helpers, and configuring a sink installs none."""
    for name in ("install_compile_hook", "set_compile_context", "restore_compile_context"):
        assert not hasattr(pmetrics, name)
    prev = pmetrics.configure("mem")
    try:
        assert pmetrics.counter_value("compile.requests") == 0
    finally:
        pmetrics.configure(prev)


def test_regex_strategy_counters_match_jax(both):
    """ops/regex.py publishes the same regex.strategy.* counters and
    regex.monoid_states gauge in both packages."""
    import numpy as np

    from spark_rapids_jni_tpu import Column as JColumn
    from spark_rapids_jni_tpu.columnar.dtypes import STRING as JSTRING
    from spark_rapids_jni_tpu.ops import regex as jregex
    from spark_rapids_jni_tpu_torch import STRING, Column
    from spark_rapids_jni_tpu_torch.ops import regex as pregex

    subjects = ["id=1;host=a", "bad", None, ""]
    jc = JColumn.from_pylist(subjects, JSTRING)
    pc = Column.from_pylist(subjects, STRING, device="cpu")
    for pat in (r"id=\d+", r"x{30}y{30}z{10}"):
        a = np.asarray(jregex.rlike(jc, pat).data)
        b = pregex.rlike(pc, pat).data.numpy()
        assert np.array_equal(a, b)
    # the JAX side also counts its XLA compiles (compile.*): compare the
    # regex instruments
    def regex_part(snap):
        return {kind: {k: v for k, v in snap[kind].items() if k.startswith("regex.")}
                for kind in ("counters", "gauges")}

    got = regex_part(pmetrics.snapshot())
    assert got == regex_part(jmetrics.snapshot())
    assert got["counters"] == {"regex.strategy.monoid": 1, "regex.strategy.serial": 1}
