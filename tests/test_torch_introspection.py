"""The port's live-introspection layer against the JAX package's,
exactly: the Prometheus exposition of ``runtime/diag.py`` (``prom_name``,
``prom_to_vocab``, ``prom_text``, ``parse_prom_text``) on one snapshot
dict, ``runtime/traceview.py`` (``load_journal``, ``to_chrome_trace``,
``check_trace``, ``span_stats``, ``render_stats``, ``convert``) on one
journal file, and the sampler's folding (``_collapse``,
``_perfetto_events``, ``perfetto``) on one folded dict. Every function
is pure host Python in both packages, so the outputs must be equal
byte for byte."""

import json
import os
import threading

import numpy as np
import pytest

from spark_rapids_jni_tpu.runtime import diag as jdiag
from spark_rapids_jni_tpu.runtime import resource as jres
from spark_rapids_jni_tpu.runtime import sampler as jsampler
from spark_rapids_jni_tpu.runtime import traceview as jtv
from spark_rapids_jni_tpu.runtime import metrics as jmetrics
from spark_rapids_jni_tpu.runtime import events as jevents
from spark_rapids_jni_tpu.runtime import spans as jspans

from spark_rapids_jni_tpu_torch import Column, Table, INT32, FLOAT64
from spark_rapids_jni_tpu_torch import traceview as pcli
from spark_rapids_jni_tpu_torch.api import Pipeline, serving_server
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
from spark_rapids_jni_tpu_torch.runtime import diag as pdiag
from spark_rapids_jni_tpu_torch.runtime import events as pevents
from spark_rapids_jni_tpu_torch.runtime import metrics as pmetrics
from spark_rapids_jni_tpu_torch.runtime import pipeline as ppl
from spark_rapids_jni_tpu_torch.runtime import resource as pres
from spark_rapids_jni_tpu_torch.runtime import sampler as psampler
from spark_rapids_jni_tpu_torch.runtime import spans as pspans
from spark_rapids_jni_tpu_torch.runtime import trace as ptrace
from spark_rapids_jni_tpu_torch.runtime import traceview as ptv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh(m, e, s, r):
    m.configure("mem")
    m.reset()
    e.clear()
    s.reset()
    r.reset()


@pytest.fixture
def both():
    """Fresh in-memory telemetry in both packages; restores each
    package's prior sink mode after."""
    prev = (jmetrics.configure("mem"), pmetrics.configure("mem"))
    mods = ((jmetrics, jevents, jspans, jres), (pmetrics, pevents, pspans, pres))
    for m in mods:
        _fresh(*m)
    ppl.plan_cache_clear()
    yield
    for m, p in zip(mods, prev):
        _fresh(*m)
        m[0].configure(p)
    ppl.plan_cache_clear()


def _table(n, seed):
    rng = np.random.default_rng(seed)
    return Table([
        Column.from_numpy(rng.integers(0, 5, n).astype(np.int32), INT32, device="cpu"),
        Column.from_numpy(rng.normal(size=n), FLOAT64, device="cpu"),
    ])


def _pipe(name, capacity=16):
    return (Pipeline(name).filter(lambda tb: tb.columns[0].data >= 1)
            .group_by([0], [Agg("sum", 1), Agg("count", 0)], capacity=capacity))


# ---- one snapshot dict, both expositions


def _snapshot():
    """A registry snapshot with every instrument kind, names with dots
    and underscores, integer and float values, and latency histograms
    from a served job."""
    srv = serving_server(1 << 30)
    try:
        s = srv.open_session("prom")
        srv.submit(s, _pipe("prom"), [_table(64, i) for i in range(2)]).result(timeout=60)
    finally:
        srv.shutdown()
    pmetrics.gauge("collect.key_skew").set(1.5)
    pmetrics.timer("op.Demo_op").observe(0.25)
    for v in (0.004, 0.5, 3.0, 3.1, 40.0, 900.0, 2e6):
        pmetrics.histogram("serving.queue_wait_ms").observe(v)
    return pmetrics.snapshot()


def test_prom_text_is_byte_identical(both):
    snap = _snapshot()
    assert snap["histograms"] and snap["timers"] and snap["gauges"] and snap["counters"]
    text = pdiag.prom_text(snap)
    assert text == jdiag.prom_text(snap)
    assert pdiag.parse_prom_text(text) == jdiag.parse_prom_text(text)


def test_prom_names_round_trip_like_jax(both):
    snap = _snapshot()
    names = sorted({n for kind in ("counters", "gauges", "timers", "histograms")
                    for n in snap[kind]})
    for n in names + ["a_b.c__d", "x.y-z"]:
        s = pdiag.prom_name(n)
        assert s == jdiag.prom_name(n)
        assert pdiag.prom_to_vocab(s) == jdiag.prom_to_vocab(s)
    assert all(pdiag.prom_to_vocab(pdiag.prom_name(n)) == n for n in names)


def test_prom_names_injective_over_the_documented_vocabulary():
    from spark_rapids_jni_tpu.analysis.rules.telemetry_vocab import parse_vocab

    with open(os.path.join(ROOT, "docs", "OBSERVABILITY.md"), encoding="utf-8") as f:
        vocab = parse_vocab(f.read())
    names = sorted(n for kind in ("counter", "gauge", "timer", "histogram")
                   for n in vocab.get(kind, ()))
    assert len(names) >= 10
    mapped = [pdiag.prom_name(n) for n in names]
    assert mapped == [jdiag.prom_name(n) for n in names]
    assert len(set(mapped)) == len(mapped)
    assert [pdiag.prom_to_vocab(m) for m in mapped] == names


def test_parse_prom_text_rejects_what_jax_rejects():
    bad = "# TYPE x counter\nx_total one\n"
    for diag in (pdiag, jdiag):
        with pytest.raises(ValueError, match="line 2"):
            diag.parse_prom_text(bad)


# ---- one journal file, both converters


def _port_serving_journal(path):
    """Three tenants interleaved on the port's server, with an injected
    retry: job, task, op, run_plan and retry_round spans."""
    srv = serving_server(1 << 30)
    try:
        jobs = []
        for i in range(3):
            s = srv.open_session(f"j{i}")
            chunks = [_table(32 + 16 * i, 10 * i + k) for k in range(2)]
            jobs.append(srv.submit(s, _pipe(f"jr{i}", 8 << i), chunks, window=2))
        for j in jobs:
            j.result(timeout=60)
    finally:
        srv.shutdown()
    with pres.task(max_retries=2):
        pres.force_retry_oom(num_ooms=1)
        pres.guard("retried", lambda: 1)
    pmetrics.dump_jsonl(path)


def _jax_retry_journal(path):
    with jres.task(max_retries=2):
        jres.force_retry_oom(num_ooms=1)
        jres.guard("retried", lambda: 1)
    with jres.task():
        for _ in range(3):
            jres.guard("noop", lambda: 1)
    jmetrics.dump_jsonl(path)


JOURNALS = {"port serving": _port_serving_journal, "jax retry": _jax_retry_journal}


@pytest.fixture(params=sorted(JOURNALS))
def journal(request, both, tmp_path):
    path = str(tmp_path / "journal.jsonl")
    JOURNALS[request.param](path)
    return path


def test_load_journal_and_chrome_trace_are_identical(journal):
    evs = ptv.load_journal(journal)
    assert evs == jtv.load_journal(journal) and evs
    trace = ptv.to_chrome_trace(evs)
    assert trace == jtv.to_chrome_trace(evs)
    assert json.dumps(trace) == json.dumps(jtv.to_chrome_trace(jtv.load_journal(journal)))


def test_check_trace_agrees(journal):
    trace = ptv.to_chrome_trace(ptv.load_journal(journal))
    for n in (1, 5, 10_000):
        assert ptv.check_trace(trace, min_spans=n) == jtv.check_trace(trace, min_spans=n)
    assert ptv.check_trace(trace, min_spans=5) == []
    assert ptv.check_trace({"x": 1}) == jtv.check_trace({"x": 1})


def test_span_stats_and_render_agree(journal):
    evs = ptv.load_journal(journal)
    for top in (1, 10):
        st = ptv.span_stats(evs, top=top)
        assert st == jtv.span_stats(evs, top=top)
        assert ptv.render_stats(st) == jtv.render_stats(st)
    assert ptv.render_stats({"by_kind": [], "by_name": []}) == \
        jtv.render_stats({"by_kind": [], "by_name": []})


def test_convert_and_cli_write_the_same_file(journal, tmp_path, capsys):
    p_out, p_trace, p_n = ptv.convert(journal, str(tmp_path / "p.json"))
    j_out, j_trace, j_n = jtv.convert(journal, str(tmp_path / "j.json"))
    assert (p_trace, p_n) == (j_trace, j_n)
    with open(p_out) as fp, open(j_out) as fj:
        assert fp.read() == fj.read()
    assert pcli.main([journal, "-o", str(tmp_path / "c.json"), "--check", "--min-spans", "3",
                      "--stats", "3"]) == 0
    out = capsys.readouterr().out
    assert "traceview check OK" in out and "top spans by cumulative wall" in out
    with open(tmp_path / "c.json") as f:
        assert json.load(f) == j_trace


def test_serving_jobs_render_on_session_tracks(both, tmp_path):
    path = str(tmp_path / "journal.jsonl")
    _port_serving_journal(path)
    trace = ptv.to_chrome_trace(ptv.load_journal(path))
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert {"session j0", "session j1", "session j2"} <= names
    jobs = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e["cat"] == "job"]
    assert len(jobs) == 3 and all(e["args"]["state"] == "done" for e in jobs)


def test_cli_errors_match(tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    for main in (pcli.main, jtv.main):
        assert main([str(tmp_path / "missing.jsonl")]) == 2
        assert main([str(empty)]) == 2
    capsys.readouterr()


# ---- one folded dict, both renderers

FOLDED = {
    "task:task[1];op:Pipeline.q1;run_plan:pipeline.q1;py:pipeline.py:run": 7,
    "task:task[1];op:Pipeline.q1;run_plan:pipeline.q1;py:pipeline.py:_replay": 3,
    "task:task[1];op:Pipeline.q1": 2,
    "task:ambient;session:q5;task:task[2];op:Pipeline.q5_batch;py:server.py:_slice": 5,
    "session:store_sales;job:job:store_sales#4 (detached)": 4,
    "op:Pipeline.q1.chunk3 (detached)": 1,
}


def test_collapse_is_identical():
    assert psampler._collapse(FOLDED) == jsampler._collapse(FOLDED)
    assert psampler._collapse({}) == jsampler._collapse({}) == ""


@pytest.mark.parametrize("rate", [19.0, 7.5])
def test_perfetto_events_are_identical(rate):
    evs = psampler._perfetto_events(FOLDED, rate)
    assert evs == jsampler._perfetto_events(FOLDED, rate)
    trace = ptv.to_chrome_trace(evs)
    assert trace == jtv.to_chrome_trace(evs)
    assert ptv.check_trace(trace, min_spans=1) == []


def test_live_folding_matches_the_jax_labels(both):
    """The port's sampler folds a live thread's span stack with the
    same labels the JAX package's does for the same nesting."""
    entered, release = threading.Event(), threading.Event()

    def blocked(res):
        with res.task(task_id=41):
            res.guard("blocked_op", lambda: (entered.set(), release.wait(30)))

    folds = {}
    for name, res, smp in (("port", pres, psampler), ("jax", jres, jsampler)):
        smp.reset()
        entered.clear()
        release.clear()
        t = threading.Thread(target=blocked, args=(res,))
        t.start()
        try:
            assert entered.wait(10)
            smp.sample_once()
        finally:
            release.set()
            t.join()
        folds[name] = sorted(k.split(";py:")[0] for k in smp._snapshot_folded()
                             if "blocked_op" in k)
        smp.reset()
    assert folds["port"] == folds["jax"] and folds["port"]


def test_a_sample_keeps_no_thread_frame_alive():
    """A thread's locals die when its function returns, sampled or not:
    the sampler's frame map must not outlive its tick (with the garbage
    collector off, a cycle through it kept a CUDA graph's warm-up
    intermediates alive and doubled a capture's peak on the card)."""
    import gc
    import weakref

    import torch

    entered, release, done = threading.Event(), threading.Event(), threading.Event()
    refs = []

    def hold():
        payload = torch.zeros(1024)
        refs.append(weakref.ref(payload))
        entered.set()
        release.wait(30)

    def worker():
        with pres.task(task_id=42):
            pres.guard("held_op", hold)
        done.set()

    psampler.reset()
    gc.disable()
    try:
        t = threading.Thread(target=worker)
        t.start()
        try:
            assert entered.wait(10)
            assert psampler.sample_once() >= 1
        finally:
            release.set()
        assert done.wait(10)
        assert refs[0]() is None
        t.join(10)
        assert not t.is_alive()
    finally:
        gc.enable()
        psampler.reset()


def test_timeline_and_annotate_function(tmp_path):
    """``trace.timeline`` writes a Chrome trace of the block (CPU
    activity only, as the tensors lie on the CPU); an ``op_range`` and an
    ``annotate_function`` inside it show as spans; outside a timeline
    both are plain calls."""
    @ptrace.annotate_function("Demo.annotated")
    def work(n, *, scale=2):
        """Doc survives."""
        return _pipe("tl").run(_table(n, 0)).num_rows * scale

    assert work.__name__ == "work" and work.__doc__ == "Doc survives."
    want = work(64)
    with ptrace.timeline(str(tmp_path / "tl"), device="cpu") as prof:
        with ptrace.op_range("Demo.range"):
            assert work(64) == want
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"Demo.range", "Demo.annotated", "Pipeline.tl"} <= names
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tl")
    with ptrace.op_range("outside"):
        assert work(64) == want
