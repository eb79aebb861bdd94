"""The port's EXPLAIN surface (``Pipeline.explain``, ``runtime/explain.py``
and the ``python -m spark_rapids_jni_tpu_torch.explain`` CLI) against
the JAX package's: the same chain explains to the same stages, static
params and plan points; the cached-plan rows render once a chunk ran;
a journal written under ANALYZE renders per plan and per stage, and the
port's renderer reads a JAX-package journal the same way."""

import json

import pytest

from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.api import Pipeline as JPipeline
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops.aggregate import Agg as JAgg
from spark_rapids_jni_tpu.runtime import metrics as jmetrics

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch import explain as cli
from spark_rapids_jni_tpu_torch.api import Pipeline as PPipeline
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg as PAgg
from spark_rapids_jni_tpu_torch.runtime import events, metrics
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.runtime.explain import render_journal, render_live

KEYS = [1, 2, 1, 3, 2, 1, 4, 3]
VALS = [10, 20, 30, 40, 50, 60, 70, 80]
STRS = ["aa", "b", "cccc", "dd", "e", "ffffff", "g", "hh"]
FLAG = [1, 1, 0, 1, 1, 1, 0, 1]


def _ptbl():
    return port.Table.from_pylists([KEYS, VALS, STRS, FLAG],
                                   [port.INT32, port.INT64, port.STRING, port.INT32],
                                   device="cpu")


def _pipe(P, A, name, capacity=16):
    return (P(name).filter(lambda t: t.columns[3].data == 1)
            .group_by([0], (A("sum", 1),), capacity=capacity))


@pytest.fixture(autouse=True)
def _clean():
    prev = metrics.configure("mem")
    metrics.reset()
    events.clear()
    pl.plan_cache_clear()
    yield
    pl.plan_cache_clear()
    metrics.configure(prev)


@pytest.mark.parametrize("capacity", [16, None], ids=["static", "symbolic"])
def test_explain_json_matches_jax(capacity):
    jdoc = _pipe(JPipeline, JAgg, "xp", capacity).explain(fmt="json")
    pdoc = _pipe(PPipeline, PAgg, "xp", capacity).explain(fmt="json")
    again = json.loads(json.dumps(pdoc))
    assert again["stages"] == json.loads(json.dumps(jdoc["stages"]))
    assert again["plan"] == jdoc["plan"]
    for key in ("pipeline", "analyze", "capacity_feedback", "shard", "feedback", "plans"):
        assert again[key] == jdoc[key], key
    assert set(again) == set(jdoc)


def test_explain_text_and_cached_plans():
    pipe = _pipe(PPipeline, PAgg, "xp_text")
    txt = pipe.explain()
    assert "== Pipeline xp_text" in txt
    assert "stage 0: filter" in txt and "stage 1: group_by" in txt
    assert "plan cache: empty" in txt
    pipe.run(_ptbl())
    pipe.run(_ptbl())
    txt2 = pipe.explain()
    assert "hits=1" in txt2 and "stages: 0:filter -> 1:group_by" in txt2
    doc = pipe.explain(fmt="json")
    assert len(doc["plans"]) == 1 and doc["plans"][0]["sig"] == doc["signature"]
    with pytest.raises(ValueError):
        pipe.explain(fmt="yaml")
    with pytest.raises(pl.PipelineError, match="exchange"):
        pipe.explain(shard=("devices", 4))


def test_render_live_uses_the_shared_row_renderer():
    _pipe(PPipeline, PAgg, "xp_live").run(_ptbl())
    rows = pl.plan_cache_table()
    txt = pl.render_plan_rows(rows)
    assert render_live({"plans": rows}) == txt
    assert render_live({"explain": "x\n"}) == "x\n"


def test_journal_renders_plans_and_analyze_stages(tmp_path, capsys):
    path = str(tmp_path / "journal.jsonl")
    prev = metrics.configure(path)
    try:
        pipe = _pipe(PPipeline, PAgg, "an_cli")
        pipe.run(_ptbl(), analyze=True)
        pipe.run(_ptbl(), analyze=True)
    finally:
        metrics.configure(prev)
    out = render_journal(path)
    assert "Pipeline.an_cli" in out and "builds=2" in out and "hits=2" in out
    assert "Pipeline.an_cli stage 0:filter chunks=2 rows=12" in out
    assert "Pipeline.an_cli stage 1:group_by chunks=2 rows=6" in out
    assert cli.main([path]) == 0
    assert capsys.readouterr().out == out


def test_port_renders_a_jax_journal(tmp_path):
    path = str(tmp_path / "jax.jsonl")
    prev = jmetrics.configure(path)
    try:
        t = JTable.from_pylists([KEYS, VALS, STRS, FLAG],
                                [jd.INT32, jd.INT64, jd.STRING, jd.INT32])
        _pipe(JPipeline, JAgg, "an_jax").run(t, analyze=True)
    finally:
        jmetrics.configure(prev)
    out = render_journal(path)
    assert "Pipeline.an_jax stage 0:filter chunks=1 rows=6" in out


def test_cli_source_errors(tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.main([])
    assert cli.main([str(tmp_path / "missing.jsonl")]) == 1
    assert "cannot read journal" in capsys.readouterr().err
