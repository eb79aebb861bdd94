"""The port's failure flight recorder (``runtime/flight.py``) against
the JAX package's: the same failing task leaves a bundle with the same
layout (files, MANIFEST fields, the error and task-metrics payload, the
span stack, the journal tail, the touched plans), and the ``ls`` /
``show`` CLI reads both packages' bundles alike. ``sampler.txt`` is
empty here because no sampler ran, as the JAX package writes it then;
tests/test_torch_diag.py holds the bundle of an armed sampler."""

import json
import os

import pytest

from spark_rapids_jni_tpu.runtime import errors as jerr
from spark_rapids_jni_tpu.runtime import flight as jfl
from spark_rapids_jni_tpu.runtime import resource as jres

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch import flight as pcli
from spark_rapids_jni_tpu_torch.api import Pipeline
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
from spark_rapids_jni_tpu_torch.runtime import errors as perr
from spark_rapids_jni_tpu_torch.runtime import flight as pfl
from spark_rapids_jni_tpu_torch.runtime import resource as pres


@pytest.fixture
def armed(tmp_path, monkeypatch):
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jres.reset()
    pres.reset()
    yield roots, monkeypatch
    jres.reset()
    pres.reset()


def _fail(res, err, with_plan=False):
    with pytest.raises(err.RetryOOMError):
        with res.task(max_retries=1, budget=10):
            if with_plan:
                t = port.Table([port.Column.from_pylist([1, 2, 2], port.INT32, device="cpu")])
                Pipeline("fl").group_by([0], [Agg("count")]).run(t)
            res.force_retry_oom(num_ooms=5)
            res.guard("noop", lambda: 1)


def _bundle(root):
    (name,) = [d for d in os.listdir(root) if d.startswith("flight_")]
    return os.path.join(root, name)


def _load(path, name):
    with open(os.path.join(path, name)) as f:
        return json.load(f)


def _record_both(armed):
    roots, mp = armed
    mp.setenv("SPARK_JNI_TPU_FLIGHT", roots["jax"])
    _fail(jres, jerr)
    mp.setenv("SPARK_JNI_TPU_FLIGHT", roots["port"])
    _fail(pres, perr, with_plan=True)
    return _bundle(roots["jax"]), _bundle(roots["port"])


def test_bundle_layout_matches(armed):
    jb, pb = _record_both(armed)
    assert sorted(os.listdir(pb)) == sorted(os.listdir(jb))
    jm, pm = _load(jb, "MANIFEST.json"), _load(pb, "MANIFEST.json")
    assert sorted(pm) == sorted(jm)
    assert pm["reason"] == jm["reason"] == "RetryOOMError"
    assert sorted(pm["files"]) == sorted(jm["files"])
    assert os.path.basename(pb).endswith(f"_task{pm['task_id']}")


def test_error_payload_matches(armed):
    jb, pb = _record_both(armed)
    je, pe = _load(jb, "error.json"), _load(pb, "error.json")
    assert sorted(pe) == sorted(je)
    assert pe["type"] == je["type"]
    assert sorted(pe["task_metrics"]) == sorted(je["task_metrics"])
    assert pe["task_metrics"]["injected_ooms"] == je["task_metrics"]["injected_ooms"] == 1
    assert pe["traceback"]


def test_span_stack_and_journal_tail(armed):
    jb, pb = _record_both(armed)
    kinds = [s["kind"] for s in _load(pb, "span_stack.json")]
    assert kinds == [s["kind"] for s in _load(jb, "span_stack.json")]
    with open(os.path.join(pb, "journal_tail.jsonl")) as f:
        events = [json.loads(line)["event"] for line in f]
    assert "retry_oom" in events and "retry_replan" in events


def test_touched_plans_and_empty_sampler(armed):
    _jb, pb = _record_both(armed)
    txt = open(os.path.join(pb, "explain.txt")).read()
    assert txt.startswith("# plans touched by task")
    assert "pipeline=fl" in txt and "stages: 0:group_by" in txt
    assert open(os.path.join(pb, "sampler.txt")).read() == ""
    assert _load(pb, "devices.json")[0]["platform"] in ("cpu", "gpu")
    assert "torch" in _load(pb, "env.json")


def test_bundle_index_and_cli(armed, capsys):
    jb, pb = _record_both(armed)
    for mod, root in ((jfl, os.path.dirname(jb)), (pfl, os.path.dirname(pb))):
        rows = mod.bundle_index(root)
        assert [r["reason"] for r in rows] == ["RetryOOMError"]
    assert pcli.main(["ls", "--dir", os.path.dirname(pb)]) == 0
    ls = capsys.readouterr().out
    assert os.path.basename(pb) in ls and "RetryOOMError" in ls
    assert pcli.main(["show", pb]) == 0
    show = capsys.readouterr().out
    assert "-- span stack at failure --" in show and "(sampler was not armed)" in show
    # the port's CLI reads a JAX-package bundle the same way
    assert pcli.main(["show", jb]) == 0
    assert "-- journal tail --" in capsys.readouterr().out


def test_cli_errors(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("SPARK_JNI_TPU_FLIGHT", raising=False)
    assert pcli.main(["ls"]) == jfl.main(["ls"]) == 2
    assert pcli.main(["ls", str(tmp_path / "none")]) == 2
    assert pcli.main(["show", str(tmp_path / "none")]) == 2


def test_prune_keeps_newest(armed):
    roots, mp = armed
    mp.setenv("SPARK_JNI_TPU_FLIGHT", roots["port"])
    for _ in range(pfl.MAX_BUNDLES + 2):
        _fail(pres, perr)
    names = [d for d in os.listdir(roots["port"]) if d.startswith("flight_")]
    assert len(names) == pfl.MAX_BUNDLES


def test_unarmed_records_nothing(monkeypatch):
    monkeypatch.delenv("SPARK_JNI_TPU_FLIGHT", raising=False)
    assert pfl.maybe_record(RuntimeError("x")) is None
