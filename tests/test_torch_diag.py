"""The port's live introspection on the CPU: the diagnostics endpoint
(``runtime/diag.py``), the span-stack sampling profiler
(``runtime/sampler.py``) and the flight bundle's ``sampler.txt``: the
port-side cases of tests/test_diag.py, plus ``explain --port`` against
a live port server and both packages armed on one fixed port."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from spark_rapids_jni_tpu_torch import Column, Table, INT32
from spark_rapids_jni_tpu_torch import explain as explain_cli
from spark_rapids_jni_tpu_torch.api import Pipeline
from spark_rapids_jni_tpu_torch.ops.aggregate import Agg
from spark_rapids_jni_tpu_torch.runtime import (
    diag,
    events,
    flight,
    metrics,
    resource,
    sampler,
    spans,
    traceview,
)
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.runtime.errors import RetryOOMError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def telemetry():
    """Fresh in-memory telemetry + fresh span/sampler state."""
    prev = metrics.configure("mem")
    metrics.reset()
    events.clear()
    spans.reset()
    resource.reset()
    sampler.stop()
    sampler.reset()
    pl.plan_cache_clear()
    yield metrics
    sampler.stop()
    sampler.reset()
    metrics.reset()
    events.clear()
    spans.reset()
    resource.reset()
    pl.plan_cache_clear()
    metrics.configure(prev)


@pytest.fixture
def server(telemetry):
    """A live diagnostics server on an ephemeral loopback port."""
    port = diag.start(0)
    yield port
    diag.stop()


def _get(port, path, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.read().decode(), dict(r.headers)


def _get_json(port, path):
    return json.loads(_get(port, path)[0])


def _fail_task():
    with pytest.raises(RetryOOMError):
        with resource.task(max_retries=1):
            resource.force_retry_oom(num_ooms=5)
            resource.guard("noop", lambda: 1)


def _bundle(root):
    (name,) = [p for p in os.listdir(root) if p.startswith("flight_")]
    return os.path.join(root, name)


def _busy_thread(seconds, op="spin"):
    def run():
        end = time.time() + seconds
        with resource.task():
            while time.time() < end:
                resource.guard(op, lambda: sum(range(500)))

    t = threading.Thread(target=run)
    t.start()
    return t


# ---- arming and security posture


def test_disarmed_by_default(monkeypatch):
    monkeypatch.delenv("SPARK_JNI_TPU_DIAG", raising=False)
    monkeypatch.delenv("SPARK_JNI_TPU_SAMPLER", raising=False)
    assert diag.armed_port() is None and diag.maybe_start() is None
    assert sampler.armed_hz() is None and sampler.maybe_start() is False


def test_bad_arming_values_stay_off(monkeypatch):
    monkeypatch.setenv("SPARK_JNI_TPU_DIAG", "not-a-port")
    monkeypatch.setenv("SPARK_JNI_TPU_SAMPLER", "not-a-rate")
    assert diag.armed_port() is None and sampler.armed_hz() is None
    monkeypatch.setenv("SPARK_JNI_TPU_SAMPLER", "on")
    assert sampler.armed_hz() == sampler.DEFAULT_HZ == 19.0
    monkeypatch.setenv("SPARK_JNI_TPU_SAMPLER", "7.5")
    assert sampler.armed_hz() == 7.5


def test_loopback_only_and_404(server):
    assert diag._server.server_address[0] == "127.0.0.1"
    assert diag.running() and diag.port() == server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/nosuch")
    assert ei.value.code == 404


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_BOTH = """
import importlib, json, sys
first, second = sys.argv[1:]
mods = {}
for name in (first, second):
    mods[name] = importlib.import_module(name + ".runtime.diag")
    importlib.import_module(name)
print(json.dumps({n: m.running() for n, m in mods.items()}))
"""


@pytest.mark.parametrize("first", ["spark_rapids_jni_tpu", "spark_rapids_jni_tpu_torch"])
def test_two_packages_one_fixed_port(first):
    """Both packages arm from the same variable: the second bind fails,
    logs, and leaves its server off; neither import breaks."""
    second = ({"spark_rapids_jni_tpu", "spark_rapids_jni_tpu_torch"} - {first}).pop()
    env = dict(os.environ, SPARK_JNI_TPU_DIAG=str(_free_port()), JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT)
    env.pop("SPARK_JNI_TPU_SAMPLER", None)
    r = subprocess.run([sys.executable, "-c", _BOTH, first, second], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {first: True, second: False}
    assert "could not bind" in r.stderr


# ---- the endpoints


def test_healthz_fields(server):
    h = _get_json(server, "/healthz")
    assert h["ok"] is True and h["pid"] == os.getpid() and h["uptime_s"] >= 0
    assert h["sink"]["mode"] == "mem"
    assert h["journal"]["capacity"] == events.capacity()
    assert set(h["sampler"]) >= {"running", "samples", "dropped"}
    assert "dir" in h["flight"] and "bundles" in h["flight"]
    assert h["slo_violations"] == 0


def test_prometheus_scrape_matches_snapshot(server):
    with resource.task():
        resource.guard("noop", lambda: 1)
    metrics.gauge("collect.key_skew").set(1.5)
    metrics.histogram("serving.e2e_ms").observe(3.0)
    body, headers = _get(server, "/metrics")
    assert "version=0.0.4" in headers["Content-Type"]
    parsed = diag.parse_prom_text(body)
    snap = metrics.snapshot()
    for name, v in snap["counters"].items():
        if name != "diag.requests":  # bumped by the scrape itself
            assert parsed[diag.prom_name(name) + "_total"] == v, name
    for name, v in snap["gauges"].items():
        assert parsed[diag.prom_name(name)] == v, name
    for name, t in snap["timers"].items():
        s = diag.prom_name(name) + "_ms"
        assert parsed[s + "_count"] == t["count"], name
        assert parsed[s + "_sum"] == pytest.approx(t["sum_ms"]), name
    assert parsed[diag.prom_name("serving.e2e_ms") + "_count"] == 1


def test_prom_text_validates_while_mutating(server):
    stop = threading.Event()

    def mutate():
        i = 0
        while not stop.is_set():
            metrics.counter("op.Mut.calls").inc()
            metrics.timer("op.Mut").observe(0.1 * (i % 7))
            i += 1

    t = threading.Thread(target=mutate, daemon=True)
    t.start()
    try:
        for _ in range(5):
            assert diag.parse_prom_text(_get(server, "/metrics")[0])
    finally:
        stop.set()
        t.join()


def test_spans_endpoint_resolves_inflight_chain_to_task_root(server):
    entered, release = threading.Event(), threading.Event()

    def blocked():
        with resource.task(task_id=77):
            resource.guard("blocked_op", lambda: (entered.set(), release.wait(30)))

    t = threading.Thread(target=blocked)
    t.start()
    try:
        assert entered.wait(timeout=10)
        tree = _get_json(server, "/spans")
        (hit,) = [th["stack"] for th in tree["threads"]
                  if "blocked_op" in [s["name"] for s in th["stack"]]]
        by_id = {s["span_id"]: s for s in hit}
        cur = hit[-1]
        assert cur["kind"] == "retry_round"
        while cur["parent_id"] in by_id:
            cur = by_id[cur["parent_id"]]
        assert cur["kind"] == "task"
        assert any(s["kind"] == "task" and s["task_id"] == 77 for s in hit)
    finally:
        release.set()
        t.join()


def _warm_plan():
    t = Table([Column.from_pylist([1, 2, 2, 3], INT32, device="cpu")])
    Pipeline("diagp").group_by([0], [Agg("count")], capacity=8).run(t)


def test_plans_endpoint_shape(server):
    body = _get_json(server, "/plans")
    assert set(body) == {"plans", "explain", "exec_feedback", "exec_programs"}
    assert body["explain"].startswith("plan cache: empty")
    _warm_plan()
    body = _get_json(server, "/plans")
    assert [r["pipeline"] for r in body["plans"]] == ["diagp"]
    assert body["explain"] == pl.render_plan_rows(pl.plan_cache_table())


def test_explain_port_reads_the_live_server(server, capsys):
    _warm_plan()
    assert explain_cli.main(["--port", str(server)]) == 0
    out = capsys.readouterr().out
    assert out.strip() and "diagp" in out
    assert out == explain_cli.render_live(_get_json(server, "/plans"))


# ---- flight bundles: the endpoint, the guard, sampler.txt


def test_flight_endpoints_and_traversal_guard(server, tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_JNI_TPU_FLIGHT", str(tmp_path))
    _fail_task()
    rows = _get_json(server, "/flight")
    assert rows and rows[0]["reason"] == "RetryOOMError"
    name = rows[0]["bundle"]
    assert _get_json(server, f"/flight/{name}")["reason"] == "RetryOOMError"
    body, _ = _get(server, f"/flight/{name}/error.json")
    assert json.loads(body)["type"] == "RetryOOMError"
    for bad in (f"/flight/{name}/../../etc/passwd", "/flight/..%2f..%2fetc",
                f"/flight/{name}/a/b"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(server, bad)
        assert ei.value.code in (400, 404)


def test_flight_bundle_sampler_txt_empty_when_never_armed(telemetry, tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_JNI_TPU_FLIGHT", str(tmp_path))
    _fail_task()
    with open(os.path.join(_bundle(str(tmp_path)), "sampler.txt")) as f:
        assert f.read() == ""


def test_flight_bundle_carries_the_armed_samplers_stacks(telemetry, tmp_path, monkeypatch,
                                                         capsys):
    """With the sampler armed, a bundle's sampler.txt holds its
    collapsed stacks, and the flight CLI's ``show`` prints them."""
    monkeypatch.setenv("SPARK_JNI_TPU_FLIGHT", str(tmp_path))
    t = _busy_thread(1.0)
    try:
        window = sampler.capture(0.3)
    finally:
        t.join()
    assert "run_plan:spin" in window
    _fail_task()
    bundle = _bundle(str(tmp_path))
    with open(os.path.join(bundle, "sampler.txt")) as f:
        assert f.read() == window == sampler.flight_text()
    assert flight.main(["show", bundle]) == 0
    out = capsys.readouterr().out
    shown = out.split("-- sampler (where it was stuck) --", 1)[1]
    assert "run_plan:spin" in shown


# ---- /profile and the sampler


def test_profile_endpoint_collapsed_and_perfetto(server):
    t = _busy_thread(2.0)
    try:
        body, _ = _get(server, "/profile?seconds=0.5")
        assert "run_plan:spin" in body, body[:300]
        for line in body.strip().splitlines():
            stack, count = line.rsplit(" ", 1)
            assert int(count) > 0 and stack
        trace = _get_json(server, "/profile?seconds=0.3&fmt=perfetto")
        assert [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        assert not traceview.check_trace(trace, min_spans=1)
    finally:
        t.join()


def test_profile_bad_fmt_is_500_not_fatal(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/profile?seconds=0.1&fmt=bogus")
    assert ei.value.code == 500
    assert _get_json(server, "/healthz")["ok"]


def test_capture_windows_are_disjoint_and_counted(telemetry):
    t = _busy_thread(1.6)
    try:
        first = sampler.capture(0.4)
        assert "run_plan:spin" in first
        assert sampler.stats()["samples"] > 0
        assert sampler.flight_text() == first
    finally:
        t.join()
    assert metrics.counter_value("sampler.samples") > 0
    assert "run_plan:spin" not in sampler.capture(0.2)


def test_sampler_start_stop_idempotent(telemetry):
    sampler.start(19)
    sampler.start(19)
    assert sampler.running()
    sampler.start(7)
    assert sampler.running() and sampler.hz() == 7
    sampler.stop()
    sampler.stop()
    assert not sampler.running()
