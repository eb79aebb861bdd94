"""The port's runtime-boundary fault injection (runtime/faultinj_pjrt.py):
faults hit programs the library never authored, at the seams every
program of the process crosses, with the reference's fatal / retryable /
status classification (faultinj.cu:154-341 analog). The six cases of
tests/test_faultinj_pjrt.py, each raising the class of the same name as
its JAX case, then a fault armed on one thread that hits a seam crossed
on another, uninstall restoring every attribute by identity, and
retry_oom at ``pjrt.execute`` retried by a task scope over q1."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.runtime import faultinj as jfi

from spark_rapids_jni_tpu_torch import INT64, Column, Table
from spark_rapids_jni_tpu_torch.api import Pipeline
from spark_rapids_jni_tpu_torch.kernels import _build
from spark_rapids_jni_tpu_torch.runtime import faultinj as fi
from spark_rapids_jni_tpu_torch.runtime import faultinj_pjrt as fp
from spark_rapids_jni_tpu_torch.runtime import pipeline as pl
from spark_rapids_jni_tpu_torch.runtime import resource

import torch_parity  # noqa: F401  (one torch thread per test process)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture
def injector(tmp_path):
    """Install around each test; always restore and deactivate."""
    cfg_path = tmp_path / "faultinj.json"
    pl.plan_cache_clear()

    def arm(cfg):
        cfg_path.write_text(json.dumps(cfg))
        fp.install(str(cfg_path))

    yield arm
    fp.uninstall()
    fi.reset()
    pl.plan_cache_clear()


def _raises_like_jax(name):
    """The port's class of the JAX case's exception (same name)."""
    assert hasattr(jfi, name)
    return pytest.raises(getattr(fi, name))


def _user_program(scale=2):
    """An arbitrary user chain, not part of the library's façade; the
    Pipeline runs it as one program."""
    return Pipeline(f"user_x{scale}").map(
        lambda t: Table([Column(INT64, t.columns[0].data * scale + 1)]))


def _ones(n):
    return Table([Column.from_numpy(np.ones(n, np.int64), INT64, device="cpu")])


def test_execute_fault_hits_foreign_program(injector):
    injector({"opFaults": {"pjrt.execute": {"injectionType": 1, "percent": 100}}})
    with _raises_like_jax("DeviceAssertError"):
        _user_program().run(_ones(4))


def test_compile_fault_is_fatal_class(injector):
    injector({"opFaults": {"pjrt.compile": {"injectionType": 0, "percent": 100}}})
    # install forgot the loaded libraries: fetching one re-enters the seam
    with _raises_like_jax("FatalDeviceError"):
        _build.load("jcudf_rows")


def test_transfer_fault_substitutes_status(injector):
    injector({"opFaults": {"pjrt.transfer": {
        "injectionType": 2, "percent": 100, "substituteReturnCode": 700}}})
    x = torch.ones(2)
    assert x.to(torch.float64).dtype == torch.float64  # same device: no transfer
    with _raises_like_jax("InjectedStatusError") as ei:
        x.to("meta")
    assert ei.value.code == 700


def test_interception_budget_then_recovers(injector):
    injector({"opFaults": {"pjrt.execute": {
        "injectionType": 1, "percent": 100, "interceptionCount": 2}}})
    prog = _user_program()
    failures = 0
    for _ in range(4):
        try:
            prog.run(_ones(3))
        except fi.DeviceAssertError:
            failures += 1
    assert failures == 2  # budget exhausted, later calls succeed
    assert prog.run(_ones(3)).columns[0].to_pylist() == [3, 3, 3]


def test_uninstall_restores_clean_execution(injector):
    injector({"opFaults": {"pjrt.execute": {"injectionType": 1, "percent": 100}}})
    prog = _user_program()
    with _raises_like_jax("DeviceAssertError"):
        prog.run(_ones(2))
    fp.uninstall()
    fi.reset()
    assert prog.run(_ones(2)).columns[0].to_pylist() == [3, 3]


def test_zero_percent_never_fires(injector):
    injector({"opFaults": {"pjrt.execute": {"injectionType": 1, "percent": 0}}})
    prog = _user_program()
    for _ in range(5):
        prog.run(_ones(2))


# -- beyond the JAX cases


def test_fault_armed_on_one_thread_hits_another(injector):
    armed = threading.Thread(target=injector, args=({"opFaults": {"pjrt.transfer": {
        "injectionType": 2, "percent": 100, "substituteReturnCode": 701}}},))
    armed.start()
    armed.join()
    caught = []

    def cross():
        try:
            torch.zeros(3).to("meta")
        except fi.InjectedStatusError as e:
            caught.append(e.code)

    worker = threading.Thread(target=cross)
    worker.start()
    worker.join()
    assert caught == [701]


def test_uninstall_restores_every_attribute_by_identity(tmp_path):
    seams = fp.patched_attributes()
    assert len(seams) == 9
    before = [(getattr(o, n), n in vars(o)) for o, n in seams]
    cfg = tmp_path / "f.json"
    cfg.write_text(json.dumps({"opFaults": {}}))
    prior = os.environ.get("FAULT_INJECTOR_CONFIG_PATH")
    fp.install(str(cfg))
    fp.install(str(cfg))  # idempotent: patches stay put, not doubled
    try:
        assert all(getattr(o, n) is not b for (o, n), (b, _) in zip(seams, before))
        assert os.environ["FAULT_INJECTOR_CONFIG_PATH"] == str(cfg)
    finally:
        fp.uninstall()
        fp.uninstall()
        fi.reset()
    assert [(getattr(o, n), n in vars(o)) for o, n in seams] == before
    assert all(getattr(o, n) is b for (o, n), (b, _) in zip(seams, before))
    assert os.environ.get("FAULT_INJECTOR_CONFIG_PATH") == prior


def test_retry_oom_at_execute_is_retried_in_a_task(injector):
    rng = np.random.default_rng(42)
    tables = [chip_smoke.q1_table(chip_smoke.q1_batch_arrays(rng, 512), "cpu")
              for _ in range(2)]
    want = [chip_smoke.q1_rows(chip_smoke.q1_pipeline("q1_clean").run(t)) for t in tables]
    pl.plan_cache_clear()
    injector({"opFaults": {"pjrt.execute": {
        "injectionType": "retry_oom", "skipCount": 1, "interceptionCount": 1}}})
    with resource.task() as task:
        got = [chip_smoke.q1_rows(chip_smoke.q1_pipeline("q1_injected").run(t))
               for t in tables]
    assert got == want
    assert task.metrics.injected_ooms == 1 and task.metrics.retries >= 1
    # outside a task scope the same fault reaches the caller
    injector({"opFaults": {"pjrt.execute": {"injectionType": "retry_oom",
                                            "interceptionCount": 1}}})
    with pytest.raises(fi.RetryOOMInjected):
        chip_smoke.q1_pipeline("q1_unscoped").run(tables[0])
