"""The port's fault-injection shim (``runtime/faultinj.py``) against the
JAX package's: the same JSON rule files drive both through their façade
op boundary (``api._instrument``), and the sequence of outcomes — which
call raises which injected error, when a budget or skip count runs out,
what a seeded probability picks, what a dynamic reload changes — must be
equal."""

import json
import os

import pytest

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu.api import CastStrings as JCast
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.runtime import faultinj as jfi

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch.api import CastStrings as PCast
from spark_rapids_jni_tpu_torch.runtime import faultinj as pfi


def jax_op():
    return JCast.toInteger(JColumn.from_pylist(["1", "2"], jd.STRING), False, True, jd.INT32)


def port_op():
    return PCast.toInteger(port.Column.from_pylist(["1", "2"], port.STRING, device="cpu"),
                           False, True, port.INT32)


@pytest.fixture
def rules(tmp_path, monkeypatch):
    path = tmp_path / "faultinj.json"

    def write(cfg):
        path.write_text(json.dumps(cfg))
        os.utime(path)
        jfi.reset()
        pfi.reset()

    monkeypatch.setenv("FAULT_INJECTOR_CONFIG_PATH", str(path))
    yield write
    jfi.reset()
    pfi.reset()


def outcomes(op, fi, n=8):
    """What each of ``n`` calls did: the injected error's class name (and
    status code), or "ok"."""
    out = []
    for _ in range(n):
        try:
            assert op().to_pylist() == [1, 2]
            out.append("ok")
        except (fi.FatalDeviceError, fi.DeviceAssertError, fi.RetryOOMInjected) as e:
            out.append(type(e).__name__)
        except fi.InjectedStatusError as e:
            out.append(f"status:{e.code}")
    return out


RULE_FILES = {
    "fatal": {"opFaults": {"CastStrings.toInteger": {"injectionType": 0}}},
    "assert_wildcard": {"opFaults": {"*": {"injectionType": "assert"}}},
    "status": {"opFaults": {"CastStrings.toInteger": {"injectionType": 2,
                                                      "substituteReturnCode": 42}}},
    "budget": {"opFaults": {"CastStrings.toInteger": {"injectionType": 0,
                                                      "interceptionCount": 3}}},
    "skip": {"opFaults": {"CastStrings.toInteger": {"injectionType": "retry_oom",
                                                    "skipCount": 2,
                                                    "interceptionCount": 2}}},
    "seeded_half": {"seed": 12345, "opFaults": {"CastStrings.toInteger": {
        "injectionType": 1, "percent": 50}}},
    "never": {"opFaults": {"CastStrings.toInteger": {"injectionType": 0, "percent": 0}}},
    "other_op": {"opFaults": {"Regex.rlike": {"injectionType": 0}}},
    "bad_type_dropped": {"opFaults": {"CastStrings.toInteger": {"injectionType": "nope"}}},
}


@pytest.mark.parametrize("name", sorted(RULE_FILES))
def test_rule_file_outcomes_match(rules, name):
    rules(RULE_FILES[name])
    want = outcomes(jax_op, jfi, 12)
    got = outcomes(port_op, pfi, 12)
    assert got == want
    if name == "seeded_half":
        assert "ok" in got and "DeviceAssertError" in got


def test_disabled_without_env(monkeypatch):
    monkeypatch.delenv("FAULT_INJECTOR_CONFIG_PATH", raising=False)
    pfi.reset()
    assert outcomes(port_op, pfi, 2) == ["ok", "ok"]


def test_dynamic_reload_matches(rules, tmp_path):
    rules({"dynamic": True, "opFaults": {}})
    first = (outcomes(jax_op, jfi, 1), outcomes(port_op, pfi, 1))
    path = os.environ["FAULT_INJECTOR_CONFIG_PATH"]
    with open(path, "w") as f:
        json.dump({"dynamic": True, "opFaults": {"CastStrings.toInteger": {"injectionType": 0}}},
                  f)
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 5))
    second = (outcomes(jax_op, jfi, 1), outcomes(port_op, pfi, 1))
    assert first == (["ok"], ["ok"])
    assert second == (["FatalDeviceError"], ["FatalDeviceError"])


def test_unreadable_config_is_noop(rules):
    with open(os.environ["FAULT_INJECTOR_CONFIG_PATH"], "w") as f:
        f.write("{not json")
    jfi.reset()
    pfi.reset()
    assert outcomes(port_op, pfi, 2) == outcomes(jax_op, jfi, 2) == ["ok", "ok"]
