"""Fault injection shim at the op boundary (the port's copy of the JAX
package's ``runtime/faultinj.py``): the reference faultinj
tool rebuilt at the operator entry.

The reference ships ``libcufaultinj.so``: a CUPTI subscriber loaded via
``CUDA_INJECTION64_PATH`` that intercepts every CUDA Runtime/Driver API
exit and, per a JSON config (``FAULT_INJECTOR_CONFIG_PATH``), injects a
PTX trap (fatal), a device assert, or a substituted return code —
probabilistically, with per-rule interception budgets and inotify-based
dynamic config reload (reference: src/main/cpp/faultinj/faultinj.cu
InitializeInjection:487-506, callback:154-341, dynamicReconfig:429-476;
config schema faultinj/README.md:60-141). Its purpose is testing the
fault-tolerance of the stack above: fatal-vs-retryable classification.

Here the narrowest program-visible boundary is the operator entry (the
analog of a CUDA API call from the plugin's perspective), so the shim
intercepts there:

- activation: ``FAULT_INJECTOR_CONFIG_PATH`` env var, read lazily at
  the first interception (the import-time analog of the driver loading
  the .so),
- config schema mirrors the reference: ``opFaults`` maps an op name or
  ``"*"`` to {``injectionType``, ``percent``, ``interceptionCount``,
  ``substituteReturnCode``}; top-level ``seed``, ``dynamic``,
  ``logLevel``,
- injection types: 0 -> FatalDeviceError (PTX-trap analog: the device
  is presumed unusable), 1 -> DeviceAssertError (device assert analog:
  the program failed, device survives), 2 -> InjectedStatusError
  carrying ``substituteReturnCode`` (status-substitution analog),
  3 (or the name ``"retry_oom"``) -> RetryOOMInjected (RmmSpark
  forceRetryOOM analog: a synthetic retryable OOM that exercises the
  resource manager's retry state machine, runtime/resource.py);
  ``injectionType`` accepts the symbolic names "fatal" / "assert" /
  "status" / "retry_oom" as well as the numeric codes, and an optional
  ``skipCount`` skips the first N matching interceptions so the Nth
  invocation can be targeted,
- dynamic reload: config file mtime is re-checked on interception when
  ``dynamic`` is true (same observable semantics as the reference's
  inotify thread, without a thread).

Ops call ``inject_point("Class.method")`` on entry; the fast path when
no config is active is one module-global ``is None`` check.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
from typing import Optional

_ENV_VAR = "FAULT_INJECTOR_CONFIG_PATH"
_LOG = logging.getLogger("spark_rapids_jni_tpu_torch.faultinj")

FATAL = 0  # PTX trap analog
ASSERT = 1  # device assert analog
STATUS = 2  # return-code substitution analog
RETRY_OOM = 3  # retryable OOM analog (RmmSpark.forceRetryOOM)

# config may name types symbolically; numeric codes stay the reference's
# sprtcheck: guarded-by=frozen
_TYPE_NAMES = {
    "fatal": FATAL,
    "assert": ASSERT,
    "status": STATUS,
    "retry_oom": RETRY_OOM,
}
_TYPE_TO_NAME = {v: k for k, v in _TYPE_NAMES.items()}  # sprtcheck: guarded-by=frozen


class FatalDeviceError(RuntimeError):
    """Injected fatal fault: treat the device as unusable (the PTX-trap
    class of errors, faultinj README: 'Fatal errors leaving a GPU in
    unusable state')."""


class DeviceAssertError(RuntimeError):
    """Injected device-assert fault: the computation failed but the
    device remains usable; retry is legitimate."""


class InjectedStatusError(RuntimeError):
    """Injected substituted error status (reference injectionType 2)."""

    def __init__(self, op: str, code: int):
        super().__init__(f"injected status {code} at {op}")
        self.code = code


class RetryOOMInjected(MemoryError):
    """Injected retryable OOM (injectionType 3 / ``"retry_oom"``): the
    analog of RmmSpark.forceRetryOOM — the op did not really run out of
    capacity, but the resource manager must behave as if it had, so the
    retry state machine is exercisable from the faultinj config schema.
    ``runtime/resource.py`` executors catch this and re-plan; outside a
    resource scope it propagates like any injected fault."""

    def __init__(self, op: str):
        super().__init__(f"injected retryable OOM at {op}")
        self.op = op


class _Rule:
    __slots__ = ("injection_type", "percent", "budget", "code", "skip")

    def __init__(self, spec: dict):
        itype = spec.get("injectionType", FATAL)
        if isinstance(itype, str):
            if itype.lower() not in _TYPE_NAMES:
                # must not leak a KeyError into an intercepted op on a
                # dynamic reload; _load drops the rule with a warning
                raise ValueError(
                    f"unknown injectionType {itype!r} "
                    f"(expected one of {sorted(_TYPE_NAMES)})"
                )
            itype = _TYPE_NAMES[itype.lower()]
        self.injection_type = int(itype)
        self.percent = float(spec.get("percent", 100))
        # None = unlimited (reference: absent interceptionCount)
        cnt = spec.get("interceptionCount")
        self.budget = None if cnt is None else int(cnt)
        self.code = int(spec.get("substituteReturnCode", 999))
        # extension over the reference schema: skip the first N matching
        # interceptions before injecting, so "fault the Nth invocation"
        # (e.g. fail only the retry, or only the first attempt) is
        # expressible — RmmSpark.forceRetryOOM's skipCount argument
        self.skip = int(spec.get("skipCount", 0))


class FaultInjector:
    """Parsed config + interception state (thread-safe budgets)."""

    def __init__(self, path: str):
        self.path = path
        self.lock = threading.Lock()
        self.mtime = 0.0
        self.dynamic = False
        self.rules = {}
        self.rng = random.Random()
        self._load()

    def _load(self):
        try:
            st = os.stat(self.path)
            with open(self.path) as f:
                cfg = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            _LOG.warning("fault injection config unreadable: %s", e)
            self.rules = {}
            # keep reload armed: a partially-written config must not
            # freeze the injector for the process lifetime (the
            # reference's inotify loop re-reads on the next modify,
            # faultinj.cu:429-476); mtime is left stale so a fixed
            # file triggers _maybe_reload
            self.dynamic = True
            return
        self.mtime = st.st_mtime
        self.dynamic = bool(cfg.get("dynamic", False))
        if "logLevel" in cfg:
            _LOG.setLevel(int(cfg["logLevel"]) * 10)
        self.rng = random.Random(cfg.get("seed"))
        self.rules = {}
        for name, spec in cfg.get("opFaults", {}).items():
            try:
                self.rules[name] = _Rule(spec)
            except (TypeError, ValueError) as e:
                # tolerate one bad rule the way a wholly-unreadable
                # config is tolerated: warn and keep going — a typo'd
                # injectionType must not crash intercepted workloads
                _LOG.warning("dropping fault rule %s: %s", name, e)
        _LOG.info(
            "fault injection config loaded: %d rules, dynamic=%s",
            len(self.rules),
            self.dynamic,
        )

    def _maybe_reload(self):
        if not self.dynamic:
            return
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return
        if mtime != self.mtime:
            _LOG.info("fault injection config changed; reloading")
            self._load()

    def intercept(self, op: str):
        with self.lock:
            self._maybe_reload()
            rule = self.rules.get(op) or self.rules.get("*")
            if rule is None:
                return
            if rule.budget is not None and rule.budget <= 0:
                return
            if self.rng.uniform(0, 100) >= rule.percent:
                return
            if rule.skip > 0:
                rule.skip -= 1
                return
            if rule.budget is not None:
                rule.budget -= 1
            itype, code = rule.injection_type, rule.code
        # journal the injection (runtime/events.py): fault-tolerance
        # test runs get a structured record of every fault they took,
        # stamped with the causal span current at the injection site
        # (runtime/spans.py — an injected fault inside a retry round
        # chains to that round, its run_plan, and its task). The log
        # line carries the same identity for non-journal consumers.
        # Out-of-range numeric types fall through to the status error
        # below; the name lookup must tolerate them too.
        from . import events as _events
        from . import metrics as _metrics
        from . import spans as _spans

        sid, _parent, task_id = _spans.current_ids()
        _LOG.error(
            "injecting fault type %d at %s (span %d, task %s)",
            itype, op, sid, task_id,
        )

        type_name = _TYPE_TO_NAME.get(itype, "status")
        _metrics.counter("faultinj.injected").inc()
        _metrics.counter(f"faultinj.type.{type_name}").inc()
        _events.emit(
            "injected_fault",
            op=op,
            type=itype,
            type_name=type_name,
            **({"code": code} if itype not in (FATAL, ASSERT, RETRY_OOM) else {}),
        )
        if itype == FATAL:
            raise FatalDeviceError(f"injected fatal fault at {op}")
        if itype == ASSERT:
            raise DeviceAssertError(f"injected device assert at {op}")
        if itype == RETRY_OOM:
            raise RetryOOMInjected(op)
        raise InjectedStatusError(op, code)


_injector: Optional[FaultInjector] = None
_checked_env = False


def inject_point(op: str) -> None:
    """Interception hook; no-op unless FAULT_INJECTOR_CONFIG_PATH is set."""
    global _injector, _checked_env
    if _injector is None:
        if _checked_env:
            return
        path = os.environ.get(_ENV_VAR)
        _checked_env = True
        if not path:
            return
        _injector = FaultInjector(path)
    _injector.intercept(op)


def reset() -> None:
    """Drop injector state (tests; also lets a long-lived process pick
    up a newly set env var)."""
    global _injector, _checked_env
    _injector = None
    _checked_env = False
