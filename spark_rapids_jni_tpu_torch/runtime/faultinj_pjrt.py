"""Runtime-boundary fault injection: the CUPTI-intercept analog (the
port's counterpart of the JAX package's ``runtime/faultinj_pjrt.py``).

The reference's injector is loaded by the CUDA *driver*
(``CUDA_INJECTION64_PATH``) and sees every CUDA API exit in the process
— including launches from code the library never authored
(reference: src/main/cpp/faultinj/faultinj.cu:121-133,154-341). The
op-boundary shim (runtime/faultinj.py) only hooks this library's
facade. This module hooks the boundary every program of the port
crosses, under the JAX package's op names, so one
``FAULT_INJECTOR_CONFIG_PATH`` file arms either package:

- ``pjrt.compile``  — an executable is created or fetched: a native
  library build or load (``kernels/_build.build``, which every load
  that misses the loaded set calls) and any CUDA graph capture
  (``torch.cuda.CUDAGraph.capture_begin``, a Pipeline plan's among
  them). ``install`` forgets the loaded libraries, so each is fetched
  again through the seam, as the JAX injector clears its caches;
- ``pjrt.execute``  — a program is dispatched: every launch of a
  hand-written kernel (``kernels/murmur3._launch``), every
  ``torch.cuda.CUDAGraph.replay`` (a foreign graph's too), and every
  eager run of a Pipeline plan (``runtime/pipeline._EagerProgram``,
  the plan's form on a device without graphs);
- ``pjrt.transfer`` — data moves between devices: ``Tensor.to``,
  ``Tensor.cuda``, ``Tensor.cpu`` and ``Tensor.copy_`` when the source
  and target devices differ (the pinned staging of
  ``columnar/interop.py`` goes through ``Tensor.to``).

Every seam is a class or module attribute, so it holds in every thread
of the process (the scan's decode threads, the serving dispatch
thread); a ``TorchDispatchMode`` would hold only in the thread that
entered it. ``uninstall`` puts each attribute back as it was, by
identity (an inherited one by deleting the override). Eager aten ops
that cross none of these seams are not intercepted: the JAX injector
sees every eager op, because each is a jitted primitive there.

Rules, probabilities, budgets and dynamic reload are the op-boundary
injector's (runtime/faultinj.py): target the ops above by name or with
``"*"``. injectionType 0 -> FatalDeviceError, 1 -> DeviceAssertError,
2 -> InjectedStatusError (``substituteReturnCode``), 3 ->
RetryOOMInjected, which a task scope's retry driver retries.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from . import faultinj as _fi

COMPILE = "pjrt.compile"
EXECUTE = "pjrt.execute"
TRANSFER = "pjrt.transfer"

# install()/uninstall() are check-then-act on _installed and swap class
# and module attributes that every thread reads: two concurrent installs
# could save an already-patched hook into _saved and make uninstall
# restore the PATCHED function. One lock serializes the whole transition.
_install_lock = threading.Lock()
_installed = False
# (owner, attribute) -> the owner's own entry before install, or _ABSENT
# sprtcheck: guarded-by=_install_lock
_saved = {}
_ABSENT = object()


def _moves(src: torch.device, target) -> bool:
    """Whether a tensor on ``src`` sent to ``target`` (a device, a
    string, a CUDA index or a tensor; None: no device named) changes
    device."""
    if target is None:
        return False
    if isinstance(target, torch.Tensor):
        target = target.device
    elif isinstance(target, int):
        target = torch.device("cuda", target)
    else:
        target = torch.device(target)
    if target.type != src.type:
        return True
    return target.index is not None and src.index is not None and target.index != src.index


def _to_target(args, kwargs):
    """The device a ``Tensor.to`` call names, or None."""
    if "device" in kwargs:
        return kwargs["device"]
    if args and isinstance(args[0], (str, torch.device, int, torch.Tensor)):
        return args[0]
    return None


def _seams():
    """[(owner, attribute, make_hook)]: each hook wraps the attribute's
    current value."""
    from ..kernels import _build, murmur3
    from . import pipeline

    def fire_then(op, orig):
        def hook(*args, **kwargs):
            _fi.inject_point(op)
            return orig(*args, **kwargs)

        return hook

    def to_hook(orig):
        def to(self, *args, **kwargs):
            if _moves(self.device, _to_target(args, kwargs)):
                _fi.inject_point(TRANSFER)
            return orig(self, *args, **kwargs)

        return to

    def cuda_hook(orig):
        def cuda(self, device=None, *args, **kwargs):
            if _moves(self.device, "cuda" if device is None else device):
                _fi.inject_point(TRANSFER)
            return orig(self, device, *args, **kwargs)

        return cuda

    def cpu_hook(orig):
        def cpu(self, *args, **kwargs):
            if self.device.type != "cpu":
                _fi.inject_point(TRANSFER)
            return orig(self, *args, **kwargs)

        return cpu

    def copy_hook(orig):
        def copy_(self, src, *args, **kwargs):
            if isinstance(src, torch.Tensor) and _moves(self.device, src.device):
                _fi.inject_point(TRANSFER)
            return orig(self, src, *args, **kwargs)

        return copy_

    graph = torch.cuda.CUDAGraph
    return [
        (_build, "build", lambda f: fire_then(COMPILE, f)),
        (graph, "capture_begin", lambda f: fire_then(COMPILE, f)),
        (murmur3, "_launch", lambda f: fire_then(EXECUTE, f)),
        (graph, "replay", lambda f: fire_then(EXECUTE, f)),
        (pipeline._EagerProgram, "__call__", lambda f: fire_then(EXECUTE, f)),
        (torch.Tensor, "to", to_hook),
        (torch.Tensor, "cuda", cuda_hook),
        (torch.Tensor, "cpu", cpu_hook),
        (torch.Tensor, "copy_", copy_hook),
    ]


def patched_attributes():
    """[(owner, attribute)] of every seam ``install`` patches."""
    return [(owner, name) for owner, name, _ in _seams()]


def install(config_path: Optional[str] = None) -> None:
    """Patch the port's runtime seams; idempotent and thread-safe
    (``_install_lock`` serializes the whole transition). ``config_path``
    overrides FAULT_INJECTOR_CONFIG_PATH for the shared injector."""
    global _installed
    import os

    with _install_lock:
        if _installed:
            if config_path is not None:
                # re-arm with the new rules; runtime patches stay put
                os.environ["FAULT_INJECTOR_CONFIG_PATH"] = config_path
                _fi.reset()
            return

        from ..kernels import _build

        _saved["env_config"] = os.environ.get("FAULT_INJECTOR_CONFIG_PATH")
        if config_path is not None:
            os.environ["FAULT_INJECTOR_CONFIG_PATH"] = config_path
            _fi.reset()
        for owner, name, make in _seams():
            own = vars(owner).get(name, _ABSENT)
            _saved[(owner, name)] = own
            setattr(owner, name, make(getattr(owner, name)))
        # loaded libraries must be fetched again through the seam
        _build.forget_loaded()
        _installed = True


def uninstall() -> None:
    """Restore every patched attribute exactly; idempotent and
    thread-safe (same ``_install_lock`` as ``install``)."""
    global _installed
    import os

    with _install_lock:
        if not _installed:
            return
        # restore the config env var so the lazy op-boundary injector
        # does not re-arm from leftover rules after uninstall
        prior = _saved.pop("env_config", None)
        if prior is None:
            os.environ.pop("FAULT_INJECTOR_CONFIG_PATH", None)
        else:
            os.environ["FAULT_INJECTOR_CONFIG_PATH"] = prior
        _fi.reset()
        for (owner, name), own in _saved.items():
            if own is _ABSENT:
                delattr(owner, name)
            else:
                setattr(owner, name, own)
        _saved.clear()
        _installed = False
