"""Execution-strategy knob for the string scan family (regex + JSON):
the port's twin of the JAX package's ``ops/_strategy.py``, with the
same environment names, so one setting drives both packages.

- ``SPARK_JNI_TPU_SCAN_STRATEGY`` = ``auto`` (default) | ``monoid`` |
  ``serial``. ``auto`` and ``monoid`` run the log-depth transition-
  monoid scans; ``serial`` forces the retained length-serial walks (the
  from_json grammar's kind-stack and token-NFA walk). Both give the
  same results.
- ``SPARK_JNI_TPU_MONOID_MAX_STATES`` (default 64): the ``auto``
  state-count threshold for compiled regex DFAs.
- ``SPARK_JNI_TPU_SCAN_BATCH`` = ``on`` (default) | ``off``: the
  batched scan lifts of regexp_extract.

``set_scan_strategy()`` / ``set_scan_batching()`` override the
environment in-process; the per-context setters override both for the
current context only (a serving session's knobs never leak into
another tenant's slice of a shared thread).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional

STRATEGY_ENV = "SPARK_JNI_TPU_SCAN_STRATEGY"
MAX_STATES_ENV = "SPARK_JNI_TPU_MONOID_MAX_STATES"
BATCH_ENV = "SPARK_JNI_TPU_SCAN_BATCH"
_STRATEGIES = ("auto", "monoid", "serial")
_BATCH_MODES = ("on", "off")
DEFAULT_MONOID_MAX_STATES = 64

_override: Optional[str] = None
_batch_override: Optional[bool] = None
# per-context overrides, resolved before the process overrides
_ctx_strategy: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "sprt_scan_strategy", default=None
)
_ctx_batching: "contextvars.ContextVar[Optional[bool]]" = contextvars.ContextVar(
    "sprt_scan_batching", default=None
)


def _check_strategy(strategy: Optional[str]) -> None:
    if strategy is not None and strategy.strip().lower() not in _STRATEGIES:
        raise ValueError(f"scan strategy {strategy!r}: expected one of {_STRATEGIES}")


def set_context_scan_strategy(strategy: Optional[str]) -> None:
    """Set (or clear, with None) the current context's strategy
    override."""
    _check_strategy(strategy)
    _ctx_strategy.set(strategy)


def set_context_scan_batching(on: Optional[bool]) -> None:
    """Per-context twin of ``set_scan_batching``."""
    _ctx_batching.set(None if on is None else bool(on))


def scan_strategy() -> str:
    """Resolved strategy: the context override, else the in-process
    override, else the environment, else ``auto``."""
    ctx = _ctx_strategy.get()
    if ctx is not None:
        s = ctx
    elif _override is not None:
        s = _override
    else:
        s = os.environ.get(STRATEGY_ENV, "auto")
    s = s.strip().lower()
    if s not in _STRATEGIES:
        raise ValueError(f"{STRATEGY_ENV}={s!r}: expected one of {_STRATEGIES}")
    return s


def set_scan_strategy(strategy: Optional[str]) -> None:
    """Override (or clear, with None) the strategy in-process."""
    global _override
    _check_strategy(strategy)
    _override = strategy


def scan_batching() -> bool:
    """Whether the batched scan lifts run (default on). A malformed
    environment value raises."""
    ctx = _ctx_batching.get()
    if ctx is not None:
        return ctx
    if _batch_override is not None:
        return _batch_override
    raw = os.environ.get(BATCH_ENV, "on").strip().lower()
    if raw not in _BATCH_MODES:
        raise ValueError(f"{BATCH_ENV}={raw!r}: expected one of {_BATCH_MODES}")
    return raw == "on"


def set_scan_batching(on: Optional[bool]) -> None:
    """Override (or clear, with None) the batching knob in-process."""
    global _batch_override
    _batch_override = None if on is None else bool(on)


def monoid_max_states() -> int:
    """The ``auto`` DFA state-count threshold. A malformed environment
    value raises rather than quietly pinning patterns to the wrong
    strategy."""
    raw = os.environ.get(MAX_STATES_ENV, "").strip()
    if not raw:
        return DEFAULT_MONOID_MAX_STATES
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{MAX_STATES_ENV}={raw!r}: expected an integer state count"
        ) from None


# inside a fused Pipeline chain (runtime/pipeline.py) every stage runs
# with no host sync: the ops take the forms the JAX package's take under
# jit — a pinned width is counted by the chain instead of checked here,
# all-valid masks stay masks, payload sizes are capacities, and a sort
# orders by every word instead of reading which ones vary
_ctx_fused: "contextvars.ContextVar[bool]" = contextvars.ContextVar("sprt_fused", default=False)


def fused() -> bool:
    """True inside a fused Pipeline chain: ops must not sync the host."""
    return _ctx_fused.get()


@contextlib.contextmanager
def fusing():
    """Run the enclosed ops in their sync-free (fused chain) forms."""
    tok = _ctx_fused.set(True)
    try:
        yield
    finally:
        _ctx_fused.reset(tok)
