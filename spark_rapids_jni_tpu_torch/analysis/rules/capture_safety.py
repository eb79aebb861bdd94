"""Graph-capture safety: the torch counterpart of the JAX package's
``tracer-bool`` (``rules/trace_safety.py``).

On the card a Pipeline runs its whole chain as one CUDA graph
(``runtime/pipeline._GraphProgram``). A host sync inside a stage —
``.item()``, ``int()`` of a device value, ``nonzero``, a branch on a
device value — cannot be captured: the capture raises on the card, and
the CPU, which runs no capture, never sees it. Under JAX the same
mistake raised ConcretizationTypeError at trace time on every device.

Scope as the JAX rule's: ops/, parallel/ and runtime/pipeline.py;
``*_host.py`` modules are host-side by contract. The port's ops split
their eager and fused forms explicitly with ``ops/_strategy.fusing()``
/ ``fused()`` (the fused form is sync-free, the eager form may size its
outputs on the host): a function that consults either has made that
split and
is exempt wholesale, as the JAX rule exempts functions that test for a
tracer. A function that runs on the host by contract (an error report,
a collect after the program, the stream's retire half) carries
``# sprtcheck: host-side — <why>`` above its ``def``, as ``*_host.py``
modules are host-side by their name; a single deliberate eager sync
carries ``# sprtcheck: disable=graph-capture-sync — <why>`` at the site.
"""

from __future__ import annotations

import ast
import re

from ..core import rule
from ..pyast import (
    device_tainted_names,
    func_annotation,
    functions,
    implicit_bool_site,
    sync_site,
    walk_shallow,
)

HOST_SIDE_RE = re.compile(r"#\s*sprtcheck:\s*host-side\b")
_SCOPE_DIRS = ("ops", "parallel")
_SCOPE_FILES = ("runtime/pipeline.py",)


def _in_scope(mod) -> bool:
    if mod.parts[-1].endswith("_host.py"):
        return False
    return mod.in_dirs(*_SCOPE_DIRS) or any(mod.rel.endswith(f) for f in _SCOPE_FILES)


_SPLIT_NAMES = {"fusing", "fused"}


def _splits_on_fusing(fn: ast.FunctionDef) -> bool:
    """The eager/fused split idiom: the function reads ``fusing`` or
    ``fused`` (ops/_strategy.py)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id in _SPLIT_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _SPLIT_NAMES:
            return True
    return False


@rule(
    "graph-capture-sync",
    "host sync on a device value in code a Pipeline stage runs (breaks "
    "the CUDA-graph capture on the card)",
    "a Pipeline's chain is captured as one CUDA graph on the card: a "
    ".item(), int() of a device value, nonzero or a branch on a device "
    "value inside it raises at capture; the CPU runs no capture, so "
    "only the card would show it.",
)
def graph_capture_sync(mod):
    if not _in_scope(mod):
        return
    for fn in functions(mod.tree):
        if _splits_on_fusing(fn) or func_annotation(mod, fn, HOST_SIDE_RE):
            continue
        tainted = device_tainted_names(fn)
        for node in walk_shallow(fn):
            desc = implicit_bool_site(node, tainted)
            if desc is None and isinstance(node, ast.Call):
                desc = sync_site(node, tainted)
            if desc is not None:
                yield mod.finding(
                    "graph-capture-sync",
                    node,
                    f"{desc} in `{fn.name}`: a host sync cannot run inside a CUDA graph "
                    "capture — use the sync-free form (torch.where, a static capacity) "
                    "or split on ops/_strategy.fusing()",
                )
