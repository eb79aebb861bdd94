"""Dispatch-path sync freedom for torch code (the port's counterpart of
the JAX package's ``rules/dispatch_purity.py``).

``Pipeline.stream``, the mesh executors' cached programs and the
serving loop keep their DISPATCH stage free of host syncs: the plan
lookup, the graph replay or the eager chain enqueue device work and
return; the one host transfer waits in retirement. A sync on that path
serializes the stream window. This rule makes the contract checkable on
torch code:

- every function of the analyzed module is classified SYNCING or
  sync-free. Direct sync sites (``pyast.sync_site`` /
  ``implicit_bool_site``): ``torch.cuda.synchronize`` and any
  ``.synchronize()`` (a stream, an ``Event``); ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()`` / ``bool()`` /
  ``float()`` and ``np.asarray()`` on a device-derived value;
  ``torch.nonzero`` / ``unique`` / ``masked_select`` (and their kin),
  which sync for their output size; a branch, loop test or assert on a
  device value;
- sync-ness propagates through the MODULE-LOCAL call graph (bare-name
  calls, ``self.``/``cls.`` methods of the enclosing class, the callable
  a ``functools.partial`` wraps), as the JAX rule's does;
- a function annotated ``# sprtcheck: dispatch-path`` must classify
  sync-free; the finding names the call chain down to the sync site.

A deliberate sync reachable from a dispatch path carries
``# sprtcheck: disable=dispatch-sync-free`` at the sync site with its
reason; the site then no longer classifies its function as syncing.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from ..core import rule
from ..pyast import (
    collect_functions,
    device_tainted_names,
    func_annotation,
    implicit_bool_site,
    local_callees,
    sync_site,
    walk_shallow,
)

DISPATCH_RE = re.compile(r"#\s*sprtcheck:\s*dispatch-path\b")


@rule(
    "dispatch-sync-free",
    "a `# sprtcheck: dispatch-path` function reaches a host sync on a "
    "torch value",
    "the dispatch stage of the stream, the mesh programs and the "
    "serving loop must only enqueue: a .item() / .cpu() / nonzero / "
    "synchronize there waits for every chunk in flight and serializes "
    "the window (the JAX package measured 0.80x of serial for one "
    "such sync).",
)
def dispatch_sync_free(mod):
    if "dispatch-path" not in mod.text:
        return  # annotation-driven rule

    funcs, by_name, by_method = collect_functions(mod.tree)
    direct: Dict[ast.FunctionDef, Tuple[str, int]] = {}
    edges: Dict[ast.FunctionDef, List[ast.FunctionDef]] = {}
    for fn, cls in funcs:
        tainted = device_tainted_names(fn)
        callees: List[ast.FunctionDef] = []
        for node in walk_shallow(fn):
            desc = implicit_bool_site(node, tainted)
            if desc is None and isinstance(node, ast.Call):
                desc = sync_site(node, tainted)
                if desc is None:
                    callees.extend(local_callees(node, cls, by_name, by_method))
            if desc is not None and not mod.suppressed("dispatch-sync-free", node.lineno):
                direct.setdefault(fn, (desc, node.lineno))
        edges[fn] = callees

    # reach[fn] = (callee chain, sync description, sync line); a
    # function is assigned at most once, so cycles terminate
    reach: Dict[ast.FunctionDef, Tuple[List[str], str, int]] = {
        fn: ([], desc, line) for fn, (desc, line) in direct.items()
    }
    changed = True
    while changed:
        changed = False
        for fn, _cls in funcs:
            if fn in reach:
                continue
            for callee in edges[fn]:
                if callee in reach:
                    via, desc, line = reach[callee]
                    reach[fn] = ([callee.name] + via, desc, line)
                    changed = True
                    break

    for fn, _cls in funcs:
        if not func_annotation(mod, fn, DISPATCH_RE):
            continue
        hit = reach.get(fn)
        if hit is None:
            continue
        via, desc, line = hit
        path = " -> ".join([fn.name] + via)
        yield mod.finding(
            "dispatch-sync-free",
            fn,
            f"dispatch-path `{fn.name}` reaches a host sync: {path} -> {desc} at line "
            f"{line} — the dispatch stage must only enqueue",
        )
