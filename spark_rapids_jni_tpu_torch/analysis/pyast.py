"""Shared AST helpers of the port's sprtcheck rules: the torch taint
model.

A value is *device-derived* when it comes from a ``torch.*`` tensor
factory or op, from a method of a device-derived value (``x.sum()``,
``x.to(...)``), from a column's tensor fields (``.data``,
``.validity``, ``.offsets``, ``.validity_or_true()``: device tensors by
the columnar contract, ``columnar/column.py``), or from a parameter
annotated ``torch.Tensor``. Metadata stays host:
``.shape``, ``.dtype``, ``.device``, ``len(x)``, ``x.numel()`` and the
``torch.cuda`` / dtype queries never read device memory.

The model is one function at a time, as the JAX package's is (its
``analysis/pyast.py`` taints ``jnp``/``lax`` results); the call-graph
helpers let the dispatch rule follow module-local calls.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

ARRAY_ROOT = "torch"

# torch entry points that are metadata or runtime control, not device
# computation
METADATA_FNS = {
    "device", "dtype", "Size", "iinfo", "finfo", "is_tensor", "is_floating_point",
    "is_complex", "get_default_dtype", "promote_types", "result_type", "can_cast",
    "no_grad", "inference_mode", "enable_grad", "set_num_threads", "get_num_threads",
    "manual_seed", "Generator",
}
# torch namespaces that hold no tensor ops (streams, events, graphs,
# profiling, process groups)
METADATA_NAMESPACES = {
    ("torch", "cuda"), ("torch", "backends"), ("torch", "distributed"),
    ("torch", "profiler"), ("torch", "autograd"), ("torch", "utils"),
    ("torch", "library"), ("torch", "testing"),
}

# the columnar contract: these fields and methods of a Column hold
# device tensors
TENSOR_FIELDS = {"data", "validity", "offsets"}
TENSOR_METHODS = {"validity_or_true"}

# attribute reads that are host metadata of a tensor (or a table)
STATIC_ATTRS = {
    "shape", "dtype", "ndim", "device", "is_cuda", "layout", "requires_grad",
    "num_rows", "num_columns", "is_varlen", "itemsize", "nbytes", "columns",
}
# tensor methods that return host metadata without reading the data
STATIC_METHODS = {
    "size", "dim", "numel", "nelement", "element_size", "stride", "is_contiguous",
    "data_ptr", "get_device", "storage_offset", "is_pinned", "is_floating_point",
    "is_complex", "is_signed",
}
# calls whose result is static regardless of argument taint
_STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "type", "id"}
# calls that copy a device value to the host: the result is a host
# value, so taint stops there (the sync site itself is what the rules
# report)
SYNC_CASTS = {"bool", "int", "float"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# ops whose output size is data-dependent: the host waits for the
# device to learn it
SIZE_SYNC_FNS = {"nonzero", "argwhere", "unique", "unique_consecutive", "masked_select"}

_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """('torch', 'cuda', 'synchronize') for torch.cuda.synchronize; None
    if not a plain Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def is_array_api_call(node: ast.AST) -> bool:
    """A call into torch's tensor API: ``torch.*(...)``, metadata and
    runtime-control entries excluded."""
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    if not chain or len(chain) < 2 or chain[0] != ARRAY_ROOT:
        return False
    if chain[-1] in METADATA_FNS or chain[:2] in METADATA_NAMESPACES:
        return False
    return True


def is_tensor_field(node: ast.AST) -> bool:
    """A column's tensor field (``col.data``) or ``col.validity_or_true()``."""
    if isinstance(node, ast.Attribute) and node.attr in TENSOR_FIELDS:
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in TENSOR_METHODS
    )


def expr_names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def functions(tree: ast.AST) -> Iterable[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def walk_shallow(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested function /
    lambda bodies (each nested function is analyzed on its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def walk_dynamic(e: ast.AST) -> Iterable[ast.AST]:
    """Walk an expression, skipping subtrees that read no device data:
    metadata attributes and methods, ``len(x)``-style calls, host copies
    (their result is a host value), numpy calls (host data), ``is
    (not) None`` and membership tests. Comprehensions are not descended
    into — ``dynamic_expr_tainted`` handles their scoping."""
    stack = [e]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            continue
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in (_STATIC_CALLS | SYNC_CASTS):
                continue
            if isinstance(f, ast.Attribute) and f.attr in (
                STATIC_ATTRS | STATIC_METHODS | SYNC_METHODS
            ):
                continue
            chain = attr_chain(f)
            if chain and chain[0] in ("np", "numpy"):
                continue
        if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops
        ):
            continue
        yield node
        if not isinstance(node, _COMPREHENSIONS):
            stack.extend(ast.iter_child_nodes(node))


def dynamic_expr_tainted(e: ast.AST, tainted: Set[str]) -> bool:
    """True when the dynamic part of the expression reads a device
    value: a torch call, a column's tensor field, or a tainted name.
    Comprehension targets shadow enclosing bindings."""
    for node in walk_dynamic(e):
        if is_array_api_call(node) or is_tensor_field(node):
            return True
        if isinstance(node, ast.Name) and node.id in tainted:
            return True
        if isinstance(node, _COMPREHENSIONS):
            # iterating a container of device values reads no device
            # data: its elements are device-derived, so the targets
            # bound from a device-derived iterable are tainted in the
            # body, and other targets shadow enclosing bindings
            inner = set(tainted)
            for gen in node.generators:
                targets = expr_names(gen.target)
                if dynamic_expr_tainted(gen.iter, inner):
                    inner |= targets
                else:
                    inner -= targets
            parts = [node.key, node.value] if isinstance(node, ast.DictComp) else [node.elt]
            parts += [i for gen in node.generators for i in gen.ifs]
            if any(dynamic_expr_tainted(p, inner) for p in parts):
                return True
    return False


def _store_names(t: ast.AST) -> Iterable[str]:
    """Names a store-target binds (``x[i] = v`` stores into ``x``)."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _store_names(e)
    elif isinstance(t, ast.Starred):
        yield from _store_names(t.value)
    elif isinstance(t, (ast.Subscript, ast.Attribute)):
        yield from _store_names(t.value)


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    chain = attr_chain(ann) if ann is not None else None
    if chain is None and isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        chain = tuple(ann.value.split("."))
    return chain in (("torch", "Tensor"), ("Tensor",))


def device_tainted_names(fn: ast.FunctionDef) -> Set[str]:
    """Names in ``fn`` bound (possibly transitively) to device-derived
    expressions. A parameter is device-derived when it is annotated
    ``torch.Tensor``; other parameters stay clean (callers may pass host
    values)."""
    args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    tainted: Set[str] = {a.arg for a in args if _is_tensor_annotation(a.annotation)}
    for _ in range(3):  # fixpoint over simple assignments
        before = len(tainted)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and dynamic_expr_tainted(node.value, tainted):
                for t in node.targets:
                    tainted.update(_store_names(t))
            elif isinstance(node, ast.AugAssign) and dynamic_expr_tainted(
                node.value, tainted
            ):
                if isinstance(node.target, ast.Name):
                    tainted.add(node.target.id)
            elif isinstance(node, (ast.AnnAssign, ast.NamedExpr)):
                if node.value is not None and dynamic_expr_tainted(node.value, tainted):
                    if isinstance(node.target, ast.Name):
                        tainted.add(node.target.id)
        if len(tainted) == before:
            break
    return tainted


def sync_site(node: ast.Call, tainted: Set[str]) -> Optional[str]:
    """Description of the host sync this call performs, or None:

    - ``torch.cuda.synchronize()`` and any ``.synchronize()`` (a stream
      or an event);
    - ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, and
      ``int()`` / ``bool()`` / ``float()``, ``np.asarray()`` /
      ``np.array()`` on a device-derived value;
    - ``torch.nonzero`` / ``argwhere`` / ``unique`` /
      ``unique_consecutive`` / ``masked_select`` (as functions or as
      methods of a device value) and one-argument ``torch.where``: the
      host waits for the output size."""
    f = node.func
    chain = attr_chain(f)
    if chain == ("torch", "cuda", "synchronize"):
        return "torch.cuda.synchronize()"
    if isinstance(f, ast.Attribute):
        if f.attr == "synchronize":
            return ".synchronize()"
        if f.attr in SYNC_METHODS and dynamic_expr_tainted(f.value, tainted):
            return f".{f.attr}() on a device value"
    if chain and chain[0] == ARRAY_ROOT and len(chain) == 2:
        if chain[1] in SIZE_SYNC_FNS:
            return f"torch.{chain[1]}() (data-dependent output size)"
        if chain[1] == "where" and len(node.args) == 1 and not node.keywords:
            return "one-argument torch.where() (data-dependent output size)"
    if (
        isinstance(f, ast.Attribute)
        and f.attr in SIZE_SYNC_FNS
        and dynamic_expr_tainted(f.value, tainted)
    ):
        return f".{f.attr}() on a device value (data-dependent output size)"
    if (
        isinstance(f, ast.Name)
        and f.id in SYNC_CASTS
        and node.args
        and dynamic_expr_tainted(node.args[0], tainted)
    ):
        return f"{f.id}() on a device value"
    if (
        chain
        and chain[0] in ("np", "numpy")
        and chain[-1] in ("asarray", "array")
        and node.args
        and dynamic_expr_tainted(node.args[0], tainted)
    ):
        return f"{'.'.join(chain)}() on a device value"
    return None


def implicit_bool_site(node: ast.AST, tainted: Set[str]) -> Optional[str]:
    """Description of an implicit ``bool()`` of a device value (a branch,
    a loop test, an assert or a conditional expression on it), or None."""
    if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
        if dynamic_expr_tainted(node.test, tainted):
            kind = {ast.If: "`if`", ast.While: "`while`", ast.Assert: "`assert`",
                    ast.IfExp: "a conditional expression"}[type(node)]
            return f"{kind} on a device value (an implicit bool())"
    return None


def func_annotation(mod, fn: ast.FunctionDef, regex):
    """Match an annotation attached to a function: on the ``def`` line,
    any decorator line, or anywhere in the contiguous comment block
    directly above the first decorator (or the ``def``)."""
    start = min([d.lineno for d in fn.decorator_list] + [fn.lineno])
    for ln in range(start, fn.lineno + 1):
        if 1 <= ln <= len(mod.lines):
            m = regex.search(mod.lines[ln - 1])
            if m:
                return m
    ln = start - 1
    while 1 <= ln <= len(mod.lines) and mod.lines[ln - 1].lstrip().startswith("#"):
        m = regex.search(mod.lines[ln - 1])
        if m:
            return m
        ln -= 1
    return None


def collect_functions(tree: ast.AST):
    """Every function in the module with its enclosing class name, plus
    the bare-name and (class, method) resolution maps.

    -> (funcs: [(fn, cls)], by_name, by_method)
    """
    funcs: List[Tuple[ast.FunctionDef, Optional[str]]] = []

    def collect(node: ast.AST, cls: Optional[str]):
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, ast.ClassDef):
                collect(ch, ch.name)
            elif isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.append((ch, cls))
                collect(ch, cls)
            else:
                collect(ch, cls)

    collect(tree, None)
    by_name: dict = {}
    by_method: dict = {}
    for fn, cls in funcs:
        by_name.setdefault(fn.name, []).append(fn)
        if cls is not None:
            by_method.setdefault((cls, fn.name), []).append(fn)
    return funcs, by_name, by_method


_PARTIAL_CHAINS = (("partial",), ("functools", "partial"))


def local_callees(node: ast.Call, cls, by_name, by_method) -> List[ast.FunctionDef]:
    """Module-local functions this Call may invoke: bare names,
    ``self.``/``cls.`` methods of the enclosing class, and the callable
    a ``functools.partial(f, ...)`` wraps."""
    f = node.func
    targets: List[ast.AST] = [f]
    if attr_chain(f) in _PARTIAL_CHAINS and node.args:
        targets = [node.args[0]]
    out: List[ast.FunctionDef] = []
    for t in targets:
        if isinstance(t, ast.Name):
            out.extend(by_name.get(t.id, ()))
        elif (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id in ("self", "cls")
            and cls is not None
        ):
            out.extend(by_method.get((cls, t.attr), ()))
    return out
