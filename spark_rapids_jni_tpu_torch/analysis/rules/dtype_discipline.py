"""Dtype discipline in the port's device op code (ops/, parallel/): the
counterpart of the JAX package's ``rules/dtype_discipline.py``.

torch's implicit float dtype is float32: a dtype-less ``torch.zeros(n)``
or ``torch.tensor([0.5, 1.0])`` allocates float32. Spark DOUBLE is
float64, so a DOUBLE value computed in an implicitly typed buffer loses
half its mantissa without a word (the JAX package's hazard is the
mirror image: x64 makes its implicit float float64). Explicit dtypes
stay allowed; what is banned is *implicit*.

Validity masks are ``torch.bool`` by the columnar contract
(columnar/column.py); integer masks break the ``&``/``|`` identities
the kernels rely on.
"""

from __future__ import annotations

import ast

from ..core import rule
from ..pyast import ARRAY_ROOT, attr_chain

_SCOPE_DIRS = ("ops", "parallel")

# factories whose dtype defaults to the implicit float dtype
_ALWAYS_FLOAT_FACTORIES = {"zeros", "ones", "empty", "rand", "randn"}
# factories that infer their dtype from a literal payload
_INFER_FACTORIES = {"tensor", "as_tensor", "full", "arange", "linspace"}


def _in_scope(mod) -> bool:
    return mod.in_dirs(*_SCOPE_DIRS) and not mod.parts[-1].endswith("_host.py")


def _has_float_literal(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Constant) and isinstance(n.value, float)
               for n in ast.walk(node))


@rule(
    "implicit-float-dtype",
    "implicit float dtype in a torch factory (float32: a Spark DOUBLE "
    "computed in it loses precision)",
    "torch's default float dtype is float32; a dtype-less torch.zeros "
    "or a float-literal torch.tensor allocates float32 and silently "
    "narrows Spark DOUBLE math.",
)
def implicit_float_dtype(mod):
    if not _in_scope(mod):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain or chain[0] != ARRAY_ROOT or len(chain) != 2:
            continue
        name = chain[1]
        if any(kw.arg == "dtype" for kw in node.keywords):
            continue
        if name in _ALWAYS_FLOAT_FACTORIES:
            yield mod.finding(
                "implicit-float-dtype",
                node,
                f"torch.{name} without dtype= allocates the implicit float dtype "
                "(float32) — state the dtype",
            )
        elif name in _INFER_FACTORIES and node.args:
            payload = node.args[1] if name == "full" and len(node.args) > 1 else node.args
            if _has_float_literal(payload if isinstance(payload, ast.AST)
                                  else ast.Tuple(elts=list(payload), ctx=ast.Load())):
                yield mod.finding(
                    "implicit-float-dtype",
                    node,
                    f"torch.{name} over float literals without dtype= infers float32 "
                    "— state the dtype",
                )


_NONBOOL_DTYPES = {"int8", "uint8", "int16", "int32", "int64", "float32", "float64"}
_NONBOOL_METHODS = {"int", "long", "byte", "char", "short", "float", "double"}


def _nonbool_cast(n: ast.AST):
    """The name of the non-bool dtype ``n`` casts to, or None."""
    if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)):
        return None
    if n.func.attr in _NONBOOL_METHODS and not n.args:
        return f".{n.func.attr}()"
    if n.func.attr in ("to", "type"):
        for a in list(n.args) + [kw.value for kw in n.keywords if kw.arg == "dtype"]:
            chain = attr_chain(a)
            if chain and chain[0] == ARRAY_ROOT and chain[-1] in _NONBOOL_DTYPES:
                return ".".join(chain)
    return None


@rule(
    "validity-mask-dtype",
    "validity mask built with a non-bool dtype",
    "columnar contract: validity is torch.bool; integer masks break the "
    "&/| null-propagation identities the kernels rely on.",
)
def validity_mask_dtype(mod):
    if not _in_scope(mod):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        # Column(dtype, data, validity) / Column(..., validity=X)
        chain = attr_chain(node.func)
        if not chain or chain[-1] != "Column":
            continue
        validity = node.args[2] if len(node.args) >= 3 else None
        for kw in node.keywords:
            if kw.arg == "validity":
                validity = kw.value
        if validity is None:
            continue
        for n in ast.walk(validity):
            cast = _nonbool_cast(n)
            if cast:
                yield mod.finding(
                    "validity-mask-dtype",
                    n,
                    f"validity cast to {cast} — masks stay torch.bool",
                )
