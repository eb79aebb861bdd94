"""The port answers to the JAX package's public names.

For every module of ``spark_rapids_jni_tpu/``, the module at the same
path under ``spark_rapids_jni_tpu_torch/`` must define each public
top-level name, each public method (and class attribute) of each public
class, and each parameter of each public function and method, or the
name sits in ``LEFT_OUT`` with the reason the port does without it. A
``LEFT_OUT`` entry is stale, and fails, once the JAX package no longer
has the name or the port has gained it. Both packages are read with
``ast``; neither is imported."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "spark_rapids_jni_tpu", "spark_rapids_jni_tpu_torch"
# "" is the package root's own modules (api, explain, flight, ...)
SUBPACKAGES = ("", "analysis", "columnar", "kernels", "ops", "parallel", "regex", "runtime",
               "serving", "utils")

_PYTREE = ("a JAX pytree hook (jax.tree_util); torch tensors in a dataclass need no "
           "registration to cross a call")
_ANALYZER = ("the JAX analyzer's own rule, which it already runs over the port's files "
             "(docs/PORT_SPRTCHECK.md maps it)")
_BASELINE = ("a baseline of grandfathered findings: the port keeps none, a finding is fixed "
             "or suppressed at its site (docs/PORT_SPRTCHECK.md:16)")
_JNP_TAINT = ("a helper of the JAX analyzer's jnp/lax taint model; the port's taint model "
              "is torch's (analysis/pyast.py device_tainted_names)")
_TILE = ("a tile or funnel-shift form of the TPU's ragged packs; on the card an index "
         "gather or scatter is the direct form (ops/ragged.py:1-13)")
_SHRINK = ("a tile-form ragged pack of the shrink-wrapped collect; the port's collect "
           "gathers live spans by index (parallel/distributed.py _gather_live)")

# "<module path>:<name>": why the port has no counterpart. A name is
# ``f``, ``Class.method``, ``f(param)`` or ``Class.method(param)``;
# ``<module>`` stands for a whole module.
LEFT_OUT = {
    # pytree methods
    "columnar/column.py:Column.tree_flatten": _PYTREE,
    "columnar/column.py:Column.tree_unflatten": _PYTREE,
    "columnar/nested.py:ListColumn.tree_flatten": _PYTREE,
    "columnar/nested.py:ListColumn.tree_unflatten": _PYTREE,
    "columnar/nested.py:StructColumn.tree_flatten": _PYTREE,
    "columnar/nested.py:StructColumn.tree_unflatten": _PYTREE,
    "columnar/table.py:Table.tree_flatten": _PYTREE,
    "columnar/table.py:Table.tree_unflatten": _PYTREE,
    # jnp dtypes
    "columnar/dtypes.py:DType.jnp_dtype": "the jnp dtype; the port's is DType.torch_dtype",
    "parallel/spark_hash.py:U32": ("the jnp uint32 alias; the port carries a hash as int32 "
                                   "holding the uint32 bits (parallel/spark_hash.py)"),
    "utils/int128.py:U64": ("the jnp uint64 alias; the port's limbs are int64 holding the "
                            "uint64 bits (utils/int128.py)"),
    "utils/int256.py:U64": ("the jnp uint64 alias; the port's limbs are int64 holding the "
                            "uint64 bits (utils/int128.py)"),
    "utils/int128.py:pow10_table(shape)": "a parameter the JAX body never reads",
    # the kernel
    "kernels/murmur3.py:hash_planes(interpret)": (
        "Pallas interpret mode; the port's wrapper runs the plain version on CPU tensors "
        "and launches csrc/murmur3.cu on CUDA tensors"),
    "kernels/murmur3.py:hash_columns(interpret)": (
        "Pallas interpret mode; the port's wrapper runs the plain version on CPU tensors "
        "and launches csrc/murmur3.cu on CUDA tensors"),
    # the TPU's ragged tile forms
    "ops/ragged.py:MAX_TILE": _TILE,
    "ops/ragged.py:MIN_TILE": _TILE,
    "ops/ragged.py:measure_k2_device": _TILE,
    "ops/ragged.py:measure_k2": _TILE,
    "ops/ragged.py:stride_k2": _TILE,
    "ops/ragged.py:ragged_unpack_words": _TILE,
    "ops/ragged.py:pack_tile_words": _TILE,
    "ops/ragged.py:stride_k2_words": _TILE,
    "ops/ragged.py:measure_k2_words_device": _TILE,
    "ops/ragged.py:measure_k2_words_at": _TILE,
    "ops/ragged.py:ragged_pack_words": _TILE,
    "ops/ragged.py:words_to_char_matrix": _TILE,
    "ops/ragged.py:char_matrix_to_words": _TILE,
    "ops/ragged.py:ragged_pack(padded)": _TILE,
    "ops/ragged.py:ragged_pack(k2)": _TILE,
    "ops/ragged.py:ragged_pack(tile)": _TILE,
    "columnar/strings.py:shrink_plan": _SHRINK,
    "columnar/strings.py:shrink_varlen": _SHRINK,
    "ops/rowgather.py:pack_fixed_rows": ("a whole-row word packer: a TPU gather costs the "
                                         "same per index whatever the row width; the port "
                                         "gathers column by column (ops/rowgather.py:11-13)"),
    "ops/rowgather.py:unpack_fixed_rows": "the inverse of pack_fixed_rows",
    # XLA's compile boundary
    "runtime/metrics.py:install_compile_hook": (
        "wraps XLA's compile_or_get_cached; eager torch has no compile boundary, and a "
        "graph capture is timed as pipeline.plan_build"),
    "runtime/metrics.py:set_compile_context": "part of install_compile_hook",
    "runtime/metrics.py:restore_compile_context": "part of install_compile_hook",
    # the analyzer
    "analysis/__init__.py:apply_baseline": _BASELINE,
    "analysis/__init__.py:load_baseline": _BASELINE,
    "analysis/__init__.py:write_baseline": _BASELINE,
    "analysis/core.py:apply_baseline": _BASELINE,
    "analysis/core.py:load_baseline": _BASELINE,
    "analysis/core.py:write_baseline": _BASELINE,
    "analysis/core.py:render_text(grandfathered)": _BASELINE,
    "analysis/core.py:render_text(stale)": _BASELINE,
    "analysis/core.py:render_json(grandfathered)": _BASELINE,
    "analysis/core.py:render_json(stale)": _BASELINE,
    "analysis/core.py:render_sarif(grandfathered)": _BASELINE,
    "analysis/core.py:render_sarif(stale)": _BASELINE,
    "analysis/core.py:analyze(jobs)": ("a worker pool over the files; the port's analyzer "
                                       "has none (--jobs was removed in its review), its "
                                       "content-hash cache keeps reruns cheap"),
    "analysis/core.py:RepoContext": ("the JAX analyzer's repo-wide machinery, for the ABI "
                                     "contract and its other repo rules, which it already "
                                     "runs over the port"),
    "analysis/core.py:repo_rule": ("the JAX analyzer's repo-wide machinery, for the ABI "
                                   "contract and its other repo rules, which it already "
                                   "runs over the port"),
    "analysis/pyast.py:ARRAY_MODULES": _JNP_TAINT,
    "analysis/pyast.py:contains_array_call": _JNP_TAINT,
    "analysis/pyast.py:jit_static": _JNP_TAINT,
    "analysis/pyast.py:has_tracer_guard": _JNP_TAINT,
    "analysis/pyast.py:tracer_tainted_names": _JNP_TAINT,
    "analysis/pyast.py:line_annotation": ("read by the JAX analyzer's generic rules only "
                                          "(guarded-by, acquires=), which it already runs "
                                          "over the port"),
    "analysis/pyast.py:walk_locked": ("a helper of the JAX lock-discipline rule, which it "
                                      "already runs over the port"),
    "analysis/pyast.py:exit_leaks": ("a helper of the JAX lifecycle-pairing rule, which it "
                                     "already runs over the port"),
    "analysis/rules/__init__.py:abi": _ANALYZER,
    "analysis/rules/__init__.py:concurrency": _ANALYZER,
    "analysis/rules/__init__.py:lifecycle": _ANALYZER,
    "analysis/rules/__init__.py:plan_key": _ANALYZER,
    "analysis/rules/__init__.py:plan_purity": _ANALYZER,
    "analysis/rules/__init__.py:scan_budget": _ANALYZER,
    "analysis/rules/__init__.py:telemetry_vocab": _ANALYZER,
    "analysis/rules/__init__.py:tenant_isolation": _ANALYZER,
    "analysis/rules/__init__.py:trace_safety": (
        "the JAX trace-safety rules over jnp values; the port's counterparts are "
        "dispatch-sync-free and graph-capture-sync (analysis/rules/dispatch_purity.py, "
        "capture_safety.py)"),
    "analysis/rules/abi.py:<module>": _ANALYZER,
    "analysis/rules/concurrency.py:<module>": _ANALYZER,
    "analysis/rules/lifecycle.py:<module>": _ANALYZER,
    "analysis/rules/plan_key.py:<module>": _ANALYZER,
    "analysis/rules/plan_purity.py:<module>": _ANALYZER,
    "analysis/rules/scan_budget.py:<module>": _ANALYZER,
    "analysis/rules/telemetry_vocab.py:<module>": _ANALYZER,
    "analysis/rules/tenant_isolation.py:<module>": _ANALYZER,
    "analysis/rules/trace_safety.py:<module>": (
        "the JAX trace-safety rules over jnp values; the port's counterparts are "
        "dispatch-sync-free and graph-capture-sync (analysis/rules/dispatch_purity.py, "
        "capture_safety.py)"),
    "analysis/rules/dtype_discipline.py:implicit_float64": (
        "the JAX rule over jnp dtypes; the port's counterpart in the same module is "
        "implicit_float_dtype"),
    "analysis/rules/dtype_discipline.py:float64_dtype_literal": (
        "the JAX rule over jnp dtype literals; torch's implicit float is float32, which "
        "implicit_float_dtype covers"),
}


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)]


def _public(name):
    return not name.startswith("_")


def surface(path):
    """The public names of one module, as ``LEFT_OUT`` spells them. An
    ``__init__.py`` also counts what it imports from its package."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    is_init = os.path.basename(path) == "__init__.py"
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            out.add(node.name)
            out.update(f"{node.name}({p})" for p in _params(node))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.add(node.name)
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if m.name == "__init__":
                        out.update(f"{node.name}({p})" for p in _params(m))
                    elif _public(m.name):
                        out.add(f"{node.name}.{m.name}")
                        out.update(f"{node.name}.{m.name}({p})" for p in _params(m))
                elif isinstance(m, (ast.Assign, ast.AnnAssign)):
                    out.update(f"{node.name}.{t}" for t in _targets(m) if _public(t))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(t for t in _targets(node) if _public(t))
        elif is_init and isinstance(node, ast.ImportFrom) and node.level:
            out.update(a.asname or a.name for a in node.names if _public(a.asname or a.name))
    return out


def modules(sub):
    """Module paths of one subpackage of the JAX package, relative to
    the package (``""``: the root's own modules)."""
    base = os.path.join(ROOT, JAX, sub)
    if not sub:
        return sorted(f for f in os.listdir(base) if f.endswith(".py"))
    out = []
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        rel = os.path.relpath(dirpath, os.path.join(ROOT, JAX))
        out += [f"{rel}/{f}".replace(os.sep, "/") for f in filenames if f.endswith(".py")]
    return sorted(out)


def _in(sub, key):
    path = key.split(":")[0]
    return "/" not in path if not sub else path.startswith(sub + "/")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_answers_to_the_jax_names(sub):
    missing, stale = [], []
    for rel in modules(sub):
        jax_names = surface(os.path.join(ROOT, JAX, rel))
        port_path = os.path.join(ROOT, PORT, rel)
        whole = f"{rel}:<module>"
        if not os.path.exists(port_path):
            if whole not in LEFT_OUT:
                missing.append(whole)
            continue
        if whole in LEFT_OUT:
            stale.append(f"{whole} (the port has the module)")
        port_names = surface(port_path)
        for name in sorted(jax_names - port_names):
            # a left-out name covers its own parameters and methods
            owners = {name, name.split("(")[0], name.split(".")[0].split("(")[0]}
            if not any(f"{rel}:{o}" in LEFT_OUT for o in owners):
                missing.append(f"{rel}:{name}")
        for key in LEFT_OUT:
            if key.startswith(f"{rel}:") and key != whole:
                name = key.split(":", 1)[1]
                if name not in jax_names:
                    stale.append(f"{key} (gone from the JAX package)")
                elif name in port_names:
                    stale.append(f"{key} (the port has it)")
    assert not missing, "no counterpart in the port and no LEFT_OUT reason:\n" + "\n".join(missing)
    assert not stale, "stale LEFT_OUT entries:\n" + "\n".join(stale)


def test_left_out_entries_are_reasoned_and_in_some_case():
    for key, why in LEFT_OUT.items():
        assert isinstance(why, str) and len(why) > 20, key
        path = key.split(":")[0]
        assert os.path.exists(os.path.join(ROOT, JAX, path)), key
        assert any(_in(sub, key) for sub in SUBPACKAGES), key
