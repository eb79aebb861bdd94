"""What the benchmark's modules import: nothing of the JAX stack, the JAX
package or its harness anywhere (top-level names compared whole), and in
the yardstick's modules nothing of the port."""

import ast
import glob
import os
import sys

import pytest
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "spark_rapids_jni_tpu", "benchmarks", "chip_smoke"}
PORT = "spark_rapids_jni_tpu_torch"
# the yardstick: data, references and controls, traffic, trace reduction,
# the metric readers
YARDSTICK = (glob.glob(os.path.join(BENCH, "configs", "*_ref.py"))
             + glob.glob(os.path.join(BENCH, "generators", "*.py"))
             + glob.glob(os.path.join(BENCH, "metrics", "*.py"))
             + [os.path.join(BENCH, "tracing.py")])


def top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "**", "*.py"),
                                               recursive=True)), ids=os.path.basename)
def test_no_jax(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(YARDSTICK), ids=os.path.basename)
def test_yardstick_imports_nothing_of_the_port(path):
    assert PORT not in top_imports(path)


def test_forbidden_names_compare_whole(monkeypatch):
    from harness import forbidden_modules

    import spark_rapids_jni_tpu_torch  # noqa: F401

    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "spark_rapids_jni_tpu.api", object())
    assert forbidden_modules() == ["jax", "spark_rapids_jni_tpu"]
