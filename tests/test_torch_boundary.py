"""The port's boundary: it imports neither JAX nor the JAX package, and
its constructors never quietly fall back to the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch.columnar import interop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_jni_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "spark_rapids_jni_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in
            ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value


def test_no_jax_imports():
    bad = []
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


CONSTRUCTORS = {
    "from_numpy": lambda **kw: port.Column.from_numpy(np.arange(3), port.INT64, **kw),
    "from_pylist": lambda **kw: port.Column.from_pylist(["a", None], port.STRING, **kw),
    "from_pylists": lambda **kw: port.Table.from_pylists([[1, 2]], [port.INT32], **kw),
    "table_from_numpy": lambda **kw: interop.table_from_numpy(
        [{"dtype": ("int", 32, None, None), "data": np.arange(2), "validity": None,
          "offsets": None}], **kw),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_default_device_is_cuda(name):
    make = CONSTRUCTORS[name]
    if torch.cuda.is_available():
        col = make()
        first = col if isinstance(col, port.Column) else col.columns[0]
        assert first.data.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    cpu = make(device="cpu")
    first = cpu if isinstance(cpu, port.Column) else cpu.columns[0]
    assert first.data.device.type == "cpu"


def test_interop_round_trip():
    rng = np.random.default_rng(0)
    cols = [
        {"dtype": ("decimal", 128, 38, 2), "data": rng.integers(-9, 9, (5, 2)),
         "validity": np.array([1, 0, 1, 1, 0], bool), "offsets": None},
        {"dtype": ("string", 0, None, None), "data": np.frombuffer(b"abcde", np.uint8),
         "validity": None, "offsets": np.array([0, 1, 1, 3, 3, 5], np.int32)},
    ]
    back = interop.table_to_numpy(interop.table_from_numpy(cols, device="cpu"))
    for c, b in zip(cols, back):
        assert c["dtype"] == b["dtype"]
        for key in ("data", "validity", "offsets"):
            if c[key] is None:
                assert b[key] is None
            else:
                np.testing.assert_array_equal(b[key], c[key])
