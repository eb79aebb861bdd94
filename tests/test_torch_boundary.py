"""The port's boundary: it imports neither JAX nor the JAX package, and
its constructors never quietly fall back to the CPU."""

import ast
import os
import subprocess
import sys

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


# Every module of the port's q1 slice, imported in an interpreter in
# which ``jax`` and the JAX package cannot be imported at all: the import
# succeeds only if nothing it pulls in, directly or transitively, needs
# either.
Q1_SLICE_MODULES = [
    "spark_rapids_jni_tpu_torch.utils.int128",
    "spark_rapids_jni_tpu_torch.utils.int256",
    "spark_rapids_jni_tpu_torch.ops.decimal",
    "spark_rapids_jni_tpu_torch.ops.segmented",
    "spark_rapids_jni_tpu_torch.ops.rowgather",
    "spark_rapids_jni_tpu_torch.columnar.strings",
    "spark_rapids_jni_tpu_torch.ops.sort",
    "spark_rapids_jni_tpu_torch.ops.filter",
    "spark_rapids_jni_tpu_torch.ops.aggregate",
    "spark_rapids_jni_tpu_torch.api",
]


# The modules of the join slice (TPC-H q5) and the host row codec, and
# the attribute each must carry, imported the same way.
Q5_SLICE_MODULES = [
    ("spark_rapids_jni_tpu_torch.ops.join", "join_padded"),
    ("spark_rapids_jni_tpu_torch.ops.row_conversion_host", "decode_rows"),
    ("spark_rapids_jni_tpu_torch.kernels._build", "HOST_SOURCES"),
    ("spark_rapids_jni_tpu_torch.api", "Join"),
]

# The modules of the store_sales slice (Parquet ingress, casts, JSON),
# imported the same way.
STORE_SALES_SLICE_MODULES = [
    ("spark_rapids_jni_tpu_torch.runtime.native", "load"),
    ("spark_rapids_jni_tpu_torch.runtime.errors", "CastException"),
    ("spark_rapids_jni_tpu_torch.ops.parquet_footer", "ParquetFooter"),
    ("spark_rapids_jni_tpu_torch.ops.parquet_reader", "ParquetReader"),
    ("spark_rapids_jni_tpu_torch.ops.cast_string", "string_to_decimal"),
    ("spark_rapids_jni_tpu_torch.ops._json_scans", "structure"),
    ("spark_rapids_jni_tpu_torch.ops.get_json_object", "get_json_object"),
    ("spark_rapids_jni_tpu_torch.api", "JSONUtils"),
]

# The modules of the slice that finishes config 4's string layer (the
# float cast, from_json and the nested Parquet assembly), imported the
# same way.
STRING_LAYER_MODULES = [
    ("spark_rapids_jni_tpu_torch.columnar.nested", "ListColumn"),
    ("spark_rapids_jni_tpu_torch.runtime.errors", "JsonParsingException"),
    ("spark_rapids_jni_tpu_torch.ops.ragged", "next_pow2"),
    ("spark_rapids_jni_tpu_torch.ops.cast_string", "string_to_float"),
    ("spark_rapids_jni_tpu_torch.regex.compile", "scalar_token_monoid"),
    ("spark_rapids_jni_tpu_torch.ops._strategy", "scan_strategy"),
    ("spark_rapids_jni_tpu_torch.ops.segmented", "lane_scan"),
    ("spark_rapids_jni_tpu_torch.ops._json_scans", "deep_grammar_errors"),
    ("spark_rapids_jni_tpu_torch.ops.map_utils", "from_json"),
    ("spark_rapids_jni_tpu_torch.ops.parquet_reader", "_assemble_node"),
    ("spark_rapids_jni_tpu_torch.api", "MapUtils"),
]

# The modules of the slice that adds the telemetry base, Regex, ZOrder
# and the prefetched scan, imported the same way.
SCAN_REGEX_ZORDER_MODULES = [
    ("spark_rapids_jni_tpu_torch.runtime.metrics", "counter"),
    ("spark_rapids_jni_tpu_torch.runtime.events", "EVENT_NAMES"),
    ("spark_rapids_jni_tpu_torch.runtime.spans", "span"),
    ("spark_rapids_jni_tpu_torch.runtime.scan", "prefetch_chunks"),
    ("spark_rapids_jni_tpu_torch.columnar.interop", "table_from_numpy"),
    ("spark_rapids_jni_tpu_torch.ops.regex", "regexp_extract"),
    ("spark_rapids_jni_tpu_torch.ops.zorder", "hilbert_index"),
    ("spark_rapids_jni_tpu_torch.api", "Regex"),
    ("spark_rapids_jni_tpu_torch.api", "ZOrder"),
    ("spark_rapids_jni_tpu_torch.api", "scan_chunks"),
    ("spark_rapids_jni_tpu_torch.api", "ScanPlan"),
]

# The modules of the window/rollup and fused-execution slice, imported
# the same way.
PIPELINE_SLICE_MODULES = [
    ("spark_rapids_jni_tpu_torch.ops.window", "window"),
    ("spark_rapids_jni_tpu_torch.ops.rollup", "grouping_sets"),
    ("spark_rapids_jni_tpu_torch.runtime.errors", "RetryOOMError"),
    ("spark_rapids_jni_tpu_torch.runtime.faultinj", "inject_point"),
    ("spark_rapids_jni_tpu_torch.runtime.trace", "op_range"),
    ("spark_rapids_jni_tpu_torch.runtime.flight", "maybe_record"),
    ("spark_rapids_jni_tpu_torch.runtime.resource", "run_plan_deferred"),
    ("spark_rapids_jni_tpu_torch.runtime.pipeline", "Pipeline"),
    ("spark_rapids_jni_tpu_torch.runtime.explain", "render_journal"),
    ("spark_rapids_jni_tpu_torch.parallel.distributed", "collect_table"),
    ("spark_rapids_jni_tpu_torch.explain", "main"),
    ("spark_rapids_jni_tpu_torch.flight", "main"),
    ("spark_rapids_jni_tpu_torch.api", "RmmSpark"),
]

# The modules of the exchange slice (the mesh, the exchange interface,
# the shuffle, the distributed operators, the mesh executors and the
# sharded stream), imported the same way.
EXCHANGE_SLICE_MODULES = [
    ("spark_rapids_jni_tpu_torch.parallel.mesh", "Mesh"),
    ("spark_rapids_jni_tpu_torch.parallel.mesh", "ShardedTable"),
    ("spark_rapids_jni_tpu_torch.parallel.exchange", "all_to_all"),
    ("spark_rapids_jni_tpu_torch.parallel.exchange", "psum"),
    ("spark_rapids_jni_tpu_torch.parallel.shuffle", "hash_shuffle"),
    ("spark_rapids_jni_tpu_torch.parallel.shuffle", "partition_exchange"),
    ("spark_rapids_jni_tpu_torch.parallel.distributed", "distributed_group_by"),
    ("spark_rapids_jni_tpu_torch.parallel.distributed", "distributed_join"),
    ("spark_rapids_jni_tpu_torch.parallel.distributed", "distributed_join_broadcast"),
    ("spark_rapids_jni_tpu_torch.parallel.distributed", "distributed_sort"),
    ("spark_rapids_jni_tpu_torch.parallel.distributed", "set_collect_shrink"),
    ("spark_rapids_jni_tpu_torch.runtime.resource", "group_by"),
    ("spark_rapids_jni_tpu_torch.runtime.resource", "join"),
    ("spark_rapids_jni_tpu_torch.runtime.resource", "shuffle"),
    ("spark_rapids_jni_tpu_torch.runtime.pipeline", "broadcast_budget"),
    ("spark_rapids_jni_tpu_torch.parallel", "shuffle"),
]

# The modules of the live-introspection and serving slice (the diag
# server, the sampler, traceview, trace.timeline, the serving driver and
# its façade entry), imported the same way.
SERVING_SLICE_MODULES = [
    ("spark_rapids_jni_tpu_torch.runtime.diag", "prom_text"),
    ("spark_rapids_jni_tpu_torch.runtime.diag", "set_sessions_provider"),
    ("spark_rapids_jni_tpu_torch.runtime.sampler", "capture"),
    ("spark_rapids_jni_tpu_torch.runtime.traceview", "to_chrome_trace"),
    ("spark_rapids_jni_tpu_torch.runtime.trace", "timeline"),
    ("spark_rapids_jni_tpu_torch.runtime.trace", "annotate_function"),
    ("spark_rapids_jni_tpu_torch.traceview", "main"),
    ("spark_rapids_jni_tpu_torch.serving", "Server"),
    ("spark_rapids_jni_tpu_torch.serving.admission", "AdmissionController"),
    ("spark_rapids_jni_tpu_torch.serving.session", "Session"),
    ("spark_rapids_jni_tpu_torch.serving.server", "Job"),
    ("spark_rapids_jni_tpu_torch.api", "serving_server"),
]

IMPORT_CASES = ([(m, None) for m in Q1_SLICE_MODULES] + Q5_SLICE_MODULES
                + STORE_SALES_SLICE_MODULES + STRING_LAYER_MODULES + SCAN_REGEX_ZORDER_MODULES
                + PIPELINE_SLICE_MODULES + EXCHANGE_SLICE_MODULES + SERVING_SLICE_MODULES)

# One interpreter imports every module in turn with the forbidden
# packages blocked, and reports per (module, attr): whether the import
# succeeded (with the error), whether the attribute is there, and the
# forbidden modules loaded so far. A module that needs JAX fails at its
# own import: Python drops a module whose import failed, so the next
# module that needs the same dependency fails at its own import too.
_IMPORTER = """
import importlib, json, sys, traceback
forbidden, cases = json.loads(sys.argv[1])
for name in forbidden:
    sys.modules[name] = None
rows = []
for module, attr in cases:
    row = {"ok": True, "error": None, "has_attr": None}
    try:
        mod = importlib.import_module(module)
        row["has_attr"] = attr is None or hasattr(mod, attr)
    except BaseException:
        row["ok"], row["error"] = False, traceback.format_exc()[-2000:]
    row["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in forbidden and sys.modules[m])
    rows.append(row)
print(json.dumps(rows))
"""


@pytest.fixture(scope="module")
def import_report():
    """{(module, attr): row} from ONE interpreter (see ``_IMPORTER``)."""
    import json

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORTER, json.dumps([FORBIDDEN, IMPORT_CASES])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    return {tuple(case): row for case, row in zip(IMPORT_CASES, rows)}


def _check_import(report, module, attr):
    path = os.path.join(ROOT, *module.split("."))
    path = path + ".py" if os.path.exists(path + ".py") else os.path.join(path, "__init__.py")
    bad = [m for m in _imported_modules(path) if m and m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    row = report[(module, attr)]
    assert row["ok"], row["error"]
    assert row["has_attr"], f"{module} has no {attr}"
    assert not row["loaded"], row["loaded"]


@pytest.mark.parametrize("module", Q1_SLICE_MODULES)
def test_q1_slice_module_imports_without_jax(import_report, module):
    _check_import(import_report, module, None)


@pytest.mark.parametrize("module,attr", Q5_SLICE_MODULES)
def test_q5_slice_module_imports_without_jax(import_report, module, attr):
    _check_import(import_report, module, attr)


@pytest.mark.parametrize("module,attr", STORE_SALES_SLICE_MODULES)
def test_store_sales_slice_module_imports_without_jax(import_report, module, attr):
    _check_import(import_report, module, attr)


def test_read_table_default_device_is_cuda(tmp_path):
    """``read_table`` lands on the card by default; without one it raises
    before decoding instead of reading onto the CPU."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    from spark_rapids_jni_tpu_torch.api import read_table

    path = str(tmp_path / "t.parquet")
    chip_smoke.write_store_sales(path, 100, 64)
    if torch.cuda.is_available():
        assert read_table(path).columns[0].data.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        read_table(path)
    assert read_table(path, device="cpu").num_rows == 100


@pytest.mark.parametrize("module,attr", STRING_LAYER_MODULES)
def test_string_layer_module_imports_without_jax(import_report, module, attr):
    _check_import(import_report, module, attr)


STRING_LAYER_ENTRIES = {
    "toFloat": lambda col: port.api.CastStrings.toFloat(col, False, port.FLOAT64),
    "extractRawMapFromJsonString": lambda col: port.api.MapUtils.extractRawMapFromJsonString(col),
}


@pytest.mark.parametrize("name", sorted(STRING_LAYER_ENTRIES))
def test_string_layer_entry_default_device_is_cuda(name):
    """The float cast and from_json run where their column lies, and a
    column lies on the card unless the caller asks for the CPU: without
    a card the default raises instead of computing on the CPU."""
    import spark_rapids_jni_tpu_torch.api  # noqa: F401

    entry = STRING_LAYER_ENTRIES[name]
    rows = ['{"a": "1.5"}', None] if name != "toFloat" else ["1.5", None]
    if torch.cuda.is_available():
        out = entry(port.Column.from_pylist(rows, port.STRING))
        assert out.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(port.Column.from_pylist(rows, port.STRING))
    out = entry(port.Column.from_pylist(rows, port.STRING, device="cpu"))
    assert out.device.type == "cpu"
    assert out.to_pylist()[1] is None


@pytest.mark.parametrize("module,attr", SCAN_REGEX_ZORDER_MODULES)
def test_scan_regex_zorder_module_imports_without_jax(import_report, module, attr):
    _check_import(import_report, module, attr)


SCAN_REGEX_ZORDER_ENTRIES = {
    "rlike": lambda dev: port.Regex.rlike(port.Column.from_pylist(["ab", None], port.STRING, **dev),
                                          "a+"),
    "regexpExtract": lambda dev: port.Regex.regexpExtract(
        port.Column.from_pylist(["id=7", None], port.STRING, **dev), r"id=(\d+)"),
    "interleaveBits": lambda dev: port.ZOrder.interleaveBits(
        2, port.Column.from_pylist([1, 2], port.INT32, **dev)),
    "interleaveBits no columns": lambda dev: port.ZOrder.interleaveBits(2, **dev),
    "hilbertIndex": lambda dev: port.ZOrder.hilbertIndex(
        4, 2, port.Column.from_pylist([1, None], port.INT32, **dev)),
    "hilbertIndex no columns": lambda dev: port.ZOrder.hilbertIndex(4, 2, **dev),
}


@pytest.mark.parametrize("name", sorted(SCAN_REGEX_ZORDER_ENTRIES))
def test_regex_zorder_entry_default_device_is_cuda(name):
    """Regex and ZOrder run where their columns lie; with no column the
    ZOrder corner cases make their result on ``device``, the card by
    default. Without a card the default raises instead of computing on
    the CPU."""
    entry = SCAN_REGEX_ZORDER_ENTRIES[name]
    if torch.cuda.is_available():
        assert entry({}).data.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry({})
    out = entry({"device": "cpu"})
    assert out.data.device.type == "cpu" and len(out) == 2


@pytest.mark.parametrize("entry", ["ScanPlan", "scan_chunks"])
def test_scan_default_device_is_cuda(tmp_path, entry):
    """ScanPlan and scan_chunks hand ``device`` (default the card) to
    their readers; without a card they raise before planning."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    path = str(tmp_path / "t.parquet")
    chip_smoke.write_store_sales(path, 100, 64)
    make = getattr(port, entry)
    if torch.cuda.is_available():
        with port.ScanPlan(path) as plan:
            chunk = next(iter(port.prefetch_chunks(plan)))
        assert chunk.columns[0].data.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(path)
    if entry == "ScanPlan":
        with make(path, device="cpu") as plan:
            assert sum(c.num_rows for c in port.prefetch_chunks(plan)) == 100
    else:
        assert sum(c.num_rows for c in make(path, device="cpu")) == 100


@pytest.mark.parametrize("module,attr", PIPELINE_SLICE_MODULES)
def test_pipeline_slice_module_imports_without_jax(import_report, module, attr):
    _check_import(import_report, module, attr)


@pytest.mark.parametrize("module,attr", EXCHANGE_SLICE_MODULES)
def test_exchange_slice_module_imports_without_jax(import_report, module, attr):
    _check_import(import_report, module, attr)


def test_scan_parquet_default_device_is_cuda(tmp_path):
    """``Pipeline.scan_parquet`` lands its chunks on the card by default;
    without one it raises before planning instead of reading onto the
    CPU."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    from spark_rapids_jni_tpu_torch.api import Pipeline

    path = str(tmp_path / "t.parquet")
    chip_smoke.write_store_sales(path, 100, 64)
    p = Pipeline("boundary").select([0])
    if torch.cuda.is_available():
        out = p.scan_parquet(path)
        assert out[0].columns[0].data.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.scan_parquet(path)
    assert sum(t.num_rows for t in p.scan_parquet(path, device="cpu")) == 100


def test_make_mesh_default_is_cuda():
    """``make_mesh`` takes CUDA devices and raises past their count (no
    quiet CPU mesh); a CPU mesh is asked for by naming its devices."""
    from spark_rapids_jni_tpu_torch.parallel.mesh import Mesh, make_mesh

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have:
        assert make_mesh(1).devices[0].type == "cuda"
        # a named card is indexed, as the tensors on it report it
        assert Mesh(["cuda"] * 8).shared_device == torch.zeros(1, device="cuda").device
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh(["cuda"] * 8)
    with pytest.raises(ValueError, match=f"need {have + 1} devices, have {have}"):
        make_mesh(have + 1)
    mesh = Mesh(["cpu"] * 8)
    assert mesh.size == 8 and mesh.shared_device == torch.device("cpu")


@pytest.mark.parametrize("module,attr", SERVING_SLICE_MODULES)
def test_serving_slice_module_imports_without_jax(import_report, module, attr):
    _check_import(import_report, module, attr)
