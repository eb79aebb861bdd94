"""The port's nested Parquet assembly against the JAX reader's (exact),
over pyarrow-written files mirroring tests/test_parquet_reader.py's
nested cases, and chip_smoke's nested writer against pyarrow and its
generator."""

import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu.columnar.nested import ListColumn as JList
from spark_rapids_jni_tpu.columnar.nested import StructColumn as JStruct
from spark_rapids_jni_tpu.ops import parquet_reader as jpr

from spark_rapids_jni_tpu_torch.columnar.interop import column_to_numpy, table_to_numpy
from spark_rapids_jni_tpu_torch.columnar.nested import ListColumn, StructColumn
from spark_rapids_jni_tpu_torch.ops import parquet_footer as ppf
from spark_rapids_jni_tpu_torch.ops import parquet_reader as ppr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _host(a):
    return None if a is None else np.asarray(a)


def jax_tree(col):
    """A JAX-package column (flat or nested) in the port's interop form."""
    if isinstance(col, JList):
        return {"list": jax_tree(col.child), "offsets": _host(col.offsets),
                "validity": _host(col.validity)}
    if isinstance(col, JStruct):
        return {"struct": [jax_tree(c) for c in col.children], "names": tuple(col.names),
                "validity": _host(col.validity)}
    dt = col.dtype
    return {"dtype": (dt.kind, dt.bits, dt.precision, dt.scale), "data": _host(col.data),
            "validity": _host(col.validity), "offsets": _host(col.offsets)}


def assert_same_tree(got, want, label="col"):
    """Exact equality of two interop trees, every buffer (null slots
    included) and every missing mask."""
    assert set(got) == set(want), label
    for k, w in want.items():
        g = got[k]
        if k in ("list",):
            assert_same_tree(g, w, label + ".element")
        elif k == "struct":
            assert len(g) == len(w), label
            for i, (a, b) in enumerate(zip(g, w)):
                assert_same_tree(a, b, f"{label}.{i}")
        elif k in ("names", "dtype"):
            assert tuple(g) == tuple(w), (label, k)
        elif w is None or g is None:
            assert w is None and g is None, (label, k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")


def read_both(path, **kw):
    port = ppr.read_table(path, device="cpu", **kw)
    jax_t = jpr.read_table(path)
    assert port.num_columns == jax_t.num_columns
    for pc, jc in zip(port.columns, jax_t.columns):
        assert_same_tree(column_to_numpy(pc), jax_tree(jc))
        assert pc.to_pylist() == jc.to_pylist()
    return port


def write(tmp_path, table, **kw):
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, **kw)
    return path


def _norm(v):
    """pyarrow nests as dicts; StructColumn.to_pylist yields tuples."""
    if isinstance(v, dict):
        return tuple(_norm(x) for x in v.values())
    if isinstance(v, list):
        return [_norm(x) for x in v]
    return v


CASES = {
    "list of int": pa.table({"v": pa.array(
        [[1, 2, 3], [], None, [42], [None, 7], [8, 9, 10, 11], None, []],
        type=pa.list_(pa.int64()))}),
    "list of string": pa.table({"s": pa.array(
        [["a", "bb", None], [], None, ["zzz"], ["", "x"]], type=pa.list_(pa.string()))}),
    "list beside flat columns": pa.table({
        "id": pa.array([1, 2, 3, 4], type=pa.int64()),
        "tags": pa.array([["x"], [], None, ["a", "b"]], type=pa.list_(pa.string())),
        "name": pa.array(["p", "q", None, "s"]),
    }),
    "struct": pa.table({
        "s": pa.array([{"a": 1, "b": "x"}, None, {"a": None, "b": "z"}, {"a": 4, "b": None}],
                      type=pa.struct([("a", pa.int64()), ("b", pa.string())])),
        "flat": pa.array([10, 20, 30, 40], pa.int64()),
    }),
    "struct two deep": pa.table({"s": pa.array(
        [{"inner": {"x": 1, "y": 1.5}, "k": 7}, {"inner": None, "k": 8}, None,
         {"inner": {"x": None, "y": 2.5}, "k": 9}],
        type=pa.struct([("inner", pa.struct([("x", pa.int32()), ("y", pa.float64())])),
                        ("k", pa.int64())]))}),
    "map": pa.table({"m": pa.array([[("k1", 1), ("k2", 2)], [], None, [("k3", None)]],
                                   type=pa.map_(pa.string(), pa.int64()))}),
    "list of list": pa.table({"ll": pa.array(
        [[[1, 2], [], [3]], [], None, [[4, None]], [None, [5]]],
        type=pa.list_(pa.list_(pa.int64())))}),
    "list of struct": pa.table({"ls": pa.array(
        [[{"a": 1, "b": "x"}, {"a": 2, "b": None}], [], None, [{"a": None, "b": "q"}]],
        type=pa.list_(pa.struct([("a", pa.int64()), ("b", pa.string())])))}),
    "struct of list": pa.table({"sl": pa.array(
        [{"v": [1, 2], "n": 1}, {"v": [], "n": 2}, {"v": None, "n": 3}, None],
        type=pa.struct([("v", pa.list_(pa.int64())), ("n", pa.int64())]))}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nested_matches_jax_and_pyarrow(tmp_path, name):
    arrow = CASES[name]
    port = read_both(write(tmp_path, arrow))
    for i, nm in enumerate(arrow.column_names):
        want = arrow.column(nm).to_pylist()
        if name == "map":  # a map reads as list<struct<key, value>>
            want = [None if v is None else [tuple(kv) for kv in v] for v in want]
        assert [_norm(v) for v in port.columns[i].to_pylist()] == [_norm(v) for v in want], nm


def test_list_multiple_row_groups(tmp_path):
    vals = [[i, i + 1] if i % 3 else [] for i in range(5000)]
    arrow = pa.table({"v": pa.array(vals, type=pa.list_(pa.int32()))})
    path = write(tmp_path, arrow, row_group_size=512, compression="SNAPPY")
    port = read_both(path)
    assert port.columns[0].to_pylist() == vals
    with ppr.ParquetReader(path, device="cpu") as r:
        assert r.num_row_groups == 10


def test_struct_multiple_row_groups(tmp_path):
    """Structs of lists concatenate across row groups (children, masks
    and offsets rebased)."""
    vals = [None if i % 7 == 0 else {"v": None if i % 5 == 0 else list(range(i % 4)), "n": i}
            for i in range(3000)]
    arrow = pa.table({"sl": pa.array(vals, type=pa.struct(
        [("v", pa.list_(pa.int64())), ("n", pa.int64())]))})
    port = ppr.read_table(write(tmp_path, arrow, row_group_size=700), device="cpu")
    assert isinstance(port.columns[0], StructColumn)
    assert [_norm(v) for v in port.columns[0].to_pylist()] == [_norm(v) for v in vals]


def test_legacy_two_level_repeated_field(tmp_path):
    """A bare repeated field written by pyarrow's non-compliant list mode
    reads as a list, as the JAX reader reads it."""
    arrow = pa.table({
        "r": pa.array([[1, 2], [], [3]], type=pa.list_(pa.int64())),
        "k": pa.array([7, 8, 9], pa.int64()),
    })
    path = str(tmp_path / "legacy.parquet")
    pq.write_table(arrow, path, use_compliant_nested_type=False, version="1.0")
    port = read_both(path)
    assert [_norm(v) for v in port.columns[0].to_pylist()] == [[1, 2], [], [3]]
    assert port.columns[1].to_pylist() == [7, 8, 9]


def test_nested_root_reads_and_prunes(tmp_path):
    """A nested root beside a flat one reads whole (the port raised here
    before the nested assembly); pruned to the flat column, only it."""
    path = str(tmp_path / "nested.parquet")
    pq.write_table(pa.table({
        "x": pa.array([1, 2], pa.int32()),
        "l": pa.array([[1], [2, 3]], pa.list_(pa.int32())),
    }), path)
    port = read_both(path)
    assert isinstance(port.columns[1], ListColumn)
    assert port.columns[1].to_pylist() == [[1], [2, 3]]
    sch = ppf.StructElement().add_child("x", ppf.ValueElement())
    assert ppr.read_table(path, sch, device="cpu").columns[0].to_pylist() == [1, 2]


def test_chip_smoke_nested_writer_reads_back(tmp_path):
    """chip_smoke's nested writer (phase 16): pyarrow, the port and the
    JAX reader read its file back as the generator made it."""
    path = str(tmp_path / "nested.parquet")
    n = 3000
    expected = chip_smoke.write_nested(path, n, seed=5)
    arrow = pq.read_table(path)
    assert arrow.column_names == ["ints", "st", "attrs"]
    assert arrow.num_rows == n
    port = read_both(path)
    got = table_to_numpy(port)
    for g, w, nm in zip(got, expected, arrow.column_names):
        chip_smoke.same_nested(g, w, nm)
        want = arrow.column(nm).to_pylist()
        if nm == "attrs":
            want = [None if v is None else [tuple(kv) for kv in v] for v in want]
        assert [_norm(v) for v in port.columns[arrow.column_names.index(nm)].to_pylist()] == [
            _norm(v) for v in want], nm
    # every level carries nulls and empties
    ints, st, attrs = got
    assert (~ints["validity"]).any() and (np.diff(ints["offsets"]) == 0).any()
    assert (~ints["list"]["validity"]).any() and (~st["validity"]).any()
    assert all((~c["validity"]).any() for c in st["struct"])
    assert (~attrs["validity"]).any() and (~attrs["list"]["struct"][1]["validity"]).any()
