"""The port's Parquet footer and reader against the JAX package's
(exact), over pyarrow-written files; chip_smoke's Parquet writer against
pyarrow; the host library's zlib branches."""

import datetime
import decimal
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu.ops import parquet_footer as jpf
from spark_rapids_jni_tpu.ops import parquet_reader as jpr

from spark_rapids_jni_tpu_torch.kernels import _build
from spark_rapids_jni_tpu_torch.ops import parquet_footer as ppf
from spark_rapids_jni_tpu_torch.ops import parquet_reader as ppr

from torch_parity import assert_same_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

N = 3000


def _mixed_arrow(seed=0):
    rng = np.random.default_rng(seed)
    null = rng.random(N) < 0.1

    def opt(values, typ):
        return pa.array([None if m else v for v, m in zip(values, null)], typ)

    return pa.table({
        "i32": opt(rng.integers(-(2**31), 2**31, N).tolist(), pa.int32()),
        "i64": pa.array(rng.integers(-(2**62), 2**62, N)),
        "f32": opt(rng.normal(size=N).astype(np.float32).tolist(), pa.float32()),
        "f64": opt(rng.normal(size=N).tolist(), pa.float64()),
        "b": opt((rng.random(N) < 0.5).tolist(), pa.bool_()),
        "s": opt([f"s{v}" * (v % 4) for v in rng.integers(0, 50, N)], pa.string()),
        "d": opt([datetime.date(1970, 1, 1) + datetime.timedelta(int(v))
                  for v in rng.integers(-5000, 20000, N)], pa.date32()),
        "ts": opt(rng.integers(-(2**50), 2**50, N).tolist(), pa.timestamp("us")),
        "ms": opt(rng.integers(-(2**40), 2**40, N).tolist(), pa.timestamp("ms")),
        "dec9": opt([decimal.Decimal(int(v)).scaleb(-2) for v in
                     rng.integers(-(10**9) + 1, 10**9, N)], pa.decimal128(9, 2)),
        "dec18": opt([decimal.Decimal(int(v)).scaleb(-4) for v in
                      rng.integers(-(10**18) + 1, 10**18, N)], pa.decimal128(18, 4)),
        "dec38": opt([decimal.Decimal(int(v) * 10**20 + int(w)).scaleb(-3) for v, w in
                      zip(rng.integers(-(10**17), 10**17, N), rng.integers(0, 10**18, N))],
                     pa.decimal128(38, 3)),
    })


FILES = {
    "snappy v1 dictionary": dict(compression="SNAPPY", use_dictionary=True),
    "snappy v1 plain": dict(compression="SNAPPY", use_dictionary=False),
    "gzip v1": dict(compression="GZIP"),
    "uncompressed v2": dict(compression="NONE", data_page_version="2.0"),
    "snappy v2 plain": dict(compression="SNAPPY", data_page_version="2.0",
                            use_dictionary=False),
    "decimals as integers": dict(compression="SNAPPY", store_decimal_as_integer=True),
    "int96 timestamps": dict(use_deprecated_int96_timestamps=True),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pq")
    arrow = _mixed_arrow()
    out = {}
    for name, kw in FILES.items():
        path = str(d / (name.replace(" ", "_") + ".parquet"))
        pq.write_table(arrow, path, row_group_size=1024, coerce_timestamps=None, **kw)
        out[name] = path
    return out, arrow


@pytest.mark.parametrize("name", sorted(FILES))
def test_read_table_matches_jax(files, name):
    paths, _arrow = files
    want = jpr.read_table(paths[name])
    got = ppr.read_table(paths[name], device="cpu")
    assert_same_table(want, got)
    assert got.num_rows == N


def test_physical_types_as_written(files):
    paths, _ = files
    kinds = {
        "decimals as integers": {"dec9": "INT32", "dec18": "INT64", "dec38": "FIXED_LEN_BYTE_ARRAY"},
        "int96 timestamps": {"ts": "INT96"},
    }
    for name, want in kinds.items():
        schema = pq.ParquetFile(paths[name]).schema
        for col, phys in want.items():
            idx = schema.names.index(col)
            assert schema.column(idx).physical_type == phys, (name, col)


def test_values_match_pyarrow(files):
    paths, arrow = files
    tbl = ppr.read_table(paths["snappy v1 dictionary"], device="cpu")
    for name in ("i32", "i64", "f64", "b", "s"):
        got = tbl.columns[arrow.column_names.index(name)].to_pylist()
        want = arrow.column(name).to_pylist()
        if name == "b":  # BOOL8 holds 0/1
            want = [None if w is None else int(w) for w in want]
        assert got == want, name


def test_row_groups_and_pruning_match_jax(files):
    paths, _ = files
    path = paths["snappy v1 dictionary"]
    jschema = jpf.StructElement().add_child("s", jpf.ValueElement()).add_child(
        "dec38", jpf.ValueElement())
    pschema = ppf.StructElement().add_child("s", ppf.ValueElement()).add_child(
        "dec38", ppf.ValueElement())
    with jpr.ParquetReader(path, jschema) as jreader, ppr.ParquetReader(path, pschema,
                                                                  device="cpu") as preader:
        assert (preader.num_row_groups, preader.num_columns) == (jreader.num_row_groups, 2)
        assert preader.num_row_groups == -(-N // 1024)
        for rg in range(preader.num_row_groups):
            assert_same_table(jreader.read_row_group(rg), preader.read_row_group(rg))
    # a byte range keeps the row groups whose midpoint falls inside it
    size = os.path.getsize(path)
    kw = dict(part_offset=0, part_length=size // 2)
    with jpr.ParquetReader(path, **kw) as jreader, ppr.ParquetReader(path, device="cpu", **kw) as preader:
        assert preader.num_row_groups == jreader.num_row_groups


def _footer_bytes(path):
    return ppr._read_footer_bytes(path)


def test_footer_matches_jax(files):
    paths, _ = files
    fb = _footer_bytes(paths["snappy v1 plain"])
    assert fb == jpr._read_footer_bytes(paths["snappy v1 plain"])
    names = ["F64", "s", "DEC38"]
    jsch, psch = jpf.StructElement(), ppf.StructElement()
    for nm in names:
        jsch.add_child(nm, jpf.ValueElement())
        psch.add_child(nm, ppf.ValueElement())
    for ignore_case in (False, True):
        with jpf.ParquetFooter.read_and_filter(fb, jsch, ignore_case=ignore_case) as jf, \
                ppf.ParquetFooter.read_and_filter(fb, psch, ignore_case=ignore_case) as pf:
            assert pf.get_num_rows() == jf.get_num_rows() == N
            assert pf.get_num_columns() == jf.get_num_columns() == (3 if ignore_case else 1)
            assert pf.serialize_thrift_file() == jf.serialize_thrift_file()
            for rg in range(3):
                for col in range(pf.get_num_columns()):
                    assert pf.chunk_stats(rg, col) == jf.chunk_stats(rg, col)
    assert ppr._schema_leaf_names(fb) == jpr._schema_leaf_names(fb)
    assert ppr._schema_tree(fb) == jpr._schema_tree(fb)
    with ppf.ParquetFooter.read_and_filter(fb, psch) as pf:
        pass
    with pytest.raises(ValueError, match="closed"):
        pf.get_num_rows()
    with pytest.raises(RuntimeError):
        ppf.ParquetFooter.read_and_filter(b"not a footer", psch)


def _np_char_chunk(n, seed):
    """sf10_store_sales.py gen_chunk's string columns, built with np.char
    exactly as the benchmark builds them."""
    rng = np.random.default_rng(seed)
    store = rng.integers(1, 64, n).astype(np.int32)
    qty_i = rng.integers(1, 100, n)
    price_u = rng.integers(1, 500, n)
    price_f = rng.integers(0, 100, n)
    chan = np.array(["web", "store", "catalog"])[rng.integers(0, 3, n)]
    qty = np.char.add(np.char.add("  ", qty_i.astype(str)), " ")
    price = np.char.add(np.char.add(price_u.astype(str), "."),
                        np.char.zfill(price_f.astype(str), 2))
    attrs = np.char.add(np.char.add('{"promo": false, "channel": "', chan), '"}')
    return store, qty.tolist(), price.tolist(), attrs.tolist()


def test_chip_smoke_writer_reads_back(tmp_path):
    path = str(tmp_path / "store_sales.parquet")
    rows, rg = 5000, 2048
    oracles = chip_smoke.write_store_sales(path, rows, rg)
    assert len(oracles) == 3
    arrow = pq.read_table(path)
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == 3 and meta.num_rows == rows
    assert meta.row_group(0).column(1).compression == "SNAPPY"
    assert "RLE_DICTIONARY" in meta.row_group(0).column(3).encodings
    chunks = [_np_char_chunk(min(rg, rows - lo), 1000 + g)
              for g, lo in enumerate(range(0, rows, rg))]
    want = [[v for chunk in chunks for v in list(chunk[i])] for i in range(4)]
    port = ppr.read_table(path, device="cpu")
    for i in range(4):
        assert arrow.column(i).to_pylist() == want[i], i
        assert port.columns[i].to_pylist() == want[i], i
    assert_same_table(jpr.read_table(path), port)


def test_host_library_zlib_branches():
    branches = _build.host_libraries()
    assert set(branches) == {"zlib", "zstd"}
    assert branches["zlib"][0].startswith("system zlib.h")
    # the port's own zlib declarations, compiled and run against the
    # zlib runtime by name: the branch a machine without zlib.h takes
    assert _build._probe_runs(
        _build._ZLIB_PROBE, ("-I", _build.HOST_INCLUDE), ("-l:libz.so.1",))
    proc = subprocess.run(
        ["g++", "-std=c++17", "-fsyntax-only", "-I", _build.HOST_INCLUDE,
         os.path.join(ROOT, "native", "parquet_pages.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
