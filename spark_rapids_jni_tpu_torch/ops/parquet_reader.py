"""Chunked Parquet reader: native host page decode feeding device columns
(the port's twin of the flat path of the JAX package's
``ops/parquet_reader.py``).

BASELINE.md staged config 4 ("Parquet chunked reader + CastStrings /
get_json_object"). The host C++ of ``native/parquet_pages.cpp`` (thrift
page headers, snappy, gzip, RLE / bit-packed, dictionaries) decodes each
column chunk into dense numpy buffers; this module moves them to the
device as ``Column``s, one row group at a time. Each row group is one
chunk: ``iter_row_groups`` streams them (the chunked-reader contract,
bounded memory), ``read_table`` concatenates.

Type mapping:
  BOOLEAN->BOOL8, INT32->INT32/DATE32/DECIMAL32, INT64->INT64/
  TIMESTAMP/DECIMAL64, INT96->TIMESTAMP, FLOAT->FLOAT32,
  DOUBLE->FLOAT64, BYTE_ARRAY->STRING, FIXED_LEN_BYTE_ARRAY(decimal)->
  DECIMAL128 (big-endian unscaled -> [lo, hi] int64 limbs).

Only flat schemas are read here: a nested root (a repeated field or a
struct/list/map group) raises ``NotImplementedError``. The Dremel record
assembly of the JAX package is ROADMAP Queue 1's "nested Parquet
assembly with columnar/nested.py" item.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..columnar.column import resolve_device
from ..columnar.dtypes import (
    BOOL8,
    DATE32,
    DECIMAL32,
    DECIMAL64,
    DECIMAL128,
    DType,
    FLOAT32,
    FLOAT64,
    INT32,
    INT64,
    STRING,
    TIMESTAMP_MICROS,
)
from ..columnar.interop import table_from_numpy
from ..columnar.table import Table
from ..runtime import native
from .parquet_footer import ParquetFooter, StructElement
from .row_conversion import _concat_col

# parquet physical types
_PT_BOOLEAN, _PT_INT32, _PT_INT64, _PT_INT96 = 0, 1, 2, 3
_PT_FLOAT, _PT_DOUBLE, _PT_BYTE_ARRAY, _PT_FLBA = 4, 5, 6, 7
# ConvertedType values (parquet-format)
_CT_UTF8, _CT_ENUM, _CT_DECIMAL, _CT_DATE = 0, 4, 5, 6
_CT_TIMESTAMP_MILLIS, _CT_TIMESTAMP_MICROS = 9, 10
_CT_INT_8, _CT_INT_16, _CT_INT_32, _CT_INT_64 = 15, 16, 17, 18
_CT_MAP, _CT_MAP_KEY_VALUE, _CT_LIST = 1, 2, 3
_REPEATED = 2

_NESTED_TODO = (
    "nested Parquet columns are not ported yet (ROADMAP.md Queue 1: the "
    "nested Parquet assembly with columnar/nested.py)"
)


def _read_footer_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        if size < 12:
            raise ValueError(f"not a parquet file: {path}")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != b"PAR1":
            raise ValueError(f"missing PAR1 magic: {path}")
        n = int.from_bytes(tail[:4], "little")
        f.seek(size - 8 - n)
        return f.read(n)


def _dtype_for(info: dict) -> DType:
    """Strict mapping: unmodeled converted types raise rather than
    silently falling back to the physical type (a BYTE_ARRAY decimal
    surfacing as STRING would corrupt queries with no signal)."""
    pt, ct = info["type"], info["converted"]
    scale, precision = info["scale"], info["precision"]
    if pt == _PT_BOOLEAN and ct == -1:
        return BOOL8
    if pt == _PT_INT32:
        if ct == _CT_DATE:
            return DATE32
        if ct == _CT_DECIMAL:
            return DECIMAL32(max(precision, 1), scale)
        if ct in (-1, _CT_INT_8, _CT_INT_16, _CT_INT_32):
            return INT32  # narrower ints decode as int32 storage
    elif pt == _PT_INT64:
        if ct in (_CT_TIMESTAMP_MICROS, _CT_TIMESTAMP_MILLIS):
            return TIMESTAMP_MICROS  # millis scaled up at decode
        if ct == _CT_DECIMAL:
            return DECIMAL64(max(precision, 1), scale)
        if ct in (-1, _CT_INT_64):
            return INT64
    elif pt == _PT_INT96 and ct == -1:
        # legacy Spark/Impala timestamp: 8B nanos-of-day + 4B Julian day
        return TIMESTAMP_MICROS
    elif pt == _PT_FLOAT and ct == -1:
        return FLOAT32
    elif pt == _PT_DOUBLE and ct == -1:
        return FLOAT64
    elif pt == _PT_BYTE_ARRAY:
        # ENUM is plain UTF-8 payload (the hidden-decimal hazard that
        # motivates strictness does not apply to it)
        if ct in (-1, _CT_UTF8, _CT_ENUM):
            return STRING
    elif pt == _PT_FLBA and ct == _CT_DECIMAL:
        return DECIMAL128(max(precision, 1), scale)
    raise NotImplementedError(
        f"parquet physical type {pt} with converted type {ct} not supported"
    )


def _int96_to_micros(raw: np.ndarray) -> np.ndarray:
    """12B little-endian INT96 (nanoseconds-of-day + u32 Julian day)
    -> int64 micros since the Unix epoch. The nanos word is SIGNED:
    writers normalize pre-epoch instants as (epoch Julian day, negative
    nanos), and signed // floors toward -inf, which is exactly the
    sub-epoch microsecond truncation Spark applies."""
    w = raw.reshape(-1, 12)
    nanos = w[:, :8].copy().view(np.int64)[:, 0]
    jdays = w[:, 8:].copy().view(np.uint32)[:, 0]
    return (jdays.astype(np.int64) - 2440588) * 86_400_000_000 + nanos // 1000


def _flba_to_limbs(raw: np.ndarray, width: int) -> np.ndarray:
    """Big-endian two's-complement FLBA decimals -> int64 [n, 2] limbs."""
    n = raw.shape[0] // width if width else 0
    b = raw.reshape(n, width)
    # sign-extend into 16 big-endian bytes
    ext = np.where(b[:, :1] >= 128, 0xFF, 0).astype(np.uint8)
    full = np.concatenate([np.repeat(ext, 16 - width, axis=1), b], axis=1)
    le = full[:, ::-1].copy()  # little-endian byte order
    u = le.view(np.uint64).reshape(n, 2)  # [lo, hi]
    return u.view(np.int64)


class _DecodedChunk:
    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._lib.spark_pq_free(self._h)

    def num_values(self) -> int:
        return self._lib.spark_pq_num_values(self._h)

    def values(self) -> np.ndarray:
        n = ctypes.c_int64()
        p = self._lib.spark_pq_values(self._h, ctypes.byref(n))
        if n.value == 0:
            return np.zeros(0, np.uint8)
        return np.ctypeslib.as_array(p, (n.value,)).copy()

    def offsets(self) -> np.ndarray:
        n = ctypes.c_int64()
        p = self._lib.spark_pq_offsets(self._h, ctypes.byref(n))
        if n.value == 0:
            return np.zeros(1, np.int32)
        return np.ctypeslib.as_array(p, (n.value,)).copy()

    def validity(self) -> Optional[np.ndarray]:
        if not self._lib.spark_pq_has_nulls(self._h):
            return None
        n = self.num_values()
        p = self._lib.spark_pq_validity(self._h)
        return np.ctypeslib.as_array(p, (n,)).astype(bool)


def _decode_column(lib, data: bytes, info: dict) -> Dict:
    """One flat column chunk -> its numpy interop form
    (``columnar/interop.py``)."""
    handle = lib.spark_pq_decode_chunk(
        data,
        len(data),
        info["type"],
        info["type_length"],
        info["codec"],
        info["max_def"],
        info.get("max_rep", 0),
    )
    if not handle:
        raise RuntimeError(lib.spark_pq_last_error().decode("utf-8", "replace"))
    dt = _dtype_for(info)
    spec = {"dtype": (dt.kind, dt.bits, dt.precision, dt.scale), "offsets": None}
    with _DecodedChunk(lib, handle) as ch:
        spec["validity"] = ch.validity()
        if dt.kind == "string":
            spec["data"] = ch.values()
            spec["offsets"] = ch.offsets()
            return spec
        raw = ch.values()
        if dt.num_limbs == 2:
            spec["data"] = _flba_to_limbs(raw, info["type_length"])
        elif info["type"] == _PT_INT96:
            spec["data"] = _int96_to_micros(raw)
        else:
            host = raw.view(dt.np_dtype)
            if info["converted"] == _CT_TIMESTAMP_MILLIS:
                host = host * 1000  # millis -> the framework's micros
            spec["data"] = host
        return spec


def _spec_rows(spec: Dict) -> int:
    if spec["offsets"] is not None:
        return len(spec["offsets"]) - 1
    return len(spec["data"])


class ParquetReader:
    """Chunked reader over one parquet file; each row group is a chunk.

    ``schema`` (optional StructElement) prunes columns natively before
    any page byte is read: the footer path of the reference
    (ParquetFooter.readAndFilter) feeding its own decode stage. Columns
    land on ``device`` (default the card; raises without one).
    """

    def __init__(
        self,
        path: str,
        schema: Optional[StructElement] = None,
        part_offset: int = 0,
        part_length: int = -1,
        ignore_case: bool = False,
        device="cuda",
    ):
        self.path = path
        self.device = resolve_device(device)
        self._lib = native.load()
        footer_bytes = _read_footer_bytes(path)
        if schema is None:
            schema = _identity_schema(footer_bytes)  # keep every leaf
        self.footer = ParquetFooter.read_and_filter(
            footer_bytes, schema, part_offset, part_length, ignore_case
        )
        self.num_row_groups = self._lib.spark_pf_num_row_groups(self.footer._handle)
        if self.num_row_groups < 0:
            raise RuntimeError(
                self._lib.spark_pf_last_error().decode("utf-8", "replace")
            )
        self.num_columns = self.footer.get_num_columns()
        # serialize_thrift_file frames as PAR1 + thrift + len + PAR1
        pruned = self.footer.serialize_thrift_file()[4:-8]
        for name, nch, rep, _conv in _schema_tree(pruned):
            if nch or rep == _REPEATED:
                self.close()
                raise NotImplementedError(f"column {name!r}: {_NESTED_TODO}")

    def _chunk_info(self, rg: int, col: int) -> dict:
        out = (ctypes.c_int64 * 12)()
        rc = self._lib.spark_pf_chunk_info(self.footer._handle, rg, col, out)
        if rc != 0:
            raise RuntimeError(
                self._lib.spark_pf_last_error().decode("utf-8", "replace")
            )
        return {
            "type": int(out[0]),
            "type_length": int(out[1]),
            "codec": int(out[2]),
            "num_values": int(out[3]),
            "offset": int(out[4]),
            "size": int(out[5]),
            "max_def": int(out[6]),
            "scale": int(out[7]),
            "precision": int(out[8]),
            "converted": int(out[9]),
            "max_rep": int(out[10]),
            "rep_def": int(out[11]),
        }

    def read_row_group_host(self, rg: int) -> List[Dict]:
        """Row group ``rg`` decoded on the host: one numpy interop dict
        per column (``columnar/interop.py``), nothing on the device."""
        specs = []
        with open(self.path, "rb") as f:
            for ci in range(self.num_columns):
                info = self._chunk_info(rg, ci)
                f.seek(info["offset"])
                spec = _decode_column(self._lib, f.read(info["size"]), info)
                # a truncated/corrupt chunk must not shrink the table
                # silently: the footer count is the contract
                if _spec_rows(spec) != info["num_values"]:
                    raise RuntimeError(
                        f"column {ci} of row group {rg} decoded "
                        f"{_spec_rows(spec)} of {info['num_values']} values"
                    )
                specs.append(spec)
        return specs

    def read_row_group(self, rg: int) -> Table:
        return table_from_numpy(self.read_row_group_host(rg), self.device)

    def iter_row_groups(self) -> Iterator[Table]:
        for rg in range(self.num_row_groups):
            yield self.read_row_group(rg)

    def close(self):
        self.footer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _schema_tree(footer_bytes: bytes):
    """Depth-first (name, num_children, repetition, converted) nodes of
    the file schema, root excluded (parquet_footer.cpp
    spark_pf_schema_tree)."""
    lib = native.load()
    out = ctypes.POINTER(ctypes.c_char)()
    n = lib.spark_pf_schema_tree(footer_bytes, len(footer_bytes), ctypes.byref(out))
    if n < 0:
        raise RuntimeError(lib.spark_pf_last_error().decode("utf-8", "replace"))
    try:
        raw = ctypes.string_at(out, n)
    finally:
        lib.spark_pf_free_buffer(out)
    nodes = []
    for line in raw.decode("utf-8", "replace").splitlines():
        name, nch, rep, conv = line.split("\t")
        nodes.append((name, int(nch), int(rep), int(conv)))
    return nodes


def _identity_schema(footer_bytes: bytes) -> StructElement:
    """Build a keep-everything Spark schema from the file's own footer,
    reconstructing nested list/map structure from the schema tree."""
    from .parquet_footer import ListElement, MapElement, ValueElement

    nodes = _schema_tree(footer_bytes)
    pos = [0]

    def build():
        name, nch, _rep, conv = nodes[pos[0]]
        pos[0] += 1
        if nch == 0:
            return name, ValueElement()
        if conv == _CT_LIST:
            # 3-level list: group (LIST) { repeated group { element } }
            _rname, rnch, _rrep, _rconv = nodes[pos[0]]
            pos[0] += 1
            if rnch != 1:
                raise RuntimeError("unsupported LIST shape in schema")
            _ename, elem = build()
            return name, ListElement(elem)
        if conv in (_CT_MAP, _CT_MAP_KEY_VALUE):
            _kvname, kvnch, _kvrep, _kvconv = nodes[pos[0]]
            pos[0] += 1
            if kvnch != 2:
                raise RuntimeError("unsupported MAP shape in schema")
            _kn, key = build()
            _vn, value = build()
            return name, MapElement(key, value)
        children = [build() for _ in range(nch)]
        st = StructElement()
        for cn, ce in children:
            st.add_child(cn, ce)
        return name, st

    root = StructElement()
    total = len(nodes)
    while pos[0] < total:
        nm, elem = build()
        root.add_child(nm, elem)
    return root


def _schema_leaf_names(footer_bytes: bytes) -> List[str]:
    """Leaf column names via the native thrift parser (one thrift
    implementation for the whole stack: parquet_footer.cpp
    spark_pf_leaf_names)."""
    lib = native.load()
    out = ctypes.POINTER(ctypes.c_char)()
    n = lib.spark_pf_leaf_names(footer_bytes, len(footer_bytes), ctypes.byref(out))
    if n < 0:
        raise RuntimeError(lib.spark_pf_last_error().decode("utf-8", "replace"))
    try:
        raw = ctypes.string_at(out, n)
    finally:
        lib.spark_pf_free_buffer(out)
    if not raw:
        return []
    # NUL-joined with a trailing NUL: drop the final empty piece
    return [piece.decode("utf-8", "replace") for piece in raw.split(b"\0")[:-1]]


def read_table(
    path: str,
    schema: Optional[StructElement] = None,
    **kw,
) -> Table:
    """Read a whole (possibly column-pruned) parquet file as one Table;
    ``device=`` as in ``ParquetReader``."""
    with ParquetReader(path, schema, **kw) as r:
        parts = list(r.iter_row_groups())
    if not parts:
        raise ValueError(f"no row groups selected in {path}")
    if len(parts) == 1:
        return parts[0]
    cols = [_concat_col([p.columns[i] for p in parts]) for i in range(parts[0].num_columns)]
    return Table(cols, parts[0].names)
