"""Chunked Parquet reader: native host page decode feeding device columns
(the port's twin of the JAX package's ``ops/parquet_reader.py``).

BASELINE.md staged config 4 ("Parquet chunked reader + CastStrings /
get_json_object"). The host C++ of ``native/parquet_pages.cpp`` (thrift
page headers, snappy, gzip, RLE / bit-packed, dictionaries) decodes each
column chunk into dense numpy buffers; this module moves them to the
device as columns, one row group at a time. Each row group is one
chunk: ``iter_row_groups`` streams them (the chunked-reader contract,
bounded memory), ``read_table`` concatenates.

Type mapping:
  BOOLEAN->BOOL8, INT32->INT32/DATE32/DECIMAL32, INT64->INT64/
  TIMESTAMP/DECIMAL64, INT96->TIMESTAMP, FLOAT->FLOAT32,
  DOUBLE->FLOAT64, BYTE_ARRAY->STRING, FIXED_LEN_BYTE_ARRAY(decimal)->
  DECIMAL128 (big-endian unscaled -> [lo, hi] int64 limbs).

Nested roots (structs at any depth, maps as list<struct<key, value>>,
multi-level lists, legacy two-level repeated fields) assemble on the
host from the decoder's per-level-entry (value, def, rep) streams by
Dremel record assembly (``_typed_tree`` / ``_assemble_node``), into the
numpy interop form of ``columnar/interop.py``; the leaves then go to the
device as the flat columns do, as ``ListColumn`` / ``StructColumn``
trees (``columnar/nested.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

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
from ..columnar.nested import ListColumn, StructColumn
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


# ---------------------------------------------------------------------------
# Dremel record assembly: structs at any depth, maps, multi-level lists.
# The decoder exposes per-level-entry (values, def, rep) streams of each
# leaf; the host rebuilds the nested columns from them in numpy.
# ---------------------------------------------------------------------------


class _PNode:
    """One pruned-schema node with cumulative Dremel levels."""

    __slots__ = (
        "name", "children", "repetition", "converted", "max_def", "max_rep", "leaf_idx",
    )

    def __init__(self, name, repetition, converted, max_def, max_rep):
        self.name = name
        self.children = []
        self.repetition = repetition  # 0 required, 1 optional, 2 repeated
        self.converted = converted
        self.max_def = max_def
        self.max_rep = max_rep
        self.leaf_idx = None


def _typed_tree(nodes) -> List[_PNode]:
    """Schema-tree nodes -> typed roots with (max_def, max_rep) and DFS
    leaf indices (leaf order == flat column order, the parquet
    contract)."""
    pos = [0]
    leaf = [0]

    def build(d: int, r: int) -> _PNode:
        name, nch, rep, conv = nodes[pos[0]]
        pos[0] += 1
        d2 = d + (1 if rep != 0 else 0)
        r2 = r + (1 if rep == 2 else 0)
        node = _PNode(name, rep, conv, d2, r2)
        if nch == 0:
            node.leaf_idx = leaf[0]
            leaf[0] += 1
        else:
            node.children = [build(d2, r2) for _ in range(nch)]
        return node

    roots = []
    while pos[0] < len(nodes):
        roots.append(build(0, 0))
    return roots


def _subtree_leaves(node: _PNode) -> int:
    if node.leaf_idx is not None:
        return 1
    return sum(_subtree_leaves(c) for c in node.children)


def _decode_leaf_arrays(lib, data: bytes, info: dict) -> dict:
    """Per-level-entry streams of one leaf chunk: ``defs`` / ``reps``
    int32 [nv], plus values: fixed-width one slot per entry, strings as
    (payload bytes, per-entry lengths)."""
    handle = lib.spark_pq_decode_chunk(
        data, len(data), info["type"], info["type_length"], info["codec"],
        info["max_def"], info["max_rep"],
    )
    if not handle:
        raise RuntimeError(lib.spark_pq_last_error().decode("utf-8", "replace"))
    dt = _dtype_for(info)
    with _DecodedChunk(lib, handle) as ch:
        nv = ch.num_values()
        if nv != info["num_values"]:
            raise RuntimeError(
                f"nested column decoded {nv} of {info['num_values']} level entries"
            )
        n = ctypes.c_int64()
        dp = lib.spark_pq_def_levels(ch._h, ctypes.byref(n))
        if n.value:
            defs = np.ctypeslib.as_array(dp, (n.value,)).copy()
        elif info["max_def"] <= 1:
            # flat/shallow leaf: the decoder kept only element validity
            v = ch.validity()
            defs = (
                np.full(nv, info["max_def"], np.int32)
                if v is None
                else v.astype(np.int32) * info["max_def"]
            )
        else:
            raise RuntimeError("decoder retained no def levels")
        rp = lib.spark_pq_rep_levels(ch._h, ctypes.byref(n))
        reps = (
            np.ctypeslib.as_array(rp, (n.value,)).copy() if n.value else np.zeros(nv, np.int32)
        )
        out = {"dt": dt, "defs": defs, "reps": reps}
        if dt.kind == "string":
            out["payload"] = ch.values()
            out["lens"] = np.diff(ch.offsets())
        else:
            raw = ch.values()
            if dt.num_limbs == 2:
                out["values"] = _flba_to_limbs(raw, info["type_length"])
            elif info["type"] == _PT_INT96:
                out["values"] = _int96_to_micros(raw)
            else:
                host = raw.view(dt.np_dtype)
                if info["converted"] == _CT_TIMESTAMP_MILLIS:
                    host = host * 1000
                out["values"] = host
        return out


def _leaf_column(node: _PNode, la: dict, base_def: int) -> Dict:
    """A leaf's entries (one per instance slot) in the interop form."""
    dt = la["dt"]
    valid = None
    if node.max_def > base_def:
        v = la["defs"] >= node.max_def
        if not v.all():
            valid = v
    spec = {"dtype": (dt.kind, dt.bits, dt.precision, dt.scale), "validity": valid,
            "offsets": None}
    if dt.kind == "string":
        # non-element slots are zero-length, so the payload already holds
        # exactly the element bytes in order
        offs = np.zeros(len(la["lens"]) + 1, np.int32)
        np.cumsum(la["lens"], out=offs[1:])
        spec["data"], spec["offsets"] = la["payload"], offs
    else:
        spec["data"] = la["values"]
    return spec


def _filter_leaf(la: dict, mask: np.ndarray) -> dict:
    out = {"dt": la["dt"], "defs": la["defs"][mask], "reps": la["reps"][mask]}
    if "lens" in la:
        out["payload"] = la["payload"]  # dropped slots are 0-length
        out["lens"] = la["lens"][mask]
    else:
        out["values"] = la["values"][mask]
    return out


def _list_offsets(la0: dict, base_rep: int, r_elem: int, d_rep: int):
    """(int32 offsets [n+1], instance-slot mask) of one list level from
    its first leaf's streams: an instance slot starts where the
    repetition returns to ``base_rep`` or above; an ELEMENT starts where
    it returns to ``r_elem`` or above (deeper entries continue the same
    element) and the definition depth says it exists."""
    defs0, reps0 = la0["defs"], la0["reps"]
    inst = reps0 <= base_rep
    elem0 = (reps0 <= r_elem) & (defs0 >= d_rep)
    counts = np.add.reduceat(elem0, np.flatnonzero(inst)) if len(defs0) else np.zeros(0, np.int64)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32), inst


def _assemble_node(node: _PNode, leaves: List[dict], base_rep: int, base_def: int,
                   as_element: bool = False) -> Dict:
    """Assemble one schema subtree into the interop form; ``leaves``
    hold this subtree's level-entry streams filtered to exactly one
    entry per instance slot of the enclosing container. ``as_element``
    marks a repeated node whose repetition the caller (a LIST/MAP
    wrapper) already consumed."""
    if node.repetition == 2 and not as_element:
        # bare repeated field (legacy 2-level lists, protobuf-style
        # writers): an implicit list<node> with no LIST wrapper group;
        # def >= max_def means >= 1 element, below it the list is empty
        # (nullness, if any, belongs to an optional ancestor)
        d_rep = node.max_def
        offsets, _inst = _list_offsets(leaves[0], base_rep, node.max_rep, d_rep)
        child_leaves = [_filter_leaf(la, la["defs"] >= d_rep) for la in leaves]
        elem = _assemble_node(node, child_leaves, node.max_rep, d_rep, as_element=True)
        return {"list": elem, "offsets": offsets, "validity": None}

    if node.leaf_idx is not None:
        return _leaf_column(node, leaves[0], base_def)

    if node.converted in (_CT_LIST, _CT_MAP, _CT_MAP_KEY_VALUE):
        rep_child = node.children[0]
        if rep_child.repetition != 2:
            raise RuntimeError("unsupported LIST/MAP shape (no repeated group)")
        d_rep, r_elem = rep_child.max_def, rep_child.max_rep
        offsets, inst = _list_offsets(leaves[0], base_rep, r_elem, d_rep)
        defs0 = leaves[0]["defs"]
        lvalid = defs0[inst] >= node.max_def if len(defs0) else np.zeros(0, bool)
        child_leaves = [_filter_leaf(la, la["defs"] >= d_rep) for la in leaves]
        if node.converted != _CT_LIST:  # map: repeated key_value struct
            if len(rep_child.children) != 2:
                raise RuntimeError("unsupported MAP shape")
            elem = _assemble_struct(rep_child, child_leaves, r_elem, d_rep)
        elif rep_child.leaf_idx is None and len(rep_child.children) != 1:
            # repeated group with several fields = list<struct<...>>
            elem = _assemble_struct(rep_child, child_leaves, r_elem, d_rep)
        else:
            # 3-level list, or a legacy 2-level repeated leaf
            elem_node = rep_child if rep_child.leaf_idx is not None else rep_child.children[0]
            elem = _assemble_node(
                elem_node, child_leaves, r_elem, d_rep, as_element=elem_node is rep_child
            )
        return {"list": elem, "offsets": offsets,
                "validity": None if lvalid.all() else lvalid}

    return _assemble_struct(node, leaves, base_rep, base_def)


def _assemble_struct(node: _PNode, leaves: List[dict], base_rep: int, base_def: int) -> Dict:
    """Struct (or repeated-group element struct): children keep the
    parent's entry alignment; nullness comes from the definition depth
    of any descendant leaf."""
    children, names, k = [], [], 0
    for ch in node.children:
        w = _subtree_leaves(ch)
        children.append(_assemble_node(ch, leaves[k : k + w], base_rep, node.max_def))
        names.append(ch.name)
        k += w
    validity = None
    if node.repetition == 1 and node.max_def > base_def:
        # one sample per instance slot: a child list's leaf stream has
        # several entries per instance, so filter to instance starts
        la0 = leaves[0]
        v = la0["defs"][la0["reps"] <= base_rep] >= node.max_def
        if not v.all():
            validity = v
    return {"struct": children, "names": tuple(names), "validity": validity}


def _concat(parts):
    """Concatenate the row-group parts of one column: flat, list or
    struct (recursively)."""
    first = parts[0]
    if not isinstance(first, (ListColumn, StructColumn)):
        return _concat_col(parts)
    validity = None
    if any(p.validity is not None for p in parts):
        validity = torch.cat([p.validity_or_true() for p in parts])
    if isinstance(first, StructColumn):
        kids = [_concat([p.children[i] for p in parts]) for i in range(len(first.children))]
        return StructColumn(tuple(kids), validity, first.names)
    offs, base = [first.offsets[:1]], 0
    for p in parts:
        offs.append(p.offsets[1:] + base)
        base += int(p.offsets[-1])
    return ListColumn(torch.cat(offs), _concat([p.child for p in parts]), validity)


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
        # typed tree of the PRUNED schema (leaf order == flat column
        # order): drives the record assembly of nested roots.
        # serialize_thrift_file frames as PAR1 + thrift + len + PAR1
        pruned = self.footer.serialize_thrift_file()[4:-8]
        self._roots = _typed_tree(_schema_tree(pruned))

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
        per root column (``columnar/interop.py``; nested roots as list /
        struct dicts), nothing on the device."""
        specs = []
        ci = 0
        with open(self.path, "rb") as f:

            def read_chunk(idx):
                info = self._chunk_info(rg, idx)
                f.seek(info["offset"])
                return f.read(info["size"]), info

            for root in self._roots:
                nleaves = _subtree_leaves(root)
                if root.leaf_idx is not None and root.max_rep == 0:
                    data, info = read_chunk(ci)
                    spec = _decode_column(self._lib, data, info)
                    # a truncated/corrupt chunk must not shrink the table
                    # silently: the footer count is the contract
                    if _spec_rows(spec) != info["num_values"]:
                        raise RuntimeError(
                            f"column {ci} of row group {rg} decoded "
                            f"{_spec_rows(spec)} of {info['num_values']} values"
                        )
                else:
                    leaves = [
                        _decode_leaf_arrays(self._lib, *read_chunk(ci + k))
                        for k in range(nleaves)
                    ]
                    spec = _assemble_node(root, leaves, 0, 0)
                specs.append(spec)
                ci += nleaves
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
    cols = [_concat([p.columns[i] for p in parts]) for i in range(parts[0].num_columns)]
    return Table(cols, parts[0].names)
