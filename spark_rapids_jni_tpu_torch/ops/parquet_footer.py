"""ParquetFooter: natively parsed and filtered Parquet footer handles
(the port's twin of the JAX package's ``ops/parquet_footer.py``).

Python twin of the reference Java API (ParquetFooter.java: schema DSL
StructElement/ListElement/MapElement/ValueElement :35-93, depth-first
flattener :136-185, readAndFilter :200-217) over the C ABI of
``native/parquet_footer.cpp``, loaded through ``runtime/native.py``.
Host code only: the pruned footer feeds ``ops/parquet_reader.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import List, Sequence, Tuple

from ..runtime import native


class SchemaElement:
    """Base of the filter-schema DSL (ParquetFooter.java:35-93)."""

    TAG_VALUE = 0
    TAG_STRUCT = 1
    TAG_LIST = 2
    TAG_MAP = 3

    def _flatten(self, name, names, num_children, tags):
        raise NotImplementedError


class ValueElement(SchemaElement):
    def _flatten(self, name, names, num_children, tags):
        names.append(name)
        num_children.append(0)
        tags.append(self.TAG_VALUE)


class StructElement(SchemaElement):
    def __init__(self, children: Sequence[Tuple[str, "SchemaElement"]] = ()):
        self.children: List[Tuple[str, SchemaElement]] = list(children)

    def add_child(self, name: str, child: "SchemaElement"):
        self.children.append((name, child))
        return self

    def _flatten(self, name, names, num_children, tags):
        names.append(name)
        num_children.append(len(self.children))
        tags.append(self.TAG_STRUCT)
        for cname, c in self.children:
            c._flatten(cname, names, num_children, tags)

    def _flatten_root(self):
        names: List[str] = []
        num_children: List[int] = []
        tags: List[int] = []
        for cname, c in self.children:
            c._flatten(cname, names, num_children, tags)
        return names, num_children, tags, len(self.children)


class ListElement(SchemaElement):
    def __init__(self, element: SchemaElement):
        self.element = element

    def _flatten(self, name, names, num_children, tags):
        names.append(name)
        num_children.append(1)
        tags.append(self.TAG_LIST)
        self.element._flatten("element", names, num_children, tags)


class MapElement(SchemaElement):
    def __init__(self, key: SchemaElement, value: SchemaElement):
        self.key = key
        self.value = value

    def _flatten(self, name, names, num_children, tags):
        names.append(name)
        num_children.append(2)
        tags.append(self.TAG_MAP)
        self.key._flatten("key", names, num_children, tags)
        self.value._flatten("value", names, num_children, tags)


class ParquetFooter:
    """Handle to a natively parsed + filtered footer."""

    def __init__(self, handle: int):
        self._handle = handle
        self._lib = native.load()

    @staticmethod
    def read_and_filter(
        footer_bytes: bytes,
        schema: StructElement,
        part_offset: int = 0,
        part_length: int = -1,
        ignore_case: bool = False,
    ) -> "ParquetFooter":
        """Parse raw thrift footer bytes, prune to ``schema``, keep only
        row groups whose midpoint falls in [part_offset, part_offset +
        part_length) (part_length < 0 keeps all)."""
        lib = native.load()
        names, num_children, tags, parent_nc = schema._flatten_root()
        n = len(names)
        c_names = (ctypes.c_char_p * n)(*[s.encode("utf-8") for s in names])
        c_nc = (ctypes.c_int32 * n)(*num_children)
        c_tags = (ctypes.c_int32 * n)(*tags)
        handle = lib.spark_pf_read_and_filter(
            footer_bytes,
            len(footer_bytes),
            part_offset,
            part_length,
            c_names,
            c_nc,
            c_tags,
            n,
            parent_nc,
            1 if ignore_case else 0,
        )
        if not handle:
            raise RuntimeError(
                lib.spark_pf_last_error().decode("utf-8", "replace")
            )
        return ParquetFooter(handle)

    def get_num_rows(self) -> int:
        self._check_open()
        return self._lib.spark_pf_num_rows(self._handle)

    def get_num_columns(self) -> int:
        self._check_open()
        return self._lib.spark_pf_num_columns(self._handle)

    def chunk_stats(self, rg_idx: int, col_idx: int):
        """Raw Statistics of column chunk (rg_idx, col_idx), or ``None``
        when the writer recorded none. Returns a dict with
        ``null_count`` (int or None) and the four candidate bound byte
        strings (``min_value``/``max_value`` from the v2 fields,
        ``min_legacy``/``max_legacy`` from the deprecated ones); values
        are raw plain-encoded bytes — interpretation (and the
        numeric-only legacy-trust rule) belongs to the scan planner."""
        self._check_open()
        out = ctypes.POINTER(ctypes.c_char)()
        n = self._lib.spark_pf_chunk_stats(
            self._handle, rg_idx, col_idx, ctypes.byref(out)
        )
        if n < 0:
            raise RuntimeError(
                self._lib.spark_pf_last_error().decode("utf-8", "replace")
            )
        if n == 0:
            return None
        try:
            buf = ctypes.string_at(out, n)
        finally:
            self._lib.spark_pf_free_buffer(out)
        null_count = int.from_bytes(buf[0:8], "little", signed=True)
        flags = buf[8]
        pos = 9
        vals = []
        for bit in range(4):
            if flags & (1 << bit):
                ln = int.from_bytes(buf[pos : pos + 8], "little", signed=True)
                pos += 8
                vals.append(buf[pos : pos + ln])
                pos += ln
            else:
                vals.append(None)
        return {
            "null_count": None if null_count < 0 else null_count,
            "min_value": vals[0],
            "max_value": vals[1],
            "min_legacy": vals[2],
            "max_legacy": vals[3],
        }

    def serialize_thrift_file(self) -> bytes:
        """Filtered footer as PAR1-framed bytes for a parquet reader
        (PAR1 + thrift + little-endian length + PAR1)."""
        self._check_open()
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.spark_pf_serialize(self._handle, ctypes.byref(out))
        if n < 0:
            raise RuntimeError(
                self._lib.spark_pf_last_error().decode("utf-8", "replace")
            )
        return ctypes.string_at(out, n)

    def _check_open(self):
        if self._handle is None:
            raise ValueError("footer is closed")

    def close(self):
        if self._handle is not None:
            self._lib.spark_pf_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        with contextlib.suppress(Exception):
            self.close()
