"""ctypes signatures of the host Parquet library ``sparkpf`` (the port's
twin of the JAX package's ``runtime/native.py``).

The library is the footer parser and page decoder of ``native/``
(``spark_pf_*`` in ``parquet_footer.cpp``, ``spark_pq_*`` in
``parquet_pages.cpp``), reused unchanged and compiled by
``kernels/_build.py`` on first use, never through ``make``. Nothing is
built at import.
"""

from __future__ import annotations

import ctypes

from ..kernels import _build

_c = ctypes
_I64P = _c.POINTER(_c.c_int64)
_CHARPP = _c.POINTER(_c.POINTER(_c.c_char))

# name -> (restype, argtypes)
# sprtcheck: guarded-by=frozen
_SIGNATURES = {
    "spark_pf_last_error": (_c.c_char_p, []),
    "spark_pf_read_and_filter": (_c.c_void_p, [
        _c.c_char_p,  # buf
        _c.c_uint64,  # len
        _c.c_int64,  # part_offset
        _c.c_int64,  # part_length
        _c.POINTER(_c.c_char_p),  # names
        _c.POINTER(_c.c_int32),  # num_children
        _c.POINTER(_c.c_int32),  # tags
        _c.c_int32,  # n_names
        _c.c_int32,  # parent_num_children
        _c.c_int32,  # ignore_case
    ]),
    "spark_pf_close": (None, [_c.c_void_p]),
    "spark_pf_num_rows": (_c.c_int64, [_c.c_void_p]),
    "spark_pf_num_columns": (_c.c_int64, [_c.c_void_p]),
    "spark_pf_serialize": (_c.c_int64, [_c.c_void_p, _c.POINTER(_c.POINTER(_c.c_uint8))]),
    "spark_pf_num_row_groups": (_c.c_int64, [_c.c_void_p]),
    "spark_pf_rg_num_rows": (_c.c_int64, [_c.c_void_p, _c.c_int32]),
    "spark_pf_chunk_info": (_c.c_int32, [_c.c_void_p, _c.c_int32, _c.c_int32, _I64P]),
    "spark_pf_chunk_stats": (_c.c_int64, [_c.c_void_p, _c.c_int32, _c.c_int32, _CHARPP]),
    "spark_pf_leaf_names": (_c.c_int64, [_c.c_char_p, _c.c_uint64, _CHARPP]),
    "spark_pf_schema_tree": (_c.c_int64, [_c.c_char_p, _c.c_uint64, _CHARPP]),
    "spark_pf_free_buffer": (None, [_c.POINTER(_c.c_char)]),
    # ---- page decoder (parquet_pages.cpp) ----
    "spark_pq_last_error": (_c.c_char_p, []),
    "spark_pq_has_zstd": (_c.c_int32, []),
    "spark_pq_decode_chunk": (_c.c_void_p, [
        _c.c_char_p,  # buf
        _c.c_uint64,  # len
        _c.c_int32,  # physical type
        _c.c_int32,  # type_length
        _c.c_int32,  # codec
        _c.c_int32,  # max_def
        _c.c_int32,  # max_rep
    ]),
    "spark_pq_num_values": (_c.c_int64, [_c.c_void_p]),
    "spark_pq_has_nulls": (_c.c_int32, [_c.c_void_p]),
    "spark_pq_values": (_c.POINTER(_c.c_uint8), [_c.c_void_p, _I64P]),
    "spark_pq_offsets": (_c.POINTER(_c.c_int32), [_c.c_void_p, _I64P]),
    "spark_pq_validity": (_c.POINTER(_c.c_uint8), [_c.c_void_p]),
    "spark_pq_def_levels": (_c.POINTER(_c.c_int32), [_c.c_void_p, _I64P]),
    "spark_pq_rep_levels": (_c.POINTER(_c.c_int32), [_c.c_void_p, _I64P]),
    "spark_pq_free": (None, [_c.c_void_p]),
}


def load() -> ctypes.CDLL:
    """The ``sparkpf`` library with its signatures declared, built on
    first use."""
    lib = _build.load("sparkpf")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
