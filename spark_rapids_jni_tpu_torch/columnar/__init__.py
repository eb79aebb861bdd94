from .dtypes import (
    DType,
    BOOL8,
    INT8,
    INT16,
    INT32,
    INT64,
    FLOAT32,
    FLOAT64,
    STRING,
    BINARY,
    DECIMAL32,
    DECIMAL64,
    DECIMAL128,
    TIMESTAMP_MICROS,
    DATE32,
)
from .column import Column
from .table import Table

__all__ = [
    "DType",
    "BOOL8",
    "INT8",
    "INT16",
    "INT32",
    "INT64",
    "FLOAT32",
    "FLOAT64",
    "STRING",
    "BINARY",
    "DECIMAL32",
    "DECIMAL64",
    "DECIMAL128",
    "TIMESTAMP_MICROS",
    "DATE32",
    "Column",
    "Table",
]
