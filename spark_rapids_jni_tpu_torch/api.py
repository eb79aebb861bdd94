"""API façade of the port: the reference's Java class surface, one
Python class per Java class (PyTorch twin of the JAX package's
``api.py``). This slice carries ``RowConversion``."""

from __future__ import annotations

from typing import List, Sequence

from .columnar.column import Column
from .columnar.dtypes import DType
from .columnar.table import Table
from .ops import row_conversion as _row_conversion


class RowConversion:
    """RowConversion.java:35-173 — Table <-> JCUDF row bytes."""

    @staticmethod
    def convertToRows(table: Table) -> List[Column]:
        return _row_conversion.convert_to_rows(table)

    @staticmethod
    def convertToRowsFixedWidthOptimized(table: Table) -> List[Column]:
        return _row_conversion.convert_to_rows_fixed_width_optimized(table)

    @staticmethod
    def convertFromRows(vec: Sequence[Column], schema: Sequence[DType]) -> Table:
        return _row_conversion.convert_from_rows(vec, schema)

    @staticmethod
    def convertFromRowsFixedWidthOptimized(
        vec: Sequence[Column], schema: Sequence[DType]
    ) -> Table:
        return _row_conversion.convert_from_rows_fixed_width_optimized(vec, schema)
