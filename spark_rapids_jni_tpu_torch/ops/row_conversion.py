"""JCUDF row format <-> columnar tables (PyTorch twin of the JAX
package's ``ops/row_conversion.py``).

Wire format, byte for byte the JAX package's (and the reference's):

- columns laid out in declared order; each fixed-width column aligned to
  its element size; a string column occupies an 8-byte (offset, length)
  uint32 pair aligned to 4,
- validity bits directly after the last column, byte aligned, one bit
  per column, LSB-first within each byte, 1 = valid,
- string payloads after the validity bytes, concatenated in column
  order; the in-row offset counts from the start of the row,
- every row padded with zeros to 8 bytes,
- row batches split at 32-row multiples so that no batch exceeds
  ``max_batch_bytes``.

The JAX package composes rows in u32 word lanes with lane permutations,
because byte-granular arrays and scatters are slow on the TPU. Here a
row batch is a uint8 buffer built from byte views of the columns
(``tensor.view(torch.uint8)``), slice copies into a zeroed ``[n, row]``
matrix, and index scatters/gathers for the variable-width part.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.dtypes import BINARY, DType
from ..columnar.strings import bucket_length, from_char_matrix, to_char_matrix
from ..columnar.table import Table
from ..kernels import native
from .ragged import ragged_scatter, ragged_unpack
from .segmented import hs_cumsum

JCUDF_ROW_ALIGNMENT = 8
# Reference splits output into <2GB batches (int32 offsets).
DEFAULT_MAX_BATCH_BYTES = (1 << 31) - 1024
ROW_BATCH_ALIGN = 32


def _round_up(x: int, to: int) -> int:
    return (x + to - 1) // to * to


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Static (host-side) description of the JCUDF row layout."""

    col_starts: tuple  # per column, byte offset within row
    col_sizes: tuple  # per column, bytes occupied in fixed section
    validity_offset: int
    validity_bytes: int
    fixed_row_size: int  # end of validity, before payload, unaligned
    var_cols: tuple  # indices of variable-width columns
    fixed_only_row_size: int  # fixed tables: full row size (8-aligned)

    @property
    def num_columns(self) -> int:
        return len(self.col_starts)


def compute_row_layout(dtypes: Sequence[DType]) -> RowLayout:
    """Offsets per column using the reference's alignment rules
    (row_conversion.cu compute_column_information)."""
    dtypes = list(dtypes)
    starts, sizes, var_cols = [], [], []
    off = 0
    for i, dt in enumerate(dtypes):
        if dt.is_fixed_width:
            size = align = dt.size_bytes
        else:  # string/binary: (offset, length) uint32 pair
            size, align = 8, 4
            var_cols.append(i)
        off = _round_up(off, align)
        starts.append(off)
        sizes.append(size)
        off += size
    validity_bytes = (len(dtypes) + 7) // 8
    fixed_row_size = off + validity_bytes
    return RowLayout(
        tuple(starts),
        tuple(sizes),
        off,
        validity_bytes,
        fixed_row_size,
        tuple(var_cols),
        _round_up(fixed_row_size, JCUDF_ROW_ALIGNMENT),
    )


def _empty_batch(device) -> Column:
    return Column(
        BINARY,
        torch.zeros((0,), dtype=torch.uint8, device=device),
        None,
        torch.zeros((1,), dtype=torch.int32, device=device),
    )


def _pack_validity(table: Table) -> torch.Tensor:
    """uint8 [n, validity_bytes]: LSB-first bit per column, 1 = valid."""
    n, ncols = table.num_rows, table.num_columns
    dev = table.columns[0].device
    nbytes = (ncols + 7) // 8
    out = torch.zeros((n, nbytes), dtype=torch.uint8, device=dev)
    for i, col in enumerate(table.columns):
        if col.validity is None:
            out[:, i // 8] |= 1 << (i % 8)
        else:
            out[:, i // 8] |= col.validity.to(torch.uint8) << (i % 8)
    return out


def _fixed_section(table: Table, layout: RowLayout, width: int, var_pairs=None):
    """uint8 [n, width]: each fixed-width column's bytes, each string
    column's (offset, length) pair, the validity bytes, zeros between.
    ``var_pairs`` maps a varlen column index to its int32 (offset,
    length) tensors."""
    n = table.num_rows
    rows = torch.zeros((n, width), dtype=torch.uint8, device=table.columns[0].device)
    for i, col in enumerate(table.columns):
        start, size = layout.col_starts[i], layout.col_sizes[i]
        if col.is_varlen:
            pair = torch.stack(var_pairs[i], dim=1).to(torch.int32)
            rows[:, start : start + size] = pair.view(torch.uint8)
        else:
            rows[:, start : start + size] = (
                col.data.reshape(-1).view(torch.uint8).reshape(n, size)
            )
    vo = layout.validity_offset
    rows[:, vo : vo + layout.validity_bytes] = _pack_validity(table)
    return rows


def _plan_batches(row_sizes: np.ndarray, max_batch_bytes: int) -> List[slice]:
    """32-row-aligned splits with cumulative size <= max_batch_bytes
    (the reference's build_batches, row_conversion.cu:1465-1543)."""
    n = len(row_sizes)
    if n == 0:
        return [slice(0, 0)]
    csum = np.cumsum(row_sizes, dtype=np.int64)
    batches = []
    start = 0
    while start < n:
        base = csum[start - 1] if start else 0
        end = int(np.searchsorted(csum, base + max_batch_bytes, side="right"))
        if end <= start:
            raise ValueError(
                f"row {start} of size {row_sizes[start]} exceeds "
                f"max_batch_bytes={max_batch_bytes}"
            )
        if end < n and end - start >= ROW_BATCH_ALIGN:
            end = (end - start) // ROW_BATCH_ALIGN * ROW_BATCH_ALIGN + start
        batches.append(slice(start, min(end, n)))
        start = min(end, n)
    return batches


# sprtcheck: host-side — the host view of a row batch (host codec, tests)
def row_batch_bytes(col: Column) -> np.ndarray:
    """Host-side JCUDF bytes of one row-batch column."""
    return col.data.cpu().numpy().view(np.uint8)


# sprtcheck: host-side — a façade entry, never a Pipeline stage: the row bytes size the batches
def convert_to_rows(
    table: Table, max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES
) -> List[Column]:
    """Table -> one or more BINARY columns of JCUDF rows (uint8 data,
    int32 row offsets). Mirrors RowConversion.convertToRows; more than
    one column comes back when the rows exceed ``max_batch_bytes``."""
    layout = compute_row_layout([c.dtype for c in table.columns])
    n = table.num_rows
    dev = table.columns[0].device
    if n == 0:
        return [_empty_batch(dev)]
    if not layout.var_cols:
        row_size = layout.fixed_only_row_size
        if dev.type == "cuda":  # the row kernel
            flat = native.to_rows(table.columns).reshape(-1)
        else:
            flat = _fixed_section(table, layout, row_size).reshape(-1)
        # constant stride: the batch plan is a division
        per = max_batch_bytes // row_size
        if per >= ROW_BATCH_ALIGN:
            per = per // ROW_BATCH_ALIGN * ROW_BATCH_ALIGN
        per = max(per, 1)
        out = []
        for start in range(0, n, per):
            nb = min(per, n - start)
            offsets = torch.arange(nb + 1, dtype=torch.int32, device=dev) * row_size
            data = flat[start * row_size : (start + nb) * row_size]
            out.append(Column(BINARY, data, None, offsets))
        return out
    # Variable width: exact per-row sizes, one host read of the sizes
    # the buffer needs, then the fixed sections and each string
    # column's payload are scattered to their exact byte positions.
    lens = [table.columns[i].string_lengths().to(torch.int64) for i in layout.var_cols]
    cursors = []
    cur = torch.full((n,), layout.fixed_row_size, dtype=torch.int64, device=dev)
    for ln in lens:
        cursors.append(cur)
        cur = cur + ln
    a = JCUDF_ROW_ALIGNMENT
    row_sizes = (cur + (a - 1)) // a * a
    row_offsets = torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=dev), hs_cumsum(row_sizes)]
    )
    total = int(row_offsets[-1])
    var_pairs = {ci: (cursors[k], lens[k]) for k, ci in enumerate(layout.var_cols)}
    F = layout.fixed_row_size
    fixed = _fixed_section(table, layout, F, var_pairs)
    buf = torch.zeros((total,), dtype=torch.uint8, device=dev)
    starts = row_offsets[:-1]
    ragged_scatter(buf, fixed, starts, torch.full((n,), F, dtype=torch.int64, device=dev))
    for k, ci in enumerate(layout.var_cols):
        chars, ln = to_char_matrix(table.columns[ci])
        payload = chars.clamp(min=0).to(torch.uint8)
        ragged_scatter(buf, payload, starts + cursors[k], ln)
    if total <= max_batch_bytes:
        return [Column(BINARY, buf, None, row_offsets.to(torch.int32))]
    # Multi-batch: plan the 32-row-aligned splits on the host.
    offs_host = row_offsets.cpu().numpy()
    out = []
    for sl in _plan_batches(np.diff(offs_host), max_batch_bytes):
        base, end = int(offs_host[sl.start]), int(offs_host[sl.stop])
        offs_b = (row_offsets[sl.start : sl.stop + 1] - base).to(torch.int32)
        out.append(Column(BINARY, buf[base:end], None, offs_b))
    return out


def convert_to_rows_fixed_width_optimized(table: Table) -> List[Column]:
    """Parity with RowConversion.convertToRowsFixedWidthOptimized:
    fixed-width only, < 100 columns, rows of at most 1KB."""
    if table.num_columns >= 100:
        raise ValueError("fixed-width optimized path supports < 100 columns")
    layout = compute_row_layout([c.dtype for c in table.columns])
    if layout.var_cols:
        raise TypeError("only fixed-width column types are supported")
    if layout.fixed_only_row_size > 1024:
        raise ValueError("row larger than 1KB")
    return convert_to_rows(table)


def _decode_fixed(rows: torch.Tensor, schema: tuple, layout: RowLayout):
    """Typed columns (varlen: int32 (offset, length) pairs) and bool
    validity from a uint8 [n, >= fixed_row_size] row matrix."""
    n = rows.shape[0]
    cols = {}
    for i, dt in enumerate(schema):
        start, size = layout.col_starts[i], layout.col_sizes[i]
        # flat copy, then a byte view: a strided slice has no typed view
        raw = rows[:, start : start + size].reshape(-1)
        if dt.is_fixed_width:
            data = raw.view(dt.torch_dtype)
            cols[i] = data.reshape(n, 2) if dt.num_limbs > 1 else data
        else:
            pair = raw.view(torch.int32).reshape(n, 2)
            cols[i] = (pair[:, 0], pair[:, 1])
    vo = layout.validity_offset
    validity = {
        i: ((rows[:, vo + i // 8] >> (i % 8)) & 1).to(torch.bool)
        for i in range(len(schema))
    }
    return cols, validity


# sprtcheck: host-side — a façade entry, never a Pipeline stage: the longest row sizes the decode
def _from_rows_single(rc: Column, schema: tuple, layout: RowLayout) -> Table:
    n = len(rc)
    data = rc.data.view(torch.uint8) if rc.data.dtype != torch.uint8 else rc.data
    starts = rc.offsets[:-1]
    if not layout.var_cols:
        row_size = layout.fixed_only_row_size
        if data.shape[0] == n * row_size:
            rows = data.reshape(n, row_size)
        else:  # sliced or foreign buffer: offsets-driven gather
            rows = ragged_unpack(data, starts, row_size)
        if rows.device.type == "cuda":  # the row kernel
            cols = native.from_rows(rows, schema)
            return Table([Column(dt, d, v) for dt, (d, v) in zip(schema, cols)])
        cols, validity = _decode_fixed(rows, schema, layout)
        return Table([Column(dt, cols[i], validity[i]) for i, dt in enumerate(schema)])
    cols, validity = _decode_fixed(
        ragged_unpack(data, starts, layout.fixed_row_size), schema, layout
    )
    out = []
    for i, dt in enumerate(schema):
        v = validity[i]
        if dt.is_fixed_width:
            out.append(Column(dt, cols[i], v))
            continue
        off_in_row, lengths = cols[i]
        max_len = int(lengths.max()) if n else 0
        L = bucket_length(max(max_len, 1))
        raw = ragged_unpack(data, starts.to(torch.int64) + off_in_row, L)
        pos = torch.arange(L, dtype=torch.int32, device=raw.device)[None, :]
        chars = torch.where(pos < lengths[:, None], raw.to(torch.int32), -1)
        out.append(from_char_matrix(chars, lengths, v, dtype=dt))
    return Table(out)


# sprtcheck: host-side — joins row batches on the host side of the façade
def _concat_col(cs: List[Column]) -> Column:
    """Concatenate the parts of one column: a mask only when some part
    has one (the others count as all valid), offsets rebased."""
    validity = None
    if any(c.validity is not None for c in cs):
        validity = torch.cat([c.validity_or_true() for c in cs])
    if not cs[0].is_varlen:
        return Column(cs[0].dtype, torch.cat([c.data for c in cs]), validity)
    offs, base = [cs[0].offsets[:1]], 0
    for c in cs:
        offs.append(c.offsets[1:] + base)
        base += int(c.offsets[-1])
    return Column(cs[0].dtype, torch.cat([c.data for c in cs]), validity, torch.cat(offs))


def convert_from_rows(row_cols: Sequence[Column], schema: Sequence[DType]) -> Table:
    """BINARY row columns -> Table (RowConversion.convertFromRows).

    Output columns always carry explicit validity masks, as the JAX
    package's do."""
    schema = tuple(schema)
    layout = compute_row_layout(schema)
    parts = [_from_rows_single(rc, schema, layout) for rc in row_cols]
    if len(parts) == 1:
        return parts[0]
    return Table([_concat_col([p.columns[i] for p in parts]) for i in range(len(schema))])


def convert_from_rows_fixed_width_optimized(
    row_cols: Sequence[Column], schema: Sequence[DType]
) -> Table:
    """Parity with RowConversion.convertFromRowsFixedWidthOptimized."""
    schema_t = tuple(schema)
    if len(schema_t) >= 100:
        raise ValueError("fixed-width optimized path supports < 100 columns")
    if any(not dt.is_fixed_width for dt in schema_t):
        raise TypeError("only fixed-width column types are supported")
    return convert_from_rows(row_cols, schema_t)
