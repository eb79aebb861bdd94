"""String column <-> padded character matrix (PyTorch twin of the JAX
package's ``columnar/strings.py``).

A string column's payload becomes an ``int32 [n, L]`` matrix with -1
past each row's end (a value no UTF-8 byte takes); ``L`` is the max
length bucketed to a power of two from 8, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops._strategy import fused
from ..ops.ragged import ragged_pack, ragged_unpack
from .column import Column, make_string_column

# Pad bucket sizes: powers of two from 8 up.
_BUCKETS = tuple(8 * (2**i) for i in range(16))


def live_span_stats(offsets: torch.Tensor, keep: torch.Tensor):
    """(total_bytes, max_len) int32 0-d tensors of the varlen rows
    selected by ``keep`` (bool [n]), left on the device."""
    lens = (offsets[1:] - offsets[:-1]).to(torch.int32)
    lens = torch.where(keep, lens, 0)
    return lens.sum(dtype=torch.int32), torch.cat([lens, lens.new_zeros(1)]).max()


def bucket_length(max_len: int) -> int:
    for b in _BUCKETS:
        if max_len <= b:
            return b
    return int(max_len)


def to_char_matrix(col: Column, L: int | None = None):
    """Return (chars int32 [n, L], lengths int32 [n]).

    Out-of-range positions hold -1. Null rows have length 0. With an
    explicit ``L``, longer strings are truncated and their lengths
    clamped to ``L``."""
    lengths = col.string_lengths()
    n = len(col)
    if L is None:
        max_len = int(lengths.max()) if n else 0
        L = bucket_length(max(max_len, 1))
    else:
        lengths = torch.clamp(lengths, max=L)
    raw = ragged_unpack(col.data, col.offsets[:-1], L)
    pos = torch.arange(L, dtype=torch.int32, device=raw.device)[None, :]
    chars = torch.where(pos < lengths[:, None], raw.to(torch.int32), -1)
    return chars, lengths


def from_char_matrix(chars, lengths, validity=None, total=None, dtype=None) -> Column:
    """Pack an int32 [n, L] char matrix (+ per-row lengths) into an
    Arrow string Column; null rows get length 0. ``dtype`` keeps a
    non-STRING varlen type (BINARY). The payload size is
    data-dependent: one host sync reads it, unless a byte capacity
    ``total`` (e.g. n * L) is given; the payload then has that size and
    the bytes past ``offsets[-1]`` are zero, as in the JAX package."""
    lengths = lengths.to(torch.int32)
    if validity is not None:
        lengths = torch.where(validity, lengths, torch.zeros_like(lengths))
    offsets = torch.cat(
        [
            torch.zeros(1, dtype=torch.int32, device=lengths.device),
            torch.cumsum(lengths, 0, dtype=torch.int32),
        ]
    )
    if total is None:
        # inside a fused chain the payload is a capacity, as under jit
        total = chars.shape[0] * chars.shape[1] if fused() else int(offsets[-1])
    data = ragged_pack(chars.clamp(min=0).to(torch.uint8), offsets[:-1], lengths, total)
    if dtype is not None:
        return Column(dtype, data, validity, offsets)
    return make_string_column(data, offsets, validity)


def take(col: Column, idx: torch.Tensor) -> Column:
    """Rows ``idx`` of a varlen column: the bytes and offsets the JAX
    package's char-matrix gather gives (null rows become empty), read
    straight from the payload. The payload size is data-dependent: one
    host sync reads it."""
    idx = idx.long()
    lengths = col.string_lengths()[idx]
    validity = None if col.validity is None else col.validity[idx]
    offsets = torch.cat(
        [
            torch.zeros(1, dtype=torch.int32, device=idx.device),
            torch.cumsum(lengths, 0, dtype=torch.int32),
        ]
    )
    total = int(offsets[-1])
    row = torch.repeat_interleave(
        torch.arange(idx.shape[0], device=idx.device), lengths.long(), output_size=total
    )
    pos = torch.arange(total, device=idx.device) - offsets[:-1].long()[row]
    data = col.data[col.offsets[idx].long()[row] + pos]
    return Column(col.dtype, data, validity, offsets)
