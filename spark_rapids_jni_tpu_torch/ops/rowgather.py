"""Order-preserving word packing of sort operands (PyTorch twin of the
order-word half of the JAX package's ``ops/rowgather.py``).

Integer operands map to big-endian bytes with the sign bit flipped,
cut into words whose lexicographic UNSIGNED order equals the operands'
lexicographic (signed) order. The JAX package packs 4-byte words for
the TPU's 32-bit comparator; the port packs 8-byte words, so a
multi-operand sort takes as few stable ``torch.sort`` passes as the
operands' bytes allow.

The JAX module's row packer (``pack_fixed_rows``) exists because a TPU
gather costs the same per index whatever the row width; on the card
the port gathers column by column, with the same results.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils.int128 import SIGN, lsr

_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)


def orderable_ops(ops: Sequence[torch.Tensor]) -> bool:
    """True when every operand is an integer kind the packer handles
    (not bool, not float). Unsigned 8-byte operands are rejected: they
    would wrap negative on the way through int64."""
    return all(o.dtype in _SIGNED or o.dtype == torch.uint8 for o in ops)


def pack_order_words(ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Integer operands -> int64 [n, W] holding 64-bit words whose
    row-wise lexicographic UNSIGNED order equals the operands'
    lexicographic order. Each operand becomes big-endian bytes with the
    sign bit flipped; the byte stream is cut into 8-byte words, the last
    zero-padded — the JAX package's byte stream, in words of 8 bytes
    instead of 4. Pieces of operands move whole, not byte by byte."""
    if not orderable_ops(ops):
        raise TypeError(f"operands are not orderable integers: {[o.dtype for o in ops]}")
    pieces = []  # (value as int64 bits of the big-endian bytes, size, stream offset)
    pos = 0
    for o in ops:
        size = o.element_size()
        u = o.to(torch.int64)
        if o.dtype in _SIGNED:
            u = u ^ (SIGN >> (64 - 8 * size))  # flip the operand's sign bit
        if size < 8:
            u = u & ((1 << (8 * size)) - 1)
        pieces.append((u, size, pos))
        pos += size
    n_words = -(-pos // 8)
    words = []
    for w in range(n_words):
        w0, w1 = 8 * w, 8 * (w + 1)
        acc = None
        for u, size, p0 in pieces:
            a, b = max(w0, p0), min(w1, p0 + size)
            if a >= b:
                continue
            # operand bytes [a - p0, b - p0), big-endian: drop the bytes
            # after b, keep (b - a) bytes, place them to end at byte b
            part = lsr(u, 8 * (p0 + size - b))
            if b - a < 8:
                part = part & ((1 << (8 * (b - a))) - 1)
            part = part << (8 * (w1 - b))
            acc = part if acc is None else acc | part
        words.append(acc)
    return torch.stack(words, dim=1)


def _unsigned_order(x: torch.Tensor) -> torch.Tensor:
    """Words whose signed order is ``x``'s unsigned order: a signed
    integer word holds unsigned bits (the int64 words above; int32 for
    uint32 words), so its sign bit is flipped."""
    if x.dtype in _SIGNED:
        return x ^ torch.iinfo(x.dtype).min
    return x


def words_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b over [..., W] unsigned word rows (lexicographic)."""
    a, b = _unsigned_order(a), _unsigned_order(b)
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for w in range(a.shape[-1]):
        aw, bw = a[..., w], b[..., w]
        lt = lt | (eq & (aw < bw))
        eq = eq & (aw == bw)
    return lt


def words_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)
