"""Ragged byte buffer <-> padded matrix (PyTorch twin of the JAX
package's ``ops/ragged.py``).

Two primitives carry every varlen movement of the slice:

- ``ragged_unpack``: flat buffer + per-row starts -> padded ``[n, L]``,
- ``ragged_pack``: padded ``[n, L]`` + per-row (start, length) -> flat
  exact-size buffer.

The JAX package builds both from tile row-gathers and funnel shifts
because per-element gathers and scatters are slow on the TPU. On the
card an index gather and an index scatter are the direct form, so that
is what is written here; the results are the same bytes.
"""

from __future__ import annotations

import torch


def next_pow2(x: int) -> int:
    """The least power of two >= ``x`` (1 for ``x <= 1``)."""
    p = 1
    while p < x:
        p *= 2
    return p


def ragged_unpack(data: torch.Tensor, starts: torch.Tensor, L: int) -> torch.Tensor:
    """``out[i, j] = data[starts[i] + j]`` for j < L, zero past the
    buffer end. Rows are not masked by per-row lengths: callers apply
    their own masks."""
    n = starts.shape[0]
    total = data.shape[0]
    if n == 0 or total == 0:
        return torch.zeros((n, L), dtype=data.dtype, device=data.device)
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        L, dtype=torch.int64, device=data.device
    )[None, :]
    vals = data[idx.clamp(max=total - 1)]
    return torch.where(idx < total, vals, torch.zeros((), dtype=data.dtype, device=data.device))


def ragged_scatter(
    out: torch.Tensor, rows: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Write ``rows[i, :lengths[i]]`` to ``out[starts[i]:]`` in place and
    return ``out``. Spans must lie inside ``out``."""
    n, L = rows.shape
    if n == 0 or L == 0:
        return out
    pos = torch.arange(L, dtype=torch.int64, device=rows.device)[None, :]
    mask = pos < lengths.to(torch.int64)[:, None]
    out[(starts.to(torch.int64)[:, None] + pos)[mask]] = rows[mask]
    return out


def ragged_pack(
    rows: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor, total: int
) -> torch.Tensor:
    """Flat ``[total]`` buffer of ``rows.dtype`` holding
    ``rows[i, :lengths[i]]`` at ``starts[i]``; bytes no span covers are
    zero. Spans must lie inside ``[0, total)``. No host sync: positions
    past a row's length write to one spare slot past the end, which is
    cut off."""
    n, L = rows.shape
    out = torch.zeros((total + 1,), dtype=rows.dtype, device=rows.device)
    if n and L:
        pos = torch.arange(L, dtype=torch.int64, device=rows.device)[None, :]
        dest = torch.where(
            pos < lengths.to(torch.int64)[:, None], starts.to(torch.int64)[:, None] + pos, total
        )
        out[dest.reshape(-1)] = rows.reshape(-1)
    return out[:total]


def lane_select(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mat[i, idx[i]]`` for idx in [0, L) (0 for out-of-range idx).

    The JAX package takes a masked one-lane reduce, since a per-row
    gather is slow on the TPU; on the card a gather is the direct form
    and gives the same values."""
    L = mat.shape[-1]
    if L == 0:
        return torch.zeros(mat.shape[:-1], dtype=mat.dtype, device=mat.device)
    idx = idx.to(torch.int64)
    inside = (idx >= 0) & (idx < L)
    got = torch.gather(mat, -1, idx.clamp(0, L - 1)[:, None])[:, 0]
    return torch.where(inside, got, torch.zeros((), dtype=mat.dtype, device=mat.device))
