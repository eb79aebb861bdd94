"""Scans over torch tensors.

Only ``hs_cumsum``'s contract is ported: an inclusive prefix sum in the
input's dtype. The JAX package builds it from Hillis-Steele shifted adds
because ``jnp.cumsum`` lowers to the TPU's slow reduce-window; on the
card ``torch.cumsum`` is the scan.
"""

from __future__ import annotations

import torch


def hs_cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inclusive cumsum along ``axis``, keeping ``x.dtype`` (torch
    widens integer cumsums to int64 unless told otherwise)."""
    return torch.cumsum(x, dim=axis, dtype=x.dtype)
