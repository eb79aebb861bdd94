"""Scans and segmented reductions over sorted runs (PyTorch twin of the
JAX package's ``ops/segmented.py``).

The reduction contract is the JAX package's: rows arrive sorted by
group key, segment ids are nondecreasing from 0, and each group's
result lands in a dense ``[capacity]`` slot.

The JAX package builds every scan from Hillis-Steele shifted adds
because ``jnp.cumsum`` lowers to the TPU's slow reduce-window. On the
card ``torch.cumsum`` is the scan, with two consequences here:

- integer segment sums (``seg_sum``) are one global ``cumsum`` and a
  difference at the segment ends: integer addition wraps mod 2^64 in
  any order, so the result equals the JAX package's segmented scan;
- float segment sums keep the segmented Hillis-Steele scan
  (``seg_cumsum``), pass for pass: the order of the float additions
  then is the JAX package's, so the sums are bit-identical to it and
  the same on every device, and a group's Inf or NaN stays in that
  group.
"""

from __future__ import annotations

from typing import Sequence

import torch


def hs_cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inclusive cumsum along ``axis``, keeping ``x.dtype`` (torch
    widens integer cumsums to int64 unless told otherwise)."""
    return torch.cumsum(x, dim=axis, dtype=x.dtype)


# Widest L at which the lane-scan forms beat torch's scans on the card:
# at [393216, 256] the product counts in 1.74 ms against cumsum's 2.50,
# at [196608, 512] in 2.75 against 0.70 (chip_smoke.scan_forms, PERF.md).
LANE_SCAN_MAX_L = 256


def count_product(flags: torch.Tensor) -> torch.Tensor:
    """``lane_count`` as one float32 product with a triangular ones
    matrix: every input and partial sum is a small integer, exact in
    float32 (TF32 included)."""
    L = flags.shape[1]
    ones = torch.ones((L, L), dtype=torch.float32, device=flags.device).triu_()
    return torch.matmul(flags.to(torch.float32), ones).to(torch.int32)


def lane_count(flags: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along axis 1 of ``flags [n, L]`` with
    values in {-1, 0, 1} (bool or integer): ``count_product`` up to
    ``LANE_SCAN_MAX_L``, where torch's innermost-dimension integer
    cumsum is slower (about 10x at ``[2 Mi, 48]``), torch.cumsum above."""
    if flags.shape[1] <= LANE_SCAN_MAX_L:
        return count_product(flags)
    return torch.cumsum(flags.to(torch.int32), dim=1, dtype=torch.int32)


def _shifted_ext(x: torch.Tensor, is_max: bool, rev: bool) -> torch.Tensor:
    """Running max / min along the last axis in log2(L) shifted
    ``torch.maximum`` / ``torch.minimum`` steps; ``rev`` for the suffix
    form."""
    L = x.shape[-1]
    op = torch.maximum if is_max else torch.minimum
    k = 1
    while k < L:
        y = x.clone()
        if rev:
            op(x[..., :-k], x[..., k:], out=y[..., :-k])
        else:
            op(x[..., k:], x[..., :-k], out=y[..., k:])
        x = y
        k *= 2
    return x


def lane_ext(x: torch.Tensor, is_max: bool, rev: bool = False) -> torch.Tensor:
    """Running max / min along the last axis (``lax.cummax`` /
    ``lax.cummin``, ``reverse=rev``): shifted steps up to
    ``LANE_SCAN_MAX_L``, torch's own ``cummax`` / ``cummin`` above."""
    if x.shape[-1] <= LANE_SCAN_MAX_L:
        return _shifted_ext(x, is_max, rev)
    scan = torch.cummax if is_max else torch.cummin
    if rev:
        return scan(x.flip(-1), dim=-1).values.flip(-1)
    return scan(x, dim=-1).values


def associative_scan(comb, x: torch.Tensor, axis: int = -1, rev: bool = False) -> torch.Tensor:
    """Inclusive scan of the associative ``comb`` along ``axis``,
    Hillis-Steele: log2(L) steps, each combining every position with the
    partial result k positions before it (after it, for ``rev``), the
    earlier operand first as in ``lax.associative_scan``. The combines
    the port scans are exact integer monoids, so any association order
    gives the same ids."""
    x = x.movedim(axis, -1)
    L = x.shape[-1]
    k = 1
    while k < L:
        y = x.clone()
        if rev:
            y[..., :-k] = comb(x[..., k:], x[..., :-k])
        else:
            y[..., k:] = comb(x[..., :-k], x[..., k:])
        x = y
        k *= 2
    return x.movedim(-1, axis)


_scan_barriers = 0  # running count of lane_scan barriers (see below)


def scan_barrier_count() -> int:
    """Number of ``lane_scan`` barriers run so far. Counts BARRIERS, not
    lanes: one call is one dependency stage whose lanes are mutually
    independent."""
    return _scan_barriers


def lane_scan(lanes, axis: int = -1):
    """ONE scan barrier running several INDEPENDENT scans as lanes. Each
    lane is ``(combine, x, rev)``: ``combine`` an associative
    elementwise function, ``x`` the lane's tensor, ``rev`` True for a
    suffix scan. Returns the per-lane inclusive scan results, as the JAX
    package's ``lane_scan`` does: ``torch.maximum`` / ``torch.minimum``
    lanes run ``lane_ext``, any other combine ``associative_scan``."""
    global _scan_barriers
    _scan_barriers += 1
    outs = []
    for comb, x, rev in lanes:
        if comb is torch.maximum or comb is torch.minimum:
            outs.append(lane_ext(x.movedim(axis, -1), comb is torch.maximum, rev).movedim(-1, axis))
        else:
            outs.append(associative_scan(comb, x, axis, rev))
    return outs


def stacked_monoid_combine(comp_flat, base, mk):
    """Associative combine for K monoid scans stacked as lanes of one
    element-id tensor: lane k's local ids compose through its own table
    at ``base[k] + a * mk[k] + b`` in the concatenated compose tables
    ``comp_flat`` (``base`` / ``mk`` broadcast over the stacked leading
    axis), one gather per combine step."""

    def comb(a, b):
        return comp_flat[(base + a * mk + b).long()]

    return comb


def seg_ids_from_boundary(boundary: torch.Tensor) -> torch.Tensor:
    """bool [n] run-start flags -> int32 [n] nondecreasing segment ids
    starting at 0 (boundary[0] must be True for nonempty input)."""
    return torch.cumsum(boundary, dim=0, dtype=torch.int32) - 1


def group_starts(seg: torch.Tensor, capacity_plus_1: int) -> torch.Tensor:
    """int32 ``starts[g]`` = first index with ``seg[i] >= g`` for g in
    [0, capacity_plus_1) — n for groups past the end (segment ids are
    consecutive from 0, so there are no holes below the last id)."""
    g = torch.arange(capacity_plus_1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, g, out_int32=True)


def _shift_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` moved down ``k`` rows, zeros in front."""
    return torch.cat([torch.zeros((k,) + x.shape[1:], dtype=x.dtype, device=x.device), x[:-k]])


def _same_as_shifted(seg: torch.Tensor, k: int) -> torch.Tensor:
    """bool [n]: row i and row i - k lie in one segment."""
    return torch.cat([torch.zeros(k, dtype=torch.bool, device=seg.device), seg[:-k] == seg[k:]])


def seg_cumsum(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum WITHIN each segment of a 1-D ``x``: the
    segmented Hillis-Steele scan, log2(n) passes, so the prefix never
    crosses a boundary and float additions happen in the JAX package's
    order."""
    n = seg.shape[0]
    k = 1
    while k < n:
        x = x + torch.where(_same_as_shifted(seg, k), _shift_rows(x, k), 0)
        k *= 2
    return x


def seg_sum(
    x: torch.Tensor, seg: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor
) -> torch.Tensor:
    """Per-group sums of a 1-D ``x`` over sorted segments [starts[g],
    ends[g]] (inclusive); 0 for empty groups (ends < starts)."""
    n = x.shape[0]
    ce = ends.clamp(0, max(n - 1, 0)).long()
    if not x.is_floating_point():
        ps = torch.cumsum(x, dim=0, dtype=x.dtype)
        before = torch.where(starts > 0, ps[(starts.long() - 1).clamp(0, max(n - 1, 0))], 0)
        total = ps[ce] - before
    else:
        total = seg_cumsum(x, seg)[ce]
    return torch.where(ends < starts, 0, total)


def lex_lt(a_ops: Sequence[torch.Tensor], b_ops: Sequence[torch.Tensor]):
    """(a < b, a == b) lexicographically over parallel operand lists
    (heterogeneous dtypes allowed; compared positionally)."""
    lt = torch.zeros(a_ops[0].shape, dtype=torch.bool, device=a_ops[0].device)
    eq = torch.ones(a_ops[0].shape, dtype=torch.bool, device=a_ops[0].device)
    for a, b in zip(a_ops, b_ops):
        lt = lt | (eq & (a < b))
        eq = eq & (a == b)
    return lt, eq


def seg_scan_argext(ops: Sequence[torch.Tensor], seg: torch.Tensor, is_max: bool) -> torch.Tensor:
    """int32 [n]: at each position, the index of the row with the
    extreme operand tuple so far within its segment (running argmin /
    argmax in ``order_keys`` ascending order; the earliest row wins
    ties). Hillis-Steele: log2(n) passes carrying the operand tuple and
    the winner index."""
    n = seg.shape[0]
    cur = list(ops)
    win = torch.arange(n, dtype=torch.int32, device=seg.device)
    k = 1
    while k < n:
        same = _same_as_shifted(seg, k)
        cand = [_shift_rows(o, k) for o in cur]
        lt, eq = lex_lt(cand, cur)
        # candidate rows are earlier; on ties the earlier row wins
        better = (lt | eq) if not is_max else ~lt
        take = same & better
        cur = [torch.where(take, c, o) for c, o in zip(cand, cur)]
        win = torch.where(take, _shift_rows(win, k), win)
        k *= 2
    return win


def boundary_from_operands(sorted_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """bool [n] run-start flags from sorted key operands (1-D or
    [n, W] word matrices)."""
    n = sorted_ops[0].shape[0]
    # the first row starts a run (built on the device: a scalar store
    # would copy from the host)
    boundary = torch.arange(n, device=sorted_ops[0].device) == 0
    if n == 0:
        return boundary
    for op in sorted_ops:
        d = op[1:] != op[:-1]
        if d.dim() > 1:
            d = d.flatten(1).any(dim=1)
        boundary[1:] |= d
    return boundary
