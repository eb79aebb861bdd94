"""Shared JSON structural scans over a padded [n, L] char matrix (the
port's twin of the parts of the JAX package's ``ops/_json_scans.py``
that ``get_json_object`` reaches).

The three associative scans that recover JSON's structural state on a
vector machine (the replacement for the reference's sequential FST
tokenizer):

1. escape parity: backslash-run length via a running max,
2. in-string state: prefix parity of unescaped quotes,
3. bracket depth: cumsum of (not-in-string) open/close brackets.

The JAX package runs its running max as ``lax.cummax`` and its prefix
sums as Hillis-Steele shifts. On the card:

- a running max is a lane scan of log2(L) shifted ``torch.maximum``
  steps over the narrowest integer type that holds the values
  (positions fit int8 at L <= 126) up to ``LANE_SCAN_MAX_L``, where
  ``torch.cummax`` is slower (it also computes indices; about 12x at
  ``[2 Mi, 48]``), and ``torch.cummax`` above
  (``chip_smoke.scan_forms``, PERF.md);
- prefix sums of flags are ``segmented.lane_count``, one float32
  product with a triangular ones matrix up to the same width, where
  torch's innermost-dimension integer cumsum is slower too.

The values are the same either way.
"""

from __future__ import annotations

import dataclasses

import torch

from .segmented import LANE_SCAN_MAX_L, lane_count

QUOTE = ord('"')
BSLASH = ord("\\")
LBRACE, RBRACE = ord("{"), ord("}")
LBRACKET, RBRACKET = ord("["), ord("]")
COLON, COMMA = ord(":"), ord(",")

_I32 = torch.int32


def shift_right(a, fill):
    """Value at position i-1 (``fill`` at 0)."""
    out = torch.full_like(a, fill)
    out[:, 1:] = a[:, :-1]
    return out


def shift_left(a, fill):
    """Value at position i+1 (``fill`` at L-1)."""
    out = torch.full_like(a, fill)
    out[:, :-1] = a[:, 1:]
    return out


def narrow_dtype(lo: int, hi: int) -> torch.dtype:
    """The narrowest integer dtype holding every value in [lo, hi]."""
    for dt in (torch.int8, torch.int16, torch.int32):
        info = torch.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return dt
    return torch.int64


def lane_cummax(x):
    """Running max along axis 1 (``lax.cummax(x, axis=1)``)."""
    L = x.shape[1]
    if L > LANE_SCAN_MAX_L:
        return torch.cummax(x, dim=1).values
    k = 1
    while k < L:
        y = x.clone()
        torch.maximum(x[:, k:], x[:, :-k], out=y[:, k:])
        x = y
        k *= 2
    return x


def carry_last(mask, payload, payload_max, idx):
    """(has, val): ``payload`` at the LAST j <= i with mask[j]. Values
    ride along the (idx, payload) lexicographic max; ``payload`` must be
    in [0, payload_max]."""
    L = mask.shape[1]
    K = 1 << int(payload_max).bit_length()
    maxenc = (L - 1) * K + K - 1
    dt = narrow_dtype(-1, maxenc)
    enc = torch.where(mask, idx.to(dt) * K + payload.to(dt), -1)
    c = lane_cummax(enc)
    has = c >= 0
    return has, torch.where(has, c & (K - 1), 0).to(_I32)


def carry_last_excl(mask, payload, payload_max, idx):
    """carry_last at strictly-before positions (j < i)."""
    has, val = carry_last(mask, payload, payload_max, idx)
    return shift_right(has, False), shift_right(val, 0)


def funnel_align(mat, start, width, fill=-1, length=None):
    """Realign each row of ``mat`` so the span beginning at ``start``
    (clipped to [0, L-1]) sits at column 0, then take ``width``
    columns: ``out[i, j] = mat[i, start[i] + j]``, ``fill`` past the
    row's end and, with ``length``, past the span. The JAX package
    composes this from log2(L) conditional static shifts because a
    per-element gather is slow on the TPU; on the card one gather is
    the direct form, with the same values."""
    n, L = mat.shape
    sh = torch.clamp(start, 0, L - 1).to(torch.int64)
    j = torch.arange(width, dtype=torch.int64, device=mat.device)[None, :]
    src = sh[:, None] + j
    out = torch.gather(mat, 1, src.clamp(max=L - 1).expand(n, width))
    out = torch.where(src < L, out, fill)
    if length is not None:
        out = torch.where(j < length[:, None], out, fill)
    return out


@dataclasses.dataclass
class Structure:
    """The structural state of every char. The JAX package's position
    scans (prev/next non-whitespace, previous quote) are not here:
    ``get_json_object`` reads those positions by masked reductions."""

    idx: torch.Tensor  # int32 [n, L] position index
    esc: torch.Tensor  # bool: char is escaped (odd backslash run before it)
    quote: torch.Tensor  # bool: unescaped double quote
    outside: torch.Tensor  # bool: outside any string literal (before char)
    open_b: torch.Tensor  # bool: structural '{' or '['
    close_b: torch.Tensor  # bool: structural '}' or ']'
    d: torch.Tensor  # int32: bracket depth AFTER this char
    q_after: torch.Tensor  # int32: quote count up to and incl. this char
    nonws: torch.Tensor  # bool: non-whitespace, in-bounds char
    past_end: torch.Tensor  # bool: position beyond the row's length


def structure(chars: torch.Tensor) -> Structure:
    """Run the structural scans; ``chars`` is int32 [n, L] with -1 at
    past-end positions (columnar/strings.to_char_matrix layout)."""
    n, L = chars.shape
    idx = torch.arange(L, dtype=_I32, device=chars.device)[None, :].expand(n, L)
    pos = torch.arange(L, dtype=narrow_dtype(-1, L), device=chars.device)[None, :]

    bs = chars == BSLASH
    last_non_bs = lane_cummax(torch.where(~bs, pos, -1))
    esc = (shift_right(pos - last_non_bs, 0) & 1) == 1

    quote = (chars == QUOTE) & ~esc
    q_after = lane_count(quote)
    outside = ((q_after - quote.to(_I32)) & 1) == 0

    open_b = outside & ((chars == LBRACE) | (chars == LBRACKET))
    close_b = outside & ((chars == RBRACE) | (chars == RBRACKET))
    d = lane_count(open_b.to(torch.int8) - close_b.to(torch.int8))

    ws = (chars == 32) | (chars == 9) | (chars == 10) | (chars == 13)
    past_end = chars < 0
    return Structure(
        idx=idx,
        esc=esc,
        quote=quote,
        outside=outside,
        open_b=open_b,
        close_b=close_b,
        d=d,
        q_after=q_after,
        nonws=~ws & ~past_end,
        past_end=past_end,
    )
