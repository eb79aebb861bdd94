"""get_json_object: JSONPath extraction from JSON strings (the port's
twin of the JAX package's ``ops/get_json_object.py``).

Spark's ``get_json_object(col, path)``. Supported path grammar: ``$``
root, ``.name`` / ``['name']`` object fields, ``[i]`` array indexes.
Missing paths, type mismatches and malformed rows yield null (Spark
returns null rather than erroring).

Design (the JAX package's, kept step for step so every span is the
same): the path is parsed on the host into a static step list; every
step is a handful of vectorized scans over the ``[n, L]`` char matrix,
navigating all rows at once:

- one structural pass (``_json_scans.structure``: escape parity,
  in-string parity, bracket depth),
- a key step at container depth ``cd`` selects each row's first colon
  inside the current span at ``d == cd`` whose key bytes equal the
  step name, then takes the value span up to the next ``d == cd``
  comma / container close,
- an index step counts ``d == cd`` commas inside the span and picks
  the i-th element span.

Value rendering follows Spark: string literals are unquoted and
single-char escapes (\\" \\\\ \\/ \\b \\f \\n \\r \\t) are decoded, and
``\\uXXXX`` sequences are decoded fully, surrogate pairs included
(``_unescape``); numbers / bools / null return their raw span. Nested
containers are re-rendered with Jackson's token spacing (structural
whitespace dropped, ``_render_nested``); escape sequences INSIDE
nested string literals are kept verbatim rather than decoded and
minimally re-escaped (the JAX package's documented divergence: Spark
would turn ``\\u0041`` into ``A`` and ``\\/`` into ``/`` inside nested
spans).

Where the JAX package avoids per-element gathers and scatters (slow on
the TPU), the port takes them: ``_at`` and ``funnel_align`` gather, the
compactions of ``_unescape`` and ``_render_nested`` scatter. The values
are the same.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np
import torch

from ..columnar.column import Column, make_string_column
from ..columnar.strings import bucket_length, from_char_matrix, to_char_matrix
from . import _json_scans as _scans
from ._json_scans import (
    BSLASH as _BSLASH,
    COLON as _COLON,
    COMMA as _COMMA,
    LBRACE as _LBRACE,
    LBRACKET as _LBRACKET,
    QUOTE as _QUOTE,
    shift_left as _shift_left,
    shift_right as _shift_right,
)
from .cast_string import _check_width_eager
from .segmented import lane_count as _lane_count

_I32 = torch.int32

_STEP_RE = re.compile(r"\.(?P<dot>[^.\[\]]+)|\[(?P<idx>\d+)\]|\['(?P<q>[^']*)'\]")


def parse_path(path: str) -> Tuple[Tuple[str, object], ...]:
    """'$.a[2].b' -> (('key','a'), ('index',2), ('key','b'))."""
    if not path.startswith("$"):
        raise ValueError(f"JSONPath must start with '$': {path!r}")
    steps: List[Tuple[str, object]] = []
    pos = 1
    while pos < len(path):
        m = _STEP_RE.match(path, pos)
        if m is None:
            raise ValueError(f"unsupported JSONPath at offset {pos}: {path!r}")
        if m.group("dot") is not None:
            steps.append(("key", m.group("dot")))
        elif m.group("q") is not None:
            steps.append(("key", m.group("q")))
        else:
            steps.append(("index", int(m.group("idx"))))
        pos = m.end()
    return tuple(steps)


def _at(a, pos):
    """a[row, pos[row]] with clipping; callers mask out-of-range."""
    L = a.shape[1]
    return torch.gather(a, 1, torch.clamp(pos, 0, L - 1).to(torch.int64)[:, None])[:, 0]


def _shl_k(a, k, fill):
    """Value at position i+k (shift left by a constant k)."""
    if k == 0:
        return a
    out = torch.full_like(a, fill)
    if k < a.shape[1]:
        out[:, :-k] = a[:, k:]
    return out


def _eq_at(chars, k, byte):
    """``_shl_k(chars, k, -1) == byte`` without the shifted copy."""
    out = torch.zeros(chars.shape, dtype=torch.bool, device=chars.device)
    if k < chars.shape[1]:
        torch.eq(chars[:, k:], byte, out=out[:, :-k])
    return out


def _shr_k(a, k, fill):
    """Value at position i-k (shift right by a constant k)."""
    if k == 0:
        return a
    out = torch.full_like(a, fill)
    if k < a.shape[1]:
        out[:, k:] = a[:, :-k]
    return out


def _first_after(mask, idx, p, L):
    """Per row, the first j > p[row] with mask[j], else L: what the JAX
    package gathers from a reverse cummin scan, read by one masked
    reduction."""
    return torch.where(mask & (idx > p[:, None]), idx, L).amin(dim=1)


def _last_before(mask, idx, p):
    """Per row, the last j < p[row] with mask[j], else -1."""
    return torch.where(mask & (idx < p[:, None]), idx, -1).amax(dim=1)


def _navigate(chars, steps):
    """Returns (vs, ve, ok): value span [vs, ve] per row after walking
    ``steps``. Positions index into ``chars``. Where the JAX package
    gathers from position scans (``next_nonws``, ``prev_nonws_x``, a
    reverse cummin of delimiters), the port reads the same positions by
    masked min/max reductions, one pass each."""
    n, L = chars.shape
    st = _scans.structure(chars)
    idx = st.idx
    outside, close_b, d, nonws = st.outside, st.close_b, st.d, st.nonws

    # current value span [s, e] inclusive; root = whole trimmed doc
    s = torch.where(nonws, idx, L).amin(dim=1)
    e = torch.where(nonws, idx, -1).amax(dim=1)
    ok = (s < L) & (e >= 0) & (e >= s)

    cd = 1  # container depth: brackets of the current container sit at d==cd
    for kind, arg in steps:
        open_ch = _at(chars, s)
        inside = (idx > s[:, None]) & (idx < e[:, None])
        if kind == "key":
            ok = ok & (open_ch == _LBRACE)
            name = np.frombuffer(arg.encode("utf-8"), np.uint8).astype(np.int32)
            W = len(name)
            # all colons at container depth inside (s, e)
            cand = outside & (chars == _COLON) & (d == cd) & inside
            # at an opening quote o, the key equals `name` iff
            # chars[o+1..o+W] == name and o+W+1 holds the unescaped
            # closing quote; that flag rides value-carry scans to the
            # colon (open quote -> closing quote is the colon's
            # strictly-previous nonws)
            open_q = st.quote & outside
            m = open_q
            for j in range(W):
                m = m & _eq_at(chars, j + 1, int(name[j]))
            m = m & _shl_k(st.quote & ~outside, W + 1, False)
            kb_has, kb_val = _scans.carry_last(open_q, m.to(_I32), 1, idx)
            km_has, km_val = _scans.carry_last_excl(
                nonws, torch.where(kb_has, kb_val, 0), 1, idx
            )
            match = cand & km_has & (km_val != 0)
            # first matching colon (Spark/Jackson: first duplicate wins)
            first_colon = torch.where(match, idx, L).amin(dim=1)
            ok = ok & (first_colon < L)
            anchor = first_colon  # value begins after this position
        else:  # index
            ok = ok & (open_ch == _LBRACKET)
            i = int(arg)
            commas = outside & (chars == _COMMA) & (d == cd) & inside
            n_commas = commas.sum(dim=1, dtype=_I32)
            # empty array has no element 0: the first nonws at or after
            # s + 1 is at or past e
            inner_first = _first_after(nonws, idx, torch.clamp(s + 1, max=L - 1) - 1, L)
            is_empty = inner_first >= e
            ok = ok & ~is_empty & (i <= n_commas)
            if i == 0:
                anchor = s  # element begins after '['
            else:
                ordinal = _lane_count(commas)
                kth = commas & (ordinal == i)
                anchor = torch.where(kth, idx, -1).amax(dim=1)
                ok = ok & (anchor >= 0)

        # value span: first nonws after anchor, up to next depth-cd
        # delimiter (comma at cd, or the container's close at cd-1)
        delim = outside & (((chars == _COMMA) & (d == cd)) | (close_b & (d == cd - 1)))
        a = torch.clamp(anchor, 0, L - 1)
        vstart = _first_after(nonws, idx, a, L)
        dpos = _first_after(delim, idx, a, L)
        vlast = _last_before(nonws, idx, torch.clamp(dpos, 0, L - 1))
        ok = ok & (dpos < L) & (vstart < dpos) & (vlast >= vstart)
        s = torch.where(ok, vstart, s)
        e = torch.where(ok, vlast, e)
        cd += 1

    return s, e, ok


def _hex_val(c):
    """Value of a hex digit char; -1 when not hex."""
    dig = (c >= ord("0")) & (c <= ord("9"))
    low = (c >= ord("a")) & (c <= ord("f"))
    upp = (c >= ord("A")) & (c <= ord("F"))
    return torch.where(
        dig, c - ord("0"), torch.where(low, c - 87, torch.where(upp, c - 55, -1))
    )


def _compact(vals, keep):
    """Stable left compaction of each row's kept chars; -1 past the new
    length. Returns (chars, lengths)."""
    k, W = vals.shape
    new_len = keep.sum(dim=1, dtype=_I32)
    tgt = torch.where(keep, _lane_count(keep) - 1, W).to(torch.int64)
    # dropped chars land in one spare column past the end
    out = torch.full((k, W + 1), -1, dtype=vals.dtype, device=vals.device)
    out.scatter_(1, tgt, vals)
    pos = torch.arange(W, dtype=_I32, device=vals.device)[None, :]
    return torch.where(pos < new_len[:, None], out[:, :W], -1), new_len


def _unescape(vchars, vlen):
    """Decode JSON escapes in a [k, W] char matrix; returns (chars,
    lengths). Single-char escapes map to their bytes; ``\\uXXXX``
    decodes to the code point's UTF-8 bytes, with adjacent
    ``\\uD8xx\\uDCxx`` surrogate pairs combined into one 4-byte
    sequence (Spark/Jackson semantics). An unpaired surrogate emits its
    3-byte CESU-8 form; invalid hex keeps the escape verbatim."""
    k, W = vchars.shape
    pos = torch.arange(W, dtype=_I32, device=vchars.device)[None, :]
    live = pos < vlen[:, None]
    bs = (vchars == _BSLASH) & live
    # escape-start backslashes: odd position within a backslash run
    npos = pos.to(_scans.narrow_dtype(-1, W))
    last_non = _scans.lane_cummax(torch.where(~bs, npos, -1))
    esc_start = bs & (((npos - last_non) & 1) == 1)
    after = _shift_right(esc_start, False)
    code = vchars
    repl = code
    for ch, byte in (("f", 12), ("b", 8), ("r", 13), ("t", 9), ("n", 10)):
        repl = torch.where(code == ord(ch), byte, repl)  # '"', '\\', '/': literal
    decoded = torch.where(after, repl, vchars)

    # ---- \uXXXX decoding --------------------------------------------
    next_ch = _shift_left(vchars, -1)
    h = [_hex_val(_shl_k(vchars, 2 + j, -1)) for j in range(4)]
    hex_ok = (h[0] >= 0) & (h[1] >= 0) & (h[2] >= 0) & (h[3] >= 0)
    cp = (h[0] << 12) | (h[1] << 8) | (h[2] << 4) | h[3]
    u_esc = esc_start & (next_ch == ord("u")) & hex_ok & _shl_k(live, 5, False)
    high_sur = u_esc & (cp >= 0xD800) & (cp <= 0xDBFF)
    nxt_u = _shl_k(u_esc, 6, False)
    low_cp = _shl_k(cp, 6, 0)
    pair = high_sur & nxt_u & (low_cp >= 0xDC00) & (low_cp <= 0xDFFF)
    pair_second = _shr_k(pair, 6, False)  # the pair's 2nd escape
    full_cp = torch.where(pair, 0x10000 + ((cp - 0xD800) << 10) + (low_cp - 0xDC00), cp)
    nbytes = torch.where(
        pair, 4, torch.where(cp < 0x80, 1, torch.where(cp < 0x800, 2, 3))
    )
    # UTF-8 bytes at the escape start (b0..b3 for nbytes 1..4)
    b0 = torch.where(
        nbytes == 1,
        full_cp,
        torch.where(
            nbytes == 2,
            0xC0 | (full_cp >> 6),
            torch.where(nbytes == 3, 0xE0 | (full_cp >> 12), 0xF0 | (full_cp >> 18)),
        ),
    )
    b1 = torch.where(
        nbytes == 2,
        0x80 | (full_cp & 0x3F),
        torch.where(
            nbytes == 3, 0x80 | ((full_cp >> 6) & 0x3F), 0x80 | ((full_cp >> 12) & 0x3F)
        ),
    )
    b2 = torch.where(nbytes == 3, 0x80 | (full_cp & 0x3F), 0x80 | ((full_cp >> 6) & 0x3F))
    b3 = 0x80 | (full_cp & 0x3F)
    # place byte j of the escape at position i+1+j; drop the rest
    u_drop = torch.zeros((k, W), dtype=torch.bool, device=vchars.device)
    for j, bj in enumerate((b0, b1, b2, b3)):
        mask_j = _shr_k(u_esc, 1 + j, False)
        have_j = _shr_k(nbytes > j, 1 + j, False)
        val_j = _shr_k(bj, 1 + j, 0)
        decoded = torch.where(mask_j & have_j, val_j, decoded)
        u_drop = u_drop | (mask_j & ~have_j)
    # position i (the backslash) and i+5 (last hex) always drop; the
    # consumed second escape of a pair drops all 6 of its chars
    u_drop = u_drop | u_esc | _shr_k(u_esc, 5, False)
    for j in range(6):
        u_drop = u_drop | _shr_k(pair_second, j, False)

    # drop the escape-start backslash of single-char escapes; \uXXXX
    # escapes use the u_drop schedule above (invalid hex: keep verbatim)
    drop = (esc_start & (next_ch != ord("u"))) | u_drop
    return _compact(decoded, live & ~drop)


def _render_nested(vchars, vlen):
    """Jackson-style re-rendering of a nested container span: drop
    whitespace OUTSIDE string literals (Spark routes nested values
    through Jackson's copyCurrentStructure, which re-emits tokens with
    no inter-token whitespace). String-literal content, escapes
    included, is kept verbatim. Returns (chars, lengths)."""
    k, W = vchars.shape
    pos = torch.arange(W, dtype=_I32, device=vchars.device)[None, :]
    live = pos < vlen[:, None]
    bs = (vchars == _BSLASH) & live
    npos = pos.to(_scans.narrow_dtype(-1, W))
    last_non = _scans.lane_cummax(torch.where(~bs, npos, -1))
    esc_start = bs & (((npos - last_non) & 1) == 1)
    real_quote = (vchars == _QUOTE) & live & ~_shift_right(esc_start, False)
    excl = _lane_count(real_quote) - real_quote.to(_I32)
    outside = (excl & 1) == 0
    is_ws = (vchars == 32) | (vchars == 9) | (vchars == 10) | (vchars == 13)
    return _compact(vchars, live & ~(is_ws & outside))


def get_json_object(
    col: Column,
    path: str,
    width: int | None = None,
    out_width: int | None = None,
) -> Column:
    """Evaluate ``path`` against each JSON string row; returns a STRING
    column (null on miss/malformed/null input, Spark semantics).
    ``width`` (input char-matrix bytes) and ``out_width`` (result span
    bytes) pin the two data-dependent widths; by default each is one
    host sync. A pinned ``width`` is checked (one sync) so it never
    truncates."""
    if col.dtype.kind != "string":
        raise TypeError(f"get_json_object expects STRING, got {col.dtype}")
    steps = parse_path(path)
    n = len(col)
    if n == 0:
        return make_string_column(
            torch.zeros((0,), dtype=torch.uint8, device=col.device),
            torch.zeros((1,), dtype=_I32, device=col.device),
        )
    _check_width_eager(col, width)
    chars, lengths = to_char_matrix(col, width)
    valid = col.validity_or_true() & (lengths > 0)
    vs, ve, ok = _navigate(chars, steps)
    ok = ok & valid

    # string literal -> unquote; else raw span
    first_ch = _at(chars, vs)
    last_ch = _at(chars, ve)
    is_str = (first_ch == _QUOTE) & (last_ch == _QUOTE) & (ve > vs)
    out_start = torch.where(is_str, vs + 1, vs)
    out_len = torch.where(is_str, ve - vs - 1, ve - vs + 1)
    out_len = torch.where(ok, out_len, 0)

    if out_width is not None:
        # result spans are substrings of the input doc, so out_len <=
        # the char-matrix width: an out_width that covers it cannot
        # truncate
        W = int(out_width)
        in_w = int(chars.shape[1])
        if W < in_w:
            raise ValueError(
                f"out_width={W} is narrower than the input char width "
                f"{in_w}; extracted values could silently truncate — "
                f"pass out_width >= {in_w} (or omit it)"
            )
    else:
        W = bucket_length(max(int(out_len.max()), 1))
    out_len = torch.clamp(out_len, max=W)
    vchars = _scans.funnel_align(chars, out_start, W, length=out_len)
    # only quoted string literals are unescaped; raw spans of nested
    # containers must stay valid JSON (their escapes belong to inner
    # string tokens)
    dec_chars, dec_len = _unescape(vchars, out_len)
    vchars = torch.where(is_str[:, None], dec_chars, vchars)
    out_len = torch.where(is_str, dec_len, out_len)
    # nested containers re-render Jackson-style (no structural
    # whitespace) to match Spark's re-serialization
    is_container = ((first_ch == _LBRACE) | (first_ch == _LBRACKET)) & ~is_str
    norm_chars, norm_len = _render_nested(vchars, out_len)
    vchars = torch.where(is_container[:, None], norm_chars, vchars)
    out_len = torch.where(is_container, norm_len, out_len)
    out_len = torch.where(ok, out_len, 0)
    return from_char_matrix(vchars, out_len, validity=ok)
