"""MapUtils: extract raw key/value pairs from JSON strings (the port's
twin of the JAX package's ``ops/map_utils.py``).

Behavioral parity with the reference ``from_json`` (map_utils.cu:
562-633; MapUtils.java:47-50): a strings column of JSON objects becomes
``List<Struct<String,String>>`` of the top-level fields, where keys and
values are *raw substrings* (string literals keep their content with
the surrounding quotes stripped, every other value, nested containers
included, is the raw span with outer whitespace trimmed; no type
coercion, MapUtils.java:33-41). Null input rows become null output rows
(map_utils.cu:623-632 copies the input mask); malformed JSON raises
``JsonParsingException`` with the first offending row's text
(map_utils.cu:109-139). Validation covers the reference tokenizer's
rejection set at every depth (``_json_scans.deep_grammar_errors``).

Design (the JAX package's, kept step for step so every span, pair and
error row is the same): JSON's structural state comes from associative
scans over the byte axis of the padded ``[n, L]`` char matrix, after
which "top-level key/value of the row object" is a mask: colons at
depth 1 outside strings mark pairs, and every neighbouring span is read
by value carries. The analysis runs in six dependency stages (B1-B6 in
``_analyze``); each stage's scans are lanes of one ``lane_scan``. The
JAX package packs the stage-2 and stage-3 prefix counts into one
cumsum each; the port counts each flag with ``segmented.lane_count``,
which gives the same counts. Only the pair count and the span-width
maxima reach the host, in one sync, before the pair gather and the
string pack.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..columnar.column import Column, make_string_column
from ..columnar.nested import ListColumn, StructColumn
from ..columnar.strings import bucket_length, from_char_matrix, to_char_matrix
from ..runtime.errors import JsonParsingException
from . import _json_scans as _scans
from ._json_scans import (
    BSLASH as _BSLASH,
    COLON as _COLON,
    COMMA as _COMMA,
    LBRACE as _LBRACE,
    LBRACKET as _LBRACKET,
    QUOTE as _QUOTE,
    RBRACE as _RBRACE,
    RBRACKET as _RBRACKET,
    shift_left as _shift_left,
    shift_right as _shift_right,
)
from ._strategy import scan_strategy as _scan_strategy
from .ragged import next_pow2
from .segmented import lane_count, lane_scan

_I32 = torch.int32


@dataclasses.dataclass
class _Analysis:
    colon: torch.Tensor  # bool [n, L]: one top-level pair per colon
    k_start: torch.Tensor  # int32 [n, L] key text start (at colon positions)
    k_len: torch.Tensor
    v_start: torch.Tensor
    v_len: torch.Tensor
    v_kind: torch.Tensor  # int8 [n, L]: 0 scalar / 1 string / 2 container
    pairs_per_row: torch.Tensor  # int32 [n]
    row_err: torch.Tensor  # bool [n]


# sprtcheck: barrier-budget=4 — B1, B4, B5 and B6; B2 and B3 are lane counts
def _analyze(chars, lengths, valid, monoid=True):
    """Structural scan over the [n, L] char matrix (see module doc).

    Every cross-position read is a value carry, never a positional
    gather. The stages, each reading only what earlier stages gave:

      B1  backslash-run running max (escape parity),
      B2  quote and nonws counts (parity needs ``esc``),
      B3  struct and depth counts (needs ``outside``),
      B4  next-nonws / next-quote / next-ret1 / prev-quote positions,
      B5  the packed prev-nonws and next-nonws value carries (token-end
          flags, chars, counts and the grammar's okpred / n1 lanes ride
          along) and the monoid kind-stack / token-monoid lanes,
      B6  the delimiter chain, the open-quote key-predecessor carries
          (map and grammar lanes share the mask) and the key-colon n2
          carry.
    """
    n, L = chars.shape
    dev = chars.device
    idx = torch.arange(L, dtype=_I32, device=dev)[None, :].expand(n, L)
    pos = torch.arange(L, dtype=_scans.narrow_dtype(-1, L), device=dev)[None, :]

    # --- B1: escape parity (backslash-run running max) ---
    bs = chars == _BSLASH
    (last_non_bs,) = lane_scan([(torch.maximum, torch.where(~bs, pos, -1), False)], axis=1)
    esc = (_shift_right((pos - last_non_bs).to(_I32), 0) & 1) == 1

    quote = (chars == _QUOTE) & ~esc
    ws = (chars == 32) | (chars == 9) | (chars == 10) | (chars == 13)
    past_end = chars < 0
    nonws = ~ws & ~past_end

    # --- B2: quote / nonws running counts ---
    q_after = lane_count(quote)
    nw_cum = lane_count(nonws)
    outside = ((q_after - quote.to(_I32)) & 1) == 0

    open_b = outside & ((chars == _LBRACE) | (chars == _LBRACKET))
    close_b = outside & ((chars == _RBRACE) | (chars == _RBRACKET))

    # --- B3: struct count and bracket depth ---
    structch = quote | open_b | close_b
    struct_cum = lane_count(structch)
    d = lane_count(open_b.to(torch.int8) - close_b.to(torch.int8))

    colon = outside & (chars == _COLON) & (d == 1)
    comma1 = outside & (chars == _COMMA) & (d == 1)
    ret1 = close_b & (d == 1)
    closer0 = close_b & (d == 0)  # object-terminating '}' (or stray ']')
    delim = comma1 | closer0
    chars1 = chars + 1  # [0, 256]: non-negative carry payload
    okf = (outside & (d == 1) & ((chars == _LBRACE) | (chars == _COMMA))).to(_I32)

    # grammar masks and the packed token-end / okpred payloads that ride
    # the B5 prev-nonws carry (shared definition, _json_scans)
    pre, gflags, okpred = _scans.grammar_masks(
        chars, nonws, esc, quote, outside, open_b, close_b, d, past_end, idx
    )
    open_q = pre.open_q

    # --- B4: the level-2 position scans (one barrier, four lanes) ---
    outs4 = lane_scan(
        [
            (torch.minimum, torch.where(nonws, pos, L), True),
            (torch.minimum, torch.where(quote, pos, L), True),
            (torch.minimum, torch.where(ret1, pos, L), True),
            (torch.maximum, torch.where(quote, pos, -1), False),
        ],
        axis=1,
    )
    next_nonws, next_quote, next_ret1, prev_quote = (o.to(_I32) for o in outs4)
    next_quote_a = _shift_left(next_quote, L)
    next_ret1_a = _shift_left(next_ret1, L)
    prev_quote_x = _shift_right(prev_quote, -1)
    next_nonws_a = _shift_left(next_nonws, L)  # strictly after i

    # --- B5: the packed prev-nonws and next-nonws value carries and
    # the monoid kind-stack / token lanes, one barrier ---
    last_lanes, dec_last = _scans.carry_last_lanes(
        nonws,
        [
            (chars1, 257),
            (torch.clamp(prev_quote_x, -1, L) + 1, L + 1),
            (okf, 1),
            (nw_cum, L),
            (struct_cum, L),
            (gflags, 63),
            (okpred.to(_I32), 1),
        ],
        idx,
    )
    next_lanes, dec_next = _scans.carry_next_lanes(
        nonws,
        [
            (chars1, 257),
            (next_quote_a, L),
            (next_ret1_a, L),
            (nw_cum, L),
            (struct_cum, L),
            (next_nonws_a, L),
            (pre.is_colon.to(_I32), 1),  # grammar n1 lane
        ],
        idx,
    )
    lanes5 = list(last_lanes) + list(next_lanes)
    if monoid:
        kcomb, kw = _scans._kind_lane(open_b, pre.curly_open, d)
        tcomb, tids = _scans._token_lane(chars, pre.scalar_start, pre.scalar_char)
        lanes5 += [(kcomb, kw, False), (tcomb, tids, False)]
    outs5 = lane_scan(lanes5, axis=1)
    k1 = len(last_lanes)
    k2 = k1 + len(next_lanes)
    lv = dec_last(outs5[:k1])
    nv = dec_next(outs5[k1:k2])
    if monoid:
        pre.kind_words = _shift_right(outs5[-2], 0)
        pre.tok_pref = outs5[-1]

    lc_has, lc_val = lv.pair(0)  # inclusive: char at prev_nonws
    pk_has, pk_val = lv.pair(0, excl=True)
    ko_has, ko_val = lv.pair(1, excl=True)
    bp_has, bp_val = lv.pair(2, excl=True)
    _, nwprev = lv.pair(3, excl=True)
    _, scprev = lv.pair(4, excl=True)
    pre.p = lv.pair(5, excl=True)
    a_has, a_val = lv.pair(6, excl=True)
    # prev-nonws POSITIONS decode off the same scan (the idx key)
    px_has, px_val = lv.pos(excl=True)
    prev_nonws_x = torch.where(px_has, px_val, -1)
    pn_has, pn_val = lv.pos()
    prev_nonws = torch.where(pn_has, pn_val, -1)

    fc_has, fc_val = nv.pair(0)  # inclusive: char at next_nonws
    vs_has, vs_val = nv.pair(0, excl=True)
    _, nq_at_vs = nv.pair(1, excl=True)
    _, nr_at_vs = nv.pair(2, excl=True)
    _, nw_at_vs = nv.pair(3, excl=True)
    _, sc_at_vs = nv.pair(4, excl=True)
    in_has, in_val = nv.pair(5)  # inclusive: 2nd-nonws carrier
    n1_has, n1_val = nv.pair(6, excl=True)
    colon_after = n1_has & (n1_val != 0)

    # --- B6: the delimiter chain, the open-quote key-predecessor
    # carries and the grammar n2 carry, one barrier ---
    pred_ok_here = (~bp_has) | (bp_val != 0)
    pred_ok_deep = (~a_has) | (a_val != 0)
    bq_lanes, dec_bq = _scans.carry_last_lanes(
        open_q, [(pred_ok_here.to(_I32), 1), (pred_ok_deep.to(_I32), 1)], idx
    )
    delim_lanes, dec_delim = _scans.carry_next_lanes(
        delim,
        [
            (torch.clamp(prev_nonws_x, -1, L) + 1, L + 1),
            (pk_val, 257),
            (nwprev, L),
            (scprev, L),
        ],
        idx,
    )
    n2_lanes, dec_n2 = _scans.carry_next_lanes(quote, [(colon_after.to(_I32), 1)], idx)
    m1 = len(bq_lanes)
    m2 = m1 + len(delim_lanes)
    outs6 = lane_scan(bq_lanes + delim_lanes + n2_lanes, axis=1)
    bq = dec_bq(outs6[:m1])
    bk_has, bk_val = bq.pair(0)
    pre.b = bq.pair(1)
    dv = dec_delim(outs6[m1:m2])
    pre.n2 = dec_n2(outs6[m2:]).pair(0, excl=True)

    vl_has, vl_val = dv.pair(0, excl=True)
    vc_has, vc_val = dv.pair(1, excl=True)
    _, nw_at_vl = dv.pair(2, excl=True)
    _, sc_at_vl = dv.pair(3, excl=True)
    # first-delim-strictly-after positions off the same scan's idx key
    nd_has, nd_val = dv.pos(excl=True)
    next_delim_a = torch.where(nd_has, nd_val, L)

    # --- per-colon key span: the string literal just before the colon ---
    key_end = prev_nonws_x  # closing quote position
    key_end_is_quote = pk_has & (pk_val == _QUOTE + 1)
    # key_open = prev_quote_x AT key_end: carried forward above
    key_open = torch.where(ko_has, ko_val - 1, -1)
    k_start = key_open + 1
    k_len = key_end - key_open - 1
    before_key_ok = bk_has & (bk_val != 0)
    key_ok = (key_end >= 0) & key_end_is_quote & (key_open >= 0) & (k_len >= 0) & before_key_ok

    # --- per-colon value span: up to the next depth-1 comma / final '}' ---
    delim_pos = next_delim_a
    val_start = next_nonws_a
    # val_last = prev_nonws_x AT the next delimiter
    val_last = torch.where(vl_has, vl_val - 1, -1)
    val_ok = (delim_pos < L) & (val_start < delim_pos) & (val_last >= val_start)
    # char at val_start (first nonws strictly after the colon)
    vs_ch = torch.where(vs_has, vs_val - 1, -1)
    # char at val_last: prev-nonws char sampled at the delimiter
    vlast_ch = torch.where(vc_has & (vc_val > 0), vc_val - 1, -1)
    is_strval = (vs_ch == _QUOTE) & (vlast_ch == _QUOTE) & (val_last > val_start)
    # single-token discipline (the reference's tokenizer rejects
    # {"a": "x" "y"}): a string value's closing quote, a container
    # value's matching close must be the span's last char; a scalar
    # value has no interior whitespace and no structural char
    span_nonws = nw_at_vl - nw_at_vs + 1
    is_container = (vs_ch == _LBRACE) | (vs_ch == _LBRACKET)
    span_struct = sc_at_vl - sc_at_vs
    token_ok = torch.where(
        vs_ch == _QUOTE,
        nq_at_vs == val_last,
        torch.where(
            is_container,
            nr_at_vs == val_last,
            (span_nonws == val_last - val_start + 1) & (span_struct == 0),
        ),
    )
    val_ok = val_ok & token_ok
    v_start = torch.where(is_strval, val_start + 1, val_start)
    v_len = torch.where(is_strval, val_last - val_start - 1, val_last - val_start + 1)
    v_kind = torch.where(is_strval, 1, torch.where(is_container, 2, 0)).to(torch.int8)

    # --- row-level validation (nulls are '{}': no pairs, no errors) ---
    last_nw = prev_nonws[:, L - 1]
    first_ch = torch.where(fc_has[:, 0], fc_val[:, 0] - 1, -1)
    # the last char of the row is at last_nw itself: the INCLUSIVE
    # carry's final column
    last_ch = torch.where(lc_has[:, L - 1], lc_val[:, L - 1] - 1, -1)
    # non-ws strictly after the object-terminating '}': the last nonws
    # of the row sits past the FIRST closer0
    first_c0 = torch.where(closer0, idx, L).amin(dim=1)
    trailing = torch.where(last_nw > first_c0, first_c0, L)
    d_masked = torch.where(past_end, 0, d)
    pair_err = colon & ~(key_ok & val_ok)
    # arity: a valid object has commas == pairs-1 (or 0 commas, 0 pairs
    # and no inner content): missing colons and trailing commas fail
    n_pairs = colon.sum(dim=1, dtype=_I32)
    n_commas = comma1.sum(dim=1, dtype=_I32)
    # second nonws position of the row: next_nonws_a sampled at the
    # first nonws (the inclusive lane's column 0)
    inner_nonempty = torch.where(in_has[:, 0], in_val[:, 0], L) != last_nw
    arity_err = torch.where(
        n_pairs > 0, n_commas != n_pairs - 1, inner_nonempty | (n_commas != 0)
    )
    row_err = (
        (lengths == 0)
        | (first_ch != _LBRACE)
        | (last_ch != _RBRACE)
        | (d_masked[:, L - 1] != 0)
        | (d_masked.amin(dim=1) < 0)
        | ((q_after[:, L - 1] & 1) == 1)
        | (trailing < L)
        | arity_err
        | pair_err.any(dim=1)
        # full-depth token grammar and bracket-kind stack: the reference
        # FST's rejection set (map_utils.cu:575-577)
        | _scans.deep_grammar_errors(chars, pre, monoid)
    )
    row_err = row_err & valid
    colon = colon & valid[:, None] & ~row_err[:, None]
    return _Analysis(
        colon, k_start, k_len, v_start, v_len, v_kind, colon.sum(dim=1, dtype=_I32), row_err
    )


# Char positions analysed at once. Eager torch keeps every temporary of
# the analysis alive to its end, about 440 bytes a position (a 2 Mi x 64
# row group peaked at 58.9 GB on the H100, PERF.md); rows are
# independent, so larger batches are analysed in row slices of this many
# positions (~15 GB) and the fields concatenated, with the same values.
_ANALYZE_POSITIONS = 1 << 25


def _analyze_rows(chars, lengths, valid, monoid):
    """``_analyze`` over row slices of at most ``_ANALYZE_POSITIONS``
    char positions."""
    n, L = chars.shape
    step = max(1, _ANALYZE_POSITIONS // max(L, 1))
    if n <= step:
        return _analyze(chars, lengths, valid, monoid)
    parts = [_analyze(chars[i : i + step], lengths[i : i + step], valid[i : i + step], monoid)
             for i in range(0, n, step)]
    return _Analysis(*(torch.cat([getattr(p, f.name) for p in parts])
                       for f in dataclasses.fields(_Analysis)))


def _gather_pairs(chars, colon, k_start, k_len, v_start, v_len, v_kind, P, Lk, Lv, maxp):
    """Flatten the colon sites (row-major: row order, then field order)
    into ``P`` pair slots of key / value char matrices (uint8, 0 past
    each span) ready for string assembly; also each pair's value kind
    and source row. Slots no pair reaches carry zero lengths. The JAX
    package compacts colon sites with a batched sort and places pairs
    with a drop-mode scatter; here the scatter's dropped writes land in
    one spare slot past the end, and each span is one gather from the
    char matrix, with the same values."""
    n, L = chars.shape
    dev = chars.device
    idx_l = torch.arange(L, dtype=_I32, device=dev)[None, :]
    # per-row colon positions, compacted to the left by one batched sort
    keys = torch.where(colon, idx_l, L)
    pos_sorted = torch.sort(keys, dim=1).values[:, :maxp]
    pairs_row = colon.sum(dim=1, dtype=_I32)
    offsets = torch.cumsum(pairs_row, 0, dtype=_I32) - pairs_row
    # row-major pair slots: pair k of row r -> offsets[r] + k; the -1
    # init doubles as the written-slot flag
    karange = torch.arange(maxp, dtype=_I32, device=dev)[None, :]
    slot = offsets[:, None] + karange
    live = (karange < pairs_row[:, None]) & (slot < P)
    tgt = torch.where(live, slot, P).reshape(-1).long()
    flat_src = torch.arange(n, dtype=_I32, device=dev)[:, None] * L + pos_sorted
    pair_flat = torch.full((P + 1,), -1, dtype=_I32, device=dev)
    pair_flat[tgt] = flat_src.reshape(-1)
    pair_flat = pair_flat[:P]
    written = pair_flat >= 0
    flat_at = torch.where(written, pair_flat, 0).long()  # colon site of each pair
    prow = (flat_at // L).to(_I32)

    def at_colon(a):
        return a.reshape(-1)[flat_at]

    ks, kl = at_colon(k_start), at_colon(k_len)
    vs, vl = at_colon(v_start), at_colon(v_len)
    vk = at_colon(v_kind)
    kl = torch.where(written, kl, 0)
    vl = torch.where(written, vl, 0)
    flat_chars = chars.reshape(-1).to(torch.uint8)
    row_base = (prow.long() * L)[:, None]

    def span(start, length, W):
        j = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
        src = torch.clamp(start, 0, L - 1).long()[:, None] + j
        got = flat_chars[row_base + torch.clamp(src, max=L - 1)]
        keep = (src < L) & (j < length[:, None])
        return torch.where(keep, got, 0)

    return span(ks, kl, Lk), kl, span(vs, vl, Lv), vl, vk, prow


def _pack_kv(kchars, klen, vchars, vlen, P: int):
    """ONE pack for the key and value matrices and the split back into
    two string columns. Key rows go first, so the key payload is a byte
    PREFIX of the packed buffer and the split is offset slicing. Slots
    past ``P`` carry zero lengths and contribute nothing. One host sync
    reads the split points."""
    Pc, Lk = kchars.shape
    Lv = vchars.shape[1]
    Lm = max(Lk, Lv)

    def _pad_to(mat, W):
        if W == Lm:
            return mat
        return torch.cat([mat, mat.new_zeros((mat.shape[0], Lm - W))], dim=1)

    both = torch.cat([_pad_to(kchars, Lk), _pad_to(vchars, Lv)], dim=0)
    blen = torch.cat([klen, vlen], dim=0)
    packed = from_char_matrix(both, blen)
    offs = packed.offsets
    data = packed.data
    cut_k, off_p, cut_v = (int(x) for x in offs[[P, Pc, Pc + P]].cpu())
    keys = make_string_column(data[:cut_k], offs[: P + 1])
    values = make_string_column(data[off_p:cut_v], offs[Pc : Pc + P + 1] - off_p)
    return keys, values


def from_json_traced(chars, lengths, valid, key_width: int, value_width: int,
                     max_pairs: int, monoid: bool):
    """``from_json``'s core with statically pinned widths and no host
    sync: the analysis and the bounded pair gather. ``key_width`` /
    ``value_width`` are the key / value char-matrix bytes and
    ``max_pairs`` the pairs per row; the pair capacity is
    ``n * max_pairs``. Stops at the gathered ``[P, Lk]`` / ``[P, Lv]``
    span matrices; ``assemble_from_json`` packs them.

    Returns ``(pieces, counts, stats)``: ``pieces`` holds the padded
    buffers ``assemble_from_json`` packs into the ListColumn (with the
    first bad row's chars, so it can raise JsonParsingException without
    re-reading the column), ``counts`` the overflow scalars (``kwidth``
    / ``vwidth`` / ``maxp``; an overflowing result is garbage but
    counted) and ``stats`` the observed maxima."""
    n, L = chars.shape
    # key/value spans are substrings of the document: a span width above
    # the input char width is unreachable, so clamping is lossless
    Lk, Lv = min(int(key_width), L), min(int(value_width), L)
    maxp = int(max_pairs)
    res = _analyze_rows(chars, lengths, valid, monoid)
    mk = torch.where(res.colon, res.k_len, 0).amax().to(_I32)
    mv = torch.where(res.colon, res.v_len, 0).amax().to(_I32)
    mp = res.pairs_per_row.amax().to(_I32)
    counts = {
        "kwidth": torch.clamp(mk - Lk, min=0),
        "vwidth": torch.clamp(mv - Lv, min=0),
        "maxp": torch.clamp(mp - maxp, min=0),
    }
    stats = {"kwidth": mk, "vwidth": mv, "maxp": mp}
    P = n * maxp
    kchars, klen, vchars, vlen, _vk, _prow = _gather_pairs(
        chars, res.colon, res.k_start, res.k_len, res.v_start, res.v_len, res.v_kind,
        P, Lk, Lv, maxp,
    )
    list_offsets = torch.cat([
        torch.zeros((1,), dtype=_I32, device=chars.device),
        torch.cumsum(torch.clamp(res.pairs_per_row, max=maxp), 0, dtype=_I32),
    ])
    err_row = torch.argmax(res.row_err.to(torch.uint8)).to(_I32)
    pieces = {
        "kchars": kchars,
        "klen": klen,
        "vchars": vchars,
        "vlen": vlen,
        "list_offsets": list_offsets,
        "err_any": res.row_err.any(),
        "err_row": err_row,
        "err_chars": chars[err_row.long()],
        "validity": valid,
    }
    return pieces, counts, stats


def _snippet(raw: np.ndarray) -> str:
    text = raw.tobytes().decode("utf-8", errors="replace")
    return text if len(text) <= 200 else text[:200] + "..."


def assemble_from_json(pieces) -> ListColumn:
    """Assembly of ``from_json_traced`` pieces into the
    List<Struct<String,String>> result: one small host sync reads the
    error flag, the first bad row, the real pair count and whether every
    row is valid, then the exact pack runs. Raises JsonParsingException
    with the offending row's text when the analysis flagged one."""
    validity = pieces["validity"]
    all_valid = validity.all() if validity is not None else torch.ones((), dtype=torch.bool)
    err_any, err_row, p_real, every_valid = (
        int(x) for x in torch.stack([
            pieces["err_any"].to(torch.int64),
            pieces["err_row"].to(torch.int64),
            pieces["list_offsets"][-1].to(torch.int64),
            all_valid.to(pieces["err_row"].device).to(torch.int64),
        ]).cpu()
    )
    if err_any:
        raw = pieces["err_chars"].cpu().numpy()
        raise JsonParsingException(err_row, _snippet(raw[raw >= 0].astype(np.uint8)))
    keys, values = _pack_kv(pieces["kchars"], pieces["klen"], pieces["vchars"],
                            pieces["vlen"], p_real)
    if validity is not None and every_valid:
        validity = None  # compact all-valid masks, as the eager path does
    child = StructColumn((keys, values), names=("key", "value"))
    return ListColumn(pieces["list_offsets"], child, validity)


def _raise_at_row(col: Column, row: int):
    """Raise with the offending row's text, copying just that row's bytes
    (the reference prints +-100 chars the same way, map_utils.cu:
    109-139)."""
    o0, o1 = (int(x) for x in col.offsets[row : row + 2].cpu())
    raise JsonParsingException(row, _snippet(col.data[o0:o1].cpu().numpy()))


def _empty_strings(device) -> Column:
    return make_string_column(
        torch.zeros((0,), dtype=torch.uint8, device=device),
        torch.zeros((1,), dtype=_I32, device=device),
    )


def _empty_child(device) -> StructColumn:
    return StructColumn((_empty_strings(device), _empty_strings(device)), names=("key", "value"))


def from_json(col: Column) -> ListColumn:
    """Extract top-level key/value raw-substring pairs from a JSON
    strings column; returns List<Struct<String,String>> (map_utils.cu
    from_json:562-633). Runs on the device ``col`` lies on."""
    if col.dtype.kind != "string":
        raise TypeError(f"from_json expects a STRING column, got {col.dtype}")
    dev = col.device
    n = len(col)
    if n == 0:
        return ListColumn(torch.zeros((1,), dtype=_I32, device=dev), _empty_child(dev), None)

    chars, lengths = to_char_matrix(col)
    valid = col.validity_or_true()
    res = _analyze_rows(chars, lengths, valid, _scan_strategy() != "serial")

    # ONE host sync for everything the staging needs: the first bad
    # row, the pair count and maximum, the span-width maxima
    pairs = res.pairs_per_row
    err_any, err_row, P, max_pairs, max_k, max_v = (
        int(x) for x in torch.stack([
            res.row_err.any().to(torch.int64),
            torch.argmax(res.row_err.to(torch.uint8)),
            pairs.sum(dtype=torch.int64),
            pairs.amax().to(torch.int64),
            torch.where(res.colon, res.k_len, 0).amax().to(torch.int64),
            torch.where(res.colon, res.v_len, 0).amax().to(torch.int64),
        ]).cpu()
    )
    if err_any:
        _raise_at_row(col, err_row)

    offsets = torch.cat([
        torch.zeros((1,), dtype=_I32, device=dev), torch.cumsum(pairs, 0, dtype=_I32)
    ])
    if P == 0:
        return ListColumn(offsets, _empty_child(dev), col.validity)

    Lk, Lv = bucket_length(max(max_k, 1)), bucket_length(max(max_v, 1))
    # the pair capacity buckets like the string widths; the pairs per
    # row to a power of two (2-4 in real documents, where the 8-floor of
    # the string buckets would double the slot work)
    Pb = bucket_length(P)
    maxp = max(next_pow2(max_pairs), 1)
    kchars, klen, vchars, vlen, _vk, _prow = _gather_pairs(
        chars, res.colon, res.k_start, res.k_len, res.v_start, res.v_len, res.v_kind,
        Pb, Lk, Lv, maxp,
    )
    keys, values = _pack_kv(kchars, klen, vchars, vlen, P)
    child = StructColumn((keys, values), names=("key", "value"))
    return ListColumn(offsets, child, col.validity)
