"""Shared JSON structural scans over a padded [n, L] char matrix (the
port's twin of the JAX package's ``ops/_json_scans.py``, used by
``ops/get_json_object.py`` and ``ops/map_utils.py``).

The three associative scans that recover JSON's structural state on a
vector machine (the replacement for the reference's sequential FST
tokenizer, cudf tokenize_json via map_utils.cu:575-577):

1. escape parity: backslash-run length via a running max,
2. in-string state: prefix parity of unescaped quotes,
3. bracket depth: cumsum of (not-in-string) open/close brackets,

plus the value carries every span computation builds on (a payload rides
the (position, payload) running max or reverse min to the positions
after or before it), the lane-group packers that put several carries of
one mask on one scan, and the full-depth grammar validation of
from_json.

The JAX package runs its running max as ``lax.cummax`` and its prefix
sums as Hillis-Steele shifts. On the card:

- a running max or min is ``segmented.lane_ext``: log2(L) shifted
  ``torch.maximum`` / ``torch.minimum`` steps over the narrowest integer
  type that holds the values (positions fit int8 at L <= 126) up to
  ``LANE_SCAN_MAX_L``, where ``torch.cummax`` is slower (it also
  computes indices; about 12x at ``[2 Mi, 48]``), and ``torch.cummax``
  / ``cummin`` above (``chip_smoke.scan_forms``, PERF.md);
- prefix sums of flags are ``segmented.lane_count``, one float32
  product with a triangular ones matrix up to the same width, where
  torch's innermost-dimension integer cumsum is slower too.

The values are the same either way.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..utils.consts import device_table
from .segmented import associative_scan, lane_count, lane_ext, lane_scan

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
    return lane_ext(x, True)


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


def carry_next(mask, payload, payload_max, idx):
    """(has, val): ``payload`` at the FIRST j >= i with mask[j]."""
    L = mask.shape[1]
    K = 1 << int(payload_max).bit_length()
    big = L * K
    dt = narrow_dtype(0, big)
    enc = torch.where(mask, idx.to(dt) * K + payload.to(dt), big)
    c = lane_ext(enc, False, rev=True)
    has = c < big
    return has, torch.where(has, c & (K - 1), 0).to(_I32)


def carry_last_excl(mask, payload, payload_max, idx):
    """carry_last at strictly-before positions (j < i)."""
    has, val = carry_last(mask, payload, payload_max, idx)
    return shift_right(has, False), shift_right(val, 0)


def carry_next_excl(mask, payload, payload_max, idx):
    """carry_next at strictly-after positions (j > i)."""
    has, val = carry_next(mask, payload, payload_max, idx)
    return shift_left(has, False), shift_left(val, 0)


def _pack_groups(specs, L: int):
    """Greedily group (payload, payload_max) specs so each group's
    idx*K_total encoding fits int32 (a 30-bit budget; a lone oversized
    spec spills to its own wider group). Returns
    [(spec_index, shift_bits, field_bits), ...] per group. The grouping
    is the JAX package's; regrouping could not change a decoded value."""
    idx_bits = max(int(L).bit_length(), 1)
    groups, cur, cur_bits = [], [], 0
    for si, (_p, pmax) in enumerate(specs):
        bits = max(int(pmax).bit_length(), 1)
        if cur and idx_bits + cur_bits + bits > 30:
            groups.append(cur)
            cur, cur_bits = [], 0
        cur.append((si, cur_bits, bits))
        cur_bits += bits
    if cur:
        groups.append(cur)
    return groups


def _encode_groups(mask, specs, idx, forward):
    """Packed encodings of same-mask value carries, one per group, each
    in the narrowest integer type that holds it. Forward (carry_last)
    groups encode missing as -1 under a running max; backward
    (carry_next) groups encode missing as the over-the-top sentinel
    under a reverse running min. Returns (groups, encs, sentinels)."""
    L = mask.shape[1]
    groups = _pack_groups(specs, L)
    encs, bigs = [], []
    for group in groups:
        total_bits = sum(b for _si, _sh, b in group)
        kt = 1 << total_bits
        maxenc = (L - 1) * kt + kt - 1 if forward else L * kt
        dt = narrow_dtype(-1, maxenc)
        packed = torch.zeros(mask.shape, dtype=dt, device=mask.device)
        for si, sh, _b in group:
            packed = packed | (specs[si][0].to(dt) << sh)
        fill = -1 if forward else maxenc
        encs.append(torch.where(mask, idx.to(dt) * kt + packed, fill))
        bigs.append(None if forward else maxenc)
    return groups, encs, bigs


class CarryView:
    """Decoded view of one packed carry's scanned groups. ``pair(i)`` /
    ``pair(i, excl=True)`` return the inclusive / strictly-exclusive
    ``(has, val)`` of spec i; ``pos()`` the selected position (the idx
    key). The exclusive form shifts each scanned GROUP once, filling
    with the group's missing sentinel, so has/val decode off the
    shifted word unchanged."""

    __slots__ = ("_groups", "_scanned", "_bigs", "_forward", "_shifted")

    def __init__(self, groups, scanned, bigs, forward):
        self._groups = groups
        self._scanned = scanned
        self._bigs = bigs
        self._forward = forward
        self._shifted = None

    def _scan_of(self, excl):
        if not excl:
            return self._scanned
        if self._shifted is None:
            if self._forward:
                self._shifted = [shift_right(c, -1) for c in self._scanned]
            else:
                self._shifted = [shift_left(c, big) for c, big in zip(self._scanned, self._bigs)]
        return self._shifted

    def _group_of(self, si):
        for gi, group in enumerate(self._groups):
            for sj, sh, b in group:
                if sj == si:
                    return gi, sh, b
        raise IndexError(si)

    def _has(self, c, gi):
        return (c >= 0) if self._forward else (c < self._bigs[gi])

    def pair(self, si, excl=False):
        gi, sh, b = self._group_of(si)
        c = self._scan_of(excl)[gi]
        has = self._has(c, gi)
        safe = torch.where(has, c, 0)
        return has, ((safe >> sh) & ((1 << b) - 1)).to(_I32)

    def pos(self, excl=False):
        total_bits = sum(b for _si, _sh, b in self._groups[0])
        c = self._scan_of(excl)[0]
        has = self._has(c, 0)
        safe = torch.where(has, c, 0)
        return has, (safe >> total_bits).to(_I32)


def carry_last_lanes(mask, specs, idx):
    """Lane form of ``carry_last_multi``: returns ``(lanes, decode)``
    where ``lanes`` feed ``segmented.lane_scan`` (one barrier shared
    with other masks' carries) and ``decode(outs)`` yields a
    ``CarryView``."""
    groups, encs, bigs = _encode_groups(mask, specs, idx, forward=True)
    lanes = [(torch.maximum, e, False) for e in encs]

    def decode(outs):
        return CarryView(groups, list(outs), bigs, True)

    return lanes, decode


def carry_next_lanes(mask, specs, idx):
    """Lane form of ``carry_next_multi`` (reverse lanes)."""
    groups, encs, bigs = _encode_groups(mask, specs, idx, forward=False)
    lanes = [(torch.minimum, e, True) for e in encs]

    def decode(outs):
        return CarryView(groups, list(outs), bigs, False)

    return lanes, decode


# sprtcheck: barrier-budget=1
def carry_last_multi(mask, specs, idx, with_idx=False):
    """carry_last for several payloads sharing ONE mask: the fields pack
    below the idx key of one value carry, so k same-mask carries cost
    one scan. Returns [(has, val), ...] in spec order, equal to k
    separate carry_last calls; ``with_idx`` appends the
    ``(has, position)`` of the selected j."""
    lanes, decode = carry_last_lanes(mask, specs, idx)
    v = decode(lane_scan(lanes, axis=1))
    out = [v.pair(i) for i in range(len(specs))]
    if with_idx:
        out.append(v.pos())
    return out


# sprtcheck: barrier-budget=1
def carry_next_multi(mask, specs, idx, with_idx=False):
    """The reverse twin of ``carry_last_multi``."""
    lanes, decode = carry_next_lanes(mask, specs, idx)
    v = decode(lane_scan(lanes, axis=1))
    out = [v.pair(i) for i in range(len(specs))]
    if with_idx:
        out.append(v.pos())
    return out


def excl_last(pair):
    """(has, val) of an inclusive backward carry -> strictly-before."""
    has, val = pair
    return shift_right(has, False), shift_right(val, 0)


def excl_next(pair):
    """(has, val) of an inclusive forward carry -> strictly-after."""
    has, val = pair
    return shift_left(has, False), shift_left(val, 0)


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
    """The structural state of every char. The four position scans are
    computed on first read: ``get_json_object`` reads positions by
    masked reductions instead and never pays for them."""

    idx: torch.Tensor  # int32 [n, L] position index
    pos: torch.Tensor  # [1, L] positions in the narrowest dtype holding -1..L
    esc: torch.Tensor  # bool: char is escaped (odd backslash run before it)
    quote: torch.Tensor  # bool: unescaped double quote
    outside: torch.Tensor  # bool: outside any string literal (before char)
    open_b: torch.Tensor  # bool: structural '{' or '['
    close_b: torch.Tensor  # bool: structural '}' or ']'
    d: torch.Tensor  # int32: bracket depth AFTER this char
    q_after: torch.Tensor  # int32: quote count up to and incl. this char
    nonws: torch.Tensor  # bool: non-whitespace, in-bounds char
    past_end: torch.Tensor  # bool: position beyond the row's length

    @functools.cached_property
    def prev_nonws(self) -> torch.Tensor:
        """int32: last nonws position <= i (-1 none)."""
        return lane_ext(torch.where(self.nonws, self.pos, -1), True).to(_I32)

    @functools.cached_property
    def prev_nonws_x(self) -> torch.Tensor:
        """int32: last nonws position < i (-1 none)."""
        return shift_right(self.prev_nonws, -1)

    @functools.cached_property
    def next_nonws(self) -> torch.Tensor:
        """int32: first nonws position >= i (L none)."""
        L = self.nonws.shape[1]
        return lane_ext(torch.where(self.nonws, self.pos, L), False, rev=True).to(_I32)

    @functools.cached_property
    def prev_quote_x(self) -> torch.Tensor:
        """int32: last unescaped quote position < i (-1 none)."""
        return shift_right(lane_ext(torch.where(self.quote, self.pos, -1), True).to(_I32), -1)


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
        pos=pos,
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


# ---------------------------------------------------------------------------
# full-depth grammar validation
# ---------------------------------------------------------------------------

MAX_VALIDATED_DEPTH = 32  # like the reference FST's bounded logical stack


@functools.lru_cache(maxsize=1)
def _scalar_monoid_tables():
    """Host tables of the scalar-token monoid (regex/compile.
    scalar_token_monoid): byte -> generator / reset element lifts, the
    element compose table and accept-at-start-state per element."""
    from ..regex.compile import scalar_token_monoid

    m = scalar_token_monoid()
    co = m.class_of
    return int(m.n_elems), m.gen_of_class[co], m.reset_of_class[co], m.compose, m.acc_at0


def _token_lane(chars, scalar_start, scalar_char):
    """(combine, ids) of the scalar-token monoid prefix scan: lexical
    validation of every scalar token in ONE log-depth composition. Token
    starts lift to RESET elements (constant maps, absorbing whatever came
    before), other token chars to generators, everything else to the
    identity, so one lane runs every token's anchored DFA independently.
    Errors read back only at token ends (``_token_errors_eval``)."""
    M, gen_b, reset_b, comp, _acc = _scalar_monoid_tables()
    dev = chars.device
    comp_t = device_table(np.asarray(comp, np.int64).reshape(-1).tolist(), _I32, dev)
    b = torch.where(chars >= 0, chars, 256)
    # one [3*257] lift table: case 0 = reset (token start), 1 = plain
    # token char, 2 = identity
    lift = np.zeros((3, 257), np.int32)
    lift[0], lift[1] = reset_b, gen_b
    case = torch.where(scalar_start, 0, torch.where(scalar_char, 1, 2))
    ids = device_table(lift.reshape(-1).tolist(), _I32, dev)[(case * 257 + b).long()]

    def comb(x, y):
        return comp_t[(x * M + y).long()]

    return comb, ids


def _token_errors_eval(pref, scalar_end):
    acc_at0 = device_table(np.asarray(_scalar_monoid_tables()[4], np.bool_).tolist(), torch.bool,
                           pref.device)
    return scalar_end & ~acc_at0[pref.long()]


def _token_errors_monoid(chars, scalar_start, scalar_char, scalar_end):
    """Standalone form of the token lane (one scan of its own)."""
    comb, ids = _token_lane(chars, scalar_start, scalar_char)
    return _token_errors_eval(associative_scan(comb, ids, axis=1), scalar_end)


_FIELD_LO = 0x5555555555555555  # bit 0 of every 2-bit level field


def _kind_lane(open_b, curly_open, d):
    """(combine, w) of the kind-stack lane: an associative LAST-WRITER-
    WINS store over 32 two-bit level fields in ONE 64-bit word (level k
    of a valid document is 1..MAX_VALIDATED_DEPTH; field = 01 square /
    11 curly): each open writes its field, composition keeps the later
    writer per field. The word is a uint64 held in int64 bits; only
    and/or/not and left shifts touch it, so no unsigned shift is
    needed. Rows whose depth leaves [0, MAX_VALIDATED_DEPTH] clip; the
    caller's depth checks reject them either way."""
    lvl = torch.clamp(d, 1, 32).to(torch.int64)  # an open's level = d AFTER it
    sh = (lvl - 1) * 2
    field = torch.where(curly_open, 3, 1).to(torch.int64) << sh
    w = torch.where(open_b, field, 0)

    def comb(a, b):
        nz = b & _FIELD_LO  # fields b wrote
        mask = nz | (nz << 1)
        return b | (a & ~mask)

    return comb, w


def _kind_words_monoid(open_b, curly_open, d):
    """Standalone form of the kind lane: the word BEFORE each position
    (the inclusive scan shifted right one, the serial walk's
    read-then-push order)."""
    comb, w = _kind_lane(open_b, curly_open, d)
    return shift_right(associative_scan(comb, w, axis=1), 0)


@functools.lru_cache(maxsize=1)
def _scalar_nfa():
    """Bit-parallel Glushkov NFA for one JSON scalar token (number /
    true / false / null), compiled once from the grammar by the regex
    engine (regex/compile.compile_nfa)."""
    from ..regex.compile import compile_nfa, parse

    ast, _s, _e, _g = parse(r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?|true|false|null")
    nfa = compile_nfa(ast)
    if nfa.n_positions > 31:
        raise RuntimeError(f"scalar NFA has {nfa.n_positions} positions, more than 31")
    return nfa


def _nfa_bmask_col(chars_col, nfa):
    """int32 B-mask (bits 0-30) of a char tensor via range compares."""
    acc = torch.zeros(chars_col.shape, dtype=_I32, device=chars_col.device)
    for i, ivs in enumerate(nfa.position_intervals):
        if not ivs:
            continue
        pred = (chars_col >= ivs[0][0]) & (chars_col <= ivs[0][1])
        for lo, hi in ivs[1:]:
            pred = pred | ((chars_col >= lo) & (chars_col <= hi))
        acc = acc | torch.where(pred, 1 << i, 0).to(_I32)
    return acc


def _nfa_follow(D, nfa):
    fu = torch.zeros_like(D)
    for i, f in enumerate(nfa.follow_masks):
        if f:
            fu = fu | torch.where(((D >> i) & 1) != 0, f, 0).to(D.dtype)
    return fu


@dataclasses.dataclass
class GrammarPre:
    """Elementwise masks and decoded cross-position carries the grammar
    rules consume, computed by the caller's lane barriers
    (map_utils._analyze: the deep-grammar carries ride the same
    lane_scan barriers as the span-selection carries). The monoid-lane
    results (``kind_words``, ``tok_pref``) are None under the serial
    strategy, where ``deep_grammar_errors`` runs the retained walk."""

    idx: torch.Tensor
    esc: torch.Tensor
    quote: torch.Tensor
    outside: torch.Tensor
    past_end: torch.Tensor
    open_b: torch.Tensor
    close_b: torch.Tensor
    d: torch.Tensor
    d_before: torch.Tensor
    structural: torch.Tensor
    open_q: torch.Tensor
    close_q: torch.Tensor
    scalar_start: torch.Tensor
    scalar_char: torch.Tensor
    scalar_end: torch.Tensor
    is_colon: torch.Tensor
    is_comma: torch.Tensor
    curly_open: torch.Tensor
    curly_close: torch.Tensor
    p: tuple  # (has, flags): token-end class at prev nonws (excl)
    b: tuple  # (has, val): key-predecessor flag at last open quote
    n2: tuple  # (has, val): colon-after flag at next quote (excl)
    kind_words: Optional[torch.Tensor] = None  # exclusive kind-stack words
    tok_pref: Optional[torch.Tensor] = None  # token-monoid prefix ids


def grammar_masks(chars, nonws, esc, quote, outside, open_b, close_b, d, past_end, idx):
    """The elementwise mask family the grammar rules share with the span
    analysis, defined once so the two cannot drift. Returns a partly
    filled ``GrammarPre`` (the carries are filled by the caller's lane
    barriers) plus the packed token-end / okpred payload pair that rides
    the caller's prev-nonws carry."""
    structural = open_b | close_b | (outside & ((chars == COLON) | (chars == COMMA)))
    open_q = quote & outside  # opening quote of a string
    close_q = quote & ~outside  # closing quote
    scalar_char = nonws & outside & ~structural & ~quote
    scalar_start = scalar_char & ~shift_right(scalar_char, False)
    scalar_end = scalar_char & ~shift_left(scalar_char, False)
    is_colon = outside & (chars == COLON)
    is_comma = outside & (chars == COMMA)
    pre = GrammarPre(
        idx=idx, esc=esc, quote=quote, outside=outside, past_end=past_end,
        open_b=open_b, close_b=close_b, d=d, d_before=shift_right(d, 0),
        structural=structural, open_q=open_q, close_q=close_q,
        scalar_start=scalar_start, scalar_char=scalar_char, scalar_end=scalar_end,
        is_colon=is_colon, is_comma=is_comma,
        curly_open=open_b & (chars == LBRACE), curly_close=chars == RBRACE,
        p=None, b=None, n2=None,
    )
    # previous-token END class: six flags packed into the caller's
    # prev-nonws value carry; okpred rides the same word
    flags = (
        open_b.to(_I32)
        | (close_b.to(_I32) << 1)
        | (is_colon.to(_I32) << 2)
        | (is_comma.to(_I32) << 3)
        | (close_q.to(_I32) << 4)
        | (scalar_end.to(_I32) << 5)
    )
    okpred = outside & ((chars == LBRACE) | (chars == COMMA))
    return pre, flags, okpred


def _serial_stack_walk(pre: GrammarPre, bmask, nfa):
    """The retained length-serial walk of the ``serial`` strategy: the
    enclosing-container kind stack (bit k of a 64-bit state = the
    container at depth k is an object) and the scalar-token NFA, one
    char column at a time. Returns (in_object, scan_err) [n, L]."""
    n, L = pre.d.shape
    dev = pre.d.device
    kind_state = torch.zeros((n,), dtype=torch.int64, device=dev)
    D = torch.zeros((n,), dtype=_I32, device=dev)
    last_mask, first_mask = int(nfa.last_mask), int(nfa.first_mask)
    in_obj_cols, err_cols = [], []
    for j in range(L):
        dbj = pre.d_before[:, j]
        dbs = torch.clamp(dbj, 0, 63).to(torch.int64)
        kind_bit = ((kind_state >> dbs) & 1) != 0
        in_obj_cols.append(kind_bit & (dbj > 0))
        close_err = pre.close_b[:, j] & (kind_bit != pre.curly_close[:, j]) & (dbj > 0)
        # push on open: its level is d AFTER the open
        bit = torch.ones_like(kind_state) << torch.clamp(pre.d[:, j], 0, 63).to(torch.int64)
        pushed = torch.where(pre.curly_open[:, j], kind_state | bit, kind_state & ~bit)
        kind_state = torch.where(pre.open_b[:, j], pushed, kind_state)
        # scalar-token NFA step (reset outside tokens, inject at starts)
        inj = torch.where(pre.scalar_start[:, j], first_mask, 0).to(_I32)
        Dn = (_nfa_follow(D, nfa) | inj) & bmask[:, j]
        tok_err = pre.scalar_end[:, j] & ((Dn & last_mask) == 0)
        D = torch.where(pre.scalar_char[:, j], Dn, 0)
        err_cols.append(close_err | tok_err)
    return torch.stack(in_obj_cols, dim=1), torch.stack(err_cols, dim=1)


def deep_grammar_errors(chars: torch.Tensor, pre: GrammarPre, monoid: bool = True) -> torch.Tensor:
    """bool [n]: rows whose token stream violates the JSON grammar at ANY
    depth: the rejection set of the reference's full tokenizer
    (map_utils.cu:575-577), as data-parallel adjacency rules.

    With quote parity and non-negative / zero-final depth validated by
    the caller, JSON validity reduces to per-token rules that need only
    (a) the previous token's end class, (b) the kind of the enclosing
    container, (c) the key-string / colon pairing in objects and (d)
    lexical validity of every scalar token. (a)-(c) arrive as decoded
    carries in ``pre``; (b) and (d) come from the monoid lanes
    (``kind_words``, ``tok_pref``), or with ``monoid=False`` from the
    retained serial walk. Depth is validated up to
    MAX_VALIDATED_DEPTH (deeper rows error, like the FST's bounded
    stack)."""
    outside = pre.outside
    open_b, close_b = pre.open_b, pre.close_b
    d_before = pre.d_before
    open_q, close_q = pre.open_q, pre.close_q
    scalar_start, scalar_end = pre.scalar_start, pre.scalar_end
    is_colon, is_comma = pre.is_colon, pre.is_comma

    p_has, p_flags = pre.p
    p_none = ~p_has
    p_open = p_has & ((p_flags & 1) != 0)
    p_close = p_has & ((p_flags & 2) != 0)
    p_colon = p_has & ((p_flags & 4) != 0)
    p_comma = p_has & ((p_flags & 8) != 0)
    p_strend = p_has & ((p_flags & 16) != 0)
    p_scalarend = p_has & ((p_flags & 32) != 0)

    depth_exceeded = torch.where(pre.past_end, 0, pre.d).amax(dim=1) > MAX_VALIDATED_DEPTH
    nfa = _scalar_nfa()

    if monoid:
        # the kind-stack store and the token-monoid prefix arrived as
        # lanes of the caller's shared barrier: only the bit reads here
        dbs = (torch.clamp(d_before, 1, 32).to(torch.int64) - 1) * 2
        kind_bit = ((pre.kind_words >> (dbs + 1)) & 1) != 0
        in_object = kind_bit & (d_before > 0)
        close_err = close_b & (kind_bit != pre.curly_close) & (d_before > 0)
        scan_err = close_err | _token_errors_eval(pre.tok_pref, scalar_end)
    else:
        in_object, scan_err = _serial_stack_walk(pre, _nfa_bmask_col(chars, nfa), nfa)

    at_root = d_before == 0
    in_array = ~at_root & ~in_object

    # value-start tokens: scalar / string / open bracket
    value_ctx_ok = torch.where(
        in_object, p_colon, torch.where(in_array, p_open | p_comma, p_none)
    )
    err = scan_err
    err = err | (scalar_start & ~value_ctx_ok)
    err = err | (open_b & ~value_ctx_ok)
    # strings: values as above, plus keys (after '{' or ',') in objects
    str_ok = value_ctx_ok | (in_object & (p_open | p_comma))
    err = err | (open_q & ~str_ok)
    # close bracket: after the matching open (empty), or a value end
    err = err | (close_b & ~(p_open | p_strend | p_scalarend | p_close))
    # comma: inside a container, after a value end
    err = err | (is_comma & ~((in_object | in_array) & (p_strend | p_scalarend | p_close)))
    # colon: in an object, after the END of a KEY string (one whose own
    # predecessor is '{' or ','); the key-predecessor flag sampled at the
    # key's opening quote is read off the open-quote carry AT the colon
    # (no opening quote can sit between a valid colon and its key)
    b_has, b_val = pre.b
    key_pred_ok = b_has & (b_val != 0)
    err = err | (is_colon & ~(in_object & p_strend & key_pred_ok))
    # key-colon pairing: a key string must be FOLLOWED by ':' (the
    # colon-after flag sampled at the key's closing quote)
    is_key_start = open_q & in_object & (p_open | p_comma)
    n2_has, n2_val = pre.n2
    err = err | (is_key_start & ~(n2_has & (n2_val != 0)))

    # in-string character rules: raw control chars, invalid escapes,
    # \uXXXX needs 4 hex digits
    in_str = ~outside & ~pre.past_end & ~close_q
    err = err | (in_str & (chars >= 0) & (chars < 0x20))
    escaped = pre.esc  # char preceded by an odd backslash run
    esc_ch_ok = (
        (chars == QUOTE)
        | (chars == BSLASH)
        | (chars == ord("/"))
        | (chars == ord("b"))
        | (chars == ord("f"))
        | (chars == ord("n"))
        | (chars == ord("r"))
        | (chars == ord("t"))
        | (chars == ord("u"))
    )
    err = err | (in_str & escaped & ~esc_ch_ok)
    is_hex = (
        ((chars >= ord("0")) & (chars <= ord("9")))
        | ((chars >= ord("a")) & (chars <= ord("f")))
        | ((chars >= ord("A")) & (chars <= ord("F")))
    )
    u_esc = in_str & escaped & (chars == ord("u"))
    h = is_hex & in_str
    for _off in range(4):
        h = shift_left(h, False)
        err = err | (u_esc & ~h)

    return err.any(dim=1) | depth_exceeded
