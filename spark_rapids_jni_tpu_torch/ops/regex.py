"""Device-side regex execution over char matrices (PyTorch twin of the
JAX package's ``ops/regex.py``: same strategies, same dispatch and
knobs, bit-identical results).

Execution is data-parallel over rows, and log-depth over string length
where the automaton allows it: a DFA step is a function S->S, function
composition is associative, so all prefix states come out of a
parallel prefix over the TRANSITION MONOID (Ladner-Fischer 1980; the
data-parallel FSM formulation of Mytkowicz et al., ASPLOS 2014).

Execution strategies (``ops/_strategy.py`` knob; auto-selected):

- **monoid** (default for small DFAs): the pattern's transition monoid
  is enumerated ON HOST (``regex/compile.compile_monoid``) — each
  reachable S->S composition gets a dense element id, so the device
  composition of two elements is ONE small-table gather. ``rlike``
  becomes a log-depth tree REDUCTION; ``regexp_extract``'s per-start
  re-walks collapse into prefix/suffix composition scans
  (``segmented.associative_scan``, Hillis-Steele: composition is an
  exact monoid, so any tree order gives the same ids).
- **serial** (fallback, knob-forced or large state counts): the
  length-serial walks — the bit-parallel Glushkov NFA under 63
  positions, the DFA table walk beyond, and the ``[n, L]`` all-starts
  state matrix for extraction (O(L^2) work).

In eager torch every step of a serial walk is a dispatched op, so the
walks are written to dispatch few: the NFA's follow-set union reads
per-16-bit-chunk union tables with one gather a chunk (at most four)
instead of one select per position, and the B-masks are one gather of
a 257-entry byte table built on the host (from the position intervals
or the byte classes, as the JAX package chooses). The JAX package
unrolls a walk up to 128 characters and runs ``lax.scan``
beyond; both are the same eager loop here.

Automaton tables are host numpy arrays in ``lru_cache``d holders, as in
the JAX package; each holder uploads them to a device once and keeps
the tensors (``_Tables.on``).

Semantics notes (tested against Python ``re`` as oracle):
- ``rlike``: exact for the supported syntax (regex/compile.py).
- ``regexp_extract`` group 0: leftmost-LONGEST match. Java's
  backtracking engine is leftmost-first; for the supported subset these
  coincide except when an earlier-alternative shorter match would win
  in Java (e.g. (a|ab) on "ab" -> Java "a", here "ab").
- ``regexp_extract`` groups 1..9: supported when every capture group
  sits at the TOP level of the concatenation (``seg0(g1)seg1(g2)...``;
  nested groups / groups under quantifiers or alternations raise).
  Segments take their longest feasible span left to right (shortest
  when their quantifier is lazy) such that the remaining segments still
  fit, which replicates Java's greedy/lazy backtracking outcome for
  these decomposable patterns.
"""

from __future__ import annotations

import hashlib
import threading
import types
from functools import lru_cache

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.dtypes import BOOL8
from ..columnar.strings import bucket_length, from_char_matrix, to_char_matrix
from ..regex.compile import (
    Concat,
    Empty,
    Group,
    Node,
    RegexUnsupported,
    Repeat,
    byte_table,
    compile_ast,
    compile_gated_monoid,
    compile_gated_search,
    compile_monoid,
    compile_nfa,
    parse,
    reverse_ast,
    stack_monoids,
)
from ..runtime import metrics as _metrics
from ._strategy import monoid_max_states, scan_batching, scan_strategy
from .segmented import associative_scan, stacked_monoid_combine

_I32 = torch.int32

# ---------------------------------------------------------------------------
# host tables and their device copies
# ---------------------------------------------------------------------------

_UPLOAD_LOCK = threading.Lock()


def _to_device(arr, device):
    if arr is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class _Tables:
    """Base of the host table holders. ``on(device)`` returns the numpy
    tables named in ``_TABLES`` as tensors on ``device``, uploaded on
    first use and kept in the holder (the ``lru_cache`` that holds the
    holder bounds them)."""

    __slots__ = ()
    _TABLES: tuple = ()

    def on(self, device) -> types.SimpleNamespace:
        key = str(device)
        with _UPLOAD_LOCK:
            got = self._dev.get(key)
            if got is None:
                got = self._dev[key] = types.SimpleNamespace(
                    **{k: _to_device(getattr(self, k), device) for k in self._TABLES}
                )
        return got


class _Serial(_Tables):
    """Flat tables of one DFA for the serial walks."""

    __slots__ = ("trans", "acc", "cls", "C", "a_start", "a_end", "_dev")
    _TABLES = ("trans", "acc", "cls")

    def __init__(self, dfa, a_start=False, a_end=False):
        self.trans = np.asarray(dfa.transition, np.int32).reshape(-1)
        self.acc = np.asarray(dfa.accepting, np.bool_)
        self.cls = np.asarray(dfa.class_of, np.int32)
        self.C = dfa.n_classes
        self.a_start = a_start
        self.a_end = a_end
        self._dev = {}


@lru_cache(maxsize=256)
def _compiled_dfa(pattern: str, mode: str):
    """(DFA, a_start, a_end) — the compiled automaton object, shared
    by the serial tables below and the monoid caches."""
    ast, a_start, a_end, _ngroups = parse(pattern)
    dfa = compile_ast(ast, "anchored" if (mode == "anchored" or a_start) else "search")
    return dfa, a_start, a_end


@lru_cache(maxsize=256)
def _compiled(pattern: str, mode: str) -> _Serial:
    dfa, a_start, a_end = _compiled_dfa(pattern, mode)
    return _Serial(dfa, a_start, a_end)


def pattern_fingerprint(pattern: str, mode: str = "rlike") -> str:
    """Content hash of the compiled automaton + anchor flags — the
    pipeline plan-cache KEY for rlike entries: two pattern strings
    compiling to the same DFA (``[0-9]+`` and ``\\d+``) share it. The
    JAX package's string, character for character."""
    dfa, a_start, a_end = _compiled_dfa(pattern, mode)
    return f"{dfa.fingerprint()}:{int(bool(a_start))}{int(bool(a_end))}"


@lru_cache(maxsize=256)
def extraction_fingerprint(pattern: str) -> str:
    """Plan-cache key for regexp_extract entries: folds every component
    that can change the output (anchored DFA, anchors, group count, the
    segment decomposition with its per-segment automata and greedy/lazy
    flags). The JAX package's string, character for character."""
    ast, a_start, a_end, ngroups = parse(pattern)
    whole = compile_ast(ast, "anchored")
    parts = [
        whole.fingerprint(),
        f"{int(bool(a_start))}{int(bool(a_end))}",
        str(ngroups),
        f"lz{int(_segment_lazy(ast) and not a_end)}",
    ]
    try:
        segs = _split_segments(ast)
        if sum(1 for _n, g in segs if g is not None) != ngroups:
            parts.append("nosplit")
        else:
            for node, gno in segs:
                sdfa = compile_ast(node, "anchored")
                parts.append(
                    f"{sdfa.fingerprint()}"
                    f":g{gno if gno is not None else '-'}"
                    f":l{int(_segment_lazy(node))}"
                )
    except RegexUnsupported:
        parts.append("nosplit")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _record_strategy(name: str, n_states=None) -> None:
    """Telemetry: which execution strategy ran (regex.strategy.<name>
    counter) and the monoid path's dense DFA state count
    (regex.monoid_states gauge) — docs/OBSERVABILITY.md vocab."""
    if not _metrics.enabled():
        return
    _metrics.counter(f"regex.strategy.{name}").inc()
    if n_states is not None:
        _metrics.gauge("regex.monoid_states").set(n_states)


def _byte_index(chars: torch.Tensor) -> torch.Tensor:
    """int32 char matrix -> byte-table index (-1 past-end -> 256)."""
    return torch.where(chars >= 0, chars, 256)


def _arange(L: int, device) -> torch.Tensor:
    return torch.arange(L, dtype=_I32, device=device)[None, :]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[r, idx[r]]`` for a 2-D ``x`` and 1-D ``idx``."""
    return x.gather(1, idx.long()[:, None])[:, 0]


def _first_true(valid: torch.Tensor) -> torch.Tensor:
    """int32 index of the first True per row (0 when none)."""
    return torch.argmax(valid.to(torch.uint8), dim=1).to(_I32)


# ---------------------------------------------------------------------------
# transition-monoid execution (log-depth; the default strategy)
# ---------------------------------------------------------------------------


class _DeviceMonoid(_Tables):
    """Kernel-ready tables of one TransitionMonoid: byte -> element
    lifts (generator / reset), the [M*M] compose table, and the
    evaluation vectors, as host numpy arrays."""

    __slots__ = (
        "M", "S", "gen_of_byte", "reset_of_byte", "comp", "at0",
        "acc_at0", "hit0", "elems", "acc", "acc0", "nullable",
        "trans_flat", "cls_of_byte", "_dev",
    )
    _TABLES = ("gen_of_byte", "reset_of_byte", "comp", "at0", "acc_at0", "hit0",
               "elems", "acc", "trans_flat", "cls_of_byte")

    def __init__(self, m, dfa=None, class_of=None):
        co = byte_table(dfa.class_of if dfa is not None else class_of)
        self.M = m.n_elems
        self.S = m.n_states
        self.gen_of_byte = m.gen_of_class[co]
        self.reset_of_byte = m.reset_of_class[co] if m.reset_of_class is not None else None
        self.comp = m.compose
        self.at0 = m.at0
        self.acc_at0 = m.acc_at0
        self.hit0 = m.hit0
        self.elems = m.elems
        self.acc = np.asarray(m.accepting, np.bool_)
        self.acc0 = bool(m.accepting[0])
        self.nullable = bool(m.nullable)
        if dfa is not None:
            self.trans_flat = np.asarray(dfa.transition, np.int32).reshape(-1)
        else:
            self.trans_flat = None
        self.cls_of_byte = co
        self._dev = {}


class _GatedDeviceMonoid(_Tables):
    """Tables of a gated-restart monoid: the generator lift is indexed
    by (byte, gate) — ``gen_of_byte_gate[byte, g]``."""

    __slots__ = ("M", "gen_of_byte_gate", "comp", "acc_at0", "nullable", "_dev")
    _TABLES = ("gen_of_byte_gate", "comp", "acc_at0")

    def __init__(self, m, gdfa):
        co = byte_table(gdfa.class_of)
        self.M = m.n_elems
        # [C, 2] generator ids -> [257, 2] byte x gate lift
        self.gen_of_byte_gate = m.gen_of_class.reshape(gdfa.n_classes, 2)[co]
        self.comp = m.compose
        self.acc_at0 = m.acc_at0
        self.nullable = bool(m.nullable)
        self._dev = {}


def _fwd_scan(ids, comp, M: int):
    """Inclusive prefix composition along axis 1, LOWER positions
    applied first (forward run order): out[j] = x0 . x1 ... . xj."""
    return associative_scan(lambda a, b: comp[torch.add(b, a, alpha=M)], ids, axis=1)


def _rev_scan(ids, comp, M: int):
    """Inclusive suffix composition along axis 1, HIGHER positions
    applied first (reversed-run order): out[j] = x_{L-1} ... . xj."""
    return associative_scan(lambda a, b: comp[torch.add(b, a, alpha=M)], ids, axis=1, rev=True)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@lru_cache(maxsize=256)
def _rlike_monoid_tables(pattern: str, max_states):
    """Tables for the rlike reduction, or None (serial fallback): the
    hit-augmented transition monoid of the rlike-mode DFA.
    ``max_states`` None skips the auto threshold (strategy forced to
    monoid)."""
    dfa, a_start, a_end = _compiled_dfa(pattern, "rlike")
    if max_states is not None and not dfa.monoid_ok(max_states):
        return None
    m = compile_monoid(dfa, with_hits=True)
    if m is None:
        return None
    return _DeviceMonoid(m, dfa=dfa), bool(a_end), dfa.n_states, dfa.n_classes


def _rlike_monoid_kernel(L: int, M: int, C: int, a_end: bool, acc0: bool,
                         data, offsets, lengths, t):
    """rlike as one chain: flat-payload byte gather -> element lift ->
    log2(L)-level tree reduction over the hit-augmented monoid ->
    terminator fixup. The whole per-row answer (matched-anywhere, state
    at the $-position, final state) comes out of the reduced element."""
    n = lengths.shape[0]
    dev = lengths.device
    j = _arange(L, dev)
    starts = offsets[:-1].to(_I32)
    if data.shape[0] == 0:
        byts = torch.full((n, L), -1, dtype=_I32, device=dev)
    else:
        pos = (starts[:, None] + j).clamp_(0, data.shape[0] - 1)
        byts = data[pos].to(_I32)

    # final line terminator (\n, \r\n or \r): Java's $ positions
    term = _terminator_len(byts, lengths)
    main_len = lengths - term
    active = j < main_len[:, None]
    safe_byte = byts.clamp(0, 256)  # -1 only at inactive positions
    ids = torch.where(active, t.gen_of_byte[safe_byte], 0)

    Lp = _next_pow2(L)
    if Lp != L:
        ids = torch.nn.functional.pad(ids, (0, Lp - L))
    w = Lp
    while w > 1:  # log2(L) levels of pairwise composition
        ids = t.comp[torch.add(ids[:, 1::2], ids[:, 0::2], alpha=M)]
        w //= 2
    elem = ids[:, 0]

    state = t.at0[elem]  # state after the pre-terminator prefix
    matched = t.hit0[elem] | acc0
    at_term = t.acc[state]

    # terminator chars: at most 2 strictly-serial (but [n]-cheap) steps
    for k in range(2):
        ch = _take(byts, (main_len + k).clamp(0, max(L - 1, 0)))
        do = term > k
        ns = t.trans_flat[torch.add(t.cls_of_byte[ch.clamp(0, 256)], state, alpha=C)]
        state = torch.where(do, ns, state)
        matched = matched | (do & t.acc[state])
    result = (t.acc[state] | at_term) if a_end else matched
    return result.to(torch.int8)


def _bucketed_width(col: Column, width) -> int:
    """Char width: the caller's pinned width, else one host sync of the
    max length, bucketed as ``columnar/strings.to_char_matrix`` does."""
    if width is not None:
        return int(width)
    if len(col) == 0:
        return bucket_length(1)
    return bucket_length(max(int(col.string_lengths().max()), 1))


def _rlike_monoid(col: Column, tables, width) -> Column:
    dm, a_end, _S, C = tables
    n = len(col)
    if n == 0:
        return Column(BOOL8, torch.zeros(0, dtype=torch.int8, device=col.device), col.validity)
    L = _bucketed_width(col, width)
    lengths = torch.clamp(col.string_lengths(), max=L)
    result = _rlike_monoid_kernel(
        L, dm.M, C, a_end, dm.acc0, col.data, col.offsets, lengths, dm.on(col.device)
    )
    return Column(BOOL8, result, col.validity)


def _dfa_walk(cls, lengths, term, t, C: int, a_end: bool):
    """The serial DFA walk: one carry-dependent table gather per
    character per row (the JAX package's ``_rlike_kernel`` /
    ``_dfa_step`` and its ``lax.scan`` form for wide rows)."""
    n, L = cls.shape
    dev = cls.device
    j = _arange(L, dev)
    active = j < lengths[:, None]
    # Java's $ also matches just before a final line terminator
    # (\n, \r\n or \r): remember acceptance at that position
    at_pos = (j + 1) == (lengths - term)[:, None]
    acc0 = bool(t.acc[0])
    state = torch.zeros(n, dtype=_I32, device=dev)
    matched = torch.full((n,), acc0, dtype=torch.bool, device=dev)
    at_term = (lengths == term) & acc0  # terminator-only strings
    for k in range(L):
        ns = t.trans[torch.add(cls[:, k], state, alpha=C)]
        state = torch.where(active[:, k], ns, state)
        acc = t.acc[state]
        matched = matched | (active[:, k] & acc)
        at_term = torch.where(at_pos[:, k], acc, at_term)
    result = (t.acc[state] | at_term) if a_end else matched
    return result.to(torch.int8)


_NFA_MAX_POSITIONS = 63
_FOLLOW_CHUNK = 16  # bits of D read by one follow-union table gather


@lru_cache(maxsize=256)
def _compiled_nfa(pattern: str):
    """Bit-parallel Glushkov form, or None when the linearized pattern
    exceeds the 63-bit position budget (DFA fallback). The position
    masks ride as int64 bits: bit 63 is never set."""
    ast, a_start, a_end, _ng = parse(pattern)
    nfa = compile_nfa(ast)
    if nfa.n_positions > _NFA_MAX_POSITIONS:
        return None
    return _NfaTables(nfa), bool(a_start), bool(a_end)


class _NfaTables(_Tables):
    """Host tables of one bit-parallel NFA: the 257-entry byte -> B-mask
    table and the per-chunk follow-union tables
    (``follow_union[c, v]`` = OR of ``follow[16c + k]`` over the bits
    ``k`` set in ``v``)."""

    __slots__ = ("nfa", "byte_masks", "follow_union", "_dev")
    _TABLES = ("byte_masks", "follow_union")

    def __init__(self, nfa):
        self.nfa = nfa
        self.byte_masks = _byte_mask_table(nfa)
        m = nfa.n_positions
        chunks = []
        for c in range(0, m, _FOLLOW_CHUNK):
            width = min(_FOLLOW_CHUNK, m - c)
            tbl = np.zeros(1 << width, np.int64)
            for k in range(width):
                half = 1 << k
                tbl[half : 2 * half] = tbl[:half] | np.int64(nfa.follow_masks[c + k])
            chunks.append(tbl)
        size = max((len(t) for t in chunks), default=1)
        self.follow_union = np.zeros((max(len(chunks), 1), size), np.int64)
        for i, tbl in enumerate(chunks):
            self.follow_union[i, : len(tbl)] = tbl
        self._dev = {}


_INTERVAL_BUDGET = 96  # the JAX package's switch between its two B-mask forms


def _bmasks_intervals(intervals) -> np.ndarray:
    """The 257-entry byte -> B-mask table of the interval form: bit i
    of entry b says byte b is in position i's byte set; the past-end
    entry 256 fails every range and stays 0."""
    tbl = np.zeros(257, np.int64)
    for i, ivs in enumerate(intervals):
        for lo, hi in ivs:
            tbl[lo : hi + 1] |= np.int64(1 << i)
    return tbl


def _byte_mask_table(nfa) -> np.ndarray:
    """B-mask table by the JAX package's rule: from the position
    intervals up to ``_INTERVAL_BUDGET`` intervals, else class_of
    composed with class_masks. Both give the same table; on the card
    either is one gather."""
    if nfa.n_intervals <= _INTERVAL_BUDGET:
        return _bmasks_intervals(nfa.position_intervals)
    return np.asarray(nfa.class_masks, np.int64)[np.asarray(nfa.class_of, np.int32)]


def _nfa_walk(bmasks, lengths, term, t, nfa, a_start: bool, a_end: bool):
    """The bit-parallel NFA walk (the JAX package's ``_rlike_nfa_kernel``
    with ``_nfa_step``): D' = (follow_union(D) | first?) & B[c]."""
    n, L = bmasks.shape
    dev = bmasks.device
    j = _arange(L, dev)
    active = j < lengths[:, None]
    at_pos = (j + 1) == (lengths - term)[:, None]
    last, first = nfa.last_mask, nfa.first_mask
    n_chunks = -(-nfa.n_positions // _FOLLOW_CHUNK)
    D = torch.zeros(n, dtype=torch.int64, device=dev)
    matched = torch.full((n,), bool(nfa.nullable), dtype=torch.bool, device=dev)
    at_term = (lengths == term) & bool(nfa.nullable)
    for k in range(L):
        fu = None
        for c in range(n_chunks):
            part = D if c == 0 else D >> (c * _FOLLOW_CHUNK)
            part = t.follow_union[c][part & ((1 << _FOLLOW_CHUNK) - 1)]
            fu = part if fu is None else fu | part
        if fu is None:
            fu = torch.zeros_like(D)
        if not a_start or k == 0:
            fu = fu | first  # the '.*' restart (search), or step 0 (anchored)
        Dn = fu & bmasks[:, k]
        D = torch.where(active[:, k], Dn, D)
        hit = (Dn & last) != 0
        matched = matched | (active[:, k] & hit)
        # Java's $ also matches just before a final line terminator
        at_term = torch.where(at_pos[:, k], hit, at_term)
    result = (((D & last) != 0) | at_term) if a_end else matched
    return result.to(torch.int8)


def _rlike_nfa(col: Column, info, width=None) -> Column:
    tables, a_start, a_end = info
    nfa = tables.nfa
    chars, lengths = to_char_matrix(col, width)
    n, L = chars.shape
    if nfa.nullable and not (a_start and a_end):
        # the empty match: Matcher.find() succeeds at some offset for
        # every subject (matches the DFA's always-accepting q0)
        return Column(BOOL8, torch.ones(n, dtype=torch.int8, device=col.device), col.validity)
    t = tables.on(col.device)
    bmasks = t.byte_masks[_byte_index(chars)]
    term = _terminator_len(chars, lengths)
    result = _nfa_walk(bmasks, lengths, term, t, nfa, a_start, a_end)
    return Column(BOOL8, result, col.validity)


def rlike(col: Column, pattern: str, width=None) -> Column:
    """Spark `str RLIKE pattern` -> BOOL8 column (search semantics;
    leading ^ / trailing $ anchor to string start/end). Strategy
    selection (ops/_strategy.py): the log-depth transition-monoid
    reduction when the DFA is small enough to enumerate (the default),
    else the serial family (bit-parallel NFA under 63 Glushkov
    positions, DFA table walk beyond). ``width`` pins the char-matrix
    byte count (longer strings truncate). Runs on the device of
    ``col``."""
    strat = scan_strategy()
    if strat != "serial":
        tables = _rlike_monoid_tables(pattern, None if strat == "monoid" else monoid_max_states())
        if tables is not None:
            _record_strategy("monoid", tables[2])
            return _rlike_monoid(col, tables, width)
    _record_strategy("serial")
    return _rlike_serial(col, pattern, width)


def _rlike_serial(col: Column, pattern: str, width=None) -> Column:
    """The length-serial family: bit-parallel NFA when the pattern fits
    63 Glushkov positions, DFA table walk beyond."""
    info = _compiled_nfa(pattern)
    if info is not None:
        return _rlike_nfa(col, info, width)
    return _rlike_dfa(col, pattern, width)


def _rlike_dfa(col: Column, pattern: str, width=None) -> Column:
    """Serial DFA walk (and direct test target): one carry-dependent
    table gather per character per row."""
    ser = _compiled(pattern, "rlike")
    chars, lengths = to_char_matrix(col, width)
    t = ser.on(col.device)
    cls = t.cls[_byte_index(chars)]
    term = _terminator_len(chars, lengths)
    return Column(BOOL8, _dfa_walk(cls, lengths, term, t, ser.C, bool(ser.a_end)), col.validity)


def regexp_like(col: Column, pattern: str) -> Column:
    """Spark 3.x alias of rlike."""
    return rlike(col, pattern)


def _terminator_len(chars, lengths):
    """Per-row length (0/1/2) of a final line terminator: '\\r\\n',
    '\\n' or '\\r' — the positions Java's $ treats as end-of-input."""
    L = chars.shape[1]
    last = _take(chars, (lengths - 1).clamp(0, max(L - 1, 0)))
    prev = _take(chars, (lengths - 2).clamp(0, max(L - 1, 0)))
    crlf = (lengths > 1) & (prev == 13) & (last == 10)
    single = (lengths > 0) & ((last == 10) | (last == 13))
    return torch.where(crlf, 2, single.to(_I32))


# ---------------------------------------------------------------------------
# regexp_extract: monoid form — match starts from ONE suffix
# composition scan over the REVERSED pattern's automaton, per-start
# runs from prefix scans with reset elements, feasibility from a
# gated-restart automaton.
# ---------------------------------------------------------------------------


class _ExtractMonoid:
    """Monoid bundle for one extraction pattern (all-or-nothing: any
    component failing enumeration falls the whole pattern back to the
    serial path). ``tails`` holds the batched-lift tables (a
    ``_TailStack``) when every reversed TAIL concatenation's gated
    monoid enumerates; None keeps the per-segment feasibility chain."""

    __slots__ = (
        "w", "r", "segs", "C_r", "a_start", "a_end", "lazy_end",
        "empty_ok", "tails",
    )

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _TailStack(_Tables):
    """Stacked gated-restart tables of the reversed TAIL patterns
    (segments i..m for i = 1..P-1): one stacked scan over a [K, n, L]
    id array answers every tail's feasibility (regex/compile.
    stack_monoids), replacing the P-1 chained per-segment scans."""

    __slots__ = ("K", "genbg", "comp_flat", "base", "mk", "ebase",
                 "acc_flat", "nullable", "null_arr", "_dev")
    _TABLES = ("genbg", "comp_flat", "base", "mk", "ebase", "acc_flat", "null_arr")

    def __init__(self, gms, gdfas):
        self.K = len(gms)
        sm = stack_monoids(gms) if gms else None
        self.comp_flat = sm.comp_flat if sm else np.zeros((0,), np.int32)
        self.base = sm.base if sm else np.zeros((0, 1, 1), np.int32)
        self.mk = sm.mk if sm else np.zeros((0, 1, 1), np.int32)
        self.ebase = sm.ebase if sm else np.zeros((0, 1, 1), np.int32)
        self.acc_flat = sm.acc_at0_flat if sm else np.zeros((0,), np.bool_)
        self.nullable = tuple(bool(m.nullable) for m in gms)
        self.null_arr = np.asarray(self.nullable, np.bool_)
        lifts = []
        for m, g in zip(gms, gdfas):
            by_class = m.gen_of_class.reshape(g.n_classes, 2)
            lifts.append(by_class[byte_table(g.class_of)])  # [257, 2]
        self.genbg = np.stack(lifts) if lifts else np.zeros((0, 257, 2), np.int32)
        self._dev = {}


@lru_cache(maxsize=128)
def _extract_monoid(pattern: str, max_states):
    """Monoid bundle for ``regexp_extract`` or None (serial fallback).
    Components: the whole-pattern anchored monoid WITH resets, the
    REVERSED pattern's monoid (search mode for match-start feasibility,
    anchored mode under $), and per top-level segment a reset monoid
    plus the gated-restart monoid of the reversed segment."""
    ast, a_start, a_end, ngroups = parse(pattern)
    limit = 10**9 if max_states is None else int(max_states)
    whole = compile_ast(ast, "anchored")
    if whole.n_states > limit:
        return None
    wm = compile_monoid(whole, with_resets=True)
    if wm is None:
        return None
    try:
        rev_dfa = compile_ast(reverse_ast(ast), "anchored" if a_end else "search")
    except RegexUnsupported:
        return None
    if rev_dfa.n_states > limit:
        return None
    rm = compile_monoid(rev_dfa)
    if rm is None:
        return None
    try:
        raw = _split_segments(ast)
        if sum(1 for _n, g in raw if g is not None) != ngroups:
            raw = None
    except RegexUnsupported:
        raw = None  # group-0 plain-span path needs no segment tables
    segs = None
    if raw is not None:
        segs = []
        try:
            for node, _gno in raw:
                sdfa = compile_ast(node, "anchored")
                if sdfa.n_states > limit:
                    return None
                sm = compile_monoid(sdfa, with_resets=True)
                gdfa = compile_gated_search(reverse_ast(node))
                gm = compile_gated_monoid(gdfa)
                if sm is None or gm is None:
                    return None
                segs.append((_DeviceMonoid(sm, dfa=sdfa), _GatedDeviceMonoid(gm, gdfa)))
        except RegexUnsupported:
            return None
    # batched lift: gated monoids of the reversed TAIL concatenations
    # (segments i..m), all gated on end-validity. Any tail failing to
    # enumerate keeps tails=None: the per-segment chain is the fallback
    tails = None
    if raw is not None and segs is not None:
        try:
            gms, gdfas = [], []
            for i in range(1, len(raw)):
                nodes = [node for node, _g in raw[i:]]
                tail_ast = nodes[0] if len(nodes) == 1 else Concat(nodes)
                gdfa = compile_gated_search(reverse_ast(tail_ast))
                gm = compile_gated_monoid(gdfa)
                if gm is None:
                    break
                gms.append(gm)
                gdfas.append(gdfa)
            else:
                tails = _TailStack(gms, gdfas)
        except RegexUnsupported:
            tails = None
    return _ExtractMonoid(
        w=_DeviceMonoid(wm, dfa=whole),
        r=_DeviceMonoid(rm, dfa=rev_dfa),
        segs=segs,
        C_r=rev_dfa.n_classes,
        a_start=bool(a_start),
        a_end=bool(a_end),
        lazy_end=_segment_lazy(ast) and not a_end,
        empty_ok=bool(whole.accepting[0]),
        tails=tails,
    )


def _match_starts_body(L: int, Mr: int, a_start: bool, empty_ok: bool,
                       chars, lengths, r):
    """(has, start): leftmost match start per row — a match STARTS at
    q iff the reversed pattern's search automaton accepts the suffix
    composition [q, len); one reverse scan answers every start. Shared
    by the per-segment spans path and the batched extraction."""
    j = _arange(L, chars.device)
    b = _byte_index(chars)
    inside = j < lengths[:, None]
    ids_r = torch.where(inside, r.gen_of_byte[b], 0)
    suf = _rev_scan(ids_r, r.comp, Mr)
    valid = inside & r.acc_at0[suf]
    if empty_ok:
        valid = valid | (j <= lengths[:, None])
    if a_start:
        valid = valid & (j == 0)
    return valid.any(dim=1), _first_true(valid)


def _spans_monoid_plain(L: int, Mr: int, Mw: int, a_start: bool, lazy: bool, empty_ok: bool,
                        chars, lengths, r, w):
    """_match_spans, monoid form, no $ anchor (the end for the chosen
    start comes from one forward prefix scan whose reset element at
    ``start`` absorbs everything before it)."""
    j = _arange(L, chars.device)
    b = _byte_index(chars)
    lenc = lengths[:, None]
    has, start = _match_starts_body(L, Mr, a_start, empty_ok, chars, lengths, r)
    sc = start[:, None]
    ids_f = torch.where(
        (j == sc) & (j < lenc), w.reset_of_byte[b],
        torch.where((j > sc) & (j < lenc), w.gen_of_byte[b], 0),
    )
    pref = _fwd_scan(ids_f, w.comp, Mw)
    accp = (j >= sc) & (j < lenc) & w.acc_at0[pref]
    if lazy:
        # Java's lazy tail stops at the FIRST accepting end; an empty
        # match at the start wins outright (serial ends0 discipline)
        big = L + 2
        endn = torch.where(accp, j + 1, big).amin(dim=1)
        end = start if empty_ok else torch.where(endn < big, endn, start)
    else:
        endn = torch.where(accp, j + 1, -1).amax(dim=1)
        end = torch.where(endn >= 0, endn, start)
    end = end.to(_I32)
    return has, torch.where(has, start, 0), torch.where(has, end, 0)


def _spans_aend_body(L: int, Mr: int, C_r: int, a_start: bool, empty_ok: bool,
                     chars, lengths, r):
    """_match_spans, monoid form, $-anchored. The reversed ANCHORED
    automaton's suffix compositions are computed once over the pre-
    terminator prefix; evaluating each at the terminator pre-states
    answers "full match to len / to len-term / to len-1" for every
    start. Shared by the spans path and the batched extraction."""
    j = _arange(L, chars.device)
    b = _byte_index(chars)
    term = _terminator_len(chars, lengths)
    main_len = lengths - term
    ml = main_len[:, None]
    lenc = lengths[:, None]
    tc = term[:, None]
    ids = torch.where(j < ml, r.gen_of_byte[b], 0)
    suf = _rev_scan(ids, r.comp, Mr)
    # reversed-run pre-states over the terminator (consumed first)
    c1 = _take(b, (lengths - 1).clamp(0, max(L - 1, 0)))
    c2 = _take(b, (lengths - 2).clamp(0, max(L - 1, 0)))
    u1 = r.trans_flat[r.cls_of_byte[c1]]  # after consuming char len-1 from q0
    u2 = r.trans_flat[torch.add(r.cls_of_byte[c2], u1, alpha=C_r)]  # then char len-2
    termstate = torch.where(term == 0, 0, torch.where(term == 1, u1, u2)).to(_I32)
    t1 = r.trans_flat[r.cls_of_byte[c2]]  # char len-2 only (the r = len-1 endpoint)
    # A: s[q..len) matches; C: s[q..len-term) matches; A1: to len-1
    in_main = j <= ml
    A_main = r.acc[r.elems[suf, termstate[:, None]]] & in_main
    A_full = torch.where(
        in_main, A_main,
        torch.where((j == lenc - 1) & (tc == 2), r.acc[u1][:, None], (j == lenc) & empty_ok),
    )
    C_ = r.acc_at0[suf] & in_main
    A1 = r.acc[r.elems[suf, t1[:, None]]] & (tc == 2) & in_main
    B = A_main | A1  # some accepting end in (len-term, len]
    valid = A_full | ((tc > 0) & in_main & C_ & ~B)
    if a_start:
        valid = valid & (j == 0)
    has = valid.any(dim=1)
    start = _first_true(valid)
    end = torch.where(_take(A_full, start), lengths, main_len).to(_I32)
    return has, torch.where(has, start, 0), torch.where(has, end, 0)


def _spans_monoid(mono: _ExtractMonoid, chars, lengths):
    L = chars.shape[1]
    r = mono.r.on(chars.device)
    if mono.a_end:
        return _spans_aend_body(L, mono.r.M, mono.C_r, mono.a_start, mono.empty_ok,
                                chars, lengths, r)
    return _spans_monoid_plain(L, mono.r.M, mono.w.M, mono.a_start, mono.lazy_end,
                               mono.empty_ok, chars, lengths, r, mono.w.on(chars.device))


def _run_from_body(L: int, M: int, acc0: bool, chars, lo, hi, t):
    """Monoid ``_run_from``: the per-row single-start anchored run is a
    forward prefix scan whose RESET element at ``lo`` absorbs the
    composition before the start. bool [n, L+1]: ``acc_at[:, k]`` =
    the run from ``lo`` accepts after consuming chars [lo, k)."""
    n = chars.shape[0]
    j = _arange(L, chars.device)
    b = _byte_index(chars)
    loc = lo[:, None]
    hic = hi[:, None]
    ids = torch.where(
        (j == loc) & (j < hic), t.reset_of_byte[b],
        torch.where((j > loc) & (j < hic), t.gen_of_byte[b], 0),
    )
    pref = _fwd_scan(ids, t.comp, M)
    accp = (j >= loc) & (j < hic) & t.acc_at0[pref]
    acc_at = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=chars.device), accp], 1)
    if acc0:  # empty prefix accepts at k == lo
        acc_at = acc_at | (_arange(L + 1, chars.device) == loc)
    return acc_at


def _run_from_mono(dm: _DeviceMonoid, L: int, chars, lo, hi):
    return _run_from_body(L, dm.M, dm.acc0, chars, lo, hi, dm.on(chars.device))


def _feasible_from_monoid(gm: _GatedDeviceMonoid, L: int, chars, end, b_next):
    """Monoid ``_feasible_from``: the gated-restart automaton of the
    REVERSED segment injects a fresh run exactly where the tail fits
    (gate = b_next[r]); one suffix composition per position then
    answers "segment matches [q, r) for some gated r <= end"."""
    n = chars.shape[0]
    t = gm.on(chars.device)
    j = _arange(L, chars.device)
    b = _byte_index(chars)
    gate = b_next[:, 1:].to(_I32)  # gate of element j = b_next[j+1]
    ids = torch.where(j < end[:, None], t.gen_of_byte_gate[b, gate], 0)
    suf = _rev_scan(ids, t.comp, gm.M)
    out = torch.cat([t.acc_at0[suf], torch.zeros((n, 1), dtype=torch.bool, device=chars.device)], 1)
    if gm.nullable:  # empty span [q, q): tail must fit right here
        out = out | (b_next & (_arange(L + 1, chars.device) <= end[:, None]))
    return out


def _select_boundary(ok, k_idx, p, lazy: bool, L: int):
    """Next boundary of the sweep: the last feasible end (the first one
    for a lazy segment), or ``p`` with the row marked infeasible."""
    if lazy:
        big = L + 2
        q = torch.where(ok, k_idx, big).amin(dim=1)
        row_ok = q < big
    else:
        q = torch.where(ok, k_idx, -1).amax(dim=1)
        row_ok = q >= 0
    return torch.where(row_ok, q, p).to(_I32), row_ok


def _extract_batched(mono: _ExtractMonoid, segs, idx: int, chars, lengths):
    """The whole monoid extraction as one chain (the JAX package's
    ``_extract_batched_kernel``): match starts, the stacked
    tail-feasibility scan (each reversed TAIL gated on plain end
    validity, so the P-1 chained scans and the accepting-end run
    disappear), and the P-step boundary sweep. Bit-identical to the
    per-segment path."""
    n, L = chars.shape
    dev = chars.device
    P = len(segs)
    lenc = lengths[:, None]
    k_idx = _arange(L + 1, dev)
    r = mono.r.on(dev)
    if mono.a_end:
        has, start, _end = _spans_aend_body(L, mono.r.M, mono.C_r, mono.a_start,
                                            mono.empty_ok, chars, lengths, r)
        term = _terminator_len(chars, lengths)
        endok = (k_idx <= lenc) & (
            (k_idx == lenc) | ((term[:, None] > 0) & (k_idx == (lengths - term)[:, None]))
        )
    else:
        has, start = _match_starts_body(L, mono.r.M, mono.a_start, mono.empty_ok,
                                        chars, lengths, r)
        endok = k_idx <= lenc

    ts = mono.tails
    feas = None
    if ts.K:
        tt = ts.on(dev)
        j = _arange(L, dev)
        b = _byte_index(chars)
        gate = endok[:, 1:].to(_I32)  # gate of rev element j = endok[j+1]
        ids = torch.where((j < lenc)[None], tt.genbg[:, b, gate], 0)
        suf = associative_scan(
            stacked_monoid_combine(tt.comp_flat, tt.base, tt.mk), ids, axis=2, rev=True
        )
        acc_t = tt.acc_flat[tt.ebase + suf]  # [K, n, L]
        feas = torch.cat([acc_t, torch.zeros((ts.K, n, 1), dtype=torch.bool, device=dev)], 2)
        # a nullable tail (every remaining segment nullable) matches
        # the empty span [q, q) wherever q itself is a valid end
        feas = feas | (tt.null_arr[:, None, None] & endok[None])

    p = start
    g_start = torch.zeros(n, dtype=_I32, device=dev)
    g_end = torch.zeros(n, dtype=_I32, device=dev)
    feasible = torch.ones(n, dtype=torch.bool, device=dev)
    for i, (node, gno) in enumerate(segs):
        dm = mono.segs[i][0]
        tail = feas[i] if i + 1 < P else endok
        acc_at = _run_from_body(L, dm.M, dm.acc0, chars, p, lengths, dm.on(dev))
        ok = acc_at & tail & (k_idx >= p[:, None]) & (k_idx <= lenc)
        q, row_ok = _select_boundary(ok, k_idx, p, _segment_lazy(node), L)
        feasible = feasible & row_ok
        if gno is not None and gno == idx:
            g_start, g_end = p, q
        p = q
    if idx == 0:
        g_start, g_end = start, p
    grp_has = has & feasible
    return (
        grp_has,
        torch.where(grp_has, g_start, 0).to(_I32),
        torch.where(grp_has, g_end, 0).to(_I32),
    )


# ---------------------------------------------------------------------------
# regexp_extract: serial form
# ---------------------------------------------------------------------------


def _match_spans(pattern: str, chars, lengths):
    """Leftmost match span per row: (has_match, start, end). The end
    is the LONGEST from the chosen start — except when the pattern's
    trailing quantifier is lazy (``a(b+?)``, ``<(.+?)>``), where Java
    stops at the SHORTEST accepting end.

    Serial form: runs the anchored DFA from every start position at
    once ([n, L] state matrix, one step per character)."""
    ser = _compiled(pattern, "anchored")
    ast, _as, _ae, _ng = parse(pattern)
    # under a $ anchor a lazy tail must still expand to reach the end,
    # so longest-end selection stays correct there
    lazy_end = _segment_lazy(ast) and not ser.a_end
    n, L = chars.shape
    dev = chars.device
    t = ser.on(dev)
    cls = t.cls[_byte_index(chars)]
    s_idx = _arange(L, dev)
    lenc = lengths[:, None]
    states = torch.zeros((n, L), dtype=_I32, device=dev)
    # empty match at start s (s <= length) when the start state accepts
    if bool(ser.acc[0]):
        ends = torch.where(s_idx <= lenc, s_idx, -1)
    else:
        ends = torch.full((n, L), -1, dtype=_I32, device=dev)
    for j in range(L):
        consume = (s_idx <= j) & (j < lenc)
        ns = t.trans[torch.add(cls[:, j : j + 1], states, alpha=ser.C)]
        states = torch.where(consume, ns, states)
        hit = consume & t.acc[states]
        if lazy_end:
            hit = hit & (ends < 0)
        ends = torch.where(hit, j + 1, ends)
    if ser.a_end:
        # Java's $ also matches before a final line terminator
        term = _terminator_len(chars, lengths)[:, None]
        at_end = (ends == lenc) | ((term > 0) & (ends == lenc - term))
        ends = torch.where(at_end, ends, -1)
    if ser.a_start:
        ends = torch.where(s_idx == 0, ends, -1)
    valid = ends >= 0
    has = valid.any(dim=1)
    start = _first_true(valid)
    end = _take(ends, start)
    return has, torch.where(has, start, 0), torch.where(has, end, 0)


def _run_from(ser: _Serial, cls, lo, hi):
    """Anchored single-start run per row: consume chars [lo, hi) starting
    the DFA at position ``lo`` (per row), recording a bool [n, L+1]
    matrix ``acc_at[:, k]`` = DFA accepts after consuming chars [lo, k).
    (hi never exceeds the row length — callers pass match spans.)"""
    n, L = cls.shape
    dev = cls.device
    t = ser.on(dev)
    # k == lo: the empty prefix
    init = (_arange(L + 1, dev) == lo[:, None]) & bool(ser.acc[0])
    j = _arange(L, dev)
    active = (j >= lo[:, None]) & (j < hi[:, None])
    state = torch.zeros(n, dtype=_I32, device=dev)
    cols = [init[:, 0]]
    for k in range(L):
        ns = t.trans[torch.add(cls[:, k], state, alpha=ser.C)]
        state = torch.where(active[:, k], ns, state)
        cols.append(init[:, k + 1] | (active[:, k] & t.acc[state]))
    return torch.stack(cols, dim=1)


def _split_segments(ast: Node):
    """Decompose a top-level concatenation into alternating segments
    ``[(node, group_no | None), ...]``: each top-level (group) is its
    own segment, consecutive non-group parts merge. Raises when any
    capture group is NESTED (group numbering would diverge from
    Java's) or sits under a top-level alternation."""
    parts = ast.parts if isinstance(ast, Concat) else [ast]

    def has_group(n: Node) -> bool:
        if isinstance(n, Group):
            return True
        kids = (
            n.parts if isinstance(n, Concat)
            else n.options if hasattr(n, "options")
            else [n.node] if hasattr(n, "node")
            else []
        )
        return any(has_group(k) for k in kids)

    segs = []
    buf: list = []
    gno = 0

    def flush():
        if buf:
            segs.append((buf[0] if len(buf) == 1 else Concat(list(buf)), None))
            buf.clear()

    for p in parts:
        if isinstance(p, Group):
            if has_group(p.node):
                raise RegexUnsupported("nested capture groups unsupported in regexp_extract")
            flush()
            gno += 1
            segs.append((p.node, gno))
        else:
            if has_group(p):
                raise RegexUnsupported(
                    "capture group under a quantifier/alternation is "
                    "unsupported in regexp_extract"
                )
            buf.append(p)
    flush()
    if not segs:
        segs.append((Empty(), None))
    return segs


def _segment_lazy(node: Node) -> bool:
    """A segment takes the SHORTEST feasible span when its trailing
    quantifier is lazy (X*? / X+? / X??); greedy (longest) otherwise —
    Java's quantifier-local preference applied at segment granularity.
    Groups are transparent (``a(b+?)`` ends lazily)."""
    if isinstance(node, Group):
        return _segment_lazy(node.node)
    if isinstance(node, Repeat):
        return node.lazy
    if isinstance(node, Concat) and node.parts:
        return _segment_lazy(node.parts[-1])
    return False


def _feasible_from(ser: _Serial, cls, end, b_next):
    """bool [n, L+1]: positions q where this segment can match [q, r)
    for some r with ``b_next[:, r]`` true and r <= end. One step per
    character with an [n, L] all-starts state matrix (column q = state
    of the run started at q)."""
    n, L = cls.shape
    dev = cls.device
    t = ser.on(dev)
    s_idx = _arange(L, dev)
    endc = end[:, None]
    out = torch.zeros((n, L + 1), dtype=torch.bool, device=dev)
    if bool(ser.acc[0]):  # empty span [q, q)
        out = out | (b_next & (_arange(L + 1, dev) <= endc))
    states = torch.zeros((n, L), dtype=_I32, device=dev)
    hits = torch.zeros((n, L), dtype=torch.bool, device=dev)
    for j in range(L):
        consume = (s_idx <= j) & (j < endc)
        ns = t.trans[torch.add(cls[:, j : j + 1], states, alpha=ser.C)]
        states = torch.where(consume, ns, states)
        # run from q accepts at r = j+1 and the tail fits from r
        hits = hits | (consume & t.acc[states] & b_next[:, j + 1 : j + 2])
    return out | torch.cat([hits, torch.zeros((n, 1), dtype=torch.bool, device=dev)], 1)


def regexp_extract(col: Column, pattern: str, idx: int = 1, width=None) -> Column:
    """Spark regexp_extract(str, pattern, idx). Returns '' for rows
    with no match (Spark semantics); null rows stay null. ``width``
    pins the char matrix. Runs on the device of ``col``.

    Group support: idx 0 (whole match) or any TOP-LEVEL capture group
    (pattern decomposes as seg0 (g1) seg1 (g2) ... at the top of the
    concatenation; nested groups and groups under quantifiers or
    alternations are unsupported — idx 0 then falls back to the plain
    span). Boundary selection sweeps segments left to right: each
    takes its longest feasible span (shortest when its quantifier is
    lazy) such that all remaining segments can still complete a match,
    with feasibility precomputed right to left."""
    if idx < 0 or idx > 9:
        raise RegexUnsupported("regexp_extract supports groups 0..9")
    chars, lengths = to_char_matrix(col, width)
    n, L = chars.shape
    dev = chars.device
    strat = scan_strategy()
    mono = None
    if strat != "serial":
        mono = _extract_monoid(pattern, None if strat == "monoid" else monoid_max_states())
    ast, _a_s, a_end_anch, ngroups = parse(pattern)
    if idx > 0 and ngroups < idx:
        raise RegexUnsupported(f"pattern has {ngroups} capture groups, asked for {idx}")
    try:
        segs = _split_segments(ast)
        n_top_groups = sum(1 for _node, g in segs if g is not None)
        if n_top_groups != ngroups:
            raise RegexUnsupported("nested capture groups unsupported in regexp_extract")
    except RegexUnsupported:
        if idx > 0:
            raise
        segs = None  # group 0 on a non-decomposable pattern: plain span

    batched = mono is not None and segs is not None and mono.tails is not None and scan_batching()
    if batched:
        # the whole extraction as one chain (stacked tail feasibility,
        # no accepting-end run, in-chain sweep) — bit-identical to the
        # per-segment path below, which remains the fallback and the
        # forced-unbatched arm (SPARK_JNI_TPU_SCAN_BATCH=off)
        _record_strategy("monoid_batched", mono.w.S)
        has, g_start, g_end = _extract_batched(mono, segs, idx, chars, lengths)
    else:
        if mono is not None:
            _record_strategy("monoid", mono.w.S)
            has, start, end = _spans_monoid(mono, chars, lengths)
        else:
            _record_strategy("serial")
            has, start, end = _match_spans(pattern, chars, lengths)
        if segs is None:
            g_start, g_end = start, end
    if segs is not None and not batched:
        k_idx = _arange(L + 1, dev)
        lenc = lengths[:, None]
        if mono is None:
            sers = [_Serial(compile_ast(node, "anchored")) for node, _g in segs]
            clss = [s.on(dev).cls[_byte_index(chars)] for s in sers]
        # accepting-end SET of the whole pattern from the chosen start:
        # the sweep picks the end Java's engine would among these
        if mono is not None:
            E = _run_from_mono(mono.w, L, chars, start, lengths)
        else:
            whole = _compiled(pattern, "anchored")
            E = _run_from(whole, whole.on(dev).cls[_byte_index(chars)], start, lengths)
        E = E & (k_idx <= lenc)
        if a_end_anch:
            term = _terminator_len(chars, lengths)
            at_end = (k_idx == lenc) | ((term[:, None] > 0) & (k_idx == (lengths - term)[:, None]))
            E = E & at_end

        # right-to-left feasibility: feas[i][:, q] = segments i..m can
        # match [q, e) for some accepting end e
        feas_next = E
        feas = [None] * len(segs)
        for i in range(len(segs) - 1, -1, -1):
            if mono is not None:
                feas[i] = _feasible_from_monoid(mono.segs[i][1], L, chars, lengths, feas_next)
            else:
                feas[i] = _feasible_from(sers[i], clss[i], lengths, feas_next)
            feas_next = feas[i]

        # left-to-right sweep: p tracks the current boundary; record
        # the span of the requested group as it is crossed
        p = start
        g_start = torch.zeros(n, dtype=_I32, device=dev)
        g_end = torch.zeros(n, dtype=_I32, device=dev)
        feasible = torch.ones(n, dtype=torch.bool, device=dev)
        for i, (node, gno) in enumerate(segs):
            tail = feas[i + 1] if i + 1 < len(segs) else E
            if mono is not None:
                acc_at = _run_from_mono(mono.segs[i][0], L, chars, p, lengths)
            else:
                acc_at = _run_from(sers[i], clss[i], p, lengths)
            ok = acc_at & tail & (k_idx >= p[:, None]) & (k_idx <= lenc)
            q, row_ok = _select_boundary(ok, k_idx, p, _segment_lazy(node), L)
            feasible = feasible & row_ok
            if gno == idx:
                g_start, g_end = p, q
            p = q
        if idx == 0:
            g_start, g_end = start, p
        grp_has = has & feasible
        g_start = torch.where(grp_has, g_start, 0).to(_I32)
        g_end = torch.where(grp_has, g_end, 0).to(_I32)
        has = grp_has

    out_len = torch.where(has, g_end - g_start, 0).to(_I32)
    arange = _arange(L, dev)
    idxs = g_start[:, None] + arange
    mask = arange < out_len[:, None]
    safe = idxs.clamp(0, max(L - 1, 0))
    out_chars = torch.where(mask, chars.gather(1, safe.long()), -1)
    return from_char_matrix(out_chars, out_len, col.validity)
