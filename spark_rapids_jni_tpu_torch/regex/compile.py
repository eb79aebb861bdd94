"""Host-side regex -> DFA compiler for the Spark rlike/regexp_extract
subset (the port's own copy of the JAX package's numpy-only
``regex/compile.py``, kept line for line so every table is the same,
two comments aside: the port imports nothing of the JAX package).

The reference stack leans on cudf's strings regex engine (a
thread-per-row backtracking VM) for the plugin's rlike/regexp_extract
(north-star op list, BASELINE.md). A per-row VM is the wrong shape for
a lane-oriented VPU, so this engine compiles the pattern ON HOST to
either

  - a bit-parallel Glushkov NFA (`compile_nfa`) when the pattern has
    <= 63 positions: the device walk is pure shift/mask algebra whose
    follow-set unions are baked-in constants (ops/regex.py
    `_rlike_nfa_kernel`), zero gathers in the dependency chain; or
  - a byte-class DFA (`compile_regex`) executed as one table gather
    per character per row — the fallback for huge patterns and the
    engine behind regexp_extract's all-starts scans.

Pipeline: parse -> AST -> bounded-repeat expansion -> Glushkov position
automaton (epsilon-free) -> bit-parallel masks, or subset-construction
DFA over byte equivalence classes.

Supported syntax (documented contract, tested vs Python `re`):
  literals, '.', escapes \\d \\D \\w \\W \\s \\S \\n \\t \\r and
  escaped punctuation, character classes [...] with ranges and
  negation, grouping (...), alternation '|', quantifiers * + ? {m}
  {m,} {m,n} (n <= 32) with lazy variants *? +? ?? honoured in
  regexp_extract span selection, anchors ^ at pattern start / $ at
  pattern end.
Unsupported (raises RegexUnsupported): backreferences, lookaround,
inline flags, named groups, inner anchors, word boundaries.
"""

from __future__ import annotations

import dataclasses
import hashlib
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

MAX_REPEAT = 32
PAD_BYTE = 256  # class index slot for past-end sentinel


class RegexUnsupported(ValueError):
    pass


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Node:
    pass


@dataclasses.dataclass
class Chars(Node):
    """A single input byte drawn from `mask` (bool per byte 0..255)."""

    mask: bytearray


@dataclasses.dataclass
class Concat(Node):
    parts: List[Node]


@dataclasses.dataclass
class Alt(Node):
    options: List[Node]


@dataclasses.dataclass
class Repeat(Node):
    node: Node
    lo: int
    hi: Optional[int]  # None = unbounded
    # lazy (X*? / X+? / X??) changes which match a backtracking engine
    # PICKS, not the language — the DFA is identical; extraction reads
    # this flag to take the shortest span instead of the longest
    # (ops/regex.py segment sweep)
    lazy: bool = False


@dataclasses.dataclass
class Group(Node):
    node: Node
    index: int


@dataclasses.dataclass
class Empty(Node):
    pass


def _mask_all() -> bytearray:
    m = bytearray(256)
    for i in range(256):
        if i != 0x0A:  # '.' does not match newline (Java default)
            m[i] = 1
    return m


def _mask_of(chars) -> bytearray:
    m = bytearray(256)
    for c in chars:
        m[c] = 1
    return m


_DIGITS = _mask_of(range(0x30, 0x3A))
_WORD = _mask_of(
    list(range(0x30, 0x3A))
    + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B))
    + [0x5F]
)
_SPACE = _mask_of([0x20, 0x09, 0x0A, 0x0B, 0x0C, 0x0D])


def _negate(m: bytearray) -> bytearray:
    return bytearray(0 if x else 1 for x in m)


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.group_count = 0

    def error(self, msg):
        raise RegexUnsupported(f"{msg} at position {self.i} in {self.p!r}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    # alt := concat ('|' concat)*
    def parse_alt(self) -> Node:
        opts = [self.parse_concat()]
        while self.peek() == "|":
            self.next()
            opts.append(self.parse_concat())
        return opts[0] if len(opts) == 1 else Alt(opts)

    def parse_concat(self) -> Node:
        parts: List[Node] = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self.parse_repeat())
        if not parts:
            return Empty()
        return parts[0] if len(parts) == 1 else Concat(parts)

    def parse_repeat(self) -> Node:
        atom = self.parse_atom()
        c = self.peek()
        if c == "*":
            self.next()
            atom = Repeat(atom, 0, None)
        elif c == "+":
            self.next()
            atom = Repeat(atom, 1, None)
        elif c == "?":
            self.next()
            atom = Repeat(atom, 0, 1)
        elif c == "{":
            save = self.i
            rep = self._try_braces()
            if rep is None:
                self.i = save
                return atom
            atom = Repeat(atom, rep[0], rep[1])
        else:
            return atom
        if self.peek() == "?":
            # lazy quantifier: same language, shortest-match selection
            # (honoured by regexp_extract's segment sweep)
            self.next()
            assert isinstance(atom, Repeat)
            atom = Repeat(atom.node, atom.lo, atom.hi, lazy=True)
        if self.peek() in ("?", "+", "*", "{"):
            # X*+ (possessive), X** — reject rather than mis-match
            self.error("possessive/double quantifiers unsupported")
        return atom

    def _try_braces(self) -> Optional[Tuple[int, Optional[int]]]:
        self.next()  # '{'
        digits = ""
        while self.peek() and self.peek().isdigit():
            digits += self.next()
        if not digits:
            return None
        lo = int(digits)
        hi: Optional[int] = lo
        if self.peek() == ",":
            self.next()
            digits2 = ""
            while self.peek() and self.peek().isdigit():
                digits2 += self.next()
            hi = int(digits2) if digits2 else None
        if self.peek() != "}":
            return None
        self.next()
        if hi is not None and (hi < lo or hi > MAX_REPEAT):
            self.error(f"repeat bound > {MAX_REPEAT} or invalid")
        if lo > MAX_REPEAT:
            self.error(f"repeat bound > {MAX_REPEAT}")
        return (lo, hi)

    def parse_atom(self) -> Node:
        c = self.peek()
        if c is None:
            return Empty()
        if c == "(":
            self.next()
            if self.peek() == "?":
                self.error("(?...) constructs unsupported")
            self.group_count += 1
            idx = self.group_count
            inner = self.parse_alt()
            if self.peek() != ")":
                self.error("unbalanced parenthesis")
            self.next()
            return Group(inner, idx)
        if c == "[":
            return self.parse_class()
        if c == ".":
            self.next()
            return Chars(_mask_all())
        if c == "\\":
            return Chars(self.parse_escape())
        if c in "^$":
            self.error("inner anchors unsupported (only leading ^/trailing $)")
        if c in "*+?{":
            self.error(f"dangling quantifier {c!r}")
        self.next()
        if ord(c) > 127:
            # subjects are UTF-8 bytes: a non-ASCII literal is its UTF-8
            # byte sequence (exact match; quantifying it repeats the
            # whole sequence since it parses as one atom)
            return Concat([Chars(_mask_of([b])) for b in c.encode("utf-8")])
        return Chars(_mask_of([ord(c)]))

    def parse_escape(self) -> bytearray:
        self.next()  # backslash
        c = self.peek()
        if c is None:
            self.error("trailing backslash")
        self.next()
        simple = {
            "d": _DIGITS,
            "D": _negate(_DIGITS),
            "w": _WORD,
            "W": _negate(_WORD),
            "s": _SPACE,
            "S": _negate(_SPACE),
            "n": _mask_of([0x0A]),
            "t": _mask_of([0x09]),
            "r": _mask_of([0x0D]),
        }
        if c in simple:
            return bytearray(simple[c])
        if c.isalnum() or ord(c) > 127:
            self.error(f"unsupported escape \\{c}")
        return _mask_of([ord(c)])

    def parse_class(self) -> Node:
        self.next()  # '['
        negate = False
        if self.peek() == "^":
            negate = True
            self.next()
        mask = bytearray(256)
        first = True
        while True:
            c = self.peek()
            if c is None:
                self.error("unterminated character class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            if c == "\\":
                sub = self.parse_escape()
                for i in range(256):
                    mask[i] |= sub[i]
                continue
            self.next()
            if ord(c) > 127:
                self.error(
                    "non-ASCII characters in [...] classes unsupported "
                    "(UTF-8 byte matching is ambiguous in a byte class)"
                )
            lo = ord(c)
            if self.peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.next()
                hi_c = self.next()
                if hi_c == "\\":
                    self.error("escape as range endpoint unsupported")
                for b in range(lo, ord(hi_c) + 1):
                    mask[b] = 1
            else:
                mask[lo] = 1
        if negate:
            mask = _negate(mask)
        return Chars(mask)


def parse(pattern: str):
    """Parse `pattern` -> (AST, anchored_start, anchored_end, n_groups)."""
    anchored_start = pattern.startswith("^")
    if anchored_start:
        pattern = pattern[1:]
    anchored_end = pattern.endswith("$") and not pattern.endswith("\\$")
    if anchored_end:
        pattern = pattern[:-1]
    p = _Parser(pattern)
    ast = p.parse_alt()
    if p.i != len(p.p):
        p.error("unbalanced parenthesis")
    if (anchored_start or anchored_end) and isinstance(ast, Alt):
        # '^a|b' anchors only the FIRST alternative in Java/PCRE; a
        # stripped anchor would silently scope over the whole
        # alternation — reject instead of mis-matching
        raise RegexUnsupported(
            "^/$ with top-level alternation is unsupported; group the "
            "alternation: ^(a|b)$"
        )
    return ast, anchored_start, anchored_end, p.group_count


# ---------------------------------------------------------------------------
# Glushkov position automaton
# ---------------------------------------------------------------------------


def _expand(node: Node) -> Node:
    """Rewrite bounded repeats into concatenations so the automaton is
    pure Kleene (a{2,4} -> a a a? a?; a{2,} -> a a a*)."""
    if isinstance(node, Chars) or isinstance(node, Empty):
        return node
    if isinstance(node, Group):
        return Group(_expand(node.node), node.index)
    if isinstance(node, Concat):
        return Concat([_expand(x) for x in node.parts])
    if isinstance(node, Alt):
        return Alt([_expand(x) for x in node.options])
    if isinstance(node, Repeat):
        inner = _expand(node.node)
        if node.lo == 0 and node.hi is None:
            return Repeat(inner, 0, None, node.lazy)  # star
        if node.lo == 1 and node.hi is None:
            return Concat([inner, Repeat(_clone(inner), 0, None, node.lazy)])
        parts: List[Node] = [_clone(inner) for _ in range(node.lo)]
        if node.hi is None:
            parts.append(Repeat(_clone(inner), 0, None, node.lazy))
        else:
            for _ in range(node.hi - node.lo):
                parts.append(Repeat(_clone(inner), 0, 1, node.lazy))
        if not parts:
            return Empty()
        return parts[0] if len(parts) == 1 else Concat(parts)
    raise AssertionError(node)


def _clone(node: Node) -> Node:
    if isinstance(node, Chars):
        return Chars(bytearray(node.mask))
    if isinstance(node, Empty):
        return Empty()
    if isinstance(node, Group):
        return Group(_clone(node.node), node.index)
    if isinstance(node, Concat):
        return Concat([_clone(x) for x in node.parts])
    if isinstance(node, Alt):
        return Alt([_clone(x) for x in node.options])
    if isinstance(node, Repeat):
        return Repeat(_clone(node.node), node.lo, node.hi, node.lazy)
    raise AssertionError(node)


class _Glushkov:
    """Linearize char leaves into positions; compute nullable/first/
    last/follow sets (standard Glushkov construction)."""

    def __init__(self):
        self.masks: List[bytearray] = []  # per position
        self.follow: List[set] = []

    def add_pos(self, mask: bytearray) -> int:
        self.masks.append(mask)
        self.follow.append(set())
        return len(self.masks) - 1

    def build(self, node: Node):
        if isinstance(node, Empty):
            return True, set(), set()
        if isinstance(node, Chars):
            p = self.add_pos(node.mask)
            return False, {p}, {p}
        if isinstance(node, Group):
            return self.build(node.node)
        if isinstance(node, Alt):
            nullable, first, last = False, set(), set()
            for opt in node.options:
                n, f, l = self.build(opt)
                nullable |= n
                first |= f
                last |= l
            return nullable, first, last
        if isinstance(node, Concat):
            nullable, first, last = True, set(), set()
            for part in node.parts:
                n, f, l = self.build(part)
                for p in last:
                    self.follow[p] |= f
                if nullable:
                    first |= f
                if n:
                    last |= l
                else:
                    last = l
                nullable &= n
            return nullable, first, last
        if isinstance(node, Repeat):  # only {0,None} / {0,1} post-expand
            n, f, l = self.build(node.node)
            if node.hi is None:  # star: last loops to first
                for p in l:
                    self.follow[p] |= f
            return True, f, l
        raise AssertionError(node)


def _byte_classes(masks: List[bytearray]):
    """Partition bytes 0..255 into equivalence classes by position-mask
    signature; returns (class_of_byte int[257], n_classes). Index 256 is
    the reserved PAD class (matches nothing)."""
    sig_to_class = {}
    class_of = [0] * 257
    # class 0 = PAD (and any byte matching no position may share it)
    sig_to_class[tuple()] = 0
    n = 1
    for b in range(256):
        sig = tuple(i for i, m in enumerate(masks) if m[b])
        if sig not in sig_to_class:
            sig_to_class[sig] = n
            n += 1
        class_of[b] = sig_to_class[sig]
    class_of[256] = 0
    # byte -> positions map per class
    class_positions = [()] * n
    for sig, c in sig_to_class.items():
        class_positions[c] = sig
    return class_of, class_positions, n


@dataclasses.dataclass
class DFA:
    """Dense DFA for the device scan. ``transition[state][cls]`` gives
    the next state; state 0 is the start. ``class_of`` maps a byte value
    (plus the past-end sentinel at index 256) to its equivalence class;
    the sentinel class matches no position, so consuming it from any
    state kills all in-flight matches (the device scan additionally
    masks on row length, so it is never consumed in practice)."""

    transition: list  # [n_states][n_classes] int
    accepting: list  # [n_states] bool
    class_of: list  # [257] int
    n_classes: int

    @property
    def n_states(self) -> int:
        return len(self.transition)

    @property
    def transition_vectors(self) -> "np.ndarray":
        """``[C, S]`` per-byte-class transition *vectors*: row ``c`` is
        the whole S->S map a character of class ``c`` applies — the
        generator set of the transition monoid (``compile_monoid``),
        and the lift table of the vector-form device scan."""
        return (
            np.asarray(self.transition, np.int32)
            .reshape(self.n_states, self.n_classes)
            .T.copy()
        )

    def monoid_ok(self, max_states: int = 64) -> bool:
        """Whether the log-depth transition-monoid execution strategy
        is worth attempting for this DFA: the state count must be small
        enough that host enumeration of the monoid (capped at
        ``_MAX_MONOID_ELEMS``) has a chance, and the per-compose work
        stays bounded. ``max_states`` is the crossover the JAX package
        measured (its benchmarks/regex_scan.py)."""
        return self.n_states <= max_states

    def fingerprint(self) -> str:
        """Stable content hash of the compiled automaton — the plan
        cache key component for pipeline regex entries (two pattern
        strings compiling to the same DFA share lowered programs)."""
        h = hashlib.sha256()
        h.update(np.asarray(self.transition, np.int32).tobytes())
        h.update(np.asarray(self.accepting, np.bool_).tobytes())
        h.update(np.asarray(self.class_of, np.int32).tobytes())
        return h.hexdigest()[:16]


_MAX_DFA_STATES = 4096
_START = -1  # sentinel "position": nothing matched yet (Glushkov q0)


def compile_ast(ast: Node, mode: str) -> DFA:
    """Glushkov position automaton -> subset-construction DFA.

    NFA shape: states are {q0} + pattern positions. q0 --b--> p for
    p in first(pattern) with b in chars(p); p --b--> q for q in
    follow(p) with b in chars(q). Accepting: positions in last(), and
    q0 itself when the pattern is nullable.

    mode 'search' simulates '.*pattern': the q0 restart edges stay
    available from every state, so the DFA accepts whenever ANY
    substring ending at the current byte matches (sticky-accept on the
    device gives rlike). mode 'anchored' accepts exactly when the full
    consumed prefix matches the pattern.
    """
    search = mode == "search"
    if mode not in ("search", "anchored"):
        raise ValueError(mode)
    ast = _expand(ast)
    g = _Glushkov()
    nullable, first, last = g.build(ast)
    class_of, class_positions, n_classes = _byte_classes(g.masks)
    pos_in_class = [frozenset(s) for s in class_positions]

    start = frozenset({_START})
    states = {start: 0}
    order = [start]
    transition: List[List[int]] = []
    accepting: List[bool] = []

    def accepts(s: frozenset) -> bool:
        return bool(s & last) or (_START in s and nullable)

    i = 0
    while i < len(order):
        s = order[i]
        i += 1
        row: List[int] = []
        for c in range(n_classes):
            nxt = set()
            for p in s:
                if p == _START:
                    continue
                for q in g.follow[p]:
                    if q in pos_in_class[c]:
                        nxt.add(q)
            if search or _START in s:
                # restart edges from q0 (always live in search mode)
                nxt |= first & pos_in_class[c]
            if search:
                nxt.add(_START)  # '.*' keeps q0 alive forever
            key = frozenset(nxt)
            if key not in states:
                if len(order) >= _MAX_DFA_STATES:
                    raise RegexUnsupported(
                        f"DFA exceeds {_MAX_DFA_STATES} states"
                    )
                states[key] = len(order)
                order.append(key)
            row.append(states[key])
        transition.append(row)
        accepting.append(accepts(s))

    return DFA(transition, accepting, class_of, n_classes)


@dataclasses.dataclass
class NFA:
    """Glushkov position automaton in bit-parallel form: position i of
    the linearized pattern owns bit i. The device step for one char of
    byte class c is

        D' = (follow_union(D) | first_mask?) & class_masks[c]

    where follow_union ORs the (constant) follow mask of every live
    bit, first_mask is injected every step in search mode (the '.*'
    restart) or only at step 0 when anchored, and a match ends at this
    char iff D' & last_mask != 0 (plus nullable for the empty match).
    """

    follow_masks: List[int]  # [m] bitmask of follow(i)
    first_mask: int
    last_mask: int
    nullable: bool
    class_masks: List[int]  # [n_classes] bitmask of positions in class
    class_of: list  # [257] byte -> class (index 256 = past-end PAD)
    n_classes: int
    # per position: the byte set as sorted disjoint [lo, hi] intervals,
    # so the device can build B-masks with fused range compares instead
    # of a byte->class table gather (measured ~10 ns/element — 331 ms
    # at 1Mi x 32 — vs ~single-pass elementwise for the compares)
    position_intervals: List[List[Tuple[int, int]]] = dataclasses.field(
        default_factory=list
    )

    @property
    def n_positions(self) -> int:
        return len(self.follow_masks)

    @property
    def n_intervals(self) -> int:
        return sum(len(iv) for iv in self.position_intervals)


def compile_nfa(ast: Node) -> NFA:
    """Glushkov construction in bit-parallel mask form (no subset
    construction — state blowup cannot happen; the only capacity limit
    is the caller's word width)."""
    ast = _expand(ast)
    g = _Glushkov()
    nullable, first, last = g.build(ast)
    class_of, class_positions, n_classes = _byte_classes(g.masks)

    def intervals(mask: bytearray) -> List[Tuple[int, int]]:
        ivs, run = [], None
        for b in range(256):
            if mask[b]:
                run = (run[0], b) if run else (b, b)
            elif run:
                ivs.append(run)
                run = None
        if run:
            ivs.append(run)
        return ivs

    return NFA(
        follow_masks=[sum(1 << q for q in s) for s in g.follow],
        first_mask=sum(1 << p for p in first),
        last_mask=sum(1 << p for p in last),
        nullable=nullable,
        class_masks=[sum(1 << p for p in sig) for sig in class_positions],
        class_of=class_of,
        n_classes=n_classes,
        position_intervals=[intervals(m) for m in g.masks],
    )


def compile_regex(pattern: str, mode: str = "search") -> DFA:
    """Compile ``pattern`` (anchors stripped — ops/regex.py interprets
    them) to a DFA in the given mode."""
    ast, _a_start, _a_end, _ngroups = parse(pattern)
    return compile_ast(ast, mode)


# ---------------------------------------------------------------------------
# transition monoid (log-depth device execution; Ladner-Fischer over
# S->S maps — the data-parallel FSM formulation of Mytkowicz et al.,
# ASPLOS 2014)
# ---------------------------------------------------------------------------

_MAX_MONOID_ELEMS = 1024  # compose table stays cache-resident (4 MB i32)


def reverse_ast(node: Node) -> Node:
    """Structural reversal: L(reverse_ast(a)) = {reverse(w) : w in
    L(a)}. Concatenations flip; alternation/quantifiers are direction-
    free. The reversed automaton lets a device scan answer "does a
    match START here" with one suffix composition per position
    (ops/regex.py `_match_spans_monoid`)."""
    if isinstance(node, Concat):
        return Concat([reverse_ast(p) for p in reversed(node.parts)])
    if isinstance(node, Alt):
        return Alt([reverse_ast(o) for o in node.options])
    if isinstance(node, Repeat):
        return Repeat(reverse_ast(node.node), node.lo, node.hi, node.lazy)
    if isinstance(node, Group):
        return Group(reverse_ast(node.node), node.index)
    return _clone(node)


@dataclasses.dataclass
class TransitionMonoid:
    """Host-enumerated transition monoid of a DFA: every reachable
    composition of per-class S->S maps gets a dense element id, so the
    device-side composition of two elements is ONE gather from
    ``compose`` instead of an S-wide vector gather — the refinement
    that makes the log-depth scan cheaper than the serial walk even
    per unit of work (benchmarks/regex_scan.py measured the plain
    [n, S] vector form 3.6x SLOWER than the serial walk on CPU).

    Element 0 is the identity (what padded/inactive positions lift
    to). ``gen_of_class[c]`` is the single-character element of byte
    class ``c``; ``reset_of_class[c]`` (when enumerated) is the
    CONSTANT map s -> transition[0][c] — "restart at q0, then consume"
    — which absorbs any earlier composition, so one prefix scan can
    run many independent automaton instances separated by reset
    positions (regexp_extract's per-segment runs, the JSON scalar-
    token validator). ``hit0`` (when enumerated) folds "did this
    composed block pass through an accepting state, starting from
    q0" into the element itself, turning rlike into a pure log-depth
    REDUCTION with no per-position accept readback."""

    n_states: int
    elems: "np.ndarray"  # [M, S] int32: element id -> S->S map
    compose: "np.ndarray"  # [M*M] int32: compose[a*M+b] = a-then-b
    gen_of_class: "np.ndarray"  # [C] int32
    accepting: "np.ndarray"  # [S] bool (the DFA's accept vector)
    reset_of_class: Optional["np.ndarray"] = None  # [C] int32
    hit0: Optional["np.ndarray"] = None  # [M] bool
    nullable: bool = False  # underlying automaton accepts empty input
    class_of: Optional["np.ndarray"] = None  # [257] byte -> class

    @property
    def n_elems(self) -> int:
        return len(self.elems)

    @property
    def at0(self) -> "np.ndarray":
        """[M] int32: element applied to the start state."""
        return self.elems[:, 0]

    @property
    def acc_at0(self) -> "np.ndarray":
        """[M] bool: element applied to the start state accepts."""
        return self.accepting[self.elems[:, 0]]


def _elem_key(m: "np.ndarray", h: Optional["np.ndarray"]) -> bytes:
    return m.tobytes() if h is None else m.tobytes() + h.tobytes()


def _close_monoid(gen_maps, gen_hits, S, cap):
    """BFS closure of the generator maps under composition (right-
    extension by generators reaches every product). Returns
    (elems [M, S], hits [M, S] | None, id_of: bytes-key -> id,
    gen_ids) or None past ``cap``."""
    with_hits = gen_hits is not None
    ident_map = np.arange(S, dtype=np.int32)
    ident_hit = np.zeros((S,), np.bool_) if with_hits else None

    id_of = {_elem_key(ident_map, ident_hit): 0}
    order = [(ident_map, ident_hit)]
    gen_ids = []
    uniq_gens = []
    for gi in range(len(gen_maps)):
        m = np.asarray(gen_maps[gi], np.int32)
        h = np.asarray(gen_hits[gi], np.bool_) if with_hits else None
        k = _elem_key(m, h)
        if k not in id_of:
            id_of[k] = len(order)
            order.append((m, h))
            uniq_gens.append((m, h))
        gen_ids.append(id_of[k])
    i = 0
    while i < len(order):
        am, ah = order[i]
        i += 1
        for bm, bh in uniq_gens:
            m = bm[am]
            h = ah | bh[am] if with_hits else None
            k = _elem_key(m, h)
            if k not in id_of:
                if len(order) >= cap:
                    return None
                id_of[k] = len(order)
                order.append((m, h))
    maps = np.array([m for m, _h in order], np.int32)
    hits = (
        np.array([h for _m, h in order], np.bool_) if with_hits else None
    )
    return maps, hits, id_of, gen_ids


def _compose_table(maps, hits, id_of):
    """Dense [M*M] compose table: compose[a*M+b] = id of "a then b"
    ((b.map[a.map[s]]), hits OR-chained through a's map)."""
    M, S = maps.shape
    with_hits = hits is not None
    comp = np.empty((M, M), np.int32)
    for a in range(M):
        am = maps[a]
        cm = np.ascontiguousarray(maps[:, am])  # [M, S]: row b = a-then-b
        if with_hits:
            ch = np.ascontiguousarray(hits[a][None, :] | hits[:, am])
            for b in range(M):
                comp[a, b] = id_of[cm[b].tobytes() + ch[b].tobytes()]
        else:
            for b in range(M):
                comp[a, b] = id_of[cm[b].tobytes()]
    return comp.reshape(-1)


def compile_monoid(
    dfa: DFA,
    *,
    with_hits: bool = False,
    with_resets: bool = False,
    nullable: Optional[bool] = None,
    cap: int = _MAX_MONOID_ELEMS,
) -> Optional[TransitionMonoid]:
    """Enumerate ``dfa``'s transition monoid (None when the closure
    exceeds ``cap`` — the caller falls back to the serial walk, so
    ``_MAX_DFA_STATES`` patterns still run). ``with_hits`` augments
    elements with the accept-passed-through flag (rlike's reduction
    form); ``with_resets`` adds the per-class constant restart
    elements (multi-run prefix scans). Both augmentations enlarge the
    closure, so each entry point enumerates only what it needs."""
    S = dfa.n_states
    C = dfa.n_classes
    tv = dfa.transition_vectors  # [C, S]
    acc = np.asarray(dfa.accepting, np.bool_)
    gen_maps = [tv[c] for c in range(C)]
    gen_hits = [acc[tv[c]] for c in range(C)] if with_hits else None
    if with_resets:
        for c in range(C):
            q = int(tv[c][0])
            gen_maps.append(np.full((S,), q, np.int32))
            if with_hits:
                gen_hits.append(np.full((S,), bool(acc[q]), np.bool_))
    closed = _close_monoid(gen_maps, gen_hits, S, cap)
    if closed is None:
        return None
    maps, hits, id_of, gen_ids = closed
    comp = _compose_table(maps, hits, id_of)
    return TransitionMonoid(
        n_states=S,
        elems=maps,
        compose=comp,
        gen_of_class=np.array(gen_ids[:C], np.int32),
        accepting=acc,
        reset_of_class=(
            np.array(gen_ids[C:], np.int32) if with_resets else None
        ),
        hit0=hits[:, 0].copy() if hits is not None else None,
        nullable=bool(acc[0]) if nullable is None else bool(nullable),
    )


# ---------------------------------------------------------------------------
# gated restart search (feasibility scans of regexp_extract)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GatedSearchDFA:
    """Subset DFA over the alphabet (byte class, gate bit): a fresh
    anchored run of the pattern is injected exactly at gated
    positions, all runs advance in lockstep, acceptance means SOME
    injected run has consumed its whole span. Running it over a
    REVERSED string with the gate wired to "the tail fits here"
    answers regexp_extract's feasibility question — out[:, q] =
    "pattern matches [q, r) for some gated r" — as one suffix
    composition per position instead of the serial all-starts walk
    (ops/regex.py `_feasible_from_monoid`). ``transition[s][c*2+g]``;
    state 0 = no runs in flight."""

    transition: list  # [n_states][2*n_classes] int
    accepting: list  # [n_states] bool
    class_of: list  # [257] int
    n_classes: int
    nullable: bool  # the PATTERN accepts the empty span

    @property
    def n_states(self) -> int:
        return len(self.transition)


def compile_gated_search(ast: Node) -> GatedSearchDFA:
    """Subset-construct the gated-restart automaton of ``ast`` (the
    caller passes the REVERSED segment AST). Raises RegexUnsupported
    past ``_MAX_DFA_STATES`` subsets like ``compile_ast``."""
    ast = _expand(ast)
    g = _Glushkov()
    nullable, first, last = g.build(ast)
    class_of, class_positions, n_classes = _byte_classes(g.masks)
    pos_in_class = [frozenset(s) for s in class_positions]

    start = frozenset()
    states = {start: 0}
    order = [start]
    transition: List[List[int]] = []
    accepting: List[bool] = []
    i = 0
    while i < len(order):
        s = order[i]
        i += 1
        row: List[int] = []
        for c in range(n_classes):
            step = set()
            for p in s:
                step |= g.follow[p]
            for gate in (0, 1):
                live = set(step)
                if gate:
                    live |= first
                key = frozenset(live & pos_in_class[c])
                if key not in states:
                    if len(order) >= _MAX_DFA_STATES:
                        raise RegexUnsupported(
                            f"gated DFA exceeds {_MAX_DFA_STATES} states"
                        )
                    states[key] = len(order)
                    order.append(key)
                row.append(states[key])
        transition.append(row)
        accepting.append(bool(s & last))
    return GatedSearchDFA(
        transition, accepting, class_of, n_classes, bool(nullable)
    )


def compile_gated_monoid(
    gdfa: GatedSearchDFA, cap: int = _MAX_MONOID_ELEMS
) -> Optional[TransitionMonoid]:
    """Transition monoid of a gated-search DFA: generators are indexed
    by (class, gate) pairs — ``gen_of_class`` is [2C] with layout
    ``c*2 + g``."""
    S = gdfa.n_states
    C2 = 2 * gdfa.n_classes
    tv = (
        np.asarray(gdfa.transition, np.int32).reshape(S, C2).T.copy()
    )
    gen_maps = [tv[c] for c in range(C2)]
    closed = _close_monoid(gen_maps, None, S, cap)
    if closed is None:
        return None
    maps, _hits, id_of, gen_ids = closed
    comp = _compose_table(maps, None, id_of)
    return TransitionMonoid(
        n_states=S,
        elems=maps,
        compose=comp,
        gen_of_class=np.array(gen_ids, np.int32),
        accepting=np.asarray(gdfa.accepting, np.bool_),
        nullable=gdfa.nullable,
    )


@dataclasses.dataclass
class StackedMonoid:
    """K monoids' tables concatenated for the stacked scan lift:
    lane k's LOCAL element ids compose through its own
    table at ``comp_flat[base[k] + a * mk[k] + b]`` and evaluate
    through ``acc_at0_flat[ebase[k] + e]`` — one scan over a
    ``[K, n, L]`` id array replaces K sequential scans over ``[n, L]``
    (ops/segmented.stacked_monoid_combine is the device combine).
    All tables are host numpy: they fold as constants under a trace
    and convert once at an eager kernel boundary, exactly like
    ``_DeviceMonoid``."""

    K: int
    base: "np.ndarray"  # [K, 1, 1] int32: comp_flat offset per lane
    mk: "np.ndarray"  # [K, 1, 1] int32: element count per lane
    ebase: "np.ndarray"  # [K, 1, 1] int32: eval-table offset per lane
    comp_flat: "np.ndarray"  # [sum Mk^2] int32
    acc_at0_flat: "np.ndarray"  # [sum Mk] bool
    nullable: "np.ndarray"  # [K] bool


def stack_monoids(monoids) -> StackedMonoid:
    """Concatenate K TransitionMonoids' compose/eval tables into one
    flat stacked bundle. Lane ids stay LOCAL (0..Mk-1) — the per-lane
    ``base``/``mk``/``ebase`` offsets are what make one gather serve
    every lane, so the stack never pays a product-monoid closure."""
    sizes = [m.n_elems for m in monoids]
    base = np.cumsum([0] + [s * s for s in sizes[:-1]]).astype(np.int32)
    ebase = np.cumsum([0] + sizes[:-1]).astype(np.int32)
    return StackedMonoid(
        K=len(monoids),
        base=base.reshape(-1, 1, 1),
        mk=np.asarray(sizes, np.int32).reshape(-1, 1, 1),
        ebase=ebase.reshape(-1, 1, 1),
        comp_flat=np.concatenate([m.compose for m in monoids]),
        acc_at0_flat=np.concatenate([m.acc_at0 for m in monoids]),
        nullable=np.asarray([bool(m.nullable) for m in monoids], np.bool_),
    )


@lru_cache(maxsize=64)
def scalar_token_monoid() -> TransitionMonoid:
    """Anchored DFA + reset monoid for one JSON scalar token (number /
    true / false / null) — the device validator behind from_json's
    log-depth token pass (ops/_json_scans.py). Fixed grammar, so the
    closure is enumerated once per process."""
    ast, _s, _e, _g = parse(
        r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?|true|false|null"
    )
    dfa = compile_ast(ast, "anchored")
    m = compile_monoid(dfa, with_resets=True)
    assert m is not None, "scalar token monoid must enumerate"
    m.class_of = byte_table(dfa.class_of)
    return m


def byte_table(class_of) -> "np.ndarray":
    """[257] int32 byte(+past-end sentinel) -> class table as numpy."""
    return np.asarray(class_of, np.int32)
