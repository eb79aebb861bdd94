"""The integer instructions a kernel's row issues, read from its SASS.

A native kernel's operation bound (``chip_smoke.py`` phases 14 and 33)
counts the integer instructions one row of it issues at the least. They
are read from ``cuobjdump -sass`` of the built plugin: one kernel's
control flow graph of basic blocks, its row loop (the innermost loop
that holds the row's output store), and the cheapest way through that
loop's body from its head to its back edge, each block weighted by its
integer instructions. Inner loops count zero turns on that way; a loop
over a string's bytes is counted apart (``per_byte``: the cheapest turn
of an inner loop that loads a byte). Every branch may be skipped on that
way, those that test the launch's own arguments too (a rescale by 10^0
skips its division), so the count is a floor of what any row issues,
and the bound it gives stays a least time.

Integer instructions are those of the per-thread integer and logic pipes
(``INT_OPCODES``); the uniform datapath (``U*``), loads and stores,
control, float and conversion instructions are not counted.

Nothing here imports torch or runs at import.
"""

from __future__ import annotations

import heapq
import os
import re
import subprocess
from typing import Dict, List, Tuple

INT_OPCODES = frozenset({
    "IMAD", "IADD3", "IADD", "IMUL", "LOP3", "LOP", "ISETP", "ICMP", "SHF", "SHL", "SHR",
    "LEA", "SEL", "IMNMX", "VIMNMX", "IABS", "PRMT", "FLO", "POPC", "BREV", "BMSK", "SGXT",
    "VIADD", "IDP", "MOV", "PLOP3", "P2R", "R2P",
})

_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNCTION = re.compile(r"Function : (\S+)")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")

Instr = Tuple[int, str, str, bool]  # address, opcode, text, predicated


def cuobjdump_sass(library: str, nvcc: str) -> str:
    """``cuobjdump -sass`` of a built library, with the toolkit's
    cuobjdump beside ``nvcc``."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    proc = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {library}: {proc.stderr[-2000:]}")
    return proc.stdout


def functions(sass: str) -> Dict[str, List[Instr]]:
    """Each function's instructions, by its (mangled) name."""
    out: Dict[str, List[Instr]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _LINE.match(line)
        if m and cur is not None:
            text = m.group(2)
            predicated = text.startswith("@")
            if predicated:
                text = text.split(None, 1)[1]
            cur.append((int(m.group(1), 16), text.split()[0], text, predicated))
    return out


def find(funcs: Dict[str, List[Instr]], fragment: str) -> List[Instr]:
    """The one function whose name holds ``fragment``."""
    names = [n for n in funcs if fragment in n]
    if len(names) != 1:
        raise KeyError(f"{len(names)} functions hold {fragment!r}")
    return funcs[names[0]]


def _is_int(op: str) -> bool:
    return op.split(".")[0] in INT_OPCODES


def _branch(ins: Instr):
    """(target, conditional) of a branch, else None."""
    addr, op, text, predicated = ins
    if op.split(".")[0] != "BRA":
        return None
    m = _TARGET.search(text)
    if m is None:
        return None
    conditional = predicated or re.search(r"\bP\d\b|\bPT\b", text) is not None
    return int(m.group(1), 16), conditional


def _blocks(instrs: List[Instr]):
    """Basic blocks: (start, end) index ranges, their integer weights and
    successor block indexes."""
    at = {ins[0]: i for i, ins in enumerate(instrs)}
    leaders = {0}
    for i, ins in enumerate(instrs):
        b = _branch(ins)
        ends = b is not None or ins[1].split(".")[0] in ("EXIT", "RET")
        if b is not None and b[0] in at:
            leaders.add(at[b[0]])
        if ends and i + 1 < len(instrs):
            leaders.add(i + 1)
    starts = sorted(leaders)
    spans = list(zip(starts, starts[1:] + [len(instrs)]))
    block_of = {s: k for k, (s, _) in enumerate(spans)}
    weights, succ = [], []
    for s, e in spans:
        weights.append(sum(1 for ins in instrs[s:e] if _is_int(ins[1])))
        last = instrs[e - 1]
        b = _branch(last)
        nxt = []
        stop = last[1].split(".")[0] in ("EXIT", "RET") and not last[3]
        if b is not None:
            if b[0] in at:
                nxt.append(block_of[at[b[0]]])
            stop = not b[1]
        if not stop and e < len(instrs):
            nxt.append(block_of[e])
        succ.append(nxt)
    return spans, weights, succ


def _cheapest(spans, weights, succ, src: int, dst: int) -> int:
    """The least summed weight of blocks from src to dst along any edges
    (Dijkstra: every weight is at least 0, so no loop is turned on that
    way; the compiler may place blocks of a loop's body past its back
    edge, which a walk along forward edges alone would miss)."""
    dist = {src: weights[src]}
    heap = [(weights[src], src)]
    while heap:
        d, k = heapq.heappop(heap)
        if k == dst:
            return int(d)
        if d > dist[k]:
            continue
        for t in succ[k]:
            nd = d + weights[t]
            if nd < dist.get(t, float("inf")):
                dist[t] = nd
                heapq.heappush(heap, (nd, t))
    raise ValueError("no way from the loop's head to its back edge")


def row_ops(instrs: List[Instr], store: str) -> Dict[str, int]:
    """The integer instructions of the cheapest way once through the row
    loop's body (``row``; the row loop: the innermost loop holding an
    instruction whose opcode is ``store``), and the cheapest turn of an
    inner loop of it that loads a byte (``per_byte``, 0 when none)."""
    spans, weights, succ = _blocks(instrs)
    back = [(k, t) for k, nxt in enumerate(succ) for t in nxt if t <= k]
    holds = [(k, t) for k, t in back
             if any(ins[1] == store for s, e in spans[t:k + 1] for ins in instrs[s:e])]
    if not holds:
        raise ValueError(f"no loop holds {store}")
    tail, head = min(holds, key=lambda e: spans[e[0]][1] - spans[e[1]][0])
    row = _cheapest(spans, weights, succ, head, tail)
    per_byte = 0
    for k, t in back:
        if head < t <= k < tail and any(
                ins[1].split(".")[0] in ("LD", "LDS", "LDG") and ".U8" in ins[1]
                for s, e in spans[t:k + 1] for ins in instrs[s:e]):
            turn = _cheapest(spans, weights, succ, t, k)
            per_byte = turn if per_byte == 0 else min(per_byte, turn)
    return {"row": row, "per_byte": per_byte}
