"""Streamed Parquet scan ingress: footer-pruned row-group planning +
prefetched host decode overlapped with the device stream (PyTorch twin
of the JAX package's ``runtime/scan.py``: same planner, same pruning
rules, same metrics and journal event).

- ``ScanPlan``: parses each file's footer ONCE (``ParquetFooter`` via
  the native thrift DOM), prunes columns through the filter-schema DSL
  (``StructElement`` subset of the identity schema), and prunes whole
  row groups against footer min/max statistics for simple AND-combined
  ``(column, op, value)`` predicates. Pruning follows SQL null
  semantics — a comparison is never satisfied by a null, so
  ``null_count`` never blocks a skip and an all-null chunk is itself
  skippable — and row groups WITHOUT statistics are never skipped. v2
  ``min_value``/``max_value`` stats are preferred; the deprecated
  ``min``/``max`` pair is trusted only because predicate columns are
  restricted to signed numeric physical types, the one family whose
  legacy sort order is unambiguous (parquet-mr's rule). Byte
  accounting: ``scan.row_groups_pruned`` and ``scan.bytes_skipped``
  count what the predicate proved away, ``scan.bytes_read`` accrues
  per chunk actually decoded.

- ``prefetch_chunks``: a bounded pool of N background decode workers
  filling a depth-K window of decoded chunks ahead of the consumer. The
  native ctypes page decode releases the GIL, so decodes overlap the
  device work and each other. Backpressure is a K-slot semaphore: at
  most K chunks are decoded or decoding at once. ``scan.prefetch_depth``
  gauges the ready backlog at each hand-off and ``scan.stall_ms`` times
  the in-order wait. Worker errors are delivered AT THE FAILING CHUNK'S
  TURN, in order.

The copy to the card (a choice of the port; the JAX package hands
host decode and device placement to XLA). A worker decodes a row group
on the host (``ParquetReader.read_row_group_host``), stages every array
in page-locked memory and copies it without blocking on a CUDA stream
of its own, pads the varlen payloads there, and records an event. The
consumer's stream waits on that event when it takes the chunk, and
every tensor of the chunk is marked as used by the consumer's stream
(``record_stream``) so the caching allocator cannot hand its memory
back to the worker's stream while the consumer still reads it. So the
copy neither blocks the worker on pageable memory nor queues behind
the consumer's kernels on the default stream. A reader on the CPU
decodes and builds its tables in the worker directly.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import torch

from . import events as _events
from . import metrics as _metrics

# parquet physical types (parquet-format Type enum) whose plain
# encoding this planner can decode and whose ordering is total and
# writer-independent: INT32/INT64 little-endian two's complement,
# FLOAT/DOUBLE IEEE754 little-endian
_NUMERIC_PT = {1: ("i", 4), 2: ("i", 8), 4: ("f", 4), 5: ("f", 8)}  # sprtcheck: guarded-by=frozen
# ConvertedType values under which the raw numeric compares like the
# logical value: none (-1) and the signed int widths. Unsigned,
# decimal, date/time etc. stay un-prunable (conservative = correct).
_SIGNED_CONVERTED = (-1, 15, 16, 17, 18)

_OPS = (">", ">=", "<", "<=", "==", "!=")

PredicateTerm = Tuple[Union[str, int], str, Union[int, float]]


def _normalize_predicate(predicate) -> List[PredicateTerm]:
    """One term or a list of AND-combined terms, each
    ``(column, op, value)`` with op in ``_OPS``."""
    if predicate is None:
        return []
    if (
        isinstance(predicate, (tuple, list))
        and len(predicate) == 3
        and isinstance(predicate[1], str)
    ):
        # a single (column, op, value) term, even with a bad op — the
        # loop below reports THAT error, not a shape complaint
        predicate = [tuple(predicate)]
    terms: List[PredicateTerm] = []
    for t in predicate:
        if len(t) != 3:
            raise ValueError(f"predicate term {t!r}: want (column, op, value)")
        col, op, val = t
        if op not in _OPS:
            raise ValueError(f"predicate op {op!r}: supported ops are {_OPS}")
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            raise TypeError(
                f"predicate value {val!r}: only numeric predicates prune "
                f"against footer statistics"
            )
        terms.append((col, str(op), val))
    return terms


def _decode_stat(raw: Optional[bytes], pt: int):
    """Plain-encoded min/max byte string -> python number, or None
    when absent/malformed (malformed stats must never prune)."""
    if raw is None:
        return None
    kind, width = _NUMERIC_PT[pt]
    if len(raw) != width:
        return None
    if kind == "i":
        return int.from_bytes(raw, "little", signed=True)
    return struct.unpack("<f" if width == 4 else "<d", raw)[0]


def _group_unsatisfiable(op: str, val, mn, mx) -> bool:
    """True when NO value in [mn, mx] can satisfy ``x <op> val`` —
    the whole row group is skippable. Nulls never satisfy a
    comparison (SQL), so they cannot veto a skip."""
    if op == ">":
        return mx <= val
    if op == ">=":
        return mx < val
    if op == "<":
        return mn >= val
    if op == "<=":
        return mn > val
    if op == "==":
        return val < mn or val > mx
    # "!=": only a constant chunk equal to the literal is unsatisfiable
    return mn == mx == val


class ScanPlan:
    """Footer-only scan plan over one or more parquet files: which row
    groups to decode, in file order, with column pruning applied and
    predicate-unsatisfiable row groups dropped. Parsing happens once,
    here — the prefetch workers reuse the pruned footers. Chunks land on
    ``device`` (default the card; raises without one). Close it to
    release the native footer handles."""

    def __init__(
        self,
        paths: Union[str, Sequence[str]],
        *,
        columns: Optional[Sequence[str]] = None,
        predicate=None,
        ignore_case: bool = False,
        device="cuda",
    ):
        from ..columnar.column import resolve_device
        from ..ops.parquet_footer import StructElement
        from ..ops.parquet_reader import (
            ParquetReader,
            _identity_schema,
            _read_footer_bytes,
            _subtree_leaves,
        )

        device = resolve_device(device)
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        if not self.paths:
            raise ValueError("scan needs at least one path")
        self.columns = None if columns is None else [str(c) for c in columns]
        self._terms = _normalize_predicate(predicate)
        self.readers: List[ParquetReader] = []
        # decode units in file order: (reader, row_group, chunk_bytes)
        self.chunks: List[tuple] = []
        self.names: Optional[List[str]] = None
        self.total_rows = 0
        self.row_groups_total = 0
        self.row_groups_pruned = 0
        self.bytes_planned = 0
        self.bytes_skipped = 0
        # predicate terms resolved against the pruned schema:
        # (top_idx, leaf_idx, physical_type, op, value)
        self._resolved: List[tuple] = []
        # reader -> the file position of each scanned column: the
        # footer filter keeps the file's column order, chunks follow
        # ``names`` (see ``_decode``)
        self.order = {}

        for path in self.paths:
            footer_bytes = _read_footer_bytes(path)
            ident = _identity_schema(footer_bytes)
            if self.columns is None:
                schema = ident
                names = [n for n, _ in ident.children]
            else:
                by_name = dict(ident.children)
                missing = [c for c in self.columns if c not in by_name]
                if missing:
                    raise ValueError(
                        f"{path}: no such column(s) {missing}; file has "
                        f"{[n for n, _ in ident.children]}"
                    )
                schema = StructElement(
                    [(c, by_name[c]) for c in self.columns]
                )
                names = list(self.columns)
            if self.names is None:
                self.names = names
            elif names != self.names:
                raise ValueError(
                    f"{path}: column set {names} differs from first "
                    f"file's {self.names} — a scan is one schema"
                )
            reader = ParquetReader(path, schema, device=device)
            self.readers.append(reader)
            kept = [n for n, _ in ident.children if n in set(names)]
            self.order[reader] = [kept.index(n) for n in names]
            # leaf index of each top-level column in file order (nested
            # subtrees span several leaves; predicate columns must be flat)
            leaf_of_top, acc = [], 0
            for root in reader._roots:
                leaf_of_top.append(acc)
                acc += _subtree_leaves(root)
            resolved = self._resolve_terms(reader, leaf_of_top)
            if not self._resolved:
                self._resolved = resolved
            self._plan_row_groups(reader, resolved)

        _metrics.counter("scan.row_groups_pruned").inc(self.row_groups_pruned)
        _metrics.counter("scan.bytes_skipped").inc(self.bytes_skipped)
        _events.emit(
            "scan_plan",
            files=len(self.paths),
            columns=list(self.names or []),
            predicate=[
                (str(c), op, v) for c, op, v in self._terms
            ] or None,
            row_groups=self.row_groups_total,
            row_groups_pruned=self.row_groups_pruned,
            rows=self.total_rows,
            bytes_planned=self.bytes_planned,
            bytes_skipped=self.bytes_skipped,
        )

    def _resolve_terms(self, reader, leaf_of_top) -> List[tuple]:
        resolved = []
        names = self.names or []
        order = self.order[reader]
        for col, op, val in self._terms:
            if isinstance(col, int):
                ti = int(col)
                if not 0 <= ti < len(reader._roots):
                    raise ValueError(f"predicate column {col} out of range")
            elif col in names:
                ti = names.index(col)
            else:
                raise ValueError(
                    f"predicate column {col!r} is not in the scanned "
                    f"columns {names} — include it in columns="
                )
            root = reader._roots[order[ti]]
            if root.leaf_idx is None or root.max_rep != 0:
                raise TypeError(
                    f"predicate column {col!r} is nested; only flat "
                    f"numeric columns support predicates"
                )
            leaf = leaf_of_top[order[ti]]
            if reader.num_row_groups == 0:
                continue
            info = reader._chunk_info(0, leaf)
            pt = info["type"]
            if (
                pt not in _NUMERIC_PT
                or info["converted"] not in _SIGNED_CONVERTED
                or info["scale"] != 0
            ):
                raise TypeError(
                    f"predicate column {col!r} has unsupported type "
                    f"(physical {pt}, converted {info['converted']}) — "
                    f"only signed ints and floats compare against "
                    f"footer statistics"
                )
            resolved.append((ti, leaf, pt, op, val))
        return resolved

    def _plan_row_groups(self, reader, resolved) -> None:
        for rg in range(reader.num_row_groups):
            infos = [
                reader._chunk_info(rg, li)
                for li in range(reader.num_columns)
            ]
            rg_bytes = sum(i["size"] for i in infos)
            self.row_groups_total += 1
            skip = False
            for ti, leaf, pt, op, val in resolved:
                st = reader.footer.chunk_stats(rg, leaf)
                if st is None:
                    continue  # no stats: this term cannot prune
                nv = infos[leaf]["num_values"]
                nulls = st["null_count"]
                if nulls is not None and nv > 0 and nulls >= nv:
                    skip = True  # all null: no comparison can hold
                    break
                mn = _decode_stat(
                    st["min_value"]
                    if st["min_value"] is not None
                    else st["min_legacy"],
                    pt,
                )
                mx = _decode_stat(
                    st["max_value"]
                    if st["max_value"] is not None
                    else st["max_legacy"],
                    pt,
                )
                if mn is None or mx is None:
                    continue
                if _group_unsatisfiable(op, val, mn, mx):
                    skip = True
                    break
            if skip:
                self.row_groups_pruned += 1
                self.bytes_skipped += rg_bytes
            else:
                self.chunks.append((reader, rg, rg_bytes))
                self.bytes_planned += rg_bytes
                self.total_rows += int(
                    reader._lib.spark_pf_rg_num_rows(
                        reader.footer._handle, rg
                    )
                )

    def residual_filter(self):
        """Per-row predicate over a decoded chunk (a bool tensor on the
        chunk's device), or None when the scan has no predicate.
        Row-group pruning only removes PROVABLY empty groups; surviving
        groups still carry rows that fail the predicate. Null predicate
        rows drop (Spark filter semantics)."""
        if not self._resolved:
            return None
        terms = [(ti, op, val) for ti, _leaf, _pt, op, val in self._resolved]

        def residual(table):
            mask = None
            for ti, op, val in terms:
                c = table.columns[ti]
                d = c.data
                if op == ">":
                    m = d > val
                elif op == ">=":
                    m = d >= val
                elif op == "<":
                    m = d < val
                elif op == "<=":
                    m = d <= val
                elif op == "==":
                    m = d == val
                else:
                    m = d != val
                if c.validity is not None:
                    m = m & c.validity
                mask = m if mask is None else mask & m
            return mask

        return residual

    def explain(self, fmt: str = "text"):
        """EXPLAIN for the scan ingress: the footer-pruning
        summary — files, pruned column set, predicate terms, row
        groups planned vs pruned, bytes planned vs skipped, and
        whether a residual per-row filter stage remains. ``fmt="json"``
        returns the JSON-safe document; ``"text"`` renders it."""
        if fmt not in ("text", "json"):
            raise ValueError(
                f"explain fmt={fmt!r}: expected 'text' or 'json'"
            )
        doc = {
            "files": list(self.paths),
            "columns": list(self.names or []),
            "predicate": [
                [str(c), op, v] for c, op, v in self._terms
            ] or None,
            "residual_filter": bool(self._resolved),
            "rows": self.total_rows,
            "row_groups": self.row_groups_total,
            "row_groups_pruned": self.row_groups_pruned,
            "bytes_planned": self.bytes_planned,
            "bytes_skipped": self.bytes_skipped,
        }
        if fmt == "json":
            return doc
        pred = doc["predicate"]
        lines = [
            f"== ScanPlan: {len(self.paths)} file(s) ==",
            "columns: " + (", ".join(doc["columns"]) or "(all)"),
            "predicate: " + (
                " AND ".join(f"{c} {op} {v}" for c, op, v in pred)
                if pred else "none"
            ),
            f"residual filter stage: "
            f"{'yes' if doc['residual_filter'] else 'no'}",
            f"row groups: {doc['row_groups']} total, "
            f"{doc['row_groups_pruned']} pruned by footer stats",
            f"rows planned: {doc['rows']}",
            f"bytes: {doc['bytes_planned']} planned, "
            f"{doc['bytes_skipped']} skipped",
        ]
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        for r in self.readers:
            r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def _pad_varlen_pow2(table, names):
    """Pad every flat varlen column's payload to a power-of-two byte
    bucket (zeros past the real payload; offsets untouched) so
    consecutive row groups present the same payload sizes, as the JAX
    package's chunks do. Also stamps the scan's column names onto the
    chunk."""
    from ..columnar.column import Column
    from ..columnar.table import Table

    cols = list(table.columns)
    for i, c in enumerate(cols):
        if not isinstance(c, Column) or not c.is_varlen:
            continue
        have = int(c.data.shape[0])
        want = max(8, _next_pow2(have))
        if want > have:
            pad = torch.zeros(want - have, dtype=c.data.dtype, device=c.data.device)
            cols[i] = Column(c.dtype, torch.cat([c.data, pad]), c.validity, c.offsets)
    return Table(cols, names)


def _tensors(col):
    """Every tensor of a (possibly nested) column."""
    for name in ("data", "validity", "offsets"):
        t = getattr(col, name, None)
        if isinstance(t, torch.Tensor):
            yield t
    child = getattr(col, "child", None)
    if child is not None:
        yield from _tensors(child)
    for kid in getattr(col, "children", ()) or ():
        yield from _tensors(kid)


def _decode(reader, rg: int, plan, streams: dict):
    """Decode row group ``rg`` on the host, its columns in the plan's
    ``names`` order, and place it on the reader's device:
    ``(table, copied)``. On a card the copy runs on this thread's own
    stream from page-locked memory and ``copied`` holds the event that
    marks its end; on the CPU it is None."""
    from ..columnar.interop import table_from_numpy

    names = plan.names
    host = reader.read_row_group_host(rg)
    specs = [host[i] for i in plan.order[reader]]
    dev = reader.device
    if dev.type != "cuda":
        return _pad_varlen_pow2(table_from_numpy(specs, dev), names), None
    stream = streams.get(dev)
    if stream is None:
        stream = streams[dev] = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(stream):
        tbl = _pad_varlen_pow2(table_from_numpy(specs, dev, pinned=True), names)
        event = torch.cuda.Event()
        event.record(stream)
    return tbl, (event, dev)


def _hand_over(tbl, copied):
    """Order the consumer's current stream after the chunk's copy, and
    keep the chunk's memory from being reused while that stream may
    still read it."""
    if copied is None:
        return
    event, dev = copied
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_event(event)
    for c in tbl.columns:
        for t in _tensors(c):
            t.record_stream(consumer)


class _Prefetcher:
    """Bounded background decode pool over a ``ScanPlan``'s chunks.
    ``workers`` threads claim chunk indices in order and publish
    decoded Tables (or the exception that killed the decode) into a
    ready map; iteration yields strictly in plan order. A ``depth``
    semaphore is the memory bound: a worker may not START a decode
    until a previously decoded chunk has been handed to the consumer,
    so at most ``depth`` decoded chunks (plus the in-progress ones'
    partial buffers) are resident."""

    def __init__(self, plan: ScanPlan, depth: int, workers: int):
        self._plan = plan
        self._items = list(plan.chunks)
        self._depth = max(1, int(depth))
        self._slots = threading.Semaphore(self._depth)
        self._cv = threading.Condition(threading.Lock())
        # sprtcheck: guarded-by=_cv
        self._ready: dict = {}
        # sprtcheck: guarded-by=_cv
        self._next_claim = 0
        # sprtcheck: guarded-by=_cv
        self._stop = False
        n = min(max(1, int(workers)), max(1, len(self._items)))
        self._threads = [
            threading.Thread(
                target=self._work, name=f"scan-prefetch-{i}", daemon=True
            )
            for i in range(n)
        ]
        for t in self._threads:
            t.start()

    def _work(self) -> None:
        streams: dict = {}  # this thread's copy stream per device
        while True:
            # sprtcheck: acquires=prefetch-slot release=_slots.release,_publish
            self._slots.acquire()
            with self._cv:
                if self._stop or self._next_claim >= len(self._items):
                    self._slots.release()
                    return
                idx = self._next_claim
                self._next_claim += 1
            # EVERYTHING between claim and publish runs inside the
            # try: a claimed index that never reaches _ready parks the
            # consumer's in-order wait forever AND strands the slot
            try:
                reader, rg, nbytes = self._items[idx]
                res = ("ok", _decode(reader, rg, self._plan, streams))
                _metrics.counter("scan.bytes_read").inc(nbytes)
            except BaseException as exc:  # delivered at the chunk's turn
                res = ("err", exc)
            self._publish(idx, res)

    def _publish(self, idx: int, res: tuple) -> None:
        """Hand a decoded (or failed) chunk to the consumer. OWNERSHIP
        TRANSFER: the backpressure slot rides with the chunk — the
        consumer's in-order drain releases it (``__iter__``), or
        ``_shutdown`` drops the ready map and refills every slot."""
        with self._cv:
            self._ready[idx] = res
            self._cv.notify_all()

    def _shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._ready.clear()
        # unblock workers parked on the backpressure semaphore
        for _ in self._threads:
            self._slots.release()
        for t in self._threads:
            t.join(timeout=5.0)

    def __iter__(self) -> Iterator:
        try:
            for i in range(len(self._items)):
                t0 = time.perf_counter()
                with self._cv:
                    while i not in self._ready:
                        self._cv.wait()
                    kind, val = self._ready.pop(i)
                    backlog = len(self._ready)
                # the wait above is the decode stall: ~0 when prefetch
                # kept ahead, the honest gap when the device outran it
                _metrics.timer("scan.stall_ms").observe(
                    (time.perf_counter() - t0) * 1000
                )
                _metrics.gauge("scan.prefetch_depth").set(backlog)
                self._slots.release()  # one slot freed -> decode ahead
                if kind == "err":
                    raise val
                tbl, copied = val
                del val
                _hand_over(tbl, copied)
                yield tbl
                del tbl  # the consumer owns the chunk now — hold no ref
        finally:
            self._shutdown()


def default_workers() -> int:
    """Decode pool size: leave one core for the dispatch thread, cap
    at 4 (row-group decode saturates memory bandwidth well before
    that on more cores)."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:  # non-linux
        cpus = os.cpu_count() or 1
    return max(1, min(cpus - 1, 4))


def prefetch_chunks(
    plan: ScanPlan,
    *,
    depth: int = 2,
    workers: Optional[int] = None,
) -> Iterator:
    """Generator of decoded, pad-stabilized chunks in plan order on the
    plan's device, decoded ahead by the bounded worker pool. Closing
    the generator (or exhausting it) stops the workers and joins them —
    the plan's native footer handles must outlive the pool, so callers
    close the generator BEFORE ``plan.close()``."""
    if workers is None:
        workers = default_workers()
    n_workers = int(workers)

    def gen():
        if not plan.chunks:
            return
        pf = _Prefetcher(plan, depth, n_workers)
        try:
            for chunk in pf:
                yield chunk
        finally:
            # deterministic even when the consumer abandons us
            # mid-stream: workers are joined before this returns, so a
            # following plan.close() cannot free footers under them
            pf._shutdown()

    return gen()


def scan_chunks(
    paths,
    *,
    columns: Optional[Sequence[str]] = None,
    predicate=None,
    depth: int = 2,
    workers: Optional[int] = None,
    device="cuda",
) -> Iterator:
    """Plan + prefetch in one call: a generator of decoded chunks on
    ``device`` (default the card; raises without one) that owns its
    plan (footers close when the generator is exhausted or closed).
    Row-group pruning only drops provably empty groups — pair with the
    plan's ``residual_filter`` when exact predicate semantics are
    needed."""
    plan = ScanPlan(paths, columns=columns, predicate=predicate, device=device)

    def gen():
        src = prefetch_chunks(plan, depth=depth, workers=workers)
        try:
            for chunk in src:
                yield chunk
        finally:
            src.close()  # join the pool BEFORE the footers go away
            plan.close()

    return gen()
