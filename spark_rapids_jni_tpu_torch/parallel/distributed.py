"""The driver-side collect of padded results (the port's twin of
``collect_table`` / ``collect_group_by`` in the JAX package's
``parallel/distributed.py``; the distributed executors wait for the
exchange, ROADMAP Queue 1 item 3).

A padded result (a fused Pipeline chain, ``join_padded``,
``group_by_padded``) carries an occupancy mask; the collect compacts
its live rows into a dense Table. The JAX package moves the planes to
the host and compacts there; the port keeps the result on its device:
ONE batched device -> host transfer reads the live count, each varlen
column's live payload bytes and the overflow counts, then the live rows
gather on the device at those host-known sizes. The result is the same
Table — data, validity and offsets — the host compaction gives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..columnar.column import Column
from ..columnar.table import Table
from ..ops.join import _first_true
from ..runtime import events as _events
from ..runtime import metrics as _metrics
from ..runtime import spans as _spans
from ..runtime.errors import CapacityExceededError


def compact_validity(table: Table, invalid_counts: Optional[Sequence[int]] = None) -> Table:
    """Drop all-True validity masks (the JAX package's
    ``Table.compact_validity``). ``invalid_counts`` — the null count of
    each masked column, in column order — comes from a caller that
    already synced it; otherwise one batched host sync reads it."""
    masked = [i for i, c in enumerate(table.columns) if c.validity is not None]
    if not masked:
        return table
    if invalid_counts is None:
        invalid_counts = torch.stack(
            [(~table.columns[i].validity).sum() for i in masked]
        ).tolist()
    cols = list(table.columns)
    for bad, i in zip(invalid_counts, masked):
        if not bad:
            c = cols[i]
            cols[i] = Column(c.dtype, c.data, None, c.offsets)
    return Table(cols, table.names)


def live_tail(result: Table, occupied) -> torch.Tensor:
    """int64 [1 + n_varlen] device vector: the live row count, then
    each varlen column's live payload bytes (null rows count 0) — what
    the compaction needs to know on the host. No sync."""
    parts = [occupied.sum().reshape(1).to(torch.int64)]
    for c in result.columns:
        if c.is_varlen:
            lens = torch.where(occupied, c.string_lengths(), 0)
            parts.append(lens.sum().reshape(1).to(torch.int64))
    return torch.cat(parts)


def _publish_device_metrics(per_dev, n_dev: int, overflow) -> None:
    """Per-device task metrics at the driver-side collect: each device's
    occupied-slot count (``device.<d>.occupied_slots``), the key-skew
    gauge (max/mean occupied slots) and one ``device_metrics`` journal
    event with the per-stage overflow counts."""
    if not _metrics.enabled() or n_dev <= 0 or not per_dev:
        return
    mean = sum(per_dev) / len(per_dev)
    skew = max(per_dev) / mean if mean > 0 else 0.0
    _metrics.drop_gauges("device.")
    for d, v in enumerate(per_dev):
        _metrics.gauge(f"device.{d}.occupied_slots").set(v)
    _metrics.gauge("collect.key_skew").set(skew)
    if isinstance(overflow, dict):
        ovf = {k: int(v) for k, v in overflow.items()}
    elif overflow is not None:
        ovf = {"total": int(overflow)}
    else:
        ovf = {}
    _events.emit(
        "device_metrics",
        n_dev=n_dev,
        occupied_slots=list(per_dev),
        key_skew=round(skew, 4),
        overflow=ovf,
    )


def _check_overflow(overflow) -> None:
    """Raise CapacityExceededError when a host-synced overflow count
    (an int, or a per-stage dict) is nonzero."""
    if overflow is None:
        return
    if isinstance(overflow, dict):
        counts = {k: int(v) for k, v in overflow.items()}
        tripped = {k: v for k, v in counts.items() if v}
        if not tripped:
            return
        for k, v in tripped.items():
            _metrics.counter(f"overflow.{k}").inc(v)
        _events.emit("capacity_overflow", source="collect", stages=tripped)
        per_stage = ", ".join(f"{k}={v}" for k, v in tripped.items())
        raise CapacityExceededError(
            "pipeline overflow detected — rows/groups dropped or truncated "
            f"by stage (indicator counts): {per_stage}. Raise the bound "
            "feeding the overflowing stage(s) and rerun, or run under a "
            "runtime.resource task scope to re-plan automatically",
            stage=max(tripped, key=tripped.get),
            breakdown=counts,
        )
    lost = int(overflow)
    if lost:
        _metrics.counter("overflow.unattributed").inc(lost)
        _events.emit("capacity_overflow", source="collect", stages={"unattributed": lost})
        raise CapacityExceededError(
            f"pipeline overflow detected (indicator count={lost}): rows/groups "
            "were dropped or truncated by a bounded contract (join capacity, "
            "group capacity, or pinned string width); raise the undersized "
            "bound and rerun"
        )


def _gather_live(result: Table, occupied, n_live: int, varlen_bytes: Sequence[int]) -> Table:
    """The live rows of ``result`` in order, gathered on its device at
    host-known sizes (no sync)."""
    idx = _first_true(occupied, n_live) if n_live else occupied.new_zeros(0, dtype=torch.int64)
    cols = []
    vi = 0
    for c in result.columns:
        valid = None if c.validity is None else c.validity[idx]
        if not c.is_varlen:
            cols.append(Column(c.dtype, c.data[idx], valid))
            continue
        total = int(varlen_bytes[vi])
        vi += 1
        lens = c.string_lengths()[idx]
        offsets = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0, dtype=torch.int32)])
        row = torch.repeat_interleave(
            torch.arange(n_live, device=idx.device), lens.long(), output_size=total
        )
        pos = torch.arange(total, device=idx.device) - offsets[:-1].long()[row]
        data = c.data[c.offsets[idx].long()[row] + pos]
        cols.append(Column(c.dtype, data.to(torch.uint8), valid, offsets))
    return Table(cols, result.names)


def collect_table(
    result: Table, occupied=None, overflow=None, n_dev: Optional[int] = None
) -> Table:
    """Compact any padded result (``join_padded``, ``group_by_padded``,
    or a fused runtime/pipeline.py chain) into a dense Table — the
    driver-side collect at a query tail (one sync). ``occupied=None``
    means every row is live: the table passes through with all-True
    validity masks dropped. Pass the op's ``overflow`` to enforce the
    bounded contracts: any undersized capacity raises here instead of
    returning a plausible short answer. ``n_dev`` turns on the
    per-device occupancy metrics."""
    if occupied is None and overflow is None:
        with _spans.span("collect_stage", "collect_table"):
            return compact_validity(result)
    return collect_group_by(result, occupied, overflow, n_dev=n_dev)


def collect_group_by(
    result: Table, occupied, overflow=None, n_dev: Optional[int] = None
) -> Table:
    """Compact a padded result into a dense Table (one sync). Raises if
    ``overflow`` (an int tensor, or a per-stage dict of them) is
    nonzero; the dict form names WHICH stage's bounded contract dropped
    rows. With ``n_dev`` given, per-device occupancy metrics are
    published first — even an overflowing collect leaves them behind."""
    with _spans.span("collect_stage", "collect_group_by"):
        if occupied is None:
            occupied = torch.ones(
                result.num_rows, dtype=torch.bool,
                device=result.columns[0].device if result.columns else "cpu",
            )
        # ONE batched transfer: the live count, the varlen live bytes,
        # the overflow counts and the per-device occupancy
        parts = [live_tail(result, occupied)]
        keys = None
        if isinstance(overflow, dict):
            keys = list(overflow)
            parts += [torch.as_tensor(overflow[k], device=occupied.device).reshape(1)
                      .to(torch.int64) for k in keys]
        elif overflow is not None:
            parts.append(torch.as_tensor(overflow, device=occupied.device).reshape(1)
                         .to(torch.int64))
        per_dev_on = n_dev is not None and n_dev > 0 and result.num_rows > 0
        if per_dev_on:
            split = torch.tensor_split(occupied.to(torch.int64), n_dev)
            parts.append(torch.stack([p.sum() for p in split]))
        host = torch.cat(parts).tolist()
        n_var = sum(1 for c in result.columns if c.is_varlen)
        n_live, varlen_bytes = host[0], host[1:1 + n_var]
        rest = host[1 + n_var:]
        if keys is not None:
            ovf, rest = dict(zip(keys, rest[:len(keys)])), rest[len(keys):]
        elif overflow is not None:
            ovf, rest = rest[0], rest[1:]
        else:
            ovf = None
        if per_dev_on:
            _publish_device_metrics(rest, n_dev, ovf)
        _check_overflow(ovf)
        return _gather_live(result, occupied, n_live, varlen_bytes)
