"""Hash-partition shuffle over a device mesh (the port's twin of the JAX
package's ``parallel/shuffle.py``).

Spark's HashPartitioning places row r on shard ``murmur3(keys[r], 42)
pmod P``. Each shard packs its rows into ``[P, C]`` send buckets (C =
per-destination capacity), ``exchange.all_to_all`` swaps bucket j with
shard j, and receive-side validity is ``slot < count``. Padding trades
bytes for a fixed shape: no size is read to the host, so a chain of
exchanges runs inside one CUDA graph when every shard shares a card.

The placement hash of fixed-width keys is the hand-written Murmur3
kernel (``kernels/murmur3.py``): the key planes of every shard on one
device are hashed by one launch. Keys Spark hashes as bytes (strings,
DECIMAL128 above precision 18) take the plain chain, as in
``spark_hash.hash_columns``.

Inputs are a ``mesh.ShardedTable`` or a Table (cut into P row blocks,
``mesh.shard_table``); occupancy masks are per-shard lists or one
global tensor. Outputs are a ShardedTable of ``P * C`` rows per shard,
a per-shard list of occupancy masks and an int32 overflow count on the
first mesh device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..columnar import strings as strs
from ..columnar.column import Column
from ..columnar.table import Table
from ..ops._strategy import fused
from ..runtime.errors import CapacityExceededError
from . import exchange, spark_hash
from .mesh import Mesh, ShardedTable, axis_size, shard_table, shard_vector


def _pack_stacked(arrays, pids, n_src: int, num_parts: int, capacity: int):
    """The bucket pack of ``n_src`` shards on one device at once:
    ``arrays`` and ``pids`` hold the shards' rows back to back (equal
    counts). One stable sort by (source shard, partition id) gives every
    shard's rows the order its own pack would (``_pack_buckets``).
    Returns (packed arrays ``[n_src, num_parts, capacity, ...]``, counts
    int32 ``[n_src, num_parts]``)."""
    dev = pids.device
    n_all = pids.shape[0]
    n = n_all // max(n_src, 1)
    bins = num_parts + 1  # the sentinel id num_parts has a count of its own
    row = torch.arange(n_all, dtype=torch.int64, device=dev)
    key = (row // max(n, 1)) * bins + pids.to(torch.int64)
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    counts_all = torch.zeros(n_src * bins, dtype=torch.int64, device=dev)
    counts_all.scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts_all, 0) - counts_all
    slot = row - starts[key_sorted]
    src, pid = key_sorted // bins, key_sorted % bins
    keep = (pid < num_parts) & (slot < capacity)
    spare = n_src * num_parts * capacity
    flat = torch.where(keep, (src * num_parts + pid) * capacity + slot, spare)
    packed = []
    for a in arrays:
        buf = torch.zeros((spare + 1,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        buf[flat] = a[order]
        packed.append(buf[:-1].view((n_src, num_parts, capacity) + tuple(a.shape[1:])))
    counts = counts_all.view(n_src, bins)[:, :num_parts].to(torch.int32)
    return packed, counts


def _pack_buckets(arrays, pids, num_parts: int, capacity: int):
    """Pack one shard's rows into [num_parts, capacity] send buckets:
    row i of the stable sort by partition id lands in bucket
    pids_sorted[i] at slot i - start(pids_sorted[i]). Rows routed to the
    sentinel id ``num_parts`` (dead rows) and rows past a bucket's
    capacity are dropped: their scatter index is a spare slot past the
    end, cut off afterwards. Returns (packed arrays, counts int32
    [num_parts])."""
    packed, counts = _pack_stacked(arrays, pids, 1, num_parts, capacity)
    return [p[0] for p in packed], counts[0]


def _shard_list(table, mesh: Mesh, axis) -> Tuple[ShardedTable, int]:
    """(ShardedTable, num_parts), with the mesh-axis checks."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
    num_parts = axis_size(mesh, axis)
    if num_parts != mesh.size:
        raise NotImplementedError(
            f"exchange over mesh axis {axis} ({num_parts} of {mesh.size} devices): the "
            "port exchanges over the whole mesh")
    st = shard_table(table, mesh)
    sizes = {s.num_rows for s in st.shards}
    if len(sizes) > 1:
        raise ValueError(f"shards hold unequal row counts {sorted(sizes)}; pad them first")
    return st, num_parts


def hash_shuffle(
    table,
    key_indices: Sequence[int],
    mesh: Mesh,
    axis="data",
    capacity: Optional[int] = None,
    occupied=None,
    string_widths: Optional[dict] = None,
    compress: bool = False,
    wire_widths: Optional[dict] = None,
    salt: int = 0,
):
    """Exchange rows so that row r lands on shard
    ``murmur3(keys[r], 42) pmod P``.

    ``salt`` (default 0, the documented placement) re-seeds the
    partition hash (``spark_hash.salted_seed``): equal keys still
    co-locate, the distinct-key -> shard assignment re-rolls. A salted
    exchange is not co-partitioned with an unsalted one.

    Returns ``(padded ShardedTable, occupied, overflow)``: ``P * C``
    rows per shard whose per-shard ``occupied`` masks mark live rows,
    plus ``overflow``, an int32 count on the first mesh device of rows
    lost to the bounded contract (bucket drops plus pinned-width string
    truncations). Zero means the exchange was exact; ``collect_*``
    raises on nonzero.

    ``capacity`` is the per-destination bucket size; the default, the
    whole local row count, can never overflow. ``occupied`` marks live
    input rows; dead rows are dropped. String columns ride the exchange
    as padded char matrices (uint8 planes + lengths) and repack per
    shard; ``string_widths`` pins their width per column (without it,
    one host sync reads the global max length; inside a fused chain a
    pin is required). A pinned width must bound the byte lengths:
    outside a fused chain a longer live string raises, inside one it
    counts into ``overflow``.

    Wire compression: ``compress=True`` shrinks integer planes to the
    narrowest width their values span (one host min/max read; skipped
    inside a fused chain). ``wire_widths`` (col index -> bits in {8,
    16, 32}) pins integer planes to a narrow wire dtype with no host
    sync; a live value that does not survive the round trip counts into
    ``overflow``."""
    st, num_parts = _shard_list(table, mesh, axis)
    occ = None if occupied is None else shard_vector(occupied, mesh, st.num_rows)
    arrays, slots, capacity, trunc, wire_casts = _plan_exchange(
        st, capacity, occ, string_widths, compress, wire_widths,
    )
    pids = _hash_pids(st, key_indices, arrays, slots, num_parts,
                      seed=spark_hash.salted_seed(salt))
    return _exchange(st, arrays, slots, pids, num_parts, capacity, occ, trunc,
                     wire_casts=wire_casts)


def _device_groups(mesh: Mesh):
    """Shard indices grouped by device, in mesh order."""
    groups = {}
    for s, d in enumerate(mesh.devices):
        groups.setdefault(str(d), []).append(s)
    return list(groups.values())


def _cat_validity(parts):
    if all(v is None for v in parts):
        return None
    return torch.cat([v for v in parts])


def _hash_pids(st: ShardedTable, key_indices, arrays, slots, num_parts: int,
               seed: int = spark_hash.DEFAULT_SEED):
    """Spark HashPartitioning over the key planes: one int32 pid vector
    per shard. The key planes of every shard on one device hash in one
    pass: fixed-width keys through one Murmur3 kernel launch (its plain
    version on the CPU), keys Spark hashes as bytes (strings, DECIMAL128
    above precision 18) through the plain chain. ``seed`` is the
    (possibly salted) uint32 seed."""
    nullable = {ki: any(x.columns[ki].validity is not None for x in st.shards)
                for ki in key_indices}

    def key_part(s, ki):
        kind, pos = slots[ki]
        c = st.shards[s].columns[ki]
        v = c.validity_or_true() if nullable[ki] else None
        if kind == "fixed":
            data = arrays[s][pos]
            if data.dtype != c.dtype.torch_dtype and data.dim() == 1:
                data = data.to(c.dtype.torch_dtype)  # compressed wire plane
            return (data, v)
        return (arrays[s][pos], arrays[s][pos + 1], v)

    cols0 = [st.shards[0].columns[ki] for ki in key_indices]
    on_kernel = all(slots[ki][0] == "fixed" and not spark_hash.is_bytes_hashed_column(c)
                    for ki, c in zip(key_indices, cols0))
    hashes = [None] * len(st.shards)
    for members in _device_groups(st.mesh):
        cols = []
        for ki, c0 in zip(key_indices, cols0):
            parts = [key_part(s, ki) for s in members]
            if len(parts[0]) == 2:
                cols.append(Column(c0.dtype, torch.cat([p[0] for p in parts]),
                                   _cat_validity([p[1] for p in parts])))
            else:
                cols.append((torch.cat([p[0] for p in parts]).to(torch.int32),
                             torch.cat([p[1] for p in parts]),
                             _cat_validity([p[2] for p in parts])))
        if on_kernel:
            from ..kernels import murmur3

            h = murmur3.hash_columns(Table(cols), seed)
        else:
            n = sum(st.shards[s].num_rows for s in members)
            h = torch.full((n,), spark_hash._i32(seed), dtype=torch.int32,
                           device=st.mesh.devices[members[0]])
            for c in cols:
                if isinstance(c, Column):
                    h = spark_hash.column_hash_update(c, h)
                else:
                    h = spark_hash.hash_string_update(h, *c)
        sizes = [st.shards[s].num_rows for s in members]
        for s, part in zip(members, torch.split(h, sizes)):
            hashes[s] = part
    return [spark_hash.pmod(h, num_parts) for h in hashes]


def partition_exchange(
    table,
    pids,
    mesh: Mesh,
    axis="data",
    capacity: Optional[int] = None,
    occupied=None,
    string_widths: Optional[dict] = None,
    compress: bool = False,
    wire_widths: Optional[dict] = None,
):
    """Exchange rows to shard ``pids[r]`` (int32 in [0, P); a global
    tensor or per-shard list): the exchange core under ``hash_shuffle``
    with caller-chosen placement (range partitioning for a distributed
    ORDER BY, custom repartitioning). Same contract and returns as
    ``hash_shuffle``."""
    st, num_parts = _shard_list(table, mesh, axis)
    occ = None if occupied is None else shard_vector(occupied, mesh, st.num_rows)
    arrays, slots, capacity, trunc, wire_casts = _plan_exchange(
        st, capacity, occ, string_widths, compress, wire_widths,
    )
    pid_list = shard_vector(pids, mesh, st.num_rows)
    return _exchange(st, arrays, slots, pid_list, num_parts, capacity, occ, trunc,
                     wire_casts=wire_casts)


_INT_WIRE_KINDS = ("int", "date", "timestamp", "bool", "decimal")
# sprtcheck: guarded-by=frozen
_WIRE_DT = {8: torch.int8, 16: torch.int16, 32: torch.int32}


def _shrink_wire_planes(st: ShardedTable, arrays, slots):
    """Wire compression at plan time: downcast integer planes to the
    narrowest signed width their values span over every shard (one host
    read of all the planes' ranges). Returns (arrays, wire_casts) where
    wire_casts maps plane pos -> storage dtype for the upcast after the
    exchange. Skipped inside a fused chain (the width would be
    data-dependent)."""
    wire_casts = {}
    arrays = [list(a) for a in arrays]
    if fused():
        return arrays, wire_casts
    candidates = []
    for i, c in enumerate(st.shards[0].columns):
        kind, pos = slots[i]
        if kind != "fixed":
            continue
        a = arrays[0][pos]
        if (c.dtype.kind not in _INT_WIRE_KINDS or a.dim() != 1 or a.element_size() <= 1
                or st.num_rows == 0):
            continue
        candidates.append(pos)
    if not candidates:
        return arrays, wire_casts
    first = st.mesh.devices[0]
    parts = []
    for p in candidates:
        planes = [arrays[s][p] for s in range(len(arrays)) if arrays[s][p].numel()]
        lo = torch.stack([a.min().to(torch.int64).to(first) for a in planes]).min()
        hi = torch.stack([a.max().to(torch.int64).to(first) for a in planes]).max()
        parts.append(torch.stack([lo, hi]))
    stats = torch.stack(parts).tolist()  # ONE host read for every plane
    for (lo, hi), pos in zip(stats, candidates):
        a = arrays[0][pos]
        for bits in (8, 16, 32):
            wire = _WIRE_DT[bits]
            info = torch.iinfo(wire)
            if info.min <= lo and hi <= info.max:
                if torch.empty((), dtype=wire).element_size() < a.element_size():
                    wire_casts[pos] = a.dtype
                    for s in range(len(arrays)):
                        arrays[s][pos] = arrays[s][pos].to(wire)
                break
    return arrays, wire_casts


def _wire_pin_planes(st: ShardedTable, arrays, slots, wire_widths, occupied, trunc):
    """Integer wire compression with no host sync: downcast pinned
    planes to the declared width on each shard, counting live rows whose
    value does not survive the round trip into the overflow total (the
    guarded-pin contract of ``string_widths``)."""
    wire_casts = {}
    arrays = [list(a) for a in arrays]
    for ci, bits in wire_widths.items():
        kind, pos = slots[ci]
        c0 = st.shards[0].columns[ci]
        if kind != "fixed" or c0.dtype.kind not in _INT_WIRE_KINDS:
            raise ValueError(f"wire_widths[{ci}]: column is not an integer plane")
        if bits not in _WIRE_DT:
            raise ValueError(f"wire_widths[{ci}]={bits}: use 8, 16 or 32")
        a0 = arrays[0][pos]
        if a0.dim() != 1 or torch.empty((), dtype=_WIRE_DT[bits]).element_size() \
                >= a0.element_size():
            continue  # multi-limb or no narrower than storage: skip
        bad_counts = []
        for s in range(len(arrays)):
            a = arrays[s][pos]
            wire = a.to(_WIRE_DT[bits])
            live_bad = wire.to(a.dtype) != a
            if occupied is not None:
                live_bad = live_bad & occupied[s]
            v = st.shards[s].columns[ci].validity
            if v is not None:
                live_bad = live_bad & v
            bad_counts.append(live_bad.sum().to(torch.int32))
            arrays[s][pos] = wire
        trunc = trunc + exchange.psum(st.mesh, bad_counts).to(torch.int32)
        wire_casts[pos] = a0.dtype
    return arrays, wire_casts, trunc


# sprtcheck: host-side — its callers run it only outside a fused chain (not fused())
def _global_max(mesh: Mesh, parts) -> int:
    """Max over every shard's int tensor (0 when all are empty): one
    host read."""
    first = mesh.devices[0]
    vals = [p.max().to(torch.int64).to(first) for p in parts if p.numel()]
    return int(torch.stack(vals).max()) if vals else 0


def _plan_exchange(st: ShardedTable, capacity, occupied, string_widths, compress=False,
                   wire_widths=None):
    """Shared prologue: per-shard exchange planes (fixed-width -> the
    data tensor; strings -> a uint8 char matrix at one width for every
    shard + lengths). Returns (arrays: per shard a list of planes,
    slots: col -> (kind, first plane), capacity, trunc: int32 count of
    live strings past a pinned width, wire_casts)."""
    mesh = st.mesh
    n_local = st.shards[0].num_rows
    if capacity is None:
        capacity = n_local
    P = len(st.shards)
    arrays = [[] for _ in range(P)]
    slots = {}
    trunc = torch.zeros((), dtype=torch.int32, device=mesh.devices[0])
    for i, c0 in enumerate(st.shards[0].columns):
        if not c0.is_varlen:
            slots[i] = ("fixed", len(arrays[0]))
            for s in range(P):
                arrays[s].append(st.shards[s].columns[i].data)
            continue
        L = None if string_widths is None else string_widths.get(i)
        if L is not None:
            lens = [st.shards[s].columns[i].string_lengths() for s in range(P)]
            if occupied is not None:
                # dead rows never ride the exchange: their width does not
                # constrain the pin
                lens = [torch.where(occupied[s], ln, 0) for s, ln in enumerate(lens)]
            if n_local:
                trunc = trunc + exchange.psum(
                    mesh, [(ln > L).sum().to(torch.int32) for ln in lens])
                if not fused():
                    max_len = _global_max(mesh, lens)
                    if max_len > L:
                        raise CapacityExceededError(
                            f"exchange: string column {i} holds {max_len}-byte strings > "
                            f"pinned width {L}; truncation would corrupt both routing and "
                            f"values — raise string_widths[{i}]",
                            stage="string_width", needed=max_len, granted=L,
                        )
        else:
            if fused():
                raise TypeError(
                    f"exchange: string column {i} has a data-dependent char-matrix width; "
                    f"pass string_widths={{{i}: <max_bytes>}} (an upper bound on its byte "
                    "lengths) to keep the exchange sync-free")
            # the global max over every shard (one host read)
            max_len = _global_max(mesh, [st.shards[s].columns[i].string_lengths()
                                         for s in range(P)])
            L = strs.bucket_length(max(max_len, 1))
        slots[i] = ("str", len(arrays[0]))
        for s in range(P):
            chars, lengths = strs.to_char_matrix(st.shards[s].columns[i], L)
            # uint8 on the wire: positions past each row's length are
            # never read downstream, so the -1 padding may wrap
            arrays[s].append((chars & 0xFF).to(torch.uint8))
            arrays[s].append(lengths)
    wire_casts = {}
    if wire_widths:
        arrays, wire_casts, trunc = _wire_pin_planes(st, arrays, slots, wire_widths, occupied,
                                                     trunc)
    if compress:
        shrunk, auto_casts = _shrink_wire_planes(st, arrays, slots)
        # pinned planes keep their pin; auto-shrink covers the rest
        for pos, dt in auto_casts.items():
            if pos not in wire_casts:
                wire_casts[pos] = dt
                for s in range(P):
                    arrays[s][pos] = shrunk[s][pos]
    return arrays, slots, capacity, trunc, wire_casts


def _exchange(st: ShardedTable, arrays, slots, pids, num_parts: int, capacity: int, occupied,
              trunc, as_planes: bool = False, wire_casts: Optional[dict] = None):
    """Pack every shard's planes by ``pids``, ``all_to_all`` them, and
    rebuild the padded output: a ShardedTable + per-shard occupancy +
    the overflow count (bucket drops + string truncations).

    ``as_planes=True`` skips the Table rebuild and returns ``(out,
    slots, vpos, occ, overflow)`` with ``out`` the received planes per
    shard: the distributed operators that run a shard-local kernel
    right after the exchange (join, sort) rebuild their own tables."""
    mesh = st.mesh
    P = len(st.shards)
    # only columns that carry nulls pay for a validity exchange; dead
    # padding slots are already excluded by the occupied mask
    null_cols = tuple(i for i in range(st.num_columns)
                      if any(s.columns[i].validity is not None for s in st.shards))
    planes, pid_l = [], []
    for s in range(P):
        shard = st.shards[s]
        valids = [shard.columns[i].validity_or_true() for i in null_cols]
        pid = pids[s].to(torch.int64).to(mesh.devices[s])
        if occupied is not None:
            # dead input rows route to the sentinel partition num_parts:
            # the pack drops them and the counts leave them out
            pid = torch.where(occupied[s], pid, num_parts)
        planes.append(list(arrays[s]) + valids)
        pid_l.append(pid)
    n_planes = len(planes[0])
    if mesh.shared_device is not None:
        # every shard on one device: one pack for all of them, the send
        # buffers stacked [P_src, P_dst, C, ...]
        packed, counts = _pack_stacked(
            [torch.cat([planes[s][k] for s in range(P)]) for k in range(n_planes)],
            torch.cat(pid_l), P, num_parts, capacity)
        recv = [exchange.all_to_all(mesh, pk) for pk in packed]
        recv_counts = exchange.all_to_all(mesh, counts.reshape(P, num_parts, 1))
        counts = list(counts.unbind(0))
    else:
        packed, counts = [], []
        for s in range(P):
            pk, cnt = _pack_buckets(planes[s], pid_l[s], num_parts, capacity)
            packed.append(pk)
            counts.append(cnt)
        recv = [exchange.all_to_all(mesh, [packed[s][k] for s in range(P)])
                for k in range(n_planes)]
        recv_counts = exchange.all_to_all(mesh, [c.reshape(num_parts, 1) for c in counts])
    dropped = [torch.clamp(c - capacity, min=0).sum().to(torch.int32) for c in counts]
    out, occ = [], []
    for j, dev in enumerate(mesh.devices):
        # receive-side validity must not resurrect dropped slots
        rc = torch.clamp(recv_counts[j].reshape(num_parts), max=capacity)
        slot = torch.arange(capacity, dtype=torch.int32, device=dev)
        occ.append((slot[None, :] < rc[:, None]).reshape(-1))
        planes = [r[j].reshape((num_parts * capacity,) + tuple(r[j].shape[2:])) for r in recv]
        for pos, dt in (wire_casts or {}).items():
            # undo the wire shrink: consumers expect the storage dtype
            planes[pos] = planes[pos].to(dt)
        out.append(planes)
    overflow = exchange.psum(mesh, dropped).to(torch.int32) + trunc
    n_arrays = len(arrays[0])
    vpos = {ci: n_arrays + k for k, ci in enumerate(null_cols)}
    if as_planes:
        return out, slots, vpos, occ, overflow
    shards = []
    for j in range(P):
        cols = []
        for i, c in enumerate(st.shards[0].columns):
            v = out[j][vpos[i]] if i in vpos else None
            kind, pos = slots[i]
            if kind == "fixed":
                cols.append(Column(c.dtype, out[j][pos], v))
            else:
                chars, lengths = out[j][pos], out[j][pos + 1]
                cols.append(strs.from_char_matrix(
                    chars.to(torch.int32), lengths, v,
                    total=chars.shape[0] * chars.shape[1],
                    dtype=c.dtype,  # BINARY survives the round trip
                ))
        shards.append(Table(cols, st.names))
    return ShardedTable(shards, mesh), occ, overflow
