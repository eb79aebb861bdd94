"""Device mesh and row-sharded tables (the port's twin of the JAX
package's ``parallel/mesh.py``).

A ``Mesh`` is an ordered array of torch devices with named axes and a
shape, like ``jax.sharding.Mesh``. ``make_mesh(n)`` takes the first
``n`` CUDA devices and raises past the count, as ``jax.devices()``
bounds the JAX mesh. A Mesh built from an explicit device list may name
one device several times: that is how P shards live on one card (the
role ``--xla_force_host_platform_device_count=8`` plays for the JAX
package's CPU tests), and ``Mesh(["cpu"] * 8)`` is the port's CPU
stand-in.

How a row-sharded table is held: a ``ShardedTable`` is a list of P
per-shard Tables, shard i on ``mesh.devices[i]``, in global row order
(shard i holds global rows [i * n/P, (i+1) * n/P) of a table it was cut
from). A row-sharded vector (an occupancy mask) is a list of P tensors
in the same layout. Each shard's varlen columns carry their own
offsets; a shard cut inside a fused chain (no host sync for the
payload boundaries) keeps the whole payload with absolute offsets into
it, which every op reads the same way.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.column import Column, resolve_device
from ..columnar.table import Table
from ..ops._strategy import fused


def _indexed(dev) -> torch.device:
    """A mesh device: ``cuda`` as the current card's ``cuda:<i>``, the
    form tensors report, so a mesh device compares equal to its tensors'
    device. A CUDA device with no card raises."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Ordered devices with named axes (``shape`` maps axis -> size)."""

    def __init__(self, devices, axis_names: Tuple[str, ...] = ("data",), shape=None):
        devs = tuple(_indexed(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.axis_names = tuple(str(a) for a in axis_names)
        if shape is None:
            shape = (len(devs),) + (1,) * (len(self.axis_names) - 1)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.axis_names) or math.prod(shape) != len(devs):
            raise ValueError(f"mesh shape {shape} does not fit {len(devs)} devices "
                             f"over axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shared_device(self) -> Optional[torch.device]:
        """The one device every shard lives on, or None."""
        first = self.devices[0]
        return first if all(d == first for d in self.devices) else None

    def _key(self):
        return (tuple(str(d) for d in self.devices), self.axis_names,
                tuple(self.shape.values()))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axes={self.shape})"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("data",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Mesh over the first ``n_devices`` CUDA devices (default all).
    With several axis names, ``shape`` gives the per-axis sizes."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices is None:
        n_devices = have
    if n_devices > have or n_devices < 1:
        raise ValueError(f"need {n_devices} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n_devices)], axis_names, shape)


def axis_size(mesh: Mesh, axis) -> int:
    """Total devices along one axis name or a tuple of axis names
    (hierarchical meshes flatten to their product axis)."""
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


class RowSharding:
    """Placement descriptor: rows split into P contiguous blocks over
    ``mesh[axis]`` (the JAX package's ``NamedSharding(mesh, P(axis))``)."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        self.mesh, self.axis = mesh, axis


class Replicated:
    """Placement descriptor: a full copy on every mesh device."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh


def row_sharding(mesh: Mesh, axis: str = "data") -> RowSharding:
    """Shard the leading (row) dimension over the given mesh axis."""
    return RowSharding(mesh, axis)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


class ShardedTable:
    """P per-shard Tables of one logical table, shard i on
    ``mesh.devices[i]`` (see the module docstring)."""

    def __init__(self, shards: Sequence[Table], mesh: Mesh):
        shards = list(shards)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a {mesh.size}-device mesh")
        self.shards = shards
        self.mesh = mesh

    @property
    def names(self):
        return self.shards[0].names

    @property
    def num_columns(self) -> int:
        return self.shards[0].num_columns

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.shards)

    @property
    def dtypes(self):
        return tuple(c.dtype for c in self.shards[0].columns)

    def gather(self) -> Table:
        """One Table of every shard's rows in order, on the first mesh
        device (no host sync)."""
        return concat_tables(self.shards, self.mesh.devices[0])


def _cut_column(c: Column, bounds: List[int], pbounds, s: int, dev) -> Column:
    lo, hi = bounds[s], bounds[s + 1]
    v = None if c.validity is None else c.validity[lo:hi].to(dev, non_blocking=True)
    if not c.is_varlen:
        return Column(c.dtype, c.data[lo:hi].to(dev, non_blocking=True), v)
    if pbounds is None:
        # absolute offsets into the whole payload: no host sync
        return Column(c.dtype, c.data.to(dev, non_blocking=True), v,
                      c.offsets[lo:hi + 1].to(dev, non_blocking=True))
    base, end = pbounds[s], pbounds[s + 1]
    return Column(c.dtype, c.data[base:end].to(dev, non_blocking=True), v,
                  (c.offsets[lo:hi + 1] - base).to(dev, non_blocking=True))


def shard_table(table, mesh: Mesh) -> ShardedTable:
    """Row-shard ``table`` over ``mesh``: P contiguous blocks of n/P
    rows, block i moved to ``mesh.devices[i]``. A ShardedTable on the
    same mesh passes through. Outside a fused chain each shard's
    varlen payload is cut to its own bytes (one host read of the P + 1
    payload boundaries per varlen column)."""
    if isinstance(table, ShardedTable):
        if table.mesh != mesh:
            raise ValueError(f"table is sharded over {table.mesh}, not {mesh}")
        return table
    P = mesh.size
    n = table.num_rows
    if n % P:
        raise ValueError(f"row count {n} not divisible by the {P}-shard mesh; pad the batch first")
    m = n // P
    bounds = [s * m for s in range(P + 1)]
    pb = {}
    if not fused():
        var = [i for i, c in enumerate(table.columns) if c.is_varlen]
        if var:
            idx = torch.tensor(bounds, device=table.columns[var[0]].offsets.device)
            host = torch.stack([table.columns[i].offsets[idx] for i in var]).tolist()
            pb = dict(zip(var, host))
    shards = []
    for s, dev in enumerate(mesh.devices):
        cols = [_cut_column(c, bounds, pb.get(i), s, dev) for i, c in enumerate(table.columns)]
        shards.append(Table(cols, table.names))
    return ShardedTable(shards, mesh)


def shard_vector(v, mesh: Mesh, n_rows: int, dtype=torch.bool, fill=True) -> List[torch.Tensor]:
    """A row-sharded vector as P per-shard tensors: None becomes
    ``fill`` everywhere, a list passes through, a global tensor is cut
    into P blocks."""
    P = mesh.size
    m = n_rows // P
    if v is None:
        return [torch.full((m,), fill, dtype=dtype, device=d) for d in mesh.devices]
    if isinstance(v, (list, tuple)):
        if len(v) != P:
            raise ValueError(f"{len(v)} shard vectors for a {P}-device mesh")
        return list(v)
    return [v[s * m:(s + 1) * m].to(d, non_blocking=True) for s, d in enumerate(mesh.devices)]


def replicate_table(table: Table, mesh: Mesh) -> List[Table]:
    """One copy of ``table`` per mesh device (the same tensors where
    the devices repeat)."""
    out, seen = [], {}
    for d in mesh.devices:
        key = str(d)
        if key not in seen:
            seen[key] = Table([Column(c.dtype, c.data.to(d, non_blocking=True),
                                      None if c.validity is None
                                      else c.validity.to(d, non_blocking=True),
                                      None if c.offsets is None
                                      else c.offsets.to(d, non_blocking=True))
                               for c in table.columns], table.names)
        out.append(seen[key])
    return out


def concat_tables(tables: Sequence[Table], device) -> Table:
    """Rows of ``tables`` (one schema) in order on ``device``, without a
    host sync. A varlen column's used payload bytes ([offsets[0],
    offsets[-1]) of each part) pack back to back into a buffer of the
    parts' summed payload capacity, at shifts computed on the device;
    parts cut from one shared payload (``shard_table`` inside a fused
    chain) keep it once, offsets as they are."""
    device = torch.device(device)
    cols = []
    for parts in zip(*(t.columns for t in tables)):
        c0 = parts[0]
        if any(p.validity is not None for p in parts):
            v = torch.cat([p.validity_or_true().to(device) for p in parts])
        else:
            v = None
        if not c0.is_varlen:
            cols.append(Column(c0.dtype, torch.cat([p.data.to(device) for p in parts]), v))
            continue
        if all(p.data is c0.data for p in parts):
            data = c0.data.to(device)
            offs = [p.offsets[:-1].to(device) for p in parts] + [parts[-1].offsets[-1:].to(device)]
            cols.append(Column(c0.dtype, data, v, torch.cat(offs).to(torch.int32)))
            continue
        total = sum(int(p.data.shape[0]) for p in parts)
        data = torch.zeros(total + 1, dtype=c0.data.dtype, device=device)
        shift = torch.zeros((), dtype=torch.int64, device=device)
        offs = []
        for p in parts:
            d = p.data.to(device)
            o = p.offsets.to(device).to(torch.int64)
            start, end = o[0], o[-1]
            j = torch.arange(d.shape[0], device=device)
            dest = torch.where((j >= start) & (j < end), j - start + shift, total)
            data[dest] = d  # bytes outside the used span land in the spare slot
            offs.append(o[:-1] - start + shift)
            shift = shift + (end - start)
        offs.append(shift.reshape(1))
        cols.append(Column(c0.dtype, data[:total], v, torch.cat(offs).to(torch.int32)))
    return Table(cols, tables[0].names if tables else None)
