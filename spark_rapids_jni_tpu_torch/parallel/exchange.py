"""The exchange interface: every collective the distributed operators
use, and nothing else (the JAX package's ``shard_map`` bodies call
``jax.lax.all_to_all`` and ``jax.lax.psum``; these are their twins).

One implementation, single-controller like ``shard_map``: this process
drives every shard of the mesh. A bucket bound for another device moves
with ``.to(device, non_blocking=True)`` (a peer copy between cards);
when source and destination are one device the exchange is an index
permutation on that device, with no copy through the host. Values stay
on the devices: nothing here reads a tensor to the host, so the
exchange runs inside a CUDA graph when every shard shares one card.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def all_to_all(mesh, buckets) -> List[torch.Tensor]:
    """``buckets[i]`` is shard i's ``[P, C, ...]`` send buffer on
    ``mesh.devices[i]``; returns the ``[P, C, ...]`` receive buffers,
    ``out[j][i] = buckets[i][j]`` on ``mesh.devices[j]`` (source-major,
    ``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``).
    When every shard shares one device, ``buckets`` may also be the send
    buffers stacked as one ``[P, P, C, ...]`` tensor."""
    P = mesh.size
    if len(buckets) != P:
        raise ValueError(f"{len(buckets)} send buffers for a {P}-device mesh")
    dev = mesh.shared_device
    if torch.is_tensor(buckets) and dev is None:
        raise ValueError("stacked send buffers need a mesh whose shards share one device")
    if dev is not None:
        # [P_src, P_dst, C, ...] -> [P_dst, P_src, C, ...]: one permuting copy
        stacked = buckets if torch.is_tensor(buckets) else torch.stack(list(buckets))
        return list(stacked.transpose(0, 1).contiguous().unbind(0))
    return [
        torch.stack([buckets[i][j].to(d, non_blocking=True) for i in range(P)])
        for j, d in enumerate(mesh.devices)
    ]


def psum(mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of one value per shard (``jax.lax.psum``), kept on the first
    mesh device."""
    first = mesh.devices[0]
    return torch.stack([v.to(first, non_blocking=True) for v in values]).sum(0)

