"""Constant lookup tables on a device, uploaded once.

An op that builds a small table from host values with ``torch.tensor``
on every call copies it from pageable host memory each time: a copy
that waits for the device and cannot run inside a CUDA graph. The ops
ask for their tables here instead; each (values, dtype, device) is
uploaded on first use and the same tensor is returned after. Callers
only read the tables."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=1024)
def _upload(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def device_table(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, uploaded once
    per (values, dtype, device); ``values`` is a (nested) sequence of
    Python numbers."""
    key = tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in values)
    return _upload(key, dtype, torch.device(device))
