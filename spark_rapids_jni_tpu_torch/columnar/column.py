"""Arrow-layout device Column over torch tensors.

The layout is the JAX package's (``columnar/column.py``), so parity with
it is a plain numpy comparison:

- fixed-width: ``data`` is ``[n]`` (or ``[n, 2]`` int64 limbs for
  DECIMAL128, little-endian lo/hi),
- string/binary: ``data`` is ``uint8 [total_bytes]`` payload plus
  ``offsets`` ``int32 [n + 1]``,
- ``validity`` is a ``bool [n]`` mask (True = valid) or None for
  all-valid.

Constructors take ``device=`` and default to ``"cuda"``: with no card a
constructor raises rather than quietly running on the CPU. Ops run on
the device their input tensors are on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .dtypes import DType, STRING


def resolve_device(device) -> torch.device:
    """``torch.device`` for a constructor's ``device=`` argument; raises
    when CUDA is asked for and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build "
            "the column on the CPU"
        )
    return dev


@dataclasses.dataclass
class Column:
    dtype: DType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None  # bool [n]; None => all valid
    offsets: Optional[torch.Tensor] = None  # int32 [n+1]; varlen only

    @property
    def is_varlen(self) -> bool:
        return self.dtype.kind in ("string", "binary")

    def __len__(self) -> int:
        if self.is_varlen:
            return int(self.offsets.shape[0]) - 1
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def validity_or_true(self) -> torch.Tensor:
        if self.validity is not None:
            return self.validity
        return torch.ones(len(self), dtype=torch.bool, device=self.device)

    # ---- constructors ----
    @staticmethod
    def from_numpy(arr, dtype: DType, validity=None, device="cuda") -> "Column":
        dev = resolve_device(device)
        data = torch.from_numpy(np.ascontiguousarray(arr, dtype.np_dtype)).to(dev)
        v = None
        if validity is not None:
            v = torch.from_numpy(np.asarray(validity, np.bool_).copy()).to(dev)
        return Column(dtype, data, v)

    @staticmethod
    def from_pylist(values: Sequence, dtype: DType, device="cuda") -> "Column":
        """Build a column from Python values; None entries become nulls."""
        dev = resolve_device(device)
        n = len(values)
        valid = np.array([v is not None for v in values], np.bool_)
        v = None if valid.all() else torch.from_numpy(valid).to(dev)
        if dtype.kind in ("string", "binary"):
            payload = bytearray()
            offsets = np.zeros(n + 1, np.int32)
            for i, s in enumerate(values):
                if s is not None:
                    payload.extend(s.encode("utf-8") if isinstance(s, str) else bytes(s))
                offsets[i + 1] = len(payload)
            data = np.frombuffer(bytes(payload), np.uint8).copy()
            return Column(
                dtype,
                torch.from_numpy(data).to(dev),
                v,
                torch.from_numpy(offsets).to(dev),
            )
        if dtype.kind == "decimal" and dtype.bits == 128:
            limbs = np.zeros((n, 2), np.uint64)
            for i, x in enumerate(values):
                if x is not None and not (-(1 << 127) <= int(x) < (1 << 127)):
                    raise OverflowError(
                        f"value at row {i} does not fit in DECIMAL128: {x}"
                    )
                ux = int(x if x is not None else 0) & ((1 << 128) - 1)
                limbs[i, 0] = ux & 0xFFFFFFFFFFFFFFFF
                limbs[i, 1] = ux >> 64
            return Column(dtype, torch.from_numpy(limbs.view(np.int64)).to(dev), v)
        fill = False if dtype.kind == "bool" else 0
        host = np.array([fill if x is None else x for x in values], dtype.np_dtype)
        return Column(dtype, torch.from_numpy(host).to(dev), v)

    # ---- host round trip (tests / oracles) ----
    def to_pylist(self):
        valid = self.validity_or_true().cpu().numpy()
        if self.is_varlen:
            data = self.data.cpu().numpy().tobytes()
            offs = self.offsets.cpu().numpy()
            out = []
            for i in range(len(self)):
                if not valid[i]:
                    out.append(None)
                elif self.dtype.kind == "string":
                    out.append(
                        data[offs[i] : offs[i + 1]].decode("utf-8", errors="replace")
                    )
                else:
                    out.append(data[offs[i] : offs[i + 1]])
            return out
        host = self.data.cpu().numpy()
        if self.dtype.kind == "decimal" and self.dtype.bits == 128:
            out = []
            u = host.view(np.uint64)
            for i in range(len(self)):
                if not valid[i]:
                    out.append(None)
                    continue
                ux = int(u[i, 0]) | (int(u[i, 1]) << 64)
                if ux >= 1 << 127:
                    ux -= 1 << 128
                out.append(ux)
            return out
        if self.dtype.kind == "bool":
            return [bool(host[i]) if valid[i] else None for i in range(len(self))]
        return [host[i].item() if valid[i] else None for i in range(len(self))]

    def string_lengths(self) -> torch.Tensor:
        """int32 [n] byte length of each string (0 for nulls)."""
        if not self.is_varlen:
            raise TypeError(f"string_lengths of a {self.dtype} column")
        lens = self.offsets[1:] - self.offsets[:-1]
        if self.validity is not None:
            lens = torch.where(self.validity, lens, torch.zeros_like(lens))
        return lens


def make_string_column(
    data: torch.Tensor, offsets: torch.Tensor, validity: Optional[torch.Tensor] = None
) -> Column:
    return Column(STRING, data, validity, offsets)
