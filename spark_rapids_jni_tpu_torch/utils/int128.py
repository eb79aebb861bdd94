"""Unsigned 128-bit arithmetic on (lo, hi) limb pairs (PyTorch twin of
the JAX package's ``utils/int128.py``).

torch has almost no ``uint64``: addition, right shift and most other
ops are not implemented for it. So every limb here is an ``int64``
tensor holding the same 64 bits. Addition, subtraction, multiplication,
the bitwise ops and the left shift wrap identically on both; the three
places where signedness shows are written out:

- unsigned compare ``ult``: flip the sign bit of both sides, then
  compare signed,
- logical right shift ``lsr``: arithmetic shift, then mask off the
  copies of the sign bit,
- constants at or above 2^63: ``s64`` gives the int64 holding their
  bits.

A limb may also be a Python int in that int64 form (a constant); every
function here accepts it where a tensor broadcasts, so constants need
no device. All functions are elementwise over tensors of any shape.
"""

from __future__ import annotations

import torch

from .consts import device_table

SIGN = -(1 << 63)  # int64 bits of 2^63
M32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1


def s64(v: int) -> int:
    """The int64 value holding the low 64 bits of ``v``."""
    v &= _U64
    return v - (1 << 64) if v >> 63 else v


def lsr(x, k: int):
    """Logical right shift of 64-bit limbs by a static ``k`` in [0, 63]."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a, b):
    """Unsigned a < b of 64-bit limbs."""
    return (a ^ SIGN) < (b ^ SIGN)


def const(value: int):
    """A u128 constant as Python-int limbs (no tensor, no device)."""
    v = int(value) & ((1 << 128) - 1)
    return (s64(v), s64(v >> 64))


def _limb(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)  # integer tensors keep their low 64 bits
    return torch.tensor(s64(int(x)), dtype=torch.int64, device=device)


def u128(lo, hi, device="cuda"):
    """A u128 from its two limbs: integer tensors (their bits kept, as
    int64) or Python ints (an int64 tensor on ``device``)."""
    return (_limb(lo, device), _limb(hi, device))


def from_int(value: int, shape=(), device="cuda"):
    """``value`` mod 2^128 as limb tensors of ``shape`` on ``device``."""
    lo, hi = const(value)
    return (
        torch.full(shape, lo, dtype=torch.int64, device=device),
        torch.full(shape, hi, dtype=torch.int64, device=device),
    )


def zeros(shape, device="cuda"):
    return from_int(0, shape, device)


def mul64(a, b):
    """u64 x u64 -> u128 (full product), via 32-bit half products."""
    a0, a1 = a & M32, lsr(a, 32)
    b0, b1 = b & M32, lsr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = lsr(p00, 32) + (p01 & M32) + (p10 & M32)
    lo = (p00 & M32) | (mid << 32)
    hi = p11 + lsr(p01, 32) + lsr(p10, 32) + lsr(mid, 32)
    return (lo, hi)


def add(a, b):
    """u128 + u128 (mod 2^128)."""
    lo = a[0] + b[0]
    carry = ult(lo, a[0]).to(torch.int64)
    return (lo, a[1] + b[1] + carry)


def add_u64(a, b):
    lo = a[0] + b
    carry = ult(lo, a[0]).to(torch.int64)
    return (lo, a[1] + carry)


def sub(a, b):
    """u128 - u128 (mod 2^128)."""
    lo = a[0] - b[0]
    borrow = ult(a[0], b[0]).to(torch.int64)
    return (lo, a[1] - b[1] - borrow)


def neg(a):
    return add_u64((~a[0], ~a[1]), 1)


def mul_u64(a, m):
    """u128 * u64 -> u128 (mod 2^128)."""
    lo_lo, lo_hi = mul64(a[0], m)
    hi_lo, _ = mul64(a[1], m)
    return (lo_lo, lo_hi + hi_lo)


def lt(a, b):
    return ult(a[1], b[1]) | ((a[1] == b[1]) & ult(a[0], b[0]))


def gt(a, b):
    return lt(b, a)


def le(a, b):
    return ~gt(a, b)


def ge(a, b):
    return ~lt(a, b)


def eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def is_zero(a):
    return (a[0] == 0) & (a[1] == 0)


def where(cond, a, b):
    return (torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1]))


def to_signed_limbs(a, negative):
    """(lo, hi) magnitude + sign -> two's-complement int64 [..., 2] limbs
    matching the DECIMAL128 storage layout of Column."""
    m = where(negative, neg(a), a)
    return torch.stack([m[0], m[1]], dim=-1)


def from_signed_limbs(limbs):
    """int64 [..., 2] two's-complement -> (magnitude u128, negative mask)."""
    lo, hi = limbs[..., 0], limbs[..., 1]
    negative = hi < 0
    mag = where(negative, neg((lo, hi)), (lo, hi))
    return mag, negative


# powers of ten 10^0 .. 10^38 as host-side python ints
POW10 = tuple(10**i for i in range(39))


def pow10_table(device="cuda"):
    """(lo[39], hi[39]) int64 limb tensors of 10^0..10^38 on ``device``."""
    lo = device_table([s64(p) for p in POW10], torch.int64, device)
    hi = device_table([p >> 64 for p in POW10], torch.int64, device)
    return lo, hi


def digit_count(a):
    """Number of decimal digits of a u128 magnitude (0 -> 0 digits),
    by comparing against the pow10 table."""
    plo, phi = pow10_table(a[0].device)
    lo, hi = a[0][..., None], a[1][..., None]
    ge_i = ult(phi, hi) | ((hi == phi) & ~ult(lo, plo))
    return ge_i.sum(dim=-1, dtype=torch.int32)
