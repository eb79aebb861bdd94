"""Signed 256-bit arithmetic on four 64-bit limbs (PyTorch twin of the
JAX package's ``utils/int256.py``, itself the column-wise form of the
reference's ``chunked256``, decimal_utils.cu:31-117).

A "u256" is a tuple ``(l0, l1, l2, l3)``, least-significant limb first,
of int64 tensors holding uint64 bits (see ``int128`` for how unsigned
compares and shifts are written). Values are two's-complement signed
256-bit, like ``chunked256``. Every function is elementwise over whole
columns; a limb may be a Python int constant in int64 form.

Division is the reference's bit-serial long division
(decimal_utils.cu:146-163 ``divide_unsigned``) as a Python loop over
the 256 bit positions, each step a few elementwise ops over all rows.
Power-of-ten division takes the exact reciprocal multiply
(``divmod_pow10``) instead.
"""

from __future__ import annotations

import torch

from . import int128 as u128
from .consts import device_table
from .int128 import lsr, s64, ult


def _device(a):
    for x in a:
        if isinstance(x, torch.Tensor):
            return x.device
    raise TypeError("u256 of constants has no device")


def from_i128_limbs(limbs):
    """int64 [..., 2] two's-complement DECIMAL128 storage -> sign-extended
    u256 (mirrors chunked256(__int128_t), decimal_utils.cu:35-41)."""
    lo, hi = limbs[..., 0], limbs[..., 1]
    ext = hi >> 63  # arithmetic shift: all ones or all zeros
    return (lo, hi, ext, ext)


def to_i128_limbs(a):
    """Truncate to the low 128 bits as int64 [..., 2] storage limbs
    (chunked256::as_128_bits, decimal_utils.cu:108-110)."""
    return torch.stack([a[0], a[1]], dim=-1)


def const(value: int):
    """A u256 constant as Python-int limbs (no tensor, no device)."""
    v = int(value) & ((1 << 256) - 1)
    return tuple(s64(v >> (64 * i)) for i in range(4))


def is_neg(a):
    return a[3] < 0


def add(a, b):
    """256-bit add with a carry chain (mod 2^256)."""
    out = []
    carry = None
    for i in range(4):
        s = a[i] + b[i]
        c1 = ult(s, a[i])
        if carry is not None:
            s2 = s + carry.to(torch.int64)
            c1 = c1 | ult(s2, s)
            s = s2
        out.append(s)
        carry = c1
    return tuple(out)


def add_small(a, inc):
    """a + inc where inc is an int64 tensor (or int) of 0/±1
    (sign-extended)."""
    ext = inc >> 63
    return add(a, (inc, ext, ext, ext))


def neg(a):
    return add_small((~a[0], ~a[1], ~a[2], ~a[3]), 1)


def abs_(a):
    n = is_neg(a)
    return where(n, neg(a), a), n


def where(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def eq(a, b):
    r = a[0] == b[0]
    for i in range(1, 4):
        r = r & (a[i] == b[i])
    return r


def is_zero(a):
    return eq(a, (0, 0, 0, 0))


def lt_unsigned(a, b):
    """a < b treating both as unsigned 256 (chunked256::lt_unsigned)."""
    lt = ult(a[0], b[0])
    for i in range(1, 4):
        lt = ult(a[i], b[i]) | ((a[i] == b[i]) & lt)
    return lt


def ge_unsigned(a, b):
    return ~lt_unsigned(a, b)


def mul(a, b):
    """Schoolbook 4x4 64-bit-limb multiply truncated to 256 bits
    (decimal_utils.cu multiply:124-143), each partial product via the
    32-bit-half decomposition in int128.mul64."""
    r = [None] * 4
    carry = 0
    for i in range(4):
        plo, phi = u128.mul64(a[i], b[0])
        s = plo + carry
        r[i] = s
        carry = phi + ult(s, plo).to(torch.int64)
    for j in range(1, 4):
        carry = 0
        for i in range(4 - j):
            k = i + j
            plo, phi = u128.mul64(a[i], b[j])
            s1 = plo + r[k]
            c1 = ult(s1, plo).to(torch.int64)
            s2 = s1 + carry
            c2 = ult(s2, s1).to(torch.int64)
            r[k] = s2
            carry = phi + c1 + c2
    return tuple(r)


def divmod_u128(n, d_lo, d_hi):
    """Unsigned long division: u256 n / u128 divisor (d_lo, d_hi != 0).

    Returns (quotient u256, remainder u128 (lo, hi)). Restoring
    division, 256 steps of u128 shift/compare/subtract over all rows at
    once (the per-thread loop of decimal_utils.cu:146-163, turned 90
    degrees). Like the reference, the shifted remainder keeps 128 bits.
    The bit position is a Python int, so each step reads one static
    limb and bit.
    """
    dev = _device(n)
    shape = torch.broadcast_shapes(*(x.shape for x in n if isinstance(x, torch.Tensor)))
    z = torch.zeros(shape, dtype=torch.int64, device=dev)
    q = [z, z, z, z]
    r_lo, r_hi = z, z
    d = (d_lo, d_hi)
    for bitpos in range(255, -1, -1):
        block, bit = bitpos >> 6, bitpos & 63
        read = lsr(n[block], bit) & 1
        r_hi = (r_hi << 1) | lsr(r_lo, 63)
        r_lo = (r_lo << 1) | read
        ge = u128.ge((r_lo, r_hi), d)
        nr_lo, nr_hi = u128.sub((r_lo, r_hi), d)
        r_lo = torch.where(ge, nr_lo, r_lo)
        r_hi = torch.where(ge, nr_hi, r_hi)
        q[block] = q[block] | (ge.to(torch.int64) << bit)
    return tuple(q), (r_lo, r_hi)


# ---------------------------------------------------------------------------
# pow10 tables

# 10^0 .. 10^77; the reference table stops at 10^76 (decimal_utils.cu
# pow_ten) but the Java guard admits scale diffs of exactly 77
# (DecimalUtils.java:100-103) and 10^77 < 2^256, so carry it too.
_POW10_256 = tuple(const(10**e) for e in range(78))


def pow10_table(max_exp: int = 77, device="cuda") -> torch.Tensor:
    """int64 [max_exp + 1, 4] limbs of 10^0..10^max_exp on ``device``."""
    return device_table(_POW10_256[: max_exp + 1], torch.int64, device)


def pow10(exp):
    """10**exp as a u256: Python-int limbs for a Python ``exp`` in
    [0, 77]; limb tensors of exp's shape for an int tensor (callers
    clip it to the table's range)."""
    if isinstance(exp, int):
        if not 0 <= exp <= 77:
            raise ValueError(f"10^{exp} does not fit in 256 bits")
        return _POW10_256[exp]
    row = pow10_table(77, exp.device)[exp.long()]
    return (row[..., 0], row[..., 1], row[..., 2], row[..., 3])


def precision10(a):
    """Count of decimal digits (reference precision10,
    decimal_utils.cu:513-529: smallest i with 10^i >= |a|, computed as
    |{i : 10^i < |a|}|)."""
    mag, _ = abs_(a)
    tab = pow10_table(76, _device(mag))  # 10^0..10^76, like the reference
    lt = None
    for i in range(4):
        t = tab[:, i]
        m = mag[i][..., None]
        lt_i = ult(t, m)
        lt = lt_i if lt is None else (lt_i | ((t == m) & lt))
    count = lt.sum(dim=-1, dtype=torch.int32)
    # values beyond 10^76: the reference falls off its search loop and
    # returns -1 (decimal_utils.cu:528); callers rely on that sentinel
    return torch.where(count >= 77, -1, count)


_DEC38 = const(10**38)


def is_greater_than_decimal_38(a):
    """|a| >= 10^38 — the Spark DECIMAL128 overflow predicate
    (decimal_utils.cu:531-537)."""
    mag, _ = abs_(a)
    return ge_unsigned(mag, _DEC38)


# ---------------------------------------------------------------------------
# signed divide + Spark rounding


def divide_signed(n, d_mag, d_neg):
    """Signed divide of u256 n by an i128 divisor given as (u128 magnitude,
    negative mask). Returns (q_mag u256, r_mag u128, q_neg, n_neg)
    (decimal_utils.cu divide:166-189)."""
    n_mag, n_neg = abs_(n)
    q_mag, r_mag = divmod_u128(n_mag, d_mag[0], d_mag[1])
    return q_mag, r_mag, n_neg ^ d_neg, n_neg


def _apply_sign(mag, negm):
    return where(negm, neg(mag), mag)


def round_half_up_inc(r_mag, d_mag):
    """HALF_UP increment predicate: 2*|r| >= |d|
    (decimal_utils.cu round_from_remainder:191-219). Doubling may overflow
    u128 only when the top bit of |r| is set, in which case
    2|r| >= 2^128 > |d| anyway."""
    top = r_mag[1] < 0
    dbl = (r_mag[0] << 1, (r_mag[1] << 1) | lsr(r_mag[0], 63))
    return top | u128.ge(dbl, d_mag)


def divide_and_round(n, d_mag, d_neg):
    """n / d with HALF_UP rounding away from zero
    (decimal_utils.cu divide_and_round:221-226)."""
    q_mag, r_mag, q_neg, _ = divide_signed(n, d_mag, d_neg)
    need_inc = round_half_up_inc(r_mag, d_mag)
    q_mag = where(need_inc, add_small(q_mag, 1), q_mag)
    return _apply_sign(q_mag, q_neg)


def integer_divide(n, d_mag, d_neg):
    """n / d truncated toward zero (decimal_utils.cu:231-236)."""
    q_mag, _, q_neg, _ = divide_signed(n, d_mag, d_neg)
    return _apply_sign(q_mag, q_neg)


# ---------------------------------------------------------------------------
# power-of-ten division by reciprocal multiply
#
# floor(n / 10^k) = floor(n * m_k / 2^(N+l)) with m_k = floor(2^(N+l) /
# 10^k) + 1, N = 256, l = 127, exact for every u256 n (Granlund &
# Montgomery, round-up variant; the JAX package's utils/int256.py
# carries the proof). About 24 64x64 partial products instead of 256
# serial shift/compare/subtract steps.

_RECIP_SHIFT = 256 + 127  # N + l
_RECIP_POW10 = tuple(
    tuple(s64(((1 << _RECIP_SHIFT) // 10**e + 1) >> (64 * i)) for i in range(6))
    for e in range(39)
)


def _mul_full(a, b):
    """Full (len(a)+len(b))-limb product of 64-bit-limb tuples —
    schoolbook partials with column accumulation in a 3-limb running
    accumulator (at most 8 u64-pair terms per column)."""
    na, nb = len(a), len(b)
    acc0 = acc1 = acc2 = 0
    out = []
    for p in range(na + nb):
        for i in range(max(0, p - nb + 1), min(na, p + 1)):
            plo, phi = u128.mul64(a[i], b[p - i])
            s = acc0 + plo
            c = ult(s, plo).to(torch.int64)
            acc0 = s
            s1 = acc1 + phi
            c1 = ult(s1, phi).to(torch.int64)
            s2 = s1 + c
            c2 = ult(s2, s1).to(torch.int64)
            acc1 = s2
            acc2 = acc2 + c1 + c2
        out.append(acc0)
        acc0, acc1, acc2 = acc1, acc2, 0
    return out


def divmod_pow10(n_mag, exp):
    """Unsigned floor division of u256 ``n_mag`` by ``10**exp`` where
    ``exp`` is a per-row int tensor in [0, 38]. Returns (quotient u256,
    remainder u128, divisor u128) — the remainder and divisor feed the
    HALF_UP predicate."""
    idx = exp.long()
    mrow = device_table(_RECIP_POW10, torch.int64, exp.device)[idx]
    m = tuple(mrow[..., t] for t in range(6))
    prod = _mul_full(n_mag, m)  # 10 limbs
    # q = full product >> 383: limbs 5..9 shifted down 63 bits
    q = tuple(lsr(prod[5 + t], 63) | (prod[6 + t] << 1) for t in range(4))
    d = pow10(torch.clamp(exp, 0, 77))
    r = add(n_mag, neg(mul(q, d)))  # n - q*d, fits u128 (r < d <= 10^38)
    return q, (r[0], r[1]), (d[0], d[1])


def divide_and_round_pow10(n, exp):
    """``n / 10**exp`` with HALF_UP rounding away from zero for a
    per-row exponent tensor in [0, 38] (bit-identical to
    ``divide_and_round`` by a power of ten)."""
    n_mag, n_neg = abs_(n)
    q_mag, r_mag, d_mag = divmod_pow10(n_mag, exp)
    need_inc = round_half_up_inc(r_mag, d_mag)
    q_mag = where(need_inc, add_small(q_mag, 1), q_mag)
    return _apply_sign(q_mag, n_neg)


def pow10_u128(exp: int):
    """10**exp as a (lo, hi) u128 magnitude of Python ints; exp <= 38."""
    if exp > 38:
        raise ValueError(f"pow10 divisor 10^{exp} does not fit in 128 bits")
    return u128.const(10**exp)


def set_scale_and_round(data, old_scale: int, new_scale: int):
    """Rescale by powers of ten with HALF_UP rounding, Spark scale
    convention (value = unscaled * 10^-scale): raising the scale
    multiplies, lowering it divides-and-rounds
    (decimal_utils.cu set_scale_and_round:539-553, cudf scales negated).
    Scales are per-column statics, so this is host control flow."""
    if new_scale == old_scale:
        return data
    if new_scale > old_scale:
        return mul(data, pow10(new_scale - old_scale))
    d_mag = pow10_u128(old_scale - new_scale)
    return divide_and_round(data, d_mag, torch.zeros_like(data[0], dtype=torch.bool))

