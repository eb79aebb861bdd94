"""Spark-exact DECIMAL128 arithmetic with overflow-flag columns (PyTorch
twin of the JAX package's ``ops/decimal.py``).

Behavioural parity with the reference's decimal kernels
(decimal_utils.cu dec128_add_sub:555-641, dec128_multiplier:643-711
with the SPARK-40129 double rounding, dec128_divider:720-824; Java
scale guards DecimalUtils.java:100-103,123-126). Every step is an
elementwise 256-bit limb operation over whole columns
(``utils/int256``).

Scale convention: Spark scales (value = unscaled * 10^-scale), the
negation of cudf's. Each public op returns a 2-column Table
{overflow BOOL8, result} whose null masks are the AND of the input
masks, like the reference host entries.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..columnar.dtypes import BOOL8, DECIMAL128, INT64
from ..columnar.table import Table
from ..kernels import native
from ..utils import int128 as u128
from ..utils import int256 as u256


def _and_validity(a: Column, b: Column):
    if a.validity is None and b.validity is None:
        return None
    return a.validity_or_true() & b.validity_or_true()


def _check_dec128(c: Column, name: str):
    if not (c.dtype.kind == "decimal" and c.dtype.bits == 128):
        raise TypeError(f"{name} is not a DECIMAL128 column: {c.dtype}")


def _check_pair(a: Column, b: Column):
    _check_dec128(a, "a")
    _check_dec128(b, "b")
    if len(a) != len(b):
        raise ValueError("inputs have mismatched row counts")


# ---------------------------------------------------------------------------
# kernels (functions over limb tensors; scales are Python ints)


def _add_sub_kernel(a_limbs, b_limbs, a_scale, b_scale, target_scale, is_sub):
    """dec128_add_sub semantics (decimal_utils.cu:573-592): rescale both
    operands to the larger scale in 256-bit, add/sub, rescale+round to the
    target scale, overflow iff |result| >= 10^38."""
    a = u256.from_i128_limbs(a_limbs)
    b = u256.from_i128_limbs(b_limbs)
    inter_scale = max(a_scale, b_scale)
    a = u256.set_scale_and_round(a, a_scale, inter_scale)
    b = u256.set_scale_and_round(b, b_scale, inter_scale)
    if is_sub:
        b = u256.neg(b)
    s = u256.add(a, b)
    s = u256.set_scale_and_round(s, inter_scale, target_scale)
    overflow = u256.is_greater_than_decimal_38(s)
    return overflow, u256.to_i128_limbs(s)


def _multiply_i128_kernel(a_limbs, b_limbs):
    """Product known to fit 38 digits statically (p1 + p2 + 1 <= 38 and
    product_scale == a_scale + b_scale): the exact 128-bit product, with
    overflow impossible. Two's-complement multiply mod 2^128 is the
    signed product when it fits — three 64x64 partials.

    Precondition (the contract Spark's planner guarantees): column
    values conform to their declared precision.
    """
    a_lo, a_hi = a_limbs[..., 0], a_limbs[..., 1]
    b_lo, b_hi = b_limbs[..., 0], b_limbs[..., 1]
    lo, mid = u128.mul64(a_lo, b_lo)
    hi = mid + a_lo * b_hi + a_hi * b_lo
    overflow = torch.zeros(a_lo.shape, dtype=torch.bool, device=a_lo.device)
    return overflow, torch.stack([lo, hi], dim=-1)


_DEC38 = u256.const(10**38)
_DEC77 = u256.const(10**77)


def _multiply_noshift_kernel(a_limbs, b_limbs):
    """product_scale == a_scale + b_scale but the product may exceed 38
    digits (p1 + p2 + 1 > 38). The reference flow
    (decimal_utils.cu:651-703) gives three regimes:

      - |product| <  10^38: exact product, no overflow.
      - 10^38 <= |product| < 10^77: overflow, result 0.
      - |product| >= 10^77: precision10's -1 sentinel skips both
        roundings; overflow, result = truncated product limbs.

    Two unsigned compares against constants; no division runs.
    """
    a = u256.from_i128_limbs(a_limbs)
    b = u256.from_i128_limbs(b_limbs)
    product = u256.mul(a, b)
    mag, _ = u256.abs_(product)
    ge38 = u256.ge_unsigned(mag, _DEC38)
    lt77 = u256.lt_unsigned(mag, _DEC77)
    zeroed = ge38 & lt77
    result = u256.where(zeroed, (0, 0, 0, 0), product)
    return ge38, u256.to_i128_limbs(result)


def _multiply_scales_any(a_limbs, b_limbs, a_scale, b_scale, product_scale):
    """dec128_multiplier semantics (decimal_utils.cu:651-703), with
    Spark's SPARK-40129 double rounding: first round the raw 256-bit
    product down to 38 digits (a per-row power of ten), then rescale to
    the requested product scale. Both roundings take the exact
    reciprocal-multiply path (``divide_and_round_pow10``)."""
    a = u256.from_i128_limbs(a_limbs)
    b = u256.from_i128_limbs(b_limbs)
    product = u256.mul(a, b)

    dec_precision = u256.precision10(product)
    first_div_precision = torch.clamp(dec_precision - 38, min=0)
    need_first = first_div_precision > 0

    # level 1: divide_and_round by 10^first_div_precision where needed
    divided = u256.divide_and_round_pow10(product, first_div_precision)
    product = u256.where(need_first, divided, product)

    # Spark mult scale after the first rounding (cudf scales negated:
    # decimal_utils.cu:668-672); exponent = mult_scale - product_scale
    exponent = (a_scale + b_scale - product_scale) - first_div_precision

    # exponent < 0 -> multiply by 10^-exponent unless that overflows 38
    # digits; exponent >= 0 -> divide_and_round by 10^exponent.
    new_precision = u256.precision10(product)
    pre_overflow = (exponent < 0) & ((new_precision - exponent) > 38)

    multiplied = u256.mul(product, u256.pow10(torch.clamp(-exponent, 0, 77)))
    # level 2: the rescale-down division, same reciprocal path
    divided2 = u256.divide_and_round_pow10(product, torch.clamp(exponent, 0, 38))

    result = u256.where(exponent < 0, multiplied, divided2)
    overflow = pre_overflow | u256.is_greater_than_decimal_38(result)
    # the reference early-returns on pre_overflow leaving the result at 0
    result = u256.where(pre_overflow, (0, 0, 0, 0), result)
    return overflow, u256.to_i128_limbs(result)


def _add_sub_scales_any(a_limbs, b_limbs, a_scale, b_scale, target_scale, is_sub: bool):
    """_add_sub_kernel with the scales as 0-d int tensors (the form a
    caller that receives scales at run time hands over): the host
    control flow becomes compute-both-and-select. Callers enforce
    inter_scale - target_scale <= 38 (the static path's pow10_u128
    guard) first."""
    dev = a_limbs.device
    a_scale, b_scale, target_scale = (
        torch.full((), s, dtype=torch.int64, device=dev) for s in (a_scale, b_scale, target_scale)
    )
    a = u256.from_i128_limbs(a_limbs)
    b = u256.from_i128_limbs(b_limbs)
    inter = torch.maximum(a_scale, b_scale)

    def up(x, e):  # multiply by 10^e, e a 0-d tensor
        return u256.mul(x, u256.pow10(torch.clamp(e, 0, 77)))

    a = up(a, inter - a_scale)
    b = up(b, inter - b_scale)
    if is_sub:
        b = u256.neg(b)
    s = u256.add(a, b)
    delta = inter - target_scale
    raised = up(s, -delta)
    d = u256.pow10(torch.clamp(delta, 0, 38))
    shape = s[0].shape
    d_mag = (d[0].expand(shape), d[1].expand(shape))
    zero_neg = torch.zeros(shape, dtype=torch.bool, device=dev)
    lowered = u256.divide_and_round(s, d_mag, zero_neg)
    result = u256.where(delta > 0, lowered, u256.where(delta < 0, raised, s))
    overflow = u256.is_greater_than_decimal_38(result)
    return overflow, u256.to_i128_limbs(result)


def _divide_kernel(a_limbs, b_limbs, a_scale, b_scale, quot_scale, is_int_div):
    """dec128_divider semantics (decimal_utils.cu:728-812). Three regimes
    by the static shift exponent:

      shift = quot_scale + b_scale - a_scale  (amount to scale n up by)
      shift < 0        -> divide then divide again (reference n_shift_exp > 0)
      shift > 38       -> multiply by 10^38, long-divide, scale remainder
                          (reference n_shift_exp < -38)
      otherwise        -> multiply by 10^shift then one divide
    """
    n = u256.from_i128_limbs(a_limbs)
    d_lo, d_hi = b_limbs[..., 0], b_limbs[..., 1]
    d_neg = d_hi < 0
    d_mag = u128.where(d_neg, u128.neg((d_lo, d_hi)), (d_lo, d_hi))
    div_by_zero = u128.is_zero(d_mag)
    # guard the long division against d == 0 (the reference returns
    # overflow=true, quotient=0 before dividing)
    safe_mag = u128.where(div_by_zero, (1, 0), d_mag)

    shift = quot_scale + b_scale - a_scale
    shape = d_lo.shape
    zero_neg = torch.zeros(shape, dtype=torch.bool, device=d_lo.device)

    if shift < 0:
        # divide twice: n/d (truncating), then rescale down with rounding
        q_mag, _, q_neg, _ = u256.divide_signed(n, safe_mag, d_neg)
        first_q = u256.where(q_neg, u256.neg(q_mag), q_mag)
        sd = u256.pow10_u128(-shift)
        if is_int_div:
            result = u256.integer_divide(first_q, sd, zero_neg)
        else:
            result = u256.divide_and_round(first_q, sd, zero_neg)
    elif shift > 38:
        # long division in base 10^38: n*10^38 / d gives quotient and
        # remainder, the remaining 10^(shift-38) is applied to both and
        # the remainder re-divided (decimal_utils.cu:765-795)
        n1 = u256.mul(n, u256.pow10(38))
        q_mag, r_mag, q_neg, n_neg = u256.divide_signed(n1, safe_mag, d_neg)
        q1 = u256.where(q_neg, u256.neg(q_mag), q_mag)
        # signed remainder: sign of n (reference divide():186-187)
        r256 = (r_mag[0], r_mag[1], 0, 0)
        r256 = u256.where(n_neg, u256.neg(r256), r256)
        remaining = u256.pow10(shift - 38)
        result = u256.mul(q1, remaining)
        scaled_r = u256.mul(r256, remaining)
        q2_mag, r2_mag, q2_neg, n2_neg = u256.divide_signed(scaled_r, safe_mag, d_neg)
        q2 = u256.where(q2_neg, u256.neg(q2_mag), q2_mag)
        result = u256.add(result, q2)
        if not is_int_div:
            # final rounding from the second remainder against the
            # divisor, away from zero of the true quotient sign
            need_inc = u256.round_half_up_inc(r2_mag, safe_mag)
            sign_neg = n2_neg ^ d_neg
            inc = torch.where(sign_neg, -1, 1) * need_inc.to(torch.int64)
            result = u256.add_small(result, inc)
    else:
        if shift > 0:
            n = u256.mul(n, u256.pow10(shift))
        if is_int_div:
            result = u256.integer_divide(n, safe_mag, d_neg)
        else:
            result = u256.divide_and_round(n, safe_mag, d_neg)

    overflow = div_by_zero | u256.is_greater_than_decimal_38(result)
    result = u256.where(div_by_zero, (0, 0, 0, 0), result)
    if is_int_div:
        # INT64 quotient = low limb (reference as_64_bits), overflow
        # still judged on the 128-bit value (DecimalUtils.java:62-70)
        return overflow, result[0]
    return overflow, u256.to_i128_limbs(result)


def _on_card(a: Column) -> bool:
    return a.data.device.type == "cuda"


def _card_kernel(op: str, a: Column, b: Column, a_scale: int, b_scale: int, out_scale: int):
    """(overflow bool, limbs) of ``a op b`` from the native decimal128
    kernel (``kernels/native.py``), which computes the scales-any
    function; the caller masks the overflow with the inputs' validity."""
    overflow, limbs, _ = native.decimal128(op, a.data.contiguous(), b.data.contiguous(), None,
                                           None, a_scale, b_scale, out_scale)
    return overflow.view(torch.bool), limbs


# ---------------------------------------------------------------------------
# public API (mirrors DecimalUtils.java / cudf::jni entries)


def _result_table(overflow, result_data, result_dtype, validity):
    if validity is not None:
        overflow = overflow & validity  # null rows: flag masked anyway
    return Table(
        [
            Column(BOOL8, overflow.to(torch.int8), validity),
            Column(result_dtype, result_data, validity),
        ],
        names=("overflow", "result"),
    )


def _add_sub(a: Column, b: Column, target_scale: int, is_sub: bool) -> Table:
    _check_pair(a, b)
    if abs(a.dtype.scale - b.dtype.scale) > 77:
        raise ValueError(
            "The intermediate scale for calculating the result exceeds "
            "256-bit representation"
        )
    validity = _and_validity(a, b)
    if _on_card(a):
        # the plain path's rescale guards (u256.set_scale_and_round),
        # raised before the launch
        inter = max(a.dtype.scale, b.dtype.scale)
        if inter - target_scale > 38:
            raise ValueError(f"pow10 divisor 10^{inter - target_scale} does not fit in 128 bits")
        if target_scale - inter > 77:
            raise ValueError(f"10^{target_scale - inter} does not fit in 256 bits")
        overflow, limbs = _card_kernel("sub" if is_sub else "add", a, b, a.dtype.scale,
                                       b.dtype.scale, target_scale)
    else:
        overflow, limbs = _add_sub_kernel(
            a.data, b.data, a.dtype.scale, b.dtype.scale, target_scale, is_sub
        )
    return _result_table(overflow, limbs, DECIMAL128(38, target_scale), validity)


def add128(a: Column, b: Column, target_scale: int) -> Table:
    """Spark 3.4 decimal add (DecimalUtils.java:122-133)."""
    return _add_sub(a, b, target_scale, False)


def subtract128(a: Column, b: Column, target_scale: int) -> Table:
    """Spark 3.4 decimal subtract (DecimalUtils.java:99-110)."""
    return _add_sub(a, b, target_scale, True)


def multiply128(a: Column, b: Column, product_scale: int) -> Table:
    """Decimal multiply with SPARK-40129 double rounding
    (DecimalUtils.java:41-43, decimal_utils.cu:643-711)."""
    _check_pair(a, b)
    # check_scale_divisor: the rescale divisor from (a_scale+b_scale)
    # down to product_scale must fit in 128 bits
    if (a.dtype.scale + b.dtype.scale) - product_scale > 38:
        raise ValueError("divisor too big")
    validity = _and_validity(a, b)
    p_sum = a.dtype.precision + b.dtype.precision + 1
    if _on_card(a):
        # one kernel for every regime: the scales-any function. With
        # product_scale == a_scale + b_scale it gives the i128 and
        # noshift regimes' values, save one: the noshift regime's result
        # is 0 at every overflow row (|product| >= 10^38; < 10^77 for
        # 128-bit operands), and the kernel's is 0 there too except at
        # |product| == 10^38 exactly (precision10 is 38, so no first
        # rounding; e.g. 10^19 * 10^19), where it keeps the product
        overflow, limbs = _card_kernel("mul", a, b, a.dtype.scale, b.dtype.scale, product_scale)
        if product_scale == a.dtype.scale + b.dtype.scale and p_sum > 38:
            limbs.masked_fill_(overflow[:, None], 0)
    elif product_scale == a.dtype.scale + b.dtype.scale:
        # Spark's standard multiply typing: the rescale exponent is zero,
        # so no division runs (see the kernels' docstrings)
        if p_sum <= 38:
            overflow, limbs = _multiply_i128_kernel(a.data, b.data)
        else:
            overflow, limbs = _multiply_noshift_kernel(a.data, b.data)
    else:
        overflow, limbs = _multiply_scales_any(
            a.data, b.data, a.dtype.scale, b.dtype.scale, product_scale
        )
    return _result_table(overflow, limbs, DECIMAL128(min(p_sum, 38), product_scale), validity)


def divide128(a: Column, b: Column, quotient_scale: int) -> Table:
    """Decimal divide rounded to quotient_scale (DecimalUtils.java:58-60)."""
    _check_pair(a, b)
    validity = _and_validity(a, b)
    overflow, limbs = _divide_kernel(
        a.data, b.data, a.dtype.scale, b.dtype.scale, quotient_scale, False
    )
    return _result_table(overflow, limbs, DECIMAL128(38, quotient_scale), validity)


def integer_divide128(a: Column, b: Column) -> Table:
    """Decimal integer divide -> INT64 with 128-bit overflow judgement
    (DecimalUtils.java:62-84)."""
    _check_pair(a, b)
    validity = _and_validity(a, b)
    overflow, q = _divide_kernel(a.data, b.data, a.dtype.scale, b.dtype.scale, 0, True)
    return _result_table(overflow, q, INT64, validity)
