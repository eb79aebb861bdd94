"""Spark-exact string -> integer / decimal / float casts (the port's
twin of the JAX package's ``ops/cast_string.py``).

Behavioral parity with the reference kernels (cast_string.cu
string_to_integer_kernel:157-244, validate_and_exponent:246-378,
string_to_decimal_kernel:390-581; cast_string_to_float.cu
string_to_float:54-599). Every parser runs over the padded
char matrix ``int32 [n, L]`` (``columnar/strings.py``) as positional
algebra: character classes, prefix sums and masked reductions along the
L axis replace the per-thread state machines, and digit accumulation is
a weighted sum with a pow10 table. The JAX package's algebra is kept
step for step, so every value, overflow and null is the same; uint64
magnitudes are int64 tensors holding the same bits (``utils/int128``).

Whitespace is the Spark set {space, \\r, \\t, \\n}
(cast_string.cu is_whitespace:45-55).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..columnar.column import Column
from ..columnar.dtypes import DECIMAL32, DECIMAL64, DECIMAL128, DType
from ..columnar.strings import to_char_matrix
from ..kernels import native
from ..runtime.errors import CapacityExceededError, CastException
from ..utils import int128 as u128
from ..utils.consts import device_table
from ._strategy import fused
from .ragged import lane_select
from .segmented import lane_count

_I32 = torch.int32
_I64 = torch.int64


def _is_ws(c):
    return (c == 32) | (c == 13) | (c == 9) | (c == 10)


def _is_digit(c):
    return (c >= ord("0")) & (c <= ord("9"))


_INT_LIMITS = {
    8: (2**7 - 1, 2**7),
    16: (2**15 - 1, 2**15),
    32: (2**31 - 1, 2**31),
    64: (2**63 - 1, 2**63),
}


def _first_true(mask, default):
    """Index of first True along axis 1, else `default` (per row)."""
    L = mask.shape[1]
    if L == 0:
        return torch.full((mask.shape[0],), default, dtype=_I32, device=mask.device)
    pos = torch.arange(L, dtype=_I32, device=mask.device)[None, :]
    return torch.where(mask, pos, default).amin(dim=1)


def _table(values, device):
    """int64 tensor holding the 64-bit patterns of ``values``."""
    return device_table([u128.s64(v) for v in values], _I64, device)


def _prologue(chars, lengths, strip):
    """Shared parser prologue: char classes, leading-whitespace skip and
    sign detection. Returns (pos, in_str, ws, digit, negative, start)."""
    n, L = chars.shape
    pos = torch.arange(L, dtype=_I32, device=chars.device)[None, :]
    in_str = pos < lengths[:, None]
    ws = _is_ws(chars) & in_str
    digit = _is_digit(chars) & in_str
    if strip:
        # leading-whitespace count: the JAX package's sum of a cumprod
        # over the ws flags, i.e. the first non-ws position
        i0 = _first_true(~ws, L)
    else:
        i0 = torch.zeros((n,), dtype=_I32, device=chars.device)
    c_i0 = lane_select(chars, torch.clamp(i0, max=L - 1))
    has_sign = ((c_i0 == ord("+")) | (c_i0 == ord("-"))) & (i0 < lengths)
    negative = (c_i0 == ord("-")) & has_sign
    start = i0 + has_sign.to(_I32)
    return pos, in_str, ws, digit, negative, start


def _parse_integer(chars, lengths, in_valid, bits, ansi, strip):
    """Returns (magnitude u64 bits in int64, negative, valid) per row.

    Mirrors cast_string.cu string_to_integer_kernel semantics:
    [ws] [+-] digits ['.' junk-digits] [ws], '.' truncation only in
    non-ANSI mode, overflow -> invalid, whitespace only with strip.
    """
    n, L = chars.shape
    dev = chars.device
    pos, in_str, ws, digit, negative, start = _prologue(chars, lengths, strip)
    dot = (chars == ord(".")) & in_str

    valid = in_valid & (lengths > 0) & (start < lengths)

    after = pos >= start[:, None]
    # trailing whitespace region: first ws at position >= start
    if strip:
        W = _first_true(ws & after, L + 1)
    else:
        W = torch.full((n,), L + 1, dtype=_I32, device=dev)
    # ws at the first payload position is not "trailing" (c != i) -> invalid
    valid = valid & (W != start)
    before_W = pos < W[:, None]

    # the single truncation dot (non-ANSI only)
    if ansi:
        D1 = torch.full((n,), L + 1, dtype=_I32, device=dev)
    else:
        D1 = _first_true(dot & after & before_W, L + 1)

    # payload chars before W: digit or the dot at D1; at/after W: ws only
    ok = torch.where(before_W, digit | (pos == D1[:, None]), ws)
    valid = valid & torch.all(~(in_str & after) | ok, dim=1)

    # digits consumed: [start, D) with D = min(D1, W, len)
    D = torch.minimum(torch.minimum(D1, W), lengths)
    consumed = after & (pos < D[:, None]) & digit
    dvals = torch.where(consumed, chars - ord("0"), 0).to(_I64)

    # leading zeros don't count toward magnitude digits
    nz = consumed & (chars != ord("0"))
    z = _first_true(nz, L + 1)
    nd = torch.clamp(D - z, min=0)  # significant digit count

    # weighted sum with pow10: exponent of digit at p is D-1-p
    exp = D[:, None] - 1 - pos
    p10 = _table([10**i for i in range(20)], dev)
    weights = p10[torch.clamp(exp, 0, 19).long()]
    mag = (dvals * weights).sum(dim=1)  # wraps mod 2^64 like the u64 sum

    max_pos, max_neg = _INT_LIMITS[bits]
    limit = torch.where(
        negative,
        torch.full((), u128.s64(max_neg), dtype=_I64, device=dev),
        torch.full((), max_pos, dtype=_I64, device=dev),
    )
    valid = valid & (nd <= 19) & ~u128.ult(limit, mag)
    return mag, negative, valid


# sprtcheck: host-side — reads one row's bytes for the CastException message, after the cast
def _row_string(col: Column, row: int) -> str:
    """Fetch one row's string with an O(row-length) transfer."""
    o0 = int(col.offsets[row])
    o1 = int(col.offsets[row + 1])
    return bytes(col.data[o0:o1].cpu().numpy()).decode("utf-8", errors="replace")


# sprtcheck: host-side — the ANSI error report: finds the first bad row after the cast
def _raise_first_error(col: Column, bad: torch.Tensor):
    """ANSI mode: find the first bad row and raise CastException with
    the offending string (cast_string.cu validate_ansi_column:601-634,
    which copies only the one offending string to the host)."""
    if not bool(bad.any()):
        return
    row = int(torch.argmax(bad.to(torch.uint8)))
    raise CastException(_row_string(col, row), row)


# sprtcheck: host-side — the ANSI error report: reads the kernel's first bad row after the cast
def _raise_status_error(col: Column, status: torch.Tensor):
    """ANSI mode on the card: the native kernel's status[0] is the first
    bad row (native.NO_ROW when there is none), so only that word and
    the offending string cross to the host."""
    row = int(status[0])
    if row != native.NO_ROW:
        raise CastException(_row_string(col, row), row)


def _check_width_eager(col: Column, width):
    """A call with a pinned ``width`` must not silently truncate
    (to_char_matrix clamps): the max length is one host sync away, so
    refuse instead. Inside a fused chain the chain counts the overflow
    (runtime/pipeline.py) and nothing syncs here."""
    if width is None or fused():
        return
    mx = int(col.string_lengths().max()) if len(col) else 0
    if mx > width:
        raise CapacityExceededError(
            f"width={width} would truncate strings up to {mx} bytes — "
            "raise width (or omit it)",
            stage="string_width",
            needed=mx,
            granted=width,
        )


def _validity_or_none(valid):
    """Compact an all-valid mask to None (one host sync; inside a fused
    chain the mask stays, and the chain's collect compacts it)."""
    if fused():
        return valid
    return None if bool(valid.all()) else valid


def string_to_integer(
    col: Column,
    out_type: DType,
    ansi_mode: bool = False,
    strip: bool = True,
    width: Optional[int] = None,
) -> Column:
    """CastStrings.toInteger (CastStrings.java:49, cast_string.cu
    string_to_integer:778). ``width`` pins the char-matrix width
    (bytes); by default it is the bucketed max length (one host sync).
    ``ansi_mode`` raises CastException on the first bad row. On the
    card the native cast_integer kernel parses each string's bytes in
    place (``width`` is checked, but no char matrix is built)."""
    if out_type.kind not in ("int",):
        raise TypeError(f"not an integer type: {out_type}")
    _check_width_eager(col, width)
    if col.data.device.type == "cuda":
        value, valid, status = native.cast_integer(
            col.data, col.offsets, col.validity, out_type.bits, ansi_mode, strip
        )
        if ansi_mode:
            _raise_status_error(col, status)
        return Column(out_type, value, _validity_or_none(valid))
    chars, lengths = to_char_matrix(col, width)
    in_valid = col.validity_or_true()
    mag, negative, valid = _parse_integer(
        chars, lengths, in_valid, out_type.bits, ansi_mode, strip
    )
    if ansi_mode:
        _raise_first_error(col, ~valid & in_valid)
    value = torch.where(negative, -mag, mag).to(out_type.torch_dtype)
    value = torch.where(valid, value, torch.zeros_like(value))
    return Column(out_type, value, _validity_or_none(valid))


# ---------------------------------------------------------------------------
# string -> decimal
# ---------------------------------------------------------------------------

_EXP_SAT = 10**15  # exponent saturation; see _parse_decimal


def _weighted_mag_u128(dvals, k_idx, K, active):
    """Sum of d_k * 10^(K-1-k) over active digit positions, exactly, as a
    u128: three u64 partial sums split by exponent band [0,13),
    [13,26), [26,39) so no band can overflow, recombined with two
    128-bit multiply-adds. All digits with exponent >= 39 must be zero
    (guaranteed: kept digits <= 38 significant)."""
    exp = K[:, None] - 1 - k_idx
    d = torch.where(active, dvals, 0)
    p10_small = _table([10**i for i in range(13)], dvals.device)

    def band(b):
        e = exp - 13 * b
        in_band = active & (e >= 0) & (e < 13)
        w = p10_small[torch.clamp(e, 0, 12).long()]
        return torch.where(in_band, d * w, 0).sum(dim=1)

    b0, b1, b2 = band(0), band(1), band(2)
    zero = torch.zeros_like(b0)
    ten13 = 10**13
    acc = u128.add(u128.mul_u64((b2, zero), ten13), (b1, zero))
    return u128.add(u128.mul_u64(acc, ten13), (b0, zero))


def _limit_div_pow10_tables(bits, device):
    """Tables floor(limit / 10^z) for z=0..39, for positive and negative
    magnitudes (limits differ by one), as (lo, hi) int64 tensors."""
    max_pos = 2 ** (bits - 1) - 1
    tables = []
    for lim in (max_pos, max_pos + 1):
        vals = [lim // (10**z) for z in range(40)]
        tables.append((_table(vals, device), _table([v >> 64 for v in vals], device)))
    return tables


def _mul_pow10_u128(a, z):
    """a * 10^z mod 2^128 for per-row z in [0, 39] via the pow10 table."""
    plo, phi = u128.pow10_table(a[0].device)
    zc = torch.clamp(z, 0, 38).long()
    wlo, whi = plo[zc], phi[zc]
    res = u128.mul_u64(a, wlo)
    return (res[0], res[1] + a[0] * whi)


def _parse_decimal(chars, lengths, in_valid, precision, scale, bits, ansi, strip):
    """Returns (limbs (lo, hi) magnitude, negative, valid) per row.

    The reference's two-pass algorithm (cast_string.cu
    validate_and_exponent:246-378 state machine +
    string_to_decimal_kernel:390-581 digit march) as closed-form
    positional algebra. One deliberate deviation, the JAX package's: the
    exponent accumulator saturates at +-1e15 instead of the storage
    type's limits, which only changes behavior for exponents written
    with >15 significant digits (reference: overflow -> invalid; here:
    same final result except astronomically negative exponents yield 0
    instead of null).
    """
    n, L = chars.shape
    dev = chars.device
    S = scale
    pos, in_str, ws, digit, negative, start = _prologue(chars, lengths, strip)
    dot = (chars == ord(".")) & in_str
    echar = ((chars == ord("e")) | (chars == ord("E"))) & in_str
    valid = in_valid & (lengths > 0) & (start < lengths)

    after = pos >= start[:, None]
    if strip:
        W = _first_true(ws & after, L + 1)
    else:
        W = torch.full((n,), L + 1, dtype=_I32, device=dev)
    W = torch.minimum(W, lengths)  # == len when no trailing ws
    valid = valid & (W != start)

    E1 = _first_true(echar & after, L + 1)
    # whitespace may begin only from mantissa or right after 'e'
    # (states DIGITS/DECIMAL_POINT/EXPONENT_OR_SIGN allow ws; EXPONENT
    # and EXPONENT_SIGN do not)
    valid = valid & ((W == lengths) | (W < E1) | (W == E1 + 1))
    # all chars from W on must be whitespace
    valid = valid & torch.all(~in_str | ~(pos >= W[:, None]) | ws, dim=1)

    # mantissa region [start, M)
    M = torch.minimum(torch.minimum(E1, W), lengths)
    in_mant = after & (pos < M[:, None])
    D1 = _first_true(dot & in_mant, L + 1)
    valid = valid & torch.all(~in_mant | digit | (pos == D1[:, None]), dim=1)

    # exponent region
    has_e = E1 < torch.minimum(W, lengths)
    estart = E1 + 1
    ws_after_e = W == estart
    c_es = lane_select(chars, torch.clamp(estart, 0, L - 1))
    e_has_sign = (
        has_e & ~ws_after_e & (estart < lengths)
        & ((c_es == ord("+")) | (c_es == ord("-")))
    )
    exp_negative = e_has_sign & (c_es == ord("-"))
    dstart = estart + e_has_sign.to(_I32)
    in_exp = (
        (pos >= dstart[:, None]) & in_str & has_e[:, None] & ~ws_after_e[:, None]
    )
    valid = valid & torch.all(~in_exp | digit, dim=1)

    # exponent value. The reference accumulates the exponent in the
    # decimal's storage type, so DECIMAL32/64 casts reject exponents
    # that overflow int32/int64; reproduced exactly for exponents
    # written with <= 18 significant digits; beyond that DECIMAL128
    # saturates at +-1e15.
    e_nz = in_exp & digit & (chars != ord("0"))
    ez = _first_true(e_nz, L + 1)
    e_nd = torch.clamp(lengths - torch.maximum(ez, dstart), min=0)
    e_exp = lengths[:, None] - 1 - pos
    p10_64 = _table([10**i for i in range(19)], dev)
    e_w = p10_64[torch.clamp(e_exp, 0, 18).long()]
    e_dval = torch.where(in_exp & digit, (chars - ord("0")).to(_I64), 0)
    e_mag = torch.where(e_exp < 18, e_dval * e_w, 0).sum(dim=1)
    too_many = e_nd > 18
    if bits == 128:
        e_mag = torch.where(too_many, _EXP_SAT, e_mag)
    else:
        exp_limit = 2 ** (bits - 1) - 1
        valid = valid & ~too_many
        # negative exponents get one more unit of range (two's
        # complement); subtract on the left to avoid wrapping
        valid = valid & ((e_mag - exp_negative.to(_I64)) <= exp_limit)
        e_mag = torch.clamp(e_mag, max=_EXP_SAT)
    exp_val = torch.where(exp_negative, -e_mag, e_mag)

    # ---- digit bookkeeping (64-bit: dl can be +-1e15) ----
    mant_digit = digit & in_mant
    k_idx = lane_count(mant_digit) - 1
    nd = mant_digit.sum(dim=1, dtype=_I64)
    mant_nz = mant_digit & (chars != ord("0"))
    # digit-index of first nonzero digit (= nd if none)
    fz_pos = _first_true(mant_nz, L + 1)
    first_nz = torch.where(
        fz_pos <= L,
        lane_select(k_idx, torch.clamp(fz_pos, 0, L - 1)),
        nd.to(_I32),
    ).to(_I64)
    # digits before the dot (chars from start to boundary are all digits)
    dl_base = torch.where(D1 <= L, (D1 - start).to(_I64), nd)
    dl = dl_base + exp_val
    last_keep = dl + S

    j0 = torch.minimum(first_nz, torch.clamp(dl, min=0))
    K = torch.minimum(torch.minimum(j0 + precision, last_keep), nd)
    K = torch.clamp(K, min=0)
    march = last_keep >= 0
    K = torch.where(march, K, 0)

    K32 = K.to(_I32)
    active = mant_digit & (k_idx < K32[:, None])
    dvals = (chars - ord("0")).to(_I64)
    mag = _weighted_mag_u128(dvals, k_idx, K32, active)

    # rounding: when the march stopped before the last digit
    has_round = march & (K < nd)
    rd_pos = _first_true(mant_digit & (k_idx == K32[:, None]), L + 1)
    rd = lane_select(chars, torch.clamp(rd_pos, 0, L - 1)) - ord("0")
    round_up = has_round & (rd >= 5)
    dc_before = u128.digit_count(mag)
    mag = u128.where(round_up, u128.add_u64(mag, 1), mag)
    dc_after = u128.digit_count(mag)
    r_extra = (
        round_up
        & ~u128.is_zero(u128.where(round_up, u128.sub(mag, u128.const(1)), mag))
        & (dc_after > dc_before)
    ).to(_I64)

    total = torch.where(march, K, 0) + r_extra
    P = torch.clamp(K - j0, min=0) + r_extra
    dl_adj = dl + r_extra

    # significant digits before the decimal as written in the string
    sig_str = torch.clamp(torch.minimum(dl, nd) - first_nz, min=0)
    if S < 0:
        z2d = torch.clamp(dl_adj - total + S, min=0)
    else:
        z2d = torch.clamp(dl_adj - total, min=0)
    sig_before = sig_str + z2d + r_extra
    valid = valid & (sig_before <= (precision - S))

    spz = torch.clamp(-dl_adj, min=0)
    digits_after = P + z2d - sig_before + spz
    needed_after = torch.clamp(precision - sig_before, max=S)
    z2 = torch.clamp(needed_after - digits_after, min=0)

    # apply both zero paddings with exact overflow checks vs storage limit
    ztot = torch.clamp(z2d + z2, 0, 39).long()
    (tp_lo, tp_hi), (tn_lo, tn_hi) = _limit_div_pow10_tables(bits, dev)
    thr = (
        torch.where(negative, tn_lo[ztot], tp_lo[ztot]),
        torch.where(negative, tn_hi[ztot], tp_hi[ztot]),
    )
    valid = valid & ~(march & u128.gt(mag, thr))
    mag = _mul_pow10_u128(mag, ztot)
    zero = torch.zeros_like(mag[0])
    mag = u128.where(march, mag, (zero, zero))
    return mag, negative, valid


def string_to_decimal(
    col: Column,
    precision: int,
    scale: int,
    ansi_mode: bool = False,
    strip: bool = True,
    width: Optional[int] = None,
) -> Column:
    """CastStrings.toDecimal (CastStrings.java:78, cast_string.cu
    string_to_decimal:800+). ``scale`` uses the Spark sign convention.
    Storage width picked from precision like the reference type
    dispatch (<=9: DECIMAL32, <=18: DECIMAL64, else DECIMAL128)."""
    if precision < 1 or precision > 38:
        raise ValueError(f"invalid precision {precision}")
    if scale > precision:
        raise ValueError(f"invalid scale {scale} for precision {precision}")
    if precision <= 9:
        out_type, bits = DECIMAL32(precision, scale), 32
    elif precision <= 18:
        out_type, bits = DECIMAL64(precision, scale), 64
    else:
        out_type, bits = DECIMAL128(precision, scale), 128

    _check_width_eager(col, width)
    chars, lengths = to_char_matrix(col, width)
    in_valid = col.validity_or_true()
    mag, negative, valid = _parse_decimal(
        chars, lengths, in_valid, precision, scale, bits, ansi_mode, strip
    )
    if ansi_mode:
        _raise_first_error(col, ~valid & in_valid)
    zero = torch.zeros_like(mag[0])
    mag = u128.where(valid, mag, (zero, zero))
    if bits == 128:
        data = u128.to_signed_limbs(mag, negative)
    else:
        data = torch.where(negative, -mag[0], mag[0]).to(out_type.torch_dtype)
    return Column(out_type, data, _validity_or_none(valid))


# ---------------------------------------------------------------------------
# string -> float
# ---------------------------------------------------------------------------

# 10^(32q) for q in 0..10 (inf past 10^308) and 10^r for r in 0..31: the
# JAX package's two-level decomposition of 10^a, kept so every value is
# the same (hi*lo double-rounds, <= ~1.5 ulp in f64; the reference
# computes these with CUDA exp10(), <= 1 ulp, cast_string_to_float.cu:
# 182-187, so this is the same error class and f32 outputs are
# unaffected).
_POW10_HI = tuple(float(10 ** (32 * q)) if 32 * q <= 308 else float("inf") for q in range(11))
_POW10_LO = tuple(float(10**r) for r in range(32))


def _pow10_subneg():
    from fractions import Fraction

    # 10^(nd10 - 308) for nd10 in 1..20, correctly rounded
    return tuple(float(Fraction(1, 10 ** (308 - nd10))) for nd10 in range(1, 21))


_POW10_SUBNEG = _pow10_subneg()
# exactly-rounded 10^k, k in [0, 56]: the subnormal branch divides by
# 10^(nd10-1+shift), and the exponents real data uses take this single
# correctly rounded table instead of the two-level product
_POW10_SUB1 = tuple(float(10**k) for k in range(57))


def _masked_sel_f64(tbl, idx):
    """``tbl[idx]`` as float64, 0.0 where ``idx`` is outside the table
    (the JAX package's masked-select chain; on the card one gather from
    a small device table gives the same values)."""
    t = device_table(tbl, torch.float64, idx.device)
    inside = (idx >= 0) & (idx < len(tbl))
    got = t[torch.clamp(idx, 0, len(tbl) - 1).long()]
    return torch.where(inside, got, torch.zeros((), dtype=torch.float64, device=idx.device))


def _pow10_pos_f64(a):
    """10^a for a >= 0 (clipped to [0, 341]; inf past 308): the
    correctly rounded single table up to a = 56, the hi*lo product
    above."""
    a = torch.clamp(a, 0, 341)
    two_level = _masked_sel_f64(_POW10_HI, a >> 5) * _masked_sel_f64(_POW10_LO, a & 31)
    # the JAX package's normalisation for the TPU's emulated f64, where
    # an overflowing finite product gives nan; under IEEE it is inf
    # already, so this changes nothing
    two_level = torch.where(torch.isnan(two_level), torch.inf, two_level)
    return torch.where(a <= 56, _masked_sel_f64(_POW10_SUB1, torch.clamp(a, max=56)), two_level)


# the reference keeps up to 19 significant digits (max_safe_digits = 19,
# ipow[0..18]) and conditionally one more when it still fits max_holding
_MAX_SAFE_DIGITS = 19
_MAX_HOLDING = (2**64 - 1 - 9) // 10


def _lower(c):
    return torch.where((c >= ord("A")) & (c <= ord("Z")), c + 32, c)


def _u64_to_f64(bits):
    """Correctly rounded float64 of the uint64 held in int64 ``bits``.
    Values >= 2^63 (negative bits) halve with the dropped bit kept as a
    sticky bit, convert, and double: the sticky bit sits below the
    rounding position, so ties and rounding are decided as for the full
    value."""
    half = ((bits >> 1) & 0x7FFFFFFFFFFFFFFF) | (bits & 1)
    return torch.where(bits < 0, half.to(torch.float64) * 2.0, bits.to(torch.float64))


def _parse_float(chars, lengths, in_valid):
    """Returns (value_f64, valid, except_) per row. Mirrors
    cast_string_to_float.cu string_to_float<T>:54-599 including its
    quirks: 'nan' only as the whole 3-char string, inf/infinity must
    end the string (invalid but NOT an ANSI error), trailing f/F/d/D
    allowed after digits but not after a zero value, manual exponents
    capped at 4 digits, 19(+1) significant digit cap with the rest
    truncated into the exponent.

    The digits are a uint64 held as int64 bits (up to 10^19 + 9 > 2^63),
    so their compares are unsigned and their float64 is
    ``_u64_to_f64``. Results below the minimum normal double are IEEE
    subnormals, as the reference's CUDA doubles give; the JAX package
    on the CPU flushes them to +-0.0 (its documented deviation, ROADMAP
    Queue 3)."""
    n, L = chars.shape
    dev = chars.device
    pos, in_str, ws, digit, negative, start = _prologue(chars, lengths, True)
    lc = _lower(chars)

    def chars_at(idx):
        return lane_select(lc, torch.clamp(idx, 0, L - 1))

    def word_at(base, word):
        m = torch.ones((n,), dtype=torch.bool, device=dev)
        for off, ch in enumerate(word):
            p = base + off
            m = m & (p < lengths) & (chars_at(p) == ord(ch))
        return m

    is_nan = word_at(start, "nan")
    nan_exact = is_nan & (lengths == 3)

    is_inf3 = word_at(start, "inf")
    inf3_end = is_inf3 & (start + 3 == lengths)
    is_inf8 = is_inf3 & word_at(start + 3, "inity")
    inf8_end = is_inf8 & (start + 8 == lengths)
    inf_value = inf3_end | inf8_end

    # ---- mantissa: digits with one optional dot ----
    after = pos >= start[:, None]
    dot = (chars == ord(".")) & in_str
    D1 = _first_true(dot & after, L + 1)
    mant_ok = digit | (pos == D1[:, None])
    # M = end of the contiguous mantissa run from `start`
    not_m = after & in_str & ~mant_ok
    M = torch.minimum(_first_true(not_m, L + 1), lengths)
    in_mant = after & (pos < M[:, None])
    mdigit = digit & in_mant
    has_dot = D1 < M

    k_idx = lane_count(mdigit) - 1
    nd = mdigit.sum(dim=1, dtype=_I32)
    pre_dot = (mdigit & (pos < D1[:, None])).sum(dim=1, dtype=_I32)
    m_nz = mdigit & (chars != ord("0"))
    fz_pos = _first_true(m_nz, L + 1)
    first_nz = torch.where(fz_pos <= L, lane_select(k_idx, torch.clamp(fz_pos, 0, L - 1)), nd)
    stripped = torch.minimum(torch.where(has_dot, pre_dot, nd), first_nz)
    R = nd - stripped  # real digit count
    seen_valid_digit = (nd > 0) | (stripped > 0)

    # keep up to 19 digits; maybe one more if it fits under max_holding
    kept18 = torch.clamp(R, max=_MAX_SAFE_DIGITS)
    act18 = (
        mdigit
        & (k_idx >= stripped[:, None])
        & (k_idx < (stripped + kept18)[:, None])
    )
    exp18 = (stripped + kept18)[:, None] - 1 - k_idx
    p10_19 = _table([10**i for i in range(19)], dev)
    w18 = p10_19[torch.clamp(exp18, 0, 18).long()]
    dv = torch.where(act18, (chars - ord("0")).to(_I64), 0)
    digits18 = (dv * w18).sum(dim=1)  # uint64 bits, < 10^19

    extra_pos = _first_true(mdigit & (k_idx == (stripped + kept18)[:, None]), L + 1)
    extra_d = torch.where(
        extra_pos <= L, lane_select(chars, torch.clamp(extra_pos, 0, L - 1)) - ord("0"), 0
    ).to(_I64)
    # (phrased as a division so digits18 * 10 cannot wrap uint64)
    take_extra = (R > _MAX_SAFE_DIGITS) & ~u128.ult((_MAX_HOLDING - extra_d) // 10, digits18)
    digits = torch.where(take_extra, digits18 * 10 + extra_d, digits18)
    kept = kept18 + take_extra.to(_I32)
    trunc = R - kept
    decimal_pos = torch.clamp(pre_dot - stripped, min=0)
    exp_base = trunc - torch.where(has_dot, R - decimal_pos, 0)

    # ---- manual exponent at M ----
    c_M = chars_at(M)
    has_e = (M < lengths) & (c_M == ord("e"))
    c_M1 = chars_at(M + 1)
    e_sign = has_e & (M + 1 < lengths) & ((c_M1 == ord("+")) | (c_M1 == ord("-")))
    e_neg = e_sign & (c_M1 == ord("-"))
    eds = M + 1 + e_sign.to(_I32)
    in_e4 = (pos >= eds[:, None]) & (pos < (eds + 4)[:, None]) & in_str
    e_nondigit = _first_true(in_e4 & ~digit, L + 1)
    ede = torch.minimum(torch.minimum(e_nondigit, eds + 4), lengths)
    e_ndig = torch.clamp(ede - eds, min=0)
    e_exp = ede[:, None] - 1 - pos
    e_act = (pos >= eds[:, None]) & (pos < ede[:, None]) & digit
    e_w = p10_19[torch.clamp(e_exp, 0, 4).long()]
    e_val = torch.where(e_act, (chars - ord("0")).to(_I64) * e_w, 0).sum(dim=1)
    manual_exp = torch.where(has_e, torch.where(e_neg, -e_val, e_val), 0)
    bad_exp = has_e & (e_ndig == 0)

    # ---- trailing junk ----
    T0 = torch.where(has_e, ede, M)
    zero_digits = digits == 0
    # nonzero: optional single f/F/d/D suffix
    c_T0 = chars_at(T0)
    fd = (T0 < lengths) & ((c_T0 == ord("f")) | (c_T0 == ord("d"))) & ~zero_digits
    T1 = T0 + fd.to(_I32)
    trailing_junk = ~torch.all(~((pos >= T1[:, None]) & in_str) | ws, dim=1)
    # a second dot inside what would be the mantissa is caught here too:
    # the mantissa run stops at it and it becomes trailing junk

    # ---- validity / except composition ----
    valid = in_valid & (lengths > 0)
    number_path = ~is_nan & ~is_inf3
    no_digit = number_path & ~seen_valid_digit
    bad = no_digit | (number_path & (bad_exp | trailing_junk))
    valid = valid & ~bad
    except_ = in_valid & bad
    # nan
    valid = torch.where(is_nan, in_valid & nan_exact, valid)
    except_ = torch.where(is_nan, in_valid & ~nan_exact, except_)
    # inf: invalid with trailing garbage, but never an ANSI error
    valid = torch.where(is_inf3, in_valid & inf_value, valid)
    except_ = except_ & ~is_inf3

    # ---- value assembly (float64, reference lines 150-195) ----
    exp_ten = (exp_base + manual_exp).to(_I32)
    digitsf = _u64_to_f64(digits)
    signf = torch.where(negative, -1.0, 1.0).to(torch.float64)

    # digit count of `digits` (unsigned: bits >= 2^63 exceed every power)
    nd10 = ((digits[:, None] < 0) | (digits[:, None] >= p10_19[None, :])).sum(dim=1, dtype=_I32)
    shift = -307 - exp_ten
    subnormal = shift > 0
    # subnormal: digits / 10^(nd10-1+shift) * 10^(exp_ten+nd10-1+shift);
    # both factors read from the exactly rounded tables (the second
    # exponent is always nd10 - 308); shift > 36 means the true
    # magnitude is below the min subnormal
    sub_val = (
        digitsf / _masked_sel_f64(_POW10_SUB1, torch.clamp(nd10 - 1 + shift, 0, 56))
    ) * _masked_sel_f64(_POW10_SUBNEG, nd10 - 1)
    sub_val = torch.where(shift > 36, 0.0, sub_val)
    p_abs = _pow10_pos_f64(torch.abs(exp_ten))
    norm_val = torch.where(exp_ten < 0, digitsf / p_abs, digitsf * p_abs)
    value = torch.where(subnormal, sub_val, norm_val)
    # the JAX package's TPU normalisation (no legitimate nan arises
    # here: the nan literal is applied below); unchanged under IEEE
    value = torch.where(torch.isnan(value), torch.inf, value)
    value = torch.where(exp_ten > 308, torch.inf, value)
    value = torch.where(zero_digits, 0.0, value)
    value = signf * value
    value = torch.where(inf_value, signf * torch.inf, value)
    value = torch.where(is_nan & nan_exact, torch.nan, value)
    return value, valid, except_


def string_to_float(
    col: Column,
    out_type: DType,
    ansi_mode: bool = False,
    width: Optional[int] = None,
) -> Column:
    """CastStrings.toFloat (CastStrings.java:91,
    cast_string_to_float.cu string_to_float:656). Computes in float64
    and narrows, as the reference's double-math-then-cast does.
    ``width`` pins the char-matrix width (see string_to_integer). On the
    card both targets take the native cast_float64 kernel (0.0 at
    invalid rows), whose FLOAT64 values FLOAT32 narrows."""
    if out_type.kind != "float":
        raise TypeError(f"not a float type: {out_type}")
    _check_width_eager(col, width)
    if col.data.device.type == "cuda":
        value, valid, status = native.cast_float64(col.data, col.offsets, col.validity)
        if ansi_mode:
            _raise_status_error(col, status)
        return Column(out_type, value.to(out_type.torch_dtype), _validity_or_none(valid))
    chars, lengths = to_char_matrix(col, width)
    value, valid, except_ = _parse_float(chars, lengths, col.validity_or_true())
    if ansi_mode:
        _raise_first_error(col, except_)
    value = torch.where(valid, value, 0.0).to(out_type.torch_dtype)
    return Column(out_type, value, _validity_or_none(valid))
