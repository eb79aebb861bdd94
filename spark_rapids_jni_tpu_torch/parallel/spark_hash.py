"""Spark-exact Murmur3_x86_32 column hashing (PyTorch twin of the JAX
package's ``parallel/spark_hash.py``).

Spark's HashPartitioning places rows with Murmur3Hash(cols, 42): each
column's hash seeds the next and a null leaves the running hash as it
was. Ints hash as one 4-byte block, longs/doubles/precision <= 18
decimals as two, floats as their int bits (-0.0 normalized, NaN
canonical), strings and precision > 18 decimals as bytes
(hashUnsafeBytes).

A hash is carried as int32 holding the uint32 bits: torch's uint32 has
no shifts on the CPU, and int32 multiply/xor/shift-left wrap exactly
like uint32. The one difference, the logical right shift, is an
arithmetic shift with the sign-extended bits masked off.

On CUDA tensors the fixed-width chain runs in the hand-written kernel
(``kernels/murmur3.py``); the columns Spark hashes as bytes are routed
to the plain torch chain here by their dtype, before any launch.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..columnar.table import Table


def _i32(u: int) -> int:
    """uint32 bits as the int32 value torch carries them in."""
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= 1 << 31 else u


_C1 = _i32(0xCC9E2D51)
_C2 = _i32(0x1B873593)
_MC = _i32(0xE6546B64)
_F1 = _i32(0x85EBCA6B)
_F2 = _i32(0xC2B2AE35)

DEFAULT_SEED = 42  # Spark's HashPartitioning seed

# multiplier of the salted partition seeds (the 32-bit golden-ratio
# constant): distinct salts land on well-separated seeds
_SALT_MULT = 0x9E3779B1


def salted_seed(salt: int) -> int:
    """Partition seed for a salted (re-rolled) exchange. ``salt=0`` is
    Spark's HashPartitioning placement; ``salt>0`` re-rolls which
    partition owns each distinct key while equal keys still hash
    identically. Returns the seed as a uint32 value."""
    if salt == 0:
        return DEFAULT_SEED
    return int((DEFAULT_SEED + salt * _SALT_MULT) & 0xFFFFFFFF)


def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical shift right of int32 lanes."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 32 - r)


def mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    k1 = _rotl(k1 * _C1, 15) * _C2
    h1 = _rotl(h1 ^ k1, 13)
    return h1 * 5 + _MC


def fmix(h1: torch.Tensor, length) -> torch.Tensor:
    """Final avalanche; ``length`` is an int or an int32 [n] tensor."""
    h1 = h1 ^ length
    h1 = h1 ^ _lsr(h1, 16)
    h1 = h1 * _F1
    h1 = h1 ^ _lsr(h1, 13)
    h1 = h1 * _F2
    return h1 ^ _lsr(h1, 16)


def _split_words(x: torch.Tensor):
    """int64 [n] -> (lo, hi) int32 words (``.to`` wraps)."""
    return [(x & 0xFFFFFFFF).to(torch.int32), (x >> 32).to(torch.int32)]


def column_word_planes(col: Column):
    """Lower one fixed-width column to its Murmur3 32-bit word planes:
    returns (list of int32 [n] tensors, fmix length). One definition
    shared by the plain chain and the kernel's lowering
    (``kernels/murmur3.table_plan``)."""
    dt = col.dtype
    if dt.kind == "float":
        # floatToIntBits semantics: -0.0 -> 0.0, canonical NaN
        v = torch.where(col.data == 0.0, torch.zeros_like(col.data), col.data)
        v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
        if dt.bits == 32:
            return [v.view(torch.int32)], 4
        return _split_words(v.view(torch.int64)), 8
    if dt.kind == "decimal" and (dt.bits <= 64 or (dt.precision or 38) <= 18):
        # hashLong of the unscaled value (DECIMAL32 sign-extends; a
        # <= 18-precision value in DECIMAL128 storage fits its low limb)
        x = col.data[:, 0] if dt.bits == 128 else col.data
        return _split_words(x.to(torch.int64)), 8
    if dt.kind in ("bool", "int", "date", "timestamp"):
        if dt.bits == 64:
            return _split_words(col.data), 8
        return [col.data.to(torch.int32)], 4
    raise NotImplementedError(f"spark hash of {dt} not supported yet")


def hash_string_update(seed, chars: torch.Tensor, lengths: torch.Tensor, validity=None):
    """Running hash update for a byte column given its padded char
    matrix (``chars`` int32 [n, L], padding -1) and byte lengths:
    Spark's hashUnsafeBytes — the 4-byte-aligned prefix as
    little-endian int blocks, each tail byte as a sign-extended int
    block, then fmix by the byte length. ``seed`` is an int or an int32
    [n] running hash."""
    n, L = chars.shape
    if isinstance(seed, int):
        seed = _i32(seed)
    h = torch.broadcast_to(torch.as_tensor(seed, dtype=torch.int32, device=chars.device), (n,))
    seed_t = h
    b = chars.clamp(min=0)
    lengths = lengths.to(torch.int32)
    n_full = lengths // 4
    for j in range(L // 4):
        word = (
            b[:, 4 * j]
            | (b[:, 4 * j + 1] << 8)
            | (b[:, 4 * j + 2] << 16)
            | (b[:, 4 * j + 3] << 24)
        )
        h = torch.where(j < n_full, mix_h1(h, word), h)
    # the unaligned tail is at most 3 bytes
    aligned = n_full * 4
    for t in range(min(3, L)):
        pos_t = aligned + t
        byte = torch.gather(chars, 1, pos_t.clamp(0, L - 1).to(torch.int64)[:, None])[:, 0]
        signed = torch.where(byte >= 128, byte - 256, byte)
        h = torch.where(pos_t < lengths, mix_h1(h, signed), h)
    out = fmix(h, lengths)
    if validity is not None:
        out = torch.where(validity, out, seed_t)
    return out


def _dec128_byte_matrix(col: Column):
    """DECIMAL128 -> (chars int32 [n, 16], nbytes int32 [n]): the
    minimal big-endian two's-complement bytes of the unscaled value,
    left-aligned with -1 padding — BigDecimal.unscaledValue()
    .toByteArray(), which Spark hashes for precision > 18 decimals."""
    lo, hi = col.data[:, 0], col.data[:, 1]
    parts = [
        ((word >> (8 * k)) & 0xFF).to(torch.int32)
        for word in (hi, lo)
        for k in range(7, -1, -1)
    ]
    B = torch.stack(parts, dim=1)  # [n, 16] big-endian bytes
    sign_bit = (hi < 0).to(torch.int32)
    sign_byte = sign_bit * 0xFF
    is_sb = B == sign_byte[:, None]
    # lead_excl[:, p]: every byte before p is a redundant sign byte
    lead_excl = torch.cat(
        [
            torch.ones((B.shape[0], 1), dtype=torch.bool, device=B.device),
            torch.cumprod(is_sb.to(torch.int32), dim=1)[:, :-1].to(torch.bool),
        ],
        dim=1,
    )
    msb_ok = ((B >> 7) & 1) == sign_bit[:, None]
    valid_p = lead_excl & msb_ok  # p = 0 is always valid
    # the last valid start p is where the minimal encoding begins
    p_max = 15 - torch.argmax(valid_p.flip(1).to(torch.int32), dim=1).to(torch.int32)
    nbytes = 16 - p_max
    ar = torch.arange(16, dtype=torch.int32, device=B.device)[None, :]
    idx = (p_max[:, None] + ar).clamp(0, 15).to(torch.int64)
    vals = torch.gather(B, 1, idx)
    return torch.where(ar < nbytes[:, None], vals, -1), nbytes


def is_bytes_hashed_column(col: Column) -> bool:
    """True for columns Spark hashes as variable-length bytes
    (hashUnsafeBytes) rather than fixed word blocks: strings/binary and
    DECIMAL128 above long precision. Decides, from the dtype alone,
    which columns stay off the kernel."""
    dt = col.dtype
    return col.is_varlen or (
        dt.kind == "decimal" and dt.bits == 128 and (dt.precision or 38) > 18
    )


def column_hash_update(col: Column, seed):
    """Running hash update for one column (plain torch); ``seed`` is an
    int or an int32 [n] running hash."""
    if col.is_varlen:
        from ..columnar import strings as strs

        chars, lengths = strs.to_char_matrix(col)
        return hash_string_update(seed, chars, lengths, col.validity)
    if is_bytes_hashed_column(col):
        chars, nbytes = _dec128_byte_matrix(col)
        return hash_string_update(seed, chars, nbytes, col.validity)
    words, length = column_word_planes(col)
    if isinstance(seed, int):
        seed = _i32(seed)
    h = torch.as_tensor(seed, dtype=torch.int32, device=col.device)
    h1 = h
    for w in words:
        h1 = mix_h1(h1, w)
    h1 = fmix(h1, length)
    if col.validity is not None:
        return torch.where(col.validity, h1, h)  # nulls: hash unchanged
    return h1


def hash_columns(table: Table, seed: int = DEFAULT_SEED) -> torch.Tensor:
    """int32 [n] (the uint32 bits of) Spark's Murmur3 hash over the
    table's columns.

    A table of fixed-width columns goes through
    ``kernels.murmur3.hash_columns`` (the kernel on CUDA tensors, its
    plain version on CPU tensors). A table with a column Spark hashes
    as bytes runs the plain per-column chain, as the JAX package's
    kernel twin does."""
    if not any(is_bytes_hashed_column(c) for c in table.columns):
        from ..kernels import murmur3

        return murmur3.hash_columns(table, seed)
    dev = table.columns[0].device
    h = torch.full((table.num_rows,), _i32(seed), dtype=torch.int32, device=dev)
    for col in table.columns:
        h = column_hash_update(col, h)
    return h


def pmod(h: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Spark's non-negative mod over the int32 view of the hash."""
    m = num_partitions
    return ((h.to(torch.int32) % m) + m) % m


def partition_ids(table: Table, num_partitions: int, seed: int = DEFAULT_SEED):
    """int32 [n] partition ids a la Spark HashPartitioning:
    ``pmod(hash, p)``."""
    return pmod(hash_columns(table, seed), num_partitions)
