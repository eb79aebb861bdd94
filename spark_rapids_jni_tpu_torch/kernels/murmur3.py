"""Spark Murmur3 multi-column hash chain: the hand-written Hopper kernel
(``csrc/murmur3.cu``), its wrapper, and its plain PyTorch version.

Replaces the Pallas TPU kernel of the JAX package
(``spark_rapids_jni_tpu/kernels/murmur3.py``, ``_hash_kernel`` launched
through ``pl.pallas_call``). The contract is the same: callers lower
every key column into one or two int32 word planes (``words [W, n]``),
stack the validity of nullable columns as int8 planes
(``valids [V, n]``, V may be 0), and pass a static ``plan`` — one
``(plane_ids, fmix_length, valid_plane_or_-1)`` entry per chained
column. The result is int32 ``[n]`` holding the uint32 hash bits.

``hash_planes`` launches the kernel on CUDA tensors and takes the plain
version on CPU tensors; there is no fallback from one to the other.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..parallel import spark_hash as _sh
from . import _build

MAX_COLS = 32  # the kernel's plan capacity (MURMUR3_MAX_COLS)

launches = 0  # kernel launches since the caller last set it to 0


class _Plan(ctypes.Structure):
    _fields_ = [
        ("n_cols", ctypes.c_int32),
        ("first_plane", ctypes.c_int32 * MAX_COLS),
        ("n_planes", ctypes.c_int32 * MAX_COLS),
        ("fmix_len", ctypes.c_int32 * MAX_COLS),
        ("valid_plane", ctypes.c_int32 * MAX_COLS),
    ]


def _check(words: torch.Tensor, valids: torch.Tensor, plan) -> None:
    if words.dtype != torch.int32 or words.dim() != 2:
        raise TypeError(f"words must be int32 [W, n], got {words.dtype} {tuple(words.shape)}")
    if valids.dtype != torch.int8 or valids.dim() != 2:
        raise TypeError(f"valids must be int8 [V, n], got {valids.dtype} {tuple(valids.shape)}")
    if valids.shape[1] != words.shape[1] or valids.device != words.device:
        raise ValueError("words and valids must have the same rows and device")
    W, V = words.shape[0], valids.shape[0]
    for planes, length, vp in plan:
        if not planes or list(planes) != list(range(planes[0], planes[0] + len(planes))):
            raise ValueError(f"a column's planes must be consecutive, got {planes}")
        if planes[-1] >= W or vp >= V or length not in (4, 8):
            raise ValueError(f"bad plan entry {(planes, length, vp)} for W={W}, V={V}")


def hash_planes_plain(words, valids, plan, seed: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same chain over the
    same planes, on whatever device the tensors are on."""
    h = torch.full((words.shape[1],), _sh._i32(seed), dtype=torch.int32, device=words.device)
    for planes, length, vp in plan:
        h1 = h
        for p in planes:
            h1 = _sh.mix_h1(h1, words[p])
        h1 = _sh.fmix(h1, length)
        h = h1 if vp < 0 else torch.where(valids[vp] != 0, h1, h)
    return h


def _launch(words, valids, plan, seed: int) -> torch.Tensor:
    global launches
    if len(plan) > MAX_COLS:
        raise ValueError(f"the kernel chains at most {MAX_COLS} columns, got {len(plan)}")
    words = words.contiguous()
    valids = valids.contiguous()
    n = words.shape[1]
    out = torch.empty((n,), dtype=torch.int32, device=words.device)
    p = _Plan()
    p.n_cols = len(plan)
    for c, (planes, length, vp) in enumerate(plan):
        p.first_plane[c] = planes[0]
        p.n_planes[c] = len(planes)
        p.fmix_len[c] = length
        p.valid_plane[c] = vp
    fn = _build.load("murmur3").murmur3_chain
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(_Plan), ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    dev = words.device
    with torch.cuda.device(dev):
        rc = fn(
            words.data_ptr(), valids.data_ptr(), out.data_ptr(), n, ctypes.byref(p),
            seed & 0xFFFFFFFF,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"murmur3_chain launch failed with CUDA error {rc}")
    launches += 1
    return out


def hash_planes(
    words: torch.Tensor,
    valids: torch.Tensor,
    plan: Tuple[Tuple[Tuple[int, ...], int, int], ...],
    seed: int,
) -> torch.Tensor:
    """Hash ``n`` rows from ``words`` int32 [W, n], ``valids`` int8
    [V, n] and the static ``plan``; ``seed`` is a uint32 value. Returns
    int32 [n] (the uint32 bits of the Spark hash). Launches the kernel
    on CUDA tensors, runs the plain version on CPU tensors."""
    _check(words, valids, plan)
    if words.device.type == "cuda":
        return _launch(words, valids, plan, seed)
    if words.device.type == "cpu":
        return hash_planes_plain(words, valids, plan, seed)
    raise ValueError(f"no murmur3 path for device {words.device}")


def table_plan(table):
    """Lower a Table's fixed-width columns into the kernel inputs via
    the same per-column word-plane lowering the plain chain uses
    (``parallel/spark_hash.column_word_planes``)."""
    planes, vplanes, plan = [], [], []
    for col in table.columns:
        col_words, length = _sh.column_word_planes(col)
        ids = tuple(range(len(planes), len(planes) + len(col_words)))
        planes.extend(col_words)
        vid = -1
        if col.validity is not None:
            vid = len(vplanes)
            vplanes.append(col.validity.to(torch.int8))
        plan.append((ids, length, vid))
    words = torch.stack(planes)
    if vplanes:
        valids = torch.stack(vplanes)
    else:
        valids = torch.empty((0, table.num_rows), dtype=torch.int8, device=words.device)
    return words, valids, tuple(plan)


def hash_columns(table, seed: int = _sh.DEFAULT_SEED) -> torch.Tensor:
    """int32 [n] Spark Murmur3 hash of the table through ``hash_planes``.
    Columns Spark hashes as bytes (strings, DECIMAL128 above precision
    18) are not word planes: such a table goes to the plain per-column
    chain, chosen by dtype before any launch."""
    if any(_sh.is_bytes_hashed_column(c) for c in table.columns):
        return _sh.hash_columns(table, seed)
    words, valids, plan = table_plan(table)
    return hash_planes(words, valids, plan, seed)
