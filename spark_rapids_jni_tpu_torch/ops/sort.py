"""Spark-exact multi-key table sort (PyTorch twin of the JAX package's
``ops/sort.py``).

Every Spark ordering maps onto one stable multi-operand sort, as in
the JAX package:

- each key column lowers to order-preserving operands ("order keys")
  whose ascending lexicographic order equals the Spark ordering of the
  column,
- a leading int8 null key realizes NULLS FIRST/LAST,
- DESC is bitwise NOT of the order keys,
- strings lower to ceil(L/7) int64 operands packing 7 bytes + the
  past-end sentinel in 9 bits each, from the padded char matrix.

Spark semantics: NaN sorts greater than every float and NaN == NaN;
-0.0 == 0.0; NULLS FIRST for ASC and NULLS LAST for DESC by default.

torch has no multi-operand sort. The port packs the operands into
8-byte order words (``rowgather.pack_order_words``; float operands
first become integers with the same order) and runs one stable
``torch.sort`` per word, least significant first, carrying the
permutation. Stable passes from the last word to the first give the
permutation of one stable lexicographic sort: the JAX package's, ties
included. Words that are equal in every row order nothing and are
skipped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..columnar import strings as strs
from ..columnar.column import Column
from ..columnar.table import Table
from ..utils.int128 import SIGN
from ._strategy import fused
from .rowgather import pack_order_words


@dataclasses.dataclass(frozen=True)
class SortKey:
    """One ORDER BY term: column index, direction, null placement."""

    column: int
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None => Spark default for direction

    @property
    def nulls_first_resolved(self) -> bool:
        if self.nulls_first is not None:
            return self.nulls_first
        return self.ascending  # Spark: ASC NULLS FIRST, DESC NULLS LAST


def _float_order_keys(x: torch.Tensor, ascending: bool) -> List[torch.Tensor]:
    """Float sort operands with Spark normalizations: an int8 NaN-rank
    operand (NaN greatest, NaN == NaN), then the float with
    -0.0 -> +0.0 and NaN rows zeroed. Descending negates the float."""
    nan = torch.isnan(x)
    nan_key = torch.where(nan, 1 if ascending else 0, 0 if ascending else 1).to(torch.int8)
    x = torch.where(nan | (x == 0), torch.zeros((), dtype=x.dtype, device=x.device), x)
    return [nan_key, x if ascending else -x]



def _pack_string_keys(chars: torch.Tensor, L: int) -> List[torch.Tensor]:
    """Pack an int32 [n, L] char matrix (-1 = past end) into ceil(L/7)
    int64 operands, 9 bits per byte slot (byte+1 in 0..256), preserving
    lexicographic order. Past-end (-1 -> 0) sorts before every byte, so
    a prefix sorts before its extensions. Each chunk is left-aligned to
    63 bits, so the fields are disjoint and their sum is their OR."""
    vals = (chars + 1).to(torch.int64)  # -1..255 -> 0..256
    keys = []
    for start in range(0, L, 7):
        width = min(7, L - start)
        shifts = torch.arange(54, 54 - 9 * width, -9, device=chars.device)
        keys.append((vals[:, start : start + width] << shifts).sum(dim=1))
    return keys


def order_keys(
    col: Column,
    ascending: bool,
    nulls_first: bool,
    char_matrix=None,
    force_null_key: bool = False,
) -> List[torch.Tensor]:
    """Lower one column to order-key operands (leading null key
    included). ``char_matrix`` shares one (chars, lengths) matrix per
    string column between callers. ``force_null_key`` emits the
    null-flag operand even for maskless columns."""
    valid = col.validity_or_true()
    if col.validity is None and not force_null_key:
        null_keys = []
    else:
        null_keys = [
            torch.where(valid, 1 if nulls_first else 0, 0 if nulls_first else 1).to(torch.int8)
        ]

    kind = col.dtype.kind
    if kind in ("int", "date", "timestamp", "bool"):
        data_keys = [col.data]
    elif kind == "float":
        # direction is folded into the keys (rank flip + negation)
        keys = _float_order_keys(col.data, ascending)
        return null_keys + [torch.where(valid, k, torch.zeros_like(k)) for k in keys]
    elif kind == "decimal":
        if col.dtype.bits == 128:
            hi = col.data[:, 1]
            lo = col.data[:, 0] ^ SIGN  # unsigned order as int64
            data_keys = [hi, lo]
        else:
            data_keys = [col.data]
    elif kind == "string":
        chars, _lengths = char_matrix if char_matrix is not None else strs.to_char_matrix(col)
        data_keys = _pack_string_keys(chars, chars.shape[1])
    else:
        raise NotImplementedError(f"sort key on {col.dtype}")
    if not ascending:
        data_keys = [~k for k in data_keys]
    # zero null rows' data keys so equal-null runs stay in input order
    data_keys = [torch.where(valid, k, torch.zeros_like(k)) for k in data_keys]
    return null_keys + data_keys


def _integer_key(op: torch.Tensor) -> torch.Tensor:
    """An integer operand with the order of ``op``. Floats (never NaN
    here) map through their bits with -0.0 taken as +0.0, the equality
    the JAX package's comparator applies."""
    if not op.is_floating_point():
        return op
    x = torch.where(op == 0, torch.zeros_like(op), op)
    itype, mask = (
        (torch.int64, (1 << 63) - 1) if x.dtype == torch.float64 else (torch.int32, (1 << 31) - 1)
    )
    bits = x.view(itype)
    return bits ^ ((bits >> (8 * bits.element_size() - 1)) & mask)


def stable_lex_order(operands: Sequence[torch.Tensor]):
    """(int64 [n] permutation, int64 [n, W] order words) of one stable
    ascending lexicographic sort over ``operands`` (any mix of integer
    and NaN-free float tensors). Two rows' words are equal exactly when
    their operand tuples are."""
    n = operands[0].shape[0]
    words = pack_order_words([_integer_key(o) for o in operands])
    perm = torch.arange(n, device=words.device)
    if fused():
        # no host sync inside a fused chain: a constant word sorts as
        # the identity, so sorting by every word gives the same order
        varying = [True] * words.shape[1]
    else:
        # host sync: which words vary (a constant word orders nothing)
        varying = (words != words[:1]).any(dim=0).tolist()
    for w in range(words.shape[1] - 1, -1, -1):
        if varying[w]:
            key = words[:, w] ^ SIGN  # unsigned word order as int64
            perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm, words


def sort_order(table: Table, keys: Sequence[SortKey], char_matrices=None) -> torch.Tensor:
    """Stable permutation (int32 [n]) realizing ORDER BY ``keys``."""
    n = table.num_rows
    dev = table.columns[0].device if table.columns else None
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    if not keys:
        return torch.arange(n, dtype=torch.int32, device=dev)  # no terms: identity
    operands: List[torch.Tensor] = []
    for k in keys:
        operands.extend(
            order_keys(
                table.columns[k.column],
                k.ascending,
                k.nulls_first_resolved,
                None if char_matrices is None else char_matrices.get(k.column),
            )
        )
    return stable_lex_order(operands)[0].to(torch.int32)


def gather_column(
    col: Column, perm: torch.Tensor, char_matrix=None, pad_payload: bool = False
) -> Column:
    """Row gather of one column; varlen columns repack their payload.

    A varlen column given a (chars, lengths) ``char_matrix`` gathers its
    rows from the matrix, as the JAX package does (a matrix narrower
    than a string truncates it); without one it reads the payload
    directly (``strings.take``), the same bytes. ``pad_payload=True``
    gives the payload a fixed capacity of rows x matrix width, with no
    host sync for its size."""
    idx = perm.long()
    validity = None if col.validity is None else col.validity[idx]
    if col.is_varlen:
        if char_matrix is None and not pad_payload:
            return strs.take(col, perm)
        chars, lengths = char_matrix if char_matrix is not None else strs.to_char_matrix(col)
        total = idx.shape[0] * chars.shape[1] if pad_payload else None
        return strs.from_char_matrix(chars[idx], lengths[idx], validity, total, col.dtype)
    return Column(col.dtype, col.data[idx], validity)


def gather(table: Table, perm: torch.Tensor, char_matrices=None) -> Table:
    """Row gather of a whole table, column by column; ``char_matrices``
    (column index -> (chars, lengths)) feeds ``gather_column``."""
    mats = char_matrices or {}
    cols = [gather_column(c, perm, mats.get(i)) for i, c in enumerate(table.columns)]
    return Table(cols, table.names)


def _string_key_matrices(table: Table, columns) -> dict:
    """One padded char matrix per distinct string key column."""
    return {
        i: strs.to_char_matrix(table.columns[i])
        for i in set(columns)
        if table.columns[i].is_varlen
    }


def sort_table(table: Table, keys: Sequence[SortKey]) -> Table:
    """ORDER BY: stable sort of all columns by ``keys``."""
    mats = _string_key_matrices(table, (k.column for k in keys))
    return gather(table, sort_order(table, keys, mats))
