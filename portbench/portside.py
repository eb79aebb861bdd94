"""What the configurations' port-side modules (``configs/<c>.py``) share:
batches as row ranges, decimals widened to DECIMAL128, the partials
concatenated for a final merge, and a result's rows on the host."""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch import DECIMAL128, Column, Table


def batch_bounds(cfg: dict, traffic: dict) -> list:
    """(lo, hi) lineitem row range of each batch."""
    n, b = int(cfg["lineitem_rows"]), int(traffic["batch_rows"])
    return [(lo, min(lo + b, n)) for lo in range(0, n, b)]


def widen(data, precision):
    """DECIMAL(12,2) int64 storage as DECIMAL128(precision, 2) limbs (the
    1 - x and 1 + x literals type as DECIMAL(13,2))."""
    return Column(DECIMAL128(precision, 2), torch.stack([data, data >> 63], dim=-1))


def concat(tables):
    """Rows of ``tables`` (one schema) in order, as the exchange to the
    final aggregate hands them over."""
    cols = []
    for parts in zip(*(t.columns for t in tables)):
        offsets = None
        if parts[0].is_varlen:
            offs, base = [parts[0].offsets[:1]], 0
            for c in parts:
                offs.append(c.offsets[1:] + base)
                base += c.data.shape[0]
            offsets = torch.cat(offs)
        cols.append(Column(parts[0].dtype, torch.cat([c.data for c in parts]),
                           torch.cat([c.validity_or_true() for c in parts]), offsets))
    return Table(cols)


def rows_of(table) -> list:
    """A result table's rows as lists of Python values."""
    return [list(r) for r in zip(*table.to_pylists())]
