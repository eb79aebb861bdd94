"""TPC-H Q1 at SF10 through the port: the batches as port Tables over the
data that ``tpch_q1_sf10_ref.make_data`` made, and the entries the
traffic's tasks call.

- ``pipeline``: one ``api.Pipeline`` of filter (l_shipdate <= cutoff) ->
  map (the two decimal products, through ``DecimalUtils.multiply128``) ->
  group_by((returnflag, linestatus), sum x 5, count), ``run`` per batch;
- ``eager``: the same chain through the façade op by op
  (``Filter.apply``, ``DecimalUtils.multiply128`` x 2,
  ``Aggregation.groupBy``), which bypasses the Pipeline.

The final merge is Spark's final aggregate through the façade: a
group-by over the concatenated partials, the three avgs by
``DecimalUtils.divide128`` (one call over the three sums stacked), and
the ORDER BY.
"""

from __future__ import annotations

import torch

from portside import batch_bounds, concat, rows_of, widen
from spark_rapids_jni_tpu_torch import DATE32, DECIMAL64, DECIMAL128, STRING, Column, Table
from spark_rapids_jni_tpu_torch.api import (
    Aggregation,
    DecimalUtils,
    Filter,
    Pipeline,
    SortOrder,
)

Agg = Aggregation.Agg
COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount",
           "l_tax", "l_shipdate")


def products(t):
    """q1's map: l_extendedprice * (1 - l_discount) as (26,4) and that
    times (1 + l_tax) as (38,6); keeps the flags, quantity, price and
    discount. (flag, flag, qty, price, disc_price, charge, disc)."""
    qty, price, disc, tax = t.columns[2:6]
    dp = DecimalUtils.multiply128(widen(price.data, 12), widen(100 - disc.data, 13), 4)
    ch = DecimalUtils.multiply128(dp.columns[1], widen(100 + tax.data, 13), 6)
    return Table([t.columns[0], t.columns[1], qty, price, dp.columns[1], ch.columns[1], disc])


def aggs():
    return [Agg("sum", 2), Agg("sum", 3), Agg("sum", 4), Agg("sum", 5), Agg("sum", 6),
            Agg("count", 2)]


class Query:
    """The batches, the entries, the answer on the host and the merge."""

    def __init__(self, data: dict, cfg: dict, traffic: dict, device):
        self.bounds = batch_bounds(cfg, traffic)
        cutoff = int(cfg["shipdate_cutoff_days"])
        offsets = {}
        dec = DECIMAL64(12, 2)
        self.tables = []
        for lo, hi in self.bounds:
            n = hi - lo
            if n not in offsets:
                offsets[n] = torch.arange(n + 1, dtype=torch.int32, device=device)
            v = {k: data[k][lo:hi] for k in COLUMNS}
            self.tables.append(Table([
                Column(STRING, v["l_returnflag"], None, offsets[n]),
                Column(STRING, v["l_linestatus"], None, offsets[n]),
                *(Column(dec, v[k]) for k in COLUMNS[2:6]),
                Column(DATE32, v["l_shipdate"]),
            ]))

        def shipped(t):
            return t.columns[6].data <= cutoff

        pipe = (Pipeline("q1_sf10").filter(shipped).map(products, name="q1_products")
                .group_by((0, 1), aggs(), capacity=8, string_widths={0: 8, 1: 8}))

        def eager(i):
            t = self.tables[i]
            return Aggregation.groupBy(products(Filter.apply(t, shipped(t))), [0, 1], aggs())

        self.entries = {"pipeline": lambda i: pipe.run(self.tables[i]), "eager": eager}

    @property
    def batches(self):
        return self.bounds

    def batch_rows(self, i: int) -> int:
        lo, hi = self.bounds[i]
        return hi - lo

    def answer(self, result) -> list:
        """A batch's group rows on the host, in key order."""
        return sorted(rows_of(result))

    def merge(self, partials) -> list:
        """Q1's rows from the batches' partial aggregates, on the host."""
        g = Aggregation.groupBy(concat(partials), [0, 1], [Agg("sum", c) for c in range(2, 8)])
        cnt = g.columns[7].data
        k = cnt.shape[0]
        sums = torch.cat([g.columns[c].data for c in (2, 3, 6)])
        c3 = cnt.repeat(3)
        counts = Column(DECIMAL128(20, 0), torch.stack([c3, c3 >> 63], dim=-1))
        avgs = DecimalUtils.divide128(Column(DECIMAL128(38, 2), sums), counts, 6).columns[1]
        avg = [Column(avgs.dtype, avgs.data[j * k:(j + 1) * k]) for j in range(3)]
        out = Table(g.columns[:6] + avg + [g.columns[7]])
        return rows_of(SortOrder.sort(out, [SortOrder.SortKey(0), SortOrder.SortKey(1)]))

    def decimal128_launches(self, entry_name: str, i: int):
        """Rows given to each decimal128 launch of one call of the entry
        over batch ``i``: the Pipeline's map runs both products over every
        row of the batch (the filter is a live mask there). None where the
        rows depend on the data (the eager chain compacts first)."""
        if entry_name != "pipeline":
            return None
        return [self.batch_rows(i)] * 2


def prepare(data: dict, cfg: dict, traffic: dict, device) -> Query:
    return Query(data, cfg, traffic, device)
