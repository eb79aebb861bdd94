"""TPC-H Q5 at SF100 through the port: the tables as port Tables over the
data that ``tpch_q5_sf100_ref.make_data`` made, the build side, and the
entries the traffic's tasks call.

The build side (ASIA's nations, their customers, the orders of 1994
joined to them: o_orderkey, c_nationkey, n_name) is made anew at the
start of every pass (``begin_pass``), before any task probes it, through
the eager façade (``Filter.apply``, ``Join.join``), as a broadcast build
side is made once per query. Per lineitem batch, the ``pipeline`` entry:
one ``api.Pipeline`` of join(build on l_orderkey) -> join(supplier on
l_suppkey, c_nationkey) -> map(revenue through
``DecimalUtils.multiply128``) -> group_by(n_name, sum), ``run`` per
batch, over the build side of its pass.

The final merge is Spark's final aggregate through the façade: a
group-by over the concatenated partials and the ORDER BY revenue DESC.
"""

from __future__ import annotations

import torch

from portside import batch_bounds, concat, rows_of, widen
from spark_rapids_jni_tpu_torch import DATE32, DECIMAL64, INT64, STRING, Column, Table
from spark_rapids_jni_tpu_torch.api import (
    Aggregation,
    DecimalUtils,
    Filter,
    Join,
    Pipeline,
    SortOrder,
)
from spark_rapids_jni_tpu_torch.columnar.strings import to_char_matrix

Agg = Aggregation.Agg
NAME_WIDTH = 16  # bytes pinned for n_name (the longest, UNITED KINGDOM, has 14)


def revenue(t):
    """The map: l_extendedprice * (1 - l_discount), (12,2) x (13,2) ->
    (26,4), appended."""
    r = DecimalUtils.multiply128(widen(t.columns[2].data, 12),
                                 widen(100 - t.columns[3].data, 13), 4)
    return Table(list(t.columns) + [r.columns[1]])


def string_equals(col, literal: str):
    """bool [n]: the string column equals ``literal``."""
    chars, _ = to_char_matrix(col)
    lit = list(literal.encode())
    if len(lit) > chars.shape[1]:
        return torch.zeros(chars.shape[0], dtype=torch.bool, device=chars.device)
    want = torch.full((chars.shape[1],), -1, dtype=chars.dtype, device=chars.device)
    want[: len(lit)] = torch.tensor(lit, dtype=chars.dtype)
    return (chars == want).all(dim=1) & col.validity_or_true()


def build_side(t: dict, cfg: dict):
    """(o_orderkey, c_nationkey, n_name) of the orders of the year whose
    customer is in the region, through the eager façade."""
    region = t["region"]
    picked = Filter.apply(region, string_equals(region.columns[1], cfg["region"]))
    # n_nationkey, n_name, n_regionkey, r_regionkey, r_name
    nations = Join.join(t["nation"], picked, [2], [0])
    # c_custkey, c_nationkey + the nation's columns
    cust = Join.join(t["customer"], nations, [1], [0])
    cust = Table([cust.columns[0], cust.columns[1], cust.columns[3]])
    date = t["orders"].columns[2].data
    orders = Filter.apply(t["orders"], (date >= cfg["orderdate_from_days"])
                          & (date < cfg["orderdate_before_days"]))
    # o_orderkey, o_custkey, o_orderdate, c_custkey, c_nationkey, n_name
    oc = Join.join(orders, cust, [1], [0])
    return Table([oc.columns[0], oc.columns[4], oc.columns[5]])


def q5_pipeline(build, supplier):
    """The per-batch chain over ``build``."""
    # l_orderkey, l_suppkey, l_extendedprice, l_discount, o_orderkey,
    # c_nationkey, n_name (+ s_suppkey, s_nationkey, + revenue)
    return (Pipeline("q5_sf100")
            .join(build, [0], [0], "inner", right_string_widths={2: NAME_WIDTH})
            .join(supplier, [1, 5], [0, 1], "inner", left_string_widths={6: NAME_WIDTH})
            .map(revenue, name="q5_revenue")
            .group_by([6], [Agg("sum", 9)], capacity=32, string_widths={6: NAME_WIDTH}))


class Query:
    """The batches, the entries, the pass's first stage, the answer on the
    host and the merge."""

    def __init__(self, data: dict, cfg: dict, traffic: dict, device):
        self.bounds = batch_bounds(cfg, traffic)
        self.cfg = cfg

        def col(k, dt=INT64):
            return Column(dt, data[k])

        self.dims = {
            "region": Table([Column(INT64, torch.arange(len(cfg["regions"]), device=device)),
                             Column.from_pylist(list(cfg["regions"]), STRING, device=device)]),
            "nation": Table([
                Column(INT64, torch.arange(len(cfg["nations"]), device=device)),
                Column.from_pylist([nm for nm, _ in cfg["nations"]], STRING, device=device),
                Column(INT64, torch.tensor([r for _, r in cfg["nations"]], device=device))]),
            "customer": Table([col("c_custkey"), col("c_nationkey")]),
            "orders": Table([col("o_orderkey"), col("o_custkey"), col("o_orderdate", DATE32)]),
        }
        self.supplier = Table([col("s_suppkey"), col("s_nationkey")])
        dec = DECIMAL64(12, 2)
        self.tables = [Table([Column(INT64, data["l_orderkey"][lo:hi]),
                              Column(INT64, data["l_suppkey"][lo:hi]),
                              Column(dec, data["l_extendedprice"][lo:hi]),
                              Column(dec, data["l_discount"][lo:hi])])
                       for lo, hi in self.bounds]
        self.build = self.pipe = None
        self.entries = {"pipeline": lambda i: self.pipe.run(self.tables[i])}

    def begin_pass(self):
        """The pass's first stage: the build side made anew. The first
        pass binds it to the Pipeline; each later one writes its side
        over the bound one, which has its shape (the same rows every
        pass). So the Pipeline keeps its plan: a new Pipeline would
        capture anew, since a map that reads the port's own classes
        keys its plan by a token of that object alone."""
        side = build_side(self.dims, self.cfg)
        if self.build is None:
            self.build, self.pipe = side, q5_pipeline(side, self.supplier)
            return
        for dst, src in zip(self.build.columns, side.columns):
            for a, b in ((dst.data, src.data), (dst.validity, src.validity),
                         (dst.offsets, src.offsets)):
                if (a is None) != (b is None) or (a is not None and a.shape != b.shape):
                    raise ValueError("a pass's build side has another shape than the first's")
                if a is not None:
                    a.copy_(b)

    @property
    def batches(self):
        return self.bounds

    def batch_rows(self, i: int) -> int:
        lo, hi = self.bounds[i]
        return hi - lo

    def answer(self, result) -> list:
        """A batch's (n_name, revenue) rows on the host, by n_name."""
        return sorted(tuple(r) for r in rows_of(result))

    def merge(self, partials) -> list:
        """Q5's rows from the batches' partial aggregates, on the host."""
        g = Aggregation.groupBy(concat(partials), [0], [Agg("sum", 1)])
        out = SortOrder.sort(g, [SortOrder.SortKey(1, ascending=False)])
        return [tuple(r) for r in rows_of(out)]

    def decimal128_launches(self, entry_name: str, i: int):
        """Rows given to each decimal128 launch of one call of the entry
        over batch ``i``: the Pipeline's map runs over the second join's
        padded output, whose capacity is the batch's rows."""
        return [self.batch_rows(i)]


def prepare(data: dict, cfg: dict, traffic: dict, device) -> Query:
    return Query(data, cfg, traffic, device)
