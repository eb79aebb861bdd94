"""TPC-H Q5 at SF100: the data made from the seed, the plain reference and
its lower-precision control. Plain PyTorch; imports nothing of the port.

The data keeps dbgen's shapes (``tpch_q5_sf100.json``): sparse order keys
(8 of every 32), customer keys off multiples of 3, 1-7 lines per order,
order dates over 1992-01-01 to 1998-08-02. It is drawn on the device with
one ``torch.Generator`` in a fixed order of calls. Decimals are unscaled
int64 at scale 2, dates days since 1970-01-01.

The reference joins by direct addressing: a table from each key to its
row (order, customer, supplier), built from the raw columns, then plain
gathers, the filters and an exact int64 sum of the revenue by nation
(``index_add_`` of integers). It works the build side out again itself.
"""

from __future__ import annotations

import torch


def make_data(cfg: dict, seed: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n_supp, n_cust, n_ord = int(cfg["suppliers"]), int(cfg["customers"]), int(cfg["orders"])

    def draw(lo_hi, n):
        return torch.randint(lo_hi[0], lo_hi[1] + 1, (n,), generator=g, device=device)

    i = torch.arange(n_ord, device=device)
    o_orderkey = 32 * (i // 8) + i % 8 + 1
    del i
    active = torch.randint(0, n_cust - n_cust // 3, (n_ord,), generator=g, device=device)
    o_custkey = 3 * (active // 2) + active % 2 + 1
    del active
    o_orderdate = draw(cfg["orderdate_days"], n_ord).to(torch.int32)
    # lines per order: every count of 1..7 held by n_ord // 7 orders (the
    # rest hold 4), dealt to the orders by a seeded permutation
    lo, hi = cfg["lines_per_order"]
    per = n_ord // (hi - lo + 1)
    counts = torch.full((hi - lo + 1,), per, dtype=torch.int64, device=device)
    counts[(lo + hi) // 2 - lo] += n_ord - per * (hi - lo + 1)
    lines = torch.arange(lo, hi + 1, device=device).repeat_interleave(counts)
    lines = lines[torch.randperm(n_ord, generator=g, device=device)]
    n_li = int(cfg["lineitem_rows"])
    l_orderkey = o_orderkey.repeat_interleave(lines, output_size=n_li)
    del lines
    l_suppkey = draw((1, n_supp), n_li)
    ep = cfg["extendedprice"]
    l_extendedprice = draw(ep["quantity"], n_li)
    l_extendedprice *= draw(ep["retailprice_cents"], n_li)
    l_discount = draw(cfg["discount_cents"], n_li)
    return {
        "s_suppkey": torch.arange(1, n_supp + 1, device=device),
        "s_nationkey": draw((0, 24), n_supp),
        "c_custkey": torch.arange(1, n_cust + 1, device=device),
        "c_nationkey": draw((0, 24), n_cust),
        "o_orderkey": o_orderkey, "o_custkey": o_custkey, "o_orderdate": o_orderdate,
        "l_orderkey": l_orderkey, "l_suppkey": l_suppkey,
        "l_extendedprice": l_extendedprice, "l_discount": l_discount,
    }


def _row_of(keys: torch.Tensor) -> torch.Tensor:
    """key -> row of ``keys`` (distinct, >= 0, fewer than 2^31), -1
    where no row has it."""
    table = torch.full((int(keys.max()) + 1,), -1, dtype=torch.int32, device=keys.device)
    table[keys] = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    return table


def _lookup(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    ok = (keys >= 0) & (keys < table.shape[0])
    return torch.where(ok, table[keys.clamp(0, table.shape[0] - 1)].long(), -1)


class Reference:
    """Answers of the plain reference over ``data``, the lineitem batches
    being row ranges ``bounds[i] = (lo, hi)``."""

    def __init__(self, data: dict, cfg: dict, bounds):
        self.d, self.cfg, self.bounds = data, cfg, bounds
        dev = data["l_orderkey"].device
        self.names = [name for name, _ in cfg["nations"]]
        region = cfg["regions"].index(cfg["region"])
        self.in_region = torch.tensor([r == region for _, r in cfg["nations"]], device=dev)
        self.order_row = _row_of(data["o_orderkey"])
        self.cust_row = _row_of(data["c_custkey"])
        self.supp_row = _row_of(data["s_suppkey"])

    def batch_answer(self, i: int, revenue=None) -> list:
        """(n_name, revenue at scale 4) of the batch's rows that join an
        order of the year to a customer and a supplier of one nation of
        the region, by n_name. ``revenue`` replaces the exact decimal
        product and its sum by floating-point values (the control)."""
        d, cfg = self.d, self.cfg
        lo, hi = self.bounds[i]
        orow = _lookup(self.order_row, d["l_orderkey"][lo:hi])
        found = orow >= 0
        orow = orow.clamp(min=0)
        date = d["o_orderdate"][orow]
        crow = _lookup(self.cust_row, d["o_custkey"][orow])
        srow = _lookup(self.supp_row, d["l_suppkey"][lo:hi])
        found &= (crow >= 0) & (srow >= 0)
        c_nat = d["c_nationkey"][crow.clamp(min=0)]
        s_nat = d["s_nationkey"][srow.clamp(min=0)]
        keep = (found & (date >= cfg["orderdate_from_days"])
                & (date < cfg["orderdate_before_days"]) & (c_nat == s_nat)
                & self.in_region[c_nat])
        price, disc = d["l_extendedprice"][lo:hi][keep], d["l_discount"][lo:hi][keep]
        nat = c_nat[keep]
        hits = torch.bincount(nat, minlength=len(self.names)).tolist()
        if revenue is None:
            sums = torch.zeros(len(self.names), dtype=torch.int64, device=nat.device)
            sums.index_add_(0, nat, price * (100 - disc))
            sums = sums.tolist()
        else:
            sums = [round(float(revenue(price[nat == k], disc[nat == k]).sum()) * 10**4)
                    if hits[k] else 0 for k in range(len(self.names))]
        return sorted((self.names[k], int(sums[k])) for k in range(len(self.names)) if hits[k])

    def final_answer(self, batch_answers) -> list:
        """Q5's rows from batch answers: revenue by n_name, ORDER BY
        revenue DESC (ties by n_name, as the port's stable sort over its
        group-by's name order leaves them)."""
        total = {}
        for rows in batch_answers:
            for name, rev in rows:
                total[name] = total.get(name, 0) + rev
        return sorted(total.items(), key=lambda kv: (-kv[1], kv[0]))


def control_answer(ref: Reference, i: int, dtype) -> list:
    """The reference in the program's place, l_extendedprice * (1 -
    l_discount) and its sum in ``dtype`` (a floating-point type), the sum
    rounded to scale 4."""

    def revenue(price, disc):
        return price.to(dtype) / 100 * (1 - disc.to(dtype) / 100)

    return ref.batch_answer(i, revenue)
