"""TPC-H Q1 at SF10: the data made from the seed, the plain reference and
its lower-precision control. Plain PyTorch; imports nothing of the port.

The data follows dbgen's lineitem rules (``tpch_q1_sf10.json``, "dbgen"),
drawn on the device with one ``torch.Generator`` in a fixed order of
calls, so one seed gives one data set. Decimals are unscaled int64 at
scale 2, dates days since 1970-01-01, the flags one byte each.

The reference works each batch's answer out again from those columns in
exact int64 arithmetic (a 4 Mi-row batch sums below 5e17), and a final
answer from the batch answers with Python integers: the rows of Q1, its
avgs rounded HALF_UP as Spark's avg(DECIMAL(12,2)) -> DECIMAL(16,6).
"""

from __future__ import annotations

import torch

RF = {"A": 65, "N": 78, "R": 82}
LS = {"F": 70, "O": 79}


def make_data(cfg: dict, seed: int, device) -> dict:
    """The Q1 columns of ``cfg["lineitem_rows"]`` lineitem rows."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = int(cfg["lineitem_rows"])
    d = cfg["dbgen"]

    def draw(lo_hi):
        return torch.randint(lo_hi[0], lo_hi[1] + 1, (n,), generator=g, device=device)

    qty = draw(d["quantity"])
    price = qty * draw(d["retailprice_cents"])
    disc = draw(d["discount_cents"])
    tax = draw(d["tax_cents"])
    ship = draw(d["orderdate_days"]) + draw(d["ship_after_order_days"])
    receipt = ship + draw(d["receipt_after_ship_days"])
    cur = d["currentdate_days"]
    r_or_a = torch.where(torch.randint(0, 2, (n,), generator=g, device=device) == 1,
                         RF["R"], RF["A"])
    rf = torch.where(receipt <= cur, r_or_a, RF["N"]).to(torch.uint8)
    ls = torch.where(ship > cur, LS["O"], LS["F"]).to(torch.uint8)
    return {"l_returnflag": rf, "l_linestatus": ls, "l_quantity": qty * 100,
            "l_extendedprice": price, "l_discount": disc, "l_tax": tax,
            "l_shipdate": ship.to(torch.int32)}


def avg_half_up(total: int, count: int) -> int:
    """avg of a DECIMAL(12,2) sum over ``count`` rows as DECIMAL(16,6):
    total * 10^4 / count rounded HALF_UP (away from zero)."""
    q, r = divmod(abs(total) * 10**4, count)
    q += 2 * r >= count
    return -q if total < 0 else q


class Reference:
    """Answers of the plain reference over ``data``, the batches being
    row ranges ``bounds[i] = (lo, hi)``."""

    def __init__(self, data: dict, cfg: dict, bounds):
        self.data, self.cfg, self.bounds = data, cfg, bounds

    def batch_answer(self, i: int, products=None) -> list:
        """[rf, ls, sum_qty, sum_price, sum_disc_price, sum_charge,
        sum_disc, count] per group, in key order. ``products`` replaces
        the exact decimal products and their sums by floating-point values
        (the control)."""
        lo, hi = self.bounds[i]
        d = {k: v[lo:hi] for k, v in self.data.items()}
        keep = d["l_shipdate"] <= self.cfg["shipdate_cutoff_days"]
        price, disc, tax = d["l_extendedprice"], d["l_discount"], d["l_tax"]
        if products is None:
            disc_price = price * (100 - disc)  # scale 4
            charge = disc_price * (100 + tax)  # scale 6
            exact = True
        else:
            disc_price, charge = products(price, disc, tax)
            exact = False
        rows = []
        for rf_name in sorted(RF):
            for ls_name in sorted(LS):
                sel = keep & (d["l_returnflag"] == RF[rf_name]) & (d["l_linestatus"] == LS[ls_name])
                count = int(sel.sum())
                if count:
                    sums = [int(x[sel].sum()) for x in (d["l_quantity"], price)]
                    for x, scale in ((disc_price, 4), (charge, 6)):
                        sums.append(int(x[sel].sum()) if exact
                                    else round(float(x[sel].sum()) * 10**scale))
                    sums.append(int(disc[sel].sum()))
                    rows.append([rf_name, ls_name] + sums + [count])
        return rows

    def final_answer(self, batch_answers) -> list:
        """Q1's rows from batch answers: the sums merged, the avgs taken,
        ORDER BY returnflag, linestatus."""
        groups = {}
        for rows in batch_answers:
            for row in rows:
                acc = groups.setdefault((row[0], row[1]), [0] * 6)
                for j, v in enumerate(row[2:]):
                    acc[j] += v
        out = []
        for key in sorted(groups):
            s_qty, s_price, s_dp, s_ch, s_disc, cnt = groups[key]
            out.append([key[0], key[1], s_qty, s_price, s_dp, s_ch, avg_half_up(s_qty, cnt),
                        avg_half_up(s_price, cnt), avg_half_up(s_disc, cnt), cnt])
        return out


def control_answer(ref: Reference, i: int, dtype) -> list:
    """The reference in the program's place, Q1's decimal products and
    their sums in ``dtype`` (a floating-point type), the sums rounded to
    scales 4 and 6."""

    def products(price, disc, tax):
        dp = price.to(dtype) / 100 * (1 - disc.to(dtype) / 100)
        return dp, dp * (1 + tax.to(dtype) / 100)

    return ref.batch_answer(i, products)
