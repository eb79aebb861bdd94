"""TPC-H q1 through the port at n = 5000 on the CPU, held exactly
against the JAX package's chain and against exact Python decimals:

    select l_returnflag, l_linestatus,
           sum(l_quantity), sum(l_extendedprice),
           sum(l_extendedprice * (1 - l_discount)),
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
           avg(l_quantity), avg(l_extendedprice), avg(l_discount),
           count(*)
    from lineitem where l_shipdate <= date '1998-09-02'
    group by l_returnflag, l_linestatus
    order by l_returnflag, l_linestatus

The port's chain is ``chip_smoke.q1_run``, the one the card runs at
SF10, over ``chip_smoke.q1_batch_arrays``' draw; the host oracle that
gates the card run is checked here against the decimal oracle too."""

import decimal

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops.aggregate import Agg, group_by
from spark_rapids_jni_tpu.ops.decimal import multiply128
from spark_rapids_jni_tpu.ops.filter import filter_table
from spark_rapids_jni_tpu.ops.sort import SortKey, sort_table

from spark_rapids_jni_tpu_torch import BOOL8
from spark_rapids_jni_tpu_torch import Column as PColumn
from spark_rapids_jni_tpu_torch.columnar.interop import table_from_numpy

from torch_parity import assert_same_table

D = decimal.Decimal
N = 5000


@pytest.fixture(scope="module")
def batch():
    return cs.q1_batch_arrays(np.random.default_rng(42), N)


def jax_q1(arrays):
    """tests/test_tpch_q1.py's chain with benchmarks/sf10_q1.py's static
    types, on the JAX package."""
    n = len(arrays["qty"])
    offs = jnp.arange(n + 1, dtype=jnp.int32)
    dec = jd.DECIMAL64(12, 2)
    tbl = Table([
        Column(jd.STRING, jnp.asarray(arrays["rf"]), None, offs),
        Column(jd.STRING, jnp.asarray(arrays["ls"]), None, offs),
        *(Column(dec, jnp.asarray(arrays[k])) for k in ("qty", "price", "disc", "tax")),
        Column(jd.DATE32, jnp.asarray(arrays["ship"])),
    ])
    f = filter_table(tbl, tbl.columns[6].data <= cs.Q1_CUTOFF)

    def widen(data, precision):
        return Column(jd.DECIMAL128(precision, 2), jnp.stack([data, data >> jnp.int64(63)], axis=-1))

    qty, price, disc, tax = f.columns[2:6]
    dp = multiply128(widen(price.data, 12), widen(100 - disc.data, 13), 4).columns[1]
    ch = multiply128(dp, widen(100 + tax.data, 13), 6).columns[1]
    work = Table([f.columns[0], f.columns[1], qty, price, dp, ch, disc])
    out = group_by(work, [0, 1], [
        Agg("sum", 2), Agg("sum", 3), Agg("sum", 4), Agg("sum", 5),
        Agg("mean", 2), Agg("mean", 3), Agg("mean", 6), Agg("count"),
    ])
    return sort_table(out, [SortKey(0), SortKey(1)])


def decimal_oracle(arrays):
    """Exact Python decimals, row by row (tests/test_tpch_q1.py:134-179)."""
    groups = {}
    for i in range(len(arrays["qty"])):
        if arrays["ship"][i] > cs.Q1_CUTOFF:
            continue
        k = (chr(arrays["rf"][i]), chr(arrays["ls"][i]))
        g = groups.setdefault(k, [D(0), D(0), D(0), D(0), 0, D(0)])
        q, p, d, t = (D(int(arrays[c][i])) / 100 for c in ("qty", "price", "disc", "tax"))
        g[0] += q
        g[1] += p
        g[2] += p * (1 - d)
        g[3] += p * (1 - d) * (1 + t)
        g[4] += 1
        g[5] += d
    half_up = decimal.Context(prec=60, rounding=decimal.ROUND_HALF_UP)

    def avg(total, n):  # Spark avg(DECIMAL(12,2)) -> DECIMAL(16,6), HALF_UP
        return int((D(int(total * 100)) * 10**4 / D(n)).quantize(
            D(1), rounding=decimal.ROUND_HALF_UP, context=half_up))

    rows = []
    for k in sorted(groups):
        g = groups[k]
        rows.append([k[0], k[1], int(g[0] * 100), int(g[1] * 100), int(g[2] * 10**4),
                     int(g[3] * 10**6), avg(g[0], g[4]), avg(g[1], g[4]), avg(g[5], g[4]), g[4]])
    return rows


def test_q1_matches_jax_chain_and_decimal_oracle(batch):
    out, overflow = cs.q1_run(cs.q1_table(batch, "cpu"))
    assert not bool(overflow)
    assert_same_table(jax_q1(batch), out)
    want = decimal_oracle(batch)
    assert len(want) == 6
    assert cs.q1_rows(out) == want


def test_host_oracle_matches_decimal_oracle(batch):
    """The gate of the card's SF10 run (numpy int64 sums, integer
    HALF_UP) agrees with exact decimals."""
    assert cs.q1_expected_rows(cs.q1_oracle(batch)) == decimal_oracle(batch)
    assert cs.avg_half_up(-5, 2) == -25000 and cs.avg_half_up(1, 3) == 3333
    assert cs.avg_half_up(1, 8) == 1250 and cs.avg_half_up(1, 80000) == 0
    assert cs.avg_half_up(1, 20000) == 1  # the half rounds away from zero


def test_sf10_batches_cover_lineitem():
    """The card's SF10 run is 14 batches of 4 Mi rows and the rest."""
    full, rest = divmod(cs.SF10_LINEITEM_ROWS, cs.Q1_BATCH)
    assert (full, cs.Q1_BATCH) == (14, 4_194_304) and rest == 1_265_796


def test_mixed_batch_feeds_every_regime():
    """The card-against-CPU batch reaches each decimal regime's overflow
    rows and every operator runs on it; the float comparison treats NaN
    as NaN and keeps -0.0 apart from 0.0."""
    n = 512
    t = table_from_numpy(cs.mixed_spec(n), device="cpu")
    rng = np.random.default_rng(4)
    pred = PColumn.from_numpy((rng.random(n) < 0.4).astype(np.int8), BOOL8,
                              rng.random(n) > 0.2, device="cpu")
    res = cs.mixed_ops(t, pred)
    for name in ("multiply128 noshift", "multiply128 scales_any", "add128", "divide128"):
        assert int(res[name].columns[0].data.sum()) > 0, name
    assert int(res["multiply128 i128"].columns[0].data.sum()) == 0
    assert res["sort_order"].num_rows == n and res["group_by float"].num_rows == 6
    nan = np.array([np.nan, 0.0, 1.0])
    assert cs.same_array(nan, nan.copy())
    assert not cs.same_array(nan, np.array([np.nan, -0.0, 1.0]))
    assert not cs.same_array(np.zeros(2, np.int64), np.zeros(2, np.int32))


def test_q1_op_counts(batch):
    """The per-stage op counts the card run prints: every stage counted,
    and the group-by dominated by its three decimal avgs' divisions."""
    counts = cs.q1_op_counts(cs.q1_table(batch, "cpu"))
    assert set(counts) == {"filter", "decimal", "group_by", "sort", "one avg division"}
    assert min(counts.values()) > 0
    assert counts["group_by"] > 3 * counts["one avg division"] > 0.8 * counts["group_by"]
