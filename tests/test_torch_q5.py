"""TPC-H q5 through the port on the CPU at a small scale, held exactly
against the same chain written with the JAX package and against the
numpy oracle that gates the card run:

    select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
    from customer, orders, lineitem, supplier, nation, region
    where c_custkey = o_custkey and l_orderkey = o_orderkey
      and l_suppkey = s_suppkey and c_nationkey = s_nationkey
      and s_nationkey = n_nationkey and n_regionkey = r_regionkey
      and r_name = 'ASIA'
      and o_orderdate >= date '1994-01-01' and o_orderdate < date '1995-01-01'
    group by n_name order by revenue desc

The port's chain is ``chip_smoke``'s (``q5_build``, ``q5_batch``,
``q5_merge``) over ``chip_smoke.q5_data``'s draw: the chain the card
runs at SF10. Tolerance 0 throughout; validity is compared through
``validity_or_true()`` (a join output column without a mask equals one
with an all-true mask, ops/join.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.columnar import strings as jstrs
from spark_rapids_jni_tpu.ops.aggregate import Agg, group_by
from spark_rapids_jni_tpu.ops.decimal import multiply128
from spark_rapids_jni_tpu.ops.filter import filter_table
from spark_rapids_jni_tpu.ops.join import join
from spark_rapids_jni_tpu.ops.sort import SortKey, sort_table

from spark_rapids_jni_tpu_torch.columnar.interop import table_to_numpy

from torch_parity import assert_same_table, jax_table

SCALE = {"n_supp": 200, "n_cust": 600, "n_ord": 6000}  # every ASIA nation in the result
BATCH = 15_000  # two lineitem batches, the second shorter


@pytest.fixture(scope="module")
def data():
    return cs.q5_data(**SCALE)


def run_port(data, batch):
    t = cs.q5_tables(data, "cpu", batch)
    built = cs.q5_build(t)
    parts = [cs.q5_batch(li, built["build"], t["supplier"]) for li in t["lineitem"]]
    final = cs.q5_merge([p["partial"] for p in parts])
    return t, built, parts, final


@pytest.fixture(scope="module")
def port_run(data):
    return run_port(data, BATCH)


def to_jax(port_tbl):
    return jax_table(table_to_numpy(port_tbl))


def jax_string_equals(col, literal):
    chars, _ = jstrs.to_char_matrix(col)
    lit = list(literal.encode())
    want = jnp.full((chars.shape[1],), -1, chars.dtype)
    want = want.at[: len(lit)].set(jnp.asarray(lit, chars.dtype))
    return jnp.all(chars == want, axis=1) & col.validity_or_true()


def jax_concat(tables):
    cols = []
    for parts in zip(*(t.columns for t in tables)):
        offsets = None
        if parts[0].is_varlen:
            offs, base = [parts[0].offsets[:1]], 0
            for c in parts:
                offs.append(c.offsets[1:] + base)
                base += c.data.shape[0]
            offsets = jnp.concatenate(offs)
        cols.append(Column(parts[0].dtype, jnp.concatenate([c.data for c in parts]),
                           jnp.concatenate([c.validity_or_true() for c in parts]), offsets))
    return Table(cols)


def jax_q5(t):
    """The same chain with the JAX package's filter_table, join,
    multiply128, group_by and sort_table."""
    region = t["region"]
    asia = filter_table(region, jax_string_equals(region.columns[1], cs.Q5_REGION))
    nations = join(t["nation"], asia, [2], [0])
    cust = join(t["customer"], nations, [1], [0])
    cust = Table([cust.columns[0], cust.columns[1], cust.columns[3]])
    date = t["orders"].columns[2].data
    orders = filter_table(t["orders"], (date >= cs.Q5_DATE_LO) & (date < cs.Q5_DATE_HI))
    oc = join(orders, cust, [1], [0])
    build = Table([oc.columns[0], oc.columns[4], oc.columns[5]])
    built = {"asia": asia, "nations": nations, "customers": cust, "orders": orders,
             "build": build}

    def widen(data, precision):
        return Column(jd.DECIMAL128(precision, 2), jnp.stack([data, data >> 63], axis=-1))

    parts = []
    for li in t["lineitem"]:
        j1 = join(li, build, [0], [0])
        j2 = join(j1, t["supplier"], [1, 5], [0, 1])
        price, disc = j2.columns[2].data, j2.columns[3].data
        revenue = multiply128(widen(price, 12), widen(100 - disc, 13), 4)
        partial = group_by(Table([j2.columns[6], revenue.columns[1]]), [0], [Agg("sum", 1)])
        parts.append({"join_orders": j1, "join_supplier": j2, "revenue": revenue,
                      "partial": partial})
    merged = group_by(jax_concat([p["partial"] for p in parts]), [0], [Agg("sum", 1)])
    return built, parts, sort_table(merged, [SortKey(1, ascending=False)])


def test_scale_reaches_every_asia_nation(data, port_run):
    t, built, parts, final = port_run
    sizes = [li.num_rows for li in t["lineitem"]]
    assert len(sizes) == 2 and sizes[0] == BATCH and 0 < sizes[1] < BATCH
    assert all(p["join_supplier"].num_rows > 0 for p in parts)
    assert built["nations"].num_rows == 5
    assert len(cs.q5_rows(final)) == 5


def test_q5_matches_jax_chain(data):
    """Every intermediate table and the final rows equal the JAX
    package's chain over the same inputs. The lineitem goes in as one
    batch here: each eager JAX join of a new shape compiles for seconds
    (the merge of several batches is held against the oracle below)."""
    t, built, parts, final = run_port(data, len(data["l_orderkey"]))
    assert len(parts) == 1
    jt = {k: to_jax(v) for k, v in t.items() if k != "lineitem"}
    jt["lineitem"] = [to_jax(li) for li in t["lineitem"]]
    jbuilt, jparts, jfinal = jax_q5(jt)
    for name, tbl in built.items():
        assert_same_table(jbuilt[name], tbl, validity_or_true=True)
    for jp, p in zip(jparts, parts):
        for name, tbl in p.items():
            assert_same_table(jp[name], tbl, validity_or_true=True)
    assert_same_table(jfinal, final, validity_or_true=True)


def test_q5_matches_numpy_oracle(data, port_run):
    """Each batch's partial rows and the final ORDER BY rows equal the
    host oracle that gates the card run, and no product overflowed."""
    _t, _built, parts, final = port_run
    for i, p in enumerate(parts):
        assert not bool(p["revenue"].columns[0].data.any())
        want = sorted(cs.q5_oracle(data, i * BATCH, (i + 1) * BATCH).items())
        assert cs.q5_rows(p["partial"]) == want
    assert cs.q5_rows(final) == cs.q5_final_rows(cs.q5_oracle(data))


def test_q5_oracle_matches_python_rows(data):
    """The numpy oracle against a row-by-row Python evaluation of the
    query over the same draw (dict lookups, Python ints)."""
    d = data
    order_of = {int(k): i for i, k in enumerate(d["o_orderkey"])}
    region_of = dict(enumerate(r for _, r in cs.Q5_NATIONS))
    want = {}
    for k, s, price, disc in zip(d["l_orderkey"], d["l_suppkey"], d["l_extendedprice"],
                                 d["l_discount"]):
        o = order_of[int(k)]
        if not cs.Q5_DATE_LO <= d["o_orderdate"][o] < cs.Q5_DATE_HI:
            continue
        c_nat = int(d["c_nationkey"][d["o_custkey"][o] - 1])
        if c_nat != int(d["s_nationkey"][s - 1]) or region_of[c_nat] != 2:
            continue
        name = cs.Q5_NATIONS[c_nat][0]
        want[name] = want.get(name, 0) + int(price) * (100 - int(disc))
    assert cs.q5_oracle(d) == want
    assert set(want) == {"INDIA", "INDONESIA", "JAPAN", "CHINA", "VIETNAM"}


def test_q5_data_follows_dbgen_rules(data):
    d = data
    assert np.all(d["o_custkey"] % 3 != 0) and d["o_custkey"].max() <= SCALE["n_cust"]
    i = np.arange(SCALE["n_ord"])
    assert np.array_equal(d["o_orderkey"], 32 * (i // 8) + i % 8 + 1)
    lines = np.bincount(np.searchsorted(d["o_orderkey"], d["l_orderkey"]))
    assert lines.min() >= 1 and lines.max() <= 7
    assert d["o_orderdate"].min() >= 8035 and d["o_orderdate"].max() <= 10440
    assert d["l_discount"].min() >= 0 and d["l_discount"].max() <= 10
    assert d["l_extendedprice"].min() >= 90_000 and d["l_extendedprice"].max() <= 50 * 209_899
