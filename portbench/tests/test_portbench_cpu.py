"""The cells at small sizes on the CPU: the port's answers against the
plain reference through a whole run, the control and the planted faults
failing the same comparison, and the control at a cell's own size on the
card."""

import pytest
import torch
from harness import Cell, forbidden_modules, load_spec, run_cell

from spark_rapids_jni_tpu_torch import Column, Table

SMALL = {
    "q1_sf10.pipeline": {"config": {"lineitem_rows": 20_000}, "traffic": {"batch_rows": 4096}},
    "q5_sf100.pipeline": {"config": {"suppliers": 1000, "customers": 15_000, "orders": 30_000,
                                     "lineitem_rows": 120_000},
                          "traffic": {"batch_rows": 16_384}},
}
CELLS = sorted(SMALL)
SEED = 2**31 + 77  # more than 32 signed bits hold
# the control's type per configuration: the nearest floating-point type
# that changes an answer at the cell's size (PERF.md, Findings, PR 19)
CONTROL = {"q1_sf10.pipeline": "float64", "q5_sf100.pipeline": "float32"}


def run(cell, trace=False, wrap=None, seconds=1.5):
    return run_cell(cell, SEED, seconds, trace, device="cpu", overrides=SMALL[cell],
                    wrap_entry=wrap)


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct(cell):
    result, log = run(cell)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"rows_per_s", "batch_p95_ms", "setup_s"}
    assert result["attempted"] >= len(log.batches) - 2 and result["failed"] == 0
    assert all(f["error"] is None for f in log.finals)
    assert list(result)[-1] == "checks"
    assert forbidden_modules() == []


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    result, _ = run(cell, trace=True)
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert m["pipeline.plan_cache_miss"]["value"] == 0
    assert m["torch_ops_per_batch"]["value"] > 0
    # no device on the CPU: nothing device-sourced is read
    assert "decimal128_roofline" not in m and "device_idle_share" not in m
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["q1_sf10.pipeline"])
def test_eager_entry_agrees(cell):
    c = Cell(load_spec(), cell, SMALL[cell])
    dev = torch.device("cpu")
    data = c.ref.make_data(c.cfg, SEED, dev)
    q = c.port.prepare(data, c.cfg, c.traffic, dev)
    ref = c.ref.Reference(data, c.cfg, q.batches)
    want = [ref.batch_answer(i) for i in range(len(q.batches))]
    for entry in ("pipeline", "eager"):
        parts = [q.entries[entry](i) for i in range(len(q.batches))]
        assert [q.answer(p) for p in parts] == want
        assert q.merge(parts) == ref.final_answer(want)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """float32 changes every answer at any size; float64 changes q1's
    only at its own size (``test_control_fails_at_cell_size``)."""
    from control import control

    (got,) = control(cell, SEED, ["float32"], "cpu", SMALL[cell])
    assert got["wrong_batches"] == got["batches"] and got["wrong_final"] == 1


def stale(entry, query):
    """A step that returns its state unchanged: every call after the
    first gives the first call's result."""
    first = []

    def f(i):
        if not first:
            first.append(entry(i))
        return first[0]

    return f


def halved(entry, query):
    """Half of the batch left out: the entry sees the first half of its
    rows."""

    def f(i):
        t = query.tables[i]
        n = t.num_rows // 2
        query.tables[i] = Table([
            Column(c.dtype, c.data[:n], None if c.validity is None else c.validity[:n],
                   None if c.offsets is None else c.offsets[:n + 1]) for c in t.columns])
        try:
            return entry(i)
        finally:
            query.tables[i] = t

    return f


def altered(entry, query):
    """An answer altered where it is produced: the last column of the
    result, plus one in its lowest word."""

    def f(i):
        out = entry(i)
        last = out.columns[-1]
        data = last.data.clone()
        data.view(-1)[0] += 1
        return Table(out.columns[:-1] + [Column(last.dtype, data, last.validity, last.offsets)])

    return f


def altered_build(entry, query):
    """A build side altered where it is produced: every pass's
    c_nationkey plus one."""
    begin = query.begin_pass

    def begin_pass():
        begin()
        query.build.columns[1].data.add_(1)

    query.begin_pass = begin_pass
    return entry


def test_build_side_each_pass():
    """q5 makes its build side at the start of every pass of the window,
    before the pass's batches, and a wrong one is caught."""
    result, log = run("q5_sf100.pipeline")
    assert result["correct"], result["checks"]
    firsts = {st["pass"]: st["end"] for st in log.stages}
    assert set(firsts) == {b["pass"] for b in log.batches}
    assert all(firsts[b["pass"]] <= b["start"] for b in log.batches)
    result, _ = run("q5_sf100.pipeline", wrap=altered_build)
    assert not result["correct"]
    assert result["checks"]["wrong_batches"]["value"] > 0


@pytest.mark.parametrize("fault", [stale, halved, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    result, _ = run(cell, wrap=fault)
    assert not result["correct"]
    assert result["checks"]["wrong_batches"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell, card):
    from control import control

    for seed in (SEED, SEED + 1, SEED + 2):
        (got,) = control(cell, seed, [CONTROL[cell]], "cuda")
        assert got["wrong_batches"] > 0 or got["wrong_final"] == 1, got
