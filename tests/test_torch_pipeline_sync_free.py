"""The fused chains dispatch with no host sync and no host-to-device copy
— the contract that lets a chunk's program run ahead of the host, and
that a CUDA graph capture requires (a stage that breaks it makes the
graph form raise PipelineError on the card).

On the CPU there is no device to sync with, so the test watches the
torch ops a chain dispatches (its second run: lookup tables upload once
on the first) and fails on any op that, on a CUDA tensor, reads a value
to the host or copies host data in: ``.item()`` / ``int()`` / ``bool()``
(``_local_scalar_dense``), ``nonzero``, boolean-mask indexing,
``masked_select``, ``unique``, ``repeat_interleave`` without an output
size, and tensors built from host data (``lift_fresh``: ``torch.tensor``,
a scalar stored into a tensor). The chains are chip_smoke.py's q1, q5
and store_sales chains and one chain over every other stage kind, and
the q1 and q5 chains sharded over 8 CPU shards (``stream(shard=...)``:
the exchange, the distributed group-by and joins inside the chain)."""

import collections
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import spark_rapids_jni_tpu_torch as port
from spark_rapids_jni_tpu_torch import FLOAT32, INT32, INT64, STRING
from spark_rapids_jni_tpu_torch.api import Aggregation, ParquetReader, Pipeline
from spark_rapids_jni_tpu_torch.runtime.scan import _pad_varlen_pow2

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

HOST_OPS = {
    "aten._local_scalar_dense.default", "aten.nonzero.default", "aten.masked_select.default",
    "aten.lift_fresh.default", "aten._unique2.default", "aten.unique_consecutive.default",
    "aten.unique_dim.default",
}


class HostTraffic(TorchDispatchMode):
    """Counts the dispatched ops that would sync or copy from the host on
    a CUDA tensor."""

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bad = name in HOST_OPS
        if name == "aten.index.Tensor":
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                      for i in (args[1] or []))
        if name == "aten.repeat_interleave.Tensor":
            bad = (kwargs or {}).get("output_size") is None
        if bad:
            self.hits[name] += 1
        return func(*args, **(kwargs or {}))


def dispatch_traffic(pipe, table):
    """Host traffic of the second dispatch of one chunk."""
    plan = pipe._initial_plan(table.num_rows)
    dispatch, sync, _ = pipe._dispatch_fns(table, False)
    sync(dispatch(plan))
    watch = HostTraffic()
    dispatch, sync, _ = pipe._dispatch_fns(table, False)
    with watch:
        value = dispatch(plan)
    assert not any(sync(value).values())
    return dict(watch.hits)


def sharded_dispatch_traffic(pipe, table, mesh):
    """Host traffic of the second dispatch of one chunk through the
    chain sharded over ``mesh``, at the stream's plan."""
    spec = pipe._resolve_shard(mesh)
    plan = pipe._initial_plan(table.num_rows, None, shard_n=spec.n_dev,
                              bcast=pipe._bcast_choices(spec))
    dispatch, sync, _ = pipe._dispatch_fns(table, False, shard=spec)
    sync(dispatch(plan))
    watch = HostTraffic()
    dispatch, sync, _ = pipe._dispatch_fns(table, False, shard=spec)
    with watch:
        value = dispatch(plan)
    assert not any(sync(value).values())
    return dict(watch.hits)


def test_q1_chain_is_sync_free():
    a = chip_smoke.q1_batch_arrays(np.random.default_rng(42), 4096)
    assert dispatch_traffic(chip_smoke.q1_pipeline("sf_q1"), chip_smoke.q1_table(a, "cpu")) == {}


def test_q5_chain_is_sync_free():
    d = chip_smoke.q5_data(n_supp=200, n_cust=3000, n_ord=20000)
    t = chip_smoke.q5_tables(d, "cpu", batch=1 << 14)
    built = chip_smoke.q5_build(t)
    pipe = (Pipeline("sf_q5")
            .join(built["build"], [0], [0], "inner", right_string_widths={2: 16})
            .join(t["supplier"], [1, 5], [0, 1], "inner", left_string_widths={6: 16})
            .map(chip_smoke.q5_revenue, name="q5_revenue")
            .group_by([6], [Aggregation.Agg("sum", 9)], capacity=32, string_widths={6: 16}))
    assert dispatch_traffic(pipe, t["lineitem"][0]) == {}


def test_store_sales_chain_is_sync_free(tmp_path):
    path = str(tmp_path / "ss.parquet")
    chip_smoke.write_store_sales(path, 5000, 4096)
    with ParquetReader(path, device="cpu") as r:
        chunk = _pad_varlen_pow2(r.read_row_group(0), None)
    assert dispatch_traffic(chip_smoke.ss_pipeline("sf_ss"), chunk) == {}


def _every_stage():
    rng = np.random.default_rng(1)
    n = 200
    docs = [f'{{"v": "{x / 4}", "c": "{"web" if x % 3 else "app"}"}}' for x in range(n)]
    t = port.Table([
        port.Column.from_numpy(rng.integers(0, 5, n).astype(np.int32), INT32, device="cpu"),
        port.Column.from_pylist(docs, STRING, device="cpu"),
        port.Column.from_pylist([f"id={i};host=h{i % 7}.x" for i in range(n)], STRING,
                                device="cpu"),
        port.Column.from_pylist([str(i) for i in range(n)], STRING, device="cpu"),
        port.Column.from_pylist([i * 7 for i in range(n)], port.DECIMAL128(18, 2), device="cpu"),
    ])
    right = port.Table([port.Column.from_pylist([0, 1, 2, 3], INT32, device="cpu"),
                        port.Column.from_pylist([10, 20, 30, 40], INT64, device="cpu")])
    pipe = (Pipeline("sf_all")
            .get_json_object(1, "$.c", width=64, out="append")
            .get_json_object(1, "$.v", width=64)
            .cast_to_float(1, FLOAT32, width=64)
            .rlike(2, r"h[0-3]", width=32, out="append")
            .regexp_extract(2, r"id=(\d+)", 1, width=32)
            .cast_to_integer(2, INT64, width=32)
            .cast_to_decimal(3, 12, 2, width=8)
            .multiply128(4, 4, 4)
            .filter(lambda tb: tb.columns[0].data >= 1)
            .join(right, [0], [0], "left", capacity=256, left_string_widths={5: 16})
            .select([0, 1, 2, 4, 5, 6, 8, 10])
            .group_by([0, 4], [Aggregation.Agg("sum", 1), Aggregation.Agg("max", 2),
                               Aggregation.Agg("min", 4), Aggregation.Agg("count", 6),
                               Aggregation.Agg("sum", 7)],
                      capacity=16, string_widths={4: 16}))
    return pipe, t


def test_every_stage_kind_is_sync_free():
    pipe, t = _every_stage()
    assert dispatch_traffic(pipe, t) == {}


def test_detector_sees_a_syncing_map_stage():
    t = port.Table([port.Column.from_pylist([1, 2, 3], INT32, device="cpu")])
    pipe = Pipeline("sf_bad").map(lambda tb: tb if int(tb.columns[0].data.max()) > 0 else tb)
    assert dispatch_traffic(pipe, t) == {"aten._local_scalar_dense.default": 1}


def test_sharded_chains_are_sync_free():
    from spark_rapids_jni_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(["cpu"] * 8)
    a = chip_smoke.q1_batch_arrays(np.random.default_rng(42), 4099)  # pads to 8 shards
    assert sharded_dispatch_traffic(chip_smoke.q1_pipeline("sf_q1_sharded"),
                                    chip_smoke.q1_table(a, "cpu"), mesh) == {}
    d = chip_smoke.q5_data(n_supp=200, n_cust=3000, n_ord=20000)
    t = chip_smoke.q5_tables(d, "cpu", batch=1 << 13)
    built = chip_smoke.q5_build(t)
    pipe = (Pipeline("sf_q5_sharded")
            .join(built["build"], [0], [0], "inner", right_string_widths={2: 16},
                  broadcast=False)
            .join(t["supplier"], [1, 5], [0, 1], "inner", left_string_widths={6: 16})
            .map(chip_smoke.q5_revenue, name="q5_revenue")
            .group_by([6], [Aggregation.Agg("sum", 9)], capacity=32, string_widths={6: 16}))
    assert sharded_dispatch_traffic(pipe, t["lineitem"][0], mesh) == {}
