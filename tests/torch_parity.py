"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
carry tables between the JAX package and the port through the numpy
interop form, compare tables and row batches exactly, run both row
round trips. Not a test module."""

import jax.numpy as jnp
import numpy as np
import torch

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.columnar.dtypes import DType as JDType
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.columnar import dtypes as pd
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc

# One intra-op thread per test process. The suite runs as several pytest
# workers on one machine; torch's default of a thread per core in every
# worker oversubscribes the cores (its idle threads spin), which slows
# every worker, the JAX package's compiles included. The port's tensors
# here are small, and a single thread also fixes the order of torch's CPU
# reductions. Every worker imports this module while it collects.
torch.set_num_threads(1)


def numpy_form(tbl):
    """The interop dict form of a JAX-package Table (numpy only)."""
    out = []
    for c in tbl.columns:
        dt = c.dtype
        out.append(
            {
                "dtype": (dt.kind, dt.bits, dt.precision, dt.scale),
                "data": np.asarray(c.data),
                "validity": None if c.validity is None else np.asarray(c.validity),
                "offsets": None if c.offsets is None else np.asarray(c.offsets),
            }
        )
    return out


def to_port(tbl):
    """The same table as a port Table on the CPU."""
    return interop.table_from_numpy(numpy_form(tbl), device="cpu")


def jax_table(spec):
    """A JAX-package Table from the interop numpy form."""
    cols = []
    for c in spec:
        opt = [None if c[k] is None else jnp.asarray(c[k]) for k in ("validity", "offsets")]
        cols.append(JColumn(JDType(*c["dtype"]), jnp.asarray(c["data"]), *opt))
    return JTable(cols)


def _rows(col):
    return len(col["offsets"]) - 1 if col["offsets"] is not None else len(col["data"])


def assert_same_table(jax_tbl, port_tbl, validity_or_true=False):
    """Exact equality of data, validity and offsets, column by column.
    ``validity_or_true=True`` compares validity as
    ``Column.validity_or_true()`` does: no mask equals an all-true one."""
    want = numpy_form(jax_tbl)
    got = interop.table_to_numpy(port_tbl)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w["dtype"] == g["dtype"], i
        if validity_or_true:
            for c in (w, g):
                if c["validity"] is None:
                    c["validity"] = np.ones(_rows(c), bool)
        for key in ("data", "validity", "offsets"):
            if w[key] is None or g[key] is None:
                assert w[key] is None and g[key] is None, (i, key)
                continue
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"col {i} {key}")


def hash_u32(h):
    """uint32 numpy view of a hash (JAX: uint32 array, port: int32
    tensor holding the uint32 bits)."""
    if hasattr(h, "numpy"):
        h = h.numpy()
    return np.asarray(h).astype(np.int64).astype(np.uint32)


def port_dtype(dt):
    return pd.DType(dt.kind, dt.bits, dt.precision, dt.scale)


def assert_same_batches(jax_batches, port_batches):
    assert len(port_batches) == len(jax_batches)
    for jb, pb in zip(jax_batches, port_batches):
        np.testing.assert_array_equal(prc.row_batch_bytes(pb), jrc.row_batch_bytes(jb))
        np.testing.assert_array_equal(pb.offsets.numpy(), np.asarray(jb.offsets))
        assert pb.data.dtype.itemsize == 1


def round_trip_both(tbl, max_batch_bytes=jrc.DEFAULT_MAX_BATCH_BYTES):
    schema = [c.dtype for c in tbl.columns]
    jrows = jrc.convert_to_rows(tbl, max_batch_bytes)
    prows = prc.convert_to_rows(to_port(tbl), max_batch_bytes)
    assert_same_batches(jrows, prows)
    jback = jrc.convert_from_rows(jrows, schema)
    pback = prc.convert_from_rows(prows, [port_dtype(d) for d in schema])
    assert_same_table(jback, pback)
    return tbl, pback


# -- row-sharded tables: the JAX package's per-device blocks and the
# port's ShardedTable (one Table per shard), compared shard by shard


def _row_blocks(a, P):
    """P row blocks of a JAX array: its per-device blocks
    (``addressable_shards``) when it is row-sharded over P devices,
    else P contiguous slices of the host copy."""
    shards = getattr(a, "addressable_shards", None)
    if shards is not None and len(shards) == P and all(
            s.index and isinstance(s.index[0], slice) and s.index[0] != slice(None)
            for s in shards):
        return [np.asarray(d) for _, d in sorted(
            ((s.index[0].start or 0), s.data) for s in shards)]
    arr = np.asarray(a)
    m = arr.shape[0] // P
    return [arr[s * m:(s + 1) * m] for s in range(P)]


def shard_forms(tbl, P):
    """A JAX Table (row-sharded or global) as P interop forms, one per
    shard: fixed planes and masks by row block, varlen columns cut at
    the blocks' offsets (rebased to 0, payload cut to the used bytes)."""
    out = [[] for _ in range(P)]
    for c in tbl.columns:
        dt = c.dtype
        valid = None if c.validity is None else _row_blocks(c.validity, P)
        if c.offsets is None:
            data = _row_blocks(c.data, P)
            offs = [None] * P
        else:
            o = np.asarray(c.offsets).astype(np.int64)
            payload = np.asarray(c.data)
            m = (len(o) - 1) // P
            data, offs = [], []
            for s in range(P):
                part = o[s * m:(s + 1) * m + 1]
                data.append(payload[part[0]:part[-1]])
                offs.append((part - part[0]).astype(np.int32))
        for s in range(P):
            out[s].append({"dtype": (dt.kind, dt.bits, dt.precision, dt.scale),
                           "data": data[s], "validity": None if valid is None else valid[s],
                           "offsets": offs[s]})
    return out


def to_port_shards(tbl, mesh):
    """A JAX row-sharded table in the port's form: a ShardedTable whose
    shard i is the JAX package's block i, on ``mesh.devices[i]``."""
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardedTable

    forms = shard_forms(tbl, mesh.size)
    return ShardedTable([interop.table_from_numpy(f, device=str(d))
                         for f, d in zip(forms, mesh.devices)], mesh)


def from_port_shards(sharded):
    """The port's ShardedTable back as one JAX Table, shard blocks in
    order (each varlen payload cut to its used bytes)."""
    forms = [interop.table_to_numpy(s) for s in sharded.shards]
    cols = []
    for parts in zip(*forms):
        c0 = parts[0]
        if c0["offsets"] is None:
            data, offs = np.concatenate([p["data"] for p in parts]), None
        else:
            datas, offs, base = [], [np.zeros(1, np.int64)], 0
            for p in parts:
                o = np.asarray(p["offsets"]).astype(np.int64)
                datas.append(np.asarray(p["data"])[o[0]:o[-1]])
                offs.append(o[1:] - o[0] + base)
                base += int(o[-1] - o[0])
            data, offs = np.concatenate(datas), np.concatenate(offs).astype(np.int32)
        valid = None
        if any(p["validity"] is not None for p in parts):
            valid = np.concatenate([np.ones(len(p["offsets"]) - 1 if p["offsets"] is not None
                                            else len(p["data"]), bool)
                                    if p["validity"] is None else p["validity"] for p in parts])
        cols.append({"dtype": c0["dtype"], "data": data, "validity": valid, "offsets": offs})
    return jax_table(cols)


def assert_same_shards(jax_tbl, jax_occ, port_sharded, port_occ):
    """Shard by shard: the occupancy masks, every fixed plane (dead slots
    included), the validity masks, and each varlen column's offsets and
    used payload bytes, all exactly equal."""
    P = port_sharded.mesh.size
    want = shard_forms(jax_tbl, P)
    occ_w = _row_blocks(jax_occ, P)
    for s in range(P):
        np.testing.assert_array_equal(port_occ[s].cpu().numpy(), occ_w[s], err_msg=f"shard {s} occ")
        got = interop.table_to_numpy(port_sharded.shards[s])
        assert len(got) == len(want[s])
        for i, (g, w) in enumerate(zip(got, want[s])):
            assert g["dtype"] == w["dtype"], (s, i)
            assert (g["validity"] is None) == (w["validity"] is None), (s, i, "validity")
            if w["validity"] is not None:
                np.testing.assert_array_equal(g["validity"], w["validity"],
                                              err_msg=f"shard {s} col {i} validity")
            if w["offsets"] is None:
                np.testing.assert_array_equal(g["data"], w["data"], err_msg=f"shard {s} col {i}")
            else:
                o = np.asarray(g["offsets"]).astype(np.int64)
                np.testing.assert_array_equal(o - o[0], w["offsets"],
                                              err_msg=f"shard {s} col {i} offsets")
                np.testing.assert_array_equal(np.asarray(g["data"])[o[0]:o[-1]], w["data"],
                                              err_msg=f"shard {s} col {i} payload")


def host_counts(ovf):
    """An overflow count (scalar or per-stage dict, JAX or port) as ints."""
    if isinstance(ovf, dict):
        return {k: int(v) for k, v in ovf.items()}
    return int(ovf)


def comparable_form(form):
    """Numpy interop form with the parts neither package specifies
    cleared: a missing mask as all-true, fixed-width data under a null
    as 0, a varlen payload cut at its last offset."""
    out = []
    for c in form:
        n = len(c["offsets"]) - 1 if c["offsets"] is not None else len(c["data"])
        valid = np.ones(n, bool) if c["validity"] is None else np.asarray(c["validity"])
        data = np.array(c["data"])
        if c["offsets"] is None:
            data[~valid] = 0
        else:
            data = data[: int(c["offsets"][-1])]
        out.append((c["dtype"], data.tolist(), valid.tolist(),
                    None if c["offsets"] is None else np.asarray(c["offsets"]).tolist()))
    return out


def assert_same_result(jax_tbl, port_tbl):
    """A collected Pipeline result of the JAX package equals the port's
    exactly, up to the parts ``comparable_form`` clears."""
    assert comparable_form(interop.table_to_numpy(port_tbl)) == \
        comparable_form(numpy_form(jax_tbl))
