"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
carry tables between the JAX package and the port through the numpy
interop form, compare tables and row batches exactly, run both row
round trips. Not a test module."""

import jax.numpy as jnp
import numpy as np

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu import Table as JTable
from spark_rapids_jni_tpu.columnar.dtypes import DType as JDType
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.columnar import dtypes as pd
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc


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
