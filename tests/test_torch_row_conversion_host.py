"""The port's host JCUDF codec (``ops/row_conversion_host.py``, over
``native/jcudf_rows.cpp`` built by the port) held byte for byte
against the JAX package's host codec and against the port's own device
codec on the CPU (``convert_to_rows``/``convert_from_rows``): the six
cases of tests/test_jcudf_host.py."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops import row_conversion_host as jhost

from spark_rapids_jni_tpu_torch import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtypes as pd
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops import row_conversion_host as host

DTYPES = [pd.INT8, pd.INT16, pd.INT32, pd.INT64, pd.FLOAT64, pd.BOOL8, pd.DECIMAL128(38, 4)]


def mixed_columns(n, rng, with_nulls):
    """tests/test_jcudf_host.py's mixed table as numpy (datas, valids)."""
    datas = [
        rng.integers(-100, 100, n, endpoint=True).astype(np.int8),
        rng.integers(-(2**15), 2**15 - 1, n).astype(np.int16),
        rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
        rng.integers(-(2**62), 2**62, n).astype(np.int64),
        rng.normal(size=n),
        (rng.random(n) > 0.5).astype(np.int8),
        rng.integers(-(2**62), 2**62, (n, 2)).astype(np.int64),
    ]
    valids = [rng.random(n) > 0.2 if with_nulls and i < 6 else None for i in range(len(datas))]
    return datas, valids


def jax_dtypes(dtypes):
    return [jd.DType(d.kind, d.bits, d.precision, d.scale) for d in dtypes]


def port_table(datas, valids):
    return Table([
        Column(dt, torch.from_numpy(d), None if v is None else torch.from_numpy(v))
        for dt, d, v in zip(DTYPES, datas, valids)
    ])


def device_rows(tbl):
    [batch] = prc.convert_to_rows(tbl)
    row_size = prc.compute_row_layout(DTYPES).fixed_only_row_size
    return prc.row_batch_bytes(batch).reshape(tbl.num_rows, row_size)


@pytest.mark.parametrize("with_nulls", [False, True])
def test_host_encode_matches_jax_host_and_device(with_nulls):
    datas, valids = mixed_columns(257, np.random.default_rng(0), with_nulls)
    got = host.encode_rows(datas, DTYPES, valids)
    want = jhost.encode_rows(datas, jax_dtypes(DTYPES), valids)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, device_rows(port_table(datas, valids)))


@pytest.mark.parametrize("with_nulls", [False, True])
def test_host_round_trip(with_nulls):
    datas, valids = mixed_columns(100, np.random.default_rng(1), with_nulls)
    back, back_valid = host.decode_rows(host.encode_rows(datas, DTYPES, valids), DTYPES)
    jback, jvalid = jhost.decode_rows(jhost.encode_rows(datas, jax_dtypes(DTYPES), valids),
                                      jax_dtypes(DTYPES))
    for d, v, b, bv, jb, jv in zip(datas, valids, back, back_valid, jback, jvalid):
        assert b.dtype == d.dtype and np.array_equal(b, d) and np.array_equal(b, jb)
        assert np.array_equal(bv, np.ones(len(d), bool) if v is None else v)
        assert np.array_equal(bv, jv)


def test_host_decode_reads_device_rows():
    """Rows the device codec wrote decode on the host, and host rows
    decode through the device codec: the interop directions."""
    datas, valids = mixed_columns(64, np.random.default_rng(2), True)
    tbl = port_table(datas, valids)
    back, back_valid = host.decode_rows(device_rows(tbl), DTYPES)
    for c, b, bv in zip(tbl.columns, back, back_valid):
        assert np.array_equal(c.data.numpy(), b)
        assert np.array_equal(c.validity_or_true().numpy(), bv)
    rows = host.encode_rows(datas, DTYPES, valids)
    batch = Column(pd.BINARY, torch.from_numpy(rows.reshape(-1)), None,
                   torch.arange(0, rows.size + 1, rows.shape[1], dtype=torch.int32))
    dev = prc.convert_from_rows([batch], DTYPES)
    for c, d in zip(dev.columns, tbl.columns):
        assert torch.equal(c.data, d.data)
        assert torch.equal(c.validity_or_true(), d.validity_or_true())


def test_host_rejects_varlen():
    with pytest.raises(TypeError, match="fixed-width"):
        host.encode_rows([np.zeros(1, np.uint8)], [pd.STRING], None)
    with pytest.raises(TypeError, match="fixed-width"):
        host.decode_rows(np.zeros((1, 16), np.uint8), [pd.INT32, pd.STRING])


def test_empty_table():
    dtypes = [pd.INT32, pd.INT64]
    rows = host.encode_rows([np.zeros(0, np.int32), np.zeros(0, np.int64)], dtypes, None)
    assert rows.shape == (0, 24)
    datas, valids = host.decode_rows(rows, dtypes)
    assert [len(d) for d in datas] == [0, 0] and [len(v) for v in valids] == [0, 0]


def test_buffer_lengths_validated():
    """Short or wrong-dtype buffers are caught in Python, before the C
    code reads them (the ABI carries no lengths)."""
    with pytest.raises(ValueError, match="bytes"):
        host.encode_rows([np.zeros(10, np.int32)], [pd.INT64], None)
    with pytest.raises(ValueError, match="validity"):
        host.encode_rows([np.zeros(10, np.int64)], [pd.INT64], [np.ones(5, bool)])
    with pytest.raises(ValueError, match="row width"):
        host.decode_rows(np.zeros((2, 8), np.uint8), [pd.INT64])
    with pytest.raises(ValueError, match="multiple of row size"):
        host.decode_rows(np.zeros(20, np.uint8), [pd.INT64])
