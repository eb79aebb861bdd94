"""Port's JCUDF row conversion vs the JAX package on tables with string
columns: (offset, length) pairs, payload placement, nulls, empty strings
and multi-batch splits, byte for byte. One table shape serves the whole
file, because the JAX package compiles its variable-width programs per
shape."""

import numpy as np

from spark_rapids_jni_tpu import Column, Table
from spark_rapids_jni_tpu.columnar import dtypes as jd
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc

from torch_parity import (
    assert_same_batches,
    assert_same_table,
    port_dtype,
    round_trip_both,
    to_port,
)

N = 96


def strings_table(n=N, seed=11):
    """bench.py's strings table widened with nulls, empty strings,
    multi-byte UTF-8, a string past the first length bucket and a
    column holding only empty strings and nulls."""
    rng = np.random.default_rng(seed)
    pool = ["", "A", "N", "R", "AIR", "TRUCK", "REG AIR", "héllo wörld",
            "a much longer string value, past a bucket", "日本"]

    def strs(p_null, choices=pool):
        return [
            None if rng.random() < p_null else choices[i]
            for i in rng.integers(0, len(choices), n)
        ]

    return Table(
        [
            Column.from_numpy(rng.integers(1, 6_000_000, n, np.int64), jd.INT64),
            Column.from_pylist(strs(0.2), jd.STRING),
            Column.from_numpy(rng.integers(1, 50, n, np.int32), jd.INT32,
                              rng.random(n) > 0.3),
            Column.from_pylist(strs(0.0), jd.STRING),
            Column.from_numpy(rng.integers(0, 2, n, np.int8), jd.BOOL8),
            Column.from_pylist(strs(0.5, [""]), jd.STRING),
        ]
    )


def test_strings_with_nulls_and_empties():
    tbl, pback = round_trip_both(strings_table())
    assert pback.to_pylists() == tbl.to_pylists()


def test_from_rows_reads_jax_rows():
    """Rows the JAX package wrote decode in the port."""
    tbl = strings_table()
    schema = [c.dtype for c in tbl.columns]
    jrows = jrc.convert_to_rows(tbl)
    carried = interop.table_from_numpy(
        [{"dtype": ("binary", 0, None, None),
          "data": jrc.row_batch_bytes(b),
          "validity": None,
          "offsets": np.asarray(b.offsets)} for b in jrows],
        device="cpu",
    )
    pback = prc.convert_from_rows(carried.columns, [port_dtype(d) for d in schema])
    assert_same_table(jrc.convert_from_rows(jrows, schema), pback)


def test_multi_batch_strings():
    tbl = strings_table()
    schema = [c.dtype for c in tbl.columns]
    single = jrc.convert_to_rows(tbl)
    total = int(np.asarray(single[0].offsets)[-1])
    cap = total * 2 // 3
    # two batches, the first cut back to a 32-row multiple
    jrows = jrc.convert_to_rows(tbl, cap)
    prows = prc.convert_to_rows(to_port(tbl), cap)
    assert len(prows) == 2 and len(prows[0]) % 32 == 0
    assert_same_batches(jrows, prows)
    # the batches decode to what the single batch decodes to
    pback = prc.convert_from_rows(prows, [port_dtype(d) for d in schema])
    assert_same_table(jrc.convert_from_rows(single, schema), pback)
