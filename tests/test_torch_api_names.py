"""The port's ``api`` module names what the JAX package's ``api`` names:
the same public names (the port adds only ``ListColumn``), each
re-exported class the port's own, and the façade raising the class it
re-exports."""

import types

import pytest

import spark_rapids_jni_tpu.api as japi

import spark_rapids_jni_tpu_torch.api as papi
from spark_rapids_jni_tpu_torch import STRING, Column
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType
from spark_rapids_jni_tpu_torch.ops import parquet_footer as pfooter
from spark_rapids_jni_tpu_torch.runtime import errors as perrors

PORT_ONLY = {"ListColumn"}
REEXPORTS = {
    pfooter: ("ListElement", "MapElement", "StructElement", "ValueElement"),
    perrors: ("CapacityExceededError", "CastException", "JsonParsingException"),
}


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_public_names_match_the_jax_api():
    assert _public(papi) - PORT_ONLY == _public(japi)
    assert PORT_ONLY <= _public(papi)


def test_reexports_are_the_ports_own_classes():
    for mod, names in REEXPORTS.items():
        for name in names:
            got = getattr(papi, name)
            assert got is getattr(mod, name), name
            assert got.__module__.startswith("spark_rapids_jni_tpu_torch."), name
            assert got is not getattr(japi, name), name


def test_facade_raises_the_reexported_cast_exception():
    col = Column.from_pylist(["5", None, "bad", "6"], STRING, device="cpu")
    with pytest.raises(papi.CastException) as e:
        papi.CastStrings.toInteger(col, True, True, DType("int", 32))
    assert (e.value.row_with_error, e.value.string_with_error) == (2, "bad")
