"""The port's exchange (``parallel/shuffle.py``, ``parallel/exchange.py``)
on 8 CPU shards against the JAX package's on its 8 virtual CPU devices:
the bucket pack, ``hash_shuffle`` and ``partition_exchange``, shard by
shard with tolerance 0 (occupancy, values, null masks, string offsets,
overflow counts). The JAX side of each comparison runs jitted: eager
``shard_map`` calls compile per op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.parallel import mesh as jmesh_mod
from spark_rapids_jni_tpu.parallel import shuffle as jsh

from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.ops._strategy import fusing
from spark_rapids_jni_tpu_torch.parallel import exchange
from spark_rapids_jni_tpu_torch.parallel import shuffle as psh
from spark_rapids_jni_tpu_torch.parallel.mesh import Mesh, ShardedTable
from spark_rapids_jni_tpu_torch.runtime.errors import CapacityExceededError

from torch_parity import (assert_same_shards, from_port_shards, host_counts, jax_table,
                          shard_forms, to_port_shards)

P = 8
N = 128


def _strings(rng, n, words, p_null):
    idx = rng.integers(0, len(words), n)
    lens = np.array([len(words[i]) for i in idx])
    return {"dtype": ("string", 0, None, None),
            "data": np.frombuffer(b"".join(words[i] for i in idx), np.uint8).copy(),
            "validity": rng.random(n) > p_null,
            "offsets": np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)}


def table_spec(n=N, seed=0):
    """Key ties, nulls, strings (empty, shared prefixes, past a 4-byte
    pin), NaN and -0.0, a DECIMAL128 above precision 18 (hashed as
    bytes) and one within it."""
    rng = np.random.default_rng(seed)
    f = rng.choice([-0.0, 0.0, 1.5, np.nan, -np.inf, 2.25], n)
    big = rng.integers(-(10**17), 10**17, n)
    return [
        {"dtype": ("int", 64, None, None), "data": rng.integers(0, 20, n),
         "validity": rng.random(n) > 0.2, "offsets": None},
        {"dtype": ("int", 32, None, None), "data": rng.integers(-5, 300, n).astype(np.int32),
         "validity": None, "offsets": None},
        _strings(rng, n, [b"", b"a", b"ab", b"hello", b"abcdefghijk", b"xy"], 0.1),
        {"dtype": ("float", 64, None, None), "data": f, "validity": rng.random(n) > 0.1,
         "offsets": None},
        {"dtype": ("decimal", 128, 38, 2), "data": np.stack([big, big >> 63], 1),
         "validity": rng.random(n) > 0.1, "offsets": None},
        {"dtype": ("decimal", 128, 18, 2), "data": np.stack([big, big >> 63], 1),
         "validity": None, "offsets": None},
    ]


# variant -> (keys, kwargs); the port and the JAX package get the same
SHUFFLES = {
    "string keys, occupied, wire pin, salt, undersized": (
        [0, 2], dict(capacity=1, string_widths={2: 16}, wire_widths={1: 8}, salt=1)),
    "fixed keys": ([0, 1], dict(string_widths={2: 16})),
    "float key": ([3], dict(string_widths={2: 16})),
    "decimal128 keys": ([4, 5], dict(capacity=4, string_widths={2: 16})),
    "truncating width": ([2], dict(string_widths={2: 4})),
}


@pytest.fixture(scope="module")
def data():
    spec = table_spec()
    occ = np.random.default_rng(1).random(N) > 0.3
    pids = (np.arange(N) * 5 % P).astype(np.int32)
    return spec, occ, pids


@pytest.fixture(scope="module")
def jax_results(data):
    """Every JAX exchange of the file from one jitted program."""
    spec, occ, pids = data
    jm = jmesh_mod.make_mesh(P)

    def run(t, o, p):
        out = {name: jsh.hash_shuffle(t, keys, jm, occupied=o, **kw)
               for name, (keys, kw) in SHUFFLES.items()}
        out["partition_exchange"] = jsh.partition_exchange(
            t, p, jm, capacity=1, occupied=o, string_widths={2: 16})
        return out

    return jax.jit(run)(jax_table(spec), jnp.asarray(occ), jnp.asarray(pids))


def same(a, b):
    """Bitwise equality (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int64 if a.element_size() == 8 else torch.int32), \
            b.view(torch.int64 if b.element_size() == 8 else torch.int32)
    return torch.equal(a, b)


def port_table(spec):
    return interop.table_from_numpy(spec, device="cpu")


def cpu_mesh(n=P):
    return Mesh(["cpu"] * n)


@pytest.mark.parametrize("name", sorted(SHUFFLES))
def test_hash_shuffle_matches_jax(data, jax_results, name):
    spec, occ, _ = data
    keys, kw = SHUFFLES[name]
    # the eager port raises where a pin truncates; a fused chain counts
    with fusing():
        out, pocc, povf = psh.hash_shuffle(port_table(spec), keys, cpu_mesh(),
                                           occupied=torch.from_numpy(occ), **kw)
    jout, jocc, jovf = jax_results[name]
    assert host_counts(povf) == host_counts(jovf)
    assert_same_shards(jout, jocc, out, pocc)


def test_partition_exchange_matches_jax(data, jax_results):
    spec, occ, pids = data
    out, pocc, povf = psh.partition_exchange(port_table(spec), torch.from_numpy(pids), cpu_mesh(),
                                             capacity=1, occupied=torch.from_numpy(occ),
                                             string_widths={2: 16})
    jout, jocc, jovf = jax_results["partition_exchange"]
    assert int(povf) == int(jovf) > 0
    assert_same_shards(jout, jocc, out, pocc)


def test_sharded_input_round_trip(jax_results):
    """A JAX row-sharded result carried into the port's form and back is
    the same table, block for block; the port's exchange over the carried
    shards equals its exchange over the same rows held as one table."""
    jout = jax_results["fixed keys"][0]
    sharded = to_port_shards(jout, cpu_mesh())
    for w, g in zip(shard_forms(jout, P), shard_forms(from_port_shards(sharded), P)):
        for wc, gc in zip(w, g):
            for k in ("data", "offsets", "validity"):
                assert (wc[k] is None) == (gc[k] is None)
                if wc[k] is not None:
                    np.testing.assert_array_equal(gc[k], wc[k])
    a = psh.hash_shuffle(sharded, [0, 1], cpu_mesh(), string_widths={2: 16})
    b = psh.hash_shuffle(sharded.gather(), [0, 1], cpu_mesh(), string_widths={2: 16})
    for sa, sb, oa, ob in zip(a[0].shards, b[0].shards, a[1], b[1]):
        assert torch.equal(oa, ob)
        for ca, cb in zip(sa.columns, sb.columns):
            assert same(ca.data, cb.data)


@pytest.mark.parametrize("case", ["plain", "sentinel", "drop", "empty"])
def test_pack_buckets_matches_jax(case):
    rng = np.random.default_rng(7)
    n = 0 if case == "empty" else 40
    pids = rng.integers(0, P, n).astype(np.int32)
    if case == "sentinel":
        pids[::3] = P  # dead rows: dropped, not counted
    cap = 2 if case == "drop" else n
    a = rng.integers(-100, 100, n)
    b = rng.integers(0, 2, (n, 2))
    jp, jc = jax.jit(jsh._pack_buckets, static_argnums=(2, 3))(
        [jnp.asarray(a), jnp.asarray(b)], jnp.asarray(pids), P, cap)
    pp, pc = psh._pack_buckets([torch.from_numpy(a), torch.from_numpy(b)],
                               torch.from_numpy(pids), P, cap)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    for x, y in zip(pp, jp):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_exchange_interface_matches_jax(n_shards):
    """``all_to_all`` (tiled=False: bucket j of shard i lands at slot i
    of shard j) and ``psum`` against jax.lax's inside shard_map."""
    from jax.sharding import PartitionSpec as JP

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    rng = np.random.default_rng(n_shards)
    x = rng.integers(-1000, 1000, (n_shards, n_shards, 3, 2))
    jm = jmesh_mod.make_mesh(n_shards)

    def body(blk, v):
        out = jax.lax.all_to_all(blk[0], "data", split_axis=0, concat_axis=0, tiled=False)
        return out[None], jax.lax.psum(v, "data")

    fn = jax.jit(shard_map(body, mesh=jm, in_specs=(JP("data"), JP("data")),
                           out_specs=(JP("data"), JP())))
    v = rng.integers(0, 50, n_shards)
    jout, jsum = fn(jnp.asarray(x), jnp.asarray(v))
    mesh = cpu_mesh(n_shards)
    got = exchange.all_to_all(mesh, [torch.from_numpy(x[i]) for i in range(n_shards)])
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), np.asarray(jout))
    total = exchange.psum(mesh, [torch.tensor(int(e)) for e in v])
    assert int(total) == int(np.asarray(jsum).reshape(-1)[0]) == int(v.sum())


def test_pinned_width_raises_outside_a_fused_chain(data):
    spec, occ, _ = data
    with pytest.raises(CapacityExceededError) as e:
        psh.hash_shuffle(port_table(spec), [2], cpu_mesh(), string_widths={2: 4})
    assert e.value.stage == "string_width" and e.value.granted == 4


def test_compress_round_trips(data):
    """``compress=True`` narrows the integer wire planes (one host read of
    their ranges) and gives the uncompressed exchange's result."""
    spec, occ, _ = data
    t = port_table(spec)
    a = psh.hash_shuffle(t, [0, 1], cpu_mesh(), string_widths={2: 16}, compress=True)
    b = psh.hash_shuffle(t, [0, 1], cpu_mesh(), string_widths={2: 16})
    assert int(a[2]) == int(b[2]) == 0
    for sa, sb in zip(a[0].shards, b[0].shards):
        for ca, cb in zip(sa.columns, sb.columns):
            assert ca.dtype == cb.dtype and same(ca.data, cb.data)


def test_fixed_keys_hash_in_one_call_per_device(data, monkeypatch):
    """The placement hash of fixed-width keys concatenates every shard on
    a device: one murmur3 call (one kernel launch on a card) per
    exchange; string keys take the plain chain instead."""
    from spark_rapids_jni_tpu_torch.kernels import murmur3

    calls = []
    real = murmur3.hash_columns
    monkeypatch.setattr(murmur3, "hash_columns", lambda t, s: calls.append(t.num_rows) or real(t, s))
    spec, _, _ = data
    psh.hash_shuffle(port_table(spec), [0, 1], cpu_mesh(), string_widths={2: 16})
    assert calls == [N]
    psh.hash_shuffle(port_table(spec), [2], cpu_mesh(), string_widths={2: 16})
    assert calls == [N]


def test_sharded_table_rejects_a_foreign_mesh(data):
    spec, _, _ = data
    st = psh.hash_shuffle(port_table(spec), [0], cpu_mesh(), string_widths={2: 16})[0]
    assert isinstance(st, ShardedTable) and st.num_rows == P * N
    with pytest.raises(ValueError, match="sharded over"):
        psh.hash_shuffle(st, [0], cpu_mesh(4), string_widths={2: 16})
    with pytest.raises(ValueError, match="not divisible"):
        psh.hash_shuffle(port_table(table_spec(n=12)), [0], cpu_mesh(), string_widths={2: 16})


def test_stacked_pack_matches_per_shard_pack():
    """The one-device pack of every shard at once (``_pack_stacked``)
    gives each shard exactly its own ``_pack_buckets`` result."""
    rng = np.random.default_rng(9)
    n = 24
    pids = [torch.from_numpy(rng.integers(0, P + 1, n)) for _ in range(P)]  # P = sentinel
    vals = [torch.from_numpy(rng.integers(-9, 9, (n, 2))) for _ in range(P)]
    packed, counts = psh._pack_stacked([torch.cat(vals)], torch.cat(pids), P, P, 3)
    for s in range(P):
        want, want_counts = psh._pack_buckets([vals[s]], pids[s], P, 3)
        assert torch.equal(packed[0][s], want[0]) and torch.equal(counts[s], want_counts)


def test_multi_device_path_matches_shared_device(data):
    """A mesh whose shards sit on different devices takes the per-shard
    pack and the peer-copy all_to_all (the multi-card path); on the CPU
    ("cpu" and "cpu:0" are distinct devices) it must give what the
    one-device path gives, hash launch grouping included."""
    spec, occ, _ = data
    mixed = Mesh(["cpu", "cpu:0"] * (P // 2))
    assert mixed.shared_device is None
    kw = dict(capacity=2, occupied=torch.from_numpy(occ), string_widths={2: 16})
    for keys in ([0, 1], [0, 2]):
        a = psh.hash_shuffle(port_table(spec), keys, mixed, **kw)
        b = psh.hash_shuffle(port_table(spec), keys, cpu_mesh(), **kw)
        assert int(a[2]) == int(b[2])
        for sa, sb, oa, ob in zip(a[0].shards, b[0].shards, a[1], b[1]):
            assert torch.equal(oa, ob)
            for ca, cb in zip(sa.columns, sb.columns):
                assert same(ca.data, cb.data)
                assert (ca.offsets is None) or torch.equal(ca.offsets, cb.offsets)
