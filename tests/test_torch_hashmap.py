"""The port's hash map (``legion_tpu_torch/cache/hashmap.py``, K11's plain
version on the CPU) against ``legion_tpu/cache/hashmap.py``: the same
tables from the same keys, the same lookups; and the billion-vertex sizing
contract of ``tests/test_hashmap.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legion_tpu.cache.hashmap import HashMap32 as JHashMap32
from legion_tpu.cache.hashmap import map_lookup as jax_map_lookup
from legion_tpu_torch.cache.hashmap import (BUCKET, HashMap32, _hash,
                                            _table_of, hash_lookup_plain,
                                            map_lookup)
from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.sampling.sampler import NeighborSampler


def _keys(n, load, seed):
    rng = np.random.default_rng(seed)
    ids = rng.choice(5_000_000, n, replace=False).astype(np.int64)
    vals = rng.integers(0, 2 ** 30, n).astype(np.int32)
    return ids, vals, rng


# (keys, load): the maps' own load of 0.5, and loads that need probe
# rounds >= 2 and >= 3
CASES = [(100_000, 0.5), (3_000, 0.9), (20_000, 0.97)]


@pytest.mark.parametrize("n,load", CASES)
def test_build_equals_jax(n, load):
    ids, vals, _ = _keys(n, load, n)
    jm = JHashMap32.build(ids, vals, load=load)
    pm = HashMap32.build(ids, vals, load=load)
    np.testing.assert_array_equal(pm.keys.numpy(), np.asarray(jm.keys))
    np.testing.assert_array_equal(pm.vals.numpy(), np.asarray(jm.vals))
    assert pm.probes == jm.probes
    assert pm.n_buckets == jm.n_buckets and pm.hbm_bytes == jm.hbm_bytes


@pytest.mark.parametrize("n,load", CASES)
def test_keys_and_vals_are_views_of_one_table(n, load):
    """One [B, 16] table a map, keys then values in a row: ``keys`` and
    ``vals`` are its halves, equal to JAX's arrays, and K11's wrapper
    reads it in place (separate arrays are packed into the same table)."""
    ids, vals, _ = _keys(n, load, n)
    jm = JHashMap32.build(ids, vals, load=load)
    pm = HashMap32.build(ids, vals, load=load)
    t = pm.table
    assert t.shape == (pm.n_buckets, 2 * BUCKET) and t.is_contiguous()
    assert pm.keys.data_ptr() == t.data_ptr()
    assert pm.vals.data_ptr() == t.data_ptr() + 4 * BUCKET
    assert pm.keys.untyped_storage().data_ptr() == \
        t.untyped_storage().data_ptr() == pm.vals.untyped_storage().data_ptr()
    np.testing.assert_array_equal(t[:, :BUCKET].numpy(), np.asarray(jm.keys))
    np.testing.assert_array_equal(t[:, BUCKET:].numpy(), np.asarray(jm.vals))
    assert pm.hbm_bytes == jm.hbm_bytes == t.numel() * 4
    assert _table_of(pm.keys, pm.vals).data_ptr() == t.data_ptr()
    packed = _table_of(pm.keys.clone(), pm.vals.clone())
    assert packed.data_ptr() != t.data_ptr() and torch.equal(packed, t)


def _edge_map(case):
    """(keys, values, load, query ids) of a map at an edge of K11's
    shapes: the largest int32 id; a map of 2 buckets; a chain of buckets
    that fills from bucket B - 1 and wraps past it (3 or more rounds),
    every query in it."""
    rng = np.random.default_rng(17)
    if case == "max id":
        keys = np.append(rng.choice(2 ** 31 - 1, 999, replace=False),
                         2 ** 31 - 1)
        q = np.concatenate([keys, [2 ** 31 - 1, 2 ** 31 - 2, 2 ** 31 - 3],
                            rng.integers(0, 2 ** 31 - 1, 500), [-1]])
        return keys, rng.integers(0, 2 ** 31 - 1, 1000), 0.5, q
    if case == "2 buckets":
        keys = rng.choice(1000, 12, replace=False)
        return (keys, np.arange(12), 0.9,
                np.concatenate([keys, np.arange(1000), [-1, -7]]))
    # 64 buckets: 170 keys anywhere, 30 whose first bucket is 63
    cand = np.arange(1, 400_000)
    last = cand[_hash(cand, 64) == 63]
    keys = np.concatenate([last[:30], rng.choice(np.setdiff1d(
        np.arange(400_000), last), 170, replace=False)])
    return keys, rng.integers(0, 2 ** 30, 200), 0.5, last[:200]


@pytest.mark.parametrize("case", ["max id", "2 buckets", "wrapping chain"])
def test_lookup_through_views_equals_jax_at_edges(case):
    keys, vals, load, q = _edge_map(case)
    jm = JHashMap32.build(keys, vals.astype(np.int32), load=load)
    pm = HashMap32.build(keys, vals.astype(np.int32), load=load)
    if case == "2 buckets":
        assert pm.n_buckets == 2
    if case == "wrapping chain":
        assert pm.n_buckets == 64 and pm.probes >= 3
        # keys of bucket 63's chain sit in buckets 0 and 1
        k = pm.keys.numpy()
        assert np.isin(k[:2], keys[:30]).any()
    qt = q.astype(np.int32)
    got = pm.lookup(torch.from_numpy(qt)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.lookup(jnp.asarray(qt))))
    hit = np.isin(qt, keys)
    assert (got[hit] >= 0).all() and (got[~hit] == -1).all()


@pytest.mark.parametrize("n,load", CASES)
def test_lookup_equals_jax(n, load):
    """Hits, misses and -1 pads, through every probe round the map
    needs."""
    ids, vals, rng = _keys(n, load, n + 1)
    jm = JHashMap32.build(ids, vals, load=load)
    pm = HashMap32.build(ids, vals, load=load)
    if load > 0.5:
        assert pm.probes >= 2
    absent = np.setdiff1d(rng.integers(0, 5_000_000, 2000), ids)[:1000]
    probe = np.concatenate([ids, absent, [-1, -1, -1]]).astype(np.int32)
    rng.shuffle(probe)
    got = pm.lookup(torch.from_numpy(probe)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.lookup(
        jnp.asarray(probe))))
    hit = np.isin(probe, ids)
    assert (got[~hit] == -1).all() and (got[hit] >= 0).all()
    # 2-D ids, as the clique caches look up every member's at once
    two = torch.from_numpy(probe[:2000].reshape(4, 500))
    np.testing.assert_array_equal(pm.lookup(two).numpy().reshape(-1),
                                  got[:2000])
    assert kernels.LAUNCHES["hash_lookup"] == 0    # CPU tensors: plain


def test_plain_lookup_reads_every_probe_round():
    """K11 stops at a bucket with an empty slot; the plain version reads
    all ``probes`` rounds, as JAX does. Both give the build's value: a key
    placed in round r found its buckets before r full."""
    ids, vals, rng = _keys(20_000, 0.97, 5)
    pm = HashMap32.build(ids, vals, load=0.97)
    q = torch.from_numpy(ids.astype(np.int32))
    for p in range(1, pm.probes):
        # with fewer rounds, the keys placed late are not found
        short = hash_lookup_plain(pm.keys, pm.vals, p, q)
        assert (short == -1).any()
    np.testing.assert_array_equal(
        hash_lookup_plain(pm.keys, pm.vals, pm.probes, q).numpy(), vals)


def test_map_lookup_equals_jax_for_both_forms():
    rng = np.random.default_rng(3)
    V = 10_000
    hot = rng.choice(V, 600, replace=False)
    table = np.full(V, -1, np.int32)
    table[hot] = np.arange(600, dtype=np.int32)
    q = rng.integers(-1, V, 3000).astype(np.int32)
    ref = np.asarray(jax_map_lookup(jnp.asarray(table), jnp.asarray(q)))
    np.testing.assert_array_equal(
        map_lookup(torch.from_numpy(table), torch.from_numpy(q)).numpy(),
        ref)
    pm = HashMap32.build(hot, np.arange(600, dtype=np.int32))
    np.testing.assert_array_equal(map_lookup(pm, torch.from_numpy(q))
                                  .numpy(), ref)


def test_hashmap_clique_sizing_uk2014():
    """The clique config at uk2014 scale: lookup state with hash maps is
    O(cached) for both clique maps, against 6.3 GB of direct tables
    (``tests/test_hashmap.py:94``)."""
    V = 787_801_471
    feat_cached = 30_000_000
    topo_cached = 10_000_000
    m = HashMap32.build(np.arange(100_000, dtype=np.int64),
                        np.arange(100_000, dtype=np.int32))
    bpe = m.hbm_bytes / 100_000
    clique_maps_bytes = bpe * (feat_cached + topo_cached)
    direct_bytes = V * 4 * 2
    assert clique_maps_bytes < 2.6e9
    assert clique_maps_bytes < direct_bytes / 2
    assert m.keys.shape[1] == BUCKET


def test_billion_vertex_lookup_state_fits():
    """uk2014 (0.79B vertices): the lookup state of one replica fits a
    card beside its cache: hash maps O(cached), label banks O(seeds), and
    sort dedup without a [V] position map (``tests/test_hashmap.py:110``).
    """
    V = 787_801_471
    cached_rows = 30_000_000
    m = HashMap32.build(np.arange(100_000, dtype=np.int64),
                        np.arange(100_000, dtype=np.int32))
    bytes_per_entry = m.hbm_bytes / 100_000
    hash_bytes = bytes_per_entry * cached_rows
    label_bank_bytes = 8000 * 10_000 * 4
    direct_bytes = V * 4 * 2
    assert hash_bytes < 2e9, hash_bytes
    assert hash_bytes + label_bank_bytes < direct_bytes / 3
    s = NeighborSampler(SamplerConfig(fanouts=(25, 10), batch_size=8000,
                                      dedup="sort", dedup_last_hop=False),
                        V)
    assert s.state_size == 1
