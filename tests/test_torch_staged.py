"""The staged host pipeline (``host_transfer="staged"``) against the JAX
package's and against the port's zero-copy trainer, on the CPU.

K19's and K20's plain versions against JAX's ``StagedHostPipeline.
_feature_tail`` and ``_assemble`` (exact, overflow included, K19 also at
its card kernel's tile edges); K21's against ``GraphAccess.merge_draws``;
the split draws merged by K21 against ``sample_neighbors`` (bit for
bit); staged trainers against zero-copy trainers of the same seed (host
features, host features and topology, 4 members with both caches), the
miss cap's overflow, the lookahead across an eval pass and a restore, and
the mode rules (``tests/test_staged_host.py``'s, for the port).
"""

import warnings
from dataclasses import replace
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legion_tpu import native
from legion_tpu.cache.cost_model import CostModelResult as JPlan
from legion_tpu.cache.hashmap import HashMap32 as JHashMap32
from legion_tpu.cache.unified_cache import UnifiedCache as JCache
from legion_tpu.data import synthesize_dataset as jax_host_synth
from legion_tpu.pipeline.staged import StagedHostPipeline as JStaged
from legion_tpu.sampling.access import GraphAccess as JGraphAccess
from legion_tpu_torch.cache.collective import (CliqueTopoCache,
                                               build_clique_topo)
from legion_tpu_torch.cache.hashmap import HashMap32
from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import synthesize_dataset
from legion_tpu_torch.ops.host_memory import (HostTable, bf16_pitch,
                                              bf16_rows,
                                              gather_host_rows_plain)
from legion_tpu_torch.pipeline import Mode
from legion_tpu_torch.pipeline.staged import (StagedHostPipeline,
                                              miss_compact_plain,
                                              staged_assemble_plain)
from legion_tpu_torch.sampling.access import (CachedTopoAccess,
                                              csr_draw_plain, key_tensor,
                                              merge_draws_plain)
from legion_tpu_torch.train import Trainer
from legion_tpu_torch.utils import restore_checkpoint
from legion_tpu_torch.utils.convert import (cache_from_jax,
                                            legion_dataset_from_jax)

RTOL, ATOL = 1e-5, 1e-6     # JAX's test_staged_host.py tolerance


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# K19 against JAX's _feature_tail
# ---------------------------------------------------------------------------

V, M = 500, 300


def _ids(case, rng):
    """[M] int32 ids: pads, repeated ids, every kind of lane."""
    if case == "empty":
        return np.full(M, -1, np.int32)
    ids = rng.integers(0, V, M).astype(np.int32)
    ids[rng.random(M) < 0.15] = -1
    ids[::7] = ids[3]                       # one id many times
    ids[-20:] = -1                          # a padded tail
    return ids


def _hot(case, rng):
    """The cached ids: about half, all or none of the graph."""
    n = {"all_hit": V, "all_miss": 0}.get(case, V // 2)
    return rng.permutation(V)[:n].astype(np.int64)


def _jax_tail(lookup, ids, clique=False):
    fake = SimpleNamespace(
        t=SimpleNamespace(_topo_hit_count=lambda b, a, s: (0, 0)),
        staged_clique=clique)
    batch = SimpleNamespace(node_ids=jnp.asarray(ids),
                            num_edges=jnp.zeros(2, jnp.int32))
    out = JStaged._feature_tail(fake, SimpleNamespace(max_ids=len(ids)),
                                batch, None, lookup, jnp.zeros((1, 1, 1)))
    _, payload, m_ids, m_pos, n_miss, hits = out[:6]
    return (np.asarray(payload), np.asarray(m_ids), np.asarray(m_pos),
            int(n_miss), int(hits))


@pytest.mark.parametrize("form", ["map", "hash", "clique"])
@pytest.mark.parametrize("case", ["mixed", "all_hit", "all_miss", "empty"])
def test_miss_compact_equals_jax_feature_tail(form, case):
    """K19's plain version equals JAX's lookup and lax.sort compaction
    exactly: m_ids, m_pos, n_miss, hits (and the payload of the map and
    hash forms), with pads, hits, misses and repeated ids; each lane's
    rank is its place in m_pos."""
    rng = np.random.default_rng(["mixed", "all_hit", "all_miss",
                                 "empty"].index(case))
    ids = _ids(case, rng)
    hot = _hot(case, rng)
    table = np.full(V, -1, np.int32)
    table[hot] = np.arange(len(hot), dtype=np.int32)
    it = torch.from_numpy(ids)[None]
    if form == "map":
        want = _jax_tail(jnp.asarray(table), ids)
        got = miss_compact_plain(it, table=torch.from_numpy(table))
    elif form == "hash":
        vals = np.arange(len(hot), dtype=np.int32)
        want = _jax_tail(JHashMap32.build(hot, vals), ids)
        slot = HashMap32.build(hot, vals).lookup(it)
        got = miss_compact_plain(it, slot=slot)
    else:
        hit = (ids >= 0) & (table[np.clip(ids, 0, V - 1)] >= 0) \
            & (rng.random(M) < 0.7)      # served: cached, not overflowed

        class Lookup:
            def fetch_cached(self, nid, rows):
                return jnp.zeros((M, 4)), jnp.asarray(hit)
        want = _jax_tail(Lookup(), ids, clique=True)
        got = miss_compact_plain(it, hit=torch.from_numpy(hit)[None])
    payload, m_ids, m_pos, n_miss, hits = want
    np.testing.assert_array_equal(_np(got.m_ids[0]), m_ids)
    np.testing.assert_array_equal(_np(got.m_pos[0]), m_pos)
    assert int(got.n_miss[0]) == n_miss and int(got.hits[0]) == hits
    if form != "clique":
        np.testing.assert_array_equal(_np(got.payload[0]), payload)
    rank = np.full(M, -1, np.int32)
    rank[m_pos[:n_miss]] = np.arange(n_miss)
    np.testing.assert_array_equal(_np(got.rank[0]), rank)


# K19's tiles hold 1024 lanes of one member (csrc/staged.cu kCompactTile)
TILE = 1024


@pytest.mark.parametrize("form,n,m", [
    ("map", 1, TILE - 1), ("map", 1, TILE), ("map", 1, TILE + 1),
    ("hash", 1, 3 * TILE + 5), ("map", 4, TILE + 1), ("hash", 4, TILE + 1),
    ("clique", 4, TILE + 1)])
def test_miss_compact_equals_jax_at_tile_edges(form, n, m):
    """K19's plain version equals JAX's ``_feature_tail`` member by member
    at the card kernel's tile edges (a tile less a lane, one tile, one
    more, several tiles) and for 4 members of different n_miss (pads 5%,
    40%, 90% and all), exactly: m_ids, m_pos, n_miss, hits, the payload
    and each lane's rank."""
    rng = np.random.default_rng(m + n)
    nv = 3 * m
    ids = rng.integers(0, nv, (n, m)).astype(np.int32)
    pad = np.array([0.05, 0.4, 0.9, 1.0])[:n, None]
    ids[rng.random((n, m)) < pad] = -1
    hot = rng.permutation(nv)[:nv // 2].astype(np.int64)
    table = np.full(nv, -1, np.int32)
    table[hot] = np.arange(len(hot), dtype=np.int32)
    it = torch.from_numpy(ids)
    hit = (ids >= 0) & (table[np.clip(ids, 0, nv - 1)] >= 0) \
        & (rng.random((n, m)) < 0.7)
    vals = np.arange(len(hot), dtype=np.int32)
    if form == "map":
        got = miss_compact_plain(it, table=torch.from_numpy(table))
        lookup = jnp.asarray(table)
    elif form == "hash":
        got = miss_compact_plain(it, slot=HashMap32.build(hot, vals)
                                 .lookup(it))
        lookup = JHashMap32.build(hot, vals)
    else:
        got = miss_compact_plain(it, hit=torch.from_numpy(hit))
    n_miss = []
    for k in range(n):
        if form == "clique":
            class Lookup:
                def fetch_cached(self, nid, rows, k=k):
                    return jnp.zeros((m, 4)), jnp.asarray(hit[k])
            want = _jax_tail(Lookup(), ids[k], clique=True)
        else:
            want = _jax_tail(lookup, ids[k])
        payload, m_ids, m_pos, nm, hits = want
        np.testing.assert_array_equal(_np(got.m_ids[k]), m_ids)
        np.testing.assert_array_equal(_np(got.m_pos[k]), m_pos)
        assert int(got.n_miss[k]) == nm and int(got.hits[k]) == hits
        if form != "clique":
            np.testing.assert_array_equal(_np(got.payload[k]), payload)
        rank = np.full(m, -1, np.int32)
        rank[m_pos[:nm]] = np.arange(nm)
        np.testing.assert_array_equal(_np(got.rank[k]), rank)
        n_miss.append(nm)
    assert len(set(n_miss)) == n      # the members' n_miss all differ


@pytest.mark.parametrize("fanout", [1, 25, 33])
@pytest.mark.parametrize("F", [257, 777])
def test_merge_draws_equals_jax_merge_draws(fanout, F):
    """K21's plain version equals JAX's ``GraphAccess.merge_draws``
    exactly, for each of 4 members (nothing, half, most and everything
    served), at F not a multiple of the card kernel's slots a block."""
    rng = np.random.default_rng(fanout * F)
    n = 4
    lanes = rng.integers(-1, 10_000, (n, fanout * F)).astype(np.int32)
    served = rng.random((n, F)) < np.array([0.0, 0.5, 0.9, 1.0])[:, None]
    host = rng.integers(-1, 10_000, (n, F, fanout)).astype(np.int32)
    got = merge_draws_plain(torch.from_numpy(lanes),
                            torch.from_numpy(served),
                            torch.from_numpy(host), fanout)
    assert tuple(got.shape) == (n, fanout * F)
    for k in range(n):
        want = JGraphAccess.merge_draws(jnp.asarray(lanes[k]),
                                        jnp.asarray(served[k]),
                                        jnp.asarray(host[k]), fanout)
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want))


# ---------------------------------------------------------------------------
# K20 against JAX's _assemble
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jds():
    return jax_host_synth(num_nodes=V, avg_degree=6, feature_dim=20,
                          num_classes=4, batch_size=32, seed=2)


def _jax_assemble(rows, payload, m_pos, x_miss, cap, clique):
    fake = SimpleNamespace(staged_clique=clique,
                           t=SimpleNamespace(_cache=SimpleNamespace(
                               cache_rows=rows)))
    return JStaged._assemble(fake, payload, m_pos, x_miss, cap, M)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [256, 64])
@pytest.mark.parametrize("form", ["cache", "clique"])
def test_assemble_equals_jax(jds, dtype, cap, form):
    """K20's plain version equals JAX's ``_assemble`` bit for bit, with
    the cache JAX builds (``cache_from_jax``) and the rows JAX's host
    gather ships (``native.gather_rows``, f32 or bf16), including a cap
    under n_miss (the tail misses zero rows); the staged rows past
    min(n_miss, cap) are garbage that must not be read. The port's
    shipped rows come from its host table (bf16: ``bf16_rows``) and equal
    JAX's gather bit for bit."""
    rng = np.random.default_rng(cap)
    ids = _ids("mixed", rng)
    hot = _hot("mixed", rng)
    plan = JPlan(feature_capacity=len(hot), topo_capacity=0, alpha=1.0,
                 feature_order=hot, topo_order=np.arange(V),
                 est_feat_saved_bytes=0.0, est_topo_saved_bytes=0.0)
    jc = JCache.build_from_host(plan, jds.features, None, None, V,
                                feat_dtype=dtype)
    pc = cache_from_jax(jc)
    comp = miss_compact_plain(torch.from_numpy(ids)[None], table=pc.slot_map)
    n_miss = int(comp.n_miss[0])
    assert (n_miss > cap) == (cap == 64)
    m_ids = _np(comp.m_ids[0])
    x_miss = native.gather_rows(jds.features, m_ids[:cap], dtype=dtype)
    F = jds.features.shape[1]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if dtype == "bfloat16":
        host = HostTable(bf16_rows(jds.features, bf16_pitch(F)),
                         pin=False).host
    else:
        host = torch.from_numpy(jds.features)
    staged = torch.from_numpy(rng.standard_normal((1, cap, F)).astype(
        np.float32)).to(tdt)
    k = min(n_miss, cap)
    gather_host_rows_plain(host, comp.m_ids[0, :k], staged[0, :k])
    np.testing.assert_array_equal(_bits(x_miss[:k]),
                                  _bits(_np(staged[0, :k].float()).astype(
                                      x_miss.dtype)))
    if form == "cache":
        want = _jax_assemble(jc.cache_rows, jnp.asarray(_np(comp.payload[0])),
                             jnp.asarray(_np(comp.m_pos[0])),
                             jnp.asarray(x_miss), cap, False)
        got = staged_assemble_plain(pc.cache_rows, comp.payload, staged,
                                    comp.rank, cap)
    else:
        # the clique's rows: the cached lanes' rows, zero elsewhere
        payload = jnp.asarray(jc.cache_rows)[jnp.clip(
            jnp.asarray(_np(comp.payload[0])), 0)] * (
                jnp.asarray(_np(comp.payload[0])) >= 0)[:, None].astype(
                    jc.cache_rows.dtype)
        want = _jax_assemble(None, payload, jnp.asarray(_np(comp.m_pos[0])),
                             jnp.asarray(x_miss), cap, True)
        rows = torch.from_numpy(np.asarray(payload).astype(
            np.float32)).to(tdt)[None]
        got = staged_assemble_plain(rows, None, staged, comp.rank, cap)
    np.testing.assert_array_equal(_bits(want),
                                  _bits(_np(got[0].float()).astype(
                                      np.asarray(want).dtype)))


# ---------------------------------------------------------------------------
# split draws: K5's device-only form, the host's draws, K21
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph():
    ds = synthesize_dataset(num_nodes=800, avg_degree=9, feature_dim=8,
                            num_classes=4, batch_size=32, seed=4)
    g = ds.graph
    return (HostTable(np.asarray(g.indptr, np.int64), pin=False),
            HostTable(np.asarray(g.indices, np.int32), pin=False))


def _cached_topo(graph, rng):
    ip, ix = graph
    V_ = ip.shape[0] - 1
    hot = rng.permutation(V_)[:V_ // 3]
    plan = SimpleNamespace(feature_capacity=0, topo_capacity=len(hot),
                           topo_order=hot, feature_order=np.arange(V_))
    from legion_tpu_torch.cache.unified_cache import UnifiedCache
    c = UnifiedCache.build_from_host(plan, None, ip.array, ix.array, V_)
    return CachedTopoAccess(c.row_map, c.sub_indptr, c.sub_indices, ip, ix)


@pytest.mark.parametrize("fanout", [1, 7])
@pytest.mark.parametrize("kind", ["cached", "all_miss", "clique"])
def test_split_draws_merge_to_sample_neighbors(graph, kind, fanout):
    """merge_draws(lookup, host_draw of the unserved slots) equals
    sample_neighbors bit for bit: a hot sub-CSR (K5's device-only form
    for the cached rows), every row on the host (``all_miss``: nothing
    served) and a 4-member clique (member m's misses drawn with m's own
    hop words). The host's draws equal K5's full-CSR draws of the same
    slots."""
    rng = np.random.default_rng(fanout)
    ip, ix = graph
    V_ = ip.shape[0] - 1
    if kind == "cached":
        acc = _cached_topo(graph, rng)
    else:
        acc = CachedTopoAccess.all_miss(ip, ix, "cpu")
    n = 4 if kind == "clique" else 1
    if kind == "clique":
        hot = rng.permutation(V_)[:V_ // 2]
        row_map, pairs, blocks, _ = build_clique_topo(
            hot, len(hot), ip.array, ix.array, 4, window=8)
        acc = CliqueTopoCache(row_map, pairs, blocks, acc, 4,
                              request_slack=0.8)
    F = 150
    front = rng.integers(0, V_, (n, F)).astype(np.int32)
    front[:, rng.random(F) < 0.1] = -1
    front[:, :5] = front[:, 5:10]               # repeated vertices
    ft = torch.from_numpy(front)
    keys = key_tensor([int(k) for k in rng.integers(0, 2 ** 40, n)], "cpu")
    if kind != "clique":
        ft, keys = ft[0], keys[0]
    assert acc.needs_host_draws
    want = acc.sample_neighbors(ft, fanout, keys)
    lanes, served = acc.lookup(ft, fanout, keys)
    miss = torch.where(served, -1, ft)
    host = acc.host_draw(miss, fanout, keys)
    assert tuple(host.shape) == tuple(ft.shape) + (fanout,)
    got = acc.merge_draws(lanes, served, host, fanout)
    assert torch.equal(got, want)
    if kind == "all_miss":
        assert not served.any() and bool((lanes == -1).all())
    else:
        assert 0 < int(served.sum()) < int((ft >= 0).sum())
    # the host's draws are K5's on the full CSR, slot for slot
    for m in range(n):
        f_m = miss.reshape(n, F)[m]
        k5 = csr_draw_plain(f_m, fanout, keys.reshape(n, 4)[m], ip.host,
                            ix.host).view(fanout, F).T
        assert torch.equal(host.reshape(n, F, fanout)[m], k5)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_ds():
    return synthesize_dataset(num_nodes=2000, avg_degree=8, feature_dim=32,
                              num_classes=5, batch_size=64, seed=7)


def _cfg(ds, transfer, case="H", **train):
    n = 4 if case == "clique" else 1
    topo = "hbm" if case in ("H", "H-hash") else "host"
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(5, 3), batch_size=64 if n == 1
                              else 16, eval_batch_size=32, dedup="sort",
                              neighbor_window=8),
        cache=CacheConfig(cache_bytes=100_000 if n == 1 else 60_000,
                          feature_residency="host", topo_residency=topo,
                          presample_steps=2, host_transfer=transfer,
                          map_impl="hash" if case == "H-hash" else "auto"),
        train=TrainConfig(model="graphsage", hidden_dim=16, epochs=1,
                          seed=3, compute_dtype="float32" if n > 1
                          else "bfloat16", **train),
        mesh=MeshConfig(1, n))


@pytest.mark.parametrize("case", ["H", "H-hash", "HT", "clique"])
def test_staged_matches_zero_copy(host_ds, case):
    """A staged trainer's losses, counters and valid accuracy over 3
    steps and a valid pass equal the zero-copy trainer's on the same
    seed (JAX's tolerance; equality is what happens): host features (a
    bf16 cache; the direct map, and the hash map with K11's lookup),
    host features and topology (host draws between the
    hops), and 4 members with both clique caches (f32)."""
    t_zc = Trainer(host_ds, _cfg(host_ds, "auto", case), "cpu")
    t_st = Trainer(host_ds, _cfg(host_ds, "staged", case), "cpu")
    assert not t_zc._staged_host and t_st._staged_host
    assert t_st._staged.staged_clique == (case == "clique")
    assert t_st.graph_access.needs_host_draws == (case not in ("H",
                                                               "H-hash"))
    assert (t_st._staged._hash is not None) == (case == "H-hash")
    s_zc, s_st = t_zc.init_state(), t_st.init_state()
    for _ in range(3):
        s_zc, l_zc = t_zc.train_step(s_zc)
        s_st, l_st = t_st.train_step(s_st)
        np.testing.assert_allclose(float(l_st), float(l_zc), rtol=RTOL,
                                   atol=ATOL)
        for c in ("last_edges", "last_slots", "last_feat_hits",
                  "last_topo_hits", "last_topo_total"):
            assert int(getattr(t_st, c)) == int(getattr(t_zc, c)), c
    assert 0 < int(t_st.last_feat_hits) < int(t_st.last_slots)
    assert t_st._staged.miss_overflows == 0 and t_st._staged._ctr == 3
    s_zc, acc_zc = t_zc.run_eval(s_zc, Mode.VALID)
    s_st, acc_st = t_st.run_eval(s_st, Mode.VALID)
    assert abs(acc_zc - acc_st) < 1e-6 and int(s_st["total"]) > 0
    for a, b in zip(s_zc["model"].parameters(), s_st["model"].parameters()):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    t_zc.close()
    t_st.close()


def test_miss_cap_overflow_drops_tail(host_ds, monkeypatch):
    """A cap of 8 (the probe patched, as JAX's test does): every step
    overflows, trains on finite losses with the tail misses as zero rows
    (the assembled rows equal JAX's ``_assemble`` on the same inputs, the
    rows its host gather ships), counts each overflowing step and warns
    once; the probed caps follow JAX's rule."""
    t = Trainer(host_ds, _cfg(host_ds, "staged"), "cpu")
    M_ = t.sampler_t.max_ids
    assert t._staged.miss_cap % 512 == 0 or t._staged.miss_cap == M_
    assert (t._staged.miss_cap <= M_
            and t._staged.eval_miss_cap <= t.sampler_e.max_ids)
    t.close()
    monkeypatch.setattr(StagedHostPipeline, "probe_miss_cap",
                        lambda self: 8)
    t = Trainer(host_ds, _cfg(host_ds, "staged"), "cpu")
    assert t._staged.miss_cap == 8
    pipe = t._staged
    seen, orig = [], pipe._assemble

    def record(a, staged, cap):
        x = orig(a, staged, cap)
        seen.append((a.comp, a.slot, staged.clone(), cap, x))
        return x
    pipe._assemble = record
    s = t.init_state()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(2):
            s, loss = t.train_step(s)
            assert np.isfinite(float(loss))
    msgs = [x for x in w if "miss buffer overflow" in str(x.message)]
    assert len(msgs) == 1 and t._staged.miss_overflows == 2
    rows = t.cache.cache_rows
    for comp, slot, staged, cap, x in seen:
        assert int(comp.n_miss[0]) > cap == 8
        x_miss = native.gather_rows(host_ds.features,
                                    _np(comp.m_ids[0, :cap]),
                                    dtype="bfloat16")
        want = _jax_assemble(
            jnp.asarray(_np(rows.float())).astype(jnp.bfloat16),
            jnp.asarray(_np(slot[0])), jnp.asarray(_np(comp.m_pos[0])),
            jnp.asarray(x_miss), cap, False)
        np.testing.assert_array_equal(
            np.asarray(want).astype(np.float32), _np(x.float()))
        shipped = (comp.rank[0] >= 0) & (comp.rank[0] < cap)
        dropped = (comp.rank[0] >= cap)
        assert int(shipped.sum()) == 8 and bool(dropped.any())
        assert bool((x[dropped] == 0).all())
    t.close()


def _losses(tr, s, n):
    out = []
    for _ in range(n):
        s, loss = tr.train_step(s)
        out.append(float(loss))
    return s, out


def test_lookahead_survives_eval_and_restore(host_ds, tmp_path):
    """JAX's ``test_staged_prefetch_pipeline_chains``, and a restore: an
    eval pass between steps leaves the loss sequence of an uninterrupted
    run; a checkpoint restored into a fresh trainer, and into the same
    trainer after it trained past it (its lookahead dropped by the
    resync), continues that sequence."""
    cfg = _cfg(host_ds, "staged", "HT")
    t1 = Trainer(host_ds, cfg, "cpu")
    s = t1.init_state()
    s, l0 = _losses(t1, s, 1)
    s, _ = t1.run_eval(s, Mode.VALID)
    s, l1 = _losses(t1, s, 1)
    t1.save(str(tmp_path), s)
    s, l2 = _losses(t1, s, 2)
    t2 = Trainer(host_ds, cfg, "cpu")
    _, ref = _losses(t2, t2.init_state(), 4)
    np.testing.assert_allclose(l0 + l1 + l2, ref, rtol=RTOL, atol=ATOL)
    t3 = Trainer(host_ds, cfg, "cpu")
    _, r3 = _losses(t3, restore_checkpoint(str(tmp_path), t3), 2)
    np.testing.assert_allclose(r3, ref[2:], rtol=RTOL, atol=ATOL)
    # the same trainer, its lookahead at counter 4: resync to 2
    assert t1._staged._prefetch[0] == 4
    _, r1 = _losses(t1, restore_checkpoint(str(tmp_path), t1), 2)
    np.testing.assert_allclose(r1, ref[2:], rtol=RTOL, atol=ATOL)
    for t in (t1, t2, t3):
        t.close()


def test_staged_mode_rules(host_ds):
    """As in JAX (legion_tpu/train.py:192-194, :516, :872): staged with
    ``fused_steps`` > 1 is refused; staged with ``interbatch`` builds, its
    step is the staged pipeline's and ``prime_carry`` leaves the state
    alone; the launcher's fit takes one step a call."""
    cfg = _cfg(host_ds, "staged")
    with pytest.raises(ValueError, match="fused single-program path"):
        Trainer(host_ds, replace(cfg, train=replace(cfg.train,
                                                    fused_steps=2)), "cpu")
    t = Trainer(host_ds, replace(cfg, train=replace(cfg.train,
                                                    interbatch=True)), "cpu")
    assert t._staged_host and not t.interbatch
    s = t.init_state()
    assert "carry_batch" not in s and "carry_batch" not in t.prime_carry(s)
    s, stats = t.fit(s, verbose=False)
    assert s["train_ctr"] == t.schedule.train_step == t._staged._ctr
    assert np.isfinite(stats[0].train_loss) and t.test_acc is not None
    t.close()
    t.close()                   # twice is fine


def test_port_dataset_from_jax_trains_staged():
    """A JAX host dataset carried over (``legion_dataset_from_jax``) trains
    staged as the port's own does."""
    jd = jax_host_synth(num_nodes=1200, avg_degree=6, feature_dim=16,
                        num_classes=4, batch_size=64, seed=1)
    ds = legion_dataset_from_jax(jd)
    t = Trainer(ds, _cfg(ds, "staged", "HT"), "cpu")
    s, losses = _losses(t, t.init_state(), 2)
    assert all(np.isfinite(losses))
    t.close()
