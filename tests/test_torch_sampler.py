"""Parity of the port's sampler with the JAX package, on the CPU.

K3 (``windowed_draw``) runs its plain version here; its deterministic half
``windowed_select`` is fed the exact block choices and in-block offsets
that JAX draws, and must reproduce ``WindowedCSRAccess.sample_neighbors``.
The port's own random words are held by distribution. ``SampleBatch``
parity injects JAX's per-hop candidates. Graphs are made with numpy.
"""

import zlib
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.graph import CSRGraph
from legion_tpu.sampling.access import WindowedCSRAccess as JWindowed
from legion_tpu.sampling.sampler import NeighborSampler as JSampler
from legion_tpu_torch.cache.hotness import presample_hotness
from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.data.device_synthetic import synthesize_device_dataset
from legion_tpu_torch.graph import DeviceCSR
from legion_tpu_torch.sampling import access
from legion_tpu_torch.sampling import sampler as smp
from legion_tpu_torch.sampling.sampler import INT32_MAX, NeighborSampler


def _graph(seed=0, V=400, E=6000):
    """Skewed random graph: some long rows (span many blocks), some
    vertices with no edges."""
    rng = np.random.default_rng(seed)
    src = np.minimum((rng.pareto(1.2, E) * 8).astype(np.int64), V - 1)
    src = rng.permutation(V)[src]
    dst = rng.integers(0, V, E)
    g = CSRGraph.from_edges(src, dst, V)
    return g, DeviceCSR.from_numpy(g.indptr, g.indices, "cpu")


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _frontier(g, rng, F):
    deg = g.degrees()
    f = rng.integers(0, g.num_nodes, F).astype(np.int32)
    f[: F // 8] = np.flatnonzero(deg == 0)[0]      # degree-0 slots
    f[F // 8: F // 4] = int(np.argmax(deg))        # the longest row
    f[rng.random(F) < 0.1] = -1                    # pads
    return f


def _jax_draws(ja, g, front, fanout, key, window):
    """JAX's random draws of one ``sample_neighbors`` call, recomputed
    outside the JAX function (the same split/randint calls as
    ``legion_tpu/sampling/access.py:209-227``): r0 [F], off [fanout, F]."""
    F = front.shape[0]
    rp = np.asarray(ja.row_pairs).astype(np.int64)
    pd = rp[np.clip(front, 0, g.num_nodes - 1)]
    start = np.where(front >= 0, pd[:, 0], 0)
    deg = np.where(front >= 0, pd[:, 1], 0)
    k0, k1 = jax.random.split(key)
    r0 = np.asarray(jax.random.randint(k0, (F,), 0, np.maximum(deg, 1),
                                       dtype=jnp.int32))
    base = (start + r0) // window * window
    lo = np.maximum(base, start) - base
    hi = np.minimum(base + window, start + deg) - base
    off = lo[None, :] + np.asarray(jax.random.randint(
        k1, (fanout, F), 0, np.maximum(hi - lo, 1)[None, :],
        dtype=jnp.int32))
    return r0, off


@pytest.mark.parametrize("window,fanout", [(16, 7), (64, 3)])
def test_windowed_select_matches_jax_draws(graph, window, fanout):
    """windowed_select(r0, off) with the r0/off JAX draws (the same
    split/randint calls as access.py:209-227) == JAX sample_neighbors."""
    g, csr = graph
    ja = JWindowed.from_csr(g.to_device(), window)
    pa = access.WindowedCSRAccess.from_csr(csr, window)
    np.testing.assert_array_equal(pa.row_pairs.numpy(),
                                  np.asarray(ja.row_pairs))
    np.testing.assert_array_equal(pa.indices2d.numpy(),
                                  np.asarray(ja.indices2d))
    rng = np.random.default_rng(window)
    F = 256
    front = _frontier(g, rng, F)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(ja.sample_neighbors(jnp.asarray(front), fanout, key))

    r0, off = _jax_draws(ja, g, front, fanout, key, window)
    r0, off = torch.from_numpy(r0.copy()), torch.from_numpy(off)
    out = access.windowed_select(pa.row_pairs, pa.indices2d,
                                 torch.from_numpy(front), r0, off)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    # int64 pair tables (graphs of 2**31 edges or more) select the same
    out64 = access.windowed_select(pa.row_pairs.long(), pa.indices2d,
                                   torch.from_numpy(front), r0, off)
    np.testing.assert_array_equal(out64.numpy(), ref)


def _edge_graph():
    """A graph whose rows have degree 0, degree 1, lie inside one block,
    straddle two blocks or many (windows 4 and 64), and whose edge count
    is no multiple of either window (the last block is padded)."""
    V = 120
    rng = np.random.default_rng(9)
    deg = np.resize([0, 1, 3, 2, 5, 7, 61, 64, 70, 130, 1, 4], V)
    deg[V - 1] = 3
    indptr = np.zeros(V + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, V, int(indptr[-1])).astype(np.int32)
    g = CSRGraph(indptr, indices)
    assert g.num_edges % 64 and g.num_edges % 4
    return g, DeviceCSR.from_numpy(indptr, indices, "cpu")


def _edge_frontier(g, rng, F, window):
    """Pads, ids at and past the number of vertices, and one row of each
    kind first; then random vertices."""
    deg, ip = g.degrees(), g.indptr
    lo_b, hi_b = ip[:-1] // window, (ip[1:] - 1) // window
    special = [np.flatnonzero(deg == 0)[0], np.flatnonzero(deg == 1)[0],
               np.flatnonzero((deg > 1) & (lo_b == hi_b))[0],
               np.flatnonzero((deg > 1) & (hi_b == lo_b + 1))[0],
               np.flatnonzero(hi_b > lo_b + 1)[0], g.num_nodes - 1, -1,
               g.num_nodes, 2 ** 31 - 1]
    f = rng.integers(0, g.num_nodes, F)
    f[rng.random(F) < 0.1] = -1
    f[:len(special)] = special
    return f.astype(np.int32)


def _ref_hash(x):
    """lowbias32 in wrapping uint32 arithmetic."""
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def _ref_bounded(ka, kb, lanes, m):
    """(word * m) >> 32 for the keyed double hash of uint32 lanes."""
    w = _ref_hash(_ref_hash(lanes.astype(np.uint32) ^ np.uint32(ka))
                  ^ np.uint32(kb))
    return ((w.astype(np.uint64) * m.astype(np.uint64))
            >> np.uint64(32)).astype(np.int64)


@pytest.mark.parametrize("window", [4, 64])
@pytest.mark.parametrize("fanout", [1, 25, 33])
def test_windowed_select_matches_jax_at_kernel_edges(fanout, window):
    """windowed_select with JAX's injected r0 and off equals JAX's gather
    (``legion_tpu/sampling/access.py:219-233``) at the fanouts K3 takes in
    one step, several steps and more draws than a step has lanes, on rows
    of every kind, exactly."""
    g, csr = _edge_graph()
    ja = JWindowed.from_csr(g.to_device(), window)
    pa = access.WindowedCSRAccess.from_csr(csr, window)
    rng = np.random.default_rng(100 * fanout + window)
    F = 96
    front = _edge_frontier(g, rng, F, window)
    key = jax.random.PRNGKey(fanout)
    ref = np.asarray(ja.sample_neighbors(jnp.asarray(front), fanout, key))
    r0, off = _jax_draws(ja, g, front, fanout, key, window)
    for pairs in (pa.row_pairs, pa.row_pairs.long()):
        out = access.windowed_select(pairs, pa.indices2d,
                                     torch.from_numpy(front),
                                     torch.from_numpy(r0.copy()),
                                     torch.from_numpy(off))
        np.testing.assert_array_equal(out.numpy(), ref)
    valid = (front >= 0) & (
        g.degrees()[np.clip(front, 0, g.num_nodes - 1)] > 0)
    assert np.all(ref.reshape(fanout, F)[:, ~valid] == -1)
    assert np.all(ref.reshape(fanout, F)[:, valid] >= 0)


@pytest.mark.parametrize("window", [4, 64])
@pytest.mark.parametrize("fanout", [1, 25, 33])
def test_windowed_draw_plain_matches_uint32_reference(fanout, window):
    """windowed_draw_plain equals a NumPy reference of the kernel's own
    arithmetic (uint32 hash words: r0 from stream 0 at lane i, the
    in-block offset from stream 1 at lane f*F + i), exactly, for int32 and
    int64 pairs."""
    g, csr = _edge_graph()
    pa = access.WindowedCSRAccess.from_csr(csr, window)
    rng = np.random.default_rng(200 * fanout + window)
    F, V = 96, g.num_nodes
    front = _edge_frontier(g, rng, F, window)
    key = 0x5DEECE66D + fanout
    ka0, kb0, ka1, kb1 = access.draw_keys(key)
    assert (ka0, kb0) == access.stream_keys(key, 0)
    assert (ka1, kb1) == access.stream_keys(key, 1)
    vc = np.clip(front.astype(np.int64), 0, V - 1)
    start = np.where(front >= 0, g.indptr[vc], 0)
    deg = np.where(front >= 0, g.degrees()[vc], 0)
    i = np.arange(F)
    at = start + _ref_bounded(ka0, kb0, i, np.maximum(deg, 1))
    base = at // window * window
    lo = np.maximum(base, start) - base
    m = np.maximum(np.minimum(base + window, start + deg) - base - lo, 1)
    blocks = pa.indices2d.numpy().reshape(-1)
    lanes = np.arange(fanout * F).reshape(fanout, F)
    pos = (base + lo)[None, :] + _ref_bounded(ka1, kb1, lanes, m[None, :])
    ok = np.broadcast_to((deg > 0)[None, :], pos.shape)
    ref = np.where(ok, blocks[np.where(ok, pos, 0)], -1).reshape(-1)
    for pairs in (pa.row_pairs, pa.row_pairs.long()):
        out = access.windowed_draw_plain(pairs, pa.indices2d,
                                         torch.from_numpy(front), fanout, key)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)


def test_hash_words_match_uint32_reference():
    """The int64 mirror of the kernel's hash (and its Python-int form)
    equals straightforward wrapping uint32 arithmetic."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2 ** 32, 10000, dtype=np.uint64)
    got = access.hash32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _ref_hash(x).astype(np.int64))
    assert [access.hash32(int(v)) for v in x[:50]] == \
        _ref_hash(x[:50]).astype(np.int64).tolist()
    ka, kb = access.stream_keys(123456789, 1)
    lanes = np.arange(1000, dtype=np.uint64)
    words = access.hash_words(ka, kb, torch.from_numpy(lanes.astype(np.int64)))
    expect = _ref_hash(_ref_hash(lanes ^ np.uint64(ka)) ^ np.uint32(kb))
    np.testing.assert_array_equal(words.numpy(), expect.astype(np.int64))


def test_windowed_draw_neighbors_pads_determinism(graph):
    g, csr = graph
    pa = access.WindowedCSRAccess.from_csr(csr, 16)
    rng = np.random.default_rng(6)
    front = _frontier(g, rng, 128)
    ft = torch.from_numpy(front)
    a = pa.sample_neighbors(ft, 5, 99).numpy().reshape(5, 128)
    b = pa.sample_neighbors(ft, 5, 99).numpy().reshape(5, 128)
    c = pa.sample_neighbors(ft, 5, 100).numpy().reshape(5, 128)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    for i, v in enumerate(front):
        nbrs = set(g.neighbors(int(v)).tolist()) if v >= 0 else set()
        if nbrs:
            assert set(a[:, i].tolist()) <= nbrs
        else:
            assert np.all(a[:, i] == -1)


@pytest.mark.parametrize("window", [0, 4])
def test_draw_marginal_is_one_over_degree(graph, window):
    """Per-draw marginal of the hash draws ~ multiplicity/deg, by
    chi-square (windowed, and the per-slot DeviceCSRAccess draws). One
    draw per slot: a slot's windowed draws share one block, so only draws
    of different slots are independent."""
    g, csr = graph
    acc = access.WindowedCSRAccess.from_csr(csr, window) if window \
        else access.DeviceCSRAccess(csr)
    v = int(np.argmax(g.degrees()))
    d = int(g.degrees()[v])
    assert d > 4 * 4                          # spans many 4-blocks
    uniq, mult = np.unique(g.neighbors(v), return_counts=True)
    draws = acc.sample_neighbors(torch.full((20000,), v, dtype=torch.int32),
                                 1, 2024).numpy()
    counts = np.array([(draws == u).sum() for u in uniq])
    assert counts.sum() == draws.size
    _, p = stats.chisquare(counts, draws.size * mult / d)
    assert p > 1e-3, p


def _run_jax(jsampler, jaccess, seeds, key):
    """JAX's batch (one jitted sample), the per-hop frontiers and
    candidates it drew (the same draws, recomputed per hop) and its
    sampler state after the batch."""
    batch, state = jsampler.sample(jaccess, jnp.asarray(seeds),
                                   jsampler.init_state(), key)
    draw = jax.jit(jaccess.sample_neighbors, static_argnums=1)
    ids, cum = np.asarray(batch.node_ids), np.asarray(batch.num_nodes)
    fronts, cands = [], []
    for k in range(jsampler.config.num_hops):
        # hop k saw the slots filled before it (positions < cum[k]); the
        # rest of its frontier window was still -1 then
        off = int(np.asarray(batch.hop_offsets)[k])
        pos = off + np.arange(jsampler.frontier_sizes[k])
        f = np.where(pos < cum[k], ids[pos], -1).astype(np.int32)
        fronts.append(f)
        cands.append(np.array(draw(jnp.asarray(f), jsampler.config.fanouts[k],
                                   jax.random.fold_in(key, k))))
    return batch, fronts, cands, np.asarray(state)


@pytest.mark.parametrize("dedup", ["sort", "map"])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("caps", [None, (24, 40, 100)])
def test_sample_batch_matches_jax(graph, dedup, aligned, caps):
    """Given JAX's per-hop candidates, the port's SampleBatch is identical
    (sort dedup or map dedup; aligned last hop or not; worst-case sizes or
    tight caps that drop the largest new ids, or the last winners in lane
    order); with map dedup the position map is JAX's after the batch, all
    INT32_MAX."""
    g, csr = graph
    kw = dict(fanouts=(5, 3), batch_size=24, dedup=dedup,
              neighbor_window=16, dedup_last_hop=not aligned,
              node_caps=caps)
    js, ps = JSampler(JSamplerConfig(**kw), g.num_nodes), \
        NeighborSampler(SamplerConfig(**kw), g.num_nodes)
    assert ps.ids_len == js.ids_len and ps.state_size == js.state_size
    rng = np.random.default_rng(7)
    seeds = rng.choice(np.flatnonzero(g.degrees() > 0), 24,
                       replace=False).astype(np.int32)
    seeds[-3:] = -1
    jb, fronts, cands, jmap = _run_jax(
        js, JWindowed.from_csr(g.to_device(), 16), seeds,
        jax.random.PRNGKey(3))
    pos_map = ps.init_state("cpu")
    carry = ps.begin(torch.from_numpy(seeds), pos_map)
    for k in range(2):
        np.testing.assert_array_equal(ps.hop_frontier(carry, k).numpy(),
                                      fronts[k])
        carry = ps.hop_absorb(carry, k, torch.from_numpy(cands[k]))
    pb = ps.finish(carry)
    if caps is not None:
        # the tight cap did bind: some new ids were dropped
        assert int(np.asarray(jb.num_nodes)[1]) == caps[1]
    _assert_batches_equal(pb, jb)
    np.testing.assert_array_equal(pos_map.numpy(), jmap)
    assert np.all(jmap == INT32_MAX)


def _assert_batches_equal(pb, jb):
    for name in ("node_ids", "num_nodes", "num_edges", "hop_offsets"):
        got = getattr(pb, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jb, name)), name)
    for k in range(len(jb.edge_src)):
        np.testing.assert_array_equal(pb.edge_src[k].numpy(),
                                      np.asarray(jb.edge_src[k]))
        np.testing.assert_array_equal(pb.edge_dst[k].numpy(),
                                      np.asarray(jb.edge_dst[k]))


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("caps", [None, (24, 40, 100)])
def test_position_map_cleared(graph, aligned, caps):
    """Map dedup through ``sample`` (the port's own draws): the map is all
    INT32_MAX after every batch, with tight caps that drop winners and
    with an aligned last hop, whose lanes never touch it (the counterpart
    of tests/test_sampler.py::test_position_map_cleared); the batch's ids
    are distinct, and a map that is not given raises."""
    g, csr = graph
    ps = NeighborSampler(SamplerConfig(
        fanouts=(5, 3), batch_size=24, neighbor_window=16,
        dedup_last_hop=not aligned, node_caps=caps), g.num_nodes)
    assert not ps.sort_dedup            # map is the default
    acc = access.WindowedCSRAccess.from_csr(csr, 16)
    pos_map = ps.init_state("cpu")
    assert pos_map.shape == (g.num_nodes,)
    rng = np.random.default_rng(8)
    for step in range(3):
        seeds = torch.from_numpy(rng.choice(g.num_nodes, 24, replace=False)
                                 .astype(np.int32))
        b = ps.sample(acc, seeds, 40 + step, pos_map=pos_map)
        assert bool((pos_map == INT32_MAX).all()), step
        deduped = b.node_ids[:ps.cum_caps[1] if aligned else ps.ids_len]
        ids = deduped[deduped >= 0].numpy()
        assert len(np.unique(ids)) == len(ids) > 24
    with pytest.raises(ValueError, match="position map"):
        ps.sample(acc, seeds, 0)


def _edge_case(case, rng, V=5000, B=64, fanout=40):
    """(seeds, candidates, node_caps) of one dedup edge case at hop 0: the
    sorted entries (B + E = 2624) span three 1024-entry tiles."""
    seeds = rng.choice(V, B, replace=False).astype(np.int32)
    seeds[-5:] = -1
    E = B * fanout
    cand = rng.integers(0, V, E).astype(np.int32)
    cand[rng.random(E) < 0.1] = -1
    caps = None
    if case == "one new id in every lane":
        cand[:] = np.setdiff1d(np.arange(V), seeds)[7]
    elif case == "one seed in every lane":
        cand[:] = seeds[3]
    elif case == "a run across a tile":
        cand[rng.permutation(E)[:1500]] = np.setdiff1d(np.arange(V),
                                                        seeds)[11]
    elif case == "all pads":
        cand[:] = -1
    elif case == "a cap that binds mid-run":
        # few distinct ids, long runs; room for 50 of about 100 new ids
        cand = rng.choice(np.arange(0, V, 50), E).astype(np.int32)
        caps = (B, B + 50)
    elif case == "a cap equal to cum":
        seeds[-5:] = rng.choice(np.setdiff1d(np.arange(V), seeds), 5,
                                replace=False)
        caps = (B, B)
    elif case == "below one tile":
        seeds, cand = seeds[:8].copy(), cand[:40].copy()
        seeds[-1] = -1
    return seeds, cand, caps


@pytest.mark.parametrize("dedup", ["sort", "map"])
@pytest.mark.parametrize("case", [
    "random", "one new id in every lane", "one seed in every lane",
    "a run across a tile", "all pads", "a cap that binds mid-run",
    "a cap equal to cum", "below one tile"])
def test_dedup_matches_jax_at_kernel_edges(dedup, case):
    """One deduped hop (K8's plain version after the sort, or K9's plain
    register, hop and clear) against JAX's ``begin`` / ``hop_absorb`` /
    ``finish`` on injected candidates, exactly: ids, counts, edge lists and
    the position map; at the edges of the kernels' tiles and caps."""
    rng = np.random.default_rng(zlib.crc32(f"{dedup} {case}".encode()))
    seeds, cand, caps = _edge_case(case, rng)
    B, V = seeds.shape[0], 5000
    kw = dict(fanouts=(cand.shape[0] // B,), batch_size=B, dedup=dedup,
              node_caps=caps)
    js, ps = JSampler(JSamplerConfig(**kw), V), \
        NeighborSampler(SamplerConfig(**kw), V)
    assert ps.ids_len == js.ids_len
    jc = js.hop_absorb(js.begin(jnp.asarray(seeds), js.init_state()), 0,
                       jnp.asarray(cand))
    jb, jmap = js.finish(jc)
    pos_map = ps.init_state("cpu")
    pc = ps.hop_absorb(ps.begin(torch.from_numpy(seeds), pos_map), 0,
                       torch.from_numpy(cand))
    if dedup == "map":
        np.testing.assert_array_equal(pc["pos_map"].numpy(),
                                      np.asarray(jc["pos_map"]))
    pb = ps.finish(pc)
    _assert_batches_equal(pb, jb)
    np.testing.assert_array_equal(pos_map.numpy(), np.asarray(jmap))
    n = np.asarray(jb.num_nodes)
    if case == "a cap that binds mid-run":
        assert n[1] == B + 50
    if case == "a cap equal to cum":
        assert n[1] == n[0] == B


_EDGE_CASES = ("random", "one new id in every lane", "one seed in every lane",
               "a run across a tile", "all pads", "a cap that binds mid-run",
               "a cap equal to cum", "below one tile")


@pytest.fixture(scope="module")
def jax_map_hops():
    """JAX's map dedup of one hop per edge case, computed once: the map
    after ``begin``'s registration, the carry after ``hop_absorb`` and the
    batch and map after ``finish``'s ClearPosMap."""
    out = {}

    def get(case):
        if case not in out:
            rng = np.random.default_rng(zlib.crc32(f"fused {case}".encode()))
            seeds, cand, caps = _edge_case(case, rng)
            B = seeds.shape[0]
            js = JSampler(JSamplerConfig(
                fanouts=(cand.shape[0] // B,), batch_size=B, dedup="map",
                node_caps=caps), 5000)
            jc0 = js.begin(jnp.asarray(seeds), js.init_state())
            jc1 = js.hop_absorb(jc0, 0, jnp.asarray(cand))
            jb, jmap = js.finish(jc1)
            out[case] = (seeds, cand, caps, np.asarray(jc0["pos_map"]),
                         jc1, jb, np.asarray(jmap))
        return out[case]
    return get


@pytest.mark.parametrize("clear", [True, False])
@pytest.mark.parametrize("register", [True, False])
@pytest.mark.parametrize("case", _EDGE_CASES)
def test_dedup_map_fused_matches_jax(jax_map_hops, case, register, clear):
    """K9's one call (``dedup_map_fused_plain``: the seeds' registration,
    the hop, the clear of the touched ids, each on or off) equals the
    three separate plain calls and JAX's ``begin`` registration,
    ``_dedup_map`` and ``finish``'s ClearPosMap, exactly: src_l, n_new,
    ids and the map (without the registration, the map comes registered;
    without the clear, it is JAX's before ClearPosMap)."""
    seeds, cand, caps, jreg, jc1, jb, jmap = jax_map_hops(case)
    B = seeds.shape[0]
    ps = NeighborSampler(SamplerConfig(
        fanouts=(cand.shape[0] // B,), batch_size=B, dedup="map",
        node_caps=caps), 5000)
    seeds_t, cand_t = torch.from_numpy(seeds), torch.from_numpy(cand)
    carry = ps.begin(seeds_t, ps.init_state("cpu"))
    cap, clear_len = ps.cum_caps[1], ps.touched_len if clear else 0
    outs = []
    for fused in (True, False):
        pos_map, ids = ps.init_state("cpu"), carry["ids"].clone()
        if not register:
            smp.map_register_plain(pos_map, seeds_t)
            np.testing.assert_array_equal(pos_map.numpy(), jreg)
        if fused:
            src, n = smp.dedup_map_fused_plain(
                cand_t, pos_map, carry["cum"], ids, cap,
                seeds_t if register else None, clear_len)
        else:
            if register:
                smp.map_register_plain(pos_map, seeds_t)
            src, n = smp.dedup_map_plain(cand_t, pos_map, carry["cum"], ids,
                                         cap)
            smp.map_clear_plain(pos_map, ids[:clear_len])
        outs.append((src, n, ids, pos_map))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    src, n, ids, pos_map = outs[0]
    np.testing.assert_array_equal(src.numpy(), np.asarray(jc1["edge_src"][0]))
    assert int(n) == int(jc1["cum"]) - int(jc1["num_nodes"][0])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jb.node_ids))
    np.testing.assert_array_equal(
        pos_map.numpy(), jmap if clear else np.asarray(jc1["pos_map"]))
    if clear:
        assert np.all(jmap == INT32_MAX)


class _InjectedAccess:
    """A graph access whose draws are given, hop by hop (JAX's), and that
    checks each frontier it is asked for."""

    def __init__(self, fronts, cands):
        self.fronts, self.cands, self.k = fronts, cands, 0

    def sample_neighbors(self, frontier, fanout, key):
        np.testing.assert_array_equal(frontier.numpy(), self.fronts[self.k])
        self.k += 1
        return torch.from_numpy(self.cands[self.k - 1])


@pytest.mark.parametrize("hops", [1, 2, 3])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("capped", [False, True])
def test_sample_map_dedup_matches_jax(graph, monkeypatch, hops, aligned,
                                      capped):
    """``NeighborSampler.sample`` with map dedup, given JAX's per-hop
    candidates, returns JAX's batch and leaves the map clean, through one
    ``dedup_map`` call a map-deduped hop: the first registers the seeds,
    the last clears the touched ids (all of ids, or those before an
    aligned last hop), and no separate registration or clear runs unless
    no hop dedups (one aligned hop)."""
    g, _ = graph
    fanouts = (5, 3, 2)[:hops]
    caps = (24, 40, 100, 160)[:hops + 1] if capped else None
    kw = dict(fanouts=fanouts, batch_size=24, dedup="map",
              neighbor_window=16, dedup_last_hop=not aligned, node_caps=caps)
    js, ps = JSampler(JSamplerConfig(**kw), g.num_nodes), \
        NeighborSampler(SamplerConfig(**kw), g.num_nodes)
    rng = np.random.default_rng(30 + hops)
    seeds = rng.choice(np.flatnonzero(g.degrees() > 0), 24,
                       replace=False).astype(np.int32)
    seeds[-3:] = -1
    jb, fronts, cands, jmap = _run_jax(
        js, JWindowed.from_csr(g.to_device(), 16), seeds,
        jax.random.PRNGKey(hops))
    calls = {n: [] for n in ("dedup_map_fused", "dedup_map", "map_register",
                             "map_clear")}
    for name in calls:
        def spy(*args, _name=name, _fn=getattr(smp, name), **kwargs):
            calls[_name].append(kwargs)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(smp, name, spy)
    pos_map = ps.init_state("cpu")
    pb = ps.sample(_InjectedAccess(fronts, cands), torch.from_numpy(seeds),
                   0, pos_map=pos_map)
    _assert_batches_equal(pb, jb)
    np.testing.assert_array_equal(pos_map.numpy(), jmap)
    assert bool((pos_map == INT32_MAX).all())
    n_map = hops - 1 if aligned else hops
    assert ps.map_hops == tuple(range(n_map))
    assert len(calls["dedup_map_fused"]) == n_map and not calls["dedup_map"]
    assert len(calls["map_register"]) == len(calls["map_clear"]) == \
        (0 if n_map else 1)
    if n_map:
        fused = calls["dedup_map_fused"]
        assert fused[0]["seeds"] is not None
        assert all(c["seeds"] is None for c in fused[1:])
        assert fused[-1]["clear_len"] == ps.touched_len == (
            ps.cum_caps[hops - 1] if aligned else ps.ids_len)
        assert all(c["clear_len"] == 0 for c in fused[:-1])


@pytest.mark.parametrize("case", ["random", "no prefix", "no candidates",
                                  "all pads", "pads in the prefix"])
def test_dedup_keys_plain_matches_the_sort_keys(case):
    """K8's key build (``dedup_keys_plain``) and ``dedup_sort_keys`` equal
    what ``dedup_sort_keys`` computed before the key kernel (the assigned
    prefix ids[:P] ++ the candidates, INT32_MAX for pads, then one stable
    sort, ``legion_tpu/sampling/sampler.py:250-258``), exactly."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    ids = rng.integers(0, 300, 200).astype(np.int32)
    ids[150:] = -1
    cand = rng.integers(0, 300, 500).astype(np.int32)
    cand[rng.random(500) < 0.1] = -1
    P = 150
    if case == "no prefix":
        P = 0
    elif case == "no candidates":
        cand = cand[:0]
    elif case == "all pads":
        cand[:] = -1
    elif case == "pads in the prefix":
        ids[rng.random(200) < 0.3] = -1
    prefix = ids[:P]
    ref = np.concatenate([np.where(prefix >= 0, prefix, INT32_MAX),
                          np.where(cand >= 0, cand, INT32_MAX)])
    ids_t, cand_t = torch.from_numpy(ids), torch.from_numpy(cand)
    keys = smp.dedup_keys_plain(ids_t, cand_t, P)
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), ref)
    skey, stag = smp.dedup_sort_keys(ids_t, cand_t, P)
    order = np.argsort(ref, kind="stable")
    np.testing.assert_array_equal(skey.numpy(), ref[order])
    np.testing.assert_array_equal(stag.numpy(), order)


def test_synthetic_graph_structure_and_presample():
    """The port's generator: valid CSR (int32 offsets, no self loops,
    in-range ids), the JAX recipe's seed sets, and presample maxima that
    bound every sampled batch."""
    from legion_tpu.data.device_synthetic import synthesize_device_dataset \
        as jax_synth
    V, E = 3000, 40000
    ds = synthesize_device_dataset("cpu", num_nodes=V, num_edges=E,
                                   feature_dim=20, num_classes=4,
                                   batch_size=32, valid_size=100,
                                   test_size=100, seed=3)
    jds = jax_synth(num_nodes=V, num_edges=E, feature_dim=20, num_classes=4,
                    batch_size=32, valid_size=100, test_size=100, seed=3)
    csr = ds.csr
    ip, ix = csr.indptr.numpy(), csr.indices.numpy()
    assert csr.indptr.dtype == torch.int32 and ix.dtype == np.int32
    assert ip[0] == 0 and ip[-1] == E and np.all(np.diff(ip) >= 0)
    assert ix.min() >= 0 and ix.max() < V
    src = np.repeat(np.arange(V), np.diff(ip))
    assert not np.any(src == ix)
    # power-law skew: the top 1% of vertices hold a large in-edge share
    top = np.sort(np.bincount(ix, minlength=V))[::-1][: V // 100].sum()
    assert top > 0.15 * E
    np.testing.assert_array_equal(ds.labels.numpy(), np.asarray(jds.labels))
    for name in ("train_ids", "valid_ids", "test_ids"):
        np.testing.assert_array_equal(getattr(ds, name),
                                      np.asarray(getattr(jds, name)))
    assert asdict(ds.meta) == asdict(jds.meta)

    scfg = SamplerConfig(fanouts=(5, 3), batch_size=32, dedup="sort",
                         neighbor_window=16, dedup_last_hop=False)
    sampler = NeighborSampler(scfg, V)
    acc = access.WindowedCSRAccess.from_csr(csr, 16)
    bank = torch.from_numpy(ds.train_ids[:4 * 32].copy())
    na, ea, mx = presample_hotness(sampler, acc, bank, 4, 17)
    nums = np.stack([sampler.sample(acc, bank[i * 32:(i + 1) * 32],
                                    access.fold_in(17, i)).num_nodes.numpy()
                     for i in range(4)])
    np.testing.assert_array_equal(mx.numpy(), nums.max(axis=0))
    assert int(ea.sum()) > 0 and int(na.sum()) >= int(nums[:, -1].sum())
