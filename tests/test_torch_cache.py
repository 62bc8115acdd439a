"""The port's host-resident storage against the JAX package, on the CPU:
the cost model, the cache FillUp, the cached feature fetch (K4's plain
version), the cached topology draws (K5's plain version) and the hit
counters. Host tables are numpy arrays shared by both packages; on the CPU
the kernels' wrappers run their plain versions, and a wrapper given a
non-CPU tensor and an unregistered host table raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from legion_tpu.cache.cost_model import CostModelResult as JPlan
from legion_tpu.cache.cost_model import plan_cache as jax_plan_cache
from legion_tpu.cache.unified_cache import CachedFeatureSource as JCached
from legion_tpu.cache.unified_cache import UnifiedCache as JCache
from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.data import synthesize_dataset as jax_synth
from legion_tpu.data import write_legion_dataset as jax_write
from legion_tpu.data.format import LegionDataset as JLegionDataset
from legion_tpu.graph import DeviceCSR as JDeviceCSR
from legion_tpu.sampling.access import CachedTopoAccess as JTopo
from legion_tpu.sampling.access import DeviceCSRAccess as JDeviceAccess
from legion_tpu.sampling.sampler import NeighborSampler as JSampler
from legion_tpu.train import Trainer as JTrainer
from legion_tpu_torch.cache.cost_model import CostModelResult, plan_cache
from legion_tpu_torch.cache.unified_cache import (CachedFeatureSource,
                                                  DeviceFeatureSource,
                                                  UnifiedCache,
                                                  cached_gather,
                                                  cached_gather_plain,
                                                  sort_ids)
from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import (LegionDataset, infer_meta,
                                   synthesize_dataset, write_legion_dataset)
from legion_tpu_torch.graph import DeviceCSR
from legion_tpu_torch.ops import host_memory
from legion_tpu_torch.ops.host_memory import HostTable, bf16_pitch, bf16_rows
from legion_tpu_torch.sampling import access
from legion_tpu_torch.sampling.access import CachedTopoAccess, DeviceCSRAccess
from legion_tpu_torch.sampling.sampler import NeighborSampler
from legion_tpu_torch.train import Trainer
from legion_tpu_torch.utils.convert import batch_from_jax, cache_from_jax

V = 1500


@pytest.fixture(scope="module")
def jds():
    return jax_synth(num_nodes=V, avg_degree=12, feature_dim=100,
                     num_classes=8, batch_size=64, seed=3)


def _plan(jds, feat_cap, topo_cap, seed=0):
    """The same hand-made plan for both packages: hot-first orders (by
    in-degree and out-degree, ties broken by a seeded permutation)."""
    rng = np.random.default_rng(seed)
    indeg = np.bincount(jds.graph.indices, minlength=V)
    qf = np.lexsort((rng.permutation(V), -indeg))
    qt = np.lexsort((rng.permutation(V), -jds.graph.degrees()))
    kw = dict(feature_capacity=feat_cap, topo_capacity=topo_cap, alpha=0.5,
              feature_order=qf, topo_order=qt, est_feat_saved_bytes=0.0,
              est_topo_saved_bytes=0.0)
    return JPlan(**kw), CostModelResult(**kw)


def _hotness(seed):
    rng = np.random.default_rng(seed)
    na = rng.poisson(3.0, V).astype(np.int32) * (rng.random(V) < 0.7)
    ea = rng.poisson(1.0, V).astype(np.int32) * (rng.random(V) < 0.4)
    na[rng.integers(0, V, 20)] = 40         # hot vertices, ties among them
    return na.astype(np.int32), ea.astype(np.int32)


@pytest.mark.parametrize("budget", [30_000, 200_000, 50_000_000])
@pytest.mark.parametrize("bpf", [2, 4])
@pytest.mark.parametrize("zero_ea", [False, True])
def test_plan_cache_matches_jax(jds, budget, bpf, zero_ea):
    """Same hotness and degrees: identical capacities, alpha, orders and
    estimated savings (numpy and torch inputs alike)."""
    na, ea = _hotness(budget + bpf)
    if zero_ea:
        ea = np.zeros_like(ea)
    deg = jds.graph.degrees().astype(np.int32)
    ref = jax_plan_cache(jnp.asarray(na), jnp.asarray(ea), jnp.asarray(deg),
                         budget, 100, bytes_per_feat=bpf)
    for args in ((na, ea, deg), tuple(map(torch.from_numpy, (na, ea, deg)))):
        got = plan_cache(*args, budget, 100, bytes_per_feat=bpf)
        assert (got.feature_capacity, got.topo_capacity, got.alpha) == \
            (ref.feature_capacity, ref.topo_capacity, ref.alpha)
        np.testing.assert_array_equal(got.feature_order, ref.feature_order)
        np.testing.assert_array_equal(got.topo_order, ref.topo_order)
        assert got.est_feat_saved_bytes == ref.est_feat_saved_bytes
        assert got.est_topo_saved_bytes == ref.est_topo_saved_bytes
    if zero_ea:
        assert ref.topo_capacity == 0 or ref.est_topo_saved_bytes == 0


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
def test_build_from_host_matches_jax(jds, feat_dtype):
    jplan, plan = _plan(jds, 400, 300)
    g = jds.graph
    jc = JCache.build_from_host(jplan, jds.features, g.indptr, g.indices, V,
                                feat_dtype=feat_dtype)
    pc = UnifiedCache.build_from_host(plan, jds.features, g.indptr,
                                      g.indices, V, feat_dtype=feat_dtype)
    for name in ("cache_rows", "slot_map", "sub_indptr", "sub_indices",
                 "row_map"):
        got, ref = getattr(pc, name), getattr(jc, name)
        np.testing.assert_array_equal(_bits(got), _bits(ref), name)
    assert pc.cache_rows.dtype == (torch.bfloat16 if feat_dtype == "bfloat16"
                                   else torch.float32)
    assert pc.sub_indptr.dtype == torch.int64
    assert (pc.feature_capacity, pc.topo_capacity) == (400, 300)
    # the bf16 cache rounds to nearest even, as torch's cast does
    if feat_dtype == "bfloat16":
        qf = plan.feature_order[:400]
        np.testing.assert_array_equal(
            _bits(pc.cache_rows),
            _bits(torch.from_numpy(jds.features[qf]).to(torch.bfloat16)))


def _csr_with_empty_rows():
    """A CSRGraph of 8 vertices whose rows 1, 4 and 6 are empty."""
    from legion_tpu.graph import CSRGraph as JCSRGraph
    src = np.array([0, 0, 2, 3, 3, 3, 5, 7, 7], np.int64)
    dst = np.array([1, 4, 6, 0, 2, 5, 3, 0, 6], np.int64)
    return JCSRGraph.from_edges(src, dst, 8)


@pytest.mark.parametrize("case", ["features", "topology", "both", "none",
                                  "empty_rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_matches_jax_and_build_from_host(jds, case, dtype):
    """``UnifiedCache.build`` from device tensors (here CPU tensors: K1's
    plain version) against JAX's ``build`` on the same plan, bit for bit:
    features only, topology only, both, capacity 0, and a hot set whose
    rows are all empty (JAX's edge budget max(degrees, 1) gives
    ``sub_indices == [-1]``), with f32 and bf16 features. Where the hot
    rows have edges it also equals ``build_from_host`` (whose bf16 cache
    rounds the f32 rows as a cast to bf16 does)."""
    g, feats = jds.graph, jds.features
    caps = {"features": (400, 0), "topology": (0, 300), "both": (400, 300),
            "none": (0, 0), "empty_rows": (3, 3)}[case]
    if case == "empty_rows":
        g = _csr_with_empty_rows()
        feats = np.random.default_rng(1).standard_normal(
            (8, 5)).astype(np.float32)
        order = np.array([1, 4, 6, 0, 2, 3, 5, 7])
        kw = dict(feature_capacity=3, topo_capacity=3, alpha=0.5,
                  feature_order=order, topo_order=order,
                  est_feat_saved_bytes=0.0, est_topo_saved_bytes=0.0)
        jplan, plan = JPlan(**kw), CostModelResult(**kw)
    else:
        jplan, plan = _plan(jds, *caps)
    jf = jnp.asarray(feats).astype(jnp.bfloat16 if dtype == "bfloat16"
                                   else jnp.float32)
    tf = torch.from_numpy(feats).to(torch.bfloat16 if dtype == "bfloat16"
                                    else torch.float32)
    jc = JCache.build(jplan, jf, g.to_device())
    pc = UnifiedCache.build(plan, tf, DeviceCSR.from_numpy(
        g.indptr, g.indices, "cpu"))
    names = ("cache_rows", "slot_map", "sub_indptr", "sub_indices",
             "row_map")
    for name in names:
        got, ref = getattr(pc, name), getattr(jc, name)
        assert (got is None) == (ref is None), name
        if got is not None:
            np.testing.assert_array_equal(_bits(got), _bits(ref), name)
    assert (pc.feature_capacity, pc.topo_capacity) == caps
    if caps[0]:
        assert pc.cache_rows.dtype == tf.dtype
    if caps[1]:
        assert pc.sub_indptr.dtype == torch.int64
        assert pc.sub_indices.dtype == torch.int32
    if case == "empty_rows":
        np.testing.assert_array_equal(pc.sub_indices.numpy(), [-1])
        np.testing.assert_array_equal(pc.sub_indptr.numpy(), [0, 0, 0, 0])
        return
    hc = UnifiedCache.build_from_host(plan, feats, g.indptr, g.indices, V,
                                      feat_dtype=dtype)
    for name in names:
        got, ref = getattr(pc, name), getattr(hc, name)
        if got is not None:
            np.testing.assert_array_equal(_bits(got), _bits(ref), name)


def _ids(jds, plan, rng, n=700):
    """Hot (cached), cold and pad ids."""
    hot = plan.feature_order[:plan.feature_capacity]
    cold = plan.feature_order[plan.feature_capacity:]
    ids = np.concatenate([rng.choice(hot, n // 2), rng.choice(cold, n // 2),
                          np.full(n - 2 * (n // 2), -1)]).astype(np.int32)
    ids[rng.random(n) < 0.1] = -1
    return rng.permutation(ids).astype(np.int32)


def host_rows_table(features, table):
    """A fetch's host table: the f32 features ("f32"), or their bf16 rows
    ("bf16"), padded by ``+k`` columns ("bf16+28": the trainer's pitch of
    128 for 100 columns, ``bf16_pitch``)."""
    if table == "f32":
        return HostTable(features, pin=False)
    pad = int(table.partition("+")[2] or 0)
    return HostTable(bf16_rows(features, features.shape[1] + pad),
                     pin=False)


# (cache dtype, host table): an f32 cache reads f32 rows; a bf16 cache
# reads the f32 rows and rounds them, or the bf16 rows the trainer builds
FETCH_TABLES = [("float32", "f32"), ("bfloat16", "f32"),
                ("bfloat16", "bf16"), ("bfloat16", "bf16+28")]


@pytest.mark.parametrize("feat_dtype,table", FETCH_TABLES)
def test_cached_fetch_matches_jax(jds, feat_dtype, table):
    """The port's CachedFeatureSource.fetch (K4's plain version) against
    JAX's, jitted with its pure_callback, over each host table the cache
    may read: the same rows and hit count, and the same rows as
    DeviceFeatureSource on the cast table."""
    jplan, plan = _plan(jds, 500, 0)
    jc = JCache.build_from_host(jplan, jds.features, None, None, V,
                                feat_dtype=feat_dtype)
    ids = _ids(jds, plan, np.random.default_rng(1))
    xj, hj = jax.jit(lambda c, i: JCached(c, jds.features).fetch(i))(
        jc, jnp.asarray(ids))
    src = CachedFeatureSource(cache_from_jax(jc),
                              host_rows_table(jds.features, table))
    xp, hp = src.fetch(torch.from_numpy(ids))
    np.testing.assert_array_equal(_bits(xp), _bits(xj))
    assert hp.dtype == torch.int32 and int(hp) == int(hj)
    hot = set(plan.feature_order[:500].tolist())
    assert 0 < int(hp) == sum(int(i) in hot for i in ids if i >= 0) \
        < int((ids >= 0).sum())
    table = torch.from_numpy(jds.features)
    if feat_dtype == "bfloat16":
        table = table.to(torch.bfloat16)
    xd, _ = DeviceFeatureSource(table).fetch(torch.from_numpy(ids))
    np.testing.assert_array_equal(_bits(xp), _bits(xd))


def _edge_ids(plan, cap, rng, pattern):
    """K4's id patterns: duplicates, pads, the table's first and last rows
    (kept out of the cache by ``_edge_plan``); all hits; all misses."""
    hot = plan.feature_order[:cap]
    cold = plan.feature_order[cap:]
    if pattern == "all hits":
        ids = rng.choice(hot, 257)
    elif pattern == "all misses":
        ids = np.concatenate([[0, V - 1], rng.choice(cold, 94)])
    else:
        ids = np.concatenate([rng.choice(hot, 400), rng.choice(cold, 400),
                              rng.choice(cold, 100), [0, V - 1, 0],
                              np.full(100, -1)])
        ids = rng.permutation(ids)
    return ids.astype(np.int32)


def _edge_plan(jds, cap):
    """``_plan`` with rows 0 and V-1 moved to the cold end, so that they
    miss."""
    jplan, plan = _plan(jds, cap, 0)
    order = np.asarray(plan.feature_order)
    order = np.concatenate([order[~np.isin(order, [0, V - 1])], [0, V - 1]])
    kw = dict(feature_capacity=cap, topo_capacity=0, alpha=0.5,
              feature_order=order, topo_order=plan.topo_order,
              est_feat_saved_bytes=0.0, est_topo_saved_bytes=0.0)
    return JPlan(**kw), CostModelResult(**kw)


@pytest.mark.parametrize("pattern", ["mixed", "all hits", "all misses"])
@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [1, 100, 128, 602])
def test_cached_fetch_matches_jax_at_kernel_edges(jds, width, feat_dtype,
                                                  pattern):
    """K4's plain version against JAX's fetch at the widths, cache dtypes
    and id patterns that ``chip_smoke.py`` holds the kernel to on the card
    (chunked and float-a-lane host reads; 16-, 8-, 4- and 2-byte cache
    words): the same rows bit for bit and the same hit count."""
    rng = np.random.default_rng(width)
    feats = rng.standard_normal((V, width)).astype(np.float32)
    jplan, plan = _edge_plan(jds, 500)
    jc = JCache.build_from_host(jplan, feats, None, None, V,
                                feat_dtype=feat_dtype)
    ids = _edge_ids(plan, 500, rng, pattern)
    xj, hj = JCached(jc, feats).fetch(jnp.asarray(ids))
    xp, hp = cached_gather(cache_from_jax(jc), HostTable(feats, pin=False),
                           torch.from_numpy(ids))
    np.testing.assert_array_equal(_bits(xp), _bits(xj))
    assert int(hp) == int(hj)
    n_valid = int((ids >= 0).sum())
    assert int(hp) == {"all hits": n_valid, "all misses": 0}.get(
        pattern, int(hp))
    if pattern == "mixed":
        assert 0 < int(hp) < n_valid


@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
def test_cached_gather_plain_past_the_tables_and_empty(jds, feat_dtype):
    """Where JAX's fetch is not defined the plain version is the kernel's
    contract: an id past the host table misses into a zero row, an id past
    the slot map takes the map's last entry, and no ids give no rows."""
    rng = np.random.default_rng(11)
    rows_h = V - 200                         # the host table ends early
    feats = rng.standard_normal((rows_h, 100)).astype(np.float32)
    _, plan = _edge_plan(jds, 300)
    hot = plan.feature_order[:300]
    hot = hot[hot < rows_h]
    c = UnifiedCache.build_from_host(
        CostModelResult(len(hot), 0, 0.5, hot, plan.topo_order, 0.0, 0.0),
        feats, None, None, V, feat_dtype=feat_dtype)
    c.slot_map[V - 1] = 0                    # ids past the map clamp to a hit
    cold = int(next(v for v in plan.feature_order[300:] if v < rows_h))
    ids = torch.tensor([cold, rows_h, V - 2, V - 1, V + 5, 2**31 - 1, -1,
                        int(hot[3])], dtype=torch.int32)
    x, h = cached_gather_plain(c, torch.from_numpy(feats), ids)
    dt = c.cache_rows.dtype
    assert int(h) == 4 and x.dtype == dt
    assert torch.equal(x[0], torch.from_numpy(feats[cold]).to(dt))
    assert not x[1].any() and not x[2].any() and not x[6].any()
    for i in (3, 4, 5):
        assert torch.equal(x[i], c.cache_rows[0])
    assert torch.equal(x[7], c.cache_rows[3])
    x0, h0 = cached_gather(c, HostTable(feats, pin=False),
                           torch.zeros(0, dtype=torch.int32))
    assert x0.shape == (0, 100) and x0.dtype == dt and int(h0) == 0


@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
def test_sorted_order_places_rows_like_plain(jds, feat_dtype):
    """The torch-side step of K4's wrapper: the kernel gathers the sorted
    ids and writes the row of ``sorted_ids[j]`` to ``out[order[j]]``. With
    the plain gather in the kernel's place that equals the plain version
    on the ids as given, duplicates and pads included."""
    rng = np.random.default_rng(12)
    _, plan = _edge_plan(jds, 400)
    c = UnifiedCache.build_from_host(plan, jds.features, None, None, V,
                                     feat_dtype=feat_dtype)
    host = torch.from_numpy(jds.features)
    ids = torch.from_numpy(_edge_ids(plan, 400, rng, "mixed"))
    sorted_ids, order = sort_ids(ids)
    assert torch.equal(ids[order], sorted_ids)
    assert bool((sorted_ids[1:] >= sorted_ids[:-1]).all())
    assert torch.equal(order.sort().values, torch.arange(ids.shape[0]))
    rows, hits = cached_gather_plain(c, host, sorted_ids)
    out = torch.empty_like(rows)
    out[order] = rows
    ref, ref_hits = cached_gather_plain(c, host, ids)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert int(hits) == int(ref_hits)


@pytest.fixture(scope="module")
def topo(jds):
    """A partial topology cache (the 300 highest-degree rows), in both
    packages, over the same host CSR."""
    jplan, plan = _plan(jds, 0, 300)
    g = jds.graph
    jc = JCache.build_from_host(jplan, None, g.indptr, g.indices, V)
    pc = cache_from_jax(jc)
    host = (HostTable(g.indptr, pin=False), HostTable(g.indices, pin=False))
    pa = CachedTopoAccess(pc.row_map, pc.sub_indptr, pc.sub_indices, *host)
    ja = JTopo(jc.row_map, jc.sub_indptr, jc.sub_indices, g.indptr,
               g.indices)
    return ja, pa, plan


def _frontier(jds, rng, F):
    f = rng.integers(0, V, F).astype(np.int32)
    f[rng.random(F) < 0.1] = -1
    f[:8] = np.argmax(jds.graph.degrees())       # a cached long row
    f[8:16] = np.flatnonzero(jds.graph.degrees() == 0)[:1] \
        if (jds.graph.degrees() == 0).any() else -1
    return f


def test_cached_topo_hit_lanes_match_jax(jds, topo):
    """JAX's lookup draws r, recomputed with the same key, fed to
    csr_select: the hit lanes equal JAX's CachedTopoAccess lanes."""
    ja, pa, _ = topo
    fanout, F = 5, 400
    front = _frontier(jds, np.random.default_rng(2), F)
    key = jax.random.PRNGKey(9)
    lanes, hit = ja.lookup(jnp.asarray(front), fanout, key)
    full = np.asarray(ja.sample_neighbors(jnp.asarray(front), fanout, key))
    lanes, hit = np.asarray(lanes), np.asarray(hit)
    assert 0 < hit.sum() < (front >= 0).sum()
    rm, sip = np.asarray(ja.row_map), np.asarray(ja.sub_indptr)
    row = np.where(front >= 0, rm[np.clip(front, 0, V - 1)], -1)
    rowc = np.clip(row, 0, sip.shape[0] - 2)
    deg = np.where(row >= 0, sip[rowc + 1] - sip[rowc], 0).astype(np.int32)
    r = np.array(jax.random.randint(
        key, (fanout, F), 0, jnp.asarray(np.maximum(deg, 1))[None, :],
        dtype=jnp.int32))
    got = access.csr_select(torch.from_numpy(front), torch.from_numpy(r),
                            pa.host_indptr.host, pa.host_indices.host,
                            pa.row_map, pa.sub_indptr, pa.sub_indices)
    assert got.dtype == torch.int32
    m = np.tile(hit, fanout)
    np.testing.assert_array_equal(got.numpy()[m], lanes[m])
    np.testing.assert_array_equal(full[m], lanes[m])


@pytest.fixture(scope="module")
def edge_csr():
    """The graph ``chip_smoke.py`` holds K5 to at its edges: degrees 0, 1,
    2, either side of a 128-byte line of neighbour ids (31 to 33, 63 to
    65, 127 to 129), one row of 70,000, first and last rows with
    neighbours; a third of the rows cached, in both packages."""
    rng = np.random.default_rng(8)
    Ve = 600
    deg = np.resize([0, 1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129], Ve)
    deg[[0, Ve - 1]] = 5, 7
    deg[300] = 70_000
    indptr = np.zeros(Ve + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, Ve, int(indptr[-1])).astype(np.int32)
    hot = np.sort(np.concatenate([[300], rng.permutation(Ve)[:200]]))
    kw = dict(feature_capacity=0, topo_capacity=len(np.unique(hot)),
              alpha=0.5, feature_order=np.arange(Ve),
              topo_order=np.concatenate([np.unique(hot), np.setdiff1d(
                  np.arange(Ve), hot)]),
              est_feat_saved_bytes=0.0, est_topo_saved_bytes=0.0)
    jc = JCache.build_from_host(JPlan(**kw), None, indptr, indices, Ve)
    return indptr, indices, jc


@pytest.mark.parametrize("offsets", ["int32", "int64"])
@pytest.mark.parametrize("fanout", [1, 10, 16, 17, 25, 32, 33, 64])
def test_csr_select_matches_jax_at_kernel_edges(edge_csr, fanout, offsets):
    """K5's plain version at the fanouts (lane groups of 1 to 32 on the
    card, and more draws than a group has lanes), degrees and offset types
    that ``chip_smoke.py`` holds the kernel to: JAX's in-row offsets,
    recomputed with the same key, fed to ``csr_select``, give JAX's
    ``DeviceCSRAccess`` draws on the full CSR and ``CachedTopoAccess.
    lookup``'s lanes on the cached rows, exactly."""
    indptr, indices, jc = edge_csr
    Ve, F = indptr.shape[0] - 1, 96
    rng = np.random.default_rng(fanout)
    front = rng.integers(0, Ve, F).astype(np.int32)
    front[rng.random(F) < 0.1] = -1
    front[:16] = np.arange(16)                   # every edge degree
    front[16:20] = (Ve - 1, 0, 300, -1)
    key = jax.random.PRNGKey(fanout)
    odt = np.int32 if offsets == "int32" else np.int64
    jcsr = JDeviceCSR(jnp.asarray(indptr.astype(odt)), jnp.asarray(indices),
                      Ve, int(indptr[-1]))
    assert jcsr.indptr.dtype == odt

    def offsets_for(deg):
        return np.array(jax.random.randint(
            key, (fanout, F), 0,
            jnp.asarray(np.maximum(deg, 1).astype(np.int32))[None, :],
            dtype=jnp.int32))

    safe = np.clip(front, 0, Ve - 1)
    deg = np.where(front >= 0, indptr[safe + 1] - indptr[safe], 0)
    tabs = (torch.from_numpy(indptr.astype(odt)), torch.from_numpy(indices))
    ft = torch.from_numpy(front)
    full = np.asarray(JDeviceAccess(jcsr).sample_neighbors(
        jnp.asarray(front), fanout, key))
    got = access.csr_select(ft, torch.from_numpy(offsets_for(deg)), *tabs)
    assert got.dtype == torch.int32 and got.shape == (fanout * F,)
    np.testing.assert_array_equal(got.numpy(), full)
    assert np.all(got.numpy().reshape(fanout, F)[:, deg == 0] == -1)
    # the cached rows: JAX draws within the cached row's degree
    ja = JTopo(jc.row_map, jc.sub_indptr, jc.sub_indices, indptr, indices)
    lanes, hit = ja.lookup(jnp.asarray(front), fanout, key)
    lanes, hit = np.asarray(lanes), np.asarray(hit)
    assert 0 < hit.sum() < (front >= 0).sum()
    pc = cache_from_jax(jc)
    got = access.csr_select(ft, torch.from_numpy(
        offsets_for(np.where(hit, deg, 0))), *tabs, pc.row_map,
        pc.sub_indptr, pc.sub_indices)
    m = np.tile(hit, fanout)
    np.testing.assert_array_equal(got.numpy()[m], lanes[m])


def test_cached_topo_miss_lanes_are_uniform_neighbours(jds, topo):
    """Every miss lane is a true neighbour of its slot, and the per-draw
    marginal over an uncached row is multiplicity/deg (chi-square)."""
    _, pa, plan = topo
    g = jds.graph
    front = _frontier(jds, np.random.default_rng(3), 300)
    out = pa.sample_neighbors(torch.from_numpy(front), 4, 77).numpy()
    out = out.reshape(4, -1)
    rm = pa.row_map.numpy()
    n_miss = 0
    for i, v in enumerate(front):
        if v < 0 or g.degrees()[v] == 0:
            assert np.all(out[:, i] == -1)
            continue
        n_miss += rm[v] < 0
        assert set(out[:, i].tolist()) <= set(g.neighbors(int(v)).tolist())
    assert n_miss > 0
    cached = set(plan.topo_order[:300].tolist())
    v = max((u for u in range(V) if u not in cached),
            key=lambda u: g.degrees()[u])
    d = int(g.degrees()[v])
    assert rm[v] < 0 and d >= 8
    uniq, mult = np.unique(g.neighbors(v), return_counts=True)
    draws = pa.sample_neighbors(torch.full((20000,), v, dtype=torch.int32),
                                1, 2025).numpy()
    counts = np.array([(draws == u).sum() for u in uniq])
    assert counts.sum() == draws.size
    _, p = stats.chisquare(counts, draws.size * mult / d)
    assert p > 1e-3, p


@pytest.mark.parametrize("cap", [0, 300, V])
def test_cached_topo_equals_device_csr_access(jds, cap):
    """A cached row is a copy of its host row and draws with the same
    words: CachedTopoAccess equals DeviceCSRAccess bit for bit, for an
    empty, a partial and a full cache."""
    g = jds.graph
    _, plan = _plan(jds, 0, cap)
    c = UnifiedCache.build_from_host(plan, None, g.indptr, g.indices, V)
    host = (HostTable(g.indptr, pin=False), HostTable(g.indices, pin=False))
    pa = CachedTopoAccess(c.row_map, c.sub_indptr, c.sub_indices, *host) \
        if cap else CachedTopoAccess.all_miss(*host, "cpu")
    da = DeviceCSRAccess(DeviceCSR.from_numpy(g.indptr, g.indices, "cpu"))
    front = torch.from_numpy(_frontier(jds, np.random.default_rng(4), 500))
    for fanout, key in ((25, 5), (10, 6)):
        np.testing.assert_array_equal(
            pa.sample_neighbors(front, fanout, key).numpy(),
            da.sample_neighbors(front, fanout, key).numpy())


def test_hit_counters_match_jax(jds, topo):
    """For the same batch (JAX's, sampled through its CachedTopoAccess)
    and cache, the port's topology-hit counter equals JAX's
    _topo_hit_count, and the fetch's hit count equals JAX's."""
    ja, pa, _ = topo
    kw = dict(fanouts=(5, 3), batch_size=32, dedup="sort",
              dedup_last_hop=False, node_caps=(32, 128, 0))
    js = JSampler(JSamplerConfig(**kw), V)
    ps = NeighborSampler(SamplerConfig(**kw), V)
    seeds = np.asarray(jds.train_ids[:32], np.int32)
    jb, _ = jax.jit(js.sample)(ja, jnp.asarray(seeds), js.init_state(),
                               jax.random.PRNGKey(5))
    th, tt = JTrainer._topo_hit_count(None, jb, ja, js)
    ph, pt = Trainer._topo_hit_count(None, batch_from_jax(jb), pa, ps)
    assert (int(ph), int(pt)) == (int(th), int(tt)) and 0 < int(ph) < int(pt)
    # and with no topology cache every adjacency read is device-resident
    dh, dt = Trainer._topo_hit_count(None, batch_from_jax(jb), object(), ps)
    assert int(dh) == int(dt) == int(tt)
    jplan, _ = _plan(jds, 300, 0)
    jc = JCache.build_from_host(jplan, jds.features, None, None, V)
    nid = jb.node_ids[:js.max_ids]
    _, jh = JCached(jc, jds.features).fetch(nid)
    _, ph = CachedFeatureSource(
        cache_from_jax(jc), HostTable(jds.features, pin=False)).fetch(
            torch.from_numpy(np.array(nid, np.int32)))
    assert int(ph) == int(jh)


def test_no_fallback_for_unregistered_host_tables(jds, topo):
    """A kernel wrapper given a non-CPU tensor reads host tables only
    through a registered device view; an unregistered table raises
    before any launch. Non-contiguous arrays are refused."""
    _, pa, _ = topo
    jplan, _ = _plan(jds, 100, 0)
    cache = cache_from_jax(JCache.build_from_host(
        jplan, jds.features, None, None, V))
    ids = torch.zeros((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not registered"):
        cached_gather(cache, HostTable(jds.features, pin=False), ids)
    with pytest.raises(ValueError, match="not registered"):
        pa.sample_neighbors(ids, 3, 1)
    with pytest.raises(ValueError, match="C-contiguous"):
        HostTable(jds.features[:, :50], pin=False)


def test_registered_ranges_are_shared_and_counted(monkeypatch):
    """Registration covers exact byte ranges, each once: a table that
    overlaps a registered range registers only its new bytes; each range
    is unregistered with its last reference. (The CUDA calls are
    recorded, not made.)"""
    calls = []
    monkeypatch.setattr(host_memory, "_PINNED", {})
    monkeypatch.setattr(host_memory, "_register",
                        lambda lo, hi: calls.append(("reg", lo, hi)))
    monkeypatch.setattr(host_memory, "_unregister",
                        lambda lo: calls.append(("unreg", lo)))
    a = host_memory.pin_range(1000, 500)      # [1000, 1500)
    b = host_memory.pin_range(1200, 600)      # [1200, 1800)
    c = host_memory.pin_range(1100, 10)       # inside a
    d = host_memory.pin_range(1800, 4)        # adjacent, not shared
    assert calls == [("reg", 1000, 1500), ("reg", 1500, 1800),
                     ("reg", 1800, 1804)]
    assert a == c == [1000] and b == [1000, 1500] and d == [1800]
    host_memory.unpin_ranges(a)
    host_memory.unpin_ranges(c)
    host_memory.unpin_ranges(d)
    assert calls[3:] == [("unreg", 1800)]
    host_memory.unpin_ranges(b)
    assert calls[4:] == [("unreg", 1000), ("unreg", 1500)]
    assert host_memory._PINNED == {}


def test_host_dataset_files_and_generator_match_jax(jds, tmp_path):
    """The copied generator gives the JAX generator's arrays for a seed;
    the copied writer/loader round-trips them as read-only memmaps that
    the JAX loader reads the same; a cached trainer reads a RAM copy of
    them."""
    ds = synthesize_dataset(num_nodes=V, avg_degree=12, feature_dim=100,
                            num_classes=8, batch_size=64, seed=3)
    for name in ("features", "labels", "train_ids", "valid_ids",
                 "test_ids"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name))
    np.testing.assert_array_equal(ds.graph.indptr, jds.graph.indptr)
    np.testing.assert_array_equal(ds.graph.indices, jds.graph.indices)
    write_legion_dataset(str(tmp_path / "p"), ds.graph, ds.features,
                         ds.labels, ds.train_ids, ds.valid_ids, ds.test_ids)
    jax_write(str(tmp_path / "j"), jds.graph, jds.features, jds.labels,
              jds.train_ids, jds.valid_ids, jds.test_ids)
    for d in ("p", "j"):
        for f in ("edge_src", "edge_dst", "features", "labels"):
            assert (tmp_path / "p" / f).read_bytes() == \
                (tmp_path / d / f).read_bytes()
    meta = infer_meta(str(tmp_path / "p"), batch_size=64)
    loaded = LegionDataset.load(meta)
    jl = JLegionDataset.load(meta)
    assert meta.num_nodes == V and meta.num_classes == 8
    assert not loaded.features.flags.writeable
    np.testing.assert_array_equal(loaded.features, jl.features)
    np.testing.assert_array_equal(loaded.graph.indices, jl.graph.indices)
    np.testing.assert_array_equal(
        loaded.seeds_for_partition("valid", 0, 1), jds.valid_ids)
    t = HostTable(np.ascontiguousarray(loaded.features, np.float32),
                  pin=False)
    assert t.host.data_ptr() == loaded.features.ctypes.data  # no copy
    # a cached trainer (a bf16 cache) builds its host table of bf16 rows
    # from the read-only memmap (the table it registers must be writable
    # RAM), copies no f32 features, and steps
    cfg = LegionConfig(
        dataset=meta,
        sampler=SamplerConfig(fanouts=(5, 3), batch_size=64,
                              eval_batch_size=64, dedup="sort",
                              dedup_last_hop=False, auto_compact=True),
        cache=CacheConfig(cache_bytes=40_000, presample_steps=2,
                          feature_residency="host", topo_residency="host"),
        train=TrainConfig(hidden_dim=16, epochs=1),
        mesh=MeshConfig.for_devices(1))
    tr = Trainer(loaded, cfg, device="cpu")
    table = tr.feature_source.host.array
    assert table.ctypes.data != loaded.features.ctypes.data
    assert table.flags.writeable
    np.testing.assert_array_equal(
        table, bf16_rows(np.asarray(loaded.features),
                         bf16_pitch(meta.feature_dim)))
    assert tr.setup_s["ram_copy_bytes"] == \
        loaded.graph.indptr.nbytes + loaded.graph.indices.nbytes
    _, loss = tr.train_step(tr.init_state())
    assert np.isfinite(float(loss)) and 0 < int(tr.last_feat_hits) \
        < int(tr.last_slots)
    tr.close()
