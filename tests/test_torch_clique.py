"""The port's clique caches (``legion_tpu_torch/cache/collective.py``, the
plain versions of K12-K14 on the CPU) against ``legion_tpu/cache/
collective.py`` run as its own tests run it, in ``shard_map`` over 4 of
the 8 virtual CPU devices; and the 4-member trainer on the CPU.

The port holds a clique's members as a leading axis of one process, so one
call of the port's takes every member's ids, and member m's part of its
result is held against JAX's device m."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from legion_tpu.cache.collective import CliqueFeatureCache as JFeat
from legion_tpu.cache.collective import CliqueTopoCache as JTopo
from legion_tpu.cache.collective import HostFallbackAccess
from legion_tpu.cache.collective import _bucket_by_owner
from legion_tpu.cache.collective import build_clique_cache as jax_build_cache
from legion_tpu.cache.collective import build_clique_topo as jax_build_topo
from legion_tpu.cache.hashmap import map_lookup as jax_map_lookup
from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.sampling.sampler import NeighborSampler as JSampler
from legion_tpu.train import Trainer as JTrainer
from legion_tpu_torch.cache.collective import (CliqueFeatureCache,
                                               CliqueTopoCache,
                                               bucket_by_owner,
                                               build_clique_cache,
                                               build_clique_topo,
                                               clique_draw,
                                               clique_draw_plain,
                                               clique_select, exchange,
                                               request_rows)
from legion_tpu_torch.cache.hashmap import HashMap32
from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import synthesize_dataset
from legion_tpu_torch.graph import DeviceCSR
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.host_memory import HostTable, bf16_rows
from legion_tpu_torch.pipeline import Mode
from legion_tpu_torch.sampling.access import CachedTopoAccess
from legion_tpu_torch.sampling.sampler import NeighborSampler
from legion_tpu_torch.train import Trainer

try:
    from jax import shard_map

    def _shard_map(f, mesh, in_specs, out_specs):
        return shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _esm

    def _shard_map(f, mesh, in_specs, out_specs):
        return _esm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

Kg = 4
DP = P(("clique", "member"))
SHARD = P("member", None, None)


def _mesh4():
    return Mesh(np.asarray(jax.devices()[:Kg]).reshape(1, Kg),
                ("clique", "member"))


def _np(m):
    """A map of either package as numpy (a direct table, or the hash
    map's keys, values and probes)."""
    if isinstance(m, HashMap32):
        return m.keys.numpy(), m.vals.numpy(), m.probes
    if hasattr(m, "probes"):
        return np.asarray(m.keys), np.asarray(m.vals), m.probes
    return (np.asarray(m),)


def _assert_maps_equal(pm, jm):
    for a, b in zip(_np(pm), _np(jm)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the builds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(0)
    V, F = 1000, 24
    return (rng.standard_normal((V, F)).astype(np.float32),
            rng.permutation(V).astype(np.int32))


@pytest.mark.parametrize("impl", ["direct", "hash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_clique_cache_equals_jax(feats, impl, dtype):
    f, order = feats
    jm, jrows, jR = jax_build_cache(order, 242, f, Kg, feat_dtype=dtype,
                                    map_impl=impl)
    pm, prows, pR = build_clique_cache(order, 242, f, Kg, feat_dtype=dtype,
                                       map_impl=impl)
    assert pR == jR == 60
    _assert_maps_equal(pm, jm)
    np.testing.assert_array_equal(prows.float().numpy(),
                                  np.asarray(jrows).astype(np.float32))


def _graph(V=300, deg=6, seed=1):
    rng = np.random.default_rng(seed)
    indptr = np.zeros(V + 1, np.int64)
    indptr[1:] = np.cumsum(rng.integers(1, deg * 2, V))
    indices = rng.integers(0, V, indptr[-1]).astype(np.int32)
    return indptr, indices


@pytest.mark.parametrize("impl", ["direct", "hash"])
def test_build_clique_topo_equals_jax(impl):
    indptr, indices = _graph()
    order = np.argsort(-np.diff(indptr))
    jm, jp, jb, jR = jax_build_topo(order, 121, indptr, indices, Kg,
                                    window=8, map_impl=impl)
    pm, pp, pb, pR = build_clique_topo(order, 121, indptr, indices, Kg,
                                       window=8, map_impl=impl)
    assert pR == jR == 30
    _assert_maps_equal(pm, jm)
    assert pp.dtype == torch.int32
    np.testing.assert_array_equal(pp.numpy(), jp)
    np.testing.assert_array_equal(pb.numpy(), jb)


# ---------------------------------------------------------------------------
# K12 bucket_by_owner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mixed", "skewed past R_req", "all miss"])
def test_bucket_by_owner_equals_jax(case):
    """The request matrix, and each lane's owner, position in its owner's
    segment and in-bounds flag, member by member."""
    rng = np.random.default_rng(4)
    M, N = 4, 240
    slot = rng.integers(-1, 900, (M, N)).astype(np.int32)
    if case == "skewed past R_req":
        # most of member 1's lanes go to owner 2, more than R_req of them
        slot[1, :200] = Kg * rng.integers(0, 200, 200) + 2
    if case == "all miss":
        slot[:] = -1
    R_req = request_rows(N, Kg, 1.5)
    req, row, pos = bucket_by_owner(torch.from_numpy(slot), Kg, R_req,
                                    with_pos=True)
    overflow = 0
    for m in range(M):
        s = slot[m]
        owner = np.where(s >= 0, s % Kg, Kg).astype(np.int32)
        local = np.where(s >= 0, s // Kg, 0).astype(np.int32)
        jreq, jinb, jso, jpos, jinv = _bucket_by_owner(
            jnp.asarray(owner), jnp.asarray(local), Kg, R_req)
        inv = np.asarray(jinv)
        np.testing.assert_array_equal(req[m].numpy(), np.asarray(jreq))
        np.testing.assert_array_equal(row[m].numpy() >= 0, np.asarray(jinb))
        np.testing.assert_array_equal(pos[m].numpy(), np.asarray(jpos)[inv])
        # the owner of a lane, and its row in the answers
        np.testing.assert_array_equal(np.clip(owner, 0, Kg - 1),
                                      np.asarray(jso)[inv])
        inb = row[m].numpy() >= 0
        np.testing.assert_array_equal(
            row[m].numpy()[inb],
            ((m * Kg + owner) * R_req + pos[m].numpy())[inb])
        overflow += int(((s >= 0) & ~inb).sum())
    assert (overflow > 0) == (case == "skewed past R_req")
    assert kernels.LAUNCHES["bucket_by_owner"] == 0


# K12's kernel takes a member of at most 8192 lanes in one block and cuts
# longer ones into tiles of 2048 (``csrc/clique.cu``)
@pytest.mark.parametrize("kg", [1, 31])
@pytest.mark.parametrize("N", [8192, 8193, 6 * 2048 + 5])
def test_bucket_by_owner_equals_jax_at_tile_edges(kg, N):
    """The plain K12 against JAX's ``_bucket_by_owner`` at the kernel's
    tile edges: one block's lanes, one lane past them, several tiles of
    2048; a third of the lanes missing, owner 0 past
    R_req where Kg > 1."""
    rng = np.random.default_rng(N + kg)
    M = 2
    slot = rng.integers(0, 40 * kg, (M, N)).astype(np.int32)
    slot[rng.random((M, N)) < 1 / 3] = -1
    slot[0, :N // 2] = kg * rng.integers(0, 40, N // 2)
    R_req = request_rows(N, kg, 1.5)
    req, row, pos = bucket_by_owner(torch.from_numpy(slot), kg, R_req,
                                    with_pos=True)
    for m in range(M):
        s = slot[m]
        owner = np.where(s >= 0, s % kg, kg).astype(np.int32)
        local = np.where(s >= 0, s // kg, 0).astype(np.int32)
        jreq, jinb, _, jpos, jinv = _bucket_by_owner(
            jnp.asarray(owner), jnp.asarray(local), kg, R_req)
        inv = np.asarray(jinv)
        np.testing.assert_array_equal(req[m].numpy(), np.asarray(jreq))
        np.testing.assert_array_equal(row[m].numpy() >= 0, np.asarray(jinb))
        np.testing.assert_array_equal(pos[m].numpy(), np.asarray(jpos)[inv])
        inb = row[m].numpy() >= 0
        np.testing.assert_array_equal(
            row[m].numpy()[inb],
            ((m * kg + owner) * R_req + pos[m].numpy())[inb])
    # owner 0's lanes of member 0 pass R_req (R_req > N at Kg 1)
    overflow = (row[0].numpy() < 0).sum() > (slot[0] < 0).sum()
    assert overflow == (kg > 1)


def test_exchange_is_the_all_to_all():
    """Block (from, to) of each clique goes to member ``to``."""
    x = torch.arange(2 * 3 * 3 * 5).view(2, 3, 3, 5)
    y = exchange(x)
    for c in range(2):
        for a in range(3):
            for b in range(3):
                assert torch.equal(y[c, b, a], x[c, a, b])


# ---------------------------------------------------------------------------
# the feature fetch (K1 on the owners' side, K13 on the requesters')
# ---------------------------------------------------------------------------

def _member_ids(order, case, N=120, seed=5):
    """Each member's own distinct ids, -1 pads at the tail, as a batch's
    ids are: cached ones (global slots < 240), uncached ones and pads."""
    rng = np.random.default_rng(seed)
    out = np.full((Kg, N), -1, np.int32)
    for m in range(Kg):
        if case == "mixed":
            pool = np.concatenate([order[:240], order[240:]])
            ids = rng.choice(pool, N - 8, replace=False)
        elif case == "all miss":
            ids = rng.choice(order[240:], N, replace=False)
        elif case == "no miss":
            ids = rng.choice(order[:240], N - 3, replace=False)
        else:   # overflow: cached ids of owner 1 only, past R_req
            ids = rng.permutation(order[1:240:Kg])[:58]
        out[m, :len(ids)] = ids
    return out


def _jax_fetch(jcache, member_rows, ids, cached_only):
    mesh = _mesh4()
    rows_sh = jax.device_put(member_rows, NamedSharding(mesh, SHARD))

    def inner(i, mr):
        if cached_only:
            rows, hit = jcache.fetch_cached(i[0], mr[0])
            return rows[None], hit[None]
        rows, hits = jcache.fetch(i[0], mr[0])
        return rows[None], hits[None]

    sm = _shard_map(inner, mesh, in_specs=(DP, SHARD), out_specs=(DP, DP))
    rows, second = jax.jit(sm)(jnp.asarray(ids), rows_sh)
    return np.asarray(rows).astype(np.float32), np.asarray(second)


@pytest.mark.parametrize("case", ["mixed", "all miss", "no miss",
                                  "overflow"])
@pytest.mark.parametrize("dtype,table", [
    ("float32", "f32"), ("bfloat16", "f32"), ("bfloat16", "bf16"),
    ("bfloat16", "bf16+40")])
def test_fetch_equals_jax(feats, case, dtype, table):
    """The clique fetch against JAX's in ``shard_map``, over each host
    table its misses may read (f32 rows; a bf16 cache's bf16 rows, at
    the width and padded to 64 columns, whole 128-byte lines)."""
    f, order = feats
    jm, jrows, R = jax_build_cache(order, 240, f, Kg, feat_dtype=dtype)
    pm, prows, _ = build_clique_cache(order, 240, f, Kg, feat_dtype=dtype)
    jcache = JFeat(jnp.asarray(jm), f, Kg, R)
    host = HostTable(f, pin=False) if table == "f32" else HostTable(
        bf16_rows(f, f.shape[1] + int(table.partition("+")[2] or 0)),
        pin=False)
    pcache = CliqueFeatureCache(pm, prows, host, Kg)
    ids = _member_ids(order, case)
    it = torch.from_numpy(ids)

    rows, served = pcache.fetch_cached(it)
    jr, js = _jax_fetch(jcache, jrows, ids, cached_only=True)
    np.testing.assert_array_equal(rows.float().numpy(), jr)
    np.testing.assert_array_equal(served.numpy(), js)

    rows, hits = pcache.fetch(it)
    jr, jh = _jax_fetch(jcache, jrows, ids, cached_only=False)
    np.testing.assert_array_equal(rows.float().numpy(), jr)
    np.testing.assert_array_equal(hits.numpy(), jh)
    # every row is the host row (rounded as the cache rounds), pads zero
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = torch.from_numpy(f)[torch.from_numpy(ids.clip(0)).long()].to(dt)
    ref[torch.from_numpy(ids) < 0] = 0
    assert torch.equal(rows, ref)
    n_cached = np.isin(ids, order[:240]).sum(1)
    if case == "overflow":
        assert (hits.numpy() == request_rows(ids.shape[1], Kg, 1.5)).all()
        assert (hits.numpy() < n_cached).all()
    else:
        np.testing.assert_array_equal(hits.numpy(), n_cached)
    assert pcache.collective_bytes(ids.shape[1])["response_bytes"] == \
        Kg * request_rows(ids.shape[1], Kg, 1.5) * f.shape[1] * \
        prows.element_size()
    assert kernels.LAUNCHES["clique_gather"] == 0


def test_fetch_with_hash_map_and_two_cliques(feats):
    """Two cliques share one copy of the shards; a hash map gives the
    direct table's rows."""
    f, order = feats
    host = HostTable(f, pin=False)
    ids = np.concatenate([_member_ids(order, "mixed", seed=s)
                          for s in (6, 7)])
    outs = []
    for impl, Kc, K in (("direct", 1, Kg), ("hash", 2, Kg // 2)):
        pm, prows, _ = build_clique_cache(order, 240, f, K, map_impl=impl)
        cache = CliqueFeatureCache(pm, prows, host, K, num_cliques=Kc)
        for part in (ids[:Kg], ids[Kg:]) if Kc == 1 else (ids[:Kg],
                                                          ids[Kg:]):
            outs.append(cache.fetch(torch.from_numpy(part))[0])
    for a, b in zip(outs[:2], outs[2:]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the topology draws (K14)
# ---------------------------------------------------------------------------

def _topo_setup(impl="direct"):
    indptr, indices = _graph(V=300, seed=1)
    order = np.argsort(-np.diff(indptr))
    cap, fanout = 120, 5
    jm, jp, jb, R = jax_build_topo(order, cap, indptr, indices, Kg, window=8,
                                   map_impl=impl)
    pm, pp, pb, _ = build_clique_topo(order, cap, indptr, indices, Kg,
                                      window=8, map_impl=impl)
    rng = np.random.default_rng(2)
    frontier = np.full((Kg, 64), -1, np.int32)
    for m in range(Kg):
        f = np.concatenate([rng.choice(order[:cap], 40, replace=False),
                            rng.choice(order[cap:], 10, replace=False)])
        frontier[m, :50] = rng.permutation(f)
    fallback = CachedTopoAccess.all_miss(HostTable(indptr, pin=False),
                                         HostTable(indices, pin=False),
                                         "cpu")
    pcache = CliqueTopoCache(pm, pp, pb, fallback, Kg)
    jcache = JTopo(jnp.asarray(jm) if impl == "direct" else jm, None, None,
                   HostFallbackAccess(indptr, indices), Kg)
    return (indptr, indices, order, cap, fanout, jm, jp, jb, pcache, jcache,
            frontier)


def _jax_draws(jm, jp, jb, frontier, keys, fanout):
    """JAX's owner-side r0 and off (``collective.py:337-365``) for the
    requests the members' frontiers make, in ``clique_select``'s shapes
    [1, Kg, Kg * R_req] and [1, Kg, Kg * R_req, fanout]."""
    F = frontier.shape[1]
    R_req = request_rows(F, Kg, 1.5)
    reqs = []
    for m in range(Kg):
        slot = jax_map_lookup(jnp.asarray(jm) if not hasattr(jm, "probes")
                              else jm, jnp.asarray(frontier[m]))
        hit = slot >= 0
        owner = jnp.where(hit, (slot % Kg).astype(jnp.int32), Kg)
        local = jnp.where(hit, (slot // Kg).astype(jnp.int32), -1)
        reqs.append(_bucket_by_owner(owner, local, Kg, R_req)[0])
    W = jb.shape[-1]
    R = jp.shape[1]
    r0s, offs = [], []
    for o in range(Kg):
        rows = jnp.stack([r[o] for r in reqs])            # [Kg, R_req]
        key = jax.random.fold_in(keys[o], o)
        ok_row = rows >= 0
        pd = jnp.asarray(jp[o])[jnp.clip(rows, 0, R - 1)]
        start = jnp.where(ok_row, pd[..., 0], 0)
        deg = jnp.where(ok_row, pd[..., 1], 0)
        k0, k1 = jax.random.split(key)
        r0 = jax.random.randint(k0, rows.shape, 0, jnp.maximum(deg, 1),
                                dtype=jnp.int32)
        base = (start + r0) // W * W
        lo = (jnp.maximum(base, start) - base).astype(jnp.int32)
        hi = (jnp.minimum(base + W, start + deg) - base).astype(jnp.int32)
        m_ = jnp.maximum(hi - lo, 1)
        off = lo[..., None] + jax.random.randint(
            k1, rows.shape + (fanout,), 0, m_[..., None], dtype=jnp.int32)
        r0s.append(np.asarray(r0).reshape(-1))
        offs.append(np.asarray(off).reshape(-1, fanout))
    return (torch.from_numpy(np.stack(r0s)[None]),
            torch.from_numpy(np.stack(offs)[None]))


def _jax_lookup(jcache, jp, jb, frontier, keys, fanout):
    mesh = _mesh4()

    def f(acc, tp, tb, fr, key):
        acc = acc.bind_shard(tp[0], tb[0])
        nbr, served = acc.lookup(fr[0], fanout, key[0])
        full = acc.sample_neighbors(fr[0], fanout, key[0])
        return nbr[None], served[None], full[None]

    sm = jax.jit(_shard_map(f, mesh, in_specs=(P(), SHARD, SHARD, DP, DP),
                            out_specs=(DP, DP, DP)))
    out = sm(jcache, jax.device_put(jp, NamedSharding(mesh, SHARD)),
             jax.device_put(jb, NamedSharding(mesh, SHARD)),
             jnp.asarray(frontier), keys)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("impl", ["direct", "hash"])
def test_lookup_and_sample_equal_jax_with_its_draws(impl):
    (indptr, indices, order, cap, fanout, jm, jp, jb, pcache, jcache,
     frontier) = _topo_setup(impl)
    keys = jax.random.split(jax.random.PRNGKey(0), Kg)
    draws = _jax_draws(jm, jp, jb, frontier, keys, fanout)
    jn, js, jfull = _jax_lookup(jcache, jp, jb, frontier, keys, fanout)
    ft = torch.from_numpy(frontier)
    pk = torch.zeros((Kg, 4), dtype=torch.int32)   # unused: draws given
    nbr, served = pcache.lookup(ft, fanout, pk, draws=draws)
    np.testing.assert_array_equal(nbr.numpy(), jn)
    np.testing.assert_array_equal(served.numpy(), js)
    full = pcache.sample_neighbors(ft, fanout, pk, draws=draws).numpy()
    lanes = np.tile(served.numpy(), (1, fanout))     # fanout-major
    np.testing.assert_array_equal(full[lanes], jfull[lanes])
    # the host draws of the lanes the clique did not serve (another
    # generator than JAX's, ROADMAP §C "Host miss draws")
    F = frontier.shape[1]
    for m in range(Kg):
        for i, v in enumerate(frontier[m]):
            got = full[m].reshape(fanout, F)[:, i]
            if v < 0:
                assert (got == -1).all()
            else:
                assert set(got.tolist()) <= set(
                    indices[indptr[v]:indptr[v + 1]].tolist())
    assert served.numpy()[:, :50].sum() == Kg * 40
    assert kernels.LAUNCHES["clique_draw"] == 0


def _draw_local_jax(jp, jb, rows, keys, fanout, kg):
    """JAX's ``_draw_local`` for every owner, its axis index the vmapped
    owner axis: rows [Kg(owner), Kg, R_req] -> [Kg, Kg, R_req, fanout];
    and its r0 and off, drawn as it draws them, as [1, Kg, Kg * R_req]
    and [1, Kg, Kg * R_req, fanout] tensors."""
    jt = JTopo(None, None, None, None, kg)
    W, R = jb.shape[-1], jp.shape[1]

    def one(pairs, blocks, r, key):
        k0, k1 = jax.random.split(
            jax.random.fold_in(key, jax.lax.axis_index("member")))
        pd = pairs[jnp.clip(r, 0, R - 1)]
        start = jnp.where(r >= 0, pd[..., 0], 0)
        deg = jnp.where(r >= 0, pd[..., 1], 0)
        r0 = jax.random.randint(k0, r.shape, 0, jnp.maximum(deg, 1),
                                dtype=jnp.int32)
        base = (start + r0) // W * W
        lo = (jnp.maximum(base, start) - base).astype(jnp.int32)
        hi = (jnp.minimum(base + W, start + deg) - base).astype(jnp.int32)
        off = lo[..., None] + jax.random.randint(
            k1, r.shape + (fanout,), 0, jnp.maximum(hi - lo, 1)[..., None],
            dtype=jnp.int32)
        return (jt.bind_shard(pairs, blocks)._draw_local(r, fanout, key),
                r0, off)

    out, r0, off = jax.jit(jax.vmap(one, axis_name="member"))(
        jnp.asarray(jp), jnp.asarray(jb), jnp.asarray(rows), keys)
    return (np.asarray(out), torch.from_numpy(np.array(r0).reshape(
        1, kg, -1)), torch.from_numpy(np.array(off).reshape(
            1, kg, -1, fanout)))


# K14's draw kernel takes a warp of 32 requests at a time, 256 a block
@pytest.mark.parametrize("kg,R_req", [(1, 256), (1, 257), (1, 773),
                                      (31, 9)])
def test_clique_select_equals_jax_draw_local_at_tile_edges(kg, R_req):
    """``clique_select`` with JAX's r0 and off against JAX's
    ``_draw_local`` of every owner (vmapped, its axis index the owner's),
    at requests of an owner around one block of the kernel (Q = Kg *
    R_req of 256 to 773), with degree-0 rows and empty requests."""
    rng = np.random.default_rng(kg * 1000 + R_req)
    indptr, indices = _graph(V=40 * kg, seed=kg)
    deg = np.diff(indptr)
    deg[rng.random(len(deg)) < 0.2] = 0      # rows with no neighbours
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = indices[:indptr[-1]]
    order = np.argsort(-deg, kind="stable")
    fanout = 7
    _, jp, jb, R = jax_build_topo(order, 20 * kg, indptr, indices, kg,
                                  window=8)
    _, pp, pb, _ = build_clique_topo(order, 20 * kg, indptr, indices, kg,
                                     window=8)
    rows = rng.integers(-1, R, (kg, kg, R_req)).astype(np.int32)
    rows[rng.random(rows.shape) < 0.3] = -1
    keys = jax.random.split(jax.random.PRNGKey(R_req), kg)
    want, r0, off = _draw_local_jax(np.asarray(jp), np.asarray(jb), rows,
                                    keys, fanout, kg)
    got = clique_select(pp, pb, torch.from_numpy(rows.reshape(1, kg, -1)),
                        r0, off)
    np.testing.assert_array_equal(got.numpy(),
                                  want.reshape(1, kg, -1, fanout))
    assert (want == -1).any() and (want >= 0).any()


def test_clique_draws_are_neighbors():
    """The port's own draws (K14's words): served rows draw from their
    vertex's CSR row, misses fall back, members draw apart
    (``tests/test_clique_topo.py::test_clique_topo_draws_are_neighbors``).
    """
    (indptr, indices, order, cap, fanout, jm, jp, jb, pcache, jcache,
     frontier) = _topo_setup()
    rng = np.random.default_rng(9)
    frontier[:] = frontier[0]          # every member asks the same rows
    keys = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (Kg, 4))
                            .astype(np.int32))
    ft = torch.from_numpy(frontier)
    nbr, served = pcache.lookup(ft, fanout, keys)
    full = pcache.sample_neighbors(ft, fanout, keys)
    F = frontier.shape[1]
    nbr = nbr.numpy().reshape(Kg, fanout, F)
    full = full.numpy().reshape(Kg, fanout, F)
    served = served.numpy()
    for m in range(Kg):
        for i, v in enumerate(frontier[m]):
            if v < 0:
                assert not served[m, i] and (full[m, :, i] == -1).all()
                continue
            nb = set(indices[indptr[v]:indptr[v + 1]].tolist())
            if served[m, i]:
                assert set(nbr[m, :, i].tolist()) <= nb
            else:
                assert (nbr[m, :, i] == -1).all()
            assert set(full[m, :, i].tolist()) <= nb
    cached = np.isin(frontier, order[:cap])
    assert (served == cached).all()
    assert not (nbr[0] == nbr[1]).all()


def test_builds_for_one_owner_are_its_slice(feats):
    """A process of a clique across processes builds its own shard alone
    (``owners=[o]``): the same rows, pairs and blocks as shard o of the
    whole build, and the same maps."""
    feats, order = feats
    sm, rows, _ = build_clique_cache(order, 400, feats, Kg)
    indptr, indices = _graph(V=300, seed=1)
    t_order = np.argsort(-np.diff(indptr))
    rm, pairs, blocks, _ = build_clique_topo(t_order, 120, indptr, indices,
                                             Kg, window=8)
    for o in range(Kg):
        sm1, rows1, _ = build_clique_cache(order, 400, feats, Kg, owners=[o])
        assert torch.equal(sm1, sm) and torch.equal(rows1, rows[o:o + 1])
        rm1, p1, b1, _ = build_clique_topo(t_order, 120, indptr, indices, Kg,
                                           window=8, owners=[o])
        assert torch.equal(rm1, rm) and torch.equal(p1, pairs[o:o + 1])
        assert torch.equal(b1, blocks[o:o + 1])


@pytest.mark.parametrize("Kc", [1, 2])
def test_one_owner_draws_its_slice_of_all_owners(Kc):
    """K14 for one owner (its own shard, its clique index o0 folded into
    the words), as a process of a clique across processes draws: equal to
    that owner's slice of the all-owners draw, for every o0, plain and
    wrapper; at offset 0 with all owners, today's draws."""
    (indptr, indices, order, cap, fanout, jm, jp, jb, pcache, jcache,
     frontier) = _topo_setup()
    rng = np.random.default_rng(21)
    pairs, blocks = pcache.member_pairs, pcache.member_indices2d
    R = pairs.shape[1]
    Q = 3 * Kg
    recv = torch.from_numpy(rng.integers(-1, R, (Kc, Kg, Q))
                            .astype(np.int32))
    keys = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (Kc * Kg, 4))
                            .astype(np.int32))
    full = clique_draw_plain(pairs, blocks, recv, fanout, keys)
    assert torch.equal(full, clique_draw(pairs, blocks, recv, fanout, keys,
                                         0))
    for o0 in range(Kg):
        kw = keys.view(Kc, Kg, 4)[:, o0].contiguous()
        args = (pairs[o0:o0 + 1], blocks[o0:o0 + 1],
                recv[:, o0:o0 + 1].contiguous(), fanout, kw)
        one = clique_draw_plain(*args, first_owner=o0)
        assert torch.equal(one, full[:, o0:o0 + 1])
        assert torch.equal(clique_draw(*args, first_owner=o0), one)
        if o0:
            assert not torch.equal(clique_draw_plain(*args), one)


def test_topo_hit_count_equals_jax_overflow_rule():
    """The trainer's topology hits: resident expanded vertices, less the
    lanes past an owner's R_req on each hop (``legion_tpu/train.py:
    535-574``, run with ``jnp`` on the same ids)."""
    V = 3000
    rng = np.random.default_rng(11)
    indptr = np.concatenate([[0], np.cumsum(rng.integers(1, 12, V))])
    indices = rng.integers(0, V, indptr[-1]).astype(np.int32)
    skw = dict(fanouts=(4, 3), batch_size=64, dedup="sort",
               dedup_last_hop=False)
    sampler = NeighborSampler(SamplerConfig(**skw), V)
    jsampler = JSampler(JSamplerConfig(**skw), V)
    from legion_tpu_torch.sampling.access import DeviceCSRAccess
    csr = DeviceCSR.from_numpy(indptr, indices, "cpu")
    batch = sampler.sample(DeviceCSRAccess(csr),
                           torch.from_numpy(rng.choice(V, 64, replace=False)
                                            .astype(np.int32)), 5)
    # a row map whose residents mostly belong to owner 0: overflow
    rm = np.full(V, -1, np.int32)
    hot = rng.choice(V, 2000, replace=False)
    rm[hot] = Kg * np.arange(2000) + (np.arange(2000) % 7 == 0)
    access = CliqueTopoCache(torch.from_numpy(rm), None, None,
                             SimpleNamespace(num_nodes=V), Kg)
    hits, total = Trainer._topo_hit_count(None, batch, access, sampler)
    jacc = SimpleNamespace(row_map=jnp.asarray(rm), Kg=Kg, slack=1.5)
    jb = SimpleNamespace(node_ids=jnp.asarray(batch.node_ids.numpy()),
                         hop_offsets=jnp.asarray(batch.hop_offsets.numpy()))
    jh, jt = JTrainer._topo_hit_count(None, jb, jacc, jsampler)
    assert (int(hits), int(total)) == (int(jh), int(jt))
    resident = int((torch.from_numpy(rm)[batch.node_ids[
        :sampler.cum_caps[1]].clamp(min=0).long()] >= 0)[
            batch.node_ids[:sampler.cum_caps[1]] >= 0].sum())
    assert int(hits) < resident        # the overflow was taken off


# ---------------------------------------------------------------------------
# the trainer: 4 members on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_ds():
    return synthesize_dataset(num_nodes=3000, avg_degree=10, feature_dim=32,
                              num_classes=5, batch_size=64, train_frac=0.5,
                              seed=3)


def _cfg(ds, mesh=MeshConfig(1, Kg), dedup="sort", impl="direct",
         feat="host", topo="host", cache_bytes=120_000, dropout=0.5,
         model="graphsage", **skw):
    s = dict(fanouts=(4, 3), batch_size=64, eval_batch_size=64, dedup=dedup,
             dedup_last_hop=False, neighbor_window=8)
    s.update(skw)
    return LegionConfig(
        dataset=ds.meta, sampler=SamplerConfig(**s),
        cache=CacheConfig(cache_bytes=cache_bytes, presample_steps=2,
                          feature_residency=feat, topo_residency=topo,
                          map_impl=impl),
        train=TrainConfig(model=model, hidden_dim=32, epochs=2,
                          compute_dtype="float32", dropout=dropout,
                          pad_feature_dim=False),
        mesh=mesh)


def _params(state):
    return [p.detach().clone() for p in state["model"].parameters()]


@pytest.mark.parametrize("dedup", ["sort", "map"])
def test_train_multidev_full_host_cache(host_ds, dedup):
    """4 members, features and topology on the host behind clique caches:
    trains, learns, both hit counters live, eval and fit run
    (``tests/test_clique_topo.py::test_train_multidev_full_host_cache``);
    the position maps stay clean."""
    tr = Trainer(host_ds, _cfg(host_ds, dedup=dedup, cache_bytes=40_000),
                 "cpu")
    assert isinstance(tr.graph_access, CliqueTopoCache)
    assert isinstance(tr.feature_source, CliqueFeatureCache)
    state = tr.init_state()
    assert tuple(state["pos_map"].shape) == (
        Kg, tr.sampler_t.state_size)
    losses = []
    for _ in range(tr.schedule.train_step * 2):
        state, loss = tr.train_step(state)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert int(tr.last_feat_hits) > 0 and int(tr.last_topo_hits) > 0
    assert int(tr.last_topo_total) >= int(tr.last_topo_hits)
    state, acc = tr.run_eval(state, Mode.VALID)
    assert 0.0 <= acc <= 1.0 and int(state["total"]) > 0
    state, stats = tr.fit(state, verbose=False)
    assert np.isfinite(stats[0].train_loss) and tr.test_acc is not None
    assert (state["pos_map"] == 2 ** 31 - 1).all()
    tr.close()


def test_clique_cached_training_learns():
    """``tests/test_clique_train.py::test_clique_cached_training_learns``:
    host features served by the clique cache over 4 members, fit."""
    ds = synthesize_dataset(num_nodes=2000, avg_degree=8, feature_dim=32,
                            num_classes=5, batch_size=64, seed=7)
    cfg = LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=16,
                              eval_batch_size=64),
        cache=CacheConfig(cache_bytes=100 * 32 * 4,
                          feature_residency="host", presample_steps=4),
        train=TrainConfig(model="graphsage", hidden_dim=32, epochs=8,
                          dropout=0.2),
        mesh=MeshConfig(num_cliques=1, clique_size=4))
    tr = Trainer(ds, cfg, "cpu")
    assert isinstance(tr.feature_source, CliqueFeatureCache)
    assert tr.cache_plan.feature_capacity > 0
    state, stats = tr.fit(verbose=False)
    assert stats[-1].train_loss < stats[0].train_loss * 0.7
    assert stats[-1].valid_acc > 0.5, stats
    assert int(tr.last_feat_hits) > 0


def _run(tr, steps=3):
    state = tr.init_state()
    losses = []
    for _ in range(steps):
        state, loss = tr.train_step(state)
        losses.append(loss.clone())
    return torch.stack(losses), _params(state)


@pytest.mark.parametrize("dedup", ["sort", "map"])
def test_hashmap_clique_training_matches_direct(host_ds, dedup):
    """Clique caches (features and topology) with hash maps give the
    direct tables' losses and parameters bit for bit
    (``tests/test_hashmap.py::test_hashmap_clique_training_matches_direct``
    held to rtol 1e-6 there)."""
    trs = [Trainer(host_ds, _cfg(host_ds, dedup=dedup, impl=impl,
                                 cache_bytes=40_000), "cpu")
           for impl in ("direct", "hash")]
    assert isinstance(trs[1].feature_source.slot_map, HashMap32)
    assert isinstance(trs[1].graph_access.row_map, HashMap32)
    (ld, pd), (lh, ph) = (_run(t) for t in trs)
    assert torch.equal(ld, lh)
    assert all(torch.equal(a, b) for a, b in zip(pd, ph))


@pytest.mark.parametrize("dedup", ["sort", "map"])
def test_clique_features_equal_device_features(host_ds, dedup):
    """4 members with the features behind the clique cache (the topology
    on the device) give the losses and parameters of the same 4 members
    with every feature on the device, bit for bit: the fetch returns the
    same rows."""
    trs = [Trainer(host_ds, _cfg(host_ds, dedup=dedup, topo="hbm",
                                 cache_bytes=cb), "cpu")
           for cb in (20_000, 0)]
    assert isinstance(trs[0].feature_source, CliqueFeatureCache)
    assert trs[1].cache_plan is None
    (la, pa), (lb, pb) = (_run(t) for t in trs)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_two_cliques_of_one_member_train(host_ds):
    """MeshConfig(2, 1): a per-member feature cache and per-member hot
    sub-CSR; trains and evaluates."""
    tr = Trainer(host_ds, _cfg(host_ds, mesh=MeshConfig(2, 1)), "cpu")
    assert isinstance(tr.graph_access, CachedTopoAccess)
    assert tr.feature_source.Kg == 1 and tr.feature_source.Kc == 2
    losses, _ = _run(tr, 4)
    assert torch.isfinite(losses).all()
    state, acc = tr.run_eval(tr.init_state(), Mode.VALID)
    assert 0.0 <= acc <= 1.0


@pytest.mark.parametrize("model,skw", [
    ("gcn", dict(dedup_last_hop=True)),
    ("gat", {}),
    ("lp_sage", dict(batch_size=63, eval_batch_size=63))])
def test_other_models_train_with_members(host_ds, model, skw):
    """The member loop serves every model: 2 members, a few steps and an
    eval pass on a device dataset's features."""
    tr = Trainer(host_ds, _cfg(host_ds, mesh=MeshConfig(1, 2), feat="hbm",
                               topo="hbm", cache_bytes=0, model=model,
                               **skw), "cpu")
    losses, _ = _run(tr, 3)
    assert torch.isfinite(losses).all()
    state, metric = tr.run_eval(tr.init_state(), Mode.VALID)
    assert np.isfinite(metric)
