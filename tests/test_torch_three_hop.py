"""Three hops: the port against the JAX package at JAX's own three-hop
configuration (``tests/test_three_hop.py::_cfg``: fanouts (5, 4, 3),
batch 32, GraphSAGE with num_layers 3), on the CPU.

The sampler's batch equals JAX's given JAX's per-hop candidates (both
dedup modes, the aligned and the deduplicated last hop); one GraphSAGE
train step on JAX's batch with JAX's weights (``utils/convert.py``) equals
JAX's, with the aligned and the deduplicated last hop, and with features
and topology on the host behind the caches; a three-layer GAT (heads
(2, 2, 1)) takes the same step. Tolerances as in ``test_torch_parity.py``
(f32: 1e-5, the loss relative, gradients and updated parameters
norm-wise).
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from legion_tpu.cache.cost_model import CostModelResult as JPlan
from legion_tpu.cache.unified_cache import CachedFeatureSource as JCached
from legion_tpu.cache.unified_cache import UnifiedCache as JCache
from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.data import synthesize_dataset as jax_host_synth
from legion_tpu.data.device_synthetic import synthesize_device_dataset \
    as jax_synth
from legion_tpu.models import make_model as jax_make_model
from legion_tpu.sampling.access import CachedTopoAccess as JTopo
from legion_tpu.sampling.access import DeviceCSRAccess as JDeviceCSR
from legion_tpu.sampling.sampler import NeighborSampler as JSampler
from legion_tpu.train import _masked_ce as jax_masked_ce
from legion_tpu_torch.cache.unified_cache import CachedFeatureSource
from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.sampling.sampler import INT32_MAX, NeighborSampler
from legion_tpu_torch.train import Trainer
from legion_tpu_torch.utils.convert import (batch_from_jax, cache_from_jax,
                                            legion_dataset_from_jax,
                                            params_from_jax)
from test_three_hop import _cfg
from test_torch_parity import F32_RTOL, one_train_step, rel
from test_torch_sampler import _assert_batches_equal, _run_jax

BS = 32


def _sampler_kw(ds, **skw):
    """JAX's three-hop sampler config (``_cfg``) as keyword arguments,
    which both packages' ``SamplerConfig`` take."""
    return asdict(_cfg(ds, **skw).sampler)


def _train_kw(ds):
    """``_cfg``'s train config: GraphSAGE, hidden 16, three layers."""
    t = _cfg(ds).train
    assert t.num_layers == 3
    return dict(hidden_dim=t.hidden_dim, num_layers=t.num_layers)


@pytest.mark.parametrize("dedup", ["sort", "map"])
@pytest.mark.parametrize("aligned", [True, False])
def test_three_hop_batch_matches_jax(small_dataset, dedup, aligned):
    """Given JAX's candidates at each of the three hops, the port's
    frontiers and ``SampleBatch`` equal JAX's exactly, and with map dedup
    the position map is clean after the batch, as JAX's."""
    ds = small_dataset
    g = ds.graph
    kw = _sampler_kw(ds, dedup=dedup, dedup_last_hop=not aligned)
    js = JSampler(JSamplerConfig(**kw), g.num_nodes)
    ps = NeighborSampler(SamplerConfig(**kw), g.num_nodes)
    assert ps.config.num_hops == 3 and ps.ids_len == js.ids_len
    assert kw["neighbor_window"] == 0    # JAX draws from the whole row
    seeds = np.asarray(ds.train_ids[:BS], np.int32)
    jb, fronts, cands, jmap = _run_jax(
        js, JDeviceCSR(g.to_device()), seeds, jax.random.PRNGKey(5))
    pos_map = ps.init_state("cpu")
    carry = ps.begin(torch.from_numpy(seeds), pos_map)
    for k in range(3):
        np.testing.assert_array_equal(ps.hop_frontier(carry, k).numpy(),
                                      fronts[k])
        carry = ps.hop_absorb(carry, k, torch.from_numpy(cands[k]))
    pb = ps.finish(carry)
    _assert_batches_equal(pb, jb)
    np.testing.assert_array_equal(pos_map.numpy(), jmap)
    assert np.all(jmap == INT32_MAX)


@pytest.fixture(scope="module")
def jax_dataset():
    return jax_synth(num_nodes=2000, num_edges=40000, feature_dim=100,
                     num_classes=8, batch_size=BS, valid_size=256,
                     test_size=256, seed=4)


def _assert_step(loss_p, loss_j, pairs):
    assert abs(loss_p - loss_j) <= F32_RTOL * abs(loss_j), (loss_p, loss_j)
    assert len(pairs) >= 9
    for name, gp, gj, npar, nj in pairs:
        assert rel(gp, gj) <= F32_RTOL and rel(npar, nj) <= F32_RTOL, name


@pytest.mark.parametrize("aligned", [True, False])
def test_three_hop_train_step_matches_jax(jax_dataset, aligned):
    """One GraphSAGE train step (three layers, features on the device) on
    JAX's batch with JAX's weights: the loss, every gradient and every
    Adam-updated parameter, with the aligned last hop (layer 0 reads the
    hop's rows in place) and with the deduplicated one."""
    kw = _sampler_kw(jax_dataset, dedup_last_hop=not aligned,
                     neighbor_window=16)
    _assert_step(*one_train_step(jax_dataset, "graphsage", "float32", kw,
                                 BS, _train_kw(jax_dataset)))


def test_three_hop_gat_train_step_matches_jax(jax_dataset):
    """A three-layer GAT, heads (2, 2, 1), on the aligned last hop: one
    train step on JAX's batch with JAX's weights, dropout 0."""
    kw = _sampler_kw(jax_dataset, neighbor_window=16)
    tkw = dict(_train_kw(jax_dataset), hidden_dim=8, gat_heads=(2, 2, 1))
    _assert_step(*one_train_step(jax_dataset, "gat", "float32", kw, BS,
                                 tkw))


def test_three_hop_host_train_step_matches_jax():
    """Features and topology on the host behind the caches (the same
    partial caches, ``cache_from_jax``): JAX's batch drawn through its
    ``CachedTopoAccess``; the port's fetch equals JAX's
    ``CachedFeatureSource.fetch`` exactly, and one GraphSAGE step with
    JAX's weights equals JAX's."""
    jds = jax_host_synth(num_nodes=1500, avg_degree=12, feature_dim=100,
                         num_classes=8, batch_size=BS, seed=2)
    V, g = jds.meta.num_nodes, jds.graph
    kw = _sampler_kw(jds)
    tkw = dict(_train_kw(jds), dropout=0.0, lr=3e-3,
               compute_dtype="float32")
    jcfg = JSamplerConfig(**kw)
    jtrain = _cfg(jds).train
    qf = np.argsort(-np.bincount(g.indices, minlength=V), kind="stable")
    qt = np.argsort(-g.degrees(), kind="stable")
    plan = JPlan(feature_capacity=400, topo_capacity=300, alpha=0.5,
                 feature_order=qf, topo_order=qt, est_feat_saved_bytes=0.0,
                 est_topo_saved_bytes=0.0)
    jc = JCache.build_from_host(plan, jds.features, g.indptr, g.indices, V)
    sampler = JSampler(jcfg, V)
    seeds = np.asarray(jds.train_ids[:BS], np.int32)
    jb, _ = sampler.sample(
        JTopo(jc.row_map, jc.sub_indptr, jc.sub_indices, g.indptr,
              g.indices), jnp.asarray(seeds), sampler.init_state(),
        jax.random.PRNGKey(4))
    xj, hj = JCached(jc, jds.features).fetch(jb.node_ids[:sampler.max_ids])
    model = jax_make_model(type(jtrain)(**dict(asdict(jtrain), **tkw)),
                           jcfg, 100, 8, in_dim_pad=100)
    params = model.init(jax.random.PRNGKey(0))
    y = np.asarray(jds.labels)[seeds]

    def loss_fn(p):
        logits = model.apply(p, xj, jb, train=True, rng=None)
        return jax_masked_ce(logits, jnp.asarray(y), jnp.asarray(seeds >= 0))

    tx = optax.adam(3e-3)

    @jax.jit
    def jax_step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    loss_j, grads_j, new_j = jax_step(params)

    ds = legion_dataset_from_jax(jds)
    cfg = LegionConfig(dataset=ds.meta, sampler=SamplerConfig(**kw),
                       cache=CacheConfig(cache_bytes=60_000,
                                         presample_steps=2,
                                         feature_residency="host",
                                         topo_residency="host"),
                       train=TrainConfig(**tkw),
                       mesh=MeshConfig.for_devices(1))
    tr = Trainer(ds, cfg, device="cpu")
    tr.feature_source = CachedFeatureSource(cache_from_jax(jc),
                                            tr.feature_source.host)
    state = tr.init_state()
    state["model"].load_state_dict(params_from_jax(params))
    pb = batch_from_jax(jb)
    xp, hp = tr.feature_source.fetch(pb.node_ids[:tr.sampler_t.max_ids])
    np.testing.assert_array_equal(xp.numpy(), np.asarray(xj))
    assert int(hp) == int(hj) > 0
    loss_p = tr._train_on(state, pb, xp, torch.from_numpy(seeds),
                          tr.train_ybank[:BS], key=0)
    pairs = [(f"layer {i} {k}", layer[k].grad, grads_j["layers"][i][k],
              layer[k], new_j["layers"][i][k])
             for i, layer in enumerate(state["model"].layers)
             for k in layer]
    _assert_step(float(loss_p), float(loss_j), pairs)
    tr.close()
