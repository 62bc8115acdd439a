"""The port's whole training slice against the JAX package, on the CPU,
and the port's own trainer loop. Also: the port never imports jax, and
its kernel wrappers have no silent fallback."""

import ast
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from legion_tpu.cache.cost_model import CostModelResult as JPlan
from legion_tpu.cache.unified_cache import CachedFeatureSource as JCached
from legion_tpu.cache.unified_cache import DeviceFeatureSource as JSource
from legion_tpu.cache.unified_cache import UnifiedCache as JCache
from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.config import TrainConfig as JTrainConfig
from legion_tpu.data import synthesize_dataset as jax_host_synth
from legion_tpu.data.device_synthetic import synthesize_device_dataset \
    as jax_synth
from legion_tpu.models import make_model as jax_make_model
from legion_tpu.sampling.access import CachedTopoAccess as JTopo
from legion_tpu.sampling.access import WindowedCSRAccess as JWindowed
from legion_tpu.sampling.sampler import NeighborSampler as JSampler
from legion_tpu.train import _masked_ce as jax_masked_ce
from legion_tpu_torch.cache.unified_cache import CachedFeatureSource
from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import synthesize_dataset as host_synth
from legion_tpu_torch.data import synthesize_device_dataset
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.host_memory import bf16_pitch, bf16_rows
from legion_tpu_torch.pipeline import Mode
from legion_tpu_torch.train import Trainer
from legion_tpu_torch.utils.convert import (batch_from_jax, cache_from_jax,
                                            dataset_from_jax,
                                            legion_dataset_from_jax,
                                            params_from_jax)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "legion_tpu_torch"

# tolerances of the one-step slice, as norm-wise relative errors
# ||port - jax|| / ||jax||. Norm-wise, because Adam's first step divides
# each gradient by its own magnitude: an element whose gradient is near
# eps turns a summation-order difference of 1e-10 into a visible change
# of that one element, while the tensor as a whole agrees.
# f32 compute differs only in summation order
F32_RTOL = 1e-5
# bf16 features/activations round at other places (and JAX's bf16 gather
# transpose sums in bf16 where the port sums in f32)
BF16_RTOL = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.fixture(scope="module")
def jax_dataset():
    return jax_synth(num_nodes=2000, num_edges=40000, feature_dim=100,
                     num_classes=8, batch_size=32, valid_size=256,
                     test_size=256, seed=1)


@pytest.mark.parametrize("dedup", ["sort", "map"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_one_train_step_matches_jax(jax_dataset, compute_dtype, dedup):
    """Same converted dataset, params and (injected) batch, dropout 0:
    the fetch, loss, gradients and Adam-updated params of the port's
    train step equal the JAX pieces of train.py:601-623, for a batch of
    either dedup mode."""
    jds = jax_dataset
    kw = dict(fanouts=(5, 3), batch_size=32, eval_batch_size=32,
              dedup=dedup, neighbor_window=16, dedup_last_hop=False,
              node_caps=(32, 128, 0))
    tkw = dict(hidden_dim=256, dropout=0.0, lr=3e-3,
               compute_dtype=compute_dtype)
    jcfg = JSamplerConfig(**kw)
    V = jds.meta.num_nodes

    # --- JAX pieces ---
    sampler = JSampler(jcfg, V)
    seeds = np.asarray(jds.train_ids[:32], np.int32)
    jb, _ = sampler.sample(JWindowed.from_csr(jds.csr, 16),
                           jnp.asarray(seeds), sampler.init_state(),
                           jax.random.PRNGKey(4))
    feats = jds.features.astype(jnp.bfloat16) \
        if compute_dtype == "bfloat16" else jds.features
    feats = jnp.pad(feats, ((0, 0), (0, 28)))
    xj, _ = JSource(feats).fetch(jb.node_ids[:sampler.max_ids])
    model = jax_make_model(JTrainConfig(**tkw), jcfg, 100, 8,
                           in_dim_pad=128)
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

    # --- the port's step on the same inputs ---
    ds = dataset_from_jax(jds)
    cfg = LegionConfig(dataset=ds.meta, sampler=SamplerConfig(**kw),
                       train=TrainConfig(**tkw),
                       mesh=MeshConfig.for_devices(1))
    tr = Trainer(ds, cfg, device="cpu")
    state = tr.init_state()
    state["model"].load_state_dict(params_from_jax(params))
    pb = batch_from_jax(jb)
    xp, _ = tr.feature_source.fetch(pb.node_ids[:tr.sampler_t.max_ids])
    np.testing.assert_array_equal(_np(xp), _np(xj))
    np.testing.assert_array_equal(tr.train_ybank[:32].numpy(), y)
    loss_p = tr._train_on(state, pb, xp, torch.from_numpy(seeds),
                          tr.train_ybank[:32], key=0)

    tol = F32_RTOL if compute_dtype == "float32" else BF16_RTOL
    assert abs(float(loss_p) - float(loss_j)) <= tol * abs(float(loss_j))
    for i in range(2):
        layer = state["model"].layers[i]
        for k in ("w_self", "w_neigh", "b"):
            g_rel = _rel(layer[k].grad, grads_j["layers"][i][k])
            p_rel = _rel(layer[k], new_j["layers"][i][k])
            assert g_rel <= tol and p_rel <= tol, (i, k, g_rel, p_rel)


@pytest.fixture(scope="module")
def jax_host_dataset():
    return jax_host_synth(num_nodes=1500, avg_degree=12, feature_dim=100,
                          num_classes=8, batch_size=32, seed=2)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_one_host_cached_train_step_matches_jax(jax_host_dataset,
                                                compute_dtype):
    """Host features and host topology with the cache on: the same cache
    (cache_from_jax), the same batch (JAX's, drawn through its
    CachedTopoAccess), the same parameters and dropout 0. The fetch equals
    JAX's CachedFeatureSource.fetch exactly; the loss, gradients and
    updated parameters equal JAX's within the one-step tolerances."""
    jds = jax_host_dataset
    V = jds.meta.num_nodes
    g = jds.graph
    kw = dict(fanouts=(5, 3), batch_size=32, eval_batch_size=32,
              dedup="sort", dedup_last_hop=False, node_caps=(32, 128, 0))
    tkw = dict(hidden_dim=64, dropout=0.0, lr=3e-3,
               compute_dtype=compute_dtype)
    feat_dtype = "bfloat16" if compute_dtype == "bfloat16" else "float32"
    jcfg = JSamplerConfig(**kw)

    # --- JAX pieces: a plan with both caches, host misses by callback ---
    qf = np.argsort(-np.bincount(g.indices, minlength=V), kind="stable")
    qt = np.argsort(-g.degrees(), kind="stable")
    plan = JPlan(feature_capacity=400, topo_capacity=300, alpha=0.5,
                 feature_order=qf, topo_order=qt, est_feat_saved_bytes=0.0,
                 est_topo_saved_bytes=0.0)
    jc = JCache.build_from_host(plan, jds.features, g.indptr, g.indices, V,
                                feat_dtype=feat_dtype)
    sampler = JSampler(jcfg, V)
    seeds = np.asarray(jds.train_ids[:32], np.int32)
    jb, _ = sampler.sample(
        JTopo(jc.row_map, jc.sub_indptr, jc.sub_indices, g.indptr,
              g.indices), jnp.asarray(seeds), sampler.init_state(),
        jax.random.PRNGKey(4))
    xj, hj = JCached(jc, jds.features).fetch(jb.node_ids[:sampler.max_ids])
    model = jax_make_model(JTrainConfig(**tkw), jcfg, 100, 8, in_dim_pad=100)
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

    # --- the port: a cached trainer on the same host data ---
    ds = legion_dataset_from_jax(jds)
    cfg = LegionConfig(dataset=ds.meta, sampler=SamplerConfig(**kw),
                       cache=CacheConfig(cache_bytes=60_000,
                                         presample_steps=2,
                                         feature_residency="host",
                                         topo_residency="host"),
                       train=TrainConfig(**tkw),
                       mesh=MeshConfig.for_devices(1))
    tr = Trainer(ds, cfg, device="cpu")
    assert tr.feat_pad == 100 and tr.cache_plan is not None
    tr.feature_source = CachedFeatureSource(cache_from_jax(jc),
                                            tr.feature_source.host)
    state = tr.init_state()
    state["model"].load_state_dict(params_from_jax(params))
    pb = batch_from_jax(jb)
    xp, hp = tr.feature_source.fetch(pb.node_ids[:tr.sampler_t.max_ids])
    np.testing.assert_array_equal(_np(xp), _np(xj))
    assert int(hp) == int(hj)
    loss_p = tr._train_on(state, pb, xp, torch.from_numpy(seeds),
                          tr.train_ybank[:32], key=0)

    tol = F32_RTOL if compute_dtype == "float32" else BF16_RTOL
    assert abs(float(loss_p) - float(loss_j)) <= tol * abs(float(loss_j))
    for i in range(2):
        layer = state["model"].layers[i]
        for k in ("w_self", "w_neigh", "b"):
            g_rel = _rel(layer[k].grad, grads_j["layers"][i][k])
            p_rel = _rel(layer[k], new_j["layers"][i][k])
            assert g_rel <= tol and p_rel <= tol, (i, k, g_rel, p_rel)
    tr.close()


def test_one_gat_train_step_on_host_features_matches_jax(jax_host_dataset):
    """GAT on host features (GAT-H): the port's ``CachedFeatureSource``
    (K4's plain version) and JAX's (its host callback) over the same
    partial cache, so that the aligned hop's lanes both hit and miss; rows
    100 wide, unpadded (``feat_pad`` 100), f32. On JAX's batch, with JAX's
    parameters and dropout 0: the fetch exactly, then the loss, every
    gradient and the Adam-updated parameters within F32_RTOL."""
    jds = jax_host_dataset
    V = jds.meta.num_nodes
    g = jds.graph
    kw = dict(fanouts=(5, 3), batch_size=32, eval_batch_size=32,
              dedup="sort", neighbor_window=16, dedup_last_hop=False,
              node_caps=(32, 128, 0))
    tkw = dict(model="gat", hidden_dim=16, dropout=0.0, gat_feat_drop=0.0,
               gat_attn_drop=0.0, gat_heads=(4, 1), lr=3e-3,
               compute_dtype="float32")
    jcfg = JSamplerConfig(**kw)
    qf = np.argsort(-np.bincount(g.indices, minlength=V), kind="stable")
    plan = JPlan(feature_capacity=400, topo_capacity=0, alpha=1.0,
                 feature_order=qf, topo_order=np.arange(V),
                 est_feat_saved_bytes=0.0, est_topo_saved_bytes=0.0)
    jc = JCache.build_from_host(plan, jds.features, None, None, V)
    sampler = JSampler(jcfg, V)
    seeds = np.asarray(jds.train_ids[:32], np.int32)
    jb, _ = sampler.sample(JWindowed.from_csr(g.to_device(), 16),
                           jnp.asarray(seeds), sampler.init_state(),
                           jax.random.PRNGKey(4))
    xj, hj = JCached(jc, jds.features).fetch(jb.node_ids[:sampler.max_ids])
    model = jax_make_model(JTrainConfig(**tkw), jcfg, 100, 8, in_dim_pad=100)
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
                       cache=CacheConfig(cache_bytes=400 * 100 * 4,
                                         presample_steps=2,
                                         feature_residency="host"),
                       train=TrainConfig(**tkw),
                       mesh=MeshConfig.for_devices(1))
    tr = Trainer(ds, cfg, device="cpu")
    assert tr.feat_pad == 100
    tr.feature_source = CachedFeatureSource(cache_from_jax(jc),
                                            tr.feature_source.host)
    state = tr.init_state()
    assert state["model"].layers[0]["w"].shape == (100, 4, 16)
    state["model"].load_state_dict(params_from_jax(params))
    pb = batch_from_jax(jb)
    nid = pb.node_ids[:tr.sampler_t.max_ids]
    xp, hp = tr.feature_source.fetch(nid)
    np.testing.assert_array_equal(_np(xp), _np(xj))
    # the aligned last hop's lanes (layer 0's K6 input) hit and miss
    ao = tr.sampler_t.config.aligned_hop_offset(1)
    lanes = nid[ao:ao + pb.edge_src[1].shape[0]]
    _, hit = tr.feature_source.cache.find_feat(lanes)
    assert 0 < int(hit.sum()) < int((lanes >= 0).sum())
    assert int(hp) == int(hj)
    loss_p = tr._train_on(state, pb, xp, torch.from_numpy(seeds),
                          tr.train_ybank[:32], key=0)
    assert abs(float(loss_p) - float(loss_j)) <= F32_RTOL * abs(float(loss_j))
    for i in range(2):
        layer = state["model"].layers[i]
        for k in ("w", "attn_l", "attn_r", "b"):
            g_rel = _rel(layer[k].grad, grads_j["layers"][i][k])
            p_rel = _rel(layer[k], new_j["layers"][i][k])
            assert g_rel <= F32_RTOL and p_rel <= F32_RTOL, (i, k, g_rel,
                                                             p_rel)
    tr.close()


@pytest.mark.parametrize("topo_residency", ["hbm", "host"])
def test_cached_trainer_steps_evaluates_and_fits_on_cpu(topo_residency):
    """A Trainer on a host LegionDataset with a partial feature cache
    (and a host topology): the graph stays host numpy arrays (not copied),
    the misses come from the bf16 rows of the features (the cache is
    bf16), train steps are finite, the cache serves some but not all
    fetched slots (last_feat_hits < last_slots), and fit's epoch metrics
    count the same hits."""
    ds = host_synth(num_nodes=3000, avg_degree=20, feature_dim=100,
                    num_classes=8, batch_size=64, train_frac=0.08, seed=0)
    cfg = replace(_tiny_config(ds), cache=CacheConfig(
        presample_steps=3, cache_bytes=300 * 200, feature_residency="host",
        topo_residency=topo_residency))
    tr = Trainer(ds, cfg, device="cpu")
    plan = tr.cache_plan
    assert 0 < plan.feature_capacity < 3000 and tr.feat_pad == 100
    np.testing.assert_array_equal(tr.feature_source.host.array,
                                  bf16_rows(ds.features, bf16_pitch(100)))
    assert tr.setup_s["ram_copy_bytes"] == 0
    if topo_residency == "host":
        assert tr.csr is None
        assert tr.graph_access.host_indptr.array is ds.graph.indptr
    state = tr.init_state()
    for _ in range(2):
        state, loss = tr.train_step(state)
        hits, slots = int(tr.last_feat_hits), int(tr.last_slots)
        assert np.isfinite(float(loss)) and 0 < hits < slots
        assert 0 <= int(tr.last_topo_hits) <= int(tr.last_topo_total) > 0
    state, acc = tr.run_eval(state, Mode.VALID)
    assert 0.0 <= acc <= 1.0 and int(state["total"]) == 60
    state, stats = tr.fit(state, verbose=False)
    sm = tr.epoch_metrics[0]
    assert 0 < sm.feat_hits < sm.feat_total and sm.host_bytes > 0
    assert np.isfinite(stats[0].train_loss) and tr.test_acc is not None
    tr.close()


def test_staged_host_transfer_is_refused():
    """host_transfer="staged" is not refused: it builds the staged
    pipeline and trains one step with a finite loss (1500 nodes, since a
    schedule needs a batch of train seeds; tests/test_torch_staged.py
    holds the pipeline against the zero-copy trainer)."""
    ds = host_synth(num_nodes=1500, avg_degree=8, feature_dim=16,
                    num_classes=4, batch_size=64, seed=0)
    cfg = replace(_tiny_config(ds), cache=CacheConfig(
        cache_bytes=10_000, feature_residency="host",
        host_transfer="staged"))
    tr = Trainer(ds, cfg, device="cpu")
    assert tr._staged_host
    assert 0 < tr._staged.miss_cap <= tr.sampler_t.max_ids
    state, loss = tr.train_step(tr.init_state())
    assert np.isfinite(float(loss)) and state["train_ctr"] == 1
    assert 0 < int(tr.last_feat_hits) < int(tr.last_slots)
    tr.close()


def _tiny_config(ds, **sampler_kw):
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=64,
                              eval_batch_size=64, dedup="sort",
                              neighbor_window=64, dedup_last_hop=False,
                              auto_compact=True, cap_headroom=1.03,
                              **sampler_kw),
        cache=CacheConfig(presample_steps=8),
        train=TrainConfig(hidden_dim=64, epochs=1, dropout=0.5),
        mesh=MeshConfig.for_devices(1))


def test_trainer_steps_and_evaluates_on_cpu():
    """The bench configuration at a tiny size, on a port-generated CPU
    dataset: measured caps, three finite train steps through the public
    API, an eval pass; no kernel was launched (CPU tensors)."""
    ds = synthesize_device_dataset("cpu", num_nodes=3000, num_edges=60000,
                                   feature_dim=100, num_classes=8,
                                   batch_size=64, valid_size=256,
                                   test_size=256)
    kernels.reset_launch_counts()
    tr = Trainer(ds, _tiny_config(ds), device="cpu")
    caps = tr.compact_caps
    assert caps[0] == 64 and all(c % 128 == 0 for c in caps[1:])
    assert tr.feature_source.features.shape == (3000, 128)
    assert tr.feature_source.features.dtype == torch.bfloat16
    state = tr.init_state()
    losses = []
    for _ in range(3):
        state, loss = tr.train_step(state)
        losses.append(float(loss))
        assert 0 < int(tr.last_edges) <= 64 * 25 + tr.sampler_t \
            .frontier_sizes[1] * 10
    assert np.all(np.isfinite(losses)) and state["train_ctr"] == 3
    state, acc = tr.run_eval(state, Mode.VALID)
    assert 0.0 <= acc <= 1.0 and int(state["total"]) == 256
    assert state["valid_ctr"] == tr.schedule.valid_step
    # fit runs the reference schedule: one epoch of train + valid, then test
    state, stats = tr.fit(state, verbose=False)
    assert len(stats) == 1 and np.isfinite(stats[0].train_loss)
    assert state["train_ctr"] == 3 + tr.schedule.train_step
    assert tr.epoch_metrics[0].edges > 0 and tr.test_acc is not None
    assert kernels.LAUNCHES == {k: 0 for k in kernels.LAUNCHES}


def test_default_map_dedup_trainer_steps_evaluates_and_fits_on_cpu():
    """A SamplerConfig that does not name its dedup (so "map", Legion's
    position map) builds a trainer that presamples, steps, evaluates and
    fits on the CPU; the state's [V] map, shared by the train and eval
    samplers, is all INT32_MAX between batches; no kernel was launched."""
    ds = synthesize_device_dataset("cpu", num_nodes=3000, num_edges=60000,
                                   feature_dim=100, num_classes=8,
                                   batch_size=64, valid_size=256,
                                   test_size=256)
    cfg = replace(_tiny_config(ds), sampler=SamplerConfig(
        fanouts=(25, 10), batch_size=64, eval_batch_size=64,
        neighbor_window=64, dedup_last_hop=False, auto_compact=True,
        cap_headroom=1.03))
    assert cfg.sampler.dedup == "map"
    kernels.reset_launch_counts()
    tr = Trainer(ds, cfg, device="cpu")
    assert not tr.sampler_t.sort_dedup and not tr.sampler_e.sort_dedup
    state = tr.init_state()
    pos_map = state["pos_map"]
    assert pos_map.shape == (3000,) and pos_map.dtype == torch.int32

    def clean():
        return state["pos_map"] is pos_map and bool((pos_map == 2**31 - 1)
                                                    .all())
    assert clean()
    for _ in range(3):
        state, loss = tr.train_step(state)
        assert np.isfinite(float(loss)) and int(tr.last_edges) > 0
        assert clean()
    state, acc = tr.run_eval(state, Mode.VALID)
    assert 0.0 <= acc <= 1.0 and int(state["total"]) == 256 and clean()
    state, stats = tr.fit(state, verbose=False)
    assert np.isfinite(stats[0].train_loss) and tr.test_acc is not None
    assert clean()
    assert kernels.LAUNCHES == {k: 0 for k in kernels.LAUNCHES}


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax (and the JAX
    package) out of sys.modules; no source file names them."""
    mods = sorted(
        "legion_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("")
                                       .parts).replace(".__init__", "")
        for p in PKG.rglob("*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'legion_tpu' or "
            "m.startswith('legion_tpu.'))\nprint(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for p in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else [node.module or ""]
                for n in names:
                    root = n.split(".")[0]
                    assert root not in ("jax", "legion_tpu"), (p, n)


def test_kernel_build_has_no_fallback(monkeypatch):
    """Without nvcc the build raises; nothing substitutes a plain path."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()
    # the library is named by a hash of csrc/ and the flags
    assert kernels.library_path().parent == kernels.BUILD_DIR
    assert kernels.library_path() == kernels.library_path()
