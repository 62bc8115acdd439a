"""Helpers shared by the parity tests of the port's models against the JAX
package (``test_torch_gat.py``, ``test_torch_gcn_lp.py``): comparisons,
a sampled batch handed to both packages, and one train step of each."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from legion_tpu.cache.unified_cache import DeviceFeatureSource as JSource
from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.config import TrainConfig as JTrainConfig
from legion_tpu.models import make_model as jax_make_model
from legion_tpu.sampling.access import WindowedCSRAccess as JWindowed
from legion_tpu.sampling.sampler import NeighborSampler as JSampler
from legion_tpu.sampling.sampler import SampleBatch as JBatch
from legion_tpu.train import _masked_ce as jax_masked_ce
from legion_tpu_torch.config import (LegionConfig, MeshConfig, SamplerConfig,
                                     TrainConfig)
from legion_tpu_torch.graph import DeviceCSR
from legion_tpu_torch.sampling.access import WindowedCSRAccess
from legion_tpu_torch.sampling.sampler import NeighborSampler
from legion_tpu_torch.train import Trainer
from legion_tpu_torch.utils.convert import (batch_from_jax, dataset_from_jax,
                                            params_from_jax)

# f32 products and sums in another order
F32_RTOL = 1e-5
# bf16 activations round at other places (and JAX's bf16 gather transpose
# sums in bf16 where the port sums in f32)
BF16_RTOL = 2e-2


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def close(got, ref, rtol, what=""):
    """Max abs error relative to the largest reference value."""
    got, ref = np32(got), np32(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.all(np.isfinite(got)), what
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, (what, err)


def rel(got, ref):
    """Norm-wise relative error ||got - ref|| / ||ref||."""
    got, ref = np32(got), np32(ref)
    assert got.shape == ref.shape
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def tdt(dtype: str):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def jdt(dtype: str):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def batch_and_feats(rng, scfg, V=500, E=8000, in_pad=128, in_dim=100):
    """A batch drawn by the port's sampler on a small power-law graph, the
    same batch as a JAX ``SampleBatch``, and features [max_ids, in_pad]
    (zero pad columns, zero rows for pad ids)."""
    src = rng.integers(0, V, E)
    dst = np.minimum((rng.pareto(1.0, E) * 10).astype(np.int64), V - 1)
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=V), out=indptr[1:])
    csr = DeviceCSR.from_numpy(indptr, dst[order], "cpu")
    sampler = NeighborSampler(scfg, V)
    seeds = torch.from_numpy(rng.choice(V, scfg.batch_size, replace=False)
                             .astype(np.int32))
    pb = sampler.sample(WindowedCSRAccess.from_csr(csr, 16), seeds, 5)
    ids = pb.node_ids.numpy()[:sampler.max_ids]
    x = np.zeros((sampler.max_ids, in_pad), np.float32)
    x[:, :in_dim] = rng.standard_normal((sampler.max_ids, in_dim))
    x[ids < 0] = 0
    jb = JBatch(jnp.asarray(pb.node_ids.numpy()),
                jnp.asarray(pb.num_nodes.numpy()),
                tuple(jnp.asarray(e.numpy()) for e in pb.edge_src),
                tuple(jnp.asarray(e.numpy()) for e in pb.edge_dst),
                jnp.asarray(pb.num_edges.numpy()),
                jnp.asarray(pb.hop_offsets.numpy()))
    return pb, jb, x


def one_train_step(jds, model: str, compute_dtype: str, sampler_kw: dict,
                   bs: int, train_kw: dict = None):
    """JAX's train step (``train.py:601-623``: loss, grads, one Adam
    update) and the port's ``Trainer._train_on`` on the same converted
    dataset, parameters and (injected) JAX batch, dropout 0; ``train_kw``
    overrides the train config (hidden 32, GAT heads (4, 1)). Returns
    (loss_p, loss_j, [(name, grad_p, grad_j, new_p, new_j), ...])."""
    tkw = dict(model=model, hidden_dim=32, dropout=0.0, gat_feat_drop=0.0,
               gat_attn_drop=0.0, gat_heads=(4, 1), lr=3e-3,
               compute_dtype=compute_dtype)
    tkw.update(train_kw or {})
    jcfg = JSamplerConfig(**sampler_kw)
    V = jds.meta.num_nodes
    sampler = JSampler(jcfg, V)
    seeds = np.asarray(jds.train_ids[:bs], np.int32)
    jb, _ = sampler.sample(JWindowed.from_csr(jds.csr, 16),
                           jnp.asarray(seeds), sampler.init_state(),
                           jax.random.PRNGKey(4))
    feats = jds.features.astype(jdt(compute_dtype))
    feats = jnp.pad(feats, ((0, 0), (0, 28)))
    xj, _ = JSource(feats).fetch(jb.node_ids[:sampler.max_ids])
    jm = jax_make_model(JTrainConfig(**tkw), jcfg, 100, 8, in_dim_pad=128)
    params = jm.init(jax.random.PRNGKey(0))
    y = np.asarray(jds.labels)[seeds]
    valid = jnp.asarray(seeds >= 0)

    def loss_fn(p):
        if model == "lp_sage":
            return jm.loss(p, xj, jb, valid, train=True, rng=None)
        logits = jm.apply(p, xj, jb, train=True, rng=None)
        return jax_masked_ce(logits, jnp.asarray(y), valid)

    tx = optax.adam(3e-3)

    @jax.jit
    def jax_step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    loss_j, grads_j, new_j = jax_step(params)

    ds = dataset_from_jax(jds)
    cfg = LegionConfig(dataset=ds.meta, sampler=SamplerConfig(**sampler_kw),
                       train=TrainConfig(**tkw),
                       mesh=MeshConfig.for_devices(1))
    tr = Trainer(ds, cfg, device="cpu")
    state = tr.init_state()
    state["model"].load_state_dict(params_from_jax(params))
    pb = batch_from_jax(jb)
    xp, _ = tr.feature_source.fetch(pb.node_ids[:tr.sampler_t.max_ids])
    np.testing.assert_array_equal(np32(xp), np32(xj))
    loss_p = tr._train_on(state, pb, xp, torch.from_numpy(seeds),
                          tr.train_ybank[:bs], key=0)
    out = []
    for i, layer in enumerate(state["model"].layers):
        for k in layer:
            out.append((f"layer {i} {k}", layer[k].grad,
                        grads_j["layers"][i][k], layer[k],
                        new_j["layers"][i][k]))
    return float(loss_p), float(loss_j), out


def inject_masks(monkeypatch, modules, folds, words, shapes=None):
    """Make the JAX package's ``dropout`` (as ``modules`` name it) draw the
    port's keep masks and leave the scaling to JAX's own arithmetic: call
    i with a positive rate in training draws ``keep_mask_plain(x.shape,
    rate, words, folds[i])`` (a feature layer's fold is the layer, an
    attention layer's ``attn_fold(layer)``), handed to JAX's ``dropout``
    as the bits its regime reads (the mask packed 32 lanes a word for the
    bit-unpacked regime, uint8 0 or 255 for the u8 regime's compare below
    kq, the mask itself for ``bernoulli``). Returns the list
    of (shape, fold) applied, in call order."""
    import legion_tpu.models.common as jcommon
    from legion_tpu_torch.ops.dropout import keep_mask_plain
    orig = jcommon.dropout
    applied = []

    def fixed(x, rate, key, train):
        if not train or rate <= 0.0 or key is None:
            return x
        fold = folds[len(applied)]
        shape = tuple(x.shape)
        applied.append((shape, fold))
        mask = jnp.asarray(keep_mask_plain(shape, rate, words, fold).numpy())
        def bits(k, s, dtype):
            if dtype == jnp.uint32:        # the bit-unpacked regime
                b = mask.reshape(tuple(s) + (32,)).astype(jnp.uint32)
                return jnp.sum(b << jnp.arange(32, dtype=jnp.uint32),
                               axis=-1, dtype=jnp.uint32)
            return jnp.where(mask, 0, 255).astype(dtype)

        with monkeypatch.context() as m:
            m.setattr(jax.random, "bits", bits)
            m.setattr(jax.random, "bernoulli", lambda k, p, s: mask)
            return orig(x, rate, key, train)

    for module in modules:
        monkeypatch.setattr(module, "dropout", fixed)
    return applied
