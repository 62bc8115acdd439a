"""Parity of the port's GCN and link-prediction SAGE with the JAX package,
on the CPU: ``gcn_layer_apply`` in both branches, the block out-degree,
the whole GCN, ``LinkPredSAGE.loss``, one train step of each model, the
parameter converter for all four models, and an ``lp_sage`` trainer that
steps, evaluates and fits. Inputs are made with numpy from a seed.

Tolerances (``tests/test_torch_parity.py``): F32_RTOL = 1e-5 and
BF16_RTOL = 2e-2, the max abs error relative to the largest reference
value; the train step compares norm-wise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.config import TrainConfig as JTrainConfig
from legion_tpu.data.device_synthetic import synthesize_device_dataset \
    as jax_synth
from legion_tpu.models import gcn as jgcn
from legion_tpu.models import make_model as jax_make_model
from legion_tpu_torch.config import (LegionConfig, MeshConfig, SamplerConfig,
                                     TrainConfig)
from legion_tpu_torch.data import synthesize_device_dataset
from legion_tpu_torch.models.common import make_model
from legion_tpu_torch.models.gcn import GCN, block_out_degree, gcn_layer_apply
from legion_tpu_torch.pipeline import Mode
from legion_tpu_torch.train import Trainer
from legion_tpu_torch.utils.convert import params_from_jax
from test_torch_parity import (BF16_RTOL, F32_RTOL, batch_and_feats, close,
                               jdt, one_train_step, rel, tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", ["project_first", "aggregate_first",
                                    "aligned"])
def test_gcn_layer_apply_matches_jax(branch, dtype):
    """Both orderings on a gathered hop (out-degree through K2's plain
    version) and the aligned hop: output and gradients for w, b and
    h_src. In bf16 JAX rounds the degree's rsqrt to bf16 where the port
    keeps it in f32."""
    rng = np.random.default_rng(0)
    fanout, F = 4, 30
    num_dst, offset = 50, 20
    d_in, d_out = {"project_first": (64, 16), "aggregate_first": (16, 64),
                   "aligned": (32, 16)}[branch]
    n_src = num_dst + fanout * F
    if branch == "aligned":
        src_l = num_dst + np.arange(fanout * F, dtype=np.int32)
        aoff = num_dst
    else:
        src_l = rng.integers(0, n_src, fanout * F).astype(np.int32)
        aoff = None
    src_l[rng.random(fanout * F) < 0.2] = -1
    h = rng.standard_normal((n_src, d_in)).astype(np.float32)
    p = {"w": 0.1 * rng.standard_normal((d_in, d_out)).astype(np.float32),
         "b": rng.standard_normal((d_out,)).astype(np.float32)}
    w = rng.standard_normal((num_dst, d_out)).astype(np.float32)

    def jfn(params, hh):
        out = jgcn.gcn_layer_apply(params, hh, jnp.asarray(src_l), fanout,
                                   jnp.int32(offset), num_dst, aoff)
        return jnp.sum(out * w), out

    (_, out_j), (gp_j, gh_j) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(h, jdt(dtype)))
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    ht = torch.from_numpy(h).to(tdt(dtype)).requires_grad_()
    out_p = gcn_layer_apply(pt, ht, torch.from_numpy(src_l), fanout,
                            torch.tensor(offset, dtype=torch.int32), num_dst,
                            aoff)
    (out_p * torch.from_numpy(w)).sum().backward()
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    close(out_p, out_j, tol, "out")
    close(ht.grad, gh_j, tol, "d h_src")
    for k in p:
        close(pt[k].grad, gp_j[k], tol, f"d {k}")


def test_gcn_out_degree_is_exact_past_bf16():
    """A block in which one source row is read by 300 lanes (a bf16 sum
    stops at 256): the out-degree is the exact count, in f32."""
    rng = np.random.default_rng(1)
    n_src, E = 400, 1200
    src = rng.integers(0, n_src, E).astype(np.int32)
    src[:300] = 7
    src[300:] = np.where(src[300:] == 7, 8, src[300:])
    src[rng.random(E) < 0.1] = -1
    deg = block_out_degree(torch.from_numpy(src), n_src)
    ref = np.bincount(src[src >= 0], minlength=n_src)
    assert deg.dtype == torch.float32 and int(deg[7]) == int(ref[7]) > 256
    np.testing.assert_array_equal(deg.numpy(), ref.astype(np.float32))


def _model_case(rng, dedup_last_hop):
    kw = dict(fanouts=(6, 4), batch_size=30, dedup="sort",
              neighbor_window=16, dedup_last_hop=dedup_last_hop,
              node_caps=(30, 160, 640 if dedup_last_hop else 0))
    scfg, jcfg = SamplerConfig(**kw), JSamplerConfig(**kw)
    pb, jb, x = batch_and_feats(rng, scfg)
    return scfg, jcfg, pb, jb, x


def test_gcn_forward_and_grads_match_jax():
    """GCN with exact last-hop dedup (gathered hops, K2 out-degree) and
    JAX's initial parameters: logits and every gradient, f32."""
    rng = np.random.default_rng(2)
    scfg, jcfg, pb, jb, x = _model_case(rng, True)
    jm = jgcn.GCN(jcfg, 100, 32, 10, in_dim_pad=128)
    params = jm.init(jax.random.PRNGKey(0))
    pm = GCN(scfg, 100, 32, 10, device="cpu", in_dim_pad=128)
    pm.load_state_dict(params_from_jax(params))
    w = rng.standard_normal((30, 10)).astype(np.float32)

    def jfn(p):
        logits = jm.apply(p, jnp.asarray(x), jb)
        return jnp.sum(logits * w), logits

    (_, lj), gj = jax.jit(jax.value_and_grad(jfn, has_aux=True))(params)
    pm.eval()
    lp = pm(torch.from_numpy(x), pb, scfg)
    (lp * torch.from_numpy(w)).sum().backward()
    close(lp, lj, F32_RTOL, "logits")
    for i, layer in enumerate(gj["layers"]):
        for k in layer:
            close(pm.layers[i][k].grad, layer[k], F32_RTOL, f"layer {i} {k}")


def test_gcn_warns_on_an_aligned_last_hop():
    scfg = SamplerConfig(fanouts=(6, 4), batch_size=30,
                         dedup_last_hop=False)
    with pytest.warns(UserWarning, match="norm='both'"):
        GCN(scfg, 100, 32, 10, device="cpu")


def test_lp_sage_loss_matches_jax():
    """``LinkPredSAGE.loss`` over (anchor, positive, negative) thirds with
    some invalid anchors: the loss and every gradient, f32."""
    rng = np.random.default_rng(3)
    scfg, jcfg, pb, jb, x = _model_case(rng, False)
    tkw = dict(model="lp_sage", hidden_dim=32, dropout=0.5)
    jm = jax_make_model(JTrainConfig(**tkw), jcfg, 100, 10, in_dim_pad=128)
    params = jm.init(jax.random.PRNGKey(0))
    pm = make_model(TrainConfig(**tkw), scfg, 100, 10, device="cpu",
                    in_dim_pad=128)
    pm.load_state_dict(params_from_jax(params))
    valid = np.ones(30, bool)
    valid[[2, 5]] = False

    def jfn(p):
        return jm.loss(p, jnp.asarray(x), jb, jnp.asarray(valid),
                       train=False)

    lj, gj = jax.jit(jax.value_and_grad(jfn))(params)
    pm.eval()
    lp = pm.loss(torch.from_numpy(x), pb, scfg, torch.from_numpy(valid))
    lp.backward()
    close(lp, lj, F32_RTOL, "loss")
    for i, layer in enumerate(gj["layers"]):
        for k in layer:
            close(pm.layers[i][k].grad, layer[k], F32_RTOL, f"layer {i} {k}")


@pytest.fixture(scope="module")
def jax_dataset():
    return jax_synth(num_nodes=2000, num_edges=40000, feature_dim=100,
                     num_classes=8, batch_size=30, valid_size=256,
                     test_size=256, seed=1)


@pytest.mark.parametrize("model,compute_dtype,dedup_last_hop",
                         [("gcn", "float32", True),
                          ("gcn", "bfloat16", True),
                          ("lp_sage", "float32", False)])
def test_one_train_step_matches_jax(jax_dataset, model, compute_dtype,
                                    dedup_last_hop):
    """``Trainer._train_on`` on JAX's batch and parameters, dropout 0:
    loss, gradients and Adam-updated parameters (GCN with exact last-hop
    dedup, lp_sage over batch thirds)."""
    kw = dict(fanouts=(5, 3), batch_size=30, eval_batch_size=30,
              dedup="sort", neighbor_window=16,
              dedup_last_hop=dedup_last_hop,
              node_caps=(30, 128, 384 if dedup_last_hop else 0))
    loss_p, loss_j, pairs = one_train_step(jax_dataset, model,
                                           compute_dtype, kw, 30)
    tol = F32_RTOL if compute_dtype == "float32" else BF16_RTOL
    assert abs(loss_p - loss_j) <= tol * abs(loss_j)
    for name, gp, gj, npar, nj in pairs:
        assert rel(gp, gj) <= tol and rel(npar, nj) <= tol, name


@pytest.mark.parametrize("model", ["graphsage", "gcn", "gat", "lp_sage"])
def test_params_from_jax_round_trip(model):
    """JAX's parameters -> ``params_from_jax`` -> the port's model built
    by ``make_model`` (strict load, same shapes) -> ``state_dict`` -> the
    same forward as JAX's, f32."""
    rng = np.random.default_rng(4)
    scfg, jcfg, pb, jb, x = _model_case(rng, model == "gcn")
    tkw = dict(model=model, hidden_dim=16, gat_heads=(2, 1),
               compute_dtype="float32")
    jm = jax_make_model(JTrainConfig(**tkw), jcfg, 100, 10, in_dim_pad=128)
    params = jm.init(jax.random.PRNGKey(1))
    pm = make_model(TrainConfig(**tkw), scfg, 100, 10, device="cpu",
                    in_dim_pad=128)
    pm.load_state_dict(params_from_jax(params), strict=True)
    sd = pm.state_dict()
    for i, layer in enumerate(params["layers"]):
        for k, v in layer.items():
            np.testing.assert_array_equal(sd[f"layers.{i}.{k}"].numpy(),
                                          np.asarray(v))
    pm.eval()
    lj = jax.jit(lambda p: jm.apply(p, jnp.asarray(x), jb))(params)
    close(pm(torch.from_numpy(x), pb, scfg), lj, F32_RTOL, model)


def test_lp_sage_trainer_steps_evaluates_and_fits_on_cpu():
    """The bench's lp_sage settings at a tiny size (batches in thirds):
    finite train steps, an eval pass whose metric is the mean loss over
    valid anchors (f32 counters), and ``fit``. Batches that do not divide
    into thirds are refused."""
    ds = synthesize_device_dataset("cpu", num_nodes=3000, num_edges=60000,
                                   feature_dim=100, num_classes=8,
                                   batch_size=63, valid_size=126,
                                   test_size=126)
    scfg = SamplerConfig(fanouts=(25, 10), batch_size=63,
                         eval_batch_size=42, dedup="sort",
                         neighbor_window=64, dedup_last_hop=False,
                         auto_compact=True, cap_headroom=1.03)
    cfg = LegionConfig(dataset=ds.meta, sampler=scfg,
                       train=TrainConfig(model="lp_sage", hidden_dim=32,
                                         epochs=1, dropout=0.5),
                       mesh=MeshConfig.for_devices(1))
    tr = Trainer(ds, cfg, device="cpu")
    state = tr.init_state()
    assert state["correct"].dtype == torch.float32
    for _ in range(2):
        state, loss = tr.train_step(state)
        assert np.isfinite(float(loss)) and float(loss) > 0
    state, metric = tr.run_eval(state, Mode.VALID)
    # 126 valid seeds in batches of 42: 14 anchors per batch
    assert float(state["total"]) == 42.0 and metric > 0
    state, stats = tr.fit(state, verbose=False)
    assert np.isfinite(stats[0].train_loss) and np.isfinite(tr.test_acc)
    from dataclasses import replace
    with pytest.raises(ValueError, match="thirds"):
        Trainer(ds, replace(cfg, sampler=replace(scfg, batch_size=64)),
                device="cpu")
