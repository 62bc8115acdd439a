"""Parity of the port's GraphSAGE with the JAX package, on the CPU: one
layer in each branch, then the whole model with converted parameters,
forward and gradients, f32 and bf16. Inputs come from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.models import graphsage as jsage
from legion_tpu.sampling.sampler import SampleBatch as JBatch
from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.graph import DeviceCSR
from legion_tpu_torch.models.common import xavier_uniform_padded
from legion_tpu_torch.ops.dropout import dropout_act
from legion_tpu_torch.models.graphsage import GraphSAGE, sage_layer_apply
from legion_tpu_torch.sampling.access import WindowedCSRAccess
from legion_tpu_torch.sampling.sampler import NeighborSampler
from legion_tpu_torch.utils.convert import params_from_jax

# f32 products and sums in another order: relative to the largest value
F32_RTOL = 1e-5
# bf16 activations round at other places (and JAX's bf16 gather
# transpose sums in bf16): relative to the largest value
BF16_RTOL = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, ref, rtol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", ["project_first", "aligned",
                                    "mean_first"])
def test_sage_layer_apply_matches_jax(branch, dtype):
    rng = np.random.default_rng(0)
    fanout, F = 4, 30
    num_dst, offset = 50, 20
    d_in, d_out = {"project_first": (256, 32), "aligned": (128, 256),
                   "mean_first": (64, 32)}[branch]
    n_src = num_dst + fanout * F
    if branch == "aligned":
        src_l = num_dst + np.arange(fanout * F, dtype=np.int32)
        aoff = num_dst
    else:
        src_l = rng.integers(0, n_src, fanout * F).astype(np.int32)
        aoff = None
    src_l[rng.random(fanout * F) < 0.2] = -1
    h = rng.standard_normal((n_src, d_in)).astype(np.float32)
    p = {"w_self": rng.standard_normal((d_in, d_out)).astype(np.float32)
         * 0.1,
         "w_neigh": rng.standard_normal((d_in, d_out)).astype(np.float32)
         * 0.1,
         "b": rng.standard_normal((d_out,)).astype(np.float32)}
    w = rng.standard_normal((num_dst, d_out)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jfn(params, hh):
        out = jsage.sage_layer_apply(params, hh, jnp.asarray(src_l), fanout,
                                     jnp.int32(offset), num_dst, aoff)
        return jnp.sum(out * w), out

    (_, out_j), (gp_j, gh_j) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h, jdt))
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    ht = torch.from_numpy(h).to(tdt).requires_grad_()
    out_p = sage_layer_apply(pt, ht, torch.from_numpy(src_l), fanout,
                             torch.tensor(offset, dtype=torch.int32),
                             num_dst, aoff)
    (out_p * torch.from_numpy(w)).sum().backward()
    assert out_p.dtype == torch.float32
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    _close(out_p, out_j, tol, "out")
    _close(ht.grad, gh_j, tol, "d h_src")
    for k in p:
        _close(pt[k].grad, gp_j[k], tol, f"d {k}")


def _batch_and_feats(rng, scfg, V=500, E=8000, in_pad=128, in_dim=100):
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


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_graphsage_forward_and_grads_match_jax(compute_dtype):
    """GraphSAGE.apply with JAX's initial params (converted by
    params_from_jax): logits and every parameter gradient."""
    kw = dict(fanouts=(6, 4), batch_size=32, dedup="sort",
              neighbor_window=16, dedup_last_hop=False,
              node_caps=(32, 160, 0))
    scfg, jcfg = SamplerConfig(**kw), JSamplerConfig(**kw)
    rng = np.random.default_rng(1)
    pb, jb, x = _batch_and_feats(rng, scfg)
    classes = 10
    jm = jsage.GraphSAGE(jcfg, 100, 256, classes, dropout=0.5,
                         compute_dtype=compute_dtype, in_dim_pad=128)
    params = jm.init(jax.random.PRNGKey(0))
    pm = GraphSAGE(100, 256, classes, num_layers=2, device="cpu",
                   dropout=0.5, compute_dtype=compute_dtype, in_dim_pad=128)
    pm.load_state_dict(params_from_jax(params))
    xdt_j = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    xdt_t = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    w = rng.standard_normal((32, classes)).astype(np.float32)

    def jfn(p):
        logits = jm.apply(p, jnp.asarray(x, xdt_j), jb, train=False)
        return jnp.sum(logits * w), logits

    (_, lj), gj = jax.jit(jax.value_and_grad(jfn, has_aux=True))(params)
    pm.eval()
    lp = pm(torch.from_numpy(x).to(xdt_t), pb, scfg)
    (lp * torch.from_numpy(w)).sum().backward()
    tol = F32_RTOL if compute_dtype == "float32" else BF16_RTOL
    _close(lp, lj, tol, "logits")
    for i, layer in enumerate(gj["layers"]):
        for k in ("w_self", "w_neigh", "b"):
            _close(pm.layers[i][k].grad, layer[k], tol, f"layer {i} {k}")
    # layer 0's pad rows see zero features: zero gradient, as in JAX
    assert torch.all(pm.layers[0]["w_self"].grad[100:] == 0)


@pytest.mark.parametrize("shape,rate", [((64, 256), 0.5),
                                        ((1024, 1024), 0.3),
                                        ((64, 100), 0.3)])
def test_dropout_regimes(shape, rate):
    """Bit-unpacked (rate 1/2), u8-threshold (>= 2**20 elements) and
    per-element regimes of the keyed dropout (``ops/dropout.py``): kept
    entries are scaled by 1/keep (by the quantised keep in the u8 regime),
    the kept share ~ keep, the masks follow the key words and the layer,
    and eval mode (or no key) is the identity."""
    x = torch.ones(shape)
    words = torch.tensor([12345, -678], dtype=torch.int32)
    y = dropout_act(x, "none", None, rate, words, 0)
    assert torch.equal(y, dropout_act(x, "none", None, rate, words, 0))
    assert not torch.equal(y, dropout_act(x, "none", None, rate, words, 1))
    keep = 1 - rate
    scale = 256 / round(keep * 256) if x.numel() >= (1 << 20) \
        and rate != 0.5 else 1 / keep
    vals = set(np.unique(y.numpy()).tolist())
    assert vals <= {0.0, np.float32(scale)}, vals
    frac = float((y != 0).float().mean())
    assert abs(frac - keep) < 4 * np.sqrt(keep * (1 - keep) / x.numel())
    assert dropout_act(x, "none", None, rate, words, 0, train=False) is x
    assert dropout_act(x, "none", None, rate, None, 0) is x


def test_xavier_uniform_padded():
    g = torch.Generator()
    g.manual_seed(0)
    w = xavier_uniform_padded(100, 128, (256,), g, gain=2 ** 0.5)
    bound = 2 ** 0.5 * np.sqrt(6 / (100 + 256))
    assert w.shape == (128, 256) and torch.all(w[100:] == 0)
    assert float(w[:100].abs().max()) <= bound
    assert float(w[:100].abs().max()) > 0.9 * bound
