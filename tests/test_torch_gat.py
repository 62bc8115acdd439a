"""Parity of the port's GAT with the JAX package, on the CPU: the plain
versions of K7 (against ``hop_softmax_attention``'s dense and chunked
branches, gathered and aligned hops) and K6 (inside
``gat_layer_aligned_streaming``), ``gat_layer_apply``, the whole model,
and one train step. The CUDA kernels
are held against these same plain versions on the card by
``chip_smoke.py``. Attention dropout is held by injection: the port's
keep mask, drawn from the step's dropout key at the attention fold, goes
into the JAX package's ``dropout``, which scales it by its own arithmetic
(regime 3 below 2^20 alpha entries, regime 2 from there). Inputs are made
with numpy from a seed.

Tolerances (``tests/test_torch_parity.py``): F32_RTOL = 1e-5 and
BF16_RTOL = 2e-2, the max abs error relative to the largest reference
value; the train step compares norm-wise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legion_tpu.models.common as jcommon
import legion_tpu.models.gat as jgat
from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.data.device_synthetic import synthesize_device_dataset \
    as jax_synth
from legion_tpu.ops import hop_agg as jhop
from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.models.gat import (GAT, gat_layer_aligned_streaming,
                                         gat_layer_apply)
from legion_tpu_torch.ops import hop_agg
from legion_tpu_torch.ops.dropout import AttnDrop, attn_fold, regime
from legion_tpu_torch.utils.convert import params_from_jax
from test_torch_parity import (BF16_RTOL, F32_RTOL, batch_and_feats, close,
                               inject_masks, jdt, one_train_step, rel, tdt)

RATE = 0.6          # attention dropout rate of the injected masks
WORDS = torch.tensor([0x5A17, -0x33C0FFE], dtype=torch.int32)


def _lanes(rng, fanout, F, n_src, aligned_offset=None, dead_row=3):
    """fanout-major lane sources with 20% pads and one row (``dead_row``)
    that has no valid lane at all."""
    E = fanout * F
    if aligned_offset is not None:
        src = (aligned_offset + np.arange(E)).astype(np.int32)
    else:
        src = rng.integers(0, n_src, E).astype(np.int32)
    src[rng.random(E) < 0.2] = -1
    src[dead_row::F] = -1
    return src


def _inject(monkeypatch, shape, layer=1):
    """Give the JAX package's attention dropout (``gat.py``'s and, through
    ``hop_agg.py``'s import, ``common.py``'s ``dropout``) the port's keep
    mask of attention layer ``layer`` for alpha of ``shape``, drawn from
    WORDS, and leave the scaling to JAX; returns the port's AttnDrop and
    the list of (shape, fold) JAX applied."""
    applied = inject_masks(monkeypatch, (jgat, jcommon), [attn_fold(layer)],
                           WORDS)
    return AttnDrop(WORDS, layer, RATE), applied


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hop", ["gathered", "aligned"])
@pytest.mark.parametrize("branch", ["dense", "chunked"])
def test_hop_softmax_attention_matches_jax(branch, hop, dtype):
    """K7's plain version == ``hop_softmax_attention`` in both of JAX's
    branches (``dense_limit`` goes to JAX only: the port has one plain
    path): the output (f32) and the gradients for z and the scores. A row
    with no valid lane gives zeros."""
    rng = np.random.default_rng(0)
    fanout, F, H, d = 5, 12, 2, 8
    num_dst, offset = 30, 6
    n_src = num_dst + fanout * F
    aoff = num_dst if hop == "aligned" else None
    src = _lanes(rng, fanout, F, n_src, aoff)
    z = rng.standard_normal((n_src, H, d)).astype(np.float32)
    scores = 2 * rng.standard_normal((fanout, F, H)).astype(np.float32)
    w = rng.standard_normal((num_dst, H, d)).astype(np.float32)
    limit = 1 if branch == "chunked" else None
    # JAX's chunked branch slices at aligned_offset + f*F next to a literal
    # 0, which x64 makes int64: the offset must be 64-bit there too
    aoff_j = None if aoff is None else np.int64(aoff)

    def jfn(zz, ss):
        out = jhop.hop_softmax_attention(zz, ss, jnp.asarray(src), fanout,
                                         jnp.int32(offset), num_dst,
                                         aligned_offset=aoff_j,
                                         dense_limit=limit)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, out_j), (gz_j, gs_j) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(z, jdt(dtype)),
                                           jnp.asarray(scores))
    zt = torch.from_numpy(z).to(tdt(dtype)).requires_grad_()
    st = torch.from_numpy(scores).requires_grad_()
    out_p = hop_agg.hop_softmax_attention(
        zt, st, torch.from_numpy(src), fanout,
        torch.tensor(offset, dtype=torch.int32), num_dst, None, aoff)
    (out_p * torch.from_numpy(w)).sum().backward()
    assert out_p.dtype == torch.float32
    assert torch.all(out_p[offset + 3] == 0)
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    close(out_p, out_j, tol, "out")
    close(zt.grad, gz_j, tol, "d z")
    close(st.grad, gs_j, tol, "d scores")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,d,fanout,hop", [
    (1, 32, 25, "gathered"), (2, 8, 1, "aligned"), (8, 64, 32, "gathered"),
    (16, 33, 33, "aligned"), (1, 256, 64, "gathered"),
    (8, 32, 33, "gathered"), (2, 64, 32, "aligned")])
def test_hop_softmax_attention_plain_matches_jax_at_kernel_edges(
        H, d, fanout, hop, dtype):
    """K7's plain version against ``hop_softmax_attention`` at heads, head
    widths and fanouts that ``chip_smoke.py`` holds the kernel to on the
    card, on both sides of its small-row kernels' shapes (fanout <= 32, a
    head's slice of a row 16 to 128 bytes): output and gradients for z
    and the scores, F32_RTOL in f32 and BF16_RTOL in bf16."""
    rng = np.random.default_rng(7)
    F, num_dst, offset = 6, 12, 4
    n_src = num_dst + fanout * F
    aoff = num_dst if hop == "aligned" else None
    src = _lanes(rng, fanout, F, n_src, aoff)
    z = rng.standard_normal((n_src, H, d)).astype(np.float32)
    scores = 2 * rng.standard_normal((fanout, F, H)).astype(np.float32)
    w = rng.standard_normal((num_dst, H, d)).astype(np.float32)

    def jfn(zz, ss):
        out = jhop.hop_softmax_attention(zz, ss, jnp.asarray(src), fanout,
                                         jnp.int32(offset), num_dst,
                                         aligned_offset=aoff)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, out_j), (gz_j, gs_j) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(z, jdt(dtype)),
                                           jnp.asarray(scores))
    zt = torch.from_numpy(z).to(tdt(dtype)).requires_grad_()
    st = torch.from_numpy(scores).requires_grad_()
    out_p = hop_agg.hop_softmax_attention_plain(
        zt, st, torch.from_numpy(src), fanout,
        torch.tensor(offset, dtype=torch.int32), num_dst, None, aoff)
    (out_p * torch.from_numpy(w)).sum().backward()
    assert torch.all(out_p[offset + 3] == 0)
    assert torch.all(out_p[:offset] == 0) and torch.all(
        out_p[offset + F:] == 0)
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    close(out_p, out_j, tol, "out")
    close(zt.grad, gz_j, tol, "d z")
    close(st.grad, gs_j, tol, "d scores")


# alpha shapes (fanout, F, H) and head width d of each dropout regime:
# fewer than 2^20 alpha entries (per entry) and 2^20 (u8 bytes)
ATTN_REGIMES = {3: ((4, 10, 2), 8), 2: ((4, 1 << 18, 1), 1)}


@pytest.mark.parametrize("reg", [3, 2])
def test_hop_softmax_attention_dropout_matches_jax(reg, monkeypatch):
    """K7's plain version with attention dropout drawn from the key (the
    attention fold of layer 1) against JAX's ``hop_softmax_attention``
    with that mask injected into its ``dropout``, in regime 3 and in
    regime 2 (2^20 alpha entries at d = 1): output and gradients, F32_RTOL."""
    rng = np.random.default_rng(1)
    (fanout, F, H), d = ATTN_REGIMES[reg]
    assert regime((fanout, F, H), RATE) == reg
    num_dst, offset = F + 14, 4
    n_src = num_dst + fanout * F
    src = _lanes(rng, fanout, F, n_src)
    drop, applied = _inject(monkeypatch, (fanout, F, H))
    z = rng.standard_normal((n_src, H, d)).astype(np.float32)
    scores = rng.standard_normal((fanout, F, H)).astype(np.float32)
    w = rng.standard_normal((num_dst, H, d)).astype(np.float32)

    def jfn(zz, ss):
        out = jhop.hop_softmax_attention(zz, ss, jnp.asarray(src), fanout,
                                         jnp.int32(offset), num_dst, RATE,
                                         True, jax.random.PRNGKey(0))
        return jnp.sum(out * w), out

    (_, out_j), (gz_j, gs_j) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(z),
                                           jnp.asarray(scores))
    assert applied == [((fanout, F, H), attn_fold(1))]
    zt = torch.from_numpy(z).requires_grad_()
    st = torch.from_numpy(scores).requires_grad_()
    out_p = hop_agg.hop_softmax_attention(
        zt, st, torch.from_numpy(src), fanout,
        torch.tensor(offset, dtype=torch.int32), num_dst, drop)
    (out_p * torch.from_numpy(w)).sum().backward()
    close(out_p, out_j, F32_RTOL, "out")
    close(zt.grad, gz_j, F32_RTOL, "d z")
    close(st.grad, gs_j, F32_RTOL, "d scores")


def _gat_params(rng, d_in, H, d_out):
    return {"w": 0.3 * rng.standard_normal((d_in, H, d_out)),
            "attn_l": rng.standard_normal((H, d_out)),
            "attn_r": rng.standard_normal((H, d_out)),
            "b": rng.standard_normal((H, d_out))}


@pytest.mark.parametrize("drop", [False, True, "u8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_layer_aligned_streaming_matches_jax(dtype, drop, monkeypatch):
    """K6's plain version inside the aligned layer: output and gradients
    for w, attn_l, attn_r and b, without attention dropout and with it,
    drawn from the key and injected into JAX's ``dropout``: regime 3
    (True: 120 alpha entries) and regime 2 ("u8": 2^20 entries at d_in 4),
    F32_RTOL in f32 and BF16_RTOL in bf16."""
    rng = np.random.default_rng(2)
    fanout, F, H, d_in, d_out = (4, 1 << 16, 4, 4, 2) if drop == "u8" \
        else (4, 10, 3, 16, 8)
    num_dst, offset = F + 15, 5
    n_src = num_dst + fanout * F
    src = _lanes(rng, fanout, F, n_src, num_dst)
    h = rng.standard_normal((n_src, d_in)).astype(np.float32)
    p = {k: v.astype(np.float32) for k, v in
         _gat_params(rng, d_in, H, d_out).items()}
    w_out = rng.standard_normal((num_dst, H, d_out)).astype(np.float32)
    adrop, applied = _inject(monkeypatch, (fanout, F, H), 0) if drop \
        else (None, [])
    if drop:
        assert regime((fanout, F, H), RATE) == (2 if drop == "u8" else 3)
    cdt_j = jnp.bfloat16 if dtype == "bfloat16" else None

    def jfn(params):
        out = jgat.gat_layer_aligned_streaming(
            params, jnp.asarray(h, jdt(dtype)), jnp.asarray(src), fanout,
            jnp.int32(offset), num_dst, num_dst, 0.2, RATE, bool(drop),
            jax.random.PRNGKey(0), cdt_j)
        return jnp.sum(out * w_out), out

    # eager, not jit: XLA's fusion drops some of the bf16 roundings of the
    # op-by-op program, which the port mirrors
    (_, out_j), g_j = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})
    assert applied == ([((fanout, F, H), attn_fold(0))] if drop else [])
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    out_p = gat_layer_aligned_streaming(
        pt, torch.from_numpy(h).to(tdt(dtype)), torch.from_numpy(src),
        fanout, torch.tensor(offset, dtype=torch.int32), num_dst, num_dst,
        0.2, adrop, torch.bfloat16 if dtype == "bfloat16" else None)
    (out_p * torch.from_numpy(w_out)).sum().backward()
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    close(out_p, out_j, tol, "out")
    for k in p:
        close(pt[k].grad, g_j[k], tol, f"d {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,d_in,fanout", [(3, 100, 10), (1, 128, 1),
                                           (8, 128, 10), (8, 100, 33),
                                           (8, 100, 10)])
def test_gat_attend_plain_matches_jax_at_kernel_edges(H, d_in, fanout, dtype,
                                                      monkeypatch):
    """K6's plain version inside the aligned layer at the heads, widths and
    fanouts that ``chip_smoke.py`` holds the kernel to on the card (inside
    and outside its tensor-core forms; (8, 100, 10) is GAT-H's layer 0),
    with attention dropout drawn from the key and injected into JAX's
    ``dropout``: output and gradients, F32_RTOL in f32 and BF16_RTOL in
    bf16."""
    rng = np.random.default_rng(5)
    F, d_out = 10, 8
    num_dst, offset = 25, 5
    n_src = num_dst + fanout * F
    src = _lanes(rng, fanout, F, n_src, num_dst)
    h = rng.standard_normal((n_src, d_in)).astype(np.float32)
    p = {k: v.astype(np.float32) for k, v in
         _gat_params(rng, d_in, H, d_out).items()}
    p["w"] *= (16 / d_in) ** 0.5        # scores of order one at any width
    w_out = rng.standard_normal((num_dst, H, d_out)).astype(np.float32)
    adrop, _ = _inject(monkeypatch, (fanout, F, H), 0)
    cdt_j = jnp.bfloat16 if dtype == "bfloat16" else None

    def jfn(params):
        out = jgat.gat_layer_aligned_streaming(
            params, jnp.asarray(h, jdt(dtype)), jnp.asarray(src), fanout,
            jnp.int32(offset), num_dst, num_dst, 0.2, RATE, True,
            jax.random.PRNGKey(0), cdt_j)
        return jnp.sum(out * w_out), out

    (_, out_j), g_j = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    out_p = gat_layer_aligned_streaming(
        pt, torch.from_numpy(h).to(tdt(dtype)), torch.from_numpy(src),
        fanout, torch.tensor(offset, dtype=torch.int32), num_dst, num_dst,
        0.2, adrop, torch.bfloat16 if dtype == "bfloat16" else None)
    (out_p * torch.from_numpy(w_out)).sum().backward()
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    close(out_p, out_j, tol, "out")
    for k in p:
        close(pt[k].grad, g_j[k], tol, f"d {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hop", ["gathered", "aligned"])
def test_gat_layer_apply_matches_jax(hop, dtype):
    """``gat_layer_apply`` (el through K1's plain version, then K7's):
    output and gradients for the parameters and h_src, dropout 0."""
    rng = np.random.default_rng(3)
    fanout, F, H, d_in, d_out = 4, 10, 2, 24, 8
    num_dst, offset = 25, 5
    n_src = num_dst + fanout * F
    aoff = num_dst if hop == "aligned" else None
    src = _lanes(rng, fanout, F, n_src, aoff)
    h = rng.standard_normal((n_src, d_in)).astype(np.float32)
    p = {k: v.astype(np.float32) for k, v in
         _gat_params(rng, d_in, H, d_out).items()}
    w_out = rng.standard_normal((num_dst, H, d_out)).astype(np.float32)
    cdt_j = jnp.bfloat16 if dtype == "bfloat16" else None

    def jfn(params, hh):
        out = jgat.gat_layer_apply(params, hh, jnp.asarray(src), fanout,
                                   jnp.int32(offset), num_dst, 0.2,
                                   aligned_offset=aoff, compute_dtype=cdt_j)
        return jnp.sum(out * w_out), out

    (_, out_j), (gp_j, gh_j) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(h, jdt(dtype)))
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    ht = torch.from_numpy(h).to(tdt(dtype)).requires_grad_()
    out_p = gat_layer_apply(pt, ht, torch.from_numpy(src), fanout,
                            torch.tensor(offset, dtype=torch.int32), num_dst,
                            0.2, None, aoff,
                            torch.bfloat16 if dtype == "bfloat16" else None)
    (out_p * torch.from_numpy(w_out)).sum().backward()
    assert out_p.dtype == torch.float32
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    close(out_p, out_j, tol, "out")
    close(ht.grad, gh_j, tol, "d h_src")
    for k in p:
        close(pt[k].grad, gp_j[k], tol, f"d {k}")


@pytest.mark.parametrize("dedup_last_hop,compute_dtype",
                         [(False, "float32"), (False, "bfloat16"),
                          (True, "bfloat16")])
def test_gat_forward_and_grads_match_jax(dedup_last_hop, compute_dtype):
    """GAT with JAX's initial parameters (converted by params_from_jax),
    eval mode: logits and every parameter gradient. The aligned last hop
    runs K6's plain version at layer 0; the exact one K7's."""
    kw = dict(fanouts=(6, 4), batch_size=32, dedup="sort",
              neighbor_window=16, dedup_last_hop=dedup_last_hop,
              node_caps=(32, 160, 640 if dedup_last_hop else 0))
    scfg, jcfg = SamplerConfig(**kw), JSamplerConfig(**kw)
    rng = np.random.default_rng(4)
    pb, jb, x = batch_and_feats(rng, scfg)
    classes = 10
    jm = jgat.GAT(jcfg, 100, 16, classes, heads=(4, 1), in_dim_pad=128,
                  compute_dtype=compute_dtype)
    params = jm.init(jax.random.PRNGKey(0))
    pm = GAT(100, 16, classes, num_layers=2, device="cpu", heads=(4, 1),
             in_dim_pad=128, compute_dtype=compute_dtype)
    pm.load_state_dict(params_from_jax(params))
    w = rng.standard_normal((32, classes)).astype(np.float32)

    def jfn(p):
        logits = jm.apply(p, jnp.asarray(x, jdt(compute_dtype)), jb)
        return jnp.sum(logits * w), logits

    (_, lj), gj = jax.jit(jax.value_and_grad(jfn, has_aux=True))(params)
    pm.eval()
    lp = pm(torch.from_numpy(x).to(tdt(compute_dtype)), pb, scfg)
    (lp * torch.from_numpy(w)).sum().backward()
    tol = F32_RTOL if compute_dtype == "float32" else BF16_RTOL
    close(lp, lj, tol, "logits")
    for i, layer in enumerate(gj["layers"]):
        for k in layer:
            close(pm.layers[i][k].grad, layer[k], tol, f"layer {i} {k}")


@pytest.fixture(scope="module")
def jax_dataset():
    return jax_synth(num_nodes=2000, num_edges=40000, feature_dim=100,
                     num_classes=8, batch_size=32, valid_size=256,
                     test_size=256, seed=1)


def test_one_gat_train_step_matches_jax(jax_dataset):
    """``Trainer._train_on`` for GAT (aligned last hop, f32) on JAX's batch
    and parameters, dropout 0: loss, gradients and Adam-updated
    parameters. (In bf16 the jitted JAX step fuses away roundings that the
    op-by-op program keeps; the bf16 model test above holds the port
    there.)"""
    kw = dict(fanouts=(5, 3), batch_size=32, eval_batch_size=32,
              dedup="sort", neighbor_window=16, dedup_last_hop=False,
              node_caps=(32, 128, 0))
    loss_p, loss_j, pairs = one_train_step(jax_dataset, "gat", "float32",
                                           kw, 32)
    assert abs(loss_p - loss_j) <= F32_RTOL * abs(loss_j)
    for name, gp, gj, npar, nj in pairs:
        assert rel(gp, gj) <= F32_RTOL and rel(npar, nj) <= F32_RTOL, name


def test_attention_kernel_entry_has_no_cpu_fallback():
    """K7's kernel entry takes CUDA tensors only: CPU tensors reach the
    plain version through ``hop_softmax_attention``, never through the
    kernel's wrapper; K6 and K7 count forward and backward launches."""
    from legion_tpu_torch.ops import kernels
    z = torch.zeros((8, 4))
    sc = torch.zeros((2, 3, 1))
    src = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="hop_attention: z on cpu"):
        kernels.hop_attention(z, sc, src, 2, torch.tensor(0), 4, 1)
    # K6 takes the plain version only when every tensor is on the CPU
    x = torch.zeros((8, 4), device="meta")
    u = torch.zeros((4, 1))
    with pytest.raises(ValueError, match="gat_attend: x on meta, u_l on cpu"):
        kernels.gat_attend(x, u, u, src, torch.tensor(0, dtype=torch.int32),
                           2, 0, 0.2)
    assert {"gat_attend", "gat_attend_bwd", "hop_attention",
            "hop_attention_bwd"} <= set(kernels.LAUNCHES)
