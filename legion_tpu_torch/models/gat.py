"""GAT, multi-head, with edge-wise attention (port of
``legion_tpu/models/gat.py``).

    z_u   = W h_u                                  (per head)
    e_uv  = LeakyReLU(a_l . z_u + a_r . z_v)
    alpha = softmax of e over the fanout of v       (per head)
    h'_v  = sum_u alpha_uv z_u + b
    between layers: ELU, flatten the heads, cast to the compute dtype;
    the last layer means its heads

Parameters keep JAX's layout: ``w`` [d_in, H, d_out], ``attn_l``,
``attn_r`` and ``b`` [H, d_out]. The attention runs in two hand-written
kernels: K6 on a lane-aligned hop (``gat_layer_aligned_streaming``), K7 on
a gathered one (``gat_layer_apply``). The GEMMs around them are
``torch.matmul``.

Feature dropout is drawn per slot: on an aligned hop two draws of one node
are two slots with independent masks (as in JAX, ``gat.py:55-58``). It is
one K16 pass a layer (``ops/dropout.py``), its bits from the step's dropout
key; layer i > 0's pass also takes the ELU and the cast of layer i - 1's
output. Attention dropout draws from the same key inside K6 and K7
(``ops/dropout.py::AttnDrop``), layer i's bits from ``attn_fold(i)``, so
every mask of a step follows the key K10 writes on the card.
JAX rematerialises a bf16 layer 0 in the backward (``jax.checkpoint``,
``gat.py:223-231``) to fit a 16 GB TPU; on an 80 GB card the port keeps
the activations.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.models.common import (static_cum_sizes,
                                            xavier_uniform,
                                            xavier_uniform_padded)
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.dropout import AttnDrop, dropout_act
from legion_tpu_torch.ops.hop_agg import hop_softmax_attention, place_rows
from legion_tpu_torch.ops.segment import gather_rows
from legion_tpu_torch.sampling.sampler import SampleBatch


def gat_layer_aligned_streaming(params: Mapping[str, torch.Tensor],
                                h_src: torch.Tensor, edge_src: torch.Tensor,
                                fanout: int, hop_offset: torch.Tensor,
                                num_dst: int, aligned_offset: int,
                                negative_slope: float = 0.2,
                                drop: Optional[AttnDrop] = None,
                                compute_dtype=None) -> torch.Tensor:
    """Multi-head GATConv on a lane-aligned hop, by the projection commute
    (e_l = x . (W a_l), sum_f alpha_f (x_f W) = (sum_f alpha_f x_f) W): the
    [E, H*d_out] projection is never built. K6 takes the scores, softmax,
    dropout and the fanout contraction; then xw @ W per head.
    ``drop`` is attention dropout (the step's dropout key words, the
    layer, the rate; K6 draws the keep bits) or None.
    Returns [num_dst, H, d_out] f32."""
    H, d_out = params["attn_l"].shape
    d_in = h_src.shape[1]
    w = params["w"].reshape(d_in, H, d_out)
    al, ar = params["attn_l"], params["attn_r"]
    if compute_dtype is not None:
        w, al, ar = (t.to(compute_dtype) for t in (w, al, ar))
        h_src = h_src.to(compute_dtype)
    else:
        h_src = h_src.to(w.dtype)
    # folded attention vectors: u[k, h] = sum_d w[k, h, d] a[h, d]
    u_l = torch.einsum("khd,hd->kh", w, al)
    u_r = torch.einsum("khd,hd->kh", w, ar)
    xw = kernels.gat_attend(h_src, u_l, u_r, edge_src, hop_offset, fanout,
                            aligned_offset, negative_slope, drop)
    # [F, H, d_in] x [d_in, H, d_out] per head in the compute dtype: the
    # GEMM accumulates in f32 and rounds once, as JAX's f32
    # preferred_element_type followed by its cast to h_src's dtype
    acc = torch.einsum("ihk,khd->ihd", xw, w)
    out = place_rows(acc, hop_offset, num_dst)
    return out + params["b"][None]


def gat_layer_apply(params: Mapping[str, torch.Tensor], h_src: torch.Tensor,
                    edge_src: torch.Tensor, fanout: int,
                    hop_offset: torch.Tensor, num_dst: int,
                    negative_slope: float = 0.2,
                    drop: Optional[AttnDrop] = None,
                    aligned_offset: Optional[int] = None,
                    compute_dtype=None) -> torch.Tensor:
    """One multi-head GATConv over a gathered (or aligned) hop: z = h W in
    the compute dtype, el/er summed in f32, el gathered per lane (K1,
    backward K2), then K7. Returns [num_dst, H, d_out] f32."""
    H, d_out = params["attn_l"].shape
    w = params["w"].reshape(h_src.shape[1], H * d_out)
    al, ar = params["attn_l"], params["attn_r"]
    if compute_dtype is not None:
        w, al, ar = (t.to(compute_dtype) for t in (w, al, ar))
        h_src = h_src.to(compute_dtype)
    else:
        h_src = h_src.to(w.dtype)
    z = (h_src @ w).reshape(-1, H, d_out)
    el = (z * al[None]).sum(dim=-1, dtype=torch.float32)      # [N_src, H]
    er = (z * ar[None]).sum(dim=-1, dtype=torch.float32)
    E = edge_src.shape[0]
    F_ = E // fanout
    er_dst = kernels.slice_rows(er, hop_offset, F_)
    if aligned_offset is not None:
        el_e = el[aligned_offset:aligned_offset + E]
    else:
        el_e = gather_rows(el, edge_src)
    e = kernels.leaky_relu(el_e.reshape(fanout, F_, H) + er_dst[None],
                           negative_slope)
    out = hop_softmax_attention(z, e, edge_src, fanout, hop_offset, num_dst,
                                drop, aligned_offset)
    return out + params["b"][None]


class GAT(nn.Module):
    """Parameters: ``layers.{i}.w`` [d_in, H_i, d_out], ``attn_l``,
    ``attn_r``, ``b`` [H_i, d_out], float32. Layer i's input is the
    (padded) feature width at i = 0, else hidden * H_{i-1}; its per-head
    output is hidden, or the class count for the last layer."""

    def __init__(self, in_dim: int, hidden_dim: int, num_classes: int,
                 num_layers: int, device: torch.device,
                 heads: Sequence[int] = (8, 1), feat_drop: float = 0.6,
                 attn_drop: float = 0.6, negative_slope: float = 0.2,
                 in_dim_pad: Optional[int] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if len(heads) != num_layers:
            raise ValueError(f"GAT: {len(heads)} head counts for "
                             f"{num_layers} layers")
        self.cdt = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.num_layers = num_layers
        self.heads = tuple(heads)
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.negative_slope = negative_slope
        self.in_dim = in_dim
        self.in_dim_pad = in_dim_pad or in_dim
        self.layer_in = [self.in_dim_pad] + [hidden_dim * heads[i - 1]
                                             for i in range(1, num_layers)]
        self.layer_out = [hidden_dim] * (num_layers - 1) + [num_classes]
        self.layers = nn.ModuleList(
            nn.ParameterDict({
                "w": nn.Parameter(torch.zeros(
                    (self.layer_in[i], H, self.layer_out[i]), device=device)),
                "attn_l": nn.Parameter(torch.zeros((H, self.layer_out[i]),
                                                   device=device)),
                "attn_r": nn.Parameter(torch.zeros((H, self.layer_out[i]),
                                                   device=device)),
                "b": nn.Parameter(torch.zeros((H, self.layer_out[i]),
                                              device=device)),
            }) for i, H in enumerate(self.heads))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """DGL GATConv init: xavier_uniform with gain sqrt(2) for w (layer
        0's pad rows zero), attn_l and attn_r; zero bias."""
        for i, layer in enumerate(self.layers):
            d_in, d_out, H = self.layer_in[i], self.layer_out[i], \
                self.heads[i]
            logical = self.in_dim if i == 0 else d_in
            dev = layer["w"].device
            layer["w"].copy_(xavier_uniform_padded(
                logical, d_in, (H, d_out), generator, gain=2 ** 0.5,
                device=dev))
            for name in ("attn_l", "attn_r"):
                layer[name].copy_(xavier_uniform((H, d_out), generator,
                                                 gain=2 ** 0.5, device=dev))
            layer["b"].zero_()

    def forward(self, feats: torch.Tensor, batch: SampleBatch,
                sampler_cfg: SamplerConfig,
                drop_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats [max_ids, in_dim_pad] -> logits [batch_size, classes].
        In training mode, with the step's dropout key words ``drop_key``,
        feature and attention dropout draw from them (layer i's bits from
        folds i and ``attn_fold(i)``)."""
        if sampler_cfg.num_hops != self.num_layers:
            raise ValueError("layer count must match sampling hops")
        S = static_cum_sizes(sampler_cfg)
        L = self.num_layers
        h, act, cdt = feats, "none", None
        attn = self.training and drop_key is not None and self.attn_drop > 0
        for i in range(L):
            k = L - 1 - i
            fanout = sampler_cfg.fanouts[k]
            edge_src = batch.edge_src[k]
            # the previous layer's ELU and cast, and this layer's dropout
            h = dropout_act(h, act, cdt, self.feat_drop, drop_key, i,
                            self.training)
            drop = AttnDrop(drop_key, i, self.attn_drop) if attn else None
            ao = sampler_cfg.aligned_hop_offset(k)
            args = (self.layers[i], h[:S[k + 1]], edge_src, fanout,
                    batch.hop_offsets[k], S[k])
            if ao is not None:
                out = gat_layer_aligned_streaming(
                    *args, ao, self.negative_slope, drop, self.cdt)
            else:
                out = gat_layer_apply(*args, self.negative_slope, drop,
                                      None, self.cdt)
            if i != L - 1:
                # flatten the heads; ELU and the cast wait for the next
                # layer's dropout
                h, act, cdt = out.reshape(out.shape[0], -1), "elu", self.cdt
            else:
                h = out.mean(dim=1)
        return h[:sampler_cfg.batch_size]
