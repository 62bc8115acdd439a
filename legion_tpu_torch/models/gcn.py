"""GCN with symmetric degree normalisation (port of
``legion_tpu/models/gcn.py``).

    h'_v = b + sum_{(u->v)} (d_out(u)^{-1/2} h_u) W * d_in(v)^{-1/2}

Degrees are block-local, counted over the sampled edges. The out-degree of
a gathered hop is a segment sum (K2) over a column of ones, kept in f32:
JAX counts it in the features' dtype, where a bf16 sum stops growing at
256 (``gcn.py:46-52``). The degree and its rsqrt are cast to the
activations' dtype only at the multiply.
"""

from __future__ import annotations

import warnings
from typing import Mapping, Optional

import torch
from torch import nn

from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.models.common import (static_cum_sizes,
                                            xavier_uniform_padded)
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.dropout import dropout_act
from legion_tpu_torch.ops.hop_agg import hop_neighbor_sum
from legion_tpu_torch.sampling.sampler import SampleBatch


def _inv_sqrt(deg: torch.Tensor) -> torch.Tensor:
    return torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1)),
                       torch.zeros_like(deg))


def block_out_degree(edge_src: torch.Tensor, n_src: int) -> torch.Tensor:
    """[n_src] f32: how many valid lanes of the hop read each source row
    (K2 over an [E, 1] column of ones; pads are -1 and dropped)."""
    ones = torch.ones((edge_src.shape[0], 1), dtype=torch.float32,
                      device=edge_src.device)
    return kernels.segment_sum(ones, edge_src, n_src)[:, 0]


def gcn_layer_apply(params: Mapping[str, torch.Tensor], h_src: torch.Tensor,
                    edge_src: torch.Tensor, fanout: int,
                    hop_offset: torch.Tensor, num_dst: int,
                    aligned_offset: Optional[int] = None) -> torch.Tensor:
    """One GraphConv(norm='both'), [N_src, d_in] -> [num_dst, d_out] f32.
    On a lane-aligned hop each source slot carries its own lane's edge, so
    the out-degree is the lane's validity."""
    n_src = h_src.shape[0]
    if aligned_offset is not None:
        E = edge_src.shape[0]
        inv_out = torch.zeros((n_src,), dtype=torch.float32,
                              device=h_src.device)
        inv_out[aligned_offset:aligned_offset + E] = (edge_src >= 0).float()
    else:
        inv_out = _inv_sqrt(block_out_degree(edge_src, n_src))
    w, b = params["w"], params["b"]
    d_in, d_out = w.shape
    if d_in > d_out:
        # project first when it shrinks rows (DGL GraphConv ordering)
        h_msg = (h_src.to(w.dtype) @ w) * inv_out[:, None].to(w.dtype)
        agg, in_deg = hop_neighbor_sum(h_msg, edge_src, fanout, hop_offset,
                                       num_dst, aligned_offset)
    else:
        h_msg = h_src * inv_out[:, None].to(h_src.dtype)
        agg, in_deg = hop_neighbor_sum(h_msg, edge_src, fanout, hop_offset,
                                       num_dst, aligned_offset)
        agg = agg.to(w.dtype) @ w
    return agg * _inv_sqrt(in_deg)[:, None] + b


class GCN(nn.Module):
    """Parameters: ``layers.{i}.w`` [d_in, d_out] and ``layers.{i}.b``
    [d_out], float32."""

    def __init__(self, sampler_cfg: SamplerConfig, in_dim: int,
                 hidden_dim: int, num_classes: int, device: torch.device,
                 dropout: float = 0.5, in_dim_pad: Optional[int] = None):
        super().__init__()
        if sampler_cfg.aligned_hop_offset(sampler_cfg.num_hops - 1) \
                is not None:
            warnings.warn(
                "GCN with dedup_last_hop=False changes norm='both' "
                "semantics: a node drawn m times counts as m degree-1 "
                "slots instead of one degree-m node. Set "
                "SamplerConfig(dedup_last_hop=True) for exact parity "
                "with the reference's DGL blocks (legion_gcn.py:68-96).",
                stacklevel=2)
        self.num_layers = sampler_cfg.num_hops
        self.in_dim = in_dim
        self.in_dim_pad = in_dim_pad or in_dim
        self.dims = ([self.in_dim_pad] + [hidden_dim] * (self.num_layers - 1)
                     + [num_classes])
        self.dropout_rate = dropout
        self.layers = nn.ModuleList(
            nn.ParameterDict({
                "w": nn.Parameter(torch.zeros(
                    (self.dims[i], self.dims[i + 1]), device=device)),
                "b": nn.Parameter(torch.zeros((self.dims[i + 1],),
                                              device=device)),
            }) for i in range(self.num_layers))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """DGL GraphConv init: xavier_uniform (gain 1), zero bias; layer
        0's pad rows are zero."""
        for i, layer in enumerate(self.layers):
            logical = self.in_dim if i == 0 else self.dims[i]
            layer["w"].copy_(xavier_uniform_padded(
                logical, self.dims[i], (self.dims[i + 1],), generator,
                device=layer["w"].device))
            layer["b"].zero_()

    def forward(self, feats: torch.Tensor, batch: SampleBatch,
                sampler_cfg: SamplerConfig,
                drop_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats [max_ids, in_dim_pad] -> logits [batch_size, classes].
        Dropout runs in training mode when the step's dropout key words
        ``drop_key`` are given; between layers ReLU and dropout are one
        K16 pass."""
        if sampler_cfg.num_hops != self.num_layers:
            raise ValueError("layer count must match sampling hops")
        S = static_cum_sizes(sampler_cfg)
        L = self.num_layers
        h = feats
        for i in range(L):
            k = L - 1 - i
            h = gcn_layer_apply(self.layers[i], h[:S[k + 1]],
                                batch.edge_src[k], sampler_cfg.fanouts[k],
                                batch.hop_offsets[k], S[k],
                                sampler_cfg.aligned_hop_offset(k))
            if i != L - 1:
                h = dropout_act(h, "relu", None, self.dropout_rate,
                                drop_key, i, self.training)
        return h[:sampler_cfg.batch_size]
