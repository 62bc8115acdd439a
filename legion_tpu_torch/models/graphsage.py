"""GraphSAGE, mean aggregator (port of ``legion_tpu/models/graphsage.py``).

    h_N(v) = mean_{(u->v) in block} h_u
    h'_v   = h_v W_self + b + h_N(v) W_neigh
    between layers: ReLU, cast to the compute dtype, dropout

Weights keep the JAX layout, ``[d_in, d_out]``, so converting parameters
from the JAX package is a copy (``utils/convert.py::params_from_jax``).
JAX promotes bf16 @ f32 to f32 where ``torch.matmul`` refuses mixed
dtypes, so activations are cast to the weight dtype before each product.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.models.common import (dropout, static_cum_sizes,
                                            xavier_uniform_padded)
from legion_tpu_torch.ops.hop_agg import TableRows, hop_neighbor_mean
from legion_tpu_torch.sampling.sampler import SampleBatch


def sage_layer_apply(params: Mapping[str, torch.Tensor],
                     h_src: Union[torch.Tensor, TableRows],
                     edge_src: torch.Tensor, fanout: int,
                     hop_offset: torch.Tensor, num_dst: int,
                     aligned_offset: Optional[int] = None) -> torch.Tensor:
    """One SAGEConv(mean) layer, [N_src, d_in] -> [num_dst, d_out].

    When the layer shrinks rows (d_in > padded d_out) and the hop needs a
    real per-edge gather, W_neigh is applied first (mean(h W) == mean(h) W)
    at a width padded up to a multiple of 128, so that the mean (K15) and
    its backward (``hop_mean_grad``) move d_out-wide rows. Otherwise the mean
    is taken first (the lane-aligned hop, or a widening layer). ``h_src``
    may be ``TableRows`` on the aligned hop: the destinations' rows, and
    the lanes' rows read from the feature table by K15."""
    w_self, w_neigh, b = params["w_self"], params["w_neigh"], params["b"]
    wdt = w_self.dtype
    table = ids = None
    if isinstance(h_src, TableRows):
        h_src, table, ids = h_src
    h_dst = h_src[:num_dst]
    d_in, d_out = w_neigh.shape
    dp = max(-(-d_out // 128) * 128, 128)
    if aligned_offset is None and d_in > dp:
        wn = F.pad(w_neigh, (0, dp - d_out)) if dp != d_out else w_neigh
        hp = (h_src.to(wdt) @ wn).to(h_src.dtype)
        h_neigh = hop_neighbor_mean(hp, edge_src, fanout, hop_offset,
                                    num_dst)
        if dp != d_out:
            h_neigh = h_neigh[:, :d_out]
        out = h_dst.to(wdt) @ w_self + h_neigh.to(wdt)
    else:
        h_neigh = hop_neighbor_mean(h_src if table is None else table,
                                    edge_src, fanout, hop_offset, num_dst,
                                    aligned_offset, ids)
        out = h_dst.to(wdt) @ w_self + h_neigh.to(wdt) @ w_neigh
    return out + b


class GraphSAGE(nn.Module):
    """Parameters: ``layers.{i}.w_self`` / ``w_neigh`` [d_in, d_out] and
    ``layers.{i}.b`` [d_out], float32."""

    # ``forward`` takes ``TableRows`` as feats: the trainer may then leave
    # the aligned last hop's rows in the device feature table
    reads_table_rows = True

    def __init__(self, in_dim: int, hidden_dim: int, num_classes: int,
                 num_layers: int, device: torch.device, dropout: float = 0.5,
                 compute_dtype: Optional[str] = None,
                 in_dim_pad: Optional[int] = None):
        super().__init__()
        self.cdt = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.num_layers = num_layers
        self.in_dim = in_dim
        self.in_dim_pad = in_dim_pad or in_dim
        self.dims = ([self.in_dim_pad] + [hidden_dim] * (num_layers - 1)
                     + [num_classes])
        self.dropout_rate = dropout
        self.layers = nn.ModuleList(
            nn.ParameterDict({
                "w_self": nn.Parameter(torch.zeros(
                    (self.dims[i], self.dims[i + 1]), device=device)),
                "w_neigh": nn.Parameter(torch.zeros(
                    (self.dims[i], self.dims[i + 1]), device=device)),
                "b": nn.Parameter(torch.zeros((self.dims[i + 1],),
                                              device=device)),
            }) for i in range(num_layers))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """DGL SAGEConv init: xavier_uniform with gain sqrt(2), zero bias;
        layer 0's pad rows are zero. ``generator`` must live on the
        parameters' device."""
        for i, layer in enumerate(self.layers):
            d_in, d_out = self.dims[i], self.dims[i + 1]
            logical = self.in_dim if i == 0 else d_in
            dev = layer["w_self"].device
            for name in ("w_self", "w_neigh"):
                layer[name].copy_(xavier_uniform_padded(
                    logical, d_in, (d_out,), generator, gain=2 ** 0.5,
                    device=dev))
            layer["b"].zero_()

    def forward(self, feats: Union[torch.Tensor, TableRows],
                batch: SampleBatch, sampler_cfg: SamplerConfig,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """feats [max_ids, in_dim_pad] (or ``TableRows`` of them, with the
        aligned last hop left in the table) -> logits [batch_size,
        classes]. Dropout runs in training mode when a generator is
        given."""
        if sampler_cfg.num_hops != self.num_layers:
            raise ValueError("layer count must match sampling hops")
        S = static_cum_sizes(sampler_cfg)
        L = self.num_layers
        h = feats
        for i in range(L):
            k = L - 1 - i      # layer i aggregates hop k's edges
            h = sage_layer_apply(self.layers[i], h if isinstance(
                h, TableRows) else h[:S[k + 1]],
                                 batch.edge_src[k], sampler_cfg.fanouts[k],
                                 batch.hop_offsets[k], S[k],
                                 sampler_cfg.aligned_hop_offset(k))
            if i != L - 1:
                h = torch.relu(h)
                if self.cdt is not None:
                    # bf16 between layers, cast before dropout
                    h = h.to(self.cdt)
                h = dropout(h, self.dropout_rate, generator, self.training)
        return h[:sampler_cfg.batch_size]
