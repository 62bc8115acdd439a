"""Shared model utilities: block geometry, initialisers and the model
factory (port of ``legion_tpu/models/common.py``; its ``dropout`` is
``ops/dropout.py``).

Block geometry: layer i (of L) aggregates over hop k = L-1-i; its input
covers local positions [0, S[k+1]) and its output [0, S[k]), with S the
sampler's static cumulative sizes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from legion_tpu_torch.config import SamplerConfig, TrainConfig


def static_cum_sizes(cfg: SamplerConfig) -> Tuple[int, ...]:
    """S[k] = static bound on local node slots after hop k."""
    return cfg.cum_sizes()


def xavier_uniform(shape: Tuple[int, ...], generator: torch.Generator,
                   gain: float = 1.0, dtype=torch.float32,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """Glorot uniform over [in, out] (fan-in shape[0], fan-out the rest)."""
    fan_in, fan_out = shape[0], math.prod(shape[1:])
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return u * (2 * bound) - bound


def xavier_uniform_padded(logical_in: int, padded_in: int,
                          shape_tail: Tuple[int, ...],
                          generator: torch.Generator, gain: float = 1.0,
                          dtype=torch.float32,
                          device: Optional[torch.device] = None
                          ) -> torch.Tensor:
    """Xavier init for a weight whose input dim is padded (feature table
    padded to a multiple of 128 columns): the first ``logical_in`` rows
    use the logical fan-in, the pad rows are zero. Pad rows only ever see
    zero activations, so they get zero gradients and stay zero."""
    w = xavier_uniform((logical_in,) + tuple(shape_tail), generator, gain,
                       dtype, device)
    if padded_in == logical_in:
        return w
    out = torch.zeros((padded_in,) + tuple(shape_tail), dtype=dtype,
                      device=device)
    out[:logical_in] = w
    return out


def torch_linear_init(generator: torch.Generator, in_dim: int,
                      out_dim: int, bias: bool = True,
                      dtype=torch.float32) -> dict:
    """torch.nn.Linear's default init, as the JAX package's
    ``torch_linear_init``: w [in, out] and b [out] from U(-1/sqrt(in),
    1/sqrt(in)), drawn by ``generator`` on its device; no "b" without
    ``bias``."""
    bound = 1.0 / math.sqrt(in_dim)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device)
        return u * (2 * bound) - bound
    w = uniform((in_dim, out_dim))
    return {"w": w, "b": uniform((out_dim,))} if bias else {"w": w}


def make_model(train_cfg: TrainConfig, sampler_cfg: SamplerConfig,
               in_dim: int, num_classes: int, device: torch.device,
               in_dim_pad: Optional[int] = None):
    """Factory with the arguments of ``legion_tpu/models/common.py::
    make_model``. The port's models take the sampler config at ``forward``
    (one module serves the train and the eval shapes); ``sampler_cfg``
    gives the layer count and, for GCN, the last hop's alignment."""
    from legion_tpu_torch.models.gat import GAT
    from legion_tpu_torch.models.gcn import GCN
    from legion_tpu_torch.models.graphsage import GraphSAGE
    from legion_tpu_torch.models.lp_sage import LinkPredSAGE

    name = train_cfg.model.lower()
    L = sampler_cfg.num_hops
    if name == "graphsage":
        return GraphSAGE(in_dim, train_cfg.hidden_dim, num_classes,
                         num_layers=L, dropout=train_cfg.dropout,
                         compute_dtype=train_cfg.compute_dtype,
                         in_dim_pad=in_dim_pad, device=device)
    if name == "gcn":
        return GCN(sampler_cfg, in_dim, train_cfg.hidden_dim, num_classes,
                   dropout=train_cfg.dropout, in_dim_pad=in_dim_pad,
                   device=device)
    if name == "gat":
        return GAT(in_dim, train_cfg.hidden_dim, num_classes, num_layers=L,
                   heads=train_cfg.gat_heads,
                   feat_drop=train_cfg.gat_feat_drop,
                   attn_drop=train_cfg.gat_attn_drop,
                   in_dim_pad=in_dim_pad,
                   compute_dtype=train_cfg.compute_dtype, device=device)
    if name == "lp_sage":
        return LinkPredSAGE(in_dim, train_cfg.hidden_dim, num_layers=L,
                            dropout=train_cfg.dropout,
                            in_dim_pad=in_dim_pad, device=device)
    raise ValueError(f"unknown model {train_cfg.model!r}")
