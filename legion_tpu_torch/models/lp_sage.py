"""Unsupervised link-prediction GraphSAGE (port of
``legion_tpu/models/lp_sage.py``).

Each batch's seeds are (anchor, positive, negative) thirds; the encoder is
a SAGE stack without a classifier head; the loss is

    -logsigmoid(h_a . h_p) - logsigmoid(-h_a . h_n)

averaged over the valid anchors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.models.graphsage import GraphSAGE
from legion_tpu_torch.sampling.sampler import SampleBatch


def check_thirds(batch_size: int) -> None:
    if batch_size % 3:
        raise ValueError(f"lp_sage batches are (anchor, pos, neg) thirds "
                         f"(lp_sage.py:86-97); batch {batch_size}")


class LinkPredSAGE(GraphSAGE):
    """GraphSAGE's parameters with every layer hidden wide:
    ``layers.{i}.w_self`` / ``w_neigh`` [d_in, hidden], ``layers.{i}.b``.
    Unlike GraphSAGE, activations stay in the weights' dtype between
    layers (the JAX model takes no compute dtype)."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int,
                 device: torch.device, dropout: float = 0.5,
                 in_dim_pad: Optional[int] = None):
        super().__init__(in_dim, hidden_dim, hidden_dim, num_layers, device,
                         dropout=dropout, in_dim_pad=in_dim_pad)

    # GraphSAGE's forward: with no compute dtype, activations stay in the
    # weights' dtype between layers
    encode = GraphSAGE.forward

    def loss(self, feats: torch.Tensor, batch: SampleBatch,
             sampler_cfg: SamplerConfig, seed_valid: torch.Tensor,
             drop_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean link-prediction loss over the valid anchors; dropout in
        training mode when the step's dropout key words are given."""
        check_thirds(sampler_cfg.batch_size)
        h = self.encode(feats, batch, sampler_cfg, drop_key)
        third = sampler_cfg.batch_size // 3
        h_a, h_p, h_n = h[:third], h[third:2 * third], h[2 * third:]
        pos = (h_a * h_p).sum(dim=-1)
        neg = (h_a * h_n).sum(dim=-1)
        per = -F.logsigmoid(pos) - F.logsigmoid(-neg)
        w = seed_valid[:third].to(per.dtype)
        return (per * w).sum() / w.sum().clamp(min=1)
