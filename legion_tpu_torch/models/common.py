"""Shared model utilities: block geometry, initialisers, dropout, and the
model factory (port of ``legion_tpu/models/common.py``).

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


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool
            ) -> torch.Tensor:
    """Inverted dropout in the three regimes of the JAX package (the masks
    come from ``generator``, so the bits differ from JAX's):
      - rate 0.5 on [N, d] with d % 32 == 0: one random bit per element,
        unpacked from 32-bit words;
      - 2**20 elements or more: u8 draws against a threshold, keep rate
        quantised to 1/256 and the scale taken from the quantised rate;
      - otherwise a uniform draw per element."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if rate == 0.5 and x.dim() == 2 and x.shape[-1] % 32 == 0:
        words = torch.randint(-2 ** 31, 2 ** 31,
                              (x.shape[0], x.shape[1] // 32),
                              dtype=torch.int32, generator=generator,
                              device=x.device)
        shifts = torch.arange(32, dtype=torch.int32, device=x.device)
        mask = ((words[:, :, None] >> shifts) & 1).reshape(x.shape) != 0
        return torch.where(mask, x / keep, zero)
    if x.dim() >= 2 and x.numel() >= (1 << 20):
        kq = min(max(round(keep * 256), 1), 255)
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             generator=generator, device=x.device)
        return torch.where(bits < kq, x * (256.0 / kq), zero)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, zero)


def make_model(train_cfg: TrainConfig, sampler_cfg: SamplerConfig,
               in_dim: int, num_classes: int, device: torch.device,
               in_dim_pad: Optional[int] = None):
    """GraphSAGE only, for now; the other models are ROADMAP items."""
    from legion_tpu_torch.models.graphsage import GraphSAGE

    name = train_cfg.model.lower()
    if name == "graphsage":
        return GraphSAGE(in_dim, train_cfg.hidden_dim, num_classes,
                         num_layers=sampler_cfg.num_hops,
                         dropout=train_cfg.dropout,
                         compute_dtype=train_cfg.compute_dtype,
                         in_dim_pad=in_dim_pad, device=device)
    if name in ("gcn", "gat", "lp_sage"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP queue A, item 9: "
            "model breadth)")
    raise ValueError(f"unknown model {train_cfg.model!r}")
