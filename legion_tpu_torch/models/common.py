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


def _u8_regime(shape: Tuple[int, ...], rate: float) -> bool:
    """Dropout's second regime: u8 draws, for 2**20 elements or more
    (rate 0.5 on a 32-multiple width takes the first regime first)."""
    if rate == 0.5 and len(shape) == 2 and shape[-1] % 32 == 0:
        return False
    return len(shape) >= 2 and math.prod(shape) >= (1 << 20)


def dropout_keep(shape: Tuple[int, ...], rate: float,
                 generator: Optional[torch.Generator],
                 device: Optional[torch.device] = None
                 ) -> Optional[Tuple[torch.Tensor, float]]:
    """The keep mask (bool, ``shape``) and the scale of kept entries for
    inverted dropout, in the three regimes of the JAX package (the masks
    come from ``generator``, so the bits differ from JAX's); None when
    nothing is dropped:
      - rate 0.5 on [N, d] with d % 32 == 0: one random bit per element,
        unpacked from 32-bit words;
      - 2**20 elements or more: u8 draws against a threshold, keep rate
        quantised to 1/256 and the scale taken from the quantised rate;
      - otherwise a uniform draw per element."""
    if rate <= 0.0 or generator is None:
        return None
    keep = 1.0 - rate
    if rate == 0.5 and len(shape) == 2 and shape[-1] % 32 == 0:
        words = torch.randint(-2 ** 31, 2 ** 31, (shape[0], shape[1] // 32),
                              dtype=torch.int32, generator=generator,
                              device=device)
        shifts = torch.arange(32, dtype=torch.int32, device=device)
        mask = ((words[:, :, None] >> shifts) & 1).reshape(shape) != 0
        return mask, 1.0 / keep
    if _u8_regime(shape, rate):
        kq = min(max(round(keep * 256), 1), 255)
        bits = torch.randint(0, 256, shape, dtype=torch.uint8,
                             generator=generator, device=device)
        return bits < kq, 256.0 / kq
    mask = torch.rand(shape, generator=generator, device=device) < keep
    return mask, 1.0 / keep


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool
            ) -> torch.Tensor:
    """Inverted dropout with the mask of ``dropout_keep``, as JAX applies
    it (``legion_tpu/models/common.py:86``, ``:96``, ``:99``): kept entries
    divided by keep, or in the u8 regime multiplied by 256 / kq, with the
    constant in x's dtype (JAX's weakly typed scalar takes x's dtype) and
    on x's device (a divisor on the host would turn the division into a
    multiplication by its reciprocal on the card)."""
    if not train:
        return x
    keep = dropout_keep(tuple(x.shape), rate, generator, x.device)
    if keep is None:
        return x
    mask, scale = keep

    def const(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    kept = x * const(scale) if _u8_regime(tuple(x.shape), rate) \
        else x / const(1.0 - rate)
    return torch.where(mask, kept, const(0.0))


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
