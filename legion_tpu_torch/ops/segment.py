"""Masked segment ops (port of ``legion_tpu/ops/segment.py``: the row
gather and the masked segment sum). Convention: id -1 is padding.

Both dispatch to the hand-written kernels (``ops/kernels.py``): the row
gather to K1 with K2 as its backward, the segment sum to K2. One
difference from the JAX ``gather_rows``: pad ids give zero rows here, not
a clamped copy of row 0. Consumers mask pads either way.
"""

from __future__ import annotations

import torch

from legion_tpu_torch.ops import kernels


def gather_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Differentiable row gather, zero rows for idx < 0 (K1; backward K2)."""
    return kernels.GatherRows.apply(data, idx)


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[e] over segment_ids[e] == s (K2, summed in
    f32), returned in ``data``'s dtype."""
    return kernels.segment_sum(data, segment_ids, num_segments).to(
        data.dtype)
