"""Dense per-hop aggregation over the sampler's fanout-major edge layout
(port of ``legion_tpu/ops/hop_agg.py``: ``hop_gather_msgs``,
``place_rows``, ``hop_neighbor_sum``, ``hop_neighbor_mean``,
``hop_softmax_attention``).

Lane f*F + i of hop k is draw f of frontier slot i, so a mean by
destination is a sum over the leading axis of a [fanout, F, d] view. The
aggregation is plain PyTorch; only the per-edge row gather of a hop that
is not lane-aligned goes through a hand-written kernel (K1, backward K2).
GAT's edge softmax and weighted sum is K7 on the card
(``kernels.hop_attention``), with its plain version here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.segment import gather_rows


def hop_gather_msgs(h_src: torch.Tensor, src_l: torch.Tensor, fanout: int,
                    aligned_offset: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge messages [fanout, F, d] and validity [fanout, F]. On a
    lane-aligned hop (position == aligned_offset + lane) the gather is a
    static slice."""
    E = src_l.shape[0]
    F = E // fanout
    d = h_src.shape[1]
    if aligned_offset is not None:
        msgs = h_src[aligned_offset:aligned_offset + E].reshape(fanout, F, d)
    else:
        msgs = gather_rows(h_src, src_l).reshape(fanout, F, d)
    return msgs, (src_l >= 0).reshape(fanout, F)


def place_rows(rows: torch.Tensor, offset: torch.Tensor, num_dst: int
               ) -> torch.Tensor:
    """Embed [F, ...] rows at [offset, offset+F) of a zeroed [num_dst, ...]
    buffer. ``offset`` is a device scalar; the sampler's buffer sizing
    keeps offset + F <= num_dst (JAX would clamp there instead)."""
    out = torch.zeros((num_dst,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    idx = offset.long() + torch.arange(rows.shape[0], device=rows.device)
    return out.index_copy(0, idx, rows)


def hop_neighbor_sum(h_src: torch.Tensor, src_l: torch.Tensor, fanout: int,
                     offset: torch.Tensor, num_dst: int,
                     aligned_offset: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum [num_dst, d], count [num_dst]) of valid neighbour rows per
    destination; bf16 inputs accumulate in f32."""
    msgs, valid = hop_gather_msgs(h_src, src_l, fanout, aligned_offset)
    acc = torch.float32 if msgs.dtype == torch.bfloat16 else msgs.dtype
    masked = torch.where(valid[..., None], msgs, torch.zeros_like(msgs))
    msum = masked.sum(dim=0, dtype=acc)
    cnt = valid.sum(dim=0).to(acc)
    return place_rows(msum, offset, num_dst), place_rows(cnt, offset,
                                                         num_dst)


def hop_neighbor_mean(h_src: torch.Tensor, src_l: torch.Tensor, fanout: int,
                      offset: torch.Tensor, num_dst: int,
                      aligned_offset: Optional[int] = None) -> torch.Tensor:
    s, c = hop_neighbor_sum(h_src, src_l, fanout, offset, num_dst,
                            aligned_offset)
    return s / c.clamp(min=1)[:, None]


def hop_softmax_attention_plain(z: torch.Tensor, scores: torch.Tensor,
                                src_l: torch.Tensor, fanout: int,
                                offset: torch.Tensor, num_dst: int,
                                keep=None,
                                aligned_offset: Optional[int] = None
                                ) -> torch.Tensor:
    """K7's plain version: a sum over fanout slices, which never builds
    the [fanout, F, H, d] edge messages (JAX's dense and chunked branches
    compute the same sum). Pads read row 0 and carry alpha 0. z is widened
    to f32 once, so the gradient of a bf16 z is summed in f32 and cast
    once, as K7 does (JAX's gather transpose sums in bf16). Returns f32
    (JAX returns z's dtype from its chunked branch)."""
    E = src_l.shape[0]
    F = E // fanout
    N, H, d = z.shape
    z2 = z.reshape(N, H * d).float()
    valid = (src_l >= 0).reshape(fanout, F)[..., None]
    alpha = kernels.masked_fanout_softmax(scores, valid)   # [fo, F, H]
    if keep is not None:
        alpha = torch.where(keep[0], alpha * keep[1], 0.0)
    out = torch.zeros((F, H, d), dtype=torch.float32, device=z.device)
    for f in range(fanout):
        if aligned_offset is not None:
            rows = z2[aligned_offset + f * F:aligned_offset + (f + 1) * F]
        else:
            rows = z2[src_l[f * F:(f + 1) * F].clamp(min=0).long()]
        out = out + alpha[f][..., None] * rows.reshape(F, H, d)
    return place_rows(out, offset, num_dst)


def hop_softmax_attention(z: torch.Tensor, scores: torch.Tensor,
                          src_l: torch.Tensor, fanout: int,
                          offset: torch.Tensor, num_dst: int, keep=None,
                          aligned_offset: Optional[int] = None
                          ) -> torch.Tensor:
    """GAT's per-destination softmax and weighted sum over a hop. z
    [N_src, H, d] projected rows; scores [fanout, F, H] f32 edge scores
    (LeakyReLU applied, fanout-major); keep = (bool mask, scale) of
    attention dropout, or None. Returns [num_dst, H, d] f32. CPU tensors
    take the plain version; CUDA tensors K7."""
    if z.device.type == "cpu" and scores.device.type == "cpu":
        return hop_softmax_attention_plain(z, scores, src_l, fanout, offset,
                                           num_dst, keep, aligned_offset)
    N, H, d = z.shape
    return kernels.hop_attention(z.reshape(N, H * d), scores, src_l, fanout,
                                 offset, num_dst, H, aligned_offset, keep)
