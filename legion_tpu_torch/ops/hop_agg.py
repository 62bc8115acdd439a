"""Dense per-hop aggregation over the sampler's fanout-major edge layout
(port of ``legion_tpu/ops/hop_agg.py``: ``hop_gather_msgs``,
``place_rows``, ``hop_neighbor_sum``, ``hop_neighbor_mean``,
``hop_softmax_attention``).

Lane f*F + i of hop k is draw f of frontier slot i, so a mean by
destination is a sum over the leading axis of a [fanout, F, d] view.
``hop_neighbor_sum`` and ``hop_neighbor_mean`` are K15 ``hop_mean`` on the
card (``kernels.hop_mean``, ``csrc/hop_agg.cu``), with their plain versions
here: a lane's row is gathered by its local index (form (a)), sliced on a
lane-aligned hop (b), or, on the aligned last hop of a batch whose
features were fetched up to that hop only (``TableRows``), read from the
feature table by the lane's id (c), as JAX's XLA sums the rows of that hop
where it gathers them. Form (a)'s backward is ``kernels.hop_mean_grad`` on
the card, with its plain versions here (``hop_mean_grad_plain``, and
``lanes_by_source_plain`` for its grouping of lanes by row). GAT's edge
softmax and weighted sum is K7 on the card (``kernels.hop_attention``),
with its plain version here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.dropout import attn_dropout_plain


class TableRows(NamedTuple):
    """A batch's features with its aligned last hop left in the table:
    ``head`` [P, F] holds the rows of ids[:P] (P the hop's aligned
    offset), as the whole fetch would, and lane l of the hop reads
    table[ids[P + l]] (K15's form (c), at layer 0). ``ids`` is the batch's
    id prefix the whole fetch would read, [max_ids] int32."""
    head: torch.Tensor
    table: torch.Tensor
    ids: torch.Tensor


def hop_gather_msgs(h_src: torch.Tensor, src_l: torch.Tensor, fanout: int,
                    aligned_offset: Optional[int] = None,
                    ids: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge messages [fanout, F, d] and validity [fanout, F]. On a
    lane-aligned hop (position == aligned_offset + lane) the gather is a
    static slice; with ``ids``, h_src is the feature table and the slice's
    rows are fetched from it (zero rows for ids < 0, as the fetch gives).
    A gathered pad lane reads a clamped row, masked by its validity. A
    bf16 gather is widened to f32 first, so that its gradient is summed in
    f32 and cast once, as K15's backward does."""
    E = src_l.shape[0]
    F = E // fanout
    d = h_src.shape[1]
    if ids is not None:
        msgs = kernels.gather_rows_plain(
            h_src, ids[aligned_offset:aligned_offset + E])
    elif aligned_offset is not None:
        msgs = h_src[aligned_offset:aligned_offset + E]
    else:
        # index_select: its gradient is an index_add_, which sums in a
        # fixed order on the CPU (an index's accumulating put does not)
        msgs = h_src.float().index_select(
            0, src_l.clamp(0, h_src.shape[0] - 1).long())
    return msgs.reshape(fanout, F, d), (src_l >= 0).reshape(fanout, F)


def placed_offset(offset: torch.Tensor, F: int, num_dst: int
                  ) -> torch.Tensor:
    """Where [F, ...] rows land in [num_dst, ...], as JAX's
    dynamic_update_slice places a start (and K15 does): a negative offset
    wrapped by num_dst, then clamped to [0, num_dst - F]. The sampler's
    offsets are in range already. A 0-dim int64 tensor."""
    o = offset.reshape(()).long()
    return torch.where(o < 0, o + num_dst, o).clamp(0, num_dst - F)


def place_rows(rows: torch.Tensor, offset: torch.Tensor, num_dst: int
               ) -> torch.Tensor:
    """Embed [F, ...] rows at [offset, offset+F) of a zeroed [num_dst, ...]
    buffer; ``offset`` is a device scalar, placed by ``placed_offset``."""
    out = torch.zeros((num_dst,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    F = rows.shape[0]
    idx = placed_offset(offset, F, num_dst) + torch.arange(
        F, device=rows.device)
    return out.index_copy(0, idx, rows)


def hop_neighbor_sum_plain(h_src: torch.Tensor, src_l: torch.Tensor,
                           fanout: int, offset: torch.Tensor, num_dst: int,
                           aligned_offset: Optional[int] = None,
                           ids: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15's plain version: (sum [num_dst, d], count [num_dst]) of valid
    neighbour rows per destination, f32."""
    msgs, valid = hop_gather_msgs(h_src, src_l, fanout, aligned_offset, ids)
    masked = torch.where(valid[..., None], msgs, torch.zeros_like(msgs))
    msum = masked.sum(dim=0, dtype=torch.float32)
    cnt = valid.sum(dim=0).to(torch.float32)
    return place_rows(msum, offset, num_dst), place_rows(cnt, offset,
                                                         num_dst)


def hop_neighbor_mean_plain(h_src: torch.Tensor, src_l: torch.Tensor,
                            fanout: int, offset: torch.Tensor, num_dst: int,
                            aligned_offset: Optional[int] = None,
                            ids: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    s, c = hop_neighbor_sum_plain(h_src, src_l, fanout, offset, num_dst,
                                  aligned_offset, ids)
    return s / c.clamp(min=1)[:, None]


def lanes_by_source_plain(src_l: torch.Tensor, num_rows: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouping of ``hop_mean_grad``'s plain version: (lanes, starts)
    int32, the valid lanes (src_l >= 0) grouped by the row they read (src
    clamped to num_rows - 1, as the forward reads it), each group in
    ascending lane order (a stable argsort of the rows, pads dropped);
    group r is lanes[starts[r]:starts[r + 1]]."""
    lanes = torch.nonzero(src_l >= 0).flatten()
    rows = src_l[lanes].clamp(max=num_rows - 1).long()
    order = torch.sort(rows, stable=True).indices
    counts = torch.bincount(rows, minlength=num_rows)
    starts = torch.zeros(num_rows + 1, dtype=torch.int64,
                         device=src_l.device)
    starts[1:] = torch.cumsum(counts, 0)
    return lanes[order].to(torch.int32), starts.to(torch.int32)


def hop_mean_grad_plain(dout: torch.Tensor, src_l: torch.Tensor,
                        num_rows: int, dtype: torch.dtype,
                        hop_offset: torch.Tensor, F: int,
                        count: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K15's backward on a gathered hop, plain: d rows [num_rows, d] in
    ``dtype``, row r the f32 sum of dout[offset + lane % F] (divided by
    max(count[offset + lane % F], 1) when the mean's ``count`` is given)
    over the valid lanes that read r (src clamped to the last row), cast
    once; offset placed by ``placed_offset``."""
    E = src_l.shape[0]
    dst = placed_offset(hop_offset, F, dout.shape[0]) + torch.arange(
        E, device=dout.device) % F
    rows = dout.float()[dst]
    if count is not None:
        rows = rows / count[dst].clamp(min=1)[:, None]
    valid = src_l >= 0
    out = torch.zeros((num_rows, dout.shape[1]), dtype=torch.float32,
                      device=dout.device)
    out.index_add_(0, src_l[valid].clamp(max=num_rows - 1).long(),
                   rows[valid])
    return out.to(dtype)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def hop_neighbor_sum(h_src: torch.Tensor, src_l: torch.Tensor, fanout: int,
                     offset: torch.Tensor, num_dst: int,
                     aligned_offset: Optional[int] = None,
                     ids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum [num_dst, d], count [num_dst]) f32 of the valid neighbour rows
    of each destination; bf16 inputs accumulate in f32. With ``ids``,
    h_src is the feature table and lane l's row is h_src[ids[
    aligned_offset + l]]. CPU tensors take the plain version, CUDA tensors
    K15; anything else raises."""
    if _on_cpu(h_src, src_l, offset, ids):
        kernels.hop_mean_checks(h_src, src_l, fanout, offset, num_dst,
                                aligned_offset, ids)
        return hop_neighbor_sum_plain(h_src, src_l, fanout, offset, num_dst,
                                      aligned_offset, ids)
    return kernels.hop_mean(h_src, src_l, fanout, offset, num_dst,
                            aligned_offset, ids, mean=False)


def hop_neighbor_mean(h_src: torch.Tensor, src_l: torch.Tensor, fanout: int,
                      offset: torch.Tensor, num_dst: int,
                      aligned_offset: Optional[int] = None,
                      ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of ``hop_neighbor_sum``: sum / max(count, 1)."""
    if _on_cpu(h_src, src_l, offset, ids):
        kernels.hop_mean_checks(h_src, src_l, fanout, offset, num_dst,
                                aligned_offset, ids)
        return hop_neighbor_mean_plain(h_src, src_l, fanout, offset,
                                       num_dst, aligned_offset, ids)
    return kernels.hop_mean(h_src, src_l, fanout, offset, num_dst,
                            aligned_offset, ids, mean=True)[0]


def hop_softmax_attention_plain(z: torch.Tensor, scores: torch.Tensor,
                                src_l: torch.Tensor, fanout: int,
                                offset: torch.Tensor, num_dst: int,
                                drop=None,
                                aligned_offset: Optional[int] = None
                                ) -> torch.Tensor:
    """K7's plain version: a sum over fanout slices, which never builds
    the [fanout, F, H, d] edge messages (JAX's dense and chunked branches
    compute the same sum). Pads read row 0 and carry alpha 0. z is widened
    to f32 once, so the gradient of a bf16 z is summed in f32 and cast
    once, as K7 does (JAX's gather transpose sums in bf16). Attention
    dropout (``drop``, an ``ops/dropout.py::AttnDrop``, or None) is
    ``attn_dropout_plain``, JAX's arithmetic on K7's keep bits. Returns
    f32 (JAX returns z's dtype from its chunked branch)."""
    E = src_l.shape[0]
    F = E // fanout
    N, H, d = z.shape
    z2 = z.reshape(N, H * d).float()
    valid = (src_l >= 0).reshape(fanout, F)[..., None]
    alpha = attn_dropout_plain(kernels.masked_fanout_softmax(scores, valid),
                               drop)                       # [fo, F, H]
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
                          offset: torch.Tensor, num_dst: int, drop=None,
                          aligned_offset: Optional[int] = None
                          ) -> torch.Tensor:
    """GAT's per-destination softmax and weighted sum over a hop. z
    [N_src, H, d] projected rows; scores [fanout, F, H] f32 edge scores
    (LeakyReLU applied, fanout-major); ``drop`` attention dropout (an
    ``ops/dropout.py::AttnDrop``: the step's dropout key words, the layer,
    the rate) or None. Returns [num_dst, H, d] f32. CPU tensors take the
    plain version; CUDA tensors K7, which draws the keep bits itself."""
    if z.device.type == "cpu" and scores.device.type == "cpu":
        return hop_softmax_attention_plain(z, scores, src_l, fanout, offset,
                                           num_dst, drop, aligned_offset)
    N, H, d = z.shape
    return kernels.hop_attention(z.reshape(N, H * d), scores, src_l, fanout,
                                 offset, num_dst, H, aligned_offset, drop)
