"""Masked segment ops (port of ``legion_tpu/ops/segment.py``): the row
gather, and the masked segment sum, mean and max and the segment softmax.
Convention: id -1 is padding, and an id >= num_segments is dropped too.

Each dispatches to hand-written kernels: the row gather to K1 with K2 as
its backward; the sum to K2; the mean to K2 (the sum, and the count as K2
over a column of ones) with K1 as its backward; the max to K17
``segment_max`` (``csrc/segment_max.cu``) and the softmax to K18
``segment_softmax`` (``csrc/segment_softmax.cu``), each with its
backward kernel (launches under ``segment_max_bwd`` and
``segment_softmax_bwd``). The max, the softmax and the mean are
differentiable with JAX's gradients. The K17 and K18 wrappers here run
their plain PyTorch versions for CPU tensors only; CUDA tensors launch
the kernel, any other device raises.

Where the port differs from the JAX functions (ROADMAP C):

- ``gather_rows`` gives zero rows for pad ids, not a clamped copy of row
  0. Consumers mask pads either way.
- ``masked_segment_mean`` counts a segment's lanes exactly (in f32) and
  sums in f32, rounding once; JAX counts and sums in the data's dtype, so
  in bf16 its count stops at 256.
- ``segment_softmax`` computes in f32 and rounds once; JAX rounds a bf16
  softmax after each op. An id >= num_segments is dropped like a pad;
  JAX's softmax takes it as valid and reads the last segment's max and
  denominator through its clipped gathers. Its gradient is p * (g - the
  segment's sum of p * g); ``jax.grad`` of JAX's squares the
  denominator, which underflows (NaN) where every exp of a segment is
  below about 1e-19.
- ``masked_segment_max`` in bf16 counts a result's ties exactly and
  rounds the count; JAX's bf16 count stops at 256.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from legion_tpu_torch.ops import kernels

# element types as csrc/segment_keys.cuh numbers them
SEG_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
FLOATS = (torch.float32, torch.bfloat16)
KEY_NAN = 0xFFFFFFFF          # every NaN's key: the top
KEY_POS_ZERO = 0x80000000     # +0.0's key: the softmax's floor of the max


def gather_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Differentiable row gather, zero rows for idx < 0 (K1; backward K2)."""
    return kernels.GatherRows.apply(data, idx)


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[e] over segment_ids[e] == s (K2, summed in
    f32), returned in ``data``'s dtype."""
    return kernels.segment_sum(data, segment_ids, num_segments).to(
        data.dtype)


# ---------------------------------------------------------------------------
# order-preserving keys (csrc/segment_keys.cuh), as int64 in [0, 2^32)
# ---------------------------------------------------------------------------

def order_keys_plain(x: torch.Tensor) -> torch.Tensor:
    """The key of each element of x (f32, bf16 or int32): integer max of
    keys is x's max; every NaN is the top key and -0 ranks below +0."""
    if x.dtype == torch.int32:
        return x.long() + 2 ** 31
    xf = x.float()
    b = xf.view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(b >= 2 ** 31, ~b & 0xFFFFFFFF, b | 2 ** 31)
    return torch.where(xf.isnan(), KEY_NAN, key)


def from_keys_plain(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values of keys, in ``dtype``, built from their bits (so a
    NaN's bits are the same on every device: the top key is 0x7FC00000,
    0x7FC0 in bf16, where a cast on the card would give 0x7FFF)."""
    if dtype == torch.int32:
        return (k - 2 ** 31).to(torch.int32)
    b = torch.where(k >= 2 ** 31, k ^ 2 ** 31, ~k & 0xFFFFFFFF)
    b = torch.where(k == KEY_NAN, 0x7FC00000, b)
    if dtype == torch.bfloat16:      # a bf16 value's low 16 bits are 0
        h = b >> 16
        return torch.where(h >= 2 ** 15, h - 2 ** 16, h).to(
            torch.int16).view(torch.bfloat16)
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32)
    return b.view(torch.float32)


def _lanes(seg: torch.Tensor, S: int):
    """(valid [E], row [E] int64): a lane's row, S (a row past the
    segments) where its id is a pad or >= S."""
    valid = (seg >= 0) & (seg < S)
    return valid, torch.where(valid, seg, S).long()


def _max_keys_plain(data: torch.Tensor, seg: torch.Tensor, S: int,
                    init_key: int) -> torch.Tensor:
    """[S + 1, F] int64: max of init_key and the valid lanes' keys."""
    _, row = _lanes(seg, S)
    keys = torch.full((S + 1, data.shape[1]), init_key, dtype=torch.int64,
                      device=data.device)
    return keys.scatter_reduce_(0, row[:, None].expand(data.shape),
                                order_keys_plain(data), "amax")


def _check(name: str, dtypes, data: torch.Tensor, seg: torch.Tensor) -> None:
    kernels._require(data.dim() == 2 and seg.dim() == 1
                     and seg.shape[0] == data.shape[0],
                     f"{name}: data {tuple(data.shape)}, segment ids "
                     f"{tuple(seg.shape)}")
    kernels._require(seg.dtype == torch.int32,
                     f"{name}: segment ids {seg.dtype}")
    kernels._require(data.dtype in dtypes, f"{name}: data {data.dtype}")


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version); False for CUDA tensors on
    one card (the kernel); raises on anything else."""
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return True
    kernels._require(len(devs) == 1 and next(iter(devs)).type == "cuda",
                     f"{name}: tensors on {sorted(str(d) for d in devs)}")
    return False


# ---------------------------------------------------------------------------
# K17 segment_max
# ---------------------------------------------------------------------------

def segment_max_plain(data: torch.Tensor, seg: torch.Tensor, S: int,
                      init_key: int) -> torch.Tensor:
    """out[s, f] = max(initial, max of data[e, f] over the valid lanes of
    s), by integer max of order keys: bit for bit what K17 writes."""
    keys = _max_keys_plain(data, seg, S, init_key)[:S]
    return from_keys_plain(keys, data.dtype)


def segment_max_fwd(data: torch.Tensor, seg: torch.Tensor, S: int,
                    init_key: int) -> torch.Tensor:
    """K17's forward. data [E, F] f32, bf16 or int32, seg [E] int32,
    init_key the key of initial in data's dtype -> [S, F] of data's
    dtype."""
    _check("segment_max", SEG_TYPES, data, seg)
    if _on_cpu("segment_max", data, seg):
        return segment_max_plain(data, seg, S, init_key)
    data, seg = data.contiguous(), seg.contiguous()
    E, F = data.shape
    keys = torch.empty(S * F, dtype=torch.int32, device=data.device)
    out = torch.empty((S, F), dtype=data.dtype, device=data.device)
    rc = kernels.lib().lt_segment_max_fwd(
        data.data_ptr(), SEG_TYPES[data.dtype], seg.data_ptr(), E, F, S,
        init_key, keys.data_ptr(), out.data_ptr(), kernels.stream_handle())
    kernels.check("segment_max", rc)
    return out


def segment_max_bwd_plain(data: torch.Tensor, seg: torch.Tensor,
                          out: torch.Tensor, g: torch.Tensor,
                          initial: float) -> torch.Tensor:
    """JAX's gradient of the segment max (``_scatter_extremal_jvp``,
    transposed): a lane equal to its segment's out (float equality) gets
    g[s] * (1 / n), n the lanes equal to out[s] plus one where initial
    equals it; every other lane +0. In f32, or as JAX computes it in bf16:
    n, 1 / n and the product each rounded to bf16."""
    S = out.shape[0]
    valid, row = _lanes(seg, S)
    pad = torch.zeros((1, out.shape[1]), dtype=torch.float32,
                      device=out.device)
    o = torch.cat([out.float(), pad])
    tied = valid[:, None] & (data.float() == o[row])
    n = torch.zeros(o.shape, dtype=torch.int64, device=out.device)
    n.index_add_(0, row, tied.long())
    n = (n[:S] + (out.float() == initial)).float()
    if data.dtype == torch.bfloat16:
        n = n.to(torch.bfloat16).float()
        coef = (1.0 / n).to(torch.bfloat16).float()
    else:
        coef = 1.0 / n
    r = torch.cat([g.float() * coef, pad])
    return torch.where(tied, r[row], 0.0).to(data.dtype)


def segment_max_bwd(data: torch.Tensor, seg: torch.Tensor, out: torch.Tensor,
                    g: torch.Tensor, initial: float) -> torch.Tensor:
    """K17's backward (``segment_max_bwd_plain``'s arithmetic). data
    [E, F], out and g [S, F], f32 or bf16 -> [E, F]."""
    _check("segment_max_bwd", FLOATS, data, seg)
    kernels._require(out.dtype == g.dtype == data.dtype
                     and out.shape == g.shape and out.dim() == 2
                     and out.shape[1] == data.shape[1],
                     f"segment_max_bwd: out {out.dtype} {tuple(out.shape)}, "
                     f"g {g.dtype} {tuple(g.shape)}")
    if _on_cpu("segment_max_bwd", data, seg, out, g):
        return segment_max_bwd_plain(data, seg, out, g, initial)
    data, seg, out, g = (t.contiguous() for t in (data, seg, out, g))
    (E, F), S = data.shape, out.shape[0]
    cnt = torch.empty(S * F, dtype=torch.int32, device=data.device)
    dx = torch.empty_like(data)
    rc = kernels.lib().lt_segment_max_bwd(
        data.data_ptr(), SEG_TYPES[data.dtype], seg.data_ptr(),
        out.data_ptr(), g.data_ptr(), initial, E, F, S, cnt.data_ptr(),
        dx.data_ptr(), kernels.stream_handle())
    kernels.check("segment_max_bwd", rc)
    return dx


class SegmentMax(torch.autograd.Function):
    """K17 both ways; ``initial`` already in data's dtype."""

    @staticmethod
    def forward(ctx, data, seg, num_segments, initial):
        init = torch.tensor(initial, dtype=data.dtype)
        out = segment_max_fwd(data, seg, num_segments,
                              int(order_keys_plain(init)))
        ctx.save_for_backward(data, seg, out)
        ctx.initial = float(init)
        return out

    @staticmethod
    def backward(ctx, g):
        data, seg, out = ctx.saved_tensors
        return (segment_max_bwd(data, seg, out, g, ctx.initial), None, None,
                None)


# ---------------------------------------------------------------------------
# K18 segment_softmax
# ---------------------------------------------------------------------------

def segment_softmax_plain(x: torch.Tensor, seg: torch.Tensor, S: int
                          ) -> torch.Tensor:
    """p = exp(x - m[s]) / max(d[s], tiny) for valid lanes, 0 for the
    rest; m[s] = max(0, the segment's max) (NaN if a lane is), d[s] the
    sum of its lanes' exp, all in f32, rounded once to x's dtype."""
    valid, row = _lanes(seg, S)
    v = valid[:, None]
    m = from_keys_plain(_max_keys_plain(x, seg, S, KEY_POS_ZERO),
                        torch.float32)
    e = torch.where(v, torch.exp(torch.where(v, x.float() - m[row], 0.0)),
                    0.0)
    d = torch.zeros(m.shape, dtype=torch.float32, device=x.device)
    d.index_add_(0, row, e)
    d = d.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.where(v, e / d[row], 0.0).to(x.dtype)


def segment_softmax_fwd(x: torch.Tensor, seg: torch.Tensor, S: int
                        ) -> torch.Tensor:
    """K18's forward. x [E, H] f32 or bf16, seg [E] int32 -> p [E, H]."""
    _check("segment_softmax", FLOATS, x, seg)
    if _on_cpu("segment_softmax", x, seg):
        return segment_softmax_plain(x, seg, S)
    x, seg = x.contiguous(), seg.contiguous()
    E, H = x.shape
    mkeys = torch.empty(S * H, dtype=torch.int32, device=x.device)
    denom = torch.empty(S * H, dtype=torch.float32, device=x.device)
    p = torch.empty_like(x)
    rc = kernels.lib().lt_segment_softmax_fwd(
        x.data_ptr(), SEG_TYPES[x.dtype], seg.data_ptr(), E, H, S,
        mkeys.data_ptr(), denom.data_ptr(), p.data_ptr(),
        kernels.stream_handle())
    kernels.check("segment_softmax", rc)
    return p


def segment_softmax_bwd_plain(p: torch.Tensor, g: torch.Tensor,
                              seg: torch.Tensor, S: int) -> torch.Tensor:
    """dx = p * (g - sum over the segment of p * g) for valid lanes, 0 for
    the rest, in f32, rounded once to p's dtype."""
    valid, row = _lanes(seg, S)
    v = valid[:, None]
    pf, gf = p.float(), g.float()
    sums = torch.zeros((S + 1, p.shape[1]), dtype=torch.float32,
                       device=p.device)
    sums.index_add_(0, row, torch.where(v, pf * gf, 0.0))
    return torch.where(v, pf * (gf - sums[row]), 0.0).to(p.dtype)


def segment_softmax_bwd(p: torch.Tensor, g: torch.Tensor, seg: torch.Tensor,
                        S: int) -> torch.Tensor:
    """K18's backward. p and g [E, H] f32 or bf16, seg [E] int32 -> dx
    [E, H] in p's dtype."""
    _check("segment_softmax_bwd", FLOATS, p, seg)
    kernels._require(g.dtype == p.dtype and g.shape == p.shape,
                     f"segment_softmax_bwd: p {p.dtype} {tuple(p.shape)}, "
                     f"g {g.dtype} {tuple(g.shape)}")
    if _on_cpu("segment_softmax_bwd", p, g, seg):
        return segment_softmax_bwd_plain(p, g, seg, S)
    p, g, seg = p.contiguous(), g.contiguous(), seg.contiguous()
    E, H = p.shape
    sums = torch.empty(S * H, dtype=torch.float32, device=p.device)
    dx = torch.empty_like(p)
    rc = kernels.lib().lt_segment_softmax_bwd(
        p.data_ptr(), g.data_ptr(), SEG_TYPES[p.dtype], seg.data_ptr(), E, H,
        S, sums.data_ptr(), dx.data_ptr(), kernels.stream_handle())
    kernels.check("segment_softmax_bwd", rc)
    return dx


class SegmentSoftmax(torch.autograd.Function):
    """K18 both ways; saves p and the ids."""

    @staticmethod
    def forward(ctx, x, seg, num_segments):
        p = segment_softmax_fwd(x, seg, num_segments)
        ctx.save_for_backward(p, seg)
        ctx.num_segments = num_segments
        return p

    @staticmethod
    def backward(ctx, g):
        p, seg = ctx.saved_tensors
        return segment_softmax_bwd(p, g, seg, ctx.num_segments), None, None


# ---------------------------------------------------------------------------
# the mean: K2's sum and count, K1's gather back
# ---------------------------------------------------------------------------

class SegmentMean(torch.autograd.Function):
    """out[s] = (f32 sum of the lanes of s) / max(their count, 1), cast to
    data's dtype: both by K2 (the count over a column of ones, exact to
    2^24 lanes a segment). Backward: each valid lane gets g[s] / count[s]
    (divided in f32, cast), gathered by K1; pads and ids >= S get 0."""

    @staticmethod
    def forward(ctx, data, seg, num_segments):
        ones = torch.ones((data.shape[0], 1), dtype=torch.float32,
                          device=data.device)
        cnt = kernels.segment_sum(ones, seg, num_segments).clamp_min_(1.0)
        ctx.save_for_backward(seg, cnt)
        return (kernels.segment_sum(data, seg, num_segments) / cnt).to(
            data.dtype)

    @staticmethod
    def backward(ctx, g):
        seg, cnt = ctx.saved_tensors
        S = cnt.shape[0]
        if S == 0:
            return torch.zeros((seg.shape[0], g.shape[1]), dtype=g.dtype,
                               device=g.device), None, None
        q = (g.float() / cnt).to(g.dtype)
        return kernels.gather_rows(q, torch.where(seg < S, seg, -1)), None, \
            None


# ---------------------------------------------------------------------------
# the JAX package's entry points
# ---------------------------------------------------------------------------

def _rows(data: torch.Tensor) -> torch.Tensor:
    """data [E, ...] as [E, F]: the trailing dimensions folded."""
    return data.reshape(data.shape[0], math.prod(data.shape[1:]))


def masked_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """The mean of data [E, ...] (f32 or bf16) over each segment's lanes,
    0 for an empty segment -> [num_segments, ...] in data's dtype."""
    kernels._require(data.dtype in FLOATS,
                     f"masked_segment_mean: data {data.dtype}")
    out = SegmentMean.apply(_rows(data), segment_ids, num_segments)
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


def masked_segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       initial: Optional[float] = None) -> torch.Tensor:
    """max(initial, the segment's lanes) of data [E, ...] (f32, bf16 or
    int32) -> [num_segments, ...] in data's dtype; ``initial`` defaults to
    the dtype's least finite value. Differentiable for f32 and bf16."""
    kernels._require(data.dtype in SEG_TYPES,
                     f"masked_segment_max: data {data.dtype}")
    if initial is None:
        initial = torch.finfo(data.dtype).min if data.dtype in FLOATS \
            else torch.iinfo(data.dtype).min
    out = SegmentMax.apply(_rows(data), segment_ids, num_segments, initial)
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of scores [E] or [E, H, ...] (f32 or bf16) within each
    segment, shifted by max(the segment's max, 0) and with the
    denominator floored at f32's tiny; invalid lanes get 0."""
    p = SegmentSoftmax.apply(_rows(scores), segment_ids, num_segments)
    return p.reshape(scores.shape)
