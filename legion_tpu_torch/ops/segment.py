"""Masked segment ops (port of ``legion_tpu/ops/segment.py``): the row
gather, and the masked segment sum, mean and max and the segment softmax.
Convention: id -1 is padding, and an id >= num_segments is dropped too.

What the five public functions take, give and differentiate (E lanes, S
segments, V table rows; "..." any trailing dimensions, folded into one
inside):

- ``gather_rows(data, idx)``: data [V, ...] of any dtype, idx of any
  shape -> ``idx.shape + data.shape[1:]`` in data's dtype. Gradient (f32,
  bf16, f16, f64): each lane's row summed into clip(id, ., V - 1), an id
  >= V into row V - 1; a pad adds nothing.
- ``masked_segment_sum``: data [E, ...] f32, bf16, f16, f64 or int32, ids
  [E] -> data's dtype. Gradient (floats): g[seg], 0 for a pad or an id
  >= S.
- ``masked_segment_mean``: as the sum -> data's dtype, f32 for int32.
  Gradient (floats): g / count, gathered.
- ``masked_segment_max``: data [E, ...] f32, bf16, f16 or int32 ->
  data's dtype. Gradient: f32, bf16, f16.
- ``segment_softmax``: data [E, ...] f32, bf16 or f16 -> data's dtype.
  Gradient: f32, bf16, f16.

Ids may be of any integer dtype but uint64: int32 ids pass as they are;
others are clamped on their own device (segment ids to [-1, S], gather ids
to [-1, V - 1]) and then cast to int32, so no id wraps (``narrow_ids``).
Any other dtype of data raises a ValueError that names the function and
the dtype (int64 or bool data, f64 in the max and the softmax): the order
keys and the accumulators are 32-bit or f64 sums. Nothing falls back to
plain PyTorch for CUDA tensors.

Each dispatches to hand-written kernels: the row gather to K1 with K2 as
its backward; the sum to K2 (``SegmentSum``; an int32 form for int32 data)
with K1 as its backward; the mean to K2 (the sum, and the count as K2
over a column of ones) with K1 as its backward; the max to K17
``segment_max`` (``csrc/segment_max.cu``) and the softmax to K18
``segment_softmax`` (``csrc/segment_softmax.cu``), each with its
backward kernel (launches under ``segment_max_bwd`` and
``segment_softmax_bwd``). K17 and K18 work segment by segment: their
forward first groups the valid lanes by segment (``csrc/hop_agg.cu``'s
grouping, whose plain version is ``segment_groups_plain``), and their
backward reads that grouping, which the autograd Functions keep. The K17
and K18 wrappers here run their plain PyTorch versions for CPU tensors
only; CUDA tensors launch the kernel, any other device raises.

Where the port differs from the JAX functions (ROADMAP C):

- ``gather_rows`` gives zero rows for pad ids, not a clamped copy of row
  0. Consumers mask pads either way.
- The sum of bf16 or f16 data is taken in f32 and rounded once; JAX
  scatter-adds in the data's dtype.
- ``masked_segment_mean`` counts a segment's lanes exactly (in int32) and
  sums in f32 (f64 for f64 data), rounding once; JAX counts and sums in
  the data's dtype, so in bf16 its count stops at 256 and in f16 at 2048.
- ``segment_softmax`` computes in f32 and rounds once; JAX rounds a bf16
  or f16 softmax after each op. An id >= num_segments is dropped like a
  pad; JAX's softmax takes it as valid and reads the last segment's max
  and denominator through its clipped gathers. Its gradient is p * (g -
  the segment's sum of p * g); ``jax.grad`` of JAX's squares the
  denominator, which underflows (NaN) where every exp of a segment is
  below about 1e-19.
- ``masked_segment_max`` in bf16 or f16 counts a result's ties exactly
  and rounds the count; JAX's count stops at 256 (bf16) or 2048 (f16).
- An int64 id past 2^32 is dropped (or, in the gather, clamped to the
  last row); JAX's scatters truncate it to its low 32 bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.hop_agg import lanes_by_source_plain

# element types as csrc/segment_keys.cuh numbers them
SEG_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
             torch.float16: 3}
FLOATS = (torch.float32, torch.bfloat16, torch.float16)
# the data the sum and the mean take (K2's forms), and those with a gradient
SUM_TYPES = tuple(kernels.SUM_ACC)
GRAD_TYPES = FLOATS + (torch.float64,)
# the ids' dtypes: every integer dtype but uint64, whose values int64
# cannot hold (and on which torch has no comparison)
ID_TYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
            torch.uint16, torch.uint32)
KEY_NAN = 0xFFFFFFFF          # every NaN's key: the top
KEY_POS_ZERO = 0x80000000     # +0.0's key: the softmax's floor of the max
F16_NAN = 0x7E00              # the f16 NaN the CPU's cast and the kernels give


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
    0x7FC0 in bf16 and 0x7E00 in f16, where a cast on the card may give
    other NaN bits)."""
    if dtype == torch.int32:
        return (k - 2 ** 31).to(torch.int32)
    b = torch.where(k >= 2 ** 31, k ^ 2 ** 31, ~k & 0xFFFFFFFF)
    b = torch.where(k == KEY_NAN, 0x7FC00000, b)
    if dtype == torch.bfloat16:      # a bf16 value's low 16 bits are 0
        h = b >> 16
        return torch.where(h >= 2 ** 15, h - 2 ** 16, h).to(
            torch.int16).view(torch.bfloat16)
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32)
    if dtype == torch.float16:       # the f32 of an f16 value: cast exactly
        h = b.view(torch.float32).to(torch.float16).view(torch.int16)
        return torch.where(k == KEY_NAN, F16_NAN, h).to(
            torch.int16).view(torch.float16)
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


def narrow_ids(ids: torch.Tensor, n: int, hi: int, name: str
               ) -> torch.Tensor:
    """ids of an integer dtype as the kernels' int32: int32 ids as they are
    (no pass); any other integer dtype clamped to [-1, hi] on its own
    device, then cast, so that no id wraps. ``n`` is S (segment ids, hi =
    S: an id >= S stays dropped) or V (gather ids, hi = V - 1: an id past
    the table reads its last row); an n of 2^31 or more is refused."""
    kernels._require(ids.dtype in ID_TYPES,
                     f"{name}: ids {ids.dtype} (an integer dtype but "
                     "uint64)")
    kernels._require(0 <= n < 2 ** 31,
                     f"{name}: {n} segments or rows (int32 ids hold fewer "
                     "than 2^31)")
    if ids.dtype == torch.int32:
        return ids
    return ids.long().clamp(-1, hi).to(torch.int32)


def _check(name: str, dtypes, data: torch.Tensor, seg: torch.Tensor,
           S: int) -> torch.Tensor:
    """Checks a kernel call's [E, F] data and [E] ids; returns the ids as
    int32 (``narrow_ids``)."""
    kernels._require(data.dim() == 2 and seg.dim() == 1
                     and seg.shape[0] == data.shape[0],
                     f"{name}: data {tuple(data.shape)}, segment ids "
                     f"{tuple(seg.shape)}")
    kernels._require(data.dtype in dtypes, f"{name}: data {data.dtype}")
    return narrow_ids(seg, S, S, name)


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
# the grouping of the lanes by segment (K17, K18)
# ---------------------------------------------------------------------------

def segment_groups_plain(seg: torch.Tensor, S: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lanes, starts) int32: the valid lanes (0 <= seg < S) grouped by
    segment, each group in ascending lane order, group s
    lanes[starts[s]:starts[s + 1]]; what the kernels' grouping holds."""
    return lanes_by_source_plain(seg, S, drop=True)


@functools.lru_cache(maxsize=64)
def _words(S: int, E: int, tmp: bool) -> int:
    return kernels.lib().lt_segment_groups_words(S, E, int(tmp))


def segment_groups(seg: torch.Tensor, S: int, sort: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouping K18 (``sort``) or K17 (each run in any order) runs
    first, alone, read back as ``segment_groups_plain`` gives it: the
    kernels' for CUDA ids, the plain version for CPU ids. For holding the
    kernels against the plain version; on no path, not counted in
    ``LAUNCHES``."""
    kernels._require(seg.dim() == 1 and seg.dtype == torch.int32,
                     f"segment_groups: ids {seg.dtype} {tuple(seg.shape)}")
    if _on_cpu("segment_groups", seg):
        return segment_groups_plain(seg, S)
    seg = seg.contiguous()
    E = seg.shape[0]
    groups, tmp = _group_args(seg, S, None, "segment_groups")
    kernels._check_probe("segment_groups", kernels.lib().lt_segment_groups(
        seg.data_ptr(), E, S, groups.data_ptr(), tmp.data_ptr(), int(sort),
        kernels.stream_handle()))
    at = (ctypes.c_int64 * 3)()
    kernels.lib().lt_segment_groups_layout(S, E, at)
    cnt, start, lanes = (groups[o:o + n] for o, n in zip(at, (S, S, E)))
    return kernels.runs_in_order(lanes, start, cnt)


def segment_groups_buffer(seg: torch.Tensor, S: int
                          ) -> Optional[torch.Tensor]:
    """Where a K17 or K18 forward on CUDA ids writes its grouping of the
    lanes, for its backward (int32 words, ``csrc/lane_groups.cuh``); None
    for CPU ids, whose plain versions keep no grouping."""
    if seg.device.type == "cpu":
        return None
    return torch.empty(_words(S, seg.shape[0], False), dtype=torch.int32,
                       device=seg.device)


def _group_args(seg: torch.Tensor, S: int, groups: Optional[torch.Tensor],
                name: str):
    """(groups, tmp) for a forward: ``groups`` (checked) or a buffer of
    its own, and the build's scratch."""
    if groups is None:
        groups = segment_groups_buffer(seg, S)
    return (_given(seg, S, groups, name),
            torch.empty(_words(S, seg.shape[0], True), dtype=torch.int32,
                        device=seg.device))


def _given(seg: torch.Tensor, S: int, groups: Optional[torch.Tensor],
           name: str) -> torch.Tensor:
    """``groups``, checked to be a grouping buffer for seg's shape."""
    kernels._require(isinstance(groups, torch.Tensor)
                     and groups.dtype == torch.int32
                     and groups.device == seg.device
                     and groups.numel() == _words(S, seg.shape[0], False),
                     f"{name}: groups are not a grouping of seg "
                     "(segment_groups_buffer, filled by the forward)")
    return groups


def _part(E: int, cols: int, device) -> torch.Tensor:
    """Scratch for the chunks of a call's long runs (hubs)."""
    return torch.empty(kernels.lib().lt_segment_part_words(E, cols),
                       dtype=torch.int32, device=device)


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
                    init_key: int, groups: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """K17's forward. data [E, F] f32, bf16, f16 or int32, seg [E] of an
    integer dtype (``narrow_ids``), init_key the key of initial in data's
    dtype -> [S, F] of data's dtype. On CUDA the call groups the lanes by
    segment first, into ``groups`` where given (``segment_groups_buffer``:
    the grouping the backward reads); on the CPU ``groups`` is None."""
    seg = _check("segment_max", SEG_TYPES, data, seg, S)
    if _on_cpu("segment_max", data, seg):
        kernels._require(groups is None, "segment_max: groups on the CPU")
        return segment_max_plain(data, seg, S, init_key)
    data, seg = data.contiguous(), seg.contiguous()
    E, F = data.shape
    groups, tmp = _group_args(seg, S, groups, "segment_max")
    out = torch.empty((S, F), dtype=data.dtype, device=data.device)
    rc = kernels.lib().lt_segment_max_fwd(
        data.data_ptr(), SEG_TYPES[data.dtype], seg.data_ptr(), E, F, S,
        init_key, groups.data_ptr(), tmp.data_ptr(),
        _part(E, F, data.device).data_ptr(), out.data_ptr(),
        kernels.stream_handle())
    kernels.check("segment_max", rc)
    return out


def segment_max_bwd_plain(data: torch.Tensor, seg: torch.Tensor,
                          out: torch.Tensor, g: torch.Tensor,
                          initial: float) -> torch.Tensor:
    """JAX's gradient of the segment max (``_scatter_extremal_jvp``,
    transposed): a lane equal to its segment's out (float equality) gets
    g[s] * (1 / n), n the lanes equal to out[s] plus one where initial
    equals it; every other lane +0. In f32, or as JAX computes it in bf16
    or f16: n, 1 / n and the product each rounded to that type."""
    S = out.shape[0]
    valid, row = _lanes(seg, S)
    pad = torch.zeros((1, out.shape[1]), dtype=torch.float32,
                      device=out.device)
    o = torch.cat([out.float(), pad])
    tied = valid[:, None] & (data.float() == o[row])
    n = torch.zeros(o.shape, dtype=torch.int64, device=out.device)
    n.index_add_(0, row, tied.long())
    n = (n[:S] + (out.float() == initial)).float()
    if data.dtype in (torch.bfloat16, torch.float16):
        n = n.to(data.dtype).float()
        coef = (1.0 / n).to(data.dtype).float()
    else:
        coef = 1.0 / n
    r = torch.cat([g.float() * coef, pad])
    return torch.where(tied, r[row], 0.0).to(data.dtype)


def segment_max_bwd(data: torch.Tensor, seg: torch.Tensor, out: torch.Tensor,
                    g: torch.Tensor, initial: float,
                    groups: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K17's backward (``segment_max_bwd_plain``'s arithmetic). data
    [E, F], out and g [S, F], f32, bf16 or f16 -> [E, F]. On CUDA ``groups``
    is the grouping that the forward of out wrote (required; the
    backward does not group); on the CPU it is not read."""
    seg = _check("segment_max_bwd", FLOATS, data, seg,
                 out.shape[0] if out.dim() else 0)
    kernels._require(out.dtype == g.dtype == data.dtype
                     and out.shape == g.shape and out.dim() == 2
                     and out.shape[1] == data.shape[1],
                     f"segment_max_bwd: out {out.dtype} {tuple(out.shape)}, "
                     f"g {g.dtype} {tuple(g.shape)}")
    if _on_cpu("segment_max_bwd", data, seg, out, g):
        return segment_max_bwd_plain(data, seg, out, g, initial)
    data, seg, out, g = (t.contiguous() for t in (data, seg, out, g))
    (E, F), S = data.shape, out.shape[0]
    groups = _given(seg, S, groups, "segment_max_bwd")
    dx = torch.empty_like(data)
    rc = kernels.lib().lt_segment_max_bwd(
        data.data_ptr(), SEG_TYPES[data.dtype], seg.data_ptr(),
        out.data_ptr(), g.data_ptr(), initial, E, F, S, groups.data_ptr(),
        _part(E, F, data.device).data_ptr(), dx.data_ptr(),
        kernels.stream_handle())
    kernels.check("segment_max_bwd", rc)
    return dx


class SegmentMax(torch.autograd.Function):
    """K17 both ways; ``initial`` already in data's dtype. On CUDA the
    forward's grouping of the lanes is kept for the backward
    (``ctx.groups``; None on the CPU)."""

    @staticmethod
    def forward(ctx, data, seg, num_segments, initial):
        init = torch.tensor(initial, dtype=data.dtype)
        key = int(order_keys_plain(init))
        if not ctx.needs_input_grad[0]:
            return segment_max_fwd(data, seg, num_segments, key)
        ctx.groups = segment_groups_buffer(seg, num_segments)
        out = segment_max_fwd(data, seg, num_segments, key, ctx.groups)
        ctx.save_for_backward(data, seg, out)
        ctx.initial = float(init)
        return out

    @staticmethod
    def backward(ctx, g):
        data, seg, out = ctx.saved_tensors
        return (segment_max_bwd(data, seg, out, g, ctx.initial, ctx.groups),
                None, None, None)


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


def segment_softmax_fwd(x: torch.Tensor, seg: torch.Tensor, S: int,
                        groups: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K18's forward. x [E, H] f32, bf16 or f16, seg [E] of an integer
    dtype -> p [E, H].
    On CUDA the call groups the lanes by segment first, each group in
    ascending lane order, into ``groups`` where given
    (``segment_groups_buffer``: the grouping the backward reads); on the
    CPU ``groups`` is None."""
    seg = _check("segment_softmax", FLOATS, x, seg, S)
    if _on_cpu("segment_softmax", x, seg):
        kernels._require(groups is None,
                         "segment_softmax: groups on the CPU")
        return segment_softmax_plain(x, seg, S)
    x, seg = x.contiguous(), seg.contiguous()
    E, H = x.shape
    groups, tmp = _group_args(seg, S, groups, "segment_softmax")
    p = torch.empty_like(x)
    rc = kernels.lib().lt_segment_softmax_fwd(
        x.data_ptr(), SEG_TYPES[x.dtype], seg.data_ptr(), E, H, S,
        groups.data_ptr(), tmp.data_ptr(),
        _part(E, 2 * H, x.device).data_ptr(), p.data_ptr(),
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
                        S: int, groups: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K18's backward. p and g [E, H] f32, bf16 or f16, seg [E] of an
    integer dtype -> dx [E, H] in p's dtype. On CUDA ``groups`` is the
    grouping that the forward of p wrote (required; its lane order fixes
    the sums' order, and the backward does not group); on the CPU it is
    not read."""
    seg = _check("segment_softmax_bwd", FLOATS, p, seg, S)
    kernels._require(g.dtype == p.dtype and g.shape == p.shape,
                     f"segment_softmax_bwd: p {p.dtype} {tuple(p.shape)}, "
                     f"g {g.dtype} {tuple(g.shape)}")
    if _on_cpu("segment_softmax_bwd", p, g, seg):
        return segment_softmax_bwd_plain(p, g, seg, S)
    p, g, seg = p.contiguous(), g.contiguous(), seg.contiguous()
    E, H = p.shape
    groups = _given(seg, S, groups, "segment_softmax_bwd")
    dx = torch.empty_like(p)
    rc = kernels.lib().lt_segment_softmax_bwd(
        p.data_ptr(), g.data_ptr(), SEG_TYPES[p.dtype], seg.data_ptr(), E, H,
        S, groups.data_ptr(), _part(E, H, p.device).data_ptr(),
        dx.data_ptr(), kernels.stream_handle())
    kernels.check("segment_softmax_bwd", rc)
    return dx


class SegmentSoftmax(torch.autograd.Function):
    """K18 both ways; saves p, the ids and, on CUDA, the forward's
    grouping of the lanes (``ctx.groups``; None on the CPU)."""

    @staticmethod
    def forward(ctx, x, seg, num_segments):
        if not ctx.needs_input_grad[0]:
            return segment_softmax_fwd(x, seg, num_segments)
        ctx.groups = segment_groups_buffer(seg, num_segments)
        p = segment_softmax_fwd(x, seg, num_segments, ctx.groups)
        ctx.save_for_backward(p, seg)
        ctx.num_segments = num_segments
        return p

    @staticmethod
    def backward(ctx, g):
        p, seg = ctx.saved_tensors
        return (segment_softmax_bwd(p, g, seg, ctx.num_segments, ctx.groups),
                None, None)


# ---------------------------------------------------------------------------
# the sum and the mean: K2 forward, K1's gather back
# ---------------------------------------------------------------------------

def _gather_back(g: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Lane e's row of g [S, F] by K1: g[seg[e]], a zero row for a pad or
    an id >= S (the transpose of JAX's scatter with mode="drop")."""
    S = g.shape[0]
    if S == 0:
        return g.new_zeros((seg.shape[0], g.shape[1]))
    return kernels.gather_rows(g, torch.where(seg < S, seg, -1))


class SegmentSum(torch.autograd.Function):
    """K2 forward (f32 accumulators for f32, bf16 and f16 data, f64 for
    f64, exact int32 sums for int32), cast to data's dtype; backward K1:
    lane e gets g[seg[e]], 0 for a pad or an id >= S, on the card as on
    the CPU."""

    @staticmethod
    def forward(ctx, data, seg, num_segments):
        ctx.save_for_backward(seg)
        return kernels.segment_sum(data, seg, num_segments).to(data.dtype)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return _gather_back(g, seg), None, None


class SegmentMean(torch.autograd.Function):
    """out[s] = (the sum of the lanes of s) / max(their count, 1), both by
    K2 (the sum in f32, f64 for f64 data, int32 for int32; the count
    exactly, over a column of int32 ones), divided once and cast to data's
    dtype; int32 data gives f32, as JAX's true division of two int32
    arrays does (both converted to f32). Backward: each valid lane gets
    g[s] / count[s] (divided in f32, f64 for f64, cast), gathered by K1;
    pads and ids >= S get 0."""

    @staticmethod
    def forward(ctx, data, seg, num_segments):
        ones = torch.ones((data.shape[0], 1), dtype=torch.int32,
                          device=data.device)
        cnt = kernels.segment_sum(ones, seg, num_segments).clamp_min_(1)
        ctx.save_for_backward(seg, cnt)
        out = kernels.segment_sum(data, seg, num_segments) / cnt
        return out if data.dtype == torch.int32 else out.to(data.dtype)

    @staticmethod
    def backward(ctx, g):
        seg, cnt = ctx.saved_tensors
        acc = torch.float64 if g.dtype == torch.float64 else torch.float32
        return _gather_back((g.to(acc) / cnt).to(g.dtype), seg), None, None


# ---------------------------------------------------------------------------
# the JAX package's entry points
# ---------------------------------------------------------------------------

def _rows(data: torch.Tensor) -> torch.Tensor:
    """data [E, ...] as [E, F]: the trailing dimensions folded."""
    return data.reshape(data.shape[0], math.prod(data.shape[1:]))


def _segment_args(name: str, dtypes, data: torch.Tensor,
                  segment_ids: torch.Tensor, num_segments: int):
    """(data as [E, F], the ids as int32) for a public segment op; raises
    a ValueError for a dtype outside ``dtypes`` or mismatched shapes."""
    kernels._require(data.dtype in dtypes, f"{name}: data {data.dtype}")
    kernels._require(data.dim() >= 1 and segment_ids.dim() == 1
                     and segment_ids.shape[0] == data.shape[0],
                     f"{name}: data {tuple(data.shape)}, segment ids "
                     f"{tuple(segment_ids.shape)}")
    return _rows(data), narrow_ids(segment_ids, num_segments, num_segments,
                                   name)


def _shaped(out: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """out [S, F] as [S, ...]: data's trailing dimensions unfolded."""
    return out.reshape((out.shape[0],) + tuple(data.shape[1:]))


def gather_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data[clip(idx, ., V - 1)] of shape ``idx.shape + data.shape[1:]``,
    a zero row where idx < 0 (K1, any dtype, rows copied as opaque words;
    idx of any shape and integer dtype). Differentiable for f32, bf16, f16
    and f64 (K2): a row's gradient sums its lanes', an id >= V adding to
    row V - 1; a pad adds nothing."""
    kernels._require(data.dim() >= 1, f"gather_rows: data "
                     f"{tuple(data.shape)}")
    kernels._require(not data.requires_grad or data.dtype in GRAD_TYPES,
                     f"gather_rows: no gradient for data {data.dtype}")
    V = data.shape[0]
    shape = tuple(idx.shape) + tuple(data.shape[1:])
    ids = narrow_ids(idx.reshape(-1), V, V - 1, "gather_rows")
    if V == 0:     # JAX's gather refuses any id into an empty table
        kernels._require(ids.numel() == 0, "gather_rows: an empty table")
        return data.new_zeros(shape)
    return kernels.GatherRows.apply(_rows(data), ids).reshape(shape)


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[e] over segment_ids[e] == s, data [E, ...]
    f32, bf16, f16, f64 or int32 -> [num_segments, ...] in data's dtype.
    K2: floats summed in f32 (f64 for f64) and rounded once, int32 exactly
    (wrapping modulo 2^32). Differentiable for floats (K1): lane e gets
    g[segment_ids[e]], 0 for a pad or an id >= num_segments."""
    rows, seg = _segment_args("masked_segment_sum", SUM_TYPES, data,
                              segment_ids, num_segments)
    return _shaped(SegmentSum.apply(rows, seg, num_segments), data)


def masked_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """The mean of data [E, ...] (f32, bf16, f16, f64 or int32) over each
    segment's lanes, 0 for an empty segment -> [num_segments, ...] in
    data's dtype, f32 for int32 (JAX's true division). Differentiable for
    floats."""
    rows, seg = _segment_args("masked_segment_mean", SUM_TYPES, data,
                              segment_ids, num_segments)
    return _shaped(SegmentMean.apply(rows, seg, num_segments), data)


def masked_segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       initial: Optional[float] = None) -> torch.Tensor:
    """max(initial, the segment's lanes) of data [E, ...] (f32, bf16, f16
    or int32) -> [num_segments, ...] in data's dtype; ``initial`` defaults
    to the dtype's least finite value. Differentiable for f32, bf16 and
    f16."""
    rows, seg = _segment_args("masked_segment_max", SEG_TYPES, data,
                              segment_ids, num_segments)
    if initial is None:
        initial = torch.finfo(data.dtype).min if data.dtype in FLOATS \
            else torch.iinfo(data.dtype).min
    return _shaped(SegmentMax.apply(rows, seg, num_segments, initial), data)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of scores [E] or [E, H, ...] (f32, bf16 or f16) within each
    segment, shifted by max(the segment's max, 0) and with the
    denominator floored at f32's tiny, computed in f32 and rounded once;
    invalid lanes get 0. Differentiable."""
    rows, seg = _segment_args("segment_softmax", FLOATS, scores,
                              segment_ids, num_segments)
    return SegmentSoftmax.apply(rows, seg, num_segments).reshape(
        scores.shape)
