"""K16 ``dropout_act``: inverted dropout fused with the activation before it
and the cast between them, ``y = drop(cast(act(x)))``, with its keep bits
drawn from the port's counter-based hash inside the pass (port of
``legion_tpu/models/common.py::dropout``, which XLA fuses into its
neighbours on the TPU; kernel ``csrc/dropout.cu``).

The bits: lane e is the row-major element index; a layer's key is
``fold_in(words, layer)`` with ``words`` the step's dropout key (K10 writes
it on the card, ``sampling/access.py::step_keys(..., dropout=True)``), and
``hash_words`` of that key gives the words. JAX's three regimes keep their
keep rates and scales (``legion_tpu/models/common.py:76``, ``:87``,
``:98``):

  1. rate 0.5 on [N, d] with d % 32 == 0: bit e % 32 of word e / 32;
     kept entries divided by keep;
  2. 2**20 elements or more: byte e % 4 of word e / 4, kept below
     kq = clamp(round(keep * 256), 1, 255); kept entries times 256 / kq;
  3. otherwise: kept where (word(e) >> 8) * 2**-24 < keep in f32; kept
     entries divided by keep.

Rate 0 keeps every entry unscaled (the activation and the cast alone). The
constant is rounded to y's dtype first, as JAX's weakly typed scalar is
rounded to x's. The bits differ from JAX's threefry stream; the parity
tests inject these masks into the JAX package's ``dropout``.

``dropout_act`` is the entry the models call: on CPU tensors the plain
arithmetic, on CUDA tensors K16 (forward ``dropout_act``, backward
``dropout_act_bwd`` in ``kernels.LAUNCHES``) or a raise. What its autograd
Function saves for the backward: with ReLU only the "passes" mask that the
forward writes, one bit a lane (kept and not x <= 0; ``passes_mask_plain``),
so the backward reads dy and ceil(n / 8) bytes; with ELU x (its derivative
reads it) and the key words, the keep bits drawn again; with no activation
the key words.

GAT's attention dropout (``legion_tpu/models/gat.py:94``,
``legion_tpu/ops/hop_agg.py:120``) draws the same way inside K6 and K7
(``AttnDrop``): alpha [fanout, F, H] f32, lane e its row-major index
(f * F + i) * H + h, layer i's key ``fold_in(words, attn_fold(i))``; alpha
is never 2-D, so regime 2 or 3. ``attn_dropout_plain`` is their plain
arithmetic, JAX's: a kept entry divided by keep (times 256 / kq in regime
2) in f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from legion_tpu_torch.ops import kernels
from legion_tpu_torch.sampling.access import (ATTN_TAG, M32, fold_in_words,
                                              hash_words)

ACTS = {"none": 0, "relu": 1, "elu": 2}
# lanes are 32-bit counters
MAX_LANES = 2 ** 32 - 1


class DropSpec(NamedTuple):
    """What a K16 call computes, besides x and the key words."""
    act: str
    out_dtype: torch.dtype
    regime: int
    layer: int
    kq: int          # regime 2's byte threshold
    keep: float      # regime 3's threshold: keep in f32
    c: float         # the divisor (regimes 1, 3) or factor (2), y's dtype


def regime(shape: Tuple[int, ...], rate: float) -> int:
    """0 (rate 0: nothing dropped), or JAX's regime 1, 2 or 3."""
    if rate <= 0.0:
        return 0
    if rate == 0.5 and len(shape) == 2 and shape[-1] % 32 == 0:
        return 1
    if len(shape) >= 2 and math.prod(shape) >= (1 << 20):
        return 2
    return 3


def u8_threshold(rate: float) -> int:
    """kq: the u8 regime keeps a byte below it (keep quantised to 1/256)."""
    return min(max(round((1.0 - rate) * 256), 1), 255)


def _const(v: float, dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.full((), v, dtype=dtype, device=device)


def make_spec(shape, rate: float, act: str, out_dtype: torch.dtype,
              layer: int) -> DropSpec:
    r = regime(tuple(shape), rate)
    keep = 1.0 - rate
    kq = u8_threshold(rate)
    c = 256.0 / kq if r == 2 else keep
    return DropSpec(act, out_dtype, r, layer, kq,
                    float(_const(keep, torch.float32)),
                    float(_const(c, out_dtype)))


def keep_mask_plain(shape: Tuple[int, ...], rate: float,
                    words: torch.Tensor, layer: int
                    ) -> Optional[torch.Tensor]:
    """The keep mask (bool, ``shape``, on the words' device) that K16
    draws for layer ``layer`` from the step's dropout key ``words`` ([2]
    int32: lo, hi); None at rate 0. In int64 torch ops, no host sync."""
    r = regime(tuple(shape), rate)
    if r == 0:
        return None
    dev = words.device
    w = words.reshape(2).long() & M32
    ka, kb = fold_in_words(w[0], w[1], layer)
    n = math.prod(shape)
    if r == 1:
        bits = hash_words(ka, kb, torch.arange(n // 32, device=dev))
        bits = (bits[:, None] >> torch.arange(32, device=dev)) & 1
        return (bits != 0).reshape(shape)
    if r == 2:
        bits = hash_words(ka, kb, torch.arange(-(-n // 4), device=dev))
        byte = (bits[:, None] >> (8 * torch.arange(4, device=dev))) & 0xFF
        return (byte.reshape(-1)[:n] < u8_threshold(rate)).reshape(shape)
    u = (hash_words(ka, kb, torch.arange(n, device=dev)) >> 8).to(
        torch.float32) * 2.0 ** -24
    return (u < _const(1.0 - rate, torch.float32, dev)).reshape(shape)


def passes_mask_plain(x: torch.Tensor, rate: float, words: torch.Tensor,
                      layer: int) -> torch.Tensor:
    """ReLU's "passes" mask as K16's forward writes it: lane e kept (by
    ``keep_mask_plain``; every lane at rate 0) and not x <= 0 (a NaN
    passes), bit e % 8 of byte e // 8, ceil(n / 8) uint8 bytes on x's
    device, the last byte's bits past n zero."""
    passes = ~(x <= 0)
    keep = keep_mask_plain(tuple(x.shape), rate, words, layer)
    if keep is not None:
        passes = passes & keep
    n = passes.numel()
    bits = torch.zeros(-(-n // 8) * 8, dtype=torch.uint8, device=x.device)
    bits[:n] = passes.reshape(-1)
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    return (bits.view(-1, 8) << shifts).sum(1, dtype=torch.uint8)


def unpack_mask(mask: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """The bool tensor of ``shape`` that a packed mask holds."""
    shifts = torch.arange(8, dtype=torch.uint8, device=mask.device)
    bits = (mask[:, None] >> shifts) & 1
    return bits.reshape(-1)[:math.prod(shape)].bool().reshape(shape)


def attn_fold(layer: int) -> int:
    """What attention layer ``layer`` folds into the step's dropout key:
    the layer in the low 32 bits and ``ATTN_TAG`` in the high ones, so its
    masks differ from the layer's feature masks (fold ``layer``)."""
    return (ATTN_TAG << 32) | layer


class AttnDrop(NamedTuple):
    """Attention dropout of one GAT layer, as K6 and K7 take it: the
    step's dropout key words ([2] int32 on alpha's device), the layer and
    the rate. Its keep bits are ``keep_mask_plain(alpha.shape, rate,
    words, attn_fold(layer))``."""
    words: torch.Tensor
    layer: int
    rate: float


def attn_spec(shape, drop: Optional[AttnDrop]) -> DropSpec:
    """The K6 / K7 launch's dropout arguments for alpha of ``shape``
    (regime 0 with no ``drop``); raises ValueError on what the kernels do
    not take."""
    if drop is None:
        return make_spec(shape, 0.0, "none", torch.float32, 0)
    n = math.prod(shape)
    kernels._require(n <= MAX_LANES,
                     f"attention dropout: {n} alpha entries, more than the "
                     f"{MAX_LANES} a 32-bit lane counter takes")
    w = drop.words
    kernels._require(w.dtype == torch.int32 and w.numel() == 2
                     and w.is_contiguous(),
                     f"attention dropout: key words {w.dtype} "
                     f"{tuple(w.shape)}, want 2 contiguous int32")
    return make_spec(shape, drop.rate, "none", torch.float32,
                     attn_fold(drop.layer))


def attn_dropout_plain(alpha: torch.Tensor, drop: Optional[AttnDrop]
                       ) -> torch.Tensor:
    """Attention dropout of alpha (f32) in plain torch ops, differentiable:
    JAX's ``where(mask, alpha / keep, 0)`` (``alpha * (256 / kq)`` in
    regime 2) with the mask K6 and K7 draw; alpha itself with no
    ``drop``."""
    if drop is None:
        return alpha
    attn_spec(tuple(alpha.shape), drop)
    return dropout_act_plain(alpha, "none", None, drop.rate, drop.words,
                             attn_fold(drop.layer))


def _act_plain(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "elu":
        return F.elu(x)
    return x


def dropout_act_plain(x: torch.Tensor, act: str,
                      out_dtype: Optional[torch.dtype], rate: float,
                      words: torch.Tensor, layer: int) -> torch.Tensor:
    """The unfused chain, differentiable by autograd: the activation, the
    cast, then ``where(mask, h / keep, 0)`` (``h * (256 / kq)`` in the u8
    regime) with ``keep_mask_plain``'s mask, the constant in h's dtype and
    on h's device (a divisor on the host would turn the division into a
    multiplication by its reciprocal on the card). K16 gives its bits,
    forward and backward."""
    h = _act_plain(x, act)
    if out_dtype is not None:
        h = h.to(out_dtype)
    mask = keep_mask_plain(tuple(h.shape), rate, words, layer)
    if mask is None:
        return h
    s = make_spec(h.shape, rate, act, h.dtype, layer)
    kept = h * _const(s.c, h.dtype, h.device) if s.regime == 2 \
        else h / _const(1.0 - rate, h.dtype, h.device)
    return torch.where(mask, kept, _const(0.0, h.dtype, h.device))


def dropout_act_bwd_plain(dy: torch.Tensor, saved: Optional[torch.Tensor],
                          x_dtype: torch.dtype, words: Optional[torch.Tensor],
                          rate: float, s: DropSpec) -> torch.Tensor:
    """K16's backward in plain torch ops: the chain's backward as autograd
    takes it. ``saved`` is what the forward left: ReLU's passes mask
    (``passes_mask_plain``), where dx is dy through the divide's (or
    multiply's) backward and the cast's, else +0, with no keep bits drawn
    and no x read (ReLU's threshold on x is <= 0 exactly where its result
    is); ELU's x, and None with no activation, where the mask is drawn
    again from ``words``: where, the divide's backward, the cast's, then
    ELU's ``elu_backward`` on its input."""
    if s.act == "relu":
        g = dy
        if s.regime != 0:
            g = g * _const(s.c, g.dtype, g.device) if s.regime == 2 \
                else g / _const(1.0 - rate, g.dtype, g.device)
        g = g.to(x_dtype)
        return torch.where(unpack_mask(saved, tuple(dy.shape)), g,
                           _const(0.0, x_dtype, g.device))
    mask = keep_mask_plain(tuple(dy.shape), rate, words, s.layer)
    g = dy
    if mask is not None:
        g = torch.where(mask, g, _const(0.0, g.dtype, g.device))
        g = g * _const(s.c, g.dtype, g.device) if s.regime == 2 \
            else g / _const(1.0 - rate, g.dtype, g.device)
    g = g.to(x_dtype)
    if s.act == "elu":
        return torch.ops.aten.elu_backward(g, 1.0, 1.0, 1.0, False, saved)
    return g


def _is_bf16(t: torch.dtype) -> int:
    return int(t == torch.bfloat16)


def _launch_fwd(x: torch.Tensor, words: torch.Tensor, s: DropSpec,
                with_mask: bool
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=s.out_dtype, device=x.device)
    mask = torch.empty((-(-x.numel() // 8),), dtype=torch.uint8,
                       device=x.device) if with_mask else None
    rc = kernels.lib().lt_dropout_act_fwd(
        x.data_ptr(), _is_bf16(x.dtype), y.data_ptr(), _is_bf16(s.out_dtype),
        None if mask is None else mask.data_ptr(), x.numel(),
        words.data_ptr(), s.layer, ACTS[s.act], s.regime, s.kq, s.keep, s.c,
        kernels.stream_handle())
    kernels.check("dropout_act", rc)
    return y, mask


def _launch_bwd(dy: torch.Tensor, saved: Optional[torch.Tensor],
                x_dtype: torch.dtype, words: Optional[torch.Tensor],
                s: DropSpec) -> torch.Tensor:
    dy = dy.contiguous()
    relu = s.act == "relu"
    x = None if relu or saved is None else saved.contiguous()
    mask = saved if relu else None
    if relu and not (mask.dtype == torch.uint8 and mask.is_contiguous()
                     and mask.numel() == -(-dy.numel() // 8)):
        raise ValueError(
            f"dropout_act_bwd: mask {mask.dtype} {tuple(mask.shape)}, want "
            f"{-(-dy.numel() // 8)} contiguous uint8 bytes")
    dx = torch.empty(dy.shape, dtype=x_dtype, device=dy.device)
    rc = kernels.lib().lt_dropout_act_bwd(
        dy.data_ptr(), None if x is None else x.data_ptr(),
        None if mask is None else mask.data_ptr(), _is_bf16(x_dtype),
        dx.data_ptr(), _is_bf16(dy.dtype), dy.numel(),
        None if words is None else words.data_ptr(), s.layer, ACTS[s.act],
        s.regime, s.kq, s.keep, s.c, kernels.stream_handle())
    kernels.check("dropout_act_bwd", rc)
    return dx


def _on_cpu(*tensors) -> bool:
    """Whether to take the plain arithmetic: every tensor on the CPU. A
    CUDA tensor launches K16; any other mix raises."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return True
    kernels._require(len(devs) == 1 and next(iter(devs)).type == "cuda",
                     f"dropout_act: tensors on {sorted(map(str, devs))}")
    return False


def dropout_act_fwd(x: torch.Tensor, words: torch.Tensor, rate: float,
                    s: DropSpec, with_mask: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K16's forward (no autograd): y, and with ``with_mask`` (ReLU) the
    passes mask for the backward, else None; on the CPU the plain chain
    and ``passes_mask_plain``."""
    if _on_cpu(x, words):
        with torch.no_grad():
            y = dropout_act_plain(x, s.act, s.out_dtype, rate, words,
                                  s.layer)
            return y, (passes_mask_plain(x, rate, words, s.layer)
                       if with_mask else None)
    return _launch_fwd(x, words, s, with_mask)


def dropout_act_bwd(dy: torch.Tensor, saved: Optional[torch.Tensor],
                    x_dtype: torch.dtype, words: Optional[torch.Tensor],
                    rate: float, s: DropSpec) -> torch.Tensor:
    """K16's backward: d x from d y and what the forward saved (ReLU's
    passes mask, ELU's x, or None), the keep bits drawn again from
    ``words`` but with ReLU."""
    if _on_cpu(dy, saved, words):
        return dropout_act_bwd_plain(dy, saved, x_dtype, words, rate, s)
    return _launch_bwd(dy, saved, x_dtype, words, s)


class DropoutAct(torch.autograd.Function):
    """K16 forward and backward. Saves ReLU's passes mask alone, ELU's x
    and the key words, or (no activation) the key words."""

    @staticmethod
    def forward(ctx, x, words, rate, s):
        ctx.rate, ctx.spec, ctx.x_dtype = rate, s, x.dtype
        y, mask = dropout_act_fwd(x, words, rate, s,
                                  with_mask=s.act == "relu")
        if s.act == "relu":
            ctx.save_for_backward(mask)
        elif s.act == "elu":
            ctx.save_for_backward(x, words)
        else:
            ctx.save_for_backward(words)
        return y

    @staticmethod
    def backward(ctx, dy):
        s, saved = ctx.spec, ctx.saved_tensors
        if s.act == "relu":
            held, words = saved[0], None
        elif s.act == "elu":
            held, words = saved
        else:
            held, words = None, saved[0]
        return dropout_act_bwd(dy, held, ctx.x_dtype, words, ctx.rate,
                               s), None, None, None


def _check(x: torch.Tensor, act: str, out_dtype: torch.dtype,
           words: torch.Tensor) -> None:
    kernels._require(x.numel() <= MAX_LANES,
                     f"dropout_act: {x.numel()} lanes, more than the "
                     f"{MAX_LANES} a 32-bit lane counter takes")
    kernels._require(act in ACTS, f"dropout_act: act {act!r}")
    kernels._require(x.dtype in (torch.float32, torch.bfloat16)
                     and out_dtype in (x.dtype, torch.bfloat16),
                     f"dropout_act: x {x.dtype} -> {out_dtype}")
    kernels._require(words.dtype == torch.int32 and words.numel() == 2
                     and words.is_contiguous(),
                     f"dropout_act: key words {words.dtype} "
                     f"{tuple(words.shape)}, want 2 contiguous int32")


def dropout_act(x: torch.Tensor, act: str, out_dtype: Optional[torch.dtype],
                rate: float, words: Optional[torch.Tensor], layer: int,
                train: bool = True) -> torch.Tensor:
    """y = drop(cast(act(x))): ``act`` "none", "relu" or "elu" (alpha 1),
    the cast to ``out_dtype`` (None: x's dtype), then inverted dropout at
    ``rate`` with layer ``layer``'s keep bits of the step's dropout key
    ``words`` ([2] int32 on x's device). Out of training, or with no key,
    the activation and the cast alone (plain torch ops, as an eval pass
    runs them). In training one K16 launch forward and one backward on a
    card (none backward when x takes no gradient; with ReLU the forward
    then writes the 1-bit passes mask that the backward reads in place of
    x); the plain arithmetic on the CPU. More than 2**32 - 1 lanes raise
    ValueError."""
    if not train or words is None:
        h = _act_plain(x, act)
        return h if out_dtype is None else h.to(out_dtype)
    ydt = x.dtype if out_dtype is None else out_dtype
    _check(x, act, ydt, words)
    s = make_spec(x.shape, rate, act, ydt, layer)
    if s.regime == 0 and act == "none" and ydt == x.dtype:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return DropoutAct.apply(x, words, rate, s)
    return dropout_act_fwd(x, words, rate, s)[0]
