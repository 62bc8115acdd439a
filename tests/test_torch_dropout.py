"""K16 ``dropout_act`` on the CPU (``legion_tpu_torch/ops/dropout.py``):
the keyed keep bits against the host's hash chain, each regime's kept
share, distinct masks by layer, member and counter, the fused forward and
backward (the autograd Function with the mask drawn again) against the
unfused torch chain bit for bit, the lane limit, K10's dropout key row,
a layer's feature and attention masks apart, and GraphSAGE and GAT slices
with dropout on (GAT: feature dropout alone, and feature and attention
dropout) against the JAX package with the port's masks injected into its
``dropout``.

The kernel itself runs only on a card: ``chip_smoke.py`` holds it against
``dropout_act_plain`` there, forward and backward, exactly.

Tolerances of the slices (``tests/test_torch_parity.py``): F32_RTOL = 1e-5
and BF16_RTOL = 2e-2, the max abs error relative to the largest reference
value (products and sums in another order; bf16 rounding at other
places).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import legion_tpu.models.common as jcommon
import legion_tpu.models.gat as jgat
import legion_tpu.models.graphsage as jsage
from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.models.gat import GAT
from legion_tpu_torch.models.graphsage import GraphSAGE
from legion_tpu_torch.ops import dropout as kdrop
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.sampling.access import (M32, dropout_words, fold_in,
                                              hash32, step_keys_plain)
from legion_tpu_torch.utils.convert import params_from_jax
from test_torch_parity import (BF16_RTOL, F32_RTOL, batch_and_feats, close,
                               inject_masks, jdt, tdt)

WORDS = torch.tensor([0x1234567, -0x2345678], dtype=torch.int32)
# (shape, rate) of each regime: 1 bit-unpacked, 2 u8 bytes, 3 per lane
REGIMES = {1: ((512, 64), 0.5), 2: ((2048, 512), 0.6), 3: ((300, 70), 0.6)}


def _host_word(words: torch.Tensor, layer: int, lane: int) -> int:
    """lt_word of the layer's key, in Python ints: hash32(hash32(lane ^
    ka) ^ kb) with (ka, kb) = fold_in(words, layer)."""
    lo, hi = (int(w) & M32 for w in words)
    k = fold_in((hi << 32) | lo, layer)
    return hash32(hash32(lane ^ (k & M32)) ^ (k >> 32))


@pytest.mark.parametrize("reg", [1, 2, 3])
@pytest.mark.parametrize("layer", [0, 3])
def test_plain_keep_bits_equal_the_host_hash_chain(reg, layer):
    """keep_mask_plain's bits, lane by lane, from the host's hash32 /
    fold_in chain: bit e % 32 of word e / 32; byte e % 4 of word e / 4
    below kq; (word(e) >> 8) * 2**-24 < keep."""
    shape, rate = REGIMES[reg]
    assert kdrop.regime(shape, rate) == reg
    mask = kdrop.keep_mask_plain(shape, rate, WORDS, layer).reshape(-1)
    n = math.prod(shape)
    lanes = np.random.default_rng(reg + 7 * layer).integers(0, n, 300)
    keep = 1.0 - rate
    kq = min(max(round(keep * 256), 1), 255)
    for e in [0, 1, 31, 32, n - 1] + lanes.tolist():
        if reg == 1:
            want = (_host_word(WORDS, layer, e // 32) >> (e % 32)) & 1 == 1
        elif reg == 2:
            want = ((_host_word(WORDS, layer, e // 4) >> (8 * (e % 4)))
                    & 0xFF) < kq
        else:
            want = np.float32(_host_word(WORDS, layer, e) >> 8) \
                * np.float32(2.0 ** -24) < np.float32(keep)
        assert bool(mask[e]) == bool(want), (reg, layer, e)


@pytest.mark.parametrize("shape,rate", [((512, 256), 0.5),
                                        ((2048, 512), 0.6),
                                        ((2048, 512), 0.1),
                                        ((1 << 20,), 0.3),
                                        ((300, 70), 0.6),
                                        ((300, 70), 0.1),
                                        ((100, 100), 0.5)])
def test_kept_share_is_within_5_sigma_of_the_binomial(shape, rate):
    """Each regime keeps a share within 5 sigma of the binomial at its keep
    rate (the quantised kq / 256 in the u8 regime)."""
    mask = kdrop.keep_mask_plain(shape, rate, WORDS, 2)
    n = mask.numel()
    p = 1.0 - rate
    if kdrop.regime(shape, rate) == 2:
        p = min(max(round(p * 256), 1), 255) / 256
    kept = int(mask.sum())
    assert abs(kept - n * p) <= 5 * math.sqrt(n * p * (1 - p)), (kept, n, p)


@pytest.mark.parametrize("reg", [1, 2, 3])
def test_layers_members_and_counters_draw_different_masks(reg):
    """Masks of two layers, two members and two consecutive counters all
    differ; each pair agrees on about p^2 + (1-p)^2 of the lanes, as
    independent masks do."""
    shape, rate = REGIMES[reg]
    base = torch.tensor(99, dtype=torch.int64)
    masks = {}
    for c in (41, 42):
        _, drop = step_keys_plain(base, torch.tensor(c), 0, 2, 2,
                                  dropout=True)
        for d in range(2):
            for layer in range(2):
                masks[c, d, layer] = kdrop.keep_mask_plain(
                    shape, rate, drop[d], layer)
    p = float(next(iter(masks.values())).float().mean())
    agree = p * p + (1 - p) * (1 - p)
    keys = list(masks)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            same = float((masks[a] == masks[b]).float().mean())
            assert not torch.equal(masks[a], masks[b]), (a, b)
            assert abs(same - agree) < 0.02, (a, b, same, agree)


@pytest.mark.parametrize("shape", [(25, 4000, 1), (10, 20000, 8)])
def test_a_layers_feature_and_attention_masks_differ(shape):
    """A layer's attention mask (fold ``attn_fold(i)``) is not its feature
    mask (fold i) over the same lanes: the two agree on a share within 5
    sigma of keep^2 + (1 - keep)^2, as independent masks do (regime 3 at
    GAT layer 1's alpha, and regime 2; keep quantised to kq / 256 there)."""
    rate = 0.6
    for layer in (0, 1):
        feat = kdrop.keep_mask_plain(shape, rate, WORDS, layer)
        attn = kdrop.keep_mask_plain(shape, rate, WORDS,
                                     kdrop.attn_fold(layer))
        assert kdrop.attn_fold(layer) != layer
        assert not torch.equal(feat, attn)
        n = math.prod(shape)
        k = 1.0 - rate
        if kdrop.regime(shape, rate) == 2:
            k = kdrop.u8_threshold(rate) / 256
        agree = k * k + (1 - k) * (1 - k)
        same = float((feat == attn).double().mean())
        assert abs(same - agree) <= 5 * math.sqrt(agree * (1 - agree) / n), \
            (layer, same, agree)


def _chain(x, act, out_dtype, rate, words, layer):
    """The unfused torch chain under autograd: relu / elu, the cast, then
    where(mask, h / keep, 0) (h * 256 / kq in the u8 regime), the constant
    in h's dtype, the mask from keep_mask_plain."""
    h = {"relu": torch.relu, "elu": F.elu, "none": lambda t: t}[act](x)
    if out_dtype is not None:
        h = h.to(out_dtype)
    r = kdrop.regime(tuple(h.shape), rate)
    if r == 0:
        return h
    mask = kdrop.keep_mask_plain(tuple(h.shape), rate, words, layer)
    keep = 1.0 - rate
    if r == 2:
        kq = min(max(round(keep * 256), 1), 255)
        kept = h * torch.full((), 256.0 / kq, dtype=h.dtype)
    else:
        kept = h / torch.full((), keep, dtype=h.dtype)
    return torch.where(mask, kept, torch.zeros((), dtype=h.dtype))


def _bits(t):
    return t.detach().view(torch.int16 if t.dtype == torch.bfloat16
                           else torch.int32)


@pytest.mark.parametrize("dtypes", [("float32", None), ("float32", "bfloat16"),
                                    ("bfloat16", None)])
@pytest.mark.parametrize("act", ["relu", "elu", "none"])
@pytest.mark.parametrize("width,rows,rate", [(256, 64, 0.5), (100, 64, 0.5),
                                             (256, 4096, 0.6),
                                             (100, 10486, 0.6),
                                             (100, 33, 0.0)])
def test_fused_equals_the_unfused_chain_bit_for_bit(dtypes, act, width, rows,
                                                    rate):
    """``dropout_act`` (the autograd Function: the forward draws the mask;
    ReLU's backward reads the 1-bit passes mask the forward wrote and
    nothing else it saved, ELU's draws the mask again from the saved key
    words and reads the saved x, no activation's saves the key words
    alone) against the unfused chain: y and dx bit for bit, f32 and bf16,
    widths 100 and 256, every regime (rows 4096 x 256 and 10486 x 100 are
    past 2**20 lanes: u8) and rate 0, with dy made from a numpy seed."""
    xdt, ydt = (tdt(d) if d else None for d in dtypes)
    rng = np.random.default_rng(rows + width)
    x0 = torch.from_numpy(rng.standard_normal((rows, width)).astype(
        np.float32)).to(xdt)
    x0[0, :5] = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 3.0])
    dy = torch.from_numpy(rng.standard_normal((rows, width)).astype(
        np.float32)).to(ydt or xdt)
    xa = x0.clone().requires_grad_()
    xb = x0.clone().requires_grad_()
    ya = kdrop.dropout_act(xa, act, ydt, rate, WORDS, 1)
    yb = _chain(xb, act, ydt, rate, WORDS, 1)
    assert ya.dtype == yb.dtype == (ydt or xdt)
    assert torch.equal(_bits(ya), _bits(yb))
    if act == "none" and ydt is None and rate == 0.0:
        assert ya is xa
        return
    saved = ya.grad_fn.saved_tensors
    if act == "relu":
        # the passes mask alone: ceil(n / 8) bytes, no x, no key words
        assert len(saved) == 1 and saved[0].dtype == torch.uint8
        assert tuple(saved[0].shape) == (-(-x0.numel() // 8),)
    elif act == "elu":
        assert len(saved) == 2
        assert torch.equal(_bits(saved[0]), _bits(x0))
        assert torch.equal(saved[1], WORDS)
    else:
        assert len(saved) == 1 and torch.equal(saved[0], WORDS)
    ya.backward(dy)
    yb.backward(dy)
    assert torch.equal(_bits(xa.grad), _bits(xb.grad))


# (shape, rate) of ReLU's mask cases: each regime, rate 0, and lane counts
# that are not a multiple of 8 (1221, 7, 1,050,049)
MASK_CASES = [((512, 64), 0.5), ((33, 96), 0.5), ((2048, 512), 0.6),
              ((1049, 1001), 0.6), ((300, 70), 0.6), ((37, 33), 0.6),
              ((7, 1), 0.3), ((37, 33), 0.0), ((64, 256), 0.0)]
# lanes 0-6 of x: each side of ReLU's threshold, and a NaN (passes)
SPECIALS = [0.0, -0.0, 1e-30, -1e-30, float("nan"), 1.0, -1.0]


def _mask_x(shape, dtype, nan=True):
    rng = np.random.default_rng(math.prod(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x.view(-1)[:len(SPECIALS)] = torch.tensor(SPECIALS)[:x.numel()]
    if not nan:
        x = torch.nan_to_num(x, nan=2.0)
    return x.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rate", MASK_CASES)
def test_passes_mask_packs_keep_and_not_x_le_0(shape, rate, dtype):
    """``passes_mask_plain`` (what K16's ReLU forward writes) is the keep
    mask and not x <= 0, packed bit e % 8 of byte e // 8 in ceil(n / 8)
    bytes, the bits past n zero: in every regime, at rate 0 (not x <= 0
    alone), at lane counts that are not a multiple of 8, with x holding
    +-0, +-1e-30 and a NaN (which passes, as ``threshold_backward``
    lets it); the CPU forward returns it only when asked."""
    x = _mask_x(shape, tdt(dtype))
    layer = 2
    mask = kdrop.passes_mask_plain(x, rate, WORDS, layer)
    n = x.numel()
    assert mask.dtype == torch.uint8 and tuple(mask.shape) == (-(-n // 8),)
    keep = kdrop.keep_mask_plain(shape, rate, WORDS, layer)
    want = ~(x <= 0) if keep is None else keep & ~(x <= 0)
    packed = np.packbits(want.reshape(-1).numpy(), bitorder="little")
    assert np.array_equal(mask.numpy(), packed)
    assert torch.equal(kdrop.unpack_mask(mask, shape), want)
    # the NaN lane passes where it is kept
    assert bool(want.view(-1)[4]) == (keep is None or bool(keep.view(-1)[4]))
    s = kdrop.make_spec(shape, rate, "relu", x.dtype, layer)
    y, m = kdrop.dropout_act_fwd(x, WORDS, rate, s, with_mask=True)
    assert torch.equal(m, mask)
    assert kdrop.dropout_act_fwd(x, WORDS, rate, s)[1] is None


@pytest.mark.parametrize("dtypes", [("float32", None), ("float32", "bfloat16"),
                                    ("bfloat16", None)])
@pytest.mark.parametrize("shape,rate", MASK_CASES)
def test_relu_backward_from_the_mask_equals_the_chain_bit_for_bit(
        shape, rate, dtypes):
    """ReLU's backward from the passes mask alone (``dropout_act_bwd``
    given the mask, no x and no key words) equals the unfused chain's
    autograd bit for bit (the sign of a zero too), as does the autograd
    Function's: every regime, rate 0, lane counts not a multiple of 8, x
    holding +-0, +-1e-30 and a NaN, f32 -> f32, f32 -> bf16 and bf16 ->
    bf16."""
    xdt, ydt = (tdt(d) if d else None for d in dtypes)
    x0 = _mask_x(shape, xdt)
    rng = np.random.default_rng(7 + math.prod(shape))
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                          ).to(ydt or xdt)
    layer = 3
    xb = x0.clone().requires_grad_()
    yb = _chain(xb, "relu", ydt, rate, WORDS, layer)
    yb.backward(dy)
    s = kdrop.make_spec(shape, rate, "relu", ydt or xdt, layer)
    mask = kdrop.passes_mask_plain(x0, rate, WORDS, layer)
    dx = kdrop.dropout_act_bwd(dy, mask, xdt, None, rate, s)
    assert dx.dtype == xdt
    assert torch.equal(_bits(dx), _bits(xb.grad))
    xa = x0.clone().requires_grad_()
    ya = kdrop.dropout_act(xa, "relu", ydt, rate, WORDS, layer)
    assert torch.equal(_bits(ya), _bits(yb))
    ya.backward(dy)
    assert torch.equal(_bits(xa.grad), _bits(xb.grad))


@pytest.mark.parametrize("dtypes", [("float32", None), ("float32", "bfloat16"),
                                    ("bfloat16", None)])
@pytest.mark.parametrize("shape,rate", [((64, 256), 0.5), ((2048, 512), 0.6),
                                        ((37, 33), 0.6)])
def test_relu_backward_from_the_mask_matches_jax_grad(shape, rate, dtypes,
                                                      monkeypatch):
    """The port's ReLU backward from the passes mask equals ``jax.grad``
    of JAX's ``relu``, the cast and ``legion_tpu/models/common.py::
    dropout`` (the port's keep mask injected, scaled by JAX) bit for bit,
    in each regime (bit-unpacked, u8, per lane, 1221 lanes) and dtype
    pair. x holds +-0 and +-1e-30, no NaN: JAX's ReLU gradient stops a
    NaN, PyTorch's ``threshold_backward`` lets it pass."""
    xdt, ydt = dtypes
    layer = 1
    x = _mask_x(shape, tdt(xdt), nan=False)
    rng = np.random.default_rng(9 + math.prod(shape))
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                          ).to(tdt(ydt or xdt))
    applied = inject_masks(monkeypatch, (jcommon,), [layer], WORDS)
    dyj = jnp.asarray(dy.float().numpy(), jdt(ydt or xdt))

    def f(xj):
        h = jax.nn.relu(xj)
        if ydt is not None:
            h = h.astype(jdt(ydt))
        return jnp.sum(jcommon.dropout(h, rate, jax.random.PRNGKey(0),
                                       True) * dyj)

    gj = jax.grad(f)(jnp.asarray(x.float().numpy(), jdt(xdt)))
    assert [fold for _, fold in applied] == [layer]
    s = kdrop.make_spec(shape, rate, "relu", tdt(ydt or xdt), layer)
    mask = kdrop.passes_mask_plain(x, rate, WORDS, layer)
    dx = kdrop.dropout_act_bwd(dy, mask, x.dtype, None, rate, s)
    want = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(x.dtype)
    assert torch.equal(_bits(dx), _bits(want))


def test_no_gradient_saves_nothing_and_cpu_launches_nothing():
    """Where x takes no gradient the output has no backward (GAT's layer 0
    input: the fetched features); on the CPU no kernel launches."""
    kernels.reset_launch_counts()
    x = torch.randn(64, 256)
    y = kdrop.dropout_act(x, "relu", torch.bfloat16, 0.5, WORDS, 0)
    assert y.grad_fn is None and y.dtype == torch.bfloat16
    with torch.no_grad():
        z = kdrop.dropout_act(x.requires_grad_(), "elu", None, 0.5, WORDS, 0)
    assert z.grad_fn is None
    assert kernels.LAUNCHES["dropout_act"] == 0
    assert kernels.LAUNCHES["dropout_act_bwd"] == 0


def test_refusals():
    """More than 2**32 - 1 lanes raise ValueError (lanes are 32-bit
    counters), as do a bad activation, dtype, key and device mix; a tensor
    that is not on the CPU or a card raises rather than fall back."""
    big = torch.zeros(1).expand(1 << 16, 1 << 16)
    with pytest.raises(ValueError, match="lanes"):
        kdrop.dropout_act(big, "relu", None, 0.5, WORDS, 0)
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="act"):
        kdrop.dropout_act(x, "gelu", None, 0.5, WORDS, 0)
    with pytest.raises(ValueError, match="float32"):
        kdrop.dropout_act(x, "relu", torch.float16, 0.5, WORDS, 0)
    with pytest.raises(ValueError, match="key words"):
        kdrop.dropout_act(x, "relu", None, 0.5, WORDS.long(), 0)
    with pytest.raises(ValueError, match="tensors on"):
        kdrop.dropout_act(torch.zeros(4, 32, device="meta"), "relu", None,
                          0.5, WORDS, 0)


def test_attention_dropout_refusals():
    """Attention dropout (``AttnDrop``, K6 and K7) refuses what its kernels
    do not take, on the CPU as on a card: alpha of 2**32 entries or more
    (lanes are 32-bit counters), and key words that are not 2 contiguous
    int32; K6's and K7's wrappers refuse words on another device than
    their tensors rather than fall back."""
    from legion_tpu_torch.ops import hop_agg
    with pytest.raises(ValueError, match="alpha entries"):
        kdrop.attn_spec((1 << 16, 1 << 16, 1), kdrop.AttnDrop(WORDS, 0, 0.6))
    z, sc = torch.zeros((8, 1, 4)), torch.zeros((2, 3, 1))
    src, off = torch.zeros(6, dtype=torch.int32), torch.tensor(0)
    for words in (WORDS.long(), torch.zeros(3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="key words"):
            hop_agg.hop_softmax_attention(z, sc, src, 2, off, 4,
                                          kdrop.AttnDrop(words, 1, 0.6))
    meta = kdrop.AttnDrop(WORDS.to("meta"), 0, 0.6)
    with pytest.raises(ValueError, match="gat_attend: x on"):
        kernels.gat_attend(torch.zeros((8, 4)), torch.zeros((4, 1)),
                           torch.zeros((4, 1)), src,
                           torch.tensor(0, dtype=torch.int32), 2, 0, 0.2,
                           meta)


@pytest.mark.parametrize("n_dev,first,n", [(1, 0, None), (4, 0, None),
                                           (8, 5, 1), (8, 2, 4)])
@pytest.mark.parametrize("tag", [0, 1])
def test_step_keys_plain_dropout_row(n_dev, first, n, tag):
    """K10's plain version with ``dropout``: the hop words as without it,
    and member d's dropout key words equal to fold_in(fold_in(step, d), 7)
    (fold_in(step, 7) with one member), step = fold_in(fold_in(base, ctr),
    tag); the counter advances once."""
    rng = np.random.default_rng(n_dev * 10 + first + tag)
    for _ in range(5):
        base = int(rng.integers(0, 2 ** 63))
        ctr = int(rng.integers(0, 2 ** 31))
        b = torch.tensor(base, dtype=torch.int64)
        c1, c2 = torch.tensor(ctr), torch.tensor(ctr)
        plain = step_keys_plain(b, c1, tag, 2, n_dev, first, n)
        words, drop = step_keys_plain(b, c2, tag, 2, n_dev, first, n,
                                      dropout=True)
        assert torch.equal(words, plain) and int(c2) == ctr + 1
        step = fold_in(fold_in(base, ctr), tag)
        if n_dev == 1:
            assert torch.equal(drop, dropout_words(step, "cpu"))
            continue
        m = n_dev - first if n is None else n
        assert tuple(drop.shape) == (m, 2)
        for j in range(m):
            assert torch.equal(drop[j], dropout_words(
                fold_in(step, first + j), "cpu"))


def _injected(monkeypatch, module, shapes_rate, words):
    """Replace the JAX package's ``dropout`` in ``module`` by the port's
    keyed masks: its i-th call with a positive rate takes layer ``layers[i]``'s
    mask of keep_mask_plain, scaled as JAX scales (x / keep; x * 256 / kq
    in the u8 regime). Returns the list of (shape, layer) it applied."""
    applied = []
    layers, rate_on = shapes_rate

    def fixed(x, rate, key, train):
        if not train or rate <= 0.0 or key is None:
            return x
        assert rate == rate_on
        layer = layers[len(applied)]
        applied.append((tuple(x.shape), layer))
        mask = jnp.asarray(kdrop.keep_mask_plain(tuple(x.shape), rate,
                                                 words, layer).numpy())
        keep = 1.0 - rate
        if kdrop.regime(tuple(x.shape), rate) == 2:
            kq = min(max(round(keep * 256), 1), 255)
            return jnp.where(mask, x * (256.0 / kq), 0).astype(x.dtype)
        return jnp.where(mask, x / keep, 0).astype(x.dtype)

    monkeypatch.setattr(module, "dropout", fixed)
    return applied


SLICE_KW = dict(fanouts=(6, 4), batch_size=32, dedup="sort",
                neighbor_window=16, dedup_last_hop=False,
                node_caps=(32, 160, 0))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_graphsage_slice_with_dropout_matches_jax(compute_dtype,
                                                  monkeypatch):
    """A 2-layer GraphSAGE (hidden 64: rate 0.5 on a 32-multiple width,
    the bit-unpacked regime) in training mode with dropout 0.5: the port
    (ReLU, cast, dropout in one ``dropout_act``) against the JAX package
    with the port's layer-0 mask injected; logits and every parameter
    gradient, F32_RTOL in f32 and BF16_RTOL in bf16."""
    scfg, jcfg = SamplerConfig(**SLICE_KW), JSamplerConfig(**SLICE_KW)
    rng = np.random.default_rng(21)
    pb, jb, x = batch_and_feats(rng, scfg)
    classes = 10
    jm = jsage.GraphSAGE(jcfg, 100, 64, classes, dropout=0.5,
                         compute_dtype=compute_dtype, in_dim_pad=128)
    params = jm.init(jax.random.PRNGKey(0))
    pm = GraphSAGE(100, 64, classes, num_layers=2, device="cpu",
                   dropout=0.5, compute_dtype=compute_dtype, in_dim_pad=128)
    pm.load_state_dict(params_from_jax(params))
    w = rng.standard_normal((32, classes)).astype(np.float32)
    applied = _injected(monkeypatch, jsage, ([0], 0.5), WORDS)

    def jfn(p):
        logits = jm.apply(p, jnp.asarray(x, jdt(compute_dtype)), jb,
                          train=True, rng=jax.random.PRNGKey(3))
        return jnp.sum(logits * w), logits

    (_, lj), gj = jax.jit(jax.value_and_grad(jfn, has_aux=True))(params)
    assert [layer for _, layer in applied] == [0]
    assert kdrop.regime(applied[0][0], 0.5) == 1
    pm.train()
    lp = pm(torch.from_numpy(x).to(tdt(compute_dtype)), pb, scfg, WORDS)
    (lp * torch.from_numpy(w)).sum().backward()
    tol = F32_RTOL if compute_dtype == "float32" else BF16_RTOL
    close(lp, lj, tol, "logits")
    for i, layer in enumerate(gj["layers"]):
        for k in ("w_self", "w_neigh", "b"):
            close(pm.layers[i][k].grad, layer[k], tol, f"layer {i} {k}")
    # the masks are the key's: another key, other logits
    with torch.no_grad():
        other = pm(torch.from_numpy(x).to(tdt(compute_dtype)), pb, scfg,
                   dropout_words(5, "cpu"))
    assert not torch.equal(other, lp.detach())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gat_slice_with_feature_dropout_matches_jax(compute_dtype,
                                                    monkeypatch):
    """GAT (heads (4, 1), hidden 16, aligned last hop) in training mode
    with feature dropout 0.6 (the per-lane regime) and no attention
    dropout: layer 0's dropout of the features, and layer 1's ELU, cast
    and dropout in one ``dropout_act``, against the JAX package with the
    port's masks injected; logits and every parameter gradient, F32_RTOL
    in f32 and BF16_RTOL in bf16."""
    scfg, jcfg = SamplerConfig(**SLICE_KW), JSamplerConfig(**SLICE_KW)
    rng = np.random.default_rng(22)
    pb, jb, x = batch_and_feats(rng, scfg)
    classes = 10
    jm = jgat.GAT(jcfg, 100, 16, classes, heads=(4, 1), feat_drop=0.6,
                  attn_drop=0.0, in_dim_pad=128,
                  compute_dtype=compute_dtype)
    params = jm.init(jax.random.PRNGKey(0))
    pm = GAT(100, 16, classes, num_layers=2, device="cpu", heads=(4, 1),
             feat_drop=0.6, attn_drop=0.0, in_dim_pad=128,
             compute_dtype=compute_dtype)
    pm.load_state_dict(params_from_jax(params))
    w = rng.standard_normal((32, classes)).astype(np.float32)
    applied = _injected(monkeypatch, jgat, ([0, 1], 0.6), WORDS)

    def jfn(p):
        logits = jm.apply(p, jnp.asarray(x, jdt(compute_dtype)), jb,
                          train=True, rng=jax.random.PRNGKey(3))
        return jnp.sum(logits * w), logits

    # eager, not jit: XLA's fusion drops some of the bf16 roundings of the
    # op-by-op program, which the port keeps
    (_, lj), gj = jax.value_and_grad(jfn, has_aux=True)(params)
    assert [layer for _, layer in applied] == [0, 1]
    pm.train()
    lp = pm(torch.from_numpy(x).to(tdt(compute_dtype)), pb, scfg, WORDS)
    (lp * torch.from_numpy(w)).sum().backward()
    tol = F32_RTOL if compute_dtype == "float32" else BF16_RTOL
    close(lp, lj, tol, "logits")
    for i, layer in enumerate(gj["layers"]):
        for k in layer:
            close(pm.layers[i][k].grad, layer[k], tol, f"layer {i} {k}")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gat_slice_with_feature_and_attention_dropout_matches_jax(
        compute_dtype, monkeypatch):
    """GAT (heads (4, 1), hidden 16) in training mode with feature and
    attention dropout both at 0.6: layer 0 on the aligned last hop (K6's
    plain version), layer 1 on a gathered hop (K7's), every mask drawn
    from the step's dropout key (features at fold i, attention at
    ``attn_fold(i)``), against the JAX package with each of those masks
    injected into its ``dropout`` in call order (features 0, attention 0,
    features 1, attention 1) and scaled by JAX; the loss and every
    parameter gradient, F32_RTOL in f32 and BF16_RTOL in bf16."""
    scfg, jcfg = SamplerConfig(**SLICE_KW), JSamplerConfig(**SLICE_KW)
    rng = np.random.default_rng(23)
    pb, jb, x = batch_and_feats(rng, scfg)
    classes = 10
    jm = jgat.GAT(jcfg, 100, 16, classes, heads=(4, 1), feat_drop=0.6,
                  attn_drop=0.6, in_dim_pad=128,
                  compute_dtype=compute_dtype)
    params = jm.init(jax.random.PRNGKey(0))
    pm = GAT(100, 16, classes, num_layers=2, device="cpu", heads=(4, 1),
             feat_drop=0.6, attn_drop=0.6, in_dim_pad=128,
             compute_dtype=compute_dtype)
    pm.load_state_dict(params_from_jax(params))
    w = rng.standard_normal((32, classes)).astype(np.float32)
    folds = [0, kdrop.attn_fold(0), 1, kdrop.attn_fold(1)]
    applied = inject_masks(monkeypatch, (jgat, jcommon), folds, WORDS)

    def jfn(p):
        logits = jm.apply(p, jnp.asarray(x, jdt(compute_dtype)), jb,
                          train=True, rng=jax.random.PRNGKey(3))
        return jnp.sum(logits * w), logits

    # eager, not jit: XLA's fusion drops some of the bf16 roundings of the
    # op-by-op program, which the port keeps
    (loss_j, lj), gj = jax.value_and_grad(jfn, has_aux=True)(params)
    assert [fold for _, fold in applied] == folds
    assert [len(shape) for shape, _ in applied] == [2, 3, 2, 3]
    pm.train()
    lp = pm(torch.from_numpy(x).to(tdt(compute_dtype)), pb, scfg, WORDS)
    loss_p = (lp * torch.from_numpy(w)).sum()
    loss_p.backward()
    tol = F32_RTOL if compute_dtype == "float32" else BF16_RTOL
    close(lp, lj, tol, "logits")
    assert abs(float(loss_p.detach()) - float(loss_j)) <= tol * float(
        np.abs(np.asarray(lj, np.float32) * w).sum())
    for i, layer in enumerate(gj["layers"]):
        for k in layer:
            close(pm.layers[i][k].grad, layer[k], tol, f"layer {i} {k}")
    # the attention masks are the key's: without them, other logits
    pm.attn_drop = 0.0
    with torch.no_grad():
        other = pm(torch.from_numpy(x).to(tdt(compute_dtype)), pb, scfg,
                   WORDS)
    assert not torch.equal(other, lp.detach())
