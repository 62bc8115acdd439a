"""Parity of the port's segment ops (``legion_tpu_torch/ops/segment.py``:
the mean, the max with K17's arithmetic and the softmax with K18's) with
``legion_tpu.ops.segment`` on the CPU, forward and ``jax.grad``; and the
two small copies, ``CSRGraph.neighbors`` and ``torch_linear_init``.

Inputs are made with numpy from a seed and handed to both packages. The
kernels' plain versions run here (CPU tensors); ``chip_smoke.py`` holds
K17 and K18 against them on the card.

Tolerances: the max is exact in f32 (forward bit for bit, a zero's sign
included; gradient equal), its bf16 gradient within one bf16 ulp; the
softmax and the mean sum in another order, rtol 1e-5 of the largest value
in f32 (the mean's gradient exact), and K2's 2e-2 in bf16 (JAX rounds a
bf16 softmax after each op, the port once).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import legion_tpu.ops as jops
from legion_tpu.graph import CSRGraph as JGraph
from legion_tpu.ops import segment as J
from legion_tpu_torch import ops as pops
from legion_tpu_torch.graph import CSRGraph
from legion_tpu_torch.models.common import torch_linear_init
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops import segment as P

F32_RTOL = 1e-5
BF16_RTOL = 2e-2
FMIN = np.finfo(np.float32).min
NAN, INF = np.nan, np.inf


def _jdt(dtype):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "float16": jnp.float16, "float64": jnp.float64,
            "int32": jnp.int32}[dtype]


def _tdt(dtype):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "float64": torch.float64,
            "int32": torch.int32}[dtype]


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounded once, by JAX, and handed over as f32)."""
    j = jnp.asarray(x).astype(_jdt(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32)
                                  if dtype == "bfloat16" else j))
    return j, t.to(_tdt(dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _same(got, ref, what=""):
    """Equal values, NaN where NaN, and a zero's sign."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.signbit(got), np.signbit(ref),
                                      err_msg=what)


def _close(got, ref, rtol, what="", scale=None):
    """NaN where NaN; elsewhere within rtol of ``scale`` (by default the
    largest reference value)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), what)
    ok = ~np.isnan(ref)
    if scale is None:
        scale = np.abs(ref[ok]).max(initial=0.0)
    err = np.abs(got[ok] - ref[ok]).max(initial=0.0)
    assert err <= rtol * max(scale, 1e-30), (what, err)


def _ulp_bf16(v):
    v = np.maximum(np.abs(v), 1e-30)
    return np.exp2(np.floor(np.log2(v)) - 7)


def _jax_vjp(fn, x, w, jit=False):
    """JAX's fn(x) and its gradient at cotangent w (0 where fn(x) is NaN).
    Eager by default (op by op: bf16 rounded after each op, and one
    compile an op and shape, shared by the cases of one shape); ``jit``
    compiles the whole, once a shape."""
    def both(x, w):
        out, vjp = jax.vjp(fn, x)
        return out, vjp(jnp.where(jnp.isnan(out), 0, w).astype(out.dtype))[0]
    return (jax.jit(both) if jit else both)(x, w)


def _port_vjp(fn, x, w):
    """The port's fn(x) and its gradient at cotangent w (0 where NaN)."""
    x = x.detach().requires_grad_()
    out = fn(x)
    w = torch.where(out.isnan(), 0, w.to(out.dtype))
    out.backward(w)
    return out.detach(), x.grad


# (data, ids, initial): each behaviour of JAX's masked_segment_max, at
# E 8 (pads appended) and S 4
MAX_S = 4
MAX_CASES = {
    # a NaN lane makes its segment NaN, and gets no gradient
    "nan": ([1.0, NAN, 2.0, 5.0], [0, 0, 0, 1], None),
    # -0 and +0 in either order give +0; the gradient splits between them
    "signed_zero": ([-0.0, 0.0, 0.0, -0.0, -0.0], [0, 0, 1, 1, 2], None),
    # [3, 3] in one segment get half each
    "ties": ([3.0, 3.0, 1.0, 2.0, 2.0, 2.0], [0, 0, 0, 1, 1, 1], None),
    # initial counts as one more tie where it equals the result
    "initial_tied": ([2.0, 2.0, 2.0, 1.0], [0, 1, 1, 2], 2.0),
    # a lane at finfo.min alone ties with the default initial
    "finfo_min_alone": ([FMIN, -1.0], [0, 1], None),
    # empty segments give initial, the default or a given one
    "empty": ([4.0, -3.0], [1, 1], None),
    "empty_initial": ([4.0, -3.0], [1, 1], -1.5),
    # negative ids and ids >= S are dropped
    "dropped": ([9.0, 1.0, 8.0, 7.0, 2.0], [-1, 0, 4, 7, -5], None),
    # +-inf
    "inf": ([-INF, -INF, INF, 1.0, -INF], [0, 0, 1, 1, 2], None),
}


def _padded(x, ids, E=8):
    x = np.concatenate([np.asarray(x, np.float32),
                        np.zeros(E - len(x), np.float32)])
    return x, np.concatenate([np.asarray(ids, np.int32),
                              np.full(E - len(ids), -1, np.int32)])


@pytest.mark.parametrize("case", sorted(MAX_CASES))
def test_masked_segment_max_matches_jax(case):
    """Forward bit for bit (NaN, the sign of a zero) and ``jax.grad``
    equal, f32 [E], for each behaviour of JAX's scatter-max and its JVP."""
    x, ids, initial = MAX_CASES[case]
    x, ids = _padded(x, ids)
    w = np.random.default_rng(len(case)).standard_normal(MAX_S) \
        .astype(np.float32)
    jout, jgrad = _jax_vjp(lambda d: J.masked_segment_max(
        d, jnp.asarray(ids), MAX_S, initial), jnp.asarray(x), w)
    out, grad = _port_vjp(lambda d: pops.masked_segment_max(
        d, torch.from_numpy(ids), MAX_S, initial), torch.from_numpy(x),
        torch.from_numpy(w))
    _same(out, jout, "forward")
    np.testing.assert_array_equal(grad.numpy(), np.asarray(jgrad))


@pytest.mark.parametrize("shape", [(61,), (61, 5), (61, 3, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_segment_max_shapes_and_bf16(shape, dtype):
    """[E], [E, F] and [E, H, F] of small integers (many ties), pads and
    ids past S: the forward equals JAX's bit for bit; the gradient equals
    it in f32 and is within one bf16 ulp in bf16 (JAX rounds n, 1/n and
    the product to bf16, as the port's kernel does)."""
    rng = np.random.default_rng(sum(shape))
    S = 9
    x = rng.integers(-3, 4, shape).astype(np.float32)
    ids = rng.integers(-2, S + 2, shape[0]).astype(np.int32)
    w = rng.standard_normal((S,) + shape[1:]).astype(np.float32)
    xj, xt = _both(x, dtype)
    wj, wt = _both(w, dtype)
    jout, jgrad = _jax_vjp(lambda d: J.masked_segment_max(
        d, jnp.asarray(ids), S), xj, wj, jit=True)
    out, grad = _port_vjp(lambda d: P.masked_segment_max(
        d, torch.from_numpy(ids), S), xt, wt)
    assert out.dtype == xt.dtype and out.shape == (S,) + shape[1:]
    _same(out, jout)
    got, ref = _np(grad), _np(jgrad)
    if dtype == "float32":
        np.testing.assert_array_equal(got, ref)
    else:
        assert (np.abs(got - ref) <= _ulp_bf16(ref)).all()
        assert (got != 0).sum() >= (ref != 0).sum() > 0


def test_masked_segment_max_int32():
    """int32: the forward bit for bit, iinfo.min in empty segments, a
    given initial, dropped ids."""
    rng = np.random.default_rng(3)
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, (50, 3), dtype=np.int64) \
        .astype(np.int32)
    x[:3] = [[-2 ** 31] * 3, [2 ** 31 - 1] * 3, [0] * 3]
    ids = rng.integers(-1, 14, 50).astype(np.int32)
    for initial in (None, 5):
        ref = J.masked_segment_max(jnp.asarray(x), jnp.asarray(ids), 12,
                                   initial)
        got = P.masked_segment_max(torch.from_numpy(x),
                                   torch.from_numpy(ids), 12, initial)
        assert got.dtype == torch.int32
        _same(got, ref, str(initial))


# (scores, ids) at E 8 (pads appended) and S 6; "random" [300, 4], S 13
SOFTMAX_CASES = {
    "random": None,
    # a lone score of -50 gives 1.0 (shift max(max, 0) = 0, no underflow)
    "lone_minus_50": ([-50.0, 3.0, -2.0], [0, 1, 1]),
    # invalid lanes give 0; empty segments write nothing
    "pads_and_empty": ([1.0, 2.0, 7.0, -1.0, 0.5], [2, -1, 2, -3, 5]),
    # a NaN lane makes its segment NaN (segment 1: JAX's pads read
    # segment 0's denominator through its clipped gather, and would be NaN
    # too; the port's pads give 0)
    "nan": ([1.0, NAN, 2.0, 4.0, 1.0], [1, 1, 1, 0, 0]),
}


def _grad_scale(p, w):
    """The size of the terms p * w whose segment sums a softmax gradient
    subtracts: its tolerance's scale, since the difference may cancel."""
    pw = np.abs(_np(p) * _np(w))
    return np.nanmax(pw, initial=0.0)


@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_segment_softmax_matches_jax(case):
    """f32 forward and ``jax.grad`` within rtol 1e-5 (sums in another
    order; JAX also differentiates through the max, a term that cancels
    in exact arithmetic), the gradient's of the largest p * g term. One
    deliberate divergence (ROADMAP C): JAX's gradient through e / d
    squares d, which underflows for a lone score of -50 (d = e^-50), and
    its gradient there is NaN; the port's p * (g - sum p * g) gives the
    exact 0."""
    rng = np.random.default_rng(11)
    if SOFTMAX_CASES[case] is None:
        S = 13
        s = (rng.standard_normal((300, 4)) * 4).astype(np.float32)
        ids = rng.integers(-1, S, 300).astype(np.int32)
    else:
        S = 6
        s, ids = _padded(*SOFTMAX_CASES[case])
    w = rng.standard_normal(s.shape).astype(np.float32)
    jout, jgrad = _jax_vjp(lambda d: J.segment_softmax(
        d, jnp.asarray(ids), S), jnp.asarray(s), w, jit=case == "random")
    p, grad = _port_vjp(lambda d: pops.segment_softmax(
        d, torch.from_numpy(ids), S), torch.from_numpy(s),
        torch.from_numpy(w))
    _close(p, jout, F32_RTOL, "forward")
    jgrad = np.array(jgrad)
    if case == "lone_minus_50":
        assert float(p[0]) == 1.0
        assert np.isnan(jgrad[0]) and float(grad[0]) == 0.0
        jgrad[0] = 0.0
    _close(grad, jgrad, F32_RTOL, "grad", _grad_scale(p, w))
    assert (p[torch.from_numpy(ids) < 0] == 0).all()


@pytest.mark.parametrize("shape", [(200,), (200, 8), (200, 2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_softmax_bf16_and_shapes(shape, dtype):
    """[E], [E, H] and [E, H, F]: f32 within rtol 1e-5 of JAX's; bf16
    within K2's bf16 tolerance, since JAX rounds after each op where the
    port rounds once."""
    rng = np.random.default_rng(shape[-1])
    S = 17
    rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
    s = (rng.standard_normal(shape) * 2).astype(np.float32)
    ids = rng.integers(-1, S, shape[0]).astype(np.int32)
    w = rng.standard_normal(shape).astype(np.float32)
    sj, st = _both(s, dtype)
    wj, wt = _both(w, dtype)
    jout, jgrad = _jax_vjp(lambda d: J.segment_softmax(
        d, jnp.asarray(ids), S), sj, wj, jit=True)
    p, grad = _port_vjp(lambda d: P.segment_softmax(
        d, torch.from_numpy(ids), S), st, wt)
    assert p.dtype == st.dtype and p.shape == shape
    _close(p, jout, rtol, dtype)
    _close(grad, jgrad, rtol, dtype + " grad", _grad_scale(p, w))


def test_segment_softmax_drops_ids_past_the_segments():
    """A deliberate divergence (ROADMAP C): JAX takes an id >= S as valid
    and divides its exp by the last segment's denominator (clipped
    gathers); the port drops it like a pad."""
    s, ids = _padded([1.0, 2.0, 0.5], [0, 5, 9])
    ref = np.asarray(J.segment_softmax(jnp.asarray(s), jnp.asarray(ids), 6))
    got = P.segment_softmax(torch.from_numpy(s), torch.from_numpy(ids), 6)
    np.testing.assert_allclose(got.numpy()[:2], ref[:2], rtol=F32_RTOL)
    assert ref[2] > 0 and float(got[2]) == 0.0


@pytest.mark.parametrize("shape", [(90,), (90, 6), (90, 2, 5)])
def test_masked_segment_mean_matches_jax(shape):
    """f32 [E], [E, F], [E, H, F] with pads, ids past S and empty
    segments: the forward within rtol 1e-5, the gradient (g / count,
    gathered) equal."""
    rng = np.random.default_rng(len(shape))
    S = 16
    d = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(-2, S + 3, shape[0]).astype(np.int32)
    ids[ids == 4] = 5                    # segment 4 is empty
    w = rng.standard_normal((S,) + shape[1:]).astype(np.float32)
    jout, jgrad = _jax_vjp(lambda a: J.masked_segment_mean(
        a, jnp.asarray(ids), S), jnp.asarray(d), w)
    out, grad = _port_vjp(lambda a: pops.masked_segment_mean(
        a, torch.from_numpy(ids), S), torch.from_numpy(d),
        torch.from_numpy(w))
    _close(out, jout, F32_RTOL)
    assert (out[4] == 0).all()
    np.testing.assert_array_equal(grad.numpy(), np.asarray(jgrad))


def test_masked_segment_mean_counts_exactly_past_bf16():
    """A deliberate divergence (ROADMAP C): 300 lanes of 3.0 in one bf16
    segment. JAX counts and sums in bf16, its count stops at 256, and
    its mean is 4.0; the port counts exactly and sums in f32: 3.0. At
    small counts the two agree within bf16 rounding, the gradient too."""
    ids = np.zeros(300, np.int32)
    ref = J.masked_segment_mean(jnp.full((300,), 3.0, jnp.bfloat16),
                                jnp.asarray(ids), 1)
    got = P.masked_segment_mean(torch.full((300,), 3.0,
                                           dtype=torch.bfloat16),
                                torch.from_numpy(ids), 1)
    assert float(ref[0]) == 4.0 and float(got[0]) == 3.0
    assert got.dtype == torch.bfloat16
    rng = np.random.default_rng(5)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    ids = rng.integers(-1, 8, 64).astype(np.int32)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    dj, dt = _both(d, "bfloat16")
    wj, wt = _both(w, "bfloat16")
    jout, jgrad = _jax_vjp(lambda a: J.masked_segment_mean(
        a, jnp.asarray(ids), 8), dj, wj, jit=True)
    out, grad = _port_vjp(lambda a: P.masked_segment_mean(
        a, torch.from_numpy(ids), 8), dt, wt)
    _close(out, jout, BF16_RTOL)
    _close(grad, jgrad, BF16_RTOL, "grad")


def test_masked_segment_mean_counts_exactly_past_f16():
    """A deliberate divergence (ROADMAP C): 3000 lanes of 3.0 in one f16
    segment. JAX counts and sums in f16, its count stops at 2048, and its
    mean is 4.0; the port counts exactly and sums in f32: 3.0."""
    ids = np.zeros(3000, np.int32)
    ref = J.masked_segment_mean(jnp.full((3000,), 3.0, jnp.float16),
                                jnp.asarray(ids), 1)
    got = P.masked_segment_mean(torch.full((3000,), 3.0,
                                           dtype=torch.float16),
                                torch.from_numpy(ids), 1)
    assert float(ref[0]) == 4.0 and float(got[0]) == 3.0
    assert got.dtype == torch.float16


def test_ops_export_the_jax_names_and_refuse_other_devices():
    """The port's ops package exports the five names of ``legion_tpu.ops``;
    the K17 and K18 wrappers take CPU tensors to their plain versions
    without counting a launch, refuse other devices and dtypes (f64 in the
    max), take int64 ids as int32 ones, and count forward and backward
    launches apart."""
    assert set(pops.__all__) == set(jops.__all__)
    assert all(callable(getattr(pops, n)) for n in pops.__all__)
    assert {"segment_max", "segment_max_bwd", "segment_softmax",
            "segment_softmax_bwd"} <= set(kernels.LAUNCHES)
    before = dict(kernels.LAUNCHES)
    x = torch.ones((4, 2), requires_grad=True)
    ids = torch.tensor([0, 1, -1, 1], dtype=torch.int32)
    (P.masked_segment_max(x, ids, 2).sum()
     + P.segment_softmax(x, ids, 2).sum()).backward()
    assert kernels.LAUNCHES == before
    meta = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="segment_max: tensors on"):
        P.segment_max_fwd(meta, ids, 2, 0)
    with pytest.raises(ValueError, match="segment_softmax: tensors on"):
        P.segment_softmax_fwd(meta, ids, 2)
    with pytest.raises(ValueError, match="segment_max_bwd: tensors on"):
        P.segment_max_bwd(x.detach(), ids, meta[:2], meta[:2], 0.0)
    with pytest.raises(ValueError, match="segment_softmax_bwd: tensors on"):
        P.segment_softmax_bwd(meta, meta, ids, 2)
    with pytest.raises(ValueError, match="data torch.float64"):
        P.masked_segment_max(x.double(), ids, 2)
    # int64 ids give the int32 ids' result, bit for bit
    _same(P.segment_softmax(x, ids.long(), 2), P.segment_softmax(x, ids, 2))
    with pytest.raises(ValueError, match="data torch.int32"):
        P.segment_softmax(x.int(), ids, 2)


# (E, S, pad share, past-S share, hub share): the grouping of K17 and K18
GROUP_CASES = {"pads and ids past S": (400, 37, 0.2, 0.2, 0.0),
               "empty segments": (30, 200, 0.1, 0.1, 0.0),
               "a hub": (3000, 50, 0.1, 0.1, 0.6),
               "all dropped": (64, 8, 0.5, 1.0, 0.0),
               "one segment": (100, 1, 0.1, 0.1, 0.0),
               "no lane": (0, 5, 0.0, 0.0, 0.0)}


def _group_ids(case):
    E, S, pad, past, hub = GROUP_CASES[case]
    rng = np.random.default_rng(E + S)
    ids = rng.integers(0, S, E).astype(np.int32)
    ids[rng.random(E) < hub] = S // 2
    past = rng.random(E) < past
    ids[past] = S + rng.integers(0, 3, int(past.sum()))
    ids[rng.random(E) < pad] = -1
    return ids, S


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_segment_groups_plain_drops_ids_past_the_segments(case):
    """``segment_groups_plain`` (the grouping K17 and K18 run first): the
    lanes with 0 <= id < S grouped by id in ascending lane order, and the
    groups' starts, against numpy's stable argsort and bincount; a pad or
    an id >= S is in no group."""
    ids, S = _group_ids(case)
    lanes, starts = P.segment_groups_plain(torch.from_numpy(ids), S)
    valid = np.flatnonzero((ids >= 0) & (ids < S))
    ref = valid[np.argsort(ids[valid], kind="stable")]
    assert lanes.dtype == starts.dtype == torch.int32
    np.testing.assert_array_equal(lanes.numpy(), ref)
    np.testing.assert_array_equal(
        starts.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(ids[valid],
                                                   minlength=S))]))


def test_hop_mean_grads_grouping_still_clamps():
    """``hop_mean_grad``'s grouping is unchanged by the segment ops' drop
    rule: by default a src >= num_rows reads (and is grouped with) the
    last row; with ``drop`` it is left out."""
    from legion_tpu_torch.ops import hop_agg
    src = torch.tensor([3, 0, 9, -1, 4, 2, 3, 7], dtype=torch.int32)
    lanes, starts = hop_agg.lanes_by_source_plain(src, 4)
    assert lanes.tolist() == [1, 5, 0, 2, 4, 6, 7]
    assert starts.tolist() == [0, 1, 1, 2, 7]
    lanes, starts = hop_agg.lanes_by_source_plain(src, 4, drop=True)
    assert lanes.tolist() == [1, 5, 0, 6]
    assert starts.tolist() == [0, 1, 1, 2, 4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["max", "softmax"])
def test_saved_grouping_matches_plain_chain_and_jax(op, dtype):
    """``SegmentMax`` and ``SegmentSoftmax`` with a segment of more than
    32 lanes: the forward and the gradient equal the plain chain (the
    forward's plain version, then the backward's on its output) bit for
    bit and JAX's ``jax.grad`` within the tolerances of the cases above.
    On CUDA the Functions keep the forward's grouping for the backward
    (``ctx.groups``; ``chip_smoke.py`` holds that path on the card); on
    the CPU they keep none (``segment_groups_buffer`` is None), since the
    plain backwards read none, and a forward refuses a grouping buffer.
    Without a gradient to take no grouping is kept."""
    rng = np.random.default_rng(7)
    S = 11
    ids = rng.integers(-2, S + 2, 120).astype(np.int32)
    ids[:40] = 3                                  # a segment of > 32 lanes
    if op == "softmax":   # JAX's softmax keeps an id >= S (ROADMAP C)
        ids[ids >= S] = -1
    x = rng.integers(-3, 4, (120, 8)).astype(np.float32) \
        + (rng.standard_normal((120, 8)) * (op == "softmax")).astype(
            np.float32)
    xj, xt = _both(x, dtype)
    tid = torch.from_numpy(ids)
    if op == "max":
        w = rng.standard_normal((S, 8)).astype(np.float32)
        wj, wt = _both(w, dtype)
        port = lambda d: P.masked_segment_max(d, tid, S)
        jfn = lambda d: J.masked_segment_max(d, jnp.asarray(ids), S)
        key = int(P.order_keys_plain(torch.tensor(
            torch.finfo(xt.dtype).min, dtype=xt.dtype)))
        out_p = P.segment_max_plain(xt, tid, S, key)
        grad_p = P.segment_max_bwd_plain(xt, tid, out_p, wt,
                                         float(torch.finfo(xt.dtype).min))
    else:
        w = rng.standard_normal((120, 8)).astype(np.float32)
        wj, wt = _both(w, dtype)
        port = lambda d: P.segment_softmax(d, tid, S)
        jfn = lambda d: J.segment_softmax(d, jnp.asarray(ids), S)
        out_p = P.segment_softmax_plain(xt, tid, S)
        grad_p = P.segment_softmax_bwd_plain(out_p, wt, tid, S)
    xg = xt.clone().requires_grad_()
    out = port(xg)
    node = out.grad_fn                    # the op's reshape, then the Function
    while not hasattr(node, "groups"):
        node = node.next_functions[0][0]
    assert node.groups is None and P.segment_groups_buffer(tid, S) is None
    words = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="groups on the CPU"):
        if op == "max":
            P.segment_max_fwd(xt, tid, S, key, words)
        else:
            P.segment_softmax_fwd(xt, tid, S, words)
    out.backward(wt)
    _same(out, out_p, "forward against the plain chain")
    _same(xg.grad, grad_p, "gradient against the plain chain")
    jout, jgrad = _jax_vjp(jfn, xj, wj, jit=True)
    if dtype == "float32" and op == "max":
        _same(out, jout)
        np.testing.assert_array_equal(_np(xg.grad), _np(jgrad))
    else:
        rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
        _close(out, jout, rtol, "forward")
        if op == "max":
            got, ref = _np(xg.grad), _np(jgrad)
            assert (np.abs(got - ref) <= _ulp_bf16(ref)).all()
        else:
            _close(xg.grad, jgrad, rtol, "grad", _grad_scale(out, w))
    assert port(xt).grad_fn is None


# ---------------------------------------------------------------------------
# the public ops at JAX's ranks, dtypes and ids (ROADMAP C.1-C.3)
# ---------------------------------------------------------------------------

PUB_E, PUB_S = 40, 9
PUB_SHAPES = [(PUB_E,), (PUB_E, 3), (PUB_E, 2, 3)]
# the sums' and the mean's tolerance, of the largest value: f32 sums in
# another order; bf16 and f16 K2's 2e-2 (JAX sums in the data's dtype, the
# port in f32, rounding once); f64 1e-12; int32 exact
SUM_RTOL = {"float32": F32_RTOL, "bfloat16": BF16_RTOL,
            "float16": BF16_RTOL, "float64": 1e-12, "int32": 0.0}
# f16's softmax: JAX rounds after each f16 op, the port once
F16_SOFTMAX_RTOL = 4e-3


def _pub_ids(rng, E=PUB_E, S=PUB_S):
    """[E] int32 ids with pads, ids past S and an empty segment (S - 2)."""
    ids = rng.integers(-2, S + 2, E).astype(np.int32)
    ids[ids == S - 2] = 0
    return ids


def _inputs(shape, dtype, rng):
    if dtype == "int32":
        x = rng.integers(-1000, 1000, shape).astype(np.int32)
        return jnp.asarray(x), torch.from_numpy(x)
    return _both(rng.standard_normal(shape).astype(np.float32), dtype)


def _ulp_f16(v):
    """One f16 ulp of each value (11 significant bits; 2^-24 below the
    normal range)."""
    v = np.maximum(np.abs(v.astype(np.float32)), 2.0 ** -14)
    return np.exp2(np.floor(np.log2(v)) - 10)


@pytest.mark.parametrize("shape", PUB_SHAPES)
@pytest.mark.parametrize("dtype", sorted(SUM_RTOL))
def test_sum_and_mean_match_jax_at_every_rank_and_dtype(shape, dtype):
    """``masked_segment_sum`` and ``masked_segment_mean`` at [E], [E, F]
    and [E, a, b] in f32, bf16, f16, f64 and int32, with pads, ids past S
    and an empty segment: JAX's dtype (the int32 mean's f32) and shape,
    its values within ``SUM_RTOL`` of the largest (int32 sums exact, the
    int32 mean bit for bit). For floats the gradients too (C.3): the
    sum's g[seg] bit for bit, 0 for a pad or an id >= S; the mean's g /
    count bit for bit in f32 and f64, within ``SUM_RTOL`` in bf16 and
    f16."""
    rng = np.random.default_rng(len(shape) + len(dtype))
    ids = _pub_ids(rng)
    tid = torch.from_numpy(ids)
    xj, xt = _inputs(shape, dtype, rng)
    w = rng.standard_normal((PUB_S,) + shape[1:]).astype(np.float32)
    for name in ("masked_segment_sum", "masked_segment_mean"):
        def jfn(d, name=name):
            return getattr(J, name)(d, jnp.asarray(ids), PUB_S)

        def pfn(d, name=name):
            return getattr(P, name)(d, tid, PUB_S)
        if dtype == "int32":
            ref, got = jfn(xj), pfn(xt)
            assert got.dtype == (torch.int32 if name.endswith("sum")
                                 else torch.float32)
            assert np.asarray(ref).dtype == got.numpy().dtype
            _same(got, ref, name)
            continue
        wj, wt = _both(w, dtype)
        jout, jgrad = _jax_vjp(jfn, xj, wj)
        out, grad = _port_vjp(pfn, xt, wt)
        assert out.dtype == xt.dtype and out.shape == (PUB_S,) + shape[1:]
        _close(out, jout, SUM_RTOL[dtype], name)
        if name.endswith("sum") or dtype in ("float32", "float64"):
            _same(grad, jgrad, name + " grad")
        else:
            _close(grad, jgrad, SUM_RTOL[dtype], name + " grad")
        assert (grad[(tid < 0) | (tid >= PUB_S)] == 0).all()


def test_int32_sum_wraps_and_the_int32_mean_is_jaxs_bit_for_bit():
    """int32 sums are exact and wrap modulo 2^32, as XLA's int32
    scatter-add does: two lanes of 2^30 give -2^31 (in the public sum and
    in K2's plain version, which sums in int64 and wraps), lanes across
    the whole int32 range equal JAX's bit for bit. The int32 mean
    converts the sum and the exact count to f32 and divides once, as
    JAX's true division does: bit for bit."""
    two = torch.full((2, 1), 2 ** 30, dtype=torch.int32)
    zero = torch.zeros(2, dtype=torch.int32)
    assert P.masked_segment_sum(two[:, 0], zero, 1).tolist() == [-2 ** 31]
    assert kernels.segment_sum_plain(two, zero, 1).tolist() == [[-2 ** 31]]
    rng = np.random.default_rng(31)
    x = rng.integers(-2 ** 31, 2 ** 31, (PUB_E, 2)).astype(np.int32)
    x[:6] = 2 ** 31 - 1
    ids = _pub_ids(rng)
    ids[:6] = 1
    for name in ("masked_segment_sum", "masked_segment_mean"):
        ref = getattr(J, name)(jnp.asarray(x), jnp.asarray(ids), PUB_S)
        got = getattr(P, name)(torch.from_numpy(x), torch.from_numpy(ids),
                               PUB_S)
        assert np.asarray(ref).dtype == got.numpy().dtype
        _same(got, ref, name)


def _special_f16(rng, shape):
    """f16 small integers (ties), a NaN, -0.0 and +0.0."""
    x = rng.integers(-3, 4, shape).astype(np.float16)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, 4, replace=False)] = [np.nan, -0.0, 0.0,
                                                      -0.0]
    return x


@pytest.mark.parametrize("shape", PUB_SHAPES)
def test_f16_max_and_softmax_match_jax(shape):
    """f16, the plain versions of K17's and K18's f16 forms: the max bit
    for bit (ties, a NaN, the sign of a zero), its gradient within one f16
    ulp (JAX rounds n, 1 / n and the product to f16, as the port does);
    the softmax within 4e-3 of the largest value, its gradient within
    4e-3 of the largest p * g term (JAX rounds after each f16 op, the
    port once; ids past S are pads here, ROADMAP C)."""
    rng = np.random.default_rng(16 + len(shape))
    ids = _pub_ids(rng)
    tid = torch.from_numpy(ids)
    x = _special_f16(rng, shape)
    w = rng.standard_normal((PUB_S,) + shape[1:]).astype(np.float16)
    jout, jgrad = _jax_vjp(lambda d: J.masked_segment_max(
        d, jnp.asarray(ids), PUB_S), jnp.asarray(x, jnp.float16),
        jnp.asarray(w, jnp.float16))
    out, grad = _port_vjp(lambda d: P.masked_segment_max(d, tid, PUB_S),
                          torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.float16
    _same(out, jout, "max")
    got, ref = _np(grad).astype(np.float32), np.asarray(jgrad, np.float32)
    assert (np.abs(got - ref) <= _ulp_f16(ref)).all()
    assert (got != 0).sum() >= (ref != 0).sum() > 0
    ids = np.where(ids >= PUB_S, -1, ids).astype(np.int32)
    s = (rng.standard_normal(shape) * 2).astype(np.float16)
    w = rng.standard_normal(shape).astype(np.float16)
    jout, jgrad = _jax_vjp(lambda d: J.segment_softmax(
        d, jnp.asarray(ids), PUB_S), jnp.asarray(s, jnp.float16),
        jnp.asarray(w, jnp.float16))
    p, grad = _port_vjp(lambda d: P.segment_softmax(
        d, torch.from_numpy(ids), PUB_S), torch.from_numpy(s),
        torch.from_numpy(w))
    assert p.dtype == torch.float16 and p.shape == shape
    _close(p.float(), np.asarray(jout, np.float32), F16_SOFTMAX_RTOL,
           "softmax")
    _close(grad.float(), np.asarray(jgrad, np.float32), F16_SOFTMAX_RTOL,
           "softmax grad", _grad_scale(p.float(), w.astype(np.float32)))


# int64 ids past int32 (each narrowed to the int32 id that means the same)
BIG_IDS = {2 ** 32 + 1: -1, 2 ** 31 + 1: -1, -2 ** 32: -1, 2 ** 40 + 2: -1}


@pytest.mark.parametrize("id_dtype", ["int64", "int16", "uint8", "uint16",
                                      "uint32"])
def test_ids_of_any_integer_dtype_give_the_int32_result(id_dtype):
    """Every public op with int64, int16, uint8, uint16 or uint32 ids (the
    unsigned: no pads) equals the same op with the int32 ids that mean the
    same, bit for bit, forward and gradient; the sum and the gather equal
    JAX's given
    ids of that dtype (``jnp.asarray(..., dtype)``). int64 ids past int32
    are clamped before they are narrowed: 2^32 + 1 is dropped by the
    segment ops, not wrapped to 1 (JAX's scatters truncate an int64 id to
    its low 32 bits, ROADMAP C; JAX is given the dropped id there), and
    reads the last row in the gather, as JAX's clip does."""
    rng = np.random.default_rng(64)
    lo = 0 if id_dtype.startswith("uint") else -1
    ids = rng.integers(lo, PUB_S + 2, PUB_E).astype(np.int64)
    i32 = ids.astype(np.int32)
    big = ids.copy()
    if id_dtype == "int64":
        at = rng.choice(PUB_E, len(BIG_IDS), replace=False)
        big[at] = list(BIG_IDS)
        i32[at] = list(BIG_IDS.values())
    big = big.astype(id_dtype)
    x = rng.standard_normal((PUB_E, 3)).astype(np.float32)
    w = rng.standard_normal((PUB_S, 3)).astype(np.float32)
    for op in ("masked_segment_sum", "masked_segment_mean",
               "masked_segment_max", "segment_softmax"):
        g = w if op != "segment_softmax" else x[::-1].copy()
        by = [_port_vjp(lambda d, i=i: getattr(P, op)(d, i, PUB_S),
                        torch.from_numpy(x), torch.from_numpy(g))
              for i in (torch.from_numpy(big), torch.from_numpy(i32))]
        _same(by[0][0], by[1][0], op)
        _same(by[0][1], by[1][1], op + " grad")
    ref = J.masked_segment_sum(jnp.asarray(x), jnp.asarray(
        np.where(i32 < 0, -1, big.astype(np.int64)), _jdt_id(id_dtype)),
        PUB_S)
    _close(P.masked_segment_sum(torch.from_numpy(x), torch.from_numpy(big),
                                PUB_S), ref, F32_RTOL, "sum against JAX")
    gid = big.reshape(4, -1)
    ref = J.gather_rows(jnp.asarray(w), jnp.asarray(gid, _jdt_id(id_dtype)))
    got = P.gather_rows(torch.from_numpy(w), torch.from_numpy(gid))
    pad = torch.from_numpy(gid.astype(np.int64) < 0)
    assert got.shape == ref.shape and (got[pad] == 0).all()
    _same(got[~pad], np.asarray(ref)[~pad.numpy()], "gather")


def _jdt_id(id_dtype):
    return {"int64": jnp.int64, "int16": jnp.int16, "uint8": jnp.uint8,
            "uint16": jnp.uint16, "uint32": jnp.uint32}[id_dtype]


# name: (table, ids): gather_rows' tables of every rank and some dtypes,
# ids of two shapes with pads and ids past V (V = 7)
GATHER_CASES = {
    "[V] f32, [2, 4] ids": ((7,), np.float32, (2, 4)),
    "[V, 3] int32": ((7, 3), np.int32, (9,)),
    "[V, 5] bool": ((7, 5), np.bool_, (2, 4)),
    "[V, 3] uint8": ((7, 3), np.uint8, (2, 4)),
    "[V, 2, 3] f64": ((7, 2, 3), np.float64, (2, 4)),
    "[V] f16": ((7,), np.float16, (9,)),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_rows_takes_any_table_and_id_shape(case):
    """``gather_rows`` of [V], [V, F] and [V, a, b] tables of f32, int32,
    bool, uint8, f64 and f16 by [N] and [2, 4] ids with pads and ids past
    V: JAX's ``table[clip(idx, 0, V - 1)]`` of shape ``idx.shape +
    table.shape[1:]`` in the table's dtype, bit for bit; a pad's row is
    zero where JAX's is row 0 (the recorded divergence "Pad rows")."""
    tshape, dtype, ishape = GATHER_CASES[case]
    rng = np.random.default_rng(len(case))
    table = rng.integers(0, 100, tshape).astype(dtype) if dtype != np.bool_ \
        else rng.random(tshape) < 0.5
    if dtype in (np.float32, np.float64, np.float16):
        table = (table + rng.standard_normal(tshape)).astype(dtype)
    idx = rng.integers(-1, 10, ishape).astype(np.int32)
    ref = np.asarray(J.gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    got = P.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == ref.shape and got.numpy().dtype == ref.dtype
    pad = idx < 0
    np.testing.assert_array_equal(got.numpy()[~pad], ref[~pad])
    assert not got.numpy()[pad].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
def test_gather_rows_gradient_matches_jax_grad(dtype):
    """The gradient of ``gather_rows`` under autograd against
    ``jax.grad``, [V, 2, 3] tables by [5, 8] ids (C.2): rows summed into
    clip(id, 0, V - 1), an id >= V into row V - 1, the row the forward
    read. Pads' cotangents are 0 for JAX, whose clipped gather sends them
    to row 0; the port's pads add nothing, whatever their cotangent.
    f32 within rtol 1e-5 (sums in another order), bf16 and f16 2e-2 (JAX
    sums in the dtype), f64 1e-12."""
    rng = np.random.default_rng(2)
    V = 7
    idx = rng.integers(-1, V + 3, (5, 8)).astype(np.int32)
    idx[0, :3] = [V, V + 2, V - 1]
    tj, tt = _both(rng.standard_normal((V, 2, 3)).astype(np.float32), dtype)
    w = rng.standard_normal((5, 8, 2, 3)).astype(np.float32)
    wj, wt = _both(np.where((idx < 0)[..., None, None], 0, w), dtype)
    _, jgrad = _jax_vjp(lambda t: J.gather_rows(t, jnp.asarray(idx)), tj, wj)
    out, grad = _port_vjp(lambda t: P.gather_rows(t, torch.from_numpy(idx)),
                          tt, _both(w, dtype)[1])
    assert grad.dtype == tt.dtype and grad.shape == tt.shape
    _close(grad, jgrad, SUM_RTOL[dtype], "grad")


def test_gradients_of_the_c2_and_c3_examples():
    """C.2: a [7, 2] table, ids [2, 6, 9, 0], the gradient of sum(): row 6
    gets [2, 2] (the id 9 reads row 6), as ``jax.grad`` gives. C.3: ids
    [0, 5, 1, -1, 2] into 3 segments, out weighted by [1, 2, 3]: the
    gradient [1, 0, 2, 0, 3], as ``jax.grad`` gives."""
    t = np.arange(14, dtype=np.float32).reshape(7, 2)
    ids = np.array([2, 6, 9, 0], np.int32)
    ref = jax.grad(lambda a: J.gather_rows(a, jnp.asarray(ids)).sum())(
        jnp.asarray(t))
    tt = torch.from_numpy(t).requires_grad_()
    P.gather_rows(tt, torch.from_numpy(ids)).sum().backward()
    _same(tt.grad, ref)
    assert tt.grad[6].tolist() == [2.0, 2.0]
    seg = np.array([0, 5, 1, -1, 2], np.int32)
    wts = np.array([1.0, 2.0, 3.0], np.float32)
    ref = jax.grad(lambda a: (J.masked_segment_sum(
        a, jnp.asarray(seg), 3) * wts).sum())(jnp.ones(5, jnp.float32))
    x = torch.ones(5, requires_grad=True)
    (P.masked_segment_sum(x, torch.from_numpy(seg), 3)
     * torch.from_numpy(wts)).sum().backward()
    _same(x.grad, ref)
    assert x.grad.tolist() == [1.0, 0.0, 2.0, 0.0, 3.0]


IDS3 = torch.tensor([0, 1, -1], dtype=torch.int32)
REFUSALS = {
    "sum int64": (lambda: P.masked_segment_sum(
        torch.ones(3, dtype=torch.int64), IDS3, 2),
        "masked_segment_sum: data torch.int64"),
    "sum bool": (lambda: P.masked_segment_sum(
        torch.ones(3, dtype=torch.bool), IDS3, 2),
        "masked_segment_sum: data torch.bool"),
    "mean int64": (lambda: P.masked_segment_mean(
        torch.ones(3, dtype=torch.int64), IDS3, 2),
        "masked_segment_mean: data torch.int64"),
    "max f64": (lambda: P.masked_segment_max(
        torch.ones(3, dtype=torch.float64), IDS3, 2),
        "masked_segment_max: data torch.float64"),
    "max int64": (lambda: P.masked_segment_max(
        torch.ones(3, dtype=torch.int64), IDS3, 2),
        "masked_segment_max: data torch.int64"),
    "softmax f64": (lambda: P.segment_softmax(
        torch.ones(3, dtype=torch.float64), IDS3, 2),
        "segment_softmax: data torch.float64"),
    "softmax int32": (lambda: P.segment_softmax(
        torch.ones(3, dtype=torch.int32), IDS3, 2),
        "segment_softmax: data torch.int32"),
    "float ids": (lambda: P.masked_segment_sum(torch.ones(3), IDS3.float(),
                                               2),
                  "masked_segment_sum: ids torch.float32"),
    "uint64 ids": (lambda: P.gather_rows(
        torch.ones(3), torch.zeros(2, dtype=torch.uint64)),
        "gather_rows: ids torch.uint64"),
    "bool ids": (lambda: P.segment_softmax(torch.ones(3), IDS3 > 0, 2),
                 "segment_softmax: ids torch.bool"),
    "S of 2^31": (lambda: P.masked_segment_sum(torch.ones(3), IDS3.long(),
                                               2 ** 31),
                  "masked_segment_sum: 2147483648 segments"),
    "ids [E, 1]": (lambda: P.masked_segment_sum(torch.ones(3), IDS3[:, None],
                                                2),
                   "masked_segment_sum: data (3,), segment ids (3, 1)"),
    "empty table": (lambda: P.gather_rows(torch.ones((0, 2)), IDS3),
                    "gather_rows: an empty table"),
    "complex gradient": (lambda: P.gather_rows(
        torch.ones(3, dtype=torch.complex64, requires_grad=True), IDS3),
        "gather_rows: no gradient for data torch.complex64"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_public_ops_refuse_what_the_contract_leaves_out(case):
    """Outside the contract each public op raises a ValueError that names
    the function and what it refused (the refused dtypes are deliberate
    divergences, ROADMAP C); none falls back to plain PyTorch."""
    fn, msg = REFUSALS[case]
    with pytest.raises(ValueError, match=re.escape(msg)):
        fn()


def test_empty_shapes_match_jax():
    """E = 0, S = 0, V = 1, ids with a zero dimension and [E, 0] rows: each
    op gives JAX's shape, dtype and values (zeros, the max's initial), and
    the sum's and the gather's gradients their shapes."""
    cases = [
        ("sum E 0", lambda m, i: m.masked_segment_sum(
            i(np.zeros((0, 3), np.float32)), i(np.zeros(0, np.int32)), 4)),
        ("sum S 0", lambda m, i: m.masked_segment_sum(
            i(np.ones((3, 2), np.float32)), i(np.zeros(3, np.int32)), 0)),
        ("mean [E, 0]", lambda m, i: m.masked_segment_mean(
            i(np.ones((3, 0), np.float32)), i(np.zeros(3, np.int32)), 2)),
        ("mean int32 E 0", lambda m, i: m.masked_segment_mean(
            i(np.zeros((0,), np.int32)), i(np.zeros(0, np.int32)), 2)),
        ("max E 0", lambda m, i: m.masked_segment_max(
            i(np.zeros((0, 2), np.float16)), i(np.zeros(0, np.int32)), 3)),
        ("max S 0", lambda m, i: m.masked_segment_max(
            i(np.ones((3, 2), np.float32)), i(np.zeros(3, np.int32)), 0)),
        ("softmax E 0", lambda m, i: m.segment_softmax(
            i(np.zeros((0,), np.float32)), i(np.zeros(0, np.int32)), 2)),
        ("gather V 1", lambda m, i: m.gather_rows(
            i(np.array([[1.5, -2.0]], np.float32)),
            i(np.array([0, 3, 1], np.int32)))),
        ("gather [2, 0] ids", lambda m, i: m.gather_rows(
            i(np.ones((5, 2), np.float32)), i(np.zeros((2, 0), np.int32)))),
        ("gather V 0, no id", lambda m, i: m.gather_rows(
            i(np.ones((0, 3), np.float32)), i(np.zeros(0, np.int32)))),
    ]
    for what, fn in cases:
        ref = np.asarray(fn(J, jnp.asarray))
        got = fn(P, torch.from_numpy)
        assert got.shape == ref.shape, what
        assert got.numpy().dtype == ref.dtype, what
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)
    x = torch.zeros((0, 3), requires_grad=True)
    P.masked_segment_sum(x, torch.zeros(0, dtype=torch.int32), 4).sum() \
        .backward()
    assert x.grad.shape == (0, 3)
    t = torch.ones((5, 2), requires_grad=True)
    P.gather_rows(t, torch.zeros((2, 0), dtype=torch.int32)).sum().backward()
    assert torch.equal(t.grad, torch.zeros(5, 2))


def test_csr_neighbors_match_jax():
    """``CSRGraph.neighbors`` against the JAX package's, every vertex of a
    graph with empty rows."""
    rng = np.random.default_rng(2)
    V = 60
    src = rng.integers(0, V // 2, 500)
    dst = rng.integers(0, V, 500)
    g, jg = CSRGraph.from_edges(src, dst, V), JGraph.from_edges(src, dst, V)
    assert (g.degrees() == 0).any()
    for v in range(V):
        np.testing.assert_array_equal(g.neighbors(v), jg.neighbors(v))
        assert g.neighbors(v).dtype == np.int32


def test_torch_linear_init_shapes_bounds_and_uniformity():
    """``torch_linear_init``: JAX's shapes and dtype, every value inside
    +-1/sqrt(in), uniform over it (Kolmogorov-Smirnov), the same draws
    from the same seed, no "b" without bias. Its values cannot match
    JAX's: the generators differ."""
    from legion_tpu.models.common import torch_linear_init as jinit
    ref = jax.eval_shape(lambda k: jinit(k, 300, 40), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    p = torch_linear_init(gen, 300, 40)
    assert set(p) == set(ref) == {"w", "b"}
    for k in p:
        assert tuple(p[k].shape) == ref[k].shape
        assert p[k].dtype == torch.float32
    bound = 1 / np.sqrt(300)
    for t in p.values():
        assert t.abs().max() <= bound
    assert stats.kstest(p["w"].numpy().ravel(), "uniform",
                        args=(-bound, 2 * bound)).pvalue > 1e-3
    again = torch_linear_init(torch.Generator().manual_seed(0), 300, 40)
    assert all(torch.equal(p[k], again[k]) for k in p)
    nob = torch_linear_init(gen, 7, 3, bias=False, dtype=torch.bfloat16)
    assert set(nob) == set(jax.eval_shape(
        lambda k: jinit(k, 7, 3, bias=False), jax.random.PRNGKey(1)))
    assert nob["w"].dtype == torch.bfloat16 and nob["w"].shape == (7, 3)
