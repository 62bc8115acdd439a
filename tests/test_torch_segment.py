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
            "int32": jnp.int32}[dtype]


def _tdt(dtype):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
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


def test_ops_export_the_jax_names_and_refuse_other_devices():
    """The port's ops package exports the five names of ``legion_tpu.ops``;
    the K17 and K18 wrappers take CPU tensors to their plain versions
    without counting a launch, refuse other devices and dtypes, and count
    forward and backward launches apart."""
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
    with pytest.raises(ValueError, match="data torch.float16"):
        P.masked_segment_max(x.half(), ids, 2)
    with pytest.raises(ValueError, match="segment ids torch.int64"):
        P.segment_softmax(x, ids.long(), 2)
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
