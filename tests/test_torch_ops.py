"""Parity of the port's kernel modules with the JAX package, on the CPU.

K1 (``gather_rows``) and K2 (``segment_sum``) run their plain PyTorch
versions here (CPU tensors); the CUDA kernels are compared with those same
plain versions on the card by ``chip_smoke.py``. The Pallas kernels they
replace run in TPU interpret mode. Inputs are made with numpy from a seed
and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from legion_tpu.cache.unified_cache import DeviceFeatureSource as JaxSource
from legion_tpu.ops import hop_agg as jhop
from legion_tpu.ops import segment as jseg
from legion_tpu.ops.pallas_segment import (gather_rows_pallas,
                                           segment_sum_pallas)
from legion_tpu_torch.cache.unified_cache import DeviceFeatureSource
from legion_tpu_torch.ops import hop_agg, kernels
from legion_tpu_torch.ops.segment import gather_rows, masked_segment_sum

# f32 sums taken in another order (index_add_ vs XLA scatter / a VMEM
# accumulator): a few ulps of the largest partial sum
F32_ATOL = 1e-5
# bf16 has 8 mantissa bits; the JAX transpose of a bf16 gather also sums
# in bf16 while the port sums in f32 and casts once (a known divergence)
BF16_RTOL = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _ids(rng, n, num_rows, pad_frac=0.1):
    ids = rng.integers(0, num_rows, n).astype(np.int32)
    ids[rng.random(n) < pad_frac] = -1
    return ids


def test_gather_rows_matches_pallas_and_fetch():
    """K1's plain version == gather_rows_pallas (interpret mode) ==
    DeviceFeatureSource.fetch, exactly, bf16, with -1 pads."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((300, 128)).astype(np.float32)
    ids = _ids(rng, 2048, 300)
    tj = jnp.asarray(table, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = gather_rows_pallas(tj, jnp.asarray(ids))
    rows_j, n_j = JaxSource(tj).fetch(jnp.asarray(ids))
    tt = torch.from_numpy(table).to(torch.bfloat16)
    out = kernels.gather_rows(tt, torch.from_numpy(ids))
    rows_p, n_p = DeviceFeatureSource(tt).fetch(torch.from_numpy(ids))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), _np(ref))
    np.testing.assert_array_equal(_np(rows_p), _np(rows_j))
    assert int(n_p) == int(n_j) == int((ids >= 0).sum())
    assert kernels.LAUNCHES["gather_rows"] == 0   # CPU tensors: plain path


def test_gather_rows_into_out():
    """K1 writes into a given ``out`` (the clique owners serve into the
    exchange's buffer), a slice of a larger tensor; a wrong ``out``
    raises."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((50, 24))
                             .astype(np.float32)).to(torch.bfloat16)
    ids = torch.from_numpy(_ids(rng, 40, 50))
    buf = torch.full((3, 40, 24), 7.0, dtype=torch.bfloat16)
    got = kernels.gather_rows(table, ids, out=buf[1])
    assert got.data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], kernels.gather_rows_plain(table, ids))
    assert (buf[0] == 7).all() and (buf[2] == 7).all()
    for bad in (torch.empty((40, 24)), torch.empty((39, 24),
                                                   dtype=torch.bfloat16),
                buf[:, 0]):
        with pytest.raises(ValueError, match="out"):
            kernels.gather_rows(table, ids, out=bad)


def test_segment_sum_matches_pallas_and_masked_segment_sum():
    """K2's plain version == segment_sum_pallas (interpret mode) and
    == masked_segment_sum, f32, duplicate-heavy, -1 dropped."""
    rng = np.random.default_rng(1)
    data = rng.standard_normal((2048, 128)).astype(np.float32)
    seg = rng.integers(-1, 64, 2048).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = segment_sum_pallas(jnp.asarray(data), jnp.asarray(seg), 64)
    ref2 = jseg.masked_segment_sum(jnp.asarray(data), jnp.asarray(seg), 64)
    out = kernels.segment_sum(torch.from_numpy(data), torch.from_numpy(seg),
                              64)
    out2 = masked_segment_sum(torch.from_numpy(data), torch.from_numpy(seg),
                              64)
    assert out.dtype == torch.float32 and out.shape == (64, 128)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(_np(out2), _np(ref2), rtol=0, atol=F32_ATOL)


def _edge_segments(rng, kind, E, S):
    """Segment ids at the edges K2's kernel takes apart: uniform ids with
    pads, every lane on one hub row, every lane dropped, ids past S."""
    if kind == "uniform":
        return _ids(rng, E, S)
    if kind == "one hub":
        return np.full(E, S // 2, np.int32)
    if kind == "all dropped":
        return np.full(E, -1, np.int32)
    seg = _ids(rng, E, S)                     # "ids >= S": half of them
    seg[::2] = S + rng.integers(0, 5, seg[::2].shape).astype(np.int32)
    return seg


@pytest.mark.parametrize("kind", ["uniform", "one hub", "all dropped",
                                  "ids >= S"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 4, 100, 128, 130])
def test_segment_sum_plain_matches_jax_at_kernel_edges(F, dtype, kind):
    """K2's plain version at the widths its kernel takes as chunks of four
    columns (4, 100, 128) or a column at a time (1, 130) and at the skews
    it combines or drops, against JAX's ``masked_segment_sum`` and, where
    it is defined (width 128, ids below S), ``segment_sum_pallas`` in
    interpret mode. f32: 1e-5 of the largest sum. bf16: the port sums in
    f32 and casts once (JAX sums in bf16), so it is held to JAX's sum of
    the same values widened to f32 within 1e-5, and to JAX's own bf16 sum
    within BF16_RTOL where a sum is short (the uniform ids)."""
    rng = np.random.default_rng(1000 * F + len(kind))
    E, S = 512, 24
    seg = _edge_segments(rng, kind, E, S)
    data = rng.standard_normal((E, F)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    dj = jnp.asarray(data, jdt)
    dt_ = torch.from_numpy(data).to(tdt)
    np.testing.assert_array_equal(_np(dt_), _np(dj))
    out = kernels.segment_sum(dt_, torch.from_numpy(seg), S)
    assert out.dtype == torch.float32 and out.shape == (S, F)
    ref = _np(jseg.masked_segment_sum(dj.astype(jnp.float32),
                                      jnp.asarray(seg), S))
    atol = F32_ATOL * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=atol)
    out2 = masked_segment_sum(dt_, torch.from_numpy(seg), S)
    assert out2.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(out2), ref, rtol=0, atol=atol)
    elif kind != "one hub":
        ref2 = _np(jseg.masked_segment_sum(dj, jnp.asarray(seg), S))
        np.testing.assert_allclose(_np(out2), ref2, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * max(1.0,
                                                        np.abs(ref2).max()))
    if F % 128 == 0 and kind != "ids >= S":
        with pltpu.force_tpu_interpret_mode():
            refp = segment_sum_pallas(dj, jnp.asarray(seg), S, chunk=E)
        np.testing.assert_allclose(_np(out), _np(refp), rtol=0, atol=atol)
    assert kernels.LAUNCHES["segment_sum"] == 0   # CPU tensors: plain path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_backward_matches_jax_grad(dtype):
    """GatherRows' backward (K2 into the table, cast to its dtype) equals
    jax.grad of the gather, on the lanes consumers keep (JAX routes pad
    lanes' gradient to row 0; the port gives pads zero rows and none)."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((200, 128)).astype(np.float32)
    ids = _ids(rng, 1500, 200)
    w = rng.standard_normal((1500, 128)).astype(np.float32)
    valid = ids >= 0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jloss(t):
        rows = jseg.gather_rows(t, jnp.asarray(ids))
        rows = jnp.where(jnp.asarray(valid)[:, None], rows, 0)
        return jnp.sum(rows.astype(jnp.float32) * w)

    gj = jax.grad(jloss)(jnp.asarray(table, jdt))
    tt = torch.from_numpy(table).to(tdt).requires_grad_()
    rows = gather_rows(tt, torch.from_numpy(ids))
    (rows.float() * torch.from_numpy(w)).sum().backward()
    assert tt.grad.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(tt.grad), _np(gj), rtol=0,
                                   atol=F32_ATOL)
    else:
        np.testing.assert_allclose(_np(tt.grad), _np(gj), rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(_np(gj)).max())


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hop_neighbor_sum_mean_forward_and_grad(aligned, dtype):
    """hop_neighbor_sum / hop_neighbor_mean: outputs and d h_src equal
    the JAX ops, lane-aligned and gathered hops, f32 and bf16 inputs."""
    rng = np.random.default_rng(3)
    fanout, F, d = 5, 40, 128
    S_dst, offset = 70, 30              # frontier rows [30, 70)
    n_src = S_dst + fanout * F
    h = rng.standard_normal((n_src, d)).astype(np.float32)
    if aligned:
        src_l = S_dst + np.arange(fanout * F, dtype=np.int32)
        aoff = S_dst
    else:
        src_l = rng.integers(0, n_src, fanout * F).astype(np.int32)
        aoff = None
    src_l[rng.random(fanout * F) < 0.2] = -1
    w = rng.standard_normal((S_dst, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jfn(hh):
        s, c = jhop.hop_neighbor_sum(hh, jnp.asarray(src_l), fanout,
                                     jnp.int32(offset), S_dst, aoff)
        m = jhop.hop_neighbor_mean(hh, jnp.asarray(src_l), fanout,
                                   jnp.int32(offset), S_dst, aoff)
        return jnp.sum(m.astype(jnp.float32) * w), (s, c, m)

    (_, (sj, cj, mj)), gj = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(h, jdt))
    ht = torch.from_numpy(h).to(tdt).requires_grad_()
    off_t = torch.tensor(offset, dtype=torch.int32)
    sp, cp = hop_agg.hop_neighbor_sum(ht, torch.from_numpy(src_l), fanout,
                                      off_t, S_dst, aoff)
    mp = hop_agg.hop_neighbor_mean(ht, torch.from_numpy(src_l), fanout,
                                   off_t, S_dst, aoff)
    (mp.float() * torch.from_numpy(w)).sum().backward()
    assert sp.dtype == torch.float32 and mp.dtype == torch.float32
    np.testing.assert_array_equal(_np(cp), _np(cj))
    # forward: both accumulate in f32 over the same (bf16-exact) inputs
    np.testing.assert_allclose(_np(sp), _np(sj), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(_np(mp), _np(mj), rtol=0, atol=F32_ATOL)
    if dtype == "float32" or aligned:
        # aligned hops have no gather transpose: grads agree to f32 order
        # (bf16 grads round once, identically, in both)
        np.testing.assert_allclose(_np(ht.grad), _np(gj), rtol=0,
                                   atol=F32_ATOL)
    else:
        np.testing.assert_allclose(_np(ht.grad), _np(gj), rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(_np(gj)).max())
