// K18 segment_softmax: p[e, h] = exp(x[e, h] - m[s, h]) / max(d[s, h],
// tiny) over the lanes e of segment s = seg[e], with m[s, h] = max(0, max
// of x[e, h] in s) and d[s, h] the sum of the lanes' exp; lanes with
// seg[e] < 0 or >= S give 0. And its backward, dx = p * (g - sum over the
// segment of p * g). x is [E, H] f32, bf16 or f16, p the same.
//
// Replaces legion_tpu/ops/segment.py::segment_softmax (:67-80), XLA (a
// scatter-max, a scatter-add and two gathers), and its gradient under
// jax.grad. On no path of the JAX package or of the port (GAT's softmax is
// K6 and K7): the port's ops package carries it because the JAX
// package's does.
//
// All in f32, rounded once to x's type: m from K17's order-preserving keys
// (segment_keys.cuh) after a max with +0's key, e = expf(x - m), p = e *
// (1 / max(d, tiny)) (tiny = FLT_MIN, bf16's too, and f16 data's, whose d
// is an f32 sum; a NaN d stays NaN; the plain version divides, a rounding
// apart). JAX computes a bf16 or f16
// softmax in that type, rounding after each op; this kernel rounds once
// (ROADMAP C). Within rtol 1e-5 in f32 and one bf16 or f16 ulp of the
// plain version (ops/segment.py::segment_softmax_plain), and the same
// bits from run to run: no atomic adds a sum.
//
// Bound on this card: device-memory bytes (forward: x and the ids read, p
// written; backward: p, g and the ids read, dx written).
// Segment-major: the forward groups the valid lanes by segment
// (lane_groups.cuh) and the backward reads that grouping (the autograd
// Function keeps it); then a group of threads takes a segment: a thread
// a 16-byte piece of the row (4 f32 or 8 bf16 heads; one element where
// the width or a base's alignment forbids it) and every other lane of
// the segment, in ascending lane order (two threads a segment for 8 bf16
// heads, four for 8 f32 ones), two lanes' pieces held in registers a
// round. Forward: the max, the sum of the exps, the write; backward: the
// sum of p * g, the write; the two threads' partial maxes and sums met by
// a shuffle, in a fixed order. A segment of at most four lanes is read
// once; a longer one is read again each walk, from the cache. A segment
// of more than kLong lanes (a hub) is cut into chunks of kLong lanes, a
// group a chunk: each chunk's (m_c, d_c = sum of exp(x - m_c)) or sum of
// p * g goes to a scratch row, a block a hub combines them in chunk order
// (d = sum of d_c exp(m_c - m)), and the chunks write their lanes. The
// lanes a call drops get +0 rows from blocks of their own.
#include <algorithm>
#include <cfloat>

#include "segment_keys.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kU = 2;  // lanes a thread holds a round

// A group's view of a segment's rows of P pieces: G = Pp L threads, Pp
// the least power of two >= P (at most 32) and L = min(2, 32 / Pp) lanes
// at a time; thread (sub, pc) of the group takes the lanes i with i % L
// == sub and the pieces pc, pc + Pp, ...; mask: the group's threads.
struct Grp {
  int P, Pp, L, G, sub, pc;
  unsigned mask;
  __device__ explicit Grp(int pieces) {
    P = pieces;
    Pp = lt_pow2_32(pieces);
    L = min(2, 32 / Pp);
    G = Pp * L;
    const int t = threadIdx.x & 31, gt = t % G;
    sub = gt / Pp;
    pc = gt % Pp;
    mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (t - gt);
  }
  __device__ int blocks() const { return (P + Pp - 1) / Pp; }
};

// The group's work on piece c over lanes[a, a + n) (n <= kLong). With
// `stats`, forward: m = max(0, the lanes' max) (their keys' max, floored
// at +0's) and d = the sum of expf(x - m); backward: d = the sum of p * g
// (x is p, y is g). A thread sums its lanes in lane order, the group's
// threads then by a fixed tree of shuffles, so every thread holds the
// same bits from run to run. With `write`, the lanes' p = expf(x - m) /
// max(d, tiny), or dx = p * (g - d). A thread holds kU lanes' pieces a
// round; a segment of at most L kU lanes is read once.
template <int TYPE, int VEC, bool BWD>
__device__ __forceinline__ void soft_lanes(
    const typename SegT<TYPE>::T* __restrict__ x,
    const typename SegT<TYPE>::T* __restrict__ y,
    const int32_t* __restrict__ lanes, int a, int n, int64_t H,
    const Grp& grp, int c, bool stats, bool write, float* m, float* d,
    typename SegT<TYPE>::T* __restrict__ out) {
  using T = typename SegT<TYPE>::T;
  const bool live = c < grp.P;
  const int step = grp.L * kU;
  uint32_t xv[kU][VEC], yv[kU][BWD ? VEC : 1];
  int64_t e[kU];
  int held = -1;  // the round xv holds
  auto load = [&](int i0) {
    if (held == i0) return;
    held = i0;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * grp.L + grp.sub;
      e[u] = i < n && live ? __ldg(lanes + a + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (e[u] < 0) continue;
      lt_load_piece<T, VEC>(x + e[u] * H + (int64_t)c * VEC, xv[u]);
      if constexpr (BWD)
        lt_load_piece<T, VEC>(y + e[u] * H + (int64_t)c * VEC, yv[u]);
    }
  };
  if (stats) {
    if constexpr (!BWD) {
      uint32_t km[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) km[k] = kKeyPosZero;
      for (int i0 = 0; i0 < n; i0 += step) {
        load(i0);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (e[u] < 0) continue;
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            km[k] = max(km[k], SegT<TYPE>::key(xv[u][k]));
        }
      }
      for (int o = grp.Pp; o < grp.G; o <<= 1) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          km[k] = max(km[k], __shfl_xor_sync(grp.mask, km[k], o));
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        m[k] = __uint_as_float(lt_f32_unkey(km[k]));
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) d[k] = 0.0f;
    for (int i0 = 0; i0 < n; i0 += step) {
      load(i0);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (e[u] < 0) continue;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          d[k] = __fadd_rn(
              d[k], BWD ? __fmul_rn(SegT<TYPE>::val(xv[u][k]),
                                    SegT<TYPE>::val(yv[u][BWD ? k : 0]))
                        : expf(__fsub_rn(SegT<TYPE>::val(xv[u][k]), m[k])));
      }
    }
    for (int o = grp.Pp; o < grp.G; o <<= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        d[k] = __fadd_rn(d[k], __shfl_xor_sync(grp.mask, d[k], o));
    }
  }
  if (!write) return;
  float dd[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    dd[k] = BWD ? d[k] : __frcp_rn(!(d[k] < FLT_MIN) ? d[k] : FLT_MIN);
  for (int i0 = 0; i0 < n; i0 += step) {
    load(i0);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (e[u] < 0) continue;
      uint32_t w[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = SegT<TYPE>::val(xv[u][k]);
        w[k] = SegT<TYPE>::store(
            BWD ? __fmul_rn(v, __fsub_rn(SegT<TYPE>::val(yv[u][BWD ? k : 0]),
                                         dd[k]))
                : __fmul_rn(expf(__fsub_rn(v, m[k])), dd[k]));
      }
      lt_store_piece<T, VEC>(out + e[u] * H + (int64_t)c * VEC, w);
    }
  }
}

// Forward (BWD false) or backward, one launch: blocks [0, chunk_blocks) a
// group a chunk of a long run, its (m_c, d_c) (2 H floats) or its sum of
// p * g (H floats) into part; then warps that zero the dropped lanes' rows
// of the output; then a group a segment of at most kLong lanes, written.
// x is the scores (forward) or p (backward), y null or g.
template <int TYPE, int VEC, bool BWD>
__global__ void __launch_bounds__(kThreads) softmax_kernel(
    const typename SegT<TYPE>::T* __restrict__ x,
    const typename SegT<TYPE>::T* __restrict__ y,
    const int32_t* __restrict__ seg, LtLaneGroups g, int64_t E, int32_t S,
    int64_t H, float* __restrict__ part, LtSegGrid lay,
    typename SegT<TYPE>::T* __restrict__ out) {
  using T = typename SegT<TYPE>::T;
  const Grp grp((int)(H / VEC));
  const int per = kThreads / grp.G;  // groups a block
  const int gi = threadIdx.x / grp.G;
  int b0 = blockIdx.x;
  float m[VEC], d[VEC];
  if (b0 < lay.chunk_blocks) {
    const int n_chunks = g.counters[1];
    for (int q = b0 * per + gi; q < n_chunks; q += lay.chunk_blocks * per) {
      int a, n;
      lt_chunk(g, q, &a, &n);
      for (int b = 0; b < grp.blocks(); ++b) {
        const int c = b * grp.Pp + grp.pc;
        soft_lanes<TYPE, VEC, BWD>(x, y, g.lanes, a, n, H, grp, c, true,
                                   false, m, d, out);
        if (grp.sub != 0 || c >= grp.P) continue;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const int64_t col = (int64_t)c * VEC + k;
          if constexpr (BWD) {
            part[(int64_t)q * H + col] = d[k];
          } else {
            part[2 * (int64_t)q * H + col] = m[k];
            part[(2 * (int64_t)q + 1) * H + col] = d[k];
          }
        }
      }
    }
    return;
  }
  b0 -= lay.chunk_blocks;
  if (b0 < lay.zero_blocks) {
    lt_zero_dropped<T, VEC>(seg, E, S, grp.P, H, out,
                            (int64_t)b0 * kWarps + (threadIdx.x >> 5),
                            (int64_t)lay.zero_blocks * kWarps);
    return;
  }
  b0 -= lay.zero_blocks;
  for (int64_t r = (int64_t)b0 * per + gi; r < S;
       r += (int64_t)lay.row_blocks * per) {
    const int n = g.cnt[r];
    if (n == 0 || n > kLong) continue;  // no lane; a long run's chunks
    const int a = g.start[r];
    for (int b = 0; b < grp.blocks(); ++b)
      soft_lanes<TYPE, VEC, BWD>(x, y, g.lanes, a, n, H, grp,
                                 b * grp.Pp + grp.pc, true, true, m, d, out);
  }
}

// Kahan's compensated sum: acc += v, the lost low part kept in comp.
__device__ __forceinline__ void kahan(float v, float* acc, float* comp) {
  const float yk = __fsub_rn(v, *comp);
  const float t = __fadd_rn(*acc, yk);
  *comp = __fsub_rn(__fsub_rn(t, *acc), yk);
  *acc = t;
}

// A block a long run: warp w takes chunks [w k / 8, (w + 1) k / 8) of the
// run's k, a column a thread, then warp 0 the warps' results in warp
// order, over the run's first chunk's row(s) of part. Forward: m = the
// max of the chunks' m_c, then d = the sum of d_c expf(m_c - m);
// backward: the sum of the chunks' sums. Sums are compensated (Kahan): a
// hub of 2^20 lanes keeps its f32 sum to a few ulps.
template <bool BWD>
__global__ void __launch_bounds__(kThreads) softmax_combine_kernel(
    LtLaneGroups g, int64_t H, float* __restrict__ part) {
  __shared__ float sh[kWarps][32];
  __shared__ uint32_t kh[kWarps][32];
  const int t = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_long = g.counters[0];
  const int64_t rows = BWD ? 1 : 2;  // rows of part a chunk
  for (int li = blockIdx.x; li < n_long; li += gridDim.x) {
    const int4 run = g.longs[li];
    const int k = (run.w + kLong - 1) / kLong;
    const int i0 = wid * k / kWarps, i1 = (wid + 1) * k / kWarps;
    for (int64_t c0 = 0; c0 < H; c0 += 32) {
      const int64_t c = c0 + t;
      const bool live = c < H;
      float mx = 0.0f;
      if (!BWD) {
        uint32_t km = 0u;
        for (int i = i0; i < i1 && live; ++i)
          km = max(km, lt_f32_key(__float_as_uint(
                           part[rows * (run.y + i) * H + c])));
        kh[wid][t] = km;
        __syncthreads();
        for (int w = 0; w < kWarps; ++w) km = max(km, kh[w][t]);
        mx = __uint_as_float(lt_f32_unkey(km));
      }
      float acc = 0.0f, comp = 0.0f;
      for (int i = i0; i < i1 && live; ++i) {
        const int64_t row = rows * (run.y + i);
        kahan(BWD ? part[row * H + c]
                  : __fmul_rn(part[(row + 1) * H + c],
                              expf(__fsub_rn(part[row * H + c], mx))),
              &acc, &comp);
      }
      sh[wid][t] = __fsub_rn(acc, comp);
      __syncthreads();
      if (wid == 0 && live) {
        float tot = 0.0f, tc = 0.0f;
        for (int w = 0; w < kWarps; ++w) kahan(sh[w][t], &tot, &tc);
        tot = __fsub_rn(tot, tc);
        const int64_t row = rows * run.y;
        if (BWD) {
          part[row * H + c] = tot;
        } else {
          part[row * H + c] = mx;
          part[(row + 1) * H + c] = tot;
        }
      }
      __syncthreads();
    }
  }
}

// The long runs' lanes: a group a chunk, written from the run's combined
// (m, d) or sum over its first chunk's row(s) of part.
template <int TYPE, int VEC, bool BWD>
__global__ void __launch_bounds__(kThreads) softmax_long_kernel(
    const typename SegT<TYPE>::T* __restrict__ x,
    const typename SegT<TYPE>::T* __restrict__ y, LtLaneGroups g, int64_t H,
    const float* __restrict__ part, typename SegT<TYPE>::T* __restrict__ out) {
  const Grp grp((int)(H / VEC));
  const int per = kThreads / grp.G;
  const int n_chunks = g.counters[1];
  const int64_t rows = BWD ? 1 : 2;
  float m[VEC] = {}, d[VEC] = {};
  for (int q = blockIdx.x * per + threadIdx.x / grp.G; q < n_chunks;
       q += gridDim.x * per) {
    int a, n;
    const int4 run = lt_chunk(g, q, &a, &n);
    for (int b = 0; b < grp.blocks(); ++b) {
      const int c = b * grp.Pp + grp.pc;
      if (c < grp.P) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const int64_t col = (int64_t)c * VEC + k;
          if (BWD) {
            d[k] = part[rows * run.y * H + col];
          } else {
            m[k] = part[rows * run.y * H + col];
            d[k] = part[(rows * run.y + 1) * H + col];
          }
        }
      }
      soft_lanes<TYPE, VEC, BWD>(x, y, g.lanes, a, n, H, grp, c, false, true,
                                 m, d, out);
    }
  }
}

template <int TYPE, int VEC, bool BWD>
int launch(const void* x, const void* y, const int32_t* seg, LtLaneGroups g,
           int64_t E, int64_t H, int64_t S, float* part, void* out,
           cudaStream_t st) {
  using T = typename SegT<TYPE>::T;
  const int Pp = lt_pow2_32((int)(H / VEC));
  const LtSegGrid lay = lt_seg_grid(E, S, Pp * std::min(2, 32 / Pp), true);
  const T *xp = static_cast<const T*>(x), *yp = static_cast<const T*>(y);
  T* op = static_cast<T*>(out);
  softmax_kernel<TYPE, VEC, BWD><<<lay.total(), kThreads, 0, st>>>(
      xp, yp, seg, g, E, (int32_t)S, H, part, lay, op);
  softmax_combine_kernel<BWD><<<lt_seg_long_blocks(E), kThreads, 0, st>>>(
      g, H, part);
  softmax_long_kernel<TYPE, VEC, BWD>
      <<<(unsigned)lay.chunk_blocks, kThreads, 0, st>>>(xp, yp, g, H, part,
                                                        op);
  return (int)cudaGetLastError();
}

template <int TYPE, bool BWD>
int launch(const void* x, const void* y, const int32_t* seg, LtLaneGroups g,
           int64_t E, int64_t H, int64_t S, float* part, void* out,
           cudaStream_t st) {
  return lt_seg_wide<TYPE>(H, {x, y, out})
             ? launch<TYPE, kSegVec<TYPE>, BWD>(x, y, seg, g, E, H, S, part,
                                                 out, st)
              : launch<TYPE, 1, BWD>(x, y, seg, g, E, H, S, part, out, st);
}

bool bad_shape(int64_t E, int64_t H, int64_t S) {
  return E < 0 || H < 0 || S < 0 || E >= 2147483647LL ||
         H > 2147483647LL || S >= 2147483647LL - 3;
}

// x, y (null in the forward) and out [E, H] of ``type``; the forward
// builds the grouping first (with tmp), the backward reads the forward's.
int softmax(const void* x, const void* y, int type, const int32_t* seg,
            int64_t E, int64_t H, int64_t S, int32_t* groups, int32_t* tmp,
            float* part, void* out, void* stream) {
  if (bad_shape(E, H, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool bwd = y != nullptr;
  if (!bwd) {
    const int rc = lt_group_segments(seg, E, S, groups, tmp, true, st);
    if (rc != 0) return rc;
  }
  if (E * H == 0) return (int)cudaGetLastError();
  const LtLaneGroups g = lt_lane_groups(groups, S, E);
  switch (type) {
    case kSegF32:
      return bwd ? launch<kSegF32, true>(x, y, seg, g, E, H, S, part, out, st)
                 : launch<kSegF32, false>(x, y, seg, g, E, H, S, part, out,
                                          st);
    case kSegBF16:
      return bwd ? launch<kSegBF16, true>(x, y, seg, g, E, H, S, part, out,
                                          st)
                 : launch<kSegBF16, false>(x, y, seg, g, E, H, S, part, out,
                                           st);
    case kSegF16:
      return bwd ? launch<kSegF16, true>(x, y, seg, g, E, H, S, part, out, st)
                 : launch<kSegF16, false>(x, y, seg, g, E, H, S, part, out,
                                          st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x and p [E, H] of ``type`` (f32, bf16 or f16), seg [E] int32. groups: where
// the call writes seg's grouping (lt_segment_groups_words(S, E, 0) int32
// words), built with tmp (lt_segment_groups_words(S, E, 1) words); part:
// lt_segment_part_words(E, 2 H) words.
LT_EXPORT int lt_segment_softmax_fwd(const void* x, int type,
                                     const int32_t* seg, int64_t E, int64_t H,
                                     int64_t S, int32_t* groups, int32_t* tmp,
                                     float* part, void* p, void* stream) {
  return softmax(x, nullptr, type, seg, E, H, S, groups, tmp, part, p,
                 stream);
}

// p, g and dx [E, H] of ``type`` (f32, bf16 or f16), seg [E] int32; groups the
// grouping that the forward wrote; part: lt_segment_part_words(E, H) words.
LT_EXPORT int lt_segment_softmax_bwd(const void* p, const void* g, int type,
                                     const int32_t* seg, int64_t E, int64_t H,
                                     int64_t S, int32_t* groups, float* part,
                                     void* dx, void* stream) {
  if (g == nullptr) return (int)cudaErrorInvalidValue;
  return softmax(p, g, type, seg, E, H, S, groups, nullptr, part, dx,
                 stream);
}
