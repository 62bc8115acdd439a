// K17 segment_max: out[s, f] = max(initial, max of data[e, f] over the
// lanes e with seg[e] == s), and its gradient; lanes with seg[e] < 0 or
// >= S are dropped. data is [E, F] f32, bf16, f16 or int32 (the backward
// f32, bf16 or f16), out [S, F] of the same type.
//
// Replaces legion_tpu/ops/segment.py::masked_segment_max (:54-64), an XLA
// scatter-max, and its gradient under jax.grad, XLA's scatter-max JVP
// (jax/_src/lax/slicing.py::_scatter_extremal_jvp) transposed. On no path
// of the JAX package or of the port: the port's ops package carries it
// because the JAX package's does.
//
// The max is the integer max of order-preserving keys (segment_keys.cuh:
// every NaN is the top key, -0 ranks below +0), written back in data's
// type after a max with initial's key: bit for bit against ops/segment.py::
// segment_max_plain, a NaN's bits (the canonical NaN) and a zero's sign
// included. The backward is JAX's rule: the gradient of out[s, f] is split
// equally among the lanes equal to it (float equality: -0 == +0, a NaN
// equals nothing), and initial counts as one more such lane where it
// equals out[s, f]; each tied lane gets g[s, f] * (1 / n) (JAX's product,
// in f32; in bf16 or f16 n, 1 / n and the product each rounded to the
// type, as JAX computes them there), every other lane +0.
//
// Bound on this card: device-memory bytes (forward: the valid lanes' rows
// and the ids read, out written; backward: the valid rows, the ids, out
// and g read, dx written). Segment-major, with no atomic on a row: the
// forward groups the valid lanes by segment (lane_groups.cuh, each run in
// any order) and the backward reads that grouping (the autograd Function
// keeps it); then a warp takes a segment and each thread a 16-byte piece
// of the row (8 bf16 or 4 f32 columns; one element where the width or a
// base's alignment forbids it), 32 / pieces lanes of the segment at a
// time. Forward: the keys' max in registers, 3 such rounds
// of loads in flight, the row written once, the empty rows too (initial).
// Backward: out's and g's pieces read once a segment, the ties of each
// column counted in int32 in registers, then each lane's dx row written
// once, its row read again from the cache (one round in flight: fewer
// registers, more warps; measured faster than keeping each lane's tie
// bits). A segment of more than kLong lanes (a hub) is cut into chunks of
// kLong lanes, a warp a chunk: the chunks' keys (or tie counts) go to a
// scratch row each, a block a hub combines them, and (backward) the
// chunks write their lanes from the combined counts. The lanes a call
// drops get +0 rows by warps of their own, 32 lanes at a time.
#include "segment_keys.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
// rounds of loads in flight: the forward's, and the backward's (whose
// registers hold more per lane; fewer rounds, more warps, measured faster)
constexpr int kFwdU = 3;
constexpr int kBwdU = 1;

// A warp's view of a row of P pieces: the pieces [cb Pp, (cb + 1) Pp) are
// taken together, thread t piece cb Pp + t % Pp for the lanes i of the
// segment with i % L == t / Pp (L = 32 / Pp lanes at a time).
struct Geo {
  int P, Pp, L, sub, pc;
  __device__ explicit Geo(int pieces) {
    P = pieces;
    Pp = lt_pow2_32(pieces);
    L = 32 / Pp;
    sub = (threadIdx.x & 31) / Pp;
    pc = (threadIdx.x & 31) % Pp;
  }
  __device__ int blocks() const { return (P + Pp - 1) / Pp; }
};

// The max of the keys of piece c over lanes[a, a + n) (n <= kLong), in
// every thread of the warp (all 32 call it with the same a and n).
template <int TYPE, int VEC>
__device__ __forceinline__ void max_keys(
    const typename SegT<TYPE>::T* __restrict__ data,
    const int32_t* __restrict__ lanes, int a, int n, int64_t F, const Geo& geo,
    int c, uint32_t* km) {
  using T = typename SegT<TYPE>::T;
  const int t = threadIdx.x & 31;
  const bool live = c < geo.P;
  const int my = t < n ? __ldg(lanes + a + t) : 0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) km[k] = 0u;
  for (int i0 = 0; i0 < n; i0 += kFwdU * geo.L) {
    uint32_t v[kFwdU][VEC];
#pragma unroll
    for (int u = 0; u < kFwdU; ++u) {
      const int i = i0 + u * geo.L + geo.sub;
      const int64_t e = __shfl_sync(0xffffffffu, my, i & 31);
      if (i < n && live)
        lt_load_piece<T, VEC>(data + e * F + (int64_t)c * VEC, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kFwdU; ++u) {
      if (i0 + u * geo.L + geo.sub < n && live) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          km[k] = max(km[k], SegT<TYPE>::key(v[u][k]));
      }
    }
  }
#pragma unroll
  for (int o = geo.Pp; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      km[k] = max(km[k], __shfl_xor_sync(0xffffffffu, km[k], o));
  }
}

// Forward. Blocks [0, chunk_blocks): a warp a chunk of a long run, its
// keys into part (a row of F a chunk). The others: a warp a row of at
// most kLong lanes, written max(keys, initial's).
template <int TYPE, int VEC>
__global__ void __launch_bounds__(kThreads) segmax_fwd_kernel(
    const typename SegT<TYPE>::T* __restrict__ data, LtLaneGroups g,
    int32_t S, int64_t F, uint32_t init_key, uint32_t* __restrict__ part,
    int chunk_blocks, typename SegT<TYPE>::T* __restrict__ out) {
  using T = typename SegT<TYPE>::T;
  const Geo geo((int)(F / VEC));
  const int wid = threadIdx.x >> 5;
  uint32_t km[VEC];
  if ((int)blockIdx.x < chunk_blocks) {
    const int n_chunks = g.counters[1];
    for (int q = blockIdx.x * kWarps + wid; q < n_chunks;
         q += chunk_blocks * kWarps) {
      int a, n;
      lt_chunk(g, q, &a, &n);
      for (int b = 0; b < geo.blocks(); ++b) {
        const int c = b * geo.Pp + geo.pc;
        max_keys<TYPE, VEC>(data, g.lanes, a, n, F, geo, c, km);
        if (geo.sub == 0 && c < geo.P) {
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            part[(int64_t)q * F + (int64_t)c * VEC + k] = km[k];
        }
      }
    }
    return;
  }
  const int64_t nw = (int64_t)(gridDim.x - chunk_blocks) * kWarps;
  for (int64_t r = (int64_t)(blockIdx.x - chunk_blocks) * kWarps + wid;
       r < S; r += nw) {
    const int n = g.cnt[r];
    if (n > kLong) continue;  // a long run: combined below
    const int a = n > 0 ? g.start[r] : 0;
    for (int b = 0; b < geo.blocks(); ++b) {
      const int c = b * geo.Pp + geo.pc;
      max_keys<TYPE, VEC>(data, g.lanes, a, n, F, geo, c, km);
      if (geo.sub == 0 && c < geo.P) {
        uint32_t o[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          o[k] = SegT<TYPE>::unkey(max(km[k], init_key));
        lt_store_piece<T, VEC>(out + r * F + (int64_t)c * VEC, o);
      }
    }
  }
}

// A block a long run: warp w combines chunks [w m / 8, (w + 1) m / 8) of
// the run's m, column by column, then warp 0 the warps' results in warp
// order. MAX: keys by max, and out[row] written max(keys, initial's);
// else tie counts by sum, written over the run's first chunk's row.
template <int TYPE, bool MAX>
__global__ void __launch_bounds__(kThreads) segmax_combine_kernel(
    LtLaneGroups g, int64_t F, uint32_t init_key, uint32_t* __restrict__ part,
    typename SegT<TYPE>::T* __restrict__ out) {
  __shared__ uint32_t sh[kWarps][32];
  const int t = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_long = g.counters[0];
  for (int li = blockIdx.x; li < n_long; li += gridDim.x) {
    const int4 run = g.longs[li];
    const int m = (run.w + kLong - 1) / kLong;
    const int i0 = wid * m / kWarps, i1 = (wid + 1) * m / kWarps;
    for (int64_t c0 = 0; c0 < F; c0 += 32) {
      const int64_t c = c0 + t;
      uint32_t acc = 0u;
      if (c < F) {
        for (int i = i0; i < i1; ++i) {
          const uint32_t v = part[(int64_t)(run.y + i) * F + c];
          acc = MAX ? max(acc, v) : acc + v;
        }
      }
      sh[wid][t] = acc;
      __syncthreads();
      if (wid == 0 && c < F) {
        uint32_t tot = MAX ? init_key : 0u;
        for (int w = 0; w < kWarps; ++w)
          tot = MAX ? max(tot, sh[w][t]) : tot + sh[w][t];
        if constexpr (MAX)
          out[(int64_t)run.x * F + c] =
              (typename SegT<TYPE>::T)SegT<TYPE>::unkey(tot);
        else
          part[(int64_t)run.y * F + c] = tot;
      }
      __syncthreads();
    }
  }
}

// JAX's coefficient 1 / n of a tied lane, and g times it, in the type's
// arithmetic.
template <int TYPE>
__device__ __forceinline__ float tied_grad(float g, int n);

template <>
__device__ __forceinline__ float tied_grad<kSegF32>(float g, int n) {
  return __fmul_rn(g, __fdiv_rn(1.0f, (float)n));
}

template <>
__device__ __forceinline__ float tied_grad<kSegBF16>(float g, int n) {
  const float nb = SegT<kSegBF16>::val(lt_bf16_rn((float)n));
  const float r = SegT<kSegBF16>::val(lt_bf16_rn(__fdiv_rn(1.0f, nb)));
  return __fmul_rn(g, r);  // exact: two 8-bit significands
}

template <>
__device__ __forceinline__ float tied_grad<kSegF16>(float g, int n) {
  const float nh = SegT<kSegF16>::val(lt_f16_rn((float)n));
  const float r = SegT<kSegF16>::val(lt_f16_rn(__fdiv_rn(1.0f, nh)));
  return __fmul_rn(g, r);  // exact: two 11-bit significands
}

// Bit k: the piece's column k equals out's (float equality).
template <int TYPE, int VEC>
__device__ __forceinline__ uint32_t tie_bits(const uint32_t* v,
                                             const uint32_t* o) {
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    bits |= (uint32_t)(SegT<TYPE>::val(v[k]) == SegT<TYPE>::val(o[k])) << k;
  return bits;
}

// The ties of piece c (against out's piece o) over lanes[a, a + n) (n <=
// kLong), by the whole warp: tc[k] the column's count over the warp.
template <int TYPE, int VEC>
__device__ __forceinline__ void count_ties(
    const typename SegT<TYPE>::T* __restrict__ data, int my, int n,
    int64_t F, const Geo& geo, int c, const uint32_t* o, int* tc) {
  using T = typename SegT<TYPE>::T;
  const bool live = c < geo.P;
#pragma unroll
  for (int k = 0; k < VEC; ++k) tc[k] = 0;
  for (int i0 = 0; i0 < n; i0 += kBwdU * geo.L) {
    uint32_t v[kBwdU][VEC];
#pragma unroll
    for (int u = 0; u < kBwdU; ++u) {
      const int i = i0 + u * geo.L + geo.sub;
      const int64_t e = __shfl_sync(0xffffffffu, my, i & 31);
      if (i < n && live)
        lt_load_piece<T, VEC>(data + e * F + (int64_t)c * VEC, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kBwdU; ++u) {
      if (i0 + u * geo.L + geo.sub >= n || !live) continue;
      const uint32_t bits = tie_bits<TYPE, VEC>(v[u], o);
#pragma unroll
      for (int k = 0; k < VEC; ++k) tc[k] += (bits >> k) & 1u;
    }
  }
#pragma unroll
  for (int s = geo.Pp; s < 32; s <<= 1) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      tc[k] += __shfl_xor_sync(0xffffffffu, tc[k], s);
  }
}

// dx's piece c of lanes[a, a + n): coef[k] where the lane ties out's
// piece o in column k (its row read again, from the cache), +0 elsewhere.
template <int TYPE, int VEC>
__device__ __forceinline__ void write_grads(
    const typename SegT<TYPE>::T* __restrict__ data, int my, int n,
    int64_t F, const Geo& geo, int c, const uint32_t* o, const float* coef,
    typename SegT<TYPE>::T* __restrict__ dx) {
  using T = typename SegT<TYPE>::T;
  const bool live = c < geo.P;
  for (int i0 = 0; i0 < n; i0 += kBwdU * geo.L) {
    uint32_t v[kBwdU][VEC];
    int64_t e[kBwdU];
#pragma unroll
    for (int u = 0; u < kBwdU; ++u) {
      const int i = i0 + u * geo.L + geo.sub;
      e[u] = __shfl_sync(0xffffffffu, my, i & 31);
      if (i < n && live)
        lt_load_piece<T, VEC>(data + e[u] * F + (int64_t)c * VEC, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kBwdU; ++u) {
      if (i0 + u * geo.L + geo.sub >= n || !live) continue;
      const uint32_t bits = tie_bits<TYPE, VEC>(v[u], o);
      uint32_t w[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        w[k] = SegT<TYPE>::store((bits >> k) & 1u ? coef[k] : 0.0f);
      lt_store_piece<T, VEC>(dx + e[u] * F + (int64_t)c * VEC, w);
    }
  }
}

// JAX's coefficients of piece c: g * (1 / n), n the column's ties plus
// initial's where it equals out.
template <int TYPE, int VEC>
__device__ __forceinline__ void coefs(const uint32_t* o, const uint32_t* gv,
                                      const int* tc, float init,
                                      float* coef) {
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    coef[k] = tied_grad<TYPE>(
        SegT<TYPE>::val(gv[k]),
        tc[k] + (init == SegT<TYPE>::val(o[k]) ? 1 : 0));
}

// Backward. Blocks [0, lay.chunk_blocks): a warp a chunk of a long run,
// its tie counts into part; then warps that zero the dropped lanes' rows;
// then a warp a row of at most kLong lanes, counted and written.
template <int TYPE, int VEC>
__global__ void __launch_bounds__(kThreads) segmax_bwd_kernel(
    const typename SegT<TYPE>::T* __restrict__ data,
    const int32_t* __restrict__ seg,
    const typename SegT<TYPE>::T* __restrict__ out,
    const typename SegT<TYPE>::T* __restrict__ gr, float init,
    LtLaneGroups g, int64_t E, int32_t S, int64_t F,
    uint32_t* __restrict__ part, LtSegGrid lay,
    typename SegT<TYPE>::T* __restrict__ dx) {
  using T = typename SegT<TYPE>::T;
  const Geo geo((int)(F / VEC));
  const int t = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int b0 = blockIdx.x;
  uint32_t o[VEC] = {}, gv[VEC] = {};
  int tc[VEC];
  float coef[VEC];
  if (b0 < lay.chunk_blocks) {
    const int n_chunks = g.counters[1];
    for (int q = b0 * kWarps + wid; q < n_chunks;
         q += lay.chunk_blocks * kWarps) {
      int a, n;
      const int4 run = lt_chunk(g, q, &a, &n);
      const int my = t < n ? __ldg(g.lanes + a + t) : 0;
      for (int b = 0; b < geo.blocks(); ++b) {
        const int c = b * geo.Pp + geo.pc;
        if (c < geo.P)
          lt_load_piece<T, VEC>(out + run.x * F + (int64_t)c * VEC, o);
        count_ties<TYPE, VEC>(data, my, n, F, geo, c, o, tc);
        if (geo.sub == 0 && c < geo.P) {
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            part[(int64_t)q * F + (int64_t)c * VEC + k] = (uint32_t)tc[k];
        }
      }
    }
    return;
  }
  b0 -= lay.chunk_blocks;
  if (b0 < lay.zero_blocks) {
    lt_zero_dropped<T, VEC>(seg, E, S, geo.P, F, dx,
                            (int64_t)b0 * kWarps + wid,
                            (int64_t)lay.zero_blocks * kWarps);
    return;
  }
  b0 -= lay.zero_blocks;
  for (int64_t r = (int64_t)b0 * kWarps + wid; r < S;
       r += (int64_t)lay.row_blocks * kWarps) {
    const int n = g.cnt[r];
    if (n == 0 || n > kLong) continue;  // no lane; a long run's chunks
    const int a = g.start[r];
    const int my = t < n ? __ldg(g.lanes + a + t) : 0;
    for (int b = 0; b < geo.blocks(); ++b) {
      const int c = b * geo.Pp + geo.pc;
      if (c < geo.P) {
        lt_load_piece<T, VEC>(out + r * F + (int64_t)c * VEC, o);
        lt_load_piece<T, VEC>(gr + r * F + (int64_t)c * VEC, gv);
      }
      count_ties<TYPE, VEC>(data, my, n, F, geo, c, o, tc);
      coefs<TYPE, VEC>(o, gv, tc, init, coef);
      write_grads<TYPE, VEC>(data, my, n, F, geo, c, o, coef, dx);
    }
  }
}

// Backward of the long runs: a warp a chunk, written from the run's tie
// counts (the combine's, over the run's first chunk's row of part).
template <int TYPE, int VEC>
__global__ void __launch_bounds__(kThreads) segmax_bwd_long_kernel(
    const typename SegT<TYPE>::T* __restrict__ data,
    const typename SegT<TYPE>::T* __restrict__ out,
    const typename SegT<TYPE>::T* __restrict__ gr, float init,
    LtLaneGroups g, int64_t F, const uint32_t* __restrict__ part,
    typename SegT<TYPE>::T* __restrict__ dx) {
  using T = typename SegT<TYPE>::T;
  const Geo geo((int)(F / VEC));
  const int t = threadIdx.x & 31;
  const int n_chunks = g.counters[1];
  uint32_t o[VEC] = {}, gv[VEC] = {};
  int tc[VEC] = {};
  float coef[VEC] = {};
  for (int q = blockIdx.x * kWarps + (threadIdx.x >> 5); q < n_chunks;
       q += gridDim.x * kWarps) {
    int a, n;
    const int4 run = lt_chunk(g, q, &a, &n);
    const int my = t < n ? __ldg(g.lanes + a + t) : 0;
    for (int b = 0; b < geo.blocks(); ++b) {
      const int c = b * geo.Pp + geo.pc;
      if (c < geo.P) {
        lt_load_piece<T, VEC>(out + run.x * F + (int64_t)c * VEC, o);
        lt_load_piece<T, VEC>(gr + run.x * F + (int64_t)c * VEC, gv);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          tc[k] = (int)part[(int64_t)run.y * F + (int64_t)c * VEC + k];
        coefs<TYPE, VEC>(o, gv, tc, init, coef);
      }
      write_grads<TYPE, VEC>(data, my, n, F, geo, c, o, coef, dx);
    }
  }
}

template <int TYPE, int VEC>
int forward(const void* data, LtLaneGroups g, int64_t E, int64_t F,
            int64_t S, uint32_t init_key, uint32_t* part, void* out,
            cudaStream_t st) {
  using T = typename SegT<TYPE>::T;
  const LtSegGrid gr = lt_seg_grid(E, S, 32, false);
  segmax_fwd_kernel<TYPE, VEC><<<gr.total(), kThreads, 0, st>>>(
      static_cast<const T*>(data), g, (int32_t)S, F, init_key, part,
      gr.chunk_blocks, static_cast<T*>(out));
  segmax_combine_kernel<TYPE, true>
      <<<lt_seg_long_blocks(E), kThreads, 0, st>>>(g, F, init_key, part,
                                                   static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <int TYPE>
int forward(const void* data, LtLaneGroups g, int64_t E, int64_t F,
            int64_t S, uint32_t init_key, uint32_t* part, void* out,
            cudaStream_t st) {
  return lt_seg_wide<TYPE>(F, {data, out})
             ? forward<TYPE, kSegVec<TYPE>>(data, g, E, F, S, init_key, part,
                                            out, st)
             : forward<TYPE, 1>(data, g, E, F, S, init_key, part, out, st);
}

template <int TYPE, int VEC>
int backward(const void* data, const int32_t* seg, const void* out,
             const void* gv, float init, LtLaneGroups g, int64_t E,
             int64_t F, int64_t S, uint32_t* part, void* dx,
             cudaStream_t st) {
  using T = typename SegT<TYPE>::T;
  const LtSegGrid gr = lt_seg_grid(E, S, 32, true);
  const T *d = static_cast<const T*>(data), *o = static_cast<const T*>(out),
          *gp = static_cast<const T*>(gv);
  segmax_bwd_kernel<TYPE, VEC><<<gr.total(), kThreads, 0, st>>>(
      d, seg, o, gp, init, g, E, (int32_t)S, F, part, gr,
      static_cast<T*>(dx));
  segmax_combine_kernel<TYPE, false>
      <<<lt_seg_long_blocks(E), kThreads, 0, st>>>(g, F, 0u, part, nullptr);
  segmax_bwd_long_kernel<TYPE, VEC>
      <<<(unsigned)gr.chunk_blocks, kThreads, 0, st>>>(d, o, gp, init, g, F,
                                                       part,
                                                       static_cast<T*>(dx));
  return (int)cudaGetLastError();
}

template <int TYPE>
int backward(const void* data, const int32_t* seg, const void* out,
             const void* gv, float init, LtLaneGroups g, int64_t E,
             int64_t F, int64_t S, uint32_t* part, void* dx,
             cudaStream_t st) {
  return lt_seg_wide<TYPE>(F, {data, out, gv, dx})
             ? backward<TYPE, kSegVec<TYPE>>(data, seg, out, gv, init, g, E,
                                             F, S, part, dx, st)
             : backward<TYPE, 1>(data, seg, out, gv, init, g, E, F, S, part,
                                 dx, st);
}

bool bad_shape(int64_t E, int64_t F, int64_t S) {
  return E < 0 || F < 0 || S < 0 || E >= 2147483647LL ||
         F > 2147483647LL || S >= 2147483647LL - 3;
}

}  // namespace

// Words of scratch a call takes for the chunks of its long runs.
LT_EXPORT int64_t lt_segment_part_words(int64_t E, int64_t cols) {
  return lt_seg_part_words(E, cols);
}

// data [E, F] of ``type``, seg [E] int32, out [S, F] of ``type``;
// init_key the key of initial in data's type. groups: where the call
// writes seg's grouping (lt_segment_groups_words(S, E, 0) int32 words),
// built with tmp (lt_segment_groups_words(S, E, 1) words); part:
// lt_segment_part_words(E, F) words.
LT_EXPORT int lt_segment_max_fwd(const void* data, int type,
                                 const int32_t* seg, int64_t E, int64_t F,
                                 int64_t S, uint32_t init_key,
                                 int32_t* groups, int32_t* tmp,
                                 uint32_t* part, void* out, void* stream) {
  if (bad_shape(E, F, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = lt_group_segments(seg, E, S, groups, tmp, false, st);
  if (rc != 0) return rc;
  if (S * F == 0) return (int)cudaGetLastError();
  const LtLaneGroups g = lt_lane_groups(groups, S, E);
  switch (type) {
    case kSegF32:
      return forward<kSegF32>(data, g, E, F, S, init_key, part, out, st);
    case kSegBF16:
      return forward<kSegBF16>(data, g, E, F, S, init_key, part, out, st);
    case kSegI32:
      return forward<kSegI32>(data, g, E, F, S, init_key, part, out, st);
    case kSegF16:
      return forward<kSegF16>(data, g, E, F, S, init_key, part, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

// data [E, F], out and g [S, F], dx [E, F], all f32, bf16 or f16; init
// initial in data's type, widened; groups the grouping that the forward
// wrote; part as the forward's.
LT_EXPORT int lt_segment_max_bwd(const void* data, int type,
                                 const int32_t* seg, const void* out,
                                 const void* g, float init, int64_t E,
                                 int64_t F, int64_t S, int32_t* groups,
                                 uint32_t* part, void* dx, void* stream) {
  if (bad_shape(E, F, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (E * F == 0) return (int)cudaGetLastError();
  const LtLaneGroups lg = lt_lane_groups(groups, S, E);
  switch (type) {
    case kSegF32:
      return backward<kSegF32>(data, seg, out, g, init, lg, E, F, S, part,
                               dx, st);
    case kSegBF16:
      return backward<kSegBF16>(data, seg, out, g, init, lg, E, F, S, part,
                                dx, st);
    case kSegF16:
      return backward<kSegF16>(data, seg, out, g, init, lg, E, F, S, part,
                               dx, st);
  }
  return (int)cudaErrorInvalidValue;
}
