// K18 segment_softmax: p[e, h] = exp(x[e, h] - m[s, h]) / max(d[s, h],
// tiny) over the lanes e of segment s = seg[e], with m[s, h] = max(0, max
// of x[e, h] in s) and d[s, h] the sum of the lanes' exp; lanes with
// seg[e] < 0 or >= S give 0. And its backward, dx = p * (g - sum over the
// segment of p * g). x is [E, H] f32 or bf16, p the same.
//
// Replaces legion_tpu/ops/segment.py::segment_softmax (:67-80), XLA (a
// scatter-max, a scatter-add and two gathers), and its gradient under
// jax.grad. On no path of the JAX package or of the port (GAT's softmax is
// K6 and K7): the port's ops package carries it because the JAX
// package's does.
//
// Forward, one C call: memsets of the [S, H] max keys and f32
// denominators; K17's key pass (segment_keys.cuh), which maxes each valid
// lane's order-preserving key into its segment's row; a pass that adds
// e = expf(x - m) (in f32, m the key decoded after a max with +0's key)
// into the denominator by f32 atomics; a pass that computes e again and
// writes e / max(d, tiny) (tiny = FLT_MIN, bf16's too; a NaN d stays NaN)
// in x's type. Backward, one C call: a memset of an [S, H] f32 sum, a
// pass that adds p * g into it by atomics, a pass that writes p * (g -
// sum), all in f32, rounded once to x's type.
//
// The f32 atomics sum in another order at every run, as K2's do: the
// plain version (ops/segment.py::segment_softmax_plain) agrees within rtol
// 1e-5 in f32 and one bf16 ulp in bf16. JAX computes a bf16 softmax in
// bf16, rounding after each op; this kernel rounds once (ROADMAP C).
//
// Bound on this card: device-memory bytes (forward: x and ids read, p
// written; backward: p, g and ids read, dx written); the passes read x
// twice (three times with the max) and the atomics resolve in the L2. A
// thread takes one element of a lane, the threads of a lane neighbours.
// A simple kernel: the op runs on no path.
#include <cfloat>

#include "segment_keys.cuh"

namespace {

__device__ __forceinline__ float shift(const uint32_t* __restrict__ mkeys,
                                       int64_t o) {
  return __uint_as_float(lt_f32_unkey(max(mkeys[o], kKeyPosZero)));
}

template <int TYPE>
__global__ void __launch_bounds__(kThreads)
    softmax_denom_kernel(const typename SegT<TYPE>::T* __restrict__ x,
                         const int32_t* __restrict__ seg,
                         const uint32_t* __restrict__ mkeys,
                         float* __restrict__ denom, int64_t E, int H,
                         int64_t S, int tshift) {
  const int c0 = threadIdx.x & ((1 << tshift) - 1);
  const int64_t lpb = kThreads >> tshift;
  for (int64_t e = blockIdx.x * lpb + (threadIdx.x >> tshift); e < E;
       e += gridDim.x * lpb) {
    const int32_t s = seg[e];
    if (s < 0 || s >= S) continue;
    for (int c = c0; c < H; c += 1 << tshift) {
      const int64_t o = (int64_t)s * H + c;
      atomicAdd(denom + o,
                expf(__fsub_rn(SegT<TYPE>::val(x[e * H + c]),
                               shift(mkeys, o))));
    }
  }
}

template <int TYPE>
__global__ void __launch_bounds__(kThreads)
    softmax_out_kernel(const typename SegT<TYPE>::T* __restrict__ x,
                       const int32_t* __restrict__ seg,
                       const uint32_t* __restrict__ mkeys,
                       const float* __restrict__ denom,
                       typename SegT<TYPE>::T* __restrict__ p, int64_t E,
                       int H, int64_t S, int tshift) {
  const int c0 = threadIdx.x & ((1 << tshift) - 1);
  const int64_t lpb = kThreads >> tshift;
  for (int64_t e = blockIdx.x * lpb + (threadIdx.x >> tshift); e < E;
       e += gridDim.x * lpb) {
    const int32_t s = seg[e];
    const bool valid = s >= 0 && s < S;
    for (int c = c0; c < H; c += 1 << tshift) {
      float r = 0.0f;
      if (valid) {
        const int64_t o = (int64_t)s * H + c;
        const float ex = expf(__fsub_rn(SegT<TYPE>::val(x[e * H + c]),
                                        shift(mkeys, o)));
        const float d = denom[o];
        r = __fdiv_rn(ex, d < FLT_MIN ? FLT_MIN : d);
      }
      p[e * H + c] = SegT<TYPE>::store(r);
    }
  }
}

template <int TYPE>
__global__ void __launch_bounds__(kThreads)
    softmax_pg_kernel(const typename SegT<TYPE>::T* __restrict__ p,
                      const typename SegT<TYPE>::T* __restrict__ g,
                      const int32_t* __restrict__ seg,
                      float* __restrict__ sum, int64_t E, int H, int64_t S,
                      int tshift) {
  const int c0 = threadIdx.x & ((1 << tshift) - 1);
  const int64_t lpb = kThreads >> tshift;
  for (int64_t e = blockIdx.x * lpb + (threadIdx.x >> tshift); e < E;
       e += gridDim.x * lpb) {
    const int32_t s = seg[e];
    if (s < 0 || s >= S) continue;
    for (int c = c0; c < H; c += 1 << tshift)
      atomicAdd(sum + (int64_t)s * H + c,
                __fmul_rn(SegT<TYPE>::val(p[e * H + c]),
                          SegT<TYPE>::val(g[e * H + c])));
  }
}

template <int TYPE>
__global__ void __launch_bounds__(kThreads)
    softmax_grad_kernel(const typename SegT<TYPE>::T* __restrict__ p,
                        const typename SegT<TYPE>::T* __restrict__ g,
                        const int32_t* __restrict__ seg,
                        const float* __restrict__ sum,
                        typename SegT<TYPE>::T* __restrict__ dx, int64_t E,
                        int H, int64_t S, int tshift) {
  const int c0 = threadIdx.x & ((1 << tshift) - 1);
  const int64_t lpb = kThreads >> tshift;
  for (int64_t e = blockIdx.x * lpb + (threadIdx.x >> tshift); e < E;
       e += gridDim.x * lpb) {
    const int32_t s = seg[e];
    const bool valid = s >= 0 && s < S;
    for (int c = c0; c < H; c += 1 << tshift) {
      const int64_t i = e * H + c;
      float r = 0.0f;
      if (valid)
        r = __fmul_rn(SegT<TYPE>::val(p[i]),
                      __fsub_rn(SegT<TYPE>::val(g[i]),
                                sum[(int64_t)s * H + c]));
      dx[i] = SegT<TYPE>::store(r);
    }
  }
}

template <int TYPE>
int forward(const void* xv, const int32_t* seg, int64_t E, int64_t H,
            int64_t S, uint32_t* mkeys, float* denom, void* pv,
            cudaStream_t stream) {
  using T = typename SegT<TYPE>::T;
  const T* x = static_cast<const T*>(xv);
  const int tshift = lt_seg_tshift(H);
  const unsigned grid = lt_grid(E << tshift);
  int rc = lt_segment_keys(xv, TYPE, seg, E, H, S, mkeys, stream);
  if (rc == 0)
    rc = (int)cudaMemsetAsync(denom, 0, S * H * sizeof(float), stream);
  if (rc != 0) return rc;
  softmax_denom_kernel<TYPE><<<grid, kThreads, 0, stream>>>(
      x, seg, mkeys, denom, E, (int)H, S, tshift);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  softmax_out_kernel<TYPE><<<grid, kThreads, 0, stream>>>(
      x, seg, mkeys, denom, static_cast<T*>(pv), E, (int)H, S, tshift);
  return (int)cudaGetLastError();
}

template <int TYPE>
int backward(const void* pv, const void* gv, const int32_t* seg, int64_t E,
             int64_t H, int64_t S, float* sum, void* dxv,
             cudaStream_t stream) {
  using T = typename SegT<TYPE>::T;
  const T* p = static_cast<const T*>(pv);
  const T* g = static_cast<const T*>(gv);
  const int tshift = lt_seg_tshift(H);
  const unsigned grid = lt_grid(E << tshift);
  int rc = (int)cudaMemsetAsync(sum, 0, S * H * sizeof(float), stream);
  if (rc != 0) return rc;
  softmax_pg_kernel<TYPE><<<grid, kThreads, 0, stream>>>(p, g, seg, sum, E,
                                                         (int)H, S, tshift);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  softmax_grad_kernel<TYPE><<<grid, kThreads, 0, stream>>>(
      p, g, seg, sum, static_cast<T*>(dxv), E, (int)H, S, tshift);
  return (int)cudaGetLastError();
}

bool bad_shape(int64_t E, int64_t H, int64_t S) {
  return E < 0 || H < 0 || S < 0 || H > 2147483647LL || S > 2147483647LL;
}

}  // namespace

// x and p [E, H] of ``type`` (f32 or bf16), seg [E] int32; mkeys an
// [S, H] uint32 scratch, denom an [S, H] f32 scratch.
LT_EXPORT int lt_segment_softmax_fwd(const void* x, int type,
                                     const int32_t* seg, int64_t E, int64_t H,
                                     int64_t S, uint32_t* mkeys, float* denom,
                                     void* p, void* stream) {
  if (bad_shape(E, H, S)) return (int)cudaErrorInvalidValue;
  if (E * H == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (type) {
    case kSegF32:
      return forward<kSegF32>(x, seg, E, H, S, mkeys, denom, p, st);
    case kSegBF16:
      return forward<kSegBF16>(x, seg, E, H, S, mkeys, denom, p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// p, g and dx [E, H] of ``type`` (f32 or bf16), seg [E] int32; sum an
// [S, H] f32 scratch.
LT_EXPORT int lt_segment_softmax_bwd(const void* p, const void* g, int type,
                                     const int32_t* seg, int64_t E, int64_t H,
                                     int64_t S, float* sum, void* dx,
                                     void* stream) {
  if (bad_shape(E, H, S)) return (int)cudaErrorInvalidValue;
  if (E * H == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (type) {
    case kSegF32:
      return backward<kSegF32>(p, g, seg, E, H, S, sum, dx, st);
    case kSegBF16:
      return backward<kSegBF16>(p, g, seg, E, H, S, sum, dx, st);
  }
  return (int)cudaErrorInvalidValue;
}
