// K2 segment_sum: out[s] += data[e] for every e with seg[e] == s; lanes
// with seg[e] < 0 (or >= S) are dropped. out is [S, F] float32 and must be
// zeroed by the caller.
//
// Replaces legion_tpu/ops/pallas_segment.py::segment_sum_pallas, which
// keeps the whole [S, F] f32 accumulator in VMEM across a sequential grid.
// Hopper runs blocks in parallel and in no order, so nothing can carry a
// sum from one block to the next: each element is added with an f32
// atomicAdd into device memory. At the main path's size the accumulator
// ([~105k, 128] f32, ~54 MB) is about as large as the 50 MB L2, where the
// atomics resolve.
//
// Bound on this card: atomic throughput on duplicate-heavy segments
// (every dst row receives ~fanout lanes), then device-memory bytes.
// Design: one thread per (lane, column), so neighbouring threads add into
// neighbouring addresses of one row; a later PR can sort lanes by segment
// and reduce in registers first.
//
// Known divergence: JAX's transpose of a bf16 gather scatter-adds in bf16.
// This kernel sums bf16 data in f32 and the caller casts once at the end,
// which is the more precise of the two.
#include <cuda_bf16.h>

#include "common.cuh"

__device__ __forceinline__ float lt_to_float(float x) { return x; }
__device__ __forceinline__ float lt_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ data,
                                   const int32_t* __restrict__ seg,
                                   float* __restrict__ out, int64_t E,
                                   int64_t F, int64_t S) {
  const int64_t total = E * F;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t e = t / F;
    const int32_t s = seg[e];
    if (s >= 0 && s < S) {
      atomicAdd(out + (int64_t)s * F + (t - e * F), lt_to_float(data[t]));
    }
  }
}

template <typename T>
static int launch(const T* data, const int32_t* seg, float* out, int64_t E,
                  int64_t F, int64_t S, void* stream) {
  if (E == 0 || F == 0) return (int)cudaSuccess;
  segment_sum_kernel<T><<<lt_grid(E * F), kThreads, 0,
                          (cudaStream_t)stream>>>(data, seg, out, E, F, S);
  return (int)cudaGetLastError();
}

LT_EXPORT int lt_segment_sum_f32(const float* data, const int32_t* seg,
                                 float* out, int64_t E, int64_t F, int64_t S,
                                 void* stream) {
  return launch<float>(data, seg, out, E, F, S, stream);
}

LT_EXPORT int lt_segment_sum_bf16(const __nv_bfloat16* data,
                                  const int32_t* seg, float* out, int64_t E,
                                  int64_t F, int64_t S, void* stream) {
  return launch<__nv_bfloat16>(data, seg, out, E, F, S, stream);
}
