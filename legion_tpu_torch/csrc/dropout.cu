// K16 dropout_act: inverted dropout fused with the activation before it and
// the cast between them, y = drop(cast(act(x))), and its backward.
//
// Replaces legion_tpu/models/common.py::dropout (:71-99), which XLA fuses
// on the TPU into the elementwise work around it: GraphSAGE's ReLU, bf16
// cast and dropout (legion_tpu/models/graphsage.py:120-129), GCN's ReLU and
// dropout, GAT's ELU and cast before the next layer's feature dropout
// (legion_tpu/models/gat.py:209, :241-245).
//
// act is none, ReLU or ELU (alpha 1); x is f32 or bf16; y is x's dtype, or
// bf16 from f32 x. Lane e is the row-major element index (numel < 2^32).
// The keep bits come from the port's counter-based hash, keyed by
// (ka, kb) = lt_fold_in(words, layer), words the step's dropout key that
// K10 writes on the card (step_keys.cu), so no step-varying host word
// enters a launch and a replayed CUDA graph draws each step's masks; the
// regimes of the JAX package as dropout.cuh sets them out (regime 0, rate
// 0: the activation and the cast alone).
//
// ReLU's backward needs one bit a lane from the forward: "kept and not
// x <= 0" (so a NaN passes, as threshold_backward lets it; at rate 0 the
// bit is not x <= 0). Where x takes a gradient the ReLU forward writes
// these bits packed, bit j of byte b for lane 8b + j (ceil(n / 8) bytes),
// and the ReLU backward reads dy and that mask and writes dx: no x, no
// hash, no key words. ELU's backward needs x (expf(x) where a kept lane
// has x <= 0, bit for bit against elu_backward on x), and none's nothing;
// both draw the keep bits again from the key words and store no mask.
//
// Arithmetic: as PyTorch's ops take it on the card, so that the plain
// version (ops/dropout.py::dropout_act_plain: relu / elu, .to, where and
// divide under autograd) gives the same bits. In float, then rounded: the
// activation to x's dtype (ReLU: NaN kept, else fmaxf(a, 0), as clamp_min;
// ELU: a > 0 ? a : expm1f(a)), the cast to y's dtype, then a kept lane
// divided by c = keep rounded to y's dtype (times c = 256 / kq in regime
// 2), a dropped lane +0. Backward: a kept lane's dy divided by c (times c),
// a dropped lane 0, widened to x's dtype, then ReLU's passes ? g : +0, or
// ELU's x <= 0 ? g * expf(x) : g (PyTorch's elu_backward on its input),
// rounded to x's dtype. No -use_fast_math: '/' is IEEE round to nearest.
//
// Bound on this card: device-memory bytes (forward: x read, y and the
// mask written; ReLU backward: dy and the mask read, dx written; ELU
// backward: dy and x read, dx written). The hash costs about 20 integer
// operations a word, one word a lane only in regime 3, which takes small
// tensors.
//
// Design: a thread owns groups of 8 consecutive lanes, one mask byte each
// (one 16-byte vector of bf16, two of f32), with streaming loads and
// stores (__ldcs / __stcs: every byte is touched once). A block takes a
// tile of U * 256 whole groups, thread t groups t, t + 256, ..., so that
// a warp's loads and stores are contiguous and its 32 mask bytes are
// consecutive; the U groups' loads are issued before any is used. Tiles
// go grid-stride. Then, in a loop of its own, the group past the last
// whole vector, or every group where a base is not 16-byte aligned,
// takes the same arithmetic one lane at a time in the thread that owns
// its byte, so no two threads write one mask byte. U is fixed by the
// dtypes, the fastest queued on an NVIDIA H100 at the paths' shapes
// (PERF.md): 1 for a forward that writes bf16 (GraphSAGE, GAT), 2 for a
// forward from f32 to f32 (GCN, lp_sage) and for the ReLU backward. ELU's
// and none's backward keep the one-group-a-thread loop.
#include <cuda_bf16.h>

#include "dropout.cuh"

namespace {

enum : int { kActNone = 0, kActRelu = 1, kActElu = 2 };

// the keep bits of lanes e0 .. e0 + 7 (e0 % 8 == 0), bit j for lane e0 + j
__device__ __forceinline__ uint32_t keep_bits8(const Drop& d, uint32_t e0) {
  switch (d.regime) {
    case 1:
      return (lt_word(d.ka, d.kb, e0 >> 5) >> (e0 & 31u)) & 0xFFu;
    case 2: {
      uint32_t m = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w = lt_word(d.ka, d.kb, (e0 >> 2) + h);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          m |= (uint32_t)(((w >> (8 * b)) & 0xFFu) < d.kq) << (4 * h + b);
      }
      return m;
    }
    case 3: {
      uint32_t m = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        m |= (uint32_t)((float)(lt_word(d.ka, d.kb, e0 + j) >> 8) *
                            5.9604644775390625e-8f <
                        d.keep)
             << j;
      return m;
    }
    default:
      return 0xFFu;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename XT, typename YT>
__device__ __forceinline__ YT fwd_lane(XT xv, int act, bool kept,
                                       const Drop& d) {
  float a = to_f(xv);
  if (act == kActRelu)
    a = isnan(a) ? a : fmaxf(a, 0.0f);
  else if (act == kActElu)
    a = a > 0.0f ? a : expm1f(a);
  // the activation in x's dtype, then the cast
  const YT cy = from_f<YT>(to_f(from_f<XT>(a)));
  if (d.regime == 0) return cy;
  if (!kept) return from_f<YT>(0.0f);
  return d.regime == 2 ? from_f<YT>(to_f(cy) * d.c)
                       : from_f<YT>(to_f(cy) / d.c);
}

// dy's kept lane divided by c (times c in regime 2), rounded to y's dtype;
// a dropped lane 0
template <typename YT>
__device__ __forceinline__ float bwd_drop(YT dy, bool kept, int regime,
                                          float c) {
  if (regime == 0) return to_f(dy);
  if (!kept) return 0.0f;
  const float g = to_f(dy);
  return to_f(from_f<YT>(regime == 2 ? g * c : g / c));
}

// ELU's or no activation's backward; widened to x's dtype: exact
template <typename XT, typename YT>
__device__ __forceinline__ XT bwd_lane(YT dy, XT xv, int act, bool kept,
                                       const Drop& d) {
  const float g = bwd_drop(dy, kept, d.regime, d.c);
  if (act == kActNone) return from_f<XT>(g);
  const float x = to_f(xv);
  return from_f<XT>(x <= 0.0f ? g * expf(x) : g);
}

// ReLU's backward from the lane's passes bit (kept and not x <= 0)
template <typename XT, typename YT>
__device__ __forceinline__ XT relu_bwd_lane(YT dy, bool passes, int regime,
                                            float c) {
  return from_f<XT>(passes ? bwd_drop(dy, true, regime, c) : 0.0f);
}

// the passes bit of a lane: kept and not x <= 0 (a NaN passes)
template <typename XT>
__device__ __forceinline__ uint32_t pass_bit(XT xv, uint32_t kept) {
  return kept & (uint32_t)!(to_f(xv) <= 0.0f);
}

// 8 values of T from / to 16-byte aligned memory, streaming
template <typename T>
struct Vec8;
template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float v[8]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[8]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(v[4], v[5], v[6], v[7]));
  }
};
template <>
struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              __nv_bfloat16 v[8]) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __ushort_as_bfloat16((unsigned short)(w[i] & 0xFFFFu));
      v[2 * i + 1] = __ushort_as_bfloat16((unsigned short)(w[i] >> 16));
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const __nv_bfloat16 v[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(v[2 * i]) |
             ((uint32_t)__bfloat16_as_ushort(v[2 * i + 1]) << 16);
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// y = drop(cast(act(x))); with Mask (ReLU), the passes byte of each group
// of 8 lanes. Whole vectors go by tiles of U * 256 groups; the rest (the
// last, partial group, or every group off alignment) one group a thread,
// one lane at a time. Group indices fit 32 bits (n < 2^32 lanes). An SM
// holds 8 blocks at U = 1 (32 registers: more ran 7-21% slower on an
// NVIDIA H100) and 6 at U = 2.
template <typename XT, typename YT, int U, bool Mask>
__global__ void __launch_bounds__(kThreads, U == 1 ? 8 : 6)
    dropout_act_fwd_kernel(const XT* __restrict__ x, YT* __restrict__ y,
                           uint8_t* __restrict__ mask, int64_t n, bool vec,
                           const int32_t* __restrict__ words, uint32_t layer,
                           int act, int regime, uint32_t kq, float keep,
                           float c) {
  const Drop d = make_drop(words, layer, regime, kq, keep, c);
  const uint32_t whole = vec ? (uint32_t)(n / 8) : 0u;
  const uint32_t step = gridDim.x * U * kThreads;
  for (uint32_t base = blockIdx.x * U * kThreads + threadIdx.x;
       base < whole; base += step) {
    XT xv[U][8];
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (base + k * kThreads < whole)
        Vec8<XT>::load(x + (size_t)(base + k * kThreads) * 8, xv[k]);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const uint32_t g = base + k * kThreads;
      if (g >= whole) break;
      const uint32_t m = keep_bits8(d, g * 8u);
      YT yv[8];
      uint32_t pass = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t kept = (m >> j) & 1u;
        yv[j] = fwd_lane<XT, YT>(xv[k][j], act, kept, d);
        if (Mask) pass |= pass_bit(xv[k][j], kept) << j;
      }
      Vec8<YT>::store(y + (size_t)g * 8, yv);
      if (Mask) mask[g] = (uint8_t)pass;
    }
  }
  const uint32_t groups = (uint32_t)((n + 7) / 8);
  for (uint32_t g = whole + blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += gridDim.x * kThreads) {
    const uint32_t m = keep_bits8(d, g * 8u);
    const int lanes = n - (int64_t)g * 8 < 8 ? (int)(n - (int64_t)g * 8) : 8;
    uint32_t pass = 0;
    for (int j = 0; j < lanes; ++j) {
      const uint32_t kept = (m >> j) & 1u;
      const XT v = x[(size_t)g * 8 + j];
      y[(size_t)g * 8 + j] = fwd_lane<XT, YT>(v, act, kept, d);
      pass |= pass_bit(v, kept) << j;
    }
    if (Mask) mask[g] = (uint8_t)pass;
  }
}

// ReLU's backward: dx = passes ? widen(round_y(dy / c)) : +0 from dy and
// the forward's mask alone, tiled as the forward (in 64-bit indices: the
// 32-bit indices, at 40 registers, ran 3-5% slower on an NVIDIA H100)
template <typename XT, typename YT, int U>
__global__ void __launch_bounds__(kThreads)
    dropout_act_relu_bwd_kernel(const YT* __restrict__ dy,
                                const uint8_t* __restrict__ mask,
                                XT* __restrict__ dx, int64_t n, bool vec,
                                int regime, float c) {
  const int64_t whole = vec ? n / 8 : 0;
  const int64_t step = (int64_t)gridDim.x * U * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * U * kThreads + threadIdx.x;
       base < whole; base += step) {
    YT gv[U][8];
    uint32_t m[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t g = base + k * kThreads;
      if (g < whole) {
        m[k] = mask[g];
        Vec8<YT>::load(dy + g * 8, gv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t g = base + k * kThreads;
      if (g >= whole) break;
      XT dv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dv[j] = relu_bwd_lane<XT, YT>(gv[k][j], (m[k] >> j) & 1u, regime, c);
      Vec8<XT>::store(dx + g * 8, dv);
    }
  }
  const int64_t groups = (n + 7) / 8;
  for (int64_t g = whole + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += (int64_t)gridDim.x * kThreads) {
    const uint32_t m = mask[g];
    const int lanes = n - g * 8 < 8 ? (int)(n - g * 8) : 8;
    for (int j = 0; j < lanes; ++j)
      dx[g * 8 + j] = relu_bwd_lane<XT, YT>(dy[g * 8 + j], (m >> j) & 1u,
                                            regime, c);
  }
}

// ELU's and no activation's backward: the keep bits drawn again, x read
// for ELU
template <typename XT, typename YT>
__global__ void __launch_bounds__(kThreads)
    dropout_act_bwd_kernel(const YT* __restrict__ dy,
                           const XT* __restrict__ x, XT* __restrict__ dx,
                           int64_t n, bool vec,
                           const int32_t* __restrict__ words, uint32_t layer,
                           int act, int regime, uint32_t kq, float keep,
                           float c) {
  const Drop d = make_drop(words, layer, regime, kq, keep, c);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t chunks = vec ? n / 8 : 0;
  const XT zero = from_f<XT>(0.0f);
  for (int64_t ch = tid; ch < chunks; ch += stride) {
    const uint32_t e0 = (uint32_t)(ch * 8);
    YT gv[8];
    XT xv[8], dv[8];
    Vec8<YT>::load(dy + ch * 8, gv);
    if (act != kActNone) {
      Vec8<XT>::load(x + ch * 8, xv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[j] = zero;
    }
    const uint32_t m = keep_bits8(d, e0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dv[j] = bwd_lane<XT, YT>(gv[j], xv[j], act, (m >> j) & 1u, d);
    Vec8<XT>::store(dx + ch * 8, dv);
  }
  for (int64_t e = chunks * 8 + tid; e < n; e += stride)
    dx[e] = bwd_lane<XT, YT>(dy[e], act != kActNone ? x[e] : zero, act,
                             keep_lane(d, (uint32_t)e), d);
}

bool aligned16(const void* p) {
  return p == nullptr || (uintptr_t)p % 16 == 0;
}

bool bad_args(int64_t n, int act, int regime) {
  return n < 0 || n > (int64_t)0xFFFFFFFFll || act < kActNone ||
         act > kActElu || regime < 0 || regime > 3;
}

// U groups a thread a tile: 1 into bf16, 2 from f32 to f32
template <typename XT, typename YT>
void launch_fwd(const void* x, void* y, uint8_t* mask, int64_t n, bool vec,
                const int32_t* words, uint32_t layer, int act, int regime,
                uint32_t kq, float keep, float c, cudaStream_t s) {
  constexpr int U = sizeof(YT) == 2 ? 1 : 2;
  const auto k = mask != nullptr ? dropout_act_fwd_kernel<XT, YT, U, true>
                                 : dropout_act_fwd_kernel<XT, YT, U, false>;
  k<<<lt_grid(((n + 7) / 8 + U - 1) / U), kThreads, 0, s>>>(
      (const XT*)x, (YT*)y, mask, n, vec, words, layer, act, regime, kq,
      keep, c);
}

template <typename XT, typename YT>
void launch_relu_bwd(const void* dy, const uint8_t* mask, void* dx,
                     int64_t n, bool vec, int regime, float c,
                     cudaStream_t s) {
  constexpr int U = 2;
  dropout_act_relu_bwd_kernel<XT, YT, U>
      <<<lt_grid(((n + 7) / 8 + U - 1) / U), kThreads, 0, s>>>(
          (const YT*)dy, mask, (XT*)dx, n, vec, regime, c);
}

}  // namespace

// y = drop(cast(act(x))) over n contiguous lanes. x_bf16 / y_bf16 give the
// dtypes (f32 -> f32, f32 -> bf16 or bf16 -> bf16); mask: null, or (ReLU
// only) ceil(n / 8) bytes that receive the passes bits; words: the step's
// two dropout key words on the card (unused in regime 0); act 0 none, 1
// ReLU, 2 ELU; regime 0-3 as above, with kq (regime 2), keep in f32
// (regime 3) and c, keep or 256 / kq rounded to y's dtype.
LT_EXPORT int lt_dropout_act_fwd(const void* x, int x_bf16, void* y,
                                 int y_bf16, uint8_t* mask, int64_t n,
                                 const int32_t* words, uint32_t layer,
                                 int act, int regime, uint32_t kq,
                                 float keep, float c, void* stream) {
  if (bad_args(n, act, regime) || (regime != 0 && words == nullptr) ||
      (x_bf16 && !y_bf16) || (mask != nullptr && act != kActRelu))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const bool vec = aligned16(x) && aligned16(y);
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16 && !y_bf16)
    launch_fwd<float, float>(x, y, mask, n, vec, words, layer, act, regime,
                             kq, keep, c, s);
  else if (!x_bf16)
    launch_fwd<float, __nv_bfloat16>(x, y, mask, n, vec, words, layer, act,
                                     regime, kq, keep, c, s);
  else
    launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, y, mask, n, vec, words,
                                             layer, act, regime, kq, keep,
                                             c, s);
  return (int)cudaGetLastError();
}

// dx (x's dtype) = the backward of lt_dropout_act_fwd at dy (y's dtype).
// ReLU: from dy and the forward's mask alone (x and words may be null);
// ELU: from dy, x and the keep bits drawn again; none: from dy and the
// keep bits (x may be null).
LT_EXPORT int lt_dropout_act_bwd(const void* dy, const void* x,
                                 const uint8_t* mask, int x_bf16, void* dx,
                                 int y_bf16, int64_t n,
                                 const int32_t* words, uint32_t layer,
                                 int act, int regime, uint32_t kq,
                                 float keep, float c, void* stream) {
  const bool relu = act == kActRelu;
  if (bad_args(n, act, regime) || (x_bf16 && !y_bf16) ||
      (relu && mask == nullptr) ||
      (!relu && regime != 0 && words == nullptr) ||
      (act == kActElu && x == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (relu) {
    const bool vec = aligned16(dy) && aligned16(dx);
    if (!x_bf16 && !y_bf16)
      launch_relu_bwd<float, float>(dy, mask, dx, n, vec, regime, c, s);
    else if (!x_bf16)
      launch_relu_bwd<float, __nv_bfloat16>(dy, mask, dx, n, vec, regime, c,
                                            s);
    else
      launch_relu_bwd<__nv_bfloat16, __nv_bfloat16>(dy, mask, dx, n, vec,
                                                    regime, c, s);
    return (int)cudaGetLastError();
  }
  const bool vec = aligned16(dy) && aligned16(x) && aligned16(dx);
  const unsigned int grid = lt_grid((n + 7) / 8);
  if (!x_bf16 && !y_bf16)
    dropout_act_bwd_kernel<float, float><<<grid, kThreads, 0, s>>>(
        (const float*)dy, (const float*)x, (float*)dx, n, vec, words, layer,
        act, regime, kq, keep, c);
  else if (!x_bf16)
    dropout_act_bwd_kernel<float, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)dy, (const float*)x, (float*)dx, n, vec, words,
        layer, act, regime, kq, keep, c);
  else
    dropout_act_bwd_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<grid, kThreads, 0, s>>>((const __nv_bfloat16*)dy,
                                   (const __nv_bfloat16*)x,
                                   (__nv_bfloat16*)dx, n, vec, words, layer,
                                   act, regime, kq, keep, c);
  return (int)cudaGetLastError();
}
