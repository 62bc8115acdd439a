// K7 hop_attention: GAT's per-destination edge softmax and the
// alpha-weighted sum of gathered rows, forward and backward.
//
// Replaces legion_tpu/ops/hop_agg.py::hop_softmax_attention (XLA on the
// TPU). There, the dense form materialises the [fanout, F, H, d] edge
// messages, and above 64M elements a fanout-chunked, rematerialised scan
// takes its place. Here one block owns one frontier row i: it reads the
// row's fanout scores, takes the masked softmax per head in shared memory,
// and sums the fanout gathered z rows with f32 accumulators in registers.
// Nothing of size [fanout, F, H, d] is ever written.
//
// Layout (the sampler's fanout-major lanes): lane f*F + i is draw f of
// frontier row i; its source row is src[f*F + i] (-1 for a pad), or
// aligned + f*F + i on a lane-aligned hop. scores and alpha are
// [fanout, F, H] f32; z is [N, H*d]; out is [num_dst, H*d] f32 and row i
// lands at *hop_offset + i (a device scalar, read here with no host sync).
//
// Bound on this card: device-memory bytes of the z gather (fanout rows of
// H*d per destination) in the forward; in the backward the same reads and
// f32 atomics into dz on a gathered hop (as K2), or plain stores on an
// aligned hop, whose lanes own distinct rows.
//
// Invalid lanes carry alpha 0 and never reach expf; a row with no valid
// lane gives zeros, not NaN. Dropped lanes (keep mask 0) are skipped.
#include <cuda_bf16.h>

#include "common.cuh"

constexpr int kMaxFanout = 64;
constexpr int kMaxHeads = 16;

__device__ __forceinline__ float lt_ld(const float* p) { return *p; }
__device__ __forceinline__ float lt_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float lt_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-row set-up shared by both passes: source rows (-1 when invalid) and
// the keep factor of every (lane, head).
__device__ __forceinline__ void load_rows(const int32_t* src, int64_t F,
                                          int64_t i, int fanout,
                                          int64_t aligned, int32_t* rows) {
  for (int f = threadIdx.x; f < fanout; f += blockDim.x) {
    const int32_t s = src[f * F + i];
    rows[f] = s < 0 ? -1 : (aligned >= 0 ? (int32_t)(aligned + f * F + i)
                                         : s);
  }
}

__device__ __forceinline__ float keep_of(const uint8_t* mask, float scale,
                                         int64_t idx) {
  return mask == nullptr ? 1.0f : (mask[idx] ? scale : 0.0f);
}

template <typename T>
__global__ void hop_attention_fwd_kernel(
    const T* __restrict__ z, const float* __restrict__ scores,
    const int32_t* __restrict__ src, const int32_t* __restrict__ hop_offset,
    const uint8_t* __restrict__ mask, float scale, float* __restrict__ out,
    float* __restrict__ alpha_pre, int64_t F, int fanout, int H, int d,
    int64_t num_dst, int64_t aligned) {
  __shared__ int32_t rows[kMaxFanout];
  __shared__ float a[kMaxFanout * kMaxHeads];
  const int64_t i = blockIdx.x;
  const int HD = H * d;
  load_rows(src, F, i, fanout, aligned, rows);
  for (int t = threadIdx.x; t < fanout * H; t += blockDim.x)
    a[t] = scores[((t / H) * F + i) * H + t % H];
  __syncthreads();
  if (threadIdx.x < H) {
    const int h = threadIdx.x;
    float m = -INFINITY;
    for (int f = 0; f < fanout; ++f)
      if (rows[f] >= 0) m = fmaxf(m, a[f * H + h]);
    float sum = 0.0f;
    for (int f = 0; f < fanout; ++f) {
      const float e = rows[f] >= 0 ? expf(a[f * H + h] - m) : 0.0f;
      a[f * H + h] = e;
      sum += e;
    }
    const float den = fmaxf(sum, 1.17549435e-38f);
    for (int f = 0; f < fanout; ++f) {
      const float p = a[f * H + h] / den;
      const int64_t idx = ((int64_t)f * F + i) * H + h;
      alpha_pre[idx] = p;
      a[f * H + h] = p * keep_of(mask, scale, idx);
    }
  }
  __syncthreads();
  const int64_t dst = (int64_t)*hop_offset + i;
  if (dst < 0 || dst >= num_dst) return;
  for (int c = threadIdx.x; c < HD; c += blockDim.x) {
    const int h = c / d;
    float acc = 0.0f;
    for (int f = 0; f < fanout; ++f) {
      const float p = a[f * H + h];
      if (rows[f] >= 0 && p != 0.0f)
        acc += p * lt_ld(z + (int64_t)rows[f] * HD + c);
    }
    out[dst * HD + c] = acc;
  }
}

template <typename T>
__global__ void hop_attention_bwd_kernel(
    const float* __restrict__ dout, const T* __restrict__ z,
    const int32_t* __restrict__ src, const int32_t* __restrict__ hop_offset,
    const float* __restrict__ alpha_pre, const uint8_t* __restrict__ mask,
    float scale, float* __restrict__ dscores, float* __restrict__ dz,
    int64_t F, int fanout, int H, int d, int64_t num_dst, int64_t aligned) {
  __shared__ int32_t rows[kMaxFanout];
  __shared__ float p[kMaxFanout * kMaxHeads];     // alpha before dropout
  __shared__ float kp[kMaxFanout * kMaxHeads];    // keep factor
  __shared__ float da[kMaxFanout * kMaxHeads];    // d alpha after dropout
  const int64_t i = blockIdx.x;
  const int HD = H * d;
  const int64_t dst = (int64_t)*hop_offset + i;
  const bool live = dst >= 0 && dst < num_dst;
  load_rows(src, F, i, fanout, aligned, rows);
  for (int t = threadIdx.x; t < fanout * H; t += blockDim.x) {
    const int64_t idx = ((int64_t)(t / H) * F + i) * H + t % H;
    p[t] = alpha_pre[idx];
    kp[t] = keep_of(mask, scale, idx);
    da[t] = 0.0f;
  }
  __syncthreads();
  // d alpha[f, h] = <dout[dst, h, :], z[row_f, h, :]>; a warp's 32
  // columns lie in one head when d % 32 == 0, so it reduces by shuffles
  const bool warp_heads = (d % 32) == 0;
  for (int f = 0; f < fanout && live; ++f) {
    if (rows[f] < 0) continue;
    const T* zr = z + (int64_t)rows[f] * HD;
    for (int c0 = 0; c0 < HD; c0 += blockDim.x) {
      const int c = c0 + threadIdx.x;
      const int h = (c < HD ? c : HD - 1) / d;
      float v = 0.0f;
      if (c < HD && kp[f * H + h] != 0.0f)
        v = dout[dst * HD + c] * lt_ld(zr + c);
      if (warp_heads) {
        v = lt_warp_sum(v);
        if ((threadIdx.x & 31) == 0 && c < HD) atomicAdd(&da[f * H + h], v);
      } else if (c < HD) {
        atomicAdd(&da[f * H + h], v);
      }
    }
  }
  __syncthreads();
  // softmax Jacobian per head: ds = p (dp - sum_f p dp), dp = da * keep
  if (threadIdx.x < H) {
    const int h = threadIdx.x;
    float s = 0.0f;
    for (int f = 0; f < fanout; ++f)
      s += p[f * H + h] * da[f * H + h] * kp[f * H + h];
    for (int f = 0; f < fanout; ++f) {
      const float g = da[f * H + h] * kp[f * H + h];
      dscores[((int64_t)f * F + i) * H + h] = p[f * H + h] * (g - s);
    }
  }
  if (!live) return;
  // dz[row_f, c] += alpha_post[f, h] * dout[dst, c]
  for (int f = 0; f < fanout; ++f) {
    if (rows[f] < 0) continue;
    float* dzr = dz + (int64_t)rows[f] * HD;
    for (int c = threadIdx.x; c < HD; c += blockDim.x) {
      const int h = c / d;
      const float ap = p[f * H + h] * kp[f * H + h];
      if (ap == 0.0f) continue;
      const float v = ap * dout[dst * HD + c];
      if (aligned >= 0)
        dzr[c] = v;
      else
        atomicAdd(dzr + c, v);
    }
  }
}

static int block_threads(int HD) {
  const int t = ((HD + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

template <typename T>
static int launch_fwd(const void* z, const float* scores, const int32_t* src,
                      const int32_t* hop_offset, const uint8_t* mask,
                      float scale, float* out, float* alpha_pre, int64_t F,
                      int fanout, int H, int d, int64_t num_dst,
                      int64_t aligned, void* stream) {
  if (F == 0) return (int)cudaSuccess;
  hop_attention_fwd_kernel<T><<<(unsigned int)F, block_threads(H * d), 0,
                                (cudaStream_t)stream>>>(
      (const T*)z, scores, src, hop_offset, mask, scale, out, alpha_pre, F,
      fanout, H, d, num_dst, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd(const float* dout, const void* z, const int32_t* src,
                      const int32_t* hop_offset, const float* alpha_pre,
                      const uint8_t* mask, float scale, float* dscores,
                      float* dz, int64_t F, int fanout, int H, int d,
                      int64_t num_dst, int64_t aligned, void* stream) {
  if (F == 0) return (int)cudaSuccess;
  hop_attention_bwd_kernel<T><<<(unsigned int)F, block_threads(H * d), 0,
                                (cudaStream_t)stream>>>(
      dout, (const T*)z, src, hop_offset, alpha_pre, mask, scale, dscores,
      dz, F, fanout, H, d, num_dst, aligned);
  return (int)cudaGetLastError();
}

// is_bf16 selects z's dtype; mask may be null (no dropout); aligned < 0
// means a gathered hop. out and dz must be zeroed by the caller.
LT_EXPORT int lt_hop_attention_fwd(const void* z, const float* scores,
                                   const int32_t* src,
                                   const int32_t* hop_offset,
                                   const uint8_t* mask, float scale,
                                   float* out, float* alpha_pre, int64_t F,
                                   int fanout, int H, int d, int64_t num_dst,
                                   int64_t aligned, int is_bf16,
                                   void* stream) {
  if (fanout > kMaxFanout || H > kMaxHeads) return (int)cudaErrorInvalidValue;
  return is_bf16
      ? launch_fwd<__nv_bfloat16>(z, scores, src, hop_offset, mask, scale,
                                  out, alpha_pre, F, fanout, H, d, num_dst,
                                  aligned, stream)
      : launch_fwd<float>(z, scores, src, hop_offset, mask, scale, out,
                          alpha_pre, F, fanout, H, d, num_dst, aligned,
                          stream);
}

LT_EXPORT int lt_hop_attention_bwd(const float* dout, const void* z,
                                   const int32_t* src,
                                   const int32_t* hop_offset,
                                   const float* alpha_pre,
                                   const uint8_t* mask, float scale,
                                   float* dscores, float* dz, int64_t F,
                                   int fanout, int H, int d, int64_t num_dst,
                                   int64_t aligned, int is_bf16,
                                   void* stream) {
  if (fanout > kMaxFanout || H > kMaxHeads) return (int)cudaErrorInvalidValue;
  return is_bf16
      ? launch_bwd<__nv_bfloat16>(dout, z, src, hop_offset, alpha_pre, mask,
                                  scale, dscores, dz, F, fanout, H, d,
                                  num_dst, aligned, stream)
      : launch_bwd<float>(dout, z, src, hop_offset, alpha_pre, mask, scale,
                          dscores, dz, F, fanout, H, d, num_dst, aligned,
                          stream);
}
