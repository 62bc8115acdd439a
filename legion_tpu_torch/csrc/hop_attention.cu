// K7 hop_attention: GAT's per-destination edge softmax and the
// alpha-weighted sum of gathered rows, forward and backward.
//
// Replaces legion_tpu/ops/hop_agg.py::hop_softmax_attention (XLA on the
// TPU). There, the dense form materialises the [fanout, F, H, d] edge
// messages, and above 64M elements a fanout-chunked, rematerialised scan
// takes its place. Here nothing of size [fanout, F, H, d] is ever written.
//
// Layout (the sampler's fanout-major lanes): lane f*F + i is draw f of
// frontier row i; its source row is src[f*F + i] (-1 for a pad), or
// aligned + f*F + i on a lane-aligned hop. scores and alpha are
// [fanout, F, H] f32; z is [N, H*d]; out is [num_dst, H*d] f32 and row i
// lands at *hop_offset + i (a device scalar, read here with no host sync).
// The forward writes every row of out: zeros outside [offset, offset + F).
//
// Bound on this card: device-memory bytes of the z gather (fanout rows of
// H*d per destination) in the forward; in the backward the same reads and
// f32 atomics into dz on a gathered hop (as K2), or plain stores in z's
// dtype on an aligned hop, whose lanes own distinct rows. At GAT's layer 1
// (8000 rows x 25 draws x 1 head x 32 bf16) the bytes are a few
// microseconds' worth: what counts there is lanes at work and few, wide
// memory operations.
//
// Two designs, chosen by shape in the launchers:
//   - small rows (fanout <= 32, a head's slice of a row 16, 32, 64 or 128
//     bytes, 16-byte aligned tensors): a warp owns one (frontier row,
//     head), eight warps a block. A lane a draw for the softmax (max, sum
//     and the backward's Jacobian by shuffles). For the contraction a lane
//     is a (draw, 16-byte chunk) pair, so one warp load brings 32 / chunks
//     source rows; every load of the row's draws is started before the
//     first is used; the partial sums of the draw groups meet by shuffles.
//     The backward takes d alpha from the same loads against the
//     destination's d out chunk in registers, and adds into dz four floats
//     at a time (red.global.add.v4.f32) on a gathered hop.
//   - any other shape (fanout <= 64, heads <= 16): a block owns a frontier
//     row, a thread a column, the softmax per head in shared memory.
//
// Invalid lanes carry alpha 0 and never reach expf; a row with no valid
// lane gives zeros, not NaN. alpha_pre is the softmax before dropout,
// saved for the backward.
//
// Attention dropout (legion_tpu/ops/hop_agg.py:120) is drawn in the
// kernels: the keep bit of (lane, head) at alpha's index e = (f*F + i)*H + h
// is keep_lane of the step's dropout key folded with the layer's fold
// (dropout.cuh; regime 3 at GAT's layer 1, 2 from 2^20 entries on), drawn
// where the softmax needs it, and drawn again in the backward: no mask is
// read or stored. A kept alpha is divided by keep in f32 (times 256 / kq in
// regime 2), as JAX's dropout; dropped lanes are skipped.
#include <cuda_bf16.h>

#include "dropout.cuh"

constexpr int kMaxFanout = 64;
constexpr int kMaxHeads = 16;

__device__ __forceinline__ float lt_ld(const float* p) { return *p; }
__device__ __forceinline__ float lt_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void lt_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void lt_st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lt_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-row set-up shared by both passes: source rows (-1 when invalid).
__device__ __forceinline__ void load_rows(const int32_t* src, int64_t F,
                                          int64_t i, int fanout,
                                          int64_t aligned, int32_t* rows) {
  for (int f = threadIdx.x; f < fanout; f += blockDim.x) {
    const int32_t s = src[f * F + i];
    rows[f] = s < 0 ? -1 : (aligned >= 0 ? (int32_t)(aligned + f * F + i)
                                         : s);
  }
}

// Destination row r of out, zeroed unless a frontier row lands on it.
__device__ __forceinline__ void zero_outside(float* out, int64_t r,
                                             int64_t offset, int64_t F,
                                             int HD, int t, int step) {
  if (r >= offset && r < offset + F) return;
  for (int c = t; c < HD; c += step) out[r * HD + c] = 0.0f;
}

template <typename T>
__global__ void hop_attention_fwd_kernel(
    const T* __restrict__ z, const float* __restrict__ scores,
    const int32_t* __restrict__ src, const int32_t* __restrict__ hop_offset,
    const DropArgs dargs, float* __restrict__ out,
    float* __restrict__ alpha_pre, int64_t F, int fanout, int H, int d,
    int64_t num_dst, int64_t aligned) {
  __shared__ int32_t rows[kMaxFanout];
  __shared__ float a[kMaxFanout * kMaxHeads];
  const Drop drop = make_drop(dargs);
  const int64_t i = blockIdx.x;
  const int HD = H * d;
  if (i >= F) {
    zero_outside(out, i - F, *hop_offset, F, HD, threadIdx.x, blockDim.x);
    return;
  }
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
      a[f * H + h] = drop_f32(drop, keep_lane(drop, (uint32_t)idx), p);
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
    const float* __restrict__ alpha_pre, const DropArgs dargs,
    float* __restrict__ dscores, void* __restrict__ dz, int64_t F,
    int fanout, int H, int d, int64_t num_dst, int64_t aligned) {
  __shared__ int32_t rows[kMaxFanout];
  __shared__ float p[kMaxFanout * kMaxHeads];     // alpha before dropout
  __shared__ bool kp[kMaxFanout * kMaxHeads];     // kept
  __shared__ float da[kMaxFanout * kMaxHeads];    // d alpha after dropout
  const Drop drop = make_drop(dargs);
  const int64_t i = blockIdx.x;
  const int HD = H * d;
  const int64_t dst = (int64_t)*hop_offset + i;
  const bool live = dst >= 0 && dst < num_dst;
  load_rows(src, F, i, fanout, aligned, rows);
  for (int t = threadIdx.x; t < fanout * H; t += blockDim.x) {
    const int64_t idx = ((int64_t)(t / H) * F + i) * H + t % H;
    p[t] = alpha_pre[idx];
    kp[t] = keep_lane(drop, (uint32_t)idx);
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
      if (c < HD && kp[f * H + h])
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
  // softmax Jacobian per head: ds = p (dp - sum_f p dp), dp = da through
  // dropout's backward (da / keep where kept, else 0)
  if (threadIdx.x < H) {
    const int h = threadIdx.x;
    float s = 0.0f;
    for (int f = 0; f < fanout; ++f)
      s += p[f * H + h] * drop_f32(drop, kp[f * H + h], da[f * H + h]);
    for (int f = 0; f < fanout; ++f) {
      const float g = drop_f32(drop, kp[f * H + h], da[f * H + h]);
      dscores[((int64_t)f * F + i) * H + h] = p[f * H + h] * (g - s);
    }
  }
  if (!live) return;
  // dz[row_f, c] += alpha_post[f, h] * dout[dst, c]: f32 atomics on a
  // gathered hop, a store in z's dtype on an aligned one
  for (int f = 0; f < fanout; ++f) {
    if (rows[f] < 0) continue;
    const int64_t at = (int64_t)rows[f] * HD;
    for (int c = threadIdx.x; c < HD; c += blockDim.x) {
      const int h = c / d;
      const float ap = drop_f32(drop, kp[f * H + h], p[f * H + h]);
      if (ap == 0.0f) continue;
      const float v = ap * dout[dst * HD + c];
      if (aligned >= 0)
        lt_st(reinterpret_cast<T*>(dz) + at + c, v);
      else
        atomicAdd(reinterpret_cast<float*>(dz) + at + c, v);
    }
  }
}

// ---------------------------------------------------------------------------
// Small rows: a warp per (frontier row, head). T is z's type, C the 16-byte
// chunks of a head's slice of a row (d = C * 16 / sizeof(T)); a lane is
// (draw group g = lane / C, chunk c = lane % C), and load l of the warp
// brings the rows of draws l * (32 / C) + g.
// ---------------------------------------------------------------------------
constexpr int kSmallFanout = 32;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float lt_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The 16 / sizeof(T) values of a 16-byte chunk, widened to f32.
__device__ __forceinline__ void unpack(const uint4& v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// This lane's draw: its source row (-1 when invalid or past the fanout)
// and its index into scores and alpha, which is also its dropout lane.
__device__ __forceinline__ int32_t small_row(const int32_t* src, int64_t F,
                                             int64_t i, int H, int h,
                                             int fanout, int64_t aligned,
                                             int lane, int64_t* idx) {
  *idx = 0;
  if (lane >= fanout) return -1;
  const int64_t e = (int64_t)lane * F + i;
  *idx = e * H + h;
  const int32_t s = src[e];
  return s < 0 ? -1 : (aligned >= 0 ? (int32_t)(aligned + e) : s);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) hop_attention_small_fwd_kernel(
    const T* __restrict__ z, const float* __restrict__ scores,
    const int32_t* __restrict__ src, const int32_t* __restrict__ hop_offset,
    const DropArgs dargs, float* __restrict__ out,
    float* __restrict__ alpha_pre, int64_t F, int fanout, int H,
    int64_t num_dst, int64_t aligned) {
  constexpr int E = 16 / sizeof(T), R = 32 / C, d = C * E;
  const Drop drop = make_drop(dargs);
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int HD = H * d;
  const int64_t offset = *hop_offset;
  if (w >= F * H) {
    // the warps past the (row, head) pairs zero the other destinations
    if (w - F * H < num_dst)
      zero_outside(out, w - F * H, offset, F, HD, lane, 32);
    return;
  }
  const int64_t i = w / H;
  const int h = (int)(w - i * H);
  // a lane a draw: the masked softmax over the fanout
  int64_t idx;
  const int32_t row = small_row(src, F, i, H, h, fanout, aligned, lane, &idx);
  const float sc = row >= 0 ? scores[idx] : -INFINITY;
  const float m = lt_warp_max(sc);
  const float e = row >= 0 ? expf(sc - m) : 0.0f;
  const float p = e / fmaxf(lt_warp_sum(e), 1.17549435e-38f);
  float a = 0.0f;
  if (lane < fanout) {
    alpha_pre[idx] = p;
    a = drop_f32(drop, keep_lane(drop, (uint32_t)idx), p);
  }
  const int64_t dst = offset + i;
  if (dst < 0 || dst >= num_dst) return;
  // a lane a (draw, chunk): every load before the first use
  const int c = lane % C, g = lane / C;
  const char* zc = reinterpret_cast<const char*>(z)
      + ((int64_t)h * d * sizeof(T) + 16 * c);
  uint4 v[C];
  float af[C];
#pragma unroll
  for (int l = 0; l < C; ++l) {
    const int32_t rf = __shfl_sync(0xffffffffu, row, l * R + g);
    af[l] = __shfl_sync(0xffffffffu, a, l * R + g);
    v[l] = make_uint4(0, 0, 0, 0);
    if (rf >= 0 && af[l] != 0.0f)
      v[l] = *reinterpret_cast<const uint4*>(
          zc + (int64_t)rf * HD * sizeof(T));
    else
      af[l] = 0.0f;
  }
  float acc[E];
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    float x[E];
    unpack(v[l], x);
#pragma unroll
    for (int k = 0; k < E; ++k) acc[k] += af[l] * x[k];
  }
#pragma unroll
  for (int o = C; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < E; ++k)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
  if (g == 0) {
    float4* o4 = reinterpret_cast<float4*>(out + dst * HD + h * d + c * E);
#pragma unroll
    for (int k = 0; k < E / 4; ++k)
      o4[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                          acc[4 * k + 3]);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) hop_attention_small_bwd_kernel(
    const float* __restrict__ dout, const T* __restrict__ z,
    const int32_t* __restrict__ src, const int32_t* __restrict__ hop_offset,
    const float* __restrict__ alpha_pre, const DropArgs dargs,
    float* __restrict__ dscores, void* __restrict__ dz, int64_t F,
    int fanout, int H, int64_t num_dst, int64_t aligned) {
  constexpr int E = 16 / sizeof(T), R = 32 / C, d = C * E;
  const Drop drop = make_drop(dargs);
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= F * H) return;
  const int HD = H * d;
  const int64_t i = w / H;
  const int h = (int)(w - i * H);
  const int64_t dst = (int64_t)*hop_offset + i;
  const bool live = dst >= 0 && dst < num_dst;
  int64_t idx;
  const int32_t row = small_row(src, F, i, H, h, fanout, aligned, lane, &idx);
  float p = 0.0f;
  bool kp = false;
  if (lane < fanout) {
    p = alpha_pre[idx];
    kp = keep_lane(drop, (uint32_t)idx);
  }
  const int c = lane % C, g = lane / C;
  // this lane's chunk of the destination's d out row
  float go[E];
#pragma unroll
  for (int k = 0; k < E; ++k) go[k] = 0.0f;
  if (live) {
    const float4* g4 =
        reinterpret_cast<const float4*>(dout + dst * HD + h * d + c * E);
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 t = g4[k];
      go[4 * k] = t.x;
      go[4 * k + 1] = t.y;
      go[4 * k + 2] = t.z;
      go[4 * k + 3] = t.w;
    }
  }
  const char* zc = reinterpret_cast<const char*>(z)
      + ((int64_t)h * d * sizeof(T) + 16 * c);
  uint4 v[C];
  int32_t rf[C];
  float pf[C];
  bool kf[C], use[C];
#pragma unroll
  for (int l = 0; l < C; ++l) {
    rf[l] = __shfl_sync(0xffffffffu, row, l * R + g);
    pf[l] = __shfl_sync(0xffffffffu, p, l * R + g);
    kf[l] = __shfl_sync(0xffffffffu, (int)kp, l * R + g) != 0;
    use[l] = live && rf[l] >= 0 && kf[l];
    v[l] = make_uint4(0, 0, 0, 0);
    if (use[l])
      v[l] = *reinterpret_cast<const uint4*>(
          zc + (int64_t)rf[l] * HD * sizeof(T));
  }
  // d alpha[f] = <dout[dst, h, :], z[row_f, h, :]>, summed over the chunks;
  // then the softmax Jacobian: ds = p (dp - sum_f p dp), dp = da through
  // dropout's backward
  float da[C];
  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < C; ++l) {
    float x[E];
    unpack(v[l], x);
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < E; ++k) t += go[k] * x[k];
    if (!use[l]) t = 0.0f;
#pragma unroll
    for (int o = 1; o < C; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    da[l] = drop_f32(drop, kf[l], t);
    if (c == 0) s += pf[l] * da[l];
  }
  s = lt_warp_sum(s);
#pragma unroll
  for (int l = 0; l < C; ++l) {
    const int f = l * R + g;
    if (c == 0 && f < fanout)
      dscores[((int64_t)f * F + i) * H + h] = pf[l] * (da[l] - s);
  }
  if (!live) return;
  // dz[row_f, h, chunk] += alpha_post[f] * dout chunk: four floats an
  // atomic on a gathered hop, one 16-byte store in z's type on an aligned
#pragma unroll
  for (int l = 0; l < C; ++l) {
    const float ap = drop_f32(drop, kf[l], pf[l]);
    if (rf[l] < 0 || ap == 0.0f) continue;
    const int64_t at = (int64_t)rf[l] * HD + h * d + c * E;
    if (aligned < 0) {
      float4* d4 = reinterpret_cast<float4*>(
          reinterpret_cast<float*>(dz) + at);
#pragma unroll
      for (int k = 0; k < E / 4; ++k)
        atomicAdd(d4 + k, make_float4(ap * go[4 * k], ap * go[4 * k + 1],
                                      ap * go[4 * k + 2],
                                      ap * go[4 * k + 3]));
    } else {
      T* dzr = reinterpret_cast<T*>(dz) + at;
      uint4 o;
      if constexpr (sizeof(T) == 4) {
        o = make_uint4(__float_as_uint(ap * go[0]), __float_as_uint(ap * go[1]),
                       __float_as_uint(ap * go[2]),
                       __float_as_uint(ap * go[3]));
      } else {
        uint32_t q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 b =
              __floats2bfloat162_rn(ap * go[2 * k], ap * go[2 * k + 1]);
          q[k] = *reinterpret_cast<const uint32_t*>(&b);
        }
        o = make_uint4(q[0], q[1], q[2], q[3]);
      }
      *reinterpret_cast<uint4*>(dzr) = o;
    }
  }
}

// Whether the small-row kernels take this shape, and with how many chunks.
template <typename T>
static int small_chunks(int fanout, int d, const void* a, const void* b,
                        const void* c) {
  const int bytes = d * (int)sizeof(T);
  const bool fits = fanout <= kSmallFanout
      && (bytes == 16 || bytes == 32 || bytes == 64 || bytes == 128)
      && ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
  return fits ? bytes / 16 : 0;
}

static unsigned int warp_blocks(int64_t warps) {
  return (unsigned int)((warps + kWarps - 1) / kWarps);
}

static int block_threads(int HD) {
  const int t = ((HD + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

template <typename T>
static int launch_fwd(const void* z, const float* scores, const int32_t* src,
                      const int32_t* hop_offset, const DropArgs& drop,
                      float* out, float* alpha_pre, int64_t F, int fanout,
                      int H, int d, int64_t num_dst, int64_t aligned,
                      void* stream) {
  if (F + num_dst == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define LT_SMALL_FWD(C)                                                     \
  case C:                                                                   \
    hop_attention_small_fwd_kernel<T, C>                                    \
        <<<warp_blocks(F * H + num_dst), kThreads, 0, st>>>(                \
            (const T*)z, scores, src, hop_offset, drop, out, alpha_pre, F,  \
            fanout, H, num_dst, aligned);                                   \
    break;
  switch (small_chunks<T>(fanout, d, z, out, nullptr)) {
    LT_SMALL_FWD(1) LT_SMALL_FWD(2) LT_SMALL_FWD(4) LT_SMALL_FWD(8)
    default:
      hop_attention_fwd_kernel<T><<<(unsigned int)(F + num_dst),
                                    block_threads(H * d), 0, st>>>(
          (const T*)z, scores, src, hop_offset, drop, out, alpha_pre, F,
          fanout, H, d, num_dst, aligned);
  }
#undef LT_SMALL_FWD
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd(const float* dout, const void* z, const int32_t* src,
                      const int32_t* hop_offset, const float* alpha_pre,
                      const DropArgs& drop, float* dscores, void* dz,
                      int64_t F, int fanout, int H, int d, int64_t num_dst,
                      int64_t aligned, void* stream) {
  if (F == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define LT_SMALL_BWD(C)                                                     \
  case C:                                                                   \
    hop_attention_small_bwd_kernel<T, C>                                    \
        <<<warp_blocks(F * H), kThreads, 0, st>>>(                          \
            dout, (const T*)z, src, hop_offset, alpha_pre, drop, dscores,   \
            dz, F, fanout, H, num_dst, aligned);                            \
    break;
  switch (small_chunks<T>(fanout, d, z, dout, dz)) {
    LT_SMALL_BWD(1) LT_SMALL_BWD(2) LT_SMALL_BWD(4) LT_SMALL_BWD(8)
    default:
      hop_attention_bwd_kernel<T><<<(unsigned int)F, block_threads(H * d),
                                    0, st>>>(
          dout, (const T*)z, src, hop_offset, alpha_pre, drop, dscores, dz,
          F, fanout, H, d, num_dst, aligned);
  }
#undef LT_SMALL_BWD
  return (int)cudaGetLastError();
}

// is_bf16 selects z's dtype; aligned < 0 means a gathered hop. Attention
// dropout: words (the step's two dropout key words on the card), fold,
// regime (0: none; words may then be null), kq, keep and c as dropout.cuh
// takes them. The forward writes all of out. dz is f32 on a gathered hop
// and of z's dtype on an aligned one, zeroed by the caller.
LT_EXPORT int lt_hop_attention_fwd(const void* z, const float* scores,
                                   const int32_t* src,
                                   const int32_t* hop_offset,
                                   const int32_t* words, uint64_t fold,
                                   int regime, uint32_t kq, float keep,
                                   float c, float* out, float* alpha_pre,
                                   int64_t F, int fanout, int H, int d,
                                   int64_t num_dst, int64_t aligned,
                                   int is_bf16, void* stream) {
  const DropArgs drop{words, fold, regime, kq, keep, c};
  if (fanout > kMaxFanout || H > kMaxHeads || bad_drop(drop))
    return (int)cudaErrorInvalidValue;
  return is_bf16
      ? launch_fwd<__nv_bfloat16>(z, scores, src, hop_offset, drop, out,
                                  alpha_pre, F, fanout, H, d, num_dst,
                                  aligned, stream)
      : launch_fwd<float>(z, scores, src, hop_offset, drop, out, alpha_pre,
                          F, fanout, H, d, num_dst, aligned, stream);
}

LT_EXPORT int lt_hop_attention_bwd(const float* dout, const void* z,
                                   const int32_t* src,
                                   const int32_t* hop_offset,
                                   const float* alpha_pre,
                                   const int32_t* words, uint64_t fold,
                                   int regime, uint32_t kq, float keep,
                                   float c, float* dscores, void* dz,
                                   int64_t F, int fanout, int H, int d,
                                   int64_t num_dst, int64_t aligned,
                                   int is_bf16, void* stream) {
  const DropArgs drop{words, fold, regime, kq, keep, c};
  if (fanout > kMaxFanout || H > kMaxHeads || bad_drop(drop))
    return (int)cudaErrorInvalidValue;
  return is_bf16
      ? launch_bwd<__nv_bfloat16>(dout, z, src, hop_offset, alpha_pre, drop,
                                  dscores, dz, F, fanout, H, d, num_dst,
                                  aligned, stream)
      : launch_bwd<float>(dout, z, src, hop_offset, alpha_pre, drop, dscores,
                          dz, F, fanout, H, d, num_dst, aligned, stream);
}
