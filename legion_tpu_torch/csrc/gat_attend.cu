// K6 gat_attend: GAT attention on a lane-aligned hop, through the
// projection commute, forward and backward.
//
// Replaces the XLA body of legion_tpu/models/gat.py::
// gat_layer_aligned_streaming (:83-99): the scores of every lane against
// the folded attention vectors u_l, u_r [d_in, H], LeakyReLU, the masked
// softmax over the fanout per head, attention dropout, and the fanout
// contraction xw[i, h, k] = sum_f alpha[f, i, h] x[f, i, k]. In plain torch
// that is about ten launches over [fanout, F, H] tensors and a batched
// H x fanout @ fanout x d_in product per row.
//
// Bound on this card: device-memory bytes (the lanes, d_in wide, and the
// [F, H, d_in] output) and shared-memory instructions. Design: one warp per
// frontier row i, up to eight rows to a block, no block barrier after the
// set-up. The block keeps u_l and u_r (f32, transposed to [H, ld]) in
// shared memory; each warp stages its row's fanout lanes
// x[aligned + f*F + i] and its destination row x[*hop_offset + i] once, as
// f32, in its own slice of shared memory. Every inner loop reads shared
// memory four floats at a time:
//   - a score is a dot product of length d_in: the warp's lanes split into
//     H' groups of G = 32 / H' lanes (H' = H rounded up to a power of two),
//     so all heads of one row reduce at once, by shuffles inside a group;
//   - the contraction gives each lane four columns of a head and sums the
//     fanout rows with alpha read as a broadcast.
// Rows are zero-padded to a multiple of four and strided by ld, a multiple
// of 32 plus 4G when G < 8, so the H' groups' 16-byte reads of one
// quarter-warp land in distinct banks.
//
// Rounding mirrors the JAX layer: the scores el, er are f32 dot products
// rounded to x's dtype (JAX's x @ u in bf16), then widened; alpha after
// dropout is rounded to x's dtype before the contraction (gat.py:97-99),
// and so is d alpha in the backward (the transpose of that contraction in
// x's dtype); xw is accumulated in f32 and stored in x's dtype.
//
// Saved for the backward: alpha before dropout [fanout, F, H] f32 and the
// sign of the pre-activation (u8, 1 where el + er < 0).
#include <cuda_bf16.h>

#include "common.cuh"

constexpr int kGatWarps = 8;
constexpr int kGatMaxFanout = 64;
constexpr int kGatMaxHeads = 16;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float g_ld(const float* p) { return *p; }
__device__ __forceinline__ float g_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void g_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void g_st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// round to the storage type and back (a bf16 product's rounding)
__device__ __forceinline__ float g_round(float v, float*) { return v; }
__device__ __forceinline__ float g_round(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// lanes per head group: 32 / (H rounded up to a power of two)
__host__ __device__ __forceinline__ int group_lanes(int H) {
  int p = 1;
  while (p < H) p <<= 1;
  return 32 / p;
}

// Shared-memory row stride in floats (see the header).
__host__ __device__ __forceinline__ int row_ld(int d_in, int G) {
  return ((d_in + 31) / 32) * 32 + (G < 8 ? 4 * G : 0);
}

// Four consecutive elements as f32, from one 8-byte (bf16) or 16-byte
// (f32) load; and the matching store.
__device__ __forceinline__ float4 g_ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 g_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void g_st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}
__device__ __forceinline__ void g_st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 s_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Copy rows row_of(0 .. n-1) of x (d_in wide) into s[r * ld] as f32,
// zero-padded to a multiple of four, by the warp's 32 lanes. A row is
// read four elements a load when vec (d_in % 4 == 0 and x aligned for it),
// and the loads of up to kStageRows rows are all issued before their
// stores: the kernels wait on these loads, not on arithmetic.
constexpr int kStageRows = 8;

template <typename T, typename RowOf>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x,
                                           RowOf row_of, int n, int d_in,
                                           bool vec, float* s, int ld,
                                           int lane) {
  const int d4 = (d_in + 3) >> 2;
  if (vec) {
    for (int w = lane; w < d4; w += 32)
      for (int r0 = 0; r0 < n; r0 += kStageRows) {
        float4 v[kStageRows];
#pragma unroll
        for (int j = 0; j < kStageRows; ++j)
          if (r0 + j < n) v[j] = g_ld4(x + row_of(r0 + j) * d_in + 4 * w);
#pragma unroll
        for (int j = 0; j < kStageRows; ++j)
          if (r0 + j < n)
            *reinterpret_cast<float4*>(s + (r0 + j) * ld + 4 * w) = v[j];
      }
  } else {
    for (int r = 0; r < n; ++r) {
      const T* src = x + row_of(r) * d_in;
      for (int k = lane; k < 4 * d4; k += 32)
        s[r * ld + k] = k < d_in ? g_ld(src + k) : 0.0f;
    }
  }
}

// Sum v over the G lanes of an aligned group (G a power of two).
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// <a, b> over d4 float4s of two shared rows, split over the G lanes of a
// head group (lane gq of the group takes float4s gq, gq + G, ...), then
// reduced in the group.
__device__ __forceinline__ float group_dot(const float* a, const float* b,
                                           int d4, int G, int gq, bool on) {
  float v = 0.0f;
  if (on)
    for (int c = gq; c < d4; c += G) v += dot4(s_ld4(a + 4 * c),
                                              s_ld4(b + 4 * c));
  return group_sum(v, G);
}

// Per-warp shared floats, rounded to a multiple of four.
__host__ __device__ __forceinline__ size_t round4(size_t n) {
  return (n + 3) & ~(size_t)3;
}

struct FwdSmem {
  static __host__ __device__ size_t block_floats(int ld, int H) {
    return 2 * (size_t)H * ld;
  }
  static __host__ __device__ size_t warp_floats(int fanout, int H, int ld) {
    return round4((size_t)(fanout + 1) * ld + (size_t)(fanout + 1) * H
                  + 2 * (size_t)fanout * H + fanout);
  }
};

// Three blocks of eight warps share an SM at the layer-0 shape (68 KB of
// shared memory each): cap the registers to match.
template <typename T>
__global__ void __launch_bounds__(kGatWarps * 32, 3) gat_attend_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ u_l,
    const T* __restrict__ u_r, const int32_t* __restrict__ src,
    const int32_t* __restrict__ hop_offset, const uint8_t* __restrict__ mask,
    float scale, float slope, T* __restrict__ xw,
    float* __restrict__ alpha_pre, uint8_t* __restrict__ neg, int64_t F,
    int fanout, int H, int d_in, int64_t aligned, bool vec) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int G = group_lanes(H);
  const int ld = row_ld(d_in, G);
  const int d4 = (d_in + 3) >> 2;
  const int warps = blockDim.x >> 5;
  float* ul = sm;                              // [H, ld]
  float* ur = ul + H * ld;                     // [H, ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = ur + H * ld
              + warp * FwdSmem::warp_floats(fanout, H, ld);  // [fo+1, ld]
  float* sc = xs + (fanout + 1) * ld;          // [fanout + 1, H]
  float* a = sc + (fanout + 1) * H;            // [fanout, H]
  float* kp = a + fanout * H;                  // [fanout, H] keep factor
  float* vl = kp + fanout * H;                 // [fanout] lane valid
  for (int t = threadIdx.x; t < H * ld; t += blockDim.x) {
    const int h = t / ld, k = t - h * ld;
    ul[t] = k < d_in ? g_ld(u_l + k * H + h) : 0.0f;
    ur[t] = k < d_in ? g_ld(u_r + k * H + h) : 0.0f;
  }
  __syncthreads();
  const int gh = lane / G, gq = lane - gh * G;   // head group, lane in it
  const int64_t off = *hop_offset;
  for (int64_t i = (int64_t)blockIdx.x * warps + warp; i < F;
       i += (int64_t)gridDim.x * warps) {
    for (int f = lane; f < fanout; f += 32) vl[f] = src[f * F + i] >= 0;
    // rows 0 .. fanout-1 are the lanes, row fanout the destination
    stage_rows(x, [&](int r) {
      return r < fanout ? aligned + (int64_t)r * F + i : off + i;
    }, fanout + 1, d_in, vec, xs, ld, lane);
    __syncwarp();
    // scores: lane row r < fanout against u_l (el), row fanout against
    // u_r (er); group gh reduces head gh
    for (int r = 0; r <= fanout; ++r) {
      const float* u = (r < fanout ? ul : ur) + (gh < H ? gh : 0) * ld;
      const float v = group_dot(xs + r * ld, u, d4, G, gq, gh < H);
      if (gq == 0 && gh < H) sc[r * H + gh] = g_round(v, (T*)nullptr);
    }
    __syncwarp();
    // LeakyReLU and the keep factors, all (lane, head) pairs at once
    for (int t = lane; t < fanout * H; t += 32) {
      const int f = t / H, h = t - f * H;
      const int64_t idx = ((int64_t)f * F + i) * H + h;
      const float pre = sc[t] + sc[fanout * H + h];
      const bool ng = pre < 0.0f;
      neg[idx] = ng;
      a[t] = ng ? pre * slope : pre;
      kp[t] = mask == nullptr ? 1.0f : (mask[idx] ? scale : 0.0f);
    }
    __syncwarp();
    if (lane < H) {                            // softmax over f, per head
      const int h = lane;
      float m = -INFINITY;
      for (int f = 0; f < fanout; ++f)
        if (vl[f] != 0.0f) m = fmaxf(m, a[f * H + h]);
      float sum = 0.0f;
      for (int f = 0; f < fanout; ++f) {
        const float e = vl[f] != 0.0f ? expf(a[f * H + h] - m) : 0.0f;
        a[f * H + h] = e;
        sum += e;
      }
      const float den = fmaxf(sum, 1.17549435e-38f);
      for (int f = 0; f < fanout; ++f) {
        const float p = a[f * H + h] / den;
        alpha_pre[((int64_t)f * F + i) * H + h] = p;
        a[f * H + h] = g_round(p * kp[f * H + h], (T*)nullptr);
      }
    }
    __syncwarp();
    // xw[i, h, 4c:4c+4] = sum_f a[f, h] x[f, 4c:4c+4]; invalid lanes have
    // alpha 0
    T* out = xw + i * H * d_in;
    for (int h = 0; h < H; ++h) {
      for (int c = lane; c < d4; c += 32) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int f = 0; f < fanout; ++f) {
          const float p = a[f * H + h];
          const float4 v = s_ld4(xs + f * ld + 4 * c);
          acc.x += p * v.x; acc.y += p * v.y;
          acc.z += p * v.z; acc.w += p * v.w;
        }
        T* o = out + h * d_in + 4 * c;
        if (vec) {
          g_st4(o, acc);
        } else {
          const float r[4] = {acc.x, acc.y, acc.z, acc.w};
          for (int e = 0; e < 4 && 4 * c + e < d_in; ++e) g_st(o + e, r[e]);
        }
      }
    }
    __syncwarp();
  }
}

struct BwdSmem {
  static __host__ __device__ size_t warp_floats(int fanout, int H, int ld) {
    return round4((size_t)(fanout + H) * ld + 4 * (size_t)fanout * H
                  + fanout);
  }
};

template <typename T>
__global__ void __launch_bounds__(kGatWarps * 32, 2) gat_attend_bwd_kernel(
    const T* __restrict__ dxw, const T* __restrict__ x,
    const int32_t* __restrict__ src, const float* __restrict__ alpha_pre,
    const uint8_t* __restrict__ neg, const uint8_t* __restrict__ mask,
    float scale, float slope, float* __restrict__ d_el,
    float* __restrict__ d_er, int64_t F, int fanout, int H, int d_in,
    int64_t aligned, bool vec) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int G = group_lanes(H);
  const int ld = row_ld(d_in, G);
  const int d4 = (d_in + 3) >> 2;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = sm + warp * BwdSmem::warp_floats(fanout, H, ld);
  float* g = xs + fanout * ld;                 // [H, ld]
  float* da = g + H * ld;                      // [fanout, H]
  float* p = da + fanout * H;                  // [fanout, H] alpha
  float* kp = p + fanout * H;                  // [fanout, H] keep factor
  float* sl = kp + fanout * H;                 // [fanout, H] LeakyReLU'
  float* vl = sl + fanout * H;                 // [fanout] lane valid
  const int gh = lane / G, gq = lane - gh * G;
  for (int64_t i = (int64_t)blockIdx.x * warps + warp; i < F;
       i += (int64_t)gridDim.x * warps) {
    for (int f = lane; f < fanout; f += 32) vl[f] = src[f * F + i] >= 0;
    for (int t = lane; t < fanout * H; t += 32) {
      const int64_t idx = ((int64_t)(t / H) * F + i) * H + t % H;
      p[t] = alpha_pre[idx];
      kp[t] = mask == nullptr ? 1.0f : (mask[idx] ? scale : 0.0f);
      sl[t] = neg[idx] ? slope : 1.0f;
    }
    stage_rows(x, [&](int r) { return aligned + (int64_t)r * F + i; },
               fanout, d_in, vec, xs, ld, lane);
    stage_rows(dxw, [&](int h) { return i * H + h; }, H, d_in, vec, g, ld,
               lane);
    __syncwarp();
    // d alpha after dropout: <dxw[i, h, :], x[f, i, :]>, rounded to T
    for (int f = 0; f < fanout; ++f) {
      const float v = group_dot(g + (gh < H ? gh : 0) * ld, xs + f * ld, d4,
                                G, gq, gh < H && vl[f] != 0.0f);
      if (gq == 0 && gh < H) da[f * H + gh] = g_round(v, (T*)nullptr);
    }
    __syncwarp();
    if (lane < H) {
      const int h = lane;
      float s = 0.0f;
      for (int f = 0; f < fanout; ++f) {
        da[f * H + h] *= kp[f * H + h];        // d alpha before dropout
        s += p[f * H + h] * da[f * H + h];
      }
      float der = 0.0f;
      for (int f = 0; f < fanout; ++f) {
        const float dpre = p[f * H + h] * (da[f * H + h] - s)
                           * sl[f * H + h];
        d_el[((int64_t)f * F + i) * H + h] = dpre;
        der += dpre;
      }
      d_er[i * H + h] = der;
    }
    __syncwarp();
  }
}

// Warps per block that fit the shared memory (at most kGatWarps; 0 when
// not even one does), and the dynamic shared bytes for them.
static int fit_warps(size_t block_floats, size_t warp_floats, size_t* smem) {
  for (int w = kGatWarps; w > 0; --w) {
    *smem = sizeof(float) * (block_floats + w * warp_floats);
    if (*smem <= (size_t)kMaxSmem) return w;
  }
  return 0;
}

template <typename K>
static int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)cudaSuccess;
}

// Whether rows of x (and dxw or xw) can be moved four elements at a time.
template <typename T>
static bool vec_ok(int d_in, const void* a, const void* b) {
  const uintptr_t al = 4 * sizeof(T);
  return d_in % 4 == 0 && (uintptr_t)a % al == 0 && (uintptr_t)b % al == 0;
}

// Enough blocks of `warps` rows to fill the card; warps walk the rest.
static unsigned int row_blocks(int64_t F, int warps) {
  const int64_t blocks = (F + warps - 1) / warps;
  const int64_t cap = 132 * 16;
  return (unsigned int)(blocks < cap ? blocks : cap);
}

template <typename T>
static int launch_fwd(const void* x, const void* u_l, const void* u_r,
                      const int32_t* src, const int32_t* hop_offset,
                      const uint8_t* mask, float scale, float slope,
                      void* xw, float* alpha_pre, uint8_t* neg, int64_t F,
                      int fanout, int H, int d_in, int64_t aligned,
                      void* stream) {
  if (F == 0) return (int)cudaSuccess;
  const int ld = row_ld(d_in, group_lanes(H));
  size_t smem = 0;
  const int warps = fit_warps(FwdSmem::block_floats(ld, H),
                              FwdSmem::warp_floats(fanout, H, ld), &smem);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  int rc = prepare(gat_attend_fwd_kernel<T>, smem);
  if (rc != 0) return rc;
  gat_attend_fwd_kernel<T><<<row_blocks(F, warps), warps * 32, smem,
                             (cudaStream_t)stream>>>(
      (const T*)x, (const T*)u_l, (const T*)u_r, src, hop_offset, mask,
      scale, slope, (T*)xw, alpha_pre, neg, F, fanout, H, d_in, aligned,
      vec_ok<T>(d_in, x, xw));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd(const void* dxw, const void* x, const int32_t* src,
                      const float* alpha_pre, const uint8_t* neg,
                      const uint8_t* mask, float scale, float slope,
                      float* d_el, float* d_er, int64_t F, int fanout, int H,
                      int d_in, int64_t aligned, void* stream) {
  if (F == 0) return (int)cudaSuccess;
  const int ld = row_ld(d_in, group_lanes(H));
  size_t smem = 0;
  const int warps = fit_warps(0, BwdSmem::warp_floats(fanout, H, ld), &smem);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  int rc = prepare(gat_attend_bwd_kernel<T>, smem);
  if (rc != 0) return rc;
  gat_attend_bwd_kernel<T><<<row_blocks(F, warps), warps * 32, smem,
                             (cudaStream_t)stream>>>(
      (const T*)dxw, (const T*)x, src, alpha_pre, neg, mask, scale, slope,
      d_el, d_er, F, fanout, H, d_in, aligned, vec_ok<T>(d_in, x, dxw));
  return (int)cudaGetLastError();
}

// x [N, d_in], u_l/u_r [d_in, H], xw [F, H, d_in], all of x's dtype
// (is_bf16); mask may be null (no dropout).
LT_EXPORT int lt_gat_attend_fwd(const void* x, const void* u_l,
                                const void* u_r, const int32_t* src,
                                const int32_t* hop_offset,
                                const uint8_t* mask, float scale, float slope,
                                void* xw, float* alpha_pre, uint8_t* neg,
                                int64_t F, int fanout, int H, int d_in,
                                int64_t aligned, int is_bf16, void* stream) {
  if (fanout > kGatMaxFanout || H > kGatMaxHeads)
    return (int)cudaErrorInvalidValue;
  return is_bf16
      ? launch_fwd<__nv_bfloat16>(x, u_l, u_r, src, hop_offset, mask, scale,
                                  slope, xw, alpha_pre, neg, F, fanout, H,
                                  d_in, aligned, stream)
      : launch_fwd<float>(x, u_l, u_r, src, hop_offset, mask, scale, slope,
                          xw, alpha_pre, neg, F, fanout, H, d_in, aligned,
                          stream);
}

LT_EXPORT int lt_gat_attend_bwd(const void* dxw, const void* x,
                                const int32_t* src, const float* alpha_pre,
                                const uint8_t* neg, const uint8_t* mask,
                                float scale, float slope, float* d_el,
                                float* d_er, int64_t F, int fanout, int H,
                                int d_in, int64_t aligned, int is_bf16,
                                void* stream) {
  if (fanout > kGatMaxFanout || H > kGatMaxHeads)
    return (int)cudaErrorInvalidValue;
  return is_bf16
      ? launch_bwd<__nv_bfloat16>(dxw, x, src, alpha_pre, neg, mask, scale,
                                  slope, d_el, d_er, F, fanout, H, d_in,
                                  aligned, stream)
      : launch_bwd<float>(dxw, x, src, alpha_pre, neg, mask, scale, slope,
                          d_el, d_er, F, fanout, H, d_in, aligned, stream);
}
