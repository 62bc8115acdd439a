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
// Bound on this card: device-memory bytes. A row reads its fanout lanes and
// its destination (d_in wide each) and writes [H, d_in]; at 10 lanes, 8
// heads and 128 bf16 columns that is 5.3 KB a row against about 41 kFLOP,
// so the arithmetic has to stay out of the loads' way.
//
// Design, bf16 with H <= 8 and fanout <= 15, at d_in = 128 (the Device
// path's padded table) or at a width of 4 to 112 in steps of 4 (GAT on a
// host dataset fetches its cached rows 100 wide, unpadded). The kernels
// take the staged width D as a template constant: 128 (the exact form,
// d_in == D) and 112 (the padded form: the columns from d_in to D are
// zero in the ring and in u, and the products take ceil(d_in / 16) k
// steps of mma's 16). One warp per frontier row i, persistent, eight warps
// a block.
//   - A warp keeps kMmaStages row sets in flight in its own ring in shared
//     memory, staged in bf16 by cp.async: 16-byte copies at 128; in the
//     padded form a 16-byte-aligned row by 16-byte copies and its last 8
//     bytes by one 8-byte copy, any other row (every second 200-byte row
//     of a 100-wide table) by 8-byte copies. The loads of rows i + stride
//     and i + 2 stride run under the arithmetic of row i. The
//     per-row flags (lane validity, the dropout keep bits; in the backward
//     also alpha and the LeakyReLU sign) are loaded, or drawn after the
//     loads are issued, one row ahead into registers.
//   - Both small products run on the tensor cores (mma.sync m16n8k16, bf16
//     in, f32 accumulation). Scores: [u_l | u_r]^T (16 rows = 8 + 8 heads,
//     held in registers for the whole kernel) times the staged rows (B from
//     ldmatrix); its accumulator is laid out as the A operand of the
//     contraction alpha [heads, fanout] x rows [fanout, d_in] (B from
//     ldmatrix.trans), so alpha never leaves registers. The softmax over
//     the fanout is four values a lane and two shuffles.
//   - xw goes back through the warp's consumed stage and out as 16-byte
//     stores (8-byte stores that stop at column d_in in the padded form).
// The backward kernel has the same ring (lanes and dxw[i]) and takes
// d alpha = dxw[i] x rows^T on the tensor cores.
//
// Every other shape and f32 take the general kernels below: one warp per
// row, the row staged once as f32 in shared memory (zero-padded to a
// multiple of four, strided by ld, a multiple of 32 plus 4G when G < 8, so
// that the head groups' 16-byte reads land in distinct banks), scores by
// head groups of G = 32 / H' lanes with shuffles, the contraction four
// columns a lane.
//
// Rounding mirrors the JAX layer: the scores el, er are f32 dot products
// rounded to x's dtype (JAX's x @ u in bf16), then widened; alpha after
// dropout is rounded to x's dtype before the contraction (gat.py:97-99),
// and so is d alpha in the backward (the transpose of that contraction in
// x's dtype); xw is accumulated in f32 and stored in x's dtype.
//
// Attention dropout (legion_tpu/models/gat.py:94) is drawn in the kernels:
// the keep bit of (lane, head) at alpha's index e = (f*F + i)*H + h is
// keep_lane of the step's dropout key folded with the layer's fold
// (dropout.cuh; regime 2 at GAT's layer 0, whose alpha has more than 2^20
// entries), and the backward draws it again: no mask is read or stored. A
// kept alpha is divided by keep in f32 (times 256 / kq in regime 2) before
// its rounding to x's dtype, and a kept d alpha likewise after its rounding,
// as JAX's dropout and its transpose take them. In the tensor-core forms a
// lane draws the bits of its four (lane, head) pairs of head g (none past
// H) where it loads the row's flags.
//
// Saved for the backward: alpha before dropout [fanout, F, H] f32 and the
// sign of the pre-activation (u8, 1 where el + er < 0).
#include <cuda_bf16.h>

#include "dropout.cuh"

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
    const int32_t* __restrict__ hop_offset, const DropArgs dargs, float slope,
    T* __restrict__ xw, float* __restrict__ alpha_pre,
    uint8_t* __restrict__ neg, int64_t F, int fanout, int H, int d_in,
    int64_t aligned, bool vec) {
  extern __shared__ float4 sm4[];
  const Drop drop = make_drop(dargs);
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
  float* kp = a + fanout * H;                  // [fanout, H] kept: 1 or 0
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
    // LeakyReLU and the keep bits, all (lane, head) pairs at once
    for (int t = lane; t < fanout * H; t += 32) {
      const int f = t / H, h = t - f * H;
      const int64_t idx = ((int64_t)f * F + i) * H + h;
      const float pre = sc[t] + sc[fanout * H + h];
      const bool ng = pre < 0.0f;
      neg[idx] = ng;
      a[t] = ng ? pre * slope : pre;
      kp[t] = keep_lane(drop, (uint32_t)idx) ? 1.0f : 0.0f;
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
        a[f * H + h] =
            g_round(drop_f32(drop, kp[f * H + h] != 0.0f, p), (T*)nullptr);
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
    const uint8_t* __restrict__ neg, const DropArgs dargs, float slope,
    float* __restrict__ d_el, float* __restrict__ d_er, int64_t F,
    int fanout, int H, int d_in, int64_t aligned, bool vec) {
  extern __shared__ float4 sm4[];
  const Drop drop = make_drop(dargs);
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
  float* kp = p + fanout * H;                  // [fanout, H] kept: 1 or 0
  float* sl = kp + fanout * H;                 // [fanout, H] LeakyReLU'
  float* vl = sl + fanout * H;                 // [fanout] lane valid
  const int gh = lane / G, gq = lane - gh * G;
  for (int64_t i = (int64_t)blockIdx.x * warps + warp; i < F;
       i += (int64_t)gridDim.x * warps) {
    for (int f = lane; f < fanout; f += 32) vl[f] = src[f * F + i] >= 0;
    for (int t = lane; t < fanout * H; t += 32) {
      const int64_t idx = ((int64_t)(t / H) * F + i) * H + t % H;
      p[t] = alpha_pre[idx];
      kp[t] = keep_lane(drop, (uint32_t)idx) ? 1.0f : 0.0f;
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
        // d alpha before dropout
        da[f * H + h] = drop_f32(drop, kp[f * H + h] != 0.0f, da[f * H + h]);
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

// ---------------------------------------------------------------------------
// bf16 tensor-core path (see the header)
// ---------------------------------------------------------------------------

constexpr int kMmaStages = 3;     // row sets in flight per warp
constexpr int kMmaPad = 8;        // bf16 of padding a staged row: ldmatrix's
                                  // eight rows then fall in distinct banks
constexpr int kMmaMaxFanout = 15; // fanout lanes + the destination: 16 rows
constexpr int kMmaMaxHeads = 8;
constexpr int kMmaWidth = 128;    // the exact form's d_in (the Device path)
constexpr int kMmaPadWidth = 112; // the padded form's staged width: d_in of
                                  // 4 to 112 in steps of 4 (GAT-H's 100)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
// d += a [16 x 16, row-major] * b [16 x 8, column-major], bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two f32 as one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A lane (g = lane / 4, q = lane % 4) of an accumulator holds head g and
// the four fanout lanes lane_f(q, 0..3).
__device__ __forceinline__ int lane_f(int q, int t) {
  return 2 * q + (t & 1) + 8 * (t >> 1);
}

// The shared bytes of one stage of `rows` rows of D bf16.
template <int D>
__host__ __device__ constexpr int stage_bytes(int rows) {
  return rows * (D + kMmaPad) * 2;
}

// Rows row_of(0 .. rows-1) of x (d_in wide) into the stage. The exact form
// (d_in == D, rows 16-byte aligned) moves 16 bytes a copy. The padded form
// takes a row at a time, a copy a lane: a 16-byte-aligned row by 16-byte
// copies and, where d_in is not a multiple of 8, its last 8 bytes by an
// 8-byte copy; any other row (8-byte aligned) by 8-byte copies. Columns
// d_in .. D of the stage are left as they are (zero, ``zero_pad``).
template <int D, bool kPad, typename RowOf>
__device__ __forceinline__ void stage_async(RowOf row_of, int rows, int d_in,
                                            __nv_bfloat16* st, int lane) {
  constexpr int LD = D + kMmaPad;
  if constexpr (!kPad) {
    constexpr int kChunks = D / 8;
    for (int c = lane; c < rows * kChunks; c += 32) {
      const int r = c / kChunks, k = c - r * kChunks;
      cp_async16(st + r * LD + 8 * k, row_of(r) + 8 * k);
    }
  } else {
    const int n16 = d_in >> 3, n8 = d_in >> 2;
    for (int r = 0; r < rows; ++r) {
      const __nv_bfloat16* src = row_of(r);
      __nv_bfloat16* dst = st + r * LD;
      if (((uintptr_t)src & 15) == 0) {
        if (lane < n16)
          cp_async16(dst + 8 * lane, src + 8 * lane);
        else if (lane == n16 && (n8 & 1))
          cp_async8(dst + 8 * lane, src + 8 * lane);
      } else if (lane < n8) {
        cp_async8(dst + 4 * lane, src + 4 * lane);
      }
    }
  }
}

// The padded form: zero columns d_in .. D of the warp's ring of `rows`
// rows (d_in a multiple of 4). No copy or store writes them after, so
// the k steps past d_in and the contraction's columns past it read zeros
// for the whole kernel.
template <int D>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* ring, int rows,
                                         int d_in, int lane) {
  constexpr int LD = D + kMmaPad;
  const int words = (D - d_in) >> 1;
  for (int t = lane; t < rows * words; t += 32) {
    const int r = t / words, k = t - r * words;
    reinterpret_cast<uint32_t*>(ring + r * LD + d_in)[k] = 0u;
  }
}

// What a lane needs of row i beside the staged rows, loaded a row ahead.
// keep: bit t is lane_f(q, t)'s keep bit at head g (1 past the fanout or
// H, and with no dropout).
struct FwdFlags {
  int32_t src[4];
  uint32_t keep;
};

// The four keep bits of head g at row i, drawn after the row's loads are
// issued, in one word: the two rows in flight then hold two registers for
// them. The exact form's forward sits at 126 of its 128 registers: a byte
// a bit drawn between the loads, or a branch on the regime here, made it
// spill, and its forward ran 27-36% slower.
__device__ __forceinline__ uint32_t keep_bits4(const Drop& drop, int64_t i,
                                               int64_t F, int fanout, int H,
                                               int g, int q) {
  uint32_t keep = 0xFu;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int f = lane_f(q, t);
    if (f < fanout && g < H &&
        !keep_lane(drop, (uint32_t)(((int64_t)f * F + i) * H + g)))
      keep &= ~(1u << t);
  }
  return keep;
}

__device__ __forceinline__ void load_flags(
    FwdFlags& fl, const int32_t* __restrict__ src, const Drop& drop,
    int64_t i, int64_t F, int fanout, int H, int g, int q) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int f = lane_f(q, t);
    fl.src[t] = f < fanout ? src[(int64_t)f * F + i] : -1;
  }
  fl.keep = keep_bits4(drop, i, F, fanout, H, g, q);
}

// x's rows are dx wide (D in the exact form, d_in in the padded one); the
// products take ks_n k steps of 16 (KS, or ceil(d_in / 16)).
template <int D, bool kPad>
__global__ void __launch_bounds__(kGatWarps * 32, 2) gat_attend_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ u_l,
    const __nv_bfloat16* __restrict__ u_r, const int32_t* __restrict__ src,
    const int32_t* __restrict__ hop_offset, const DropArgs dargs, float slope,
    __nv_bfloat16* __restrict__ xw, float* __restrict__ alpha_pre,
    uint8_t* __restrict__ neg, int64_t F, int fanout, int H, int d_in,
    int64_t aligned) {
  constexpr int LD = D + kMmaPad, KS = D / 16, kChunks = D / 8;
  const Drop drop = make_drop(dargs);
  const int dx = kPad ? d_in : D;
  const int ks_n = kPad ? (d_in + 15) >> 4 : KS;
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* zero_row = reinterpret_cast<__nv_bfloat16*>(smem16);
  const int rows = max(fanout + 1, H);   // a stage also carries xw out
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  char* ring = reinterpret_cast<char*>(smem16) + stage_bytes<D>(1)
               + (size_t)warp * kMmaStages * stage_bytes<D>(rows);
  for (int t = threadIdx.x; t < LD; t += blockDim.x)
    zero_row[t] = __float2bfloat16(0.0f);
  if constexpr (kPad)
    zero_pad<D>(reinterpret_cast<__nv_bfloat16*>(ring), kMmaStages * rows,
                d_in, lane);
  // [u_l | u_r]^T as the A operand of every k step: rows 0-7 the heads of
  // u_l, rows 8-15 the heads of u_r; u is [d_in, H] row-major, zero past
  // d_in
  uint32_t ua[KS][4];
  {
    const uint16_t* ul = reinterpret_cast<const uint16_t*>(u_l);
    const uint16_t* ur = reinterpret_cast<const uint16_t*>(u_r);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k0 = 16 * ks + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = k0 + 8 * half;
        uint32_t l = 0, r = 0;
        if (g < H && (!kPad || k < d_in)) {
          l = (uint32_t)ul[k * H + g] | ((uint32_t)ul[(k + 1) * H + g] << 16);
          r = (uint32_t)ur[k * H + g] | ((uint32_t)ur[(k + 1) * H + g] << 16);
        }
        ua[ks][2 * half] = l;
        ua[ks][2 * half + 1] = r;
      }
    }
  }
  __syncthreads();
  const int64_t off = *hop_offset;
  const int64_t stride = (int64_t)gridDim.x * kGatWarps;
  const int64_t i0 = (int64_t)blockIdx.x * kGatWarps + warp;
  auto stage = [&](int64_t i, int slot) {
    stage_async<D, kPad>([&](int r) {
      return x + (r < fanout ? aligned + (int64_t)r * F + i : off + i) * dx;
    }, fanout + 1, d_in, reinterpret_cast<__nv_bfloat16*>(
        ring + slot * stage_bytes<D>(rows)), lane);
  };
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (i0 + s * stride < F) stage(i0 + s * stride, s);
    cp_async_commit();
  }
  FwdFlags cur, nxt;
  if (i0 < F) load_flags(cur, src, drop, i0, F, fanout, H, g, q);
  // ldmatrix row addresses of this lane (matrix m = lane / 8, row lane % 8)
  const int lm = lane >> 3, lr = lane & 7;
  // scores' B operand: matrices (f 0-7, k 0-7), (f 0-7, k 8-15),
  // (f 8-15, k 0-7), (f 8-15, k 8-15); rows past the destination repeat it
  const int sc_row = min(lr + 8 * (lm >> 1), fanout);
  const int sc_off = (sc_row * LD + 8 * (lm & 1)) * 2;
  // contraction's B operand (transposed on load): matrices (f 0-7, n),
  // (f 8-15, n), (f 0-7, n + 8), (f 8-15, n + 8); rows past the fanout
  // are the zero row
  const int ct_row = lr + 8 * (lm & 1);
  const int ct_col = 8 * (lm >> 1);
  int slot = 0;
  for (int64_t i = i0; i < F; i += stride) {
    {
      const int64_t ahead = i + (kMmaStages - 1) * stride;
      if (ahead < F) stage(ahead, (slot + kMmaStages - 1) % kMmaStages);
      cp_async_commit();
    }
    if (i + stride < F)
      load_flags(nxt, src, drop, i + stride, F, fanout, H, g, q);
    cp_async_wait<kMmaStages - 1>();
    __syncwarp();
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(
        ring + slot * stage_bytes<D>(rows));
    // scores: s0 lanes 0-7, s1 lanes 8-15; [0], [1] against u_l (el),
    // [2], [3] against u_r (er, wanted for the destination row only)
    float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    {
      const uint32_t base = smem_u32(st) + sc_off;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks < ks_n) {
          uint32_t b[4];
          ldmatrix_x4(b, base + 32 * ks);
          mma_bf16(s0, ua[ks], b[0], b[1]);
          mma_bf16(s1, ua[ks], b[2], b[3]);
        }
      }
    }
    // er[g]: the u_r row of column `fanout`, held by lane (g, (fanout%8)/2)
    const float er_mine = (fanout & 8) ? ((fanout & 1) ? s1[3] : s1[2])
                                       : ((fanout & 1) ? s0[3] : s0[2]);
    const float er = round_bf16(__shfl_sync(
        0xffffffffu, er_mine, (lane & ~3) | ((fanout & 7) >> 1)));
    const float el[4] = {s0[0], s0[1], s1[0], s1[1]};
    float a[4];
    bool ng[4], valid[4];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float pre = round_bf16(el[t]) + er;
      ng[t] = pre < 0.0f;
      a[t] = ng[t] ? pre * slope : pre;
      valid[t] = cur.src[t] >= 0;
      if (valid[t]) m = fmaxf(m, a[t]);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      a[t] = valid[t] ? expf(a[t] - m) : 0.0f;
      sum += a[t];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1.17549435e-38f);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int f = lane_f(q, t);
      const float p = a[t] / den;
      if (f < fanout && g < H) {
        const int64_t idx = ((int64_t)f * F + i) * H + g;
        alpha_pre[idx] = p;
        neg[idx] = ng[t];
      }
      a[t] = round_bf16(drop_f32(drop, (cur.keep >> t) & 1u, p));
    }
    // contraction: alpha [heads 0-7 | none, lanes 0-15] x rows
    const uint32_t pa[4] = {pack_bf16(a[0], a[1]), 0u, pack_bf16(a[2], a[3]),
                            0u};
    uint32_t o[KS][2];
    {
      const uint32_t base = ct_row < fanout
          ? smem_u32(st) + (ct_row * LD + ct_col) * 2
          : smem_u32(zero_row) + ct_col * 2;
      // the zero row is one row: its columns past 8 wrap into the pad
      const uint32_t step = ct_row < fanout ? 32 : 0;
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        if (np < ks_n) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, base + step * np);
          float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(c0, pa, b[0], b[1]);
          mma_bf16(c1, pa, b[2], b[3]);
          o[np][0] = pack_bf16(c0[0], c0[1]);
          o[np][1] = pack_bf16(c1[0], c1[1]);
        }
      }
    }
    __syncwarp();
    // xw[i] through the consumed stage: head g, columns 16 np + 2q (+ 8);
    // the padded form leaves the columns past d_in zero
    if (g < H) {
      uint32_t* orow = reinterpret_cast<uint32_t*>(st + g * LD) + q;
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        if (np < ks_n) {
          const int col = 16 * np + 2 * q;
          if (!kPad || col < d_in) orow[8 * np] = o[np][0];
          if (!kPad || col + 8 < d_in) orow[8 * np + 4] = o[np][1];
        }
      }
    }
    __syncwarp();
    __nv_bfloat16* out = xw + i * H * dx;
    if constexpr (!kPad) {
      for (int c = lane; c < H * kChunks; c += 32) {
        const int h = c / kChunks, k = c - h * kChunks;
        *reinterpret_cast<uint4*>(out + h * D + 8 * k) =
            *reinterpret_cast<const uint4*>(st + h * LD + 8 * k);
      }
    } else {
      // [H, d_in] rows 8 bytes a lane, a head at a time
      if (lane < (d_in >> 2))
        for (int h = 0; h < H; ++h)
          *reinterpret_cast<uint2*>(out + h * d_in + 4 * lane) =
              *reinterpret_cast<const uint2*>(st + h * LD + 4 * lane);
    }
    __syncwarp();
    cur = nxt;
    slot = (slot + 1) % kMmaStages;
  }
}

struct BwdFlags {
  int32_t src[4];
  float p[4];
  uint32_t keep;
  uint8_t neg[4];
};

__device__ __forceinline__ void load_flags(
    BwdFlags& fl, const int32_t* __restrict__ src,
    const float* __restrict__ alpha_pre, const uint8_t* __restrict__ neg,
    const Drop& drop, int64_t i, int64_t F, int fanout, int H, int g,
    int q) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int f = lane_f(q, t);
    fl.src[t] = -1;
    fl.p[t] = 0.0f;
    fl.neg[t] = 0;
    if (f < fanout) {
      fl.src[t] = src[(int64_t)f * F + i];
      if (g < H) {
        const int64_t idx = ((int64_t)f * F + i) * H + g;
        fl.p[t] = alpha_pre[idx];
        fl.neg[t] = neg[idx];
      }
    }
  }
  fl.keep = keep_bits4(drop, i, F, fanout, H, g, q);
}

template <int D, bool kPad>
__global__ void __launch_bounds__(kGatWarps * 32, 2) gat_attend_bwd_mma_kernel(
    const __nv_bfloat16* __restrict__ dxw, const __nv_bfloat16* __restrict__ x,
    const int32_t* __restrict__ src, const float* __restrict__ alpha_pre,
    const uint8_t* __restrict__ neg, const DropArgs dargs, float slope,
    float* __restrict__ d_el, float* __restrict__ d_er, int64_t F,
    int fanout, int H, int d_in, int64_t aligned) {
  constexpr int LD = D + kMmaPad, KS = D / 16;
  const Drop drop = make_drop(dargs);
  const int dx = kPad ? d_in : D;
  const int ks_n = kPad ? (d_in + 15) >> 4 : KS;
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* zero_row = reinterpret_cast<__nv_bfloat16*>(smem16);
  const int rows = fanout + H;           // the lanes, then dxw[i]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  char* ring = reinterpret_cast<char*>(smem16) + stage_bytes<D>(1)
               + (size_t)warp * kMmaStages * stage_bytes<D>(rows);
  for (int t = threadIdx.x; t < LD; t += blockDim.x)
    zero_row[t] = __float2bfloat16(0.0f);
  if constexpr (kPad)
    zero_pad<D>(reinterpret_cast<__nv_bfloat16*>(ring), kMmaStages * rows,
                d_in, lane);
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kGatWarps;
  const int64_t i0 = (int64_t)blockIdx.x * kGatWarps + warp;
  auto stage = [&](int64_t i, int slot) {
    stage_async<D, kPad>([&](int r) {
      return r < fanout ? x + (aligned + (int64_t)r * F + i) * dx
                        : dxw + (i * H + (r - fanout)) * dx;
    }, rows, d_in, reinterpret_cast<__nv_bfloat16*>(
        ring + slot * stage_bytes<D>(rows)), lane);
  };
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (i0 + s * stride < F) stage(i0 + s * stride, s);
    cp_async_commit();
  }
  BwdFlags cur, nxt;
  if (i0 < F)
    load_flags(cur, src, alpha_pre, neg, drop, i0, F, fanout, H, g, q);
  const int lm = lane >> 3, lr = lane & 7;
  // A operand, dxw[i] [heads, k]: matrices (h 0-7, k 0-7), (h 8-15, k 0-7),
  // (h 0-7, k 8-15), (h 8-15, k 8-15); heads past H are the zero row
  const bool a_on = (lm & 1) == 0 && lr < H;
  const int a_off = ((fanout + lr) * LD + 8 * (lm >> 1)) * 2;
  // B operand, the lanes [k, f]: as the forward's scores, rows past the
  // fanout the zero row
  const int b_row = lr + 8 * (lm >> 1);
  const bool b_on = b_row < fanout;
  const int b_off = (b_row * LD + 8 * (lm & 1)) * 2;
  const uint32_t zero_at = smem_u32(zero_row);
  int slot = 0;
  for (int64_t i = i0; i < F; i += stride) {
    {
      const int64_t ahead = i + (kMmaStages - 1) * stride;
      if (ahead < F) stage(ahead, (slot + kMmaStages - 1) % kMmaStages);
      cp_async_commit();
    }
    if (i + stride < F)
      load_flags(nxt, src, alpha_pre, neg, drop, i + stride, F, fanout, H,
                 g, q);
    cp_async_wait<kMmaStages - 1>();
    __syncwarp();
    const uint32_t st = smem_u32(ring + slot * stage_bytes<D>(rows));
    // d alpha after dropout [head g, lanes]: d0 lanes 0-7, d1 lanes 8-15
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks < ks_n) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, a_on ? st + a_off + 32 * ks : zero_at);
        ldmatrix_x4(b, b_on ? st + b_off + 32 * ks : zero_at);
        mma_bf16(d0, a, b[0], b[1]);
        mma_bf16(d1, a, b[2], b[3]);
      }
    }
    const float dv[4] = {d0[0], d0[1], d1[0], d1[1]};
    float da[4];
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // d alpha after dropout rounded to bf16 as the products are, then
      // through dropout's backward
      da[t] = cur.src[t] >= 0
          ? drop_f32(drop, (cur.keep >> t) & 1u, round_bf16(dv[t])) : 0.0f;
      s += cur.p[t] * da[t];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    float der = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int f = lane_f(q, t);
      const float dpre = cur.p[t] * (da[t] - s) * (cur.neg[t] ? slope : 1.0f);
      if (f < fanout && g < H) d_el[((int64_t)f * F + i) * H + g] = dpre;
      der += dpre;
    }
    der += __shfl_xor_sync(0xffffffffu, der, 1);
    der += __shfl_xor_sync(0xffffffffu, der, 2);
    if (q == 0 && g < H) d_er[i * H + g] = der;
    __syncwarp();
    cur = nxt;
    slot = (slot + 1) % kMmaStages;
  }
}

// Which tensor-core form takes a call: kExact at d_in 128 with x and the
// other row tensor (xw or dxw) 16-byte aligned, kPadded at a width of 4 to
// 112 in steps of 4 with both 8-byte aligned, else kGeneral.
enum MmaForm { kGeneral, kExact, kPadded };
static MmaForm mma_form(int fanout, int H, int d_in, const void* a,
                        const void* b) {
  if (fanout > kMmaMaxFanout || H > kMmaMaxHeads) return kGeneral;
  const uintptr_t al = (uintptr_t)a | (uintptr_t)b;
  if (d_in == kMmaWidth && al % 16 == 0) return kExact;
  if (d_in > 0 && d_in <= kMmaPadWidth && d_in % 4 == 0 && al % 8 == 0)
    return kPadded;
  return kGeneral;
}

// Launch a persistent tensor-core kernel: as many blocks as stay resident.
template <typename K, typename... Args>
static int launch_mma(K kernel, size_t smem, int64_t F, void* stream,
                      Args... args) {
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kGatWarps * 32, smem);
  if (rc != 0) return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  int64_t blocks = (F + kGatWarps - 1) / kGatWarps;
  blocks = blocks < 132 * (int64_t)per_sm ? blocks : 132 * (int64_t)per_sm;
  kernel<<<(unsigned int)blocks, kGatWarps * 32, smem,
           (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
static size_t mma_smem(int rows) {
  return stage_bytes<D>(1)
         + (size_t)kGatWarps * kMmaStages * stage_bytes<D>(rows);
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
                      const DropArgs& drop, float slope, void* xw,
                      float* alpha_pre, uint8_t* neg, int64_t F, int fanout,
                      int H, int d_in, int64_t aligned, void* stream) {
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
      (const T*)x, (const T*)u_l, (const T*)u_r, src, hop_offset, drop,
      slope, (T*)xw, alpha_pre, neg, F, fanout, H, d_in, aligned,
      vec_ok<T>(d_in, x, xw));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd(const void* dxw, const void* x, const int32_t* src,
                      const float* alpha_pre, const uint8_t* neg,
                      const DropArgs& drop, float slope, float* d_el,
                      float* d_er, int64_t F, int fanout, int H, int d_in,
                      int64_t aligned, void* stream) {
  if (F == 0) return (int)cudaSuccess;
  const int ld = row_ld(d_in, group_lanes(H));
  size_t smem = 0;
  const int warps = fit_warps(0, BwdSmem::warp_floats(fanout, H, ld), &smem);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  int rc = prepare(gat_attend_bwd_kernel<T>, smem);
  if (rc != 0) return rc;
  gat_attend_bwd_kernel<T><<<row_blocks(F, warps), warps * 32, smem,
                             (cudaStream_t)stream>>>(
      (const T*)dxw, (const T*)x, src, alpha_pre, neg, drop, slope, d_el,
      d_er, F, fanout, H, d_in, aligned, vec_ok<T>(d_in, x, dxw));
  return (int)cudaGetLastError();
}

template <int D, bool kPad>
static int launch_fwd_mma(const void* x, const void* u_l, const void* u_r,
                          const int32_t* src, const int32_t* hop_offset,
                          const DropArgs& drop, float slope, void* xw,
                          float* alpha_pre, uint8_t* neg, int64_t F,
                          int fanout, int H, int d_in, int64_t aligned,
                          void* stream) {
  const int rows = fanout + 1 > H ? fanout + 1 : H;
  return launch_mma(gat_attend_fwd_mma_kernel<D, kPad>, mma_smem<D>(rows), F,
                    stream, (const __nv_bfloat16*)x,
                    (const __nv_bfloat16*)u_l, (const __nv_bfloat16*)u_r, src,
                    hop_offset, drop, slope, (__nv_bfloat16*)xw, alpha_pre,
                    neg, F, fanout, H, d_in, aligned);
}

template <int D, bool kPad>
static int launch_bwd_mma(const void* dxw, const void* x, const int32_t* src,
                          const float* alpha_pre, const uint8_t* neg,
                          const DropArgs& drop, float slope, float* d_el,
                          float* d_er, int64_t F, int fanout, int H,
                          int d_in, int64_t aligned, void* stream) {
  return launch_mma(gat_attend_bwd_mma_kernel<D, kPad>,
                    mma_smem<D>(fanout + H), F, stream,
                    (const __nv_bfloat16*)dxw, (const __nv_bfloat16*)x, src,
                    alpha_pre, neg, drop, slope, d_el, d_er, F, fanout, H,
                    d_in, aligned);
}

// x [N, d_in], u_l/u_r [d_in, H], xw [F, H, d_in], all of x's dtype
// (is_bf16). Attention dropout: words (the step's two dropout key words on
// the card), fold, regime (0: none; words may then be null), kq, keep and
// c as dropout.cuh takes them. general != 0 takes the general kernels where
// a tensor-core form would take the call (to time the two).
LT_EXPORT int lt_gat_attend_fwd(const void* x, const void* u_l,
                                const void* u_r, const int32_t* src,
                                const int32_t* hop_offset,
                                const int32_t* words, uint64_t fold,
                                int regime, uint32_t kq, float keep, float c,
                                float slope, void* xw, float* alpha_pre,
                                uint8_t* neg, int64_t F, int fanout, int H,
                                int d_in, int64_t aligned, int is_bf16,
                                int general, void* stream) {
  const DropArgs drop{words, fold, regime, kq, keep, c};
  if (fanout > kGatMaxFanout || H > kGatMaxHeads || bad_drop(drop))
    return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaSuccess;
  const MmaForm form = is_bf16 && !general
      ? mma_form(fanout, H, d_in, x, xw) : kGeneral;
  if (form == kExact)
    return launch_fwd_mma<kMmaWidth, false>(
        x, u_l, u_r, src, hop_offset, drop, slope, xw, alpha_pre, neg, F,
        fanout, H, d_in, aligned, stream);
  if (form == kPadded)
    return launch_fwd_mma<kMmaPadWidth, true>(
        x, u_l, u_r, src, hop_offset, drop, slope, xw, alpha_pre, neg, F,
        fanout, H, d_in, aligned, stream);
  return is_bf16
      ? launch_fwd<__nv_bfloat16>(x, u_l, u_r, src, hop_offset, drop, slope,
                                  xw, alpha_pre, neg, F, fanout, H, d_in,
                                  aligned, stream)
      : launch_fwd<float>(x, u_l, u_r, src, hop_offset, drop, slope, xw,
                          alpha_pre, neg, F, fanout, H, d_in, aligned,
                          stream);
}

LT_EXPORT int lt_gat_attend_bwd(const void* dxw, const void* x,
                                const int32_t* src, const float* alpha_pre,
                                const uint8_t* neg, const int32_t* words,
                                uint64_t fold, int regime, uint32_t kq,
                                float keep, float c, float slope,
                                float* d_el, float* d_er, int64_t F,
                                int fanout, int H, int d_in, int64_t aligned,
                                int is_bf16, int general, void* stream) {
  const DropArgs drop{words, fold, regime, kq, keep, c};
  if (fanout > kGatMaxFanout || H > kGatMaxHeads || bad_drop(drop))
    return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaSuccess;
  const MmaForm form = is_bf16 && !general
      ? mma_form(fanout, H, d_in, x, dxw) : kGeneral;
  if (form == kExact)
    return launch_bwd_mma<kMmaWidth, false>(
        dxw, x, src, alpha_pre, neg, drop, slope, d_el, d_er, F, fanout, H,
        d_in, aligned, stream);
  if (form == kPadded)
    return launch_bwd_mma<kMmaPadWidth, true>(
        dxw, x, src, alpha_pre, neg, drop, slope, d_el, d_er, F, fanout, H,
        d_in, aligned, stream);
  return is_bf16
      ? launch_bwd<__nv_bfloat16>(dxw, x, src, alpha_pre, neg, drop, slope,
                                  d_el, d_er, F, fanout, H, d_in, aligned,
                                  stream)
      : launch_bwd<float>(dxw, x, src, alpha_pre, neg, drop, slope, d_el,
                          d_er, F, fanout, H, d_in, aligned, stream);
}
