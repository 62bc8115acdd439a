// K15 hop_mean: the per-destination sum (or mean) and count of a hop's
// valid neighbour rows, placed at the hop's offset of a zeroed output.
//
// Replaces legion_tpu/ops/hop_agg.py::hop_neighbor_sum / hop_neighbor_mean
// and place_rows (XLA on the TPU), with, on the aligned last hop over the
// device feature table, legion_tpu/cache/unified_cache.py::
// DeviceFeatureSource.fetch (:221). There XLA sums the fetched rows where
// it gathers them and never writes them; the port's parent wrote every
// fetched row (K1), then read them back through a masked `where`, a `sum`,
// a zero fill and an `index_copy`.
//
// Layout (the sampler's fanout-major lanes): lane f*F + i is draw f of
// frontier slot i; it is valid iff src[lane] >= 0. The row of a valid lane
// is, by form:
//   (a) gathered:  rows[src[lane]]          (src clamped to the last row)
//   (b) aligned:   rows[aligned + lane]
//   (c) fetched:   rows[ids[lane]]          (ids already offset by the
//                  hop's aligned position; an id < 0 is a zero row that
//                  still counts, an id past the table clamps, as K1)
// out[offset + i] = sum (or sum / max(count, 1)) of slot i's valid rows in
// f32, count[offset + i] = their number; every other row of out and count
// is written with zeros. offset is a device scalar, read here (no host
// sync) and clamped to [0, num_dst - F] as JAX's dynamic_update_slice
// clamps its start.
//
// Bound on this card: device-memory bytes. Each valid lane costs one row
// read (256 B for a 128-wide bf16 row); src (and ids) are read once; out
// is written once in f32. There is no arithmetic to speak of.
//
// Design: a warp a destination slot (8 a block). The lanes of the warp
// read the slot's src entries (one a lane, 32 draws at a time) and work
// out each draw's row; a draw's row moves to the threads that load it by
// a shuffle. A row is read as 16-, 8-, 4- or 2-byte pieces, the widest the
// row width and the base's alignment allow (K4's 100-wide bf16 rows are
// 200 bytes at 8-byte alignment: 8-byte pieces). A row of c pieces takes
// the least power of two >= c threads (at most 32), so a warp reads 32 /
// that many draws at once, four rounds of them in flight; the groups'
// partial sums meet by shuffles, and the first group stores. A slot past
// the hop's F is a zero row of out instead, so that the launch covers
// num_dst warps in all.
//
// The backward of (b) is here too: d rows[aligned + lane] = d out[offset +
// lane % F] (divided by max(count, 1) for the mean), zero for a pad lane,
// rounded once to the rows' dtype; every lane owns its row, no atomics.
// The backward of (a) is K2 in its lane form (segment_sum.cu).
#include <cuda_bf16.h>

#include "common.cuh"

constexpr int kWarps = kThreads / 32;  // destination slots of a block
constexpr int kRounds = 4;             // rounds of draws in flight a warp

// BYTES bytes at p as 32-bit words (a 2-byte piece in the low half).
template <int BYTES>
__device__ __forceinline__ void load_piece(const void* p, uint32_t* w) {
  if constexpr (BYTES == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (BYTES == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (BYTES == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// acc += the piece's values as floats (a 32-bit word holds two bf16, the
// low half first).
template <typename T, int BYTES>
__device__ __forceinline__ void add_piece(float* acc, const uint32_t* w) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < BYTES / 4; ++k) acc[k] += __uint_as_float(w[k]);
  } else if constexpr (BYTES == 2) {
    acc[0] += __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int k = 0; k < BYTES / 4; ++k) {
      acc[2 * k] += __uint_as_float(w[k] << 16);
      acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// n floats at p, as one store where n allows (out rows are 16-byte
// aligned at a width that is a multiple of 4, and a piece of n floats
// starts at a multiple of n).
template <int N>
__device__ __forceinline__ void store_floats(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The hop's offset, clamped as JAX clamps a dynamic_update_slice.
__device__ __forceinline__ int64_t placed_offset(const int32_t* hop_offset,
                                                 int64_t F,
                                                 int64_t num_dst) {
  const int64_t o = *hop_offset;
  return o < 0 ? 0 : (o > num_dst - F ? num_dst - F : o);
}

// tshift: log2 of the threads of a row.
template <typename T, int BYTES>
__global__ void __launch_bounds__(kThreads) hop_mean_kernel(
    const T* __restrict__ rows, int64_t num_rows, int d,
    const int32_t* __restrict__ src, const int32_t* __restrict__ ids,
    int64_t aligned, const int32_t* __restrict__ hop_offset, int64_t F,
    int fanout, int64_t num_dst, int mean, int tshift,
    float* __restrict__ out, float* __restrict__ count) {
  constexpr int kElems = BYTES / (int)sizeof(T);   // values of a piece
  constexpr int kWords = BYTES < 4 ? 1 : BYTES / 4;
  const int lane = threadIdx.x & 31;
  const int tpr = 1 << tshift;
  const int t = lane & (tpr - 1);    // this thread's piece of a row
  const int g = lane >> tshift;      // its group: draws g, g + G, ...
  const int G = 32 >> tshift;
  const int cpr = d / kElems;        // pieces of a row
  const int64_t offset = placed_offset(hop_offset, F, num_dst);
  for (int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < num_dst; w += (int64_t)gridDim.x * kWarps) {
    if (w >= F) {
      // the (w - F)-th row of out outside [offset, offset + F): zeros
      const int64_t j = w - F;
      const int64_t r = j < offset ? j : j + F;
      for (int c = lane; c < d; c += 32) out[r * d + c] = 0.0f;
      if (lane == 0) count[r] = 0.0f;
      continue;
    }
    const int64_t i = w;
    const int64_t dst = offset + i;
    int n_valid = 0;
    for (int c0 = 0; c0 < cpr; c0 += tpr) {
      const int c = c0 + t;
      const bool live = c < cpr;
      float acc[kElems];
#pragma unroll
      for (int k = 0; k < kElems; ++k) acc[k] = 0.0f;
      n_valid = 0;
      for (int f0 = 0; f0 < fanout; f0 += 32) {
        const int nf = min(32, fanout - f0);
        // lane j: the row of draw f0 + j, or -1 (a pad, or a zero row)
        long long row = -1;
        bool valid = false;
        if (lane < nf) {
          const int64_t e = (int64_t)(f0 + lane) * F + i;
          const int32_t s = src[e];
          valid = s >= 0;
          if (valid) {
            if (ids != nullptr) {
              const int32_t v = ids[e];
              row = v < 0 ? -1 : (v < num_rows ? v : num_rows - 1);
            } else if (aligned >= 0) {
              row = aligned + e;
            } else {
              row = s < num_rows ? s : num_rows - 1;
            }
          }
        }
        n_valid += __popc(__ballot_sync(0xffffffffu, valid));
        for (int fb = 0; fb < nf; fb += G * kRounds) {
          long long r[kRounds];
#pragma unroll
          for (int u = 0; u < kRounds; ++u) {
            const int f = fb + u * G + g;
            r[u] = __shfl_sync(0xffffffffu, row, f & 31);
            if (f >= nf || !live) r[u] = -1;
          }
          uint32_t piece[kRounds][kWords];
#pragma unroll
          for (int u = 0; u < kRounds; ++u)
            if (r[u] >= 0)
              load_piece<BYTES>(rows + r[u] * d + (int64_t)c * kElems,
                                piece[u]);
#pragma unroll
          for (int u = 0; u < kRounds; ++u)
            if (r[u] >= 0) add_piece<T, BYTES>(acc, piece[u]);
        }
      }
      // the groups' partial sums meet
      for (int o = tpr; o < 32; o <<= 1) {
#pragma unroll
        for (int k = 0; k < kElems; ++k)
          acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
      }
      if (g == 0 && live) {
        if (mean) {
          const float den = (float)max(n_valid, 1);
#pragma unroll
          for (int k = 0; k < kElems; ++k) acc[k] = acc[k] / den;
        }
        store_floats<kElems>(out + dst * d + (int64_t)c * kElems, acc);
      }
    }
    if (lane == 0) count[dst] = (float)n_valid;
  }
}

template <typename T>
__global__ void hop_mean_bwd_kernel(
    const float* __restrict__ dout, const float* __restrict__ count,
    const int32_t* __restrict__ src, const int32_t* __restrict__ hop_offset,
    int64_t F, int64_t E, int d, int64_t aligned, int64_t num_dst, int mean,
    T* __restrict__ drows) {
  const int64_t offset = placed_offset(hop_offset, F, num_dst);
  const int64_t total = E * d;
  for (int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       x < total; x += (int64_t)gridDim.x * blockDim.x) {
    const int64_t lane = x / d;
    const int c = (int)(x - lane * d);
    float v = 0.0f;
    if (src[lane] >= 0) {
      const int64_t dst = offset + lane % F;
      v = dout[dst * d + c];
      if (mean) v = v / fmaxf(count[dst], 1.0f);
    }
    if constexpr (sizeof(T) == 4)
      drows[(aligned + lane) * d + c] = v;
    else
      drows[(aligned + lane) * d + c] = __float2bfloat16_rn(v);
  }
}

template <typename T, int BYTES>
static int launch(const T* rows, int64_t num_rows, int64_t d,
                  const int32_t* src, const int32_t* ids, int64_t aligned,
                  const int32_t* hop_offset, int64_t F, int fanout,
                  int64_t num_dst, int mean, float* out, float* count,
                  cudaStream_t stream) {
  const int cpr = (int)(d / (BYTES / (int)sizeof(T)));
  int tshift = 0;
  while ((1 << tshift) < cpr && tshift < 5) ++tshift;
  int64_t blocks = (num_dst + kWarps - 1) / kWarps;
  const int64_t cap = 132 * 32;
  if (blocks > cap) blocks = cap;
  hop_mean_kernel<T, BYTES><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      rows, num_rows, (int)d, src, ids, aligned, hop_offset, F, fanout,
      num_dst, mean, tshift, out, count);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_widest(const T* rows, int64_t num_rows, int64_t d,
                         const int32_t* src, const int32_t* ids,
                         int64_t aligned, const int32_t* hop_offset,
                         int64_t F, int fanout, int64_t num_dst, int mean,
                         float* out, float* count, cudaStream_t s) {
  const int64_t row_bytes = d * (int64_t)sizeof(T);
  const uintptr_t base = (uintptr_t)rows;
#define LT_HOP_MEAN(B)                                                   \
  if (row_bytes % (B) == 0 && base % (B) == 0)                           \
    return launch<T, (B)>(rows, num_rows, d, src, ids, aligned, hop_offset, \
                          F, fanout, num_dst, mean, out, count, s);
  LT_HOP_MEAN(16)
  LT_HOP_MEAN(8)
  LT_HOP_MEAN(4)
#undef LT_HOP_MEAN
  if constexpr (sizeof(T) == 2)
    return launch<T, 2>(rows, num_rows, d, src, ids, aligned, hop_offset, F,
                        fanout, num_dst, mean, out, count, s);
  return (int)cudaErrorMisalignedAddress;
}

// rows [num_rows, d] contiguous, bf16 (bf16 != 0) or f32; src [fanout * F]
// int32; ids [fanout * F] int32 or null (form (c)); aligned >= 0 for form
// (b), -1 otherwise; hop_offset a device int32 scalar; out [num_dst, d]
// and count [num_dst] f32, both written whole. num_dst >= F.
LT_EXPORT int lt_hop_mean(const void* rows, int64_t num_rows, int64_t d,
                          int bf16, const int32_t* src, const int32_t* ids,
                          int64_t aligned, const int32_t* hop_offset,
                          int64_t F, int fanout, int64_t num_dst, int mean,
                          float* out, float* count, void* stream) {
  if (num_dst == 0 || d == 0) return (int)cudaSuccess;
  if (F > num_dst || fanout <= 0 || num_rows <= 0 || d > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_widest<__nv_bfloat16>(
        (const __nv_bfloat16*)rows, num_rows, d, src, ids, aligned,
        hop_offset, F, fanout, num_dst, mean, out, count, s);
  return launch_widest<float>((const float*)rows, num_rows, d, src, ids,
                              aligned, hop_offset, F, fanout, num_dst, mean,
                              out, count, s);
}

// Form (b)'s backward: drows [*, d] in the rows' dtype, zeroed by the
// caller; lanes [aligned, aligned + E) are written.
LT_EXPORT int lt_hop_mean_bwd(const float* dout, const float* count,
                              const int32_t* src, const int32_t* hop_offset,
                              int64_t F, int64_t E, int64_t d,
                              int64_t aligned, int64_t num_dst, int mean,
                              void* drows, int bf16, void* stream) {
  if (E == 0 || d == 0) return (int)cudaSuccess;
  if (F > num_dst || d > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = lt_grid(E * d);
  if (bf16)
    hop_mean_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        dout, count, src, hop_offset, F, E, (int)d, aligned, num_dst, mean,
        (__nv_bfloat16*)drows);
  else
    hop_mean_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        dout, count, src, hop_offset, F, E, (int)d, aligned, num_dst, mean,
        (float*)drows);
  return (int)cudaGetLastError();
}
