// K2 segment_sum: out[s] += data[e] for every e with seg[e] == s; lanes
// with seg[e] < 0 (or >= S) are dropped. data is [E, F] with a row stride
// of ld elements, out is [S, F] and must be zeroed by the caller: f32,
// bf16 or f16 data into an f32 out, f64 into f64, int32 into int32 (an
// exact sum that wraps modulo 2^32, as XLA's int32 scatter-add does; it
// equals JAX's bit for bit, whatever the order of the atomics).
//
// Replaces legion_tpu/ops/pallas_segment.py::segment_sum_pallas, which
// keeps the whole [S, F] f32 accumulator in VMEM across a sequential grid.
// Hopper runs blocks in parallel and in no order, so nothing can carry a
// sum from one block to the next: the rows are added with f32 atomics into
// device memory, which resolve in the L2.
//
// Bound on this card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 2):
// first the atomics that meet on one row, then the L2's misses. At the main
// path's shape (200,000 bf16 rows of 128 into 104,576 rows) the
// accumulator is 53.5 MB, as large as the 50 MB L2, and the segments are
// the power-law graph's: one row takes a twentieth of the lanes. Atomics
// on one row resolve one after the other, about 5 ns a 512-byte row, and
// hold up the rest while they queue.
//
// Design:
//  - a thread owns four neighbouring columns of a lane: one 8- or 16-byte
//    load, one four-float atomic (red.global.add.v4.f32), and the threads
//    of a lane are neighbours, so that a warp's atomic covers whole
//    32-byte sectors of one row. (Eight columns a thread, two atomics 16
//    bytes apart, leaves every sector half filled and was slower than a
//    float an atomic.) The data is read with __ldcs, marked to leave the
//    L2 first, so that it does not push the accumulator out;
//  - a block takes a tile of 256 lanes and puts, through a small hash
//    table in shared memory, the lanes of every segment in the tile on a
//    list. Only the head of a list adds to out; where the list has other
//    lanes, its threads sum their rows in registers first, four loads in
//    flight. A hub row gets one atomic a tile, not one a lane;
//  - the threads of a lane are a power of two (no division anywhere),
//    seg[e] is read once a lane, and a thread has kLanes lanes in flight,
//    all of their loads issued before the first atomic;
//  - any width or alignment that four-column chunks do not fit takes the
//    same kernel with one column a thread and a float an atomic;
//  - f64 and int32 take the one-column form alone (atomicAdd on a double,
//    native on sm_90, and on a 32-bit word: there is no four-column f64
//    or s32 reduction), with the same tile lists, so a hub still takes one
//    atomic a tile. The four-column form takes the f32 accumulators: f32,
//    bf16 and f16 data.
//
// Known divergence: JAX's transpose of a bf16 gather scatter-adds in bf16.
// This kernel sums bf16 data in f32 and the caller casts once at the end,
// which is the more precise of the two.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

constexpr int kLanes = 4;            // lanes of a thread in flight
constexpr int kTile = kThreads;      // lanes of a block's tile
constexpr int kSlots = 2 * kTile;    // slots of its segment table (2^9)

// COLS columns of a row in the accumulator's type Acc, from one load.
template <typename T, int COLS>
struct Chunk;

template <>
struct Chunk<float, 1> {
  using Acc = float;
  float x[1];
  __device__ __forceinline__ void load(const float* p) { x[0] = __ldcs(p); }
};
template <>
struct Chunk<float, 4> {
  using Acc = float;
  float x[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
};
template <>
struct Chunk<__nv_bfloat16, 1> {
  using Acc = float;
  float x[1];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    x[0] = __uint_as_float(
        (uint32_t)__ldcs(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
};
template <>
struct Chunk<__nv_bfloat16, 4> {
  using Acc = float;
  float x[4];
  // a 32-bit word holds two bf16: the low half is the first
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};
template <>
struct Chunk<__half, 1> {
  using Acc = float;
  float x[1];
  __device__ __forceinline__ void load(const __half* p) {
    x[0] = __half2float(
        __ushort_as_half(__ldcs(reinterpret_cast<const unsigned short*>(p))));
  }
};
template <>
struct Chunk<__half, 4> {
  using Acc = float;
  float x[4];
  // a 32-bit word holds two f16: the low half is the first
  __device__ __forceinline__ void load(const __half* p) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    x[0] = __half2float(__ushort_as_half((unsigned short)(v.x & 0xffffu)));
    x[1] = __half2float(__ushort_as_half((unsigned short)(v.x >> 16)));
    x[2] = __half2float(__ushort_as_half((unsigned short)(v.y & 0xffffu)));
    x[3] = __half2float(__ushort_as_half((unsigned short)(v.y >> 16)));
  }
};
template <>
struct Chunk<double, 1> {
  using Acc = double;
  double x[1];
  __device__ __forceinline__ void load(const double* p) { x[0] = __ldcs(p); }
};
// int32 summed as uint32: the same bits, wrapping modulo 2^32 with no
// signed overflow
template <>
struct Chunk<int32_t, 1> {
  using Acc = uint32_t;
  uint32_t x[1];
  __device__ __forceinline__ void load(const int32_t* p) {
    x[0] = (uint32_t)__ldcs(p);
  }
};

template <typename T>
using AccOf = typename Chunk<T, 1>::Acc;

// cpl chunks a lane, 1 << tshift threads a lane (the least power of two
// >= cpl, at most the block).
template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const T* __restrict__ data, const int32_t* __restrict__ seg,
    AccOf<T>* __restrict__ out, int64_t E, int F, int64_t ld, int64_t S,
    int cpl, int tshift) {
  using A = AccOf<T>;
  __shared__ int32_t slot_sh[kTile];  // a lane's slot in the table, or -1
  __shared__ int32_t next_sh[kTile];  // the lane before it in its slot's list
  __shared__ int32_t key[kSlots];     // a slot's segment, -1 while it is free
  __shared__ int32_t head[kSlots];    // the last lane put on its list
  const int tpl = 1 << tshift;
  const int c0 = threadIdx.x & (tpl - 1);    // this thread's first chunk
  const int g = threadIdx.x >> tshift;       // its lane among the block's
  const int gpb = kThreads >> tshift;        // lanes of a block at a time
  for (int64_t e0 = (int64_t)blockIdx.x * kTile; e0 < E;
       e0 += (int64_t)gridDim.x * kTile) {
    for (int i = threadIdx.x; i < kSlots; i += kThreads)
      key[i] = -1, head[i] = -1;
    __syncthreads();
    {
      // a lane a thread: find the segment's slot, join its list
      const int t = threadIdx.x;
      int32_t s = -1;
      if (e0 + t < E) s = seg[e0 + t];
      if (s >= S) s = -1;
      int h = -1;
      if (s >= 0) {
        h = (int)(((uint32_t)s * 2654435761u) >> 23);
        for (;;) {
          const int32_t was = atomicCAS(&key[h], -1, s);
          if (was == -1 || was == s) break;
          h = (h + 1) & (kSlots - 1);
        }
        next_sh[t] = atomicExch(&head[h], t);
      }
      slot_sh[t] = h;
    }
    __syncthreads();
    for (int j0 = g; j0 < kTile; j0 += gpb * kLanes) {
      // the lanes this thread adds: the heads of their segments' lists
      int32_t s[kLanes];
      unsigned more = 0;  // bit u: lane u's list has other lanes
#pragma unroll
      for (int u = 0; u < kLanes; ++u) {
        const int t = j0 + u * gpb;
        s[u] = -1;
        if (t < kTile) {
          const int h = slot_sh[t];
          if (h >= 0 && head[h] == t) {
            s[u] = key[h];
            if (next_sh[t] >= 0) more |= 1u << u;
          }
        }
      }
      for (int c = c0; c < cpl; c += tpl) {
        const T* col = data + e0 * ld + c * COLS;
        // chunk c of lane t of the tile
        auto load = [&](Chunk<T, COLS>& v, int t) { v.load(col + t * ld); };
        Chunk<T, COLS> v[kLanes];
#pragma unroll
        for (int u = 0; u < kLanes; ++u)
          if (s[u] >= 0) load(v[u], j0 + u * gpb);
        // the few lanes with a list: sum the other lanes' rows, four loads
        // at a time (one copy of this code: the loop over u is not
        // unrolled, v is indexed by unrolled selects)
#pragma unroll 1
        for (int u = 0; more >> u; ++u) {
          if (!((more >> u) & 1)) continue;
          A sum[COLS] = {};
          int m = next_sh[j0 + u * gpb];
          while (m >= 0) {
            int at[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              at[i] = m;
              if (m >= 0) m = next_sh[m];
            }
            Chunk<T, COLS> y[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (at[i] >= 0) load(y[i], at[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (at[i] < 0) continue;
#pragma unroll
              for (int n = 0; n < COLS; ++n) sum[n] += y[i].x[n];
            }
          }
#pragma unroll
          for (int w = 0; w < kLanes; ++w) {
            if (w != u) continue;
#pragma unroll
            for (int n = 0; n < COLS; ++n) v[w].x[n] += sum[n];
          }
        }
#pragma unroll
        for (int u = 0; u < kLanes; ++u) {
          if (s[u] < 0) continue;
          A* o = out + (int64_t)s[u] * F + c * COLS;
          if constexpr (COLS == 1)
            atomicAdd(o, v[u].x[0]);
          else
            atomicAdd(reinterpret_cast<float4*>(o),
                      make_float4(v[u].x[0], v[u].x[1], v[u].x[2],
                                  v[u].x[3]));
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int COLS>
static int launch_cols(const T* data, const int32_t* seg, AccOf<T>* out,
                       int64_t E, int64_t F, int64_t ld, int64_t S,
                       void* stream) {
  const int cpl = (int)(F / COLS);
  int tshift = 0;
  while ((1 << tshift) < cpl && (1 << tshift) < kThreads) ++tshift;
  const int64_t tiles = (E + kTile - 1) / kTile;
  segment_sum_kernel<T, COLS><<<lt_grid(tiles * kThreads), kThreads, 0,
                                (cudaStream_t)stream>>>(
      data, seg, out, E, (int)F, ld, S, cpl, tshift);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* data, const int32_t* seg, AccOf<T>* out, int64_t E,
                  int64_t F, int64_t ld, int64_t S, void* stream) {
  if (E == 0 || F == 0 || S == 0) return (int)cudaSuccess;
  if (F > 2147483647LL || ld < F) return (int)cudaErrorInvalidValue;
  // four-column chunks (f32 accumulators alone) need whole chunks a row and
  // aligned loads and atomics
  if constexpr (std::is_same<AccOf<T>, float>::value) {
    if (F % 4 == 0 && ld % 4 == 0 &&
        (uintptr_t)data % (4 * sizeof(T)) == 0 && (uintptr_t)out % 16 == 0)
      return launch_cols<T, 4>(data, seg, out, E, F, ld, S, stream);
  }
  return launch_cols<T, 1>(data, seg, out, E, F, ld, S, stream);
}

LT_EXPORT int lt_segment_sum_f32(const float* data, const int32_t* seg,
                                 float* out, int64_t E, int64_t F, int64_t ld,
                                 int64_t S, void* stream) {
  return launch<float>(data, seg, out, E, F, ld, S, stream);
}

LT_EXPORT int lt_segment_sum_bf16(const __nv_bfloat16* data,
                                  const int32_t* seg, float* out, int64_t E,
                                  int64_t F, int64_t ld, int64_t S,
                                  void* stream) {
  return launch<__nv_bfloat16>(data, seg, out, E, F, ld, S, stream);
}

LT_EXPORT int lt_segment_sum_f16(const __half* data, const int32_t* seg,
                                 float* out, int64_t E, int64_t F, int64_t ld,
                                 int64_t S, void* stream) {
  return launch<__half>(data, seg, out, E, F, ld, S, stream);
}

LT_EXPORT int lt_segment_sum_f64(const double* data, const int32_t* seg,
                                 double* out, int64_t E, int64_t F, int64_t ld,
                                 int64_t S, void* stream) {
  return launch<double>(data, seg, out, E, F, ld, S, stream);
}

// out int32, wrapping modulo 2^32
LT_EXPORT int lt_segment_sum_i32(const int32_t* data, const int32_t* seg,
                                 int32_t* out, int64_t E, int64_t F,
                                 int64_t ld, int64_t S, void* stream) {
  return launch<int32_t>(data, seg, reinterpret_cast<uint32_t*>(out), E, F,
                         ld, S, stream);
}
