// Shared by K17 segment_max (segment_max.cu) and K18 segment_softmax
// (segment_softmax.cu): the order-preserving integer keys that make an
// integer atomicMax a float max, the element types they take, and the
// pass that maxes a lane's keys into its segment's row.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// Element types, as ops/segment.py::SEG_TYPES numbers them.
enum LtSegType : int { kSegF32 = 0, kSegBF16 = 1, kSegI32 = 2 };

// The key of an f32's bits: unsigned max of keys is float max. Every NaN
// maps to the top key, so a NaN lane makes its segment NaN; -0 ranks
// below +0. Key 0 belongs to no float (it would be a negative NaN's), so a
// zeroed key buffer means "no lane yet" (for int32, key 0 is INT_MIN's,
// which no initial lies below).
__device__ __forceinline__ uint32_t lt_f32_key(uint32_t b) {
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) return 0xFFFFFFFFu;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The f32 bits of a key; the top key decodes to the canonical NaN.
__device__ __forceinline__ uint32_t lt_f32_unkey(uint32_t k) {
  if (k == 0xFFFFFFFFu) return 0x7FC00000u;
  return (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
}

// The key of +0.0: K18's shift is max(segment max, 0).
constexpr uint32_t kKeyPosZero = 0x80000000u;

// bf16 bits of a float, rounded to nearest even as PyTorch's cast rounds
// it (c10::BFloat16); a NaN is 0x7FC0, as the CPU cast and the plain
// versions' NaN (PyTorch's cast on the card gives 0x7FFF).
__device__ __forceinline__ uint16_t lt_bf16_rn(float f) {
  const uint32_t u = __float_as_uint(f);
  if (f != f) return 0x7FC0u;
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// An element type's storage, its key, its value as a float and the
// store of a float result.
template <int TYPE>
struct SegT;

template <>
struct SegT<kSegF32> {
  using T = uint32_t;
  static __device__ __forceinline__ uint32_t key(T b) { return lt_f32_key(b); }
  static __device__ __forceinline__ T unkey(uint32_t k) {
    return lt_f32_unkey(k);
  }
  static __device__ __forceinline__ float val(T b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ T store(float f) {
    return __float_as_uint(f);
  }
};

template <>
struct SegT<kSegBF16> {
  using T = uint16_t;
  static __device__ __forceinline__ uint32_t key(T b) {
    return lt_f32_key((uint32_t)b << 16);
  }
  // a key of a bf16 value (or of the top key) decodes to f32 bits whose
  // low half is zero
  static __device__ __forceinline__ T unkey(uint32_t k) {
    return (T)(lt_f32_unkey(k) >> 16);
  }
  static __device__ __forceinline__ float val(T b) {
    return __uint_as_float((uint32_t)b << 16);
  }
  static __device__ __forceinline__ T store(float f) { return lt_bf16_rn(f); }
};

template <>
struct SegT<kSegI32> {
  using T = uint32_t;
  static __device__ __forceinline__ uint32_t key(T b) {
    return b ^ 0x80000000u;
  }
  static __device__ __forceinline__ T unkey(uint32_t k) {
    return k ^ 0x80000000u;
  }
};

// The least power of two of threads a lane, at least the row's F
// elements, at most a block.
inline int lt_seg_tshift(int64_t F) {
  int t = 0;
  while ((1LL << t) < F && (1 << t) < kThreads) ++t;
  return t;
}

// keys[s, f] = max over the valid lanes e of segment s (0 <= seg[e] < S)
// of key(data[e, f]); keys must be zeroed first. data [E, F] of ``type``,
// keys [S, F]. Returns cudaGetLastError().
int lt_segment_keys(const void* data, int type, const int32_t* seg,
                    int64_t E, int64_t F, int64_t S, uint32_t* keys,
                    cudaStream_t stream);
