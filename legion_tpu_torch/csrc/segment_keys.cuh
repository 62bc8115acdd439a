// Shared by K17 segment_max (segment_max.cu) and K18 segment_softmax
// (segment_softmax.cu): the order-preserving integer keys that make an
// integer max a float max, the element types they take, the pieces of a
// row a thread moves, and the zero rows of the lanes a call drops.
#pragma once

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <initializer_list>

#include "lane_groups.cuh"

// Element types, as ops/segment.py::SEG_TYPES numbers them.
enum LtSegType : int { kSegF32 = 0, kSegBF16 = 1, kSegI32 = 2, kSegF16 = 3 };

// The key of an f32's bits: unsigned max of keys is float max. Every NaN
// maps to the top key, so a NaN lane makes its segment NaN; -0 ranks
// below +0. Key 0 belongs to no float (it would be a negative NaN's), so
// it means "no lane yet" (for int32, key 0 is INT_MIN's, which no initial
// lies below).
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

// f16 bits of a float, rounded to nearest even; a NaN is 0x7E00, as the CPU
// cast and the plain versions' NaN (the card's cast may give other bits).
__device__ __forceinline__ uint16_t lt_f16_rn(float f) {
  if (f != f) return 0x7E00u;
  return __half_as_ushort(__float2half_rn(f));
}

// An element type's storage, its key, its value as a float and the
// store of a float result, all on the element's bits widened to 32.
template <int TYPE>
struct SegT;

template <>
struct SegT<kSegF32> {
  using T = uint32_t;
  static __device__ __forceinline__ uint32_t key(uint32_t b) {
    return lt_f32_key(b);
  }
  static __device__ __forceinline__ uint32_t unkey(uint32_t k) {
    return lt_f32_unkey(k);
  }
  static __device__ __forceinline__ float val(uint32_t b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ uint32_t store(float f) {
    return __float_as_uint(f);
  }
};

template <>
struct SegT<kSegBF16> {
  using T = uint16_t;
  static __device__ __forceinline__ uint32_t key(uint32_t b) {
    return lt_f32_key(b << 16);
  }
  // a key of a bf16 value (or of the top key) decodes to f32 bits whose
  // low half is zero
  static __device__ __forceinline__ uint32_t unkey(uint32_t k) {
    return lt_f32_unkey(k) >> 16;
  }
  static __device__ __forceinline__ float val(uint32_t b) {
    return __uint_as_float(b << 16);
  }
  static __device__ __forceinline__ uint32_t store(float f) {
    return lt_bf16_rn(f);
  }
};

// f16: the key of the exact f32 widening, decoded back to f16 exactly (a
// key of an f16 value is one of an f32 that f16 holds; the top key, a
// NaN, decodes to 0x7E00).
template <>
struct SegT<kSegF16> {
  using T = uint16_t;
  static __device__ __forceinline__ float val(uint32_t b) {
    return __half2float(__ushort_as_half((unsigned short)b));
  }
  static __device__ __forceinline__ uint32_t key(uint32_t b) {
    return lt_f32_key(__float_as_uint(val(b)));
  }
  static __device__ __forceinline__ uint32_t unkey(uint32_t k) {
    return lt_f16_rn(__uint_as_float(lt_f32_unkey(k)));
  }
  static __device__ __forceinline__ uint32_t store(float f) {
    return lt_f16_rn(f);
  }
};

template <>
struct SegT<kSegI32> {
  using T = uint32_t;
  static __device__ __forceinline__ uint32_t key(uint32_t b) {
    return b ^ 0x80000000u;
  }
  static __device__ __forceinline__ uint32_t unkey(uint32_t k) {
    return k ^ 0x80000000u;
  }
};

// A thread moves a piece of a row: VEC elements, 16 bytes (where the row
// width and every base allow it) or one element.
template <int TYPE>
constexpr int kSegVec = 16 / (int)sizeof(typename SegT<TYPE>::T);

// The piece at p (16 or 8 bytes in one load, or one element) as 32-bit
// words, an element a word.
template <typename T, int VEC>
__device__ __forceinline__ void lt_load_piece(const T* p, uint32_t* v) {
  constexpr int kWords = VEC * (int)sizeof(T) / 4;
  if constexpr (VEC > 1) {
    uint32_t w[kWords];
    if constexpr (kWords == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x, w[1] = q.y;
    }
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) v[k] = w[k];
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        v[2 * k] = w[k] & 0xFFFFu, v[2 * k + 1] = w[k] >> 16;
    }
  } else {
    v[0] = __ldg(p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void lt_store_piece(T* p, const uint32_t* v) {
  constexpr int kWords = VEC * (int)sizeof(T) / 4;
  if constexpr (VEC > 1) {
    uint32_t w[kWords];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) w[k] = v[k];
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k) w[k] = v[2 * k] | (v[2 * k + 1] << 16);
    }
    if constexpr (kWords == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    p[0] = (T)v[0];
  }
}

// Whether 16-byte pieces fit a call: the width a multiple of the piece,
// every base 16-byte aligned (a null one too).
template <int TYPE>
bool lt_seg_wide(int64_t F, std::initializer_list<const void*> bases) {
  if (F % kSegVec<TYPE> != 0) return false;
  for (const void* p : bases)
    if ((uintptr_t)p % 16 != 0) return false;
  return true;
}

// The least power of two >= n, at most 32.
__host__ __device__ inline int lt_pow2_32(int n) {
  int p = 1;
  while (p < n && p < 32) p <<= 1;
  return p;
}

// Warp wid of nwarps writes +0 to the rows [E, P pieces of VEC] of the
// lanes that a call drops (seg[e] < 0 or >= S): a narrow row (P <= 4) by
// the thread that reads the lane's id, 4 lanes a thread; a wider one by
// the whole warp, 32 lanes at a time.
template <typename T, int VEC>
__device__ void lt_zero_dropped(const int32_t* __restrict__ seg, int64_t E,
                                int64_t S, int P, int64_t F, T* __restrict__ out,
                                int64_t wid, int64_t nwarps) {
  const int t = threadIdx.x & 31;
  const uint32_t zero[VEC] = {};
  if (P <= 4) {
    for (int64_t e0 = wid * 128 + t; e0 < E; e0 += nwarps * 128) {
      bool drop[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int32_t s = e0 + 32 * u < E ? __ldg(seg + e0 + 32 * u) : 0;
        drop[u] = e0 + 32 * u < E && (s < 0 || s >= S);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!drop[u]) continue;
        for (int c = 0; c < P; ++c)
          lt_store_piece<T, VEC>(out + (e0 + 32 * u) * F + (int64_t)c * VEC,
                                 zero);
      }
    }
    return;
  }
  for (int64_t e0 = wid * 32; e0 < E; e0 += nwarps * 32) {
    bool drop = false;
    if (e0 + t < E) {
      const int32_t s = __ldg(seg + e0 + t);
      drop = s < 0 || s >= S;
    }
    for (uint32_t m = __ballot_sync(0xffffffffu, drop); m; m &= m - 1) {
      const int64_t e = e0 + __ffs(m) - 1;
      for (int c = t; c < P; c += 32)
        lt_store_piece<T, VEC>(out + e * F + (int64_t)c * VEC, zero);
    }
  }
}

// The blocks of a segment kernel's launch: chunks of long runs first (a
// group of threads a chunk), then the dropped lanes' zero rows, then the
// rows (a group a row).
struct LtSegGrid {
  int chunk_blocks, zero_blocks, row_blocks;
  unsigned total() const {
    return (unsigned)(chunk_blocks + zero_blocks + row_blocks);
  }
};

inline LtSegGrid lt_seg_grid(int64_t E, int64_t S, int group, bool zeros) {
  const int64_t per = kThreads / group;  // groups a block
  auto cap = [](int64_t n, int64_t most) {
    return (int)(n < 1 ? 1 : (n < most ? n : most));
  };
  LtSegGrid g;
  g.chunk_blocks = cap((lt_max_chunks(E) + per - 1) / per, 132 * 2);
  g.zero_blocks = zeros ? cap((E + kThreads - 1) / kThreads, 132 * 4) : 0;
  g.row_blocks = cap((S + per - 1) / per, 132 * 8);
  return g;
}

// Blocks for a combine: a block a long run.
inline unsigned lt_seg_long_blocks(int64_t E) {
  const int64_t n = lt_max_longs(E);
  return (unsigned)(n < 132 * 4 ? n : 132 * 4);
}

// Words of a call's scratch for the chunks of its long runs: cols 32-bit
// values a chunk.
inline int64_t lt_seg_part_words(int64_t E, int64_t cols) {
  return lt_max_chunks(E) * cols;
}
