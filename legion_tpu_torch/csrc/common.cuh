// Shared helpers for the legion_tpu_torch CUDA kernels.
//
// Every launcher has a plain C interface (loaded with ctypes by
// legion_tpu_torch/ops/kernels.py), launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() so that the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LT_EXPORT extern "C" __attribute__((visibility("default")))

constexpr int kThreads = 256;

// Enough blocks to fill the card; kernels walk the rest grid-stride.
inline unsigned int lt_grid(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;
  return (unsigned int)(blocks < cap ? blocks : cap);
}

// Counter-based random words (no state, no library): a keyed double
// application of the "lowbias32" integer hash. The Python side mirrors it
// bit for bit in int64 arithmetic (sampling/access.py::hash32), and the
// host draws of host_half.cu call the same functions.
__host__ __device__ __forceinline__ uint32_t lt_hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ uint32_t lt_word(uint32_t ka,
                                                     uint32_t kb,
                                                     uint32_t lane) {
  return lt_hash32(lt_hash32(lane ^ ka) ^ kb);
}

// Uniform integer in [0, m) from a 32-bit word: (w * m) >> 32.
__host__ __device__ __forceinline__ uint32_t lt_bounded(uint32_t w,
                                                        uint32_t m) {
  return (uint32_t)(((uint64_t)w * (uint64_t)m) >> 32);
}

// fold_in on a 64-bit key held as its 32-bit halves (lo, hi), bit for bit
// sampling/access.py::fold_in_words: data's low and high 32 bits,
//   lo' = hash32(lo ^ hash32(data_lo ^ 0x9E3779B9))
//   hi' = hash32(hi ^ hash32(lo' ^ data_hi)).
struct LtKey {
  uint32_t lo, hi;
};

__device__ __forceinline__ LtKey lt_fold_in(LtKey k, uint64_t data) {
  LtKey r;
  r.lo = lt_hash32(k.lo ^ lt_hash32((uint32_t)(data & 0xFFFFFFFFull) ^
                                    0x9E3779B9u));
  r.hi = lt_hash32(k.hi ^ lt_hash32(r.lo ^ (uint32_t)(data >> 32)));
  return r;
}
