// K4 cached_gather: feature rows from the device cache, or from the host
// table through its registered (zero-copy) pointer on a miss.
//
// Replaces legion_tpu/cache/unified_cache.py::CachedFeatureSource.fetch
// (:261-271), which on the TPU was a slot_map gather, a pure_callback
// into native.gather_rows for the misses and a where. Per (id, word):
//   id < 0             -> a zero row;
//   slot = slot_map[min(id, V-1)];
//   slot >= 0          -> the word of cache row `slot` (device memory);
//   otherwise          -> the host f32 row `id` (a zero row past the host
//                         table), converted to bf16 with round-to-nearest-
//                         even for a bf16 cache, as lg_gather_rows_bf16
//                         does (legion_tpu/native/src/legion_native.cpp).
// Hits (valid ids with slot >= 0) are counted per block and added once per
// block into a device int32 scalar: no host sync.
//
// Bound on this card: the PCIe reads of the miss rows (400 B of f32 per
// 100-wide row, at tens of GB/s against 3.35 TB/s for a cached row).
// Design: one thread per output word, as K1. A word is as wide as the row
// and the pointers allow (16, 8, 4 or 2 bytes); for a bf16 cache one word
// of N bf16 values comes from N f32 values of the host row, read as one
// aligned vector. Neighbouring threads read neighbouring parts of a row,
// so a warp's host reads of one row merge into full PCIe requests.
#include <cstring>

#include "common.cuh"

template <int N>
struct alignas(4 * N) HostChunk {
  float v[N];
};

__device__ __forceinline__ uint16_t bf16_rne(float x) {
  const uint32_t bits = __float_as_uint(x);
  return (uint16_t)((bits + 0x7fffu + ((bits >> 16) & 1u)) >> 16);
}

// Word = the output word; N = f32 host values per word.
template <typename Word, bool kBf16>
__global__ void cached_gather_kernel(
    const Word* __restrict__ cache, const int32_t* __restrict__ slot_map,
    int64_t num_nodes,
    const HostChunk<sizeof(Word) / (kBf16 ? 2 : 4)>* __restrict__ host,
    int64_t host_rows, const int32_t* __restrict__ ids,
    Word* __restrict__ out, int64_t n, int64_t words_per_row,
    int32_t* __restrict__ hits) {
  constexpr int N = sizeof(Word) / (kBf16 ? 2 : 4);
  const int64_t total = n * words_per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int local = 0;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t row = t / words_per_row;
    const int64_t w = t - row * words_per_row;
    const int32_t id = ids[row];
    Word v{};
    if (id >= 0) {
      const int32_t slot = slot_map[id < num_nodes ? id : num_nodes - 1];
      if (slot >= 0) {
        v = cache[(int64_t)slot * words_per_row + w];
        local += (w == 0);
      } else if (id < host_rows) {
        const HostChunk<N> c = host[(int64_t)id * words_per_row + w];
        if constexpr (kBf16) {
          uint16_t h[N];
#pragma unroll
          for (int j = 0; j < N; ++j) h[j] = bf16_rne(c.v[j]);
          memcpy(&v, h, sizeof(Word));
        } else {
          memcpy(&v, &c, sizeof(Word));
        }
      }
    }
    out[t] = v;
  }
  // one atomic per block: warp sums, then the block's sum
  for (int o = 16; o > 0; o >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, o);
  __shared__ int warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += warp_sums[i];
    if (s) atomicAdd(hits, s);
  }
}

template <typename Word, bool kBf16>
static int launch(const void* cache, const int32_t* slot_map,
                  int64_t num_nodes, const float* host, int64_t host_rows,
                  const int32_t* ids, void* out, int64_t n,
                  int64_t row_bytes, int32_t* hits, cudaStream_t stream) {
  constexpr int N = sizeof(Word) / (kBf16 ? 2 : 4);
  const int64_t wpr = row_bytes / (int64_t)sizeof(Word);
  cached_gather_kernel<Word, kBf16><<<lt_grid(n * wpr), kThreads, 0,
                                      stream>>>(
      (const Word*)cache, slot_map, num_nodes,
      (const HostChunk<N>*)host, host_rows, ids, (Word*)out, n, wpr, hits);
  return (int)cudaGetLastError();
}

template <bool kBf16>
static int dispatch(const void* cache, const int32_t* slot_map,
                    int64_t num_nodes, const float* host, int64_t host_rows,
                    const int32_t* ids, void* out, int64_t n, int64_t F,
                    int32_t* hits, cudaStream_t s) {
  const int64_t es = kBf16 ? 2 : 4;
  const int64_t row_bytes = F * es;
  // the widest word that the row width and all three tables allow
  auto fits = [&](int64_t wb) {
    const int64_t hb = wb / es * 4;  // host bytes behind one word
    return row_bytes % wb == 0 && (uintptr_t)cache % wb == 0 &&
           (uintptr_t)out % wb == 0 && (uintptr_t)host % hb == 0;
  };
  if (fits(16))
    return launch<uint4, kBf16>(cache, slot_map, num_nodes, host, host_rows,
                                ids, out, n, row_bytes, hits, s);
  if (fits(8))
    return launch<uint2, kBf16>(cache, slot_map, num_nodes, host, host_rows,
                                ids, out, n, row_bytes, hits, s);
  if (fits(4) || !kBf16)
    return launch<uint32_t, kBf16>(cache, slot_map, num_nodes, host,
                                   host_rows, ids, out, n, row_bytes, hits,
                                   s);
  return launch<uint16_t, true>(cache, slot_map, num_nodes, host, host_rows,
                                ids, out, n, row_bytes, hits, s);
}

// cache [C, F] (bf16 if bf16 else f32), slot_map [num_nodes] int32,
// host [host_rows, F] f32 (a device address of registered host memory),
// ids [n] int32 -> out [n, F] in the cache's dtype; *hits += hit count.
// All contiguous.
LT_EXPORT int lt_cached_gather(const void* cache, const int32_t* slot_map,
                               int64_t num_nodes, const float* host,
                               int64_t host_rows, const int32_t* ids,
                               int64_t n, int64_t F, int bf16, void* out,
                               int32_t* hits, void* stream) {
  if (n == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<true>(cache, slot_map, num_nodes, host, host_rows,
                               ids, out, n, F, hits, s)
              : dispatch<false>(cache, slot_map, num_nodes, host, host_rows,
                                ids, out, n, F, hits, s);
}
