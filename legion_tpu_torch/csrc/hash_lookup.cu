// K11 hash_lookup: id -> int32 value through a bucketed open-addressing
// hash map, -1 when the id is absent or a pad.
//
// Replaces legion_tpu/cache/hashmap.py::HashMap32.lookup (:96-115), which
// XLA compiled on the TPU as `probes` rounds of [N, 8] row gathers and
// compares. The map is one [B, 16] int32 table, B a power of two: row b
// holds bucket b's 8 keys (-1 = empty slot), then their 8 values, 64
// bytes (JAX's [B, 8] keys and values are its two halves). id's first
// bucket is (id * 0x9E3779B1 mod 2^32) mod B, and round p looks at
// bucket + p (linear probing over buckets). The first round whose bucket
// holds id gives its value.
//
// Early exit: the build (HashMap32.build, numpy) places its keys in
// rounds, a key of round r into bucket h0 + r unless that bucket filled up
// in round r, and a full bucket stays full. So a bucket with an empty
// slot ends the probe: an absent id costs one bucket row at the map's
// load of 0.5, not `probes` rows. The result is the JAX function's.
//
// Bound on this card: memory bytes. An id costs its 4-byte read, one
// 32-byte key row a probe (one sector), a 4-byte value read on a hit and
// its 4-byte write; there is no arithmetic worth counting. The rows are
// random: while the table fits L2 (50 MB) every id costs L2 a key sector
// and a hit a value sector, and L2's rate for random sectors sets the
// time (measured on an H100: about 190 G sectors/s at clique-HT-hash's
// fetch); past L2 a row costs a device-memory access. Design:
//   - a thread an id; a round reads the bucket's keys as two 16-byte
//     loads, then a hit's value from the same 64-byte row: past L2 it
//     comes with the keys' device-memory access, not in a second one;
//   - ids are read and values written with __ldcs / __stcs (evict first),
//     so that at the fetch 45 MB of ids and values stream past the map in
//     L2 without pushing it out.
#include "common.cuh"

constexpr int kRowWords = 16;          // a table row: 8 keys, 8 values

__global__ void __launch_bounds__(kThreads) hash_lookup_kernel(
    const int32_t* __restrict__ table, int64_t B, int32_t probes,
    const int32_t* __restrict__ ids, int64_t n, int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint32_t mask = (uint32_t)(B - 1);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t id = __ldcs(ids + i);
    int32_t v = -1;
    if (id >= 0) {
      const uint32_t b0 = ((uint32_t)id * 0x9E3779B1u) & mask;
      for (int32_t p = 0; p < probes; ++p) {
        const int32_t* row =
            table + (int64_t)((b0 + (uint32_t)p) & mask) * kRowWords;
        const int4 k0 = __ldg(reinterpret_cast<const int4*>(row));
        const int4 k1 = __ldg(reinterpret_cast<const int4*>(row) + 1);
        const int32_t k[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        int j = -1;
        bool empty = false;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          if (k[s] == id) j = s;
          empty |= k[s] < 0;
        }
        if (j >= 0) {
          v = __ldg(row + 8 + j);
          break;
        }
        if (empty) break;
      }
    }
    __stcs(out + i, v);
  }
}

// table: [B, 16] int32, contiguous, 16-byte aligned, B a power of two;
// ids, out: [n].
LT_EXPORT int lt_hash_lookup(const int32_t* table, int64_t B, int32_t probes,
                             const int32_t* ids, int64_t n, int32_t* out,
                             void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (B <= 0 || (B & (B - 1)) || B > (1ll << 32) || probes < 1 ||
      ((uintptr_t)table & 15))
    return (int)cudaErrorInvalidValue;
  hash_lookup_kernel<<<lt_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      table, B, probes, ids, n, out);
  return (int)cudaGetLastError();
}
