// K9 dedup_map: Legion's position-map dedup.
//
// Replaces the XLA bodies of legion_tpu/sampling/sampler.py::
// NeighborSampler._dedup_map (:190-220), the seed registration of begin
// (:315-318) and the ClearPosMap of finish (:376-383); no Pallas source.
// The reference is operator_impl.cu:244-279 (an atomicOr bitmap and the
// position map). pos_map [V] int32 holds a vertex's local position, or
// INT32_MAX when unseen; during a hop, a claim tag kClaimBase + lane.
//   register: pos_map[seed] = its lane (atomicMin: a repeated seed keeps
//             its least lane);
//   hop:      claim:  atomicMin(&pos_map[c], kClaimBase + lane) for every
//                     valid lane; no lane decides from a read whether its
//                     id is new (a read after another lane's claim would
//                     see a tag). An id that already has a position
//                     (< kClaimBase) keeps it, so the winner is the least
//                     lane among the lanes of a new id, the one JAX's
//                     scatter-min picks, and only that lane can ever read
//                     its own tag back. A read that finds the entry at or
//                     below the lane's tag only skips an atomic that would
//                     change nothing (the hub's lanes, old ids);
//             count:  per tile, the lanes that won;
//             assign: won = (pos_map[c] == its tag), ranked in lane order
//                     (the tiles before, then the block's scan); a winner
//                     at cum + rank < cap writes pos_map[c] and ids[cum +
//                     rank]; one past the cap resets only its own entry to
//                     INT32_MAX (a lane that tested "tag >= kClaimBase"
//                     could race a winner's write and wipe a kept
//                     position); the last tile writes n_new = min(winners,
//                     cap - cum), so cum + n_new stays on the card;
//             read back: src_l = pos_map[c], INT32_MAX -> -1, a launch of
//                     its own after every write;
//   clear:    pos_map[t] = INT32_MAX for the touched ids.
// Everything is integer: the kernel equals the plain version
// (sampling/sampler.py::dedup_map_plain and friends) and JAX's
// _dedup_map bit for bit. Ids outside [0, V) count as pads.
//
// Bound on this card: bytes, dominated by the 32-byte sectors of the map
// that a lane touches (its claim, its test, its read-back: three a lane);
// the 9.6 MB map of 2.4M vertices stays in the 50 MB L2. Four launches a
// hop (claim, count, assign, read back) in one call from the host.
//
// Design: claim and read back are a thread a lane, grid-stride. Count and
// assign take tiles of kTile lanes, kItems neighbouring lanes a thread;
// the rank is two passes over tile sums (no spinning, no atomics beyond
// the claim): assign reduces the counts of the tiles before its own (a
// few values a thread) and scans its own threads. No thread writes an
// entry that another lane of the same launch still has to test: only a
// winner writes its id's entry, and only a winner's test depends on it.
#include "dedup.cuh"

constexpr int32_t kUnset = 2147483647;
constexpr int32_t kClaimBase = 1 << 30;

__global__ void __launch_bounds__(kThreads) map_register_kernel(
    const int32_t* __restrict__ seeds, int64_t n, int32_t* pos_map,
    int64_t V) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const int32_t s = seeds[i];
    if (s >= 0 && s < V && __ldcg(&pos_map[s]) > (int32_t)i)
      atomicMin(&pos_map[s], (int32_t)i);
  }
}

__global__ void __launch_bounds__(kThreads) map_clear_kernel(
    const int32_t* __restrict__ touched, int64_t n, int32_t* pos_map,
    int64_t V) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const int32_t t = touched[i];
    if (t >= 0 && t < V) pos_map[t] = kUnset;
  }
}

__global__ void __launch_bounds__(kThreads) map_claim_kernel(
    const int32_t* __restrict__ cand, int64_t E, int32_t* pos_map,
    int64_t V) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < E;
       i += (int64_t)gridDim.x * kThreads) {
    const int32_t c = cand[i], tag = kClaimBase + (int32_t)i;
    // entries only fall during a claim: one at or below the tag already
    // would leave the atomic without effect (a hub's later lanes, an id
    // placed at an earlier hop), so it is skipped
    if (c >= 0 && c < V && __ldcg(&pos_map[c]) > tag)
      atomicMin(&pos_map[c], tag);
  }
}

// Which of this thread's lanes won their id's claim.
__device__ __forceinline__ int won_lanes(const int32_t* __restrict__ cand,
                                         int64_t E, const int32_t* pos_map,
                                         int64_t V, int64_t i0,
                                         int32_t* c) {
  int won = 0;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int64_t i = i0 + u;
    c[u] = i < E ? cand[i] : -1;
    if (c[u] >= 0 && c[u] < V && pos_map[c[u]] == kClaimBase + (int32_t)i)
      won |= 1 << u;
  }
  return won;
}

__global__ void __launch_bounds__(kThreads) map_count_kernel(
    const int32_t* __restrict__ cand, int64_t E, const int32_t* pos_map,
    int64_t V, int32_t* __restrict__ tile_cnt) {
  int32_t c[kItems];
  const int won = won_lanes(cand, E, pos_map, V,
                            (int64_t)blockIdx.x * kTile
                                + threadIdx.x * kItems, c);
  int ec, el, tc, tl;
  lt_block_scan_sum_max(__popc(won), -1, &ec, &el, &tc, &tl);
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = tc;
}

__global__ void __launch_bounds__(kThreads) map_assign_kernel(
    const int32_t* __restrict__ cand, int64_t E, int32_t* pos_map,
    int64_t V, const int32_t* __restrict__ cum_p, int32_t cap,
    int32_t* __restrict__ ids, int32_t* __restrict__ n_new,
    const int32_t* __restrict__ tile_cnt) {
  const int t = blockIdx.x;
  int32_t c[kItems];
  const int64_t i0 = (int64_t)t * kTile + threadIdx.x * kItems;
  // test before any write of this launch that could concern this thread
  const int won = won_lanes(cand, E, pos_map, V, i0, c);
  int pc = 0;
  for (int p = threadIdx.x; p < t; p += kThreads) pc += tile_cnt[p];
  int unused0, unused1, tile_c, tl;
  lt_block_scan_sum_max(pc, -1, &unused0, &unused1, &tile_c, &tl);
  int ex, el, tot, tl2;
  lt_block_scan_sum_max(__popc(won), -1, &ex, &el, &tot, &tl2);
  const int32_t cum = *cum_p;
  int32_t local = cum + tile_c + ex;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    if (won & (1 << u)) {
      if (local < cap) {
        pos_map[c[u]] = local;
        ids[local] = c[u];
      } else {
        pos_map[c[u]] = kUnset;
      }
      ++local;
    }
  }
  if (t == (int)gridDim.x - 1 && threadIdx.x == 0) {
    const int64_t total = (int64_t)tile_c + tot;
    const int64_t room = cap > cum ? (int64_t)cap - cum : 0;
    *n_new = (int32_t)(total < room ? total : room);
  }
}

__global__ void __launch_bounds__(kThreads) map_read_kernel(
    const int32_t* __restrict__ cand, int64_t E,
    const int32_t* __restrict__ pos_map, int64_t V,
    int32_t* __restrict__ src_l) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < E;
       i += (int64_t)gridDim.x * kThreads) {
    const int32_t c = cand[i];
    int32_t v = -1;
    if (c >= 0 && c < V) {
      v = pos_map[c];
      if (v == kUnset) v = -1;
    }
    src_l[i] = v;
  }
}

LT_EXPORT int lt_map_register(const int32_t* seeds, int64_t n,
                              int32_t* pos_map, int64_t V, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  map_register_kernel<<<lt_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      seeds, n, pos_map, V);
  return (int)cudaGetLastError();
}

LT_EXPORT int lt_map_clear(const int32_t* touched, int64_t n,
                           int32_t* pos_map, int64_t V, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  map_clear_kernel<<<lt_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      touched, n, pos_map, V);
  return (int)cudaGetLastError();
}

// One hop: claim, count, assign, read back. scratch: tiles int32 (tiles =
// max(1, ceil(E / kTile))). cap <= the length of ids.
LT_EXPORT int lt_dedup_map(const int32_t* cand, int64_t E, int32_t* pos_map,
                           int64_t V, const int32_t* cum, int32_t cap,
                           int32_t* ids, int32_t* src_l, int32_t* n_new,
                           int32_t* scratch, void* stream) {
  const int64_t tiles = E > 0 ? (E + kTile - 1) / kTile : 1;
  if (E >= kClaimBase) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = lt_grid(E > 0 ? E : 1);
  map_claim_kernel<<<grid, kThreads, 0, s>>>(cand, E, pos_map, V);
  map_count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(cand, E, pos_map, V,
                                                        scratch);
  map_assign_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      cand, E, pos_map, V, cum, cap, ids, n_new, scratch);
  map_read_kernel<<<grid, kThreads, 0, s>>>(cand, E, pos_map, V, src_l);
  return (int)cudaGetLastError();
}
