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
//             assign: won = (pos_map[c] == its tag), ranked in lane order;
//                     a winner at cum + rank < cap writes pos_map[c] and
//                     ids[cum + rank]; one past the cap resets only its own
//                     entry to INT32_MAX (a lane that tested "tag >=
//                     kClaimBase" could race a winner's write and wipe a
//                     kept position); the tile of the last lane writes
//                     n_new = min(winners, cap - cum), so cum + n_new stays
//                     on the card;
//             read back: src_l = pos_map[c], INT32_MAX -> -1, after every
//                     write of the hop (a lane that already knows its
//                     position, by the claim's read or as the winner,
//                     writes it without reading again);
//   clear:    pos_map[t] = INT32_MAX for the touched ids.
// Everything is integer: the kernels equal the plain versions
// (sampling/sampler.py::dedup_map_plain and friends) and JAX's _dedup_map
// bit for bit. Ids outside [0, V) count as pads.
//
// Bound on this card: bytes, dominated by the 32-byte sectors of the map
// that a lane touches (its claim, its test, its read-back); the 9.6 MB map
// of 2.4M vertices stays in the 50 MB L2. At a batch's sizes the launches
// cost more than the bytes: a batch once took six launches in three
// calls.
//
// Design: the hop is one cooperative launch (dedup_map_kernel), which can
// also register a batch's seeds first and clear its touched ids last, so
// that a batch of map dedup with a lane-aligned last hop is one call and
// one launch. Phases, separated by grid.sync():
//   0. register (when asked), zero the tiles' status words;
//   1. claim. The barrier after the registration is for speed, not for
//      the result (both are atomicMin, and a seed's lane lies below every
//      claim tag): with the seeds' entries final, a lane whose id is a
//      seed reads its position in the claim and skips the atomic, the test
//      and the read-back. Without it the lanes of already placed ids race
//      their registration into atomics, tests and read-backs, and the
//      one call was slower than three (PERF.md, §6);
//   2. per tile: test, count the winners, decoupled look-back over the
//      tiles before (dedup.cuh) for the lane-order rank, assign;
//   3. read back;
//   4. clear ids[0, clear_len) (when asked).
// A tile is kTile lanes, kItems neighbouring lanes a thread; a block takes
// tiles blockIdx.x, + gridDim.x, ... in increasing order in every phase.
// The map's scattered sectors at the L2 set the phases' time, not the
// atomics of a hub's lanes (the read before the claim skips most of
// those; combining a tile's lanes of one id in shared memory first was
// tried and was slower, PERF.md). So every lane reads the map as few
// times as it can: the claim's read gives a lane whose id was placed
// before the claims its final position at once, only a lane that claimed
// tests, a winner knows its own position, and only the rest read back.
// A lane's state between phases lives in src_l (kClaimed, kPending).
// When a block owns one tile (every shape up to the grid's size: 1.08M
// lanes at 8 blocks an SM) its lanes' ids stay in registers from the claim
// to the read-back. The won bits never cross a barrier: the test, the
// look-back and the assign of a tile run in one phase. No thread writes an
// entry that another lane of its phase still tests: only a winner writes
// its id's entry, only a winner's test can find it, and a winner is the
// least lane of its id, so tiles assigned earlier never change a later
// tile's test. Reads of the map and of ids written in an earlier phase go
// to the L2 (__ldcg). The grid is the occupancy limit of this kernel times
// the SMs (found once a device and kept), or fewer blocks when the shape
// needs fewer; a refused cooperative launch returns its error, and no
// other form runs. grid.sync() needs the cooperative launch and nothing
// more of the build (no -rdc since CUDA 11): ops/kernels.py::NVCC_FLAGS.
#include <cooperative_groups.h>

#include "dedup.cuh"

namespace cg = cooperative_groups;

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

// src_l during a call, below every output (a position or -1): a lane that
// claimed its id, and one that waits for its id's position
constexpr int32_t kClaimed = -2147483647 - 1, kPending = kClaimed + 1;

__global__ void __launch_bounds__(kThreads) dedup_map_kernel(
    const int32_t* seeds, int64_t n_seeds,
    const int32_t* __restrict__ cand, int64_t E, int32_t* pos_map,
    int64_t V, const int32_t* __restrict__ cum_p, int32_t cap,
    int32_t* ids, int32_t* __restrict__ src_l, int32_t* __restrict__ n_new,
    int64_t clear_len, uint64_t* status) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_pc;
  const int64_t tiles = E > 0 ? (E + kTile - 1) / kTile : 1;
  const int64_t g0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  // every block owns at most one tile: its lanes' ids and states stay in
  // registers; else they are loaded again (a thread reads its own stores)
  const bool one = tiles <= (int64_t)gridDim.x;
  int32_t c[kItems], st[kItems];

  // 0. register; zero the status words (first read after a barrier). A
  // thread reads its entries before it changes any, so that the reads are
  // in flight together.
  for (int64_t i = g0; i < tiles; i += stride) status[i] = 0;
  if (seeds != nullptr) {
    for (int64_t i0 = g0 * kItems; i0 < n_seeds; i0 += stride * kItems) {
      int32_t sd[kItems], now[kItems];
      lt_load4(seeds, i0, n_seeds, -1, sd);
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        now[u] = sd[u] >= 0 && sd[u] < V ? __ldcg(&pos_map[sd[u]]) : 0;
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        if (sd[u] >= 0 && sd[u] < V && now[u] > (int32_t)(i0 + u))
          atomicMin(&pos_map[sd[u]], (int32_t)(i0 + u));
    }
    grid.sync();
  }

  // 1. claim
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t i0 = t * kTile + threadIdx.x * kItems;
    lt_load4(cand, i0, E, -1, c);
    int32_t now[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u)
      now[u] = c[u] >= 0 && c[u] < V ? __ldcg(&pos_map[c[u]]) : 0;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int32_t tag = kClaimBase + (int32_t)(i0 + u);
      if (c[u] < 0 || c[u] >= V) {
        st[u] = -1;
      } else if (now[u] < kClaimBase) {
        st[u] = now[u];  // placed before the claims: its final position
      } else if (now[u] > tag) {
        atomicMin(&pos_map[c[u]], tag);
        st[u] = kClaimed;
      } else {
        // a smaller tag: no win, and no atomic that could change the entry
        st[u] = kPending;
      }
      if (i0 + u < E) src_l[i0 + u] = st[u];
    }
  }
  grid.sync();

  // 2. test the claims, rank by look-back, assign
  const int32_t cum = *cum_p;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t i0 = t * kTile + threadIdx.x * kItems;
    if (!one) {
      lt_load4(cand, i0, E, -1, c);
      lt_load4(src_l, i0, E, -1, st);
    }
    int won = 0;
#pragma unroll
    for (int u = 0; u < kItems; ++u)
      if (st[u] == kClaimed
          && __ldcg(&pos_map[c[u]]) == kClaimBase + (int32_t)(i0 + u))
        won |= 1 << u;
    int ex, el, tot, tl;
    lt_block_scan_sum_max(__popc(won), -1, &ex, &el, &tot, &tl);
    if (threadIdx.x < 32) {
      int pc, pl;
      lt_tile_lookback(status, t, tot, -1, &pc, &pl);
      if (threadIdx.x == 0) s_pc = pc;
    }
    __syncthreads();
    const int tile_c = s_pc;
    int32_t local = cum + tile_c + ex;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (won & (1 << u)) {
        if (local < cap) {
          pos_map[c[u]] = local;
          ids[local] = c[u];
          st[u] = local;
        } else {
          pos_map[c[u]] = kUnset;
          st[u] = -1;
        }
        src_l[i0 + u] = st[u];
        ++local;
      }
    }
    if (t == tiles - 1 && threadIdx.x == 0) {
      const int64_t total = (int64_t)tile_c + tot;
      const int64_t room = cap > cum ? (int64_t)cap - cum : 0;
      *n_new = (int32_t)(total < room ? total : room);
    }
  }
  grid.sync();

  // 3. read back the positions of the lanes that wait for them
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t i0 = t * kTile + threadIdx.x * kItems;
    if (!one) {
      lt_load4(cand, i0, E, -1, c);
      lt_load4(src_l, i0, E, -1, st);
    }
    int32_t v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u)
      v[u] = st[u] < -1 ? __ldcg(&pos_map[c[u]]) : 0;
#pragma unroll
    for (int u = 0; u < kItems; ++u)
      if (st[u] < -1) src_l[i0 + u] = v[u] == kUnset ? -1 : v[u];
  }

  // 4. clear the touched ids
  if (clear_len > 0) {
    grid.sync();
    for (int64_t i0 = g0 * kItems; i0 < clear_len; i0 += stride * kItems) {
      int32_t tt[kItems];
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        tt[u] = i0 + u < clear_len ? __ldcg(&ids[i0 + u]) : -1;
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        if (tt[u] >= 0 && tt[u] < V) pos_map[tt[u]] = kUnset;
    }
  }
}

// The cooperative grid for a shape: enough blocks for its tiles, its
// seeds and its touched ids, at most the blocks that fit on the card at
// once (this kernel's occupancy, found once a device, times the SMs).
// Returns 0 with *err set when the card cannot launch it.
static unsigned int map_grid(int64_t E, int64_t n_seeds, int64_t clear_len,
                             cudaError_t* err) {
  static int resident[64];  // per device; 0 until found
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= 64) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (resident[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (*err == cudaSuccess && !coop) *err = cudaErrorNotSupported;
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dedup_map_kernel, kThreads, 0);
    if (*err != cudaSuccess) return 0;
    if (per_sm * sms <= 0) {
      *err = cudaErrorCooperativeLaunchTooLarge;
      return 0;
    }
    resident[dev] = per_sm * sms;
  }
  int64_t need = E > 0 ? (E + kTile - 1) / kTile : 1;
  const int64_t side = n_seeds > clear_len ? n_seeds : clear_len;
  if ((side + kTile - 1) / kTile > need) need = (side + kTile - 1) / kTile;
  return (unsigned int)(need < resident[dev] ? need : resident[dev]);
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

// The blocks dedup_map_kernel takes for a shape (0 if it cannot launch).
LT_EXPORT int lt_dedup_map_grid(int64_t E, int64_t n_seeds,
                                int64_t clear_len) {
  cudaError_t err;
  return (int)map_grid(E, n_seeds, clear_len, &err);
}

// One hop, with the seeds' registration first when seeds is not null and
// the clear of ids[0, clear_len) last when clear_len > 0: one cooperative
// launch. scratch: 2 * tiles int32, 8-byte aligned (tiles = max(1, ceil(E /
// kTile))). cap <= the length of ids, clear_len too.
LT_EXPORT int lt_dedup_map_fused(const int32_t* seeds, int64_t n_seeds,
                                 const int32_t* cand, int64_t E,
                                 int32_t* pos_map, int64_t V,
                                 const int32_t* cum, int32_t cap,
                                 int32_t* ids, int32_t* src_l,
                                 int32_t* n_new, int64_t clear_len,
                                 int32_t* scratch, void* stream) {
  if (E >= kClaimBase || n_seeds < 0 || clear_len < 0
      || ((uintptr_t)scratch & 7))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const unsigned int grid = map_grid(E, n_seeds, clear_len, &err);
  if (grid == 0) return (int)err;
  uint64_t* status = (uint64_t*)scratch;
  void* args[] = {&seeds, &n_seeds, &cand, &E, &pos_map, &V, &cum, &cap,
                  &ids, &src_l, &n_new, &clear_len, &status};
  return (int)cudaLaunchCooperativeKernel((const void*)dedup_map_kernel,
                                          grid, kThreads, args, 0,
                                          (cudaStream_t)stream);
}

// One hop alone: claim, rank, assign, read back.
LT_EXPORT int lt_dedup_map(const int32_t* cand, int64_t E, int32_t* pos_map,
                           int64_t V, const int32_t* cum, int32_t cap,
                           int32_t* ids, int32_t* src_l, int32_t* n_new,
                           int32_t* scratch, void* stream) {
  return lt_dedup_map_fused(nullptr, 0, cand, E, pos_map, V, cum, cap, ids,
                            src_l, n_new, 0, scratch, stream);
}
