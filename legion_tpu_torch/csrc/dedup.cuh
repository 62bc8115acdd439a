// Shared by the dedup kernels (K8 dedup_sort.cu, K9 dedup_map.cu).
#pragma once

#include "common.cuh"

// K9 cuts its lanes into tiles of kTile, kItems neighbouring lanes a
// thread; K8 takes larger tiles (dedup_sort.cu).
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

// Exclusive scan across a block of kThreads threads of (count, last) pairs
// under (sum, max): this thread's exclusive pair (the identity is (0, -1))
// and the block's totals. Starts with a barrier, so it may be called again.
__device__ __forceinline__ void lt_block_scan_sum_max(
    int cnt, int last, int* ex_cnt, int* ex_last, int* tot_cnt,
    int* tot_last) {
  __shared__ int s_cnt[kThreads / 32], s_last[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int c = cnt, l = last;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int c2 = __shfl_up_sync(0xffffffffu, c, o);
    const int l2 = __shfl_up_sync(0xffffffffu, l, o);
    if (lane >= o) {
      c += c2;
      l = max(l, l2);
    }
  }
  int lp = __shfl_up_sync(0xffffffffu, l, 1);
  if (lane == 0) lp = -1;
  __syncthreads();  // the previous call's readers are done
  if (lane == 31) {
    s_cnt[warp] = c;
    s_last[warp] = l;
  }
  __syncthreads();
  int wc = 0, wl = -1, tc = 0, tl = -1;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int sc = s_cnt[w], sl = s_last[w];
    if (w < warp) {
      wc += sc;
      wl = max(wl, sl);
    }
    tc += sc;
    tl = max(tl, sl);
  }
  *ex_cnt = wc + c - cnt;
  *ex_last = max(wl, lp);
  *tot_cnt = tc;
  *tot_last = tl;
}

// Entries [j0, j0 + 4) of a into v[0, 4) (values past n are `pad`): one
// 16-byte load (two for 8-byte types) where they all exist and lie
// 16-byte aligned.
template <typename T>
__device__ __forceinline__ void lt_load4(const T* __restrict__ a, int64_t j0,
                                         int64_t n, T pad, T* v) {
  if (j0 + 4 <= n && ((uintptr_t)(a + j0) & 15) == 0) {
    if constexpr (sizeof(T) == 4) {
      const int4 q = *reinterpret_cast<const int4*>(a + j0);
      v[0] = (T)q.x, v[1] = (T)q.y, v[2] = (T)q.z, v[3] = (T)q.w;
    } else {
      const longlong2 q0 = *reinterpret_cast<const longlong2*>(a + j0);
      const longlong2 q1 = *reinterpret_cast<const longlong2*>(a + j0 + 2);
      v[0] = (T)q0.x, v[1] = (T)q0.y, v[2] = (T)q1.x, v[3] = (T)q1.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = j0 + u < n ? a[j0 + u] : pad;
  }
}

// Decoupled look-back (Merrill and Garland's single-pass prefix scan, as
// CUB's): a tile publishes its (count, last) aggregate as soon as it has
// it, then reduces the published words of the tiles before it, back to
// the nearest one that holds an inclusive prefix, and publishes its own
// inclusive prefix. A tile waits only on tiles numbered before it. Both
// kernels make that safe: K8 numbers its tiles by an atomic ticket in the
// order blocks start, so every tile waited on belongs to a block already
// running; K9 is a cooperative launch, every block resident, and a block
// takes its tiles in increasing order. A round reads the 32 words before
// the last one read (a word a lane), polling again only the words not yet
// published.
//
// A tile's status word, written with one 64-bit store: bits 62-63 the flag
// (0 none yet, 1 aggregate, 2 inclusive prefix), bits 31-61 the count,
// bits 0-30 last + 1. Counts and indices stay below 2^31 - 1. The word is
// all that one tile passes to another, so it is stored and loaded relaxed
// at gpu scope (single-copy atomic, from the L2); no other data needs
// ordering, and release/acquire would fence every store and poll.
constexpr uint64_t kStatusAggregate = 1ull << 62;
constexpr uint64_t kStatusPrefix = 2ull << 62;
// A spin that outlasts this many polls of a word (seconds, where a
// published word arrives in microseconds) is a fault: __trap() ends the
// kernel, and the error surfaces at the next CUDA call on the host
// instead of leaving the card hung.
constexpr long long kMaxPolls = 1ll << 24;

__device__ __forceinline__ uint64_t lt_status(uint64_t flag, int cnt,
                                              int last) {
  return flag | ((uint64_t)(uint32_t)cnt << 31) | (uint32_t)(last + 1);
}

__device__ __forceinline__ void lt_status_store(uint64_t* p, uint64_t w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ uint64_t lt_status_load(const uint64_t* p) {
  uint64_t w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

// Called by all 32 lanes of one warp of tile t's block, with the tile's
// aggregate (cnt, last): publishes it, looks back, publishes the inclusive
// prefix, and returns the exclusive prefix (the sum of the counts and the
// max of the lasts of tiles [0, t)) in every lane. status[t] must read 0
// (none) until this tile writes it.
__device__ __forceinline__ void lt_tile_lookback(uint64_t* status, int64_t t,
                                                 int cnt, int last,
                                                 int* ex_cnt, int* ex_last) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0)
      lt_status_store(status, lt_status(kStatusPrefix, cnt, last));
    *ex_cnt = 0;
    *ex_last = -1;
    return;
  }
  if (lane == 0)
    lt_status_store(status + t, lt_status(kStatusAggregate, cnt, last));
  int pc = 0, pl = -1;
  // each round reads the 32 words before `end`, lane 31 the nearest
  for (int64_t end = t;; end -= 32) {
    const int64_t i = end - 32 + lane;
    // before tile 0: the identity, as an inclusive prefix
    uint64_t w = i >= 0 ? 0 : lt_status(kStatusPrefix, 0, -1);
    for (long long polls = 0;; ++polls) {
      if ((w >> 62) == 0) w = lt_status_load(status + i);
      if (__all_sync(0xffffffffu, (w >> 62) != 0)) break;
      if (polls == kMaxPolls) __trap();
    }
    const unsigned pre = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    // the words from the nearest inclusive prefix on (all when none)
    const int from = pre ? 31 - __clz(pre) : 0;
    int c = lane >= from ? (int)((w >> 31) & 0x7fffffffu) : 0;
    int l = lane >= from ? (int)(w & 0x7fffffffu) - 1 : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      c += __shfl_xor_sync(0xffffffffu, c, o);
      l = max(l, __shfl_xor_sync(0xffffffffu, l, o));
    }
    pc += c;
    pl = max(pl, l);
    if (pre) break;
  }
  if (lane == 0)
    lt_status_store(status + t,
                    lt_status(kStatusPrefix, pc + cnt, max(pl, last)));
  *ex_cnt = pc;
  *ex_last = pl;
}
