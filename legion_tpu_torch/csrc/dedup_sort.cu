// K8 dedup_sort: sort dedup after the sort.
//
// Replaces the XLA body of legion_tpu/sampling/sampler.py::
// NeighborSampler._dedup_sort (:259-293, no Pallas source) after its
// stable sort, which stays torch.sort. Input: skey [M] ascending and stag
// [M] (a permutation of [0, M)), the sorted keys and tags of the assigned
// prefix (tags < P) and a hop's E = M - P candidate lanes (tag P + lane);
// INT32_MAX keys are pads. For every sorted entry j:
//   run_start = valid and skey[j] != skey[j-1]; a run leads with its
//   authority (the existing entry, else the least lane);
//   a new head (run start, tag >= P) gets rank = the new heads before it,
//   position cum + rank while that is below cap, else -1;
//   every entry of the run takes its head's position (an existing head's
//   tag), and a candidate entry writes it to src_l[tag - P];
//   a kept new head writes its id to ids[cum + rank];
// and ids[cum + n_new, cum + W) = -1, W = min(E, cap), n_new = the kept
// heads. Everything is integer: the kernel equals the plain version
// (sampling/sampler.py::dedup_sort_plain) bit for bit.
//
// Bound on this card: bytes (skey and stag read, src_l and the ids block
// written; a few MB at the main path's shapes, microseconds) and the two
// launches. What it replaces was a dozen torch launches around a
// torch.cummax of M int64s (the fill-forward), 0.57 ms a step on the
// GraphSAGE paths and 3.5 ms on GCN's exact-dedup hops.
//
// Design: two passes over tiles of kTile entries (kItems a thread), no
// atomics and no spinning. Pass 1 writes each tile's count of new heads
// and its last run start. Pass 2 reduces the tiles before its own from
// those (a few values a thread), scans its own threads in the block, and
// walks each thread's entries in order. The run a thread's first entries
// continue may start in an earlier tile: its start is the max of the run
// starts before, and since no run starts between that head h and the
// thread, h's rank is the new heads before the thread less one. So one
// read of stag[h] gives the position that the carried run fills forward,
// however many tiles the run spans. The last tile writes n_new and the -1
// tail of the ids block.
#include "dedup.cuh"

constexpr int32_t kPad = 2147483647;

template <typename Tag>
__global__ void __launch_bounds__(kThreads) dedup_sort_count(
    const int32_t* __restrict__ skey, const Tag* __restrict__ stag,
    int64_t M, int64_t P, int32_t* __restrict__ tile_cnt,
    int32_t* __restrict__ tile_last) {
  const int64_t j0 = (int64_t)blockIdx.x * kTile + threadIdx.x * kItems;
  int cnt = 0, last = -1;
  int32_t prev = (j0 > 0 && j0 <= M) ? skey[j0 - 1] : -1;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int64_t j = j0 + u;
    if (j < M) {
      const int32_t key = skey[j];
      if (key != kPad && key != prev) {
        last = (int)j;
        if ((int64_t)stag[j] >= P) ++cnt;
      }
      prev = key;
    }
  }
  int ec, el, tc, tl;
  lt_block_scan_sum_max(cnt, last, &ec, &el, &tc, &tl);
  if (threadIdx.x == 0) {
    tile_cnt[blockIdx.x] = tc;
    tile_last[blockIdx.x] = tl;
  }
}

template <typename Tag>
__global__ void __launch_bounds__(kThreads) dedup_sort_assign(
    const int32_t* __restrict__ skey, const Tag* __restrict__ stag,
    int64_t M, int64_t P, const int32_t* __restrict__ cum_p, int32_t cap,
    int32_t* __restrict__ ids, int64_t ids_len, int32_t* __restrict__ src_l,
    int32_t* __restrict__ n_new, const int32_t* __restrict__ tile_cnt,
    const int32_t* __restrict__ tile_last) {
  const int t = blockIdx.x;
  // new heads and the last run start over the tiles before this one
  int pc = 0, pl = -1;
  for (int p = threadIdx.x; p < t; p += kThreads) {
    pc += tile_cnt[p];
    pl = max(pl, tile_last[p]);
  }
  int unused0, unused1, tile_c, tile_l;
  lt_block_scan_sum_max(pc, pl, &unused0, &unused1, &tile_c, &tile_l);

  const int64_t j0 = (int64_t)t * kTile + threadIdx.x * kItems;
  int32_t key[kItems];
  int64_t tag[kItems];
  bool rs[kItems];
  int cnt = 0, last = -1;
  int32_t prev = (j0 > 0 && j0 <= M) ? skey[j0 - 1] : -1;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int64_t j = j0 + u;
    key[u] = kPad;
    tag[u] = 0;
    rs[u] = false;
    if (j < M) {
      key[u] = skey[j];
      tag[u] = (int64_t)stag[j];
      rs[u] = key[u] != kPad && key[u] != prev;
      prev = key[u];
      if (rs[u]) {
        last = (int)j;
        if (tag[u] >= P) ++cnt;
      }
    }
  }
  int ex_c, ex_l, tot_c, tot_l;
  lt_block_scan_sum_max(cnt, last, &ex_c, &ex_l, &tot_c, &tot_l);
  int c = tile_c + ex_c;           // new heads before this thread's entries
  const int h = max(tile_l, ex_l); // the last run start before them
  const int32_t cum = *cum_p;

  // the position of the run that the first entries continue
  int32_t cur = -1;
  if (h >= 0 && j0 < M && key[0] != kPad && !rs[0]) {
    const int64_t th = (int64_t)stag[h];
    cur = th < P ? (int32_t)th : (cum + c - 1 < cap ? cum + c - 1 : -1);
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int64_t j = j0 + u;
    if (j >= M) break;
    if (rs[u]) {
      if (tag[u] < P) {
        cur = (int32_t)tag[u];
      } else {
        const int32_t pos = cum + c;
        cur = pos < cap ? pos : -1;
        if (pos < cap && pos < ids_len) ids[pos] = key[u];
        ++c;
      }
    }
    if (tag[u] >= P) src_l[tag[u] - P] = key[u] != kPad ? cur : -1;
  }

  if (t == (int)gridDim.x - 1) {
    // n_new, and the rest of the block [cum + n_new, cum + W) is -1
    const int64_t total = (int64_t)tile_c + tot_c;
    const int64_t room = cap > cum ? (int64_t)cap - cum : 0;
    const int64_t n = total < room ? total : room;
    const int64_t E = M - P;
    const int64_t W = E < cap ? E : cap;
    if (threadIdx.x == 0) *n_new = (int32_t)n;
    for (int64_t r = n + threadIdx.x; r < W; r += kThreads) {
      const int64_t at = cum + r;
      if (at >= 0 && at < ids_len) ids[at] = -1;
    }
  }
}

template <typename Tag>
static int launch(const int32_t* skey, const Tag* stag, int64_t M,
                  int64_t P, const int32_t* cum, int32_t cap, int32_t* ids,
                  int64_t ids_len, int32_t* src_l, int32_t* n_new,
                  int32_t* scratch, void* stream) {
  const int64_t tiles = M > 0 ? (M + kTile - 1) / kTile : 1;
  if (tiles > 2147483647 || P < 0 || P > M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dedup_sort_count<Tag><<<(unsigned)tiles, kThreads, 0, s>>>(
      skey, stag, M, P, scratch, scratch + tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dedup_sort_assign<Tag><<<(unsigned)tiles, kThreads, 0, s>>>(
      skey, stag, M, P, cum, cap, ids, ids_len, src_l, n_new, scratch,
      scratch + tiles);
  return (int)cudaGetLastError();
}

// scratch: 2 * tiles int32 (tiles = max(1, ceil(M / kTile)));
// stag is int64 when tag64, else int32.
LT_EXPORT int lt_dedup_sort(const int32_t* skey, const void* stag,
                            int32_t tag64, int64_t M, int64_t P,
                            const int32_t* cum, int32_t cap, int32_t* ids,
                            int64_t ids_len, int32_t* src_l, int32_t* n_new,
                            int32_t* scratch, void* stream) {
  if (tag64)
    return launch<int64_t>(skey, (const int64_t*)stag, M, P, cum, cap, ids,
                           ids_len, src_l, n_new, scratch, stream);
  return launch<int32_t>(skey, (const int32_t*)stag, M, P, cum, cap, ids,
                         ids_len, src_l, n_new, scratch, stream);
}
