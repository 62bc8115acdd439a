// K8 dedup_sort: sort dedup around the sort.
//
// Replaces the XLA body of legion_tpu/sampling/sampler.py::
// NeighborSampler._dedup_sort (:250-293, no Pallas source) but its stable
// sort, which stays torch.sort. Two kernels:
//
// dedup_keys (:250-256): the sort's keys, keys[j] = ids[j] for j < P and
// cand[j - P] after, INT32_MAX where the id is negative (a pad).
//
// dedup_sort (:259-293): input skey [M] ascending and stag [M] (a
// permutation of [0, M)), the sorted keys and tags of the assigned prefix
// (tags < P) and a hop's E = M - P candidate lanes (tag P + lane);
// INT32_MAX keys are pads. For every sorted entry j:
//   run_start = valid and skey[j] != skey[j-1]; a run leads with its
//   authority (the existing entry, else the least lane);
//   a new head (run start, tag >= P) gets rank = the new heads before it,
//   position cum + rank while that is below cap, else -1;
//   every entry of the run takes its head's position (an existing head's
//   tag), and a candidate entry writes it to src_l[tag - P];
//   a kept new head writes its id to ids[cum + rank];
// and ids[cum + n_new, cum + W) = -1, W = min(E, cap), n_new = the kept
// heads. Everything is integer: the kernels equal the plain versions
// (sampling/sampler.py::dedup_keys_plain, dedup_sort_plain) bit for bit.
//
// Bound on this card: bytes (skey and stag read, src_l and the ids block
// written; 2.5 MB at Device hop 0, 13 MB at GCN's hop 1 with int64 tags:
// one to four microseconds) and, at these sizes, the latency of one
// launch. What it replaces was a dozen torch launches around a
// torch.cummax of M int64s (the fill-forward).
//
// Design: one launch, one pass, each entry of skey and stag loaded once.
// A block takes a tile number from an atomic ticket (tiles of kSortTile
// entries, kSortItems neighbouring entries a thread: fewer tiles, fewer
// look-back rounds), loads its entries, scans its (new heads, last run
// start) pairs, and gets the tiles before it by decoupled look-back
// (dedup.cuh). Then each thread walks its entries in order. The run a
// thread's first entries continue may start in an earlier tile: its start
// h is the max of the run starts before, and since no run starts between h
// and the thread, h's rank is the new heads before the thread less one. So
// one read of stag[h] gives the position that the carried run fills
// forward, however many tiles the run spans. Every position of the ids
// block is written once, in the walk, so no tile fills a tail alone: rank
// r < total (the new heads) by the head of rank r (its id if it is kept,
// else -1); r in [total, W) by the entries that are no new head, the i-th
// of them (i = j - the new heads before j) at r = M - 1 - i, which covers
// exactly [total, M) once. The tile numbered last writes n_new. The
// wrapper's scratch (the tile words and the ticket) is zeroed by one
// cudaMemsetAsync in the same call.
#include "dedup.cuh"

constexpr int32_t kPad = 2147483647;
constexpr int kSortItems = 8;
constexpr int kSortTile = kThreads * kSortItems;

__global__ void __launch_bounds__(kThreads) dedup_keys_kernel(
    const int32_t* __restrict__ ids, int64_t P,
    const int32_t* __restrict__ cand, int64_t E,
    int32_t* __restrict__ keys) {
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < P + E;
       j += (int64_t)gridDim.x * kThreads) {
    const int32_t v = j < P ? ids[j] : cand[j - P];
    keys[j] = v >= 0 ? v : kPad;
  }
}

template <typename Tag>
__global__ void __launch_bounds__(kThreads) dedup_sort_kernel(
    const int32_t* __restrict__ skey, const Tag* __restrict__ stag,
    int64_t M, int64_t P, const int32_t* __restrict__ cum_p, int32_t cap,
    int32_t* __restrict__ ids, int64_t ids_len, int32_t* __restrict__ src_l,
    int32_t* __restrict__ n_new, uint64_t* status,
    unsigned int* ticket) {
  __shared__ int s_tile, s_pc, s_pl;
  __shared__ int32_t s_edge[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int t = s_tile;
  const int64_t j0 = (int64_t)t * kSortTile + threadIdx.x * kSortItems;
  int32_t key[kSortItems];
  Tag tg[kSortItems];
#pragma unroll
  for (int q = 0; q < kSortItems; q += 4) {
    lt_load4(skey, j0 + q, M, kPad, key + q);
    lt_load4(stag, j0 + q, M, (Tag)0, tg + q);
  }

  // the key before this thread's first: the previous thread's last
  int32_t prev = __shfl_up_sync(0xffffffffu, key[kSortItems - 1], 1);
  if (lane == 31) s_edge[warp] = key[kSortItems - 1];
  __syncthreads();
  if (lane == 0)
    prev = warp > 0 ? s_edge[warp - 1]
                    : (j0 > 0 && j0 - 1 < M ? skey[j0 - 1] : -1);

  bool rs[kSortItems];
  int cnt = 0, last = -1;
#pragma unroll
  for (int u = 0; u < kSortItems; ++u) {
    rs[u] = j0 + u < M && key[u] != kPad && key[u] != prev;
    prev = key[u];
    if (rs[u]) {
      last = (int)(j0 + u);
      if ((int64_t)tg[u] >= P) ++cnt;
    }
  }
  int ex_c, ex_l, tot_c, tot_l;
  lt_block_scan_sum_max(cnt, last, &ex_c, &ex_l, &tot_c, &tot_l);
  if (warp == 0) {
    int pc, pl;
    lt_tile_lookback(status, t, tot_c, tot_l, &pc, &pl);
    if (lane == 0) {
      s_pc = pc;
      s_pl = pl;
    }
  }
  __syncthreads();
  const int tile_c = s_pc;
  int c = tile_c + ex_c;               // new heads before this thread's
  const int h = max(s_pl, ex_l);       // the last run start before them
  const int32_t cum = *cum_p;
  const int64_t E = M - P;
  const int64_t W = E < cap ? E : cap;  // the ids block [cum, cum + W)

  // the position of the run that the first entries continue
  int32_t cur = -1;
  if (h >= 0 && j0 < M && key[0] != kPad && !rs[0]) {
    const int64_t th = (int64_t)stag[h];
    cur = th < P ? (int32_t)th : (cum + c - 1 < cap ? cum + c - 1 : -1);
  }
#pragma unroll
  for (int u = 0; u < kSortItems; ++u) {
    const int64_t j = j0 + u;
    if (j >= M) break;
    const int64_t tag = (int64_t)tg[u];
    // the rank this entry fills in the ids block, and with what
    int64_t r;
    int32_t v = -1;
    if (rs[u] && tag >= P) {
      const int32_t pos = cum + c;
      cur = pos < cap ? pos : -1;
      v = pos < cap ? key[u] : -1;
      r = c++;
    } else {
      if (rs[u]) cur = (int32_t)tag;
      r = M - 1 - (j - c);
    }
    const int64_t at = cum + r;
    if (r < W && at >= 0 && at < ids_len) ids[at] = v;
    if (tag >= P) src_l[tag - P] = key[u] != kPad ? cur : -1;
  }

  if (t == (int)gridDim.x - 1 && threadIdx.x == 0) {
    const int64_t total = (int64_t)tile_c + tot_c;
    const int64_t room = cap > cum ? (int64_t)cap - cum : 0;
    *n_new = (int32_t)(total < room ? total : room);
  }
}

template <typename Tag>
static int launch(const int32_t* skey, const Tag* stag, int64_t M,
                  int64_t P, const int32_t* cum, int32_t cap, int32_t* ids,
                  int64_t ids_len, int32_t* src_l, int32_t* n_new,
                  int32_t* scratch, void* stream) {
  const int64_t tiles = M > 0 ? (M + kSortTile - 1) / kSortTile : 1;
  if (tiles > 2147483647 || P < 0 || P > M || ((uintptr_t)scratch & 7))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint64_t* status = (uint64_t*)scratch;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * 8, s);
  if (e != cudaSuccess) return (int)e;
  dedup_sort_kernel<Tag><<<(unsigned)tiles, kThreads, 0, s>>>(
      skey, stag, M, P, cum, cap, ids, ids_len, src_l, n_new, status,
      (unsigned int*)(status + tiles));
  return (int)cudaGetLastError();
}

// keys [P + E] from ids[:P] and cand [E].
LT_EXPORT int lt_dedup_keys(const int32_t* ids, int64_t P,
                            const int32_t* cand, int64_t E, int32_t* keys,
                            void* stream) {
  dedup_keys_kernel<<<lt_grid(P + E > 0 ? P + E : 1), kThreads, 0,
                      (cudaStream_t)stream>>>(ids, P, cand, E, keys);
  return (int)cudaGetLastError();
}

// scratch: 2 * (tiles + 1) int32, 8-byte aligned (tiles = max(1, ceil(M /
// kSortTile))): the tiles' status words, then the ticket; zeroed here.
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
