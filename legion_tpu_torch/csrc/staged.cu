// The staged host pipeline's device kernels (pipeline/staged.py): K19
// miss_compact, K20 staged_assemble and K21 merge_draws.
//
// K19 miss_compact replaces the lookup and the miss compaction of
// legion_tpu/pipeline/staged.py::StagedHostPipeline._feature_tail
// (:112-143), a jnp gather and a lax.sort of (lane if missed, else
// INT32_MAX, id, lane). For n member rows of M lanes (ids [n, M] int32, -1
// pad), a lane's hit is map[min(id, V - 1)] >= 0 for a valid id (the
// direct [V] map, fused; its value is written to payload), or slot >= 0
// (a slot from K11), or hit != 0 (the clique's served lanes). A lane
// misses when its id is valid and it does not hit. Outputs a member row:
// m_ids and m_pos [M], the missed lanes' ids and lanes in ascending lane
// order and -1 past n_miss (what the sort gives); rank [M], each lane's
// place among the misses (-1 for a hit or a pad); n_miss and hits [n].
// Bound on this card: device-memory bytes (the ids, one 4-byte map read a
// valid id, 16 bytes a lane written with the map; 12 and the slots or
// flags read without). The map reads are random (a batch's ids are in no
// order) and each moves a 32-byte sector: they, not the streams, set the
// map form's time. Design: two launches, no memset (K12's shape). Tiles of
// kCompactTile lanes of one member, kCompactItems a thread, in warp-wide
// steps. The count pass reads each lane's id once, resolves its hit once
// (the map's slot written to payload), and writes the tile's misses and
// hits to its word and its misses as one ballot word a warp step. The
// rank pass is a dependent launch (Hopper's programmatic serialization):
// its blocks start while the count pass ends and read their ids meanwhile,
// then read their ballot words (not the hit source again) and sum the
// words of the member's tiles before theirs. A tile stages its misses in
// lane order in shared memory and writes them as one run of m_ids and
// m_pos, and its other lanes as one run of -1 (the i-th lane of the member
// that is no miss at M - 1 - i, K8's way: [n_miss, M) is covered once and
// nothing is written twice), then each lane's rank; the member's last tile
// writes n_miss and hits. Chosen over a one pass that was built and timed
// against it: an atomic ticket, a memset of the status words, decoupled
// look-back of the misses and hits (dedup.cuh's). The ticket's atomic, the
// memset and the look-back's chain cost more than the rank pass's second
// launch and its reads: the one pass was the slower at every staged path's
// shape (NVIDIA H100 80GB HBM3, 700 W), and was removed. Both beat the
// earlier three launches (a count, a scan of the tiles' counts a member, a
// scatter that read the lanes again). Times: PERF.md §6.
//
// K20 staged_assemble replaces StagedHostPipeline._assemble (:375-388),
// a gather of the cache rows and a scatter of the shipped rows. For every
// lane i of n member rows: x[i] = staged[rank[i]] when 0 <= rank[i] < cap
// (a shipped miss: the host rows the bulk copy brought, [n, cap, F]);
// else rows[slot[i]] when slot[i] >= 0 (the cache's rows, slot past them
// clamped), or rows[i] when there is no slot (the clique's rows of the
// lanes, zero where not served); else a zero row. Each row of x is written
// once, in 16-, 8-, 4- or 2-byte words as the row's bytes and the
// pointers' alignment allow (bf16 and f32 rows are opaque words). Bound:
// bytes, a row read a lane and one written.
//
// K21 merge_draws replaces GraphAccess.merge_draws and
// CliqueTopoCache.merge_draws (legion_tpu/sampling/access.py:78-84,
// legion_tpu/cache/collective.py:431-434): out[m, f*F + i] = lanes[m,
// f*F + i] when served[m, i], else host[m, i, f] (the host's [F, fanout]
// draws, transposed to fanout-major here). Bound: bytes, a served byte a
// slot, a slot's lanes or its host draws, the merged lanes written.
// Design: a 2-D grid (slot tiles, members), no division a lane. A block
// reads its T slots' served bytes once and stages their host draws, one
// contiguous run, in shared memory with coalesced 16-byte loads (4-byte
// where the run is not aligned), in the same round as the served bytes:
// the draws of served slots too, bytes the bound does not count, for one
// round of latency less. It then writes the output column by column, a
// slot a thread: each column one coalesced run, a slot's lanes read only
// where served. Chosen over the earlier kernel (a lane a thread, the host
// draws read transposed, each sector read again for each draw of its
// slots, two 64-bit divisions a lane), which it beats at every staged
// path's shape. Times: PERF.md §6.
#include "common.cuh"

// K19's tiles: one member's lanes, kCompactItems a thread. Warp w of a
// tile holds its lanes [w * 32 * kCompactItems, (w + 1) * 32 *
// kCompactItems), lane l of step u the lane 32 u + l of them: every load
// and store of a step is one coalesced run, and a step's misses are one
// ballot word.
constexpr int kCompactThreads = 256;
constexpr int kCompactItems = 4;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kWarpLanes = 32 * kCompactItems;
constexpr int kCompactTile = kCompactThreads * kCompactItems;
constexpr int kTileWords = kCompactTile / 32;     // a tile's ballot words

// K19's passes: the count pass, then the rank pass.
constexpr int kCountPass = 0, kRankPass = 1;

struct HitSource {
  const int32_t* map;   // [V] direct map, fused (payload written), or null
  int64_t V;
  const int32_t* slot;  // [n, M] slots (>= 0 a hit), or null
  const uint8_t* hit;   // [n, M] served flags, or null
};

// The scratch: a word a tile (its counts of misses and hits), then the
// tiles' ballot words.
struct CompactScratch {
  int2* tile;
  uint32_t* bits;
};

inline CompactScratch compact_scratch(int32_t* scratch, int64_t tiles) {
  CompactScratch w;
  w.tile = reinterpret_cast<int2*>(scratch);
  w.bits = reinterpret_cast<uint32_t*>(w.tile + tiles);
  return w;
}

// Lanes j0 + 32 u of a member row (ids, slot, hit and payload already at
// the row): the ids (-1 past M), the misses as bits (bit u), the hits
// counted. With the map, each valid id's slot is read once and written to
// payload.
__device__ __forceinline__ void compact_load(
    const int32_t* __restrict__ ids, int j0, int M, const HitSource& src,
    int32_t* __restrict__ payload, int32_t* id, uint32_t* miss, int* nhit) {
#pragma unroll
  for (int u = 0; u < kCompactItems; ++u)
    id[u] = j0 + 32 * u < M ? ids[j0 + 32 * u] : -1;
  uint32_t mb = 0;
  int nh = 0;
#pragma unroll
  for (int u = 0; u < kCompactItems; ++u) {
    const int j = j0 + 32 * u;
    bool h;                     // a lane past M never hits
    if (src.map != nullptr) {
      const int32_t s = id[u] >= 0
          ? __ldg(src.map + (id[u] < src.V ? id[u] : src.V - 1)) : -1;
      if (j < M) payload[j] = s;
      h = s >= 0;
    } else if (src.slot != nullptr) {
      h = j < M && src.slot[j] >= 0;
    } else {
      h = j < M && src.hit[j] != 0;
    }
    nh += h;
    if (id[u] >= 0 && !h) mb |= 1u << u;
  }
  *miss = mb;
  *nhit = nh;
}

// Grid: a block a tile, n * tiles in all (member m's tile k is tile m *
// tiles + k). kCountPass: each lane's hit resolved once (the map's slot
// written to payload), the tile's misses and hits to its word and its
// ballot words to bits. kRankPass: the tile's ballots read back, the ids
// of its misses, the counts of the member's tiles before it summed from
// their words; then the tile's misses in lane order staged in shared
// memory and written as one run of m_ids and m_pos from the misses before
// it, pm, its other lanes as one run of -1 (the i-th lane of the member
// that is no miss at M - 1 - i: [n_miss, M) is covered once, with nothing
// written twice), each lane's rank; the member's last tile writes n_miss
// and hits.
template <int kPass>
__global__ void __launch_bounds__(kCompactThreads) miss_compact_kernel(
    const int32_t* __restrict__ ids, int32_t M, int32_t tiles, HitSource src,
    int32_t* __restrict__ payload, int32_t* __restrict__ m_ids,
    int32_t* __restrict__ m_pos, int32_t* __restrict__ rank,
    int32_t* __restrict__ n_miss, int32_t* __restrict__ hits,
    CompactScratch w) {
  __shared__ int s_pm, s_ph, s_wm[kCompactWarps], s_wh[kCompactWarps];
  __shared__ int32_t s_id[kPass == kCountPass ? 1 : kCompactTile];
  __shared__ int32_t s_pos[kPass == kCountPass ? 1 : kCompactTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const int m = t / tiles, tile = t - m * tiles;
  const int64_t base = (int64_t)m * M;
  const int j0 = tile * kCompactTile + warp * kWarpLanes + lane;
  uint32_t* bits = w.bits + (int64_t)t * kTileWords + warp * kCompactItems;
  int32_t id[kCompactItems];
  uint32_t ball[kCompactItems];
  uint32_t mb;
  int nh = 0;
  if (kPass == kRankPass) {
    // the ids are the caller's: read while the count pass ends, then wait
    // for its words (a programmatic launch: no effect in a plain one)
#pragma unroll
    for (int u = 0; u < kCompactItems; ++u)
      id[u] = j0 + 32 * u < M ? ids[base + j0 + 32 * u] : -1;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const uint32_t word = lane < kCompactItems ? bits[lane] : 0u;
    mb = 0;
#pragma unroll
    for (int u = 0; u < kCompactItems; ++u) {
      ball[u] = __shfl_sync(0xffffffffu, word, u);
      mb |= ((ball[u] >> lane) & 1u) << u;
    }
  } else {
    // every block of the count pass started: the rank pass may launch
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    HitSource row = src;
    if (src.slot != nullptr) row.slot = src.slot + base;
    if (src.hit != nullptr) row.hit = src.hit + base;
    compact_load(ids + base, j0, M, row,
                 payload != nullptr ? payload + base : nullptr, id, &mb,
                 &nh);
#pragma unroll
    for (int u = 0; u < kCompactItems; ++u)
      ball[u] = __ballot_sync(0xffffffffu, (mb >> u) & 1u);
    nh = __reduce_add_sync(0xffffffffu, nh);
  }
  int wm = 0;
#pragma unroll
  for (int u = 0; u < kCompactItems; ++u) wm += __popc(ball[u]);
  if (lane == 0) {
    s_wm[warp] = wm;
    s_wh[warp] = nh;
  }
  __syncthreads();
  int before = 0, tile_miss = 0, tile_hit = 0;
#pragma unroll
  for (int k = 0; k < kCompactWarps; ++k) {
    if (k < warp) before += s_wm[k];
    tile_miss += s_wm[k];
    tile_hit += s_wh[k];
  }
  int2* cnt = w.tile;
  if (kPass == kCountPass) {
    uint32_t word = 0;
#pragma unroll
    for (int u = 0; u < kCompactItems; ++u)
      if (lane == u) word = ball[u];
    if (lane < kCompactItems) bits[lane] = word;
    if (threadIdx.x == 0) cnt[t] = make_int2(tile_miss, tile_hit);
    return;
  }
  // the tile's misses in lane order into shared memory (their place in the
  // tile's run), each lane's rank within the tile
  int rk[kCompactItems];
  {
    int run = before;
    const uint32_t lt = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < kCompactItems; ++u) {
      rk[u] = -1;
      if ((mb >> u) & 1u) {
        const int e = run + __popc(ball[u] & lt);
        s_id[e] = id[u];
        s_pos[e] = j0 + 32 * u;
        rk[u] = e;
      }
      run += __popc(ball[u]);
    }
  }
  {
    // the counts of the member's tiles before this one, summed
    int vm = 0, vh = 0;
    for (int k = threadIdx.x; k < tile; k += kCompactThreads) {
      const int2 c = cnt[m * tiles + k];
      vm += c.x;
      vh += c.y;
    }
    vm = __reduce_add_sync(0xffffffffu, vm);
    vh = __reduce_add_sync(0xffffffffu, vh);
    tile_hit = cnt[t].y;
    __syncthreads();            // every warp has read s_wm and s_wh
    if (lane == 0) {
      s_wm[warp] = vm;
      s_wh[warp] = vh;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int a = 0, b = 0;
      for (int k = 0; k < kCompactWarps; ++k) a += s_wm[k], b += s_wh[k];
      s_pm = a;
      s_ph = b;
    }
  }
  __syncthreads();
  const int pm = s_pm;
  if (threadIdx.x == 0 && tile == tiles - 1) {
    n_miss[m] = pm + tile_miss;
    hits[m] = s_ph + tile_hit;
  }
  const int first = tile * kCompactTile;
  const int lanes = M - first < kCompactTile ? M - first : kCompactTile;
  const int tile_non = lanes - tile_miss;
  const int64_t tail = base + M - (first - pm) - tile_non;
  for (int e = threadIdx.x; e < tile_miss; e += kCompactThreads) {
    m_ids[base + pm + e] = s_id[e];
    m_pos[base + pm + e] = s_pos[e];
  }
  for (int e = threadIdx.x; e < tile_non; e += kCompactThreads) {
    m_ids[tail + e] = -1;
    m_pos[tail + e] = -1;
  }
#pragma unroll
  for (int u = 0; u < kCompactItems; ++u)
    if (j0 + 32 * u < M)
      rank[base + j0 + 32 * u] = rk[u] < 0 ? -1 : pm + rk[u];
}

// The int32 words of K19's scratch: two a tile's word, a tile's ballot
// words.
LT_EXPORT int64_t lt_miss_compact_scratch(int64_t n, int64_t M) {
  const int64_t tiles = n * ((M + kCompactTile - 1) / kCompactTile);
  return tiles * (2 + kTileWords);
}

// ids [n, M]; one of map ([V]), slot ([n, M]) or hit ([n, M]) given;
// payload [n, M] (map only, else null); m_ids, m_pos, rank [n, M]; n_miss,
// hits [n]; scratch of lt_miss_compact_scratch words, 8-byte aligned.
LT_EXPORT int lt_miss_compact(const int32_t* ids, int64_t n, int64_t M,
                              const int32_t* map, int64_t V,
                              const int32_t* slot, const uint8_t* hit,
                              int32_t* payload, int32_t* m_ids,
                              int32_t* m_pos, int32_t* rank, int32_t* n_miss,
                              int32_t* hits, int32_t* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaSuccess;
  if (M == 0) {
    cudaError_t e = cudaMemsetAsync(hits, 0, n * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemsetAsync(n_miss, 0, n * sizeof(int32_t), s);
  }
  const int64_t tiles = (M + kCompactTile - 1) / kCompactTile;
  if (M > 2147483647LL - kCompactTile || n * tiles > 2147483647LL ||
      ((uintptr_t)scratch & 7))
    return (int)cudaErrorInvalidValue;
  const unsigned total = (unsigned)(n * tiles);
  const CompactScratch w = compact_scratch(scratch, total);
  HitSource src{map, V, slot, hit};
  // each tile's word and ballot words written whole by the count pass
  miss_compact_kernel<kCountPass><<<total, kCompactThreads, 0, s>>>(
      ids, (int)M, (int)tiles, src, payload, m_ids, m_pos, rank, n_miss,
      hits, w);
  // the rank pass launched programmatically (Hopper's dependent launch):
  // its blocks start as the count pass ends and read the ids meanwhile
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(total);
  cfg.blockDim = dim3(kCompactThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, miss_compact_kernel<kRankPass>, ids, (int)M, (int)tiles, src,
      payload, m_ids, m_pos, rank, n_miss, hits, w);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K20 staged_assemble
// ---------------------------------------------------------------------------

template <typename Word>
__global__ void __launch_bounds__(kThreads) assemble_kernel(
    const Word* __restrict__ rows, int64_t num_rows,
    const int32_t* __restrict__ slot, const Word* __restrict__ staged,
    const int32_t* __restrict__ rank, int64_t cap, int64_t M, int64_t n,
    int64_t wpr, Word* __restrict__ x) {
  const int64_t total = n * M * wpr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / wpr;          // the lane, over all members
    const int64_t w = t - i * wpr;
    const int32_t r = rank[i];
    Word v{};
    if (r >= 0 && r < cap) {
      v = staged[((i / M) * cap + r) * wpr + w];
    } else if (slot == nullptr) {
      v = rows[i * wpr + w];
    } else {
      const int32_t s = slot[i];
      if (s >= 0) v = rows[(s < num_rows ? s : num_rows - 1) * wpr + w];
    }
    x[t] = v;
  }
}

template <typename Word>
static int assemble_launch(const void* rows, int64_t num_rows,
                           const int32_t* slot, const void* staged,
                           const int32_t* rank, int64_t cap, int64_t M,
                           int64_t n, int64_t row_bytes, void* x,
                           cudaStream_t s) {
  const int64_t wpr = row_bytes / (int64_t)sizeof(Word);
  assemble_kernel<Word><<<lt_grid(n * M * wpr), kThreads, 0, s>>>(
      (const Word*)rows, num_rows, slot, (const Word*)staged, rank, cap, M, n,
      wpr, (Word*)x);
  return (int)cudaGetLastError();
}

// rows [num_rows, F] with slot [n, M], or [n, M, F] with slot null;
// staged [n, cap, F]; rank [n, M]; x [n, M, F]; row_bytes = F * itemsize.
LT_EXPORT int lt_staged_assemble(const void* rows, int64_t num_rows,
                                 const int32_t* slot, const void* staged,
                                 const int32_t* rank, int64_t cap, int64_t M,
                                 int64_t n, int64_t row_bytes, void* x,
                                 void* stream) {
  if (n * M == 0 || row_bytes == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t a = (uintptr_t)rows | (uintptr_t)staged | (uintptr_t)x;
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return assemble_launch<uint4>(rows, num_rows, slot, staged, rank, cap, M,
                                  n, row_bytes, x, s);
  if (row_bytes % 8 == 0 && a % 8 == 0)
    return assemble_launch<uint2>(rows, num_rows, slot, staged, rank, cap, M,
                                  n, row_bytes, x, s);
  if (row_bytes % 4 == 0 && a % 4 == 0)
    return assemble_launch<uint32_t>(rows, num_rows, slot, staged, rank, cap,
                                     M, n, row_bytes, x, s);
  return assemble_launch<uint16_t>(rows, num_rows, slot, staged, rank, cap, M,
                                   n, row_bytes, x, s);
}

// ---------------------------------------------------------------------------
// K21 merge_draws
// ---------------------------------------------------------------------------

// The most shared words a block's staged host draws take (with the served
// bytes, 48 KB: no opt-in needed); a block takes T * stride of them.
constexpr int kMergeWords = 12224;

// Grid (slot tiles x fanout chunks, members). A block takes T slots
// [i0, i0 + T) of member m and fanout columns [f0, f0 + Fc): their served
// bytes, and the host's draws into shared memory (row stride `stride`,
// odd: the T slots of one column lie on distinct banks), loaded together
// in one round (16-byte loads where the block's draws are one aligned
// run; the draws of served slots too, which costs bytes and saves a
// round); then out[m, f * F + i] for each column, a slot a thread,
// coalesced: lanes where served (read only there), else the staged draw.
__global__ void __launch_bounds__(kThreads) merge_draws_kernel(
    const int32_t* __restrict__ lanes, const uint8_t* __restrict__ served,
    const int32_t* __restrict__ host, int64_t F, int32_t fanout, int32_t T,
    int32_t Fc, int32_t stride, int32_t slot_tiles,
    int32_t* __restrict__ out) {
  extern __shared__ int32_t s_draw[];
  __shared__ uint8_t s_srv[kThreads];
  const int chunk = blockIdx.x / slot_tiles;
  const int64_t i0 = (int64_t)(blockIdx.x - chunk * slot_tiles) * T;
  const int nT = (int)(F - i0 < T ? F - i0 : T);
  const int f0 = chunk * Fc;
  const int nF = fanout - f0 < Fc ? fanout - f0 : Fc;
  const int64_t row0 = (int64_t)blockIdx.y * F + i0;  // over all members
  if (threadIdx.x < nT) s_srv[threadIdx.x] = served[row0 + threadIdx.x];
  // element e of the block's draws is (slot e / nF, column e % nF); a
  // thread steps its (i, f) by the block's stride instead of dividing
  const int32_t* h = host + row0 * fanout + f0;
  const int n_el = nT * nF;
  if (nF == fanout && ((uintptr_t)h & 15) == 0) {
    const int n4 = n_el >> 2;
    const int step = 4 * kThreads, di = step / nF, df = step - di * nF;
    int i = 4 * threadIdx.x / nF, f = 4 * threadIdx.x - i * nF;
    for (int c = threadIdx.x; c < n4; c += kThreads) {
      const int4 v = reinterpret_cast<const int4*>(h)[c];
      const int32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s_draw[i * stride + f] = vv[u];
        if (++f == nF) f = 0, ++i;
      }
      // the four elements stepped (i, f) by 4; step the rest of the way
      i += di;
      f += df - 4;
      while (f < 0) f += nF, --i;
      while (f >= nF) f -= nF, ++i;
    }
    for (int e = 4 * n4 + threadIdx.x; e < n_el; e += kThreads) {
      const int i2 = e / nF;
      s_draw[i2 * stride + e - i2 * nF] = h[e];
    }
  } else {
    const int di = kThreads / nF, df = kThreads - di * nF;
    int i = threadIdx.x / nF, f = threadIdx.x - i * nF;
    for (int e = threadIdx.x; e < n_el; e += kThreads) {
      s_draw[i * stride + f] = h[(int64_t)i * fanout + f];
      i += di;
      f += df;
      if (f >= nF) f -= nF, ++i;
    }
  }
  __syncthreads();
  const int i = threadIdx.x & (T - 1);
  if (i >= nT) return;
  const int G = kThreads / T;
  const bool sv = s_srv[i] != 0;
  int f = threadIdx.x / T;
  int64_t at = ((int64_t)blockIdx.y * fanout + f0 + f) * F + i0 + i;
  for (; f < nF; f += G, at += G * F)
    out[at] = sv ? lanes[at] : s_draw[i * stride + f];
}

// The current device's SMs, read once a device (0 on an error).
static int merge_sms(cudaError_t* err) {
  static int sms[64];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess && dev >= 64) *err = cudaErrorInvalidDevice;
  if (*err != cudaSuccess) return 0;
  if (sms[dev] == 0)
    *err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                  dev);
  return *err == cudaSuccess ? sms[dev] : 0;
}

// lanes [n, fanout * F] fanout-major, served [n, F] (bool bytes), host
// [n, F, fanout] -> out [n, fanout * F]. T, a power of two, is the most
// slots that still give the device two blocks an SM (32 at least), halved
// until T rows of the fanout fit kMergeWords; a fanout wider than that
// alone is cut into chunks of columns.
LT_EXPORT int lt_merge_draws(const int32_t* lanes, const uint8_t* served,
                             const int32_t* host, int64_t n, int64_t F,
                             int32_t fanout, int32_t* out, void* stream) {
  if (n * F * fanout == 0) return (int)cudaSuccess;
  if (n > 65535 || F > 2147483647LL || fanout < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int sms = merge_sms(&err);
  if (err != cudaSuccess) return (int)err;
  int T = kThreads;
  while (T > 32 && ((F + T - 1) / T) * n < 2 * sms) T >>= 1;
  int Fc = fanout < kMergeWords - 1 ? fanout : kMergeWords - 1;
  while (T > 1 && (int64_t)T * (Fc | 1) > kMergeWords) T >>= 1;
  const int64_t slot_tiles = (F + T - 1) / T;
  const int64_t chunks = (fanout + Fc - 1) / Fc;
  if (slot_tiles * chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(slot_tiles * chunks), (unsigned)n);
  const int stride = Fc | 1;
  merge_draws_kernel<<<grid, kThreads, (size_t)T * stride * sizeof(int32_t),
                       (cudaStream_t)stream>>>(lanes, served, host, F, fanout,
                                               T, Fc, stride,
                                               (int)slot_tiles, out);
  return (int)cudaGetLastError();
}
