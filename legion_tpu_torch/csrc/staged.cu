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
// Three launches: a count of each tile's misses (and the hits, one atomic
// a block), one scan of the tiles' counts a member, and a pass that ranks
// the misses of a tile in lane order (warp ballots) and scatters them.
//
// K20 staged_assemble replaces StagedHostPipeline._assemble (:375-388),
// a gather of the cache rows and a scatter of the shipped rows. For every
// lane i of n member rows: x[i] = staged[rank[i]] when 0 <= rank[i] < cap
// (a shipped miss: the host rows the bulk copy brought, [n, cap, F]);
// else rows[slot[i]] when slot[i] >= 0 (the cache's rows, slot past them
// clamped), or rows[i] when there is no slot (the clique's rows of the
// lanes, zero where not served); else a zero row. Each row of x is written
// once, in 16-, 8-, 4- or 2-byte words as the row's bytes and the
// pointers' alignment allow (bf16 and f32 rows are opaque words).
//
// K21 merge_draws replaces GraphAccess.merge_draws and
// CliqueTopoCache.merge_draws (legion_tpu/sampling/access.py:78-84,
// legion_tpu/cache/collective.py:431-434): out[m, f*F + i] = lanes[m,
// f*F + i] when served[m, i], else host[m, i, f] (the host's [F, fanout]
// draws, transposed to fanout-major here).
//
// Bound on this card: device-memory bytes, for all three. K19 reads the
// ids and the map entries (one random 4-byte read a valid id) and writes
// 16 bytes a lane; K20 reads a row a lane and writes one; K21 reads and
// writes 4 bytes a lane and a byte a slot. Simple and right first: the
// counting pass's map reads are the random ones, and the scatter pass
// reads back what the count wrote.
#include "common.cuh"

constexpr int kCompactItems = 8;                      // lanes a thread
constexpr int kCompactTile = kThreads * kCompactItems;  // lanes a block

struct HitSource {
  const int32_t* map;   // [V] direct map, fused (payload written), or null
  int64_t V;
  const int32_t* slot;  // [n, M] slots (>= 0 a hit), or null
  const uint8_t* hit;   // [n, M] served flags, or null
};

// Lane j of member row m: 1 if its id is valid and it does not hit. With a
// map, the lane's slot is written to payload (pass 1 only).
__device__ __forceinline__ int lane_miss(const HitSource& src, int32_t id,
                                         int64_t j, int32_t* payload,
                                         int* hit_out) {
  int h;
  if (src.map != nullptr) {
    int32_t s = -1;
    if (id >= 0) s = src.map[id < src.V ? id : src.V - 1];
    if (payload != nullptr) payload[j] = s;
    h = s >= 0;
  } else if (src.slot != nullptr) {
    h = src.slot[j] >= 0;
  } else {
    h = src.hit[j] != 0;
  }
  *hit_out = h;
  return id >= 0 && !h;
}

__device__ __forceinline__ int block_sum(int v, int* shared) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += shared[w];
  return t;
}

// Pass 1: grid (tiles, n). Each tile's misses to cnt[m * tiles + tile],
// its hits added to hits[m]; with a map, payload written.
__global__ void __launch_bounds__(kThreads) compact_count_kernel(
    const int32_t* __restrict__ ids, int64_t M, int64_t tiles,
    HitSource src, int32_t* __restrict__ payload, int32_t* __restrict__ cnt,
    int32_t* __restrict__ hits) {
  __shared__ int s_red[kThreads / 32];
  const int64_t m = blockIdx.y;
  const int64_t base = m * M;
  int misses = 0, nh = 0;
  for (int k = 0; k < kCompactItems; ++k) {
    const int64_t lane = (int64_t)blockIdx.x * kCompactTile + k * kThreads
                         + threadIdx.x;
    if (lane < M) {
      int h;
      misses += lane_miss(src, ids[base + lane], base + lane, payload, &h);
      nh += h;
    }
  }
  misses = block_sum(misses, s_red);
  nh = block_sum(nh, s_red);
  if (threadIdx.x == 0) {
    cnt[m * tiles + blockIdx.x] = misses;
    if (nh) atomicAdd(&hits[m], nh);
  }
}

// Pass 2: grid (n). One block a member: the exclusive scan of its tiles'
// counts in place, and the member's total to n_miss[m].
__global__ void __launch_bounds__(kThreads) compact_scan_kernel(
    int32_t* __restrict__ cnt, int64_t tiles, int32_t* __restrict__ n_miss) {
  __shared__ int s_warp[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* c = cnt + (int64_t)blockIdx.x * tiles;
  int carry = 0;
  for (int64_t t0 = 0; t0 < tiles; t0 += kThreads) {
    const int64_t t = t0 + threadIdx.x;
    const int v = t < tiles ? c[t] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    __syncthreads();
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before += s_warp[w];
      total += s_warp[w];
    }
    if (t < tiles) c[t] = carry + before + x - v;
    carry += total;
  }
  if (threadIdx.x == 0) n_miss[blockIdx.x] = carry;
}

// Pass 3: grid (tiles, n). A tile's misses ranked in lane order from the
// tile's base, scattered to m_ids/m_pos; every lane's rank; the lanes at
// and past n_miss of m_ids/m_pos set to -1 (no miss lands there).
__global__ void __launch_bounds__(kThreads) compact_scatter_kernel(
    const int32_t* __restrict__ ids, int64_t M, int64_t tiles,
    HitSource src, const int32_t* __restrict__ payload,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ n_miss,
    int32_t* __restrict__ m_ids, int32_t* __restrict__ m_pos,
    int32_t* __restrict__ rank) {
  __shared__ int s_warp[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m = blockIdx.y;
  const int64_t base = m * M;
  const int64_t nm = n_miss[m];
  int64_t carry = cnt[m * tiles + blockIdx.x];
  // the map's slots were written by pass 1: read them back in lane order
  HitSource back = src;
  if (src.map != nullptr) {
    back.map = nullptr;
    back.slot = payload;
  }
  for (int k = 0; k < kCompactItems; ++k) {
    const int64_t j = (int64_t)blockIdx.x * kCompactTile + k * kThreads
                      + threadIdx.x;
    int miss = 0;
    int32_t id = -1;
    if (j < M) {
      int h;
      id = ids[base + j];
      miss = lane_miss(back, id, base + j, nullptr, &h);
    }
    const unsigned ball = __ballot_sync(0xffffffffu, miss);
    const int within = __popc(ball & ((1u << lane) - 1u));
    __syncthreads();
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before += s_warp[w];
      total += s_warp[w];
    }
    if (j < M) {
      const int64_t r = carry + before + within;
      rank[base + j] = miss ? (int32_t)r : -1;
      if (miss) {
        m_ids[base + r] = id;
        m_pos[base + r] = (int32_t)j;
      }
      if (j >= nm) {
        m_ids[base + j] = -1;
        m_pos[base + j] = -1;
      }
    }
    carry += total;
  }
}

// The words of K19's scratch: the tiles' counts of every member.
LT_EXPORT int64_t lt_miss_compact_scratch(int64_t n, int64_t M) {
  const int64_t tiles = (M + kCompactTile - 1) / kCompactTile;
  return n * (tiles > 0 ? tiles : 1);
}

// ids [n, M]; one of map ([V]), slot ([n, M]) or hit ([n, M]) given;
// payload [n, M] (map only, else null); m_ids, m_pos, rank [n, M]; n_miss,
// hits [n] (hits zeroed here); scratch of lt_miss_compact_scratch words.
LT_EXPORT int lt_miss_compact(const int32_t* ids, int64_t n, int64_t M,
                              const int32_t* map, int64_t V,
                              const int32_t* slot, const uint8_t* hit,
                              int32_t* payload, int32_t* m_ids,
                              int32_t* m_pos, int32_t* rank, int32_t* n_miss,
                              int32_t* hits, int32_t* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaSuccess;
  cudaError_t e = cudaMemsetAsync(hits, 0, n * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  if (M == 0) return (int)cudaMemsetAsync(n_miss, 0, n * sizeof(int32_t), s);
  const int64_t tiles = (M + kCompactTile - 1) / kCompactTile;
  HitSource src{map, V, slot, hit};
  const dim3 grid((unsigned)tiles, (unsigned)n);
  compact_count_kernel<<<grid, kThreads, 0, s>>>(ids, M, tiles, src, payload,
                                                 scratch, hits);
  compact_scan_kernel<<<(unsigned)n, kThreads, 0, s>>>(scratch, tiles,
                                                        n_miss);
  compact_scatter_kernel<<<grid, kThreads, 0, s>>>(
      ids, M, tiles, src, payload, scratch, n_miss, m_ids, m_pos, rank);
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

__global__ void __launch_bounds__(kThreads) merge_draws_kernel(
    const int32_t* __restrict__ lanes, const uint8_t* __restrict__ served,
    const int32_t* __restrict__ host, int64_t n, int64_t F, int32_t fanout,
    int32_t* __restrict__ out) {
  const int64_t per = (int64_t)fanout * F;
  const int64_t total = n * per;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t m = t / per;
    const int64_t e = t - m * per;
    const int64_t f = e / F;
    const int64_t i = e - f * F;
    out[t] = served[m * F + i] ? lanes[t]
                               : host[(m * F + i) * fanout + f];
  }
}

// lanes [n, fanout * F] fanout-major, served [n, F] (bool bytes), host
// [n, F, fanout] -> out [n, fanout * F].
LT_EXPORT int lt_merge_draws(const int32_t* lanes, const uint8_t* served,
                             const int32_t* host, int64_t n, int64_t F,
                             int32_t fanout, int32_t* out, void* stream) {
  const int64_t total = n * F * fanout;
  if (total == 0) return (int)cudaSuccess;
  merge_draws_kernel<<<lt_grid(total), kThreads, 0, (cudaStream_t)stream>>>(
      lanes, served, host, n, F, fanout, out);
  return (int)cudaGetLastError();
}
