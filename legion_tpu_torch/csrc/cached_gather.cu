// K4 cached_gather: feature rows from the device cache, or from the host
// table through its registered (zero-copy) pointer on a miss.
//
// Replaces legion_tpu/cache/unified_cache.py::CachedFeatureSource.fetch
// (:261-271), which on the TPU was a slot_map gather, a pure_callback
// into native.gather_rows for the misses and a where. Per id:
//   id < 0             -> a zero row;
//   slot = slot_map[min(id, V-1)];
//   slot >= 0          -> cache row `slot` (device memory);
//   otherwise          -> the first F values of host row `id` (a zero row
//                         past the host table).
// The host table is [host_rows, P] (P >= F, its pitch) in one of two
// types, as the JAX package's host gather ships rows
// (legion_tpu/native/__init__.py::gather_rows):
//   bf16 rows (a bf16 cache: the trainer rounded the table once, at
//     set-up, with lg_gather_rows_bf16's round-to-nearest-even,
//     legion_tpu/native/src/legion_native.cpp) are copied as they are;
//   f32 rows go to an f32 cache as they are, or to a bf16 output rounded
//     here with the same formula (bf16_rne).
// Hits (valid ids with slot >= 0) are counted per block and added once per
// block into a device int32 scalar: no host sync.
//
// Bound on this card: the PCIe reads of the miss rows (200 B of bf16 per
// 100-wide row, 400 B of f32; the link moves tens of GB/s against 3.35
// TB/s for a cached row). What the card showed (NVIDIA H100 80GB HBM3 at
// 700 W; the link probe of chip_smoke.py): loads made by the SMs move
// scattered 400-byte rows of mapped host memory at 21-22 GB/s and rows in
// address order at 24-31 GB/s, whatever the alignment of the requests and
// however many are in flight, against 51 GB/s for the copy engine; a row
// asked for again right after it arrived costs next to nothing; and a
// warp's load costs one link request per 128-byte line it touches,
// whatever the bytes it asks for of the line. So the design reads as few
// rows as it can, in address order, and as few lines a row as the table
// allows: a bf16 row of 100 values at the trainer's pitch of 128 spans 2
// lines, where its f32 row spans 4.
//
// Design: the wrapper sorts the ids (values and positions), and a warp
// owns 32 consecutive sorted ids.
//   1. Each lane classifies one id (slot, zero row or miss).
//   2. The warp copies its cached and zero rows to their positions as
//      words (16, 8, 4 or 2 bytes, as the row width and pointers allow), at
//      device-memory speed: no lane waits on the host here.
//   3. Equal ids are neighbours now. The warp reads each distinct miss row
//      of its 32 once (a run cut by the warp's edge twice), kMissRows rows
//      at a time, a word a lane, every load started before the first
//      conversion or store, and writes it to every position of its run.
//      An f32 row is read in 16-byte chunks of four values, or a float a
//      lane where chunks do not fit (base or pitch not 16-byte aligned,
//      width not a multiple of 4). A bf16 row is read and written in the
//      widest word (16, 8, 4 or 2 bytes) that the table's base and pitch,
//      the row's bytes and the output allow: 8 bytes for 100 values.
// The grid is the wrapper's (cache/unified_cache.py::K4_BLOCKS): a block
// on half of the SMs keeps far more link requests in flight than the link
// serves, and leaves the other half to the kernels of another stream.
//
// K13 clique_gather, the requester side of the clique feature fetch, is
// this kernel with the slot read by lane (kByLane): it replaces
// legion_tpu/cache/collective.py::CliqueFeatureCache.fetch_cached's unsort
// and fetch's host fallback (:160-218). The "cache" is then the rows the
// owners sent back ([members * Kg * R_req, F]), and lane j's slot is
// lane_row[order[j]] (K12 bucket_by_owner's flat row of the request, -1
// where the id missed the clique cache or overflowed its owner's R_req);
// a lane without a row reads its id's host row, as a K4 miss, or a zero
// row without a host table (fetch_cached). The ids of all members are
// sorted together, so an id that two members miss is read once over the
// link. One member's lane may find an id in the clique while another's
// overflowed, so a run of equal ids is cut where the lanes' class turns
// between a miss and not one. Hits are counted by member (the lane's
// position over group_len).
#include <initializer_list>

#include "common.cuh"

constexpr int kMissRows = 4;      // miss rows in flight per warp
constexpr int kMissIters = 2;     // words per lane per row and pass
constexpr int kHitUnroll = 4;     // cached words in flight per lane
constexpr int32_t kZeroRow = -1;  // a lane's class when not a cache slot
constexpr int32_t kMissRow = -2;

__device__ __forceinline__ uint32_t bf16_rne(float x) {
  const uint32_t bits = __float_as_uint(x);
  return (bits + 0x7fffu + ((bits >> 16) & 1u)) >> 16;
}

// Step 2: the rows of this warp's `cnt` ids that are cached (cls >= 0) or
// zero, as words, each to its position; word t of the warp's run of words
// belongs to id t / wpr.
template <typename Word>
__device__ __forceinline__ void copy_device_rows(
    const void* __restrict__ cache, void* __restrict__ out, int cnt, int wpr,
    int32_t cls, int32_t pos, int lane) {
  const Word* c = reinterpret_cast<const Word*>(cache);
  Word* o = reinterpret_cast<Word*>(out);
  const int total = cnt * wpr;
  for (int t0 = 0; t0 < total; t0 += 32 * kHitUnroll) {
    Word v[kHitUnroll];
    int64_t at[kHitUnroll];
#pragma unroll
    for (int j = 0; j < kHitUnroll; ++j) {
      const int t = t0 + 32 * j + lane;
      const int r = min(t / wpr, 31);
      const int32_t s = __shfl_sync(0xffffffffu, cls, r);
      const int32_t p = __shfl_sync(0xffffffffu, pos, r);
      const int w = t - r * wpr;
      at[j] = t < total && s != kMissRow ? (int64_t)p * wpr + w : -1;
      v[j] = Word{};
      if (at[j] >= 0 && s >= 0) v[j] = c[(int64_t)s * wpr + w];
    }
#pragma unroll
    for (int j = 0; j < kHitUnroll; ++j)
      if (at[j] >= 0) o[at[j]] = v[j];
  }
}

// Four f32 host values into the output row at column `col`.
template <bool kBf16>
__device__ __forceinline__ void store_chunk(char* orow, int col, float4 v) {
  if constexpr (kBf16) {
    uint2 w;
    w.x = bf16_rne(v.x) | (bf16_rne(v.y) << 16);
    w.y = bf16_rne(v.z) | (bf16_rne(v.w) << 16);
    *reinterpret_cast<uint2*>(orow + 2 * (int64_t)col) = w;
  } else {
    *reinterpret_cast<float4*>(orow + 4 * (int64_t)col) = v;
  }
}

// Step 3 for a bf16 host table: rows rid[j] (j < kMissRows, r[j] >= 0) of
// the table, `wpr` words of W a row at `pitch` bytes apart, copied as they
// are to the positions of lanes r[j] .. end[j]-1 (output rows of wpr
// words).
template <typename W>
__device__ __forceinline__ void copy_host_words(
    const char* __restrict__ host, int64_t pitch, char* __restrict__ obase,
    int wpr, const int (&r)[kMissRows], const int (&end)[kMissRows],
    const int32_t (&rid)[kMissRows], int32_t pos, int lane) {
  const W* row[kMissRows];
#pragma unroll
  for (int j = 0; j < kMissRows; ++j)
    row[j] = reinterpret_cast<const W*>(host + (int64_t)rid[j] * pitch);
  for (int c0 = 0; c0 < wpr; c0 += 32 * kMissIters) {
    W v[kMissRows][kMissIters];
#pragma unroll
    for (int j = 0; j < kMissRows; ++j)
#pragma unroll
      for (int k = 0; k < kMissIters; ++k) {
        const int c = c0 + 32 * k + lane;
        v[j][k] = W{};
        if (r[j] >= 0 && c < wpr) v[j][k] = __ldcs(row[j] + c);
      }
#pragma unroll
    for (int j = 0; j < kMissRows; ++j)
      for (int m = max(r[j], 0); m < end[j]; ++m) {
        W* orow = reinterpret_cast<W*>(obase) +
                  (int64_t)__shfl_sync(0xffffffffu, pos, m) * wpr;
#pragma unroll
        for (int k = 0; k < kMissIters; ++k) {
          const int c = c0 + 32 * k + lane;
          if (c < wpr) orow[c] = v[j][k];
        }
      }
  }
}

constexpr int kMaxGroups = 64;   // members whose hits K13 counts apart

// The body of K4 (kByLane false) and K13 (true); each has its own entry
// point below, so that a profile names them apart. kBf16: the output (and
// the cache) is bf16; kHostBf16: so is the host table (then kBf16 too).
// word_bytes: the device rows' word; host_word: the host rows' (bf16
// table), or 16 for f32 chunks and 4 for a float a lane.
template <bool kBf16, bool kHostBf16, bool kByLane>
__device__ __forceinline__ void gather_body(
    const void* __restrict__ cache, const int32_t* __restrict__ slot_map,
    int64_t num_nodes, const void* __restrict__ host, int64_t host_rows,
    int64_t pitch, const int32_t* __restrict__ ids,
    const int64_t* __restrict__ order, void* __restrict__ out, int64_t n,
    int F, int word_bytes, int host_word, int32_t* __restrict__ hits,
    int64_t group_len, int n_groups) {
  static_assert(kBf16 || !kHostBf16, "a bf16 host table needs bf16 output");
  __shared__ int group_hits[kMaxGroups];
  if (kByLane) {
    for (int g = threadIdx.x; g < n_groups; g += blockDim.x)
      group_hits[g] = 0;
    __syncthreads();
  }
  constexpr int es = kBf16 ? 2 : 4;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int64_t groups = (n + 31) / 32;
  const int wpr = F * es / word_bytes;
  const int nch = F / 4;            // 16-byte chunks of an f32 host row
  const float* host_f = reinterpret_cast<const float*>(host);
  const char* host_b = reinterpret_cast<const char*>(host);
  const int64_t pitch_b = pitch * (kHostBf16 ? 2 : 4);
  const int hwpr = F * 2 / host_word;   // words of a bf16 host row
  char* obase = reinterpret_cast<char*>(out);
  int local = 0;
  for (int64_t g = (int64_t)blockIdx.x * (blockDim.x >> 5)
                   + (threadIdx.x >> 5);
       g < groups; g += warps) {
    const int64_t first = g * 32;
    const int cnt = (int)min((int64_t)32, n - first);
    // 1. classify
    int32_t id = -1, pos = 0, cls = kZeroRow;
    if (lane < cnt) {
      id = ids[first + lane];
      pos = (int32_t)order[first + lane];
      if (id >= 0) {
        const int32_t slot =
            kByLane ? slot_map[pos]
                    : slot_map[id < num_nodes ? id : num_nodes - 1];
        cls = slot >= 0 ? slot : (id < host_rows ? kMissRow : kZeroRow);
      }
    }
    if (kByLane) {
      if (cls >= 0) atomicAdd(&group_hits[pos / group_len], 1);
    } else {
      local += cls >= 0;
    }
    // 2. cached and zero rows
    switch (word_bytes) {
      case 16: copy_device_rows<uint4>(cache, out, cnt, wpr, cls, pos, lane);
        break;
      case 8: copy_device_rows<uint2>(cache, out, cnt, wpr, cls, pos, lane);
        break;
      case 4: copy_device_rows<uint32_t>(cache, out, cnt, wpr, cls, pos,
                                         lane);
        break;
      default: copy_device_rows<uint16_t>(cache, out, cnt, wpr, cls, pos,
                                          lane);
        break;
    }
    // 3. each distinct miss row once, to every position of its run of
    // equal ids (lanes past cnt hold id -1, which ends the last run)
    const int32_t before = __shfl_up_sync(0xffffffffu, id, 1);
    // K13: an id that one member's lane finds in the clique may overflow
    // for another member's, so a run also ends where the lanes' class
    // turns between a miss and not one (K4's equal ids share a class)
    const int32_t cls_before = __shfl_up_sync(0xffffffffu, cls, 1);
    const bool starts =
        lane == 0 || id != before ||
        (kByLane && (cls == kMissRow) != (cls_before == kMissRow));
    const unsigned edges = __ballot_sync(0xffffffffu, starts);
    unsigned heads = __ballot_sync(0xffffffffu, starts && cls == kMissRow);
    while (heads) {
      int r[kMissRows], end[kMissRows];
      int32_t rid[kMissRows];
#pragma unroll
      for (int j = 0; j < kMissRows; ++j) {
        r[j] = heads ? __ffs(heads) - 1 : -1;
        heads &= heads - 1;   // 0 stays 0
        const int at = r[j] & 31;
        const unsigned rest = at < 31 ? edges >> (at + 1) : 0u;
        end[j] = r[j] < 0 ? 0 : (rest ? at + __ffs(rest) : 32);
        rid[j] = __shfl_sync(0xffffffffu, id, at);
      }
      if constexpr (kHostBf16) {
        switch (host_word) {
          case 16: copy_host_words<uint4>(host_b, pitch_b, obase, hwpr, r,
                                          end, rid, pos, lane);
            break;
          case 8: copy_host_words<uint2>(host_b, pitch_b, obase, hwpr, r,
                                         end, rid, pos, lane);
            break;
          case 4: copy_host_words<uint32_t>(host_b, pitch_b, obase, hwpr, r,
                                            end, rid, pos, lane);
            break;
          default: copy_host_words<uint16_t>(host_b, pitch_b, obase, hwpr,
                                             r, end, rid, pos, lane);
            break;
        }
      } else if (host_word == 16) {
        const float* row[kMissRows];
#pragma unroll
        for (int j = 0; j < kMissRows; ++j)
          row[j] = host_f + (int64_t)rid[j] * pitch;
        for (int c0 = 0; c0 < nch; c0 += 32 * kMissIters) {
          float4 v[kMissRows][kMissIters];
#pragma unroll
          for (int j = 0; j < kMissRows; ++j)
#pragma unroll
            for (int k = 0; k < kMissIters; ++k) {
              const int c = c0 + 32 * k + lane;
              v[j][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (r[j] >= 0 && c < nch)
                v[j][k] = __ldcs(reinterpret_cast<const float4*>(row[j]) + c);
            }
#pragma unroll
          for (int j = 0; j < kMissRows; ++j)
            for (int m = max(r[j], 0); m < end[j]; ++m) {
              char* orow = obase + (int64_t)__shfl_sync(0xffffffffu, pos, m)
                                   * F * es;
#pragma unroll
              for (int k = 0; k < kMissIters; ++k) {
                const int c = c0 + 32 * k + lane;
                if (c < nch) store_chunk<kBf16>(orow, 4 * c, v[j][k]);
              }
            }
        }
      } else {
        const float* row[kMissRows];
#pragma unroll
        for (int j = 0; j < kMissRows; ++j)
          row[j] = host_f + (int64_t)rid[j] * pitch;
        for (int c0 = 0; c0 < F; c0 += 32) {
          const int c = c0 + lane;
          float v[kMissRows];
#pragma unroll
          for (int j = 0; j < kMissRows; ++j)
            v[j] = r[j] >= 0 && c < F ? __ldcs(row[j] + c) : 0.0f;
#pragma unroll
          for (int j = 0; j < kMissRows; ++j)
            for (int m = max(r[j], 0); m < end[j]; ++m) {
              char* orow = obase + (int64_t)__shfl_sync(0xffffffffu, pos, m)
                                   * F * es;
              if (c < F) {
                if constexpr (kBf16)
                  reinterpret_cast<uint16_t*>(orow)[c] =
                      (uint16_t)bf16_rne(v[j]);
                else
                  reinterpret_cast<float*>(orow)[c] = v[j];
              }
            }
        }
      }
    }
  }
  if (kByLane) {
    __syncthreads();
    for (int g = threadIdx.x; g < n_groups; g += blockDim.x)
      if (group_hits[g]) atomicAdd(hits + g, group_hits[g]);
  } else {
    // one atomic per block: warp sums, then the block's sum
    for (int o = 16; o > 0; o >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, o);
    __shared__ int warp_sums[kThreads / 32];
    if (lane == 0) warp_sums[threadIdx.x >> 5] = local;
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += warp_sums[i];
      if (s) atomicAdd(hits, s);
    }
  }
}

#define LT_GATHER_ARGS                                                      \
  const void* __restrict__ cache, const int32_t* __restrict__ slot_map,     \
      int64_t num_nodes, const void* __restrict__ host, int64_t host_rows,  \
      int64_t pitch, const int32_t* __restrict__ ids,                       \
      const int64_t* __restrict__ order, void* __restrict__ out, int64_t n, \
      int F, int word_bytes, int host_word, int32_t* __restrict__ hits,     \
      int64_t group_len, int n_groups
#define LT_GATHER_PASS                                                     \
  cache, slot_map, num_nodes, host, host_rows, pitch, ids, order, out, n, \
      F, word_bytes, host_word, hits, group_len, n_groups

template <bool kBf16, bool kHostBf16>
__global__ void __launch_bounds__(kThreads)
    cached_gather_kernel(LT_GATHER_ARGS) {
  gather_body<kBf16, kHostBf16, false>(LT_GATHER_PASS);
}

template <bool kBf16, bool kHostBf16>
__global__ void __launch_bounds__(kThreads)
    clique_gather_kernel(LT_GATHER_ARGS) {
  gather_body<kBf16, kHostBf16, true>(LT_GATHER_PASS);
}

// The widest word of 16, 8, 4 and 2 bytes (at least `least`) that divides
// the row's bytes and every address given.
static int widest_word(int64_t row_bytes, int least,
                       std::initializer_list<uintptr_t> addrs) {
  for (int wb = 16; wb > least; wb >>= 1) {
    bool fits = row_bytes % wb == 0;
    for (uintptr_t a : addrs) fits = fits && a % wb == 0;
    if (fits) return wb;
  }
  return least;
}

template <bool kBf16, bool kHostBf16, bool kByLane>
static int launch(const void* cache, const int32_t* slot_map,
                  int64_t num_nodes, const void* host, int64_t host_rows,
                  int64_t pitch, const int32_t* ids, const int64_t* order,
                  void* out, int64_t n, int64_t F, int32_t* hits,
                  int64_t max_blocks, int64_t group_len, int n_groups,
                  cudaStream_t stream) {
  const int64_t row_bytes = F * (kBf16 ? 2 : 4);
  // the device rows' word: what the row width, the cache and the output
  // allow
  const int word = widest_word(row_bytes, kBf16 ? 2 : 4,
                               {(uintptr_t)cache, (uintptr_t)out});
  // the host rows' word. bf16 rows: what the table's base and pitch, the
  // row and the output allow (no host table: any). f32 rows: 16-byte
  // chunks land on whole groups of four output values, else a float a
  // lane
  int host_word;
  if (kHostBf16)
    host_word = widest_word(row_bytes, 2,
                            {(uintptr_t)host, (uintptr_t)(pitch * 2),
                             (uintptr_t)out});
  else
    host_word = F % 4 == 0 && pitch % 4 == 0 && (uintptr_t)host % 16 == 0 &&
                (uintptr_t)out % 16 == 0 ? 16 : 4;
  // a warp takes 32 ids at a time: at most max_blocks blocks (the
  // wrapper's choice), and the warps walk the rest
  const int64_t warps_per_block = kThreads / 32;
  int64_t blocks = ((n + 31) / 32 + warps_per_block - 1) / warps_per_block;
  blocks = blocks < max_blocks ? blocks : max_blocks;
  auto kernel = kByLane ? clique_gather_kernel<kBf16, kHostBf16>
                        : cached_gather_kernel<kBf16, kHostBf16>;
  kernel<<<(unsigned int)blocks, kThreads, 0, stream>>>(
      cache, slot_map, num_nodes, host, host_rows, pitch, ids, order, out, n,
      (int)F, word, host_word, hits, group_len, n_groups);
  return (int)cudaGetLastError();
}

// The three forms: an f32 host table into f32 or bf16 rows, a bf16 table
// into bf16 rows (host_bf16 without bf16 is refused by the callers).
template <bool kByLane>
static int launch_form(int bf16, int host_bf16, const void* cache,
                       const int32_t* slot_map, int64_t num_nodes,
                       const void* host, int64_t host_rows, int64_t pitch,
                       const int32_t* ids, const int64_t* order, void* out,
                       int64_t n, int64_t F, int32_t* hits,
                       int64_t max_blocks, int64_t group_len, int n_groups,
                       cudaStream_t s) {
  if (host_bf16)
    return launch<true, true, kByLane>(cache, slot_map, num_nodes, host,
                                       host_rows, pitch, ids, order, out, n,
                                       F, hits, max_blocks, group_len,
                                       n_groups, s);
  if (bf16)
    return launch<true, false, kByLane>(cache, slot_map, num_nodes, host,
                                        host_rows, pitch, ids, order, out, n,
                                        F, hits, max_blocks, group_len,
                                        n_groups, s);
  return launch<false, false, kByLane>(cache, slot_map, num_nodes, host,
                                       host_rows, pitch, ids, order, out, n,
                                       F, hits, max_blocks, group_len,
                                       n_groups, s);
}

// cache [C, F] (bf16 if bf16 else f32), slot_map [num_nodes] int32,
// host [host_rows, pitch] (a device address of registered host memory):
// bf16 if host_bf16 (then bf16 too), else f32; pitch >= F. ids [n] int32
// in ascending order with order [n] int64, the position of each in the
// caller's batch (a permutation of 0 .. n-1) -> out [n, F] in the cache's
// dtype, out[order[j]] the row of ids[j]; *hits += hit count. All
// contiguous. max_blocks (> 0) caps the grid.
LT_EXPORT int lt_cached_gather(const void* cache, const int32_t* slot_map,
                               int64_t num_nodes, const void* host,
                               int64_t host_rows, int64_t pitch,
                               int host_bf16, const int32_t* ids,
                               const int64_t* order, int64_t n, int64_t F,
                               int bf16, void* out, int32_t* hits,
                               int64_t max_blocks, void* stream) {
  if (n == 0 || F == 0) return (int)cudaSuccess;
  if (F > (1 << 24) || n > INT32_MAX || max_blocks <= 0 ||
      max_blocks > INT32_MAX || pitch < F || (host_bf16 && !bf16))
    return (int)cudaErrorInvalidValue;
  return launch_form<false>(bf16, host_bf16, cache, slot_map, num_nodes,
                            host, host_rows, pitch, ids, order, out, n, F,
                            hits, max_blocks, n, 1, (cudaStream_t)stream);
}

// K13. rows [*, F] (bf16 if bf16 else f32): the rows the owners sent
// back; lane_row [n] int32, the row of each lane in the caller's order
// (-1: none); host [host_rows, pitch] registered host memory as for K4, or
// null with host_rows 0 (no host reads: zero rows); ids [n] int32
// ascending with order [n] int64 as for K4 -> out [n, F] in rows' dtype;
// hits [n_groups] int32, hits[p / group_len] += 1 for each lane p served
// from rows (n_groups <= 64). All contiguous.
LT_EXPORT int lt_clique_gather(const void* rows, const int32_t* lane_row,
                               const void* host, int64_t host_rows,
                               int64_t pitch, int host_bf16,
                               const int32_t* ids, const int64_t* order,
                               int64_t n, int64_t F, int bf16, void* out,
                               int32_t* hits, int64_t group_len,
                               int32_t n_groups, int64_t max_blocks,
                               void* stream) {
  if (n == 0 || F == 0) return (int)cudaSuccess;
  if (F > (1 << 24) || n > INT32_MAX || max_blocks <= 0 ||
      max_blocks > INT32_MAX || group_len <= 0 || n_groups <= 0 ||
      n_groups > kMaxGroups || (n - 1) / group_len >= n_groups ||
      (host == nullptr && host_rows != 0) ||
      (host != nullptr && pitch < F) || (host_bf16 && !bf16))
    return (int)cudaErrorInvalidValue;
  return launch_form<true>(bf16, host_bf16, rows, lane_row, n, host,
                           host_rows, pitch, ids, order, out, n, F, hits,
                           max_blocks, group_len, n_groups,
                           (cudaStream_t)stream);
}
