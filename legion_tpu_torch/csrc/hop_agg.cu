// K15 hop_mean: the per-destination sum (or mean) and count of a hop's
// valid neighbour rows, placed at the hop's offset of a zeroed output;
// and its backward on a gathered hop (hop_mean_grad).
//
// Replaces legion_tpu/ops/hop_agg.py::hop_neighbor_sum / hop_neighbor_mean
// and place_rows (XLA on the TPU), with, on the aligned last hop over the
// device feature table, legion_tpu/cache/unified_cache.py::
// DeviceFeatureSource.fetch (:221). There XLA sums the fetched rows where
// it gathers them and never writes them. The backward replaces XLA's
// transpose of the gather in hop_gather_msgs (legion_tpu/ops/hop_agg.py:43),
// a scatter-add.
//
// Layout (the sampler's fanout-major lanes): lane f*F + i is draw f of
// frontier slot i; it is valid iff src[lane] >= 0. The row of a valid lane
// is, by form:
//   (a) gathered:  rows[src[lane]]          (src clamped to the last row)
//   (b) aligned:   rows[aligned + lane]
//   (c) fetched:   rows[ids[lane]]          (ids already offset by the
//                  hop's aligned position; an id < 0 is a zero row that
//                  still counts, an id past the table clamps, as K1)
// out[offset + i] = sum (or sum / max(count, 1)) of slot i's valid rows in
// f32, count[offset + i] = their number; every other row of out and count
// is written with zeros. offset is a device scalar, read here (no host
// sync) and placed as JAX's dynamic_update_slice places its start: a
// negative one wrapped by num_dst, then clamped to [0, num_dst - F].
//
// Forward. Bound on this card: device-memory bytes. Each valid lane costs
// one row read (256 B for a 128-wide bf16 row); src (and ids) are read
// once; out is written once in f32. There is no arithmetic to speak of.
//
// Design: a block takes a tile of ts consecutive slots. It first stages
// the tile's src entries (and ids for form (c)), draw by draw: each draw's
// entries are one contiguous run of src, so the loads coalesce, and all of
// a thread's loads are issued before the first is used. Staged is each
// lane's row (or a pad, or a zero row). A group of the least power of two
// >= c threads (at most 32) reads a row of c pieces (16, 8, 4 or 2 bytes,
// the widest the row width and the base's alignment allow: K4's 100-wide
// bf16 rows are 200 bytes at 8-byte alignment, 8-byte pieces). A group
// owns slots g, g + ng, ... of the tile, and walks their (slot, draw)
// pairs in one run, kRounds rows in flight: a round that runs past the end
// of a slot already has the next slot's rows in flight. A slot's draws are
// summed in draw order in f32, so forms (b) and (c) over the same rows
// give the same bits. Blocks past the tiles write the zero rows outside
// [offset, offset + F).
//
// The backward of (b) is here too: d rows[aligned + lane] = d out[offset +
// lane % F] (divided by max(count, 1) for the mean), zero for a pad lane,
// rounded once to the rows' dtype; every lane owns its row, no atomics.
//
// Backward of (a) (hop_mean_grad): d rows[r] = sum over the valid lanes
// whose (clamped) src is r of d out[offset + lane % F], each divided by
// max(count, 1) for the mean: summed in f32 in ascending lane order and
// written once, in the rows' dtype, every row (zero where no lane reads
// it). Bound: device-memory bytes (src, the hop's F rows of d out and
// their counts read, d rows written once); on this card the L2 too, where
// a lane rereads its destination's d out row (512 B at 128 f32 columns: d
// out is 4 MB at Device's layer 1 and stays in the L2). No accumulator of
// the rows' size is kept, nothing is written twice, and no atomic adds a
// row: the result is the same bits from run to run.
//
// Design, all on the card with no host sync, eight launches:
//  1. a memset of the counts;
//  2. count: a block combines its tile's lanes of one row in shared
//     memory, then one atomic a row a tile gives each lane its place in
//     its row (the heavy rows sit next to each other and would queue on
//     the same L2 lines with an atomic a lane); for the mean, more blocks
//     divide the hop's F rows of d out by their counts once (dq);
//  3-4. scan, in two passes over tiles of rows: where each row's run goes
//     (runs of at most kLong lanes in row order, longer ones after them),
//     the list of long runs with their chunks of kLong lanes, and the
//     rows where a walk starts;
//  5. fill: each lane at its place in its row's run;
//  6. sort: each run into ascending lane order: a thread a run of up to
//     kLong (a network in registers), a block a run of up to kBlockSort
//     (a bitonic network, a shuffle for partners in a warp, shared memory
//     only between warps), and, for a hub, blocks a window of the lane
//     space each (a bitmap of the run's lanes in the window, read back in
//     order after the run's lanes before the window);
//  7. gather: a warp a walk (up to kWalkRows rows starting within one
//     span of kWalkSpan lanes, so the walks are balanced by lanes and not
//     rows: the sampler numbers rows by first appearance, and the heavy
//     ones come first), reading a window of 32 lanes at once and then
//     kGRounds rows in flight, storing each row as it passes its end; and
//     a warp a chunk of a long run, into an f32 row of scratch;
//  8. combine: a block a long run, its warps adding consecutive ranges of
//     its chunks in order, then the warps' sums in order.
#include <cuda_bf16.h>

#include <climits>

#include "dedup.cuh"
#include "lane_groups.cuh"

constexpr int kRounds = 4;        // rows in flight a thread (forward)
constexpr int kStage = 12288;     // staged lanes a tile at most (48 KB)
constexpr int32_t kPadLane = -1;  // a staged pad lane: no row, no count
constexpr int32_t kZeroRow = -2;  // a valid lane without a row (an id < 0)

// BYTES bytes at p as 32-bit words (a 2-byte piece in the low half).
template <int BYTES>
__device__ __forceinline__ void load_piece(const void* p, uint32_t* w) {
  if constexpr (BYTES == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (BYTES == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (BYTES == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// acc += the piece's values as floats (a 32-bit word holds two bf16, the
// low half first).
template <typename T, int BYTES>
__device__ __forceinline__ void add_piece(float* acc, const uint32_t* w) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < BYTES / 4; ++k) acc[k] += __uint_as_float(w[k]);
  } else if constexpr (BYTES == 2) {
    acc[0] += __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int k = 0; k < BYTES / 4; ++k) {
      acc[2 * k] += __uint_as_float(w[k] << 16);
      acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// n floats at p, as one store where n allows (out rows are 16-byte
// aligned at a width that is a multiple of 4, and a piece of n floats
// starts at a multiple of n).
template <int N>
__device__ __forceinline__ void store_floats(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The hop's offset as JAX's dynamic_update_slice places a start: a
// negative one wrapped by num_dst, then clamped to [0, num_dst - F].
__device__ __forceinline__ int64_t placed_offset(const int32_t* hop_offset,
                                                 int64_t F,
                                                 int64_t num_dst) {
  int64_t o = *hop_offset;
  if (o < 0) o += num_dst;
  return o < 0 ? 0 : (o > num_dst - F ? num_dst - F : o);
}

// tshift: log2 of the threads of a row; ts slots a tile, spg of them a
// group (ng = kThreads >> tshift groups; a group past the tile's slots
// idles, as where a large fanout leaves ts below ng); blocks from `tiles`
// on write the zero rows. Dynamic shared memory: fanout * ts int32.
template <typename T, int BYTES>
__global__ void __launch_bounds__(kThreads, 4) hop_mean_kernel(
    const T* __restrict__ rows, int64_t num_rows, int d,
    const int32_t* __restrict__ src, const int32_t* __restrict__ ids,
    int64_t aligned, const int32_t* __restrict__ hop_offset, int64_t F,
    int fanout, int64_t num_dst, int mean, int tshift, int ts, int spg,
    int64_t tiles, float* __restrict__ out, float* __restrict__ count) {
  constexpr int kElems = BYTES / (int)sizeof(T);   // values of a piece
  constexpr int kWords = BYTES < 4 ? 1 : BYTES / 4;
  extern __shared__ int32_t ent[];  // [fanout][ts]: row, kPadLane, kZeroRow
  const int64_t offset = placed_offset(hop_offset, F, num_dst);
  if ((int64_t)blockIdx.x >= tiles) {
    // the rows of out outside [offset, offset + F): zeros, a warp a row
    const int warps = kThreads / 32, lane = threadIdx.x & 31;
    for (int64_t j = ((int64_t)blockIdx.x - tiles) * warps +
                     (threadIdx.x >> 5);
         j < num_dst - F; j += ((int64_t)gridDim.x - tiles) * warps) {
      const int64_t r = j < offset ? j : j + F;
      for (int c = lane; c < d; c += 32) out[r * d + c] = 0.0f;
      if (lane == 0) count[r] = 0.0f;
    }
    return;
  }
  const int64_t i0 = (int64_t)blockIdx.x * ts;
  const int nt = (int)(F - i0 < ts ? F - i0 : ts);
  const int n_ent = fanout * ts;
  // form (b) stages lane numbers and reads rows[aligned + lane]
  const int64_t base = (ids == nullptr && aligned >= 0) ? aligned : 0;
  for (int k0 = threadIdx.x; k0 < n_ent; k0 += 4 * kThreads) {
    int32_t s[4], v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * kThreads;
      const int f = k / ts, t = k - f * ts;
      s[u] = -1;
      v[u] = 0;
      if (k < n_ent && t < nt) {
        const int64_t e = (int64_t)f * F + i0 + t;
        s[u] = __ldg(src + e);
        if (ids != nullptr) v[u] = __ldg(ids + e);
        else if (aligned >= 0) v[u] = (int32_t)e;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * kThreads;
      if (k >= n_ent) continue;
      int32_t x = kPadLane;
      if (s[u] >= 0) {
        if (ids != nullptr)
          x = v[u] < 0 ? kZeroRow
                       : (int32_t)(v[u] < num_rows ? v[u] : num_rows - 1);
        else if (aligned >= 0)
          x = v[u];
        else
          x = (int32_t)(s[u] < num_rows ? s[u] : num_rows - 1);
      }
      ent[k] = x;
    }
  }
  __syncthreads();
  const int tpr = 1 << tshift;
  const int t = threadIdx.x & (tpr - 1);   // this thread's piece of a row
  const int g = threadIdx.x >> tshift;     // its group: slots g, g + ng, ...
  const int ng = kThreads >> tshift;
  const int mine = g < nt ? min(spg, (nt - 1 - g) / ng + 1) : 0;
  const int pairs = mine * fanout;         // (slot, draw), slot-major
  const int cpr = d / kElems;              // pieces of a row
  for (int c0 = 0; c0 < cpr; c0 += tpr) {
    const int c = c0 + t;
    const bool live = c < cpr;
    float acc[kElems];
#pragma unroll
    for (int k = 0; k < kElems; ++k) acc[k] = 0.0f;
    int n_valid = 0;
    int j = 0, f = 0;  // the (slot, draw) of the next pair
    for (int p0 = 0; p0 < pairs; p0 += kRounds) {
      int32_t x[kRounds];
      int jj[kRounds];
      bool last[kRounds];
      uint32_t piece[kRounds][kWords];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        x[u] = p0 + u < pairs ? ent[f * ts + g + j * ng] : kPadLane;
        jj[u] = j;
        last[u] = f == fanout - 1;
        if (++f == fanout) f = 0, ++j;
      }
#pragma unroll
      for (int u = 0; u < kRounds; ++u)
        if (x[u] >= 0 && live)
          load_piece<BYTES>(rows + (base + x[u]) * d + (int64_t)c * kElems,
                            piece[u]);
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        if (p0 + u >= pairs) break;
        if (x[u] != kPadLane) ++n_valid;
        if (x[u] >= 0 && live) add_piece<T, BYTES>(acc, piece[u]);
        if (last[u]) {
          // the slot's last draw: store its row, start the next slot
          const int64_t dst = offset + i0 + g + jj[u] * ng;
          if (live) {
            if (mean) {
              const float den = (float)max(n_valid, 1);
#pragma unroll
              for (int k = 0; k < kElems; ++k) acc[k] = acc[k] / den;
            }
            store_floats<kElems>(out + dst * d + (int64_t)c * kElems, acc);
          }
          if (c0 == 0 && t == 0) count[dst] = (float)n_valid;
#pragma unroll
          for (int k = 0; k < kElems; ++k) acc[k] = 0.0f;
          n_valid = 0;
        }
      }
    }
  }
}

template <typename T>
__global__ void hop_mean_bwd_kernel(
    const float* __restrict__ dout, const float* __restrict__ count,
    const int32_t* __restrict__ src, const int32_t* __restrict__ hop_offset,
    int64_t F, int64_t E, int d, int64_t aligned, int64_t num_dst, int mean,
    T* __restrict__ drows) {
  const int64_t offset = placed_offset(hop_offset, F, num_dst);
  const int64_t total = E * d;
  for (int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       x < total; x += (int64_t)gridDim.x * blockDim.x) {
    const int64_t lane = x / d;
    const int c = (int)(x - lane * d);
    float v = 0.0f;
    if (src[lane] >= 0) {
      const int64_t dst = offset + lane % F;
      v = dout[dst * d + c];
      if (mean) v = v / fmaxf(count[dst], 1.0f);
    }
    if constexpr (sizeof(T) == 4)
      drows[(aligned + lane) * d + c] = v;
    else
      drows[(aligned + lane) * d + c] = __float2bfloat16_rn(v);
  }
}

template <typename T, int BYTES>
static int launch(const T* rows, int64_t num_rows, int64_t d,
                  const int32_t* src, const int32_t* ids, int64_t aligned,
                  const int32_t* hop_offset, int64_t F, int fanout,
                  int64_t num_dst, int mean, float* out, float* count,
                  cudaStream_t stream) {
  const int cpr = (int)(d / (BYTES / (int)sizeof(T)));
  int tshift = 0;
  while ((1 << tshift) < cpr && tshift < 5) ++tshift;
  const int ng = kThreads >> tshift;
  // two slots a group where the tiles fill the card with blocks anyway
  // (the walk over both then runs without a tail), one where they would
  // not; fewer slots a tile where the staged lanes would pass kStage
  int spg = F >= (int64_t)ng * 2 * 132 * 8 ? 2 : 1;
  int ts = ng * spg;
  if ((int64_t)ts * fanout > kStage) {
    spg = 1;
    ts = ng < kStage / fanout ? ng : kStage / fanout;
  }
  const int64_t tiles = (F + ts - 1) / ts;
  int64_t zero = (num_dst - F + kThreads / 32 - 1) / (kThreads / 32);
  if (zero > 132 * 8) zero = 132 * 8;
  const int64_t blocks = tiles + zero;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  hop_mean_kernel<T, BYTES><<<(unsigned int)blocks, kThreads,
                              (size_t)ts * fanout * sizeof(int32_t),
                              stream>>>(
      rows, num_rows, (int)d, src, ids, aligned, hop_offset, F, fanout,
      num_dst, mean, tshift, ts, spg, tiles, out, count);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_widest(const T* rows, int64_t num_rows, int64_t d,
                         const int32_t* src, const int32_t* ids,
                         int64_t aligned, const int32_t* hop_offset,
                         int64_t F, int fanout, int64_t num_dst, int mean,
                         float* out, float* count, cudaStream_t s) {
  const int64_t row_bytes = d * (int64_t)sizeof(T);
  const uintptr_t base = (uintptr_t)rows;
#define LT_HOP_MEAN(B)                                                   \
  if (row_bytes % (B) == 0 && base % (B) == 0)                           \
    return launch<T, (B)>(rows, num_rows, d, src, ids, aligned, hop_offset, \
                          F, fanout, num_dst, mean, out, count, s);
  LT_HOP_MEAN(16)
  LT_HOP_MEAN(8)
  LT_HOP_MEAN(4)
#undef LT_HOP_MEAN
  if constexpr (sizeof(T) == 2)
    return launch<T, 2>(rows, num_rows, d, src, ids, aligned, hop_offset, F,
                        fanout, num_dst, mean, out, count, s);
  return (int)cudaErrorMisalignedAddress;
}

// rows [num_rows, d] contiguous, bf16 (bf16 != 0) or f32; src [fanout * F]
// int32; ids [fanout * F] int32 or null (form (c)); aligned >= 0 for form
// (b), -1 otherwise; hop_offset a device int32 scalar; out [num_dst, d]
// and count [num_dst] f32, both written whole. num_dst >= F, fanout <=
// kStage, rows (and, in form (a), src) indexed below 2^31 a lane.
LT_EXPORT int lt_hop_mean(const void* rows, int64_t num_rows, int64_t d,
                          int bf16, const int32_t* src, const int32_t* ids,
                          int64_t aligned, const int32_t* hop_offset,
                          int64_t F, int fanout, int64_t num_dst, int mean,
                          float* out, float* count, void* stream) {
  if (num_dst == 0 || d == 0) return (int)cudaSuccess;
  if (F > num_dst || fanout <= 0 || fanout > kStage || num_rows <= 0 ||
      d > 2147483647LL || (int64_t)fanout * F > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_widest<__nv_bfloat16>(
        (const __nv_bfloat16*)rows, num_rows, d, src, ids, aligned,
        hop_offset, F, fanout, num_dst, mean, out, count, s);
  return launch_widest<float>((const float*)rows, num_rows, d, src, ids,
                              aligned, hop_offset, F, fanout, num_dst, mean,
                              out, count, s);
}

// Form (b)'s backward: drows [*, d] in the rows' dtype, zeroed by the
// caller; lanes [aligned, aligned + E) are written.
LT_EXPORT int lt_hop_mean_bwd(const float* dout, const float* count,
                              const int32_t* src, const int32_t* hop_offset,
                              int64_t F, int64_t E, int64_t d,
                              int64_t aligned, int64_t num_dst, int mean,
                              void* drows, int bf16, void* stream) {
  if (E == 0 || d == 0) return (int)cudaSuccess;
  if (F > num_dst || d > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = lt_grid(E * d);
  if (bf16)
    hop_mean_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        dout, count, src, hop_offset, F, E, (int)d, aligned, num_dst, mean,
        (__nv_bfloat16*)drows);
  else
    hop_mean_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        dout, count, src, hop_offset, F, E, (int)d, aligned, num_dst, mean,
        (float*)drows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// hop_mean_grad: the backward of form (a)
// ---------------------------------------------------------------------------

// kLong (lane_groups.cuh): a run sorted by one thread up to this; longer:
// by a block, and summed in chunks
constexpr int kGRounds = 4;         // rows of d out in flight a thread
constexpr int kWalkRows = 31;       // rows of a walk at most
constexpr int kWalkSpan = 32;       // a walk's rows start within one span
constexpr int kCountLanes = 4 * kThreads;  // a count block's tile
constexpr int kCountSlots = 2 * kCountLanes;
constexpr int kScanRows = 8 * kThreads;    // rows of a scan block
constexpr int kBitWords = 1024;     // a hub's bitmap window (4 KB)
constexpr int kBlockSort = 1024;    // a long run sorted in shared memory
                                    // up to this; longer: through a bitmap

// The scratch of one call, carved from one int32 buffer. cnt and the three
// counters after it (long runs, chunks, walks) are zeroed by one memset.
struct GradScratch {
  int32_t *cnt, *counters, *start, *sstart, *tot, *ticket, *pos, *lanes,
      *walks;
  int4* longs;  // a long run: (its row, its first chunk, its start, lanes)
  int2* items;  // a chunk: (its long run, its index in the run)
  float* part;  // [max_chunks, d]
  float* dq;    // [F, d]: the mean's d out rows, each divided by its count
  int64_t words;
};

// a walk ends at kWalkRows rows or where a row starts in the next span
__host__ __device__ inline int64_t grad_max_walks(int64_t S, int64_t E) {
  return S / kWalkRows + E / kWalkSpan + 2;
}

static GradScratch grad_scratch(int32_t* base, int64_t S, int64_t E,
                                int64_t d, int64_t F) {
  GradScratch g;
  int64_t at = 0;
  auto take = [&](int64_t n) {
    int32_t* p = base == nullptr ? nullptr : base + at;
    at += (n + 3) / 4 * 4;  // 16-byte aligned pieces
    return p;
  };
  const int64_t chunks = lt_max_chunks(E);
  g.cnt = take(S + 3);
  g.counters = g.cnt == nullptr ? nullptr : g.cnt + S;
  g.start = take(S);
  g.sstart = take(S + 1);
  g.tot = take(2 * ((S + kScanRows - 1) / kScanRows));
  g.ticket = take(E);
  g.pos = take(E);
  g.lanes = take(E);
  g.walks = take(grad_max_walks(S, E));
  g.longs = reinterpret_cast<int4*>(take(4 * lt_max_longs(E)));
  g.items = reinterpret_cast<int2*>(take(2 * chunks));
  g.part = reinterpret_cast<float*>(take(chunks * d));
  g.dq = reinterpret_cast<float*>(take(F * d));
  g.words = at;
  return g;
}

// Count: cnt[r] = the valid lanes whose clamped src is r; ticket[e] = a
// lane's place among them (any order: the sort fixes it). A block combines
// its tile's lanes of one row in shared memory first: a row takes one
// atomic a tile, not one a lane (the heavy rows, hundreds of lanes each,
// sit next to each other in cnt, and their atomics queue on the same L2
// lines). Blocks from count_blocks on divide, for the mean, the hop's F
// rows of d out by their counts once: dq[i] = d out[offset + i] /
// max(count[offset + i], 1), as the plain version divides before it sums.
__global__ void __launch_bounds__(kThreads) hop_grad_count_kernel(
    const int32_t* __restrict__ src, int64_t E, int32_t S,
    int32_t* __restrict__ cnt, int32_t* __restrict__ ticket, int count_blocks,
    const float* __restrict__ dout, const float* __restrict__ count,
    const int32_t* __restrict__ hop_offset, int64_t F, int64_t num_dst,
    int d, float* __restrict__ dq) {
  // a slot's row, and its lanes in the tile, then its place in cnt's count
  __shared__ int32_t key[kCountSlots], num[kCountSlots];
  if ((int)blockIdx.x >= count_blocks) {
    // four neighbouring columns a thread (d % 4 == 0 where the gather
    // reads 16 bytes; one column a thread otherwise)
    const int64_t offset = placed_offset(hop_offset, F, num_dst);
    const int per = d % 4 == 0 ? 4 : 1;
    for (int64_t x = ((int64_t)(blockIdx.x - count_blocks) * kThreads +
                      threadIdx.x) * per;
         x < F * d;
         x += (int64_t)(gridDim.x - count_blocks) * kThreads * per) {
      const float q = fmaxf(count[offset + x / d], 1.0f);
      if (per == 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(dout + offset * d + x);
        *reinterpret_cast<float4*>(dq + x) =
            make_float4(v.x / q, v.y / q, v.z / q, v.w / q);
      } else {
        dq[x] = dout[offset * d + x] / q;
      }
    }
    return;
  }
  constexpr int kPer = kCountLanes / kThreads;
  for (int64_t e0 = (int64_t)blockIdx.x * kCountLanes; e0 < E;
       e0 += (int64_t)count_blocks * kCountLanes) {
    for (int i = threadIdx.x; i < kCountSlots; i += kThreads)
      key[i] = -1, num[i] = 0;
    __syncthreads();
    int32_t s[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t e = e0 + threadIdx.x + u * kThreads;
      s[u] = e < E ? __ldg(src + e) : -1;
    }
    int slot[kPer], rank[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      slot[u] = -1;
      if (s[u] >= 0) {
        const int32_t r = s[u] < S ? s[u] : S - 1;
        int h = (int)(((uint32_t)r * 2654435761u) >> 20) & (kCountSlots - 1);
        for (;;) {
          const int32_t was = atomicCAS(&key[h], -1, r);
          if (was == -1 || was == r) break;
          h = (h + 1) & (kCountSlots - 1);
        }
        slot[u] = h;
        rank[u] = atomicAdd(&num[h], 1);
      }
    }
    __syncthreads();
    // every slot's row and lanes read first, then all the atomics in
    // flight together, then their results stored
    constexpr int kSl = kCountSlots / kThreads;
    int32_t kr[kSl], kn[kSl];
#pragma unroll
    for (int u = 0; u < kSl; ++u)
      kr[u] = key[u * kThreads + threadIdx.x],
      kn[u] = num[u * kThreads + threadIdx.x];
#pragma unroll
    for (int u = 0; u < kSl; ++u)
      if (kn[u] > 0) kn[u] = atomicAdd(cnt + kr[u], kn[u]);
#pragma unroll
    for (int u = 0; u < kSl; ++u) num[u * kThreads + threadIdx.x] = kn[u];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (slot[u] >= 0)
        ticket[e0 + threadIdx.x + u * kThreads] = num[slot[u]] + rank[u];
    __syncthreads();
  }
}

// A row's lanes, split by where its run goes: runs of at most kLong lanes
// in the first region (the walks'), longer ones after them.
__device__ __forceinline__ void split_counts(const int32_t* cnt, int64_t r0,
                                             int32_t S, int* v, int* small,
                                             int* big) {
  lt_load4(cnt, r0, S, 0, v);
  lt_load4(cnt, r0 + 4, S, 0, v + 4);
  *small = 0, *big = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (v[k] > kLong) *big += v[k];
    else *small += v[k];
  }
}

// Scan, pass 1: the lanes of rows [b * kScanRows, ...) in each region,
// tot[2 b] and tot[2 b + 1].
__global__ void __launch_bounds__(kThreads) hop_grad_tiles_kernel(
    const int32_t* __restrict__ cnt, int32_t S, int32_t* __restrict__ tot) {
  int v[8], small, big, ex, el, ts, tb, tl;
  split_counts(cnt, (int64_t)blockIdx.x * kScanRows + threadIdx.x * 8, S, v,
               &small, &big);
  lt_block_scan_sum_max(small, -1, &ex, &el, &ts, &tl);
  lt_block_scan_sum_max(big, -1, &ex, &el, &tb, &tl);
  if (threadIdx.x == 0) tot[2 * blockIdx.x] = ts, tot[2 * blockIdx.x + 1] = tb;
}

// The places of a block's items in three lists (counters[0..3)): n[i] a
// thread; its place in list i is its block's base there (one atomic a
// list, the three in flight together) plus the block's exclusive scan.
// base and total get the block's base and count in each list.
__device__ __forceinline__ void block_claim3(int* n, int32_t* counters,
                                             int* base, int* total) {
  __shared__ int warp_sh[kThreads / 32][3], base_sh[3], total_sh[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    inc[i] = n[i];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc[i], o);
      if (lane >= o) inc[i] += y;
    }
    if (lane == 31) warp_sh[warp][i] = inc[i];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int tot = 0;
    for (int w = 0; w < kThreads / 32; ++w) tot += warp_sh[w][threadIdx.x];
    total_sh[threadIdx.x] = tot;
    base_sh[threadIdx.x] = tot > 0 ? atomicAdd(counters + threadIdx.x, tot)
                                   : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int before = base_sh[i] + inc[i] - n[i];
    for (int w = 0; w < warp; ++w) before += warp_sh[w][i];
    n[i] = before;
    base[i] = base_sh[i];
    total[i] = total_sh[i];
  }
}

// Whether row r starts a walk: every kWalkRows rows, and where a row's
// first lane lies in another span of kWalkSpan than the row before's.
__device__ __forceinline__ bool walk_starts(int64_t r, int sst, int prev) {
  return r % kWalkRows == 0 || sst / kWalkSpan != prev / kWalkSpan;
}

// Scan, pass 2: start[r], where row r's run goes (the first region, then
// the long runs'), and sstart[r], the first region's lanes of rows before
// r (sstart[S] = all of them); the long runs on their list with their
// chunks; the rows that start a walk on theirs.
__global__ void __launch_bounds__(kThreads) hop_grad_scan_kernel(
    const int32_t* __restrict__ cnt, int32_t S,
    const int32_t* __restrict__ tot, int tiles, int32_t* __restrict__ start,
    int32_t* __restrict__ sstart, int32_t* __restrict__ counters,
    int4* __restrict__ longs, int2* __restrict__ items,
    int32_t* __restrict__ walks) {
  const int64_t r0 = (int64_t)blockIdx.x * kScanRows + threadIdx.x * 8;
  int v[8], small, big, exs, exb, t;
  split_counts(cnt, r0, S, v, &small, &big);
  // the first region's lanes of the row before r0
  const int before = r0 > 0 && r0 <= S && cnt[r0 - 1] <= kLong
                         ? cnt[r0 - 1] : 0;
  int bs = 0, bb = 0, as = 0;
  for (int i = threadIdx.x; i < tiles; i += kThreads) {
    const int ts = tot[2 * i], tb = tot[2 * i + 1];
    as += ts;
    if (i < (int)blockIdx.x) bs += ts, bb += tb;
  }
  int ex, el, tl;
  lt_block_scan_sum_max(bs, -1, &ex, &el, &bs, &tl);
  lt_block_scan_sum_max(bb, -1, &ex, &el, &bb, &tl);
  lt_block_scan_sum_max(as, -1, &ex, &el, &as, &tl);
  lt_block_scan_sum_max(small, -1, &exs, &el, &t, &tl);
  lt_block_scan_sum_max(big, -1, &exb, &el, &t, &tl);
  int at[3] = {0, 0, 0};  // long runs, chunks, walks: this thread's
  {
    int rs = bs + exs, prev = rs - before;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (r0 + k >= S) break;
      if (v[k] > kLong) ++at[0], at[1] += (v[k] + kLong - 1) / kLong;
      if (walk_starts(r0 + k, rs, prev)) ++at[2];
      prev = rs;
      if (v[k] <= kLong) rs += v[k];
    }
  }
  int base[3], total[3];
  block_claim3(at, counters, base, total);
  int li = at[0], ci = at[1], wi = at[2];
  // the block's long runs, in order: (first chunk, place on the list)
  __shared__ int2 runs_sh[kScanRows];
  int rs = bs + exs, rb = as + bb + exb, prev = rs - before;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t r = r0 + k;
    if (r >= S) break;
    const int n = v[k];
    sstart[r] = rs;
    if (walk_starts(r, rs, prev)) walks[wi++] = (int32_t)r;
    prev = rs;
    if (n > kLong) {
      start[r] = rb;
      runs_sh[li - base[0]] = make_int2(ci, li);
      longs[li++] = make_int4((int)r, ci, rb, n);
      ci += (n + kLong - 1) / kLong;
      rb += n;
    } else {
      start[r] = rs;
      rs += n;
    }
    if (r == S - 1) sstart[S] = rs;
  }
  // the chunks of this block's long runs, by all its threads: chunk q's
  // run is the last with a first chunk <= q
  __syncthreads();
  for (int q = base[1] + threadIdx.x; q < base[1] + total[1];
       q += kThreads) {
    int lo = 0, hi = total[0] - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (runs_sh[mid].x <= q) lo = mid;
      else hi = mid - 1;
    }
    items[q] = make_int2(runs_sh[lo].y, q - runs_sh[lo].x);
  }
}

// Fill: pos[start[r] + ticket[e]] = e for each valid lane e of row r.
__global__ void __launch_bounds__(kThreads) hop_grad_fill_kernel(
    const int32_t* __restrict__ src, int64_t E, int32_t S,
    const int32_t* __restrict__ start, const int32_t* __restrict__ ticket,
    int32_t* __restrict__ pos) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * kThreads) {
    const int32_t s = __ldg(src + e);
    if (s >= 0) pos[start[s < S ? s : S - 1] + ticket[e]] = (int32_t)e;
  }
}

__device__ __forceinline__ void cas(int32_t& a, int32_t& b) {
  const int32_t lo = min(a, b), hi = max(a, b);
  a = lo, b = hi;
}

// A run of n <= N lanes sorted by one thread: a bitonic network over N
// registers (INT_MAX past n).
template <int N>
__device__ __forceinline__ void sort_run(const int32_t* __restrict__ in,
                                         int n, int32_t* __restrict__ out) {
  int32_t v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = i < n ? in[i] : INT_MAX;
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          if ((i & k) == 0) cas(v[i], v[l]);
          else cas(v[l], v[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) out[i] = v[i];
}

// A run of kLong < n <= NP lanes sorted by a block: a bitonic network over
// NP elements (INT_MAX past n), element q kThreads + t in register q of
// thread t; partners less than 32 apart meet by a shuffle, kThreads or
// more apart in the thread, and only the stages in between go through
// shared memory (sh: NP words).
template <int NP>
__device__ void block_sort_run(const int32_t* __restrict__ in, int n,
                               int32_t* __restrict__ out, int32_t* sh) {
  constexpr int kQ = NP / kThreads;
  const int t = threadIdx.x;
  int32_t v[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int e = q * kThreads + t;
    v[q] = e < n ? in[e] : INT_MAX;
  }
  for (int k = 2; k <= NP; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kThreads) {
        // partners in this thread's registers: q and q ^ (j / kThreads)
        const int dq = j / kThreads;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
#pragma unroll
          for (int d = 1; d < kQ; d <<= 1) {
            if (d != dq || (q & d)) continue;
            const bool up = ((q * kThreads + t) & k) == 0;
            if ((v[q] > v[q + d]) == up) {
              const int32_t x = v[q];
              v[q] = v[q + d], v[q + d] = x;
            }
          }
        }
      } else {
        int32_t y[kQ];
        if (j >= 32) {
#pragma unroll
          for (int q = 0; q < kQ; ++q) sh[q * kThreads + t] = v[q];
          __syncthreads();
#pragma unroll
          for (int q = 0; q < kQ; ++q) y[q] = sh[(q * kThreads + t) ^ j];
          __syncthreads();
        } else {
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            y[q] = __shfl_xor_sync(0xffffffffu, v[q], j);
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int e = q * kThreads + t;
          const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
          v[q] = keep_min ? min(v[q], y[q]) : max(v[q], y[q]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int e = q * kThreads + t;
    if (e < n) out[e] = v[q];
  }
}

// Sort: lanes[start[r] ...] = row r's run of pos in ascending lane order.
// Blocks [0, long_blocks) take the long runs' work items, `wins` a run:
// a run of up to kBlockSort lanes is its first item's (block_sort_run);
// a longer one (a few hubs) is cut into windows of kBitWords * 32 lanes of
// [0, E), an item a window: the item reads the whole run, counts the
// run's lanes before its window (where its lanes go) and sets a bit for
// each lane in it, then reads the bits back in order. The other blocks
// take a thread a row, its run of up to kLong lanes sorted by a network
// in registers.
__global__ void __launch_bounds__(kThreads) hop_grad_sort_kernel(
    const int32_t* __restrict__ start, const int32_t* __restrict__ cnt,
    int32_t S, int64_t E, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ counters, const int4* __restrict__ longs,
    int long_blocks, int wins, int32_t* __restrict__ lanes) {
  __shared__ uint32_t bm[kBitWords];
  if ((int)blockIdx.x < long_blocks) {
    const int64_t items = (int64_t)counters[0] * wins;
    for (int64_t it = blockIdx.x; it < items; it += long_blocks) {
      const int li = (int)(it / wins), win = (int)(it - (int64_t)li * wins);
      const int4 run = longs[li];  // row, first chunk, start, lanes
      const int a = run.z, n = run.w;
      if (n <= kBlockSort) {
        if (win == 0) {
          int32_t* sh = reinterpret_cast<int32_t*>(bm);
          if (n <= kThreads)
            block_sort_run<kThreads>(pos + a, n, lanes + a, sh);
          else if (n <= 2 * kThreads)
            block_sort_run<2 * kThreads>(pos + a, n, lanes + a, sh);
          else block_sort_run<kBlockSort>(pos + a, n, lanes + a, sh);
        }
        continue;
      }
      const int64_t w0 = (int64_t)win * 32 * kBitWords;
      if (w0 >= E) continue;
      const int words = (int)min((int64_t)kBitWords, (E - w0 + 31) / 32);
      for (int i = threadIdx.x; i < words; i += kThreads) bm[i] = 0u;
      __syncthreads();
      // the run's lanes, 16 a thread at a time (16-byte loads where
      // aligned), all read before their bits are set
      int below = 0;
      for (int i0 = 16 * threadIdx.x; i0 < n; i0 += 16 * kThreads) {
        int32_t x[16];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          lt_load4(pos + a, i0 + 4 * u, n, -1, x + 4 * u);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int64_t v = x[u] - w0;
          if (x[u] < 0) continue;
          if (v < 0) ++below;
          else if (v < 32LL * words) atomicOr(&bm[v >> 5], 1u << (v & 31));
        }
      }
      int ex, el, tl;
      lt_block_scan_sum_max(below, -1, &ex, &el, &below, &tl);
      // read back in order: warp w the words [w per, (w + 1) per), 32
      // words a round, a word a lane, its bits at its place in the round
      // (a warp scan), so that a round's stores are neighbours
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      constexpr int kWarps = kThreads / 32;
      const int per = (words + kWarps - 1) / kWarps;
      const int wa = min(words, warp * per), wb = min(words, wa + per);
      int c = 0;
      for (int w = wa + lane; w < wb; w += 32) c += __popc(bm[w]);
#pragma unroll
      for (int o = 16; o; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
      int total;
      lt_block_scan_sum_max(lane == 0 ? c : 0, -1, &ex, &el, &total, &tl);
      int o = a + below + __shfl_sync(0xffffffffu, ex, 0);
      for (int w0r = wa; w0r < wb; w0r += 32) {
        const int w = w0r + lane;
        uint32_t bits = w < wb ? bm[w] : 0u;
        const int k = __popc(bits);
        int inc = k;
#pragma unroll
        for (int sh = 1; sh < 32; sh <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, inc, sh);
          if (lane >= sh) inc += y;
        }
        int at = o + inc - k;
        for (; bits; bits &= bits - 1)
          lanes[at++] = (int32_t)(w0 + 32 * w + __ffs(bits) - 1);
        o += __shfl_sync(0xffffffffu, inc, 31);
      }
      __syncthreads();
    }
    return;
  }
  for (int64_t r = (int64_t)(blockIdx.x - long_blocks) * kThreads +
                   threadIdx.x;
       r < S; r += (int64_t)(gridDim.x - long_blocks) * kThreads) {
    const int a = start[r], n = cnt[r];
    if (n > 0 && n <= 8) sort_run<8>(pos + a, n, lanes + a);
    else if (n > 8 && n <= 16) sort_run<16>(pos + a, n, lanes + a);
    else if (n > 16 && n <= kLong) sort_run<kLong>(pos + a, n, lanes + a);
  }
}

// COLS columns of d out as floats, from one load.
template <int COLS>
__device__ __forceinline__ void load_cols(const float* p, float* v) {
  if constexpr (COLS == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// COLS columns of a row of d rows, in T, with one store.
template <typename T, int COLS>
__device__ __forceinline__ void store_cols(T* p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (COLS == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float*>(p) = v[0];
  } else if constexpr (COLS == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&a);
    w.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = w;
  } else {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v[0]);
  }
}

// A warp's walk over lanes [a, b) of `lanes`, in order: a window of 32
// lanes read at once (a lane a thread, its row of `rows` with it), then
// kGRounds of those rows in flight; before(p) runs before lane p's row is
// added to acc.
template <int COLS, typename Before>
__device__ __forceinline__ void walk(const float* __restrict__ rows,
                                     const int32_t* __restrict__ lanes,
                                     int64_t offset, int32_t F, int d, int a,
                                     int b, int c, bool live, float* acc,
                                     Before before) {
  const int t = threadIdx.x & 31;
  for (int pw = a; pw < b; pw += 32) {
    const int kn = min(32, b - pw);
    const int64_t rw = t < kn ? offset + lanes[pw + t] % F : 0;
    for (int u0 = 0; u0 < kn; u0 += kGRounds) {
      float v[kGRounds][COLS];
#pragma unroll
      for (int u = 0; u < kGRounds; ++u) {
        const int64_t r = __shfl_sync(0xffffffffu, rw, (u0 + u) & 31);
        if (u0 + u < kn && live)
          load_cols<COLS>(rows + r * d + (int64_t)c * COLS, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kGRounds; ++u) {
        if (u0 + u >= kn) break;
        before(pw + u0 + u);
#pragma unroll
        for (int k = 0; k < COLS; ++k) acc[k] += v[u][k];
      }
    }
  }
}

// Gather: d rows, a warp a walk or a chunk. Blocks [0, chunk_blocks) take
// the long runs' chunks of kLong lanes, each summed into its f32 row of
// the scratch (they start first); the others take walks: a walk's rows
// (up to kWalkRows, starting within one span of kWalkSpan lanes, so at
// most 2 kWalkSpan lanes in all) have their runs one after another in the
// first region, and one walk over them stores each row as it passes the
// row's end (a row of no lanes as zeros, a long run's row not at all), so
// a round that runs past the end of a row has the next row's lanes in
// flight.
template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads, 4) hop_grad_gather_kernel(
    const float* __restrict__ dout, const float* __restrict__ count,
    const int32_t* __restrict__ hop_offset, int64_t F, int64_t num_dst,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ sstart,
    const int32_t* __restrict__ lanes, const int32_t* __restrict__ counters,
    const int4* __restrict__ longs, const int2* __restrict__ items,
    const int32_t* __restrict__ walks, const float* __restrict__ dq,
    float* __restrict__ part, int32_t S, int d, int chunk_blocks,
    T* __restrict__ drows) {
  // the mean reads the divided rows dq (slot i's at i), the sum d out
  const int64_t offset =
      count != nullptr ? 0 : placed_offset(hop_offset, F, num_dst);
  const float* rows = count != nullptr ? dq : dout;
  const int t = threadIdx.x & 31;
  const int cpr = d / COLS;
  const int wid = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  auto nothing = [](int) {};
  if ((int)blockIdx.x < chunk_blocks) {
    const int n_chunks = counters[1];
    for (int q = blockIdx.x * kWarps + wid; q < n_chunks;
         q += chunk_blocks * kWarps) {
      const int2 it = items[q];  // long run, index in it
      const int4 run = longs[it.x];
      const int ca = run.z + it.y * kLong;
      const int cb = run.z + min(run.w, (it.y + 1) * kLong);
      for (int c = t; c - t < cpr; c += 32) {
        float acc[COLS] = {};
        walk<COLS>(rows, lanes, offset, (int32_t)F, d, ca, cb, c, c < cpr,
                   acc, nothing);
        if (c < cpr) {
#pragma unroll
          for (int k = 0; k < COLS; ++k)
            part[(int64_t)q * d + c * COLS + k] = acc[k];
        }
      }
    }
    return;
  }
  const int wk = (blockIdx.x - chunk_blocks) * kWarps + wid;
  if (wk >= counters[2]) return;
  // the walk's rows: thread t holds row0 + t's first-region start and
  // lanes; the walk ends before the next row that starts a walk
  const int64_t row0 = walks[wk];
  const int64_t r = row0 + t;
  const int st = sstart[r <= S ? r : S];
  const int nt = r < S ? cnt[r] : 0;
  const int prev = __shfl_up_sync(0xffffffffu, st, 1);
  const bool ends = t > 0 && (r >= S || walk_starts(r, st, prev));
  const int nrows = __ffs(__ballot_sync(0xffffffffu, ends)) - 1;
  const int a = __shfl_sync(0xffffffffu, st, 0);
  const int b = __shfl_sync(0xffffffffu, st, nrows);
  for (int c = t; c - t < cpr; c += 32) {
    const bool live = c < cpr;
    float acc[COLS] = {};
    int j = 0;  // the row whose sum is open
    int end = __shfl_sync(0xffffffffu, st, 1);
    // store row j (unless it is a long run's), open row j + 1
    auto flush = [&]() {
      const bool long_run = __shfl_sync(0xffffffffu, nt, j) > kLong;
      if (live && !long_run)
        store_cols<T, COLS>(drows + (row0 + j) * d + c * COLS, acc);
#pragma unroll
      for (int k = 0; k < COLS; ++k) acc[k] = 0.0f;
      ++j;
      end = __shfl_sync(0xffffffffu, st, min(j + 1, nrows));
    };
    walk<COLS>(rows, lanes, offset, (int32_t)F, d, a, b, c, live, acc,
               [&](int p) {
                 while (p >= end) flush();
               });
    while (j < nrows) flush();
  }
}

// The long runs' rows: a block a run, warp w adding chunks [w m / 8, (w +
// 1) m / 8) of the run's m in chunk order, then the warps' sums in warp
// order: the same bits from run to run.
template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads) hop_grad_combine_kernel(
    const int32_t* __restrict__ counters, const int4* __restrict__ longs,
    const float* __restrict__ part, int d, T* __restrict__ drows) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float sum_sh[kWarps][32][COLS];
  const int t = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int cpr = d / COLS;
  const int n_long = counters[0];
  for (int li = blockIdx.x; li < n_long; li += gridDim.x) {
    const int4 run = longs[li];  // row, first chunk, start, lanes
    const int m = (run.w + kLong - 1) / kLong;
    const int i0 = wid * m / kWarps, i1 = (wid + 1) * m / kWarps;
    for (int c0 = 0; c0 < cpr; c0 += 32) {
      const int c = c0 + t;
      float acc[COLS] = {};
      constexpr int kIn = 16;  // partial rows in flight a thread
      for (int i = i0; i < i1; i += kIn) {
        float v[kIn][COLS];
#pragma unroll
        for (int u = 0; u < kIn; ++u)
          if (i + u < i1 && c < cpr)
            load_cols<COLS>(part + (int64_t)(run.y + i + u) * d + c * COLS,
                            v[u]);
#pragma unroll
        for (int u = 0; u < kIn; ++u) {
          if (i + u >= i1) break;
#pragma unroll
          for (int k = 0; k < COLS; ++k) acc[k] += v[u][k];
        }
      }
#pragma unroll
      for (int k = 0; k < COLS; ++k) sum_sh[wid][t][k] = acc[k];
      __syncthreads();
      if (wid == 0 && c < cpr) {
        float tot[COLS] = {};
        for (int w = 0; w < kWarps; ++w) {
#pragma unroll
          for (int k = 0; k < COLS; ++k) tot[k] += sum_sh[w][t][k];
        }
        store_cols<T, COLS>(drows + (int64_t)run.x * d + c * COLS, tot);
      }
      __syncthreads();
    }
  }
}

// The grouping: count, scan, fill, sort. Leaves the valid lanes grouped by
// row in g.lanes, each run in ascending lane order: the runs of at most
// kLong lanes in row order from 0 (g.sstart [S + 1] their starts), then
// the longer ones (g.start [S]: every row's).
static int group_lanes(const int32_t* src, int64_t E, int64_t S,
                       const GradScratch& g, cudaStream_t s,
                       const float* dout = nullptr,
                       const float* count = nullptr,
                       const int32_t* hop_offset = nullptr, int64_t F = 0,
                       int64_t num_dst = 0, int d = 0) {
  cudaError_t rc = cudaMemsetAsync(g.cnt, 0, (S + 3) * sizeof(int32_t), s);
  if (rc != cudaSuccess) return (int)rc;
  // the count's blocks, then (for the mean) the division's
  int64_t cb = (E + kCountLanes - 1) / kCountLanes;
  if (cb > 132 * 8) cb = 132 * 8;
  const unsigned db =
      count != nullptr ? lt_grid((d % 4 == 0 ? F * d / 4 : F * d)) : 0;
  if (cb + db > 0)
    hop_grad_count_kernel<<<(unsigned)cb + db, kThreads, 0, s>>>(
        src, E, (int)S, g.cnt, g.ticket, (int)cb, dout, count, hop_offset, F,
        num_dst, d, g.dq);
  const int64_t tiles = (S + kScanRows - 1) / kScanRows;
  hop_grad_tiles_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(g.cnt, (int)S,
                                                             g.tot);
  hop_grad_scan_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      g.cnt, (int)S, g.tot, (int)tiles, g.start, g.sstart, g.counters,
      g.longs, g.items, g.walks);
  if (E > 0)
    hop_grad_fill_kernel<<<lt_grid(E), kThreads, 0, s>>>(src, E, (int)S,
                                                         g.start, g.ticket,
                                                         g.pos);
  // the long runs' items (windows of the lane space a run), then the
  // short runs' blocks
  const int wins = (int)((E + 32LL * kBitWords - 1) / (32LL * kBitWords));
  int64_t lb = lt_max_longs(E) * (wins > 0 ? wins : 1);
  if (lb > 132 * 4) lb = 132 * 4;
  const unsigned rb = lt_grid(S);
  hop_grad_sort_kernel<<<(unsigned)lb + rb, kThreads, 0, s>>>(
      g.start, g.cnt, (int)S, E, g.pos, g.counters, g.longs, (int)lb,
      wins > 0 ? wins : 1, g.lanes);
  return (int)cudaGetLastError();
}

static bool grad_shape_ok(int64_t E, int64_t S, int64_t d) {
  return E >= 0 && S > 0 && d > 0 && E < 2147483647LL &&
         S < 2147483647LL - 3 && d < 2147483647LL;
}

// Words of int32 scratch that lt_hop_mean_grad and lt_lanes_by_source take
// for E lanes, S rows of d columns.
LT_EXPORT int64_t lt_hop_mean_grad_scratch(int64_t S, int64_t E, int64_t d,
                                           int64_t F) {
  return grad_scratch(nullptr, S, E, d, F).words;
}

template <typename T, int COLS>
static int launch_gather(const float* dout, const float* count,
                         const int32_t* hop_offset, int64_t F,
                         int64_t num_dst, const GradScratch& g, int64_t S,
                         int64_t E, int d, T* drows, cudaStream_t s) {
  constexpr int kWarps = kThreads / 32;
  int64_t cb = (lt_max_chunks(E) - 1 + kWarps - 1) / kWarps;
  if (cb > 132 * 2) cb = 132 * 2;
  const int64_t wb = (grad_max_walks(S, E) + kWarps - 1) / kWarps;
  hop_grad_gather_kernel<T, COLS><<<(unsigned)(cb + wb), kThreads, 0, s>>>(
      dout, count, hop_offset, F, num_dst, g.cnt, g.sstart, g.lanes,
      g.counters, g.longs, g.items, g.walks, g.dq, g.part, (int32_t)S, d,
      (int)cb, drows);
  int64_t lb = lt_max_longs(E);
  if (lb > 132 * 4) lb = 132 * 4;
  hop_grad_combine_kernel<T, COLS><<<(unsigned)lb, kThreads, 0, s>>>(
      g.counters, g.longs, g.part, d, drows);
  return (int)cudaGetLastError();
}

// d rows [S, d] (bf16 != 0: bf16, else f32), written whole, of K15's form
// (a): dout [num_dst, d] f32 contiguous, count [num_dst] f32 (the mean) or
// null (the sum), src [E] int32 (E = fanout * F), hop_offset a device
// int32 scalar; scratch: lt_hop_mean_grad_scratch(S, E, d) int32 words.
LT_EXPORT int lt_hop_mean_grad(const float* dout, const float* count,
                               const int32_t* src, int64_t E,
                               const int32_t* hop_offset, int64_t F,
                               int64_t num_dst, int64_t S, int64_t d,
                               int32_t* scratch, void* drows, int bf16,
                               void* stream) {
  if (!grad_shape_ok(E, S, d) || F <= 0 || F > num_dst || E % F != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const GradScratch g = grad_scratch(scratch, S, E, d, F);
  const int rc = group_lanes(src, E, S, g, s, dout, count, hop_offset, F,
                             num_dst, (int)d);
  if (rc != 0) return rc;
  const bool four = d % 4 == 0 && (uintptr_t)dout % 16 == 0 &&
                    (uintptr_t)drows % (bf16 ? 8 : 16) == 0;
  if (bf16)
    return four ? launch_gather<__nv_bfloat16, 4>(
                      dout, count, hop_offset, F, num_dst, g, S, E, (int)d,
                      (__nv_bfloat16*)drows, s)
                : launch_gather<__nv_bfloat16, 1>(
                      dout, count, hop_offset, F, num_dst, g, S, E, (int)d,
                      (__nv_bfloat16*)drows, s);
  return four ? launch_gather<float, 4>(dout, count, hop_offset, F, num_dst,
                                        g, S, E, (int)d, (float*)drows, s)
              : launch_gather<float, 1>(dout, count, hop_offset, F, num_dst,
                                        g, S, E, (int)d, (float*)drows, s);
}

// The grouping alone, for holding it against its plain version:
// lanes_out [E] gets g.lanes (the tail past the valid lanes is not
// written), start_out [S] and cnt_out [S] every row's run there and its
// lanes.
LT_EXPORT int lt_lanes_by_source(const int32_t* src, int64_t E, int64_t S,
                                 int32_t* scratch, int32_t* lanes_out,
                                 int32_t* start_out, int32_t* cnt_out,
                                 void* stream) {
  if (!grad_shape_ok(E, S, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const GradScratch g = grad_scratch(scratch, S, E, 1, 0);
  int rc = group_lanes(src, E, S, g, s);
  if (rc != 0) return rc;
  const void* from[3] = {g.lanes, g.start, g.cnt};
  void* to[3] = {lanes_out, start_out, cnt_out};
  const int64_t n[3] = {E, S, S};
  for (int i = 0; i < 3 && rc == 0; ++i)
    if (n[i] > 0)
      rc = (int)cudaMemcpyAsync(to[i], from[i], n[i] * sizeof(int32_t),
                                cudaMemcpyDeviceToDevice, s);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the segment ops' grouping (K17, K18): count, scan, fill, then (sorted,
// K18's) hop_mean_grad's sort, into the kept words of lane_groups.cuh
// ---------------------------------------------------------------------------

// The count and the fill take kSegPer lanes a thread, lanes e0 + 32 u +
// (the thread's lane) of its warp's span, every load (and atomic) of the
// thread in flight together.
constexpr int kSegPer = 4;

// Count: ticket[e] = a valid lane's place among its segment's (any order:
// the sort fixes it), cnt[s] their number, an atomic a lane; except that
// the lanes of a warp that share its first valid lane's segment take one
// atomic together, so a hub's lanes do not queue on one word one by one
// (__match_any_sync for every segment measured slower).
__global__ void __launch_bounds__(kThreads) seg_count_kernel(
    const int32_t* __restrict__ seg, int64_t E, int32_t S,
    int32_t* __restrict__ cnt, int32_t* __restrict__ ticket) {
  const int lane = threadIdx.x & 31;
  const int64_t span = 32 * kSegPer;
  const int64_t nw = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t e0 = ((int64_t)blockIdx.x * (kThreads / 32) +
                     (threadIdx.x >> 5)) * span;
       e0 < E; e0 += nw * span) {
    int32_t s[kSegPer];
#pragma unroll
    for (int u = 0; u < kSegPer; ++u) {
      const int64_t e = e0 + 32 * u + lane;
      s[u] = e < E ? __ldg(seg + e) : -1;
      if (s[u] >= S) s[u] = -1;
    }
    unsigned peers[kSegPer];
    int base[kSegPer];
#pragma unroll
    for (int u = 0; u < kSegPer; ++u) {
      const unsigned act = __ballot_sync(0xffffffffu, s[u] >= 0);
      const int32_t lead = __shfl_sync(0xffffffffu, s[u],
                                       act ? __ffs(act) - 1 : 0);
      const unsigned same = __ballot_sync(0xffffffffu,
                                          s[u] >= 0 && s[u] == lead);
      peers[u] = s[u] < 0 ? 0u : s[u] == lead ? same : 1u << lane;
      base[u] = 0;
      if (s[u] >= 0 && lane == __ffs(peers[u]) - 1)
        base[u] = atomicAdd(cnt + s[u], __popc(peers[u]));
    }
#pragma unroll
    for (int u = 0; u < kSegPer; ++u) {
      if (s[u] < 0) continue;
      const int b = __shfl_sync(peers[u], base[u], __ffs(peers[u]) - 1);
      ticket[e0 + 32 * u + lane] =
          b + __popc(peers[u] & ((1u << lane) - 1u));
    }
  }
}

// Fill: pos[start[s] + ticket[e]] = e for each valid lane e of segment s.
__global__ void __launch_bounds__(kThreads) seg_fill_kernel(
    const int32_t* __restrict__ seg, int64_t E, int32_t S,
    const int32_t* __restrict__ start, const int32_t* __restrict__ ticket,
    int32_t* __restrict__ pos) {
  const int lane = threadIdx.x & 31;
  const int64_t span = 32 * kSegPer;
  const int64_t nw = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t e0 = ((int64_t)blockIdx.x * (kThreads / 32) +
                     (threadIdx.x >> 5)) * span;
       e0 < E; e0 += nw * span) {
    int32_t s[kSegPer], t[kSegPer], at[kSegPer];
#pragma unroll
    for (int u = 0; u < kSegPer; ++u) {
      const int64_t e = e0 + 32 * u + lane;
      s[u] = e < E ? __ldg(seg + e) : -1;
      if (s[u] >= S) s[u] = -1;
      t[u] = s[u] >= 0 ? __ldg(ticket + e) : 0;
    }
#pragma unroll
    for (int u = 0; u < kSegPer; ++u) at[u] = s[u] >= 0 ? start[s[u]] : 0;
#pragma unroll
    for (int u = 0; u < kSegPer; ++u)
      if (s[u] >= 0) pos[at[u] + t[u]] = (int32_t)(e0 + 32 * u + lane);
  }
}

// Scan, one pass: start[r] = the valid lanes of the segments before r;
// the runs of more than kLong lanes on `longs` as (segment, first chunk,
// start, lanes). A block a tile of kSegRows segments, tiles numbered by a
// ticket in the order blocks start, the prefix by decoupled look-back
// (dedup.cuh). A block numbers its long runs and their chunks with one
// 64-bit atomic on counters[0..1], so the list's first chunks increase
// with its index (lt_chunk searches it).
__global__ void __launch_bounds__(kThreads) seg_scan_kernel(
    const int32_t* __restrict__ cnt, int32_t S, int32_t* __restrict__ start,
    int32_t* __restrict__ counters, int4* __restrict__ longs,
    uint64_t* __restrict__ status, int32_t* __restrict__ tiles) {
  __shared__ int tile_sh, pre_sh;
  __shared__ unsigned long long base_sh;
  if (threadIdx.x == 0) tile_sh = atomicAdd(tiles, 1);
  __syncthreads();
  const int64_t t = tile_sh;
  const int64_t r0 = t * kSegRows + threadIdx.x * 8;
  int v[8];
  lt_load4(cnt, r0, S, 0, v);
  lt_load4(cnt, r0 + 4, S, 0, v + 4);
  int n = 0, nl = 0, nc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    n += v[k];
    if (v[k] > kLong) ++nl, nc += (v[k] + kLong - 1) / kLong;
  }
  int ex, exl, exc, tot, totl, totc, el, tl;
  lt_block_scan_sum_max(n, -1, &ex, &el, &tot, &tl);
  lt_block_scan_sum_max(nl, -1, &exl, &el, &totl, &tl);
  lt_block_scan_sum_max(nc, -1, &exc, &el, &totc, &tl);
  if (threadIdx.x < 32) {
    int pc, pl;
    lt_tile_lookback(status, t, tot, -1, &pc, &pl);
    if (threadIdx.x == 0) {
      pre_sh = pc;
      base_sh = totl > 0 ? atomicAdd(reinterpret_cast<unsigned long long*>(
                                         counters),
                                     ((unsigned long long)totc << 32) |
                                         (unsigned)totl)
                         : 0ull;
    }
  }
  __syncthreads();
  int rs = pre_sh + ex;
  int li = (int)(base_sh & 0xffffffffull) + exl;
  int ci = (int)(base_sh >> 32) + exc;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t r = r0 + k;
    if (r >= S) break;
    start[r] = rs;
    if (v[k] > kLong) {
      longs[li++] = make_int4((int)r, ci, rs, v[k]);
      ci += (v[k] + kLong - 1) / kLong;
    }
    rs += v[k];
  }
}

// Words of the kept grouping (tmp == 0) or of its build's scratch (tmp !=
// 0) for E lanes into S segments.
LT_EXPORT int64_t lt_segment_groups_words(int64_t S, int64_t E, int tmp) {
  return tmp ? lt_seg_tmp_words(E) : lt_groups_layout(S, E).words;
}

int lt_group_segments(const int32_t* seg, int64_t E, int64_t S,
                      int32_t* groups, int32_t* tmp, bool sorted,
                      cudaStream_t stream) {
  if (E < 0 || S < 0 || E >= 2147483647LL || S >= 2147483647LL - 3)
    return (int)cudaErrorInvalidValue;
  const LtLaneGroups g = lt_lane_groups(groups, S, E);
  const LtSegTmp w = lt_seg_tmp(tmp, E);
  int rc = (int)cudaMemsetAsync(g.cnt, 0, g.zero_words * sizeof(int32_t),
                                stream);
  if (rc != 0 || S == 0) return rc;
  const unsigned lb_lanes = lt_grid((E + kSegPer - 1) / kSegPer);
  if (E > 0)
    seg_count_kernel<<<lb_lanes, kThreads, 0, stream>>>(seg, E, (int)S, g.cnt,
                                                        w.ticket);
  seg_scan_kernel<<<(unsigned)((S + kSegRows - 1) / kSegRows), kThreads, 0,
                    stream>>>(g.cnt, (int)S, g.start, g.counters, g.longs,
                              g.status, g.tiles);
  // unsorted, the fill writes the runs where they stay
  if (E > 0)
    seg_fill_kernel<<<lb_lanes, kThreads, 0, stream>>>(
        seg, E, (int)S, g.start, w.ticket, sorted ? w.pos : g.lanes);
  if (!sorted) return (int)cudaGetLastError();
  const int wins = (int)((E + 32LL * kBitWords - 1) / (32LL * kBitWords));
  int64_t lb = lt_max_longs(E) * (wins > 0 ? wins : 1);
  if (lb > 132 * 4) lb = 132 * 4;
  hop_grad_sort_kernel<<<(unsigned)lb + lt_grid(S), kThreads, 0, stream>>>(
      g.start, g.cnt, (int)S, E, w.pos, g.counters, g.longs, (int)lb,
      wins > 0 ? wins : 1, g.lanes);
  return (int)cudaGetLastError();
}

// The grouping alone into `groups` (for holding it against its plain
// version: ops/segment.py::segment_groups reads it back).
LT_EXPORT int lt_segment_groups(const int32_t* seg, int64_t E, int64_t S,
                                int32_t* groups, int32_t* tmp, int sorted,
                                void* stream) {
  return lt_group_segments(seg, E, S, groups, tmp, sorted != 0,
                           (cudaStream_t)stream);
}

// Word offsets in the kept grouping: cnt, start, lanes.
LT_EXPORT void lt_segment_groups_layout(int64_t S, int64_t E, int64_t* at) {
  const LtGroupsLayout l = lt_groups_layout(S, E);
  at[0] = l.cnt, at[1] = l.start, at[2] = l.lanes;
}
