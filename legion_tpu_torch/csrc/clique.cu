// The clique caches' routing and draws: K12 bucket_by_owner and K14
// clique_draw (the owners' draws) with clique_draw_unsort (the
// requesters' side). K13 clique_gather is a form of K4 (cached_gather.cu).
//
// A clique's Kg members hold the hot rows interleaved: global slot s lives
// on member s % Kg at local row s / Kg. A member's request of N ids goes
// to the owners as a fixed [Kg, R_req] matrix of local rows, each owner
// answers its matrix, and the answers come back through the same
// exchange (cache/collective.py). Here the members share one card, so the
// kernels take every member's (and clique's) matrices in one launch.
//
// K12 bucket_by_owner replaces legion_tpu/cache/collective.py::
// _bucket_by_owner (:76-104) with the owner and local row of :174-175 and
// :394-395, which XLA compiled on the TPU as a stable argsort by owner, a
// searchsorted, a scatter into the request matrix and two inverse
// scatters. What it computes, for each member m and lane i of its N
// requests (slot[m, i] the global slot, -1 for a miss):
//   owner o = slot % Kg (Kg for a miss), local row slot / Kg;
//   pos = the lane's rank among the member's earlier lanes of owner o (a
//         stable sort's position in o's segment; for a miss, JAX's clipped
//         form: the count of owner Kg-1 plus the rank among the misses);
//   in bounds = o < Kg and pos < R_req;
//   req[m, o, pos] = local row where in bounds, -1 in every other entry;
//   row[m, i] = (m * Kg + o) * R_req + pos where in bounds, else -1: the
//         row of the answer in the [members * Kg * R_req, ...] array the
//         exchange brings back (K13's and the unsort's lane_row).
// Bound on this card: device-memory bytes (slot read, row and req written,
// pos too when asked; a few integer operations a lane). Design: a stable
// counting sort over Kg + 1 keys in two passes over tiles of 2048 lanes of
// one member (256 threads, 8 lanes a thread, lane l of step k the lane
// 32 k + l of its warp's 256: each step's loads and row stores one
// coalesced 128-byte run, all of a thread's loads in flight first), with
// no 64-bit division (slot / Kg is the high word of a 64-bit product):
//   pass 1: each tile counts its lanes of each owner (a thread's counts in
//           8-bit fields of one word, summed over the warp; one ballot a
//           bit of the owner a step where Kg + 1 > 8) into [M, Kg + 1, T];
//   pass 2: each tile ranks its lanes in lane order, a step at a time, by
//           one ballot a bit of the owner (the lanes of each owner as a
//           mask), lane o keeping its warp's running count of owner o;
//           its base an owner is the sum of the counts of the tiles before
//           it (one warp an owner, 16-byte loads, 4 in flight a lane:
//           ceil(t / 512) rounds of loads for tile t) and of its warps
//           before (a scan). The fill blocks after the tiles sum their
//           owner's counts for the total and write -1 in [total, R_req):
//           nothing writes an entry twice, and a miss's pos gets the
//           member's total of owner Kg - 1 the same way.
// The counts are all that passes between blocks, written whole by pass 1
// at every call: no ticket, status word, memset or barrier, so a replayed
// CUDA graph needs nothing reset. With N at most 8192, one block of 1024
// threads a member ranks all its lanes alone, and Kg more blocks a member
// each count one owner's lanes and write its unused entries beside it:
// one launch, faster on the card than the two passes at hop 0's [4,
// 8000] and [1, 8000] (PERF.md §6). The look-back design (tiles by an
// atomic ticket, status words an owner, Onesweep's decoupled look-back)
// was built and measured first: tiles of one wave waited for the slowest
// tile before them, and it was slower than the two passes at the fetch
// (PERF.md §6).
//
// K14 clique_draw replaces collective.py::CliqueTopoCache._draw_local
// (:337-370), and clique_draw_unsort the unsort of lookup (:383-407). Owner o
// of clique c draws `fanout` neighbours for each received local row of its
// shard (K3's windowed scheme): row r -> (start, deg) of its [R, 2] pairs; r0
// ~ U[0, max(deg, 1)) picks the W-wide block of its [Eb / W, W] blocks holding
// start + r0; each draw is uniform over the row's part of that block. -1 for
// no request (r < 0) or degree 0. The words: owner member c * Kg + o's hop
// words, each (lo, hi) pair folded with first_owner + o (JAX's fold_in(key,
// axis_index); a process that holds one owner of a clique across processes
// passes that owner's index, and its shard as the only one of pairs and
// blocks); r0 from lane q (the request's index in the owner's [Kg, R_req]
// matrix), draw f from lane q * fanout + f. Out: [Kc, Kg(owner), Kg * R_req,
// fanout], the draws of a request together, as JAX returns them. Bound: by
// bytes, the received rows, the pairs of the valid ones, one int32 of the
// block a draw and every draw written; most requests are empty (-1), so
// the kernel is mostly a writer of -1. Design: a block's owner is
// blockIdx.y, and its folded words are made once a thread, only by warps
// that hold a valid request. A warp takes 32 requests, one a lane: it
// reads the row and pair and draws r0 once, then the warp writes the
// 32 * fanout draws of those requests as one coalesced run, each draw
// taking its request's window from a shuffle and costing one lt_word, one
// lt_bounded and one read of blocks, 8 reads in flight a lane before
// their stores; a warp with no valid request writes its run of -1 alone.
// 32-bit index math inside an owner's matrix (the wrapper holds Q *
// fanout < 2^32).
//
// clique_draw_unsort: lane i of member m takes draw f of its request,
// back[row[m, i], f], into the fanout-major lane f * F + i, or fill's
// value (the host draws of the lanes the clique did not serve) where row
// is -1; -1 without fill. Bound: bytes (row, fill and out once, the
// served lanes' back words). Design: the member is blockIdx.y; a thread
// takes 4 neighbouring lanes (one when F or a base is not 16-byte
// aligned), reads their rows once as one 16-byte load, then for each f
// reads 16 bytes of fill, gathers the served lanes' back words and stores
// 16 bytes of out: each f is one coalesced run across the warp.
#include "common.cuh"

namespace {

constexpr int kMaxOwners = 32;             // Kg + 1

// K12's tiles: 2048 lanes (256 threads x 8), or one tile of 8192 (1024 x
// 8) for a member of at most 8192 lanes; a fill block's request entries
constexpr int kTileThreads = 256, kTileItems = 8;
constexpr int kTileLanes = kTileThreads * kTileItems;
constexpr int kOneThreads = 1024, kOneItems = 8;
constexpr int kOneLanes = kOneThreads * kOneItems;
constexpr int kFillEntries = 8192;
// K14's draws: a warp's reads of blocks in flight at once
constexpr int kDrawUnroll = 8;

// slot / Kg for 0 <= slot < 2^31 and 1 <= Kg < 32: the high word of slot *
// magic, magic = (2^64 - 1) / Kg + 1 (exact: the error is under 2^-32,
// a quotient's fraction at most 1 - 1 / Kg); slot itself for Kg 1
// (magic 0).
__device__ __forceinline__ int32_t div_owner(int32_t slot, uint64_t magic) {
  return magic ? (int32_t)__umul64hi((uint64_t)slot, magic) : slot;
}

// Loads the n lanes of a tile at s (warp w holds lanes [w * 32 * kI, (w +
// 1) * 32 * kI), lane l of step k the lane w * 32 * kI + k * 32 + l) and
// ranks them: q[k] the local row, pk[k] = rank << 6 | owner (Kg + 1 past
// the end), the rank among the warp's earlier lanes of that owner. A step
// splits the warp by owner with one ballot a bit of the owner; lane o
// keeps the warp's running count of owner o. wc: this warp's counts, left
// there for owners 0 .. Kg.
template <int kI>
__device__ __forceinline__ void rank_lanes(const int32_t* __restrict__ s,
                                           int n, int Kg, uint64_t magic,
                                           int32_t (&q)[kI], int (&pk)[kI],
                                           int* wc) {
  const int lane = threadIdx.x & 31;
  const int at0 = (threadIdx.x >> 5) * 32 * kI + lane;
  const int past = Kg + 1, bits = 32 - __clz(past);
  int32_t sl[kI];
#pragma unroll
  for (int k = 0; k < kI; ++k) sl[k] = at0 + k * 32 < n ? s[at0 + k * 32] : 0;
  const unsigned lt = (1u << lane) - 1u;
  int count = 0;
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    int o = past;
    q[k] = 0;
    if (at0 + k * 32 < n) {
      if (sl[k] >= 0) {
        q[k] = div_owner(sl[k], magic);
        o = sl[k] - q[k] * Kg;
      } else {
        o = Kg;
      }
    }
    // mine: the lanes of this lane's owner; theirs: the lanes of owner
    // `lane`
    unsigned mine = 0xffffffffu, theirs = 0xffffffffu;
#pragma unroll
    for (int b = 0; b < 6; ++b) {          // the bits of 0 .. 32
      if (b == bits) break;
      const unsigned set = __ballot_sync(0xffffffffu, (o >> b) & 1);
      mine &= (o >> b) & 1 ? set : ~set;
      theirs &= (lane >> b) & 1 ? set : ~set;
    }
    pk[k] = (__shfl_sync(0xffffffffu, count, o & 31) + __popc(mine & lt))
                << 6 | o;
    count += __popc(theirs);
  }
  if (lane <= Kg) wc[lane] = count;
}

// The warps' counts wcnt[w][o] -> each warp's exclusive base an owner;
// tot[o] the tile's count. Called by all threads, ends with a barrier.
template <int kWarps>
__device__ __forceinline__ void scan_warps(int (*wcnt)[kMaxOwners + 1],
                                           int K1, int* tot) {
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int o = threadIdx.x >> 5; o < K1; o += kWarps) {
    const int c = lane < kWarps ? wcnt[lane][o] : 0;
    int run = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, run, d);
      if (lane >= d) run += v;
    }
    if (lane < kWarps) wcnt[lane][o] = run - c;
    if (lane == 31) tot[o] = run;
  }
  __syncthreads();
}

// Writes the tile's lanes into row and pos (both at the tile's first lane)
// and req where in bounds: a lane's position is base[o] (the lanes of
// owner o before this warp's, in the tiles before and in this one) + its
// rank; a miss's pos adds miss_base.
template <int kI>
__device__ __forceinline__ void write_lanes(
    const int32_t (&q)[kI], const int (&pk)[kI], const int* base,
    int miss_base, int m, int Kg, int32_t R_req, int32_t* __restrict__ req,
    int32_t* __restrict__ row, int32_t* __restrict__ pos) {
  const int at0 = (threadIdx.x >> 5) * 32 * kI + (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    const int o = pk[k] & 63;
    if (o > Kg) continue;                  // past the tile's end
    const int p = base[o] + (pk[k] >> 6);
    int32_t r = -1;
    if (o < Kg && p < R_req) {
      r = (m * Kg + o) * R_req + p;
      req[r] = q[k];
    }
    row[at0 + k * 32] = r;
    if (pos) pos[at0 + k * 32] = o < Kg ? p : miss_base + p;
  }
}

// Members of at most kOneLanes lanes: block m < M takes all of member m's
// lanes; block M + m * Kg + o counts member m's lanes of owner o itself
// and writes -1 in [that count, R_req) of o's request row, beside it.
__global__ void __launch_bounds__(kOneThreads, 1) bucket_by_owner_one_kernel(
    const int32_t* __restrict__ slot, int64_t N, int32_t Kg, int32_t R_req,
    int32_t M, int32_t* __restrict__ req, int32_t* __restrict__ row,
    int32_t* __restrict__ pos, uint64_t magic) {
  constexpr int kWarps = kOneThreads / 32;
  __shared__ int wcnt[kWarps][kMaxOwners + 1];
  __shared__ int tot[kMaxOwners + 1];
  const int K1 = Kg + 1;
  if (blockIdx.x >= M) {
    const int f = blockIdx.x - M, m = f / Kg, o = f - m * Kg;
    const int32_t* s = slot + (int64_t)m * N;
    if (threadIdx.x == 0) tot[0] = 0;
    __syncthreads();
    int c = 0;
    for (int i = threadIdx.x; i < N; i += kOneThreads)
      c += s[i] >= 0 && (int)((uint32_t)s[i] % (uint32_t)Kg) == o;
    c = __reduce_add_sync(0xffffffffu, c);
    if ((threadIdx.x & 31) == 0) atomicAdd(&tot[0], c);
    __syncthreads();
    int32_t* r = req + (int64_t)(m * Kg + o) * R_req;
    for (int e = tot[0] + threadIdx.x; e < R_req; e += kOneThreads) r[e] = -1;
    return;
  }
  const int m = blockIdx.x;
  const int64_t mN = (int64_t)m * N;
  int32_t q[kOneItems];
  int pk[kOneItems];
  rank_lanes<kOneItems>(slot + mN, (int)N, Kg, magic, q, pk,
                        wcnt[threadIdx.x >> 5]);
  scan_warps<kWarps>(wcnt, K1, tot);
  write_lanes<kOneItems>(q, pk, wcnt[threadIdx.x >> 5], tot[Kg - 1], m, Kg,
                         R_req, req, row + mN, pos ? pos + mN : nullptr);
}

// The sum of a[0 .. n) over the calling warp, in every lane: 16-byte
// loads, 4 in flight a lane (a is 16-byte aligned, and its entries past
// the last tile up to a multiple of 4 are zero).
__device__ __forceinline__ int warp_sum(const int* __restrict__ a, int n) {
  const int4* a4 = reinterpret_cast<const int4*>(a);
  const int lane = threadIdx.x & 31, full = n >> 2;
  int c = 0;
#pragma unroll 4
  for (int i = lane; i < full; i += 32) {
    const int4 v = a4[i];
    c += (v.x + v.y) + (v.z + v.w);
  }
  if (lane == 0 && (n & 3)) {
    const int4 v = a4[full];
    c += v.x + ((n & 3) > 1 ? v.y : 0) + ((n & 3) > 2 ? v.z : 0);
  }
  return __reduce_add_sync(0xffffffffu, c);
}

// Members of more lanes, pass 1: tile t of member m (block m * T + t)
// counts its lanes of each owner into counts[m, o, t], [M, Kg + 1, Tp]
// (Tp: T rounded up to a multiple of 4; the last tile zeroes the entries
// past it).
__global__ void __launch_bounds__(kTileThreads) bucket_by_owner_count_kernel(
    const int32_t* __restrict__ slot, int64_t N, int32_t Kg, int32_t T,
    int32_t Tp, int32_t* __restrict__ counts, uint64_t magic) {
  __shared__ int tot[kMaxOwners];
  const int m = blockIdx.x / T, t = blockIdx.x - m * T, K1 = Kg + 1;
  const int64_t left = N - (int64_t)t * kTileLanes;
  const int n = left < kTileLanes ? (int)left : kTileLanes;
  const int32_t* s = slot + (int64_t)m * N + (int64_t)t * kTileLanes;
  const int lane = threadIdx.x & 31;
  const int at0 = (threadIdx.x >> 5) * 32 * kTileItems + lane;
  if (threadIdx.x < K1) tot[threadIdx.x] = 0;
  int32_t sl[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    sl[k] = at0 + k * 32 < n ? s[at0 + k * 32] : 0;
  // lane o's count of owner o in the warp
  int count = 0;
  if (K1 <= 8) {
    // a thread's counts in 8-bit fields (at most kTileItems), summed over
    // the warp in 16-bit fields: owners 0, 2, 4, 6 in lo, 1, 3, 5, 7 in hi
    uint64_t c8 = 0;
#pragma unroll
    for (int k = 0; k < kTileItems; ++k)
      if (at0 + k * 32 < n)
        c8 += 1ull << (8 * (sl[k] >= 0 ? sl[k] - div_owner(sl[k], magic) * Kg
                                       : Kg));
    uint64_t lo = c8 & 0x00ff00ff00ff00ffull;
    uint64_t hi = (c8 >> 8) & 0x00ff00ff00ff00ffull;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, d);
      hi += __shfl_xor_sync(0xffffffffu, hi, d);
    }
    count = (int)((((lane & 1) ? hi : lo) >> (16 * ((lane >> 1) & 3))) &
                  0xffff);
  } else {
    // one ballot a bit of the owner a step, as rank_lanes
    const int bits = 32 - __clz(K1);
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      int o = K1;
      if (at0 + k * 32 < n)
        o = sl[k] >= 0 ? sl[k] - div_owner(sl[k], magic) * Kg : Kg;
      unsigned theirs = 0xffffffffu;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        if (b == bits) break;
        const unsigned set = __ballot_sync(0xffffffffu, (o >> b) & 1);
        theirs &= (lane >> b) & 1 ? set : ~set;
      }
      count += __popc(theirs);
    }
  }
  __syncthreads();
  if (lane < K1) atomicAdd(&tot[lane], count);
  __syncthreads();
  if (threadIdx.x < K1) {
    int32_t* c = counts + ((int64_t)m * K1 + threadIdx.x) * Tp;
    c[t] = tot[threadIdx.x];
    if (t == T - 1)
      for (int u = T; u < Tp; ++u) c[u] = 0;
  }
}

// Pass 2: blocks [0, M * T) are the tiles, each ranking its lanes and
// taking its bases an owner from the counts of the tiles before it (warp
// o sums owner o's); blocks from M * T on are the fill blocks, Kg *
// ceil(R_req / kFillEntries) a member, each summing its owner's counts
// for the total and writing -1 in its part of [total, R_req).
__global__ void __launch_bounds__(kTileThreads) bucket_by_owner_tiles_kernel(
    const int32_t* __restrict__ slot, int64_t N, int32_t Kg, int32_t R_req,
    int32_t M, int32_t T, int32_t Tp, const int32_t* __restrict__ counts,
    int32_t* __restrict__ req, int32_t* __restrict__ row,
    int32_t* __restrict__ pos, uint64_t magic) {
  constexpr int kWarps = kTileThreads / 32;
  __shared__ int wcnt[kWarps][kMaxOwners + 1];
  __shared__ int tot[kMaxOwners + 1], ex[kMaxOwners + 1];
  __shared__ int s_total;
  const int K1 = Kg + 1, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if ((int)blockIdx.x >= M * T) {
    const int fills = (R_req + kFillEntries - 1) / kFillEntries;
    const int f = blockIdx.x - M * T, m = f / (Kg * fills);
    const int o = (f - m * Kg * fills) / fills;
    const int j = f - m * Kg * fills - o * fills;
    if (w == 0) {
      const int total = warp_sum(counts + ((int64_t)m * K1 + o) * Tp, T);
      if (lane == 0) s_total = total;
    }
    __syncthreads();
    int32_t* r = req + (int64_t)(m * Kg + o) * R_req;
    const int hi = min((j + 1) * kFillEntries, R_req);
    for (int e = max(j * kFillEntries, s_total) + threadIdx.x; e < hi;
         e += kTileThreads)
      r[e] = -1;
    return;
  }

  const int m = blockIdx.x / T, t = blockIdx.x - m * T;
  const int64_t li0 = (int64_t)m * N + (int64_t)t * kTileLanes;
  const int64_t left = N - (int64_t)t * kTileLanes;
  const int n = left < kTileLanes ? (int)left : kTileLanes;
  int32_t q[kTileItems];
  int pk[kTileItems];
  rank_lanes<kTileItems>(slot + li0, n, Kg, magic, q, pk, wcnt[w]);
  // the tiles before this one, an owner a warp; a miss's pos also needs
  // the member's total of owner Kg - 1
  for (int o = w; o < K1; o += kWarps) {
    const int32_t* c = counts + ((int64_t)m * K1 + o) * Tp;
    const int before = warp_sum(c, t);
    if (lane == 0) ex[o] = before;
    if (pos && o == Kg - 1) {
      const int total = warp_sum(c, T);
      if (lane == 0) s_total = total;
    }
  }
  scan_warps<kWarps>(wcnt, K1, tot);
  // each warp's base an owner: the tiles before, then the warps before
  if (threadIdx.x < kWarps * K1) {
    const int ww = threadIdx.x / K1, o = threadIdx.x - ww * K1;
    wcnt[ww][o] += ex[o];
  }
  __syncthreads();
  write_lanes<kTileItems>(q, pk, wcnt[w], pos ? s_total : 0, m, Kg, R_req,
                          req, row + li0, pos ? pos + li0 : nullptr);
}

template <typename Off>
__global__ void __launch_bounds__(kThreads) clique_draw_kernel(
    const Off* __restrict__ pairs, const int32_t* __restrict__ blocks,
    int64_t R, int64_t nblk, int32_t W, const int32_t* __restrict__ recv,
    uint32_t Q, int32_t Kg, int32_t fanout, const uint32_t* __restrict__ keys,
    int32_t first_owner, int32_t* __restrict__ out) {
  const int co = blockIdx.y;               // the owner's member index
  const int o = co % Kg, lane = threadIdx.x & 31;
  const int32_t* rv = recv + (int64_t)co * Q;
  int32_t* oc = out + (int64_t)co * Q * fanout;
  const Off* pr = pairs + (int64_t)o * R * 2;
  const int32_t* bo = blocks + (int64_t)o * nblk * W;
  const uint32_t step_i = 32u / fanout, step_f = 32u - step_i * fanout;
  const uint32_t lane_i = lane / fanout, lane_f = lane - lane_i * fanout;
  bool folded = false;
  LtKey k0{0, 0}, k1{0, 0};
  const uint32_t warps = gridDim.x * (kThreads / 32);
  for (uint32_t q0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * 32;
       q0 < Q; q0 += warps * 32) {
    const uint32_t nq = Q - q0 < 32u ? Q - q0 : 32u;
    const int32_t r = lane < nq ? rv[q0 + lane] : -1;
    Off start = 0, deg = 0;
    if (r >= 0) {
      const int64_t rc = r < R ? r : R - 1;
      start = pr[2 * rc];
      deg = pr[2 * rc + 1];
    }
    int32_t* run = oc + (uint64_t)q0 * fanout;
    const uint32_t cnt = nq * fanout;
    if (!__ballot_sync(0xffffffffu, deg > 0)) {
      for (uint32_t j = lane; j < cnt; j += 32) run[j] = -1;
      continue;
    }
    if (!folded) {
      const uint32_t* kw = keys + 4 * co;
      const uint64_t og = (uint64_t)(first_owner + o);
      k0 = lt_fold_in(LtKey{kw[0], kw[1]}, og);
      k1 = lt_fold_in(LtKey{kw[2], kw[3]}, og);
      folded = true;
    }
    // the request's window: its first entry in bo, and its width (0: -1)
    Off wb = 0;
    uint32_t width = 0;
    if (deg > 0) {
      const uint32_t deg32 =
          deg < (Off)2147483647 ? (uint32_t)deg : 2147483647u;
      const Off at =
          start + (Off)lt_bounded(lt_word(k0.lo, k0.hi, q0 + lane), deg32);
      const Off blk = at / W;
      const Off bbase = blk * W;
      const Off end = start + deg;
      const Off lo = (start > bbase ? start : bbase) - bbase;
      const Off hi = (end < bbase + W ? end : bbase + W) - bbase;
      width = hi - lo > 1 ? (uint32_t)(hi - lo) : 1u;
      wb = (blk < nblk ? blk : (Off)(nblk - 1)) * W + lo;
    }
    // draw j of the run: request i = j / fanout, f = j % fanout; kDrawUnroll
    // reads of blocks in flight before their stores
    uint32_t i = lane_i, f = lane_f;
    for (uint32_t j0 = 0; j0 < cnt; j0 += 32 * kDrawUnroll) {
      int32_t res[kDrawUnroll];
#pragma unroll
      for (int u = 0; u < kDrawUnroll; ++u) {
        const uint32_t wi = __shfl_sync(0xffffffffu, width, i & 31);
        const Off bi = __shfl_sync(0xffffffffu, wb, i & 31);
        res[u] = -1;
        if (wi && j0 + u * 32 + lane < cnt) {
          const uint32_t word =
              lt_word(k1.lo, k1.hi, (q0 + i) * (uint32_t)fanout + f);
          res[u] = bo[bi + (Off)lt_bounded(word, wi)];
        }
        i += step_i;
        f += step_f;
        if (f >= (uint32_t)fanout) {
          f -= fanout;
          ++i;
        }
      }
#pragma unroll
      for (int u = 0; u < kDrawUnroll; ++u)
        if (j0 + u * 32 + lane < cnt) run[j0 + u * 32 + lane] = res[u];
    }
  }
}

// kV neighbouring lanes a thread (4: one 16-byte access for each of row,
// fill and out; 1 otherwise).
template <int kV>
__global__ void __launch_bounds__(kThreads) clique_draw_unsort_kernel(
    const int32_t* __restrict__ back, const int32_t* __restrict__ row,
    const int32_t* __restrict__ fill, int64_t F, int32_t fanout,
    int32_t* __restrict__ out) {
  const int64_t m = blockIdx.y;
  const int32_t* rw = row + m * F;
  const int32_t* fl = fill ? fill + m * fanout * F : nullptr;
  int32_t* om = out + m * fanout * F;
  for (int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kV;
       i < F; i += (int64_t)gridDim.x * kThreads * kV) {
    int32_t r[kV];
    if constexpr (kV == 4) {
      const int4 v = *reinterpret_cast<const int4*>(rw + i);
      r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
    } else {
      r[0] = rw[i];
    }
    for (int f = 0; f < fanout; ++f) {
      const int64_t at = (int64_t)f * F + i;
      int32_t v[kV];
      if constexpr (kV == 4) {
        int4 x = make_int4(-1, -1, -1, -1);
        if (fl) x = *reinterpret_cast<const int4*>(fl + at);
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      } else {
        v[0] = fl ? fl[at] : -1;
      }
#pragma unroll
      for (int u = 0; u < kV; ++u)
        if (r[u] >= 0) v[u] = back[(int64_t)r[u] * fanout + f];
      if constexpr (kV == 4) {
        *reinterpret_cast<int4*>(om + at) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
        om[at] = v[0];
      }
    }
  }
}

}  // namespace

// K12's scratch: the words of the tiles' counts, [M, Kg + 1, Tp] with Tp
// ceil(N / 2048) rounded up to a multiple of 4; none for a member of at
// most 8192 lanes (one block a member).
LT_EXPORT int64_t lt_bucket_scratch(int64_t M, int64_t N, int32_t Kg) {
  if (N <= kOneLanes) return 0;
  const int64_t T = (N + kTileLanes - 1) / kTileLanes;
  return M * (Kg + 1) * ((T + 3) & ~(int64_t)3);
}

// K12. slot [M, N] int32 (-1 = miss) -> req [M, Kg, R_req], row [M, N] and,
// when pos is not null, pos [M, N], all int32 and contiguous. scratch:
// lt_bucket_scratch(M, N, Kg) words, 16-byte aligned (the tiles' counts,
// written whole by the first pass; unused for one block a member).
// 1 <= Kg < 32, N < 2^30 and M * Kg * R_req < 2^31.
LT_EXPORT int lt_bucket_by_owner(const int32_t* slot, int64_t M, int64_t N,
                                 int32_t Kg, int32_t R_req, int32_t* req,
                                 int32_t* row, int32_t* pos,
                                 int32_t* scratch, void* stream) {
  if (Kg < 1 || Kg + 1 > kMaxOwners || R_req < 1 || M < 1 || N < 0 ||
      N >= (1ll << 30) || M * Kg * (int64_t)R_req >= INT32_MAX ||
      M * (Kg + 1) >= INT32_MAX || ((uintptr_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint64_t magic = Kg == 1 ? 0 : ~0ull / (uint64_t)Kg + 1;
  if (N <= kOneLanes) {
    bucket_by_owner_one_kernel<<<(unsigned)(M * (1 + Kg)), kOneThreads, 0,
                                 s>>>(slot, N, Kg, R_req, (int32_t)M, req,
                                      row, pos, magic);
    return (int)cudaGetLastError();
  }
  const int64_t T = (N + kTileLanes - 1) / kTileLanes;
  const int64_t Tp = (T + 3) & ~(int64_t)3;
  const int64_t fills = (R_req + kFillEntries - 1) / kFillEntries;
  if (M * T + M * Kg * fills >= INT32_MAX) return (int)cudaErrorInvalidValue;
  bucket_by_owner_count_kernel<<<(unsigned)(M * T), kTileThreads, 0, s>>>(
      slot, N, Kg, (int32_t)T, (int32_t)Tp, scratch, magic);
  bucket_by_owner_tiles_kernel<<<(unsigned)(M * T + M * Kg * fills),
                                 kTileThreads, 0, s>>>(
      slot, N, Kg, R_req, (int32_t)M, (int32_t)T, (int32_t)Tp, scratch, req,
      row, pos, magic);
  return (int)cudaGetLastError();
}

// K14, the owners' draws. pairs [Kg, R, 2] (Off), blocks [Kg, nblk, W]
// int32, recv [Kc, Kg, Q] int32 (Q = Kg * R_req), keys [Kc * Kg, 4] uint32
// (each member's hop words), first_owner the clique index of owner 0 of
// pairs -> out [Kc, Kg, Q, fanout] int32.
template <typename Off>
static int draw_launch(const Off* pairs, const int32_t* blocks, int64_t R,
                       int64_t nblk, int32_t W, const int32_t* recv,
                       int64_t Kc, int32_t Kg, int64_t Q, int32_t fanout,
                       const uint32_t* keys, int32_t first_owner,
                       int32_t* out, void* stream) {
  const int64_t total = Kc * Kg * Q * fanout;
  if (total == 0) return (int)cudaSuccess;
  if (W <= 0 || R <= 0 || nblk <= 0 || fanout <= 0 || Kg < 1 ||
      first_owner < 0 || Kc * Kg > 65535 ||
      Q * fanout >= ((int64_t)1 << 32))
    return (int)cudaErrorInvalidValue;
  const int64_t bx = (Q + kThreads - 1) / kThreads;
  clique_draw_kernel<Off>
      <<<dim3((unsigned)(bx < 4096 ? bx : 4096), (unsigned)(Kc * Kg)),
         kThreads, 0, (cudaStream_t)stream>>>(pairs, blocks, R, nblk, W,
                                              recv, (uint32_t)Q, Kg, fanout,
                                              keys, first_owner, out);
  return (int)cudaGetLastError();
}

LT_EXPORT int lt_clique_draw_i32(const int32_t* pairs, const int32_t* blocks,
                                 int64_t R, int64_t nblk, int32_t W,
                                 const int32_t* recv, int64_t Kc, int32_t Kg,
                                 int64_t Q, int32_t fanout,
                                 const uint32_t* keys, int32_t first_owner,
                                 int32_t* out, void* stream) {
  return draw_launch<int32_t>(pairs, blocks, R, nblk, W, recv, Kc, Kg, Q,
                              fanout, keys, first_owner, out, stream);
}

LT_EXPORT int lt_clique_draw_i64(const int64_t* pairs, const int32_t* blocks,
                                 int64_t R, int64_t nblk, int32_t W,
                                 const int32_t* recv, int64_t Kc, int32_t Kg,
                                 int64_t Q, int32_t fanout,
                                 const uint32_t* keys, int32_t first_owner,
                                 int32_t* out, void* stream) {
  return draw_launch<int64_t>(pairs, blocks, R, nblk, W, recv, Kc, Kg, Q,
                              fanout, keys, first_owner, out, stream);
}

// K14, the requesters' side. back [*, fanout] int32, row [M, F] int32,
// fill [M, fanout * F] int32 or null -> out [M, fanout * F] int32.
LT_EXPORT int lt_clique_draw_unsort(const int32_t* back, const int32_t* row,
                                    const int32_t* fill, int64_t M,
                                    int64_t F, int32_t fanout, int32_t* out,
                                    void* stream) {
  if (M * F * fanout == 0) return (int)cudaSuccess;
  if (fanout <= 0 || M > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool v4 = F % 4 == 0 && ((uintptr_t)row & 15) == 0 &&
                  ((uintptr_t)out & 15) == 0 &&
                  (fill == nullptr || ((uintptr_t)fill & 15) == 0);
  const int64_t per = v4 ? F / 4 : F;
  const int64_t bx = (per + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(bx < 4096 ? bx : 4096), (unsigned)M);
  if (v4)
    clique_draw_unsort_kernel<4><<<grid, kThreads, 0, s>>>(back, row, fill, F,
                                                           fanout, out);
  else
    clique_draw_unsort_kernel<1><<<grid, kThreads, 0, s>>>(back, row, fill, F,
                                                           fanout, out);
  return (int)cudaGetLastError();
}
