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
// Bound on this card: device-memory bytes (read slot, write row, pos and
// req; a handful of integer operations a lane). Design: a stable counting
// sort over Kg + 1 keys, in one cooperative launch (as K9): each block
// takes a contiguous chunk of one member's lanes and counts its owners,
// grid.sync(), each block sums the counts of the chunks before its own,
// then walks its chunk in lane order a tile of 256 at a time, ranking
// lanes of one owner by __match_any_sync within a warp and by a scan of
// the warps' counts across the block; the tile's counts then advance the
// block's bases. Blocks also fill the unused request entries with -1.
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
// fanout], the draws of a request together, as JAX returns them. Bound: the
// launch, as K3 (a few hundred thousand draws); by bytes, the received rows,
// their pairs, one int32 of the block a draw and the draws written. Design: a
// thread a draw, so that the stores of a warp are one run of out; the
// request's row, pair and r0 are recomputed by the fanout threads that share
// them (L1 hits).
//
// clique_draw_unsort: lane i of member m takes draw f of its request,
// back[row[m, i], f], into the fanout-major lane f * F + i, or fill's
// value (the host draws of the lanes the clique did not serve) where row
// is -1; -1 without fill. A thread an output lane: stores are coalesced,
// the reads are a gather.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxOwners = 32;             // Kg + 1
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int owner_of(int32_t slot, int32_t Kg) {
  return slot >= 0 ? slot % Kg : Kg;
}

__global__ void __launch_bounds__(kThreads) bucket_by_owner_kernel(
    const int32_t* __restrict__ slot, int64_t N, int32_t Kg, int32_t R_req,
    int64_t chunk, int32_t* __restrict__ req, int32_t* __restrict__ row,
    int32_t* __restrict__ pos_out, int32_t* __restrict__ scratch) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x, m = blockIdx.y;
  const int K1 = Kg + 1;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  __shared__ int base[kMaxOwners], total[kMaxOwners], tile[kMaxOwners];
  __shared__ int wcnt[kWarps][kMaxOwners];
  const int32_t* s = slot + (int64_t)m * N;
  const int64_t lo = (int64_t)b * chunk;
  const int64_t hi = lo + chunk < N ? lo + chunk : N;

  // 1. the owners of this block's chunk
  if (tid < K1) base[tid] = 0;
  __syncthreads();
  for (int64_t i = lo + tid; i < hi; i += blockDim.x)
    atomicAdd(&base[owner_of(s[i], Kg)], 1);
  __syncthreads();
  if (tid < K1) scratch[((int64_t)m * G + b) * K1 + tid] = base[tid];
  grid.sync();

  // 2. this chunk's bases: the counts of the member's chunks before it
  if (tid < K1) {
    int before = 0, all = 0;
    for (int bb = 0; bb < G; ++bb) {
      const int c = scratch[((int64_t)m * G + bb) * K1 + tid];
      before += bb < b ? c : 0;
      all += c;
    }
    base[tid] = before;
    total[tid] = all;
  }
  __syncthreads();

  // 3. ranks in lane order, a tile at a time
  const unsigned lt = (1u << lane) - 1u;
  for (int64_t t0 = lo; t0 < hi; t0 += blockDim.x) {
    const int64_t i = t0 + tid;
    const bool valid = i < hi;
    const int32_t sl = valid ? s[i] : -1;
    const int o = valid ? owner_of(sl, Kg) : -1;
    for (int e = tid; e < kWarps * K1; e += blockDim.x)
      wcnt[e / K1][e % K1] = 0;
    __syncthreads();
    const unsigned same = __match_any_sync(0xffffffffu, o);
    const int wrank = __popc(same & lt);
    if (valid && wrank == 0) wcnt[w][o] = __popc(same);
    __syncthreads();
    if (tid < K1) {
      int run = 0;
      for (int ww = 0; ww < kWarps; ++ww) {
        const int c = wcnt[ww][tid];
        wcnt[ww][tid] = run;
        run += c;
      }
      tile[tid] = run;
    }
    __syncthreads();
    if (valid) {
      const int p = base[o] + wcnt[w][o] + wrank;
      const bool inb = o < Kg && p < R_req;
      const int64_t at = ((int64_t)m * Kg + o) * R_req + p;
      if (inb) req[at] = sl / Kg;
      row[(int64_t)m * N + i] = inb ? (int32_t)at : -1;
      if (pos_out)
        pos_out[(int64_t)m * N + i] = o < Kg ? p : total[Kg - 1] + p;
    }
    __syncthreads();
    if (tid < K1) base[tid] += tile[tid];
    __syncthreads();
  }

  // the request entries no lane took
  int32_t* rm = req + (int64_t)m * Kg * R_req;
  const int64_t entries = (int64_t)Kg * R_req;
  for (int64_t e = (int64_t)b * blockDim.x + tid; e < entries;
       e += (int64_t)G * blockDim.x)
    if (e % R_req >= total[e / R_req]) rm[e] = -1;
}

template <typename Off>
__global__ void __launch_bounds__(kThreads) clique_draw_kernel(
    const Off* __restrict__ pairs, const int32_t* __restrict__ blocks,
    int64_t R, int64_t nblk, int32_t W, const int32_t* __restrict__ recv,
    int64_t Q, int32_t Kg, int32_t fanout, const uint32_t* __restrict__ keys,
    int32_t first_owner, int32_t* __restrict__ out, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t qq = t / fanout;          // (clique, owner, q)
    const int f = (int)(t - qq * fanout);
    const int64_t co = qq / Q;              // the owner's member index
    const int64_t q = qq - co * Q;
    const int o = (int)(co % Kg);
    const int32_t r = recv[qq];
    int32_t res = -1;
    if (r >= 0) {
      const int64_t rc = r < R ? r : R - 1;
      const Off start = pairs[2 * ((int64_t)o * R + rc)];
      const Off deg = pairs[2 * ((int64_t)o * R + rc) + 1];
      if (deg > 0) {
        const uint32_t* kw = keys + 4 * co;
        const uint64_t og = (uint64_t)(first_owner + o);
        const LtKey k0 = lt_fold_in(LtKey{kw[0], kw[1]}, og);
        const LtKey k1 = lt_fold_in(LtKey{kw[2], kw[3]}, og);
        const uint32_t deg32 =
            deg < (Off)2147483647 ? (uint32_t)deg : 2147483647u;
        const int64_t at =
            (int64_t)start +
            (int64_t)lt_bounded(lt_word(k0.lo, k0.hi, (uint32_t)q), deg32);
        const int64_t blk = at / W;
        const int64_t bbase = blk * W;
        const int64_t end = (int64_t)start + (int64_t)deg;
        const int64_t lo = ((int64_t)start > bbase ? (int64_t)start : bbase)
                           - bbase;
        const int64_t hi = (end < bbase + W ? end : bbase + W) - bbase;
        const uint32_t mm = hi - lo > 1 ? (uint32_t)(hi - lo) : 1u;
        const uint32_t lane = (uint32_t)q * (uint32_t)fanout + (uint32_t)f;
        const int64_t off = lo + lt_bounded(lt_word(k1.lo, k1.hi, lane), mm);
        const int64_t bc = blk < nblk ? blk : nblk - 1;
        res = blocks[((int64_t)o * nblk + bc) * W + off];
      }
    }
    out[t] = res;
  }
}

__global__ void __launch_bounds__(kThreads) clique_draw_unsort_kernel(
    const int32_t* __restrict__ back, const int32_t* __restrict__ row,
    const int32_t* __restrict__ fill, int64_t F, int32_t fanout,
    int32_t* __restrict__ out, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t per = (int64_t)fanout * F;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t m = t / per;
    const int64_t rem = t - m * per;
    const int64_t f = rem / F;
    const int64_t i = rem - f * F;
    const int32_t r = row[m * F + i];
    out[t] = r >= 0 ? back[(int64_t)r * fanout + f]
                    : (fill != nullptr ? fill[t] : -1);
  }
}

// The cooperative grid: at most the blocks of bucket_by_owner_kernel that
// fit on the card at once (found once a device), shared by the members.
static int resident_blocks(cudaError_t* err) {
  static int resident[64];
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
          &per_sm, bucket_by_owner_kernel, kThreads, 0);
    if (*err != cudaSuccess) return 0;
    resident[dev] = per_sm * sms;
  }
  return resident[dev];
}

}  // namespace

// K12. slot [M, N] int32 (-1 = miss) -> req [M, Kg, R_req], row [M, N] and,
// when pos is not null, pos [M, N], all int32 and contiguous. scratch:
// M * grid * (Kg + 1) int32, grid from lt_bucket_grid. 1 <= Kg < 32 and
// M * Kg * R_req < 2^31.
LT_EXPORT int lt_bucket_grid(int64_t M, int64_t N) {
  cudaError_t err;
  const int resident = resident_blocks(&err);
  if (resident <= 0 || M <= 0 || resident < M) return 0;
  int64_t need = (N + kThreads - 1) / kThreads;
  if (need < 1) need = 1;
  const int64_t per = resident / M;
  return (int)(need < per ? need : per);
}

LT_EXPORT int lt_bucket_by_owner(const int32_t* slot, int64_t M, int64_t N,
                                 int32_t Kg, int32_t R_req, int32_t* req,
                                 int32_t* row, int32_t* pos,
                                 int32_t* scratch, void* stream) {
  if (Kg < 1 || Kg + 1 > kMaxOwners || R_req < 1 || M < 1 ||
      M * Kg * (int64_t)R_req >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int G = lt_bucket_grid(M, N);
  if (G <= 0) {
    resident_blocks(&err);
    return (int)(err != cudaSuccess ? err
                                    : cudaErrorCooperativeLaunchTooLarge);
  }
  const int64_t chunk =
      ((N + G - 1) / G + kThreads - 1) / kThreads * kThreads;
  void* args[] = {&slot, &N, &Kg, &R_req, (void*)&chunk, &req, &row,
                  &pos, &scratch};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)bucket_by_owner_kernel, dim3((unsigned)G, (unsigned)M),
      kThreads, args, 0, (cudaStream_t)stream);
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
      first_owner < 0 || Q * fanout >= ((int64_t)1 << 32))
    return (int)cudaErrorInvalidValue;
  clique_draw_kernel<Off><<<lt_grid(total), kThreads, 0,
                            (cudaStream_t)stream>>>(
      pairs, blocks, R, nblk, W, recv, Q, Kg, fanout, keys, first_owner, out,
      total);
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
  const int64_t total = M * F * fanout;
  if (total == 0) return (int)cudaSuccess;
  if (fanout <= 0) return (int)cudaErrorInvalidValue;
  clique_draw_unsort_kernel<<<lt_grid(total), kThreads, 0,
                         (cudaStream_t)stream>>>(back, row, fill, F, fanout,
                                                 out, total);
  return (int)cudaGetLastError();
}
