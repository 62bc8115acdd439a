// K3 windowed_draw: block-windowed neighbour draws, fanout-major.
//
// Replaces the XLA body of
// legion_tpu/sampling/access.py::WindowedCSRAccess.sample_neighbors
// (no Pallas source). For frontier slot i (vertex v, row [start,
// start+deg) of the CSR):
//   r0 ~ U[0, max(deg, 1)) picks the W-wide block b = (start + r0) / W;
//   each of the fanout draws is uniform over [lo, hi) = the row's part
//   of block b, so every neighbour keeps marginal 1/deg per draw.
// Output lane f*F + i holds draw f of slot i; -1 for an invalid slot
// (v < 0) or a vertex of degree 0.
//
// Random words come from the keyed integer hash in common.cuh: r0 from
// (ka0, kb0, lane i), the in-block draw from (ka1, kb1, lane f*F + i).
// The four key words are read from the card (`keys`, the hop's row of K10
// step_keys' output, or words the wrapper uploaded), once a thread, so a
// replayed CUDA graph draws with each step's own keys. The plain PyTorch
// version (sampling/access.py::windowed_draw_plain) computes the same
// words, so the two agree bit for bit.
//
// Bound on this card: the launch. The card needs a few microseconds for
// either hop of the main path (8000 x 25 and 96,576 x 10 draws), about
// what an empty kernel takes, and the host needs several times that to
// call it (chip_smoke.py prints both beside `launch_floor`). What the
// kernel itself waits for is three dependent reads (the vertex, its
// (start, deg) pair, one int32 of the edge block) and, by bytes, the
// 32-byte sectors those reads and the scattered writes touch.
//
// Design: a warp owns 1 << sshift neighbouring frontier slots at a time (8
// on the main path) and no slot straddles a warp. Lane j of the first
// 1 << sshift reads slot j's vertex and its pair, once, as one 8- or
// 16-byte load, and computes r0, the block's base, lo and hi - lo once; the
// warp gets them by shuffle. Then a lane a draw: lane (q, j) makes draw
// fb + q of slot j, so that a warp's store of one step covers whole
// 32-byte sectors of out (8 neighbouring slots of one draw index), kSteps
// steps' loads all issued before the first store, in a loop over fb that
// takes any fanout. W is a power of two wherever the port builds the
// blocks, and then the block is a shift (any other W divides). With int32
// pairs all arithmetic but the final addresses is 32-bit and unsigned: the
// edge count is below 2^31, so no sum here reaches 2^32.
#include "common.cuh"

constexpr int kSteps = 4;  // draws of a lane in flight

template <typename Off>
struct Pair;
template <>
struct Pair<int32_t> {
  typedef uint32_t U;
  typedef int2 V;
};
template <>
struct Pair<int64_t> {
  typedef uint64_t U;
  typedef longlong2 V;
};

template <typename U>
__device__ __forceinline__ U lt_shfl(U x, int src);
template <>
__device__ __forceinline__ uint32_t lt_shfl(uint32_t x, int src) {
  return __shfl_sync(0xffffffffu, x, src);
}
template <>
__device__ __forceinline__ uint64_t lt_shfl(uint64_t x, int src) {
  return (uint64_t)__shfl_sync(0xffffffffu, (unsigned long long)x, src);
}

template <typename Off>
__global__ void __launch_bounds__(kThreads) windowed_draw_kernel(
    const Off* __restrict__ row_pairs, const int32_t* __restrict__ blocks,
    const int32_t* __restrict__ frontier, int32_t* __restrict__ out,
    int64_t F, int32_t fanout, int32_t W, int wshift, int sshift,
    int64_t num_nodes, const uint32_t* __restrict__ keys) {
  typedef typename Pair<Off>::U U;
  const uint32_t ka0 = keys[0], kb0 = keys[1], ka1 = keys[2], kb1 = keys[3];
  typedef typename Pair<Off>::V V;
  const int lane = threadIdx.x & 31;
  const int spw = 1 << sshift;       // slots of a warp at a time
  const int j = lane & (spw - 1);    // this lane's slot among them
  const int q = lane >> sshift;      // and its draw among a step's
  const int dps = 32 >> sshift;      // draws of a slot in a step
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int64_t chunks = (F + spw - 1) >> sshift;
  for (int64_t chunk = (int64_t)blockIdx.x * (blockDim.x >> 5)
                       + (threadIdx.x >> 5);
       chunk < chunks; chunk += warps) {
    const int64_t i = (chunk << sshift) + j;  // this lane's slot
    // lanes q == 0: the chosen block of slot i: its first edge, the row's
    // first place in it and how many places the row has there (0: no draw)
    U base = 0;
    uint32_t lo = 0, m = 0;
    if (q == 0 && i < F) {
      const int32_t v = frontier[i];
      if (v >= 0) {
        const int64_t vc = v < num_nodes ? v : num_nodes - 1;
        const V p = reinterpret_cast<const V*>(row_pairs)[vc];
        if (p.y > 0) {
          const U start = (U)p.x, deg = (U)p.y;
          const uint32_t deg32 =
              deg < (U)2147483647u ? (uint32_t)deg : 2147483647u;
          const U at =
              start + lt_bounded(lt_word(ka0, kb0, (uint32_t)i), deg32);
          base = wshift >= 0 ? (at >> wshift) << wshift : at / (U)W * (U)W;
          const U end = start + deg;
          lo = start > base ? (uint32_t)(start - base) : 0u;
          m = (end - base < (U)W ? (uint32_t)(end - base) : (uint32_t)W) - lo;
        }
      }
    }
    base = lt_shfl<U>(base, j);
    lo = lt_shfl<uint32_t>(lo, j);
    m = lt_shfl<uint32_t>(m, j);
    const uint32_t lane0 = (uint32_t)F * (uint32_t)q + (uint32_t)i;
    for (int fb = 0; fb < fanout; fb += kSteps * dps) {
      int32_t res[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int f = fb + u * dps + q;
        res[u] = -1;
        if (f < fanout && m > 0) {
          // the hashed lane is f*F + i mod 2^32
          const uint32_t hl = lane0 + (uint32_t)F * (uint32_t)(fb + u * dps);
          res[u] = blocks[base + lo + lt_bounded(lt_word(ka1, kb1, hl), m)];
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int f = fb + u * dps + q;
        if (f < fanout && i < F) out[(int64_t)f * F + i] = res[u];
      }
    }
  }
}

template <typename Off>
static int launch(const Off* row_pairs, const int32_t* blocks,
                  const int32_t* frontier, int32_t* out, int64_t F,
                  int32_t fanout, int32_t W, int64_t num_nodes,
                  const uint32_t* keys, void* stream) {
  if (F == 0 || fanout == 0) return (int)cudaSuccess;
  if (W <= 0 || (uintptr_t)row_pairs % (2 * sizeof(Off)))
    return (int)cudaErrorInvalidValue;
  int wshift = -1;
  if ((W & (W - 1)) == 0)
    for (wshift = 0; (1 << wshift) < W; ++wshift) {}
  // 8 slots a warp and 4 draws a step; with one or two draws a slot, more
  // slots a warp so that no lane of a step idles
  const int sshift = fanout >= 4 ? 3 : fanout >= 2 ? 4 : 5;
  const int64_t chunks = (F + (1 << sshift) - 1) >> sshift;
  windowed_draw_kernel<Off><<<lt_grid(chunks * 32), kThreads, 0,
                              (cudaStream_t)stream>>>(
      row_pairs, blocks, frontier, out, F, fanout, W, wshift, sshift,
      num_nodes, keys);
  return (int)cudaGetLastError();
}

LT_EXPORT int lt_windowed_draw_i32(const int32_t* row_pairs,
                                   const int32_t* blocks,
                                   const int32_t* frontier, int32_t* out,
                                   int64_t F, int32_t fanout, int32_t W,
                                   int64_t num_nodes, const uint32_t* keys,
                                   void* stream) {
  return launch<int32_t>(row_pairs, blocks, frontier, out, F, fanout, W,
                         num_nodes, keys, stream);
}

LT_EXPORT int lt_windowed_draw_i64(const int64_t* row_pairs,
                                   const int32_t* blocks,
                                   const int32_t* frontier, int32_t* out,
                                   int64_t F, int32_t fanout, int32_t W,
                                   int64_t num_nodes, const uint32_t* keys,
                                   void* stream) {
  return launch<int64_t>(row_pairs, blocks, frontier, out, F, fanout, W,
                         num_nodes, keys, stream);
}
