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
// The plain PyTorch version (sampling/access.py::windowed_draw_plain)
// computes the same words, so the two agree bit for bit.
//
// Bound on this card: latency of two dependent random reads per lane
// (the (start, deg) pair, then one int32 of the edge block), a few
// hundred thousand to two million lanes per hop. Design: one thread per
// output lane, no shared memory; the fanout lanes of one slot re-read the
// same 8- or 16-byte pair, which L1/L2 serve.
#include "common.cuh"

template <typename Off>
__global__ void windowed_draw_kernel(const Off* __restrict__ row_pairs,
                                     const int32_t* __restrict__ blocks,
                                     const int32_t* __restrict__ frontier,
                                     int32_t* __restrict__ out, int64_t F,
                                     int32_t fanout, int32_t W,
                                     int64_t num_nodes, uint32_t ka0,
                                     uint32_t kb0, uint32_t ka1,
                                     uint32_t kb1) {
  const int64_t total = F * fanout;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       lane < total; lane += stride) {
    const int64_t i = lane % F;
    const int32_t v = frontier[i];
    int32_t result = -1;
    if (v >= 0) {
      const int64_t vc = v < num_nodes ? v : num_nodes - 1;
      const int64_t start = (int64_t)row_pairs[2 * vc];
      const int64_t deg = (int64_t)row_pairs[2 * vc + 1];
      if (deg > 0) {
        const int64_t deg32 = deg < 2147483647LL ? deg : 2147483647LL;
        const uint32_t r0 =
            lt_bounded(lt_word(ka0, kb0, (uint32_t)i), (uint32_t)deg32);
        const int64_t blk = (start + r0) / W;
        const int64_t base = blk * W;
        const int64_t lo = (start > base ? start : base) - base;
        const int64_t end = start + deg;
        const int64_t hi = (end < base + W ? end : base + W) - base;
        const uint32_t m = (uint32_t)(hi - lo > 1 ? hi - lo : 1);
        const int64_t off =
            lo + lt_bounded(lt_word(ka1, kb1, (uint32_t)lane), m);
        result = blocks[base + off];
      }
    }
    out[lane] = result;
  }
}

template <typename Off>
static int launch(const Off* row_pairs, const int32_t* blocks,
                  const int32_t* frontier, int32_t* out, int64_t F,
                  int32_t fanout, int32_t W, int64_t num_nodes, uint32_t ka0,
                  uint32_t kb0, uint32_t ka1, uint32_t kb1, void* stream) {
  if (F == 0 || fanout == 0) return (int)cudaSuccess;
  windowed_draw_kernel<Off><<<lt_grid(F * fanout), kThreads, 0,
                              (cudaStream_t)stream>>>(
      row_pairs, blocks, frontier, out, F, fanout, W, num_nodes, ka0, kb0,
      ka1, kb1);
  return (int)cudaGetLastError();
}

LT_EXPORT int lt_windowed_draw_i32(const int32_t* row_pairs,
                                   const int32_t* blocks,
                                   const int32_t* frontier, int32_t* out,
                                   int64_t F, int32_t fanout, int32_t W,
                                   int64_t num_nodes, uint32_t ka0,
                                   uint32_t kb0, uint32_t ka1, uint32_t kb1,
                                   void* stream) {
  return launch<int32_t>(row_pairs, blocks, frontier, out, F, fanout, W,
                         num_nodes, ka0, kb0, ka1, kb1, stream);
}

LT_EXPORT int lt_windowed_draw_i64(const int64_t* row_pairs,
                                   const int32_t* blocks,
                                   const int32_t* frontier, int32_t* out,
                                   int64_t F, int32_t fanout, int32_t W,
                                   int64_t num_nodes, uint32_t ka0,
                                   uint32_t kb0, uint32_t ka1, uint32_t kb1,
                                   void* stream) {
  return launch<int64_t>(row_pairs, blocks, frontier, out, F, fanout, W,
                         num_nodes, ka0, kb0, ka1, kb1, stream);
}
