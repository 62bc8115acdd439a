// K5 csr_draw: per-slot uniform neighbour draws, fanout-major, from the
// device sub-CSR of cached rows or from the full CSR (on the device, or
// in registered host memory read zero-copy).
//
// Replaces legion_tpu/sampling/access.py::DeviceCSRAccess.sample_neighbors
// (:115-128) and CachedTopoAccess.sample_neighbors (:279-310), which on
// the TPU were a device draw plus a pure_callback into
// native.sample_neighbors for the rows not in the cache. Per lane
// (f, i), written to out[f*F + i]:
//   v = frontier[i]            (-1 for v < 0);
//   row = row_map[v]           (when there is a row_map, else -1);
//   row >= 0  -> the row [sub_indptr[row], sub_indptr[row+1]) of
//                sub_indices (device memory);
//   otherwise -> the row [indptr[v], indptr[v+1]) of indices (the full
//                CSR; host memory for a host-resident graph);
//   deg = 0   -> -1, else indices[start + (word * deg >> 32)].
// The random word is lt_word(ka, kb, f*F + i) (common.cuh), so the plain
// PyTorch version (sampling/access.py::csr_draw_plain) agrees bit for bit,
// and a cached row and its host row give the same neighbour.
//
// Bound on this card: latency of two dependent random reads per lane
// (the row's offsets, then one neighbour id), over PCIe for a row that
// misses the cache. Design: one thread per lane, the lanes of one slot in
// neighbouring threads, so a warp reads a slot's offsets once (one
// request, broadcast) instead of once per draw; the writes scatter by F,
// in device memory. The full CSR's offsets are int32 or int64 (templated);
// host offsets are int64.
#include "common.cuh"

template <typename Off>
__global__ void csr_draw_kernel(const int32_t* __restrict__ frontier,
                                int64_t F, int32_t fanout,
                                const int32_t* __restrict__ row_map,
                                const int64_t* __restrict__ sub_indptr,
                                const int32_t* __restrict__ sub_indices,
                                const Off* __restrict__ indptr,
                                const int32_t* __restrict__ indices,
                                int64_t num_nodes, uint32_t ka, uint32_t kb,
                                int32_t* __restrict__ out) {
  const int64_t total = F * fanout;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / fanout;
    const int64_t lane = (t - i * fanout) * F + i;
    const int32_t v = frontier[i];
    int32_t result = -1;
    if (v >= 0) {
      const int64_t vc = v < num_nodes ? v : num_nodes - 1;
      const int32_t row = row_map != nullptr ? row_map[vc] : -1;
      int64_t start, end;
      const int32_t* idx;
      if (row >= 0) {
        start = sub_indptr[row];
        end = sub_indptr[row + 1];
        idx = sub_indices;
      } else {
        start = (int64_t)indptr[vc];
        end = (int64_t)indptr[vc + 1];
        idx = indices;
      }
      const int64_t deg = end - start;
      if (deg > 0) {
        const int64_t deg32 = deg < 2147483647LL ? deg : 2147483647LL;
        const uint32_t r =
            lt_bounded(lt_word(ka, kb, (uint32_t)lane), (uint32_t)deg32);
        result = idx[start + r];
      }
    }
    out[lane] = result;
  }
}

template <typename Off>
static int launch(const int32_t* frontier, int64_t F, int32_t fanout,
                  const int32_t* row_map, const int64_t* sub_indptr,
                  const int32_t* sub_indices, const Off* indptr,
                  const int32_t* indices, int64_t num_nodes, uint32_t ka,
                  uint32_t kb, int32_t* out, void* stream) {
  if (F == 0 || fanout == 0) return (int)cudaSuccess;
  csr_draw_kernel<Off><<<lt_grid(F * fanout), kThreads, 0,
                         (cudaStream_t)stream>>>(
      frontier, F, fanout, row_map, sub_indptr, sub_indices, indptr, indices,
      num_nodes, ka, kb, out);
  return (int)cudaGetLastError();
}

// row_map may be null (no cache: every slot draws from the full CSR).
LT_EXPORT int lt_csr_draw_i32(const int32_t* frontier, int64_t F,
                              int32_t fanout, const int32_t* row_map,
                              const int64_t* sub_indptr,
                              const int32_t* sub_indices,
                              const int32_t* indptr, const int32_t* indices,
                              int64_t num_nodes, uint32_t ka, uint32_t kb,
                              int32_t* out, void* stream) {
  return launch<int32_t>(frontier, F, fanout, row_map, sub_indptr,
                         sub_indices, indptr, indices, num_nodes, ka, kb,
                         out, stream);
}

LT_EXPORT int lt_csr_draw_i64(const int32_t* frontier, int64_t F,
                              int32_t fanout, const int32_t* row_map,
                              const int64_t* sub_indptr,
                              const int32_t* sub_indices,
                              const int64_t* indptr, const int32_t* indices,
                              int64_t num_nodes, uint32_t ka, uint32_t kb,
                              int32_t* out, void* stream) {
  return launch<int64_t>(frontier, F, fanout, row_map, sub_indptr,
                         sub_indices, indptr, indices, num_nodes, ka, kb,
                         out, stream);
}
