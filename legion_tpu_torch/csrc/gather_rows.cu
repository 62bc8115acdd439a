// K1 gather_rows: out[i] = table[ids[i]], a zero row where ids[i] < 0.
//
// Replaces legion_tpu/ops/pallas_segment.py::gather_rows_pallas, which
// issues one async row DMA per id (8 in flight) from HBM into VMEM.
//
// Bound on this card: device-memory bytes. Each output row costs one
// random row read and one contiguous row write (256 B + 256 B for a
// 128-wide bf16 row) plus a 4-byte id read; there is no arithmetic.
// Design: the rows are copied as opaque words, so one kernel serves every
// dtype of the same width. A thread moves one 16-byte word when the row
// width allows it (16 threads per 256-byte row: a row is read by
// neighbouring threads as one coalesced 256-byte segment), else 4- or
// 2-byte words. Ids past the table clamp to its last row, as the JAX
// gather clamps.
#include "common.cuh"

template <typename Word>
__global__ void gather_rows_kernel(const Word* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   Word* __restrict__ out, int64_t n,
                                   int64_t num_rows, int64_t words_per_row) {
  const int64_t total = n * words_per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t row = t / words_per_row;
    const int64_t w = t - row * words_per_row;
    const int32_t id = ids[row];
    Word v{};
    if (id >= 0) {
      const int64_t src = id < num_rows ? id : num_rows - 1;
      v = table[src * words_per_row + w];
    }
    out[t] = v;
  }
}

template <typename Word>
static int launch(const void* table, const int32_t* ids, void* out,
                  int64_t n, int64_t num_rows, int64_t row_bytes,
                  cudaStream_t stream) {
  const int64_t wpr = row_bytes / (int64_t)sizeof(Word);
  gather_rows_kernel<Word><<<lt_grid(n * wpr), kThreads, 0, stream>>>(
      (const Word*)table, ids, (Word*)out, n, num_rows, wpr);
  return (int)cudaGetLastError();
}

// row_bytes = F * itemsize. table and out must be contiguous [*, F].
LT_EXPORT int lt_gather_rows(const void* table, const int32_t* ids,
                             void* out, int64_t n, int64_t num_rows,
                             int64_t row_bytes, void* stream) {
  if (n == 0 || row_bytes == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned16 = ((uintptr_t)table % 16 == 0) &&
                         ((uintptr_t)out % 16 == 0);
  if (row_bytes % 16 == 0 && aligned16)
    return launch<uint4>(table, ids, out, n, num_rows, row_bytes, s);
  if (row_bytes % 4 == 0 && (uintptr_t)table % 4 == 0 &&
      (uintptr_t)out % 4 == 0)
    return launch<uint32_t>(table, ids, out, n, num_rows, row_bytes, s);
  return launch<uint16_t>(table, ids, out, n, num_rows, row_bytes, s);
}

LT_EXPORT const char* lt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
