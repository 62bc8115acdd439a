// The staged pipeline's host half (ops/host_memory.py): multi-threaded C++
// on the host, built into the kernels' library by nvcc. No device code.
//
// lt_host_gather_rows is the port of the JAX package's native.gather_rows
// (legion_tpu/native/__init__.py:78-110, lg_gather_rows_f32/_bf16): row j
// of out is the first row_bytes of row ids[j] of a host table of pitch
// pitch_bytes, a zero row for ids[j] < 0 or past the table. It fills the
// pinned staging buffer that one bulk copy then ships to the card. With a
// bf16 cache the table is the trainer's bf16 rows (bf16_rows, rounded once
// at set-up), so the shipped bits are K4's. Bound: the host's memory for
// scattered rows; a thread prefetches the row kAhead ids ahead.
//
// lt_host_draw_i64 is the port of native.sample_neighbors (:112-137, the
// host draws of the per-hop chain): for n member rows of F frontier slots
// ([n, F] int32, -1 for a slot that needs no host draw), out[(m*F + i) *
// fanout + f] = indices[start + lt_bounded(lt_word(ka, kb, f*F + i),
// deg)] from the host CSR row of the slot's vertex (clamped to V - 1, as
// K5 clamps), -1 for a pad or degree 0, with (ka, kb) the first two of
// member m's four hop key words: K5's draw for a miss, bit for bit
// (csr_draw.cu), where the JAX package draws with its own generator from
// host_seed.
//
// Both split their rows over `threads` std::threads (the JAX package's
// _nthreads(): the process's CPUs), one contiguous chunk a thread, and run
// on the calling thread alone for small inputs.
#include <algorithm>
#include <cstring>
#include <thread>
#include <vector>

#include "common.cuh"

namespace {

constexpr int64_t kSerialBelow = 4096;  // rows done by the caller alone
constexpr int64_t kAhead = 16;          // rows a thread prefetches ahead

template <typename Body>
void parallel_rows(int64_t n, int threads, const Body& body) {
  if (threads <= 1 || n < kSerialBelow) {
    body(0, n);
    return;
  }
  const int64_t chunk = (n + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) {
    const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  body(0, std::min(n, chunk));
  for (auto& th : pool) th.join();
}

}  // namespace

LT_EXPORT int lt_host_gather_rows(const char* table, int64_t rows,
                                  int64_t pitch_bytes, const int32_t* ids,
                                  int64_t n, int64_t row_bytes, char* out,
                                  int threads) {
  parallel_rows(n, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      if (j + kAhead < hi) {
        const int32_t a = ids[j + kAhead];
        if (a >= 0 && a < rows)
          __builtin_prefetch(table + (int64_t)a * pitch_bytes);
      }
      const int32_t id = ids[j];
      char* dst = out + j * row_bytes;
      if (id >= 0 && id < rows)
        std::memcpy(dst, table + (int64_t)id * pitch_bytes, row_bytes);
      else
        std::memset(dst, 0, row_bytes);
    }
  });
  return 0;
}

LT_EXPORT int lt_host_draw_i64(const int64_t* indptr, const int32_t* indices,
                               int64_t num_nodes, const int32_t* frontier,
                               int64_t n, int64_t F, int32_t fanout,
                               const uint32_t* keys, int32_t* out,
                               int threads) {
  parallel_rows(n * F, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t s = lo; s < hi; ++s) {
      const int64_t m = s / F, i = s - m * F;
      const uint32_t ka = keys[4 * m], kb = keys[4 * m + 1];
      int32_t* dst = out + s * fanout;
      const int32_t v = frontier[s];
      uint32_t deg = 0;
      int64_t start = 0;
      if (v >= 0 && num_nodes > 0) {
        const int64_t vc = v < num_nodes ? v : num_nodes - 1;
        start = indptr[vc];
        const int64_t d = indptr[vc + 1] - start;
        deg = d <= 0 ? 0u : (uint32_t)(d < 2147483647LL ? d : 2147483647LL);
      }
      for (int32_t f = 0; f < fanout; ++f) {
        if (deg == 0) {
          dst[f] = -1;
          continue;
        }
        const uint32_t lane = (uint32_t)((int64_t)f * F + i);
        dst[f] = indices[start + lt_bounded(lt_word(ka, kb, lane), deg)];
      }
    }
  });
  return 0;
}
