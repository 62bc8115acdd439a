// Host-memory registration for the zero-copy miss paths of K4
// (cached_gather) and K5 (csr_draw).
//
// The reference keeps its full graph and features in pinned host memory
// and lets kernels read a miss over PCIe through a UVA pointer
// (cache_impl.cuh:239-272). A host table here is an existing numpy buffer,
// so it is pinned in place with cudaHostRegister (tensor.pin_memory() would
// copy it a second time) and mapped into the device's address space. The
// buffer is writable RAM: the trainer copies a read-only array (a memmapped
// dataset file) into RAM once before it registers it. A refused
// registration is returned to the caller, which raises.
// legion_tpu_torch/ops/host_memory.py keeps the registry of registered
// ranges.
#include "common.cuh"

// Pin [ptr, ptr + bytes) and return its device address in *dev_ptr.
LT_EXPORT int lt_host_register(void* ptr, int64_t bytes, void** dev_ptr) {
  cudaError_t e = cudaHostRegister(
      ptr, (size_t)bytes, cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (e == cudaSuccess) {
    e = cudaHostGetDevicePointer(dev_ptr, ptr, 0);
    if (e != cudaSuccess) cudaHostUnregister(ptr);
  }
  // a refused registration is reported here, not by the next launch
  cudaGetLastError();
  return (int)e;
}

LT_EXPORT int lt_host_unregister(void* ptr) {
  cudaError_t e = cudaHostUnregister(ptr);
  cudaGetLastError();
  return (int)e;
}

// The link's practical rate for scattered rows: read rows `ids` of a
// registered host table [*, row_bytes] (base a multiple of 16, row_bytes of
// 2) as K4's miss path does, a warp a row, kProbeRows rows in flight, each
// row asked for as its `align`-aligned span (16: the 16-byte chunks that
// hold the row's own bytes, so the same 128-byte lines) cut to the table,
// and fold what arrives into *sink so that no load is dropped. Nothing is
// converted or stored.
constexpr int kProbeRows = 4;

__global__ void __launch_bounds__(kThreads) host_read_probe_kernel(
    const char* __restrict__ host, int64_t host_rows, int64_t row_bytes,
    const int32_t* __restrict__ ids, int64_t n, int align,
    uint32_t* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const uintptr_t tab_lo = reinterpret_cast<uintptr_t>(host);
  const uintptr_t tab_hi = tab_lo + (uintptr_t)(host_rows * row_bytes);
  const uintptr_t m = (uintptr_t)align - 1;
  uint32_t acc = 0;
  for (int64_t i = kProbeRows * ((int64_t)blockIdx.x * (blockDim.x >> 5)
                                 + (threadIdx.x >> 5));
       i < n; i += kProbeRows * warps) {
    uintptr_t lo[kProbeRows];
    int nch[kProbeRows];
    int most = 0;
#pragma unroll
    for (int j = 0; j < kProbeRows; ++j) {
      nch[j] = 0;
      if (i + j < n) {
        const uintptr_t at = tab_lo + (uintptr_t)(ids[i + j] * row_bytes);
        const uintptr_t a = at & ~m, b = (at + row_bytes + m) & ~m;
        lo[j] = a > tab_lo ? a : tab_lo;
        nch[j] = (int)(((b < tab_hi ? b : tab_hi) - lo[j]) >> 4);
      }
      most = max(most, nch[j]);
    }
    for (int c0 = 0; c0 < most; c0 += 64) {
      uint4 v[kProbeRows][2];
#pragma unroll
      for (int j = 0; j < kProbeRows; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int c = c0 + 32 * k + lane;
          v[j][k] = make_uint4(0, 0, 0, 0);
          if (c < nch[j])
            v[j][k] = __ldcs(reinterpret_cast<const uint4*>(
                lo[j] + 16 * (uintptr_t)c));
        }
#pragma unroll
      for (int j = 0; j < kProbeRows; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          acc ^= v[j][k].x ^ v[j][k].y ^ v[j][k].z ^ v[j][k].w;
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) atomicXor(sink, acc);
}

// ids [n] int32 in [0, host_rows); align a power of two, 16 to 128.
LT_EXPORT int lt_host_read_probe(const void* host, int64_t host_rows,
                                 int64_t row_bytes, const int32_t* ids,
                                 int64_t n, int align, uint32_t* sink,
                                 void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if ((uintptr_t)host % 16 || row_bytes <= 0 || row_bytes % 2 ||
      align < 16 || align > 128 || (align & (align - 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t per_block = kProbeRows * (kThreads / 32);
  int64_t blocks = (n + per_block - 1) / per_block;
  blocks = blocks < 132 * 8 ? blocks : 132 * 8;
  host_read_probe_kernel<<<(unsigned int)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const char*)host, host_rows, row_bytes, ids, n, align, sink);
  return (int)cudaGetLastError();
}

// The link's practical rate for scattered words, as K5's miss path asks for
// them: thread t reads the 4-byte word `at[t]` of a registered host table
// (none where at[t] < 0) and folds it into a value that is never stored, so
// no load is dropped. Neighbouring threads are one warp's load,
// as in K5.
__global__ void __launch_bounds__(kThreads) host_word_probe_kernel(
    const int32_t* __restrict__ host, const int64_t* __restrict__ at,
    int64_t n, uint32_t* __restrict__ sink) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  uint32_t acc = 0;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const int64_t a = at[t];
    if (a >= 0) acc ^= (uint32_t)__ldcs(host + a);
  }
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) atomicXor(sink, acc);
}

// at [n] int64 word offsets inside the table (or negative: no load).
LT_EXPORT int lt_host_word_probe(const void* host, const int64_t* at,
                                 int64_t n, uint32_t* sink, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if ((uintptr_t)host % 4) return (int)cudaErrorInvalidValue;
  host_word_probe_kernel<<<lt_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)host, at, n, sink);
  return (int)cudaGetLastError();
}
