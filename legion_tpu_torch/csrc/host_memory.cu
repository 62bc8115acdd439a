// Host-memory registration for the zero-copy miss paths of K4
// (cached_gather) and K5 (csr_draw).
//
// The reference keeps its full graph and features in pinned host memory
// and lets kernels read a miss over PCIe through a UVA pointer
// (cache_impl.cuh:239-272). A host table here is an existing numpy buffer,
// so it is pinned in place with cudaHostRegister (never copied:
// tensor.pin_memory() would double host RAM) and mapped into the device's
// address space. A read-only mapping (a memmapped dataset file) needs
// cudaHostRegisterReadOnly; a platform without it refuses the
// registration, and the caller raises. legion_tpu_torch/ops/host_memory.py
// keeps the registry of registered ranges.
#include "common.cuh"

// Pin [ptr, ptr + bytes) and return its device address in *dev_ptr.
LT_EXPORT int lt_host_register(void* ptr, int64_t bytes, int read_only,
                               void** dev_ptr) {
  unsigned int flags = cudaHostRegisterMapped | cudaHostRegisterPortable;
  if (read_only) flags |= cudaHostRegisterReadOnly;
  cudaError_t e = cudaHostRegister(ptr, (size_t)bytes, flags);
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
