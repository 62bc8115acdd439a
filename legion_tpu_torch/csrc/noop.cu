// lt_noop: an empty kernel behind the same plain C interface as the
// others. It computes nothing and is on no path: chip_smoke.py times it,
// as the host launches it and queued behind a kernel that holds the card,
// as the least time any launch through this route can take
// (`launch_floor`), against which the smallest kernels (K3, K5's hit-heavy
// form, K7) are read.
#include "common.cuh"

__global__ void noop_kernel() {}

LT_EXPORT int lt_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
