// Yardsticks behind the same plain C interface as the kernels. They
// compute nothing and are on no path; chip_smoke.py times them as the host
// launches them and queued behind a kernel that holds the card.
//
// lt_noop: an empty kernel, the least time any launch through this route
// can take (`launch_floor`), against which the smallest kernels (K3, K5's
// hit-heavy form, K7) are read.
//
// lt_grid_sync_probe: an empty cooperative kernel of kThreads-thread blocks
// that calls grid.sync() n times (`grid_sync`): what a cooperative launch
// and each grid barrier of K9 (csrc/dedup_map.cu) cost at its grid.
#include <cooperative_groups.h>

#include "common.cuh"

__global__ void noop_kernel() {}

__global__ void __launch_bounds__(kThreads) grid_sync_kernel(int n) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

LT_EXPORT int lt_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

LT_EXPORT int lt_grid_sync_probe(int32_t n, int32_t blocks, void* stream) {
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel((const void*)grid_sync_kernel,
                                          blocks, kThreads, args, 0,
                                          (cudaStream_t)stream);
}
