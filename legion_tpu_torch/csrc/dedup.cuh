// Shared by the dedup kernels (K8 dedup_sort.cu, K9 dedup_map.cu).
#pragma once

#include "common.cuh"

// The dedup kernels (K8, K9) cut their arrays into tiles of kTile entries,
// kItems neighbouring entries a thread.
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

// Exclusive scan across a block of kThreads threads of (count, last) pairs
// under (sum, max): this thread's exclusive pair (the identity is (0, -1))
// and the block's totals. Starts with a barrier, so it may be called again.
__device__ __forceinline__ void lt_block_scan_sum_max(
    int cnt, int last, int* ex_cnt, int* ex_last, int* tot_cnt,
    int* tot_last) {
  __shared__ int s_cnt[kThreads / 32], s_last[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int c = cnt, l = last;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int c2 = __shfl_up_sync(0xffffffffu, c, o);
    const int l2 = __shfl_up_sync(0xffffffffu, l, o);
    if (lane >= o) {
      c += c2;
      l = max(l, l2);
    }
  }
  int lp = __shfl_up_sync(0xffffffffu, l, 1);
  if (lane == 0) lp = -1;
  __syncthreads();  // the previous call's readers are done
  if (lane == 31) {
    s_cnt[warp] = c;
    s_last[warp] = l;
  }
  __syncthreads();
  int wc = 0, wl = -1, tc = 0, tl = -1;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int sc = s_cnt[w], sl = s_last[w];
    if (w < warp) {
      wc += sc;
      wl = max(wl, sl);
    }
    tc += sc;
    tl = max(tl, sl);
  }
  *ex_cnt = wc + c - cnt;
  *ex_last = max(wl, lp);
  *tot_cnt = tc;
  *tot_last = tl;
}
