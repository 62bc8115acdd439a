// The grouping of a call's lanes by the row they name, shared by
// hop_mean_grad (hop_agg.cu) and K17 segment_max and K18 segment_softmax
// (segment_max.cu, segment_softmax.cu).
//
// The segment ops keep theirs between a forward and its backward (the
// autograd Functions save it): hop_agg.cu::lt_group_segments builds it, a
// memset, a count, a one-pass scan, a fill and (sorted) hop_mean_grad's
// sort. The valid lanes (0 <= seg[e] < S) lie grouped by segment in
// `lanes`, segment r's run at [start[r], start[r] + cnt[r]); sorted, in
// ascending lane order (K18's sums take that order), else in any order
// (K17's max and tie counts do not depend on it). A run of more than
// kLong lanes (a hub) is also on the list `longs`, its chunks of kLong
// lanes numbered from its first chunk, so that a hub's work can be split
// across warps and combined in a fixed order.
#pragma once

#include <cstdint>

#include "common.cuh"

constexpr int kLong = 32;                // a run of more lanes is a long run
constexpr int kSegRows = 8 * kThreads;   // segments of a scan tile

// Long runs and their chunks of kLong lanes, at most, for E lanes.
__host__ __device__ inline int64_t lt_max_longs(int64_t E) {
  return E / (kLong + 1) + 1;
}
// a run of n > kLong lanes has ceil(n / kLong) < 2 n / kLong chunks
__host__ __device__ inline int64_t lt_max_chunks(int64_t E) {
  return 2 * E / kLong + 1;
}

// The kept grouping of E lanes into S segments, in int32 words, each piece
// 16-byte aligned: cnt [S]; counters [4] (long runs, their chunks); the
// scan's tile status words [tiles] (uint64) and tile ticket, zeroed with
// cnt and counters by one memset of the first zero_words; start [S];
// lanes [E]; longs [max_longs] (segment, first chunk, start, lanes).
struct LtGroupsLayout {
  int64_t cnt, counters, status, tiles, start, lanes, longs, zero_words,
      words;
};

inline LtGroupsLayout lt_groups_layout(int64_t S, int64_t E) {
  LtGroupsLayout l;
  int64_t at = 0;
  auto take = [&](int64_t n) {
    const int64_t p = at;
    at += (n + 3) / 4 * 4;
    return p;
  };
  l.cnt = take(S);
  l.counters = take(4);
  l.status = take(2 * ((S + kSegRows - 1) / kSegRows));
  l.tiles = take(1);
  l.zero_words = at;
  l.start = take(S);
  l.lanes = take(E);
  l.longs = take(4 * lt_max_longs(E));
  l.words = at;
  return l;
}

struct LtLaneGroups {
  int32_t *cnt, *counters, *tiles, *start, *lanes;
  uint64_t* status;
  int4* longs;
  int64_t zero_words;
};

inline LtLaneGroups lt_lane_groups(int32_t* base, int64_t S, int64_t E) {
  const LtGroupsLayout l = lt_groups_layout(S, E);
  LtLaneGroups g;
  g.cnt = base + l.cnt;
  g.counters = base + l.counters;
  g.status = reinterpret_cast<uint64_t*>(base + l.status);
  g.tiles = base + l.tiles;
  g.start = base + l.start;
  g.lanes = base + l.lanes;
  g.longs = reinterpret_cast<int4*>(base + l.longs);
  g.zero_words = l.zero_words;
  return g;
}

// The build's scratch: each lane's place in its run, then the unsorted
// runs.
struct LtSegTmp {
  int32_t *ticket, *pos;
};

inline int64_t lt_seg_tmp_words(int64_t E) { return 2 * ((E + 3) / 4 * 4); }

inline LtSegTmp lt_seg_tmp(int32_t* base, int64_t E) {
  return {base, base + (E + 3) / 4 * 4};
}

// Chunk q of the long runs (q < counters[1]): its run and its lanes [*a,
// *a + *n). The runs' first chunks increase along the list.
__device__ __forceinline__ int4 lt_chunk(const LtLaneGroups& g, int q, int* a,
                                         int* n) {
  int lo = 0, hi = g.counters[0] - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.longs[mid].y <= q) lo = mid;
    else hi = mid - 1;
  }
  const int4 run = g.longs[lo];  // segment, first chunk, start, lanes
  const int k = q - run.y;
  *a = run.z + k * kLong;
  *n = min(kLong, run.w - k * kLong);
  return run;
}

// Builds the grouping of seg [E] into `groups` (lt_groups_layout(S,
// E).words int32 words), using `tmp` (lt_seg_tmp_words(E) words), each run
// in ascending lane order where `sorted`. Returns a CUDA error code.
int lt_group_segments(const int32_t* seg, int64_t E, int64_t S,
                      int32_t* groups, int32_t* tmp, bool sorted,
                      cudaStream_t stream);
