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
// The random word is lt_word(ka, kb, f*F + i) (common.cuh), with (ka, kb)
// the first two of the hop's four key words on the card (`keys`: K10
// step_keys' row for the hop, or words the wrapper uploaded), read once a
// thread so that a replayed CUDA graph draws with each step's keys; the plain
// PyTorch version (sampling/access.py::csr_draw_plain) agrees bit for bit,
// and a cached row and its host row give the same neighbour.
//
// Bound on this card: for a row that misses the cache, the link's request
// rate. What the card showed (NVIDIA H100 80GB HBM3 at 700 W; the link
// lines of chip_smoke.py's phase 5): loads made by the SMs from mapped host
// memory cost one request per distinct 128-byte line of a warp's
// load, about 250 M requests a second, whether one word of the line
// is asked for or all of it; the bytes hardly matter. A slot needs one
// request for its two offsets and one for each line its draws fall on (2.3
// of the 2.5 lines of a 50-neighbour row at fanout 10, so reading the row
// whole asks for more, not fewer), and the second waits for the first.
//
// Design: a group of G lanes (the least power of two >= the fanout, at
// most 32) owns kPasses consecutive frontier slots at a time. Lane u of the
// group reads slot u's vertex, map entry and offsets, once for all of the
// slot's draws: no slot's offsets are asked for by two warps, and no lane
// divides. The group then draws for its slots, a lane a draw (a loop where
// the fanout exceeds 32), with each slot's offsets from its owner by
// shuffle, and every neighbour load of the kPasses slots is started before
// the first store. The writes scatter by F, in device memory. The full
// CSR's offsets are int32 or int64 (templated); host offsets are int64.
//
// Reading a short host row whole would ask for more lines than its draws
// fall on, and one 16-byte load of both offsets asks for the same line as
// two 8-byte loads: neither is done.
//
// The device-only form (`device_only` = 1; the staged pipeline's
// CachedTopoAccess.lookup, which replaces legion_tpu/sampling/access.py::
// CachedTopoAccess.lookup, :279-297): a slot whose vertex the row_map does
// not hold draws nothing (-1 on its lanes) and no host memory is read
// (indptr and indices may be null); `served` [F], when given, gets 1 for a
// valid slot that row_map holds, else 0 (written by the lane that reads the
// slot's row). The host draws the unserved slots (host_half.cu) with the
// same words, so the merge equals the full form bit for bit.
#include "common.cuh"

constexpr int kPasses = 4;  // slots of a lane group in flight

template <typename Off>
__global__ void __launch_bounds__(kThreads) csr_draw_kernel(
    const int32_t* __restrict__ frontier, int64_t F, int32_t fanout,
    const int32_t* __restrict__ row_map,
    const int64_t* __restrict__ sub_indptr,
    const int32_t* __restrict__ sub_indices, const Off* __restrict__ indptr,
    const int32_t* __restrict__ indices, int64_t num_nodes,
    const uint32_t* __restrict__ keys, int32_t* __restrict__ out,
    uint8_t* __restrict__ served, int device_only, int gshift) {
  const uint32_t ka = keys[0], kb = keys[1];
  const int lane = threadIdx.x & 31;
  const int G = 1 << gshift;                  // lanes of a group
  const int sub = lane >> gshift;             // this lane's group
  const int gl = lane & (G - 1);              // and its place there
  const int P = G < kPasses ? G : kPasses;    // slots of a group at a time
  const int spw = (32 >> gshift) * P;         // slots of a warp at a time
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int64_t chunks = (F + spw - 1) / spw;
  for (int64_t chunk = (int64_t)blockIdx.x * (blockDim.x >> 5)
                       + (threadIdx.x >> 5);
       chunk < chunks; chunk += warps) {
    const int64_t i0 = chunk * spw + sub * P;  // the group's first slot
    // lane u < P of the group: the row of slot i0 + u (degree 0 for a pad
    // or past F)
    long long start = 0;
    uint32_t deg = 0;
    int hit = 0;
    if (gl < P && i0 + gl < F) {
      const int32_t v = frontier[i0 + gl];
      if (v >= 0) {
        const int64_t vc = v < num_nodes ? v : num_nodes - 1;
        const int32_t row = row_map != nullptr ? row_map[vc] : -1;
        long long end;
        if (row >= 0) {
          start = sub_indptr[row];
          end = sub_indptr[row + 1];
          hit = 1;
        } else if (device_only) {
          end = start;                        // not served: no draw
        } else {
          start = (long long)indptr[vc];
          end = (long long)indptr[vc + 1];
        }
        const long long d = end - start;
        deg = d <= 0 ? 0u : (uint32_t)(d < 2147483647LL ? d : 2147483647LL);
      }
      if (served != nullptr) served[i0 + gl] = (uint8_t)hit;
    }
    for (int fb = 0; fb < fanout; fb += G) {
      const int f = fb + gl;
      int64_t at[kPasses];
      int32_t res[kPasses];
#pragma unroll
      for (int u = 0; u < kPasses; ++u) {
        const int owner = (sub << gshift) + (u < P ? u : 0);
        const long long st = __shfl_sync(0xffffffffu, start, owner);
        const uint32_t dg = __shfl_sync(0xffffffffu, deg, owner);
        const int h = __shfl_sync(0xffffffffu, hit, owner);
        const int64_t i = i0 + u;
        at[u] = u < P && i < F && f < fanout ? (int64_t)f * F + i : -1;
        res[u] = -1;
        if (at[u] >= 0 && dg > 0) {
          const uint32_t r = lt_bounded(lt_word(ka, kb, (uint32_t)at[u]), dg);
          res[u] = (h ? sub_indices : indices)[st + r];
        }
      }
#pragma unroll
      for (int u = 0; u < kPasses; ++u)
        if (at[u] >= 0) out[at[u]] = res[u];
    }
  }
}

template <typename Off>
static int launch(const int32_t* frontier, int64_t F, int32_t fanout,
                  const int32_t* row_map, const int64_t* sub_indptr,
                  const int32_t* sub_indices, const Off* indptr,
                  const int32_t* indices, int64_t num_nodes,
                  const uint32_t* keys, int32_t* out, uint8_t* served,
                  int device_only, void* stream) {
  if (F == 0) return (int)cudaSuccess;
  if (fanout == 0 && served == nullptr) return (int)cudaSuccess;
  int gshift = 0;
  while (gshift < 5 && (1 << gshift) < fanout) ++gshift;
  // a warp takes (32 >> gshift) * min(kPasses, 1 << gshift) slots at a time
  const int64_t spw = (32 >> gshift) * (gshift < 2 ? 1 << gshift : kPasses);
  csr_draw_kernel<Off><<<lt_grid((F + spw - 1) / spw * 32), kThreads, 0,
                         (cudaStream_t)stream>>>(
      frontier, F, fanout, row_map, sub_indptr, sub_indices, indptr, indices,
      num_nodes, keys, out, served, device_only, gshift);
  return (int)cudaGetLastError();
}

// row_map may be null (no cache: every slot draws from the full CSR).
// With device_only = 1 (row_map given) indptr and indices are not read and
// may be null; served [F] may be null.
LT_EXPORT int lt_csr_draw_i32(const int32_t* frontier, int64_t F,
                              int32_t fanout, const int32_t* row_map,
                              const int64_t* sub_indptr,
                              const int32_t* sub_indices,
                              const int32_t* indptr, const int32_t* indices,
                              int64_t num_nodes, const uint32_t* keys,
                              int32_t* out, uint8_t* served, int device_only,
                              void* stream) {
  return launch<int32_t>(frontier, F, fanout, row_map, sub_indptr,
                         sub_indices, indptr, indices, num_nodes, keys, out,
                         served, device_only, stream);
}

LT_EXPORT int lt_csr_draw_i64(const int32_t* frontier, int64_t F,
                              int32_t fanout, const int32_t* row_map,
                              const int64_t* sub_indptr,
                              const int32_t* sub_indices,
                              const int64_t* indptr, const int32_t* indices,
                              int64_t num_nodes, const uint32_t* keys,
                              int32_t* out, uint8_t* served, int device_only,
                              void* stream) {
  return launch<int64_t>(frontier, F, fanout, row_map, sub_indptr,
                         sub_indices, indptr, indices, num_nodes, keys, out,
                         served, device_only, stream);
}
