// K10 step_keys: a step's random keys, derived on the card from device
// counters.
//
// Replaces legion_tpu/train.py::Trainer._device_key (:526-533), which XLA
// compiled into the step on the TPU, together with the sampler's per-hop
// fold (legion_tpu/sampling/sampler.py: hop k draws with fold_in(key, k)).
// One launch reads the int64 base key and the int64 step counter, and
//   step = fold_in(fold_in(base_key, ctr), tag)   (tag 0 train, 1 eval)
//   out[k] = draw_keys(fold_in(step, k))          for every hop k < L
// where draw_keys(h) = (lo, hi) of fold_in(h, 0) ++ (lo, hi) of
// fold_in(h, 1): the four 32-bit words K3 reads (K5 reads the first two).
// Then it adds one to the counter. The step's keys are thus a pure
// function of (base_key, ctr, tag), written where K3 and K5 read them,
// with no host word in the launch: a captured step replays with new keys.
// JAX also folds in the device index; on one card there is none.
//
// fold_in is sampling/access.py::fold_in, bit for bit: a 64-bit key is
// (lo, hi) 32-bit halves, data its low and high 32 bits,
//   lo' = hash32(lo ^ hash32(data_lo ^ 0x9E3779B9))
//   hi' = hash32(hi ^ hash32(lo' ^ data_hi)).
// Every half is an explicit uint32 cast of the 64-bit value, never an
// arithmetic shift of a signed one.
//
// Bound on this card: the launch. The work is 8 dependent hashes a hop
// and 16 bytes a hop written; the card's time is an empty kernel's.
// Design: one block of 32 threads, thread k computes hop k (a loop for
// L > 32); every thread reads the counter before the barrier, and only
// then thread 0 writes it back incremented.
#include "common.cuh"

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;

struct Key {
  uint32_t lo, hi;
};

__device__ __forceinline__ Key fold_in(Key k, uint64_t data) {
  Key r;
  r.lo = lt_hash32(k.lo ^ lt_hash32((uint32_t)(data & 0xFFFFFFFFull) ^
                                    kGolden));
  r.hi = lt_hash32(k.hi ^ lt_hash32(r.lo ^ (uint32_t)(data >> 32)));
  return r;
}

__global__ void __launch_bounds__(32) step_keys_kernel(
    const int64_t* __restrict__ base_key, int64_t* __restrict__ ctr,
    uint32_t tag, int32_t L, uint32_t* __restrict__ out) {
  const uint64_t base = (uint64_t)base_key[0];
  const uint64_t c = (uint64_t)ctr[0];
  Key k{(uint32_t)(base & 0xFFFFFFFFull), (uint32_t)(base >> 32)};
  k = fold_in(fold_in(k, c), (uint64_t)tag);
  for (int h = threadIdx.x; h < L; h += blockDim.x) {
    const Key hk = fold_in(k, (uint64_t)h);
    const Key s0 = fold_in(hk, 0), s1 = fold_in(hk, 1);
    out[4 * h + 0] = s0.lo;
    out[4 * h + 1] = s0.hi;
    out[4 * h + 2] = s1.lo;
    out[4 * h + 3] = s1.hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) ctr[0] = (int64_t)(c + 1);
}

}  // namespace

// base_key and ctr: one int64 each on the card; out: [L, 4] uint32.
LT_EXPORT int lt_step_keys(const int64_t* base_key, int64_t* ctr,
                           uint32_t tag, int32_t L, uint32_t* out,
                           void* stream) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  step_keys_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(base_key, ctr, tag, L,
                                                      out);
  return (int)cudaGetLastError();
}
