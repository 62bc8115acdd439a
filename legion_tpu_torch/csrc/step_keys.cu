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
// With members (the clique's members on one card) JAX's device fold comes
// after the tag, step_d = fold_in(step, d), and out is [n, L, 4] for the n
// members first .. first + n - 1 of the world (a rank of a run across
// processes writes its own); with n 0 (one device) no device index is
// folded in, as before, and out is [L, 4].
// With drop given, the same launch writes each member's dropout key,
// fold_in(step_d, 7) (step_d = step without members; JAX's train step folds
// 7 into its key for dropout, legion_tpu/train.py:612), as two words (lo,
// hi) a member: [2], or [n, 2] with members. K16 (dropout.cu) folds a
// layer index into it.
//
// fold_in is common.cuh::lt_fold_in (sampling/access.py::fold_in, bit for
// bit). Every half is an explicit uint32 cast of the 64-bit value, never
// an arithmetic shift of a signed one.
//
// Bound on this card: the launch. The work is 8 dependent hashes a hop
// and 16 bytes a hop written; the card's time is an empty kernel's.
// Design: one block of 32 threads, thread t computes the (member, hop)
// rows t, t + 32, ...; every thread reads the counter before the barrier,
// and only then thread 0 writes it back incremented.
#include "common.cuh"

namespace {

constexpr uint64_t kDropoutTag = 7;

__global__ void __launch_bounds__(32) step_keys_kernel(
    const int64_t* __restrict__ base_key, int64_t* __restrict__ ctr,
    uint32_t tag, int32_t L, int32_t n_dev, int64_t first,
    uint32_t* __restrict__ out, uint32_t* __restrict__ drop) {
  const uint64_t base = (uint64_t)base_key[0];
  const uint64_t c = (uint64_t)ctr[0];
  LtKey k{(uint32_t)(base & 0xFFFFFFFFull), (uint32_t)(base >> 32)};
  k = lt_fold_in(lt_fold_in(k, c), (uint64_t)tag);
  const int rows = (n_dev > 0 ? n_dev : 1) * L;
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int d = t / L, h = t - d * L;
    const LtKey sk = n_dev > 0 ? lt_fold_in(k, (uint64_t)(first + d)) : k;
    const LtKey hk = lt_fold_in(sk, (uint64_t)h);
    const LtKey s0 = lt_fold_in(hk, 0), s1 = lt_fold_in(hk, 1);
    out[4 * t + 0] = s0.lo;
    out[4 * t + 1] = s0.hi;
    out[4 * t + 2] = s1.lo;
    out[4 * t + 3] = s1.hi;
  }
  const int members = n_dev > 0 ? n_dev : 1;
  for (int d = threadIdx.x; drop != nullptr && d < members;
       d += blockDim.x) {
    const LtKey sk = n_dev > 0 ? lt_fold_in(k, (uint64_t)(first + d)) : k;
    const LtKey dk = lt_fold_in(sk, kDropoutTag);
    drop[2 * d] = dk.lo;
    drop[2 * d + 1] = dk.hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) ctr[0] = (int64_t)(c + 1);
}

}  // namespace

// base_key and ctr: one int64 each on the card; out: [L, 4] uint32 when
// n_dev is 0, else [n_dev, L, 4], row d with the device index first + d
// folded in; drop: null, or [2] uint32 when n_dev is 0, else [n_dev, 2].
LT_EXPORT int lt_step_keys(const int64_t* base_key, int64_t* ctr,
                           uint32_t tag, int32_t L, int32_t n_dev,
                           int64_t first, uint32_t* out, uint32_t* drop,
                           void* stream) {
  if (L <= 0 || n_dev < 0 || first < 0) return (int)cudaErrorInvalidValue;
  step_keys_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      base_key, ctr, tag, L, n_dev, first, out, drop);
  return (int)cudaGetLastError();
}
