// K17 segment_max: out[s, f] = max(initial, max of data[e, f] over the
// lanes e with seg[e] == s), and its gradient; lanes with seg[e] < 0 or
// >= S are dropped. data is [E, F] f32, bf16 or int32 (the backward f32
// or bf16), out [S, F] of the same type.
//
// Replaces legion_tpu/ops/segment.py::masked_segment_max (:54-64), an XLA
// scatter-max, and its gradient under jax.grad, XLA's scatter-max JVP
// (jax/_src/lax/slicing.py::_scatter_extremal_jvp) transposed. On no path
// of the JAX package or of the port: the port's ops package carries it
// because the JAX package's does.
//
// Forward, one C call: a memset of a [S, F] uint32 key buffer, then a
// lane pass that atomicMax-es each valid element's order-preserving key
// (segment_keys.cuh: float max is unsigned max of keys; every NaN is the
// top key, -0 ranks below +0) into its segment's row, then a decode pass
// that writes max(key, key(initial)) back in data's type. Max does not
// depend on the order of the atomics, so the result is the same bits at
// every run: bit for bit against ops/segment.py::segment_max_plain, a
// NaN's bits (the canonical NaN) and a zero's sign included.
//
// Backward, one C call, JAX's rule: the gradient of out[s, f] is split
// equally among the lanes equal to it (float equality: -0 == +0, a NaN
// equals nothing), and initial counts as one more such lane where it
// equals out[s, f]. A memset of a [S, F] int32 count, a count pass
// (atomicAdd of 1 a tied lane), and a pass that writes each lane's
// g[s, f] * (1 / n) (JAX's product, in f32; in bf16 n, 1 / n and the
// product each rounded to bf16, as JAX computes them in bf16) and +0 for
// a lane that is not tied or not valid.
//
// Bound on this card: device-memory bytes (data and ids read, out
// written; backward also g and out read), but the lane pass's atomics
// resolve in the L2 one a word, and a row that many lanes share takes
// them one after the other. A thread takes one element of a lane, the
// threads of a lane neighbours, so a warp's loads are contiguous and its
// atomics fall in the sectors of one row. A simple kernel: the op runs on
// no path.
#include <cuda_bf16.h>

#include "segment_keys.cuh"

namespace {

template <int TYPE>
__global__ void __launch_bounds__(kThreads)
    segment_keys_kernel(const typename SegT<TYPE>::T* __restrict__ data,
                        const int32_t* __restrict__ seg,
                        uint32_t* __restrict__ keys, int64_t E, int F,
                        int64_t S, int tshift) {
  const int c0 = threadIdx.x & ((1 << tshift) - 1);
  const int64_t lpb = kThreads >> tshift;  // lanes of a block at a time
  for (int64_t e = blockIdx.x * lpb + (threadIdx.x >> tshift); e < E;
       e += gridDim.x * lpb) {
    const int32_t s = seg[e];
    if (s < 0 || s >= S) continue;
    for (int c = c0; c < F; c += 1 << tshift)
      atomicMax(keys + (int64_t)s * F + c,
                SegT<TYPE>::key(__ldcs(data + e * F + c)));
  }
}

template <int TYPE>
__global__ void __launch_bounds__(kThreads)
    segment_decode_kernel(const uint32_t* __restrict__ keys,
                          typename SegT<TYPE>::T* __restrict__ out, int64_t n,
                          uint32_t init_key) {
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads)
    out[i] = SegT<TYPE>::unkey(max(keys[i], init_key));
}

template <int TYPE>
__global__ void __launch_bounds__(kThreads)
    segment_ties_kernel(const typename SegT<TYPE>::T* __restrict__ data,
                        const int32_t* __restrict__ seg,
                        const typename SegT<TYPE>::T* __restrict__ out,
                        int32_t* __restrict__ cnt, int64_t E, int F,
                        int64_t S, int tshift) {
  const int c0 = threadIdx.x & ((1 << tshift) - 1);
  const int64_t lpb = kThreads >> tshift;
  for (int64_t e = blockIdx.x * lpb + (threadIdx.x >> tshift); e < E;
       e += gridDim.x * lpb) {
    const int32_t s = seg[e];
    if (s < 0 || s >= S) continue;
    for (int c = c0; c < F; c += 1 << tshift)
      if (SegT<TYPE>::val(data[e * F + c]) ==
          SegT<TYPE>::val(out[(int64_t)s * F + c]))
        atomicAdd(cnt + (int64_t)s * F + c, 1);
  }
}

// JAX's coefficient 1 / n of a tied lane, and g times it, in the type's
// arithmetic.
template <int TYPE>
__device__ __forceinline__ float tied_grad(float g, int n);

template <>
__device__ __forceinline__ float tied_grad<kSegF32>(float g, int n) {
  return __fmul_rn(g, __fdiv_rn(1.0f, (float)n));
}

template <>
__device__ __forceinline__ float tied_grad<kSegBF16>(float g, int n) {
  const float nb = SegT<kSegBF16>::val(lt_bf16_rn((float)n));
  const float r = SegT<kSegBF16>::val(lt_bf16_rn(__fdiv_rn(1.0f, nb)));
  return __fmul_rn(g, r);  // exact: two 8-bit significands
}

template <int TYPE>
__global__ void __launch_bounds__(kThreads)
    segment_max_grad_kernel(const typename SegT<TYPE>::T* __restrict__ data,
                            const int32_t* __restrict__ seg,
                            const typename SegT<TYPE>::T* __restrict__ out,
                            const typename SegT<TYPE>::T* __restrict__ g,
                            const int32_t* __restrict__ cnt, float init,
                            typename SegT<TYPE>::T* __restrict__ dx,
                            int64_t E, int F, int64_t S, int tshift) {
  const int c0 = threadIdx.x & ((1 << tshift) - 1);
  const int64_t lpb = kThreads >> tshift;
  for (int64_t e = blockIdx.x * lpb + (threadIdx.x >> tshift); e < E;
       e += gridDim.x * lpb) {
    const int32_t s = seg[e];
    const bool valid = s >= 0 && s < S;
    for (int c = c0; c < F; c += 1 << tshift) {
      float r = 0.0f;
      if (valid) {
        const int64_t o = (int64_t)s * F + c;
        const float m = SegT<TYPE>::val(out[o]);
        if (SegT<TYPE>::val(data[e * F + c]) == m)
          r = tied_grad<TYPE>(SegT<TYPE>::val(g[o]),
                              cnt[o] + (init == m ? 1 : 0));
      }
      dx[e * F + c] = SegT<TYPE>::store(r);
    }
  }
}

template <int TYPE>
int keys_pass(const void* data, const int32_t* seg, int64_t E, int64_t F,
              int64_t S, uint32_t* keys, cudaStream_t stream) {
  const int tshift = lt_seg_tshift(F);
  segment_keys_kernel<TYPE><<<lt_grid(E << tshift), kThreads, 0, stream>>>(
      static_cast<const typename SegT<TYPE>::T*>(data), seg, keys, E, (int)F,
      S, tshift);
  return (int)cudaGetLastError();
}

template <int TYPE>
int forward(const void* data, const int32_t* seg, int64_t E, int64_t F,
            int64_t S, uint32_t init_key, uint32_t* keys, void* out,
            cudaStream_t stream) {
  int rc = lt_segment_keys(data, TYPE, seg, E, F, S, keys, stream);
  if (rc != 0) return rc;
  segment_decode_kernel<TYPE><<<lt_grid(S * F), kThreads, 0, stream>>>(
      keys, static_cast<typename SegT<TYPE>::T*>(out), S * F, init_key);
  return (int)cudaGetLastError();
}

template <int TYPE>
int backward(const void* data, const int32_t* seg, const void* out,
             const void* g, float init, int64_t E, int64_t F, int64_t S,
             int32_t* cnt, void* dx, cudaStream_t stream) {
  using T = typename SegT<TYPE>::T;
  const int tshift = lt_seg_tshift(F);
  int rc = (int)cudaMemsetAsync(cnt, 0, S * F * sizeof(int32_t), stream);
  if (rc != 0) return rc;
  segment_ties_kernel<TYPE><<<lt_grid(E << tshift), kThreads, 0, stream>>>(
      static_cast<const T*>(data), seg, static_cast<const T*>(out), cnt, E,
      (int)F, S, tshift);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  segment_max_grad_kernel<TYPE>
      <<<lt_grid(E << tshift), kThreads, 0, stream>>>(
          static_cast<const T*>(data), seg, static_cast<const T*>(out),
          static_cast<const T*>(g), cnt, init, static_cast<T*>(dx), E,
          (int)F, S, tshift);
  return (int)cudaGetLastError();
}

bool bad_shape(int64_t E, int64_t F, int64_t S) {
  return E < 0 || F < 0 || S < 0 || F > 2147483647LL ||
         S > 2147483647LL;
}

}  // namespace

int lt_segment_keys(const void* data, int type, const int32_t* seg,
                    int64_t E, int64_t F, int64_t S, uint32_t* keys,
                    cudaStream_t stream) {
  int rc = (int)cudaMemsetAsync(keys, 0, S * F * sizeof(uint32_t), stream);
  if (rc != 0 || E == 0) return rc;
  switch (type) {
    case kSegF32:
      return keys_pass<kSegF32>(data, seg, E, F, S, keys, stream);
    case kSegBF16:
      return keys_pass<kSegBF16>(data, seg, E, F, S, keys, stream);
    case kSegI32:
      return keys_pass<kSegI32>(data, seg, E, F, S, keys, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// data [E, F] of ``type``, seg [E] int32, keys a [S, F] uint32 scratch,
// out [S, F] of ``type``; init_key the key of initial in data's type.
LT_EXPORT int lt_segment_max_fwd(const void* data, int type,
                                 const int32_t* seg, int64_t E, int64_t F,
                                 int64_t S, uint32_t init_key, uint32_t* keys,
                                 void* out, void* stream) {
  if (bad_shape(E, F, S)) return (int)cudaErrorInvalidValue;
  if (S * F == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (type) {
    case kSegF32:
      return forward<kSegF32>(data, seg, E, F, S, init_key, keys, out, st);
    case kSegBF16:
      return forward<kSegBF16>(data, seg, E, F, S, init_key, keys, out, st);
    case kSegI32:
      return forward<kSegI32>(data, seg, E, F, S, init_key, keys, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

// data [E, F], out and g [S, F], dx [E, F], all f32 or all bf16; cnt a
// [S, F] int32 scratch; init initial in data's type, widened.
LT_EXPORT int lt_segment_max_bwd(const void* data, int type,
                                 const int32_t* seg, const void* out,
                                 const void* g, float init, int64_t E,
                                 int64_t F, int64_t S, int32_t* cnt, void* dx,
                                 void* stream) {
  if (bad_shape(E, F, S)) return (int)cudaErrorInvalidValue;
  if (E * F == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (type) {
    case kSegF32:
      return backward<kSegF32>(data, seg, out, g, init, E, F, S, cnt, dx, st);
    case kSegBF16:
      return backward<kSegBF16>(data, seg, out, g, init, E, F, S, cnt, dx,
                                st);
  }
  return (int)cudaErrorInvalidValue;
}
