// Shared pieces of the Felsenstein peel kernels. peel_stream_ring.cu takes
// only dmax, dlog and the element-wise cp.async helpers; peel_mxu.cu takes
// dmax, dlog and take_scale; node_product and over_categories serve the two
// S = 4 kernels (peel_resident.cu, peel_stream.cu), which walk the tree by
// levels in the same way and differ only in where the branch matrices come
// from.
//
// The level walk of those two: a slot is pw patterns x C categories of one
// warp (lane = category * pw + pattern), so the max over categories is a
// warp shuffle within the slot; a block's slots take the nodes of a level
// round robin, one barrier a level.
#pragma once

#include <cuda_runtime.h>

namespace peel {

__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float dlog(float a) { return logf(a); }
__device__ __forceinline__ double dlog(double a) { return log(a); }

// One element (4 or 8 bytes) from device to shared memory, asynchronously:
// no pattern or state count needs padding for alignment.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(static_cast<int>(sizeof(T)))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x[s] = (Pl . vl)[s] * (Pr . vr)[s]; the j-sum runs in index order, like
// the TPU kernels' broadcast matvec. Returns max_s x[s] (>= 0).
template <typename T, int S>
__device__ __forceinline__ T node_product(const T* __restrict__ pl,
                                          const T* __restrict__ pr,
                                          const T (&vl)[S], const T (&vr)[S],
                                          T (&x)[S]) {
  T mx = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T a = pl[s * S] * vl[0];
    T b = pr[s * S] * vr[0];
#pragma unroll
    for (int j = 1; j < S; ++j) {
      a = fma(pl[s * S + j], vl[j], a);
      b = fma(pr[s * S + j], vr[j], b);
    }
    x[s] = a * b;
    mx = dmax(mx, x[s]);
  }
  return mx;
}

// The log-scale sum as a running product, in double for either type: prod
// takes the scales while it and they stay far from the ends of the exponent
// range, and goes into acc as one logarithm when they do not. A logarithm a
// node is on every node's critical path; a multiplication is not.
__device__ __forceinline__ void take_scale(double& acc, double& prod, double s) {
  constexpr double tiny = 1e-150, big = 1e150;
  if (prod > tiny && prod < big && s > tiny && s < big) {
    prod *= s;
  } else {
    acc += log(prod) + log(s);
    prod = 1.0;
  }
}

// Sum (or max) over the C category lanes of one pattern within a slot of
// gs = pw * C lanes starting at lane `base`; q is the lane's pattern.
template <typename T, bool kMax>
__device__ __forceinline__ T over_categories(T v, unsigned gmask, int base,
                                             int q, int pw, int c_n, int gs) {
  if (c_n == 1) return v;
  if ((c_n & (c_n - 1)) == 0) {  // lanes differ in the bits pw .. gs/2
    for (int off = pw; off < gs; off <<= 1) {
      const T o = __shfl_xor_sync(gmask, v, off);
      v = kMax ? dmax(v, o) : v + o;
    }
    return v;
  }
  T acc = __shfl_sync(gmask, v, base + q);
  for (int c = 1; c < c_n; ++c) {
    const T o = __shfl_sync(gmask, v, base + c * pw + q);
    acc = kMax ? dmax(acc, o) : acc + o;
  }
  return acc;
}

}  // namespace peel
