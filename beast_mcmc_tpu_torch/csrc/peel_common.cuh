// Shared pieces of the two Felsenstein peel kernels (peel_resident.cu,
// peel_stream.cu).
//
// Thread layout of both: a block is PX patterns x C categories
// (threadIdx.x = pattern in the tile, threadIdx.y = category), one thread
// per (pattern, category). Patterns are independent, so blocks never talk
// to each other. Every thread walks the internal nodes in peel order and
// keeps its log-scale accumulator in a register. A child's partials for
// (category, pattern) are written and read back by the same thread, so the
// partials scratch in device memory needs no synchronisation; only the
// per-pattern max over categories goes through shared memory.
#pragma once

#include <cuda_runtime.h>

namespace peel {

constexpr int PX = 32;  // patterns per block: one warp per category row

__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float dlog(float a) { return logf(a); }
__device__ __forceinline__ double dlog(double a) { return log(a); }

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

// Per-pattern rescale: scale = max over (category, state), 1 where that max
// is 0; x /= scale. `red` is one parity half of the [2][C][PX] buffer: the
// two halves alternate node by node, so one barrier per node suffices.
template <typename T, int S>
__device__ __forceinline__ T rescale(T* red, T mx, T (&x)[S], int c_n) {
  const int tx = threadIdx.x, cc = threadIdx.y;
  red[cc * PX + tx] = mx;
  __syncthreads();
  T scale = red[tx];
  for (int k = 1; k < c_n; ++k) scale = dmax(scale, red[k * PX + tx]);
  if (!(scale > T(0))) scale = T(1);
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = x[s] / scale;
  return scale;
}

// Root: site_lik = sum_c sum_s wcs[c,s] * post_root[c,s]; out = log + acc.
template <typename T, int S>
__device__ __forceinline__ void root_reduce(T* red, const T (&x)[S],
                                            const T* __restrict__ wcs, T acc,
                                            T* __restrict__ out, int p,
                                            bool valid, int c_n) {
  const int tx = threadIdx.x, cc = threadIdx.y;
  T part = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) part += x[s] * wcs[cc * S + s];
  red[cc * PX + tx] = part;
  __syncthreads();
  if (cc == 0 && valid) {
    T site = red[tx];
    for (int k = 1; k < c_n; ++k) site += red[k * PX + tx];
    out[p] = dlog(site) + acc;
  }
}

}  // namespace peel
