// Shared pieces of the Felsenstein peel kernels: dmax, dlog, the
// element-wise cp.async helpers and take_scale for all; node_product for the
// S = 4 kernels (peel_resident.cu, peel_stream.cu), over_categories for them
// and the S < 16 slots of peel_stream_ring.cu; the bulk copies, named
// barriers and 8 x 8 tile products of the S >= 16 kernels (peel_mxu.cu and
// the S >= 16 teams of peel_stream_ring.cu).
//
// The level walk of the slots: a slot is pw patterns x C categories of one
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

// The S >= 16 products of peel_mxu.cu and peel_stream_ring.cu: matrices
// handed to the bulk copy engine with an mbarrier, teams of warps on named
// barriers, and 8 x 8 output tiles (8 rows of one [S, S] matrix by TILE_W
// patterns) on the FP64 tensor cores, or by FMA in float.
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_W = 8;  // patterns of an output tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The bulk copy engine (TMA): `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device to shared memory, counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` of the mbarrier has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// leading dimension >= n that is 4 mod 8 (n is a multiple of 4)
__host__ __device__ inline int pad_ld(int n) { return n + ((4 - n) & 7); }

__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// One 8 x 8 tile of A [8, 4*ksteps] . X [4*ksteps, 8]: a_tile is the first of
// the 8 rows (leading dimension lda), x_tile the first of the 8 columns
// (leading dimension TILE_W). The thread gets out[lane / 4][2 * (lane % 4) + i]
// in y_i, the accumulator layout of mma.m8n8k4.
__device__ __forceinline__ void tile_product(const double* __restrict__ a_tile, int lda,
                                             const double* __restrict__ x_tile, int ksteps,
                                             int lane, double& y0, double& y1) {
  const double* a = a_tile + (lane >> 2) * lda + (lane & 3);
  const double* b = x_tile + (lane & 3) * TILE_W + (lane >> 2);
  constexpr int step = 4 * TILE_W;
  double e0 = 0.0, e1 = 0.0;
  y0 = 0.0;
  y1 = 0.0;
  int ks = 0;
  for (; ks + 1 < ksteps; ks += 2) {
    mma_f64(y0, y1, a[4 * ks], b[ks * step]);
    mma_f64(e0, e1, a[4 * ks + 4], b[(ks + 1) * step]);
  }
  if (ks < ksteps) mma_f64(y0, y1, a[4 * ks], b[ks * step]);
  y0 += e0;
  y1 += e1;
}

__device__ __forceinline__ void tile_product(const float* __restrict__ a_tile, int lda,
                                             const float* __restrict__ x_tile, int ksteps,
                                             int lane, float& y0, float& y1) {
  const float4* a = reinterpret_cast<const float4*>(a_tile + (lane >> 2) * lda);
  const float* b = x_tile + 2 * (lane & 3);
  y0 = 0.f;
  y1 = 0.f;
  for (int ks = 0; ks < ksteps; ++ks) {
    const float4 av = a[ks];
    const float* bk = b + 4 * ks * TILE_W;
    const float2 b0 = *reinterpret_cast<const float2*>(bk);
    const float2 b1 = *reinterpret_cast<const float2*>(bk + TILE_W);
    const float2 b2 = *reinterpret_cast<const float2*>(bk + 2 * TILE_W);
    const float2 b3 = *reinterpret_cast<const float2*>(bk + 3 * TILE_W);
    y0 = fmaf(av.x, b0.x, y0);
    y1 = fmaf(av.x, b0.y, y1);
    y0 = fmaf(av.y, b1.x, y0);
    y1 = fmaf(av.y, b1.y, y1);
    y0 = fmaf(av.z, b2.x, y0);
    y1 = fmaf(av.z, b2.y, y1);
    y0 = fmaf(av.w, b3.x, y0);
    y1 = fmaf(av.w, b3.y, y1);
  }
}

// over the 8 rows of a tile: the lanes with the same lane % 4
template <typename T>
__device__ __forceinline__ T rows_max(T v) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) v = dmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
template <typename T>
__device__ __forceinline__ T rows_sum(T v) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// the warps of one team (named barrier `id`, 1..15)
__device__ __forceinline__ void team_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

}  // namespace peel
