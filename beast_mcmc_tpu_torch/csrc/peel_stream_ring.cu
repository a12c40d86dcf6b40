// v1 streaming Felsenstein peel for Hopper (sm_90a): any state count, and the
// partials returned.
//
// Replaces beast_mcmc_tpu/ops/pallas_stream.py::_stream_kernel. Per pattern,
// for each internal node in peel order: x = (P_l . child_l) * (P_r . child_r)
// over every (category, state), scale = max of x over (category, state) (1
// where that is 0), post = x / scale, acc += log(scale). Two outputs: the
// per-pattern log-likelihood log(sum wcs * post_root) + acc, and post_pos
// [n_int, C, S, P], the rescaled partials of every node by peel position
// (the gradient's residuals). 2 <= S <= 64, 1 <= C <= 8, float or double.
//
// What bounds it on this card: the bytes are the tips and matrices read once
// and post_pos written once; at S = 4 the peel is a dependent chain of tiny
// products, so a node costs a round of barriers and shared-memory latency,
// not bandwidth or arithmetic, and the kernel is latency-bound far above its
// byte bound. At S >= 16 a node is 4*C*S*S FMAs per pattern fed from shared
// memory, and the shared-memory load rate of the FMA loop bounds it.
//
// What the design does about it:
//  - A block is BP patterns x R row threads. The C*S output rows of a node
//    are split over the row threads in groups of TR rows of one category; a
//    thread accumulates its TR rows over the child's S states, reading each
//    child value once for TR rows. The matrix entry is a shared-memory
//    broadcast, the child values of neighbouring patterns are neighbours.
//  - The threads of a block share a child's [C, S, BP] partials in shared
//    memory. A three-slot ring holds the node being written and the last two
//    nodes, so a parent at position i+1 or i+2 never goes to device memory
//    (the TPU kernel's prev_buf ring). Other children, and tips, are copied
//    into a two-slot staging buffer by cp.async one node ahead (the TPU
//    kernel's one-step double buffering), while the current node is computed.
//    post_pos is read back by threads other than the writer: every such read
//    starts at least one __syncthreads() after the write.
//  - The peel-ordered matrices [n_int, 2, C, S, S] are one linear stream.
//    They arrive by cp.async in two slots: `chunk` whole nodes per slot, or,
//    where one node's matrices exceed a slot (chunk == 0), one child's one
//    category ([S, S]) at a time, the node then being computed in 2*C steps.
//  - The ragged last tile recomputes pattern P-1 in its idle lanes and never
//    stores them. Offsets into post_pos are size_t.
// Copies are element-wise (4 or 8 bytes), so no pattern count or state count
// needs padding for alignment.

#include <cuda_runtime.h>

#include "peel_common.cuh"

namespace {

constexpr int TR = 4;                  // rows a thread accumulates at a time
constexpr int MAX_THREADS = 512;       // of one block
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may take on sm_90

using peel::cp_async_commit;
using peel::cp_async_elem;
using peel::cp_async_wait_all;

// acc[r] = sum_j m[ro[r] + j] * ch[j * bp], j in index order, for the TR
// rows at offsets ro[] of one [S, S] matrix and one child column.
template <typename T>
__device__ __forceinline__ void matvec_rows(const T* __restrict__ m,
                                            const int (&ro)[TR],
                                            const T* __restrict__ ch, int s_n,
                                            int bp, T (&acc)[TR]) {
#pragma unroll
  for (int r = 0; r < TR; ++r) acc[r] = T(0);
#pragma unroll 4
  for (int j = 0; j < s_n; ++j) {
    const T v = ch[j * bp];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r] = fma(m[ro[r] + j], v, acc[r]);
  }
}

template <typename T, bool PIECES>
__global__ void __launch_bounds__(MAX_THREADS) peel_stream_ring_kernel(
    const T* __restrict__ tips,      // [N,S,P]
    const T* __restrict__ pm_ord,    // [n_int,2,C,S,S]
    const int* __restrict__ lr_ids,  // [n_int,2]
    const int* __restrict__ lr_pos,  // [n_int,2], -1 for a tip
    const T* __restrict__ wcs,       // [C,S]
    T* post,                         // [n_int,C,S,P], written and read back
    T* __restrict__ out,             // [P]
    int n_int, int c_n, int s_n, int p_n, int bp_log2, int r_n, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bp = 1 << bp_log2;
  const int cs = c_n * s_n;
  const int slab = cs << bp_log2;  // one node's tile [C*S, BP]
  const int ss = s_n * s_n;
  const int node_elems = 2 * c_n * ss;
  const int unit_elems = PIECES ? ss : chunk * node_elems;
  const size_t total_elems = (size_t)n_int * node_elems;

  T* ring = reinterpret_cast<T*>(smem_raw);  // [3][C*S][BP]
  T* stage = ring + 3 * (size_t)slab;        // [2][2][C*S][BP]
  T* mat = stage + 4 * (size_t)slab;         // [2][unit_elems]
  T* red = mat + 2 * (size_t)unit_elems;     // [R][BP]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tx = tid & (bp - 1), ty = tid >> bp_log2;
  const int p0 = blockIdx.x << bp_log2;
  const bool valid = p0 + tx < p_n;
  const int gs = (s_n + TR - 1) / TR;  // row groups per category

  // unit u of the matrix stream into slot u & 1
  auto fetch_mat = [&](size_t u) {
    const size_t start = u * unit_elems;
    if (start >= total_elems) return;
    const size_t left = total_elems - start;
    const int n = left < (size_t)unit_elems ? (int)left : unit_elems;
    const T* src = pm_ord + start;
    T* dst = mat + (u & 1) * (size_t)unit_elems;
    for (int e = tid; e < n; e += nthreads) cp_async_elem(dst + e, src + e);
  };

  // the children of node t that the ring will not hold, into stage[t & 1].
  // Started at step t - 1, so it reads no node later than t - 3.
  auto fetch_children = [&](int t) {
    for (int k = 0; k < 2; ++k) {
      const int pos = lr_pos[2 * t + k];
      const T* src;
      int rows;
      if (pos < 0) {
        src = tips + (size_t)lr_ids[2 * t + k] * s_n * p_n;
        rows = s_n;
      } else if (pos < t - 2) {
        src = post + (size_t)pos * cs * p_n;
        rows = cs;
      } else {
        continue;
      }
      T* dst = stage + ((t & 1) * 2 + k) * (size_t)slab;
      const int n = rows << bp_log2;
      for (int e = tid; e < n; e += nthreads) {
        const int p = min(p0 + (e & (bp - 1)), p_n - 1);
        cp_async_elem(dst + e, src + (size_t)(e >> bp_log2) * p_n + p);
      }
    }
  };

  // child k of node i at this thread's pattern: [S] values bp apart, the
  // categories cstride apart (0 for a tip)
  auto child = [&](int i, int k, int& cstride) -> const T* {
    const int pos = lr_pos[2 * i + k];
    cstride = pos < 0 ? 0 : s_n << bp_log2;
    if (pos < 0 || pos < i - 2)  // a tip, or a node the ring let go
      return stage + ((i & 1) * 2 + k) * (size_t)slab + tx;
    return ring + (pos % 3) * (size_t)slab + tx;
  };

  const int nq = PIECES ? 2 * c_n : 1;  // steps a node is computed in
  T acc = T(0);
  fetch_mat(0);
  fetch_children(0);
  cp_async_commit();

  for (int i = 0; i < n_int; ++i) {
    T* cur = ring + (i % 3) * (size_t)slab;
    T mx = T(0);
    for (int q = 0; q < nq; ++q) {
      // what was fetched during the last step has landed, and every thread
      // is done with the slots the next fetch overwrites
      cp_async_wait_all();
      __syncthreads();
      if constexpr (PIECES) {
        fetch_mat((size_t)i * nq + q + 1);
      } else {
        if (i % chunk == 0) fetch_mat((size_t)(i / chunk) + 1);
      }
      if (q == 0 && i + 1 < n_int) fetch_children(i + 1);
      cp_async_commit();

      T a[TR];
      int ro[TR];
      if constexpr (PIECES) {
        const int k = q / c_n, c = q - k * c_n;
        const T* m = mat + ((size_t)(i * nq + q) & 1) * unit_elems;
        int cst;
        const T* ch = child(i, k, cst);
        ch += c * cst;
        for (int g = ty; g < gs; g += r_n) {
          const int s0 = g * TR;
#pragma unroll
          for (int r = 0; r < TR; ++r) ro[r] = min(s0 + r, s_n - 1) * s_n;
          matvec_rows<T>(m, ro, ch, s_n, bp, a);
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            if (s0 + r < s_n) {
              T* d = cur + ((c * s_n + s0 + r) << bp_log2) + tx;
              if (k == 0) {
                *d = a[r];
              } else {
                const T x = *d * a[r];
                *d = x;
                mx = peel::dmax(mx, x);
              }
            }
          }
        }
      } else {
        T b[TR];
        const T* m = mat + ((i / chunk) & 1) * (size_t)unit_elems +
                     (size_t)(i % chunk) * node_elems;
        int cst_l, cst_r;
        const T* ch_l = child(i, 0, cst_l);
        const T* ch_r = child(i, 1, cst_r);
        for (int g = ty; g < c_n * gs; g += r_n) {
          const int c = g / gs, s0 = (g - c * gs) * TR;
#pragma unroll
          for (int r = 0; r < TR; ++r) ro[r] = min(s0 + r, s_n - 1) * s_n;
          matvec_rows<T>(m + c * ss, ro, ch_l + c * cst_l, s_n, bp, a);
          matvec_rows<T>(m + (c_n + c) * ss, ro, ch_r + c * cst_r, s_n, bp, b);
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            if (s0 + r < s_n) {
              const T x = a[r] * b[r];
              cur[((c * s_n + s0 + r) << bp_log2) + tx] = x;
              mx = peel::dmax(mx, x);
            }
          }
        }
      }
    }
    // per-pattern max over every row, then rescale the node's tile in place
    red[(ty << bp_log2) + tx] = mx;
    __syncthreads();
    T scale = red[tx];
    for (int t = 1; t < r_n; ++t) scale = peel::dmax(scale, red[(t << bp_log2) + tx]);
    if (!(scale > T(0))) scale = T(1);
    acc += peel::dlog(scale);
    T* dst = post + (size_t)i * cs * p_n + p0 + tx;
    for (int row = ty; row < cs; row += r_n) {
      const T v = cur[(row << bp_log2) + tx] / scale;
      cur[(row << bp_log2) + tx] = v;
      if (valid) dst[(size_t)row * p_n] = v;
    }
  }

  // root: site = sum over rows of wcs * post_root; the peel ends at the root
  __syncthreads();
  const T* root = ring + ((n_int - 1) % 3) * (size_t)slab;
  T part = T(0);
  for (int row = ty; row < cs; row += r_n) part += root[(row << bp_log2) + tx] * wcs[row];
  red[(ty << bp_log2) + tx] = part;
  __syncthreads();
  if (ty == 0 && valid) {
    T site = red[tx];
    for (int t = 1; t < r_n; ++t) site += red[(t << bp_log2) + tx];
    out[p0 + tx] = peel::dlog(site) + acc;
  }
}

template <typename T, bool PIECES>
int launch_mode(const void* tips, const void* pm_ord, const void* lr_ids,
                const void* lr_pos, const void* wcs, void* post, void* out,
                int n_int, int c_n, int s_n, int p_n, int bp_log2, int r_n,
                int chunk, size_t smem, void* stream) {
  auto kern = peel_stream_ring_kernel<T, PIECES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bp = 1 << bp_log2;
  kern<<<(p_n + bp - 1) / bp, r_n * bp, smem, (cudaStream_t)stream>>>(
      (const T*)tips, (const T*)pm_ord, (const int*)lr_ids, (const int*)lr_pos,
      (const T*)wcs, (T*)post, (T*)out, n_int, c_n, s_n, p_n, bp_log2, r_n,
      chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* tips, const void* pm_ord, const void* lr_ids,
           const void* lr_pos, const void* wcs, void* post, void* out,
           int n_int, int c_n, int s_n, int p_n, int bp, int r_n, int chunk,
           void* stream) {
  int bp_log2 = 0;
  while ((1 << bp_log2) < bp) ++bp_log2;
  if (s_n < 2 || s_n > 64 || c_n < 1 || c_n > 8 || n_int < 1 || p_n < 1 ||
      bp < 1 || bp > 32 || (1 << bp_log2) != bp || r_n < 1 ||
      r_n * bp > MAX_THREADS || chunk < 0)
    return (int)cudaErrorInvalidValue;
  const size_t unit = chunk ? (size_t)chunk * 2 * c_n * s_n * s_n
                            : (size_t)s_n * s_n;
  const size_t smem =
      (7 * (size_t)c_n * s_n * bp + 2 * unit + (size_t)r_n * bp) * sizeof(T);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  return chunk ? launch_mode<T, false>(tips, pm_ord, lr_ids, lr_pos, wcs, post,
                                       out, n_int, c_n, s_n, p_n, bp_log2, r_n,
                                       chunk, smem, stream)
               : launch_mode<T, true>(tips, pm_ord, lr_ids, lr_pos, wcs, post,
                                      out, n_int, c_n, s_n, p_n, bp_log2, r_n,
                                      chunk, smem, stream);
}

}  // namespace

extern "C" int peel_stream_ring_f64(const void* tips, const void* pm_ord,
                                    const void* lr_ids, const void* lr_pos,
                                    const void* wcs, void* post, void* out,
                                    int n_int, int c_n, int s_n, int p_n, int bp,
                                    int r_n, int chunk, void* stream) {
  return launch<double>(tips, pm_ord, lr_ids, lr_pos, wcs, post, out, n_int,
                        c_n, s_n, p_n, bp, r_n, chunk, stream);
}

extern "C" int peel_stream_ring_f32(const void* tips, const void* pm_ord,
                                    const void* lr_ids, const void* lr_pos,
                                    const void* wcs, void* post, void* out,
                                    int n_int, int c_n, int s_n, int p_n, int bp,
                                    int r_n, int chunk, void* stream) {
  return launch<float>(tips, pm_ord, lr_ids, lr_pos, wcs, post, out, n_int,
                       c_n, s_n, p_n, bp, r_n, chunk, stream);
}
