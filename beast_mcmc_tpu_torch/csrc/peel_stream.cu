// Streaming Felsenstein peel for Hopper (sm_90a), for trees whose branch
// matrices do not fit in shared memory.
//
// Replaces beast_mcmc_tpu/ops/pallas_stream2.py::_deep_kernel. Same function
// as the resident peel (peel_resident.cu): per pattern, post-order products
// of child partials through the branch matrices, rescaled per node by the
// max over (category, state), log-scales summed, root reduction with the
// category-weighted frequencies.
//
// What bounds it on this card: bytes are the tips read once and the site
// log-likelihoods written once (~105 MB of tips at the Makona shape in f64),
// operations ~1 GFLOP; the bound is tens of microseconds. As in the resident
// kernel the per-pattern node chain is a dependent sequence of loads, so the
// kernel is latency-bound; at 1,609 internal nodes the partials scratch
// (~422 MB in f64) no longer stays in the 50 MB L2 either.
//
// What the design does about it: the wrapper gathers the branch matrices in
// peel order ([n_int, 2, C, S, S], left then right child, as the TPU kernel's
// pm_flat), so a block reads them as one contiguous stream. The block copies
// CHUNK nodes' matrices at a time into shared memory with cp.async, double
// buffered: chunk k+1 is in flight while chunk k is peeled. Partials are
// indexed by peel position ([n_int, C, S, P], patterns innermost, coalesced);
// a child with a negative position is a tip. The TPU kernel's DMA lookahead
// ring has no counterpart: each thread reads only partials it wrote itself.

#include <cuda_runtime.h>

#include "peel_common.cuh"

namespace {

using peel::PX;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int S>
__global__ void peel_stream_kernel(const T* __restrict__ tips,      // [N,S,P]
                                   const T* __restrict__ pm_ord,    // [n_int,2,C,S,S]
                                   const int* __restrict__ lr_ids,  // [n_int,2]
                                   const int* __restrict__ lr_pos,  // [n_int,2]
                                   const T* __restrict__ wcs,       // [C,S]
                                   T* __restrict__ scratch,         // [n_int,C,S,P]
                                   T* __restrict__ out,             // [P]
                                   int n_int, int c_n, int p_n, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int node_elems = 2 * c_n * S * S;
  const int chunk_elems = chunk * node_elems;
  T* buf = reinterpret_cast<T*>(smem_raw);  // [2][chunk][2][C][S][S]
  T* red = buf + 2 * (size_t)chunk_elems;   // [2][C][PX]

  const int tx = threadIdx.x, cc = threadIdx.y;
  const int tid = cc * PX + tx, nthreads = PX * c_n;
  const int n_chunks = (n_int + chunk - 1) / chunk;

  // all threads copy 16-byte pieces of one chunk's matrices into one slot
  auto fetch = [&](int ch) {
    const int nodes = min(chunk, n_int - ch * chunk);
    const char* src = reinterpret_cast<const char*>(
        pm_ord + (size_t)ch * chunk_elems);
    char* dst = reinterpret_cast<char*>(buf + (ch & 1) * (size_t)chunk_elems);
    const int nvec = nodes * node_elems * (int)sizeof(T) / 16;
    for (int v = tid; v < nvec; v += nthreads) cp_async16(dst + 16 * v, src + 16 * v);
    cp_async_commit();
  };

  const int p_raw = blockIdx.x * PX + tx;
  const bool valid = p_raw < p_n;
  const int p = valid ? p_raw : p_n - 1;  // ragged edge: recompute, never store
  const size_t slab = (size_t)S * p_n;

  T acc = T(0);
  T x[S];
  fetch(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      fetch(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* pb = buf + (ch & 1) * (size_t)chunk_elems;
    const int nodes = min(chunk, n_int - ch * chunk);
    for (int k = 0; k < nodes; ++k) {
      const int i = ch * chunk + k;
      const int pos_l = lr_pos[2 * i], pos_r = lr_pos[2 * i + 1];
      const T* src_l = pos_l < 0 ? tips + (size_t)lr_ids[2 * i] * slab
                                 : scratch + ((size_t)pos_l * c_n + cc) * slab;
      const T* src_r = pos_r < 0 ? tips + (size_t)lr_ids[2 * i + 1] * slab
                                 : scratch + ((size_t)pos_r * c_n + cc) * slab;
      T vl[S], vr[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        vl[j] = src_l[(size_t)j * p_n + p];
        vr[j] = src_r[(size_t)j * p_n + p];
      }
      const T* pl = pb + ((size_t)(2 * k) * c_n + cc) * S * S;
      const T* pr = pb + ((size_t)(2 * k + 1) * c_n + cc) * S * S;
      const T mx = peel::node_product<T, S>(pl, pr, vl, vr, x);
      acc += peel::dlog(peel::rescale<T, S>(red + (i & 1) * c_n * PX, mx, x, c_n));
      if (valid) {
        T* dst = scratch + ((size_t)i * c_n + cc) * slab;
#pragma unroll
        for (int s = 0; s < S; ++s) dst[(size_t)s * p_n + p] = x[s];
      }
    }
    __syncthreads();  // slot (ch & 1) is refilled by the next iteration's fetch
  }
  // x now holds the root's rescaled partials (the peel order ends at it)
  peel::root_reduce<T, S>(red + (n_int & 1) * c_n * PX, x, wcs, acc, out, p,
                          valid, c_n);
}

template <typename T>
int launch(const void* tips, const void* pm_ord, const void* lr_ids,
           const void* lr_pos, const void* wcs, void* scratch, void* out,
           int n_int, int c_n, int s_n, int p_n, int chunk, void* stream) {
  if (s_n != 4 || c_n < 1 || c_n * PX > 1024 || n_int < 1 || p_n < 1 ||
      chunk < 1 || (2 * c_n * s_n * s_n * (int)sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int S = 4;
  auto kern = peel_stream_kernel<T, S>;
  const size_t smem =
      (2 * (size_t)chunk * 2 * c_n * S * S + 2 * (size_t)c_n * PX) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(PX, c_n);
  dim3 grid((p_n + PX - 1) / PX);
  kern<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)tips, (const T*)pm_ord, (const int*)lr_ids, (const int*)lr_pos,
      (const T*)wcs, (T*)scratch, (T*)out, n_int, c_n, p_n, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int peel_stream_f64(const void* tips, const void* pm_ord,
                               const void* lr_ids, const void* lr_pos,
                               const void* wcs, void* scratch, void* out,
                               int n_int, int c_n, int s_n, int p_n, int chunk,
                               void* stream) {
  return launch<double>(tips, pm_ord, lr_ids, lr_pos, wcs, scratch, out, n_int,
                        c_n, s_n, p_n, chunk, stream);
}

extern "C" int peel_stream_f32(const void* tips, const void* pm_ord,
                               const void* lr_ids, const void* lr_pos,
                               const void* wcs, void* scratch, void* out,
                               int n_int, int c_n, int s_n, int p_n, int chunk,
                               void* stream) {
  return launch<float>(tips, pm_ord, lr_ids, lr_pos, wcs, scratch, out, n_int,
                       c_n, s_n, p_n, chunk, stream);
}
