// Resident Felsenstein peel for Hopper (sm_90a).
//
// Replaces beast_mcmc_tpu/ops/pallas_peeling.py::_peel_kernel: the
// post-order peel of one tree, per pattern: for each internal node in peel
// order and each category, x = (P_l . post_l) * (P_r . post_r); scale = max
// over (category, state), 1 where that max is 0; post = x / scale; log(scale)
// is added to an accumulator. At the root, log sum_c sum_s w_c pi_s post
// plus the accumulator is the site log-likelihood.
//
// What bounds it on this card: the bytes are the tips read once
// (N*S*P*itemsize) and the site log-likelihoods written once; the operations
// are ~2*C*S*S*2 FMAs per node and pattern. At the benchmark2 shape that is
// ~11 MB and ~0.1 GFLOP (f64), a bound of a few microseconds. The node loop
// is a dependent chain per pattern, so the kernel is latency-bound long
// before either limit: each node waits on its children's partials.
//
// What the design does about it: all branch matrices [M,C,S,S] are staged
// in shared memory once per block (63 KB at benchmark2 in f64), so the
// matvec operands are shared-memory broadcasts; patterns go on the grid,
// one thread per (pattern, category), so the card holds 4x more independent
// chains than one thread per pattern; partials live in a device-memory
// scratch [n_int, C, S, P] with patterns innermost, so every load and store
// of a warp is one coalesced 32-pattern row. The TPU kernel's VMEM-resident
// partials tensor has no counterpart: a Hopper block has 227 KB of shared
// memory, not 6 MB of VMEM.

#include <cuda_runtime.h>

#include "peel_common.cuh"

namespace {

using peel::PX;

template <typename T, int S>
__global__ void peel_resident_kernel(const T* __restrict__ tips,     // [N,S,P]
                                     const T* __restrict__ pmats,    // [M,C,S,S]
                                     const int* __restrict__ children,  // [M,2]
                                     const int* __restrict__ order,  // [N-1]
                                     const T* __restrict__ wcs,      // [C,S]
                                     T* __restrict__ scratch,        // [N-1,C,S,P]
                                     T* __restrict__ out,            // [P]
                                     int n_tips, int m, int c_n, int p_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pm_s = reinterpret_cast<T*>(smem_raw);
  T* red = pm_s + (size_t)m * c_n * S * S;  // [2][C][PX]

  const int tx = threadIdx.x, cc = threadIdx.y;
  const int tid = cc * PX + tx, nthreads = PX * c_n;
  const int total = m * c_n * S * S;
  for (int i = tid; i < total; i += nthreads) pm_s[i] = pmats[i];
  __syncthreads();

  const int p_raw = blockIdx.x * PX + tx;
  const bool valid = p_raw < p_n;
  const int p = valid ? p_raw : p_n - 1;  // ragged edge: recompute, never store
  const int n_int = n_tips - 1;
  const size_t slab = (size_t)S * p_n;

  T acc = T(0);
  T x[S];
  for (int i = 0; i < n_int; ++i) {
    const int node = order[i];
    const int l = children[2 * node], r = children[2 * node + 1];
    const T* src_l = l < n_tips ? tips + l * slab
                                : scratch + ((size_t)(l - n_tips) * c_n + cc) * slab;
    const T* src_r = r < n_tips ? tips + r * slab
                                : scratch + ((size_t)(r - n_tips) * c_n + cc) * slab;
    T vl[S], vr[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      vl[j] = src_l[(size_t)j * p_n + p];
      vr[j] = src_r[(size_t)j * p_n + p];
    }
    const T* pl = pm_s + ((size_t)l * c_n + cc) * S * S;
    const T* pr = pm_s + ((size_t)r * c_n + cc) * S * S;
    const T mx = peel::node_product<T, S>(pl, pr, vl, vr, x);
    acc += peel::dlog(peel::rescale<T, S>(red + (i & 1) * c_n * PX, mx, x, c_n));
    if (valid) {
      T* dst = scratch + ((size_t)(node - n_tips) * c_n + cc) * slab;
#pragma unroll
      for (int s = 0; s < S; ++s) dst[(size_t)s * p_n + p] = x[s];
    }
  }
  // x now holds the root's rescaled partials (the peel order ends at it)
  peel::root_reduce<T, S>(red + (n_int & 1) * c_n * PX, x, wcs, acc, out, p,
                          valid, c_n);
}

template <typename T>
int launch(const void* tips, const void* pmats, const void* children,
           const void* order, const void* wcs, void* scratch, void* out,
           int n_tips, int m, int c_n, int s_n, int p_n, void* stream) {
  if (s_n != 4 || c_n < 1 || c_n * PX > 1024 || n_tips < 2 || p_n < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int S = 4;
  auto kern = peel_resident_kernel<T, S>;
  const size_t smem = ((size_t)m * c_n * S * S + 2 * (size_t)c_n * PX) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(PX, c_n);
  dim3 grid((p_n + PX - 1) / PX);
  kern<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)tips, (const T*)pmats, (const int*)children, (const int*)order,
      (const T*)wcs, (T*)scratch, (T*)out, n_tips, m, c_n, p_n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int peel_resident_f64(const void* tips, const void* pmats,
                                 const void* children, const void* order,
                                 const void* wcs, void* scratch, void* out,
                                 int n_tips, int m, int c_n, int s_n, int p_n,
                                 void* stream) {
  return launch<double>(tips, pmats, children, order, wcs, scratch, out,
                        n_tips, m, c_n, s_n, p_n, stream);
}

extern "C" int peel_resident_f32(const void* tips, const void* pmats,
                                 const void* children, const void* order,
                                 const void* wcs, void* scratch, void* out,
                                 int n_tips, int m, int c_n, int s_n, int p_n,
                                 void* stream) {
  return launch<float>(tips, pmats, children, order, wcs, scratch, out,
                       n_tips, m, c_n, s_n, p_n, stream);
}
