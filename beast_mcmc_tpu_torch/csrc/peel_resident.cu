// Resident Felsenstein peel for Hopper (sm_90a), S = 4, by levels.
//
// Replaces beast_mcmc_tpu/ops/pallas_peeling.py::_peel_kernel: the
// post-order peel of one tree, per pattern: for each internal node and each
// category, x = (P_l . post_l) * (P_r . post_r); scale = max over (category,
// state), 1 where that max is 0; post = x / scale; log(scale) is added to an
// accumulator. At the root, log sum_c sum_s w_c pi_s post plus the
// accumulator is the site log-likelihood.
//
// What bounds it on this card. The bytes are the tips read once
// (N*S*P*itemsize) and the site log-likelihoods written once; the
// operations are ~2*C*S*S*2 FMAs per node and pattern. At the benchmark2
// shape that is ~11 MB and ~0.1 GFLOP (f64), a bound of a few microseconds.
// What the kernel really pays for is the chain of dependent nodes: a node
// can start only once its children's partials are written. Walking the 61
// internal nodes of benchmark2 one after the other paid a dependent load
// from device memory, a barrier, four divisions and a logarithm on every
// node.
//
// What the design does about it.
// - Levels, not nodes. The wrapper sorts the internal nodes by depth from
//   the root, deepest first (ops/cuda_stream.py::level_schedule, on the
//   device, the deep kernel's schedule). A child lies exactly one level
//   deeper than its parent, so the nodes of a level are independent; a
//   coalescent tree of 62 taxa has 9-15 levels. `level_start` [n_int + 1]
//   holds each level's first position, n_int past the last, where the
//   kernel stops: the host never learns the number of levels.
// - Slots side by side, as in peel_stream.cu. A slot is pw patterns x C
//   categories of one warp, so the max over categories is a warp shuffle
//   (peel_common.cuh, over_categories). A block holds `tiles` pattern tiles
//   of pw patterns, each with the same number of slots; the slots of a tile
//   take the nodes of a level round robin. One barrier a level.
// - Resident: every branch matrix [M, C, 4, 4] is staged in shared memory
//   once per block (63 KB at benchmark2 in f64), 16 bytes a thread, and no
//   node copies matrices. The schedule rows are prefetched into L1 during
//   the stage.
// - Partials go to a device-memory scratch by peel position, tile-major:
//   [tiles, n_int, S, C, pw], one node's partials of one tile contiguous,
//   the C lanes of a slot on consecutive words. A child is read with
//   ld.global.cg (L2, coherent across the barrier), never through the
//   non-coherent read-only path. Keeping them in shared memory instead (an
//   eighth of the matrices' bytes a pattern column, so they fit) keeps a
//   level on the SM but leaves room for one block an SM, against three
//   with the scratch; built both ways and timed in turns on an NVIDIA H100
//   80GB HBM3 at 700 W during bring-up, the scratch was the faster at
//   benchmark2 in f64, and so it stays.
// - Each slot keeps the log-scales of its nodes as a running product in
//   double (take_scale); the slots of a tile add their sums once, at the
//   end. The rescaling multiplies by one reciprocal a pattern.
// - Ragged pattern edges are clamped on load and never stored.
// - A chain batch is the grid's second axis: block (x, b) peels pattern
//   block x of chain b, whose matrices [B, M, C, 4, 4], schedule, `wcs`
//   [B, C, 4], scratch and output [B, P] it offsets to; the tips [N, 4, P]
//   are shared by every chain, read through one pointer. Chains reach
//   different trees, so each block stops at its own chain's `level_start`
//   sentinel. A single tree is B = 1. Shared memory is that of one chain.

#include <cuda_runtime.h>

#include "peel_common.cuh"

namespace {

using peel::dlog;
using peel::over_categories;
using peel::take_scale;

template <typename T, int S>
__global__ void __launch_bounds__(1024)
    peel_resident_kernel(const T* __restrict__ tips,      // [N,S,P]
                         const T* __restrict__ pmats,     // [B,M,C,S,S]
                         const int* __restrict__ lr_ids,  // [B,n_int,2]
                         const int* __restrict__ lr_pos,  // [B,n_int,2]
                         const int* __restrict__ ls,      // [B,n_int+1]
                         const T* __restrict__ wcs,       // [B,C,S]
                         T* scratch,  // [B,tiles_total,n_int,S,C,pw]
                         T* __restrict__ out,             // [B,P]
                         int n_tips, int m, int c_n, int p_n, int pw,
                         int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_int = n_tips - 1;
  {  // this block's chain
    const size_t b = blockIdx.y;
    pmats += b * m * c_n * S * S;
    lr_ids += b * 2 * n_int;
    lr_pos += b * 2 * n_int;
    ls += b * (n_int + 1);
    wcs += b * c_n * S;
    scratch += b * gridDim.x * tiles * n_int * S * c_n * pw;
    out += b * p_n;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gs = pw * c_n, groups = 32 / gs;
  const int g = lane / gs, r = lane - g * gs;
  const int cc = r / pw, q = r - cc * pw;
  const int n_slots = (blockDim.x >> 5) * groups;
  const int slot = warp * groups + g;
  const bool active = g < groups;
  const int spt = n_slots / tiles;  // slots of one pattern tile
  const int t = slot / spt, sub = slot - t * spt;
  const int base = g * gs;
  const unsigned gmask =
      gs == 32 ? 0xffffffffu : (((1u << gs) - 1u) << (base & 31));
  const int part_elems = S * c_n * pw;  // one node's partials in one tile
  T* pm_s = reinterpret_cast<T*>(smem_raw);  // [M,C,S,S]
  double* red = reinterpret_cast<double*>(pm_s + (size_t)m * c_n * S * S);  // [slots][pw]

  // the stage: 16 bytes a thread (M*C*S*S*itemsize is a multiple of 16);
  // the schedule's lines into L1 meanwhile
  {
    const int4* src = reinterpret_cast<const int4*>(pmats);
    int4* dst = reinterpret_cast<int4*>(pm_s);
    const int nvec = (int)((size_t)m * c_n * S * S * sizeof(T) / 16);
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) dst[v] = __ldg(src + v);
    for (int e = 32 * threadIdx.x; e < 2 * n_int; e += 32 * blockDim.x) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(lr_ids + e));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(lr_pos + e));
    }
    for (int e = 32 * threadIdx.x; e <= n_int; e += 32 * blockDim.x)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(ls + e));
  }
  __syncthreads();

  const int p_raw = (blockIdx.x * tiles + t) * pw + q;
  const bool valid = p_raw < p_n;
  const int p = valid ? p_raw : p_n - 1;  // ragged edge: no output stored
  const size_t slab = (size_t)S * p_n;
  // this lane's element of a node's partials in its tile: states apart by
  // C*pw, so the lanes of a slot read consecutive words
  T* part_t =
      scratch + ((size_t)blockIdx.x * tiles + t) * n_int * part_elems + cc * pw + q;

  auto load_child = [&](T (&v)[S], int id, int pos) {
    if (pos < 0) {
      const T* src = tips + (size_t)id * slab + p;
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = __ldg(src + (size_t)s * p_n);
    } else {
      const T* src = part_t + (size_t)pos * part_elems;
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = __ldcg(src + s * c_n * pw);
    }
  };

  T x[S];
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = T(0);
  double acc = 0.0, prod = 1.0;
  for (int lvl = 0;; ++lvl) {
    const int a = __ldg(ls + lvl);
    if (a >= n_int) break;
    const int b = __ldg(ls + lvl + 1);
    for (int i = a + sub; active && i < b; i += spt) {
      const int2 ids = __ldg(reinterpret_cast<const int2*>(lr_ids) + i);
      const int2 pos = __ldg(reinterpret_cast<const int2*>(lr_pos) + i);
      T vl[S], vr[S];
      load_child(vl, ids.x, pos.x);
      load_child(vr, ids.y, pos.y);
      const T* pl = pm_s + ((size_t)ids.x * c_n + cc) * S * S;
      const T* pr = pm_s + ((size_t)ids.y * c_n + cc) * S * S;
      T mx = peel::node_product<T, S>(pl, pr, vl, vr, x);
      mx = over_categories<T, true>(mx, gmask, base, q, pw, c_n, gs);
      const T scale = mx > T(0) ? mx : T(1);
      const T inv = T(1) / scale;
#pragma unroll
      for (int s = 0; s < S; ++s) x[s] *= inv;
      take_scale(acc, prod, (double)scale);
      T* dst = part_t + (size_t)i * part_elems;
#pragma unroll
      for (int s = 0; s < S; ++s) dst[s * c_n * pw] = x[s];
    }
    __syncthreads();  // this level's partials are written before the next reads
  }

  if (active && cc == 0) red[slot * pw + q] = acc + log(prod);
  __syncthreads();
  // slot 0 of each tile took the last level's only node, the root: x holds
  // its partials
  if (active && sub == 0) {
    T part = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) part += x[s] * __ldg(wcs + cc * S + s);
    const T site = over_categories<T, false>(part, gmask, base, q, pw, c_n, gs);
    if (cc == 0 && valid) {
      double tot = 0.0;
      for (int j = 0; j < spt; ++j) tot += red[(t * spt + j) * pw + q];
      out[p] = (T)((double)dlog(site) + tot);
    }
  }
}

template <typename T>
int launch(const void* tips, const void* pmats, const void* lr_ids,
           const void* lr_pos, const void* level_start, const void* wcs,
           void* scratch, void* out, int n_tips, int m, int c_n, int s_n,
           int p_n, int pw, int warps, int tiles, int b_n, void* stream) {
  const int gs = pw * c_n;
  if (s_n != 4 || c_n < 1 || pw < 1 || (pw & (pw - 1)) != 0 || gs > 32 ||
      warps < 1 || warps > 32 || tiles < 1 || (warps * (32 / gs)) % tiles != 0 ||
      n_tips < 2 || m != 2 * n_tips - 1 || p_n < 1 || b_n < 1 || b_n > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int S = 4;
  const int slots = warps * (32 / gs);
  const size_t smem = (size_t)m * c_n * S * S * sizeof(T) +
                      (size_t)slots * pw * sizeof(double);
  auto kern = peel_resident_kernel<T, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (p_n + pw - 1) / pw;
  dim3 grid((n_tiles + tiles - 1) / tiles, b_n);
  kern<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const T*)tips, (const T*)pmats, (const int*)lr_ids, (const int*)lr_pos,
      (const int*)level_start, (const T*)wcs, (T*)scratch, (T*)out, n_tips, m,
      c_n, p_n, pw, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

#define PEEL_RESIDENT_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* tips, const void* pmats, const void* lr_ids, \
                      const void* lr_pos, const void* level_start,            \
                      const void* wcs, void* scratch, void* out, int n_tips,  \
                      int m, int c_n, int s_n, int p_n, int pw, int warps,    \
                      int tiles, int b_n, void* stream) {                     \
    return launch<T>(tips, pmats, lr_ids, lr_pos, level_start, wcs, scratch,  \
                     out, n_tips, m, c_n, s_n, p_n, pw, warps, tiles, b_n,    \
                     stream);                                                 \
  }

PEEL_RESIDENT_ENTRY(peel_resident_f64, double)
PEEL_RESIDENT_ENTRY(peel_resident_f32, float)
