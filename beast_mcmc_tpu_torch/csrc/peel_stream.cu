// Level-scheduled Felsenstein peel for Hopper (sm_90a), for S = 4 trees whose
// branch matrices do not fit in shared memory, all partitions of one tree in
// one launch.
//
// Replaces beast_mcmc_tpu/ops/pallas_stream2.py::_deep_kernel. Same function
// as the resident peel (peel_resident.cu), for each of K partitions: per
// pattern, post-order products of child partials through the branch
// matrices, rescaled per node by the max over (category, state) (1 where
// that max is 0), log-scales summed, root reduction with the
// category-weighted frequencies.
//
// What bounds it on this card. The bound proper is tens of microseconds:
// the tips read once (~105 MB at the Makona shape in f64) and ~1 GFLOP. What
// the kernel really pays for is the chain of dependent nodes: a node can
// start only when its children's partials are written. A walk of the nodes
// one after the other pays a dependent load and a block barrier for every
// node (1,609 at Makona). Beneath that, the partials scratch (422 MB in f64
// at Makona) is written once and read back once, and would go to device
// memory and back through the 50 MB L2; and every node costs each of its
// C x pw lanes a rescaling and a logarithm.
//
// What the design does about it.
// - Levels, not nodes. The wrapper sorts the internal nodes by depth from the
//   root, deepest first (ops/cuda_stream.py::level_schedule, on the device).
//   A node's children lie exactly one level deeper, so the nodes of a level
//   are independent. `level_start` [n_int + 1] holds each level's first
//   position; entries past the last level equal n_int, the sentinel at which
//   the kernel stops, so the host never learns the number of levels. A
//   coalescent tree of 1,610 taxa has 24-28 levels; a caterpillar has n_int.
// - Slots side by side. A slot is a group of pw x C lanes of one warp: pw
//   patterns by C categories, so the max over categories is a warp shuffle
//   within the group. A warp holds 32 / (pw C) slots; a block's slots take
//   the nodes of a level round robin. One barrier a level, which also makes
//   one level's partials, written to device memory, visible to the next.
// - Partials stay in device memory by peel position, tile-major:
//   [K, tiles, n_int, C, S, pw], so one node's partials for one block are
//   C x S x pw contiguous elements (1 KB at C = 4, pw = 8 in f64), read and
//   written in whole 128-byte lines. Keeping a tile's live partials in
//   shared memory would need two levels' nodes there, and a level of a
//   coalescent tree of Makona's size has up to ~200 nodes, 200 KB at pw = 8,
//   C = 4 in f64: more than a block keeps beside its matrices. The scratch is
//   read with ld.global.cg (L2, coherent across the barrier), never through
//   the non-coherent read-only path. Dropping a child's lines from L2 once
//   read (discard.global.L2), so that dead partials are never written back,
//   was measured and bought nothing in f64 (PERF.md section 7): what is left is
//   the latency of a slot's dependent loads, which more warps a block hide
//   (16 by default, chip_smoke.py --tiles).
// - Each slot keeps the log-scales of the nodes it peeled as a running
//   product in double, for both types (one logarithm where it nears the ends
//   of the exponent range, as in peel_mxu.cu); the block adds the slots'
//   sums once, at the end. The rescaling multiplies by one reciprocal.
// - Each slot copies its next node's matrices ([2, C, 4, 4], 1 KB at C = 4 in
//   f64) and schedule entries into its own shared-memory buffer with
//   cp.async, one node ahead, so copies of the next level's first nodes are
//   in flight across the barrier. A whole level's matrices (up to ~200 KB)
//   would not fit twice in shared memory, so the look-ahead is per slot.
// - The grid is (pattern tiles of pw, partitions, chains). Blocks never
//   share patterns, so no synchronisation crosses blocks. Ragged pattern
//   edges are clamped on load and never written to the output.
// - A chain batch is the grid's third axis: block (x, k, b) offsets to chain
//   b's matrices, schedule, `wcs`, scratch and output; the tips [K, N, 4, P]
//   are shared by every chain. Chains reach different trees, so each block
//   walks its own chain's levels to its own `level_start` sentinel. A single
//   tree is B = 1.

#include <cuda_runtime.h>

#include "peel_common.cuh"

namespace {

using peel::dlog;
using peel::over_categories;
using peel::take_scale;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The node a slot peels after node `i` of level `lvl` (updated in place): the
// next of its round robin in the same level, else its first in the first
// later level wide enough to give it one; -1 when there is none. i = -1
// asks for the slot's first node.
__device__ __forceinline__ int next_node(const int* __restrict__ ls, int n_int,
                                         int slot, int n_slots, int& lvl, int i) {
  if (i >= 0 && i + n_slots < __ldg(ls + lvl + 1)) return i + n_slots;
  for (++lvl;; ++lvl) {
    const int a = __ldg(ls + lvl);
    if (a >= n_int) return -1;
    if (a + slot < __ldg(ls + lvl + 1)) return a + slot;
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(1024)
    peel_levels_kernel(const T* __restrict__ tips,     // [K,N,S,P]
                       const T* __restrict__ pm_ord,   // [B,K,n_int,2,C,S,S]
                       const int* __restrict__ lr_ids, // [B,n_int,2]
                       const int* __restrict__ lr_pos, // [B,n_int,2]
                       const int* __restrict__ ls,     // [B,n_int+1]
                       const T* __restrict__ wcs,      // [B,K,C,S]
                       T* scratch,  // [B,K,tiles,n_int,C,S,pw]
                       T* __restrict__ out,            // [B,K,P]
                       int n_tips, int n_int, int c_n, int p_n, int pw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  {  // this block's chain: [K] slabs of it precede it
    const size_t b = blockIdx.z, kb = b * gridDim.y;
    pm_ord += kb * n_int * 2 * c_n * S * S;
    lr_ids += b * 2 * n_int;
    lr_pos += b * 2 * n_int;
    ls += b * (n_int + 1);
    wcs += kb * c_n * S;
    scratch += kb * gridDim.x * n_int * c_n * S * pw;
    out += kb * p_n;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gs = pw * c_n, groups = 32 / gs;
  const int g = lane / gs, r = lane - g * gs;
  const int cc = r / pw, q = r - cc * pw;
  const int n_slots = (blockDim.x >> 5) * groups;
  const int slot = warp * groups + g;
  const bool active = g < groups;
  const int base = g * gs;
  const unsigned gmask =
      gs == 32 ? 0xffffffffu : (((1u << gs) - 1u) << (base & 31));
  const int node_elems = 2 * c_n * S * S;
  T* mats = reinterpret_cast<T*>(smem_raw);  // [n_slots][2][node_elems]
  int* sched = reinterpret_cast<int*>(mats + (size_t)n_slots * 2 * node_elems);
  double* red = reinterpret_cast<double*>(sched + n_slots * 8);  // [slots][pw]

  const int k = blockIdx.y;
  const int p_raw = blockIdx.x * pw + q;
  const bool valid = p_raw < p_n;
  const int p = valid ? p_raw : p_n - 1;  // ragged edge: no output stored
  const size_t slab = (size_t)S * p_n;
  const T* tips_k = tips + (size_t)k * n_tips * slab;
  const int part_elems = c_n * S * pw;  // one node's partials in this tile
  T* scr_t = scratch + ((size_t)k * gridDim.x + blockIdx.x) * n_int * part_elems;
  const T* pm_k = pm_ord + (size_t)k * n_int * node_elems;

  // node i's matrices and its schedule row (ids, positions) into buffer b
  auto fetch = [&](int i, int b) {
    char* dst = reinterpret_cast<char*>(mats + ((size_t)slot * 2 + b) * node_elems);
    const char* src = reinterpret_cast<const char*>(pm_k + (size_t)i * node_elems);
    const int nvec = node_elems * (int)sizeof(T) / 16;
    for (int v = r; v < nvec; v += gs) cp_async16(dst + 16 * v, src + 16 * v);
    if (r == 0) {
      int* sd = sched + (slot * 2 + b) * 4;
      cp_async8(sd, lr_ids + 2 * i);
      cp_async8(sd + 2, lr_pos + 2 * i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto load_child = [&](T (&v)[S], int id, int pos) {
    if (pos < 0) {
      const T* src = tips_k + (size_t)id * slab + p;
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = __ldg(src + (size_t)s * p_n);
    } else {
      const T* src = scr_t + (size_t)pos * part_elems + cc * S * pw + q;
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = __ldcg(src + s * pw);
    }
  };

  T x[S];
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = T(0);
  double acc = 0.0, prod = 1.0;
  int cur_lvl = -1;
  int cur = active ? next_node(ls, n_int, slot, n_slots, cur_lvl, -1) : -1;
  int buf = 0;
  if (cur >= 0) fetch(cur, 0);

  for (int lvl = 0; __ldg(ls + lvl) < n_int; ++lvl) {
    while (cur >= 0 && cur_lvl == lvl) {
      int nxt_lvl = cur_lvl;
      const int nxt = next_node(ls, n_int, slot, n_slots, nxt_lvl, cur);
      if (nxt >= 0) {
        fetch(nxt, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp(gmask);
      const int* sd = sched + (slot * 2 + buf) * 4;
      T vl[S], vr[S];
      load_child(vl, sd[0], sd[2]);
      load_child(vr, sd[1], sd[3]);
      const T* pl = mats + ((size_t)slot * 2 + buf) * node_elems + cc * S * S;
      const T* pr = pl + c_n * S * S;
      T mx = peel::node_product<T, S>(pl, pr, vl, vr, x);
      mx = over_categories<T, true>(mx, gmask, base, q, pw, c_n, gs);
      const T scale = mx > T(0) ? mx : T(1);
      const T inv = T(1) / scale;
#pragma unroll
      for (int s = 0; s < S; ++s) x[s] *= inv;
      take_scale(acc, prod, (double)scale);
      T* dst = scr_t + (size_t)cur * part_elems + cc * S * pw + q;
#pragma unroll
      for (int s = 0; s < S; ++s) dst[s * pw] = x[s];
      __syncwarp(gmask);  // buffer `buf` is refilled for the node after next
      buf ^= 1;
      cur = nxt;
      cur_lvl = nxt_lvl;
    }
    __syncthreads();  // this level's partials are written before the next reads
  }

  if (active && cc == 0) red[slot * pw + q] = acc + log(prod);
  __syncthreads();
  // slot 0 took the last level's only node, the root: x holds its partials
  if (slot == 0 && active) {
    T part = T(0);
    const T* w = wcs + ((size_t)k * c_n + cc) * S;
#pragma unroll
    for (int s = 0; s < S; ++s) part += x[s] * __ldg(w + s);
    const T site = over_categories<T, false>(part, gmask, base, q, pw, c_n, gs);
    if (cc == 0 && valid) {
      double tot = 0.0;
      for (int j = 0; j < n_slots; ++j) tot += red[j * pw + q];
      out[(size_t)k * p_n + p] = (T)((double)dlog(site) + tot);
    }
  }
}

template <typename T>
int launch(const void* tips, const void* pm_ord, const void* lr_ids,
           const void* lr_pos, const void* level_start, const void* wcs,
           void* scratch, void* out, int n_tips, int n_int, int c_n, int s_n,
           int p_n, int k_n, int pw, int warps, int b_n, void* stream) {
  if (s_n != 4 || c_n < 1 || pw < 1 || (pw & (pw - 1)) != 0 || pw * c_n > 32 ||
      pw * c_n < 2 || warps < 1 || warps > 32 || n_int < 1 ||
      n_tips != n_int + 1 || p_n < 1 || k_n < 1 || k_n > 65535 || b_n < 1 ||
      b_n > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int S = 4;
  const int slots = warps * (32 / (pw * c_n));
  const size_t smem = (size_t)slots * 2 * 2 * c_n * S * S * sizeof(T) +
                      (size_t)slots * 8 * sizeof(int) +
                      (size_t)slots * pw * sizeof(double);
  auto kern = peel_levels_kernel<T, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p_n + pw - 1) / pw, k_n, b_n);
  kern<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const T*)tips, (const T*)pm_ord, (const int*)lr_ids, (const int*)lr_pos,
      (const int*)level_start, (const T*)wcs, (T*)scratch, (T*)out, n_tips,
      n_int, c_n, p_n, pw);
  return (int)cudaGetLastError();
}

}  // namespace

#define PEEL_STREAM_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* tips, const void* pm_ord,                  \
                      const void* lr_ids, const void* lr_pos,                \
                      const void* level_start, const void* wcs,              \
                      void* scratch, void* out, int n_tips, int n_int,       \
                      int c_n, int s_n, int p_n, int k_n, int pw, int warps, \
                      int b_n, void* stream) {                               \
    return launch<T>(tips, pm_ord, lr_ids, lr_pos, level_start, wcs,         \
                     scratch, out, n_tips, n_int, c_n, s_n, p_n, k_n, pw,    \
                     warps, b_n, stream);                                    \
  }

PEEL_STREAM_ENTRY(peel_stream_f64, double)
PEEL_STREAM_ENTRY(peel_stream_f32, float)
