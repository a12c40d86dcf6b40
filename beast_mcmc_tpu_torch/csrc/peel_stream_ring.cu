// v1 streaming Felsenstein peel for Hopper (sm_90a), by levels: any state
// count 2 <= S <= 64, up to 8 rate categories, the partials returned, B
// chains' trees in one launch.
//
// Replaces beast_mcmc_tpu/ops/pallas_stream.py::_stream_kernel. Per pattern,
// for each internal node: x = (P_l . child_l) * (P_r . child_r) over every
// (category, state), scale = max of x over (category, state) (1 where that
// is 0), post = x / scale, acc += log(scale); at the root
// log(sum wcs * post_root) + acc. Two outputs: the per-pattern
// log-likelihood [B, P] and every internal node's rescaled partials by level
// position (the gradient's residuals; ops/cuda_stream2.py::deep_positions
// reads the tile-major layout). Float or double.
//
// What bounds it on this card. The bytes are the tips and the branch
// matrices read once and the partials written once (at 1,441 taxa x 4
// categories x 61 states x 593 patterns in f64: 417 MB, 343 MB and 1.67 GB,
// 0.73 ms at 3.35 TB/s); the operations 4*C*S*S a node and pattern (5.2e10
// there, 0.77 ms on the FP64 tensor cores). What a peel really pays for is
// the chain of dependent nodes: a node starts only when its children's
// partials are written. Walking the nodes one after the other, as this
// kernel's first design did, paid a round of barriers and copy waits for
// every node (1,440 at 1,441 taxa) on a grid of pattern tiles alone, about
// half the SMs at 593 patterns. At S >= 16 the other cost is the matrices:
// every block of patterns needs every node's matrices (238 KB a node there),
// so they stream from L2 once a block.
//
// What the design does about it.
//  - Levels, not nodes (as peel_stream.cu and peel_mxu.cu). The wrapper sorts
//    the internal nodes by depth from the root, deepest first
//    (ops/cuda_stream.py::level_schedule, on the device): `lr_ids` are each
//    position's children, `lr_pos` their positions (-1 for a tip),
//    `level_start` each level's first position, n_int past the last, where
//    a block stops: the host never learns the number of levels. The nodes of
//    a level are independent; they go side by side across the block, one
//    block barrier a level. A coalescent tree of 1,441 taxa has ~25 levels.
//  - Partials in device memory by level position, tile-major: [B, tiles,
//    n_int, C, S, pw], so one node's partials for one block are C x S x pw
//    contiguous elements, written in whole lines and read back after the
//    level barrier through L2 (ld.global.cg or cp.async.cg), never through
//    the non-coherent read-only path. They are the second output.
//  - S < 16: slots on the CUDA cores. A slot is pw patterns x C categories of
//    lanes of one warp (the max over categories a warp shuffle); a lane holds
//    its category's S partials of one pattern in registers and computes the
//    node's 2*S*S products by FMA from its slot's shared-memory copy of the
//    node's matrices, copied by cp.async one node ahead (16 bytes a thread
//    where the [C, S, S] blocks allow, else element-wise). The register
//    arrays are sized at compile time: exactly S = 2, 4 and 8, and 8 or 16
//    with the rows past S skipped for the other S.
//  - S >= 16: teams of warps on the tensor cores, as peel_mxu.cu. A block is
//    8 patterns; its teams take a level's nodes round robin, each in its own
//    shared-memory slot behind its own named barrier; a node is 2*C products
//    [S, S] x [S, 8] as 8 x 8 output tiles, in double a chain of
//    mma.sync.m8n8k4 (FP64 tensor cores), in float FMA (single-pass TF32
//    would lose precision). The wrapper pads the matrices to [mp, lda] with
//    zeros, so that one thread of the team hands each [S, S] piece to the
//    bulk copy engine (TMA) with an mbarrier. A team's slot holds two
//    buffers of g pieces, taken in turns by its steps: the pieces of the
//    next step (the next node's first, across the level barrier) are in
//    flight while the team computes the current one, one named barrier a
//    step. Single-buffered, a team waited for every step's copy and a
//    GY94+Gamma4 launch took twice as long with one team as with two
//    (chip_smoke.py --tiles). g is a whole node (2C) where two buffers fit
//    beside a second team, else one category's pair, else one piece. The
//    children's [C, S, 8] tiles come by cp.async, 16 bytes a thread from the
//    tile-major partials, element-wise and clamped from the tips. The block
//    of 8 patterns is peel_mxu.cu's: it found 16 slower at its shapes.
//  - The schedule is read from device memory, not staged in shared memory
//    (any tree size fits): each slot or team loads its next node's row into
//    registers while it computes the current one (the S < 16 slots two
//    nodes ahead, since the copy of the next node's matrices needs it).
//  - Log-scales as a running product in double, for both types (one
//    logarithm where it nears the ends of the exponent range); the block adds
//    its slots' or teams' sums once, at the end; the rescaling multiplies by
//    one reciprocal.
//  - The grid is (pattern tiles, chains): block (x, b) offsets to chain b's
//    matrices, schedule, `wcs`, partials and output; the tips [N, S, P] are
//    shared. Each block stops at its own chain's sentinel. A single tree is
//    B = 1. Blocks never share patterns; the ragged last tile recomputes
//    pattern P-1 in its idle lanes, whose partials land in the tile's padding
//    and whose log-likelihood is never stored.

#include <cuda_runtime.h>

#include "peel_common.cuh"

namespace {

using peel::bulk_copy;
using peel::cp_async_commit;
using peel::cp_async_elem;
using peel::cp_async_wait_all;
using peel::mbar_expect;
using peel::mbar_wait;
using peel::over_categories;
using peel::pad_ld;
using peel::rows_max;
using peel::rows_sum;
using peel::smem_addr;
using peel::take_scale;
using peel::team_sync;
using peel::tile_product;

constexpr int MAX_THREADS = 512;       // of one block
constexpr int MMA_MIN_STATES = 16;     // from here the teams' tile products
constexpr int W = peel::TILE_W;        // patterns of a block, S >= 16
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may take on sm_90

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one node's schedule row: its children (x, y) by id and by position
__device__ __forceinline__ int4 sched_row(const int* __restrict__ lr_ids,
                                          const int* __restrict__ lr_pos, int i) {
  const int2 ids = __ldg(reinterpret_cast<const int2*>(lr_ids) + i);
  const int2 pos = __ldg(reinterpret_cast<const int2*>(lr_pos) + i);
  return make_int4(ids.x, ids.y, pos.x, pos.y);
}

// The node that worker `w` of `n_w` (a slot or a team) peels after position
// i of level `lvl` (updated in place): the next of its round robin in the
// same level, else its first in the first later level wide enough to give it
// one; -1 when there is none. i = -1 asks for the worker's first node.
__device__ __forceinline__ int next_node(const int* __restrict__ ls, int n_int, int w,
                                         int n_w, int& lvl, int i) {
  if (i >= 0 && i + n_w < __ldg(ls + lvl + 1)) return i + n_w;
  for (++lvl;; ++lvl) {
    const int a = __ldg(ls + lvl);
    if (a >= n_int) return -1;
    if (a + w < __ldg(ls + lvl + 1)) return a + w;
  }
}

// elements of one child's [C, S, S] matrices in a slot buffer, rounded up to
// 16 bytes
template <typename T>
__host__ __device__ inline int slot_elems(int c_n, int s_n) {
  const int per16 = 16 / (int)sizeof(T);
  return (c_n * s_n * s_n + per16 - 1) / per16 * per16;
}

// ---- S < 16: slots of pw patterns x C categories on the CUDA cores ---------

// SB register entries a lane; EXACT: S == SB, else S < SB and the rows past S
// are skipped.
template <typename T, int SB, bool EXACT>
__global__ void __launch_bounds__(MAX_THREADS)
    ring_slots_kernel(const T* __restrict__ tips,      // [N,S,P]
                      const T* __restrict__ pm,        // [B,M,C,S,S] by node
                      const int* __restrict__ lr_ids,  // [B,n_int,2]
                      const int* __restrict__ lr_pos,  // [B,n_int,2], -1 a tip
                      const int* __restrict__ ls,      // [B,n_int+1]
                      const T* __restrict__ wcs,       // [B,C,S]
                      T* post,                         // [B,tiles,n_int,C,S,pw]
                      T* __restrict__ out,             // [B,P]
                      int n_tips, int c_n, int s_rt, int p_n, int pw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = EXACT ? SB : s_rt;
  const int n_int = n_tips - 1;
  const int ne = c_n * S * S;  // one child's matrices
  const int ne_pad = slot_elems<T>(c_n, S);
  const int part = c_n * S * pw;  // one node's partials in this tile
  {  // this block's chain and tile
    const size_t b = blockIdx.y;
    pm += b * (2 * (size_t)n_tips - 1) * ne;
    lr_ids += b * 2 * n_int;
    lr_pos += b * 2 * n_int;
    ls += b * (n_int + 1);
    wcs += b * c_n * S;
    post += (b * gridDim.x + blockIdx.x) * (size_t)n_int * part;
    out += b * p_n;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gs = pw * c_n, groups = 32 / gs;
  const int g = lane / gs, r = lane - g * gs;
  const int cc = r / pw, q = r - cc * pw;
  const int n_slots = (blockDim.x >> 5) * groups;
  const int slot = warp * groups + g;
  const bool active = g < groups;
  const int base = g * gs;
  const unsigned gmask = gs == 32 ? 0xffffffffu : (((1u << gs) - 1u) << (base & 31));
  T* mats = reinterpret_cast<T*>(smem_raw);  // [slots][2 buffers][2 children][ne_pad]
  double* red = reinterpret_cast<double*>(mats + (size_t)n_slots * 4 * ne_pad);  // [slots][pw]

  const int p_raw = blockIdx.x * pw + q;
  const bool valid = p_raw < p_n;
  const int p = valid ? p_raw : p_n - 1;  // ragged edge: no output stored
  const size_t slab = (size_t)S * p_n;
  const bool vec = (ne * sizeof(T)) % 16 == 0;

  // the matrices of the children `ids` into buffer `buf` of this slot
  auto fetch = [&](int4 row, int buf) {
    T* dst = mats + ((size_t)slot * 2 + buf) * 2 * ne_pad;
    const T* src0 = pm + (size_t)row.x * ne;
    const T* src1 = pm + (size_t)row.y * ne;
    if (vec) {
      const int nv = ne * (int)sizeof(T) / 16;
      for (int v = r; v < 2 * nv; v += gs) {
        const int k = v >= nv, e = v - k * nv;
        cp_async16(reinterpret_cast<char*>(dst + k * ne_pad) + 16 * e,
                   reinterpret_cast<const char*>(k ? src1 : src0) + 16 * e);
      }
    } else {
      for (int v = r; v < 2 * ne; v += gs) {
        const int k = v >= ne, e = v - k * ne;
        cp_async_elem(dst + k * ne_pad + e, (k ? src1 : src0) + e);
      }
    }
    cp_async_commit();
  };
  // child's values of this lane's category and pattern
  auto load_child = [&](T (&v)[SB], int id, int pos) {
    if (pos < 0) {
      const T* src = tips + (size_t)id * slab + p;
#pragma unroll
      for (int s = 0; s < SB; ++s) v[s] = (EXACT || s < S) ? __ldg(src + (size_t)s * p_n) : T(0);
    } else {
      const T* src = post + (size_t)pos * part + cc * S * pw + q;
#pragma unroll
      for (int s = 0; s < SB; ++s) v[s] = (EXACT || s < S) ? __ldcg(src + s * pw) : T(0);
    }
  };

  T x[SB];
#pragma unroll
  for (int s = 0; s < SB; ++s) x[s] = T(0);
  double acc = 0.0, prod = 1.0;
  // the slot's current node and the next two, with their schedule rows
  int cur_lvl = -1;
  int cur = active ? next_node(ls, n_int, slot, n_slots, cur_lvl, -1) : -1;
  int nxt_lvl = cur_lvl;
  int nxt = cur >= 0 ? next_node(ls, n_int, slot, n_slots, nxt_lvl, cur) : -1;
  int4 cur_row = make_int4(0, 0, -1, -1), nxt_row = cur_row;
  if (cur >= 0) {
    cur_row = sched_row(lr_ids, lr_pos, cur);
    fetch(cur_row, 0);
  }
  if (nxt >= 0) nxt_row = sched_row(lr_ids, lr_pos, nxt);
  int buf = 0;

  for (int lvl = 0; __ldg(ls + lvl) < n_int; ++lvl) {
    while (cur >= 0 && cur_lvl == lvl) {
      int far_lvl = nxt_lvl;
      const int far = nxt >= 0 ? next_node(ls, n_int, slot, n_slots, far_lvl, nxt) : -1;
      int4 far_row = make_int4(0, 0, -1, -1);
      if (far >= 0) far_row = sched_row(lr_ids, lr_pos, far);  // used a node later
      if (nxt >= 0) {
        fetch(nxt_row, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp(gmask);
      T vl[SB], vr[SB];
      load_child(vl, cur_row.x, cur_row.z);
      load_child(vr, cur_row.y, cur_row.w);
      const T* ml = mats + ((size_t)slot * 2 + buf) * 2 * ne_pad + cc * S * S;
      const T* mr = ml + ne_pad;
      T mx = T(0);
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        if (EXACT || s < S) {
          T a = T(0), b = T(0);
#pragma unroll
          for (int j = 0; j < SB; ++j) {
            if (EXACT || j < S) {
              a = fma(ml[s * S + j], vl[j], a);
              b = fma(mr[s * S + j], vr[j], b);
            }
          }
          x[s] = a * b;
          mx = peel::dmax(mx, x[s]);
        }
      }
      mx = over_categories<T, true>(mx, gmask, base, q, pw, c_n, gs);
      const T scale = mx > T(0) ? mx : T(1);
      const T inv = T(1) / scale;
      take_scale(acc, prod, (double)scale);
      T* dst = post + (size_t)cur * part + cc * S * pw + q;
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        if (EXACT || s < S) {
          x[s] *= inv;
          dst[s * pw] = x[s];
        }
      }
      __syncwarp(gmask);  // buffer `buf` is refilled for the node after next
      buf ^= 1;
      cur = nxt;
      cur_lvl = nxt_lvl;
      cur_row = nxt_row;
      nxt = far;
      nxt_lvl = far_lvl;
      nxt_row = far_row;
    }
    __syncthreads();  // this level's partials are written before the next reads
  }

  if (active && cc == 0) red[slot * pw + q] = acc + log(prod);
  __syncthreads();
  // slot 0 took the last level's only node, the root: x holds its partials
  if (slot == 0 && active) {
    T part_w = T(0);
    const T* w = wcs + cc * S;
#pragma unroll
    for (int s = 0; s < SB; ++s)
      if (EXACT || s < S) part_w += x[s] * __ldg(w + s);
    const T site = over_categories<T, false>(part_w, gmask, base, q, pw, c_n, gs);
    if (cc == 0 && valid) {
      double tot = 0.0;
      for (int j = 0; j < n_slots; ++j) tot += red[j * pw + q];
      out[p] = (T)((double)peel::dlog(site) + tot);
    }
  }
}

// ---- S >= 16: teams of warps, 8 x 8 tiles on the tensor cores --------------

// Shared memory of a block: two mbarriers a team (one a buffer); then, in
// elements of the working type, a slot a team, [2 buffers][g pieces [mp,
// lda]][2 children][C][kp, W], the max reduction [teams][tw][W] and the
// root's parts [tw][W]; then the teams' log-scale sums [teams][W] in double.
struct TeamLayout {
  int kp, mp, lda, piece, cst, slot;
  __host__ __device__ TeamLayout(int c_n, int s_n, int g_n) {
    kp = (s_n + 3) & ~3;
    mp = (s_n + 7) & ~7;
    lda = pad_ld(kp);
    piece = mp * lda;
    cst = kp * W;
    slot = 2 * g_n * piece + 2 * c_n * cst;
  }
  __host__ __device__ size_t elems(int teams, int tw) const {
    return (size_t)teams * slot + ((size_t)teams + 1) * tw * W;
  }
};

__host__ __device__ inline size_t mbar_bytes(int teams) {
  return (16 * (size_t)teams + 15) & ~size_t(15);
}

__device__ __forceinline__ void store2(double* g, double a, double b) {
  *reinterpret_cast<double2*>(g) = make_double2(a, b);
}
__device__ __forceinline__ void store2(float* g, float a, float b) {
  *reinterpret_cast<float2*>(g) = make_float2(a, b);
}

// UNITS output tiles (category, row tile) a warp owns: the register tile of
// a thread is x[UNITS][2].
template <typename T, int UNITS>
__global__ void __launch_bounds__(MAX_THREADS)
    ring_teams_kernel(const T* __restrict__ tips,      // [N,S,P]
                      const T* __restrict__ pm,        // [B,M,C,mp,lda], zero-padded
                      const int* __restrict__ lr_ids,  // [B,n_int,2]
                      const int* __restrict__ lr_pos,  // [B,n_int,2], -1 a tip
                      const int* __restrict__ ls,      // [B,n_int+1]
                      const T* __restrict__ wcs,       // [B,C,S]
                      T* post,                         // [B,tiles,n_int,C,S,W]
                      T* __restrict__ out,             // [B,P]
                      int n_tips, int c_n, int s_n, int p_n, int teams, int tw, int g_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TeamLayout L(c_n, s_n, g_n);
  const int n_int = n_tips - 1;
  const int part = c_n * s_n * W;  // one node's partials in this tile
  {  // this block's chain and tile
    const size_t b = blockIdx.y, nodes = 2 * (size_t)n_tips - 1;
    pm += b * nodes * c_n * L.piece;
    lr_ids += b * 2 * n_int;
    lr_pos += b * 2 * n_int;
    ls += b * (n_int + 1);
    wcs += b * c_n * s_n;
    post += (b * gridDim.x + blockIdx.x) * (size_t)n_int * part;
    out += b * p_n;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / tw, wj = warp - team * tw;
  const int tt = wj * 32 + lane, nthr = 32 * tw;  // thread within the team
  const int rt_n = L.mp >> 3, ksteps = L.kp >> 2;
  const int units = c_n * rt_n;
  const size_t cs_p = (size_t)s_n * p_n;  // one tip's partials
  const int spn = (2 * c_n) / g_n;        // steps a node is computed in

  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem_raw);  // [teams][2]
  unsigned char* tail = smem_raw + mbar_bytes(teams);
  T* smem = reinterpret_cast<T*>(tail);
  T* amat = smem + (size_t)team * L.slot;  // [2][g][mp][lda]
  T* btile = amat + 2 * g_n * L.piece;     // [2][C][kp][W]
  T* red = smem + (size_t)teams * L.slot;  // [teams][tw][W]
  T* root_part = red + teams * tw * W;     // [tw][W]
  double* acc_s = reinterpret_cast<double*>(
      tail + ((L.elems(teams, tw) * sizeof(T) + 7) & ~size_t(7)));  // [teams][W]

  // the children's tiles' padding stays zero: their copies touch only the
  // [S, W] interiors (the matrices arrive padded)
  for (int m = 0; m < teams; ++m)
    for (int e = threadIdx.x; e < 2 * c_n * L.cst; e += blockDim.x)
      smem[(size_t)m * L.slot + 2 * g_n * L.piece + e] = T(0);
  if (threadIdx.x < 2 * teams)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(mbar + threadIdx.x))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const unsigned bar0 = smem_addr(mbar + 2 * team);  // buffer b's: bar0 + 8 b
  unsigned phases = 0;  // bit b: the phase of buffer b's mbarrier

  const int p0 = blockIdx.x * W;
  const int trow = lane >> 2;
  const int col0 = 2 * (lane & 3);  // this thread's two columns
  int uc[UNITS], urow[UNITS];       // category, first row; -1 for no unit
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    const int u = wj + j * tw;
    uc[j] = u < units ? u / rt_n : -1;
    urow[j] = (u - (u / rt_n) * rt_n) * 8;
  }
  // how this thread walks a tip's rows of one column (element-wise, the
  // ragged edge clamped), and an internal child's rows (16 bytes at a time)
  const int ccol = tt % W, tr0 = tt / W, dtr = nthr / W;
  const int pcol = min(p0 + ccol, p_n - 1);
  constexpr int per16 = 16 / (int)sizeof(T);
  constexpr int cpr = W / per16;  // 16-byte pieces of a row of W

  T x[UNITS][2];
#pragma unroll
  for (int j = 0; j < UNITS; ++j) x[j][0] = x[j][1] = T(0);
  double acc0 = 0.0, acc1 = 0.0, prod0 = 1.0, prod1 = 1.0;

  // step st's g pieces of the node with children `row` into buffer `into`,
  // by one thread of the team through the bulk copy engine: piece q of the
  // node is category q / 2 of child q % 2, [mp, lda] as in the slot
  auto fetch_mats = [&](int4 row, int st, int into) {
    if (tt == 0) {
      const unsigned bytes = (unsigned)(L.piece * sizeof(T));
      const unsigned bar = bar0 + 8 * into;
      mbar_expect(bar, g_n * bytes);
      for (int gq = 0; gq < g_n; ++gq) {
        const int q = st * g_n + gq;
        bulk_copy(amat + (into * g_n + gq) * L.piece,
                  pm + ((size_t)((q & 1) ? row.y : row.x) * c_n + (q >> 1)) * L.piece, bytes,
                  bar);
      }
    }
  };

  // The team's steps take the two buffers in turns: the pieces of its next
  // step (of this node, else of its next node, across the level barrier:
  // the matrices depend on nothing of this launch) are copied while it
  // computes the current one. The children's tiles wait for the barrier.
  int cur_lvl = -1;
  int cur = next_node(ls, n_int, team, teams, cur_lvl, -1);
  int4 cur_row = make_int4(0, 0, -1, -1);
  int buf = 0;  // the buffer of the team's current step
  if (cur >= 0) {
    cur_row = sched_row(lr_ids, lr_pos, cur);
    fetch_mats(cur_row, 0, 0);
  }
  for (int lvl = 0; __ldg(ls + lvl) < n_int; ++lvl) {
    while (cur >= 0 && cur_lvl == lvl) {
      int nxt_lvl = cur_lvl;
      const int nxt = next_node(ls, n_int, team, teams, nxt_lvl, cur);
      int4 nxt_row = make_int4(0, 0, -1, -1);
      if (nxt >= 0) nxt_row = sched_row(lr_ids, lr_pos, nxt);  // used after this node
      const bool tip0 = cur_row.z < 0, tip1 = cur_row.w < 0;
      // the children's tiles [C or 1, S, W] (a tip serves every category)
      for (int k = 0; k < 2; ++k) {
        T* dst = btile + k * c_n * L.cst;
        if (k ? tip1 : tip0) {
          const T* src = tips + (size_t)(k ? cur_row.y : cur_row.x) * cs_p + pcol;
          for (int rr = tr0; rr < s_n; rr += dtr)
            cp_async_elem(dst + rr * W + ccol, src + (size_t)rr * p_n);
        } else {
          const T* src = post + (size_t)(k ? cur_row.w : cur_row.z) * part;
          for (int e = tt; e < c_n * s_n * cpr; e += nthr) {
            const int rw = e / cpr, c = rw / s_n;
            const int off = (e - rw * cpr) * per16;
            cp_async16(dst + c * L.cst + (rw - c * s_n) * W + off, src + rw * W + off);
          }
        }
      }
      cp_async_commit();
      T mx0 = T(0), mx1 = T(0);
      for (int st = 0; st < spn; ++st) {
        cp_async_wait_all();
        mbar_wait(bar0 + 8 * buf, (phases >> buf) & 1);
        phases ^= 1u << buf;
        // the buffer is filled, and every warp is done with the other one
        team_sync(1 + team, nthr);
        if (st + 1 < spn) {
          fetch_mats(cur_row, st + 1, buf ^ 1);
        } else if (nxt >= 0) {
          fetch_mats(nxt_row, 0, buf ^ 1);
        }
        const T* am = amat + buf * g_n * L.piece;
        const int lo = st * g_n;
#pragma unroll
        for (int j = 0; j < UNITS; ++j) {
          if (uc[j] >= 0) {
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int q = 2 * uc[j] + k - lo;  // the piece within this step's slot
              if ((unsigned)q < (unsigned)g_n) {
                const bool tip = k ? tip1 : tip0;
                const T* xt = btile + (k * c_n + (tip ? 0 : uc[j])) * L.cst;
                T y0, y1;
                tile_product(am + q * L.piece + urow[j] * L.lda, L.lda, xt, ksteps, lane, y0, y1);
                if (k == 0) {
                  x[j][0] = y0;
                  x[j][1] = y1;
                } else {
                  x[j][0] *= y0;
                  x[j][1] *= y1;
                  mx0 = peel::dmax(mx0, x[j][0]);
                  mx1 = peel::dmax(mx1, x[j][1]);
                }
              }
            }
          }
        }
        buf ^= 1;
      }

      // per-pattern max over the node: the rows of a tile by shuffles, the
      // warps of the team through `red`; the barrier also frees the
      // children's tiles
      mx0 = rows_max(mx0);
      mx1 = rows_max(mx1);
      T* rd = red + (size_t)team * tw * W + col0;
      if (lane < 4) {
        rd[wj * W] = mx0;
        rd[wj * W + 1] = mx1;
      }
      team_sync(1 + team, nthr);
      T s0 = rd[0], s1 = rd[1];
      for (int w = 1; w < tw; ++w) {
        s0 = peel::dmax(s0, rd[w * W]);
        s1 = peel::dmax(s1, rd[w * W + 1]);
      }
      if (!(s0 > T(0))) s0 = T(1);
      if (!(s1 > T(0))) s1 = T(1);
      take_scale(acc0, prod0, s0);
      take_scale(acc1, prod1, s1);

      // rescale by the reciprocal and store the node's rows, two columns a
      // thread (the tile's padding columns too)
      const T inv0 = T(1) / s0, inv1 = T(1) / s1;
      T* gp = post + (size_t)cur * part + col0;
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        if (uc[j] >= 0) {
          x[j][0] *= inv0;
          x[j][1] *= inv1;
          const int row = urow[j] + trow;
          if (row < s_n) store2(gp + (uc[j] * s_n + row) * W, x[j][0], x[j][1]);
        }
      }
      cur = nxt;
      cur_lvl = nxt_lvl;
      cur_row = nxt_row;
    }
    __syncthreads();  // this level's partials are written before the next reads
  }

  // the teams' log-scale sums; team 0 took the last level's only node, the
  // root, and still holds its rows
  if (wj == 0 && lane < 4) {
    acc_s[team * W + col0] = acc0 + log(prod0);
    acc_s[team * W + col0 + 1] = acc1 + log(prod1);
  }
  if (team == 0) {
    T part0 = T(0), part1 = T(0);
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const int row = urow[j] + trow;
      if (uc[j] >= 0 && row < s_n) {
        const T w = __ldg(wcs + uc[j] * s_n + row);
        part0 += w * x[j][0];
        part1 += w * x[j][1];
      }
    }
    part0 = rows_sum(part0);
    part1 = rows_sum(part1);
    if (lane < 4) {
      root_part[wj * W + col0] = part0;
      root_part[wj * W + col0 + 1] = part1;
    }
  }
  __syncthreads();
  if (threadIdx.x < W) {  // one thread a pattern
    const int c = threadIdx.x;
    T site = T(0);
    for (int w = 0; w < tw; ++w) site += root_part[w * W + c];
    double tot = 0.0;
    for (int m = 0; m < teams; ++m) tot += acc_s[m * W + c];
    if (p0 + c < p_n) out[p0 + c] = (T)((double)peel::dlog(site) + tot);
  }
}

// ---- launch ----------------------------------------------------------------

struct Args {
  const void *tips, *pm, *lr_ids, *lr_pos, *ls, *wcs;
  void *post, *out;
  // pw: patterns of a slot (S < 16) or of a block (S >= 16, W); nodes: the
  // block's slots (S < 16) or teams (S >= 16); g_n: matrix pieces a team's
  // slot holds (S >= 16)
  int n_tips, c_n, s_n, p_n, pw, warps, nodes, g_n, b_n;
  void* stream;
};

size_t slots_smem(const Args& a, size_t itemsize) {
  const int ne_pad = itemsize == 8 ? slot_elems<double>(a.c_n, a.s_n)
                                   : slot_elems<float>(a.c_n, a.s_n);
  return (size_t)a.nodes * (4 * (size_t)ne_pad * itemsize + a.pw * sizeof(double));
}

size_t teams_smem(const Args& a, size_t itemsize) {
  const TeamLayout L(a.c_n, a.s_n, a.g_n);
  const int tw = a.warps / a.nodes;
  return mbar_bytes(a.nodes) + ((L.elems(a.nodes, tw) * itemsize + 7) & ~size_t(7)) +
         (size_t)a.nodes * W * sizeof(double);
}

template <typename T, int SB, bool EXACT>
int launch_slots(const Args& a, size_t smem) {
  auto kern = ring_slots_kernel<T, SB, EXACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((a.p_n + a.pw - 1) / a.pw, a.b_n), 32 * a.warps, smem,
         (cudaStream_t)a.stream>>>((const T*)a.tips, (const T*)a.pm, (const int*)a.lr_ids,
                                   (const int*)a.lr_pos, (const int*)a.ls, (const T*)a.wcs,
                                   (T*)a.post, (T*)a.out, a.n_tips, a.c_n, a.s_n, a.p_n,
                                   a.pw);
  return (int)cudaGetLastError();
}

template <typename T, int UNITS>
int launch_teams(const Args& a, size_t smem) {
  auto kern = ring_teams_kernel<T, UNITS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((a.p_n + W - 1) / W, a.b_n), 32 * a.warps, smem, (cudaStream_t)a.stream>>>(
      (const T*)a.tips, (const T*)a.pm, (const int*)a.lr_ids, (const int*)a.lr_pos,
      (const int*)a.ls, (const T*)a.wcs, (T*)a.post, (T*)a.out, a.n_tips, a.c_n, a.s_n,
      a.p_n, a.nodes, a.warps / a.nodes, a.g_n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a) {
  if (a.s_n < 2 || a.s_n > 64 || a.c_n < 1 || a.c_n > 8 || a.n_tips < 2 || a.p_n < 1 ||
      a.warps < 1 || 32 * a.warps > MAX_THREADS || a.nodes < 1 || a.b_n < 1 ||
      a.b_n > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.s_n < MMA_MIN_STATES) {
    const int gs = a.pw * a.c_n;
    if (a.pw < 1 || (a.pw & (a.pw - 1)) != 0 || gs > 32 || gs < 2 ||
        a.nodes != a.warps * (32 / gs))
      return (int)cudaErrorInvalidValue;
    const size_t smem = slots_smem(a, sizeof(T));
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    switch (a.s_n) {
      case 2: return launch_slots<T, 2, true>(a, smem);
      case 4: return launch_slots<T, 4, true>(a, smem);
      case 8: return launch_slots<T, 8, true>(a, smem);
      default:
        return a.s_n < 8 ? launch_slots<T, 8, false>(a, smem)
                         : launch_slots<T, 16, false>(a, smem);
    }
  }
  const int teams = a.nodes;
  if (a.pw != W || teams > 15 ||  // named barriers 1..15
      a.warps % teams != 0 || a.g_n < 1 || (2 * a.c_n) % a.g_n != 0)
    return (int)cudaErrorInvalidValue;
  const int tw = a.warps / teams;
  const int units = a.c_n * ((a.s_n + 7) / 8);
  const int per_warp = (units + tw - 1) / tw;  // output tiles a warp owns
  const size_t smem = teams_smem(a, sizeof(T));
  if (per_warp > 8 || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (per_warp == 1) return launch_teams<T, 1>(a, smem);
  if (per_warp == 2) return launch_teams<T, 2>(a, smem);
  if (per_warp <= 4) return launch_teams<T, 4>(a, smem);
  return launch_teams<T, 8>(a, smem);
}

}  // namespace

#define PEEL_RING_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* tips, const void* pm, const void* lr_ids,              \
                      const void* lr_pos, const void* ls, const void* wcs, void* post,  \
                      void* out, int n_tips, int c_n, int s_n, int p_n, int pw,         \
                      int warps, int nodes, int g_n, int b_n, void* stream) {           \
    return launch<T>(Args{tips, pm, lr_ids, lr_pos, ls, wcs, post, out, n_tips, c_n,    \
                          s_n, p_n, pw, warps, nodes, g_n, b_n, stream});               \
  }

PEEL_RING_ENTRY(peel_stream_ring_f64, double)
PEEL_RING_ENTRY(peel_stream_ring_f32, float)
