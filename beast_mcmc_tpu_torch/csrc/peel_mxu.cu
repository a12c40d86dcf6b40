// Matrix-product Felsenstein peel for Hopper (sm_90a): large state spaces
// (amino acid S = 20, codon S = 61) on the FP64 tensor cores, by levels.
//
// Replaces beast_mcmc_tpu/ops/pallas_mxu.py::_peel_kernel_mxu. Per pattern,
// for each internal node: x = (P_l . post_l) * (P_r . post_r) over every
// (category, state), scale = max of x over (category, state) (1 where that
// is 0), post = x / scale, acc += log(scale); at the root
// log(sum wcs * post_root) + acc. The rescaled partials of the internal nodes
// are written to post [M, C, S, P] by node. 2 <= S <= 64, 1 <= C <= 8, float
// or double.
//
// Unlike the TPU kernel it takes the dense [M, C, S, S] matrices, not a
// block-diagonal [C*S, C*S] operand (C - 1 of every C blocks of that are
// zero): a node is 2*C products [S, S] x [S, 8 patterns].
//
// What bounds it on this card: a node is 4*C*S*S operations per pattern
// against the tips and matrices read once, so at S >= 16 the operations set
// the bound. At the shapes of one analysis (a hundred taxa, a thousand
// patterns) the kernel is far above it: the peel is a chain of dependent
// nodes with little work each, and every block (8 patterns) needs every
// branch matrix of the tree (3.3 MB at the protein shape, 3.8 MB at the codon
// shape in f64) from L2. Walking the nodes one after the other cost two
// block barriers and a copy of the node's matrices on every node.
//
// What the design does about it (what was tried was built and timed on an
// NVIDIA H100 80GB HBM3 at 700 W during bring-up):
//  - Levels, not nodes. The wrapper sorts the internal nodes by depth from
//    the root, deepest first (ops/cuda_stream.py::level_schedule, on the
//    device): `order` is the node of each position, `lr_ids` its children,
//    `level_start` each level's first position (n_int past the last, where
//    the kernel stops). The nodes of a level are independent: a coalescent
//    tree of 128 taxa has 11-19 levels for its 127 nodes. The schedule, 16
//    bytes a node, is staged in shared memory once.
//  - Teams. A block of 8 patterns holds `teams` teams of `tw` warps; the
//    teams take the nodes of a level round robin, one block barrier a level.
//    A team owns a shared-memory slot and computes its node in it: the
//    node's output tiles (category, 8 rows) go round its warps; the slot's
//    filling and the per-pattern max over the node each take one named
//    barrier of the team (bar.sync with the team's id), so teams never wait
//    for each other inside a level. As many teams as slots fit (5 at the
//    protein shape, 2 at the codon shape, in f64).
//  - Where the matrices come from, settled on the card. Loaded straight from
//    L2 into registers, each A fragment's load sat in a chain with its mma,
//    and a node took over ten times as long as with a copy into shared
//    memory. Copied into the slot by cp.async, 16 bytes a thread, a node's
//    copies were in flight at once, but clock64 probes put the most time of
//    a node in issuing them: the SM's outstanding requests, not L2's
//    bandwidth, were the limit. Here one thread of the team hands each
//    [S, S] matrix to the bulk copy engine (cp.async.bulk, TMA) with an
//    mbarrier: the wrapper pads the matrices to the slot's layout [mp, lda]
//    in device memory, so that each is one contiguous copy. A node's
//    matrices depend on nothing of this launch, so the team starts its next
//    node's as soon as its slot is free, across the level barrier; only the
//    children's [C, S, 8] tiles (cp.async, element-wise, the ragged edge
//    clamped) wait for the barrier. A whole node's matrices a slot where
//    they fit (g = 2*C pieces), else one category's pair (g = 2), else one
//    piece (g = 1, S = 61 with C = 4 in double), the left child's products
//    then waiting in registers for the right child's. Blocks of 16 patterns,
//    each A fragment feeding two tiles, halve the matrix traffic but were
//    slower at both chains' shapes (half the SMs), so a block is 8 patterns.
//  - In double every product is an 8 x 8 output tile, a chain of
//    mma.sync.m8n8k4 (two accumulator chains), A and B read from shared
//    memory one element per thread; in float it is register-tiled FMA with
//    the same output layout (single-pass TF32 would lose precision): a
//    thread holds out[lane / 4][2 * (lane % 4) + {0, 1}] and reads four
//    matrix entries at a time. ptxas takes the larger f64 shapes m16n8k4,
//    m16n8k8 and m16n8k16 for sm_90a, but a node's time is in its copies
//    and barriers, not in the count of its mma instructions, so m8n8k4
//    stays. S is padded with zeros (rows to a multiple of 8, the inner
//    dimension to a multiple of 4, leading dimensions 4 mod 8 elements, so
//    the fragment loads of a half warp hit distinct banks): the matrices in
//    the wrapper's padded copy, the children's tiles in the slot; the tips
//    and the partials need no padding in device memory.
//  - The log-scale sum is a running product in double, the rescaling one
//    reciprocal a pattern; the teams add their sums at the end.
//  - The ragged last block recomputes pattern P-1 in its idle lanes and
//    never stores them; padded rows are never stored.
//  - A chain batch is the grid's second axis: block (x, b) peels pattern
//    block x of chain b, offsetting to its padded matrices [B, M, C, mp,
//    lda], schedule, `wcs` [B, C, S], `post` [B, M, C, S, P] and output
//    [B, P]; the tips [N, S, P] are shared by every chain. Each block stops
//    at its own chain's `level_start` sentinel. A single tree is B = 1.

#include <cuda_runtime.h>

#include "peel_common.cuh"

namespace {

using peel::cp_async_commit;
using peel::cp_async_elem;
using peel::cp_async_wait_all;
using peel::take_scale;

constexpr int MAX_THREADS = 512;       // of one block
constexpr int W = peel::TILE_W;        // patterns of a block
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may take on sm_90

using peel::bulk_copy;
using peel::mbar_expect;
using peel::mbar_wait;
using peel::pad_ld;
using peel::rows_max;
using peel::rows_sum;
using peel::smem_addr;
using peel::team_sync;
using peel::tile_product;

// Shared memory of a block: the schedule, {node, left, right, -} a position
// and `level_start`, and an mbarrier a team; then, in elements of the working
// type, a slot a team, [g pieces [mp, lda]][2 children][C][kp, W], the max
// reduction [teams][tw][W] and the root's parts [tw][W]; then the teams'
// log-scale sums [teams][W] in double.
struct Layout {
  int kp, mp, lda, piece, cst, slot;
  __host__ __device__ Layout(int c_n, int s_n, int g_n) {
    kp = (s_n + 3) & ~3;
    mp = (s_n + 7) & ~7;
    lda = pad_ld(kp);
    piece = mp * lda;
    cst = kp * W;
    slot = g_n * piece + 2 * c_n * cst;
  }
  __host__ __device__ size_t elems(int teams, int tw) const {
    return (size_t)teams * slot + ((size_t)teams + 1) * tw * W;
  }
};

// bytes of the schedule and the teams' mbarriers at the head of shared
// memory, 16-byte aligned
__host__ __device__ inline size_t head_bytes(int n_int, int teams) {
  const size_t sched = ((size_t)16 * n_int + 4 * ((size_t)n_int + 1) + 7) & ~size_t(7);
  return (sched + 8 * (size_t)teams + 15) & ~size_t(15);
}

// UNITS output tiles (category, row tile) a warp owns: the register tile of
// a thread is x[UNITS][2].
template <typename T, int UNITS>
__global__ void __launch_bounds__(MAX_THREADS) peel_mxu_kernel(
    const T* __restrict__ tips,      // [N,S,P]
    const T* __restrict__ pm,        // [B,M,C,mp,lda], by node, zero-padded
    const int* __restrict__ order,   // [B,n_int], node of each position
    const int* __restrict__ lr_ids,  // [B,n_int,2]
    const int* __restrict__ ls,      // [B,n_int+1]
    const T* __restrict__ wcs,       // [B,C,S]
    T* post,                         // [B,M,C,S,P], internal nodes written and read back
    T* __restrict__ out,             // [B,P]
    int n_tips, int c_n, int s_n, int p_n, int teams, int tw, int g_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(c_n, s_n, g_n);
  const int n_int = n_tips - 1;
  {  // this block's chain
    const size_t b = blockIdx.y, nodes = 2 * (size_t)n_tips - 1;
    pm += b * nodes * c_n * L.piece;
    order += b * n_int;
    lr_ids += b * 2 * n_int;
    ls += b * (n_int + 1);
    wcs += b * c_n * s_n;
    post += b * nodes * c_n * s_n * p_n;
    out += b * p_n;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / tw, wj = warp - team * tw;
  const int tt = wj * 32 + lane, nthr = 32 * tw;  // thread within the team
  const int rt_n = L.mp >> 3, ksteps = L.kp >> 2;
  const int units = c_n * rt_n;
  const size_t cs_p = (size_t)s_n * p_n;  // one category of a node's partials
  const int spn = (2 * c_n) / g_n;        // steps a node is computed in

  int4* sch = reinterpret_cast<int4*>(smem_raw);  // [n_int]
  int* ls_s = reinterpret_cast<int*>(sch + n_int);  // [n_int+1]
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(
      smem_raw + (((size_t)16 * n_int + 4 * ((size_t)n_int + 1) + 7) & ~size_t(7)));  // [teams]
  unsigned char* tail = smem_raw + head_bytes(n_int, teams);
  T* smem = reinterpret_cast<T*>(tail);
  T* amat = smem + (size_t)team * L.slot;   // [g][mp][lda]
  T* btile = amat + g_n * L.piece;          // [2][C][kp][W]
  T* red = smem + (size_t)teams * L.slot;   // [teams][tw][W]
  T* root_part = red + teams * tw * W;      // [tw][W]
  double* acc_s = reinterpret_cast<double*>(
      tail + ((L.elems(teams, tw) * sizeof(T) + 7) & ~size_t(7)));  // [teams][W]

  // the children's tiles' padding stays zero: their copies touch only the
  // [S, W] interiors (the matrices arrive padded)
  for (int m = 0; m < teams; ++m)
    for (int e = threadIdx.x; e < 2 * c_n * L.cst; e += blockDim.x)
      smem[(size_t)m * L.slot + g_n * L.piece + e] = T(0);
  for (int i = threadIdx.x; i < n_int; i += blockDim.x)
    sch[i] = make_int4(order[i], lr_ids[2 * i], lr_ids[2 * i + 1], 0);
  for (int i = threadIdx.x; i <= n_int; i += blockDim.x) ls_s[i] = ls[i];
  if (threadIdx.x < teams)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(mbar + threadIdx.x))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const unsigned bar = smem_addr(mbar + team);
  unsigned phase = 0;  // of the team's mbarrier

  const int p0 = blockIdx.x * W;
  const int trow = lane >> 2;
  const int col0 = 2 * (lane & 3);  // this thread's two columns
  const bool valid0 = p0 + col0 < p_n, valid1 = p0 + col0 + 1 < p_n;
  int uc[UNITS], urow[UNITS];       // category, first row; -1 for no unit
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    const int u = wj + j * tw;
    uc[j] = u < units ? u / rt_n : -1;
    urow[j] = (u - (u / rt_n) * rt_n) * 8;
  }
  // how this thread walks a child's rows (category, state) of one column:
  // fixed once, so the copies divide nothing
  const int ccol = tt % W, cs0 = tt / W, dcs = nthr / W;
  const int cc0 = cs0 / s_n, cr0 = cs0 - cc0 * s_n;
  const int dcc = dcs / s_n, dcr = dcs - dcc * s_n;
  const int pcol = min(p0 + ccol, p_n - 1);

  T x[UNITS][2];
#pragma unroll
  for (int j = 0; j < UNITS; ++j) x[j][0] = x[j][1] = T(0);
  double acc0 = 0.0, acc1 = 0.0, prod0 = 1.0, prod1 = 1.0;

  // step st's g pieces of the node with children `kids` into the slot, by
  // one thread of the team through the bulk copy engine: piece q of the
  // node is category q / 2 of child q % 2, [mp, lda] as in the slot
  auto fetch_mats = [&](int2 kids, int st) {
    if (tt == 0) {
      const unsigned bytes = (unsigned)(L.piece * sizeof(T));
      mbar_expect(bar, g_n * bytes);
      for (int gq = 0; gq < g_n; ++gq) {
        const int q = st * g_n + gq;
        bulk_copy(amat + gq * L.piece,
                  pm + ((size_t)((q & 1) ? kids.y : kids.x) * c_n + (q >> 1)) * L.piece, bytes,
                  bar);
      }
    }
  };
  // the team's node after position i of level lv (lv updated in place): the
  // next of its round robin in the level, else its first in the first later
  // level wide enough to give it one; -1 when there is none. i = -1 asks for
  // the team's first node.
  auto next_node = [&](int& lv, int i) {
    if (i >= 0 && i + teams < ls_s[lv + 1]) return i + teams;
    for (++lv;; ++lv) {
      const int a = ls_s[lv];
      if (a >= n_int) return -1;
      if (a + team < ls_s[lv + 1]) return a + team;
    }
  };

  // The matrices of the team's next node are copied as soon as its slot is
  // free, across the level barrier: they depend on nothing of this launch.
  // The children's tiles wait for the barrier.
  int cur_lvl = -1;
  int cur = next_node(cur_lvl, -1);
  if (cur >= 0) fetch_mats(make_int2(sch[cur].y, sch[cur].z), 0);
  for (int lvl = 0; ls_s[lvl] < n_int; ++lvl) {
    while (cur >= 0 && cur_lvl == lvl) {
      const int4 sn = sch[cur];
      const int nd = sn.x;
      const int2 kids = make_int2(sn.y, sn.z);
      const bool tip0 = kids.x < n_tips, tip1 = kids.y < n_tips;
      // the children's tiles [C or 1, S, W] (a tip serves every category)
      for (int k = 0; k < 2; ++k) {
        const int child = k ? kids.y : kids.x;
        const bool tip = k ? tip1 : tip0;
        const T* src =
            (tip ? tips + (size_t)child * cs_p : post + (size_t)child * c_n * cs_p) + pcol;
        T* dst = btile + k * c_n * L.cst + ccol;
        const int rows = (tip ? 1 : c_n) * s_n;
        for (int cs = cs0, c = cc0, r = cr0; cs < rows; cs += dcs) {  // cs = c * S + r
          cp_async_elem(dst + c * L.cst + r * W, src + (size_t)cs * p_n);
          c += dcc;
          r += dcr;
          if (r >= s_n) {
            r -= s_n;
            ++c;
          }
        }
      }
      cp_async_commit();
      T mx0 = T(0), mx1 = T(0);
      for (int st = 0; st < spn; ++st) {
        if (st > 0) fetch_mats(kids, st);
        cp_async_wait_all();
        mbar_wait(bar, phase);
        phase ^= 1;
        team_sync(1 + team, nthr);  // the slot is filled
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
                tile_product(amat + q * L.piece + urow[j] * L.lda, L.lda, xt, ksteps, lane, y0,
                             y1);
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
        if (st + 1 < spn) team_sync(1 + team, nthr);  // before the slot is refilled
      }

      // per-pattern max over the node: the rows of a tile by shuffles, the
      // warps of the team through `red`; the barrier also frees the slot
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
      int nxt_lvl = cur_lvl;
      const int nxt = next_node(nxt_lvl, cur);
      if (nxt >= 0) fetch_mats(make_int2(sch[nxt].y, sch[nxt].z), 0);  // the slot is free

      // rescale by the reciprocal and store the node's rows
      const T inv0 = T(1) / s0, inv1 = T(1) / s1;
      T* gp = post + (size_t)nd * c_n * cs_p + p0 + col0;
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        if (uc[j] >= 0) {
          x[j][0] *= inv0;
          x[j][1] *= inv1;
          const int row = urow[j] + trow;
          if (row < s_n) {
            T* g = gp + ((size_t)uc[j] * s_n + row) * p_n;
            if (valid0) g[0] = x[j][0];
            if (valid1) g[1] = x[j][1];
          }
        }
      }
      cur = nxt;
      cur_lvl = nxt_lvl;
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

struct Args {
  const void *tips, *pm, *order, *lr_ids, *ls, *wcs;
  void *post, *out;
  int n_tips, c_n, s_n, p_n, teams, tw, g_n, b_n;
  void* stream;
};

size_t smem_bytes(const Args& a, size_t itemsize) {
  const Layout L(a.c_n, a.s_n, a.g_n);
  return head_bytes(a.n_tips - 1, a.teams) +
         ((L.elems(a.teams, a.tw) * itemsize + 7) & ~size_t(7)) +
         (size_t)a.teams * W * sizeof(double);
}

template <typename T, int UNITS>
int launch_as(const Args& a, size_t smem) {
  auto kern = peel_mxu_kernel<T, UNITS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((a.p_n + W - 1) / W, a.b_n), 32 * a.teams * a.tw, smem,
         (cudaStream_t)a.stream>>>(
      (const T*)a.tips, (const T*)a.pm, (const int*)a.order, (const int*)a.lr_ids,
      (const int*)a.ls, (const T*)a.wcs, (T*)a.post, (T*)a.out, a.n_tips, a.c_n, a.s_n,
      a.p_n, a.teams, a.tw, a.g_n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a) {
  if (a.s_n < 2 || a.s_n > 64 || a.c_n < 1 || a.c_n > 8 || a.n_tips < 2 || a.p_n < 1 ||
      a.teams < 1 || a.teams > 15 ||  // named barriers 1..15
      a.tw < 1 || 32 * a.teams * a.tw > MAX_THREADS || a.g_n < 1 ||
      (2 * a.c_n) % a.g_n != 0 || a.b_n < 1 || a.b_n > 65535 ||
      (size_t)a.c_n * a.s_n * a.p_n > 0x7fffffffu)  // offsets within a node are int
    return (int)cudaErrorInvalidValue;
  const int units = a.c_n * ((a.s_n + 7) / 8);
  const int per_warp = (units + a.tw - 1) / a.tw;  // output tiles a warp owns
  const size_t smem = smem_bytes(a, sizeof(T));
  if (per_warp > 8 || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (per_warp == 1) return launch_as<T, 1>(a, smem);
  if (per_warp == 2) return launch_as<T, 2>(a, smem);
  if (per_warp <= 4) return launch_as<T, 4>(a, smem);
  return launch_as<T, 8>(a, smem);
}

}  // namespace

#define PEEL_MXU_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* tips, const void* pm, const void* order,             \
                      const void* lr_ids, const void* ls, const void* wcs, void* post,  \
                      void* out, int n_tips, int c_n, int s_n, int p_n, int teams,     \
                      int tw, int g_n, int b_n, void* stream) {                        \
    return launch<T>(Args{tips, pm, order, lr_ids, ls, wcs, post, out, n_tips, c_n,     \
                          s_n, p_n, teams, tw, g_n, b_n, stream});                     \
  }

PEEL_MXU_ENTRY(peel_mxu_f64, double)
PEEL_MXU_ENTRY(peel_mxu_f32, float)
