// Matrix-product Felsenstein peel for Hopper (sm_90a): large state spaces
// (amino acid S = 20, codon S = 61) on the FP64 tensor cores.
//
// Replaces beast_mcmc_tpu/ops/pallas_mxu.py::_peel_kernel_mxu. Per pattern,
// for each internal node in peel order: x = (P_l . post_l) * (P_r . post_r)
// over every (category, state), scale = max of x over (category, state) (1
// where that is 0), post = x / scale, acc += log(scale); at the root
// log(sum wcs * post_root) + acc. The rescaled partials of the internal nodes
// are written to post [M, C, S, P] by node. 2 <= S <= 64, 1 <= C <= 8, float
// or double.
//
// Unlike the TPU kernel it takes the dense [M, C, S, S] matrices, not a
// block-diagonal [C*S, C*S] operand (C - 1 of every C blocks of that are
// zero): a node is 2*C products [S, S] x [S, BP].
//
// What bounds it on this card: a node is 4*C*S*S operations per pattern
// against the tips and matrices read once, so at S >= 16 the operations set
// the bound. At the shapes of one analysis (a hundred taxa, a thousand
// patterns) the kernel is far above it: the peel is a dependent chain of
// nodes with little work each, one block to an SM, and a node costs its two
// barriers, the copy of the node's matrices that every block repeats, and
// the latency of a short chain of matrix instructions.
//
// What the design does about it:
//  - Every product is an 8 x 8 output tile owned by one warp. In double it
//    is a chain of mma.sync.m8n8k4 (FP64 tensor cores), A (the matrix) and B
//    (the child's partials) read from shared memory one element per thread,
//    two accumulator chains in flight; in float it is register-tiled FMA
//    with the same output layout (single-pass TF32 would lose precision):
//    a thread holds out[lane / 4][2 * (lane % 4) + {0, 1}] and reads four
//    matrix entries at a time. S is padded with zeros in shared memory only:
//    rows to a multiple of 8, the inner dimension to a multiple of 4. Leading
//    dimensions are 4 mod 8 elements, which keeps the fragment loads of a
//    half warp on distinct banks.
//  - A block owns BP = 8, 16 or 32 patterns, `w` warps to each 8-pattern
//    tile; the node's C * ceil(S / 8) output tiles go round the warps of their
//    pattern tile, and a warp keeps the products of its tiles in registers:
//    the two children's accumulators have the same layout, so their product,
//    the max over the 8 rows of a tile (shuffles) and the rescaling need no
//    trip through shared memory. Only the max over the warps of a pattern
//    tile goes through a small shared buffer, one barrier a node. More warps
//    shorten a node (its chains of matrix instructions run side by side) as
//    long as each still has a tile.
//  - A node's instructions outside the products are kept few, since every
//    warp repeats them: the schedule sits in shared memory as {node, left,
//    right, flags}, a thread's walk through a matrix or a child tile is fixed
//    once, the log-scale sum is a running product, the rescaling multiplies
//    by one reciprocal a pattern, and offsets within a node are 32-bit.
//  - Partials live in device memory by node (the recent ones are still in
//    L2 when their parent reads them). A node's output also stays in a
//    shared-memory slot for the next node, which is often its parent;
//    every other child, and the tips, are copied into a staging slot by
//    cp.async one node ahead, while the current node is computed.
//  - The matrices arrive by cp.async in two slots of `g` pieces [S, S] each:
//    a whole node (g = 2*C) where that fits shared memory, else one category's
//    pair (g = 2), else one piece (g = 1, S = 61 with C = 4 in double), the
//    left child's products then waiting in registers for the right child's.
//  - The ragged last tile recomputes pattern P-1 in its idle lanes and never
//    stores them; padded rows are never stored. Child tiles are copied
//    element-wise and the matrices 16 bytes at a time only where S allows, so
//    no pattern or state count needs padding in device memory.

#include <cuda_runtime.h>

#include "peel_common.cuh"

namespace {

using peel::cp_async_commit;
using peel::cp_async_elem;
using peel::cp_async_wait_all;

constexpr int MAX_THREADS = 512;       // of one block
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may take on sm_90
constexpr unsigned FULL = 0xffffffffu;

// 16 bytes from device to shared memory, both 16-byte aligned
template <typename T>
__device__ __forceinline__ void cp_async_16(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
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
// (leading dimension ldb). The thread gets out[lane / 4][2 * (lane % 4) + i]
// in y_i, the accumulator layout of mma.m8n8k4.
__device__ __forceinline__ void tile_product(const double* __restrict__ a_tile, int lda,
                                             const double* __restrict__ x_tile, int ldb,
                                             int ksteps, int lane, double& y0, double& y1) {
  const double* a = a_tile + (lane >> 2) * lda + (lane & 3);
  const double* b = x_tile + (lane & 3) * ldb + (lane >> 2);
  const int step = 4 * ldb;
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
                                             const float* __restrict__ x_tile, int ldb,
                                             int ksteps, int lane, float& y0, float& y1) {
  const float4* a = reinterpret_cast<const float4*>(a_tile + (lane >> 2) * lda);
  const float* b = x_tile + 2 * (lane & 3);
  y0 = 0.f;
  y1 = 0.f;
  for (int ks = 0; ks < ksteps; ++ks) {
    const float4 av = a[ks];
    const float* bk = b + 4 * ks * ldb;
    const float2 b0 = *reinterpret_cast<const float2*>(bk);
    const float2 b1 = *reinterpret_cast<const float2*>(bk + ldb);
    const float2 b2 = *reinterpret_cast<const float2*>(bk + 2 * ldb);
    const float2 b3 = *reinterpret_cast<const float2*>(bk + 3 * ldb);
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
  for (int off = 4; off < 32; off <<= 1) v = peel::dmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
template <typename T>
__device__ __forceinline__ T rows_sum(T v) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
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

// UNITS output tiles (category, row tile) a warp owns: the register tile of
// a thread is x[UNITS][2].
template <typename T, int UNITS>
__global__ void __launch_bounds__(MAX_THREADS) peel_mxu_kernel(
    const T* __restrict__ tips,        // [N,S,P]
    const T* __restrict__ pm,          // [M,C,S,S], by node
    const int* __restrict__ children,  // [M,2]
    const int* __restrict__ order,     // [n_int]
    const T* __restrict__ wcs,         // [C,S]
    T* post,                           // [M,C,S,P], internal nodes written and read back
    T* __restrict__ out,               // [P]
    int n_tips, int n_int, int c_n, int s_n, int p_n, int bp_log2, int w_n, int g_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bp = 1 << bp_log2;
  const int kp = (s_n + 3) & ~3;             // inner dimension, padded
  const int mp = (s_n + 7) & ~7;             // output rows, padded
  const int rt_n = mp >> 3, ksteps = kp >> 2;
  const int lda = pad_ld(kp), ldb = bp + 4;
  const int cst_n = kp * ldb;                // one category of a child tile
  const int xslot = c_n * cst_n;             // one child tile [C][kp][ldb]
  const int piece = mp * lda;                // one matrix [mp][lda]
  const int mslot = g_n * piece;
  const int spn = (2 * c_n) / g_n;           // steps a node is computed in
  const int ss = s_n * s_n;

  // the schedule: {node, left child, right child, flags} per peel step; bit k
  // of flags says that child k is the node computed just before
  int4* sch = reinterpret_cast<int4*>(smem_raw);         // [n_int]
  T* cur = reinterpret_cast<T*>(sch + n_int);            // [2][xslot]: the last two outputs
  T* stage = cur + 2 * xslot;                            // [2][2][xslot]: fetched children
  T* mat = stage + 4 * xslot;                            // [2][mslot]
  T* red = mat + 2 * mslot;                              // [2][w_n][bp]

  // warp (pattern tile nt, wq of w_n); its units u = wq, wq + w_n, ...
  const int nt = warp & ((bp >> 3) - 1), wq = warp >> (bp_log2 - 3);
  const int n0 = nt << 3;
  const int trow = lane >> 2;                // row of the thread within a tile
  const int col0 = n0 + 2 * (lane & 3);      // its two columns: col0, col0 + 1
  const int p0 = blockIdx.x << bp_log2;
  const bool valid0 = p0 + col0 < p_n, valid1 = p0 + col0 + 1 < p_n;
  int uc[UNITS], urow[UNITS];                // category, first row; -1 for no unit
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    const int u = wq + j * w_n;
    uc[j] = u < c_n * rt_n ? u / rt_n : -1;
    urow[j] = (u - (u / rt_n) * rt_n) * 8;
  }

  // how this thread walks a matrix [S, S] in vectors of vec elements (16
  // bytes where S allows, else one element), and a child tile [rows, BP]
  const int vec = (s_n % (16 / (int)sizeof(T)) == 0) ? 16 / (int)sizeof(T) : 1;
  const int sv = s_n / vec;
  const int mr0 = tid / sv, mj0 = tid - mr0 * sv;
  const int mdr = nthreads / sv, mdj = nthreads - mdr * sv;
  const int ccol = tid & (bp - 1), crow0 = tid >> bp_log2, cdr = nthreads >> bp_log2;
  const int pcol = min(p0 + ccol, p_n - 1);

  // padding stays zero: the copies below touch only the [S, S] and [S, BP]
  // interiors
  for (int e = tid; e < 6 * xslot + 2 * mslot; e += nthreads) cur[e] = T(0);
  for (int i = tid; i < n_int; i += nthreads) {
    const int node = order[i], prev = i > 0 ? order[i - 1] : -1;
    const int l = children[2 * node], r = children[2 * node + 1];
    sch[i] = make_int4(node, l, r, (l == prev ? 1 : 0) | (r == prev ? 2 : 0));
  }
  __syncthreads();

  // the matrices of step st of node i into slot
  auto fetch_mats = [&](int i, int st, int slot) {
    if (i >= n_int) return;
    const int4 sn = sch[i];
    for (int g = 0; g < g_n; ++g) {
      const int q = st * g_n + g;  // piece of the node: category q / 2, child q % 2
      const T* src = pm + ((size_t)((q & 1) ? sn.z : sn.y) * c_n + (q >> 1)) * ss;
      T* d = mat + slot * mslot + g * piece;
      for (int r = mr0, j = mj0; r < s_n;) {
        if (vec == 1) {
          cp_async_elem(d + r * lda + j, src + r * s_n + j);
        } else {
          cp_async_16(d + r * lda + j * vec, src + r * s_n + j * vec);
        }
        j += mdj;
        r += mdr;
        if (j >= sv) {
          j -= sv;
          ++r;
        }
      }
    }
  };

  // the children of node i that `cur` will not hold, into stage[i & 1].
  // Started at node i - 1, so it reads no node later than i - 2.
  auto fetch_children = [&](int i) {
    const int4 sn = sch[i];
    for (int k = 0; k < 2; ++k) {
      if ((sn.w >> k) & 1) continue;
      const int child = k ? sn.z : sn.y;
      const bool tip = child < n_tips;
      const T* src = (tip ? tips + (size_t)child * s_n * p_n
                          : post + (size_t)child * c_n * s_n * p_n) + pcol;
      T* dst = stage + ((i & 1) * 2 + k) * xslot + ccol;
      for (int c = 0; c < (tip ? 1 : c_n); ++c)
        for (int s = crow0; s < s_n; s += cdr)
          cp_async_elem(dst + c * cst_n + s * ldb, src + (c * s_n + s) * p_n);
    }
  };

  T x[UNITS][2];
  double acc0 = 0.0, acc1 = 0.0, prod0 = 1.0, prod1 = 1.0;
  int slot = 0;
  fetch_mats(0, 0, 0);
  fetch_children(0);
  cp_async_commit();

  for (int i = 0; i < n_int; ++i) {
    const int4 sn = sch[i];
    const T* xk[2];
    int cst[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if ((sn.w >> k) & 1) {
        xk[k] = cur + ((i - 1) & 1) * xslot + n0;
        cst[k] = cst_n;
      } else {
        xk[k] = stage + ((i & 1) * 2 + k) * xslot + n0;
        cst[k] = (k ? sn.z : sn.y) < n_tips ? 0 : cst_n;  // a tip serves every category
      }
    }
    T mx0 = T(0), mx1 = T(0);
    for (int st = 0; st < spn; ++st, slot ^= 1) {
      // what was fetched during the last step has landed, and every thread
      // is done with the slots the next fetch overwrites
      cp_async_wait_all();
      __syncthreads();
      if (st + 1 < spn) {
        fetch_mats(i, st + 1, slot ^ 1);
      } else {
        fetch_mats(i + 1, 0, slot ^ 1);
      }
      if (st == 0 && i + 1 < n_int) fetch_children(i + 1);
      cp_async_commit();

      const T* m = mat + slot * mslot;
      const int lo = st * g_n;
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        if (uc[j] >= 0) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int q = 2 * uc[j] + k - lo;  // the piece within this step's slot
            if ((unsigned)q < (unsigned)g_n) {
              T y0, y1;
              tile_product(m + q * piece + urow[j] * lda, lda, xk[k] + uc[j] * cst[k], ldb,
                           ksteps, lane, y0, y1);
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
    }

    // per-pattern max over every row: the rows of a tile by shuffles, the
    // warps of the pattern tile through `red` (two halves, by node parity)
    mx0 = rows_max(mx0);
    mx1 = rows_max(mx1);
    T* rd = red + (i & 1) * w_n * bp + col0;
    if (lane < 4) {
      rd[wq * bp] = mx0;
      rd[wq * bp + 1] = mx1;
    }
    __syncthreads();
    T s0 = rd[0], s1 = rd[1];
    for (int w = 1; w < w_n; ++w) {
      s0 = peel::dmax(s0, rd[w * bp]);
      s1 = peel::dmax(s1, rd[w * bp + 1]);
    }
    if (!(s0 > T(0))) s0 = T(1);
    if (!(s1 > T(0))) s1 = T(1);
    take_scale(acc0, prod0, s0);
    take_scale(acc1, prod1, s1);

    // rescale (by the reciprocal: one division a pattern); the node's tile
    // goes to device memory and stays in `cur`
    const T inv0 = T(1) / s0, inv1 = T(1) / s1;
    T* cw = cur + (i & 1) * xslot + col0;
    T* gp = post + (size_t)sn.x * c_n * s_n * p_n + p0 + col0;
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const int row = urow[j] + trow;
      if (uc[j] >= 0 && row < s_n) {
        const T v0 = x[j][0] * inv0, v1 = x[j][1] * inv1;
        x[j][0] = v0;
        x[j][1] = v1;
        T* d = cw + uc[j] * cst_n + row * ldb;
        d[0] = v0;
        d[1] = v1;
        T* g = gp + (uc[j] * s_n + row) * p_n;
        if (valid0) g[0] = v0;
        if (valid1) g[1] = v1;
      }
    }
  }

  // root: site = sum over rows of wcs * post_root, still in registers (the
  // peel ends at the root)
  T part0 = T(0), part1 = T(0);
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    const int row = urow[j] + trow;
    if (uc[j] >= 0 && row < s_n) {
      const T w = wcs[uc[j] * s_n + row];
      part0 += w * x[j][0];
      part1 += w * x[j][1];
    }
  }
  part0 = rows_sum(part0);
  part1 = rows_sum(part1);
  T* rd = red + (n_int & 1) * w_n * bp + col0;
  if (lane < 4) {
    rd[wq * bp] = part0;
    rd[wq * bp + 1] = part1;
  }
  __syncthreads();
  if (wq == 0 && lane < 4) {
    T site0 = rd[0], site1 = rd[1];
    for (int w = 1; w < w_n; ++w) {
      site0 += rd[w * bp];
      site1 += rd[w * bp + 1];
    }
    if (valid0) out[p0 + col0] = peel::dlog(site0) + T(log(prod0) + acc0);
    if (valid1) out[p0 + col0 + 1] = peel::dlog(site1) + T(log(prod1) + acc1);
  }
}

struct Args {
  const void *tips, *pm, *children, *order, *wcs;
  void *post, *out;
  int n_tips, n_int, c_n, s_n, p_n, bp, w_n, g_n;
  void* stream;
};

template <typename T, int UNITS>
int launch_as(const Args& a, int bp_log2, size_t smem) {
  auto kern = peel_mxu_kernel<T, UNITS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(a.p_n + a.bp - 1) / a.bp, 32 * (a.bp / 8) * a.w_n, smem, (cudaStream_t)a.stream>>>(
      (const T*)a.tips, (const T*)a.pm, (const int*)a.children, (const int*)a.order,
      (const T*)a.wcs, (T*)a.post, (T*)a.out, a.n_tips, a.n_int, a.c_n, a.s_n, a.p_n,
      bp_log2, a.w_n, a.g_n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a) {
  if (a.s_n < 2 || a.s_n > 64 || a.c_n < 1 || a.c_n > 8 || a.n_int < 1 || a.p_n < 1 ||
      a.n_tips != a.n_int + 1 || (a.bp != 8 && a.bp != 16 && a.bp != 32) || a.w_n < 1 ||
      a.g_n < 1 || (2 * a.c_n) % a.g_n != 0 || 32 * (a.bp / 8) * a.w_n > MAX_THREADS ||
      (size_t)a.c_n * a.s_n * a.p_n > 0x7fffffffu)  // offsets within a node are int
    return (int)cudaErrorInvalidValue;
  const int bp_log2 = a.bp == 8 ? 3 : a.bp == 16 ? 4 : 5;
  const int kp = (a.s_n + 3) & ~3, mp = (a.s_n + 7) & ~7;
  const int units = (a.c_n * (mp / 8) + a.w_n - 1) / a.w_n;  // tiles a warp owns
  const size_t xslot = (size_t)a.c_n * kp * (a.bp + 4);
  const size_t mslot = (size_t)a.g_n * mp * pad_ld(kp);
  const size_t smem = (6 * xslot + 2 * mslot + 2 * (size_t)a.w_n * a.bp) * sizeof(T) +
                      (size_t)a.n_int * sizeof(int4);
  if (units > 8 || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (units == 1) return launch_as<T, 1>(a, bp_log2, smem);
  if (units == 2) return launch_as<T, 2>(a, bp_log2, smem);
  if (units <= 4) return launch_as<T, 4>(a, bp_log2, smem);
  return launch_as<T, 8>(a, bp_log2, smem);
}

}  // namespace

#define PEEL_MXU_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* tips, const void* pm, const void* children,       \
                      const void* order, const void* wcs, void* post, void* out,    \
                      int n_tips, int n_int, int c_n, int s_n, int p_n, int bp,     \
                      int w_n, int g_n, void* stream) {                             \
    return launch<T>(Args{tips, pm, children, order, wcs, post, out, n_tips, n_int, \
                          c_n, s_n, p_n, bp, w_n, g_n, stream});                    \
  }

PEEL_MXU_ENTRY(peel_mxu_f64, double)
PEEL_MXU_ENTRY(peel_mxu_f32, float)
