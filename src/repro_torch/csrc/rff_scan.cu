// Per-chunk replay elements for Hopper (sm_90a): the time-blocked half of
// the parallel-in-time replay engine (core/scan.py, mode "blocked").
//
// Replaces repro/kernels/rff_scan.py:
//  * klms_chunk_elements <- rff_klms_chunk_elements_pallas. Per chunk of
//    Tc ticks, the composed affine map theta -> A theta + v of the ticks
//        theta <- theta - mu_eff ((z . theta) - y) z,
//    mu_eff = m mu, or m mu / (eps + z . z) for NKLMS, m = 0 on a masked
//    tick (which then composes the identity).
//  * krls_chunk_elements <- rff_krls_chunk_elements_pallas. Per chunk, the
//    information-form element folded from (1, 0, 0):
//        g <- beta_eff g;  Phi <- beta_eff Phi + m outer(z, z);
//        r <- beta_eff r + (m y) z,
//    beta_eff = beta on a live tick; a masked tick skips its update.
//
// The features z (nc * Tc, D) are made first by the feature-map kernel
// (csrc/rff_features.cu) into device memory; the wrapper launches both,
// so together they compute what the TPU kernel computes,
// (xs, ys, W, b, mu, mask, s) -> (A, v).
//
// KLMS. The TPU kernel folds the ticks one by one into a (D, D)
// accumulator resident in VMEM (row = z A; A <- A - mu_eff outer(z, row)).
// On this card that is a chain of Tc dependent passes over 16 MB. The
// product of the Tc rank-1 maps has a closed form instead (compact WY):
// with Z (Tc, D) the chunk's features, G = Z Z^T, L its strictly lower
// part and D_mu = diag(mu_eff),
//     T = (I + D_mu L)^-1 D_mu    (Tc x Tc, lower triangular),
//     A = I - Z^T (T Z),   v = Z^T c,   c = T y,
// since row t of T is mu_t (e_t - sum_{j<t} G_tj T_j), the fold's own
// recursion in the chunk's coordinates. A call runs four phases over a
// group of chunks (as many as the wrapper's workspace holds), each one
// launch over all of them:
//  1. Gram (gram_kernel): the lower 64 x 64 tiles of G, K = D split into
//     slabs of `ks` columns (a block a tile and slab, at most 16 slabs;
//     the partial tiles go to the workspace), each slab loaded into shared
//     memory 128 columns at a time. The diagonal tiles' blocks also copy
//     Z, zero-padded to (Tcp, Dp), for phases 3 and 4.
//  2. Solve. diag_kernel adds each lower tile's partials in slab order;
//     a diagonal tile's block takes mu_eff from G's diagonal and solves
//     its 64 x 64 block T_rr = (I + D_r L_rr)^-1 D_r by forward
//     substitution, a thread a column, with no barrier. off_kernel then
//     fills the rest of T, 16 columns a block: below the columns' own
//     block, X_r = T_rr (B_r - sum_{q<r} G_rq X_q) with B = I, a row
//     block at a time, each step 64 x 64 x 16 products through shared
//     memory. One more block takes B = [y, 0, ...] and gives c = T y.
//     The chain is Tc / 64 steps long, not Tc.
//  3. T Z (tz_kernel): Y = T Z in 64 x 64 tiles, T's blocks above its
//     diagonal skipped; one more row of blocks forms v = Z^T c.
//  4. The product (gemm_kernel): A = I - Z^T Y, (D x Tc) (Tc x D), on the
//     feature tile (feature_tile.cuh; the padded Z is its transposed x, Y
//     its W): 128 x 128 tiles, 8 x 8 a thread, a three-stage cp.async
//     ring; the epilogue writes (row == col) - acc.
// What bounds it: operations. The last product is 2 D^2 Tc (2.1 GFLOP at
// Tc = 256, D = 2048), the Gram's lower tiles about Tc (Tc + 64) D and
// T Z Tc^2 D more, against the
// fold's 4 D^2 Tc; A (16.8 MB there) is written once.
// Exactness: every element is a fixed-order chain of fmaf from +0 (the
// Gram's slabs, fixed by D alone, added in order); no atomics, so two
// runs agree bit for bit and a chunk's element depends on its own ticks
// alone. A masked or padded tick has mu_eff = 0, so its row and column of
// T and its entry of c are exact zeros: a fully masked chunk gives A = I
// and v = 0 exactly. Padded features are zeros. The element is not bit
// for bit the fold's (another summation order): within 1e-4 of it, and
// no farther from a float64 fold than the f32 fold is at the replay shape.
// IEEE f32 throughout (no TF32, no fast math); 64-bit offsets.
//
// KRLS. Phi <- beta Phi + m z z^T is elementwise, so a block owns a
// 64 x 64 tile of one chunk's Phi in registers (16 values a thread) and
// reads z_i, z_j from L2 each tick; one extra block per chunk folds g and
// r. A KRLS tick is 4 D^2 elementwise operations: bound by operations.
// Each update uses _rn intrinsics in the reference's operation order (no
// contraction). Ragged D by bounds checks.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_runtime.h>

#include "feature_tile.cuh"

namespace {

namespace ft = feature_tile;

constexpr int kThreads = 256;
constexpr int kTile = 64;                 // KRLS Phi tile edge
constexpr int kTileRows = kThreads / 32;  // rows covered per pass (8)

// ---------------------------------------------------------------- KLMS (WY)

constexpr int kB = 64;          // G's tiles, T's blocks, Y's tiles
constexpr int kKT = 16;         // k a step of the 64 x 64 products
constexpr int kPitch = kB + 4;  // shared rows of 64 (16-byte aligned)
constexpr int kSlab = 16;       // columns of T (or of [c, 0 ...]) a block
constexpr int kSplitCols = 128; // the Gram's K slabs are multiples of this
constexpr int kMaxSplits = 16;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The Tc and D a call takes.
constexpr int kMaxTc = 1 << 14, kMaxD = 1 << 22;

// One chunk's padded extents and workspace (floats).
struct Plan {
  int tc, D;     // ticks a chunk, features
  int tcp, dp;   // tc rounded up to kB, D to the feature tile's 128
  int nt, ntl;   // T's row blocks, G's lower tiles (diagonal included)
  int ks, nsplit;  // the Gram's K slab and slab count (fixed by D)
  int ldt;       // row stride of [T | c, 0 ...]: tcp + kSlab
  size_t zp, yp, gpart, g, tcm;  // floats a chunk of each buffer
  __host__ __device__ size_t chunk_floats() const {
    return zp + yp + gpart + g + tcm;
  }
};

__host__ __device__ inline Plan make_plan(int tc, int D) {
  Plan p;
  p.tc = tc;
  p.D = D;
  p.tcp = round_up(tc, kB);
  p.dp = round_up(D, ft::kN);
  p.nt = p.tcp / kB;
  p.ntl = p.nt * (p.nt + 1) / 2;
  const int cols = p.dp / kSplitCols;
  const int want = cols < kMaxSplits ? cols : kMaxSplits;
  p.ks = (cols + want - 1) / want * kSplitCols;
  p.nsplit = (p.dp + p.ks - 1) / p.ks;
  p.ldt = p.tcp + kSlab;
  p.zp = (size_t)p.tcp * p.dp;          // Z padded (Tcp, Dp)
  p.yp = (size_t)(p.tcp + 2) * p.dp;    // Y, and the tile's two unused rows
  p.gpart = (size_t)p.ntl * p.nsplit * kB * kB;  // the Gram's partials
  p.g = (size_t)p.tcp * p.tcp;          // G's lower off-diagonal tiles
  p.tcm = (size_t)p.tcp * p.ldt;        // [T | c, 0 ...]
  return p;
}

// A group's buffers, each ng chunks long.
struct Bufs {
  float *zp, *yp, *gpart, *g, *tcm;
};

inline Bufs carve(float* ws, const Plan& p, int ng) {
  Bufs b;
  b.zp = ws;
  b.yp = b.zp + p.zp * ng;
  b.gpart = b.yp + p.yp * ng;
  b.g = b.gpart + p.gpart * ng;
  b.tcm = b.g + p.g * ng;
  return b;
}

// Lower tile `lin` = ti (ti + 1) / 2 + tj, tj <= ti.
__device__ __forceinline__ void lower_tile(int lin, int& ti, int& tj) {
  int i = 0;
  while ((i + 1) * (i + 2) / 2 <= lin) ++i;
  ti = i;
  tj = lin - i * (i + 1) / 2;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][j] += sum over k < kKT, in order, of xs[k][ty 4 + i] ws[k][tx 4 + j].
__device__ __forceinline__ void tile_step(float (*xs)[kPitch],
                                          float (*ws)[kPitch], int ty, int tx,
                                          float (&acc)[4][4]) {
#pragma unroll
  for (int k = 0; k < kKT; ++k) {
    const float4 a = ld4(&xs[k][ty * 4]);
    const float4 b = ld4(&ws[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  }
}

// Phase 1. Grid (ntl, nsplit, ng): tile (ti, tj) of G over K slab `split`,
// partial[r][c] = sum over k of the slab, in order, of Z[ti 64 + r][k]
// Z[tj 64 + c][k]. The slab comes in pieces of kPiece columns: a piece of
// both row blocks is loaded at once (Z read with bounds: rows past tc,
// columns past D are zero), stored transposed, then summed with no
// barrier in between. A diagonal tile's block loads one row block and also writes it
// into zp.
constexpr int kPiece = 128;
constexpr size_t kGramSmem = sizeof(float) * 2 * kPiece * kPitch;

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ z, float* __restrict__ zp,
            float* __restrict__ gpart, Plan p) {
  extern __shared__ __align__(16) float gsm[];
  float (*xs)[kPitch] = reinterpret_cast<float (*)[kPitch]>(gsm);
  const int lin = blockIdx.x, split = blockIdx.y, chunk = blockIdx.z;
  int ti, tj;
  lower_tile(lin, ti, tj);
  const bool diag = ti == tj;
  float (*ws)[kPitch] = diag ? xs : xs + kPiece;
  const float* zc = z + (size_t)chunk * p.tc * p.D;
  float* zpc = zp + (size_t)chunk * p.zp;
  const int k_end = min((split + 1) * p.ks, p.dp);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // ks and dp are multiples of kPiece, so every piece is whole.
  for (int k0 = split * p.ks; k0 < k_end; k0 += kPiece) {
    // Element e of a row block's piece: row e / kPiece, column e % kPiece,
    // so that consecutive threads read consecutive floats of a row.
#pragma unroll
    for (int h = 0; h < kB * kPiece / kThreads; ++h) {
      const int e = threadIdx.x + kThreads * h;
      const int r = e / kPiece, kk = e % kPiece, k = k0 + kk;
      const int ri = ti * kB + r;
      const float v =
          (ri < p.tc && k < p.D) ? __ldg(zc + (size_t)ri * p.D + k) : 0.f;
      xs[kk][r] = v;
      if (diag) zpc[(size_t)ri * p.dp + k] = v;
    }
    if (!diag) {
#pragma unroll
      for (int h = 0; h < kB * kPiece / kThreads; ++h) {
        const int e = threadIdx.x + kThreads * h;
        const int r = e / kPiece, kk = e % kPiece, k = k0 + kk;
        const int rj = tj * kB + r;
        ws[kk][r] =
            (rj < p.tc && k < p.D) ? __ldg(zc + (size_t)rj * p.D + k) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kPiece; k += kKT) tile_step(xs + k, ws + k, ty, tx, acc);
    __syncthreads();  // the next piece overwrites the tiles
  }
  float* out =
      gpart + (((size_t)chunk * p.ntl + lin) * p.nsplit + split) * kB * kB;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st4(out + (ty * 4 + i) * kB + tx * 4, acc[i][0], acc[i][1], acc[i][2],
        acc[i][3]);
}

// Phase 2a. Grid (ntl, 1, ng): blocks 0 .. nt - 1 own G's diagonal tiles,
// the rest its lower off-diagonal ones (ti > tj, in the order ti (ti - 1)
// / 2 + tj). Each sums its tile's partials in slab order; an off-diagonal
// block writes the tile to g, a diagonal one forms mu_eff for its 64 ticks
// and solves T_rr, writing it (zeros above its diagonal) into tcm.
__global__ void __launch_bounds__(kThreads)
diag_kernel(const float* __restrict__ gpart, float* __restrict__ g,
            float* __restrict__ tcm, const float* __restrict__ mask, Plan p,
            float mu, int normalized, float eps) {
  __shared__ float gs[kB][kB + 1];
  __shared__ float mus[kB];
  const int chunk = blockIdx.z;
  const bool diag = (int)blockIdx.x < p.nt;
  int ti, tj;
  if (diag) {
    ti = tj = blockIdx.x;
  } else {
    const int q = blockIdx.x - p.nt;
    int i = 1;
    while (i * (i + 1) / 2 <= q) ++i;
    ti = i;
    tj = q - i * (i - 1) / 2;
  }
  const float* part = gpart + ((size_t)chunk * p.ntl + ti * (ti + 1) / 2 + tj) *
                                  p.nsplit * kB * kB;
  float* gc = g + (size_t)chunk * p.g;
  // Element e = tid + kThreads h of the tile, its partials added in slab
  // order; a slab's 16 loads a thread are issued together.
  constexpr int kPer = kB * kB / kThreads;
  float v[kPer];
#pragma unroll
  for (int h = 0; h < kPer; ++h) v[h] = 0.f;
#pragma unroll 2
  for (int s = 0; s < p.nsplit; ++s) {
    const float* ps = part + (size_t)s * kB * kB + threadIdx.x;
    float u[kPer];
#pragma unroll
    for (int h = 0; h < kPer; ++h) u[h] = __ldg(ps + kThreads * h);
#pragma unroll
    for (int h = 0; h < kPer; ++h) v[h] = __fadd_rn(v[h], u[h]);
  }
#pragma unroll
  for (int h = 0; h < kPer; ++h) {
    const int e = threadIdx.x + kThreads * h;
    const int r = e / kB, c = e % kB;
    if (diag)
      gs[r][c] = v[h];
    else
      gc[(size_t)(ti * kB + r) * p.tcp + tj * kB + c] = v[h];
  }
  if (!diag) return;
  __syncthreads();
  if (threadIdx.x < kB) {
    const int t = ti * kB + threadIdx.x;
    float m = 0.f;
    if (t < p.tc) m = mask ? __ldg(mask + (size_t)chunk * p.tc + t) : 1.f;
    float mu_t = mu;
    if (normalized)
      mu_t = __fdiv_rn(mu, __fadd_rn(eps, gs[threadIdx.x][threadIdx.x]));
    // A padded tick's z is 0, so at eps = 0 its mu_t is inf: select.
    mus[threadIdx.x] = m == 0.f ? 0.f : __fmul_rn(m, mu_t);
  }
  __syncthreads();
  if (threadIdx.x >= kB) return;
  // Column j of T_rr: x_i = mu_i (delta_ij - sum_{l<i} G_il x_l), the sums
  // carried forward (acc[l] gains G_li x_i once x_i is known), in order.
  const int j = threadIdx.x;
  float acc[kB];
#pragma unroll
  for (int l = 0; l < kB; ++l) acc[l] = 0.f;
  float* out = tcm + (size_t)chunk * p.tcm + (size_t)(ti * kB) * p.ldt +
               ti * kB + j;
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const float x = __fmul_rn(mus[i], __fsub_rn(i == j ? 1.f : 0.f, acc[i]));
    out[(size_t)i * p.ldt] = x;
#pragma unroll
    for (int l = i + 1; l < kB; ++l) acc[l] = __fmaf_rn(gs[l][i], x, acc[l]);
  }
}

// Phase 2b. Grid (tcp / kSlab + 1, 1, ng). Block x < tcp / kSlab owns
// columns x 16 .. x 16 + 15 of T, in column block cb; for each row block
// r > cb, X_r = T_rr (-sum_{q = cb}^{r-1} G_rq X_q), X_cb the diagonal
// block's columns. The last block solves B = [y, 0 ...] from r = 0 into
// columns tcp .. tcp + 15 of tcm: c = T y, then zeros. A thread owns row
// i = tid / 4 and columns 4 (tid % 4) .. + 3 of a step's (64, 16) block;
// each sum runs over k in order. X_q is read back from tcm (written by
// diag_kernel or by this block before a barrier).
__global__ void __launch_bounds__(kThreads)
off_kernel(const float* __restrict__ g, float* tcm,
           const float* __restrict__ ys, Plan p) {
  __shared__ __align__(16) float gs[kB][kPitch];  // G_rq, then T_rr
  __shared__ __align__(16) float xs[kB][kSlab];   // X_q, then B_r - sum
  const int chunk = blockIdx.z;
  const bool rhs_y = (int)blockIdx.x == p.tcp / kSlab;
  const int col0 = blockIdx.x * kSlab;
  const int cb = rhs_y ? -1 : col0 / kB;
  const float* gc = g + (size_t)chunk * p.g;
  float* tc = tcm + (size_t)chunk * p.tcm;
  const int i = threadIdx.x / 4, cq = (threadIdx.x % 4) * 4;
  // A 64 x 64 tile moves through registers, 4 float4s a thread (row e /
  // 16, columns 4 (e % 16) .., e = tid + kThreads h), so that the next
  // tile's loads are in flight while this one is summed.
  constexpr int kQuads = kB * kB / 4 / kThreads;
  auto fetch = [&](float4 (&v)[kQuads], const float* src, size_t ld) {
#pragma unroll
    for (int h = 0; h < kQuads; ++h) {
      const int e = threadIdx.x + kThreads * h;
      v[h] = ld4(src + (e / (kB / 4)) * ld + (e % (kB / 4)) * 4);
    }
  };
  auto stash = [&](const float4 (&v)[kQuads]) {
#pragma unroll
    for (int h = 0; h < kQuads; ++h) {
      const int e = threadIdx.x + kThreads * h;
      *reinterpret_cast<float4*>(&gs[e / (kB / 4)][(e % (kB / 4)) * 4]) = v[h];
    }
  };
  float4 gv[kQuads], tv[kQuads], xv;
  for (int r = cb + 1; r < p.nt; ++r) {
    const int q0 = cb < 0 ? 0 : cb;
    const float* grow = gc + (size_t)(r * kB) * p.tcp;
    fetch(tv, tc + (size_t)(r * kB) * p.ldt + r * kB, p.ldt);  // T_rr
    if (q0 < r) {
      fetch(gv, grow + q0 * kB, p.tcp);
      xv = ld4(tc + (size_t)(q0 * kB + i) * p.ldt + col0 + cq);
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = q0; q < r; ++q) {
      stash(gv);
      *reinterpret_cast<float4*>(&xs[i][cq]) = xv;
      __syncthreads();
      if (q + 1 < r) {
        fetch(gv, grow + (q + 1) * kB, p.tcp);
        xv = ld4(tc + (size_t)((q + 1) * kB + i) * p.ldt + col0 + cq);
      }
#pragma unroll 4
      for (int k = 0; k < kB; k += 4) {
        const float4 g4 = ld4(&gs[i][k]);
        const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 x4 = ld4(&xs[k + kk][cq]);
          acc[0] = __fmaf_rn(ga[kk], x4.x, acc[0]);
          acc[1] = __fmaf_rn(ga[kk], x4.y, acc[1]);
          acc[2] = __fmaf_rn(ga[kk], x4.z, acc[2]);
          acc[3] = __fmaf_rn(ga[kk], x4.w, acc[3]);
        }
      }
      __syncthreads();
    }
    const int t = r * kB + i;
    const float y0 = (rhs_y && cq == 0 && t < p.tc)
                         ? __ldg(ys + (size_t)chunk * p.tc + t) : 0.f;
    st4(&xs[i][cq], __fsub_rn(y0, acc[0]), __fsub_rn(0.f, acc[1]),
        __fsub_rn(0.f, acc[2]), __fsub_rn(0.f, acc[3]));
    stash(tv);
    __syncthreads();
    float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int l = 0; l < kB; l += 4) {
      const float4 t4 = ld4(&gs[i][l]);
      const float ta[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
      for (int ll = 0; ll < 4; ++ll) {
        const float4 w4 = ld4(&xs[l + ll][cq]);
        x[0] = __fmaf_rn(ta[ll], w4.x, x[0]);
        x[1] = __fmaf_rn(ta[ll], w4.y, x[1]);
        x[2] = __fmaf_rn(ta[ll], w4.z, x[2]);
        x[3] = __fmaf_rn(ta[ll], w4.w, x[3]);
      }
    }
    st4(tc + (size_t)t * p.ldt + col0 + cq, x[0], x[1], x[2], x[3]);
    __syncthreads();  // gs and xs are restaged; X_r is read back next step
  }
}

// Phase 3. Grid (dp / 64, nt + 1, ng). Row y < nt: the tile Y[y 64 ..][x
// 64 ..] = sum over k < (y + 1) 64 of T[i][k] Zp[k][b] (T row-major in
// tcm, Zp as packed). Row y == nt: v[x 64 + c] = sum over t of Zp[t][x 64
// + c] c_t, four quarters of t in order, then added in order.
__global__ void __launch_bounds__(kThreads)
tz_kernel(const float* __restrict__ tcm, const float* __restrict__ zp,
          float* __restrict__ yp, float* __restrict__ v_out, Plan p) {
  __shared__ __align__(16) float xs[2][kKT][kPitch];
  __shared__ __align__(16) float ws[2][kKT][kPitch];
  const int chunk = blockIdx.z;
  const float* tc = tcm + (size_t)chunk * p.tcm;
  const float* zc = zp + (size_t)chunk * p.zp;
  if ((int)blockIdx.y == p.nt) {
    float* part = &xs[0][0][0];  // [4][kB]
    const int quarter = threadIdx.x / kB, c = threadIdx.x % kB;
    const int a = blockIdx.x * kB + c;
    const int len = p.tcp / 4;
    float acc = 0.f;
    for (int t = quarter * len; t < (quarter + 1) * len; ++t)
      acc = __fmaf_rn(__ldg(zc + (size_t)t * p.dp + a),
                      __ldg(tc + (size_t)t * p.ldt + p.tcp), acc);
    part[quarter * kB + c] = acc;
    __syncthreads();
    if (quarter == 0 && a < p.D) {
      float v = part[c];
      for (int h = 1; h < 4; ++h) v = __fadd_rn(v, part[h * kB + c]);
      v_out[(size_t)chunk * p.D + a] = v;
    }
    return;
  }
  const int i0 = blockIdx.y * kB, b0 = blockIdx.x * kB;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // A thread's float4 of T (row r, k 4 kq ..) and of Zp (row kk, columns
  // 4 cq ..) a step.
  const int r = threadIdx.x / 4, kq = (threadIdx.x % 4) * 4;
  const int kk = threadIdx.x / 16, cq = (threadIdx.x % 16) * 4;
  float4 xv, wv;
  auto fetch = [&](int k0) {
    xv = __ldg(reinterpret_cast<const float4*>(tc + (size_t)(i0 + r) * p.ldt +
                                               k0 + kq));
    wv = __ldg(reinterpret_cast<const float4*>(zc + (size_t)(k0 + kk) * p.dp +
                                               b0 + cq));
  };
  auto stash = [&](int buf) {
    xs[buf][kq][r] = xv.x;
    xs[buf][kq + 1][r] = xv.y;
    xs[buf][kq + 2][r] = xv.z;
    xs[buf][kq + 3][r] = xv.w;
    *reinterpret_cast<float4*>(&ws[buf][kk][cq]) = wv;
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int steps = (i0 + kB) / kKT;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) fetch((s + 1) * kKT);
    tile_step(xs[buf], ws[buf], ty, tx, acc);
    if (s + 1 < steps) stash(buf ^ 1);
    __syncthreads();
  }
  float* out = yp + (size_t)chunk * p.yp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st4(out + (size_t)(i0 + ty * 4 + i) * p.dp + b0 + tx * 4, acc[i][0],
        acc[i][1], acc[i][2], acc[i][3]);
}

// Phase 4. Grid (dp / 128, dp / 128, ng): A[a][b] = (a == b) - sum over t
// of Zp[t][a] Y[t][b] for one 128 x 128 tile, on the feature tile.
__global__ void __launch_bounds__(ft::kThreads, ft::kMinBlocks)
gemm_kernel(const float* __restrict__ zp, const float* __restrict__ yp,
            float* __restrict__ a_out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ft::Smem& s = *reinterpret_cast<ft::Smem*>(smem_raw);
  const int chunk = blockIdx.z;
  const int row0 = blockIdx.x * ft::kM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const ft::Walk wk{zp + (size_t)chunk * p.zp, yp + (size_t)chunk * p.yp,
                    p.dp, p.dp, p.tcp / ft::kK, row0, (int)blockIdx.y, 1};
  float* ac = a_out + (size_t)chunk * p.D * p.D;
  const bool vec = (p.D & 3) == 0;  // rows of A start on 16 bytes
  ft::walk(s, wk, [&](int col0, int, float (&acc)[8][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ft::row_of(ty, i);
      if (row >= p.D) continue;
      float* ar = ac + (size_t)row * p.D;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + ft::col_of(tx, 4 * h);
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = __fsub_rn(row == col + c ? 1.f : 0.f, acc[i][4 * h + c]);
        if (vec && col < p.D) {
          st4(ar + col, v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (col + c < p.D) ar[col + c] = v[c];
        }
      }
    }
  });
}

// The four phases over all nc chunks, ws_floats / chunk_floats() chunks
// (at most 65535) a group.
int klms_run(const float* z, const float* ys, const float* mask,
             float* a_out, float* v_out, float* ws, long long ws_floats,
             int nc, int tc, int D, float mu, int normalized, float eps,
             cudaStream_t st) {
  if (nc < 0 || tc < 1 || D < 1 || tc > kMaxTc || D > kMaxD)
    return cudaErrorInvalidValue;
  if (nc == 0) return cudaSuccess;
  const Plan p = make_plan(tc, D);
  const long long per = (long long)p.chunk_floats();
  if (ws_floats < per) return cudaErrorInvalidValue;
  const long long fit = ws_floats / per;
  const int group = fit < 65535 ? (int)fit : 65535;
  cudaError_t rc = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ft::smem_bytes());
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(gram_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)kGramSmem);
  if (rc != cudaSuccess) return rc;
  for (int c0 = 0; c0 < nc; c0 += group) {
    const int ng = nc - c0 < group ? nc - c0 : group;
    const Bufs b = carve(ws, p, ng);
    const size_t t0 = (size_t)c0 * tc;
    gram_kernel<<<dim3(p.ntl, p.nsplit, ng), kThreads, kGramSmem, st>>>(
        z + t0 * D, b.zp, b.gpart, p);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    diag_kernel<<<dim3(p.ntl, 1, ng), kThreads, 0, st>>>(
        b.gpart, b.g, b.tcm, mask ? mask + t0 : nullptr, p, mu, normalized,
        eps);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    off_kernel<<<dim3(p.tcp / kSlab + 1, 1, ng), kThreads, 0, st>>>(
        b.g, b.tcm, ys + t0, p);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    tz_kernel<<<dim3(p.dp / kB, p.nt + 1, ng), kThreads, 0, st>>>(
        b.tcm, b.zp, b.yp, v_out + (size_t)c0 * D, p);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    gemm_kernel<<<dim3(p.dp / ft::kM, p.dp / ft::kN, ng), ft::kThreads,
                  ft::smem_bytes(), st>>>(b.zp, b.yp,
                                          a_out + (size_t)c0 * D * D, p);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------- KRLS

// Grid (tiles + 1, nc), tiles = ceil(D / 64)^2. Block x < tiles owns one
// 64 x 64 tile of chunk y's Phi; block x == tiles folds g and r.
__global__ void __launch_bounds__(kThreads)
krls_elements_kernel(const float* __restrict__ z, const float* __restrict__ ys,
                     const float* __restrict__ mask, float beta,
                     float* __restrict__ g_out, float* __restrict__ phi_out,
                     float* __restrict__ r_out, int tc, int D) {
  extern __shared__ float r_s[];  // [D], the g/r block only
  const int chunk = blockIdx.y;
  const int edge = (D + kTile - 1) / kTile;
  const int tiles = edge * edge;

  if ((int)blockIdx.x == tiles) {  // ---- g and r block
    for (int i = threadIdx.x; i < D; i += kThreads) r_s[i] = 0.f;
    float g = 1.f;
    for (int t = 0; t < tc; ++t) {
      const size_t row = (size_t)chunk * tc + t;
      const float m = mask ? __ldg(mask + row) : 1.f;
      if (m == 0.f) continue;
      const float my = __fmul_rn(m, __ldg(ys + row));
      const float* zt = z + row * D;
      g = __fmul_rn(g, beta);
      for (int i = threadIdx.x; i < D; i += kThreads)
        r_s[i] = __fadd_rn(__fmul_rn(beta, r_s[i]), __fmul_rn(my, __ldg(zt + i)));
    }
    for (int i = threadIdx.x; i < D; i += kThreads)
      r_out[(size_t)chunk * D + i] = r_s[i];
    if (threadIdx.x == 0) g_out[chunk] = g;
    return;
  }

  // ---- Phi tile block: rows r0 + ty + 8 k, columns c0 + tx + 32 l.
  const int r0 = (blockIdx.x / edge) * kTile;
  const int c0 = (blockIdx.x % edge) * kTile;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  constexpr int kRowsPer = kTile / kTileRows;  // 8
  constexpr int kColsPer = kTile / 32;         // 2
  float phi[kRowsPer][kColsPer];
#pragma unroll
  for (int k = 0; k < kRowsPer; ++k)
#pragma unroll
    for (int l = 0; l < kColsPer; ++l) phi[k][l] = 0.f;
  for (int t = 0; t < tc; ++t) {
    const size_t row = (size_t)chunk * tc + t;
    const float m = mask ? __ldg(mask + row) : 1.f;
    if (m == 0.f) continue;
    const float* zt = z + row * D;
    float zc[kColsPer];
#pragma unroll
    for (int l = 0; l < kColsPer; ++l) {
      const int c = c0 + tx + 32 * l;
      zc[l] = c < D ? __ldg(zt + c) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kRowsPer; ++k) {
      const int r = r0 + ty + kTileRows * k;
      const float zr = r < D ? __ldg(zt + r) : 0.f;
#pragma unroll
      for (int l = 0; l < kColsPer; ++l)
        phi[k][l] = __fadd_rn(__fmul_rn(beta, phi[k][l]),
                              __fmul_rn(m, __fmul_rn(zr, zc[l])));
    }
  }
  float* dst = phi_out + (size_t)chunk * D * D;
#pragma unroll
  for (int k = 0; k < kRowsPer; ++k) {
    const int r = r0 + ty + kTileRows * k;
    if (r >= D) continue;
#pragma unroll
    for (int l = 0; l < kColsPer; ++l) {
      const int c = c0 + tx + 32 * l;
      if (c < D) dst[(size_t)r * D + c] = phi[k][l];
    }
  }
}

}  // namespace

extern "C" {

// z (nc * tc, D), ys and mask (nc * tc) (mask may be null: every tick
// live); a_out (nc, D, D), v_out (nc, D); ws a workspace of ws_floats
// floats, at least one chunk's (klms_element_chunk_floats), 16-byte
// aligned. Tc <= 16384, D <= 4194304.
int klms_chunk_elements(const float* z, const float* ys, const float* mask,
                        float* a_out, float* v_out, float* ws,
                        long long ws_floats, int nc, int tc, int D, float mu,
                        int normalized, float eps, void* stream) {
  return klms_run(z, ys, mask, a_out, v_out, ws, ws_floats, nc, tc, D, mu,
                  normalized, eps, static_cast<cudaStream_t>(stream));
}

// Floats of one chunk's workspace at (tc, D); 0 outside the Tc <= 16384
// and D <= 4194304 a call takes.
long long klms_element_chunk_floats(int tc, int D) {
  if (tc < 1 || D < 1 || tc > kMaxTc || D > kMaxD) return 0;
  return (long long)make_plan(tc, D).chunk_floats();
}

// z (nc * tc, D), ys and mask (nc * tc) (mask may be null); g_out (nc,),
// phi_out (nc, D, D), r_out (nc, D).
int krls_chunk_elements(const float* z, const float* ys, const float* mask,
                        float beta, float* g_out, float* phi_out,
                        float* r_out, int nc, int tc, int D, void* stream) {
  if (nc < 0 || tc < 1 || D < 1) return cudaErrorInvalidValue;
  if (nc == 0) return cudaSuccess;
  const long long edge = (D + kTile - 1) / kTile;
  if (nc > 65535 || edge * edge + 1 > 2147483647LL)
    return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (size_t)D;
  cudaError_t rc = cudaFuncSetAttribute(
      krls_elements_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return rc;
  const dim3 grid((unsigned)(edge * edge + 1), nc);
  krls_elements_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      z, ys, mask, beta, g_out, phi_out, r_out, tc, D);
  return cudaGetLastError();
}

const char* rff_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
