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
//    beta_eff = beta on a live tick (m > 0), 1 on a masked one.
//
// The features z (nc * Tc, D) are made first by the feature-map kernel
// (csrc/rff_features.cu) into device memory; the wrapper launches both,
// so together they compute what the TPU kernel computes,
// (xs, ys, W, b, mu, mask, s) -> (A, v), or (g, Phi, r).
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
// KRLS. The fold (g, Phi, r) <- (beta_eff g, beta_eff Phi + m z z^T,
// beta_eff r + (m y) z) from (1, 0, 0) has a closed form too: with n_t the
// live ticks after t and w_t = m_t beta^(n_t),
//     Phi = Z^T diag(w) Z,   r = Z^T (w y),   g = beta^(live ticks).
// So the TPU kernel's Tc dependent passes over a (D, D) accumulator (a
// chain of Tc L2 round trips a tile on this card) become one weighted
// Gram, a (D, Tc) (Tc, D) product. A call runs two launches over a group
// of chunks:
//  1. krls_prep_kernel: the weights by a suffix chain of f32 multiplies
//     (and g, bit for bit the fold's), then Zp = Z and Yp = [w Z | c, 0,
//     ...] with c = w y, zero-padded so that the product copies 16 bytes
//     unchecked.
//  2. The product: only the lower tiles of Phi = Zp^T (w Z), each element
//     stored with its mirror image, so Phi equals Phi^T bit for bit (w_t
//     z_ti z_tj summed as z_i (w z_j) is not symmetric under
//     transposition) and the work halves; one more tile a row of tiles,
//     Zp^T [c, 0, ...], gives r in its first column. The tiles are 64 x 64
//     or 32 x 32 (krls_tile), on the feature tile's discipline (cp.async
//     copies of 16 bytes through a ring, fixed-order fmaf chains) with a
//     deeper ring: at the paper's D = 300 the feature tile's 128 x 128
//     gives 6 blocks for 132 SMs, and at D = 2048 its 136 leave most SMs
//     with one block and a few with two; it ran slower at both.
// What bounds it: operations, D (D + 1) Tc for the lower triangle (1.07
// GFLOP at Tc = 256, D = 2048), against the fold's 3 D^2 Tc.
// Exactness: every element of Phi and r is one chain of fmaf over t in
// order from +0, whatever the tile (the product's tile changes no bit);
// no split-K, no atomics, so two calls agree and a chunk's element depends
// on its own ticks alone. A masked or padded tick has w_t = 0, so every
// term it adds is an exact zero: a fully masked chunk is (1, 0, 0) and a
// remainder chunk equals its live ticks alone. Not bit for bit the fold
// (another rounding sequence): within 1e-4 of it, and no farther from a
// float64 fold than twice the f32 fold is.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_runtime.h>

#include "feature_tile.cuh"

namespace {

namespace ft = feature_tile;

constexpr int kThreads = 256;

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

constexpr int kPrepRows = 16;    // ticks a prep block
constexpr int kPrepCols = 128;   // features a prep block
constexpr int kWave = 132;       // SMs of an H100 SXM: blocks a wave

// One chunk's padded extents and workspace (floats).
struct KPlan {
  int tc, D;
  int tcp, dp;  // tc rounded up to a k-step, D to a prep block
  int ldy;      // Y's row: dp columns of w Z, then 128 of [c, 0, ...]
  size_t zp, yp;  // floats a chunk: Z and Y padded
  __host__ __device__ size_t chunk_floats() const { return zp + yp; }
};

__host__ __device__ inline KPlan make_kplan(int tc, int D) {
  KPlan p;
  p.tc = tc;
  p.D = D;
  p.tcp = round_up(tc, kKT);
  p.dp = round_up(D, kPrepCols);
  p.ldy = p.dp + kPrepCols;
  p.zp = (size_t)p.tcp * p.dp;   // Z (Tcp, Dp)
  p.yp = (size_t)p.tcp * p.ldy;  // Y (Tcp, Dp + 128)
  return p;
}

// Weights and operands. Grid (dp / 128 + 1, tcp / 16, ng), one block a 16
// ticks x 128 features piece (the last column of blocks fills Y's [c, 0,
// ...] columns). The weights of the block's ticks: with n_t
// the live ticks (m > 0) after t, w_t = m_t beta^(n_t) (0 past tc). The
// block counts the live ticks after its own (a block-wide count), its
// rows' n_t by a ballot, and one thread takes the powers of beta up to
// the largest n it needs as the suffix chain does, repeated __fmul_rn
// from 1 (no table: it keeps the at most 17 powers its rows use). The
// block of the first ticks and features runs the chain on to the chunk's
// live count and writes g, the fold's g bit for bit (the same products
// from 1, in the same order). Then Zp[t][a] = z[t][a] (0 past tc or D),
// Yp[t][a] = w_t Zp[t][a], and Yp[t][dp] = c_t = w_t y_t (0 past tc), the
// rest of those 128 columns 0.
__global__ void __launch_bounds__(kThreads)
krls_prep_kernel(const float* __restrict__ z, const float* __restrict__ ys,
                 const float* __restrict__ mask, float beta,
                 float* __restrict__ zp, float* __restrict__ yp,
                 float* __restrict__ g_out, KPlan p) {
  __shared__ float w[kPrepRows];
  __shared__ float pw[kPrepRows + 1];  // beta^(after + i)
  const int chunk = blockIdx.z;
  const int t0 = blockIdx.y * kPrepRows, c0 = blockIdx.x * kPrepCols;
  const size_t row0 = (size_t)chunk * p.tc;
  auto m_at = [&](int t) { return mask ? __ldg(mask + row0 + t) : 1.f; };
  int after = 0;  // live ticks after the block's
  for (int t1 = t0 + kPrepRows; t1 < p.tc; t1 += kThreads) {
    const int t = t1 + threadIdx.x;
    after += __syncthreads_count(t < p.tc && m_at(t) > 0.f);
  }
  if (threadIdx.x < 32) {
    const int t = t0 + threadIdx.x;
    const bool own = threadIdx.x < kPrepRows && t < p.tc;
    const float m = own ? m_at(t) : 0.f;
    const unsigned live =
        __ballot_sync(0xffffffffu, own && m > 0.f) & ((1u << kPrepRows) - 1);
    // n_t for lane i: after + the live ticks among lanes i + 1 .. 15.
    const int n = after + __popc(live >> threadIdx.x >> 1);
    const bool first = blockIdx.x == 0 && blockIdx.y == 0;
    const int top = after + (first ? __popc(live) : __popc(live >> 1));
    if (threadIdx.x == 0) {
      float q = 1.f;
      if (after == 0) pw[0] = q;
#pragma unroll 4
      for (int k = 1; k <= top; ++k) {
        q = __fmul_rn(q, beta);
        if (k >= after) pw[k - after] = q;
      }
      if (first) g_out[chunk] = q;
    }
    __syncwarp();
    if (threadIdx.x < kPrepRows)
      w[threadIdx.x] = own ? __fmul_rn(m, pw[n - after]) : 0.f;
  }
  __syncthreads();
  float* zc = zp + (size_t)chunk * p.zp;
  float* yc = yp + (size_t)chunk * p.yp;
  if (c0 == p.dp) {  // [c, 0, ...]
#pragma unroll
    for (int h = 0; h < kPrepRows * kPrepCols / kThreads; ++h) {
      const int e = threadIdx.x + kThreads * h;
      const int r = e / kPrepCols, t = t0 + r, j = e % kPrepCols;
      yc[(size_t)t * p.ldy + c0 + j] =
          j == 0 && t < p.tc ? __fmul_rn(w[r], __ldg(ys + row0 + t)) : 0.f;
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < kPrepRows * kPrepCols / kThreads; ++h) {
    const int e = threadIdx.x + kThreads * h;
    const int r = e / kPrepCols, t = t0 + r, a = c0 + e % kPrepCols;
    const float v =
        (t < p.tc && a < p.D) ? __ldg(z + (row0 + t) * p.D + a) : 0.f;
    zc[(size_t)t * p.dp + a] = v;
    yc[(size_t)t * p.ldy + a] = __fmul_rn(w[r], v);
  }
}

// Phi[row][col] and Phi[col][row] = v for an element of a lower tile;
// on a diagonal tile only row >= col is stored (so both halves hold the
// lower one's bits).
__device__ __forceinline__ void store_sym(float* __restrict__ phi, int D,
                                          bool diag, int row, int col,
                                          float v) {
  if (row >= D || col >= D || (diag && row < col)) return;
  phi[(size_t)row * D + col] = v;
  phi[(size_t)col * D + row] = v;
}

// The product on T x T tiles (T = 64 or 32): tile (ti, tj) forms acc[i][j]
// = sum over t, in order, of Zp[t][ti T + i] Yp[t][tj T + j], one chain of
// fmaf from +0 an element, so the bits do not depend on T; it is stored
// mirrored (store_sym). Grid (nt + lower tiles, 1, ng), nt = ceil(D / T):
// the first nt blocks are r's, tile (i, Y's [c, 0, ...] columns), which
// keep their first column. A thread owns U x U = (T / 16)^2 elements, rows
// ty U .., columns tx U ..; k-steps of 16 through a ring of
// small_stages(T) shared buffers filled by cp.async, so that several
// steps' loads are in flight (a step's products are short against an L2
// round trip).
template <int T>
__host__ __device__ constexpr int small_stages() {
  return T == 32 ? 8 : 5;  // about 37 and 44 KB of static shared memory
}

template <int T>
__global__ void __launch_bounds__(kThreads)
krls_product_kernel(const float* __restrict__ zp, const float* __restrict__ yp,
                  float* __restrict__ phi_out, float* __restrict__ r_out,
                  KPlan p) {
  constexpr int U = T / 16;
  constexpr int Q = kKT * T / 4;  // float4s of one operand a k-step
  constexpr int S = small_stages<T>();
  __shared__ __align__(16) float xs[S][kKT][T + 4];
  __shared__ __align__(16) float ws[S][kKT][T + 4];
  const int chunk = blockIdx.z;
  const float* zc = zp + (size_t)chunk * p.zp;
  const int nt = (p.D + T - 1) / T;
  const bool r_tile = (int)blockIdx.x < nt;
  int ti = blockIdx.x, tj = 0;
  if (!r_tile) lower_tile(blockIdx.x - nt, ti, tj);
  const bool diag = !r_tile && ti == tj;
  const int i0 = ti * T, j0 = r_tile ? p.dp : tj * T;
  const float* yc = yp + (size_t)chunk * p.yp;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // Thread e < Q copies x's float4 e, Q <= e < 2 Q W's (both at T = 64).
  const int e = threadIdx.x % Q, kk = e / (T / 4), cq = (e % (T / 4)) * 4;
  const bool loads_x = T == 64 || (int)threadIdx.x < Q;
  const bool loads_w = T == 64 || (int)threadIdx.x >= Q;
  const int steps = p.tcp / kKT;
  auto load = [&](int st) {
    const int slot = st % S;
    const size_t k = (size_t)(st * kKT + kk);
    if (loads_x) ft::cp_async16(&xs[slot][kk][cq], zc + k * p.dp + i0 + cq);
    if (loads_w) ft::cp_async16(&ws[slot][kk][cq], yc + k * p.ldy + j0 + cq);
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < steps) load(st);
    ft::cp_commit();
  }
  float acc[U][U];
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int j = 0; j < U; ++j) acc[i][j] = 0.f;
  for (int st = 0; st < steps; ++st) {
    ft::cp_wait<S - 2>();
    // Step st has landed for every thread, and every thread is done with
    // the slot that the next copy overwrites (read at step st - 1).
    __syncthreads();
    if (st + S - 1 < steps) load(st + S - 1);
    ft::cp_commit();
    const int slot = st % S;
#pragma unroll
    for (int k = 0; k < kKT; ++k) {
      float av[U], bv[U];
#pragma unroll
      for (int i = 0; i < U; ++i) av[i] = xs[slot][k][ty * U + i];
#pragma unroll
      for (int j = 0; j < U; ++j) bv[j] = ws[slot][k][tx * U + j];
#pragma unroll
      for (int i = 0; i < U; ++i)
#pragma unroll
        for (int j = 0; j < U; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  }
  ft::cp_wait<0>();
  if (r_tile) {
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < U; ++i)
        if (i0 + ty * U + i < p.D)
          r_out[(size_t)chunk * p.D + i0 + ty * U + i] = acc[i][0];
    return;
  }
  float* phi = phi_out + (size_t)chunk * p.D * p.D;
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int j = 0; j < U; ++j)
      store_sym(phi, p.D, diag, i0 + ty * U + i, j0 + tx * U + j, acc[i][j]);
}

// The product's tile: `tile` if given (64 or 32), else 64 where its lower
// tiles over the group's chunks give every SM two blocks (D = 2048: 528),
// else 32 (D = 300: 55 blocks where 64 gives 15).
int krls_tile(int tile, int D, int ng) {
  if (tile) return tile;
  const long long n = (D + 63) / 64;
  return n * (n + 1) / 2 * ng >= 2 * kWave ? 64 : 32;
}

int krls_run(const float* z, const float* ys, const float* mask, float beta,
             float* g_out, float* phi_out, float* r_out, float* ws,
             long long ws_floats, int nc, int tc, int D, int tile,
             cudaStream_t st) {
  if (nc < 0 || tc < 1 || D < 1 || tc > kMaxTc || D > kMaxD)
    return cudaErrorInvalidValue;
  if (tile != 0 && tile != 64 && tile != 32) return cudaErrorInvalidValue;
  if (nc == 0) return cudaSuccess;
  const KPlan p = make_kplan(tc, D);
  const long long per = (long long)p.chunk_floats();
  if (ws_floats < per) return cudaErrorInvalidValue;
  const long long fit = ws_floats / per;
  const int group = fit < 65535 ? (int)fit : 65535;
  cudaError_t rc;
  for (int c0 = 0; c0 < nc; c0 += group) {
    const int ng = nc - c0 < group ? nc - c0 : group;
    float* zp = ws;
    float* yp = zp + p.zp * ng;
    const size_t t0 = (size_t)c0 * tc;
    krls_prep_kernel<<<dim3(p.dp / kPrepCols + 1, p.tcp / kPrepRows, ng),
                       kThreads, 0, st>>>(z + t0 * D, ys + t0,
                                          mask ? mask + t0 : nullptr, beta,
                                          zp, yp, g_out + c0, p);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    const int t = krls_tile(tile, D, ng);
    const long long n = (D + t - 1) / t;
    const long long blocks = n + n * (n + 1) / 2;  // r's, then Phi's
    if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)blocks, 1, ng);
    float* phi = phi_out + (size_t)c0 * D * D;
    float* r = r_out + (size_t)c0 * D;
    if (t == 64)
      krls_product_kernel<64><<<grid, kThreads, 0, st>>>(zp, yp, phi, r, p);
    else
      krls_product_kernel<32><<<grid, kThreads, 0, st>>>(zp, yp, phi, r, p);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  return cudaSuccess;
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
// phi_out (nc, D, D), r_out (nc, D); ws a workspace of ws_floats floats,
// at least one chunk's (krls_element_chunk_floats), 16-byte aligned. tile:
// the product's tile (64 or 32), or 0 for the plan's. Tc <= 16384, D
// <= 4194304.
int krls_chunk_elements(const float* z, const float* ys, const float* mask,
                        float beta, float* g_out, float* phi_out,
                        float* r_out, float* ws, long long ws_floats, int nc,
                        int tc, int D, int tile, void* stream) {
  return krls_run(z, ys, mask, beta, g_out, phi_out, r_out, ws, ws_floats,
                  nc, tc, D, tile, static_cast<cudaStream_t>(stream));
}

// Floats of one chunk's KRLS workspace at (tc, D); 0 outside the Tc <=
// 16384 and D <= 4194304 a call takes.
long long krls_element_chunk_floats(int tc, int D) {
  if (tc < 1 || D < 1 || tc > kMaxTc || D > kMaxD) return 0;
  return (long long)make_kplan(tc, D).chunk_floats();
}

const char* rff_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
