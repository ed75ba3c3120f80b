// The compact (blocked) KRLS chunk route for Hopper (sm_90a).
//
// Replaces repro/kernels/rff_krls_step.py::rff_krls_bank_chunk_pallas
// (and, at T = 1, ::rff_krls_bank_step_pallas) for every bank whose P
// triangle does not fit a block's shared memory (D > 335 at d = 5;
// chunking.krls_resident_fits), where csrc/krls_bank.cu's streaming kernels
// moved P through device memory twice a tick. The tick is the paper's
// section 6 recursion, as in krls_bank.cu:
//   z = s cos(x W + b), y_hat = theta . z, e = y - y_hat, pz = P z,
//   delta = beta + z . pz, g = pz / delta, theta += g e,
//   P <- 0.5 (P'' + P''^T), P'' = (P - g pz^T) / beta.
//
// The compact form. Within a block of Tc ticks (kTc), with P_0 the block's
// first P, S_0 = 0.5 (P_0 + P_0^T), n_k the live ticks before tick k and L
// the block's live ticks, the recursion is, in exact arithmetic,
//   P_k   = (S_0 - sum_{live j<k} c_j pz_j pz_j^T) / beta^n_k,
//           c_j = beta^n_j / delta_j,
//   pz_k  = (v_k - sum_{live j<k} c_j pz_j (pz_j . z_k)) / beta^n_k,
//   P_out = (S_0 - sum_{live j} c_j pz_j pz_j^T) / beta^L   (P_0 if L = 0),
// with v_k = P_0 z_k (P_0's rows, as the tick reads them) at the block's
// first live tick and S_0 z_k after it; the symmetrization acts on P_0
// alone because g pz^T = pz pz^T / delta is symmetric. So P is read once
// for P_0 Z^T and once more read and written for the rank-L update: 12 B
// D^2 bytes a block of Tc ticks, where the streaming route moves 12 B D^2
// a tick.
//
// What bounds it: bytes. A block does about 3 Tc D^2 operations a tenant
// (2 Tc D^2 for P_0 Z^T, Tc D^2 for the update) against its 12 D^2 bytes,
// 4 operations a byte at Tc = 16, under the card's ~20 (67 TFLOP/s f32
// over 3.35 TB/s). A fused block (the update with the next block's P_0
// Z^T) would move 8 B D^2; it is not done here.
//
// Accuracy. At lam = 1e-4 the pz_k are O(1) differences of O(1e4)
// vectors. Formed as vectors in f32, their errors grow with Tc past the
// tick form's. So P_0 z_k is summed in f64 across 16-column runs (f32
// within a run), and the recursion runs in f64 on coefficients: pz_k =
// sum_j R_kj v_j, so the ticks need only the (Tc, Tc) products v_j . z_q
// and theta_0 . z_q, and the pz_k are formed once, at the end (phase c).
// The rank-L update of P runs in f32 from c_j pz_j and pz_j rounded to f32.
//
// A call runs, for each slab of tenants (the workspace is capped by the
// wrapper) and each block of at most Tc ticks in order, each from the
// state the one before left:
//  (a) featurize the block's x into the workspace, on feature_tile.cuh
//      (pack, then 128 x 128 tiles with a cosf epilogue; a feature's bits
//      depend on its x row and W column alone);
//  (b) A = P_0 Z^T (f64) over a grid of (tenant, 64-row strips of P_0):
//      128 threads, a thread 4 rows x 2 ticks, 64 x 64 tiles of P_0 and of
//      Z through two stages of shared memory (cp.async 16-byte copies
//      where D % 4 == 0, the next tile landing while this one is used),
//      IEEE f32 FFMA over 16 columns at a time, f64 across them;
//  (c) the recursion, one block a tenant: the (Tc + 1, Tc) products
//      v_j . z_q and theta_0 . z_q (a thread a product, over all D in order:
//      no atomics), the tick recursion on them in one warp (predictions,
//      errors, delta, the coefficients R, c_j, e_j / delta_j), then per
//      feature pz_j = sum R_jk v_k, c_j pz_j and pz_j (f32, for (d)) and
//      theta_out = theta_0 + sum_j (e_j / delta_j) pz_j rounded once;
//  (d) the rank-L update over (tenant, 64 x 64 tile pairs I <= J): tiles
//      (I, J) and (J, I) of P_0 into shared memory, S_0's element minus
//      sum_l (c_l pz_l)_i (pz_l)_j in l order, divided by beta^L; each
//      element and its mirror written from one value, so P_out is bitwise
//      symmetric. A tenant with L = 0 gets P_0 (and theta_0) back bit for
//      bit.
// Pass 1 assumes S_0 z_k = P_0 z_k. Phase (d) compares each tile pair of
// P_0 bitwise and flags a tenant whose P_0 is not symmetric and whose
// block has two live ticks or more (the only case that reads S_0 z_k).
// A fix-up pass then runs, for the flagged tenants alone and one block a
// tenant, (b) for P_0^T Z^T from p_in's columns (pass 1's P_0 Z^T stands),
// then (c) with S_0 z_k = 0.5 (P_0 z_k + P_0^T z_k) and (d). A flagged P_0
// is the call's p_in (an update's output is symmetric bit for bit, so an
// asymmetric P_0 has seen no live tick: it is p_in, copied, and theta_0 is
// theta_in), so the fix-up reads p_in and theta_in even where pass 1
// updated p_out in place. For a symmetric P_0 the fix-up's three launches
// return at once.
//
// Bits: every sum runs in a fixed order from +0 with no atomics, and a
// tenant's work reads its own rows alone, so two calls agree, a tenant's
// outputs do not depend on B or its neighbours, a call of n Tc ticks
// equals n calls of Tc in order, and a step (the route at T = 1) equals a
// chunk at T = 1. A chunk of T does not equal T steps bit for bit (the
// blocks reassociate the recursion). P offsets are 64-bit. cosf, never
// __cosf.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "feature_tile.cuh"

namespace {

namespace ft = feature_tile;

constexpr int kTc = 16;      // ticks a block (chunking.KRLS_COMPACT_TC)
constexpr int kTile = 64;    // a strip's rows, a tile's side
constexpr int kPitch = kTile + 4;  // (b)'s shared rows: 16-byte aligned
constexpr int kProdThreads = 128;  // (b): 16 x 8, 4 rows x 2 ticks each
constexpr int kRecThreads = 256;   // (c)
constexpr int kPairs = (kTc + 1) * kTc;  // (c)'s products: v_j . z_q, theta . z_q
constexpr int kUpdThreads = 256;   // (d): 16 x 16, 4 x 4 elements each
constexpr int kUpdPitch = kTile + 1;
constexpr size_t kAlign = 256;

// One block of ticks of one slab of tenants: tenants from b0, ticks t0 ..
// t0 + tcb - 1 of T.
struct Block {
  int b0, t0, tcb, T, D;
};

// The workspace of a slab (krls_compact_workspace_bytes in chunking.py):
// per tenant, tcb * D values of each array, [tick][feature].
struct Work {
  float* z;       // features
  double* a;      // P_0 z_k
  double* c;      // P_0^T z_k (fix-up)
  float* vw;      // c_l pz_l then pz_l, 2 tcb D floats a tenant, for (d)
  int* live;      // L
  float* scale;   // beta^L
  int* flag;      // the tenant needs the fix-up
  float* pk;      // the feature tile's packed x and W
};

inline size_t aligned(size_t bytes) {
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

size_t work_bytes(int Bs, int tcb, int d, int D) {
  const size_t n = (size_t)Bs * tcb * D;
  return aligned(4 * n) + 2 * aligned(8 * n) + aligned(8 * n) +
         3 * aligned(4 * (size_t)Bs) +
         aligned(4 * ft::pack_floats(Bs * tcb, d, D));
}

Work carve(void* ws, int Bs, int tcb, int D) {
  const size_t n = (size_t)Bs * tcb * D;
  char* p = static_cast<char*>(ws);
  Work w;
  w.z = reinterpret_cast<float*>(p);      p += aligned(4 * n);
  w.a = reinterpret_cast<double*>(p);     p += aligned(8 * n);
  w.c = reinterpret_cast<double*>(p);     p += aligned(8 * n);
  w.vw = reinterpret_cast<float*>(p);     p += aligned(8 * n);
  w.live = reinterpret_cast<int*>(p);     p += aligned(4 * (size_t)Bs);
  w.scale = reinterpret_cast<float*>(p);  p += aligned(4 * (size_t)Bs);
  w.flag = reinterpret_cast<int*>(p);     p += aligned(4 * (size_t)Bs);
  w.pk = reinterpret_cast<float*>(p);
  return w;
}

// ---------------------------------------------------------------------------
// (a) z[r][j] = s_j cos((x W)[r][j] + b_j), rows r = (tenant, tick) of the
// slab's block, from the packed xT and Wp; one 128 x 128 tile a block.

__global__ void __launch_bounds__(ft::kThreads, ft::kMinBlocks)
compact_features_kernel(const float* __restrict__ xT,
                        const float* __restrict__ wp, float* __restrict__ z,
                        int R, int D, ft::Dims g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ft::Smem& s = *reinterpret_cast<ft::Smem*>(smem_raw);
  const int row0 = blockIdx.x * ft::kM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const ft::Walk wk{xT, wp, g.Rp, g.Dp, g.dp / ft::kK, row0, (int)blockIdx.y, 1};
  const bool vec = (D & 3) == 0;  // rows of z start on 16 bytes
  ft::walk(s, wk, [&](int col0, int buf, float (&acc)[8][8]) {
    float bj[8], sj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bj[j] = s.bs[buf][0][ft::col_of(tx, j)];
      sj[j] = s.bs[buf][1][ft::col_of(tx, j)];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ft::row_of(ty, i);
      if (row >= R) continue;
      float* zr = z + (size_t)row * D;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * h + c;
          v[c] = __fmul_rn(sj[j], cosf(__fadd_rn(acc[i][j], bj[j])));
        }
        const int col = col0 + ft::col_of(tx, 4 * h);
        if (vec && col < D) {
          *reinterpret_cast<float4*>(zr + col) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (col + c < D) zr[col + c] = v[c];
        }
      }
    }
  });
}

// ---------------------------------------------------------------------------
// (b) out[k][i] = sum_j P[i][j] z_k[j] (or P[j][i] z_k[j] when transposed)
// for the 64 rows i of strip I of one tenant, k < tcb.

struct ProdSmem {  // two stages: the next tile lands while this one is used
  float p[2][kTile][kPitch];  // p[r][c]: P[I + r][J + c] (or P[J + c][I + r])
  float z[2][kTc][kPitch];    // z[k][c]: z_k[J + c]
};

// Tile J of the strip (and of z) into stage st: cp.async 16-byte copies
// where D % 4 == 0 (rows then start on 16 bytes), else plain loads; zeros
// outside D and past tcb.
__device__ __forceinline__ void load_stage(ProdSmem& sm, int st,
                                           const float* __restrict__ p,
                                           const float* __restrict__ z,
                                           int tcb, int D, int i0, int J,
                                           bool transposed) {
  const int tid = threadIdx.x;
  const int j0 = J * kTile;
  const bool vec = (D & 3) == 0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!transposed && vec) {  // 64 rows of 16 float4s
    for (int e = tid; e < kTile * kTile / 4; e += kProdThreads) {
      const int r = e >> 4, c = (e & 15) * 4;
      if (i0 + r < D && j0 + c < D)
        ft::cp_async16(&sm.p[st][r][c], p + (size_t)(i0 + r) * D + j0 + c);
      else
        *reinterpret_cast<float4*>(&sm.p[st][r][c]) = zero;
    }
  } else if (!transposed) {
    for (int e = tid; e < kTile * kTile; e += kProdThreads) {
      const int r = e >> 6, c = e & 63;
      sm.p[st][r][c] = (i0 + r < D && j0 + c < D)
                           ? __ldg(p + (size_t)(i0 + r) * D + j0 + c) : 0.f;
    }
  } else {  // sm.p[r][c] = P[j0 + c][i0 + r], rows of P read along r
    for (int e = tid; e < kTile * kTile; e += kProdThreads) {
      const int c = e >> 6, r = e & 63;
      sm.p[st][r][c] = (i0 + r < D && j0 + c < D)
                           ? __ldg(p + (size_t)(j0 + c) * D + i0 + r) : 0.f;
    }
  }
  if (vec) {
    for (int e = tid; e < kTc * kTile / 4; e += kProdThreads) {
      const int k = e >> 4, c = (e & 15) * 4;
      if (k < tcb && j0 + c < D)
        ft::cp_async16(&sm.z[st][k][c], z + (size_t)k * D + j0 + c);
      else
        *reinterpret_cast<float4*>(&sm.z[st][k][c]) = zero;
    }
  } else {
    for (int e = tid; e < kTc * kTile; e += kProdThreads) {
      const int k = e >> 6, c = e & 63;
      sm.z[st][k][c] = (k < tcb && j0 + c < D)
                           ? __ldg(z + (size_t)k * D + j0 + c) : 0.f;
    }
  }
}

__device__ void strip_product(ProdSmem& sm, const float* __restrict__ p,
                              const float* __restrict__ z,
                              double* __restrict__ out, int tcb, int D,
                              int I, bool transposed) {
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;  // rows ty + 16 r, ticks tx + 8 q
  const int i0 = I * kTile;
  const int nt = (D + kTile - 1) / kTile;
  double acc[4][2] = {};
  load_stage(sm, 0, p, z, tcb, D, i0, 0, transposed);
  ft::cp_commit();
  for (int J = 0; J < nt; ++J) {
    const int st = J & 1;
    if (J + 1 < nt) load_stage(sm, st ^ 1, p, z, tcb, D, i0, J + 1, transposed);
    ft::cp_commit();
    ft::cp_wait<1>();  // tile J has landed
    __syncthreads();
    float part[4][2] = {};
#pragma unroll 4
    for (int c = 0; c < kTile; c += 4) {  // f32 over 16 columns, then f64
      float4 pr[4], zr[2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pr[r] = *reinterpret_cast<const float4*>(&sm.p[st][ty + 16 * r][c]);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        zr[q] = *reinterpret_cast<const float4*>(&sm.z[st][tx + 8 * q][c]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = part[r][q];
          v = __fmaf_rn(pr[r].x, zr[q].x, v);
          v = __fmaf_rn(pr[r].y, zr[q].y, v);
          v = __fmaf_rn(pr[r].z, zr[q].z, v);
          v = __fmaf_rn(pr[r].w, zr[q].w, v);
          part[r][q] = v;
        }
      if ((c & 15) == 12) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            acc[r][q] = __dadd_rn(acc[r][q], (double)part[r][q]);
            part[r][q] = 0.f;
          }
      }
    }
    __syncthreads();  // stage st is free for tile J + 2
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = i0 + ty + 16 * r, k = tx + 8 * q;
      if (i < D && k < tcb) out[(size_t)k * D + i] = acc[r][q];
    }
}

// Pass 1: a block a (tenant, strip), rows of the block's P_0 (src).
__global__ void __launch_bounds__(kProdThreads)
compact_product_kernel(const float* __restrict__ src, Work w, Block bk) {
  __shared__ __align__(16) ProdSmem sm;
  const int nstrip = (bk.D + kTile - 1) / kTile;
  const int bl = blockIdx.x / nstrip, I = blockIdx.x % nstrip;
  const size_t n = (size_t)bk.tcb * bk.D;
  strip_product(sm, src + (size_t)(bk.b0 + bl) * bk.D * bk.D, w.z + bl * n,
                w.a + bl * n, bk.tcb, bk.D, I, false);
}

// Fix-up: a block a flagged tenant, every strip, P_0^T Z^T from the columns
// of p_in (pass 1's P_0 Z^T stands: a flagged P_0 is p_in).
__global__ void __launch_bounds__(kProdThreads)
compact_product_fix_kernel(const float* __restrict__ p_in, Work w, Block bk) {
  __shared__ __align__(16) ProdSmem sm;
  const int bl = blockIdx.x;
  if (!w.flag[bl]) return;
  const size_t n = (size_t)bk.tcb * bk.D;
  const float* p = p_in + (size_t)(bk.b0 + bl) * bk.D * bk.D;
  const int nstrip = (bk.D + kTile - 1) / kTile;
  for (int I = 0; I < nstrip; ++I)
    strip_product(sm, p, w.z + bl * n, w.c + bl * n, bk.tcb, bk.D, I, true);
}

// ---------------------------------------------------------------------------
// (c) The recursion of one tenant's block.

struct RecSmem {
  double v[kTc + 1][kTile];  // a chunk of v_j (row kTc: theta_0)
  float z[kTc][kTile + 1];   // the chunk's z_q
  double g[kTc + 1][kTc];    // g[j][q] = v_j . z_q, g[kTc][q] = theta_0 . z_q
  double r[kTc][kTc];        // pz_s = sum_j r[s][j] v_j (zero for masked s)
  double m[kTc][kTc];        // m[s][q] = pz_s . z_q
  double cl[kTc];            // c_s = beta^n_s / delta_s (0 for masked s)
  double ql[kTc];            // e_s / delta_s (0 for masked s)
  int slot[kTc];             // live ticks in order
  double scale;              // beta^L
  int nlive;
};

// v_j[i] of tenant bl: P_0 z_j, or S_0 z_j after the first live tick in
// the fix-up (S_0 z_j = 0.5 (P_0 z_j + P_0^T z_j)).
__device__ __forceinline__ double vj(const double* a, const double* c,
                                     bool fix, int j, int first, size_t at) {
  const double x = a[at];
  return (fix && j != first) ? __dmul_rn(0.5, __dadd_rn(x, c[at])) : x;
}

__global__ void __launch_bounds__(kRecThreads)
compact_recursion_kernel(const float* th_src,
                         float* theta_out, const float* __restrict__ ys,
                         const float* __restrict__ mask,
                         const float* __restrict__ beta_in,
                         float* __restrict__ pred_out,
                         float* __restrict__ err_out, Work w, Block bk,
                         int fix) {
  __shared__ __align__(16) RecSmem sm;
  const int tid = threadIdx.x;
  const int bl = blockIdx.x, b = bk.b0 + bl;
  if (fix && !w.flag[bl]) return;
  const int D = bk.D, tcb = bk.tcb;
  const size_t n = (size_t)tcb * D;
  const float* z = w.z + bl * n;
  const double* a = w.a + bl * n;
  const double* c = w.c + bl * n;
  const float* th0 = th_src + (size_t)b * D;
  float* th = theta_out + (size_t)b * D;
  const size_t row0 = (size_t)b * bk.T + bk.t0;
  int first = -1;  // the block's first live tick (block-uniform)
  for (int k = 0; k < tcb; ++k)
    if (first < 0 && (mask == nullptr || mask[row0 + k] > 0.f)) first = k;

  // The products v_j . z_q and theta_0 . z_q: thread t owns pairs t and
  // t + 256, each summed over all D in order.
  double acc[2] = {0.0, 0.0};
  for (int e0 = 0; e0 < D; e0 += kTile) {
    for (int e = tid; e < (kTc + 1) * kTile; e += kRecThreads) {
      const int j = e / kTile, i = e % kTile, col = e0 + i;
      double x = 0.0;
      if (col < D && j < tcb) x = vj(a, c, fix, j, first, (size_t)j * D + col);
      else if (col < D && j == kTc) x = (double)th0[col];
      sm.v[j][i] = x;
    }
    for (int e = tid; e < kTc * kTile; e += kRecThreads) {
      const int q = e / kTile, i = e % kTile, col = e0 + i;
      sm.z[q][i] = (col < D && q < tcb) ? z[(size_t)q * D + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pair = tid + kRecThreads * h;
      if (pair < kPairs) {
        const int j = pair / kTc, q = pair % kTc;
        double s = acc[h];
        for (int i = 0; i < kTile; ++i)
          s = __fma_rn(sm.v[j][i], (double)sm.z[q][i], s);
        acc[h] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pair = tid + kRecThreads * h;
    if (pair < kPairs) sm.g[pair / kTc][pair % kTc] = acc[h];
  }
  __syncthreads();

  // The tick recursion on the (Tc, Tc) products, in warp 0: lane j holds
  // column j of this tick's coefficients and of its products.
  if (tid < 32) {
    const int lane = tid;
    const double beta = (double)beta_in[b];
    double scale = 1.0;
    int nlive = 0;
    for (int k = 0; k < tcb; ++k) {
      const size_t row = row0 + k;
      const bool live = mask == nullptr || mask[row] > 0.f;
      // theta_k . z_k = theta_0 . z_k + sum_{s<k} (e_s / delta_s) m[s][k]
      double pred = sm.g[kTc][k];
      for (int s = 0; s < k; ++s) pred = __fma_rn(sm.ql[s], sm.m[s][k], pred);
      const float pred32 = (float)pred;
      const float err32 = __fsub_rn(ys[row], pred32);
      if (lane == 0) {
        pred_out[row] = pred32;
        err_out[row] = err32;
      }
      double rk = 0.0, mk = 0.0;
      if (live) {
        // r_k = (e_k - sum_{s<k} c_s m[s][k] r_s) / beta^n_k
        if (lane < kTc) {
          double t = lane == k ? 1.0 : 0.0;
          for (int s = 0; s < k; ++s)
            t = __fma_rn(-__dmul_rn(sm.cl[s], sm.m[s][k]), sm.r[s][lane], t);
          rk = __ddiv_rn(t, scale);
        }
      }
      __syncwarp();
      if (lane < kTc) sm.r[k][lane] = rk;
      __syncwarp();
      if (live && lane < kTc) {  // m[k][q] = pz_k . z_q = sum_j r[k][j] g[j][q]
        for (int j = 0; j < tcb; ++j) mk = __fma_rn(sm.r[k][j], sm.g[j][lane], mk);
      }
      if (lane < kTc) sm.m[k][lane] = mk;
      __syncwarp();
      if (lane == 0) {
        if (live) {
          const double delta = __dadd_rn(beta, sm.m[k][k]);
          sm.cl[k] = __ddiv_rn(scale, delta);
          sm.ql[k] = __ddiv_rn((double)err32, delta);
          sm.slot[nlive] = k;
        } else {
          sm.cl[k] = 0.0;
          sm.ql[k] = 0.0;
        }
      }
      if (live) {
        scale = __dmul_rn(scale, beta);
        ++nlive;
      }
      __syncwarp();
    }
    if (lane == 0) {
      sm.scale = scale;
      sm.nlive = nlive;
    }
  }
  __syncthreads();

  // Per feature: pz_s = sum_j r[s][j] v_j for the live s, in slot order,
  // into (d)'s c_s pz_s and pz_s rows; theta_out.
  const int nlive = sm.nlive;
  float* vl = w.vw + 2 * bl * n;  // c_l pz_l
  float* wl = vl + n;             // pz_l
  for (int i = tid; i < D; i += kRecThreads) {
    if (nlive == 0) {
      th[i] = th0[i];
      continue;
    }
    double v[kTc];
#pragma unroll
    for (int j = 0; j < kTc; ++j)
      v[j] = j < tcb ? vj(a, c, fix, j, first, (size_t)j * D + i) : 0.0;
    double t = (double)th0[i];
    for (int l = 0; l < nlive; ++l) {
      const int s = sm.slot[l];
      double pz = 0.0;
#pragma unroll
      for (int j = 0; j < kTc; ++j) pz = __fma_rn(sm.r[s][j], v[j], pz);
      vl[(size_t)l * D + i] = (float)__dmul_rn(sm.cl[s], pz);
      wl[(size_t)l * D + i] = (float)pz;
      t = __fma_rn(sm.ql[s], pz, t);
    }
    th[i] = (float)t;
  }
  if (tid == 0) {
    w.live[bl] = nlive;
    w.scale[bl] = (float)sm.scale;
    if (!fix) w.flag[bl] = 0;
  }
}

// ---------------------------------------------------------------------------
// (d) The rank-L update of tile pair (I, J), I <= J, of one tenant:
// dst[i][j] = dst[j][i] = (0.5 (P_ij + P_ji) - sum_l V_l[i] W_l[j]) / beta^L
// for i in tile I, j in tile J (i <= j on the diagonal tile), from src.

struct UpdSmem {
  float pa[kTile][kUpdPitch];  // src tile (I, J), then the result
  float pb[kTile][kUpdPitch];  // src tile (J, I)
  float v[kTc][kTile];         // V_l over tile I's rows
  float w[kTc][kTile];         // W_l over tile J's columns
};

// The pair index p (0 .. nt (nt + 1) / 2 - 1) as (I, J), I <= J.
__device__ __forceinline__ void pair_of(int p, int nt, int& I, int& J) {
  I = 0;
  while (p >= nt - I) {
    p -= nt - I;
    ++I;
  }
  J = I + p;
}

__device__ void copy_tile(const float* src, float* dst, int D, int r0, int c0) {
  if ((D & 3) == 0) {  // 16-byte copies: rows start on 16 bytes
    for (int e = threadIdx.x; e < kTile * kTile / 4; e += kUpdThreads) {
      const int r = r0 + (e >> 4), cc = c0 + (e & 15) * 4;
      if (r < D && cc < D)
        *reinterpret_cast<float4*>(dst + (size_t)r * D + cc) =
            *reinterpret_cast<const float4*>(src + (size_t)r * D + cc);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTile * kTile; e += kUpdThreads) {
    const int r = r0 + e / kTile, cc = c0 + e % kTile;
    if (r < D && cc < D) dst[(size_t)r * D + cc] = src[(size_t)r * D + cc];
  }
}

// src and dst are not __restrict__: pass 1 after the call's first block
// updates P in place (each tile pair is read whole before it is written,
// by its own block alone).
__device__ void update_pair(UpdSmem& sm, const float* src, float* dst,
                            const Work& w, int bl, int L, int D, int I,
                            int J, int* flag) {
  const int tid = threadIdx.x;
  const int i0 = I * kTile, j0 = J * kTile;
  const bool vec = (D & 3) == 0;
  if (vec) {  // each thread's 16-byte loads of both tiles issued first
    constexpr int kH = kTile * kTile / 4 / kUpdThreads;
    float4 va[kH], vb[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int e = tid + kUpdThreads * h, r = e >> 4, c = (e & 15) * 4;
      va[h] = vb[h] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + r < D && j0 + c < D)
        va[h] = *reinterpret_cast<const float4*>(src + (size_t)(i0 + r) * D + j0 + c);
      if (j0 + r < D && i0 + c < D)
        vb[h] = *reinterpret_cast<const float4*>(src + (size_t)(j0 + r) * D + i0 + c);
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int e = tid + kUpdThreads * h, r = e >> 4, c = (e & 15) * 4;
      sm.pa[r][c] = va[h].x; sm.pa[r][c + 1] = va[h].y;
      sm.pa[r][c + 2] = va[h].z; sm.pa[r][c + 3] = va[h].w;
      sm.pb[r][c] = vb[h].x; sm.pb[r][c + 1] = vb[h].y;
      sm.pb[r][c + 2] = vb[h].z; sm.pb[r][c + 3] = vb[h].w;
    }
  } else {
    for (int e = tid; e < kTile * kTile; e += kUpdThreads) {
      const int r = e / kTile, cc = e % kTile;
      sm.pa[r][cc] = (i0 + r < D && j0 + cc < D) ? src[(size_t)(i0 + r) * D + j0 + cc] : 0.f;
      sm.pb[r][cc] = (j0 + r < D && i0 + cc < D) ? src[(size_t)(j0 + r) * D + i0 + cc] : 0.f;
    }
  }
  __syncthreads();
  if (flag != nullptr && L >= 2) {  // P_0 not symmetric, bit for bit
    bool asym = false;
    for (int e = tid; e < kTile * kTile; e += kUpdThreads) {
      const int r = e / kTile, cc = e % kTile;
      asym |= __float_as_uint(sm.pa[r][cc]) != __float_as_uint(sm.pb[cc][r]);
    }
    if (__syncthreads_or(asym) && tid == 0) *flag = 1;
  }
  const int ty = tid >> 4, tx = tid & 15;  // rows ty * 4 + {0..3}, cols tx * 4 + {0..3}
  float out[4][4];
  {
    float acc[4][4] = {};
    for (int l = 0; l < L; ++l) {
      const float4 vr = *reinterpret_cast<const float4*>(&sm.v[l][ty * 4]);
      const float4 wc = *reinterpret_cast<const float4*>(&sm.w[l][tx * 4]);
      const float vv[4] = {vr.x, vr.y, vr.z, vr.w};
      const float ww[4] = {wc.x, wc.y, wc.z, wc.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = __fmaf_rn(vv[r], ww[q], acc[r][q]);
    }
    const float scale = w.scale[bl];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = ty * 4 + r, cc = tx * 4 + q;
        const float s0 = __fmul_rn(0.5f, __fadd_rn(sm.pa[rr][cc], sm.pb[cc][rr]));
        out[r][q] = __fdiv_rn(__fsub_rn(s0, acc[r][q]), scale);
      }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) sm.pa[ty * 4 + r][tx * 4 + q] = out[r][q];
  __syncthreads();
  // Tile (I, J) (on the diagonal tile the lower half from the upper) and
  // its mirror (J, I).
  if (vec) {
    for (int e = tid; e < kTile * kTile / 4; e += kUpdThreads) {
      const int r = e >> 4, c = (e & 15) * 4;
      float v[4], m[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = (I == J && r > c + q) ? sm.pa[c + q][r] : sm.pa[r][c + q];
        m[q] = sm.pa[c + q][r];
      }
      if (i0 + r < D && j0 + c < D)
        *reinterpret_cast<float4*>(dst + (size_t)(i0 + r) * D + j0 + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      if (I != J && j0 + r < D && i0 + c < D)
        *reinterpret_cast<float4*>(dst + (size_t)(j0 + r) * D + i0 + c) =
            make_float4(m[0], m[1], m[2], m[3]);
    }
  } else {
    for (int e = tid; e < kTile * kTile; e += kUpdThreads) {
      const int r = e / kTile, cc = e % kTile;  // tile (I, J), rows along cc
      if (i0 + r < D && j0 + cc < D)
        dst[(size_t)(i0 + r) * D + j0 + cc] =
            (I == J && r > cc) ? sm.pa[cc][r] : sm.pa[r][cc];
      if (I != J && j0 + r < D && i0 + cc < D)  // tile (J, I): the mirror
        dst[(size_t)(j0 + r) * D + i0 + cc] = sm.pa[cc][r];
    }
  }
  __syncthreads();
}

// V and W of tile I's rows and tile J's columns.
__device__ void load_vw(UpdSmem& sm, const Work& w, int bl, int L, size_t n,
                        int D, int I, int J) {
  const float* vl = w.vw + 2 * bl * n;
  const float* wl = vl + n;
  for (int e = threadIdx.x; e < kTc * kTile; e += kUpdThreads) {
    const int l = e / kTile, i = e % kTile;
    const bool in_v = l < L && I * kTile + i < D, in_w = l < L && J * kTile + i < D;
    sm.v[l][i] = in_v ? vl[(size_t)l * D + I * kTile + i] : 0.f;
    sm.w[l][i] = in_w ? wl[(size_t)l * D + J * kTile + i] : 0.f;
  }
}

// Pass 1: a block a (tenant, tile pair). src is the block's P_0: p_in in
// the call's first block, p_out after it.
__global__ void __launch_bounds__(kUpdThreads)
compact_update_kernel(const float* src, float* dst, Work w, Block bk) {
  __shared__ __align__(16) UpdSmem sm;
  const int D = bk.D;
  const int nt = (D + kTile - 1) / kTile;
  const int npairs = nt * (nt + 1) / 2;
  const int bl = blockIdx.x / npairs;
  int I, J;
  pair_of(blockIdx.x % npairs, nt, I, J);
  const size_t off = (size_t)(bk.b0 + bl) * D * D;
  const int L = w.live[bl];
  if (L == 0) {  // P' = P_0
    if (src != dst) {
      copy_tile(src + off, dst + off, D, I * kTile, J * kTile);
      if (I != J) copy_tile(src + off, dst + off, D, J * kTile, I * kTile);
    }
    return;
  }
  load_vw(sm, w, bl, L, (size_t)bk.tcb * D, D, I, J);
  update_pair(sm, src + off, dst + off, w, bl, L, D, I, J, w.flag + bl);
}

// Fix-up: a block a flagged tenant, every tile pair, from p_in.
__global__ void __launch_bounds__(kUpdThreads)
compact_update_fix_kernel(const float* p_in, float* dst, Work w, Block bk) {
  __shared__ __align__(16) UpdSmem sm;
  const int bl = blockIdx.x;
  if (!w.flag[bl]) return;
  const int D = bk.D;
  const int nt = (D + kTile - 1) / kTile;
  const size_t off = (size_t)(bk.b0 + bl) * D * D;
  const int L = w.live[bl];
  for (int I = 0; I < nt; ++I)
    for (int J = I; J < nt; ++J) {
      load_vw(sm, w, bl, L, (size_t)bk.tcb * D, D, I, J);
      update_pair(sm, p_in + off, dst + off, w, bl, L, D, I, J, nullptr);
    }
}

// One call: slabs of `slab` tenants, blocks of kTc ticks.
int run(const float* theta, const float* p_in, const float* xs,
        const float* ys, const float* mask, const float* beta,
        const float* w, const float* b, const float* s, float* theta_out,
        float* p_out, float* pred, float* err, int B, int T, int d, int D,
        void* ws, long long ws_bytes, int slab, cudaStream_t st) {
  if (B < 1 || T < 1 || d < 1 || D < 1 || slab < 1) return cudaErrorInvalidValue;
  if ((long long)B * T > 0x7fffffffLL || (D + ft::kN - 1) / ft::kN > 65535)
    return cudaErrorInvalidValue;
  const int Bmax = slab < B ? slab : B;
  const int tmax = kTc < T ? kTc : T;
  if (ws == nullptr || (size_t)ws_bytes < work_bytes(Bmax, tmax, d, D))
    return cudaErrorInvalidValue;
  const int nt = (D + kTile - 1) / kTile;
  const long long npairs = (long long)nt * (nt + 1) / 2;
  if ((long long)Bmax * npairs > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      compact_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ft::smem_bytes());
  if (rc != cudaSuccess) return rc;
  for (int b0 = 0; b0 < B; b0 += slab) {
    const int Bs = B - b0 < slab ? B - b0 : slab;
    for (int t0 = 0; t0 < T; t0 += kTc) {
      const int tcb = T - t0 < kTc ? T - t0 : kTc;
      const Block bk{b0, t0, tcb, T, D};
      const Work wk = carve(ws, Bs, tcb, D);
      // (a) the block's features, rows (tenant, tick) in xs order.
      const int rows = Bs * tcb;
      const ft::Dims g = ft::tile_dims(rows, d, D);
      float* wp = wk.pk;
      float* xT = wk.pk + (size_t)(g.dp + 2) * g.Dp;
      const ft::Rows x{xs + ((size_t)b0 * T + t0) * d, tcb, (long long)T * d, d};
      rc = ft::pack(x, rows, w, b, s, D, xT, wp, false, st);
      if (rc != cudaSuccess) return rc;
      compact_features_kernel<<<dim3(g.Rp / ft::kM, g.Dp / ft::kN),
                                ft::kThreads, ft::smem_bytes(), st>>>(
          xT, wp, wk.z, rows, D, g);
      if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
      // The block's P_0 and theta_0: the call's inputs, then its outputs.
      const float* src = t0 == 0 ? p_in : p_out;
      const float* th = t0 == 0 ? theta : theta_out;
      compact_product_kernel<<<Bs * nt, kProdThreads, 0, st>>>(src, wk, bk);
      if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
      compact_recursion_kernel<<<Bs, kRecThreads, 0, st>>>(
          th, theta_out, ys, mask, beta, pred, err, wk, bk, 0);
      if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
      compact_update_kernel<<<(unsigned)(Bs * npairs), kUpdThreads, 0, st>>>(
          src, p_out, wk, bk);
      if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
      // The fix-up of tenants whose P_0 is not symmetric (see the header).
      compact_product_fix_kernel<<<Bs, kProdThreads, 0, st>>>(p_in, wk, bk);
      if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
      compact_recursion_kernel<<<Bs, kRecThreads, 0, st>>>(
          theta, theta_out, ys, mask, beta, pred, err, wk, bk, 1);
      if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
      compact_update_fix_kernel<<<Bs, kUpdThreads, 0, st>>>(p_in, p_out, wk, bk);
      if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// krls_bank_chunk's arguments, then the workspace (ws, ws_bytes: at least
// krls_compact_workspace_bytes(min(slab, B), min(Tc, T), d, D)) and the
// tenants a slab takes.
int krls_bank_chunk_compact(const float* theta, const float* p_in,
                            const float* xs, const float* ys,
                            const float* mask, const float* beta,
                            const float* w, const float* b, const float* s,
                            float* theta_out, float* p_out, float* pred,
                            float* err, int B, int T, int d, int D,
                            void* stream, void* ws, long long ws_bytes,
                            int slab) {
  return run(theta, p_in, xs, ys, mask, beta, w, b, s, theta_out, p_out,
             pred, err, B, T, d, D, ws, ws_bytes, slab,
             static_cast<cudaStream_t>(stream));
}

long long krls_compact_workspace_bytes(int Bs, int tcb, int d, int D) {
  return (long long)work_bytes(Bs, tcb, d, D);
}

int krls_compact_tc() { return kTc; }

const char* krls_compact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
