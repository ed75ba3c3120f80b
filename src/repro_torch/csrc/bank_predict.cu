// Fused predict-only bank read path for Hopper (sm_90a).
//
// Replaces repro/kernels/rff_predict.py::rff_bank_predict_pallas. For a
// bank of B tenants and a block of Q queries per tenant:
//   z = s * cos(x_q W + b),   y_hat[b, q] = theta_b . z
// against a read-only theta (the published snapshot). No state is written.
//
// What bounds it on this card: 2 d D flops and D cosines per query (34
// GFLOP for B=1024, Q=64, d=128, D=2048) against about 36 MB that must
// move (xq, theta, W once, the output), so the work is bound by operations:
// the f32 CUDA cores' for f32, the bf16 tensor cores' for the products of
// the bf16 contract (and then the cosines on the CUDA cores).
//
// Design: the rows are the B Q (tenant, query) pairs of the row-major
// (B Q, d) xq. The operands are packed first (zero-padded, so the main
// loops copy 16-byte chunks with cp.async and check no bounds), then a
// block owns 128 rows (2 tenants of 64 queries at Q = 64; a block may span
// tenants) and walks all of D in 128-column tiles, so W crosses L2 once per
// 128 rows (512 MiB a launch at the serving shape instead of the first
// design's 4 GiB). Each column tile's epilogue forms z and multiplies it by
// theta[tenant(row), j]; a row's sum is taken in a fixed order (a thread's
// columns over all column tiles in order, then the threads that share the
// row by shuffles, then for bf16 the two warps that share it), so a read
// gives the same bits every time: no atomics.
//  * f32: the register-tiled IEEE f32 tile of feature_tile.cuh (x packed
//    transposed, 8 x 8 a thread); cosf, never __cosf; no TF32.
//  * bf16 (the contract of kernels/ref.py: mp_project, mp_trig): x and W
//    rounded with __float2bfloat16_rn as they are packed (x as (Rp, dp)
//    rows, W transposed as (Dp, dp)), products on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate; fragments by ldmatrix),
//    bias, cos and scale in f32, z rounded to bf16, the dot with theta in
//    f32. mma.sync rather than wgmma: once the products are on the tensor
//    cores the cosines on the CUDA cores set the pace, and its per-warp
//    accumulator layout keeps the row-wise epilogue simple.
//  * Ragged B, Q, d and D: the packing pads them with zeros, and the
//    epilogues skip rows past B Q and columns past D.
//
// The few-row route (bank_predict_few). Where the bank route gives too few
// blocks to fill the card (kernels/chunking.py predict_route: one tenant's
// 64 queries are one block walking all of D on one SM), a read runs in two
// phases over an (R, Dp) f32 workspace of z, since a row's chain crosses
// the column tiles and cannot be cut into per-block partial sums without
// changing its bits:
//  (a) one launch packs x and W (f32: feature_tile.cuh's pack; bf16 both
//      of the bank route's packs in one launch), then a grid of (row tile,
//      column tile) blocks forms z, each block one 128-column tile: f32 on
//      the feature tile (32 rows of 4 x 4 a thread, or 128 rows of 8 x 8
//      where those fill a wave), whose elements' bits depend on the x row
//      and the W column alone; bf16 the bank route's block tile restricted
//      to one column tile (the same mma.sync k-steps in the same order at
//      the same fragment positions), z rounded to bf16;
//  (b) a reduce launch runs the bank route's chain for each row: the same
//      lanes over the same columns in the same order from +0, then the
//      same shuffles (f32: 16 lanes at offsets 8, 4, 2, 1; bf16: the lanes
//      t at 1 and 2, then the two column halves' sum).
// So a row's prediction has the same bits on either route and whatever B.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "feature_tile.cuh"

namespace {

namespace ft = feature_tile;

// --- f32 -----------------------------------------------------------------

__global__ void __launch_bounds__(ft::kThreads, ft::kMinBlocks)
predict_f32_kernel(const float* __restrict__ theta,
                   const float* __restrict__ xT, const float* __restrict__ wp,
                   float* __restrict__ out, int R, int Q, int D, ft::Dims g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ft::Smem& s = *reinterpret_cast<ft::Smem*>(smem_raw);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * ft::kM;
  int toff[8];  // theta row of each of the thread's rows
#pragma unroll
  for (int i = 0; i < 8; ++i)
    toff[i] = min(row0 + ft::row_of(ty, i), R - 1) / Q * D;
  float part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i] = 0.f;
  const ft::Walk wk{xT, wp, g.Rp, g.Dp, g.dp / ft::kK, row0, 0, g.Dp / ft::kN};
  ft::walk(s, wk, [&](int col0, int buf, float (&acc)[8][8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = ft::col_of(tx, j);
      if (col0 + cc >= D) continue;
      const float bj = s.bs[buf][0][cc], sj = s.bs[buf][1][cc];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float z = __fmul_rn(sj, cosf(__fadd_rn(acc[i][j], bj)));
        part[i] = __fmaf_rn(__ldg(theta + toff[i] + col0 + cc), z, part[i]);
      }
    }
  });
  // The 16 threads of a row are lanes tx of one half-warp.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = part[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int row = row0 + ft::row_of(ty, i);
    if (tx == 0 && row < R) out[row] = v;
  }
}

// --- bf16 on the tensor cores --------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;  // block tile, k a stage
constexpr int kStages = 3;
constexpr int kPitch = kBK + 8;  // bf16 a shared row (80 bytes): ldmatrix
                                 // rows fall in distinct banks
constexpr int kThreads = 256;    // 8 warps: 4 along rows x 2 along columns

struct Bf16Smem {
  __nv_bfloat16 a[kStages][kBM][kPitch];  // x rows, k contiguous
  __nv_bfloat16 w[kStages][kBN][kPitch];  // W columns (W^T), k contiguous
  float bs[kStages][2][kBN];              // a column tile's bias and scale
};  // 63 KB: dynamic shared memory

// Packed bf16 extents: dp = d rounded up to kBK, Rp and Dp to 128.
struct Bf16Dims {
  int dp, Rp, Dp;
};
inline Bf16Dims bf16_dims(int R, int d, int D) {
  return Bf16Dims{ft::round_up(d, kBK), ft::round_up(R, kBM),
                  ft::round_up(D, kBN)};
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// xb[r][k] = bf16(x[r][k]) (zero past R or d), two columns a thread:
// pairs first, first + stride, ... of Rp dp / 2.
__device__ __forceinline__ void pack_x_bf16_part(const float* __restrict__ x,
                                                 int R, int d,
                                                 uint32_t* __restrict__ xb,
                                                 int dp, int Rp,
                                                 long long first,
                                                 long long stride) {
  const int np = dp / 2;
  for (long long i = first; i < (long long)Rp * np; i += stride) {
    const int r = (int)(i / np), k = 2 * (int)(i % np);
    const float* xr = x + (size_t)r * d;
    const float lo = (r < R && k < d) ? __ldg(xr + k) : 0.f;
    const float hi = (r < R && k + 1 < d) ? __ldg(xr + k + 1) : 0.f;
    xb[i] = pack_bf16(lo, hi);
  }
}

// wb[n][k] = bf16(W[k][n]) (zero past D or d): W transposed; and the f32
// rows bs[0] = b, bs[1] = s (zero past D). Pairs first, first + stride,
// ... of Dp dp / 2.
__device__ __forceinline__ void pack_w_bf16_part(
    const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ s, int d, int D, uint32_t* __restrict__ wb,
    float* __restrict__ bs, int dp, int Dp, int first, int stride) {
  const int np = dp / 2;
  for (int i = first; i < Dp * np; i += stride) {
    const int n = i % Dp, k = 2 * (i / Dp);
    const float lo = (n < D && k < d) ? __ldg(w + (size_t)k * D + n) : 0.f;
    const float hi = (n < D && k + 1 < d) ? __ldg(w + (size_t)(k + 1) * D + n) : 0.f;
    wb[(size_t)n * np + k / 2] = pack_bf16(lo, hi);
    if (k == 0) {
      bs[n] = n < D ? __ldg(b + n) : 0.f;
      bs[Dp + n] = n < D ? __ldg(s + n) : 0.f;
    }
  }
}

__global__ void pack_x_bf16_kernel(const float* __restrict__ x, int R, int d,
                                   uint32_t* __restrict__ xb, int dp,
                                   int Rp) {
  pack_x_bf16_part(x, R, d, xb, dp, Rp,
                   blockIdx.x * (long long)blockDim.x + threadIdx.x,
                   (long long)gridDim.x * blockDim.x);
}

__global__ void pack_w_bf16_kernel(const float* __restrict__ w,
                                   const float* __restrict__ b,
                                   const float* __restrict__ s, int d, int D,
                                   uint32_t* __restrict__ wb,
                                   float* __restrict__ bs, int dp, int Dp) {
  pack_w_bf16_part(w, b, s, d, D, wb, bs, dp, Dp,
                   blockIdx.x * blockDim.x + threadIdx.x,
                   gridDim.x * blockDim.x);
}

// Both in one launch: blocks 0 .. xblocks - 1 pack x, the others W, b, s.
__global__ void pack_bf16_kernel(const float* __restrict__ x, int R, int d,
                                 uint32_t* __restrict__ xb,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 const float* __restrict__ s, int D,
                                 uint32_t* __restrict__ wb,
                                 float* __restrict__ bs, int dp, int Rp,
                                 int Dp, int xblocks) {
  const int blk = (int)blockIdx.x;
  if (blk < xblocks) {
    pack_x_bf16_part(x, R, d, xb, dp, Rp,
                     blk * (long long)blockDim.x + threadIdx.x,
                     (long long)xblocks * blockDim.x);
    return;
  }
  pack_w_bf16_part(w, b, s, d, D, wb, bs, dp, Dp,
                   (blk - xblocks) * blockDim.x + threadIdx.x,
                   ((int)gridDim.x - xblocks) * blockDim.x);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stage `step` (column tile step / nk, k-step step % nk) into ring slot
// step % kStages: 2 x 16-byte copies of x and 2 of W^T a thread; at a
// tile's first k-step also its bias and scale (into bs[tile % kStages]).
__device__ __forceinline__ void bf16_load(Bf16Smem& s,
                                          const __nv_bfloat16* __restrict__ xb,
                                          const __nv_bfloat16* __restrict__ wb,
                                          const float* __restrict__ bs,
                                          const Bf16Dims& g, int row0, int nk,
                                          int step) {
  const int col0 = (step / nk) * kBN;
  const int k0 = (step % nk) * kBK;
  const int slot = step % kStages;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = threadIdx.x + kThreads * h;  // chunk of 8 bf16
    const int r = c / 4, k = (c % 4) * 8;
    ft::cp_async16(&s.a[slot][r][k], xb + (size_t)(row0 + r) * g.dp + k0 + k);
    ft::cp_async16(&s.w[slot][r][k], wb + (size_t)(col0 + r) * g.dp + k0 + k);
  }
  if (k0 != 0) return;
  const int buf = (step / nk) % kStages;
  if (threadIdx.x < 64) {
    const int row = threadIdx.x / 32, off = (threadIdx.x % 32) * 4;
    ft::cp_async16(&s.bs[buf][row][off], bs + (size_t)row * g.Dp + col0 + off);
  }
}

// Warp (wm, wn) owns rows 32 wm + 16 mi + {g, g + 8} and columns 64 wn +
// 8 ni + 2 t + {0, 1} of the block tile (mi < 2, ni < 8; g = lane / 4,
// t = lane % 4): acc[mi][ni][2 h + c] is (row 16 mi + g + 8 h, column
// 8 ni + 2 t + c), the m16n8 accumulator layout.
__global__ void __launch_bounds__(kThreads, 2)
predict_bf16_kernel(const float* __restrict__ theta,
                    const __nv_bfloat16* __restrict__ xb,
                    const __nv_bfloat16* __restrict__ wb,
                    const float* __restrict__ bs, float* __restrict__ out,
                    int R, int Q, int D, Bf16Dims g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Bf16Smem& s = *reinterpret_cast<Bf16Smem*>(smem_raw);
  __shared__ float red[2][kBM];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int gq = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kBM;
  int toff[2][2];  // theta row of each of the thread's rows
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      toff[mi][h] = min(row0 + 32 * wm + 16 * mi + gq + 8 * h, R - 1) / Q * D;
  float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const int nk = g.dp / kBK;
  const int steps = (g.Dp / kBN) * nk;
  // ldmatrix row addresses: A lanes 0-15 rows 0-15 at k 0, 16-31 at k 8;
  // B lanes 0-7 / 16-23 columns 0-7 / 8-15 at k 0, 8-15 / 24-31 at k 8.
  const int a_row = 32 * wm + (lane % 16), a_k = (lane / 16) * 8;
  const int b_col = 64 * wn + (lane % 8) + (lane / 16) * 8;
  const int b_k = ((lane / 8) % 2) * 8;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < steps) bf16_load(s, xb, wb, bs, g, row0, nk, p);
    ft::cp_commit();
  }
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  for (int step = 0; step < steps; ++step) {
    ft::cp_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < steps)
      bf16_load(s, xb, wb, bs, g, row0, nk, step + kStages - 1);
    ft::cp_commit();
    const int slot = step % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &s.a[slot][a_row + 16 * mi][kk + a_k]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, &s.w[slot][b_col + 16 * np][kk + b_k]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (step % nk != nk - 1) continue;
    // Epilogue of a column tile: f32 bias, cos and scale, z rounded to
    // bf16, f32 dot with theta.
    const int col0 = (step / nk) * kBN;
    const int buf = (step / nk) % kStages;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cc = 64 * wn + 8 * ni + 2 * t + c;  // column in the tile
        if (col0 + cc >= D) continue;
        const float bj = s.bs[buf][0][cc], sj = s.bs[buf][1][cc];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float z = round_bf16(
                __fmul_rn(sj, cosf(__fadd_rn(acc[mi][ni][2 * h + c], bj))));
            part[mi][h] = __fmaf_rn(__ldg(theta + toff[mi][h] + col0 + cc), z,
                                    part[mi][h]);
          }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  }
  ft::cp_wait<0>();
  // The four lanes t of a row, then the two warps wn that share it.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = part[mi][h];
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) red[wn][32 * wm + 16 * mi + gq + 8 * h] = v;
    }
  __syncthreads();
  if (threadIdx.x < kBM && row0 + threadIdx.x < R)
    out[row0 + threadIdx.x] =
        __fadd_rn(red[0][threadIdx.x], red[1][threadIdx.x]);
}

// --- The few-row route -----------------------------------------------------

constexpr int kWave = 132;  // SMs of an H100 SXM: blocks a wave

// (a), f32: z[r][col0 + j] = s_j cos((x W)[r][col0 + j] + b_j) for the
// block's M rows (those below R) and its column tile blockIdx.y, all Dp
// columns (zero past D); U x U a thread (feature_tile.cuh).
template <int M, int U>
__global__ void __launch_bounds__(ft::threads_of<M, U>(), 2)
few_z_f32_kernel(const float* __restrict__ xT, const float* __restrict__ wp,
                 float* __restrict__ zw, int R, ft::Dims g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ft::SmemT<M>& s = *reinterpret_cast<ft::SmemT<M>*>(smem_raw);
  const int row0 = blockIdx.x * M;
  const int ty = threadIdx.x / (ft::kN / U), tx = threadIdx.x % (ft::kN / U);
  const ft::Walk wk{xT, wp, g.Rp, g.Dp, g.dp / ft::kK, row0, (int)blockIdx.y,
                    1};
  ft::walk<M, U>(s, wk, [&](int col0, int buf, float (&acc)[U][U]) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int row = row0 + ft::row_of<M, U>(ty, i);
      if (row >= R) continue;
      float* zr = zw + (size_t)row * g.Dp + col0;
#pragma unroll
      for (int h = 0; h < U / 4; ++h) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * h + c, cc = ft::col_of<U>(tx, j);
          v[c] = __fmul_rn(s.bs[buf][1][cc],
                           cosf(__fadd_rn(acc[i][j], s.bs[buf][0][cc])));
        }
        *reinterpret_cast<float4*>(zr + ft::col_of<U>(tx, 4 * h)) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  });
}

// (a), bf16: predict_bf16_kernel's block tile (row tile blockIdx.x) for
// column tile blockIdx.y alone, the same k-steps at the same fragment
// positions; z = bf16(s cos(acc + b)) for rows below R, all Dp columns.
__global__ void __launch_bounds__(kThreads, 2)
few_z_bf16_kernel(const __nv_bfloat16* __restrict__ xb,
                  const __nv_bfloat16* __restrict__ wb,
                  const float* __restrict__ bs, float* __restrict__ zw,
                  int R, Bf16Dims g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Bf16Smem& s = *reinterpret_cast<Bf16Smem*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int gq = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  // The column tile's W^T rows and bias and scale columns: bf16_load's
  // first tile.
  const __nv_bfloat16* wt = wb + (size_t)col0 * g.dp;
  const float* bst = bs + col0;
  const int nk = g.dp / kBK;
  const int a_row = 32 * wm + (lane % 16), a_k = (lane / 16) * 8;
  const int b_col = 64 * wn + (lane % 8) + (lane / 16) * 8;
  const int b_k = ((lane / 8) % 2) * 8;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nk) bf16_load(s, xb, wt, bst, g, row0, nk, p);
    ft::cp_commit();
  }
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  for (int step = 0; step < nk; ++step) {
    ft::cp_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < nk)
      bf16_load(s, xb, wt, bst, g, row0, nk, step + kStages - 1);
    ft::cp_commit();
    const int slot = step % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &s.a[slot][a_row + 16 * mi][kk + a_k]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, &s.w[slot][b_col + 16 * np][kk + b_k]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  ft::cp_wait<0>();
  // The tile's bias and scale landed in bs[0] with its first k-step.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 32 * wm + 16 * mi + gq + 8 * h;
      if (row >= R) continue;
      float* zr = zw + (size_t)row * g.Dp + col0;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int cc = 64 * wn + 8 * ni + 2 * t;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          v[c] = round_bf16(__fmul_rn(
              s.bs[0][1][cc + c],
              cosf(__fadd_rn(acc[mi][ni][2 * h + c], s.bs[0][0][cc + c]))));
        *reinterpret_cast<float2*>(zr + cc) = make_float2(v[0], v[1]);
      }
    }
}

// (b) runs on blocks of one warp, so that a few rows still spread over
// many SMs. A lane's chain is serial and its loads set the pace, so the
// full column tiles run in a loop of their own, unrolled by four with no
// branch, whose loads the compiler hoists ahead of the multiply-adds, 16
// (f32) or 8 (bf16) bytes a lane where theta's rows allow. That loop took
// the f32 reduce from 4.6 to 2.6 us at one tenant's read and from 15.3 to
// 7.3 us at D = 8192 (krls_breakdown.py --predict-few; NVIDIA H100 80GB
// HBM3, 700 W).
constexpr int kReduceThreads = 32;

// (b), f32: a half-warp a row; lane tx carries predict_f32_kernel's chain
// over its columns col_of(tx, j) of each column tile in order, then the
// same shuffles.
__global__ void __launch_bounds__(kReduceThreads)
few_reduce_f32_kernel(const float* __restrict__ theta,
                      const float* __restrict__ zw, float* __restrict__ out,
                      int R, int Q, int D, int Dp) {
  const int row = blockIdx.x * (kReduceThreads / 16) + threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int r = min(row, R - 1);
  const float* th = theta + (size_t)(r / Q) * D;
  const float* zr = zw + (size_t)r * Dp;
  // Full column tiles with 16-byte loads where theta's rows start on 16
  // bytes (z's always do: Dp is a multiple of 128), then the rest.
  const int full = ((D & 3) == 0 &&
                    reinterpret_cast<uintptr_t>(theta) % 16 == 0)
                       ? D / ft::kN
                       : 0;
  float v = 0.f;
#pragma unroll 4
  for (int col0 = 0; col0 < full * ft::kN; col0 += ft::kN) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + ft::col_of(tx, 4 * h);
      const float4 t4 = __ldg(reinterpret_cast<const float4*>(th + col));
      const float4 z4 = __ldg(reinterpret_cast<const float4*>(zr + col));
      v = __fmaf_rn(t4.x, z4.x, v);
      v = __fmaf_rn(t4.y, z4.y, v);
      v = __fmaf_rn(t4.z, z4.z, v);
      v = __fmaf_rn(t4.w, z4.w, v);
    }
  }
  for (int col0 = full * ft::kN; col0 < D; col0 += ft::kN) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + ft::col_of(tx, j);
      if (col < D) v = __fmaf_rn(__ldg(th + col), __ldg(zr + col), v);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (tx == 0 && row < R) out[row] = v;
}

// (b), bf16: eight lanes a row; lane 4 wn + t carries predict_bf16_kernel's
// chain of warp column half wn and lane t (columns 64 wn + 8 ni + 2 t + c,
// ni then c, each column tile in order), then the shuffles at 1 and 2 and
// the two halves' sum.
__global__ void __launch_bounds__(kReduceThreads)
few_reduce_bf16_kernel(const float* __restrict__ theta,
                       const float* __restrict__ zw, float* __restrict__ out,
                       int R, int Q, int D, int Dp) {
  const int row = blockIdx.x * (kReduceThreads / 8) + threadIdx.x / 8;
  const int l = threadIdx.x % 8, wn = l / 4, t = l % 4;
  const int r = min(row, R - 1);
  const float* th = theta + (size_t)(r / Q) * D;
  const float* zr = zw + (size_t)r * Dp;
  // Full column tiles with 8-byte loads where theta's rows start on 8
  // bytes, then the rest.
  const int full =
      ((D & 1) == 0 && reinterpret_cast<uintptr_t>(theta) % 8 == 0) ? D / kBN
                                                                     : 0;
  float v = 0.f;
#pragma unroll 4
  for (int col0 = 0; col0 < full * kBN; col0 += kBN) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = col0 + 64 * wn + 8 * ni + 2 * t;
      const float2 t2 = __ldg(reinterpret_cast<const float2*>(th + col));
      const float2 z2 = __ldg(reinterpret_cast<const float2*>(zr + col));
      v = __fmaf_rn(t2.x, z2.x, v);
      v = __fmaf_rn(t2.y, z2.y, v);
    }
  }
  for (int col0 = full * kBN; col0 < D; col0 += kBN) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + 64 * wn + 8 * ni + 2 * t + c;
        if (col < D) v = __fmaf_rn(__ldg(th + col), __ldg(zr + col), v);
      }
  }
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
  const float other = __shfl_xor_sync(0xffffffffu, v, 4);
  if (l == 0 && row < R) out[row] = __fadd_rn(v, other);
}

// Bytes of the packed operands one read needs (kernels/chunking.py's
// predict_workspace_bytes): f32 Wp (with b and s) then xT; bf16 b and s
// (f32), W^T, then x.
size_t workspace_bytes(int R, int d, int D, int bf16) {
  if (bf16) {
    const Bf16Dims g = bf16_dims(R, d, D);
    return 8 * (size_t)g.Dp + 2 * (size_t)g.dp * ((size_t)g.Dp + g.Rp);
  }
  return 4 * ft::pack_floats(R, d, D);
}

int launch_f32(const float* theta, const float* xq, const float* w,
               const float* b, const float* s, float* out, void* ws, int R,
               int Q, int d, int D, cudaStream_t st) {
  const ft::Dims g = ft::tile_dims(R, d, D);
  float* wp = static_cast<float*>(ws);  // W, b and s: (dp + 2, Dp)
  float* xT = wp + (size_t)(g.dp + 2) * g.Dp;
  cudaError_t rc = ft::pack_w(w, b, s, d, D, wp, st);
  if (rc == cudaSuccess) rc = ft::pack_x(ft::Rows{xq, R, 0, d}, R, D, xT, st);
  if (rc != cudaSuccess) return rc;
  const int smem = (int)ft::smem_bytes();
  rc = cudaFuncSetAttribute(predict_f32_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  predict_f32_kernel<<<g.Rp / ft::kM, ft::kThreads, smem, st>>>(
      theta, xT, wp, out, R, Q, D, g);
  return cudaGetLastError();
}

int launch_bf16(const float* theta, const float* xq, const float* w,
                const float* b, const float* s, float* out, void* ws, int R,
                int Q, int d, int D, cudaStream_t st) {
  const Bf16Dims g = bf16_dims(R, d, D);
  float* bs = static_cast<float*>(ws);  // b and s: (2, Dp) f32
  uint32_t* wb = reinterpret_cast<uint32_t*>(bs + 2 * (size_t)g.Dp);
  uint32_t* xb = wb + (size_t)g.Dp * g.dp / 2;
  const long long nx = (long long)g.Rp * g.dp / 2;
  pack_x_bf16_kernel<<<(int)((nx + 255) / 256 < 4096 ? (nx + 255) / 256 : 4096),
                       256, 0, st>>>(xq, R, d, xb, g.dp, g.Rp);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const int nw = g.Dp * g.dp / 2;
  pack_w_bf16_kernel<<<(nw + 255) / 256 < 1024 ? (nw + 255) / 256 : 1024,
                       256, 0, st>>>(w, b, s, d, D, wb, bs, g.dp, g.Dp);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const int smem = (int)sizeof(Bf16Smem);
  rc = cudaFuncSetAttribute(predict_bf16_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  predict_bf16_kernel<<<g.Rp / kBM, kThreads, smem, st>>>(
      theta, reinterpret_cast<const __nv_bfloat16*>(xb),
      reinterpret_cast<const __nv_bfloat16*>(wb), bs, out, R, Q, D, g);
  return cudaGetLastError();
}

// Bytes of the few-row route's workspace: the packed operands as above,
// then z (R, Dp) in f32 (kernels/chunking.py's predict_workspace_bytes).
size_t few_workspace_bytes(int R, int d, int D, int bf16) {
  return workspace_bytes(R, d, D, bf16) +
         4 * (size_t)R * ft::round_up(D, ft::kN);
}

template <int M, int U>
cudaError_t z_tiles_f32(const float* xT, const float* wp, float* zw, int R,
                      const ft::Dims& g, cudaStream_t st) {
  const auto kernel = few_z_f32_kernel<M, U>;
  constexpr size_t smem = ft::smem_bytes<M>();
  if (smem > 48 * 1024) {  // past the default (the 128-row tile)
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<dim3((unsigned)((R + M - 1) / M), g.Dp / ft::kN),
           ft::threads_of<M, U>(), smem, st>>>(xT, wp, zw, R, g);
  return cudaGetLastError();
}

// The z tiles' rows, as rff_features.cu plans them: 128 where 128-row
// tiles fill a wave of blocks, else 32 (the bits do not depend on it).
cudaError_t few_z_f32(const float* xT, const float* wp, float* zw, int R,
                      const ft::Dims& g, cudaStream_t st) {
  if ((long long)(g.Rp / ft::kM) * (g.Dp / ft::kN) >= kWave)
    return z_tiles_f32<ft::kM, 8>(xT, wp, zw, R, g, st);
  return z_tiles_f32<32, 4>(xT, wp, zw, R, g, st);
}

cudaError_t few_z_bf16(const __nv_bfloat16* xb, const __nv_bfloat16* wb,
                       const float* bs, float* zw, int R, const Bf16Dims& g,
                       cudaStream_t st) {
  const int smem = (int)sizeof(Bf16Smem);
  const cudaError_t rc = cudaFuncSetAttribute(
      few_z_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  few_z_bf16_kernel<<<dim3(g.Rp / kBM, g.Dp / kBN), kThreads, smem, st>>>(
      xb, wb, bs, zw, R, g);
  return cudaGetLastError();
}

cudaError_t few_reduce(const float* theta, const float* zw, float* out, int R,
                       int Q, int D, int Dp, int bf16, cudaStream_t st) {
  const int rows = kReduceThreads / (bf16 ? 8 : 16);  // rows a block
  const int blocks = (int)(((long long)R + rows - 1) / rows);
  if (bf16)
    few_reduce_bf16_kernel<<<blocks, kReduceThreads, 0, st>>>(theta, zw, out,
                                                             R, Q, D, Dp);
  else
    few_reduce_f32_kernel<<<blocks, kReduceThreads, 0, st>>>(theta, zw, out,
                                                            R, Q, D, Dp);
  return cudaGetLastError();
}

int few_f32(const float* theta, const float* xq, const float* w,
            const float* b, const float* s, float* out, void* ws, int R, int Q,
            int d, int D, cudaStream_t st) {
  const ft::Dims g = ft::tile_dims(R, d, D);
  float* wp = static_cast<float*>(ws);  // W, b and s: (dp + 2, Dp)
  float* xT = wp + (size_t)(g.dp + 2) * g.Dp;
  float* zw = xT + (size_t)g.dp * g.Rp;
  cudaError_t rc = ft::pack(ft::Rows{xq, R, 0, d}, R, w, b, s, D, xT, wp,
                            false, st);
  if (rc == cudaSuccess) rc = few_z_f32(xT, wp, zw, R, g, st);
  if (rc == cudaSuccess) rc = few_reduce(theta, zw, out, R, Q, D, g.Dp, 0, st);
  return rc;
}

int few_bf16(const float* theta, const float* xq, const float* w,
             const float* b, const float* s, float* out, void* ws, int R,
             int Q, int d, int D, cudaStream_t st) {
  const Bf16Dims g = bf16_dims(R, d, D);
  float* bs = static_cast<float*>(ws);  // b and s: (2, Dp) f32
  uint32_t* wb = reinterpret_cast<uint32_t*>(bs + 2 * (size_t)g.Dp);
  uint32_t* xb = wb + (size_t)g.Dp * g.dp / 2;
  float* zw = reinterpret_cast<float*>(xb + (size_t)g.Rp * g.dp / 2);
  const long long nx = (long long)g.Rp * g.dp / 2;
  const int xblocks = (int)((nx + 255) / 256 < 4096 ? (nx + 255) / 256 : 4096);
  const int nw = g.Dp * g.dp / 2;
  const int wblocks = (nw + 255) / 256 < 1024 ? (nw + 255) / 256 : 1024;
  pack_bf16_kernel<<<xblocks + wblocks, 256, 0, st>>>(
      xq, R, d, xb, w, b, s, D, wb, bs, g.dp, g.Rp, g.Dp, xblocks);
  cudaError_t rc = cudaGetLastError();
  if (rc == cudaSuccess)
    rc = few_z_bf16(reinterpret_cast<const __nv_bfloat16*>(xb),
                    reinterpret_cast<const __nv_bfloat16*>(wb), bs, zw, R, g,
                    st);
  if (rc == cudaSuccess) rc = few_reduce(theta, zw, out, R, Q, D, g.Dp, 1, st);
  return rc;
}

// B Q as R, or -1 where the entries refuse the shape.
long long rows_of(int B, int Q, int d, int D) {
  if (B < 1 || Q < 1 || d < 1 || D < 1) return -1;
  const long long rows = (long long)B * Q;
  if (rows > 0x7fffffffLL - 128 || (long long)B * D > 0x7fffffffLL) return -1;
  return rows;
}

}  // namespace

extern "C" {

// theta (B, D), xq (B, Q, d), w (d, D), b / s (D,) -> out (B, Q); ws a
// workspace of ws_bytes for the packed operands.
int bank_predict(const float* theta, const float* xq, const float* w,
                 const float* b, const float* s, float* out, void* ws,
                 long long ws_bytes, int B, int Q, int d, int D, int bf16,
                 void* stream) {
  const long long rows = rows_of(B, Q, d, D);
  if (rows < 0) return cudaErrorInvalidValue;
  const int R = (int)rows;
  if ((size_t)ws_bytes < workspace_bytes(R, d, D, bf16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_bf16(theta, xq, w, b, s, out, ws, R, Q, d, D, st);
  return launch_f32(theta, xq, w, b, s, out, ws, R, Q, d, D, st);
}

// The few-row route, the same arguments; ws of the few-row route's bytes.
int bank_predict_few(const float* theta, const float* xq, const float* w,
                     const float* b, const float* s, float* out, void* ws,
                     long long ws_bytes, int B, int Q, int d, int D, int bf16,
                     void* stream) {
  const long long rows = rows_of(B, Q, d, D);
  if (rows < 0 || (D + ft::kN - 1) / ft::kN > 65535)
    return cudaErrorInvalidValue;
  const int R = (int)rows;
  if ((size_t)ws_bytes < few_workspace_bytes(R, d, D, bf16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return few_bf16(theta, xq, w, b, s, out, ws, R, Q, d, D, st);
  return few_f32(theta, xq, w, b, s, out, ws, R, Q, d, D, st);
}

const char* bank_predict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
