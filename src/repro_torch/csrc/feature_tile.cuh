// The f32 feature tile shared by klms_bank.cu, bank_predict.cu,
// rff_features.cu and rff_scan.cu: one block of 256 threads forms 128 x 128
// tiles of x W on the f32 CUDA cores, for one or several column tiles of
// the same 128 rows. The tile's row count M and a thread's U x U register
// tile are template parameters: the default M = kM = 128, U = 8 (2 M
// threads); for calls with few rows M = 32, U = 4 (8 M threads), which
// gives the card four times the blocks of 256 threads. Neither changes
// an element's bits.
//
// * Operands are packed first (pack_x_kernel, pack_w_kernel), so that the
//   main loop has no bounds checks and copies 16-byte chunks: x, R rows of
//   d floats placed by Rows, goes transposed into xT (dp, Rp), W (d, D)
//   into rows 0 .. dp - 1 of Wp (dp + 2, Dp) and the bias and scale into
//   its last two rows, all zero-padded (dp, Rp and Dp rounded up to kK,
//   kM and kN; tile_dims). A call packs once: 1 MiB of W and the rows' x.
//   pack_kernel packs both in one launch, and for a bf16 route rounds x
//   and W (not b and s) to bf16 as it packs.
//   A column tile's bias and scale ride the ring with its first k-tile, so
//   the epilogue reads them from shared memory.
// * The main loop streams k-tiles of 16 through a ring of kStages buffers
//   in shared memory with cp.async (16 bytes a copy, no registers held);
//   one barrier a k-tile. The ring runs on across column tiles, so the
//   next tile's first loads are in flight while the epilogue of the last
//   one runs.
// * Thread (ty, tx) = (tid / 16, tid % 16) owns an 8 x 8 register tile:
//   rows ty * 4 + {0..3} and M / 2 + ty * 4 + {0..3}, columns tx * 4 +
//   {0..3} and 64 + tx * 4 + {0..3} (row_of, col_of; the rows split at
//   M / 2). Per k it reads two float4s of x and two of W for 64
//   multiply-adds. At U = 4, thread (tid / 32, tid % 32) owns rows ty * 4
//   + {0..3} and columns tx * 4 + {0..3}: one float4 of each a k for 16.
// * Every element accumulates over k = 0 .. d - 1 in order, one __fmaf_rn
//   each, from +0; the padded k add fmaf(0, 0, acc) = acc exactly, and no
//   row feeds another. So an element's bits depend on its row of x and its
//   column of W alone, never on the tile it lands in: no split-K, no TF32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace feature_tile {

constexpr int kM = 128;  // rows a tile
constexpr int kN = 128;  // columns a tile
constexpr int kK = 16;   // k a stage
constexpr int kStages = 3;
constexpr int kThreads = kM * 2;  // (kM / 8) x 16 threads of 8 x 8
constexpr int kMinBlocks = 2;     // blocks an SM (128 registers a thread)

template <int M>
struct SmemT {
  float a[kStages][kK][M];  // x, transposed
  float w[kStages][kK][kN];
  float bs[kStages][2][kN];  // a column tile's bias and scale
};  // 49.5 KB at M = 128: dynamic shared memory (smem_bytes)
using Smem = SmemT<kM>;

template <int M = kM>
constexpr size_t smem_bytes() { return sizeof(SmemT<M>); }

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The packed extents (dp, Rp, Dp) of R rows, d and D.
struct Dims {
  int dp, Rp, Dp;
};
__host__ __device__ inline Dims tile_dims(int R, int d, int D) {
  return Dims{round_up(d, kK), round_up(R, kM), round_up(D, kN)};
}

// Threads of a block with M rows and U x U a thread (U = 8 or 4).
template <int M, int U>
__host__ __device__ constexpr int threads_of() {
  return M / U * (kN / U);
}

template <int M = kM, int U = 8>
__device__ __forceinline__ int row_of(int ty, int i) {
  return U == 8 ? (i < 4 ? 0 : M / 2) + ty * 4 + (i & 3) : ty * 4 + i;
}
template <int U = 8>
__device__ __forceinline__ int col_of(int tx, int j) {
  return U == 8 ? (j < 4 ? 0 : 64) + tx * 4 + (j & 3) : tx * 4 + j;
}

// Where row r of x starts: rows come in groups of `per` rows `d` apart,
// groups `stride` apart, from `base` (a (B, T, d) array read ticks t0 ..
// t0 + per - 1 of each b: base = xs + t0 d, per = the ticks, stride = T d;
// a plain (R, d) matrix: per = R).
struct Rows {
  const float* base;
  int per;
  long long stride;
  int d;
  __device__ __forceinline__ const float* row(int r) const {
    return base + (size_t)(r / per) * stride + (size_t)(r % per) * d;
  }
};

// v, or v rounded to bf16 (and back: exact in f32) when kRound.
template <bool kRound>
__device__ __forceinline__ float packed(float v) {
  return kRound ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// xT[k][r] = x[r][k] (zero past R or d) for the 32 x 32 tile (bx, by),
// through shared memory so that both sides are coalesced; block (32, 8).
template <bool kRound>
__device__ __forceinline__ void pack_x_tile(const Rows& x, int R,
                                            float* __restrict__ xT, int dp,
                                            int Rp, int bx, int by) {
  __shared__ float t[32][33];
  const int r0 = bx * 32, k0 = by * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, k = k0 + threadIdx.x;
    t[i][threadIdx.x] =
        (r < R && k < x.d) ? packed<kRound>(__ldg(x.row(r) + k)) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, r = r0 + threadIdx.x;
    if (k < dp) xT[(size_t)k * Rp + r] = t[threadIdx.x][i];
  }
}

// wp[k][j] = w[k][j] for k < dp, then the rows b and s (zero past d or
// D; W rounded when kRound, b and s never), float4s first, first +
// stride, ... of (dp + 2) * Dp / 4.
template <bool kRound>
__device__ __forceinline__ void pack_w_part(const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            const float* __restrict__ s,
                                            int d, int D,
                                            float* __restrict__ wp, int dp,
                                            int Dp, int first, int stride) {
  const int n4 = Dp / 4;
  for (int i = first; i < (dp + 2) * n4; i += stride) {
    const int k = i / n4, j = (i % n4) * 4;
    const float* src = k < dp ? (k < d ? w + (size_t)k * D : nullptr)
                              : (k == dp ? b : s);
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = (src != nullptr && j + c < D) ? __ldg(src + j + c) : 0.f;
      if (k < dp) v[c] = packed<kRound>(v[c]);
    }
    *reinterpret_cast<float4*>(wp + (size_t)k * Dp + j) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Grid (Rp / 32, dp / 32), block (32, 8).
__global__ void pack_x_kernel(const Rows x, int R, float* __restrict__ xT,
                              int dp, int Rp) {
  pack_x_tile<false>(x, R, xT, dp, Rp, blockIdx.x, blockIdx.y);
}

// Grid over (dp + 2) * Dp / 4 float4s.
__global__ void pack_w_kernel(const float* __restrict__ w,
                              const float* __restrict__ b,
                              const float* __restrict__ s, int d, int D,
                              float* __restrict__ wp, int dp, int Dp) {
  pack_w_part<false>(w, b, s, d, D, wp, dp, Dp,
                     blockIdx.x * blockDim.x + threadIdx.x,
                     gridDim.x * blockDim.x);
}

// Both in one launch: blocks 0 .. xb - 1 (xb = Rp / 32 * dp / 32) pack x
// tiles, the other wb pack W. Block (32, 8).
template <bool kRound>
__global__ void pack_kernel(const Rows x, int R, float* __restrict__ xT,
                            const float* __restrict__ w,
                            const float* __restrict__ b,
                            const float* __restrict__ s, int D,
                            float* __restrict__ wp, Dims g) {
  const int xcols = g.Rp / 32, xb = xcols * ((g.dp + 31) / 32);
  if ((int)blockIdx.x < xb) {
    pack_x_tile<kRound>(x, R, xT, g.dp, g.Rp, blockIdx.x % xcols,
                        blockIdx.x / xcols);
    return;
  }
  const int tid = threadIdx.y * 32 + threadIdx.x;
  pack_w_part<kRound>(w, b, s, x.d, D, wp, g.dp, g.Dp,
                      ((int)blockIdx.x - xb) * 256 + tid,
                      ((int)gridDim.x - xb) * 256);
}

// Floats of the packed operands for R rows: Wp ((dp + 2) Dp), then xT.
__host__ __device__ inline size_t pack_floats(int R, int d, int D) {
  const Dims g = tile_dims(R, d, D);
  return (size_t)(g.dp + 2) * g.Dp + (size_t)g.dp * g.Rp;
}

// Pack x (into xT) and W, b, s (into Wp) for R rows.
inline cudaError_t pack_x(const Rows& x, int R, int D, float* xT,
                          cudaStream_t st) {
  const Dims g = tile_dims(R, x.d, D);
  pack_x_kernel<<<dim3(g.Rp / 32, (g.dp + 31) / 32), dim3(32, 8), 0, st>>>(
      x, R, xT, g.dp, g.Rp);
  return cudaGetLastError();
}
inline cudaError_t pack_w(const float* w, const float* b, const float* s,
                          int d, int D, float* wp, cudaStream_t st) {
  const Dims g = tile_dims(1, d, D);
  const int n = (g.dp + 2) * (g.Dp / 4);
  pack_w_kernel<<<(n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024, 256, 0,
                  st>>>(w, b, s, d, D, wp, g.dp, g.Dp);
  return cudaGetLastError();
}
// x (into xT) and W, b, s (into wp) in one launch; bf16 rounds x and W.
inline cudaError_t pack(const Rows& x, int R, const float* w, const float* b,
                        const float* s, int D, float* xT, float* wp,
                        bool bf16, cudaStream_t st) {
  const Dims g = tile_dims(R, x.d, D);
  const int xb = g.Rp / 32 * ((g.dp + 31) / 32);
  const int n = (g.dp + 2) * (g.Dp / 4);
  const int wb = (n + 255) / 256 < 256 ? (n + 255) / 256 : 256;
  if (bf16)
    pack_kernel<true><<<xb + wb, dim3(32, 8), 0, st>>>(x, R, xT, w, b, s, D,
                                                       wp, g);
  else
    pack_kernel<false><<<xb + wb, dim3(32, 8), 0, st>>>(x, R, xT, w, b, s,
                                                        D, wp, g);
  return cudaGetLastError();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The packed operands of one block and its walk: column tiles col_tile0,
// col_tile0 + 1, ... (ntiles of them) of the block's 128 rows from row0.
struct Walk {
  const float* xT;
  const float* wp;
  int Rp, Dp, nk;  // nk = dp / kK
  int row0, col_tile0, ntiles;
};

// Stage `step` (column tile step / nk, k-tile step % nk) into ring slot
// step % kStages: 16-byte copies of x and W; at a tile's first k-tile
// also its bias and scale (into bs[tile % kStages]). T threads (>= 64).
template <int M, int T>
__device__ __forceinline__ void load_stage(SmemT<M>& s, const Walk& wk,
                                           int step) {
  constexpr int xq = kK * M / 4;  // chunks of 4 floats of x a stage
  const int tile = wk.col_tile0 + step / wk.nk;
  const int k0 = (step % wk.nk) * kK;
  const int slot = step % kStages;
#pragma unroll
  for (int h = 0; h < (xq + T - 1) / T; ++h) {
    const int c = threadIdx.x + T * h;  // chunk of 4 floats of x
    if (xq % T != 0 && c >= xq) break;
    const int k = c / (M / 4), off = (c % (M / 4)) * 4;
    cp_async16(&s.a[slot][k][off],
               wk.xT + (size_t)(k0 + k) * wk.Rp + wk.row0 + off);
  }
#pragma unroll
  for (int h = 0; h < kK * kN / 4 / T; ++h) {
    const int c = threadIdx.x + T * h;  // chunk of 4 floats of W
    const int k = c / (kN / 4), off = (c % (kN / 4)) * 4;
    cp_async16(&s.w[slot][k][off],
               wk.wp + (size_t)(k0 + k) * wk.Dp + tile * kN + off);
  }
  if (k0 == 0) {
    const int buf = (step / wk.nk) % kStages;
    if (threadIdx.x < 64) {
      const int row = threadIdx.x / 32, off = (threadIdx.x % 32) * 4;
      cp_async16(&s.bs[buf][row][off],
                 wk.wp + (size_t)(wk.nk * kK + row) * wk.Dp + tile * kN + off);
    }
  }
}

// For each column tile of the walk in order, acc[i][j] = sum over k < d,
// in order, of x[row0 + row_of(ty, i)][k] * W[k][col + col_of(tx, j)],
// then epi(col, buf, acc) with col the tile's first column and
// s.bs[buf] its bias and scale. Every thread of the block calls it; it
// returns after a barrier, so the caller may reuse the shared memory.
// A block of threads_of<M, U>() threads; acc is U x U (row_of<M, U>,
// col_of<U>).
template <int M, int U = 8, class Epi>
__device__ __forceinline__ void walk(SmemT<M>& s, const Walk& wk, Epi&& epi) {
  constexpr int T = threads_of<M, U>();
  const int ty = threadIdx.x / (kN / U), tx = threadIdx.x % (kN / U);
  const int steps = wk.ntiles * wk.nk;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < steps) load_stage<M, T>(s, wk, p);
    cp_commit();
  }
  float acc[U][U];
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int j = 0; j < U; ++j) acc[i][j] = 0.f;
  for (int step = 0; step < steps; ++step) {
    cp_wait<kStages - 2>();
    // Stage `step` has landed for every thread, and every thread is done
    // with the slot that the next load overwrites (read at step - 1).
    __syncthreads();
    if (step + kStages - 1 < steps)
      load_stage<M, T>(s, wk, step + kStages - 1);
    cp_commit();
    const int slot = step % kStages;
    if constexpr (U == 4) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float4 a =
            *reinterpret_cast<const float4*>(&s.a[slot][k][ty * 4]);
        const float4 b =
            *reinterpret_cast<const float4*>(&s.w[slot][k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&s.a[slot][k][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&s.a[slot][k][M / 2 + ty * 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&s.w[slot][k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&s.w[slot][k][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    }
    if (step % wk.nk == wk.nk - 1) {
      epi((wk.col_tile0 + step / wk.nk) * kN, (step / wk.nk) % kStages, acc);
#pragma unroll
      for (int i = 0; i < U; ++i)
#pragma unroll
        for (int j = 0; j < U; ++j) acc[i][j] = 0.f;
    }
  }
  cp_wait<0>();
  __syncthreads();
}

}  // namespace feature_tile
