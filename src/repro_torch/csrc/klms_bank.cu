// Fused RFF-KLMS bank kernels for Hopper (sm_90a).
//
// Replaces repro/kernels/rff_klms_step.py::rff_klms_bank_chunk_pallas
// (klms_bank_chunk: T masked ticks per tenant per launch) and
// ::rff_klms_bank_step_pallas (klms_bank_step: one unmasked tick). Per tick
// and tenant:  z = s * cos(x W + b),  y_hat = theta . z,  e = y - y_hat,
// theta += mu * m * e * z.
//
// What bounds it on this card: the projection x W is 2 d D flops per tenant
// and tick (8.6 GFLOP for B=1024, T=16, d=128, D=2048) plus D cosines, on
// the f32 CUDA cores; the bytes that must move (theta in and out, xs, W
// once) are a few tens of MB, so the work is bound by operations.
//
// Design: z_t = s * cos(x_t W + b) does not depend on theta; only theta . z
// and the update run in order over the ticks. So a call runs in two phases:
//  * Phase A (klms_features_kernel): the features of all B T rows of the
//    call, rows (b, t) in the order of xs (B, T, d), as one register-tiled
//    f32 GEMM with a cosine epilogue (feature_tile.cuh: x and W packed
//    first, then 128 x 128 tiles, 8 x 8 a thread, k-tiles through a
//    cp.async ring in shared memory), written to a (B, Ts, D) f32
//    workspace that the wrapper allocates (Ts = T unless B T D floats pass
//    the wrapper's workspace budget; then the two phases take the ticks in
//    slabs of Ts, theta carried through theta_out, which changes no bit).
//    W crosses L2 once per 128-row tile instead of once per tick per 8
//    tenants (the first design's 2 GiB of L2 reads a launch), and the grid
//    of B T / 128 x D / 128 tiles fills every SM.
//  * Phase B (klms_ticks_kernel): one warp per tenant keeps theta on chip
//    for all T ticks (NPL columns a lane in registers, lane + 32 i; in
//    shared memory past D = 2048) and per tick reads z_t coalesced, forms
//    theta . z_t as lane partials over the lane's columns in order and an
//    xor butterfly, and applies the update with explicit _rn intrinsics.
//    No barriers. A tick with m == 0 skips the update, so theta stays bit
//    for bit; theta' goes to a fresh buffer.
//  * klms_bank_step is klms_bank_chunk at T = 1 with no mask, so "a chunk at
//    T = 1 equals a step" holds by construction, and "a chunk of T equals T
//    steps" because a z element's bits depend on its x row and W column
//    alone (feature_tile.cuh) and the tick is the same code.
//  * A tenant's bits depend on nothing but its own rows: no split-K, no
//    atomics, padded rows and columns are zero and never feed another row.
//  * IEEE f32 throughout: no TF32, cosf and never __cosf (x W + b runs far
//    outside [-pi, pi]).
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_runtime.h>

#include "feature_tile.cuh"

namespace {

namespace ft = feature_tile;

constexpr int kTickWarps = 4;  // tenants a block of phase B (registers)

// Phase A: z[r][j] = s_j * cos((x W)[r][j] + b_j) for r < R, j < D, from
// the packed xT and Wp; one 128 x 128 tile a block.
__global__ void __launch_bounds__(ft::kThreads, ft::kMinBlocks)
klms_features_kernel(const float* __restrict__ xT, const float* __restrict__ wp,
                     float* __restrict__ z, int R, int D, ft::Dims g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ft::Smem& s = *reinterpret_cast<ft::Smem*>(smem_raw);
  const int row0 = blockIdx.x * ft::kM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool vec = (D & 3) == 0;  // rows of z start on 16 bytes
  const ft::Walk wk{xT, wp, g.Rp, g.Dp, g.dp / ft::kK, row0, (int)blockIdx.y, 1};
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

// A tick of one tenant on a warp: theta . z as lane partials in column
// order and an xor butterfly (every lane ends with the same sum), e = y -
// y_hat, and the update's coefficient mu (m e).
struct TickIn {
  float y, m, mu;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float update_coef(const TickIn& in, float pred,
                                             float* err) {
  const float e = __fsub_rn(in.y, pred);
  *err = e;
  return __fmul_rn(in.mu, __fmul_rn(in.m, e));
}

// Phase B over ticks t0 .. t0 + Ts - 1 of T: z holds their features as
// (B, Ts, D); ys, mask, pred and err are (B, T). theta may be theta_out (a
// later slab): each warp reads its own row before it writes it.
struct Slab {
  int t0, Ts, T;
  __device__ __forceinline__ size_t io(int b, int t) const {
    return (size_t)b * T + t0 + t;
  }
  __device__ __forceinline__ size_t zrow(int b, int t) const {
    return (size_t)b * Ts + t;
  }
};

// Phase B with theta in registers: NPL columns a lane (D <= 32 NPL).
template <int NPL>
__global__ void __launch_bounds__(32 * kTickWarps)
klms_ticks_kernel(const float* theta, const float* __restrict__ z,
                  const float* __restrict__ ys,
                  const float* __restrict__ mask,
                  const float* __restrict__ mu, float* theta_out,
                  float* __restrict__ pred, float* __restrict__ err, int B,
                  Slab sl, int D) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kTickWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp; the kernel has no barriers
  float th[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int j = lane + 32 * i;
    th[i] = j < D ? theta[(size_t)b * D + j] : 0.f;
  }
  const float mu_b = mu[b];
  for (int t = 0; t < sl.Ts; ++t) {
    const size_t o = sl.io(b, t);
    const float* zr = z + sl.zrow(b, t) * D;
    float zt[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int j = lane + 32 * i;
      zt[i] = j < D ? __ldg(zr + j) : 0.f;
    }
    const TickIn in{__ldg(ys + o), mask ? __ldg(mask + o) : 1.f, mu_b};
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if (lane + 32 * i < D) part = __fmaf_rn(th[i], zt[i], part);
    const float p = warp_sum(part);
    float e;
    const float c = update_coef(in, p, &e);
    if (in.m != 0.f) {
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        if (lane + 32 * i < D) th[i] = __fadd_rn(th[i], __fmul_rn(c, zt[i]));
    }
    if (lane == 0) {
      pred[o] = p;
      err[o] = e;
    }
  }
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int j = lane + 32 * i;
    if (j < D) theta_out[(size_t)b * D + j] = th[i];
  }
}

// Phase B with theta in shared memory (D > 32 * 64): one warp a block, the
// same column order and arithmetic as the register kernel, so the bits do
// not depend on which of the two runs.
__global__ void __launch_bounds__(32)
klms_ticks_smem_kernel(const float* theta, const float* __restrict__ z,
                       const float* __restrict__ ys,
                       const float* __restrict__ mask,
                       const float* __restrict__ mu, float* theta_out,
                       float* __restrict__ pred, float* __restrict__ err,
                       Slab sl, int D) {
  extern __shared__ float th[];  // [D]
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  for (int j = lane; j < D; j += 32) th[j] = theta[(size_t)b * D + j];
  const float mu_b = mu[b];
  for (int t = 0; t < sl.Ts; ++t) {
    const size_t o = sl.io(b, t);
    const float* zr = z + sl.zrow(b, t) * D;
    const TickIn in{__ldg(ys + o), mask ? __ldg(mask + o) : 1.f, mu_b};
    float part = 0.f;
    for (int j = lane; j < D; j += 32) part = __fmaf_rn(th[j], __ldg(zr + j), part);
    const float p = warp_sum(part);
    float e;
    const float c = update_coef(in, p, &e);
    if (in.m != 0.f)
      for (int j = lane; j < D; j += 32)
        th[j] = __fadd_rn(th[j], __fmul_rn(c, __ldg(zr + j)));
    if (lane == 0) {
      pred[o] = p;
      err[o] = e;
    }
  }
  for (int j = lane; j < D; j += 32) theta_out[(size_t)b * D + j] = th[j];
}

template <int NPL>
cudaError_t launch_ticks(const float* theta, const float* z, const float* ys,
                         const float* mask, const float* mu, float* theta_out,
                         float* pred, float* err, int B, Slab sl, int D,
                         cudaStream_t st) {
  const int grid = (B + kTickWarps - 1) / kTickWarps;
  klms_ticks_kernel<NPL><<<grid, 32 * kTickWarps, 0, st>>>(
      theta, z, ys, mask, mu, theta_out, pred, err, B, sl, D);
  return cudaGetLastError();
}

cudaError_t ticks(const float* theta, const float* z, const float* ys,
                  const float* mask, const float* mu, float* theta_out,
                  float* pred, float* err, int B, Slab sl, int D,
                  int reg_cols, cudaStream_t st) {
  switch (reg_cols) {
    case 4: return launch_ticks<4>(theta, z, ys, mask, mu, theta_out, pred, err, B, sl, D, st);
    case 16: return launch_ticks<16>(theta, z, ys, mask, mu, theta_out, pred, err, B, sl, D, st);
    case 64: return launch_ticks<64>(theta, z, ys, mask, mu, theta_out, pred, err, B, sl, D, st);
    case 0: break;
    default: return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * (size_t)D;
  cudaError_t rc = cudaFuncSetAttribute(
      klms_ticks_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return rc;
  klms_ticks_smem_kernel<<<B, 32, smem, st>>>(theta, z, ys, mask, mu,
                                              theta_out, pred, err, sl, D);
  return cudaGetLastError();
}

// Both phases of one call, slab by slab; mask may be null (all ones).
// reg_cols is the plan's columns a lane in registers (4, 16 or 64; 0 =
// shared memory); slab the ticks a (B, slab, D) workspace z holds; pk the
// packed operands (pk_floats of them).
int run(const float* theta, const float* xs, const float* ys,
        const float* mask, const float* mu, const float* w, const float* b,
        const float* s, float* z, float* pk, long long pk_floats,
        float* theta_out, float* pred, float* err, int B, int T, int d, int D,
        int reg_cols, int slab, cudaStream_t st) {
  if (B < 1 || T < 1 || d < 1 || D < 1 || slab < 1) return cudaErrorInvalidValue;
  if ((long long)B * T > 0x7fffffffLL || (D + ft::kN - 1) / ft::kN > 65535)
    return cudaErrorInvalidValue;
  const int max_rows = B * (slab < T ? slab : T);
  if ((size_t)pk_floats < ft::pack_floats(max_rows, d, D))
    return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      klms_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ft::smem_bytes());
  if (rc != cudaSuccess) return rc;
  const ft::Dims gmax = ft::tile_dims(max_rows, d, D);
  float* wp = pk;  // W, b and s: (dp + 2, Dp)
  float* xT = pk + (size_t)(gmax.dp + 2) * gmax.Dp;
  rc = ft::pack_w(w, b, s, d, D, wp, st);
  if (rc != cudaSuccess) return rc;
  for (int t0 = 0; t0 < T; t0 += slab) {
    const int ts = T - t0 < slab ? T - t0 : slab;
    const int rows = B * ts;
    const ft::Rows x{xs + (size_t)t0 * d, ts, (long long)T * d, d};
    const ft::Dims g = ft::tile_dims(rows, d, D);
    rc = ft::pack_x(x, rows, D, xT, st);
    if (rc != cudaSuccess) return rc;
    klms_features_kernel<<<dim3(g.Rp / ft::kM, g.Dp / ft::kN), ft::kThreads,
                           ft::smem_bytes(), st>>>(xT, wp, z, rows, D, g);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    rc = ticks(t0 == 0 ? theta : theta_out, z, ys, mask, mu, theta_out, pred,
               err, B, Slab{t0, ts, T}, D, reg_cols, st);
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// theta (B, D), xs (B, T, d), ys / mask (B, T) (mask may be null), mu
// (B,), w (d, D), b / s (D,); workspaces z (B, slab, D) and pk (pk_floats
// floats of packed operands); theta_out (B, D) and pred / err (B, T) are
// written.
int klms_bank_chunk(const float* theta, const float* xs, const float* ys,
                    const float* mask, const float* mu, const float* w,
                    const float* b, const float* s, float* z, float* pk,
                    long long pk_floats, float* theta_out, float* pred,
                    float* err, int B, int T, int d, int D, int reg_cols,
                    int slab, void* stream) {
  return run(theta, xs, ys, mask, mu, w, b, s, z, pk, pk_floats, theta_out,
             pred, err, B, T, d, D, reg_cols, slab,
             static_cast<cudaStream_t>(stream));
}

// One unmasked tick: the chunk at T = 1. x (B, d), y (B,), z (B, D).
int klms_bank_step(const float* theta, const float* x, const float* y,
                   const float* mu, const float* w, const float* b,
                   const float* s, float* z, float* pk, long long pk_floats,
                   float* theta_out, float* pred, float* err, int B, int d,
                   int D, int reg_cols, void* stream) {
  return run(theta, x, y, nullptr, mu, w, b, s, z, pk, pk_floats, theta_out,
             pred, err, B, 1, d, D, reg_cols, 1,
             static_cast<cudaStream_t>(stream));
}

const char* klms_bank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
