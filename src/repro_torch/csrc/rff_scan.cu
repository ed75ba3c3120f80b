// Per-chunk replay elements for Hopper (sm_90a): the time-blocked half of
// the parallel-in-time replay engine (core/scan.py, mode "blocked").
//
// Replaces repro/kernels/rff_scan.py:
//  * klms_chunk_elements <- rff_klms_chunk_elements_pallas. Per chunk of
//    Tc ticks, the composed affine map theta -> A theta + v, folded tick by
//    tick from (I, 0):
//        row = z A;  A <- A - mu_eff outer(z, row);
//        v <- v - mu_eff ((z . v) - y) z,
//    mu_eff = m mu, or m mu / (eps + z . z) for NKLMS.
//  * krls_chunk_elements <- rff_krls_chunk_elements_pallas. Per chunk, the
//    information-form element folded from (1, 0, 0):
//        g <- beta_eff g;  Phi <- beta_eff Phi + m outer(z, z);
//        r <- beta_eff r + (m y) z,
//    beta_eff = beta on a live tick.
//  A masked tick (m = 0) skips its update, so it composes the identity
//  exactly.
//
// The features z (nc * Tc, D) are made first by the feature-map kernel
// (csrc/rff_features.cu) into device memory; the wrapper launches both,
// so together they compute what the TPU kernel computes,
// (xs, ys, W, b, mu, mask, s) -> (A, v). z is 2 MB at Tc = 256, D = 2048
// and is read from L2.
//
// What bounds them on this card: a KLMS tick is 5 D^2 operations (the
// z A product and the three-operation rank-1 update) against a (D, D)
// element written once per chunk, so KLMS is bound by operations; a KRLS
// tick is 4 D^2 elementwise operations, also bound by operations.
//
// Design (the TPU kernels keep one chunk's (D, D) accumulator resident in
// VMEM across a sequential tick axis; on this card a (D, D) f32 tile does
// not fit a block's 227 KB at D = 2048, and blocks run in no order):
//  * KLMS. Column j of A' = A - mu_eff z (z A)^T depends only on column j
//    of A and on z, since row_j = sum_i z_i A_ij. So a block owns a strip
//    of `strip` columns of one chunk's A in shared memory for all Tc ticks
//    and writes it once. Thread (g, j) sums rows i = g, g + G, ... of
//    column j (G = 256 / strip row groups), the G partials are added in
//    order g = 0 .. G-1, and the same thread updates those rows. One extra
//    block per chunk folds v. NKLMS's z . z is one fixed-order block
//    reduction (thread chains, xor butterflies, warp slots in order), so
//    every block of a chunk gets the same mu_eff bit for bit.
//  * KRLS. Phi <- beta Phi + m z z^T is elementwise, so a block owns a
//    64 x 64 tile of one chunk's Phi in registers (16 values a thread) and
//    reads z_i, z_j from L2 each tick; one extra block per chunk folds g
//    and r.
//  Each update uses _rn intrinsics in the reference's operation order (no
//  contraction). Ragged D by bounds checks; 64-bit offsets (nc D^2 passes
//  2^31).
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // KRLS Phi tile edge
constexpr int kTileRows = kThreads / 32;  // rows covered per pass (8)

// Sum of a[i] * b[i] over i < n in a fixed order, the same value in every
// thread of the block. `slots` holds kWarps floats; the caller syncs
// before `a`/`b` are rewritten.
__device__ __forceinline__ float block_dot(const float* a, const float* b,
                                           int n, float* slots) {
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads)
    v = __fmaf_rn(a[i], b[i], v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) s = __fadd_rn(s, slots[k]);
  __syncthreads();  // slots may be reused right after
  return s;
}

// The tick's step size, identical in every block of a chunk.
__device__ __forceinline__ float tick_mu(const float* z_s, int D, float m,
                                         float mu, int normalized, float eps,
                                         float* slots) {
  float mu_t = mu;
  if (normalized)
    mu_t = __fdiv_rn(mu, __fadd_rn(eps, block_dot(z_s, z_s, D, slots)));
  return __fmul_rn(m, mu_t);
}

__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int D) {
  for (int i = threadIdx.x; i < D; i += kThreads) dst[i] = __ldg(src + i);
}

// Grid (strips + 1, nc). Blocks x < strips own columns
// [x * strip, x * strip + strip) of chunk y's A; block x == strips folds
// chunk y's v.
__global__ void __launch_bounds__(kThreads)
klms_elements_kernel(const float* __restrict__ z, const float* __restrict__ ys,
                     const float* __restrict__ mask, float* __restrict__ a_out,
                     float* __restrict__ v_out, int tc, int D, int strip,
                     float mu, int normalized, float eps) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.y;
  const int strips = gridDim.x - 1;
  float* z_s = smem;            // [D]
  float* slots = z_s + D;       // [kWarps]
  float* red = slots + kWarps;  // [kThreads]
  float* acc = red + kThreads;  // A strip [D][strip], or v [D]

  if ((int)blockIdx.x == strips) {  // ---- v block
    for (int i = threadIdx.x; i < D; i += kThreads) acc[i] = 0.f;
    __syncthreads();
    for (int t = 0; t < tc; ++t) {
      const size_t row = (size_t)chunk * tc + t;
      const float m = mask ? __ldg(mask + row) : 1.f;
      if (m == 0.f) continue;  // uniform: every thread reads the same m
      load_row(z_s, z + row * D, D);
      __syncthreads();
      const float mu_eff = tick_mu(z_s, D, m, mu, normalized, eps, slots);
      const float zv = block_dot(z_s, acc, D, slots);
      const float c = __fmul_rn(mu_eff, __fsub_rn(zv, __ldg(ys + row)));
      for (int i = threadIdx.x; i < D; i += kThreads)
        acc[i] = __fsub_rn(acc[i], __fmul_rn(c, z_s[i]));
      __syncthreads();
    }
    for (int i = threadIdx.x; i < D; i += kThreads)
      v_out[(size_t)chunk * D + i] = acc[i];
    return;
  }

  // ---- A strip block
  const int groups = kThreads / strip;
  const int j = threadIdx.x % strip;
  const int g = threadIdx.x / strip;
  const int col = blockIdx.x * strip + j;
  for (int i = g; i < D; i += groups) acc[i * strip + j] = (i == col) ? 1.f : 0.f;
  __syncthreads();
  for (int t = 0; t < tc; ++t) {
    const size_t row = (size_t)chunk * tc + t;
    const float m = mask ? __ldg(mask + row) : 1.f;
    if (m == 0.f) continue;
    load_row(z_s, z + row * D, D);
    __syncthreads();
    const float mu_eff = tick_mu(z_s, D, m, mu, normalized, eps, slots);
    float part = 0.f;
    for (int i = g; i < D; i += groups)
      part = __fmaf_rn(z_s[i], acc[i * strip + j], part);
    red[g * strip + j] = part;
    __syncthreads();
    float row_j = 0.f;
    for (int k = 0; k < groups; ++k) row_j = __fadd_rn(row_j, red[k * strip + j]);
    for (int i = g; i < D; i += groups) {
      const float upd = __fmul_rn(mu_eff, __fmul_rn(z_s[i], row_j));
      acc[i * strip + j] = __fsub_rn(acc[i * strip + j], upd);
    }
    __syncthreads();
  }
  if (col < D) {
    float* dst = a_out + (size_t)chunk * D * D + col;
    for (int i = g; i < D; i += groups) dst[(size_t)i * D] = acc[i * strip + j];
  }
}

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
// live); a_out (nc, D, D), v_out (nc, D). strip divides 256.
int klms_chunk_elements(const float* z, const float* ys, const float* mask,
                        float* a_out, float* v_out, int nc, int tc, int D,
                        int strip, float mu, int normalized, float eps,
                        void* stream) {
  if (nc < 0 || tc < 1 || D < 1 || strip < 1 || kThreads % strip != 0)
    return cudaErrorInvalidValue;
  if (nc == 0) return cudaSuccess;
  const int strips = (D + strip - 1) / strip;
  if (nc > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem =
      sizeof(float) * ((size_t)D * (strip + 1) + kWarps + kThreads);
  cudaError_t rc = cudaFuncSetAttribute(
      klms_elements_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(strips + 1, nc);
  klms_elements_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      z, ys, mask, a_out, v_out, tc, D, strip, mu, normalized, eps);
  return cudaGetLastError();
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
