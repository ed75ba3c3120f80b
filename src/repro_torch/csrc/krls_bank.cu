// Fused RFF-KRLS (EW-RLS) bank kernels for Hopper (sm_90a).
//
// Replaces repro/kernels/rff_krls_step.py::rff_krls_bank_chunk_pallas
// (krls_bank_chunk: T masked ticks per tenant per launch) and
// ::rff_krls_bank_step_pallas (krls_bank_step: one unmasked tick). Per tick
// and tenant, the paper's section 6 recursion:
//   z = s * cos(x W + b),  y_hat = theta . z,  e = y - y_hat,
//   pz = P z,  denom = beta + z . pz,  g = pz / denom,  theta += g e,
//   P'' = (P - g pz^T) / beta,  P <- 0.5 (P'' + P''^T).
//
// What bounds it on this card: each tenant carries a (D, D) f32 P, 360 KB
// at D = 300 and 369 MB for a bank of 1024. Reading and writing P once is
// 8 B D^2 bytes; the arithmetic is about 7 D^2 operations per tick, so the
// work is bound by bytes.
//
// Design (a first version that is simple and right for every D):
//  * One block owns one tenant for the whole launch. The TPU kernel carries
//    theta and P across T with a minor grid axis that runs in order; GPU
//    blocks run in no order, so T is a loop inside the block.
//  * P does not fit shared memory (227 KB a block), unlike the TPU's VMEM
//    where the Pallas kernel pins it. P stays in device memory and every
//    tick streams it twice: once for pz (one warp per row, coalesced) and
//    once for the downdate, which reads and writes it. That is 12 B D^2
//    bytes a tick, T times the structural minimum of the chunk.
//  * theta, z, pz and g live in shared memory across the T ticks.
//  * The downdate is done in place, in pairs of 32 x 32 tiles: a warp loads
//    tile (I, J) and its twin (J, I) through shared memory (both loads
//    coalesced), computes 0.5 (P''_ij + P''_ji) for every pair, and writes
//    the value to both halves. No element is read after its twin is
//    written, and the output is bitwise symmetric.
//  * The chunk reads p_in until its first tick that updates and p_out (in
//    place) after it; a chunk whose ticks are all masked copies p_in. A
//    masked tick skips the update, so theta and P stay bit for bit.
//  * Both entry points call the same __device__ tick, and the arithmetic
//    uses explicit _rn intrinsics that the compiler may not contract into
//    FMAs differently in the two contexts: a chunk of T ticks equals T step
//    launches bit for bit. Reductions are fixed-order trees (no atomics).
//  * The arithmetic order is the reference's: the gain and the downdate
//    divide (no reciprocal multiply); pz[i] reads row i of P, so a P that
//    is not symmetric is taken as it is.
//  * P offsets are 64-bit: B D^2 passes 2^31 at D = 2048, B = 1024.
//  * cosf, never __cosf: x W + b runs far outside [-pi, pi].
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kPitch = kTile + 1;  // padded rows: column reads hit 32 banks
constexpr int kTileFloats = 2 * kTile * kPitch;
constexpr int kScalars = 3;

// Shared-memory layout of one block (krls_smem_bytes in chunking.py).
struct Tiles {
  float* theta;  // [D]
  float* z;      // [D]
  float* pz;     // [D]
  float* gain;   // [D]
  float* x;      // [d]
  float* red;    // [kWarps]
  float* sc;     // [kScalars]: y, mask, beta (kY, kMask, kBeta)
  float* tiles;  // [kWarps][2][kTile][kPitch]
};

enum { kY = 0, kMask = 1, kBeta = 2 };

__device__ Tiles carve(float* smem, int d, int D) {
  Tiles t;
  t.theta = smem;
  t.z = t.theta + D;
  t.pz = t.z + D;
  t.gain = t.pz + D;
  t.x = t.gain + D;
  t.red = t.x + d;
  t.sc = t.red + kWarps;
  t.tiles = t.sc + kScalars;
  return t;
}

size_t smem_bytes(int d, int D) {
  return sizeof(float) *
         (4 * (size_t)D + d + kWarps + kScalars + (size_t)kWarps * kTileFloats);
}

// Sum of v over the block in a fixed order; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float acc = 0.f;
  for (int w = 0; w < kWarps; ++w) acc = __fadd_rn(acc, red[w]);
  __syncthreads();
  return acc;
}

// The symmetrised downdate of tile pair (I, J), I <= J, by one warp:
// dst[i][j] = dst[j][i] = 0.5 (P''_ij + P''_ji) for i in tile I, j in tile
// J, reading P from src (which may equal dst).
__device__ void downdate_pair(const Tiles& t, const float* src, float* dst,
                              int I, int J, float beta, int D) {
  const int lane = threadIdx.x & 31;
  float* a = t.tiles + (threadIdx.x >> 5) * kTileFloats;  // rows of I
  float* bt = a + kTile * kPitch;                          // rows of J
  const int i0 = I * kTile, j0 = J * kTile;
  for (int r = 0; r < kTile; ++r) {
    const int i = i0 + r, j = j0 + lane;
    a[r * kPitch + lane] = (i < D && j < D) ? src[(size_t)i * D + j] : 0.f;
    const int jr = j0 + r, ic = i0 + lane;
    bt[r * kPitch + lane] = (jr < D && ic < D) ? src[(size_t)jr * D + ic] : 0.f;
  }
  __syncwarp();
  const int j = j0 + lane;
  if (j < D) {
    const float pzj = t.pz[j];
    const float gj = t.gain[j];
    for (int r = 0; r < kTile && i0 + r < D; ++r) {
      const int i = i0 + r;
      const float pij = a[r * kPitch + lane];
      const float pji = bt[lane * kPitch + r];
      const float dij = __fdiv_rn(__fsub_rn(pij, __fmul_rn(t.gain[i], pzj)), beta);
      const float dji = __fdiv_rn(__fsub_rn(pji, __fmul_rn(gj, t.pz[i])), beta);
      a[r * kPitch + lane] = __fmul_rn(0.5f, __fadd_rn(dij, dji));
    }
  }
  __syncwarp();
  for (int r = 0; r < kTile; ++r) {
    const int i = i0 + r, jc = j0 + lane;
    if (i < D && jc < D) dst[(size_t)i * D + jc] = a[r * kPitch + lane];
    const int jr = j0 + r, ic = i0 + lane;
    if (I != J && jr < D && ic < D) dst[(size_t)jr * D + ic] = a[lane * kPitch + r];
  }
  __syncwarp();
}

// One EW-RLS tick of the block's tenant. t.x, t.sc[kY] and t.sc[kMask]
// hold this tick's inputs; theta (shared) is updated, and P is read from
// src and, when the tick is live, written to dst. Returns the prediction.
__device__ float krls_tick(const Tiles& t, const float* src, float* dst,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ scale, int d, int D) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // z = s cos(x W + b) and the partial sums of theta . z.
  float part = 0.f;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < d; ++k)
      acc = __fmaf_rn(t.x[k], __ldg(w + (size_t)k * D + j), acc);
    const float zj = __fmul_rn(__ldg(scale + j), cosf(__fadd_rn(acc, __ldg(bias + j))));
    t.z[j] = zj;
    part = __fmaf_rn(t.theta[j], zj, part);
  }
  const float pred = block_sum(part, t.red);  // also publishes t.z
  // pz[i] = sum_j P[i, j] z[j]: one warp per row, lanes along the row.
  for (int i = warp; i < D; i += kWarps) {
    const float* row = src + (size_t)i * D;
    float acc = 0.f;
    for (int j = lane; j < D; j += 32) acc = __fmaf_rn(row[j], t.z[j], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) t.pz[i] = acc;
  }
  __syncthreads();
  part = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads)
    part = __fmaf_rn(t.z[i], t.pz[i], part);
  const float beta = t.sc[kBeta];
  const float denom = __fadd_rn(beta, block_sum(part, t.red));
  if (!(t.sc[kMask] > 0.f)) return pred;  // block-uniform: skip the update
  const float e = __fsub_rn(t.sc[kY], pred);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float g = __fdiv_rn(t.pz[i], denom);
    t.gain[i] = g;
    t.theta[i] = __fadd_rn(t.theta[i], __fmul_rn(g, e));
  }
  __syncthreads();
  const int nt = (D + kTile - 1) / kTile;
  int pair = 0;
  for (int I = 0; I < nt; ++I)
    for (int J = I; J < nt; ++J, ++pair)
      if (pair % kWarps == warp) downdate_pair(t, src, dst, I, J, beta, D);
  __syncthreads();  // dst is the next tick's src
  return pred;
}

// The tenant's theta into shared memory, and its beta.
__device__ void load_state(const Tiles& t, const float* __restrict__ theta,
                           const float* __restrict__ beta, int b, int D) {
  for (int i = threadIdx.x; i < D; i += kThreads)
    t.theta[i] = theta[(size_t)b * D + i];
  if (threadIdx.x == 0) t.sc[kBeta] = beta[b];
}

// This tick's x row, target and gate (mask may be null: all ones).
__device__ void load_tick(const Tiles& t, const float* __restrict__ xs,
                          const float* __restrict__ ys,
                          const float* __restrict__ mask, int b, int T,
                          int tick, int d) {
  const size_t row = (size_t)b * T + tick;
  for (int k = threadIdx.x; k < d; k += kThreads) t.x[k] = xs[row * d + k];
  if (threadIdx.x == 0) {
    t.sc[kY] = ys[row];
    t.sc[kMask] = mask ? mask[row] : 1.f;
  }
  __syncthreads();
}

__device__ void store_outputs(const Tiles& t, float pred,
                              float* __restrict__ pred_out,
                              float* __restrict__ err_out, int b, int T,
                              int tick) {
  if (threadIdx.x == 0) {
    const size_t o = (size_t)b * T + tick;
    pred_out[o] = pred;
    err_out[o] = __fsub_rn(t.sc[kY], pred);
  }
}

__device__ void store_theta(const Tiles& t, float* __restrict__ theta_out,
                            int b, int D) {
  for (int i = threadIdx.x; i < D; i += kThreads)
    theta_out[(size_t)b * D + i] = t.theta[i];
}

// p_in and p_out are not __restrict__: p_out is read back after the block
// writes it, and no load of it may take the non-coherent path.
__global__ void __launch_bounds__(kThreads)
krls_bank_chunk_kernel(const float* __restrict__ theta, const float* p_in,
                       const float* __restrict__ xs,
                       const float* __restrict__ ys,
                       const float* __restrict__ mask,
                       const float* __restrict__ beta,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ scale,
                       float* __restrict__ theta_out, float* p_out,
                       float* __restrict__ pred, float* __restrict__ err,
                       int T, int d, int D) {
  extern __shared__ float smem[];
  const Tiles t = carve(smem, d, D);
  const int b = blockIdx.x;
  const size_t off = (size_t)b * D * D;
  const float* src = p_in + off;
  float* dst = p_out + off;
  load_state(t, theta, beta, b, D);
  for (int tick = 0; tick < T; ++tick) {
    load_tick(t, xs, ys, mask, b, T, tick, d);
    const float p = krls_tick(t, src, dst, w, bias, scale, d, D);
    if (t.sc[kMask] > 0.f) src = dst;
    store_outputs(t, p, pred, err, b, T, tick);
    __syncthreads();  // the scalars are reloaded next tick
  }
  if (src != dst) {  // no tick updated: P' = P
    const size_t n = (size_t)D * D;
    for (size_t i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
  store_theta(t, theta_out, b, D);
}

__global__ void __launch_bounds__(kThreads)
krls_bank_step_kernel(const float* __restrict__ theta, const float* p_in,
                      const float* __restrict__ x,
                      const float* __restrict__ y,
                      const float* __restrict__ beta,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ scale,
                      float* __restrict__ theta_out, float* p_out,
                      float* __restrict__ pred, float* __restrict__ err,
                      int d, int D) {
  extern __shared__ float smem[];
  const Tiles t = carve(smem, d, D);
  const int b = blockIdx.x;
  const size_t off = (size_t)b * D * D;
  load_state(t, theta, beta, b, D);
  load_tick(t, x, y, nullptr, b, 1, 0, d);
  const float p = krls_tick(t, p_in + off, p_out + off, w, bias, scale, d, D);
  store_outputs(t, p, pred, err, b, 1, 0);
  store_theta(t, theta_out, b, D);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

int krls_bank_chunk(const float* theta, const float* p_in, const float* xs,
                    const float* ys, const float* mask, const float* beta,
                    const float* w, const float* b, const float* s,
                    float* theta_out, float* p_out, float* pred, float* err,
                    int B, int T, int d, int D, void* stream) {
  const size_t smem = smem_bytes(d, D);
  cudaError_t rc = prepare(krls_bank_chunk_kernel, smem);
  if (rc != cudaSuccess) return rc;
  krls_bank_chunk_kernel<<<B, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      theta, p_in, xs, ys, mask, beta, w, b, s, theta_out, p_out, pred, err,
      T, d, D);
  return cudaGetLastError();
}

int krls_bank_step(const float* theta, const float* p_in, const float* x,
                   const float* y, const float* beta, const float* w,
                   const float* b, const float* s, float* theta_out,
                   float* p_out, float* pred, float* err, int B, int d, int D,
                   void* stream) {
  const size_t smem = smem_bytes(d, D);
  cudaError_t rc = prepare(krls_bank_step_kernel, smem);
  if (rc != cudaSuccess) return rc;
  krls_bank_step_kernel<<<B, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      theta, p_in, x, y, beta, w, b, s, theta_out, p_out, pred, err, d, D);
  return cudaGetLastError();
}

const char* krls_bank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
