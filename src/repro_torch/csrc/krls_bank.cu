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
// Two chunk kernels (kernels/rff_krls_step.py):
//  * krls_bank_chunk_resident keeps P's upper triangle in shared
//    memory for the whole launch, when it fits a block (D <= 335 at d = 5;
//    chunking.krls_resident_fits): P crosses device memory once in and
//    once out, 8 B D^2 a launch (see "Resident" below). The wrapper picks
//    it wherever it fits; wider D go to the compact route
//    (csrc/krls_compact.cu: P moved once a block of Tc ticks);
//  * krls_bank_chunk streams P every tick, for any D (below). No caller
//    picks it: tests and timings force it (_route="streaming") to hold the
//    other routes against it.
// krls_bank_step is one tick of the streaming design, forced the same way.
//
// Streaming design (simple and right for every D):
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
constexpr size_t kSmemBudget = 232448;  // shared memory a block may use

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

// ---------------------------------------------------------------------------
// Resident design: P's upper triangle in shared memory for the whole launch.
//
//  * P is symmetric after the first live tick, and its upper triangle is
//    about 180 KB at D = 300: it fits the 232,448 bytes a block may use,
//    beside theta, z, gain, pz and x. One block per tenant fills an SM's
//    shared memory, so a block has 32 warps to hide shared-memory latency.
//  * Packing: row a and row D - 1 - a of the triangle share one row of a
//    rectangle of pitch W (D + 1 elements, W even); the middle row of an
//    odd D stands alone in the last row. Element (a, b >= a) is at
//      a W + (b - a)              when 2 a <= D - 1 (row a first),
//      (D - 1 - a) W + 1 + b      otherwise (row a second).
//    Every rectangle row holds the same work, so the downdate gives each
//    warp whole rectangle rows; reading a column of the triangle (pz below
//    the diagonal) steps by W - 1, odd, so the lanes of a warp hit 32
//    banks (2-way in the rows stored second). Lane l of each warp always
//    works on columns l + 32 m, so the starts of those rows, and z for the
//    tick, stay in its registers.
//  * Until the first live tick, pz reads rows of p_in from device memory
//    as krls_tick does (p_in need not be symmetric) and keeps the upper
//    half of each row it reads. That tick's downdate then reads each row r
//    of p_in along its columns c <= r and finishes element (c, r) as
//    0.5 (P''_cr + P''_rc). Later ticks read and write only the triangle.
//  * At the end both halves of the triangle go to p_out; a launch whose
//    ticks are all masked copies p_in. P crosses device memory 8 B D^2 a
//    launch (plus half of P once more on the first live tick), where the
//    streaming kernel moves 12 B D^2 a tick.
//  * Bit for bit the streaming kernels' arithmetic: the same per-feature
//    and per-element _rn sequences (divide, not a reciprocal multiply), pz
//    in the same order and xor tree (one warp a row, lanes along j), and
//    every block sum over the same 256-lane partition, xor tree and warp
//    order as block_sum. So a chunk of T equals T krls_bank_step launches,
//    and T = 1 equals a step, bit for bit.
//  * A tick's inputs and the reduction slots alternate between two
//    buffers, and pz runs between the prediction's two halves, so a live
//    tick takes 4 block barriers and a masked one 2.
//
// What bounds it: P's bytes no longer do (0.22 ms for B = 1024 at D =
// 300). Per tick and tenant it does D^2 shared-memory multiply-adds for pz
// and D^2 IEEE divides in the downdate, each divide a chain of dependent
// instructions that the 32 warps of the SM's one block hide only in part,
// and a chain of short phases with a barrier after each. The downdate
// loops stay rolled: unrolled, they spill under the 64 registers a thread
// of a 1024-thread block may hold, and ran slower on the card.

constexpr int kResThreads = 1024;
constexpr int kResWarps = kResThreads / 32;
constexpr int kMaxLaneCols = 11;  // j = lane + 32 m, m < 11: D <= 352

__host__ __device__ __forceinline__ int rect_pitch(int D) {
  return (D & 1) ? D + 1 : D + 2;
}

// Floats of the packed triangle (rows of pitch W, the padding included).
__host__ __device__ __forceinline__ int tri_floats(int D) {
  return (D & 1) ? D * (D + 1) / 2 : D * (D + 2) / 2;
}

// Shared-memory layout of one resident block
// (chunking.krls_resident_smem_bytes).
struct Resident {
  float2* gp;    // [D]: (gain, pz)
  float* tri;    // [tri_floats(D)]
  float* theta;  // [D]
  float* z;      // [D]
  float* x;      // [2][d]: this tick's x, alternating
  float* red;    // [2][kWarps]: the 256-lane partition's warp sums
  float* sc;     // [2][2]: (y, mask), alternating
};

__device__ Resident carve_resident(float* smem, int d, int D) {
  Resident t;
  t.gp = reinterpret_cast<float2*>(smem);
  t.tri = smem + 2 * D;
  t.theta = t.tri + tri_floats(D);
  t.z = t.theta + D;
  t.x = t.z + D;
  t.red = t.x + 2 * d;
  t.sc = t.red + 2 * kWarps;
  return t;
}

size_t resident_smem_bytes(int d, int D) {
  return sizeof(float) *
         ((size_t)tri_floats(D) + 4 * (size_t)D + 2 * d + 2 * kWarps + 4);
}

// block_sum over the 256-lane partition, in two halves around a barrier
// the caller places: sum256_post folds the partials of threads 0..255 (each
// summed over j = tid, tid + 256, ...) with the same xor tree into one slot
// a warp, sum256_collect adds the eight slots in warp order. Same bits as
// block_sum at any block size. The caller alternates between two sets of
// slots, so a set is written again only after every thread has passed the
// barrier of the sum in between.
__device__ __forceinline__ void sum256_post(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp < kWarps) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[warp] = v;
  }
}

__device__ __forceinline__ float sum256_collect(const float* red) {
  float acc = 0.f;
  for (int w = 0; w < kWarps; ++w) acc = __fadd_rn(acc, red[w]);
  return acc;
}

// Where row a of the triangle starts: element (a, b >= a) is at
// row_base(a) + b.
__device__ __forceinline__ int row_base(int a, int D, int W) {
  return 2 * a <= D - 1 ? a * (W - 1) : (D - 1 - a) * W + 1;
}

__global__ void __launch_bounds__(kResThreads, 1)
krls_bank_chunk_resident_kernel(const float* __restrict__ theta,
                                const float* __restrict__ p_in,
                                const float* __restrict__ xs,
                                const float* __restrict__ ys,
                                const float* __restrict__ mask,
                                const float* __restrict__ beta_in,
                                const float* __restrict__ w,
                                const float* __restrict__ bias,
                                const float* __restrict__ scale,
                                float* __restrict__ theta_out,
                                float* __restrict__ p_out,
                                float* __restrict__ pred_out,
                                float* __restrict__ err_out, int T, int d,
                                int D) {
  extern __shared__ float smem[];
  const Resident t = carve_resident(smem, d, D);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int W = rect_pitch(D);
  const float* src = p_in + (size_t)b * D * D;
  float* dst = p_out + (size_t)b * D * D;
  const size_t row0 = (size_t)b * T;
  const float beta = beta_in[b];
  // Lane l of every warp works on columns j = l + 32 m of a row: their row
  // bases stay in registers for the launch, their z for the tick.
  int jb[kMaxLaneCols];
  float zr[kMaxLaneCols];
#pragma unroll
  for (int m = 0; m < kMaxLaneCols; ++m)
    jb[m] = lane + 32 * m < D ? row_base(lane + 32 * m, D, W) : 0;
  bool resident = false;
  int sums = 0;  // block sums so far: picks the set of reduction slots

  // Tick t's x, y and mask sit in slot t & 1 of shared memory from the
  // barrier after tick t - 1's pred (the setup barrier for tick 0); the
  // values of tick t + 1 wait in registers (x[tid] for tid < d) meanwhile.
  for (int i = tid; i < D; i += kResThreads) t.theta[i] = theta[(size_t)b * D + i];
  for (int k = tid; k < d; k += kResThreads) t.x[k] = xs[row0 * d + k];
  if (tid == 0) {
    t.sc[0] = ys[row0];
    t.sc[1] = mask ? mask[row0] : 1.f;
  }
  float xv = 0.f, yv = 0.f, mv = 1.f;
  if (T > 1) {
    if (tid < d) xv = xs[(row0 + 1) * d + tid];
    if (tid == 0) {
      yv = ys[row0 + 1];
      mv = mask ? mask[row0 + 1] : 1.f;
    }
  }
  __syncthreads();

  for (int tick = 0; tick < T; ++tick) {
    const int slot = tick & 1;
    const float* x = t.x + slot * d;
    const float* sc = t.sc + 2 * slot;
    const size_t row = row0 + tick;
    const bool live = sc[1] > 0.f;  // block-uniform
    // z = s cos(x W + b), by the last D threads: their warps hold one
    // rectangle row fewer in the previous tick's downdate, so this work
    // overlaps the other warps' last row.
    if (const int j = kResThreads - 1 - tid; j < D) {
      float acc = 0.f;
      for (int k = 0; k < d; ++k)
        acc = __fmaf_rn(x[k], __ldg(w + (size_t)k * D + j), acc);
      t.z[j] = __fmul_rn(__ldg(scale + j), cosf(__fadd_rn(acc, __ldg(bias + j))));
    }
    __syncthreads();
    float part = 0.f;
    if (tid < kThreads)
      for (int j = tid; j < D; j += kThreads)
        part = __fmaf_rn(t.theta[j], t.z[j], part);
    float* red = t.red + (sums++ & 1) * kWarps;
    sum256_post(part, red);

    // pz[i] = sum_j P[i, j] z[j]: one warp a row, lanes along the row, in
    // krls_tick's order; element (i, j) is at row_base(min) + max.
#pragma unroll
    for (int m = 0; m < kMaxLaneCols; ++m)
      zr[m] = live && lane + 32 * m < D ? t.z[lane + 32 * m] : 0.f;
    for (int i = warp; live && i < D; i += kResWarps) {
      const int base = row_base(i, D, W);
      float acc = 0.f;
      if (resident) {
#pragma unroll
        for (int m = 0; m < kMaxLaneCols; ++m) {
          const int j = lane + 32 * m;
          if (j < D) acc = __fmaf_rn(t.tri[j < i ? jb[m] + i : base + j], zr[m], acc);
        }
      } else {  // rows of p_in (all loads first); keep their upper halves
        const float* prow = src + (size_t)i * D;
        float v[kMaxLaneCols];
#pragma unroll
        for (int m = 0; m < kMaxLaneCols; ++m) {
          const int j = lane + 32 * m;
          v[m] = j < D ? prow[j] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kMaxLaneCols; ++m) {
          const int j = lane + 32 * m;
          if (j < D) {
            if (j >= i) t.tri[base + j] = v[m];
            acc = __fmaf_rn(v[m], zr[m], acc);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      if (lane == 0) t.gp[i].y = acc;
    }
    if (tick + 1 < T) {  // publish tick t + 1's inputs; fetch tick t + 2's
      if (tid < d) t.x[(1 - slot) * d + tid] = xv;
      for (int k = tid + kResThreads; k < d; k += kResThreads)
        t.x[(1 - slot) * d + k] = xs[(row + 1) * d + k];
      if (tid == 0) {
        t.sc[2 * (1 - slot)] = yv;
        t.sc[2 * (1 - slot) + 1] = mv;
      }
      if (tick + 2 < T) {
        if (tid < d) xv = xs[(row + 2) * d + tid];
        if (tid == 0) {
          yv = ys[row + 2];
          mv = mask ? mask[row + 2] : 1.f;
        }
      }
    }
    __syncthreads();
    const float pred = sum256_collect(red);
    const float y = sc[0];
    if (tid == 0) {
      pred_out[row] = pred;
      err_out[row] = __fsub_rn(y, pred);
    }
    if (!live) continue;

    part = 0.f;
    if (tid < kThreads)
      for (int i = tid; i < D; i += kThreads)
        part = __fmaf_rn(t.z[i], t.gp[i].y, part);
    red = t.red + (sums++ & 1) * kWarps;
    sum256_post(part, red);
    __syncthreads();
    const float denom = __fadd_rn(beta, sum256_collect(red));
    const float e = __fsub_rn(y, pred);
    for (int i = tid; i < D; i += kResThreads) {
      const float g = __fdiv_rn(t.gp[i].y, denom);
      t.gp[i].x = g;
      t.theta[i] = __fadd_rn(t.theta[i], __fmul_rn(g, e));
    }
    __syncthreads();

    // The symmetrised downdate: element (i, j >= i) becomes
    // 0.5 ((P_ij - g_i pz_j) / beta + (P_ji - g_j pz_i) / beta).
    if (resident) {  // one warp a rectangle row: row r, then row D - 1 - r
      for (int r = warp; r < (D + 1) / 2; r += kResWarps) {
        const int split = D - r;  // columns of row r; then row D - 1 - r
        const int end = 2 * r == D - 1 ? split : D + 1;
        float* rect = t.tri + r * W;
        int c = lane;
        const float2 ga = t.gp[r];
#pragma unroll 1
        for (; c < split; c += 32) {  // (r, r + c)
          const float2 gj = t.gp[r + c];
          const float p = rect[c];
          const float dij = __fdiv_rn(__fsub_rn(p, __fmul_rn(ga.x, gj.y)), beta);
          const float dji = __fdiv_rn(__fsub_rn(p, __fmul_rn(gj.x, ga.y)), beta);
          rect[c] = __fmul_rn(0.5f, __fadd_rn(dij, dji));
        }
        const float2 gb = t.gp[D - 1 - r];
#pragma unroll 1
        for (; c < end; c += 32) {  // (D - 1 - r, c - 1)
          const float2 gj = t.gp[c - 1];
          const float p = rect[c];
          const float dij = __fdiv_rn(__fsub_rn(p, __fmul_rn(gb.x, gj.y)), beta);
          const float dji = __fdiv_rn(__fsub_rn(p, __fmul_rn(gj.x, gb.y)), beta);
          rect[c] = __fmul_rn(0.5f, __fadd_rn(dij, dji));
        }
      }
    } else {  // row r of p_in along c <= r finishes element (c, r)
      for (int r = warp; r < D; r += kResWarps) {
        const float* prow = src + (size_t)r * D;
        const float2 gr = t.gp[r];
        float v[kMaxLaneCols];
#pragma unroll
        for (int m = 0; m < kMaxLaneCols; ++m) {
          const int c = lane + 32 * m;
          v[m] = c <= r ? prow[c] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kMaxLaneCols; ++m) {
          const int c = lane + 32 * m;
          if (c <= r) {
            const int at = jb[m] + r;  // element (c, r)
            const float2 gc = t.gp[c];
            const float dij = __fdiv_rn(__fsub_rn(t.tri[at], __fmul_rn(gc.x, gr.y)), beta);
            const float dji = __fdiv_rn(__fsub_rn(v[m], __fmul_rn(gr.x, gc.y)), beta);
            t.tri[at] = __fmul_rn(0.5f, __fadd_rn(dij, dji));
          }
        }
      }
      resident = true;
    }
    // No barrier here. The next tick writes z before its first barrier,
    // which a thread reaches only after this tick's last one (the fourth of
    // a live tick, the second of a masked one); z was last read before it
    // (the denominator's partial, before the third). The downdate's reads
    // of gp and writes of the triangle end before the next tick's first
    // barrier, after which its pz reads the triangle and writes gp.
  }
  __syncthreads();
  if (resident) {  // both halves of the triangle, rows coalesced
    for (int i = warp; i < D; i += kResWarps) {
      const int base = row_base(i, D, W);
#pragma unroll
      for (int m = 0; m < kMaxLaneCols; ++m) {
        const int j = lane + 32 * m;
        if (j < D) dst[(size_t)i * D + j] = t.tri[j < i ? jb[m] + i : base + j];
      }
    }
  } else {  // no tick updated: P' = P
    const size_t n = (size_t)D * D;
    for (size_t i = tid; i < n; i += kResThreads) dst[i] = src[i];
  }
  for (int i = tid; i < D; i += kResThreads)
    theta_out[(size_t)b * D + i] = t.theta[i];
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

// krls_bank_chunk with P resident in shared memory: the same arguments;
// fails (cudaErrorInvalidValue) when the triangle does not fit a block.
int krls_bank_chunk_resident(const float* theta, const float* p_in,
                             const float* xs, const float* ys,
                             const float* mask, const float* beta,
                             const float* w, const float* b, const float* s,
                             float* theta_out, float* p_out, float* pred,
                             float* err, int B, int T, int d, int D,
                             void* stream) {
  const size_t smem = resident_smem_bytes(d, D);
  if (smem > kSmemBudget || D > 32 * kMaxLaneCols) return cudaErrorInvalidValue;
  cudaError_t rc = prepare(krls_bank_chunk_resident_kernel, smem);
  if (rc != cudaSuccess) return rc;
  krls_bank_chunk_resident_kernel<<<B, kResThreads, smem,
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
