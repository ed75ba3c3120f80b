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
// Design:
//  * One block owns BB tenants (8 when the tiles fit) for the whole launch.
//    The TPU kernel carries theta across T with a minor grid axis that runs
//    in order; GPU blocks run in no order, so T is a loop inside the block.
//  * theta and z of the block's tenants live in shared memory across all T
//    ticks; only theta', y_hat and e are written out. z never reaches HBM.
//  * W (1 MiB at d=128, D=2048) does not fit shared memory (227 KB), unlike
//    the TPU's VMEM. Each tick streams it from L2 with coalesced loads, and
//    every W element loaded is used for all BB tenants of the block, so the
//    L2 traffic is B*T*d*D*4/BB bytes.
//  * The reduction theta . z is a fixed-order tree (per-thread column sums,
//    warp butterflies, then warp partials in order): no atomics, so results
//    are reproducible.
//  * Both entry points call the same __device__ tick, and the arithmetic on
//    the update path uses explicit _rn intrinsics that the compiler may not
//    contract into FMAs differently in the two contexts. Hence a chunk of T
//    ticks equals T step launches bit for bit, and a chunk at T=1 equals a
//    step. A tick with m == 0 skips the update, so theta stays bit for bit.
//  * Ragged B, d and D are handled by bounds checks: there is no padding,
//    and no feature column beyond D is ever formed.
//  * cosf, never __cosf: x W + b runs far outside [-pi, pi].
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared-memory layout of one block (klms_smem_bytes in chunking.py).
struct Tiles {
  float* theta;  // [BB][D]
  float* z;      // [BB][D]
  float* x;      // [BB][d]
  float* red;    // [BB][kWarps]
  float* y;      // [BB]
  float* mu;     // [BB]
  float* m;      // [BB]
  float* pred;   // [BB]
};

template <int BB>
__device__ Tiles carve(float* smem, int d, int D) {
  Tiles t;
  t.theta = smem;
  t.z = t.theta + BB * D;
  t.x = t.z + BB * D;
  t.red = t.x + BB * d;
  t.y = t.red + BB * kWarps;
  t.mu = t.y + BB;
  t.m = t.mu + BB;
  t.pred = t.m + BB;
  return t;
}

// out[b] = sum over threads of part[b], in a fixed order.
template <int BB>
__device__ void block_sum(const float (&part)[BB], float* red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    float v = part[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[b * kWarps + warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < BB) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w)
      acc = __fadd_rn(acc, red[threadIdx.x * kWarps + w]);
    out[threadIdx.x] = acc;
  }
  __syncthreads();
}

// One KLMS tick for the block's BB tenants on the resident tiles. t.x, t.y,
// t.mu and t.m hold this tick's inputs; t.pred receives the predictions.
template <int BB>
__device__ void klms_tick(const Tiles& t, const float* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ scale, int d, int D) {
  float part[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) part[b] = 0.f;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    float acc[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) acc[b] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float wk = __ldg(w + (size_t)k * D + j);
#pragma unroll
      for (int b = 0; b < BB; ++b) acc[b] = __fmaf_rn(t.x[b * d + k], wk, acc[b]);
    }
    const float bj = __ldg(bias + j);
    const float sj = __ldg(scale + j);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float zb = __fmul_rn(sj, cosf(__fadd_rn(acc[b], bj)));
      t.z[b * D + j] = zb;
      part[b] = __fmaf_rn(t.theta[b * D + j], zb, part[b]);
    }
  }
  block_sum<BB>(part, t.red, t.pred);
  // Each thread updates the columns whose z it formed.
  for (int j = threadIdx.x; j < D; j += kThreads) {
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float m = t.m[b];
      if (m != 0.f) {
        const float e = __fsub_rn(t.y[b], t.pred[b]);
        const float c = __fmul_rn(t.mu[b], __fmul_rn(m, e));
        t.theta[b * D + j] =
            __fadd_rn(t.theta[b * D + j], __fmul_rn(c, t.z[b * D + j]));
      }
    }
  }
  __syncthreads();
}

// theta rows of the block into shared memory (zeros past B), and mu.
template <int BB>
__device__ void load_state(const Tiles& t, const float* __restrict__ theta,
                           const float* __restrict__ mu, int b0, int B,
                           int D) {
  for (int i = threadIdx.x; i < BB * D; i += kThreads) {
    const int b = i / D;
    t.theta[i] = (b0 + b < B) ? theta[(size_t)(b0 + b) * D + (i - b * D)] : 0.f;
  }
  if (threadIdx.x < BB) {
    const int b = b0 + threadIdx.x;
    t.mu[threadIdx.x] = b < B ? mu[b] : 0.f;
  }
}

// This tick's x rows, targets and gates (x is row (b, tick) of a
// (B, T, d) array; mask may be null, meaning all ones).
template <int BB>
__device__ void load_tick(const Tiles& t, const float* __restrict__ xs,
                          const float* __restrict__ ys,
                          const float* __restrict__ mask, int b0, int B,
                          int T, int tick, int d) {
  for (int i = threadIdx.x; i < BB * d; i += kThreads) {
    const int b = i / d;
    const int k = i - b * d;
    t.x[i] = (b0 + b < B) ? xs[((size_t)(b0 + b) * T + tick) * d + k] : 0.f;
  }
  if (threadIdx.x < BB) {
    const int b = b0 + threadIdx.x;
    const bool live = b < B;
    t.y[threadIdx.x] = live ? ys[(size_t)b * T + tick] : 0.f;
    t.m[threadIdx.x] =
        live ? (mask ? mask[(size_t)b * T + tick] : 1.f) : 0.f;
  }
  __syncthreads();
}

template <int BB>
__device__ void store_outputs(const Tiles& t, float* __restrict__ pred,
                              float* __restrict__ err, int b0, int B, int T,
                              int tick) {
  if (threadIdx.x < BB && b0 + threadIdx.x < B) {
    const size_t o = (size_t)(b0 + threadIdx.x) * T + tick;
    const float p = t.pred[threadIdx.x];
    pred[o] = p;
    err[o] = __fsub_rn(t.y[threadIdx.x], p);
  }
}

template <int BB>
__device__ void store_theta(const Tiles& t, float* __restrict__ theta_out,
                            int b0, int B, int D) {
  for (int i = threadIdx.x; i < BB * D; i += kThreads) {
    const int b = i / D;
    if (b0 + b < B) theta_out[(size_t)(b0 + b) * D + (i - b * D)] = t.theta[i];
  }
}

template <int BB>
__global__ void __launch_bounds__(kThreads)
klms_bank_chunk_kernel(const float* __restrict__ theta,
                       const float* __restrict__ xs,
                       const float* __restrict__ ys,
                       const float* __restrict__ mask,
                       const float* __restrict__ mu,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ scale,
                       float* __restrict__ theta_out,
                       float* __restrict__ pred, float* __restrict__ err,
                       int B, int T, int d, int D) {
  extern __shared__ float smem[];
  const Tiles t = carve<BB>(smem, d, D);
  const int b0 = blockIdx.x * BB;
  load_state<BB>(t, theta, mu, b0, B, D);
  for (int tick = 0; tick < T; ++tick) {
    load_tick<BB>(t, xs, ys, mask, b0, B, T, tick, d);
    klms_tick<BB>(t, w, bias, scale, d, D);
    store_outputs<BB>(t, pred, err, b0, B, T, tick);
  }
  store_theta<BB>(t, theta_out, b0, B, D);
}

template <int BB>
__global__ void __launch_bounds__(kThreads)
klms_bank_step_kernel(const float* __restrict__ theta,
                      const float* __restrict__ x,
                      const float* __restrict__ y,
                      const float* __restrict__ mu,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ scale,
                      float* __restrict__ theta_out,
                      float* __restrict__ pred, float* __restrict__ err,
                      int B, int d, int D) {
  extern __shared__ float smem[];
  const Tiles t = carve<BB>(smem, d, D);
  const int b0 = blockIdx.x * BB;
  load_state<BB>(t, theta, mu, b0, B, D);
  load_tick<BB>(t, x, y, nullptr, b0, B, 1, 0, d);
  klms_tick<BB>(t, w, bias, scale, d, D);
  store_outputs<BB>(t, pred, err, b0, B, 1, 0);
  store_theta<BB>(t, theta_out, b0, B, D);
}

size_t smem_bytes(int bb, int d, int D) {
  return sizeof(float) * (size_t)bb * (2 * (size_t)D + d + kWarps + 4);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int BB>
int launch_chunk(const float* theta, const float* xs, const float* ys,
                 const float* mask, const float* mu, const float* w,
                 const float* b, const float* s, float* theta_out,
                 float* pred, float* err, int B, int T, int d, int D,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes(BB, d, D);
  cudaError_t rc = prepare(klms_bank_chunk_kernel<BB>, smem);
  if (rc != cudaSuccess) return rc;
  const int grid = (B + BB - 1) / BB;
  klms_bank_chunk_kernel<BB><<<grid, kThreads, smem, stream>>>(
      theta, xs, ys, mask, mu, w, b, s, theta_out, pred, err, B, T, d, D);
  return cudaGetLastError();
}

template <int BB>
int launch_step(const float* theta, const float* x, const float* y,
                const float* mu, const float* w, const float* b,
                const float* s, float* theta_out, float* pred, float* err,
                int B, int d, int D, cudaStream_t stream) {
  const size_t smem = smem_bytes(BB, d, D);
  cudaError_t rc = prepare(klms_bank_step_kernel<BB>, smem);
  if (rc != cudaSuccess) return rc;
  const int grid = (B + BB - 1) / BB;
  klms_bank_step_kernel<BB><<<grid, kThreads, smem, stream>>>(
      theta, x, y, mu, w, b, s, theta_out, pred, err, B, d, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int klms_bank_chunk(const float* theta, const float* xs, const float* ys,
                    const float* mask, const float* mu, const float* w,
                    const float* b, const float* s, float* theta_out,
                    float* pred, float* err, int B, int T, int d, int D,
                    int block_b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_b) {
    case 8: return launch_chunk<8>(theta, xs, ys, mask, mu, w, b, s, theta_out, pred, err, B, T, d, D, st);
    case 4: return launch_chunk<4>(theta, xs, ys, mask, mu, w, b, s, theta_out, pred, err, B, T, d, D, st);
    case 2: return launch_chunk<2>(theta, xs, ys, mask, mu, w, b, s, theta_out, pred, err, B, T, d, D, st);
    case 1: return launch_chunk<1>(theta, xs, ys, mask, mu, w, b, s, theta_out, pred, err, B, T, d, D, st);
    default: return cudaErrorInvalidValue;
  }
}

int klms_bank_step(const float* theta, const float* x, const float* y,
                   const float* mu, const float* w, const float* b,
                   const float* s, float* theta_out, float* pred, float* err,
                   int B, int d, int D, int block_b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_b) {
    case 8: return launch_step<8>(theta, x, y, mu, w, b, s, theta_out, pred, err, B, d, D, st);
    case 4: return launch_step<4>(theta, x, y, mu, w, b, s, theta_out, pred, err, B, d, D, st);
    case 2: return launch_step<2>(theta, x, y, mu, w, b, s, theta_out, pred, err, B, d, D, st);
    case 1: return launch_step<1>(theta, x, y, mu, w, b, s, theta_out, pred, err, B, d, D, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* klms_bank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
