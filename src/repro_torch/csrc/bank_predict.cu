// Fused predict-only bank read path for Hopper (sm_90a).
//
// Replaces repro/kernels/rff_predict.py::rff_bank_predict_pallas. For a
// bank of B tenants and a block of Q queries per tenant:
//   z = s * cos(x_q W + b),   y_hat[b, q] = theta_b . z
// against a read-only theta (the published snapshot). No state is written.
//
// What bounds it on this card: 2 d D flops and D cosines per query (34
// GFLOP for B=1024, Q=64, d=128, D=2048) on the f32 CUDA cores, against
// about 36 MB that must move (xq, theta, W once, the output), so the work
// is bound by operations.
//
// Design:
//  * Grid (tenant, query block): one block owns one tenant's theta row,
//    held in shared memory for the whole query loop, and walks its query
//    block kRows queries at a time.
//  * W does not fit shared memory; it streams from L2 with coalesced loads
//    (each thread owns feature columns j, j + kThreads, ...), and each W
//    element loaded serves kRows queries.
//  * theta . z is a fixed-order tree (thread column sums, warp butterflies,
//    warp partials in order): no atomics.
//  * precision "bf16" reproduces the contract of kernels/ref.py: x and W
//    are rounded to bf16 (__float2bfloat16_rn), products accumulate in f32,
//    bias, cos and scale run in f32, z is rounded to bf16 before the f32
//    dot with theta.
//  * Ragged B, Q, d and D by bounds checks; cosf, never __cosf.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // queries that share one pass over W

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
bank_predict_kernel(const float* __restrict__ theta,
                    const float* __restrict__ xq,
                    const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ scale,
                    float* __restrict__ out, int Q, int d, int D,
                    int block_q) {
  extern __shared__ float smem[];
  float* theta_s = smem;             // [D]
  float* x_s = theta_s + D;          // [kRows][d]
  float* red = x_s + kRows * d;      // [kRows][kWarps]

  const int tenant = blockIdx.x;
  const int q_begin = blockIdx.y * block_q;
  const int q_end = min(Q, q_begin + block_q);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int j = threadIdx.x; j < D; j += kThreads)
    theta_s[j] = theta[(size_t)tenant * D + j];

  for (int q0 = q_begin; q0 < q_end; q0 += kRows) {
    for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
      const int r = i / d;
      const int k = i - r * d;
      float v = 0.f;
      if (q0 + r < q_end) v = xq[((size_t)tenant * Q + q0 + r) * d + k];
      x_s[i] = BF16 ? round_bf16(v) : v;
    }
    __syncthreads();

    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.f;
    for (int j = threadIdx.x; j < D; j += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int k = 0; k < d; ++k) {
        float wk = __ldg(w + (size_t)k * D + j);
        if (BF16) wk = round_bf16(wk);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = __fmaf_rn(x_s[r * d + k], wk, acc[r]);
      }
      const float bj = __ldg(bias + j);
      const float sj = __ldg(scale + j);
      const float th = theta_s[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float z = __fmul_rn(sj, cosf(__fadd_rn(acc[r], bj)));
        if (BF16) z = round_bf16(z);
        part[r] = __fmaf_rn(th, z, part[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float v = part[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) red[r * kWarps + warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < kRows && q0 + threadIdx.x < q_end) {
      float acc = 0.f;
      for (int k = 0; k < kWarps; ++k)
        acc = __fadd_rn(acc, red[threadIdx.x * kWarps + k]);
      out[(size_t)tenant * Q + q0 + threadIdx.x] = acc;
    }
    __syncthreads();
  }
}

template <bool BF16>
int launch(const float* theta, const float* xq, const float* w,
           const float* b, const float* s, float* out, int B, int Q, int d,
           int D, int block_q, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)D + (size_t)kRows * d + kRows * kWarps);
  cudaError_t rc = cudaFuncSetAttribute(
      bank_predict_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(B, (Q + block_q - 1) / block_q);
  bank_predict_kernel<BF16><<<grid, kThreads, smem, stream>>>(
      theta, xq, w, b, s, out, Q, d, D, block_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bank_predict(const float* theta, const float* xq, const float* w,
                 const float* b, const float* s, float* out, int B, int Q,
                 int d, int D, int block_q, int bf16, void* stream) {
  if (block_q < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<true>(theta, xq, w, b, s, out, B, Q, d, D, block_q, st);
  return launch<false>(theta, xq, w, b, s, out, B, Q, d, D, block_q, st);
}

const char* bank_predict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
