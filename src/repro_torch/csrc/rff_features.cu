// Fused affine-trig feature map z = s * cos(x W + b) for Hopper (sm_90a).
//
// Replaces repro/kernels/rff_features.py::rff_features_pallas: a tiled
// GEMM that accumulates x W over K in f32 and applies bias, cos and scale
// once, in the epilogue, so the pre-activation never reaches device
// memory. precision "bf16" follows the contract of kernels/ref.py: x and W
// are rounded to bf16 on load (a bf16 x bf16 product is exact in f32), the
// sum stays f32, bias, cos and scale run in f32 and z is stored as bf16.
//
// What bounds it on this card: 2 d D multiply-adds and one cosine per
// output (35 G operations for M = 65536, d = 128, D = 2048) on the f32
// CUDA cores, against about 570 MB that must move (the output dominates),
// so it is bound by operations.
//
// Design: a plain shared-memory SGEMM. Each block owns a 64 x 64 output
// tile; each of its 256 threads a 4 x 4 micro-tile (rows ty + 16 i,
// columns tx + 16 j, so a half-warp stores 16 consecutive features). K
// goes in steps of 16 through two shared tiles (x stored transposed).
// Every output is one fixed-order chain of fmaf over k = 0 .. d-1 (zero
// padding past d adds exact zeros). Ragged M, d and D by bounds checks;
// cosf, never __cosf; 64-bit offsets.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kMicro = 4;  // kTileM / 16 rows and kTileN / 16 columns

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
rff_features_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ scale, void* __restrict__ out,
                    int M, int d, int D) {
  __shared__ float xs[kTileK][kTileM + 4];  // x tile, transposed
  __shared__ float ws[kTileK][kTileN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kTileN;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTileM * kTileK; e += kThreads) {
      const int r = e / kTileK;  // consecutive threads read consecutive k
      const int c = e % kTileK;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      float v = 0.f;
      if (gm < M && gk < d) v = x[gm * d + gk];
      xs[c][r] = BF16 ? round_bf16(v) : v;
    }
    for (int e = threadIdx.x; e < kTileK * kTileN; e += kThreads) {
      const int r = e / kTileN;
      const int c = e % kTileN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      float v = 0.f;
      if (gk < d && gn < D) v = w[(size_t)gk * D + gn];
      ws[r][c] = BF16 ? round_bf16(v) : v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMicro; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= D) continue;
    const float bj = __ldg(bias + gn);
    const float sj = __ldg(scale + gn);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const long long gm = m0 + ty + 16 * i;
      if (gm >= M) continue;
      const float z = __fmul_rn(sj, cosf(__fadd_rn(acc[i][j], bj)));
      const size_t o = (size_t)gm * D + gn;
      if (BF16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(z);
      else
        static_cast<float*>(out)[o] = z;
    }
  }
}

}  // namespace

extern "C" {

// x (M, d), w (d, D), b (D,), s (D,) f32; out (M, D) f32, or bf16 when
// bf16 != 0.
int rff_features(const float* x, const float* w, const float* b,
                 const float* s, void* out, int M, int d, int D, int bf16,
                 void* stream) {
  if (M < 0 || d < 1 || D < 1) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const long long row_tiles = (M + kTileM - 1) / kTileM;
  const int col_tiles = (D + kTileN - 1) / kTileN;
  if (col_tiles > 65535 || row_tiles > 2147483647LL)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)row_tiles, col_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    rff_features_kernel<true><<<grid, kThreads, 0, st>>>(x, w, b, s, out, M,
                                                         d, D);
  else
    rff_features_kernel<false><<<grid, kThreads, 0, st>>>(x, w, b, s, out,
                                                          M, d, D);
  return cudaGetLastError();
}

const char* rff_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
