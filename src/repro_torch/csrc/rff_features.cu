// Fused affine-trig feature map z = s * cos(x W + b) for Hopper (sm_90a).
//
// Replaces repro/kernels/rff_features.py::rff_features_pallas: a tiled
// GEMM that accumulates x W over K in f32 and applies bias, cos and scale
// once, in the epilogue, so the pre-activation never reaches device
// memory. precision "bf16" follows the contract of kernels/ref.py: x and W
// are rounded to bf16 (a bf16 x bf16 product is exact in f32), the sum
// stays f32, bias, cos and scale run in f32 and z is stored as bf16.
//
// What bounds it on this card: 2 d D multiply-adds and one cosine per
// output (35 G operations for M = 65536, d = 128, D = 2048) on the f32
// CUDA cores, against about 570 MB that must move (the output dominates),
// so it is bound by operations.
//
// Design: the feature tile of kernels 1, 3 and 7 (feature_tile.cuh). One
// launch packs x (transposed) and W with its bias and scale rows into a
// zero-padded workspace, rounding x and W to bf16 on the bf16 route; then
// blocks of 256 threads form one M x 128 tile each, k-tiles of 16 through
// a three-stage cp.async ring, and the epilogue applies bias, cos and
// scale in the order kernel 1 does (__fmul_rn(s, cosf(__fadd_rn(acc,
// b)))), so a row's z has the same bits whichever of the two forms it.
// The plan: M = 128 rows, 8 x 8 a thread, while that gives a wave of
// blocks (132 on the H100), else M = 32, 4 x 4 a thread (at 256 rows, 128
// blocks of 256 threads where the 128-row tile gives 32). A block takes
// one column tile. Every element is one chain of fmaf over k = 0 .. d - 1 from +0
// (padding adds exact zeros): its bits depend on its row of x and its
// column of W alone, never on M, the plan or the tile it lands in. No
// split-K, no TF32; cosf, never __cosf; 64-bit offsets.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "feature_tile.cuh"

namespace {

namespace ft = feature_tile;

constexpr int kWave = 132;  // SMs of an H100 SXM: blocks a wave

// z[r][j] = s_j cos((x W)[r][j] + b_j) for the block's M rows and its
// column tile; U x U a thread (feature_tile.cuh).
template <int M, int U, bool BF16>
__global__ void __launch_bounds__(ft::threads_of<M, U>(), 2)
features_kernel(const float* __restrict__ xT, const float* __restrict__ wp,
                void* __restrict__ out, int R, int D, ft::Dims g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ft::SmemT<M>& s = *reinterpret_cast<ft::SmemT<M>*>(smem_raw);
  const int row0 = blockIdx.x * M;
  const int ty = threadIdx.x / (ft::kN / U), tx = threadIdx.x % (ft::kN / U);
  const bool vec = (D & 3) == 0;  // rows of z start on 16 (bf16: 8) bytes
  const ft::Walk wk{xT, wp, g.Rp, g.Dp, g.dp / ft::kK, row0, (int)blockIdx.y,
                    1};
  ft::walk<M, U>(s, wk, [&](int col0, int buf, float (&acc)[U][U]) {
    float bj[U], sj[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      bj[j] = s.bs[buf][0][ft::col_of<U>(tx, j)];
      sj[j] = s.bs[buf][1][ft::col_of<U>(tx, j)];
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int row = row0 + ft::row_of<M, U>(ty, i);
      if (row >= R) continue;
      const size_t base = (size_t)row * D;
#pragma unroll
      for (int h = 0; h < U / 4; ++h) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * h + c;
          v[c] = __fmul_rn(sj[j], cosf(__fadd_rn(acc[i][j], bj[j])));
        }
        const int col = col0 + ft::col_of<U>(tx, 4 * h);
        if (BF16) {
          __nv_bfloat16* zr = static_cast<__nv_bfloat16*>(out) + base;
          if (vec && col < D) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
            __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
            uint2 packed;
            packed.x = *reinterpret_cast<unsigned*>(&lo);
            packed.y = *reinterpret_cast<unsigned*>(&hi);
            *reinterpret_cast<uint2*>(zr + col) = packed;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (col + c < D) zr[col + c] = __float2bfloat16_rn(v[c]);
          }
        } else {
          float* zr = static_cast<float*>(out) + base;
          if (vec && col < D) {
            *reinterpret_cast<float4*>(zr + col) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (col + c < D) zr[col + c] = v[c];
          }
        }
      }
    }
  });
}

template <int M, int U, bool BF16>
cudaError_t launch(const float* xT, const float* wp, void* out, int R, int D,
                   const ft::Dims& g, cudaStream_t st) {
  const auto kernel = features_kernel<M, U, BF16>;
  constexpr size_t smem = ft::smem_bytes<M>();
  if (smem > 48 * 1024) {  // past the default (the 128-row tile)
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<dim3((unsigned)(((long long)R + M - 1) / M), g.Dp / ft::kN),
           ft::threads_of<M, U>(), smem, st>>>(xT, wp, out, R, D, g);
  return cudaGetLastError();
}

// The tile's rows of the plan: 128 where the 128-row tiles fill a wave of
// blocks, else 32.
int plan_rows(int R, int D) {
  const long long ctiles = (D + ft::kN - 1) / ft::kN;
  return ((long long)R + ft::kM - 1) / ft::kM * ctiles >= kWave ? ft::kM : 32;
}

}  // namespace

extern "C" {

// x (M, d), w (d, D), b (D,), s (D,) f32; out (M, D) f32, or bf16 when
// bf16 != 0; ws the packed operands' workspace, at least (dp + 2) Dp + dp
// Rp floats (feature_tile.cuh pack_floats), 16-byte aligned. rows: the tile's rows (128 or 32), or 0 for the plan's.
int rff_features(const float* x, const float* w, const float* b,
                 const float* s, void* out, float* ws, long long ws_floats,
                 int M, int d, int D, int bf16, int rows, void* stream) {
  if (M < 0 || d < 1 || D < 1) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  if (rows == 0) rows = plan_rows(M, D);
  if (rows != 128 && rows != 32) return cudaErrorInvalidValue;
  if ((D + ft::kN - 1) / ft::kN > 65535) return cudaErrorInvalidConfiguration;
  if ((size_t)ws_floats < ft::pack_floats(M, d, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ft::Dims g = ft::tile_dims(M, d, D);
  float* wp = ws;  // W, b and s: (dp + 2, Dp)
  float* xT = ws + (size_t)(g.dp + 2) * g.Dp;
  cudaError_t rc = ft::pack(ft::Rows{x, M, 0, d}, M, w, b, s, D, xT, wp,
                            bf16 != 0, st);
  if (rc != cudaSuccess) return rc;
  if (rows == 128)
    return bf16 ? launch<128, 8, true>(xT, wp, out, M, D, g, st)
                : launch<128, 8, false>(xT, wp, out, M, D, g, st);
  return bf16 ? launch<32, 4, true>(xT, wp, out, M, D, g, st)
              : launch<32, 4, false>(xT, wp, out, M, D, g, st);
}

const char* rff_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
