// Blocked softmax attention with the online (m, l) statistics, in IEEE f32
// on the CUDA cores of Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas for
// f32 inputs: q, k (BH, S, dh), v (BH, S, dv) f32, dh and dv up to 256
// and independent (deepseek-v2-lite's MLA heads are (192, 128),
// minicpm3's (96, 64)); q scaled by dh^-1/2; causal or not; masked
// scores -1e30; the running max m, the running denominator l and the
// output accumulator in f32; the output divided by max(l, 1e-30).
// bf16 inputs go to the tensor-core kernel (csrc/flash_attention_sm90.cu);
// f32 stays here because f32 means IEEE f32 in this port, never TF32.
//
// What bounds it on this card: operations. Causal attention at B = 4,
// 14 heads, S = 2048, dh = 64 does 30 GFLOP of products: 0.45 ms at the
// 67 TFLOP/s of f32 outside the tensor cores.
//
// Design: one block of 256 threads per (head, 64-row query tile), looping
// over 64-key tiles up to the diagonal: tiles wholly above it are skipped
// (the TPU computed them, and they added exactly 0). The grid starts with
// the last query tiles, which have the most key tiles. The scaled Q tile,
// the transposed K tile, the V tile and the probabilities live in shared
// memory (4 (64 dh + 65 dh + 64 dv + 64 * 65) bytes: 214,272 at dh = dv =
// 256, inside the 232,448 a block may use; chunking.SMEM_BUDGET, checked
// by kernels/flash_attention.py's flash_plan); each thread owns a
// 4 x 4 block of scores (rows ty + 16 i, keys tx + 16 j) and a 4 x NJ
// block of the output accumulator (columns tx + 16 j, dv <= 16 NJ). A
// row's max and sum go across the 16 lanes that share it with a fixed xor
// tree. Keys past S are masked like the causal ones; key 0 is never
// masked, so a row always has a finite max. expf, never __expf.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kPad = 65;   // padded row of the transposed K tile and of P
constexpr float kNegInf = -1e30f;

inline size_t flash_smem_bytes(int dh, int dv) {
  const size_t floats = (size_t)kTile * (dh + dv) + (size_t)dh * kPad +
                        (size_t)kTile * kPad;
  return 4 * floats;
}

// SAME: dv == dh, as at every head of the dense configs; K and V then
// share one load loop and its index divisions.
template <int NJ, bool CAUSAL, bool SAME>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int dh, int dv_, float scale) {
  const int dv = SAME ? dh : dv_;
  extern __shared__ float smem[];
  float* Qs = smem;                    // (kTile, dh), scaled
  float* KT = Qs + kTile * dh;         // (dh, kPad)
  float* Vs = KT + dh * kPad;          // (kTile, dv)
  float* P = Vs + kTile * dv;          // (kTile, kPad)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int nq = (S + kTile - 1) / kTile;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int q0 = qi * kTile;
  const size_t base = (size_t)blockIdx.y * S * dh;
  const size_t vbase = (size_t)blockIdx.y * S * dv;

  for (int e = tid; e < kTile * dh; e += kThreads) {
    const int r = e / dh;
    const int d = e % dh;
    const int gr = q0 + r;
    Qs[e] = gr < S ? __fmul_rn(q[base + (size_t)gr * dh + d], scale)
                   : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = CAUSAL ? qi + 1 : nq;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kTile * dh; e += kThreads) {
      const int s = e / dh;
      const int d = e % dh;
      const int gs = k0 + s;
      KT[d * kPad + s] = gs < S ? k[base + (size_t)gs * dh + d] : 0.f;
      if (SAME) Vs[e] = gs < S ? v[vbase + (size_t)gs * dv + d] : 0.f;
    }
    if (!SAME) {
      for (int e = tid; e < kTile * dv; e += kThreads) {
        const int gs = k0 + e / dv;
        Vs[e] = gs < S ? v[vbase + (size_t)gs * dv + e % dv] : 0.f;
      }
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * dh + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = KT[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = __fmaf_rn(qa[i], kb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (CAUSAL && kpos > qpos)) sc[i][j] = kNegInf;
        mb = fmaxf(mb, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m[i], mb);
      const float corr = expf(__fsub_rn(m[i], m_new));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(__fsub_rn(sc[i][j], m_new));
        P[(ty + 16 * i) * kPad + tx + 16 * j] = p;
        ps = __fadd_rn(ps, p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, off));
      l[i] = __fmaf_rn(l[i], corr, ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = __fmul_rn(acc[i][j], corr);
    }
    __syncthreads();

    for (int s = 0; s < kTile; ++s) {
      float pa[4], vb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = P[(ty + 16 * i) * kPad + s];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        vb[j] = c < dv ? Vs[s * dv + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = __fmaf_rn(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c >= dv) continue;
      out[vbase + (size_t)gr * dv + c] = __fdiv_rn(acc[i][j], denom);
    }
  }
}

template <int NJ, bool CAUSAL, bool SAME>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int BH, int S, int dh, int dv, float scale,
                   cudaStream_t st) {
  const size_t smem = flash_smem_bytes(dh, dv);
  auto kernel = flash_kernel<NJ, CAUSAL, SAME>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, BH);
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, out, S, dh, dv, scale);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t dispatch(const float* q, const float* k, const float* v,
                     float* out, int BH, int S, int dh, int dv, int causal,
                     float scale, cudaStream_t st) {
  if (dv == dh) {
    if (causal) return launch<NJ, true, true>(q, k, v, out, BH, S, dh, dv, scale, st);
    return launch<NJ, false, true>(q, k, v, out, BH, S, dh, dv, scale, st);
  }
  if (causal) return launch<NJ, true, false>(q, k, v, out, BH, S, dh, dv, scale, st);
  return launch<NJ, false, false>(q, k, v, out, BH, S, dh, dv, scale, st);
}

}  // namespace

extern "C" {

// q, k (BH, S, dh), v, out (BH, S, dv) f32; dh, dv <= 256; scale is
// dh^-1/2 as f32.
int flash_attention(const float* q, const float* k, const float* v,
                    float* out, int BH, int S, int dh, int dv, int causal,
                    float scale, void* stream) {
  if (BH < 0 || S < 0 || dh < 1 || dh > 256 || dv < 1 || dv > 256)
    return cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dv <= 16) return dispatch<1>(q, k, v, out, BH, S, dh, dv, causal, scale, st);
  if (dv <= 32) return dispatch<2>(q, k, v, out, BH, S, dh, dv, causal, scale, st);
  if (dv <= 64) return dispatch<4>(q, k, v, out, BH, S, dh, dv, causal, scale, st);
  if (dv <= 128) return dispatch<8>(q, k, v, out, BH, S, dh, dv, causal, scale, st);
  return dispatch<16>(q, k, v, out, BH, S, dh, dv, causal, scale, st);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
