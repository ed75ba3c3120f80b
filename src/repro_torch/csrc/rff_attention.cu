// RFF linear attention for Hopper (sm_90a): the fused decode block and the
// chunked causal prefill.
//
// decode_block replaces
// repro/kernels/rff_attention.py::rff_attention_decode_block_pallas: T
// decode tokens of one head per launch, with the head's fixed-size state
// S (D, dv) and z (D,) read once, held across the T strictly sequential
// ticks and written once. Each tick featurizes the token's pre-projected
// q and k in-kernel (prf: s * (exp(x W - |x|^2 / 2) / sqrt(D) + 1e-6);
// trig: s * cos(x W + b)), then S += phi_k v^T, z += phi_k and
// o = phi_q S [/ (phi_q . z + eps)]. precision "bf16" follows the contract
// of kernels/ref.py: the projection's operands are rounded to bf16, the
// sum stays f32, |x|^2 is taken on the f32 x, the features are rounded to
// bf16 and the state stays f32.
//
// What bounds it on this card: the state. A head's S and z move in and
// out once (2 D dv 4 bytes: 128 KB at D = 256, dv = 64), against about
// 4 D dh + 4 D dv operations per token. At the LM's decode shape (56
// heads at B = 4, T = 1) that is 7 MB, 2 us at the memory rate, below the
// few microseconds a launch costs: launch latency bounds it.
//
// Design: one block of 256 threads per head. The TPU kept S and W (dh, D)
// in VMEM; here S and z live in dynamic shared memory for the whole launch
// (64 KB at dv = 64, 128 KB at dv = 128) and W is streamed from L2, since
// S and W together (256 KB at dh = dv = 128) exceed a block's 227 KB.
// A tick featurizes one token (thread j owns features j, j + 256, ...:
// one fixed-order chain of fmaf over dh), so a block of T tokens equals T
// launches of one bit for bit. The output's reduction over D is split in
// fixed parts per column, then summed in a fixed order; the normalizer's
// reduction is a fixed warp tree. expf and cosf, never the fast
// intrinsics; 64-bit offsets.
//
// linear_attention replaces repro/kernels/rff_attention.py::
// rff_attention_pallas: causal linear attention over featurized
// phi_q, phi_k (BH, S, D) and v (BH, S, dv), chunk by chunk: (Q K^T ∘
// tril) V + Q S_prev, normalized by the row sum plus Q z_prev, S and z
// updated after the chunk.
//
// What bounds it on this card: f32 operations. The least work is the
// recurrent form, 4 D dv + 2 D per token (7.5 GFLOP, 0.11 ms at
// B = 4, S = 2048, 14 heads, D = 256, dv = 64) against 294 MB of inputs
// and outputs (0.09 ms).
//
// Design: a loop inside the block replaces the TPU's sequential chunk
// axis. The dv columns of S are independent, so the grid is (BH, dv / 64)
// and a block holds its (D, 64) tile of S and all of z in shared memory
// for the whole sequence. A 256 x 256 f32 score tile (256 KB) does not
// fit, so the block walks the sequence in chunks of 64 rows (the chunk is
// not part of the function; the wrapper keeps the reference's check that
// S is a multiple of its chunk). Per chunk: Q K^T and Q S_prev as one
// shared-memory GEMM over D in slabs of 32 (a 4 x 4 micro-tile per
// thread), the causal mask, the row sums, A V, then S += K^T V and
// z += sum K. Every block of a head computes z and the normalizer with
// the same code in the same order, so the dv tiles agree bit for bit.
// Ragged S, D and dv by bounds checks and zero fill (a zero row of K adds
// nothing to S or z).
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// decode_block
// ---------------------------------------------------------------------------

__host__ __device__ inline int decode_parts(int dv) {
  return dv >= kThreads ? 1 : kThreads / dv;
}

inline size_t decode_smem_bytes(int dh, int D, int dv) {
  const size_t floats = (size_t)D * dv + 3 * (size_t)D + 2 * (size_t)dh + dv +
                        (size_t)decode_parts(dv) * dv + kWarps + 4;
  return 4 * floats;
}

template <bool PRF, bool BF16, bool NORMALIZE>
__global__ void __launch_bounds__(kThreads)
decode_block_kernel(const float* __restrict__ s_in,
                    const float* __restrict__ z_in,
                    const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ scale, float* __restrict__ out,
                    float* __restrict__ s_out, float* __restrict__ z_out,
                    int T, int dh, int D, int dv, float eps, float root_d) {
  extern __shared__ float smem[];
  const int parts = decode_parts(dv);
  const size_t state = (size_t)D * dv;
  float* S = smem;             // (D, dv)
  float* z = S + state;        // (D,)
  float* pq = z + D;           // phi_q of the tick
  float* pk = pq + D;          // phi_k of the tick
  float* xq = pk + D;          // (dh,)
  float* xk = xq + dh;         // (dh,)
  float* vrow = xk + dh;       // (dv,)
  float* red = vrow + dv;      // (parts, dv) partial numerators
  float* wred = red + (size_t)parts * dv;  // per-warp normalizer partials
  float* scal = wred + kWarps;             // |xq|^2, |xk|^2, denominator

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t head = blockIdx.x;

  for (size_t e = tid; e < state; e += kThreads) S[e] = s_in[head * state + e];
  for (int j = tid; j < D; j += kThreads) z[j] = z_in[head * D + j];

  for (int t = 0; t < T; ++t) {
    const size_t row = head * T + t;
    for (int i = tid; i < dh; i += kThreads) {
      xq[i] = q[row * dh + i];
      xk[i] = k[row * dh + i];
    }
    for (int c = tid; c < dv; c += kThreads) vrow[c] = v[row * dv + c];
    __syncthreads();
    if (PRF) {
      if (warp < 2) {
        const float* x = warp == 0 ? xq : xk;
        float acc = 0.f;
        for (int i = lane; i < dh; i += 32) acc = __fmaf_rn(x[i], x[i], acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
        if (lane == 0) scal[warp] = acc;
      }
      __syncthreads();
    }

    // Featurize the tick: feature j by one thread, one fixed-order chain.
    float den_part = 0.f;
    for (int j = tid; j < D; j += kThreads) {
      float aq = 0.f, ak = 0.f;
      for (int i = 0; i < dh; ++i) {
        float wij = __ldg(w + (size_t)i * D + j);
        float a = xq[i], b = xk[i];
        if (BF16) {
          wij = round_bf16(wij);
          a = round_bf16(a);
          b = round_bf16(b);
        }
        aq = __fmaf_rn(a, wij, aq);
        ak = __fmaf_rn(b, wij, ak);
      }
      const float sj = __ldg(scale + j);
      float fq, fk;
      if (PRF) {
        const float eq = expf(__fsub_rn(aq, __fmul_rn(scal[0], 0.5f)));
        const float ek = expf(__fsub_rn(ak, __fmul_rn(scal[1], 0.5f)));
        fq = __fmul_rn(sj, __fadd_rn(__fdiv_rn(eq, root_d), 1e-6f));
        fk = __fmul_rn(sj, __fadd_rn(__fdiv_rn(ek, root_d), 1e-6f));
      } else {
        const float bj = __ldg(bias + j);
        fq = __fmul_rn(sj, cosf(__fadd_rn(aq, bj)));
        fk = __fmul_rn(sj, cosf(__fadd_rn(ak, bj)));
      }
      if (BF16) {
        fq = round_bf16(fq);
        fk = round_bf16(fk);
      }
      pq[j] = fq;
      pk[j] = fk;
      const float zj = __fadd_rn(z[j], fk);  // update before emitting
      z[j] = zj;
      den_part = __fmaf_rn(fq, zj, den_part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den_part = __fadd_rn(den_part, __shfl_xor_sync(0xffffffffu, den_part, off));
    if (lane == 0) wred[warp] = den_part;
    __syncthreads();

    // S += phi_k v^T (the token attends to itself).
    for (size_t e = tid; e < state; e += kThreads) {
      const int j = (int)(e / dv);
      const int c = (int)(e % dv);
      S[e] = __fadd_rn(S[e], __fmul_rn(pk[j], vrow[c]));
    }
    if (tid == 0) {
      float den = 0.f;
      for (int i = 0; i < kWarps; ++i) den = __fadd_rn(den, wred[i]);
      scal[2] = __fadd_rn(den, eps);
    }
    __syncthreads();

    // o = phi_q S: each column's sum over D in `parts` fixed ranges.
    for (int idx = tid; idx < parts * dv; idx += kThreads) {
      const int c = idx % dv;
      const int p = idx / dv;
      const int j0 = (int)((long long)p * D / parts);
      const int j1 = (int)((long long)(p + 1) * D / parts);
      float acc = 0.f;
      for (int j = j0; j < j1; ++j)
        acc = __fmaf_rn(pq[j], S[(size_t)j * dv + c], acc);
      red[idx] = acc;
    }
    __syncthreads();
    for (int c = tid; c < dv; c += kThreads) {
      float num = 0.f;
      for (int p = 0; p < parts; ++p) num = __fadd_rn(num, red[p * dv + c]);
      if (NORMALIZE) num = __fdiv_rn(num, scal[2]);
      out[row * dv + c] = num;
    }
    __syncthreads();  // the next tick overwrites x, phi and the partials
  }

  for (size_t e = tid; e < state; e += kThreads) s_out[head * state + e] = S[e];
  for (int j = tid; j < D; j += kThreads) z_out[head * D + j] = z[j];
}

template <bool PRF, bool BF16, bool NORMALIZE>
cudaError_t launch_decode(const float* s_in, const float* z_in, const float* q,
                          const float* k, const float* v, const float* w,
                          const float* b, const float* s, float* out,
                          float* s_out, float* z_out, int BH, int T, int dh,
                          int D, int dv, float eps, float root_d,
                          size_t smem, cudaStream_t st) {
  auto kernel = decode_block_kernel<PRF, BF16, NORMALIZE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<BH, kThreads, smem, st>>>(s_in, z_in, q, k, v, w, b, s, out, s_out,
                                     z_out, T, dh, D, dv, eps, root_d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// linear_attention
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // rows of a chunk (queries and keys)
constexpr int kCols = 64;  // dv columns a block owns
constexpr int kSlab = 32;  // features per step of Q K^T and Q S
constexpr int kPad = 65;   // padded row of the transposed tiles

__host__ __device__ inline int round64(int n) { return (n + 63) / 64 * 64; }

inline size_t linear_smem_bytes(int D) {
  const size_t dp = round64(D);
  const size_t floats = dp * kCols + dp + 2 * kSlab * kPad + kRows * kPad +
                        kRows * kCols;
  return 4 * floats;
}

template <bool NORMALIZE>
__global__ void __launch_bounds__(kThreads)
linear_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        int S, int D, int dv, float eps) {
  extern __shared__ float smem[];
  const int dp = round64(D);
  float* St = smem;                 // (dp, kCols) tile of the state
  float* z = St + (size_t)dp * kCols;  // (dp,)
  float* qT = z + dp;               // (kSlab, kPad) Q slab, transposed
  float* kT = qT + kSlab * kPad;    // (kSlab, kPad) K slab, transposed
  float* A = kT + kSlab * kPad;     // (kRows, kPad) scores, then K rows
  float* Vs = A + kRows * kPad;     // (kRows, kCols) V tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = blockIdx.x;
  const int col0 = blockIdx.y * kCols;
  const float* qh = q + bh * S * D;
  const float* kh = k + bh * S * D;
  const float* vh = v + bh * S * dv;
  float* oh = out + bh * S * dv;

  for (size_t e = tid; e < (size_t)dp * kCols; e += kThreads) St[e] = 0.f;
  for (int j = tid; j < dp; j += kThreads) z[j] = 0.f;
  __syncthreads();

  for (int r0 = 0; r0 < S; r0 += kRows) {
    float a[4][4], o[4][4], qz[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qz[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = o[i][j] = 0.f;
    }
    // Q K^T, Q S_prev and Q z_prev over D in slabs.
    for (int d0 = 0; d0 < D; d0 += kSlab) {
      for (int e = tid; e < kRows * kSlab; e += kThreads) {
        const int r = e / kSlab;
        const int c = e % kSlab;
        const long long gr = (long long)r0 + r;
        const int gd = d0 + c;
        float qv = 0.f, kv = 0.f;
        if (gr < S && gd < D) {
          qv = qh[gr * D + gd];
          kv = kh[gr * D + gd];
        }
        qT[c * kPad + r] = qv;
        kT[c * kPad + r] = kv;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kSlab; ++kk) {
        float qa[4], kb[4], sv[4];
        const float zk = z[d0 + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qT[kk * kPad + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kb[j] = kT[kk * kPad + tx + 16 * j];
          sv[j] = St[(size_t)(d0 + kk) * kCols + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qz[i] = __fmaf_rn(qa[i], zk, qz[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[i][j] = __fmaf_rn(qa[i], kb[j], a[i][j]);
            o[i][j] = __fmaf_rn(qa[i], sv[j], o[i][j]);
          }
        }
      }
      __syncthreads();
    }
    // Causal mask (the diagonal kept), the V tile.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        A[r * kPad + c] = c <= r ? a[i][j] : 0.f;
      }
    for (int e = tid; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols;
      const int c = e % kCols;
      const long long gr = (long long)r0 + r;
      const int gc = col0 + c;
      Vs[e] = (gr < S && gc < dv) ? vh[gr * dv + gc] : 0.f;
    }
    __syncthreads();
    float den[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float rs = 0.f;
      for (int c = 0; c < kRows; ++c) rs = __fadd_rn(rs, A[r * kPad + c]);
      den[i] = __fadd_rn(__fadd_rn(rs, qz[i]), eps);
    }
    for (int c = 0; c < kRows; ++c) {
      float av[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = A[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = Vs[c * kCols + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = __fmaf_rn(av[i], vb[j], o[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long gr = (long long)r0 + ty + 16 * i;
      if (gr >= S) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gc = col0 + tx + 16 * j;
        if (gc >= dv) continue;
        oh[gr * dv + gc] = NORMALIZE ? __fdiv_rn(o[i][j], den[i]) : o[i][j];
      }
    }
    __syncthreads();  // A is reused for K rows below

    // S += K^T V and z += sum K, after this chunk's outputs.
    for (int d0 = 0; d0 < D; d0 += 64) {
      for (int e = tid; e < kRows * 64; e += kThreads) {
        const int r = e / 64;
        const int c = e % 64;
        const long long gr = (long long)r0 + r;
        const int gd = d0 + c;
        A[r * kPad + c] = (gr < S && gd < D) ? kh[gr * D + gd] : 0.f;
      }
      __syncthreads();
      float u[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) u[i][j] = 0.f;
      for (int r = 0; r < kRows; ++r) {
        float kd[4], vb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kd[i] = A[r * kPad + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) vb[j] = Vs[r * kCols + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] = __fmaf_rn(kd[i], vb[j], u[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* sij = St + (size_t)(d0 + ty + 16 * i) * kCols + tx + 16 * j;
          *sij = __fadd_rn(*sij, u[i][j]);
        }
      if (tid < 64) {
        float zs = 0.f;
        for (int r = 0; r < kRows; ++r) zs = __fadd_rn(zs, A[r * kPad + tid]);
        z[d0 + tid] = __fadd_rn(z[d0 + tid], zs);
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one decode block, for the wrapper's check.
long long rff_decode_block_smem_bytes(int dh, int D, int dv) {
  return (long long)decode_smem_bytes(dh, D, dv);
}

// s_in (BH, D, dv), z_in (BH, D), q, k (BH, T, dh), v (BH, T, dv),
// w (dh, D), b (D,), s (D,) f32; out (BH, T, dv), s_out, z_out f32.
// prf selects the positive-random-feature map (b unused, s a 0/1 mask),
// else trig; bf16 the precision contract; root_d is sqrt(D) as f32.
int rff_decode_block(const float* s_in, const float* z_in, const float* q,
                     const float* k, const float* v, const float* w,
                     const float* b, const float* s, float* out, float* s_out,
                     float* z_out, int BH, int T, int dh, int D, int dv,
                     int prf, int bf16, int normalize, float eps, float root_d,
                     void* stream) {
  if (BH < 0 || T < 0 || dh < 1 || D < 1 || dv < 1)
    return cudaErrorInvalidValue;
  if (BH == 0) return cudaSuccess;
  const size_t smem = decode_smem_bytes(dh, D, dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(P, B, N)                                                 \
  return launch_decode<P, B, N>(s_in, z_in, q, k, v, w, b, s, out, s_out,    \
                                z_out, BH, T, dh, D, dv, eps, root_d, smem, st)
  if (prf) {
    if (bf16) {
      if (normalize) REPRO_DECODE(true, true, true);
      REPRO_DECODE(true, true, false);
    }
    if (normalize) REPRO_DECODE(true, false, true);
    REPRO_DECODE(true, false, false);
  }
  if (bf16) {
    if (normalize) REPRO_DECODE(false, true, true);
    REPRO_DECODE(false, true, false);
  }
  if (normalize) REPRO_DECODE(false, false, true);
  REPRO_DECODE(false, false, false);
#undef REPRO_DECODE
}

long long rff_linear_attention_smem_bytes(int D) {
  return (long long)linear_smem_bytes(D);
}

// phi_q, phi_k (BH, S, D), v (BH, S, dv) f32; out (BH, S, dv) f32.
int rff_linear_attention(const float* q, const float* k, const float* v,
                         float* out, int BH, int S, int D, int dv,
                         int normalize, float eps, void* stream) {
  if (BH < 0 || S < 0 || D < 1 || dv < 1) return cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return cudaSuccess;
  const int col_tiles = (dv + kCols - 1) / kCols;
  if (col_tiles > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = linear_smem_bytes(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(BH, col_tiles);
  auto kernel = normalize ? linear_attention_kernel<true>
                          : linear_attention_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, out, S, D, dv, eps);
  return cudaGetLastError();
}

const char* rff_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
