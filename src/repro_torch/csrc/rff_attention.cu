// RFF linear attention for Hopper (sm_90a): the fused decode block and the
// chunk-parallel causal prefill.
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
// heads at B = 4, T = 1) that is 7 MB, 2 us at the memory rate; a tick is
// a chain of short dependent steps, so at T = 1 latency bounds it.
//
// Design: a head's dv columns are split into tiles of 32, one block of
// 256 threads each (112 blocks at the LM shape, 128 at llama3-8b's head).
// The TPU kept S and W (dh, D) in VMEM; here a block keeps its (D, 32)
// tile of S and all of z in shared memory for the whole launch, and, when
// the launch has more than one token and it fits beside them, W too
// (64 KB at dh = 64, D = 256); else W is read from L2. Every block of a
// head featurizes all D features with the same code (thread j owns
// features j, j + 256, ...: the dh loads of a feature issued 16 at a
// time, one fixed-order fmaf chain over dh), so z, the normalizer and the
// tiles' columns agree bit for bit and a block of T tokens equals T
// launches of one. The S update and o = phi_q S are one pass over the
// tile: thread (part p, quad c) owns the 16-byte rows S[j, 4c:4c+4] of
// the features j = p (mod 32), updates them and sums phi_q[j] S[j, :] in
// order of j; the 32 parts are summed by a fixed tree (xor shuffles over
// the warp's 4, then the 8 warps in order), which depends neither on T
// nor on the number of tiles. Two barriers a tick: the next token's q, k
// and v are copied in (cp.async) while this one is featurized, and its
// |x|^2 is taken during this tick's S pass. The state moves in and out
// in 16-byte copies. expf and cosf, never the fast intrinsics; 64-bit
// offsets.
//
// linear_attention replaces repro/kernels/rff_attention.py::
// rff_attention_pallas: causal linear attention over featurized
// phi_q, phi_k (BH, S, D) and v (BH, S, dv): per chunk of rows,
// (Q K^T ∘ tril) V + Q S_prev, normalized by the row sum plus Q z_prev,
// where S_prev and z_prev sum K^T V and K over the earlier chunks.
//
// What bounds it on this card: f32 operations. The least work is the
// recurrent form, 4 D dv + 2 D per token (7.5 GFLOP, 0.11 ms at
// B = 4, S = 2048, 14 heads, D = 256, dv = 64) against 294 MB of inputs
// and outputs (0.09 ms). f32 means IEEE f32 here (no TF32), so the
// products run on the CUDA cores' FFMA.
//
// Design: the TPU's sequential chunk axis becomes two launches over an f32
// workspace of each (head, chunk of 64 rows)'s S_prev (tiles, Dp, 64) and
// z_prev (Dp,), Dp = D rounded up to 32. (1) The state: a block per
// (head, 64 features, tile of 64 dv columns) walks the chunks in order,
// keeping its (64, 64) of S in registers, writing it out as S_prev(c)
// before adding K_c^T V_c (224 blocks at the LM shape; every element
// summed over the rows in order: no atomics, the same bits every run). It
// takes the place of a local-state launch (U_c = K_c^T V_c for every chunk
// at once) and an exclusive prefix over chunks, which wrote, read and
// rewrote the workspace and ran slower at the LM shape on the H100; with
// few heads and long sequences the walk has few blocks (32 at 8 heads,
// D = 256), and that form would be the faster. (2) The outputs, a block per
// (head, chunk, dv tile) (1792 blocks): Q K^T and Q S_prev as one GEMM
// over D, Q, K and S_prev streamed in slabs of 32 features through shared
// memory with cp.async, double-buffered, a thread 8 rows by (4 columns of
// Q S_prev and 4 keys of Q K^T), so that each Q load feeds 32
// multiply-adds; the score quadrant above the diagonal is skipped; then
// the masked scores' row sums and A V. Every product reads 16-byte shared
// loads on rows padded so that the loads have no bank conflicts. Each
// output column depends on its own columns of V and S_prev only, and the
// normalizer is computed by the same code in every tile, so the dv tiles
// agree bit for bit. Ragged S, D and dv by zero fill (a zero row of K adds
// nothing).
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemBudget = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// decode_block
// ---------------------------------------------------------------------------

constexpr int kDecCols = 32;                   // dv columns a block owns
constexpr int kDecQuads = kDecCols / 4;        // 16-byte quads of a row
constexpr int kDecParts = kThreads / kDecQuads;  // 32 parts of D
constexpr int kDecUnroll = 16;                 // W loads in flight a feature

// Floats of a decode block's shared memory without W: the (D, 32) S tile,
// two v rows, the (8, 32) partial numerators, z and the two feature rows,
// two (q, k) token pairs, the per-warp normalizer partials and two
// (|xq|^2, |xk|^2) pairs.
inline size_t decode_base_floats(int dh, int D) {
  return (size_t)D * kDecCols + 2 * kDecCols + kWarps * kDecCols +
         3 * (size_t)D + 4 * (size_t)dh + kWarps + 4;
}

// Whether a launch of T tokens stages W (dh, D) in shared memory.
inline bool decode_stages_w(int T, int dh, int D) {
  return T > 1 &&
         4 * (decode_base_floats(dh, D) + (size_t)dh * D) <= kSmemBudget;
}

// Dynamic shared memory of one decode block of a launch of T tokens.
inline size_t decode_smem_bytes(int T, int dh, int D) {
  return 4 * (decode_base_floats(dh, D) +
              (decode_stages_w(T, dh, D) ? (size_t)dh * D : 0));
}

// Featurize one token pair: phi_q and phi_k of the features j = tid,
// tid + 256, ... into pq, pk; z += phi_k; returns the thread's share of
// phi_q . z (after the update), summed in order of j.
template <bool PRF, bool BF16>
__device__ __forceinline__ float featurize(
    const float* wsrc, const float* __restrict__ xq,
    const float* __restrict__ xk, const float* __restrict__ bias,
    const float* __restrict__ scale, float nq, float nk, float* z, float* pq,
    float* pk, int dh, int D, float root_d) {
  float den_part = 0.f;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    float aq = 0.f, ak = 0.f;
    int i = 0;
    for (; i + kDecUnroll <= dh; i += kDecUnroll) {
      float wv[kDecUnroll];
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) wv[u] = wsrc[(size_t)(i + u) * D + j];
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        float wij = wv[u], a = xq[i + u], b = xk[i + u];
        if (BF16) {
          wij = round_bf16(wij);
          a = round_bf16(a);
          b = round_bf16(b);
        }
        aq = __fmaf_rn(a, wij, aq);
        ak = __fmaf_rn(b, wij, ak);
      }
    }
    for (; i < dh; ++i) {
      float wij = wsrc[(size_t)i * D + j], a = xq[i], b = xk[i];
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
      const float eq = expf(__fsub_rn(aq, __fmul_rn(nq, 0.5f)));
      const float ek = expf(__fsub_rn(ak, __fmul_rn(nk, 0.5f)));
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
  return den_part;
}

// S += phi_k v^T over the block's tile and its share of phi_q S: thread
// (part, quad) owns S[j, 4 quad : 4 quad + 4] for j = part (mod 32).
// Leaves the warp's sum over its 4 parts in red[warp, :].
__device__ __forceinline__ void s_pass(float* St, const float* pq,
                                       const float* pk, const float* vrow,
                                       float* red, int D, int part, int quad,
                                       int lane, int warp) {
  const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * quad);
  float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
  for (int j = part; j < D; j += kDecParts) {
    float4* sp = reinterpret_cast<float4*>(St + (size_t)j * kDecCols + 4 * quad);
    float4 s = *sp;
    const float kj = pk[j], qj = pq[j];
    s.x = __fadd_rn(s.x, __fmul_rn(kj, vv.x));
    s.y = __fadd_rn(s.y, __fmul_rn(kj, vv.y));
    s.z = __fadd_rn(s.z, __fmul_rn(kj, vv.z));
    s.w = __fadd_rn(s.w, __fmul_rn(kj, vv.w));
    *sp = s;
    o0 = __fmaf_rn(qj, s.x, o0);
    o1 = __fmaf_rn(qj, s.y, o1);
    o2 = __fmaf_rn(qj, s.z, o2);
    o3 = __fmaf_rn(qj, s.w, o3);
  }
#pragma unroll
  for (int off = 8; off < 32; off <<= 1) {
    o0 = __fadd_rn(o0, __shfl_xor_sync(0xffffffffu, o0, off));
    o1 = __fadd_rn(o1, __shfl_xor_sync(0xffffffffu, o1, off));
    o2 = __fadd_rn(o2, __shfl_xor_sync(0xffffffffu, o2, off));
    o3 = __fadd_rn(o3, __shfl_xor_sync(0xffffffffu, o3, off));
  }
  if (lane < kDecQuads)
    *reinterpret_cast<float4*>(red + warp * kDecCols + 4 * quad) =
        make_float4(o0, o1, o2, o3);
}

// |x|^2 of a token row by one warp: lane-strided fmaf, then an xor tree.
__device__ __forceinline__ float sq_norm(const float* x, int dh, int lane) {
  float acc = 0.f;
  for (int i = lane; i < dh; i += 32) acc = __fmaf_rn(x[i], x[i], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
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
                    int T, int dh, int D, int dv, float eps, float root_d,
                    bool stage_w, bool vec_s, bool vec_w) {
  extern __shared__ float4 smem4[];
  float* St = reinterpret_cast<float*>(smem4);   // (D, 32) tile of S
  float* vb = St + (size_t)D * kDecCols;         // (2, 32) v rows
  float* red = vb + 2 * kDecCols;                // (8, 32) partial numerators
  float* Ws = red + kWarps * kDecCols;           // (dh, D) W, when staged
  float* z = Ws + (stage_w ? (size_t)dh * D : 0);  // (D,)
  float* pq = z + D;                             // phi_q of the tick
  float* pk = pq + D;                            // phi_k of the tick
  float* xb = pk + D;                            // (2, 2, dh) q, k rows
  float* wred = xb + 4 * dh;                     // per-warp normalizer sums
  float* nrm = wred + kWarps;                    // (2, 2) |xq|^2, |xk|^2

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane % kDecQuads;
  const int part = warp * (32 / kDecQuads) + lane / kDecQuads;
  const size_t head = blockIdx.x;
  const int col0 = blockIdx.y * kDecCols;
  const float* wsrc = stage_w ? Ws : w;

  // A tick's q, k and v rows into buffer `buf` (cp.async, 4 bytes a copy).
  auto fetch = [&](int t, int buf) {
    const size_t row = head * T + t;
    for (int i = tid; i < 2 * dh; i += kThreads) {
      const float* src = i < dh ? q + row * dh + i : k + row * dh + (i - dh);
      cp_async4(xb + (size_t)buf * 2 * dh + i, src);
    }
    if (tid < kDecCols) {
      const int c = col0 + tid;
      if (c < dv)
        cp_async4(vb + buf * kDecCols + tid, v + row * dv + c);
      else
        vb[buf * kDecCols + tid] = 0.f;
    }
  };
  // The first token and W (when staged), then the block's S tile (zero
  // beyond dv), which the first featurize does not wait for; z.
  if (T > 0) fetch(0, 0);
  if (stage_w) {
    const size_t n = (size_t)dh * D;
    if (vec_w) {
      for (size_t e = 4 * (size_t)tid; e < n; e += 4 * kThreads)
        cp_async16(Ws + e, w + e);
    } else {
      for (size_t e = tid; e < n; e += kThreads) Ws[e] = w[e];
    }
  }
  cp_commit();
  for (int e = tid; e < D * kDecQuads; e += kThreads) {
    const int j = e / kDecQuads;
    const int c = col0 + 4 * (e % kDecQuads);
    float* dst = St + (size_t)j * kDecCols + 4 * (e % kDecQuads);
    const float* src = s_in + (head * D + j) * dv + c;
    if (vec_s && c + 4 <= dv) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[u] = c + u < dv ? src[u] : 0.f;
    }
  }
  cp_commit();
  for (int j = tid; j < D; j += kThreads) z[j] = z_in[head * D + j];
  cp_wait<1>();
  __syncthreads();
  if (PRF && T > 0 && warp < 2) {
    const float nv = sq_norm(xb + warp * dh, dh, lane);
    if (lane == 0) nrm[warp] = nv;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t + 1 < T) fetch(t + 1, cur ^ 1);
    cp_commit();
    const float* xq = xb + (size_t)cur * 2 * dh;
    float den_part = featurize<PRF, BF16>(wsrc, xq, xq + dh, bias, scale, nrm[2 * cur], nrm[2 * cur + 1], z, pq, pk, dh, D, root_d);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den_part = __fadd_rn(den_part, __shfl_xor_sync(0xffffffffu, den_part, off));
    if (lane == 0) wred[warp] = den_part;
    cp_wait<0>();
    __syncthreads();  // phi, z and the next token's rows are in

    float den = 0.f;
    if (NORMALIZE) {
      for (int i = 0; i < kWarps; ++i) den = __fadd_rn(den, wred[i]);
      den = __fadd_rn(den, eps);
    }
    s_pass(St, pq, pk, vb + cur * kDecCols, red, D, part, quad, lane, warp);
    if (PRF && t + 1 < T && warp < 2) {
      const float nv = sq_norm(xb + (size_t)(cur ^ 1) * 2 * dh + warp * dh, dh, lane);
      if (lane == 0) nrm[2 * (cur ^ 1) + warp] = nv;
    }
    __syncthreads();  // the partial numerators are in

    if (tid < kDecCols) {
      float num = 0.f;
      for (int i = 0; i < kWarps; ++i) num = __fadd_rn(num, red[i * kDecCols + tid]);
      if (NORMALIZE) num = __fdiv_rn(num, den);
      const int c = col0 + tid;
      if (c < dv) out[(head * T + t) * dv + c] = num;
    }
  }

  cp_wait<0>();  // the S tile, when T = 0
  __syncthreads();
  // State out.
  for (int e = tid; e < D * kDecQuads; e += kThreads) {
    const int j = e / kDecQuads;
    const int c = col0 + 4 * (e % kDecQuads);
    const float* src = St + (size_t)j * kDecCols + 4 * (e % kDecQuads);
    float* dst = s_out + (head * D + j) * dv + c;
    if (vec_s && c + 4 <= dv) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < dv) dst[u] = src[u];
    }
  }
  if (blockIdx.y == 0)
    for (int j = tid; j < D; j += kThreads) z_out[head * D + j] = z[j];
}

template <bool PRF, bool BF16, bool NORMALIZE>
cudaError_t launch_decode(const float* s_in, const float* z_in, const float* q,
                          const float* k, const float* v, const float* w,
                          const float* b, const float* s, float* out,
                          float* s_out, float* z_out, int BH, int T, int dh,
                          int D, int dv, float eps, float root_d,
                          cudaStream_t st) {
  auto kernel = decode_block_kernel<PRF, BF16, NORMALIZE>;
  const size_t smem = decode_smem_bytes(T, dh, D);
  if (smem > kSmemBudget) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec_s = dv % 4 == 0 && aligned16(s_in) && aligned16(s_out);
  const bool vec_w = ((size_t)dh * D) % 4 == 0 && aligned16(w);
  const dim3 grid(BH, (dv + kDecCols - 1) / kDecCols);
  kernel<<<grid, kThreads, smem, st>>>(s_in, z_in, q, k, v, w, b, s, out,
                                       s_out, z_out, T, dh, D, dv, eps, root_d,
                                       decode_stages_w(T, dh, D), vec_s, vec_w);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// linear_attention
// ---------------------------------------------------------------------------

constexpr int kRows = 64;      // rows of a chunk (queries and keys)
constexpr int kCols = 64;      // dv columns of a tile
constexpr int kSlab = 32;      // features a step of the output phase
constexpr int kPitch = 36;     // row-major slab rows: 9 16-byte units, odd
constexpr int kAPitch = 68;    // transposed score rows: 17 units, odd
constexpr int kStateD = 64;    // features of a state block
constexpr int kStateThreads = 128;  // threads of a state block
constexpr int kStateStage = kRows * (kStateD + kCols);  // a chunk of K, V
constexpr int kOutThreads = 128;  // threads of an output block
constexpr int kOutStage = 2 * kRows * kPitch + kSlab * kCols + kSlab;

struct LinearDims {
  int nc, tiles, Dp;
  size_t chunk_floats;  // a (head, chunk) of the workspace: S_prev, z_prev
};

__host__ __device__ inline LinearDims linear_dims(int S, int D, int dv) {
  LinearDims g;
  g.nc = (S + kRows - 1) / kRows;
  g.tiles = (dv + kCols - 1) / kCols;
  g.Dp = round_up(D, kSlab);
  g.chunk_floats = (size_t)g.tiles * g.Dp * kCols + g.Dp;
  return g;
}

constexpr size_t kStateSmem = 4 * 2 * (size_t)kStateStage;
constexpr size_t kOutSmem = 4 * (2 * (size_t)kOutStage + 2 * kRows);
constexpr size_t kLinearSmem = kStateSmem > kOutSmem ? kStateSmem : kOutSmem;

// Copy rows [r0, r0 + ROWS) and columns [c0, c0 + WIDTH) of a row-major
// (nrows, ncols) matrix with row stride ld into dst (row pitch P), zero
// outside it: 16-byte cp.async where a quad lies inside and `vec` says
// the rows are 16-byte aligned, else scalar copies.
template <int ROWS, int WIDTH, int P, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long r0, int c0, long long nrows,
                                          int ncols, long long ld, bool vec) {
  constexpr int kQuads = WIDTH / 4;
  for (int e = threadIdx.x; e < ROWS * kQuads; e += THREADS) {
    const int r = e / kQuads;
    const int c = 4 * (e % kQuads);
    float* d = dst + r * P + c;
    const long long gr = r0 + r;
    const int gc = c0 + c;
    if (vec && gr < nrows && gc + 4 <= ncols) {
      cp_async16(d, src + gr * ld + gc);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        d[u] = (gr < nrows && gc + u < ncols) ? src[gr * ld + gc + u] : 0.f;
    }
  }
}

// Phases 1 and 2 in one launch: the state of features [64 y, 64 y + 64)
// and dv tile z of a head, walked over its chunks in order. Before adding
// chunk c the block writes the running S (and, tile 0, z) as S_prev(c),
// z_prev(c); then S += K_c^T V_c and z += sum K_c, every element summed
// over the rows in order. K_c and V_c stream through shared memory, the
// next chunk copied in (cp.async) while this one is summed. Thread (h, q)
// of warp w, lane = 16 h + q, owns features 8 (2 w + h) + i (i < 8) and
// columns 4 q + j (j < 4), so that 16 lanes write a row of S_prev
// together; for z, warp 0's lane l sums features l and 32 + l.
__global__ void __launch_bounds__(kStateThreads, 3)
linear_state_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ ws, int S, int D, int dv, bool vec_k,
                    bool vec_v) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const LinearDims g = linear_dims(S, D, dv);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int f0 = 8 * (2 * warp + lane / 16);  // the thread's first feature
  const int cq = lane % 16;
  const size_t bh = blockIdx.x;
  const int d0 = blockIdx.y * kStateD;
  const int tile = blockIdx.z;
  const bool zwarp = tile == 0 && warp == 0;
  const float* kh = k + bh * S * D;
  const float* vh = v + bh * S * dv;

  auto stage = [&](int buf, int c) {
    float* ks = smem + buf * kStateStage;
    const long long r0 = (long long)c * kRows;
    load_tile<kRows, kStateD, kStateD, kStateThreads>(ks, kh, r0, d0, S, D,
                                                      D, vec_k);
    load_tile<kRows, kCols, kCols, kStateThreads>(
        ks + kRows * kStateD, vh, r0, tile * kCols, S, dv, dv, vec_v);
    cp_commit();
  };

  float acc[8][4], z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  stage(0, 0);
  for (int c = 0; c < g.nc; ++c) {
    float* wc = ws + (bh * g.nc + c) * g.chunk_floats;
    float* u = wc + (size_t)tile * g.Dp * kCols;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = d0 + f0 + i;
      if (d < g.Dp)
        *reinterpret_cast<float4*>(u + (size_t)d * kCols + 4 * cq) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    if (zwarp) {
      float* zc = wc + (size_t)g.tiles * g.Dp * kCols;
      if (d0 + lane < g.Dp) zc[d0 + lane] = z0;
      if (d0 + 32 + lane < g.Dp) zc[d0 + 32 + lane] = z1;
    }
    if (c + 1 < g.nc) {
      stage((c + 1) & 1, c + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* ks = smem + (c & 1) * kStateStage;
    const float* vs = ks + kRows * kStateD;
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float4* kr = reinterpret_cast<const float4*>(ks + r * kStateD + f0);
      const float4 vv = *reinterpret_cast<const float4*>(vs + r * kCols + 4 * cq);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float4 k4 = kr[m];
        const float kd[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[4 * m + i][0] = __fmaf_rn(kd[i], vv.x, acc[4 * m + i][0]);
          acc[4 * m + i][1] = __fmaf_rn(kd[i], vv.y, acc[4 * m + i][1]);
          acc[4 * m + i][2] = __fmaf_rn(kd[i], vv.z, acc[4 * m + i][2]);
          acc[4 * m + i][3] = __fmaf_rn(kd[i], vv.w, acc[4 * m + i][3]);
        }
      }
      if (zwarp) {
        z0 = __fadd_rn(z0, ks[r * kStateD + lane]);
        z1 = __fadd_rn(z1, ks[r * kStateD + 32 + lane]);
      }
    }
    __syncthreads();  // the buffer is refilled next chunk
  }
}

// One slab step of phase 3 for one thread: 4 features at a time, Q S_prev
// into o (and, with SCORES, Q K^T into a).
template <bool SCORES>
__device__ __forceinline__ void output_slab(const float* Qs, const float* Ks,
                                            const float* Ss, int rbase,
                                            int cbase, int rg, int cg,
                                            float (&o)[8][4],
                                            float (&a)[8][4]) {
#pragma unroll 2
  for (int kq = 0; kq < kSlab / 4; ++kq) {
    float4 sb[4], kb[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      sb[t] = *reinterpret_cast<const float4*>(Ss + (4 * kq + t) * kCols +
                                               cbase + 4 * cg);
      if (SCORES)
        kb[t] = *reinterpret_cast<const float4*>(
            Ks + (cbase + cg + 8 * t) * kPitch + 4 * kq);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(
          Qs + (rbase + rg + 4 * i) * kPitch + 4 * kq);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        o[i][0] = __fmaf_rn(xs[t], sb[t].x, o[i][0]);
        o[i][1] = __fmaf_rn(xs[t], sb[t].y, o[i][1]);
        o[i][2] = __fmaf_rn(xs[t], sb[t].z, o[i][2]);
        o[i][3] = __fmaf_rn(xs[t], sb[t].w, o[i][3]);
      }
      if (SCORES) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          a[i][t] = __fmaf_rn(x.x, kb[t].x, a[i][t]);
          a[i][t] = __fmaf_rn(x.y, kb[t].y, a[i][t]);
          a[i][t] = __fmaf_rn(x.z, kb[t].z, a[i][t]);
          a[i][t] = __fmaf_rn(x.w, kb[t].w, a[i][t]);
        }
      }
    }
  }
}

// Phase 3: the outputs of chunk c, dv tile y, by 4 warps. Warp w owns
// rows 32 qa + rg + 4 i (i < 8, qa = w / 2, lane = 8 rg + cg): of
// Q S_prev and then A V the columns 32 qb + 4 cg + j (j < 4, qb = w % 2),
// and of the scores A = Q K^T the keys 32 qb + cg + 8 j, skipped for the
// quadrant above the diagonal (qb > qa). Every thread also sums half of
// each slab of Q z_prev for row tid / 2. The scores go to shared memory
// transposed, each thread's 8 rows stored contiguously (position
// 32 qa + 8 rg + i), for the row sums and A V; the V tile is copied in
// during the last slab.
template <bool NORMALIZE>
__global__ void __launch_bounds__(kOutThreads, 3)
linear_output_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ ws,
                     float* __restrict__ out, int S, int D, int dv, float eps,
                     bool vec_qk, bool vec_v) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qz = smem + 2 * kOutStage;  // (64,) Q z_prev
  float* den = qz + kRows;           // (64,) normalizers

  const LinearDims g = linear_dims(S, D, dv);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rg = lane / 8;
  const int cg = lane % 8;
  const size_t bh = blockIdx.x / g.nc;
  const int c = blockIdx.x % g.nc;
  const int tile = blockIdx.y;
  const int col0 = tile * kCols;
  const long long row0 = (long long)c * kRows;
  const float* qh = q + bh * S * D;
  const float* kh = k + bh * S * D;
  const float* vh = v + bh * S * dv;
  const float* wc = ws + (bh * g.nc + c) * g.chunk_floats;
  const float* sp = wc + (size_t)tile * g.Dp * kCols;     // (Dp, 64) S_prev
  const float* zp = wc + (size_t)g.tiles * g.Dp * kCols;  // (Dp,) z_prev

  const int qa = warp / 2;
  const int qb = warp % 2;
  const bool scores = qb <= qa;
  const int rbase = 32 * qa;
  const int cbase = 32 * qb;

  auto stage = [&](int buf, int f0) {
    float* Qs = smem + buf * kOutStage;
    float* Ks = Qs + kRows * kPitch;
    float* Ss = Ks + kRows * kPitch;
    float* zs = Ss + kSlab * kCols;
    load_tile<kRows, kSlab, kPitch, kOutThreads>(Qs, qh, row0, f0, S, D, D,
                                                 vec_qk);
    load_tile<kRows, kSlab, kPitch, kOutThreads>(Ks, kh, row0, f0, S, D, D,
                                                 vec_qk);
    for (int e = tid; e < kSlab * kCols / 4; e += kOutThreads)
      cp_async16(Ss + 4 * e, sp + (size_t)f0 * kCols + 4 * e);
    if (tid < kSlab / 4) cp_async16(zs + 4 * tid, zp + f0 + 4 * tid);
  };

  float o[8][4], a[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = a[i][j] = 0.f;
  float zpart = 0.f;
  const int zr = tid / 2;
  const int zh = 16 * (tid % 2);

  const int steps = g.Dp / kSlab;
  const int last = (steps - 1) & 1;  // the buffer of the last slab
  float* At = smem + last * kOutStage;        // (64 keys, kAPitch) scores
  float* Vs = smem + (last ^ 1) * kOutStage;  // (64, 64) V tile
  stage(0, 0);
  cp_commit();
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps)
      stage((it + 1) & 1, (it + 1) * kSlab);
    else
      load_tile<kRows, kCols, kCols, kOutThreads>(Vs, vh, row0, col0, S, dv,
                                                  dv, vec_v);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* Qs = smem + (it & 1) * kOutStage;
    const float* Ks = Qs + kRows * kPitch;
    const float* Ss = Ks + kRows * kPitch;
    const float* zs = Ss + kSlab * kCols;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 x = *reinterpret_cast<const float4*>(Qs + zr * kPitch + zh + 4 * m);
      const float4 y = *reinterpret_cast<const float4*>(zs + zh + 4 * m);
      zpart = __fmaf_rn(x.x, y.x, zpart);
      zpart = __fmaf_rn(x.y, y.y, zpart);
      zpart = __fmaf_rn(x.z, y.z, zpart);
      zpart = __fmaf_rn(x.w, y.w, zpart);
    }
    if (scores)
      output_slab<true>(Qs, Ks, Ss, rbase, cbase, rg, cg, o, a);
    else
      output_slab<false>(Qs, Ks, Ss, rbase, cbase, rg, cg, o, a);
    __syncthreads();  // the buffer is refilled next step
  }
  cp_wait<0>();  // the V tile

  // Q z_prev: the two halves of row tid / 2, in order.
  const float zhi = __shfl_down_sync(0xffffffffu, zpart, 1);
  if (tid % 2 == 0) qz[zr] = __fadd_rn(zpart, zhi);
  // The masked scores, transposed (the diagonal kept).
  if (scores) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int key = cbase + cg + 8 * t;
      float m[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = key <= rbase + rg + 4 * i ? a[i][t] : 0.f;
      float* dst = At + key * kAPitch + rbase + 8 * rg;
      *reinterpret_cast<float4*>(dst) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(m[4], m[5], m[6], m[7]);
    }
  }
  __syncthreads();

  if (tid < kRows) {
    // Row sums over keys 0..r in order, then + Q z_prev + eps.
    const int r = tid;
    const int pos = 32 * (r / 32) + 8 * (r % 4) + (r % 32) / 4;
    float rs = 0.f;
    for (int key = 0; key <= r; ++key) rs = __fadd_rn(rs, At[key * kAPitch + pos]);
    den[r] = __fadd_rn(__fadd_rn(rs, qz[r]), eps);
  }
  // A V over the keys the warp's rows can see.
  for (int key = 0; key < rbase + 32; ++key) {
    const float4 a0 = *reinterpret_cast<const float4*>(At + key * kAPitch + rbase + 8 * rg);
    const float4 a1 = *reinterpret_cast<const float4*>(At + key * kAPitch + rbase + 8 * rg + 4);
    const float4 vv = *reinterpret_cast<const float4*>(Vs + key * kCols + cbase + 4 * cg);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i][0] = __fmaf_rn(ar[i], vv.x, o[i][0]);
      o[i][1] = __fmaf_rn(ar[i], vv.y, o[i][1]);
      o[i][2] = __fmaf_rn(ar[i], vv.z, o[i][2]);
      o[i][3] = __fmaf_rn(ar[i], vv.w, o[i][3]);
    }
  }
  __syncthreads();  // the normalizers are in
  float* oh = out + bh * S * dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rbase + rg + 4 * i;
    const long long gr = row0 + r;
    if (gr >= S) continue;
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = NORMALIZE ? __fdiv_rn(o[i][j], den[r]) : o[i][j];
    const int gc = col0 + cbase + 4 * cg;
    float* dst = oh + gr * dv + gc;
    if (vec_v && gc + 4 <= dv) {
      *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gc + j < dv) dst[j] = y[j];
    }
  }
}

cudaError_t linear_state(const float* k, const float* v, float* ws, int BH,
                         int S, int D, int dv, cudaStream_t st) {
  const LinearDims g = linear_dims(S, D, dv);
  cudaError_t err = cudaFuncSetAttribute(
      linear_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kStateSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (g.Dp + kStateD - 1) / kStateD, g.tiles);
  linear_state_kernel<<<grid, kStateThreads, kStateSmem, st>>>(
      k, v, ws, S, D, dv, D % 4 == 0 && aligned16(k),
      dv % 4 == 0 && aligned16(v));
  return cudaGetLastError();
}

cudaError_t linear_outputs(const float* q, const float* k, const float* v,
                           const float* ws, float* out, int BH, int S, int D,
                           int dv, bool normalize, float eps, cudaStream_t st) {
  const LinearDims g = linear_dims(S, D, dv);
  auto kernel = normalize ? linear_output_kernel<true>
                          : linear_output_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kOutSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((long long)BH * g.nc), g.tiles);
  kernel<<<grid, kOutThreads, kOutSmem, st>>>(
      q, k, v, ws, out, S, D, dv, eps,
      D % 4 == 0 && aligned16(q) && aligned16(k),
      dv % 4 == 0 && aligned16(v) && aligned16(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one decode block of a launch of more than one
// token (W staged where it fits), for the wrapper's check. dv does not
// change it: a block owns 32 columns.
long long rff_decode_block_smem_bytes(int dh, int D, int dv) {
  (void)dv;
  return (long long)decode_smem_bytes(2, dh, D);
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
  if ((dv + kDecCols - 1) / kDecCols > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(P, B, N)                                                 \
  return launch_decode<P, B, N>(s_in, z_in, q, k, v, w, b, s, out, s_out,    \
                                z_out, BH, T, dh, D, dv, eps, root_d, st)
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

// Dynamic shared memory of the largest linear-attention block (the output
// phase's; D does not change it: Q, K and S_prev stream in slabs).
long long rff_linear_attention_smem_bytes(int D) {
  (void)D;
  return (long long)kLinearSmem;
}

// Bytes of the workspace a call needs: the local states and z of every
// (head, chunk), then their exclusive prefix in place.
long long rff_linear_attention_workspace_bytes(int BH, int S, int D, int dv) {
  const LinearDims g = linear_dims(S, D, dv);
  return 4LL * BH * g.nc * (long long)g.chunk_floats;
}

// phi_q, phi_k (BH, S, D), v (BH, S, dv) f32; out (BH, S, dv) f32; ws a
// workspace of rff_linear_attention_workspace_bytes (ws_bytes checked).
int rff_linear_attention(const float* q, const float* k, const float* v,
                         float* out, float* ws, long long ws_bytes, int BH,
                         int S, int D, int dv, int normalize, float eps,
                         void* stream) {
  if (BH < 0 || S < 0 || D < 1 || dv < 1) return cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return cudaSuccess;
  if (ws_bytes < rff_linear_attention_workspace_bytes(BH, S, D, dv) ||
      !aligned16(ws))
    return cudaErrorInvalidValue;
  const LinearDims g = linear_dims(S, D, dv);
  if ((long long)BH * g.nc > 0x7fffffffLL || g.tiles > 65535 ||
      (g.Dp + kStateD - 1) / kStateD > 65535)
    return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = linear_state(k, v, ws, BH, S, D, dv, st)) != cudaSuccess) return err;
  if ((err = linear_outputs(q, k, v, ws, out, BH, S, D, dv, normalize != 0, eps, st)) != cudaSuccess) return err;
  return cudaSuccess;
}

const char* rff_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
