// Blocked softmax attention with the online (m, l) statistics, in IEEE f32
// on the CUDA cores of Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas for
// f32 inputs: q, k (BH, S, dh), v (BH, S, dv) f32, dh and dv up to 256
// and independent (deepseek-v2-lite's MLA heads are (192, 128),
// minicpm3's (96, 64)); q scaled by dh^-1/2 with __fmul_rn; causal or
// not; masked scores -1e30; the running max m, the running denominator l
// and the output accumulator in f32; the output divided by
// max(l, 1e-30). bf16 inputs go to the tensor-core kernel
// (csrc/flash_attention_sm90.cu).
//
// Why the CUDA cores: f32 means IEEE f32 in this port. The tensor cores
// take f32 inputs only rounded to 10 mantissa bits, and the split products
// that recover f32's accuracy from three such products round differently
// from an f32 FMA chain; neither is the reference's arithmetic. So no
// tensor-core instruction here, no fast-math build, and the IEEE expf for
// every exponential.
//
// What bounds it on this card: operations. Causal attention at B = 4, 14
// heads, S = 2048, dh = dv = 64 keeps 117.5 M (query, key) pairs, each
// 4 dh + 3 operations (Q K^T and P V as multiply-adds, the subtract, exp
// and add of the softmax): 30.4 G operations, 0.454 ms at the 67 TFLOP/s
// of f32 outside the tensor cores, against 0.03 ms for its 117 MB of
// inputs and output at 3.35 TB/s. Feeding the FMA units is the whole
// problem: an SM retires 128 FMAs a clock but its shared memory delivers
// 128 bytes (32 floats) a clock, and the timings of this kernel's tiles
// fit a broadcast costing each lane's bytes all the same. So a product
// whose operands come from shared memory keeps pace only at 4 FMAs a
// float loaded: a thread tile of 8 x 8 (8 + 8 floats of each d or key
// step for 64 FMAs). This kernel's first version (4 x 4 tiles, scalar
// loads: 2 FMAs a load) ran at a quarter of the bound.
//
// Design:
//  * One block per (head, query tile), walking 64-key tiles up to the
//    diagonal; tiles wholly above it are skipped (the TPU computed them,
//    and they added exactly 0). A thread is (row group rg = tid / 8, key
//    group cg = tid % 8) and owns TM rows rg + RG i (i < TM), keys cg + 8 j
//    (j < 8) and output columns 4 cg + 32 c + (0..3) (c < TD4, dv <= 32
//    TD4); a warp is 4 row groups by 8 key groups. Three thread tiles,
//    picked by kernels/flash_attention.py's flash_plan from (dh, dv, S):
//    - 128 rows of 8 a thread (128 threads; 8 x 8 scores and, at dv = 64,
//      8 x 8 outputs a thread) where dv <= 64 and two blocks fit an SM;
//    - 128 rows of 4 a thread (256 threads; 4 x 8 scores) where dv <= 128;
//    - 64 rows of 2 a thread (256 threads) for dv <= 256, and wherever S
//      is one 64-key tile (128 rows would be half padding).
//    The grid is (BH, query tiles) and blockIdx.y counts from the last
//    query tile, so every head's heaviest tiles start first.
//  * Q K^T walks d four at a time over row-major Q and K tiles in shared
//    memory: a float4 of each of the thread's TM rows of Q and of its 8
//    keys of K, then 32 TM FMAs. The tiles' rows are padded to ld floats,
//    ld / 4 odd (dh + 4 at dh = 64), so the 8 keys a phase of 8 lanes reads
//    fall on 8 distinct 16-byte bank groups.
//  * P V walks keys four at a time over a (rows, keys) P tile (rows of 72
//    floats: the 4 rows a warp stores fall on distinct banks) and the
//    (keys, dv) V tile: a float4 of P for each row and a float4 of V for
//    each key and column group, 16 TM TD4 FMAs for TM + 4 TD4 loads.
//  * The config heads on their 128-row tiles ((64, 64), (128, 128) and
//    deepseek's (192, 128)) are compiled for their widths (DH, DV): the
//    strides and loop bounds become constants, which freed the registers
//    and address arithmetic that held the 8 x 8 tile back.
//  * A fixed order of the sums, no split over d or keys: each score sums
//    over d in order 0 ... dh - 1 and each output over keys in order, so
//    a row's bits depend only on its q row and its head's K and V (not on
//    BH, nor on the tile). A row's max and sum go across the 8 lanes that
//    share it with a fixed xor tree (4, 2, 1). The masks (keys past S;
//    causal) apply only on tiles that reach the diagonal or the tail; key
//    0 is never masked, so a row always has a finite max.
//  * K and V arrive by cp.async (16 bytes a copy; rows past S zero-filled
//    by a source size of 0) into one K and one V tile, two barriers a
//    tile: V of tile kt is copied while Q K^T and the softmax of tile kt
//    run, and K of tile kt + 1 while its P V runs. A double buffer of both
//    (tile kt + 1's K and V in flight during all of tile kt) was slower at
//    dh = dv = 64 (two blocks no longer fit an SM) and no faster on the
//    other tiles where it was timed. Q is read once, scaled into shared
//    memory.
//  * Shared memory: 4 (R ld + 64 (ld + dv) + 72 R) bytes for R query
//    rows, at most chunking.SMEM_BUDGET; flash_plan's _smem_bytes
//    mirrors it and the card tests hold it against
//    flash_attention_smem_bytes below. At dh = dv = 64 (128 rows of 8 a
//    thread): 105,472 bytes and 255 registers a thread, no spill
//    (-Xptxas -v), so two blocks of 128 threads an SM, 8 warps. At
//    deepseek's (192, 128) (128 rows of 4): 220,160 bytes, 238 registers
//    (causal; 236 not), one block of 256 threads.
//
// The wrapper pads dh and dv to multiples of 4 (zero columns change no
// score and no kept output) and hands 16-byte aligned rows.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKeys = 64;          // keys a tile
constexpr int kKeyGroups = 8;      // tid % 8; tid / 8 is the row group
constexpr int kKeysEach = kKeys / kKeyGroups;  // keys a thread: cg + 8 j
constexpr int kPLd = kKeys + 8;    // a row of P
constexpr float kNegInf = -1e30f;

// Row stride of the Q and K tiles: dh, or dh + 4 where dh / 4 is even, so
// that 8 consecutive rows start on 8 distinct 16-byte bank groups.
__host__ __device__ inline int qk_ld(int dh) {
  return (dh / 4) % 2 ? dh : dh + 4;
}

inline size_t smem_bytes(int rows, int dh, int dv) {
  const size_t ld = qk_ld(dh);
  return 4 * ((size_t)rows * ld + (size_t)kKeys * (ld + dv) +
              (size_t)rows * kPLd);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) of a head's (S, w) matrix into a (64, ld) tile,
// rows past S zero-filled; w is a multiple of 4.
template <int NT>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int r0, int S,
                                          int w) {
  const int w4 = w / 4;
  for (int e = threadIdx.x; e < kKeys * w4; e += NT) {
    const int r = e / w4;
    const int c = e - r * w4;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * ld + 4 * c,
               src + (size_t)(ok ? r0 + r : 0) * w + 4 * c, ok);
  }
}

__device__ __forceinline__ float lane(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// RG row groups of TM rows (BM = RG TM query rows, 8 RG threads); TD4
// float4 columns of V a thread; DH, DV > 0: dh = DH and dv = DV, known
// when compiled (the tile strides and the loop bounds become constants).
template <int TM, int RG, int TD4, bool CAUSAL, int DH, int DV>
__global__ void __launch_bounds__(kKeyGroups * RG, RG == 16 ? 2 : 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int dh, int dv, float scale) {
  if constexpr (DH > 0) {
    dh = DH;
    dv = DV;
  }
  constexpr int BM = RG * TM;
  constexpr int NT = kKeyGroups * RG;
  const int ld = qk_ld(dh);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // (BM, ld), scaled
  float* Ks = Qs + BM * ld;               // (kKeys, ld)
  float* Vs = Ks + kKeys * ld;            // (kKeys, dv)
  float* P = Vs + kKeys * dv;             // (BM, kPLd)

  const int tid = threadIdx.x;
  const int cg = tid % kKeyGroups;
  const int rg = tid / kKeyGroups;
  const int nq = (S + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BM;
  const size_t head = blockIdx.x;
  const float* kh = k + head * S * dh;
  const float* vh = v + head * S * dv;
  const int nk = ((CAUSAL ? min(q0 + BM, S) : S) + kKeys - 1) / kKeys;

  load_tile<NT>(Ks, ld, kh, 0, S, dh);
  cp_commit();
  load_tile<NT>(Vs, dv, vh, 0, S, dv);
  cp_commit();
  const int dh4 = dh / 4;
  for (int e = tid; e < BM * dh4; e += NT) {
    const int r = e / dh4;
    const int c = e - r * dh4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      x = *reinterpret_cast<const float4*>(q + (head * S + q0 + r) * dh +
                                           4 * c);
      x.x = __fmul_rn(x.x, scale);
      x.y = __fmul_rn(x.y, scale);
      x.z = __fmul_rn(x.z, scale);
      x.w = __fmul_rn(x.w, scale);
    }
    *reinterpret_cast<float4*>(Qs + r * ld + 4 * c) = x;
  }

  float m[TM], l[TM];
  float4 acc[TM][TD4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TD4; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  bool col_ok[TD4];
#pragma unroll
  for (int c = 0; c < TD4; ++c) col_ok[c] = 4 * cg + 32 * c < dv;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kKeys;
    // K of tile kt has landed. Past the barrier every thread is done with
    // P V of tile kt - 1, so P and the V tile are free: V of tile kt is
    // copied while Q K^T and the softmax run (tile 0's came with its K).
    cp_wait<0>();
    __syncthreads();
    if (kt > 0) {
      load_tile<NT>(Vs, dv, vh, k0, S, dv);
      cp_commit();
    }

    float s[TM][kKeysEach];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kKeysEach; ++j) s[i][j] = 0.f;
#pragma unroll(TM == 8 ? 1 : 2)
    for (int d = 0; d < dh; d += 4) {
      float4 qf[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qf[i] = *reinterpret_cast<const float4*>(Qs + (rg + RG * i) * ld + d);
#pragma unroll
      for (int j = 0; j < kKeysEach; ++j) {
        const float4 kf = *reinterpret_cast<const float4*>(
            Ks + (cg + kKeyGroups * j) * ld + d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          s[i][j] = __fmaf_rn(qf[i].x, kf.x, s[i][j]);
          s[i][j] = __fmaf_rn(qf[i].y, kf.y, s[i][j]);
          s[i][j] = __fmaf_rn(qf[i].z, kf.z, s[i][j]);
          s[i][j] = __fmaf_rn(qf[i].w, kf.w, s[i][j]);
        }
      }
    }
    const bool edge = k0 + kKeys > S || (CAUSAL && k0 + kKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = rg + RG * i;
      if (edge) {
#pragma unroll
        for (int j = 0; j < kKeysEach; ++j) {
          const int kpos = k0 + cg + kKeyGroups * j;
          if (kpos >= S || (CAUSAL && kpos > q0 + row)) s[i][j] = kNegInf;
        }
      }
      float mb = s[i][0];
#pragma unroll
      for (int j = 1; j < kKeysEach; ++j) mb = fmaxf(mb, s[i][j]);
#pragma unroll
      for (int off = kKeyGroups / 2; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m[i], mb);
      const float corr = expf(__fsub_rn(m[i], m_new));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysEach; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        P[row * kPLd + cg + kKeyGroups * j] = p;
        ps = __fadd_rn(ps, p);
      }
#pragma unroll
      for (int off = kKeyGroups / 2; off > 0; off >>= 1)
        ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, off));
      l[i] = __fmaf_rn(l[i], corr, ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD4; ++c) {
        acc[i][c].x = __fmul_rn(acc[i][c].x, corr);
        acc[i][c].y = __fmul_rn(acc[i][c].y, corr);
        acc[i][c].z = __fmul_rn(acc[i][c].z, corr);
        acc[i][c].w = __fmul_rn(acc[i][c].w, corr);
      }
    }
    // V of tile kt has landed. Past the barrier P is in place and every
    // thread is done with K of tile kt: K of tile kt + 1 is copied while
    // P V runs.
    cp_wait<0>();
    __syncthreads();
    if (kt + 1 < nk) {
      load_tile<NT>(Ks, ld, kh, k0 + kKeys, S, dh);
      cp_commit();
    }

#pragma unroll 2
    for (int s0 = 0; s0 < kKeys; s0 += 4) {
      float4 pf[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pf[i] = *reinterpret_cast<const float4*>(
            P + (rg + RG * i) * kPLd + s0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < TD4; ++c) {
          const float4 vf =
              col_ok[c] ? *reinterpret_cast<const float4*>(
                              Vs + (s0 + u) * dv + 4 * cg + 32 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float p = lane(pf[i], u);
            acc[i][c].x = __fmaf_rn(p, vf.x, acc[i][c].x);
            acc[i][c].y = __fmaf_rn(p, vf.y, acc[i][c].y);
            acc[i][c].z = __fmaf_rn(p, vf.z, acc[i][c].z);
            acc[i][c].w = __fmaf_rn(p, vf.w, acc[i][c].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = q0 + rg + RG * i;
    if (gr >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < TD4; ++c) {
      if (!col_ok[c]) continue;
      float4 o;
      o.x = __fdiv_rn(acc[i][c].x, denom);
      o.y = __fdiv_rn(acc[i][c].y, denom);
      o.z = __fdiv_rn(acc[i][c].z, denom);
      o.w = __fdiv_rn(acc[i][c].w, denom);
      *reinterpret_cast<float4*>(out + (head * S + gr) * dv + 4 * cg +
                                 32 * c) = o;
    }
  }
}

template <int TM, int RG, int TD4, bool CAUSAL, int DH, int DV>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int BH, int S, int dh, int dv, float scale,
                   cudaStream_t st) {
  constexpr int BM = RG * TM;
  const size_t smem = smem_bytes(BM, dh, dv);
  auto kernel = flash_kernel<TM, RG, TD4, CAUSAL, DH, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not sticky: cleared, so no later check reads it
    return err;
  }
  const int nq = (S + BM - 1) / BM;
  if (nq > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(BH, nq), kKeyGroups * RG, smem, st>>>(q, k, v, out, S, dh,
                                                      dv, scale);
  return cudaGetLastError();
}

// TD4 from dv: 4 TD4 columns a thread, 32 TD4 a row; TM x TD4 <= 16 float4
// accumulators a thread.
template <int TM, int RG, bool CAUSAL>
cudaError_t by_width(const float* q, const float* k, const float* v,
                     float* out, int BH, int S, int dh, int dv, float scale,
                     cudaStream_t st) {
#define FLASH_LAUNCH(TD4, DH, DV)                                       \
  return launch<TM, RG, TD4, CAUSAL, DH, DV>(q, k, v, out, BH, S, dh, dv, \
                                             scale, st)
  // The config heads on their 128-row tiles, compiled for their widths:
  // the dense heads of 64, the dense heads of 128 and deepseek's MLA.
  if constexpr (TM == 8) {
    if (dh == 64 && dv == 64) FLASH_LAUNCH(2, 64, 64);
  }
  if constexpr (TM == 4) {
    if (dh == 128 && dv == 128) FLASH_LAUNCH(4, 128, 128);
    if (dh == 192 && dv == 128) FLASH_LAUNCH(4, 192, 128);
  }
  if (dv <= 32) FLASH_LAUNCH(1, 0, 0);
  if (dv <= 64) FLASH_LAUNCH(2, 0, 0);
  if constexpr (TM <= 4) {
    if (dv <= 128) FLASH_LAUNCH(4, 0, 0);
  }
  if constexpr (TM <= 2) FLASH_LAUNCH(8, 0, 0);
#undef FLASH_LAUNCH
  return cudaErrorInvalidValue;
}

// The thread tiles: 64 rows of 2 a thread (256 threads), 128 rows of 4 (256
// threads) or of 8 (128 threads).
template <bool CAUSAL>
cudaError_t by_tile(const float* q, const float* k, const float* v,
                    float* out, int BH, int S, int dh, int dv, int rows,
                    int thread_rows, float scale, cudaStream_t st) {
  if (rows == 64 && thread_rows == 2)
    return by_width<2, 32, CAUSAL>(q, k, v, out, BH, S, dh, dv, scale, st);
  if (rows == 128 && thread_rows == 4)
    return by_width<4, 32, CAUSAL>(q, k, v, out, BH, S, dh, dv, scale, st);
  if (rows == 128 && thread_rows == 8)
    return by_width<8, 16, CAUSAL>(q, k, v, out, BH, S, dh, dv, scale, st);
  return cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// q, k (BH, S, dh), v, out (BH, S, dv) f32 with 16-byte aligned bases;
// dh, dv multiples of 4 up to 256; scale is dh^-1/2 (of the unpadded dh)
// as f32; rows (query rows a block) and thread_rows (rows a thread) as
// flash_plan picks them.
int flash_attention(const float* q, const float* k, const float* v,
                    float* out, int BH, int S, int dh, int dv, int causal,
                    float scale, int rows, int thread_rows, void* stream) {
  if (BH < 0 || S < 0 || dh < 4 || dh > 256 || dv < 4 || dv > 256 ||
      dh % 4 || dv % 4)
    return cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidConfiguration;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal)
    return by_tile<true>(q, k, v, out, BH, S, dh, dv, rows, thread_rows,
                         scale, st);
  return by_tile<false>(q, k, v, out, BH, S, dh, dv, rows, thread_rows,
                        scale, st);
}

// The dynamic shared memory of one block (what flash_plan's _smem_bytes
// mirrors).
long long flash_attention_smem_bytes(int rows, int dh, int dv) {
  return (long long)smem_bytes(rows, dh, dv);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
