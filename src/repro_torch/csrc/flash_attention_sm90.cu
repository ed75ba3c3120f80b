// Blocked softmax attention on the bf16 tensor cores of Hopper (sm_90a):
// wgmma products, TMA loads, a producer warp and two consumer warpgroups.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas for
// bf16 inputs: q, k (BH, S, dh), v (BH, S, dv) bf16, dh and dv up to 256
// and independent (deepseek-v2-lite's MLA heads (192, 128), minicpm3's
// (96, 64), recurrentgemma's 256); causal or not; masked scores -1e30;
// the running max m, the running denominator l and the output
// accumulator in f32; the output divided by max(l, 1e-30) and stored in
// bf16. f32 inputs keep the CUDA-core kernel (csrc/flash_attention.cu):
// f32 means IEEE f32 in this port, never TF32.
//
// What bounds it on this card: operations. Causal attention at B = 4,
// 14 heads, S = 2048, dh = 64 is 30 GFLOP of products against 59 MB of
// inputs and outputs: 0.03 ms at 989 TFLOP/s of dense bf16, 0.018 ms at
// 3.35 TB/s.
//
// Design:
//  * One block of 288 threads per (head, 128-row query tile): two consumer
//    warpgroups own 64 query rows each, and one producer warp issues the
//    TMA loads. The grid starts with the last query tiles, which have the
//    most key tiles. Key tiles wholly above the diagonal are skipped.
//  * TMA loads the Q tile once, then K and V tiles of BN keys into a
//    two-stage ring in shared memory; mbarriers say when a stage has
//    arrived (full, one arrival plus the bytes) and when both warpgroups
//    are done with it (empty, one arrival a consumer thread). The tensor
//    maps are 3-D over (BH, S, width) with 128-byte swizzle and boxes of 64
//    columns (one swizzle atom), so TMA's zero fill covers both the S tail
//    of a head and the columns past dh or dv: every width that is a
//    multiple of 8 (TMA's 16-byte row stride) runs the same code, q and k
//    padded to HD = 64, 128, 192 or 256 columns.
//  * Shared memory (Layout, at most 232,448 bytes a block; kernels/
//    flash_attention.py's flash_plan checks chunking.SMEM_BUDGET): Q is
//    256 HD bytes and each stage BN (2 HD + 2 DV) bytes. BN = 128 keys up
//    to HD = 192 (214,056 bytes at HD = 192, DV = 128); at HD = 256 a
//    128-key ring would take 64 KiB of Q and 128 KiB of K before V, so
//    BN = 64 there (164,904 bytes).
//  * O is (64 rows, DV) f32 a warpgroup, DV = 64 or 128 (DV / 2 registers
//    a thread, 168 registers in all at HD = DV = 128). A dv above 128 does
//    not fit beside the scores, so the wrapper runs the kernel once for
//    each 128 columns of V (v_col0, v_cols), each pass recomputing Q K^T
//    and the softmax: at dv = 256 the score work doubles. Each pass is a
//    launch and counts as one.
//  * S = Q K^T: wgmma m64nBNk16, both operands K-major from shared
//    memory, f32 accumulator in registers (BN / 2 a thread).
//  * Softmax in f32 registers: the scores are scaled by dh^-1/2 after the
//    product, not q before it as the reference does; at dh = 64 the scale
//    is 1/8 and the two agree exactly, elsewhere they differ in the last
//    bits. The causal and S-tail masks apply only on the last key tile
//    (the diagonal one when causal). A row's max and sum go across the 4
//    lanes of its quad in a fixed order (xor 1, then xor 2). expf, never
//    __expf.
//  * O += P V: P is rounded to bf16 in registers and fed to wgmma as the A
//    operand from registers (the accumulator layout of the first product
//    is the A-fragment layout of the second, so no shuffle and no trip
//    through shared memory), V as an MN-major B operand from shared
//    memory. O stays in f32 registers, rescaled on every tile. l sums the
//    f32 probabilities; P in bf16 is what SDPA's flash kernels use too.
//  * Each thread stores its own rows and column pairs of the pass's
//    columns of the bf16 output.
//
// Plain C interface (loaded with ctypes); each entry returns cudaError_t,
// or minus the CUresult of a tensor map that could not be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;  // query rows a block: two warpgroups of 64
constexpr int kStages = 2;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // plus the producer warp
constexpr int kAtomCols = 64;              // bf16 columns of a 128-byte row
constexpr int kVPass = 128;                // V columns a launch
constexpr float kNegInf = -1e30f;

// Shared memory of one block, from a 1024-byte aligned base (the swizzle
// atoms must start on 1024 bytes): the Q tile, kStages K and V tiles of BN
// keys, then the mbarriers (q, full[kStages], empty[kStages]). An atom is
// 64 columns of all the tile's rows, 128 bytes a row.
template <int HD, int BN, int DV>
struct Layout {
  static constexpr int kQAtom = kBlockM * 128;
  static constexpr int kKAtom = BN * 128;
  static constexpr int kQTile = (HD / kAtomCols) * kQAtom;
  static constexpr int kKTile = (HD / kAtomCols) * kKAtom;
  static constexpr int kVTile = (DV / kAtomCols) * kKAtom;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBar = kV + kStages * kVTile;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of the 3-D map (dh column c0, row c1, head c2) into shared
// memory at dst; its bytes are counted against bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor with 128-byte swizzle: the start
// address, the leading and stride byte offsets (16-byte units), layout
// type 1 (SW128) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128); A and B bf16 in shared
// memory, both K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64); A and B bf16 in shared
// memory, both K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BN == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n128(d, da, db, accumulate);
}

// D (64 x 64, f32) += A (64 x 16) B (16 x 64); A bf16 in registers (four
// packed pairs a thread), B bf16 in shared memory, MN-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128); A bf16 in registers (four
// packed pairs a thread), B bf16 in shared memory, MN-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int DV>
__device__ __forceinline__ void wgmma_rs(float (&d)[DV / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  if constexpr (DV == 64)
    wgmma_rs_n64(d, a0, a1, a2, a3, db);
  else
    wgmma_rs_n128(d, a0, a1, a2, a3, db);
}

template <int HD, int BN, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ out, int S, int v_width,
                  int v_col0, int v_cols, float scale) {
  using L = Layout<HD, BN, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full0 = q_full + 8;              // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;    // empty[s] = empty0 + 8 s

  const int nq = (S + kBlockM - 1) / kBlockM;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int head = blockIdx.y;
  const int nk = CAUSAL ? (min(S, (qi + 1) * kBlockM) + BN - 1) / BN
                        : (S + BN - 1) / BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one lane issues
    if (lane == 0) {
      mbar_expect_tx(q_full, L::kQTile);
      for (int a = 0; a < HD / kAtomCols; ++a)
        tma_load(base + L::kQ + a * L::kQAtom, &tq, q_full, a * kAtomCols,
                 qi * kBlockM, head);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        // The stage's previous tile must be released by both warpgroups.
        if (kt >= kStages) mbar_wait(empty0 + 8 * s, ((kt / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, L::kKTile + L::kVTile);
        for (int a = 0; a < HD / kAtomCols; ++a)
          tma_load(base + L::kK + s * L::kKTile + a * L::kKAtom, &tk, full,
                   a * kAtomCols, kt * BN, head);
        for (int a = 0; a < DV / kAtomCols; ++a)
          tma_load(base + L::kV + s * L::kVTile + a * L::kKAtom, &tv, full,
                   v_col0 + a * kAtomCols, kt * BN, head);
      }
    }
    return;
  }

  // A consumer thread: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of
  // the tile; as in every wgmma accumulator, warp wl of it owns 16 of those
  // rows and lane (g = lane / 4, t = lane % 4) rows g and g + 8 of them,
  // columns 8 j + 2 t and 8 j + 2 t + 1 of each 8-column block j:
  // acc[4 j + 2 r + c] is (row g + 8 r, column 8 j + 2 t + c).
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int row0 = qi * kBlockM + wg * 64 + (warp % 4) * 16 + g;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t qa = base + L::kQ + wg * 64 * 128;  // row 64 wg of each atom

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
    const uint32_t kb = base + L::kK + s * L::kKTile;
    const uint32_t vb = base + L::kV + s * L::kVTile;

    // S = Q K^T over HD / 16 steps of 16 columns: a step moves 32 bytes
    // along the swizzled 128-byte rows, 4 steps an atom.
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss<BN>(sc, smem_desc(qa + (kk / 4) * L::kQAtom + col, 16, 1024),
                   smem_desc(kb + (kk / 4) * L::kKAtom + col, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // Online softmax over this tile, in f32. Masks apply only to a tile
    // that reaches past S or, causal, past the block's first row.
    const int k0 = kt * BN;
    const bool edge = k0 + BN > S || (CAUSAL && k0 + BN > qi * kBlockM);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(sc[4 * j + e], scale);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key >= S || (CAUSAL && key > row)) x = kNegInf;
        }
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(__fsub_rn(m[r], m_new));
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(sc[4 * j + e], m[e >> 1]));
        sc[4 * j + e] = p;
        rs[e >> 1] = __fadd_rn(rs[e >> 1], p);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 1));
      rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 2));
      l[r] = __fmaf_rn(l[r], corr[r], rs[r]);
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = __fmul_rn(o[i], corr[(i >> 1) & 1]);

    // O += P V: P's accumulator pairs are the A fragments of the BN / 16
    // steps of 16 keys; V's step moves 16 rows (2048 bytes); its atoms are
    // LBO = BN rows of 128 bytes apart.
    uint32_t pa[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<DV>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                   pa[4 * kk + 3], smem_desc(vb + kk * 2048, L::kKAtom, 1024));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    mbar_arrive(empty0 + 8 * s);  // this thread is done with the stage
  }

  // This pass's columns v_col0 .. v_col0 + v_cols - 1 of out (BH, S,
  // v_width).
  const size_t hbase = (size_t)head * S * v_width + v_col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= v_cols) continue;  // v_cols is a multiple of 8
      const uint32_t v = pack_bf16(__fdiv_rn(o[4 * j + 2 * r], denom),
                                   __fdiv_rn(o[4 * j + 2 * r + 1], denom));
      *reinterpret_cast<uint32_t*>(out + hbase + (size_t)row * v_width + col) = v;
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// -lcuda at link time).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                             cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 3-D map of a (BH, S, width) bf16 tensor: boxes of 64 columns x
// `rows` rows x 1 head, 128-byte swizzle, zero fill out of bounds.
CUresult make_map(CUtensorMap* map, const void* ptr, int BH, int S,
                  int width, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)S * width * 2};
  const cuuint32_t box[3] = {kAtomCols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int BH, S, dh, dv, v_col0, v_cols;
  float scale;
  cudaStream_t st;
};

template <int HD, int BN, int DV, bool CAUSAL>
int launch(const Args& a) {
  CUtensorMap tq, tk, tv;
  CUresult rc = make_map(&tq, a.q, a.BH, a.S, a.dh, kBlockM);
  if (rc == CUDA_SUCCESS) rc = make_map(&tk, a.k, a.BH, a.S, a.dh, BN);
  if (rc == CUDA_SUCCESS) rc = make_map(&tv, a.v, a.BH, a.S, a.dv, BN);
  if (rc != CUDA_SUCCESS) return -(int)rc;
  constexpr int smem = Layout<HD, BN, DV>::kBytes;
  auto kernel = flash_sm90_kernel<HD, BN, DV, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBlockM - 1) / kBlockM, a.BH);
  kernel<<<grid, kThreads, smem, a.st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.out), a.S, a.dv, a.v_col0,
      a.v_cols, a.scale);
  return cudaGetLastError();
}

// BN = 128 keys a tile up to HD = 192, 64 at HD = 256 (shared memory).
template <int HD, int DV>
int by_causal(const Args& a, int causal) {
  constexpr int BN = HD <= 192 ? 128 : 64;
  return causal ? launch<HD, BN, DV, true>(a) : launch<HD, BN, DV, false>(a);
}

template <int HD>
int by_dv(const Args& a, int causal) {
  return a.v_cols <= 64 ? by_causal<HD, 64>(a, causal)
                        : by_causal<HD, 128>(a, causal);
}

}  // namespace

extern "C" {

// q, k (BH, S, dh), v and out (BH, S, dv) bf16, contiguous, 16-byte
// aligned; dh and dv multiples of 8 in [8, 256]. One pass over V's columns
// v_col0 .. v_col0 + v_cols - 1 (v_col0 a multiple of 128, v_cols a
// multiple of 8 up to 128) writes those columns of out; scale is the f32
// dh^-1/2 of the unpadded head.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int BH, int S, int dh, int dv,
                         int v_col0, int v_cols, int causal, float scale,
                         void* stream) {
  if (BH < 0 || S < 0 || dh < 8 || dh > 256 || dh % 8 || dv < 8 ||
      dv > 256 || dv % 8 || v_col0 < 0 || v_col0 % kVPass || v_cols < 8 ||
      v_cols > kVPass || v_cols % 8 || v_col0 + v_cols > dv)
    return cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidConfiguration;
  const Args a{q, k, v, out, BH, S, dh, dv, v_col0, v_cols, scale,
               static_cast<cudaStream_t>(stream)};
  if (dh <= 64) return by_dv<64>(a, causal);
  if (dh <= 128) return by_dv<128>(a, causal);
  if (dh <= 192) return by_dv<192>(a, causal);
  return by_dv<256>(a, causal);
}

const char* flash_attention_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
