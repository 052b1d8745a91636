// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention.py:76, body `_flash_fwd_kernel` :31).
// It computes the same function: for q (B, Hq, S, D) and k, v (B, Hkv, T, D),
// with query head h reading kv head h / G (G = Hq / Hkv),
//     s[i][j] = (q_i . k_j) * scale                    (float32)
//     masked where j >= T, j > i (causal) or j <= i - window (window > 0)
//     o_i     = sum_j softmax_j(s[i]) v_j              (online, float32)
// and writes o_i = acc / max(l, 1e-30) in q's dtype.  Beyond the TPU kernel it
// writes the row's logsumexp, lse_i = m_i + log(max(l_i, 1e-30)), in float32,
// which the backward pass (plain PyTorch, kernels/flash_attention.py) uses to
// rebuild the softmax.  Masks are by index, as in the TPU kernel: query row i
// sits at position i and key row j at position j.
//
// Bound on this card.  At the training shape of qwen3-8b (B = 2, Hq = 32,
// Hkv = 8, S = T = 4096, D = 128, causal) the function needs 275 GFLOP (two
// products over 537 M causal pairs) against 169 MB of traffic, so it is bound
// by operations: 278 us at the bf16 tensor-core peak.
//
// Two instances, chosen by shape and layout alone in the C entry point:
//
// 1. bf16 with D % 8 == 0 and 16-byte aligned q, k, v (every call of the
//    port's models): the tensor-core instance `flash_fwd_tc_kernel`, with D
//    padded with zeros to DP = 64 (D <= 64), 128 (D <= 128) or 256 (D <= 256).
//    * Grid: one block per (b, q head, 128-row q tile), the longest causal
//      walks first.  288 threads: warpgroups 0 and 1 are consumers and own
//      64 q rows each; warp 8 is the producer (one thread issues every
//      copy).  A thread gets at most 168 registers (the SM's registers are
//      split over 4 sub-partitions, and 9 warps put 3 on one);
//      `setmaxnreg` from a producer warpgroup did not raise ptxas's budget
//      (a variant without it compiled to the same spills), so the tiles
//      are sized to fit 168.
//    * Copies: TMA, from three 3-D tensor maps (D, rows, batch x heads) built
//      on the host in the entry point (`cuTensorMapEncodeTiled` reached
//      through `cudaGetDriverEntryPoint`, so nothing new is linked).  A box
//      is 64 columns (128 bytes) wide with 128-byte swizzle, the layout the
//      wgmma descriptors name; columns >= D and rows >= S or T lie outside
//      the tensor and arrive as zeros.  Q is loaded once; K and V tiles of
//      BK = 64 rows (32 at DP = 256: a consumer thread's accumulators, S
//      and P's two parts must fit the 168 registers the launch bound
//      leaves, or ptxas serializes the wgmma pipeline) go through a
//      2-stage ring with full / empty mbarriers for K and for V apart, so
//      a K slot is refilled as soon as Q.K^T has read it.
//    * Q.K^T: `wgmma.mma_async` m64nBKk16, Q and K from shared memory (both
//      K-major), f32 accumulators in registers.  The scores are exact f32
//      sums of exact bf16 products, so lse keeps its 1e-4.
//    * Softmax on those registers, with the plain version's arithmetic:
//      scores times scale, m the running max, p = expf(s - m) (IEEE-accurate,
//      no fast math), lse = m + log(max(l, 1e-30)).  A row's 2 x BK / 8
//      values sit in the 4 threads of a quad: row max by two quad shuffles;
//      row sums stay per thread and are reduced once at the end.  Masks are
//      by index, and only on tiles that cross the diagonal, the window's
//      edge or T; tiles wholly above the diagonal or behind the window are
//      never loaded (the TPU kernel walks them, but a fully masked tile
//      adds exactly nothing there).
//    * P goes to the tensor cores as two bf16 parts, hi = bf16(P) and
//      lo = bf16(P - hi), in registers, where the accumulator layout of
//      Q.K^T is already the A-operand layout of the next product:
//      O += hi.V + lo.V as `wgmma` m64nDPk16 with A from registers and V
//      from shared memory (MN-major, transposed by the descriptor).  P
//      never touches shared memory.  With P rounded once to bf16 (each term
//      moved by up to 2^-9) the output stayed inside its bf16 tolerance, but
//      qwen3-8b's step-0 gradients through 8 layers moved by 2.036e-2
//      against the plain path (tolerance 2e-2); hi + lo keeps about 16 bits
//      of P for half again the tensor-core work of the two products.
//    * No atomics: every output element is written by one thread, the sums
//      run in a fixed order, and the result is the same in every run.
//    Shared memory: Q 16 / 32 / 64 KB, ring 32 / 64 / 64 KB (DP 64 / 128 /
//    256), set above 48 KB with `cudaFuncSetAttribute`.
//
// 2. float32, or bf16 with D % 8 != 0 or a misaligned pointer: the CUDA-core
//    instance `flash_fwd_kernel` (the first version of this kernel).
//    float32 stays off the tensor cores: TF32 keeps about three digits and
//    would miss the 1e-4 check; float32 is used by the checks only.
//    * one block of 256 threads per (b, q head, 64-row q tile); kv tiles of
//      64 rows, staged in shared memory as float32 (rows and columns outside
//      S, T and D as zeros), fully masked tiles skipped;
//    * thread (ty, tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3:
//      their scores against kv rows tx + 16 c and output columns
//      64 c + 4 tx .. + 3; row max and sum by half-warp shuffles; P goes
//      through shared memory (over the K tile) to the P.V product.
// The multiply-adds contract into fma and the sums run in another order than
// the plain version's, so results differ from it in the last bits.
//
// The C entry point returns the cudaError_t of the launch (0 = success); the
// Python wrapper raises on anything else.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// The tensor-core instance (bf16)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;       // q rows per block: two consumer warpgroups
constexpr int TC_THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int TC_STAGES = 2;     // K / V ring depth

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
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

// returns once the phase of parity `parity` of the barrier has completed;
// traps (a launch error, not a hung card) if that takes over 2^33 cycles
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 33)) asm volatile("trap;");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: 128-byte swizzle, start address, leading
// and stride byte offsets (all in bytes here, stored in 16-byte units)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for an A fragment, which a wgmma reads until it completes
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 32, f32) = [d +] a (64 x 16, smem) . b (32 x 16, smem)^T
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}


// d (64 x 64, f32) = [d +] a (64 x 16, smem) . b (64 x 16, smem)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += a (64 x 16, registers) . b (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16, registers) . b (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += a (64 x 16, registers) . b (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64, "the kv tiles are 32 or 64 keys");
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, accumulate);
  else wgmma_ss_n64(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// Shared memory of one block, in bytes from a 1024-byte aligned base: Q as
// DP / 64 column blocks of TC_BQ rows x 128 bytes, then the K ring and the V
// ring (each stage DP / 64 column blocks of BK rows x 128 bytes), then the
// mbarriers.
template <int DP, int BK>
struct TcLayout {
  static constexpr int NB = DP / 64;
  static constexpr int Q_BYTES = TC_BQ * DP * 2;
  static constexpr int TILE_BYTES = BK * DP * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + TC_STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + TC_STAGES * TILE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * TC_STAGES) + 1024;
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

template <int DP, int BK>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int Hq, int Hkv, int S,
                        int T_, int D, float scale, int causal,
                        int window) {
  using L = TcLayout<DP, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  const uint32_t sq = sbase, sk = sbase + L::K_OFF, sv = sbase + L::V_OFF;
  const uint32_t bar_q = sbase + L::BAR_OFF;
  // per stage: K landed, V landed, K slot free again, V slot free again
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_k + 8 * TC_STAGES;
  const uint32_t bar_k_free = bar_v + 8 * TC_STAGES;
  const uint32_t bar_v_free = bar_k_free + 8 * TC_STAGES;

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - (int)blockIdx.x;      // longest walks first
  const int bh = blockIdx.y;                      // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = qt * TC_BQ;

  // kv tiles that hold at least one unmasked key for these rows, walked
  // from the last (the diagonal, which needs the mask) down
  const int q_last = min(q0 + TC_BQ, S) - 1;
  int kv_hi = T_;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (kv_hi + BK - 1) / BK;
  const int n_tiles = max(0, t_end - kv_lo / BK);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_k_free + 8 * s, 256);         // every consumer thread
      mbar_init(bar_v_free + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread of warp 8 --------------------------------
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < L::NB; ++c)
        tma_load_3d(sq + c * TC_BQ * 128, &tm_q, bar_q, c * 64, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % TC_STAGES;
        const uint32_t free_parity = ((it / TC_STAGES) & 1) ^ 1;
        const int kv0 = (t_end - 1 - it) * BK;
        const uint32_t kb = bar_k + 8 * st, vb = bar_v + 8 * st;
        mbar_wait(bar_k_free + 8 * st, free_parity);
        mbar_expect_tx(kb, L::TILE_BYTES);
        for (int c = 0; c < L::NB; ++c)
          tma_load_3d(sk + st * L::TILE_BYTES + c * BK * 128, &tm_k, kb,
                      c * 64, kv0, kvh);
        mbar_wait(bar_v_free + 8 * st, free_parity);
        mbar_expect_tx(vb, L::TILE_BYTES);
        for (int c = 0; c < L::NB; ++c)
          tma_load_3d(sv + st * L::TILE_BYTES + c * BK * 128, &tm_v, vb,
                      c * 64, kv0, kvh);
      }
    }
  } else {
    // ---- consumers -----------------------------------------------------
    const int cw = wg;                            // rows q0 + 64 cw ..
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5, lane = t & 31;
    const int qa = q0 + 64 * cw;                  // this warpgroup's first row
    // this thread's two rows; its columns are 8 n + 2 (lane % 4) + {0, 1}
    const int row0 = qa + 16 * warp + (lane >> 2);
    const int row1 = row0 + 8;
    const int col_l = 2 * (lane & 3);
    const uint32_t q_rows = sq + cw * 64 * 128;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    // running max of scale x scores (natural domain, expf as the plain
    // version), row sums
    float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
    float s[BK / 2];
    uint32_t p[BK / 16][4], pl[BK / 16][4];     // P = hi + lo, both bf16

    // s = Q . K^T of the tile in stage st, DP / 16 steps of 16 columns:
    // column block kk / 4, then 32 bytes per step inside its 128
    const auto issue_qk = [&](int st) {
      const uint32_t k_t = sk + st * L::TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BK>(s,
                     make_desc(q_rows + (kk / 4) * TC_BQ * 128 + off, 16, 1024),
                     make_desc(k_t + (kk / 4) * BK * 128 + off, 16, 1024),
                     kk > 0);
      }
    };
    // acc += P . V of the tile in stage st, BK / 16 steps of 16 kv rows,
    // each as hi . V + lo . V
    const auto issue_pv = [&](int st) {
      const uint32_t v_t = sv + st * L::TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = make_desc(v_t + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs<DP>(acc, p[kk], dv);
        wgmma_rs<DP>(acc, pl[kk], dv);
      }
    };
    // mask by index where a boundary crosses, then the online softmax on
    // the registers (row max over the quad): s becomes P in float32, and
    // the rows' rescale factors come back
    const auto softmax = [&](int it, float& alpha0, float& alpha1) {
      const int kv0 = (t_end - 1 - it) * BK;
      const bool need_mask =
          kv0 + BK > T_ || (causal && kv0 + BK - 1 > qa) ||
          (window > 0 && kv0 <= qa + 63 - window);
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = kv0 + 8 * i + col_l + (e & 1);
            const int r = e < 2 ? row0 : row1;
            if (j >= T_ || (causal && j > r) || (window > 0 && j <= r - window))
              s[4 * i + e] = -INFINITY;
          }
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // scale > 0, so the max of the scaled scores is the scaled max
      const float mn0 = fmaxf(m0, mx0 * scale);
      const float mn1 = fmaxf(m1, mx1 * scale);
      alpha0 = expf(m0 - mn0);
      alpha1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        s[4 * i] = expf(s[4 * i] * scale - mn0);
        s[4 * i + 1] = expf(s[4 * i + 1] * scale - mn0);
        s[4 * i + 2] = expf(s[4 * i + 2] * scale - mn1);
        s[4 * i + 3] = expf(s[4 * i + 3] * scale - mn1);
        sum0 += s[4 * i] + s[4 * i + 1];
        sum1 += s[4 * i + 2] + s[4 * i + 3];
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
    };
    // P as hi + lo, hi = bf16(P) and lo = bf16(P - hi): about 16 bits of
    // P reach the tensor cores.  The accumulator layout of 16 columns of s
    // is the A fragment of a k16 step
    const auto to_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = s[8 * kk + 2 * e], x1 = s[8 * kk + 2 * e + 1];
          const uint32_t hi = pack_bf16(x0, x1);
          p[kk][e] = hi;
          pl[kk][e] = pack_bf16(x0 - __uint_as_float(hi << 16),
                                x1 - __uint_as_float(hi & 0xffff0000u));
        }
    };
    const auto rescale = [&](float alpha0, float alpha1) {
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        acc[4 * i] *= alpha0;
        acc[4 * i + 1] *= alpha0;
        acc[4 * i + 2] *= alpha1;
        acc[4 * i + 3] *= alpha1;
      }
    };

    mbar_wait(bar_q, 0);
    // The softmax of tile it runs while the tensor cores do P.V of tile
    // it - 1.  Per step: issue Q.K^T (it); rescale acc to tile it - 1's
    // max; issue P.V (it - 1); wait for the first, softmax it, wait for the
    // second, round P.  So acc = acc x alpha_{it-1} + P_{it-1} V_{it-1}.
    if (n_tiles > 0) {
      float alpha0, alpha1;
      mbar_wait(bar_k, 0);
      fence_regs(s);
      wgmma_fence();
      issue_qk(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(bar_k_free);
      softmax(0, alpha0, alpha1);
      to_p();
      for (int it = 1; it < n_tiles; ++it) {
        const int st = it % TC_STAGES, prev = (it - 1) % TC_STAGES;
        mbar_wait(bar_k + 8 * st, (it / TC_STAGES) & 1);
        fence_regs(s);
        wgmma_fence();
        issue_qk(st);
        wgmma_commit();
        fence_regs(s);
        rescale(alpha0, alpha1);
        mbar_wait(bar_v + 8 * prev, ((it - 1) / TC_STAGES) & 1);
        fence_regs(acc);
        fence_regs(p);
        fence_regs(pl);
        wgmma_fence();
        issue_pv(prev);
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();                       // Q.K^T (it) is done
        fence_regs(s);
        mbar_arrive(bar_k_free + 8 * st);
        softmax(it, alpha0, alpha1);
        wgmma_wait<0>();                       // P.V (it - 1) is done
        fence_regs(acc);
        fence_regs(p);
        fence_regs(pl);
        mbar_arrive(bar_v_free + 8 * prev);
        to_p();
      }
      const int last = (n_tiles - 1) % TC_STAGES;
      rescale(alpha0, alpha1);
      mbar_wait(bar_v + 8 * last, ((n_tiles - 1) / TC_STAGES) & 1);
      fence_regs(acc);
      fence_regs(p);
      fence_regs(pl);
      wgmma_fence();
      issue_pv(last);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar_v_free + 8 * last);
    }

    // finalize: o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30))
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* o0 = o + ((size_t)bh * S + row0) * D;
    __nv_bfloat16* o1 = o + ((size_t)bh * S + row1) * D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + col_l;
      if (col < D) {
        if (row0 < S)
          *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
              __floats2bfloat162_rn(acc[4 * i] / d0, acc[4 * i + 1] / d0);
        if (row1 < S)
          *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
              __floats2bfloat162_rn(acc[4 * i + 2] / d1, acc[4 * i + 3] / d1);
      }
    }
    if ((lane & 3) == 0) {
      if (row0 < S) lse[(size_t)bh * S + row0] = m0 + logf(d0);
      if (row1 < S) lse[(size_t)bh * S + row1] = m1 + logf(d1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (heads, rows, D) bf16 tensor as TMA boxes of (1, box_rows, 64)
bool make_map(CUtensorMap* map, const void* ptr, int heads, int rows, int D,
              int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int BK>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Hq, int Hkv, int S, int T_, int D,
              float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * Hq, S, D, TC_BQ) ||
      !make_map(&tk, k, B * Hkv, T_, D, BK) ||
      !make_map(&tv, v, B * Hkv, T_, D, BK))
    return (int)cudaErrorInvalidValue;
  const int smem = TcLayout<DP, BK>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + TC_BQ - 1) / TC_BQ, B * Hq);
  flash_fwd_tc_kernel<DP, BK><<<grid, TC_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, S, T_, D,
      scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The CUDA-core instance (float32; bf16 that TMA cannot take)
// ---------------------------------------------------------------------------


constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // kv rows per tile
constexpr int NTHREADS = 256;    // 16 x 16
constexpr int PSTR = BK + 4;     // row stride of P in shared memory
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DMAX>
struct Layout {
  static constexpr int KSTR = DMAX + 4;                 // padded K row stride
  static constexpr int Q_FLOATS = BQ * DMAX;
  static constexpr int K_FLOATS = BK * KSTR;            // also holds P
  static constexpr int V_FLOATS = BK * DMAX;
  static constexpr size_t BYTES =
      sizeof(float) * (size_t)(Q_FLOATS + K_FLOATS + V_FLOATS);
  static_assert(BQ * PSTR <= K_FLOATS, "P must fit over the K tile");
};

// rows [row0, row0 + 64) of a (rows, D) matrix into shared memory as float32
// with row stride `stride`; rows >= n_rows and columns >= D become zeros
template <typename Tin, int DMAX>
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const Tin* __restrict__ src, int row0,
                                      int n_rows, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 64 / (NTHREADS / 32); ++i) {
    const int r = warp + i * (NTHREADS / 32);
    const bool row_ok = row0 + r < n_rows;
    const Tin* row = src + (size_t)(row0 + r) * D;
#pragma unroll
    for (int jd = 0; jd < DMAX / 32; ++jd) {
      const int d = lane + 32 * jd;
      dst[r * stride + d] = (row_ok && d < D) ? to_f32(row[d]) : 0.f;
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NTHREADS, DMAX <= 128 ? 2 : 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Hq, int Hkv, int S, int T_,
                     int D, float scale, int causal, int window) {
  using L = Layout<DMAX>;
  constexpr int NC = DMAX / 64;          // 4-column groups a thread owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + L::Q_FLOATS;
  float* Ps = Ks;                        // P reuses the K tile
  float* Vs = Ks + L::K_FLOATS;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - (int)blockIdx.x;      // longest walks first
  const int bh = blockIdx.y;                      // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;

  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * T_ * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * T_ * D;

  stage<T, DMAX>(Qs, DMAX, qb, q0, S, D);

  // kv tiles that hold at least one unmasked key for these rows
  const int q_last = min(q0 + BQ, S) - 1;
  int kv_hi = T_;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int t_begin = kv_lo / BK;
  const int t_end = (kv_hi + BK - 1) / BK;
  const int Dp = (D + 3) & ~3;

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int kv0 = t * BK;
    __syncthreads();                     // the previous P.V is done
    stage<T, DMAX>(Ks, L::KSTR, kb, kv0, T_, D);
    stage<T, DMAX>(Vs, DMAX, vb, kv0, T_, D);
    __syncthreads();

    // s = q . k for rows 4 ty + r and kv rows tx + 16 c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < Dp; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + r) * DMAX + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(
            &Ks[(tx + 16 * c) * L::KSTR + d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] += qv[r].x * kv[c].x;
          s[r][c] += qv[r].y * kv[c].y;
          s[r][c] += qv[r].z * kv[c].z;
          s[r][c] += qv[r].w * kv[c].w;
        }
    }

    // mask, online softmax over the tile
    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = kv0 + tx + 16 * c;
        ok[c] = kj < T_;
        if (causal) ok[c] = ok[c] && kj <= qi;
        if (window > 0) ok[c] = ok[c] && kj > qi - window;
        s[r][c] = ok[c] ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[r][c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += p[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[r][c].x *= alpha;
        acc[r][c].y *= alpha;
        acc[r][c].z *= alpha;
        acc[r][c].w *= alpha;
      }
    }

    __syncthreads();                     // every thread is done with K
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty * 4 + r) * PSTR + tx + 16 * c] = p[r][c];
    __syncthreads();

    // acc += P . V over the tile's 64 kv rows
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + r) * PSTR + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(j + jj) * DMAX + c * 64 + tx * 4]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pj = jj == 0 ? pv[r].x
                             : jj == 1 ? pv[r].y
                             : jj == 2 ? pv[r].z
                                       : pv[r].w;
            acc[r][c].x += pj * vv.x;
            acc[r][c].y += pj * vv.y;
            acc[r][c].z += pj * vv.z;
            acc[r][c].w += pj * vv.w;
          }
        }
      }
    }
  }

  // finalize: o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30))
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * S + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 64 + tx * 4;
      const float vals[4] = {acc[r][c].x, acc[r][c].y, acc[r][c].z,
                             acc[r][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < D) orow[col + e] = from_f32<T>(vals[e] / denom);
    }
    if (tx == 0) lse[(size_t)bh * S + qi] = m[r] + logf(denom);
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int S, int T_, int D, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = Layout<DMAX>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<T, DMAX><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, S, T_, D,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int Hq, int Hkv, int S, int T_, int D, float scale,
             int causal, int window, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, Hq, Hkv, S, T_, D, scale, causal,
                         window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, Hq, Hkv, S, T_, D, scale,
                          causal, window, stream);
  if (D <= 256)
    return launch<T, 256>(q, k, v, o, lse, B, Hq, Hkv, S, T_, D, scale,
                          causal, window, stream);
  return (int)cudaErrorInvalidValue;
}

// the tensor-core instance takes bf16 rows of 16-byte multiples from
// 16-byte aligned bases (what TMA needs)
bool takes_tensor_cores(int dtype, int D, const void* q, const void* k,
                        const void* v) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return dtype == 1 && D % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
}

}  // namespace

extern "C" {

// 1 when a call with this dtype (0 = float32, 1 = bfloat16) and head dim
// runs on the tensor cores, given 16-byte aligned inputs; else 0.
int flash_attention_tensor_cores(int dtype, int D) {
  return dtype == 1 && D % 8 == 0 && D >= 1 && D <= 256;
}

// Dynamic shared memory of one block of the instance such a call takes
// (0 if D > 256).
long long flash_attention_smem_bytes(int dtype, int D) {
  if (D < 1 || D > 256) return 0;
  if (flash_attention_tensor_cores(dtype, D))
    return D <= 64 ? TcLayout<64, 64>::BYTES
           : D <= 128 ? TcLayout<128, 64>::BYTES
                      : TcLayout<256, 32>::BYTES;
  return D <= 64 ? (long long)Layout<64>::BYTES
         : D <= 128 ? (long long)Layout<128>::BYTES
                    : (long long)Layout<256>::BYTES;
}

// q, o: (B, Hq, S, D); k, v: (B, Hkv, T, D), all contiguous, of `dtype`
// (0 = float32, 1 = bfloat16); lse: (B, Hq, S) float32.  Hq % Hkv == 0,
// 1 <= D <= 256, S, T >= 1.  causal != 0 masks j > i; window > 0 masks
// j <= i - window.  Returns the cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Hq, int Hkv, int S, int T, int D,
                        float scale, int causal, int window, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || S < 1 || T < 1 || D < 1 ||
      D > 256 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  float* lse_f = static_cast<float*>(lse);
  if (takes_tensor_cores(dtype, D, q, k, v)) {
    if (D <= 64)
      return launch_tc<64, 64>(q, k, v, o, lse_f, B, Hq, Hkv, S, T, D, scale,
                                causal, window, st);
    if (D <= 128)
      return launch_tc<128, 64>(q, k, v, o, lse_f, B, Hq, Hkv, S, T, D,
                                scale, causal, window, st);
    return launch_tc<256, 32>(q, k, v, o, lse_f, B, Hq, Hkv, S, T, D, scale,
                              causal, window, st);
  }
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse_f, B, Hq, Hkv, S, T, D, scale,
                           causal, window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, lse_f, B, Hq, Hkv, S, T, D,
                                   scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
