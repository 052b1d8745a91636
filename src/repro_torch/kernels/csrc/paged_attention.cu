// Paged single-token decode attention for Hopper (sm_90a), split across
// blocks.
//
// Replaces the Pallas TPU kernel `paged_attention_fwd`
// (src/repro/kernels/paged_attention.py:201, body `_paged_decode_kernel`
// :139).  It computes the same function: for each serving slot, one query
// token attends over a paged K/V pool read through the slot's block
// table, with softmax in float32.  Mask: block >= 0, pos >= 0,
// pos <= q_pos, and pos > q_pos - window for sliding-window layers.
// Options: tanh softcap, and a second score contraction
// q_extra . k_extra^T (the MLA rope term).  Finalize: acc / max(l, 1e-30).
//
// Bound on this card: the bytes of the K/V pages it reads (each allocated
// page read once per kv head, the G query heads of that kv head share the
// read), over the 3.35 TB/s of HBM.  The arithmetic is 2 flops per byte
// of K/V at G = 4, far below the ridge point, so the bytes set the floor.
// At decode the G query rows are 4 or 8, too few for the tensor cores:
// the CUDA cores serve, and the design is about keeping many page loads
// in flight.
//
// Design (split-K):
// * grid (B * Hkv, n_splits).  Split s of (slot, kv head) covers the
//   fixed table columns [s * PAGES_PER_SPLIT, (s + 1) * PAGES_PER_SPLIT);
//   columns past n_cols count as -1.  PAGES_PER_SPLIT is a constant of
//   the kernel, never derived from n_cols, B or the SM count, so
//   appending -1 columns never moves a split boundary;
// * a block of 128 threads issues all its pages' K, V (and K_extra) rows
//   at once as 16-byte cp.async copies into shared memory in the pool's
//   dtype (the `vec` instance; odd head dims or unaligned pools load
//   element by element), reads the positions and the scaled q meanwhile,
//   and waits once;
// * scores: a thread per (row, half of the query heads), its own dot
//   products over the head dims (q read by a whole warp at once, K in
//   XOR-swizzled 16-byte units: no bank conflicts), bf16 -> f32 in
//   registers, softcap and mask; the split's max m_s, p = exp(s - m_s) and
//   l_s = sum p by 128 / GB lanes per head; then a thread per column of V
//   sums p V for all heads over the split's rows in row order.  G is
//   computed as a bucket GB = 4, 8 or 16 (q rows past G are zeros), so the
//   inner loops carry no per-head branch.  A masked row has p = 0; a -1
//   column's page is never loaded or read;
// * the block writes its partial (m_s, l_s, acc_s) to float32 scratch.  A
//   split with no table column exits at once and takes no part in the
//   merge;
// * the last live split of each (slot, kv head) to finish (found by an
//   acq_rel atomic counter of the live splits, which that block resets to
//   0 for the next launch; warp 0 of every live block counted and listed
//   them from the table while its copies were in flight) merges the
//   partials in split order 0, 1, 2, ...: M = max m_s,
//   l = sum l_s e^(m_s - M), o = sum acc_s e^(m_s - M) / max(l, 1e-30).
//   The partials come back in one round of loads (acc by cp.async into the
//   free K/V region, m and l beside), a running max per head takes them
//   32 splits at a time (an online merge: with up to 128 columns, one
//   chunk, it is the two-pass form exactly), and each thread sums groups
//   of 4 output elements from shared memory.  A live split whose rows are
//   all masked has l_s = 0 and acc_s = 0: it adds exactly 0.  So the
//   result does not depend on which block finishes first, and -1 columns
//   are neutral bit for bit;
// * an idle slot (q_pos < 0) writes exact zeros from split 0 and touches
//   no counter.
// expf / tanhf / division stay IEEE-accurate: no --use_fast_math.  The
// counters are shared by the launches on one device and stream, which
// run one after another.
//
// gemma3-12b's decode (G = 2 query heads over each of 8 kv heads of D =
// Dv = 256, 16-row pages, bf16) takes the wide-head instance
// `paged_wide_kernel`, built for that shape alone: through the instance
// above it ran as GB = 4 (half the q rows zeros), copied the split's 64 KB
// of K and V, waited, and only then computed, one thread scoring a whole
// 512-byte K row for half the heads; 58-60 / 113-114 us at the ring /
// table shape against SDPA's 39 / 63 (scripts/d256_times.py on an H100
// 80GB HBM3 at 700 W).  Its bound is the bytes of K and V, as above: at 2
// flops a byte for G = 2 the CUDA cores idle at any rate HBM can feed.
// * The split kernel's splits, partial format, prologue (idle slots, -1
//   columns), counter and merge, as the shared functions split_blocks,
//   split_idle, count_live, last_split and merge_splits, on a grid
//   (Hkv x n_splits, B) whose blocks of one slot run together, so most
//   merges overlap other slots' loads; the exact G (q rows held in
//   registers as f32, no padded rows).
// * A warp per K row: warp w takes rows w, w + 4, w + 8, w + 12 of each of
//   the split's pages, lane u the row's 16-byte unit u (one unit a lane),
//   dotted with the G query rows; the 4 x G partial sums are summed over
//   the warp by a transposing xor fold (17 shuffles where a butterfly per
//   value takes 40).
// * A ring of WIDE_STAGES = 2 pages a warp: lane u copies its units of
//   the next page by cp.async.cg while the page at hand is scored; each
//   lane reads back only what it copied.  33.6 KB of shared memory a
//   block lets 6 blocks share an SM (the 4-page staging of a first
//   version, 66 KB, allowed 3, and its blocks idled HBM while computing).
// * An online softmax per warp over its rows: lane k computes p of (row
//   k / G, head k % G) and shuffles hand every p to every lane; l and acc
//   rescale only when a head's max moved (alpha = 1 exactly otherwise).
//   Then P.V with lane u owning V columns 8 u .. 8 u + 7 of every head.
//   Masked rows add nothing; -1 columns' pages are never copied.
// * The 4 warps' (m, l, acc) combine in warp order into the split's
//   partial; the last live split merges the partials as above, 16 staged
//   a round over the ring.
// So -1 columns stay neutral bit for bit, idle slots write exact zeros,
// and float32 and every other shape keep the GB instance above.
// At gemma3's shapes it reads 34.85-34.86 us a full ring and 60.02-60.06
// a full table (the GB = 4 instance 58.96-59.19 and 112.98-113.01; SDPA
// on gathered K/V 38.47-39.34 and 62.68-62.76; bounds 20.08 and 40.12;
// scripts/d256_times.py on an H100 80GB HBM3 at 700 W).  Without the
// arithmetic the copies alone read 31.68 / 58.09 us, and the merge adds
// 4.6 / 8.3 us at the launch's tail (scripts/d256_times.py --ablate): the
// 512-byte rows of a page, 4 KB apart, do not stream at HBM's rate.
//
// MLA's absorbed decode (DeepSeek-V3: Hkv = 1, G = 128 query heads over one
// latent head, D = Dv = kv_lora_rank = 512, De = qk_rope_dim = 64, the
// latent pool passed as both K and V) is another shape of the same
// function.  Per cached position a slot reads 1152 bytes (bf16 latent +
// rope) and does 2 x 128 x 576 + 2 x 128 x 512 = 278.5 K flops: about 240
// flops a byte, above the ridge of the CUDA cores (67 TFLOP/s f32 over 3.35
// TB/s, about 20 flops a byte) and below that of the tensor cores (989
// TFLOP/s, about 295).  So the CUDA cores would set the floor (about 4.2 ns
// a position) and on the tensor cores the bytes set it again (about 0.3
// ns).  The design above is compute-bound here: it stages G x (D + De +
// Dv) query floats and R rows of K and V a block (at MLA's shape the query
// alone is 295 KB, over the 227 KB a block may use), and every thread
// loops over all G heads.  Two head-tiled instances take such shapes:
// * `paged_mla_kernel`, the MLA instance, replacing for this shape what
//   the TPU kernel `paged_attention_fwd` (src/repro/kernels/paged_attention.py
//   :201) computes with its second contraction: DeepSeek-V3's widths (bf16,
//   K is V, 16-row pages, D = Dv = 512, De <= 64, G a multiple of 64).
//   Bound at the served decode shape (B = 8, 2-40 pages a slot; chip_smoke
//   phase 10b): the 5.80 MB it must move, 1.73 us at 3.35 TB/s; its 0.86
//   GFLOP take 0.87 us on the tensor cores.  What held the mma.sync
//   instance it replaces (22.19 us of split kernel + 7.37 of merge there)
//   and what this design does about each:
//   1. Fixed 4-page splits that each staged the whole 74 KB q tile: a split
//      is now MLA_PAGES_PER_SPLIT = 8 table columns (boundaries still a
//      function of the column index alone), q is staged once per 8 pages,
//      and a slot of 40 pages is 5 blocks a head tile, not 10.  8 is the
//      most one block can hold (q 72 KB + 8 pages of 18 KB); with 4 a split
//      the partials double, with 16 one block's serial work does (PERF.md
//      has the lengths' timings from a first build).
//   2. A serial chain in one 150 KB block an SM, nothing in flight during
//      compute: the block is a producer warpgroup (its registers handed to
//      the consumers by `setmaxnreg`) and two consumer warpgroups.  The
//      producer issues q (9 TMA boxes of 64 heads x 64 columns) before it
//      has the table, then its four warps' lane 0 copy two pages each (a
//      page: 8 boxes of 16 latent rows x 64 columns and one of the rope
//      rows, on the page slot's mbarrier), so the split's 8 slots are all
//      in flight at once (four warps issue the 72 boxes faster than one),
//      and reads the positions for the row masks meanwhile.  Each consumer
//      warpgroup starts on its four pages as soon as they land; the
//      exponentials of the split's second half run while the first half's
//      P.V products are on the tensor cores.  -1 columns are never read;
//      their slots are zero-filled so the P.V steps need no branch.
//   3. f32 partials larger than the input: with 8-page splits the scratch
//      holds about half as many partials (at the served shape 56 of 131.6
//      KB, 7.4 MB, against 102 with 4-page splits, 13.4 MB).  A block
//      stores its partial by TMA from shared memory; the store takes 3 us,
//      bound by what one SM writes (a half store takes half).
//      `paged_merge_kernel`, a block per query head, merges them in split
//      order, each chunk's (m_s, l_s) read in one round by a warp (a merge
//      in the last split's block, which reads the others' partials through
//      one SM, took 144 us in a first build of the mma.sync instance).
//   4. No Hopper tensor-core path: S = [q | q_rope] . [K | K_rope]^T runs as
//      36 k16 steps of wgmma m64n64k16 with both operands in shared memory
//      (128-byte swizzle, the layout TMA writes); warpgroup w scores the
//      split's pages w, w + 2, w + 4, w + 6 (the two warpgroups' row maxima
//      meet through shared memory).  Scale, softcap, mask and the split's
//      softmax (one max a split, IEEE expf) run on the score registers; P
//      goes to bf16 (moving the output by about 2^-9 of its scale) into
//      shared memory over q, and acc += P . V is 8 k16 steps of wgmma
//      m64n256k16, A = P and B = the pages' latent rows read MN-major (no
//      transposed copy), both from shared memory.  The 64 x 512 f32
//      accumulator is split by columns: each warpgroup holds 64 x 256, 128
//      registers a thread (224 after `setmaxnreg`, 0 spilled).
//   Shared memory: q 72 KB, the 8 page slots 144 KB, about 218 KB.  Where a
//   block's time goes, phase by phase: `scripts/mla_ablate.py --timeline`.
// * `paged_tiled_kernel`, on the CUDA cores (float32, which the tensor
//   cores would round, and shapes the MLA instance does not take): 16 heads
//   a block, q staged as f32, a thread per row and 8 heads for the scores,
//   per 4 columns of V and all 16 heads for P.V, rows in order; K and V
//   staged once when they are one tensor; the split kernel's PAGES_PER_SPLIT
//   columns a split and its one max a split;
// * both write each live split's partial per head tile (16 x (Dv + 2) or
//   64 x (Dv + 2) floats) and leave the merge to `paged_merge_kernel`, a
//   block per query head, which reads them in split order as the last block
//   above does.
// expf stays IEEE-accurate here too.  Per head, the splits' partials (m_s,
// l_s, acc_s) and the ordered merge are those above (the MLA instance's
// m_s and l_s come from its page-by-page softmax), so -1 columns stay
// neutral bit for bit and idle slots output exact zeros.
//
// The C entry points return the cudaError_t of the launch (0 = success);
// the Python wrapper raises on anything else.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int PAGES_PER_SPLIT = 4;
constexpr int MAX_GROUP = 16;
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int MERGE_CHUNK = 32;  // splits the merge takes at once (a warp)
// partials the merge's shared memory holds at least: the 10 live splits of
// a 40-page table in one round, with 4 blocks of G = 8 still fitting an SM
constexpr int MERGE_STAGE = 10;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// the group bucket of an instance: G query heads per kv head are computed
// as GB = 4, 8 or 16 (q rows past G are zeros), so the inner loops carry no
// per-head branch
__host__ __device__ inline int group_bucket(int G) {
  return G <= 4 ? 4 : G <= 8 ? 8 : 16;
}

// floats of one split's partial (acc[G][Dv], m[G], l[G]) rounded up to 16
// bytes
__host__ __device__ inline size_t part_floats(int G, int Dv) {
  return ((size_t)G * (Dv + 2) + 3) & ~size_t(3);
}

// Byte offsets of the regions of one block's dynamic shared memory.  q and
// the scores (then probabilities) have GB rows / columns: the scores are
// kept [row][GB], so the P.V loop reads a row's values as float4s.
struct Smem {
  size_t qs, qes, ks, vs, kes, sc, ok, ml, wt, lst, total;
  __host__ __device__ Smem(int G, int D, int Dv, int De, int page, int isz) {
    const size_t R = (size_t)PAGES_PER_SPLIT * page;
    const size_t GP = group_bucket(G);
    qs = 0;                                        // GB x D, pool dtype, unscaled
    qes = round16(qs + isz * GP * D);                   // GB x De f32, scaled
    ks = round16(qes + sizeof(float) * GP * De);        // R x D, pool dtype
    // (the P.V halves' exchange, (Dv + 1) / 2 x GB x 2 f32, reuses K)
    const size_t k_bytes = R * D * isz, x_bytes = (Dv + 1) / 2 * GP * 8;
    vs = round16(ks + (k_bytes > x_bytes ? k_bytes : x_bytes));  // R x Dv
    kes = round16(vs + R * Dv * isz);                   // R x De
    // R x GB f32; the merge stages partials (G x Dv f32 each) over K/V
    sc = round16(kes + R * De * isz);
    const size_t stage = sizeof(float) * MERGE_STAGE * G * Dv;
    if (sc < ks + stage) sc = round16(ks + stage);
    // (the merge keeps 2 MAX_GROUP floats there)
    ok = sc + sizeof(float) * (R * GP > 2 * MAX_GROUP ? R * GP : 2 * MAX_GROUP);
    ml = ok + sizeof(int) * R;                          // m, l: 2 G f32; flags
    wt = ml + sizeof(float) * 2 * G + 2 * sizeof(int);  // merge: m, l of a chunk
    lst = wt + sizeof(float) * 2 * MERGE_CHUNK * G;     // its live splits
    total = lst + sizeof(int) * 2 * MERGE_CHUNK;
  }
};

// Where 16-byte unit u of K row r sits in shared memory: with SWZ it is
// XORed with r mod 8 inside its group of 8 units, so the 8 threads of a
// 16-byte load phase, reading one unit of 8 consecutive rows, touch 8
// different bank groups.
template <bool SWZ>
__device__ __forceinline__ int k_unit(int u, int r) {
  return SWZ ? (u ^ (r & 7)) : u;
}

// Rows of this split's pages: row r of the split is row r % page of table
// column split * PAGES_PER_SPLIT + r / page.  Copies K, V and K_extra rows
// of kv head h into shared memory in load units of 16 bytes (VEC, by
// cp.async) or of one element, a warp per row and its lanes over the
// row's units.
template <typename T, bool VEC, bool SWZ>
__device__ __forceinline__ void load_rows(
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ ke, T* ks, T* vs, T* kes, const int* blk, int page,
    int Hkv, int h, int D, int Dv, int De) {
  constexpr int E = VEC ? 16 / (int)sizeof(T) : 1;  // elements per unit
  const int uk = D / E, uv = Dv / E, ue = De / E, U = uk + uv + ue;
  const int R = PAGES_PER_SPLIT * page;
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < R; r += nwarps) {
    const int b = blk[r / page];
    if (b < 0) continue;                      // -1 column: never read
    const size_t row = ((size_t)b * page + r % page) * Hkv + h;
    for (int u = lane; u < U; u += 32) {
      const T* src;
      T* dst;
      int w = u, at;
      if (w < uk) {
        src = k + row * D, dst = ks + (size_t)r * D, at = k_unit<SWZ>(w, r);
      } else if (w < uk + uv) {
        w -= uk, src = v + row * Dv, dst = vs + (size_t)r * Dv, at = w;
      } else {
        w -= uk + uv, src = ke + row * De, dst = kes + (size_t)r * De, at = w;
      }
      if (VEC)
        cp_async16(dst + at * E, src + w * E);
      else
        dst[at] = src[w];
    }
  }
}

// the E elements of a 16-byte unit as floats (a bf16 is the upper half of
// its float32: exact, by shifts, and the unit stays in registers)
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(x[i] << 16);
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x), f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z), f[3] = __uint_as_float(w.w);
}

// whether split s of a table row, of PPS columns a split, holds a column
// (block ids outside the pool count as -1, as in the kernel)
template <int PPS = PAGES_PER_SPLIT>
__device__ __forceinline__ bool split_live(const int32_t* row, int n_cols,
                                           int num_blocks, int s) {
  bool live = false;
#pragma unroll
  for (int j = 0; j < PPS; ++j) {
    const int c = s * PPS + j;
    if (c < n_cols) {
      const int x = row[c];
      live = live || (x >= 0 && x < num_blocks);
    }
  }
  return live;
}

// By warp 0: the live splits of chunk [s0, s0 + 32) of a table row, in
// split order, into `lst`; returns their number (on warp 0's lanes)
template <int PPS = PAGES_PER_SPLIT>
__device__ __forceinline__ int list_live(const int32_t* row, int n_cols,
                                         int num_blocks, int s0, int* lst) {
  const int lane = threadIdx.x & 31;
  const int n_splits = (n_cols + PPS - 1) / PPS;
  const int s = s0 + lane;
  const bool live =
      s < n_splits && split_live<PPS>(row, n_cols, num_blocks, s);
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (live) lst[__popc(mask & ((1u << lane) - 1))] = s;
  return __popc(mask);
}

// The blocks of split `split`'s columns of a table row (-1 for a -1
// column, one past the row or outside the pool); whether any is live
__device__ __forceinline__ bool split_blocks(const int32_t* trow, int n_cols,
                                             int num_blocks, int split,
                                             int (&blk)[PAGES_PER_SPLIT]) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < PAGES_PER_SPLIT; ++j) {
    const int c = split * PAGES_PER_SPLIT + j;
    const int x = c < n_cols ? trow[c] : -1;
    blk[j] = (x < 0 || x >= num_blocks) ? -1 : x;
    any = any || blk[j] >= 0;
  }
  return any;
}

// Whether a split's block has nothing to score, once it has written what
// it owes: an idle slot (q_pos < 0) masks every key, and its split 0
// writes exact zeros; a split with no live column adds nothing and takes
// no part in the merge, and a row with no live column at all outputs exact
// zeros (0 / 1e-30) from its split 0.  o: the slot's n_out = G x Dv outputs
template <typename T>
__device__ __forceinline__ bool split_idle(int qp, bool any, int split,
                                           int n_splits, const int32_t* trow,
                                           int n_cols, int num_blocks, T* o,
                                           int n_out, int* lst, int* flag) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (qp < 0) {
    if (split == 0)
      for (int i = tid; i < n_out; i += blockDim.x) o[i] = from_f32<T>(0.f);
    return true;
  }
  if (!any) {
    if (split != 0) return true;
    if (warp == 0) {
      int n = 0;
      for (int s0 = 0; s0 < n_splits; s0 += MERGE_CHUNK)
        n += list_live(trow, n_cols, num_blocks, s0, lst);
      if (lane == 0) flag[0] = n;
    }
    __syncthreads();
    if (flag[0] == 0)
      for (int i = tid; i < n_out; i += blockDim.x) o[i] = from_f32<T>(0.f);
    return true;
  }
  return false;
}

// By warp 0, while the block's copies are in flight: the number of live
// splits of the row into flag[0] (what the counter counts up to), chunk
// 0's list into lst and its count into flag[1] (the merge's first chunk)
__device__ __forceinline__ void count_live(const int32_t* trow, int n_cols,
                                           int num_blocks, int n_splits,
                                           int* lst, int* flag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    int n = list_live(trow, n_cols, num_blocks, 0, lst);
    const int first = n;
    for (int s0 = MERGE_CHUNK; s0 < n_splits; s0 += MERGE_CHUNK)
      n += list_live(trow, n_cols, num_blocks, s0, lst + MERGE_CHUNK);
    if (lane == 0) {
      flag[0] = n;
      flag[1] = first;
    }
  }
}

// Whether this block is the last of the row's live splits to finish: the
// one that merges the partials.  The block's stores are ordered before
// thread 0's counter update by the barrier, and that update releases them
// to the device and acquires the other blocks' (one acq_rel atomic, no
// fence in every thread)
__device__ __forceinline__ bool last_split(int* counter, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    flag[0] = prev == flag[0] - 1;
  }
  __syncthreads();
  return flag[0];
}

// The merge, by the last split's block, into the slot's G x Dv outputs o.
// Chunks of MERGE_CHUNK splits, in order; per chunk one round of loads:
// warp 0 lists its live splits in split order (chunk 0's list is kept
// from count_live), their acc go to shared memory (`stage`, free by now)
// by cp.async, stage_n at a time, and their (m_s, l_s) beside them (cm,
// cl: MERGE_CHUNK x G floats).  Then the running max of each query head
// (ms) takes the chunk's m_s (rescaling what was summed with alpha =
// e^(M_old - M), m_al; the new max in mnew), the weights are e^(m_s - M),
// l (ls) adds l_s x weight in split order, and each thread adds the
// weighted acc of its K8 output elements (a pass) in split order.  A live split
// with l_s = 0 (every row masked) has acc_s = 0: it adds exactly 0, as in
// the plain mirror, which skips it.  With one chunk this is the two-pass
// merge M = max m_s, sum e^(m_s - M) (...) exactly.  pb: the row's
// partials; ends by resetting the row's counter.
template <int K8, typename T>
__device__ __forceinline__ void merge_splits(
    const float* pb, size_t part_stride, int G, int Dv, int n_splits,
    const int32_t* trow, int n_cols, int num_blocks, int* lst, int* flag,
    float* stage, int stage_n, float* cm, float* cl, float* ms, float* ls,
    float* m_al, float* mnew, T* o, int* counter) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int PM = G * Dv, PL = G * Dv + G;              // offsets of m and l
  const bool vec_part = PM % 4 == 0;
  const int units = vec_part ? PM / 4 : PM;
  const int n_chunks = (n_splits + MERGE_CHUNK - 1) / MERGE_CHUNK;
  const int n_first = flag[1];                 // live splits of chunk 0
  for (int i0 = 0; i0 < G * Dv; i0 += K8 * kThreads) {
    float a[K8];
    int gk[K8];
#pragma unroll
    for (int kk = 0; kk < K8; ++kk) {
      const int i = i0 + kk * kThreads + tid;
      a[kk] = 0.f;
      gk[kk] = i < G * Dv ? i / Dv : -1;
    }
    __syncthreads();
    if (tid < G) {
      ms[tid] = kNegInf;
      if (i0 == 0) ls[tid] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int* l_ = c > 0 ? lst + MERGE_CHUNK : lst;
      if (c > 0) {
        __syncthreads();
        if (warp == 0) {
          const int n = list_live(trow, n_cols, num_blocks, c * MERGE_CHUNK,
                                  lst + MERGE_CHUNK);
          if (lane == 0) flag[1] = n;
        }
      }
      __syncthreads();
      const int n = c > 0 ? flag[1] : n_first;
      for (int j0 = 0; j0 < n; j0 += stage_n) {
        const int m = min(stage_n, n - j0);
        if (j0 > 0) __syncthreads();
        for (int j = 0; j < m; ++j) {
          const float* src = pb + (size_t)l_[j0 + j] * part_stride;
          float* dst = stage + (size_t)j * PM;
          for (int u = tid; u < units; u += kThreads) {
            if (vec_part)
              cp_async16(dst + 4 * u, src + 4 * u);
            else
              cp_async4(dst + u, src + u);
          }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        if (j0 == 0)
          for (int x = tid; x < n * G; x += kThreads) {
            const float* ps = pb + (size_t)l_[x / G] * part_stride;
            cm[x] = __ldcg(ps + PM + x % G);
            cl[x] = __ldcg(ps + PL + x % G);
          }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        if (j0 == 0) {
          if (tid < G) {
            float M = ms[tid];
            for (int j = 0; j < n; ++j) M = fmaxf(M, cm[j * G + tid]);
            mnew[tid] = M;
            m_al[tid] = expf(ms[tid] - M);
          }
          __syncthreads();
          for (int x = tid; x < n * G; x += kThreads)
            cm[x] = expf(cm[x] - mnew[x % G]);
          __syncthreads();
          if (tid < G) {
            float l = ls[tid] * m_al[tid];
            for (int j = 0; j < n; ++j) l += cl[j * G + tid] * cm[j * G + tid];
            if (i0 == 0) ls[tid] = l;
            ms[tid] = mnew[tid];
          }
#pragma unroll
          for (int kk = 0; kk < K8; ++kk)
            a[kk] *= gk[kk] >= 0 ? m_al[gk[kk]] : 0.f;
        }
        for (int j = 0; j < m; ++j) {
#pragma unroll
          for (int kk = 0; kk < K8; ++kk) {
            const bool v = gk[kk] >= 0;
            const float w = v ? cm[(j0 + j) * G + gk[kk]] : 0.f;
            const float x =
                v ? stage[(size_t)j * PM + i0 + kk * kThreads + tid] : 0.f;
            a[kk] += x * w;
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < K8; ++kk)
      if (gk[kk] >= 0)
        o[i0 + kk * kThreads + tid] =
            from_f32<T>(a[kk] / fmaxf(ls[gk[kk]], 1e-30f));
  }
  if (tid == 0) *counter = 0;
}

template <typename T, bool VEC, bool SWZ, int GB>
__global__ void __launch_bounds__(kThreads, 4) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ table, const int32_t* __restrict__ q_pos,
    const T* __restrict__ q_extra, const T* __restrict__ k_extra,
    T* __restrict__ out, float* __restrict__ part, int* __restrict__ counter,
    int Hkv, int G, int D, int Dv, int De, int page, int n_cols,
    int num_blocks, float scale, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(G, D, Dv, De, page, (int)sizeof(T));
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  float* qes = reinterpret_cast<float*>(smem + L.qes);
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = reinterpret_cast<T*>(smem + L.vs);
  T* kes = reinterpret_cast<T*>(smem + L.kes);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  int* ok = reinterpret_cast<int*>(smem + L.ok);
  float* ms = reinterpret_cast<float*>(smem + L.ml);
  float* ls = ms + G;
  int* flag = reinterpret_cast<int*>(ls + G);  // [0] count / last, [1] chunk
  float* cm = reinterpret_cast<float*>(smem + L.wt);   // [chunk][G]: m_s
  float* cl = cm + MERGE_CHUNK * G;                    // l_s, then weights
  int* lst = reinterpret_cast<int*>(smem + L.lst);

  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int Hq = Hkv * G;
  constexpr int GP = GB;
  const int R = PAGES_PER_SPLIT * page;
  const int tid = threadIdx.x;
  const size_t head0 = (size_t)b * Hq + (size_t)h * G;  // first query head row
  T* o = out + head0 * Dv;
  // a split's partial: acc[G][Dv], m[G], l[G], on 16-byte strides
  const size_t part_stride = part_floats(G, Dv);
  const int PM = G * Dv, PL = G * Dv + G;              // offsets of m and l
  float* my_part = part + ((size_t)bh * n_splits + split) * part_stride;
  const int32_t* trow = table + (size_t)b * n_cols;

  // the slot's q_pos and this split's table columns, loaded together
  const int qp = q_pos[b];
  int blk[PAGES_PER_SPLIT];
  const bool any = split_blocks(trow, n_cols, num_blocks, split, blk);
  if (split_idle(qp, any, split, n_splits, trow, n_cols, num_blocks, o,
                 G * Dv, lst, flag))
    return;

  load_rows<T, VEC, SWZ>(k, v, k_extra, ks, vs, kes, blk, page, Hkv, h, D,
                         Dv, De);
  if (VEC) asm volatile("cp.async.commit_group;\n" ::: "memory");
  count_live(trow, n_cols, num_blocks, n_splits, lst, flag);
  // positions first: their loads are in flight while q is read
  for (int r = tid; r < R; r += blockDim.x) {
    const int bb = blk[r / page];
    const int p = bb >= 0 ? pos[(size_t)bb * page + r % page] : -1;
    ok[r] = (p >= 0) && (p <= qp) && (window <= 0 || p > qp - window);
  }
  for (int i = tid; i < GB * D; i += blockDim.x)
    qs[i] = i < G * D ? q[head0 * D + i] : from_f32<T>(0.f);
  for (int i = tid; i < GB * De; i += blockDim.x)
    qes[i] = i < G * De ? to_f32(q_extra[head0 * De + i]) * scale : 0.f;
  if (VEC) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores: a thread per (row, half of the GB query heads), its own dot
  // products over the head dims, times scale; q (unscaled, in the pool's
  // dtype) is read by every thread of a warp at once (a broadcast), K in
  // XOR-swizzled 16-byte units (VEC).  A masked row scores -1e30 and gets
  // p = 0 below
  constexpr int GH = GB / 2;
  for (int x = tid; x < 2 * R; x += blockDim.x) {
    const int r = x % R, g0 = (x / R) * GH;
    float a[GH];
#pragma unroll
    for (int j = 0; j < GH; ++j) a[j] = 0.f;
    if (ok[r]) {
      if constexpr (VEC) {
        constexpr int E = 16 / sizeof(T);
        const uint4* kr = reinterpret_cast<const uint4*>(ks + (size_t)r * D);
#pragma unroll 2
        for (int u = 0; u < D / E; ++u) {
          float kf[E];
          unpack(kr[k_unit<SWZ>(u, r)], kf);
#pragma unroll
          for (int j = 0; j < GH; ++j) {
            float qf[E];
            unpack(reinterpret_cast<const uint4*>(qs + (g0 + j) * D)[u], qf);
#pragma unroll
            for (int e = 0; e < E; ++e) a[j] = fmaf(qf[e], kf[e], a[j]);
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float kd = to_f32(ks[(size_t)r * D + d]);
#pragma unroll
          for (int j = 0; j < GH; ++j)
            a[j] += to_f32(qs[(g0 + j) * D + d]) * kd;
        }
      }
#pragma unroll
      for (int j = 0; j < GH; ++j) a[j] *= scale;
      for (int d = 0; d < De; ++d) {
        const float kd = to_f32(kes[(size_t)r * De + d]);
#pragma unroll
        for (int j = 0; j < GH; ++j) a[j] += qes[(g0 + j) * De + d] * kd;
      }
    }
#pragma unroll
    for (int j = 0; j < GH; ++j) {
      float y = a[j];
      if (softcap > 0.f) y = softcap * tanhf(y / softcap);
      sc[r * GP + g0 + j] = ok[r] ? y : kNegInf;
    }
  }
  __syncthreads();

  // the split's softmax statistics: 128 / GB consecutive lanes per query
  // head, R * GB / 128 rows each, reduced by shuffles inside the group
  {
    constexpr int TG = kThreads / GB;              // lanes per head
    const int g = tid / TG, t = tid % TG;
    float mx = kNegInf;
    for (int r = t; r < R; r += TG) mx = fmaxf(mx, sc[r * GP + g]);
#pragma unroll
    for (int off = TG / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float psum = 0.f;
    for (int r = t; r < R; r += TG) {
      const float p = ok[r] ? expf(sc[r * GP + g] - mx) : 0.f;
      sc[r * GP + g] = p;
      psum += p;
    }
#pragma unroll
    for (int off = TG / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    if (t == 0 && g < G) {
      my_part[PM + g] = mx;
      my_part[PL + g] = psum;
    }
  }
  __syncthreads();

  // acc_s = P . V over the split's rows in row order: a thread per (pair
  // of adjacent columns of V, half of the rows), all GB query heads; the
  // second half's sums go through shared memory (over K, free by now) and
  // are added to the first's: (rows of pages 0, 1) + (rows of pages 2, 3).
  // The pages of -1 columns are skipped (a masked row of a live page adds
  // p = 0 times its V)
  {
    constexpr int HALF = PAGES_PER_SPLIT / 2;
    const int n_pairs = (Dv + 1) / 2;                // <= 128: one item of
    float* upper = reinterpret_cast<float*>(ks);     // each half per thread
    float lower[2][GB];                              // [pair][GB][2] above
    int my_pair = -1;
    for (int x = tid; x < 2 * n_pairs; x += blockDim.x) {
      const int pair = x % n_pairs, half = x / n_pairs, d = 2 * pair;
      const bool two = d + 1 < Dv;
      float a[2][GB];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int g = 0; g < GB; ++g) a[c][g] = 0.f;
#pragma unroll
      for (int jj = 0; jj < HALF; ++jj) {
        const int j = half * HALF + jj;
        if (blk[j] < 0) continue;
#pragma unroll 4
        for (int rr = 0; rr < page; ++rr) {
          const int r = j * page + rr;
          const T* vr = vs + (size_t)r * Dv + d;
          const float v0 = to_f32(vr[0]), v1 = two ? to_f32(vr[1]) : 0.f;
          const float4* pr = reinterpret_cast<const float4*>(sc + r * GP);
#pragma unroll
          for (int g4 = 0; g4 < GB / 4; ++g4) {
            const float4 p4 = pr[g4];
            a[0][4 * g4] += p4.x * v0;
            a[0][4 * g4 + 1] += p4.y * v0;
            a[0][4 * g4 + 2] += p4.z * v0;
            a[0][4 * g4 + 3] += p4.w * v0;
            a[1][4 * g4] += p4.x * v1;
            a[1][4 * g4 + 1] += p4.y * v1;
            a[1][4 * g4 + 2] += p4.z * v1;
            a[1][4 * g4 + 3] += p4.w * v1;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (half == 1) {
          upper[(pair * GB + g) * 2] = a[0][g];
          upper[(pair * GB + g) * 2 + 1] = a[1][g];
        } else {
          lower[0][g] = a[0][g];
          lower[1][g] = a[1][g];
        }
      }
      if (half == 0) my_pair = pair;
    }
    __syncthreads();
    if (my_pair >= 0) {
      const int d = 2 * my_pair;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < G) {
          my_part[g * Dv + d] = lower[0][g] + upper[(my_pair * GB + g) * 2];
          if (d + 1 < Dv)
            my_part[g * Dv + d + 1] =
                lower[1][g] + upper[(my_pair * GB + g) * 2 + 1];
        }
      }
    }
  }

  // the last of the live splits of this (slot, kv head) to finish merges
  // the partials: acc_s staged over K / V, (m_s, l_s) over the weights
  if (!last_split(counter + bh, flag)) return;
  merge_splits<8>(part + (size_t)bh * n_splits * part_stride, part_stride, G,
                  Dv, n_splits, trow, n_cols, num_blocks, lst, flag,
                  reinterpret_cast<float*>(smem + L.ks),
                  max(1, (int)(L.sc - L.ks) / (4 * PM)), cm, cl, ms, ls,
                  reinterpret_cast<float*>(smem + L.sc),
                  reinterpret_cast<float*>(smem + L.sc) + MAX_GROUP, o,
                  counter + bh);
}

template <typename T, bool VEC, bool SWZ, int GB>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* table, const void* q_pos, const void* q_extra,
           const void* k_extra, void* out, void* part, void* counter, int B,
           int Hkv, int G, int D, int Dv, int De, int page, int n_cols,
           int num_blocks, float scale, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = Smem(G, D, Dv, De, page, (int)sizeof(T)).total;
  auto kernel = paged_split_kernel<T, VEC, SWZ, GB>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_splits = (n_cols + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT;
  kernel<<<dim3(B * Hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(q_pos),
      static_cast<const T*>(q_extra), static_cast<const T*>(k_extra),
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(counter), Hkv, G, D, Dv, De, page, n_cols,
      num_blocks, scale, window, softcap);
  return (int)cudaGetLastError();
}

// the instance of the group bucket of G
template <typename T, bool VEC, bool SWZ>
int launch_g(const void* q, const void* k, const void* v, const void* pos,
             const void* table, const void* q_pos, const void* q_extra,
             const void* k_extra, void* out, void* part, void* counter, int B,
             int Hkv, int G, int D, int Dv, int De, int page, int n_cols,
             int num_blocks, float scale, int window, float softcap,
             cudaStream_t s) {
  const int gb = group_bucket(G);
  if (gb == 4)
    return launch<T, VEC, SWZ, 4>(q, k, v, pos, table, q_pos, q_extra,
                                  k_extra, out, part, counter, B, Hkv, G, D,
                                  Dv, De, page, n_cols, num_blocks, scale,
                                  window, softcap, s);
  if (gb == 8)
    return launch<T, VEC, SWZ, 8>(q, k, v, pos, table, q_pos, q_extra,
                                  k_extra, out, part, counter, B, Hkv, G, D,
                                  Dv, De, page, n_cols, num_blocks, scale,
                                  window, softcap, s);
  return launch<T, VEC, SWZ, 16>(q, k, v, pos, table, q_pos, q_extra, k_extra,
                                 out, part, counter, B, Hkv, G, D, Dv, De,
                                 page, n_cols, num_blocks, scale, window,
                                 softcap, s);
}

// 16-byte loads when the wrapper says the rows allow them; the swizzled K
// layout when a K row is a whole number of 8-unit groups
template <typename T>
int launch_any(bool vec, const void* q, const void* k, const void* v,
               const void* pos, const void* table, const void* q_pos,
               const void* q_extra, const void* k_extra, void* out,
               void* part, void* counter, int B, int Hkv, int G, int D,
               int Dv, int De, int page, int n_cols, int num_blocks,
               float scale, int window, float softcap, cudaStream_t s) {
  const bool swz = vec && (D * (int)sizeof(T) / 16) % 8 == 0;
  if (swz)
    return launch_g<T, true, true>(q, k, v, pos, table, q_pos, q_extra,
                                   k_extra, out, part, counter, B, Hkv, G, D,
                                   Dv, De, page, n_cols, num_blocks, scale,
                                   window, softcap, s);
  if (vec)
    return launch_g<T, true, false>(q, k, v, pos, table, q_pos, q_extra,
                                    k_extra, out, part, counter, B, Hkv, G, D,
                                    Dv, De, page, n_cols, num_blocks, scale,
                                    window, softcap, s);
  return launch_g<T, false, false>(q, k, v, pos, table, q_pos, q_extra,
                                   k_extra, out, part, counter, B, Hkv, G, D,
                                   Dv, De, page, n_cols, num_blocks, scale,
                                   window, softcap, s);
}

// ---------------------------------------------------------------------------
// The wide-head instance (see the header): gemma3-12b's decode shape only,
// bf16, G = 2, D = Dv = 256, 16-row pages.  A warp per K row, each warp's
// pages through a 2-stage cp.async ring, an online softmax per warp, the
// warps' partials combined in warp order; the split kernel's splits,
// partials, prologue, counter and merge.
// ---------------------------------------------------------------------------

constexpr int WIDE_G = 2;                          // query heads a kv head
constexpr int WIDE_D = 256;                        // D = Dv: a unit a lane
constexpr int WIDE_PAGE = 16;
constexpr int WIDE_WARPS = kThreads / 32;
constexpr int WIDE_ROWS = WIDE_PAGE / WIDE_WARPS;  // rows of a page a warp
constexpr int WIDE_STAGES = 2;                     // pages in flight a warp

// Byte offsets of one wide block's dynamic shared memory: the warps' rings
// of K and V rows, [warp][stage][row][K | V] in bf16 (the warps' partials,
// then the merge's staged acc_s, reuse the region once every warp is
// done), then the merge's lists of live splits (chunk 0's, the current
// chunk's), their weights and l_s, the running max, l, rescale factor and
// new max, and flags.
struct WideSmem {
  size_t rows, lst, cw, cl, ml, flag, total;
  __host__ __device__ WideSmem(int G, int D, int Dv) {
    const size_t staged =
        (size_t)WIDE_WARPS * WIDE_STAGES * WIDE_ROWS * (D + Dv) * 2;
    const size_t partials = sizeof(float) * WIDE_WARPS * part_floats(G, Dv);
    rows = 0;
    lst = round16(staged > partials ? staged : partials);
    cw = round16(lst + sizeof(int) * 2 * MERGE_CHUNK);
    cl = cw + sizeof(float) * MERGE_CHUNK * G;
    ml = cl + sizeof(float) * MERGE_CHUNK * G;    // m, l, alpha, M: 4 G
    flag = ml + sizeof(float) * 4 * G;
    total = flag + 2 * sizeof(int);
  }
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sums each of NV values (NV a power of two up to 32) over the warp and
// leaves every sum in every lane.  Each xor step keeps half of a lane's
// values and hands the other half to its partner, so after log2 NV steps a
// lane holds one value (index: the lane's bits at the offsets folded)
// summed over those lanes; the other offsets finish its sum, and NV
// shuffles hand each sum back to every lane: 2 NV + 4 - log2 NV shuffles
// against 5 NV for a butterfly per value.
template <int NV>
__device__ __forceinline__ void warp_sum_all(float (&v)[NV]) {
  static_assert(NV >= 1 && NV <= 32 && (NV & (NV - 1)) == 0, "NV");
  constexpr int LOG = NV >= 32 ? 5 : NV >= 16 ? 4 : NV >= 8 ? 3
                    : NV >= 4 ? 2 : NV >= 2 ? 1 : 0;
  const int lane = threadIdx.x & 31;
  float x[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) x[i] = v[i];
#pragma unroll
  for (int st = 0; st < LOG; ++st) {           // fold half the values
    const int h = NV >> (st + 1), off = 16 >> st;
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep = up ? x[i + h] : x[i];
      const float send = up ? x[i] : x[i + h];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float t = x[0];
#pragma unroll
  for (int st = LOG; st < 5; ++st)
    t += __shfl_xor_sync(0xffffffffu, t, 16 >> st);
#pragma unroll
  for (int k = 0; k < NV; ++k) {               // lane holding sum k
    int src = 0;
#pragma unroll
    for (int st = 0; st < LOG; ++st)
      if ((k >> (LOG - 1 - st)) & 1) src += 16 >> st;
    v[k] = __shfl_sync(0xffffffffu, t, src);
  }
}

// One warp's copies of one page into stage `slot` of its ring: rows w, w +
// 4, w + 8, w + 12 of kv head h, lane u taking 16-byte unit u of each K
// and V row (none for a -1 column)
__device__ __forceinline__ void wide_issue(int bj, int slot,
                                           __nv_bfloat16* wrows,
                                           const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, int Hkv,
                                           int h, int warp, int lane) {
  if (bj < 0) return;
#pragma unroll
  for (int i = 0; i < WIDE_ROWS; ++i) {
    const size_t grow =
        ((size_t)bj * WIDE_PAGE + warp + WIDE_WARPS * i) * Hkv + h;
    __nv_bfloat16* dst = wrows + (size_t)(slot * WIDE_ROWS + i) * 2 * WIDE_D;
    cp_async16(dst + 8 * lane, k + grow * WIDE_D + 8 * lane);
    cp_async16(dst + WIDE_D + 8 * lane, v + grow * WIDE_D + 8 * lane);
  }
}

__global__ void __launch_bounds__(kThreads) paged_wide_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ table, const int32_t* __restrict__ q_pos,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part,
    int* __restrict__ counter, int Hkv, int n_cols, int num_blocks,
    float scale, int window, float softcap) {
  constexpr int G = WIDE_G, D = WIDE_D, Dv = WIDE_D;
  static_assert(D == 8 * 32, "a lane takes one 16-byte unit of a row");
  extern __shared__ __align__(16) unsigned char smem[];
  const WideSmem L(G, D, Dv);
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(smem + L.rows);
  int* lst = reinterpret_cast<int*>(smem + L.lst);
  float* cw = reinterpret_cast<float*>(smem + L.cw);   // [chunk][G] weights
  float* cl = reinterpret_cast<float*>(smem + L.cl);   // [chunk][G] l_s
  float* ms = reinterpret_cast<float*>(smem + L.ml);   // [G] running max
  float* ls = ms + G;                                  // [G] running l
  float* m_al = ls + G;                                // [G] rescale
  float* mnew = m_al + G;                              // [G] new max
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  // grid (Hkv x n_splits, B): a slot's splits run together, so most
  // merges overlap other slots' loads instead of all waiting for the end
  const int b = blockIdx.y, h = blockIdx.x % Hkv;
  const int bh = b * Hkv + h;
  const int split = blockIdx.x / Hkv, n_splits = gridDim.x / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head0 = (size_t)b * Hkv * G + (size_t)h * G;
  __nv_bfloat16* o = out + head0 * Dv;
  const size_t part_stride = part_floats(G, Dv);
  const int PM = G * Dv, PL = G * Dv + G;              // offsets of m and l
  float* my_part = part + ((size_t)bh * n_splits + split) * part_stride;
  const int32_t* trow = table + (size_t)b * n_cols;

  const int qp = q_pos[b];
  int blk[PAGES_PER_SPLIT];
  const bool any = split_blocks(trow, n_cols, num_blocks, split, blk);
  if (split_idle(qp, any, split, n_splits, trow, n_cols, num_blocks, o,
                 G * Dv, lst, flag))
    return;

  // this warp's rows w, w + 4, w + 8, w + 12 of each live page go through
  // a ring of WIDE_STAGES pages: lane u copies 16-byte unit u of each K row
  // and of each V row, one commit group a page (empty for a -1 column or
  // past the split), so with WIDE_STAGES - 1 groups left pending the page
  // at hand has landed.  A lane reads back only the units it copied
  const int rstride = D + Dv;                          // elements a staged row
  __nv_bfloat16* wrows =
      rows + (size_t)warp * WIDE_STAGES * WIDE_ROWS * rstride;
#pragma unroll
  for (int j = 0; j < WIDE_STAGES; ++j) {
    wide_issue(blk[j], j, wrows, k, v, Hkv, h, warp, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  count_live(trow, n_cols, num_blocks, n_splits, lst, flag);
  // which of this warp's 16 rows are unmasked: lane 4 j + i reads row i of
  // page j
  bool ok_l = false;
  if (lane < PAGES_PER_SPLIT * WIDE_ROWS) {
    const int j = lane / WIDE_ROWS, i = lane % WIDE_ROWS;
    int bb = blk[0];
#pragma unroll
    for (int jj = 1; jj < PAGES_PER_SPLIT; ++jj)   // no local-memory index
      if (j == jj) bb = blk[jj];
    const int p =
        bb >= 0 ? pos[(size_t)bb * WIDE_PAGE + warp + WIDE_WARPS * i] : -1;
    ok_l = (p >= 0) && (p <= qp) && (window <= 0 || p > qp - window);
  }
  const unsigned okmask = __ballot_sync(0xffffffffu, ok_l);
  // the G query rows' unit `lane`, unscaled, as float32
  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
    unpack(*reinterpret_cast<const uint4*>(q + (head0 + g) * D + 8 * lane),
           qf[g]);

  // per page: scores of the warp's 4 rows (a lane's 8-element dot, summed
  // over the warp by shuffles), the online softmax (m and l the same on
  // every lane), then P.V with lane u owning V columns 8 u .. 8 u + 7 of
  // every head; then the page's stage takes the page WIDE_STAGES on.  A
  // masked row gets p = 0 and adds nothing; a -1 column's page, or one
  // with no unmasked row here, is skipped
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < PAGES_PER_SPLIT; ++j) {
    cp_async_wait<WIDE_STAGES - 1>();
    const unsigned okp = (okmask >> (WIDE_ROWS * j)) & ((1u << WIDE_ROWS) - 1);
    const __nv_bfloat16* pr =
        wrows + (size_t)(j % WIDE_STAGES) * WIDE_ROWS * rstride;
    if (okp != 0) {
      float s[WIDE_ROWS * G];          // [row][head], summed over the warp
#pragma unroll
      for (int i = 0; i < WIDE_ROWS; ++i) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[i * G + g] = 0.f;
        float kf[8];
        unpack(*reinterpret_cast<const uint4*>(pr + (size_t)i * rstride +
                                               8 * lane),
               kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            s[i * G + g] = fmaf(qf[g][e], kf[e], s[i * G + g]);
      }
      warp_sum_all(s);
      // the online softmax: each head's new max; lane k computes p of
      // (row k / G, head k % G) and a shuffle hands each p to every lane;
      // l and acc rescale only when a head's max moved (alpha = 1 else)
      float mn[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < WIDE_ROWS; ++i) {
          float y = s[i * G + g] * scale;
          if (softcap > 0.f) y = softcap * tanhf(y / softcap);
          s[i * G + g] = y;
          if ((okp >> i) & 1) mx = fmaxf(mx, y);
        }
        mn[g] = fmaxf(m[g], mx);
      }
      constexpr int NV = WIDE_ROWS * G;
      const int kv = lane % NV;
      float sk = s[0], mk = mn[0];
#pragma unroll
      for (int x = 1; x < NV; ++x)         // no local-memory index
        if (kv == x) sk = s[x], mk = mn[x % G];
      const float pk = (okp >> (kv / G)) & 1 ? expf(sk - mk) : 0.f;
      float p[WIDE_ROWS][G];
#pragma unroll
      for (int i = 0; i < WIDE_ROWS; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g)
          p[i][g] = __shfl_sync(0xffffffffu, pk, i * G + g);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < WIDE_ROWS; ++i) psum += p[i][g];
        if (mn[g] > m[g]) {
          const float alpha = expf(m[g] - mn[g]);
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
          m[g] = mn[g];
        }
        l[g] += psum;
      }
#pragma unroll
      for (int i = 0; i < WIDE_ROWS; ++i) {
        if (!((okp >> i) & 1)) continue;
        float vf[8];
        unpack(*reinterpret_cast<const uint4*>(pr + (size_t)i * rstride + D +
                                               8 * lane),
               vf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[g][e] = fmaf(p[i][g], vf[e], acc[g][e]);
      }
    }
    __syncwarp();                      // the stage's reads are done
    if (j + WIDE_STAGES < PAGES_PER_SPLIT)
      wide_issue(blk[min(j + WIDE_STAGES, PAGES_PER_SPLIT - 1)],
                 j % WIDE_STAGES, wrows, k, v, Hkv, h, warp, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // the warps' partials, combined in warp order into the split's: M = max
  // m_w, l_s = sum l_w e^(m_w - M), acc_s = sum acc_w e^(m_w - M)
  __syncthreads();                   // every warp is done with its rows
  float* wp = reinterpret_cast<float*>(smem + L.rows);  // [warp][part]
  {
    float* mine = wp + (size_t)warp * part_stride;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4* d4 = reinterpret_cast<float4*>(mine + g * Dv + 8 * lane);
      d4[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      d4[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        mine[PM + g] = m[g];
        mine[PL + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < PL + G; i += kThreads) {
    const int g = i < PM ? i / Dv : (i - PM) % G;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < WIDE_WARPS; ++w)
      M = fmaxf(M, wp[(size_t)w * part_stride + PM + g]);
    float a = 0.f;
    if (i >= PM && i < PL) {
      a = M;
    } else {
#pragma unroll
      for (int w = 0; w < WIDE_WARPS; ++w)
        a += wp[(size_t)w * part_stride + i] *
             expf(wp[(size_t)w * part_stride + PM + g] - M);
    }
    my_part[i] = a;
  }

  // the last of the live splits of this (slot, kv head) to finish merges
  // the partials: acc_s staged over the rows, 16 a round, an output
  // element of each head a thread (8 would spill across the division)
  if (!last_split(counter + bh, flag)) return;
  merge_splits<G * Dv / kThreads>(
      part + (size_t)bh * n_splits * part_stride, part_stride, G, Dv,
      n_splits, trow, n_cols, num_blocks, lst, flag,
      reinterpret_cast<float*>(smem + L.rows),
      max(1, (int)(L.lst / (sizeof(float) * PM))), cw, cl, ms, ls, m_al, mnew,
      o, counter + bh);
}

int launch_wide(const void* q, const void* k, const void* v, const void* pos,
                const void* table, const void* q_pos, void* out, void* part,
                void* counter, int B, int Hkv, int n_cols, int num_blocks,
                float scale, int window, float softcap, cudaStream_t stream) {
  const size_t smem = WideSmem(WIDE_G, WIDE_D, WIDE_D).total;
  auto kernel = paged_wide_kernel;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_splits = (n_cols + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT;
  kernel<<<dim3(Hkv * n_splits, B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(q_pos),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
      static_cast<int*>(counter), Hkv, n_cols, num_blocks, scale, window,
      softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The head-tiled instances (see the header): G > MAX_GROUP or head dims past
// the split kernel's, 16-byte rows only.  A split kernel writes each live
// split's partial per head tile; paged_merge_kernel then merges them.
// ---------------------------------------------------------------------------

constexpr int TILE_G = 16;  // query heads a block of the CUDA-core instance

// elements of one staged K row: K, K_extra, then one 16-byte unit of padding
__host__ __device__ inline int tiled_kstride(int D, int De, int isz) {
  return D + De + 16 / isz;
}

// Byte offsets of the regions of one CUDA-core tiled block's shared memory.
struct TiledSmem {
  size_t qs, ks, vs, sc, ok, total;
  __host__ __device__ TiledSmem(int D, int Dv, int De, int page, int isz,
                                bool kv_same) {
    const size_t R = (size_t)PAGES_PER_SPLIT * page;
    qs = 0;                                    // TILE_G x (D + De) f32
    ks = round16(qs + sizeof(float) * TILE_G * (D + De));
    vs = round16(ks + (size_t)isz * R * tiled_kstride(D, De, isz));
    sc = round16(vs + (kv_same ? 0 : (size_t)isz * R * Dv));  // R x Dv
    ok = sc + sizeof(float) * R * TILE_G;      // scores, then p: R x TILE_G
    total = ok + sizeof(int) * R;
  }
};

// four consecutive elements as floats (8 bytes of bf16 or 16 of f32)
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(x.x << 16), f[1] = __uint_as_float(x.x & 0xffff0000u);
  f[2] = __uint_as_float(x.y << 16), f[3] = __uint_as_float(x.y & 0xffff0000u);
}

// This split's table columns into `sblk` (block ids outside the pool count
// as -1); whether the block has work: a live slot and a live column.
__device__ __forceinline__ bool tiled_split_start(
    const int32_t* trow, int n_cols, int num_blocks, int split, int qp,
    int* sblk) {
  if (threadIdx.x < PAGES_PER_SPLIT) {
    const int c = split * PAGES_PER_SPLIT + threadIdx.x;
    const int x = c < n_cols ? trow[c] : -1;
    sblk[threadIdx.x] = (x < 0 || x >= num_blocks) ? -1 : x;
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int j = 0; j < PAGES_PER_SPLIT; ++j) any = any || sblk[j] >= 0;
  return qp >= 0 && any;
}

template <typename T, bool KV_SAME>
__global__ void __launch_bounds__(kThreads, 1) paged_tiled_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ table, const int32_t* __restrict__ q_pos,
    const T* __restrict__ q_extra, const T* __restrict__ k_extra,
    float* __restrict__ part, int Hkv, int G, int D, int Dv, int De,
    int page, int n_cols, int num_blocks, float scale, int window,
    float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sblk[PAGES_PER_SPLIT];
  const TiledSmem L(D, Dv, De, page, (int)sizeof(T), KV_SAME);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = KV_SAME ? ks : reinterpret_cast<T*>(smem + L.vs);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  int* ok = reinterpret_cast<int*>(smem + L.ok);

  constexpr int E = 16 / sizeof(T);          // elements per 16-byte unit
  const int n_tiles = (G + TILE_G - 1) / TILE_G;
  const int ct = blockIdx.x;                 // (slot, kv head, head tile)
  const int bh = ct / n_tiles, tile = ct % n_tiles;
  const int b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int Gt = min(TILE_G, G - tile * TILE_G);  // this tile's query heads
  const int R = PAGES_PER_SPLIT * page;
  const int KS = tiled_kstride(D, De, (int)sizeof(T));
  const int VS = KV_SAME ? KS : Dv;          // V row stride in shared memory
  const int QW = D + De;                     // staged q row
  const int tid = threadIdx.x;
  const size_t head0 =
      (size_t)b * Hkv * G + (size_t)h * G + (size_t)tile * TILE_G;
  const size_t part_stride = part_floats(TILE_G, Dv);
  const int PM = TILE_G * Dv, PL = TILE_G * Dv + TILE_G;
  float* my_part = part + ((size_t)ct * n_splits + split) * part_stride;

  const int qp = q_pos[b];
  if (!tiled_split_start(table + (size_t)b * n_cols, n_cols, num_blocks,
                         split, qp, sblk))
    return;  // an idle slot or a split with no column: nothing to merge

  // the split's rows: K and K_extra into one padded row, V apart unless it
  // is K, 16 bytes a cp.async; a -1 column's page is never read
  {
    const int uk = D / E, ue = De / E, uv = KV_SAME ? 0 : Dv / E;
    const int U = uk + ue + uv;
    for (int x = tid; x < R * U; x += kThreads) {
      const int r = x / U, u = x % U;
      const int bb = sblk[r / page];
      if (bb < 0) continue;
      const size_t row = ((size_t)bb * page + r % page) * Hkv + h;
      if (u < uk)
        cp_async16(ks + (size_t)r * KS + u * E, k + row * D + u * E);
      else if (u < uk + ue)
        cp_async16(ks + (size_t)r * KS + D + (u - uk) * E,
                   k_extra + row * De + (u - uk) * E);
      else
        cp_async16(vs + (size_t)r * Dv + (u - uk - ue) * E,
                   v + row * Dv + (u - uk - ue) * E);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int r = tid; r < R; r += kThreads) {
    const int bb = sblk[r / page];
    const int p = bb >= 0 ? pos[(size_t)bb * page + r % page] : -1;
    ok[r] = (p >= 0) && (p <= qp) && (window <= 0 || p > qp - window);
  }
  for (int i = tid; i < TILE_G * QW; i += kThreads) {
    const int g = i / QW, d = i % QW;
    float x = 0.f;
    if (g < Gt)
      x = d < D ? to_f32(q[(head0 + g) * D + d])
                : to_f32(q_extra[(head0 + g) * De + d - D]);
    qs[i] = x;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores: a thread per (row, half of the tile's heads); sum over D, times
  // scale, plus the sum over De times scale.  A masked row scores -1e30
  constexpr int GH = TILE_G / 2;
  for (int x = tid; x < 2 * R; x += kThreads) {
    const int r = x % R, g0 = (x / R) * GH;
    float a[GH], e[GH];
#pragma unroll
    for (int j = 0; j < GH; ++j) a[j] = e[j] = 0.f;
    const bool live = ok[r];
    if (live) {
      const uint4* kr = reinterpret_cast<const uint4*>(ks + (size_t)r * KS);
#pragma unroll 2
      for (int u = 0; u < D / E; ++u) {
        float kf[E];
        unpack(kr[u], kf);
#pragma unroll
        for (int j = 0; j < GH; ++j) {
          const float* qr = qs + (g0 + j) * QW + u * E;
#pragma unroll
          for (int i = 0; i < E; i += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + i);
            a[j] = fmaf(q4.x, kf[i], a[j]);
            a[j] = fmaf(q4.y, kf[i + 1], a[j]);
            a[j] = fmaf(q4.z, kf[i + 2], a[j]);
            a[j] = fmaf(q4.w, kf[i + 3], a[j]);
          }
        }
      }
      for (int u = D / E; u < QW / E; ++u) {
        float kf[E];
        unpack(kr[u], kf);
#pragma unroll
        for (int j = 0; j < GH; ++j) {
          const float* qr = qs + (g0 + j) * QW + u * E;
#pragma unroll
          for (int i = 0; i < E; i += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + i);
            e[j] = fmaf(q4.x, kf[i], e[j]);
            e[j] = fmaf(q4.y, kf[i + 1], e[j]);
            e[j] = fmaf(q4.z, kf[i + 2], e[j]);
            e[j] = fmaf(q4.w, kf[i + 3], e[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < GH; ++j) {
      float y = a[j] * scale + e[j] * scale;
      if (softcap > 0.f) y = softcap * tanhf(y / softcap);
      sc[r * TILE_G + g0 + j] = live ? y : kNegInf;
    }
  }
  __syncthreads();

  // the split's softmax statistics, as in paged_split_kernel
  {
    constexpr int TG = kThreads / TILE_G;          // lanes per head
    const int g = tid / TG, t = tid % TG;
    float mx = kNegInf;
    for (int r = t; r < R; r += TG) mx = fmaxf(mx, sc[r * TILE_G + g]);
#pragma unroll
    for (int off = TG / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float psum = 0.f;
    for (int r = t; r < R; r += TG) {
      const float p = ok[r] ? expf(sc[r * TILE_G + g] - mx) : 0.f;
      sc[r * TILE_G + g] = p;
      psum += p;
    }
#pragma unroll
    for (int off = TG / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    if (t == 0) {
      my_part[PM + g] = mx;
      my_part[PL + g] = psum;
    }
  }
  __syncthreads();

  // acc_s = P . V: a thread per 4 adjacent columns of V and all 16 heads,
  // the split's rows in order (the pages of -1 columns skipped)
  for (int x = tid; x < Dv / 4; x += kThreads) {
    const int d = 4 * x;
    float acc[TILE_G][4];
#pragma unroll
    for (int g = 0; g < TILE_G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
    for (int j = 0; j < PAGES_PER_SPLIT; ++j) {
      if (sblk[j] < 0) continue;
#pragma unroll 2
      for (int rr = 0; rr < page; ++rr) {
        const int r = j * page + rr;
        float vf[4];
        load4(vs + (size_t)r * VS + d, vf);
        const float4* pr = reinterpret_cast<const float4*>(sc + r * TILE_G);
#pragma unroll
        for (int g4 = 0; g4 < TILE_G / 4; ++g4) {
          const float4 p4 = pr[g4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[4 * g4][c] = fmaf(p4.x, vf[c], acc[4 * g4][c]);
            acc[4 * g4 + 1][c] = fmaf(p4.y, vf[c], acc[4 * g4 + 1][c]);
            acc[4 * g4 + 2][c] = fmaf(p4.z, vf[c], acc[4 * g4 + 2][c]);
            acc[4 * g4 + 3][c] = fmaf(p4.w, vf[c], acc[4 * g4 + 3][c]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < TILE_G; ++g)
      *reinterpret_cast<float4*>(my_part + (size_t)g * Dv + d) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
}

// ---------------------------------------------------------------------------
// The MLA instance (see the header): bf16, k is v, 16-row pages, D = Dv =
// MLA_DV, 8 <= De <= 64, G a multiple of MLA_TH.  wgmma over a split's
// pages staged by TMA; its partials go to paged_merge_kernel.
// ---------------------------------------------------------------------------

constexpr int MLA_TH = 64;                // query heads a block: wgmma's M
constexpr int MLA_PAGES_PER_SPLIT = 8;    // table columns a split
constexpr int MLA_PAGE = 16;              // rows a page: one k16 step of P.V
constexpr int MLA_DV = 512;               // D = Dv (kv_lora_rank)
constexpr int MLA_NB = MLA_DV / 64 + 1;   // 128-byte column blocks of a row
// 2 consumer warpgroups + a producer warpgroup, whose registers
// `setmaxnreg` hands to the consumers: 128 x 56 + 256 x 224 = 64,512 of the
// SM's 65,536 (the launch bound gives each of the 384 threads 168, and 128
// accumulators a thread do not fit beside the rest)
constexpr int MLA_THREADS = 384;
constexpr int MLA_REGS_PRODUCER = 56;
constexpr int MLA_REGS_CONSUMER = 224;
constexpr int MLA_NW = MLA_DV / 2;        // V columns a consumer warpgroup
constexpr int MLA_WG_PAGES = MLA_PAGES_PER_SPLIT / 2;  // a warpgroup's pages
constexpr int MLA_WG_ROWS = MLA_WG_PAGES * MLA_PAGE;   // its score columns
static_assert(MLA_WG_ROWS == 64, "a warpgroup's scores are one m64n64 tile");

// The slot of the split's k-th live page: warpgroup k % 2 scores it, as
// its (k / 2)-th page, so each warpgroup's pages lie side by side
__device__ __forceinline__ int mla_slot(int k) {
  return (k % 2) * MLA_WG_PAGES + k / 2;
}

// Shared memory of one MLA block, in bytes from a 1024-byte aligned base:
// q as MLA_NB column blocks of MLA_TH rows x 128 bytes (8 of the latent,
// one of the rope term; once the scores are done, its first two blocks hold
// P, a warpgroup's 64 heads x 64 rows each, in the same layout); the page
// slots as MLA_NB column blocks of MLA_PAGES_PER_SPLIT slots x 16 rows x 128
// bytes (slot s of column block c at c x SLOTS_CB + s x SLOT); the row
// masks of the split's rows, a bit a row; each warpgroup's row maxima and
// row sums; the
// live pages' block ids and their count; the mbarriers (q, a slot each).
struct MlaLayout {
  static constexpr int Q_CB = MLA_TH * 128;
  static constexpr int SLOT = MLA_PAGE * 128;
  static constexpr int SLOTS_CB = MLA_PAGES_PER_SPLIT * SLOT;
  static constexpr int SLOTS_OFF = MLA_NB * Q_CB;
  static constexpr int OK_OFF = SLOTS_OFF + MLA_NB * SLOTS_CB;
  static constexpr int ROW_OFF = OK_OFF + MLA_PAGES_PER_SPLIT * MLA_PAGE / 8;
  static constexpr int LST_OFF = ROW_OFF + 4 * 4 * MLA_TH;
  static constexpr int BAR_OFF = (LST_OFF + 4 * (MLA_PAGES_PER_SPLIT + 1) + 7) & ~7;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + MLA_PAGES_PER_SPLIT) + 1024;
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

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

// Returns once the phase of parity `parity` of the barrier has completed.
// A trap inside a loop of the consumers' code keeps ptxas from giving it
// the budget `setmaxnreg.inc` raised, so a wait that outlasts 2^32 cycles
// gives up instead and marks the thread `dead`, whose later waits return
// at once; a marked thread traps after its loop, so the launch fails (a
// launch error, not a hung card) and no result is written.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar,
                                                  uint32_t parity,
                                                  bool& dead) {
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
  } while (!done && !dead && !(dead = clock64() - t0 > (1ll << 32)));
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
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

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// makes this thread's generic-proxy writes to shared memory visible to the
// tensor cores' (async-proxy) reads that follow
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (3, 4 or 8) of the 256 consumer threads (0 is
// __syncthreads, 1 the producer's hand-over, 2 its row masks, 5 the
// producer's own, 6 and 7 each consumer warpgroup's own)
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// d (64 x 256, f32) += a (64 x 16, smem) . b (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// The MLA split kernel.  Block (head tile, split) of grid (B * Hkv * G /
// MLA_TH, n_splits).  Warpgroup 2 produces: thread 256 sets up the
// mbarriers and issues the q tile's 9 TMA boxes, warp 9 reads the split's
// table columns meanwhile, then lane 0 of each producer warp w issues the
// boxes of live pages w and w + 4 on their slots' mbarriers, each thread
// reads one split row's position for the row masks, and the slots of the
// split's columns that hold no live page are zero-filled.  So the whole
// split is in flight at once; -1 columns are never read.  Warpgroups 0 and
// 1 consume:
//   S = [q | q_rope] . [K | K_rope]^T: warpgroup w scores the split's pages
//     w, w + 2, w + 4, w + 6 (64 rows, one m64n64 tile) as soon as they
//     land, MLA_NB x 4 k16 steps with both operands in shared memory;
//   scale, softcap and mask on the registers; the split's row max M (the
//     two warpgroups' maxima meet through shared memory), p = e^(s - M),
//     each warpgroup's row sums; P in bf16 into shared memory over q (free
//     once both have scored), in the layout wgmma's A operand reads, pages
//     0-3 first;
//   acc += P . V over the split's 8 pages (a zero slot adds exact zeros),
//     warpgroup w on V columns w x MLA_NW .. + MLA_NW (m64n256k16, both
//     operands in shared memory, V the pages' latent rows read MN-major),
//     pages 0-3 on the tensor cores while P of pages 4-7 is computed.
// Then the split's partial: acc (staged through shared memory and stored by
// TMA), M, and the two warpgroups' row sums added.
__global__ void __launch_bounds__(MLA_THREADS, 1) paged_mla_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_qe,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_ke,
    const __grid_constant__ CUtensorMap tm_part,
    const int32_t* __restrict__ pos, const int32_t* __restrict__ table,
    const int32_t* __restrict__ q_pos, float* __restrict__ part, int Hkv,
    int G, int n_cols, int num_blocks, float scale, int window,
    float softcap) {
  using L = MlaLayout;
  constexpr int PPS = MLA_PAGES_PER_SPLIT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (sbase - raw);   // generic view
  const uint32_t sq = sbase, sslots = sbase + L::SLOTS_OFF;
  uint32_t* okw = reinterpret_cast<uint32_t*>(gbase + L::OK_OFF);
  float* rowmax = reinterpret_cast<float*>(gbase + L::ROW_OFF);  // [2][64]
  float* rowsum = rowmax + 2 * MLA_TH;                            // [2][64]
  int* lst = reinterpret_cast<int*>(gbase + L::LST_OFF);   // [PPS], count
  const uint32_t bar_q = sbase + L::BAR_OFF;
  const uint32_t bar_page = bar_q + 8;                     // a slot each

  const int n_tiles = G / MLA_TH;
  const int ct = blockIdx.x;                 // (slot, kv head, head tile)
  const int bh = ct / n_tiles, tile = ct % n_tiles;
  const int b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int tid = threadIdx.x;
  const int head0 = b * Hkv * G + h * G + tile * MLA_TH;  // q row of head 0
  const int qp = q_pos[b];
  if (qp < 0) return;                        // an idle slot: nothing to merge

  // warp-uniform for the compiler: setmaxnreg sits in warpgroup-uniform
  // branches that never reconverge
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 2) {
    // ---- producer: warpgroup 2 -------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        MLA_REGS_PRODUCER));
    const int pt = tid - 256, pw = pt >> 5;
    if (pt == 0) {
      // the barriers, then q: it does not depend on the table
      mbar_init(bar_q, 1);
      for (int i = 0; i < PPS; ++i) mbar_init(bar_page + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(bar_q, MLA_NB * L::Q_CB);
      for (int cb = 0; cb < MLA_NB - 1; ++cb)
        tma_load_2d(sq + cb * L::Q_CB, &tm_q, bar_q, 64 * cb, head0);
      tma_load_2d(sq + (MLA_NB - 1) * L::Q_CB, &tm_qe, bar_q, 0, head0);
    }
    if (pw == 1) {                           // warp 9: the live columns
      const int lane = pt & 31, c = split * PPS + lane;
      int x = -1;
      if (lane < PPS && c < n_cols) x = table[(size_t)b * n_cols + c];
      const bool live = x >= 0 && x < num_blocks;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) lst[__popc(mask & ((1u << lane) - 1))] = x;
      if (lane == 0) lst[PPS] = __popc(mask);
    }
    asm volatile("bar.sync 5, 128;\n" ::: "memory");
    const int n_live = lst[PPS];
    // the live list and the barriers are set: hand over to the consumers
    asm volatile("bar.arrive 1, %0;\n" ::"n"(MLA_THREADS) : "memory");
    if (n_live == 0) {              // no live column: let q land, and leave
      if (pt == 0) {
        bool gave_up = false;
        mbar_wait_bounded(bar_q, 0, gave_up);
      }
      return;
    }
    // thread pt reads the position of split row pt (row pt % 16 of live
    // page pt / 16) while lane 0 of producer warp w copies pages w and w +
    // 4 (8 boxes of 16 latent rows x 64 columns and one of the rope rows
    // each, 18 KB, on the slot's barrier)
    const int prow = pt < n_live * MLA_PAGE
                         ? pos[(size_t)lst[pt / MLA_PAGE] * MLA_PAGE +
                               pt % MLA_PAGE]
                         : -1;
    if ((pt & 31) == 0) {
      for (int kp = pw; kp < n_live; kp += 4) {
        const int sl = mla_slot(kp), row = lst[kp] * MLA_PAGE;
        const uint32_t full = bar_page + 8 * sl, dst = sslots + sl * L::SLOT;
        mbar_expect_tx(full, MLA_NB * L::SLOT);
        for (int cb = 0; cb < MLA_NB - 1; ++cb)
          tma_load_3d(dst + cb * L::SLOTS_CB, &tm_k, full, 64 * cb, h, row);
        tma_load_3d(dst + (MLA_NB - 1) * L::SLOTS_CB, &tm_ke, full, 0, h,
                    row);
      }
    }
    // the row masks of the split's 128 rows as 4 words (bit r % 32 of word
    // r / 32; rows of no live page masked), for the consumers' softmax
    const bool ok = prow >= 0 && prow <= qp && (window <= 0 || prow > qp - window);
    const unsigned okbits = __ballot_sync(0xffffffffu, ok);
    if ((pt & 31) == 0) okw[pw] = okbits;
    asm volatile("bar.arrive 2, %0;\n" ::"n"(MLA_THREADS) : "memory");
    // the slots of the split's columns that hold no live page: zeros
    if (n_live < PPS) {
      for (int kp = n_live; kp < PPS; ++kp) {
        const int off = L::SLOTS_OFF + mla_slot(kp) * L::SLOT;
        for (int x = pt; x < MLA_NB * MLA_PAGE * 8; x += 128)
          *reinterpret_cast<uint4*>(gbase + off + (x / 128) * L::SLOTS_CB +
                                    (x % 128) * 16) = make_uint4(0, 0, 0, 0);
      }
      fence_async_smem();
      asm volatile("bar.sync 5, 128;\n" ::: "memory");
      if (pt == 0)
        for (int kp = n_live; kp < PPS; ++kp)
          mbar_arrive(bar_page + 8 * mla_slot(kp));
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  asm volatile("bar.sync 1, %0;\n" ::"n"(MLA_THREADS) : "memory");
  const int n_live = lst[PPS];
  if (n_live == 0) return;                   // no live column: no partial
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      MLA_REGS_CONSUMER));
  bool dead = false;                  // a bounded wait gave up

  const int t = tid - 128 * wg, warp = t >> 5, lane = t & 31;
  // this thread's rows (heads) g0 = 16 warp + lane / 4 and g1 = g0 + 8;
  // its columns 8 i + 2 (lane % 4) + {0, 1} of every 8 (of this
  // warpgroup's 64 score columns for s, of its MLA_NW V columns for acc)
  const int col_l = 2 * (lane & 3);
  const int g0 = 16 * warp + (lane >> 2), g1 = g0 + 8;
  float s[MLA_WG_ROWS / 2];
#pragma unroll
  for (int i = 0; i < MLA_WG_ROWS / 2; ++i) s[i] = 0.f;

  // the scores of this warpgroup's pages, once they and q have landed
  mbar_wait_bounded(bar_q, 0, dead);
#pragma unroll
  for (int p = 0; p < MLA_WG_PAGES; ++p)
    mbar_wait_bounded(bar_page + 8 * (wg * MLA_WG_PAGES + p), 0, dead);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < MLA_NB * 4; ++ks) {
    const uint32_t off = (ks % 4) * 32;
    wgmma_ss_n64(s, make_desc(sq + (ks / 4) * L::Q_CB + off, 16, 1024),
                 make_desc(sslots + (ks / 4) * L::SLOTS_CB +
                               wg * MLA_WG_PAGES * L::SLOT + off,
                           16, 1024),
                 ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  // scale, softcap, mask (the producer's row masks: score column 8 i +
  // col_l + e is split row 32 (i / 2) + 16 wg + 8 (i % 2) + col_l + e, bit
  // 16 wg + col_l + 8 (i % 2) + e of word i / 2); the row maxima over the
  // quad, then over both warpgroups
  asm volatile("bar.sync 2, %0;\n" ::"n"(MLA_THREADS) : "memory");
  uint32_t okb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) okb[i] = okw[i] >> (16 * wg + col_l);
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < MLA_WG_ROWS / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = (okb[i / 2] >> (8 * (i % 2) + (e & 1))) & 1u;
      float y = s[4 * i + e] * scale;
      if (softcap > 0.f) y = softcap * tanhf(y / softcap);
      y = ok ? y : kNegInf;
      s[4 * i + e] = y;
      if (e < 2) mx0 = fmaxf(mx0, y); else mx1 = fmaxf(mx1, y);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  if ((lane & 3) == 0) {
    rowmax[wg * MLA_TH + g0] = mx0;
    rowmax[wg * MLA_TH + g1] = mx1;
  }
  consumers_sync(3);                  // both have scored: q is free
  const float M0 = fmaxf(mx0, rowmax[(wg ^ 1) * MLA_TH + g0]);
  const float M1 = fmaxf(mx1, rowmax[(wg ^ 1) * MLA_TH + g1]);
  // p = e^(s - M) (0 where masked), its row sums, and P in bf16 into
  // column block wg of the q region: 64 heads x 64 rows, 128-byte rows,
  // 16-byte unit u of row r at unit u ^ (r % 8), as q was.  In two rounds:
  // P of the split's pages 0-3 (this warpgroup's first two, score columns
  // 0-31), whose P.V products then run while the exponentials of pages 4-7
  // (columns 32-63) are computed.  acc = P . V over the split's pages in
  // order, this warpgroup's MLA_NW columns (m64n256k16)
  float acc[MLA_NW / 2];
#pragma unroll
  for (int i = 0; i < MLA_NW / 2; ++i) acc[i] = 0.f;
  float sum0 = 0.f, sum1 = 0.f;
  unsigned char* pw = gbase + wg * L::Q_CB;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 4 * r; i < 4 * r + 4; ++i) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = s[4 * i + e];
        pv[e] = y > kNegInf ? expf(y - (e < 2 ? M0 : M1)) : 0.f;
      }
      sum0 += pv[0] + pv[1];
      sum1 += pv[2] + pv[3];
      *reinterpret_cast<uint32_t*>(pw + g0 * 128 + ((i ^ (g0 & 7)) << 4) +
                                   2 * col_l) = pack_bf16(pv[0], pv[1]);
      *reinterpret_cast<uint32_t*>(pw + g1 * 128 + ((i ^ (g1 & 7)) << 4) +
                                   2 * col_l) = pack_bf16(pv[2], pv[3]);
    }
    if (r == 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
      if ((lane & 3) == 0) {
        rowsum[wg * MLA_TH + g0] = sum0;
        rowsum[wg * MLA_TH + g1] = sum1;
      }
    }
    fence_async_smem();               // P, for the tensor cores' reads
    consumers_sync(r == 0 ? 4 : 8);
    if (r == 0) {
#pragma unroll
      for (int p = 0; p < PPS; ++p)          // every slot has landed
        mbar_wait_bounded(bar_page + 8 * p, 0, dead);
      fence_regs(acc);
    }
    wgmma_fence();
#pragma unroll
    for (int p = PPS / 2 * r; p < PPS / 2 * (r + 1); ++p)
      wgmma_ss_n256(acc,
                    make_desc(sq + (p % 2) * L::Q_CB + (p / 2) * 32, 16, 1024),
                    make_desc(sslots + (MLA_NW / 64) * wg * L::SLOTS_CB +
                                  mla_slot(p) * L::SLOT,
                              L::SLOTS_CB, 1024));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (dead) asm volatile("trap;");              // a wait gave up

  // the split's partial: this warpgroup's 64 x MLA_NW floats staged over
  // its own V columns' slots (only its P.V read them) as 8 blocks of 64
  // rows x 32 floats in the 128-byte swizzle, then stored by TMA (8 boxes)
  const int part_i = ct * n_splits + split;
  {
    const int off = L::SLOTS_OFF + (MLA_NW / 64) * wg * L::SLOTS_CB;
    unsigned char* st = gbase + off;
#pragma unroll
    for (int i = 0; i < MLA_NW / 8; ++i) {
      const int u = 2 * (i % 4) + (col_l >> 2), half = (col_l >> 1) & 1;
      unsigned char* blk = st + (i / 4) * (MLA_TH * 128) + 8 * half;
      *reinterpret_cast<float2*>(blk + g0 * 128 + ((u ^ (g0 & 7)) << 4)) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(blk + g1 * 128 + ((u ^ (g1 & 7)) << 4)) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(6 + wg) : "memory");
    if (t == 0) {
      for (int j = 0; j < MLA_NW / 32; ++j)
        tma_store_3d(&tm_part, sbase + off + j * (MLA_TH * 128),
                     MLA_NW * wg + 32 * j, 0, part_i);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }

  // the split's m and l
  float* my_part = part + (size_t)part_i * part_floats(MLA_TH, MLA_DV);
  if (wg == 0 && (lane & 3) == 0) {
    const int PM = MLA_TH * MLA_DV, PL = PM + MLA_TH;
    my_part[PM + g0] = M0;
    my_part[PM + g1] = M1;
    my_part[PL + g0] = rowsum[g0] + rowsum[MLA_TH + g0];
    my_part[PL + g1] = rowsum[g1] + rowsum[MLA_TH + g1];
  }
}

// The merge of the head-tiled instances, launched after their split kernel
// (of PPS table columns a split): a block per (slot, kv head, query head), a
// thread per 4 output columns; a chunk's table columns and (m_s, l_s) are
// read by warp 0, a lane a split, at once.
// The live splits are taken MERGE_CHUNK at a time in split order, each
// chunk in the two-pass form against the running max (M = max m_s, the
// sums rescaled by e^(M_old - M)): with up to 128 columns, one chunk, it is
// M = max m_s, l = sum l_s e^(m_s - M), o = sum acc_s e^(m_s - M) / max(l,
// 1e-30) exactly.  A live split whose rows are all masked has l_s = 0 and
// acc_s = 0 and adds exactly 0; an idle slot, or a row with no column,
// outputs exact zeros.
template <typename T, int PPS>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(
    const float* __restrict__ part, const int32_t* __restrict__ table,
    const int32_t* __restrict__ q_pos, T* __restrict__ out, int Hkv, int G,
    int TH, int Dv, int n_cols, int num_blocks) {
  __shared__ int lst[MERGE_CHUNK];
  __shared__ float cw[MERGE_CHUNK], cl[MERGE_CHUNK];  // e^(m_s - M), l_s
  __shared__ int n_live;
  __shared__ float m_new;
  const int hq = blockIdx.x;                 // (slot, kv head, head)
  const int bh = hq / G, gh = hq % G;
  const int b = bh / Hkv;
  const int n_tiles = (G + TH - 1) / TH;
  const int ct = bh * n_tiles + gh / TH, gi = gh % TH;
  const int n_splits = (n_cols + PPS - 1) / PPS;
  const size_t part_stride = part_floats(TH, Dv);
  const float* pb = part + (size_t)ct * n_splits * part_stride;
  const int PM = TH * Dv + gi, PL = TH * Dv + TH + gi;
  const int32_t* trow = table + (size_t)b * n_cols;
  const bool idle = q_pos[b] < 0;
  const int tid = threadIdx.x;
  T* o = out + (size_t)hq * Dv;
  for (int x0 = 0; x0 < Dv / 4; x0 += kThreads) {  // every thread: barriers
    const int x = x0 + tid;
    const bool mine = x < Dv / 4;
    float M = kNegInf, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_splits && !idle; s0 += MERGE_CHUNK) {
      __syncthreads();
      // warp 0, a lane a split: the chunk's live splits in split order, the
      // new running max and each live split's weight e^(m_s - M) and l_s.
      // A lane reads its split's (m_s, l_s) beside its table columns, and
      // keeps them only if the split is live
      if (tid < 32) {
        const int sp = s0 + tid;
        float ms = kNegInf, ls = 0.f;
        if (sp < n_splits) {
          const float* ps = pb + (size_t)sp * part_stride;
          ms = __ldcg(ps + PM);
          ls = __ldcg(ps + PL);
        }
        const bool live =
            sp < n_splits && split_live<PPS>(trow, n_cols, num_blocks, sp);
        const unsigned mask = __ballot_sync(0xffffffffu, live);
        const int n = __popc(mask), at = __popc(mask & ((1u << tid) - 1));
        if (!live) ms = kNegInf, ls = 0.f;
        float Mn = fmaxf(M, ms);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          Mn = fmaxf(Mn, __shfl_xor_sync(0xffffffffu, Mn, off));
        if (live) {
          lst[at] = sp;
          cw[at] = expf(ms - Mn);
          cl[at] = ls;
        }
        if (tid == 0) {
          n_live = n;
          m_new = Mn;
        }
      }
      __syncthreads();
      const int n = n_live;
      if (n == 0) continue;
      const float Mn = m_new;
      const float alpha = expf(M - Mn);
      l *= alpha;
      a.x *= alpha, a.y *= alpha, a.z *= alpha, a.w *= alpha;
#pragma unroll 4
      for (int j = 0; j < n && mine; ++j) {
        const float* ps = pb + (size_t)lst[j] * part_stride;
        const float w = cw[j];
        const float4 y =
            *reinterpret_cast<const float4*>(ps + (size_t)gi * Dv + 4 * x);
        l += cl[j] * w;
        a.x += y.x * w, a.y += y.y * w, a.z += y.z * w, a.w += y.w * w;
      }
      M = Mn;
    }
    if (!mine) continue;
    const float inv = fmaxf(l, 1e-30f);
    o[4 * x] = from_f32<T>(a.x / inv);
    o[4 * x + 1] = from_f32<T>(a.y / inv);
    o[4 * x + 2] = from_f32<T>(a.z / inv);
    o[4 * x + 3] = from_f32<T>(a.w / inv);
  }
}

template <typename T, int PPS>
int launch_merge(const void* part, const void* table, const void* q_pos,
                 void* out, int B, int Hkv, int G, int TH, int Dv, int n_cols,
                 int num_blocks, cudaStream_t stream) {
  paged_merge_kernel<T, PPS><<<B * Hkv * G, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(q_pos), static_cast<T*>(out), Hkv, G, TH,
      Dv, n_cols, num_blocks);
  return (int)cudaGetLastError();
}

template <typename T, bool KV_SAME>
int launch_tiled(const void* q, const void* k, const void* v, const void* pos,
                 const void* table, const void* q_pos, const void* q_extra,
                 const void* k_extra, void* out, void* part, int B, int Hkv,
                 int G, int D, int Dv, int De, int page, int n_cols,
                 int num_blocks, float scale, int window, float softcap,
                 cudaStream_t stream) {
  const size_t smem =
      TiledSmem(D, Dv, De, page, (int)sizeof(T), KV_SAME).total;
  auto kernel = paged_tiled_kernel<T, KV_SAME>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = (G + TILE_G - 1) / TILE_G;
  const int n_splits = (n_cols + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT;
  kernel<<<dim3(B * Hkv * n_tiles, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(q_pos),
      static_cast<const T*>(q_extra), static_cast<const T*>(k_extra),
      static_cast<float*>(part), Hkv, G, D, Dv, De, page, n_cols, num_blocks,
      scale, window, softcap);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_merge<T, PAGES_PER_SPLIT>(part, table, q_pos, out, B, Hkv, G,
                                          TILE_G, Dv,
                         n_cols, num_blocks, stream);
}

template <typename T>
int launch_tiled_any(bool kv_same, const void* q, const void* k,
                     const void* v, const void* pos, const void* table,
                     const void* q_pos, const void* q_extra,
                     const void* k_extra, void* out, void* part, int B,
                     int Hkv, int G, int D, int Dv, int De, int page,
                     int n_cols, int num_blocks, float scale, int window,
                     float softcap, cudaStream_t s) {
  if (kv_same)
    return launch_tiled<T, true>(q, k, v, pos, table, q_pos, q_extra, k_extra,
                                 out, part, B, Hkv, G, D, Dv, De, page,
                                 n_cols, num_blocks, scale, window, softcap, s);
  return launch_tiled<T, false>(q, k, v, pos, table, q_pos, q_extra, k_extra,
                                out, part, B, Hkv, G, D, Dv, De, page, n_cols,
                                num_blocks, scale, window, softcap, s);
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

// a tensor (bf16 unless `type` says) of `rank` dimensions (innermost first,
// the byte strides of
// the outer ones) as TMA boxes with 128-byte swizzle, the layout the wgmma
// descriptors name; elements outside the tensor arrive as zeros
bool make_map(CUtensorMap* map, const void* ptr, cuuint32_t rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box,
              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The MLA instance: its split kernel, then the merge.  q / q_extra as (B x
// Hq, D / De) matrices in boxes of 64 heads x 64 columns; the pools as (N x
// page, Hkv, D / De) in boxes of one page's 16 rows x 64 columns of one kv
// head.
int launch_mla(const void* q, const void* k, const void* pos,
               const void* table, const void* q_pos, const void* q_extra,
               const void* k_extra, void* out, void* part, int B, int Hkv,
               int G, int De, int n_cols, int num_blocks, float scale,
               int window, float softcap, cudaStream_t stream) {
  const cuuint64_t heads = (cuuint64_t)B * Hkv * G;
  const cuuint64_t rows = (cuuint64_t)num_blocks * MLA_PAGE;
  const cuuint64_t dq[2] = {MLA_DV, heads}, sq[1] = {MLA_DV * 2};
  const cuuint64_t dqe[2] = {(cuuint64_t)De, heads};
  const cuuint64_t sqe[1] = {(cuuint64_t)De * 2};
  const cuuint64_t dk[3] = {MLA_DV, (cuuint64_t)Hkv, rows};
  const cuuint64_t sk[2] = {MLA_DV * 2, (cuuint64_t)Hkv * MLA_DV * 2};
  const cuuint64_t dke[3] = {(cuuint64_t)De, (cuuint64_t)Hkv, rows};
  const cuuint64_t ske[2] = {(cuuint64_t)De * 2, (cuuint64_t)Hkv * De * 2};
  const cuuint32_t bq[2] = {64, MLA_TH}, bk[3] = {64, 1, MLA_PAGE};
  // the partials' acc as (parts, 64 heads, MLA_DV) float32 (a part's stride
  // takes its m and l too) in boxes of 64 heads x 32 columns
  const int n_splits = (n_cols + MLA_PAGES_PER_SPLIT - 1) / MLA_PAGES_PER_SPLIT;
  const cuuint64_t dp[3] = {MLA_DV, MLA_TH,
                            (cuuint64_t)B * Hkv * (G / MLA_TH) * n_splits};
  const cuuint64_t spart[2] = {MLA_DV * 4,
                               (cuuint64_t)part_floats(MLA_TH, MLA_DV) * 4};
  const cuuint32_t bp[3] = {32, MLA_TH, 1};
  CUtensorMap tq, tqe, tk, tke, tp;
  if (!make_map(&tq, q, 2, dq, sq, bq) ||
      !make_map(&tqe, q_extra, 2, dqe, sqe, bq) ||
      !make_map(&tk, k, 3, dk, sk, bk) ||
      !make_map(&tke, k_extra, 3, dke, ske, bk) ||
      !make_map(&tp, part, 3, dp, spart, bp, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return (int)cudaErrorInvalidValue;
  const int smem = MlaLayout::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      paged_mla_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  paged_mla_kernel<<<dim3(B * Hkv * (G / MLA_TH), n_splits), MLA_THREADS, smem,
                     stream>>>(
      tq, tqe, tk, tke, tp, static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(q_pos),
      static_cast<float*>(part), Hkv, G, n_cols, num_blocks, scale, window,
      softcap);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return launch_merge<__nv_bfloat16, MLA_PAGES_PER_SPLIT>(
      part, table, q_pos, out, B, Hkv, G, MLA_TH, MLA_DV, n_cols, num_blocks,
      stream);
}

}  // namespace

extern "C" {

// Query heads a block of the head-tiled instance takes.
int paged_attention_tile_heads() { return TILE_G; }

// Query heads a block of the MLA instance takes and its table columns per
// split (the wrapper sizes its scratch with them).
int paged_attention_mla_heads() { return MLA_TH; }
int paged_attention_mla_pages_per_split() { return MLA_PAGES_PER_SPLIT; }

// Bytes of dynamic shared memory one block of the MLA instance needs.
long long paged_attention_mla_smem_bytes() {
  return (long long)MlaLayout::BYTES;
}

// Bytes of dynamic shared memory one block of the head-tiled instance
// needs (kv_same: V is K and is not staged apart).
long long paged_attention_tiled_smem_bytes(int D, int Dv, int De, int page,
                                           int isz, int kv_same) {
  return (long long)TiledSmem(D, Dv, De, page, isz, kv_same != 0).total;
}

// Table columns per split (the wrapper sizes the scratch with it).
int paged_attention_pages_per_split() { return PAGES_PER_SPLIT; }

// Floats of scratch one split's partial takes.
long long paged_attention_part_floats(int G, int Dv) {
  return (long long)part_floats(G, Dv);
}

// Bytes of dynamic shared memory one block of the wide-head instance needs.
long long paged_attention_wide_smem_bytes(int G, int D, int Dv) {
  return (long long)WideSmem(G, D, Dv).total;
}

// Bytes of dynamic shared memory one block of the kernel needs for
// elements of `isz` bytes.
long long paged_attention_smem_bytes(int G, int D, int Dv, int De, int page,
                                     int isz) {
  return (long long)Smem(G, D, Dv, De, page, isz).total;
}

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when D, Dv, De are multiples
// of 16 bytes of elements and k / v / k_extra are 16-byte aligned (loads
// go 16 bytes at a time by cp.async), else 0.  q_extra / k_extra may be
// null when De == 0.  part: float32 scratch of B * Hkv * n_splits *
// paged_attention_part_floats(G, Dv) elements, n_splits = ceil(n_cols /
// PAGES_PER_SPLIT);
// counter: B * Hkv ints, zero before the launch and zero again after it.
// G <= 16 (instance 0).  instance 3: the wide-head split instance
// (gemma3-12b's shape: bf16, vec, De == 0, G == 2, D == Dv == 256, 16-row
// pages, 16-byte aligned q), with instance 0's scratch and counter.
// instance 1: the CUDA-core head-tiled instance (any
// G; vec rows only), instance 2: the MLA one (bf16, vec, kv_same, 16-row
// pages, G a multiple of MLA_TH, D == Dv == MLA_DV, De a multiple of 8 in
// [8, 64], 16-byte aligned q / q_extra; n_splits = ceil(n_cols /
// MLA_PAGES_PER_SPLIT)).  Each launches its split kernel and the merge
// kernel; their scratch is per (slot, kv head, head tile of TILE_G or
// MLA_TH heads), each split's partial paged_attention_part_floats(heads,
// Dv) floats, and they take no counter.
// kv_same: v is k (same pointer and shape), staged once.  Returns the
// cudaError_t of the launch.
int paged_attention_fwd(const void* q, const void* k, const void* v,
                        const void* pos, const void* table, const void* q_pos,
                        const void* q_extra, const void* k_extra, void* out,
                        void* part, void* counter, int B, int Hkv, int G,
                        int D, int Dv, int De, int page, int n_cols,
                        int num_blocks, float scale, int window,
                        float softcap, int dtype, int vec, int instance,
                        int kv_same, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 3) {
    if (dtype != 1 || !vec || De != 0 || G != WIDE_G || D != WIDE_D ||
        Dv != WIDE_D || page != WIDE_PAGE || n_cols < 1 || B > 65535 ||
        reinterpret_cast<uintptr_t>(q) % 16)
      return (int)cudaErrorInvalidValue;
    return launch_wide(q, k, v, pos, table, q_pos, out, part, counter, B,
                       Hkv, n_cols, num_blocks, scale, window, softcap, s);
  }
  if (instance == 2) {
    if (dtype != 1 || !vec || !kv_same || page != MLA_PAGE || G % MLA_TH ||
        D != MLA_DV || Dv != MLA_DV || De < 8 || De > 64 || De % 8 ||
        n_cols < 1 || reinterpret_cast<uintptr_t>(q) % 16 ||
        reinterpret_cast<uintptr_t>(q_extra) % 16)
      return (int)cudaErrorInvalidValue;
    return launch_mla(q, k, pos, table, q_pos, q_extra, k_extra, out, part,
                      B, Hkv, G, De, n_cols, num_blocks, scale, window,
                      softcap, s);
  }
  if (instance == 1) {
    if (G < 1 || n_cols < 1 || page < 1 || !vec || Dv % 4 ||
        (kv_same && Dv > D))
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return launch_tiled_any<float>(kv_same != 0, q, k, v, pos, table, q_pos,
                                     q_extra, k_extra, out, part, B, Hkv, G,
                                     D, Dv, De, page, n_cols, num_blocks,
                                     scale, window, softcap, s);
    if (dtype == 1)
      return launch_tiled_any<__nv_bfloat16>(
          kv_same != 0, q, k, v, pos, table, q_pos, q_extra, k_extra, out,
          part, B, Hkv, G, D, Dv, De, page, n_cols, num_blocks, scale, window,
          softcap, s);
    return (int)cudaErrorInvalidValue;
  }
  if (G < 1 || G > MAX_GROUP || n_cols < 1 || page < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_any<float>(vec != 0, q, k, v, pos, table, q_pos, q_extra,
                             k_extra, out, part, counter, B, Hkv, G, D, Dv,
                             De, page, n_cols, num_blocks, scale, window,
                             softcap, s);
  if (dtype == 1)
    return launch_any<__nv_bfloat16>(vec != 0, q, k, v, pos, table, q_pos,
                                     q_extra, k_extra, out, part, counter, B,
                                     Hkv, G, D, Dv, De, page, n_cols,
                                     num_blocks, scale, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
