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
// * `paged_mma_kernel`, on the tensor cores (bf16, K is V, 16-row pages):
//   grid (B * Hkv * G / 64, n_splits), the same fixed splits of
//   PAGES_PER_SPLIT columns, a block of 4 warps takes 64 query heads, a warp
//   16 (mma.sync m16n8k16's M).  The tile's q rows and the split's 64 K rows
//   ([latent | rope], one 16-byte unit of padding a row, so ldmatrix's 8
//   rows hit 8 bank groups) are staged once by cp.async: 148 KB.  Scores
//   take 36 k-steps of 16, the softmax runs on the score registers (quad
//   shuffles), P goes to bf16 straight from them as the A operand of P.V,
//   and V is the staged K rows' first Dv columns, read by transposed
//   ldmatrix, 128 columns at a time.  Rounding P to bf16 moves the output
//   by about 2^-9 of its scale;
// * `paged_tiled_kernel`, on the CUDA cores (float32, which the tensor
//   cores would round, and shapes the tensor-core instance does not take):
//   16 heads a block, q staged as f32, a thread per row and 8 heads for the
//   scores, per 4 columns of V and all 16 heads for P.V, rows in order; K
//   and V staged once when they are one tensor;
// * both write each live split's partial per head tile (16 x (Dv + 2) or
//   64 x (Dv + 2) floats: at B = 8 and 64 columns 33.7 MB at most) and
//   leave the merge to `paged_merge_kernel`, a block per query head, which
//   reads them in split order as the last block above does.  A merge in the
//   last split block, as above, read up to 2 MB of partials from one block
//   per head tile: most of the kernel's time at this shape.
// expf stays IEEE-accurate here too.  Per head, the split's max, exp and
// sum and the ordered merge are those above, so -1 columns stay neutral bit
// for bit and idle slots output exact zeros.
//
// The C entry points return the cudaError_t of the launch (0 = success);
// the Python wrapper raises on anything else.

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

// whether split s of a table row holds a column (block ids outside the pool
// count as -1, as in the kernel)
__device__ __forceinline__ bool split_live(const int32_t* row, int n_cols,
                                           int num_blocks, int s) {
  bool live = false;
#pragma unroll
  for (int j = 0; j < PAGES_PER_SPLIT; ++j) {
    const int c = s * PAGES_PER_SPLIT + j;
    if (c < n_cols) {
      const int x = row[c];
      live = live || (x >= 0 && x < num_blocks);
    }
  }
  return live;
}

// By warp 0: the live splits of chunk [s0, s0 + 32) of a table row, in
// split order, into `lst`; returns their number (on warp 0's lanes)
__device__ __forceinline__ int list_live(const int32_t* row, int n_cols,
                                         int num_blocks, int s0, int* lst) {
  const int lane = threadIdx.x & 31;
  const int n_splits = (n_cols + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT;
  const int s = s0 + lane;
  const bool live = s < n_splits && split_live(row, n_cols, num_blocks, s);
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
constexpr int MMA_TH = 64;  // of the tensor-core instance: 4 warps x 16
constexpr int MMA_R = 64;   // rows a split of it: PAGES_PER_SPLIT pages of 16

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

// ... and of one tensor-core block's: q and K rows in bf16, D + De
// elements padded by 8 (one 16-byte unit)
struct MmaSmem {
  size_t qs, ks, ok, total;
  __host__ __device__ MmaSmem(int D, int De) {
    const size_t KS = (size_t)D + De + 8;
    qs = 0;                                    // MMA_TH x KS
    ks = round16(qs + 2 * MMA_TH * KS);        // MMA_R x KS
    ok = round16(ks + 2 * MMA_R * KS);
    total = ok + sizeof(int) * MMA_R;
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tensor-core split kernel: bf16, K is V, 16-row pages, MMA_TH heads a
// block, a warp per 16 heads.
template <int TH>
__global__ void __launch_bounds__(kThreads, 1) paged_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const int32_t* __restrict__ pos, const int32_t* __restrict__ table,
    const int32_t* __restrict__ q_pos,
    const __nv_bfloat16* __restrict__ q_extra,
    const __nv_bfloat16* __restrict__ k_extra, float* __restrict__ part,
    int Hkv, int G, int D, int Dv, int De, int n_cols, int num_blocks,
    float scale, int window, float softcap) {
  static_assert(TH == 16 * (kThreads / 32), "a warp per 16 heads");
  using bf16 = __nv_bfloat16;
  constexpr int page = MMA_R / PAGES_PER_SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sblk[PAGES_PER_SPLIT];
  const MmaSmem L(D, De);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.qs);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.ks);
  int* ok = reinterpret_cast<int*>(smem + L.ok);

  const int QW = D + De, KS = D + De + 8;
  const int n_tiles = G / TH;
  const int ct = blockIdx.x;                 // (slot, kv head, head tile)
  const int bh = ct / n_tiles, tile = ct % n_tiles;
  const int b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head0 = (size_t)b * Hkv * G + (size_t)h * G + (size_t)tile * TH;
  const size_t part_stride = part_floats(TH, Dv);
  const int PM = TH * Dv, PL = TH * Dv + TH;
  float* my_part = part + ((size_t)ct * n_splits + split) * part_stride;

  const int qp = q_pos[b];
  if (!tiled_split_start(table + (size_t)b * n_cols, n_cols, num_blocks,
                         split, qp, sblk))
    return;  // an idle slot or a split with no column: nothing to merge

  // the tile's query rows [q | q_extra] and the split's rows [K | K_extra],
  // 16 bytes a cp.async; a -1 column's rows are zeros (its page is never
  // read), so the products over them are exact zeros
  {
    const int U = QW / 8;
    for (int x = tid; x < (TH + MMA_R) * U; x += kThreads) {
      const int r = x / U, e = (x % U) * 8;
      if (r < TH) {
        const size_t hq = head0 + r;
        cp_async16(qs + (size_t)r * KS + e,
                   e < D ? q + hq * D + e : q_extra + hq * De + (e - D));
      } else {
        const int rr = r - TH, bb = sblk[rr / page];
        bf16* dst = ks + (size_t)rr * KS + e;
        if (bb < 0) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          continue;
        }
        const size_t row = ((size_t)bb * page + rr % page) * Hkv + h;
        cp_async16(dst,
                   e < D ? k + row * D + e : k_extra + row * De + (e - D));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int r = tid; r < MMA_R; r += kThreads) {
    const int bb = sblk[r / page];
    const int p = bb >= 0 ? pos[(size_t)bb * page + r % page] : -1;
    ok[r] = (p >= 0) && (p <= qp) && (window <= 0 || p > qp - window);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores S (this warp's 16 heads x 64 rows) = [q | q_extra] . [K |
  // K_extra]^T on the tensor cores, (D + De) / 16 steps, then times scale,
  // softcap and mask.  Lane (g, c4) holds heads g and g + 8 of the warp,
  // rows 8 nt + 2 c4 + {0, 1} of each of the 8 row tiles
  const int g = lane >> 2, c4 = lane & 3;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
  {
    const bf16* qa =
        qs + (size_t)(warp * 16 + (lane & 15)) * KS + (lane >> 4) * 8;
    const bf16* kb = ks + (size_t)((lane >> 4) * 8 + (lane & 7)) * KS +
                     ((lane >> 3) & 1) * 8;
#pragma unroll 2
    for (int kk = 0; kk < QW / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, kb + (size_t)np * 16 * KS + kk * 16);
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }
  }
  float m0 = kNegInf, m1 = kNegInf;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool live = ok[nt * 8 + 2 * c4 + j];
      float y0 = s[nt][j] * scale, y1 = s[nt][2 + j] * scale;
      if (softcap > 0.f) {
        y0 = softcap * tanhf(y0 / softcap);
        y1 = softcap * tanhf(y1 / softcap);
      }
      s[nt][j] = live ? y0 : kNegInf;
      s[nt][2 + j] = live ? y1 : kNegInf;
      m0 = fmaxf(m0, s[nt][j]);
      m1 = fmaxf(m1, s[nt][2 + j]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool live = ok[nt * 8 + 2 * c4 + j];
      const float p0 = live ? expf(s[nt][j] - m0) : 0.f;
      const float p1 = live ? expf(s[nt][2 + j] - m1) : 0.f;
      s[nt][j] = p0;
      s[nt][2 + j] = p1;
      l0 += p0;
      l1 += p1;
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (c4 == 0) {
    my_part[PM + warp * 16 + g] = m0;
    my_part[PM + warp * 16 + g + 8] = m1;
    my_part[PL + warp * 16 + g] = l0;
    my_part[PL + warp * 16 + g + 8] = l1;
  }

  // acc_s = P . V on the tensor cores: P (bf16) straight from the score
  // registers as the A operand (two row tiles make one 16-row step, one
  // page), V = the staged K rows' first Dv columns by transposed ldmatrix,
  // 128 columns of V at a time; a -1 column's page is skipped
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
  const bf16* vb = ks + (size_t)(lane & 15) * KS + (lane >> 4) * 8;
  for (int n0 = 0; n0 < Dv; n0 += 128) {
    float acc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (sblk[kk] < 0) continue;
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vb + (size_t)kk * 16 * KS + n0 + np * 16);
        mma_bf16(acc[2 * np], pa[kk], bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], pa[kk], bf[2], bf[3]);
      }
    }
    float* r0 = my_part + (size_t)(warp * 16 + g) * Dv + n0 + 2 * c4;
    float* r1 = r0 + (size_t)8 * Dv;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      *reinterpret_cast<float2*>(r0 + nt * 8) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(r1 + nt * 8) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// The merge of the head-tiled instances, launched after their split kernel:
// a block per (slot, kv head, query head), a thread per 4 output columns.
// The live splits are taken MERGE_CHUNK at a time in split order, each
// chunk in the two-pass form against the running max (M = max m_s, the
// sums rescaled by e^(M_old - M)): with up to 128 columns, one chunk, it is
// M = max m_s, l = sum l_s e^(m_s - M), o = sum acc_s e^(m_s - M) / max(l,
// 1e-30) exactly.  A live split whose rows are all masked has l_s = 0 and
// acc_s = 0 and adds exactly 0; an idle slot, or a row with no column,
// outputs exact zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(
    const float* __restrict__ part, const int32_t* __restrict__ table,
    const int32_t* __restrict__ q_pos, T* __restrict__ out, int Hkv, int G,
    int TH, int Dv, int n_cols, int num_blocks) {
  __shared__ int lst[MERGE_CHUNK];
  __shared__ int n_live;
  const int hq = blockIdx.x;                 // (slot, kv head, head)
  const int bh = hq / G, gh = hq % G;
  const int b = bh / Hkv;
  const int n_tiles = (G + TH - 1) / TH;
  const int ct = bh * n_tiles + gh / TH, gi = gh % TH;
  const int n_splits = (n_cols + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT;
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
      if (tid < 32) {
        const int n = list_live(trow, n_cols, num_blocks, s0, lst);
        if (tid == 0) n_live = n;
      }
      __syncthreads();
      const int n = n_live;
      if (n == 0) continue;
      float Mn = M;
      for (int j = 0; j < n; ++j)
        Mn = fmaxf(Mn, pb[(size_t)lst[j] * part_stride + PM]);
      const float alpha = expf(M - Mn);
      l *= alpha;
      a.x *= alpha, a.y *= alpha, a.z *= alpha, a.w *= alpha;
#pragma unroll 4
      for (int j = 0; j < n && mine; ++j) {
        const float* ps = pb + (size_t)lst[j] * part_stride;
        const float w = expf(ps[PM] - Mn);
        const float4 y =
            *reinterpret_cast<const float4*>(ps + (size_t)gi * Dv + 4 * x);
        l += ps[PL] * w;
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

template <typename T>
int launch_merge(const void* part, const void* table, const void* q_pos,
                 void* out, int B, int Hkv, int G, int TH, int Dv, int n_cols,
                 int num_blocks, cudaStream_t stream) {
  paged_merge_kernel<T><<<B * Hkv * G, kThreads, 0, stream>>>(
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
  return launch_merge<T>(part, table, q_pos, out, B, Hkv, G, TILE_G, Dv,
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

int launch_mma(const void* q, const void* k, const void* pos,
               const void* table, const void* q_pos, const void* q_extra,
               const void* k_extra, void* out, void* part, int B, int Hkv,
               int G, int D, int Dv, int De, int n_cols, int num_blocks,
               float scale, int window, float softcap, cudaStream_t stream) {
  const size_t smem = MmaSmem(D, De).total;
  auto kernel = paged_mma_kernel<MMA_TH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_splits = (n_cols + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT;
  kernel<<<dim3(B * Hkv * (G / MMA_TH), n_splits), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(q_pos),
      static_cast<const __nv_bfloat16*>(q_extra),
      static_cast<const __nv_bfloat16*>(k_extra), static_cast<float*>(part),
      Hkv, G, D, Dv, De, n_cols, num_blocks, scale, window, softcap);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return launch_merge<__nv_bfloat16>(part, table, q_pos, out, B, Hkv, G,
                                     MMA_TH, Dv, n_cols, num_blocks, stream);
}

}  // namespace

extern "C" {

// Query heads a block of the head-tiled instance takes.
int paged_attention_tile_heads() { return TILE_G; }

// Query heads and rows a block of the tensor-core instance takes.
int paged_attention_mma_heads() { return MMA_TH; }
int paged_attention_mma_rows() { return MMA_R; }

// Bytes of dynamic shared memory one block of the tensor-core instance
// needs.
long long paged_attention_mma_smem_bytes(int D, int De) {
  return (long long)MmaSmem(D, De).total;
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
// G; vec rows only), instance 2: the tensor-core one (bf16, kv_same, page
// MMA_R / PAGES_PER_SPLIT, G a multiple of MMA_TH, (D + De) % 16 == 0,
// Dv % 128 == 0, Dv <= D, 16-byte aligned q / q_extra).  Each launches its
// split kernel and the merge kernel; their scratch is per (slot, kv head,
// head tile of TILE_G or MMA_TH heads), each split's partial
// paged_attention_part_floats(heads, Dv) floats, and they take no counter.
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
    if (dtype != 1 || !vec || !kv_same || page * PAGES_PER_SPLIT != MMA_R ||
        G % MMA_TH || (D + De) % 16 || Dv % 128 || Dv > D || n_cols < 1)
      return (int)cudaErrorInvalidValue;
    return launch_mma(q, k, pos, table, q_pos, q_extra, k_extra, out, part,
                      B, Hkv, G, D, Dv, De, n_cols, num_blocks, scale, window,
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
