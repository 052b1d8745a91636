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
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head0 = (size_t)b * Hq + (size_t)h * G;  // first query head row
  T* o = out + head0 * Dv;
  // a split's partial: acc[G][Dv], m[G], l[G], on 16-byte strides
  const size_t part_stride = part_floats(G, Dv);
  const int PM = G * Dv, PL = G * Dv + G;              // offsets of m and l
  float* my_part = part + ((size_t)bh * n_splits + split) * part_stride;

  // the slot's q_pos and this split's table columns, loaded together
  const int qp = q_pos[b];
  int blk[PAGES_PER_SPLIT];
  bool any = false;
#pragma unroll
  for (int j = 0; j < PAGES_PER_SPLIT; ++j) {
    const int c = split * PAGES_PER_SPLIT + j;
    const int x = c < n_cols ? table[(size_t)b * n_cols + c] : -1;
    blk[j] = (x < 0 || x >= num_blocks) ? -1 : x;
    any = any || blk[j] >= 0;
  }
  if (qp < 0) {  // idle slot: every key is masked, the output is exactly 0
    if (split == 0)
      for (int i = tid; i < G * Dv; i += blockDim.x) o[i] = from_f32<T>(0.f);
    return;
  }
  if (!any) {
    // no table column: this split adds nothing and takes no part in the
    // merge.  A row with no column at all outputs exact zeros (0 / 1e-30)
    if (split != 0) return;
    if (warp == 0) {
      int n = 0;
      for (int s0 = 0; s0 < n_splits; s0 += MERGE_CHUNK)
        n += list_live(table + (size_t)b * n_cols, n_cols, num_blocks, s0,
                       lst);
      if (lane == 0) flag[0] = n;
    }
    __syncthreads();
    if (flag[0] == 0)
      for (int i = tid; i < G * Dv; i += blockDim.x) o[i] = from_f32<T>(0.f);
    return;
  }

  load_rows<T, VEC, SWZ>(k, v, k_extra, ks, vs, kes, blk, page, Hkv, h, D,
                         Dv, De);
  if (VEC) asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the merge's count of live splits, and the list of the first chunk,
  // by warp 0 while the copies are in flight
  const int32_t* trow = table + (size_t)b * n_cols;
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
  // the partials.  The block's stores are ordered before thread 0's
  // counter update by the barrier, and that update releases them to the
  // device and acquires the other blocks' (one acq_rel atomic, no fence
  // in every thread)
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counter + bh)
                 : "memory");
    flag[0] = prev == flag[0] - 1;
  }
  __syncthreads();
  if (!flag[0]) return;
  const float* pb = part + (size_t)bh * n_splits * part_stride;
  // Chunks of MERGE_CHUNK splits, in order; per chunk one round of loads:
  // warp 0 lists its live splits in split order (chunk 0's list is kept
  // from above), their acc go to shared memory (over K/V, free by now) by
  // cp.async, stage_n at a time, and their (m_s, l_s) beside them.  Then
  // the running max of each query head takes the chunk's m_s (rescaling
  // what was summed with alpha = e^(M_old - M)), the weights are
  // e^(m_s - M), l adds l_s x weight in split order, and each thread adds
  // the weighted acc of its K8 output elements in split order.  A live
  // split with l_s = 0 (every row masked) has acc_s = 0: it adds exactly 0,
  // as in the plain mirror, which skips it.  With one chunk this is the
  // two-pass merge M = max m_s, sum e^(m_s - M) (...) exactly.
  float* stage = reinterpret_cast<float*>(smem + L.ks);
  float* m_al = reinterpret_cast<float*>(smem + L.sc);  // [G], scores are done
  const bool vec_part = PM % 4 == 0;
  const int units = vec_part ? PM / 4 : PM;
  const int stage_n = max(1, (int)(L.sc - L.ks) / (4 * PM));
  const int n_chunks = (n_splits + MERGE_CHUNK - 1) / MERGE_CHUNK;
  const int n_first = flag[1];                 // live splits of chunk 0
  constexpr int K8 = 8;
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
          float* mnew = m_al + MAX_GROUP;
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
  if (tid == 0) counter[bh] = 0;
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

}  // namespace

extern "C" {

// Table columns per split (the wrapper sizes the scratch with it).
int paged_attention_pages_per_split() { return PAGES_PER_SPLIT; }

// Floats of scratch one split's partial takes.
long long paged_attention_part_floats(int G, int Dv) {
  return (long long)part_floats(G, Dv);
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
// G <= 16.  Returns the cudaError_t of the launch.
int paged_attention_fwd(const void* q, const void* k, const void* v,
                        const void* pos, const void* table, const void* q_pos,
                        const void* q_extra, const void* k_extra, void* out,
                        void* part, void* counter, int B, int Hkv, int G,
                        int D, int Dv, int De, int page, int n_cols,
                        int num_blocks, float scale, int window,
                        float softcap, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
