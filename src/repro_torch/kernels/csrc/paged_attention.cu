// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_fwd`
// (src/repro/kernels/paged_attention.py:201, body `_paged_decode_kernel`
// :139).  It computes the same function: for each serving slot, one query
// token attends over a paged K/V pool read through the slot's block
// table, with an online softmax in float32.  Mask: block >= 0, pos >= 0,
// pos <= q_pos, and pos > q_pos - window for sliding-window layers.
// Options: tanh softcap, and a second score contraction
// q_extra . k_extra^T (the MLA rope term).  Finalize: acc / max(l, 1e-30).
//
// Bound on this card: the bytes of the K/V pages it reads (each allocated
// page read once per kv head, the G query heads of that kv head share the
// read), over the 3.35 TB/s of HBM.  The arithmetic is 2 flops per byte
// of K/V at G = 4, far below the ridge point, so the bytes set the floor.
//
// Design (a straightforward first version, no wgmma / TMA / split-K):
// * one thread block per (slot, kv head); the TPU grid's sequential page
//   axis becomes a loop inside the block over the slot's table columns,
//   and the block reads its own table row and q_pos (the TPU kernel's
//   scalar prefetch);
// * the G query rows, scaled, are staged in shared memory as f32;
// * per column: the page's K (page, D), V (page, Dv), [K_extra] and
//   positions are loaded into shared memory as f32.  Each thread first
//   issues a batch of independent loads (16 bytes each where the head
//   dims and pointers allow) and only then converts and stores them, so
//   a page costs about one memory latency, not one per element;
// * G x page scores by one warp per (query head, row) with a shuffle
//   reduction; softcap and mask; the online-softmax update by one warp
//   per query head; acc (G, Dv) kept in shared memory;
// * a -1 table column is skipped (exactly neutral: the reference's fully
//   masked page has alpha = exp(0) = 1 and p = 0); an idle slot
//   (q_pos < 0) writes exact zeros, as the reference's 0 / 1e-30 does.
// The pages of one slot are still walked one after another by one block,
// and only B * Hkv blocks run: splitting the walk (split-K) and
// overlapping the next page's loads with this page's math are the next
// steps.  expf / tanhf / division stay IEEE-accurate: no --use_fast_math.
//
// The C entry points return the cudaError_t of the launch (0 = success);
// the Python wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBatch = 4;  // loads each thread keeps in flight

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// floats of dynamic shared memory one block uses (ints share the slots)
__host__ __device__ inline size_t smem_floats(int G, int D, int Dv, int De,
                                              int page) {
  return (size_t)G * D + (size_t)G * De        // q, q_extra (scaled)
         + (size_t)page * (D + De + Dv)        // K, K_extra, V page
         + (size_t)G * page                    // scores -> probabilities
         + (size_t)G * Dv                      // acc
         + 2 * (size_t)G                       // m, l
         + (size_t)page;                       // per-row mask
}

// One page (K, V and K_extra rows of kv head h) as load units U of
// sizeof(U) / sizeof(T) elements: unit i of the concatenated K | V | K_extra
// index space -> its source in the pool and its f32 destination.
template <typename T, typename U>
struct PageUnits {
  static constexpr int E = sizeof(U) / sizeof(T);
  const T* k;
  const T* v;
  const T* ke;
  float* ks;
  float* vs;
  float* kes;
  size_t row0;
  int Hkv, h, D, Dv, De, nk, nv, n;

  __device__ PageUnits(const T* k_, const T* v_, const T* ke_, float* ks_,
                       float* vs_, float* kes_, size_t row0_, int page,
                       int Hkv_, int h_, int D_, int Dv_, int De_)
      : k(k_), v(v_), ke(ke_), ks(ks_), vs(vs_), kes(kes_), row0(row0_),
        Hkv(Hkv_), h(h_), D(D_), Dv(Dv_), De(De_) {
    nk = page * (D / E);
    nv = page * (Dv / E);
    n = nk + nv + page * (De / E);
  }

  __device__ __forceinline__ void locate(int i, const U*& src,
                                         float*& dst) const {
    const T* base;
    float* out;
    int W;
    if (i < nk) {
      base = k, out = ks, W = D;
    } else if (i < nk + nv) {
      i -= nk, base = v, out = vs, W = Dv;
    } else {
      i -= nk + nv, base = ke, out = kes, W = De;
    }
    const int w = W / E, r = i / w, c = i - r * w;
    src = reinterpret_cast<const U*>(base + ((row0 + r) * Hkv + h) * W) + c;
    dst = out + (size_t)r * W + (size_t)c * E;
  }

  // every thread issues up to kBatch independent loads, then converts
  __device__ __forceinline__ void load() const {
    for (int b0 = threadIdx.x; b0 < n; b0 += kBatch * blockDim.x) {
      U buf[kBatch];
      const U* src;
      float* dst;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = b0 + j * blockDim.x;
        if (i < n) {
          locate(i, src, dst);
          buf[j] = __ldg(src);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = b0 + j * blockDim.x;
        if (i < n) {
          locate(i, src, dst);
          const T* e = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
          for (int t = 0; t < E; ++t) dst[t] = to_f32(e[t]);
        }
      }
    }
  }
};

template <typename T, typename U>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ table, const int32_t* __restrict__ q_pos,
    const T* __restrict__ q_extra, const T* __restrict__ k_extra,
    T* __restrict__ out, int Hkv, int G, int D, int Dv, int De, int page,
    int n_cols, int num_blocks, float scale, int window, float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* qes = qs + (size_t)G * D;
  float* ks = qes + (size_t)G * De;
  float* kes = ks + (size_t)page * D;
  float* vs = kes + (size_t)page * De;
  float* sc = vs + (size_t)page * Dv;
  float* acc = sc + (size_t)G * page;
  float* m = acc + (size_t)G * Dv;
  float* l = m + G;
  int* ok = reinterpret_cast<int*>(l + G);

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t head0 = (size_t)b * Hq + (size_t)h * G;  // first query head row
  T* o = out + head0 * Dv;

  const int qp = q_pos[b];
  if (qp < 0) {  // idle slot: every key is masked, the output is exactly 0
    for (int i = tid; i < G * Dv; i += blockDim.x) o[i] = from_f32<T>(0.f);
    return;
  }

  for (int i = tid; i < G * D; i += blockDim.x)
    qs[i] = to_f32(q[head0 * D + i]) * scale;
  for (int i = tid; i < G * De; i += blockDim.x)
    qes[i] = to_f32(q_extra[head0 * De + i]) * scale;
  for (int i = tid; i < G * Dv; i += blockDim.x) acc[i] = 0.f;
  for (int g = tid; g < G; g += blockDim.x) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  __syncthreads();

  const int32_t* trow = table + (size_t)b * n_cols;
  for (int c = 0; c < n_cols; ++c) {
    const int blk = trow[c];
    if (blk < 0 || blk >= num_blocks) continue;  // unallocated: neutral
    const size_t row0 = (size_t)blk * page;      // first pool row of the page

    PageUnits<T, U>(k, v, k_extra, ks, vs, kes, row0, page, Hkv, h, D, Dv,
                    De)
        .load();
    for (int r = tid; r < page; r += blockDim.x) {
      const int p = pos[row0 + r];
      ok[r] = (p >= 0) && (p <= qp) && (window <= 0 || p > qp - window);
    }
    __syncthreads();

    // scores: one warp per (query head g, page row r)
    for (int pr = warp; pr < G * page; pr += nwarps) {
      const int g = pr / page, r = pr - g * page;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[g * D + d] * ks[r * D + d];
      s = warp_sum(s);
      if (De > 0) {
        float se = 0.f;
        for (int d = lane; d < De; d += 32) se += qes[g * De + d] * kes[r * De + d];
        s += warp_sum(se);
      }
      if (lane == 0) {
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        sc[pr] = ok[r] ? s : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax update, one warp per query head; rescale acc here
    for (int g = warp; g < G; g += nwarps) {
      const float m_prev = m[g];
      float mx = kNegInf;
      for (int r = lane; r < page; r += 32) mx = fmaxf(mx, sc[g * page + r]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f;
      for (int r = lane; r < page; r += 32) {
        const float p = ok[r] ? expf(sc[g * page + r] - m_new) : 0.f;
        sc[g * page + r] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      const float alpha = expf(m_prev - m_new);
      for (int d = lane; d < Dv; d += 32) acc[g * Dv + d] *= alpha;
      if (lane == 0) {
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * Dv; i += blockDim.x) {
      const int g = i / Dv, d = i - g * Dv;
      float pv = 0.f;
      for (int r = 0; r < page; ++r) pv += sc[g * page + r] * vs[r * Dv + d];
      acc[i] += pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * Dv; i += blockDim.x) {
    const int g = i / Dv;
    o[i] = from_f32<T>(acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T, typename U>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* table, const void* q_pos, const void* q_extra,
           const void* k_extra, void* out, int B, int Hkv, int G, int D,
           int Dv, int De, int page, int n_cols, int num_blocks, float scale,
           int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats(G, D, Dv, De, page) * sizeof(float);
  auto kernel = paged_decode_kernel<T, U>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(q_pos),
      static_cast<const T*>(q_extra), static_cast<const T*>(k_extra),
      static_cast<T*>(out), Hkv, G, D, Dv, De, page, n_cols, num_blocks,
      scale, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(bool vec, const void* q, const void* k, const void* v,
               const void* pos, const void* table, const void* q_pos,
               const void* q_extra, const void* k_extra, void* out, int B,
               int Hkv, int G, int D, int Dv, int De, int page, int n_cols,
               int num_blocks, float scale, int window, float softcap,
               cudaStream_t s) {
  return vec ? launch<T, uint4>(q, k, v, pos, table, q_pos, q_extra, k_extra,
                                out, B, Hkv, G, D, Dv, De, page, n_cols,
                                num_blocks, scale, window, softcap, s)
             : launch<T, T>(q, k, v, pos, table, q_pos, q_extra, k_extra, out,
                            B, Hkv, G, D, Dv, De, page, n_cols, num_blocks,
                            scale, window, softcap, s);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel needs.
long long paged_attention_smem_bytes(int G, int D, int Dv, int De, int page) {
  return (long long)(smem_floats(G, D, Dv, De, page) * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when D, Dv, De are multiples
// of 16 bytes of elements and k / v / k_extra are 16-byte aligned (loads
// go 16 bytes at a time), else 0.  q_extra / k_extra may be null when
// De == 0.  Returns the cudaError_t of the launch.
int paged_attention_fwd(const void* q, const void* k, const void* v,
                        const void* pos, const void* table, const void* q_pos,
                        const void* q_extra, const void* k_extra, void* out,
                        int B, int Hkv, int G, int D, int Dv, int De, int page,
                        int n_cols, int num_blocks, float scale, int window,
                        float softcap, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_any<float>(vec != 0, q, k, v, pos, table, q_pos, q_extra,
                             k_extra, out, B, Hkv, G, D, Dv, De, page, n_cols,
                             num_blocks, scale, window, softcap, s);
  if (dtype == 1)
    return launch_any<__nv_bfloat16>(vec != 0, q, k, v, pos, table, q_pos,
                                     q_extra, k_extra, out, B, Hkv, G, D, Dv,
                                     De, page, n_cols, num_blocks, scale,
                                     window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
