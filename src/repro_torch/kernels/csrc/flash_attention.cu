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
// by operations: 278 us at the bf16 tensor-core peak.  This first version
// multiplies on the CUDA cores in float32 (67 TFLOP/s peak, at least 4.1 ms
// here), so it sits far above that bound; tensor cores come later.
//
// Design (a straightforward first version: no tensor cores, no cp.async / TMA,
// no double buffering):
// * one block of 256 threads per (b, q head, 64-row q tile); the TPU grid's
//   sequential kv axis becomes a loop inside the block over 64-row kv tiles.
//   Blocks of the last q tiles (the longest causal walks) start first;
// * kv tiles entirely above the causal diagonal or entirely behind the window
//   are skipped.  The TPU kernel walks them, but a fully masked tile adds
//   exactly nothing there (alpha = 1, p = 0), so skipping them changes no bit;
// * the q tile, one K tile and one V tile are staged in shared memory as
//   float32 (rows and columns outside S, T and D as zeros, which add nothing);
//   K rows are padded by 4 floats so that the 8 lanes of a 16-byte load phase
//   read 8 different bank groups;
// * thread (ty, tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3: it
//   computes their scores against kv rows tx, tx + 16, tx + 32, tx + 48 and
//   their output columns 64 c + 4 tx .. 64 c + 4 tx + 3.  Row max and row sum
//   reduce over the 16 lanes of a half warp by shuffles, so every thread keeps
//   its rows' running max m, sum l and its slice of the accumulator in
//   registers;
// * P goes through shared memory (over the K tile, which is free by then) to
//   the P.V product.
// The multiply-adds contract into fma and the sums run in another order than
// the plain version's, so results differ from it in the last bits.
//
// The C entry point returns the cudaError_t of the launch (0 = success); the
// Python wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

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

}  // namespace

extern "C" {

// Dynamic shared memory one block takes for head dim D (0 if D > 256).
long long flash_attention_smem_bytes(int D) {
  if (D <= 64) return (long long)Layout<64>::BYTES;
  if (D <= 128) return (long long)Layout<128>::BYTES;
  if (D <= 256) return (long long)Layout<256>::BYTES;
  return 0;
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
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse_f, B, Hq, Hkv, S, T, D, scale,
                           causal, window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, lse_f, B, Hq, Hkv, S, T, D,
                                   scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
