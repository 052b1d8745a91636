// RWKV6 wkv recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rwkv_scan` (src/repro/kernels/ssm_scan.py:131,
// body `_rwkv_kernel` :106).  It computes the same function: per (batch row
// b, head h) a float32 state S (hd x hd, [k-index i, v-index j]) walks the
// sequence, and per step t
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// Beyond the TPU kernel it starts from a given state s0 (the serving cache)
// instead of zeros, writes the final state, and leaves the final state of
// rows whose `rows` flag is 0 equal to s0 (idle serving slots).
//
// Bound on this card.  Each step reads r, k, v, w (hd values each) and
// writes o, the state is read once and written once.  The function needs
// 5 float32 flops per state element per step (2 for r.S, 3 for the update;
// the bonus term v[j] * sum_i r[i] u[i] k[i] is rank one, O(hd) per step),
// elementwise, with no tensor-core product in it.  At the decode shape
// (S = 1) the state traffic sets the floor; at a 128-token chunk bytes and
// operations come within 0.1% of each other, bytes just above.  (This first
// version spends 7 flops per element: it does not factor out the bonus.)
//
// Design (a straightforward first version: no cp.async / TMA, no split of
// the i sum across lanes):
// * one block of HD threads (HD = 32, 64 or 128, the smallest >= hd) per
//   (b, h); the TPU grid's sequential chunk axis becomes a loop inside the
//   block, and the state never leaves the chip between steps;
// * thread j owns column j of S in HD registers, so the update needs no
//   reduction across threads: o[j] is a register sum over i;
// * the block stages kSteps = 2048 / HD steps of r, k, w (and v) at a time
//   in shared memory as float32, one __syncthreads pair per stage; the
//   per-step reads of r_i, k_i, w_i, u_i are broadcasts (every thread reads
//   the same address), four at a time as float4;
// * rows i >= hd are staged as zeros, so they leave S untouched and add
//   nothing to o: any hd <= 128 runs without a guard in the inner loop;
// * the final state is written from registers at the end.  Every thread
//   reads its own state column before the walk and writes only that column
//   after it, so s_out may be s0 itself (the port writes the serving cache
//   in place).
// The multiply-adds may contract into fma, so roundings differ from the
// plain version's at the last bit.
//
// The C entry point returns the cudaError_t of the launch (0 = success);
// the Python wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

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

// one (i, j) element of a step: the output term, then the state update
__device__ __forceinline__ void cell(float& s, float& acc, float r, float k,
                                     float w, float u, float vj) {
  const float kv = k * vj;
  acc += r * (s + u * kv);
  s = w * s + kv;
}

template <typename Tin, typename Tout, int HD>
__global__ void __launch_bounds__(HD) rwkv_scan_kernel(
    const Tin* __restrict__ r, const Tin* __restrict__ k,
    const Tin* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0,
    const uint8_t* __restrict__ rows, float* s_out, Tout* __restrict__ o,
    int S, int H, int hd) {
  constexpr int kSteps = 2048 / HD;
  __shared__ __align__(16) float rs[kSteps][HD];
  __shared__ __align__(16) float ks[kSteps][HD];
  __shared__ __align__(16) float ws[kSteps][HD];
  __shared__ __align__(16) float vs[kSteps][HD];
  __shared__ __align__(16) float us[HD];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int j = threadIdx.x;
  const bool live = j < hd;
  const size_t state0 = ((size_t)b * H + h) * hd * hd;  // S[b, h, 0, 0]

  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    s[i] = (s0 != nullptr && live && i < hd) ? s0[state0 + (size_t)i * hd + j]
                                             : 0.f;
  us[j] = live ? u[(size_t)h * hd + j] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int nt = min(kSteps, S - t0);
    __syncthreads();  // the previous stage has been read
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const size_t at = (((size_t)b * S + t0 + tt) * H + h) * hd + j;
      rs[tt][j] = live ? to_f32(r[at]) : 0.f;
      ks[tt][j] = live ? to_f32(k[at]) : 0.f;
      vs[tt][j] = live ? to_f32(v[at]) : 0.f;
      ws[tt][j] = live ? w[at] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = vs[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[tt][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        cell(s[i + 0], acc, r4.x, k4.x, w4.x, u4.x, vj);
        cell(s[i + 1], acc, r4.y, k4.y, w4.y, u4.y, vj);
        cell(s[i + 2], acc, r4.z, k4.z, w4.z, u4.z, vj);
        cell(s[i + 3], acc, r4.w, k4.w, w4.w, u4.w, vj);
      }
      if (live)
        o[(((size_t)b * S + t0 + tt) * H + h) * hd + j] = from_f32<Tout>(acc);
    }
  }

  if (s_out == nullptr || !live) return;
  const bool update = rows == nullptr || rows[b] != 0;
  if (!update && s_out == s0) return;  // in place: the row keeps s0 as it is
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    if (i < hd) {
      const size_t at = state0 + (size_t)i * hd + j;
      s_out[at] = update ? s[i] : (s0 != nullptr ? s0[at] : 0.f);
    }
  }
}

template <typename Tin, typename Tout, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* rows, void* s_out,
           void* o, int B, int S, int H, int hd, cudaStream_t stream) {
  rwkv_scan_kernel<Tin, Tout, HD><<<B * H, HD, 0, stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<const uint8_t*>(rows), static_cast<float*>(s_out),
      static_cast<Tout*>(o), S, H, hd);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_hd(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, const void* rows, void* s_out,
              void* o, int B, int S, int H, int hd, cudaStream_t stream) {
  if (hd <= 32)
    return launch<Tin, Tout, 32>(r, k, v, w, u, s0, rows, s_out, o, B, S, H,
                                 hd, stream);
  if (hd <= 64)
    return launch<Tin, Tout, 64>(r, k, v, w, u, s0, rows, s_out, o, B, S, H,
                                 hd, stream);
  if (hd <= 128)
    return launch<Tin, Tout, 128>(r, k, v, w, u, s0, rows, s_out, o, B, S, H,
                                  hd, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename Tin>
int launch_out(int out_dtype, const void* r, const void* k, const void* v,
               const void* w, const void* u, const void* s0, const void* rows,
               void* s_out, void* o, int B, int S, int H, int hd,
               cudaStream_t stream) {
  if (out_dtype == 0)
    return launch_hd<Tin, float>(r, k, v, w, u, s0, rows, s_out, o, B, S, H,
                                 hd, stream);
  if (out_dtype == 1)
    return launch_hd<Tin, __nv_bfloat16>(r, k, v, w, u, s0, rows, s_out, o, B,
                                         S, H, hd, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// r, k, v: (B, S, H, hd) of in_dtype; w: (B, S, H, hd) float32; u: (H, hd)
// float32; s0: (B, H, hd, hd) float32 or null (zeros); rows: (B,) uint8 or
// null (every row updates); s_out: (B, H, hd, hd) float32 or null (no state
// out), and may equal s0; o: (B, S, H, hd) of out_dtype.  Dtype codes:
// 0 = float32, 1 = bfloat16.  1 <= hd <= 128, S >= 1.  Returns the
// cudaError_t of the launch.
int rwkv_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, const void* rows, void* s_out,
                  void* o, int B, int S, int H, int hd, int in_dtype,
                  int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || hd < 1 || hd > 128)
    return (int)cudaErrorInvalidValue;
  if (in_dtype == 0)
    return launch_out<float>(out_dtype, r, k, v, w, u, s0, rows, s_out, o, B,
                             S, H, hd, st);
  if (in_dtype == 1)
    return launch_out<__nv_bfloat16>(out_dtype, r, k, v, w, u, s0, rows, s_out,
                                     o, B, S, H, hd, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
