// Per-block absmax int8 quantization and its inverse, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `int8_quantize` (src/repro/kernels/quantize.py:36,
// body `_quant_kernel` :22) and `int8_dequantize` (:63, body `_dequant_kernel`
// :31), the §2.3 communication-compression hot path.  They compute the same
// functions.  The input, flattened, is cut into rows of `block` consecutive
// elements (the last row zero-padded); per row
//     scale   = absmax / 127 + 1e-12                      (float32)
//     code[i] = clip(round_half_even(x[i] / scale), -127, 127)   (int8)
// and the inverse writes code * scale, cast to the output type, for the first
// n elements only.
//
// Arithmetic.  Both divisions are IEEE round-to-nearest (`__fdiv_rn`; the
// build has no fast-math), the rounding is `rintf` (half to even, as
// `jnp.round` and `torch.round`), so the codes and scales equal the eager
// JAX function `repro.core.compression.int8_block_encode` bit for bit.  (A
// jitted JAX version may multiply by f32(1/127) instead of dividing, which
// moves a scale by one ulp.)  A NaN anywhere in a row makes its scale NaN,
// as `jnp.max` does (`fmaxf` alone would drop it), and a code whose quotient
// is NaN is 0, as XLA's and the plain version's float-to-int conversion give.
//
// Bound on this card: bytes.  Encode reads the input once and writes a code
// per element plus a scale per row (3.016 B per element from bf16 at block
// 256); decode reads a code per element and a scale per row and writes the
// output (5.016 B per element to float32).  A handful of float32 operations
// per element is far below the card's rate.
//
// Design (a simple first version: no TMA, no persistent grid):
// * encode: one warp per row.  Lanes read 16-byte vectors (8 bf16 or 4
//   float32 values) where the row is 16-byte aligned and `block` is a
//   multiple of the vector, strided scalars otherwise; the absmax is a
//   __shfl_xor_sync reduction in float32; a second pass over the row (now in
//   L1) writes the codes, 8 or 4 bytes per vector.  The padded tail of the
//   last row is read as 0 and never from memory.
// * decode: one thread per 8 codes (one 8-byte load, one or two 16-byte
//   stores) where `block` is a multiple of 8, so that the 8 codes share a
//   row and its scale; a scalar walk otherwise.  Only the first n outputs
//   are written.
// * every element index is 64-bit: a gradient of more than 2^31 elements
//   is one launch.
//
// The C entry points return the cudaError_t of the launch (0 = success);
// the Python wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kDecodeThreads = 256;
constexpr int kCodesPerThread = 8;

template <int IN_BF16>
__device__ __forceinline__ float load_scalar(const void* x, int64_t i) {
  if (IN_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  return static_cast<const float*>(x)[i];
}

// 16 bytes of input at element i (16-byte aligned) as float32 values
template <int IN_BF16>
__device__ __forceinline__ void load_vec(const void* x, int64_t i, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(
      static_cast<const char*>(x) + i * (IN_BF16 ? 2 : 4));
  if (IN_BF16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = f[j];
  }
}

__device__ __forceinline__ int8_t code_of(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  if (isnan(r)) return 0;
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

template <int IN_BF16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
absmax_quantize_kernel(const void* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scales, int64_t n, int64_t rows,
                       int block, int vec_ok) {
  constexpr int VEC = IN_BF16 ? 8 : 4;   // elements per 16-byte load
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t start = row * block;
  const int64_t valid = n - start < block ? n - start : block;  // >= 1
  const bool vec = vec_ok && valid == block;

  // pass 1: absmax (and whether the row holds a NaN)
  float amax = 0.f;
  bool nan = false;
  if (vec) {
    for (int c = lane * VEC; c < block; c += 32 * VEC) {
      float v[VEC];
      load_vec<IN_BF16>(x, start + c, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        nan |= isnan(v[j]);
        amax = fmaxf(amax, fabsf(v[j]));
      }
    }
  } else {
    for (int c = lane; c < valid; c += 32) {
      const float v = load_scalar<IN_BF16>(x, start + c);
      nan |= isnan(v);
      amax = fmaxf(amax, fabsf(v));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  nan = __any_sync(0xffffffffu, nan);
  const float scale = nan ? __int_as_float(0x7fc00000)
                          : __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
  if (lane == 0) scales[row] = scale;

  // pass 2: codes (the padded tail codes 0 / scale)
  int8_t* qr = q + start;
  if (vec) {
    for (int c = lane * VEC; c < block; c += 32 * VEC) {
      float v[VEC];
      load_vec<IN_BF16>(x, start + c, v);
      union { int8_t b[VEC]; uint2 u2; uint32_t u1; } out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) out.b[j] = code_of(v[j], scale);
      if (VEC == 8)
        *reinterpret_cast<uint2*>(qr + c) = out.u2;
      else
        *reinterpret_cast<uint32_t*>(qr + c) = out.u1;
    }
  } else {
    for (int c = lane; c < block; c += 32) {
      const float v = c < valid ? load_scalar<IN_BF16>(x, start + c) : 0.f;
      qr[c] = code_of(v, scale);
    }
  }
}

template <int OUT_BF16>
__device__ __forceinline__ void store_scalar(void* out, int64_t i, float v) {
  if (OUT_BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// vec_ok: block % 8 == 0 and q / out aligned for 8- and 16-byte accesses
template <int OUT_BF16>
__global__ void __launch_bounds__(kDecodeThreads)
absmax_dequantize_kernel(const int8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         void* __restrict__ out, int64_t n, int block,
                         int vec_ok) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kDecodeThreads + threadIdx.x) *
      kCodesPerThread;
  if (i0 >= n) return;
  if (vec_ok && i0 + kCodesPerThread <= n) {
    const float s = scales[i0 / block];
    const uint2 raw = *reinterpret_cast<const uint2*>(q + i0);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
    float v[kCodesPerThread];
#pragma unroll
    for (int j = 0; j < kCodesPerThread; ++j)
      v[j] = __fmul_rn(static_cast<float>(c[j]), s);
    if (OUT_BF16) {
      uint4 o;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + i0) = o;
    } else {
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + i0);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    return;
  }
  int64_t row = i0 / block;
  int off = static_cast<int>(i0 - row * block);
  for (int64_t i = i0; i < i0 + kCodesPerThread && i < n; ++i) {
    store_scalar<OUT_BF16>(out, i,
                           __fmul_rn(static_cast<float>(q[i]), scales[row]));
    if (++off == block) {
      off = 0;
      ++row;
    }
  }
}

}  // namespace

extern "C" {

// x: n elements of in_dtype (0 = float32, 1 = bfloat16); q: (rows, block)
// int8 and scales: (rows,) float32 with rows = ceil(n / block).  vec_ok: the
// caller vouches that x is 16-byte aligned and block is a multiple of 8.
// Returns the cudaError_t of the launch.
int int8_quantize_fwd(const void* x, void* q, void* scales, int64_t n,
                      int64_t rows, int block, int in_dtype, int vec_ok,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || block < 1 || rows != (n + block - 1) / block)
    return (int)cudaErrorInvalidValue;
  const int64_t grid = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 g(static_cast<unsigned>(grid)), b(kWarpsPerBlock * 32);
  if (in_dtype == 0)
    absmax_quantize_kernel<0><<<g, b, 0, st>>>(x, static_cast<int8_t*>(q),
                                              static_cast<float*>(scales), n,
                                              rows, block, vec_ok);
  else if (in_dtype == 1)
    absmax_quantize_kernel<1><<<g, b, 0, st>>>(x, static_cast<int8_t*>(q),
                                              static_cast<float*>(scales), n,
                                              rows, block, vec_ok);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q: (rows, block) int8 and scales: (rows,) float32, rows * block >= n;
// out: n elements of out_dtype (0 = float32, 1 = bfloat16).  vec_ok: the
// caller vouches that block is a multiple of 8, q is 8-byte aligned and out
// 16-byte aligned.  Returns the cudaError_t of the launch.
int int8_dequantize_fwd(const void* q, const void* scales, void* out,
                        int64_t n, int block, int out_dtype, int vec_ok,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || block < 1) return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)kDecodeThreads * kCodesPerThread;
  const int64_t grid = (n + per_block - 1) / per_block;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 g(static_cast<unsigned>(grid)), b(kDecodeThreads);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  if (out_dtype == 0)
    absmax_dequantize_kernel<0><<<g, b, 0, st>>>(qc, sc, out, n, block, vec_ok);
  else if (out_dtype == 1)
    absmax_dequantize_kernel<1><<<g, b, 0, st>>>(qc, sc, out, n, block, vec_ok);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
