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
// rows whose `rows` flag is 0 equal to s0 (idle serving slots).  Every row's
// output is written, idle rows included.
//
// Bound on this card.  Each step reads r, k, v, w (hd values each) and
// writes o; the state is read once and written once.  The function needs
// 5 float32 flops per state element per step (an fma for r.S; a multiply
// and an fma for the update) plus O(hd) per step for the bonus term, with
// no tensor-core product in it.  At the served decode shape (B=8, S=1,
// H=64, hd=64) the 16.8 MB of state traffic sets the floor, 5.15 us; at a
// 128-token prefill chunk bytes (68.2 MB) and operations come within 0.1%
// of each other, 20.35 us.  The three instructions a state element costs
// issue at one warp instruction per clock per SM sub-partition, so every
// other instruction issued per element (shared-memory reads, reductions,
// staging) adds to that floor.
//
// Design (PERF.md has the measurements behind each point):
// * the bonus term is factored out of the element loop:
//     o_t[j] = sum_i r_t[i] S[i][j] + v_t[j] a_t,
//     a_t = sum_i r_t[i] u[i] k_t[i]
//   so a state element costs an fma for the output and a multiply and an
//   fma for the update; a_t is computed once per step for the block;
// * the state is split over lanes: a thread holds an 8-row x 4-column tile
//   of S in 32 registers, HD^2 / 32 threads per (b, h) (HD = 64 for
//   hd <= 64, else 128; 128 threads, 4 warps, at hd = 64), so no thread
//   spills and 16 warps run on an SM.  A quarter warp shares one row group,
//   so its float4 reads of a staged row are one 16-byte unit for all 8
//   lanes (a shared-memory read that replicates 8 distinct units in every
//   quarter costs 4 wavefronts);
// * o_t[j] sums over the HD / 8 row groups: each thread writes its 4
//   partial sums a step to shared memory (one float4), and one pass a
//   stage adds them in group order, adds v_t[j] a_t and writes the
//   outputs, 16 bytes a thread.  (A shuffle reduce-scatter after every
//   step, tried first, put a chain of dependent shuffles in each step.);
// * the state is loaded and stored as float4 rows of the tile, whole
//   32-byte sectors a warp instruction; every thread reads its tile before
//   the walk and writes only that tile after it, so s_out may be s0 itself
//   (the port writes the serving cache in place);
// * the sequence is staged T = 32768 / HD^2 steps at a time (8 at
//   hd = 64): 16-byte cp.async copies of r, k, v in their own dtype and of
//   w in float32 (element by element where hd or a pointer does not allow
//   them) into a ring of two stages.  Stage s + 2 is issued as soon as
//   stage s's slot is free, so it lands during stage s + 1.  The same pass
//   that reduces stage s converts stage s + 1 to float32 rows (zero past
//   hd, so any hd <= HD runs without a guard in the element loop) and
//   computes its a_t; two __syncthreads a stage;
// * the multiply-adds are fma: roundings differ from the plain version's
//   in the last bits, and the sums run in another order.
//   ref.rwkv_scan_split_ref is the plain mirror of this arithmetic.
// An 8-column tile (64 threads per head) measured slower (PERF.md).
//
// The C entry point returns the cudaError_t of the launch (0 = success);
// the Python wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>


namespace {

constexpr int kRows = 8;  // state rows per thread
constexpr int kCols = 4;  // state columns per thread (a multiple of 4)
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 4 consecutive values of a staged row as float32
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(a.x << 16);
  out[1] = __uint_as_float(a.x & 0xffff0000u);
  out[2] = __uint_as_float(a.y << 16);
  out[3] = __uint_as_float(a.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const unsigned*>(&a);
  x.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}

template <typename Tin, int HD>
struct Stage {
  static constexpr int T = 32768 / (HD * HD);  // steps per stage: 8 or 2
  static constexpr int RG = HD / kRows;        // row groups
  Tin rkv[2][3][T][HD];      // ring of raw r, k, v stages
  float w[2][T][HD];         // ring of raw w stages (zero past hd)
  float f[2][3][T][HD];      // r, k, v as float32, zero past hd
  float a[2][T];             // a_t = sum_i r_i u_i k_i
  float u[HD];               // u of this head, zero past hd
  float part[T][RG][HD];     // each row group's sum_i r_i S[i][j]
};

// Start the copies of steps [t0, t0 + nt) into ring slot `slot`: where
// `vec`, 16-byte cp.async, thread c making copy c of every step (a step
// is at most HD copies: r, k, v in their dtype, w in float32); else plain
// loads and stores.  Commits one group.
template <typename Tin, int HD, int NT>
__device__ __forceinline__ void stage_issue(
    Stage<Tin, HD>& sm, int slot, const Tin* __restrict__ r,
    const Tin* __restrict__ k, const Tin* __restrict__ v,
    const float* __restrict__ w, int b, int h, int t0, int nt, int S, int H,
    int hd, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CI = 16 / sizeof(Tin);  // elements per 16-byte copy
    const int ci = hd / CI;
    const int which = tid < ci ? 0 : tid < 2 * ci ? 1 : tid < 3 * ci ? 2 : 3;
    const int q = tid - which * ci;
    const Tin* src = which == 0 ? r : which == 1 ? k : v;
    if (q < (which < 3 ? ci : hd / 4)) {
      for (int tt = 0; tt < nt; ++tt) {
        const size_t row = (((size_t)b * S + t0 + tt) * H + h) * hd;
        if (which < 3)
          cp_async16(&sm.rkv[slot][which][tt][q * CI], src + row + q * CI);
        else
          cp_async16(&sm.w[slot][tt][q * 4], w + row + q * 4);
      }
    }
  } else {
    for (int e = tid; e < nt * hd; e += NT) {
      const int tt = e / hd, i = e - tt * hd;
      const size_t at = (((size_t)b * S + t0 + tt) * H + h) * hd + i;
      sm.rkv[slot][0][tt][i] = r[at];
      sm.rkv[slot][1][tt][i] = k[at];
      sm.rkv[slot][2][tt][i] = v[at];
      sm.w[slot][tt][i] = w[at];
    }
  }
  cp_async_commit();
}

// Ring slot `slot` (nt steps) to float32 rows of r, k, v in f[slot], zero
// past hd and past nt, and a_t = sum_i r_i u_i k_i in a[slot]: T * HD / 4
// chunks of 4 elements, a multiple of 32 (whole warps, for the shuffles).
template <typename Tin, int HD, int NT>
__device__ __forceinline__ void stage_convert(Stage<Tin, HD>& sm, int slot,
                                              int nt, int hd) {
  constexpr int T = Stage<Tin, HD>::T, CQ = HD / 4;
  for (int it = threadIdx.x; it < T * CQ; it += NT) {
    const int tt = it / CQ, i0 = (it % CQ) * 4;
    const bool on = tt < nt;
    float rv[4], kv[4], vv[4];
    load4(&sm.rkv[slot][0][tt][i0], rv);
    load4(&sm.rkv[slot][1][tt][i0], kv);
    load4(&sm.rkv[slot][2][tt][i0], vv);
    const float4 u4 = *reinterpret_cast<const float4*>(&sm.u[i0]);
    const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = on && i0 + e < hd;
      rv[e] = ok ? rv[e] : 0.f;
      kv[e] = ok ? kv[e] : 0.f;
      vv[e] = ok ? vv[e] : 0.f;
      a = fmaf(rv[e] * uu[e], kv[e], a);
    }
    store4(&sm.f[slot][0][tt][i0], rv);
    store4(&sm.f[slot][1][tt][i0], kv);
    store4(&sm.f[slot][2][tt][i0], vv);
#pragma unroll
    for (int m = 1; m < CQ; m <<= 1) a += __shfl_xor_sync(kFull, a, m);
    if (i0 == 0) sm.a[slot][tt] = a;
  }
}

// The outputs of the nt steps of stage slot `slot` from the row groups'
// partial sums: o_t[j] = sum_g part[t][g][j] (g in order) + v_t[j] a_t,
// four consecutive j a thread.
template <typename Tin, typename Tout, int HD, int NT>
__device__ __forceinline__ void stage_reduce(Stage<Tin, HD>& sm, int slot,
                                             int nt, Tout* __restrict__ o,
                                             int b, int h, int t0, int S,
                                             int H, int hd, bool vec_o) {
  constexpr int T = Stage<Tin, HD>::T, RG = Stage<Tin, HD>::RG;
  for (int q = threadIdx.x; q < T * HD / 4; q += NT) {
    const int tt = q / (HD / 4), j = (q % (HD / 4)) * 4;
    if (tt >= nt || j >= hd) continue;
    float4 acc = *reinterpret_cast<const float4*>(&sm.part[tt][0][j]);
#pragma unroll
    for (int g = 1; g < RG; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(&sm.part[tt][g][j]);
      acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
    }
    const float4 v4 = *reinterpret_cast<const float4*>(&sm.f[slot][2][tt][j]);
    const float a = sm.a[slot][tt];
    const float y[4] = {fmaf(v4.x, a, acc.x), fmaf(v4.y, a, acc.y),
                        fmaf(v4.z, a, acc.z), fmaf(v4.w, a, acc.w)};
    Tout* dst = o + (((size_t)b * S + t0 + tt) * H + h) * hd + j;
    if (vec_o) {
      store4(dst, y);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < hd) dst[e] = from_f32<Tout>(y[e]);
    }
  }
}

// The tile of a thread: kRows = 8 state rows i = g * HD / 2 + 4 rg + m
// (g = 0, 1; m = 0..3) and kCols columns j = g * 4 * NCG + 4 cg + q
// (g < kCols / 4; q = 0..3).  The 8 lanes of a quarter warp hold one row
// group and 8 consecutive column groups: their reads of a staged row are
// one 16-byte unit, and their float4 accesses to the state and to the
// partial sums cover 128 contiguous bytes.
template <typename Tin, typename Tout, int HD>
__global__ void __launch_bounds__(HD* HD / (kRows * kCols),
                                  512 / (HD * HD / (kRows * kCols)))
    rwkv_scan_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                     const Tin* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* s0,
                     const uint8_t* __restrict__ rows, float* s_out,
                     Tout* __restrict__ o, int S, int H, int hd) {
  constexpr int RG = HD / kRows;      // row groups
  constexpr int NCG = HD / kCols;     // column groups
  constexpr int NT = RG * NCG;        // threads
  constexpr int T = Stage<Tin, HD>::T;
  static_assert(RG % 4 == 0 && NCG % 8 == 0 && NT >= HD, "tile shape");
  __shared__ __align__(16) Stage<Tin, HD> sm;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // a quarter warp shares one row group: 4 row groups x 8 column groups
  // a warp
  const int rg = (tid / 32) % (RG / 4) * 4 + lane / 8;
  const int cg = (tid / 32) / (RG / 4) * 8 + lane % 8;
  const size_t state0 = ((size_t)b * H + h) * hd * hd;  // S[b, h, 0, 0]
  const bool vec = (hd * (int)sizeof(Tin)) % 16 == 0 && hd % 4 == 0 &&
                   aligned16(r) && aligned16(k) && aligned16(v) &&
                   aligned16(w);
  const bool vec_s = hd % 4 == 0 && aligned16(s0) && aligned16(s_out);
  const bool vec_o = hd % 4 == 0 && aligned16(o);
  auto row_of = [&](int m) { return (m / 4) * (HD / 2) + 4 * rg + m % 4; };
  auto col_of = [&](int q) { return (q / 4) * 4 * NCG + 4 * cg + q % 4; };

  // w past hd stays zero (the copies fill [0, hd) of a row), so rows past
  // hd keep a zero state without a guard in the element loop
  for (int e = tid; e < 2 * T * HD; e += NT)
    if (e % HD >= hd) (&sm.w[0][0][0])[e] = 0.f;
  for (int i = tid; i < HD; i += NT)
    sm.u[i] = i < hd ? u[(size_t)h * hd + i] : 0.f;
  stage_issue<Tin, HD, NT>(sm, 0, r, k, v, w, b, h, 0, min(T, S), S, H, hd,
                           vec);
  if (T < S)
    stage_issue<Tin, HD, NT>(sm, 1, r, k, v, w, b, h, T, min(T, S - T), S, H,
                             hd, vec);

  // this thread's tile of the state
  float st[kRows][kCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int i = row_of(m);
#pragma unroll
    for (int g = 0; g < kCols / 4; ++g) {
      const int j = col_of(4 * g);
      const bool on = s0 != nullptr && i < hd && j < hd;
      const float* p = s0 + state0 + (size_t)i * hd + j;
      if (on && vec_s) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        st[m][4 * g] = x.x, st[m][4 * g + 1] = x.y;
        st[m][4 * g + 2] = x.z, st[m][4 * g + 3] = x.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st[m][4 * g + q] = (on && j + q < hd) ? p[q] : 0.f;
      }
    }
  }
  cp_async_wait0();
  __syncthreads();
  stage_convert<Tin, HD, NT>(sm, 0, min(T, S), hd);
  __syncthreads();

  for (int s = 0, t0 = 0; t0 < S; ++s, t0 += T) {
    const int slot = s & 1, nt = min(T, S - t0);
#pragma unroll 2
    for (int tt = 0; tt < nt; ++tt) {
      const float* f = &sm.f[slot][0][tt][0];
      float vv[kCols];
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(f + 2 * T * HD + col_of(4 * g));
        vv[4 * g] = x.x, vv[4 * g + 1] = x.y;
        vv[4 * g + 2] = x.z, vv[4 * g + 3] = x.w;
      }
      float p[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) p[q] = 0.f;
#pragma unroll
      for (int g = 0; g < 2; ++g) {  // rows in two float4 groups
        const int i0 = g * (HD / 2) + 4 * rg;
        const float4 r4 = *reinterpret_cast<const float4*>(f + i0);
        const float4 k4 = *reinterpret_cast<const float4*>(f + T * HD + i0);
        const float4 w4 =
            *reinterpret_cast<const float4*>(&sm.w[slot][tt][i0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            float& x = st[4 * g + m][q];
            p[q] = fmaf(rr[m], x, p[q]);
            x = fmaf(ww[m], x, kk[m] * vv[q]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g)
        *reinterpret_cast<float4*>(&sm.part[tt][rg][col_of(4 * g)]) =
            make_float4(p[4 * g], p[4 * g + 1], p[4 * g + 2], p[4 * g + 3]);
    }
    cp_async_wait0();  // stage s + 1, if any, is in
    __syncthreads();   // and every row group's partial sums are written
    // stage s's ring slot is consumed (its r, k, v converted a stage ago,
    // its w read by the steps): start stage s + 2 into it
    if (t0 + 2 * T < S)
      stage_issue<Tin, HD, NT>(sm, slot, r, k, v, w, b, h, t0 + 2 * T,
                               min(T, S - t0 - 2 * T), S, H, hd, vec);
    stage_reduce<Tin, Tout, HD, NT>(sm, slot, nt, o, b, h, t0, S, H, hd,
                                    vec_o);
    if (t0 + T < S)
      stage_convert<Tin, HD, NT>(sm, slot ^ 1, min(T, S - t0 - T), hd);
    __syncthreads();
  }

  if (s_out != nullptr) {
    const bool update = rows == nullptr || rows[b] != 0;
    if (update || s_out != s0) {  // in place, an idle row keeps s0 as it is
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int i = row_of(m);
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g) {
          const int j = col_of(4 * g);
          if (i >= hd || j >= hd) continue;
          const size_t at = state0 + (size_t)i * hd + j;
          float x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            x[q] = update ? st[m][4 * g + q]
                          : (s0 != nullptr && j + q < hd ? s0[at + q] : 0.f);
          if (vec_s) {
            *reinterpret_cast<float4*>(s_out + at) =
                make_float4(x[0], x[1], x[2], x[3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (j + q < hd) s_out[at + q] = x[q];
          }
        }
      }
    }
  }
}

template <typename Tin, typename Tout, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* rows, void* s_out,
           void* o, int B, int S, int H, int hd, cudaStream_t stream) {
  rwkv_scan_kernel<Tin, Tout, HD>
      <<<B * H, HD * HD / (kRows * kCols), 0, stream>>>(
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
