// Mamba selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `mamba_scan` (src/repro/kernels/ssm_scan.py:59,
// body `_mamba_kernel` :33).  It computes the same function: per (batch row
// b, channel i) a float32 state h[0..ds) walks the sequence, and per step t
//     h[s] <- exp(dt_t[i] * A[i][s]) * h[s] + dt_t[i] * x_t[i] * B_t[s]
//     y_t[i] = sum_s h[s] * C_t[s]
// Beyond the TPU kernel it starts from a given state h0 (the serving cache)
// instead of zeros, writes the final state, and leaves the final state of
// rows whose `rows` flag is 0 equal to h0 (idle serving slots).  It walks
// every row and writes every row's y, idle ones included: under MoE the
// padding tokens of idle rows route through the experts beside the live
// ones, so their outputs must be the plain path's, never left unwritten.
//
// Bound on this card.  Each step reads x, dt (di values each) and B, C (ds
// each) and writes y; the state is read once and written once.  Per state
// element and step the function needs one exp and six float32 flops.  At
// the served decode shape (B=8, S=1, di=16384, ds=16) the state and A
// traffic (18.9 MB) sets the floor, 5.63 us; at a 128-token chunk the exps
// do: 268 M of them on the SFUs at 16 per clock per SM, 64.2 us, against
// 32 us for the float32 work on the FMA pipes.
//
// Design (PERF.md has the measurements behind each point):
// * one thread owns one (b, channel) pair and keeps its 16 state values and
//   its 16 A values in registers; a block is 256 consecutive channels of
//   one row b, so the grid is (ceil(di / 256), B): at the served shape 512
//   blocks, all resident at once (4 per SM) under the 64-register cap that
//   __launch_bounds__(256, 4) sets.  ptxas spills 76 bytes a thread at that
//   cap; 3 blocks an SM (80 registers, 8 bytes spilled) runs a second wave
//   of blocks and is slower at decode;
// * the block's state tile (256 channels x 16 x 4 B = 16 KB, contiguous in
//   memory) is copied in by cp.async in 16-byte pieces, consecutive threads
//   on consecutive addresses, into shared memory with its 16-byte units
//   XOR-swizzled (unit q of channel c at 4 c + (q ^ ((c >> 1) & 3))), so
//   each thread's four float4 reads of its own 64 bytes are free of bank
//   conflicts; the final state goes back out the same way.  A is read as
//   four float4s a thread (the same 1 MB for every row b: from L2);
// * A is scaled by log2 e once, at load, so each element's decay is one
//   ex2.approx.ftz of dt * A' on the SFU (a result below 2^-126 flushes to
//   zero, as a decay it is then 0 instead of a subnormal).  __expf without
//   fast math is a multiply by log2 e and ex2.approx without ftz, which
//   guards subnormals with more instructions;
// * x and dt are staged 16 / sizeof(input) steps at a time in their own
//   dtype by cp.async into a ring of three stages: stage st + 1 is issued
//   while stage st runs, and the third slot lets one __syncthreads a stage
//   order each slot's reads before its next copies.  B and C of the next
//   stage are loaded into a register a thread one stage ahead and written
//   to shared memory as float32 (zero past ds, so any ds <= 16 runs without
//   a guard in the element loop);
// * where ds != 16 or a pointer is not 16-byte aligned, the state, x and dt
//   move element by element instead (the same arithmetic);
// * the multiply-adds are fma and the exp is the SFU's approximation, a
//   few ulp from expf: roundings differ from the plain version's in the
//   last bits.
//
// The C entry point returns the cudaError_t of the launch (0 = success);
// the Python wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>


namespace {

constexpr int kThreads = 256;  // channels per block
constexpr int kDS = 16;        // state entries per channel held in registers
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// shared-memory float4 slot of 16-byte unit q of channel c in the state tile
__device__ __forceinline__ int swz(int c, int q) {
  return 4 * c + (q ^ ((c >> 1) & 3));
}

template <typename Tin>
struct Smem {
  static constexpr int T = 16 / sizeof(Tin);  // steps per stage: 8 or 4
  float4 tile[kThreads * kDS / 4];            // the state, swizzled
  Tin xdt[3][2][T][kThreads];                 // ring of x / dt stages
  float bc[2][T][2][kDS];                     // B / C of a stage, float32
};

// Start the copies of x and dt for steps [t0, t0 + nt) of channels
// [i0, i0 + nch) into ring slot `slot`: 16-byte cp.async where `vec`
// (thread c making copy c of every step, 2 nch / CI <= 64 of them), else
// plain loads and stores.  Commits one group (with the state tile's
// copies, if any were issued before).
template <typename Tin>
__device__ __forceinline__ void stage_issue(Smem<Tin>& sm, int slot,
                                            const Tin* __restrict__ x,
                                            const Tin* __restrict__ dt, int b,
                                            int i0, int nch, int t0, int nt,
                                            int S, int di, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CI = 16 / sizeof(Tin);  // elements per 16-byte copy
    const int per = nch / CI;             // copies per row
    const int which = tid >= per, q = tid - which * per;
    if (tid < 2 * per) {
      for (int tt = 0; tt < nt; ++tt) {
        const size_t at = ((size_t)b * S + t0 + tt) * di + i0 + q * CI;
        cp_async16(&sm.xdt[slot][which][tt][q * CI], (which ? dt : x) + at);
      }
    }
  } else {
    for (int e = tid; e < nt * nch; e += kThreads) {
      const int tt = e / nch, c = e - tt * nch;
      const size_t at = ((size_t)b * S + t0 + tt) * di + i0 + c;
      sm.xdt[slot][0][tt][c] = x[at];
      sm.xdt[slot][1][tt][c] = dt[at];
    }
  }
  cp_async_commit();
}

// B and C of steps [t0, t0 + nt) as this thread's one float32 value of the
// stage's bc[T][2][kDS] (zero past ds and past nt)
template <typename Tin>
__device__ __forceinline__ float bc_load(const Tin* __restrict__ bm,
                                         const Tin* __restrict__ cm, int b,
                                         int t0, int nt, int S, int ds) {
  constexpr int T = Smem<Tin>::T;
  const int tid = threadIdx.x;
  if (tid >= T * 2 * kDS) return 0.f;
  const int tt = tid / (2 * kDS), which = (tid / kDS) & 1, s = tid % kDS;
  if (tt >= nt || s >= ds) return 0.f;
  return to_f32((which ? cm : bm)[((size_t)b * S + t0 + tt) * ds + s]);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, 4) mamba_scan_kernel(
    const Tin* __restrict__ x, const Tin* __restrict__ dt,
    const Tin* __restrict__ bm, const Tin* __restrict__ cm,
    const float* __restrict__ a, const float* h0,
    const uint8_t* __restrict__ rows, float* h_out, Tout* __restrict__ y,
    int S, int di, int ds) {
  constexpr int T = Smem<Tin>::T;
  __shared__ __align__(16) Smem<Tin> sm;

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kThreads;
  const int nch = min(kThreads, di - i0);  // channels of this block
  const int i = i0 + tid;
  const bool live = i < di;
  // the state tile (and A) move by 16-byte copies where ds = 16 and the
  // buffers are 16-byte aligned; x / dt where a row of channels is
  const bool tile = ds == kDS && h0 != nullptr && aligned16(h0) &&
                    aligned16(h_out) && aligned16(a);
  const bool vec = (di * (int)sizeof(Tin)) % 16 == 0 && aligned16(x) &&
                   aligned16(dt);
  const size_t state0 = ((size_t)b * di + i0) * ds;  // h[b, i0, 0]

  if (tile) {
    const float* src = h0 + state0;
    for (int e = tid; e < nch * 4; e += kThreads)
      cp_async16(&sm.tile[swz(e >> 2, e & 3)], src + 4 * e);
  }
  stage_issue(sm, 0, x, dt, b, i0, nch, 0, min(T, S), S, di, vec);
  float bc_next = bc_load(bm, cm, b, 0, min(T, S), S, ds);

  float h[kDS], a2[kDS];
  if (live && tile) {
    const float4* ap = reinterpret_cast<const float4*>(a + (size_t)i * kDS);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = ap[q];
      a2[4 * q] = v.x * kLog2e, a2[4 * q + 1] = v.y * kLog2e;
      a2[4 * q + 2] = v.z * kLog2e, a2[4 * q + 3] = v.w * kLog2e;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kDS; ++s) {
      const bool on = live && s < ds;
      a2[s] = on ? a[(size_t)i * ds + s] * kLog2e : 0.f;
      h[s] = (on && h0 != nullptr) ? h0[state0 + (size_t)tid * ds + s] : 0.f;
    }
  }

  for (int st = 0, t0 = 0; t0 < S; ++st, t0 += T) {
    const int nt = min(T, S - t0);
    if (t0 + T < S)
      stage_issue(sm, (st + 1) % 3, x, dt, b, i0, nch, t0 + T,
                  min(T, S - t0 - T), S, di, vec);
    else
      cp_async_commit();  // an empty group keeps wait_group 1 exact
    if (tid < T * 2 * kDS) (&sm.bc[st & 1][0][0][0])[tid] = bc_next;
    if (t0 + T < S)
      bc_next = bc_load(bm, cm, b, t0 + T, min(T, S - t0 - T), S, ds);
    cp_async_wait1();
    __syncthreads();  // stage st is in; stage st - 2 is read
    if (st == 0 && tile) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = sm.tile[swz(tid, q)];
        h[4 * q] = v.x, h[4 * q + 1] = v.y;
        h[4 * q + 2] = v.z, h[4 * q + 3] = v.w;
      }
    }

    const int slot = st % 3;
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = to_f32(sm.xdt[slot][1][tt][tid]);
      const float dtx = dtv * to_f32(sm.xdt[slot][0][tt][tid]);
      const float* bc = &sm.bc[st & 1][tt][0][0];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b4 = reinterpret_cast<const float4*>(bc)[q];
        const float4 c4 = reinterpret_cast<const float4*>(bc + kDS)[q];
        const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& hs = h[4 * q + e];
          hs = fmaf(exp2_ftz(dtv * a2[4 * q + e]), hs, dtx * bs[e]);
          acc = fmaf(hs, cs[e], acc);
        }
      }
      if (live) y[((size_t)b * S + t0 + tt) * di + i] = from_f32<Tout>(acc);
    }
  }

  const bool update = rows == nullptr || rows[b] != 0;
  if (h_out == nullptr || (!update && h_out == h0))
    return;  // no state out, or in place: an idle row keeps h0 as it is
  if (tile) {
    // an idle row writes back the tile as it came in (h0)
    __syncthreads();
    if (update) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sm.tile[swz(tid, q)] = make_float4(h[4 * q], h[4 * q + 1],
                                           h[4 * q + 2], h[4 * q + 3]);
    }
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(h_out + state0);
    for (int e = tid; e < nch * 4; e += kThreads)
      dst[e] = sm.tile[swz(e >> 2, e & 3)];
  } else if (live) {
#pragma unroll
    for (int s = 0; s < kDS; ++s) {
      if (s < ds) {
        const size_t at = state0 + (size_t)tid * ds + s;
        h_out[at] = update ? h[s] : (h0 != nullptr ? h0[at] : 0.f);
      }
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a, const void* h0, const void* rows, void* h_out,
           void* y, int B, int S, int di, int ds, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  mamba_scan_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(dt),
      static_cast<const Tin*>(bm), static_cast<const Tin*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<const uint8_t*>(rows), static_cast<float*>(h_out),
      static_cast<Tout*>(y), S, di, ds);
  return (int)cudaGetLastError();
}

template <typename Tin>
int launch_out(int out_dtype, const void* x, const void* dt, const void* bm,
               const void* cm, const void* a, const void* h0,
               const void* rows, void* h_out, void* y, int B, int S, int di,
               int ds, cudaStream_t stream) {
  if (out_dtype == 0)
    return launch<Tin, float>(x, dt, bm, cm, a, h0, rows, h_out, y, B, S, di,
                              ds, stream);
  if (out_dtype == 1)
    return launch<Tin, __nv_bfloat16>(x, dt, bm, cm, a, h0, rows, h_out, y, B,
                                      S, di, ds, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, dt: (B, S, di) of in_dtype; bm, cm: (B, S, ds) of in_dtype; a: (di, ds)
// float32; h0: (B, di, ds) float32 or null (zeros); rows: (B,) uint8 or null
// (every row updates); h_out: (B, di, ds) float32 or null (no state out), and
// may equal h0; y: (B, S, di) of out_dtype.  Dtype codes: 0 = float32,
// 1 = bfloat16.  1 <= ds <= 16, S >= 1, B <= 65535.  Returns the cudaError_t
// of the launch.
int mamba_scan_fwd(const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* h0,
                   const void* rows, void* h_out, void* y, int B, int S,
                   int di, int ds, int in_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || S < 1 || di < 1 || ds < 1 || ds > kDS)
    return (int)cudaErrorInvalidValue;
  if (in_dtype == 0)
    return launch_out<float>(out_dtype, x, dt, bm, cm, a, h0, rows, h_out, y,
                             B, S, di, ds, st);
  if (in_dtype == 1)
    return launch_out<__nv_bfloat16>(out_dtype, x, dt, bm, cm, a, h0, rows,
                                     h_out, y, B, S, di, ds, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
