// Hopper kernel for Mamba's selective scan (arXiv:2312.00752).
//
// Replaces no Pallas kernel: the JAX package scans with
// jax.lax.associative_scan (src/repro/models/mamba.py:107,126,152), which
// XLA fuses.  PyTorch has no such scan, and its plain version (a doubling
// scan over (B, chunk, d_inner, d_state) float32 tensors, kernels/ref.py)
// moves ~2 GB a tensor a step at Jamba's widths, so the port's Mamba
// prefill runs this kernel instead.  Per channel i of batch row b:
//
//   a_t = exp(dt_t * A[i, :])                       (float32)
//   h_t = a_t * h_{t-1} + round(dt_t * xc_t) * B_t  (float32 state)
//   y_t = sum_n h_t[n] * C_t[n]
//
// where round() keeps the reference's dtype point: dt * xc is rounded to
// the input type (bfloat16 or float32) before the float32 products.  The
// outputs are y (B, S, d_inner) float32 and the final state h_S
// (B, d_inner, d_state) float32, in one launch; h starts at h0 or zero.
//
// What bounds it on an H100 SXM: the bytes of dt and xc (read once) and of
// y (written once): at (2, 8192, 16384) in bfloat16 that is 2.15 GB, 0.64 ms
// at 3.35 TB/s.  Its B * S * d_inner * d_state exponentials (4.3e9 at that
// shape) run on the special-function units, 16 a clock an SM: ~1.0 ms at
// 1.98 GHz, the larger floor of the two.
//
// Design (simple, right first): one thread per (b, i) channel walks time
// in order with its d_state-long state and A row in registers (d_state is
// a template parameter: 8 or 16), so y's sum over the state needs no
// shuffle.  A CTA holds kThreads consecutive channels of one batch row, so
// a warp's loads of dt and xc at one step are 32 consecutive elements.
// Each thread keeps two register tiles of kTile steps of dt and xc: the
// next tile's loads are issued before the current tile is computed, so
// they are in flight while it computes.  B_t and C_t are the same for
// every channel of a row: each 2 * kTile steps the CTA stages them in
// shared memory as float32, where every lane of a warp reads the same word
// (a broadcast).  Products are written __fmul_rn/__fmaf_rn so that the
// compiler contracts nothing the reference rounds.  Splitting time across
// CTAs (a chunked scan with a carry pass) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // channels per CTA
constexpr int kTile = 16;      // time steps per register tile

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A float32 product rounded to T (the reference computes dt * xc in the
// model's type: bfloat16 products are rounded once, to nearest even).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// dt and xc of steps [t0, t0 + kTile) of this thread's channel.
template <typename T>
__device__ __forceinline__ void load_tile(T (&d)[kTile], T (&x)[kTile],
                                          const T* __restrict__ dtp,
                                          const T* __restrict__ xcp,
                                          int64_t t0, int64_t S, int64_t DI,
                                          bool active) {
#pragma unroll
  for (int tt = 0; tt < kTile; ++tt) {
    const int64_t t = t0 + tt;
    if (active && t < S) {
      d[tt] = dtp[t * DI];
      x[tt] = xcp[t * DI];
    } else {
      d[tt] = zero<T>();
      x[tt] = zero<T>();
    }
  }
}

// Steps [t0, t0 + kTile) of the recurrence; B_t and C_t at rows
// s0 + tt of the staged tiles.
template <typename T, int DS>
__device__ __forceinline__ void run_tile(const T (&d)[kTile],
                                         const T (&x)[kTile],
                                         const float (*sB)[DS],
                                         const float (*sC)[DS], int s0,
                                         const float (&a_row)[DS],
                                         float (&h)[DS], float* yp,
                                         int64_t t0, int64_t S, int64_t DI,
                                         bool active) {
#pragma unroll
  for (int tt = 0; tt < kTile; ++tt) {
    const int64_t t = t0 + tt;
    if (t < S) {  // the same for every thread of the CTA
      const float dtf = to_f(d[tt]);
      const float bx = round_to<T>(__fmul_rn(dtf, to_f(x[tt])));
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        const float a = expf(__fmul_rn(dtf, a_row[n]));
        const float bn = __fmul_rn(bx, sB[s0 + tt][n]);
        h[n] = __fmaf_rn(a, h[n], bn);
        acc = __fmaf_rn(h[n], sC[s0 + tt][n], acc);
      }
      if (active) yp[t * DI] = acc;
    }
  }
}

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ xc,
                          const T* __restrict__ Bm, const T* __restrict__ Cm,
                          const float* __restrict__ A,
                          const float* __restrict__ h0, float* __restrict__ y,
                          float* __restrict__ h_out, int64_t S, int64_t DI,
                          int64_t sBb, int64_t sBt, int64_t sCb, int64_t sCt) {
  __shared__ float sB[2 * kTile][DS];
  __shared__ float sC[2 * kTile][DS];
  const int64_t b = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = i < DI;
  float a_row[DS], h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a_row[n] = active ? A[i * DS + n] : 0.f;
    h[n] = (active && h0 != nullptr) ? h0[(b * DI + i) * DS + n] : 0.f;
  }
  const int64_t base = b * S * DI + (active ? i : 0);
  const T* dtp = dt + base;
  const T* xcp = xc + base;
  float* yp = y + base;
  const T* Bp = Bm + b * sBb;
  const T* Cp = Cm + b * sCb;

  T d0[kTile], x0[kTile], d1[kTile], x1[kTile];
  load_tile(d0, x0, dtp, xcp, 0, S, DI, active);
  for (int64_t t0 = 0; t0 < S; t0 += 2 * kTile) {
    load_tile(d1, x1, dtp, xcp, t0 + kTile, S, DI, active);
    __syncthreads();  // the previous steps' reads of sB and sC are done
    for (int k = threadIdx.x; k < 2 * kTile * DS; k += kThreads) {
      const int tt = k / DS, n = k % DS;
      const int64_t t = t0 + tt;
      sB[tt][n] = t < S ? to_f(Bp[t * sBt + n]) : 0.f;
      sC[tt][n] = t < S ? to_f(Cp[t * sCt + n]) : 0.f;
    }
    __syncthreads();
    run_tile<T, DS>(d0, x0, sB, sC, 0, a_row, h, yp, t0, S, DI, active);
    load_tile(d0, x0, dtp, xcp, t0 + 2 * kTile, S, DI, active);
    run_tile<T, DS>(d1, x1, sB, sC, kTile, a_row, h, yp, t0 + kTile, S, DI,
                    active);
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < DS; ++n) h_out[(b * DI + i) * DS + n] = h[n];
  }
}

template <typename T>
int launch(const void* dt, const void* xc, const void* Bm, const void* Cm,
           const void* A, const void* h0, void* y, void* h, int64_t B,
           int64_t S, int64_t DI, int64_t DS, int64_t sBb, int64_t sBt,
           int64_t sCb, int64_t sCt, void* stream_ptr) {
  if (B < 1 || B > 65535 || S < 1 || DI < 1 ||
      (DI + kThreads - 1) / kThreads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((DI + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T* dt_ = static_cast<const T*>(dt);
  const T* xc_ = static_cast<const T*>(xc);
  const T* B_ = static_cast<const T*>(Bm);
  const T* C_ = static_cast<const T*>(Cm);
  const float* A_ = static_cast<const float*>(A);
  const float* h0_ = static_cast<const float*>(h0);
  float* y_ = static_cast<float*>(y);
  float* h_ = static_cast<float*>(h);
  if (DS == 8) {
    selective_scan_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
        dt_, xc_, B_, C_, A_, h0_, y_, h_, S, DI, sBb, sBt, sCb, sCt);
  } else if (DS == 16) {
    selective_scan_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
        dt_, xc_, B_, C_, A_, h0_, y_, h_, S, DI, sBb, sBt, sCb, sCt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dt, xc (B, S, DI) contiguous; Bm, Cm (B, S, DS) with unit stride over
// the state and the given batch and time strides; A (DI, DS) float32; h0
// (B, DI, DS) float32 or null; y (B, S, DI) and h (B, DI, DS) float32.
extern "C" int rt_selective_scan_f32(const void* dt, const void* xc,
                                     const void* Bm, const void* Cm,
                                     const void* A, const void* h0, void* y,
                                     void* h, int64_t B, int64_t S,
                                     int64_t DI, int64_t DS, int64_t sBb,
                                     int64_t sBt, int64_t sCb, int64_t sCt,
                                     void* stream_ptr) {
  return launch<float>(dt, xc, Bm, Cm, A, h0, y, h, B, S, DI, DS, sBb, sBt,
                       sCb, sCt, stream_ptr);
}

extern "C" int rt_selective_scan_bf16(const void* dt, const void* xc,
                                      const void* Bm, const void* Cm,
                                      const void* A, const void* h0, void* y,
                                      void* h, int64_t B, int64_t S,
                                      int64_t DI, int64_t DS, int64_t sBb,
                                      int64_t sBt, int64_t sCb, int64_t sCt,
                                      void* stream_ptr) {
  return launch<__nv_bfloat16>(dt, xc, Bm, Cm, A, h0, y, h, B, S, DI, DS,
                               sBb, sBt, sCb, sCt, stream_ptr);
}
