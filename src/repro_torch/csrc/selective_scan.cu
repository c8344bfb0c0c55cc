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
// What bounds it on an H100 SXM, at the Jamba prefill's (2, 8192, 16384),
// d_state 16, bfloat16: the bytes of dt and xc (read once) and of y
// (written once), 2.15 GB, 0.64 ms at 3.35 TB/s; and its B * S * d_inner *
// d_state = 4.3e9 exponentials on the special-function units (MUFU), 16 a
// clock an SM: 1.03 ms at 1.98 GHz, the larger floor.  Beside each
// exponential a state update needs four FP32 instructions (dt * A, the
// product with B_t, the state's FMA and y's FMA), so at one warp
// instruction a clock a scheduler (128 lanes a clock an SM) the issue
// slots allow about three more an exponential before they, and not the
// MUFU, are the limit.  The first version (one thread a channel, expf,
// per-step branches) spent 16.4 SASS instructions an exponential and
// took 4.6-4.7 ms.
//
// Design.  The exponentials: exp(dt * A) = ex2.approx.ftz(dt * A'), with
// A' = A * log2(e) formed once a state at load: one FMUL and one MUFU.EX2
// each, where expf() spends a range reduction of several FP32
// instructions around the same MUFU op.  ex2.approx errs up to 2 ulp where
// expf() rounds nearly correctly; against a float64 run this doubles the
// RMS error of y (PERF.md §6, PR 24: a CPU emulation of this arithmetic,
// tests/test_torch_mamba.py, puts it on ex2's own error, not on the
// rounding of A').  dt * xc is rounded to bfloat16 by integer
// instructions: the conversion instruction runs at 16 a clock an SM, as
// the MUFU, and measured slower.  One thread a channel of one batch row
// holds its d_state states and its row of A in registers and walks time
// in order, so each state keeps the reference's sequential rounding.  (A
// split of a channel's state over 2, 4 or 8 lanes measured slower at the
// serve shape: the lanes repeat the channel's loads and rounding and add
// shuffles, issue slots the MUFU floor leaves none of.)
//   * dt, xc: a CTA owns kThreads consecutive channels of one batch row
//     and copies each tile of kSteps steps of its dt and xc columns into a
//     ring of kStages shared-memory stages with 16-byte cp.async (when the
//     rows are 16-byte aligned; otherwise by plain loads), kStages - 1
//     tiles ahead of the tile being computed, behind one __syncthreads a
//     tile; each thread reads its own channel's column.
//   * B_t, C_t (any batch and time stride, unit stride over the state:
//     the model reads them in place from its x_proj output): loaded into
//     registers one tile ahead and stored into the same ring as float32
//     after the current tile, so a thread reads them as 16-byte
//     shared-memory broadcasts, behind the same barrier.
//   * A tile's steps are one straight run of code: y is stored by a
//     predicated store, with no branch to cut the compiler's schedule; a
//     warp's store at a step writes 32 consecutive channels.
// Time is not split across CTAs (a chunked scan with a carry pass): at the
// serve shape B * d_inner threads already give 128 of the 132 SMs a CTA,
// and a carry pass would compute the exponentials, the floor, a second
// time.  Products are written __fmul_rn/__fmaf_rn so that the compiler
// contracts nothing the reference rounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The launch shape, each the fastest of those measured (PERF.md §6,
// PR 24): threads a CTA (one a channel), tiles in the shared-memory ring,
// and bytes of dt (and of xc) a channel a tile.
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kTileBytes = 64;
constexpr float kLog2e = 1.4426950408889634f;

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
  // to nearest even on the bits; NaN (whose payload could carry into the
  // sign) passes through
  const unsigned u = __float_as_uint(v);
  const unsigned r = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return v != v ? v : __uint_as_float(r);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// *p = v where `pred`, as one predicated store (no branch, which would
// cut the tile's straight-line code into blocks the compiler schedules
// apart).
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"(static_cast<int>(pred)));
}

// N floats (a multiple of 4) from 16-byte-aligned shared memory.
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  static_assert(N % 4 == 0, "whole float4s");
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    r[k] = v.x, r[k + 1] = v.y, r[k + 2] = v.z, r[k + 3] = v.w;
  }
}

template <typename T, int DS>
struct Scan {
  static constexpr int kSteps = kTileBytes / sizeof(T);  // steps a tile
  static constexpr int kEpc = 16 / sizeof(T);            // elements a chunk
  static constexpr int kRowChunks = kThreads / kEpc;     // chunks a row
  static constexpr int kBC = 2 * kSteps * DS;            // B and C values
  static constexpr int kBCPer = kBC / kThreads;
  // one stage: dt and xc [kSteps][kThreads] in T, then B and C
  // [kSteps][DS] float32
  static constexpr int kDtxcBytes = 2 * kSteps * kThreads * int(sizeof(T));
  static constexpr int kStageBytes = kDtxcBytes + kBC * 4;
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static_assert(kThreads % kEpc == 0, "shape");
  static_assert(kDtxcBytes % 16 == 0, "stage alignment");
};

struct Args {
  const void* dt;
  const void* xc;
  const void* Bm;
  const void* Cm;
  const float* A;
  const float* h0;
  float* y;
  float* h;
  int64_t S, DI, sBb, sBt, sCb, sCt;
};

// Copies dt and xc of the tile of steps [t0, t0 + kSteps) of this CTA's
// channels into `stage`, laid out [dt | xc][step][channel]: a thread
// copies the 16-byte chunk `threadIdx.x % kRowChunks` of rows
// threadIdx.x / kRowChunks + s * kRows, with cp.async when kVec (rows
// 16-byte aligned and d_inner a multiple of a chunk), else by plain loads.
// `gdt` and `gxc` point at the chunk's first channel `ch` in step 0 of
// the batch row; steps past S and channels past d_inner are zero.
template <typename T, int DS, bool kVec>
__device__ __forceinline__ void copy_dtxc(unsigned char* stage,
                                          const T* gdt, const T* gxc,
                                          int64_t ch, int64_t t0,
                                          const Args& a) {
  using K = Scan<T, DS>;
  constexpr int kRows = kThreads / K::kRowChunks;
  static_assert((2 * K::kSteps) % kRows == 0, "rows a pass");
  T* dst = reinterpret_cast<T*>(stage) +
           (threadIdx.x % K::kRowChunks) * K::kEpc;
  const int row = threadIdx.x / K::kRowChunks;
#pragma unroll
  for (int s = 0; s < 2 * K::kSteps / kRows; ++s) {
    const int rr = row + s * kRows;  // [dt | xc] x step
    const bool isx = rr >= K::kSteps;
    const int64_t t = t0 + rr - (isx ? K::kSteps : 0);
    const T* src = (isx ? gxc : gdt) + t * a.DI;
    T* d = dst + rr * kThreads;
    if constexpr (kVec) {
      const bool ok = t < a.S && ch < a.DI;
      cp_async16(d, ok ? src : gdt, ok);
    } else {
#pragma unroll
      for (int e = 0; e < K::kEpc; ++e)
        d[e] = (t < a.S && ch + e < a.DI) ? src[e] : zero<T>();
    }
  }
}

// B and C of the tile of steps [t0, t0 + kSteps) into registers, laid out
// [B | C][step][state] over the CTA's threads (steps past S: zero).  `Bn`
// and `Cn` point at state threadIdx.x % DS of step 0 of the batch row.
template <typename T, int DS>
__device__ __forceinline__ void load_bc(T (&r)[Scan<T, DS>::kBCPer],
                                        const T* Bn, const T* Cn,
                                        int64_t t0, const Args& a) {
  using K = Scan<T, DS>;
  static_assert(K::kBC % kThreads == 0 && kThreads % DS == 0, "B, C");
#pragma unroll
  for (int k = 0; k < K::kBCPer; ++k) {
    const int rr = threadIdx.x / DS + k * (kThreads / DS);  // [B | C] x step
    const bool isc = rr >= K::kSteps;
    const int64_t t = t0 + rr - (isc ? K::kSteps : 0);
    r[k] = t < a.S ? (isc ? Cn[t * a.sCt] : Bn[t * a.sBt]) : zero<T>();
  }
}

template <typename T, int DS>
__device__ __forceinline__ void store_bc(
    unsigned char* stage, const T (&r)[Scan<T, DS>::kBCPer]) {
  using K = Scan<T, DS>;
  float* bc = reinterpret_cast<float*>(stage + K::kDtxcBytes);
#pragma unroll
  for (int k = 0; k < K::kBCPer; ++k)
    bc[threadIdx.x + k * kThreads] = to_f(r[k]);
}

// The kSteps steps of one tile from `stage` for channel `c` of the CTA; in
// the last tile (kTail) only its first `nsteps` steps run.  `yp` points at
// y[b, t0, i].
template <typename T, int DS, bool kTail>
__device__ __forceinline__ void run_tile(const unsigned char* stage, int c,
                                         const float (&a2)[DS],
                                         float (&h)[DS], float* yp,
                                         int64_t DI, int nsteps,
                                         bool active) {
  using K = Scan<T, DS>;
  const T* sdt = reinterpret_cast<const T*>(stage);
  const T* sxc = sdt + K::kSteps * kThreads;
  const float* sB = reinterpret_cast<const float*>(stage + K::kDtxcBytes);
  const float* sC = sB + K::kSteps * DS;
#pragma unroll
  for (int tt = 0; tt < K::kSteps; ++tt) {
    if (kTail && tt >= nsteps) break;
    const float dtf = to_f(sdt[tt * kThreads + c]);
    const float bx = round_to<T>(__fmul_rn(dtf, to_f(sxc[tt * kThreads + c])));
    float bv[DS], cv[DS];
    lds(bv, sB + tt * DS);
    lds(cv, sC + tt * DS);
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < DS; ++p) {
      const float e = ex2(__fmul_rn(dtf, a2[p]));
      h[p] = __fmaf_rn(e, h[p], __fmul_rn(bx, bv[p]));
      acc = __fmaf_rn(h[p], cv[p], acc);
    }
    store_if(yp, acc, active);
    yp += DI;
  }
}

template <typename T, int DS, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    selective_scan_kernel(Args a) {
  using K = Scan<T, DS>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int c = threadIdx.x;
  const int64_t i = c0 + c;
  const bool active = i < a.DI;
  float a2[DS], h[DS];
#pragma unroll
  for (int p = 0; p < DS; ++p) {
    a2[p] = active ? __fmul_rn(a.A[i * DS + p], kLog2e) : 0.f;
    h[p] = (active && a.h0 != nullptr) ? a.h0[(b * a.DI + i) * DS + p] : 0.f;
  }
  const int64_t row0 = b * a.S;
  float* yp = a.y + row0 * a.DI + (active ? i : 0);
  const int64_t ch = c0 + (threadIdx.x % K::kRowChunks) * K::kEpc;
  const T* gdt = static_cast<const T*>(a.dt) + row0 * a.DI + ch;
  const T* gxc = static_cast<const T*>(a.xc) + row0 * a.DI + ch;
  const T* Bn = static_cast<const T*>(a.Bm) + b * a.sBb + threadIdx.x % DS;
  const T* Cn = static_cast<const T*>(a.Cm) + b * a.sCb + threadIdx.x % DS;
  const int64_t ntiles = (a.S + K::kSteps - 1) / K::kSteps;
  auto stage = [&](int64_t tile) {
    return smem + (tile % kStages) * K::kStageBytes;
  };

  T bc[K::kBCPer];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles)
      copy_dtxc<T, DS, kVec>(stage(s), gdt, gxc, ch, s * K::kSteps, a);
    cp_async_commit();
  }
  load_bc<T, DS>(bc, Bn, Cn, 0, a);
  store_bc<T, DS>(stage(0), bc);
  if (ntiles > 1) load_bc<T, DS>(bc, Bn, Cn, K::kSteps, a);

  for (int64_t tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this tile's dt and xc have landed
    __syncthreads();  // for every thread; the oldest stage is free again
    const int64_t t0 = tile * K::kSteps;
    if (tile + kStages - 1 < ntiles)
      copy_dtxc<T, DS, kVec>(stage(tile + kStages - 1), gdt, gxc, ch,
                             t0 + (kStages - 1) * K::kSteps, a);
    cp_async_commit();
    float* yt = yp + t0 * a.DI;
    if (t0 + K::kSteps <= a.S) {
      run_tile<T, DS, false>(stage(tile), c, a2, h, yt, a.DI, K::kSteps,
                             active);
    } else {
      run_tile<T, DS, true>(stage(tile), c, a2, h, yt, a.DI,
                            static_cast<int>(a.S - t0), active);
    }
    if (tile + 1 < ntiles) store_bc<T, DS>(stage(tile + 1), bc);
    if (tile + 2 < ntiles) load_bc<T, DS>(bc, Bn, Cn, t0 + 2 * K::kSteps, a);
  }
  if (active) {
#pragma unroll
    for (int p = 0; p < DS; ++p) a.h[(b * a.DI + i) * DS + p] = h[p];
  }
}

template <typename T, int DS, bool kVec>
int launch_one(const Args& a, int64_t B, cudaStream_t stream) {
  using K = Scan<T, DS>;
  auto kernel = selective_scan_kernel<T, DS, kVec>;
  if (K::kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if ((a.DI + kThreads - 1) / kThreads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.DI + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  kernel<<<grid, kThreads, K::kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DS>
int launch_ds(const Args& a, int64_t B, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(a.dt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.xc) % 16 == 0 &&
                   (a.DI * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  return vec ? launch_one<T, DS, true>(a, B, stream)
             : launch_one<T, DS, false>(a, B, stream);
}

template <typename T>
int launch(const void* dt, const void* xc, const void* Bm, const void* Cm,
           const void* A, const void* h0, void* y, void* h, int64_t B,
           int64_t S, int64_t DI, int64_t DS, int64_t sBb, int64_t sBt,
           int64_t sCb, int64_t sCt, void* stream_ptr) {
  if (B < 1 || B > 65535 || S < 1 || DI < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{dt, xc, Bm, Cm, static_cast<const float*>(A),
               static_cast<const float*>(h0), static_cast<float*>(y),
               static_cast<float*>(h), S, DI, sBb, sBt, sCb, sCt};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (DS == 8) return launch_ds<T, 8>(a, B, stream);
  if (DS == 16) return launch_ds<T, 16>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
