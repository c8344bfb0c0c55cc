// Hopper kernel for grouped-query flash attention (forward).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): out = softmax(mask(cap(q k^T / sqrt(hd))))
// v for q (B, Sq, nq, hd) and k, v (B, Skv, nkv, hd), float32 or bfloat16,
// accumulated in float32 and written in q's dtype.  Options: causal
// (qpos >= kpos), a sliding window (qpos - kpos < window), a softcap
// c * tanh(s / c), and q_offset (query row i sits at position i +
// q_offset).  Masked scores are -2e38, not -inf, and the masked
// probabilities are zeroed explicitly, as in the Pallas kernel; a row with
// no unmasked key comes out as zeros.
//
// The Pallas kernel walks a sequential grid whose innermost axis is the KV
// block, carrying the online-softmax state in VMEM scratch.  Here one CTA
// owns one (batch, q head, 64-row q tile) and loops over 64-key tiles
// itself, with the running max, sum and the 64 x hd output accumulator in
// registers (256 threads as 16 x 16; a thread owns rows ty + 16 i, i < 4,
// score columns tx + 16 j, j < 4, and output columns tx + 16 c).  Q (scaled
// by 1/sqrt(hd)), the K and V tiles and the probability tile are staged
// through shared memory in float32, rows padded by one word so the strided
// reads are conflict-free; at hd = 256 that is 209 KB, so the launch opts
// in to more than 48 KB of dynamic shared memory.  Both products are
// float32 FMAs.  GQA reads the kv head h / group in place through the
// (B, S, heads, hd) strides: no transpose and no repeated heads.  Key
// tiles wholly outside the causal/window band are skipped (their scores
// would all be masked, which changes neither the max nor the sums), and
// ragged tails are masked, so any Sq and Skv work.  q tiles run heaviest
// first (reverse order), which evens out the causal triangle.
//
// Bound on an H100 SXM: 4 B nq hd operations per unmasked (q, k) pair; at
// the Gemma-2-2B serve shape (B 2, S 8192, 8 q heads, hd 256, causal) that
// is ~0.55 TFLOP per global layer, ~8 ms at the 67 TFLOP/s float32 rate
// outside the tensor cores, against 0.1 GB of q, k, v and o (~30 us).
// This first version is simple, not fast: the score product reads two
// shared-memory words per FMA pair, and there is no wgmma, TMA or warp
// specialisation yet.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                // query rows per CTA
constexpr int kBK = 64;                // keys per tile
constexpr int kTX = 16;                // thread columns
constexpr int kTY = 16;                // thread rows
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;       // rows a thread owns
constexpr int kCols = kBK / kTX;       // score columns a thread owns
constexpr float kNeg = -2.0e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t Sq, Skv, nq, group;
  int64_t sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;  // element strides
  int64_t q_offset, window;
  int causal, has_window, vec;
  float scale, softcap;
};

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

// Four consecutive elements as float32; ``vec`` (uniform) says the
// address is aligned for one vector load.
__device__ __forceinline__ void load4(const float* src, bool vec,
                                      float out[4]) {
  if (vec) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = src[i];
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* src, bool vec,
                                      float out[4]) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    out[0] = __low2float(lo); out[1] = __high2float(lo);
    out[2] = __low2float(hi); out[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(src[i]);
  }
}

__device__ __forceinline__ float store_as(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 store_as(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}

// Stage rows [row0, row0 + rows) of a (S, hd) slice with row stride ``ss``
// into shared memory with row pitch ``pitch``, times ``mul``; rows past
// ``S`` are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      int64_t row0, int rows, int64_t S,
                                      int64_t ss, bool vec, float mul) {
  constexpr int kChunks = HD / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int d = (e % kChunks) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load4(src + (row0 + r) * ss + d, vec, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[r * pitch + d + i] = x[i] * mul;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int kOC = HD / kTX;  // output columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                    // kBQ x (HD + 1), q * scale
  float* Ks = Qs + kBQ * (HD + 1);     // kBK x (HD + 1)
  float* Vs = Ks + kBK * (HD + 1);     // kBK x HD
  float* Ps = Vs + kBK * HD;           // kBQ x (kBK + 1), probabilities

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int64_t q0 = int64_t(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;
  T* o = static_cast<T*>(p.o) + (b * p.Sq * p.nq + h) * HD;  // contiguous
  const bool vec = p.vec != 0;

  stage<T, HD>(Qs, HD + 1, q, q0, kBQ, p.Sq, p.sqs, vec, p.scale);

  // The key range any row of this tile can see.
  const int64_t q_first = q0 + p.q_offset;
  const int64_t q_last = (q0 + kBQ < p.Sq ? q0 + kBQ : p.Sq) - 1 + p.q_offset;
  int64_t kv_end = p.Skv;
  if (p.causal && q_last + 1 < kv_end) kv_end = q_last + 1;
  int64_t kv_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0)
    kv_begin = ((q_first - p.window + 1) / kBK) * kBK;

  float acc[kRows][kOC];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) acc[i][c] = 0.f;
  }

  for (int64_t kv0 = kv_begin; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // Qs staged; the last tile's Ks/Vs/Ps readers done
    stage<T, HD>(Ks, HD + 1, k, kv0, kBK, p.Skv, p.sks, vec, 1.f);
    stage<T, HD>(Vs, HD, v, kv0, kBK, p.Skv, p.svs, vec, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kRows], kk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qs[(ty + kTY * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kk[j] = Ks[(tx + kTX * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    // Online softmax; a row's 64 columns live in the 16 lanes of one
    // half-warp, so xor shuffles below 16 reduce a row.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qpos = q0 + ty + kTY * i + p.q_offset;
      bool ok[kCols];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t kpos = kv0 + tx + kTX * j;
        ok[j] = kpos < p.Skv && (!p.causal || qpos >= kpos) &&
                (!p.has_window || qpos - kpos < p.window);
        float x = s[i][j];
        if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
        s[i][j] = ok[j] ? x : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + kTY * i) * (kBK + 1) + tx + kTX * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + kTY * i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        const float vv = Vs[j * HD + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t row = q0 + ty + kTY * i;
    if (row >= p.Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully-masked rows -> 0
#pragma unroll
    for (int c = 0; c < kOC; ++c)
      o[row * p.nq * HD + tx + kTX * c] = store_as(acc[i][c] / li, o);
  }
}

template <typename T, int HD>
int launch(const Params& p, int64_t B, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  const int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(p.nq), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int64_t B,
             int64_t Sq, int64_t Skv, int64_t nq, int64_t nkv, int64_t hd,
             int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
             int64_t sks, int64_t skh, int64_t svb, int64_t svs,
             int64_t svh, int64_t causal, int64_t has_window,
             int64_t window, double softcap, int64_t q_offset,
             void* stream_ptr) {
  if (B < 1 || Sq < 1 || Skv < 0 || nkv < 1 || nq % nkv != 0 ||
      nq > 65535 || B > 65535 || (Sq + kBQ - 1) / kBQ > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.Sq = Sq; p.Skv = Skv; p.nq = nq; p.group = nq / nkv;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.q_offset = q_offset; p.window = window;
  p.causal = causal != 0; p.has_window = has_window != 0;
  // One vector load per four elements needs every row start aligned.
  const uintptr_t align = 4 * sizeof(T);
  const bool ptrs = (reinterpret_cast<uintptr_t>(q) % align == 0) &&
                    (reinterpret_cast<uintptr_t>(k) % align == 0) &&
                    (reinterpret_cast<uintptr_t>(v) % align == 0);
  const bool strides = ((sqb | sqs | sqh | skb | sks | skh | svb | svs |
                         svh) % 4) == 0;
  p.vec = ptrs && strides;
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  p.softcap = static_cast<float>(softcap);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (hd) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define RT_FLASH_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* q, const T* k, const T* v, T* o, int64_t B,   \
                      int64_t Sq, int64_t Skv, int64_t nq, int64_t nkv,      \
                      int64_t hd, int64_t sqb, int64_t sqs, int64_t sqh,     \
                      int64_t skb, int64_t sks, int64_t skh, int64_t svb,    \
                      int64_t svs, int64_t svh, int64_t causal,              \
                      int64_t has_window, int64_t window, double softcap,    \
                      int64_t q_offset, void* stream) {                      \
    return dispatch<T>(q, k, v, o, B, Sq, Skv, nq, nkv, hd, sqb, sqs, sqh,   \
                       skb, sks, skh, svb, svs, svh, causal, has_window,     \
                       window, softcap, q_offset, stream);                   \
  }

RT_FLASH_ENTRY(rt_flash_attention_f32, float)
RT_FLASH_ENTRY(rt_flash_attention_bf16, __nv_bfloat16)
