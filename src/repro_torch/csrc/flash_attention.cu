// Hopper kernel for float32 grouped-query flash attention (forward).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) for float32 inputs: out = softmax(mask(
// cap(q k^T / sqrt(hd)))) v for q (B, Sq, nq, hd) and k, v (B, Skv, nkv,
// hd).  bfloat16 inputs take the tensor-core kernel of
// csrc/flash_attention_bf16.cu.  Options: causal
// (qpos >= kpos), a sliding window (qpos - kpos < window), a softcap
// c * tanh(s / c), and q_offset (query row i sits at position i +
// q_offset).  Masked scores are -2e38, not -inf, and the masked
// probabilities are zeroed explicitly, as in the Pallas kernel; a row with
// no unmasked key comes out as zeros.
//
// The Pallas kernel walks a sequential grid whose innermost axis is the KV
// block, carrying the online-softmax state in VMEM scratch.  Here one CTA
// owns one (batch, q head, 64-row q tile) and loops over 256-key tiles
// itself, with the running max, sum and the 64 x hd output accumulator in
// registers.  GQA reads the kv head h / group in place through the
// (B, S, heads, hd) strides: no transpose and no repeated heads.  Key tiles
// wholly outside the causal/window band are skipped, masks are evaluated
// only on tiles that cross the band's edge or the ragged end of Skv, and q
// tiles run heaviest first (reverse order), which evens out the causal
// triangle.  Any Sq and Skv work: rows past Sq are zero and not written,
// keys past Skv are zero-filled and masked.
//
// Bound on an H100 SXM: 4 hd operations per unmasked (q, k) pair and q
// head, float32 FMAs on the CUDA cores (no TF32: the model runs float32 at
// PyTorch's "highest" matmul precision).  At the Gemma-2-2B serve shape (B
// 2, S 8192, 8 q heads, hd 256, causal) that is 0.55 TFLOP per global
// layer, 8.2 ms at 67 TFLOP/s, against 0.1 GB of q, k, v and o (~30 us):
// the kernel is bound by FMA issue, so the design keeps the FMA pipes fed.
//
// Design (256 threads, one CTA per SM at hd 256):
// * Register micro-tiles.  Warp w owns query rows 8w .. 8w+7; lane cg owns
//   the keys cg*4 .. cg*4+3 and 128 + cg*4 .. +3 of each 256-key tile: 8 x
//   8 scores.  Of O it owns the same 8 rows and 8 columns (hd / 32 in
//   general), laid out the same way.  Each float4 read from shared memory
//   feeds at least 4 FMAs in both products: per d, 2 float4 of Q and 2 of
//   K for 64 FMAs; per key, 2 float4 of P and 2 of V for 64 FMAs.  Q and P
//   are read as warp-wide broadcasts, and a row's online-softmax
//   statistics are reduced by shuffles alone, with no barrier.  Q and K
//   sit d-major in shared memory (a float4 is four rows, or four keys, at
//   one d), P key-major with rows padded to 68 words, so the eight lanes of
//   a phase hit distinct banks.  S and O take 128 of the thread's 254
//   registers; that, and the 197 KB of shared memory, hold the SM to 8
//   warps.
// * Asynchronous staging.  K arrives in chunks of 256 keys x 16 d, V in
//   chunks of 16 keys x hd (16.6 KB and 16 KB at hd 256), one sequence of
//   chunks over all tiles, through a ring of 4 stages filled by cp.async
//   (K one 4-byte element per copy, so that it lands transposed while 16
//   lanes read one key's 64 contiguous bytes; V 16 bytes per copy;
//   zero-filled past Skv).  Each thread's copies of a chunk are one base
//   address plus compile-time multiples of a stride.  Chunk n + 3 is
//   requested before chunk n is consumed, so copies overlap the products,
//   across the softmax too.  Q (64 KB at hd 256, scaled by 1/sqrt(hd)),
//   the P tile (68 KB) and the ring (66.5 KB) stay under the 227 KB a
//   CTA may opt in to.  Q stays resident for the whole key loop; 32-key
//   tiles with V loaded into K's buffer were the alternative, but they
//   would cut the register tile of S to 8 x 1.  Key tiles start at the
//   first key the q tile can see, not at a multiple of 256.
//
// An earlier version (64 x 64 tiles, 4 x 4 scores a thread from scalar
// shared-memory reads, synchronous staging, 209 KB of shared memory) ran
// at 27% of the bound at the serve shape.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 256;       // keys per tile
constexpr int kThreads = 256;
constexpr int kRows = 8;       // rows a thread owns
constexpr int kKeys = kBK / 32; // score columns a thread owns
static_assert(kKeys % 4 == 0, "a thread's keys are float4s of a K row");
constexpr int kKSpan = kBK / (kKeys / 4);  // keys between a thread's float4s
constexpr int kDC = 16;        // d per K chunk
constexpr int kKC = 16;        // keys per V chunk
constexpr int kKPitch = kBK + 4;   // padded row of a d-major K chunk
constexpr int kPPitch = kBQ + 4;   // padded P row (floats)
constexpr int kStages = 4;
constexpr float kNeg = -2.0e38f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t Sq, Skv, nq, group;
  int64_t sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;  // element strides
  int64_t q_offset, window;
  int causal, has_window;
  float scale, softcap;
};

template <int HD>
struct Cfg {
  static constexpr int kNK = HD / kDC;           // K chunks per tile
  static constexpr int kNV = kBK / kKC;          // V chunks per tile
  static constexpr int kNC = kNK + kNV;
  static constexpr int kStage =
      kDC * kKPitch > kKC * HD ? kDC * kKPitch : kKC * HD;  // floats
  static constexpr int kOC = HD >= 32 ? HD / 32 : 1;  // O columns a thread
  static constexpr int kVW = kOC < 4 ? kOC : 4;       // ... read at once
  static constexpr int kNVW = kOC / kVW;
  static constexpr int kSmemFloats =
      HD * kBQ + kBK * kPPitch + kStages * kStage;
  // copies per thread and chunk: K one element each (it is transposed),
  // V 16 bytes each
  static constexpr int kKPer = kBK * kDC / kThreads;
  static constexpr int kVPieces = kKC * (HD / 4);
  static constexpr int kVPer = (kVPieces + kThreads - 1) / kThreads;
};

// Four consecutive elements (the address is vector-aligned).
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          bool valid) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One chunk of the ring: K chunk c < kNK (keys kv0 .. kv0 + kBK, d c*kDC ..
// + kDC), stored d-major, or V chunk c - kNK (keys kv0 + (c - kNK) * kKC ..
// + kKC, all d), stored as in memory, by cp.async straight into the stage
// (K one element per copy, so that it lands transposed, 16 lanes reading
// one key's 64 contiguous bytes; V 16 bytes per copy).
template <int HD>
struct Chunk {
  using C = Cfg<HD>;
  // Thread t copies K elements (key kkey + r * kKStep, d kd) and V pieces
  // (key vkey + r * kVStep, columns vcol .. vcol + 3): all addresses of a
  // chunk are one base plus compile-time multiples of a stride.
  static constexpr int kKStep = kThreads / kDC;
  static constexpr int kVStep = kThreads / (HD / 4);

  const float* k;
  const float* v;
  int64_t Skv, sks, svs;
  int kkey, kd, vkey, vcol;

  __device__ __forceinline__ void init(const float* k_, const float* v_,
                                       const Params& p) {
    k = k_;
    v = v_;
    Skv = p.Skv;
    sks = p.sks;
    svs = p.svs;
    kkey = threadIdx.x / kDC;
    kd = threadIdx.x % kDC;
    vkey = threadIdx.x / (HD / 4);
    vcol = (threadIdx.x % (HD / 4)) * 4;
  }

  __device__ __forceinline__ void load(float* stage, int c, int64_t kv0) {
    if (c < C::kNK) {
      const int64_t rem = Skv - kv0;  // keys of the tile that exist
      const float* src = k + (kv0 + kkey) * sks + c * kDC + kd;
      const int64_t step = kKStep * sks;
      float* dst = stage + kd * kKPitch + kkey;
#pragma unroll
      for (int r = 0; r < C::kKPer; ++r) {
        const bool valid = kkey + r * kKStep < rem;
        const float* sr = valid ? src + r * step : k;
        cp_async4(dst + r * kKStep, sr, valid);
      }
    } else {
      const int64_t key0 = kv0 + (c - C::kNK) * kKC + vkey;
      const float* src = v + key0 * svs + vcol;
      const int64_t step = kVStep * svs;
      float* dst = stage + vkey * HD + vcol;
#pragma unroll
      for (int r = 0; r < C::kVPer; ++r) {
        if (vkey + r * kVStep >= kKC) break;  // HD < 64: fewer pieces
        const bool valid = key0 + r * kVStep < Skv;
        const float* sr = valid ? src + r * step : v;
        cp_async16(dst + r * kVStep * HD, sr, valid);
      }
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const Params p) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // HD x kBQ, d-major, q * scale
  float* Ps = Qs + HD * kBQ;              // kBK x kPPitch, key-major
  float* ring = Ps + kBK * kPPitch;       // kStages x C::kStage

  const int tid = threadIdx.x;
  const int cg = tid & 31;                // column group: the lane
  const int row0 = (tid >> 5) * kRows;    // row group: the warp
  // The thread's score column j is key cg*4 + j of the tile's first half
  // (j < 4) or of its second (j >= 4).
  auto key_of = [cg](int j) { return (j >> 2) * kKSpan + cg * 4 + (j & 3); };

  const int64_t q0 = int64_t(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = h / p.group;
  const float* q = p.q + b * p.sqb + h * p.sqh;
  float* o = p.o + (b * p.Sq * p.nq + h) * HD;  // contiguous

  Chunk<HD> chunk;
  chunk.init(p.k + b * p.skb + kvh * p.skh, p.v + b * p.svb + kvh * p.svh,
             p);

  // The key range any row of this tile can see; key tiles start at its
  // first key (a row's 16-byte pieces need no alignment of the tile).
  const int64_t q_first = q0 + p.q_offset;
  const int64_t q_last = (q0 + kBQ < p.Sq ? q0 + kBQ : p.Sq) - 1 + p.q_offset;
  int64_t kv_end = p.Skv;
  if (p.causal && q_last + 1 < kv_end) kv_end = q_last + 1;
  int64_t kv_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0)
    kv_begin = q_first - p.window + 1;
  const int tiles =
      kv_end > kv_begin ? static_cast<int>((kv_end - kv_begin + kBK - 1) / kBK)
                        : 0;
  const int total = tiles * C::kNC;

  // Start the ring, then stage Q (transposed, scaled) while it fills.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) {
      float* stage = ring + s * C::kStage;
      const int64_t kv0 = kv_begin + (s / C::kNC) * int64_t(kBK);
      chunk.load(stage, s % C::kNC, kv0);
    }
    cp_async_commit();
  }
  for (int e = tid; e < kBQ * (HD / 4); e += kThreads) {
    const int r = e % kBQ, d = (e / kBQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq) x = load4(q + (q0 + r) * p.sqs + d);
    Qs[(d + 0) * kBQ + r] = x.x * p.scale;
    Qs[(d + 1) * kBQ + r] = x.y * p.scale;
    Qs[(d + 2) * kBQ + r] = x.z * p.scale;
    Qs[(d + 3) * kBQ + r] = x.w * p.scale;
  }

  float acc[kRows][C::kOC];
  float s[kRows][kKeys];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kOC; ++c) acc[i][c] = 0.f;
  }

  for (int n = 0; n < total; ++n) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk n landed; chunk n - 1's stage is free
    const int nn = n + kStages - 1;
    float* next = ring + (nn % kStages) * C::kStage;
    const int64_t kv_next = kv_begin + (nn / C::kNC) * int64_t(kBK);
    if (nn < total) chunk.load(next, nn % C::kNC, kv_next);
    cp_async_commit();

    const int c = n % C::kNC;
    const float* st = ring + (n % kStages) * C::kStage;
    const int64_t kv0 = kv_begin + (n / C::kNC) * int64_t(kBK);
    if (c < C::kNK) {
      // ---- S += Q[:, d] K[:, d]^T over this chunk's kDC values of d ----
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int d = 0; d < kDC; ++d) {
        const float* qd = Qs + (c * kDC + d) * kBQ + row0;
        const float* kd = st + d * kKPitch + cg * 4;
        const float4 qa = load4(qd), qb = load4(qd + 4);
        const float a[kRows] = {qa.x, qa.y, qa.z, qa.w,
                                qb.x, qb.y, qb.z, qb.w};
        float kk[kKeys];
#pragma unroll
        for (int h = 0; h < kKeys / 4; ++h) {
          const float4 kx = load4(kd + h * kKSpan);
          kk[4 * h] = kx.x; kk[4 * h + 1] = kx.y;
          kk[4 * h + 2] = kx.z; kk[4 * h + 3] = kx.w;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
      }
      if (c == C::kNK - 1) {
        // ---- online softmax of the tile; P to shared memory ----
        const bool full =
            kv0 + kBK <= p.Skv && (!p.causal || q_first >= kv0 + kBK - 1) &&
            (!p.has_window || q_last - kv0 < p.window);
        uint64_t ok = ~uint64_t(0);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int64_t qpos = q0 + row0 + i + p.q_offset;
          float mx = kNeg;
#pragma unroll
          for (int j = 0; j < kKeys; ++j) {
            float x = s[i][j];
            if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
            if (!full) {
              const int64_t kpos = kv0 + key_of(j);
              const bool okij = kpos < p.Skv &&
                                (!p.causal || qpos >= kpos) &&
                                (!p.has_window || qpos - kpos < p.window);
              if (!okij) {
                ok &= ~(uint64_t(1) << (i * kKeys + j));
                x = kNeg;
              }
            }
            s[i][j] = x;
            mx = fmaxf(mx, x);
          }
          // A row's 256 keys live in the 32 lanes of one warp.
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          m[i] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kKeys; ++j) {
            const bool okij = (ok >> (i * kKeys + j)) & 1;
            s[i][j] = okij ? expf(s[i][j] - m_new) : 0.f;
            sum += s[i][j];
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l[i] = alpha * l[i] + sum;
#pragma unroll
          for (int cc = 0; cc < C::kOC; ++cc) acc[i][cc] *= alpha;
        }
        // P for the V chunks; the next chunk's barrier publishes it.
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          float* pr = Ps + key_of(j) * kPPitch + row0;
          store4(pr, make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
          store4(pr + 4, make_float4(s[4][j], s[5][j], s[6][j], s[7][j]));
        }
      }
    } else {
      // ---- O += P[:, keys] V[keys, :] over this chunk's kKC keys ----
      const int kc = (c - C::kNK) * kKC;
#pragma unroll 4
      for (int jj = 0; jj < kKC; ++jj) {
        const float* pr = Ps + (kc + jj) * kPPitch + row0;
        const float4 pa = load4(pr), pb = load4(pr + 4);
        const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w,
                                 pb.x, pb.y, pb.z, pb.w};
        float vv[C::kOC];
#pragma unroll
        for (int hh = 0; hh < C::kNVW; ++hh) {
          const float* vr = st + jj * HD + hh * 32 * C::kVW + cg * C::kVW;
          if constexpr (C::kVW == 4) {
            const float4 x = load4(vr);
            vv[hh * 4 + 0] = x.x; vv[hh * 4 + 1] = x.y;
            vv[hh * 4 + 2] = x.z; vv[hh * 4 + 3] = x.w;
          } else if constexpr (C::kVW == 2) {
            const float2 x = *reinterpret_cast<const float2*>(vr);
            vv[hh * 2 + 0] = x.x; vv[hh * 2 + 1] = x.y;
          } else {
            vv[hh] = (HD >= 32 || cg < HD) ? vr[0] : 0.f;
          }
        }
#pragma unroll
        for (int cc = 0; cc < C::kOC; ++cc)
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t row = q0 + row0 + i;
    if (row >= p.Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully-masked rows -> 0
    float* orow = o + row * p.nq * HD;
#pragma unroll
    for (int hh = 0; hh < C::kNVW; ++hh) {
      const int col = hh * 32 * C::kVW + cg * C::kVW;
      if constexpr (C::kVW == 4) {
        store4(orow + col, make_float4(acc[i][hh * 4] / li,
                                       acc[i][hh * 4 + 1] / li,
                                       acc[i][hh * 4 + 2] / li,
                                       acc[i][hh * 4 + 3] / li));
      } else {
#pragma unroll
        for (int e = 0; e < C::kVW; ++e)
          if (HD >= 32 || col + e < HD)
            orow[col + e] = acc[i][hh * C::kVW + e] / li;
      }
    }
  }
}

template <int HD>
int launch(const Params& p, int64_t B, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<HD>;
  const int bytes = Cfg<HD>::kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(p.nq), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_flash_attention_f32(
    const float* q, const float* k, const float* v, float* o, int64_t B,
    int64_t Sq, int64_t Skv, int64_t nq, int64_t nkv, int64_t hd,
    int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int64_t causal,
    int64_t has_window, int64_t window, double softcap, int64_t q_offset,
    void* stream_ptr) {
  if (B < 1 || Sq < 1 || Skv < 0 || nkv < 1 || nq % nkv != 0 ||
      nq > 65535 || B > 65535 || (Sq + kBQ - 1) / kBQ > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  // Every row start must be aligned for 16-byte copies; the wrapper copies
  // inputs that are not.
  const bool ptrs = (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  const bool strides = ((sqb | sqs | sqh | skb | sks | skh | svb | svs |
                         svh) % 4) == 0;
  if (!ptrs || !strides) return static_cast<int>(cudaErrorMisalignedAddress);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.Sq = Sq; p.Skv = Skv; p.nq = nq; p.group = nq / nkv;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.q_offset = q_offset; p.window = window;
  p.causal = causal != 0; p.has_window = has_window != 0;
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  p.softcap = static_cast<float>(softcap);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (hd) {
    case 16: return launch<16>(p, B, stream);
    case 32: return launch<32>(p, B, stream);
    case 64: return launch<64>(p, B, stream);
    case 128: return launch<128>(p, B, stream);
    case 256: return launch<256>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
