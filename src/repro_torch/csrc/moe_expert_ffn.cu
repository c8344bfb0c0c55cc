// Hopper kernels for a MoE layer's dropless decode: each picked expert's
// FFN over all T tokens, its weights read once, where they lie.
//
// Replaces no Pallas kernel: the JAX package's moe_ffn(dropless=True)
// (src/repro/models/moe.py) runs einsums over all E experts at C = T, which
// XLA fuses.  The port's plain version copies the picked experts' weights
// (params["wi"][sel]) and runs torch.bmm on the copy, which moves each
// picked expert's weights three times: the copy reads and writes them, the
// products read the copy.  Here, for every expert e of the rank's E_loc
// with used[e] != 0:
//
//   h[e]   = act(X . wi[e, :, 0, :]) * (X . wi[e, :, 1, :])   swiglu, geglu
//   h[e]   = act(X . wi[e])                                   gelu, relu^2
//   out[e] = h[e] . wo[e]
//
// with X (T, d), h (E_loc, T, f) and out (E_loc, T, d) in the weights'
// type, in two launches (h, then out).  An expert with used[e] == 0 is
// skipped: its CTAs return at once and its rows of h and out are left
// unwritten (the caller never reads them).  `used` is the dispatch's mask,
// read on the card: no host synchronise, no shape that depends on the data.
//
// What bounds it on an H100 SXM: the weights' bytes.  At Jamba's decode
// (T 32, d 8192, f 24576, bfloat16) an expert is 1.21 GB of weights for
// 2 * 32 FLOPs an element, 32 FLOP/byte against the card's ~295 at the
// ridge: 16 experts take 11.5 ms at 3.35 TB/s and ~0.4 ms of tensor-core
// time.  So the design point is the load pipeline.
//
// Design (bfloat16).  One kernel computes either product, C[n, t] =
// sum_k W[e][k][n] X[e][t][k], with the weight tile as the 16-row side of
// mma.sync.m16n8k16 and the tokens as its 8-column side ("swap AB"), so
// that a few tokens still fill the MMAs' long side with weights.
//   * A CTA owns one expert and 128 weight columns: 64 of gate and the same
//     64 of up (the gated first product), or 128 consecutive columns (the
//     non-gated first product and the second).  Each of its 4 warps owns 16
//     of each 64 and all of the CTA's tokens, so gate and up of one
//     (column, token) sit in one thread's registers: act(gate) * up is the
//     epilogue, in float32, and h is written once, rounded once.
//   * K is walked in tiles of 64 through a ring of kStages shared-memory
//     stages, each 64 x 128 weights (16 KB) and TN x 64 tokens, filled with
//     16-byte cp.async (.cg) kStages - 1 tiles ahead, behind one
//     __syncthreads a tile.  16-byte chunks are XOR-swizzled by row, so
//     ldmatrix (.trans for the weights, stored k-major as they lie) reads no
//     bank twice.  Two CTAs an SM keep ~120 KB of loads in flight.  Of the
//     rings measured at the smoke's shape (3 to 6 stages, with and without
//     an L2 evict_first policy on the weights) this one was the fastest:
//     5.86 ms for 18.1 GB, 3.10 TB/s on an H100 SXM (PERF.md §6).
//   * TN (16, 32 or 64) is the smallest token tile that holds T; a larger T
//     takes more token tiles.  They are the grid's fastest index, so the
//     CTAs of one weight tile's token tiles run side by side and stream its
//     weights together: HBM sends each tile once and L2 serves the others.
//   * The grid is (token tiles, column tiles, E_loc): at Jamba's widths
//     1 x 384 x 16 CTAs for wi and 1 x 64 x 16 for wo at T <= 64, so the
//     card is full without splitting K.
// float32 weights take a plain FFMA kernel (a thread a column and 8 tokens)
// in the same two launches: correct, not tuned (no served configuration
// runs float32).
//
// The kernels' names carry "gemm", as the products they stand for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kHalf = 64;      // weight columns of a half tile
constexpr int kBK = 64;        // K of a stage
constexpr int kStages = 4;
constexpr int kHalfBytes = kBK * kHalf * 2;
constexpr int kWeightBytes = 2 * kHalfBytes;
constexpr int kF32Tokens = 8;  // tokens a thread of the float32 kernel

// activation codes, as kernels/moe_expert_ffn.py's ACT_CODES
constexpr int kNone = -1, kSilu = 0, kGelu = 1, kRelu2 = 2;

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kSilu:
      return x / (1.0f + expf(-x));
    case kGelu:  // the tanh approximation
      return 0.5f * x *
             (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case kRelu2: {
      const float r = fmaxf(x, 0.0f);
      return r * r;
    }
    default:
      return x;
  }
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows, the chunks XOR-swizzled by the row's low three bits
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Y[e][t][n] (row stride N) for the CTA's expert, columns and tokens:
// GATED: act(X . W[:, n]) * (X . W[:, N + n]) with W's rows ldw apart;
// else act(X . W[:, n]) (act kNone: the product itself).  X[e] is (T, K)
// at x_stride_e elements an expert (0: one X for all), W[e] (K, ldw) at
// w_stride_e.
template <int TN, bool GATED>
__global__ void __launch_bounds__(kThreads)
    moe_expert_gemm_bf16(const __nv_bfloat16* __restrict__ X,
                         const __nv_bfloat16* __restrict__ W,
                         __nv_bfloat16* __restrict__ Y,
                         const int* __restrict__ used, int T, int K, int N,
                         int64_t ldw, int64_t x_stride_e, int64_t w_stride_e,
                         int act) {
  constexpr int kStageBytes = kWeightBytes + TN * kBK * 2;
  const int e = blockIdx.z;
  if (used[e] == 0) return;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * (GATED ? kHalf : 2 * kHalf);
  const int t0 = blockIdx.x * TN;
  const __nv_bfloat16* x = X + e * x_stride_e;
  const __nv_bfloat16* w = W + e * w_stride_e;
  const int n_tiles = (K + kBK - 1) / kBK;

  // a k-tile into a stage; chunks past K, N or T are zero-filled
  auto load = [&](int stage, int kt) {
    const uint32_t s = base + stage * kStageBytes;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2 * kBK * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int half = idx >> 9, row = (idx >> 3) & (kBK - 1), c = idx & 7;
      const int col = n0 + (GATED ? 0 : half * kHalf) + c * 8;
      const int k = k0 + row;
      const bool ok = k < K && col < N;
      const __nv_bfloat16* src =
          ok ? w + k * ldw + col + (GATED ? half * N : 0) : W;
      cp_async(s + half * kHalfBytes + swz(row, c), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < TN * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int t = idx >> 3, c = idx & 7;
      const int k = k0 + c * 8;
      const bool ok = t0 + t < T && k < K;
      const __nv_bfloat16* src =
          ok ? x + static_cast<int64_t>(t0 + t) * K + k : X;
      cp_async(s + kWeightBytes + swz(t, c), src, ok ? 16 : 0);
    }
  };

  float acc[2][TN / 8][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_commit();
  }
  const int mi = lane >> 3;  // the 8x8 matrix this lane addresses
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1's stage is free
    const int next = kt + kStages - 1;
    if (next < n_tiles) load(next % kStages, next);
    cp_commit();
    const uint32_t s = base + (kt % kStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // tokens: (b0, b1) of n-tiles 2p and 2p + 1
      uint32_t b[TN / 8][2];
#pragma unroll
      for (int p = 0; p < TN / 16; ++p) {
        uint32_t r[4];
        ldsm_x4(r, s + kWeightBytes +
                       swz((2 * p + (mi >> 1)) * 8 + (lane & 7),
                           2 * kk + (mi & 1)));
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
      // weights: the warp's 16 columns of each half, k-major in shared
      // memory, transposed into the A fragment
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[4];
        ldsm_x4_trans(a, s + h * kHalfBytes +
                             swz(16 * kk + (mi >> 1) * 8 + (lane & 7),
                                 2 * warp + (mi & 1)));
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) mma_bf16(acc[h][j], a, b[j][0], b[j][1]);
      }
    }
  }

  // acc[h][j][r]: column 16 * warp + lane / 4 + 8 * (r / 2) of half h,
  // token t0 + 8 * j + 2 * (lane % 4) + r % 2
  __nv_bfloat16* y = Y + static_cast<int64_t>(e) * T * N;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + 8 * j + 2 * (lane & 3) + (r & 1);
      const int nn = 16 * warp + (lane >> 2) + 8 * (r >> 1);
      if (t >= T) continue;
      __nv_bfloat16* row = y + static_cast<int64_t>(t) * N;
      if (GATED) {
        if (n0 + nn < N)
          row[n0 + nn] =
              __float2bfloat16(activate(acc[0][j][r], act) * acc[1][j][r]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + h * kHalf + nn;
          if (col < N) row[col] = __float2bfloat16(activate(acc[h][j][r], act));
        }
      }
    }
  }
}

// The same products in float32 FFMA: a thread owns a column and up to
// kF32Tokens tokens and walks K in order.
template <bool GATED>
__global__ void __launch_bounds__(kThreads)
    moe_expert_gemm_f32(const float* __restrict__ X,
                        const float* __restrict__ W, float* __restrict__ Y,
                        const int* __restrict__ used, int T, int K, int N,
                        int64_t ldw, int64_t x_stride_e, int64_t w_stride_e,
                        int act) {
  const int e = blockIdx.z;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  if (used[e] == 0 || n >= N) return;
  const int t0 = blockIdx.x * kF32Tokens;
  const int nt = min(kF32Tokens, T - t0);
  const float* x = X + e * x_stride_e + static_cast<int64_t>(t0) * K;
  const float* w = W + e * w_stride_e + n;
  float gate[kF32Tokens] = {}, up[kF32Tokens] = {};
  for (int k = 0; k < K; ++k) {
    const float wg = w[k * ldw];
    const float wu = GATED ? w[k * ldw + N] : 0.0f;
#pragma unroll
    for (int i = 0; i < kF32Tokens; ++i) {
      if (i < nt) {
        const float xv = __ldg(x + static_cast<int64_t>(i) * K + k);
        gate[i] = fmaf(xv, wg, gate[i]);
        if (GATED) up[i] = fmaf(xv, wu, up[i]);
      }
    }
  }
  float* y = Y + (static_cast<int64_t>(e) * T + t0) * N + n;
  for (int i = 0; i < nt; ++i)
    y[static_cast<int64_t>(i) * N] =
        GATED ? activate(gate[i], act) * up[i] : activate(gate[i], act);
}

unsigned ceil_div(int64_t a, int64_t b) {
  return static_cast<unsigned>((a + b - 1) / b);
}

struct Product {
  const void* X;
  const void* W;
  void* Y;
  const int* used;
  int64_t E, T, K, N, ldw, x_stride_e, w_stride_e;
  int act;
};

template <int TN, bool GATED>
cudaError_t launch_bf16(const Product& p, cudaStream_t stream) {
  auto kernel = moe_expert_gemm_bf16<TN, GATED>;
  const int bytes = kStages * (kWeightBytes + TN * kBK * 2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(p.T, TN), ceil_div(p.N, GATED ? kHalf : 2 * kHalf),
                  static_cast<unsigned>(p.E));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(p.X),
      static_cast<const __nv_bfloat16*>(p.W), static_cast<__nv_bfloat16*>(p.Y),
      p.used, static_cast<int>(p.T), static_cast<int>(p.K),
      static_cast<int>(p.N), p.ldw, p.x_stride_e, p.w_stride_e, p.act);
  return cudaGetLastError();
}

template <bool GATED>
cudaError_t launch_bf16_tile(const Product& p, cudaStream_t stream) {
  if (p.T <= 16) return launch_bf16<16, GATED>(p, stream);
  if (p.T <= 32) return launch_bf16<32, GATED>(p, stream);
  return launch_bf16<64, GATED>(p, stream);
}

template <bool GATED>
cudaError_t launch_f32(const Product& p, cudaStream_t stream) {
  const dim3 grid(ceil_div(p.T, kF32Tokens), ceil_div(p.N, kThreads),
                  static_cast<unsigned>(p.E));
  moe_expert_gemm_f32<GATED><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(p.X), static_cast<const float*>(p.W),
      static_cast<float*>(p.Y), p.used, static_cast<int>(p.T),
      static_cast<int>(p.K), static_cast<int>(p.N), p.ldw, p.x_stride_e,
      p.w_stride_e, p.act);
  return cudaGetLastError();
}

// h = first product of x and wi, then out = h . wo, on the given stream
template <bool BF16>
int launch(const void* x, const void* wi, const void* wo, const void* used,
           void* h, void* out, int64_t E, int64_t T, int64_t d, int64_t f,
           int64_t gated, int64_t act, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int* u = static_cast<const int*>(used);
  const Product first{x, wi, h, u, E, T, d, f, gated ? 2 * f : f,
                      0, d * (gated ? 2 : 1) * f, static_cast<int>(act)};
  const Product second{h, wo, out, u, E, T, f, d, d, T * f, f * d, kNone};
  cudaError_t err;
  if (BF16)
    err = gated ? launch_bf16_tile<true>(first, stream)
                : launch_bf16_tile<false>(first, stream);
  else
    err = gated ? launch_f32<true>(first, stream)
                : launch_f32<false>(first, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = BF16 ? launch_bf16_tile<false>(second, stream)
             : launch_f32<false>(second, stream);
  return static_cast<int>(err);
}

}  // namespace

// x (T, d); wi (E, d, 2, f) when gated, else (E, d, f); wo (E, f, d);
// used (E,) int32; h (E, T, f) and out (E, T, d) written for the experts
// with used != 0.  act: 0 silu, 1 gelu (tanh), 2 relu^2.  Returns the last
// launch's cudaError_t.
extern "C" int rt_moe_expert_ffn_bf16(const void* x, const void* wi,
                                      const void* wo, const void* used,
                                      void* h, void* out, int64_t E,
                                      int64_t T, int64_t d, int64_t f,
                                      int64_t gated, int64_t act,
                                      void* stream_ptr) {
  return launch<true>(x, wi, wo, used, h, out, E, T, d, f, gated, act,
                      stream_ptr);
}

extern "C" int rt_moe_expert_ffn_f32(const void* x, const void* wi,
                                     const void* wo, const void* used, void* h,
                                     void* out, int64_t E, int64_t T,
                                     int64_t d, int64_t f, int64_t gated,
                                     int64_t act, void* stream_ptr) {
  return launch<false>(x, wi, wo, used, h, out, E, T, d, f, gated, act,
                       stream_ptr);
}
