// Hopper kernels for the Bellman optimality operator (paper §3.3.2).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/bellman.py:
//
// * bellman (_bellman_kernel): (T v)(s) = max_a [R(s,a) + gamma *
//   sum_b P_b(s,a) v[idx_b(s,a)]] for all S states;
// * bellman_block (_bellman_block_kernel): the same backup for a block of
//   states, gathering from the block's dependency closure (a remapped idx),
//   plus the block-local inf-norm max|tv - v_old|.
//
// The Pallas kernels keep all of v resident in VMEM and gather there.  On
// Hopper the work is a gather, bound by the bytes of idx (int32), probs and
// R, which every state reads once: at S = 10^6, A = 4, b = 5 that is 288 MB
// with v and the output, ~86 us at 3.35 TB/s on an H100 SXM; a
// 250,000-state block is ~80 MB, ~24 us.
//
// Design: a CTA owns a tile of kTile consecutive states.  Their idx and
// probs rows are one contiguous stretch of global memory, so the CTA first
// copies the stretch into shared memory with coalesced loads (a first
// version had each thread read its own 160-byte row straight from global
// memory; the strided loads thrashed L1 and ran slower than the plain
// PyTorch version).  Then one thread per state walks its A x b successors
// from shared memory, gathers v[idx] from global memory (the 8 MB v of a
// 10^6-state MDP stays in the 50 MB L2), accumulates the expectation in
// the reference's order and takes the max over actions (NaN propagates,
// like jnp.max).  The block norm is one partial max per CTA, combined by a
// one-CTA pass: a max does not depend on order, so it is exact.
// R + gamma * ev may contract to an FMA, so values agree with the plain
// version to ~1e-15 relative, not bitwise.

#include <cstdint>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kTile = 128;  // states (and threads) per CTA
// Shared memory a CTA may stage (below the 227 KB one CTA can have): rows
// of up to A * b = 133 successors.  The wrapper refuses longer rows.
constexpr int64_t kMaxStageBytes = 200 * 1024;

inline int64_t stage_bytes(int64_t per_state) {
  return kTile * per_state * int64_t(sizeof(double) + sizeof(int32_t));
}

template <bool kNorm>
__global__ void bellman_kernel(const int32_t* __restrict__ idx,
                               const double* __restrict__ probs,
                               const double* __restrict__ rewards,
                               const double* __restrict__ v,
                               const double* __restrict__ v_old,
                               double* __restrict__ tv,
                               double* __restrict__ partials, int64_t S,
                               int64_t A, int64_t B, double gamma) {
  extern __shared__ __align__(16) unsigned char stage[];
  const int64_t per = A * B;
  double* sp = reinterpret_cast<double*>(stage);
  int32_t* si = reinterpret_cast<int32_t*>(sp + kTile * per);
  double local = 0.0;
  for (int64_t s0 = int64_t(blockIdx.x) * kTile; s0 < S;
       s0 += int64_t(gridDim.x) * kTile) {
    const int64_t n_states = (S - s0 < kTile) ? (S - s0) : kTile;
    const int64_t count = n_states * per;
    const int64_t base = s0 * per;
    __syncthreads();  // the previous tile is consumed
    for (int64_t e = threadIdx.x; e < count; e += blockDim.x) {
      sp[e] = probs[base + e];
      si[e] = idx[base + e];
    }
    __syncthreads();
    if (threadIdx.x < n_states) {
      const int64_t s = s0 + threadIdx.x;
      const int64_t row = int64_t(threadIdx.x) * per;
      double best = 0.0;
      for (int64_t a = 0; a < A; ++a) {
        double ev = 0.0;
        for (int64_t k = 0; k < B; ++k)
          ev += sp[row + a * B + k] * v[si[row + a * B + k]];
        const double q = rewards[s * A + a] + gamma * ev;
        best = (a == 0) ? q : rt::MaxOp::apply(q, best);
      }
      tv[s] = best;
      if (kNorm) local = rt::MaxOp::apply(fabs(best - v_old[s]), local);
    }
  }
  if (kNorm) {
    local = rt::block_reduce<rt::MaxOp>(local);
    if (threadIdx.x == 0) partials[blockIdx.x] = local;
  }
}

template <bool kNorm>
cudaError_t launch(int grid, const int32_t* idx, const double* probs,
                   const double* rewards, const double* v,
                   const double* v_old, double* tv, double* partials,
                   int64_t S, int64_t A, int64_t B, double gamma,
                   cudaStream_t stream) {
  const int64_t bytes = stage_bytes(A * B);
  cudaError_t err = cudaFuncSetAttribute(
      bellman_kernel<kNorm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  bellman_kernel<kNorm><<<grid, kTile, static_cast<size_t>(bytes), stream>>>(
      idx, probs, rewards, v, v_old, tv, partials, S, A, B, gamma);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_bellman(const int32_t* idx, const double* probs,
                          const double* rewards, const double* v, double* tv,
                          int64_t S, int64_t A, int64_t B, double gamma,
                          void* stream_ptr) {
  if (S < 1 || A < 1 || B < 1 || stage_bytes(A * B) > kMaxStageBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (S + kTile - 1) / kTile;
  const int grid = static_cast<int>(tiles < (1 << 30) ? tiles : (1 << 30));
  return static_cast<int>(launch<false>(
      grid, idx, probs, rewards, v, nullptr, tv, nullptr, S, A, B, gamma,
      static_cast<cudaStream_t>(stream_ptr)));
}

extern "C" int rt_bellman_block(const int32_t* idx, const double* probs,
                                const double* rewards, const double* v,
                                const double* v_old, double* tv,
                                double* partials, int64_t partials_len,
                                double* norm, int64_t S, int64_t A, int64_t B,
                                double gamma, void* stream_ptr) {
  if (S < 1 || A < 1 || B < 1 || partials_len < rt::kMaxPartials ||
      stage_bytes(A * B) > kMaxStageBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t tiles = (S + kTile - 1) / kTile;
  const int grid = static_cast<int>(
      tiles < rt::kMaxPartials ? tiles : rt::kMaxPartials);
  cudaError_t err = launch<true>(grid, idx, probs, rewards, v, v_old, tv,
                                 partials, S, A, B, gamma, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  rt::reduce_partials_kernel<rt::MaxOp><<<1, rt::kThreads, 0, stream>>>(
      partials, grid, norm);
  return static_cast<int>(cudaGetLastError());
}
