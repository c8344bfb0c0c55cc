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
// Design: one thread per (state, action) pair, one CTA per tile of
// kThreads / A consecutive states (one state, its actions split over the
// CTA, when A > kThreads).  Pair i = s * A + a of the tile is thread
// i - s0 * A, so a warp's rows idx[i * b ..] and probs[i * b ..] are one
// contiguous stretch of global memory.  For b <= 8 each warp copies its
// stretch into shared memory with coalesced loads (one 128-byte line per
// load of idx), then each lane reads its own row there (an odd row pitch,
// so no bank conflicts) and issues all b gathers of v[idx] before the
// first product (the successor loop is unrolled at compile time).  Only a
// __syncwarp separates the copy from the use.  Longer rows take a plain
// loop over global memory, so a row has no length limit.  v (8 MB at 10^6
// states) stays in the 50 MB L2: idx, probs and R, read once, are loaded
// as streams (__ldcs, evict first) so that they displace as little of v
// as they can.  Each gather is one 32-byte sector, and the 20 per state
// are what the kernel waits on.  The expectation is summed over b in the
// reference's order; R + gamma * ev may contract to
// an FMA, so values agree with the plain version to ~1e-15 relative, not
// bitwise.  The max over actions is a small shared-memory pass (A need not
// be a power of two), with a max that propagates NaN like jnp.max; a max
// of numbers does not depend on order, so it is exact.  The block norm is
// one partial max per CTA, combined in a fixed order by a one-CTA pass.
//
// An earlier version (one thread per state, each CTA first copying its
// tile's rows into shared memory between two barriers, rows capped at 133
// successors) ran at 23% of the bound: the copy was synchronous and the
// per-state reads of the staged rows conflicted on banks.

#include <cstdint>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = rt::kThreads;  // (state, action) pairs per CTA

// The expectation sum_k p[k] * v[idx[k]] of one row of kB successors, all
// gathers issued before the first product.  ``idx``/``probs`` point into
// the warp's staged rows in shared memory.
template <int kB>
__device__ __forceinline__ double expectation(
    const int32_t* idx, const double* probs, const double* __restrict__ v,
    int64_t) {
  double x[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k) x[k] = __ldg(v + idx[k]);
  double ev = 0.0;
#pragma unroll
  for (int k = 0; k < kB; ++k) ev += probs[k] * x[k];
  return ev;
}

// Rows longer than the unrolled sizes: a plain loop over global memory.
template <>
__device__ __forceinline__ double expectation<0>(
    const int32_t* idx, const double* probs, const double* __restrict__ v,
    int64_t B) {
  double ev = 0.0;
#pragma unroll 4
  for (int64_t k = 0; k < B; ++k)
    ev += __ldcs(probs + k) * __ldg(v + __ldcs(idx + k));
  return ev;
}

template <int kB, bool kNorm>
__global__ void __launch_bounds__(kThreads)
bellman_kernel(const int32_t* __restrict__ idx,
               const double* __restrict__ probs,
               const double* __restrict__ rewards,
               const double* __restrict__ v,
               const double* __restrict__ v_old, double* __restrict__ tv,
               double* __restrict__ partials, int64_t S, int64_t A,
               int64_t B, double gamma) {
  // Staged rows (kB > 0), one odd pitch per pair so that the lanes' rows
  // fall on distinct banks.
  constexpr int kPitch = kB > 0 ? (kB | 1) : 1;
  __shared__ int32_t sidx[kB > 0 ? kThreads * kPitch : 1];
  __shared__ double sprob[kB > 0 ? kThreads * kPitch : 1];
  __shared__ double qs[kThreads];
  // lanes: threads per state; spc: states per CTA.
  const int lanes = A <= kThreads ? static_cast<int>(A) : kThreads;
  const int spc = kThreads / lanes;
  const int t = threadIdx.x;
  const int ls = t / lanes;          // the thread's state in the tile
  const int a0 = t - ls * lanes;     // its first action
  const int64_t s0 = int64_t(blockIdx.x) * spc;
  const int64_t s = s0 + ls;
  const int64_t n_states = S - s0 < spc ? S - s0 : spc;
  double q = 0.0;
  if constexpr (kB > 0) {
    // A <= kThreads here: pair i = s0 * A + t.  Each warp copies its
    // contiguous stretch of rows with coalesced loads, then each lane
    // reads its own row.
    const int lane = t & 31, w0 = t - lane;
    const int pairs = static_cast<int>(n_states * A) - w0;
    const int n = (pairs < 32 ? pairs : 32) * kB;
    const int64_t base = (s0 * A + w0) * int64_t(kB);
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      const int e = lane + 32 * r;
      if (e < n) {
        const int dst = (w0 + e / kB) * kPitch + e % kB;
        sidx[dst] = __ldcs(idx + base + e);
        sprob[dst] = __ldcs(probs + base + e);
      }
    }
    __syncwarp();
    if (ls < spc && s < S) {
      const int64_t i = s0 * A + t;
      q = __ldcs(rewards + i) + gamma * expectation<kB>(sidx + t * kPitch,
                                                        sprob + t * kPitch,
                                                        v, kB);
      qs[t] = q;
    }
  } else {
    if (ls < spc && s < S) {
      for (int64_t a = a0; a < A; a += lanes) {
        const int64_t i = s * A + a;
        const double qa = __ldcs(rewards + i) +
                          gamma * expectation<0>(idx + i * B, probs + i * B,
                                                 v, B);
        q = (a == a0) ? qa : rt::MaxOp::apply(qa, q);
      }
      qs[t] = q;
    }
  }
  __syncthreads();
  double local = 0.0;
  if (t < n_states) {
    const double* row = qs + t * lanes;
    const int n = static_cast<int>(A < lanes ? A : lanes);
    double best = row[0];
    for (int k = 1; k < n; ++k) best = rt::MaxOp::apply(row[k], best);
    tv[s0 + t] = best;
    if (kNorm) local = fabs(best - v_old[s0 + t]);
  }
  if (kNorm) {
    local = rt::block_reduce<rt::MaxOp>(local);
    if (threadIdx.x == 0) partials[blockIdx.x] = local;
  }
}

// States per CTA, and CTAs for S states (one tile each).
inline int64_t states_per_cta(int64_t A) {
  return A <= kThreads ? kThreads / A : 1;
}

inline int64_t ctas(int64_t S, int64_t A) {
  const int64_t spc = states_per_cta(A);
  return (S + spc - 1) / spc;
}

template <bool kNorm>
cudaError_t launch(const int32_t* idx, const double* probs,
                   const double* rewards, const double* v,
                   const double* v_old, double* tv, double* partials,
                   int64_t S, int64_t A, int64_t B, double gamma,
                   cudaStream_t stream) {
  const int grid = static_cast<int>(ctas(S, A));
  // Staged rows need all of a state's actions in one tile (A <= kThreads).
  const int64_t kb = A <= kThreads && B <= 8 ? B : 0;
#define RT_BELLMAN_CASE(KB)                                                  \
  bellman_kernel<KB, kNorm><<<grid, kThreads, 0, stream>>>(                  \
      idx, probs, rewards, v, v_old, tv, partials, S, A, B, gamma);          \
  break;
  switch (kb) {
    case 1: RT_BELLMAN_CASE(1)
    case 2: RT_BELLMAN_CASE(2)
    case 3: RT_BELLMAN_CASE(3)
    case 4: RT_BELLMAN_CASE(4)
    case 5: RT_BELLMAN_CASE(5)
    case 6: RT_BELLMAN_CASE(6)
    case 7: RT_BELLMAN_CASE(7)
    case 8: RT_BELLMAN_CASE(8)
    default: RT_BELLMAN_CASE(0)
  }
#undef RT_BELLMAN_CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_bellman(const int32_t* idx, const double* probs,
                          const double* rewards, const double* v, double* tv,
                          int64_t S, int64_t A, int64_t B, double gamma,
                          void* stream_ptr) {
  if (S < 1 || A < 1 || B < 1 || ctas(S, A) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false>(
      idx, probs, rewards, v, nullptr, tv, nullptr, S, A, B, gamma,
      static_cast<cudaStream_t>(stream_ptr)));
}

extern "C" int rt_bellman_block(const int32_t* idx, const double* probs,
                                const double* rewards, const double* v,
                                const double* v_old, double* tv,
                                double* partials, int64_t partials_len,
                                double* norm, int64_t S, int64_t A, int64_t B,
                                double gamma, void* stream_ptr) {
  // One partial per CTA, which owns at least one state.
  if (S < 1 || A < 1 || B < 1 || partials_len < ctas(S, A) ||
      ctas(S, A) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = launch<true>(idx, probs, rewards, v, v_old, tv, partials,
                                 S, A, B, gamma, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  rt::reduce_partials_kernel<rt::MaxOp><<<1, rt::kThreads, 0, stream>>>(
      partials, ctas(S, A), norm);
  return static_cast<int>(cudaGetLastError());
}
