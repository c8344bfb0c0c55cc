// Deterministic block reductions shared by the port's kernels.
//
// A kernel that needs a norm over all its threads writes one partial per
// CTA; a second one-block launch (reduce_partials_kernel) combines the
// partials in a fixed order.  Nothing uses atomics, so a norm is the same
// bits on every run with the same launch shape.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int kThreads = 256;  // threads per CTA for every 1-D kernel

struct SumOp {
  __device__ __forceinline__ static double identity() { return 0.0; }
  __device__ __forceinline__ static double apply(double a, double b) {
    return a + b;
  }
};

// max that propagates NaN, like jnp.max / torch.amax
struct MaxOp {
  __device__ __forceinline__ static double identity() { return 0.0; }
  __device__ __forceinline__ static double apply(double a, double b) {
    return (a > b || a != a) ? a : b;
  }
};

// Reduce one value per thread over the CTA; the result is valid in thread 0.
// blockDim.x must be a multiple of 32 and at most 1024.
template <typename Op>
__device__ __forceinline__ double block_reduce(double v) {
  __shared__ double warp_vals[32];
  for (int off = 16; off > 0; off >>= 1)
    v = Op::apply(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_vals[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  if (warp == 0) {
    v = (lane < nwarps) ? warp_vals[lane] : Op::identity();
    for (int off = 16; off > 0; off >>= 1)
      v = Op::apply(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// One CTA combines `count` partials in a fixed order into out[0].
template <typename Op>
__global__ void reduce_partials_kernel(const double* __restrict__ partials,
                                       int64_t count,
                                       double* __restrict__ out) {
  double v = Op::identity();
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x)
    v = Op::apply(v, partials[i]);
  v = block_reduce<Op>(v);
  if (threadIdx.x == 0) out[0] = v;
}

// CTAs for a grid-stride kernel over n items, one item per thread.
inline int item_grid(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(1) << 30;
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace rt
