// Hopper kernels for the five-point Jacobi stencil (paper §3.3.1).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/jacobi_stencil.py:
//
// * jacobi_halo_sweeps (_halo_kernel): `sweeps` sweeps of a (rows, g) row
//   block with frozen halo rows, plus sum((new - blk0)^2).  The Pallas
//   kernel keeps the whole block in VMEM for all sweeps; at the device
//   plane's 512 x 2048 float64 block that is 8 MB, far beyond the 227 KB of
//   shared memory one SM offers.  This port launches one kernel per sweep
//   and ping-pongs between the output and one scratch buffer, so every
//   sweep streams the block through L2 (the 8 MB block and b fit in the
//   50 MB L2).  Bound on an H100 SXM (3.35 TB/s): the inputs and output,
//   3 x 8 MB, are ~7.5 us; the per-sweep design moves ~25 MB per sweep,
//   mostly from L2.  The last sweep also writes one partial norm per CTA
//   and a one-CTA pass sums the partials in a fixed order: deterministic,
//   no atomics.  Values keep the reference's order,
//   (b + (((up + down) + left) + right)) / 4, so they equal the plain
//   version bit for bit (adds and an exact division: nothing to contract).
//
// * jacobi_sweep (_jacobi_kernel): one global Dirichlet sweep of a g x g
//   grid.  The Pallas kernel gets its row halo by binding the operand three
//   times with shifted BlockSpecs; here each CTA stages a 32 x 8 tile plus
//   its one-deep halo in shared memory (zero outside the grid), so each
//   value is read from device memory about once.  Bound: x, b and the
//   output, 3 x 8 B x g^2 (100.7 MB at g = 2048, ~30 us at 3.35 TB/s).  A
//   template flag picks the add order: the Pallas kernel's own,
//   ((((b + up) + down) + left) + right) * 0.25, or that of the reference
//   problem's default jnp sweep (_full_sweep), (b + (((up + down) + left)
//   + right)) / 4.  Both are adds and an exact scaling, so each equals its
//   plain version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__device__ __forceinline__ double halo_point(
    const double* __restrict__ src, const double* __restrict__ top,
    const double* __restrict__ bot, const double* __restrict__ b,
    int64_t r, int64_t c, int64_t rows, int64_t g) {
  const int64_t i = r * g + c;
  const double up = (r == 0) ? top[c] : src[i - g];
  const double down = (r == rows - 1) ? bot[c] : src[i + g];
  const double left = (c == 0) ? 0.0 : src[i - 1];
  const double right = (c == g - 1) ? 0.0 : src[i + 1];
  const double nb = ((up + down) + left) + right;
  return (b[i] + nb) / 4.0;
}

__global__ void halo_sweep_kernel(const double* __restrict__ src,
                                  const double* __restrict__ top,
                                  const double* __restrict__ bot,
                                  const double* __restrict__ b,
                                  double* __restrict__ dst, int64_t rows,
                                  int64_t g) {
  const int64_t n = rows * g;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t r = i / g;
    dst[i] = halo_point(src, top, bot, b, r, i - r * g, rows, g);
  }
}

// The last sweep: also one partial of sum((new - blk0)^2) per CTA.
__global__ void halo_last_sweep_kernel(const double* __restrict__ src,
                                       const double* __restrict__ top,
                                       const double* __restrict__ bot,
                                       const double* __restrict__ b,
                                       const double* __restrict__ blk0,
                                       double* __restrict__ dst,
                                       double* __restrict__ partials,
                                       int64_t rows, int64_t g) {
  const int64_t n = rows * g;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  double acc = 0.0;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t r = i / g;
    const double v = halo_point(src, top, bot, b, r, i - r * g, rows, g);
    dst[i] = v;
    const double d = v - blk0[i];
    acc += d * d;
  }
  acc = rt::block_reduce<rt::SumOp>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__device__ __forceinline__ double grid_value(const double* __restrict__ x,
                                             int64_t r, int64_t c,
                                             int64_t g) {
  return (r >= 0 && r < g && c >= 0 && c < g) ? x[r * g + c] : 0.0;
}

template <bool kJnpOrder>
__global__ void jacobi_sweep_kernel(const double* __restrict__ x,
                                    const double* __restrict__ b,
                                    double* __restrict__ out, int64_t g) {
  __shared__ double tile[kTileY + 2][kTileX + 2];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t c = int64_t(blockIdx.x) * kTileX + tx;
  const int64_t r = int64_t(blockIdx.y) * kTileY + ty;
  tile[ty + 1][tx + 1] = grid_value(x, r, c, g);
  if (ty == 0) tile[0][tx + 1] = grid_value(x, r - 1, c, g);
  if (ty == kTileY - 1) tile[kTileY + 1][tx + 1] = grid_value(x, r + 1, c, g);
  if (tx == 0) tile[ty + 1][0] = grid_value(x, r, c - 1, g);
  if (tx == kTileX - 1) tile[ty + 1][kTileX + 1] = grid_value(x, r, c + 1, g);
  __syncthreads();
  if (r < g && c < g) {
    const double up = tile[ty][tx + 1];
    const double down = tile[ty + 2][tx + 1];
    const double left = tile[ty + 1][tx];
    const double right = tile[ty + 1][tx + 2];
    out[r * g + c] =
        kJnpOrder ? (b[r * g + c] + (((up + down) + left) + right)) / 4.0
                  : ((((b[r * g + c] + up) + down) + left) + right) * 0.25;
  }
}

}  // namespace

extern "C" int rt_jacobi_halo_sweeps(const double* xb, const double* top,
                                     const double* bot, const double* b,
                                     double* out, double* scratch,
                                     double* partials, int64_t partials_len,
                                     double* norm, int64_t rows, int64_t g,
                                     int64_t sweeps, void* stream_ptr) {
  if (rows < 1 || g < 1 || sweeps < 1 || partials_len < rt::kMaxPartials)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n = rows * g;
  const int grid = rt::item_grid(n);
  const int last_grid = rt::partial_grid(n);
  const double* src = xb;
  for (int64_t s = 0; s < sweeps; ++s) {
    // The last sweep must land in `out`: alternate backwards from it.
    double* dst = ((sweeps - 1 - s) % 2 == 0) ? out : scratch;
    if (s == sweeps - 1) {
      halo_last_sweep_kernel<<<last_grid, rt::kThreads, 0, stream>>>(
          src, top, bot, b, xb, dst, partials, rows, g);
    } else {
      halo_sweep_kernel<<<grid, rt::kThreads, 0, stream>>>(src, top, bot, b,
                                                            dst, rows, g);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  rt::reduce_partials_kernel<rt::SumOp><<<1, rt::kThreads, 0, stream>>>(
      partials, last_grid, norm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_jacobi_sweep(const double* x, const double* b, double* out,
                               int64_t g, int64_t jnp_order,
                               void* stream_ptr) {
  const int64_t gx = (g + kTileX - 1) / kTileX;
  const int64_t gy = (g + kTileY - 1) / kTileY;
  if (g < 1 || gy > 65535 || gx > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 block(kTileX, kTileY);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  if (jnp_order)
    jacobi_sweep_kernel<true><<<grid, block, 0, stream>>>(x, b, out, g);
  else
    jacobi_sweep_kernel<false><<<grid, block, 0, stream>>>(x, b, out, g);
  return static_cast<int>(cudaGetLastError());
}
