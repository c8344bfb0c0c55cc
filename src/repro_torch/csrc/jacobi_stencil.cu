// Hopper kernels for the five-point Jacobi stencil (paper §3.3.1).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/jacobi_stencil.py:
//
// * jacobi_halo_sweeps (_halo_kernel): `sweeps` sweeps of a (rows, g) row
//   block with frozen halo rows `top`/`bot` and Dirichlet zero columns,
//   plus sum((new - xb)^2).  The Pallas kernel keeps the whole block in
//   VMEM across all sweeps.  Bound on an H100 SXM (3.35 TB/s): xb, b and
//   the output once each, 3 x 8 B per cell (25 MB, 7.5 us, at the device
//   plane's 512 x 2048 block); the 5 operations per cell and sweep take
//   1.6 us at the float64 rate.  An 8 MB block does not fit in the 227 KB
//   of shared memory of one SM, so the design is temporal blocking with
//   ghost zones.  A CTA owns an output tile and loads, once, the tile plus
//   a ghost zone k cells deep on every side (k = the pass's sweeps) over a
//   fixed 64 x 128 region: x and b by 16-byte cp.async (8-byte where rows
//   are not 16-byte aligned); a frozen halo row or a zero column stands in
//   where the region meets the block's edge, and the cells beyond it are
//   never read by a cell that counts.  It then runs the k sweeps on chip.
//   A thread keeps 4 x 4 cells and their b in registers; a warp spans the
//   region's width, so a row's outer neighbours come from the lanes beside
//   by shuffles, and only each warp's first and last rows cross shared
//   memory (a ping-pong pair of buffers, one barrier per sweep).  Errors
//   enter at the region's rim and move in by one cell per sweep, so after
//   k sweeps the (64 - 2k) x (128 - 2k') interior is exact (k' = k rounded
//   up to even, so copies stay aligned); the CTA writes it and its partial
//   of the norm (against xb) in the same pass.  CTAs are persistent, one
//   per SM (a thread holds 128 registers), and stage the next tile's
//   region by cp.async while they sweep this one.  Sweeps above kMaxDepth
//   run as several passes, one launch each, through one scratch block.
//   Partials are one per tile of the last pass, summed by a one-CTA pass
//   in a fixed order: deterministic, no atomics, ceil(sweeps / kMaxDepth)
//   + 1 launches (2 at 10 sweeps; the per-sweep kernels this replaced took
//   11 and streamed the block through L2 each sweep).  What bounds it: the
//   loads of the regions (1.7x the block's x and b at k = 10) and the
//   sweeps' shuffle and shared-memory traffic over the same 1.7x cells, of
//   which one SM overlaps only the next tile's load.  Values keep the
//   reference's order, (b + (((up + down) + left) + right)) / 4: adds and
//   an exact division, nothing to contract, so they equal the plain
//   version bit for bit.
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

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

// jacobi_halo_sweeps: a CTA of kHaloThreads threads sweeps a kRegionRows x
// kRegionCols region; warp w owns rows kV * w .. kV * w + kV - 1 and lane l
// columns kU * l .. kU * l + kU - 1 of them, so a warp spans the region's
// width and a row's left and right neighbours come from the lanes beside.
constexpr int kHaloThreads = 512;
constexpr int kWarps = kHaloThreads / 32;                // 16
constexpr int kV = 4;                                    // rows per thread
constexpr int kU = 4;                                    // columns per thread
constexpr int kRegionRows = kWarps * kV;                 // 64
constexpr int kRegionCols = 32 * kU;                     // 128
constexpr int kRegionCells = kRegionRows * kRegionCols;
constexpr int kEdgeCells = 2 * kWarps * kRegionCols;     // first, last rows
constexpr int kMaxDepth = 16;  // sweeps one pass runs (its ghost depth)
// staged x and b of one region, then two buffers of warp edge rows
constexpr int kHaloSmem =
    (2 * kRegionCells + 2 * kEdgeCells) * int(sizeof(double));  // 192 KB

// Output tile of a pass that runs k sweeps: rows and columns.
__host__ __device__ __forceinline__ int tile_rows(int k) {
  return kRegionRows - 2 * k;
}
__host__ __device__ __forceinline__ int col_depth(int k) {
  return k + (k & 1);
}
__host__ __device__ __forceinline__ int tile_cols(int k) {
  return kRegionCols - 2 * col_depth(k);
}

// Slot of column j in a shared row: 16-byte chunks 8..15 of every 16 are
// swapped in pairs, so that the 8 lanes of a quarter warp reading chunks
// 2l (or 2l + 1) hit 8 different bank groups.
__device__ __forceinline__ int swz(int j) {
  const int q = j >> 1;
  return ((q ^ ((q >> 3) & 1)) << 1) | (j & 1);
}

__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         bool valid, int bytes) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;  // 0: zero-fill, nothing is read
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     saddr), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     saddr), "l"(src), "r"(n) : "memory");
}

// kU consecutive values of a shared row, from column kU * lane.
__device__ __forceinline__ void load_row(const double* row, int lane,
                                         double* v) {
  const double2 a = *reinterpret_cast<const double2*>(row + swz(kU * lane));
  const double2 c =
      *reinterpret_cast<const double2*>(row + swz(kU * lane + 2));
  v[0] = a.x; v[1] = a.y; v[2] = c.x; v[3] = c.y;
}

__device__ __forceinline__ void store_row(double* row, int lane,
                                          const double* v) {
  *reinterpret_cast<double2*>(row + swz(kU * lane)) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(row + swz(kU * lane + 2)) =
      make_double2(v[2], v[3]);
}

// One pass of k frozen-halo sweeps over `tiles` output tiles; CTAs are
// persistent and take tiles blockIdx.x, + gridDim.x, ...  src -> dst; when
// `partials` is set (the last pass) tile t also writes partials[t], its
// part of sum((dst - x0)^2).  kVec: every row start is 16-byte aligned (g
// even, aligned pointers), so copies and stores move column pairs.
template <bool kVec>
__global__ void __launch_bounds__(kHaloThreads, 1) halo_pass_kernel(
    const double* __restrict__ src, const double* __restrict__ top,
    const double* __restrict__ bot, const double* __restrict__ b,
    const double* __restrict__ x0, double* __restrict__ dst,
    double* __restrict__ partials, int64_t rows, int64_t g, int k,
    int64_t tiles_x, int64_t tiles) {
  extern __shared__ __align__(16) double smem[];
  double* const sx = smem;                       // staged x
  double* const sb = smem + kRegionCells;        // staged b
  double* const edges = smem + 2 * kRegionCells;  // [2][first/last][warp]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kc = col_depth(k);
  const int tr = tile_rows(k);
  const int tc = tile_cols(k);

  // Stage x and b of a tile's region: rows -1 and `rows` are the frozen
  // halos, everything else outside the block is zero.
  const auto stage = [&](int64_t tile) {
    constexpr int kWidth = kVec ? 2 : 1;
    const int64_t ty = tile / tiles_x;
    const int64_t ro = ty * tr - k;
    const int64_t co = (tile - ty * tiles_x) * tc - kc;
#pragma unroll 4
    for (int id = threadIdx.x; id < kRegionCells / kWidth;
         id += kHaloThreads) {
      const int i = id / (kRegionCols / kWidth);
      const int j = (id - i * (kRegionCols / kWidth)) * kWidth;
      const int64_t r = ro + i;
      const int64_t c = co + j;
      const bool col_ok = c >= 0 && c < g;
      const bool in_rows = r >= 0 && r < rows;
      const double* xrow = in_rows ? src + r * g
                           : r == -1 ? top : r == rows ? bot : nullptr;
      const bool x_ok = col_ok && xrow != nullptr;
      const int at = i * kRegionCols + swz(j);
      cp_async(sx + at, x_ok ? xrow + c : src, x_ok, 8 * kWidth);
      cp_async(sb + at, col_ok && in_rows ? b + r * g + c : b,
               col_ok && in_rows, 8 * kWidth);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int64_t tile = blockIdx.x;
  stage(tile);
  for (; tile < tiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const int64_t ty = tile / tiles_x;
    const int64_t ro = ty * tr - k;
    const int64_t co = (tile - ty * tiles_x) * tc - kc;

    // This thread's kV x kU cells into registers; then the staging buffer
    // takes the next tile while this one is swept.
    double x[kV][kU], bv[kV][kU];
    unsigned row_in = 0, col_in = 0;  // the block's cells are swept; the
#pragma unroll                        // rest are frozen or never read
    for (int v = 0; v < kV; ++v) {
      const int i = warp * kV + v;
      load_row(sx + i * kRegionCols, lane, x[v]);
      load_row(sb + i * kRegionCols, lane, bv[v]);
      row_in |= unsigned(ro + i >= 0 && ro + i < rows) << v;
    }
#pragma unroll
    for (int c = 0; c < kU; ++c) {
      const int64_t col = co + kU * lane + c;
      col_in |= unsigned(col >= 0 && col < g) << c;
    }
    __syncthreads();
    if (tile + gridDim.x < tiles) stage(tile + gridDim.x);

    // k sweeps.  Each sweep reads the warps' first and last rows from one
    // edge buffer and writes them to the other.  At the region's rim the
    // neighbours read are clamped (wrong) cells; their errors move in by
    // one cell per sweep and miss the output tile.
    const int up_warp = warp > 0 ? warp - 1 : 0;
    const int dn_warp = warp + 1 < kWarps ? warp + 1 : kWarps - 1;
    const auto store_edges = [&](double* e) {
      store_row(e + warp * kRegionCols, lane, x[0]);
      store_row(e + (kWarps + warp) * kRegionCols, lane, x[kV - 1]);
    };
    store_edges(edges);
    __syncthreads();
    for (int s = 1; s <= k; ++s) {
      const double* e = edges + ((s - 1) & 1) * kEdgeCells;
      double prev[kU], below[kU];
      load_row(e + (kWarps + up_warp) * kRegionCols, lane, prev);
      load_row(e + dn_warp * kRegionCols, lane, below);
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const double left = __shfl_up_sync(0xffffffffu, x[v][kU - 1], 1);
        const double right = __shfl_down_sync(0xffffffffu, x[v][0], 1);
        double nv[kU];
#pragma unroll
        for (int c = 0; c < kU; ++c) {
          const double up = prev[c];
          const double down = v + 1 < kV ? x[v + 1][c] : below[c];
          const double l = c > 0 ? x[v][c - 1] : left;
          const double r = c + 1 < kU ? x[v][c + 1] : right;
          nv[c] = (bv[v][c] + (((up + down) + l) + r)) / 4.0;
        }
#pragma unroll
        for (int c = 0; c < kU; ++c) {
          prev[c] = x[v][c];
          if ((row_in >> v & col_in >> c) & 1u) x[v][c] = nv[c];
        }
      }
      if (s < k) {
        store_edges(edges + (s & 1) * kEdgeCells);
        __syncthreads();
      }
    }

    // The output tile: region rows k .. k + tr, columns kc .. kc + tc
    // (whole column pairs, as kc and tc are even), inside the block.
    double acc = 0.0;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int i = warp * kV + v;
      const int64_t r = ro + i;
      if (i < k || i >= k + tr || r >= rows) continue;
#pragma unroll
      for (int c = 0; c < kU; c += 2) {
        const int j = kU * lane + c;
        const int64_t at = r * g + co + j;
        if (j < kc || j >= kc + tc) continue;
        if (kVec) {
          if (!(col_in >> c & 1u)) continue;
          *reinterpret_cast<double2*>(dst + at) =
              make_double2(x[v][c], x[v][c + 1]);
          if (partials != nullptr) {
            const double2 o = *reinterpret_cast<const double2*>(x0 + at);
            const double d0 = x[v][c] - o.x, d1 = x[v][c + 1] - o.y;
            acc += d0 * d0;
            acc += d1 * d1;
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!(col_in >> (c + h) & 1u)) continue;
            dst[at + h] = x[v][c + h];
            if (partials != nullptr) {
              const double d = x[v][c + h] - x0[at + h];
              acc += d * d;
            }
          }
        }
      }
    }
    if (partials != nullptr) {
      acc = rt::block_reduce<rt::SumOp>(acc);
      if (threadIdx.x == 0) partials[tile] = acc;
    }
  }
}

// The current device's SM count, after allowing both halo kernels their
// dynamic shared memory; both are done once per device (a call's host
// time is otherwise a large share of the kernel's).
constexpr int kMaxDevices = 64;
std::atomic<int> g_halo_sms[kMaxDevices];  // 0 until a device's first call

cudaError_t halo_device_setup(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = g_halo_sms[device].load(std::memory_order_acquire);
  if (n == 0) {
    using Kernel = decltype(&halo_pass_kernel<true>);
    const Kernel kernels[] = {halo_pass_kernel<true>, halo_pass_kernel<false>};
    for (const Kernel kernel : kernels) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHaloSmem);
      if (err != cudaSuccess) return err;
    }
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    g_halo_sms[device].store(n, std::memory_order_release);
  }
  *sms = n;
  return cudaSuccess;
}

// Sweeps of pass `pass` of `passes`: as even a split as can be.
inline int pass_depth(int64_t sweeps, int64_t passes, int64_t pass) {
  return static_cast<int>(sweeps / passes + (pass < sweeps % passes));
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

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

// out[0]: the passes one call of `sweeps` sweeps takes (one launch each);
// out[1]: the output tiles of its last pass, i.e. the partial norms.
extern "C" int rt_jacobi_halo_plan(int64_t rows, int64_t g, int64_t sweeps,
                                   int64_t* out) {
  if (rows < 1 || g < 1 || sweeps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t passes = ceil_div(sweeps, kMaxDepth);
  const int k = pass_depth(sweeps, passes, passes - 1);
  out[0] = passes;
  out[1] = ceil_div(rows, tile_rows(k)) * ceil_div(g, tile_cols(k));
  return 0;
}

extern "C" int rt_jacobi_halo_sweeps(const double* xb, const double* top,
                                     const double* bot, const double* b,
                                     double* out, double* scratch,
                                     double* partials, int64_t partials_len,
                                     double* norm, int64_t rows, int64_t g,
                                     int64_t sweeps, void* stream_ptr) {
  int64_t plan[2];
  const int bad = rt_jacobi_halo_plan(rows, g, sweeps, plan);
  if (bad != 0) return bad;
  const int64_t passes = plan[0];
  if (partials_len < plan[1] || (passes > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool vec = g % 2 == 0 && aligned(xb) && aligned(top) &&
                   aligned(bot) && aligned(b) && aligned(out) &&
                   (passes == 1 || aligned(scratch));
  // One persistent CTA per SM (the kernel holds an SM's registers).
  int sms = 0;
  cudaError_t err = halo_device_setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = vec ? halo_pass_kernel<true> : halo_pass_kernel<false>;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const double* src = xb;
  int64_t tiles = 0;
  for (int64_t pass = 0; pass < passes; ++pass) {
    const int k = pass_depth(sweeps, passes, pass);
    const int64_t tiles_x = ceil_div(g, tile_cols(k));
    tiles = ceil_div(rows, tile_rows(k)) * tiles_x;
    // The last pass must land in `out`: alternate backwards from it.
    double* dst = (passes - 1 - pass) % 2 == 0 ? out : scratch;
    const bool last = pass == passes - 1;
    const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
    kernel<<<grid, kHaloThreads, kHaloSmem, stream>>>(
        src, top, bot, b, xb, dst, last ? partials : nullptr, rows, g, k,
        tiles_x, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  rt::reduce_partials_kernel<rt::SumOp><<<1, rt::kThreads, 0, stream>>>(
      partials, tiles, norm);
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
