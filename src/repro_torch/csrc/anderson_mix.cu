// Hopper kernel for the Anderson/DIIS combine (paper Eq. 2 application).
//
// Replaces the Pallas TPU kernel src/repro/kernels/anderson_mix.py:46
// (anderson_mix, _mix_kernel): x_acc = sum_j alpha_j ((1 - beta) X_j +
// beta G_j) over an (h, N) window of iterate / map-value rows, h <= 16.
//
// Bound: bytes.  A call moves (h N + h + N) * 8 bytes at beta = 0 or 1
// (beta = 1 reads only G, beta = 0 only X; the Pallas kernel reads both)
// and (2 h N + h + N) * 8 otherwise, against two floating-point operations
// per window entry.  At an H100 SXM's 3.35 TB/s: 25.0 us at SCF's (9,
// 2^20), 16.7 us at VI's (6, 10^6), 70.1 us at Jacobi's (6, 2^22).
//
// The earlier kernel ran one thread per column over a runtime window depth
// (at most four 8-byte loads in flight a thread).  Measured before this
// design (kernel_bench; PERF.md, step 0): its device time was 85-90% of
// the bound at 32 MiB outputs and less at 8 MB, and most of what it lost
// to `a @ G` at short rows was its launcher's host time.  Here a thread
// combines one column pair: it puts the loads of every window row in
// flight before the first FMA (16-byte loads where each row starts on a
// 16-byte boundary, two 8-byte loads where it does not), and the grid has
// a thread for every pair, so the hardware keeps the SMs full as CTAs
// retire.  Loads and stores are streaming (`ld.global.cs`, `st.global.cs`):
// each byte is touched once.  The kernel is templated on h and on which
// rows it reads, so the window loop unrolls fully.  The grid is what a
// sweep of this kernel's plans measured fastest (launch/anderson_sweep.py);
// read-only loads were no faster at 32 MiB outputs and slower at 8 MB, and
// a persistent CTA per SM streaming tiles through a shared-memory ring of
// bulk copies (cp.async.bulk with mbarriers) was no faster at the three
// windows (PERF.md).  The launch plan is
// repro_torch.kernels.anderson_mix.mix_plan; rt_anderson_mix checks it and
// launches on the caller's stream and device.
//
// Arithmetic: acc = 0, then acc = fma(alpha_j, c_j, acc) for j ascending,
// the order and rounding the earlier kernel compiled its acc += a * c to,
// so at beta = 0 or 1 every plan gives that kernel's bits.

#include <cstdint>

#include <cuda_runtime.h>

// The C entry's launch arguments: the window, mix_plan's choices and the
// device (repro_torch.kernels.anderson_mix._Plan).
struct MixPlan {
  int64_t h, N, vector, grid, device;
};

namespace {

constexpr int kMaxH = 16;
constexpr int kThreads = 256;

enum Mix { kOnlyX = 0, kOnlyG = 1, kBoth = 2 };

// Window rows a kernel reads: the one window at beta = 0 or 1, X then G
// otherwise.
__host__ __device__ constexpr int rows_read(int h, int mode) {
  return mode == kBoth ? 2 * h : h;
}

// Row r of the rows a kernel reads: X_r, G_r, or (both) X_r then G_{r-H}.
template <int H, int kMode>
__device__ __forceinline__ const double* window_row(
    const double* __restrict__ X, const double* __restrict__ G, int r,
    int64_t N) {
  if (kMode == kOnlyX) return X + r * N;
  if (kMode == kOnlyG) return G + r * N;
  return r < H ? X + r * N : G + (r - H) * N;
}

// Columns c and c + 1 (c even) of a row: one 16-byte load where every row
// starts on a 16-byte boundary, two 8-byte loads where it does not.
template <bool kVector>
__device__ __forceinline__ double2 load_pair(const double* row, int64_t c) {
  if (kVector) return __ldcs(reinterpret_cast<const double2*>(row + c));
  return make_double2(__ldcs(row + c), __ldcs(row + c + 1));
}

template <int H, int kMode, bool kVector>
__global__ void __launch_bounds__(kThreads)
    mix_kernel(const double* __restrict__ X, const double* __restrict__ G,
               const double* __restrict__ alpha, double* __restrict__ out,
               int64_t N, double beta) {
  constexpr int R = rows_read(H, kMode);
  __shared__ double a[H];
  if (threadIdx.x < H) a[threadIdx.x] = alpha[threadIdx.x];
  __syncthreads();
  const double keep = 1.0 - beta;
  const int64_t pairs = N / 2;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t q = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; q < pairs;
       q += stride) {
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = load_pair<kVector>(window_row<H, kMode>(X, G, r, N), 2 * q);
    double acc0 = 0.0, acc1 = 0.0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      double2 c = v[j];
      if (kMode == kBoth)
        c = make_double2(keep * c.x + beta * v[H + j].x,
                         keep * c.y + beta * v[H + j].y);
      acc0 = __fma_rn(a[j], c.x, acc0);
      acc1 = __fma_rn(a[j], c.y, acc1);
    }
    __stcs(reinterpret_cast<double2*>(out) + q, make_double2(acc0, acc1));
  }
  if ((N & 1) && blockIdx.x == 0 && threadIdx.x == 0) {
    // the peeled last column of an odd N
    const int64_t i = N - 1;
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      double c = window_row<H, kMode>(X, G, j, N)[i];
      if (kMode == kBoth)
        c = keep * c + beta * window_row<H, kMode>(X, G, H + j, N)[i];
      acc = __fma_rn(a[j], c, acc);
    }
    out[i] = acc;
  }
}

struct Launch {
  const double* X;
  const double* G;
  const double* alpha;
  double* out;
  double beta;
  const MixPlan* p;
  cudaStream_t stream;
};

template <int kMode, int H, bool kVector>
void launch(const Launch& l) {
  mix_kernel<H, kMode, kVector>
      <<<static_cast<int>(l.p->grid), kThreads, 0, l.stream>>>(
          l.X, l.G, l.alpha, l.out, l.p->N, l.beta);
}

// The instantiation for window depth h and the plan's loads.
template <int kMode, int H = 1>
void dispatch(const Launch& l) {
  if constexpr (H <= kMaxH) {
    if (l.p->h != H) return dispatch<kMode, H + 1>(l);
    if (l.p->vector)
      launch<kMode, H, true>(l);
    else
      launch<kMode, H, false>(l);
  }
}

bool aligned16(const double* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whether the plan is one the kernel can run: 16-byte loads only from
// rows that all start on a 16-byte boundary.
bool valid(const MixPlan& p, int mode, const double* X, const double* G,
           const double* out) {
  if (p.h < 1 || p.h > kMaxH || p.N < 1 || p.grid < 1 ||
      p.grid > 0x7fffffff || !aligned16(out))
    return false;
  return !p.vector || (p.N % 2 == 0 && (mode == kOnlyG || aligned16(X)) &&
                       (mode == kOnlyX || aligned16(G)));
}

}  // namespace

// x_acc = sum_j alpha_j ((1 - beta) X_j + beta G_j) for an (h, N) window
// with row stride N, with the plan's loads and grid, on the plan's device
// and the given stream.  Returns cudaErrorInvalidValue for a plan the
// kernel cannot run, else the launch's cudaGetLastError().
extern "C" int rt_anderson_mix(const double* X, const double* G,
                               const double* alpha, double* out, double beta,
                               const MixPlan* plan, void* stream_ptr) {
  const int mode = beta == 1.0 ? kOnlyG : beta == 0.0 ? kOnlyX : kBoth;
  if (!valid(*plan, mode, X, G, out))
    return static_cast<int>(cudaErrorInvalidValue);
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool switch_device = caller != plan->device;
  if (switch_device) err = cudaSetDevice(static_cast<int>(plan->device));
  if (err == cudaSuccess) {
    const Launch l{X, G, alpha, out, beta, plan,
                   static_cast<cudaStream_t>(stream_ptr)};
    if (mode == kOnlyX)
      dispatch<kOnlyX>(l);
    else if (mode == kOnlyG)
      dispatch<kOnlyG>(l);
    else
      dispatch<kBoth>(l);
    err = cudaGetLastError();
  }
  if (switch_device) cudaSetDevice(caller);
  return static_cast<int>(err);
}
