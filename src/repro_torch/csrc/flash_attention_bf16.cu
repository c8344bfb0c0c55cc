// Hopper tensor-core kernel for bfloat16 grouped-query flash attention
// (forward).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) for bfloat16 inputs: out = softmax(mask(
// cap(q k^T / sqrt(hd)))) v for q (B, Sq, nq, hd) and k, v (B, Skv, nkv,
// hd), accumulated in float32 and written in bfloat16.  Options: causal
// (qpos >= kpos), a sliding window (qpos - kpos < window), a softcap
// c * tanh(s / c), and q_offset (query row i sits at position i + q_offset,
// negative too).  Masked scores are -2e38 and masked probabilities are
// zeroed, as in the Pallas kernel; a row with no unmasked key comes out as
// zeros.  The float32 kernel is csrc/flash_attention.cu.
//
// Bound on an H100 SXM: 4 hd operations per unmasked (q, k) pair and q
// head, both products on the bfloat16 tensor cores (989 TFLOP/s dense).  At
// the Gemma-2-2B serve shape (B 2, S 8192, 8 q heads, 4 kv heads, hd 256)
// that is 0.417 ms for a local layer (window 4096) and 0.556 ms for a
// global one, against ~0.1 GB of q, k, v and o (~30 us): the kernel is
// bound by the tensor cores.  At hd 256 a score costs ~1,024 MMA
// operations and 1 (2 with the softcap) MUFU operations, so the
// exponentials cost issue slots but do not set the bound.
//
// Design (one CTA per SM at hd 256: 3 warpgroups, 224 KB of shared memory):
// * Both products on wgmma.  S = Q K^T (m64nBNk16, Q and K K-major in
//   shared memory) and O += P V (m64n256k16 at hd 256, P from registers, V
//   read MN-major from shared memory).  The softcap, masks and online
//   softmax run on S's float32 accumulator fragments in registers, with
//   each exponent one FFMA before ex2; P is rounded to bfloat16 in
//   registers and fed as wgmma's A operand (FlashAttention-2/3 do the
//   same; the reference's bfloat16 math rounds its normalised weights,
//   models/attention.py).  The head dim is padded to a multiple of 64
//   (hd 16 and 32 read zeros past hd), so every operand is rows of 128
//   bytes in the 128-byte swizzle.  BN, the keys a tile, is 80 at hd 256
//   (Tile below) and 128 at smaller head dims.
// * TMA.  One producer warpgroup, lowered to 24 registers by setmaxnreg
//   (the consumers raised to 240: O alone is 128 registers a thread at hd
//   256), where one thread loads Q once and K tiles and another V tiles,
//   through tensor maps over the strided (B, S, heads, hd) layout, into
//   rings of 2 K and 2 V stages with full/empty mbarriers.  Keys past Skv
//   and before 0 come back zero-filled.  The maps are encoded on the host
//   (the driver's cuTensorMapEncodeTiled, fetched with
//   cudaGetDriverEntryPointByVersion: no -lcuda) and cached per pointer,
//   shape and strides.  Descriptors are rebuilt from an opaque base every
//   tile: hoisted out of the loop they spilled beside O.
// * GQA sharing.  The CTA's two consumer warpgroups take two 64-row query
//   blocks of one kv head: two q heads of the group at the same rows when
//   the group is even (Gemma-2: 2), else neighbouring row blocks, so each
//   K/V tile is loaded once for both.  The CTA walks the union of their key
//   bands.
// * Overlap (FlashAttention-3's order).  Each warpgroup issues S(n) = Q
//   K(n)^T, rescales O to tile n - 1's max while it runs, issues O +=
//   P(n-1) V(n-1), then runs the softmax of tile n while that product is in
//   flight; two named barriers make the warpgroups take turns issuing, so
//   one's softmax runs under the other's products.
// * Kept from the float32 design: key tiles wholly outside the causal/
//   window band are skipped (the tiles end at the band's last key, so the
//   diagonal is one tile); masks are evaluated only on tiles that cross
//   the band's edge or Skv's end (a second copy of the softmax); the
//   heaviest query blocks run first, across every (batch, kv head) in a
//   wave.
// * The softcap's tanh is tanh.approx.f32: its 2^-11 relative error is at
//   most ~5e-4 |s| in a capped score, a quarter of the 2^-9 to which the
//   reference's bfloat16 math rounds every score.
// * Measured and not kept (chip runs of compile-time variants): 64-key
//   tiles at hd 256, three K or three V stages, no ping-pong barriers, the
//   other warpgroup released only after S(n) completes.  Loading every other tile only (an L2 test) or
//   reading S's A operand from registers (a shared-memory test) left the
//   products' time where it was: the remaining gap to the bound is in the
//   tensor pipe's issue and synchronisation, not in L2 or shared memory.

#include <cuda.h>  // CUtensorMap and its enums; the driver call is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // query rows per consumer warpgroup
constexpr int kRowBytes = 128; // one swizzled row: 64 bfloat16 of the head dim
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;   // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240;  // <= 65,536 registers of the SM
constexpr float kNeg = -2.0e38f;
constexpr int kMaxLen = 1 << 28;  // sequence lengths and |q_offset|
constexpr int kKStages = 2, kVStages = 2;  // 3 K or 3 V stages ran slower

// NC chunks of 64 head-dim elements; every block is [rows][64] bfloat16,
// rows * 128 bytes, 1024-byte aligned (the swizzle's period).
template <int NC, int BN>
struct Smem {
  bf16 q[kConsumers][NC][kBM * 64];
  bf16 k[kKStages][NC][BN * 64];
  bf16 v[kVStages][NC][BN * 64];
  uint64_t q_full;
  uint64_t k_full[kKStages], k_empty[kKStages];
  uint64_t v_full[kVStages], v_empty[kVStages];
};

struct Params {
  bf16* o;
  int Sq, Skv, q_offset, window;  // |each| <= kMaxLen: positions fit int
  int B, nq, nkv, group, hd;
  int n_items, n_pairs;  // 64-row query blocks of one kv head, and pairs
  int causal, has_window;
  float s_mul;  // raw score -> tanh's argument: scale / cap
  float c_mul;  // a score unit -> log2 units: scale log2(e), or cap log2(e)
};

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Named barriers 1 and 2 order the two consumer warpgroups' issue turns.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers in program order around asynchronous wgmma (the compiler
// must not move their reads or writes across the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (uint64_t(1) << 62);
}

// wgmma wrappers, d (+)= A B for a 64 x N tile and K 16 with float32
// accumulators d[N / 2] in the warpgroup's fragment layout.  Ss: A and B
// K-major in shared memory (S = Q K^T; ``accumulate`` 0 starts from zero).
// Rs: A in registers (4 x 2 bfloat16, P), B MN-major in shared memory (V,
// read transposed), accumulating.
template <int N> struct Ss;
template <int N> struct Rs;

template <>
struct Ss<80> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Ss<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Rs<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Rs<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Rs<256> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One consumer warpgroup's 64-row query block.
struct Item {
  int head;
  int q0, q_first, q_last;  // first row; first and last position
  int lo, hi;               // its key band [lo, hi), empty if hi <= lo
  bool store;
};

__device__ __forceinline__ Item item_of(const Params& p, int kvh, int idx) {
  Item it;
  it.store = idx < p.n_items;
  if (!it.store) idx = p.n_items - 1;  // an odd count: a duplicate, unstored
  it.head = kvh * p.group + idx % p.group;
  it.q0 = (idx / p.group) * kBM;
  const int rows = (it.q0 + kBM < p.Sq ? it.q0 + kBM : p.Sq) - it.q0;
  it.q_first = it.q0 + p.q_offset;
  it.q_last = it.q_first + rows - 1;
  it.hi = p.Skv;
  if (p.causal && it.q_last + 1 < it.hi) it.hi = it.q_last + 1;
  it.lo = 0;
  if (p.has_window && it.q_first - p.window + 1 > 0)
    it.lo = it.q_first - p.window + 1;
  return it;
}

// Tiles by head-dim chunks NC: keys per tile and the N of each P V wgmma.
// At hd 256 a 64 x 256 float32 O takes 128 registers a thread, so the key
// tile is 80 (S 40 registers, and two K and two V stages of 40 KB beside
// Q's 64 KB fill the 227 KB; 64-key tiles ran slower); smaller head dims
// take 128 keys.
template <int NC> struct Tile;
template <> struct Tile<1> { static constexpr int BN = 128, PVN = 64; };
template <> struct Tile<2> { static constexpr int BN = 128, PVN = 128; };
template <> struct Tile<4> { static constexpr int BN = 80, PVN = 256; };

template <int NC, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int BN = Tile<NC>::BN, PVN = Tile<NC>::PVN;
  constexpr int NS = BN / 2;   // score registers a thread
  constexpr int KS = BN / 16;  // k-steps of P V
  static_assert(BN % 16 == 0 && (NC * 64) % PVN == 0, "tile shapes");
  extern __shared__ uint8_t smem_raw[];
  Smem<NC, BN>& sm = *reinterpret_cast<Smem<NC, BN>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  // The CTA's pair of query blocks: the heaviest pairs first, every
  // (batch, kv head) in each wave.
  const int heads = p.B * p.nkv;
  const int bh = blockIdx.x % heads;
  const int pair = p.n_pairs - 1 - static_cast<int>(blockIdx.x / heads);
  const int b = bh / p.nkv, kvh = bh % p.nkv;
  // The union of the two blocks' key bands, in T tiles from kv_first that
  // end at its last key (computed in each role, after its setmaxnreg).
  int T, kv_first;
  auto tiles = [&](const Item& a, const Item& c) {
    int lo = INT32_MAX, hi = INT32_MIN;
    if (a.hi > a.lo) { lo = a.lo; hi = a.hi; }
    if (c.hi > c.lo) {
      lo = c.lo < lo ? c.lo : lo;
      hi = c.hi > hi ? c.hi : hi;
    }
    T = hi > lo ? static_cast<int>((hi - lo + BN - 1) / BN) : 0;
    kv_first = T > 0 ? hi - T * BN : 0;
  };

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.v_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: lane 0 of warp 0 loads Q and K, of warp 1 V ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int warp = tid / 32;
    const Item mine = item_of(p, kvh, 2 * pair);
    const Item other = item_of(p, kvh, 2 * pair + 1);
    tiles(mine, other);
    if (tid % 32 == 0 && warp < 2 && T > 0) {
      if (warp == 0) {
        mbar_expect_tx(&sm.q_full, kConsumers * NC * kBM * kRowBytes);
        for (int w = 0; w < kConsumers; ++w) {
          const Item it = w == 0 ? mine : other;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load(sm.q[w][c], &tq, &sm.q_full, c * 64, it.q0, it.head, b);
        }
      }
      uint64_t* full = warp == 0 ? sm.k_full : sm.v_full;
      uint64_t* empty = warp == 0 ? sm.k_empty : sm.v_empty;
      const CUtensorMap* map = warp == 0 ? &tk : &tv;
      const int stages = warp == 0 ? kKStages : kVStages;
      for (int n = 0; n < T; ++n) {
        const int s = n % stages;
        bf16* dst = warp == 0 ? sm.k[s][0] : sm.v[s][0];
        const int kv0 = kv_first + n * BN;
        mbar_wait(&empty[s], ((n / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], NC * BN * kRowBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(dst + c * BN * 64, map, &full[s], c * 64, kv0, kvh, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: 64 query rows of q head mine.head ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const Item mine = item_of(p, kvh, 2 * pair + wg);
    tiles(mine, item_of(p, kvh, 2 * pair + 1 - wg));
    const int lane = tid % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;  // rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);              // first column of a pair
    // Fragment element i of a 64 x N accumulator: row r0 + 8 ((i % 4) / 2),
    // column 8 (i / 4) + c0 + i % 2.
    float o[NC * 32];
#pragma unroll
    for (int i = 0; i < NC * 32; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg};  // running max, in score units
    float l[2] = {0.f, 0.f};    // this thread's share of the running sum
    float s[NS];
    uint32_t pa[KS][4];  // P in bfloat16: the A operand of each k-step

    const uint32_t q_addr = smem_u32(sm.q[wg][0]);
    // Descriptors are rebuilt from an opaque base each tile: hoisted out
    // of the loop, the 4 NC of them would not fit beside O and spill.
    auto issue_qk = [&](int st) {
      uint32_t qa = q_addr, ka = smem_u32(sm.k[st][0]);
      asm volatile("" : "+r"(qa), "+r"(ka));
      const uint64_t dq = desc_sw128(qa, 16, 8 * kRowBytes);
      const uint64_t dk = desc_sw128(ka, 16, 8 * kRowBytes);
#pragma unroll
      for (int kk = 0; kk < 4 * NC; ++kk) {
        const uint32_t in_row = (kk % 4) * 32;  // 16 elements a k-step
        Ss<BN>::mma(s, dq + (((kk / 4) * kBM * kRowBytes + in_row) >> 4),
                    dk + (((kk / 4) * BN * kRowBytes + in_row) >> 4),
                    kk > 0);
      }
    };
    auto issue_pv = [&](int st) {
      uint32_t va = smem_u32(sm.v[st][0]);
      asm volatile("" : "+r"(va));
      const uint64_t dv = desc_sw128(va, BN * kRowBytes, 8 * kRowBytes);
#pragma unroll
      for (int c = 0; c < NC * 64 / PVN; ++c)
#pragma unroll
        for (int kb = 0; kb < KS; ++kb)
          Rs<PVN>::mma(o + c * (PVN / 2), pa[kb],
                       dv + ((c * (PVN / 64) * BN * kRowBytes +
                              kb * 16 * kRowBytes) >> 4));
    };
    // Softmax of tile n in place on s (scores -> P), returning the factors
    // that rescale O and l to the new running max.  A score unit is the raw
    // score (no softcap) or tanh(s scale / cap); c_mul takes it to log2
    // units, folded into one FFMA before each exp2.
    auto softmax = [&](int n, float (&alpha)[2]) {
      const int kv0 = kv_first + n * BN;
      const bool full =
          kv0 >= 0 && kv0 + BN <= p.Skv &&
          (!p.causal || mine.q_first >= kv0 + BN - 1) &&
          (!p.has_window || mine.q_last - kv0 < p.window);
      auto body = [&](auto masked) {
        constexpr bool MASK = decltype(masked)::value;
        float mx[2] = {kNeg, kNeg};
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float x = s[i];
          if constexpr (CAP) x = tanh_approx(x * p.s_mul);
          if constexpr (MASK) {
            const int kpos = kv0 + 8 * (i / 4) + c0 + (i % 2);
            const int qpos = mine.q_first + r0 + 8 * ((i % 4) / 2);
            const bool ok = kpos >= 0 && kpos < p.Skv &&
                            (!p.causal || qpos >= kpos) &&
                            (!p.has_window || qpos - kpos < p.window);
            if (!ok) x = kNeg;
          }
          s[i] = x;
          mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
        }
        float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = ex2((m[r] - m_new) * p.c_mul);
          m[r] = m_new;
          mc[r] = m_new * p.c_mul;
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int r = (i % 4) / 2;
          const float e = ex2(fmaf(s[i], p.c_mul, -mc[r]));
          s[i] = MASK && s[i] == kNeg ? 0.f : e;  // masked: zero, not exp
          sum[r] += s[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
      };
      if (full)
        body(std::integral_constant<bool, false>());
      else
        body(std::integral_constant<bool, true>());
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kb = 0; kb < KS; ++kb)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kb][j] = pack_bf16(s[8 * kb + 2 * j], s[8 * kb + 2 * j + 1]);
    };
    // O and P as the products will read them: written before wgmma.fence.
    auto fence_operands = [&]() {
      fence_regs(o);
#pragma unroll
      for (int kb = 0; kb < KS; ++kb) fence_regs(pa[kb]);
    };

    if (T > 0) {
      mbar_wait(&sm.q_full, 0);
      if (wg == 1) named_arrive(1);  // warpgroup 0 issues first
      // Tile 0: S only.
      mbar_wait(&sm.k_full[0], 0);
      named_sync(1 + wg);
      wg_fence();
      issue_qk(0);
      wg_commit();
      named_arrive(2 - wg);
      wg_wait<0>();
      fence_regs(s);
      if (tid == 0) mbar_arrive(&sm.k_empty[0]);
      float alpha[2];
      softmax(0, alpha);
      pack_p();
      // Tile n: S(n) = Q K(n)^T is issued first; O is rescaled to tile n -
      // 1's max while it runs, then O += P(n-1) V(n-1) is issued, and the
      // softmax of tile n runs while that product is in flight.
      for (int n = 1; n < T; ++n) {
        const int st = n % kKStages, ph = (n / kKStages) & 1;
        const int sp = (n - 1) % kVStages, php = ((n - 1) / kVStages) & 1;
        mbar_wait(&sm.k_full[st], ph);
        named_sync(1 + wg);
        wg_fence();
        issue_qk(st);
        wg_commit();
#pragma unroll
        for (int i = 0; i < NC * 32; ++i) o[i] *= alpha[(i % 4) / 2];
        mbar_wait(&sm.v_full[sp], php);
        fence_operands();
        wg_fence();
        issue_pv(sp);
        wg_commit();
        named_arrive(2 - wg);
        wg_wait<1>();  // S(n) is ready; O's product may still run
        fence_regs(s);
        if (tid == 0) mbar_arrive(&sm.k_empty[st]);
        softmax(n, alpha);
        wg_wait<0>();
        fence_regs(o);
        if (tid == 0) mbar_arrive(&sm.v_empty[sp]);
        pack_p();
      }
      // The last tile's P V.
      const int sp = (T - 1) % kVStages, php = ((T - 1) / kVStages) & 1;
      mbar_wait(&sm.v_full[sp], php);
      named_sync(1 + wg);
#pragma unroll
      for (int i = 0; i < NC * 32; ++i) o[i] *= alpha[(i % 4) / 2];
      fence_operands();
      wg_fence();
      issue_pv(sp);
      wg_commit();
      if (wg == 0) named_arrive(2);  // warpgroup 1 has no turn left to wait for
      wg_wait<0>();
      fence_regs(o);
      if (tid == 0) mbar_arrive(&sm.v_empty[sp]);
    }

    // ---- O / l, in bfloat16, straight from the fragments ----
    if (mine.store) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float t = l[r];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        inv[r] = t == 0.f ? 0.f : 1.f / t;  // fully-masked rows -> 0
      }
      const int64_t ld = int64_t(p.nq) * p.hd;
      bf16* base = p.o + (int64_t(b) * p.Sq * p.nq + mine.head) * p.hd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mine.q0 + r0 + 8 * half;
        if (row >= p.Sq) continue;
        bf16* orow = base + row * ld;
#pragma unroll
        for (int j = 0; j < NC * 8; ++j) {
          const int col = 8 * j + c0;
          if (col < p.hd)
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(o[4 * j + 2 * half] * inv[half],
                          o[4 * j + 2 * half + 1] * inv[half]);
        }
      }
    }
  }
}

// ---- host side: tensor maps and launch -----------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// What a map is encoded from: a (B, S, heads, hd) bfloat16 view and the
// rows of its box.
struct MapKey {
  const void* ptr;
  uint64_t dims[4];
  uint64_t strides[3];  // bytes: sequence, head, batch
  uint32_t rows;
  bool operator==(const MapKey& o) const {
    for (int i = 0; i < 4; ++i)
      if (dims[i] != o.dims[i]) return false;
    for (int i = 0; i < 3; ++i)
      if (strides[i] != o.strides[i]) return false;
    return ptr == o.ptr && rows == o.rows;
  }
};

constexpr int kCacheSize = 64;
struct MapCache {
  std::mutex mu;
  MapKey keys[kCacheSize];
  CUtensorMap maps[kCacheSize];
  int used = 0, next = 0;
};

// A map whose box is [rows][64] elements of one head, in the 128-byte
// swizzle, zero-filled out of bounds; cached, since encoding costs host
// time on every launch.
int tensor_map(CUtensorMap* out, const void* ptr, int64_t B, int64_t S,
               int64_t H, int64_t hd, int64_t sb, int64_t ss, int64_t sh,
               uint32_t rows) {
  static MapCache cache;
  MapKey key;
  key.ptr = ptr;
  const int64_t dims[4] = {hd, S, H, B};
  // A dimension of size 1 is never stepped over: give it a canonical stride.
  const int64_t strides[3] = {S > 1 ? ss : hd, H > 1 ? sh : hd,
                              B > 1 ? sb : hd};
  for (int i = 0; i < 4; ++i) key.dims[i] = static_cast<uint64_t>(dims[i]);
  for (int i = 0; i < 3; ++i)
    key.strides[i] = static_cast<uint64_t>(strides[i]) * sizeof(bf16);
  key.rows = rows;
  std::lock_guard<std::mutex> lock(cache.mu);
  for (int i = 0; i < cache.used; ++i)
    if (cache.keys[i] == key) {
      *out = cache.maps[i];
      return 0;
    }
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t box[4] = {64, rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      key.dims, key.strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  int slot = cache.used;
  if (cache.used < kCacheSize) {
    ++cache.used;
  } else {  // full: replace the oldest
    slot = cache.next;
    cache.next = (cache.next + 1) % kCacheSize;
  }
  cache.keys[slot] = key;
  cache.maps[slot] = *out;
  return 0;
}

template <int NC>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const Params& p, bool cap,
           cudaStream_t stream) {
  auto kernel = cap ? flash_bf16_kernel<NC, true> : flash_bf16_kernel<NC, false>;
  const int bytes = static_cast<int>(sizeof(Smem<NC, Tile<NC>::BN>)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ctas = int64_t(p.n_pairs) * p.B * p.nkv;
  kernel<<<static_cast<unsigned>(ctas), kThreads, bytes, stream>>>(mq, mk,
                                                                   mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_flash_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* o, int64_t B, int64_t Sq, int64_t Skv, int64_t nq,
    int64_t nkv, int64_t hd, int64_t sqb, int64_t sqs, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
    int64_t svh, int64_t causal, int64_t has_window, int64_t window,
    double softcap, int64_t q_offset, void* stream_ptr) {
  if (B < 1 || Sq < 1 || Skv < 0 || nkv < 1 || nq % nkv != 0 ||
      Sq > kMaxLen || Skv > kMaxLen || q_offset > kMaxLen ||
      q_offset < -kMaxLen || nq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA reads from a 16-byte aligned start in strides of 16 bytes; the
  // wrapper copies inputs that are not.
  const bool ptrs = (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  const bool strides = ((sqb | sqs | sqh | skb | sks | skh | svb | svs |
                         svh) % 8) == 0;
  if (!ptrs || !strides) return static_cast<int>(cudaErrorMisalignedAddress);
  int nc;
  switch (hd) {
    case 16: case 32: case 64: nc = 1; break;
    case 128: nc = 2; break;
    case 256: nc = 4; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (Skv == 0)  // nothing to attend to: every row is zero
    return static_cast<int>(cudaMemsetAsync(
        o, 0, size_t(B * Sq * nq * hd) * sizeof(bf16), stream));
  Params p;
  p.o = o;
  p.Sq = static_cast<int>(Sq);
  p.Skv = static_cast<int>(Skv);
  p.q_offset = static_cast<int>(q_offset);
  // A window past every (query, key) distance binds nothing.
  p.window = static_cast<int>(window < 4 * kMaxLen ? window : 4 * kMaxLen);
  p.B = static_cast<int>(B); p.nq = static_cast<int>(nq);
  p.nkv = static_cast<int>(nkv); p.group = static_cast<int>(nq / nkv);
  p.hd = static_cast<int>(hd);
  const int64_t items = (nq / nkv) * ((Sq + kBM - 1) / kBM);
  if ((items + 1) / 2 * B * nkv > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_items = static_cast<int>(items);
  p.n_pairs = static_cast<int>((items + 1) / 2);
  p.causal = causal != 0; p.has_window = has_window != 0;
  const bool cap = softcap != 0.0;
  const double scale = 1.0 / std::sqrt(static_cast<double>(hd));
  const double log2e = 1.4426950408889634;
  p.s_mul = static_cast<float>(cap ? scale / softcap : 0.0);
  p.c_mul = static_cast<float>(cap ? softcap * log2e : scale * log2e);
  const uint32_t bn = nc == 1 ? Tile<1>::BN : nc == 2 ? Tile<2>::BN
                                                     : Tile<4>::BN;
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, B, Sq, nq, hd, sqb, sqs, sqh, kBM);
  if (!err) err = tensor_map(&mk, k, B, Skv, nkv, hd, skb, sks, skh, bn);
  if (!err) err = tensor_map(&mv, v, B, Skv, nkv, hd, svb, svs, svh, bn);
  if (err) return err;
  switch (nc) {
    case 1: return launch<1>(mq, mk, mv, p, cap, stream);
    case 2: return launch<2>(mq, mk, mv, p, cap, stream);
    default: return launch<4>(mq, mk, mv, p, cap, stream);
  }
}
