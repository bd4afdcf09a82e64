// Hopper tensor-core pieces shared by the bf16 flash kernels (flash_fwd.cu,
// flash_bwd.cu): TMA tensor maps over [B, rows, heads, D] bf16 tensors read
// through their strides, mbarriers, wgmma descriptors and instructions, and
// the split of an f32 operand into two bf16 halves.
//
// Shared-memory tiles are "panels" of 64 bf16 columns: a tile of R rows and
// D columns is D / 64 panels of R rows x 128 bytes, each written by one TMA
// box load with the 128-byte swizzle and read by wgmma through a descriptor
// with the same swizzle (every panel starts on a 1024-byte boundary, so the
// swizzle phase is the address's own).  Columns past D and rows past the
// tensor's end arrive as zeros (TMA's out-of-bounds fill): a head dim below
// its tier is zero-padded in shared memory, and the kernels mask keys past
// T themselves (a zero key scores 0, not -inf).
//
// A panel is read two ways:
//   K-major, as the A or B operand of a product over D (Q K^T): 16 columns
//     a k-step, 32 bytes further along the swizzled row;
//   MN-major, as the B operand of a product over rows (P V, dS K): 16 rows
//     a k-step, 2048 bytes further, with wgmma's transpose bit.
// Both descriptors take 1024 bytes between 8-row groups; the other offset
// is unused by a 64-column panel and set to the same value.
//
// Accumulator layout of an m64nN f32 wgmma, thread t of the warpgroup:
// element 4 i + 2 half + e is row 16 (t / 32) + (t % 32) / 4 + 8 half,
// column 8 i + 2 (t % 4) + e.  Its pairs (8 j + 2 r, 8 j + 2 r + 1), r < 4,
// are exactly the bf16 A fragment of k-step j of a register-A wgmma, so a
// probability tile goes from one product to the next without shared memory.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace rj {
namespace tc {

constexpr int kPanelCols = 64;    // bf16 columns of a panel (128 bytes)
constexpr int kRowBytes = 128;
constexpr int kGroupBytes = 1024;  // 8 swizzled rows
// --------------------------------------------------------------------------
// host: tensor maps
// --------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, so the library
// needs no -lcuda.
inline EncodeTiledFn encode_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A map over one head-major view x [B, rows, heads, D] bf16 (element
// strides st; unit stride along D, 16-byte aligned base and strides) whose
// box is one panel of box_rows rows of one head: coordinates (column,
// row, head, batch).
inline cudaError_t make_map(CUtensorMap* map, const void* x, long long B,
                            long long rows, long long heads, long long D,
                            Strides st, int box_rows) {
  const EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const long long ext[3] = {rows, heads, B};
  const long long str[3] = {st.s, st.h, st.b};
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)ext[i];
    // a dimension of size 1 is never stepped along: any legal stride
    const long long bytes = str[i] * 2;
    strides[i] = (cuuint64_t)(ext[i] > 1 || (bytes > 0 && bytes % 16 == 0)
                                  ? bytes
                                  : 16);
  }
  const cuuint32_t box[4] = {(cuuint32_t)kPanelCols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(x), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Registers a thread of a 384-thread CTA whose producer warpgroup hands
// its registers to two consumer warpgroups (setmaxnreg): launched at 168
// (a quarter of the SM's 65,536 registers over three warps),
// 24 x 128 + 240 x 256 = 168 x 384.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Opt a kernel of `threads` threads in to `smem` bytes of dynamic shared
// memory.  A 384-thread one moves registers with setmaxnreg: refuse it
// unless it was launched with the 168 a thread the move assumes (else
// setmaxnreg.inc would wait forever).
template <typename K>
cudaError_t prepare(K kernel, size_t smem, int threads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || threads != 384) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  return attr.numRegs * 384 >= kProducerRegs * 128 + kConsumerRegs * 256
             ? cudaSuccess
             : cudaErrorLaunchOutOfResources;
}

// --------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to a 1024-byte boundary (the
// launcher asks for 1024 bytes more than the layout needs).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
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

// Wait for the phase of parity `parity` to complete.  A wait that lasts
// ~2^35 cycles (~17 s) traps: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0)
      start = now;
    else if (now - start > (1LL << 35))
      __trap();
  }
}

// One panel: box (64 columns, box rows) at (col, row, head, batch).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(smem_u32(bar))
      : "memory");
}

// Every panel of a tile of `rows` rows starting at `row`.
template <int NP>
__device__ __forceinline__ void tma_tile(unsigned char* dst, int rows,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row, int head,
                                         int batch) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
    tma_load(dst + p * rows * kRowBytes, map, bar, p * kPanelCols, row, head,
             batch);
}

// --------------------------------------------------------------------------
// device: wgmma
// --------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled panel at p (1024-byte aligned): the
// start address, both byte offsets 1024 (see the head comment), layout
// type 1 (128-byte swizzle).  A K-major k-step adds 2 (32 bytes), an
// MN-major one 128 (2048 bytes), a panel of R rows R * 8.
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t enc = kGroupBytes >> 4;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (enc << 16) |
         (enc << 32) | (1ull << 62);
}
constexpr uint64_t kKStepK = 32 >> 4;
constexpr uint64_t kKStepMN = (16 * kRowBytes) >> 4;
__host__ __device__ constexpr uint64_t panel_step(int rows) {
  return (uint64_t)(rows * kRowBytes) >> 4;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// This thread's warpgroup, broadcast from lane 0 so that the compiler
// knows it is the same across the warp: setmaxnreg takes effect in
// register allocation only under warp-uniform control flow.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Keep the compiler from moving accesses of wgmma registers across the
// asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[32] (+)= A B: A [64 x 16] and B [16 x 64] both K-major in shared
// memory (descriptors); d is overwritten when scale_d == 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A B: A [64 x 16] bf16 in registers (four bf16 pairs a thread,
// the accumulator layout's fragment), B [16 x 64] MN-major in shared
// memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The 64 x 64 product A B^T of two K-major tiles of NP panels (a tile of
// `a_rows` rows holds A at `a`, one of `b_rows` rows holds B at `b`): d is
// overwritten (one wgmma per 16 of the 64 NP columns; not committed).
template <int NP>
__device__ __forceinline__ void product_ss(float (&d)[32], uint64_t a,
                                           int a_rows, uint64_t b,
                                           int b_rows) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(d, a + p * panel_step(a_rows) + kk * kKStepK,
                   b + p * panel_step(b_rows) + kk * kKStepK,
                   (p | kk) != 0);
}

// x -> hi = bf16(x), lo = bf16(x - hi) for a pair: hi + lo carries x to
// ~2^-17 of |x| where bf16 alone carries it to 2^-9.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A fragments of the four k-steps of a 64 x 64 f32 accumulator, split.
__device__ __forceinline__ void split_frags(const float (&s)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair(s[8 * j + 2 * r], s[8 * j + 2 * r + 1], hi[j][r], lo[j][r]);
}

// d += (hi + lo) B over 64 rows of an MN-major panel at b: eight wgmmas.
__device__ __forceinline__ void product_rs_split(float (&d)[32],
                                                 const uint32_t (&hi)[4][4],
                                                 const uint32_t (&lo)[4][4],
                                                 uint64_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_rs_n64_tb(d, hi[j], b + j * kKStepMN);
    wgmma_rs_n64_tb(d, lo[j], b + j * kKStepMN);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a,
                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace tc
}  // namespace rj
