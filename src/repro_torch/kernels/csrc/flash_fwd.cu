// flash_fwd on Hopper: causal / sliding-window GQA attention, forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:110
// flash_fwd (_fwd_kernel, :59).  It computes, per query row s of head h,
// o = softmax(q k^T / sqrt(D)) v over the visible keys t (t <= s when
// causal, t > s - window when window > 0) of kv head h / (H / KVH), with
// an online softmax, and returns the running row max m and row sum l
// beside o.  The Pallas grid is one program per (batch, head, q chunk)
// with the q block pinned in VMEM and a fori_loop over kv chunks; scores
// never reach HBM.
//
// Two instances by dtype, chosen in rj_flash_fwd (no switch elsewhere).
//
// bf16: the tensor cores (flash_tc.cuh).  One CTA of 384 threads per (128
// query rows, head, batch), the tiles with the most causal work launched
// first: two consumer warpgroups of 64 query rows each and a producer
// warpgroup, one thread of which issues the TMA loads (128-byte swizzle)
// of the q tile once and of each 64-key k and v tile into a ring of
// kStages stages guarded by full / empty mbarriers.  The SM's registers
// are split four ways, three warps to a quarter here, so the CTA is
// launched at 168 a thread; the producer gives its registers to the
// consumers with setmaxnreg (24 / 240), in branches on a warpgroup index
// the compiler knows to be warp-uniform.  ptxas still allocates the
// consumers 168 at D = 256 (128 f32 of O alone) and spills there (see
// PERF.md; the same with a 40 / 232 or 56 / 224 split, a producer warp,
// __maxnreg__ or -maxrregcount); D <= 128 does not spill.  Per stage a
// consumer
//   1. S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//      f32 accumulators in registers;
//   2. masks only a tile that crosses an edge (the diagonal, the window's
//      start, T), scales, and runs the online softmax in registers: a
//      row's values sit in the four threads of a quad, so its max and sum
//      take two shuffles each; a row with no visible key keeps m =
//      -2e38 and its exp() arguments at -inf (the Pallas kernel's guard),
//      so it ends with o = 0, l = 0 (the f32 kernel does the same);
//   3. O += P V: P is the A operand in registers, taken straight from the
//      score accumulator's layout (RS), V an MN-major B (transpose bit).
// P stays f32, as the Pallas kernel keeps it: it is split into hi =
// bf16(p) and lo = bf16(p - hi) and both go through the tensor cores
// (hi V + lo V), so P carries ~2^-17 of its value where bf16 alone
// carries 2^-9.  That keeps FLASH_TOL's f32-P limits, at the price of
// three products where a bf16-P kernel runs two.  Tiles past the diagonal
// and wholly before q - window + 1 are skipped (by the CTA's loop bounds,
// and by a test for a warpgroup).  TMA zero-fills rows past S and T and
// columns past D (D is zero-padded to its tier, 64, 128 or 256, in shared
// memory); keys past T are masked to -inf, since a zero key scores 0.
// Shared memory: the q tile, 128 rows of the tier, plus kStages k and v
// tiles of 64 rows: 16 + 3 x 16 KB = 64 KB at D <= 64, 32 + 3 x 32 = 128
// KB at D <= 128, 64 + 2 x 64 = 192 KB at D = 256 (two stages), plus 1 KB
// of alignment, under the 227 KB a CTA can opt into.
//
// f32: the CUDA-core kernel of the first port, unchanged (the tensor cores
// cannot hold f32 inputs to FLASH_TOL's 2e-5).  One CTA of 256 threads
// (16 x 16) per (q tile of kBQ = 64 rows, head, batch); it stages its q
// tile once and each 64-key k and v tile through shared memory, rows
// padded by 4 elements so that the vector reads of 16 threads hit
// distinct banks.  Per kv tile: S = q k^T with thread (ty, tx) taking rows
// 4ty..4ty+3 and keys tx + 16j; the masked online softmax with the row max
// and sum reduced over the 16 lanes of a row group; P (f32) to shared
// memory; O += P V with the thread owning rows 4ty..4ty+3 and columns
// 4tx + 64jj, all as f32 FMAs.  Shared memory 3 x 64 x (D + 4) elements +
// 64 x 68 f32, 212 KB at D = 256.
//
// Both read GQA's kv head in place and q, k, v through their strides
// ([B, S, H, D] as the model makes them), so no transpose copy is made.
// Bound: the operations, 4 D flops per visible (q, k) pair, over the bf16
// tensor-core rate; the bf16 kernel issues 6 D (the split P V).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"
#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace rj {

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // keys per kv tile
constexpr int kPLd = kBQ + 4;       // row length of the P tile (f32)

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int S, int Tk, int H, int G, int D, Strides qs, Strides ks,
                 Strides vs, int causal, int window, float scale) {
  using V = Vec4<T>;
  constexpr int kNJ = kDMax / 64;  // 4-column groups a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = D + kPad;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * ld;
  T* Vs = Ks + kBK * ld;
  float* Ps = reinterpret_cast<float*>(Vs + kBK * ld);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heavy tiles first
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long hk = h / G;

  stage_rows(Qs, ld, q, qs, b, h, q0, kBQ, S, D, tid);

  int lo = 0, hi = Tk;
  if (causal) hi = min(Tk, q0 + kBQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = (lo / kBK) * kBK;

  float m[4], l[4], acc[4][4 * kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kNJ; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();  // the previous tile's P V is done with Vs and Ps
    stage_rows(Ks, ld, k, ks, b, hk, k0, kBK, Tk, D, tid);
    stage_rows(Vs, ld, v, vs, b, hk, k0, kBK, Tk, D, tid);
    __syncthreads();

    // 1. scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[4][4], kv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) V::load(Qs + (4 * ty + i) * ld + d, qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) V::load(Ks + (tx + 16 * j) * ld + d, kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }

    // 2. mask, online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool vis = kpos < Tk && (!causal || kpos <= qpos) &&
                         (window <= 0 || kpos > qpos - window);
        s[i][j] = vis ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(rmax));
      const float safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - safe);
        rsum += s[i][j];
      }
      const float corr = expf(m[i] - safe);
      l[i] = l[i] * corr + row_sum16(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kNJ; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * kPLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // 3. O += P V
#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + kk * kPLd +
                                                        4 * ty);
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const int c = 4 * tx + 64 * jj;
        if (c < D) {
          float vv[4];
          V::load(Vs + kk * ld + c, vv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[0][4 * jj + e] = fmaf(p.x, vv[e], acc[0][4 * jj + e]);
            acc[1][4 * jj + e] = fmaf(p.y, vv[e], acc[1][4 * jj + e]);
            acc[2][4 * jj + e] = fmaf(p.z, vv[e], acc[2][4 * jj + e]);
            acc[3][4 * jj + e] = fmaf(p.w, vv[e], acc[3][4 * jj + e]);
          }
        }
      }
    }
  }

  // o = acc / max(l, 1e-30) in T, m and l in f32
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + 4 * ty + i;
    if (qrow >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((b * S + qrow) * H + h) * (long long)D;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c < D) {
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * jj + e] / den;
        *reinterpret_cast<typename V::Raw*>(orow + c) = V::pack(out);
      }
    }
    if (tx == 0) {
      m_out[(b * H + h) * S + qrow] = m[i];
      l_out[(b * H + h) * S + qrow] = l[i];
    }
  }
}

template <typename T, int kDMax>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         float* m, float* l, long long B, long long S,
                         long long Tk, long long H, long long KVH,
                         long long D, Strides qs, Strides ks, Strides vs,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  const size_t smem = 3 * 64 * (size_t)(D + kPad) * sizeof(T) +
                      (size_t)kBK * kPLd * sizeof(float);
  auto kernel = flash_fwd_kernel<T, kDMax>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, l, (int)S, (int)Tk,
      (int)H, (int)(H / KVH), (int)D, qs, ks, vs, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(long long D, const void* q, const void* k,
                           const void* v, void* o, float* m, float* l,
                           long long B, long long S, long long Tk,
                           long long H, long long KVH, Strides qs,
                           Strides ks, Strides vs, int causal, int window,
                           float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_flash<T, 64>(q, k, v, o, m, l, B, S, Tk, H, KVH, D, qs,
                               ks, vs, causal, window, scale, stream);
  if (D <= 128)
    return launch_flash<T, 128>(q, k, v, o, m, l, B, S, Tk, H, KVH, D, qs,
                                ks, vs, causal, window, scale, stream);
  return launch_flash<T, 256>(q, k, v, o, m, l, B, S, Tk, H, KVH, D, qs,
                              ks, vs, causal, window, scale, stream);
}

// --------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, TMA-fed stages
// --------------------------------------------------------------------------

constexpr int kTcRows = 128;  // query rows per CTA: two consumer warpgroups
constexpr int kTcKeys = 64;   // keys per stage
constexpr int kTcThreads = 3 * 128;  // two consumers, then the producer

template <int NP>
struct FwdTile {
  static constexpr int kStages = NP == 4 ? 2 : 3;
  static constexpr int kQBytes = kTcRows * tc::kRowBytes * NP;
  static constexpr int kKBytes = kTcKeys * tc::kRowBytes * NP;  // K or V
  static constexpr int kBars = 2 * kStages + 1;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKBytes + 8 * kBars;
};

struct FwdParams {
  CUtensorMap q, k, v;
  __nv_bfloat16* o;
  float* m;
  float* l;
  int S, Tk, H, G, D, causal, window;
  float scale;
};

template <int NP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ FwdParams p) {
  using L = FwdTile<NP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = tc::align_1024(smem_raw);
  unsigned char* Ks = Qs + L::kQBytes;
  unsigned char* Vs = Ks + L::kStages * L::kKBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + L::kStages * L::kKBytes);
  uint64_t* empty = full + L::kStages;
  uint64_t* qbar = empty + L::kStages;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;  // heavy first
  const int h = blockIdx.x, b = blockIdx.y, hk = h / p.G;
  int lo = 0, hi = p.Tk;
  if (p.causal) hi = min(p.Tk, q0 + kTcRows);
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
  lo = (lo / kTcKeys) * kTcKeys;
  const int n_tiles = hi > lo ? (hi - lo + kTcKeys - 1) / kTcKeys : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 2);
    }
    tc::mbar_init(qbar, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tc::warpgroup();
  if (wg == 2) {
    // producer: one thread keeps the TMA loads of the stages in flight
    tc::reg_dealloc<tc::kProducerRegs>();
    if (threadIdx.x == 256) {
      tc::mbar_expect_tx(qbar, L::kQBytes);
      tc::tma_tile<NP>(Qs, kTcRows, &p.q, qbar, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % L::kStages;
        tc::mbar_wait(&empty[st], ((it / L::kStages) & 1) ^ 1);
        tc::mbar_expect_tx(&full[st], 2 * L::kKBytes);
        const int k0 = lo + it * kTcKeys;
        tc::tma_tile<NP>(Ks + st * L::kKBytes, kTcKeys, &p.k, &full[st], k0,
                         hk, b);
        tc::tma_tile<NP>(Vs + st * L::kKBytes, kTcKeys, &p.v, &full[st], k0,
                         hk, b);
      }
    }
  } else {
    // consumers: warpgroup w takes query rows qw .. qw + 63
    tc::reg_alloc<tc::kConsumerRegs>();
    const int w = wg, t = threadIdx.x % 128;
    const int lane = t & 31;
    const int qw = q0 + 64 * w;
    const int r0 = qw + 16 * (t >> 5) + (lane >> 2);  // rows r0, r0 + 8
    const int c0 = 2 * (lane & 3);
    int wlo = 0, whi = p.Tk;
    if (p.causal) whi = min(p.Tk, qw + 64);
    if (p.window > 0) wlo = max(0, qw - p.window + 1);

    float o[NP][32];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pn][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint64_t dq = tc::desc(Qs + 64 * tc::kRowBytes * w);

    tc::mbar_wait(qbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % L::kStages;
      const int k0 = lo + it * kTcKeys;
      tc::mbar_wait(&full[st], (it / L::kStages) & 1);
      if (k0 < whi && k0 + kTcKeys > wlo) {
        // 1. S = Q K^T
        float s[32];
        tc::wg_fence();
        tc::product_ss<NP>(s, dq, kTcRows, tc::desc(Ks + st * L::kKBytes),
                           kTcKeys);
        tc::wg_commit();
        tc::wg_wait();
        tc::fence_regs(s);

        // 2. scale, mask (tiles that cross an edge only), online softmax
        const bool edge = k0 + kTcKeys > p.Tk ||
                          (p.causal && k0 + kTcKeys - 1 > qw) ||
                          (p.window > 0 && k0 <= qw + 63 - p.window);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          float rmax = kNegInf;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * i + 2 * half + e;
              const int col = k0 + 8 * i + c0 + e;
              const bool vis = !edge ||
                               (col < p.Tk && (!p.causal || col <= row) &&
                                (p.window <= 0 || col > row - p.window));
              s[idx] = vis ? s[idx] * p.scale : kNegInf;
              rmax = fmaxf(rmax, s[idx]);
            }
          const float m_new = fmaxf(m[half], tc::quad_max(rmax));
          const float safe = m_new <= kNegInf / 2 ? 0.f : m_new;
          float rsum = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * i + 2 * half + e;
              s[idx] = expf(s[idx] - safe);
              rsum += s[idx];
            }
          const float corr = expf(m[half] - safe);
          l[half] = l[half] * corr + tc::quad_sum(rsum);
          m[half] = m_new;
#pragma unroll
          for (int pn = 0; pn < NP; ++pn)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              o[pn][4 * i + 2 * half] *= corr;
              o[pn][4 * i + 2 * half + 1] *= corr;
            }
        }

        // 3. O += P V, P (f32) split into bf16 hi + lo
        uint32_t ph[4][4], pl[4][4];
        tc::split_frags(s, ph, pl);
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) tc::fence_regs(o[pn]);
        tc::wg_fence();
        const uint64_t dv = tc::desc(Vs + st * L::kKBytes);
#pragma unroll
        for (int pn = 0; pn < NP; ++pn)
          tc::product_rs_split(o[pn], ph, pl,
                               dv + pn * tc::panel_step(kTcKeys));
        tc::wg_commit();
        tc::wg_wait();
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) tc::fence_regs(o[pn]);
      }
      if (t == 0) tc::mbar_arrive(&empty[st]);  // the stage is free again
    }

    // o = acc / max(l, 1e-30) in bf16, m and l in f32
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= p.S) continue;
      const float den = fmaxf(l[half], 1e-30f);
      __nv_bfloat16* orow =
          p.o + (((long long)b * p.S + row) * p.H + h) * (long long)p.D;
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * pn + 8 * i + c0;
          if (col < p.D)
            tc::store_bf16x2(orow + col, o[pn][4 * i + 2 * half] / den,
                             o[pn][4 * i + 2 * half + 1] / den);
        }
      if ((lane & 3) == 0) {
        const long long at = ((long long)b * p.H + h) * p.S + row;
        p.m[at] = m[half];
        p.l[at] = l[half];
      }
    }
  }
}

template <int NP>
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v,
                            void* o, float* m, float* l, long long B,
                            long long S, long long Tk, long long H,
                            long long KVH, long long D, Strides qs,
                            Strides ks, Strides vs, int causal, int window,
                            float scale, cudaStream_t stream) {
  using L = FwdTile<NP>;
  FwdParams p;
  cudaError_t err;
  if ((err = tc::make_map(&p.q, q, B, S, H, D, qs, kTcRows)) != cudaSuccess)
    return err;
  // with no keys no tile is loaded: q stands in for k and v
  const bool none = Tk == 0;
  if ((err = tc::make_map(&p.k, none ? q : k, B, none ? S : Tk,
                          none ? H : KVH, D, none ? qs : ks, kTcKeys)) !=
          cudaSuccess ||
      (err = tc::make_map(&p.v, none ? q : v, B, none ? S : Tk,
                          none ? H : KVH, D, none ? qs : vs, kTcKeys)) !=
          cudaSuccess)
    return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.m = m;
  p.l = l;
  p.S = (int)S;
  p.Tk = (int)Tk;
  p.H = (int)H;
  p.G = (int)(H / KVH);
  p.D = (int)D;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  auto kernel = flash_fwd_tc_kernel<NP>;
  if ((err = tc::prepare(kernel, L::kSmem, kTcThreads)) != cudaSuccess)
    return err;
  const dim3 grid((unsigned)H, (unsigned)B,
                  (unsigned)((S + kTcRows - 1) / kTcRows));
  kernel<<<grid, kTcThreads, L::kSmem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_flash_tc(long long D, const void* q, const void* k,
                              const void* v, void* o, float* m, float* l,
                              long long B, long long S, long long Tk,
                              long long H, long long KVH, Strides qs,
                              Strides ks, Strides vs, int causal, int window,
                              float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_flash_tc<1>(q, k, v, o, m, l, B, S, Tk, H, KVH, D, qs, ks,
                              vs, causal, window, scale, stream);
  if (D <= 128)
    return launch_flash_tc<2>(q, k, v, o, m, l, B, S, Tk, H, KVH, D, qs, ks,
                              vs, causal, window, scale, stream);
  return launch_flash_tc<4>(q, k, v, o, m, l, B, S, Tk, H, KVH, D, qs, ks,
                            vs, causal, window, scale, stream);
}

}  // namespace rj

// dtype: 0 = float32, 1 = bfloat16.  o is [B, S, H, D] contiguous, m and
// l [B, H, S] contiguous; q, k, v have unit stride along D, 16-byte
// aligned bases and rows, D a multiple of 8 up to 256 and H a multiple of
// KVH (the wrapper checks all of it).
extern "C" int rj_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* m, float* l, int dtype,
                            long long B, long long S, long long Tk,
                            long long H, long long KVH, long long D,
                            long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            int causal, int window, float scale, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D <= 0 || D > 256 || D % 8 || KVH <= 0 || H % KVH || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  const rj::Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = rj::dispatch_flash<float>(D, q, k, v, o, m, l, B, S, Tk, H, KVH,
                                    qs, ks, vs, causal, window, scale, s);
  else if (dtype == 1)
    err = rj::dispatch_flash_tc(D, q, k, v, o, m, l, B, S, Tk, H, KVH, qs,
                                ks, vs, causal, window, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
