// flash_bwd on Hopper: causal / sliding-window GQA attention, backward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:262
// flash_bwd, whose two pallas_calls are _bwd_dq_kernel (:164) and
// _bwd_dkv_kernel (:207).  Given q [B,S,H,D], k, v [B,T,KVH,D], the output
// gradient do [B,S,H,D] and the forward's row max m and row sum l
// ([B,H,S] f32), it recomputes the probabilities
//   p = exp(s - m) / max(l, 1e-30) over the visible keys (0 elsewhere),
//   s = q k^T / sqrt(D),
// and returns dq = ds k / sqrt(D), dk = ds^T q / sqrt(D), dv = p^T do with
// ds = p (do v^T - delta), delta = sum_D o do (a torch reduction, taken
// outside the kernel as the JAX package takes it outside its kernels).
// Query head h reads kv head h / (H / KVH); dk and dv sum over the H / KVH
// query heads of each kv head.  Scores never reach device memory.
//
// Design: two kernels, as the Pallas version has, neither with atomics:
// every output element has one writer and every sum a fixed order, so a
// training step is deterministic on the card (two calls are bit-equal).
// Two instances by dtype, chosen in rj_flash_bwd (no switch elsewhere).
//
// bf16: the tensor cores (flash_tc.cuh, as flash_fwd.cu).  A producer
// warp feeds TMA tiles (128-byte swizzle) into a ring of stages guarded by
// full / empty mbarriers; consumer warpgroups run wgmma m64n64k16 with f32
// accumulators.  With one consumer warpgroup a CTA has 160 threads, and a
// thread may hold 255 registers.
//   dq:  one CTA of 160 threads per (q tile of 64 rows, head, batch),
//        heaviest causal tiles first.  Its q and do tiles are loaded once;
//        per visible 64-key tile it computes S = Q K^T and dP = dO V^T
//        (both operands in shared memory), P = exp(S scale - m) / l and
//        dS = P (dP - delta) in registers, and dQ += dS K with dS the A
//        operand in registers and K an MN-major B (transpose bit).
//   dkv: one CTA per (key tile of 64, query head, batch), the first key
//        tiles (the most causal work) first: 16 x 12 x 2 = 384 CTAs at a
//        training microbatch of qwen2-1.5b (the CUDA-core kernel had one
//        CTA per kv head: 64).  Its k and v tiles are loaded once; per
//        q tile that can see them (rows >= k0 when causal, < k1 - 1 +
//        window with a window) it computes S^T = K Q^T and dP^T = V dO^T,
//        P^T and dS^T, then dV += P^T dO and dK += dS^T Q (register A,
//        MN-major B).  The producer warp also stages each q tile's m, l
//        and delta in shared memory.  At D = 256 two consumer warpgroups
//        each own half of dK's and dV's columns (a warpgroup's four
//        accumulators would need 256 registers a thread) and both
//        compute S^T and dP^T; a producer warpgroup then hands them its
//        registers with setmaxnreg (see flash_fwd.cu).  For G = H / KVH
//        > 1 it writes f32 per-query-head partials [B, T, H, D] to a
//        scratch the wrapper allocates (2 x 12.6 MB = 25 MB at a
//        qwen2-1.5b microbatch of 2 x 1024, 2 x 33.6 MB = 67 MB at
//        gemma3-1b's 4 x 2048 with MQA), and flash_bwd_reduce_kernel sums
//        the G partials of each kv head in order g = 0, 1, ... and casts
//        them; with G = 1 it writes dk, dv directly.
// P and dS stay f32, as in the Pallas kernel: each product that takes
// one splits it into hi = bf16(x) and lo = bf16(x - hi) and runs both
// (hi B + lo B), so the operand carries ~2^-17 of its value where bf16
// alone carries 2^-9.  That keeps FLASH_BWD_TOL, at the price of ten
// products a visible tile pair over the two kernels (S and dP in each,
// dQ, dV, dK twice) where a bf16-P pair of kernels runs seven; twelve at
// D = 256, where both dkv warpgroups compute S^T and dP^T.  Masking runs
// only on tiles that cross an edge; TMA zero-fills rows past S and T and
// columns past D (D zero-padded to its tier in shared memory), and
// invisible pairs, keys past T and rows past S get p = 0.
// Shared memory: dq holds q, do and kStages k + v tiles (64 rows of the
// tier each): 2 x 8 + 3 x 16 = 64 KB at D <= 64, 2 x 16 + 3 x 32 = 128 KB
// at D <= 128, 2 x 32 + 2 x 64 = 192 KB at D = 256 (two stages); dkv the
// same with k, v held and q, do staged, plus 768 bytes of row statistics
// a stage; plus 1 KB of alignment.
//
// f32: the CUDA-core kernels of the first port, unchanged (the tensor
// cores cannot hold f32 inputs to FLASH_BWD_TOL's 1e-4).  CTAs of 256
// threads (16 x 16) stage tiles through shared memory, rows padded by 4
// elements, and run every product as f32 FMAs.
//   dq:  one CTA per (q tile of 64 rows, head, batch): S = q k^T and
//        dP = do v^T (thread (ty, tx): rows 4ty..4ty+3, keys tx + 16j),
//        dS to shared memory, dQ += dS K.
//   dkv: one CTA per (key tile of kBK keys, kv head, batch), looping over
//        the kv head's query heads and the q tiles that can see the key
//        tile; P and dS to shared memory [q row][key]; dV += P^T dO and
//        dK += dS^T Q with the thread owning keys kRJ ty..kRJ ty + kRJ-1.
//   kBK is 64, or 32 at D > 128: at D = 256 the dkv kernel then takes
//   (2 x 64 + 2 x 32) x 260 x 4 + 2 x 64 x 36 x 4 = 218,112 bytes and the
//   dq kernel 208,384, under the 232,448 a CTA can opt into.
// Rows and keys past the ends and invisible pairs give p = 0; a row with
// no visible key (l = 0, m = -2e38) gets dq = 0 and adds nothing.  q, k,
// v and do are read through their strides; dq, dk, dv are written
// contiguous in the input type from f32 sums.
// Bound: the operations, 10 D flops per visible (q, k) pair (four
// products and the recomputed scores), over the bf16 tensor-core rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"
#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace rj {

constexpr int kBQ = 64;  // query rows per tile

template <int kDMax>
struct BwdTile {
  static constexpr int kBK = kDMax > 128 ? 32 : 64;  // keys per tile
  static constexpr int kRJ = kBK / 16;               // keys per thread
  static constexpr int kNJ = kDMax / 64;  // 4-column groups a thread owns
};

// acc[i][j] += sum_d A[4 ty + i][d] B[tx + 16 j][d] over staged rows.
template <typename T, int kRJ>
__device__ __forceinline__ void tile_dot(float (&acc)[4][kRJ], const T* A,
                                         const T* B, int ld, int D, int ty,
                                         int tx) {
  using V = Vec4<T>;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float a[4][4], bv[kRJ][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) V::load(A + (4 * ty + i) * ld + d, a[i]);
#pragma unroll
    for (int j = 0; j < kRJ; ++j) V::load(B + (tx + 16 * j) * ld + d, bv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kRJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j] = fmaf(a[i][e], bv[j][e], acc[i][j]);
  }
}

// The forward's statistics of query rows q0 + 4 ty + i: the max to
// subtract (0 for an empty row, as the forward's guard), max(l, 1e-30)
// and delta; rows past S get neutral values (their p is masked to 0).
__device__ __forceinline__ void row_stats(const float* m, const float* l,
                                          const float* delta, long long base,
                                          int q0, int ty, int S,
                                          float (&sm)[4], float (&lm)[4],
                                          float (&dl)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    sm[i] = 0.f;
    lm[i] = 1.f;
    dl[i] = 0.f;
    if (row < S) {
      const float mm = m[base + row];
      sm[i] = mm <= kNegInf / 2 ? 0.f : mm;
      lm[i] = fmaxf(l[base + row], 1e-30f);
      dl[i] = delta[base + row];
    }
  }
}

// s -> p = exp(s scale - m) / l where (q, k) is visible, else 0, and
// dp -> ds = p (dp - delta), for the thread's rows 4ty + i, keys tx + 16j.
template <int kRJ>
__device__ __forceinline__ void grad_scores(
    float (&s)[4][kRJ], float (&dp)[4][kRJ], const float (&sm)[4],
    const float (&lm)[4], const float (&dl)[4], int q0, int k0, int ty,
    int tx, int S, int Tk, int causal, int window, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < kRJ; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool vis = qpos < S && kpos < Tk &&
                       (!causal || kpos <= qpos) &&
                       (window <= 0 || kpos > qpos - window);
      const float p = vis ? expf(s[i][j] * scale - sm[i]) / lm[i] : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl[i]);
    }
  }
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int Tk, int H, int G, int D, Strides qs,
                    Strides ks, Strides vs, Strides dos, int causal,
                    int window, float scale) {
  using V = Vec4<T>;
  constexpr int kBK = BwdTile<kDMax>::kBK;
  constexpr int kRJ = BwdTile<kDMax>::kRJ;
  constexpr int kNJ = BwdTile<kDMax>::kNJ;
  constexpr int kSLd = kBQ + 4;  // row length of the dS tile [key][q row]
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = D + kPad;
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBQ * ld;
  T* Ks = dOs + kBQ * ld;
  T* Vs = Ks + kBK * ld;
  float* dSs = reinterpret_cast<float*>(Vs + kBK * ld);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heavy tiles first
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long hk = h / G;

  stage_rows(Qs, ld, q, qs, b, h, q0, kBQ, S, D, tid);
  stage_rows(dOs, ld, dout, dos, b, h, q0, kBQ, S, D, tid);
  float sm[4], lm[4], dl[4];
  row_stats(m, l, delta, (b * H + h) * S, q0, ty, S, sm, lm, dl);

  int lo = 0, hi = Tk;
  if (causal) hi = min(Tk, q0 + kBQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = (lo / kBK) * kBK;

  float acc[4][4 * kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kNJ; ++c) acc[i][c] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();  // the previous tile's dS K is done with Ks and dSs
    stage_rows(Ks, ld, k, ks, b, hk, k0, kBK, Tk, D, tid);
    stage_rows(Vs, ld, v, vs, b, hk, k0, kBK, Tk, D, tid);
    __syncthreads();

    float s[4][kRJ], dp[4][kRJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kRJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<T, kRJ>(s, Qs, Ks, ld, D, ty, tx);
    tile_dot<T, kRJ>(dp, dOs, Vs, ld, D, ty, tx);
    grad_scores<kRJ>(s, dp, sm, lm, dl, q0, k0, ty, tx, S, Tk, causal,
                     window, scale);
#pragma unroll
    for (int j = 0; j < kRJ; ++j)
      *reinterpret_cast<float4*>(dSs + (tx + 16 * j) * kSLd + 4 * ty) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();

    // dQ += dS K
#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 ds = *reinterpret_cast<const float4*>(dSs + kk * kSLd +
                                                         4 * ty);
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const int c = 4 * tx + 64 * jj;
        if (c < D) {
          float kv[4];
          V::load(Ks + kk * ld + c, kv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[0][4 * jj + e] = fmaf(ds.x, kv[e], acc[0][4 * jj + e]);
            acc[1][4 * jj + e] = fmaf(ds.y, kv[e], acc[1][4 * jj + e]);
            acc[2][4 * jj + e] = fmaf(ds.z, kv[e], acc[2][4 * jj + e]);
            acc[3][4 * jj + e] = fmaf(ds.w, kv[e], acc[3][4 * jj + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + 4 * ty + i;
    if (qrow >= S) continue;
    T* row = dq + ((b * S + qrow) * H + h) * (long long)D;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c < D) {
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * jj + e] * scale;
        *reinterpret_cast<typename V::Raw*>(row + c) = V::pack(out);
      }
    }
  }
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ m,
                     const float* __restrict__ l,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Tk, int H, int G, int D,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     int causal, int window, float scale) {
  using V = Vec4<T>;
  constexpr int kBK = BwdTile<kDMax>::kBK;
  constexpr int kRJ = BwdTile<kDMax>::kRJ;
  constexpr int kNJ = BwdTile<kDMax>::kNJ;
  constexpr int kPLd = kBK + 4;  // row length of the P, dS tiles [q][key]
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = D + kPad;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBK * ld;
  T* Qs = Vs + kBK * ld;
  T* dOs = Qs + kBQ * ld;
  float* Ps = reinterpret_cast<float*>(dOs + kBQ * ld);
  float* dSs = Ps + kBQ * kPLd;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;
  const long long hk = blockIdx.y, b = blockIdx.z;
  const int k1 = min(Tk, k0 + kBK);

  stage_rows(Ks, ld, k, ks, b, hk, k0, kBK, Tk, D, tid);
  stage_rows(Vs, ld, v, vs, b, hk, k0, kBK, Tk, D, tid);

  // the query rows that see a key of [k0, k1)
  int qlo = causal ? k0 : 0;
  const int qhi = window > 0 ? min(S, k1 - 1 + window) : S;
  qlo = (qlo / kBQ) * kBQ;

  float dka[kRJ][4 * kNJ], dva[kRJ][4 * kNJ];
#pragma unroll
  for (int r = 0; r < kRJ; ++r)
#pragma unroll
    for (int c = 0; c < 4 * kNJ; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const long long h = hk * G + gi;
    for (int q0 = qlo; q0 < qhi; q0 += kBQ) {
      __syncthreads();  // the previous tile's products are done with
                        // Qs, dOs, Ps and dSs
      stage_rows(Qs, ld, q, qs, b, h, q0, kBQ, S, D, tid);
      stage_rows(dOs, ld, dout, dos, b, h, q0, kBQ, S, D, tid);
      float sm[4], lm[4], dl[4];
      row_stats(m, l, delta, (b * H + h) * S, q0, ty, S, sm, lm, dl);
      __syncthreads();

      float s[4][kRJ], dp[4][kRJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kRJ; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_dot<T, kRJ>(s, Qs, Ks, ld, D, ty, tx);
      tile_dot<T, kRJ>(dp, dOs, Vs, ld, D, ty, tx);
      grad_scores<kRJ>(s, dp, sm, lm, dl, q0, k0, ty, tx, S, Tk, causal,
                       window, scale);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kRJ; ++j) {
          Ps[(4 * ty + i) * kPLd + tx + 16 * j] = s[i][j];
          dSs[(4 * ty + i) * kPLd + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
      for (int kk = 0; kk < kBQ; ++kk) {
        float p[kRJ], ds[kRJ];
#pragma unroll
        for (int r = 0; r < kRJ; ++r) {
          p[r] = Ps[kk * kPLd + kRJ * ty + r];
          ds[r] = dSs[kk * kPLd + kRJ * ty + r];
        }
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          const int c = 4 * tx + 64 * jj;
          if (c < D) {
            float dov[4], qv[4];
            V::load(dOs + kk * ld + c, dov);
            V::load(Qs + kk * ld + c, qv);
#pragma unroll
            for (int r = 0; r < kRJ; ++r)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                dva[r][4 * jj + e] = fmaf(p[r], dov[e], dva[r][4 * jj + e]);
                dka[r][4 * jj + e] = fmaf(ds[r], qv[e], dka[r][4 * jj + e]);
              }
          }
        }
      }
    }
  }

  const int kvh = H / G;
#pragma unroll
  for (int r = 0; r < kRJ; ++r) {
    const int krow = k0 + kRJ * ty + r;
    if (krow >= Tk) continue;
    const long long off = ((b * Tk + krow) * kvh + hk) * (long long)D;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c < D) {
        float ko[4], vo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ko[e] = dka[r][4 * jj + e] * scale;
          vo[e] = dva[r][4 * jj + e];
        }
        *reinterpret_cast<typename V::Raw*>(dk + off + c) = V::pack(ko);
        *reinterpret_cast<typename V::Raw*>(dv + off + c) = V::pack(vo);
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *m, *l, *delta;
  void *dq, *dk, *dv;
  long long B, S, Tk, H, KVH, D;
  Strides qs, ks, vs, dos;
  int causal, window;
  float scale;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int kDMax>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr int kBK = BwdTile<kDMax>::kBK;
  const size_t ld = (size_t)(a.D + kPad);
  const size_t tiles = (size_t)(2 * kBQ + 2 * kBK) * ld * sizeof(T);
  const size_t smem_dq = tiles + (size_t)kBK * (kBQ + 4) * sizeof(float);
  const size_t smem_dkv =
      tiles + (size_t)2 * kBQ * (kBK + 4) * sizeof(float);
  const int G = (int)(a.H / a.KVH);
  auto dq_kernel = flash_bwd_dq_kernel<T, kDMax>;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, kDMax>;
  cudaError_t err;
  if (a.S > 0) {
    if ((err = allow_smem(dq_kernel, smem_dq)) != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.S + kBQ - 1) / kBQ), (unsigned)a.H,
                    (unsigned)a.B);
    dq_kernel<<<grid, kFlashThreads, smem_dq, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.m, a.l,
        a.delta, static_cast<T*>(a.dq), (int)a.S, (int)a.Tk, (int)a.H, G,
        (int)a.D, a.qs, a.ks, a.vs, a.dos, a.causal, a.window, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.Tk > 0) {
    if ((err = allow_smem(dkv_kernel, smem_dkv)) != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.Tk + kBK - 1) / kBK), (unsigned)a.KVH,
                    (unsigned)a.B);
    dkv_kernel<<<grid, kFlashThreads, smem_dkv, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.m, a.l,
        a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), (int)a.S,
        (int)a.Tk, (int)a.H, G, (int)a.D, a.qs, a.ks, a.vs, a.dos,
        a.causal, a.window, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_bwd(const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch_bwd<T, 64>(a, stream);
  if (a.D <= 128) return launch_bwd<T, 128>(a, stream);
  return launch_bwd<T, 256>(a, stream);
}


// --------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, TMA-fed stages
// --------------------------------------------------------------------------

constexpr int kTcTile = 64;  // q rows of a dq CTA and of a dkv stage; keys
                             // of a dq stage and of a dkv CTA

template <int NP>
struct BwdTcTile {
  static constexpr int kStages = NP == 4 ? 2 : 3;
  static constexpr int kTile = kTcTile * tc::kRowBytes * NP;  // one tile
  // dkv: D = 256 splits dK and dV by columns over two consumer warpgroups
  static constexpr int kDkvWGs = NP == 4 ? 2 : 1;
  static constexpr int kDkvPanels = NP / kDkvWGs;  // panels a warpgroup owns
  // the consumers and a producer warp, or a producer warpgroup that moves
  // its registers to two consumers (setmaxnreg)
  static constexpr int kDkvThreads = kDkvWGs > 1 ? 128 * (kDkvWGs + 1)
                                                 : 128 + 32;
  // dq: Q, dO, then the K and V stages; dkv: K, V, then the Q and dO
  // stages and the stages' row statistics (3 x 64 f32)
  static constexpr size_t kSmemDq =
      1024 + (2 + 2 * kStages) * kTile + 8 * (2 * kStages + 1);
  static constexpr size_t kSmemDkv = 1024 + (2 + 2 * kStages) * kTile +
                                     kStages * 3 * kTcTile * 4 +
                                     8 * (2 * kStages + 1);
};

struct BwdTcParams {
  CUtensorMap q, k, v, dout;
  const float* m;
  const float* l;
  const float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* part;  // [2, B, T, H, D] f32 per-query-head dk, dv when G > 1
  int S, Tk, H, G, D, causal, window;
  float scale;
};

// The forward's statistics of a query row: the max to subtract (0 for an
// empty row), max(l, 1e-30) and delta; neutral for rows past S.
__device__ __forceinline__ void tc_row_stats(const BwdTcParams& p,
                                             long long base, int row,
                                             float& sm, float& lm,
                                             float& dl) {
  sm = 0.f;
  lm = 1.f;
  dl = 0.f;
  if (row < p.S) {
    const float mm = p.m[base + row];
    sm = mm <= kNegInf / 2 ? 0.f : mm;
    lm = fmaxf(p.l[base + row], 1e-30f);
    dl = p.delta[base + row];
  }
}

template <int NP>
__global__ void __launch_bounds__(128 + 32, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ BwdTcParams p) {
  using L = BwdTcTile<NP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = tc::align_1024(smem_raw);
  unsigned char* dOs = Qs + L::kTile;
  unsigned char* Ks = dOs + L::kTile;
  unsigned char* Vs = Ks + L::kStages * L::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + L::kStages * L::kTile);
  uint64_t* empty = full + L::kStages;
  uint64_t* qbar = empty + L::kStages;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcTile;  // heavy first
  const int h = blockIdx.x, b = blockIdx.y, hk = h / p.G;
  int lo = 0, hi = p.Tk;
  if (p.causal) hi = min(p.Tk, q0 + kTcTile);
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
  lo = (lo / kTcTile) * kTcTile;
  const int n_tiles = hi > lo ? (hi - lo + kTcTile - 1) / kTcTile : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 1);
    }
    tc::mbar_init(qbar, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp
    if (threadIdx.x == 128) {
      tc::mbar_expect_tx(qbar, 2 * L::kTile);
      tc::tma_tile<NP>(Qs, kTcTile, &p.q, qbar, q0, h, b);
      tc::tma_tile<NP>(dOs, kTcTile, &p.dout, qbar, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % L::kStages;
        tc::mbar_wait(&empty[st], ((it / L::kStages) & 1) ^ 1);
        tc::mbar_expect_tx(&full[st], 2 * L::kTile);
        const int k0 = lo + it * kTcTile;
        tc::tma_tile<NP>(Ks + st * L::kTile, kTcTile, &p.k, &full[st], k0, hk,
                         b);
        tc::tma_tile<NP>(Vs + st * L::kTile, kTcTile, &p.v, &full[st], k0, hk,
                         b);
      }
    }
    return;
  }

  // consumer: query rows q0 .. q0 + 63
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = q0 + 16 * (t >> 5) + (lane >> 2);  // rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);
  const long long sbase = ((long long)b * p.H + h) * p.S;
  float sm[2], lm[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    tc_row_stats(p, sbase, r0 + 8 * half, sm[half], lm[half], dl[half]);

  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  const uint64_t dq_desc = tc::desc(Qs), do_desc = tc::desc(dOs);

  tc::mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % L::kStages;
    const int k0 = lo + it * kTcTile;
    tc::mbar_wait(&full[st], (it / L::kStages) & 1);
    const uint64_t dk_desc = tc::desc(Ks + st * L::kTile);

    // S = Q K^T, dP = dO V^T
    float s[32], dp[32];
    tc::wg_fence();
    tc::product_ss<NP>(s, dq_desc, kTcTile, dk_desc, kTcTile);
    tc::product_ss<NP>(dp, do_desc, kTcTile, tc::desc(Vs + st * L::kTile),
                       kTcTile);
    tc::wg_commit();
    tc::wg_wait();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    // P = exp(S scale - m) / l where visible, dS = P (dP - delta)
    const bool edge = k0 + kTcTile > p.Tk ||
                      (p.causal && k0 + kTcTile - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + kTcTile - 1 - p.window);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * i + 2 * half + e;
          const int row = r0 + 8 * half, col = k0 + 8 * i + c0 + e;
          const bool vis = !edge ||
                           (col < p.Tk && (!p.causal || col <= row) &&
                            (p.window <= 0 || col > row - p.window));
          const float pv =
              vis ? expf(s[idx] * p.scale - sm[half]) / lm[half] : 0.f;
          dp[idx] = pv * (dp[idx] - dl[half]);
        }

    // dQ += dS K, dS (f32) split into bf16 hi + lo
    uint32_t dh[4][4], dlo[4][4];
    tc::split_frags(dp, dh, dlo);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) tc::fence_regs(acc[pn]);
    tc::wg_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
      tc::product_rs_split(acc[pn], dh, dlo,
                           dk_desc + pn * tc::panel_step(kTcTile));
    tc::wg_commit();
    tc::wg_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) tc::fence_regs(acc[pn]);
    if (t == 0) tc::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= p.S) continue;
    __nv_bfloat16* out =
        p.dq + (((long long)b * p.S + row) * p.H + h) * (long long)p.D;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * pn + 8 * i + c0;
        if (col < p.D)
          tc::store_bf16x2(out + col, acc[pn][4 * i + 2 * half] * p.scale,
                           acc[pn][4 * i + 2 * half + 1] * p.scale);
      }
  }
}

template <int NP>
__global__ void __launch_bounds__(BwdTcTile<NP>::kDkvThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ BwdTcParams p) {
  using L = BwdTcTile<NP>;
  constexpr int kWGs = L::kDkvWGs, kNPW = L::kDkvPanels;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = tc::align_1024(smem_raw);
  unsigned char* Vs = Ks + L::kTile;
  unsigned char* Qs = Vs + L::kTile;
  unsigned char* dOs = Qs + L::kStages * L::kTile;
  float* stats = reinterpret_cast<float*>(dOs + L::kStages * L::kTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats +
                                               L::kStages * 3 * kTcTile);
  uint64_t* empty = full + L::kStages;
  uint64_t* kvbar = empty + L::kStages;

  const int k0 = blockIdx.z * kTcTile;  // the first key tiles are heaviest
  const int h = blockIdx.x, b = blockIdx.y, hk = h / p.G;
  const int k1 = min(p.Tk, k0 + kTcTile);
  // the query rows that see a key of [k0, k1)
  const int qlo = p.causal ? k0 : 0;
  const int qhi = p.window > 0 ? min(p.S, k1 - 1 + p.window) : p.S;
  const int n_tiles = qhi > qlo ? (qhi - qlo + kTcTile - 1) / kTcTile : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], kWGs);
    }
    tc::mbar_init(kvbar, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tc::warpgroup();
  if (wg == kWGs) {
    // producer: with two consumers a warpgroup that gives its registers
    // away, else one warp.  Its first warp works: lane 0 issues the TMA
    // loads, the 32 lanes stage each q tile's row statistics.
    if (kWGs > 1) tc::reg_dealloc<tc::kProducerRegs>();
    const int lane = threadIdx.x - 128 * kWGs;
    if (lane >= 32) return;
    if (lane == 0) {
      tc::mbar_expect_tx(kvbar, 2 * L::kTile);
      tc::tma_tile<NP>(Ks, kTcTile, &p.k, kvbar, k0, hk, b);
      tc::tma_tile<NP>(Vs, kTcTile, &p.v, kvbar, k0, hk, b);
    }
    const long long sbase = ((long long)b * p.H + h) * p.S;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % L::kStages;
      const int q0 = qlo + it * kTcTile;
      tc::mbar_wait(&empty[st], ((it / L::kStages) & 1) ^ 1);
      float* sst = stats + st * 3 * kTcTile;
#pragma unroll
      for (int r = lane; r < kTcTile; r += 32)
        tc_row_stats(p, sbase, q0 + r, sst[r], sst[kTcTile + r],
                     sst[2 * kTcTile + r]);
      if (lane == 0) {
        tc::mbar_expect_tx(&full[st], 2 * L::kTile);
        tc::tma_tile<NP>(Qs + st * L::kTile, kTcTile, &p.q, &full[st], q0,
                         h, b);
        tc::tma_tile<NP>(dOs + st * L::kTile, kTcTile, &p.dout, &full[st],
                         q0, h, b);
      } else {
        tc::mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumer warpgroup w: keys k0 .. k0 + 63, dK and dV columns of panels
    // w kNPW .. (w + 1) kNPW - 1
    if (kWGs > 1) tc::reg_alloc<tc::kConsumerRegs>();
    const int w = wg, t = threadIdx.x % 128, lane = t & 31;
    const int kr0 = k0 + 16 * (t >> 5) + (lane >> 2);  // keys kr0, kr0 + 8
    const int c0 = 2 * (lane & 3);

    float dka[kNPW][32], dva[kNPW][32];
#pragma unroll
    for (int pn = 0; pn < kNPW; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[pn][i] = dva[pn][i] = 0.f;
    const uint64_t k_desc = tc::desc(Ks), v_desc = tc::desc(Vs);

    tc::mbar_wait(kvbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % L::kStages;
      const int q0 = qlo + it * kTcTile;
      tc::mbar_wait(&full[st], (it / L::kStages) & 1);
      const uint64_t q_desc = tc::desc(Qs + st * L::kTile);
      const uint64_t do_desc = tc::desc(dOs + st * L::kTile);

      // S^T = K Q^T, dP^T = V dO^T (rows: keys, columns: query rows)
      float s[32], dp[32];
      tc::wg_fence();
      tc::product_ss<NP>(s, k_desc, kTcTile, q_desc, kTcTile);
      tc::product_ss<NP>(dp, v_desc, kTcTile, do_desc, kTcTile);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(s);
      tc::fence_regs(dp);

      // P^T and dS^T = P^T (dP^T - delta)
      const float* sst = stats + st * 3 * kTcTile;
      const bool edge = q0 + kTcTile > p.S || k0 + kTcTile > p.Tk ||
                        (p.causal && k0 + kTcTile - 1 > q0) ||
                        (p.window > 0 && k0 <= q0 + kTcTile - 1 - p.window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * i + c0 + e, row = q0 + qc;
          const float sm = sst[qc], lm = sst[kTcTile + qc];
          const float dl = sst[2 * kTcTile + qc];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int idx = 4 * i + 2 * half + e;
            const int key = kr0 + 8 * half;
            const bool vis = !edge ||
                             (row < p.S && key < p.Tk &&
                              (!p.causal || key <= row) &&
                              (p.window <= 0 || key > row - p.window));
            const float pv = vis ? expf(s[idx] * p.scale - sm) / lm : 0.f;
            s[idx] = pv;
            dp[idx] = pv * (dp[idx] - dl);
          }
        }

      // dV += P^T dO, dK += dS^T Q, each f32 operand split into hi + lo
      uint32_t hi[4][4], lo[4][4];
      tc::split_frags(s, hi, lo);
#pragma unroll
      for (int pn = 0; pn < kNPW; ++pn) {
        tc::fence_regs(dva[pn]);
        tc::fence_regs(dka[pn]);
      }
      tc::wg_fence();
#pragma unroll
      for (int pn = 0; pn < kNPW; ++pn)
        tc::product_rs_split(
            dva[pn], hi, lo,
            do_desc + (w * kNPW + pn) * tc::panel_step(kTcTile));
      uint32_t dhi[4][4], dlo[4][4];
      tc::split_frags(dp, dhi, dlo);
      tc::wg_fence();
#pragma unroll
      for (int pn = 0; pn < kNPW; ++pn)
        tc::product_rs_split(
            dka[pn], dhi, dlo,
            q_desc + (w * kNPW + pn) * tc::panel_step(kTcTile));
      tc::wg_commit();
      tc::wg_wait();
#pragma unroll
      for (int pn = 0; pn < kNPW; ++pn) {
        tc::fence_regs(dva[pn]);
        tc::fence_regs(dka[pn]);
      }
      if (t == 0) tc::mbar_arrive(&empty[st]);
    }

    // G = 1: dk = sum scale, dv = sum in bf16; else the f32 partials of this
    // query head, summed by flash_bwd_reduce_kernel
    const int kvh = p.H / p.G;
    const long long n_part = (long long)gridDim.y * p.Tk * p.H * p.D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kr0 + 8 * half;
      if (key >= p.Tk) continue;
      const long long out = (((long long)b * p.Tk + key) * kvh + hk) * p.D;
      const long long part = (((long long)b * p.Tk + key) * p.H + h) * p.D;
#pragma unroll
      for (int pn = 0; pn < kNPW; ++pn)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * (w * kNPW + pn) + 8 * i + c0;
          if (col >= p.D) continue;
          const int j = 4 * i + 2 * half;
          if (p.G == 1) {
            tc::store_bf16x2(p.dk + out + col, dka[pn][j] * p.scale,
                             dka[pn][j + 1] * p.scale);
            tc::store_bf16x2(p.dv + out + col, dva[pn][j], dva[pn][j + 1]);
          } else {
            *reinterpret_cast<float2*>(p.part + part + col) =
                make_float2(dka[pn][j], dka[pn][j + 1]);
            *reinterpret_cast<float2*>(p.part + n_part + part + col) =
                make_float2(dva[pn][j], dva[pn][j + 1]);
          }
        }
    }
  }
}

// dk[b, t, j] = scale sum_g part_k[b, t, j G + g], dv the same without the
// scale, the G partials summed in order g = 0, 1, ... (deterministic).
__global__ void flash_bwd_reduce_kernel(const float* __restrict__ part,
                                        __nv_bfloat16* __restrict__ dk,
                                        __nv_bfloat16* __restrict__ dv,
                                        long long n_pairs, long long n_part,
                                        int G, int D, float scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_pairs; i += (long long)gridDim.x * blockDim.x) {
    const long long o = 2 * i, r = o / D, c = o - r * D;
    const float* pk = part + r * G * D + c;
    float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
    for (int g = 0; g < G; ++g) {
      const float2 a = *reinterpret_cast<const float2*>(pk + g * D);
      const float2 v = *reinterpret_cast<const float2*>(pk + n_part + g * D);
      sk.x += a.x;
      sk.y += a.y;
      sv.x += v.x;
      sv.y += v.y;
    }
    tc::store_bf16x2(dk + o, sk.x * scale, sk.y * scale);
    tc::store_bf16x2(dv + o, sv.x, sv.y);
  }
}

template <int NP>
cudaError_t launch_bwd_tc(const BwdArgs& a, float* part,
                          cudaStream_t stream) {
  using L = BwdTcTile<NP>;
  const int G = (int)(a.H / a.KVH);
  if (G > 1 && part == nullptr) return cudaErrorInvalidValue;
  BwdTcParams p;
  cudaError_t err;
  // an empty side is never loaded: the other side's tensors stand in
  const bool no_q = a.S == 0, no_k = a.Tk == 0;
  const long long S = no_q ? a.Tk : a.S, Tk = no_k ? a.S : a.Tk;
  const long long H = no_q ? a.KVH : a.H, KVH = no_k ? a.H : a.KVH;
  if ((err = tc::make_map(&p.q, no_q ? a.k : a.q, a.B, S, H, a.D,
                          no_q ? a.ks : a.qs, kTcTile)) != cudaSuccess ||
      (err = tc::make_map(&p.dout, no_q ? a.k : a.dout, a.B, S, H, a.D,
                          no_q ? a.ks : a.dos, kTcTile)) != cudaSuccess ||
      (err = tc::make_map(&p.k, no_k ? a.q : a.k, a.B, Tk, KVH, a.D,
                          no_k ? a.qs : a.ks, kTcTile)) != cudaSuccess ||
      (err = tc::make_map(&p.v, no_k ? a.q : a.v, a.B, Tk, KVH, a.D,
                          no_k ? a.qs : a.vs, kTcTile)) != cudaSuccess)
    return err;
  p.m = a.m;
  p.l = a.l;
  p.delta = a.delta;
  p.dq = static_cast<__nv_bfloat16*>(a.dq);
  p.dk = static_cast<__nv_bfloat16*>(a.dk);
  p.dv = static_cast<__nv_bfloat16*>(a.dv);
  p.part = part;
  p.S = (int)a.S;
  p.Tk = (int)a.Tk;
  p.H = (int)a.H;
  p.G = G;
  p.D = (int)a.D;
  p.causal = a.causal;
  p.window = a.window;
  p.scale = a.scale;
  if (a.S > 0) {
    auto kernel = flash_bwd_dq_tc_kernel<NP>;
    if ((err = tc::prepare(kernel, L::kSmemDq, 128 + 32)) != cudaSuccess)
      return err;
    const dim3 grid((unsigned)a.H, (unsigned)a.B,
                    (unsigned)((a.S + kTcTile - 1) / kTcTile));
    kernel<<<grid, 128 + 32, L::kSmemDq, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.Tk > 0) {
    auto kernel = flash_bwd_dkv_tc_kernel<NP>;
    if ((err = tc::prepare(kernel, L::kSmemDkv, L::kDkvThreads)) !=
        cudaSuccess)
      return err;
    const dim3 grid((unsigned)a.H, (unsigned)a.B,
                    (unsigned)((a.Tk + kTcTile - 1) / kTcTile));
    kernel<<<grid, L::kDkvThreads, L::kSmemDkv, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (G > 1) {
      const long long n_pairs = a.B * a.Tk * a.KVH * a.D / 2;
      const long long want = (n_pairs + 255) / 256;
      const long long blocks = want < 132 * 16 ? want : 132 * 16;
      flash_bwd_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
          part, p.dk, p.dv, n_pairs, a.B * a.Tk * a.H * a.D, G, (int)a.D,
          a.scale);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

cudaError_t dispatch_bwd_tc(const BwdArgs& a, float* part,
                            cudaStream_t stream) {
  if (a.D <= 64) return launch_bwd_tc<1>(a, part, stream);
  if (a.D <= 128) return launch_bwd_tc<2>(a, part, stream);
  return launch_bwd_tc<4>(a, part, stream);
}

}  // namespace rj

// dtype: 0 = float32, 1 = bfloat16.  dq [B, S, H, D] and dk, dv
// [B, T, KVH, D] contiguous; m, l, delta [B, H, S] f32 contiguous; q, k,
// v and do have unit stride along D, 16-byte aligned bases and rows, D a
// multiple of 8 up to 256 and H a multiple of KVH (the wrapper checks all
// of it).  part: f32 scratch [2, B, T, H, D] for bf16 with H > KVH, else
// unused (may be null).
extern "C" int rj_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const float* m, const float* l,
                            const float* delta, void* dq, void* dk, void* dv,
                            float* part, int dtype, long long B, long long S,
                            long long Tk,
                            long long H, long long KVH, long long D,
                            long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            long long dsb, long long dss, long long dsh,
                            int causal, int window, float scale, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D <= 0 || D > 256 || D % 8 || KVH <= 0 || H % KVH || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  const rj::BwdArgs a{q,  k,  v,  dout, m,
                      l,  delta, dq, dk, dv,
                      B,  S,  Tk, H,  KVH,
                      D,  {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
                      {dsb, dss, dsh}, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)rj::dispatch_bwd<float>(a, s);
  if (dtype == 1) return (int)rj::dispatch_bwd_tc(a, part, s);
  return (int)cudaErrorInvalidValue;
}
