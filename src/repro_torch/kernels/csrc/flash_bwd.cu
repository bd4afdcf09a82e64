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
// Design: two kernels, as the Pallas version has, neither with atomics,
// so a training step is deterministic on the card.  CTAs of 256 threads
// (16 x 16) stage tiles through shared memory in the input type (f32 or
// bf16; flash_common.cuh) and run every product as f32 FMAs on the CUDA
// cores, as flash_fwd.cu does (a first kernel: right before fast).
//   dq:  one CTA per (q tile of kBQ = 64 rows, head, batch), heaviest
//        causal tiles first.  It stages its q and do tiles once, then
//        walks the visible key tiles (kBK keys): S = q k^T and
//        dP = do v^T (thread (ty, tx): rows 4ty..4ty+3, keys tx + 16j),
//        P and dS in registers, dS to shared memory, dQ += dS K with the
//        thread owning rows 4ty..4ty+3 and columns 4tx + 64jj.
//   dkv: one CTA per (key tile of kBK keys, kv head, batch).  It stages
//        its k and v tiles once and loops over the kv head's query heads
//        and, for each, over the q tiles that can see the key tile: rows
//        >= k0 when causal, rows < k1 - 1 + window with a window (taken
//        from the mask; the Pallas kernel masks every q chunk instead).
//        P and dS go to shared memory [q row][key]; dV += P^T dO and
//        dK += dS^T Q with the thread owning keys kRJ ty..kRJ ty + kRJ-1
//        and columns 4tx + 64jj.
// Rows and keys past the ends and invisible pairs give p = 0; a row with
// no visible key (l = 0, m = -2e38) gets dq = 0 and adds nothing.  q, k,
// v and do are read through their strides; dq, dk, dv are written
// contiguous in the input type from f32 sums.
// Bound: the operations, 10 D flops per visible (q, k) pair (four
// products and the recomputed scores), over the bf16 tensor-core rate;
// these FMAs run at the f32 CUDA-core rate, so the kernel cannot come near
// it.
//
// Shared memory: four staged tiles of (D + 4) elements per row plus the
// f32 P / dS tiles.  kBK is 64, or 32 at D > 128: at D = 256 in f32 the
// dkv kernel then takes (2 x 64 + 2 x 32) x 260 x 4 + 2 x 64 x 36 x 4 =
// 218,112 bytes and the dq kernel 208,384, under the 232,448 a CTA can opt
// into (cudaFuncSetAttribute); with 64-key tiles it would need 266 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"
#include "flash_common.cuh"

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

}  // namespace rj

// dtype: 0 = float32, 1 = bfloat16.  dq [B, S, H, D] and dk, dv
// [B, T, KVH, D] contiguous; m, l, delta [B, H, S] f32 contiguous; q, k,
// v and do have unit stride along D, 4-element aligned rows, D a multiple
// of 8 up to 256 and H a multiple of KVH (the wrapper checks all of it).
extern "C" int rj_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const float* m, const float* l,
                            const float* delta, void* dq, void* dk, void* dv,
                            int dtype, long long B, long long S, long long Tk,
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
  if (dtype == 1) return (int)rj::dispatch_bwd<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
