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
// Design.  One CTA of 256 threads (16 x 16) per (q tile of kBQ = 64 rows,
// head, batch); the tiles with the most causal work are launched first.
// The CTA stages its q tile once and then each kv tile of kBK = 64 keys
// through shared memory in the input type (f32 or bf16), rows padded by
// 4 elements so that the vector reads of 16 threads hit distinct banks.
// Per kv tile:
//   1. S = q k^T: thread (ty, tx) takes rows 4ty..4ty+3 and keys tx + 16j
//      (j < 4), 16 f32 sums, reading 4-element vectors of q and k;
//   2. mask, scale, and the online softmax in f32: the row max and row
//      sum are reduced over the 16 lanes of a row group with shuffles,
//      the accumulator rescaled by exp(m_old - m_new); a row with no
//      visible key keeps m = -2e38 and its exp() arguments at -inf
//      (the Pallas kernel's guard), so it ends with o = 0, l = 0;
//   3. P (f32, never rounded) goes to shared memory; O += P V with thread
//      (ty, tx) owning rows 4ty..4ty+3 and columns 4tx + 64jj..+3.
// Causal tiles past the diagonal are skipped, as the Pallas kernel's loop
// bound does; tiles wholly before q - window + 1 are skipped too (the
// Pallas kernel masks them: they add nothing).  GQA reads the kv head's
// rows in place; q, k, v are read through their strides ([B, S, H, D] as
// the model makes them), so no transpose copy is made.  Both products run
// on the CUDA cores in f32 FMAs (a first kernel: right before fast).
// Bound: the operations, 4 D flops per visible (q, k) pair, over the bf16
// tensor-core rate; these FMAs run at the f32 CUDA-core rate, so the
// kernel cannot come near it.
//
// Shared memory: 3 x 64 x (D + 4) elements + 64 x 68 f32, 115 KB at
// D = 256 in bf16 and 212 KB in f32, above the 48 KB default: the launcher
// opts in to it with cudaFuncSetAttribute (one CTA of 256 threads per SM
// at D = 256; no tile is shrunk).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"
#include "flash_common.cuh"

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

}  // namespace rj

// dtype: 0 = float32, 1 = bfloat16.  o is [B, S, H, D] contiguous, m and
// l [B, H, S] contiguous; q, k, v have unit stride along D, 4-element
// aligned rows, D a multiple of 8 up to 256 and H a multiple of KVH (the
// wrapper checks all of it).
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
    err = rj::dispatch_flash<__nv_bfloat16>(D, q, k, v, o, m, l, B, S, Tk, H,
                                            KVH, qs, ks, vs, causal, window,
                                            scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
