// Pieces shared by the flash attention kernels (flash_fwd.cu and
// flash_bwd.cu): 256-thread CTAs that stage rows of one head of a
// [B, S, H, D] tensor, read through its strides, into shared memory in the
// input type (f32 or bf16), rows padded by kPad elements so that the
// vector reads of 16 threads hit distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rj {

constexpr int kFlashThreads = 256;  // 16 x 16
constexpr int kPad = 4;             // elements of padding per staged row
constexpr float kNegInf = -2.0e38f;

// Four consecutive elements of T: loads (converted to f32), stores and
// raw copies (8 bytes for bf16, 16 for f32).
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  using Raw = float4;
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ Raw pack(const float v[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float v[4]) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ Raw pack(const float v[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const unsigned*>(&a);
    x.y = *reinterpret_cast<const unsigned*>(&b);
    return x;
  }
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
};

struct Strides {
  long long b, s, h;  // element strides of batch, position and head
};

// Copy rows [row0, row0 + n_rows) of one head of x (rows past `limit` are
// zero) into `dst` [n_rows][ld].
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* x,
                                           Strides st, long long b,
                                           long long h, int row0, int n_rows,
                                           int limit, int d, int tid) {
  using V = Vec4<T>;
  const int nv = d / 4;
  for (int idx = tid; idx < n_rows * nv; idx += kFlashThreads) {
    const int r = idx / nv, c = (idx - r * nv) * 4;
    const int row = row0 + r;
    typename V::Raw val = V::zero();
    if (row < limit)
      val = *reinterpret_cast<const typename V::Raw*>(
          x + b * st.b + (long long)row * st.s + h * st.h + c);
    *reinterpret_cast<typename V::Raw*>(dst + r * ld + c) = val;
  }
}

}  // namespace rj
