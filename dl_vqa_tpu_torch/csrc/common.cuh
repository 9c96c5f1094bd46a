// Helpers shared by the kernels of dl_vqa_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vqa {

// Element type codes passed from Python (ops/_native.py).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Eight f32 values rounded to bf16 and packed for one 16-byte store.
__device__ __forceinline__ uint4 pack8(const float* x) {
  __nv_bfloat162 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  uint4 out;
  out.x = *reinterpret_cast<unsigned*>(&p[0]);
  out.y = *reinterpret_cast<unsigned*>(&p[1]);
  out.z = *reinterpret_cast<unsigned*>(&p[2]);
  out.w = *reinterpret_cast<unsigned*>(&p[3]);
  return out;
}

// Eight f32 values cast to T and stored at dst, which is 16-byte aligned:
// one 16-byte store for bf16, two for f32.
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* x) {
  *reinterpret_cast<uint4*>(dst) = pack8(x);
}
__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// Eight values of T at src (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float* x) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

}  // namespace vqa
