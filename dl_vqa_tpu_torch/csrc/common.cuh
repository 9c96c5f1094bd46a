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

}  // namespace vqa
