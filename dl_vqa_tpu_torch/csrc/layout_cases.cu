// Four re-layouts of a [R, W, C] block (kernel 9 of the port).
//
// Replaces the case kernels that
// experiments/probe_mosaic_recheck.py::run_kernel compiles: the W-pair split max, the
// W-pair merge, the strided-slice max and the shifted concatenation. On the
// TPU each was a question to the compiler, whether it can re-tile a vector
// register whose two minor dimensions are (W, C); the conv0 pooling of the
// JAX package was shaped by the answers. This card has no tiled register
// layout: a thread addresses any element, so all four are index arithmetic
// on 16-byte vectors, and the only bound is the bytes moved (a few tens of
// KB at the probe's shapes: the launch itself takes longer).
//
//   mode 0  out[r, j, :] = max(x[r, 2j, :], x[r, 2j + 1, :])     [R, W/2, C]
//   mode 1  out[r, j, :] = x[r, 2j, :] | x[r, 2j + 1, :]         [R, W/2, 2C]
//   mode 2  out = max(x[:, 0::2, :], x[:, 1::2, :])              [R, W/2, C]
//   mode 3  out[r, j, :] = x[r, (j + 1) mod W, :]                [R, W, C]
//
// Modes 0 and 2 are two spellings of one function and share a body; mode 1
// moves no element in row-major memory and is a copy. One thread makes one
// 16-byte vector of the output, channels fastest.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ uint4 max_vectors(uint4 a, uint4 b) {
  constexpr int kVec = 16 / sizeof(T);
  const T* pa = reinterpret_cast<const T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
  uint4 out;
  T* po = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    po[i] = vqa::to_float(pa[i]) >= vqa::to_float(pb[i]) ? pa[i] : pb[i];
  return out;
}

// x and out as arrays of 16-byte vectors; cv vectors a pixel.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
layout_case_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                   int rows, int width, int cv) {
  const int out_width = kMode == 0 || kMode == 2 ? width / 2 : width;
  const int64_t total = static_cast<int64_t>(rows) * out_width * cv;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int v = static_cast<int>(e % cv);
  const int j = static_cast<int>((e / cv) % out_width);
  const int64_t row = e / cv / out_width * width;
  if (kMode == 0 || kMode == 2) {
    out[e] = max_vectors<T>(x[(row + 2 * j) * cv + v],
                            x[(row + 2 * j + 1) * cv + v]);
  } else if (kMode == 1) {
    // Out pixel j is pixels 2j and 2j + 1 side by side: vector e of the
    // output is vector e of the input.
    out[e] = x[e];
  } else {
    out[e] = x[(row + (j + 1 == width ? 0 : j + 1)) * cv + v];
  }
}

template <typename T, int kMode>
cudaError_t run(const void* x, void* out, int rows, int width, int channels,
                cudaStream_t stream) {
  const int cv = channels / (16 / static_cast<int>(sizeof(T)));
  const int64_t total =
      static_cast<int64_t>(rows) *
      (kMode == 0 || kMode == 2 ? width / 2 : width) * cv;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  layout_case_kernel<T, kMode><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), rows, width, cv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_mode(const void* x, void* out, int rows, int width,
                     int channels, int mode, cudaStream_t stream) {
  switch (mode) {
    case 0: return run<T, 0>(x, out, rows, width, channels, stream);
    case 1: return run<T, 1>(x, out, rows, width, channels, stream);
    case 2: return run<T, 2>(x, out, rows, width, channels, stream);
    case 3: return run<T, 3>(x, out, rows, width, channels, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [R, W, C] -> out as the mode says, both of the type `dtype` names; C a
// multiple of a 16-byte vector, W even for modes 0 to 2.
extern "C" int vqa_layout_case(const void* x, void* out, int rows, int width,
                               int channels, int mode, int dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vqa::kBFloat16:
      return run_mode<__nv_bfloat16>(x, out, rows, width, channels, mode, s);
    case vqa::kFloat32:
      return run_mode<float>(x, out, rows, width, channels, mode, s);
    default:
      return cudaErrorInvalidValue;
  }
}
