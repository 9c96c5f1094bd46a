// Bias + ReLU + 2x2/2 max pool over an NHWC conv output (kernel 2 of the
// port).
//
// Replaces dl_vqa_tpu/ops/conv_fused.py::_relu_pool_kernel and
// ::_relu_pool_direct_kernel, which compute the same function:
//   out[b, i, j, ch] = max over the 2x2 window at (2i, 2j) of
//                      cast(relu(f32(y) + bias[ch]))
// with floor semantics (an odd last row or column is dropped). Bias add,
// ReLU and the rounding cast are monotone non-decreasing, so they commute
// with max: the kernel takes the max of the four raw values first and
// applies bias, ReLU and the cast once, which gives the same bits.
//
// The block is bound by reading y once (3.2 GB for conv0 at batch 512 in
// bf16) and writing a quarter of that. One block walks one pooled row
// (b, i); one thread makes one output element, channels fastest, so the
// loads of a warp are contiguous.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_maxpool_kernel(const T* __restrict__ y,         // [B, Hc, Wc, C]
                    const float* __restrict__ bias,  // [C]
                    T* __restrict__ out,             // [B, Hc/2, Wc/2, C]
                    int hc, int wc, int channels) {
  const int hp = hc / 2, wp = wc / 2;
  const int64_t row = blockIdx.x;  // pooled row index b * hp + i
  const int64_t b = row / hp;
  const int i = static_cast<int>(row % hp);
  const int64_t in_row = static_cast<int64_t>(wc) * channels;
  const T* top = y + (b * hc + 2 * i) * in_row;
  T* dst = out + row * wp * channels;
  const int n = wp * channels;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int j = e / channels, ch = e % channels;
    const T* p = top + static_cast<int64_t>(2 * j) * channels + ch;
    const float m = fmaxf(
        fmaxf(vqa::to_float(p[0]), vqa::to_float(p[channels])),
        fmaxf(vqa::to_float(p[in_row]), vqa::to_float(p[in_row + channels])));
    dst[e] = vqa::from_float<T>(fmaxf(m + bias[ch], 0.0f));
  }
}

template <typename T>
cudaError_t run(const void* y, const float* bias, void* out, int batch,
                int hc, int wc, int channels, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(batch) * (hc / 2);
  if (rows == 0 || wc / 2 == 0) return cudaSuccess;
  relu_maxpool_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(y), bias, static_cast<T*>(out), hc, wc, channels);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vqa_relu_maxpool(const void* y, const void* bias, void* out,
                                int batch, int hc, int wc, int channels,
                                int dtype, void* stream) {
  const float* b = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vqa::kBFloat16:
      return run<__nv_bfloat16>(y, b, out, batch, hc, wc, channels, s);
    case vqa::kFloat32:
      return run<float>(y, b, out, batch, hc, wc, channels, s);
    default:
      return cudaErrorInvalidValue;
  }
}
