// Bias + ReLU + 2x2/2 max pool over an NHWC conv output (kernel 2 of the
// port), with three output modes.
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
// The two other modes have no TPU kernel behind them (XLA computes them in
// the JAX package) and replace the pool of its quantized serving modes:
// - kE4m3, the f8 storage of ops/conv_fused.py::conv_relu_pool_quantstore:
//   relu(f32(y) + bias) converted f32 -> e4m3 in one rounding, with no
//   saturation (a value above 464 becomes NaN, as JAX's astype does; the max
//   is taken before the cast, so NaN is never fed to fmaxf), then widened to
//   the compute type, which holds every e4m3 value exactly;
// - kInt8, ops/conv_int8.py::quantize_relu_pool: clip(rint(relu(f32(y) +
//   bias) * scale), 0, 127) stored as int8, scale = 127 / s_out rounded to
//   f32 once by the caller. rint rounds half to even, as jnp.round.
// The cast, the rounding and the clip are non-decreasing too, so max first
// stays exact in both.
//
// The block is bound by reading y once (3.2 GB for conv0 at batch 512 in
// bf16) and writing a quarter of that (an eighth in int8). One block walks
// one pooled row (b, i); one thread makes one output element, channels
// fastest, so the loads of a warp are contiguous.

#include <stdint.h>

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Output modes, the `mode` argument of the C entry (ops/conv_fused.py).
constexpr int kCompute = 0;
constexpr int kE4m3 = 1;
constexpr int kInt8 = 2;

template <typename T, int kMode>
struct Out { using type = T; };
template <typename T>
struct Out<T, kInt8> { using type = int8_t; };

template <typename T, int kMode>
__device__ __forceinline__ typename Out<T, kMode>::type finish(float v,
                                                              float scale) {
  if constexpr (kMode == kCompute) {
    return vqa::from_float<T>(v);
  } else if constexpr (kMode == kE4m3) {
    const __nv_fp8_storage_t q =
        __nv_cvt_float_to_fp8(v, __NV_NOSAT, __NV_E4M3);
    const __half h(__nv_cvt_fp8_to_halfraw(q, __NV_E4M3));
    return vqa::from_float<T>(__half2float(h));
  } else {
    const float r = rintf(__fmul_rn(v, scale));
    return static_cast<int8_t>(fminf(fmaxf(r, 0.0f), 127.0f));
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
relu_maxpool_kernel(const T* __restrict__ y,         // [B, Hc, Wc, C]
                    const float* __restrict__ bias,  // [C]
                    typename Out<T, kMode>::type* __restrict__ out,
                    int hc, int wc, int channels, float scale) {
  const int hp = hc / 2, wp = wc / 2;
  const int64_t row = blockIdx.x;  // pooled row index b * hp + i
  const int64_t b = row / hp;
  const int i = static_cast<int>(row % hp);
  const int64_t in_row = static_cast<int64_t>(wc) * channels;
  const T* top = y + (b * hc + 2 * i) * in_row;
  auto* dst = out + row * wp * channels;
  const int n = wp * channels;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int j = e / channels, ch = e % channels;
    const T* p = top + static_cast<int64_t>(2 * j) * channels + ch;
    const float m = fmaxf(
        fmaxf(vqa::to_float(p[0]), vqa::to_float(p[channels])),
        fmaxf(vqa::to_float(p[in_row]), vqa::to_float(p[in_row + channels])));
    dst[e] = finish<T, kMode>(fmaxf(m + bias[ch], 0.0f), scale);
  }
}

template <typename T, int kMode>
cudaError_t run(const void* y, const float* bias, void* out, int batch,
                int hc, int wc, int channels, float scale,
                cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(batch) * (hc / 2);
  if (rows == 0 || wc / 2 == 0) return cudaSuccess;
  relu_maxpool_kernel<T, kMode>
      <<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
          static_cast<const T*>(y), bias,
          static_cast<typename Out<T, kMode>::type*>(out), hc, wc, channels,
          scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_mode(const void* y, const float* bias, void* out, int batch,
                     int hc, int wc, int channels, int mode, float scale,
                     cudaStream_t stream) {
  switch (mode) {
    case kCompute:
      return run<T, kCompute>(y, bias, out, batch, hc, wc, channels, scale,
                              stream);
    case kE4m3:
      return run<T, kE4m3>(y, bias, out, batch, hc, wc, channels, scale,
                           stream);
    case kInt8:
      return run<T, kInt8>(y, bias, out, batch, hc, wc, channels, scale,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// `scale` is read in the int8 mode only.
extern "C" int vqa_relu_maxpool(const void* y, const void* bias, void* out,
                                int batch, int hc, int wc, int channels,
                                int dtype, int mode, float scale,
                                void* stream) {
  const float* b = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vqa::kBFloat16:
      return run_mode<__nv_bfloat16>(y, b, out, batch, hc, wc, channels, mode,
                                     scale, s);
    case vqa::kFloat32:
      return run_mode<float>(y, b, out, batch, hc, wc, channels, mode, scale,
                             s);
    default:
      return cudaErrorInvalidValue;
  }
}
