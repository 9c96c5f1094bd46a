// Kernel G of the port: Pillow's bilinear resize (ImagingResample, 8 bits a
// channel) of an RGB8 image, only at the pixels of the centre crop, for the
// "exact" image decoder (data/images.py).
//
// No TPU kernel behind it: the JAX package resizes with PIL on the host
// (dl_vqa_tpu/data/images.py:54). The taps are made on the host as Pillow
// makes them (precompute_coeffs in double, normalize_coeffs_8bpc to 22
// fraction bits: ops/exact_decode.py::resample_plan), already cut to the
// crop's columns and rows. Each output pixel runs Pillow's two passes: for
// each of its vertical taps, the horizontal pass of that input row at its
// column, rounded as Pillow rounds the intermediate image
// ((ss + (1 << 21)) >> 22, clipped to 0-255), then the vertical pass over
// those values, rounded alike. An output pixel of the crop depends only on
// its own taps, so its bits are those of the whole resize cropped. The
// plain version, ops/exact_decode.py::pil_resample_reference, is its oracle
// to the bit.
//
// Bound: bytes. The function reads only the input rectangle the crop's
// taps span (422 x 422 x 3 B of a 640x480 image at 224 px), its taps, and
// writes 224 x 224 x 3: 0.70 MB. This kernel recomputes the horizontal
// pass for each output row that shares an input row (about 2.6 times the
// products the function needs at COCO's sizes), which the card hides
// under the reads. One thread an output pixel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPrecision = 22;

__device__ __forceinline__ int clip8(int v) {
  v >>= kPrecision;
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// taps: [size, 2 + kx] for the columns (first input column, count, then
// kx coefficients), then [size, 2 + ky] for the rows.
__global__ void __launch_bounds__(kThreads)
pil_resample_kernel(const uint8_t* __restrict__ in, int in_w,
                    const int* __restrict__ taps, int kx, int ky, int size,
                    uint8_t* __restrict__ out) {
  const int x = blockIdx.x * kThreads + threadIdx.x, y = blockIdx.y;
  if (x >= size) return;
  const int* xt = taps + static_cast<size_t>(x) * (2 + kx);
  const int* yt = taps + static_cast<size_t>(size) * (2 + kx) +
                  static_cast<size_t>(y) * (2 + ky);
  const int xmin = xt[0], xn = xt[1], ymin = yt[0], yn = yt[1];
  const int half = 1 << (kPrecision - 1);
  int acc[3] = {half, half, half};
  for (int j = 0; j < yn; ++j) {
    const uint8_t* row =
        in + (static_cast<size_t>(ymin + j) * in_w + xmin) * 3;
    int h[3] = {half, half, half};
    for (int i = 0; i < xn; ++i) {
      const int k = xt[2 + i];
      h[0] += row[3 * i] * k;
      h[1] += row[3 * i + 1] * k;
      h[2] += row[3 * i + 2] * k;
    }
    const int k = yt[2 + j];
    for (int c = 0; c < 3; ++c) acc[c] += clip8(h[c]) * k;
  }
  uint8_t* o = out + (static_cast<size_t>(y) * size + x) * 3;
  for (int c = 0; c < 3; ++c) o[c] = static_cast<uint8_t>(clip8(acc[c]));
}

}  // namespace

// in: RGB8 [in_h, in_w, 3]; taps as above (int32); out: RGB8 [size, size,
// 3]. Returns cudaGetLastError() of the launch.
extern "C" int vqa_pil_resample(const void* in, int in_w, int in_h,
                                const void* taps, int kx, int ky, int size,
                                void* out, void* stream) {
  if (in_w < 1 || in_h < 1 || kx < 1 || ky < 1 || size < 1 || size > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((size + kThreads - 1) / kThreads, size);
  pil_resample_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), in_w, static_cast<const int*>(taps),
      kx, ky, size, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
