// Kernel F of the port: libjpeg's chroma upsampling and colour conversion,
// then PIL's convert("RGB"), for the "exact" image decoder
// (data/images.py).
//
// No TPU kernel behind it: the JAX package decodes with PIL on the host
// (dl_vqa_tpu/data/images.py:64). Each output pixel reads each
// component's plane (kernel E's output) at the component's real samples
// only, never the padding of the last MCU:
//
// * upsampling (jdsample.c at do_fancy_upsampling): full size; h2v1 and
//   h2v2 "fancy" triangle filters (3/4 nearer sample + 1/4 farther, h2v2's
//   biases 8 and 7 on alternate outputs), where the plane is over 2
//   samples wide, else replication; h1v2 fancy (biases 1 and 2); any other
//   integral ratio by replication. The edge sample and row stand in for
//   the ones beyond (jdmainct.c's context rows replicate the first and
//   last real row);
// * colour (jdcolor.c): YCbCr -> RGB by its 16-bit tables; greyscale
//   replicated (PIL's L -> RGB); RGB passed through; CMYK taken as it is
//   and YCCK by ycck_cmyk_convert, then inverted (PIL's "CMYK;I" raw mode)
//   and converted by Pillow's cmyk2rgb.
//
// The plain version, ops/exact_decode.py::upsample_color_reference, is its
// oracle to the bit. Bound: bytes (a 640x480 4:2:0 image reads about 0.46
// MB of planes and writes 0.92 MB); one thread an output pixel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Upsampling methods, as ops/exact_decode.py::upsample_method names them.
enum Method { kFull = 0, kH2V1 = 1, kH1V2 = 2, kH2V2 = 3, kReplicate = 4 };
enum Space { kGrey = 1, kRgb = 2, kYCbCr = 3, kCmyk = 4, kYcck = 5 };

struct Plane {
  const uint8_t* p;
  int pitch, w, h, he, ve, method;
};

struct Args {
  Plane c[4];
  int ncomp, space, width, height;
  uint8_t* out;  // [height, width, 3]
};

__device__ __forceinline__ int at(const Plane& c, int r, int x) {
  r = min(max(r, 0), c.h - 1);
  x = min(max(x, 0), c.w - 1);
  return c.p[static_cast<size_t>(r) * c.pitch + x];
}

// Component sample at output pixel (x, y).
__device__ __forceinline__ int upsample(const Plane& c, int x, int y) {
  switch (c.method) {
    case kFull:
      return at(c, y, x);
    case kH2V1: {
      const int j = x >> 1;
      const int v = 3 * at(c, y, j);
      return (x & 1) ? (v + at(c, y, j + 1) + 2) >> 2
                     : (v + at(c, y, j - 1) + 1) >> 2;
    }
    case kH1V2: {
      const int r = y >> 1, far = (y & 1) ? r + 1 : r - 1;
      return (3 * at(c, r, x) + at(c, far, x) + ((y & 1) ? 2 : 1)) >> 2;
    }
    case kH2V2: {
      const int r = y >> 1, far = (y & 1) ? r + 1 : r - 1;
      const int j = x >> 1;
      const int here = 3 * at(c, r, j) + at(c, far, j);
      const int k = (x & 1) ? j + 1 : j - 1;
      const int there = 3 * at(c, r, k) + at(c, far, k);
      return (3 * here + there + ((x & 1) ? 7 : 8)) >> 4;
    }
    default:
      return at(c, y / c.ve, x / c.he);
  }
}

// jdcolor.c's FIX(x) at SCALEBITS 16, made at compile time.
constexpr int kScaleBits = 16;
constexpr long long kHalf = 1LL << (kScaleBits - 1);
constexpr long long fix(double x) {
  return static_cast<long long>(x * (1LL << kScaleBits) + 0.5);
}
constexpr long long kCrR = fix(1.40200), kCbB = fix(1.77200),
                    kCrG = fix(0.71414), kCbG = fix(0.34414);

__device__ __forceinline__ int clamp255(long long v) {
  return static_cast<int>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jdcolor.c build_ycc_rgb_table and ycc_rgb_convert, before the clamp.
__device__ __forceinline__ void ycc(int y, int cb, int cr, long long rgb[3]) {
  const long long xb = cb - 128, xr = cr - 128;
  rgb[0] = y + ((kCrR * xr + kHalf) >> kScaleBits);
  rgb[1] = y + ((-kCbG * xb + kHalf - kCrG * xr) >> kScaleBits);
  rgb[2] = y + ((kCbB * xb + kHalf) >> kScaleBits);
}

// Pillow's MULDIV255.
__device__ __forceinline__ int muldiv255(int a, int b) {
  const int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

__global__ void __launch_bounds__(kThreads)
exact_color_kernel(const Args args) {
  const int x = blockIdx.x * kThreads + threadIdx.x, y = blockIdx.y;
  if (x >= args.width) return;
  int s[4] = {0, 0, 0, 0};
  for (int k = 0; k < args.ncomp; ++k) s[k] = upsample(args.c[k], x, y);
  int rgb[3];
  if (args.space == kGrey) {
    rgb[0] = rgb[1] = rgb[2] = s[0];
  } else if (args.space == kRgb) {
    rgb[0] = s[0];
    rgb[1] = s[1];
    rgb[2] = s[2];
  } else if (args.space == kYCbCr) {
    long long v[3];
    ycc(s[0], s[1], s[2], v);
    for (int k = 0; k < 3; ++k) rgb[k] = clamp255(v[k]);
  } else {
    int cmyk[4] = {s[0], s[1], s[2], s[3]};
    if (args.space == kYcck) {
      long long v[3];
      ycc(s[0], s[1], s[2], v);
      for (int k = 0; k < 3; ++k) cmyk[k] = clamp255(255 - v[k]);
    }
    // "CMYK;I": each sample inverted; then cmyk2rgb.
    const int nk = 255 - (255 - cmyk[3]);
    for (int k = 0; k < 3; ++k) rgb[k] = nk - muldiv255(255 - cmyk[k], nk);
  }
  uint8_t* out = args.out + (static_cast<size_t>(y) * args.width + x) * 3;
  out[0] = static_cast<uint8_t>(rgb[0]);
  out[1] = static_cast<uint8_t>(rgb[1]);
  out[2] = static_cast<uint8_t>(rgb[2]);
}

}  // namespace

// Four of each plane field (planes null beyond ncomp): the plane, its
// pitch, its real width and height, its expansion across and down and its
// method; then ncomp, the colour space (libjpeg's J_COLOR_SPACE), the
// image's width and height, out, stream. Returns cudaGetLastError().
extern "C" int vqa_exact_color(
    const void* p0, const void* p1, const void* p2, const void* p3,
    int pitch0, int pitch1, int pitch2, int pitch3, int w0, int w1, int w2,
    int w3, int h0, int h1, int h2, int h3, int he0, int he1, int he2,
    int he3, int ve0, int ve1, int ve2, int ve3, int m0, int m1, int m2,
    int m3, int ncomp, int space, int width, int height, void* out,
    void* stream) {
  if (ncomp < 1 || ncomp > 4 || width < 1 || height < 1 || height > 65535 ||
      space < kGrey || space > kYcck)
    return cudaErrorInvalidValue;
  const void* ps[4] = {p0, p1, p2, p3};
  const int pitches[4] = {pitch0, pitch1, pitch2, pitch3};
  const int ws[4] = {w0, w1, w2, w3}, hs[4] = {h0, h1, h2, h3};
  const int hes[4] = {he0, he1, he2, he3}, ves[4] = {ve0, ve1, ve2, ve3};
  const int ms[4] = {m0, m1, m2, m3};
  Args args{};
  for (int k = 0; k < ncomp; ++k) {
    if (ws[k] < 1 || hs[k] < 1 || hes[k] < 1 || ves[k] < 1)
      return cudaErrorInvalidValue;
    args.c[k] = {static_cast<const uint8_t*>(ps[k]), pitches[k], ws[k],
                 hs[k], hes[k], ves[k], ms[k]};
  }
  args.ncomp = ncomp;
  args.space = space;
  args.width = width;
  args.height = height;
  args.out = static_cast<uint8_t*>(out);
  const dim3 grid((width + kThreads - 1) / kThreads, height);
  exact_color_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
