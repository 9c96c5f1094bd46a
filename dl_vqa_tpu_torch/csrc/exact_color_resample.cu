// Kernels F and G of the port in one kernel over a batch of images
// (color_resample), for the "exact" image decoder (data/images.py): for
// each image, libjpeg's chroma upsampling and colour conversion and PIL's
// convert("RGB") (a JPEG's planes, kernel E's output), or an RGB8 image as
// it is (a PNG's or BMP's), then Pillow's bilinear resize (ImagingResample,
// 8 bits a channel) at the centre crop's pixels.
//
// No TPU kernel behind it: the JAX package decodes and resizes with PIL on
// the host (dl_vqa_tpu/data/images.py:64). Its oracle to the bit is the
// composition of the plain versions, ops/exact_decode.py::
// color_resample_reference (upsample_color_reference, then
// pil_resample_reference).
//
// The grid runs over (image, output tile) of the whole batch: one block a
// tile. The plan (ops/exact_decode.py::tile_plan, passed whole; nothing
// here decides a tile) gives each tile its output pixels, the input
// rectangle its taps reach, the rows of that rectangle coloured at a time
// (a strip: the whole rectangle unless the tile is one pixel of a very
// large image), each component's staged window and every shared-memory
// offset. A block
//
// 1. stages its tile's column and row taps (cp.async, 4 bytes);
// 2. for each strip, stages the samples of each component plane that the
//    strip's upsampling reads (cp.async, 16 bytes where the plane's pitch
//    and the window allow, else 8: a pitch is a multiple of 8, and the
//    plan starts each window at a multiple of 16 columns), one
//    sample of halo around it, clamped to the component's real samples
//    (jdmainct.c's replicated edge rows, as kernel F clamped); or loads the
//    strip of an RGB8 image (byte loads: its rows are 3 * width apart);
// 3. upsamples each subsampled component over the strip (jdsample.c: fancy
//    h2v1 and h2v2 a lane a sample column and its two output columns, h2v2
//    a warp a sample row and its two output rows from column sums, as
//    libjpeg's h2v2_fancy_upsample works; h1v2 fancy or replication a lane
//    an output column), then converts each pixel (jdcolor.c's YCbCr
//    at 16 fraction bits, grey, RGB, CMYK and YCCK through PIL's "CMYK;I"
//    and cmyk2rgb), a full-size component read straight from its window,
//    into shared memory as 32 bits a pixel (one shared load a tap in the
//    next pass, not three);
// 4. runs Pillow's horizontal pass once for each row of the strip and
//    column of the tile, kept in shared memory as the rounded uint8
//    intermediate ((ss + (1 << 21)) >> 22, clipped), as Pillow keeps its
//    intermediate image, 32 bits a pixel too;
// 5. runs the vertical pass over that intermediate for the tile's pixels
//    and writes each output row of the tile with 16-byte stores where the
//    row's bytes and address allow (a 32-pixel row is 96 B: six of them).
//
// A warp takes a row at a time (of samples, RGB, the intermediate or the
// output), two in the passes, and its lanes the columns: no index needs a
// division, a lane keeps its column's taps across rows, and a component's
// method and the colour space are decided once a strip, not a pixel.
//
// Arithmetic in 32 bits, and why it is exact: jdcolor.c's products are at
// most FIX(1.772) * 128 = 116130 * 128 < 1.5e7; Pillow's sums are
// (1 << 21) + sum(v * k) with v <= 255 and the bilinear taps k >= 0
// summing to about 1 << 22, so under 1.08e9 < 2^31, and Pillow itself
// sums in int.
//
// Bound, and why no tensor cores: the function's bytes are the plane
// samples the crop's taps reach (a 640x480 4:2:0 image: about 0.28 MB),
// its taps and its output (0.15 MB); its integer operations about 11.7 M
// an image (tools/_compare.py::color_resample_work counts both). Neither a
// tensor core's s8 nor its f16 product can carry a tap of 22 fraction bits
// into Pillow's int32 sums to the bit, so the work stays on the integer
// units, and the design is for the memory system and the instruction
// count: one launch for a chunk of images (a single image's launch is
// mostly fixed cost), each image's plane samples staged once a tile in
// shared memory (cp.async), its RGB computed only inside the rectangles
// the crop reads, the horizontal pass done once a row and column, 16-byte
// stores, and enough blocks (49 an image at COCO's sizes) to fill 132 SMs.
//
// Shared memory a block: at COCO's sizes (640x480 4:2:0 to 224, a 32x32
// tile reading 62x62 input pixels) about 43 KB; the plan shrinks the tile
// (32, 16, ..., 1 pixels a side) until a block needs at most 48 KB, then
// cuts a one-pixel tile's rectangle into strips, so every image the
// decoder accepts fits.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPrecision = 22;
constexpr int kHalfUnit = 1 << (kPrecision - 1);
constexpr int kMaxComponents = 4;
// A block's dynamic shared memory at most: an H100's 232,448 bytes less a
// KiB for the static shared memory below (ops/exact_decode.py SMEM_LIMIT).
constexpr int kMaxDynamic = 232448 - 1024;

// An image's descriptor, int64 fields (ops/exact_decode.py IMAGE_FIELDS).
enum ImageField {
  kOut = 0,   // uint8 [size, size, 3] on the card
  kTaps,      // int32: [size, 2 + kx] columns, then [size, 2 + ky] rows
  kRgb,       // RGB8 [height, width, 3] of a PNG or BMP (ncomp 0)
  kKx, kKy, kSize, kNcomp, kSpace, kWidth, kHeight,
  kPlanes     // then kPlaneFields a component
};
// plane, pitch, real width, real height, expansion across, down, method
constexpr int kPlaneFields = 7;
constexpr int kImageFields = kPlanes + kMaxComponents * kPlaneFields;

// A tile's plan, int32 fields (ops/exact_decode.py TILE_FIELDS).
enum TileField {
  tImage = 0, tOx, tOy, tTw, tTh,  // the image, the output tile
  tX0, tY0, tRw, tRh,              // the input rectangle
  tStrip,                          // its rows coloured at a time
  tWin,       // then 3 a component: first column, width, rows at most
  tOffPlane = tWin + 3 * kMaxComponents,  // a component's window
  tOffUp = tOffPlane + kMaxComponents,    // its upsampled strip (uint8)
  tOffRgb = tOffUp + kMaxComponents,      // a strip's RGB, 32 bits each
  tOffH,      // the horizontal pass: [rh, tw], 32 bits each
  tOffXt,     // the tile's column taps
  tOffYt,     // its row taps
  tOffOut,    // the output tile: [th, tw, 3]
  tEnd,       // the bytes the tile uses
  kTileFields
};
static_assert(kTileFields == 36, "ops/exact_decode.py TILE_FIELDS");
static_assert(kImageFields == 38, "ops/exact_decode.py IMAGE_FIELDS");

// Upsampling methods and colour spaces, as ops/exact_decode.py names them.
enum Method { kFull = 0, kH2V1 = 1, kH1V2 = 2, kH2V2 = 3, kReplicate = 4 };
enum Space { kGrey = 1, kRgbSpace = 2, kYCbCr = 3, kCmyk = 4, kYcck = 5 };

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// jdcolor.c's FIX(x) at SCALEBITS 16.
constexpr int kScaleBits = 16;
constexpr int kHalf = 1 << (kScaleBits - 1);
constexpr int fix(double x) {
  return static_cast<int>(x * (1 << kScaleBits) + 0.5);
}
constexpr int kCrR = fix(1.40200), kCbB = fix(1.77200), kCrG = fix(0.71414),
              kCbG = fix(0.34414);

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// jdcolor.c ycc_rgb_convert before the clamp (32 bits: see the header).
__device__ __forceinline__ void ycc(int y, int cb, int cr, int rgb[3]) {
  const int xb = cb - 128, xr = cr - 128;
  rgb[0] = y + ((kCrR * xr + kHalf) >> kScaleBits);
  rgb[1] = y + ((-kCbG * xb + kHalf - kCrG * xr) >> kScaleBits);
  rgb[2] = y + ((kCbB * xb + kHalf) >> kScaleBits);
}

// Pillow's MULDIV255.
__device__ __forceinline__ int muldiv255(int a, int b) {
  const int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

__device__ __forceinline__ uint32_t pack(int r, int g, int b) {
  return static_cast<uint32_t>(r) | static_cast<uint32_t>(g) << 8 |
         static_cast<uint32_t>(b) << 16;
}

// A pixel's samples -> RGB in 32 bits (R in the low byte).
template <int kSpace>
__device__ __forceinline__ uint32_t to_rgb(int s0, int s1, int s2, int s3) {
  if (kSpace == kGrey) return pack(s0, s0, s0);
  if (kSpace == kRgbSpace) return pack(s0, s1, s2);
  int v[3];
  ycc(s0, s1, s2, v);
  if (kSpace == kYCbCr)
    return pack(clamp255(v[0]), clamp255(v[1]), clamp255(v[2]));
  int c = s0, m = s1, y = s2;
  if (kSpace == kYcck) {
    c = clamp255(255 - v[0]);
    m = clamp255(255 - v[1]);
    y = clamp255(255 - v[2]);
  }
  // "CMYK;I": each sample inverted; then cmyk2rgb.
  const int nk = 255 - (255 - s3);
  return pack(nk - muldiv255(255 - c, nk), nk - muldiv255(255 - m, nk),
              nk - muldiv255(255 - y, nk));
}

__device__ __forceinline__ int clip8(int v) {
  v >>= kPrecision;
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// Byte c of v, zero-extended (one PRMT).
__device__ __forceinline__ int channel(uint32_t v, int c) {
  return static_cast<int>(__byte_perm(v, 0u, 0x4440u + c));
}

// Where a component's samples of the strip lie for the colour conversion:
// row r, column xs of the strip at p[r * stride + xs].
struct Source {
  const uint8_t* p;
  int stride;
};

template <int kSpace>
__device__ __forceinline__ uint32_t convert_at(
    const Source (&s)[kMaxComponents], int r, int xs) {
  const int s0 = s[0].p[r * s[0].stride + xs];
  int s1 = 0, s2 = 0, s3 = 0;
  if (kSpace != kGrey) {
    s1 = s[1].p[r * s[1].stride + xs];
    s2 = s[2].p[r * s[2].stride + xs];
  }
  if (kSpace == kCmyk || kSpace == kYcck) s3 = s[3].p[r * s[3].stride + xs];
  return to_rgb<kSpace>(s0, s1, s2, s3);
}

// The strip's pixels to RGB, a warp two rows at a time (the second read
// even past the strip's end, from the first, so that the two pixels'
// loads are issued together; it is stored only inside the strip).
template <int kSpace>
__device__ __forceinline__ void convert(const Source (&s)[kMaxComponents],
                                        uint32_t* rgb, int n, int rw) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += 2 * kWarps) {
    const bool two = r + kWarps < n;
    const int r1 = two ? r + kWarps : r;
    for (int xs = lane; xs < rw; xs += 32) {
      const uint32_t a = convert_at<kSpace>(s, r, xs);
      const uint32_t b = convert_at<kSpace>(s, r1, xs);
      rgb[r * rw + xs] = a;
      if (two) rgb[r1 * rw + xs] = b;
    }
  }
}

// A subsampled component's strip of samples at the rectangle's columns
// x0 .. x0 + rw - 1 and the strip's rows ys .. ys + n - 1, into up[n, rw]
// (jdsample.c; every sample index clamped to the component's real
// samples, as kernel F clamped), a warp two rows at a time as convert
// takes them, in a loop of its method's own. win: the component's window
// in shared memory, plane rows r0 .., columns c0 .., ww bytes a row; w, h
// its real samples.
struct Window {
  const uint8_t* p;
  int ww, r0, c0, w, h;
  __device__ __forceinline__ const uint8_t* row(int r) const {
    return p + (clampi(r, h - 1) - r0) * ww;
  }
  __device__ __forceinline__ int col(int x) const {
    return clampi(x, w - 1) - c0;
  }
};

// Fancy h2v1: a lane a sample column j, and the output columns 2j and
// 2j + 1 of each of the warp's rows, from samples j - 1, j and j + 1 of
// the row (each index clamped), two rows at a time as convert takes them.
__device__ __forceinline__ void fancy_h2v1(const Window& c, int x0, int rw,
                                           int ys, int n, uint8_t* up) {
  const int lane = threadIdx.x & 31;
  const int ja = x0 >> 1, jb = (x0 + rw - 1) >> 1;
  for (int r = threadIdx.x >> 5; r < n; r += 2 * kWarps) {
    const bool two = r + kWarps < n;
    const int r1 = two ? r + kWarps : r;
    const uint8_t* p0 = c.row(ys + r);
    const uint8_t* p1 = c.row(ys + r1);
    uint8_t* out0 = up + r * rw;
    uint8_t* out1 = up + r1 * rw;
    for (int j = ja + lane; j <= jb; j += 32) {
      const int left = c.col(j - 1), at = c.col(j), right = c.col(j + 1);
      const int s0 = 3 * p0[at], s1 = 3 * p1[at];
      const int x = 2 * j - x0;
      if (x >= 0) {
        out0[x] = static_cast<uint8_t>((s0 + p0[left] + 1) >> 2);
        if (two) out1[x] = static_cast<uint8_t>((s1 + p1[left] + 1) >> 2);
      }
      if (x + 1 < rw) {
        out0[x + 1] = static_cast<uint8_t>((s0 + p0[right] + 2) >> 2);
        if (two)
          out1[x + 1] = static_cast<uint8_t>((s1 + p1[right] + 2) >> 2);
      }
    }
  }
}

// Fancy h2v2 over the strip: a warp a sample row i, nearer to the output
// rows 2i and 2i + 1 (the farther rows i - 1 and i + 1), a lane a sample
// column j and the output columns 2j and 2j + 1, from the column sums of
// columns j - 1, j and j + 1 (each index clamped), the lane's columns
// fixed across its rows.
__device__ __forceinline__ void fancy_h2v2(const Window& c, int x0, int rw,
                                           int ys, int n, uint8_t* up) {
  const int lane = threadIdx.x & 31;
  const int ja = x0 >> 1, jb = (x0 + rw - 1) >> 1;
  const int ia = ys >> 1, ib = (ys + n - 1) >> 1;
  for (int j = ja + lane; j <= jb; j += 32) {
    const int cl = c.col(j - 1), cm = c.col(j), cr = c.col(j + 1);
    const int x = 2 * j - x0;
    for (int i = ia + (threadIdx.x >> 5); i <= ib; i += kWarps) {
      const uint8_t* above = c.row(i - 1);
      const uint8_t* near = c.row(i);
      const uint8_t* below = c.row(i + 1);
      const int ml = 3 * near[cl], mm = 3 * near[cm], mr = 3 * near[cr];
      // Output row 2i (farther row above), then 2i + 1 (below).
      const int sums[2][3] = {
          {ml + above[cl], mm + above[cm], mr + above[cr]},
          {ml + below[cl], mm + below[cm], mr + below[cr]}};
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const int y = 2 * i + odd - ys;
        if (y < 0 || y >= n) continue;
        uint8_t* out = up + y * rw;
        const int* t = sums[odd];
        if (x >= 0) out[x] = static_cast<uint8_t>((3 * t[1] + t[0] + 8) >> 4);
        if (x + 1 < rw)
          out[x + 1] = static_cast<uint8_t>((3 * t[1] + t[2] + 7) >> 4);
      }
    }
  }
}

// Fancy h1v2 (kReplicate false: (3 * nearer + farther + 1 or 2) >> 2 of
// the output's own column) or replication (the sample at y / ve, x / he):
// a lane an output column.
template <bool kReplicate>
__device__ __forceinline__ void by_column(const Window& c, int he, int ve,
                                          int x0, int rw, int ys, int n,
                                          uint8_t* up) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += 2 * kWarps) {
    const bool two = r + kWarps < n;
    const int r1 = two ? r + kWarps : r;
    const int y0 = ys + r, y1 = ys + r1;
    const uint8_t* p0 = c.row(kReplicate ? y0 / ve : y0 >> 1);
    const uint8_t* f0 = c.row((y0 & 1) ? (y0 >> 1) + 1 : (y0 >> 1) - 1);
    const uint8_t* p1 = c.row(kReplicate ? y1 / ve : y1 >> 1);
    const uint8_t* f1 = c.row((y1 & 1) ? (y1 >> 1) + 1 : (y1 >> 1) - 1);
    for (int xs = lane; xs < rw; xs += 32) {
      const int at = c.col(kReplicate ? (x0 + xs) / he : x0 + xs);
      const int u0 = kReplicate ? p0[at]
                                : (3 * p0[at] + f0[at] + 1 + (y0 & 1)) >> 2;
      const int u1 = kReplicate ? p1[at]
                                : (3 * p1[at] + f1[at] + 1 + (y1 & 1)) >> 2;
      up[r * rw + xs] = static_cast<uint8_t>(u0);
      if (two) up[r1 * rw + xs] = static_cast<uint8_t>(u1);
    }
  }
}

__device__ __forceinline__ void upsample(int method, const Window& c,
                                         int he, int ve, int x0, int rw,
                                         int ys, int n, uint8_t* up) {
  switch (method) {
    case kH2V2: fancy_h2v2(c, x0, rw, ys, n, up); break;
    case kH2V1: fancy_h2v1(c, x0, rw, ys, n, up); break;
    case kH1V2: by_column<false>(c, he, ve, x0, rw, ys, n, up); break;
    default: by_column<true>(c, he, ve, x0, rw, ys, n, up);
  }
}

// Pillow's horizontal pass over the strip's rows: row r of the strip and
// column ox of the tile into hpass row r; a lane a column, its taps read
// once for two rows (the second read even past the strip, as convert).
__device__ __forceinline__ void horizontal(const uint32_t* rgb, int rw,
                                           const int* xt, int kx, int x0,
                                           int tw, int n, uint32_t* hpass) {
  const int lane = threadIdx.x & 31;
  for (int ox = lane; ox < tw; ox += 32) {
    const int* t = xt + ox * (2 + kx);
    const int first = t[0] - x0, count = t[1];
    for (int r = threadIdx.x >> 5; r < n; r += 2 * kWarps) {
      const bool two = r + kWarps < n;
      const uint32_t* a = rgb + r * rw + first;
      const uint32_t* b = two ? a + kWarps * rw : a;
      int a0 = kHalfUnit, a1 = kHalfUnit, a2 = kHalfUnit;
      int b0 = kHalfUnit, b1 = kHalfUnit, b2 = kHalfUnit;
      for (int j = 0; j < count; ++j) {
        const int k = t[2 + j];
        const uint32_t va = a[j], vb = b[j];
        a0 += channel(va, 0) * k;
        a1 += channel(va, 1) * k;
        a2 += channel(va, 2) * k;
        b0 += channel(vb, 0) * k;
        b1 += channel(vb, 1) * k;
        b2 += channel(vb, 2) * k;
      }
      hpass[r * tw + ox] = pack(clip8(a0), clip8(a1), clip8(a2));
      if (two)
        hpass[(r + kWarps) * tw + ox] = pack(clip8(b0), clip8(b1), clip8(b2));
    }
  }
}

// The tile's rows of output from shared memory to the image, in units of
// T (16, 4 or 1 bytes) that divide the row and its address.
template <typename T>
__device__ __forceinline__ void store_rows(const uint8_t* src, uint8_t* dst,
                                           int rows, int row_bytes,
                                           int dst_pitch) {
  const int units = row_bytes / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps)
    for (int u = lane; u < units; u += 32)
      reinterpret_cast<T*>(dst + static_cast<size_t>(r) * dst_pitch)[u] =
          reinterpret_cast<const T*>(src + r * row_bytes)[u];
}

__global__ void __launch_bounds__(kThreads)
color_resample_kernel(const long long* __restrict__ images,
                      const int* __restrict__ tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int tile[kTileFields];
  __shared__ long long image[kImageFields];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* plan = tiles + static_cast<size_t>(blockIdx.x) * kTileFields;
  if (tid < kTileFields) tile[tid] = plan[tid];
  if (tid < kImageFields)
    image[tid] = images[static_cast<size_t>(plan[tImage]) * kImageFields +
                        tid];
  __syncthreads();
  const int ox0 = tile[tOx], oy0 = tile[tOy], tw = tile[tTw], th = tile[tTh];
  const int x0 = tile[tX0], y0 = tile[tY0], rw = tile[tRw], rh = tile[tRh];
  const int strip = tile[tStrip];
  const int kx = static_cast<int>(image[kKx]);
  const int ky = static_cast<int>(image[kKy]);
  const int size = static_cast<int>(image[kSize]);
  const int ncomp = static_cast<int>(image[kNcomp]);
  const int space = static_cast<int>(image[kSpace]);
  const int width = static_cast<int>(image[kWidth]);
  const int* xt = reinterpret_cast<const int*>(smem + tile[tOffXt]);
  const int* yt = reinterpret_cast<const int*>(smem + tile[tOffYt]);
  uint32_t* rgb = reinterpret_cast<uint32_t*>(smem + tile[tOffRgb]);
  uint32_t* hpass = reinterpret_cast<uint32_t*>(smem + tile[tOffH]);
  uint8_t* outt = smem + tile[tOffOut];

  // 1. The tile's taps.
  {
    const int* taps = reinterpret_cast<const int*>(image[kTaps]);
    const int xn = tw * (2 + kx), yn = th * (2 + ky);
    const int* xs = taps + static_cast<size_t>(ox0) * (2 + kx);
    const int* ys = taps + static_cast<size_t>(size) * (2 + kx) +
                    static_cast<size_t>(oy0) * (2 + ky);
    for (int i = tid; i < xn; i += kThreads)
      cp_async4(smem + tile[tOffXt] + 4 * i, xs + i);
    for (int i = tid; i < yn; i += kThreads)
      cp_async4(smem + tile[tOffYt] + 4 * i, ys + i);
  }
  for (int ys = y0; ys < y0 + rh; ys += strip) {
    const int n = min(strip, y0 + rh - ys);
    // 2. The strip's samples.
    if (ncomp > 0) {
      for (int k = 0; k < ncomp; ++k) {
        const long long* pf = image + kPlanes + k * kPlaneFields;
        const uint8_t* plane = reinterpret_cast<const uint8_t*>(pf[0]);
        const int pitch = static_cast<int>(pf[1]);
        const int h = static_cast<int>(pf[3]), ve = static_cast<int>(pf[5]);
        const int c0 = tile[tWin + 3 * k], ww = tile[tWin + 3 * k + 1];
        // The plane rows the strip's output rows read, one of halo each
        // side (ops/exact_decode.py::_window bounds them alike).
        const int r0 = max(ys / ve - 1, 0);
        const int rows = min(min((ys + n - 1) / ve + 1, h - 1) - r0 + 1,
                             tile[tWin + 3 * k + 2]);
        uint8_t* dst = smem + tile[tOffPlane + k];
        const uint8_t* src = plane + static_cast<size_t>(r0) * pitch + c0;
        if (((reinterpret_cast<uintptr_t>(src) | pitch | ww) & 15) == 0) {
          const int units = ww >> 4;
          for (int r = warp; r < rows; r += kWarps)
            for (int u = lane; u < units; u += 32)
              cp_async16(dst + r * ww + 16 * u,
                         src + static_cast<size_t>(r) * pitch + 16 * u);
        } else {
          const int units = ww >> 3;
          for (int r = warp; r < rows; r += kWarps)
            for (int u = lane; u < units; u += 32)
              cp_async8(dst + r * ww + 8 * u,
                        src + static_cast<size_t>(r) * pitch + 8 * u);
        }
      }
    } else {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(image[kRgb]);
      for (int r = warp; r < n; r += kWarps)
        for (int x = lane; x < rw; x += 32) {
          const uint8_t* p =
              src + (static_cast<size_t>(ys + r) * width + x0 + x) * 3;
          rgb[r * rw + x] = pack(__ldg(p), __ldg(p + 1), __ldg(p + 2));
        }
    }
    cp_async_wait_all();
    __syncthreads();
    // 3. The strip's RGB: each subsampled component upsampled, then each
    // pixel converted.
    if (ncomp > 0) {
      // Each subsampled component upsampled: one inlined copy of the loops
      // serves every component, which keeps the kernel's code small.
#pragma unroll 1
      for (int k = 0; k < ncomp; ++k) {
        const long long* pf = image + kPlanes + k * kPlaneFields;
        const int method = static_cast<int>(pf[6]);
        const int ve = static_cast<int>(pf[5]);
        if (method == kFull) continue;
        upsample(method,
                 Window{smem + tile[tOffPlane + k], tile[tWin + 3 * k + 1],
                        max(ys / ve - 1, 0), tile[tWin + 3 * k],
                        static_cast<int>(pf[2]), static_cast<int>(pf[3])},
                 static_cast<int>(pf[4]), ve, x0, rw, ys, n,
                 smem + tile[tOffUp + k]);
      }
      // Where the conversion reads each component: a full-size one its own
      // sample in the window (inside the component), a subsampled one its
      // upsampled strip.
      Source src[kMaxComponents];
#pragma unroll
      for (int k = 0; k < kMaxComponents; ++k) {
        const long long* pf = image + kPlanes + k * kPlaneFields;
        const int ww = tile[tWin + 3 * k + 1];
        const int ve = k < ncomp ? static_cast<int>(pf[5]) : 1;
        const uint8_t* win = smem + tile[tOffPlane + k];
        if (k >= ncomp)
          src[k] = Source{win, 0};
        else if (pf[6] == kFull)
          src[k] = Source{win + (ys - max(ys / ve - 1, 0)) * ww +
                              (x0 - tile[tWin + 3 * k]),
                          ww};
        else
          src[k] = Source{smem + tile[tOffUp + k], rw};
      }
      __syncthreads();
      switch (space) {
        case kGrey: convert<kGrey>(src, rgb, n, rw); break;
        case kRgbSpace: convert<kRgbSpace>(src, rgb, n, rw); break;
        case kYCbCr: convert<kYCbCr>(src, rgb, n, rw); break;
        case kCmyk: convert<kCmyk>(src, rgb, n, rw); break;
        default: convert<kYcck>(src, rgb, n, rw);
      }
      __syncthreads();
    }
    // 4. Pillow's horizontal pass over the strip's rows, the tile's columns.
    horizontal(rgb, rw, xt, kx, x0, tw, n, hpass + (ys - y0) * tw);
    __syncthreads();
  }
  // 5. The vertical pass, two output rows a warp at a time, then the
  // tile's rows to the image.
  for (int oy = warp; oy < th; oy += 2 * kWarps) {
    const bool two = oy + kWarps < th;
    const int* ta = yt + oy * (2 + ky);
    const int* tb = ta + kWarps * (2 + ky);
    for (int ox = lane; ox < tw; ox += 32) {
      const uint32_t* ca = hpass + (ta[0] - y0) * tw + ox;
      int a0 = kHalfUnit, a1 = kHalfUnit, a2 = kHalfUnit;
      for (int j = 0; j < ta[1]; ++j) {
        const uint32_t v = ca[j * tw];
        const int k = ta[2 + j];
        a0 += channel(v, 0) * k;
        a1 += channel(v, 1) * k;
        a2 += channel(v, 2) * k;
      }
      int b0 = kHalfUnit, b1 = kHalfUnit, b2 = kHalfUnit;
      if (two) {
        const uint32_t* cb = hpass + (tb[0] - y0) * tw + ox;
        for (int j = 0; j < tb[1]; ++j) {
          const uint32_t v = cb[j * tw];
          const int k = tb[2 + j];
          b0 += channel(v, 0) * k;
          b1 += channel(v, 1) * k;
          b2 += channel(v, 2) * k;
        }
      }
      uint8_t* o = outt + (oy * tw + ox) * 3;
      o[0] = static_cast<uint8_t>(clip8(a0));
      o[1] = static_cast<uint8_t>(clip8(a1));
      o[2] = static_cast<uint8_t>(clip8(a2));
      if (two) {
        o += kWarps * tw * 3;
        o[0] = static_cast<uint8_t>(clip8(b0));
        o[1] = static_cast<uint8_t>(clip8(b1));
        o[2] = static_cast<uint8_t>(clip8(b2));
      }
    }
  }
  __syncthreads();
  uint8_t* dst = reinterpret_cast<uint8_t*>(image[kOut]) +
                 (static_cast<size_t>(oy0) * size + ox0) * 3;
  const int row_bytes = tw * 3, pitch = size * 3;
  const auto aligned = [&](int unit) {
    return (reinterpret_cast<uintptr_t>(dst) | row_bytes | pitch) %
               unit == 0;
  };
  if (aligned(16))
    store_rows<uint4>(outt, dst, th, row_bytes, pitch);
  else if (aligned(4))
    store_rows<uint32_t>(outt, dst, th, row_bytes, pitch);
  else
    store_rows<uint8_t>(outt, dst, th, row_bytes, pitch);
}

}  // namespace

// images: int64 [n, kImageFields] on the card; tiles: int32 [n_tiles,
// kTileFields] on the card (ops/exact_decode.py::tile_plan, an image's
// tiles with its index); smem: the largest tile's bytes (tEnd). One launch
// of n_tiles blocks on the stream. Returns cudaGetLastError().
extern "C" int vqa_color_resample(const void* images, const void* tiles,
                                  int n_tiles, int smem, void* stream) {
  if (n_tiles < 0 || smem < 0 || smem > kMaxDynamic)
    return cudaErrorInvalidValue;
  if (n_tiles == 0) return cudaSuccess;
  // Past 48 KB less the static shared memory (under a KiB), a block's
  // shared memory needs the opt-in; the same value from every caller, so
  // threads do not race.
  if (smem > (47 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        color_resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamic);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  color_resample_kernel<<<n_tiles, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(images), static_cast<const int*>(tiles));
  return static_cast<int>(cudaGetLastError());
}
