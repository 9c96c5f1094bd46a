// Host resize and centre crop of the reference image transform (see
// resample.h).

#include "resample.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

// PIL's triangle-filter taps (BILINEAR: support 1.0 scaled by the
// downscale factor) for one axis.
struct Taps {
  std::vector<int> xmin;  // per output position
  std::vector<int> n;     // taps per output position
  std::vector<std::vector<float>> weights;
};

Taps ComputeTaps(int in_size, int out_size) {
  Taps taps;
  taps.xmin.resize(out_size);
  taps.n.resize(out_size);
  taps.weights.resize(out_size);
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;
  for (int xout = 0; xout < out_size; ++xout) {
    const double center = (xout + 0.5) * scale;
    const int xmin = int(std::max(0.0, std::floor(center - support)));
    const int xmax =
        int(std::min(double(in_size), std::ceil(center + support)));
    const int n = xmax - xmin;
    std::vector<float> w(n);
    double wsum = 0.0;
    for (int j = 0; j < n; ++j) {
      const double dist = std::abs((xmin + j + 0.5 - center) / filterscale);
      const double wj = dist >= 1.0 ? 0.0 : 1.0 - dist;
      w[j] = float(wj);
      wsum += wj;
    }
    for (int j = 0; j < n; ++j) w[j] = float(w[j] / wsum);
    taps.xmin[xout] = xmin;
    taps.n[xout] = n;
    taps.weights[xout] = std::move(w);
  }
  return taps;
}

// [rows x in_w x 3] -> [rows x out_w x 3]
void HorizontalPass(const float* in, float* out, int in_w, int out_w,
                    int rows, const Taps& taps) {
  for (int y = 0; y < rows; ++y) {
    const float* src = in + size_t(y) * in_w * 3;
    float* dst = out + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const float* w = taps.weights[x].data();
      const float* p = src + size_t(taps.xmin[x]) * 3;
      float a0 = 0, a1 = 0, a2 = 0;
      for (int j = 0; j < taps.n[x]; ++j, p += 3) {
        a0 += w[j] * p[0];
        a1 += w[j] * p[1];
        a2 += w[j] * p[2];
      }
      dst[x * 3 + 0] = a0;
      dst[x * 3 + 1] = a1;
      dst[x * 3 + 2] = a2;
    }
  }
}

// [in_h x width x 3] -> [out_h x width x 3]
void VerticalPass(const float* in, float* out, int out_h, int width,
                  const Taps& taps) {
  const size_t row = size_t(width) * 3;
  for (int y = 0; y < out_h; ++y) {
    float* dst = out + size_t(y) * row;
    std::memset(dst, 0, row * sizeof(float));
    for (int j = 0; j < taps.n[y]; ++j) {
      const float w = taps.weights[y][j];
      const float* src = in + size_t(taps.xmin[y] + j) * row;
      for (size_t x = 0; x < row; ++x) dst[x] += w * src[x];
    }
  }
}

}  // namespace

namespace vqa_torch {

bool ResampleCrop(const uint8_t* rgb, int w, int h, int image_size,
                  double central_fraction, uint8_t* out) {
  if (w <= 0 || h <= 0 || image_size <= 0 || !(central_fraction > 0.0) ||
      uint64_t(w) * uint64_t(h) > kMaxPixels)
    return false;
  try {
    // Shorter edge to int(image_size / central_fraction).
    const int target = int(image_size / central_fraction);
    int new_w, new_h;
    if (w <= h) {
      new_w = target;
      new_h = int(double(target) * h / w);
    } else {
      new_h = target;
      new_w = int(double(target) * w / h);
    }
    if (new_w < image_size || new_h < image_size) return false;

    const size_t n = size_t(w) * h * 3;
    std::vector<float> src(n);
    for (size_t i = 0; i < n; ++i) src[i] = rgb[i];

    // Horizontal then vertical pass (PIL's order).
    std::vector<float> tmp(size_t(h) * new_w * 3);
    HorizontalPass(src.data(), tmp.data(), w, new_w, h, ComputeTaps(w, new_w));
    std::vector<float> resized(size_t(new_h) * new_w * 3);
    VerticalPass(tmp.data(), resized.data(), new_h, new_w,
                 ComputeTaps(h, new_h));

    // Centre crop; Python's round() is ties-to-even, as nearbyint is under
    // the default rounding mode.
    const int left = int(std::nearbyint((new_w - image_size) / 2.0));
    const int top = int(std::nearbyint((new_h - image_size) / 2.0));
    for (int y = 0; y < image_size; ++y) {
      const float* row =
          resized.data() + (size_t(top + y) * new_w + left) * 3;
      uint8_t* dst = out + size_t(y) * image_size * 3;
      for (int x = 0; x < image_size * 3; ++x) {
        float v = row[x];
        v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
        dst[x] = uint8_t(std::lround(v));
      }
    }
    return true;
  } catch (...) {
    return false;
  }
}

}  // namespace vqa_torch
