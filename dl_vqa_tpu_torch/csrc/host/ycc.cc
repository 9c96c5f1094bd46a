// libjpeg's chroma upsampling and YCbCr -> RGB on the host (see ycc.h).

#include "ycc.h"

#include <algorithm>
#include <vector>

namespace {

// Two output rows (v_expand 2) or one from chroma row r and its neighbours
// above and below (the edge rows replicated), into full-height rows of
// width cw * h_expand.

// h2v1: jdsample.c h2v1_fancy_upsample.
void H2V1(const uint8_t* in, int cw, uint8_t* out) {
  int v = in[0];
  out[0] = uint8_t(v);
  out[1] = uint8_t((v * 3 + in[1] + 2) >> 2);
  for (int x = 1; x < cw - 1; ++x) {
    v = in[x] * 3;
    out[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
    out[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
  }
  v = in[cw - 1];
  out[2 * cw - 2] = uint8_t((v * 3 + in[cw - 2] + 1) >> 2);
  out[2 * cw - 1] = uint8_t(v);
}

// h2v2: jdsample.c h2v2_fancy_upsample, one output row from the nearer
// input row (in0) and the farther one (in1); bias 8 then 7 across.
void H2V2Row(const uint8_t* in0, const uint8_t* in1, int cw, uint8_t* out) {
  int this_sum = in0[0] * 3 + in1[0];
  int next_sum = in0[1] * 3 + in1[1];
  out[0] = uint8_t((this_sum * 4 + 8) >> 4);
  out[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int x = 1; x < cw - 1; ++x) {
    next_sum = in0[x + 1] * 3 + in1[x + 1];
    out[2 * x] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * x + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * cw - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * cw - 1] = uint8_t((this_sum * 4 + 7) >> 4);
}

// h1v2: jdsample.c h1v2_fancy_upsample; bias 1 for the upper output row,
// 2 for the lower.
void H1V2Row(const uint8_t* in0, const uint8_t* in1, int cw, int bias,
             uint8_t* out) {
  for (int x = 0; x < cw; ++x)
    out[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
}

// Replication across (int_upsample / h2v1_upsample).
void Replicate(const uint8_t* in, int cw, int h_expand, uint8_t* out) {
  for (int x = 0; x < cw; ++x)
    for (int k = 0; k < h_expand; ++k) out[x * h_expand + k] = in[x];
}

// One chroma plane to [h, cw * h_expand].
void Upsample(const uint8_t* in, int cw, int ch, int h, int h_expand,
              int v_expand, std::vector<uint8_t>* out) {
  const int ow = cw * h_expand;
  out->assign(size_t(ow) * h, 0);
  const bool fancy = cw > 2;
  auto row = [&](int r) { return in + size_t(std::clamp(r, 0, ch - 1)) * cw; };
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = out->data() + size_t(y) * ow;
    const int r = y / v_expand;
    if (v_expand == 1) {
      if (h_expand == 2 && fancy)
        H2V1(row(r), cw, dst);
      else
        Replicate(row(r), cw, h_expand, dst);
    } else if (!fancy || h_expand > 2) {
      Replicate(row(r), cw, h_expand, dst);
    } else {
      const bool upper = y % 2 == 0;
      const uint8_t* far = row(upper ? r - 1 : r + 1);
      if (h_expand == 2)
        H2V2Row(row(r), far, cw, dst);
      else
        H1V2Row(row(r), far, cw, upper ? 1 : 2, dst);
    }
  }
}

// jdcolor.c build_ycc_rgb_table and ycc_rgb_convert.
constexpr int kScaleBits = 16;
constexpr long kOneHalf = 1L << (kScaleBits - 1);
constexpr long Fix(double x) { return long(x * (1L << kScaleBits) + 0.5); }

struct Tables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  Tables() {
    for (int i = 0; i < 256; ++i) {
      const long x = i - 128;
      cr_r[i] = int((Fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = int((Fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -Fix(0.71414) * x;
      cb_g[i] = -Fix(0.34414) * x + kOneHalf;
    }
  }
};

uint8_t Clamp(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

}  // namespace

namespace vqa_torch {

bool YccToRgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int w,
              int h, int cw, int ch, int h_expand, int v_expand,
              uint8_t* rgb) {
  if (w <= 0 || h <= 0 || cw <= 0 || ch <= 0 ||
      !(h_expand == 1 || h_expand == 2 || h_expand == 4) ||
      !(v_expand == 1 || v_expand == 2) || size_t(cw) * h_expand < size_t(w) ||
      size_t(ch) * v_expand < size_t(h))
    return false;
  try {
    static const Tables t;
    std::vector<uint8_t> up_cb, up_cr;
    Upsample(cb, cw, ch, h, h_expand, v_expand, &up_cb);
    Upsample(cr, cw, ch, h, h_expand, v_expand, &up_cr);
    const size_t ow = size_t(cw) * h_expand;
    for (int r = 0; r < h; ++r) {
      const uint8_t* yr = y + size_t(r) * w;
      const uint8_t* br = up_cb.data() + size_t(r) * ow;
      const uint8_t* rr = up_cr.data() + size_t(r) * ow;
      uint8_t* out = rgb + size_t(r) * w * 3;
      for (int x = 0; x < w; ++x) {
        const int yy = yr[x], b = br[x], c = rr[x];
        out[3 * x] = Clamp(yy + t.cr_r[c]);
        out[3 * x + 1] =
            Clamp(yy + int((t.cb_g[b] + t.cr_g[c]) >> kScaleBits));
        out[3 * x + 2] = Clamp(yy + t.cb_b[b]);
      }
    }
    return true;
  } catch (...) {
    return false;
  }
}

}  // namespace vqa_torch
