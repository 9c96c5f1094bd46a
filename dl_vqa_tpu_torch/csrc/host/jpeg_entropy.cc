// The JPEG entropy decoder of the "exact" decoder (see jpeg_entropy.h),
// and its C interface:
//
//   vqa_torch_jpeg_parse(data, len) -> a handle (null only when memory
//     runs out), whatever the bytes hold;
//   vqa_torch_jpeg_status(handle, message, capacity) -> the status code,
//     its message (NUL-terminated) copied into message;
//   vqa_torch_jpeg_header(handle, int32 out[8 + 4 * 8]) -> 0: width,
//     height, components, colour space, max_h, max_v, mcus_x, mcus_y, then
//     for each component h, v, blocks_w, blocks_h, width, height, id, 0;
//   vqa_torch_jpeg_coefficients(handle, c) -> int16 [blocks_h, blocks_w,
//     64] of component c; vqa_torch_jpeg_qtable(handle, c) -> uint16 [64];
//   vqa_torch_jpeg_export(handle, dest, offsets) -> 0: each component c's
//     coefficients copied to dest + offsets[2 c], its table to dest +
//     offsets[2 c + 1] (int64 offsets);
//   vqa_torch_jpeg_free(handle).
//
// The arithmetic follows libjpeg-turbo's jdhuff.c (sequential), jdphuff.c
// (progressive) and jdmarker.c (markers), so that the coefficients are the
// ones libjpeg hands its inverse DCT.

#include "jpeg_entropy.h"

#include <algorithm>
#include <cstdio>
#include <cstring>
#include <new>

#include "resample.h"

namespace vqa_torch {
namespace {

// Zigzag position -> natural position, with 16 extra entries that send a
// corrupt run past the end to the last coefficient (jutils.c).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The tables of the standard's Annex K.3 (libjpeg-turbo's jstdhuff.c),
// which stand in for a table 0 or 1 a file leaves undefined.
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},   // DC luminance
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},   // DC chrominance
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},  // AC lum.
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};  // AC chrom.
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChrom[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// A decoding failure: the status and the message the caller sees.
struct Failure {
  int status;
  std::string message;
};

[[noreturn]] void Fail(int status, const std::string& message) {
  throw Failure{status, message};
}

constexpr int kLookBits = 9;

// A canonical Huffman table (jdhuff.c jpeg_make_d_derived_tbl), with a
// lookup of the codes of up to kLookBits bits.
struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[17];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | value, 0 when longer

  void Build(const uint8_t bits[17], const uint8_t* values, int count,
             bool dc) {
    int code = 0, k = 0;
    std::fill(std::begin(look), std::end(look), 0);
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      k += bits[len];
      code += bits[len];
      // No code may be all ones (jdhuff.c).
      if (code >= (1 << len)) Fail(kJpegCorrupt, "a bad Huffman table");
      maxcode[len] = bits[len] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memcpy(vals, values, count);
    for (int i = 0; dc && i < count; ++i)
      if (vals[i] > 15) Fail(kJpegCorrupt, "a bad Huffman table");
    code = 0;
    k = 0;
    for (int len = 1; len <= kLookBits; ++len, code <<= 1) {
      for (int i = 0; i < bits[len]; ++i, ++code, ++k) {
        const int shift = kLookBits - len;
        for (int j = 0; j < (1 << shift); ++j)
          look[(code << shift) | j] = uint16_t((len << 8) | vals[k]);
      }
    }
    defined = true;
  }
};

// The entropy-coded bytes of a scan, read MSB first: 0xFF 0x00 is a 0xFF
// byte; a marker (or the end of the data) ends the segment, after which
// zero bits stand in (libjpeg's fill_bit_buffer). A scan that consumes one
// of those is truncated.
struct BitReader {
  const uint8_t* data;
  size_t len, pos;
  uint64_t buf = 0;
  int nbits = 0, phantom = 0;
  bool hit_marker = false;

  BitReader(const uint8_t* d, size_t n, size_t p) : data(d), len(n), pos(p) {}

  void Fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!hit_marker) {
        if (pos >= len) {
          hit_marker = true;
        } else if (data[pos] != 0xFF) {
          byte = data[pos++];
        } else {
          size_t q = pos + 1;
          while (q < len && data[q] == 0xFF) ++q;
          if (q < len && data[q] == 0) {
            byte = 0xFF;
            pos = q + 1;
          } else {
            hit_marker = true;  // pos stays on the marker's first 0xFF
          }
        }
      }
      if (hit_marker) phantom += 8;
      buf = (buf << 8) | uint64_t(byte);
      nbits += 8;
    }
  }

  void Consumed() {
    if (nbits < phantom) Fail(kJpegUnsupported, "a truncated scan");
  }

  int Bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) Fill();
    nbits -= n;
    Consumed();
    return int((buf >> nbits) & ((uint64_t(1) << n) - 1));
  }

  int Bit() { return Bits(1); }

  int Decode(const Huffman& t) {
    if (nbits < 16) Fill();
    const int peek = int((buf >> (nbits - kLookBits)) & ((1 << kLookBits) - 1));
    if (t.look[peek]) {
      nbits -= t.look[peek] >> 8;
      Consumed();
      return t.look[peek] & 0xFF;
    }
    int code = 0;
    for (int len = 1; len <= 16; ++len) {
      code = (code << 1) | int((buf >> (nbits - len)) & 1);
      if (code <= t.maxcode[len]) {
        nbits -= len;
        Consumed();
        return t.vals[code + t.valoffset[len]];
      }
    }
    Fail(kJpegCorrupt, "a bad Huffman code");
  }

  // Drops the buffered bits and returns the position of the next marker
  // (skipping stray bytes and fill bytes, as jdmarker.c next_marker), or
  // len when there is none.
  size_t Reset() {
    buf = 0;
    nbits = phantom = 0;
    hit_marker = false;
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && data[pos + 1] != 0 && data[pos + 1] != 0xFF)
        return pos;
      ++pos;
    }
    return pos = len;
  }
};

inline int Extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (-1 << s) + 1 : r;
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t len, JpegImage* out)
      : data_(data), len_(len), img_(out) {}

  void Run() {
    if (len_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8)
      Fail(kJpegNotJpeg, "not a JPEG");
    size_t pos = 2;
    bool eoi = false;
    while (!eoi) {
      const int marker = NextMarker(&pos);
      if (marker < 0) break;  // the data ends without EOI
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2:
          Frame(Segment(&pos), marker == 0xC2);
          break;
        case 0xC3: case 0xC7: case 0xCB: case 0xCF:
          Fail(kJpegUnsupported, "a lossless JPEG (SOF" +
               std::to_string(marker - 0xC0) + ")");
        case 0xC5: case 0xC6: case 0xCD: case 0xCE: case 0xDE: case 0xDF:
          Fail(kJpegUnsupported, "a hierarchical JPEG (" +
               std::string(marker == 0xDE ? "DHP" : marker == 0xDF ? "EXP"
                           : "SOF" + std::to_string(marker - 0xC0)) + ")");
        case 0xC9: case 0xCA:
          Fail(kJpegUnsupported, "an arithmetic-coded JPEG (SOF" +
               std::to_string(marker - 0xC0) + ")");
        case 0xC8:
          Fail(kJpegUnsupported, "a JPEG extension frame (JPG)");
        case 0xC4: Dht(Segment(&pos)); break;
        case 0xDB: Dqt(Segment(&pos)); break;
        case 0xDD: Dri(Segment(&pos)); break;
        case 0xDC:
          Fail(kJpegUnsupported, "a JPEG with a DNL marker");
        case 0xDA: pos = Scan(Segment(&pos)); break;
        case 0xD9: eoi = true; break;
        case 0xE0: case 0xEE: App(marker, Segment(&pos)); break;
        case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4:
        case 0xD5: case 0xD6: case 0xD7:
          break;  // parameterless
        default:
          if ((marker >= 0xE1 && marker <= 0xEF) || marker == 0xFE ||
              marker == 0xCC) {
            Segment(&pos);  // APPn, COM, DAC: skipped
            break;
          }
          Fail(kJpegCorrupt, "an unknown JPEG marker 0xFF" + Hex(marker));
      }
    }
    if (!frame_) Fail(kJpegUnsupported, "a truncated JPEG (no frame)");
    if (scans_ == 0) Fail(kJpegUnsupported, "a truncated JPEG (no scan)");
    if (!eoi && (img_->progressive || scans_ > 1))
      Fail(kJpegUnsupported, "a truncated JPEG (no EOI after its scans)");
    ColorSpace();
    if (img_->progressive) CheckNoSmoothing();
  }

 private:
  struct Seg {
    const uint8_t* p;
    size_t n;
  };

  static std::string Hex(int v) {
    char s[8];
    std::snprintf(s, sizeof(s), "%02X", v & 0xFF);
    return s;
  }

  // The next marker at or after *pos (stray bytes and fill bytes skipped);
  // *pos moves past it. -1 at the end of the data.
  int NextMarker(size_t* pos) {
    size_t p = *pos;
    for (;;) {
      while (p < len_ && data_[p] != 0xFF) ++p;
      while (p < len_ && data_[p] == 0xFF) ++p;
      if (p >= len_) {
        *pos = len_;
        return -1;
      }
      if (data_[p] != 0) {
        *pos = p + 1;
        return data_[p];
      }
      ++p;  // 0xFF 0x00 outside a scan: skipped
    }
  }

  Seg Segment(size_t* pos) {
    if (*pos + 2 > len_) Fail(kJpegUnsupported, "a truncated JPEG header");
    const size_t n = (size_t(data_[*pos]) << 8) | data_[*pos + 1];
    if (n < 2) Fail(kJpegCorrupt, "a bad JPEG marker length");
    if (*pos + n > len_) Fail(kJpegUnsupported, "a truncated JPEG header");
    Seg s{data_ + *pos + 2, n - 2};
    *pos += n;
    return s;
  }

  void App(int marker, Seg s) {
    const size_t n = std::min<size_t>(s.n, 14);  // APPN_DATA_LEN
    if (marker == 0xE0 && n >= 14 && std::memcmp(s.p, "JFIF\0", 5) == 0)
      jfif_ = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(s.p, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = s.p[11];
    }
  }

  void Frame(Seg s, bool progressive) {
    if (frame_) Fail(kJpegCorrupt, "a JPEG with two frames");
    if (s.n < 6) Fail(kJpegCorrupt, "a bad SOF marker");
    if (s.p[0] != 8)
      Fail(kJpegUnsupported, "a " + std::to_string(s.p[0]) +
           "-bit JPEG (8-bit samples only)");
    img_->height = (s.p[1] << 8) | s.p[2];
    img_->width = (s.p[3] << 8) | s.p[4];
    img_->ncomp = s.p[5];
    img_->progressive = progressive;
    if (img_->height == 0)
      Fail(kJpegUnsupported, "a JPEG with a DNL marker (height 0)");
    if (img_->width == 0) Fail(kJpegCorrupt, "an empty JPEG image");
    if (img_->ncomp != 1 && img_->ncomp != 3 && img_->ncomp != 4)
      Fail(kJpegUnsupported, "a JPEG of " + std::to_string(img_->ncomp) +
           " components (PIL opens 1, 3 or 4)");
    if (s.n != size_t(6 + 3 * img_->ncomp))
      Fail(kJpegCorrupt, "a bad SOF marker length");
    if (uint64_t(img_->width) * uint64_t(img_->height) > kMaxPixels)
      Fail(kJpegUnsupported, "more pixels than the decoders' cap");
    for (int c = 0; c < img_->ncomp; ++c) {
      JpegComponent& k = img_->comp[c];
      k.id = s.p[6 + 3 * c];
      k.h = s.p[7 + 3 * c] >> 4;
      k.v = s.p[7 + 3 * c] & 15;
      k.tq = s.p[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        Fail(kJpegCorrupt, "bad JPEG sampling factors");
      img_->max_h = std::max(img_->max_h, k.h);
      img_->max_v = std::max(img_->max_v, k.v);
      std::fill(std::begin(k.coef_bits), std::end(k.coef_bits), -1);
    }
    img_->mcus_x = (img_->width + 8 * img_->max_h - 1) / (8 * img_->max_h);
    img_->mcus_y = (img_->height + 8 * img_->max_v - 1) / (8 * img_->max_v);
    for (int c = 0; c < img_->ncomp; ++c) {
      JpegComponent& k = img_->comp[c];
      if (img_->max_h % k.h || img_->max_v % k.v)
        Fail(kJpegUnsupported, "JPEG sampling factors whose ratios are not "
             "integral");
      k.width = int((int64_t(img_->width) * k.h + img_->max_h - 1) /
                    img_->max_h);
      k.height = int((int64_t(img_->height) * k.v + img_->max_v - 1) /
                     img_->max_v);
      k.blocks_w = img_->mcus_x * k.h;
      k.blocks_h = img_->mcus_y * k.v;
      k.coef.assign(size_t(k.blocks_w) * k.blocks_h * 64, 0);
    }
    frame_ = true;
  }

  void Dqt(Seg s) {
    size_t i = 0;
    while (i < s.n) {
      const int pq = s.p[i] >> 4, tq = s.p[i] & 15;
      if (pq > 1 || tq > 3) Fail(kJpegCorrupt, "a bad DQT marker");
      const size_t need = 1 + 64 * size_t(pq + 1);
      if (i + need > s.n) Fail(kJpegCorrupt, "a bad DQT marker length");
      for (int k = 0; k < 64; ++k)
        qt_[tq][kNatural[k]] = uint16_t(
            pq ? (s.p[i + 1 + 2 * k] << 8) | s.p[i + 2 + 2 * k]
               : s.p[i + 1 + k]);
      qt_defined_[tq] = true;
      i += need;
    }
  }

  void Dht(Seg s) {
    size_t i = 0;
    while (i < s.n) {
      if (i + 17 > s.n) Fail(kJpegCorrupt, "a bad DHT marker length");
      const int tc = s.p[i] >> 4, th = s.p[i] & 15;
      if (tc > 1 || th > 3) Fail(kJpegCorrupt, "a bad DHT marker");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int k = 1; k <= 16; ++k) count += bits[k] = s.p[i + k];
      if (count > 256 || i + 17 + count > s.n)
        Fail(kJpegCorrupt, "a bad DHT marker length");
      huff_[tc][th].Build(bits, s.p + i + 17, count, tc == 0);
      i += 17 + count;
    }
  }

  void Dri(Seg s) {
    if (s.n != 2) Fail(kJpegCorrupt, "a bad DRI marker length");
    restart_interval_ = (s.p[0] << 8) | s.p[1];
  }

  const Huffman& Table(int tc, int th) {
    Huffman& t = huff_[tc][th];
    if (!t.defined && th < 2) {  // std_huff_tables
      if (tc == 0)
        t.Build(kStdBits[th], kStdDcVals, 12, true);
      else
        t.Build(kStdBits[2 + th], th ? kStdAcChrom : kStdAcLum, 162, false);
    }
    if (!t.defined) Fail(kJpegCorrupt, "a scan uses an undefined Huffman "
                         "table");
    return t;
  }

  // One scan: its header `s`, then its entropy-coded data from the end of
  // the header. Returns the position of the marker that ends it.
  size_t Scan(Seg s) {
    if (!frame_) Fail(kJpegCorrupt, "a scan before the frame");
    if (s.n < 1) Fail(kJpegCorrupt, "a bad SOS marker");
    const int ns = s.p[0];
    if (ns < 1 || ns > 4 || s.n != size_t(4 + 2 * ns))
      Fail(kJpegCorrupt, "a bad SOS marker length");
    int comps[4], dc[4], ac[4];
    for (int i = 0; i < ns; ++i) {
      const int id = s.p[1 + 2 * i];
      comps[i] = -1;
      for (int c = 0; c < img_->ncomp; ++c)
        if (img_->comp[c].id == id) comps[i] = c;
      for (int j = 0; j < i; ++j)
        if (comps[j] == comps[i]) comps[i] = -1;
      if (comps[i] < 0) Fail(kJpegCorrupt, "a bad component id in a scan");
      dc[i] = s.p[2 + 2 * i] >> 4;
      ac[i] = s.p[2 + 2 * i] & 15;
      if (dc[i] > 3 || ac[i] > 3) Fail(kJpegCorrupt, "a bad SOS marker");
    }
    const int ss = s.p[1 + 2 * ns], se = s.p[2 + 2 * ns];
    const int ah = s.p[3 + 2 * ns] >> 4, al = s.p[3 + 2 * ns] & 15;
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i)
        blocks += img_->comp[comps[i]].h * img_->comp[comps[i]].v;
      if (blocks > 10) Fail(kJpegCorrupt, "a bad JPEG MCU size");
    }
    for (int i = 0; i < ns; ++i) {  // jdinput.c latch_quant_tables
      JpegComponent& k = img_->comp[comps[i]];
      if (k.latched) continue;
      if (!qt_defined_[k.tq])
        Fail(kJpegCorrupt, "a component with no quantization table");
      std::memcpy(k.qtable, qt_[k.tq], sizeof(k.qtable));
      k.latched = true;
    }
    if (img_->progressive) {
      const bool dc_band = ss == 0;
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) Fail(kJpegCorrupt, "a bad progressive scan");
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k)
          img_->comp[comps[i]].coef_bits[k] = al;
    }
    // The tables the scan uses, made before any data is read.
    const Huffman* dct[4] = {};
    const Huffman* act[4] = {};
    for (int i = 0; i < ns; ++i) {
      if (!img_->progressive || (ss == 0 && ah == 0)) dct[i] = &Table(0, dc[i]);
      if (!img_->progressive || ss > 0) act[i] = &Table(1, ac[i]);
    }

    BitReader br(data_, len_, size_t(s.p + s.n - data_));
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    // The blocks of the scan, MCU by MCU.
    const bool single = ns == 1;
    const JpegComponent& k0 = img_->comp[comps[0]];
    const int mcus_x = single ? (k0.width + 7) / 8 : img_->mcus_x;
    const int mcus_y = single ? (k0.height + 7) / 8 : img_->mcus_y;
    int restarts_to_go = restart_interval_, next_rst = 0;
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval_) {
          if (restarts_to_go == 0) {
            const size_t at = br.Reset();
            if (at + 1 >= len_ || data_[at + 1] != 0xD0 + next_rst)
              Fail(kJpegCorrupt, "a missing or misplaced restart marker");
            br.pos = at + 2;
            next_rst = (next_rst + 1) & 7;
            std::fill(pred, pred + 4, 0);
            eobrun = 0;
            restarts_to_go = restart_interval_;
          }
          --restarts_to_go;
        }
        for (int i = 0; i < ns; ++i) {
          JpegComponent& k = img_->comp[comps[i]];
          const int bh = single ? 1 : k.h, bv = single ? 1 : k.v;
          for (int by = 0; by < bv; ++by) {
            for (int bx = 0; bx < bh; ++bx) {
              const int row = my * bv + by, col = mx * bh + bx;
              int16_t* block =
                  k.coef.data() + (size_t(row) * k.blocks_w + col) * 64;
              if (!img_->progressive) {
                Sequential(&br, *dct[i], *act[i], &pred[i], block);
              } else if (ss == 0) {
                if (ah == 0) {
                  const int t = br.Decode(*dct[i]);
                  const int diff = t ? Extend(br.Bits(t), t) : 0;
                  pred[i] += diff;
                  block[0] = int16_t(unsigned(pred[i]) << al);
                } else if (br.Bit()) {
                  block[0] = int16_t(block[0] | (1 << al));
                }
              } else if (ah == 0) {
                AcFirst(&br, *act[i], ss, se, al, &eobrun, block);
              } else {
                AcRefine(&br, *act[i], ss, se, al, &eobrun, block);
              }
            }
          }
        }
      }
    }
    ++scans_;
    return br.Reset();
  }

  static void Sequential(BitReader* br, const Huffman& dc, const Huffman& ac,
                         int* pred, int16_t* block) {
    const int t = br->Decode(dc);
    const int diff = t ? Extend(br->Bits(t), t) : 0;
    *pred += diff;
    block[0] = int16_t(*pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = br->Decode(ac);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = int16_t(Extend(br->Bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void AcFirst(BitReader* br, const Huffman& ac, int ss, int se,
                      int al, int* eobrun, int16_t* block) {
    if (*eobrun > 0) {
      --*eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = br->Decode(ac);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = int16_t(unsigned(Extend(br->Bits(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br->Bits(r);
        --*eobrun;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine.
  static void AcRefine(BitReader* br, const Huffman& ac, int ss, int se,
                       int al, int* eobrun, int16_t* block) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (br->Bit() && (*coef & p1) == 0)
        *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    if (*eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br->Decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br->Bit() ? p1 : m1;  // a size other than 1 is corrupt
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br->Bits(r);
          break;
        }
        do {
          int16_t* coef = block + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) block[kNatural[k]] = int16_t(s);
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --*eobrun;
    }
  }

  // jdapimin.c default_decompress_parms.
  void ColorSpace() {
    const JpegComponent* c = img_->comp;
    switch (img_->ncomp) {
      case 1:
        img_->color_space = kGrey;
        break;
      case 3:
        if (jfif_)
          img_->color_space = kYCbCr;
        else if (adobe_)
          img_->color_space = adobe_transform_ == 0 ? kRgb : kYCbCr;
        else if (c[0].id == 82 && c[1].id == 71 && c[2].id == 66)
          img_->color_space = kRgb;
        else
          img_->color_space = kYCbCr;
        break;
      default:
        img_->color_space =
            adobe_ ? (adobe_transform_ == 0 ? kCmyk : kYcck) : kCmyk;
    }
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths a progressive image's blocks
  // where one of the first ten coefficients (zigzag order) was left
  // unfinished, if every component's DC and quantization values allow it.
  void CheckNoSmoothing() {
    static const int kFirst[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int c = 0; c < img_->ncomp; ++c) {
      const JpegComponent& k = img_->comp[c];
      if (!k.latched) return;
      for (int i = 0; i < 10; ++i)
        if (k.qtable[kFirst[i]] == 0) return;
      if (k.coef_bits[0] < 0) return;
      for (int i = 1; i < 10; ++i)
        if (k.coef_bits[i] != 0) useful = true;
    }
    if (useful)
      Fail(kJpegUnsupported, "a progressive JPEG whose scans leave a low "
           "coefficient unfinished (libjpeg smooths its blocks)");
  }

  const uint8_t* data_;
  size_t len_;
  JpegImage* img_;
  bool frame_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0, scans_ = 0;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman huff_[2][4];
};

}  // namespace

void DecodeJpegEntropy(const uint8_t* data, size_t len, JpegImage* image) {
  try {
    Decoder(data, len, image).Run();
  } catch (const Failure& f) {
    image->status = f.status;
    image->message = f.message;
  } catch (const std::bad_alloc&) {
    image->status = kJpegUnsupported;
    image->message = "an image too large to hold";
  }
  if (image->status != kJpegOk)
    for (auto& c : image->comp) std::vector<int16_t>().swap(c.coef);
}

}  // namespace vqa_torch

extern "C" {

void* vqa_torch_jpeg_parse(const uint8_t* data, size_t len) {
  auto* image = new (std::nothrow) vqa_torch::JpegImage;
  if (image) vqa_torch::DecodeJpegEntropy(data, len, image);
  return image;
}

int vqa_torch_jpeg_status(void* handle, char* message, int capacity) {
  const auto* image = static_cast<const vqa_torch::JpegImage*>(handle);
  if (capacity > 0) {
    const size_t n = std::min(image->message.size(), size_t(capacity - 1));
    std::memcpy(message, image->message.data(), n);
    message[n] = '\0';
  }
  return image->status;
}

int vqa_torch_jpeg_header(void* handle, int32_t* out) {
  const auto* image = static_cast<const vqa_torch::JpegImage*>(handle);
  const int32_t head[8] = {image->width, image->height, image->ncomp,
                           image->color_space, image->max_h, image->max_v,
                           image->mcus_x, image->mcus_y};
  std::memcpy(out, head, sizeof(head));
  for (int c = 0; c < 4; ++c) {
    const auto& k = image->comp[c];
    const int32_t row[8] = {k.h, k.v, k.blocks_w, k.blocks_h,
                            k.width, k.height, k.id, 0};
    std::memcpy(out + 8 + 8 * c, row, sizeof(row));
  }
  return 0;
}

const int16_t* vqa_torch_jpeg_coefficients(void* handle, int c) {
  return static_cast<const vqa_torch::JpegImage*>(handle)->comp[c].coef.data();
}

const uint16_t* vqa_torch_jpeg_qtable(void* handle, int c) {
  return static_cast<const vqa_torch::JpegImage*>(handle)->comp[c].qtable;
}

int vqa_torch_jpeg_export(void* handle, uint8_t* dest,
                          const int64_t* offsets) {
  const auto* image = static_cast<const vqa_torch::JpegImage*>(handle);
  for (int c = 0; c < image->ncomp; ++c) {
    const auto& k = image->comp[c];
    std::memcpy(dest + offsets[2 * c], k.coef.data(),
                k.coef.size() * sizeof(int16_t));
    std::memcpy(dest + offsets[2 * c + 1], k.qtable, sizeof(k.qtable));
  }
  return 0;
}

void vqa_torch_jpeg_free(void* handle) {
  delete static_cast<vqa_torch::JpegImage*>(handle);
}

}  // extern "C"
