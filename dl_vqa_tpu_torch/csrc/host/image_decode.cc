// The port's host JPEG decoder: libjpeg, then PIL's bilinear resize of the
// shorter edge and the centre crop (resample.h, the arithmetic of
// native/image_pipeline.cc, so an RGB or greyscale JPEG gives that file's
// bits, within one uint8 level of PIL). Unlike native/, it also decodes
// four-component JPEGs as PIL does:
//
// * libjpeg is asked for JCS_CMYK (it converts YCCK to CMYK itself);
// * the samples are taken inverted, as PIL's "CMYK;I" raw mode takes every
//   CMYK JPEG (Adobe's convention, which Photoshop and libjpeg write with
//   their Adobe marker);
// * CMYK -> RGB by Pillow's cmyk2rgb: nk = 255 - k, r = nk - c * nk / 255
//   rounded by its MULDIV255 (and g, b alike), which is Pillow's
//   convert("RGB") to the bit.
//
//   vqa_torch_decode_jpeg(data, len, image_size, central_fraction, out)
//     -> 0 ok, 1 decode failed (corrupt, truncated, or more pixels than
//        the cap), 2 not a JPEG
//   vqa_torch_decode_files(paths, n, image_size, central_fraction, out,
//                          n_threads, status)
//     -> the number of files that failed; status[i] is the code above for
//        file i, or 3 where it cannot be read. The files are read and
//        decoded on n_threads host threads, each file into its slot of out
//        (n * image_size * image_size * 3 bytes; a failed slot is zeroed).

#include <cstddef>
#include <cstdint>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstring>
#include <thread>
#include <vector>

#include "resample.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void ErrorExit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrorMgr*>(cinfo->err)->jump, 1);
}

// Pillow's MULDIV255: a * b / 255, rounded.
inline int MulDiv255(int a, int b) {
  const int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// Inverted CMYK samples (PIL's "CMYK;I") -> RGB, as Pillow's cmyk2rgb.
void CmykToRgb(const uint8_t* cmyk, size_t pixels, uint8_t* rgb) {
  for (size_t i = 0; i < pixels; ++i, cmyk += 4, rgb += 3) {
    const int nk = cmyk[3];  // 255 - (255 - raw k)
    for (int c = 0; c < 3; ++c)
      rgb[c] = uint8_t(nk - MulDiv255(255 - cmyk[c], nk));
  }
}

// JPEG bytes -> RGB8 [h, w, 3]. Returns false on any libjpeg error, a
// colour space it does not convert, or more pixels than the cap.
bool DecodeRgb(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
               int* width, int* height) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = ErrorExit;
  // Declared before setjmp, so that a longjmp leaves them intact.
  std::vector<uint8_t> cmyk;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  const bool four = cinfo.jpeg_color_space == JCS_CMYK ||
                    cinfo.jpeg_color_space == JCS_YCCK;
  cinfo.out_color_space = four ? JCS_CMYK : JCS_RGB;
  if (uint64_t(cinfo.image_width) * cinfo.image_height >
      vqa_torch::kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  const int comps = cinfo.output_components;
  if (comps != (four ? 4 : 3)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  std::vector<uint8_t>* dst = four ? &cmyk : rgb;
  dst->resize(size_t(w) * h * comps);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = dst->data() + size_t(cinfo.output_scanline) * w * comps;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (four) {
    rgb->resize(size_t(w) * h * 3);
    CmykToRgb(cmyk.data(), size_t(w) * h, rgb->data());
  }
  *width = w;
  *height = h;
  return true;
}

int Transform(const uint8_t* data, size_t len, int image_size,
              double central_fraction, uint8_t* out) {
  if (len < 3 || data[0] != 0xFF || data[1] != 0xD8) return 2;
  try {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    if (!DecodeRgb(data, len, &rgb, &w, &h)) return 1;
    return vqa_torch::ResampleCrop(rgb.data(), w, h, image_size,
                                   central_fraction, out)
               ? 0
               : 1;
  } catch (...) {  // an image too large to hold
    return 1;
  }
}

bool ReadFile(const char* path, std::vector<uint8_t>* bytes) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  bool ok = std::fseek(fp, 0, SEEK_END) == 0;
  const long size = ok ? std::ftell(fp) : -1;
  ok = size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0;
  if (ok) {
    try {
      bytes->resize(size_t(size));
      ok = std::fread(bytes->data(), 1, bytes->size(), fp) == bytes->size();
    } catch (...) {
      ok = false;
    }
  }
  std::fclose(fp);
  return ok;
}

}  // namespace

extern "C" {

int vqa_torch_decode_jpeg(const uint8_t* data, size_t len, int image_size,
                          double central_fraction, uint8_t* out) {
  return Transform(data, len, image_size, central_fraction, out);
}

int vqa_torch_decode_files(const char** paths, int n, int image_size,
                           double central_fraction, uint8_t* out,
                           int n_threads, uint8_t* status) {
  const size_t image_bytes = size_t(image_size) * image_size * 3;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    std::vector<uint8_t> bytes;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* dst = out + size_t(i) * image_bytes;
      const int code =
          ReadFile(paths[i], &bytes)
              ? Transform(bytes.data(), bytes.size(), image_size,
                          central_fraction, dst)
              : 3;
      if (code != 0) {
        std::memset(dst, 0, image_bytes);
        failures.fetch_add(1);
      }
      status[i] = uint8_t(code);
    }
  };
  const int threads = std::max(1, std::min(n_threads, n));
  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return failures.load();
}

}  // extern "C"
