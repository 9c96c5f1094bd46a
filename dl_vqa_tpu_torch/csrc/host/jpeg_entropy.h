// The JPEG entropy decoder of the "exact" decoder (data/images.py): the
// markers and Huffman-coded scans of a JPEG read on the host, without
// libjpeg, into each component's quantized DCT coefficients, as libjpeg's
// decompressor holds them before its inverse DCT. The inverse DCT, the
// chroma upsampling, the colour conversion and PIL's resize run after it,
// on the card (kernels E, F and G, ops/exact_decode.py) or in their plain
// PyTorch versions on the host.
//
// Taken: SOF0, SOF1 and SOF2 at 8 bits; baseline and extended-sequential
// scans (interleaved or one component a scan); progressive scans (DC first
// and refine, AC first and refine with EOB runs and correction bits);
// restart intervals; DQT of 8- and 16-bit tables; DHT (the standard
// tables stand in for a missing table 0 or 1, as libjpeg-turbo's
// std_huff_tables); the colour space that libjpeg infers from the JFIF
// and Adobe markers and the component ids (jdapimin.c
// default_decompress_parms). Refused, naming what: arithmetic coding,
// lossless and hierarchical frames (SOF3, SOF5-SOF15), 12-bit samples, DNL,
// a truncated scan, sampling factors whose ratios are not integral, more
// than kMaxPixels pixels, a component count PIL does not open (2, or more
// than 4), and a progressive file whose scans leave one of the first ten
// coefficients unfinished (libjpeg then smooths the blocks, jdcoefct.c
// decompress_smooth_data).
#ifndef VQA_TORCH_HOST_JPEG_ENTROPY_H_
#define VQA_TORCH_HOST_JPEG_ENTROPY_H_

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace vqa_torch {

// libjpeg's J_COLOR_SPACE values.
enum JpegColorSpace { kGrey = 1, kRgb = 2, kYCbCr = 3, kCmyk = 4, kYcck = 5 };

// Status codes, shared with data/image_formats.py.
enum JpegStatus {
  kJpegOk = 0,
  kJpegCorrupt = 1,      // a fault in the file's structure or its codes
  kJpegNotJpeg = 2,      // no SOI marker at the start
  kJpegUnsupported = 4,  // a variant the decoder refuses (see above)
};

struct JpegComponent {
  int id = 0, h = 1, v = 1, tq = 0;
  int blocks_w = 0, blocks_h = 0;  // padded to whole MCUs
  int width = 0, height = 0;       // libjpeg's downsampled_width, _height
  std::vector<int16_t> coef;       // [blocks_h, blocks_w, 64], natural order
  uint16_t qtable[64] = {};        // latched at its first scan, natural order
  bool latched = false;
  int coef_bits[64];               // progressive: -1 unseen, else last Al
};

struct JpegImage {
  int status = kJpegOk;
  std::string message;
  int width = 0, height = 0, ncomp = 0, color_space = 0;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  bool progressive = false;
  JpegComponent comp[4];
};

// Decodes `len` bytes; on failure `image->status` and `image->message` say
// why. Never throws.
void DecodeJpegEntropy(const uint8_t* data, size_t len, JpegImage* image);

}  // namespace vqa_torch

#endif  // VQA_TORCH_HOST_JPEG_ENTROPY_H_
