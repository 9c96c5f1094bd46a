// The port's C interface to the host JPEG decoder of native/ (libjpeg, then
// PIL's bilinear resize of the shorter edge and the centre crop:
// vqa::TransformMem of native/transform.h, within one uint8 level of PIL).
// Linked with native/image_pipeline.cc, which is compiled unchanged.
//
//   vqa_torch_decode_jpeg(data, len, image_size, central_fraction, out)
//     -> 0 ok, 1 decode failed (corrupt, truncated, or more pixels than
//        the cap), 2 not a JPEG

#include <cstddef>
#include <cstdint>

#include "transform.h"

extern "C" {

int vqa_torch_decode_jpeg(const uint8_t* data, size_t len, int image_size,
                          double central_fraction, uint8_t* out) {
  if (len < 3 || data[0] != 0xFF || data[1] != 0xD8) return 2;
  try {
    return vqa::TransformMem(data, len, image_size, central_fraction, out)
               ? 0
               : 1;
  } catch (...) {  // an image too large to hold
    return 1;
  }
}

}  // extern "C"
