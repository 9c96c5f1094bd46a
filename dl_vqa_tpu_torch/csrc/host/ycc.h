// Planar YCbCr, as a JPEG decoder's inverse DCT leaves it, to RGB8 by the
// arithmetic of libjpeg's decompressor at its defaults (what PIL and
// native/image_pipeline.cc get from libjpeg): subsampled chroma upsampled
// by libjpeg's "fancy" triangle filters (h2v1, h1v2, h2v2; other integral
// ratios by replication, as libjpeg does; replication also where a chroma
// plane is at most 2 samples wide), the rows beyond the image's edges
// replicating its first and last chroma rows; then YCbCr -> RGB by its
// fixed-point tables (jdcolor.c: 16 fraction bits, round half up). The
// nvJPEG decoder (nvjpeg_decode.cc) takes the planes from the card and
// finishes here, so that its pixels differ from libjpeg's by the inverse
// DCT alone.
#ifndef VQA_TORCH_HOST_YCC_H_
#define VQA_TORCH_HOST_YCC_H_

#include <cstdint>

namespace vqa_torch {

// y: [h, w] (pitch w); cb, cr: [ch, cw] (pitch cw), the chroma planes
// subsampled h_expand times across and v_expand times down (cw =
// ceil(w / h_expand), ch = ceil(h / v_expand)); rgb: [h, w, 3]. Returns
// false for expansions it does not take (anything but 1, 2 or 4 across, 1
// or 2 down) or planes too small for them; never throws.
bool YccToRgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int w,
              int h, int cw, int ch, int h_expand, int v_expand,
              uint8_t* rgb);

}  // namespace vqa_torch

#endif  // VQA_TORCH_HOST_YCC_H_
