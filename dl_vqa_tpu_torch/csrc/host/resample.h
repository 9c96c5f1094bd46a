// The resize and centre crop of the reference image transform, on the host:
// decoded RGB8 [h, w, 3] -> PIL's bilinear (triangle-filter) resize of the
// shorter edge to int(image_size / central_fraction) -> centre crop ->
// uint8 [image_size, image_size, 3]. The port's copy of the arithmetic of
// native/image_pipeline.cc (ComputeTaps, HorizontalPass, VerticalPass,
// ResampleCropTail), the same float operations in the same order, so that
// the two give the same bits on the same RGB; the nvJPEG decoder
// (nvjpeg_decode.cc) runs it after the card decodes, and it needs no libjpeg.
#ifndef VQA_TORCH_HOST_RESAMPLE_H_
#define VQA_TORCH_HOST_RESAMPLE_H_

#include <cstddef>
#include <cstdint>

namespace vqa_torch {

// Largest image the decoders accept, in pixels: native/image_pipeline.cc's
// cap, PIL's DecompressionBombError threshold (2 * MAX_IMAGE_PIXELS).
constexpr uint64_t kMaxPixels = 178956970;

// Returns false on an allocation failure or a size it cannot crop; never
// throws.
bool ResampleCrop(const uint8_t* rgb, int w, int h, int image_size,
                  double central_fraction, uint8_t* out);

}  // namespace vqa_torch

#endif  // VQA_TORCH_HOST_RESAMPLE_H_
