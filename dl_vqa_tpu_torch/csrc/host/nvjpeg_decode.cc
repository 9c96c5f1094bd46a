// JPEG decode on the card with nvJPEG, then the rest of libjpeg's
// decompression and the reference resize and centre crop on the host: the
// Python front's decoder where the host has no libjpeg. Host C++, built
// with g++ against the CUDA toolkit's nvjpeg.h and cuda_runtime.h.
//
// nvJPEG decodes the entropy-coded data and runs the inverse DCT into a
// device buffer as planes (Y, then Cb and Cr at their subsampled size; a
// greyscale image as Y alone), one copy brings them back, and the host
// upsamples the chroma and converts to RGB as libjpeg does (ycc.h;
// nvJPEG's own RGB output upsamples chroma otherwise and moves pixels at
// hard colour edges by tens of levels), then resamples (resample.h). What
// remains different from libjpeg's pixels is nvJPEG's inverse DCT: a level
// or two an element (the tolerance is stated where the fixtures are
// checked, chip_smoke.py::TOL).
//
// Concurrency: one nvJPEG handle for the process; a pool of decoder slots
// (a JPEG state, a non-blocking stream, a device buffer), one taken by each
// call for its duration, so handler threads decode at once and no call
// waits for the model's work on the legacy default stream. Slots are kept
// for the life of the process. Device memory, the slots' buffers and
// nvJPEG's own, comes from one memory pool of the decoder's in stream
// order (cudaMallocFromPoolAsync, cudaFreeAsync on the slot's stream; the
// pool keeps what is freed), so a buffer that grows never synchronises the
// card as cudaMalloc and cudaFree would; a slot's buffer grows to the next
// power of two. nvJPEG's page-locked staging buffers are allocated and
// freed with cudaHostAlloc and cudaFreeHost, which do synchronise: that
// happens the first times a slot's state meets a larger image than it has
// held.
//
//   vqa_torch_nvjpeg_decode(data, len, image_size, central_fraction, device,
//                           out)
//     -> 0 ok, 1 decode failed (corrupt, truncated, an unsupported layout,
//        or more pixels than the cap), 2 not a JPEG, -1 a CUDA or nvJPEG
//        error (vqa_torch_nvjpeg_last_error says which)
//   vqa_torch_nvjpeg_last_error() -> the calling thread's last error text

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "resample.h"
#include "ycc.h"

namespace {

thread_local std::string t_error;

int Fail(const char* what, int code) {
  char buf[160];
  std::snprintf(buf, sizeof(buf), "%s failed (%d)", what, code);
  t_error = buf;
  return -1;
}

struct Slot {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t cap = 0;
  std::vector<uint8_t> host;
  std::vector<uint8_t> rgb;
};

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  cudaMemPool_t pool = nullptr;
  int device = -1;
  std::mutex mu;
  std::vector<Slot*> idle;
};

std::mutex g_mu;
Decoder* g_decoder = nullptr;  // lives for the process

// nvJPEG's allocators; ctx is the decoder's memory pool.
int DevMalloc(void* ctx, void** ptr, size_t size, cudaStream_t stream) {
  return int(cudaMallocFromPoolAsync(ptr, size,
                                     static_cast<cudaMemPool_t>(ctx),
                                     stream));
}

int DevFree(void*, void* ptr, size_t, cudaStream_t stream) {
  return int(cudaFreeAsync(ptr, stream));
}

int PinnedMalloc(void*, void** ptr, size_t size, cudaStream_t) {
  return int(cudaHostAlloc(ptr, size, cudaHostAllocDefault));
}

int PinnedFree(void*, void* ptr, size_t, cudaStream_t) {
  return int(cudaFreeHost(ptr));
}

Decoder* GetDecoder(int device, int* code) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_decoder) {
    if (g_decoder->device != device) {
      t_error = "the nvJPEG decoder serves one device a process";
      *code = -1;
      return nullptr;
    }
    return g_decoder;
  }
  cudaError_t ce = cudaSetDevice(device);
  if (ce != cudaSuccess) {
    *code = Fail("cudaSetDevice", int(ce));
    return nullptr;
  }
  auto* d = new Decoder();
  cudaMemPoolProps props;
  std::memset(&props, 0, sizeof(props));
  props.allocType = cudaMemAllocationTypePinned;
  props.location.type = cudaMemLocationTypeDevice;
  props.location.id = device;
  ce = cudaMemPoolCreate(&d->pool, &props);
  uint64_t keep = UINT64_MAX;  // never hand freed memory back
  if (ce == cudaSuccess)
    ce = cudaMemPoolSetAttribute(d->pool, cudaMemPoolAttrReleaseThreshold,
                                 &keep);
  if (ce != cudaSuccess) {
    if (d->pool) cudaMemPoolDestroy(d->pool);
    delete d;
    *code = Fail("cudaMemPoolCreate", int(ce));
    return nullptr;
  }
  nvjpegDevAllocatorV2_t dev = {DevMalloc, DevFree, d->pool};
  nvjpegPinnedAllocatorV2_t pinned = {PinnedMalloc, PinnedFree, nullptr};
  nvjpegStatus_t st = nvjpegCreateExV2(NVJPEG_BACKEND_DEFAULT, &dev, &pinned,
                                       0, &d->handle);
  if (st != NVJPEG_STATUS_SUCCESS) {
    cudaMemPoolDestroy(d->pool);
    delete d;
    *code = Fail("nvjpegCreateExV2", int(st));
    return nullptr;
  }
  d->device = device;
  g_decoder = d;
  return d;
}

Slot* Acquire(Decoder* d, int* code) {
  {
    std::lock_guard<std::mutex> lk(d->mu);
    if (!d->idle.empty()) {
      Slot* s = d->idle.back();
      d->idle.pop_back();
      return s;
    }
  }
  auto* s = new Slot();
  nvjpegStatus_t st = nvjpegJpegStateCreate(d->handle, &s->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    delete s;
    *code = Fail("nvjpegJpegStateCreate", int(st));
    return nullptr;
  }
  cudaError_t ce = cudaStreamCreateWithFlags(&s->stream,
                                             cudaStreamNonBlocking);
  if (ce != cudaSuccess) {
    nvjpegJpegStateDestroy(s->state);
    delete s;
    *code = Fail("cudaStreamCreateWithFlags", int(ce));
    return nullptr;
  }
  return s;
}

void Release(Decoder* d, Slot* s) {
  std::lock_guard<std::mutex> lk(d->mu);
  d->idle.push_back(s);
}

// The chroma planes' subsampling, as expansions across and down.
bool Expansion(nvjpegChromaSubsampling_t subsampling, int* hx, int* vx) {
  switch (subsampling) {
    case NVJPEG_CSS_444: *hx = 1; *vx = 1; return true;
    case NVJPEG_CSS_422: *hx = 2; *vx = 1; return true;
    case NVJPEG_CSS_420: *hx = 2; *vx = 2; return true;
    case NVJPEG_CSS_440: *hx = 1; *vx = 2; return true;
    case NVJPEG_CSS_411: *hx = 4; *vx = 1; return true;
    case NVJPEG_CSS_410: *hx = 4; *vx = 2; return true;
    default: return false;
  }
}

// Decode into the slot's device buffer as planes: Y [h, w], then (colour)
// Cb and Cr [ch, cw]; copy them back; finish on the host.
int DecodeIn(Decoder* d, Slot* s, const uint8_t* data, size_t len,
             const int* widths, const int* heights, bool grey, int hx,
             int vx, int image_size, double central_fraction, uint8_t* out) {
  const int w = widths[0], h = heights[0];
  const int cw = grey ? 0 : widths[1], ch = grey ? 0 : heights[1];
  const size_t plane = size_t(w) * h, chroma = size_t(cw) * ch;
  const size_t need = plane + 2 * chroma;
  if (s->cap < need) {
    size_t cap = size_t(1) << 20;
    while (cap < need) cap *= 2;
    if (s->dev) cudaFreeAsync(s->dev, s->stream);
    s->dev = nullptr;
    s->cap = 0;
    cudaError_t ce = cudaMallocFromPoolAsync(
        reinterpret_cast<void**>(&s->dev), cap, d->pool, s->stream);
    if (ce != cudaSuccess) return Fail("cudaMallocFromPoolAsync", int(ce));
    s->cap = cap;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = s->dev;
  img.pitch[0] = size_t(w);
  if (!grey) {
    img.channel[1] = s->dev + plane;
    img.channel[2] = s->dev + plane + chroma;
    img.pitch[1] = img.pitch[2] = size_t(cw);
  }
  nvjpegStatus_t st =
      nvjpegDecode(d->handle, s->state, data, len,
                   grey ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &img,
                   s->stream);
  if (st != NVJPEG_STATUS_SUCCESS) {
    cudaStreamSynchronize(s->stream);
    return 1;
  }
  s->host.resize(need);
  cudaError_t ce = cudaMemcpyAsync(s->host.data(), s->dev, need,
                                   cudaMemcpyDeviceToHost, s->stream);
  if (ce == cudaSuccess) ce = cudaStreamSynchronize(s->stream);
  if (ce != cudaSuccess) return Fail("nvJPEG decode or its copy", int(ce));
  const uint8_t* y = s->host.data();
  s->rgb.resize(plane * 3);
  if (grey) {
    for (size_t i = 0; i < plane; ++i)
      s->rgb[3 * i] = s->rgb[3 * i + 1] = s->rgb[3 * i + 2] = y[i];
  } else if (!vqa_torch::YccToRgb(y, y + plane, y + plane + chroma, w, h,
                                  cw, ch, hx, vx, s->rgb.data())) {
    return 1;
  }
  return vqa_torch::ResampleCrop(s->rgb.data(), w, h, image_size,
                                 central_fraction, out)
             ? 0
             : 1;
}

}  // namespace

extern "C" {

int vqa_torch_nvjpeg_decode(const uint8_t* data, size_t len, int image_size,
                            double central_fraction, int device,
                            uint8_t* out) {
  if (len < 3 || data[0] != 0xFF || data[1] != 0xD8) return 2;
  int code = 0;
  Decoder* d = GetDecoder(device, &code);
  if (!d) return code;
  cudaError_t ce = cudaSetDevice(device);
  if (ce != cudaSuccess) return Fail("cudaSetDevice", int(ce));
  int comps = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(d->handle, data, len, &comps, &subsampling, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return 1;
  const int w = widths[0], h = heights[0];
  if (w <= 0 || h <= 0 || uint64_t(w) * uint64_t(h) > vqa_torch::kMaxPixels)
    return 1;
  const bool grey = comps == 1;
  int hx = 1, vx = 1;
  if (!grey && (comps != 3 || !Expansion(subsampling, &hx, &vx) ||
                widths[1] != (w + hx - 1) / hx ||
                heights[1] != (h + vx - 1) / vx))
    return 1;
  Slot* s = Acquire(d, &code);
  if (!s) return code;
  try {
    code = DecodeIn(d, s, data, len, widths, heights, grey, hx, vx,
                    image_size, central_fraction, out);
  } catch (...) {  // a host buffer too large to hold
    code = 1;
  }
  Release(d, s);
  return code;
}

const char* vqa_torch_nvjpeg_last_error() { return t_error.c_str(); }

}  // extern "C"
