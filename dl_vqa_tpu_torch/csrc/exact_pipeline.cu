// The exact decoder's device stages for a chunk of images in one call: the
// inputs' copy to the card, kernel E for each JPEG, one launch of
// color_resample over the whole chunk, the output's copy back and the wait
// for it, on the caller's stream. One image is the chunk of one. A decode
// driven op by op from Python gives the interpreter lock up and takes it
// back at every call, and threads decoding at once then queue for it; this
// entry is one foreign call a chunk. It launches the kernels through their
// own C entries (exact_idct.cu, exact_color_resample.cu), so the bits are
// theirs.
//
// desc: int64 (ops/exact_decode.py::exact_decode_cuda builds it):
//   0 host_in, 1 dev_in, 2 in_bytes, 3 host_out, 4 dev_out, 5 out_bytes,
//   6 images (color_resample's descriptors, on the card), 7 tiles (its
//   plan, on the card), 8 n_tiles, 9 smem, 10 n_jpegs;
//   then kJpegFields a JPEG: ncomp, and for each of four components (zero
//   beyond ncomp) coef, qtable, plane, blocks_w, blocks_h.

#include <cstdint>

#include <cuda_runtime.h>

extern "C" int vqa_exact_idct(const void*, const void*, const void*,
                              const void*, const void*, const void*,
                              const void*, const void*, void*, void*, void*,
                              void*, int, int, int, int, int, int, int, int,
                              int, void*);
extern "C" int vqa_color_resample(const void*, const void*, int, int, void*);

namespace {

constexpr int kHeader = 11;
constexpr int kJpegFields = 1 + 4 * 5;

inline void* ptr(long long v) { return reinterpret_cast<void*>(v); }
inline int i32(long long v) { return static_cast<int>(v); }

}  // namespace

extern "C" int vqa_exact_decode_batch(const long long* desc, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const long long* d = desc;
  cudaError_t err = cudaMemcpyAsync(ptr(d[1]), ptr(d[0]), d[2],
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long j = 0; j < d[10]; ++j) {
    const long long* e = d + kHeader + kJpegFields * j;
    const long long* c = e + 1;  // c[5 * k + field]
    int rc = vqa_exact_idct(
        ptr(c[0]), ptr(c[5]), ptr(c[10]), ptr(c[15]), ptr(c[1]), ptr(c[6]),
        ptr(c[11]), ptr(c[16]), ptr(c[2]), ptr(c[7]), ptr(c[12]),
        ptr(c[17]), i32(c[3]), i32(c[8]), i32(c[13]), i32(c[18]),
        i32(c[4]), i32(c[9]), i32(c[14]), i32(c[19]), i32(e[0]), stream);
    if (rc) return rc;
  }
  int rc = vqa_color_resample(ptr(d[6]), ptr(d[7]), i32(d[8]), i32(d[9]),
                              stream);
  if (rc) return rc;
  err = cudaMemcpyAsync(ptr(d[3]), ptr(d[4]), d[5], cudaMemcpyDeviceToHost,
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamSynchronize(s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
