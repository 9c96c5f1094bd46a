// The exact decoder's device stages for one image in one call: the inputs'
// copy to the card, kernels E and F (a JPEG) and G, the output's copy back
// and the wait for it, on the caller's stream. A decode driven op by op
// from Python gives the interpreter lock up and takes it back some forty
// times an image, and threads decoding at once then queue for it; this
// entry is one foreign call, the lock given up once. It launches the
// kernels through their own C entries (exact_idct.cu, exact_color.cu,
// pil_resample.cu), so the bits are theirs.
//
// desc: int64 [kDescLen] (ops/exact_decode.py::exact_decode_cuda builds it):
//   0 host_in, 1 dev_in, 2 in_bytes, 3 host_out, 4 dev_out, 5 out_bytes,
//   6 jpeg (0 or 1), 7 ncomp, 8 colour space, 9 width, 10 height,
//   11 rgb (device RGB8: F's output, or a PNG's or BMP's pixels),
//   12 taps, 13 kx, 14 ky, 15 size,
//   16 + 11 c (c < 4): coef, qtable, plane, blocks_w, blocks_h, pitch,
//   real width, real height, expansion across, down, method.

#include <cstdint>

#include <cuda_runtime.h>

extern "C" int vqa_exact_idct(const void*, const void*, const void*,
                              const void*, const void*, const void*,
                              const void*, const void*, void*, void*, void*,
                              void*, int, int, int, int, int, int, int, int,
                              int, void*);
extern "C" int vqa_exact_color(const void*, const void*, const void*,
                               const void*, int, int, int, int, int, int, int,
                               int, int, int, int, int, int, int, int, int,
                               int, int, int, int, int, int, int, int, int,
                               int, int, int, void*, void*);
extern "C" int vqa_pil_resample(const void*, int, int, const void*, int, int,
                                int, void*, void*);

namespace {

constexpr int kDescLen = 16 + 4 * 11;

inline void* ptr(long long v) { return reinterpret_cast<void*>(v); }
inline int i32(long long v) { return static_cast<int>(v); }

}  // namespace

extern "C" int vqa_exact_decode(const long long* desc, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const long long* d = desc;
  cudaError_t err = cudaMemcpyAsync(ptr(d[1]), ptr(d[0]), d[2],
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncomp = i32(d[7]);
  if (d[6]) {
    if (ncomp < 1 || ncomp > 4) return cudaErrorInvalidValue;
    const long long* c[4];
    for (int k = 0; k < 4; ++k) c[k] = d + 16 + 11 * (k < ncomp ? k : 0);
    auto field = [&](int k, int f) { return k < ncomp ? c[k][f] : 0LL; };
    int rc = vqa_exact_idct(
        ptr(field(0, 0)), ptr(field(1, 0)), ptr(field(2, 0)),
        ptr(field(3, 0)), ptr(field(0, 1)), ptr(field(1, 1)),
        ptr(field(2, 1)), ptr(field(3, 1)), ptr(field(0, 2)),
        ptr(field(1, 2)), ptr(field(2, 2)), ptr(field(3, 2)),
        i32(field(0, 3)), i32(field(1, 3)), i32(field(2, 3)),
        i32(field(3, 3)), i32(field(0, 4)), i32(field(1, 4)),
        i32(field(2, 4)), i32(field(3, 4)), ncomp, stream);
    if (rc) return rc;
    auto one = [&](int k, int f) { return k < ncomp ? i32(c[k][f]) : 1; };
    rc = vqa_exact_color(
        ptr(field(0, 2)), ptr(field(1, 2)), ptr(field(2, 2)),
        ptr(field(3, 2)), one(0, 5), one(1, 5), one(2, 5), one(3, 5),
        one(0, 6), one(1, 6), one(2, 6), one(3, 6), one(0, 7), one(1, 7),
        one(2, 7), one(3, 7), one(0, 8), one(1, 8), one(2, 8), one(3, 8),
        one(0, 9), one(1, 9), one(2, 9), one(3, 9), one(0, 10), one(1, 10),
        one(2, 10), one(3, 10), ncomp, i32(d[8]), i32(d[9]), i32(d[10]),
        ptr(d[11]), stream);
    if (rc) return rc;
  }
  int rc = vqa_pil_resample(ptr(d[11]), i32(d[9]), i32(d[10]), ptr(d[12]),
                            i32(d[13]), i32(d[14]), i32(d[15]), ptr(d[4]),
                            stream);
  if (rc) return rc;
  err = cudaMemcpyAsync(ptr(d[3]), ptr(d[4]), d[5], cudaMemcpyDeviceToHost,
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamSynchronize(s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
