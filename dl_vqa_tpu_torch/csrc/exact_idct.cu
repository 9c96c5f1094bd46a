// Kernel E of the port: a JPEG component's inverse DCT as libjpeg computes
// it, for the "exact" image decoder (data/images.py).
//
// No TPU kernel behind it: the JAX package decodes with PIL on the host
// (dl_vqa_tpu/data/images.py:64), whose libjpeg-turbo runs
// jpeg_idct_islow (jidctint.c). Per 8x8 block: dequantization (the
// coefficient times its table entry), the column pass (CONST_BITS 13,
// PASS1_BITS 2, results kept as int), the row pass, then the level shift
// and a clamp to 0-255. libjpeg's C code takes range_limit[x & 1023]
// there, a table that wraps values beyond +-384; PIL's libjpeg-turbo runs
// its SIMD inverse DCT, whose saturating packs clamp, and PIL's pixels
// follow the clamp where the table is off by up to 255 levels (the two
// agree within +-384). The plain version,
// ops/exact_decode.py::idct_islow_reference, is its oracle to the bit.
//
// Bound: bytes. A block reads 128 bytes of coefficients and writes 64 of
// samples (a 640x480 4:2:0 image: 7,200 blocks, 1.38 MB, about 0.4 us at
// 3.35 TB/s), so one image is a launch and little else. The design is the
// simple one: eight threads a block, one a column in the first pass and
// one a row in the second, the 8x8 intermediate in shared memory; all of
// an image's components in one launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerCta = 16;
constexpr int kThreads = kBlocksPerCta * 8;
constexpr int kMaxComponents = 4;

struct Component {
  const int16_t* coef;     // [blocks_h, blocks_w, 64], natural order
  const uint16_t* qtable;  // [64], natural order
  uint8_t* out;            // [blocks_h * 8, blocks_w * 8]
  int blocks_w, first;     // first: its first block in the launch's count
};

struct Args {
  Component c[kMaxComponents];
  int ncomp, total;
};

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr long long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                    F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                    F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

__device__ __forceinline__ long long descale(long long x, int n) {
  return (x + (1LL << (n - 1))) >> n;
}

// jidctint.c's one-dimensional pass on inputs s0..s7 (already dequantized
// in the first pass); o[i] before its descale.
__device__ __forceinline__ void idct_1d(const long long s[8], long long o[8]) {
  long long z2 = s[2], z3 = s[6];
  long long z1 = (z2 + z3) * F0541;
  const long long tmp2 = z1 + z3 * (-F1847);
  const long long tmp3 = z1 + z2 * F0765;
  long long tmp0 = (s[0] + s[4]) * (1LL << kConstBits);
  long long tmp1 = (s[0] - s[4]) * (1LL << kConstBits);
  const long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  tmp0 = s[7];
  tmp1 = s[5];
  long long t2 = s[3], t3 = s[1];
  z1 = tmp0 + t3;
  z2 = tmp1 + t2;
  z3 = tmp0 + t2;
  long long z4 = tmp1 + t3;
  const long long z5 = (z3 + z4) * F1175;
  tmp0 *= F0298;
  tmp1 *= F2053;
  t2 *= F3072;
  t3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 *= -F1961;
  z4 *= -F0390;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;

  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + tmp1;
  o[5] = tmp12 - tmp1;
  o[3] = tmp13 + tmp0;
  o[4] = tmp13 - tmp0;
}

// The level shift and clamp of PIL's libjpeg-turbo (see above).
__device__ __forceinline__ unsigned range_limit(long long x) {
  x += 128;
  return static_cast<unsigned>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

__global__ void __launch_bounds__(kThreads)
exact_idct_kernel(const Args args) {
  __shared__ int ws[kBlocksPerCta][64];
  const int slot = threadIdx.x / 8, lane = threadIdx.x % 8;
  const int block = blockIdx.x * kBlocksPerCta + slot;
  const bool live = block < args.total;
  int ci = 0;
  for (int k = 1; k < args.ncomp; ++k)
    if (block >= args.c[k].first) ci = k;
  const Component& c = args.c[ci];
  const int local = block - c.first;
  const int16_t* coef = c.coef + static_cast<size_t>(local) * 64;

  if (live) {  // column `lane`
    long long s[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      s[k] = static_cast<long long>(coef[8 * k + lane]) *
             static_cast<long long>(c.qtable[8 * k + lane]);
    idct_1d(s, o);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      ws[slot][8 * k + lane] =
          static_cast<int>(descale(o[k], kConstBits - kPass1Bits));
  }
  __syncthreads();
  if (live) {  // row `lane`
    long long s[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = ws[slot][8 * lane + k];
    idct_1d(s, o);
    const int brow = local / c.blocks_w, bcol = local % c.blocks_w;
    const size_t pitch = static_cast<size_t>(c.blocks_w) * 8;
    uint8_t* out = c.out + (static_cast<size_t>(brow) * 8 + lane) * pitch +
                   static_cast<size_t>(bcol) * 8;
    unsigned word[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      word[k / 4] |= range_limit(descale(o[k], kConstBits + kPass1Bits + 3))
                     << (8 * (k % 4));
    // The plane's rows start at multiples of 8 bytes.
    *reinterpret_cast<uint2*>(out) = make_uint2(word[0], word[1]);
  }
}

}  // namespace

// coef, qtable, out, blocks_w, blocks_h: four of each (the unused ones
// null or 0); ncomp 1 to 4. Returns cudaGetLastError() of the launch.
extern "C" int vqa_exact_idct(
    const void* coef0, const void* coef1, const void* coef2,
    const void* coef3, const void* q0, const void* q1, const void* q2,
    const void* q3, void* out0, void* out1, void* out2, void* out3, int bw0,
    int bw1, int bw2, int bw3, int bh0, int bh1, int bh2, int bh3, int ncomp,
    void* stream) {
  if (ncomp < 1 || ncomp > kMaxComponents) return cudaErrorInvalidValue;
  const void* coefs[4] = {coef0, coef1, coef2, coef3};
  const void* qs[4] = {q0, q1, q2, q3};
  void* outs[4] = {out0, out1, out2, out3};
  const int bws[4] = {bw0, bw1, bw2, bw3}, bhs[4] = {bh0, bh1, bh2, bh3};
  Args args{};
  args.ncomp = ncomp;
  long long total = 0;
  for (int k = 0; k < ncomp; ++k) {
    args.c[k] = {static_cast<const int16_t*>(coefs[k]),
                 static_cast<const uint16_t*>(qs[k]),
                 static_cast<uint8_t*>(outs[k]), bws[k],
                 static_cast<int>(total)};
    total += static_cast<long long>(bws[k]) * bhs[k];
  }
  if (total <= 0 || total > (1LL << 30)) return cudaErrorInvalidValue;
  args.total = static_cast<int>(total);
  const int grid = static_cast<int>((total + kBlocksPerCta - 1) /
                                    kBlocksPerCta);
  exact_idct_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
