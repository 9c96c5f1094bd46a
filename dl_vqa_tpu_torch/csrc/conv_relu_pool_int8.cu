// The W8A8 conv block of the int8 serving mode (kernel D of the port): an
// s8 x s8 -> s32 convolution, the f32 requantizing epilogue, ReLU, the int8
// store and the 2x2/2 max pool, in one pass.
//
// No TPU kernel stands behind it: the JAX package computes the block in XLA
// (dl_vqa_tpu/ops/conv_int8.py::conv_relu_pool_w8a8, a conv_general_dilated
// with preferred_element_type=int32, then quantize_relu_pool), and PyTorch
// has no int8 convolution on CUDA. It computes, for x [B, H, W, Cin] int8
// (NHWC), any stride s, a VALID k x k filter and floor pooling:
//   acc[b, r, c, n] = sum over di, dj, ci of
//                     x[b, s r + di, s c + dj, ci] * w_q[n, ci, di, dj]   (s32)
//   y = fma(float_rn(acc), mult[n], bias[n])     (one rounding, as XLA)
//   q = clip(rint(relu(y) * scale), 0, 127)       (int8, half to even)
//   out[b, i, j, n] = max of q over the 2x2 window at (2i, 2j)
// where mult = w_scale * f32(s_in / 127) and scale = f32(127 / s_out) come
// rounded from the caller, as the JAX package rounds them, and the
// multiply-add rounds once because XLA contracts the JAX expression into a
// fused multiply-add when the model runs jitted. Each of the four
// positions of a window is finished on its own before the max, in the JAX
// order, so no monotonicity of the epilogue is assumed.
//
// What bounds it on this card: operations. conv1 of the reference model at
// batch 512 (111 px, 64 -> 128 channels) is 0.88 T integer operations over
// the 108 x 108 conv positions its pool reads, and moves 0.40 GB in and
// 0.19 GB out: 0.45 ms at the dense int8 peak against 0.18 ms of memory
// traffic. The first design here is simple and
// right, not fast: an implicit GEMM on mma.sync m16n8k32 (s8 in, s32
// accumulators), M = the conv positions of 8 pooled columns (the two rows
// of each window in two m16 tiles, its two columns in rows g and g + 8 of a
// tile, so that a thread holds the four positions of its windows), N = 32
// channels a warp, K = (di, dj, ci) with Cin padded to 32. A block makes one
// pooled row of one image for 128 channels: it stages the s + k input rows
// it reads (all of their columns, Cin padded with zeros) in shared memory
// once, with a pixel stride that spreads a fragment's loads over all the
// banks, and its warps walk (column group, 32-channel quarter) items. The
// weights come packed in fragment order from global memory (8 bytes a lane,
// a warp's load one 256-byte run; they stay in L1 and L2: 74 KB for conv1,
// 295 KB for conv2).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockN = 128;          // output channels a block makes
constexpr int kWarpTiles = 4;         // n8 tiles a warp item makes
constexpr int kQuarters = kBlockN / (8 * kWarpTiles);
constexpr int kCols = 8;              // pooled columns a warp item makes
constexpr int kMaxShared = 232448;    // bytes a block may have on sm_90

// d += a . b for s8 a [16, 32] (row-major), s8 b [32, 8] (column-major) and
// s32 d [16, 8]: a lane holds a[lane / 4][4 (lane % 4) + {0..3}] in a[0],
// row lane / 4 + 8 in a[1], and the same rows at k + 16 in a[2], a[3]; b
// column lane / 4 at k = 4 (lane % 4) + {0..3} in b0 and k + 16 in b1; d as
// mma.m16n8k16's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int finish(int acc, float mult, float bias,
                                      float scale) {
  const float y = __fmaf_rn(__int2float_rn(acc), mult, bias);
  const float r = rintf(__fmul_rn(fmaxf(y, 0.0f), scale));
  return static_cast<int>(fminf(fmaxf(r, 0.0f), 127.0f));
}

struct Shape {
  int h, w, cin, cout, k, stride, hp, wp;
  int cin_words;  // Cin padded to 32, in 4-byte words
  int pw;         // words a staged pixel takes (cin_words and a bank pad)
  int ksteps;     // k * k * Cin_pad / 32
};

__global__ void __launch_bounds__(kThreads)
conv_relu_pool_int8_kernel(const int8_t* __restrict__ x,     // [B, H, W, Cin]
                           const uint2* __restrict__ wpack,  // fragments
                           const float* __restrict__ mult,   // [Cout]
                           const float* __restrict__ bias,   // [Cout]
                           int8_t* __restrict__ out,  // [B, Hp, Wp, Cout]
                           Shape s, float scale) {
  extern __shared__ unsigned staged[];  // [s + k rows][W][pw] words
  const int row = blockIdx.x;           // b * hp + i
  const int b = row / s.hp, i = row % s.hp;
  const int n_block = blockIdx.y * kBlockN;
  const int rows = s.stride + s.k;
  const int first_row = 2 * i * s.stride;

  // Stage the input rows of pooled row i, Cin padded with zero words.
  const int words = rows * s.w * s.cin_words;
  const int cin4 = s.cin / 4;
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const int cw = e % s.cin_words;
    const int pix = e / s.cin_words;  // r * W + col
    const int r = pix / s.w, col = pix % s.w;
    unsigned v = 0;
    if (cw < cin4) {
      const int64_t offset =
          ((static_cast<int64_t>(b) * s.h + first_row + r) * s.w + col) *
              s.cin + 4 * cw;
      v = __ldg(reinterpret_cast<const unsigned*>(x + offset));
    }
    staged[pix * s.pw + cw] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int groups = (s.wp + kCols - 1) / kCols;
  const int csteps = s.cin_words / 8;  // k steps of 32 channels a tap
  for (int item = warp; item < groups * kQuarters; item += kWarps) {
    const int group = item / kQuarters, quarter = item % kQuarters;
    const int n0 = n_block + quarter * 8 * kWarpTiles;
    if (n0 >= s.cout) continue;
    const int j = group * kCols + g;
    const int jj = j < s.wp ? j : s.wp - 1;  // a clamped address; not stored
    int acc[2][kWarpTiles][4] = {};
    const uint2* wq = wpack + static_cast<int64_t>(n0 / 8) * s.ksteps * 32;
    for (int di = 0; di < s.k; ++di) {
      for (int dj = 0; dj < s.k; ++dj) {
        // The staged pixels of the window's four positions for this tap.
        int base[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            base[a][c] = ((s.stride * a + di) * s.w +
                          s.stride * (2 * jj + c) + dj) * s.pw + t;
        const int step0 = (di * s.k + dj) * csteps;
        for (int cs = 0; cs < csteps; ++cs) {
          unsigned frag[2][4];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            frag[a][0] = staged[base[a][0] + 8 * cs];
            frag[a][1] = staged[base[a][1] + 8 * cs];
            frag[a][2] = staged[base[a][0] + 8 * cs + 4];
            frag[a][3] = staged[base[a][1] + 8 * cs + 4];
          }
          const int step = step0 + cs;
#pragma unroll
          for (int nt = 0; nt < kWarpTiles; ++nt) {
            const uint2 bw =
                __ldg(wq + (static_cast<int64_t>(nt) * s.ksteps + step) * 32 +
                      lane);
            mma_s8(acc[0][nt], frag[0], bw.x, bw.y);
            mma_s8(acc[1][nt], frag[1], bw.x, bw.y);
          }
        }
      }
    }
    if (j >= s.wp) continue;
    int8_t* dst = out + (static_cast<int64_t>(row) * s.wp + j) * s.cout;
#pragma unroll
    for (int nt = 0; nt < kWarpTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + nt * 8 + 2 * t + e;
        if (n >= s.cout) continue;
        const float m = mult[n], bn = bias[n];
        // (row 2i, col 2j), (2i, 2j + 1), (2i + 1, 2j), (2i + 1, 2j + 1)
        const int q0 = finish(acc[0][nt][e], m, bn, scale);
        const int q1 = finish(acc[0][nt][2 + e], m, bn, scale);
        const int q2 = finish(acc[1][nt][e], m, bn, scale);
        const int q3 = finish(acc[1][nt][2 + e], m, bn, scale);
        dst[n] = static_cast<int8_t>(max(max(q0, q1), max(q2, q3)));
      }
    }
  }
}

// The least pixel stride (in words, at least cin_words) under which the
// eight rows of a fragment load (pixels 2 s g apart) and its four lanes of a
// row fall in distinct banks; cin_words where none does.
int pixel_words(int cin_words, int stride) {
  for (int pw = cin_words; pw < cin_words + 32; ++pw) {
    unsigned used = 0;
    bool clash = false;
    for (int g = 0; g < 8 && !clash; ++g)
      for (int t = 0; t < 4 && !clash; ++t) {
        const unsigned bank = (2u * stride * pw * g + t) % 32;
        clash = used & (1u << bank);
        used |= 1u << bank;
      }
    if (!clash) return pw;
  }
  return cin_words;
}

}  // namespace

// x int8 [B, H, W, Cin] (Cin a multiple of 4, 4-byte aligned), wpack the
// weights packed by ops/conv_int8.py::pack_int8_weight ([Cout padded to 128
// / 8][k * k * Cin_pad / 32][32 lanes][8 bytes]), mult and bias f32 [Cout],
// out int8 [B, Hp, Wp, Cout]. Returns cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int vqa_conv_relu_pool_int8(const void* x, const void* wpack,
                                       const void* mult, const void* bias,
                                       void* out, int batch, int h, int w,
                                       int cin, int cout, int k, int stride,
                                       float scale, void* stream) {
  if (cin < 4 || cin % 4 || cout < 1 || k < 1 || stride < 1 || h < k ||
      w < k)
    return cudaErrorInvalidValue;
  Shape s;
  s.h = h; s.w = w; s.cin = cin; s.cout = cout; s.k = k; s.stride = stride;
  s.hp = ((h - k) / stride + 1) / 2;
  s.wp = ((w - k) / stride + 1) / 2;
  s.cin_words = (cin + 31) / 32 * 8;
  s.pw = pixel_words(s.cin_words, stride);
  s.ksteps = k * k * s.cin_words / 8;
  if (static_cast<int64_t>(batch) * s.hp == 0 || s.wp == 0)
    return cudaSuccess;
  const size_t shared =
      static_cast<size_t>(stride + k) * w * s.pw * sizeof(unsigned);
  if (shared > kMaxShared || static_cast<int64_t>(batch) * s.hp > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_relu_pool_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * s.hp),
                  static_cast<unsigned>((cout + kBlockN - 1) / kBlockN));
  conv_relu_pool_int8_kernel<<<grid, kThreads, shared,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint2*>(wpack),
      static_cast<const float*>(mult), static_cast<const float*>(bias),
      static_cast<int8_t*>(out), s, scale);
  return cudaGetLastError();
}
