// Stride-1 VALID conv + bias + ReLU + 2x2 max pool, the conv as tap GEMMs with
// the pool on the f32 accumulator (kernel 6 of the port).
//
// Replaces dl_vqa_tpu/ops/conv_fused.py::_fused_kernel:
//   acc[b, y, x, n] = sum over taps (di, dj) of
//                     x[b, y + di, x + dj, :] . w[di, dj, :, n]      (f32 sums)
//   out[b, i, j, n] = cast(max over the 2x2 window at (2i, 2j) of
//                     relu(acc + bias[n]))
// with operands rounded to x's type, floor pooling, one cast: only the pooled
// tensor reaches device memory. Bias and ReLU are monotone, so the max of the
// four accumulators comes first.
//
// What bounds it on this card: operations. conv1 at batch 512 is 0.88 TFLOP
// (0.89 ms at the bf16 tensor cores' 989 TFLOP/s) against 0.81 GB read and
// 0.38 GB written (0.36 ms); conv2 0.82 TFLOP against 0.47 GB. The unfused
// path writes and reads the unpooled output besides (1.6 and 0.7 GB).
//
// Design, bf16. An implicit GEMM: M runs over conv positions, N over output
// channels, K over taps and input channels. A block makes a tile of 8 conv
// rows by 16 conv columns (aligned to pool windows) for BN = 32, 64 or 128
// channels. It does not carry over the TPU kernel's shape (a whole image a
// block, the width padded to 16, a clamped tail chunk that recomputes rows):
// tiles cover only the 2 Hp x 2 Wp conv positions that feed a window, and the
// ragged edge is masked at the store. Per slice of `ck` input channels the
// block stages the tile's input window with its halo, (8 + k - 1) x
// (16 + k - 1) pixels, and the slice's weights for all taps (they stream
// from L2: 144 KB and 576 KB of weights do not stay in shared memory), by
// asynchronous copies into one of two stages, so that a slice lands while
// the one before is multiplied. An operand's 16 rows are pixels of the
// staged window, so tap (di, dj) is the same window read at a shifted
// pixel: no im2col copy. Eight warps: warp (rp, nh) makes conv rows 2 rp and
// 2 rp + 1 of the tile for half of the block's channels, as two 16-row
// operand tiles of 2 conv rows by 8 conv columns each. Operands come from
// shared memory by ldmatrix (one instruction a 16 x 16 block; through wmma's
// fragment loads, many 32-bit loads each, the kernel took twice as long),
// products are mma.sync m16n8k16 with f32 accumulators. With the two conv
// rows of a window in the upper and lower half of an operand tile, a lane
// holds a window's two vertical sums and the lane four further its two
// others: the pool is two max and a shuffle in registers, and only pooled
// values are stored.
//
// f32 goes through plain FMAs (conv_pool_direct.cuh), which keeps the f32
// products exact rather than rounding them to TF32.

#include <cuda_pipeline.h>
#include <stdint.h>

#include "conv_pool_direct.cuh"
#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vqa::ldmatrix_x4;
using vqa::ldmatrix_x4_trans;
using vqa::mma_bf16;

constexpr int kThreads = 256;
constexpr int kTileH = 8, kTileW = 16;  // conv positions a block makes
// A staged pixel holds ck + kPad values and a staged weight row bn + kPad: the
// eight 16-byte rows that one ldmatrix phase reads then fall on eight
// different bank groups.
constexpr int kPad = 8;
constexpr int kMaxShared = vqa_conv::kMaxShared;

// kFrags: 16-channel groups a warp makes; the block makes 32 * kFrags
// channels. kK, kCk: the filter size and the slice width as constants, or 0
// for the values passed at run time; with constants the steps of a slice
// unroll, and the loads of a step are issued while the one before multiplies.
template <int kFrags, int kK, int kCk>
__global__ void __launch_bounds__(kThreads, 2)
conv_pool_mma_kernel(const bf16* __restrict__ x,      // [B, H, W, Cin]
                     const bf16* __restrict__ w,      // [k * k, Cin, Cout]
                     const float* __restrict__ bias,  // [Cout]
                     bf16* __restrict__ out,          // [B, Hp, Wp, Cout]
                     int h, int wd, int cin, int cout, int k_rt, int hp,
                     int wp, int ck_rt) {
  constexpr int kBn = 32 * kFrags, kBnPad = kBn + kPad;
  const int k = kK ? kK : k_rt, ck = kCk ? kCk : ck_rt;
  extern __shared__ __align__(128) unsigned char smem[];
  const int in_h = kTileH + k - 1, in_w = kTileW + k - 1;
  const int ckp = ck + kPad;
  // Two stages, each [in_h * in_w][ckp] pixels and [k * k * ck][kBnPad]
  // weights.
  const int in_elems = in_h * in_w * ckp;
  const int stage_elems = in_elems + k * k * ck * kBnPad;
  bf16* stages = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rp = warp % 4, nh = warp / 4;
  const int tiles_x = (2 * wp + kTileW - 1) / kTileW;
  const int y0 = blockIdx.x / tiles_x * kTileH;
  const int x0 = blockIdx.x % tiles_x * kTileW;
  const int n0 = blockIdx.y * kBn;
  const int64_t b = blockIdx.z;

  // A warp's two 16-row operand tiles: tile t holds conv rows 2 rp and
  // 2 rp + 1 at conv columns 8 t .. 8 t + 7, the upper row in operand rows
  // 0 .. 7 and the lower in 8 .. 15, so that a pool window's four sums lie
  // in two lanes. This lane's row address inside the staged window, without
  // the tap's shift, and its 8-channel half of a 16-channel step:
  const int a_pixel = (2 * rp + lane % 16 / 8) * in_w + lane % 8;
  const int a_half = lane / 16 * 8;
  // Its row of a [16, 16] weight block, as ldmatrix.trans wants it.
  const int b_row = lane % 8 + lane / 8 % 2 * 8;
  const int b_col = nh * kFrags * 16 + lane / 16 * 8;

  float acc[2][2 * kFrags][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < 2 * kFrags; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][n][q] = 0.0f;

  // Asynchronous copies (cp.async) of slice `slice` into stage `slice % 2`:
  // they are in flight while the slice before is multiplied.
  auto stage_slice = [&](int slice) {
    bf16* in_s = stages + (slice & 1) * stage_elems;
    bf16* w_s = in_s + in_elems;
    const int c_off = slice * ck, vecs = ck / 8;
    for (int e = tid; e < in_h * in_w * vecs; e += kThreads) {
      const int v = e % vecs, pixel = e / vecs;
      const int gy = y0 + pixel / in_w, gx = x0 + pixel % in_w;
      bf16* dst = in_s + pixel * ckp + v * 8;
      if (gy < h && gx < wd)
        __pipeline_memcpy_async(
            dst, x + ((b * h + gy) * wd + gx) * cin + c_off + v * 8, 16);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    constexpr int kRowVecs = kBn / 8;
    for (int e = tid; e < k * k * ck * kRowVecs; e += kThreads) {
      const int v = e % kRowVecs, row = e / kRowVecs;
      const int tap = row / ck, ci = row % ck;
      __pipeline_memcpy_async(
          w_s + row * kBnPad + v * 8,
          w + (static_cast<int64_t>(tap) * cin + c_off + ci) * cout + n0 +
              v * 8,
          16);
    }
    __pipeline_commit();
  };

  const int slices = cin / ck;
  stage_slice(0);
  for (int slice = 0; slice < slices; ++slice) {
    if (slice + 1 < slices) {
      stage_slice(slice + 1);
      __pipeline_wait_prior(1);  // this slice has landed, the next may fly
    } else {
      __pipeline_wait_prior(0);
    }
    const bf16* in_s = stages + (slice & 1) * stage_elems;
    const bf16* w_s = in_s + in_elems;
    __syncthreads();
#pragma unroll
    for (int di = 0; di < k; ++di) {
#pragma unroll
      for (int dj = 0; dj < k; ++dj) {
        const bf16* a_tap = in_s + (a_pixel + di * in_w + dj) * ckp + a_half;
        const bf16* b_tap = w_s + ((di * k + dj) * ck + b_row) * kBnPad + b_col;
#pragma unroll
        for (int kk = 0; kk < ck; kk += 16) {
          // wb[n]: two 8-channel blocks, k 0..7 and 8..15 of each.
          unsigned a[2][4], wb[kFrags][4];
          ldmatrix_x4(a[0], a_tap + kk);
          ldmatrix_x4(a[1], a_tap + 8 * ckp + kk);
#pragma unroll
          for (int n = 0; n < kFrags; ++n)
            ldmatrix_x4_trans(wb[n], b_tap + kk * kBnPad + n * 16);
#pragma unroll
          for (int n = 0; n < kFrags; ++n) {
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              mma_bf16(acc[t][2 * n], a[t], wb[n][0], wb[n][1]);
              mma_bf16(acc[t][2 * n + 1], a[t], wb[n][2], wb[n][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage may now take the slice after the next
  }

  // The pool, in registers: a lane holds the window's upper and lower sums
  // of one conv column; the column beside it is four lanes away.
  const int i = y0 / 2 + rp;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = x0 / 2 + 4 * t + lane / 8;
#pragma unroll
    for (int n = 0; n < 2 * kFrags; ++n) {
      float m0 = fmaxf(acc[t][n][0], acc[t][n][2]);
      float m1 = fmaxf(acc[t][n][1], acc[t][n][3]);
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
      if (lane / 4 % 2 || i >= hp || j >= wp) continue;
      const int channel = n0 + nh * kFrags * 16 + n * 8 + lane % 4 * 2;
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((b * hp + i) * wp + j) * cout + channel) =
          __floats2bfloat162_rn(fmaxf(m0 + bias[channel], 0.0f),
                                fmaxf(m1 + bias[channel + 1], 0.0f));
    }
  }
}

// Both stages.
size_t staging_bytes(int k, int ck, int bn) {
  return 2 * (static_cast<size_t>(kTileH + k - 1) * (kTileW + k - 1) * (ck + kPad) +
          static_cast<size_t>(k) * k * ck * (bn + kPad)) *
         sizeof(bf16);
}

template <int kFrags>
cudaError_t run_mma(const void* x, const void* w, const float* bias,
                     void* out, int batch, int h, int wd, int cin, int cout,
                     int k, cudaStream_t stream) {
  constexpr int kBn = 32 * kFrags;
  const int hp = (h - k + 1) / 2, wp = (wd - k + 1) / 2;
  // The widest slice of which two blocks, two stages each, fit an SM, else
  // the narrowest.
  int ck = 16;
  if (cin % 32 == 0 && 2 * staging_bytes(k, 32, kBn) <= kMaxShared) ck = 32;
  const size_t shared = staging_bytes(k, ck, kBn);
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  auto kernel = k == 3 && ck == 32   ? conv_pool_mma_kernel<kFrags, 3, 32>
                : k == 3 && ck == 16 ? conv_pool_mma_kernel<kFrags, 3, 16>
                                     : conv_pool_mma_kernel<kFrags, 0, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const int tiles = ((2 * hp + kTileH - 1) / kTileH) *
                    ((2 * wp + kTileW - 1) / kTileW);
  const dim3 grid(tiles, cout / kBn, batch);
  kernel<<<grid, kThreads, shared, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias,
      static_cast<bf16*>(out), h, wd, cin, cout, k, hp, wp, ck);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, Cin], w [k * k, Cin, Cout] rounded to x's type (bf16 for bf16 x,
// f32 for f32 x), bias [Cout] f32 -> out [B, (H - k + 1) / 2, (W - k + 1) / 2,
// Cout]. bf16 takes Cin a multiple of 16 and Cout a multiple of 32; f32 takes
// Cout a multiple of 8. cudaErrorInvalidValue for anything else.
extern "C" int vqa_conv_relu_pool_fused(const void* x, const void* w,
                                        const void* bias, void* out, int batch,
                                        int h, int wd, int cin, int cout, int k,
                                        int dtype, void* stream) {
  const float* bf = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || cin < 1 || cout < 1) return cudaErrorInvalidValue;
  if (batch <= 0 || (h - k + 1) / 2 <= 0 || (wd - k + 1) / 2 <= 0)
    return cudaSuccess;
  switch (dtype) {
    case vqa::kBFloat16:
      if (cin % 16 || cout % 32) return cudaErrorInvalidValue;
      if (cout % 128 == 0)
        return run_mma<4>(x, w, bf, out, batch, h, wd, cin, cout, k, s);
      if (cout % 64 == 0)
        return run_mma<2>(x, w, bf, out, batch, h, wd, cin, cout, k, s);
      return run_mma<1>(x, w, bf, out, batch, h, wd, cin, cout, k, s);
    case vqa::kFloat32:
      return vqa_conv::run_direct<float>(x, static_cast<const float*>(w), bf,
                                         out, batch, h, wd, cin, cout, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}
