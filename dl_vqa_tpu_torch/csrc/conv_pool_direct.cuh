// A fused conv + bias + ReLU + 2x2 max pool on plain f32 FMAs, shared by the
// stem kernel (conv_relu_pool_stem.cu, any type) and by the f32 path of the
// tap-GEMM kernel (conv_relu_pool_fused.cu).
//
//   out[b, i, j, n] = cast(relu(max over a, c in {0, 1} of
//       sum over di, dj, ci of x[b, 2i + a + di, 2j + c + dj, ci] * w[di, dj, ci, n]
//       + bias[n]))
// for x [B, H, W, Cin] of type T (NHWC, stride 1, VALID), w [k, k, Cin, Cout]
// f32 holding values already rounded to T, f32 sums, floor pooling: the conv
// output is never written. Bias and ReLU are monotone, so they are applied
// once, to the max of the four sums.
//
// A block makes a tile of pooled positions for `bn` output channels; a
// thread makes one pooled position for 8 channels: the four conv sums of its
// window for each, 32 accumulators. The block stages the tile's input window
// (with its halo) and the weights of those channels in shared memory, in
// slices of `cs` input channels when all of them do not fit. With one slice a
// pixel row of the window is one run of memory, which is loaded by 16-byte
// vectors whatever its alignment (3-channel pixels are 6 bytes in bf16), and
// the block stages a window several times as tall and walks it in passes, so
// that the weights are staged once for up to four positions a thread.
// The kernel takes any k, Cin and Cout at run time; for the RGB stem's own
// shape (k = 3, Cin = 3, 64 channels a block) they are template constants,
// so the 27 steps of a window unroll, every shared-memory offset is an
// immediate and a window's 48 inputs are loaded once; and there a thread
// makes two positions at a time with each weight vector it loads, because
// with one position the weights' shared-memory loads take as long as the
// FMAs they feed.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace vqa_conv {

constexpr int kThreads = 256;
constexpr int kGroup = 8;           // channels a thread makes
constexpr int kTileCols = 8;        // pooled columns a block makes
constexpr int kMaxShared = 232448;  // bytes a block may have on sm_90
// Shared memory the slices aim at, so that three blocks share an SM.
constexpr int kSliceBudget = 72 * 1024;
constexpr int kMaxPasses = 4;

struct DirectPlan {
  int bn;         // output channels a block makes: 8, 16, 32 or 64
  int cs;         // input channels a slice holds
  int passes;     // positions a thread makes, one after the other
  int tile_rows;  // pooled rows a block makes, over all passes
  size_t shared;  // bytes of shared memory
};

inline size_t direct_bytes_per_channel(int k, int bn, int tile_rows,
                                       size_t elem) {
  return static_cast<size_t>(k) * k * bn * sizeof(float) +
         static_cast<size_t>(2 * tile_rows + k - 1) * (2 * kTileCols + k - 1) *
             elem;
}

// False where the kernel cannot run: Cout no multiple of 8, or a filter so
// large that one input channel does not fit.
inline bool plan_direct(int k, int cin, int cout, size_t elem, DirectPlan* p) {
  if (k < 1 || cin < 1 || cout < kGroup || cout % kGroup) return false;
  p->bn = cout % 64 == 0 ? 64 : cout % 32 == 0 ? 32 : cout % 16 == 0 ? 16 : 8;
  const int rows = kThreads / (p->bn / kGroup) / kTileCols;  // of one pass
  size_t per_channel = direct_bytes_per_channel(k, p->bn, rows, elem);
  size_t cs = kSliceBudget / per_channel;
  if (cs < 1) cs = kMaxShared / per_channel;
  if (cs < 1) return false;
  p->cs = cs < static_cast<size_t>(cin) ? static_cast<int>(cs) : cin;
  p->passes = 1;
  if (p->cs == cin) {  // one slice: as many passes as the budget holds
    while (p->passes < kMaxPasses &&
           direct_bytes_per_channel(k, p->bn, rows * (p->passes + 1), elem) *
                   cin <= kSliceBudget)
      ++p->passes;
    per_channel = direct_bytes_per_channel(k, p->bn, rows * p->passes, elem);
  }
  p->tile_rows = rows * p->passes;
  p->shared = per_channel * p->cs;
  return true;
}

// Stage slice [c_off, c_off + cs_here) of the block's weights and input
// window; called by all threads of the block.
template <typename T>
__device__ __forceinline__ void stage_slice(
    const T* __restrict__ x, const T* x_end, const float* __restrict__ w,
    float* w_s, T* in_s, int64_t b, int h, int wd, int cin, int cout, int k,
    int bn, int cs, int cs_here, int c_off, int n0, int y0, int x0,
    int rows_here, int cols_here, int in_cols) {
  const int tid = threadIdx.x;
  if (cs_here == cin && bn == cout) {
    for (int e = tid; e < k * k * cin * cout; e += kThreads) w_s[e] = w[e];
  } else {
    for (int e = tid; e < k * k * cs_here * bn; e += kThreads) {
      const int n = e % bn, row = e / bn;
      const int tap = row / cs_here, ci = row % cs_here;
      w_s[(tap * cs + ci) * bn + n] =
          w[(static_cast<int64_t>(tap) * cin + c_off + ci) * cout + n0 + n];
    }
  }
  if (cs_here == cin) {
    // One run of cols_here * cin elements a row: aligned 16-byte loads that
    // may start before the run and end after it.
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const int run = cols_here * cin;
    const int vecs = (run + kVec - 1) / kVec + 1;
    for (int e = tid; e < rows_here * vecs; e += kThreads) {
      const int r = e / vecs, v = e % vecs;
      const T* src = x + ((b * h + y0 + r) * wd + x0) * cin;
      const int shift = static_cast<int>(
          (reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
      const int first = v * kVec - shift;  // the run's index of element 0
      if (first >= run) continue;
      const T* vec = src + first;
      T* dst = in_s + r * in_cols * cs;
      if (vec >= x && vec + kVec <= x_end) {
        const uint4 raw = *reinterpret_cast<const uint4*>(vec);
        const T* val = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int t = 0; t < kVec; ++t)
          if (first + t >= 0 && first + t < run) dst[first + t] = val[t];
      } else {
        for (int t = 0; t < kVec; ++t)
          if (first + t >= 0 && first + t < run) dst[first + t] = vec[t];
      }
    }
  } else {
    for (int e = tid; e < rows_here * cols_here * cs_here; e += kThreads) {
      const int ci = e % cs_here, pixel = e / cs_here;
      const int r = pixel / cols_here, c = pixel % cols_here;
      in_s[(r * in_cols + c) * cs + ci] =
          x[((b * h + y0 + r) * wd + x0 + c) * cin + c_off + ci];
    }
  }
}

// kK, kCin, kBn: k, Cin (one slice) and bn as constants, or 0 for the values
// passed at run time. kPos: positions a thread makes at a time (passes is a
// multiple of it); two of them keep 64 accumulators, and two blocks an SM.
template <typename T, int kK, int kCin, int kBn, int kPos>
__global__ void __launch_bounds__(kThreads, kPos)
conv_pool_direct_kernel(const T* __restrict__ x,         // [B, H, W, Cin]
                        const float* __restrict__ w,     // [k, k, Cin, Cout]
                        const float* __restrict__ bias,  // [Cout]
                        T* __restrict__ out,             // [B, Hp, Wp, Cout]
                        int h, int wd, int cin_rt, int cout, int k_rt, int hp,
                        int wp, int bn_rt, int cs_rt, int tile_rows,
                        int passes) {
  const int k = kK ? kK : k_rt, bn = kBn ? kBn : bn_rt;
  const int cin = kCin ? kCin : cin_rt, cs = kCin ? kCin : cs_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_rows = 2 * tile_rows + k - 1, in_cols = 2 * kTileCols + k - 1;
  float* w_s = reinterpret_cast<float*>(smem);            // [k * k][cs][bn]
  T* in_s = reinterpret_cast<T*>(w_s + k * k * cs * bn);  // [in_rows][in_cols][cs]

  const int tid = threadIdx.x;
  const int tiles_x = (wp + kTileCols - 1) / kTileCols;
  const int i0 = blockIdx.x / tiles_x * tile_rows;
  const int j0 = blockIdx.x % tiles_x * kTileCols;
  const int n0 = blockIdx.y * bn;
  const int64_t b = blockIdx.z;
  const int groups = bn / kGroup;
  const int g = tid % groups, pos = tid / groups;
  const int pc = pos % kTileCols, j = j0 + pc;
  const int y0 = 2 * i0, x0 = 2 * j0;
  const int rows_here = min(in_rows, h - y0), cols_here = min(in_cols, wd - x0);
  const T* x_end = x + static_cast<int64_t>(gridDim.z) * h * wd * cin;

  for (int pass = 0; pass < passes; pass += kPos) {
    // A live position reads rows up to 2i + k <= H - 1 and columns up to
    // 2j + k <= W - 1, so what is staged below covers all it reads; one that
    // is not live reads staged memory all the same, and stores nothing.
    int pr[kPos];
    bool live[kPos], any_live = false;
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      pr[p] = (pass + p) * (tile_rows / passes) + pos / kTileCols;
      live[p] = i0 + pr[p] < hp && j < wp;
      any_live = any_live || live[p];
    }
    float acc[kPos][4][kGroup];
#pragma unroll
    for (int p = 0; p < kPos; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < kGroup; ++c) acc[p][q][c] = 0.0f;

    for (int c_off = 0; c_off < cin; c_off += cs) {
      const int cs_here = kCin ? kCin : min(cs, cin - c_off);
      // Several passes come with one slice, which the first pass stages.
      if (pass == 0) {
        __syncthreads();  // the last slice has been read
        stage_slice<T>(x, x_end, w, w_s, in_s, b, h, wd, cin, cout, k, bn, cs,
                       cs_here, c_off, n0, y0, x0, rows_here, cols_here,
                       in_cols);
        __syncthreads();
      }
      if (!any_live) continue;
#pragma unroll
      for (int di = 0; di < k; ++di) {
#pragma unroll
        for (int dj = 0; dj < k; ++dj) {
          const float* wt = w_s + (di * k + dj) * cs * bn + g * kGroup;
#pragma unroll
          for (int ci = 0; ci < cs_here; ++ci) {
            float wv[kGroup];
            vqa::load8(wt + ci * bn, wv);
#pragma unroll
            for (int p = 0; p < kPos; ++p) {
              const T* top =
                  in_s + ((2 * pr[p] + di) * in_cols + 2 * pc + dj) * cs + ci;
              const T* bottom = top + in_cols * cs;
              const float v[4] = {vqa::to_float(top[0]), vqa::to_float(top[cs]),
                                  vqa::to_float(bottom[0]),
                                  vqa::to_float(bottom[cs])};
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int c = 0; c < kGroup; ++c)
                  acc[p][q][c] = fmaf(v[q], wv[c], acc[p][q][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      if (!live[p]) continue;
      float o[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        const float m = fmaxf(fmaxf(acc[p][0][c], acc[p][1][c]),
                              fmaxf(acc[p][2][c], acc[p][3][c]));
        o[c] = fmaxf(m + bias[n0 + g * kGroup + c], 0.0f);
      }
      vqa::store8(
          out + ((b * hp + i0 + pr[p]) * wp + j) * cout + n0 + g * kGroup, o);
    }
  }
}

// One grid of (tiles, Cout / bn, B) blocks; cudaErrorInvalidValue for what
// plan_direct refuses.
template <typename T>
cudaError_t run_direct(const void* x, const float* w, const float* bias,
                       void* out, int batch, int h, int wd, int cin, int cout,
                       int k, cudaStream_t stream) {
  const int hp = (h - k + 1) / 2, wp = (wd - k + 1) / 2;
  if (batch <= 0 || hp <= 0 || wp <= 0) return cudaSuccess;
  DirectPlan plan;
  if (!plan_direct(k, cin, cout, sizeof(T), &plan)) return cudaErrorInvalidValue;
  const bool stem_shape = k == 3 && cin == 3 && plan.bn == 64 &&
                          plan.cs == 3 && plan.passes % 2 == 0;
  auto kernel = stem_shape ? conv_pool_direct_kernel<T, 3, 3, 64, 2>
                           : conv_pool_direct_kernel<T, 0, 0, 0, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.shared));
  if (err != cudaSuccess) return err;
  const int tiles = ((hp + plan.tile_rows - 1) / plan.tile_rows) *
                    ((wp + kTileCols - 1) / kTileCols);
  const dim3 grid(tiles, cout / plan.bn, batch);
  kernel<<<grid, kThreads, plan.shared, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(out), h, wd, cin,
      cout, k, hp, wp, plan.bn, plan.cs, plan.tile_rows, plan.passes);
  return cudaGetLastError();
}

}  // namespace vqa_conv
