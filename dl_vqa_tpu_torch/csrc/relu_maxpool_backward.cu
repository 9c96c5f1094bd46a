// Backward of bias + ReLU + 2x2/2 max pool (kernel C of the port).
//
// The pool part of dl_vqa_tpu/ops/conv_fused.py::_fastgrad_bwd (scatter
// branch), which the JAX package leaves to XLA (a pooled-side gate and
// reduction, then select_and_scatter). From the pooled cotangent g
// [B, Hp, Wp, C], the raw conv output y [B, Hc, Wc, C] and the bias:
//   z       = cast(relu(f32(y) + bias))          the values that were pooled
//   m       = max of z over the window           (the pooled output)
//   g_gated = m > 0 ? g : 0                      ReLU gate on the pooled side
//   db[ch]  = sum of f32(g_gated) over B, Hp, Wp
//   dz      = g_gated at the FIRST position of the window, in row-major
//             order, whose z equals m; zero everywhere else, the odd last
//             row and column included.
// Ties are decided on z, not on the raw y: two raw values can round to the
// same z. The forward kernel never wrote z, so it is recomputed here from
// the raw conv output, which costs no extra pass over device memory.
//
// Bound by memory traffic: reads y (3.2 GB for conv0 at batch 512 in bf16)
// and g, writes dz of y's size. A fixed grid of blocks walks the pooled rows
// (b, i); one thread makes the four dz values of one window, channels
// fastest, so a warp's loads and stores are contiguous. db: each thread sums
// what it routed (its channel is fixed when the block size is a multiple of
// C; shared-memory atomics otherwise), the block writes one partial row, and
// a second small kernel adds the rows up, so no global atomics are needed.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // all resident on an H100 at once

template <typename T>
__device__ __forceinline__ float pooled_value(T raw, float bias) {
  // Rounded to T as the forward stored it, back in f32 for the compares.
  return vqa::to_float(vqa::from_float<T>(fmaxf(vqa::to_float(raw) + bias,
                                                0.0f)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_maxpool_backward_kernel(const T* __restrict__ g,         // [B,Hp,Wp,C]
                             const T* __restrict__ y,         // [B,Hc,Wc,C]
                             const float* __restrict__ bias,  // [C]
                             T* __restrict__ dz,              // [B,Hc,Wc,C]
                             float* __restrict__ partial,     // [grid, C]
                             int64_t rows, int hc, int wc, int channels) {
  extern __shared__ float db_s[];  // [C]
  const int hp = hc / 2, wp = wc / 2;
  const int64_t in_row = static_cast<int64_t>(wc) * channels;
  const int n = wp * channels;
  const bool fixed_channel = kThreads % channels == 0;
  const T zero = vqa::from_float<T>(0.0f);
  for (int ch = threadIdx.x; ch < channels; ch += kThreads) db_s[ch] = 0.0f;
  __syncthreads();

  float acc = 0.0f;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t b = row / hp;
    const int i = static_cast<int>(row % hp);
    const int64_t top = (b * hc + 2 * i) * in_row;
    const T* g_row = g + row * n;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int j = e / channels, ch = e % channels;
      const int64_t at = top + static_cast<int64_t>(2 * j) * channels + ch;
      const float bv = bias[ch];
      const float z00 = pooled_value(y[at], bv);
      const float z01 = pooled_value(y[at + channels], bv);
      const float z10 = pooled_value(y[at + in_row], bv);
      const float z11 = pooled_value(y[at + in_row + channels], bv);
      const float m = fmaxf(fmaxf(z00, z01), fmaxf(z10, z11));
      const T gg = m > 0.0f ? g_row[e] : zero;
      // First match in row-major window order takes the cotangent.
      const int pick = z00 == m ? 0 : z01 == m ? 1 : z10 == m ? 2
                     : z11 == m ? 3 : -1;
      dz[at] = pick == 0 ? gg : zero;
      dz[at + channels] = pick == 1 ? gg : zero;
      dz[at + in_row] = pick == 2 ? gg : zero;
      dz[at + in_row + channels] = pick == 3 ? gg : zero;
      if (fixed_channel) {
        acc += vqa::to_float(gg);
      } else {
        atomicAdd(&db_s[ch], vqa::to_float(gg));
      }
    }
    // The odd last column of the window's two rows, and the odd last row.
    if (wc % 2) {
      for (int e = threadIdx.x; e < 2 * channels; e += kThreads)
        dz[top + (e / channels) * in_row +
           static_cast<int64_t>(wc - 1) * channels + e % channels] = zero;
    }
    if (hc % 2 && i == hp - 1) {
      const int64_t last = (b * hc + hc - 1) * in_row;
      for (int64_t e = threadIdx.x; e < in_row; e += kThreads)
        dz[last + e] = zero;
    }
  }
  if (fixed_channel) atomicAdd(&db_s[threadIdx.x % channels], acc);
  __syncthreads();
  for (int ch = threadIdx.x; ch < channels; ch += kThreads)
    partial[static_cast<int64_t>(blockIdx.x) * channels + ch] = db_s[ch];
}

// db[ch] = sum over the blocks' partial rows; one thread per channel.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ db, int blocks,
                                    int channels) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= channels) return;
  float sum = 0.0f;
  for (int r = 0; r < blocks; ++r)
    sum += partial[static_cast<int64_t>(r) * channels + ch];
  db[ch] = sum;
}

template <typename T>
cudaError_t run(const void* g, const void* y, const float* bias, void* dz,
                float* db, float* partial, int blocks, int batch, int hc,
                int wc, int channels, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(batch) * (hc / 2);
  relu_maxpool_backward_kernel<T>
      <<<blocks, kThreads, channels * sizeof(float), stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(y), bias,
          static_cast<T*>(dz), partial, rows, hc, wc, channels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(channels + 127) / 128, 128, 0, stream>>>(
      partial, db, blocks, channels);
  return cudaGetLastError();
}

}  // namespace

// The number of blocks the main kernel runs, which is also the number of
// rows of `partial` the caller allocates.
extern "C" int vqa_relu_maxpool_backward_blocks(int batch, int hc) {
  const int64_t rows = static_cast<int64_t>(batch) * (hc / 2);
  return static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
}

// Needs batch * (hc / 2) > 0, wc / 2 > 0 and channels * 4 bytes of shared
// memory under the 48 KB a launch gets without opting in.
extern "C" int vqa_relu_maxpool_backward(const void* g, const void* y,
                                         const void* bias, void* dz, void* db,
                                         void* partial, int batch, int hc,
                                         int wc, int channels, int dtype,
                                         void* stream) {
  const int blocks = vqa_relu_maxpool_backward_blocks(batch, hc);
  if (blocks == 0 || wc / 2 == 0 || channels <= 0 || channels > 8192)
    return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  float* dbp = static_cast<float*>(db);
  float* pp = static_cast<float*>(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vqa::kBFloat16:
      return run<__nv_bfloat16>(g, y, b, dz, dbp, pp, blocks, batch, hc, wc,
                                channels, s);
    case vqa::kFloat32:
      return run<float>(g, y, b, dz, dbp, pp, blocks, batch, hc, wc, channels,
                        s);
    default:
      return cudaErrorInvalidValue;
  }
}
