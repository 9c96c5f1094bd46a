// Glimpse softmax pooling (kernel 3 of the port).
//
// Replaces dl_vqa_tpu/ops/attention_pool.py::_pool_kernel:
//   w[b, :, g] = softmax over s of att[b, s, g]
//   out[b, g * C + ch] = sum_s w[b, s, g] * v[b, s, ch]
// in f32, glimpses concatenated glimpse-major.
//
// The bound is reading v once (512 x 676 x 256 f32 = 177 MB at batch 512).
// The TPU kernel re-reads v once per glimpse; here a block owns one sample
// and a tile of 128 channels, keeps the whole att[b] (676 x 2 values) in
// shared memory, turns it into softmax weights there, and then streams v
// once, accumulating every glimpse from the same load. Each thread owns one
// channel, so the loads of a warp are contiguous; the block's four groups
// of 128 threads take every fourth position, which keeps four times as
// many loads in flight, and their partial sums meet in shared memory.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kChannels = 128;            // channels per block
constexpr int kGroups = 4;                // position groups per block
constexpr int kThreads = kChannels * kGroups;
constexpr int kMaxGlimpses = 8;

__device__ __forceinline__ float warp_reduce(float x, bool is_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, o) : x + o;
  }
  return x;
}

// Max or sum over the block; every thread gets the result.
__device__ float block_reduce(float x, bool is_max, float* scratch) {
  x = warp_reduce(x, is_max);
  __syncthreads();  // the previous call may still be reading scratch
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  x = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w)
    x = is_max ? fmaxf(x, scratch[w]) : x + scratch[w];
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_pool_kernel(const T* __restrict__ v,    // [B, S, C]
                      const T* __restrict__ att,  // [B, S, G]
                      float* __restrict__ out,    // [B, G * C]
                      int spatial, int channels, int glimpses) {
  extern __shared__ float w_s[];  // [S, G]: logits, then softmax weights
  __shared__ float scratch[kThreads / 32];
  const int b = blockIdx.y;
  const int n = spatial * glimpses;
  const T* att_b = att + static_cast<size_t>(b) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) w_s[i] = vqa::to_float(att_b[i]);
  __syncthreads();

  for (int g = 0; g < glimpses; ++g) {
    float m = -INFINITY;
    for (int s = threadIdx.x; s < spatial; s += kThreads)
      m = fmaxf(m, w_s[s * glimpses + g]);
    m = block_reduce(m, true, scratch);
    float sum = 0.0f;
    for (int s = threadIdx.x; s < spatial; s += kThreads) {
      const float e = expf(w_s[s * glimpses + g] - m);
      w_s[s * glimpses + g] = e;
      sum += e;
    }
    sum = block_reduce(sum, false, scratch);
    for (int s = threadIdx.x; s < spatial; s += kThreads)
      w_s[s * glimpses + g] /= sum;
  }
  __syncthreads();

  __shared__ float part_s[kGroups - 1][kMaxGlimpses][kChannels];
  const int lane = threadIdx.x % kChannels;
  const int group = threadIdx.x / kChannels;
  const int ch = blockIdx.x * kChannels + lane;
  float acc[kMaxGlimpses];
#pragma unroll
  for (int g = 0; g < kMaxGlimpses; ++g) acc[g] = 0.0f;
  if (ch < channels) {
    const T* vb = v + static_cast<size_t>(b) * spatial * channels + ch;
#pragma unroll 4
    for (int s = group; s < spatial; s += kGroups) {
      const float x = vqa::to_float(vb[static_cast<size_t>(s) * channels]);
#pragma unroll
      for (int g = 0; g < kMaxGlimpses; ++g)
        if (g < glimpses) acc[g] += w_s[s * glimpses + g] * x;
    }
  }
  if (group > 0) {
#pragma unroll
    for (int g = 0; g < kMaxGlimpses; ++g) part_s[group - 1][g][lane] = acc[g];
  }
  __syncthreads();
  if (group > 0 || ch >= channels) return;
  float* ob = out + static_cast<size_t>(b) * glimpses * channels + ch;
#pragma unroll
  for (int g = 0; g < kMaxGlimpses; ++g) {
    if (g >= glimpses) break;
    float total = acc[g];
    for (int p = 0; p < kGroups - 1; ++p) total += part_s[p][g][lane];
    ob[static_cast<size_t>(g) * channels] = total;
  }
}

template <typename T>
cudaError_t run(const void* v, const void* att, float* out, int batch,
                int spatial, int channels, int glimpses, cudaStream_t stream) {
  if (glimpses < 1 || glimpses > kMaxGlimpses) return cudaErrorInvalidValue;
  if (batch == 0 || channels == 0) return cudaSuccess;
  const dim3 grid((channels + kChannels - 1) / kChannels, batch);
  const size_t smem = static_cast<size_t>(spatial) * glimpses * sizeof(float);
  attention_pool_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(att), out, spatial,
      channels, glimpses);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vqa_attention_pool(const void* v, const void* att, void* out,
                                  int batch, int spatial, int channels,
                                  int glimpses, int dtype, void* stream) {
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vqa::kBFloat16:
      return run<__nv_bfloat16>(v, att, o, batch, spatial, channels, glimpses,
                                s);
    case vqa::kFloat32:
      return run<float>(v, att, o, batch, spatial, channels, glimpses, s);
    default:
      return cudaErrorInvalidValue;
  }
}
