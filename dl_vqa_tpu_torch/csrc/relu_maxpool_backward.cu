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
// and g, writes dz of y's size, and does a few dozen operations a byte at
// most. Two kernels, one chosen by a shape rule (vector_path below, which
// ops/conv_fused.py::pool_backward_vector_path mirrors):
//
// The vector kernel, where C is a multiple of the 16-byte vector (8 bf16
// or 4 f32 channels), C / vector divides the block, the four tensors sit
// on 16-byte boundaries and the pooled pixels fit 31 bits. A thread makes
// one pool window for one channel vector: it issues its four 16-byte loads
// of y (two rows, two columns) and the one of g before it uses any, then
// writes four 16-byte vectors of dz. A block takes kThreads / (C / vector)
// consecutive pooled pixels a step, their vectors fastest, so a warp's
// loads and stores are contiguous runs; the grid is persistent, sized to
// the blocks resident at once (kVectorBlocksPerSm an SM), and since
// the grid's stride in pixels is a whole number of blocks' steps, a
// thread's channel vector never changes: its bias sits in registers and
// its bias sums too. Indices are 32-bit, two divisions a window. The
// thread that makes the last window of a row or column also zeroes the odd
// last column or row beside it, by 16-byte stores, so every element of dz
// is written once. db: the lanes that share a vector add by shuffles, the
// warps (or the groups of threads, where a vector's lanes span warps) add
// in a fixed order through shared memory, and each block writes one row of
// partial sums.
//
// The scalar kernel, every other shape: a fixed grid of blocks walks the
// pooled rows (b, i); one thread makes the four dz values of one window
// for one channel, channels fastest. db: each thread sums what it routed
// (its channel is fixed when the block size is a multiple of C;
// shared-memory atomics otherwise), and the block writes one partial row.
//
// Either way a second small kernel adds the partial rows in a fixed order,
// so no global atomics are needed, and two grids run a call.

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

// The vector kernel: a thread's channels are one 16-byte vector of T, read
// and written as four 32-bit words of kPerWord elements each.
constexpr int kVectorBytes = 16;
constexpr int kVectorBlocksPerSm = 4;  // resident at once (<= 64 registers)
constexpr int64_t kMaxVectorPixels = int64_t{1} << 31;  // pooled, a call

template <typename T>
constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element h of a word: its bits in the low end, and its value.
template <typename T>
__device__ __forceinline__ unsigned element_bits(unsigned w, int h) {
  return kPerWord<T> == 1 ? w : (w >> (16 * h)) & 0xffffu;
}
template <typename T>
__device__ __forceinline__ float element_value(unsigned bits) {
  return __uint_as_float(kPerWord<T> == 1 ? bits : bits << 16);
}
// pooled_value of the element with these bits.
template <typename T>
__device__ __forceinline__ float pooled_bits(unsigned bits, float bias) {
  return vqa::to_float(
      vqa::from_float<T>(fmaxf(element_value<T>(bits) + bias, 0.0f)));
}

// Plain 16-byte loads and stores: the cache-streaming forms (__ldcs,
// __stcs) measured no faster, the loads slower.
__device__ __forceinline__ uint4 load16(const void* p) {
  return *static_cast<const uint4*>(p);
}
__device__ __forceinline__ void store16(void* p, uint4 v) {
  *static_cast<uint4*>(p) = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kVectorBlocksPerSm)
relu_maxpool_backward_vector_kernel(const T* __restrict__ g,     // [B,Hp,Wp,C]
                                    const T* __restrict__ y,     // [B,Hc,Wc,C]
                                    const float* __restrict__ bias,  // [C]
                                    T* __restrict__ dz,          // [B,Hc,Wc,C]
                                    float* __restrict__ partial,  // [grid, C]
                                    unsigned pixels, int hp, int wp, int hc,
                                    int wc, int channels) {
  constexpr int kPer = kPerWord<T>;
  constexpr int kVec = 4 * kPer;  // channels a thread
  __shared__ float red_s[kThreads * 8];  // the warps' or groups' sums
  const int vectors = channels / kVec;  // divides kThreads
  const int per_step = kThreads / vectors;
  const int ch = threadIdx.x % vectors * kVec;
  const int64_t in_row = static_cast<int64_t>(wc) * channels;
  const uint4 zeros = make_uint4(0, 0, 0, 0);

  float bv[kVec], acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    bv[c] = bias[ch + c];
    acc[c] = 0.0f;
  }
  const unsigned stride = gridDim.x * static_cast<unsigned>(per_step);
  for (unsigned p = blockIdx.x * per_step + threadIdx.x / vectors; p < pixels;
       p += stride) {
    const unsigned row = p / wp, b = row / hp;
    const int j = static_cast<int>(p - row * wp);
    const int i = static_cast<int>(row - b * hp);
    const int64_t at =
        ((static_cast<int64_t>(b) * hc + 2 * i) * wc + 2 * j) * channels + ch;
    // Every load of the window is in flight before any is used.
    const uint4 gr = load16(g + static_cast<int64_t>(p) * channels + ch);
    const uint4 raw[4] = {load16(y + at), load16(y + at + channels),
                          load16(y + at + in_row),
                          load16(y + at + in_row + channels)};
    unsigned out[4][4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const unsigned gw = word(gr, w);
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q][w] = 0u;
#pragma unroll
      for (int h = 0; h < kPer; ++h) {
        const int c = w * kPer + h;
        float z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          z[q] = pooled_bits<T>(element_bits<T>(word(raw[q], w), h), bv[c]);
        const float m = fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
        // The gate; then the first match in row-major window order takes
        // the cotangent (zero bits where the gate is shut).
        const unsigned gbits = m > 0.0f ? element_bits<T>(gw, h) : 0u;
        const int pick = z[0] == m ? 0 : z[1] == m ? 1 : z[2] == m ? 2 : 3;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (pick == q) out[q][w] |= gbits << (16 * h * (kPer - 1));
        acc[c] += element_value<T>(gbits);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t to = at + (q / 2) * in_row + (q % 2) * channels;
      store16(dz + to, make_uint4(out[q][0], out[q][1], out[q][2],
                                       out[q][3]));
    }
    // The odd last column beside the row's last window, and the odd last
    // row below the last row of windows (its corner too).
    const bool last_col = wc % 2 && j == wp - 1;
    if (last_col) {
      store16(dz + at + 2 * channels, zeros);
      store16(dz + at + in_row + 2 * channels, zeros);
    }
    if (hc % 2 && i == hp - 1) {
      const int64_t below = at + 2 * in_row;
      store16(dz + below, zeros);
      store16(dz + below + channels, zeros);
      if (last_col) store16(dz + below + 2 * channels, zeros);
    }
  }

  // db: lanes of one vector by shuffles (when a warp holds several of
  // them), then the warps or thread groups in a fixed order.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int groups;
  if (vectors < 32) {
    for (int off = vectors; off < 32; off *= 2)
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    groups = kThreads / 32;
    if (lane < vectors)
#pragma unroll
      for (int c = 0; c < kVec; ++c) red_s[warp * channels + ch + c] = acc[c];
  } else {
    groups = per_step;
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      red_s[(threadIdx.x / vectors) * channels + ch + c] = acc[c];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < channels; c += kThreads) {
    float sum = 0.0f;
    for (int r = 0; r < groups; ++r) sum += red_s[r * channels + c];
    partial[static_cast<int64_t>(blockIdx.x) * channels + c] = sum;
  }
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

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVectorBytes == 0;
}

int element_bytes(int dtype) {
  return dtype == vqa::kBFloat16 ? 2 : dtype == vqa::kFloat32 ? 4 : 0;
}

// The shape rule of the vector kernel.
bool vector_path(const void* g, const void* y, const void* bias,
                 const void* dz, int batch, int hc, int wc, int channels,
                 int dtype) {
  const int elem = element_bytes(dtype);
  if (elem == 0 || channels <= 0) return false;
  const int vec = kVectorBytes / elem;
  const int64_t pixels = static_cast<int64_t>(batch) * (hc / 2) * (wc / 2);
  return channels % vec == 0 && kThreads % (channels / vec) == 0 &&
         pixels < kMaxVectorPixels && aligned(g) && aligned(y) &&
         aligned(bias) && aligned(dz);
}

int blocks_for(bool vector, int batch, int hc, int wc, int channels,
               int dtype) {
  const int64_t rows = static_cast<int64_t>(batch) * (hc / 2);
  if (!vector) return static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return -1;
  const int per_step = kThreads / (channels / (kVectorBytes /
                                               element_bytes(dtype)));
  const int64_t steps = (rows * (wc / 2) + per_step - 1) / per_step;
  const int64_t resident = static_cast<int64_t>(sms) * kVectorBlocksPerSm;
  return static_cast<int>(steps < resident ? steps : resident);
}

template <typename T>
cudaError_t run(bool vector, const void* g, const void* y, const float* bias,
                void* dz, float* db, float* partial, int blocks, int batch,
                int hc, int wc, int channels, cudaStream_t stream) {
  if (vector) {
    relu_maxpool_backward_vector_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(y), bias,
        static_cast<T*>(dz), partial,
        static_cast<unsigned>(batch) * (hc / 2) * (wc / 2), hc / 2, wc / 2,
        hc, wc, channels);
  } else {
    const int64_t rows = static_cast<int64_t>(batch) * (hc / 2);
    relu_maxpool_backward_kernel<T>
        <<<blocks, kThreads, channels * sizeof(float), stream>>>(
            static_cast<const T*>(g), static_cast<const T*>(y), bias,
            static_cast<T*>(dz), partial, rows, hc, wc, channels);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(channels + 127) / 128, 128, 0, stream>>>(
      partial, db, blocks, channels);
  return cudaGetLastError();
}

}  // namespace

// 1 where a call with these arguments runs the vector kernel, 0 where it
// runs the scalar one.
extern "C" int vqa_relu_maxpool_backward_vector(const void* g, const void* y,
                                                const void* bias,
                                                const void* dz, int batch,
                                                int hc, int wc, int channels,
                                                int dtype) {
  return vector_path(g, y, bias, dz, batch, hc, wc, channels, dtype) ? 1 : 0;
}

// The number of blocks the main kernel of such a call runs, which is also
// the number of rows of `partial` the caller allocates (-1 if the device
// cannot be asked).
extern "C" int vqa_relu_maxpool_backward_blocks(const void* g, const void* y,
                                                const void* bias,
                                                const void* dz, int batch,
                                                int hc, int wc, int channels,
                                                int dtype) {
  return blocks_for(
      vector_path(g, y, bias, dz, batch, hc, wc, channels, dtype), batch, hc,
      wc, channels, dtype);
}

// Needs batch * (hc / 2) > 0, wc / 2 > 0 and channels * 4 bytes of shared
// memory under the 48 KB a launch gets without opting in.
extern "C" int vqa_relu_maxpool_backward(const void* g, const void* y,
                                         const void* bias, void* dz, void* db,
                                         void* partial, int batch, int hc,
                                         int wc, int channels, int dtype,
                                         void* stream) {
  if (batch * static_cast<int64_t>(hc / 2) == 0 || wc / 2 == 0 ||
      channels <= 0 || channels > 8192)
    return cudaErrorInvalidValue;
  const bool vector =
      vector_path(g, y, bias, dz, batch, hc, wc, channels, dtype);
  const int blocks = blocks_for(vector, batch, hc, wc, channels, dtype);
  if (blocks <= 0) return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  float* dbp = static_cast<float*>(db);
  float* pp = static_cast<float*>(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vqa::kBFloat16:
      return run<__nv_bfloat16>(vector, g, y, b, dz, dbp, pp, blocks, batch,
                                hc, wc, channels, s);
    case vqa::kFloat32:
      return run<float>(vector, g, y, b, dz, dbp, pp, blocks, batch, hc, wc,
                        channels, s);
    default:
      return cudaErrorInvalidValue;
  }
}
