// Layer norm + ReLU MLP + residual of a ViT block in one pass (kernel 8 of the
// port).
//
// Replaces experiments/probe_vit_mlp_fused.py::_kernel. Per token row x [D],
// with W1 [F, D] and W2 [D, F] in the port's [out, in] layout:
//   ln  = cast((x - mean) * rsqrt(var + 1e-5) * scale + shift)    (f32 inside)
//   h   = cast(relu(f32(ln . W1^T) + b1))
//   out = cast(f32(x) + f32(h . W2^T) + b2)
// with products of operands rounded to x's type and f32 sums; the residual is
// added to the f32 accumulator before the one cast. The TPU kernel walks
// images because its compiler has no batched product; LN and both products
// are per row, so here the rows of [B * S, D] are tiled and image borders are
// ignored.
//
// What bounds it on this card: operations. At batch 512 (100,352 rows,
// D = 256, F = 1024) the two products are 105 GFLOP (0.11 ms at the bf16
// tensor cores' rate) against 51 MB read and 51 MB written (0.03 ms). The
// unfused block writes ln, the [rows, F] hidden tensor and the MLP output to
// device memory and reads them back, in f32 copies besides; here x is read
// and out is written, nothing else.
//
// Design, bf16. A block takes 64 rows: a warp a row for the LN statistics
// (f32, shuffles), ln rounded into shared memory. Neither the weights
// (2 x 0.5 MB) nor a tile's hidden rows in f32 fit in shared memory, so the
// block walks F in chunks of 64: it stages W1[c : c + 64, :] and
// W2[:, c : c + 64] (they stream from L2, by asynchronous copies into one of
// two stages, so that a chunk lands while the one before is used), makes h_c = cast(relu(ln . W1_c^T
// + b1_c)) [64, 64] in shared memory, and adds h_c . W2_c^T to the [64, D]
// accumulators, which stay in registers for the whole walk (warp (mw, nw):
// rows 32 mw .. 32 mw + 31, columns nw D / 4 ...). Operands come from shared
// memory by ldmatrix, products are mma.sync m16n8k16 with f32 accumulators
// (through wmma's fragment loads and a scratch buffer for every epilogue the
// kernel took half as long again); both weights are stored [n][k], which is
// the column-major B operand as it stands, so neither is transposed, and
// the accumulator's known layout lets bias, ReLU, the residual and the casts
// happen in registers. f32 goes through plain FMAs with the same tiling,
// which keeps the f32 products exact rather than rounding them to TF32.

#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;  // rows a block takes
constexpr float kEps = 1e-5f;
constexpr int kMaxShared = 232448;  // bytes a block may have on sm_90

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Layer norm of rows row0 .. row0 + kRows - 1 into ln_s[kRows][ld], a warp a
// row and kD / 32 neighbouring columns a lane; rows at or beyond `rows`
// become zero.
template <typename T, int kD>
__device__ __forceinline__ void layer_norm_rows(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, T* ln_s, int ld, int64_t row0,
    int64_t rows) {
  constexpr int kPer = kD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    T* dst = ln_s + r * ld + lane * kPer;
    if (row0 + r >= rows) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) dst[e] = vqa::from_float<T>(0.0f);
      continue;
    }
    const T* src = x + (row0 + r) * kD + lane * kPer;
    float v[kPer], sum = 0.0f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      v[e] = vqa::to_float(src[e]);
      sum += v[e];
    }
    const float mean = warp_sum(sum) / kD;
    float sq = 0.0f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      v[e] -= mean;
      sq += v[e] * v[e];
    }
    const float inv = rsqrtf(warp_sum(sq) / kD + kEps);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int col = lane * kPer + e;
      // Rounded after each step, as the plain version rounds.
      dst[e] = vqa::from_float<T>(__fadd_rn(
          __fmul_rn(__fmul_rn(v[e], inv), scale[col]), shift[col]));
    }
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kChunk = 64;      // hidden units a step of the walk takes
constexpr int kOperandPad = 8;  // rows stay 16-byte multiples and the eight
                                // rows of an ldmatrix phase miss each other's
                                // banks

template <int kD>
struct Bf16Layout {
  static constexpr int kLnLd = kD + kOperandPad;         // ln_s, w1_s rows
  static constexpr int kChunkLd = kChunk + kOperandPad;  // h_s, w2_s rows
  // Elements of one stage of weights: W1's chunk, then W2's.
  static constexpr int kW1Elems = kChunk * kLnLd;
  static constexpr int kStageElems = kW1Elems + kD * kChunkLd;
  static constexpr size_t kLn = 0;
  static constexpr size_t kH = kLn + sizeof(bf16) * kRows * kLnLd;
  static constexpr size_t kStages = kH + sizeof(bf16) * kRows * kChunkLd;
  static constexpr size_t kBytes = kStages + 2 * sizeof(bf16) * kStageElems;
};

template <int kD>
__global__ void __launch_bounds__(kThreads)
ln_mlp_mma_kernel(const bf16* __restrict__ x,       // [rows, D]
                  const float* __restrict__ scale,  // [D]
                  const float* __restrict__ shift,  // [D]
                  const bf16* __restrict__ w1,      // [F, D]
                  const float* __restrict__ b1,     // [F]
                  const bf16* __restrict__ w2,      // [D, F]
                  const float* __restrict__ b2,     // [D]
                  bf16* __restrict__ out,           // [rows, D]
                  int64_t rows, int hidden) {
  using L = Bf16Layout<kD>;
  constexpr int kBlocks = kD / 32;  // 8-column blocks of a warp's output
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ln_s = reinterpret_cast<bf16*>(smem + L::kLn);  // [kRows][kLnLd]
  bf16* h_s = reinterpret_cast<bf16*>(smem + L::kH);    // [kRows][kChunkLd]
  // Two stages of [kChunk][kLnLd] of W1 and [kD][kChunkLd] of W2.
  bf16* stages = reinterpret_cast<bf16*>(smem + L::kStages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mw = warp % 2, nw = warp / 2;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  // ldmatrix row addresses of this lane. A operands are [rows][k] blocks of
  // 16 x 16: row lane % 16, k half lane / 16. B operands are stored [n][k]
  // (W1 as [f][d], W2 as [d][f], the port's [out, in]), which is mma's
  // column-major B: matrices (n 0..7, k 0..7), (n 0..7, k 8..15), (n 8..15,
  // k 0..7), (n 8..15, k 8..15), no transposition.
  const int a_row = lane % 16, a_col = lane / 16 * 8;
  const int b_row = lane / 16 * 8 + lane % 8, b_col = lane / 8 % 2 * 8;
  // The accumulator's rows and columns of this lane.
  const int g = lane / 4, c2 = lane % 4 * 2;

  layer_norm_rows<bf16, kD>(x, scale, shift, ln_s, L::kLnLd, row0, rows);

  // [64, D] output: warp (mw, nw) makes rows 32 mw .. + 31 (two 16-row
  // tiles), columns nw D / 4 .. (kBlocks blocks of 8).
  float acc[2][kBlocks][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kBlocks; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.0f;

  // Asynchronous copies (cp.async) of chunk `chunk` of both weights into
  // stage `chunk % 2`: they are in flight while the chunk before is used.
  auto stage_chunk = [&](int chunk) {
    bf16* w1_s = stages + (chunk & 1) * L::kStageElems;
    bf16* w2_s = w1_s + L::kW1Elems;
    const int c0 = chunk * kChunk;
    for (int e = tid; e < kChunk * (kD / 8); e += kThreads) {
      const int f = e / (kD / 8), v = e % (kD / 8);
      __pipeline_memcpy_async(w1_s + f * L::kLnLd + v * 8,
                              w1 + static_cast<int64_t>(c0 + f) * kD + v * 8,
                              16);
    }
    for (int e = tid; e < kD * (kChunk / 8); e += kThreads) {
      const int d = e / (kChunk / 8), v = e % (kChunk / 8);
      __pipeline_memcpy_async(
          w2_s + d * L::kChunkLd + v * 8,
          w2 + static_cast<int64_t>(d) * hidden + c0 + v * 8, 16);
    }
    __pipeline_commit();
  };

  const int chunks = hidden / kChunk;
  stage_chunk(0);
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int c0 = chunk * kChunk;
    if (chunk + 1 < chunks) {
      stage_chunk(chunk + 1);
      __pipeline_wait_prior(1);  // this chunk has landed, the next may fly
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // (the first time, ln_s is written too)
    const bf16* w1_s = stages + (chunk & 1) * L::kStageElems;
    const bf16* w2_s = w1_s + L::kW1Elems;

    // h_c [64, 64]: the warp makes rows 32 mw .. + 31, columns 16 nw .. + 15.
    float hacc[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) hacc[m][n][q] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kD; kk += 16) {
      unsigned a[2][4], wb[4];
      vqa::ldmatrix_x4(
          wb, w1_s + (nw * 16 + b_row) * L::kLnLd + kk + b_col);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        vqa::ldmatrix_x4(
            a[m], ln_s + ((2 * mw + m) * 16 + a_row) * L::kLnLd + kk + a_col);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        vqa::mma_bf16(hacc[m][0], a[m], wb[0], wb[1]);
        vqa::mma_bf16(hacc[m][1], a[m], wb[2], wb[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = nw * 16 + n * 8 + c2;
        const float bias0 = b1[c0 + col], bias1 = b1[c0 + col + 1];
        bf16* dst = h_s + ((2 * mw + m) * 16 + g) * L::kChunkLd + col;
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
            fmaxf(hacc[m][n][0] + bias0, 0.0f),
            fmaxf(hacc[m][n][1] + bias1, 0.0f));
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * L::kChunkLd) =
            __floats2bfloat162_rn(fmaxf(hacc[m][n][2] + bias0, 0.0f),
                                  fmaxf(hacc[m][n][3] + bias1, 0.0f));
      }
    __syncthreads();

    // acc += h_c . W2_c^T.
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        vqa::ldmatrix_x4(
            a[m], h_s + ((2 * mw + m) * 16 + a_row) * L::kChunkLd + kk + a_col);
#pragma unroll
      for (int n = 0; n < kBlocks; n += 2) {
        unsigned wb[4];
        vqa::ldmatrix_x4(wb, w2_s + (nw * (kD / 4) + n * 8 + b_row) *
                                     L::kChunkLd + kk + b_col);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          vqa::mma_bf16(acc[m][n], a[m], wb[0], wb[1]);
          vqa::mma_bf16(acc[m][n + 1], a[m], wb[2], wb[3]);
        }
      }
    }
    __syncthreads();  // this stage may now take the chunk after the next
  }

  // out = cast(x + (acc + b2)), two neighbouring columns a store.
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = row0 + (2 * mw + m) * 16 + g + 8 * half;
      if (row >= rows) continue;
#pragma unroll
      for (int n = 0; n < kBlocks; ++n) {
        const int col = nw * (kD / 4) + n * 8 + c2;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + row * kD + col));
        *reinterpret_cast<__nv_bfloat162*>(out + row * kD + col) =
            __floats2bfloat162_rn(
                xv.x + (acc[m][n][2 * half] + b2[col]),
                xv.y + (acc[m][n][2 * half + 1] + b2[col + 1]));
      }
    }
}

// ---------------------------------------------------------------- f32

constexpr int kChunkF32 = 32;

template <int kD>
struct F32Layout {
  static constexpr int kLnLd = kD + 1;             // ln_s, w1_s rows
  static constexpr int kChunkLd = kChunkF32 + 1;   // h_s, w2_s rows
  static constexpr size_t kLn = 0;
  static constexpr size_t kW1 = kLn + kRows * kLnLd;
  static constexpr size_t kW2 = kW1 + kChunkF32 * kLnLd;
  static constexpr size_t kH = kW2 + kD * kChunkLd;
  static constexpr size_t kBytes = sizeof(float) * (kH + kRows * kChunkLd);
};

template <int kD>
__global__ void __launch_bounds__(kThreads)
ln_mlp_fma_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ out, int64_t rows, int hidden) {
  using L = F32Layout<kD>;
  constexpr int kCols = kD / 32;  // output columns a lane makes
  extern __shared__ __align__(128) unsigned char smem[];
  float* base = reinterpret_cast<float*>(smem);
  float* ln_s = base + L::kLn;  // [kRows][kLnLd]
  float* w1_s = base + L::kW1;  // [kChunkF32][kLnLd]
  float* w2_s = base + L::kW2;  // [kD][kChunkLd]
  float* h_s = base + L::kH;    // [kRows][kChunkLd]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;

  layer_norm_rows<float, kD>(x, scale, shift, ln_s, L::kLnLd, row0, rows);

  // The warp makes rows 8 warp .. 8 warp + 7; a lane makes hidden unit
  // `lane` of the chunk, then output columns lane, lane + 32, ...
  float acc[8][kCols];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;

  for (int c0 = 0; c0 < hidden; c0 += kChunkF32) {
    __syncthreads();
    for (int e = tid; e < kChunkF32 * kD; e += kThreads)
      w1_s[e / kD * L::kLnLd + e % kD] =
          w1[static_cast<int64_t>(c0 + e / kD) * kD + e % kD];
    for (int e = tid; e < kD * kChunkF32; e += kThreads)
      w2_s[e / kChunkF32 * L::kChunkLd + e % kChunkF32] =
          w2[static_cast<int64_t>(e / kChunkF32) * hidden + c0 + e % kChunkF32];
    __syncthreads();

    float hacc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) hacc[r] = 0.0f;
    for (int d = 0; d < kD; ++d) {
      const float wv = w1_s[lane * L::kLnLd + d];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        hacc[r] = fmaf(ln_s[(warp * 8 + r) * L::kLnLd + d], wv, hacc[r]);
    }
    const float bias = b1[c0 + lane];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      h_s[(warp * 8 + r) * L::kChunkLd + lane] = fmaxf(hacc[r] + bias, 0.0f);
    __syncwarp();  // the warp reads back only the rows it wrote

    for (int f = 0; f < kChunkF32; ++f) {
      float wv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        wv[j] = w2_s[(lane + 32 * j) * L::kChunkLd + f];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float hv = h_s[(warp * 8 + r) * L::kChunkLd + f];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(hv, wv[j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t row = row0 + warp * 8 + r;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = lane + 32 * j;
      out[row * kD + col] = x[row * kD + col] + (acc[r][j] + b2[col]);
    }
  }
}

template <int kD>
cudaError_t run(const void* x, const float* scale, const float* shift,
                const void* w1, const float* b1, const void* w2,
                const float* b2, void* out, int64_t rows, int hidden,
                int dtype, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  if (dtype == vqa::kBFloat16) {
    auto kernel = ln_mlp_mma_kernel<kD>;
    constexpr size_t shared = Bf16Layout<kD>::kBytes;
    static_assert(shared <= kMaxShared, "the bf16 tiles fit a block");
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, shared, stream>>>(
        static_cast<const bf16*>(x), scale, shift,
        static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
        static_cast<bf16*>(out), rows, hidden);
  } else {
    auto kernel = ln_mlp_fma_kernel<kD>;
    constexpr size_t shared = F32Layout<kD>::kBytes;
    static_assert(shared <= kMaxShared, "the f32 tiles fit a block");
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, shared, stream>>>(
        static_cast<const float*>(x), scale, shift,
        static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2,
        static_cast<float*>(out), rows, hidden);
  }
  return cudaGetLastError();
}

}  // namespace

// x [rows, D], scale, shift [D] f32, w1 [F, D] and w2 [D, F] of x's type,
// b1 [F] and b2 [D] f32 -> out [rows, D]. D is 64, 128 or 256 and F a
// multiple of 64; cudaErrorInvalidValue for anything else.
extern "C" int vqa_vit_mlp_fused(const void* x, const void* scale,
                                 const void* shift, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* out, int rows,
                                 int dim, int hidden, int dtype,
                                 void* stream) {
  if (dtype != vqa::kBFloat16 && dtype != vqa::kFloat32)
    return cudaErrorInvalidValue;
  if (hidden < kChunk || hidden % kChunk) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* c1 = static_cast<const float*>(b1);
  const float* c2 = static_cast<const float*>(b2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 64:
      return run<64>(x, sc, sh, w1, c1, w2, c2, out, rows, hidden, dtype, s);
    case 128:
      return run<128>(x, sc, sh, w1, c1, w2, c2, out, rows, hidden, dtype, s);
    case 256:
      return run<256>(x, sc, sh, w1, c1, w2, c2, out, rows, hidden, dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}
