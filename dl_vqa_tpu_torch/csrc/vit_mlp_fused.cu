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
// Design, bf16 (warpgroup MMA, wgmma.cuh). A block has one or two consumer
// warpgroups of 64 rows each (the wrapper's row plan, ops/vit_mlp_fused.py::
// row_plan, takes two where the rows fill the card's SMs, so that every
// weight byte fetched from L2 serves 128 rows). Each warpgroup normalises its
// rows (a warp a row, f32 statistics by shuffles) into a 128-byte-swizzled
// tile in shared memory, the A operand of the first product. Neither the
// weights (2 x 0.5 MB) nor the hidden rows fit in shared memory, so the block
// walks F in chunks of 64: a first grid of the same call packs W1 and W2
// chunk by chunk into wgmma's swizzled layout (ops/vit_mlp_fused.py::
// pack_weights is its plain version), so that a chunk of both is one run of
// memory, copied by cp.async into one of two stages while the chunk before
// is used.
// The first product, wgmma m64n64k16 with both operands in shared memory,
// leaves h_c [64, 64] in f32 registers; bias, ReLU and the bf16 cast happen
// there, and the rounded pairs are, as they lie, the register A operand of
// the second product, wgmma m64nDk16 (B = the W2 chunk), which adds
// h_c . W2_c^T to the [64, D] accumulator held in registers for the whole
// walk. The hidden chunk never touches shared memory: one block barrier a
// chunk, where its stage is handed back. Every row sums over k in the same
// order whatever the plan, so a row's bits do not depend on the batch.
// f32 goes through plain FMAs with 64-row blocks, which keeps the f32
// products exact rather than rounding them to TF32.

#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"


namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // the f32 kernel
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

constexpr int kChunk = 64;     // hidden units a step of the walk takes
constexpr int kWgRows = 64;    // rows a warpgroup takes (wgmma's M)
constexpr int kWgThreads = 128;

// Shared memory of the bf16 kernel, in bytes from a 1024-byte boundary:
// the warpgroups' swizzled ln tiles [D / 64][64][64], then two stages of one
// packed chunk of W1 ([D / 64][64][64]) and of W2 ([D][64]).
template <int kD, int kWarpgroups>
struct Bf16Layout {
  static constexpr int kLnBytes = kWgRows * kD * 2;  // a warpgroup's tile
  static constexpr int kChunkBytes = kChunk * kD * 2;  // W1's or W2's chunk
  static constexpr int kStagesAt = kWarpgroups * kLnBytes;  // offset
  static constexpr int kBytes = kStagesAt + 2 * 2 * kChunkBytes;
  static constexpr int kLaunchBytes = kBytes + vqa::wgmma::kAtomBytes;
};

// Layer norm of this warpgroup's 64 rows into its swizzled tile, a warp a
// row; rows at or beyond `rows` become zero.
template <int kD>
__device__ __forceinline__ void layer_norm_swizzled(
    const bf16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, unsigned char* ln_s, int64_t row0,
    int64_t rows) {
  constexpr int kPer = kD / 32;  // neighbouring columns a lane takes
  const int warp = threadIdx.x % kWgThreads / 32, lane = threadIdx.x % 32;
  const int col0 = lane * kPer;
  for (int r = warp; r < kWgRows; r += 4) {
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        ln_s + vqa::wgmma::swizzle_offset(r, col0, kWgRows));
    if (row0 + r >= rows) {
#pragma unroll
      for (int e = 0; e < kPer / 2; ++e)
        dst[e] = __floats2bfloat162_rn(0.0f, 0.0f);
      continue;
    }
    const bf16* src = x + (row0 + r) * kD + col0;
    float v[kPer], sum = 0.0f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      v[e] = __bfloat162float(src[e]);
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
    for (int e = 0; e < kPer; ++e)  // rounded after each step, as the plain
      v[e] = __fadd_rn(                // version rounds
          __fmul_rn(__fmul_rn(v[e], inv), scale[col0 + e]), shift[col0 + e]);
#pragma unroll
    for (int e = 0; e < kPer / 2; ++e)
      dst[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  }
}

template <int kD, int kWarpgroups>
__global__ void __launch_bounds__(kWgThreads * kWarpgroups, 1)
ln_mlp_wgmma_kernel(const bf16* __restrict__ x,       // [rows, D]
                    const float* __restrict__ scale,  // [D]
                    const float* __restrict__ shift,  // [D]
                    const bf16* __restrict__ w1p,     // W1, packed
                    const float* __restrict__ b1,     // [F]
                    const bf16* __restrict__ w2p,     // W2, packed
                    const float* __restrict__ b2,     // [D]
                    bf16* __restrict__ out,           // [rows, D]
                    int64_t rows, int hidden) {
  namespace wg = vqa::wgmma;
  using L = Bf16Layout<kD, kWarpgroups>;
  constexpr int kThreadsHere = kWgThreads * kWarpgroups;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  unsigned char* smem =
      smem_raw + ((wg::kAtomBytes - raw % wg::kAtomBytes) % wg::kAtomBytes);
  const int tid = threadIdx.x, group = tid / kWgThreads;
  const int warp = tid % kWgThreads / 32, lane = tid % 32;
  const int g = lane / 4, c2 = lane % 4 * 2;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * kWgRows * kWarpgroups +
      group * kWgRows;
  unsigned char* ln_s = smem + group * L::kLnBytes;
  unsigned char* stages = smem + L::kStagesAt;

  // Asynchronous copies of chunk `chunk` of both packed weights into stage
  // `chunk % 2`: each is one run of kChunkBytes, in flight while the chunk
  // before is used.
  auto stage_chunk = [&](int chunk) {
    unsigned char* dst = stages + (chunk & 1) * 2 * L::kChunkBytes;
    const unsigned char* src1 = reinterpret_cast<const unsigned char*>(w1p) +
                                static_cast<int64_t>(chunk) * L::kChunkBytes;
    const unsigned char* src2 = reinterpret_cast<const unsigned char*>(w2p) +
                                static_cast<int64_t>(chunk) * L::kChunkBytes;
    for (int e = tid; e < L::kChunkBytes / 16; e += kThreadsHere) {
      __pipeline_memcpy_async(dst + 16 * e, src1 + 16 * e, 16);
      __pipeline_memcpy_async(dst + L::kChunkBytes + 16 * e, src2 + 16 * e,
                              16);
    }
    __pipeline_commit();
  };

  const int chunks = hidden / kChunk;
  stage_chunk(0);
  layer_norm_swizzled<kD>(x, scale, shift, ln_s, row0, rows);

  float acc[kD / 2];  // [64, D] of this warpgroup
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.0f;
  float h[kChunk / 2];  // h_c [64, 64] before bias and ReLU
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) h[i] = 0.0f;
  const uint32_t ln_addr = wg::smem_addr(ln_s);

  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk + 1 < chunks) {
      stage_chunk(chunk + 1);
      __pipeline_wait_prior(1);  // this chunk has landed, the next may fly
    } else {
      __pipeline_wait_prior(0);
    }
    wg::fence_shared();  // cp.async and ln stores, before wgmma reads them
    __syncthreads();
    const uint32_t w1_addr =
        wg::smem_addr(stages + (chunk & 1) * 2 * L::kChunkBytes);
    const uint32_t w2_addr = w1_addr + L::kChunkBytes;

    // h_c = ln . W1_c^T: K = D in k16 steps, atom by atom.
    wg::fence_operand(h);
    wg::fence();
#pragma unroll
    for (int s = 0; s < kD / 16; ++s) {
      const uint32_t step = (s / 4) * kWgRows * 128 + (s % 4) * 32;
      wg::mma_ss<kChunk>(h, wg::desc(ln_addr + step),
                         wg::desc(w1_addr + step), s > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(h);

    // Bias, ReLU and the cast in registers; the bf16 pairs are the A
    // operand of the second product as they lie.
    const int c0 = chunk * kChunk;
    unsigned hb[kChunk / 8][2];
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      const float bias0 = b1[c0 + 8 * j + c2], bias1 = b1[c0 + 8 * j + c2 + 1];
      hb[j][0] = wg::pack_bf16(fmaxf(h[4 * j] + bias0, 0.0f),
                               fmaxf(h[4 * j + 1] + bias1, 0.0f));
      hb[j][1] = wg::pack_bf16(fmaxf(h[4 * j + 2] + bias0, 0.0f),
                               fmaxf(h[4 * j + 3] + bias1, 0.0f));
    }

    // acc += h_c . W2_c^T: K = the chunk's 64 hidden units, one atom.
    wg::fence_operand(acc);
    wg::fence();
#pragma unroll
    for (int s = 0; s < kChunk / 16; ++s) {
      unsigned a[4];
      wg::accumulator_to_a(a, hb[2 * s], hb[2 * s + 1]);
      wg::mma_rs<kD>(acc, a, wg::desc(w2_addr + 32 * s), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc);
    __syncthreads();  // this stage may now take the chunk after the next
  }

  // out = cast(x + (acc + b2)), two neighbouring columns a store.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = row0 + warp * 16 + g + 8 * half;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + c2;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(x + row * kD + col));
      *reinterpret_cast<__nv_bfloat162*>(out + row * kD + col) =
          __floats2bfloat162_rn(
              xv.x + (acc[4 * j + 2 * half] + b2[col]),
              xv.y + (acc[4 * j + 2 * half + 1] + b2[col + 1]));
    }
  }
}

// W1 [F, D] and W2 [D, F] into `packed` [2][F D]: for each chunk of 64
// hidden units, W1's rows as [D / 64][64][64] and W2's columns as [D][64],
// K-major, the 16-byte piece p of row r at p ^ (r % 8); a thread a piece.
template <int kD>
__global__ void pack_weights_kernel(const bf16* __restrict__ w1,
                                    const bf16* __restrict__ w2,
                                    bf16* __restrict__ packed, int hidden) {
  const int64_t pieces = static_cast<int64_t>(hidden) * kD / 8;  // a weight
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= 2 * pieces) return;
  const int64_t i = q % pieces;  // the piece of its packed weight
  const int chunk = static_cast<int>(i / (8 * kD));
  const int at = static_cast<int>(i % (8 * kD)), piece = at % 8;
  const bf16* src;
  if (q < pieces) {
    const int atom = at / (8 * kChunk), r = at / 8 % kChunk;
    src = w1 + static_cast<int64_t>(chunk * kChunk + r) * kD + atom * 64 +
          (piece ^ r % 8) * 8;
  } else {
    const int d = at / 8;
    src = w2 + static_cast<int64_t>(d) * hidden + chunk * kChunk +
          (piece ^ d % 8) * 8;
  }
  reinterpret_cast<uint4*>(packed)[q] = *reinterpret_cast<const uint4*>(src);
}

template <int kD, int kWarpgroups>
cudaError_t run_wgmma(const void* x, const float* scale, const float* shift,
                      const void* w1, const float* b1, const void* w2,
                      const float* b2, void* out, void* packed, int64_t rows,
                      int hidden, cudaStream_t stream) {
  using L = Bf16Layout<kD, kWarpgroups>;
  bf16* w1p = static_cast<bf16*>(packed);
  bf16* w2p = w1p + static_cast<int64_t>(hidden) * kD;
  const int64_t pieces = static_cast<int64_t>(hidden) * kD / 4;  // both
  pack_weights_kernel<kD><<<static_cast<unsigned>((pieces + 255) / 256), 256,
                            0, stream>>>(static_cast<const bf16*>(w1),
                                         static_cast<const bf16*>(w2), w1p,
                                         hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static_assert(L::kLaunchBytes <= kMaxShared, "the bf16 tiles fit a block");
  auto kernel = ln_mlp_wgmma_kernel<kD, kWarpgroups>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kLaunchBytes);
  if (err != cudaSuccess) return err;
  constexpr int kBlockRows = kWgRows * kWarpgroups;
  const unsigned blocks =
      static_cast<unsigned>((rows + kBlockRows - 1) / kBlockRows);
  kernel<<<blocks, kWgThreads * kWarpgroups, L::kLaunchBytes, stream>>>(
      static_cast<const bf16*>(x), scale, shift, w1p, b1, w2p, b2,
      static_cast<bf16*>(out), rows, hidden);
  return cudaGetLastError();
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
                const float* b2, void* out, void* packed, int64_t rows,
                int hidden, int warpgroups, int dtype, cudaStream_t stream) {
  if (dtype == vqa::kBFloat16) {
    if (warpgroups == 1)
      return run_wgmma<kD, 1>(x, scale, shift, w1, b1, w2, b2, out, packed,
                              rows, hidden, stream);
    if (warpgroups == 2)
      return run_wgmma<kD, 2>(x, scale, shift, w1, b1, w2, b2, out, packed,
                              rows, hidden, stream);
    return cudaErrorInvalidValue;
  }
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
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
  return cudaGetLastError();
}

}  // namespace

// x [rows, D], scale, shift [D] f32, w1 [F, D] and w2 [D, F] of x's type,
// b1 [F] and b2 [D] f32 -> out [rows, D]. bf16: `packed` is scratch of
// 2 F D values that the first of the two grids fills with both weights in
// wgmma's layout (ops/vit_mlp_fused.py::pack_weights), and `warpgroups`
// (1 or 2) 64-row warpgroups a block (ops/vit_mlp_fused.py::row_plan); f32
// takes neither. D is 64, 128 or 256 and F a multiple of 64;
// cudaErrorInvalidValue for anything else, with nothing launched.
extern "C" int vqa_vit_mlp_fused(const void* x, const void* scale,
                                 const void* shift, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* out, void* packed,
                                 int rows, int dim, int hidden,
                                 int warpgroups, int dtype, void* stream) {
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
      return run<64>(x, sc, sh, w1, c1, w2, c2, out, packed, rows, hidden,
                     warpgroups, dtype, s);
    case 128:
      return run<128>(x, sc, sh, w1, c1, w2, c2, out, packed, rows, hidden,
                      warpgroups, dtype, s);
    case 256:
      return run<256>(x, sc, sh, w1, c1, w2, c2, out, packed, rows, hidden,
                      warpgroups, dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}
