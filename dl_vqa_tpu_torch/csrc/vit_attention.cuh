// Shared by the ViT attention kernels (vit_attention.cu and
// vit_attention_backward.cu): the packed-qkv layout, staging of one 64-wide
// column slice of a head into shared memory, the tensor-core tiling of the
// bf16 paths, and warp reductions.
//
// qkv is [B, S, 3 * H * D] with D = 64 n: q | k | v, each head-major, so
// head h's q, k and v rows are D-element slices of a row of 3 * H * D
// elements, at columns h * D, H * D + h * D and 2 * H * D + h * D. The
// kernels stage a head 64 columns (one slice) at a time, so shared memory
// does not grow with D; a head of 64 is one slice. They compute these
// offsets themselves; nothing is split or transposed before the launch.
//
// A tensor-core tile has 16 rows, so S is padded to a multiple of 16 in
// shared memory: staged rows at or beyond S are zero, padded key columns get
// weight zero, and padded query rows are computed and never stored.
#pragma once

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

namespace vqa_vit {

constexpr int kSlice = 64;          // columns of a staged head slice
constexpr float kScale = 0.125f;    // 1 / sqrt(64): a head of one slice
constexpr int kMaxShared = 232448;  // bytes a block may have on sm_90

__host__ __device__ inline int padded(int seq) { return (seq + 15) & ~15; }

// ------------------------------------------------------- f32 (plain FMAs)

// Leading dimension of a staged [rows][64] f32 slice: 65 floats makes a
// column walk (one row per lane) conflict-free.
constexpr int kLdF32 = 65;

// Leading dimension of a warp's f32 score buffer [16][score_ld]: no
// multiple of 32 words.
__host__ __device__ inline int score_ld(int sp) { return sp + 4; }

// Copy rows row0 .. row0 + rows - 1 of an f32 head slice (src points at row
// 0 of the image, at the slice's first column; row_stride in elements) into
// dst[rows][ld], by 16-byte global loads; rows at or beyond seq become
// zero. Called by `count` threads with ranks `rank`.
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int row_stride,
                                           int row0, int rows, int seq,
                                           int rank, int count) {
  for (int i = rank; i < rows * (kSlice / 4); i += count) {
    const int r = i / (kSlice / 4), c = (i % (kSlice / 4)) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < seq)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * row_stride + c);
    float* d = dst + r * ld + c;  // rows of 65 floats are not 16-byte aligned
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------- bf16 (ldmatrix + mma)

using bf16 = __nv_bfloat16;

// A staged bf16 head slice is [rows][64], 128 bytes a row with no padding:
// the eight 16-byte chunks of row r lie in the order c ^ (r % 8) (the
// layout TMA's 128-byte swizzle gives). The eight rows that one ldmatrix
// phase reads, or that the eight row groups of an accumulator write, then
// fall on eight different chunks of the 32 banks.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kSlice + ((chunk ^ (row & 7)) << 3);
}

// Asynchronous 16-byte copy global -> shared; with `valid` false it reads
// nothing and writes 16 zero bytes (cp.async's src-size operand 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Start copying rows row0 .. row1 - 1 of a bf16 head slice (src at row 0 of
// the image, at the slice's first column) into rows 0 .. row1 - row0 - 1
// of dst, swizzled (row0 is a multiple of 8); rows at or beyond seq are
// zero-filled. Called by `count` threads with ranks `rank`.
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                            int row_stride, int row0,
                                            int row1, int seq, int rank,
                                            int count) {
  for (int i = rank; i < (row1 - row0) * 8; i += count) {
    const int r = row0 + i / 8, c = i % 8;
    const bool valid = r < seq;
    cp_async16(dst + swz(i / 8, c),
               src + (valid ? static_cast<size_t>(r) * row_stride + c * 8 : 0),
               valid);
  }
}

// Multiply the eight bf16 values of an A fragment by 1 / sqrt(64) = 2^-3:
// exact, so the product of the scaled fragment is the scaled product, to
// the bit, and the scores need no multiplication of their own (a head of one
// slice; wider heads multiply the f32 scores by their scale).
__device__ __forceinline__ void scale_fragment(unsigned (&a)[4]) {
  const __nv_bfloat162 s = __float2bfloat162_rn(kScale);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 x =
        __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]), s);
    a[i] = *reinterpret_cast<const unsigned*>(&x);
  }
}

// The lane's ldmatrix row and chunk for the three operand shapes, on a
// staged slice at a 16-row base and a 16-column (two-chunk) base:
//  A [rows][k]: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
//    (8-15, 8-15) = a[0..3] of mma.m16n8k16;
//  B stored [n][k] (mma's column-major B as it stands): (n 0-7, k 0-7),
//    (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) = b0, b1 of the n8 tile 0,
//    then of tile 1;
//  B stored [k][n] (row-major, taken with .trans): (k 0-7, n 0-7),
//    (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) = b0, b1 of tile 0, then 1.
struct Lanes {
  int a_row, a_chunk, bn_row, bn_chunk, bk_row, bk_chunk;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane % 16), a_chunk(lane / 16),
        bn_row(lane / 16 * 8 + lane % 8), bn_chunk(lane / 8 % 2),
        bk_row(lane % 8 + lane / 8 % 2 * 8), bk_chunk(lane / 16) {}
};

// Two f32 values rounded to bf16 in one register, the first in the low
// half: one k-pair of an A fragment.
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}
__device__ __forceinline__ float2 unpack2(unsigned x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Four-lane (quad) reductions: the lanes 4g .. 4g + 3 hold one accumulator
// row between them.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The tiled kernels keep a whole score row in registers, so the number of
// 16-key tiles is a compile-time constant: S is rounded up to one of these
// (the keys beyond S are zero rows that get weight zero); 16 tiles hold
// kMaxRowSeq = 256 tokens. Calls
// launch(std::integral_constant<int, kTiles>()) for the smallest that holds
// seq; longer sequences take the key-tile kernels below.
constexpr int kMaxRowSeq = 256;

template <typename Launch>
cudaError_t with_key_tiles(int seq, Launch&& launch) {
  const int tiles = padded(seq) / 16;
  if (tiles <= 4) return launch(std::integral_constant<int, 4>());
  if (tiles <= 8) return launch(std::integral_constant<int, 8>());
  if (tiles <= 13) return launch(std::integral_constant<int, 13>());
  if (tiles <= 16) return launch(std::integral_constant<int, 16>());
  return cudaErrorInvalidValue;
}

// A warp's [16][64] accumulator times `mul`, rounded, into rows row0 ..
// row0 + 15 of `dst` (row stride `stride`; rows at or beyond S skipped), a
// bf16 pair a store.
__device__ __forceinline__ void store_acc_rows(bf16* dst, int stride,
                                               int row0, int seq,
                                               const float (&acc)[8][4],
                                               float mul, int lane) {
  const int gr = lane / 4, c2 = lane % 4 * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + gr + 8 * half;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<unsigned*>(dst + static_cast<size_t>(row) * stride +
                                   n * 8 + c2) =
          pack2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

// ------------------------------------------ sequences over kMaxRowSeq tokens
//
// Past 16 key tiles no score row fits a warp's registers, and at S = 784 a
// head's q, k and v slices (3 x 784 x 128 bytes) leave little of a block's
// shared memory. The key-tile kernels (attention_*_long_kernel) walk the
// keys (or, for dk and dv, the queries) a tile of kLongTile rows at a time,
// each tile's 64-wide head slices staged through a two-stage cp.async ring
// while the tile before it is computed. A row's statistics take passes of
// their own over the tiles (first the max, then the sums at that max), so
// every number is the plain version's at the same rounding points: no tile
// width enters the arithmetic, only the order of the f32 sums differs.

constexpr int kLongTile = 64;                    // rows of a staged tile
constexpr int kTileElems = kLongTile * kSlice;   // elements of a bf16 slice

__host__ __device__ inline bool long_sequence(int seq) {
  return seq > kMaxRowSeq;
}

// Wait for every cp.async group but the newest (the ring's next stage).
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// acc[2 j .. 2 j + 1] += a . (the rows 16 j .. 16 j + 15 of tile)^T for the
// four 16-row parts j of a staged [64][64] bf16 tile, whose rows are mma's
// column-major B as they stand (q . k^T, g . v^T, k . q^T, v . g^T).
__device__ __forceinline__ void tile_products(float (&acc)[8][4],
                                              const unsigned (&a)[4][4],
                                              const bf16* tile,
                                              const Lanes& ln) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned b[4];
      vqa::ldmatrix_x4(b, tile + swz(j * 16 + ln.bn_row, 2 * kk + ln.bn_chunk));
      vqa::mma_bf16(acc[2 * j], a[kk], b[0], b[1]);
      vqa::mma_bf16(acc[2 * j + 1], a[kk], b[2], b[3]);
    }
}

// out += (a [16][64 tile rows], four k16 A fragments) . tile, for a staged
// [64][64] tile taken row-major with ldmatrix.trans (e . v, dz . k,
// w^T . g, dz^T . q).
__device__ __forceinline__ void tile_times(float (&out)[8][4],
                                           const unsigned (&a)[4][4],
                                           const bf16* tile,
                                           const Lanes& ln) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      unsigned b[4];
      vqa::ldmatrix_x4_trans(
          b, tile + swz(j * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
      vqa::mma_bf16(out[2 * n], a[j], b[0], b[1]);
      vqa::mma_bf16(out[2 * n + 1], a[j], b[2], b[3]);
    }
}

// The four A fragments of a warp's 16 rows of a staged [rows][64] slice.
__device__ __forceinline__ void load_rows(unsigned (&a)[4][4],
                                          const bf16* rows, const Lanes& ln) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    vqa::ldmatrix_x4(a[kk], rows + swz(ln.a_row, 2 * kk + ln.a_chunk));
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[j][i] = 0.0f;
}

// f32 key-tile kernels: a thread per query (or key) row, plain FMAs, every
// staged slice [rows][kLdF32].
constexpr int kLongRowsF32 = 64;  // rows (threads) of an f32 block

}  // namespace vqa_vit
