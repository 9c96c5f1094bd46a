// Shared by the ViT attention kernels (vit_attention.cu and
// vit_attention_backward.cu): the packed-qkv layout, staging of one head's
// 64-wide column slice into shared memory, warp reductions, and the in-place
// narrowing of an f32 score row to bf16.
//
// qkv is [B, S, 3 * H * 64]: q | k | v, each head-major, so head h's q, k and
// v rows are 64-element slices of a row of 3 * H * 64 elements, at columns
// h * 64, H * 64 + h * 64 and 2 * H * 64 + h * 64. The kernels compute these
// offsets themselves; nothing is split or transposed before the launch.
//
// A tensor-core tile has 16 rows, so S is padded to sp = ceil(S / 16) * 16 in
// shared memory: staged rows at or beyond S are zero, padded key columns get
// weight zero, and padded query rows are computed and never stored.
#pragma once

#include <cmath>
#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace vqa_vit {

constexpr int kHead = 64;           // head size the kernels take
constexpr float kScale = 0.125f;    // 1 / sqrt(kHead)
constexpr int kMaxShared = 232448;  // bytes a block may have on sm_90
constexpr int kMaxSeq = 256;        // tokens; ops/vit_attention.py MAX_SEQ
// The row passes of the tensor-core paths take kRowGroup rows at a time and
// keep a row's kMaxSeq / 32 columns a lane in registers.
constexpr int kRowGroup = 4;
constexpr int kLaneCols = kMaxSeq / 32;

// Leading dimension of a staged [rows][64] slice: 72 bf16 (144 bytes) keeps
// wmma's 32-byte alignment and spreads rows over the banks; 65 floats makes a
// column walk (one row per lane) conflict-free.
template <typename T>
struct Staged;
template <>
struct Staged<__nv_bfloat16> {
  static constexpr int kLd = 72;
};
template <>
struct Staged<float> {
  static constexpr int kLd = 65;
};

__host__ __device__ inline int padded(int seq) { return (seq + 15) & ~15; }

// Leading dimension of a warp's f32 score buffer [16][score_ld]: a multiple of
// 4 (wmma's f32 store) that is no multiple of 32 words, and at least 68, so
// that the buffer also takes a staged bf16 slab [16][72] before the scores
// and the f32 [16][64] result after them.
__host__ __device__ inline int score_ld(int sp) {
  return (sp < 64 ? 64 : sp) + 4;
}

// Copy rows row0 .. row0 + rows - 1 of a head slice (src points at row 0 of
// the image, at the slice's first column; row_stride in elements) into
// dst[rows][ld], by 16-byte global loads; rows at or beyond seq become zero.
// Called by `count` threads with ranks `rank`.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int row_stride, int row0, int rows,
                                           int seq, int rank, int count) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = kHead / kVec;
  for (int i = rank; i < rows * kVecs; i += count) {
    const int r = i / kVecs, c = (i % kVecs) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * row_stride + c);
    if constexpr (std::is_same<T, float>::value) {
      float* d = dst + r * ld + c;  // rows of 65 floats are not 16-byte aligned
      d[0] = __uint_as_float(val.x);
      d[1] = __uint_as_float(val.y);
      d[2] = __uint_as_float(val.z);
      d[3] = __uint_as_float(val.w);
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
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

using vqa::pack8;

}  // namespace vqa_vit
