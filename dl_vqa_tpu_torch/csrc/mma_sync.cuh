// Tensor-core building blocks shared by the kernels that feed mma.sync from
// shared memory (lstm_recurrence.cu, vit_attention.cuh), and by the ldmatrix
// loads of wgmma's register operand (conv_relu_pool_fused.cu,
// conv_relu_pool_int8.cu): ldmatrix
// loads and the bf16 m16n8k16 product with f32 accumulation.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace vqa {

// Four 8 x 8 b16 matrices from shared memory, one 16-byte row address a lane
// (lanes 8i .. 8i + 7 give matrix i); a lane receives row lane / 4, columns
// 2 (lane % 4) and the next of each matrix, which is the operand layout of
// mma.m16n8k16. `.trans` hands over the transposed matrices.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same four matrices as 8 rows of 16 bytes each: for s8 data a lane
// receives row lane / 4, bytes 4 (lane % 4) .. + 3, the operand layout of
// mma.m16n8k32 and of wgmma's 8-bit register A.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const int8_t* p) {
  ldmatrix_x4(r, reinterpret_cast<const __nv_bfloat16*>(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b for a [16, 16] (row-major), b [16, 8] and f32 d [16, 8]: a lane
// holds d[lane / 4][2 (lane % 4) + {0, 1}] in d[0], d[1] and the same columns
// of row lane / 4 + 8 in d[2], d[3].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace vqa
