// Warpgroup matrix multiply (wgmma, sm_90a) building blocks shared by the
// kernels that feed Hopper's tensor cores from a warpgroup of four warps
// (conv_relu_pool_fused.cu, vit_mlp_fused.cu, conv_relu_pool_int8.cu, the
// ViT attention's key-tile kernels in vit_attention_wgmma.cuh).
//
// Shared-memory operands: 128-byte-swizzled, K-major bf16 tiles. A tile of
// R rows (M or N) by K columns is stored as K / 64 "atoms" one after the
// other, each atom R rows of 64 values (128 bytes), every atom starting at
// a 1024-byte boundary. Inside an atom the eight 16-byte pieces of row r are
// permuted: piece p (values 8 p .. 8 p + 7) of row r lies at
//
//   atom_base + 128 r + 16 (p ^ (r % 8))                       (bytes)
//
// which is the hardware's 128-byte swizzle (address bits 4..6 XOR bits
// 7..9), so that the eight rows an 8 x 8 core matrix reads hit eight
// different bank groups. `swizzle_offset` gives that byte offset; kernel 6's
// wrapper (ops/conv_fused.py::pack_conv_weight) and kernel 8's packing grid
// write weights in the same order. A descriptor for the k16 step s of
// atom a points at atom_base(a) + 32 (s % 4): the stride between 8-row
// groups is 1024 bytes, and the leading offset is unused for K-major
// swizzled tiles.
//
// Register operand A (`mma_rs`): each warp w of the warpgroup holds rows
// 16 w .. 16 w + 15 of the 64-row A slice in the mma.sync m16n8k16 A
// layout (what ldmatrix_x4 of a [16, 16] block gives). The f32 accumulator
// of m64nN: warp w, lane l holds, for each 8-column block j, rows
// 16 w + l / 4 (d[4 j], d[4 j + 1]) and 16 w + l / 4 + 8 (d[4 j + 2],
// d[4 j + 3]), columns 8 j + 2 (l % 4) and the next. So the accumulator of
// one product, rounded to bf16 in pairs, is the register A of the next:
// A's k16 step s is blocks 2 s and 2 s + 1 (`accumulator_to_a`). A wgmma
// in flight reads its A registers: nothing may write them until a `wait`
// retires its group, which the compiler does not see, so a kernel that
// loads the next A while a group runs keeps the two in distinct buffers.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace vqa {
namespace wgmma {

constexpr int kAtomBytes = 1024;  // alignment of an atom (8 rows of 128 B)

// Byte offset of value (row, col) in a swizzled K-major tile of `rows`
// rows (col < K, any multiple of 64).
__host__ __device__ __forceinline__ int swizzle_offset(int row, int col,
                                                       int rows) {
  return (col / 64) * rows * 128 + row * 128 +
         (((col % 64) / 8) ^ (row % 8)) * 16 + (col % 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a 128-byte-swizzled K-major tile whose k16 step starts at
// shared address `addr` (16-byte aligned; its atom 1024-byte aligned).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |              // leading: unused
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) |  // 8-row stride
         (static_cast<uint64_t>(1) << 62);                // 128-byte swizzle
}

// An MN-major operand B (stored [K][N], N contiguous; taken with the
// instruction's transpose-B bit, `mma_rs_mn64`) in 128-byte rows with the same
// swizzle: a row is 64 N values at one k, and eight rows (k) are one
// 1024-byte atom. For N = 64 (one atom across) `desc` describes it as it
// stands: the stride between the two 8-k halves of a k16 step is the
// 1024-byte field, and the leading offset (between atoms along N) is
// unused. The k16 step s starts two atoms on, at tile + 2048 s.
constexpr int kMnStepBytes = 2 * kAtomBytes;

// Orders this thread's earlier register writes before the next wgmma.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most kPending committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Makes this thread's shared-memory writes (plain stores, cp.async) visible
// to wgmma, which reads shared memory through the async proxy.
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma that is still in flight.
template <int kN>
__device__ __forceinline__ void fence_operand(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void fence_operand(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64, N] (+)= A[64, 16] . B[16, N], f32 sums of bf16 products; B from
// shared memory by descriptor (K-major: stored [N][K]); A from shared memory
// (`mma_ss`, K-major [64][K]) or from registers (`mma_rs`). scale_d = 0
// overwrites d, 1 adds to it.
template <int kN>
__device__ __forceinline__ void mma_ss(float (&d)[kN / 2], uint64_t a,
                                       uint64_t b, int scale_d);
template <int kN>
__device__ __forceinline__ void mma_rs(float (&d)[kN / 2],
                                       const unsigned (&a)[4], uint64_t b,
                                       int scale_d);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, "
      "%17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, "
      "%68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
      "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[64, 64] (+)= A[64, 16] . B[16, 64] as `mma_rs<64>`, with B MN-major
// (stored [K][N], see kMnStepBytes): the transpose-B bit set.
__device__ __forceinline__ void mma_rs_mn64(float (&d)[32],
                                            const unsigned (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Moves registers between the warpgroups of a warp-specialised block: a
// warpgroup that only issues copies gives them up, the ones that compute
// take them. All four warps of a warpgroup execute it.
template <int kRegs>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// d[64, N] (+)= A[64, 32] . B[32, N], exact s32 sums of s8 products: A from
// registers (per warp the mma.sync m16n8k32 A layout, which ldmatrix_x4 of
// a [16, 32]-byte block gives), B from shared memory by descriptor,
// K-major: a k32 step is 32 bytes, as a bf16 k16 step, so `desc` and the
// swizzle above hold in bytes with 128 s8 values an atom row. The s32
// accumulator has the f32 one's layout. scale_d = 0 overwrites d, 1 adds.
template <int kN>
__device__ __forceinline__ void mma_rs_s8(int (&d)[kN / 2],
                                          const unsigned (&a)[4], uint64_t b,
                                          int scale_d);

template <>
__device__ __forceinline__ void mma_rs_s8<128>(int (&d)[64],
                                               const unsigned (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Two f32 values rounded to bf16 and packed, the lower column first.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The A operand of k16 step s from accumulator blocks 2 s and 2 s + 1 that
// already hold bf16 pairs (h[j][0]: row l / 4, h[j][1]: row l / 4 + 8).
__device__ __forceinline__ void accumulator_to_a(unsigned (&a)[4],
                                                 const unsigned (&lo)[2],
                                                 const unsigned (&hi)[2]) {
  a[0] = lo[0];
  a[1] = lo[1];
  a[2] = hi[0];
  a[3] = hi[1];
}

}  // namespace wgmma
}  // namespace vqa
