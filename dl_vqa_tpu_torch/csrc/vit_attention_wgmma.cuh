// Shared by the wgmma key-tile kernels of the ViT attention (kernel 4 in
// vit_attention.cu, kernel 5's two grids in vit_attention_backward.cu): bf16
// heads of 64 and 128 past kMaxRowSeq tokens, as
// ops/vit_attention.py::attention_plan sends them.
//
// A block is a producer warpgroup (warpgroup 0: one thread issues every
// copy, the others leave at once; setmaxnreg hands their registers to the
// consumers) and two or three consumer warpgroups, 64 rows each (queries,
// or keys in kernel 5's second grid). The block's own rows are staged once;
// the other side's rows flow through a ring of `stages` stages, a 64-row
// tile of every 64-wide head slice a stage, each stage guarded by a `full`
// and an `empty` mbarrier.
//
// Copies are TMA loads of 3-D tensor maps over [B, S, width] (qkv, g): a
// box is 64 columns (one head slice, 128 bytes) by 64 rows of one image, so
// rows at or past S are zero-filled by the copy and never read from the next
// image. The copy lays the box down in 128-byte rows with the 128-byte
// swizzle, which is wgmma's K-major tile (wgmma.cuh) and, read with the
// transpose-B bit, its MN-major tile: the same bytes serve q . k^T (k
// K-major) and dz . k (k MN-major). Tiles start at 1024-byte boundaries.
//
// The plan is made in Python; the C entries take it as it is and check only
// that the kernel's shared memory fits what it names.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder: see below)

#include "vit_attention.cuh"
#include "wgmma.cuh"

namespace vqa_vit {

constexpr int kWgThreads = 128;               // a warpgroup
constexpr int kRingRows = 64;                 // rows of a ring tile
constexpr int kSliceBytes = kRingRows * 128;  // one 64-wide slice of a tile
constexpr int kStatBytes = 1024;  // kernel 5's [3][64] f32 statistics, padded
constexpr int kBarrierBytes = 128;
constexpr int kMaxStages = 7;  // (2 stages + 1) mbarriers of 8 bytes fit
// One stage to compute on while the next one is loaded.
constexpr int kMinStages = 2;
// Registers a thread after setmaxnreg: the producer keeps 24, two
// consumers take 240 each, three 160 (all within the 64 K of an SM).
constexpr int kProducerRegs = 24;
template <int kConsumers>
struct ConsumerRegs {
  static constexpr int value = kConsumers == 3 ? 160 : 240;
};

// The plan's numbers (ops/vit_attention.py::AttentionPlan.c_args after the
// design code): rows a block, keys (queries) a ring tile, ring stages, the
// dynamic shared bytes of kernel 4, kernel 5's first and second grids, and
// the length of a row of kernel 5's statistics.
struct Plan {
  int rows, key_tile, stages, shared, shared_dq, shared_dkdv, stats_len;
};

// Shared bytes of a block holding `fixed` bytes of its own rows and
// `stages` ring stages of `stage` bytes: 1024 to align the tiles, then the
// tiles, then the mbarriers.
__host__ __device__ inline size_t ring_shared(size_t fixed, size_t stage,
                                              int stages) {
  return 1024 + fixed + stages * stage + kBarrierBytes;
}

// Consumer warpgroups of a block with rows row0 .. row0 + rows - 1: those
// whose 64 rows start before S.
__host__ __device__ inline int consumers(int row0, int rows, int seq) {
  const int left = (seq - row0 + kRingRows - 1) / kRingRows;
  return left < rows / kRingRows ? left : rows / kRingRows;
}

// ------------------------------------------------------- device helpers

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = vqa::wgmma::smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

namespace ring {

__device__ __forceinline__ void init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   vqa::wgmma::smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the copy engine and the other
// threads (with the __syncthreads after it).
__device__ __forceinline__ void init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The producer's arrival, with the bytes the copies of this phase bring.
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          vqa::wgmma::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Waits for the completion of the barrier's phase of this parity. The
// polling loop lies inside the asm, so that the compiler sees no divergent
// branch around the wgmma that follows.
__device__ __forceinline__ void wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(vqa::wgmma::smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// A TMA load of the box at (c0, c1, c2) of a 3-D map (`load_2d`: at
// (c0, c1) of a 2-D one) into dst, completing on `bar`.
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map,
                                        int c0, int c1, int c2,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          vqa::wgmma::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)),
      "r"(vqa::wgmma::smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map,
                                        int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          vqa::wgmma::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)),
      "r"(vqa::wgmma::smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

}  // namespace ring

// The wgmma accumulator of a [64][64] product, as mma.sync's [8][4] n8
// tiles (wgmma.cuh): d[4 j + x] is row l / 4 (+ 8 for x >= 2) of the
// warp's 16, column 8 j + 2 (l % 4) + (x & 1).
__device__ __forceinline__ int acc_col(int j, int x, int lane) {
  return 8 * j + lane % 4 * 2 + (x & 1);
}

// acc = A . B^T over a consumer's staged rows A [64 rows][64 n] (at
// a_addr, slices a_slice_bytes apart) and a ring tile B [64][64 n] (slices
// kSliceBytes apart), both K-major: the score products q . k^T, g . v^T,
// k . q^T and v . g^T.
template <int kSlices>
__device__ __forceinline__ void score_product(float (&acc)[32],
                                              uint32_t a_addr,
                                              int a_slice_bytes,
                                              uint32_t b_addr) {
  namespace wg = vqa::wgmma;
#pragma unroll
  for (int sl = 0; sl < kSlices; ++sl)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_ss<64>(acc, wg::desc(a_addr + sl * a_slice_bytes + 32 * kk),
                     wg::desc(b_addr + sl * kSliceBytes + 32 * kk),
                     sl > 0 || kk > 0);
}

// The score product above as one committed wgmma group, not waited for:
// nothing may read `acc` until a wait retires the group (then
// `fence_operand(acc)` before the first read).
//
// The consumers issue a unit's wgmma groups, commit them and wait for them
// in straight-line code, with no other instruction touching their
// registers while they fly: so ptxas can tell which groups are done and
// keeps them asynchronous (where it cannot, it serialises every wgmma, as
// its advisory C7514/C7515 says). A consumer's own softmax does not run
// under its products; the other consumers' does.
template <int kSlices>
__device__ __forceinline__ void issue_scores(float (&acc)[32],
                                             uint32_t a_addr,
                                             int a_slice_bytes,
                                             uint32_t b_addr) {
  namespace wg = vqa::wgmma;
  wg::fence_operand(acc);
  wg::fence();
  score_product<kSlices>(acc, a_addr, a_slice_bytes, b_addr);
  wg::commit();
}

// acc += A . B for A [64 rows][64 keys] in registers (the bf16 pairs of a
// score-shaped accumulator, a[kk] the k16 step kk) and B one 64-wide slice
// of a ring tile [64 keys][64 n] at b_addr, MN-major.
__device__ __forceinline__ void tile_product(float (&acc)[32],
                                             const unsigned (&a)[4][4],
                                             uint32_t b_addr) {
  namespace wg = vqa::wgmma;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::mma_rs_mn64(acc, a[kk], wg::desc(b_addr + kk * wg::kMnStepBytes), 1);
}

// The k16 step kk of an A operand from f32 values v(j, x) of a score-shaped
// accumulator (blocks 2 kk and 2 kk + 1), rounded to bf16 in pairs.
template <typename F>
__device__ __forceinline__ void pack_a(unsigned (&a)[4][4], F&& v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][2 * (j % 2)] = pack2(v(j, 0), v(j, 1));
    a[j / 2][2 * (j % 2) + 1] = pack2(v(j, 2), v(j, 3));
  }
}

// A consumer warp is done with a ring stage: one arrival a warp, by lane 0
// under a predicate (no branch).
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          vqa::wgmma::smem_addr(empty)),
      "r"(lane)
      : "memory");
}

// The scores of keys at or past S in the tile of keys key0 .. key0 + 63
// (only the tile that reaches past S has any) become -inf.
__device__ __forceinline__ void mask_keys(float (&s)[32], int key0, int seq,
                                          int lane) {
  if (key0 + kRingRows > seq) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (key0 + acc_col(j, x, lane) >= seq) s[4 * j + x] = -INFINITY;
  }
}

// f32(s * scale) - m with the plain versions' roundings. A head of 64 has
// scale 2^-3, so the product is exact and one fma gives the same bits.
// (The row max is taken of the unscaled scores and scaled once: rounding
// is monotone and the scale positive, so that is the max of the scaled
// ones, to the bit.)
template <int kSlices>
__device__ __forceinline__ float shifted(float s, float scale, float m) {
  return kSlices == 1 ? fmaf(s, scale, -m) : s * scale - m;
}

template <int kN>
__device__ __forceinline__ void zero_acc(float (&x)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = 0.0f;
}

// A warp's 16 rows of a [64][64] accumulator times `mul`, rounded, at
// row0 .. row0 + 15 of dst (row stride `stride`; rows at or past S
// skipped), a bf16 pair a store.
__device__ __forceinline__ void store_acc(bf16* dst, int stride, int row0,
                                          int seq, const float (&acc)[32],
                                          float mul, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + lane / 4 + 8 * half;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<unsigned*>(dst + static_cast<size_t>(row) * stride +
                                   acc_col(j, 0, lane)) =
          pack2(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, found at run time through the runtime's
// entry-point query so that the library links nothing new; null where it
// is not there.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 3-D map of a bf16 [batch, seq, width] tensor whose boxes are one
// 64-wide slice of kRingRows rows of one image, 128-byte swizzled.
inline cudaError_t slice_map(CUtensorMap* map, const bf16* base, int width,
                             int seq, int batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {sizeof(bf16) * dims[0],
                                 sizeof(bf16) * dims[0] * dims[1]};
  const cuuint32_t box[3] = {kSlice, kRingRows, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<bf16*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The 2-D map of kernel 5's f32 statistics [rows, stats_len] (rows = B H 3)
// whose boxes are kRingRows columns of a (b, h)'s three rows.
inline cudaError_t stats_map(CUtensorMap* map, const float* base, int rows,
                             int stats_len) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(stats_len),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {sizeof(float) * dims[0]};
  const cuuint32_t box[2] = {kRingRows, 3}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// Whether a plan's ring fits the kernels: rows of one to three warpgroups,
// 64-row ring tiles, kMinStages .. kMaxStages stages.
inline bool plan_shape_ok(const Plan& plan) {
  return (plan.rows == kRingRows || plan.rows == 2 * kRingRows ||
          plan.rows == 3 * kRingRows) &&
         plan.key_tile == kRingRows && plan.stages >= kMinStages &&
         plan.stages <= kMaxStages;
}

}  // namespace vqa_vit
