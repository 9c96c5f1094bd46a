// ViT self-attention forward on the packed qkv projection (kernel 4 of the
// port).
//
// Replaces dl_vqa_tpu/ops/vit_attention_pallas.py::_attention_kernel. Per
// image b and head h, on the 64-wide slices q, k, v of qkv [B, S, 3 * H * 64]
// (layout in vit_attention.cuh):
//   s = f32(q . k^T) * (1 / sqrt(64));  m = rowmax(s)  (of the whole row)
//   e = exp(s - m)  (f32);  denom = rowsum(e)  (of the f32 e, before it is
//                                               rounded)
//   o = f32(cast(e) . v) / denom        (the [S, 64] output is normalised,
//                                        not the [S, S] weights)
//   out[b, :, h * 64 : (h + 1) * 64] = cast(o)
// for bf16 or f32 qkv and out; scores, sums and accumulators are f32.
//
// What bounds it on this card: memory traffic. It has to read qkv and write
// out once (205 MB at B = 512, S = 196, H = 4 in bf16, 0.061 ms at 3.35 TB/s)
// while its two products are 20 GFLOP (0.020 ms at the bf16 tensor-core
// peak). The plain version writes the f32 [B, H, S, S] scores, their
// exponentials and the split heads to device memory; here no score leaves
// the registers of the warp that made it.
//
// Design, bf16 (ldmatrix + mma.sync m16n8k16, f32 accumulate):
//  - A block takes one (image, head) and all of its 16-row query slabs,
//    four warps taking every fourth slab, and stages the head's q, k and v
//    once, by cp.async (rows at or beyond S zero-filled by the copy's
//    src-size operand), into unpadded 128-byte rows whose 16-byte chunks
//    are XOR-swizzled (vit_attention.cuh): 3 x 208 x 128 = 79,872 bytes at
//    S = 196. The score row takes the registers (254 a thread), so two
//    blocks of four warps share an SM; three at 168 registers, or the row
//    split over two warps, ran slower (PERF.md, PR 5).
//  - Where the batch has fewer (image, head) pairs than the card has SMs
//    (the serving buckets), the wrapper passes the SM count and the slabs
//    of a head are spread over blocks of four slabs, one a warp. A row's
//    arithmetic is the same whichever block or warp takes it, so an image
//    gives the same bits in a batch of 1 and of 512.
//  - A warp loads its q slab once as four A fragments, scaled by
//    1 / sqrt(64) = 2^-3 (exact, so the scores come out scaled to the bit),
//    takes the scores of its 16 rows against every key (S rounded up to
//    64, 128, 208 or 256: the whole row, up to 128 f32 a lane) into
//    accumulators, K by ldmatrix as mma's column-major B as it is stored.
//    Row max and row sum are two shuffles across the four lanes of a quad;
//    only the tiles that reach past S are masked. exp(s - m) is summed in f32
//    and rounded to bf16 in registers: two neighbouring n8 accumulator
//    tiles are one k16 A fragment of e . v, V by ldmatrix.trans. No score
//    or weight buffer exists in shared memory.
//  - The output is divided by the row sum on the accumulator and goes out
//    through the warp's own (spent) q rows as 16-byte stores.
// f32 goes through plain FMAs (a block per query tile, f32 score buffers in
// shared memory), which keeps the f32 products exact rather than rounding
// them to TF32; it is off the main path and slower than its plain version.

#include "vit_attention.cuh"

namespace {

using namespace vqa_vit;

// ---------------------------------------------------------------- bf16

constexpr int kWarps = 4;

template <int kTiles>  // 16-key tiles a score row spans
__global__ void __launch_bounds__(kWarps * 32, 2)
attention_mma_kernel(const bf16* __restrict__ qkv,  // [B, S, 3 * H * 64]
                     bf16* __restrict__ out,        // [B, S, H * 64]
                     int seq, int heads, int slabs_per_block) {
  constexpr int kRows = kTiles * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // each [kRows][64], swizzled
  bf16* v_s = k_s + kRows * kHead;
  bf16* q_s = v_s + kRows * kHead;  // the block's query slabs

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int dim = heads * kHead, stride = 3 * dim;
  const bf16* image = qkv + static_cast<size_t>(b) * seq * stride + h * kHead;
  const int slab0 = blockIdx.x * slabs_per_block;
  const int slab1 = min(padded(seq) / 16, slab0 + slabs_per_block);

  stage_async(k_s, image + dim, stride, 0, kRows, seq, tid, kWarps * 32);
  stage_async(v_s, image + 2 * dim, stride, 0, kRows, seq, tid, kWarps * 32);
  stage_async(q_s, image, stride, slab0 * 16, slab1 * 16, seq, tid,
              kWarps * 32);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const Lanes ln(lane);
  const int g = lane / 4, c2 = lane % 4 * 2;  // accumulator row, column
  for (int slab = slab0 + warp; slab < slab1; slab += kWarps) {
    const int row0 = slab * 16;
    bf16* q_w = q_s + (slab - slab0) * 16 * kHead;  // the warp's 16 q rows
    unsigned qa[4][4];  // q / sqrt(64)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      vqa::ldmatrix_x4(qa[kk], q_w + swz(ln.a_row, 2 * kk + ln.a_chunk));
      scale_fragment(qa[kk]);
    }

    // s[j]: keys 8 j .. 8 j + 7; a lane holds rows g (s[j][0..1]) and g + 8
    // (s[j][2..3]), keys 8 j + c2 and the next.
    float s[2 * kTiles][4];
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        unsigned kb[4];
        vqa::ldmatrix_x4(kb,
                         k_s + swz(t * 16 + ln.bn_row, 2 * kk + ln.bn_chunk));
        vqa::mma_bf16(s[2 * t], qa[kk], kb[0], kb[1]);
        vqa::mma_bf16(s[2 * t + 1], qa[kk], kb[2], kb[3]);
      }

    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j) {
      if ((j + 1) * 8 > seq) {  // a tile that reaches past S
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * 8 + c2 + e >= seq)  // a padded key column: no weight
            s[j][e] = s[j][2 + e] = -INFINITY;
      }
      m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
      m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
    }
    m_lo = quad_max(m_lo);
    m_hi = quad_max(m_hi);

    float sum_lo = 0.0f, sum_hi = 0.0f, o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[n][x] = 0.0f;
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      unsigned ea[4];  // cast(e) of keys 16 t .. 16 t + 15: an A fragment
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* x = s[2 * t + jj];
        const float e0 = expf(x[0] - m_lo), e1 = expf(x[1] - m_lo);
        const float e2 = expf(x[2] - m_hi), e3 = expf(x[3] - m_hi);
        sum_lo += e0 + e1;
        sum_hi += e2 + e3;
        ea[2 * jj] = pack2(e0, e1);
        ea[2 * jj + 1] = pack2(e2, e3);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        unsigned vb[4];
        vqa::ldmatrix_x4_trans(
            vb, v_s + swz(t * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
        vqa::mma_bf16(o[2 * n], ea, vb[0], vb[1]);
        vqa::mma_bf16(o[2 * n + 1], ea, vb[2], vb[3]);
      }
    }
    sum_lo = quad_sum(sum_lo);
    sum_hi = quad_sum(sum_hi);

    // The slab's q rows are spent: they take the rounded output, then go
    // out as 16-byte stores of whole rows.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<unsigned*>(q_w + swz(g, n) + c2) =
          pack2(o[n][0] / sum_lo, o[n][1] / sum_lo);
      *reinterpret_cast<unsigned*>(q_w + swz(g + 8, n) + c2) =
          pack2(o[n][2] / sum_hi, o[n][3] / sum_hi);
    }
    __syncwarp();
    bf16* out_rows =
        out + (static_cast<size_t>(b) * seq + row0) * dim + h * kHead;
#pragma unroll
    for (int i = lane; i < 16 * 8; i += 32) {
      const int r = i / 8, c = i % 8;
      if (row0 + r < seq)
        *reinterpret_cast<uint4*>(out_rows + static_cast<size_t>(r) * dim +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(q_w + swz(r, c));
    }
  }
}

cudaError_t run_bf16(const bf16* qkv, bf16* out, int batch, int seq,
                     int heads, int sms, cudaStream_t stream) {
  return with_key_tiles(seq, [&](auto tiles) {
    constexpr int kTiles = decltype(tiles)::value;
    constexpr size_t shared = 3 * sizeof(bf16) * kTiles * 16 * kHead;
    static_assert(shared <= kMaxShared, "q, k and v of a head fit a block");
    auto kernel = attention_mma_kernel<kTiles>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
    const int slabs = padded(seq) / 16;
    // Fewer heads than SMs: a block of one slab a warp, so that a small
    // batch still spreads over the card.
    const int per_block =
        static_cast<long long>(batch) * heads < sms ? kWarps : slabs;
    const dim3 grid((slabs + per_block - 1) / per_block, heads, batch);
    kernel<<<grid, kWarps * 32, shared, stream>>>(qkv, out, seq, heads,
                                                  per_block);
    return cudaGetLastError();
  });
}

// ---------------------------------------------------------------- f32

constexpr int kWarpsF32 = 4;

__global__ void __launch_bounds__(kWarpsF32 * 32)
attention_fma_kernel(const float* __restrict__ qkv,  // [B, S, 3 * H * 64]
                     float* __restrict__ out,        // [B, S, H * 64]
                     int seq, int heads) {
  constexpr int kLd = kLdF32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded(seq);
  const int lds = score_ld(sp);
  float* k_s = reinterpret_cast<float*>(smem);  // [sp][kLd]
  float* v_s = k_s + sp * kLd;                  // [sp][kLd]
  float* sc_all = v_s + sp * kLd;               // [kWarpsF32][16][lds]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int dim = heads * kHead, stride = 3 * dim;
  const float* image = qkv + static_cast<size_t>(b) * seq * stride;

  stage_rows(k_s, kLd, image + dim + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kWarpsF32 * 32);
  stage_rows(v_s, kLd, image + 2 * dim + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kWarpsF32 * 32);
  __syncthreads();
  // The block's only barrier is behind it: a warp without rows may leave.
  const int row0 = (blockIdx.x * kWarpsF32 + warp) * 16;
  if (row0 >= seq) return;

  float* sc = sc_all + warp * 16 * lds;
  float* out_rows = out + (static_cast<size_t>(b) * seq + row0) * dim +
                    h * kHead;
  float denom_mine = 1.0f;  // lane r keeps the denominator of row r
  float* q_s = sc_all + kWarpsF32 * 16 * lds + warp * 16 * kHead;  // [16][64]
  stage_rows(q_s, kHead, image + h * kHead, stride, row0, 16, seq, lane, 32);
  __syncwarp();
  // Lane owns key column c: its k row in registers, the 16 q rows broadcast.
  for (int c0 = 0; c0 < seq; c0 += 32) {
    const int c = c0 + lane;
    if (c < seq) {
      float kr[kHead];
#pragma unroll
      for (int d = 0; d < kHead; ++d) kr[d] = k_s[c * kLd + d];
      for (int r = 0; r < 16; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < kHead; ++d)
          acc = fmaf(q_s[r * kHead + d], kr[d], acc);
        sc[r * lds + c] = acc;
      }
    }
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    float* row = sc + r * lds;
    float m = -INFINITY;
    for (int c = lane; c < seq; c += 32) m = fmaxf(m, row[c] * kScale);
    m = warp_max(m);
    float sum = 0.0f;
    for (int c = lane; c < seq; c += 32) {
      const float e = expf(row[c] * kScale - m);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == r) denom_mine = sum;
  }
  __syncwarp();
  // Lane owns output columns lane and lane + 32 of all 16 rows.
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int c = 0; c < seq; ++c) {
    const float v0 = v_s[c * kLd + lane], v1 = v_s[c * kLd + lane + 32];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float e = sc[r * lds + c];
      acc[r][0] = fmaf(e, v0, acc[r][0]);
      acc[r][1] = fmaf(e, v1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float d = __shfl_sync(0xffffffffu, denom_mine, r);
    if (row0 + r < seq) {
      out_rows[static_cast<size_t>(r) * dim + lane] = acc[r][0] / d;
      out_rows[static_cast<size_t>(r) * dim + lane + 32] = acc[r][1] / d;
    }
  }
}

cudaError_t run_f32(const float* qkv, float* out, int batch, int seq,
                    int heads, cudaStream_t stream) {
  const int sp = padded(seq);
  const size_t shared =
      sizeof(float) * (2 * static_cast<size_t>(sp) * kLdF32 +
                       kWarpsF32 * 16 * (static_cast<size_t>(score_ld(sp)) +
                                         kHead));
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const dim3 grid((sp / 16 + kWarpsF32 - 1) / kWarpsF32, heads, batch);
  attention_fma_kernel<<<grid, kWarpsF32 * 32, shared, stream>>>(
      qkv, out, seq, heads);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3 * H * 64] -> out [B, S, H * 64], both of the type `dtype`
// names; `sms` is the device's SM count (bf16: below it in (image, head)
// pairs, a head's query slabs spread over several blocks). One grid.
extern "C" int vqa_vit_attention(const void* qkv, void* out, int batch,
                                 int seq, int heads, int sms, int dtype,
                                 void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vqa::kBFloat16:
      return run_bf16(static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
                      batch, seq, heads, sms, s);
    case vqa::kFloat32:
      return run_f32(static_cast<const float*>(qkv), static_cast<float*>(out),
                     batch, seq, heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}
