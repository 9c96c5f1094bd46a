// ViT self-attention forward on the packed qkv projection (kernel 4 of the
// port).
//
// Replaces dl_vqa_tpu/ops/vit_attention_pallas.py::_attention_kernel. Per
// image b and head h, on the D-wide slices q, k, v of qkv [B, S, 3 * H * D],
// D = 64 n (layout in vit_attention.cuh):
//   s = f32(q . k^T) * (1 / sqrt(D));  m = rowmax(s)  (of the whole row)
//   e = exp(s - m)  (f32);  denom = rowsum(e)  (of the f32 e, before it is
//                                               rounded)
//   o = f32(cast(e) . v) / denom        (the [S, D] output is normalised,
//                                        not the [S, S] weights)
//   out[b, :, h * D : (h + 1) * D] = cast(o)
// for bf16 or f32 qkv and out; scores, sums and accumulators are f32.
//
// What bounds it on this card: memory traffic. It has to read qkv and write
// out once (205 MB at B = 512, S = 196, H = 4, D = 64 in bf16, 0.061 ms at
// 3.35 TB/s) while its two products are 20 GFLOP (0.020 ms at the bf16
// tensor-core peak). The plain version writes the f32 [B, H, S, S] scores,
// their exponentials and the split heads to device memory; here no score
// leaves the registers of the warp that made it.
//
// Past 256 tokens (the 448-px ViT's 784) the function is bound by its
// operations instead: 322 GFLOP against 0.82 GB at B = 512, S = 784, 0.326
// ms at the bf16 tensor-core peak. There no score row fits a warp's
// registers, and the key-tile kernels below walk the keys a tile at a
// time, taking a pass for the row max before the pass for the sums: 1.5
// times the score products, in exchange for the plain version's rounding
// points at every length. bf16 heads of 64 and 128 take
// attention_wgmma_kernel (vit_attention_wgmma.cuh: every product on wgmma,
// the tiles brought by TMA through an mbarrier ring by a producer
// warpgroup, two consumer warpgroups of 64 query rows, each issuing a
// unit's products ahead of the unit before's softmax so that the softmax
// runs under them); other heads attention_mma_long_kernel (mma.sync over a
// cp.async ring), f32 attention_fma_long_kernel. The tiling of the wgmma
// kernel is ops/vit_attention.py::attention_plan's. No library kernel is
// called.
//
// Design, bf16, D = 64 (ldmatrix + mma.sync m16n8k16, f32 accumulate):
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
// bf16, D = 64 n for n > 1 (attention_mma_sliced_kernel): the same warp
// arithmetic, with the head walked in 64-wide slices so that shared memory
// stays what a slice needs (a k or v slice and the block's four q slabs:
// 40,960 bytes at S = 256), whatever D. A block takes four query slabs, a
// warp each. The scores accumulate over the slices (stage q and k of a
// slice, add its four k16 steps to the score row), are multiplied by the
// f32 scale, and the softmax is taken once; cast(e) stays in registers as
// A fragments, and the output goes out a slice at a time (stage v's slice,
// e . v over every key, divide, store 64 columns). Each slice restages k
// or v for every block of four slabs: a head's k and v are read from the L2
// cache once a block, not once a head.
// f32 goes through plain FMAs (a block per query tile, f32 score buffers in
// shared memory; heads of 64 n a slice at a time, the score buffers summing
// over the slices), which keeps the f32 products exact rather than rounding
// them to TF32; it is off the main path and slower than its plain version.

#include "vit_attention_wgmma.cuh"

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
  bf16* v_s = k_s + kRows * kSlice;
  bf16* q_s = v_s + kRows * kSlice;  // the block's query slabs

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int dim = heads * kSlice, stride = 3 * dim;
  const bf16* image = qkv + static_cast<size_t>(b) * seq * stride + h * kSlice;
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
    bf16* q_w = q_s + (slab - slab0) * 16 * kSlice;  // the warp's 16 q rows
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
        out + (static_cast<size_t>(b) * seq + row0) * dim + h * kSlice;
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

// bf16, heads of 64 n for n > 1: a block of four query slabs, a warp each;
// the head walked a 64-wide slice at a time (see the file's notes).
template <int kTiles>  // 16-key tiles a score row spans
__global__ void __launch_bounds__(kWarps * 32, 2)
attention_mma_sliced_kernel(const bf16* __restrict__ qkv,  // [B, S, 3*H*D]
                            bf16* __restrict__ out,        // [B, S, H * D]
                            int seq, int heads, int slices, float scale) {
  constexpr int kRows = kTiles * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem);  // [kRows][64]: k's, then v's
  bf16* q_s = kv_s + kRows * kSlice;           // [4 slabs][16][64], swizzled

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const bf16* image = qkv + static_cast<size_t>(b) * seq * stride + h * head;
  const int slab0 = blockIdx.x * kWarps;
  const int slab1 = min(padded(seq) / 16, slab0 + kWarps);
  const int row0 = (slab0 + warp) * 16;
  // A warp without a slab still takes every barrier.
  const bool active = slab0 + warp < slab1;
  bf16* q_w = q_s + warp * 16 * kSlice;  // the warp's 16 q rows

  const Lanes ln(lane);
  const int g = lane / 4, c2 = lane % 4 * 2;  // accumulator row, column

  // s[j]: keys 8 j .. 8 j + 7, as in attention_mma_kernel, summed over the
  // head's slices.
  float s[2 * kTiles][4];
#pragma unroll
  for (int j = 0; j < 2 * kTiles; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[j][x] = 0.0f;
  for (int sl = 0; sl < slices; ++sl) {
    if (sl) __syncthreads();  // every warp is done with the last slice
    stage_async(kv_s, image + dim + sl * kSlice, stride, 0, kRows, seq, tid,
                kWarps * 32);
    stage_async(q_s, image + sl * kSlice, stride, slab0 * 16, slab1 * 16, seq,
                tid, kWarps * 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    unsigned qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      vqa::ldmatrix_x4(qa[kk], q_w + swz(ln.a_row, 2 * kk + ln.a_chunk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        unsigned kb[4];
        vqa::ldmatrix_x4(kb,
                         kv_s + swz(t * 16 + ln.bn_row, 2 * kk + ln.bn_chunk));
        vqa::mma_bf16(s[2 * t], qa[kk], kb[0], kb[1]);
        vqa::mma_bf16(s[2 * t + 1], qa[kk], kb[2], kb[3]);
      }
  }

  // The softmax, once: cast(e) of keys 16 t .. 16 t + 15 as the A fragment
  // ea[t] of e . v, and the f32 row sums.
  unsigned ea[kTiles][4];
  float sum_lo = 0.0f, sum_hi = 0.0f;
  if (active) {
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] *= scale;
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
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* x = s[2 * t + jj];
        const float e0 = expf(x[0] - m_lo), e1 = expf(x[1] - m_lo);
        const float e2 = expf(x[2] - m_hi), e3 = expf(x[3] - m_hi);
        sum_lo += e0 + e1;
        sum_hi += e2 + e3;
        ea[t][2 * jj] = pack2(e0, e1);
        ea[t][2 * jj + 1] = pack2(e2, e3);
      }
    sum_lo = quad_sum(sum_lo);
    sum_hi = quad_sum(sum_hi);
  }

  // The output, a slice at a time: v's slice staged, e . v over every key,
  // divided, rounded into the warp's spent q rows and stored as whole rows.
  bf16* out_rows = out + (static_cast<size_t>(b) * seq + row0) * dim +
                   h * head;
  for (int sl = 0; sl < slices; ++sl) {
    __syncthreads();  // kv_s and the warps' output rows are free
    stage_async(kv_s, image + 2 * dim + sl * kSlice, stride, 0, kRows, seq,
                tid, kWarps * 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[n][x] = 0.0f;
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        unsigned vb[4];
        vqa::ldmatrix_x4_trans(
            vb, kv_s + swz(t * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
        vqa::mma_bf16(o[2 * n], ea[t], vb[0], vb[1]);
        vqa::mma_bf16(o[2 * n + 1], ea[t], vb[2], vb[3]);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<unsigned*>(q_w + swz(g, n) + c2) =
          pack2(o[n][0] / sum_lo, o[n][1] / sum_lo);
      *reinterpret_cast<unsigned*>(q_w + swz(g + 8, n) + c2) =
          pack2(o[n][2] / sum_hi, o[n][3] / sum_hi);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * 8; i += 32) {
      const int r = i / 8, c = i % 8;
      if (row0 + r < seq)
        *reinterpret_cast<uint4*>(out_rows + static_cast<size_t>(r) * dim +
                                  sl * kSlice + c * 8) =
            *reinterpret_cast<const uint4*>(q_w + swz(r, c));
    }
  }
}

// bf16, S > kMaxRowSeq, heads of 64 n: a block of four 16-row query slabs
// (a warp each) walks the keys a 64-key tile at a time (see
// vit_attention.cuh). Pass 0 takes each row's max m; pass 1 + o, for each
// 64-wide output slice o, takes e = exp(s - m) in f32, the f32 sum of e and
// f32(cast(e) . v) of v's slice o, and stores it divided by the sum. The
// ring's unit is one (tile, slice) of a pass: k's slice, v's slice o with
// the last slice of a tile in an output pass, and, for heads of more than
// one slice, the block's q rows of that slice (one slice stays staged from
// the start).
__global__ void __launch_bounds__(kWarps * 32)
attention_mma_long_kernel(const bf16* __restrict__ qkv,  // [B, S, 3*H*D]
                          bf16* __restrict__ out,        // [B, S, H * D]
                          int seq, int heads, int slices, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  // Two stages of [k | v | q] slices, each [64][64] swizzled; then, for a
  // head of one slice, the block's q rows.
  bf16* stages = reinterpret_cast<bf16*>(smem);
  bf16* q_fixed = stages + 2 * 3 * kTileElems;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const bf16* image = qkv + static_cast<size_t>(b) * seq * stride + h * head;
  const int q0 = blockIdx.x * kLongTile, row0 = q0 + warp * 16;
  const int tiles = (seq + kLongTile - 1) / kLongTile;
  const int per_pass = tiles * slices, units = (1 + slices) * per_pass;

  auto issue = [&](int u) {
    const int pass = u / per_pass, t = u % per_pass / slices,
              sl = u % slices;
    bf16* st = stages + (u & 1) * 3 * kTileElems;
    const int key0 = t * kLongTile;
    stage_async(st, image + dim + sl * kSlice, stride, key0,
                key0 + kLongTile, seq, tid, kWarps * 32);
    if (pass > 0 && sl == slices - 1)
      stage_async(st + kTileElems, image + 2 * dim + (pass - 1) * kSlice,
                  stride, key0, key0 + kLongTile, seq, tid, kWarps * 32);
    if (slices > 1)
      stage_async(st + 2 * kTileElems, image + sl * kSlice, stride, q0,
                  q0 + kLongTile, seq, tid, kWarps * 32);
  };

  const Lanes ln(lane);
  const int c2 = lane % 4 * 2;  // accumulator column
  if (slices == 1)
    stage_async(q_fixed, image, stride, q0, q0 + kLongTile, seq, tid,
                kWarps * 32);
  issue(0);
  cp_async_commit();

  float s[8][4], o[8][4];
  float m_lo = -INFINITY, m_hi = -INFINITY, sum_lo = 0.0f, sum_hi = 0.0f;
  unsigned qa[4][4];
  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) issue(u + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int pass = u / per_pass, t = u % per_pass / slices,
              sl = u % slices;
    const bf16* st = stages + (u & 1) * 3 * kTileElems;
    if (slices > 1 || u == 0)
      load_rows(qa, (slices > 1 ? st + 2 * kTileElems : q_fixed) +
                        warp * 16 * kSlice, ln);
    if (sl == 0) zero(s);
    tile_products(s, qa, st, ln);
    if (sl == slices - 1) {
      const int key0 = t * kLongTile;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          s[j][x] *= scale;
          if (key0 + j * 8 + c2 + (x & 1) >= seq) s[j][x] = -INFINITY;
        }
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
          m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
        }
        if (t == tiles - 1) {
          m_lo = quad_max(m_lo);
          m_hi = quad_max(m_hi);
        }
      } else {
        if (t == 0) {
          zero(o);
          sum_lo = sum_hi = 0.0f;
        }
        unsigned ea[4][4];  // cast(e) of the tile's four 16-key parts
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float* x = s[2 * j + jj];
            const float e0 = expf(x[0] - m_lo), e1 = expf(x[1] - m_lo);
            const float e2 = expf(x[2] - m_hi), e3 = expf(x[3] - m_hi);
            sum_lo += e0 + e1;
            sum_hi += e2 + e3;
            ea[j][2 * jj] = pack2(e0, e1);
            ea[j][2 * jj + 1] = pack2(e2, e3);
          }
        tile_times(o, ea, st + kTileElems, ln);
        if (t == tiles - 1) {
          const float lo = quad_sum(sum_lo), hi = quad_sum(sum_hi);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            o[n][0] /= lo;
            o[n][1] /= lo;
            o[n][2] /= hi;
            o[n][3] /= hi;
          }
          store_acc_rows(out + static_cast<size_t>(b) * seq * dim + h * head +
                             (pass - 1) * kSlice,
                         dim, row0, seq, o, 1.0f, lane);
        }
      }
    }
    __syncthreads();  // the stage is free for unit u + 2
  }
}

cudaError_t run_bf16_long(const bf16* qkv, bf16* out, int batch, int seq,
                          int heads, int slices, float scale,
                          cudaStream_t stream) {
  const size_t shared =
      sizeof(bf16) * kTileElems * (2 * 3 + (slices == 1 ? 1 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      attention_mma_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kLongTile - 1) / kLongTile, heads, batch);
  attention_mma_long_kernel<<<grid, kWarps * 32, shared, stream>>>(
      qkv, out, seq, heads, slices, scale);
  return cudaGetLastError();
}

// bf16, heads of 64 and 128, where the plan names the wgmma design (past
// kMaxRowSeq tokens; vit_attention_wgmma.cuh): a block of plan.rows query
// rows, a consumer warpgroup for each 64 of them, and a producer warpgroup
// whose one thread stages the block's q rows once and then, through the
// ring, each 64-key tile of k (pass 1) and of k and v (pass 2): a unit.
// Pass 1: s = f32(q . k^T) * scale (wgmma, both operands from shared
// memory), keys at or past S masked, the row max m. Pass 2: s again, e =
// exp(s - m) in f32, its f32 sum, cast(e) rounded in registers into
// wgmma's register A, o += cast(e) . v (v MN-major); at the end o / sum,
// rounded and stored. The tensor cores take the next unit's scores and the
// unit before's e . v while a unit's softmax runs.
template <int kSlices, int kConsumers>
__global__ void __launch_bounds__((1 + kConsumers) * kWgThreads, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                       bf16* __restrict__ out,  // [B, S, H * D]
                       int seq, int heads, int rows, int stages,
                       float scale) {
  namespace wg = vqa::wgmma;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int q_slice_bytes = rows * 128;  // [rows][64] a head slice
  unsigned char* ring_s = smem + kSlices * q_slice_bytes;
  constexpr int kStageBytes = 2 * kSlices * kSliceBytes;  // k | v slices
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_s + stages * kStageBytes);
  uint64_t* empty = full + stages;
  uint64_t* q_full = empty + stages;

  const int h = blockIdx.y, b = blockIdx.z;
  constexpr int kHead = kSlices * kSlice;
  const int dim = heads * kHead;
  const int q0 = blockIdx.x * rows;
  const int active = consumers(q0, rows, seq);
  const int tiles = (seq + kRingRows - 1) / kRingRows, units = 2 * tiles;
  const int wgi = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      ring::init(&full[s], 1);
      ring::init(&empty[s], 4 * active);  // each consumer warp
    }
    ring::init(q_full, 1);
    ring::init_fence();
  }
  __syncthreads();

  if (wgi == 0) {  // the producer
    wg::regs_release<kProducerRegs>();
    if (threadIdx.x != 0) return;
    ring::expect(q_full, kSlices * active * kSliceBytes);
    for (int sl = 0; sl < kSlices; ++sl)
      for (int c = 0; c < active; ++c)
        ring::load_3d(smem + sl * q_slice_bytes + c * kSliceBytes, &qkv_map,
                      h * kHead + sl * kSlice, q0 + c * kRingRows, b, q_full);
    for (int u = 0; u < units; ++u) {
      const int st = u % stages;
      if (u >= stages) ring::wait(&empty[st], (u / stages - 1) & 1);
      const bool with_v = u >= tiles;
      const int key0 = (u % tiles) * kRingRows;
      unsigned char* stage = ring_s + st * kStageBytes;
      ring::expect(&full[st], (with_v ? 2 : 1) * kSlices * kSliceBytes);
      for (int sl = 0; sl < kSlices; ++sl) {
        ring::load_3d(stage + sl * kSliceBytes, &qkv_map,
                      dim + h * kHead + sl * kSlice, key0, b, &full[st]);
        if (with_v)
          ring::load_3d(stage + (kSlices + sl) * kSliceBytes, &qkv_map,
                        2 * dim + h * kHead + sl * kSlice, key0, b,
                        &full[st]);
      }
    }
    return;
  }

  // A consumer: 64 query rows, a warp 16 of them. Each pass is a loop of
  // its own, every wgmma group issued, committed and waited for in
  // straight-line code (vit_attention_wgmma.cuh); the other consumers
  // compute while this one waits.
  const int c = wgi - 1;
  if (c >= active) return;
  wg::regs_take<ConsumerRegs<kConsumers>::value>();
  const int warp = threadIdx.x % kWgThreads / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + c * kRingRows + warp * 16;
  const uint32_t q_addr = wg::smem_addr(smem) + c * kSliceBytes;
  const uint32_t ring_addr = wg::smem_addr(ring_s);
  auto stage_of = [&](int u) { return ring_addr + u % stages * kStageBytes; };

  float s[32], o[kSlices][32];
  zero_acc(s);
#pragma unroll
  for (int sl = 0; sl < kSlices; ++sl) zero_acc(o[sl]);
  float m_lo = -INFINITY, m_hi = -INFINITY, sum_lo = 0.0f, sum_hi = 0.0f;
  ring::wait(q_full, 0);
  int u = 0;  // the ring's unit
  for (int t = 0; t < tiles; ++t, ++u) {  // pass 1: the row max
    ring::wait(&full[u % stages], (u / stages) & 1);
    issue_scores<kSlices>(s, q_addr, q_slice_bytes, stage_of(u));
    wg::wait<0>();
    wg::fence_operand(s);
    release(&empty[u % stages], lane);
    mask_keys(s, t * kRingRows, seq, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m_lo = fmaxf(m_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      m_hi = fmaxf(m_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
  m_lo = quad_max(m_lo) * scale;
  m_hi = quad_max(m_hi) * scale;
  for (int t = 0; t < tiles; ++t, ++u) {  // pass 2: the sums and e . v
    const uint32_t stage = stage_of(u);
    ring::wait(&full[u % stages], (u / stages) & 1);
    issue_scores<kSlices>(s, q_addr, q_slice_bytes, stage);
    wg::wait<0>();
    wg::fence_operand(s);
    mask_keys(s, t * kRingRows, seq, lane);
    // e in f32, summed before it is rounded; cast(e) is register A.
    unsigned ea[4][4];
    pack_a(ea, [&](int j, int x) {
      const float e =
          expf(shifted<kSlices>(s[4 * j + x], scale, x < 2 ? m_lo : m_hi));
      if (x < 2)
        sum_lo += e;
      else
        sum_hi += e;
      return e;
    });
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) wg::fence_operand(o[sl]);
    wg::fence();
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl)
      tile_product(o[sl], ea, stage + (kSlices + sl) * kSliceBytes);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) wg::fence_operand(o[sl]);
    release(&empty[u % stages], lane);
  }
  const float lo = quad_sum(sum_lo), hi = quad_sum(sum_hi);
#pragma unroll
  for (int sl = 0; sl < kSlices; ++sl) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[sl][4 * j] /= lo;
      o[sl][4 * j + 1] /= lo;
      o[sl][4 * j + 2] /= hi;
      o[sl][4 * j + 3] /= hi;
    }
    store_acc(out + static_cast<size_t>(b) * seq * dim + h * kHead +
                  sl * kSlice,
              dim, row0, seq, o[sl], 1.0f, lane);
  }
}

cudaError_t run_bf16_wgmma(const bf16* qkv, bf16* out, int batch, int seq,
                           int heads, int slices, float scale,
                           const Plan& plan, cudaStream_t stream) {
  if (!plan_shape_ok(plan) || slices > 2) return cudaErrorInvalidValue;
  const size_t need =
      ring_shared(static_cast<size_t>(slices) * plan.rows * 128,
                  2 * slices * kSliceBytes, plan.stages);
  if (need > static_cast<size_t>(plan.shared) || plan.shared > kMaxShared)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = slice_map(&map, qkv, 3 * heads * slices * kSlice, seq,
                              batch);
  if (err != cudaSuccess) return err;
  // Blocks of three consumer warpgroups where the plan's rows are 192,
  // else of two (one of them idle for rows of 64).
  const bool three = plan.rows == 3 * kRingRows;
  auto kernel = slices == 1 ? (three ? attention_wgmma_kernel<1, 3>
                                     : attention_wgmma_kernel<1, 2>)
                            : (three ? attention_wgmma_kernel<2, 3>
                                     : attention_wgmma_kernel<2, 2>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.shared);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + plan.rows - 1) / plan.rows, heads, batch);
  kernel<<<grid, (three ? 4 : 3) * kWgThreads, plan.shared, stream>>>(
      map, out, seq, heads, plan.rows, plan.stages, scale);
  return cudaGetLastError();
}

cudaError_t run_bf16(const bf16* qkv, bf16* out, int batch, int seq,
                     int heads, int slices, float scale, int sms,
                     cudaStream_t stream) {
  if (long_sequence(seq))
    return run_bf16_long(qkv, out, batch, seq, heads, slices, scale, stream);
  return with_key_tiles(seq, [&](auto tiles) {
    constexpr int kTiles = decltype(tiles)::value;
    const int slabs = padded(seq) / 16;
    if (slices > 1) {
      constexpr size_t shared =
          sizeof(bf16) * (kTiles * 16 + kWarps * 16) * kSlice;
      static_assert(shared <= kMaxShared, "a slice of k and q fit a block");
      auto kernel = attention_mma_sliced_kernel<kTiles>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared));
      if (err != cudaSuccess) return err;
      const dim3 grid((slabs + kWarps - 1) / kWarps, heads, batch);
      kernel<<<grid, kWarps * 32, shared, stream>>>(qkv, out, seq, heads,
                                                    slices, scale);
      return cudaGetLastError();
    }
    constexpr size_t shared = 3 * sizeof(bf16) * kTiles * 16 * kSlice;
    static_assert(shared <= kMaxShared, "q, k and v of a head fit a block");
    auto kernel = attention_mma_kernel<kTiles>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
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
attention_fma_kernel(const float* __restrict__ qkv,  // [B, S, 3 * H * D]
                     float* __restrict__ out,        // [B, S, H * D]
                     int seq, int heads, int slices, float scale) {
  constexpr int kLd = kLdF32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded(seq);
  const int lds = score_ld(sp);
  float* k_s = reinterpret_cast<float*>(smem);  // [sp][kLd], a slice
  float* v_s = k_s + sp * kLd;                  // [sp][kLd], a slice
  float* sc_all = v_s + sp * kLd;               // [kWarpsF32][16][lds]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const float* image = qkv + static_cast<size_t>(b) * seq * stride + h * head;
  const int row0 = (blockIdx.x * kWarpsF32 + warp) * 16;
  // A warp without rows still takes every barrier.
  const bool active = row0 < seq;

  float* sc = sc_all + warp * 16 * lds;
  float* out_rows = out + (static_cast<size_t>(b) * seq + row0) * dim +
                    h * head;
  float* q_s = sc_all + kWarpsF32 * 16 * lds + warp * 16 * kSlice;  // [16][64]
  // The scores, summed over the head's slices: lane owns key column c, its
  // k row in registers, the 16 q rows broadcast.
  for (int sl = 0; sl < slices; ++sl) {
    if (sl) __syncthreads();  // every warp is done with the last k slice
    stage_rows(k_s, kLd, image + dim + sl * kSlice, stride, 0, sp, seq,
               static_cast<int>(threadIdx.x), kWarpsF32 * 32);
    __syncthreads();
    if (!active) continue;
    stage_rows(q_s, kSlice, image + sl * kSlice, stride, row0, 16, seq, lane,
               32);
    __syncwarp();
    for (int c0 = 0; c0 < seq; c0 += 32) {
      const int c = c0 + lane;
      if (c < seq) {
        float kr[kSlice];
#pragma unroll
        for (int d = 0; d < kSlice; ++d) kr[d] = k_s[c * kLd + d];
        for (int r = 0; r < 16; ++r) {
          float acc = sl ? sc[r * lds + c] : 0.0f;
#pragma unroll
          for (int d = 0; d < kSlice; ++d)
            acc = fmaf(q_s[r * kSlice + d], kr[d], acc);
          sc[r * lds + c] = acc;
        }
      }
    }
    __syncwarp();  // the next slice overwrites q_s
  }
  float denom_mine = 1.0f;  // lane r keeps the denominator of row r
  if (active) {
    for (int r = 0; r < 16; ++r) {
      float* row = sc + r * lds;
      float m = -INFINITY;
      for (int c = lane; c < seq; c += 32) m = fmaxf(m, row[c] * scale);
      m = warp_max(m);
      float sum = 0.0f;
      for (int c = lane; c < seq; c += 32) {
        const float e = expf(row[c] * scale - m);
        row[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == r) denom_mine = sum;
    }
    __syncwarp();
  }
  // The output a slice at a time: lane owns columns lane and lane + 32 of
  // the slice, all 16 rows.
  for (int sl = 0; sl < slices; ++sl) {
    __syncthreads();  // every warp is done with the last v slice
    stage_rows(v_s, kLd, image + 2 * dim + sl * kSlice, stride, 0, sp, seq,
               static_cast<int>(threadIdx.x), kWarpsF32 * 32);
    __syncthreads();
    if (!active) continue;
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
        float* o = out_rows + static_cast<size_t>(r) * dim + sl * kSlice;
        o[lane] = acc[r][0] / d;
        o[lane + 32] = acc[r][1] / d;
      }
    }
  }
}

// f32, S > kMaxRowSeq: a thread per query row (kLongRowsF32 a block), the
// keys kKeysF32 at a time. Pass 0 takes each row's max; pass 1 + o, for
// each 64-wide output slice o, the f32 e, their sum and e . v of v's slice
// o, divided at the end. Each (tile, slice) is staged synchronously: k's
// slice of the tile, the block's q rows of the slice, and v's slice o of
// the tile with a tile's last slice.
constexpr int kKeysF32 = 32;

__global__ void __launch_bounds__(kLongRowsF32)
attention_fma_long_kernel(const float* __restrict__ qkv,  // [B, S, 3*H*D]
                          float* __restrict__ out,        // [B, S, H * D]
                          int seq, int heads, int slices, float scale) {
  constexpr int kLd = kLdF32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [kKeysF32][kLd]
  float* v_s = k_s + kKeysF32 * kLd;            // [kKeysF32][kLd]
  float* q_s = v_s + kKeysF32 * kLd;            // [kLongRowsF32][kLd]

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const float* image = qkv + static_cast<size_t>(b) * seq * stride + h * head;
  const int q0 = blockIdx.x * kLongRowsF32, row = q0 + tid;
  const int tiles = (seq + kKeysF32 - 1) / kKeysF32;
  const float* q_row = q_s + tid * kLd;

  float m = -INFINITY;
  for (int pass = 0; pass <= slices; ++pass) {
    float sum = 0.0f, o[kSlice];
#pragma unroll
    for (int c = 0; c < kSlice; ++c) o[c] = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      const int key0 = t * kKeysF32;
      float s[kKeysF32];
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j) s[j] = 0.0f;
      for (int sl = 0; sl < slices; ++sl) {
        __syncthreads();  // every thread is done with the last slices
        stage_rows(k_s, kLd, image + dim + sl * kSlice, stride, key0,
                   kKeysF32, seq, tid, kLongRowsF32);
        stage_rows(q_s, kLd, image + sl * kSlice, stride, q0, kLongRowsF32,
                   seq, tid, kLongRowsF32);
        if (pass > 0 && sl == slices - 1)
          stage_rows(v_s, kLd, image + 2 * dim + (pass - 1) * kSlice, stride,
                     key0, kKeysF32, seq, tid, kLongRowsF32);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kKeysF32; ++j) {
          float acc = s[j];
          for (int d = 0; d < kSlice; ++d)
            acc = fmaf(q_row[d], k_s[j * kLd + d], acc);
          s[j] = acc;
        }
      }
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j) {
        s[j] = key0 + j < seq ? s[j] * scale : -INFINITY;
        if (pass == 0) m = fmaxf(m, s[j]);
      }
      if (pass == 0) continue;
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j) {
        const float e = expf(s[j] - m);
        sum += e;
#pragma unroll
        for (int c = 0; c < kSlice; ++c)
          o[c] = fmaf(e, v_s[j * kLd + c], o[c]);
      }
    }
    if (pass > 0 && row < seq) {
      float* dst = out + (static_cast<size_t>(b) * seq + row) * dim +
                   h * head + (pass - 1) * kSlice;
#pragma unroll
      for (int c = 0; c < kSlice; ++c) dst[c] = o[c] / sum;
    }
  }
}

cudaError_t run_f32_long(const float* qkv, float* out, int batch, int seq,
                         int heads, int slices, float scale,
                         cudaStream_t stream) {
  const size_t shared =
      sizeof(float) * kLdF32 * (2 * kKeysF32 + kLongRowsF32);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fma_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kLongRowsF32 - 1) / kLongRowsF32, heads, batch);
  attention_fma_long_kernel<<<grid, kLongRowsF32, shared, stream>>>(
      qkv, out, seq, heads, slices, scale);
  return cudaGetLastError();
}

cudaError_t run_f32(const float* qkv, float* out, int batch, int seq,
                    int heads, int slices, float scale, cudaStream_t stream) {
  if (long_sequence(seq))
    return run_f32_long(qkv, out, batch, seq, heads, slices, scale, stream);
  const int sp = padded(seq);
  const size_t shared =
      sizeof(float) * (2 * static_cast<size_t>(sp) * kLdF32 +
                       kWarpsF32 * 16 * (static_cast<size_t>(score_ld(sp)) +
                                         kSlice));
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const dim3 grid((sp / 16 + kWarpsF32 - 1) / kWarpsF32, heads, batch);
  attention_fma_kernel<<<grid, kWarpsF32 * 32, shared, stream>>>(
      qkv, out, seq, heads, slices, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3 * H * D] -> out [B, S, H * D], both of the type `dtype`
// names, D = `head` a multiple of 64 and `scale` its 1 / sqrt(D) as the
// caller rounds it to f32 (a head of 64 has the exact 2^-3); `sms` is the
// device's SM count (bf16, D = 64: below it in (image, head) pairs, a head's
// query slabs spread over several blocks). `design` and the seven plan
// numbers after it are ops/vit_attention.py::attention_plan's c_args: design
// 1 runs the wgmma kernel with that plan, 0 the kernels above. One grid.
extern "C" int vqa_vit_attention(const void* qkv, void* out, int batch,
                                 int seq, int heads, int head, float scale,
                                 int sms, int dtype, int design, int rows,
                                 int key_tile, int stages, int shared,
                                 int shared_dq, int shared_dkdv,
                                 int stats_len, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  if (head < kSlice || head % kSlice) return cudaErrorInvalidValue;
  if (head == kSlice && scale != kScale) return cudaErrorInvalidValue;
  const int slices = head / kSlice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (dtype != vqa::kBFloat16) return cudaErrorInvalidValue;
    const Plan plan{rows,   key_tile,  stages,     shared,
                    shared_dq, shared_dkdv, stats_len};
    return run_bf16_wgmma(static_cast<const bf16*>(qkv),
                          static_cast<bf16*>(out), batch, seq, heads, slices,
                          scale, plan, s);
  }
  if (design != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case vqa::kBFloat16:
      return run_bf16(static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
                      batch, seq, heads, slices, scale, sms, s);
    case vqa::kFloat32:
      return run_f32(static_cast<const float*>(qkv), static_cast<float*>(out),
                     batch, seq, heads, slices, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
