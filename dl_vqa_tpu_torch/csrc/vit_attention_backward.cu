// ViT self-attention backward from the saved packed qkv (kernel 5 of the
// port).
//
// Replaces dl_vqa_tpu/ops/vit_attention_pallas.py::_attention_bwd_kernel. Per
// image b and head h, from the slices q, k, v of qkv [B, S, 3 * H * 64]
// (layout in vit_attention.cuh) and the cotangent g [B, S, H * 64] of the
// forward's output:
//   s, m, e, denom as the forward;  w = cast(e / denom)   (here the weights
//                                   are normalised before the cast)
//   dv = f32(w^T . g);  dw = f32(g . v^T)
//   dz = cast(f32(w) * (dw - rowsum(dw * f32(w))))
//   dq = f32(dz . k) * scale;  dk = f32(dz^T . q) * scale
//   dqkv[b, :, (dq | dk | dv at the packed offsets of head h)] = cast(...)
//
// What bounds it on this card: memory traffic. It has to read qkv and g and
// write dqkv once (360 MB at B = 512, S = 196, H = 4 in bf16, 0.107 ms at
// 3.35 TB/s); the five products of the function are 50 GFLOP (0.051 ms at
// the bf16 tensor-core peak). Nothing of size [S, S] reaches device memory.
//
// Past 256 tokens it is bound by its operations: 805 GFLOP against 1.44 GB
// at B = 512, S = 784 (0.814 ms at the bf16 tensor-core peak). There the
// two-grid path walks key (and query) tiles through a ring, with a pass
// over the tiles for each row statistic: eleven products' worth of
// tensor-core work for the function's five, the plain version's casts of w
// and dz kept. bf16 heads of 64 and 128 take attention_bwd_dq_wgmma_kernel
// and attention_bwd_dkdv_wgmma_kernel (every product on wgmma, TMA loads
// through an mbarrier ring, two consumer warpgroups each issuing a unit's
// products ahead of the unit before's softmax; vit_attention_wgmma.cuh,
// tiled by ops/vit_attention.py::attention_plan), other heads and f32
// attention_bwd_*_long_kernel (mma.sync or FMAs over a cp.async ring). No
// library kernel is called.
//
// Design, bf16 (ldmatrix + mma.sync m16n8k16, f32 accumulate): one grid, a
// block per (image, head), no atomics, the same digits on every run. dq sums
// over keys and dk, dv over queries, so one tiling cannot keep both sums
// inside a warp; the block runs two phases over the same staged head.
//  - Staging: q, k, v and g of the head once, by cp.async (rows at or beyond
//    S zero-filled), into unpadded swizzled 128-byte rows, and three f32
//    statistics a query row: 4 x 208 x 128 + 3 x 208 x 4 = 108,992 bytes at
//    S = 196, so two blocks of four warps share an SM (phase 1 holds a row
//    of w and dw: 255 registers). q, k, v and g are read once: the bytes of
//    the bound. What sets the pace is neither those bytes nor the products
//    but the softmax arithmetic of both phases at eight warps an SM.
//  - Phase 1, a warp per 16-row query slab: the scores of the slab's whole
//    row in registers (as the forward, q's fragments scaled by the exact
//    2^-3), m and denom by quad shuffles, w rounded and packed in
//    registers, dw = g . v^T in registers, delta = rowsum(dw * w), dz
//    rounded and packed as the A fragment of dq = dz . k (K by
//    ldmatrix.trans). m, denom and delta go to shared memory.
//  - One barrier.
//  - Phase 2, a warp per 16-key slab, over the query tiles: the tile is
//    computed transposed, k-first (A = k rows scaled by 2^-3, B = q as it
//    is stored), so its accumulator is the [key][query] A operand of
//    dv = w^T . g and dk = dz^T . q (g and q by ldmatrix.trans); w and dz
//    come from the same arithmetic on the same products and statistics as
//    in phase 1. dk and dv stay in registers that the warp owns from first
//    to last; two query tiles are in flight at a time.
// The cost of the choice: the scores and dw are computed twice (seven
// products instead of five); in exchange no sum crosses a warp and no
// score, weight or dz buffer exists in shared memory.
// f32 goes through plain FMAs in two grids (dq over query tiles, which also
// writes the statistics to a device scratch [B, H, 3, S]; dk and dv over key
// tiles); it is off the main path and slower than its plain version.

#include "vit_attention_wgmma.cuh"

namespace {

using namespace vqa_vit;

// ---------------------------------------------------------------- bf16

constexpr int kWarps = 4;

template <int kTiles>  // 16-key tiles a score row spans
__global__ void __launch_bounds__(kWarps * 32, 2)
attention_bwd_mma_kernel(const bf16* __restrict__ qkv,  // [B, S, 3*H*64]
                         const bf16* __restrict__ g,    // [B, S, H * 64]
                         bf16* __restrict__ dqkv,       // [B, S, 3*H*64]
                         int seq, int heads) {
  constexpr int kRows = kTiles * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // each [kRows][64], swizzled
  bf16* k_s = q_s + kRows * kSlice;
  bf16* v_s = k_s + kRows * kSlice;
  bf16* g_s = v_s + kRows * kSlice;
  // [3][kRows]
  float* stat_s = reinterpret_cast<float*>(g_s + kRows * kSlice);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int dim = heads * kSlice, stride = 3 * dim;
  const size_t image_row0 = static_cast<size_t>(b) * seq;
  const bf16* image = qkv + image_row0 * stride + h * kSlice;
  const bf16* g_image = g + image_row0 * dim + h * kSlice;
  bf16* d_image = dqkv + image_row0 * stride + h * kSlice;
  const int slabs = padded(seq) / 16;

  stage_async(q_s, image, stride, 0, slabs * 16, seq, tid, kWarps * 32);
  stage_async(k_s, image + dim, stride, 0, kRows, seq, tid, kWarps * 32);
  stage_async(v_s, image + 2 * dim, stride, 0, kRows, seq, tid, kWarps * 32);
  stage_async(g_s, g_image, dim, 0, slabs * 16, seq, tid, kWarps * 32);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const Lanes ln(lane);
  const int gr = lane / 4, c2 = lane % 4 * 2;  // accumulator row, column

  // A warp's [16][64] accumulator times `mul`, rounded, into rows row0 ..
  // row0 + 15 of `dst` (those at or beyond S skipped), a bf16 pair a store.
  auto store_rows = [&](bf16* dst, int row0, const float (&acc)[8][4],
                        float mul) {
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
  };

  // ---- phase 1: a warp per query slab; dq and the row statistics.
  for (int slab = warp; slab < slabs; slab += kWarps) {
    const int row0 = slab * 16;
    unsigned qa[4][4], ga[4][4];  // q / sqrt(64), g
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      vqa::ldmatrix_x4(qa[kk],
                       q_s + swz(row0 + ln.a_row, 2 * kk + ln.a_chunk));
      scale_fragment(qa[kk]);
      vqa::ldmatrix_x4(ga[kk],
                       g_s + swz(row0 + ln.a_row, 2 * kk + ln.a_chunk));
    }
    // s[j]: keys 8 j .. 8 j + 7; a lane holds rows gr (s[j][0..1]) and
    // gr + 8 (s[j][2..3]), keys 8 j + c2 and the next.
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
    float den_lo = 0.0f, den_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j) {
      s[j][0] = expf(s[j][0] - m_lo);
      s[j][1] = expf(s[j][1] - m_lo);
      s[j][2] = expf(s[j][2] - m_hi);
      s[j][3] = expf(s[j][3] - m_hi);
      den_lo += s[j][0] + s[j][1];
      den_hi += s[j][2] + s[j][3];
    }
    den_lo = quad_sum(den_lo);
    den_hi = quad_sum(den_hi);
    // w: the normalised weight, rounded before it is used; w[j][0] holds
    // row gr, w[j][1] row gr + 8.
    unsigned w[2 * kTiles][2];
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j) {
      w[j][0] = pack2(s[j][0] / den_lo, s[j][1] / den_lo);
      w[j][1] = pack2(s[j][2] / den_hi, s[j][3] / den_hi);
    }

    float dw[2 * kTiles][4];
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) dw[j][x] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        unsigned vb[4];
        vqa::ldmatrix_x4(vb,
                         v_s + swz(t * 16 + ln.bn_row, 2 * kk + ln.bn_chunk));
        vqa::mma_bf16(dw[2 * t], ga[kk], vb[0], vb[1]);
        vqa::mma_bf16(dw[2 * t + 1], ga[kk], vb[2], vb[3]);
      }
    float del_lo = 0.0f, del_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j) {
      const float2 lo = unpack2(w[j][0]), hi = unpack2(w[j][1]);
      del_lo += dw[j][0] * lo.x + dw[j][1] * lo.y;
      del_hi += dw[j][2] * hi.x + dw[j][3] * hi.y;
    }
    del_lo = quad_sum(del_lo);
    del_hi = quad_sum(del_hi);
    if (lane % 4 == 0) {
      stat_s[row0 + gr] = m_lo;
      stat_s[row0 + gr + 8] = m_hi;
      stat_s[kRows + row0 + gr] = den_lo;
      stat_s[kRows + row0 + gr + 8] = den_hi;
      stat_s[2 * kRows + row0 + gr] = del_lo;
      stat_s[2 * kRows + row0 + gr + 8] = del_hi;
    }

    // dz = cast(w (dw - delta)), packed as w is (w and dw die as it is
    // made); two neighbouring n8 tiles are one k16 A fragment of dq = dz . k.
    unsigned dz[2 * kTiles][2];
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j) {
      const float2 lo = unpack2(w[j][0]), hi = unpack2(w[j][1]);
      dz[j][0] = pack2(lo.x * (dw[j][0] - del_lo), lo.y * (dw[j][1] - del_lo));
      dz[j][1] = pack2(hi.x * (dw[j][2] - del_hi), hi.y * (dw[j][3] - del_hi));
    }
    float dq[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) dq[n][x] = 0.0f;
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const unsigned za[4] = {dz[2 * t][0], dz[2 * t][1], dz[2 * t + 1][0],
                              dz[2 * t + 1][1]};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        unsigned kb[4];
        vqa::ldmatrix_x4_trans(
            kb, k_s + swz(t * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
        vqa::mma_bf16(dq[2 * n], za, kb[0], kb[1]);
        vqa::mma_bf16(dq[2 * n + 1], za, kb[2], kb[3]);
      }
    }
    store_rows(d_image, row0, dq, kScale);
  }
  __syncthreads();  // every query row's statistics are in stat_s

  // ---- phase 2: a warp per key slab; dk and dv over all query tiles.
  for (int kslab = warp; kslab < slabs; kslab += kWarps) {
    const int key0 = kslab * 16;
    unsigned ka[4][4], va[4][4];  // k / sqrt(64), v
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      vqa::ldmatrix_x4(ka[kk],
                       k_s + swz(key0 + ln.a_row, 2 * kk + ln.a_chunk));
      scale_fragment(ka[kk]);
      vqa::ldmatrix_x4(va[kk],
                       v_s + swz(key0 + ln.a_row, 2 * kk + ln.a_chunk));
    }
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) dk[n][x] = dv[n][x] = 0.0f;
#pragma unroll 2
    for (int t = 0; t < slabs; ++t) {
      // st[jj]: s^T of keys key0 + gr (st[jj][0..1]) and key0 + gr + 8
      // (st[jj][2..3]) against queries 16 t + 8 jj + c2 and the next; dwt
      // the same of dw^T.
      float st[2][4], dwt[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) st[jj][x] = dwt[jj][x] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned qb[4], gb[4];
        vqa::ldmatrix_x4(qb,
                         q_s + swz(t * 16 + ln.bn_row, 2 * kk + ln.bn_chunk));
        vqa::ldmatrix_x4(gb,
                         g_s + swz(t * 16 + ln.bn_row, 2 * kk + ln.bn_chunk));
        vqa::mma_bf16(st[0], ka[kk], qb[0], qb[1]);
        vqa::mma_bf16(st[1], ka[kk], qb[2], qb[3]);
        vqa::mma_bf16(dwt[0], va[kk], gb[0], gb[1]);
        vqa::mma_bf16(dwt[1], va[kk], gb[2], gb[3]);
      }
      // w and dz of the tile as in phase 1, packed as A fragments of
      // [key][query]: (key gr, queries c2..) of tile jj in register 2 jj,
      // key gr + 8 in 2 jj + 1.
      unsigned wa[4], za[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int q0 = t * 16 + jj * 8 + c2;
        float wv[4], zv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int q = q0 + (x & 1);
          const float e = expf(st[jj][x] - stat_s[q]);
          wv[x] = __bfloat162float(__float2bfloat16(e / stat_s[kRows + q]));
          zv[x] = wv[x] * (dwt[jj][x] - stat_s[2 * kRows + q]);
        }
        wa[2 * jj] = pack2(wv[0], wv[1]);
        wa[2 * jj + 1] = pack2(wv[2], wv[3]);
        za[2 * jj] = pack2(zv[0], zv[1]);
        za[2 * jj + 1] = pack2(zv[2], zv[3]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        unsigned gb[4], qb[4];
        vqa::ldmatrix_x4_trans(
            gb, g_s + swz(t * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
        vqa::ldmatrix_x4_trans(
            qb, q_s + swz(t * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
        vqa::mma_bf16(dv[2 * n], wa, gb[0], gb[1]);
        vqa::mma_bf16(dv[2 * n + 1], wa, gb[2], gb[3]);
        vqa::mma_bf16(dk[2 * n], za, qb[0], qb[1]);
        vqa::mma_bf16(dk[2 * n + 1], za, qb[2], qb[3]);
      }
    }
    store_rows(d_image + dim, key0, dk, kScale);
    store_rows(d_image + 2 * dim, key0, dv, 1.0f);
  }
}

// Heads of 64 n for n > 1 take two grids with the row statistics in a
// device scratch [B, H, 3, S] between them, each walking the head a 64-wide
// slice at a time, so that shared memory does not grow with D.
//
// Grid 1 (dq): a block of four query slabs, a warp each. The scores summed
// over the slices (stage a slice of k and of the block's q rows, add its
// four k16 steps), scaled in f32, the softmax and w as in the one-slice
// kernel's phase 1; then dw = g . v^T summed over the slices the same way,
// delta and dz; m, denom and delta of each query row to `stats`; then dq a
// slice at a time (stage k's slice, dz . k over every key, store).
template <int kTiles>  // 16-key tiles a score row spans
__global__ void __launch_bounds__(kWarps * 32, 2)
attention_bwd_dq_mma_kernel(const bf16* __restrict__ qkv,  // [B, S, 3*H*D]
                            const bf16* __restrict__ g,    // [B, S, H * D]
                            bf16* __restrict__ dqkv,       // [B, S, 3*H*D]
                            float* __restrict__ stats,     // [B, H, 3, S]
                            int seq, int heads, int slices, float scale) {
  constexpr int kRows = kTiles * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem);  // [kRows][64]: k's or v's
  bf16* qg_s = kv_s + kRows * kSlice;          // [4 slabs][16][64]: q or g

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const size_t image_row0 = static_cast<size_t>(b) * seq;
  const bf16* image = qkv + image_row0 * stride + h * head;
  const bf16* g_image = g + image_row0 * dim + h * head;
  bf16* d_image = dqkv + image_row0 * stride + h * head;
  float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  const int slab0 = blockIdx.x * kWarps;
  const int slab1 = min(padded(seq) / 16, slab0 + kWarps);
  const int row0 = (slab0 + warp) * 16;
  // A warp without a slab still takes every barrier.
  const bool active = slab0 + warp < slab1;
  const bf16* qg_w = qg_s + warp * 16 * kSlice;  // the warp's 16 rows

  const Lanes ln(lane);
  const int gr = lane / 4, c2 = lane % 4 * 2;  // accumulator row, column

  // Stage a slice of every row of `rows` into kv_s and of the block's rows
  // of `mine` (row stride `mine_stride`) into qg_s, then wait for both.
  auto stage = [&](const bf16* rows, const bf16* mine, int mine_stride) {
    stage_async(kv_s, rows, stride, 0, kRows, seq, tid, kWarps * 32);
    if (mine != nullptr)
      stage_async(qg_s, mine, mine_stride, slab0 * 16, slab1 * 16, seq, tid,
                  kWarps * 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  };
  // acc[j] += (the warp's rows of qg_s) . (kv_s's rows of tile j / 2)^T.
  auto rows_times_kv = [&](float (&acc)[2 * kTiles][4]) {
    unsigned a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      vqa::ldmatrix_x4(a[kk], qg_w + swz(ln.a_row, 2 * kk + ln.a_chunk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        unsigned kb[4];
        vqa::ldmatrix_x4(kb,
                         kv_s + swz(t * 16 + ln.bn_row, 2 * kk + ln.bn_chunk));
        vqa::mma_bf16(acc[2 * t], a[kk], kb[0], kb[1]);
        vqa::mma_bf16(acc[2 * t + 1], a[kk], kb[2], kb[3]);
      }
  };

  float s[2 * kTiles][4];
#pragma unroll
  for (int j = 0; j < 2 * kTiles; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[j][x] = 0.0f;
  for (int sl = 0; sl < slices; ++sl) {
    if (sl) __syncthreads();  // every warp is done with the last slice
    stage(image + dim + sl * kSlice, image + sl * kSlice, stride);
    if (active) rows_times_kv(s);
  }
  // w: the normalised weight, rounded before it is used; w[j][0] holds row
  // gr, w[j][1] row gr + 8.
  unsigned w[2 * kTiles][2];
  float m_lo = -INFINITY, m_hi = -INFINITY, den_lo = 0.0f, den_hi = 0.0f;
  if (active) {
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
    for (int j = 0; j < 2 * kTiles; ++j) {
      s[j][0] = expf(s[j][0] - m_lo);
      s[j][1] = expf(s[j][1] - m_lo);
      s[j][2] = expf(s[j][2] - m_hi);
      s[j][3] = expf(s[j][3] - m_hi);
      den_lo += s[j][0] + s[j][1];
      den_hi += s[j][2] + s[j][3];
    }
    den_lo = quad_sum(den_lo);
    den_hi = quad_sum(den_hi);
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j) {
      w[j][0] = pack2(s[j][0] / den_lo, s[j][1] / den_lo);
      w[j][1] = pack2(s[j][2] / den_hi, s[j][3] / den_hi);
    }
  }

  float dw[2 * kTiles][4];
#pragma unroll
  for (int j = 0; j < 2 * kTiles; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dw[j][x] = 0.0f;
  for (int sl = 0; sl < slices; ++sl) {
    __syncthreads();  // every warp is done with kv_s and qg_s
    stage(image + 2 * dim + sl * kSlice, g_image + sl * kSlice, dim);
    if (active) rows_times_kv(dw);
  }
  // dz = cast(w (dw - delta)), packed as w is; two neighbouring n8 tiles are
  // one k16 A fragment of dq = dz . k.
  unsigned dz[2 * kTiles][2];
  if (active) {
    float del_lo = 0.0f, del_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j) {
      const float2 lo = unpack2(w[j][0]), hi = unpack2(w[j][1]);
      del_lo += dw[j][0] * lo.x + dw[j][1] * lo.y;
      del_hi += dw[j][2] * hi.x + dw[j][3] * hi.y;
    }
    del_lo = quad_sum(del_lo);
    del_hi = quad_sum(del_hi);
    if (lane % 4 == 0) {
      const float row_stats[2][3] = {{m_lo, den_lo, del_lo},
                                     {m_hi, den_hi, del_hi}};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + gr + 8 * half;
        if (row < seq)
#pragma unroll
          for (int p = 0; p < 3; ++p) stat[p * seq + row] = row_stats[half][p];
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j) {
      const float2 lo = unpack2(w[j][0]), hi = unpack2(w[j][1]);
      dz[j][0] = pack2(lo.x * (dw[j][0] - del_lo), lo.y * (dw[j][1] - del_lo));
      dz[j][1] = pack2(hi.x * (dw[j][2] - del_hi), hi.y * (dw[j][3] - del_hi));
    }
  }

  for (int sl = 0; sl < slices; ++sl) {
    __syncthreads();  // every warp is done with kv_s
    stage(image + dim + sl * kSlice, nullptr, 0);
    if (!active) continue;
    float dq[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) dq[n][x] = 0.0f;
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const unsigned za[4] = {dz[2 * t][0], dz[2 * t][1], dz[2 * t + 1][0],
                              dz[2 * t + 1][1]};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        unsigned kb[4];
        vqa::ldmatrix_x4_trans(
            kb, kv_s + swz(t * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
        vqa::mma_bf16(dq[2 * n], za, kb[0], kb[1]);
        vqa::mma_bf16(dq[2 * n + 1], za, kb[2], kb[3]);
      }
    }
    store_acc_rows(d_image + sl * kSlice, stride, row0, seq, dq, scale, lane);
  }
}

// Grid 2 (dk, dv) of a head of 64 n, n > 1: a block of four key slabs, a
// warp each. The transposed scores s^T of the warp's 16 keys against every
// query, summed over the slices (stage a slice of every q row and of the
// block's k rows), then w from the row statistics (the same arithmetic on
// the same products as grid 1), kept as A fragments of [key][query] in the
// warp's part of shared memory; dw^T the same way from g and v, and dz
// beside w. Then dk = dz^T . q and dv = w^T . g a slice at a time (stage q's
// slice, then g's).
template <int kTiles>  // 16-query tiles a transposed score row spans
__global__ void __launch_bounds__(kWarps * 32, 2)
attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ qkv,   // [B, S, 3*H*D]
                              const bf16* __restrict__ g,     // [B, S, H * D]
                              bf16* __restrict__ dqkv,        // [B, S, 3*H*D]
                              const float* __restrict__ stats,  // [B,H,3,S]
                              int seq, int heads, int slices, float scale) {
  constexpr int kRows = kTiles * 16;
  constexpr int kFrags = kTiles * 4 * 32;  // a warp's fragments of [16][kRows]
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qg_s = reinterpret_cast<bf16*>(smem);  // [kRows][64]: q's or g's
  bf16* kv_s = qg_s + kRows * kSlice;          // [4 slabs][16][64]: k or v
  unsigned* w_f = reinterpret_cast<unsigned*>(kv_s + kWarps * 16 * kSlice);
  unsigned* z_f = w_f + kWarps * kFrags;         // [kWarps][kTiles][4][32]
  // [3][kRows]
  float* stat_s = reinterpret_cast<float*>(z_f + kWarps * kFrags);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const size_t image_row0 = static_cast<size_t>(b) * seq;
  const bf16* image = qkv + image_row0 * stride + h * head;
  const bf16* g_image = g + image_row0 * dim + h * head;
  bf16* d_image = dqkv + image_row0 * stride + h * head;
  const float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  const int slab0 = blockIdx.x * kWarps;
  const int slab1 = min(padded(seq) / 16, slab0 + kWarps);
  const int key0 = (slab0 + warp) * 16;
  const bool active = slab0 + warp < slab1;
  const bf16* kv_w = kv_s + warp * 16 * kSlice;  // the warp's 16 keys
  unsigned* w_w = w_f + warp * kFrags;
  unsigned* z_w = z_f + warp * kFrags;

  // A padded query row has q = g = 0: with m = 0, denom = 1, delta = 0 its
  // w is 1 and its dz is 0, and it adds nothing to dk or dv. The first
  // barrier below publishes these.
  for (int i = tid; i < 3 * kRows; i += kWarps * 32) {
    const int p = i / kRows, r = i % kRows;
    stat_s[i] = r < seq ? stat[p * seq + r] : (p == 1 ? 1.0f : 0.0f);
  }

  const Lanes ln(lane);
  const int c2 = lane % 4 * 2;  // accumulator column

  // Stage a slice of every row of `rows` (row stride `rows_stride`) into
  // qg_s and of the block's key rows of `mine` into kv_s, then wait.
  auto stage = [&](const bf16* rows, int rows_stride, const bf16* mine) {
    stage_async(qg_s, rows, rows_stride, 0, kRows, seq, tid, kWarps * 32);
    if (mine != nullptr)
      stage_async(kv_s, mine, stride, slab0 * 16, slab1 * 16, seq, tid,
                  kWarps * 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  };
  // acc[j] += (the warp's key rows of kv_s) . (qg_s's rows of tile j / 2)^T.
  auto keys_times_rows = [&](float (&acc)[2 * kTiles][4]) {
    unsigned a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      vqa::ldmatrix_x4(a[kk], kv_w + swz(ln.a_row, 2 * kk + ln.a_chunk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        unsigned qb[4];
        vqa::ldmatrix_x4(qb,
                         qg_s + swz(t * 16 + ln.bn_row, 2 * kk + ln.bn_chunk));
        vqa::mma_bf16(acc[2 * t], a[kk], qb[0], qb[1]);
        vqa::mma_bf16(acc[2 * t + 1], a[kk], qb[2], qb[3]);
      }
  };

  {
    // st[j]: s^T of keys key0 + gr (st[j][0..1]) and key0 + gr + 8
    // (st[j][2..3]) against queries 8 j + c2 and the next.
    float st[2 * kTiles][4];
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) st[j][x] = 0.0f;
    for (int sl = 0; sl < slices; ++sl) {
      if (sl) __syncthreads();  // every warp is done with the last slice
      stage(image + sl * kSlice, stride, image + dim + sl * kSlice);
      if (active) keys_times_rows(st);
    }
    if (active) {
      // w of the tile, packed as A fragments of [key][query]: (key gr,
      // queries c2..) of query half jj in register 2 jj, key gr + 8 in
      // 2 jj + 1.
#pragma unroll
      for (int t = 0; t < kTiles; ++t)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float wv[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int q = t * 16 + jj * 8 + c2 + (x & 1);
            const float e = expf(st[2 * t + jj][x] * scale - stat_s[q]);
            wv[x] = e / stat_s[kRows + q];
          }
          w_w[(t * 4 + 2 * jj) * 32 + lane] = pack2(wv[0], wv[1]);
          w_w[(t * 4 + 2 * jj + 1) * 32 + lane] = pack2(wv[2], wv[3]);
        }
    }
  }
  {
    float dwt[2 * kTiles][4];
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) dwt[j][x] = 0.0f;
    for (int sl = 0; sl < slices; ++sl) {
      __syncthreads();  // every warp is done with qg_s and kv_s
      stage(g_image + sl * kSlice, dim, image + 2 * dim + sl * kSlice);
      if (active) keys_times_rows(dwt);
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < kTiles; ++t)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int reg = (t * 4 + 2 * jj + half) * 32 + lane;
            const float2 wv = unpack2(w_w[reg]);
            const int q = t * 16 + jj * 8 + c2;
            const float* d = dwt[2 * t + jj] + 2 * half;
            z_w[reg] = pack2(wv.x * (d[0] - stat_s[2 * kRows + q]),
                             wv.y * (d[1] - stat_s[2 * kRows + q + 1]));
          }
    }
  }

  // dk = dz^T . q and dv = w^T . g, a slice at a time.
  const int tiles = padded(seq) / 16;
  for (int sl = 0; sl < slices; ++sl) {
    for (int part = 1; part <= 2; ++part) {  // 1: dk from q, 2: dv from g
      __syncthreads();  // every warp is done with qg_s
      if (part == 1)
        stage(image + sl * kSlice, stride, nullptr);
      else
        stage(g_image + sl * kSlice, dim, nullptr);
      if (!active) continue;
      const unsigned* frags = part == 1 ? z_w : w_w;
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[n][x] = 0.0f;
      for (int t = 0; t < tiles; ++t) {
        unsigned a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = frags[(t * 4 + i) * 32 + lane];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          unsigned xb[4];
          vqa::ldmatrix_x4_trans(
              xb, qg_s + swz(t * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
          vqa::mma_bf16(acc[2 * n], a, xb[0], xb[1]);
          vqa::mma_bf16(acc[2 * n + 1], a, xb[2], xb[3]);
        }
      }
      store_acc_rows(d_image + part * dim + sl * kSlice, stride, key0, seq,
                     acc, part == 1 ? scale : 1.0f, lane);
    }
  }
}

// bf16, S > kMaxRowSeq, heads of 64 n: the two grids of the wider heads,
// each walking the other side's rows a 64-row tile at a time (see
// vit_attention.cuh), with a pass of its own for each row statistic.
//
// Grid 1 (dq and the statistics): a block of four 16-row query slabs, a
// warp each, over the key tiles. Pass 0 takes m; pass 1 denom, the f32 sum
// of e = exp(s - m); pass 2 delta = rowsum(dw * w) with w = cast(e /
// denom) and dw = f32(g . v^T), and writes m, denom and delta of each row
// to `stats`; pass 3 + o, for each 64-wide slice o, dz = cast(w (dw -
// delta)) and dq's slice o = f32(dz . k) * scale. A ring unit is one
// (tile, slice) of a pass: k's slice, v's with passes 2 on, and for heads
// of more than one slice the block's q and g rows of that slice and, with
// a tile's last slice of a dq pass, k's slice o. A head of one slice keeps
// its q and g rows staged from the start.
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_long_kernel(const bf16* __restrict__ qkv,  // [B, S, 3*H*D]
                             const bf16* __restrict__ g,    // [B, S, H * D]
                             bf16* __restrict__ dqkv,       // [B, S, 3*H*D]
                             float* __restrict__ stats,     // [B, H, 3, S]
                             int seq, int heads, int slices, float scale) {
  enum { kK, kV, kQ, kG, kKd };
  extern __shared__ __align__(128) unsigned char smem[];
  const int slots = slices == 1 ? 2 : 5;
  bf16* stages = reinterpret_cast<bf16*>(smem);  // [2][slots][64][64]
  bf16* fixed = stages + 2 * slots * kTileElems;  // q, g rows (one slice)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const size_t image_row0 = static_cast<size_t>(b) * seq;
  const bf16* image = qkv + image_row0 * stride + h * head;
  const bf16* g_image = g + image_row0 * dim + h * head;
  bf16* d_image = dqkv + image_row0 * stride + h * head;
  float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  const int q0 = blockIdx.x * kLongTile, row0 = q0 + warp * 16;
  const int tiles = (seq + kLongTile - 1) / kLongTile;
  const int per_pass = tiles * slices, units = (3 + slices) * per_pass;

  auto slot = [&](int u, int which) -> bf16* {
    if (slices == 1) {
      if (which == kQ || which == kG) return fixed + (which - kQ) * kTileElems;
      if (which == kKd) which = kK;
    }
    return stages + ((u & 1) * slots + which) * kTileElems;
  };
  auto issue = [&](int u) {
    const int pass = u / per_pass, t = u % per_pass / slices,
              sl = u % slices, key0 = t * kLongTile;
    auto tile = [&](int which, const bf16* src) {
      stage_async(slot(u, which), src, stride, key0, key0 + kLongTile, seq,
                  tid, kWarps * 32);
    };
    tile(kK, image + dim + sl * kSlice);
    if (pass >= 2) tile(kV, image + 2 * dim + sl * kSlice);
    if (slices > 1) {
      stage_async(slot(u, kQ), image + sl * kSlice, stride, q0,
                  q0 + kLongTile, seq, tid, kWarps * 32);
      if (pass >= 2)
        stage_async(slot(u, kG), g_image + sl * kSlice, dim, q0,
                    q0 + kLongTile, seq, tid, kWarps * 32);
      if (pass >= 3 && sl == slices - 1)
        tile(kKd, image + dim + (pass - 3) * kSlice);
    }
  };

  const Lanes ln(lane);
  const int gr = lane / 4, c2 = lane % 4 * 2;
  if (slices == 1) {
    stage_async(slot(0, kQ), image, stride, q0, q0 + kLongTile, seq, tid,
                kWarps * 32);
    stage_async(slot(0, kG), g_image, dim, q0, q0 + kLongTile, seq, tid,
                kWarps * 32);
  }
  issue(0);
  cp_async_commit();

  float s[8][4], dw[8][4], dq[8][4];
  float m_lo = -INFINITY, m_hi = -INFINITY, den_lo = 0.0f, den_hi = 0.0f;
  float del_lo = 0.0f, del_hi = 0.0f;
  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) issue(u + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int pass = u / per_pass, t = u % per_pass / slices,
              sl = u % slices;
    if (sl == 0) {
      zero(s);
      zero(dw);
    }
    {
      unsigned a[4][4];
      load_rows(a, slot(u, kQ) + warp * 16 * kSlice, ln);
      tile_products(s, a, slot(u, kK), ln);
      if (pass >= 2) {
        load_rows(a, slot(u, kG) + warp * 16 * kSlice, ln);
        tile_products(dw, a, slot(u, kV), ln);
      }
    }
    if (sl == slices - 1) {
      const int key0 = t * kLongTile;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          s[j][x] *= scale;
          if (key0 + j * 8 + c2 + (x & 1) >= seq) s[j][x] = -INFINITY;
        }
      const bool last = t == tiles - 1;
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
          m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
        }
        if (last) {
          m_lo = quad_max(m_lo);
          m_hi = quad_max(m_hi);
        }
      } else if (pass == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          den_lo += expf(s[j][0] - m_lo) + expf(s[j][1] - m_lo);
          den_hi += expf(s[j][2] - m_hi) + expf(s[j][3] - m_hi);
        }
        if (last) {
          den_lo = quad_sum(den_lo);
          den_hi = quad_sum(den_hi);
        }
      } else {
        // w: the normalised weight, rounded; w[j][0] row gr, w[j][1] gr + 8.
        unsigned w[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          w[j][0] = pack2(expf(s[j][0] - m_lo) / den_lo,
                          expf(s[j][1] - m_lo) / den_lo);
          w[j][1] = pack2(expf(s[j][2] - m_hi) / den_hi,
                          expf(s[j][3] - m_hi) / den_hi);
        }
        if (pass == 2) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 lo = unpack2(w[j][0]), hi = unpack2(w[j][1]);
            del_lo += dw[j][0] * lo.x + dw[j][1] * lo.y;
            del_hi += dw[j][2] * hi.x + dw[j][3] * hi.y;
          }
          if (last) {
            del_lo = quad_sum(del_lo);
            del_hi = quad_sum(del_hi);
            if (lane % 4 == 0) {
              const float row_stats[2][3] = {{m_lo, den_lo, del_lo},
                                             {m_hi, den_hi, del_hi}};
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = row0 + gr + 8 * half;
                if (row < seq)
#pragma unroll
                  for (int p = 0; p < 3; ++p)
                    stat[p * seq + row] = row_stats[half][p];
              }
            }
          }
        } else {
          if (t == 0) zero(dq);
          // dz = cast(w (dw - delta)) of the tile's four 16-key parts, each
          // the A fragment of dq += dz . k.
          unsigned za[4][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 lo = unpack2(w[j][0]), hi = unpack2(w[j][1]);
            za[j / 2][2 * (j % 2)] =
                pack2(lo.x * (dw[j][0] - del_lo), lo.y * (dw[j][1] - del_lo));
            za[j / 2][2 * (j % 2) + 1] =
                pack2(hi.x * (dw[j][2] - del_hi), hi.y * (dw[j][3] - del_hi));
          }
          tile_times(dq, za, slot(u, kKd), ln);
          if (last)
            store_acc_rows(d_image + (pass - 3) * kSlice, stride, row0, seq,
                           dq, scale, lane);
        }
      }
    }
    __syncthreads();  // the stage is free for unit u + 2
  }
}

// Grid 2 (dk and dv): a block of four 16-key slabs, a warp each, over the
// query tiles; pass o for each 64-wide slice o. The transposed scores s^T
// of the warp's keys against the tile's queries and dw^T = f32(v . g^T),
// summed over the head's slices; w and dz from the row statistics of
// `stats` (the same arithmetic on the same products as grid 1; a padded
// query has m = 0, denom = 1, delta = 0, so its dz is 0 and, g being 0
// there, it adds nothing); dv's slice o += w^T . g and dk's += dz^T . q of
// the tile's slice o. A ring unit is one (tile, slice): q's and g's slices
// of the query tile, and for heads of more than one slice the block's k and
// v rows of that slice and, with a tile's last slice, q's and g's slice o.
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkdv_long_kernel(const bf16* __restrict__ qkv,   // [B,S,3HD]
                               const bf16* __restrict__ g,     // [B,S,HD]
                               bf16* __restrict__ dqkv,        // [B,S,3HD]
                               const float* __restrict__ stats,  // [B,H,3,S]
                               int seq, int heads, int slices, float scale) {
  enum { kQ, kG, kKs, kVs, kQd, kGd };
  extern __shared__ __align__(128) unsigned char smem[];
  const int slots = slices == 1 ? 2 : 6;
  bf16* stages = reinterpret_cast<bf16*>(smem);  // [2][slots][64][64]
  bf16* fixed = stages + 2 * slots * kTileElems;  // k, v rows (one slice)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const size_t image_row0 = static_cast<size_t>(b) * seq;
  const bf16* image = qkv + image_row0 * stride + h * head;
  const bf16* g_image = g + image_row0 * dim + h * head;
  bf16* d_image = dqkv + image_row0 * stride + h * head;
  const float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  const int k0 = blockIdx.x * kLongTile, key0 = k0 + warp * 16;
  const int tiles = (seq + kLongTile - 1) / kLongTile;
  const int per_pass = tiles * slices, units = slices * per_pass;

  auto slot = [&](int u, int which) -> bf16* {
    if (slices == 1) {
      if (which == kKs || which == kVs)
        return fixed + (which - kKs) * kTileElems;
      if (which == kQd) which = kQ;
      if (which == kGd) which = kG;
    }
    return stages + ((u & 1) * slots + which) * kTileElems;
  };
  auto issue = [&](int u) {
    const int pass = u / per_pass, t = u % per_pass / slices,
              sl = u % slices, row0 = t * kLongTile;
    stage_async(slot(u, kQ), image + sl * kSlice, stride, row0,
                row0 + kLongTile, seq, tid, kWarps * 32);
    stage_async(slot(u, kG), g_image + sl * kSlice, dim, row0,
                row0 + kLongTile, seq, tid, kWarps * 32);
    if (slices > 1) {
      stage_async(slot(u, kKs), image + dim + sl * kSlice, stride, k0,
                  k0 + kLongTile, seq, tid, kWarps * 32);
      stage_async(slot(u, kVs), image + 2 * dim + sl * kSlice, stride, k0,
                  k0 + kLongTile, seq, tid, kWarps * 32);
      if (sl == slices - 1) {
        stage_async(slot(u, kQd), image + pass * kSlice, stride, row0,
                    row0 + kLongTile, seq, tid, kWarps * 32);
        stage_async(slot(u, kGd), g_image + pass * kSlice, dim, row0,
                    row0 + kLongTile, seq, tid, kWarps * 32);
      }
    }
  };

  const Lanes ln(lane);
  const int c2 = lane % 4 * 2;
  if (slices == 1) {
    stage_async(slot(0, kKs), image + dim, stride, k0, k0 + kLongTile, seq,
                tid, kWarps * 32);
    stage_async(slot(0, kVs), image + 2 * dim, stride, k0, k0 + kLongTile,
                seq, tid, kWarps * 32);
  }
  issue(0);
  cp_async_commit();

  float st[8][4], dwt[8][4], dk[8][4], dv[8][4];
  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) issue(u + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int pass = u / per_pass, t = u % per_pass / slices,
              sl = u % slices;
    if (sl == 0) {
      zero(st);
      zero(dwt);
    }
    {
      unsigned a[4][4];
      load_rows(a, slot(u, kKs) + warp * 16 * kSlice, ln);
      tile_products(st, a, slot(u, kQ), ln);
      load_rows(a, slot(u, kVs) + warp * 16 * kSlice, ln);
      tile_products(dwt, a, slot(u, kG), ln);
    }
    if (sl == slices - 1) {
      if (t == 0) {
        zero(dk);
        zero(dv);
      }
      const bf16* q_d = slot(u, kQd);
      const bf16* g_d = slot(u, kGd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // w and dz of queries 64 t + 16 j .. + 15 as A fragments of
        // [key][query]: (key gr, queries 8 jj + c2 ..) in register 2 jj,
        // key gr + 8 in 2 jj + 1.
        unsigned wa[4], za[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float wv[4], zv[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int q = t * kLongTile + j * 16 + jj * 8 + c2 + (x & 1);
            float m = 0.0f, den = 1.0f, del = 0.0f;
            if (q < seq) {
              m = stat[q];
              den = stat[seq + q];
              del = stat[2 * seq + q];
            }
            const float e = expf(st[2 * j + jj][x] * scale - m);
            wv[x] = __bfloat162float(__float2bfloat16(e / den));
            zv[x] = wv[x] * (dwt[2 * j + jj][x] - del);
          }
          wa[2 * jj] = pack2(wv[0], wv[1]);
          wa[2 * jj + 1] = pack2(wv[2], wv[3]);
          za[2 * jj] = pack2(zv[0], zv[1]);
          za[2 * jj + 1] = pack2(zv[2], zv[3]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          unsigned gb[4], qb[4];
          vqa::ldmatrix_x4_trans(
              gb, g_d + swz(j * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
          vqa::ldmatrix_x4_trans(
              qb, q_d + swz(j * 16 + ln.bk_row, 2 * n + ln.bk_chunk));
          vqa::mma_bf16(dv[2 * n], wa, gb[0], gb[1]);
          vqa::mma_bf16(dv[2 * n + 1], wa, gb[2], gb[3]);
          vqa::mma_bf16(dk[2 * n], za, qb[0], qb[1]);
          vqa::mma_bf16(dk[2 * n + 1], za, qb[2], qb[3]);
        }
      }
      if (t == tiles - 1) {
        store_acc_rows(d_image + dim + pass * kSlice, stride, key0, seq, dk,
                       scale, lane);
        store_acc_rows(d_image + 2 * dim + pass * kSlice, stride, key0, seq,
                       dv, 1.0f, lane);
      }
    }
    __syncthreads();  // the stage is free for unit u + 2
  }
}

cudaError_t run_bf16_long(const bf16* qkv, const bf16* g, bf16* dqkv,
                          float* stats, int batch, int seq, int heads,
                          int slices, float scale, cudaStream_t stream) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  const size_t tile = sizeof(bf16) * kTileElems;
  const size_t shared_q = tile * (slices == 1 ? 2 * 2 + 2 : 2 * 5);
  const size_t shared_k = tile * (slices == 1 ? 2 * 2 + 2 : 2 * 6);
  const dim3 grid((seq + kLongTile - 1) / kLongTile, heads, batch);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_long_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared_q));
  if (err != cudaSuccess) return err;
  attention_bwd_dq_long_kernel<<<grid, kWarps * 32, shared_q, stream>>>(
      qkv, g, dqkv, stats, seq, heads, slices, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_long_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared_k));
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_long_kernel<<<grid, kWarps * 32, shared_k, stream>>>(
      qkv, g, dqkv, stats, seq, heads, slices, scale);
  return cudaGetLastError();
}

// bf16, heads of 64 and 128, where the plan names the wgmma design (past
// kMaxRowSeq tokens; vit_attention_wgmma.cuh): the two grids of
// attention_bwd_*_long_kernel with every product on wgmma and the loads on
// TMA through a ring, at the same passes and rounding points.
//
// Grid 1 (dq and the statistics): a block of plan.rows query rows, a
// consumer warpgroup for each 64, q's and g's rows of the block staged once;
// the ring carries each 64-key tile of k (passes 0 and 1) or of k and v
// (passes 2 on). Pass 0: s = f32(q . k^T) * scale, keys at or past S
// masked, m = rowmax(s). Pass 1: denom, the f32 sum of e = exp(s - m). Pass
// 2: w = cast(e / denom), dw = f32(g . v^T), delta = rowsum(dw * w); m,
// denom and delta go to `stats`. Pass 3 + o for each 64-wide head slice o:
// dz = cast(w (dw - delta)) as wgmma's register A, dq's slice o += dz . k's
// slice o (the same k tile read MN-major); stored times scale.
template <int kSlices, int kConsumers>
__global__ void __launch_bounds__((1 + kConsumers) * kWgThreads, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                              const __grid_constant__ CUtensorMap g_map,
                              bf16* __restrict__ dqkv,    // [B, S, 3 * H * D]
                              float* __restrict__ stats,  // [B, H, 3, len]
                              int seq, int heads, int rows, int stages,
                              int stats_len, float scale) {
  namespace wg = vqa::wgmma;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int slice_bytes = rows * 128;  // [rows][64] a head slice
  unsigned char* q_s = smem;
  unsigned char* g_s = smem + kSlices * slice_bytes;
  unsigned char* ring_s = g_s + kSlices * slice_bytes;
  constexpr int kStageBytes = 2 * kSlices * kSliceBytes;  // k | v slices
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_s + stages * kStageBytes);
  uint64_t* empty = full + stages;
  uint64_t* fixed_full = empty + stages;

  const int h = blockIdx.y, b = blockIdx.z;
  constexpr int kHead = kSlices * kSlice;
  const int dim = heads * kHead;
  const int q0 = blockIdx.x * rows;
  const int active = consumers(q0, rows, seq);
  const int tiles = (seq + kRingRows - 1) / kRingRows;
  const int units = (3 + kSlices) * tiles;
  const int wgi = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      ring::init(&full[s], 1);
      ring::init(&empty[s], 4 * active);
    }
    ring::init(fixed_full, 1);
    ring::init_fence();
  }
  __syncthreads();

  if (wgi == 0) {  // the producer
    wg::regs_release<kProducerRegs>();
    if (threadIdx.x != 0) return;
    ring::expect(fixed_full, 2 * kSlices * active * kSliceBytes);
    for (int sl = 0; sl < kSlices; ++sl)
      for (int c = 0; c < active; ++c) {
        const int at = sl * slice_bytes + c * kSliceBytes;
        const int col = h * kHead + sl * kSlice, row = q0 + c * kRingRows;
        ring::load_3d(q_s + at, &qkv_map, col, row, b, fixed_full);
        ring::load_3d(g_s + at, &g_map, col, row, b, fixed_full);
      }
    for (int u = 0; u < units; ++u) {
      const int st = u % stages;
      if (u >= stages) ring::wait(&empty[st], (u / stages - 1) & 1);
      const bool with_v = u / tiles >= 2;
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

  const int c = wgi - 1;
  if (c >= active) return;
  wg::regs_take<ConsumerRegs<kConsumers>::value>();
  const int warp = threadIdx.x % kWgThreads / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + c * kRingRows + warp * 16;
  const uint32_t q_addr = wg::smem_addr(q_s) + c * kSliceBytes;
  const uint32_t g_addr = wg::smem_addr(g_s) + c * kSliceBytes;
  const uint32_t ring_addr = wg::smem_addr(ring_s);
  float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * stats_len;

  // Each pass is a loop of its own, every wgmma group issued, committed and
  // waited for in straight-line code (vit_attention_wgmma.cuh).
  float s[32], dw[32], dq[32];
  zero_acc(s);
  zero_acc(dw);
  zero_acc(dq);
  float m_lo = -INFINITY, m_hi = -INFINITY, den_lo = 0.0f, den_hi = 0.0f;
  float del_lo = 0.0f, del_hi = 0.0f;
  auto stage_of = [&](int u) { return ring_addr + u % stages * kStageBytes; };
  // The scores of unit u (and dw = f32(g . v^T) with `with_dw`), waited for.
  auto products = [&](int u, auto with_dw) {
    ring::wait(&full[u % stages], (u / stages) & 1);
    wg::fence_operand(s);
    wg::fence_operand(dw);
    wg::fence();
    score_product<kSlices>(s, q_addr, slice_bytes, stage_of(u));
    if constexpr (decltype(with_dw)::value)
      score_product<kSlices>(dw, g_addr, slice_bytes,
                             stage_of(u) + kSlices * kSliceBytes);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(s);
    wg::fence_operand(dw);
  };
  using NoDw = std::false_type;
  using WithDw = std::true_type;
  auto e_of = [&](int i) {
    return expf(shifted<kSlices>(s[i], scale, i % 4 < 2 ? m_lo : m_hi));
  };
  // w = cast(e / denom) of the tile's scores: w[j][0] row l / 4, w[j][1]
  // row l / 4 + 8.
  auto weights = [&](unsigned (&w)[8][2]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j][0] = pack2(e_of(4 * j) / den_lo, e_of(4 * j + 1) / den_lo);
      w[j][1] = pack2(e_of(4 * j + 2) / den_hi, e_of(4 * j + 3) / den_hi);
    }
  };
  ring::wait(fixed_full, 0);
  int u = 0;  // the ring's unit
  for (int pass = 0; pass < 2; ++pass) {  // m, then denom
    for (int t = 0; t < tiles; ++t, ++u) {
      products(u, NoDw());
      release(&empty[u % stages], lane);
      mask_keys(s, t * kRingRows, seq, lane);
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          m_lo = fmaxf(m_lo, fmaxf(s[4 * j], s[4 * j + 1]));
          m_hi = fmaxf(m_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          den_lo += e_of(4 * j) + e_of(4 * j + 1);
          den_hi += e_of(4 * j + 2) + e_of(4 * j + 3);
        }
      }
    }
    if (pass == 0) {
      m_lo = quad_max(m_lo) * scale;
      m_hi = quad_max(m_hi) * scale;
    } else {
      den_lo = quad_sum(den_lo);
      den_hi = quad_sum(den_hi);
    }
  }
  for (int t = 0; t < tiles; ++t, ++u) {  // pass 2: delta
    products(u, WithDw());
    release(&empty[u % stages], lane);
    mask_keys(s, t * kRingRows, seq, lane);
    unsigned w[8][2];
    weights(w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lo = unpack2(w[j][0]), hi = unpack2(w[j][1]);
      del_lo += dw[4 * j] * lo.x + dw[4 * j + 1] * lo.y;
      del_hi += dw[4 * j + 2] * hi.x + dw[4 * j + 3] * hi.y;
    }
  }
  del_lo = quad_sum(del_lo);
  del_hi = quad_sum(del_hi);
  if (lane % 4 == 0) {
    const float row_stats[2][3] = {{m_lo, den_lo, del_lo},
                                   {m_hi, den_hi, del_hi}};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + lane / 4 + 8 * half;
      if (row < seq)
#pragma unroll
        for (int p = 0; p < 3; ++p)
          stat[p * stats_len + row] = row_stats[half][p];
    }
  }
  for (int o = 0; o < kSlices; ++o) {  // pass 3 + o: dq's slice o
    for (int t = 0; t < tiles; ++t, ++u) {
      products(u, WithDw());
      mask_keys(s, t * kRingRows, seq, lane);
      unsigned w[8][2];
      weights(w);
      // dz = cast(w (dw - delta)) as register A of dq += dz . k.
      unsigned za[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lo = unpack2(w[j][0]), hi = unpack2(w[j][1]);
        za[j / 2][2 * (j % 2)] = pack2(lo.x * (dw[4 * j] - del_lo),
                                       lo.y * (dw[4 * j + 1] - del_lo));
        za[j / 2][2 * (j % 2) + 1] = pack2(hi.x * (dw[4 * j + 2] - del_hi),
                                           hi.y * (dw[4 * j + 3] - del_hi));
      }
      wg::fence_operand(dq);
      wg::fence();
      tile_product(dq, za, stage_of(u) + o * kSliceBytes);
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(dq);
      release(&empty[u % stages], lane);
    }
    store_acc(dqkv + static_cast<size_t>(b) * seq * 3 * dim + h * kHead +
                  o * kSlice,
              3 * dim, row0, seq, dq, scale, lane);
    zero_acc(dq);
  }
}

// Grid 2 (dk and dv): a block of plan.rows key rows, a consumer warpgroup
// for each 64, k's and v's rows of the block staged once; the ring carries
// each 64-query tile of q and g with its three statistics rows (a pass for
// each 64-wide output slice o). s^T = f32(k . q^T) and dw^T = f32(v . g^T)
// are computed transposed, so w^T = cast(e / denom) and dz^T = cast(w (dw^T
// - delta)), from the statistics and the same arithmetic as grid 1, are
// wgmma's register A as they lie; dv's slice o += w^T . g and dk's += dz^T .
// q read the tile's slice o MN-major. A query at or past S has m = 0,
// denom = 1 and delta = 0, and its zero-filled g and q rows add nothing.
// Unlike grid 1's, these statistics are per column of the accumulator, so
// w^T and dz^T are made from them directly, with no row reduction.
template <int kSlices, int kConsumers>
__global__ void __launch_bounds__((1 + kConsumers) * kWgThreads, 1)
attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                                const __grid_constant__ CUtensorMap g_map,
                                const __grid_constant__ CUtensorMap stats_map,
                                bf16* __restrict__ dqkv,  // [B, S, 3 * H * D]
                                int seq, int heads, int rows, int stages,
                                float scale) {
  namespace wg = vqa::wgmma;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int slice_bytes = rows * 128;
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + kSlices * slice_bytes;
  unsigned char* ring_s = v_s + kSlices * slice_bytes;
  // q slices | g slices | the statistics [3][64]
  constexpr int kStageBytes = 2 * kSlices * kSliceBytes + kStatBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_s + stages * kStageBytes);
  uint64_t* empty = full + stages;
  uint64_t* fixed_full = empty + stages;

  const int h = blockIdx.y, b = blockIdx.z;
  constexpr int kHead = kSlices * kSlice;
  const int dim = heads * kHead;
  const int k0 = blockIdx.x * rows;
  const int active = consumers(k0, rows, seq);
  const int tiles = (seq + kRingRows - 1) / kRingRows;
  const int units = kSlices * tiles;
  const int wgi = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      ring::init(&full[s], 1);
      ring::init(&empty[s], 4 * active);
    }
    ring::init(fixed_full, 1);
    ring::init_fence();
  }
  __syncthreads();

  if (wgi == 0) {  // the producer
    wg::regs_release<kProducerRegs>();
    if (threadIdx.x != 0) return;
    ring::expect(fixed_full, 2 * kSlices * active * kSliceBytes);
    for (int sl = 0; sl < kSlices; ++sl)
      for (int c = 0; c < active; ++c) {
        const int at = sl * slice_bytes + c * kSliceBytes;
        const int col = h * kHead + sl * kSlice, row = k0 + c * kRingRows;
        ring::load_3d(k_s + at, &qkv_map, dim + col, row, b, fixed_full);
        ring::load_3d(v_s + at, &qkv_map, 2 * dim + col, row, b, fixed_full);
      }
    for (int u = 0; u < units; ++u) {
      const int st = u % stages;
      if (u >= stages) ring::wait(&empty[st], (u / stages - 1) & 1);
      const int row = (u % tiles) * kRingRows;
      unsigned char* stage = ring_s + st * kStageBytes;
      ring::expect(&full[st],
                   2 * kSlices * kSliceBytes + 3 * kRingRows * sizeof(float));
      for (int sl = 0; sl < kSlices; ++sl) {
        const int col = h * kHead + sl * kSlice;
        ring::load_3d(stage + sl * kSliceBytes, &qkv_map, col, row, b,
                      &full[st]);
        ring::load_3d(stage + (kSlices + sl) * kSliceBytes, &g_map, col, row,
                      b, &full[st]);
      }
      ring::load_2d(stage + 2 * kSlices * kSliceBytes, &stats_map, row,
                    (b * heads + h) * 3, &full[st]);
    }
    return;
  }

  const int c = wgi - 1;
  if (c >= active) return;
  wg::regs_take<ConsumerRegs<kConsumers>::value>();
  const int warp = threadIdx.x % kWgThreads / 32, lane = threadIdx.x % 32;
  const int key0 = k0 + c * kRingRows + warp * 16;
  const uint32_t k_addr = wg::smem_addr(k_s) + c * kSliceBytes;
  const uint32_t v_addr = wg::smem_addr(v_s) + c * kSliceBytes;
  const uint32_t ring_addr = wg::smem_addr(ring_s);

  // Every wgmma group issued, committed and waited for in straight-line
  // code (vit_attention_wgmma.cuh).
  float st[32], dwt[32], dk[32], dv[32];
  zero_acc(st);
  zero_acc(dwt);
  zero_acc(dk);
  zero_acc(dv);
  auto stage_of = [&](int u) { return ring_addr + u % stages * kStageBytes; };
  ring::wait(fixed_full, 0);
  int u = 0;  // the ring's unit
  for (int o = 0; o < kSlices; ++o) {  // a pass for each output slice
    for (int t = 0; t < tiles; ++t, ++u) {
      const uint32_t stage = stage_of(u);
      ring::wait(&full[u % stages], (u / stages) & 1);
      wg::fence_operand(st);
      wg::fence_operand(dwt);
      wg::fence();
      score_product<kSlices>(st, k_addr, slice_bytes, stage);
      score_product<kSlices>(dwt, v_addr, slice_bytes,
                             stage + kSlices * kSliceBytes);
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(st);
      wg::fence_operand(dwt);
      // The statistics of the tile's query columns 8 j + 2 (l % 4) and the
      // next, as pairs; a query at or past S (only in the tile that reaches
      // past it) takes m = 0, denom = 1, delta = 0.
      const int q0 = t * kRingRows;
      const float* stat = reinterpret_cast<const float*>(
          ring_s + u % stages * kStageBytes + 2 * kSlices * kSliceBytes);
      const bool ragged = q0 + kRingRows > seq;
      auto stats_at = [&](int p, int j, float none) {
        const int qi = acc_col(j, 0, lane);
        float2 v =
            *reinterpret_cast<const float2*>(stat + p * kRingRows + qi);
        if (ragged) {
          if (q0 + qi >= seq) v.x = none;
          if (q0 + qi + 1 >= seq) v.y = none;
        }
        return v;
      };
      // w^T = cast(e / denom) and dz^T = cast(w (dw^T - delta)) as register
      // A ([key][query]).
      unsigned wa[4][4], za[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 m = stats_at(0, j, 0.0f), den = stats_at(1, j, 1.0f);
        const float2 del = stats_at(2, j, 0.0f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = 4 * j + 2 * half;
          const unsigned w = pack2(
              expf(shifted<kSlices>(st[x], scale, m.x)) / den.x,
              expf(shifted<kSlices>(st[x + 1], scale, m.y)) / den.y);
          const float2 wf = unpack2(w);
          wa[j / 2][2 * (j % 2) + half] = w;
          za[j / 2][2 * (j % 2) + half] =
              pack2(wf.x * (dwt[x] - del.x), wf.y * (dwt[x + 1] - del.y));
        }
      }
      wg::fence_operand(dk);
      wg::fence_operand(dv);
      wg::fence();
      tile_product(dv, wa, stage + (kSlices + o) * kSliceBytes);
      tile_product(dk, za, stage + o * kSliceBytes);
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(dk);
      wg::fence_operand(dv);
      release(&empty[u % stages], lane);
    }
    bf16* d_image = dqkv + static_cast<size_t>(b) * seq * 3 * dim +
                    h * kHead + o * kSlice;
    store_acc(d_image + dim, 3 * dim, key0, seq, dk, scale, lane);
    store_acc(d_image + 2 * dim, 3 * dim, key0, seq, dv, 1.0f, lane);
    zero_acc(dk);
    zero_acc(dv);
  }
}

cudaError_t run_bf16_wgmma(const bf16* qkv, const bf16* g, bf16* dqkv,
                           float* stats, int batch, int seq, int heads,
                           int slices, float scale, const Plan& plan,
                           cudaStream_t stream) {
  if (!plan_shape_ok(plan) || slices > 2 || stats == nullptr ||
      plan.stats_len < seq || plan.stats_len % kRingRows)
    return cudaErrorInvalidValue;
  const size_t fixed = 2 * static_cast<size_t>(slices) * plan.rows * 128;
  const size_t stage = 2 * slices * kSliceBytes;
  if (ring_shared(fixed, stage, plan.stages) >
          static_cast<size_t>(plan.shared_dq) ||
      ring_shared(fixed, stage + kStatBytes, plan.stages) >
          static_cast<size_t>(plan.shared_dkdv) ||
      plan.shared_dq > kMaxShared || plan.shared_dkdv > kMaxShared)
    return cudaErrorInvalidValue;
  const int width = heads * slices * kSlice;
  CUtensorMap qkv_map, g_map, st_map;
  cudaError_t err = slice_map(&qkv_map, qkv, 3 * width, seq, batch);
  if (err == cudaSuccess) err = slice_map(&g_map, g, width, seq, batch);
  if (err == cudaSuccess)
    err = stats_map(&st_map, stats, batch * heads * 3, plan.stats_len);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + plan.rows - 1) / plan.rows, heads, batch);
  // Blocks of three consumer warpgroups where the plan's rows are 192,
  // else of two (one of them idle for rows of 64).
  const bool three = plan.rows == 3 * kRingRows;
  const int threads = (three ? 4 : 3) * kWgThreads;
  auto dq = slices == 1
                ? (three ? attention_bwd_dq_wgmma_kernel<1, 3>
                         : attention_bwd_dq_wgmma_kernel<1, 2>)
                : (three ? attention_bwd_dq_wgmma_kernel<2, 3>
                         : attention_bwd_dq_wgmma_kernel<2, 2>);
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.shared_dq);
  if (err != cudaSuccess) return err;
  dq<<<grid, threads, plan.shared_dq, stream>>>(
      qkv_map, g_map, dqkv, stats, seq, heads, plan.rows, plan.stages,
      plan.stats_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkdv = slices == 1
                  ? (three ? attention_bwd_dkdv_wgmma_kernel<1, 3>
                           : attention_bwd_dkdv_wgmma_kernel<1, 2>)
                  : (three ? attention_bwd_dkdv_wgmma_kernel<2, 3>
                           : attention_bwd_dkdv_wgmma_kernel<2, 2>);
  err = cudaFuncSetAttribute(dkdv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.shared_dkdv);
  if (err != cudaSuccess) return err;
  dkdv<<<grid, threads, plan.shared_dkdv, stream>>>(
      qkv_map, g_map, st_map, dqkv, seq, heads, plan.rows, plan.stages,
      scale);
  return cudaGetLastError();
}

cudaError_t run_bf16(const bf16* qkv, const bf16* g, bf16* dqkv,
                     float* stats, int batch, int seq, int heads, int slices,
                     float scale, cudaStream_t stream) {
  if (long_sequence(seq))
    return run_bf16_long(qkv, g, dqkv, stats, batch, seq, heads, slices,
                         scale, stream);
  return with_key_tiles(seq, [&](auto tiles) {
    constexpr int kTiles = decltype(tiles)::value;
    if (slices > 1) {
      if (stats == nullptr) return cudaErrorInvalidValue;
      constexpr size_t shared_q =
          sizeof(bf16) * (kTiles * 16 + kWarps * 16) * kSlice;
      constexpr size_t shared_k =
          sizeof(bf16) * (kTiles * 16 + kWarps * 16) * kSlice +
          2 * sizeof(unsigned) * kWarps * kTiles * 4 * 32 +
          3 * sizeof(float) * kTiles * 16;
      static_assert(shared_k <= kMaxShared, "grid 2's slices fit a block");
      const int slabs = padded(seq) / 16;
      const dim3 grid((slabs + kWarps - 1) / kWarps, heads, batch);
      auto dq = attention_bwd_dq_mma_kernel<kTiles>;
      cudaError_t err = cudaFuncSetAttribute(
          dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared_q));
      if (err != cudaSuccess) return err;
      dq<<<grid, kWarps * 32, shared_q, stream>>>(qkv, g, dqkv, stats, seq,
                                                  heads, slices, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      auto dkdv = attention_bwd_dkdv_mma_kernel<kTiles>;
      err = cudaFuncSetAttribute(
          dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared_k));
      if (err != cudaSuccess) return err;
      dkdv<<<grid, kWarps * 32, shared_k, stream>>>(qkv, g, dqkv, stats, seq,
                                                    heads, slices, scale);
      return cudaGetLastError();
    }
    constexpr size_t shared =
        (4 * sizeof(bf16) * kSlice + 3 * sizeof(float)) * kTiles * 16;
    static_assert(shared <= kMaxShared, "a head's q, k, v, g fit a block");
    auto kernel = attention_bwd_mma_kernel<kTiles>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
    kernel<<<dim3(heads, batch), kWarps * 32, shared, stream>>>(
        qkv, g, dqkv, seq, heads);
    return cudaGetLastError();
  });
}

// ---------------------------------------------------------------- f32

constexpr int kQueryWarpsF32 = 2, kKeyWarpsF32 = 4;

// Grid 1 (dq) tiles the query rows, as the forward does: a block stages a
// slice of the head's k and v, and each warp adds its 16 query rows' scores
// and dw over the slice; after the last slice each warp takes its rows
// through the softmax, dz and, a slice of k at a time, dq on its own. It
// also writes m, denom and delta = rowsum(dw * w) of each query row to
// `stats`.
__global__ void __launch_bounds__(kQueryWarpsF32 * 32)
attention_bwd_dq_kernel(const float* __restrict__ qkv,  // [B, S, 3*H*D]
                        const float* __restrict__ g,    // [B, S, H * D]
                        float* __restrict__ dqkv,       // [B, S, 3*H*D]
                        float* __restrict__ stats,      // [B, H, 3, S]
                        int seq, int heads, int slices, float scale) {
  constexpr int kLd = kLdF32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded(seq);
  const int lds = score_ld(sp);
  float* k_s = reinterpret_cast<float*>(smem);  // [sp][kLd], a slice
  float* v_s = k_s + sp * kLd;                  // [sp][kLd], a slice
  float* buf_all = v_s + sp * kLd;              // [warps][2][16][lds]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const float* image = qkv + static_cast<size_t>(b) * seq * stride + h * head;
  const float* g_image = g + static_cast<size_t>(b) * seq * dim + h * head;
  const int row0 = (blockIdx.x * kQueryWarpsF32 + warp) * 16;
  // A warp without rows still takes every barrier.
  const bool active = row0 < seq;

  float* s_buf = buf_all + warp * 2 * 16 * lds;  // scores, then w
  float* dw_buf = s_buf + 16 * lds;              // dw, then dz
  float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  float* dq_rows =
      dqkv + (static_cast<size_t>(b) * seq + row0) * stride + h * head;
  float* q_s =
      buf_all + kQueryWarpsF32 * 2 * 16 * lds + warp * 2 * 16 * kSlice;
  float* g_s = q_s + 16 * kSlice;  // both [16][64]
  // Lane owns key column c: a k (then v) row of the slice in registers, the
  // 16 q (then g) rows broadcast; the sums run on over the slices.
  for (int sl = 0; sl < slices; ++sl) {
    if (sl) __syncthreads();  // every warp is done with the last slice
    stage_rows(k_s, kLd, image + dim + sl * kSlice, stride, 0, sp, seq,
               static_cast<int>(threadIdx.x), kQueryWarpsF32 * 32);
    stage_rows(v_s, kLd, image + 2 * dim + sl * kSlice, stride, 0, sp, seq,
               static_cast<int>(threadIdx.x), kQueryWarpsF32 * 32);
    __syncthreads();
    if (!active) continue;
    stage_rows(q_s, kSlice, image + sl * kSlice, stride, row0, 16, seq, lane,
               32);
    stage_rows(g_s, kSlice, g_image + sl * kSlice, dim, row0, 16, seq, lane,
               32);
    __syncwarp();
    for (int c0 = 0; c0 < seq; c0 += 32) {
      const int c = c0 + lane;
      if (c < seq) {
        float kr[kSlice];
#pragma unroll
        for (int d = 0; d < kSlice; ++d) kr[d] = k_s[c * kLd + d];
        for (int r = 0; r < 16; ++r) {
          float acc = sl ? s_buf[r * lds + c] : 0.0f;
#pragma unroll
          for (int d = 0; d < kSlice; ++d)
            acc = fmaf(q_s[r * kSlice + d], kr[d], acc);
          s_buf[r * lds + c] = acc;
        }
#pragma unroll
        for (int d = 0; d < kSlice; ++d) kr[d] = v_s[c * kLd + d];
        for (int r = 0; r < 16; ++r) {
          float acc = sl ? dw_buf[r * lds + c] : 0.0f;
#pragma unroll
          for (int d = 0; d < kSlice; ++d)
            acc = fmaf(g_s[r * kSlice + d], kr[d], acc);
          dw_buf[r * lds + c] = acc;
        }
      }
    }
    __syncwarp();  // the next slice overwrites q_s and g_s
  }
  if (active) {
    for (int r = 0; r < 16; ++r) {
      float* row = s_buf + r * lds;
      float* dw_row = dw_buf + r * lds;
      float m = -INFINITY;
      for (int c = lane; c < seq; c += 32) m = fmaxf(m, row[c] * scale);
      m = warp_max(m);
      float sum = 0.0f;
      for (int c = lane; c < seq; c += 32) {
        const float e = expf(row[c] * scale - m);
        row[c] = e;
        sum += e;
      }
      const float denom = warp_sum(sum);
      float part = 0.0f;
      for (int c = lane; c < seq; c += 32) {
        const float w = row[c] / denom;
        row[c] = w;
        part += dw_row[c] * w;
      }
      const float delta = warp_sum(part);
      for (int c = lane; c < seq; c += 32)
        dw_row[c] = row[c] * (dw_row[c] - delta);
      if (lane == 0 && row0 + r < seq) {
        stat[row0 + r] = m;
        stat[seq + row0 + r] = denom;
        stat[2 * seq + row0 + r] = delta;
      }
    }
    __syncwarp();
  }
  // dq a slice at a time: lane owns columns lane and lane + 32 of the
  // slice, all 16 rows.
  for (int sl = 0; sl < slices; ++sl) {
    if (sl) {
      __syncthreads();  // every warp is done with the last k slice
      stage_rows(k_s, kLd, image + dim + sl * kSlice, stride, 0, sp, seq,
                 static_cast<int>(threadIdx.x), kQueryWarpsF32 * 32);
      __syncthreads();
    } else if (slices > 1) {
      __syncthreads();  // k_s holds the last slice: stage the first again
      stage_rows(k_s, kLd, image + dim, stride, 0, sp, seq,
                 static_cast<int>(threadIdx.x), kQueryWarpsF32 * 32);
      __syncthreads();
    }
    if (!active) continue;
    float acc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.0f;
    for (int c = 0; c < seq; ++c) {
      const float k0 = k_s[c * kLd + lane], k1 = k_s[c * kLd + lane + 32];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float dz = dw_buf[r * lds + c];
        acc[r][0] = fmaf(dz, k0, acc[r][0]);
        acc[r][1] = fmaf(dz, k1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (row0 + r < seq) {
        float* d = dq_rows + static_cast<size_t>(r) * stride + sl * kSlice;
        d[lane] = acc[r][0] * scale;
        d[lane + 32] = acc[r][1] * scale;
      }
    }
  }
}

// Grid 2 (dk, dv) tiles the key rows: each warp takes 16 keys. It sums the
// transposed scores s^T and dw^T of its keys against every query over the
// head's slices (a block stages a slice of every q, then g, row; the warp a
// slice of its k, then v, rows) into its two [16][lds] buffers, turns them
// into w and dz from the three row statistics (the same arithmetic on the
// same products as grid 1, so the same bits), and then takes dz^T . q and
// w^T . g a slice at a time, the queries in order.
__global__ void __launch_bounds__(kKeyWarpsF32 * 32)
attention_bwd_dkdv_kernel(const float* __restrict__ qkv,    // [B, S, 3*H*D]
                          const float* __restrict__ g,      // [B, S, H * D]
                          float* __restrict__ dqkv,         // [B, S, 3*H*D]
                          const float* __restrict__ stats,  // [B, H, 3, S]
                          int seq, int heads, int slices, float scale) {
  constexpr int kLd = kLdF32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded(seq);
  const int lds = score_ld(sp);
  float* qg_s = reinterpret_cast<float*>(smem);  // [sp][kLd]: q's or g's
  float* stat_s = qg_s + sp * kLd;               // [3][sp]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* kv_j = stat_s + 3 * sp + warp * (16 * kLd + 2 * 16 * lds);
  float* st = kv_j + 16 * kLd;  // [16][lds]: s^T, then w^T
  float* dt = st + 16 * lds;    // [16][lds]: dw^T, then dz^T

  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const float* image = qkv + static_cast<size_t>(b) * seq * stride + h * head;
  const float* g_image = g + static_cast<size_t>(b) * seq * dim + h * head;
  const float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  const int key0 = (blockIdx.x * kKeyWarpsF32 + warp) * 16;
  // A warp without keys still takes every barrier.
  const bool active = key0 < seq;

  // A padded query row has q = g = 0: with m = 0, denom = 1, delta = 0 its
  // w is 1 and its dz is 0, and it adds nothing to dk or dv. The first
  // barrier below publishes these.
  for (int i = threadIdx.x; i < 3 * sp; i += kKeyWarpsF32 * 32) {
    const int p = i / sp, r = i % sp;
    stat_s[i] = r < seq ? stat[p * seq + r] : (p == 1 ? 1.0f : 0.0f);
  }
  // Pass 0: s^T from q and k; pass 1: dw^T from g and v. Lane owns query
  // column q: its row of the slice in registers, the 16 key rows broadcast.
  for (int pass = 0; pass < 2; ++pass) {
    float* buf = pass ? dt : st;
    for (int sl = 0; sl < slices; ++sl) {
      __syncthreads();  // every warp is done with qg_s
      stage_rows(qg_s, kLd, (pass ? g_image : image) + sl * kSlice,
                 pass ? dim : stride, 0, sp, seq,
                 static_cast<int>(threadIdx.x), kKeyWarpsF32 * 32);
      __syncthreads();
      if (!active) continue;
      stage_rows(kv_j, kLd, image + (pass + 1) * dim + sl * kSlice, stride,
                 key0, 16, seq, lane, 32);
      __syncwarp();
      for (int q0 = 0; q0 < sp; q0 += 32) {
        const int q = q0 + lane;
        if (q < sp) {
          float xr[kSlice];
#pragma unroll
          for (int d = 0; d < kSlice; ++d) xr[d] = qg_s[q * kLd + d];
          for (int r = 0; r < 16; ++r) {
            float acc = sl ? buf[r * lds + q] : 0.0f;
#pragma unroll
            for (int d = 0; d < kSlice; ++d)
              acc = fmaf(xr[d], kv_j[r * kLd + d], acc);
            buf[r * lds + q] = acc;
          }
        }
      }
      __syncwarp();  // the next slice overwrites kv_j
    }
  }
  if (active) {
    for (int r = 0; r < 16; ++r)
      for (int q = lane; q < sp; q += 32) {
        const float w =
            expf(st[r * lds + q] * scale - stat_s[q]) / stat_s[sp + q];
        st[r * lds + q] = w;
        dt[r * lds + q] = w * (dt[r * lds + q] - stat_s[2 * sp + q]);
      }
    __syncwarp();
  }
  // Part 1: dk = dz^T . q; part 2: dv = w^T . g. Lane owns columns lane and
  // lane + 32 of the slice, all 16 keys.
  for (int sl = 0; sl < slices; ++sl) {
    for (int part = 1; part <= 2; ++part) {
      __syncthreads();  // every warp is done with qg_s
      stage_rows(qg_s, kLd, (part == 2 ? g_image : image) + sl * kSlice,
                 part == 2 ? dim : stride, 0, sp, seq,
                 static_cast<int>(threadIdx.x), kKeyWarpsF32 * 32);
      __syncthreads();
      if (!active) continue;
      const float* a = part == 1 ? dt : st;
      float acc[16][2];
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c][0] = acc[c][1] = 0.0f;
      for (int q = 0; q < sp; ++q) {
        const float x0 = qg_s[q * kLd + lane], x1 = qg_s[q * kLd + lane + 32];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float z = a[c * lds + q];
          acc[c][0] = fmaf(z, x0, acc[c][0]);
          acc[c][1] = fmaf(z, x1, acc[c][1]);
        }
      }
      const float mul = part == 1 ? scale : 1.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        if (key0 + c < seq) {
          float* d = dqkv +
                     (static_cast<size_t>(b) * seq + key0 + c) * stride +
                     part * dim + h * head + sl * kSlice;
          d[lane] = acc[c][0] * mul;
          d[lane + 32] = acc[c][1] * mul;
        }
      }
    }
  }
}

// f32, S > kMaxRowSeq: the two grids with a thread per row (kLongRowsF32 a
// block) and plain FMAs, the passes of the bf16 key-tile grids. Grid 1 (a
// thread per query row, the keys kKeysF32 at a time): m, denom, then delta
// (and the statistics to `stats`), then dq a 64-wide slice at a time. Grid
// 2 (a thread per key row, the queries kQueriesF32 at a time): dk and dv a
// slice at a time from the statistics. Each (tile, slice) is staged
// synchronously.
constexpr int kKeysF32 = 16, kQueriesF32 = 16;

__global__ void __launch_bounds__(kLongRowsF32)
attention_bwd_dq_fma_long_kernel(const float* __restrict__ qkv,  // [B,S,3HD]
                             const float* __restrict__ g,    // [B,S,HD]
                             float* __restrict__ dqkv,       // [B,S,3HD]
                             float* __restrict__ stats,      // [B,H,3,S]
                             int seq, int heads, int slices, float scale) {
  constexpr int kLd = kLdF32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [kKeysF32][kLd] each
  float* v_s = k_s + kKeysF32 * kLd;
  float* kd_s = v_s + kKeysF32 * kLd;           // k's slice o (wide heads)
  float* q_s = kd_s + kKeysF32 * kLd;           // [kLongRowsF32][kLd] each
  float* g_s = q_s + kLongRowsF32 * kLd;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const size_t image_row0 = static_cast<size_t>(b) * seq;
  const float* image = qkv + image_row0 * stride + h * head;
  const float* g_image = g + image_row0 * dim + h * head;
  float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  const int q0 = blockIdx.x * kLongRowsF32, row = q0 + tid;
  const int tiles = (seq + kKeysF32 - 1) / kKeysF32;
  const float* q_row = q_s + tid * kLd;
  const float* g_row = g_s + tid * kLd;

  float m = -INFINITY, den = 0.0f, del = 0.0f;
  for (int pass = 0; pass < 3 + slices; ++pass) {
    float dq[kSlice];
#pragma unroll
    for (int c = 0; c < kSlice; ++c) dq[c] = 0.0f;
    const float* kd = slices == 1 ? k_s : kd_s;
    for (int t = 0; t < tiles; ++t) {
      const int key0 = t * kKeysF32;
      float s[kKeysF32], dw[kKeysF32];
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j) s[j] = dw[j] = 0.0f;
      for (int sl = 0; sl < slices; ++sl) {
        __syncthreads();  // every thread is done with the last slices
        stage_rows(k_s, kLd, image + dim + sl * kSlice, stride, key0,
                   kKeysF32, seq, tid, kLongRowsF32);
        stage_rows(q_s, kLd, image + sl * kSlice, stride, q0, kLongRowsF32,
                   seq, tid, kLongRowsF32);
        if (pass >= 2) {
          stage_rows(v_s, kLd, image + 2 * dim + sl * kSlice, stride, key0,
                     kKeysF32, seq, tid, kLongRowsF32);
          stage_rows(g_s, kLd, g_image + sl * kSlice, dim, q0, kLongRowsF32,
                     seq, tid, kLongRowsF32);
        }
        if (pass >= 3 && slices > 1 && sl == slices - 1)
          stage_rows(kd_s, kLd, image + dim + (pass - 3) * kSlice, stride,
                     key0, kKeysF32, seq, tid, kLongRowsF32);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kKeysF32; ++j) {
          float acc = s[j];
          for (int d = 0; d < kSlice; ++d)
            acc = fmaf(q_row[d], k_s[j * kLd + d], acc);
          s[j] = acc;
          if (pass >= 2) {
            float acc2 = dw[j];
            for (int d = 0; d < kSlice; ++d)
              acc2 = fmaf(g_row[d], v_s[j * kLd + d], acc2);
            dw[j] = acc2;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j) {
        s[j] = key0 + j < seq ? s[j] * scale : -INFINITY;
        if (pass == 0) {
          m = fmaxf(m, s[j]);
        } else if (pass == 1) {
          den += expf(s[j] - m);
        } else {
          const float w = expf(s[j] - m) / den;
          if (pass == 2) {
            del += dw[j] * w;
          } else {
            const float dz = w * (dw[j] - del);
#pragma unroll
            for (int c = 0; c < kSlice; ++c)
              dq[c] = fmaf(dz, kd[j * kLd + c], dq[c]);
          }
        }
      }
    }
    if (row >= seq) continue;
    if (pass == 2) {
      stat[row] = m;
      stat[seq + row] = den;
      stat[2 * seq + row] = del;
    } else if (pass >= 3) {
      float* dst = dqkv + (image_row0 + row) * stride + h * head +
                   (pass - 3) * kSlice;
#pragma unroll
      for (int c = 0; c < kSlice; ++c) dst[c] = dq[c] * scale;
    }
  }
}

__global__ void __launch_bounds__(kLongRowsF32)
attention_bwd_dkdv_fma_long_kernel(const float* __restrict__ qkv,  // [B,S,3HD]
                               const float* __restrict__ g,    // [B,S,HD]
                               float* __restrict__ dqkv,       // [B,S,3HD]
                               const float* __restrict__ stats,  // [B,H,3,S]
                               int seq, int heads, int slices, float scale) {
  constexpr int kLd = kLdF32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kQueriesF32][kLd] each
  float* g_s = q_s + kQueriesF32 * kLd;
  float* qd_s = g_s + kQueriesF32 * kLd;        // q's, g's slice o (wide
  float* gd_s = qd_s + kQueriesF32 * kLd;       // heads)
  float* k_s = gd_s + kQueriesF32 * kLd;        // [kLongRowsF32][kLd] each
  float* v_s = k_s + kLongRowsF32 * kLd;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int head = slices * kSlice, dim = heads * head, stride = 3 * dim;
  const size_t image_row0 = static_cast<size_t>(b) * seq;
  const float* image = qkv + image_row0 * stride + h * head;
  const float* g_image = g + image_row0 * dim + h * head;
  const float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  const int k0 = blockIdx.x * kLongRowsF32, key = k0 + tid;
  const int tiles = (seq + kQueriesF32 - 1) / kQueriesF32;
  const float* k_row = k_s + tid * kLd;
  const float* v_row = v_s + tid * kLd;

  for (int pass = 0; pass < slices; ++pass) {
    float dk[kSlice], dv[kSlice];
#pragma unroll
    for (int c = 0; c < kSlice; ++c) dk[c] = dv[c] = 0.0f;
    const float* qd = slices == 1 ? q_s : qd_s;
    const float* gd = slices == 1 ? g_s : gd_s;
    for (int t = 0; t < tiles; ++t) {
      const int row0 = t * kQueriesF32;
      float st[kQueriesF32], dwt[kQueriesF32];
#pragma unroll
      for (int j = 0; j < kQueriesF32; ++j) st[j] = dwt[j] = 0.0f;
      for (int sl = 0; sl < slices; ++sl) {
        __syncthreads();  // every thread is done with the last slices
        stage_rows(q_s, kLd, image + sl * kSlice, stride, row0, kQueriesF32,
                   seq, tid, kLongRowsF32);
        stage_rows(g_s, kLd, g_image + sl * kSlice, dim, row0, kQueriesF32,
                   seq, tid, kLongRowsF32);
        stage_rows(k_s, kLd, image + dim + sl * kSlice, stride, k0,
                   kLongRowsF32, seq, tid, kLongRowsF32);
        stage_rows(v_s, kLd, image + 2 * dim + sl * kSlice, stride, k0,
                   kLongRowsF32, seq, tid, kLongRowsF32);
        if (slices > 1 && sl == slices - 1) {
          stage_rows(qd_s, kLd, image + pass * kSlice, stride, row0,
                     kQueriesF32, seq, tid, kLongRowsF32);
          stage_rows(gd_s, kLd, g_image + pass * kSlice, dim, row0,
                     kQueriesF32, seq, tid, kLongRowsF32);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kQueriesF32; ++j) {
          float acc = st[j], acc2 = dwt[j];
          for (int d = 0; d < kSlice; ++d) {
            acc = fmaf(q_s[j * kLd + d], k_row[d], acc);
            acc2 = fmaf(g_s[j * kLd + d], v_row[d], acc2);
          }
          st[j] = acc;
          dwt[j] = acc2;
        }
      }
#pragma unroll
      for (int j = 0; j < kQueriesF32; ++j) {
        const int q = row0 + j;
        if (q >= seq) continue;  // a padded query adds nothing
        const float w = expf(st[j] * scale - stat[q]) / stat[seq + q];
        const float dz = w * (dwt[j] - stat[2 * seq + q]);
#pragma unroll
        for (int c = 0; c < kSlice; ++c) {
          dv[c] = fmaf(w, gd[j * kLd + c], dv[c]);
          dk[c] = fmaf(dz, qd[j * kLd + c], dk[c]);
        }
      }
    }
    if (key < seq) {
      float* dst = dqkv + (image_row0 + key) * stride + h * head +
                   pass * kSlice;
#pragma unroll
      for (int c = 0; c < kSlice; ++c) {
        dst[dim + c] = dk[c] * scale;
        dst[2 * dim + c] = dv[c];
      }
    }
  }
}

cudaError_t run_f32_long(const float* qkv, const float* g, float* dqkv,
                         float* stats, int batch, int seq, int heads,
                         int slices, float scale, cudaStream_t stream) {
  const size_t shared_q =
      sizeof(float) * kLdF32 * (3 * kKeysF32 + 2 * kLongRowsF32);
  const size_t shared_k =
      sizeof(float) * kLdF32 * (4 * kQueriesF32 + 2 * kLongRowsF32);
  const dim3 grid((seq + kLongRowsF32 - 1) / kLongRowsF32, heads, batch);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_fma_long_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared_q));
  if (err != cudaSuccess) return err;
  attention_bwd_dq_fma_long_kernel<<<grid, kLongRowsF32, shared_q, stream>>>(
      qkv, g, dqkv, stats, seq, heads, slices, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_fma_long_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared_k));
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_fma_long_kernel<<<grid, kLongRowsF32, shared_k, stream>>>(
      qkv, g, dqkv, stats, seq, heads, slices, scale);
  return cudaGetLastError();
}

cudaError_t run_f32(const float* qkv, const float* g, float* dqkv,
                    float* stats, int batch, int seq, int heads, int slices,
                    float scale, cudaStream_t stream) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  if (long_sequence(seq))
    return run_f32_long(qkv, g, dqkv, stats, batch, seq, heads, slices,
                        scale, stream);
  const int sp = padded(seq);
  const int slabs = sp / 16;
  const size_t lds = static_cast<size_t>(score_ld(sp));
  const size_t shared_q =
      sizeof(float) * (2 * static_cast<size_t>(sp) * kLdF32 +
                       kQueryWarpsF32 * 2 * 16 * (lds + kSlice));
  const size_t shared_k =
      sizeof(float) * (static_cast<size_t>(sp) * (kLdF32 + 3) +
                       kKeyWarpsF32 * (16 * kLdF32 + 2 * 16 * lds));
  if (shared_q > kMaxShared || shared_k > kMaxShared)
    return cudaErrorInvalidValue;

  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_q));
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<<<
      dim3((slabs + kQueryWarpsF32 - 1) / kQueryWarpsF32, heads, batch),
      kQueryWarpsF32 * 32, shared_q, stream>>>(qkv, g, dqkv, stats, seq,
                                               heads, slices, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared_k));
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<<<
      dim3((slabs + kKeyWarpsF32 - 1) / kKeyWarpsF32, heads, batch),
      kKeyWarpsF32 * 32, shared_k, stream>>>(qkv, g, dqkv, stats, seq, heads,
                                             slices, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3 * H * D] and g [B, S, H * D] -> dqkv like qkv, all of the
// type `dtype` names, D = `head` a multiple of 64 and `scale` its 1 /
// sqrt(D) as the caller rounds it to f32 (a head of 64 has the exact 2^-3).
// `design` and the seven plan numbers after it are
// ops/vit_attention.py::attention_plan's c_args. Design 1: the wgmma grids
// with that plan, `stats` an f32 scratch [B, H, 3, stats_len]. Design 0:
// bf16 with D = 64 up to kMaxRowSeq tokens one grid, `stats` unused (may be
// null); otherwise two grids, and `stats` is an f32 scratch [B, H, 3, S]
// (stats_len = S) that the first writes and the second reads.
extern "C" int vqa_vit_attention_backward(
    const void* qkv, const void* g, void* dqkv, void* stats, int batch,
    int seq, int heads, int head, float scale, int dtype, int design,
    int rows, int key_tile, int stages, int shared, int shared_dq,
    int shared_dkdv, int stats_len, void* stream) {
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
                          static_cast<const bf16*>(g),
                          static_cast<bf16*>(dqkv),
                          static_cast<float*>(stats), batch, seq, heads,
                          slices, scale, plan, s);
  }
  if (design != 0 || (stats != nullptr && stats_len != seq))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case vqa::kBFloat16:
      return run_bf16(static_cast<const bf16*>(qkv),
                      static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
                      static_cast<float*>(stats), batch, seq, heads, slices,
                      scale, s);
    case vqa::kFloat32:
      return run_f32(static_cast<const float*>(qkv),
                     static_cast<const float*>(g), static_cast<float*>(dqkv),
                     static_cast<float*>(stats), batch, seq, heads, slices,
                     scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
