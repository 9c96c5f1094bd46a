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

#include "vit_attention.cuh"

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
  bf16* k_s = q_s + kRows * kHead;
  bf16* v_s = k_s + kRows * kHead;
  bf16* g_s = v_s + kRows * kHead;
  float* stat_s = reinterpret_cast<float*>(g_s + kRows * kHead);  // [3][kRows]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int dim = heads * kHead, stride = 3 * dim;
  const size_t image_row0 = static_cast<size_t>(b) * seq;
  const bf16* image = qkv + image_row0 * stride + h * kHead;
  const bf16* g_image = g + image_row0 * dim + h * kHead;
  bf16* d_image = dqkv + image_row0 * stride + h * kHead;
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

cudaError_t run_bf16(const bf16* qkv, const bf16* g, bf16* dqkv, int batch,
                     int seq, int heads, cudaStream_t stream) {
  return with_key_tiles(seq, [&](auto tiles) {
    constexpr int kTiles = decltype(tiles)::value;
    constexpr size_t shared =
        (4 * sizeof(bf16) * kHead + 3 * sizeof(float)) * kTiles * 16;
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

// Grid 1 (dq) tiles the query rows, as the forward does: a block stages the
// head's k and v, and each warp takes 16 query rows through scores,
// softmax, dw, dz and dq on its own. It also writes m, denom and delta =
// rowsum(dw * w) of each query row to `stats`.
__global__ void __launch_bounds__(kQueryWarpsF32 * 32)
attention_bwd_dq_kernel(const float* __restrict__ qkv,  // [B, S, 3*H*64]
                        const float* __restrict__ g,    // [B, S, H * 64]
                        float* __restrict__ dqkv,       // [B, S, 3*H*64]
                        float* __restrict__ stats,      // [B, H, 3, S]
                        int seq, int heads) {
  constexpr int kLd = kLdF32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded(seq);
  const int lds = score_ld(sp);
  float* k_s = reinterpret_cast<float*>(smem);  // [sp][kLd]
  float* v_s = k_s + sp * kLd;                  // [sp][kLd]
  float* buf_all = v_s + sp * kLd;              // [warps][2][16][lds]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int dim = heads * kHead, stride = 3 * dim;
  const float* image = qkv + static_cast<size_t>(b) * seq * stride;
  const float* g_image = g + static_cast<size_t>(b) * seq * dim;

  stage_rows(k_s, kLd, image + dim + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kQueryWarpsF32 * 32);
  stage_rows(v_s, kLd, image + 2 * dim + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kQueryWarpsF32 * 32);
  __syncthreads();
  // The block's only barrier is behind it: a warp without rows may leave.
  const int row0 = (blockIdx.x * kQueryWarpsF32 + warp) * 16;
  if (row0 >= seq) return;

  float* s_buf = buf_all + warp * 2 * 16 * lds;  // scores, then w
  float* dw_buf = s_buf + 16 * lds;              // dw, then dz
  float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  float* dq_rows =
      dqkv + (static_cast<size_t>(b) * seq + row0) * stride + h * kHead;
  float* q_s = buf_all + kQueryWarpsF32 * 2 * 16 * lds + warp * 2 * 16 * kHead;
  float* g_s = q_s + 16 * kHead;  // both [16][64]
  stage_rows(q_s, kHead, image + h * kHead, stride, row0, 16, seq, lane, 32);
  stage_rows(g_s, kHead, g_image + h * kHead, dim, row0, 16, seq, lane, 32);
  __syncwarp();
  // Lane owns key column c: a k (then v) row in registers, the 16 q (then
  // g) rows broadcast.
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
        s_buf[r * lds + c] = acc;
      }
#pragma unroll
      for (int d = 0; d < kHead; ++d) kr[d] = v_s[c * kLd + d];
      for (int r = 0; r < 16; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < kHead; ++d)
          acc = fmaf(g_s[r * kHead + d], kr[d], acc);
        dw_buf[r * lds + c] = acc;
      }
    }
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    float* row = s_buf + r * lds;
    float* dw_row = dw_buf + r * lds;
    float m = -INFINITY;
    for (int c = lane; c < seq; c += 32) m = fmaxf(m, row[c] * kScale);
    m = warp_max(m);
    float sum = 0.0f;
    for (int c = lane; c < seq; c += 32) {
      const float e = expf(row[c] * kScale - m);
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
  // Lane owns dq columns lane and lane + 32 of all 16 rows.
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
      dq_rows[static_cast<size_t>(r) * stride + lane] = acc[r][0] * kScale;
      dq_rows[static_cast<size_t>(r) * stride + lane + 32] =
          acc[r][1] * kScale;
    }
  }
}

// Per-warp scratch of grid 2 in floats: the warp's k and v slabs [16][65],
// tiles of w and dz [16][17].
constexpr int kSlabF32 = 16 * kLdF32, kTileF32 = 16 * 17;
constexpr int kKeyScratchF32 = 2 * kSlabF32 + 2 * kTileF32;

// Grid 2 (dk, dv) tiles the key rows: a block stages the head's q and g and
// the three row statistics, and each warp takes 16 keys and walks over the
// query rows 16 at a time: scores and dw of a 16 x 16 tile, w and dz from
// the statistics (the same arithmetic on the same scores, so the same bits
// as grid 1 had), then w^T . g and dz^T . q into accumulators that the warp
// owns from first to last.
__global__ void __launch_bounds__(kKeyWarpsF32 * 32)
attention_bwd_dkdv_kernel(const float* __restrict__ qkv,    // [B, S, 3*H*64]
                          const float* __restrict__ g,      // [B, S, H * 64]
                          float* __restrict__ dqkv,         // [B, S, 3*H*64]
                          const float* __restrict__ stats,  // [B, H, 3, S]
                          int seq, int heads) {
  constexpr int kLd = kLdF32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded(seq);
  float* q_s = reinterpret_cast<float*>(smem);  // [sp][kLd]
  float* g_s = q_s + sp * kLd;                  // [sp][kLd]
  float* stat_s = g_s + sp * kLd;               // [3][sp]
  float* scratch_all = stat_s + 3 * sp;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int dim = heads * kHead, stride = 3 * dim;
  const float* image = qkv + static_cast<size_t>(b) * seq * stride;
  const float* g_image = g + static_cast<size_t>(b) * seq * dim;
  const float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;

  stage_rows(q_s, kLd, image + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kKeyWarpsF32 * 32);
  stage_rows(g_s, kLd, g_image + h * kHead, dim, 0, sp, seq,
             static_cast<int>(threadIdx.x), kKeyWarpsF32 * 32);
  // A padded query row has q = g = 0: with m = 0, denom = 1, delta = 0 its
  // w is 1 and its dz is 0, and it adds nothing to dk or dv.
  for (int i = threadIdx.x; i < 3 * sp; i += kKeyWarpsF32 * 32) {
    const int p = i / sp, r = i % sp;
    stat_s[i] = r < seq ? stat[p * seq + r] : (p == 1 ? 1.0f : 0.0f);
  }
  __syncthreads();
  // The block's only barrier is behind it: a warp without keys may leave.
  const int key0 = (blockIdx.x * kKeyWarpsF32 + warp) * 16;
  if (key0 >= seq) return;

  float* scratch = scratch_all + warp * kKeyScratchF32;
  float* dk_rows = dqkv + (static_cast<size_t>(b) * seq + key0) * stride +
                   dim + h * kHead;
  float* dv_rows = dk_rows + dim;
  float* kj = scratch;               // [16][65]
  float* vj = scratch + kSlabF32;    // [16][65]
  float* w_t = vj + kSlabF32;        // [16][17]
  float* dz_t = w_t + kTileF32;      // [16][17]
  stage_rows(kj, kLd, image + dim + h * kHead, stride, key0, 16, seq, lane,
             32);
  stage_rows(vj, kLd, image + 2 * dim + h * kHead, stride, key0, 16, seq,
             lane, 32);
  __syncwarp();
  // Lane owns columns lane and lane + 32 of the 16 dk and 16 dv rows.
  float dk[16][2], dv[16][2];
#pragma unroll
  for (int c = 0; c < 16; ++c)
    dk[c][0] = dk[c][1] = dv[c][0] = dv[c][1] = 0.0f;
  const int tr = lane / 2, tc = (lane % 2) * 8;  // tile[query tr][key tc ..]
  for (int i = 0; i < sp / 16; ++i) {
    const float* q_row = q_s + (i * 16 + tr) * kLd;
    const float* g_row = g_s + (i * 16 + tr) * kLd;
    const float m = stat_s[i * 16 + tr];
    const float denom = stat_s[sp + i * 16 + tr];
    const float delta = stat_s[2 * sp + i * 16 + tr];
    for (int x = 0; x < 8; ++x) {
      float s = 0.0f, dw = 0.0f;
#pragma unroll
      for (int d = 0; d < kHead; ++d) {
        s = fmaf(q_row[d], kj[(tc + x) * kLd + d], s);
        dw = fmaf(g_row[d], vj[(tc + x) * kLd + d], dw);
      }
      const float w = expf(s * kScale - m) / denom;
      w_t[tr * 17 + tc + x] = w;
      dz_t[tr * 17 + tc + x] = w * (dw - delta);
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const float g0 = g_s[(i * 16 + r) * kLd + lane];
      const float g1 = g_s[(i * 16 + r) * kLd + lane + 32];
      const float q0 = q_s[(i * 16 + r) * kLd + lane];
      const float q1 = q_s[(i * 16 + r) * kLd + lane + 32];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float w = w_t[r * 17 + c], dz = dz_t[r * 17 + c];
        dv[c][0] = fmaf(w, g0, dv[c][0]);
        dv[c][1] = fmaf(w, g1, dv[c][1]);
        dk[c][0] = fmaf(dz, q0, dk[c][0]);
        dk[c][1] = fmaf(dz, q1, dk[c][1]);
      }
    }
    __syncwarp();  // the next tile overwrites w_t and dz_t
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (key0 + c < seq) {
      dk_rows[static_cast<size_t>(c) * stride + lane] = dk[c][0] * kScale;
      dk_rows[static_cast<size_t>(c) * stride + lane + 32] = dk[c][1] * kScale;
      dv_rows[static_cast<size_t>(c) * stride + lane] = dv[c][0];
      dv_rows[static_cast<size_t>(c) * stride + lane + 32] = dv[c][1];
    }
  }
}

cudaError_t run_f32(const float* qkv, const float* g, float* dqkv,
                    float* stats, int batch, int seq, int heads,
                    cudaStream_t stream) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  const int sp = padded(seq);
  const int slabs = sp / 16;
  const size_t staged = 2 * static_cast<size_t>(sp) * kLdF32;
  const size_t shared_q =
      sizeof(float) * (staged + kQueryWarpsF32 * 2 * 16 *
                                    (static_cast<size_t>(score_ld(sp)) + kHead));
  const size_t shared_k =
      sizeof(float) * (staged + 3 * static_cast<size_t>(sp) +
                       kKeyWarpsF32 * static_cast<size_t>(kKeyScratchF32));
  if (shared_q > kMaxShared || shared_k > kMaxShared)
    return cudaErrorInvalidValue;

  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_q));
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<<<
      dim3((slabs + kQueryWarpsF32 - 1) / kQueryWarpsF32, heads, batch),
      kQueryWarpsF32 * 32, shared_q, stream>>>(qkv, g, dqkv, stats, seq,
                                               heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared_k));
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<<<
      dim3((slabs + kKeyWarpsF32 - 1) / kKeyWarpsF32, heads, batch),
      kKeyWarpsF32 * 32, shared_k, stream>>>(qkv, g, dqkv, stats, seq, heads);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3 * H * 64] and g [B, S, H * 64] -> dqkv like qkv, all of the
// type `dtype` names. bf16: one grid, `stats` unused (may be null). f32: two
// grids, and `stats` is an f32 scratch [B, H, 3, S] that the first writes
// and the second reads.
extern "C" int vqa_vit_attention_backward(const void* qkv, const void* g,
                                          void* dqkv, void* stats, int batch,
                                          int seq, int heads, int dtype,
                                          void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vqa::kBFloat16:
      return run_bf16(static_cast<const bf16*>(qkv),
                      static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
                      batch, seq, heads, s);
    case vqa::kFloat32:
      return run_f32(static_cast<const float*>(qkv),
                     static_cast<const float*>(g), static_cast<float*>(dqkv),
                     static_cast<float*>(stats), batch, seq, heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}
