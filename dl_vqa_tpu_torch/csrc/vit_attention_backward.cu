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
// Design: two grids, no atomics, the same digits on every run. dq sums over
// keys and dk, dv sum over queries, so one tiling cannot keep both sums
// inside a warp.
//   Grid 1 (dq) tiles the query rows, as the forward does: a block stages
//   the head's k and v, and each warp takes 16 query rows through scores,
//   softmax, dw, dz and dq on its own. It also writes three f32 numbers per
//   query row to a scratch [B, H, 3, S]: m, denom and delta = rowsum(dw * w).
//   Grid 2 (dk, dv) tiles the key rows: a block stages the head's q and g
//   and the three row statistics, and each warp takes 16 keys and walks over
//   the query rows 16 at a time: scores and dw of a 16 x 16 tile, w and dz
//   from the statistics (the same arithmetic on the same scores, so the same
//   bits as grid 1 had), then w^T . g and dz^T . q into accumulators that the
//   warp owns from first to last.
// The cost of the choice: the scores and dw are computed twice (seven
// products instead of five) and the 12 bytes a row of statistics go through
// device memory; in exchange no sum crosses a warp. bf16 goes through the
// tensor cores (wmma 16x16x16, f32 accumulate; the transposed products load
// their A fragments column-major from the same tile, no transposed copy);
// f32 goes through plain FMAs with fewer warps a block, and is slow.

#include "vit_attention.cuh"

namespace {

using namespace nvcuda;
using namespace vqa_vit;

// ---------------------------------------------------------------- grid 1

template <typename T, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_kernel(const T* __restrict__ qkv,   // [B, S, 3*H*64]
                        const T* __restrict__ g,     // [B, S, H * 64]
                        T* __restrict__ dqkv,        // [B, S, 3*H*64]
                        float* __restrict__ stats,   // [B, H, 3, S]
                        int seq, int heads) {
  constexpr int kLd = Staged<T>::kLd;
  constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded(seq);
  const int lds = score_ld(sp);
  T* k_s = reinterpret_cast<T*>(smem);                       // [sp][kLd]
  T* v_s = k_s + sp * kLd;                                   // [sp][kLd]
  // [kWarps][2][16][lds]
  float* buf_all = reinterpret_cast<float*>(v_s + sp * kLd);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int dim = heads * kHead, stride = 3 * dim;
  const T* image = qkv + static_cast<size_t>(b) * seq * stride;
  const T* g_image = g + static_cast<size_t>(b) * seq * dim;

  stage_rows(k_s, kLd, image + dim + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kWarps * 32);
  stage_rows(v_s, kLd, image + 2 * dim + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kWarps * 32);
  __syncthreads();
  // The block's only barrier is behind it: a warp without rows may leave.
  const int row0 = (blockIdx.x * kWarps + warp) * 16;
  if (row0 >= seq) return;

  float* s_buf = buf_all + warp * 2 * 16 * lds;  // scores, later dq
  float* dw_buf = s_buf + 16 * lds;              // dw, then dz
  float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;
  T* dq_rows =
      dqkv + (static_cast<size_t>(b) * seq + row0) * stride + h * kHead;

  if constexpr (kTensor) {
    // q and g slabs through the (still unused) buffers into A fragments.
    T* q_st = reinterpret_cast<T*>(s_buf);
    T* g_st = reinterpret_cast<T*>(dw_buf);
    stage_rows(q_st, kLd, image + h * kHead, stride, row0, 16, seq, lane, 32);
    stage_rows(g_st, kLd, g_image + h * kHead, dim, row0, 16, seq, lane, 32);
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qa[4], ga[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wmma::load_matrix_sync(qa[kk], q_st + kk * 16, kLd);
      wmma::load_matrix_sync(ga[kk], g_st + kk * 16, kLd);
    }
    __syncwarp();
    for (int j = 0; j < sp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_acc, dw_acc;
      wmma::fill_fragment(s_acc, 0.0f);
      wmma::fill_fragment(dw_acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kb, vb;
        wmma::load_matrix_sync(kb, k_s + j * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(s_acc, qa[kk], kb, s_acc);
        wmma::load_matrix_sync(vb, v_s + j * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(dw_acc, ga[kk], vb, dw_acc);
      }
      wmma::store_matrix_sync(s_buf + j * 16, s_acc, lds, wmma::mem_row_major);
      wmma::store_matrix_sync(dw_buf + j * 16, dw_acc, lds,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Softmax and its backward, four rows at a time so that their loads,
    // exps and shuffles overlap; a lane holds columns lane, lane + 32, ...
    // of each row's scores and dw in registers. dz is narrowed in place:
    // bf16 column c lands on bytes 2c, 2c + 1 of its dw row; every lane
    // has its four rows in registers (the __syncwarp) before any writes.
    for (int r0 = 0; r0 < 16; r0 += kRowGroup) {
      float x[kRowGroup][kLaneCols], d[kRowGroup][kLaneCols];
      float m[kRowGroup], denom[kRowGroup], delta[kRowGroup];
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) {
        const float* row = s_buf + (r0 + rr) * lds;
        const float* dw_row = dw_buf + (r0 + rr) * lds;
        m[rr] = -INFINITY;
#pragma unroll
        for (int i = 0; i < kLaneCols; ++i) {
          const int c = lane + 32 * i;
          x[rr][i] = c < seq ? row[c] * kScale : -INFINITY;
          d[rr][i] = c < seq ? dw_row[c] : 0.0f;
          m[rr] = fmaxf(m[rr], x[rr][i]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) m[rr] = warp_max(m[rr]);
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) {
        denom[rr] = 0.0f;
#pragma unroll
        for (int i = 0; i < kLaneCols; ++i) {
          // A padded key column gets no weight.
          x[rr][i] = lane + 32 * i < seq ? expf(x[rr][i] - m[rr]) : 0.0f;
          denom[rr] += x[rr][i];
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) denom[rr] = warp_sum(denom[rr]);
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) {
        delta[rr] = 0.0f;
#pragma unroll
        for (int i = 0; i < kLaneCols; ++i) {
          // w: the normalised weight, rounded before it is used.
          x[rr][i] = vqa::to_float(vqa::from_float<T>(x[rr][i] / denom[rr]));
          delta[rr] += d[rr][i] * x[rr][i];
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) delta[rr] = warp_sum(delta[rr]);
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) {
        T* dz_row = reinterpret_cast<T*>(dw_buf + (r0 + rr) * lds);
#pragma unroll
        for (int i = 0; i < kLaneCols; ++i) {
          const int c = lane + 32 * i;
          if (c < sp)
            dz_row[c] = vqa::from_float<T>(x[rr][i] * (d[rr][i] - delta[rr]));
        }
        if (lane == 0 && row0 + r0 + rr < seq) {
          stat[row0 + r0 + rr] = m[rr];
          stat[seq + row0 + r0 + rr] = denom[rr];
          stat[2 * seq + row0 + r0 + rr] = delta[rr];
        }
      }
    }
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(dq[n], 0.0f);
    const T* dz_s = reinterpret_cast<const T*>(dw_buf);  // [16][2 * lds]
    for (int kk = 0; kk < sp / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> za;
      wmma::load_matrix_sync(za, dz_s + kk * 16, 2 * lds);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> kb;
        wmma::load_matrix_sync(kb, k_s + kk * 16 * kLd + n * 16, kLd);
        wmma::mma_sync(dq[n], za, kb, dq[n]);
      }
    }
#pragma unroll
    // The scores are done with: their buffer takes dq.
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(s_buf + n * 16, dq[n], lds, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * 8; i += 32) {
      const int r = i / 8, c = (i % 8) * 8;
      if (row0 + r < seq) {
        float t[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) t[x] = s_buf[r * lds + c + x] * kScale;
        *reinterpret_cast<uint4*>(dq_rows + static_cast<size_t>(r) * stride +
                                  c) = pack8(t);
      }
    }
  } else {
    float* q_s = buf_all + kWarps * 2 * 16 * lds + warp * 2 * 16 * kHead;
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
}

// ---------------------------------------------------------------- grid 2

// Per-warp scratch of grid 2, in bytes. bf16: the warp's k and v slabs
// [16][72] (later the f32 staging [16][72] of dk, then dv), f32 tiles of
// scores and dw [16][20], bf16 tiles of w and dz [16][24]. f32: k and v slabs
// [16][65], tiles of w and dz [16][17].
template <typename T>
struct KeyScratch;
template <>
struct KeyScratch<__nv_bfloat16> {
  static constexpr int kSlab = 16 * 72 * 2, kTile32 = 16 * 20 * 4,
                       kTile16 = 16 * 24 * 2;
  static constexpr int kBytes = 2 * kSlab + 2 * kTile32 + 2 * kTile16;
};
template <>
struct KeyScratch<float> {
  static constexpr int kSlab = 16 * 65 * 4, kTile = 16 * 17 * 4;
  static constexpr int kBytes = 2 * kSlab + 2 * kTile;
};

template <typename T, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkdv_kernel(const T* __restrict__ qkv,        // [B, S, 3*H*64]
                          const T* __restrict__ g,          // [B, S, H * 64]
                          T* __restrict__ dqkv,             // [B, S, 3*H*64]
                          const float* __restrict__ stats,  // [B, H, 3, S]
                          int seq, int heads) {
  constexpr int kLd = Staged<T>::kLd;
  constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded(seq);
  T* q_s = reinterpret_cast<T*>(smem);                         // [sp][kLd]
  T* g_s = q_s + sp * kLd;                                     // [sp][kLd]
  float* stat_s = reinterpret_cast<float*>(g_s + sp * kLd);    // [3][sp]
  unsigned char* scratch_all =
      reinterpret_cast<unsigned char*>(stat_s + 3 * sp);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int dim = heads * kHead, stride = 3 * dim;
  const T* image = qkv + static_cast<size_t>(b) * seq * stride;
  const T* g_image = g + static_cast<size_t>(b) * seq * dim;
  const float* stat = stats + (static_cast<size_t>(b) * heads + h) * 3 * seq;

  stage_rows(q_s, kLd, image + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kWarps * 32);
  stage_rows(g_s, kLd, g_image + h * kHead, dim, 0, sp, seq,
             static_cast<int>(threadIdx.x), kWarps * 32);
  // A padded query row has q = g = 0: with m = 0, denom = 1, delta = 0 its
  // w is 1 and its dz is 0, and it adds nothing to dk or dv.
  for (int i = threadIdx.x; i < 3 * sp; i += kWarps * 32) {
    const int p = i / sp, r = i % sp;
    stat_s[i] = r < seq ? stat[p * seq + r] : (p == 1 ? 1.0f : 0.0f);
  }
  __syncthreads();
  // The block's only barrier is behind it: a warp without keys may leave.
  const int key0 = (blockIdx.x * kWarps + warp) * 16;
  if (key0 >= seq) return;

  unsigned char* scratch = scratch_all + warp * KeyScratch<T>::kBytes;
  T* dk_rows = dqkv + (static_cast<size_t>(b) * seq + key0) * stride + dim +
               h * kHead;
  T* dv_rows = dk_rows + dim;

  if constexpr (kTensor) {
    using KS = KeyScratch<T>;
    T* kj = reinterpret_cast<T*>(scratch);                       // [16][72]
    T* vj = reinterpret_cast<T*>(scratch + KS::kSlab);           // [16][72]
    float* s_t = reinterpret_cast<float*>(scratch + 2 * KS::kSlab);  // [16][20]
    float* dw_t = s_t + 16 * 20;                                 // [16][20]
    T* w_t = reinterpret_cast<T*>(scratch + 2 * KS::kSlab + 2 * KS::kTile32);
    T* dz_t = w_t + 16 * 24;  // both [16][24]
    stage_rows(kj, kLd, image + dim + h * kHead, stride, key0, 16, seq, lane,
               32);
    stage_rows(vj, kLd, image + 2 * dim + h * kHead, stride, key0, 16, seq,
               lane, 32);
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[4], dv[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fill_fragment(dk[n], 0.0f);
      wmma::fill_fragment(dv[n], 0.0f);
    }
    // Lane's share of a 16 x 16 tile: row lane / 2, eight columns.
    const int tr = lane / 2, tc = (lane % 2) * 8;
    for (int i = 0; i < sp / 16; ++i) {
      const T* q_i = q_s + i * 16 * kLd;
      const T* g_i = g_s + i * 16 * kLd;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_acc, dw_acc;
      wmma::fill_fragment(s_acc, 0.0f);
      wmma::fill_fragment(dw_acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bt;
        wmma::load_matrix_sync(a, q_i + kk * 16, kLd);
        wmma::load_matrix_sync(bt, kj + kk * 16, kLd);
        wmma::mma_sync(s_acc, a, bt, s_acc);
        wmma::load_matrix_sync(a, g_i + kk * 16, kLd);
        wmma::load_matrix_sync(bt, vj + kk * 16, kLd);
        wmma::mma_sync(dw_acc, a, bt, dw_acc);
      }
      wmma::store_matrix_sync(s_t, s_acc, 20, wmma::mem_row_major);
      wmma::store_matrix_sync(dw_t, dw_acc, 20, wmma::mem_row_major);
      __syncwarp();
      const float m = stat_s[i * 16 + tr];
      const float denom = stat_s[sp + i * 16 + tr];
      const float delta = stat_s[2 * sp + i * 16 + tr];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float e = expf(s_t[tr * 20 + tc + x] * kScale - m);
        const T w = vqa::from_float<T>(e / denom);
        w_t[tr * 24 + tc + x] = w;
        dz_t[tr * 24 + tc + x] = vqa::from_float<T>(
            vqa::to_float(w) * (dw_t[tr * 20 + tc + x] - delta));
      }
      __syncwarp();
      // A[key][query] = tile[query][key]: column-major from the same tile.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> wa, za;
      wmma::load_matrix_sync(wa, w_t, 24);
      wmma::load_matrix_sync(za, dz_t, 24);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bn;
        wmma::load_matrix_sync(bn, g_i + n * 16, kLd);
        wmma::mma_sync(dv[n], wa, bn, dv[n]);
        wmma::load_matrix_sync(bn, q_i + n * 16, kLd);
        wmma::mma_sync(dk[n], za, bn, dk[n]);
      }
      __syncwarp();  // the next tile overwrites s_t .. dz_t
    }

    // The k and v slabs are done with: their 4,608 bytes stage [16][72] f32.
    float* stage = reinterpret_cast<float*>(scratch);
    auto write = [&](wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
                     T* rows, float mul) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(stage + n * 16, acc[n], 72,
                                wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 16 * 8; i += 32) {
        const int r = i / 8, c = (i % 8) * 8;
        if (key0 + r < seq) {
          float t[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) t[x] = stage[r * 72 + c + x] * mul;
          *reinterpret_cast<uint4*>(rows + static_cast<size_t>(r) * stride +
                                    c) = pack8(t);
        }
      }
      __syncwarp();
    };
    write(dk, dk_rows, kScale);
    write(dv, dv_rows, 1.0f);
  } else {
    using KS = KeyScratch<T>;
    float* kj = reinterpret_cast<float*>(scratch);                   // [16][65]
    float* vj = reinterpret_cast<float*>(scratch + KS::kSlab);       // [16][65]
    float* w_t = reinterpret_cast<float*>(scratch + 2 * KS::kSlab);  // [16][17]
    float* dz_t = w_t + 16 * 17;                                     // [16][17]
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
        dk_rows[static_cast<size_t>(c) * stride + lane + 32] =
            dk[c][1] * kScale;
        dv_rows[static_cast<size_t>(c) * stride + lane] = dv[c][0];
        dv_rows[static_cast<size_t>(c) * stride + lane + 32] = dv[c][1];
      }
    }
  }
}

template <typename T, int kQueryWarps, int kKeyWarps>
cudaError_t run(const void* qkv, const void* g, void* dqkv, float* stats,
                int batch, int seq, int heads, cudaStream_t stream) {
  const int sp = padded(seq);
  const int slabs = sp / 16;
  const size_t staged =
      2 * static_cast<size_t>(sp) * Staged<T>::kLd * sizeof(T);
  size_t shared_q = staged + static_cast<size_t>(kQueryWarps) * 2 * 16 *
                                 score_ld(sp) * sizeof(float);
  if (std::is_same<T, float>::value)
    shared_q +=
        static_cast<size_t>(kQueryWarps) * 2 * 16 * kHead * sizeof(float);
  const size_t shared_k =
      staged + 3 * static_cast<size_t>(sp) * sizeof(float) +
      static_cast<size_t>(kKeyWarps) * KeyScratch<T>::kBytes;
  if (shared_q > kMaxShared || shared_k > kMaxShared)
    return cudaErrorInvalidValue;

  auto dq_kernel = attention_bwd_dq_kernel<T, kQueryWarps>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_q));
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((slabs + kQueryWarps - 1) / kQueryWarps, heads, batch),
              kQueryWarps * 32, shared_q, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<T*>(dqkv), stats, seq, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv_kernel = attention_bwd_dkdv_kernel<T, kKeyWarps>;
  err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_k));
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((slabs + kKeyWarps - 1) / kKeyWarps, heads, batch),
                kKeyWarps * 32, shared_k, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<T*>(dqkv), stats, seq, heads);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3 * H * 64] and g [B, S, H * 64] -> dqkv like qkv, all of the
// type `dtype` names; stats is an f32 scratch [B, H, 3, S] that the first
// grid writes and the second reads. Two grids.
extern "C" int vqa_vit_attention_backward(const void* qkv, const void* g,
                                          void* dqkv, void* stats, int batch,
                                          int seq, int heads, int dtype,
                                          void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case vqa::kBFloat16:
      return run<__nv_bfloat16, 4, 8>(qkv, g, dqkv, st, batch, seq, heads, s);
    case vqa::kFloat32:
      return run<float, 2, 4>(qkv, g, dqkv, st, batch, seq, heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}
