// ViT self-attention forward on the packed qkv projection (kernel 4 of the
// port).
//
// Replaces dl_vqa_tpu/ops/vit_attention_pallas.py::_attention_kernel. Per
// image b and head h, on the 64-wide slices q, k, v of qkv [B, S, 3 * H * 64]
// (layout in vit_attention.cuh):
//   s = f32(q . k^T) * (1 / sqrt(64));  m = rowmax(s);  e = exp(s - m)  (f32)
//   denom = rowsum(e)                   (of the f32 e, before it is rounded)
//   o = f32(cast(e) . v) / denom        (the [S, 64] output is normalised,
//                                        not the [S, S] weights)
//   out[b, :, h * 64 : (h + 1) * 64] = cast(o)
// for bf16 or f32 qkv and out; scores, sums and accumulators are f32.
//
// What bounds it on this card: memory traffic. It has to read qkv and write
// out once (205 MB at B = 512, S = 196, H = 4 in bf16, 0.061 ms at 3.35 TB/s)
// while its two products are 20 GFLOP (0.020 ms at the bf16 tensor-core
// peak). The plain version writes the f32 [B, H, S, S] scores, their
// exponentials and the split heads to device memory; here the scores of a
// query tile never leave shared memory.
//
// Design. A block takes one (image, head) and kWarps * 16 query rows; the
// grid's x dimension runs over query tiles, so a small serving batch still
// spreads over many SMs. The block stages the head's whole k and v in shared
// memory (S is padded to a multiple of 16 there). After that one barrier
// every warp works alone on its 16 query rows: scores into its own f32
// buffer [16][score_ld], a row softmax by the warp (four rows at a time,
// their values in registers), e rounded in place, then
// e . v, the division by denom and 16-byte stores of the merged output.
// bf16 goes through the tensor cores (wmma 16x16x16, f32 accumulate) and
// narrows e to bf16 inside the score buffer; f32 goes through plain FMAs,
// which keeps the f32 products exact rather than rounding them to TF32.

#include "vit_attention.cuh"

namespace {

using namespace nvcuda;
using namespace vqa_vit;

template <typename T, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
vit_attention_kernel(const T* __restrict__ qkv,  // [B, S, 3 * H * 64]
                     T* __restrict__ out,        // [B, S, H * 64]
                     int seq, int heads) {
  constexpr int kLd = Staged<T>::kLd;
  constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = padded(seq);
  const int lds = score_ld(sp);
  T* k_s = reinterpret_cast<T*>(smem);                  // [sp][kLd]
  T* v_s = k_s + sp * kLd;                              // [sp][kLd]
  // [kWarps][16][lds]
  float* sc_all = reinterpret_cast<float*>(v_s + sp * kLd);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int dim = heads * kHead, stride = 3 * dim;
  const T* image = qkv + static_cast<size_t>(b) * seq * stride;

  stage_rows(k_s, kLd, image + dim + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kWarps * 32);
  stage_rows(v_s, kLd, image + 2 * dim + h * kHead, stride, 0, sp, seq,
             static_cast<int>(threadIdx.x), kWarps * 32);
  __syncthreads();
  // The block's only barrier is behind it: a warp without rows may leave.
  const int row0 = (blockIdx.x * kWarps + warp) * 16;
  if (row0 >= seq) return;

  float* sc = sc_all + warp * 16 * lds;
  T* out_rows = out + (static_cast<size_t>(b) * seq + row0) * dim + h * kHead;
  float denom_mine = 1.0f;  // lane r keeps the denominator of row r

  if constexpr (kTensor) {
    // q slab through the (still unused) score buffer into four A fragments.
    T* q_st = reinterpret_cast<T*>(sc);  // [16][kLd]
    stage_rows(q_st, kLd, image + h * kHead, stride, row0, 16, seq, lane, 32);
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qa[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wmma::load_matrix_sync(qa[kk], q_st + kk * 16, kLd);
    __syncwarp();
    for (int j = 0; j < sp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // B[d][n] = k[j * 16 + n][kk * 16 + d]: column-major, ld kLd.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, k_s + j * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(sc + j * 16, acc, lds, wmma::mem_row_major);
    }
    __syncwarp();

    // Row softmax, four rows at a time so that their loads, exps and
    // shuffles overlap; a lane holds columns lane, lane + 32, ... of each.
    // e is narrowed in place: bf16 column c lands on bytes 2c, 2c + 1 of
    // its row, which held f32 scores; every lane has its four rows in
    // registers (the __syncwarp) before any of them writes.
    for (int r0 = 0; r0 < 16; r0 += kRowGroup) {
      float x[kRowGroup][kLaneCols], m[kRowGroup], sum[kRowGroup];
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) {
        const float* row = sc + (r0 + rr) * lds;
        m[rr] = -INFINITY;
#pragma unroll
        for (int i = 0; i < kLaneCols; ++i) {
          const int c = lane + 32 * i;
          x[rr][i] = c < seq ? row[c] * kScale : -INFINITY;
          m[rr] = fmaxf(m[rr], x[rr][i]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) m[rr] = warp_max(m[rr]);
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) {
        sum[rr] = 0.0f;
#pragma unroll
        for (int i = 0; i < kLaneCols; ++i) {
          // A padded key column gets no weight.
          x[rr][i] = lane + 32 * i < seq ? expf(x[rr][i] - m[rr]) : 0.0f;
          sum[rr] += x[rr][i];
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) sum[rr] = warp_sum(sum[rr]);
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < kRowGroup; ++rr) {
        T* erow = reinterpret_cast<T*>(sc + (r0 + rr) * lds);
#pragma unroll
        for (int i = 0; i < kLaneCols; ++i) {
          const int c = lane + 32 * i;
          if (c < sp) erow[c] = vqa::from_float<T>(x[rr][i]);
        }
        if (lane == r0 + rr) denom_mine = sum[rr];
      }
    }
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(o[n], 0.0f);
    const T* e_s = reinterpret_cast<const T*>(sc);  // [16][2 * lds]
    for (int kk = 0; kk < sp / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> ea;
      wmma::load_matrix_sync(ea, e_s + kk * 16, 2 * lds);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, v_s + kk * 16 * kLd + n * 16, kLd);
        wmma::mma_sync(o[n], ea, vb, o[n]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(sc + n * 16, o[n], lds, wmma::mem_row_major);
    __syncwarp();
    // 16 rows of 64 values: eight 16-byte stores a row.
    for (int i = lane; i < 16 * 8; i += 32) {
      const int r = i / 8, c = (i % 8) * 8;
      const float d = __shfl_sync(0xffffffffu, denom_mine, r);
      if (row0 + r < seq) {
        float t[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) t[x] = sc[r * lds + c + x] / d;
        *reinterpret_cast<uint4*>(out_rows + static_cast<size_t>(r) * dim + c) =
            pack8(t);
      }
    }
  } else {
    float* q_s = sc_all + kWarps * 16 * lds + warp * 16 * kHead;  // [16][64]
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
}

template <typename T, int kWarps>
cudaError_t run(const void* qkv, void* out, int batch, int seq, int heads,
                cudaStream_t stream) {
  const int sp = padded(seq);
  size_t shared =
      2 * static_cast<size_t>(sp) * Staged<T>::kLd * sizeof(T) +
      static_cast<size_t>(kWarps) * 16 * score_ld(sp) * sizeof(float);
  if (std::is_same<T, float>::value)
    shared += static_cast<size_t>(kWarps) * 16 * kHead * sizeof(float);
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  auto kernel = vit_attention_kernel<T, kWarps>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const int slabs = sp / 16;
  const dim3 grid((slabs + kWarps - 1) / kWarps, heads, batch);
  kernel<<<grid, kWarps * 32, shared, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), seq, heads);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3 * H * 64] -> out [B, S, H * 64], both of the type `dtype`
// names. One grid of ceil(S / 16 / warps) x H x B blocks.
extern "C" int vqa_vit_attention(const void* qkv, void* out, int batch,
                                 int seq, int heads, int dtype, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vqa::kBFloat16:
      return run<__nv_bfloat16, 8>(qkv, out, batch, seq, heads, s);
    case vqa::kFloat32:
      return run<float, 4>(qkv, out, batch, seq, heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}
