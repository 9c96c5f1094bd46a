// Masked LSTM recurrence (kernel 1 of the port) and its save mode (kernel A).
//
// Replaces dl_vqa_tpu/ops/lstm_pallas.py::_lstm_kernel and, with kSave,
// ::_lstm_kernel_save. Per step t and direction d:
//   gates = f32(xproj[d, t]) + cast(h, W dtype) . W_hh[d]^T   (f32 accumulate)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the gate chunks
//   c' = f * c + i * g;  h' = o * tanh(c')
//   (h, c) <- (h', c') where t < len[b], else unchanged (masked pass-through)
// Save mode also writes, for the backward from saved states, the f32 gates
// of step t (before the activations, also at a padded step) and the f32
// carries after the masked update. It is a template flag, so the plain
// mode's code, bits and time are what they were without it.
//
// The host launches one grid per timestep; blockIdx.z is the direction, so
// both directions of the bi-LSTM share every launch. A block owns 16 hidden
// units and 16 batch rows (64 when the batch is larger than 64, so each
// W_hh tile read from L2 serves four times the rows), and computes all four
// gate columns of its units (one warp per gate), so the cell update fuses
// into the same block. Blocks read all of h while other blocks write it, so
// h is double-buffered across
// launches (h_prev -> h_next); c is updated in place, because exactly one
// thread of one block owns each (b, j). Every block reads all of h, so the
// step also writes h rounded to the weight dtype (hq), which the next step
// stages into shared memory with 16-byte loads: half the bytes of f32 h for
// bf16, and the rounding the product needs anyway.
//
// W_hh stays in torch layout [4H, H], so each gate row is a contiguous dot
// product. bf16 weights go through the tensor cores (wmma 16x16x16, f32
// accumulate); f32 weights through plain FMAs, which keeps the f32 product
// exact rather than rounding it to TF32.

#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kUnits = 16;     // hidden units per block (one wmma N tile)
constexpr int kChunk = 128;    // columns of h staged in shared memory at once
constexpr int kPad = 8;        // row padding of the staged tile
constexpr int kThreads = 128;  // four warps: warp g computes gate g

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// kTiles: 16-row wmma tiles of batch rows per block. kSave: kernel A.
template <typename T, int kTiles, bool kSave>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const T* __restrict__ xproj,        // [D, T, B, 4H]
                 const T* __restrict__ whh,          // [D, 4H, H]
                 const int* __restrict__ lengths,    // [B]
                 const float* __restrict__ h_prev,   // [D, B, H]
                 float* __restrict__ h_next,         // [D, B, H]
                 const T* __restrict__ hq_prev,      // [D, B, H], h as T
                 T* __restrict__ hq_next,            // unused when T = float
                 float* __restrict__ c,              // [D, B, H]
                 float* __restrict__ gates_all,      // [D, T, B, 4H] (kSave)
                 float* __restrict__ c_all,          // [D, T, B, H] (kSave)
                 float* __restrict__ h_all,          // [D, T, B, H] (kSave)
                 int t, int seq_len, int batch, int hidden) {
  constexpr int kRows = 16 * kTiles;
  __shared__ __align__(32) T h_s[kRows][kChunk + kPad];
  __shared__ __align__(32) float gates_s[4][kRows][kUnits];

  const int u0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const int d = blockIdx.z;
  const int gate = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const size_t state = static_cast<size_t>(batch) * hidden;
  h_prev += d * state;
  h_next += d * state;
  hq_prev += d * state;
  hq_next += d * state;
  c += d * state;
  xproj += (static_cast<size_t>(d) * seq_len + t) * batch * 4 * hidden;
  // The 16 rows of W_hh that feed gate `gate` of units u0 .. u0 + 15.
  const T* w_gate = whh + static_cast<size_t>(d) * 4 * hidden * hidden +
                    static_cast<size_t>(gate * hidden + u0) * hidden;

  // Stage hq[b0 : b0 + kRows, k0 : k0 + kc] in 16-byte vectors (rows past
  // the batch read as zero). kc and hidden are multiples of 16.
  constexpr int kVec = 16 / sizeof(T);
  auto stage = [&](int k0, int kc) {
    const int vecs = kc / kVec;
    for (int i = threadIdx.x; i < kRows * vecs; i += kThreads) {
      const int r = i / vecs, k = (i % vecs) * kVec;
      const int b = b0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (b < batch)
        v = *reinterpret_cast<const uint4*>(
            hq_prev + static_cast<size_t>(b) * hidden + k0 + k);
      *reinterpret_cast<uint4*>(&h_s[r][k]) = v;
    }
  };

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTiles];
#pragma unroll
    for (int m = 0; m < kTiles; ++m) wmma::fill_fragment(acc[m], 0.0f);
    for (int k0 = 0; k0 < hidden; k0 += kChunk) {
      const int kc = min(kChunk, hidden - k0);
      stage(k0, kc);
      __syncthreads();
      auto k_step = [&](int kk) {
        // B[k][n] = W[gate * H + u0 + n][k0 + kk + k]: column-major, ld H.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> w;
        wmma::load_matrix_sync(w, w_gate + k0 + kk, hidden);
#pragma unroll
        for (int m = 0; m < kTiles; ++m) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::load_matrix_sync(a, &h_s[16 * m][kk], kChunk + kPad);
          wmma::mma_sync(acc[m], a, w, acc[m]);
        }
      };
      // A full chunk unrolls, so the W_hh loads of its k-steps (L2 latency)
      // are issued together rather than one after another.
      if (kc == kChunk) {
#pragma unroll
        for (int kk = 0; kk < kChunk; kk += 16) k_step(kk);
      } else {
        for (int kk = 0; kk < kc; kk += 16) k_step(kk);
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < kTiles; ++m)
      wmma::store_matrix_sync(&gates_s[gate][16 * m][0], acc[m], kUnits,
                              wmma::mem_row_major);
  } else {
    static_assert(kTiles == 1, "the f32 path computes 16 rows per block");
    // Lane owns unit (lane % 16) and rows 8 * (lane / 16) .. + 7.
    const int u = lane % 16;
    const int r0 = (lane / 16) * 8;
    const T* w_row = w_gate + static_cast<size_t>(u) * hidden;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < hidden; k0 += kChunk) {
      const int kc = min(kChunk, hidden - k0);
      stage(k0, kc);
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        const float w = vqa::to_float(w_row[k0 + k]);
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] += vqa::to_float(h_s[r0 + r][k]) * w;
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) gates_s[gate][r0 + r][u] = acc[r];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * kUnits; i += kThreads) {
    const int r = i / kUnits, u = i % kUnits;
    const int b = b0 + r;
    if (b >= batch) continue;
    const int j = u0 + u;
    const T* xp = xproj + static_cast<size_t>(b) * 4 * hidden;
    const float gi = vqa::to_float(xp[j]) + gates_s[0][r][u];
    const float gf = vqa::to_float(xp[hidden + j]) + gates_s[1][r][u];
    const float gg = vqa::to_float(xp[2 * hidden + j]) + gates_s[2][r][u];
    const float go = vqa::to_float(xp[3 * hidden + j]) + gates_s[3][r][u];
    const size_t at = static_cast<size_t>(b) * hidden + j;
    const float c_old = c[at];
    const float c_new = sigmoid(gf) * c_old + sigmoid(gi) * tanhf(gg);
    const float h_new = sigmoid(go) * tanhf(c_new);
    const bool keep = t < lengths[b];
    const float h_out = keep ? h_new : h_prev[at];
    c[at] = keep ? c_new : c_old;
    h_next[at] = h_out;
    if constexpr (!std::is_same<T, float>::value)
      hq_next[at] = vqa::from_float<T>(h_out);
    if constexpr (kSave) {
      // The f32 carries, not the rounded hq: the backward multiplies by them.
      const size_t step = (static_cast<size_t>(d) * seq_len + t) * batch;
      float* g_out = gates_all + (step + b) * 4 * hidden;
      g_out[j] = gi;
      g_out[hidden + j] = gf;
      g_out[2 * hidden + j] = gg;
      g_out[3 * hidden + j] = go;
      c_all[(step + b) * hidden + j] = keep ? c_new : c_old;
      h_all[(step + b) * hidden + j] = h_out;
    }
  }
}

// For T = float, hq_a / hq_b are h_a / h_b themselves.
template <typename T, int kTiles, bool kSave>
cudaError_t run(const void* xproj, const void* whh, const int* lengths,
                float* h_a, float* h_b, void* hq_a, void* hq_b, float* c,
                float* gates_all, float* c_all, float* h_all,
                int directions, int seq_len, int batch, int hidden,
                cudaStream_t stream) {
  constexpr int kRows = 16 * kTiles;
  if (batch == 0 || directions == 0) return cudaSuccess;
  const dim3 grid(hidden / kUnits, (batch + kRows - 1) / kRows, directions);
  for (int t = 0; t < seq_len; ++t) {
    // Step t reads h_a and writes h_b when t is even, and the other way
    // round when it is odd; the final h is in h_b iff seq_len is odd.
    const bool even = t % 2 == 0;
    lstm_step_kernel<T, kTiles, kSave><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(xproj), static_cast<const T*>(whh), lengths,
        even ? h_a : h_b, even ? h_b : h_a,
        static_cast<const T*>(even ? hq_a : hq_b),
        static_cast<T*>(even ? hq_b : hq_a), c, gates_all, c_all, h_all, t,
        seq_len, batch, hidden);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kSave>
cudaError_t dispatch(const void* xproj, const void* whh, const void* lengths,
                     void* h_a, void* h_b, void* hq_a, void* hq_b, void* c,
                     void* gates_all, void* c_all, void* h_all,
                     int directions, int seq_len, int batch, int hidden,
                     int dtype, void* stream) {
  const int* len = static_cast<const int*>(lengths);
  float* ha = static_cast<float*>(h_a);
  float* hb = static_cast<float*>(h_b);
  float* cc = static_cast<float*>(c);
  float* ga = static_cast<float*>(gates_all);
  float* ca = static_cast<float*>(c_all);
  float* hl = static_cast<float*>(h_all);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden % kUnits != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case vqa::kBFloat16:
      // Up to 64 rows, one tile: more blocks share the step. Beyond, four
      // tiles, so each W_hh tile read from L2 serves 64 rows. Measured on an
      // H100 (700 W): one tile is 8% faster at B=64, four are 23% faster at
      // B=128 and 44% at B=512.
      if (batch <= 64)
        return run<__nv_bfloat16, 1, kSave>(xproj, whh, len, ha, hb, hq_a,
                                            hq_b, cc, ga, ca, hl, directions,
                                            seq_len, batch, hidden, s);
      return run<__nv_bfloat16, 4, kSave>(xproj, whh, len, ha, hb, hq_a, hq_b,
                                          cc, ga, ca, hl, directions, seq_len,
                                          batch, hidden, s);
    case vqa::kFloat32:
      return run<float, 1, kSave>(xproj, whh, len, ha, hb, ha, hb, cc, ga, ca,
                                  hl, directions, seq_len, batch, hidden, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vqa_lstm_recurrence(const void* xproj, const void* whh,
                                   const void* lengths, void* h_a, void* h_b,
                                   void* hq_a, void* hq_b, void* c,
                                   int directions, int seq_len, int batch,
                                   int hidden, int dtype, void* stream) {
  return dispatch<false>(xproj, whh, lengths, h_a, h_b, hq_a, hq_b, c,
                         nullptr, nullptr, nullptr, directions, seq_len,
                         batch, hidden, dtype, stream);
}

// Kernel A: the same steps, which also fill gates_all [D, T, B, 4H] and
// c_all, h_all [D, T, B, H], all f32.
extern "C" int vqa_lstm_recurrence_save(
    const void* xproj, const void* whh, const void* lengths, void* h_a,
    void* h_b, void* hq_a, void* hq_b, void* c, void* gates_all, void* c_all,
    void* h_all, int directions, int seq_len, int batch, int hidden,
    int dtype, void* stream) {
  return dispatch<true>(xproj, whh, lengths, h_a, h_b, hq_a, hq_b, c,
                        gates_all, c_all, h_all, directions, seq_len, batch,
                        hidden, dtype, stream);
}

extern "C" const char* vqa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
