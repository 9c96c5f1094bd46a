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
// Three designs, chosen by the caller (ops/lstm_cuda.py::persistent_plan
// for bf16, ::f32_plan for f32) on dtype and shape before the launch:
//
// 1. The persistent kernel (lstm_persistent_kernel; bf16 whenever the plan
//    finds a block size that fits). What bounds the recurrence is that it
//    is serial in T while each step is a [B, H] x [H, 4H] product against
//    all of W_hh. The TPU kernel kept W_hh in VMEM across a sequential time
//    grid; here one cooperative launch a call keeps W_hh in shared memory
//    for all T steps: a block owns `units` hidden units of one direction
//    and holds their 4 x units rows of W_hh (128 KiB at H = 1024, 16 units)
//    from its prologue on. Only h crosses between SMs: each step every
//    block streams its direction's bf16 h (hq, written by the other blocks
//    the step before) from L2 by cp.async.cg in 64- or 128-column chunks
//    through a two-stage ring, multiplies by mma.sync m16n8k16 (h as A, W
//    by ldmatrix as B), and orders N as one n8 tile per gate over the same
//    8 units, so a lane's accumulators hold i, f, g and o of the same (row,
//    unit) and the cell update runs in registers. Then one barrier per step
//    per direction: a release-arrive on the direction's counter and
//    acquire loads until all its blocks have arrived; the two directions
//    never wait on each other. hq is double-buffered by step parity. c and
//    f32 h stay in device memory at the owner's addresses (read back by the
//    thread that wrote them; the batch of 512 does not fit on the SM beside
//    W). At B = 512 each block reads 1 MiB of hq from L2 a step.
//
// 2. The per-step kernel (lstm_step_kernel; bf16 and f32 shapes with no
//    plan): the host launches one grid per timestep; blockIdx.z is the
//    direction, so both directions of the bi-LSTM share every launch. A
//    block owns 16 hidden units and 16 batch rows (64 when the batch is
//    larger than 64, so each W_hh tile read from L2 serves four times the
//    rows), and computes all four gate columns of its units (one warp per
//    gate), so the cell update fuses into the same block. Blocks read all
//    of h while other blocks write it, so h is double-buffered across
//    launches (h_prev -> h_next); c is updated in place, because exactly one
//    thread of one block owns each (b, j). Every block reads all of h, so
//    the step also writes h rounded to the weight dtype (hq), which the
//    next step stages into shared memory with 16-byte loads. W_hh stays in
//    torch layout [4H, H], so each gate row is a contiguous dot product.
//    bf16 weights go through the tensor cores (wmma 16x16x16, f32
//    accumulate); f32 weights through plain FMAs, which keeps the f32
//    product exact rather than rounding it to TF32.
//
// 3. The f32 persistent kernel (lstm_f32_kernel; f32 wherever f32_plan finds
//    room, H <= 1024 with a block per 8 units on the card's SMs). The f32
//    W_hh of two directions (32 MiB at H = 1024) fits no card's shared
//    memory, one direction's 16 MiB does: one cooperative launch a call
//    runs the directions one after the other, each block holding its 8
//    units' 32 rows of the direction's W_hh (128 KiB) for all T steps, so
//    each step streams only h from L2 (cp.async through a three-slot ring,
//    two chunks ahead) and W never leaves the SM; one barrier a step over
//    the grid. The product is plain f32 FMAs (no TF32 rounding): each warp
//    sums an eighth of K in register tiles of up to 8 x 8, and the eight
//    partial sums meet in shared memory in a fixed order.
//    Rows are taken longest first (`order`, a stable sort of the lengths),
//    so step t multiplies only its `live[t]` rows that are still inside
//    their length; a finished row keeps its state. kSave (kernel A)
//    computes every row at every step instead, the gates of padded steps
//    included, as design 2 does; kTokens (the co-attention's per-token
//    states) writes only h_all and the final state.
//
// Designs 1 and 2 sum a gate's products in the same order for every row
// (k ascending in 16-wide steps), whatever the batch or the row's tile;
// design 3 in its own fixed order (an FMA chain over each eighth of K,
// then the eight in turn), whatever the batch, the row's position or the
// mode, so kernel 1's (h, c), kernel A's and the token states' agree to
// the bit.

#include <mma.h>
#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

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

// ---------------------------------------------------------------------------
// The persistent kernel (design 1 above). Block layout: kWarps warps; warp
// w owns the 8-unit group w % (units / 8) of the block's units and the row
// group w / (units / 8), so a row group is units / 8 warps that stage the
// same rows and sync by a named barrier of their own (one warp by
// __syncwarp). A row group computes kTiles 16-row tiles a pass; passes walk
// the batch. kTiles is 2 where one tile would need more than one pass, else
// 1: a row's arithmetic is the same either way, only the grouping differs.
namespace persistent {

using bf16 = __nv_bfloat16;

// 16 warps of one or two 16-row tiles: twice the warps of an SM
// sub-partition of 8 warps of four tiles, at about 100 registers rather than
// 254. Measured in one call of tools/compare_lstm.py on an H100 (700 W),
// kernel 1 at T = 23, one tile against 8 warps of four: 0.23 against 0.37
// ms at B = 1, 0.29 against 0.69 at B = 64, 1.39 against 1.58 at B = 512;
// two tiles: 1.26 at B = 512, but 0.28 and 0.39 at B = 1 and 64.
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTiles = 2;          // 16-row tiles of a row group a pass
constexpr int kMaxRows = 16 * kMaxTiles;
constexpr int kChunk = 64;            // columns of hq a 32-row slot holds
constexpr int kStages = 2;
constexpr int kPad = 8;               // bf16 padding of each staged row

// Dynamic shared memory of a block: W_hh rows [4 * units][hidden + kPad],
// then each row group's ring [kStages][kMaxRows][kChunk + kPad]. The row
// strides are 16 bytes past a multiple of 32, so the eight 16-byte rows of
// one ldmatrix phase fall on all 32 banks. Mirrored by
// ops/lstm_cuda.py::persistent_smem_bytes.
constexpr size_t smem_bytes(int units, int hidden) {
  return static_cast<size_t>(4 * units) * (hidden + kPad) * 2 +
         static_cast<size_t>(kWarps * 8 / units) * kStages * kMaxRows *
             (kChunk + kPad) * 2;
}

// Asynchronous 16-byte copy global -> shared through L2 only (.cg: another
// SM's L1 is not coherent with the writer's stores); with `valid` false it
// reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
// Wait until at most `kPending` of this thread's newest copy groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The threads of row group `rg`: a warp syncs alone; a larger group by
// named barrier 1 + rg (0 is __syncthreads'; at most 8 such groups).
__device__ __forceinline__ void group_sync(int rg, int threads) {
  if (threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + rg), "r"(threads) : "memory");
}

// All blocks of one direction: the block's stores are made visible at
// device scope (the fence after the block barrier is cumulative), then one
// arrive on the direction's counter, then acquire loads until `target`
// arrivals. The counter only grows (step t waits for (t + 1) x blocks),
// so it needs no reset within a call.
__device__ __forceinline__ void direction_barrier(int* counter, int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1);
    int seen;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

__device__ __forceinline__ float2 unpack2(unsigned x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const unsigned*>(&p);
}

template <bool kSave, int kTiles>
__global__ void __launch_bounds__(kThreads, 1)
lstm_persistent_kernel(const bf16* __restrict__ xproj,    // [D, T, B, 4H]
                       const bf16* __restrict__ whh,      // [D, 4H, H]
                       const int* __restrict__ lengths,   // [B]
                       float* __restrict__ h,             // [D, B, H], 0 in
                       float* __restrict__ c,             // [D, B, H], 0 in
                       bf16* hq,                          // [2, D, B, H]
                       int* barrier,                      // [D], 0 in
                       float* __restrict__ gates_all,     // [D, T, B, 4H]
                       float* __restrict__ c_all,         // [D, T, B, H]
                       float* __restrict__ h_all,         // [D, T, B, H]
                       int directions, int seq_len, int batch, int hidden,
                       int units) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  const int ldw = hidden + kPad;
  // A slot holds kMaxRows rows of kChunk columns, or fewer rows of as
  // many more columns: with one tile, 128-column chunks and half the waits
  // and syncs a step (H100, 700 W, kernel 1: 0.20 against 0.24 ms at B =
  // 1, 0.26 against 0.29 at B = 64).
  constexpr int kCols = kChunk * kMaxTiles / kTiles;
  constexpr int lds = kCols + kPad;
  constexpr int kRows = 16 * kTiles;
  constexpr int stage = kMaxRows * (kChunk + kPad);  // a slot

  const int blocks = hidden / units;  // blocks of one direction
  const int d = blockIdx.x / blocks;
  const int u0 = (blockIdx.x % blocks) * units;
  const int groups = units / 8;       // warps of a row group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = warp % groups, rg = warp / groups;
  const int group_threads = 32 * groups;
  const int rank = threadIdx.x - rg * group_threads;
  const int rows_per_pass = kWarps / groups * kRows;
  bf16* ring = w_s + 4 * units * ldw + rg * kStages * stage;

  // Prologue: rows gate * H + u0 .. + units of W_hh[d], for the four gates,
  // into rows gate * units + u of w_s; they stay for all T steps.
  {
    const bf16* w_dir = whh + static_cast<size_t>(d) * 4 * hidden * hidden;
    const int vecs = hidden / 8;
    for (int i = threadIdx.x; i < 4 * units * vecs; i += kThreads) {
      const int r = i / vecs, v = i % vecs;
      const int gate = r / units, u = r % units;
      cp_async16(w_s + r * ldw + v * 8,
                 w_dir + static_cast<size_t>(gate * hidden + u0 + u) * hidden +
                     v * 8,
                 true);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }

  // ldmatrix lanes: A [rows][k] gives a[0..3] of mma.m16n8k16; B stored
  // [n][k] gives b0, b1 of the n8 tile of gate 2p, then of gate 2p + 1.
  const int a_off = (lane % 16) * lds + (lane / 16) * 8;
  const bf16* w_lane[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
    w_lane[p] = w_s + ((2 * p + lane / 16) * units + 8 * j + lane % 8) * ldw +
                (lane / 8 % 2) * 8;
  // The lane's accumulator columns: units `unit`, `unit + 1`; rows lane / 4
  // and lane / 4 + 8 of each tile.
  const int unit = u0 + 8 * j + 2 * (lane % 4);
  const size_t state = static_cast<size_t>(batch) * hidden;
  float* h_d = h + d * state;
  float* c_d = c + d * state;

  for (int t = 0; t < seq_len; ++t) {
    const bf16* hq_in =
        hq + (static_cast<size_t>(t % 2) * directions + d) * state;
    bf16* hq_out =
        hq + (static_cast<size_t>((t + 1) % 2) * directions + d) * state;
    const bf16* xp =
        xproj + (static_cast<size_t>(d) * seq_len + t) * batch * 4 * hidden;
    for (int pass = 0; pass < batch; pass += rows_per_pass) {
      const int row0 = pass + rg * kRows;
      if (row0 >= batch) continue;  // uniform over the row group
      const int tiles = min(kTiles, (batch - row0 + 15) / 16);

      // x_proj of the four gates and the lengths, loaded before the
      // product so that their latency hides behind it. x_proj is read once
      // and the saved tensors written once: both go evict-first (.cs), so
      // they do not push h out of L2 (kernel A at B = 512 on an H100, 700
      // W: 1.44 against 1.69 ms; kernel 1 the same).
      unsigned xq[kTiles][2][4];
      int len[kTiles][2];
#pragma unroll
      for (int m = 0; m < kTiles; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int b = row0 + 16 * m + lane / 4 + 8 * hh;
          len[m][hh] = 0;
          if (m < tiles && b < batch) {
            const bf16* xr = xp + static_cast<size_t>(b) * 4 * hidden + unit;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              xq[m][hh][g] = __ldcs(reinterpret_cast<const unsigned*>(
                  xr + g * hidden));
            len[m][hh] = __ldg(lengths + b);
          }
        }
      }

      float acc[kTiles][4][4];
#pragma unroll
      for (int m = 0; m < kTiles; ++m)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][g][e] = 0.0f;

      // h is zero before step 0, and so is its product.
      if (t > 0) {
        const int chunks = (hidden + kCols - 1) / kCols;
        auto issue = [&](int chunk) {
          if (chunk < chunks) {
            const int k0 = chunk * kCols;
            const int vecs = min(kCols, hidden - k0) / 8;
            bf16* dst = ring + (chunk % kStages) * stage;
            for (int i = rank; i < tiles * 16 * vecs; i += group_threads) {
              const int r = i / vecs, v = i % vecs;
              const int b = row0 + r;
              const bool valid = b < batch;
              cp_async16(dst + r * lds + v * 8,
                         hq_in + (valid ? static_cast<size_t>(b) * hidden +
                                              k0 + v * 8
                                        : 0),
                         valid);
            }
          }
          cp_async_commit();  // empty past the end: the count stays uniform
        };
        for (int chunk = 0; chunk < kStages - 1; ++chunk) issue(chunk);
        for (int chunk = 0; chunk < chunks; ++chunk) {
          cp_async_wait<kStages - 2>();  // this thread's copies of `chunk`
          // Everyone's copies of `chunk` have landed, and everyone is done
          // with the slot of chunk - 1, which the next issue refills.
          group_sync(rg, group_threads);
          issue(chunk + kStages - 1);
          const int k0 = chunk * kCols;
          const bf16* a_s = ring + (chunk % kStages) * stage + a_off;
          auto k_step = [&](int kk) {
            unsigned wf[2][4];
            vqa::ldmatrix_x4(wf[0], w_lane[0] + k0 + kk);
            vqa::ldmatrix_x4(wf[1], w_lane[1] + k0 + kk);
#pragma unroll
            for (int m = 0; m < kTiles; ++m) {
              if (m < tiles) {
                unsigned a[4];
                vqa::ldmatrix_x4(a, a_s + m * 16 * lds + kk);
                vqa::mma_bf16(acc[m][0], a, wf[0][0], wf[0][1]);
                vqa::mma_bf16(acc[m][1], a, wf[0][2], wf[0][3]);
                vqa::mma_bf16(acc[m][2], a, wf[1][0], wf[1][1]);
                vqa::mma_bf16(acc[m][3], a, wf[1][2], wf[1][3]);
              }
            }
          };
          if (hidden - k0 >= kCols) {
#pragma unroll
            for (int kk = 0; kk < kCols; kk += 16) k_step(kk);
          } else {
            for (int kk = 0; kk < hidden - k0; kk += 16) k_step(kk);
          }
        }
        // Everyone is done with the last chunk's slot before the next
        // pass's issue(0) refills slot 0, which it is when the chunk count
        // is odd. The next step is behind the direction barrier anyway.
        if (pass + rows_per_pass < batch) group_sync(rg, group_threads);
      }

      // The cell update in registers: acc[m][g][2 hh + e] is gate g of row
      // lane / 4 + 8 hh of tile m, unit `unit + e`.
#pragma unroll
      for (int m = 0; m < kTiles; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int b = row0 + 16 * m + lane / 4 + 8 * hh;
          if (m >= tiles || b >= batch) continue;
          const bool keep = t < len[m][hh];
          float gates[4][2], c_out[2], h_out[2];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float2 x = unpack2(xq[m][hh][g]);
            gates[g][0] = x.x + acc[m][g][2 * hh];
            gates[g][1] = x.y + acc[m][g][2 * hh + 1];
          }
          // The f32 carries, written by this thread the step before.
          const size_t at = static_cast<size_t>(b) * hidden + unit;
          const float2 c2 = *reinterpret_cast<const float2*>(c_d + at);
          const float2 h2 = *reinterpret_cast<const float2*>(h_d + at);
          const float co[2] = {c2.x, c2.y};
          const float ho[2] = {h2.x, h2.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float c_new = sigmoid(gates[1][e]) * co[e] +
                                sigmoid(gates[0][e]) * tanhf(gates[2][e]);
            const float h_new = sigmoid(gates[3][e]) * tanhf(c_new);
            c_out[e] = keep ? c_new : co[e];
            h_out[e] = keep ? h_new : ho[e];
          }
          *reinterpret_cast<float2*>(c_d + at) =
              make_float2(c_out[0], c_out[1]);
          *reinterpret_cast<float2*>(h_d + at) =
              make_float2(h_out[0], h_out[1]);
          *reinterpret_cast<unsigned*>(hq_out + at) =
              pack2(h_out[0], h_out[1]);
          if constexpr (kSave) {
            // The f32 carries, not the rounded hq: the backward multiplies
            // by them.
            const size_t row =
                (static_cast<size_t>(d) * seq_len + t) * batch + b;
            float* g_out = gates_all + row * 4 * hidden + unit;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              __stcs(reinterpret_cast<float2*>(g_out + g * hidden),
                     make_float2(gates[g][0], gates[g][1]));
            __stcs(reinterpret_cast<float2*>(c_all + row * hidden + unit),
                   make_float2(c_out[0], c_out[1]));
            __stcs(reinterpret_cast<float2*>(h_all + row * hidden + unit),
                   make_float2(h_out[0], h_out[1]));
          }
        }
      }
    }
    // Every block's hq_out before anyone reads it. The parity buffer that
    // the next step writes was last read in the step before this one,
    // which every block finished before arriving here: one barrier a step.
    if (t + 1 < seq_len) direction_barrier(barrier + d, (t + 1) * blocks);
  }
}

template <bool kSave>
cudaError_t launch(const void* xproj, const void* whh, const void* lengths,
                   void* h, void* c, void* hq, void* barrier, void* gates_all,
                   void* c_all, void* h_all, int directions, int seq_len,
                   int batch, int hidden, int units, int smem,
                   cudaStream_t stream) {
  // Two tiles a row group where one would need more than one pass.
  const int rows_one_tile = kWarps / (units / 8) * 16;
  auto kernel = batch > rows_one_tile ? lstm_persistent_kernel<kSave, 2>
                                      : lstm_persistent_kernel<kSave, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the other entries report the last error
    return err;
  }
  const bf16* xp = static_cast<const bf16*>(xproj);
  const bf16* w = static_cast<const bf16*>(whh);
  const int* len = static_cast<const int*>(lengths);
  float* hh = static_cast<float*>(h);
  float* cc = static_cast<float*>(c);
  bf16* q = static_cast<bf16*>(hq);
  int* bar = static_cast<int*>(barrier);
  float* ga = static_cast<float*>(gates_all);
  float* ca = static_cast<float*>(c_all);
  float* ha = static_cast<float*>(h_all);
  void* args[] = {&xp, &w, &len, &hh, &cc, &q, &bar, &ga, &ca, &ha,
                  &directions, &seq_len, &batch, &hidden, &units};
  // Refuses a grid whose blocks cannot all be resident at once, rather than
  // letting the step barrier wait forever.
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(directions * hidden / units),
      dim3(kThreads), args, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace persistent

// ---------------------------------------------------------------------------
// The f32 persistent kernel (design 3 above). A block owns kUnits hidden
// units and keeps their 4 x kUnits rows of one direction's W_hh in shared
// memory, row (2 g + e) * 4 + q holding gate g of unit 2 q + e, K padded
// with zeros to a multiple of kKAlign. Warp w sums the products of its
// eighth of K, columns [w K/8, (w + 1) K/8), for a pass of rows: lane (rg,
// q) = (lane / 4, lane % 4) holds rows rg + 8 s by the 8 columns c * 4 + q,
// a register tile of up to 8 x 8 f32 sums fed by 16-byte shared loads,
// each k once into every sum in ascending order (plain f32 FMAs). The
// eight partial sums go through shared memory (XOR-swizzled by row, so
// that the stores and the cell update's loads fall on distinct banks) and
// are added in warp order; the cell update follows in the same block. A
// pass is 64 rows (kSlots = 8, 16 columns a warp a ring slot), or 16
// (kSlots = 2, 64 columns) where the step has no more: the same products
// in the same order either way. h streams from L2 through a ring of two
// slots by 16-byte cp.async, one chunk ahead; at the end of a pass warps
// 0-3 put their partial sums in red and warps 4-7 in the slot just used
// up.
//
// What bounds it at batch 512: the FMAs, fed from shared memory at about
// the rate they run (an 8 x 8 tile takes 16 shared words a lane for 64
// FMAs, which is what the SM's 128 bytes of shared memory a cycle give its
// 128 FMA lanes), then the staging of h from L2 (2 MiB a block a step)
// where it does not overlap them, then the cell updates and the step
// barrier. 3xTF32 on mma.sync ran faster on an H100 but moved the f8
// model's f32 gradient check in chip_smoke.py (tensor-to-tensor 2e-4)
// past its limit: this design keeps exact f32 products, as the per-step
// kernel has them.
namespace persistent_f32 {

constexpr int kUnits = 8;
constexpr int kCols = 4 * kUnits;       // W_hh rows of a block
constexpr int kSlices = 8;              // warps, each sums an eighth of K
constexpr int kThreads = 32 * kSlices;
constexpr int kKAlign = 512;            // K padded to a multiple
constexpr int kWPad = 4;                // f32 padding of each W_s row
constexpr int kRingSlots = 2;
constexpr int kStageFloats = 64 * 132;  // a slot: 64 x (128 + 4), 16 x 516
constexpr int kRedRows = 64;            // rows of a pass at most

enum Mode { kFinal = 0, kSave = 1, kTokens = 2 };

__host__ __device__ constexpr int padded_k(int hidden) {
  return (hidden + kKAlign - 1) / kKAlign * kKAlign;
}

// Dynamic shared memory of a block: W_s [kCols][padded_k + kWPad], the
// ring [kRingSlots][kStageFloats], then red, the partial sums of warps 0-3
// [4][kRedRows][kCols] (warps 4-7 put theirs in the slot a pass has just
// used up); all f32. Mirrored by ops/lstm_cuda.py::f32_smem_bytes.
constexpr size_t smem_bytes(int hidden) {
  return (static_cast<size_t>(kCols) * (padded_k(hidden) + kWPad) +
          static_cast<size_t>(kRingSlots) * kStageFloats +
          static_cast<size_t>(kSlices / 2) * kRedRows * kCols) *
         sizeof(float);
}

// A warp's partial sum of (row, column) within its 64 x kCols block of red
// or a slot: the column XOR-ed with the row's low three bits.
__device__ __forceinline__ int part_at(int row, int col) {
  return row * kCols + (col ^ ((row & 7) << 2));
}

// The products of one ring slot: lane (rg, q) sums rows rg + 8 s (s <
// slots, or all kSlots with kFull) of the slot (rows kLd apart, from hs)
// by W_s rows c * 4 + q (from ws, rows ldw apart) over the warp's kCw
// columns of K.
template <int kSlots, int kCw, int kLd, bool kFull>
__device__ __forceinline__ void slot_product(float (&acc)[kSlots][8],
                                             const float* hs, const float* ws,
                                             int ldw, int slots) {
  // Two k steps at a time: a full unroll's loads ahead spill registers.
#pragma unroll 2
  for (int kk = 0; kk < kCw; kk += 4) {
    float4 wv[8], hv[kSlots];
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      wv[cc] = *reinterpret_cast<const float4*>(ws + cc * 4 * ldw + kk);
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (kFull || s < slots)
        hv[s] = *reinterpret_cast<const float4*>(hs + s * 8 * kLd + kk);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (kFull || s < slots) {
          const float h = reinterpret_cast<const float*>(&hv[s])[k];
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
            acc[s][cc] = fmaf(h, reinterpret_cast<const float*>(&wv[cc])[k],
                              acc[s][cc]);
        }
      }
    }
  }
}

struct Args {
  const float* xproj;    // [D, T, B, 4H]
  const float* whh;      // [D, 4H, H]
  const int* lengths;    // [B]
  const int* order;      // [B]: rows by length, longest first (not kSave)
  const int* live;       // [T]: rows with t < len (not kSave)
  float* h;              // [D, B, H], 0 in: the final h
  float* c;              // [D, B, H], 0 in
  float* hbuf;           // [2, B, H]: h of the step before, by parity
  int* barrier;          // [1], 0 in
  float* gates_all;      // [D, T, B, 4H] (kSave)
  float* c_all;          // [D, T, B, H] (kSave)
  float* h_all;          // [D, T, B, H] (kSave, kTokens)
  int directions, seq_len, batch, hidden;
};

// Step t of direction d for the rows at positions 0 .. rows - 1 of the
// order: the product (t > 0) pass by pass, each pass's cell update (in
// kTokens a row's last step writes its h to every later step of h_all, and
// step 0 the zero state of the rows of length 0 to every step).
template <int kMode, int kSlots>
__device__ __forceinline__ void step(const Args& a, const float* w_s,
                                     int ldw, float* ring, float* red, int d,
                                     int t, int rows) {
  constexpr int kRows = 8 * kSlots;       // rows a pass
  constexpr int kCw = 128 / kSlots;       // K columns of a warp a slot
  constexpr int kLd = kSlices * kCw + 4;  // f32 a staged row
  constexpr int kVpr = kSlices * kCw / 4; // 16-byte vectors a staged row
  static_assert(kRows * kLd <= kStageFloats, "a pass fits a ring slot");
  static_assert(kSlices / 2 * kRedRows * kCols <= kStageFloats,
                "half the warps' partial sums fit a ring slot");
  const int hidden = a.hidden, batch = a.batch;
  const int k_slice = padded_k(hidden) / kSlices;
  const int chunks = k_slice / kCw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u0 = blockIdx.x * kUnits;
  const size_t state = static_cast<size_t>(batch) * hidden;
  const float* h_in = a.hbuf + static_cast<size_t>(t % 2) * state;
  float* h_next = a.hbuf + static_cast<size_t>((t + 1) % 2) * state;
  const float* xp =
      a.xproj + (static_cast<size_t>(d) * a.seq_len + t) * batch * 4 * hidden;
  const size_t step_row = (static_cast<size_t>(d) * a.seq_len + t) * batch;
  float* c_d = a.c + d * state;
  float* h_d = a.h + d * state;
  auto row_of = [&](int pos) {
    return kMode == kSave ? pos : __ldg(a.order + pos);
  };

  if (kMode == kTokens && t == 0) {
    // A row of length 0 keeps the zero state at every step.
    const int seq_len = a.seq_len;
    for (int i = threadIdx.x; i < (batch - rows) * 4 * seq_len;
         i += kThreads) {
      const int pair = i / seq_len, s = i % seq_len;
      const size_t at =
          (static_cast<size_t>(d) * seq_len + s) * batch * hidden +
          static_cast<size_t>(row_of(rows + pair / 4)) * hidden + u0 +
          2 * (pair % 4);
      __stcs(reinterpret_cast<float2*>(a.h_all + at),
             make_float2(0.0f, 0.0f));
    }
  }

  // The cell update of the rows at positions row0 .. row0 + n - 1, with
  // the partial sums of warps 0-3 in `lo` and 4-7 in `hi` (none at step
  // 0): thread (r, p) takes units u0 + 2 p, + 1 of row r, all four gates.
  auto cell_update = [&](int row0, int n, const float* lo, const float* hi) {
    const int r = threadIdx.x / 4, p = threadIdx.x % 4;
    if (r >= n) return;
    const int b = row_of(row0 + r);
    const int j = u0 + 2 * p;
    const float* xr = xp + static_cast<size_t>(b) * 4 * hidden + j;
    float gates[4][2];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float2 x = __ldcs(reinterpret_cast<const float2*>(xr + g * hidden));
      float sum[2] = {0.0f, 0.0f};
      if (lo != nullptr) {  // the product's sums, in warp order
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = part_at(r, (2 * g + e) * 4 + p);
          float s = lo[at];
#pragma unroll
          for (int w = 1; w < kSlices; ++w)
            s += (w < kSlices / 2 ? lo + w * kRedRows * kCols
                                  : hi + (w - kSlices / 2) * kRedRows *
                                             kCols)[at];
          sum[e] = s;
        }
      }
      gates[g][0] = x.x + sum[0];
      gates[g][1] = x.y + sum[1];
    }
    const int len = __ldg(a.lengths + b);
    const bool keep = t < len;
    const size_t at = static_cast<size_t>(b) * hidden + j;
    float2 c2 = make_float2(0.0f, 0.0f), h2 = make_float2(0.0f, 0.0f);
    if (t > 0) {
      c2 = __ldcg(reinterpret_cast<const float2*>(c_d + at));
      // A padded row passes its h through; only kSave computes one.
      if (kMode == kSave)
        h2 = __ldcg(reinterpret_cast<const float2*>(h_in + at));
    }
    const float co[2] = {c2.x, c2.y};
    const float ho[2] = {h2.x, h2.y};
    float c_out[2], h_out[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float c_new = sigmoid(gates[1][e]) * co[e] +
                          sigmoid(gates[0][e]) * tanhf(gates[2][e]);
      const float h_new = sigmoid(gates[3][e]) * tanhf(c_new);
      c_out[e] = keep ? c_new : co[e];
      h_out[e] = keep ? h_new : ho[e];
    }
    const float2 c_o = make_float2(c_out[0], c_out[1]);
    const float2 h_o = make_float2(h_out[0], h_out[1]);
    *reinterpret_cast<float2*>(c_d + at) = c_o;
    *reinterpret_cast<float2*>(h_next + at) = h_o;
    *reinterpret_cast<float2*>(h_d + at) = h_o;
    if constexpr (kMode == kSave) {
      float* g_out = a.gates_all + (step_row + b) * 4 * hidden + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        __stcs(reinterpret_cast<float2*>(g_out + g * hidden),
               make_float2(gates[g][0], gates[g][1]));
      __stcs(reinterpret_cast<float2*>(a.c_all + step_row * hidden + at),
             c_o);
      __stcs(reinterpret_cast<float2*>(a.h_all + step_row * hidden + at),
             h_o);
    }
    if constexpr (kMode == kTokens) {
      // A row's last step also writes its state to the steps after it,
      // which no longer compute the row.
      const int until = len - 1 == t ? a.seq_len : t + 1;
      for (int s = t; s < until; ++s)
        __stcs(reinterpret_cast<float2*>(
                   a.h_all + (step_row + static_cast<size_t>(s - t) * batch) *
                                 hidden + at),
               h_o);
    }
  };

  if (t == 0) {
    // h is zero before step 0, and so is its product.
    for (int row0 = 0; row0 < rows; row0 += kRedRows)
      cell_update(row0, min(kRedRows, rows - row0), nullptr, nullptr);
    return;
  }

  // Chunk g (columns g % chunks of every warp's slice, rows of pass g /
  // chunks) goes to slot g % kRingSlots, one chunk ahead of the one in use.
  // Each call commits one copy group, empty past the last chunk.
  const int total = (rows + kRows - 1) / kRows * chunks;
  auto issue = [&](int g) {
    if (g < total) {
      constexpr int kRowStep = kThreads / kVpr;
      const int pass = g / chunks, ch = g % chunks;
      const int n = min(kRows, rows - pass * kRows);
      float* dst = ring + (g % kRingSlots) * kStageFloats;
      const int v = threadIdx.x % kVpr;  // a thread's vector of every row
      const int col = v / (kCw / 4) * k_slice + ch * kCw + v % (kCw / 4) * 4;
      const bool in_k = col < hidden;    // columns past H read as zero
#pragma unroll
      for (int r = threadIdx.x / kVpr; r < kRows; r += kRowStep) {
        if (r < n) {  // rows past the pass's last are not read
          const int b = row_of(pass * kRows + r);
          persistent::cp_async16(
              dst + r * kLd + 4 * v,
              h_in + (in_k ? static_cast<size_t>(b) * hidden + col : 0),
              in_k);
        }
      }
    }
    persistent::cp_async_commit();
  };
  const int rg = lane / 4, q = lane % 4;
  float acc[kSlots][8];
  issue(0);
  for (int g = 0; g < total; ++g) {
    persistent::cp_async_wait_all();  // this thread's copies of g
    // Everyone's copies of g have landed, and everyone is done with the
    // slot of g - 1, which the next issue refills.
    __syncthreads();
    issue(g + 1);
    const int pass = g / chunks;
    const int n = min(kRows, rows - pass * kRows);
    const int slots = (n + 7) / 8;  // the same for every warp
    if (g % chunks == 0) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) acc[s][cc] = 0.0f;
    }
    float* slot = ring + (g % kRingSlots) * kStageFloats;
    const float* hs = slot + rg * kLd + warp * kCw;
    const float* ws = w_s + q * ldw + warp * k_slice + g % chunks * kCw;
    if (slots == kSlots)
      slot_product<kSlots, kCw, kLd, true>(acc, hs, ws, ldw, slots);
    else
      slot_product<kSlots, kCw, kLd, false>(acc, hs, ws, ldw, slots);
    if (g % chunks == chunks - 1) {
      // The pass's partial sums into red (warps 0-3) and this slot (4-7)
      // once everyone is done reading it, then its cell update; the next
      // pass's first chunk is in flight meanwhile, and the next refill of
      // this slot follows the next barrier.
      __syncthreads();
      float* part = (warp < kSlices / 2 ? red : slot) +
                    warp % (kSlices / 2) * kRedRows * kCols;
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (s < slots)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
            part[part_at(rg + 8 * s, 4 * cc + q)] = acc[s][cc];
      __syncthreads();
      cell_update(pass * kRows, n, red, slot);
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1) lstm_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int hidden = a.hidden;
  const int kpad = padded_k(hidden);
  const int ldw = kpad + kWPad;
  float* w_s = smem;
  float* ring = w_s + kCols * ldw;
  float* red = ring + kRingSlots * kStageFloats;
  const int u0 = blockIdx.x * kUnits;
  int steps = 0;
  for (int d = 0; d < a.directions; ++d) {
    // This direction's rows of W_hh; every block is past the barrier of
    // the last step that read the other direction's.
    const float* w_dir = a.whh + static_cast<size_t>(d) * 4 * hidden * hidden;
    const int vecs = hidden / 4;
    for (int i = threadIdx.x; i < kCols * vecs; i += kThreads) {
      const int r = i / vecs, v = i % vecs;
      const int g = r / 8, e = r / 4 % 2, q = r % 4;
      persistent::cp_async16(
          w_s + r * ldw + v * 4,
          w_dir + static_cast<size_t>(g * hidden + u0 + 2 * q + e) * hidden +
              v * 4,
          true);
    }
    const int tail = kpad - hidden;
    for (int i = threadIdx.x; i < kCols * tail; i += kThreads)
      w_s[i / tail * ldw + hidden + i % tail] = 0.0f;
    persistent::cp_async_commit();
    persistent::cp_async_wait_all();
    __syncthreads();
    for (int t = 0; t < a.seq_len; ++t) {
      const int rows = kMode == kSave ? a.batch : __ldg(a.live + t);
      if (rows <= 16)
        step<kMode, 2>(a, w_s, ldw, ring, red, d, t, rows);
      else
        step<kMode, 8>(a, w_s, ldw, ring, red, d, t, rows);
      // Every block's h of this step before anyone reads it; the parity
      // buffer the next step writes was last read the step before.
      if (++steps < a.directions * a.seq_len)
        persistent::direction_barrier(a.barrier,
                                      steps * static_cast<int>(gridDim.x));
    }
  }
}

template <int kMode>
cudaError_t launch(const Args& args, int smem, cudaStream_t stream) {
  auto kernel = lstm_f32_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  Args a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(a.hidden / kUnits), dim3(kThreads),
                                    params, static_cast<size_t>(smem),
                                    stream);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace persistent_f32

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

// Kernels 1 and A as one persistent cooperative launch (bf16; `units` and
// `smem_bytes` from ops/lstm_cuda.py::persistent_plan): h, c [D, B, H] f32
// and barrier [D] int32 zeroed, hq [2, D, B, H] bf16 scratch; with `save`
// also gates_all [D, T, B, 4H], c_all, h_all [D, T, B, H] f32 (else null).
// Returns cudaErrorInvalidValue for a plan this build would lay out
// otherwise, and the launch's error (cudaErrorCooperativeLaunchTooLarge when
// the blocks cannot all be resident).
extern "C" int vqa_lstm_recurrence_persistent(
    const void* xproj, const void* whh, const void* lengths, void* h, void* c,
    void* hq, void* barrier, void* gates_all, void* c_all, void* h_all,
    int directions, int seq_len, int batch, int hidden, int units,
    int smem_bytes, int save, void* stream) {
  if (units < 8 || units % 8 || 64 % units || hidden % 16 ||
      hidden % units ||
      static_cast<size_t>(smem_bytes) !=
          persistent::smem_bytes(units, hidden))
    return cudaErrorInvalidValue;
  if (batch == 0 || directions == 0 || seq_len == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return save ? persistent::launch<true>(
                    xproj, whh, lengths, h, c, hq, barrier, gates_all, c_all,
                    h_all, directions, seq_len, batch, hidden, units,
                    smem_bytes, s)
              : persistent::launch<false>(
                    xproj, whh, lengths, h, c, hq, barrier, nullptr, nullptr,
                    nullptr, directions, seq_len, batch, hidden, units,
                    smem_bytes, s);
}

// Kernels 1 and A in f32 as one persistent cooperative launch (`smem_bytes`
// from ops/lstm_cuda.py::f32_plan; a block per 8 hidden units): mode 0
// writes the final h, c [D, B, H]; mode 1 (kernel A) also gates_all [D, T,
// B, 4H], c_all and h_all [D, T, B, H] at every row and step; mode 2 (the
// token states) h_all and the final h, c only. h, c zeroed, hbuf [2, B, H]
// scratch, barrier [1] int32 zeroed; `order` (int32 [B], the rows by length
// longest first, a stable order) and `live` (int32 [T], the rows with t <
// len) are read in modes 0 and 2, which compute step t for those rows only.
// Returns cudaErrorInvalidValue for a size this build lays out otherwise,
// and the launch's error.
extern "C" int vqa_lstm_recurrence_f32(
    const void* xproj, const void* whh, const void* lengths, const void* order,
    const void* live, void* h, void* c, void* hbuf, void* barrier,
    void* gates_all, void* c_all, void* h_all, int directions, int seq_len,
    int batch, int hidden, int smem_bytes, int mode, void* stream) {
  using namespace persistent_f32;
  if (hidden < 16 || hidden % 16 ||
      static_cast<size_t>(smem_bytes) != persistent_f32::smem_bytes(hidden) ||
      mode < kFinal || mode > kTokens)
    return cudaErrorInvalidValue;
  // An empty call launches nothing (its tensors may have no storage).
  if (batch == 0 || directions == 0 || seq_len == 0) return cudaSuccess;
  if ((mode != kSave && (order == nullptr || live == nullptr)) ||
      (mode != kFinal && h_all == nullptr) ||
      (mode == kSave && (gates_all == nullptr || c_all == nullptr)))
    return cudaErrorInvalidValue;
  const Args args{static_cast<const float*>(xproj),
                  static_cast<const float*>(whh),
                  static_cast<const int*>(lengths),
                  static_cast<const int*>(order),
                  static_cast<const int*>(live),
                  static_cast<float*>(h),
                  static_cast<float*>(c),
                  static_cast<float*>(hbuf),
                  static_cast<int*>(barrier),
                  static_cast<float*>(gates_all),
                  static_cast<float*>(c_all),
                  static_cast<float*>(h_all),
                  directions,
                  seq_len,
                  batch,
                  hidden};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFinal:
      return launch<kFinal>(args, smem_bytes, s);
    case kSave:
      return launch<kSave>(args, smem_bytes, s);
    default:
      return launch<kTokens>(args, smem_bytes, s);
  }
}

extern "C" const char* vqa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
