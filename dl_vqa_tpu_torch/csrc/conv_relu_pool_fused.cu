// Stride-1 VALID conv + bias + ReLU + 2x2 max pool, the conv as tap GEMMs with
// the pool on the f32 accumulator (kernel 6 of the port).
//
// Replaces dl_vqa_tpu/ops/conv_fused.py::_fused_kernel:
//   acc[b, y, x, n] = sum over taps (di, dj) of
//                     x[b, y + di, x + dj, :] . w[di, dj, :, n]      (f32 sums)
//   out[b, i, j, n] = cast(max over the 2x2 window at (2i, 2j) of
//                     relu(acc + bias[n]))
// with operands rounded to x's type, floor pooling, one cast: only the pooled
// tensor reaches device memory. Bias and ReLU are monotone, so the max of the
// four accumulators comes first.
//
// What bounds it on this card: operations. conv1 at batch 512 is 0.88 TFLOP
// (0.89 ms at the bf16 tensor cores' 989 TFLOP/s) against 0.81 GB read and
// 0.38 GB written (0.36 ms); conv2 0.82 TFLOP against 0.47 GB. The unfused
// path writes and reads the unpooled output besides (1.6 and 0.7 GB).
//
// Design, bf16 (warpgroup MMA, wgmma.cuh). An implicit GEMM: M runs over conv
// positions, N over output channels, K over taps and input channels.
// - Weights resident. A block owns a slice of N = 32, 64 or 128 output
//   channels and keeps that slice's weights for all taps and input channels
//   in shared memory for the whole launch (conv1: all 128 channels, 147 KB;
//   conv2: 64 of 256, 147 KB), loaded once. The wrapper packs them
//   (ops/conv_fused.py::pack_conv_weight) as [tap][Cin / 64][Cout][64] in
//   wgmma's swizzled K-major layout, so a slice of one tap is one run of
//   memory and the B operand is read by descriptor as it lies. The grid is
//   persistent: per slice about (SMs / slices) blocks walk all conv tiles,
//   so the weights cross L2 once a block, not once a tile.
// - Weights streamed where no slice's weights fit (k = 3 from Cin = 320,
//   k = 5 from Cin = 128; conv_pool_stream_kernel): a block step stages
//   one filter row's weights for ck channels and serves four tiles with
//   them, two a warpgroup, 256 conv positions; the tiles' windows are
//   staged once a channel step. A shape takes one plan whatever the batch.
// - Two warpgroups a block, with the weights resident each on its own
//   stream of tiles with its own two stages of input, synchronised by its
//   own named barrier; while one waits for its input the other
//   multiplies. A warpgroup's tile is 64 conv
//   positions = 16 pool windows, laid as 4 x 4, 2 x 8 or 1 x 16 windows,
//   whichever masks the fewest positions at this output size (the plan;
//   conv1 2 x 8: 3.6% masked, conv2 4 x 4: 13.8%). Per step the warpgroup
//   stages the tile's input window with its halo for `ck` (<= 64) input
//   channels by cp.async.
// - A into registers by ldmatrix from the staged window: an operand's 16
//   rows are pixels of the window, so tap (di, dj) is the same window read
//   at a shifted pixel, with no im2col copy. wgmma m64nNk16 with A from
//   registers and B from shared memory, f32 accumulators in registers.
//   wgmma's fence, commit and wait each hold the whole warpgroup; with the
//   filter size known (k = 3) one filter row of taps loads its A operands
//   together and shares one of each, and the rows take two fragment
//   buffers in turn so that a row's products run under the next row's
//   loads (A registers stay untouched until their group retires).
// - Warp w of the warpgroup holds two conv rows by eight conv columns: the
//   upper row in its operand rows 0 .. 7, the lower in 8 .. 15, so that in
//   the accumulator layout a lane holds a window's two vertical sums and the
//   lane four further its two others: bias, ReLU and the pool are two max
//   and a shuffle in registers, and only pooled values are stored.
// Every conv position sums over taps and channels in the same order whatever
// the tile, so a pooled pixel's bits do not depend on the batch.
//
// f32 goes through plain FMAs (conv_pool_direct.cuh), which keeps the f32
// products exact rather than rounding them to TF32.

#include <cuda_pipeline.h>
#include <stdint.h>

#include "conv_pool_direct.cuh"
#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wg = vqa::wgmma;

constexpr int kWgThreads = 128;
constexpr int kWarpgroups = 2;  // a block's independent tile streams
constexpr int kThreads = kWgThreads * kWarpgroups;
// A staged pixel holds ck + kPad values: the eight 16-byte rows that one
// ldmatrix phase reads then fall on eight different bank groups.
constexpr int kPad = 8;
constexpr int kMaxShared = vqa_conv::kMaxShared;
constexpr int kStreamTiles = 4;  // tiles a block step, weights streamed

// The tiling of one call, as ops/conv_fused.py::fused_plan computes it.
struct Plan {
  int warp_rows, warp_cols;  // warps of a warpgroup by rows and columns: a
                             // tile is warp_rows x 4 warp_cols pool windows
  int channels;              // N: output channels a block owns
  int ck;                    // input channels a stage holds
  int atoms;                 // 64-channel atoms of Cin in the packed weight
  int in_h, in_w;            // the input window of a tile with its halo
  int tiles_y, tiles_x;      // tiles of one image
  bool stream;               // weights streamed a filter row a step
  size_t weight_bytes;       // resident: the slice's weights; streamed: one
                             // filter row of them (a weight stage)
  size_t stage_bytes;        // one tile's input window
  size_t shared;
};

// Fills `p` for `n` output channels a block and `ck` input channels a
// stage; true if it fits a block's shared memory.
bool fits(int k, int n, int ck, bool stream, Plan* p) {
  p->channels = n;
  p->ck = ck;
  p->stream = stream;
  p->stage_bytes = static_cast<size_t>(p->in_h) * p->in_w * (ck + kPad) *
                   sizeof(bf16);
  if (stream) {  // two weight stages, two stages of the block's windows
    p->weight_bytes = static_cast<size_t>(k) * n * 128;
    p->shared = 2 * p->weight_bytes + 2 * kStreamTiles * p->stage_bytes +
                wg::kAtomBytes;
  } else {  // the weights, two stages of each warpgroup's window
    p->weight_bytes = static_cast<size_t>(k) * k * p->atoms * n * 128;
    p->shared = p->weight_bytes + 2 * kWarpgroups * p->stage_bytes +
                wg::kAtomBytes;  // room to align the weights
  }
  return p->shared <= static_cast<size_t>(kMaxShared);
}

// False where not even streamed weights fit a block's shared memory.
bool make_plan(int h, int wd, int cin, int cout, int k, Plan* p) {
  const int hp = (h - k + 1) / 2, wp = (wd - k + 1) / 2;
  // The arrangement that masks the fewest windows; ties go to the squarer
  // tile, whose window has the smaller halo.
  const int arrangements[3][2] = {{4, 1}, {2, 2}, {1, 4}};
  long best = -1;
  for (const auto& a : arrangements) {
    const int ty = (hp + a[0] - 1) / a[0];
    const int tx = (wp + 4 * a[1] - 1) / (4 * a[1]);
    const long covered = static_cast<long>(ty) * tx * 16;
    if (best < 0 || covered < best) {
      best = covered;
      p->warp_rows = a[0];
      p->warp_cols = a[1];
      p->tiles_y = ty;
      p->tiles_x = tx;
    }
  }
  p->atoms = (cin + 63) / 64;
  p->in_h = 2 * p->warp_rows + k - 1;
  p->in_w = 8 * p->warp_cols + k - 1;
  // Resident weights with the widest stage dividing Cin, in the widest
  // slice that fits; else streamed weights, the widest slice, then the
  // widest stage, that fit.
  const int cks[4] = {64, 48, 32, 16};
  int widest = 0;
  while (cin % cks[widest]) ++widest;  // 16 divides Cin
  for (int n : {128, 64, 32})
    if (cout % n == 0 && fits(k, n, cks[widest], false, p)) return true;
  for (int n : {128, 64, 32})
    for (int c = widest; c < 4; ++c)
      if (cout % n == 0 && cin % cks[c] == 0 && fits(k, n, cks[c], true, p))
        return true;
  return false;
}

// The fragments an in-flight wgmma reads count as read here, so that the
// compiler holds their registers untouched until the wait that retires it.
template <int kTaps, int kSteps>
__device__ __forceinline__ void keep_live(unsigned (&a)[kTaps][kSteps][4]) {
#pragma unroll
  for (int t = 0; t < kTaps; ++t)
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      asm volatile("" : "+r"(a[t][q][0]), "+r"(a[t][q][1]), "+r"(a[t][q][2]),
                   "+r"(a[t][q][3]));
}

__device__ __forceinline__ void warpgroup_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kWgThreads)
               : "memory");
}

// A warpgroup's cooperative copy of tile `t`'s input window (kCk channels
// from c_off, zeros past the image) into `dst0`, ck + kPad values a pixel.
template <int kCk>
__device__ __forceinline__ void stage_window(bf16* dst0, const bf16* x,
                                             const Plan& plan, int t, int h,
                                             int wd, int cin, int c_off,
                                             int thread) {
  constexpr int kVecs = kCk / 8;
  const int tiles_img = plan.tiles_y * plan.tiles_x;
  const int64_t b = t / tiles_img;
  const int tile = t % tiles_img;
  const int y0 = tile / plan.tiles_x * 2 * plan.warp_rows;
  const int x0 = tile % plan.tiles_x * 8 * plan.warp_cols;
  const int in_w = plan.in_w;
  for (int e = thread; e < plan.in_h * in_w * kVecs; e += kWgThreads) {
    const int v = e % kVecs, pixel = e / kVecs;
    const int gy = y0 + pixel / in_w, gx = x0 + pixel % in_w;
    bf16* dst = dst0 + pixel * (kCk + kPad) + v * 8;
    if (gy < h && gx < wd)
      __pipeline_memcpy_async(
          dst, x + ((b * h + gy) * wd + gx) * cin + c_off + v * 8, 16);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The pool of a warpgroup's tile `t` in registers, and its store: a lane
// holds the window's upper and lower sums of one conv column; the column
// beside it is four lanes away. Bias and ReLU after the max. Zeroes acc.
template <int kN>
__device__ __forceinline__ void pool_store(float (&acc)[kN / 2],
                                           const Plan& plan, int t,
                                           int tiles, int warp, int lane,
                                           int n0, const float* bias,
                                           bf16* out, int hp, int wp,
                                           int cout) {
  const int tiles_img = plan.tiles_y * plan.tiles_x;
  const int wrow = warp / plan.warp_cols, wcol = warp % plan.warp_cols;
  const int g = lane / 4, c2 = lane % 4 * 2;
  const int64_t b = t / tiles_img;
  const int tile = t % tiles_img;
  const int i = tile / plan.tiles_x * plan.warp_rows + wrow;
  const int j = tile % plan.tiles_x * 4 * plan.warp_cols + 4 * wcol + g / 2;
  const bool store = g % 2 == 0 && t < tiles && i < hp && j < wp;
#pragma unroll
  for (int nb = 0; nb < kN / 8; ++nb) {
    float m0 = fmaxf(acc[4 * nb], acc[4 * nb + 2]);
    float m1 = fmaxf(acc[4 * nb + 1], acc[4 * nb + 3]);
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
    if (store) {
      const int channel = n0 + 8 * nb + c2;
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((b * hp + i) * wp + j) * cout + channel) =
          __floats2bfloat162_rn(fmaxf(m0 + bias[channel], 0.0f),
                                fmaxf(m1 + bias[channel + 1], 0.0f));
    }
  }
#pragma unroll
  for (int q = 0; q < kN / 2; ++q) acc[q] = 0.0f;
}

// Weights resident. kN: the block's output channels; kCk: input channels a
// stage holds; kK: the filter size as a constant, or 0 for the value
// passed at run time.
template <int kN, int kCk, int kK>
__global__ void __launch_bounds__(kThreads, 1)
conv_pool_wgmma_kernel(const bf16* __restrict__ x,      // [B, H, W, Cin]
                       const bf16* __restrict__ w,      // packed, see above
                       const float* __restrict__ bias,  // [Cout]
                       bf16* __restrict__ out,          // [B, Hp, Wp, Cout]
                       Plan plan, int batch, int h, int wd, int cin, int cout,
                       int k_rt, int hp, int wp) {
  constexpr int kCkp = kCk + kPad;
  constexpr int kSteps = kCk / 16;  // k16 steps a tap takes of a stage
  constexpr int kTapGroup = kK ? kK : 1;  // taps that share a commit group
  const int k = kK ? kK : k_rt;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  unsigned char* smem =
      smem_raw + ((wg::kAtomBytes - raw % wg::kAtomBytes) % wg::kAtomBytes);
  const int tid = threadIdx.x, group = tid / kWgThreads;
  const int warp = tid % kWgThreads / 32, lane = tid % 32;

  const int per_slice = gridDim.x / (cout / kN);  // blocks a channel slice
  const int n0 = blockIdx.x / per_slice * kN;

  // The slice's weights, once: for each (tap, atom) kN rows of 128 bytes.
  {
    const int64_t row_bytes = 128;
    const int pieces = kN * 8;  // 16-byte pieces of one (tap, atom)
    const int total = k * k * plan.atoms * pieces;
    for (int e = tid; e < total; e += kThreads) {
      const int ta = e / pieces, piece = e % pieces;
      __pipeline_memcpy_async(
          smem + static_cast<size_t>(ta) * kN * row_bytes + piece * 16,
          reinterpret_cast<const unsigned char*>(w) +
              (static_cast<int64_t>(ta) * cout + n0) * row_bytes + piece * 16,
          16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    wg::fence_shared();
    __syncthreads();
  }
  const uint32_t w_addr = wg::smem_addr(smem);
  bf16* my_stages = reinterpret_cast<bf16*>(
      smem + plan.weight_bytes + group * 2 * plan.stage_bytes);
  const int stage_elems = static_cast<int>(plan.stage_bytes / sizeof(bf16));

  // This warpgroup's tiles: every (slices-th) warpgroup of the slice's
  // 2 per_slice, each tile in cin / ck steps.
  const int tiles = batch * plan.tiles_y * plan.tiles_x;
  const int wg_id = blockIdx.x % per_slice * kWarpgroups + group;
  const int wgs = per_slice * kWarpgroups;
  const int channel_steps = cin / kCk;
  const int my_tiles = wg_id < tiles ? (tiles - wg_id + wgs - 1) / wgs : 0;
  const int steps = my_tiles * channel_steps;
  const int in_w = plan.in_w;
  const int wrow = warp / plan.warp_cols, wcol = warp % plan.warp_cols;

  // Cooperative copy of step `s`'s input window into stage `s % 2`.
  auto stage_step = [&](int s) {
    stage_window<kCk>(my_stages + (s & 1) * stage_elems, x, plan,
                      wg_id + s / channel_steps * wgs, h, wd, cin,
                      s % channel_steps * kCk, tid % kWgThreads);
    __pipeline_commit();
  };

  // This lane's ldmatrix row inside the window, without the tap's shift:
  // conv row 2 wrow + (lane % 16) / 8, column 8 wcol + lane % 8; and its
  // 8-channel half of a 16-channel step.
  const int a_pixel = (2 * wrow + lane % 16 / 8) * in_w + 8 * wcol + lane % 8;
  const int a_half = lane / 16 * 8;

  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.0f;
  unsigned frag[2][kTapGroup][kSteps][4];

  if (steps > 0) stage_step(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage_step(s + 1);
      __pipeline_wait_prior(1);  // this step has landed, the next may fly
    } else {
      __pipeline_wait_prior(0);
    }
    warpgroup_sync(group);
    const bf16* in_s = my_stages + (s & 1) * stage_elems;
    const int c_off = s % channel_steps * kCk;
#pragma unroll
    for (int di = 0; di < k; ++di) {
#pragma unroll
      for (int dj0 = 0; dj0 < k; dj0 += kTapGroup) {
        // A for kTapGroup taps at once: one fence, one commit group, one
        // wait for all of them (each is a warpgroup-wide synchronisation).
        // A wgmma in flight reads its A registers, which nothing may write
        // until its group retires: at k = 3 the filter rows take the two
        // fragment buffers in turn and each group may run on under the
        // next row's loads; else each group is retired before the next.
        auto& a = frag[kK ? di & 1 : 0];
#pragma unroll
        for (int t = 0; t < kTapGroup; ++t) {
          const bf16* a_tap =
              in_s + (a_pixel + di * in_w + dj0 + t) * kCkp + a_half;
#pragma unroll
          for (int q = 0; q < kSteps; ++q)
            vqa::ldmatrix_x4(a[t][q], a_tap + 16 * q);
        }
        wg::fence();
#pragma unroll
        for (int t = 0; t < kTapGroup; ++t) {
          const int tap = di * k + dj0 + t;
#pragma unroll
          for (int q = 0; q < kSteps; ++q) {
            const int kc = c_off + 16 * q;  // input channel of this step
            const uint32_t b_addr =
                w_addr + (tap * plan.atoms + kc / 64) * kN * 128 + kc % 64 * 2;
            wg::mma_rs<kN>(acc, a[t][q], wg::desc(b_addr), 1);
          }
        }
        wg::commit();
        if (kK) {
          wg::wait<1>();  // the row before has retired
          if (di > 0) keep_live(frag[(di - 1) & 1]);
        } else {
          wg::wait<0>();
        }
      }
    }
    if (kK) {  // the last row, before the next step's first takes its buffer
      wg::wait<0>();
      keep_live(frag[(k - 1) & 1]);
    }

    if (s % channel_steps == channel_steps - 1) {
      wg::wait<0>();
      wg::fence_operand(acc);
      pool_store<kN>(acc, plan, wg_id + s / channel_steps * wgs, tiles, warp,
                     lane, n0, bias, out, hp, wp, cout);
    }
    warpgroup_sync(group);  // this stage may now take the step after next
  }
}

// Weights streamed (plan.stream): the slice's weights do not fit a block.
// A block step takes four tiles, two a warpgroup, so that each weight
// byte staged serves 256 conv positions; it stages one filter row's
// weights for kCk channels. The four windows of a channel step are staged
// once, with the step's first filter row, for all k of its rows; two
// stages of each, filled by cp.async one step (windows: one channel step)
// ahead. The sums run in the resident kernel's order.
template <int kN, int kCk>
__global__ void __launch_bounds__(kThreads, 1)
conv_pool_stream_kernel(const bf16* __restrict__ x,      // [B, H, W, Cin]
                        const bf16* __restrict__ w,      // packed
                        const float* __restrict__ bias,  // [Cout]
                        bf16* __restrict__ out,          // [B, Hp, Wp, Cout]
                        Plan plan, int batch, int h, int wd, int cin,
                        int cout, int k, int hp, int wp) {
  constexpr int kCkp = kCk + kPad;
  constexpr int kSteps = kCk / 16;
  constexpr int kPieces = kCk / 8;  // 16-byte pieces of a weight row a step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  unsigned char* smem =
      smem_raw + ((wg::kAtomBytes - raw % wg::kAtomBytes) % wg::kAtomBytes);
  const int tid = threadIdx.x, group = tid / kWgThreads;
  const int warp = tid % kWgThreads / 32, lane = tid % 32;
  const unsigned char* w_bytes = reinterpret_cast<const unsigned char*>(w);

  const int per_slice = gridDim.x / (cout / kN);
  const int n0 = blockIdx.x / per_slice * kN;
  // Two weight stages (1024-byte aligned), then two stages of the block's
  // kStreamTiles windows.
  bf16* windows = reinterpret_cast<bf16*>(smem + 2 * plan.weight_bytes);
  const int window_elems = static_cast<int>(plan.stage_bytes / sizeof(bf16));

  const int tiles = batch * plan.tiles_y * plan.tiles_x;
  const int groups = (tiles + kStreamTiles - 1) / kStreamTiles;
  const int first = blockIdx.x % per_slice;
  const int my_groups =
      first < groups ? (groups - first + per_slice - 1) / per_slice : 0;
  const int channel_steps = cin / kCk;
  const int steps = my_groups * channel_steps * k;  // (group, channels, row)
  // Tile u (0, 1) of this warpgroup in the block's m-th channel step.
  auto tile_of = [&](int m, int u) {
    return (first + m / channel_steps * per_slice) * kStreamTiles +
           group * 2 + u;
  };

  // Step s's filter row di = s % k of channel step m = s / k.
  auto stage_weights = [&](int s) {
    const int di = s % k, c_off = s / k % channel_steps * kCk;
    unsigned char* stage = smem + (s & 1) * plan.weight_bytes;
    // For each tap (di, dj) and output channel a 128-byte row, swizzled as
    // in the packed weight, of which the step's 16-byte pieces are copied.
    for (int e = tid; e < k * kN * kPieces; e += kThreads) {
      const int row = e / kPieces;  // dj kN + n
      const int dj = row / kN, n = row % kN;
      const int c = c_off + e % kPieces * 8;
      const int place = ((c % 64 / 8) ^ (n % 8)) * 16;
      __pipeline_memcpy_async(
          stage + static_cast<size_t>(row) * 128 + place,
          w_bytes +
              ((static_cast<int64_t>(di * k + dj) * plan.atoms + c / 64) *
                   cout + n0 + n) * 128 + place,
          16);
    }
  };
  auto stage_windows = [&](int m) {  // this warpgroup's two, channel step m
    for (int u = 0; u < 2; ++u) {
      const int t = tile_of(m, u);
      if (t < tiles)
        stage_window<kCk>(
            windows + ((m & 1) * kStreamTiles + group * 2 + u) * window_elems,
            x, plan, t, h, wd, cin, m % channel_steps * kCk,
            tid % kWgThreads);
    }
  };

  const int in_w = plan.in_w;
  const int wrow = warp / plan.warp_cols, wcol = warp % plan.warp_cols;
  const int a_pixel = (2 * wrow + lane % 16 / 8) * in_w + 8 * wcol + lane % 8;
  const int a_half = lane / 16 * 8;

  float acc[2][kN / 2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[u][i] = 0.0f;

  if (steps > 0) {
    stage_weights(0);
    stage_windows(0);
  }
  __pipeline_commit();
  for (int s = 0; s < steps; ++s) {
    // One commit group a step: the next step's weights and, with a channel
    // step's first row, the next channel step's windows.
    if (s + 1 < steps) stage_weights(s + 1);
    if (s % k == 0 && s + k < steps) stage_windows(s / k + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // all but this step's group have landed
    wg::fence_shared();        // the weights, for wgmma's reads
    __syncthreads();
    const int m = s / k, di = s % k;
    const int c_off = m % channel_steps * kCk;
    const uint32_t w_addr = wg::smem_addr(smem + (s & 1) * plan.weight_bytes);
    const bf16* in_s =
        windows + ((m & 1) * kStreamTiles + group * 2) * window_elems;
    for (int dj = 0; dj < k; ++dj) {
      unsigned a[2][kSteps][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const bf16* a_tap = in_s + u * window_elems +
                            (a_pixel + di * in_w + dj) * kCkp + a_half;
#pragma unroll
        for (int q = 0; q < kSteps; ++q)
          vqa::ldmatrix_x4(a[u][q], a_tap + 16 * q);
      }
      wg::fence();
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const uint64_t b =
            wg::desc(w_addr + dj * kN * 128 + (c_off + 16 * q) % 64 * 2);
#pragma unroll
        for (int u = 0; u < 2; ++u) wg::mma_rs<kN>(acc[u], a[u][q], b, 1);
      }
      wg::commit();
      wg::wait<0>();  // the next tap's loads may take these A registers
    }
    if (m % channel_steps == channel_steps - 1 && di == k - 1) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        wg::fence_operand(acc[u]);
        pool_store<kN>(acc[u], plan, tile_of(m, u), tiles, warp, lane, n0,
                       bias, out, hp, wp, cout);
      }
    }
    __syncthreads();  // both stages may now take the steps after next
  }
}

template <int kN, int kCk>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   const Plan& plan, int batch, int h, int wd, int cin,
                   int cout, int k, cudaStream_t stream) {
  // The filter size as a constant only for the model's own stages (64
  // channels), which keeps the build to one more instantiation a width.
  constexpr int kK3 = kCk == 64 ? 3 : 0;
  auto kernel = plan.stream ? conv_pool_stream_kernel<kN, kCk>
                : k == 3    ? conv_pool_wgmma_kernel<kN, kCk, kK3>
                            : conv_pool_wgmma_kernel<kN, kCk, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.shared));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // Blocks a channel slice gets: the SMs shared out among the slices, and
  // no more than its tiles need (two a block step resident, four
  // streamed).
  const int slices = cout / kN;
  const int per_step = plan.stream ? kStreamTiles : kWarpgroups;
  const long tiles = static_cast<long>(batch) * plan.tiles_y * plan.tiles_x;
  long per_slice = sms / slices > 1 ? sms / slices : 1;
  const long needed = (tiles + per_step - 1) / per_step;
  if (per_slice > needed) per_slice = needed;
  const unsigned blocks = static_cast<unsigned>(per_slice * slices);
  kernel<<<blocks, kThreads, plan.shared, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias,
      static_cast<bf16*>(out), plan, batch, h, wd, cin, cout, k,
      (h - k + 1) / 2, (wd - k + 1) / 2);
  return cudaGetLastError();
}

template <int kN>
cudaError_t launch_n(const void* x, const void* w, const float* bias,
                     void* out, const Plan& plan, int batch, int h, int wd,
                     int cin, int cout, int k, cudaStream_t stream) {
  switch (plan.ck) {
    case 64:
      return launch<kN, 64>(x, w, bias, out, plan, batch, h, wd, cin, cout, k,
                            stream);
    case 48:
      return launch<kN, 48>(x, w, bias, out, plan, batch, h, wd, cin, cout, k,
                            stream);
    case 32:
      return launch<kN, 32>(x, w, bias, out, plan, batch, h, wd, cin, cout, k,
                            stream);
    default:
      return launch<kN, 16>(x, w, bias, out, plan, batch, h, wd, cin, cout, k,
                            stream);
  }
}

cudaError_t run_wgmma(const void* x, const void* w, const float* bias,
                      void* out, int batch, int h, int wd, int cin, int cout,
                      int k, cudaStream_t stream) {
  Plan plan;
  if (!make_plan(h, wd, cin, cout, k, &plan)) return cudaErrorInvalidValue;
  switch (plan.channels) {
    case 128:
      return launch_n<128>(x, w, bias, out, plan, batch, h, wd, cin, cout, k,
                           stream);
    case 64:
      return launch_n<64>(x, w, bias, out, plan, batch, h, wd, cin, cout, k,
                          stream);
    default:
      return launch_n<32>(x, w, bias, out, plan, batch, h, wd, cin, cout, k,
                          stream);
  }
}

}  // namespace

// x [B, H, W, Cin], bias [Cout] f32 -> out [B, (H - k + 1) / 2,
// (W - k + 1) / 2, Cout]. f32: w [k * k, Cin, Cout] f32, Cout a multiple of
// 8. bf16: w packed by ops/conv_fused.py::pack_conv_weight ([k * k,
// ceil(Cin / 64), Cout, 64], swizzled), Cin a multiple of 16 and Cout of 32,
// and k small enough that two stages of a filter row of 32 channels'
// weights and of four input windows fit a block's shared memory (every
// k <= 9, none from 12). cudaErrorInvalidValue for anything else.
extern "C" int vqa_conv_relu_pool_fused(const void* x, const void* w,
                                        const void* bias, void* out, int batch,
                                        int h, int wd, int cin, int cout, int k,
                                        int dtype, void* stream) {
  const float* bf = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || cin < 1 || cout < 1) return cudaErrorInvalidValue;
  if (batch <= 0 || (h - k + 1) / 2 <= 0 || (wd - k + 1) / 2 <= 0)
    return cudaSuccess;
  switch (dtype) {
    case vqa::kBFloat16:
      if (cin % 16 || cout % 32) return cudaErrorInvalidValue;
      return run_wgmma(x, w, bf, out, batch, h, wd, cin, cout, k, s);
    case vqa::kFloat32:
      return vqa_conv::run_direct<float>(x, static_cast<const float*>(w), bf,
                                         out, batch, h, wd, cin, cout, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The bf16 plan of a call, for the tests: plan[0 .. 5] = warp rows, warp
// columns, channels a block owns, input channels a stage holds, shared
// bytes, 1 where the weights are streamed. Returns cudaErrorInvalidValue
// where there is none.
extern "C" int vqa_conv_relu_pool_fused_plan(int h, int wd, int cin, int cout,
                                             int k, int* plan) {
  Plan p;
  if (k < 1 || cin % 16 || cout % 32 || (h - k + 1) / 2 <= 0 ||
      (wd - k + 1) / 2 <= 0 || !make_plan(h, wd, cin, cout, k, &p))
    return cudaErrorInvalidValue;
  plan[0] = p.warp_rows;
  plan[1] = p.warp_cols;
  plan[2] = p.channels;
  plan[3] = p.ck;
  plan[4] = static_cast<int>(p.shared);
  plan[5] = p.stream;
  return cudaSuccess;
}
