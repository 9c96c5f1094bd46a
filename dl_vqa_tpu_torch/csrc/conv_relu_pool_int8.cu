// The W8A8 conv block of the int8 serving mode (kernel D of the port): an
// s8 x s8 -> s32 convolution, the f32 requantizing epilogue, ReLU, the int8
// store and the 2x2/2 max pool, in one pass.
//
// No TPU kernel stands behind it: the JAX package computes the block in XLA
// (dl_vqa_tpu/ops/conv_int8.py::conv_relu_pool_w8a8, a conv_general_dilated
// with preferred_element_type=int32, then quantize_relu_pool), and PyTorch
// has no int8 convolution on CUDA. It computes, for x [B, H, W, Cin] int8
// (NHWC), any stride s, a VALID k x k filter and floor pooling:
//   acc[b, r, c, n] = sum over di, dj, ci of
//                     x[b, s r + di, s c + dj, ci] * w_q[n, ci, di, dj]   (s32)
//   y = fma(float_rn(acc), mult[n], bias[n])     (one rounding, as XLA)
//   q = clip(rint(relu(y) * scale), 0, 127)       (int8, half to even)
//   out[b, i, j, n] = max of q over the 2x2 window at (2i, 2j)
// where mult = w_scale * f32(s_in / 127) and scale = f32(127 / s_out) come
// rounded from the caller, as the JAX package rounds them, and the
// multiply-add rounds once because XLA contracts the JAX expression into a
// fused multiply-add when the model runs jitted. Each of the four
// positions of a window is finished on its own (`finish`, one function for
// both kernels below) before the max, in the JAX order, so no monotonicity
// of the epilogue is assumed. The s32 sums are exact in any order, so both
// kernels give the plain version's codes bit for bit.
//
// What bounds it on this card: operations. conv1 of the reference model at
// batch 512 (111 px, 64 -> 128 channels) is 0.88 T integer operations over
// the 108 x 108 conv positions its pool reads, and moves 0.40 GB in and
// 0.19 GB out: 0.45 ms at the dense int8 peak against 0.18 ms of memory
// traffic; conv2 (54 px, 128 -> 256) 0.82 T.
//
// Two kernels behind the one C entry; ops/conv_int8.py::w8a8_plan picks one
// a shape and fixes its tiling. No plan is made here: the entry takes the
// plan's tiles, atoms and stage size as they are, and checks only that the
// kernel's accesses stay within the tensors and the shared memory.
//
// The wgmma kernel (stride 1, k = 3, Cin a multiple of 32, Cout of 4): the
// design of kernel 6 (conv_relu_pool_fused.cu) in s8. An implicit GEMM, M =
// conv positions, N = output channels, K = (di, dj, ci).
// - Weights resident. A block owns a slice of N = 128 output channels (Cout
//   padded to whole slices) and keeps the slice's weights for all of K in
//   shared memory for the whole launch (conv1: 5 atoms x 128 channels, 80
//   KB; conv2: 9 x 128 of its 256, 144 KB). The wrapper packs them (pack_int8_weight_wgmma) as
//   [K / 128][Cout][128] in wgmma's 128-byte-swizzled K-major layout with K
//   laid end to end across atoms, so that conv1's taps of 64 channels take
//   half an atom each and no product runs on padding. The grid is
//   persistent: a slice's blocks (the plan's `blocks`, about SMs / slices)
//   walk all tiles.
// - Two warpgroups a block, each with its own two input stages filled by
//   cp.async one step ahead and its own named barrier; a block walks pairs
//   of tiles, one tile a warpgroup. The warpgroups take turns at the tensor
//   cores (two more named barriers): each issues a step's products, hands
//   the turn over, and runs its epilogue and next loads under the other's
//   products; without the turns the two fall into step and both sit in
//   their epilogues at once. A tile is 64 conv positions = 16 pool windows,
//   laid as 4 x 4, 2 x 8 or 1 x 16 windows (the plan; conv1 2 x 8, conv2
//   4 x 4; a template argument, so the window's shape is a constant),
//   staged once with its halo for `ck` input channels, ck + 16 bytes a
//   pixel so that one ldmatrix phase's eight pixels fall on eight bank
//   groups.
// - A into registers by ldmatrix from the staged window (tap (di, dj) is
//   the window read at a shifted pixel, no im2col copy), B by descriptor:
//   wgmma m64nNk32 s8.s8 -> s32. A filter row's three taps share one fence
//   and commit, and the rows take two fragment buffers in turn so that a
//   row's products run under the next row's loads; no A register that a
//   wgmma in flight reads is written before its group retires (keep_live).
// - The epilogue on the accumulators: warp w holds two conv rows by eight
//   conv columns, the upper row in its operand rows 0 .. 7 and the lower in
//   8 .. 15, so a lane holds a window's two vertical positions of one
//   column and the lane four further the other column. Each position is
//   finished to its code, then the window's max is taken over the lane's
//   two and, by a shuffle, the other column's two; the codes are packed
//   four to a word, a second shuffle regroups the words so that each lane
//   stores four consecutive channels, and the lanes of even and odd columns
//   take alternate 16-channel groups. The epilogue is most of a step's
//   instructions (seven a position), which is what the turns hide.
//
// The mma.sync kernel (every other shape the plan takes): an implicit GEMM
// on mma.sync m16n8k32, M = the conv positions of 8 pooled columns (the two
// rows of each window in two m16 tiles, its two columns in rows g and g + 8
// of a tile, so that a thread holds the four positions of its windows), N =
// 32 channels a warp, K = (di, dj, ci) with Cin padded to 32. A block makes
// one pooled row of one image for 128 channels: it stages the s + k input
// rows it reads (all of their columns, Cin padded with zeros) in shared
// memory once, with the plan's pixel stride, which spreads a fragment's
// loads over all the banks, and its warps walk (column group, 32-channel
// quarter) items. The weights come packed in fragment order
// (pack_int8_weight) from global memory (8 bytes a lane, a warp's load one
// 256-byte run; they stay in L1 and L2).

#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = vqa::wgmma;

constexpr int kMaxShared = 232448;  // bytes a block may have on sm_90

// One conv position's code: fma(f32(acc), mult, bias) rounded once, ReLU,
// times scale, clipped to [0, 127] and rounded half to even. The clip comes
// before the rounding, which gives the same code (rounding is monotone and
// 0 and 127 are integers), and the rounding is an f32 add of 1.5 2^23: the
// code comes as the float 1.5 2^23 + code, whose low byte is the code and
// whose order is the codes' order. No float-to-int conversion, which runs
// at a quarter of the f32 rate.
__device__ __forceinline__ float finish(int acc, float mult, float bias,
                                        float scale) {
  const float y = __fmaf_rn(__int2float_rn(acc), mult, bias);
  const float v = fminf(fmaxf(__fmul_rn(fmaxf(y, 0.0f), scale), 0.0f), 127.0f);
  return __fadd_rn(v, 12582912.0f);
}

// The code that `finish` encodes.
__device__ __forceinline__ int code_of(float finished) {
  return __float_as_int(finished) & 0xFF;
}

// ---------------------------------------------------------------- mma.sync

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kBlockN = 128;          // output channels a block makes
constexpr int kWarpTiles = 4;         // n8 tiles a warp item makes
constexpr int kQuarters = kBlockN / (8 * kWarpTiles);
constexpr int kCols = 8;              // pooled columns a warp item makes

// d += a . b for s8 a [16, 32] (row-major), s8 b [32, 8] (column-major) and
// s32 d [16, 8]: a lane holds a[lane / 4][4 (lane % 4) + {0..3}] in a[0],
// row lane / 4 + 8 in a[1], and the same rows at k + 16 in a[2], a[3]; b
// column lane / 4 at k = 4 (lane % 4) + {0..3} in b0 and k + 16 in b1; d as
// mma.m16n8k16's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Shape {
  int h, w, cin, cout, k, stride, hp, wp;
  int cin_words;  // Cin padded to 32, in 4-byte words
  int pw;         // words a staged pixel takes (the plan's pixel stride)
  int ksteps;     // k * k * Cin_pad / 32
};

__global__ void __launch_bounds__(kMmaThreads)
conv_relu_pool_int8_kernel(const int8_t* __restrict__ x,     // [B, H, W, Cin]
                           const uint2* __restrict__ wpack,  // fragments
                           const float* __restrict__ mult,   // [Cout]
                           const float* __restrict__ bias,   // [Cout]
                           int8_t* __restrict__ out,  // [B, Hp, Wp, Cout]
                           Shape s, float scale) {
  extern __shared__ unsigned staged[];  // [s + k rows][W][pw] words
  const int row = blockIdx.x;           // b * hp + i
  const int b = row / s.hp, i = row % s.hp;
  const int n_block = blockIdx.y * kBlockN;
  const int rows = s.stride + s.k;
  const int first_row = 2 * i * s.stride;

  // Stage the input rows of pooled row i, Cin padded with zero words.
  const int words = rows * s.w * s.cin_words;
  const int cin4 = s.cin / 4;
  for (int e = threadIdx.x; e < words; e += kMmaThreads) {
    const int cw = e % s.cin_words;
    const int pix = e / s.cin_words;  // r * W + col
    const int r = pix / s.w, col = pix % s.w;
    unsigned v = 0;
    if (cw < cin4) {
      const int64_t offset =
          ((static_cast<int64_t>(b) * s.h + first_row + r) * s.w + col) *
              s.cin + 4 * cw;
      v = __ldg(reinterpret_cast<const unsigned*>(x + offset));
    }
    staged[pix * s.pw + cw] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int groups = (s.wp + kCols - 1) / kCols;
  const int csteps = s.cin_words / 8;  // k steps of 32 channels a tap
  for (int item = warp; item < groups * kQuarters; item += kMmaWarps) {
    const int group = item / kQuarters, quarter = item % kQuarters;
    const int n0 = n_block + quarter * 8 * kWarpTiles;
    if (n0 >= s.cout) continue;
    const int j = group * kCols + g;
    const int jj = j < s.wp ? j : s.wp - 1;  // a clamped address; not stored
    int acc[2][kWarpTiles][4] = {};
    const uint2* wq = wpack + static_cast<int64_t>(n0 / 8) * s.ksteps * 32;
    for (int di = 0; di < s.k; ++di) {
      for (int dj = 0; dj < s.k; ++dj) {
        // The staged pixels of the window's four positions for this tap.
        int base[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            base[a][c] = ((s.stride * a + di) * s.w +
                          s.stride * (2 * jj + c) + dj) * s.pw + t;
        const int step0 = (di * s.k + dj) * csteps;
        for (int cs = 0; cs < csteps; ++cs) {
          unsigned frag[2][4];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            frag[a][0] = staged[base[a][0] + 8 * cs];
            frag[a][1] = staged[base[a][1] + 8 * cs];
            frag[a][2] = staged[base[a][0] + 8 * cs + 4];
            frag[a][3] = staged[base[a][1] + 8 * cs + 4];
          }
          const int step = step0 + cs;
#pragma unroll
          for (int nt = 0; nt < kWarpTiles; ++nt) {
            const uint2 bw =
                __ldg(wq + (static_cast<int64_t>(nt) * s.ksteps + step) * 32 +
                      lane);
            mma_s8(acc[0][nt], frag[0], bw.x, bw.y);
            mma_s8(acc[1][nt], frag[1], bw.x, bw.y);
          }
        }
      }
    }
    if (j >= s.wp) continue;
    int8_t* dst = out + (static_cast<int64_t>(row) * s.wp + j) * s.cout;
#pragma unroll
    for (int nt = 0; nt < kWarpTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + nt * 8 + 2 * t + e;
        if (n >= s.cout) continue;
        const float m = mult[n], bn = bias[n];
        // (row 2i, col 2j), (2i, 2j + 1), (2i + 1, 2j), (2i + 1, 2j + 1)
        const int q0 = code_of(finish(acc[0][nt][e], m, bn, scale));
        const int q1 = code_of(finish(acc[0][nt][2 + e], m, bn, scale));
        const int q2 = code_of(finish(acc[1][nt][e], m, bn, scale));
        const int q3 = code_of(finish(acc[1][nt][2 + e], m, bn, scale));
        dst[n] = static_cast<int8_t>(max(max(q0, q1), max(q2, q3)));
      }
    }
  }
}

// ------------------------------------------------------------------ wgmma

constexpr int kWgThreads = 128;
constexpr int kWarpgroups = 2;  // a block's warpgroups: a tile pair's two
constexpr int kWgBlockThreads = kWgThreads * kWarpgroups;
constexpr int kPad = 16;  // bytes after a staged pixel's ck channels
constexpr int kK = 3;     // the filter size the kernel takes
constexpr int kWgN = 128;  // output channels a block keeps resident

// What a launch needs besides its template arguments.
struct WgArgs {
  int batch, h, wd, cin, cout, hp, wp;
  int tiles_y, tiles_x;  // tiles of one image
  int atoms;             // 128-byte K atoms of the packed weight
  int cout_pad;          // Cout padded to whole slices
  int stage_bytes;       // one tile's staged window
  int weight_bytes;      // one slice's weights
  float scale;
};

// Where a warpgroup's stream of tiles stands: image b, tile row ty and
// column tx; `step` moves it on by the stream's stride (db images, dty
// rows, dtx columns) without a division.
struct TileWalk {
  int b, ty, tx;
  int db, dty, dtx;

  __device__ __forceinline__ void start(int t, int stride,
                                        const WgArgs& a) {
    const int per_image = a.tiles_y * a.tiles_x;
    b = t / per_image;
    ty = t % per_image / a.tiles_x;
    tx = t % a.tiles_x;
    db = stride / per_image;
    dty = stride % per_image / a.tiles_x;
    dtx = stride % per_image % a.tiles_x;
  }
  __device__ __forceinline__ void step(const WgArgs& a) {
    b += db;
    ty += dty;
    tx += dtx;
    if (tx >= a.tiles_x) {
      tx -= a.tiles_x;
      ++ty;
    }
    if (ty >= a.tiles_y) {
      ty -= a.tiles_y;
      ++b;
    }
  }
};

// The fragments an in-flight wgmma reads count as read here, so that the
// compiler holds their registers untouched until the wait that retires it.
template <int kSteps>
__device__ __forceinline__ void keep_live(unsigned (&a)[kK][kSteps][4]) {
#pragma unroll
  for (int t = 0; t < kK; ++t)
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      asm volatile("" : "+r"(a[t][q][0]), "+r"(a[t][q][1]), "+r"(a[t][q][2]),
                   "+r"(a[t][q][3]));
}

__device__ __forceinline__ void warpgroup_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kWgThreads)
               : "memory");
}

// The tensor cores' turn between the block's two warpgroups (named
// barriers 3 and 4, counted over both warpgroups' threads): a warpgroup
// waits for its turn before it issues a step's products and hands the turn
// over once they are issued, so that its epilogue and its next stage's
// loads run under the other warpgroup's products rather than beside them.
__device__ __forceinline__ void await_turn(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + group), "r"(kWgBlockThreads)
               : "memory");
}
__device__ __forceinline__ void pass_turn(int group) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(4 - group), "r"(kWgBlockThreads)
               : "memory");
}

// A warpgroup's cooperative copy of the input window of the tile at `at`
// (kCk channels from c_off, zeros past the image) into `dst0`, kCk + kPad
// bytes a pixel. The window's shape is a constant, so a thread's pixels
// come without a division by a run-time value.
template <int kCk, int kWarpCols>
__device__ __forceinline__ void stage_window(int8_t* dst0, const int8_t* x,
                                             const TileWalk& at,
                                             const WgArgs& a, int c_off,
                                             int thread) {
  constexpr int kVecs = kCk / 16;
  constexpr int kInH = 2 * (4 / kWarpCols) + kK - 1;
  constexpr int kInW = 8 * kWarpCols + kK - 1;
  constexpr int kElems = kInH * kInW * kVecs;
  const int y0 = at.ty * 2 * (4 / kWarpCols), x0 = at.tx * 8 * kWarpCols;
  const int8_t* origin =
      x + ((static_cast<int64_t>(at.b) * a.h + y0) * a.wd + x0) * a.cin +
      c_off;
  const int rows = a.h - y0, cols = a.wd - x0;
#pragma unroll
  for (int r = 0; r < (kElems + kWgThreads - 1) / kWgThreads; ++r) {
    const int e = thread + r * kWgThreads;
    if (kElems % kWgThreads == 0 || e < kElems) {
      const int v = e % kVecs, pixel = e / kVecs;
      const int py = pixel / kInW, px = pixel % kInW;
      int8_t* dst = dst0 + pixel * (kCk + kPad) + v * 16;
      if (py < rows && px < cols)
        __pipeline_memcpy_async(
            dst, origin + (py * a.wd + px) * a.cin + v * 16, 16);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The epilogue of a warpgroup's tile in registers, and its store. A lane
// holds, for each 8-channel block jb, channels 8 jb + 2 (lane % 4) and the
// next at the window's upper (acc[4 jb], acc[4 jb + 1]) and lower
// (acc[4 jb + 2], acc[4 jb + 3]) positions of one conv column; the lane
// four further holds the other column. `mb` holds (mult, bias) of channel
// pairs, one float4 a pair. Lanes of even columns store the even 16-channel
// groups m, lanes of odd columns the odd ones: `word` points at this
// lane's four channels of group 0 (`store` false where the window lies
// outside the output), and `limit` is the channels the slice has past
// them. Zeroes acc.
__device__ __forceinline__ void pool_store(int (&acc)[kWgN / 2], bool store,
                                           unsigned* word, int limit,
                                           int lane, const float4* mb,
                                           float scale) {
  const int t4 = lane % 4;
  const bool even = t4 % 2 == 0, odd_column = lane / 4 % 2 == 1;
#pragma unroll
  for (int m = 0; m < kWgN / 16; ++m) {  // channels 16 m .. 16 m + 15
    // Each position finished on its own, then the window's max: over this
    // lane's two rows, then over the column four lanes away. q[half][e]:
    // channel 2 t4 + e of block 2 m + half.
    float q[2][2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jb = 2 * m + half;
      const float4 p = mb[4 * jb + t4];
      q[half][0] = fmaxf(finish(acc[4 * jb], p.x, p.y, scale),
                         finish(acc[4 * jb + 2], p.x, p.y, scale));
      q[half][1] = fmaxf(finish(acc[4 * jb + 1], p.z, p.w, scale),
                         finish(acc[4 * jb + 3], p.z, p.w, scale));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        q[half][e] = fmaxf(q[half][e],
                           __shfl_xor_sync(0xffffffffu, q[half][e], 4));
    // The four codes a byte each (blocks 2 m, 2 m + 1; channels e), then
    // lanes 2u and 2u + 1 trade halves: the even one holds channels 16 m +
    // 2 t4 .. + 3 of block 2 m, the odd one 16 m + 8 + 2 (t4 - 1) .. + 3 of
    // block 2 m + 1.
    const unsigned p = __byte_perm(
        __byte_perm(__float_as_uint(q[0][0]), __float_as_uint(q[0][1]), 0x40),
        __byte_perm(__float_as_uint(q[1][0]), __float_as_uint(q[1][1]), 0x40),
        0x5410);
    const unsigned other = __shfl_xor_sync(0xffffffffu, p, 1);
    if (store && odd_column == (m % 2 == 1) && 16 * m < limit)
      word[4 * m] = even ? __byte_perm(p, other, 0x5410)
                         : __byte_perm(other, p, 0x7632);
  }
#pragma unroll
  for (int q = 0; q < kWgN / 2; ++q) acc[q] = 0;
}

// kCk: input channels a stage holds; kWarpCols: warps of a warpgroup side
// by side (a tile is 4 / kWarpCols by 4 kWarpCols pool windows).
template <int kCk, int kWarpCols>
__global__ void __launch_bounds__(kWgBlockThreads, 1)
conv_relu_pool_int8_wgmma_kernel(
    const int8_t* __restrict__ x,     // [B, H, W, Cin]
    const int8_t* __restrict__ w,     // packed, [atoms][cout_pad][128]
    const float* __restrict__ mult,   // [Cout]
    const float* __restrict__ bias,   // [Cout]
    int8_t* __restrict__ out,         // [B, Hp, Wp, Cout]
    WgArgs a) {
  constexpr int kWarpRows = 4 / kWarpCols;
  constexpr int kInW = 8 * kWarpCols + kK - 1;
  constexpr int kPixel = kCk + kPad;
  constexpr int kSteps = kCk / 32;  // k32 steps a tap takes of a stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  unsigned char* smem =
      smem_raw + ((wg::kAtomBytes - raw % wg::kAtomBytes) % wg::kAtomBytes);
  const int tid = threadIdx.x, group = tid / kWgThreads;
  const int warp = tid % kWgThreads / 32, lane = tid % 32;

  const int per_slice = gridDim.x / (a.cout_pad / kWgN);
  const int n0 = blockIdx.x / per_slice * kWgN;

  // Shared memory: the slice's weights, each warpgroup's two stages, the
  // slice's (mult, bias) by channel pairs.
  float4* s_mb = reinterpret_cast<float4*>(smem + a.weight_bytes +
                                           2 * kWarpgroups * a.stage_bytes);
  {
    const int pieces = kWgN * 8;  // 16-byte pieces of one atom's slice
    for (int e = tid; e < a.atoms * pieces; e += kWgBlockThreads) {
      const int atom = e / pieces, piece = e % pieces;
      __pipeline_memcpy_async(
          smem + static_cast<size_t>(atom) * kWgN * 128 + piece * 16,
          w + (static_cast<int64_t>(atom) * a.cout_pad + n0) * 128 +
              piece * 16,
          16);
    }
    __pipeline_commit();
    for (int c = 2 * tid; c < kWgN; c += 2 * kWgBlockThreads) {
      const int n = n0 + c;
      s_mb[c / 2] = make_float4(n < a.cout ? mult[n] : 0.0f,
                                n < a.cout ? bias[n] : 0.0f,
                                n + 1 < a.cout ? mult[n + 1] : 0.0f,
                                n + 1 < a.cout ? bias[n + 1] : 0.0f);
    }
    __pipeline_wait_prior(0);
    wg::fence_shared();
    __syncthreads();
  }
  const uint64_t desc0 = wg::desc(wg::smem_addr(smem));
  int8_t* my_stages = reinterpret_cast<int8_t*>(
      smem + a.weight_bytes + group * 2 * a.stage_bytes);

  // The block's tile pairs: every per_slice-th pair of the slice's tiles,
  // each tile in cin / kCk steps; warpgroup g takes tile 2 p + g of pair p
  // (the last pair's second may lie past the tiles: that warpgroup then
  // only keeps the turns). `next` walks the tiles being staged, `cur` the
  // tiles being multiplied.
  const int tiles = a.batch * a.tiles_y * a.tiles_x;
  const int first = blockIdx.x % per_slice;
  const int pairs = (tiles + kWarpgroups - 1) / kWarpgroups;
  const int wgs = per_slice * kWarpgroups;
  const int channel_steps = a.cin / kCk;
  const int my_pairs =
      first < pairs ? (pairs - first + per_slice - 1) / per_slice : 0;
  const int steps = my_pairs * channel_steps;
  const int wrow = warp / kWarpCols, wcol = warp % kWarpCols;
  TileWalk next, cur;
  next.start(first * kWarpgroups + group, wgs, a);
  cur = next;

  // This lane's ldmatrix row inside the window, without the tap's shift:
  // conv row 2 wrow + (lane % 16) / 8, column 8 wcol + lane % 8; and its
  // 16-byte half of a 32-channel step.
  const int a_offset =
      ((2 * wrow + lane % 16 / 8) * kInW + 8 * wcol + lane % 8) * kPixel +
      lane / 16 * 16;
  // The pooled pixel this lane stores, inside its tile, and its first
  // channel (pool_store).
  const int own_i = wrow, own_j = 4 * wcol + lane / 8;
  const int lane_channel = lane % 2 == 0 ? lane % 4 * 2 : 6 + lane % 4 * 2;

  int acc[kWgN / 2];
#pragma unroll
  for (int q = 0; q < kWgN / 2; ++q) acc[q] = 0;
  unsigned frag[2][kK][kSteps][4];

  if (group == 1) pass_turn(group);  // the first turn is warpgroup 0's
  if (steps > 0) {
    if (next.b < a.batch)
      stage_window<kCk, kWarpCols>(my_stages, x, next, a, 0,
                                   tid % kWgThreads);
    __pipeline_commit();
  }
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {  // stage step s + 1 into stage (s + 1) % 2
      if ((s + 1) % channel_steps == 0) next.step(a);
      if (next.b < a.batch)
        stage_window<kCk, kWarpCols>(
            my_stages + ((s + 1) & 1) * a.stage_bytes, x, next, a,
            (s + 1) % channel_steps * kCk, tid % kWgThreads);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this step has landed, the next may fly
    } else {
      __pipeline_wait_prior(0);
    }
    warpgroup_sync(group);
    const int8_t* in_s = my_stages + (s & 1) * a.stage_bytes + a_offset;
    const int c_off = s % channel_steps * kCk;
    await_turn(group);
    if (cur.b < a.batch) {
#pragma unroll
      for (int di = 0; di < kK; ++di) {
        // A filter row's three taps: one fence, one commit group. The rows
        // take the two fragment buffers in turn: a row's group runs on
        // under the next row's loads, and is retired (wait<1>) before the
        // row after that writes its buffer.
        auto& f = frag[di & 1];
#pragma unroll
        for (int dj = 0; dj < kK; ++dj)
#pragma unroll
          for (int q = 0; q < kSteps; ++q)
            vqa::ldmatrix_x4(f[dj][q],
                             in_s + (di * kInW + dj) * kPixel + 32 * q);
        wg::fence();
#pragma unroll
        for (int dj = 0; dj < kK; ++dj) {
#pragma unroll
          for (int q = 0; q < kSteps; ++q) {
            // K offset of this step, (tap, input channel) laid end to end:
            // atom kk / 128 at kWgN 128 bytes an atom, byte kk % 128 in it (a
            // multiple of 32); descriptors count 16-byte units.
            const int kk = (di * kK + dj) * a.cin + c_off + 32 * q;
            wg::mma_rs_s8<kWgN>(
                acc, f[dj][q],
                desc0 + static_cast<uint64_t>((kk >> 7) * (kWgN * 8) +
                                              ((kk & 127) >> 4)),
                1);
          }
        }
        wg::commit();
        if (di + 1 < kK) {
          wg::wait<1>();  // the row before has retired
          if (di > 0) keep_live(frag[(di - 1) & 1]);
        }
      }
    }
    pass_turn(group);  // the step's products are issued: the other's turn
    // The last two rows retire before anything takes their buffers.
    wg::wait<0>();
    keep_live(frag[0]);
    keep_live(frag[1]);

    if (s % channel_steps == channel_steps - 1) {
      wg::fence_operand(acc);
      const int i = cur.ty * kWarpRows + own_i;
      const int j = cur.tx * 4 * kWarpCols + own_j;
      const bool inside = cur.b < a.batch && i < a.hp && j < a.wp;
      unsigned* word = reinterpret_cast<unsigned*>(
          out + ((static_cast<int64_t>(cur.b) * a.hp + i) * a.wp + j) *
                    a.cout + n0 + lane_channel);
      pool_store(acc, inside, word, a.cout - n0 - lane_channel, lane,
                     s_mb, a.scale);
      cur.step(a);
    }
    warpgroup_sync(group);  // this stage may now take the step after next
  }
  if (group == 0) await_turn(group);  // warpgroup 1's last hand-over
}

template <int kCk, int kWarpCols>
cudaError_t launch_wgmma(const int8_t* x, const int8_t* w, const float* mult,
                         const float* bias, int8_t* out, const WgArgs& a,
                         int blocks, int shared, cudaStream_t stream) {
  // A stage holds the window stage_window writes.
  if (a.stage_bytes < (2 * (4 / kWarpCols) + kK - 1) *
                          (8 * kWarpCols + kK - 1) * (kCk + kPad))
    return cudaErrorInvalidValue;
  auto kernel = conv_relu_pool_int8_wgmma_kernel<kCk, kWarpCols>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  // The plan's blocks a slice, and no more than its tiles need (two a
  // block step).
  const int64_t tiles = static_cast<int64_t>(a.batch) * a.tiles_y * a.tiles_x;
  int64_t per_slice = blocks;
  if (per_slice > (tiles + kWarpgroups - 1) / kWarpgroups)
    per_slice = (tiles + kWarpgroups - 1) / kWarpgroups;
  const unsigned grid = static_cast<unsigned>(per_slice * (a.cout_pad / kWgN));
  kernel<<<grid, kWgBlockThreads, shared, stream>>>(x, w, mult, bias, out, a);
  return cudaGetLastError();
}

template <int kCk>
cudaError_t launch_wgmma_cols(int warp_cols, const int8_t* x, const int8_t* w,
                              const float* mult, const float* bias,
                              int8_t* out, const WgArgs& a, int blocks,
                              int shared, cudaStream_t stream) {
  switch (warp_cols) {
    case 1:
      return launch_wgmma<kCk, 1>(x, w, mult, bias, out, a, blocks,
                                      shared, stream);
    case 2:
      return launch_wgmma<kCk, 2>(x, w, mult, bias, out, a, blocks,
                                      shared, stream);
    default:
      return launch_wgmma<kCk, 4>(x, w, mult, bias, out, a, blocks,
                                      shared, stream);
  }
}

cudaError_t launch_wgmma_n(int ck, int warp_cols, const int8_t* x,
                           const int8_t* w, const float* mult,
                           const float* bias, int8_t* out, const WgArgs& a,
                           int blocks, int shared, cudaStream_t stream) {
  switch (ck) {
    case 128:
      return launch_wgmma_cols<128>(warp_cols, x, w, mult, bias, out, a,
                                          blocks, shared, stream);
    case 64:
      return launch_wgmma_cols<64>(warp_cols, x, w, mult, bias, out, a,
                                         blocks, shared, stream);
    default:
      return launch_wgmma_cols<32>(warp_cols, x, w, mult, bias, out, a,
                                         blocks, shared, stream);
  }
}

}  // namespace

// x int8 [B, H, W, Cin] (Cin a multiple of 4, 4-byte aligned), mult and
// bias f32 [Cout], out int8 [B, Hp, Wp, Cout], and the plan of
// ops/conv_int8.py::w8a8_plan (WgmmaPlan.c_args or MmaSyncPlan.c_args):
// kind 1, the wgmma kernel: wpack packed by pack_int8_weight_wgmma,
// [atoms][Cout padded to channels][128]; warp rows and columns of a tile,
// channels a block, ck input channels a stage, tiles of an image down and
// across, atoms, bytes a stage, blocks a slice (the persistent grid),
// shared bytes. Kind 0, the mma.sync kernel: wpack packed by
// pack_int8_weight, [Cout padded to 128 / 8][k * k * Cin_pad / 32][32
// lanes][8 bytes]; bytes a staged pixel and shared bytes (the other
// fields 0). The plan is taken as it is: the entry checks only that the
// named kernel takes the shape and that its accesses stay within the
// tensors and the shared memory, and returns cudaErrorInvalidValue where
// not.
extern "C" int vqa_conv_relu_pool_int8(
    const void* x, const void* wpack, const void* mult, const void* bias,
    void* out, int batch, int h, int w, int cin, int cout, int k, int stride,
    float scale, int kind, int warp_rows, int warp_cols, int channels, int ck,
    int tiles_y, int tiles_x, int atoms, int stage_bytes, int pixel_bytes,
    int blocks, int shared, void* stream) {
  if (cin < 4 || cin % 4 || cout < 1 || k < 1 || stride < 1 || h < k ||
      w < k || batch < 0 || shared < 0 || shared > kMaxShared)
    return cudaErrorInvalidValue;
  const int hp = ((h - k) / stride + 1) / 2;
  const int wp = ((w - k) / stride + 1) / 2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const float* fm = static_cast<const float*>(mult);
  const float* fb = static_cast<const float*>(bias);
  int8_t* o = static_cast<int8_t*>(out);

  if (kind == 1) {
    // The kernel's own constants and the template instances it has; the
    // plan's tiles cover the output; its K atoms hold the k * k * Cin
    // bytes the products read; its regions fit the block's shared memory
    // (launch_wgmma checks a stage against the window it stages).
    if (stride != 1 || k != kK || cin % 32 || cout % 4 ||
        channels != kWgN || (ck != 32 && ck != 64 && ck != 128) ||
        cin % ck || blocks < 1 || warp_rows * warp_cols != 4 ||
        (warp_cols != 1 && warp_cols != 2 && warp_cols != 4) ||
        static_cast<int64_t>(tiles_y) * warp_rows < hp ||
        static_cast<int64_t>(tiles_x) * 4 * warp_cols < wp ||
        static_cast<int64_t>(batch) * tiles_y * tiles_x > INT32_MAX ||
        static_cast<int64_t>(atoms) * 128 < k * k * cin || atoms < 1 ||
        stage_bytes < 1 || stage_bytes % 16 ||
        static_cast<int64_t>(atoms) * kWgN * 128 +
                2 * kWarpgroups * static_cast<int64_t>(stage_bytes) +
                kWgN * 8 + wg::kAtomBytes > shared)
      return cudaErrorInvalidValue;
    WgArgs a;
    a.batch = batch; a.h = h; a.wd = w; a.cin = cin; a.cout = cout;
    a.hp = hp;
    a.wp = wp;
    a.tiles_y = tiles_y;
    a.tiles_x = tiles_x;
    a.atoms = atoms;
    a.cout_pad = (cout + kWgN - 1) / kWgN * kWgN;
    a.stage_bytes = stage_bytes;
    a.weight_bytes = atoms * kWgN * 128;
    a.scale = scale;
    if (batch == 0 || hp == 0 || wp == 0) return cudaSuccess;
    const int8_t* wq = static_cast<const int8_t*>(wpack);
    return launch_wgmma_n(ck, warp_cols, xq, wq, fm, fb, o, a, blocks, shared,
                          st);
  }
  if (kind != 0 || pixel_bytes % 4) return cudaErrorInvalidValue;
  Shape s;
  s.h = h; s.w = w; s.cin = cin; s.cout = cout; s.k = k; s.stride = stride;
  s.hp = hp;
  s.wp = wp;
  s.cin_words = (cin + 31) / 32 * 8;
  s.pw = pixel_bytes / 4;
  s.ksteps = k * k * s.cin_words / 8;
  if (s.pw < s.cin_words ||
      static_cast<int64_t>(stride + k) * w * pixel_bytes > shared ||
      static_cast<int64_t>(batch) * hp > INT32_MAX)
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(batch) * hp == 0 || wp == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      conv_relu_pool_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * hp),
                  static_cast<unsigned>((cout + kBlockN - 1) / kBlockN));
  conv_relu_pool_int8_kernel<<<grid, kMmaThreads, shared, st>>>(
      xq, static_cast<const uint2*>(wpack), fm, fb, o, s, scale);
  return cudaGetLastError();
}
