// Small-Cin stem block: conv + bias + ReLU + 2x2 max pool with no conv output
// in device memory (kernel 7 of the port).
//
// Replaces dl_vqa_tpu/ops/conv_fused.py::_stem_kernel with the patch
// extraction and the 4-phase weight of ::conv_relu_pool_stem around it. Those
// were how the TPU's matrix unit was fed: every pooled output gathers its
// (k + 1)^2 window into a patch row, and one product against a weight that
// holds the filter at its four shifts (zeros elsewhere) gives the four conv
// positions side by side. What is computed is
//   out[b, i, j, n] = cast(relu(max over the four conv positions of the
//                     window at (2i, 2j) of f32(conv(x, w)) + bias[n]))
// with products of operands rounded to x's type and f32 sums: no patch
// tensor, no zero taps, and the unpooled conv output (3.2 GB in bf16 at
// batch 512, which the unfused path writes and reads back) never exists.
//
// What bounds it on this card: memory traffic. conv0 at batch 512 reads a
// 0.15 GB image batch and writes 0.81 GB of pooled output in bf16 (0.29 ms
// at 3.35 TB/s); its 87 GFLOP take 0.09 ms at the tensor cores' bf16 rate,
// but 1.3 ms at the 67 TFLOP/s of the f32 units.
//
// bf16 (stem_mma_kernel below; stem_mma_path is the rule, which
// ops/conv_fused.py::stem_mma_path mirrors): an implicit GEMM on
// mma.sync.m16n8k16. M is a tile's conv positions, N the output channels
// (64 a block at most), K = k * k * Cin ordered (di, dj, ci) and padded
// with zero weights to a multiple of 16 (the RGB stem: 27 -> 32, two k
// steps), so that one filter row's taps are one run of k * Cin values of
// the NHWC image. The wrapper packs the weights once a call as the
// [K_pad, Cout] matrix in the order of mma's B fragments (a lane's two
// registers for each k step and 8 channels lie side by side;
// ops/conv_fused.py::pack_stem_weight); a block copies its channels' part
// to shared memory once, and for the stem every lane holds its fragments
// in registers. A block of 8 warps makes tiles of 28 x 16 pool windows,
// walked by a persistent grid, two blocks an SM. A tile's input window
// (58 x 34 pixels for the stem, 12 KB) arrives by cp.async in 16-byte
// pieces, the next tile's while this one computes. Where every image row
// is a whole number of pieces (the stem's 224 x 3 values), the window is
// read where its pieces land, from three stages, with one block barrier a
// tile; else each row is first realigned to a fixed layout (a row of
// 3-channel pixels may start on any 2-byte boundary). A warp makes 8
// windows of one pooled row at a time, 7 rows a tile: its two m16 tiles
// are the windows' two conv rows, and in each, rows r and r + 8 are the
// two conv columns of window r, so a lane's accumulators hold all four
// positions of its windows for two channels: max, bias, ReLU and the one
// rounding happen in registers. Each lane gathers its A fragments
// straight from the window (a k value's offset in it depends on the
// lane's column of the fragment only, so each lane's offsets are computed
// once). The pooled outputs are staged in shared memory and leave as
// 16-byte streaming stores, each warp's 8 windows one run of memory.
// Measured and dropped (H100, B = 512): tiles of 4 and 8 rows (1.05 and
// 0.85 ms against 0.58 at 28; 16 rows 0.61), realigning aligned rows too
// (0.71 against 0.61 at 16 rows), three blocks an SM with the channels in
// two passes of the products (no faster: occupancy does not bound it), and
// the stem's shape on the general kernel, offsets and weights read from
// shared memory each k step (0.74 against 0.58).
//
// f32, and bf16 shapes the rule refuses (Cout no multiple of 8, K over
// 96, a filter row over 16 values), run on the f32 FMA units (conv_pool_direct.cuh, which kernel 6's
// f32 path shares).

#include "conv_pool_direct.cuh"

#include "mma_sync.cuh"

namespace {

constexpr int kStemThreads = 256;  // 8 warps
constexpr int kStemWarpRows = 7;   // pooled rows a warp makes a tile
constexpr int kStemTileRows = 4 * kStemWarpRows;  // pool windows, down
constexpr int kStemTileCols = 16;  // and across: a warp's rows 8 wide
constexpr int kStemMaxKSteps = 6;  // K_pad <= 96
// A filter row's taps (k * Cin values) at most one k step: the three
// stages of a window then take under 180 KB of shared memory.
constexpr int kStemMaxRowTaps = 16;
constexpr int kStemMaxShared = 232448;  // bytes a block may have on sm_90
constexpr int kStemBlocksPerSm = 2;
constexpr int kStemOutPad = 8;     // values after each staged output row

struct StemPlan {
  int nt;      // 8-channel tiles a block: 1, 2, 4 or 8
  int ksteps;  // K_pad / 16
  int wrows;   // window rows: 2 * kStemTileRows + k - 1
  int slot;    // bytes of a row as it arrives (16-byte pieces)
  // Where every row starts at the same byte of a 16-byte piece (a row of
  // the image is a whole number of pieces), the kernel reads the window
  // where its pieces land (`lead` bytes into each slot), from three
  // stages; else it realigns each row to `rowe` values first (two stages
  // and the realigned window).
  bool direct;
  int lead;
  int rowe;    // values from one window row to the next, as it is read
  int w_off, koff_off, raw_off, win_off, out_off;  // shared-memory layout
  int shared;  // bytes
};

int round_up(int x, int to) { return (x + to - 1) / to * to; }

bool stem_mma_plan(int cin, int cout, int k, int dtype, StemPlan* p) {
  if (dtype != vqa::kBFloat16 || k < 1 || cin < 1 || cout < 8 || cout % 8)
    return false;
  const int kk = k * k * cin;
  p->ksteps = (kk + 15) / 16;
  if (p->ksteps > kStemMaxKSteps || k * cin > kStemMaxRowTaps) return false;
  p->nt = cout % 64 == 0 ? 8 : cout % 32 == 0 ? 4 : cout % 16 == 0 ? 2 : 1;
  p->wrows = 2 * kStemTileRows + k - 1;
  const int run = (2 * kStemTileCols + k - 1) * cin;  // values a row
  // A row's 16-byte pieces start up to 15 bytes early; the realignment
  // reads one word past the run.
  p->slot = round_up(2 * run + 20, 16);
  return true;
}

// The layout for an image `x` of rows of `wd` pixels.
void stem_layout(const void* x, int wd, int cin, int k, StemPlan* p) {
  p->direct = wd * cin * 2 % 16 == 0;
  p->lead = static_cast<int>(reinterpret_cast<uintptr_t>(x) & 15);
  p->rowe = p->direct ? p->slot / 2
                      : round_up((2 * kStemTileCols + k - 1) * cin, 2);
  p->w_off = 0;
  p->koff_off = p->w_off + p->ksteps * p->nt * 32 * 8;
  p->raw_off = round_up(p->koff_off + p->ksteps * 16 * 4, 16);
  p->win_off = p->raw_off + (p->direct ? 3 : 2) * p->wrows * p->slot;
  p->out_off = round_up(
      p->win_off + (p->direct ? 0 : p->wrows * p->rowe * 2), 16);
  p->shared = p->out_off +
              (kStemThreads / 32) * 8 * (p->nt * 8 + kStemOutPad) * 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

struct StemArgs {
  const __nv_bfloat16* x;    // [B, H, W, Cin]
  const uint2* w;            // [ksteps, Cout / 8, 32] fragment pairs
  const float* bias;         // [Cout]
  __nv_bfloat16* out;        // [B, Hp, Wp, Cout]
  int h, wd, cin, cout, k, hp, wp, tiles_y, tiles_x, tiles;
  StemPlan plan;
};

struct StemTile {
  int b, i0, j0;
};

__device__ __forceinline__ StemTile stem_tile(const StemArgs& a, int tile) {
  const int per_image = a.tiles_y * a.tiles_x;
  const int b = tile / per_image, rest = tile - b * per_image;
  const int ty = rest / a.tiles_x;
  return {b, ty * kStemTileRows, (rest - ty * a.tiles_x) * kStemTileCols};
}

// The first value of window row r (image row y0 + r from column x0).
__device__ __forceinline__ const __nv_bfloat16* stem_row(const StemArgs& a,
                                                         StemTile t, int r) {
  return a.x + ((static_cast<int64_t>(t.b) * a.h + 2 * t.i0 + r) * a.wd +
                2 * t.j0) * a.cin;
}

__device__ __forceinline__ int stem_rows_here(const StemArgs& a, StemTile t) {
  return min(a.plan.wrows, a.h - 2 * t.i0);
}
__device__ __forceinline__ int stem_run_here(const StemArgs& a, StemTile t) {
  return min(2 * kStemTileCols + a.k - 1, a.wd - 2 * t.j0) * a.cin;
}

// Every 16-byte piece that holds a value of the tile's window rows, into
// `raw` (one slot a row); the rows and columns past the image stay out.
__device__ __forceinline__ void stem_issue(const StemArgs& a, int tile,
                                           unsigned char* raw) {
  const StemTile t = stem_tile(a, tile);
  const int rows = stem_rows_here(a, t), bytes = 2 * stem_run_here(a, t);
  const int pieces = a.plan.slot / 16;
  for (int e = threadIdx.x; e < rows * pieces; e += kStemThreads) {
    const int r = e / pieces, c = e - r * pieces;
    const uintptr_t src = reinterpret_cast<uintptr_t>(stem_row(a, t, r));
    if (c * 16 < static_cast<int>(src & 15) + bytes)
      cp_async16(raw + r * a.plan.slot + c * 16,
                 reinterpret_cast<const void*>((src & ~uintptr_t{15}) +
                                               c * 16));
  }
}

// raw -> win: row r's values from where its pieces put them to r * rowe.
__device__ __forceinline__ void stem_realign(const StemArgs& a, int tile,
                                             const unsigned char* raw,
                                             unsigned* win) {
  const StemTile t = stem_tile(a, tile);
  const int rows = stem_rows_here(a, t);
  const int words = (stem_run_here(a, t) + 1) / 2, row_words = a.plan.rowe / 2;
  for (int e = threadIdx.x; e < rows * words; e += kStemThreads) {
    const int r = e / words, wi = e - r * words;
    const int lead = static_cast<int>(
        reinterpret_cast<uintptr_t>(stem_row(a, t, r)) & 15);
    const int o = r * a.plan.slot + lead + 4 * wi;
    const unsigned* src = reinterpret_cast<const unsigned*>(raw + (o & ~3));
    win[r * row_words + wi] = o & 2 ? __byte_perm(src[0], src[1], 0x5432)
                                    : src[0];
  }
}

// kNt 8-channel tiles a block; kKs k steps, or 0 for the plan's at run
// time (offsets and weights then read from shared memory each step).
template <int kNt, int kKs>
__global__ void __launch_bounds__(kStemThreads, kStemBlocksPerSm)
stem_mma_kernel(const __grid_constant__ StemArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StemPlan& p = a.plan;
  uint2* w_s = reinterpret_cast<uint2*>(smem + p.w_off);
  int* koff_s = reinterpret_cast<int*>(smem + p.koff_off);
  unsigned char* raw_s = smem + p.raw_off;
  unsigned* win_s = reinterpret_cast<unsigned*>(smem + p.win_off);
  const int ksteps = kKs ? kKs : p.ksteps;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.y * kNt * 8;
  const int out_pitch = kNt * 8 + kStemOutPad;  // values
  unsigned* out_s = reinterpret_cast<unsigned*>(smem + p.out_off) +
                    warp * 8 * out_pitch / 2;

  int tile = blockIdx.x;
  if (tile < a.tiles) stem_issue(a, tile, raw_s);
  cp_async_commit();
  // The block's weights, and each k's offset in a window (-1: padding).
  const int tiles_n = a.cout / 8;
  for (int e = tid; e < ksteps * kNt * 32; e += kStemThreads) {
    const int s = e / (kNt * 32), rest = e - s * kNt * 32;
    w_s[e] = a.w[(s * tiles_n + blockIdx.y * kNt) * 32 + rest];
  }
  const int taps_row = a.k * a.cin;
  for (int kk = tid; kk < ksteps * 16; kk += kStemThreads)
    koff_s[kk] = kk < a.k * taps_row
                     ? kk / taps_row * p.rowe + kk % taps_row : -1;
  __syncthreads();

  const int gq = lane / 4, t = lane % 4;
  float bias_v[kNt][2];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    bias_v[nt][0] = a.bias[n0 + nt * 8 + 2 * t];
    bias_v[nt][1] = a.bias[n0 + nt * 8 + 2 * t + 1];
  }
  // With the k steps known, each lane's offsets and B fragments stay in
  // registers.
  constexpr int kHeld = kKs ? kKs : 1;
  uint2 b_r[kHeld][kNt];
  int off_r[kHeld][4];
  if (kKs) {
#pragma unroll
    for (int s = 0; s < kHeld; ++s) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
        b_r[s][nt] = w_s[(s * kNt + nt) * 32 + lane];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        off_r[s][q] = koff_s[s * 16 + 2 * t + (q & 1) + (q & 2) * 4];
    }
  }
  const int pc = warp % 2 * 8 + gq;  // the lane's window column
  const int stages = p.direct ? 3 : 2;
  const int first = p.direct ? p.lead / 2 : 0;  // row 0's first value

  for (int it = 0; tile < a.tiles; tile += gridDim.x, ++it) {
    // The next tile's pieces go to the stage read two tiles ago (direct)
    // or realigned one tile ago: every thread is past that since the
    // barrier below, in the last step.
    const int next = tile + gridDim.x;
    if (next < a.tiles)
      stem_issue(a, next, raw_s + (it + 1) % stages * p.wrows * p.slot);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // this tile's pieces have landed
    const unsigned char* stage = raw_s + it % stages * p.wrows * p.slot;
    if (!p.direct) {
      stem_realign(a, tile, stage, win_s);
      __syncthreads();
    }
    const unsigned short* win16 = reinterpret_cast<const unsigned short*>(
        p.direct ? stage : reinterpret_cast<const unsigned char*>(win_s));

    const StemTile tt = stem_tile(a, tile);
#pragma unroll 1
    for (int sub = 0; sub < kStemWarpRows; ++sub) {
      const int pr = 4 * sub + warp / 2;  // the lane's window row
      int base[2][2];  // [conv row][conv column] of the window, in `win`
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          base[mt][c] =
              first + (2 * pr + mt) * p.rowe + (2 * pc + c) * a.cin;
      float acc[2][kNt][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;
#pragma unroll
      for (int s = 0; s < ksteps; ++s) {
        int off[4];
        uint2 bf[kNt];
        if (kKs) {
#pragma unroll
          for (int q = 0; q < 4; ++q) off[q] = off_r[kKs ? s : 0][q];
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) bf[nt] = b_r[kKs ? s : 0][nt];
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            off[q] = koff_s[s * 16 + 2 * t + (q & 1) + (q & 2) * 4];
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
            bf[nt] = w_s[(s * kNt + nt) * 32 + lane];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // a[0], a[1]: k = 2t, 2t + 1 of rows gq (column 0) and gq + 8
          // (column 1); a[2], a[3]: the same at k + 8.
          unsigned af[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int at = base[mt][r & 1], q = r & 2;
            const unsigned lo = off[q] >= 0 ? win16[at + off[q]] : 0u;
            const unsigned hi =
                off[q + 1] >= 0 ? win16[at + off[q + 1]] : 0u;
            af[r] = lo | hi << 16;
          }
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
            vqa::mma_bf16(acc[mt][nt], af, bf[nt].x, bf[nt].y);
        }
      }

      // The window's four positions: rows gq, gq + 8 of both m tiles.
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float m = fmaxf(fmaxf(acc[0][nt][c], acc[0][nt][c + 2]),
                                fmaxf(acc[1][nt][c], acc[1][nt][c + 2]));
          v[c] = fmaxf(m + bias_v[nt][c], 0.0f);
        }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v[0], v[1]);
        out_s[gq * out_pitch / 2 + nt * 4 + t] =
            *reinterpret_cast<const unsigned*>(&pair);
      }
      __syncwarp();
      const int i = tt.i0 + pr;
      for (int e = lane; e < 8 * kNt; e += 32) {
        const int r = e / kNt, c = e - r * kNt;
        const int j = tt.j0 + warp % 2 * 8 + r;
        if (i < a.hp && j < a.wp)
          __stcs(reinterpret_cast<uint4*>(
                     a.out + ((static_cast<int64_t>(tt.b) * a.hp + i) *
                                  a.wp + j) * a.cout + n0 + c * 8),
                 *reinterpret_cast<const uint4*>(out_s + r * out_pitch / 2 +
                                                 c * 4));
      }
      __syncwarp();
    }
  }
  cp_async_wait_one();  // nothing stays in flight past the block's end
}

template <int kNt, int kKs>
cudaError_t launch_stem(const StemArgs& a, cudaStream_t stream) {
  auto kernel = stem_mma_kernel<kNt, kKs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.plan.shared);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int groups = a.cout / (kNt * 8);
  int blocks = sms * kStemBlocksPerSm / groups;
  if (blocks < 1) blocks = 1;
  if (blocks > a.tiles) blocks = a.tiles;
  kernel<<<dim3(blocks, groups), kStemThreads, a.plan.shared, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run_stem_mma(const void* x, const void* w, const float* bias,
                         void* out, int batch, int h, int wd, int cin,
                         int cout, int k, const StemPlan& plan,
                         cudaStream_t stream) {
  StemArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const uint2*>(w);
  a.bias = bias;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.h = h, a.wd = wd, a.cin = cin, a.cout = cout, a.k = k;
  a.hp = (h - k + 1) / 2, a.wp = (wd - k + 1) / 2;
  if (batch <= 0 || a.hp <= 0 || a.wp <= 0) return cudaSuccess;
  a.tiles_y = (a.hp + kStemTileRows - 1) / kStemTileRows;
  a.tiles_x = (a.wp + kStemTileCols - 1) / kStemTileCols;
  const int64_t tiles = static_cast<int64_t>(batch) * a.tiles_y * a.tiles_x;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  a.tiles = static_cast<int>(tiles);
  a.plan = plan;
  stem_layout(x, wd, cin, k, &a.plan);
  if (a.plan.shared > kStemMaxShared) return cudaErrorInvalidValue;
  // The RGB stem's shape (k = 3, Cin = 3, 64 channels a block) holds its
  // offsets and weights in registers.
  if (plan.nt == 8 && plan.ksteps == 2)
    return launch_stem<8, 2>(a, stream);
  switch (plan.nt) {
    case 8: return launch_stem<8, 0>(a, stream);
    case 4: return launch_stem<4, 0>(a, stream);
    case 2: return launch_stem<2, 0>(a, stream);
    default: return launch_stem<1, 0>(a, stream);
  }
}

}  // namespace

// 1 where a call of these shapes and type runs the tensor-core kernel (and
// takes its weights packed by ops/conv_fused.py::pack_stem_weight), 0 where
// it runs on the FMA units (weights f32 [k, k, Cin, Cout]).
extern "C" int vqa_conv_relu_pool_stem_mma(int cin, int cout, int k,
                                           int dtype) {
  StemPlan plan;
  return stem_mma_plan(cin, cout, k, dtype, &plan) ? 1 : 0;
}

// x [B, H, W, Cin], bias [Cout] f32 -> out [B, (H - k + 1) / 2,
// (W - k + 1) / 2, Cout]; w as vqa_conv_relu_pool_stem_mma says.
extern "C" int vqa_conv_relu_pool_stem(const void* x, const void* w,
                                       const void* bias, void* out, int batch,
                                       int h, int wd, int cin, int cout, int k,
                                       int dtype, void* stream) {
  const float* bf = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  StemPlan plan;
  if (stem_mma_plan(cin, cout, k, dtype, &plan))
    return run_stem_mma(x, w, bf, out, batch, h, wd, cin, cout, k, plan, s);
  const float* wf = static_cast<const float*>(w);
  switch (dtype) {
    case vqa::kBFloat16:
      return vqa_conv::run_direct<__nv_bfloat16>(x, wf, bf, out, batch, h, wd,
                                                 cin, cout, k, s);
    case vqa::kFloat32:
      return vqa_conv::run_direct<float>(x, wf, bf, out, batch, h, wd, cin,
                                         cout, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}
