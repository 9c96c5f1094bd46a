// Four re-layouts of a [R, W, C] block (kernel 9 of the port).
//
// Replaces the case kernels that
// experiments/probe_mosaic_recheck.py::run_kernel compiles: the W-pair split max, the
// W-pair merge, the strided-slice max and the shifted concatenation. On the
// TPU each was a question to the compiler, whether it can re-tile a vector
// register whose two minor dimensions are (W, C); the conv0 pooling of the
// JAX package was shaped by the answers. This card has no tiled register
// layout: a thread addresses any element, so all four are index arithmetic
// on 16-byte vectors, and the only bound is the bytes moved (96 to 256 KB
// a case at the probe's shapes: the launch itself takes longer).
//
//   mode 0  out[r, j, :] = max(x[r, 2j, :], x[r, 2j + 1, :])     [R, W/2, C]
//   mode 1  out[r, j, :] = x[r, 2j, :] | x[r, 2j + 1, :]         [R, W/2, 2C]
//   mode 2  out = max(x[:, 0::2, :], x[:, 1::2, :])              [R, W/2, C]
//   mode 3  out[r, j, :] = x[r, (j + 1) mod W, :]                [R, W, C]
//
// Modes 0 and 2 are two spellings of one function and share a body; mode 1
// moves no element in row-major memory and is a copy. One thread makes one
// 16-byte vector of the output, channels fastest.
//
// So a case's time is its launch and its wrapper's host work: the one C
// entry, vqa_layout_cases, runs up to kMaxCases cases in one launch (a
// single case is a batch of one). Their descriptors (input, output, R, W,
// C, mode, type) travel by value as one kernel parameter, the grid is laid
// over (case, output vector), and a block finds its case in the prefix of
// the cases' block counts (ops/layout_cases.py::batched_plan mirrors it).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCases = 8;

template <typename T>
__device__ __forceinline__ uint4 max_vectors(uint4 a, uint4 b) {
  constexpr int kVec = 16 / sizeof(T);
  const T* pa = reinterpret_cast<const T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
  uint4 out;
  T* po = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    po[i] = vqa::to_float(pa[i]) >= vqa::to_float(pb[i]) ? pa[i] : pb[i];
  return out;
}

__host__ __device__ __forceinline__ int out_width(int width, int mode) {
  return mode == 0 || mode == 2 ? width / 2 : width;
}

// Output vector e of one case: x and out as arrays of 16-byte vectors, cv
// vectors a pixel.
template <typename T, int kMode>
__device__ __forceinline__ void layout_vector(const uint4* __restrict__ x,
                                              uint4* __restrict__ out,
                                              int width, int cv, int64_t e) {
  const int ow = out_width(width, kMode);
  const int v = static_cast<int>(e % cv);
  const int j = static_cast<int>((e / cv) % ow);
  const int64_t row = e / cv / ow * width;
  if (kMode == 0 || kMode == 2) {
    out[e] = max_vectors<T>(x[(row + 2 * j) * cv + v],
                            x[(row + 2 * j + 1) * cv + v]);
  } else if (kMode == 1) {
    // Out pixel j is pixels 2j and 2j + 1 side by side: vector e of the
    // output is vector e of the input.
    out[e] = x[e];
  } else {
    out[e] = x[(row + (j + 1 == width ? 0 : j + 1)) * cv + v];
  }
}

template <typename T>
__device__ __forceinline__ void layout_vector(const uint4* __restrict__ x,
                                              uint4* __restrict__ out,
                                              int width, int cv, int mode,
                                              int64_t e) {
  switch (mode) {
    case 0: layout_vector<T, 0>(x, out, width, cv, e); break;
    case 1: layout_vector<T, 1>(x, out, width, cv, e); break;
    case 2: layout_vector<T, 2>(x, out, width, cv, e); break;
    default: layout_vector<T, 3>(x, out, width, cv, e); break;
  }
}

struct Case {
  const uint4* x;
  uint4* out;
  int64_t vectors;  // output vectors
  int width, cv, mode, dtype;
  int first_block;  // blocks of the cases before this one
};

struct Cases {
  Case c[kMaxCases];
  int n;
};

__global__ void __launch_bounds__(kThreads)
layout_cases_kernel(const Cases cases) {
  // The last case that starts at or before this block (a case with no
  // block never is one), picked with constant indices so the descriptors
  // stay in the parameter bank.
  const int block = static_cast<int>(blockIdx.x);
  Case c = cases.c[0];
#pragma unroll
  for (int k = 1; k < kMaxCases; ++k)
    if (k < cases.n && block >= cases.c[k].first_block) c = cases.c[k];
  const int64_t e =
      static_cast<int64_t>(blockIdx.x - c.first_block) * kThreads +
      threadIdx.x;
  if (e >= c.vectors) return;
  if (c.dtype == vqa::kBFloat16)
    layout_vector<__nv_bfloat16>(c.x, c.out, c.width, c.cv, c.mode, e);
  else
    layout_vector<float>(c.x, c.out, c.width, c.cv, c.mode, e);
}

int element_bytes(int dtype) {
  switch (dtype) {
    case vqa::kBFloat16: return 2;
    case vqa::kFloat32: return 4;
    default: return 0;
  }
}

}  // namespace

// n cases (1 to kMaxCases) in one launch. `desc` is host memory, n rows of
// seven int64: x, out, R, W, C, mode, dtype code. Each case maps x [R, W, C]
// to out as its mode says, both of the type its code names; C a multiple
// of a 16-byte vector, W even for modes 0 to 2. Launches nothing where no
// case has an output.
extern "C" int vqa_layout_cases(const int64_t* desc, int n, void* stream) {
  if (n < 1 || n > kMaxCases) return cudaErrorInvalidValue;
  Cases cases{};
  cases.n = n;
  int64_t blocks = 0;
  for (int k = 0; k < n; ++k) {
    const int64_t* d = desc + 7 * k;
    const int rows = static_cast<int>(d[2]), width = static_cast<int>(d[3]);
    const int channels = static_cast<int>(d[4]), mode = static_cast<int>(d[5]);
    const int dtype = static_cast<int>(d[6]);
    const int elem = element_bytes(dtype);
    if (elem == 0 || mode < 0 || mode > 3 || rows < 0 || width < 0 ||
        channels < 0 || channels * elem % 16 ||
        (mode != 3 && width % 2))
      return cudaErrorInvalidValue;
    Case& c = cases.c[k];
    c.x = reinterpret_cast<const uint4*>(d[0]);
    c.out = reinterpret_cast<uint4*>(d[1]);
    c.width = width;
    c.cv = channels * elem / 16;
    c.mode = mode;
    c.dtype = dtype;
    c.vectors = static_cast<int64_t>(rows) * out_width(width, mode) * c.cv;
    c.first_block = static_cast<int>(blocks);
    blocks += (c.vectors + kThreads - 1) / kThreads;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  }
  if (blocks == 0) return cudaSuccess;
  layout_cases_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(cases);
  return cudaGetLastError();
}
