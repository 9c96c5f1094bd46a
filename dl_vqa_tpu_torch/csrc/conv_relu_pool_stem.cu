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
// with products of operands rounded to x's type and f32 sums, and that is
// what conv_pool_direct.cuh computes from the image itself: no patch tensor,
// no zero taps.
//
// What bounds it on this card: memory traffic. conv0 at batch 512 reads a
// 0.15 GB image batch and writes 0.81 GB of pooled output in bf16 (0.29 ms at
// 3.35 TB/s); its 87 GFLOP are 0.09 ms at the tensor cores' rate but 1.3 ms
// at the 67 TFLOP/s of the f32 units, where this kernel does them:
// K = 27 is too short to feed the tensor cores without padding and an
// im2col in shared memory, which is the redesign. The unpooled conv output
// (3.2 GB in bf16, which the unfused path writes and reads back) never
// exists.

#include "conv_pool_direct.cuh"

// x [B, H, W, Cin], w [k, k, Cin, Cout] f32 (rounded to x's type),
// bias [Cout] f32 -> out [B, (H - k + 1) / 2, (W - k + 1) / 2, Cout].
extern "C" int vqa_conv_relu_pool_stem(const void* x, const void* w,
                                       const void* bias, void* out, int batch,
                                       int h, int wd, int cin, int cout, int k,
                                       int dtype, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
