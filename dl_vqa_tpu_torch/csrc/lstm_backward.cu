// One reverse step of the LSTM backward from saved states (kernel B of the
// port).
//
// The body of dl_vqa_tpu/ops/lstm_pallas.py::_lstm_saved_state_bwd.step
// without its matrix product; the JAX package runs it as XLA ops inside a
// reverse lax.scan. Per step t, direction d, row b and unit j, with
// keep = t < len[b] and (i, f, g, o) the activated gates of step t:
//   dh_eff = keep * dh
//   dc_tot = keep * dc + dh_eff * o * (1 - tanh(c_t)^2)
//   dgates = [dc_tot * g * i * (1 - i), dc_tot * c_prev * f * (1 - f),
//             dc_tot * i * (1 - g^2),   dh_eff * tanh(c_t) * o * (1 - o)]
//   dc <- (1 - keep) * dc + dc_tot * f          (dc_prev)
//   dh <- (1 - keep) * dh                       (the part that passes a pad)
// The caller adds dgates . W_hh to dh between two launches (a plain matrix
// product), so a padded step (keep = 0) hands (dh, dc) on unchanged and
// writes zero dgates: a padded row reads nothing but len[b], writes its
// zeros and leaves dh and dc alone. A real row (keep = 1) rounds every
// product and sum once, in the order of the plain version
// (ops/lstm.py::lstm_backward_step_reference, one torch op each), by the
// _rn intrinsics, which the compiler never contracts into an FMA: the
// results equal the plain version's bits. The one difference is the sign
// of a zero: the plain version's 0 * dh and 0 * dc + x keep a -0 where this
// kernel writes +0 or x.
//
// Bound by memory traffic: a real row reads 4H gates, two carries and
// (dh, dc) and writes 4H dgates and (dh, dc); a padded row writes its 4H
// zeros. Two kernels, one chosen by a shape rule (vector_path below, which
// ops/lstm_cuda.py::backward_step_vector_path mirrors):
//
// The vector kernel, where H is a multiple of 4, the five f32 tensors sit
// on 16-byte boundaries (so every row does) and the threads fit 31 bits.
// One thread makes four consecutive units j of one (d, b) row: it issues
// its eight 16-byte loads (the gates i, f, g, o at j, H + j, 2H + j and
// 3H + j, c_t, c_prev, dh and dc) before it uses any, then writes four
// 16-byte dgates vectors, dh and dc. Threads run j fastest, so a warp's
// loads and stores are contiguous runs; at H = 1024 a block is one row,
// four blocks an SM. The gates (read once) and dgates (written once) go
// through the cache-streaming hints (__ldcs, __stcs), which leave the L2
// to what the next launch reads again: c_all[t - 1] (its c_t), dh and dc.
// On an H100 that took the 23 steps at B = 512 from 0.326 to 0.310 ms of
// device time (tools/compare_lstm.py, a CUDA graph's replay).
//
// The scalar kernel, every other shape: one thread per (d, b, j), 4-byte
// loads, the same arithmetic and the same padded-row rule.
//
// One launch covers both directions. Chaining the launches (programmatic
// dependent launch) hid the gaps between 23 steps run back to back, but
// in the backward each step follows a cuBLAS product, which lets no
// dependent launch start early: on an H100 it moved the whole backward
// from 9.313 to 9.273 ms (tools/compare_lstm.py), within its spread.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVectorFloats = 4;  // f32 units a thread of the vector kernel
constexpr int kVectorBlocksPerSm = 4;  // 54 registers a thread, no spill
constexpr int64_t kMaxVectorThreads = int64_t{1} << 31;

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

struct UnitGrad {
  float di, df, dg, dout, dc;
};

// One unit of a real row (keep = 1), each operation rounded once in the
// plain version's order.
__device__ __forceinline__ UnitGrad unit_backward(float gi, float gf,
                                                  float gg, float go,
                                                  float c_t, float c_prev,
                                                  float dh, float dc) {
  const float i = sigmoid(gi);
  const float f = sigmoid(gf);
  const float g = tanhf(gg);
  const float o = sigmoid(go);
  const float tanh_c = tanhf(c_t);
  const float dc_tot = __fadd_rn(
      dc, __fmul_rn(__fmul_rn(dh, o),
                    __fsub_rn(1.0f, __fmul_rn(tanh_c, tanh_c))));
  UnitGrad r;
  r.di = __fmul_rn(__fmul_rn(__fmul_rn(dc_tot, g), i), __fsub_rn(1.0f, i));
  r.df = __fmul_rn(__fmul_rn(__fmul_rn(dc_tot, c_prev), f),
                   __fsub_rn(1.0f, f));
  r.dg = __fmul_rn(__fmul_rn(dc_tot, i), __fsub_rn(1.0f, __fmul_rn(g, g)));
  r.dout = __fmul_rn(__fmul_rn(__fmul_rn(dh, tanh_c), o), __fsub_rn(1.0f, o));
  r.dc = __fmul_rn(dc_tot, f);
  return r;
}

__global__ void __launch_bounds__(kThreads, kVectorBlocksPerSm)
lstm_backward_step_vector_kernel(
    const float4* __restrict__ gates_all,  // [D,T,B,4H] as H/4 vectors a gate
    const float4* __restrict__ c_all,      // [D,T,B,H]
    const int* __restrict__ lengths,       // [B]
    float4* __restrict__ dh,               // [D,B,H]
    float4* __restrict__ dc,               // [D,B,H]
    float4* __restrict__ dgates_all,       // [D,T,B,4H]
    int seq_len, int batch, int hv, int t, int total) {
  const int at = blockIdx.x * kThreads + threadIdx.x;
  if (at >= total) return;  // total = D * B * H / 4
  const int v = at % hv;
  const int row = at / hv;  // d * B + b
  const int b = row % batch;
  const int d = row / batch;
  const int64_t step = (static_cast<int64_t>(d) * seq_len + t) * batch + b;
  float4* dgates = dgates_all + step * 4 * hv + v;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (t >= lengths[b]) {
    __stcs(dgates, zero);
    __stcs(dgates + hv, zero);
    __stcs(dgates + 2 * hv, zero);
    __stcs(dgates + 3 * hv, zero);
    return;
  }
  const float4* gates = gates_all + step * 4 * hv + v;
  const float4 gi = __ldcs(gates);
  const float4 gf = __ldcs(gates + hv);
  const float4 gg = __ldcs(gates + 2 * hv);
  const float4 go = __ldcs(gates + 3 * hv);
  const float4 c_t = c_all[step * hv + v];
  // The carry before step t: c_all[t - 1], zeros before the first step.
  const float4 c_prev = t > 0 ? c_all[(step - batch) * hv + v] : zero;
  const float4 dh_in = dh[at];
  const float4 dc_in = dc[at];

  const float* pi = reinterpret_cast<const float*>(&gi);
  const float* pf = reinterpret_cast<const float*>(&gf);
  const float* pg = reinterpret_cast<const float*>(&gg);
  const float* po = reinterpret_cast<const float*>(&go);
  const float* pc = reinterpret_cast<const float*>(&c_t);
  const float* pp = reinterpret_cast<const float*>(&c_prev);
  const float* ph = reinterpret_cast<const float*>(&dh_in);
  const float* pd = reinterpret_cast<const float*>(&dc_in);
  float4 out[5];
  float* di = reinterpret_cast<float*>(&out[0]);
  float* df = reinterpret_cast<float*>(&out[1]);
  float* dg = reinterpret_cast<float*>(&out[2]);
  float* dout = reinterpret_cast<float*>(&out[3]);
  float* dcn = reinterpret_cast<float*>(&out[4]);
#pragma unroll
  for (int k = 0; k < kVectorFloats; ++k) {
    const UnitGrad r =
        unit_backward(pi[k], pf[k], pg[k], po[k], pc[k], pp[k], ph[k], pd[k]);
    di[k] = r.di;
    df[k] = r.df;
    dg[k] = r.dg;
    dout[k] = r.dout;
    dcn[k] = r.dc;
  }
  __stcs(dgates, out[0]);
  __stcs(dgates + hv, out[1]);
  __stcs(dgates + 2 * hv, out[2]);
  __stcs(dgates + 3 * hv, out[3]);
  dc[at] = out[4];
  dh[at] = zero;
}

__global__ void __launch_bounds__(kThreads)
lstm_backward_step_kernel(const float* __restrict__ gates_all,  // [D,T,B,4H]
                          const float* __restrict__ c_all,      // [D,T,B,H]
                          const int* __restrict__ lengths,      // [B]
                          float* __restrict__ dh,               // [D,B,H]
                          float* __restrict__ dc,               // [D,B,H]
                          float* __restrict__ dgates_all,       // [D,T,B,4H]
                          int seq_len, int batch, int hidden, int t,
                          int64_t total) {
  const int64_t at = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= total) return;  // total = D * B * H
  const int j = static_cast<int>(at % hidden);
  const int64_t row = at / hidden;  // d * B + b
  const int b = static_cast<int>(row % batch);
  const int64_t d = row / batch;
  const int64_t step = (d * seq_len + t) * batch + b;
  float* dgates = dgates_all + step * 4 * hidden;
  if (t >= lengths[b]) {
    dgates[j] = 0.0f;
    dgates[hidden + j] = 0.0f;
    dgates[2 * hidden + j] = 0.0f;
    dgates[3 * hidden + j] = 0.0f;
    return;
  }
  const float* gates = gates_all + step * 4 * hidden;
  const UnitGrad r = unit_backward(
      gates[j], gates[hidden + j], gates[2 * hidden + j],
      gates[3 * hidden + j], c_all[step * hidden + j],
      t > 0 ? c_all[(step - batch) * hidden + j] : 0.0f, dh[at], dc[at]);
  dgates[j] = r.di;
  dgates[hidden + j] = r.df;
  dgates[2 * hidden + j] = r.dg;
  dgates[3 * hidden + j] = r.dout;
  dc[at] = r.dc;
  dh[at] = 0.0f;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (kVectorFloats * sizeof(float)) ==
         0;
}

bool vector_path(const void* gates_all, const void* c_all, const void* dh,
                 const void* dc, const void* dgates_all, int directions,
                 int batch, int hidden) {
  const int64_t threads = static_cast<int64_t>(directions) * batch *
                          (hidden / kVectorFloats);
  return hidden % kVectorFloats == 0 && threads < kMaxVectorThreads &&
         aligned(gates_all) && aligned(c_all) && aligned(dh) &&
         aligned(dc) && aligned(dgates_all);
}

}  // namespace

// 1 where a call with these tensors and sizes runs the vector kernel, else
// 0 (not an error).
extern "C" int vqa_lstm_backward_step_vector(const void* gates_all,
                                             const void* c_all,
                                             const void* dh, const void* dc,
                                             const void* dgates_all,
                                             int directions, int batch,
                                             int hidden) {
  return vector_path(gates_all, c_all, dh, dc, dgates_all, directions, batch,
                     hidden)
             ? 1
             : 0;
}

extern "C" int vqa_lstm_backward_step(const void* gates_all, const void* c_all,
                                      const void* lengths, void* dh, void* dc,
                                      void* dgates_all, int directions,
                                      int seq_len, int batch, int hidden,
                                      int t, void* stream) {
  const int64_t total = static_cast<int64_t>(directions) * batch * hidden;
  if (total == 0) return cudaSuccess;
  if (t < 0 || t >= seq_len) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector_path(gates_all, c_all, dh, dc, dgates_all, directions, batch,
                  hidden)) {
    const int64_t threads = total / kVectorFloats;
    lstm_backward_step_vector_kernel<<<
        static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
        0, s>>>(
        static_cast<const float4*>(gates_all),
        static_cast<const float4*>(c_all), static_cast<const int*>(lengths),
        static_cast<float4*>(dh), static_cast<float4*>(dc),
        static_cast<float4*>(dgates_all), seq_len, batch,
        hidden / kVectorFloats, t, static_cast<int>(threads));
    return cudaGetLastError();
  }
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  lstm_backward_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(gates_all), static_cast<const float*>(c_all),
      static_cast<const int*>(lengths), static_cast<float*>(dh),
      static_cast<float*>(dc), static_cast<float*>(dgates_all), seq_len,
      batch, hidden, t, total);
  return cudaGetLastError();
}
