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
// product), so a padded step hands (dh, dc) on unchanged and writes zeros.
//
// Bound by memory traffic: it reads 4H gates and two carries per (b) row
// and writes 4H dgates, about 60 MB a step at batch 512, H = 1024, two
// directions. One thread per (d, b, j), j fastest, so every load and store
// of a warp is contiguous; one launch covers both directions.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
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
  const int64_t step = (d * seq_len + t) * batch + b;  // row of [D, T, B]
  const float* gates = gates_all + step * 4 * hidden;
  float* dgates = dgates_all + step * 4 * hidden;

  const float keep = t < lengths[b] ? 1.0f : 0.0f;
  const float i = sigmoid(gates[j]);
  const float f = sigmoid(gates[hidden + j]);
  const float g = tanhf(gates[2 * hidden + j]);
  const float o = sigmoid(gates[3 * hidden + j]);
  const float c_t = c_all[step * hidden + j];
  // The carry before step t: c_all[t - 1], zeros before the first step.
  const float c_prev =
      t > 0 ? c_all[(step - batch) * hidden + j] : 0.0f;
  const float tanh_c = tanhf(c_t);
  const float dh_in = dh[at];
  const float dc_in = dc[at];
  const float dh_eff = dh_in * keep;
  const float dc_tot = dc_in * keep + dh_eff * o * (1.0f - tanh_c * tanh_c);
  dgates[j] = dc_tot * g * i * (1.0f - i);
  dgates[hidden + j] = dc_tot * c_prev * f * (1.0f - f);
  dgates[2 * hidden + j] = dc_tot * i * (1.0f - g * g);
  dgates[3 * hidden + j] = dh_eff * tanh_c * o * (1.0f - o);
  dc[at] = (1.0f - keep) * dc_in + dc_tot * f;
  dh[at] = (1.0f - keep) * dh_in;
}

}  // namespace

extern "C" int vqa_lstm_backward_step(const void* gates_all, const void* c_all,
                                      const void* lengths, void* dh, void* dc,
                                      void* dgates_all, int directions,
                                      int seq_len, int batch, int hidden,
                                      int t, void* stream) {
  const int64_t total = static_cast<int64_t>(directions) * batch * hidden;
  if (total == 0) return cudaSuccess;
  if (t < 0 || t >= seq_len) return cudaErrorInvalidValue;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  lstm_backward_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gates_all), static_cast<const float*>(c_all),
      static_cast<const int*>(lengths), static_cast<float*>(dh),
      static_cast<float*>(dc), static_cast<float*>(dgates_all), seq_len,
      batch, hidden, t, total);
  return cudaGetLastError();
}
