// The LSTM gates of the recurrent policy's BPTT unroll for Hopper (sm_90a):
// one launch a timestep forward (dwbc_lstm_forward) and one backward
// (dwbc_lstm_backward), each serving both memories (actor and critic).
//
// Replaces no TPU kernel: the JAX package's unroll is a `scan` of flax's
// OptimizedLSTMCell that XLA fuses (dwbc_tpu/models/actor_critic_recurrent
// .py). In eager PyTorch each step of the unroll ran the done mask, each
// memory's two linears, a chunk and ~9 elementwise gate ops and both MLP
// heads, ~44 forward ops and as many autograd nodes a step; at 24 steps x
// 20 minibatches an iteration those host launches held ~80% of the
// recurrent cell's iteration while the card idled. The unroll is now a
// sequence op (ops/lstm_kernel.py): the input projection and the heads run
// once over all T x B rows, and each step is one batched product h W_h^T
// for both memories plus one launch of this kernel; the backward one
// launch of the gate kernel plus one product dgates W_h. The plain PyTorch
// version it is held against is ops/lstm_kernel.py's forward_step and
// backward_step, the Python wrapper the same module.
//
// Layouts (float32, contiguous; M memories, T steps, B rows, H units; the
// gates in the order i, f, g, o along 4H, as the cell chunks them):
//   xproj, act, dxp        (M, T, B, 4H)  input projections with the hidden
//                                         side's bias; the gates after their
//                                         nonlinearities; their gradients
//   c, y, cm, hm           (M, T, B, H)   c_t and h_t of step t (y is the
//                                         unroll's output); the carry step t
//                                         reads, already masked by keep_t
//   hh                     (M, B, 4H)     h_masked_{t-1} W_h^T of step t
//   keep                   (T, B)         1 - dones_prev
//   dy                     (M, T, B, H)   gradient of y
//   dh_next, dc_next,
//   dc_prev                (M, B, H)      gradients of step t+1's carry
//                                         (hm, cm at t+1), of step t's (cm)
//
// Forward, per (memory, row, unit) of step t: the pre-activations xproj +
// hh, i = sigma, f = sigma, g = tanh, o = sigma, c_t = f c_{t-1} + i g,
// h_t = o tanh(c_t); it stores the gates and c_t for the backward pass,
// h_t as the output, and the carry of step t+1 multiplied by keep_{t+1}
// (the done mask that each eager step applied with two more ops a tensor).
// Backward, per the same element: the gradients of h_t (dy plus the next
// step's carry gradient through the mask) and of c_t, then of the four
// pre-activations and of c_{t-1}.
//
// Bound: elementwise, so bytes. Forward 17 floats an element (reads 4
// projections, 4 products and c_{t-1}; writes 4 gates, c_t, h_t and the
// masked carry pair), backward 14 (reads 4 gates, c_t, c_{t-1}, dy,
// dh_next and dc_next; writes 4 gate gradients and dc_prev), and keep a
// row (utils/measure.lstm_bytes): at 2 x 1,024 x 512 elements 71.3 MB and
// 58.7 MB, 21.3 us and 17.5 us at 3.35 TB/s; some 30 flops and 4-5
// transcendentals an element, far under the byte time. One thread an
// element, the unit index innermost, so each of a warp's loads and stores
// is one contiguous run; nothing is reused, so nothing is staged in shared
// memory.
//
// Numerics: built with -fmad=false, IEEE division, expf and tanhf with no
// fast-math, and every operation in the order the eager cell rounds it:
// sigma(x) = 1 / (1 + expf(-x)) and tanhf as ATen's CUDA sigmoid and tanh
// compute them, each product and sum rounded on its own as the cell's
// separate elementwise ops round them. The backward follows autograd's
// formulas (sigmoid: grad (1 - y) y; tanh: grad (1 - y y)).

#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256

namespace {

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
lstm_forward(const float* __restrict__ xproj, const float* __restrict__ hh,
             const float* __restrict__ keep, float* __restrict__ act,
             float* __restrict__ c, float* __restrict__ y,
             float* __restrict__ cm, float* __restrict__ hm, int t, int T,
             int B, int H, int M) {
  const uint32_t e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= (uint32_t)M * B * H) return;
  const uint32_t j = e % H, r = e / H;  // r: row of (M, B)
  const uint32_t b = r % B, m = r / B;
  const uint32_t s = (m * T + t) * B + b;  // row of (M, T, B)
  const uint32_t g4 = 4u * H;
  const float* xp = xproj + s * g4;
  const float* hp = hh + r * g4;
  const float i = sigmoid(xp[j] + hp[j]);
  const float f = sigmoid(xp[H + j] + hp[H + j]);
  const float g = tanhf(xp[2 * H + j] + hp[2 * H + j]);
  const float o = sigmoid(xp[3 * H + j] + hp[3 * H + j]);
  const float ct = f * cm[s * H + j] + i * g;
  const float ht = o * tanhf(ct);
  float* a = act + s * g4;
  a[j] = i;
  a[H + j] = f;
  a[2 * H + j] = g;
  a[3 * H + j] = o;
  c[s * H + j] = ct;
  y[s * H + j] = ht;
  if (t + 1 < T) {
    const float k = keep[(t + 1) * B + b];
    cm[(s + B) * H + j] = ct * k;
    hm[(s + B) * H + j] = ht * k;
  }
}

__global__ void __launch_bounds__(THREADS)
lstm_backward(const float* __restrict__ act, const float* __restrict__ c,
              const float* __restrict__ cm, const float* __restrict__ keep,
              const float* __restrict__ dy, const float* __restrict__ dh_next,
              const float* __restrict__ dc_next, float* __restrict__ dxp,
              float* __restrict__ dc_prev, int t, int T, int B, int H,
              int M) {
  const uint32_t e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= (uint32_t)M * B * H) return;
  const uint32_t j = e % H, r = e / H;
  const uint32_t b = r % B, m = r / B;
  const uint32_t s = (m * T + t) * B + b;
  const uint32_t g4 = 4u * H;
  const float* a = act + s * g4;
  const float i = a[j], f = a[H + j], g = a[2 * H + j], o = a[3 * H + j];
  // the gradients of h_t and c_t: the output's, and at t < T - 1 the next
  // step's carry's through its mask
  float dh = dy[s * H + j];
  float dc = dc_next[r * H + j];
  if (t + 1 < T) {
    const float k = keep[(t + 1) * B + b];
    dh = dh + dh_next[r * H + j] * k;
    dc = dc * k;
  }
  const float tc = tanhf(c[s * H + j]);
  const float d_o = dh * tc;
  dc = (dh * o) * (1.0f - tc * tc) + dc;
  const float d_i = dc * g, d_f = dc * cm[s * H + j], d_g = dc * i;
  float* d = dxp + s * g4;
  d[j] = d_i * (1.0f - i) * i;
  d[H + j] = d_f * (1.0f - f) * f;
  d[2 * H + j] = d_g * (1.0f - g * g);
  d[3 * H + j] = d_o * (1.0f - o) * o;
  dc_prev[r * H + j] = dc * f;
}

bool bad_shape(int t, int T, int B, int H, int M) {
  return T <= 0 || B <= 0 || H <= 0 || M <= 0 || t < 0 || t >= T ||
         4ull * M * T * B * H > UINT32_MAX;
}

unsigned blocks(int B, int H, int M) {
  return (unsigned)(((uint64_t)M * B * H + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// Step t of the forward pass on `stream`; returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous float32
// arrays of the layouts above.
int dwbc_lstm_forward(const float* xproj, const float* hh, const float* keep,
                      float* act, float* c, float* y, float* cm, float* hm,
                      int t, int T, int B, int H, int M, void* stream) {
  if (bad_shape(t, T, B, H, M)) return (int)cudaErrorInvalidValue;
  lstm_forward<<<blocks(B, H, M), THREADS, 0, (cudaStream_t)stream>>>(
      xproj, hh, keep, act, c, y, cm, hm, t, T, B, H, M);
  return (int)cudaGetLastError();
}

// Step t of the backward pass on `stream`; dh_next is null at t = T - 1,
// where dc_next is the gradient of the final c.
int dwbc_lstm_backward(const float* act, const float* c, const float* cm,
                       const float* keep, const float* dy,
                       const float* dh_next, const float* dc_next,
                       float* dxp, float* dc_prev, int t, int T, int B,
                       int H, int M, void* stream) {
  if (bad_shape(t, T, B, H, M) || (dh_next == nullptr) != (t == T - 1))
    return (int)cudaErrorInvalidValue;
  lstm_backward<<<blocks(B, H, M), THREADS, 0, (cudaStream_t)stream>>>(
      act, c, cm, keep, dy, dh_next, dc_next, dxp, dc_prev, t, T, B, H, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
