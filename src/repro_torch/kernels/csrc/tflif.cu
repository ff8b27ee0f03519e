// TFLIF: bias add + LIF over T timesteps, spikes packed 8 per byte.
//
// Replaces the TPU kernel src/repro/kernels/tflif.py:tflif_fused.
// Per neuron and step: h = v + ((x + bias) - v) / tau; spike iff h >= v_th;
// hard reset. Bit j of group g is the spike at step 8g+j, and the membrane
// is carried across groups.
//
// Bound on this card: memory. Each neuron reads T f32 accumulators and
// writes ceil(T/8) bytes for about 5 flops a step, far below the ~20
// flop/byte where the H100's f32 units become the limit.
// Design: one thread per neuron with the membrane in a register over all T,
// neighbouring threads on neighbouring neurons so every load of x and
// store of the packed bytes coalesces. bias and v_th are vectors that
// repeat with their own period (the channel count), so the per-channel
// int8 scale fold never materializes an (M,) copy.
// Exactness: the IEEE round-to-nearest intrinsics keep the reference's op
// order and forbid contraction; __fdiv_rn is the correctly rounded divide.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void tflif_kernel(const float* __restrict__ x,
                             const float* __restrict__ bias,
                             long long bias_period,
                             const float* __restrict__ vth,
                             long long vth_period,
                             uint8_t* __restrict__ out,
                             int t_steps, long long m, float tau) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float b = bias[bias_period == 1 ? 0 : i % bias_period];
  const float th = vth[vth_period == 1 ? 0 : i % vth_period];
  float v = 0.f;
  const int groups = (t_steps + 7) / 8;
  for (int g = 0; g < groups; ++g) {
    unsigned packed = 0;
    const int live = min(8, t_steps - 8 * g);
    for (int j = 0; j < live; ++j) {
      const float xt = x[(long long)(8 * g + j) * m + i];
      const float h =
          __fadd_rn(v, __fdiv_rn(__fsub_rn(__fadd_rn(xt, b), v), tau));
      const bool s = h >= th;
      v = s ? 0.f : h;
      packed |= (unsigned)s << j;
    }
    out[(long long)g * m + i] = (uint8_t)packed;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: (T, M) f32; bias: (bias_period,) f32; vth: (vth_period,) f32, both
// periods dividing M; out: (ceil(T/8), M) uint8.
extern "C" int tflif_launch(const float* x, const float* bias,
                            long long bias_period, const float* vth,
                            long long vth_period, uint8_t* out, int t_steps,
                            long long m, float tau, void* stream) {
  if (m == 0) return 0;
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  tflif_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, bias, bias_period, vth, vth_period, out, t_steps, m, tau);
  return (int)cudaGetLastError();
}
