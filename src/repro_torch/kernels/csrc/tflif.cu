// TFLIF: bias add + LIF over T timesteps, spikes packed 8 per byte.
//
// Replaces the TPU kernel src/repro/kernels/tflif.py:tflif_fused.
// Per neuron and step: h = v + ((x + bias) - v) / tau; spike iff h >= v_th;
// hard reset. Bit j of group g is the spike at step 8g+j, and the membrane
// is carried across groups.
//
// Bound on this card: memory. Each neuron reads T f32 accumulators and
// writes ceil(T/8) bytes for about 5 flops a step, far below the ~20
// flop/byte where the H100's f32 units become the limit. So the design is
// a streaming pass that keeps enough loads in flight and spends few
// instructions a neuron:
// - a thread owns 4 neighbouring neurons: one 16-byte load a step
//   (streaming, no L1 allocation: every byte is read once) and one 4-byte
//   store a plane group;
// - for T <= 8 the step count is a template argument, so all of a group's
//   loads are issued before the dependent LIF chain starts; T > 8 runs
//   whole groups of 8 the same way, the membrane in registers throughout;
// - bias and v_th repeat with their own period (the channel count, so the
//   per-channel int8 scale fold never materializes an (M,) copy); a block
//   takes its channel offset from one 64-bit remainder, and every thread
//   from 32-bit arithmetic on it;
// - x's step stride is an argument: a stride of 0 reads one accumulator
//   row for every step (SSSC conv0, whose image is constant in T) once.
// Ragged M or misaligned pointers take scalar loads and stores; that is
// the same kernel, not a fallback.
// Exactness: the IEEE round-to-nearest intrinsics keep the reference's op
// order and forbid contraction; __fdiv_rn is the correctly rounded divide.
// When tau is a power of two (the main path's tau = 2), d / tau and
// d * (1 / tau) are the same exact real number correctly rounded once, so
// __fmul_rn by the exact inverse gives the same bits, subnormals included
// (this file is built without flush-to-zero).
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;                 // neurons a thread
constexpr int BLOCK = THREADS * PER_THREAD;   // neurons a block

struct Params {
  const float* x;
  long long xs;          // step stride of x, in elements (0: one row)
  const float* bias;
  long long bias_period;
  const float* vth;
  long long vth_period;
  uint8_t* out;
  long long m;
  int t;
  float tau, inv_tau;
};

__device__ __forceinline__ float4 ld_stream4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];"
               : "=f"(v)
               : "l"(p));
  return v;
}

template <bool POW2>
__device__ __forceinline__ bool charge_fire(float& v, float xt, float b,
                                            float th, const Params& p) {
  const float d = __fsub_rn(__fadd_rn(xt, b), v);
  const float h =
      __fadd_rn(v, POW2 ? __fmul_rn(d, p.inv_tau) : __fdiv_rn(d, p.tau));
  const bool s = h >= th;
  v = s ? 0.f : h;
  return s;
}

// The 4 channel entries of neurons i0..i0+3 of a vector of period
// ``period``; ``c0`` is (block base) % period.
__device__ __forceinline__ void channel_values(const float* vec,
                                               long long period,
                                               unsigned c0, unsigned off,
                                               float out[PER_THREAD]) {
  if (period == 1) {
    const float v = __ldg(vec);
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) out[j] = v;
    return;
  }
  const unsigned per = (unsigned)period;
  unsigned c = (c0 + off) % per;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    out[j] = __ldg(vec + c);
    if (++c == per) c = 0;
  }
}

// TT: the step count when 1..8, else 0 (any T, in groups of 8);
// VEC: 16-byte loads and 4-byte stores (M a multiple of 4, aligned).
template <int TT, bool VEC, bool POW2>
__global__ void __launch_bounds__(THREADS)
    tflif_kernel(const Params p) {
  __shared__ unsigned s_c0[2];
  const long long base = (long long)blockIdx.x * BLOCK;
  if (threadIdx.x == 0) {
    s_c0[0] = (unsigned)(base % p.bias_period);
    s_c0[1] = (unsigned)(base % p.vth_period);
  }
  __syncthreads();
  const unsigned off = threadIdx.x * PER_THREAD;
  const long long i0 = base + off;
  if (i0 >= p.m) return;
  const int live_n = (int)min((long long)PER_THREAD, p.m - i0);

  float b[PER_THREAD], th[PER_THREAD], v[PER_THREAD];
  channel_values(p.bias, p.bias_period, s_c0[0], off, b);
  channel_values(p.vth, p.vth_period, s_c0[1], off, th);
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) v[j] = 0.f;

  const int t_steps = TT > 0 ? TT : p.t;
  const int groups = TT > 0 ? 1 : (t_steps + 7) / 8;
  const float* xp = p.x + i0;
  float x0[PER_THREAD];          // the one row of a stride-0 x
  if (p.xs == 0) {
    if (VEC) {
      const float4 f = ld_stream4(xp);
      x0[0] = f.x;
      x0[1] = f.y;
      x0[2] = f.z;
      x0[3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j)
        x0[j] = j < live_n ? ld_stream(xp + j) : 0.f;
    }
  }
  for (int g = 0; g < groups; ++g) {
    constexpr int GS = TT > 0 ? TT : 8;       // steps a group, at most
    const int live = TT > 0 ? TT : min(8, t_steps - 8 * g);
    float xv[GS][PER_THREAD];
    // every load of the group first: none waits on the LIF chain
#pragma unroll
    for (int q = 0; q < GS; ++q) {
      if (TT == 0 && q >= live) break;
      const float* row = xp + (long long)(8 * g + q) * p.xs;
      if (p.xs == 0) {
#pragma unroll
        for (int j = 0; j < PER_THREAD; ++j) xv[q][j] = x0[j];
      } else if (VEC) {
        const float4 f = ld_stream4(row);
        xv[q][0] = f.x;
        xv[q][1] = f.y;
        xv[q][2] = f.z;
        xv[q][3] = f.w;
      } else {
#pragma unroll
        for (int j = 0; j < PER_THREAD; ++j)
          xv[q][j] = j < live_n ? ld_stream(row + j) : 0.f;
      }
    }
    unsigned packed[PER_THREAD] = {};
#pragma unroll
    for (int q = 0; q < GS; ++q) {
      if (TT == 0 && q >= live) break;
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j)
        packed[j] |= (unsigned)charge_fire<POW2>(v[j], xv[q][j], b[j], th[j],
                                                 p)
                     << q;
    }
    uint8_t* op = p.out + (long long)g * p.m + i0;
    if (VEC) {
      *reinterpret_cast<uchar4*>(op) =
          make_uchar4(packed[0], packed[1], packed[2], packed[3]);
    } else {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j)
        if (j < live_n) op[j] = (uint8_t)packed[j];
    }
  }
}

template <int TT, bool VEC, bool POW2>
int launch_one(const Params& p, cudaStream_t s) {
  const long long blocks = (p.m + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tflif_kernel<TT, VEC, POW2><<<(unsigned)blocks, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool VEC, bool POW2>
int launch_t(const Params& p, cudaStream_t s) {
  switch (p.t) {
    case 1: return launch_one<1, VEC, POW2>(p, s);
    case 2: return launch_one<2, VEC, POW2>(p, s);
    case 3: return launch_one<3, VEC, POW2>(p, s);
    case 4: return launch_one<4, VEC, POW2>(p, s);
    case 5: return launch_one<5, VEC, POW2>(p, s);
    case 6: return launch_one<6, VEC, POW2>(p, s);
    case 7: return launch_one<7, VEC, POW2>(p, s);
    case 8: return launch_one<8, VEC, POW2>(p, s);
    default: return launch_one<0, VEC, POW2>(p, s);
  }
}

template <bool VEC>
int launch_tau(const Params& p, bool pow2, cudaStream_t s) {
  return pow2 ? launch_t<VEC, true>(p, s) : launch_t<VEC, false>(p, s);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: T rows of M f32, row t at x + t * x_step (x_step >= 0 elements; 0
// reads one row for every step), unit neuron stride; bias: (bias_period,)
// f32; vth: (vth_period,) f32, both periods dividing M and below 2^31;
// out: (ceil(T/8), M) uint8.
extern "C" int tflif_launch(const float* x, long long x_step,
                            const float* bias, long long bias_period,
                            const float* vth, long long vth_period,
                            uint8_t* out, int t_steps, long long m, float tau,
                            void* stream) {
  if (m == 0 || t_steps == 0) return 0;
  if (t_steps < 0 || x_step < 0 || bias_period < 1 || vth_period < 1 ||
      bias_period >= (1LL << 31) || vth_period >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.xs = x_step;
  p.bias = bias;
  p.bias_period = bias_period;
  p.vth = vth;
  p.vth_period = vth_period;
  p.out = out;
  p.m = m;
  p.t = t_steps;
  p.tau = tau;
  // a normal power of two whose inverse is a normal float: the inverse is
  // exact, and multiplying by it rounds exactly as dividing does
  int e;
  const bool pow2 = std::isfinite(tau) && tau > 0.f &&
                    std::frexp(tau, &e) == 0.5f && e >= -124 && e <= 126;
  p.inv_tau = pow2 ? 1.f / tau : 0.f;
  const bool vec = m % 4 == 0 && x_step % 4 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)out % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_tau<true>(p, pow2, s) : launch_tau<false>(p, pow2, s);
}
