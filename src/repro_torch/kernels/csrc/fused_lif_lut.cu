// Fused TFLIF -> pack -> byte-LUT gather over a producer/consumer pair:
// x (T, R, K) f32 producer accumulators, bias and v_th (K,), table
// (C, 256, N) consumer chunk-partial sums -> spikes (G, R, K) uint8, the
// producer's packed LIF output, and acc (T, R, N) f32, the consumer's
// accumulators: acc[t, r, :] = sum over c ascending of table[c, b, :],
// with bit i of index byte b the spike of input 8c+i at step t.
//
// Replaces the TPU kernel src/repro/kernels/fused.py:tflif_lut_matmul,
// which keeps the whole (C, 256, N) table resident per grid step. At fc2 of
// the paper config that table is 64 MiB (int16) or 128 MiB (f32), hundreds
// of times the 227 KB of shared memory a block may use, so that layout
// cannot be carried over.
//
// Bound on this card: the table reads. Each output element gathers C table
// entries (T*R*C*N reads in all) while x, the table and the outputs are
// read or written once; the table does not fit the 50 MB L2 at fc2, but
// the blocks in flight walk the chunks in step, so a chunk's 256 x N slab
// is served from L2 to all of them.
// Design: a block owns ROWS rows and a BN-column tile and walks the chunks
// in ascending order. For each chunk, ROWS*8 threads run the LIF of the
// chunk's 8 input neurons over all T for the block's rows (the membrane is
// per neuron, so chunk order does not disturb it); one warp ballot per step
// turns 4 rows x 8 neurons of spike bits into 4 index bytes, kept in shared
// memory. Then every thread gathers table[c, byte, col] into per-(t, row,
// col) accumulators in registers. The fc1 spikes never exist unpacked
// outside registers, and the 8x8 bit transpose of the unfused route is
// never run. Only the first column tile writes the packed spikes; the other
// tiles recompute the LIF of their rows (N / BN times the LIF work).
// Exactness: the LIF charge uses the IEEE round-to-nearest intrinsics in
// the reference's op order (as csrc/tflif.cu does); the fold is ascending
// chunk, int32 for int16 tables and f32 starting from chunk 0's entry for
// f32 tables, the defined reduction tree of lut_matmul. K not a multiple
// of 8 pads with x = 0, bias = 0, v_th = 1: such a neuron never fires, so
// its bit is 0 and selects build_lut's zero rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // threads along output columns
constexpr int BY = 8;   // thread rows
constexpr int THREADS = BX * BY;

// TT: timestep capacity; RM: rows per thread; CPT: columns per thread,
// strided by BX so that a warp's table reads coalesce.
template <int TT, int RM, int CPT, typename Tab, typename Acc>
__global__ void __launch_bounds__(THREADS)
fused_lif_lut_kernel(const float* __restrict__ x,
                     const float* __restrict__ bias,
                     const float* __restrict__ vth,
                     const Tab* __restrict__ table,
                     uint8_t* __restrict__ spikes, float* __restrict__ out,
                     int t_steps, int r, int k, int n, float tau) {
  constexpr int ROWS = BY * RM;
  constexpr int BN = BX * CPT;
  constexpr int LIF_THREADS = ROWS * 8;  // whole warps: ROWS is a multiple of 4
  __shared__ uint8_t sidx[TT][ROWS];
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int col0 = blockIdx.y * BN;
  const int chunks = (k + 7) / 8;
  const bool write_spikes = blockIdx.y == 0;
  Acc acc[TT][RM][CPT];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int rr = 0; rr < RM; ++rr)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[t][rr][j] = (Acc)0;

  for (int c = 0; c < chunks; ++c) {
    __syncthreads();  // the previous chunk's gathers are done with sidx
    if (tid < LIF_THREADS) {
      // lane = 8 * (row % 4) + i: a warp holds 4 rows x the chunk's 8 inputs
      const int rl = tid >> 3, i = tid & 7;
      const int row = row0 + rl, kk = c * 8 + i;
      const bool live = row < r && kk < k;
      const float b = kk < k ? bias[kk] : 0.f;
      const float th = kk < k ? vth[kk] : 1.f;
      float v = 0.f;
      unsigned packed = 0;
      for (int t = 0; t < t_steps; ++t) {
        const float xt = live ? x[((long long)t * r + row) * k + kk] : 0.f;
        const float h =
            __fadd_rn(v, __fdiv_rn(__fsub_rn(__fadd_rn(xt, b), v), tau));
        const bool s = h >= th;
        v = s ? 0.f : h;
        const unsigned bits = __ballot_sync(0xffffffffu, s);
        if (i == 0) sidx[t][rl] = (uint8_t)(bits >> ((rl & 3) * 8));
        packed |= (unsigned)s << (t & 7);
        if ((t & 7) == 7 || t == t_steps - 1) {
          if (write_spikes && live)
            spikes[((long long)(t >> 3) * r + row) * k + kk] = (uint8_t)packed;
          packed = 0;
        }
      }
    }
    __syncthreads();
    const Tab* tc = table + (long long)c * 256 * n;
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      if (t >= t_steps) break;
#pragma unroll
      for (int rr = 0; rr < RM; ++rr) {
        const Tab* trow = tc + (long long)sidx[t][threadIdx.y * RM + rr] * n;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = col0 + threadIdx.x + j * BX;
          const Acc g = col < n ? (Acc)trow[col] : (Acc)0;
          acc[t][rr][j] = c == 0 ? g : acc[t][rr][j] + g;
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t >= t_steps) break;
#pragma unroll
    for (int rr = 0; rr < RM; ++rr) {
      const int row = row0 + threadIdx.y * RM + rr;
      if (row >= r) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = col0 + threadIdx.x + j * BX;
        if (col < n) out[((long long)t * r + row) * n + col] = (float)acc[t][rr][j];
      }
    }
  }
}

template <int TT, int RM, int CPT, typename Tab, typename Acc>
int launch_one(const float* x, const float* bias, const float* vth,
               const Tab* table, uint8_t* spikes, float* out, int t, int r,
               int k, int n, float tau, cudaStream_t s) {
  // N = 0 still takes one column tile: it writes the spikes
  const int tiles = n > 0 ? (n + BX * CPT - 1) / (BX * CPT) : 1;
  const dim3 grid((r + BY * RM - 1) / (BY * RM), tiles);
  fused_lif_lut_kernel<TT, RM, CPT, Tab, Acc><<<grid, dim3(BX, BY), 0, s>>>(
      x, bias, vth, table, spikes, out, t, r, k, n, tau);
  return (int)cudaGetLastError();
}

// Register accumulators per thread: TT * RM * CPT <= 64.
template <typename Tab, typename Acc>
int launch(const float* x, const float* bias, const float* vth,
           const Tab* table, uint8_t* spikes, float* out, int t, int r, int k,
           int n, float tau, void* stream) {
  if (t == 0 || r == 0 || k == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (t <= 4)
    return launch_one<4, 2, 4, Tab, Acc>(x, bias, vth, table, spikes, out, t, r, k, n, tau, s);
  if (t <= 8)
    return launch_one<8, 1, 4, Tab, Acc>(x, bias, vth, table, spikes, out, t, r, k, n, tau, s);
  if (t <= 16)
    return launch_one<16, 1, 4, Tab, Acc>(x, bias, vth, table, spikes, out, t, r, k, n, tau, s);
  if (t <= 32)
    return launch_one<32, 1, 2, Tab, Acc>(x, bias, vth, table, spikes, out, t, r, k, n, tau, s);
  if (t <= 64)
    return launch_one<64, 1, 1, Tab, Acc>(x, bias, vth, table, spikes, out, t, r, k, n, tau, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: (T, R, K) f32; bias, vth: (K,) f32; table: (ceil(K/8), 256, N);
// spikes: (ceil(T/8), R, K) uint8; out: (T, R, N) f32; T <= 64.
extern "C" int fused_lif_lut_i16(const float* x, const float* bias,
                                 const float* vth, const int16_t* table,
                                 uint8_t* spikes, float* out, int t, int r,
                                 int k, int n, float tau, void* stream) {
  return launch<int16_t, int>(x, bias, vth, table, spikes, out, t, r, k, n,
                              tau, stream);
}

extern "C" int fused_lif_lut_f32(const float* x, const float* bias,
                                 const float* vth, const float* table,
                                 uint8_t* spikes, float* out, int t, int r,
                                 int k, int n, float tau, void* stream) {
  return launch<float, float>(x, bias, vth, table, spikes, out, t, r, k, n,
                              tau, stream);
}
