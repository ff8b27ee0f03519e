// Shift-sum dot: (M, K) uint8 x (K, N) f32 -> (M, N) f32,
// out[m, n] = sum over k of value(x[m, k]) * w[k, n]. Each byte is read as
// the value sum_p 2^p plane_p, so the 8 per-plane dots of SSSC and their
// 2^p combine collapse into one dot.
//
// Replaces the TPU kernel src/repro/kernels/spike_matmul.py:spike_matmul
// with mode="shift_sum" (its 2-D form), which converts the byte tile to f32
// and runs one MXU dot.
//
// Bound on this card: memory. At conv0 of the paper config (M = 100352
// pixels of a batch of 8, K = 12, N = 64) the call makes 2*M*K*N = 154
// MFLOP against 26.9 MB moved, about 6 operations per byte, far below the
// ~20 where the f32 units become the limit; the (M, N) f32 output is 96% of
// the bytes.
// Design: a shared-memory tiled product. A block stages a 64 x 16 tile of
// bytes, converted to f32 as it lands in shared memory, and a 16 x 64 tile
// of weights; each thread holds a 4 x 4 output tile in registers, threads
// of a half-warp on neighbouring output columns so that the stores
// coalesce. No library call: the product is this kernel's body.
// Exactness: k ascends; with integer-valued weights every product and
// partial sum is an integer below 2^24 at conv0 (12 * 255 * 127), so the
// result is exact in any order. With f32 weights it differs from other
// summation orders by rounding only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TX = 16, TY = 16;            // 256 threads
constexpr int TM = BM / TY, TN = BN / TX;  // 4 x 4 outputs per thread

__global__ void __launch_bounds__(TX * TY)
shift_sum_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int m, int k, int n) {
  __shared__ float xs[BK][BM];
  __shared__ float ws[BK][BN];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = tid; e < BM * BK; e += TX * TY) {
      const int rr = e / BK, kk = e % BK;
      const int row = row0 + rr, kg = k0 + kk;
      xs[kk][rr] = (row < m && kg < k) ? (float)x[(long long)row * k + kg] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += TX * TY) {
      const int kk = e / BN, cc = e % BN;
      const int kg = k0 + kk, col = col0 + cc;
      ws[kk][cc] = (kg < k && col < n) ? w[(long long)kg * n + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + i * TY;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * TX;
      if (col < n) out[(long long)row * n + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: (M, K) uint8; w: (K, N) f32; out: (M, N) f32.
extern "C" int shift_sum_launch(const uint8_t* x, const float* w, float* out,
                                int m, int k, int n, void* stream) {
  if (m == 0 || n == 0) return 0;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  shift_sum_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
      x, w, out, m, k, n);
  return (int)cudaGetLastError();
}
