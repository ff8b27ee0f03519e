// Grouped unpack dot: (G, M, K) uint8 plane groups x (K, N) f32 weights ->
// (t, M, N) f32, out[p] = plane_p @ W with plane p = bit (p % 8) of group
// p / 8. Only the t live planes are written.
//
// Replaces the TPU kernel src/repro/kernels/spike_matmul.py:
// _spike_matmul_grouped, which folds a group's 8 planes into the row
// dimension of one MXU dot and writes (G, 8, M, N).
//
// Bound on this card: t*M*K*N multiply-adds against G*M*K + K*N + t*M*N
// elements moved, ~240 operations per byte at fc1 of the paper config.
// The int8 path's integer-valued weights would be exact on int8 tensor
// cores, whose ridge (~590 operations per byte) puts that work under the
// memory bound; this first kernel runs on the f32 units (ridge ~20), so it
// is limited by operations.
// Design: a shared-memory tiled product. A block stages a 32x32 tile of
// packed bytes and a 32x64 tile of weights; each thread holds a 2x4 output
// tile for every live plane of the group in registers and expands the bits
// in registers, so the unpacked planes never exist in memory and one weight
// fetch serves all of a group's planes.
// Exactness: bit * w is exactly 0 or w, so each fmaf is one rounded add.
// With integer-valued weights every partial sum is an integer below 2^24
// and the result is exact in any order; with f32 weights it differs from
// other summation orders by rounding only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32, BN = 64, BK = 32;
constexpr int TX = 16, TY = 16;           // 256 threads
constexpr int TM = BM / TY, TN = BN / TX;  // 2 x 4 outputs per thread/plane

template <int NP>
__global__ void unpack_dot_kernel(const uint8_t* __restrict__ x,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, int t, int m,
                                  int k, int n) {
  __shared__ uint8_t xs[BM][BK];
  __shared__ float ws[BK][BN];
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const uint8_t* xg = x + (long long)g * m * k;
  float acc[NP][TM][TN];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[p][i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = tid; e < BM * BK; e += TX * TY) {
      const int r = e / BK, kk = e % BK;
      const int row = row0 + r, kg = k0 + kk;
      xs[r][kk] = (row < m && kg < k) ? xg[(long long)row * k + kg] : 0;
    }
    for (int e = tid; e < BK * BN; e += TX * TY) {
      const int kk = e / BN, cc = e % BN;
      const int kg = k0 + kk, col = col0 + cc;
      ws[kk][cc] = (kg < k && col < n) ? w[(long long)kg * n + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float wv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const unsigned b = xs[ty + i * TY][kk];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float bit = (float)((b >> p) & 1u);
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[p][i][j] = fmaf(bit, wv[j], acc[p][i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int plane = g * 8 + p;
    if (plane >= t) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty + i * TY;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + tx + j * TX;
        if (col < n) out[((long long)plane * m + row) * n + col] = acc[p][i][j];
      }
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: (G, M, K) uint8; w: (K, N) f32; out: (t, M, N) f32, G = ceil(t/8).
extern "C" int unpack_dot_launch(const uint8_t* x, const float* w, float* out,
                                 int t, int m, int k, int n, void* stream) {
  if (t == 0 || m == 0 || n == 0) return 0;
  const int g = (t + 7) / 8;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
  const dim3 block(TX, TY);
  cudaStream_t s = (cudaStream_t)stream;
  // planes per group: all 8 unless T < 8 (a T > 8 tail group computes its
  // dead planes and does not store them)
  switch (t < 8 ? t : 8) {
    case 1: unpack_dot_kernel<1><<<grid, block, 0, s>>>(x, w, out, t, m, k, n); break;
    case 2: unpack_dot_kernel<2><<<grid, block, 0, s>>>(x, w, out, t, m, k, n); break;
    case 3: unpack_dot_kernel<3><<<grid, block, 0, s>>>(x, w, out, t, m, k, n); break;
    case 4: unpack_dot_kernel<4><<<grid, block, 0, s>>>(x, w, out, t, m, k, n); break;
    case 5: unpack_dot_kernel<5><<<grid, block, 0, s>>>(x, w, out, t, m, k, n); break;
    case 6: unpack_dot_kernel<6><<<grid, block, 0, s>>>(x, w, out, t, m, k, n); break;
    case 7: unpack_dot_kernel<7><<<grid, block, 0, s>>>(x, w, out, t, m, k, n); break;
    default: unpack_dot_kernel<8><<<grid, block, 0, s>>>(x, w, out, t, m, k, n); break;
  }
  return (int)cudaGetLastError();
}
