// STDP attention: softmax-free (Q K^T) V * scale over (BH, N, Dh) f32
// q, k, v.
//
// Replaces the TPU kernel src/repro/kernels/stdp_attention.py:
// stdp_attention, which streams KV tiles and contracts each score tile with
// its V tile at once. Unlike that kernel's wrapper, which pads q and KV to
// a multiple of the query block and then takes npad / bkv KV steps (so
// bq != bkv drops KV rows), this kernel walks every KV tile up to N and
// masks the ragged edge.
//
// Bound on this card: 4*BH*N*Dh f32 move for 4*BH*N^2*Dh operations,
// ~49 operations per byte at N = 196. The {0,1} operands are exact on int8
// tensor cores (ridge ~590), so the least time is the memory bound; this
// first kernel runs on the f32 units (ridge ~20) and is limited by
// operations until a tensor-core version lands.
// Design: one block per (query tile of 32 rows, bh). The Q tile stays in
// shared memory; for each KV tile of 64 rows the block stages K and V,
// computes the 32x64 score tile into shared memory and accumulates S V in
// registers, so neither the N x N scores nor a second pass over V touch
// device memory. K is stored with a one-float row pad so the score loop
// reads it without bank conflicts.
// Exactness: q, k, v are {0,1}, every score and every sum is an integer
// below 2^24 and the scale is a power of two, so the result is exact in
// any order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32, BKV = 64, THREADS = 256;
constexpr int MAX_DH = 128;
constexpr int MAX_ACC = BQ * MAX_DH / THREADS;

__global__ void stdp_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, int n, int dh,
                            float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // BQ x dh
  float* ks = qs + BQ * dh;          // BKV x (dh + 1)
  float* vs = ks + BKV * (dh + 1);   // BKV x dh
  float* ss = vs + BKV * dh;         // BQ x BKV
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)blockIdx.y * n * dh;

  for (int e = tid; e < BQ * dh; e += THREADS) {
    const int r = e / dh;
    qs[e] = q0 + r < n ? q[base + (long long)q0 * dh + e] : 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) acc[a] = 0.f;

  for (int kv0 = 0; kv0 < n; kv0 += BKV) {
    __syncthreads();
    for (int e = tid; e < BKV * dh; e += THREADS) {
      const int r = e / dh, d = e % dh;
      const bool live = kv0 + r < n;
      const long long off = base + (long long)kv0 * dh + e;
      ks[r * (dh + 1) + d] = live ? k[off] : 0.f;
      vs[e] = live ? v[off] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < BQ * BKV; e += THREADS) {
      const int i = e / BKV, j = e % BKV;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s += qs[i * dh + d] * ks[j * (dh + 1) + d];
      ss[e] = s;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) {
      const int e = tid + a * THREADS;
      if (e >= BQ * dh) break;
      const int i = e / dh, d = e % dh;
      float s = acc[a];
      for (int j = 0; j < BKV; ++j) s += ss[i * BKV + j] * vs[j * dh + d];
      acc[a] = s;
    }
  }
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) {
    const int e = tid + a * THREADS;
    if (e >= BQ * dh) break;
    if (q0 + e / dh < n) out[base + (long long)q0 * dh + e] = acc[a] * scale;
  }
}

size_t smem_bytes(int dh) {
  return sizeof(float) *
         (size_t)(BQ * dh + BKV * (dh + 1) + BKV * dh + BQ * BKV);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, k, v, out: (BH, N, Dh) f32 contiguous, 1 <= Dh <= MAX_DH.
extern "C" int stdp_launch(const float* q, const float* k, const float* v,
                           float* out, int bh, int n, int dh, float scale,
                           void* stream) {
  if (bh == 0 || n == 0) return 0;
  if (dh < 1 || dh > MAX_DH) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      stdp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BQ - 1) / BQ, bh);
  stdp_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(q, k, v, out, n,
                                                             dh, scale);
  return (int)cudaGetLastError();
}
