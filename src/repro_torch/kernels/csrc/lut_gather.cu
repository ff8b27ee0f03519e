// Byte-LUT gather matmul: (P, M, C) uint8 index bytes x (C, 256, N) table
// -> (P, M, N) f32, out[p, m, :] = sum over c ascending of
// table[c, idx[p, m, c], :].
//
// Replaces the TPU kernel src/repro/kernels/spike_matmul.py:lut_gather_matmul
// (wrapper src/repro/kernels/lut_matmul.py:lut_matmul_pallas), which
// selects table rows with one-hot MXU products against a VMEM-resident
// table.
//
// Bound on this card: the table reads. Each output element gathers C table
// entries, P*M*C*N reads in all, while the inputs and outputs are read and
// written once. A 16 MiB int16 SSA table is 70x the 227 KB of shared memory
// a block may use, so the table cannot be staged; it fits the 50 MB L2, and
// the gathers are served from there. Device memory sees it once.
// Design: grid (row tiles, column tiles, plane). A block stages its rows'
// index bytes in shared memory; its threads sit on neighbouring output
// columns so that one warp's reads of a table row coalesce (64 bytes for
// int16, 128 for f32), and each thread folds RM rows in registers.
// Exactness: every thread folds its chunks in ascending order, the defined
// reduction tree of the reference; int16 tables accumulate in int32 and
// convert to f32 at the end, f32 tables accumulate with plain adds starting
// from chunk 0's entry. Ragged rows and columns are masked, not padded.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;   // threads (output columns) along x
constexpr int BY = 8;    // thread rows along y
constexpr int RM = 4;    // output rows per thread
constexpr int ROWS = BY * RM;
constexpr int CT = 128;  // chunks of index bytes staged at a time

template <typename T, typename Acc>
__global__ void lut_gather_kernel(const uint8_t* __restrict__ idx,
                                  const T* __restrict__ table,
                                  float* __restrict__ out, int m, int c,
                                  int n) {
  __shared__ uint8_t sidx[ROWS * CT];
  const int p = blockIdx.z;
  const int row0 = blockIdx.x * ROWS;
  const int col = blockIdx.y * BX + threadIdx.x;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const uint8_t* ip = idx + (long long)p * m * c;
  Acc acc[RM] = {};
  for (int c0 = 0; c0 < c; c0 += CT) {
    const int cw = min(CT, c - c0);
    __syncthreads();
    for (int e = tid; e < ROWS * cw; e += BX * BY) {
      const int r = e / cw, cc = e % cw;
      const int row = row0 + r;
      sidx[r * CT + cc] = row < m ? ip[(long long)row * c + c0 + cc] : 0;
    }
    __syncthreads();
    if (col >= n) continue;
    for (int cc = 0; cc < cw; ++cc) {
      const T* tc = table + (long long)(c0 + cc) * 256 * n + col;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const Acc g = (Acc)tc[(long long)sidx[(threadIdx.y * RM + r) * CT + cc] * n];
        acc[r] = (c0 + cc == 0) ? g : acc[r] + g;
      }
    }
  }
  if (col >= n) return;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + threadIdx.y * RM + r;
    if (row < m) out[((long long)p * m + row) * n + col] = (float)acc[r];
  }
}

template <typename T, typename Acc>
int launch(const uint8_t* idx, const T* table, float* out, int p, int m,
           int c, int n, void* stream) {
  if (p == 0 || m == 0 || n == 0) return 0;
  const dim3 grid((m + ROWS - 1) / ROWS, (n + BX - 1) / BX, p);
  lut_gather_kernel<T, Acc><<<grid, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      idx, table, out, m, c, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int lut_gather_i16(const uint8_t* idx, const int16_t* table,
                              float* out, int p, int m, int c, int n,
                              void* stream) {
  return launch<int16_t, int>(idx, table, out, p, m, c, n, stream);
}

extern "C" int lut_gather_f32(const uint8_t* idx, const float* table,
                              float* out, int p, int m, int c, int n,
                              void* stream) {
  return launch<float, float>(idx, table, out, p, m, c, n, stream);
}
