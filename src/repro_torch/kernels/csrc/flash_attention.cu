// Flash attention: softmax attention with an online softmax over KV tiles,
// causal or not, f32 operands and math on the CUDA cores, f32 output.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention for f32 operands (bf16 operands run the tensor-core kernel
// csrc/flash_attention_tc.cu). q: (BH, Nq, Dh); k, v: (BH, Nkv, Dh);
// query row i sits at
// position Nkv - Nq + i, key j at position j. Per KV tile, as the reference:
// s = (q * scale) . k in f32 (q scaled before the dot), masked entries set
// to NEG_INF = -1e30 (not -inf), m_new = max(m, rowmax s),
// alpha = exp(m - m_new), p = exp(s - m_new), l = l * alpha + rowsum p,
// acc = acc * alpha + p v; out = acc / max(l, 1e-30).
// Keys past Nkv are masked in both modes (the reference's wrapper refuses
// the non-causal case with KV padding; this kernel masks it, which is the
// exact softmax of flash_attention_ref).
//
// Bound on this card: at smollm's prefill shape (15 heads, 2048 tokens,
// Dh 64) the causal product is ~8e9 flops for ~31 MB of f32 moved, above
// the f32 units' ridge (~20 flop/byte): the least time is the operations'
// at 67 TFLOP/s. f32 operands are the oracle and gate route (the serving
// path is bf16), so this kernel stays the simple CUDA-core design.
// Design: one block of 256 threads per (64-query tile, bh). The scaled Q
// tile stays in shared memory; KV tiles of 64 keys are staged in ascending
// order, so the first tile of every row holds key 0, which every row may
// see (the wrapper refuses causal Nq > Nkv, where a row would have no key):
// a row never finishes with m = NEG_INF, and a tile whose entries are all
// masked while m is still NEG_INF (p = exp(0) = 1) cannot occur. Causal
// blocks stop at the last tile their last query can see; the tiles skipped
// would add exact zeros. Each thread computes a 4x4 patch of the score
// tile (rows ty + 16 i, keys tx + 16 j) into shared memory; four threads
// per row then do the online-softmax update with warp shuffles; each
// thread then accumulates a 4 x Dh/16 patch of p v in registers. Q and K
// rows carry a one-float pad so the score loop is free of bank conflicts.
// Numerics: expf (not __expf) and no fast-math flags.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BKV * (DH + 1) + BKV * DH + BQ * (BKV + 1) + 3 * BQ;
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, float* __restrict__ out,
                           int nq, int nkv, float scale, int causal) {
  constexpr int DP = DH + 1;    // row stride of the q and k tiles
  constexpr int SP = BKV + 1;   // row stride of the score tile
  constexpr int RPT = BQ / 16;  // query rows per thread
  constexpr int CPT = BKV / 16; // keys per thread in the score patch
  constexpr int DPT = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // BQ x DP: q * scale
  float* ks = qs + BQ * DP;     // BKV x DP
  float* vs = ks + BKV * DP;    // BKV x DH
  float* ss = vs + BKV * DH;    // BQ x SP: scores, then probabilities
  float* m_s = ss + BQ * SP;    // running max per row
  float* l_s = m_s + BQ;        // running sum per row
  float* a_s = l_s + BQ;        // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * nq * DH;
  const T* kb = k + bh * nkv * DH;
  const T* vb = v + bh * nkv * DH;
  const int q_offset = nkv - nq;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH, qi = q0 + r;
    qs[r * DP + d] = qi < nq ? to_f32(qb[(long long)qi * DH + d]) * scale
                             : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // the last key this block's last query may see, plus one
  const int kv_end =
      causal ? min(nkv, q_offset + min(q0 + BQ, nq)) : nkv;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's reads of ks, vs, ss are done
    for (int e = tid; e < BKV * DH; e += THREADS) {
      const int r = e / DH, d = e % DH, kj = k0 + r;
      const bool in = kj < nkv;
      ks[r * DP + d] = in ? to_f32(kb[(long long)kj * DH + d]) : 0.f;
      vs[r * DH + d] = in ? to_f32(vb[(long long)kj * DH + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kpos = k0 + c, qpos = q_offset + q0 + r;
        const bool keep = kpos < nkv && (!causal || qpos >= kpos);
        ss[r * SP + c] = keep ? s[i][j] : NEG_INF;
      }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row, 16 keys each
      const int r = tid / 4, part = tid % 4;
      float* row = ss + r * SP + part * (BKV / 4);
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BKV / 4; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BKV / 4; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      // the shuffles also order every lane's read of m_s[r] before the
      // write below
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 8
    for (int c = 0; c < BKV; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ss[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // the last tile's l_s update is visible

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= nq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      out[(bh * nq + qi) * DH + tx + 16 * j] = acc[i][j] / l;
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, float* out, int bh,
           int nq, int nkv, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = smem_floats<DH>() * sizeof(float);
  auto kernel = flash_attention_kernel<DH, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, nq, nkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, float* out, int bh,
              int nq, int nkv, int dh, float scale, int causal,
              cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<32, T>(q, k, v, out, bh, nq, nkv, scale, causal, stream);
    case 64:
      return launch<64, T>(q, k, v, out, bh, nq, nkv, scale, causal, stream);
    case 128:
      return launch<128, T>(q, k, v, out, bh, nq, nkv, scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q: (bh, nq, dh); k, v: (bh, nkv, dh), all f32, contiguous; out:
// (bh, nq, dh) f32. dh in {32, 64, 128}; nkv >= 1, and nq <= nkv when
// causal.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, float* out, int bh,
                                      int nq, int nkv, int dh, float scale,
                                      int causal, void* stream) {
  if (bh == 0 || nq == 0) return 0;
  return launch_dh<float>(q, k, v, out, bh, nq, nkv, dh, scale, causal,
                          (cudaStream_t)stream);
}
