// Packed STDP on the tensor cores: softmax-free (Q K^T) V * scale per
// timestep plane, read straight from uint8 temporal plane groups.
//
// Replaces the TPU kernel src/repro/kernels/stdp_attention.py:
// stdp_attention on its main-path caller, the packed entry
// src/repro/kernels/ops.py:stdp_attention_packed, which unpacks the planes
// and folds them into the kernel's batch-heads axis. q, k, v: (G, B, H, N,
// Dh) uint8 with element strides (s_g, s_b, s_h, s_n, 1), shared by the
// three; plane s is bit s % 8 of group s // 8. out: (t, B, H, N, Dh) f32,
// contiguous. csrc/stdp.cu stays the kernel for f32 operands of any value.
//
// Bound on this card: at the paper config's bucket 8 (t 4 planes, 64
// batch-heads, N 196, Dh 64) the 2.4 MB of packed input and the 12.8 MB f32
// output take ~4.6 us at 3.35 TB/s; the 2.5e9 operations take ~2.5 us at
// the fp16 tensor cores' 989 TFLOP/s, so the bytes bound it.
// Exactness: spikes are {0,1} in fp16; a score is an integer <= Dh <= 2048,
// exact in fp16, so the score accumulator fragment is reused as the A
// operand of S V; every f32 sum is an integer below N * Dh < 2^24 (the
// wrapper refuses more), exact in any order; the scale multiplies the
// exact sum once, as the plain version's does. So the result is bit-exact
// against unpacking and stdp_attention_ref.
// Design: one block of four warps per (64-query tile, plane, batch-head,
// 64-column output chunk); one plane per block measured the same as two
// (PERF.md §6), so each block reads its bytes for one bit only. Per 64-key tile the block extracts
// its plane's bits from the packed bytes into fp16 {0,1} tiles in shared
// memory (Q and K row-major, V transposed, zero-padded past N and Dh, row
// stride 72 halves so the fragment loads are free of bank conflicts), then
// each warp computes its 16 x 64 score tile with mma.sync m16n8k16 (f16
// operands, f32 accumulators) over Dh in 64-wide chunks and accumulates
// S V into its 16 x 64 output chunk, skipping key and column blocks that
// are wholly padding. Neither the unpacked planes nor the N x N scores
// touch device memory.
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BKV = 64, DC = 64, THREADS = 128;
constexpr int LD = DC + 8;   // shared row stride in halves
constexpr uint32_t ONE_H = 0x3C00u;   // fp16 1.0

struct Params {
  const uint8_t* q;
  const uint8_t* k;
  const uint8_t* v;
  float* out;
  long long s_g, s_b, s_h, s_n;
  int t, heads, n, dh, n_bh, n_qt, n_oc;
  float scale;
};

// one byte's bit -> fp16 {0, 1}
__device__ __forceinline__ __half bit_half(uint8_t byte, int bit) {
  return __ushort_as_half((unsigned short)(((byte >> bit) & 1u) * ONE_H));
}

// bits of 4 bytes -> two fp16x2 words
__device__ __forceinline__ uint2 bits_half4(uint32_t w, int bit) {
  const uint32_t x = (w >> bit) & 0x01010101u;
  const uint32_t lo = (x & 1u) | ((x & 0x100u) << 8);
  const uint32_t hi = ((x >> 16) & 1u) | ((x >> 8) & 0x10000u);
  return make_uint2(lo * ONE_H, hi * ONE_H);
}

// dst[r][c] = plane bit of src[row0 + r][col0 + c] (0 outside n x dh)
template <bool VEC>
__device__ void stage_rows(__half* dst, const uint8_t* src, long long s_n,
                           int row0, int col0, int n, int dh, int bit) {
  if (VEC) {
    for (int e = threadIdx.x; e < BKV * DC / 4; e += THREADS) {
      const int r = e / (DC / 4), c = (e % (DC / 4)) * 4;
      const int row = row0 + r, col = col0 + c;
      uint2 h = make_uint2(0u, 0u);
      if (row < n && col < dh)
        h = bits_half4(
            *reinterpret_cast<const uint32_t*>(src + row * s_n + col), bit);
      *reinterpret_cast<uint2*>(dst + r * LD + c) = h;
    }
  } else {
    for (int e = threadIdx.x; e < BKV * DC; e += THREADS) {
      const int r = e / DC, c = e % DC;
      const int row = row0 + r, col = col0 + c;
      dst[r * LD + c] = row < n && col < dh ? bit_half(src[row * s_n + col],
                                                       bit)
                                            : __ushort_as_half(0);
    }
  }
}

// dst[c][r] = plane bit of src[row0 + r][col0 + c] (V transposed)
template <bool VEC>
__device__ void stage_cols(__half* dst, const uint8_t* src, long long s_n,
                           int row0, int col0, int n, int dh, int bit) {
  if (VEC) {
    // a thread takes two rows of four columns: four 32-bit stores of
    // (row, row + 1) pairs, a warp's stores consecutive
    for (int e = threadIdx.x; e < BKV / 2 * DC / 4; e += THREADS) {
      const int r = (e % (BKV / 2)) * 2, c = (e / (BKV / 2)) * 4;
      const int col = col0 + c;
      uint2 h[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + r + i < n && col < dh)
          h[i] = bits_half4(*reinterpret_cast<const uint32_t*>(
                                src + (row0 + r + i) * s_n + col),
                            bit);
      // h[i].x holds columns c, c + 1 of row r + i; .y columns c + 2, c + 3
      const uint32_t w[4] = {(h[0].x & 0xFFFFu) | (h[1].x << 16),
                             (h[0].x >> 16) | (h[1].x & 0xFFFF0000u),
                             (h[0].y & 0xFFFFu) | (h[1].y << 16),
                             (h[0].y >> 16) | (h[1].y & 0xFFFF0000u)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(dst + (c + j) * LD + r) = w[j];
    }
  } else {
    for (int e = threadIdx.x; e < BKV * DC; e += THREADS) {
      const int r = e % BKV, c = e / BKV;
      const int row = row0 + r, col = col0 + c;
      dst[c * LD + r] = row < n && col < dh ? bit_half(src[row * s_n + col],
                                                       bit)
                                            : __ushort_as_half(0);
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const __half* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_half2(float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    stdp_packed_kernel(const Params p) {
  __shared__ __align__(16) __half q_s[BQ * LD];
  __shared__ __align__(16) __half k_s[BKV * LD];
  __shared__ __align__(16) __half vt_s[DC * LD];

  int idx = blockIdx.x;
  const int oc = (idx % p.n_oc) * DC;
  idx /= p.n_oc;
  const int q0 = (idx % p.n_qt) * BQ;
  idx /= p.n_qt;
  const int s = idx % p.t;
  const int bh = idx / p.t;
  const int b = bh / p.heads, h = bh % p.heads;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const int row_w = 16 * warp;   // this warp's rows in the tile
  const bool active = q0 + row_w < p.n;
  const int nd = (p.dh + DC - 1) / DC;
  // output column blocks of 8 inside Dh
  const int out_n8 = (min(DC, p.dh - oc) + 7) / 8;

  const long long plane_off = (s / 8) * p.s_g + b * p.s_b + h * p.s_h;
  const int bit = s % 8;
  const uint8_t* qp = p.q + plane_off;
  const uint8_t* kp = p.k + plane_off;
  const uint8_t* vp = p.v + plane_off;
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int kv0 = 0; kv0 < p.n; kv0 += BKV) {
    const int keys = min(BKV, p.n - kv0);
    const int key_n8 = (keys + 7) / 8, key_k16 = (keys + 15) / 16;
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;

    for (int dc = 0; dc < nd; ++dc) {
      const int dk = dc * DC;
      __syncthreads();   // the previous reads of the tiles are done
      if (nd > 1 || kv0 == 0)
        stage_rows<VEC>(q_s, qp, p.s_n, q0, dk, p.n, p.dh, bit);
      stage_rows<VEC>(k_s, kp, p.s_n, kv0, dk, p.n, p.dh, bit);
      if (dc == nd - 1)
        stage_cols<VEC>(vt_s, vp, p.s_n, kv0, oc, p.n, p.dh, bit);
      __syncthreads();
      if (!active) continue;
      const int d_k16 = (min(DC, p.dh - dk) + 15) / 16;
#pragma unroll
      for (int kk = 0; kk < DC / 16; ++kk) {
        if (kk >= d_k16) break;
        const __half* qa = q_s + (row_w + g) * LD + kk * 16 + tq * 2;
        const uint32_t a[4] = {lds32(qa), lds32(qa + 8 * LD), lds32(qa + 8),
                               lds32(qa + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= key_n8) break;
          const __half* kb = k_s + (j * 8 + g) * LD + kk * 16 + tq * 2;
          mma16816(sc[j], a, lds32(kb), lds32(kb + 8));
        }
      }
    }
    if (!active) continue;
    // O += S V: the score fragments of key blocks 2kk, 2kk + 1 are the
    // A fragment of keys 16kk..16kk + 15
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      if (kk >= key_k16) break;
      const uint32_t a[4] = {pack_half2(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_half2(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_half2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_half2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= out_n8) break;
        const __half* vb = vt_s + (j * 8 + g) * LD + kk * 16 + tq * 2;
        mma16816(o[j], a, lds32(vb), lds32(vb + 8));
      }
    }
  }

  if (active) {
    float* out = p.out + ((long long)s * p.n_bh + bh) * p.n * p.dh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row_w + g + 8 * r;
      if (row >= p.n) continue;
      float* orow = out + (long long)row * p.dh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = oc + j * 8 + tq * 2;
        const float x0 = o[j][2 * r] * p.scale, x1 = o[j][2 * r + 1] * p.scale;
        if ((p.dh & 1) == 0) {
          if (col < p.dh)
            *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        } else {
          if (col < p.dh) orow[col] = x0;
          if (col + 1 < p.dh) orow[col + 1] = x1;
        }
      }
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, k, v: (G, batch, heads, n, dh) uint8 sharing element strides (s_g, s_b,
// s_h, s_n, 1), G = ceil(t / 8); out: (t, batch, heads, n, dh) f32,
// contiguous; n * dh < 2^24, dh <= 2048.
extern "C" int stdp_packed_launch(const uint8_t* q, const uint8_t* k,
                                  const uint8_t* v, float* out, int t,
                                  int batch, int heads, int n, int dh,
                                  long long s_g, long long s_b, long long s_h,
                                  long long s_n, float scale, void* stream) {
  if (t == 0 || batch == 0 || heads == 0 || n == 0 || dh == 0) return 0;
  if (t < 0 || dh > 2048 || (long long)n * dh >= (1LL << 24))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.s_g = s_g;
  p.s_b = s_b;
  p.s_h = s_h;
  p.s_n = s_n;
  p.t = t;
  p.heads = heads;
  p.n = n;
  p.dh = dh;
  p.n_bh = batch * heads;
  p.n_qt = (n + BQ - 1) / BQ;
  p.n_oc = (dh + DC - 1) / DC;
  p.scale = scale;
  const long long blocks = (long long)p.n_oc * p.n_qt * p.t * p.n_bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 4-byte loads when every row of four columns is 4-byte aligned
  const bool vec = dh % 4 == 0 && s_g % 4 == 0 && s_b % 4 == 0 &&
                   s_h % 4 == 0 && s_n % 4 == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 4 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    stdp_packed_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(p);
  else
    stdp_packed_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
