// STDP attention: softmax-free (Q K^T) V * scale over (BH, N, Dh) f32
// q, k, v, on the tensor cores in split TF32 (csrc/tf32x3.cuh).
//
// Replaces the TPU kernel src/repro/kernels/stdp_attention.py:
// stdp_attention, which streams KV tiles and contracts each score tile with
// its V tile at once. Unlike that kernel's wrapper, which pads q and KV to
// a multiple of the query block and then takes npad / bkv KV steps (so
// bq != bkv drops KV rows), this kernel walks every KV tile up to N and
// masks the ragged edge.
//
// Bound on this card: 4 BH N Dh f32 move (12.8 MB at (256, 196, 64)) for
// 4 BH N^2 Dh operations (2.52e9 there). Each product is three TF32
// products (7.6e9 at 495 TFLOP/s: 0.0153 ms), which is as long as the
// bytes take; on the f32 units (67 TFLOP/s) the same work needs 0.0376 ms.
// Two designs, chosen by the operands:
// - Dh 32 or 64 with 16-byte aligned operands (the paper config's Dh 64):
//   stdp_kernel_wgmma, the block pipeline of tf32x3::Pipe. Three
//   warpgroups per (128-query tile, bh); the producer loads q and each tile
//   of 64 K and V rows by TMA and splits K and V^T once a block; each
//   consumer warpgroup computes its 64 x 64 scores S = Q K^T as 3xTF32
//   wgmma products into two accumulators, adds them, and accumulates O +=
//   S V as 3xTF32 wgmma products with the split S as the A fragment,
//   skipping the 8-key steps past N; out = (O_hi + O_lo) * scale.
// - any other Dh up to 128, or unaligned operands: stdp_kernel, mma.sync
//   over fragments split in registers (the reasons are in tf32x3.cuh). One
//   block of 8 warps per (128-query tile, bh); each warp owns 16 query rows.
//   The Q tile and a ring of STAGES tiles of 32 K and V rows come into
//   shared memory by cp.async (16-byte copies when Dh is a multiple of 4
//   and the operands are 16-byte aligned, 4-byte copies otherwise), rows
//   past N and columns past Dh zero-filled up to DP, Dh rounded up to 8 and
//   then to a power of two. One barrier a tile: it both shows tile j landed
//   and frees the stage of tile j - 1 for the copy of tile j + 2. Per tile
//   a warp computes its 16 x 32 scores as 3xTF32 products into two
//   accumulators, adds them, splits S in registers and accumulates O += S V
//   likewise; the ragged last tile computes only its live 8-key blocks, and
//   warps whose rows all lie past N skip the products. Row strides 8 (Q, K)
//   and 4 (V) floats past a multiple of 32 keep every fragment load free of
//   bank conflicts.
// Both set their shared-memory size once a device, not at every launch.
// Exactness: q, k, v are {0,1}, so every split has small = 0, every score
// and sum is an integer below 2^24 and the scale a power of two: the
// result is exact, as it is in any order.
#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"
#include "tma.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::mma3;

constexpr int BQ = 128, BKV = 32, KB = BKV / 8, STAGES = 3, WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_DH = 128;

// DB: 8-column blocks of the padded head dim DP = 8 DB
template <int DB>
struct Tiles {
  static constexpr int DP = 8 * DB;
  static constexpr int ROW = (DP + 31) / 32 * 32;
  static constexpr int QS = ROW + 8, KS = ROW + 8, VS = ROW + 4;
  static constexpr int Q_FLOATS = BQ * QS;
  static constexpr int KV_FLOATS = BKV * (KS + VS);   // one stage
  static constexpr size_t BYTES =
      sizeof(float) * (Q_FLOATS + STAGES * KV_FLOATS);
};

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec4, bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(live ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(live ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) of a row-major (n, dh) matrix into dst (row stride
// ld), columns up to DP; rows past n and columns past dh are zero-filled
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int r0, int rows,
                                          int n, int dh, bool vec4) {
  const int w = vec4 ? 4 : 1, per_row = DP / w;
  for (int e = threadIdx.x; e < rows * per_row; e += THREADS) {
    const int r = e / per_row, c = w * (e % per_row);
    const bool live = r0 + r < n && c < dh;
    cp_async(dst + r * ld + c, live ? src + (long long)(r0 + r) * dh + c : src,
             vec4, live);
  }
}

template <int DB>
__global__ void __launch_bounds__(THREADS, DB <= 8 ? 2 : 1)
    stdp_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int n,
                int dh, float scale, int vec4) {
  using T = Tiles<DB>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ring = qs + T::Q_FLOATS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)blockIdx.y * n * dh;
  const float *qb = q + base, *kb = k + base, *vb = v + base;
  const int n_tiles = (n + BKV - 1) / BKV;

  auto load_tile = [&](int j) {
    float* ks = ring + (j % STAGES) * T::KV_FLOATS;
    load_rows<T::DP>(ks, T::KS, kb, j * BKV, BKV, n, dh, vec4);
    load_rows<T::DP>(ks + BKV * T::KS, T::VS, vb, j * BKV, BKV, n, dh, vec4);
  };
  // groups: {Q, tile 0}, {tile 1}, then one a tile (empty past the end)
  load_rows<T::DP>(qs, T::QS, qb, q0, BQ, n, dh, vec4);
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_tile(j);
    cp_async_commit();
  }

  const int row0 = 16 * warp;         // the warp's rows in the tile
  const bool active = q0 + row0 < n;
  const float* qa = qs + (row0 + g) * T::QS + 2 * t;
  float o_hi[DB][4], o_lo[DB][4];
#pragma unroll
  for (int nd = 0; nd < DB; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_hi[nd][i] = o_lo[nd][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < n_tiles) load_tile(j + STAGES - 1);
    cp_async_commit();
    if (!active) continue;

    const float* ks = ring + (j % STAGES) * T::KV_FLOATS;
    const float* vs = ks + BKV * T::KS;
    const int nkb = min(KB, (n - j * BKV + 7) / 8);   // live 8-key blocks

    // S = Q K^T: columns 2t, 2t + 1 of each 8-column step are its k = t,
    // t + 4 for both operands
    float s_hi[KB][4], s_lo[KB][4];
#pragma unroll
    for (int nb = 0; nb < KB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s_hi[nb][i] = s_lo[nb][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DB; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kk);
      const float2 x1 =
          *reinterpret_cast<const float2*>(qa + 8 * T::QS + 8 * kk);
      FragA a;
      a.set(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
      for (int nb = 0; nb < KB; ++nb)
        if (nb < nkb) {
          const float2 y = *reinterpret_cast<const float2*>(
              ks + (8 * nb + g) * T::KS + 8 * kk + 2 * t);
          FragB b;
          b.set(y.x, y.y);
          mma3(s_hi[nb], s_lo[nb], a, b);
        }
    }

    // O += S V: the accumulator's keys 2t, 2t + 1 are the A fragment's
    // k = t, t + 4, so V's rows 2t, 2t + 1 are B's
#pragma unroll
    for (int nb = 0; nb < KB; ++nb)
      if (nb < nkb) {
        FragA a;
        a.set(s_hi[nb][0] + s_lo[nb][0], s_hi[nb][2] + s_lo[nb][2],
              s_hi[nb][1] + s_lo[nb][1], s_hi[nb][3] + s_lo[nb][3]);
        const float* v0 = vs + (8 * nb + 2 * t) * T::VS + g;
#pragma unroll
        for (int nd = 0; nd < DB; ++nd) {
          FragB b;
          b.set(v0[8 * nd], v0[T::VS + 8 * nd]);
          mma3(o_hi[nd], o_lo[nd], a, b);
        }
      }
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (!active) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + g + 8 * h;
    if (row >= n) continue;
    float* dst = out + base + (long long)row * dh;
#pragma unroll
    for (int nd = 0; nd < DB; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < dh) dst[col] = (o_hi[nd][2 * h] + o_lo[nd][2 * h]) * scale;
      if (col + 1 < dh)
        dst[col + 1] =
            (o_hi[nd][2 * h + 1] + o_lo[nd][2 * h + 1]) * scale;
    }
  }
}

template <int DB>
int launch(const float* q, const float* k, const float* v, float* out,
           int bh, int n, int dh, float scale, cudaStream_t stream) {
  using T = Tiles<DB>;
  static std::atomic<unsigned long long> sized{0};
  const cudaError_t err =
      tf32x3::size_smem_once(stdp_kernel<DB>, T::BYTES, sized);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 =
      dh % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid((n + BQ - 1) / BQ, bh);
  stdp_kernel<DB><<<grid, THREADS, T::BYTES, stream>>>(q, k, v, out, n, dh,
                                                       scale, (int)vec4);
  return (int)cudaGetLastError();
}

// Dh 32 and 64 with 16-byte aligned operands: wgmma over operands split
// once a block (tf32x3::Pipe). Rows past N are zero-filled by TMA, so their
// scores and V rows add nothing; P V skips the 8-key steps past N.
struct WgParams {
  int n, n_qtiles;
  int dim[3];   // TMA dimension of (row, batch-head, 1)
  float scale;
  float* out;
};

constexpr int WG_THREADS = 384;

template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 1)
    stdp_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const WgParams p) {
  using Pipe = tf32x3::Pipe<DH>;
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe(smem_raw);
  const int qt = blockIdx.x % p.n_qtiles, bh = blockIdx.x / p.n_qtiles;
  const int q0 = qt * Pipe::BQ;
  const int n_tiles = (p.n + Pipe::BKV - 1) / Pipe::BKV;
  const int tid = threadIdx.x;
  pipe.init(tid, WG_THREADS);
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    int cq[4] = {0, 0, 0, 0}, ckv[4] = {0, 0, 0, 0};
    cq[p.dim[0]] = q0;
    cq[p.dim[1]] = bh;
    ckv[p.dim[1]] = bh;
    pipe.produce(&map_q, &map_k, &map_v, cq, ckv, p.dim[0], n_tiles,
                 tid - 256);
    return;
  }

  // consumers: 64 query rows a warpgroup, 16 a warp
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int lane = tid % 32, warp = tid / 32, wg = tid / 128;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;
  const bool active = q0 + 64 * wg < p.n;
  tma::mbar_wait(pipe.q_bar, 0);
  const float* qa = pipe.q + (row0 + g) * Pipe::RS + t;
  float o_hi[32], o_lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_hi[i] = o_lo[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % Pipe::STAGES;
    tma::mbar_wait(&pipe.full[s], (j / Pipe::STAGES) & 1);
    if (active) {
      float sc[32], sl[32];
      pipe.qk(qa, s, sc, sl);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] += sl[i];
      pipe.pv(sc, s, min(Pipe::BKV / 8, (p.n - j * Pipe::BKV + 7) / 8),
              o_hi, o_lo);
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(&pipe.empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    if (row >= p.n) continue;
    float* dst = p.out + ((long long)bh * p.n + row) * DH + 2 * t;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
      *reinterpret_cast<float2*>(dst + 8 * nb) = make_float2(
          (o_hi[4 * nb + 2 * r] + o_lo[4 * nb + 2 * r]) * p.scale,
          (o_hi[4 * nb + 2 * r + 1] + o_lo[4 * nb + 2 * r + 1]) * p.scale);
  }
}

template <int DH>
int launch_wgmma(const float* q, const float* k, const float* v, float* out,
                 int bh, int n, float scale, cudaStream_t stream) {
  using Pipe = tf32x3::Pipe<DH>;
  static std::atomic<unsigned long long> sized{0};
  const cudaError_t err =
      tf32x3::size_smem_once(stdp_kernel_wgmma<DH>, Pipe::SMEM, sized);
  if (err != cudaSuccess) return (int)err;
  // (Dh, N, BH, 1) maps, boxes of Dh + 4 columns (zeros past Dh)
  CUtensorMap mq, mk, mv;
  WgParams prm;
  constexpr auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr auto FLAT = CU_TENSOR_MAP_SWIZZLE_NONE;
  const long long s_bh = (long long)n * DH;
  if (!tma::make_map(&mq, F32, 4, FLAT, q, DH, DH + 4, n, bh, 1, DH, s_bh,
                     s_bh * bh, Pipe::BQ, prm.dim) ||
      !tma::make_map(&mk, F32, 4, FLAT, k, DH, DH + 4, n, bh, 1, DH, s_bh,
                     s_bh * bh, Pipe::BKV, prm.dim) ||
      !tma::make_map(&mv, F32, 4, FLAT, v, DH, DH + 4, n, bh, 1, DH, s_bh,
                     s_bh * bh, Pipe::BKV, prm.dim))
    return (int)cudaErrorInvalidValue;
  prm.n = n;
  prm.n_qtiles = (n + Pipe::BQ - 1) / Pipe::BQ;
  prm.scale = scale;
  prm.out = out;
  stdp_kernel_wgmma<DH><<<prm.n_qtiles * bh, WG_THREADS, Pipe::SMEM,
                          stream>>>(mq, mk, mv, prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, k, v, out: (BH, N, Dh) f32 contiguous, 1 <= Dh <= MAX_DH,
// BH <= 65535.
extern "C" int stdp_launch(const float* q, const float* k, const float* v,
                           float* out, int bh, int n, int dh, float scale,
                           void* stream) {
  if (bh == 0 || n == 0) return 0;
  if (dh < 1 || dh > MAX_DH || bh > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (dh == 32 && aligned)
    return launch_wgmma<32>(q, k, v, out, bh, n, scale, s);
  if (dh == 64 && aligned)
    return launch_wgmma<64>(q, k, v, out, bh, n, scale, s);
  const int blocks8 = (dh + 7) / 8;
  if (blocks8 <= 1) return launch<1>(q, k, v, out, bh, n, dh, scale, s);
  if (blocks8 <= 2) return launch<2>(q, k, v, out, bh, n, dh, scale, s);
  if (blocks8 <= 4) return launch<4>(q, k, v, out, bh, n, dh, scale, s);
  if (blocks8 <= 8) return launch<8>(q, k, v, out, bh, n, dh, scale, s);
  return launch<16>(q, k, v, out, bh, n, dh, scale, s);
}
