// Flash attention: softmax attention with an online softmax over KV tiles,
// causal or not, f32 q, k, v, f32 output, grouped-query heads and strided
// operands, on the tensor cores in split TF32 (csrc/tf32x3.cuh).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention for f32 operands (bf16 operands run
// csrc/flash_attention_tc.cu). q: (B, Hq, Nq, Dh); k, v: (B, KV, Nkv, Dh),
// Hq a multiple of KV, q head h reading KV head h / (Hq / KV); any strides
// with a unit last stride, every stride a multiple of 4 elements and every
// base 16-byte aligned (TMA). Query row i sits at position Nkv - Nq + i, key
// j at position j. Per KV tile, as the reference: s = (q * scale) . k (q
// scaled in f32 before the dot), masked entries set to NEG_INF = -1e30 (not
// -inf), m_new = max(m, rowmax s), alpha = exp(m - m_new), p = exp(s -
// m_new), l = l * alpha + rowsum p, acc = acc * alpha + p v; out = acc /
// max(l, 1e-30). Keys past Nkv are masked in both modes (the reference's
// wrapper refuses the non-causal case with KV padding; this kernel masks
// it, which is the exact softmax of flash_attention_ref).
//
// Bound on this card: at smollm's prefill shape (15 heads, 2048 tokens, Dh
// 64) the causal product is 8.06e9 operations for 31 MB of f32 moved. As
// three TF32 products they take 0.0489 ms at 495 TFLOP/s; the bytes take
// 0.0094 ms; the f32 units (67 TFLOP/s) would need 0.1203 ms.
// Numerics: both products are 3xTF32 with two accumulators each: S from
// the split q * scale and k, P V from the split p and v. The sums keep
// ~2^-21 of each product, well inside the 2e-4 the kernel is held to. expf
// (not __expf), no fast-math flags.
// Design (the skeleton of csrc/flash_attention_tc.cu): one block of three
// warpgroups per (query tile, batch, head); blocks with the longest
// causal rows launch first. Warpgroup 2 is the producer: one thread loads
// the Q tile once and then K and V tiles of 64 keys by TMA, completion on
// mbarriers; each box has padded rows (TMA zero-fills the columns past Dh).
// The consumer warpgroups 0 and 1 scale the q tile in place once, and
// per KV tile compute S = Q K^T, mask the blocks that cross the
// diagonal or Nkv, run the online softmax on the accumulator fragments
// with quad shuffles for the row max and sum, and accumulate O += P V with
// P straight from the S fragments. Tiles wholly above a consumer's
// diagonal are skipped (they would add exact zeros). Two designs share
// this, by head dim:
// - Dh 32 and 64 (smollm's 64): flash_attention_kernel_wgmma, the block
//   pipeline of tf32x3::Pipe: the producer warpgroup also splits each K
//   and V tile once into big and small K and V^T, which 3xTF32 wgmma
//   products read from shared memory.
// - Dh 128 and 160 (stablelm-12b's 160): flash_attention_kernel,
//   mma.sync over fragments each warp splits in registers (the split K and
//   V^T of 64 keys would not fit in shared memory beside the ring); the K
//   and V tiles come through a ring of two stages, with rows of Dh + 8
//   (q, k) and Dh + 4 (v) floats that keep every fragment load free of
//   bank conflicts, and each warp skips the 8-key blocks wholly above its
//   own rows. At Dh 160 a block takes 64 query rows, and the two warps of
//   each 16 rows both compute S and its softmax (the same values) and
//   each accumulate half of Dh's output columns: with 128 rows the q tile
//   and two stages (255 KB) would not fit the 227 KB a block has, and a
//   warp's 2 x 160 split accumulators would not fit its registers. The
//   cost is S taken twice: 1.5 times Dh 128's products a column.
// The shared-memory size is set once a device, not at every launch.
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
using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_addr;
using tma::tma_load_4d;

constexpr int BQ = 128, BKV = 64, KB = BKV / 8, THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG_INF = -1e30f;

struct Params {
  int heads, group, nq, nkv, n_qtiles, n_bh;
  int dim_q[3], dim_kv[3];   // TMA dimension of (row, head, batch)
  float scale;
  int causal;
  float* out;   // (B, Hq, Nq, Dh) f32, contiguous
};

// ---------------------------------------------------------------------------
// Dh 128: mma.sync over fragments split in registers
// ---------------------------------------------------------------------------

template <int DH>
struct Layout {
  static constexpr int DB = DH / 8;
  // Dh 128: the block's 128 query rows, 16 a consumer warp. Dh 160: 64
  // rows, each 16 shared by two warps that own half of Dh's output
  // columns each (both take the whole S): 128 rows would not fit two
  // stages in shared memory, nor Dh 160's accumulators in registers.
  static constexpr int SPLIT = DH > 128 ? 2 : 1;
  static constexpr int ROWS = 128 / SPLIT;
  static constexpr int DBW = DB / SPLIT;   // a warp's 8-column output blocks
  static constexpr int STAGES = 2;
  // row strides in floats: 8 (q, k) and 4 (v) past a multiple of 32
  static constexpr int QS = DH + 8, KS = DH + 8, VS = DH + 4;
  static constexpr uint32_t Q_BYTES = ROWS * QS * 4;
  static constexpr uint32_t K_BYTES = BKV * KS * 4;
  static constexpr uint32_t V_BYTES = BKV * VS * 4;
  static constexpr size_t SMEM = 128 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) +
                                 (2 * STAGES + 1) * sizeof(uint64_t);
  static_assert(DB % SPLIT == 0 && ROWS / 16 * SPLIT == CONSUMER_WARPS,
                "every consumer warp owns 16 rows and DB / SPLIT blocks");
  static_assert(SMEM <= 232448, "over the H100's shared memory a block");
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const Params p) {
  using L = Layout<DH>;
  constexpr int DB = L::DB, DBW = L::DBW, ROWS = L::ROWS, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // TMA writes shared memory at 128-byte aligned addresses
  uint8_t* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  float* q_s = reinterpret_cast<float*>(base);
  uint8_t* k_ring = base + L::Q_BYTES;
  uint8_t* v_ring = k_ring + STAGES * L::K_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_ring + STAGES * L::V_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;

  // longest causal rows first: the last query tiles of every head lead
  const int bh = blockIdx.x % p.n_bh;
  const int qt = p.n_qtiles - 1 - blockIdx.x / p.n_bh;
  const int b = bh / p.heads, h = bh % p.heads, kvh = h / p.group;
  const int q0 = qt * ROWS;
  const int q_offset = p.nkv - p.nq;
  const int kv_end = p.causal ? min(p.nkv, q_offset + min(q0 + ROWS, p.nq))
                              : p.nkv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);   // one arrival a consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int cq[4] = {0, 0, 0, 0}, ckv[4] = {0, 0, 0, 0};
      cq[p.dim_q[0]] = q0;
      cq[p.dim_q[1]] = h;
      cq[p.dim_q[2]] = b;
      ckv[p.dim_kv[1]] = kvh;
      ckv[p.dim_kv[2]] = b;
      mbar_expect_tx(q_bar, L::Q_BYTES);
      tma_load_4d(q_s, &map_q, q_bar, cq[0], cq[1], cq[2], cq[3]);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::K_BYTES + L::V_BYTES);
        ckv[p.dim_kv[0]] = j * BKV;
        tma_load_4d(k_ring + s * L::K_BYTES, &map_k, &full[s], ckv[0],
                    ckv[1], ckv[2], ckv[3]);
        tma_load_4d(v_ring + s * L::V_BYTES, &map_v, &full[s], ckv[0],
                    ckv[1], ckv[2], ckv[3]);
      }
    }
    return;
  }

  // ---------------- consumers: 16 query rows a warp ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 16 * (warp % (ROWS / 16));   // the warp's rows in the tile
  const int col0 = 8 * DBW * (warp / (ROWS / 16));   // its output columns
  const int wq0 = q0 + row0;     // its first query
  const int w_end =
      wq0 >= p.nq ? 0
                  : (p.causal ? min(p.nkv, q_offset + min(wq0 + 16, p.nq))
                              : p.nkv);
  const int my_tiles = (w_end + BKV - 1) / BKV;

  mbar_wait(q_bar, 0);
  for (int e = tid; e < ROWS * DH; e += 256) {   // q * scale, once
    float* x = q_s + (e / DH) * L::QS + e % DH;
    *x *= p.scale;
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");   // the consumers
  const float* qa = q_s + (row0 + g) * L::QS + 2 * t;

  float o_hi[DBW][4], o_lo[DBW][4];
#pragma unroll
  for (int nd = 0; nd < DBW; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_hi[nd][i] = o_lo[nd][i] = 0.f;
  // rows g (fragment entries 0, 1) and g + 8 (entries 2, 3)
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    if (j < my_tiles) {
      const float* ks =
          reinterpret_cast<const float*>(k_ring + s * L::K_BYTES);
      const float* vs =
          reinterpret_cast<const float*>(v_ring + s * L::V_BYTES);
      const int k0 = j * BKV;
      const int nkb = min(KB, (w_end - k0 + 7) / 8);   // live 8-key blocks

      // S = (q * scale) K^T: columns 2t, 2t + 1 of each 8-column step are
      // its k = t, t + 4 for both operands
      float sc[KB][4];
      {
        float s_lo[KB][4];
#pragma unroll
        for (int nb = 0; nb < KB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nb][i] = s_lo[nb][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DB; ++kk) {
          const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kk);
          const float2 x1 =
              *reinterpret_cast<const float2*>(qa + 8 * L::QS + 8 * kk);
          FragA a;
          a.set(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
          for (int nb = 0; nb < KB; ++nb)
            if (nb < nkb) {
              const float2 y = *reinterpret_cast<const float2*>(
                  ks + (8 * nb + g) * L::KS + 8 * kk + 2 * t);
              FragB bf;
              bf.set(y.x, y.y);
              mma3(sc[nb], s_lo[nb], a, bf);
            }
        }
        // add the corrections; mask the blocks that cross the diagonal or
        // Nkv, and the skipped ones
        const bool edge = k0 + BKV > p.nkv ||
                          (p.causal && k0 + BKV - 1 > q_offset + wq0);
#pragma unroll
        for (int nb = 0; nb < KB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = sc[nb][i] + s_lo[nb][i];
            if (nb >= nkb) {
              x = NEG_INF;
            } else if (edge) {
              const int kpos = k0 + 8 * nb + 2 * t + (i & 1);
              const int qpos = q_offset + wq0 + g + 8 * (i >> 1);
              if (kpos >= p.nkv || (p.causal && kpos > qpos)) x = NEG_INF;
            }
            sc[nb][i] = x;
          }
      }

      // online softmax; the four lanes of a quad hold a row's 64 keys
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nb = 0; nb < KB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mx[i >> 1] = fmaxf(mx[i >> 1], sc[nb][i]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int nb = 0; nb < KB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[nb][i] = expf(sc[nb][i] - m_run[i >> 1]);
          sum[i >> 1] += sc[nb][i];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_run[r] = l_run[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int nd = 0; nd < DBW; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o_hi[nd][i] *= alpha[i >> 1];
          o_lo[nd][i] *= alpha[i >> 1];
        }

      // O += P V: the accumulator's keys 2t, 2t + 1 are the A fragment's
      // k = t, t + 4, so V's rows 2t, 2t + 1 are B's
#pragma unroll
      for (int nb = 0; nb < KB; ++nb)
        if (nb < nkb) {
          FragA a;
          a.set(sc[nb][0], sc[nb][2], sc[nb][1], sc[nb][3]);
          const float* v0 = vs + (8 * nb + 2 * t) * L::VS + col0 + g;
#pragma unroll
          for (int nd = 0; nd < DBW; ++nd) {
            FragB bf;
            bf.set(v0[8 * nd], v0[L::VS + 8 * nd]);
            mma3(o_hi[nd], o_lo[nd], a, bf);
          }
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // out = acc / max(l, 1e-30), rows inside Nq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    if (qi >= p.nq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    float* row = p.out + ((long long)bh * p.nq + qi) * DH + col0 + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DBW; ++nd)
      *reinterpret_cast<float2*>(row + 8 * nd) =
          make_float2((o_hi[nd][2 * r] + o_lo[nd][2 * r]) / l,
                      (o_hi[nd][2 * r + 1] + o_lo[nd][2 * r + 1]) / l);
  }
}

// ---------------------------------------------------------------------------
// Dh 32 and 64: wgmma over operands split once a block (tf32x3::Pipe)
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const Params p) {
  using Pipe = tf32x3::Pipe<DH>;
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe(smem_raw);

  // longest causal rows first: the last query tiles of every head lead
  const int bh = blockIdx.x % p.n_bh;
  const int qt = p.n_qtiles - 1 - blockIdx.x / p.n_bh;
  const int b = bh / p.heads, h = bh % p.heads, kvh = h / p.group;
  const int q0 = qt * BQ;
  const int q_offset = p.nkv - p.nq;
  const int kv_end = p.causal ? min(p.nkv, q_offset + min(q0 + BQ, p.nq))
                              : p.nkv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  const int tid = threadIdx.x;
  pipe.init(tid, THREADS);
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    int cq[4] = {0, 0, 0, 0}, ckv[4] = {0, 0, 0, 0};
    cq[p.dim_q[0]] = q0;
    cq[p.dim_q[1]] = h;
    cq[p.dim_q[2]] = b;
    ckv[p.dim_kv[1]] = kvh;
    ckv[p.dim_kv[2]] = b;
    pipe.produce(&map_q, &map_k, &map_v, cq, ckv, p.dim_kv[0], n_tiles,
                 tid - 256);
    return;
  }

  // ---------------- consumers: 64 query rows a warpgroup ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int lane = tid % 32, warp = tid / 32, wg = tid / 128;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;    // the warp's rows in the tile
  const int wg_q0 = q0 + 64 * wg;
  const int wg_end =
      wg_q0 >= p.nq ? 0
                    : (p.causal ? min(p.nkv, q_offset + min(wg_q0 + 64, p.nq))
                                : p.nkv);
  const int my_tiles = (wg_end + BKV - 1) / BKV;

  tma::mbar_wait(pipe.q_bar, 0);
  for (int e = lane; e < 16 * DH; e += 32) {   // q * scale, once
    float* x = pipe.q + (row0 + e / DH) * Pipe::RS + e % DH;
    *x *= p.scale;
  }
  __syncwarp();
  const float* qa = pipe.q + (row0 + g) * Pipe::RS + t;

  float o_hi[32], o_lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_hi[i] = o_lo[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % Pipe::STAGES;
    tma::mbar_wait(&pipe.full[s], (j / Pipe::STAGES) & 1);
    if (j < my_tiles) {
      float sc[32], sl[32];
      pipe.qk(qa, s, sc, sl);

      // add the corrections; mask the tiles that cross the diagonal or Nkv
      const int k0 = j * BKV;
      const bool edge = k0 + BKV > p.nkv ||
                        (p.causal && k0 + BKV - 1 > q_offset + wg_q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] + sl[i];
        if (edge) {
          const int kpos = k0 + (i / 4) * 8 + 2 * t + (i % 2);
          const int qpos = q_offset + q0 + row0 + g + ((i / 2) % 2) * 8;
          if (kpos >= p.nkv || (p.causal && kpos > qpos)) x = NEG_INF;
        }
        sc[i] = x;
      }

      // online softmax, rows g (i % 4 < 2) and g + 8 (i % 4 >= 2); the
      // four lanes of a quad hold a row's 64 keys
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = expf(sc[i] - m_run[r]);
        sum[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_run[r] = l_run[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o_hi[i] *= alpha[(i / 2) % 2];
        o_lo[i] *= alpha[(i / 2) % 2];
      }
      pipe.pv(sc, s, BKV / 8, o_hi, o_lo);
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(&pipe.empty[s]);
  }

  // out = acc / max(l, 1e-30), rows inside Nq, columns inside Dh
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + g + 8 * r;
    if (qi >= p.nq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    float* row = p.out + ((long long)bh * p.nq + qi) * DH;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb)
      *reinterpret_cast<float2*>(row + nb * 8 + 2 * t) =
          make_float2((o_hi[4 * nb + 2 * r] + o_lo[4 * nb + 2 * r]) / l,
                      (o_hi[4 * nb + 2 * r + 1] + o_lo[4 * nb + 2 * r + 1]) /
                          l);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, std::atomic<unsigned long long>& sized,
           const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           const Params& prm, cudaStream_t stream) {
  const cudaError_t err = tf32x3::size_smem_once(kernel, smem, sized);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)prm.n_qtiles * prm.n_bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(mq, mk, mv, prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q: (batch, heads, nq, dh) f32 with element strides (qs_b, qs_h, qs_r, 1);
// k, v: (batch, kv_heads, nkv, dh) f32, strides (ks_*, 1) and (vs_*, 1), k
// and v in one order of strides; every stride a multiple of 4 and every
// base 16-byte aligned (TMA); heads a multiple of kv_heads; dh in {32, 64,
// 128, 160}; nkv >= 1, nq <= nkv when causal. out: (batch, heads, nq, dh)
// f32, contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, float* out, int batch,
    int heads, int kv_heads, int nq, int nkv, int dh, long long qs_b,
    long long qs_h, long long qs_r, long long ks_b, long long ks_h,
    long long ks_r, long long vs_b, long long vs_h, long long vs_r,
    float scale, int causal, void* stream) {
  if (batch == 0 || heads == 0 || nq == 0) return 0;
  if ((dh != 32 && dh != 64 && dh != 128 && dh != 160) || kv_heads <= 0 ||
      heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  Params prm;
  int dim_v[3];
  // unswizzled boxes of padded rows (TMA zero-fills the columns past Dh):
  // Dh + 4 columns for every operand of the wgmma kernel (Dh 32, 64);
  // Dh + 8 (q, k) and Dh + 4 (v) for the mma.sync kernel (Dh 128 in q
  // tiles of 128 rows, Dh 160 in q tiles of 64)
  constexpr auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr auto FLAT = CU_TENSOR_MAP_SWIZZLE_NONE;
  const bool mma_sync = dh > 64;
  const int qk_cols = mma_sync ? dh + 8 : dh + 4;
  const int rows = dh == 160 ? Layout<160>::ROWS : BQ;
  if (!tma::make_map(&mq, F32, 4, FLAT, q, dh, qk_cols, nq, heads, batch,
                     qs_r, qs_h, qs_b, rows, prm.dim_q) ||
      !tma::make_map(&mk, F32, 4, FLAT, k, dh, qk_cols, nkv, kv_heads, batch,
                     ks_r, ks_h, ks_b, BKV, prm.dim_kv) ||
      !tma::make_map(&mv, F32, 4, FLAT, v, dh, dh + 4, nkv, kv_heads, batch,
                     vs_r, vs_h, vs_b, BKV, dim_v))
    return (int)cudaErrorInvalidValue;
  // k and v share one coordinate order (the wrapper gives them one layout)
  for (int i = 0; i < 3; ++i)
    if (dim_v[i] != prm.dim_kv[i]) return (int)cudaErrorInvalidValue;
  prm.heads = heads;
  prm.group = heads / kv_heads;
  prm.nq = nq;
  prm.nkv = nkv;
  prm.n_qtiles = (nq + rows - 1) / rows;
  prm.n_bh = batch * heads;
  prm.scale = scale;
  prm.causal = causal;
  prm.out = out;
  const cudaStream_t s = (cudaStream_t)stream;
  static std::atomic<unsigned long long> sized[4];   // a bit a device
  if (dh == 32)
    return launch(flash_attention_kernel_wgmma<32>, tf32x3::Pipe<32>::SMEM,
                  sized[0], mq, mk, mv, prm, s);
  if (dh == 64)
    return launch(flash_attention_kernel_wgmma<64>, tf32x3::Pipe<64>::SMEM,
                  sized[1], mq, mk, mv, prm, s);
  if (dh == 128)
    return launch(flash_attention_kernel<128>, Layout<128>::SMEM, sized[2],
                  mq, mk, mv, prm, s);
  return launch(flash_attention_kernel<160>, Layout<160>::SMEM, sized[3], mq,
                mk, mv, prm, s);
}
