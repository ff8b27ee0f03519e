// Flash attention on the tensor cores: bf16 q, k, v, f32 output, causal or
// not, grouped-query heads and strided operands.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention for bf16 operands (f32 operands run csrc/flash_attention.cu
// in split TF32). q: (B, Hq, Nq, Dh); k, v: (B, KV, Nkv, Dh), Hq a
// multiple of KV, q head h reading KV head h / (Hq / KV); any strides with
// a unit last stride. Query row i sits at position Nkv - Nq + i, key j at
// position j. Per KV tile, as the reference: s = q . k in f32 times scale,
// masked entries set to NEG_INF = -1e30 (not -inf), m_new = max(m, rowmax
// s), alpha = exp(m - m_new), p = exp(s - m_new), l = l * alpha + rowsum p,
// acc = acc * alpha + p v; out = acc / max(l, 1e-30). KV tiles ascend,
// keys past Nkv are masked in both modes. The reference scales q before the
// dot; here the f32 scores are scaled after it (identical for a power-of-two
// scale, within an ulp otherwise).
//
// Bound on this card: at smollm's prefill (15 heads, 2048 tokens, Dh 64)
// the causal product is ~8e9 operations for ~20 MB moved, far above the
// bf16 tensor cores' ridge (~295 operations a byte): the least time is the
// operations' at 989 TFLOP/s. At DeepSeek-V4-Flash's (64 heads over 1,
// 2048 tokens, Dh 512) 2.75e11 operations take 0.278 ms.
// Numerics: q k^T takes the bf16 values exactly (products exact, f32
// accumulators). p is an f32 weight in [0, 1]; rounding it to bf16 for
// p v would cost up to 2^-9 relative, beyond the 2e-4 the kernel is held
// to, so p is split as p_hi = bf16(p), p_lo = bf16(p - p_hi) (together
// within 2^-17 of p) and both are multiplied into the same accumulators.
// v is bf16 already, so p v loses nothing more. expf (not __expf), no
// fast-math flags.
// Design: one block of three warpgroups per (128-query tile, batch, head);
// blocks with the longest causal rows launch first. Warpgroup 2 is the
// producer: one thread loads the Q tile once and then K and V tiles of 64
// keys by TMA (128-byte swizzle) into a ring of STAGES stages, completion
// on an mbarrier per stage, and waits on the stage's "empty" mbarrier
// before it reuses it. Warpgroups 0 and 1 each own 64 query rows: per KV
// tile, S = Q K^T by wgmma (m64n64k16, both operands in shared memory),
// the online softmax on the accumulator fragments in registers with quad
// shuffles for the row max and sum, then O += P V by wgmma with P in
// registers (the accumulator fragment is the A fragment's layout) and V in
// shared memory. Causal blocks stop at the last tile their last query
// sees, and a warpgroup skips the tiles wholly above its own rows (both
// would add exact zeros); only tiles that cross the diagonal or Nkv are
// masked. Dh is tiled in NH = ceil(Dh / 64) boxes of 64 columns, and TMA
// fills the columns past Dh with zeros (which add exact zeros to S and
// are never stored): Dh 32 is one half-filled box, Dh 64 one, Dh 128 two,
// Dh 160 (stablelm-12b) three, the last half filled, Dh 256 (Qwen3-Next)
// four. Any Dh that is a multiple of 8 (TMA's 16-byte row stride) up to
// 256 runs. The ring has three stages up to NH 3 (1 KiB + 3 x (2 + 2 x 3)
// x 8 KiB = 193 KiB of shared memory at NH 3) and two at NH 4 (1 KiB + 4 x
// (2 + 2 x 2) x 8 KiB = 193 KiB; three would take 257 KiB); a consumer
// thread holds NH x 32 f32 output accumulators, 128 at NH 4, beside S and
// the split P.
// Past Dh 256 (DeepSeek-V4's 512, sarvam-105b's 576, any multiple of 8):
// flash_tc_kernel_sliced<NC>. A consumer thread cannot hold more than 128
// output accumulators, and at Dh 512 the 128-row q tile alone is 128 KiB,
// so Dh's nb = ceil(Dh / 64) boxes are cut into n_slices = ceil(nb / 4)
// column slices of NC = ceil(nb / n_slices) boxes (3 or 4), one block a
// (slice, 128-query tile, head), the slices of a tile side by side in the
// grid. Each block takes S = Q K^T over all nb boxes: its producer streams
// q and K box by box (q in slots of 128 rows x 64 columns, K in a ring of
// 4 boxes), and V only the slice's boxes (2 stages). q stays in its slots
// for the whole block where its boxes fit (up to Dh 512 at NC 4, 576 at NC
// 3: ~225 KiB of shared memory); past that it is loaded again every KV
// tile. A consumer warpgroup frees each box's slots as soon as its wgmma
// group is done, with the next box's group already issued. Work factor
// against the bound's two products: n_slices S products plus P V in two
// bf16 terms over n_slices x NC boxes, (n_slices + 2) / 2 where the boxes
// divide evenly: 2.0 at Dh 512 (2 slices), 2.5 at 576 (3 slices of 3), 3
// at 1024, 5 at 2048 (the design up to 256 is at 1.5).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_addr;
using tma::tma_load_4d;

constexpr int BQ = 128, BKV = 64, THREADS = 384;
constexpr int TILE_BYTES = 64 * 128;   // 64 rows of 64 bf16
constexpr float NEG_INF = -1e30f;

// --- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor of a tile written by TMA with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (both offsets
// set to 1024 bytes: K-major tiles ignore the leading one, and the MN-major
// V tile spans a single 64-column atom).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64x64 f32) (+)= A (64x16, K-major in shared memory) * B (16x64, K-major
// in shared memory, i.e. the 64x16 tile of K rows)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64x64 f32) += A (64x16 bf16 in registers) * B (16x64, MN-major in
// shared memory: 16 V rows of 64 columns)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

struct Params {
  int heads, group, nq, nkv, dh, n_qtiles, n_bh;
  int dim_q[3], dim_kv[3];   // TMA dimension of (row, head, batch)
  float scale;
  int causal;
  float* out;   // (B, Hq, Nq, Dh) f32, contiguous
};

// NH 64-column boxes of Dh, a ring of STAGES stages
template <int NH, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern and the descriptors assume it
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                                     // NH x BQ rows
  uint8_t* k_s = q_s + NH * 2 * TILE_BYTES;                // STAGES x NH
  uint8_t* v_s = k_s + STAGES * NH * TILE_BYTES;           // STAGES x NH
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + STAGES * NH * TILE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;

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
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int cq[4] = {0, 0, 0, 0}, ckv[4] = {0, 0, 0, 0};
      cq[p.dim_q[0]] = q0;
      cq[p.dim_q[1]] = h;
      cq[p.dim_q[2]] = b;
      ckv[p.dim_kv[1]] = kvh;
      ckv[p.dim_kv[2]] = b;
      mbar_expect_tx(q_bar, NH * 2 * TILE_BYTES);
      for (int c = 0; c < NH; ++c) {
        cq[0] = c * 64;
        tma_load_4d(q_s + c * 2 * TILE_BYTES, &map_q, q_bar, cq[0], cq[1],
                    cq[2], cq[3]);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * NH * TILE_BYTES);
        ckv[p.dim_kv[0]] = j * BKV;
        for (int c = 0; c < NH; ++c) {
          ckv[0] = c * 64;
          tma_load_4d(k_s + (s * NH + c) * TILE_BYTES, &map_k, &full[s],
                      ckv[0], ckv[1], ckv[2], ckv[3]);
          tma_load_4d(v_s + (s * NH + c) * TILE_BYTES, &map_v, &full[s],
                      ckv[0], ckv[1], ckv[2], ckv[3]);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid % 32, warp = (tid / 32) % 4;
    const int r0 = 64 * wg + 16 * warp + lane / 4;   // rows r0 and r0 + 8
    const int wg_q0 = q0 + 64 * wg;
    const int wg_end =
        wg_q0 >= p.nq ? 0
                      : (p.causal ? min(p.nkv, q_offset + min(wg_q0 + 64, p.nq))
                                  : p.nkv);
    const int my_tiles = (wg_end + BKV - 1) / BKV;

    float o[NH][32];
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

    mbar_wait(q_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      if (j < my_tiles) {
        // S = Q K^T over Dh in k16 steps
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da =
                smem_desc(q_s + c * 2 * TILE_BYTES + wg * TILE_BYTES + kk * 32);
            const uint64_t db =
                smem_desc(k_s + (s * NH + c) * TILE_BYTES + kk * 32);
            wgmma_ss(sc, da, db, c + kk > 0);
          }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale, then mask the tiles that cross the diagonal or Nkv
        const int k0 = j * BKV;
        const bool edge = k0 + BKV > p.nkv ||
                          (p.causal && k0 + BKV - 1 > q_offset + wg_q0);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = sc[i] * p.scale;
          if (edge) {
            const int kpos = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
            const int qpos = q_offset + q0 + r0 + ((i / 2) % 2) * 8;
            if (kpos >= p.nkv || (p.causal && kpos > qpos)) x = NEG_INF;
          }
          sc[i] = x;
        }

        // online softmax, rows r0 (i % 4 < 2) and r0 + 8 (i % 4 >= 2);
        // the four lanes of a quad hold a row's 64 keys
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
        for (int c = 0; c < NH; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i / 2) % 2];

        // P as bf16 A fragments, split hi + lo: keys 16kk.. are the
        // accumulator's n8 blocks 2kk and 2kk + 1
        uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            const float2 hf = __bfloat1622float2(hi);
            p_hi[kk][e] = pack_bf16(hi);
            p_lo[kk][e] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x,
                                                          x1 - hf.y));
          }

        // O += P V: 16 keys (16 rows of 128 bytes) per k16 step
#pragma unroll
        for (int c = 0; c < NH; ++c) fence_regs(o[c]);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t db =
                smem_desc(v_s + (s * NH + c) * TILE_BYTES + kk * 16 * 128);
            wgmma_rs(o[c], p_hi[kk], db);
            wgmma_rs(o[c], p_lo[kk], db);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NH; ++c) fence_regs(o[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // out = acc / max(l, 1e-30), rows inside Nq, columns inside Dh
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + r0 + 8 * r;
      if (qi >= p.nq) continue;
      const float inv_l = 1.f / fmaxf(l_run[r], 1e-30f);
      float* row = p.out + ((long long)bh * p.nq + qi) * p.dh;
#pragma unroll
      for (int c = 0; c < NH; ++c)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int col = c * 64 + nb * 8 + (lane % 4) * 2;
          if (col < p.dh) {
            const float2 val = make_float2(o[c][4 * nb + 2 * r] * inv_l,
                                           o[c][4 * nb + 2 * r + 1] * inv_l);
            *reinterpret_cast<float2*>(row + col) = val;
          }
        }
    }
  }
}

// --- Dh above 256: column slices ---------------------------------------------
// A slice is NC 64-column boxes of the output; the block owns one slice of
// one 128-query tile and takes S = Q K^T over all nb boxes of Dh, q and K
// coming box by box through rings. q stays in its ring for the whole block
// where its nb boxes fit there ("resident", up to Dh 512 at NC 4 and 576
// at NC 3); otherwise it is loaded again for every KV tile.
constexpr size_t SMEM_LIMIT = 232448;   // the H100's shared memory a block
constexpr int SLICE_KS = 4, SLICE_VS = 2;   // K boxes, V stages of NC boxes

template <int NC>
struct SliceSmem {
  static constexpr int QS =   // q slots of 128 rows x 64 columns
      (int)((SMEM_LIMIT - 1024 - 256 - SLICE_KS * TILE_BYTES -
             SLICE_VS * NC * TILE_BYTES) /
            (2 * TILE_BYTES));
  static constexpr size_t SMEM =
      1024 + (size_t)(2 * QS + SLICE_KS + SLICE_VS * NC) * TILE_BYTES +
      (2 * QS + 2 * SLICE_KS + 2 * SLICE_VS) * sizeof(uint64_t);
  static_assert(SMEM <= SMEM_LIMIT, "over shared memory");
};

struct SliceParams {
  Params p;
  int n_slices;   // blocks a (query tile, head), one output slice each
  int nb;         // 64-column boxes of Dh, all of which S sums over
  int resident;   // nb <= QS: q is loaded once a block
};

template <int NC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel_sliced(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const SliceParams sp) {
  constexpr int QS = SliceSmem<NC>::QS, KS = SLICE_KS, VS = SLICE_VS;
  const Params& p = sp.p;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                            // QS x 128 rows
  uint8_t* k_s = q_s + QS * 2 * TILE_BYTES;       // KS x 64 keys
  uint8_t* v_s = k_s + KS * TILE_BYTES;           // VS x NC x 64 keys
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + VS * NC * TILE_BYTES);
  uint64_t* q_empty = q_full + QS;
  uint64_t* k_full = q_empty + QS;
  uint64_t* k_empty = k_full + KS;
  uint64_t* v_full = k_empty + KS;
  uint64_t* v_empty = v_full + VS;

  // the slices of one (query tile, head) are neighbours, longest causal
  // rows first
  const int slice = blockIdx.x % sp.n_slices;
  const int rest = blockIdx.x / sp.n_slices;
  const int bh = rest % p.n_bh;
  const int qt = p.n_qtiles - 1 - rest / p.n_bh;
  const int b = bh / p.heads, h = bh % p.heads, kvh = h / p.group;
  const int q0 = qt * BQ;
  const int q_offset = p.nkv - p.nq;
  const int kv_end = p.causal ? min(p.nkv, q_offset + min(q0 + BQ, p.nq))
                              : p.nkv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int nb = sp.nb, box0 = slice * NC;
  const int nc = min(NC, nb - box0);   // the slice's boxes inside Dh
  const bool resident = sp.resident;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < QS; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);   // one arrival per consumer warp
    }
    for (int s = 0; s < KS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 8);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---------------- producer: box n = j nb + c is (KV tile j, box c) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int cq[4] = {0, 0, 0, 0}, ckv[4] = {0, 0, 0, 0};
      cq[p.dim_q[0]] = q0;
      cq[p.dim_q[1]] = h;
      cq[p.dim_q[2]] = b;
      ckv[p.dim_kv[1]] = kvh;
      ckv[p.dim_kv[2]] = b;
      for (int j = 0; j < n_tiles; ++j) {
        ckv[p.dim_kv[0]] = j * BKV;
        for (int c = 0; c < nb; ++c) {
          const int n = j * nb + c;
          if (!resident || j == 0) {
            const int s = resident ? c : n % QS, u = resident ? 0 : n / QS;
            if (u > 0) mbar_wait(&q_empty[s], (u - 1) & 1);
            mbar_expect_tx(&q_full[s], 2 * TILE_BYTES);
            cq[0] = c * 64;
            tma_load_4d(q_s + s * 2 * TILE_BYTES, &map_q, &q_full[s], cq[0],
                        cq[1], cq[2], cq[3]);
          }
          const int s = n % KS, u = n / KS;
          if (u > 0) mbar_wait(&k_empty[s], (u - 1) & 1);
          mbar_expect_tx(&k_full[s], TILE_BYTES);
          ckv[0] = c * 64;
          tma_load_4d(k_s + s * TILE_BYTES, &map_k, &k_full[s], ckv[0],
                      ckv[1], ckv[2], ckv[3]);
        }
        // V: the slice's boxes inside Dh (the others are never stored)
        const int s = j % VS, u = j / VS;
        if (u > 0) mbar_wait(&v_empty[s], (u - 1) & 1);
        mbar_expect_tx(&v_full[s], nc * TILE_BYTES);
        for (int c = 0; c < nc; ++c) {
          ckv[0] = (box0 + c) * 64;
          tma_load_4d(v_s + (s * NC + c) * TILE_BYTES, &map_v, &v_full[s],
                      ckv[0], ckv[1], ckv[2], ckv[3]);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid % 32, warp = (tid / 32) % 4;
    const int r0 = 64 * wg + 16 * warp + lane / 4;   // rows r0 and r0 + 8
    const int wg_q0 = q0 + 64 * wg;
    const int wg_end =
        wg_q0 >= p.nq ? 0
                      : (p.causal ? min(p.nkv, q_offset + min(wg_q0 + 64, p.nq))
                                  : p.nkv);
    const int my_tiles = (wg_end + BKV - 1) / BKV;

    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

    // the warp is done with box n: free its q (when streamed) and K slots
    auto release = [&](int n) {
      __syncwarp();
      if (lane == 0) {
        if (!resident) mbar_arrive(&q_empty[n % QS]);
        mbar_arrive(&k_empty[n % KS]);
      }
    };

    for (int j = 0; j < n_tiles; ++j) {
      // a warpgroup's tiles wholly above its rows: only free the slots
      if (j >= my_tiles) {
        for (int c = 0; c < nb; ++c) {
          const int n = j * nb + c;
          mbar_wait(&q_full[resident ? c : n % QS],
                    resident ? 0 : (n / QS) & 1);
          mbar_wait(&k_full[n % KS], (n / KS) & 1);
          release(n);
        }
        mbar_wait(&v_full[j % VS], (j / VS) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(&v_empty[j % VS]);
        continue;
      }
      // S = Q K^T over Dh, box by box; a box's wgmma group runs while the
      // next one is issued, and its slots are freed once it is done. (sc
      // is not zeroed: the first wgmma does not read it, and writing it
      // here made ptxas serialize the wgmmas.)
      float sc[32];
      for (int c = 0; c < nb; ++c) {
        const int n = j * nb + c;
        const int qs = resident ? c : n % QS, ks = n % KS;
        mbar_wait(&q_full[qs], resident ? 0 : (n / QS) & 1);
        mbar_wait(&k_full[ks], (n / KS) & 1);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc,
                   smem_desc(q_s + qs * 2 * TILE_BYTES + wg * TILE_BYTES +
                             kk * 32),
                   smem_desc(k_s + ks * TILE_BYTES + kk * 32), c + kk > 0);
        wgmma_commit();
        fence_regs(sc);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (c > 0) release(n - 1);
      }
      wgmma_wait_all();
      fence_regs(sc);
      release(j * nb + nb - 1);

      uint32_t p_hi[4][4], p_lo[4][4];
      {
        // scale, then mask the tiles that cross the diagonal or Nkv
        const int k0 = j * BKV;
        const bool edge = k0 + BKV > p.nkv ||
                          (p.causal && k0 + BKV - 1 > q_offset + wg_q0);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = sc[i] * p.scale;
          if (edge) {
            const int kpos = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
            const int qpos = q_offset + q0 + r0 + ((i / 2) % 2) * 8;
            if (kpos >= p.nkv || (p.causal && kpos > qpos)) x = NEG_INF;
          }
          sc[i] = x;
        }

        // online softmax, rows r0 (i % 4 < 2) and r0 + 8 (i % 4 >= 2);
        // the four lanes of a quad hold a row's 64 keys
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
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i / 2) % 2];

        // P as bf16 A fragments, split hi + lo
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            const float2 hf = __bfloat1622float2(hi);
            p_hi[kk][e] = pack_bf16(hi);
            p_lo[kk][e] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x,
                                                          x1 - hf.y));
          }
      }

      // O += P V over the slice's boxes (those past Dh take whatever their
      // stage holds: their columns are never stored)
      const int vs = j % VS;
      mbar_wait(&v_full[vs], (j / VS) & 1);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db =
              smem_desc(v_s + (vs * NC + c) * TILE_BYTES + kk * 16 * 128);
          wgmma_rs(o[c], p_hi[kk], db);
          wgmma_rs(o[c], p_lo[kk], db);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[vs]);
    }

    // out = acc / max(l, 1e-30), rows inside Nq, the slice's columns
    // inside Dh
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + r0 + 8 * r;
      if (qi >= p.nq) continue;
      const float inv_l = 1.f / fmaxf(l_run[r], 1e-30f);
      float* row = p.out + ((long long)bh * p.nq + qi) * p.dh;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int nb8 = 0; nb8 < 8; ++nb8) {
          const int col = (box0 + c) * 64 + nb8 * 8 + (lane % 4) * 2;
          if (col < p.dh) {
            const float2 val = make_float2(o[c][4 * nb8 + 2 * r] * inv_l,
                                           o[c][4 * nb8 + 2 * r + 1] * inv_l);
            *reinterpret_cast<float2*>(row + col) = val;
          }
        }
    }
  }
}

// Dh above 256: nb boxes of 64 columns in n_slices = ceil(nb / 4) slices of
// NC = ceil(nb / n_slices) boxes (3 or 4), the last slice's boxes past Dh
// left out
int launch_sliced(const CUtensorMap& mq, const CUtensorMap& mk,
                  const CUtensorMap& mv, const Params& prm,
                  cudaStream_t stream) {
  SliceParams sp;
  sp.p = prm;
  sp.nb = (prm.dh + 63) / 64;
  sp.n_slices = (sp.nb + 3) / 4;
  const int nc = (sp.nb + sp.n_slices - 1) / sp.n_slices;
  sp.resident = sp.nb <= (nc == 4 ? SliceSmem<4>::QS : SliceSmem<3>::QS);
  const size_t smem = nc == 4 ? SliceSmem<4>::SMEM : SliceSmem<3>::SMEM;
  auto kernel = nc == 4 ? flash_tc_kernel_sliced<4>
                        : flash_tc_kernel_sliced<3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)prm.n_qtiles * prm.n_bh * sp.n_slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(mq, mk, mv, sp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q: (batch, heads, nq, dh) bf16 with element strides (qs_b, qs_h, qs_r, 1);
// k, v: (batch, kv_heads, nkv, dh) bf16, strides (ks_*, 1) and (vs_*, 1);
// every stride a multiple of 8 and every base 16-byte aligned (TMA); heads a
// multiple of kv_heads; dh a multiple of 8, at least 8; nkv >= 1, nq <= nkv
// when causal. out: (batch, heads, nq, dh) f32, contiguous.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, float* out, int batch,
    int heads, int kv_heads, int nq, int nkv, int dh, long long qs_b,
    long long qs_h, long long qs_r, long long ks_b, long long ks_h,
    long long ks_r, long long vs_b, long long vs_h, long long vs_r,
    float scale, int causal, void* stream) {
  if (batch == 0 || heads == 0 || nq == 0) return 0;
  if (dh < 8 || dh % 8 || kv_heads <= 0 || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  Params prm;
  int dim_v[3];
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tma::make_map(&mq, BF16, 2, SW128, q, dh, 64, nq, heads, batch, qs_r,
                     qs_h, qs_b, BQ, prm.dim_q) ||
      !tma::make_map(&mk, BF16, 2, SW128, k, dh, 64, nkv, kv_heads, batch,
                     ks_r, ks_h, ks_b, BKV, prm.dim_kv) ||
      !tma::make_map(&mv, BF16, 2, SW128, v, dh, 64, nkv, kv_heads, batch,
                     vs_r, vs_h, vs_b, BKV, dim_v))
    return (int)cudaErrorInvalidValue;
  // k and v share one coordinate order (the wrapper gives them one layout)
  for (int i = 0; i < 3; ++i)
    if (dim_v[i] != prm.dim_kv[i]) return (int)cudaErrorInvalidValue;
  prm.heads = heads;
  prm.group = heads / kv_heads;
  prm.nq = nq;
  prm.nkv = nkv;
  prm.dh = dh;
  prm.n_qtiles = (nq + BQ - 1) / BQ;
  prm.n_bh = batch * heads;
  prm.scale = scale;
  prm.causal = causal;
  prm.out = out;
  if (dh > 256) return launch_sliced(mq, mk, mv, prm, (cudaStream_t)stream);
  const int nh = (dh + 63) / 64;
  const int stages = nh == 4 ? 2 : 3;
  const size_t smem = 1024 + (size_t)nh * (2 + 2 * stages) * TILE_BYTES +
                      (2 * stages + 1) * sizeof(uint64_t);
  auto kernel = nh == 4   ? flash_tc_kernel<4, 2>
                : nh == 3 ? flash_tc_kernel<3, 3>
                : nh == 2 ? flash_tc_kernel<2, 3>
                          : flash_tc_kernel<1, 3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)prm.n_qtiles * prm.n_bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(mq, mk, mv,
                                                                    prm);
  return (int)cudaGetLastError();
}
