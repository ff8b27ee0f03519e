// Flash attention: softmax attention with an online softmax over KV tiles,
// causal or not, f32 q, k, v, f32 output, grouped-query heads and strided
// operands, on the tensor cores in split TF32 (csrc/tf32x3.cuh).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention for f32 operands (bf16 operands run
// csrc/flash_attention_tc.cu). q: (B, Hq, Nq, Dh); k, v: (B, KV, Nkv, Dh),
// Hq a multiple of KV, q head h reading KV head h / (Hq / KV); Dh any
// multiple of 4; any strides with a unit last stride, every
// stride a multiple of 4 elements and every base 16-byte aligned (TMA).
// Query row i sits at position Nkv - Nq + i, key j at position j. Per KV
// tile, as the reference: s = (q * scale) . k (q scaled in f32 before the
// dot), masked entries set to NEG_INF = -1e30 (not -inf), m_new = max(m,
// rowmax s), alpha = exp(m - m_new), p = exp(s - m_new), l = l * alpha +
// rowsum p, acc = acc * alpha + p v; out = acc / max(l, 1e-30). Keys past
// Nkv are masked in both modes (the reference's wrapper refuses the
// non-causal case with KV padding; this kernel masks it, which is the
// exact softmax of flash_attention_ref).
//
// Bound on this card: at smollm's prefill shape (15 heads, 2048 tokens, Dh
// 64) the causal product is 8.06e9 operations for 31 MB of f32 moved. As
// three TF32 products they take 0.0489 ms at 495 TFLOP/s; the bytes take
// 0.0094 ms; the f32 units (67 TFLOP/s) would need 0.1203 ms. Every head
// dim is bound the same way: the operations grow with Dh, the bytes too
// (DeepSeek-V4-Flash's 64 heads over 1 at Dh 512: 2.75e11 operations,
// 1.667 ms as three TF32 products).
// Numerics: both products are 3xTF32 with two accumulators each: S from
// the split q * scale and k, P V from the split p and v. The sums keep
// ~2^-21 of each product, well inside the 2e-4 the kernel is held to. expf
// (not __expf), no fast-math flags.
// Design (the skeleton of csrc/flash_attention_tc.cu): one block of three
// warpgroups per (query tile, batch, head); blocks with the longest
// causal rows launch first. Warpgroup 2 is the producer: it loads the Q
// tile once and K and V tiles by TMA, completion on mbarriers, TMA
// zero-filling the columns past Dh and the rows past the sequence, and
// splits each K and V tile once a block into big and small parts that
// 3xTF32 wgmma products read from shared memory (tf32 wgmma reads B only
// K-major, so V is stored transposed). The consumer warpgroups 0 and 1
// scale the q tile in place once, and per KV tile compute S = Q K^T with
// A fragments split from the q tile in registers, mask the tiles that
// cross the diagonal or Nkv, run the online softmax on the accumulator
// fragments with quad shuffles for the row max and sum, and accumulate
// O += P V with P straight from the S fragments. Tiles wholly above a
// consumer's diagonal are skipped (they would add exact zeros). Two
// pipelines, by head dim:
// - Dh up to 64 (smollm's 64): flash_attention_kernel_wgmma, the block
//   pipeline of tf32x3::Pipe at Dh 32 or 64 (a smaller Dh runs the next
//   one up, its columns past Dh zero-filled): raw tiles with padded rows,
//   split into a ring of two stages in the unswizzled core-matrix layout.
// - Dh 65 to 256 (glm4's 128, stablelm-12b's 160, Qwen3-Next's 256):
//   flash_attention_kernel_wide, the pipeline of Wide<DH> below at every
//   multiple of 32 from 96 to 256 (a Dh in between runs the next one up).
//   At these head dims the Pipe layout does not fit: at Dh 160 its q tile,
//   raw tiles and two stages of split K and V^T would take 484 KiB of the
//   227 KiB a block has. So the tiles come by TMA in 32-column boxes with
//   the 128-byte swizzle, which is the K-major layout wgmma reads: K is
//   split in place (big over the raw tile, small beside it), only V keeps
//   a raw tile (its transpose cannot be written over itself), and KV tiles
//   hold 64 keys up to Dh 128 and 32 past it. K and V have rings of their
//   own, so that the next K tile is loaded and split while the consumers
//   take P V of this one. The swizzle also keeps the consumers' q fragment
//   reads and the producer's transposed V^T writes free of bank
//   conflicts. Past Dh 160 the two consumer warpgroups share 64 query rows
//   and split Dh's output columns, both taking S (1.5 times the products
//   of one S); the q fragments are split from the q tile anew each KV
//   tile, which is why larger tiles run faster where they fit.
// - Past Dh 256 (DeepSeek-V4's 512, sarvam-105b's 576, any multiple of 4):
//   flash_attention_kernel_sliced, the pipeline of Sliced<VB> below. Two
//   64 x Dh accumulators no longer fit a warpgroup at all, nor does the
//   q tile (128 KiB for 64 rows at Dh 512), so Dh's nb = ceil(Dh / 32)
//   boxes are cut into n_slices = ceil(nb / 4) column slices of VB =
//   ceil(nb / n_slices) boxes (3 or 4), one block a (slice, 128-query
//   tile, head), its two consumer warpgroups on 64 rows each and every
//   column of the slice (Wide<128>'s rows, keys and registers). Each
//   block takes S over all of Dh: a ring of 4 slots streams one box of q
//   (128 rows, 32 columns, split in registers as it is read) beside one
//   of K (64 keys, split in place), so q is read again every KV tile; V
//   comes as the slice's raw boxes, split into one stage of V^T. Work
//   factor against the bound's two products (each three TF32 products):
//   n_slices S products plus one P V, (n_slices + 1) / 2: 2.5 at Dh 512
//   (4 slices), 3.1 at 576 (5 slices of 4 boxes, the last of 2), 4.5 at
//   1024 (Wide<256>'s is 1.5).
// The shared-memory size is set once a device, not at every launch.
#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"
#include "tma.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::split_tf32;
using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_addr;
using tma::tma_load_4d;

constexpr int BQ = 128, BKV = 64, THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_LIMIT = 232448;   // the H100's shared memory a block
// Dh 65..256 (Wide<DH>). A consumer thread holds 64 x DC / 128 output
// values, DC the output columns of its warpgroup, in each of two
// accumulators, beside S (KEYS / 2 values in each of two) and one k-step's
// split A fragments (8 registers): up to Dh 160 a warpgroup takes every
// column of its 64 query rows; past it the two consumer warpgroups split
// Dh's columns and both take S of the same 64 rows, since 2 x Dh / 2
// accumulators would not fit. KV tiles hold 64 keys where shared memory
// and registers allow (up to Dh 128), else 32: each tile splits the q
// fragments anew, so more keys a tile split them less often a key.
// setmaxnreg hands the 65,536 registers to 2 x 128 consumer threads and
// 128 producer threads (168 each at launch): 232 and 40, or 240 and 24 at
// Dh 160, whose 160 accumulators a thread leave too few for wgmma to run
// without serializing at 232.
constexpr int wide_split(int dh) { return dh > 160 ? 2 : 1; }
constexpr int wide_keys(int dh) { return dh <= 128 ? 64 : 32; }
constexpr int wide_consumer_regs(int dc) { return dc > 128 ? 240 : 232; }

struct Params {
  int heads, group, nq, nkv, dh, n_qtiles, n_bh;
  int dim_q[3], dim_kv[3];   // TMA dimension of (row, head, batch)
  float scale;
  int causal;
  float* out;   // (B, Hq, Nq, Dh) f32, contiguous
};

// ---------------------------------------------------------------------------
// Dh 65 to 256: wgmma over K split in place and V^T split once a block
// ---------------------------------------------------------------------------

template <int DH>
struct Wide {
  static_assert(DH % 32 == 0 && DH > 64 && DH <= 256, "Dh 96..256 by 32");
  static constexpr int SPLIT = wide_split(DH);
  static constexpr int ROWS = 128 / SPLIT;   // query rows a block
  static constexpr int DC = DH / SPLIT;      // a warpgroup's output columns
  static constexpr int KEYS = wide_keys(DH);
  static constexpr int NB = DH / 32;         // 32-column (128-byte) boxes
  static constexpr int CONSUMER_REGS = wide_consumer_regs(DC);
  static constexpr int PRODUCER_REGS = 168 - 2 * (CONSUMER_REGS - 168);
  static constexpr uint32_t Q_BYTES = ROWS * DH * 4;
  static constexpr uint32_t TILE = KEYS * DH * 4;   // a K or V tile, a part
  static constexpr int SLOTS = (int)((SMEM_LIMIT - 2048 - Q_BYTES - TILE) /
                                     (2 * TILE));
  // ring stages: split K (big in place, small) and split V^T (big, small)
  static constexpr int K_STAGES = SLOTS >= 3 ? 2 : 1;
  static constexpr int V_STAGES = SLOTS >= 4 ? 2 : 1;
  static constexpr size_t SMEM = 1024 + Q_BYTES + TILE +
                                 2 * TILE * (K_STAGES + V_STAGES) +
                                 (2 + 3 * K_STAGES + 2 * V_STAGES) * 8;
  static_assert(SLOTS >= 2 && SMEM <= SMEM_LIMIT, "over shared memory");

  float* q;         // ROWS rows, NB boxes of ROWS x 32 (q * scale)
  float* v_raw;     // one raw V tile, NB boxes of KEYS x 32
  uint8_t* k_ring;  // K_STAGES x (K big over the raw tile, K small)
  uint8_t* v_ring;  // V_STAGES x (V^T big, V^T small): boxes of 32 keys
  uint64_t* q_bar;
  uint64_t* v_loaded;   // the raw V tile has landed
  uint64_t* k_loaded;   // K_STAGES: a raw K tile has landed
  uint64_t* k_full;     // K_STAGES: its split is ready
  uint64_t* k_empty;    // K_STAGES: its consumers are done with it
  uint64_t* v_full;     // V_STAGES
  uint64_t* v_empty;    // V_STAGES

  __device__ explicit Wide(uint8_t* smem) {
    // the 128-byte swizzle pattern repeats every 1024 bytes
    uint8_t* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
    q = reinterpret_cast<float*>(base);
    v_raw = reinterpret_cast<float*>(base + Q_BYTES);
    k_ring = base + Q_BYTES + TILE;
    v_ring = k_ring + 2 * TILE * K_STAGES;
    q_bar = reinterpret_cast<uint64_t*>(v_ring + 2 * TILE * V_STAGES);
    v_loaded = q_bar + 1;
    k_loaded = v_loaded + 1;
    k_full = k_loaded + K_STAGES;
    k_empty = k_full + K_STAGES;
    v_full = k_empty + K_STAGES;
    v_empty = v_full + V_STAGES;
  }
  __device__ uint8_t* k_big(int s) const { return k_ring + 2 * s * TILE; }
  __device__ uint8_t* k_small(int s) const { return k_big(s) + TILE; }
  __device__ uint8_t* v_big(int s) const { return v_ring + 2 * s * TILE; }
  __device__ uint8_t* v_small(int s) const { return v_big(s) + TILE; }

  __device__ void init() const {
    mbar_init(q_bar, 1);
    mbar_init(v_loaded, 1);
    for (int s = 0; s < K_STAGES; ++s) {
      mbar_init(&k_loaded[s], 1);
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < V_STAGES; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // NB boxes of 32 columns of `rows` rows at TMA coordinates c (c[0] the
  // column) into dst, on bar
  __device__ static void load(void* dst, const CUtensorMap* map,
                              uint64_t* bar, int (&c)[4], int rows) {
#pragma unroll 1
    for (int b = 0; b < NB; ++b) {
      c[0] = 32 * b;
      tma_load_4d(static_cast<uint8_t*>(dst) + b * rows * 128, map, bar,
                  c[0], c[1], c[2], c[3]);
    }
  }

  // The producer warpgroup (ct = 0..127): cq the TMA coordinates of the q
  // rows, ckv those of KV tile 0, whose dimension `row` steps KEYS a tile.
  __device__ void produce(const CUtensorMap* map_q, const CUtensorMap* map_k,
                          const CUtensorMap* map_v, int (&cq)[4],
                          int (&ckv)[4], int row, int n_tiles,
                          int ct) const {
    const int kv0 = ckv[row];
    auto load_k = [&](int j) {
      const int s = j % K_STAGES;
      mbar_expect_tx(&k_loaded[s], TILE);
      ckv[row] = kv0 + j * KEYS;
      load(k_big(s), map_k, &k_loaded[s], ckv, KEYS);
    };
    if (ct == 0) {
      mbar_expect_tx(q_bar, Q_BYTES);
      load(q, map_q, q_bar, cq, ROWS);
      for (int j = 0; j < K_STAGES && j < n_tiles; ++j) load_k(j);
      if (n_tiles > 0) {
        mbar_expect_tx(v_loaded, TILE);
        ckv[row] = kv0;
        load(v_raw, map_v, v_loaded, ckv, KEYS);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int sk = j % K_STAGES, sv = j % V_STAGES;
      // K: big over the raw tile, small beside it, elementwise (the split
      // keeps the swizzled layout TMA wrote)
      mbar_wait(&k_loaded[sk], (j / K_STAGES) & 1);
      for (int e = ct; e < TILE / 16; e += 128) {
        uint4* x = reinterpret_cast<uint4*>(k_big(sk)) + e;
        const uint4 raw = *x;
        uint4 hi, lo;
        split_tf32(__uint_as_float(raw.x), hi.x, lo.x);
        split_tf32(__uint_as_float(raw.y), hi.y, lo.y);
        split_tf32(__uint_as_float(raw.z), hi.z, lo.z);
        split_tf32(__uint_as_float(raw.w), hi.w, lo.w);
        *x = hi;
        reinterpret_cast<uint4*>(k_small(sk))[e] = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (ct == 0) mbar_arrive(&k_full[sk]);

      // V^T: row d holds the tile's keys in the order P's A fragments take
      // them (slot 4c + i of 16-byte chunk c is key 8 (c / 2) + c % 2 +
      // 2i), in boxes of 32 keys (DH rows of 128 bytes) swizzled as TMA
      // swizzles (chunk c % 8 of row d at (c % 8) ^ (d % 8)). A thread
      // takes one chunk of one row; a warp's 32 rows read one 128-byte row
      // of a raw box.
      mbar_wait(v_loaded, j & 1);
      if (j >= V_STAGES) mbar_wait(&v_empty[sv], ((j / V_STAGES) & 1) ^ 1);
      for (int e = ct; e < DH * (KEYS / 4); e += 128) {
        const int d = e % DH, c = e / DH;
        const int key0 = 8 * (c / 2) + c % 2;
        const float* box = v_raw + (d / 32) * KEYS * 32;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + 2 * i;
          split_tf32(box[key * 32 + ((((d % 32) / 4) ^ (key % 8)) * 4) +
                         d % 4],
                     hi[i], lo[i]);
        }
        const uint32_t off =
            (c / 8) * DH * 128 + d * 128 + (((c % 8) ^ (d % 8)) * 16);
        *reinterpret_cast<uint4*>(v_big(sv) + off) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(v_small(sv) + off) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      // wgmma (the async proxy) reads the split; the raw tile is free
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (ct == 0) {
        mbar_arrive(&v_full[sv]);
        if (j + 1 < n_tiles) {
          mbar_expect_tx(v_loaded, TILE);
          ckv[row] = kv0 + (j + 1) * KEYS;
          load(v_raw, map_v, v_loaded, ckv, KEYS);
        }
        // the next K tile of this stage, once S of this one is taken
        if (j + K_STAGES < n_tiles) {
          mbar_wait(&k_empty[sk], (j / K_STAGES) & 1);
          load_k(j + K_STAGES);
        }
      }
    }
  }

  // S = Q K^T of stage s for a consumer warpgroup, into hi and lo: qa the
  // thread's q row g + column t in box 0 (rows 32 floats apart, box
  // ROWS x 32 floats), g its row in the 8-row swizzle group. One k-step a
  // group: its fragment's 8 registers live till the wait.
  __device__ void qk(const float* qa, int g, int s, float (&hi)[KEYS / 2],
                     float (&lo)[KEYS / 2]) const {
    const uint32_t big = smem_addr(k_big(s)) / 16, small = big + TILE / 16;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      const float* x = qa + (kk / 4) * ROWS * 32;
      const int c0 = ((2 * (kk % 4)) ^ g) * 4;
      const int c1 = ((2 * (kk % 4) + 1) ^ g) * 4;
      FragA a;
      a.set(x[c0], x[8 * 32 + c0], x[c1], x[8 * 32 + c1]);
      const uint32_t off = ((kk / 4) * KEYS * 128 + (kk % 4) * 32) / 16;
      tf32x3::wgmma_fence();
      tf32x3::wgmma3<KEYS>(hi, lo, a, tf32x3::smem_desc_sw128(big + off),
                           tf32x3::smem_desc_sw128(small + off), kk == 0);
      tf32x3::wgmma_commit();
      tf32x3::wgmma_wait_all();
    }
    tf32x3::fence_regs(hi);
    tf32x3::fence_regs(lo);
  }

  // O += P V of stage s over a warpgroup's DC columns from col0, P the S
  // accumulator's layout, in groups of 4 k-steps (32 fragment registers)
  __device__ void pv(const float (&p)[KEYS / 2], int s, int col0,
                     float (&hi)[DC / 2], float (&lo)[DC / 2]) const {
    constexpr int STEPS = 4;
    const uint32_t big = smem_addr(v_big(s)) / 16, small = big + TILE / 16;
#pragma unroll
    for (int k0 = 0; k0 < KEYS / 8; k0 += STEPS) {
      FragA a[STEPS];
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const int kk = k0 + i;
        a[i].set(p[4 * kk], p[4 * kk + 2], p[4 * kk + 1], p[4 * kk + 3]);
      }
      tf32x3::fence_regs(hi);
      tf32x3::fence_regs(lo);
      tf32x3::wgmma_fence();
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const int kk = k0 + i;
        const uint32_t off =
            ((kk / 4) * DH * 128 + col0 * 128 + (kk % 4) * 32) / 16;
        tf32x3::wgmma3<DC>(hi, lo, a[i], tf32x3::smem_desc_sw128(big + off),
                           tf32x3::smem_desc_sw128(small + off), false);
      }
      tf32x3::wgmma_commit();
      tf32x3::wgmma_wait_all();
      tf32x3::fence_regs(hi);
      tf32x3::fence_regs(lo);
    }
  }
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel_wide(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const Params p) {
  using W = Wide<DH>;
  constexpr int KEYS = W::KEYS;
  extern __shared__ uint8_t smem_raw[];
  const W w(smem_raw);

  // longest causal rows first: the last query tiles of every head lead
  const int bh = blockIdx.x % p.n_bh;
  const int qt = p.n_qtiles - 1 - blockIdx.x / p.n_bh;
  const int b = bh / p.heads, h = bh % p.heads, kvh = h / p.group;
  const int q0 = qt * W::ROWS;
  const int q_offset = p.nkv - p.nq;
  const int kv_end = p.causal
                         ? min(p.nkv, q_offset + min(q0 + W::ROWS, p.nq))
                         : p.nkv;
  const int n_tiles = (kv_end + KEYS - 1) / KEYS;

  const int tid = threadIdx.x;
  if (tid == 0) w.init();
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        W::PRODUCER_REGS));
    int cq[4] = {0, 0, 0, 0}, ckv[4] = {0, 0, 0, 0};
    cq[p.dim_q[0]] = q0;
    cq[p.dim_q[1]] = h;
    cq[p.dim_q[2]] = b;
    ckv[p.dim_kv[1]] = kvh;
    ckv[p.dim_kv[2]] = b;
    w.produce(&map_q, &map_k, &map_v, cq, ckv, p.dim_kv[0], n_tiles,
              tid - 256);
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      W::CONSUMER_REGS));
  const int lane = tid % 32, warp = tid / 32, wg = tid / 128;
  const int g = lane / 4, t = lane % 4;
  // SPLIT 1: warpgroup wg owns rows 64 wg.. and every column; SPLIT 2:
  // both own rows 0..63, warpgroup wg the columns DC wg..
  const int rows0 = W::SPLIT == 1 ? 64 * wg : 0;
  const int col0 = W::SPLIT == 1 ? 0 : W::DC * wg;
  const int row0 = rows0 + 16 * (warp % 4);   // the warp's rows in the tile
  const int wg_q0 = q0 + rows0;
  const int wg_end =
      wg_q0 >= p.nq ? 0
                    : (p.causal ? min(p.nkv, q_offset + min(wg_q0 + 64, p.nq))
                                : p.nkv);
  const int my_tiles = (wg_end + KEYS - 1) / KEYS;

  mbar_wait(w.q_bar, 0);
  for (int e = tid; e < (int)(W::Q_BYTES / 16); e += 256) {   // q * scale
    float4* x = reinterpret_cast<float4*>(w.q) + e;
    float4 y = *x;
    y.x *= p.scale;
    y.y *= p.scale;
    y.z *= p.scale;
    y.w *= p.scale;
    *x = y;
  }
  asm volatile("bar.sync 2, 256;\n" ::: "memory");   // the consumers
  const float* qa = w.q + (row0 + g) * 32 + t;

  float o_hi[W::DC / 2], o_lo[W::DC / 2];
#pragma unroll
  for (int i = 0; i < W::DC / 2; ++i) o_hi[i] = o_lo[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int sk = j % W::K_STAGES, sv = j % W::V_STAGES;
    mbar_wait(&w.k_full[sk], (j / W::K_STAGES) & 1);
    float sc[KEYS / 2];
    if (j < my_tiles) {
      float sl[KEYS / 2];
      w.qk(qa, g, sk, sc, sl);
      // add the corrections; mask the tiles that cross the diagonal or Nkv
      const int k0 = j * KEYS;
      const bool edge = k0 + KEYS > p.nkv ||
                        (p.causal && k0 + KEYS - 1 > q_offset + wg_q0);
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        float x = sc[i] + sl[i];
        if (edge) {
          const int kpos = k0 + (i / 4) * 8 + 2 * t + (i % 2);
          const int qpos = q_offset + q0 + row0 + g + ((i / 2) % 2) * 8;
          if (kpos >= p.nkv || (p.causal && kpos > qpos)) x = NEG_INF;
        }
        sc[i] = x;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&w.k_empty[sk]);

    if (j < my_tiles) {
      // online softmax, rows g (i % 4 < 2) and g + 8 (i % 4 >= 2); the
      // four lanes of a quad hold a row's keys
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i)
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
      for (int i = 0; i < KEYS / 2; ++i) {
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
      // (a warp whose rows kept their maxima multiplies by exactly 1: skip)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < W::DC / 2; ++i) {
          o_hi[i] *= alpha[(i / 2) % 2];
          o_lo[i] *= alpha[(i / 2) % 2];
        }
      }
    }
    mbar_wait(&w.v_full[sv], (j / W::V_STAGES) & 1);
    if (j < my_tiles) w.pv(sc, sv, col0, o_hi, o_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(&w.v_empty[sv]);
  }

  // out = acc / max(l, 1e-30), rows inside Nq, columns inside Dh
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + g + 8 * r;
    if (qi >= p.nq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    float* row = p.out + ((long long)bh * p.nq + qi) * p.dh;
#pragma unroll
    for (int nb = 0; nb < W::DC / 8; ++nb) {
      const int col = col0 + nb * 8 + 2 * t;
      if (col < p.dh)
        *reinterpret_cast<float2*>(row + col) = make_float2(
            (o_hi[4 * nb + 2 * r] + o_lo[4 * nb + 2 * r]) / l,
            (o_hi[4 * nb + 2 * r + 1] + o_lo[4 * nb + 2 * r + 1]) / l);
    }
  }
}

// ---------------------------------------------------------------------------
// Dh above 256: column slices, q and K streamed in 32-column boxes
// ---------------------------------------------------------------------------

struct SliceParams {
  Params p;
  int n_slices;   // blocks a (query tile, head), one output slice each
  int nb;         // 32-column boxes of Dh, all of which S sums over
};

// A block owns VB 32-column boxes of the output (DC = 32 VB columns) of 128
// query rows, 64 a consumer warpgroup, as Wide<DH> does at SPLIT 1, and
// takes S over every box of Dh: a ring slot holds one box of q (128 rows)
// and one of K (64 keys, split in place, small beside it), loaded together
// and freed once the consumers have taken that box's share of S. V comes
// as one raw tile of the slice's boxes, split into one stage of V^T.
template <int VB>
struct Sliced {
  static constexpr int ROWS = 128, KEYS = 64, DC = 32 * VB;
  static constexpr int CONSUMER_REGS = wide_consumer_regs(DC);
  static constexpr int PRODUCER_REGS = 168 - 2 * (CONSUMER_REGS - 168);
  static constexpr uint32_t Q_BOX = ROWS * 128, K_BOX = KEYS * 128;
  static constexpr uint32_t SLOT = Q_BOX + 2 * K_BOX;   // q, K big, K small
  static constexpr uint32_t V_TILE = VB * K_BOX;   // raw V, or V^T's part
  static constexpr int KS =
      (int)((SMEM_LIMIT - 2048 - 3 * V_TILE) / SLOT);   // ring slots
  static constexpr size_t SMEM =
      1024 + KS * SLOT + 3 * V_TILE + (3 * KS + 3) * sizeof(uint64_t);
  static_assert(KS >= 2 && SMEM <= SMEM_LIMIT, "over shared memory");

  uint8_t* ring;    // KS x (q box, K big over the raw box, K small)
  float* v_raw;     // the slice's raw V boxes of one KV tile
  uint8_t* v_big;   // V^T big, then small: boxes of 32 keys (DC rows)
  uint64_t* loaded;   // KS: a slot's q and raw K have landed
  uint64_t* k_full;   // KS: its K split is ready
  uint64_t* k_empty;  // KS: its consumers are done with it
  uint64_t* v_loaded;
  uint64_t* v_full;
  uint64_t* v_empty;

  __device__ explicit Sliced(uint8_t* smem) {
    uint8_t* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
    ring = base;
    v_raw = reinterpret_cast<float*>(base + KS * SLOT);
    v_big = base + KS * SLOT + V_TILE;
    loaded = reinterpret_cast<uint64_t*>(v_big + 2 * V_TILE);
    k_full = loaded + KS;
    k_empty = k_full + KS;
    v_loaded = k_empty + KS;
    v_full = v_loaded + 1;
    v_empty = v_full + 1;
  }
  __device__ float* q_box(int s) const {
    return reinterpret_cast<float*>(ring + s * SLOT);
  }
  __device__ uint8_t* k_big(int s) const { return ring + s * SLOT + Q_BOX; }
  __device__ uint8_t* k_small(int s) const { return k_big(s) + K_BOX; }
  __device__ uint8_t* v_small() const { return v_big + V_TILE; }

  __device__ void init() const {
    for (int s = 0; s < KS; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], CONSUMER_WARPS);
    }
    mbar_init(v_loaded, 1);
    mbar_init(v_full, 1);
    mbar_init(v_empty, CONSUMER_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The producer warpgroup (ct = 0..127). Box n = j nb + c is (KV tile j,
  // column box c); cq, ckv the TMA coordinates of the q rows and of KV tile
  // 0 (dimension `row` steps KEYS a tile); the slice's V boxes are box0..,
  // nvb of them inside Dh.
  __device__ void produce(const CUtensorMap* map_q, const CUtensorMap* map_k,
                          const CUtensorMap* map_v, int (&cq)[4],
                          int (&ckv)[4], int row, int n_tiles, int nb,
                          int box0, int nvb, int ct) const {
    const int kv0 = ckv[row], total = n_tiles * nb;
    auto load_box = [&](int n) {
      const int s = n % KS;
      mbar_expect_tx(&loaded[s], Q_BOX + K_BOX);
      cq[0] = ckv[0] = 32 * (n % nb);
      ckv[row] = kv0 + (n / nb) * KEYS;
      tma_load_4d(q_box(s), map_q, &loaded[s], cq[0], cq[1], cq[2], cq[3]);
      tma_load_4d(k_big(s), map_k, &loaded[s], ckv[0], ckv[1], ckv[2],
                  ckv[3]);
    };
    auto load_v = [&](int j) {
      mbar_expect_tx(v_loaded, nvb * K_BOX);
      ckv[row] = kv0 + j * KEYS;
      for (int b = 0; b < nvb; ++b) {
        ckv[0] = 32 * (box0 + b);
        tma_load_4d(reinterpret_cast<uint8_t*>(v_raw) + b * K_BOX, map_v,
                    v_loaded, ckv[0], ckv[1], ckv[2], ckv[3]);
      }
    };
    if (ct == 0) {
      for (int n = 0; n < KS && n < total; ++n) load_box(n);
      if (n_tiles > 0) load_v(0);
    }
    for (int n = 0; n < total; ++n) {
      const int s = n % KS, j = n / nb;
      // K: big over the raw box, small beside it
      mbar_wait(&loaded[s], (n / KS) & 1);
      for (int e = ct; e < (int)(K_BOX / 16); e += 128) {
        uint4* x = reinterpret_cast<uint4*>(k_big(s)) + e;
        const uint4 raw = *x;
        uint4 hi, lo;
        split_tf32(__uint_as_float(raw.x), hi.x, lo.x);
        split_tf32(__uint_as_float(raw.y), hi.y, lo.y);
        split_tf32(__uint_as_float(raw.z), hi.z, lo.z);
        split_tf32(__uint_as_float(raw.w), hi.w, lo.w);
        *x = hi;
        reinterpret_cast<uint4*>(k_small(s))[e] = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (ct == 0) {
        mbar_arrive(&k_full[s]);
        // refill the slot of box n - 1 once its consumers are done
        if (n >= 1 && n - 1 + KS < total) {
          mbar_wait(&k_empty[(n - 1) % KS], ((n - 1) / KS) & 1);
          load_box(n - 1 + KS);
        }
      }
      if (n % nb != nb - 1) continue;

      // V^T of tile j, as Wide<DH> lays it out over the slice's DC columns
      // (the columns past Dh split whatever the raw tile holds there: their
      // outputs are never stored)
      mbar_wait(v_loaded, j & 1);
      if (j >= 1) mbar_wait(v_empty, (j - 1) & 1);
      for (int e = ct; e < DC * (KEYS / 4); e += 128) {
        const int d = e % DC, c = e / DC;
        const int key0 = 8 * (c / 2) + c % 2;
        const float* box = v_raw + (d / 32) * KEYS * 32;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + 2 * i;
          split_tf32(box[key * 32 + ((((d % 32) / 4) ^ (key % 8)) * 4) +
                         d % 4],
                     hi[i], lo[i]);
        }
        const uint32_t off =
            (c / 8) * DC * 128 + d * 128 + (((c % 8) ^ (d % 8)) * 16);
        *reinterpret_cast<uint4*>(v_big + off) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(v_small() + off) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (ct == 0) {
        mbar_arrive(v_full);
        if (j + 1 < n_tiles) load_v(j + 1);
      }
    }
  }

  // S (+)= the share of q box slot s for a consumer warpgroup: qa the
  // thread's q row g + column t in the box, scaled as it is read (the
  // reference's q * scale, before the split); one k-step a wgmma group
  __device__ void qk_box(const float* qa, int g, int s, float scale,
                         bool first, float (&hi)[KEYS / 2],
                         float (&lo)[KEYS / 2]) const {
    const uint32_t big = smem_addr(k_big(s)) / 16, small = big + K_BOX / 16;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c0 = ((2 * kk) ^ g) * 4, c1 = ((2 * kk + 1) ^ g) * 4;
      FragA a;
      a.set(qa[c0] * scale, qa[8 * 32 + c0] * scale, qa[c1] * scale,
            qa[8 * 32 + c1] * scale);
      tf32x3::wgmma_fence();
      tf32x3::wgmma3<KEYS>(hi, lo, a,
                           tf32x3::smem_desc_sw128(big + 2 * kk),
                           tf32x3::smem_desc_sw128(small + 2 * kk),
                           first && kk == 0);
      tf32x3::wgmma_commit();
      tf32x3::wgmma_wait_all();
    }
    tf32x3::fence_regs(hi);
    tf32x3::fence_regs(lo);
  }

  // O += P V^T over the slice's DC columns, P the S accumulator's layout,
  // in groups of 2 k-steps
  __device__ void pv(const float (&p)[KEYS / 2], float (&hi)[DC / 2],
                     float (&lo)[DC / 2]) const {
    constexpr int STEPS = 2;
    const uint32_t big = smem_addr(v_big) / 16, small = big + V_TILE / 16;
#pragma unroll
    for (int k0 = 0; k0 < KEYS / 8; k0 += STEPS) {
      FragA a[STEPS];
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const int kk = k0 + i;
        a[i].set(p[4 * kk], p[4 * kk + 2], p[4 * kk + 1], p[4 * kk + 3]);
      }
      tf32x3::fence_regs(hi);
      tf32x3::fence_regs(lo);
      tf32x3::wgmma_fence();
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const int kk = k0 + i;
        const uint32_t off = ((kk / 4) * DC * 128 + (kk % 4) * 32) / 16;
        tf32x3::wgmma3<DC>(hi, lo, a[i], tf32x3::smem_desc_sw128(big + off),
                           tf32x3::smem_desc_sw128(small + off), false);
      }
      tf32x3::wgmma_commit();
      tf32x3::wgmma_wait_all();
      tf32x3::fence_regs(hi);
      tf32x3::fence_regs(lo);
    }
  }
};

template <int VB>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel_sliced(const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap map_k,
                                  const __grid_constant__ CUtensorMap map_v,
                                  const SliceParams sp) {
  using W = Sliced<VB>;
  constexpr int KEYS = W::KEYS, KS = W::KS;
  const Params& p = sp.p;
  extern __shared__ uint8_t smem_raw[];
  const W w(smem_raw);

  // the slices of one (query tile, head) are neighbours, longest causal
  // rows first
  const int slice = blockIdx.x % sp.n_slices;
  const int rest = blockIdx.x / sp.n_slices;
  const int bh = rest % p.n_bh;
  const int qt = p.n_qtiles - 1 - rest / p.n_bh;
  const int b = bh / p.heads, h = bh % p.heads, kvh = h / p.group;
  const int q0 = qt * W::ROWS;
  const int q_offset = p.nkv - p.nq;
  const int kv_end = p.causal
                         ? min(p.nkv, q_offset + min(q0 + W::ROWS, p.nq))
                         : p.nkv;
  const int n_tiles = (kv_end + KEYS - 1) / KEYS;
  const int nb = sp.nb, box0 = slice * VB;

  const int tid = threadIdx.x;
  if (tid == 0) w.init();
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        W::PRODUCER_REGS));
    int cq[4] = {0, 0, 0, 0}, ckv[4] = {0, 0, 0, 0};
    cq[p.dim_q[0]] = q0;
    cq[p.dim_q[1]] = h;
    cq[p.dim_q[2]] = b;
    ckv[p.dim_kv[1]] = kvh;
    ckv[p.dim_kv[2]] = b;
    w.produce(&map_q, &map_k, &map_v, cq, ckv, p.dim_kv[0], n_tiles, nb,
              box0, min(VB, nb - box0), tid - 256);
    return;
  }

  // ---------------- consumers: 64 query rows a warpgroup ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      W::CONSUMER_REGS));
  const int lane = tid % 32, warp = tid / 32, wg = tid / 128;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;    // the warp's rows in the tile
  const int wg_q0 = q0 + 64 * wg;
  const int wg_end =
      wg_q0 >= p.nq ? 0
                    : (p.causal ? min(p.nkv, q_offset + min(wg_q0 + 64, p.nq))
                                : p.nkv);
  const int my_tiles = (wg_end + KEYS - 1) / KEYS;

  float o_hi[W::DC / 2], o_lo[W::DC / 2];
#pragma unroll
  for (int i = 0; i < W::DC / 2; ++i) o_hi[i] = o_lo[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  const int qa = (row0 + g) * 32 + t;   // the thread's q row and column
  for (int j = 0; j < n_tiles; ++j) {
    // a warpgroup's tiles wholly above its rows: only free the slots
    if (j >= my_tiles) {
      for (int c = 0; c < nb; ++c) {
        const int n = j * nb + c;
        mbar_wait(&w.k_full[n % KS], (n / KS) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(&w.k_empty[n % KS]);
      }
      mbar_wait(w.v_full, j & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(w.v_empty);
      continue;
    }
    float sc[KEYS / 2], sl[KEYS / 2];
    for (int c = 0; c < nb; ++c) {
      const int n = j * nb + c, s = n % KS;
      // the q box is read by this thread: wait on its load too
      mbar_wait(&w.loaded[s], (n / KS) & 1);
      mbar_wait(&w.k_full[s], (n / KS) & 1);
      w.qk_box(w.q_box(s) + qa, g, s, p.scale, c == 0, sc, sl);
      __syncwarp();
      if (lane == 0) mbar_arrive(&w.k_empty[s]);
    }

    {
      // add the corrections; mask the tiles that cross the diagonal or Nkv
      const int k0 = j * KEYS;
      const bool edge = k0 + KEYS > p.nkv ||
                        (p.causal && k0 + KEYS - 1 > q_offset + wg_q0);
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        float x = sc[i] + sl[i];
        if (edge) {
          const int kpos = k0 + (i / 4) * 8 + 2 * t + (i % 2);
          const int qpos = q_offset + q0 + row0 + g + ((i / 2) % 2) * 8;
          if (kpos >= p.nkv || (p.causal && kpos > qpos)) x = NEG_INF;
        }
        sc[i] = x;
      }

      // online softmax, rows g (i % 4 < 2) and g + 8 (i % 4 >= 2); the
      // four lanes of a quad hold a row's keys
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i)
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
      for (int i = 0; i < KEYS / 2; ++i) {
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
      // (a warp whose rows kept their maxima multiplies by exactly 1: skip)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < W::DC / 2; ++i) {
          o_hi[i] *= alpha[(i / 2) % 2];
          o_lo[i] *= alpha[(i / 2) % 2];
        }
      }
    }
    mbar_wait(w.v_full, j & 1);
    w.pv(sc, o_hi, o_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(w.v_empty);
  }

  // out = acc / max(l, 1e-30), rows inside Nq, the slice's columns inside
  // Dh
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + g + 8 * r;
    if (qi >= p.nq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    float* row = p.out + ((long long)bh * p.nq + qi) * p.dh;
#pragma unroll
    for (int nb8 = 0; nb8 < W::DC / 8; ++nb8) {
      const int col = 32 * box0 + nb8 * 8 + 2 * t;
      if (col < p.dh)
        *reinterpret_cast<float2*>(row + col) = make_float2(
            (o_hi[4 * nb8 + 2 * r] + o_lo[4 * nb8 + 2 * r]) / l,
            (o_hi[4 * nb8 + 2 * r + 1] + o_lo[4 * nb8 + 2 * r + 1]) / l);
    }
  }
}

// ---------------------------------------------------------------------------
// Dh up to 64: wgmma over operands split once a block (tf32x3::Pipe)
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
    float* row = p.out + ((long long)bh * p.nq + qi) * p.dh;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      const int col = nb * 8 + 2 * t;
      if (col < p.dh)
        *reinterpret_cast<float2*>(row + col) = make_float2(
            (o_hi[4 * nb + 2 * r] + o_lo[4 * nb + 2 * r]) / l,
            (o_hi[4 * nb + 2 * r + 1] + o_lo[4 * nb + 2 * r + 1]) / l);
    }
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

template <int DH>
int launch_wide(std::atomic<unsigned long long>& sized, const CUtensorMap& mq,
                const CUtensorMap& mk, const CUtensorMap& mv,
                const Params& prm, cudaStream_t stream) {
  return launch(flash_attention_kernel_wide<DH>, Wide<DH>::SMEM, sized, mq,
                mk, mv, prm, stream);
}

// Dh above 256: nb boxes of 32 columns in n_slices = ceil(nb / 4) slices of
// VB = ceil(nb / n_slices) boxes (3 or 4), the last slice's boxes past Dh
// left out
template <int VB>
int launch_sliced(std::atomic<unsigned long long>& sized,
                  const CUtensorMap& mq, const CUtensorMap& mk,
                  const CUtensorMap& mv, const SliceParams& sp,
                  cudaStream_t stream) {
  constexpr size_t smem = Sliced<VB>::SMEM;
  const cudaError_t err = tf32x3::size_smem_once(
      flash_attention_kernel_sliced<VB>, smem, sized);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)sp.p.n_qtiles * sp.p.n_bh * sp.n_slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_kernel_sliced<VB><<<(unsigned)blocks, THREADS, smem,
                                      stream>>>(mq, mk, mv, sp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q: (batch, heads, nq, dh) f32 with element strides (qs_b, qs_h, qs_r, 1);
// k, v: (batch, kv_heads, nkv, dh) f32, strides (ks_*, 1) and (vs_*, 1), k
// and v in one order of strides; every stride a multiple of 4 and every
// base 16-byte aligned (TMA); heads a multiple of kv_heads; dh a multiple
// of 4, at least 4; nkv >= 1, nq <= nkv when causal. out: (batch, heads,
// nq, dh) f32, contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, float* out, int batch,
    int heads, int kv_heads, int nq, int nkv, int dh, long long qs_b,
    long long qs_h, long long qs_r, long long ks_b, long long ks_h,
    long long ks_r, long long vs_b, long long vs_h, long long vs_r,
    float scale, int causal, void* stream) {
  if (batch == 0 || heads == 0 || nq == 0) return 0;
  if (dh < 4 || dh % 4 || kv_heads <= 0 || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  // the instantiation that runs: Pipe at 32 or 64, Wide at a multiple of 32
  // up to 256, Sliced past it (its rows and key tiles are Wide<128>'s)
  const int inst = dh <= 32    ? 32
                   : dh <= 64  ? 64
                   : dh <= 256 ? (dh + 31) / 32 * 32
                               : 128;
  CUtensorMap mq, mk, mv;
  Params prm;
  int dim_v[3];
  constexpr auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  bool ok;
  int rows;
  if (inst <= 64) {
    // unswizzled boxes of padded rows, Dh + 4 columns (TMA zero-fills
    // the columns past Dh)
    constexpr auto FLAT = CU_TENSOR_MAP_SWIZZLE_NONE;
    rows = BQ;
    ok = tma::make_map(&mq, F32, 4, FLAT, q, dh, inst + 4, nq, heads, batch,
                       qs_r, qs_h, qs_b, BQ, prm.dim_q) &&
         tma::make_map(&mk, F32, 4, FLAT, k, dh, inst + 4, nkv, kv_heads,
                       batch, ks_r, ks_h, ks_b, BKV, prm.dim_kv) &&
         tma::make_map(&mv, F32, 4, FLAT, v, dh, inst + 4, nkv, kv_heads,
                       batch, vs_r, vs_h, vs_b, BKV, dim_v);
  } else {
    // 128-byte swizzled boxes of 32 columns
    constexpr auto SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
    rows = 128 / wide_split(inst);   // Wide<inst>::ROWS
    ok = tma::make_map(&mq, F32, 4, SW128, q, dh, 32, nq, heads, batch, qs_r,
                       qs_h, qs_b, rows, prm.dim_q) &&
         tma::make_map(&mk, F32, 4, SW128, k, dh, 32, nkv, kv_heads, batch,
                       ks_r, ks_h, ks_b, wide_keys(inst), prm.dim_kv) &&
         tma::make_map(&mv, F32, 4, SW128, v, dh, 32, nkv, kv_heads, batch,
                       vs_r, vs_h, vs_b, wide_keys(inst), dim_v);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  // k and v share one coordinate order (the wrapper gives them one layout)
  for (int i = 0; i < 3; ++i)
    if (dim_v[i] != prm.dim_kv[i]) return (int)cudaErrorInvalidValue;
  prm.heads = heads;
  prm.group = heads / kv_heads;
  prm.nq = nq;
  prm.nkv = nkv;
  prm.dh = dh;
  prm.n_qtiles = (nq + rows - 1) / rows;
  prm.n_bh = batch * heads;
  prm.scale = scale;
  prm.causal = causal;
  prm.out = out;
  const cudaStream_t s = (cudaStream_t)stream;
  static std::atomic<unsigned long long> sized[10];   // a bit a device
  if (dh > 256) {
    SliceParams sp;
    sp.p = prm;
    sp.nb = (dh + 31) / 32;
    sp.n_slices = (sp.nb + 3) / 4;
    if ((sp.nb + sp.n_slices - 1) / sp.n_slices == 4)
      return launch_sliced<4>(sized[8], mq, mk, mv, sp, s);
    return launch_sliced<3>(sized[9], mq, mk, mv, sp, s);
  }
  switch (inst) {
    case 32:
      return launch(flash_attention_kernel_wgmma<32>, tf32x3::Pipe<32>::SMEM,
                    sized[0], mq, mk, mv, prm, s);
    case 64:
      return launch(flash_attention_kernel_wgmma<64>, tf32x3::Pipe<64>::SMEM,
                    sized[1], mq, mk, mv, prm, s);
    case 96: return launch_wide<96>(sized[2], mq, mk, mv, prm, s);
    case 128: return launch_wide<128>(sized[3], mq, mk, mv, prm, s);
    case 160: return launch_wide<160>(sized[4], mq, mk, mv, prm, s);
    case 192: return launch_wide<192>(sized[5], mq, mk, mv, prm, s);
    case 224: return launch_wide<224>(sized[6], mq, mk, mv, prm, s);
    default: return launch_wide<256>(sized[7], mq, mk, mv, prm, s);
  }
}
