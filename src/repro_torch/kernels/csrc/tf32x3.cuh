// Split-TF32 ("3xTF32") products on the tensor cores, shared by csrc/stdp.cu
// and csrc/flash_attention.cu.
//
// An f32 x is held as big + small: big = rna(x), x rounded to nearest,
// ties away from zero, to 10 explicit mantissa bits (cvt.rna.tf32.f32's
// rounding), and small = rna(x - big). x - big is exact, so big + small is
// within 2^-22 |x| of x. A product a b is taken as big_a big_b + (big_a
// small_b + small_a big_b); the dropped small_a small_b is below 2^-22
// |a b|. The big products go into one accumulator and the two corrections
// into a second, added together by the caller: the tensor cores align a
// step's products to the largest one and truncate (measured for bf16
// wgmma, scripts/wgmma_accumulation.py), so corrections summed apart from
// the big terms keep their low bits. For {0,1} operands small is 0 and
// every big product is exact, so integer sums below 2^24 are exact.
//
// Two ways to take the products, both here. wgmma m64nNk8 tf32
// (wgmma_tf32, below): a producer warpgroup splits each K and V tile once,
// into K-major copies that wgmma reads from shared memory (tf32 wgmma
// reads B only K-major, so V is stored transposed); the block pipeline
// Pipe (below) does so for Dh 32 and 64 in STDP and flash attention, and
// csrc/flash_attention.cu's Wide for its other head dims. mma.sync
// m16n8k8 tf32 for STDP's other head dims and for STDP operands TMA cannot
// read: each warp loads its fragments from the raw f32 tiles and splits
// them in registers. In both, the S accumulator is P.V's A fragment
// unchanged: it holds keys 2t and 2t+1 of each 8-key block where the A
// fragment expects k = t and t + 4, so P.V reads V's rows in that order
// (rows 2t and 2t+1 as its k = t and t + 4) and nothing moves between
// lanes. The mma.sync Q.K^T reads both operands' columns 2t and 2t+1 of
// each 8-column step as k = t and t + 4 (one 8-byte load each), which
// permutes only the order of the products inside a step.
//
// Fragments (g = lane / 4, t = lane % 4), PTX ISA "mma.m16n8k8 .tf32":
//   A 16x8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8x8:  b0 (k t, n g), b1 (k t + 4, n g)
//   C 16x8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once
#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace tf32x3 {

// Sets a kernel's dynamic shared-memory size on the current device once (the
// setting is per device; `sized` holds a bit a device), not at every launch.
template <typename Kernel>
inline cudaError_t size_smem_once(Kernel kernel, size_t bytes,
                                  std::atomic<unsigned long long>& sized) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (sized.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) sized.fetch_or(bit);
  return err;
}

// rna(x) as an mma operand: half a tf32 ulp added to the magnitude's bits.
// The tensor cores read only a tf32 operand's top 19 bits, so the bits
// below need no clearing (CUTLASS's round_half_ulp_truncate; the kernels
// give the same bits with them cleared). One integer add: with
// cvt.rna.tf32.f32 instead both kernels ran slower on an H100
// (scripts/tf32x3_variants.py).
__device__ __forceinline__ uint32_t rna_operand(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// x = big + small as two mma operands; the value of big is the operand
// with its 13 low bits cleared
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = rna_operand(x);
  small = rna_operand(x - __uint_as_float(big & 0xffffe000u));
}

// A fragment of a 16x8 tile from four f32 values, split
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

// B fragment of an 8x8 tile from two f32 values, split
struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

// d (16x8 f32) += a (16x8 tf32) * b (8x8 tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 3xTF32 step: hi += big_a big_b; lo += big_a small_b + small_a big_b.
// The product is hi + lo, taken once the sums are done.
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4],
                                     const FragA& a, const FragB& b) {
  mma_tf32(hi, a.big, b.big);
  mma_tf32(lo, a.big, b.small);
  mma_tf32(lo, a.small, b.big);
}

// ---------------------------------------------------------------------------
// wgmma over operands split once a block (Dh 32 and 64)
// ---------------------------------------------------------------------------
// A block is three warpgroups over 128 query rows and KV tiles of 64 keys.
// Warpgroup 2, the producer, loads by TMA the block's q rows once and each
// raw K and V tile (rows of Dh + 4 floats: TMA zero-fills the columns past
// Dh and the rows past the sequence, and the 4 extra floats keep the
// split's reads free of bank conflicts), splits the tile once into big and
// small K (64 keys x Dh) and V^T (64 rows of d, zero past Dh, x 64 key
// slots) in the unswizzled K-major layout wgmma reads (core matrices of 8
// rows x 16 bytes, 128 bytes apart along N and LBO apart along K), in a
// ring of STAGES stages, and frees the raw tile for the next load.
// Warpgroups 0 and 1 own 64 query rows each: Q K^T takes its A fragments
// from their raw q rows, split in registers, and P V takes them from the S
// accumulator, whose keys 2t and 2t + 1 of each 8-key block stand where the
// A fragment expects k = t and t + 4: so V^T's slot 4sg + i (k-step sg / 2)
// holds key 8 (sg / 2) + sg % 2 + 2i. Each tile is split once a block,
// not once a warp, and B is read from shared memory inside the tensor
// cores: at Dh 64 the f32 flash kernel took less than half the time of
// its mma.sync design on an H100 (PERF.md section 6).

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
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a K-major operand in the unswizzled core-matrix layout
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo) {
  return ((uint64_t)(tma::smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t(lbo >> 4) << 16) | (uint64_t(128 >> 4) << 32);
}

// descriptor of a K-major operand in the 128-byte swizzled layout TMA
// writes (rows of 32 f32, 8-row groups 1024 bytes apart, the tile 1024-byte
// aligned), from its shared-memory address in 16-byte units (a k-step of 8
// starts 2 units further)
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr16) {
  return addr16 | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// d (64xN f32) (+)= a (64x8 tf32 in registers: a warp's 16 rows in the
// mma.m16n8k8 A layout) * b (8xN tf32, K-major in shared memory), for the
// N the kernels use: the N / 2 accumulators are %0.., then a, b and the
// accumulate flag.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate);

#define TF32X3_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TF32X3_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define TF32X3_R1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define TF32X3_R2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define TF32X3_R3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define TF32X3_R4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define TF32X3_R5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define TF32X3_R6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define TF32X3_R7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define TF32X3_R8 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define TF32X3_R9 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define TF32X3_WGMMA(N, REGS, A, B, ACC, ...)                              \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_tf32<N>(                           \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,               \
      int accumulate) {                                                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " ACC ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                    \
                 "k8.f32.tf32.tf32 {" REGS "}, {" A "}, " B                \
                 ", p, 1, 1;\n}\n"                                         \
                 : __VA_ARGS__                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),     \
                   "r"(accumulate));                                       \
  }
TF32X3_WGMMA(32, TF32X3_R0 TF32X3_R1, "%16, %17, %18, %19", "%20", "%21",
             TF32X3_D8(0), TF32X3_D8(8))
TF32X3_WGMMA(64, TF32X3_R0 TF32X3_R1 TF32X3_R2 TF32X3_R3, "%32, %33, %34, %35",
             "%36", "%37", TF32X3_D8(0), TF32X3_D8(8), TF32X3_D8(16),
             TF32X3_D8(24))
TF32X3_WGMMA(96, TF32X3_R0 TF32X3_R1 TF32X3_R2 TF32X3_R3 TF32X3_R4 TF32X3_R5,
             "%48, %49, %50, %51", "%52", "%53", TF32X3_D8(0), TF32X3_D8(8),
             TF32X3_D8(16), TF32X3_D8(24), TF32X3_D8(32), TF32X3_D8(40))
TF32X3_WGMMA(112, TF32X3_R0 TF32X3_R1 TF32X3_R2 TF32X3_R3 TF32X3_R4 TF32X3_R5
             TF32X3_R6, "%56, %57, %58, %59", "%60", "%61", TF32X3_D8(0),
             TF32X3_D8(8), TF32X3_D8(16), TF32X3_D8(24), TF32X3_D8(32),
             TF32X3_D8(40), TF32X3_D8(48))
TF32X3_WGMMA(128, TF32X3_R0 TF32X3_R1 TF32X3_R2 TF32X3_R3 TF32X3_R4 TF32X3_R5
             TF32X3_R6 TF32X3_R7, "%64, %65, %66, %67", "%68", "%69",
             TF32X3_D8(0), TF32X3_D8(8), TF32X3_D8(16), TF32X3_D8(24),
             TF32X3_D8(32), TF32X3_D8(40), TF32X3_D8(48), TF32X3_D8(56))
TF32X3_WGMMA(160, TF32X3_R0 TF32X3_R1 TF32X3_R2 TF32X3_R3 TF32X3_R4 TF32X3_R5
             TF32X3_R6 TF32X3_R7 TF32X3_R8 TF32X3_R9, "%80, %81, %82, %83",
             "%84", "%85", TF32X3_D8(0), TF32X3_D8(8), TF32X3_D8(16),
             TF32X3_D8(24), TF32X3_D8(32), TF32X3_D8(40), TF32X3_D8(48),
             TF32X3_D8(56), TF32X3_D8(64), TF32X3_D8(72))
#undef TF32X3_WGMMA
#undef TF32X3_D8
#undef TF32X3_R0
#undef TF32X3_R1
#undef TF32X3_R2
#undef TF32X3_R3
#undef TF32X3_R4
#undef TF32X3_R5
#undef TF32X3_R6
#undef TF32X3_R7
#undef TF32X3_R8
#undef TF32X3_R9

// the 3xTF32 step on a warpgroup; first: hi and lo start from it
template <int N>
__device__ __forceinline__ void wgmma3(float (&hi)[N / 2], float (&lo)[N / 2],
                                       const FragA& a, uint64_t b_big,
                                       uint64_t b_small, bool first) {
  wgmma_tf32<N>(hi, a.big, b_big, !first);
  wgmma_tf32<N>(lo, a.big, b_small, !first);
  wgmma_tf32<N>(lo, a.small, b_big, 1);
}

template <int DH>
struct Pipe {
  static_assert(DH == 32 || DH == 64, "the wgmma pipeline takes Dh 32, 64");
  static constexpr int BQ = 128, BKV = 64, STAGES = 2, CONSUMER_WARPS = 8;
  static constexpr int RS = DH + 4;   // row stride of the raw tiles
  static constexpr uint32_t Q_BYTES = BQ * RS * 4, RAW_BYTES = BKV * RS * 4;
  static constexpr uint32_t K_LBO = BKV / 8 * 128, V_LBO = 64 / 8 * 128;
  static constexpr uint32_t K_BYTES = BKV * DH * 4, V_BYTES = 64 * BKV * 4;
  static constexpr uint32_t STAGE = 2 * K_BYTES + 2 * V_BYTES;
  static constexpr size_t SMEM = 128 + Q_BYTES + 2 * RAW_BYTES +
                                 STAGES * STAGE +
                                 (2 + 2 * STAGES) * sizeof(uint64_t);

  float* q;        // the block's BQ raw q rows
  float* k_raw;    // one raw K tile
  float* v_raw;    // one raw V tile
  uint8_t* ring;   // STAGES x (K big, K small, V^T big, V^T small)
  uint64_t* q_bar;
  uint64_t* raw_full;
  uint64_t* full;    // STAGES: a split tile is ready
  uint64_t* empty;   // STAGES: its consumers are done with it

  __device__ explicit Pipe(uint8_t* smem) {
    // TMA writes shared memory at 128-byte aligned addresses
    uint8_t* base = smem + ((128 - (tma::smem_addr(smem) & 127)) & 127);
    q = reinterpret_cast<float*>(base);
    k_raw = reinterpret_cast<float*>(base + Q_BYTES);
    v_raw = reinterpret_cast<float*>(base + Q_BYTES + RAW_BYTES);
    ring = base + Q_BYTES + 2 * RAW_BYTES;
    q_bar = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
    raw_full = q_bar + 1;
    full = raw_full + 1;
    empty = full + STAGES;
  }
  __device__ uint8_t* k_big(int s) const { return ring + s * STAGE; }
  __device__ uint8_t* k_small(int s) const { return k_big(s) + K_BYTES; }
  __device__ uint8_t* v_big(int s) const { return k_big(s) + 2 * K_BYTES; }
  __device__ uint8_t* v_small(int s) const { return v_big(s) + V_BYTES; }

  // the barriers, and V^T's rows past Dh zeroed once; the block then syncs
  __device__ void init(int tid, int threads) const {
    if (tid == 0) {
      tma::mbar_init(q_bar, 1);
      tma::mbar_init(raw_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        tma::mbar_init(&full[s], 1);
        tma::mbar_init(&empty[s], CONSUMER_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (DH < 64) {
      for (int s = 0; s < STAGES; ++s) {
        uint4* vt = reinterpret_cast<uint4*>(v_big(s));
        for (int e = tid; e < 2 * V_BYTES / 16; e += threads)
          vt[e] = make_uint4(0, 0, 0, 0);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  }

  // The producer warpgroup (ct = 0..127): cq the TMA coordinates of the q
  // rows, ckv those of KV tile 0, whose dimension `row` steps 64 a tile.
  __device__ void produce(const CUtensorMap* map_q, const CUtensorMap* map_k,
                          const CUtensorMap* map_v, const int (&cq)[4],
                          int (&ckv)[4], int row, int n_tiles, int ct) const {
    if (ct == 0) {
      tma::mbar_expect_tx(q_bar, Q_BYTES);
      tma::tma_load_4d(q, map_q, q_bar, cq[0], cq[1], cq[2], cq[3]);
      tma::mbar_expect_tx(raw_full, 2 * RAW_BYTES);
      tma::tma_load_4d(k_raw, map_k, raw_full, ckv[0], ckv[1], ckv[2],
                       ckv[3]);
      tma::tma_load_4d(v_raw, map_v, raw_full, ckv[0], ckv[1], ckv[2],
                       ckv[3]);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      tma::mbar_wait(raw_full, j & 1);
      if (j >= STAGES) tma::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      // K: four columns of one key a thread, one 16-byte core-matrix row
      for (int e = ct; e < BKV * (DH / 4); e += 128) {
        const int r = e % BKV, c4 = e / BKV;
        const float4 x =
            *reinterpret_cast<const float4*>(k_raw + r * RS + 4 * c4);
        uint4 hi, lo;
        split_tf32(x.x, hi.x, lo.x);
        split_tf32(x.y, hi.y, lo.y);
        split_tf32(x.z, hi.z, lo.z);
        split_tf32(x.w, hi.w, lo.w);
        const uint32_t off = (r / 8) * 128 + c4 * K_LBO + (r % 8) * 16;
        *reinterpret_cast<uint4*>(k_big(s) + off) = hi;
        *reinterpret_cast<uint4*>(k_small(s) + off) = lo;
      }
      // V^T: four key slots of one column a thread
      for (int e = ct; e < DH * (BKV / 4); e += 128) {
        const int d = e % DH, sg = e / DH;
        const float* x = v_raw + (8 * (sg / 2) + sg % 2) * RS + d;
        uint4 hi, lo;
        split_tf32(x[0], hi.x, lo.x);
        split_tf32(x[2 * RS], hi.y, lo.y);
        split_tf32(x[4 * RS], hi.z, lo.z);
        split_tf32(x[6 * RS], hi.w, lo.w);
        const uint32_t off = (d / 8) * 128 + sg * V_LBO + (d % 8) * 16;
        *reinterpret_cast<uint4*>(v_big(s) + off) = hi;
        *reinterpret_cast<uint4*>(v_small(s) + off) = lo;
      }
      // wgmma (the async proxy) reads the split; the raw tile is free
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (ct == 0) {
        tma::mbar_arrive(&full[s]);
        if (j + 1 < n_tiles) {
          ckv[row] += BKV;
          tma::mbar_expect_tx(raw_full, 2 * RAW_BYTES);
          tma::tma_load_4d(k_raw, map_k, raw_full, ckv[0], ckv[1], ckv[2],
                           ckv[3]);
          tma::tma_load_4d(v_raw, map_v, raw_full, ckv[0], ckv[1], ckv[2],
                           ckv[3]);
        }
      }
    }
  }

  // S = Q K^T of stage s for a consumer warpgroup, into hi and lo: qa the
  // warp's q row g + column t (q rows RS apart), four k-steps of split A
  // fragments at a time
  __device__ void qk(const float* qa, int s, float (&hi)[32],
                     float (&lo)[32]) const {
#pragma unroll
    for (int k0 = 0; k0 < DH / 8; k0 += 4) {
      FragA a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* x = qa + 8 * (k0 + i);
        a[i].set(x[0], x[8 * RS], x[4], x[8 * RS + 4]);
      }
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t step = (k0 + i) * 2 * K_LBO;
        wgmma3<BKV>(hi, lo, a[i], smem_desc(k_big(s) + step, K_LBO),
               smem_desc(k_small(s) + step, K_LBO), k0 + i == 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(hi);
      fence_regs(lo);
    }
  }

  // O += P V of stage s over its first `steps` 8-key steps, P the S
  // accumulator's layout
  __device__ void pv(const float (&p)[32], int s, int steps, float (&hi)[32],
                     float (&lo)[32]) const {
    FragA a[BKV / 8];
#pragma unroll
    for (int kk = 0; kk < BKV / 8; ++kk)
      a[kk].set(p[4 * kk], p[4 * kk + 2], p[4 * kk + 1], p[4 * kk + 3]);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 8; ++kk)
      if (kk < steps) {
        const uint32_t step = kk * 2 * V_LBO;
        wgmma3<64>(hi, lo, a[kk], smem_desc(v_big(s) + step, V_LBO),
               smem_desc(v_small(s) + step, V_LBO), false);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(hi);
    fence_regs(lo);
  }
};

}  // namespace tf32x3
