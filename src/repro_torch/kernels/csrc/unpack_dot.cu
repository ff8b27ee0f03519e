// Grouped unpack dot on the bf16 tensor cores: (G, M, K) uint8 plane
// groups x f32 weights -> (t, M, N) f32, out[p] = plane_p @ W with plane p
// = bit (p % 8) of group p / 8. Only the t live planes are written.
//
// Replaces the TPU kernel src/repro/kernels/spike_matmul.py:
// _spike_matmul_grouped for f32 weights (csrc/unpack_dot_s8.cu is the
// kernel for int8 weights).
//
// Weights as three bf16 terms. W enters as w3, (3, N, K) bf16 K-major:
// hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), built once per
// layer by the planner (infer/compile.py, kernels/spike_matmul.py
// bf16x3_weights), which checks hi + mid + lo == w for every weight: three
// 8-bit significands cover f32's 24 wherever lo stays a normal bf16 (|w| >=
// ~2^-110). A spike is exactly 0 or 1 in bf16, so every product s * term is
// exact, and the only departure from an f32 sum is the order and rounding
// of the accumulation (TF32, with its 10-bit significand, is not used). For
// integer-valued |w| <= 256, hi == w and mid = lo = 0: every partial sum is
// an integer below 2^24 and the result is exact in any order.
//
// Bound on this card: at fc1 of the paper config (x (1, 1568, 512), W (512,
// 2048), t = 4) the three bf16 products are 3 x 2 x 6272 x 512 x 2048 =
// 39.5 GFLOP, 0.040 ms at the dense bf16 rate of 989 TFLOP/s; the 51 MB f32
// output alone takes 0.015 ms at 3.35 TB/s: the products bound it. (The f32
// units' 67 TFLOP/s put one product at 0.196 ms, the old kernel's bound.)
//
// Design: one block of two warpgroups per (128 A-rows, 128 columns, plane
// group), laid out as csrc/unpack_dot_s8.cu. The live planes of the group
// are extra rows of A: with NP planes a block covers RB = 128 / NP rows of
// x, and A-row a = p * RB + r holds bit p of row r, so one B tile serves
// every live plane. Per 64-deep K step, every thread expands packed bytes
// into bf16 {0, 1} (8 bytes of x -> 16 bytes of A a plane) in shared memory,
// in the 128-byte swizzle that wgmma's descriptor reads; A is double
// buffered, so step j + 1's rows are expanded (its bytes loaded from device
// memory before step j's products are issued) while step j's wgmma run.
// Thread 0 keeps the three terms' B tiles (128 columns x 64 K, 128-byte
// swizzle, 48 KB a step) coming by TMA into a 3-deep mbarrier ring. Each
// warpgroup issues wgmma.m64n128k16.f32.bf16.bf16 for its 64 A-rows, three
// per 16-deep K slice, 12 a step. The epilogue stores pairs of columns
// (8-byte stores, a quad of lanes covering 32 contiguous bytes of a row).
// The expanded planes never reach device memory. K past the weights' K
// reads zero weights (TMA fills out-of-bounds boxes with zeros) and zero
// spikes.
//
// Accumulation. Inside a wgmma the tensor cores add the products into the
// accumulator without rounding each add to nearest (they align to the
// largest term and drop the bits below). A first version summed all of K
// into one accumulator (12 wgmma a step, the step's sum then added to a
// master sum): in the paper config's default f32 plan it flipped 85,270
// spikes a step against the plain route and moved the logits 0.006, out of
// the 1e-3 gate, where the plain dot summed in reversed K order flips 3 and
// moves no logit, and one summed in f64 and rounded once flips none
// (scripts/unpack_dot_order.py). So each
// slice's hi products (8-bit significands, 16 terms) are summed from zero
// into their own accumulator, exact unless the slice's weights span more
// than ~12 binades, and added to the thread's master f32 sum with ordinary
// round-to-nearest adds, 4 a step; the lo and mid products, ~2^-8 of the
// sum and smaller, share a second accumulator over all of K, added last.
// The result is an f32 sum of K/16 + 1 terms, each add rounded to nearest:
// the default f32 plan then gives the plain route's logits bit for bit. A
// slice's hi group is committed apart from its mid/lo group, so the master
// adds of slice kk run while slice kk's mid/lo products do. Cost: three
// 64-float accumulators a thread (241 registers, no spills) and 17-20% of
// the first version's speed.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;     // A-rows, columns, K a step
constexpr int TERMS = 3, STAGES = 3, THREADS = 256;
constexpr int ROW_BYTES = BK * 2;              // 128: one swizzle row
constexpr int CHUNKS = ROW_BYTES / 16;         // 16-byte chunks a row
constexpr int A_BYTES = BM * ROW_BYTES;        // 16 KB
constexpr int B_TERM_BYTES = BN * ROW_BYTES;   // 16 KB
constexpr int B_BYTES = TERMS * B_TERM_BYTES;  // 48 KB a stage
// 8-byte items of x (one row, 8 K values) a thread expands a step: RB * 8
// items over 256 threads, at most 4 (one plane, RB = 128)
constexpr int MAX_ITEMS = BM * CHUNKS / THREADS;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// returns once the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
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
// returns once at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "     \
  "%58, %59, %60, %61, %62, %63}"
#define F8(d, i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64x128 f32) = A (64x16 bf16, K-major in shared memory) * B (16x128
// bf16, K-major in shared memory: 128 rows of one term of W^T), plus d
// itself where ``accumulate`` is nonzero
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// bit ``bit`` of each of 8 bytes -> 8 bf16 of 0.0 or 1.0 (0x3F80): each
// pair of {0, 1} bytes spread into the two halves of a word, times 0x3F80
__device__ __forceinline__ uint4 bf16_bits(uint2 v, int bit) {
  const uint32_t lo = (v.x >> bit) & 0x01010101u;
  const uint32_t hi = (v.y >> bit) & 0x01010101u;
  return make_uint4(__byte_perm(lo, 0, 0x4140) * 0x3F80u,
                    __byte_perm(lo, 0, 0x4342) * 0x3F80u,
                    __byte_perm(hi, 0, 0x4140) * 0x3F80u,
                    __byte_perm(hi, 0, 0x4342) * 0x3F80u);
}

// K slice kk of a step's A (a) and B stage (b): its hi products into hi,
// from zero (one commit group), then its lo and mid products into ml, from
// zero only for the first slice of all (the next group)
__device__ __forceinline__ void issue_slice(float (&hi)[64], float (&ml)[64],
                                            const uint8_t* a, const uint8_t* b,
                                            int kk, bool first) {
  const uint64_t da = smem_desc(a + kk * 32);
  wgmma_bf16(hi, da, smem_desc(b + kk * 32), 0);
  wgmma_commit();
  wgmma_bf16(ml, da, smem_desc(b + 2 * B_TERM_BYTES + kk * 32), !first);
  wgmma_bf16(ml, da, smem_desc(b + B_TERM_BYTES + kk * 32), 1);
  wgmma_commit();
}

struct Params {
  const uint8_t* x;   // (G, M, K)
  float* out;         // (t, M, N)
  int t, m, k, n;
  int vec;            // 8-byte loads of x: K % 8 == 0 and x aligned
};

// this thread's items of x for K step j: item e covers x row r0 + e / 8,
// K values [64 j + 8 (e % 8), + 8); zeros past M and K
__device__ __forceinline__ void load_x(uint2 (&xv)[MAX_ITEMS],
                                       const uint8_t* xg, const Params& p,
                                       int r0, int items, int j, int tid) {
#pragma unroll
  for (int i = 0; i < MAX_ITEMS; ++i) {
    const int e = tid + i * THREADS;
    xv[i] = make_uint2(0u, 0u);
    const int row = r0 + e / CHUNKS, kk = j * BK + (e % CHUNKS) * 8;
    if (e < items && row < p.m && kk < p.k) {
      const uint8_t* src = xg + (long long)row * p.k + kk;
      if (p.vec) {
        xv[i] = *reinterpret_cast<const uint2*>(src);
      } else {
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (kk + b < p.k) w[b / 4] |= (uint32_t)src[b] << (8 * (b % 4));
        xv[i] = make_uint2(w[0], w[1]);
      }
    }
  }
}

// the items as np swizzled bf16 rows of A: A-row pl * rb + r, 16-byte chunk
// c stored at chunk c ^ (A-row % 8)
__device__ __forceinline__ void expand_x(const uint2 (&xv)[MAX_ITEMS],
                                         uint8_t* a_s, int np, int rb,
                                         int items, int tid) {
#pragma unroll
  for (int i = 0; i < MAX_ITEMS; ++i) {
    const int e = tid + i * THREADS;
    if (e < items) {
      const int rl = e / CHUNKS, c = e % CHUNKS;
      for (int pl = 0; pl < np; ++pl) {
        const int a = pl * rb + rl;
        *reinterpret_cast<uint4*>(a_s + a * ROW_BYTES + ((c ^ (a & 7)) << 4)) =
            bf16_bits(xv[i], pl);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    unpack_dot_kernel(const __grid_constant__ CUtensorMap map_w,
                      const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern and the descriptors assume it
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_s = base;                                  // 2 x BM x 128 B
  uint8_t* b_s = a_s + 2 * A_BYTES;                     // STAGES x 3 terms
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + STAGES * B_BYTES);

  const int g = blockIdx.z;
  const int np = min(8, p.t - 8 * g);      // live planes of this group
  const int rb = BM / np;                  // x rows a block covers
  const int r0 = blockIdx.y * rb;
  if (r0 >= p.m) return;                   // a group with fewer planes
  const int col0 = blockIdx.x * BN;
  const int n_k = (p.k + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int items = rb * CHUNKS;
  const uint8_t* xg = p.x + (long long)g * p.m * p.k;

  // stage s <- the three terms' tiles of K step j
  auto load_b = [&](int s, int j) {
    mbar_expect_tx(&full[s], B_BYTES);
#pragma unroll
    for (int q = 0; q < TERMS; ++q)
      tma_load_3d(b_s + s * B_BYTES + q * B_TERM_BYTES, &map_w, &full[s],
                  j * BK, col0, q);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < STAGES && j < n_k; ++j) load_b(j, j);
  }

  uint2 xv[MAX_ITEMS];
  load_x(xv, xg, p, r0, items, 0, tid);
  expand_x(xv, a_s, np, rb, items, tid);
  // make the generic-proxy stores visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = tid / 128, lane = tid % 32, warp = (tid / 32) % 4;
  // hi: one 16-deep slice of hi products, from zero; ml: every mid and lo
  // product of the whole K; sum: the master sum of the slices' hi sums
  float hi[64], ml[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) hi[i] = ml[i] = sum[i] = 0.f;

  for (int j = 0; j < n_k; ++j) {
    const bool more = j + 1 < n_k;
    // step j + 1's bytes are in flight while step j's products run
    if (more) load_x(xv, xg, p, r0, items, j + 1, tid);
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const uint8_t* a = a_s + (j & 1) * A_BYTES + wg * 64 * ROW_BYTES;
    const uint8_t* b = b_s + s * B_BYTES;
    fence_regs(hi);
    fence_regs(ml);
    wgmma_fence();
    issue_slice(hi, ml, a, b, 0, j == 0);
    if (more) {
      // A[(j + 1) % 2] was last read by step j - 1's products, which both
      // warpgroups finished before the barrier that ended step j - 1
      expand_x(xv, a_s + ((j + 1) & 1) * A_BYTES, np, rb, items, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_wait<1>();        // slice kk's hi group done; its ml may run on
      fence_regs(hi);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += hi[i];
      if (kk + 1 < BK / 16) {
        fence_regs(hi);
        wgmma_fence();
        issue_slice(hi, ml, a, b, kk + 1, false);
      }
    }
    wgmma_wait<0>();
    __syncthreads();   // A of step j + 1 written; stage s read by both
    if (tid == 0 && j + STAGES < n_k) load_b(s, j + STAGES);
  }
  fence_regs(ml);
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] += ml[i];

  // epilogue: A-row a -> plane 8g + a / rb, x row r0 + a % rb
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = wg * 64 + warp * 16 + lane / 4 + 8 * h;
    const int pl = a / rb, row = r0 + a % rb;
    if (pl >= np || row >= p.m) continue;
    float* orow = p.out + ((long long)(8 * g + pl) * p.m + row) * p.n;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int col = col0 + nb * 8 + (lane % 4) * 2;
      const float v0 = sum[4 * nb + 2 * h], v1 = sum[4 * nb + 2 * h + 1];
      if ((p.n & 1) == 0) {
        if (col < p.n)
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < p.n) orow[col] = v0;
        if (col + 1 < p.n) orow[col + 1] = v1;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: (G, M, K) uint8, G = ceil(t / 8); w3: (3, N, K) bf16, term q at
// element offset q * ldt, row n at n * ldw, unit K stride (ldw and ldt
// multiples of 8 elements, base 16-byte aligned); out: (t, M, N) f32,
// contiguous.
extern "C" int unpack_dot_launch(const uint8_t* x, const void* w3, float* out,
                                 int t, int m, int k, int n, long long ldw,
                                 long long ldt, void* stream) {
  if (t == 0 || m == 0 || n == 0) return 0;
  if (t < 0 || k <= 0 || ldw < k || ldw % 8 || ldt < (long long)n * ldw ||
      ldt % 8 || (uintptr_t)w3 % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorInvalidValue;
  // The map is encoded on the host at each launch and passed by value, so
  // a CUDA graph that captures this launch keeps it, with the split
  // weights' address of that moment. Replays are right because a plan's
  // split copies never move once built.
  CUtensorMap map;
  const cuuint64_t gdim[3] = {(cuuint64_t)k, (cuuint64_t)n, TERMS};
  const cuuint64_t gstride[2] = {(cuuint64_t)ldw * 2, (cuuint64_t)ldt * 2};
  const cuuint32_t box[3] = {BK, BN, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, (void*)w3, gdim,
             gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.out = out;
  p.t = t;
  p.m = m;
  p.k = k;
  p.n = n;
  p.vec = k % 8 == 0 && (uintptr_t)x % 8 == 0;
  const int groups = (t + 7) / 8;
  const int rb_min = BM / (t < 8 ? t : 8);   // the group with most planes
  const dim3 grid((n + BN - 1) / BN, (m + rb_min - 1) / rb_min, groups);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + 2 * A_BYTES + STAGES * B_BYTES +
                      STAGES * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      unpack_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  unpack_dot_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(map, p);
  return (int)cudaGetLastError();
}
