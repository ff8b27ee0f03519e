// Grouped unpack dot on the int8 tensor cores: (G, M, K) uint8 plane
// groups x int8 weights -> (t, M, N) f32, out[p] = plane_p @ W with plane p
// = bit (p % 8) of group p / 8. Only the t live planes are written.
//
// Replaces the TPU kernel src/repro/kernels/spike_matmul.py:
// _spike_matmul_grouped for int8 weights (csrc/unpack_dot.cu stays the
// kernel for f32 weights). W enters K-major: w_kt is (N, K) int8 with a row
// stride that is a multiple of 16 bytes (the plan builds it once,
// infer/compile.py), because 8-bit wgmma reads both operands K-major.
//
// Bound on this card: at fc1 of the paper config (x (1, 1568, 512), W
// (512, 2048), t = 4) the 13.2e9 operations take 6.7 us at the int8 tensor
// cores' 1,979 TOP/s, while the 51 MB f32 output alone takes 15 us at
// 3.35 TB/s: the output write bounds it.
// Exactness: spikes are u8 {0, 1} and weights s8, so every product is exact
// and every s32 sum is an integer of magnitude <= 127 K < 2^24 (the wrapper
// refuses K >= 132,104): the s32 sum and its f32 conversion are exact, and
// the result equals the plain version's f32 matmul of the unpacked planes
// by the int-valued weights bit for bit.
// Design: one block of two warpgroups per (128 A-rows, 128 columns, plane
// group). The live planes of the group are extra rows of A: with NP planes
// in the group, a block covers RB = 128 / NP rows of x, and A-row
// a = p * RB + r holds bit p of row r, so one B tile serves every live
// plane. Per 128-byte K step, every thread expands 16 packed bytes into NP
// rows of u8 {0, 1} in shared memory (written in the 128-byte swizzle that
// wgmma's descriptor reads); thread 0 keeps B tiles of 128 columns x 128
// bytes coming by TMA (128-byte swizzle) into a STAGES-deep mbarrier ring,
// two K steps ahead. Each warpgroup issues wgmma.m64n128k32.s32.u8.s8 for
// its 64 A-rows, 4 per K step, into s32 accumulators in registers; the
// epilogue converts them to f32 and stores pairs of columns (8-byte stores,
// a quad of lanes covering 32 contiguous bytes of a row). The expanded
// planes never reach device memory. K past the weights' K reads zero
// weights (TMA fills out-of-bounds boxes with zeros) and zero spikes.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 128, STAGES = 3, THREADS = 256;
constexpr int A_BYTES = BM * BK;   // 16 KB
constexpr int B_BYTES = BN * BK;   // 16 KB

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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "     \
  "%58, %59, %60, %61, %62, %63}"
#define R8(d, i)                                                            \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),               \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64x128 s32) (+)= A (64x32 u8, K-major in shared memory) * B (32x128
// s8, K-major in shared memory: 128 rows of W^T)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 " WG_D64
      ", %64, %65, p;\n}\n"
      : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24), R8(d, 32), R8(d, 40),
        R8(d, 48), R8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// bit ``bit`` of each of 4 bytes -> 4 bytes of {0, 1}
__device__ __forceinline__ uint32_t bits4(uint32_t w, int bit) {
  return (w >> bit) & 0x01010101u;
}

struct Params {
  const uint8_t* x;   // (G, M, K)
  float* out;         // (t, M, N)
  int t, m, k, n;
  int vec;            // 16-byte loads of x: K % 16 == 0 and x aligned
};

__global__ void __launch_bounds__(THREADS, 1)
    unpack_dot_s8_kernel(const __grid_constant__ CUtensorMap map_w,
                         const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern and the descriptors assume it
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_s = base;                                  // BM x BK
  uint8_t* b_s = a_s + A_BYTES;                         // STAGES x BN x BK
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + STAGES * B_BYTES);

  const int g = blockIdx.z;
  const int np = min(8, p.t - 8 * g);      // live planes of this group
  const int rb = BM / np;                  // x rows a block covers
  const int r0 = blockIdx.y * rb;
  if (r0 >= p.m) return;                   // a group with fewer planes
  const int col0 = blockIdx.x * BN;
  const int n_k = (p.k + BK - 1) / BK;
  const int tid = threadIdx.x;
  const uint8_t* xg = p.x + (long long)g * p.m * p.k;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < STAGES - 1 && j < n_k; ++j) {
      mbar_expect_tx(&full[j], B_BYTES);
      tma_load_2d(b_s + j * B_BYTES, &map_w, &full[j], j * BK, col0);
    }
  }

  const int wg = tid / 128, lane = tid % 32, warp = (tid / 32) % 4;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int j = 0; j < n_k; ++j) {
    __syncthreads();   // every warpgroup's wgmma of step j - 1 is done
    if (tid == 0 && j + STAGES - 1 < n_k) {
      const int jn = j + STAGES - 1, s = jn % STAGES;  // stage of step j - 1
      mbar_expect_tx(&full[s], B_BYTES);
      tma_load_2d(b_s + s * B_BYTES, &map_w, &full[s], jn * BK, col0);
    }
    // A: 16 bytes of x a thread, expanded into np swizzled rows
    const int k0 = j * BK;
    for (int e = tid; e < rb * (BK / 16); e += THREADS) {
      const int rl = e / (BK / 16), c = e % (BK / 16);
      const int row = r0 + rl, kk = k0 + c * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < p.m && kk < p.k) {
        const uint8_t* src = xg + (long long)row * p.k + kk;
        if (p.vec) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          uint8_t b[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) b[i] = kk + i < p.k ? src[i] : 0;
          v.x = b[0] | b[1] << 8 | b[2] << 16 | (uint32_t)b[3] << 24;
          v.y = b[4] | b[5] << 8 | b[6] << 16 | (uint32_t)b[7] << 24;
          v.z = b[8] | b[9] << 8 | b[10] << 16 | (uint32_t)b[11] << 24;
          v.w = b[12] | b[13] << 8 | b[14] << 16 | (uint32_t)b[15] << 24;
        }
      }
      for (int pl = 0; pl < np; ++pl) {
        const int a = pl * rb + rl;
        const uint4 bits = make_uint4(bits4(v.x, pl), bits4(v.y, pl),
                                      bits4(v.z, pl), bits4(v.w, pl));
        *reinterpret_cast<uint4*>(a_s + a * BK + ((c ^ (a & 7)) << 4)) = bits;
      }
    }
    // make the generic-proxy stores visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8(acc, smem_desc(a_s + wg * 64 * BK + kk * 32),
               smem_desc(b_s + s * B_BYTES + kk * 32), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

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
      const float v0 = (float)acc[4 * nb + 2 * h];
      const float v1 = (float)acc[4 * nb + 2 * h + 1];
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

// x: (G, M, K) uint8, G = ceil(t / 8); w_kt: (N, K) int8 with row stride
// ldw bytes (a multiple of 16, base 16-byte aligned), unit column stride;
// out: (t, M, N) f32, contiguous; K < 132,104.
extern "C" int unpack_dot_s8_launch(const uint8_t* x, const int8_t* w_kt,
                                    float* out, int t, int m, int k, int n,
                                    long long ldw, void* stream) {
  if (t == 0 || m == 0 || n == 0) return 0;
  if (t < 0 || k <= 0 || k >= 132104 || ldw < k || ldw % 16 ||
      (uintptr_t)w_kt % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorInvalidValue;
  // The map is encoded on the host at each launch and passed by value, so
  // a CUDA graph that captures this launch keeps it, with the K-major
  // weights' address of that moment. Replays are right because a plan's
  // K-major copies never move once built.
  CUtensorMap map;
  const cuuint64_t gdim[2] = {(cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t gstride[1] = {(cuuint64_t)ldw};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t estride[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)w_kt, gdim,
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
  p.vec = k % 16 == 0 && (uintptr_t)x % 16 == 0;
  const int groups = (t + 7) / 8;
  const int rb_min = BM / (t < 8 ? t : 8);   // the group with most planes
  const dim3 grid((n + BN - 1) / BN, (m + rb_min - 1) / rb_min, groups);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + A_BYTES + STAGES * B_BYTES +
                      STAGES * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      unpack_dot_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  unpack_dot_s8_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(map, p);
  return (int)cudaGetLastError();
}
