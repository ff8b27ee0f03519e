// Fused TFLIF -> pack -> byte-LUT gather over a producer/consumer pair:
// x (T, R, K) f32 producer accumulators, bias and v_th (K,), table
// (C, 256, N) consumer chunk-partial sums -> spikes (G, R, K) uint8, the
// producer's packed LIF output, and acc (T, R, N) f32, the consumer's
// accumulators: acc[t, r, :] = sum over c ascending of table[c, b, :],
// with bit i of index byte b the spike of input 8c+i at step t.
//
// Replaces the TPU kernel src/repro/kernels/fused.py:tflif_lut_matmul,
// which keeps the whole (C, 256, N) table resident per grid step. At fc2 of
// the paper config that table is 64 MiB (int16) or 128 MiB (f32), hundreds
// of times the 227 KB of shared memory a block may use, so that layout
// cannot be carried over.
//
// Bound on this card: device memory moves x, the table and the outputs
// once (~0.06 ms at fc2, batch 8), but every (t, row, col) fold gathers C
// table entries, and a gather straight from L2 would move T*R*C*N entries
// (3.3 GB for the f32 table at fc2). So the table is staged in shared
// memory a slab at a time and every slab entry serves ROWS * T index bytes:
// the L2 -> SM traffic is (R / ROWS) table reads, and the gathers run at
// shared memory's rate.
// Design: a block owns ROWS = 1024 / TT rows (256 at T <= 4) and BN = 32
// columns, one per lane, and walks the chunks in ascending order. For each
// chunk its (256, BN) table slab arrives by TMA in a STAGES-deep mbarrier
// ring that thread 0 keeps STAGES chunks ahead (ragged N, whose rows TMA
// cannot address, copies the slab with plain loads instead). Every warp
// gathers for ROWS / 16 rows x T steps into f32 (or int32) accumulators in
// registers, 64 a thread; a warp's 32 lanes read 32 neighbouring entries of
// one slab row, free of bank conflicts. The column tiles of a row tile form
// one thread block cluster of up to 8 blocks, and the LIF runs once per
// row tile: the chunks go in groups of 8, each block of the cluster takes
// a share of a group's chunks (64 input neurons), runs their LIF over all
// T for the block's rows, forms index bytes by warp ballot (4 rows x 8
// neurons a warp) and stores them, 4 steps to a word, into the shared
// memory of every block of the cluster; one cluster barrier a group
// publishes them (index words sit in two slots: one group's are written
// while the previous group's are read). A thread loads 4 steps of x for
// all its pairs before it charges any. So x comes from device memory once
// per cluster, and the fc1 spikes never exist unpacked outside registers;
// the first cluster of a row tile writes the packed spikes.
// Exactness: the LIF charge uses the IEEE round-to-nearest intrinsics in
// the reference's op order (as csrc/tflif.cu does; dividing by a power-of-
// two tau is the exact multiplication by its inverse); the fold is
// ascending chunk, int32 for int16 tables and f32 starting from chunk 0's
// entry for f32 tables, the defined reduction tree of lut_matmul. K not a
// multiple of 8 pads with x = 0, bias = 0, v_th = 1: such a neuron never
// fires, so its bit is 0 and selects build_lut's zero rows.
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 32;           // columns a block, one per lane
constexpr int GROUP = 8;         // chunks whose index bytes go out at once
constexpr int STAGES = 4;
constexpr int MAX_CLUSTER = 8;

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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// a 32-bit store into the shared memory of block ``rank`` of the cluster
__device__ __forceinline__ void st_cluster(const void* local, uint32_t rank,
                                           uint32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(remote), "r"(v)
               : "memory");
}

struct Params {
  const float* x;
  const float* bias;
  const float* vth;
  const void* table;     // (C, 256, N)
  uint8_t* spikes;
  float* out;
  int t, r, k, n, chunks, cluster;
  float tau, inv_tau;
  int tau_pow2;          // tau a power of two: divide by multiplying
};

// TT: timestep capacity (4..64); ROWS * TT = 1024 keeps 64 accumulators a
// thread; TMA: slabs by TMA (N rows 16-byte aligned) or by plain loads.
template <int TT, bool TMA, typename Tab, typename Acc>
__global__ void __launch_bounds__(THREADS, 1)
    fused_lif_lut_kernel(const __grid_constant__ CUtensorMap map,
                         const Params p) {
  constexpr int ROWS = 1024 / TT;
  constexpr int RPW = ROWS / WARPS;       // rows a warp gathers for
  constexpr int TW = (TT + 3) / 4;        // index words a (row, chunk)
  constexpr int SLAB = 256 * BN;          // entries a stage
  constexpr int ITEMS = ROWS * 8;         // (row, input) pairs of a chunk
  constexpr int LI = ITEMS > THREADS ? ITEMS / THREADS : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  Tab* slabs = reinterpret_cast<Tab*>(base);
  uint32_t* sidx = reinterpret_cast<uint32_t*>(
      base + (TMA ? STAGES : 1) * SLAB * sizeof(Tab));  // [2][GROUP][ROWS][TW]
  uint64_t* full = reinterpret_cast<uint64_t*>(sidx + 2 * GROUP * ROWS * TW);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const uint32_t rank = cluster_rank();
  const int row0 = blockIdx.y * ROWS;
  const int col0 = blockIdx.x * BN;
  const bool has_cols = col0 < p.n;
  const bool write_spikes = (int)blockIdx.x < p.cluster;  // first cluster
  const Tab* table = static_cast<const Tab*>(p.table);

  if (TMA && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // barriers ready; every block of the cluster running
  if (TMA && has_cols && tid == 0)
    for (int c = 0; c < STAGES && c < p.chunks; ++c) {
      mbar_expect_tx(&full[c], SLAB * sizeof(Tab));
      tma_load_2d(slabs + c * SLAB, &map, &full[c], col0, c * 256);
    }

  Acc acc[RPW][TT];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[i][t] = (Acc)0;

  for (int c = 0; c < p.chunks; ++c) {
    const int slot = (c / GROUP) & 1;
    if (c % GROUP == 0) {
      // the LIF of this block's share of the group's chunks: a thread runs
      // LI (row, input) pairs, lane = 8 * (row % 4) + i so that a warp
      // holds 4 rows x a chunk's 8 inputs, and loads 4 steps of x for all
      // of them before it charges any: one load latency per 4 steps
      for (int cc = rank; cc < GROUP && c + cc < p.chunks; cc += p.cluster) {
        if (tid >= ITEMS) break;     // whole warps
        const int i = tid & 7, kk = (c + cc) * 8 + i;
        const float b = kk < p.k ? p.bias[kk] : 0.f;
        const float th = kk < p.k ? p.vth[kk] : 1.f;
        const int rq = (tid >> 3) & 3;   // the row's byte in the ballot
        const long long step = (long long)p.r * p.k;
        bool live[LI];
        const float* xp[LI];
        float v[LI];
        unsigned packed[LI];
#pragma unroll
        for (int j = 0; j < LI; ++j) {
          const int row = row0 + ((tid + j * THREADS) >> 3);
          live[j] = row < p.r && kk < p.k;
          xp[j] = p.x + (long long)row * p.k + kk;
          v[j] = 0.f;
          packed[j] = 0;
        }
        for (int t0 = 0; t0 < p.t; t0 += 4) {
          float xv[LI][4];
#pragma unroll
          for (int j = 0; j < LI; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              xv[j][q] = live[j] && t0 + q < p.t ? xp[j][(t0 + q) * step]
                                                 : 0.f;
          unsigned word[LI];
#pragma unroll
          for (int j = 0; j < LI; ++j) word[j] = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int t = t0 + q;
            if (t >= p.t) break;
#pragma unroll
            for (int j = 0; j < LI; ++j) {
              const float d = __fsub_rn(__fadd_rn(xv[j][q], b), v[j]);
              const float h = __fadd_rn(
                  v[j], p.tau_pow2 ? __fmul_rn(d, p.inv_tau)
                                   : __fdiv_rn(d, p.tau));
              const bool s = h >= th;
              v[j] = s ? 0.f : h;
              const unsigned bits = __ballot_sync(0xffffffffu, s);
              word[j] |= ((bits >> (rq * 8)) & 0xffu) << (q * 8);
              packed[j] |= (unsigned)s << (t & 7);
              if ((t & 7) == 7 || t == p.t - 1) {
                if (write_spikes && live[j])
                  p.spikes[(t >> 3) * step + (xp[j] - p.x)] =
                      (uint8_t)packed[j];
                packed[j] = 0;
              }
            }
          }
          if (i == 0)
#pragma unroll
            for (int j = 0; j < LI; ++j) {
              const int rl = (tid + j * THREADS) >> 3;
              uint32_t* words =
                  sidx + ((slot * GROUP + cc) * ROWS + rl) * TW + (t0 >> 2);
              for (int q = 0; q < p.cluster; ++q)
                st_cluster(words, q, word[j]);
            }
        }
      }
      cluster_sync();   // the group's index words are in every block
    }
    if (!has_cols) continue;
    const int cc = c % GROUP;
    if (TMA) {
      mbar_wait(&full[c % STAGES], (c / STAGES) & 1);
    } else {
      for (int e = tid; e < SLAB; e += THREADS) {
        const int col = col0 + e % BN;
        slabs[e] = col < p.n ? table[((long long)c * 256 + e / BN) * p.n + col]
                             : (Tab)0;
      }
      __syncthreads();
    }
    const Tab* slab = slabs + (TMA ? c % STAGES : 0) * SLAB + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const uint32_t* words =
          sidx + ((slot * GROUP + cc) * ROWS + warp * RPW + i) * TW;
#pragma unroll
      for (int w = 0; w < TW; ++w) {
        const uint32_t word = words[w];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 4 * w + q;
          if (t < TT && t < p.t) {
            const Acc g = (Acc)slab[((word >> (8 * q)) & 0xffu) * BN];
            acc[i][t] = c == 0 ? g : acc[i][t] + g;
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    if (TMA && tid == 0 && c + STAGES < p.chunks) {
      const int s = c % STAGES;
      mbar_expect_tx(&full[s], SLAB * sizeof(Tab));
      tma_load_2d(slabs + s * SLAB, &map, &full[s], col0, (c + STAGES) * 256);
    }
  }
  if (!has_cols) return;
  const int col = col0 + lane;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = row0 + warp * RPW + i;
    if (row >= p.r || col >= p.n) continue;
#pragma unroll
    for (int t = 0; t < TT; ++t)
      if (t < p.t)
        p.out[((long long)t * p.r + row) * p.n + col] = (float)acc[i][t];
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

template <int TT, bool TMA, typename Tab, typename Acc>
int launch_one(const CUtensorMap& map, const Params& p, cudaStream_t s) {
  constexpr int ROWS = 1024 / TT;
  const size_t smem = 128 + (TMA ? STAGES : 1) * 256 * BN * sizeof(Tab) +
                      2 * GROUP * ROWS * ((TT + 3) / 4) * sizeof(uint32_t) +
                      STAGES * sizeof(uint64_t);
  auto kernel = fused_lif_lut_kernel<TT, TMA, Tab, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // column tiles (N = 0 still takes one: it writes the spikes), rounded up
  // to whole clusters
  const int tiles = p.n > 0 ? (p.n + BN - 1) / BN : 1;
  const int row_tiles = (p.r + ROWS - 1) / ROWS;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + p.cluster - 1) / p.cluster * p.cluster,
                     row_tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, map, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool TMA, typename Tab, typename Acc>
int launch_t(const CUtensorMap& map, const Params& p, cudaStream_t s) {
  if (p.t <= 4) return launch_one<4, TMA, Tab, Acc>(map, p, s);
  if (p.t <= 8) return launch_one<8, TMA, Tab, Acc>(map, p, s);
  if (p.t <= 16) return launch_one<16, TMA, Tab, Acc>(map, p, s);
  if (p.t <= 32) return launch_one<32, TMA, Tab, Acc>(map, p, s);
  return launch_one<64, TMA, Tab, Acc>(map, p, s);
}

template <typename Tab, typename Acc>
int launch(const float* x, const float* bias, const float* vth,
           const Tab* table, uint8_t* spikes, float* out, int t, int r, int k,
           int n, float tau, void* stream, CUtensorMapDataType dtype) {
  if (t == 0 || r == 0 || k == 0) return 0;
  if (t < 0 || t > 64 || n < 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.bias = bias;
  p.vth = vth;
  p.table = table;
  p.spikes = spikes;
  p.out = out;
  p.t = t;
  p.r = r;
  p.k = k;
  p.n = n;
  p.chunks = (k + 7) / 8;
  const int tiles = n > 0 ? (n + BN - 1) / BN : 1;
  p.cluster = tiles < MAX_CLUSTER ? tiles : MAX_CLUSTER;
  int e2;
  p.tau_pow2 = tau > 0.f && frexpf(tau, &e2) == 0.5f;
  p.tau = tau;
  p.inv_tau = p.tau_pow2 ? 1.f / tau : 0.f;
  const cudaStream_t s = (cudaStream_t)stream;
  // The map is encoded on the host at each launch and passed by value, so
  // a CUDA graph that captures this launch keeps it, with the table's
  // address of that moment. Replays are right because a plan's tables
  // never move once built.
  CUtensorMap map = {};
  const bool tma = n > 0 && ((long long)n * sizeof(Tab)) % 16 == 0 &&
                   (uintptr_t)table % 16 == 0;
  if (tma) {
    EncodeTiled encode = encoder();
    if (!encode) return (int)cudaErrorInvalidValue;
    const cuuint64_t gdim[2] = {(cuuint64_t)n, (cuuint64_t)p.chunks * 256};
    const cuuint64_t gstride[1] = {(cuuint64_t)n * sizeof(Tab)};
    const cuuint32_t box[2] = {BN, 256};
    const cuuint32_t estride[2] = {1, 1};
    if (encode(&map, dtype, 2, (void*)table, gdim, gstride, box, estride,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    return launch_t<true, Tab, Acc>(map, p, s);
  }
  return launch_t<false, Tab, Acc>(map, p, s);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: (T, R, K) f32; bias, vth: (K,) f32; table: (ceil(K/8), 256, N);
// spikes: (ceil(T/8), R, K) uint8; out: (T, R, N) f32; T <= 64.
extern "C" int fused_lif_lut_i16(const float* x, const float* bias,
                                 const float* vth, const int16_t* table,
                                 uint8_t* spikes, float* out, int t, int r,
                                 int k, int n, float tau, void* stream) {
  return launch<int16_t, int>(x, bias, vth, table, spikes, out, t, r, k, n,
                              tau, stream, CU_TENSOR_MAP_DATA_TYPE_UINT16);
}

extern "C" int fused_lif_lut_f32(const float* x, const float* bias,
                                 const float* vth, const float* table,
                                 uint8_t* spikes, float* out, int t, int r,
                                 int k, int n, float tau, void* stream) {
  return launch<float, float>(x, bias, vth, table, spikes, out, t, r, k, n,
                              tau, stream, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}
