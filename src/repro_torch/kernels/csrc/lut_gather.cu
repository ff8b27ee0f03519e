// Byte-LUT gather matmul: (P, M, C) uint8 index bytes x (C, 256, N) table
// -> (P, M, N) f32, out[p, m, :] = sum over c ascending of
// table[c, idx[p, m, c], :]. A second entry takes the packed spikes
// (G, M, K) uint8 and t live planes instead and forms the index bytes
// itself: bit i of idx[p, m, c] is bit p % 8 of x[p / 8, m, 8c + i].
//
// Replaces the TPU kernel src/repro/kernels/spike_matmul.py:lut_gather_matmul
// (wrapper src/repro/kernels/lut_matmul.py:lut_matmul_pallas), which
// selects table rows with one-hot MXU products against a VMEM-resident
// table.
//
// Bound on this card: every output element gathers C table entries,
// P*M*C*N reads in all (205 M at the SSA q/k/v layers of a batch of 8,
// 822 M at fc1 with an f32 table), while device memory moves the inputs,
// the table and the outputs once. Served from L2, one 2-byte read an entry
// (the first design of this file) is 411 MB of L2 traffic at q/k/v for a
// 16.8 MB table. So the table comes into shared memory a slab at a time,
// and every slab entry serves every plane of every row of a tile: the
// gathers run from shared memory, and the instructions a gather takes
// bound the kernel.
// Design:
// - A tile is ROWS rows with all their planes (up to TT = 4, 8 or 16; more
//   planes loop over blocks of TT) by BN = 32 f32 or 64 int16 columns; 512
//   threads hold its 64 accumulators a thread: ROWS = 1024 / TT for f32
//   tables, 512 / TT for int16 ones, whose lanes own two columns each.
// - One block an SM walks tiles (rows fastest, so blocks resident together
//   share column slabs and a table larger than L2 comes from device memory
//   about once). The chunks of a tile go in ascending order; each chunk's
//   (256, BN) slab (32 KB) arrives by TMA in a STAGES-deep mbarrier ring
//   that runs on across the block's tiles; columns past N read as zeros.
//   Table rows that are not 16-byte aligned cannot be addressed by TMA:
//   such slabs are copied with plain loads, in the same kernel.
// - A lane reads one 4-byte word of a slab row: an f32 entry, or two int16
//   columns accumulated into two int32 sums (low half sign-extended, high
//   half arithmetic-shifted). The 32 lanes of a warp read one slab row, so
//   the reads are free of bank conflicts; index words are broadcast reads.
//   Slabs sit 32 KB-aligned in the shared window, so a gather's address is
//   one shift and one AND-OR of the index byte into the lane's base.
// - Index bytes live in shared memory as words of 4 planes a (row, chunk),
//   32 chunks a group, in two buffers: while a group's chunks are gathered,
//   every chunk's step also loads a share of the next group's index bytes,
//   so their loads wait behind the gathers and not in front of them. The
//   packed entry forms them from the spikes: it reads the 8 packed bytes of
//   a (row, chunk, group), transposes the 8x8 bit matrix in registers, and
//   keeps the live planes' bytes. K that is not a multiple of 8 reads as
//   zero bits.
// Exactness: every (plane, row, column) folds its chunks in ascending
// order, the defined reduction tree of the reference; int16 tables
// accumulate in int32 and convert to f32 at the end; f32 tables start from
// -0.0, the exact identity of an IEEE add, so the first add gives chunk
// 0's entry bit for bit. There is no split over chunks.
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;
constexpr int CT = 32;            // chunks of index words a group
constexpr int SLAB_WORDS = 256 * 32;
constexpr int SLAB_BYTES = SLAB_WORDS * 4;   // 32 KB, also the alignment

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
// a 4-byte shared-memory read at a shared-window address; volatile keeps
// it behind the barrier wait that makes the slab valid
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// 8x8 bit transpose: byte i of x holds row i; byte j of the result holds
// column j (bit i of result byte j = bit j of x's byte i)
__device__ __forceinline__ uint64_t bit_transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

struct Params {
  const uint8_t* src;   // index bytes (P, M, C), or packed spikes (G, M, K)
  const void* table;    // (C, 256, N) int16 or f32
  float* out;           // (P, M, N)
  int p, m, c, n;
  int g, k;             // packed entry: plane groups and inputs
  int aligned8;         // packed entry: 8-byte loads of a (row, chunk)
  int row_tiles, tiles; // tiles: row_tiles x column tiles, rows fastest
};

// one group of index words: chunks [c0, c0 + cw) of plane block pb for the
// ROWS rows from row0; items: the loads that stage it
struct Group {
  int row0, pb, c0, cw, np, items;
};

// TT: planes a tile (4, 8 or 16); I16: int16 table, two columns a lane;
// PACKED: index bytes formed from packed spikes; TMA: slabs by TMA.
template <int TT, bool I16, bool PACKED, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
    lut_gather_kernel(const __grid_constant__ CUtensorMap map,
                      const Params p) {
  using Acc = typename std::conditional<I16, int, float>::type;
  constexpr int CPL = I16 ? 2 : 1;       // columns a lane
  constexpr int BN = 32 * CPL;
  constexpr int ROWS = 1024 / (TT * CPL);
  constexpr int RPW = ROWS / WARPS;      // rows a warp
  constexpr int TW = TT / 4;             // index words a (row, chunk)
  constexpr int TG = TT >= 8 ? TT / 8 : 1;   // plane groups a tile
  constexpr int BUF = CT * ROWS * TW;    // index words a group
  // shared memory: two index buffers, the barriers, then the slabs on the
  // next 32 KB boundary of the shared window
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint32_t* sidx = reinterpret_cast<uint32_t*>(smem_raw);   // [2][BUF]
  uint64_t* full = reinterpret_cast<uint64_t*>(sidx + 2 * BUF);
  const uint32_t slab0 = (smem_addr(full + STAGES) + SLAB_BYTES - 1) &
                         ~(uint32_t)(SLAB_BYTES - 1);
  uint32_t* slabs =
      reinterpret_cast<uint32_t*>(smem_raw + (slab0 - smem_addr(smem_raw)));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_pb = (p.p + TT - 1) / TT;
  const int gpb = (p.c + CT - 1) / CT;   // groups a plane block
  const int per_tile = n_pb * p.c;       // (plane block, chunk) steps
  const int my_tiles = (p.tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const long long total = (long long)my_tiles * per_tile;
  const int groups = my_tiles * n_pb * gpb;
  auto tile_at = [&](int local_tile) {
    return (int)blockIdx.x + local_tile * (int)gridDim.x;
  };
  // the producer's cursor: the (local tile, step) of the next slab to load
  int prod_lt = 0, prod_local = 0;
  auto issue_next = [&](int s) {
    const int tile = tile_at(prod_lt);
    tma_load_2d(slabs + s * SLAB_WORDS, &map, &full[s],
                (tile / p.row_tiles) * BN, (prod_local % p.c) * 256);
    if (++prod_local == per_tile) {
      prod_local = 0;
      ++prod_lt;
    }
  };
  auto group_at = [&](int gs) {
    Group q;
    const int tile = tile_at(gs / (n_pb * gpb));
    q.row0 = (tile % p.row_tiles) * ROWS;
    q.pb = (gs / gpb) % n_pb;
    q.c0 = (gs % gpb) * CT;
    q.cw = min(CT, p.c - q.c0);
    q.np = min(TT, p.p - q.pb * TT);
    q.items = q.cw * ROWS * (PACKED ? 1 : TW);
    return q;
  };
  // one item of a group's index words: a (row, chunk) for the packed entry
  // (TG 8-byte loads), a (row, chunk, word) for index bytes (4 byte loads)
  auto load_item = [&](const Group& q, int e, uint64_t v[TG]) {
    if constexpr (PACKED) {
      const int cc = e % q.cw, row = q.row0 + e / q.cw;
      const int kk = 8 * (q.c0 + cc);
#pragma unroll
      for (int gi = 0; gi < TG; ++gi) {
        const int g = (TT >= 8 ? q.pb * TG : 0) + gi;
        v[gi] = 0;
        if (g < p.g && row < p.m) {
          const uint8_t* src = p.src + ((long long)g * p.m + row) * p.k + kk;
          if (p.aligned8) {
            const uint2 b = __ldg(reinterpret_cast<const uint2*>(src));
            v[gi] = (uint64_t)b.x | ((uint64_t)b.y << 32);
          } else {
            for (int i = 0; i < 8 && kk + i < p.k; ++i)
              v[gi] |= (uint64_t)__ldg(src + i) << (8 * i);
          }
        }
      }
    } else {
      const int cc = e % q.cw, r = (e / q.cw) % ROWS, w = e / (q.cw * ROWS);
      const int row = q.row0 + r;
      uint32_t word = 0;
      if (row < p.m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * w + j < q.np)
            word |= (uint32_t)__ldg(
                        p.src + ((long long)(q.pb * TT + 4 * w + j) * p.m +
                                 row) * p.c + q.c0 + cc)
                    << (8 * j);
      v[0] = word;
    }
  };
  auto store_item = [&](uint32_t* buf, const Group& q, int e,
                        const uint64_t v[TG]) {
    if constexpr (PACKED) {
      uint32_t* dst = buf + ((e % q.cw) * ROWS + e / q.cw) * TW;
#pragma unroll
      for (int gi = 0; gi < TG; ++gi) {
        const uint64_t planes = bit_transpose8(v[gi]);
        dst[2 * gi] = (uint32_t)planes;
        if (TT >= 8) dst[2 * gi + 1] = (uint32_t)(planes >> 32);
      }
    } else {
      const int cc = e % q.cw, r = (e / q.cw) % ROWS, w = e / (q.cw * ROWS);
      buf[(cc * ROWS + r) * TW + w] = (uint32_t)v[0];
    }
  };

  if (TMA && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES && s < total; ++s) {
      mbar_expect_tx(&full[s], SLAB_BYTES);
      issue_next(s);
    }
  }
  if (groups > 0) {   // the first group's index words, before any gather
    const Group q = group_at(0);
    for (int e = tid; e < q.items; e += THREADS) {
      uint64_t v[TG];
      load_item(q, e, v);
      store_item(sidx, q, e, v);
    }
  }
  __syncthreads();

  // every fold starts from the identity; a tile's last chunk writes its
  // sums out and resets them (a reset there, not a select every chunk)
  Acc acc[RPW][TT][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[i][t][j] = I16 ? Acc(0) : Acc(-0.f);
  long long it = 0;
  int lt = 0, pb = 0, c = 0, gs = 0;     // local tile, plane block, chunk
  Group q = {}, nq = {};
  int share = 0;
  const uint32_t* words = sidx;
  int col0 = 0;
  for (; it < total; ++it) {
    if (c % CT == 0) {   // a new group: its words and the next group's
      q = group_at(gs);
      words = sidx + (gs & 1) * BUF;
      col0 = (tile_at(lt) / p.row_tiles) * BN;
      if (gs + 1 < groups) {
        nq = group_at(gs + 1);
        share = (nq.items + q.cw - 1) / q.cw;
      }
    }

    // this step's share of the next group's index words: loaded now,
    // stored after the gathers
    int pre_e = -1, end = 0;
    uint64_t pre[TG];
    if (gs + 1 < groups) {
      const int j = c - q.c0;
      const int e = j * share + tid;
      end = min((j + 1) * share, nq.items);
      if (e < end) {
        load_item(nq, e, pre);
        pre_e = e;
      }
    }

    const int s = TMA ? (int)(it % STAGES) : 0;
    if (TMA) {
      mbar_wait(&full[s], (int)((it / STAGES) & 1));
    } else {
      const int n = p.n;
      for (int e = tid; e < SLAB_WORDS; e += THREADS) {
        const long long row = (long long)c * 256 + e / 32;
        const int col = col0 + CPL * (e % 32);
        if constexpr (I16) {
          const int16_t* tb = static_cast<const int16_t*>(p.table) + row * n;
          const uint32_t lo = col < n ? (uint16_t)tb[col] : 0u;
          const uint32_t hi = col + 1 < n ? (uint16_t)tb[col + 1] : 0u;
          slabs[e] = lo | (hi << 16);
        } else {
          const float* tb = static_cast<const float*>(p.table) + row * n;
          slabs[e] = __float_as_uint(col < n ? tb[col] : 0.f);
        }
      }
      __syncthreads();
    }
    // the lane's word of slab row 0; row b is 128 * b bytes on, and bits
    // 7..14 of the base are zero, so base | (b << 7) addresses it
    const uint32_t lane_base = slab0 + s * SLAB_BYTES + lane * 4;
    const uint32_t* wrow = words + ((c - q.c0) * ROWS + warp * RPW) * TW;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int w = 0; w < TW; ++w) {
        const uint32_t word = wrow[i * TW + w];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int t = 4 * w + b;
          if (t < q.np) {
            const uint32_t off =
                (b == 0 ? word << 7 : word >> (8 * b - 7)) & 0x7f80u;
            const uint32_t u = lds_u32(lane_base | off);
            if constexpr (I16) {
              acc[i][t][0] += (int)(int16_t)(u & 0xffffu);
              acc[i][t][1] += ((int)u) >> 16;
            } else {
              acc[i][t][0] = __fadd_rn(acc[i][t][0], __uint_as_float(u));
            }
          }
        }
      }
    }
    if (c == p.c - 1) {
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int row = q.row0 + warp * RPW + i;
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t >= q.np || row >= p.m) break;
          float* o = p.out + ((long long)(pb * TT + t) * p.m + row) * p.n;
          const int col = col0 + CPL * lane;
          if constexpr (I16) {
            const float a = (float)acc[i][t][0];
            const float b = (float)acc[i][t][1];
            if (col + 1 < p.n && (p.n & 1) == 0) {
              *reinterpret_cast<float2*>(o + col) = make_float2(a, b);
            } else {
              if (col < p.n) o[col] = a;
              if (col + 1 < p.n) o[col + 1] = b;
            }
          } else if (col < p.n) {
            o[col] = (float)acc[i][t][0];
          }
        }
#pragma unroll
        for (int t = 0; t < TT; ++t)
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            acc[i][t][j] = I16 ? Acc(0) : Acc(-0.f);
      }
    }
    if (pre_e >= 0) {
      uint32_t* nbuf = sidx + ((gs + 1) & 1) * BUF;
      store_item(nbuf, nq, pre_e, pre);
      // a share larger than the block (a short group before a long one)
      for (int e = pre_e + THREADS; e < end; e += THREADS) {
        uint64_t v[TG];
        load_item(nq, e, v);
        store_item(nbuf, nq, e, v);
      }
    }
    __syncthreads();   // every warp is done with this stage and its words
    if (TMA && tid == 0 && it + STAGES < total) {
      mbar_expect_tx(&full[s], SLAB_BYTES);
      issue_next(s);
    }
    if (++c == p.c || c % CT == 0) ++gs;
    if (c == p.c) {
      c = 0;
      if (++pb == n_pb) {
        pb = 0;
        ++lt;
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

// The slab's tensor map: (C * 256, N) table rows, a box of 256 rows of 32
// f32 or 64 int16 columns
template <bool I16>
bool slab_map(CUtensorMap* map, const Params& p) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const int elt = I16 ? 2 : 4;
  const cuuint64_t gdim[2] = {(cuuint64_t)p.n, (cuuint64_t)p.c * 256};
  const cuuint64_t gstride[1] = {(cuuint64_t)p.n * elt};
  const cuuint32_t box[2] = {(cuuint32_t)(I16 ? 64 : 32), 256};
  const cuuint32_t estride[2] = {1, 1};
  return encode(map,
                I16 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(p.table), gdim, gstride, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 1;
  }
  return n;
}

template <int TT, bool I16, bool PACKED, bool TMA>
int launch_one(Params p, cudaStream_t s) {
  constexpr int CPL = I16 ? 2 : 1;
  constexpr int ROWS = 1024 / (TT * CPL);
  // index buffers and barriers, up to 32 KB of alignment, the slabs
  const size_t smem = 2 * CT * ROWS * (TT / 4) * sizeof(uint32_t) +
                      STAGES * sizeof(uint64_t) + SLAB_BYTES +
                      (TMA ? STAGES : 1) * (size_t)SLAB_BYTES;
  auto kernel = lut_gather_kernel<TT, I16, PACKED, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long row_tiles = ((long long)p.m + ROWS - 1) / ROWS;
  const long long col_tiles = ((long long)p.n + 32 * CPL - 1) / (32 * CPL);
  if (row_tiles * col_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.row_tiles = (int)row_tiles;
  p.tiles = (int)(row_tiles * col_tiles);
  // one block an SM (the accumulators take its registers), each walking
  // tiles until none is left
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  // The map is encoded on the host at each launch and passed by value, so
  // a CUDA graph that captures this launch keeps it, with the table's
  // address of that moment. Replays are right because a plan's tables
  // never move once built.
  CUtensorMap map = {};
  if (TMA && !slab_map<I16>(&map, p)) return (int)cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, s>>>(map, p);
  return (int)cudaGetLastError();
}

template <bool I16, bool PACKED, bool TMA>
int launch_tt(const Params& p, cudaStream_t s) {
  if (p.p <= 4) return launch_one<4, I16, PACKED, TMA>(p, s);
  if (p.p <= 8) return launch_one<8, I16, PACKED, TMA>(p, s);
  return launch_one<16, I16, PACKED, TMA>(p, s);
}

template <bool I16, bool PACKED>
int launch(Params p, void* stream) {
  if (p.p == 0 || p.m == 0 || p.n == 0) return 0;
  if (p.p < 0 || p.m < 0 || p.n < 0 || p.c < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // TMA addresses rows 16 bytes apart from a 16-byte aligned base
  const bool tma = ((long long)p.n * (I16 ? 2 : 4)) % 16 == 0 &&
                   (uintptr_t)p.table % 16 == 0;
  return tma ? launch_tt<I16, PACKED, true>(p, s)
             : launch_tt<I16, PACKED, false>(p, s);
}

Params index_params(const uint8_t* idx, const void* table, float* out, int p,
                    int m, int c, int n) {
  Params q = {};
  q.src = idx;
  q.table = table;
  q.out = out;
  q.p = p;
  q.m = m;
  q.c = c;
  q.n = n;
  return q;
}

Params packed_params(const uint8_t* x, const void* table, float* out, int t,
                     int g, int m, int k, int n) {
  Params q = {};
  q.src = x;
  q.table = table;
  q.out = out;
  q.p = t;
  q.m = m;
  q.c = (k + 7) / 8;
  q.n = n;
  q.g = g;
  q.k = k;
  q.aligned8 = k % 8 == 0 && (uintptr_t)x % 8 == 0;
  return q;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// idx: (P, M, C) uint8; table: (C, 256, N); out: (P, M, N) f32.
extern "C" int lut_gather_i16(const uint8_t* idx, const int16_t* table,
                              float* out, int p, int m, int c, int n,
                              void* stream) {
  return launch<true, false>(index_params(idx, table, out, p, m, c, n),
                             stream);
}

extern "C" int lut_gather_f32(const uint8_t* idx, const float* table,
                              float* out, int p, int m, int c, int n,
                              void* stream) {
  return launch<false, false>(index_params(idx, table, out, p, m, c, n),
                              stream);
}

// x: (G, M, K) uint8 packed spikes, G = ceil(t / 8); table:
// (ceil(K/8), 256, N); out: (t, M, N) f32.
extern "C" int lut_gather_packed_i16(const uint8_t* x, const int16_t* table,
                                     float* out, int t, int g, int m, int k,
                                     int n, void* stream) {
  return launch<true, true>(packed_params(x, table, out, t, g, m, k, n),
                            stream);
}

extern "C" int lut_gather_packed_f32(const uint8_t* x, const float* table,
                                     float* out, int t, int g, int m, int k,
                                     int n, void* stream) {
  return launch<false, true>(packed_params(x, table, out, t, g, m, k, n),
                             stream);
}
