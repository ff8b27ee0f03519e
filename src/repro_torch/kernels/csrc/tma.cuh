// TMA tile loads with mbarrier completion, and the 4-d tensor maps over
// (Dh, rows, heads, batch) views, shared by csrc/flash_attention_tc.cu and
// csrc/flash_attention.cu.
#pragma once
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------
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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
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

// --- TMA ---------------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
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

// A 4-d map over (Dh, rows, heads, batch) with element strides (1, s_row,
// s_head, s_batch), boxes of box_cols columns (TMA zero-fills those past Dh)
// x box_rows rows. The three outer dimensions are given to TMA in ascending
// order of stride, as a packed layout has them (a box is one row-block of
// one head, so their order does not change the tile's layout in shared
// memory); dim_order[i] is the TMA dimension of row (0), head (1) and
// batch (2).
inline bool make_map(CUtensorMap* map, CUtensorMapDataType dtype,
                     int elem_bytes, CUtensorMapSwizzle swizzle,
                     const void* ptr, int dh, int box_cols, int rows,
                     int heads, int batch, long long s_row, long long s_head,
                     long long s_batch, int box_rows, int dim_order[3]) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const long long size[3] = {rows, heads, batch};
  const long long stride[3] = {s_row, s_head, s_batch};
  const uint32_t box[3] = {(uint32_t)box_rows, 1, 1};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int k = i + 1; k < 3; ++k)
      if (stride[order[k]] < stride[order[i]]) {
        const int tmp = order[i];
        order[i] = order[k];
        order[k] = tmp;
      }
  cuuint64_t gdim[4] = {(cuuint64_t)dh};
  cuuint64_t gstride[3];
  cuuint32_t gbox[4] = {(cuuint32_t)box_cols};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    gdim[i + 1] = (cuuint64_t)size[order[i]];
    gstride[i] = (cuuint64_t)stride[order[i]] * elem_bytes;
    gbox[i + 1] = box[order[i]];
    dim_order[order[i]] = i + 1;
  }
  return encode(map, dtype, 4, const_cast<void*>(ptr), gdim, gstride, gbox,
                estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
