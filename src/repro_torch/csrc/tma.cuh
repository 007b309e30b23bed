// Tensor Memory Accelerator (TMA) copies, warp specialisation and the wgmma
// descriptors of swizzled operands: what the bf16 kernels at dh 64, 128 and 160
// (flash_attention.cu, flash_attention_bwd.cu) are built from.
//
// A bf16 [outer, rows, dh] array (q, k, v, o or dO, row-major) is described by
// one 3-D tensor map (dh, rows, outer) whose box is 32 columns × R rows × 1:
// dh / 32 boxes cover a tile of R rows, box c holding columns [32c, 32c + 32) as
// R rows of 64 bytes with the 64-byte swizzle (chunk j of row r at chunk j ^
// ((r / 2) % 4), the pattern repeating every 8 rows = 512 bytes).  Rows past
// `rows` arrive as zeros: a ragged tile needs no masking of its operand, and a
// tile of one head never reads the next head's rows.  wgmma reads such a box
// in place, K-major or MN-major (tma::desc_k, tma::desc_mn); the box's base
// must be 1024-byte aligned.
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace tma {

constexpr int kBoxCols = 32;                  // columns of a box: one 64-byte swizzled row
constexpr int kBoxRowBytes = kBoxCols * 2;    // bf16
constexpr int kSwizzleAtom = 8 * kBoxRowBytes;  // 512 bytes: 8 rows of the pattern

// ------------------------------------------------------------------ host side
// Encode the map of a bf16 [outer, rows, dh] array at `base` with boxes of
// 32 columns × box_rows rows.  cuTensorMapEncodeTiled is a driver function:
// it is found through the runtime (cudaGetDriverEntryPoint), so that the
// library links the runtime alone.  Returns a cudaError_t as int.
inline int encode_rows(CUtensorMap* map, const void* base, long long outer, long long rows,
                       int dh, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(rows) * dh * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- device side
// The DH / 32 boxes of a tile of R rows, starting at row `row` of slice `outer`,
// into `dst` (box c at dst + c · R · 64), completed on `bar`.  One thread.
template <int DH, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, int row,
                                          int outer, uint64_t* bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
#pragma unroll
  for (int c = 0; c < DH / kBoxCols; ++c)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(hopper::smem_addr(dst + c * R * kBoxRowBytes)),
        "l"(m), "r"(c * kBoxCols), "r"(row), "r"(outer), "r"(hopper::smem_addr(bar))
        : "memory");
}

// One arrival on an mbarrier (no transfer bytes).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(hopper::smem_addr(bar))
               : "memory");
}

// Hand registers between the warpgroups of a warp-specialised block: the
// producer gives back down to N, the consumers take up to N.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The descriptor of a 64-byte-swizzled operand (layout type 2 in bits 62–63).
__device__ __forceinline__ uint64_t desc_sw64(const void* p, uint32_t lbo, uint32_t sbo) {
  return hopper::make_desc(p, lbo, sbo) | (2ull << 62);
}

// K-major (the box's columns along K): 64 rows of M or N rows at `tile` (a
// tile of boxes of R rows), k16 step i of the tile's columns.  Step i lies in box
// i / 2 at byte 32 · (i % 2) of each row; 8-row groups are 512 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int i) {
  return desc_sw64(tile + (i >> 1) * R * kBoxRowBytes + (i & 1) * 32, 16, kSwizzleAtom);
}

// MN-major (the box's columns along N, its rows along K): the B of a product
// over the tile's rows, k16 step i = rows [16i, 16i + 16).  Consecutive boxes
// (32 columns of N each) are R · 64 bytes apart (the leading byte offset),
// 8-row groups of K 512 (the stride byte offset).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int i) {
  return desc_sw64(tile + i * 2 * kSwizzleAtom, R * kBoxRowBytes, kSwizzleAtom);
}

// acc (+)= A · B over k16 step i: A the bf16 fragments of registers `a`, B the
// MN-major tile of boxes of R rows at `tile` with N = DH (dh).  At dh 64 as two
// n32 products, a box each: one m64n64k16 whose B spans two boxes of 64 rows (a
// leading byte offset of 4,096 B) summed wrong across loop tiles on an H100 (the
// backward's dQ far off at Sk 128 where one key tile alone was right; the n32
// halves, and n128 and n160 over the same boxes, were right).  The cause is not
// known, so no product spans two boxes at dh 64, in the forward (boxes of 128
// rows, where n64 was right in every test) as in the backward.  In the forward
// the two n32 products give n64's bits and run 5% faster (llama3.2-1b's prefill
// on an H100).
template <int R, int DH>
__device__ __forceinline__ void mma_mn(float (&acc)[DH / 2], const uint32_t* a,
                                       const unsigned char* tile, int i) {
  using hopper::Mma;
  using hopper::Op;
  using hopper::Src;
  if constexpr (DH == 64) {
    Mma<Op::kBf16, Src::kRST, 32>::run(acc, a, desc_mn<R>(tile, i), 1);
    Mma<Op::kBf16, Src::kRST, 32>::run(acc + 16, a, desc_mn<R>(tile + R * kBoxRowBytes, i), 1);
  } else {
    Mma<Op::kBf16, Src::kRST, DH>::run(acc, a, desc_mn<R>(tile, i), 1);
  }
}

// This thread's bf16 A fragments of a K-major operand of 64 rows (from `row0`
// of a tile of boxes of R rows), DH columns along K: k16 step i is f[4i … 4i +
// 3] = the column pairs (r0, c), (r0 + 8, c), (r0, c + 8), (r0 + 8, c + 8) with
// c = 16i + 2·(lane % 4) and r0 = 16·warp + lane / 4 (the m64k16 A fragment),
// read through the 64-byte swizzle.
template <int R, int DH>
__device__ __forceinline__ void load_a_frags(const unsigned char* tile, int row0,
                                             uint32_t (&f)[DH / 4]) {
  const int t = threadIdx.x & 127, r0 = row0 + (t >> 5) * 16 + ((t & 31) >> 2), tig = t & 3;
#pragma unroll
  for (int i = 0; i < DH / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 8 * (j & 1), c = 16 * i + 8 * (j >> 1) + 2 * tig;
      const int off = (c >> 5) * R * kBoxRowBytes + r * kBoxRowBytes +
                      ((((c & 31) >> 3) ^ ((r >> 1) & 3)) << 4) + (c & 7) * 2;
      f[4 * i + j] = *reinterpret_cast<const uint32_t*>(tile + off);
    }
}

// The first 1024-byte boundary at or after p (dynamic shared memory is only
// 16-byte aligned; a swizzled box wants the pattern's alignment).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = hopper::smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

}  // namespace tma
