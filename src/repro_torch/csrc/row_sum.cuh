// Deterministic row-segment sum shared by segment_spmm.cu and delta_agg.cu.
//
//   sum[r] = Σ_{k = row_ptr[r]}^{row_ptr[r+1]-1} msg[order ? order[k] : k, :]
//
// One warp owns one output row; its 32 lanes stride over the feature
// columns, and each lane walks the row's records in k order, accumulating in
// a register.  Every output element therefore has exactly one writer and one
// fixed summation order: no atomics, and the result is the same bits on
// every run.  kAccumulate selects the epilogue: store the sum (segment_spmm)
// or add it once into the row already in `out` (delta_agg, in place), in
// which case rows without records are not touched at all.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "error.cuh"

namespace repro_torch {

constexpr int kWarpSize = 32;
constexpr int kRowsPerBlock = 8;  // warps per block

template <typename I, bool kAccumulate>
__global__ void __launch_bounds__(kWarpSize * kRowsPerBlock)
row_sum_kernel(const float* __restrict__ msg, const I* __restrict__ row_ptr,
               const I* __restrict__ order, float* __restrict__ out,
               long long num_rows, long long d) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= num_rows) return;
  const long long lo = static_cast<long long>(row_ptr[row]);
  const long long hi = static_cast<long long>(row_ptr[row + 1]);
  if (kAccumulate && lo >= hi) return;  // untouched: the O(affected) property
  for (long long c = threadIdx.x; c < d; c += kWarpSize) {
    float acc = 0.0f;
    for (long long k = lo; k < hi; ++k) {
      const long long e = order != nullptr ? static_cast<long long>(order[k]) : k;
      acc += msg[e * d + c];
    }
    float* o = out + row * d + c;
    *o = kAccumulate ? *o + acc : acc;
  }
}

template <typename I, bool kAccumulate>
int launch_row_sum(const void* msg, const void* row_ptr, const void* order, void* out,
                   long long num_rows, long long d, void* stream) {
  if (num_rows > 0 && d > 0) {
    const dim3 block(kWarpSize, kRowsPerBlock);
    const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock));
    row_sum_kernel<I, kAccumulate><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(msg), static_cast<const I*>(row_ptr),
        static_cast<const I*>(order), static_cast<float*>(out), num_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
