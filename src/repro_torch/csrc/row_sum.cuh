// Deterministic row-segment sum shared by segment_spmm.cu and delta_agg.cu.
//
//   sum[r] = Σ_{k = row_ptr[r]}^{row_ptr[r+1]-1} msg[order ? order[k] : k, :]
//
// The order of the additions.  Every element of a row with records [lo, hi)
// is summed in one fixed order that depends on that row's records alone, not
// on the row count, the row's offset in the record array, the grid or the
// other rows of the launch:
//   * hi - lo <= kChunk: one chain in k order from 0.0f;
//   * longer rows: chunks [lo + j·kChunk, min(lo + (j+1)·kChunk, hi)), each a
//     chain in k order from 0.0f (p_j), then ((p_0 + p_1) + p_2) + … in chunk
//     order.
// `row_sum_chunked_plain` (kernels/segment_spmm.py) is the same order in
// PyTorch.  kAccumulate selects the epilogue: store the sum (segment_spmm) or
// add it once into the row already in `out` (delta_agg, in place), in which
// case rows without records are not touched at all.  No float atomics.
//
// The work.  Pass 1 (row_sum_kernel) has two kinds of warps.  A row warp owns
// one row of at most kChunk records and writes its result.  A chunk warp owns
// one chunk of a longer row and writes the chunk's sum into a scratch slot; a
// hub row's chunks thus spread over the card.  The chunk warps come first in
// the grid, so the long work starts first.  Without a scan on the host, chunk
// warps are laid out over windows of kChunk records from row_ptr[0]: a window
// holds at most one chunk j >= 1 of a long row that began before it (that row
// holds the window's first record) and at most one first chunk of a long row
// that begins in it (that row holds the window's last record), so window w
// has two warps, each finding its row by a search of row_ptr, and the chunk
// that starts in window w owns slot 2·w + [j == 0].  Pass 2 (row_sum_combine)
// has one warp a window: the window's first-chunk warp left the long row
// that begins there (or -1) in hub_row[w], and the combine warp adds that
// row's slots in chunk order and writes the result.  With at most kChunk
// records no row is long: pass 1 has no chunk warps and pass 2 is not
// launched.
//
// Each warp walks its records once for all columns (up to 32·kMaxCols): lane
// l keeps the columns l, l + 32, … in registers, the warp loads 32 `order`
// entries at a time and shares them by shuffle, and kUnroll records' loads
// are in flight before their adds, which stay in k order.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "error.cuh"

namespace repro_torch {

constexpr int kChunk = 512;  // records a chain sums at most (the TPU kernel's block, BE)
constexpr int kWarpSize = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxCols = 8;   // accumulators a lane: D <= 256 in one walk of the records
constexpr int kUnroll = 4;    // records whose loads are in flight together
constexpr int kSlotBatch = 8; // chunk sums whose loads are in flight together in pass 2
constexpr unsigned kFullMask = 0xffffffffu;

// Windows of pass 1 for `num_records` records (a bound on row_ptr[R] - row_ptr[0]);
// the scratch holds 2·windows slots of d floats, then `windows` long longs.
inline long long row_sum_windows(long long num_records) {
  return num_records > kChunk ? (num_records + kChunk - 1) / kChunk : 0;
}

// v[c] = row[col0 + lane + 32·c], or 0 past the row's d columns.
template <int kCols>
__device__ __forceinline__ void load_cols(const float* __restrict__ row, long long d,
                                          long long col0, int lane, float (&v)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const long long col = col0 + lane + c * kWarpSize;
    v[c] = col < d ? __ldg(row + col) : 0.0f;
  }
}

// The epilogue: row[col] = acc (or row[col] = old + acc with kAccumulate).
template <bool kAccumulate, int kCols>
__device__ __forceinline__ void store_cols(float* __restrict__ row, long long d, long long col0,
                                           int lane, const float (&old)[kCols],
                                           const float (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const long long col = col0 + lane + c * kWarpSize;
    if (col < d) row[col] = kAccumulate ? old[c] + acc[c] : acc[c];
  }
}

// One chain: acc = 0.0f + msg[e_a] + msg[e_{a+1}] + … over the records k in
// [a, b), in k order, for the lane's columns from col0.
template <int kCols, typename I>
__device__ __forceinline__ void chain_sum(const float* __restrict__ msg,
                                          const I* __restrict__ order, long long a, long long b,
                                          long long d, long long col0, int lane,
                                          float (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  for (long long k0 = a; k0 < b; k0 += kWarpSize) {
    const int n = static_cast<int>(b - k0 < kWarpSize ? b - k0 : kWarpSize);
    long long mine = 0;
    if (lane < n) mine = order != nullptr ? static_cast<long long>(order[k0 + lane]) : k0 + lane;
    for (int t = 0; t < n; t += kUnroll) {  // kUnroll records' loads in flight, then their adds
      float v[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long e = __shfl_sync(kFullMask, mine, (t + u) % kWarpSize);
        if (t + u < n) load_cols<kCols>(msg + e * d, d, col0, lane, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t + u < n)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] += v[u][c];
    }
  }
}

// The row that holds record p: the largest r < num_rows with row_ptr[r] <= p,
// given row_ptr[0] <= p < row_ptr[num_rows].  The warp probes 31 points a
// step (4 steps for a million rows); every lane returns the same row.
template <typename I>
__device__ __forceinline__ long long row_of_record(const I* __restrict__ row_ptr,
                                                   long long num_rows, long long p, int lane) {
  long long a = 0, n = num_rows;  // the row is in [a, a + n)
  while (n > 1) {
    const long long step = (n + kWarpSize - 1) / kWarpSize;
    const long long q = a + (lane + 1) * step;
    const bool le = q < a + n && static_cast<long long>(row_ptr[q]) <= p;
    const long long parts = __popc(__ballot_sync(kFullMask, le));
    a += parts * step;
    n = step < n - parts * step ? step : n - parts * step;
  }
  return a;
}

template <typename I, bool kAccumulate, int kCols>
__global__ void __launch_bounds__(kWarpSize * kWarpsPerBlock)
row_sum_kernel(const float* __restrict__ msg, const I* __restrict__ row_ptr,
               const I* __restrict__ order, float* __restrict__ out, float* __restrict__ slots,
               long long* __restrict__ hub_row, long long num_rows, long long d,
               long long windows, long long chunk_blocks) {
  const int lane = threadIdx.x;
  float acc[kCols], old[kCols];
  if (blockIdx.x < chunk_blocks) {  // a chunk warp: item = 2·window + [first chunk]
    const long long item = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
    if (item >= 2 * windows) return;
    const long long w = item >> 1;
    const bool first = item & 1;
    const long long base = static_cast<long long>(row_ptr[0]);
    const long long start = base + w * kChunk;  // the window's first record
    const long long p = first ? start + kChunk - 1 : start;
    long long row = -1, s = 0, hi = 0;
    if (p < static_cast<long long>(row_ptr[num_rows])) {
      row = row_of_record(row_ptr, num_rows, p, lane);
      const long long lo = static_cast<long long>(row_ptr[row]);
      hi = static_cast<long long>(row_ptr[row + 1]);
      if (hi - lo <= kChunk || (lo >= start) != first) {
        row = -1;  // a short row, or not the kind of chunk this warp owns
      } else {
        s = first ? lo : lo + (start - lo + kChunk - 1) / kChunk * kChunk;
        if (s >= hi) row = -1;  // the row ends before its next chunk would start
      }
    }
    if (first && lane == 0) hub_row[w] = row;
    if (row < 0) return;
    const long long e = s + kChunk < hi ? s + kChunk : hi;
    for (long long col0 = 0; col0 < d; col0 += kCols * kWarpSize) {
      chain_sum<kCols>(msg, order, s, e, d, col0, lane, acc);
      store_cols<false, kCols>(slots + item * d, d, col0, lane, old, acc);
    }
    return;
  }
  // a row warp
  const long long row =
      static_cast<long long>(blockIdx.x - chunk_blocks) * kWarpsPerBlock + threadIdx.y;
  if (row >= num_rows) return;
  const long long lo = static_cast<long long>(row_ptr[row]);
  const long long hi = static_cast<long long>(row_ptr[row + 1]);
  if (hi - lo > kChunk) return;           // summed by chunk warps, written by pass 2
  if (kAccumulate && lo >= hi) return;    // untouched: the O(affected) property
  float* o = out + row * d;
  for (long long col0 = 0; col0 < d; col0 += kCols * kWarpSize) {
    if (kAccumulate) load_cols<kCols>(o, d, col0, lane, old);  // in flight during the walk
    chain_sum<kCols>(msg, order, lo, hi, d, col0, lane, acc);
    store_cols<kAccumulate, kCols>(o, d, col0, lane, old, acc);
  }
}

template <typename I, bool kAccumulate, int kCols>
__global__ void __launch_bounds__(kWarpSize * kWarpsPerBlock)
row_sum_combine(const float* __restrict__ slots, const long long* __restrict__ hub_row,
                const I* __restrict__ row_ptr, float* __restrict__ out, long long d,
                long long windows) {
  const int lane = threadIdx.x;
  const long long w = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
  if (w >= windows) return;
  const long long row = hub_row[w];
  if (row < 0) return;
  const long long base = static_cast<long long>(row_ptr[0]);
  const long long lo = static_cast<long long>(row_ptr[row]);
  const long long hi = static_cast<long long>(row_ptr[row + 1]);
  float* o = out + row * d;
  float acc[kCols], old[kCols];
  for (long long col0 = 0; col0 < d; col0 += kCols * kWarpSize) {
    if (kAccumulate) load_cols<kCols>(o, d, col0, lane, old);
    load_cols<kCols>(slots + (2 * w + 1) * d, d, col0, lane, acc);  // p_0: window w's first chunk
    for (long long s = lo + kChunk; s < hi; s += kSlotBatch * kChunk) {  // p_j, j >= 1
      float v[kSlotBatch][kCols];
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u)
        if (s + u * kChunk < hi)
          load_cols<kCols>(slots + 2 * ((s + u * kChunk - base) / kChunk) * d, d, col0, lane, v[u]);
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u)
        if (s + u * kChunk < hi)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] += v[u][c];
    }
    store_cols<kAccumulate, kCols>(o, d, col0, lane, old, acc);
  }
}

template <typename I, bool kAccumulate, int kCols>
cudaError_t launch_cols(const float* msg, const I* row_ptr, const I* order, float* out,
                        long long num_rows, long long d, long long windows, float* slots,
                        long long* hub_row, cudaStream_t stream) {
  const dim3 block(kWarpSize, kWarpsPerBlock);
  const long long chunk_blocks = (2 * windows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long row_blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_sum_kernel<I, kAccumulate, kCols>
      <<<static_cast<unsigned>(chunk_blocks + row_blocks), block, 0, stream>>>(
          msg, row_ptr, order, out, slots, hub_row, num_rows, d, windows, chunk_blocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || windows == 0) return err;
  row_sum_combine<I, kAccumulate, kCols>
      <<<static_cast<unsigned>((windows + kWarpsPerBlock - 1) / kWarpsPerBlock), block, 0,
         stream>>>(slots, hub_row, row_ptr, out, d, windows);
  return cudaGetLastError();
}

// `num_records` bounds row_ptr[R] - row_ptr[0] (the length of `order`, or of
// `msg` without one); `scratch` holds row_sum_windows(num_records) windows'
// slots and hub rows, and may be null when that is 0.
template <typename I, bool kAccumulate>
int launch_row_sum(const void* msg, const void* row_ptr, const void* order, void* out,
                   long long num_rows, long long d, long long num_records, void* scratch,
                   void* stream) {
  if (num_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const long long windows = row_sum_windows(num_records);
  if (windows > 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto* m = static_cast<const float*>(msg);
  const auto* rp = static_cast<const I*>(row_ptr);
  const auto* ord = static_cast<const I*>(order);
  auto* o = static_cast<float*>(out);
  auto* slots = static_cast<float*>(scratch);
  auto* hub_row = windows > 0 ? reinterpret_cast<long long*>(slots + 2 * windows * d) : nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long cols = (d + kWarpSize - 1) / kWarpSize;
  cudaError_t err;
  switch (cols < kMaxCols ? cols : kMaxCols) {
    case 1: err = launch_cols<I, kAccumulate, 1>(m, rp, ord, o, num_rows, d, windows, slots, hub_row, s); break;
    case 2: err = launch_cols<I, kAccumulate, 2>(m, rp, ord, o, num_rows, d, windows, slots, hub_row, s); break;
    case 3: err = launch_cols<I, kAccumulate, 3>(m, rp, ord, o, num_rows, d, windows, slots, hub_row, s); break;
    case 4: err = launch_cols<I, kAccumulate, 4>(m, rp, ord, o, num_rows, d, windows, slots, hub_row, s); break;
    case 5: err = launch_cols<I, kAccumulate, 5>(m, rp, ord, o, num_rows, d, windows, slots, hub_row, s); break;
    case 6: err = launch_cols<I, kAccumulate, 6>(m, rp, ord, o, num_rows, d, windows, slots, hub_row, s); break;
    case 7: err = launch_cols<I, kAccumulate, 7>(m, rp, ord, o, num_rows, d, windows, slots, hub_row, s); break;
    default: err = launch_cols<I, kAccumulate, kMaxCols>(m, rp, ord, o, num_rows, d, windows, slots, hub_row, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace repro_torch
