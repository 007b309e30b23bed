// row_linear — out = A @ W in fp32, each output element summed in one fixed order.
//
//   out[i, j] = Σ_{k=0}^{K-1} A[i, k] · W[k, j]     (fmaf, k ascending, one accumulator)
//
// Replaces: no TPU kernel.  The JAX package leaves its dense products (`a @ W` in every
// model's update, `h_u @ W` in gat's messages) to XLA.  A library product (cuBLAS) picks
// its kernel (tile shape, split-K) by the row count M, so a row of `A @ W` depends on how
// many other rows share the call: on an H100 rows 0..15 of `A @ W` differ between M = 16
// and M ≥ 32 by up to 1.4e-6.  The engine's invariants
// (a fused window ≡ the serial loop, device ≡ offload, sharded ≡ device, hybrid ≡
// offload) compare runs that put the same row into products of different M, so they
// need a product whose rows do not depend on M.  This kernel is that product: each
// element is one fmaf chain over k = 0 … K−1, whatever M, the tile or the block is.
//
// What bounds it on an H100: operations at the engine's shapes.  2·M·K·N flops against
// (M·K + K·N + M·N)·4 bytes: at K = N = 128 that is 64 flops a byte of A and out, above
// the card's 67 TFLOP/s ÷ 3.35 TB/s = 20 flops a byte for fp32 outside the tensor cores.
// (Tensor cores are out: TF32 keeps ~3 decimal digits, and a split-TF32 product sums
// partial products in an order the MMA unit picks.)
//
// What the design does about it: a 64 × 64 output tile per block of 256 threads, each
// thread 4 rows × 4 columns in registers; the block walks K in slices of 16 through
// shared memory (A stored k-major so a thread reads its 4 rows as one float4, W row-major
// so it reads its 4 columns as one float4): two shared loads feed 16 FMAs.  The k loop
// inside a slice and the slices are both ascending, and nothing in the tiling changes an
// element's chain: out-of-range A rows, W columns and the K tail load as 0, and
// fmaf(0, 0, acc) = acc, so the K tail is the same for every M.  No split-K, no atomics.
#include <cstdint>

#include "error.cuh"

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // k slice through shared memory
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int APAD = 4;  // keeps each k row of the A tile 16-byte aligned

__global__ void __launch_bounds__(THREADS)
row_linear_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  float* __restrict__ out, long long m, int k, int n) {
  __shared__ __align__(16) float as[BK][BM + APAD];  // as[kk][r] = A[row0 + r, k0 + kk]
  __shared__ __align__(16) float ws[BK][BN];         // ws[kk][c] = W[k0 + kk, col0 + c]
  const int t = threadIdx.x;
  const int tx = t % (BN / TN);  // column group
  const int ty = t / (BN / TN);  // row group
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A tile: 64 rows × 16 k, 4 loads a thread; a row's 16 k are 16 neighbouring threads
#pragma unroll
    for (int q = 0; q < (BM * BK) / THREADS; ++q) {
      const int idx = t + q * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const long long row = row0 + r;
      const int kc = k0 + kk;
      as[kk][r] = (row < m && kc < k) ? a[row * k + kc] : 0.0f;
    }
    // W tile: 16 k × 64 columns, 4 loads a thread, coalesced along the columns
#pragma unroll
    for (int q = 0; q < (BK * BN) / THREADS; ++q) {
      const int idx = t + q * THREADS;
      const int kk = idx / BN, c = idx % BN;
      const int kc = k0 + kk, col = col0 + c;
      ws[kk][c] = (kc < k && col < n) ? w[static_cast<long long>(kc) * n + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float wr[TN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = row0 + ty * TM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col < n) out[row * n + col] = acc[i][j];
    }
  }
}

}  // namespace

//: int row_linear_f32(const void* a, const void* w, void* out,
//:                    long long m, long long k, long long n, void* stream)
extern "C" int row_linear_f32(const void* a, const void* w, void* out, long long m,
                              long long k, long long n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const long long row_blocks = (m + BM - 1) / BM;
  const long long col_blocks = (n + BN - 1) / BN;
  if (row_blocks > 0x7fffffffLL || col_blocks > 65535 || k > 0x7fffffffLL || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_blocks), static_cast<unsigned>(col_blocks));
  row_linear_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<float*>(out), m,
      static_cast<int>(k), static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}
