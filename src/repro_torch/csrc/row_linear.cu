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
// Two kernels, one chain.  Both run the chain above, so both give the same bits for
// every element, and the wrapper may pick either for any shape (kernels/row_linear.py):
//
// row_linear_f32 — the general kernel, any K and N: a 64 × 64 output tile per block of
// 256 threads, each thread 4 rows × 4 columns in registers; the block walks K in slices
// of 16 through shared memory (A stored k-major so a thread reads its 4 rows as one
// float4, W row-major so it reads its 4 columns as one float4): two shared loads feed 16
// FMAs.  The k loop inside a slice and the slices are both ascending, and nothing in the
// tiling changes an element's chain: out-of-range A rows, W columns and the K tail load
// as 0, and fmaf(0, 0, acc) = acc, so the K tail is the same for every M.
//
// row_linear_f32_tiled — the engine's shapes, N = 128 and K a multiple of 16 up to 256:
// one persistent block of 256 threads on each SM.  The block copies all of W (K·128·4 ≤
// 128 KB) into shared memory once, then walks the row tiles blockIdx.x, blockIdx.x +
// gridDim.x, …: each a 128 × 128 output tile (BN = N, so every row of A is read from
// device memory once), each thread 8 rows × 8 columns in registers.  A streams through a
// ring of two slices of 128 rows × 64 k (16-byte cp.async.cg, rows past M zero-filled),
// one iteration per slice over the block's tiles, so the next slice's loads (across tile
// boundaries too) are in flight under each slice's FMAs and each tile's epilogue.  A
// stays row-major in shared memory, each row padded by 4 floats so the two rows a warp
// reads fall in different banks; W is read as two float4 a k, so for every 4 k a thread
// issues 8 + 8 shared loads (its 8 rows' 4 k as float4, W's 4 × 8 slice as float4) and
// 256 FMAs.  k ascends inside each group of 4, across groups and across slices; a tail
// slice of 16, 32 or 48 k ends the chain at K with no padding, as the general kernel's
// 16-slices do.  The epilogue writes the 64 accumulators as float4 and leaves rows past
// M unwritten.  No split-K, no atomics, no tensor cores.
//   Budget (sm_90a, -Xptxas -v): 167 registers, no spills; dynamic shared memory
//   K·512 + 69,632 bytes (135,168 at K = 128, 200,704 at K = 256), so one block an SM.
//   On an H100 it reaches about 58% of the operations bound at K = N = 128 (PERF.md,
//   from chip_smoke.py).  What holds it there is the rate at which the FMAs issue, not
//   memory or shared loads: trial versions without the shared loads, the A stream or
//   the stores, or with 16 warps an SM, came out little faster (PERF.md §7).
#include <cstdint>

#include "error.cuh"

namespace {

// ---- row_linear_f32: the general kernel ------------------------------------------------

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

// ---- row_linear_f32_tiled: N = 128, K ≡ 0 (mod 16), K ≤ 256 -------------------------

namespace tiled {

constexpr int BM = 128;       // output rows per tile
constexpr int BN = 128;       // output columns per tile = N
constexpr int BK = 64;        // k slice of A through the ring
constexpr int TM = 8;         // rows per thread: ty, ty + 16, …, ty + 112
constexpr int TN = 8;         // columns per thread: 4·tx … 4·tx + 3 and 64 + 4·tx … 64 + 4·tx + 3
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int STAGES = 2;     // A slices in the ring: one computed while the next lands
constexpr int AROW = BK + 4;  // floats a row of an A slice takes: 272 bytes, 16-byte aligned
constexpr int A_SLICE = BM * AROW;
constexpr int KMAX = 256;     // W (K·BN floats) and the ring fit in one SM's shared memory

constexpr size_t smem_bytes(int k) {
  return (static_cast<size_t>(k) * BN + STAGES * A_SLICE) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are filled with zeros, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One A slice: rows row0 … row0 + 127, k0 … k0 + kn − 1 (kn 64, or 16, 32 or 48 at the
// K tail), 16 threads a row, 16 bytes each; rows past M are zero-filled.
__device__ __forceinline__ void load_a_slice(float* as, const float* __restrict__ a,
                                             long long row0, long long m, int k, int k0,
                                             int kn, int t) {
#pragma unroll
  for (int q = 0; q < (BM * BK / 4) / THREADS; ++q) {
    const int idx = t + q * THREADS;
    const int r = idx / (BK / 4), c4 = idx % (BK / 4);
    if (c4 * 4 < kn) {
      const long long row = row0 + r;
      const bool valid = row < m;
      cp_async16(as + r * AROW + c4 * 4, valid ? a + row * k + k0 + c4 * 4 : a, valid);
    }
  }
}

// G groups of 4 k of one slice, k ascending: for each group a thread reads its 8 rows'
// 4 k (8 float4), then for each of the 4 k its 8 columns of W (2 float4) and runs 64 FMAs.
template <int G>
__device__ __forceinline__ void fma_slice(float (&acc)[TM][TN], const float* as,
                                          const float* wk, int tx, int ty) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * AROW + 4 * g);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wrow = wk + (4 * g + kk) * BN + 4 * tx;
      const float4 w0 = *reinterpret_cast<const float4*>(wrow);
      const float4 w1 = *reinterpret_cast<const float4*>(wrow + 64);
      const float wr[TN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, wr[j], acc[i][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
row_linear_tiled_kernel(const float* __restrict__ a, const float* __restrict__ w,
                        float* __restrict__ out, long long m, int k) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;               // ws[kk·BN + c] = W[kk, c], all of W
  float* ring = smem + k * BN;    // STAGES slices, ring[s·A_SLICE + r·AROW + kk]
  const int t = threadIdx.x;
  const int tx = t % (BN / TN);   // column group
  const int ty = t / (BN / TN);   // row group
  const long long tiles = (m + BM - 1) / BM;  // the launch makes gridDim.x ≤ tiles
  const long long my_tiles = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int slices = (k + BK - 1) / BK;
  const long long total = my_tiles * slices;  // ring iterations of this block
  const long long row_step = static_cast<long long>(gridDim.x) * BM;

  // W rides in the first commit group, with the first A slice
  for (int idx = t; idx < k * (BN / 4); idx += THREADS) cp_async16(ws + 4 * idx, w + 4 * idx, true);

  // producer cursor: the next slice to load (tile row0, slice index, ring stage)
  long long ld_row0 = static_cast<long long>(blockIdx.x) * BM;
  int ld_slice = 0, ld_stage = 0;
  long long issued = 0;
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (issued < total) {
      const int k0 = ld_slice * BK;
      load_a_slice(ring + ld_stage * A_SLICE, a, ld_row0, m, k, k0, min(BK, k - k0), t);
      ++issued;
      ld_stage = (ld_stage + 1) % STAGES;
      if (++ld_slice == slices) { ld_slice = 0; ld_row0 += row_step; }
    }
    cp_async_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  long long row0 = static_cast<long long>(blockIdx.x) * BM;
  int slice = 0, stage = 0;
#pragma unroll 1
  for (long long it = 0; it < total; ++it) {
    // slice `it` has landed (at most STAGES − 2 later groups pending), and every thread
    // is past slice it − 1, whose stage the next load reuses
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (issued < total) {
      const int k0 = ld_slice * BK;
      load_a_slice(ring + ld_stage * A_SLICE, a, ld_row0, m, k, k0, min(BK, k - k0), t);
      ++issued;
      ld_stage = (ld_stage + 1) % STAGES;
      if (++ld_slice == slices) { ld_slice = 0; ld_row0 += row_step; }
    }
    cp_async_commit();

    const int k0 = slice * BK;
    const float* as = ring + stage * A_SLICE;
    if (k - k0 >= BK) {
      fma_slice<BK / 4>(acc, as, ws + k0 * BN, tx, ty);
    } else {  // the K tail: 16, 32 or 48 k, in steps of 16, still ascending
#pragma unroll 1
      for (int c = 0; c < (k - k0) / 16; ++c)
        fma_slice<4>(acc, as + 16 * c, ws + (k0 + 16 * c) * BN, tx, ty);
    }
    stage = (stage + 1) % STAGES;

    if (++slice == slices) {  // the tile's chains are complete: write them, start anew
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long row = row0 + ty + 16 * i;
        if (row < m) {
          float* o = out + row * BN + 4 * tx;
          *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(o + 64) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
      }
      slice = 0;
      row0 += row_step;
    }
  }
  cp_async_wait<0>();
}

}  // namespace tiled

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

constexpr int MAX_DEVICES = 64;

//: int row_linear_f32_tiled(const void* a, const void* w, void* out,
//:                          long long m, long long k, long long n, void* stream)
extern "C" int row_linear_f32_tiled(const void* a, const void* w, void* out, long long m,
                                    long long k, long long n, void* stream) {
  namespace T = tiled;
  if (n != T::BN || k < 16 || k > T::KMAX || k % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  static int sm_count[MAX_DEVICES] = {};  // 0 until the device's first launch sets it up
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(T::row_linear_tiled_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::smem_bytes(T::KMAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[dev] = sms;
  }
  const long long tiles = (m + T::BM - 1) / T::BM;
  const unsigned grid = static_cast<unsigned>(tiles < sm_count[dev] ? tiles : sm_count[dev]);
  T::row_linear_tiled_kernel<<<grid, T::THREADS, T::smem_bytes(static_cast<int>(k)),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<float*>(out), m,
      static_cast<int>(k));
  return static_cast<int>(cudaGetLastError());
}
