// edge_softmax_normalize — phase 2 of the decoupled GAT edge softmax.
//
//   out[e, h] = scores[e, h] / sums[dst[e], h]   where dst[e] ≥ 0 and that sum > 1e-10,
//             = 0                                otherwise.
//
// scores and out [E, H] fp32, dst [E] int32 or int64 (−1 = padding), sums [R, H] fp32
// (phase 1, the destination segment sum of the same scores), all contiguous.
//
// Replaces: the Pallas TPU kernel `edge_softmax_normalize`
// (src/repro/kernels/edge_softmax.py, fn `edge_softmax_normalize`, body `_kernel`),
// which gathers each edge's destination sum as a transposed one-hot MXU matmul over
// block-CSR tiles so that the irregular gather becomes systolic work.  On Hopper
// the gather is a plain indexed load: no tiles, no one-hot, and the edges keep the
// caller's order, so nothing has to be permuted back.  The port has no caller on a
// main path; `repro_torch.kernels.ops.edge_softmax` composes it with `segment_spmm`.
//
// What bounds it on an H100: memory.  One division per element against E·H·4 bytes
// of scores in, E·H·4 out, E index bytes and R·H·4 bytes of sums: at the smoke
// graph's 10M edges, H = 2 and int64 ids that is 0.248 GB, 0.074 ms at 3.35 TB/s.
//
// What the design does about it: one thread per edge, four edges per thread with
// all their loads issued before any use (memory-level parallelism), and
// consecutive threads on consecutive edges.  H is a template parameter for 1, 2,
// 4 and 8, so an edge's scores, sums and outputs move as one float, float2 or
// one or two float4 (where the pointers are aligned for it); any other H, or
// unaligned pointers, take an inner loop over H in the same kernel.  dst is read
// once per edge, index arithmetic is 32-bit unless E·H needs 64, the sums are
// read through the read-only path (a destination's sums are reused from cache by
// its neighbouring dst-sorted edges) and scores and out stream past the cache.
// Each element has one writer and the division is IEEE `scores / denom` (no
// fast-math reciprocal), so the result equals the plain version bit for bit.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEPT = 4;  // edges per thread
constexpr long long kChunk = static_cast<long long>(kThreads) * kEPT;
constexpr long long kMaxBlocks = 1 << 20;  // the grid-stride loop covers the rest

// H consecutive floats at p: streaming loads and stores, read-only loads.
template <int H>
__device__ __forceinline__ void load_stream(const float* p, float* x) {
  if constexpr (H == 1) {
    x[0] = __ldcs(p);
  } else if constexpr (H == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    x[0] = t.x, x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < H / 4; ++i) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = t.x, x[4 * i + 1] = t.y, x[4 * i + 2] = t.z, x[4 * i + 3] = t.w;
    }
  }
}

template <int H>
__device__ __forceinline__ void load_ro(const float* p, float* x) {
  if constexpr (H == 1) {
    x[0] = __ldg(p);
  } else if constexpr (H == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x, x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < H / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = t.x, x[4 * i + 1] = t.y, x[4 * i + 2] = t.z, x[4 * i + 3] = t.w;
    }
  }
}

template <int H>
__device__ __forceinline__ void store_stream(float* p, const float* x) {
  if constexpr (H == 1) {
    __stcs(p, x[0]);
  } else if constexpr (H == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
#pragma unroll
    for (int i = 0; i < H / 4; ++i)
      __stcs(reinterpret_cast<float4*>(p) + i,
             make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]));
  }
}

__device__ __forceinline__ long long load_index(const int32_t* p) {
  return __ldcs(reinterpret_cast<const int*>(p));
}
__device__ __forceinline__ long long load_index(const int64_t* p) {
  return __ldcs(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ float normalize(float s, float denom) {
  return denom > 1e-10f ? s / denom : 0.0f;
}

// H > 0: that many heads, vector accesses.  H = 0: h heads, scalar accesses.
// N is the type of edge and element indices (int when E·H fits).
template <typename I, typename N, int H>
__global__ void __launch_bounds__(kThreads)
edge_softmax_normalize_kernel(const float* __restrict__ scores, const I* __restrict__ dst,
                              const float* __restrict__ sums, float* __restrict__ out, N e,
                              N h) {
  const N stride = static_cast<N>(gridDim.x) * static_cast<N>(kChunk);
  for (N base = static_cast<N>(blockIdx.x) * static_cast<N>(kChunk); base < e;
       base = e - base > stride ? base + stride : e) {
    N edge[kEPT];
    long long d[kEPT];
#pragma unroll
    for (int k = 0; k < kEPT; ++k) {
      edge[k] = base + k * kThreads + static_cast<N>(threadIdx.x);
      d[k] = edge[k] < e ? load_index(dst + edge[k]) : -1;
    }
    if constexpr (H > 0) {
      float sc[kEPT][H], den[kEPT][H];
#pragma unroll
      for (int k = 0; k < kEPT; ++k)
        if (edge[k] < e) load_stream<H>(scores + edge[k] * H, sc[k]);
#pragma unroll
      for (int k = 0; k < kEPT; ++k) {
        if (d[k] >= 0) {
          load_ro<H>(sums + d[k] * H, den[k]);
        } else {
#pragma unroll
          for (int j = 0; j < H; ++j) den[k][j] = 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < kEPT; ++k) {
        if (edge[k] >= e) continue;
        float y[H];
#pragma unroll
        for (int j = 0; j < H; ++j) y[j] = normalize(sc[k][j], den[k][j]);
        store_stream<H>(out + edge[k] * H, y);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kEPT; ++k) {
        if (edge[k] >= e) continue;
        const N row = edge[k] * h;
        for (N j = 0; j < h; ++j) {
          const float denom = d[k] >= 0 ? __ldg(sums + d[k] * h + j) : 0.0f;
          __stcs(out + row + j, normalize(__ldcs(scores + row + j), denom));
        }
      }
    }
  }
}

template <typename I, typename N, int H>
void run(const void* scores, const void* dst, const void* sums, void* out, long long e,
         long long h, cudaStream_t stream) {
  const long long blocks = std::min((e + kChunk - 1) / kChunk, kMaxBlocks);
  edge_softmax_normalize_kernel<I, N, H><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(scores), static_cast<const I*>(dst),
      static_cast<const float*>(sums), static_cast<float*>(out), static_cast<N>(e),
      static_cast<N>(h));
}

template <typename I, typename N>
void run_h(const void* scores, const void* dst, const void* sums, void* out, long long e,
           long long h, cudaStream_t stream) {
  // a vector access of H floats needs every row start aligned to min(H, 4) floats
  const uintptr_t any = reinterpret_cast<uintptr_t>(scores) | reinterpret_cast<uintptr_t>(sums) |
                        reinterpret_cast<uintptr_t>(out);
  const long long vec = std::min(h, 4LL) * 4;
  if ((h == 1 || h == 2 || h == 4 || h == 8) && any % vec == 0) {
    switch (h) {
      case 1: return run<I, N, 1>(scores, dst, sums, out, e, h, stream);
      case 2: return run<I, N, 2>(scores, dst, sums, out, e, h, stream);
      case 4: return run<I, N, 4>(scores, dst, sums, out, e, h, stream);
      default: return run<I, N, 8>(scores, dst, sums, out, e, h, stream);
    }
  }
  run<I, N, 0>(scores, dst, sums, out, e, h, stream);
}

template <typename I>
int launch(const void* scores, const void* dst, const void* sums, void* out, long long e,
           long long h, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e > 0 && h > 0) {
    if ((e + kChunk) * h < (1LL << 31))
      run_h<I, int>(scores, dst, sums, out, e, h, st);
    else
      run_h<I, long long>(scores, dst, sums, out, e, h, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int edge_softmax_normalize_i32(const void* scores, const void* dst, const void* sums,
                                          void* out, long long e, long long h, void* stream) {
  return launch<int32_t>(scores, dst, sums, out, e, h, stream);
}

extern "C" int edge_softmax_normalize_i64(const void* scores, const void* dst, const void* sums,
                                          void* out, long long e, long long h, void* stream) {
  return launch<int64_t>(scores, dst, sums, out, e, h, stream);
}
