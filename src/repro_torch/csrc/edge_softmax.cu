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
// graph's 10M edges and H = 2 that is ≈ 0.21 GB, ≈ 0.06 ms at 3.35 TB/s.
//
// What the design does about it: one thread per output element, consecutive
// threads on consecutive elements, so scores and out move in full 128-byte lines;
// the H threads of one edge read its dst once between them through L1, and a
// destination's sums are reused from L2 by its neighbouring (dst-sorted) edges.
// Each element has one writer, so there are no atomics and the result is exactly
// the division the plain version does.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // the grid-stride loop covers the rest

template <typename I>
__global__ void __launch_bounds__(kThreads)
edge_softmax_normalize_kernel(const float* __restrict__ scores, const I* __restrict__ dst,
                              const float* __restrict__ sums, float* __restrict__ out,
                              long long e, long long h) {
  const long long n = e * h;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const long long edge = i / h;
    const long long d = static_cast<long long>(dst[edge]);
    const float denom = d >= 0 ? sums[d * h + (i - edge * h)] : 0.0f;
    out[i] = denom > 1e-10f ? scores[i] / denom : 0.0f;
  }
}

template <typename I>
int launch(const void* scores, const void* dst, const void* sums, void* out, long long e,
           long long h, void* stream) {
  const long long n = e * h;
  if (n > 0) {
    const long long blocks = std::min((n + kThreads - 1) / kThreads, kMaxBlocks);
    edge_softmax_normalize_kernel<I>
        <<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(scores), static_cast<const I*>(dst),
            static_cast<const float*>(sums), static_cast<float*>(out), e, h);
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
