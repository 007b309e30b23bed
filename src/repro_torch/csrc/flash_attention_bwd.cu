// flash_attention_bwd — the backward of flash_attention (flash_attention.cu): the
// gradients of q, k and v from q, k, v, the output o, the row log-sum-exp lse that
// the forward wrote, and the output's gradient dO.  The FlashAttention-2 backward:
//
//   P  = exp(S · scale − lse) over the visible keys, 0 elsewhere    (S = Q · Kᵀ)
//   dV = Pᵀ · dO      dP = dO · Vᵀ      D = rowsum(dO ∘ O)      dS = P ∘ (dP − D)
//   dQ = dS · K · scale                 dK = dSᵀ · Q · scale
//
// with dK and dV summed over the g = Hq / Hkv query heads of each KV head, and the
// forward's masks: key j < Sk, j ≤ i + q_offset (causal), j > i + q_offset − window
// (window > 0).  A row that sees no key has zero gradients (its lse is −inf and is
// never read: every key of such a row is masked).
//
// q, o, dO, dq [B, Hq, Sq, dh]; k, v, dk, dv [B, Hkv, Sk, dh]; lse and D [B, Hq, Sq]
// fp32; all contiguous and 16-byte aligned; fp32 or bf16 (gradients in the input
// type), fp32 arithmetic and accumulation; dh ∈ {16, 32, 64, 128}.
//
// Replaces: no TPU kernel.  The Pallas `flash_attention` (src/repro/kernels/
// flash_attention.py) has no VJP, and the JAX package's training differentiates
// its plain `flash_attention_ref` with jax.value_and_grad (src/repro/train/
// trainer.py).  In the port every attention call with more than one query row runs
// the forward kernel, so training on the card needs this backward: it is the
// backward of every layer of the LM's training step (nn/attention.py → the
// autograd Function in kernels/flash_attention.py).
//
// What bounds it on an H100: operations.  The five products (S, dP, dV, dK, dQ) do
// 2.5× the forward's: 10·dh operations per (query, visible key) pair, 1.72e11 at
// the llama3.2-1b training shape (B 4, Hq 32, Hkv 8, S 2048, dh 64, causal),
// against ≈ 0.34 GB of q, k, v, o, dO, lse read and dq, dk, dv written (0.10 ms at
// 3.35 TB/s).  In split TF32 on the tensor cores (the forward's route) that is
// 1.04 ms at 495 TFLOP/s; on the fp32 CUDA cores at 67 TFLOP/s, 2.57 ms.
//
// What the design does about it: this first version is the simple one, on the
// fp32 CUDA cores (tensor cores are later work).  Two kernels, so that every
// output element has one owner and no float atomics are needed (the same bits on
// every run):
//   * the dQ kernel, one block per (b, q head, 64-row query tile), computes D for
//     its rows from its dO and O tiles, writes it for the second kernel, and loops
//     over the key tiles its rows can see (causal and window band), accumulating
//     dQ in registers;
//   * the dK/dV kernel, launched after it on the same stream, one block per (b, KV
//     head, 64-key tile), loops over the g query heads of the group and the query
//     tiles that can see its keys, accumulating dK and dV in registers.
// D comes from the dQ kernel rather than a pre-pass: its block holds the rows' dO
// already, and the stream orders the two launches.  Each kernel recomputes S and
// dP (seven products in all against the minimum five), which is what removes the
// atomics.  Tiles are staged in shared memory as fp32 rows padded by 4 floats, so
// the 16-byte loads of eight neighbouring threads fall on distinct banks; 256
// threads as 16 × 16, each computing a 4 × 4 block of a [64, 64] score tile (rows
// ty + 16a, keys tx + 16b: 8 16-byte loads per 64 FMAs) or a 4 × dh/16 block of a
// [64, dh] gradient tile (rows 4tx…4tx+3: 2 16-byte loads per 16 FMAs at dh 64).
// The heaviest blocks under the causal mask go first (the dQ kernel's last query
// tiles, the dK/dV kernel's first key tiles).  P uses exp2f with lse · log2 e.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

#include "error.cuh"

namespace {

constexpr int kTile = 64;        // query rows or keys of a tile
constexpr int kThreads = 256;    // 16 × 16
constexpr int kLdS = kTile + 4;  // padded row of a [64, 64] score tile
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Cfg {
  static constexpr int kLd = DH + 4;    // padded row of a [64, DH] tile
  static constexpr int kDpt = DH / 16;  // columns a thread owns in a [64, DH] gradient tile
  static constexpr int kTileFloats = kTile * kLd;
  static constexpr int kScoreFloats = kTile * kLdS;
  static constexpr int kMinBlocks = DH <= 64 ? 2 : 1;  // two blocks an SM where they fit
};

__device__ __forceinline__ void put4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// Rows [0, 64) of a row-major [rows, DH] tile in device memory → fp32 rows of
// `dst` (stride DH + 4); rows ≥ nvalid become 0 and are not read.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int nvalid) {
  constexpr int kEpc = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte chunk
  constexpr int kCpr = DH / kEpc;                          // chunks per row
  for (int c = threadIdx.x; c < kTile * kCpr; c += kThreads) {
    const int r = c / kCpr, col = (c % kCpr) * kEpc;
    float* out = dst + r * Cfg<DH>::kLd + col;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid)
      x = __ldg(reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * DH + col));
    if constexpr (std::is_same<T, float>::value) {
      put4(out, __uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
           __uint_as_float(x.w));
    } else {  // eight bf16, low half first: a bf16 is the high half of its fp32
      put4(out, __uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
           __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
      put4(out + 4, __uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
           __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u));
    }
  }
}

// c[a][b] = Σ_d A[ty + 16a][d] · B[tx + 16b][d] over two [64, DH] tiles.
template <int DH>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, float c[4][4]) {
  constexpr int LD = Cfg<DH>::kLd;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) c[a][b] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = *reinterpret_cast<const float4*>(B + (tx + 16 * b) * LD + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        c[a][b] = fmaf(x[a].x, y[b].x, c[a][b]);
        c[a][b] = fmaf(x[a].y, y[b].y, c[a][b]);
        c[a][b] = fmaf(x[a].z, y[b].z, c[a][b]);
        c[a][b] = fmaf(x[a].w, y[b].w, c[a][b]);
      }
  }
}

// N consecutive floats of shared memory (N = DH / 16: 1, 2, 4 or 8).
template <int N>
__device__ __forceinline__ void load_row(const float* src, float* x) {
  if constexpr (N == 1) {
    x[0] = src[0];
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    x[0] = t.x, x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + i);
      x[i] = t.x, x[i + 1] = t.y, x[i + 2] = t.z, x[i + 3] = t.w;
    }
  }
}

// acc[c][e] += Σ_r W[r][4tx + c] · X[r][ty · DH/16 + e] over a [64, 64] weight tile
// (stride kLdS) and a [64, DH] tile: a [64, DH] gradient tile, reduced over r.
template <int DH>
__device__ __forceinline__ void acc_tile(const float* W, const float* X,
                                         float acc[4][Cfg<DH>::kDpt]) {
  constexpr int LD = Cfg<DH>::kLd, N = Cfg<DH>::kDpt;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    const float4 w = *reinterpret_cast<const float4*>(W + r * kLdS + 4 * tx);
    float x[N];
    load_row<N>(X + r * LD + ty * N, x);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      acc[0][e] = fmaf(w.x, x[e], acc[0][e]);
      acc[1][e] = fmaf(w.y, x[e], acc[1][e]);
      acc[2][e] = fmaf(w.z, x[e], acc[2][e]);
      acc[3][e] = fmaf(w.w, x[e], acc[3][e]);
    }
  }
}

__device__ __forceinline__ bool visible(long long qpos, long long kpos, long long sk,
                                        int causal, long long window) {
  return kpos < sk && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows 4tx + c < nrows, columns ty · DH/16 + e of a [64, DH] gradient tile at `out`.
template <typename T, int DH>
__device__ __forceinline__ void write_tile(T* out, const float acc[4][Cfg<DH>::kDpt],
                                           float mul, int nrows) {
  constexpr int N = Cfg<DH>::kDpt;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int r = 4 * tx + c;
    if (r >= nrows) continue;
#pragma unroll
    for (int e = 0; e < N; ++e) store(out + static_cast<long long>(r) * DH + ty * N + e,
                                      acc[c][e] * mul);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, Cfg<DH>::kMinBlocks)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ o, const float* __restrict__ lse,
              const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ delta,
              int hq, int g, long long sq, long long sk, float scale, int causal,
              long long window, long long q_offset) {
  using C = Cfg<DH>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // Q tile
  float* dos = qs + C::kTileFloats;     // dO tile
  float* ks = dos + C::kTileFloats;     // K tile (first O's tile, for D)
  float* vs = ks + C::kTileFloats;      // V tile
  float* dst = vs + C::kTileFloats;     // dSᵀ [key][row], stride kLdS
  float* lse2 = dst + C::kScoreFloats;  // the rows' lse · log2 e
  float* drow = lse2 + kTile;           // the rows' D

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long bh = blockIdx.x, b = bh / hq;
  const long long kvh = b * (hq / g) + (bh % hq) / g;
  // the last query tiles see the most keys under the causal mask: they go first
  const long long q0 = (static_cast<long long>(gridDim.y) - 1 - blockIdx.y) * kTile;
  const int nq = static_cast<int>(min(static_cast<long long>(kTile), sq - q0));
  const long long row0 = bh * sq + q0;  // the tile's first row of [B · Hq · Sq]

  load_tile<T, DH>(q + row0 * DH, qs, nq);
  load_tile<T, DH>(dout + row0 * DH, dos, nq);
  load_tile<T, DH>(o + row0 * DH, ks, nq);
  if (tid < kTile) lse2[tid] = tid < nq ? lse[row0 + tid] * kLog2e : 0.0f;
  __syncthreads();
  {  // D = rowsum(dO ∘ O): four threads a row, a quarter of the columns each
    const int r = tid >> 2, part = tid & 3;
    float sum = 0.0f;
#pragma unroll
    for (int d = part * (DH / 4); d < (part + 1) * (DH / 4); ++d)
      sum = fmaf(dos[r * C::kLd + d], ks[r * C::kLd + d], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      drow[r] = sum;
      if (r < nq) delta[row0 + r] = sum;
    }
  }
  __syncthreads();  // D is in shared memory, O's tile may be overwritten

  // the key tiles that some row of the block may see
  long long k_lo = 0, k_hi = sk;
  if (causal) k_hi = min(k_hi, q0 + nq + q_offset);
  if (window > 0) k_lo = max(k_lo, q0 + q_offset - window + 1);
  const float scale_log2 = scale * kLog2e;
  float acc[4][C::kDpt];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < C::kDpt; ++e) acc[c][e] = 0.0f;

  for (long long k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    const int nk = static_cast<int>(min(static_cast<long long>(kTile), sk - k0));
    load_tile<T, DH>(k + (kvh * sk + k0) * DH, ks, nk);
    load_tile<T, DH>(v + (kvh * sk + k0) * DH, vs, nk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DH>(qs, ks, s);
    dot_tile<DH>(dos, vs, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      const long long qpos = q0 + i + q_offset;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = tx + 16 * bb;
        const bool ok = i < nq && visible(qpos, k0 + j, sk, causal, window);
        const float p = ok ? exp2f(s[a][bb] * scale_log2 - lse2[i]) : 0.0f;
        dst[j * kLdS + i] = p * (dp[a][bb] - drow[i]);
      }
    }
    __syncthreads();
    acc_tile<DH>(dst, ks, acc);  // dQ += dS · K
    __syncthreads();             // K, V and dSᵀ are free for the next tile
  }
  write_tile<T, DH>(dq + row0 * DH, acc, scale, nq);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, Cfg<DH>::kMinBlocks)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ lse, const T* __restrict__ dout,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                int hq, int g, long long sq, long long sk, float scale, int causal,
                long long window, long long q_offset) {
  using C = Cfg<DH>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // K tile
  float* vs = ks + C::kTileFloats;       // V tile
  float* qs = vs + C::kTileFloats;       // Q tile
  float* dos = qs + C::kTileFloats;      // dO tile
  float* ps = dos + C::kTileFloats;      // P [row][key], stride kLdS
  float* dss = ps + C::kScoreFloats;     // dS [row][key]
  float* lse2 = dss + C::kScoreFloats;   // the rows' lse · log2 e
  float* drow = lse2 + kTile;            // the rows' D

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long bkv = blockIdx.x;  // b · Hkv + KV head
  const long long hkv = hq / g, b = bkv / hkv;
  const long long h0 = b * hq + (bkv % hkv) * g;  // b · Hq + the group's first q head
  // the first key tiles are seen by the most rows under the causal mask: they go first
  const long long k0 = static_cast<long long>(blockIdx.y) * kTile;
  const int nk = static_cast<int>(min(static_cast<long long>(kTile), sk - k0));
  load_tile<T, DH>(k + (bkv * sk + k0) * DH, ks, nk);
  load_tile<T, DH>(v + (bkv * sk + k0) * DH, vs, nk);

  // the query rows that see some key of the tile
  long long i_lo = 0, i_hi = sq;
  if (causal) i_lo = max(i_lo, k0 - q_offset);
  if (window > 0) i_hi = min(i_hi, k0 + nk - 1 + window - q_offset);
  const float scale_log2 = scale * kLog2e;
  float acc_k[4][C::kDpt], acc_v[4][C::kDpt];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < C::kDpt; ++e) acc_k[c][e] = acc_v[c][e] = 0.0f;

  for (int hg = 0; hg < g; ++hg) {
    const long long bh = h0 + hg;
    for (long long q0 = (i_lo / kTile) * kTile; q0 < i_hi; q0 += kTile) {
      const int nq = static_cast<int>(min(static_cast<long long>(kTile), sq - q0));
      const long long row0 = bh * sq + q0;
      load_tile<T, DH>(q + row0 * DH, qs, nq);
      load_tile<T, DH>(dout + row0 * DH, dos, nq);
      if (tid < kTile) {
        lse2[tid] = tid < nq ? lse[row0 + tid] * kLog2e : 0.0f;
        drow[tid] = tid < nq ? delta[row0 + tid] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<DH>(qs, ks, s);
      dot_tile<DH>(dos, vs, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        const long long qpos = q0 + i + q_offset;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int j = tx + 16 * bb;
          const bool ok = i < nq && visible(qpos, k0 + j, sk, causal, window);
          const float p = ok ? exp2f(s[a][bb] * scale_log2 - lse2[i]) : 0.0f;
          ps[i * kLdS + j] = p;
          dss[i * kLdS + j] = p * (dp[a][bb] - drow[i]);
        }
      }
      __syncthreads();
      acc_tile<DH>(ps, dos, acc_v);  // dV += Pᵀ · dO
      acc_tile<DH>(dss, qs, acc_k);  // dK += dSᵀ · Q
      __syncthreads();               // Q, dO, P and dS are free for the next tile
    }
  }
  write_tile<T, DH>(dk + (bkv * sk + k0) * DH, acc_k, scale, nk);
  write_tile<T, DH>(dv + (bkv * sk + k0) * DH, acc_v, 1.0f, nk);
}

struct Args {
  long long b, hq, hkv, sq, sk;
  float scale;
  int causal;
  long long window, q_offset;
};

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* lse,
              const void* dout, void* dq, void* delta, const Args& a, cudaStream_t stream) {
  using C = Cfg<DH>;
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (4 * C::kTileFloats + C::kScoreFloats + 2 * kTile);
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.b * a.hq),
                  static_cast<unsigned>((a.sq + kTile - 1) / kTile));
  bwd_dq_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(delta), static_cast<int>(a.hq),
      static_cast<int>(a.hq / a.hkv), a.sq, a.sk, a.scale, a.causal, a.window, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dkdv(const void* q, const void* k, const void* v, const void* lse,
                const void* dout, const void* delta, void* dk, void* dv, const Args& a,
                cudaStream_t stream) {
  using C = Cfg<DH>;
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (4 * C::kTileFloats + 2 * C::kScoreFloats + 2 * kTile);
  cudaError_t err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.b * a.hkv),
                  static_cast<unsigned>((a.sk + kTile - 1) / kTile));
  bwd_dkdv_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<int>(a.hq), static_cast<int>(a.hq / a.hkv), a.sq, a.sk, a.scale, a.causal,
      a.window, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq_dispatch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                const void* dout, void* dq, void* delta, long long dh, const Args& a,
                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_dq<T, 16>(q, k, v, o, lse, dout, dq, delta, a, st);
    case 32: return launch_dq<T, 32>(q, k, v, o, lse, dout, dq, delta, a, st);
    case 64: return launch_dq<T, 64>(q, k, v, o, lse, dout, dq, delta, a, st);
    case 128: return launch_dq<T, 128>(q, k, v, o, lse, dout, dq, delta, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dkdv_dispatch(const void* q, const void* k, const void* v, const void* lse,
                  const void* dout, const void* delta, void* dk, void* dv, long long dh,
                  const Args& a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_dkdv<T, 16>(q, k, v, lse, dout, delta, dk, dv, a, st);
    case 32: return launch_dkdv<T, 32>(q, k, v, lse, dout, delta, dk, dv, a, st);
    case 64: return launch_dkdv<T, 64>(q, k, v, lse, dout, delta, dk, dv, a, st);
    case 128: return launch_dkdv<T, 128>(q, k, v, lse, dout, delta, dk, dv, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window ≤ 0: no window.  The wrapper has checked shapes, types, alignment, dh and
// the grid, and launches the dQ entry (which writes delta = D) before the dK/dV
// entry (which reads it) on one stream.
#define REPRO_BWD_ENTRIES(SUFFIX, T)                                                      \
  extern "C" int flash_attention_bwd_dq_##SUFFIX(                                         \
      const void* q, const void* k, const void* v, const void* o, const void* lse,         \
      const void* dout, void* dq, void* delta, long long b, long long hq, long long hkv,   \
      long long sq, long long sk, long long dh, float scale, int causal, long long window, \
      long long q_offset, void* stream) {                                                  \
    const Args a{b, hq, hkv, sq, sk, scale, causal, window, q_offset};                     \
    return dq_dispatch<T>(q, k, v, o, lse, dout, dq, delta, dh, a, stream);                \
  }                                                                                        \
  extern "C" int flash_attention_bwd_dkdv_##SUFFIX(                                       \
      const void* q, const void* k, const void* v, const void* lse, const void* dout,      \
      const void* delta, void* dk, void* dv, long long b, long long hq, long long hkv,     \
      long long sq, long long sk, long long dh, float scale, int causal, long long window, \
      long long q_offset, void* stream) {                                                  \
    const Args a{b, hq, hkv, sq, sk, scale, causal, window, q_offset};                     \
    return dkdv_dispatch<T>(q, k, v, lse, dout, delta, dk, dv, dh, a, stream);             \
  }

REPRO_BWD_ENTRIES(f32, float)
REPRO_BWD_ENTRIES(bf16, __nv_bfloat16)
