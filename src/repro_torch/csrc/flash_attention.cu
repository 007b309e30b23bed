// flash_attention — blockwise streaming-softmax attention with GQA, causal and
// sliding-window masks.
//
//   o[b,h,i] = Σ_j softmax_j(q[b,h,i] · k[b,h/g,j] · scale) v[b,h/g,j]    (g = Hq / Hkv)
//   over the keys j that row i may see: j < Sk, j ≤ i + q_offset (causal) and
//   j > i + q_offset − window (window > 0).  A row that sees no key gives 0.
//
// q [B, Hq, Sq, dh], k and v [B, Hkv, Sk, dh], o like q; all contiguous, fp32 or
// bf16 (o in q's type); dh ∈ {16, 32, 64, 128}.  The softmax state (m, l, acc)
// and every product are fp32.
//
// Replaces: the Pallas TPU kernel `flash_attention` (src/repro/kernels/flash_attention.py,
// fn `flash_attention`, body `_kernel`), which streams (512 × 128) K/V blocks through
// VMEM per (b·h, q block), computes masked blocks and masks them, and is handed KV
// heads already repeated g times by `ops.flash_attention`.  In the port it is the
// attention of every prefill and full forward of the LM (nn/attention.py
// `attention_core` for Sq > 1).
//
// What bounds it on an H100: operations.  Causal attention does 4·dh fp32 operations
// per (query, visible key) pair over ~Sq²/2 pairs per head, and reads q, k, v and
// writes o once: at the llama3.2-1b prefill shape (B 8, Hq 32, Hkv 8, S 2048, dh 64)
// that is 1.4e11 operations, 2.05 ms at the 67 TFLOP/s fp32 rate outside the tensor
// cores, against 0.27 GB of tensors, 0.08 ms at 3.35 TB/s.
//
// What the design does about it, simple and right first: one block of 256 threads
// per (b·Hq, 64-row query tile); the query tile and each 64-key K/V tile are staged
// in shared memory as fp32, and each thread owns a 4 × 4 patch of the score tile
// and a 4 × dh/16 patch of the output, so every shared-memory load feeds two FMAs.
// The running (m, l, acc) of a row stay in the registers of the 16 threads that
// own it; the row max and sum go across those 16 lanes by shuffles; the
// probabilities go through shared memory to the P·V product.  GQA maps head h to
// KV head h / g instead of copying K and V g times, key tiles wholly outside the
// causal or window band are skipped (the TPU kernel computes and masks them: the
// result is the same), and the ragged ends of Sq and Sk are masked.  The longest
// causal rows are scheduled first.  Left for later: wgmma on the tensor cores
// (which needs a bf16 or TF32 decision), TMA loads and a pipelined K/V ring.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "error.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 × 16: thread (ty, tx) owns rows 4·ty … 4·ty + 3
constexpr int kLDP = kBK + 1;  // row stride of the probability tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DH>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * ((kBQ + 2 * kBK) * (DH + 1) + kBQ * kLDP);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq, int g,
                       long long sq, long long sk, float scale, int causal,
                       long long window, long long q_offset) {
  constexpr int LD = DH + 1;   // odd stride: the 16 keys a half-warp reads sit in 16 banks
  constexpr int NC = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long bh = blockIdx.x;
  const long long b = bh / hq;
  const long long kvh = b * (hq / g) + (bh % hq) / g;
  const long long q0 = (static_cast<long long>(gridDim.y) - 1 - blockIdx.y) * kBQ;
  const T* qp = q + bh * sq * DH;
  const T* kp = k + kvh * sk * DH;
  const T* vp = v + kvh * sk * DH;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    qs[r * LD + c] = q0 + r < sq ? to_float(qp[(q0 + r) * DH + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;
  }

  // the keys that some row of this tile may see: [k_lo, k_hi)
  const long long qa_lo = q0 + q_offset;
  const long long qa_hi = min(q0 + kBQ, sq) - 1 + q_offset;
  long long k_lo = 0, k_hi = sk;
  if (causal) k_hi = min(k_hi, qa_hi + 1);
  if (window > 0) k_lo = max(k_lo, qa_lo - window + 1);

  for (long long k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // qs is stored; the last tile's reads of ks, vs and ps are done
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      const bool in = k0 + r < sk;
      ks[r * LD + c] = in ? to_float(kp[(k0 + r) * DH + c]) : 0.0f;
      vs[r * LD + c] = in ? to_float(vp[(k0 + r) * DH + c]) : 0.0f;
    }
    __syncthreads();

    // scores of rows 4·ty + i against keys k0 + tx + 16·j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DH; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: each row's 64 scores lie in the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + 4 * ty + i + q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + tx + 16 * j;
        const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // nothing seen yet: p = 0
      const float alpha = expf(m[i] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        ps[(4 * ty + i) * kLDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

    // acc[rows 4·ty + i, columns tx + 16·n] += P · V
#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kLDP + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float vv = vs[j * LD + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    T* out = o + (bh * sq + r) * DH;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store(out + tx + 16 * n, l[i] > 0.0f ? acc[i][n] / l[i] : 0.0f);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, long long b, long long hq,
           long long hkv, long long sq, long long sk, float scale, int causal,
           long long window, long long q_offset, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(b * hq), static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<int>(hq), static_cast<int>(hq / hkv), sq, sk, scale,
      causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, long long b, long long hq,
             long long hkv, long long sq, long long sk, long long dh, float scale, int causal,
             long long window, long long q_offset, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, window, q_offset, st);
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, window, q_offset, st);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, window, q_offset, st);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, window, q_offset, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window ≤ 0: no window.  The wrapper has checked shapes, types, dh and the grid.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   long long b, long long hq, long long hkv, long long sq,
                                   long long sk, long long dh, float scale, int causal,
                                   long long window, long long q_offset, void* stream) {
  return dispatch<float>(q, k, v, o, b, hq, hkv, sq, sk, dh, scale, causal, window, q_offset,
                         stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    long long b, long long hq, long long hkv, long long sq,
                                    long long sk, long long dh, float scale, int causal,
                                    long long window, long long q_offset, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, dh, scale, causal, window,
                                 q_offset, stream);
}
