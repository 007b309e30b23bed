// flash_attention — blockwise streaming-softmax attention with GQA, causal and
// sliding-window masks, on Hopper's tensor cores.
//
//   o[b,h,i] = Σ_j softmax_j(q[b,h,i] · k[b,h/g,j] · scale) v[b,h/g,j]    (g = Hq / Hkv)
//   over the keys j that row i may see: j < Sk, j ≤ i + q_offset (causal) and
//   j > i + q_offset − window (window > 0).  A row that sees no key gives 0.
//
// q [B, Hq, Sq, dh], k and v [B, Hkv, Sk, dh], o like q; all contiguous and
// 16-byte aligned, fp32 or bf16 (o in q's type); dh ∈ {16, 32, 64, 128, 160}.  The
// softmax state (m, l, acc) is fp32.  When `lse` is not null the kernel also
// writes each row's log-sum-exp, lse [B, Hq, Sq] fp32 = ln Σ_j exp(q·k_j ·
// scale) over the visible keys, for the backward (flash_attention_bwd.cu): m
// is kept in log2 units with the scale folded in, so lse = (m + log2 l) · ln 2;
// a row that sees no key (l = 0) gets −inf, which the backward never reads (it
// masks every key of such a row).  The write is in the epilogue of an
// instantiation of its own (kLse): with lse null the launch is the serving
// kernel as it was, the same code and the same bits.
//
// Replaces: the Pallas TPU kernel `flash_attention` (src/repro/kernels/flash_attention.py,
// fn `flash_attention`, body `_kernel`), which streams (512 × 128) K/V blocks through
// VMEM per (b·h, q block), computes masked blocks and masks them, and is handed KV
// heads already repeated g times by `ops.flash_attention`.  In the port it is the
// attention of every prefill and full forward of the LM (nn/attention.py
// `attention_core` for Sq > 1).
//
// What bounds it on an H100: tensor-core operations.  Causal attention does 4·dh
// operations per (query, visible key) pair, 1.375e11 at the llama3.2-1b prefill
// shape (B 8, Hq 32, Hkv 8, S 2048, dh 64), against 0.27 GB of q, k, v and o
// (0.08 ms at 3.35 TB/s).  fp32 inputs are multiplied in error-compensated split
// TF32: x = hi + lo with hi = tf32(x) and lo = tf32(x − hi), and each product is
// hi·hi + hi·lo + lo·hi with fp32 accumulation, which keeps about fp32's accuracy
// (plain TF32 keeps ~3 digits, too few for the fp32 tolerance of 2e-5 + 2e-3·|o|).
// That is 3 × 1.375e11 operations: 0.833 ms at 495 TFLOP/s dense TF32.  bf16
// inputs take one bf16 product: 0.139 ms at 989 TFLOP/s.  The fp32 CUDA cores
// (67 TFLOP/s) could not go below 2.05 ms.  At pixtral-12b's prefill (B 8, Hq
// 32, Hkv 8, S 2,304, dh 160, causal): 4.35e11 operations, 2.637 ms in split
// TF32 and 0.440 ms in bf16, against 0.94 GB (0.28 ms).
//
// What the design does about it: one block of two warpgroups per (b·Hq, 128-row
// query tile), each warpgroup owning 64 rows.  Thread 0 keeps the K/V tiles of
// the next key blocks in flight with 1-D bulk async copies (a K or V tile of
// one KV head is one contiguous run of rows) into a ring of raw stages, completed
// on mbarriers.  The block splits each arrived tile once into the wgmma operand
// layout (hopper.cuh): K as it is (K-major for S = Q·Kᵀ), V transposed (TF32
// wgmma takes only K-major B, so the keys of each dh column must be contiguous),
// each as hi and lo, missing rows of a ragged last tile as zeros (stale shared
// memory could hold NaN, and 0 · NaN is NaN).  Each warpgroup then runs
//   S  = Q_lo·K_hiᵀ + Q_hi·K_loᵀ + Q_hi·K_hiᵀ        (wgmma m64n(BK)k8 chains)
//   online softmax in registers (quad shuffles, ex2 with the scale in log2 e)
//   O += P_lo·V_hi + P_hi·V_lo + P_hi·V_hi           (wgmma m64n(dh)k8, P from registers)
// At fp32 and dh ≤ 64 (the LM's path) Q is split once and its hi and lo A
// fragments stay in registers, and the operands have two buffers: the block
// splits tile t + 1 into one while the tensor cores run tile t's S from the
// other, so the split (CUDA cores, shared memory) hides behind the products.
// fp32 at dh 128 (whose Q fragments would take 128 registers a thread) and bf16
// at dh 16 and 32 read Q from shared memory and use one buffer; fp32 at dh 128
// also takes 32-key tiles and one raw stage to fit in 227 KB.  dh 160 (pixtral-12b, whose
// prefill and training run it causal over 2,304 rows in fp32): Q's hi and lo
// for 128 rows would take 163,840 B.  But Q is only ever the A of S = Q·Kᵀ,
// and wgmma may read A from registers, so fp32 at dh 160 (kQFrag) keeps Q raw
// in shared memory in the A-fragment order of hopper.cuh (one conflict-free
// 16-byte load a k step and thread) and splits it in registers four k steps at
// a time, the next group's split running while the tensor cores take the last
// (hopper::product_frag).  That halves Q's bytes, so the block keeps dh ≤ 128's
// two warpgroups of 64 rows, and one warpgroup's splits and softmax run beside
// the other's products: Q 81,920 + K and Vᵀ hi and lo of 32 keys 81,920 + one
// raw K/V stage 40,960 + 8 = 204,808 B, one block an SM.  Its splits (Q, K, Vᵀ
// and P) leave lo unrounded (hopper::split_tf32_fast): three ALU operations
// where the rounded split takes five.  O += P·V is one m64n160 wgmma a k step
// (80 fp32 accumulators a thread); ptxas -v gives 246 registers a thread in
// fp32 at dh 160, no spills.  bf16 at dh 64, 128 and 160 (the production
// dtype's path: bf16 params) runs a kernel of its own, on TMA tensor copies and
// warp-specialised: the note above flash_attention_ws_kernel.  Times against the bound: PERF.md §6.  The
// split's bank spreading gives each group of 8 threads 8 distinct chunks.  P never
// leaves the registers: the S accumulator gives a thread keys 2t, 2t+1 of each
// 8-key group where the TF32 A fragment wants keys t, t+4, so the V split stores
// each 8-key group in the order 0 2 4 6 1 3 5 7 and the product is unchanged.  (bf16 needs
// no reordering: its k16 fragment matches the accumulator.)  Nothing branches
// between a wgmma's issue and its wait, so ptxas keeps the wgmma pipelined.  Key
// tiles outside a warpgroup's causal or window band are skipped, masks are
// applied (by select) only on tiles that cross the band or the end of Sk, the
// longest causal rows are scheduled first, and GQA reads KV head h / g in place.
// Every output element has one owner: no atomics, the same bits on every run.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mutex>
#include <type_traits>
#include <vector>

#include "error.cuh"
#include "hopper.cuh"
#include "tma.cuh"

namespace {

using hopper::Mma;
using hopper::Op;
using hopper::Src;

constexpr int kWG = 64;  // query rows per warpgroup

template <typename T, int DH>
struct Cfg {
  static constexpr bool kSplit = std::is_same<T, float>::value;  // fp32: hi + lo
  static constexpr Op kOp = kSplit ? Op::kTf32 : Op::kBf16;
  static constexpr int kParts = kSplit ? 2 : 1;
  static constexpr int kE = static_cast<int>(sizeof(T));  // operand bytes: tf32 4, bf16 2
  static constexpr int kEPC = 16 / kE;                    // elements per 16-byte chunk
  static constexpr int kCPR = DH / kEPC;                  // chunks per row of q or k
  static constexpr int kKStep = 32 / kE;                  // k of one wgmma
  // A block is two warpgroups of 64 query rows.
  static constexpr int kWGs = 2;
  static constexpr int kBQ = kWGs * kWG;        // query rows per block
  static constexpr int kThreads = kWGs * 128;
  // fp32 up to dh 64 keeps Q's hi and lo A fragments in registers and splits
  // tile t + 1 into a second operand buffer while tile t computes.  fp32 from
  // dh 128 (whose fragments would take 128 registers a thread or more) and
  // bf16 at dh 16 and 32 read Q from shared memory and use one operand buffer;
  // fp32 from dh 128 also shrinks the tiles to 32 keys and one raw stage to fit
  // in 227 KB.  (bf16 at dh 64, 128 and 160 is flash_attention_ws_kernel's.)
  static constexpr bool kQRegs = kSplit && DH <= 64;
  // fp32 at dh 160 keeps Q raw in the A-fragment order of hopper.cuh (80 KB for
  // 128 rows, where its hi and lo would take 160 KB) and splits it into
  // fragments in registers a group of k steps at a time (hopper::product_frag).
  static constexpr bool kQFrag = kSplit && DH > 128;
  static constexpr int kBK = (kSplit && DH >= 128) ? 32 : 64;
  static constexpr int kStages = (kSplit && DH >= 128) ? 1 : 2;
  static constexpr int kBufs = kQRegs ? 2 : 1;  // two: tile t + 1 is split while t computes
  static constexpr int kQBytes = kBQ * DH * kE;    // one part of the Q operand
  static constexpr int kKBytes = kBK * DH * kE;    // one part of the K (or Vᵀ) operand
  static constexpr int kBufBytes = kParts * 2 * kKBytes;  // K and Vᵀ, all parts
  static constexpr int kRawBytes = kBK * DH * kE;  // one raw K (or V) tile
  // with fragments in registers, Q is split into the second operand buffer
  static constexpr int kQRegion = kQRegs ? 0 : kQFrag ? kQBytes : kParts * kQBytes;
  static constexpr int kSmem =
      kQRegion + kBufs * kBufBytes + kStages * 2 * kRawBytes + 8 * kStages;
  static_assert(!kQRegs || kParts * kQBytes <= kBufBytes, "Q must fit in an operand buffer");
  static_assert(kSmem <= 232448, "a block may have at most 227 KB of shared memory");
};

// x ≈ hi + lo by hopper::split_tf32, or with kFast (fp32 at dh 160, Cfg::kQFrag)
// by hopper::split_tf32_fast
template <bool kFast>
__device__ __forceinline__ void split_x(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kFast) hopper::split_tf32_fast(x, hi, lo);
  else hopper::split_tf32(x, hi, lo);
}

// One 16-byte chunk of raw values → the operand part(s) at byte `off`.
template <typename T, bool kFast = false>
__device__ __forceinline__ void put_chunk(unsigned char* hi, unsigned char* lo, int off,
                                          uint4 x) {
  if constexpr (std::is_same<T, float>::value) {
    uint4 h, l;
    split_x<kFast>(__uint_as_float(x.x), h.x, l.x);
    split_x<kFast>(__uint_as_float(x.y), h.y, l.y);
    split_x<kFast>(__uint_as_float(x.z), h.z, l.z);
    split_x<kFast>(__uint_as_float(x.w), h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  } else {
    *reinterpret_cast<uint4*>(hi + off) = x;
  }
}

// Rows [0, R) of a row-major [rows, DH] tile → a K-major operand of R rows;
// rows ≥ nvalid become 0.  Each group of 8 threads takes 8 rows and 8
// distinct chunks, so neither its reads nor its writes share a bank.  Every
// thread runs the same unrolled steps: no branch.  kGlobal: the tile is in
// device memory, where rows ≥ nvalid may not be read; in shared memory they
// are read and dropped.
template <typename T, int DH, int R, bool kGlobal>
__device__ __forceinline__ void split_rows(const T* raw, unsigned char* hi, unsigned char* lo,
                                           int nvalid) {
  using C = Cfg<T, DH>;
  constexpr int CPR = C::kCPR, N = R * CPR, NT = C::kThreads;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int q = it * NT + static_cast<int>(threadIdx.x);
    if (N % NT != 0 && q >= N) break;
    const int i = q & 7, j = q >> 3;
    const int r = (j % (R / 8)) * 8 + i, c = (j / (R / 8) + i) % CPR;
    const uint4* src = reinterpret_cast<const uint4*>(raw + r * DH + c * C::kEPC);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kGlobal) {
      if (r < nvalid) x = *src;
    } else {
      const uint4 y = *src;
      x = r < nvalid ? y : x;
    }
    put_chunk<T, C::kQFrag>(hi, lo, hopper::chunk_offset(R, r, c), x);
  }
}

// Key of element e in chunk kc of the Vᵀ operand.  TF32: each 8-key group is
// stored as keys 0 2 4 6 | 1 3 5 7, the order in which a thread's S
// accumulator values sit in the A fragment of P; bf16: in order.
template <typename T>
__device__ __forceinline__ int vt_key(int kc, int e) {
  if constexpr (std::is_same<T, float>::value) return 8 * (kc >> 1) + 2 * e + (kc & 1);
  return 8 * kc + e;
}

// The raw [BK, DH] V tile in shared memory → the Vᵀ operand (DH rows, BK keys
// along K); keys ≥ nvalid become 0.  Branch-free like split_rows.
template <typename T, int DH>
__device__ __forceinline__ void split_vt(const T* raw, unsigned char* hi, unsigned char* lo,
                                         int nvalid) {
  using C = Cfg<T, DH>;
  constexpr int NKC = C::kBK / C::kEPC, N = DH * NKC, NT = C::kThreads;  // key chunks, units
  using Bits = typename std::conditional<C::kSplit, uint32_t, uint16_t>::type;
  const Bits* bits = reinterpret_cast<const Bits*>(raw);
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int q = it * NT + static_cast<int>(threadIdx.x);
    if (N % NT != 0 && q >= N) break;
    const int d = q % DH, kc = q / DH;
    union {
      uint4 u;
      Bits v[C::kEPC];
    } x;
#pragma unroll
    for (int e = 0; e < C::kEPC; ++e) {
      const int key = vt_key<T>(kc, e);
      const Bits y = bits[key * DH + d];
      x.v[e] = key < nvalid ? y : Bits(0);
    }
    put_chunk<T, C::kQFrag>(hi, lo, hopper::chunk_offset(DH, d, kc), x.u);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// kLse: also write each row's log-sum-exp (an instantiation of its own, so
// that the serving path without it is the kernel it was)
template <typename T, int DH, bool kLse>
__global__ void __launch_bounds__(Cfg<T, DH>::kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int hq, int g,
                       long long sq, long long sk, float scale_log2, int causal,
                       long long window, long long q_offset) {
  using C = Cfg<T, DH>;
  constexpr int BK = C::kBK, NS = BK / 2, NO = DH / 2, kBQ = C::kBQ;
  constexpr int QK_STEPS = DH / C::kKStep, PV_STEPS = BK / C::kKStep;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* bufs = smem + C::kQRegion;  // [buffer][K parts, Vᵀ parts]
  unsigned char* raw = bufs + C::kBufs * C::kBufBytes;  // [stage][K tile, V tile]
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + C::kStages * 2 * C::kRawBytes);
  unsigned char* qs = C::kQRegs ? bufs + (C::kBufs - 1) * C::kBufBytes : smem;  // [part][Q]

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const long long bh = blockIdx.x;
  const long long b = bh / hq;
  const long long kvh = b * (hq / g) + (bh % hq) / g;
  const long long q0 = (static_cast<long long>(gridDim.y) - 1 - blockIdx.y) * kBQ;
  const T* qp = q + (bh * sq + q0) * DH;
  const T* kp = k + kvh * sk * DH;
  const T* vp = v + kvh * sk * DH;

  // the key tiles that some row of the block may see: [t0, t0 + BK · n_tiles)
  long long k_lo = 0, k_hi = sk;
  if (causal) k_hi = min(k_hi, min(q0 + kBQ, sq) - 1 + q_offset + 1);
  if (window > 0) k_lo = max(k_lo, q0 + q_offset - window + 1);
  const long long t0 = (k_lo / BK) * BK;
  const int n_tiles = k_hi > t0 ? static_cast<int>((k_hi - t0 + BK - 1) / BK) : 0;

  auto issue = [&](int t, int stage) {  // thread 0: bulk-copy tile t into a raw stage
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    const uint32_t bytes = static_cast<uint32_t>(min(static_cast<long long>(BK), sk - k0)) *
                           DH * C::kE;
    unsigned char* dst = raw + stage * 2 * C::kRawBytes;
    hopper::mbar_expect_tx(&full[stage], 2 * bytes);
    hopper::bulk_load(dst, kp + k0 * DH, bytes, &full[stage]);
    hopper::bulk_load(dst + C::kRawBytes, vp + k0 * DH, bytes, &full[stage]);
  };
  auto arrived = [&](int t) {  // all threads: wait until tile t is in its raw stage
    hopper::mbar_wait(&full[t % C::kStages], (t / C::kStages) & 1);
  };
  auto split_tile = [&](int t, unsigned char* buf) {  // all threads, once tile t has arrived
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    const int nvalid = static_cast<int>(min(static_cast<long long>(BK), sk - k0));
    const T* rk = reinterpret_cast<const T*>(raw + (t % C::kStages) * 2 * C::kRawBytes);
    unsigned char* vt = buf + C::kParts * C::kKBytes;
    split_rows<T, DH, BK, false>(rk, buf, buf + C::kKBytes, nvalid);
    split_vt<T, DH>(rk + BK * DH, vt, vt + C::kKBytes, nvalid);
  };

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(C::kStages, n_tiles); ++t) issue(t, t);
  if constexpr (C::kQFrag) {  // each warpgroup its 64 rows, each thread its own fragments
    const long long nq = min(static_cast<long long>(kWG), sq - q0 - wg * kWG);
    hopper::load_frags<DH>(qp + wg * kWG * DH, static_cast<int>(max(nq, 0LL)),
                           qs + wg * kWG * DH * C::kE, tid & 127);
  } else {
    split_rows<T, DH, kBQ, true>(qp, qs, qs + C::kQBytes,
                                 static_cast<int>(min(static_cast<long long>(kBQ), sq - q0)));
  }
  if (n_tiles > 0) {
    arrived(0);
    split_tile(0, bufs);
  }
  hopper::fence_proxy_async();
  __syncthreads();
  if (tid == 0 && C::kStages < n_tiles) {
    hopper::fence_proxy_async();
    issue(C::kStages, 0);
  }

  // this warpgroup's rows and the absolute positions of its first and last
  const long long wq0 = q0 + wg * kWG;
  const bool rows = wq0 < sq;
  const long long qa_lo = wq0 + q_offset, qa_hi = min(wq0 + kWG, sq) - 1 + q_offset;
  // this thread's two rows of the accumulators: r0 and r0 + 8 of the warpgroup's 64
  const int r0 = warp * 16 + (lane >> 2), tig = lane & 3;

  // Q's hi and lo A fragments where they stay in registers (k step i: row r0,
  // column 8i + tig; r0 + 8; r0, 8i + tig + 4; r0 + 8), else Q's descriptors
  uint32_t qf_hi[4 * QK_STEPS], qf_lo[4 * QK_STEPS];
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int i = 0; i < QK_STEPS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off =
            hopper::chunk_offset(kBQ, wg * kWG + r0 + 8 * (j & 1), 2 * i + (j >> 1)) + 4 * tig;
        qf_hi[4 * i + j] = *reinterpret_cast<const uint32_t*>(qs + off);
        qf_lo[4 * i + j] = *reinterpret_cast<const uint32_t*>(qs + C::kQBytes + off);
      }
    __syncthreads();  // Q's region is the second operand buffer: read before reuse
  }
  const uint64_t dq_hi = hopper::make_desc(qs + wg * (kWG / 8) * 128, kBQ * 16, 128);
  const uint64_t dq_lo = dq_hi + (C::kQBytes >> 4);

  float acc[NO], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    unsigned char* buf = bufs + (t % C::kBufs) * C::kBufBytes;
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    // does some row of this warpgroup see a key of this tile?
    const bool active = rows && !(causal && k0 > qa_hi) &&
                        !(window > 0 && k0 + BK - 1 <= qa_lo - window);
    const uint64_t dk_hi = hopper::make_desc(buf, BK * 16, 128);
    const uint64_t dk_lo = dk_hi + (C::kKBytes >> 4);
    const uint64_t dv_hi = hopper::make_desc(buf + C::kParts * C::kKBytes, DH * 16, 128);
    const uint64_t dv_lo = dv_hi + (C::kKBytes >> 4);

    // tile t + 1 is split while the tensor cores work on tile t: wait for it first,
    // so that nothing between the wgmma issue and its wait branches
    const bool ahead = C::kBufs == 2 && t + 1 < n_tiles;
    if (ahead) arrived(t + 1);

    // S = Q · Kᵀ, issued asynchronously
    unsigned char* next = bufs + ((t + 1) % C::kBufs) * C::kBufBytes;
    float s[NS];
    if (!active) {
      if (ahead) split_tile(t + 1, next);
    } else {
      if constexpr (C::kQFrag) {
        hopper::product_frag<DH, BK, 4>(s, qs + wg * kWG * DH * C::kE, buf, C::kKBytes);
      } else {
        hopper::wgmma_fence();
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int i = 0; i < QK_STEPS; ++i)
            Mma<C::kOp, Src::kRS, BK>::run(s, qf_lo + 4 * i, dk_hi + i * (2 * BK), i > 0);
#pragma unroll
          for (int i = 0; i < QK_STEPS; ++i)
            Mma<C::kOp, Src::kRS, BK>::run(s, qf_hi + 4 * i, dk_lo + i * (2 * BK), 1);
#pragma unroll
          for (int i = 0; i < QK_STEPS; ++i)
            Mma<C::kOp, Src::kRS, BK>::run(s, qf_hi + 4 * i, dk_hi + i * (2 * BK), 1);
        } else {
          if constexpr (C::kSplit) {
#pragma unroll
            for (int i = 0; i < QK_STEPS; ++i)
              Mma<C::kOp, Src::kSS, BK>::run(s, dq_lo + i * (2 * kBQ), dk_hi + i * (2 * BK), i > 0);
#pragma unroll
            for (int i = 0; i < QK_STEPS; ++i)
              Mma<C::kOp, Src::kSS, BK>::run(s, dq_hi + i * (2 * kBQ), dk_lo + i * (2 * BK), 1);
          }
#pragma unroll
          for (int i = 0; i < QK_STEPS; ++i)
            Mma<C::kOp, Src::kSS, BK>::run(s, dq_hi + i * (2 * kBQ), dk_hi + i * (2 * BK),
                                           C::kSplit || i > 0);
        }
        hopper::wgmma_commit();
        // while the tensor cores work: split the next tile into the other buffer
        if (ahead) split_tile(t + 1, next);
        hopper::wgmma_wait_all();
        hopper::fence_regs(s);
      }

      // online softmax; s[4·i + 2·h + e] is row r0 + 8·h, key k0 + 8·i + 2·tig + e
      const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > qa_lo) ||
                          (window > 0 && k0 <= qa_hi - window);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long qpos = qa_lo + r0 + 8 * h;
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[4 * i + 2 * h + e] * scale_log2;
            if (masked) {
              const long long kpos = k0 + 8 * i + 2 * tig + e;
              const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                              (window <= 0 || kpos > qpos - window);
              x = ok ? x : -INFINITY;
            }
            s[4 * i + 2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // nothing seen yet: p = 0
        const float alpha = hopper::exp2_approx(m[h] - m_use);
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = hopper::exp2_approx(s[4 * i + 2 * h + e] - m_use);
            s[4 * i + 2 * h + e] = p;
            sum += p;
          }
        l[h] = l[h] * alpha + sum;  // this thread's share; the quad sums it at the end
        m[h] = m_new;
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          acc[4 * i + 2 * h] *= alpha;
          acc[4 * i + 2 * h + 1] *= alpha;
        }
      }

      // O += P · V with P from registers
      uint32_t p_hi[4 * PV_STEPS], p_lo[C::kSplit ? 4 * PV_STEPS : 1];
      if constexpr (C::kSplit) {
        // k step i covers keys 8i … 8i + 7; the fragment holds (row, key-slot tig)
        // = key 2·tig, (row + 8, tig), (row, tig + 4) = key 2·tig + 1, (row + 8, tig + 4)
#pragma unroll
        for (int i = 0; i < PV_STEPS; ++i) {
          split_x<C::kQFrag>(s[4 * i + 0], p_hi[4 * i + 0], p_lo[4 * i + 0]);
          split_x<C::kQFrag>(s[4 * i + 2], p_hi[4 * i + 1], p_lo[4 * i + 1]);
          split_x<C::kQFrag>(s[4 * i + 1], p_hi[4 * i + 2], p_lo[4 * i + 2]);
          split_x<C::kQFrag>(s[4 * i + 3], p_hi[4 * i + 3], p_lo[4 * i + 3]);
        }
      } else {
        // k step i covers keys 16i … 16i + 15: pairs (row, 2·tig), (row + 8, 2·tig),
        // (row, 2·tig + 8), (row + 8, 2·tig + 8)
#pragma unroll
        for (int i = 0; i < PV_STEPS; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int src = 8 * i + 4 * (j >> 1) + 2 * (j & 1);
            __nv_bfloat162 pr = __floats2bfloat162_rn(s[src], s[src + 1]);
            p_hi[4 * i + j] = *reinterpret_cast<uint32_t*>(&pr);
          }
      }
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      if constexpr (C::kSplit) {
#pragma unroll
        for (int i = 0; i < PV_STEPS; ++i)
          Mma<C::kOp, Src::kRS, DH>::run(acc, p_lo + 4 * i, dv_hi + i * (2 * DH), 1);
#pragma unroll
        for (int i = 0; i < PV_STEPS; ++i)
          Mma<C::kOp, Src::kRS, DH>::run(acc, p_hi + 4 * i, dv_lo + i * (2 * DH), 1);
      }
#pragma unroll
      for (int i = 0; i < PV_STEPS; ++i)
        Mma<C::kOp, Src::kRS, DH>::run(acc, p_hi + 4 * i, dv_hi + i * (2 * DH), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      hopper::fence_regs(p_hi);
      if constexpr (C::kSplit) hopper::fence_regs(p_lo);
    }

    // one buffer: the next tile is split only once both warpgroups are done
    if (C::kBufs == 1 && t + 1 < n_tiles) {
      __syncthreads();
      arrived(t + 1);
      split_tile(t + 1, next);
    }
    hopper::fence_proxy_async();
    __syncthreads();  // tile t + 1 is split, tile t's buffer and tile t + 1's raw stage are free
    if (tid == 0 && t + 1 + C::kStages < n_tiles) {
      hopper::fence_proxy_async();
      issue(t + 1 + C::kStages, (t + 1) % C::kStages);
    }
  }

  if (!rows) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const long long r = wq0 + r0 + 8 * h;
    if (r >= sq) continue;
    if constexpr (kLse) {
      if (tig == 0)
        lse[bh * sq + r] = lt > 0.0f ? (m[h] + log2f(lt)) * 0.6931471805599453f : -INFINITY;
    }
    T* out = o + (bh * sq + r) * DH + 2 * tig;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      store2(out + 8 * i, lt > 0.0f ? acc[4 * i + 2 * h] / lt : 0.0f,
             lt > 0.0f ? acc[4 * i + 2 * h + 1] / lt : 0.0f);
  }
}

// ------------------------------------------------------- bf16 at dh 64, 128, 160
// The production dtype's path (bf16 params, so bf16 q, k and v): pixtral-12b at
// dh 160, llama3.2-1b, hymba-1.5b and seamless-m4t at dh 64, qwen3-moe-30b-a3b
// at dh 128.  The design above split each arrived K/V tile into the operand
// layout on all 256 threads between two barriers, beside no product, and read
// bf16 Q from shared memory with one operand buffer (at dh 64 21% of the bound,
// half SDPA's rate on an H100; at dh 160 a quarter, with 2-way bank conflicts and
// V transposed element by element).  Here no thread touches an operand:
//   * TMA tensor copies (tma.cuh) land Q, K and V in the 64-byte swizzle that
//     wgmma reads in place (dh / 32 boxes a tile): Q and K K-major, V MN-major
//     through the transpose bit of B (a 16-bit B may be either), so V needs no
//     transpose.  The maps are 3-D (dh, S, B·H): keys past Sk and rows past Sq
//     arrive as zeros, and a ragged tile needs no zeroing.  The host encodes
//     them per call.
//   * A block is three warpgroups.  Warpgroup 0 is the producer: one thread
//     hands each unit of work (128 query rows of one head) to the consumers as
//     a record in shared memory with its Q, then keeps a ring of Ws<DH>::kStages
//     K and V tiles full (a full and an empty mbarrier per tile and operand);
//     the warpgroup gives its registers to the consumers (setmaxnreg 24 /
//     240).  Warpgroups 1 and 2 own 64 query rows each and run the same loop
//     over the unit's key tiles of 128 keys, the masks applied by select where
//     a tile crosses the band or the end of Sk.
//   * Each consumer overlaps its own softmax with its products (FA3's order):
//     in step t it issues S_t = Q·K_tᵀ, rescales O to tile t − 1's maxima
//     while S_t runs, issues O += P_{t−1}·V_{t−1}, waits for S_t alone and runs
//     the softmax of tile t while the P·V product runs.  The two consumers take
//     turns to issue (two named barriers, FA3's ping-pong), so that one's
//     softmax runs beside the other's products.  At dh 64 the softmax is as
//     long as the products: a 64 × 128 tile's 8,192 ex2 take a consumer's four
//     warps 512 cycles of the SM's 16-a-cycle special-function units, as long
//     as the tile's two products take the tensor cores (≈ 0.138 ms against
//     0.139 ms of products at the llama3.2-1b prefill shape).  (Three consumers
//     of 160 registers, FA3's 192 rows at dh 64, spilled.)
//   * The softmax is short chains: the rows' maxima and sums run as four
//     partial chains each (with two consumer warps on an SM sub-partition, one
//     chain of 64 dependent operations a row held each tile for its latency),
//     p = 2^(s·scale − m) is one FFMA and one ex2, and the masks are 32-bit
//     bounds per row (the 64-bit ones spilled at dh 160).
//   * Units go by KV head, then query tile (the longest causal rows first),
//     then the group's query heads, so that the units in flight read the K/V
//     of one or two KV heads from L2 (the production prefill's K/V would
//     otherwise stream from HBM once per query head group in flight).  At dh
//     64 and 128 the grid is persistent (Ws::kPersistent): a block an SM, its
//     producer fetching the next unit from a counter (an int32 atomic of the
//     device and stream, unit_counter, zeroed on the call's stream before the
//     launch; which block takes a unit changes no bit) and loading its
//     Q and first K/V tiles while the consumers finish the last unit's
//     softmax, products and stores; the ring and the turns run on across
//     units.  A block a unit filled and drained its pipeline once a unit
//     (scripts/flash_variants.py times both grids), and a fixed round-robin of
//     units over the blocks handed the heaviest causal units to the same blocks
//     at B 2 × S 4,096, so units are fetched.  dh 160 keeps a block a unit: its
//     persistent loop spilled.  (A
//     cluster of two blocks sharing each K/V tile by TMA multicast measured
//     slower at dh 160 on an H100, and was dropped.)
// fp32 (m, l, O) and the softmax in registers (O dh / 2, S 64 and P's fragments
// 32 a thread), causal rows heaviest first within a KV head, GQA read in place,
// one owner for each output element (no atomics on data, the same bits on
// every run).  Shared memory (1024-aligned): kQBufs buffers of Q, 128 · dh · 2 B,
// and kStages stages of K and V of 128 keys: at dh 160 40,960 + 2 · 81,920; at
// dh 128 2 · 32,768 + 2 · 65,536; at dh 64, where a stage is 32 KB, 2 · 16,384
// + 6 · 32,768.
// What still bounds it (PERF.md §6): the K/V tiles' traffic from L2, 128
// operations a byte at 128 query rows a unit, and at dh 64 the exponentials.
constexpr int kWsBQ = 128;     // query rows a unit: two consumer warpgroups of 64
constexpr int kWsBK = 128;     // keys a tile
template <int DH>
struct Ws {
  static constexpr bool kPersistent = DH < 160;       // a block an SM, units fetched
  // Q buffers: persistent, the next unit's Q lands while the consumers finish the last
  static constexpr int kQBufs = kPersistent ? 2 : 1;
  static constexpr int kStages = DH == 64 ? 6 : 2;  // K/V tiles in flight
  static constexpr int kQBytes = kWsBQ * DH * 2;
  static constexpr int kKBytes = kWsBK * DH * 2;
  // full and empty of each Q buffer, and of K and of V a stage
  static constexpr int kBars = 2 * kQBufs + 4 * kStages;
  // + two unit records of 16 bytes
  static constexpr int kSmem =
      1024 + kQBufs * kQBytes + 2 * kStages * kKBytes + 8 * kBars + 32;
  static_assert(DH % tma::kBoxCols == 0, "a tile is whole 32-column boxes");
  static_assert(kSmem <= 232448, "a block may have at most 227 KB of shared memory");
};
// the head dims the warp-specialised kernels take in bf16
template <typename T, int DH>
constexpr bool kWsPath = std::is_same<T, __nv_bfloat16>::value && (DH == 64 || DH == 128 ||
                                                                   DH == 160);
// the registers a thread of the producer and of a consumer (setmaxnreg): together
// 24 · 128 + 240 · 256 = 64,512, what the block is launched with (384 · 168)
constexpr int kWsRegsProducer = 24, kWsRegsConsumer = 240;
constexpr int kWsSchedBar = 1;  // named barriers 1 and 2: consumer 0's and consumer 1's turn

template <int DH, bool kLse>
__global__ void __launch_bounds__(384, 1)
flash_attention_ws_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int hq, int g, long long sq, long long sk,
                          float scale_log2, int causal, long long window, long long q_offset,
                          int n_units, int* __restrict__ next_unit) {
  using W = Ws<DH>;
  constexpr int BK = kWsBK, BQ = kWsBQ, S = W::kStages, NS = BK / 2, NO = DH / 2;
  constexpr int QK_STEPS = DH / 16, PV_STEPS = BK / 16;
  extern __shared__ unsigned char smem_raw[];
  constexpr int QB = W::kQBufs;
  unsigned char* qs = tma::align1024(smem_raw);          // [buffer][box][128 rows][64 B]
  unsigned char* ks = qs + QB * W::kQBytes;               // [stage][box][BK rows][64 B]
  unsigned char* vs = ks + S * W::kKBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vs + S * W::kKBytes);  // [buffer]
  uint64_t* empty_q = full_q + QB;                                      // [buffer]
  uint64_t* full_k = empty_q + QB;
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;
  int4* rec = reinterpret_cast<int4*>(empty_v + S);  // [2]: a unit's q0, b · Hq + head, t0, tiles

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int b = 0; b < QB; ++b) {
      hopper::mbar_init(&full_q[b], 1);
      hopper::mbar_init(&empty_q[b], 8);  // one arrival from each consumer warp
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty_k[s], 8);
      hopper::mbar_init(&empty_v[s], 8);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: a unit's record and Q, then its K/V tiles into the ring
    tma::regs_dec<kWsRegsProducer>();
    if (tid == 0) {
      const int n_qb = static_cast<int>((sq + BQ - 1) / BQ);
      int tiles = 0;  // K/V tiles loaded so far: the ring's position
      // unit j of the block: its first is blockIdx.x; persistent, the next from the
      // counter; one a block, a record of −1 tiles after it (see the consumers)
      for (int j = 0, u = blockIdx.x;; ++j) {
        // unit j − QB's S products done: its Q buffer and record are free
        const int qb = j % QB;
        if (j >= QB) hopper::mbar_wait(&empty_q[qb], ((j / QB) - 1) & 1);
        if (u >= n_units) {  // no unit left: a record of −1 tiles ends the consumers' loop
          rec[j & 1] = make_int4(0, 0, 0, -1);
          tma::arrive(&full_q[qb]);
          break;
        }
        // the next unit, fetched now and read at the loop's end
        const int fetched = W::kPersistent ? atomicAdd(next_unit, 1) : 0;
        const int bkv = u / g / n_qb;  // b · Hkv + KV head
        const int q0 = (n_qb - 1 - (u / g) % n_qb) * BQ;
        const int bh = (bkv / (hq / g)) * hq + (bkv % (hq / g)) * g + u % g;
        long long k_lo = 0, k_hi = sk;  // the keys [t0, t0 + BK · n) that some row may see
        if (causal) k_hi = min(k_hi, min(static_cast<long long>(q0) + BQ, sq) - 1 + q_offset + 1);
        if (window > 0) k_lo = max(k_lo, q0 + q_offset - window + 1);
        const int t0 = static_cast<int>((k_lo / BK) * BK);
        const int n = k_hi > t0 ? static_cast<int>((k_hi - t0 + BK - 1) / BK) : 0;
        rec[j & 1] = make_int4(q0, bh, t0, n);
        if (n > 0) {
          hopper::mbar_expect_tx(&full_q[qb], W::kQBytes);
          tma::load_tile<DH, BQ>(qs + qb * W::kQBytes, &tq, q0, bh, &full_q[qb]);
        } else {
          tma::arrive(&full_q[qb]);
        }
        for (int t = 0; t < n; ++t, ++tiles) {
          const int s = tiles % S, k0 = t0 + t * BK;
          if (tiles >= S) hopper::mbar_wait(&empty_k[s], ((tiles / S) - 1) & 1);
          hopper::mbar_expect_tx(&full_k[s], W::kKBytes);
          tma::load_tile<DH, BK>(ks + s * W::kKBytes, &tk, k0, bkv, &full_k[s]);
          if (tiles >= S) hopper::mbar_wait(&empty_v[s], ((tiles / S) - 1) & 1);
          hopper::mbar_expect_tx(&full_v[s], W::kKBytes);
          tma::load_tile<DH, BK>(vs + s * W::kKBytes, &tv, k0, bkv, &full_v[s]);
        }
        u = W::kPersistent ? static_cast<int>(gridDim.x) + fetched : n_units;
      }
    }
    return;
  }

  tma::regs_inc<kWsRegsConsumer>();
  const int cw = wg - 1, ct = tid & 127, warp = ct >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), tig = lane & 3;
  float acc[NO], m[2], l[2];
  uint32_t pf[4 * PV_STEPS];  // P of the last tile as bf16 A fragments

  // S = Q · K_tᵀ of stage s from Q buffer qb, issued and committed
  auto issue_s = [&](float (&s_acc)[NS], int s, int qb) {
    const unsigned char* qw = qs + qb * W::kQBytes + cw * kWG * tma::kBoxRowBytes;  // its rows
    const unsigned char* kt = ks + s * W::kKBytes;
#pragma unroll
    for (int i = 0; i < QK_STEPS; ++i)
      Mma<Op::kBf16, Src::kSS, BK>::run(s_acc, tma::desc_k<BQ>(qw, i),
                                        tma::desc_k<BK>(kt, i), i > 0);
    hopper::wgmma_commit();
  };
  // O += P · V of stage s, issued and committed
  auto issue_pv = [&](int s) {
    const unsigned char* vt = vs + s * W::kKBytes;
#pragma unroll
    for (int i = 0; i < PV_STEPS; ++i)
      tma::mma_mn<BK, DH>(acc, pf + 4 * i, vt, i);
    hopper::wgmma_commit();
  };
  auto release = [&](uint64_t* bar) {  // this warp is done with a stage's operand
    if (lane == 0) tma::arrive(bar);
  };
  // O *= alpha by row (fp32 sums of the rows' last maximum → this tile's)
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * i + 2 * h] *= alpha[h];
        acc[4 * i + 2 * h + 1] *= alpha[h];
      }
  };
  // P (fp32) → pf, bf16 k16 fragments: pairs (r0, 2·tig), (r0 + 8, 2·tig), (r0,
  // 2·tig + 8), (r0 + 8, 2·tig + 8) of each 16 keys
  auto pack = [&](const float (&s_acc)[NS]) {
#pragma unroll
    for (int i = 0; i < PV_STEPS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int src = 8 * i + 4 * (j >> 1) + 2 * (j & 1);
        __nv_bfloat162 pr = __floats2bfloat162_rn(s_acc[src], s_acc[src + 1]);
        pf[4 * i + j] = *reinterpret_cast<uint32_t*>(&pr);
      }
  };
  // the turns: consumer cw issues after its own barrier and then opens the other's
  auto my_turn = [&] { hopper::bar_sync(kWsSchedBar + cw, 256); };
  auto your_turn = [&] { hopper::bar_arrive(kWsSchedBar + (cw ^ 1), 256); };

  int tiles = 0;  // K/V tiles consumed so far: the ring's position
  // unit j of the block; false once the producer's record ends the block's units
  auto run_unit = [&](int j) {
    const int qb = j % QB;
    hopper::mbar_wait(&full_q[qb], (j / QB) & 1);
    const int4 w = rec[j & 1];  // q0, b · Hq + head, t0, tiles
    const int n_tiles = w.w;
    if (n_tiles < 0) return false;
    const long long wq0 = w.x + cw * kWG;  // this warpgroup's rows
    // The masks in 32 bits, keys counted from t0 (S < 2^30, which launch_ws checks):
    // row q sees the keys j with w(q) ≤ j < c(q) and j < Sk − t0, where c(q) = q +
    // q_offset + 1 − t0 (causal) and w(q) = q + q_offset − window + 1 − t0 (window),
    // clamped to [−1, 2^30]; per thread for its rows r0 and r0 + 8, and for the
    // warpgroup's first row (the fewest keys under the causal mask) and last (the
    // latest window start).
    constexpr long long kCap = 1LL << 30;
    auto rel = [&](long long x) { return static_cast<int>(max(min(x - w.z, kCap), -1LL)); };
    const long long qa_lo = wq0 + q_offset, qa_hi = min(wq0 + kWG, sq) - 1 + q_offset;
    const int sk_r = rel(sk);
    const int c_first = causal ? rel(qa_lo + 1) : static_cast<int>(kCap);
    const int w_last = window > 0 ? rel(qa_hi - window + 1) : -1;
    int c_row[2], w_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long qpos = qa_lo + r0 + 8 * h;
      c_row[h] = min(sk_r, causal ? rel(qpos + 1) : static_cast<int>(kCap));
      w_row[h] = window > 0 ? rel(qpos - window + 1) : -1;
      m[h] = -INFINITY;
      l[h] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.0f;

    // the online softmax of tile t's scores; s_acc[4i + 2h + e] is row r0 + 8h,
    // key k0 + 8i + 2·tig + e.  Returns P in s_acc and each row's rescale of O.
    // The maximum is taken over the raw scores (scale > 0), m is kept in log2
    // units with the scale folded in, and p = 2^(s · scale − m) is one FFMA and
    // one ex2.  The row's maximum and sum run as four partial chains each: with
    // two consumer warps on an SM sub-partition, one chain of 64 dependent
    // operations a row would hold each tile for ~4 × 64 cycles of latency.
    auto softmax = [&](float (&s_acc)[NS], int t, float (&alpha)[2]) {
      const int k0 = t * BK;  // from t0
      const bool masked = k0 + BK > sk_r || c_first < k0 + BK || w_last > k0;
      if (masked) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lo = w_row[h] - k0, hi = c_row[h] - k0;  // the tile's keys lo ≤ j < hi
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 8 * i + 2 * tig + e;
              s_acc[4 * i + 2 * h + e] =
                  j >= lo && j < hi ? s_acc[4 * i + 2 * h + e] : -INFINITY;
            }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mx[(2 * i + e) & 3] = fmaxf(mx[(2 * i + e) & 3], s_acc[4 * i + 2 * h + e]);
        float m_row = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
        m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, 1));
        m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, 2));
        const float m_new = fmaxf(m[h], m_row * scale_log2);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // nothing seen yet: p = 0
        alpha[h] = hopper::exp2_approx(m[h] - m_use);
        float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p =
                hopper::exp2_approx(fmaf(s_acc[4 * i + 2 * h + e], scale_log2, -m_use));
            s_acc[4 * i + 2 * h + e] = p;
            sum[(2 * i + e) & 3] += p;
          }
        // this thread's share; the quad sums it at the end
        l[h] = l[h] * alpha[h] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
        m[h] = m_new;
      }
    };

    if (n_tiles == 0) {
      release(&empty_q[qb]);
    } else {
      // tile t of the unit is tile `tiles + t` of the block's ring
      auto stage = [&](int t) { return (tiles + t) % S; };
      auto phase = [&](int t) { return static_cast<uint32_t>(((tiles + t) / S) & 1); };
      float s_acc[NS], alpha[2];
      hopper::mbar_wait(&full_k[stage(0)], phase(0));
      my_turn();
      hopper::wgmma_fence();
      issue_s(s_acc, stage(0), qb);
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s_acc);
      release(&empty_k[stage(0)]);
      softmax(s_acc, 0, alpha);
      pack(s_acc);
      for (int t = 1; t < n_tiles; ++t) {
        // O is rescaled to tile t − 1's maxima while S_t runs, and P_{t−1}·V_{t−1}
        // is issued after it; the softmax of tile t runs while that product does
        const int s = stage(t), sp = stage(t - 1);
        hopper::mbar_wait(&full_k[s], phase(t));
        hopper::mbar_wait(&full_v[sp], phase(t - 1));
        my_turn();
        hopper::fence_regs(pf);
        hopper::wgmma_fence();
        issue_s(s_acc, s, qb);
        rescale(alpha);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        issue_pv(sp);
        your_turn();
        hopper::wgmma_wait<1>();  // S_t is done; P_{t−1}·V_{t−1} runs on
        hopper::fence_regs(s_acc);
        release(&empty_k[s]);
        softmax(s_acc, t, alpha);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::fence_regs(pf);
        release(&empty_v[sp]);
        pack(s_acc);
      }
      release(&empty_q[qb]);  // every S of the unit is done: its Q buffer is free
      const int sl = stage(n_tiles - 1);
      hopper::mbar_wait(&full_v[sl], phase(n_tiles - 1));
      my_turn();
      rescale(alpha);
      hopper::fence_regs(acc);
      hopper::fence_regs(pf);
      hopper::wgmma_fence();
      issue_pv(sl);
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pf);
      release(&empty_v[sl]);
      tiles += n_tiles;
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const long long r = wq0 + r0 + 8 * h;
      if (r >= sq) continue;
      const long long row = static_cast<long long>(w.y) * sq + r;
      if constexpr (kLse) {
        if (tig == 0) lse[row] = lt > 0.0f ? (m[h] + log2f(lt)) * 0.6931471805599453f : -INFINITY;
      }
      __nv_bfloat16* out = o + row * DH + 2 * tig;
      const float inv = lt > 0.0f ? 1.0f / lt : 0.0f;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        store2(out + 8 * i, acc[4 * i + 2 * h] * inv, acc[4 * i + 2 * h + 1] * inv);
    }
    return true;
  };

  // consumer 0 goes first; consumer 1's last turn is taken up by consumer 0 at the end
  if (cw == 1) your_turn();
  if constexpr (W::kPersistent) {
    for (int j = 0; run_unit(j); ++j) {
    }
  } else {
    run_unit(0);
  }
  if (cw == 0) my_turn();
}

// The persistent kernels' counter of units handed out: one int32 a device and
// stream (two streams may run the forward at once), made on first use; the
// launch zeroes it on its stream.  Null if it cannot be made.
inline int* unit_counter(cudaStream_t stream) {
  struct Entry {
    int dev;
    cudaStream_t stream;
    int* counter;
  };
  static std::mutex mu;
  static std::vector<Entry> entries;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return nullptr;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : entries)
    if (e.dev == dev && e.stream == stream) return e.counter;
  int* counter = nullptr;
  if (cudaMalloc(&counter, sizeof(int)) != cudaSuccess) return nullptr;
  entries.push_back({dev, stream, counter});
  return counter;
}

// The SMs of the current device (the persistent grid's size), read once a device.
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

template <int DH, bool kLse>
int launch_ws(const void* q, const void* k, const void* v, void* o, float* lse, long long b,
              long long hq, long long hkv, long long sq, long long sk, float scale, int causal,
              long long window, long long q_offset, cudaStream_t stream) {
  using W = Ws<DH>;
  if (b * hq * ((sq + kWsBQ - 1) / kWsBQ) > 0x7fffffffLL || sq >= (1LL << 30) ||
      sk >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);  // units; the kernel's 32-bit masks
  CUtensorMap tq, tk, tv;
  // Sk = 0 leaves no tile to load: the maps of k and v then describe q's first
  // row, which is never read
  const bool keys = sk > 0;
  int err = tma::encode_rows(&tq, q, b * hq, sq, DH, kWsBQ);
  if (err == 0) err = tma::encode_rows(&tk, keys ? k : q, keys ? b * hkv : 1, keys ? sk : 1,
                                       DH, kWsBK);
  if (err == 0) err = tma::encode_rows(&tv, keys ? v : q, keys ? b * hkv : 1, keys ? sk : 1,
                                       DH, kWsBK);
  if (err != 0) return err;
  constexpr int smem = W::kSmem;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_ws_kernel<DH, kLse>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* next_unit = nullptr;
  if constexpr (W::kPersistent) {
    next_unit = unit_counter(stream);
    if (next_unit == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
    e = cudaMemsetAsync(next_unit, 0, sizeof(int), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_units = static_cast<int>(b * hq * ((sq + kWsBQ - 1) / kWsBQ));
  const dim3 grid(static_cast<unsigned>(W::kPersistent ? min(n_units, sm_count()) : n_units));
  flash_attention_ws_kernel<DH, kLse><<<grid, 384, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, static_cast<int>(hq),
      static_cast<int>(hq / hkv), sq, sk, scale * 1.4426950408889634f, causal, window, q_offset,
      n_units, next_unit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH, bool kLse>
int launch_kernel(const void* q, const void* k, const void* v, void* o, float* lse,
                  long long b, long long hq, long long hkv, long long sq, long long sk,
                  float scale, int causal, long long window, long long q_offset,
                  cudaStream_t stream) {
  constexpr int smem = Cfg<T, DH>::kSmem;
  constexpr int kBQ = Cfg<T, DH>::kBQ;
  if ((sq + kBQ - 1) / kBQ > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(b * hq), static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  flash_attention_kernel<T, DH, kLse><<<grid, Cfg<T, DH>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, static_cast<int>(hq), static_cast<int>(hq / hkv), sq, sk,
      scale * 1.4426950408889634f, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, long long b,
           long long hq, long long hkv, long long sq, long long sk, float scale, int causal,
           long long window, long long q_offset, cudaStream_t stream) {
  if constexpr (kWsPath<T, DH>)  // TMA, warp-specialised
    return lse != nullptr ? launch_ws<DH, true>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale,
                                                causal, window, q_offset, stream)
                          : launch_ws<DH, false>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale,
                                                 causal, window, q_offset, stream);
  else
    return lse != nullptr
               ? launch_kernel<T, DH, true>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal,
                                            window, q_offset, stream)
               : launch_kernel<T, DH, false>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale,
                                             causal, window, q_offset, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, long long b,
             long long hq, long long hkv, long long sq, long long sk, long long dh, float scale,
             int causal, long long window, long long q_offset, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, sk, scale,
                           causal, window, q_offset, st);
    case 32:
      return launch<T, 32>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, sk, scale,
                           causal, window, q_offset, st);
    case 64:
      return launch<T, 64>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, sk, scale,
                           causal, window, q_offset, st);
    case 128:
      return launch<T, 128>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, sk, scale,
                            causal, window, q_offset, st);
    case 160:
      return launch<T, 160>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq, sk, scale,
                            causal, window, q_offset, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window ≤ 0: no window; lse may be null.  The wrapper has checked shapes,
// types, alignment, dh and the grid.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   void* lse, long long b, long long hq, long long hkv,
                                   long long sq, long long sk, long long dh, float scale,
                                   int causal, long long window, long long q_offset,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, lse, b, hq, hkv, sq, sk, dh, scale, causal, window,
                         q_offset, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    void* lse, long long b, long long hq, long long hkv,
                                    long long sq, long long sk, long long dh, float scale,
                                    int causal, long long window, long long q_offset,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, sq, sk, dh, scale, causal,
                                 window, q_offset, stream);
}
