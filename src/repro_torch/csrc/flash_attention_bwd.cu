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
// type), fp32 accumulation; dh ∈ {16, 32, 64, 128, 160} (160: pixtral-12b).
//
// Replaces: no TPU kernel.  The Pallas `flash_attention` (src/repro/kernels/
// flash_attention.py) has no VJP, and the JAX package's training differentiates
// its plain `flash_attention_ref` with jax.value_and_grad (src/repro/train/
// trainer.py).  In the port every attention call with more than one query row runs
// the forward kernel, so training on the card needs this backward: it is the
// backward of every layer of the LM's training step (nn/attention.py → the
// autograd Function in kernels/flash_attention.py).
//
// What bounds it on an H100: tensor-core operations.  The five products (S, dP,
// dV, dK, dQ) do 2.5× the forward's: 10·dh operations per (query, visible key)
// pair, 1.72e11 at the llama3.2-1b training shape (B 4, Hq 32, Hkv 8, S 2048, dh
// 64, causal), against ≈ 0.34 GB of q, k, v, o, dO, lse read and dq, dk, dv
// written (0.10 ms at 3.35 TB/s).  fp32 inputs are multiplied in the forward's
// error-compensated split TF32 (x = hi + lo, each product lo·hi + hi·lo + hi·hi
// with fp32 accumulation; plain TF32 misses the fp32 tolerance by ~100×): 1.04 ms
// at 495 TFLOP/s.  bf16 inputs take one bf16 product: 0.174 ms at 989 TFLOP/s.
// This design runs seven products, not five (below): its floor is 7/5 of those,
// 1.46 ms in fp32.  Measured at that shape (chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700 W): fp32 3.61 ms (29% of the 1.04 ms bound; the CUDA-core kernel
// before it 8.07), bf16 in this design 0.78 ms (22% of 0.174 ms; bf16 at dh 64,
// 128 and 160 now runs the TMA kernels at the end of this file).  What holds it
// there: the CUDA-core work between the products (each loop tile split, and in
// fp32 transposed, into the operand layout; exp, masks and dS; the fragments'
// splits), which overlaps the tensor cores only across warpgroups, and the
// operands' single buffer.
//
// What the design does about it: two kernels, so that every output element has
// one owner and no float atomics are needed (the same bits on every run):
//   * the dQ kernel, one block per (b, q head, tile of query rows), computes D
//     for its rows, writes it for the second kernel, and loops over the key
//     tiles its rows can see:  S = Q·Kᵀ, dP = dO·Vᵀ (Q and dO from shared
//     memory by descriptor), P and dS in registers, dQ += dS·K;
//   * the dK/dV kernel, launched after it on the same stream, one block per (b,
//     KV head, tile of keys), loops over the g query heads of the group and the
//     query tiles that see its keys:  Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (keys as M, K
//     and V from shared memory by descriptor), which leaves Pᵀ and dSᵀ in
//     exactly the registers that dV += Pᵀ·dO and dK += dSᵀ·Q take as A.
// Each kernel recomputes S and dP (seven products against the minimum five),
// which is what removes the atomics.  A block is one warpgroup per 64 rows (or
// keys) it owns: two in fp32 up to dh 64, sharing the split of each loop tile
// (the CUDA-core work of one warpgroup then runs beside the other's products),
// one otherwise (Cfg).  fp32 at dh 160 (pixtral-12b's training) runs kernels of
// its own, two warpgroups with a role each over the same 64 rows or keys (the
// note above bwd_dq_roles_kernel), and so does bf16 at dh 64, 128 and 160, on
// TMA tensor copies and warp-specialised (the note above struct Bwd).  Elsewhere P
// and dS never go to shared
// memory: the accumulator
// gives a thread columns 2t, 2t+1 of each 8-group where the TF32 A fragment
// wants t, t+4, so the transposed operands (Kᵀ; Qᵀ, dOᵀ) store each 8-group of
// their K dimension in the order 0 2 4 6 1 3 5 7, as the forward's Vᵀ does;
// bf16's k16 fragment matches the accumulator.  TF32 wgmma takes only K-major B,
// so fp32 keeps a transposed split copy of each tile that is a B operand along
// its rows (Kᵀ in the dQ kernel, Qᵀ and dOᵀ in the dK/dV kernel); bf16 keeps one
// copy and reads it MN-major through wgmma's transpose bit.  The tensor cores'
// fp32 sums truncate, so dQ, dK and dV are not one wgmma chain over the whole
// loop (~3000 steps, which put dk and dv ~5e-4 off): each tile's product runs
// in a fresh accumulator that the CUDA cores add to the running sum.  The TF32
// splits use integer ALU operations (cvt.rna's bits, without conversions; at fp32
// dh 160 hopper::split_tf32_fast, whose lo is not rounded).
// The loop's raw tiles (K and V, or Q and dO, each one contiguous run of rows
// of one head) arrive by 1-D bulk async copies into a ring of stages completed
// on mbarriers, so the copy of tile t + 1 overlaps the products of tile t; the
// block splits each arrived tile into the operand layout (hopper.cuh), missing
// rows of a ragged tile as zeros (stale shared memory could hold NaN, and 0 ·
// NaN is NaN).  The operands have one buffer; at fp32 dh 64 the dK/dV kernel
// holds K and V of 128 keys and Q, Qᵀ, dO and dOᵀ of 32 rows, each as hi and
// lo, in 192 KB, and two 16 KB raw stages.  Masks are applied by select, only
// on tiles that cross the band or the end of Sk; a warpgroup skips a tile none
// of its rows (keys) meets; nothing branches between a wgmma's issue and its
// wait.  The heaviest blocks under the causal mask go first (the dQ kernel's
// last query tiles, the dK/dV kernel's first key tiles), and GQA reads KV head
// h / g in place.  lse · log2 e and D are indexed by the accumulator's rows in
// the dQ kernel (two a thread, in registers) and by its columns in the dK/dV
// kernel (read from shared memory).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

#include "error.cuh"
#include "hopper.cuh"
#include "tma.cuh"

namespace {

using hopper::Mma;
using hopper::Op;
using hopper::Src;
using hopper::split_tf32_alu;  // x ≈ hi + lo by integer ALU operations

constexpr int kWgRows = 64;       // rows of one wgmma's M: query rows (dQ) or keys (dK/dV)
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have on an H100
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int DH>
struct Cfg {
  static constexpr bool kSplit = std::is_same<T, float>::value;  // fp32: hi + lo
  static constexpr Op kOp = kSplit ? Op::kTf32 : Op::kBf16;
  static constexpr int kParts = kSplit ? 2 : 1;
  static constexpr int kE = static_cast<int>(sizeof(T));  // operand bytes: tf32 4, bf16 2
  static constexpr int kEPC = 16 / kE;                    // elements per 16-byte chunk
  static constexpr int kCPR = DH / kEPC;                  // chunks per row
  static constexpr int kKStep = 32 / kE;                  // k of one wgmma
  // A fragment registers a thread for K = KD: tf32 4 per k8, bf16 4 per k16
  template <int KD>
  __host__ __device__ static constexpr int frag_regs() { return kSplit ? KD / 2 : KD / 4; }
  // fp32 up to dh 64: two warpgroups a block, each owning 64 of the block's
  // query rows (dQ) or keys (dK/dV) and sharing the split of each loop tile, so
  // that the CUDA-core work of one hides behind the other's products.  fp32 at
  // dh 128, whose 64-row operands alone take 128 KB, and bf16 (dh 16 and 32
  // here), whose blocks are small enough to run several to an SM and whose
  // two-warpgroup kernels took more registers (fewer warps an SM, and spills at
  // dh 128), take one.  The
  // loop tile (keys a step of the dQ kernel, query rows a step of the dK/dV
  // kernel) is as large as fits in 227 KB.
  // fp32 at dh 160 (kRoles) runs the kernels of their own below
  // (bwd_dq_roles_kernel, bwd_dkdv_roles_kernel): 64 rows (keys) a block, two
  // warpgroups with a role each, the block operands raw in the A-fragment
  // order of hopper.cuh (the dQ kernel's Q in role 0's registers), loop tiles
  // of 32 keys (dQ) and 16 query rows (dK/dV).
  static constexpr bool kRoles = kSplit && DH == 160;
  static constexpr int kWG = (kSplit && DH <= 64) || kRoles ? 2 : 1;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kRows = kRoles ? kWgRows : kWgRows * kWG;
  static constexpr int kTile = kRoles ? 16 : !kSplit || DH <= 32 ? 64 : DH == 64 ? 32 : 16;
  static constexpr int kBlockPart = kRows * DH * kE;  // one part of a block operand
  static constexpr int kTilePart = kTile * DH * kE;   // one part of a loop-tile operand
  // operands of a loop tile: dQ: K, V (+ Kᵀ in fp32); dK/dV: Q, dO (+ Qᵀ, dOᵀ in fp32)
  static constexpr int kTileOps = kSplit ? 3 : 2;
  static constexpr int kTileOpsDkdv = kSplit ? 4 : 2;
  static constexpr int smem(int tile_ops, int stages) {
    return 2 * kParts * kBlockPart + tile_ops * kParts * kTilePart + stages * 2 * kTilePart +
           2 * 4 * kRows + 8 * stages;  // + lse · log2 e and D of ≤ kRows rows, barriers
  }
  // kRoles: `blocks` raw block operands, loop tiles of `tile` rows, and the
  // roles' exchange of P
  static constexpr int kTileDq = kRoles ? 32 : kTile;
  static constexpr int smem_roles(int blocks, int tile, int tile_ops, int stages) {
    return blocks * kBlockPart + (tile_ops * kParts + stages * 2) * tile * DH * kE +
           4 * kWgRows * tile + 2 * 4 * kRows + 8 * stages;
  }
  static constexpr int smem_dq(int stages) {
    return kRoles ? smem_roles(1, kTileDq, kTileOps, stages) : smem(kTileOps, stages);
  }
  static constexpr int smem_dkdv(int stages) {
    return kRoles ? smem_roles(2, kTile, kTileOpsDkdv, stages) : smem(kTileOpsDkdv, stages);
  }
  // two raw stages where they fit, else one
  static constexpr int kStagesDq = smem_dq(2) <= kSmemMax ? 2 : 1;
  static constexpr int kStagesDkdv = smem_dkdv(2) <= kSmemMax ? 2 : 1;
  static constexpr int kSmemDq = smem_dq(kStagesDq);
  static constexpr int kSmemDkdv = smem_dkdv(kStagesDkdv);
  static_assert(kSmemDq <= kSmemMax && kSmemDkdv <= kSmemMax, "shared memory");
};

// x ≈ hi + lo by split_tf32_alu, or with kFast (the kernels of Cfg::kRoles) by
// hopper::split_tf32_fast
template <bool kFast>
__device__ __forceinline__ void split_x(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kFast) hopper::split_tf32_fast(x, hi, lo);
  else split_tf32_alu(x, hi, lo);
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

// Rows [0, R) of a row-major [·, DH] tile → a K-major operand of R rows (DH
// along K); rows ≥ nvalid become 0.  Each group of 8 threads takes 8 rows and 8
// distinct chunks, so neither its reads nor its writes share a bank.  kGlobal:
// the tile is in device memory, where rows ≥ nvalid may not be read; in shared
// memory they are read and dropped.
template <typename T, int DH, int R, bool kGlobal, bool kFast = false>
__device__ __forceinline__ void put_rows(const T* raw, unsigned char* hi, unsigned char* lo,
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
    put_chunk<T, kFast>(hi, lo, hopper::chunk_offset(R, r, c), x);
  }
}

// The raw fp32 [R, DH] tile in shared memory → its transpose as a K-major
// operand (DH rows, the R raw rows along K), each 8-group of raw rows stored as
// 0 2 4 6 | 1 3 5 7: the order in which a thread's accumulator values sit in the
// TF32 A fragment.  Raw rows ≥ nvalid become 0.
template <int DH, int R, bool kFast = false>
__device__ __forceinline__ void put_cols(const float* raw, unsigned char* hi, unsigned char* lo,
                                         int nvalid) {
  constexpr int NKC = R / 4, N = DH * NKC, NT = Cfg<float, DH>::kThreads;  // chunks along K
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(raw);
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int q = it * NT + static_cast<int>(threadIdx.x);
    if (N % NT != 0 && q >= N) break;
    const int d = q % DH, kc = q / DH;
    union {
      uint4 u;
      uint32_t v[4];
    } x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * (kc >> 1) + 2 * e + (kc & 1);
      const uint32_t y = bits[row * DH + d];
      x.v[e] = row < nvalid ? y : 0u;
    }
    put_chunk<float, kFast>(hi, lo, hopper::chunk_offset(DH, d, kc), x.u);
  }
}

// An accumulator of N columns (N / 2 values a thread: acc[4i + 2h + e] is row
// r0 + 8h, column 8i + 2·tig + e) → the A fragments of the product that takes it
// with its columns along K.  TF32 (k8 steps): (r0, slot tig) = column 2·tig,
// (r0 + 8, tig), (r0, tig + 4) = column 2·tig + 1, (r0 + 8, tig + 4), each split
// into hi and lo; bf16 (k16 steps): pairs (r0, 2·tig), (r0 + 8, 2·tig), (r0, 2·tig
// + 8), (r0 + 8, 2·tig + 8).
template <typename T, int N, bool kFast = false>
__device__ __forceinline__ void to_frags(const float* acc, uint32_t* hi, uint32_t* lo) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      split_x<kFast>(acc[4 * i + 0], hi[4 * i + 0], lo[4 * i + 0]);
      split_x<kFast>(acc[4 * i + 2], hi[4 * i + 1], lo[4 * i + 1]);
      split_x<kFast>(acc[4 * i + 1], hi[4 * i + 2], lo[4 * i + 2]);
      split_x<kFast>(acc[4 * i + 3], hi[4 * i + 3], lo[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int src = 8 * i + 4 * (j >> 1) + 2 * (j & 1);
        __nv_bfloat162 pr = __floats2bfloat162_rn(acc[src], acc[src + 1]);
        hi[4 * i + j] = *reinterpret_cast<uint32_t*>(&pr);
      }
  }
}

// d = A · Bᵀ over K = DH for 64 rows of A (rows [0, 64) at `a` of a K-major
// operand of `a_rows` rows) and N rows of B (a K-major operand of N rows at
// `b`); fp32 as lo·hi + hi·lo + hi·hi.  Issued, not waited for.
template <typename T, int DH, int N>
__device__ __forceinline__ void product_ss(float* d, const unsigned char* a, int a_rows,
                                           int a_part, const unsigned char* b, int b_part) {
  using C = Cfg<T, DH>;
  constexpr int STEPS = DH / C::kKStep;
  const uint64_t a_hi = hopper::make_desc(a, a_rows * 16, 128);
  const uint64_t b_hi = hopper::make_desc(b, N * 16, 128);
  if constexpr (C::kSplit) {
    const uint64_t a_lo = a_hi + (a_part >> 4), b_lo = b_hi + (b_part >> 4);
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
      Mma<C::kOp, Src::kSS, N>::run(d, a_lo + i * (2 * a_rows), b_hi + i * (2 * N), i > 0);
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
      Mma<C::kOp, Src::kSS, N>::run(d, a_hi + i * (2 * a_rows), b_lo + i * (2 * N), 1);
  }
#pragma unroll
  for (int i = 0; i < STEPS; ++i)
    Mma<C::kOp, Src::kSS, N>::run(d, a_hi + i * (2 * a_rows), b_hi + i * (2 * N),
                                  C::kSplit || i > 0);
}

// acc += A · B over K = KD: A from the fragments of to_frags<T, KD>, B [KD × DH].
// fp32: B is the transposed operand of put_cols (DH rows, KD along K); bf16: B
// is the K-major operand of put_rows (KD rows, DH along K) read MN-major.  The
// product runs in a fresh wgmma accumulator, NC ≤ 64 columns at a time (32 at
// dh 160, which 64 does not divide), which the CUDA cores then add to acc: no
// tensor-core chain outlives one tile.  (The
// tensor cores' fp32 sums truncate; one chain over all of a 2048-row group,
// ~3000 steps, put dk and dv ~5e-4 off, past the fp32 tolerance.)
template <typename T, int DH, int KD>
__device__ __forceinline__ void accumulate_rs(float* acc, const uint32_t* a_hi,
                                              const uint32_t* a_lo, const unsigned char* b,
                                              int b_part) {
  using C = Cfg<T, DH>;
  constexpr int STEPS = KD / C::kKStep, NC = DH < 64 ? DH : DH % 64 == 0 ? 64 : 32;
#pragma unroll
  for (int c = 0; c < DH / NC; ++c) {
    float part[NC / 2];
    hopper::wgmma_fence();
    if constexpr (C::kSplit) {
      const uint64_t b_hi = hopper::make_desc(b, DH * 16, 128) + c * NC;
      const uint64_t b_lo = b_hi + (b_part >> 4);
#pragma unroll
      for (int i = 0; i < STEPS; ++i)
        Mma<Op::kTf32, Src::kRS, NC>::run(part, a_lo + 4 * i, b_hi + i * (2 * DH), i > 0);
#pragma unroll
      for (int i = 0; i < STEPS; ++i)
        Mma<Op::kTf32, Src::kRS, NC>::run(part, a_hi + 4 * i, b_lo + i * (2 * DH), 1);
#pragma unroll
      for (int i = 0; i < STEPS; ++i)
        Mma<Op::kTf32, Src::kRS, NC>::run(part, a_hi + 4 * i, b_hi + i * (2 * DH), 1);
    } else {
      // MN-major: 8 rows of K are 128 bytes apart, 8 columns of N KD · 16 bytes
      const uint64_t b_mn = hopper::make_desc(b, 128, KD * 16) + c * (NC / 8) * KD;
#pragma unroll
      for (int i = 0; i < STEPS; ++i)
        Mma<Op::kBf16, Src::kRST, NC>::run(part, a_hi + 4 * i, b_mn + i * 16, i > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(part);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[c * (NC / 2) + i] += part[i];
  }
}

__device__ __forceinline__ bool visible(long long qpos, long long kpos, long long sk,
                                        int causal, long long window) {
  return kpos < sk && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Σ over one 16-byte chunk of x ∘ y in fp32, added to `sum` in element order.
template <typename T>
__device__ __forceinline__ float dot_chunk(uint4 x, uint4 y, float sum) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      sum = fmaf(__uint_as_float(xs[i]), __uint_as_float(ys[i]), sum);
    } else {  // a bf16 is the high half of its fp32, low half first
      sum = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16), sum);
      sum = fmaf(__uint_as_float(xs[i] & 0xffff0000u), __uint_as_float(ys[i] & 0xffff0000u),
                 sum);
    }
  }
  return sum;
}

// The row mapping of the accumulators: this thread's warpgroup wg (of WG), its
// rows r0 and r0 + 8 of the warpgroup's 64, and its column group tig.
template <int WG>
struct Lane {
  int wg, r0, tig;
  __device__ Lane() {
    const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
    wg = WG == 1 ? 0 : tid >> 7;
    r0 = warp * 16 + (lane >> 2);
    tig = lane & 3;
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH>::kThreads, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ o, const float* __restrict__ lse,
              const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ delta,
              int hq, int g, long long sq, long long sk, float scale, int causal,
              long long window, long long q_offset) {
  using C = Cfg<T, DH>;
  constexpr int R = C::kRows, BK = C::kTile, S = C::kStagesDq, NS = BK / 2, NO = DH / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;                                   // [Q parts]
  unsigned char* dos = qs + C::kParts * C::kBlockPart;         // [dO parts]
  unsigned char* ks = dos + C::kParts * C::kBlockPart;         // [K parts][V parts][Kᵀ parts]
  unsigned char* vs = ks + C::kParts * C::kTilePart;
  unsigned char* kts = vs + C::kParts * C::kTilePart;
  unsigned char* raw = ks + C::kTileOps * C::kParts * C::kTilePart;  // [stage][K, V]
  float* lse2s = reinterpret_cast<float*>(raw + S * 2 * C::kTilePart);  // the rows' lse · log2 e
  float* drow = lse2s + R;                                              // the rows' D
  uint64_t* full = reinterpret_cast<uint64_t*>(drow + R);

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x, b = bh / hq;
  const long long kvh = b * (hq / g) + (bh % hq) / g;
  // the last query tiles see the most keys under the causal mask: they go first
  const long long q0 = (static_cast<long long>(gridDim.y) - 1 - blockIdx.y) * R;
  const int nq = static_cast<int>(min(static_cast<long long>(R), sq - q0));
  const long long row0 = bh * sq + q0;  // the block's first row of [B · Hq · Sq]
  const T* kp = k + kvh * sk * DH;
  const T* vp = v + kvh * sk * DH;

  // the key tiles that some row of the block may see: [t0, t0 + BK · n_tiles)
  long long k_lo = 0, k_hi = sk;
  if (causal) k_hi = min(k_hi, q0 + nq + q_offset);
  if (window > 0) k_lo = max(k_lo, q0 + q_offset - window + 1);
  const long long t0 = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_lo ? static_cast<int>((k_hi - t0 + BK - 1) / BK) : 0;

  auto issue = [&](int t, int stage) {  // thread 0: bulk-copy K and V tile t into a raw stage
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    const uint32_t bytes =
        static_cast<uint32_t>(min(static_cast<long long>(BK), sk - k0)) * DH * C::kE;
    unsigned char* dst = raw + stage * 2 * C::kTilePart;
    hopper::mbar_expect_tx(&full[stage], 2 * bytes);
    hopper::bulk_load(dst, kp + k0 * DH, bytes, &full[stage]);
    hopper::bulk_load(dst + C::kTilePart, vp + k0 * DH, bytes, &full[stage]);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(S, n_tiles); ++t) issue(t, t);
  put_rows<T, DH, R, true>(q + row0 * DH, qs, qs + C::kBlockPart, nq);
  put_rows<T, DH, R, true>(dout + row0 * DH, dos, dos + C::kBlockPart, nq);
  {  // D = rowsum(dO ∘ O): two threads a row, half the columns each
    const int r = tid >> 1, half = tid & 1;
    float sum = 0.0f;
    if (r < nq) {
      const T* dr = dout + (row0 + r) * DH + half * (DH / 2);
      const T* orow = o + (row0 + r) * DH + half * (DH / 2);
#pragma unroll
      for (int c = 0; c < DH / 2; c += C::kEPC)
        sum = dot_chunk<T>(__ldg(reinterpret_cast<const uint4*>(dr + c)),
                           __ldg(reinterpret_cast<const uint4*>(orow + c)), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      drow[r] = sum;
      if (r < nq) delta[row0 + r] = sum;
    } else {
      lse2s[r] = r < nq ? lse[row0 + r] * kLog2e : 0.0f;
    }
  }
  __syncthreads();
  // this warpgroup's rows: [wq0, wq0 + 64) of the block, at positions qa_lo … qa_hi
  const Lane<C::kWG> ln;
  const int wq0 = ln.wg * kWgRows;
  const float lse2[2] = {lse2s[wq0 + ln.r0], lse2s[wq0 + ln.r0 + 8]};
  const float drw[2] = {drow[wq0 + ln.r0], drow[wq0 + ln.r0 + 8]};
  const bool rows = wq0 < nq;
  const long long qa_lo = q0 + wq0 + q_offset;
  const long long qa_hi = q0 + min(wq0 + kWgRows, nq) - 1 + q_offset;
  const float scale_log2 = scale * kLog2e;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    const int nk = static_cast<int>(min(static_cast<long long>(BK), sk - k0));
    hopper::mbar_wait(&full[t % S], (t / S) & 1);
    const T* rk = reinterpret_cast<const T*>(raw + (t % S) * 2 * C::kTilePart);
    put_rows<T, DH, BK, false>(rk, ks, ks + C::kTilePart, nk);
    put_rows<T, DH, BK, false>(rk + BK * DH, vs, vs + C::kTilePart, nk);
    if constexpr (C::kSplit)
      put_cols<DH, BK>(reinterpret_cast<const float*>(rk), kts, kts + C::kTilePart, nk);
    hopper::fence_proxy_async();
    __syncthreads();  // the operands are ready and the raw stage is free
    if (tid == 0 && t + S < n_tiles) {
      hopper::fence_proxy_async();
      issue(t + S, t % S);
    }

    // does some row of this warpgroup see a key of this tile?  (With one
    // warpgroup, always: the tiles are the block's.)
    const bool active = C::kWG == 1 || (rows && !(causal && k0 > qa_hi) &&
                                        !(window > 0 && k0 + BK - 1 <= qa_lo - window));
    if (active) {
      // S = Q · Kᵀ and dP = dO · Vᵀ
      float s[NS], dp[NS];
      hopper::wgmma_fence();
      product_ss<T, DH, BK>(s, qs + wq0 * 16, R, C::kBlockPart, ks, C::kTilePart);
      product_ss<T, DH, BK>(dp, dos + wq0 * 16, R, C::kBlockPart, vs, C::kTilePart);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P and dS = P ∘ (dP − D); s[4i + 2h + e] is row r0 + 8h, key k0 + 8i + 2·tig + e
      const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > qa_lo) ||
                          (window > 0 && k0 <= qa_hi - window);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long qpos = qa_lo + ln.r0 + 8 * h;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * h + e;
            float p = hopper::exp2_approx(fmaf(s[x], scale_log2, -lse2[h]));
            if (masked)
              p = visible(qpos, k0 + 8 * i + 2 * ln.tig + e, sk, causal, window) ? p : 0.0f;
            dp[x] = p * (dp[x] - drw[h]);
          }
      }

      // dQ += dS · K, dS from registers
      constexpr int NF = C::template frag_regs<BK>();
      uint32_t f_hi[NF], f_lo[C::kSplit ? NF : 1];
      to_frags<T, BK>(dp, f_hi, f_lo);
      accumulate_rs<T, DH, BK>(acc, f_hi, f_lo, C::kSplit ? kts : ks, C::kTilePart);
      hopper::fence_regs(f_hi);
      hopper::fence_regs(f_lo);
    }
    __syncthreads();  // the operands are free for tile t + 1
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wq0 + ln.r0 + 8 * h;
    if (r >= nq) continue;
    T* out = dq + (row0 + r) * DH + 2 * ln.tig;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      store2(out + 8 * i, acc[4 * i + 2 * h] * scale, acc[4 * i + 2 * h + 1] * scale);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH>::kThreads, 1)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ lse, const T* __restrict__ dout,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                int hq, int g, long long sq, long long sk, float scale, int causal,
                long long window, long long q_offset) {
  using C = Cfg<T, DH>;
  constexpr int R = C::kRows, BQ = C::kTile, S = C::kStagesDkdv, NS = BQ / 2, NO = DH / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;                                    // [K parts]
  unsigned char* vs = ks + C::kParts * C::kBlockPart;          // [V parts]
  unsigned char* qs = vs + C::kParts * C::kBlockPart;          // [Q][dO][Qᵀ][dOᵀ], parts each
  unsigned char* dos = qs + C::kParts * C::kTilePart;
  unsigned char* qts = dos + C::kParts * C::kTilePart;
  unsigned char* dots = qts + C::kParts * C::kTilePart;
  unsigned char* raw = qs + C::kTileOpsDkdv * C::kParts * C::kTilePart;  // [stage][Q, dO]
  float* lse2s = reinterpret_cast<float*>(raw + S * 2 * C::kTilePart);  // the tile's lse · log2 e
  float* drow = lse2s + BQ;                                             // the tile's D
  uint64_t* full = reinterpret_cast<uint64_t*>(drow + BQ);

  const int tid = threadIdx.x;
  const long long bkv = blockIdx.x;  // b · Hkv + KV head
  const long long hkv = hq / g, b = bkv / hkv;
  const long long h0 = b * hq + (bkv % hkv) * g;  // b · Hq + the group's first q head
  // the first key tiles are seen by the most rows under the causal mask: they go first
  const long long k0 = static_cast<long long>(blockIdx.y) * R;
  const int nk = static_cast<int>(min(static_cast<long long>(R), sk - k0));

  // the query tiles that see some key of the block, for each of the g heads
  long long i_lo = 0, i_hi = sq;
  if (causal) i_lo = max(i_lo, k0 - q_offset);
  if (window > 0) i_hi = min(i_hi, k0 + nk - 1 + window - q_offset);
  const long long qt0 = (i_lo / BQ) * BQ;
  const int n_qt = i_hi > i_lo ? static_cast<int>((i_hi - qt0 + BQ - 1) / BQ) : 0;
  const int n_tiles = g * n_qt;
  auto tile_q0 = [&](int t) { return qt0 + static_cast<long long>(t % n_qt) * BQ; };
  auto tile_row0 = [&](int t) { return (h0 + t / n_qt) * sq + tile_q0(t); };

  auto issue = [&](int t, int stage) {  // thread 0: bulk-copy Q and dO tile t into a raw stage
    const uint32_t bytes =
        static_cast<uint32_t>(min(static_cast<long long>(BQ), sq - tile_q0(t))) * DH * C::kE;
    const long long row0 = tile_row0(t);
    unsigned char* dst = raw + stage * 2 * C::kTilePart;
    hopper::mbar_expect_tx(&full[stage], 2 * bytes);
    hopper::bulk_load(dst, q + row0 * DH, bytes, &full[stage]);
    hopper::bulk_load(dst + C::kTilePart, dout + row0 * DH, bytes, &full[stage]);
  };
  // threads < BQ: tile t's lse · log2 e and D for one row (0 past Sq)
  float lse_next = 0.0f, d_next = 0.0f;
  auto prefetch = [&](int t) {
    if (tid < BQ && t < n_tiles && tile_q0(t) + tid < sq) {
      lse_next = lse[tile_row0(t) + tid] * kLog2e;
      d_next = delta[tile_row0(t) + tid];
    } else {
      lse_next = d_next = 0.0f;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(S, n_tiles); ++t) issue(t, t);
  put_rows<T, DH, R, true>(k + (bkv * sk + k0) * DH, ks, ks + C::kBlockPart, nk);
  put_rows<T, DH, R, true>(v + (bkv * sk + k0) * DH, vs, vs + C::kBlockPart, nk);
  prefetch(0);

  // this warpgroup's keys: [wk0, wk0 + 64) of the block
  const Lane<C::kWG> ln;
  const int wk0 = ln.wg * kWgRows;
  const long long kw = k0 + wk0;  // the first key's position
  const float scale_log2 = scale * kLog2e;
  float acc_k[NO], acc_v[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc_k[i] = acc_v[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const long long q0 = tile_q0(t);
    const int nq = static_cast<int>(min(static_cast<long long>(BQ), sq - q0));
    hopper::mbar_wait(&full[t % S], (t / S) & 1);
    const T* rq = reinterpret_cast<const T*>(raw + (t % S) * 2 * C::kTilePart);
    put_rows<T, DH, BQ, false>(rq, qs, qs + C::kTilePart, nq);
    put_rows<T, DH, BQ, false>(rq + BQ * DH, dos, dos + C::kTilePart, nq);
    if constexpr (C::kSplit) {
      put_cols<DH, BQ>(reinterpret_cast<const float*>(rq), qts, qts + C::kTilePart, nq);
      put_cols<DH, BQ>(reinterpret_cast<const float*>(rq) + BQ * DH, dots,
                       dots + C::kTilePart, nq);
    }
    if (tid < BQ) {
      lse2s[tid] = lse_next;
      drow[tid] = d_next;
    }
    hopper::fence_proxy_async();
    __syncthreads();  // the operands are ready and the raw stage is free
    if (tid == 0 && t + S < n_tiles) {
      hopper::fence_proxy_async();
      issue(t + S, t % S);
    }
    prefetch(t + 1);

    // does a row of the tile see some key of this warpgroup?  (With one
    // warpgroup, always: the tiles are the block's.)
    const bool active =
        C::kWG == 1 || (wk0 < nk && !(causal && kw > q0 + BQ - 1 + q_offset) &&
                        !(window > 0 && kw + kWgRows - 1 <= q0 + q_offset - window));
    if (active) {
      // Sᵀ = K · Qᵀ and dPᵀ = V · dOᵀ (keys as M)
      float s[NS], dp[NS];
      hopper::wgmma_fence();
      product_ss<T, DH, BQ>(s, ks + wk0 * 16, R, C::kBlockPart, qs, C::kTilePart);
      product_ss<T, DH, BQ>(dp, vs + wk0 * 16, R, C::kBlockPart, dos, C::kTilePart);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // Pᵀ and dSᵀ; s[4i + 2h + e] is key kw + r0 + 8h, query row q0 + 8i + 2·tig + e
      const bool masked = kw + kWgRows > sk || (causal && kw + kWgRows - 1 > q0 + q_offset) ||
                          (window > 0 && kw <= q0 + BQ - 1 + q_offset - window);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int c = 8 * i + 2 * ln.tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2s + c);
        const float2 dd = *reinterpret_cast<const float2*>(drow + c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * h + e;
            float p = hopper::exp2_approx(fmaf(s[x], scale_log2, -(e ? l2.y : l2.x)));
            if (masked)
              p = visible(q0 + c + e + q_offset, kw + ln.r0 + 8 * h, sk, causal, window) ? p
                                                                                        : 0.0f;
            s[x] = p;
            dp[x] = p * (dp[x] - (e ? dd.y : dd.x));
          }
      }

      // dV += Pᵀ · dO, then dK += dSᵀ · Q, Pᵀ and dSᵀ from registers.  fp32
      // fragments take twice the registers of the values: dSᵀ's are formed
      // only once Pᵀ's are done with.
      constexpr int NF = C::template frag_regs<BQ>();
      uint32_t p_hi[NF], p_lo[C::kSplit ? NF : 1], ds_hi[NF], ds_lo[C::kSplit ? NF : 1];
      to_frags<T, BQ>(s, p_hi, p_lo);
      accumulate_rs<T, DH, BQ>(acc_v, p_hi, p_lo, C::kSplit ? dots : dos, C::kTilePart);
      if constexpr (C::kSplit) hopper::fence_regs(dp);
      to_frags<T, BQ>(dp, ds_hi, ds_lo);
      accumulate_rs<T, DH, BQ>(acc_k, ds_hi, ds_lo, C::kSplit ? qts : qs, C::kTilePart);
      hopper::fence_regs(p_hi);
      hopper::fence_regs(p_lo);
      hopper::fence_regs(ds_hi);
      hopper::fence_regs(ds_lo);
    }
    __syncthreads();  // the operands and the tile's lse and D are free for tile t + 1
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wk0 + ln.r0 + 8 * h;
    if (r >= nk) continue;
    T* outk = dk + (bkv * sk + k0 + r) * DH + 2 * ln.tig;
    T* outv = dv + (bkv * sk + k0 + r) * DH + 2 * ln.tig;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      store2(outk + 8 * i, acc_k[4 * i + 2 * h] * scale, acc_k[4 * i + 2 * h + 1] * scale);
      store2(outv + 8 * i, acc_v[4 * i + 2 * h], acc_v[4 * i + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------- fp32 at dh 160
// The two kernels of Cfg::kRoles (pixtral-12b's training: B 2, 32/8 heads, S
// 2,304).  At dh 160 the 64-row block operands as hi and lo (Q and dO, or K
// and V) take 163,840 B, which left room for 8-row loop tiles only: N = 8
// products and two barriers every 8 keys.  Here a block is two warpgroups that
// own the same 64 query rows (dQ) or keys (dK/dV), one role each.  Role 0 runs
// S = Q·Kᵀ (Sᵀ = K·Qᵀ) and P; role 1 runs dP = dO·Vᵀ (dPᵀ = V·dOᵀ), takes P
// through shared memory (thread t of one role holds the same accumulator
// entries as thread t of the other), and forms dS.  The dQ kernel's role 1 then
// owns dQ += dS·K; in the dK/dV kernel role 0 owns dV += Pᵀ·dO and role 1 dK +=
// dSᵀ·Q, so that each thread holds one 64 × 160 sum (80 registers; both would
// take 160).  One role's exp, dS and adds run beside the other's products.
// Each block operand is the A of one product only, and wgmma may read A from
// registers, so it stays raw in the A-fragment order of hopper.cuh, half the
// bytes of hi and lo, and is split in registers per group of k steps
// (hopper::product_frag) with hopper::split_tf32_fast,
// as are the loop tiles and the fragments of P and dS.
//   dQ kernel: role 0 keeps Q's raw fragments in its registers (product_regs;
//   the roles run loops of their own, so Q's 80 registers and role 1's dQ sums
//   are the same registers), which leaves room for 32-key loop tiles: dO
//   40,960 + K, V and Kᵀ hi and lo 122,880 + one raw K/V stage 40,960 + P
//   8,192 + the rows' lse and D 512 + 8 = 213,512 B; ptxas -v 244 registers.
//   dK/dV kernel: K and V 81,920 + Q, dO, Qᵀ and dOᵀ hi and lo of 16 query
//   rows 81,920 + two raw stages 40,960 + P 4,096 + 528 = 209,424 B; 226
//   registers.  32-row tiles would take 245,760 B, and K or V in registers
//   would sit beside a role's dK or dV sums.
// No spills.  The loop tile's split runs on all 256 threads between two
// barriers, beside no product.  Times against the bound: PERF.md §6.

// x[4i + 2h + e] ↔ float4 i / 2 of this thread's slots in the exchange buffer
template <int NS>
__device__ __forceinline__ void put_exchange(float* xs, const float (&x)[NS]) {
  float4* xt = reinterpret_cast<float4*>(xs) + (threadIdx.x & 127);
#pragma unroll
  for (int c = 0; c < NS / 4; ++c)
    xt[c * 128] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
}
template <int NS>
__device__ __forceinline__ void get_exchange(const float* xs, float (&x)[NS]) {
  const float4* xt = reinterpret_cast<const float4*>(xs) + (threadIdx.x & 127);
#pragma unroll
  for (int c = 0; c < NS / 4; ++c) {
    const float4 y = xt[c * 128];
    x[4 * c] = y.x;
    x[4 * c + 1] = y.y;
    x[4 * c + 2] = y.z;
    x[4 * c + 3] = y.w;
  }
}

// acc += A · B over K = KD in split TF32: A from the fragments of to_frags<float,
// KD>, B the transposed operand of put_cols (DH rows, KD along K).  As
// accumulate_rs, each chunk of NC columns runs in a fresh accumulator that the
// CUDA cores add to acc; here chunk c + 1 is issued before chunk c is waited for
// and added (two chunk accumulators), so the adds overlap the products.
template <int DH, int KD, int NC>
__device__ __forceinline__ void accumulate_frag(float (&acc)[DH / 2], const uint32_t* a_hi,
                                                const uint32_t* a_lo, const unsigned char* b,
                                                int b_part) {
  constexpr int STEPS = KD / 8, NCH = DH / NC;
  const uint64_t b0 = hopper::make_desc(b, DH * 16, 128);
  float part[2][NC / 2];
  auto issue = [&](int c, float(&d)[NC / 2]) {
    const uint64_t b_hi = b0 + c * NC, b_lo = b_hi + (b_part >> 4);
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
      Mma<Op::kTf32, Src::kRS, NC>::run(d, a_lo + 4 * i, b_hi + i * (2 * DH), i > 0);
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
      Mma<Op::kTf32, Src::kRS, NC>::run(d, a_hi + 4 * i, b_lo + i * (2 * DH), 1);
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
      Mma<Op::kTf32, Src::kRS, NC>::run(d, a_hi + 4 * i, b_hi + i * (2 * DH), 1);
    hopper::wgmma_commit();
  };
  issue(0, part[0]);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c + 1 < NCH) {
      issue(c + 1, part[(c + 1) & 1]);
      hopper::wgmma_wait<1>();
    } else {
      hopper::wgmma_wait<0>();
    }
    hopper::fence_regs(part[c & 1]);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[c * (NC / 2) + i] += part[c & 1][i];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(256, 1)
bwd_dq_roles_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const float* __restrict__ lse,
                    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ delta,
                    int hq, int g, long long sq, long long sk, float scale, int causal,
                    long long window, long long q_offset) {
  using C = Cfg<T, DH>;
  static_assert(C::kRoles && C::kOp == Op::kTf32, "the role-split kernels are fp32 at dh 160");
  constexpr int R = kWgRows, BK = C::kTileDq, S = C::kStagesDq, NS = BK / 2, NO = DH / 2;
  constexpr int kPart = BK * DH * C::kE;  // one part of a loop-tile operand
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* dof = smem;                // dO, raw in A-fragment order: role 1's A
  unsigned char* ks = dof + C::kBlockPart;  // [K parts][V parts][Kᵀ parts]
  unsigned char* vs = ks + C::kParts * kPart;
  unsigned char* kts = vs + C::kParts * kPart;
  unsigned char* raw = ks + C::kTileOps * C::kParts * kPart;          // [stage][K, V]
  float* xs = reinterpret_cast<float*>(raw + S * 2 * kPart);         // P of the tile
  float* lse2s = xs + R * BK;                                         // the rows' lse · log2 e
  float* drow = lse2s + R;                                            // the rows' D
  uint64_t* full = reinterpret_cast<uint64_t*>(drow + R);

  const int tid = threadIdx.x, role = tid >> 7;
  const long long bh = blockIdx.x, b = bh / hq;
  const long long kvh = b * (hq / g) + (bh % hq) / g;
  // the last query tiles see the most keys under the causal mask: they go first
  const long long q0 = (static_cast<long long>(gridDim.y) - 1 - blockIdx.y) * R;
  const int nq = static_cast<int>(min(static_cast<long long>(R), sq - q0));
  const long long row0 = bh * sq + q0;  // the block's first row of [B · Hq · Sq]
  const T* kp = k + kvh * sk * DH;
  const T* vp = v + kvh * sk * DH;

  // the key tiles that some row of the block may see: [t0, t0 + BK · n_tiles)
  long long k_lo = 0, k_hi = sk;
  if (causal) k_hi = min(k_hi, q0 + nq + q_offset);
  if (window > 0) k_lo = max(k_lo, q0 + q_offset - window + 1);
  const long long t0 = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_lo ? static_cast<int>((k_hi - t0 + BK - 1) / BK) : 0;

  auto issue = [&](int t, int stage) {  // thread 0: bulk-copy K and V tile t into a raw stage
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    const uint32_t bytes =
        static_cast<uint32_t>(min(static_cast<long long>(BK), sk - k0)) * DH * C::kE;
    unsigned char* dst = raw + stage * 2 * kPart;
    hopper::mbar_expect_tx(&full[stage], 2 * bytes);
    hopper::bulk_load(dst, kp + k0 * DH, bytes, &full[stage]);
    hopper::bulk_load(dst + kPart, vp + k0 * DH, bytes, &full[stage]);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(S, n_tiles); ++t) issue(t, t);
  if (role == 1) hopper::load_frags<DH>(dout + row0 * DH, nq, dof, tid & 127);
  {  // D = rowsum(dO ∘ O): four threads a row, a quarter of the columns each
    const int r = tid >> 2, part = tid & 3;
    float sum = 0.0f;
    if (r < nq) {
      const T* dr = dout + (row0 + r) * DH + part * (DH / 4);
      const T* orow = o + (row0 + r) * DH + part * (DH / 4);
#pragma unroll
      for (int c = 0; c < DH / 4; c += C::kEPC)
        sum = dot_chunk<T>(__ldg(reinterpret_cast<const uint4*>(dr + c)),
                           __ldg(reinterpret_cast<const uint4*>(orow + c)), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      drow[r] = sum;
      if (r < nq) delta[row0 + r] = sum;
    } else if (part == 1) {
      lse2s[r] = r < nq ? lse[row0 + r] * kLog2e : 0.0f;
    }
  }
  __syncthreads();
  const Lane<2> ln;
  const long long qa_lo = q0 + q_offset, qa_hi = q0 + nq - 1 + q_offset;

  // The roles run loops of their own (so that role 0's Q fragments and role 1's
  // dQ sums take the same registers), meeting at named barriers: kTileReady
  // once a tile's operands are split, kTileDone once it is used, kPReady for P.
  constexpr int kTileReady = 2, kTileDone = 3, kPReady = 1;
  auto start_tile = [&](int t) {  // all threads: tile t's K, V and Kᵀ into the operands
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    const int nk = static_cast<int>(min(static_cast<long long>(BK), sk - k0));
    hopper::mbar_wait(&full[t % S], (t / S) & 1);
    const T* rk = reinterpret_cast<const T*>(raw + (t % S) * 2 * kPart);
    put_rows<T, DH, BK, false, true>(rk, ks, ks + kPart, nk);
    put_rows<T, DH, BK, false, true>(rk + BK * DH, vs, vs + kPart, nk);
    put_cols<DH, BK, true>(rk, kts, kts + kPart, nk);
    hopper::fence_proxy_async();
    hopper::bar_sync(kTileReady, 256);  // the operands are ready and the raw stage is free
    if (tid == 0 && t + S < n_tiles) {
      hopper::fence_proxy_async();
      issue(t + S, t % S);
    }
    return k0;
  };

  if (role == 0) {  // S = Q · Kᵀ and P, to role 1
    uint32_t qa[DH / 2];  // this thread's raw A fragments of Q
    hopper::load_frags_regs<DH>(q + row0 * DH, nq, tid, qa);
    const float lse2[2] = {lse2s[ln.r0], lse2s[ln.r0 + 8]};
    const float scale_log2 = scale * kLog2e;
    for (int t = 0; t < n_tiles; ++t) {
      const long long k0 = start_tile(t);
      // x[4i + 2h + e] is row r0 + 8h, key k0 + 8i + 2·tig + e
      float x[NS];
      hopper::product_regs<DH, BK, 4>(x, qa, ks, kPart);
      const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > qa_lo) ||
                          (window > 0 && k0 <= qa_hi - window);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long qpos = qa_lo + ln.r0 + 8 * h;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * i + 2 * h + e;
            const float p = hopper::exp2_approx(fmaf(x[j], scale_log2, -lse2[h]));
            x[j] = !masked || visible(qpos, k0 + 8 * i + 2 * ln.tig + e, sk, causal, window)
                       ? p
                       : 0.0f;
          }
      }
      put_exchange(xs, x);
      hopper::bar_arrive(kPReady, 256);
      hopper::bar_sync(kTileDone, 256);
    }
    return;
  }

  // role 1: dP = dO · Vᵀ, dS = P ∘ (dP − D), dQ += dS · K with dS from registers
  const float drw[2] = {drow[ln.r0], drow[ln.r0 + 8]};
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    start_tile(t);
    float x[NS], p[NS];
    hopper::product_frag<DH, BK, 2>(x, dof, vs, kPart);
    hopper::bar_sync(kPReady, 256);
    get_exchange(xs, p);
#pragma unroll
    for (int j = 0; j < NS; ++j) x[j] = p[j] * (x[j] - drw[(j >> 1) & 1]);
    constexpr int NF = C::template frag_regs<BK>();
    uint32_t f_hi[NF], f_lo[NF];
    to_frags<T, BK, true>(x, f_hi, f_lo);
    accumulate_frag<DH, BK, 32>(acc, f_hi, f_lo, kts, kPart);
    hopper::fence_regs(f_hi);
    hopper::fence_regs(f_lo);
    hopper::bar_sync(kTileDone, 256);  // the operands and the exchange are free for tile t + 1
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ln.r0 + 8 * h;
    if (r >= nq) continue;
    T* out = dq + (row0 + r) * DH + 2 * ln.tig;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      store2(out + 8 * i, acc[4 * i + 2 * h] * scale, acc[4 * i + 2 * h + 1] * scale);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(256, 1)
bwd_dkdv_roles_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ lse,
                      const T* __restrict__ dout, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int hq, int g, long long sq,
                      long long sk, float scale, int causal, long long window,
                      long long q_offset) {
  using C = Cfg<T, DH>;
  static_assert(C::kRoles && C::kOp == Op::kTf32, "the role-split kernels are fp32 at dh 160");
  constexpr int R = kWgRows, BQ = C::kTile, S = C::kStagesDkdv, NS = BQ / 2, NO = DH / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* kf = smem;                   // K, raw in A-fragment order: role 0's A
  unsigned char* vf = kf + C::kBlockPart;     // V, the same: role 1's A
  unsigned char* qs = vf + C::kBlockPart;     // [Q][dO][Qᵀ][dOᵀ], parts each
  unsigned char* dos = qs + C::kParts * C::kTilePart;
  unsigned char* qts = dos + C::kParts * C::kTilePart;
  unsigned char* dots = qts + C::kParts * C::kTilePart;
  unsigned char* raw = qs + C::kTileOpsDkdv * C::kParts * C::kTilePart;  // [stage][Q, dO]
  float* xs = reinterpret_cast<float*>(raw + S * 2 * C::kTilePart);     // Pᵀ of the tile
  float* lse2s = xs + R * BQ;                                            // the tile's lse · log2 e
  float* drow = lse2s + BQ;                                              // the tile's D
  uint64_t* full = reinterpret_cast<uint64_t*>(drow + BQ);

  const int tid = threadIdx.x, role = tid >> 7;
  const long long bkv = blockIdx.x;  // b · Hkv + KV head
  const long long hkv = hq / g, b = bkv / hkv;
  const long long h0 = b * hq + (bkv % hkv) * g;  // b · Hq + the group's first q head
  // the first key tiles are seen by the most rows under the causal mask: they go first
  const long long k0 = static_cast<long long>(blockIdx.y) * R;
  const int nk = static_cast<int>(min(static_cast<long long>(R), sk - k0));

  // the query tiles that see some key of the block, for each of the g heads
  long long i_lo = 0, i_hi = sq;
  if (causal) i_lo = max(i_lo, k0 - q_offset);
  if (window > 0) i_hi = min(i_hi, k0 + nk - 1 + window - q_offset);
  const long long qt0 = (i_lo / BQ) * BQ;
  const int n_qt = i_hi > i_lo ? static_cast<int>((i_hi - qt0 + BQ - 1) / BQ) : 0;
  const int n_tiles = g * n_qt;
  auto tile_q0 = [&](int t) { return qt0 + static_cast<long long>(t % n_qt) * BQ; };
  auto tile_row0 = [&](int t) { return (h0 + t / n_qt) * sq + tile_q0(t); };

  auto issue = [&](int t, int stage) {  // thread 0: bulk-copy Q and dO tile t into a raw stage
    const uint32_t bytes =
        static_cast<uint32_t>(min(static_cast<long long>(BQ), sq - tile_q0(t))) * DH * C::kE;
    const long long row0 = tile_row0(t);
    unsigned char* dst = raw + stage * 2 * C::kTilePart;
    hopper::mbar_expect_tx(&full[stage], 2 * bytes);
    hopper::bulk_load(dst, q + row0 * DH, bytes, &full[stage]);
    hopper::bulk_load(dst + C::kTilePart, dout + row0 * DH, bytes, &full[stage]);
  };
  // threads < BQ: tile t's lse · log2 e and D for one row (0 past Sq)
  float lse_next = 0.0f, d_next = 0.0f;
  auto prefetch = [&](int t) {
    if (tid < BQ && t < n_tiles && tile_q0(t) + tid < sq) {
      lse_next = lse[tile_row0(t) + tid] * kLog2e;
      d_next = delta[tile_row0(t) + tid];
    } else {
      lse_next = d_next = 0.0f;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(S, n_tiles); ++t) issue(t, t);
  hopper::load_frags<DH>((role ? v : k) + (bkv * sk + k0) * DH, nk, role ? vf : kf, tid & 127);
  prefetch(0);

  const Lane<2> ln;
  const float scale_log2 = scale * kLog2e;
  float acc[NO];  // role 0's dV, role 1's dK
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const long long q0 = tile_q0(t);
    const int nq = static_cast<int>(min(static_cast<long long>(BQ), sq - q0));
    hopper::mbar_wait(&full[t % S], (t / S) & 1);
    const T* rq = reinterpret_cast<const T*>(raw + (t % S) * 2 * C::kTilePart);
    put_rows<T, DH, BQ, false, true>(rq, qs, qs + C::kTilePart, nq);
    put_rows<T, DH, BQ, false, true>(rq + BQ * DH, dos, dos + C::kTilePart, nq);
    put_cols<DH, BQ, true>(rq, qts, qts + C::kTilePart, nq);
    put_cols<DH, BQ, true>(rq + BQ * DH, dots, dots + C::kTilePart, nq);
    if (tid < BQ) {
      lse2s[tid] = lse_next;
      drow[tid] = d_next;
    }
    hopper::fence_proxy_async();
    __syncthreads();  // the operands are ready and the raw stage is free
    if (tid == 0 && t + S < n_tiles) {
      hopper::fence_proxy_async();
      issue(t + S, t % S);
    }
    prefetch(t + 1);

    // role 0: Sᵀ = K · Qᵀ; role 1: dPᵀ = V · dOᵀ (keys as M).  x[4i + 2h + e] is
    // key k0 + r0 + 8h, query row q0 + 8i + 2·tig + e
    float x[NS];
    hopper::product_frag<DH, BQ, 4>(x, role ? vf : kf, role ? dos : qs, C::kTilePart);
    if (role == 0) {  // Pᵀ, to role 1
      const bool masked = k0 + R > sk || (causal && k0 + R - 1 > q0 + q_offset) ||
                          (window > 0 && k0 <= q0 + BQ - 1 + q_offset - window);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int c = 8 * i + 2 * ln.tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2s + c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * i + 2 * h + e;
            const float p = hopper::exp2_approx(fmaf(x[j], scale_log2, -(e ? l2.y : l2.x)));
            x[j] = !masked ||
                           visible(q0 + c + e + q_offset, k0 + ln.r0 + 8 * h, sk, causal, window)
                       ? p
                       : 0.0f;
          }
      }
      put_exchange(xs, x);
      hopper::bar_arrive(1, 256);
    } else {  // dSᵀ = Pᵀ ∘ (dPᵀ − D)
      float p[NS];
      hopper::bar_sync(1, 256);
      get_exchange(xs, p);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 dd = *reinterpret_cast<const float2*>(drow + 8 * i + 2 * ln.tig);
#pragma unroll
        for (int j = 4 * i; j < 4 * i + 4; ++j) x[j] = p[j] * (x[j] - (j & 1 ? dd.y : dd.x));
      }
    }

    // role 0: dV += Pᵀ · dO; role 1: dK += dSᵀ · Q; the A from registers
    constexpr int NF = C::template frag_regs<BQ>();
    uint32_t f_hi[NF], f_lo[NF];
    to_frags<T, BQ, true>(x, f_hi, f_lo);
    accumulate_frag<DH, BQ, 32>(acc, f_hi, f_lo, role ? qts : dots, C::kTilePart);
    hopper::fence_regs(f_hi);
    hopper::fence_regs(f_lo);
    __syncthreads();  // the operands, the exchange and the tile's lse and D are free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ln.r0 + 8 * h;
    if (r >= nk) continue;
    T* out = (role ? dk : dv) + (bkv * sk + k0 + r) * DH + 2 * ln.tig;
    const float f = role ? scale : 1.0f;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      store2(out + 8 * i, acc[4 * i + 2 * h] * f, acc[4 * i + 2 * h + 1] * f);
  }
}

// the dQ and dK/dV kernels of an instantiation
template <typename T, int DH>
constexpr auto dq_kernel() {
  if constexpr (Cfg<T, DH>::kRoles) return &bwd_dq_roles_kernel<T, DH>;
  else return &bwd_dq_kernel<T, DH>;
}
template <typename T, int DH>
constexpr auto dkdv_kernel() {
  if constexpr (Cfg<T, DH>::kRoles) return &bwd_dkdv_roles_kernel<T, DH>;
  else return &bwd_dkdv_kernel<T, DH>;
}

struct Args {
  long long b, hq, hkv, sq, sk;
  float scale;
  int causal;
  long long window, q_offset;
};

// --------------------------------------------------------- bf16 at dh 64, 128, 160
// The production dtype's training (bf16 params): pixtral-12b at dh 160,
// llama3.2-1b, hymba-1.5b and seamless-m4t at dh 64, qwen3-moe-30b-a3b at dh
// 128: every layer's backward runs here.  The kernels above split each loop
// tile into the operand layout on the block's CUDA cores between barriers,
// beside no product, one warpgroup a block in bf16 (at dh 64 22% of the bound,
// slower than SDPA's backward on an H100).  Here no thread touches an operand,
// and the warpgroups specialise:
//   * TMA tensor copies (tma.cuh) land every operand in the 64-byte swizzle
//     that wgmma reads in place, K-major as the A or B of S and dP, MN-major
//     through B's transpose bit as the B of dQ += dS·K, dV += Pᵀ·dO and dK +=
//     dSᵀ·Q: one copy of each tile serves both products.  Rows past Sq or Sk
//     arrive as zeros.
//   * Warpgroup 0 is the producer: one warp keeps a ring of Bwd::kStages loop
//     tiles full (full and empty mbarriers per stage; in the dK/dV kernels its
//     lanes also write each tile's lse · log2 e and D into the stage) and gives
//     its registers to the consumers (setmaxnreg 40 / 232).
//   * dQ kernel: two consumer warpgroups of 64 query rows each (128 a block)
//     over 64-key tiles: S = Q·Kᵀ (Q's A fragments in registers, dh / 4 a
//     thread), dP = dO·Vᵀ, P and dS = P ∘ (dP − D) in registers, dQ += dS·K
//     (dh / 2 fp32 sums a thread).  Each owns one sum, so two 64-row
//     warpgroups fit beside S, dP and the fragments, and the two share each
//     loop tile: half the tile bytes of one warpgroup a block.  D = rowsum(dO ∘
//     O) is computed by each row's four threads and written for the dK/dV
//     kernel.
//   * dK/dV kernel, two arrangements (Bwd<DH>::kBothSums picks one per head dim):
//     - roles (bwd_dkdv_ws_kernel): 64 keys a block over 64-row query tiles,
//       the two roles of the fp32 kernels at dh 160 (bwd_dkdv_roles_kernel):
//       role 0 runs Sᵀ = K·Qᵀ, Pᵀ and dV += Pᵀ·dO, role 1 dPᵀ = V·dOᵀ, dSᵀ =
//       Pᵀ ∘ (dPᵀ − D) and dK += dSᵀ·Q, Pᵀ passing through shared memory
//       (double buffered, two named barriers each way, so role 0 may run a
//       tile ahead).  Each role holds its block operand (K or V) as A
//       fragments in registers, so Sᵀ and dPᵀ read only the loop tile from
//       shared memory (an m64n64 product from shared memory on both sides
//       reads it at its full rate).  At dh 160 two 64-key warpgroups with
//       both sums each would hold 160 fp32 sums a thread beside S, dP and the
//       fragments of a 64-row tile (past 240 registers); a role holds one.
//     - both sums (bwd_dkdv_sums_kernel): 128 keys a block, each consumer
//       owning dK and dV of its 64 (dh fp32 sums a thread), the two sharing
//       each 64-row query tile; Sᵀ, dPᵀ, Pᵀ and dSᵀ stay in the consumer's
//       registers, so nothing passes through shared memory and each tile's Q
//       and dO serve 128 keys, not 64.  K and V are read from shared memory
//       (at dh 128 their A fragments, 64 registers a thread, would not fit
//       beside the sums).
// Which kernel runs each bf16 entry: the fastest arrangement measured on an
// H100 at each head dim (scripts/flash_variants.py bwd builds the others by
// patching kTmaDq, kTmaDkdv or Bwd's kBothSums and kSoloDq).  dh 128 takes the
// warp-specialised dQ and both sums (dK/dV 1.18 ms against the roles' 1.51 and
// Cfg's 2.56 at qwen3-moe's B 2 × S 4,096: the roles' exchange of Pᵀ and the
// single 64-key owner of each Q and dO tile cost more than the both-sums
// consumer's registers); dh 160 the warp-specialised dQ and the roles (its
// both-sums consumer would not fit in 240 registers); dh 64 the dQ kernel of
// one warpgroup a block on TMA (bwd_dq_solo_kernel, below: 0.29 ms against
// Cfg's 0.32 and the warp-specialised 0.45 at llama3.2-1b's B 4 × S 2048) and
// the older dK/dV kernel of Cfg (0.46 against both sums' 0.52 and the roles'
// 0.70).  fp32, and bf16 at dh 16 and 32, run the kernels of Cfg.
// The sums run as one wgmma chain over the loop (bf16 products of fp32 sums:
// no fp32 tolerance to keep, unlike the split-TF32 kernels), each output
// element has one owner (no atomics: the same bits on every run), masks by
// select only on tiles that cross the band or the end of Sk, the heaviest blocks
// first, GQA read in place.
constexpr int kBwdRegsProducer = 40, kBwdRegsConsumer = 232;
constexpr int kDqRows = 128, kDqKeys = 64;  // dQ: 128 query rows a block over 64-key tiles
constexpr int kKvKeys = 64, kKvRows = 64;   // dK/dV: 64 keys (a consumer) over 64-row tiles
constexpr int kKvExchange = kKvKeys * kKvRows * 4;  // one buffer of Pᵀ, fp32
template <typename T, int DH>
constexpr bool kTmaDq =
    std::is_same<T, __nv_bfloat16>::value && (DH == 64 || DH == 128 || DH == 160);
template <typename T, int DH>
constexpr bool kTmaDkdv = std::is_same<T, __nv_bfloat16>::value && (DH == 128 || DH == 160);
template <int DH>
struct Bwd {
  static constexpr int kTile64 = 64 * DH * 2;  // one operand tile of 64 rows
  static constexpr int kStages = 3;  // loop tiles in flight
  // dQ: Q and dO of 128 rows + kStages stages of K and V of 64 keys
  static constexpr int kDqSmem =
      1024 + 2 * 2 * kTile64 + kStages * 2 * kTile64 + 8 * (1 + 2 * kStages);
  static constexpr bool kBothSums = DH == 128;  // else the roles
  static constexpr bool kSoloDq = DH == 64;      // one warpgroup a block
  static constexpr int kKeys = kBothSums ? 2 * kKvKeys : kKvKeys;  // keys a dK/dV block
  // dK/dV: K and V of kKeys keys + kStages stages of Q and dO + their lse · log2 e
  // and D (+ the roles' exchange of Pᵀ)
  static constexpr int kKvSmem = 1024 + 2 * (kKeys / 64) * kTile64 + kStages * 2 * kTile64 +
                                 kStages * 2 * 4 * kKvRows +
                                 (kBothSums ? 0 : 2 * kKvExchange) + 8 * (1 + 2 * kStages);
  static_assert(DH % tma::kBoxCols == 0, "a tile is whole 32-column boxes");
  static_assert(kDqSmem <= kSmemMax && kKvSmem <= kSmemMax, "shared memory");
};

template <int DH>
__global__ void __launch_bounds__(384, 1)
bwd_dq_ws_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                 float* __restrict__ delta, int hq, int g, long long sq, long long sk,
                 float scale, int causal, long long window, long long q_offset) {
  using T = __nv_bfloat16;
  constexpr int BK = kDqKeys, S = Bwd<DH>::kStages, NS = BK / 2, NO = DH / 2;
  constexpr int QK_STEPS = DH / 16, DQ_STEPS = BK / 16, TILE = Bwd<DH>::kTile64;
  constexpr int CHUNKS = DH / 32;  // 16-byte chunks of a row each of its four threads sums
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = tma::align1024(smem_raw);  // [box][128 rows][64 B]
  unsigned char* dos = qs + 2 * TILE;
  unsigned char* kvs = dos + 2 * TILE;   // [stage][K tile, V tile]
  uint64_t* full_qo = reinterpret_cast<uint64_t*>(kvs + S * 2 * TILE);
  uint64_t* full = full_qo + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid >> 7;
  const long long bh = blockIdx.x, b = bh / hq;
  const int kvh = static_cast<int>(b * (hq / g) + (bh % hq) / g);
  // the last query tiles see the most keys under the causal mask: they go first
  const long long q0 = (static_cast<long long>(gridDim.y) - 1 - blockIdx.y) * kDqRows;
  const long long nq = min(static_cast<long long>(kDqRows), sq - q0);

  // the key tiles that some row of the block may see: [t0, t0 + BK · n_tiles)
  long long k_lo = 0, k_hi = sk;
  if (causal) k_hi = min(k_hi, q0 + nq + q_offset);
  if (window > 0) k_lo = max(k_lo, q0 + q_offset - window + 1);
  const long long t0 = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_lo ? static_cast<int>((k_hi - t0 + BK - 1) / BK) : 0;

  if (tid == 0) {
    hopper::mbar_init(full_qo, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    tma::regs_dec<kBwdRegsProducer>();
    if (tid == 0 && n_tiles > 0) {
      hopper::mbar_expect_tx(full_qo, 4 * TILE);
      tma::load_tile<DH, kDqRows>(qs, &tq, static_cast<int>(q0), static_cast<int>(bh), full_qo);
      tma::load_tile<DH, kDqRows>(dos, &tdo, static_cast<int>(q0), static_cast<int>(bh), full_qo);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S, k0 = static_cast<int>(t0 + static_cast<long long>(t) * BK);
        if (t >= S) hopper::mbar_wait(&empty[s], ((t / S) - 1) & 1);
        unsigned char* dst = kvs + s * 2 * TILE;
        hopper::mbar_expect_tx(&full[s], 2 * TILE);
        tma::load_tile<DH, BK>(dst, &tk, k0, kvh, &full[s]);
        tma::load_tile<DH, BK>(dst + TILE, &tv, k0, kvh, &full[s]);
      }
    }
    return;
  }

  tma::regs_inc<kBwdRegsConsumer>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), tig = lane & 3;
  const long long wq0 = q0 + cw * kWgRows;  // this warpgroup's rows
  const long long qa_lo = wq0 + q_offset, qa_hi = min(wq0 + kWgRows, sq) - 1 + q_offset;
  const bool rows = wq0 < sq;
  const unsigned char* dow = dos + cw * kWgRows * tma::kBoxRowBytes;  // its rows of dO
  const float scale_log2 = scale * kLog2e;

  // D = rowsum(dO ∘ O) and lse · log2 e of this thread's rows r0 and r0 + 8: each
  // row's four threads take dh / 4 columns each
  float lse2[2], drw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = wq0 + r0 + 8 * h, row = bh * sq + r;
    float sum = 0.0f;
    if (r < sq) {
      const uint4* dr = reinterpret_cast<const uint4*>(dout + row * DH) + tig * CHUNKS;
      const uint4* orow = reinterpret_cast<const uint4*>(o + row * DH) + tig * CHUNKS;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) sum = dot_chunk<T>(__ldg(dr + c), __ldg(orow + c), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    drw[h] = sum;
    lse2[h] = r < sq ? lse[row] * kLog2e : 0.0f;
    if (r < sq && tig == 0) delta[row] = sum;
  }
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  uint32_t qf[DH / 4];  // Q's A fragments: S = Q·Kᵀ reads only K from shared memory
  if (n_tiles > 0) {
    hopper::mbar_wait(full_qo, 0);
    tma::load_a_frags<kDqRows, DH>(qs, cw * kWgRows, qf);
  }
  // tile t: its stage arrived, S = Q · Kᵀ and dP = dO · Vᵀ issued and committed,
  // P and dS = P ∘ (dP − D) in dp, dQ += dS · K (dS from registers, K read
  // MN-major) issued and committed, the stage released
  auto arrived = [&](int t) { hopper::mbar_wait(&full[t % S], (t / S) & 1); };
  auto release = [&](int t) {  // this warp is done with the stage
    if (lane == 0) tma::arrive(&empty[t % S]);
  };
  auto issue_sdp = [&](float (&x)[NS], float (&dp)[NS], int t) {
    const unsigned char* kt = kvs + (t % S) * 2 * TILE;
    const unsigned char* vt = kt + TILE;
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < QK_STEPS; ++i)
      Mma<Op::kBf16, Src::kRS, BK>::run(x, qf + 4 * i, tma::desc_k<BK>(kt, i), i > 0);
#pragma unroll
    for (int i = 0; i < QK_STEPS; ++i)
      Mma<Op::kBf16, Src::kSS, BK>::run(dp, tma::desc_k<kDqRows>(dow, i),
                                        tma::desc_k<BK>(vt, i), i > 0);
    hopper::wgmma_commit();
  };
  // x[4i + 2h + e] is row r0 + 8h, key k0 + 8i + 2·tig + e
  auto p_ds = [&](const float (&x)[NS], float (&dp)[NS], int t) {
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > qa_lo) ||
                        (window > 0 && k0 <= qa_hi - window);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long qpos = qa_lo + r0 + 8 * h;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * i + 2 * h + e;
          float p = hopper::exp2_approx(fmaf(x[j], scale_log2, -lse2[h]));
          if (masked) p = visible(qpos, k0 + 8 * i + 2 * tig + e, sk, causal, window) ? p : 0.0f;
          dp[j] = p * (dp[j] - drw[h]);
        }
    }
  };
  auto issue_dq = [&](const float (&dp)[NS], uint32_t (&f)[4 * DQ_STEPS], int t) {
    const unsigned char* kt = kvs + (t % S) * 2 * TILE;
    to_frags<T, BK>(dp, f, nullptr);
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < DQ_STEPS; ++i)
      tma::mma_mn<BK, DH>(acc, f + 4 * i, kt, i);
    hopper::wgmma_commit();
  };
  // does some row of this warpgroup see a key of tile t?
  auto active = [&](int t) {
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    return rows && !(causal && k0 > qa_hi) && !(window > 0 && k0 + BK - 1 <= qa_lo - window);
  };

  for (int t = 0; t < n_tiles; ++t) {
    arrived(t);
    if (active(t)) {
      float x[NS], dp[NS];
      uint32_t f[4 * DQ_STEPS];
      issue_sdp(x, dp, t);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(x);
      hopper::fence_regs(dp);
      p_ds(x, dp, t);
      issue_dq(dp, f, t);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(f);
    }
    release(t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = wq0 + r0 + 8 * h;
    if (r >= sq) continue;
    T* out = dq + (bh * sq + r) * DH + 2 * tig;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      store2(out + 8 * i, acc[4 * i + 2 * h] * scale, acc[4 * i + 2 * h + 1] * scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(384, 1)
bwd_dkdv_ws_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int hq, int g, long long sq, long long sk,
                   float scale, int causal, long long window, long long q_offset) {
  using T = __nv_bfloat16;
  constexpr int BQ = kKvRows, S = Bwd<DH>::kStages, NS = BQ / 2, NO = DH / 2;
  constexpr int QK_STEPS = DH / 16, KV_STEPS = BQ / 16, TILE = Bwd<DH>::kTile64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = tma::align1024(smem_raw);   // K, then V: [box][64 keys][64 B]
  unsigned char* vs = ks + TILE;
  unsigned char* qds = vs + TILE;         // [stage][Q tile, dO tile]
  float* lse2s = reinterpret_cast<float*>(qds + S * 2 * TILE);  // [stage][64]
  float* ds_ = lse2s + S * BQ;                                         // [stage][64]: D
  float* xs = ds_ + S * BQ;                                            // [2][Pᵀ]
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(xs + 2 * (kKvExchange / 4));
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid >> 7;
  const long long bkv = blockIdx.x;  // b · Hkv + KV head
  const long long hkv = hq / g, b = bkv / hkv;
  const long long h0 = b * hq + (bkv % hkv) * g;  // b · Hq + the group's first q head
  // the first key tiles are seen by the most rows under the causal mask: they go first
  const long long k0 = static_cast<long long>(blockIdx.y) * kKvKeys;
  const long long nk = min(static_cast<long long>(kKvKeys), sk - k0);

  // the query tiles that see some key of the block, for each of the g heads
  long long i_lo = 0, i_hi = sq;
  if (causal) i_lo = max(i_lo, k0 - q_offset);
  if (window > 0) i_hi = min(i_hi, k0 + nk - 1 + window - q_offset);
  const long long qt0 = (i_lo / BQ) * BQ;
  const int n_qt = i_hi > i_lo ? static_cast<int>((i_hi - qt0 + BQ - 1) / BQ) : 0;
  const int n_tiles = g * n_qt;
  auto tile_q0 = [&](int t) { return qt0 + static_cast<long long>(t % n_qt) * BQ; };
  auto tile_bh = [&](int t) { return h0 + t / n_qt; };

  if (tid == 0) {
    hopper::mbar_init(full_kv, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp: the copies and lse, D
      hopper::mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: its first warp
    tma::regs_dec<kBwdRegsProducer>();
    if (tid < 32 && n_tiles > 0) {
      const int lane = tid;
      if (lane == 0) {
        hopper::mbar_expect_tx(full_kv, 2 * TILE);
        tma::load_tile<DH, kKvKeys>(ks, &tk, static_cast<int>(k0), static_cast<int>(bkv), full_kv);
        tma::load_tile<DH, kKvKeys>(vs, &tv, static_cast<int>(k0), static_cast<int>(bkv), full_kv);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        const long long q0 = tile_q0(t), bh = tile_bh(t);
        if (t >= S) hopper::mbar_wait(&empty[s], ((t / S) - 1) & 1);
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {  // the tile's lse · log2 e and D, 0 past Sq
          const int r = lane + 32 * u;
          const bool in = q0 + r < sq;
          lse2s[s * BQ + r] = in ? lse[bh * sq + q0 + r] * kLog2e : 0.0f;
          ds_[s * BQ + r] = in ? delta[bh * sq + q0 + r] : 0.0f;
        }
        if (lane == 0) {
          unsigned char* dst = qds + s * 2 * TILE;
          hopper::mbar_expect_tx(&full[s], 2 * TILE);
          tma::load_tile<DH, BQ>(dst, &tq, static_cast<int>(q0), static_cast<int>(bh), &full[s]);
          tma::load_tile<DH, BQ>(dst + TILE, &tdo, static_cast<int>(q0),
                                 static_cast<int>(bh), &full[s]);
        } else {
          tma::arrive(&full[s]);
        }
      }
    }
    return;
  }

  tma::regs_inc<kBwdRegsConsumer>();
  const int role = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), tig = lane & 3;
  const float scale_log2 = scale * kLog2e;
  constexpr int kPReady = 1, kPFree = 3;  // named barriers 1, 2 and 3, 4: one a buffer
  float acc[NO];  // role 0's dV, role 1's dK
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  uint32_t kvf[DH / 4];  // role 0's K, role 1's V as A fragments
  if (n_tiles > 0) {
    hopper::mbar_wait(full_kv, 0);
    tma::load_a_frags<kKvKeys, DH>(role ? vs : ks, 0, kvf);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S, buf = t & 1;
    const long long q0 = tile_q0(t);
    const unsigned char* qt = qds + s * 2 * TILE;
    const unsigned char* dot = qt + TILE;
    float* xb = xs + buf * (kKvExchange / 4);
    hopper::mbar_wait(&full[s], (t / S) & 1);

    // role 0: Sᵀ = K · Qᵀ; role 1: dPᵀ = V · dOᵀ (keys as M).  x[4i + 2h + e] is
    // key k0 + r0 + 8h, query row q0 + 8i + 2·tig + e
    float x[NS];
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < QK_STEPS; ++i)
      Mma<Op::kBf16, Src::kRS, BQ>::run(x, kvf + 4 * i, tma::desc_k<BQ>(role ? dot : qt, i),
                                        i > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(x);
    if (role == 0) {  // Pᵀ, to role 1
      const bool masked = k0 + kKvKeys > sk || (causal && k0 + kKvKeys - 1 > q0 + q_offset) ||
                          (window > 0 && k0 <= q0 + BQ - 1 + q_offset - window);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int c = 8 * i + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2s + s * BQ + c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * i + 2 * h + e;
            const float p = hopper::exp2_approx(fmaf(x[j], scale_log2, -(e ? l2.y : l2.x)));
            x[j] = !masked || visible(q0 + c + e + q_offset, k0 + r0 + 8 * h, sk, causal, window)
                       ? p
                       : 0.0f;
          }
      }
      if (t >= 2) hopper::bar_sync(kPFree + buf, 256);  // role 1 has read tile t − 2's
      put_exchange(xb, x);
      hopper::bar_arrive(kPReady + buf, 256);
    } else {  // dSᵀ = Pᵀ ∘ (dPᵀ − D)
      float p[NS];
      hopper::bar_sync(kPReady + buf, 256);
      get_exchange(xb, p);
      if (t + 2 < n_tiles) hopper::bar_arrive(kPFree + buf, 256);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 dd = *reinterpret_cast<const float2*>(ds_ + s * BQ + 8 * i + 2 * tig);
#pragma unroll
        for (int j = 4 * i; j < 4 * i + 4; ++j) x[j] = p[j] * (x[j] - (j & 1 ? dd.y : dd.x));
      }
    }

    // role 0: dV += Pᵀ · dO; role 1: dK += dSᵀ · Q; the A from registers, the B
    // read MN-major
    uint32_t f[4 * KV_STEPS];
    to_frags<T, BQ>(x, f, nullptr);
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < KV_STEPS; ++i)
      tma::mma_mn<BQ, DH>(acc, f + 4 * i, role ? qt : dot, i);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(f);
    if (lane == 0) tma::arrive(&empty[s]);  // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= nk) continue;
    T* out = (role ? dk : dv) + (bkv * sk + k0 + r) * DH + 2 * tig;
    const float f = role ? scale : 1.0f;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      store2(out + 8 * i, acc[4 * i + 2 * h] * f, acc[4 * i + 2 * h + 1] * f);
  }
}

// The both-sums dK/dV arrangement (the note above struct Bwd): 128 keys a block,
// consumer c owning keys [k0 + 64c, k0 + 64c + 64) with their dK and dV sums, the
// two sharing each 64-row tile of Q and dO (with its lse · log2 e and D, written
// into the stage by the producer warp, as in bwd_dkdv_ws_kernel).  Per tile a
// consumer issues Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as one group, forms Pᵀ and dSᵀ in
// registers and issues dV += Pᵀ·dO and dK += dSᵀ·Q as the next; a consumer that
// none of the tile's rows sees skips it.  Its products are those of the roles
// kernel in the same order, so the two give the same bits.
template <int DH>
__global__ void __launch_bounds__(384, 1)
bwd_dkdv_sums_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int hq, int g, long long sq, long long sk,
                     float scale, int causal, long long window, long long q_offset) {
  using T = __nv_bfloat16;
  constexpr int BQ = kKvRows, KB = Bwd<DH>::kKeys, S = Bwd<DH>::kStages, NS = BQ / 2;
  constexpr int NO = DH / 2;
  constexpr int QK_STEPS = DH / 16, KV_STEPS = BQ / 16, TILE = Bwd<DH>::kTile64;
  static_assert(KB == 2 * kKvKeys, "two consumers of 64 keys");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = tma::align1024(smem_raw);   // K, then V: [box][128 keys][64 B]
  unsigned char* vs = ks + 2 * TILE;
  unsigned char* qds = vs + 2 * TILE;             // [stage][Q tile, dO tile]
  float* lse2s = reinterpret_cast<float*>(qds + S * 2 * TILE);  // [stage][64]
  float* ds_ = lse2s + S * BQ;                                  // [stage][64]: D
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(ds_ + S * BQ);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid >> 7;
  const long long bkv = blockIdx.x;  // b · Hkv + KV head
  const long long hkv = hq / g, b = bkv / hkv;
  const long long h0 = b * hq + (bkv % hkv) * g;  // b · Hq + the group's first q head
  // the first key tiles are seen by the most rows under the causal mask: they go first
  const long long k0 = static_cast<long long>(blockIdx.y) * KB;
  const long long nk = min(static_cast<long long>(KB), sk - k0);

  // the query tiles that see some key of the block, for each of the g heads
  long long i_lo = 0, i_hi = sq;
  if (causal) i_lo = max(i_lo, k0 - q_offset);
  if (window > 0) i_hi = min(i_hi, k0 + nk - 1 + window - q_offset);
  const long long qt0 = (i_lo / BQ) * BQ;
  const int n_qt = i_hi > i_lo ? static_cast<int>((i_hi - qt0 + BQ - 1) / BQ) : 0;
  const int n_tiles = g * n_qt;
  auto tile_q0 = [&](int t) { return qt0 + static_cast<long long>(t % n_qt) * BQ; };
  auto tile_bh = [&](int t) { return h0 + t / n_qt; };

  if (tid == 0) {
    hopper::mbar_init(full_kv, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp: the copies and lse, D
      hopper::mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: its first warp
    tma::regs_dec<kBwdRegsProducer>();
    if (tid < 32 && n_tiles > 0) {
      const int lane = tid;
      if (lane == 0) {
        hopper::mbar_expect_tx(full_kv, 4 * TILE);
        tma::load_tile<DH, KB>(ks, &tk, static_cast<int>(k0), static_cast<int>(bkv), full_kv);
        tma::load_tile<DH, KB>(vs, &tv, static_cast<int>(k0), static_cast<int>(bkv), full_kv);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        const long long q0 = tile_q0(t), bh = tile_bh(t);
        if (t >= S) hopper::mbar_wait(&empty[s], ((t / S) - 1) & 1);
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {  // the tile's lse · log2 e and D, 0 past Sq
          const int r = lane + 32 * u;
          const bool in = q0 + r < sq;
          lse2s[s * BQ + r] = in ? lse[bh * sq + q0 + r] * kLog2e : 0.0f;
          ds_[s * BQ + r] = in ? delta[bh * sq + q0 + r] : 0.0f;
        }
        if (lane == 0) {
          unsigned char* dst = qds + s * 2 * TILE;
          hopper::mbar_expect_tx(&full[s], 2 * TILE);
          tma::load_tile<DH, BQ>(dst, &tq, static_cast<int>(q0), static_cast<int>(bh), &full[s]);
          tma::load_tile<DH, BQ>(dst + TILE, &tdo, static_cast<int>(q0), static_cast<int>(bh),
                                 &full[s]);
        } else {
          tma::arrive(&full[s]);
        }
      }
    }
    return;
  }

  tma::regs_inc<kBwdRegsConsumer>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), tig = lane & 3;
  const long long kc0 = k0 + cw * kKvKeys;  // this consumer's keys
  const float scale_log2 = scale * kLog2e;
  const unsigned char* kw = ks + cw * kKvKeys * tma::kBoxRowBytes;  // its rows of K and V
  const unsigned char* vw = vs + cw * kKvKeys * tma::kBoxRowBytes;
  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.0f;
  if (n_tiles > 0) hopper::mbar_wait(full_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S;
    const long long q0 = tile_q0(t);
    const unsigned char* qt = qds + s * 2 * TILE;
    const unsigned char* dot = qt + TILE;
    hopper::mbar_wait(&full[s], (t / S) & 1);
    // does some row of this tile see a key of this consumer?
    const bool active = kc0 < sk && !(causal && q0 + BQ - 1 + q_offset < kc0) &&
                        !(window > 0 && kc0 + kKvKeys - 1 <= q0 + q_offset - window);
    if (active) {
      // Sᵀ = K · Qᵀ and dPᵀ = V · dOᵀ (keys as M); x[4i + 2h + e] is key kc0 + r0 +
      // 8h, query row q0 + 8i + 2·tig + e
      float x[NS], dp[NS];
      hopper::wgmma_fence();
#pragma unroll
      for (int i = 0; i < QK_STEPS; ++i)
        Mma<Op::kBf16, Src::kSS, BQ>::run(x, tma::desc_k<KB>(kw, i), tma::desc_k<BQ>(qt, i),
                                          i > 0);
#pragma unroll
      for (int i = 0; i < QK_STEPS; ++i)
        Mma<Op::kBf16, Src::kSS, BQ>::run(dp, tma::desc_k<KB>(vw, i), tma::desc_k<BQ>(dot, i),
                                          i > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(x);
      hopper::fence_regs(dp);

      // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ − D)
      const bool masked = kc0 + kKvKeys > sk || (causal && kc0 + kKvKeys - 1 > q0 + q_offset) ||
                          (window > 0 && kc0 <= q0 + BQ - 1 + q_offset - window);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int c = 8 * i + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2s + s * BQ + c);
        const float2 dd = *reinterpret_cast<const float2*>(ds_ + s * BQ + c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * i + 2 * h + e;
            float p = hopper::exp2_approx(fmaf(x[j], scale_log2, -(e ? l2.y : l2.x)));
            p = !masked || visible(q0 + c + e + q_offset, kc0 + r0 + 8 * h, sk, causal, window)
                    ? p
                    : 0.0f;
            x[j] = p;
            dp[j] = p * (dp[j] - (e ? dd.y : dd.x));
          }
      }

      // dV += Pᵀ · dO and dK += dSᵀ · Q; the A from registers, the B read MN-major
      uint32_t fp[4 * KV_STEPS], fs[4 * KV_STEPS];
      to_frags<T, BQ>(x, fp, nullptr);
      to_frags<T, BQ>(dp, fs, nullptr);
      hopper::wgmma_fence();
#pragma unroll
      for (int i = 0; i < KV_STEPS; ++i)
        tma::mma_mn<BQ, DH>(dva, fp + 4 * i, dot, i);
#pragma unroll
      for (int i = 0; i < KV_STEPS; ++i)
        tma::mma_mn<BQ, DH>(dka, fs + 4 * i, qt, i);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      hopper::fence_regs(fp);
      hopper::fence_regs(fs);
    }
    if (lane == 0) tma::arrive(&empty[s]);  // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long key = kc0 + r0 + 8 * h;
    if (key >= sk) continue;
    T* out_k = dk + (bkv * sk + key) * DH + 2 * tig;
    T* out_v = dv + (bkv * sk + key) * DH + 2 * tig;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      store2(out_k + 8 * i, dka[4 * i + 2 * h] * scale, dka[4 * i + 2 * h + 1] * scale);
      store2(out_v + 8 * i, dva[4 * i + 2 * h], dva[4 * i + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------- bf16 at dh 64
// The dQ kernel at dh 64 is one warpgroup a block: at dh 64
// a tile's products are short, and the warp-specialised dQ kernel above, one
// block an SM with two consumers, lost to the older one-warpgroup design that ran
// three blocks an SM (0.45 against 0.32 ms at B 4, Hq 32, S 2048 on an H100): the
// products of one block hide another's exponentials only where the SM holds
// several independent warpgroups.  So this kernel keeps the TMA operands in the
// swizzle wgmma reads, but a block is the 64 query rows of one warpgroup, thread 0
// issues the copies into a ring of kSoloStages loop tiles (refilling a stage once
// the four warps have arrived on its empty barrier), and it runs three blocks an
// SM (150 registers): 0.29 ms there.  (A dK/dV kernel built the same way, both
// sums a warpgroup, two blocks an SM at 209 registers, stayed slower than the
// older dK/dV kernel, which dh 64 keeps.)
constexpr int kSoloStages = 3;

template <int DH>
__global__ void __launch_bounds__(128, 3)
bwd_dq_solo_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int hq, int g,
                   long long sq, long long sk, float scale, int causal, long long window,
                   long long q_offset) {
  using T = __nv_bfloat16;
  constexpr int BK = kDqKeys, S = kSoloStages, NS = BK / 2, NO = DH / 2;
  constexpr int QK_STEPS = DH / 16, DQ_STEPS = BK / 16, TILE = Bwd<DH>::kTile64;
  constexpr int CHUNKS = DH / 32;  // 16-byte chunks of a row each of its four threads sums
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = tma::align1024(smem_raw);  // [box][64 rows][64 B]
  unsigned char* dos = qs + TILE;
  unsigned char* kvs = dos + TILE;  // [stage][K tile, V tile]
  uint64_t* full_qo = reinterpret_cast<uint64_t*>(kvs + S * 2 * TILE);
  uint64_t* full = full_qo + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = blockIdx.x, b = bh / hq;
  const int kvh = static_cast<int>(b * (hq / g) + (bh % hq) / g);
  // the last query tiles see the most keys under the causal mask: they go first
  const long long q0 = (static_cast<long long>(gridDim.y) - 1 - blockIdx.y) * kWgRows;
  const long long nq = min(static_cast<long long>(kWgRows), sq - q0);
  long long k_lo = 0, k_hi = sk;  // the key tiles the block's rows may see
  if (causal) k_hi = min(k_hi, q0 + nq + q_offset);
  if (window > 0) k_lo = max(k_lo, q0 + q_offset - window + 1);
  const long long t0 = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_lo ? static_cast<int>((k_hi - t0 + BK - 1) / BK) : 0;
  auto load = [&](int t) {  // thread 0: tile t into its stage
    const int s = t % S, k0 = static_cast<int>(t0 + static_cast<long long>(t) * BK);
    hopper::mbar_expect_tx(&full[s], 2 * TILE);
    tma::load_tile<DH, BK>(kvs + s * 2 * TILE, &tk, k0, kvh, &full[s]);
    tma::load_tile<DH, BK>(kvs + s * 2 * TILE + TILE, &tv, k0, kvh, &full[s]);
  };
  if (tid == 0) {
    hopper::mbar_init(full_qo, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // one arrival from each warp
    }
    hopper::fence_mbar_init();
    if (n_tiles > 0) {
      hopper::mbar_expect_tx(full_qo, 2 * TILE);
      tma::load_tile<DH, kWgRows>(qs, &tq, static_cast<int>(q0), static_cast<int>(bh), full_qo);
      tma::load_tile<DH, kWgRows>(dos, &tdo, static_cast<int>(q0), static_cast<int>(bh), full_qo);
      for (int t = 0; t < min(S, n_tiles); ++t) load(t);
    }
  }
  __syncthreads();

  const int r0 = warp * 16 + (lane >> 2), tig = lane & 3;
  const long long qa_lo = q0 + q_offset, qa_hi = q0 + nq - 1 + q_offset;
  const float scale_log2 = scale * kLog2e;
  // D = rowsum(dO ∘ O) and lse · log2 e of this thread's rows r0 and r0 + 8: each
  // row's four threads take dh / 4 columns each
  float lse2[2], drw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = q0 + r0 + 8 * h, row = bh * sq + r;
    float sum = 0.0f;
    if (r < sq) {
      const uint4* dr = reinterpret_cast<const uint4*>(dout + row * DH) + tig * CHUNKS;
      const uint4* orow = reinterpret_cast<const uint4*>(o + row * DH) + tig * CHUNKS;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) sum = dot_chunk<T>(__ldg(dr + c), __ldg(orow + c), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    drw[h] = sum;
    lse2[h] = r < sq ? lse[row] * kLog2e : 0.0f;
    if (r < sq && tig == 0) delta[row] = sum;
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  uint32_t qf[DH / 4];  // Q's A fragments
  if (n_tiles > 0) {
    hopper::mbar_wait(full_qo, 0);
    tma::load_a_frags<kWgRows, DH>(qs, 0, qf);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S;
    const long long k0 = t0 + static_cast<long long>(t) * BK;
    const unsigned char* kt = kvs + s * 2 * TILE;
    const unsigned char* vt = kt + TILE;
    hopper::mbar_wait(&full[s], (t / S) & 1);
    const bool active = !(causal && k0 > qa_hi) && !(window > 0 && k0 + BK - 1 <= qa_lo - window);
    if (active) {
      // S = Q · Kᵀ and dP = dO · Vᵀ
      float x[NS], dp[NS];
      hopper::wgmma_fence();
#pragma unroll
      for (int i = 0; i < QK_STEPS; ++i)
        Mma<Op::kBf16, Src::kRS, BK>::run(x, qf + 4 * i, tma::desc_k<BK>(kt, i), i > 0);
#pragma unroll
      for (int i = 0; i < QK_STEPS; ++i)
        Mma<Op::kBf16, Src::kSS, BK>::run(dp, tma::desc_k<kWgRows>(dos, i),
                                          tma::desc_k<BK>(vt, i), i > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(x);
      hopper::fence_regs(dp);
      // P and dS = P ∘ (dP − D); x[4i + 2h + e] is row r0 + 8h, key k0 + 8i + 2·tig + e
      const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > qa_lo) ||
                          (window > 0 && k0 <= qa_hi - window);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long qpos = qa_lo + r0 + 8 * h;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * i + 2 * h + e;
            float p = hopper::exp2_approx(fmaf(x[j], scale_log2, -lse2[h]));
            if (masked) p = visible(qpos, k0 + 8 * i + 2 * tig + e, sk, causal, window) ? p : 0.0f;
            dp[j] = p * (dp[j] - drw[h]);
          }
      }
      // dQ += dS · K, dS from registers, K read MN-major
      uint32_t f[4 * DQ_STEPS];
      to_frags<T, BK>(dp, f, nullptr);
      hopper::wgmma_fence();
#pragma unroll
      for (int i = 0; i < DQ_STEPS; ++i)
        tma::mma_mn<BK, DH>(acc, f + 4 * i, kt, i);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(f);
    }
    if (lane == 0) tma::arrive(&empty[s]);  // this warp is done with the stage
    if (tid == 0 && t + S < n_tiles) {      // refill it with tile t + S
      hopper::mbar_wait(&empty[s], (t / S) & 1);
      load(t + S);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = q0 + r0 + 8 * h;
    if (r >= sq) continue;
    T* out = dq + (bh * sq + r) * DH + 2 * tig;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      store2(out + 8 * i, acc[4 * i + 2 * h] * scale, acc[4 * i + 2 * h + 1] * scale);
  }
}

// the four maps of a backward call: q and dO with boxes of q_rows rows, k and v
// of kv_rows (Sk = 0: k's and v's describe q's first row, which is never read)
template <int DH>
int encode_bwd_maps(CUtensorMap* m, const void* q, const void* dout, const void* k,
                    const void* v, const Args& a, int q_rows, int kv_rows) {
  const bool keys = a.sk > 0;
  int err = tma::encode_rows(&m[0], q, a.b * a.hq, a.sq, DH, q_rows);
  if (err == 0) err = tma::encode_rows(&m[1], dout, a.b * a.hq, a.sq, DH, q_rows);
  if (err == 0) err = tma::encode_rows(&m[2], keys ? k : q, keys ? a.b * a.hkv : 1,
                                       keys ? a.sk : 1, DH, kv_rows);
  if (err == 0) err = tma::encode_rows(&m[3], keys ? v : q, keys ? a.b * a.hkv : 1,
                                       keys ? a.sk : 1, DH, kv_rows);
  return err;
}

template <int DH, typename Kernel>
int launch_dq_kernel(Kernel kernel, const CUtensorMap (&m)[4], const void* o, const void* lse,
                     const void* dout, void* dq, void* delta, const Args& a, int rows,
                     int threads, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(a.b * a.hq),
                  static_cast<unsigned>((a.sq + rows - 1) / rows));
  kernel<<<grid, threads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dq), static_cast<float*>(delta), static_cast<int>(a.hq),
      static_cast<int>(a.hq / a.hkv), a.sq, a.sk, a.scale, a.causal, a.window, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dq_ws(const void* q, const void* k, const void* v, const void* o, const void* lse,
                 const void* dout, void* dq, void* delta, const Args& a, cudaStream_t stream) {
  using B = Bwd<DH>;
  constexpr int rows = B::kSoloDq ? kWgRows : kDqRows;
  CUtensorMap m[4];
  int err = encode_bwd_maps<DH>(m, q, dout, k, v, a, rows, kDqKeys);
  if (err != 0) return err;
  if constexpr (B::kSoloDq) {
    constexpr int smem = 1024 + 2 * B::kTile64 + kSoloStages * 2 * B::kTile64 +
                         8 * (1 + 2 * kSoloStages);
    return launch_dq_kernel<DH>(bwd_dq_solo_kernel<DH>, m, o, lse, dout, dq, delta, a, rows, 128,
                                smem, stream);
  } else {
    return launch_dq_kernel<DH>(bwd_dq_ws_kernel<DH>, m, o, lse, dout, dq, delta, a, rows, 384,
                                B::kDqSmem, stream);
  }
}

template <int DH, typename Kernel>
int launch_dkdv_kernel(Kernel kernel, const CUtensorMap (&m)[4], const void* lse,
                       const void* delta, void* dk, void* dv, const Args& a,
                       cudaStream_t stream) {
  using B = Bwd<DH>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B::kKvSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(a.b * a.hkv),
                  static_cast<unsigned>((a.sk + B::kKeys - 1) / B::kKeys));
  kernel<<<grid, 384, B::kKvSmem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), static_cast<int>(a.hq),
      static_cast<int>(a.hq / a.hkv), a.sq, a.sk, a.scale, a.causal, a.window, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dkdv_ws(const void* q, const void* k, const void* v, const void* lse,
                   const void* dout, const void* delta, void* dk, void* dv, const Args& a,
                   cudaStream_t stream) {
  using B = Bwd<DH>;
  CUtensorMap m[4];
  int err = encode_bwd_maps<DH>(m, q, dout, k, v, a, kKvRows, B::kKeys);
  if (err != 0) return err;
  if constexpr (B::kBothSums)
    return launch_dkdv_kernel<DH>(bwd_dkdv_sums_kernel<DH>, m, lse, delta, dk, dv, a, stream);
  else
    return launch_dkdv_kernel<DH>(bwd_dkdv_ws_kernel<DH>, m, lse, delta, dk, dv, a, stream);
}

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* lse,
              const void* dout, void* dq, void* delta, const Args& a, cudaStream_t stream) {
  if constexpr (kTmaDq<T, DH>)
    return launch_dq_ws<DH>(q, k, v, o, lse, dout, dq, delta, a, stream);
  else {
    using C = Cfg<T, DH>;
    constexpr int smem = C::kSmemDq;
    constexpr auto kernel = dq_kernel<T, DH>();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(a.b * a.hq),
                    static_cast<unsigned>((a.sq + C::kRows - 1) / C::kRows));
    kernel<<<grid, C::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const float*>(lse), static_cast<const T*>(dout),
        static_cast<T*>(dq), static_cast<float*>(delta), static_cast<int>(a.hq),
        static_cast<int>(a.hq / a.hkv), a.sq, a.sk, a.scale, a.causal, a.window, a.q_offset);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int DH>
int launch_dkdv(const void* q, const void* k, const void* v, const void* lse,
                const void* dout, const void* delta, void* dk, void* dv, const Args& a,
                cudaStream_t stream) {
  if constexpr (kTmaDkdv<T, DH>)
    return launch_dkdv_ws<DH>(q, k, v, lse, dout, delta, dk, dv, a, stream);
  else {
    using C = Cfg<T, DH>;
    constexpr int smem = C::kSmemDkdv;
    constexpr auto kernel = dkdv_kernel<T, DH>();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(a.b * a.hkv),
                    static_cast<unsigned>((a.sk + C::kRows - 1) / C::kRows));
    kernel<<<grid, C::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(lse), static_cast<const T*>(dout),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<int>(a.hq), static_cast<int>(a.hq / a.hkv), a.sq, a.sk, a.scale, a.causal,
        a.window, a.q_offset);
    return static_cast<int>(cudaGetLastError());
  }
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
    case 160: return launch_dq<T, 160>(q, k, v, o, lse, dout, dq, delta, a, st);
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
    case 160: return launch_dkdv<T, 160>(q, k, v, lse, dout, delta, dk, dv, a, st);
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
