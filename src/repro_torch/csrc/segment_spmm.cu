// segment_spmm — destination segment sum for the full-neighbour layer.
//
//   out[r] = Σ_{k=row_ptr[r]}^{row_ptr[r+1]-1} messages[order[k]]   (order may be NULL = identity)
//
// Replaces: the Pallas TPU kernel `segment_spmm` (src/repro/kernels/segment_spmm.py,
// fn `segment_spmm`, body `_kernel`), which sums destination-sorted edges as one-hot
// MXU matmuls per (row tile, edge block) over a host-planned block-CSR schedule.  In
// the port it carries the segment sums of `full_layer` and `subset_layer`
// (src/repro_torch/core/full.py), i.e. engine init, refresh and gat's constrained
// full-recompute path, with the [ctx | raw] columns in one call.
//
// What bounds it on an H100: memory.  It does one add per message element and moves
// E·D·4 bytes of messages in, the index bytes (row_ptr, order), and R·D·4 bytes out;
// at the engine-init shape (E = 10M, D = 129, R = 1M) that is ≈ 5.7 GB, ≈ 1.7 ms at
// 3.35 TB/s, against ≈ 1.3 GFLOP of adds.
//
// What the design does about it: rows are contiguous in memory, so a warp that owns a
// row reads each record's D floats with consecutive lanes on consecutive addresses
// (coalesced 128-byte lines) and writes its output row once.  There is no second pass
// and no scratch in device memory; the sum stays in a register.  Known gaps, left for a
// later change: no load balance for hub rows (one warp walks a hub's whole record list),
// no 16-byte vector loads (D = 129 rows are not 16-byte aligned), and the [ctx | raw]
// gather from the edge messages is not fused in.
#include "row_sum.cuh"

extern "C" int segment_spmm_i32(const void* msg, const void* row_ptr, const void* order,
                                void* out, long long num_rows, long long d, void* stream) {
  return repro_torch::launch_row_sum<int32_t, false>(msg, row_ptr, order, out, num_rows, d,
                                                     stream);
}

extern "C" int segment_spmm_i64(const void* msg, const void* row_ptr, const void* order,
                                void* out, long long num_rows, long long d, void* stream) {
  return repro_torch::launch_row_sum<int64_t, false>(msg, row_ptr, order, out, num_rows, d,
                                                     stream);
}
