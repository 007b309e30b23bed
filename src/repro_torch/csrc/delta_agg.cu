// delta_agg — in-place signed delta aggregation, step 1 of the incremental layer.
//
//   state[r] += Σ_{k=row_ptr[r]}^{row_ptr[r+1]-1} messages[order[k]]   for rows with records
//
// Replaces: the Pallas TPU kernel `delta_agg` (src/repro/kernels/delta_agg.py, fn
// `delta_agg`, body `_kernel`), which adds onehot(dst_local) @ msg into the state tiles
// named by a block-CSR schedule and aliases the state buffer to its output
// (`input_output_aliases`) so untouched tiles cost nothing.  In the port it adds the
// signed [ctx | raw] record messages of `_layer_body` step 1
// (src/repro_torch/core/incremental.py) into the touched rows' [nct | ms_cbn⁻¹(a)]
// state, using the row schedule (stable argsort of the records' row index + row_ptr)
// that the host planner ships with each packed plan.
//
// What bounds it on an H100: memory.  Bytes = E·D·4 of messages + index bytes
// (row_ptr, order) + R·D·4 of state read and written for the touched rows only; one add
// per message element.  At the streaming shapes (E and R in the thousands, D ≈ 130) the
// work is a few MB, so in practice a single launch is bound by launch latency.
//
// What the design does about it: one warp per touched row with lanes across the
// columns, so reads are coalesced and each state row is read and written once; rows
// without records are skipped before any load — the O(affected) property the TPU kernel
// gets from aliasing.  The sum is taken in a register in record order and added to the
// state once, so it is deterministic and matches `nct_old + Σ delta` of the reference.
#include "row_sum.cuh"

extern "C" int delta_agg_i32(const void* msg, const void* row_ptr, const void* order,
                             void* state, long long num_rows, long long d, void* stream) {
  return repro_torch::launch_row_sum<int32_t, true>(msg, row_ptr, order, state, num_rows, d,
                                                    stream);
}

extern "C" int delta_agg_i64(const void* msg, const void* row_ptr, const void* order,
                             void* state, long long num_rows, long long d, void* stream) {
  return repro_torch::launch_row_sum<int64_t, true>(msg, row_ptr, order, state, num_rows, d,
                                                    stream);
}
