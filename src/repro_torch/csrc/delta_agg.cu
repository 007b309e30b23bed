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
// per message element.  At the streaming shapes (E and R in the thousands to a few
// hundred thousand, D ≈ 130) the work is a few MB to a few hundred MB, and a launch is
// bound by latency and by the records' random order (each record is a gathered D-float
// row).  When a batch touches many of a hub's in-neighbours, one row holds most of the
// records, and how evenly they spread over the card bounds it.
//
// What the design does about it (row_sum.cuh): a warp owns a touched row of at most 512
// records and walks them once for all columns (lanes across the columns, so each
// gathered record is a coalesced read; 32 record ids a load shared by shuffle; four
// records' loads in flight, with the state row's); a longer row is cut into 512-record
// chunks summed by warps anywhere on the card into scratch slots, and a second pass adds
// a row's chunk sums in chunk order and adds the total into the state once.  Rows
// without records are skipped before any load — the O(affected) property the TPU kernel
// gets from aliasing.  Each row's order of additions is a function of its own records
// (rows of at most 512 records: the one k-order chain, as before), so the result is
// deterministic and the same bits whatever else the launch holds.  The scratch is sized
// from E on the host; with E <= 512 no row can be long and pass 2 is not launched.
// Known gaps: a warp still owns a row of one record alone, and every window's chunk
// warps search row_ptr even where no row is long.
#include "row_sum.cuh"

extern "C" int delta_agg_i32(const void* msg, const void* row_ptr, const void* order,
                             void* state, long long num_rows, long long d,
                             long long num_records, void* scratch, void* stream) {
  return repro_torch::launch_row_sum<int32_t, true>(msg, row_ptr, order, state, num_rows, d,
                                                    num_records, scratch, stream);
}

extern "C" int delta_agg_i64(const void* msg, const void* row_ptr, const void* order,
                             void* state, long long num_rows, long long d,
                             long long num_records, void* scratch, void* stream) {
  return repro_torch::launch_row_sum<int64_t, true>(msg, row_ptr, order, state, num_rows, d,
                                                    num_records, scratch, stream);
}
