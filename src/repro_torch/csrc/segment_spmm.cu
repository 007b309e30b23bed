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
// 3.35 TB/s, against ≈ 1.3 GFLOP of adds.  On a power-law graph the bytes are the same
// but one hub row holds 10^4–10^5 records, so what bounds it there is how evenly the
// records spread over the card.
//
// What the design does about it (row_sum.cuh): a warp owns a row of at most 512
// records (kChunk, the TPU kernel's edge block) and walks its records once for all
// columns, lanes on consecutive columns (coalesced), 32 record ids a load shared by
// shuffle, four records' loads in flight; a longer row is cut into 512-record chunks,
// each summed by its own warp into a scratch slot, and a second pass adds a row's
// chunk sums in chunk order.  Each row's order of additions is a function of its own
// records, so the result is the same bits whatever the grid, the row count or the
// row's offset; rows of at most 512 records keep the single k-order chain.  The
// scratch (2·⌈E/512⌉ slots of D floats) is sized from E, which the host knows, so
// the wrapper never waits on the card.  Known gaps, left for a later change: every
// window's two chunk warps search row_ptr even where no row is long; a warp owns a
// short row of one or two records alone; no 16-byte vector loads (D = 129 rows are
// not 16-byte aligned); and the [ctx | raw] gather from the edge messages is not
// fused in.
#include "row_sum.cuh"

extern "C" int segment_spmm_i32(const void* msg, const void* row_ptr, const void* order,
                                void* out, long long num_rows, long long d,
                                long long num_records, void* scratch, void* stream) {
  return repro_torch::launch_row_sum<int32_t, false>(msg, row_ptr, order, out, num_rows, d,
                                                     num_records, scratch, stream);
}

extern "C" int segment_spmm_i64(const void* msg, const void* row_ptr, const void* order,
                                void* out, long long num_rows, long long d,
                                long long num_records, void* scratch, void* stream) {
  return repro_torch::launch_row_sum<int64_t, false>(msg, row_ptr, order, out, num_rows, d,
                                                     num_records, scratch, stream);
}
