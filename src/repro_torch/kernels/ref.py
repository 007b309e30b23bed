"""Plain PyTorch oracles with the semantics of ``repro.kernels.ref``.

Each takes destination ids with ``-1`` padding (dropped), exactly like the
reference's ``segment_spmm_ref``/``delta_agg_ref``.  They run on any device;
the port's engine reaches them only through the CPU path of the kernel
wrappers (``repro_torch.kernels.segment_spmm`` / ``delta_agg``).  On the CPU
``index_add_`` adds the records one after another in index order, so the
sums are deterministic there; on a card it would use float atomics, which is
why the engine never calls it on one.
"""
from __future__ import annotations

import torch


def segment_spmm_ref(messages: torch.Tensor, dst: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Sum messages[e] into out[dst[e]]; dst may contain -1 (padding → dropped).

    messages: [E, D] float; dst: [E] int; returns [num_rows, D]."""
    dst = dst.to(messages.device)
    valid = dst >= 0
    seg = torch.where(valid, dst, num_rows).long()
    out = messages.new_zeros((num_rows + 1,) + tuple(messages.shape[1:]))
    out.index_add_(0, seg, messages * valid[:, None].to(messages.dtype))
    return out[:num_rows]


def delta_agg_ref(state: torch.Tensor, messages: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """state[dst[e]] += messages[e] (signed deltas; -1 padding dropped)."""
    return state + segment_spmm_ref(messages, dst, state.shape[0]).to(state.dtype)
