"""``delta_agg``: in-place signed delta aggregation (CUDA, ``sm_90a``).

    state[r] += Σ_{k=row_ptr[r]}^{row_ptr[r+1]-1} messages[order[k]]   (rows with records only)

The port's counterpart of the Pallas TPU kernel
``repro.kernels.delta_agg.delta_agg``: step 1 of the incremental layer adds
each touched row's signed record messages into that row's state, in place,
and touches no row without records (the O(affected) property the TPU kernel
gets from ``input_output_aliases``).  The row schedule is the one
:func:`repro_torch.kernels.segment_spmm.prepare_row_schedule` builds; the
host planner ships it with every packed plan.  Kernel source and its note on
what bounds it: ``repro_torch/csrc/delta_agg.cu``.

:func:`delta_agg` dispatches on the device of ``state``: CPU tensors go to
:func:`delta_agg_plain`, CUDA tensors to the kernel, anything else raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _fake
from repro_torch.kernels._build import ROW_SUM_ARGTYPES, CudaKernel
from repro_torch.kernels.segment_spmm import (
    _check_cuda,
    _fake_row_sum,
    _same_device,
    _launch_row_sum,
    segment_spmm_plain,
)

KERNEL = CudaKernel("delta_agg", {"delta_agg_i32": ROW_SUM_ARGTYPES,
                                 "delta_agg_i64": ROW_SUM_ARGTYPES})


def delta_agg_plain(
    state: torch.Tensor,
    messages: torch.Tensor,
    row_ptr: torch.Tensor,
    order: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: the same per-row sum, added once into the
    rows that have records; returns ``state`` (updated in place).  Rows of
    more than ``ROW_SUM_CHUNK`` records are summed in one chain here and in
    chunks by the kernel (``segment_spmm.row_sum_chunked_plain``)."""
    sums = segment_spmm_plain(messages, row_ptr, order, state.shape[0])
    touched = torch.nonzero(row_ptr[1:] != row_ptr[:-1]).squeeze(1)
    state[touched] += sums[touched]
    return state


def delta_agg(
    state: torch.Tensor,
    messages: torch.Tensor,
    row_ptr: torch.Tensor,
    order: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Add the scheduled row sums of ``messages`` into ``state`` in place;
    returns ``state``.  ``state`` is ``[R, D]`` float32, ``row_ptr`` has
    ``R + 1`` entries."""
    if isinstance(state, _fake.FakeTensor):
        _fake_row_sum("delta_agg", messages, row_ptr, order, state, reads_out=True)
        return state
    dev = state.device
    if dev.type == "cpu":
        _same_device(dev, messages, row_ptr, order)
        return delta_agg_plain(state, messages, row_ptr, order)
    if dev.type != "cuda":
        raise ValueError(f"delta_agg: unsupported device {dev}")
    if state.dtype != torch.float32 or state.dim() != 2 or not state.is_contiguous():
        raise ValueError(
            f"state must be contiguous 2-D float32, got {state.dtype} {tuple(state.shape)}")
    _check_cuda(messages, row_ptr, order, state.shape[0])
    if messages.shape[1] != state.shape[1]:
        raise ValueError(f"messages width {messages.shape[1]} != state width {state.shape[1]}")
    if state.shape[0] == 0 or state.shape[1] == 0:
        return state
    _launch_row_sum(KERNEL, "delta_agg", messages, row_ptr, order, state)
    return state
