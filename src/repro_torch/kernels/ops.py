"""Public kernel ops of the port: the counterpart of ``repro.kernels.ops``.

Every op dispatches on the device of its tensors: a CPU tensor goes to the
plain PyTorch version, a CUDA tensor to the hand-written kernel.  The JAX
package's ``FORCE_PALLAS_INTERPRET`` switch has no counterpart: a CUDA
kernel has no interpret mode, and the device alone decides.

* :func:`segment_spmm` / :func:`delta_agg` take a row schedule
  (``row_ptr`` + optional ``order``); the engine calls these.
* :func:`segment_sum_edges` / :func:`delta_agg_update` keep the reference
  ops' signatures (host destination ids, sorted, ``-1`` padding allowed) and
  build the row schedule on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.delta_agg import delta_agg
from repro_torch.kernels.segment_spmm import prepare_row_schedule, segment_spmm

__all__ = [
    "segment_spmm",
    "delta_agg",
    "prepare_row_schedule",
    "segment_sum_edges",
    "delta_agg_update",
]


def _schedule(dst: np.ndarray, num_rows: int, device: torch.device):
    order, row_ptr = prepare_row_schedule(dst, num_rows)
    return (torch.from_numpy(row_ptr).to(device), torch.from_numpy(order).to(device))


def segment_sum_edges(messages: torch.Tensor, dst: np.ndarray, num_rows: int) -> torch.Tensor:
    """out[v] = Σ_{dst[e]=v} messages[e] — the aggregation hot spot."""
    if messages.device.type == "cpu":
        return kref.segment_spmm_ref(messages, torch.as_tensor(np.asarray(dst)), num_rows)
    row_ptr, order = _schedule(dst, num_rows, messages.device)
    return segment_spmm(messages.contiguous(), row_ptr, order, num_rows)


def delta_agg_update(state: torch.Tensor, messages: torch.Tensor, dst: np.ndarray) -> torch.Tensor:
    """state[dst[e]] += messages[e] on a copy of ``state``; returns the copy."""
    if state.device.type == "cpu":
        return kref.delta_agg_ref(state, messages, torch.as_tensor(np.asarray(dst)))
    row_ptr, order = _schedule(dst, state.shape[0], state.device)
    return delta_agg(state.clone(), messages.contiguous(), row_ptr, order)
