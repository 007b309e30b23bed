"""Public kernel ops of the port: the counterpart of ``repro.kernels.ops``.

Every op dispatches on the device of its tensors: a CPU tensor goes to the
plain PyTorch version, a CUDA tensor to the hand-written kernel.  The JAX
package's ``FORCE_PALLAS_INTERPRET`` switch has no counterpart: a CUDA
kernel has no interpret mode, and the device alone decides.

* :func:`segment_spmm` / :func:`delta_agg` take a row schedule
  (``row_ptr`` + optional ``order``); the engine calls these.
* :func:`segment_sum_edges` / :func:`delta_agg_update` / :func:`edge_softmax`
  keep the reference ops' data arguments (host destination ids, ``-1``
  padding allowed) and build the row schedule on the host; the reference's
  TPU tile sizes (``tv``/``be``/``bd``/``bh``) have no counterpart.
* :func:`flash_attention` keeps the reference op's arguments but the tile
  sizes ``bq``/``bk``; the LM's ``attention_core`` calls it for every
  prefill and full forward, and differentiates it (the backward kernels)
  in training; :func:`flash_attention_lse` also returns the row
  log-sum-exp that the backward reads.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.delta_agg import delta_agg
from repro_torch.kernels.edge_softmax import edge_softmax_normalize
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_lse
from repro_torch.kernels.segment_spmm import prepare_row_schedule, segment_spmm

__all__ = [
    "segment_spmm",
    "delta_agg",
    "prepare_row_schedule",
    "segment_sum_edges",
    "delta_agg_update",
    "edge_softmax",
    "flash_attention",
    "flash_attention_lse",
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


def edge_softmax(scores: torch.Tensor, dst: np.ndarray,
                 num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAT edge softmax: (normalized scores [E, H] in the caller's edge order,
    attention sums [num_rows, H]).  ``scores`` are raw exp-scores; ``dst``
    host ids in ``[-1, num_rows)``, ``-1`` padding (normalized to 0).

    Phase 1 is :func:`segment_spmm` on the row schedule, phase 2
    :func:`edge_softmax_normalize`, on either device: the device of
    ``scores`` picks the kernels or their plain versions."""
    dst = np.asarray(dst)
    if dst.size and (dst.min() < -1 or dst.max() >= num_rows):
        raise ValueError(f"dst must lie in [-1, {num_rows})")
    row_ptr, order = _schedule(dst, num_rows, scores.device)
    sums = segment_spmm(scores.contiguous(), row_ptr, order, num_rows)
    dst_t = torch.from_numpy(dst.astype(np.int64, copy=False)).to(scores.device)
    return edge_softmax_normalize(scores.contiguous(), dst_t, sums), sums
