"""Plain PyTorch oracles with the semantics of ``repro.kernels.ref``.

The segment ops take destination ids with ``-1`` padding (dropped), exactly
like the reference's ``segment_spmm_ref``/``delta_agg_ref``/``edge_softmax_ref``.
:func:`flash_attention_ref` is the plain version of the attention kernel
(``repro_torch.kernels.flash_attention``).  They run on any device;
the port's engine reaches them only through the CPU path of the kernel
wrappers (``repro_torch.kernels.segment_spmm`` / ``delta_agg``).  On the CPU
``index_add_`` adds the records one after another in index order, so the
sums are deterministic there; on a card it would use float atomics, which is
why the engine never calls it on one.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def edge_softmax_ref(scores: torch.Tensor, dst: torch.Tensor,
                     num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAT edge softmax over raw exp-scores grouped by destination.

    scores: [E, H] raw exp(logits); returns (normalized [E, H], per-row sums
    [num_rows, H]).  As in the reference, a ``-1`` padded edge is divided by
    row 0's sum (the kernel path gives it 0)."""
    dst = dst.to(scores.device)
    sums = segment_spmm_ref(scores, dst, num_rows)
    denom = sums[torch.where(dst >= 0, dst, 0).long()]
    live = denom > 1e-10
    out = torch.where(live, scores / torch.where(live, denom, 1.0), 0.0)
    return out.to(scores.dtype), sums


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Reference attention with GQA head-group broadcast, causal masking and
    an optional sliding window.  q [B, H, Sq, D], k and v [B, Hkv, Sk, D];
    q_offset is the absolute position of q[..., 0, :].  Rows that see no
    key give 0.

    Numerics as the reference's: q is cast to k's dtype and both products
    accumulate in fp32 (operands in their own dtype, upcast: a bf16 product
    is exact in fp32); probabilities are cast to v's dtype before P·V; long
    prefills (Sq > 2048, a multiple of it) go in 2048-row query chunks."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.reshape(b, hkv, g, sq, d).to(k.dtype).float()
    kf, vf = k.float(), v.float()
    kpos = torch.arange(sk, device=q.device)[None, :]

    def attend(q_chunk, off):
        qc = q_chunk.shape[3]
        logits = torch.einsum("bhgqd,bhkd->bhgqk", q_chunk, kf) / math.sqrt(d)
        qpos = off + torch.arange(qc, device=q.device)[:, None]
        m = torch.ones((qc, sk), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        probs = torch.softmax(logits.masked_fill(~m, -math.inf), dim=-1)
        probs = torch.where(probs.isnan(), 0.0, probs)
        return torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(), vf)

    chunk = 2048
    if sq > chunk and sq % chunk == 0:
        out = torch.cat([attend(qf[:, :, :, i:i + chunk], q_offset + i)
                         for i in range(0, sq, chunk)], dim=3)
    else:
        out = attend(qf, q_offset)
    return out.reshape(b, h, sq, d).to(q.dtype)
