"""Plain PyTorch oracles with the semantics of ``repro.kernels.ref``.

The segment ops take destination ids with ``-1`` padding (dropped), exactly
like the reference's ``segment_spmm_ref``/``delta_agg_ref``/``edge_softmax_ref``.
:func:`flash_attention_ref` is the plain version of the attention kernel
(``repro_torch.kernels.flash_attention``), :func:`flash_attention_lse_ref`
the same with the row log-sum-exp that training saves, and
:func:`flash_attention_bwd_ref` the plain version of its backward kernels.
They run on any device; the port's engine reaches them only through the
CPU path of the kernel wrappers (``repro_torch.kernels.segment_spmm`` /
``delta_agg``, ``flash_attention``).  On the CPU
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
    return flash_attention_lse_ref(q, k, v, causal, window, q_offset)[0]


def _visible(sq: int, sk: int, causal: bool, window: Optional[int], q_offset: int,
             device) -> torch.Tensor:
    """[Sq, Sk] mask of the keys each query row may see."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True, window: Optional[int] = None,
                            q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref` and the row log-sum-exp of its scaled,
    masked scores: ``(o, lse)``, lse fp32 ``[B, H, Sq]``, ``-inf`` for a row
    that sees no key.  ``o`` is :func:`flash_attention_ref`'s, bit for bit."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.reshape(b, hkv, g, sq, d).to(k.dtype).float()
    kf, vf = k.float(), v.float()

    def attend(q_chunk, off):
        logits = torch.einsum("bhgqd,bhkd->bhgqk", q_chunk, kf) / math.sqrt(d)
        m = _visible(q_chunk.shape[3], sk, causal, window, off, q.device)
        logits = logits.masked_fill(~m, -math.inf)
        probs = torch.softmax(logits, dim=-1)
        probs = torch.where(probs.isnan(), 0.0, probs)
        out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(), vf)
        return out, torch.logsumexp(logits, dim=-1)

    chunk = 2048
    if sq > chunk and sq % chunk == 0:
        parts = [attend(qf[:, :, :, i:i + chunk], q_offset + i) for i in range(0, sq, chunk)]
        out = torch.cat([o for o, _ in parts], dim=3)
        lse = torch.cat([s for _, s in parts], dim=3)
    else:
        out, lse = attend(qf, q_offset)
    return out.reshape(b, h, sq, d).to(q.dtype), lse.reshape(b, h, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True, window: Optional[int] = None,
                            q_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention_ref` from its output ``o``,
    row log-sum-exp ``lse`` and the output's gradient ``do``: ``(dq, dk,
    dv)`` in the dtypes of q, k, v.  The FlashAttention-2 steps, in fp32:

        P  = exp(S · scale − lse) on the visible keys, 0 elsewhere
        dV = Pᵀ · dO        dP = dO · Vᵀ        D = rowsum(dO ∘ O)
        dS = P ∘ (dP − D)   dQ = dS · K · scale  dK = dSᵀ · Q · scale

    with dK and dV summed over the g = Hq / Hkv query heads of each KV
    head.  A row that sees no key has zero gradients."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, hkv, g, sq, d).float()
    of = o.reshape(b, hkv, g, sq, d).float()
    dof = do.reshape(b, hkv, g, sq, d).float()
    kf, vf = k.float(), v.float()
    m = _visible(sq, sk, causal, window, q_offset, q.device)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    p = torch.where(m, torch.exp(s - lse.reshape(b, hkv, g, sq, 1).float()), 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
