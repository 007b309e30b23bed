"""Mixture-of-Experts layer: GShard capacity dispatch with a deterministic combine.

The counterpart of ``repro.nn.moe``, line for line: top-k routing with the
Switch aux loss, a capacity of ``C = min(int(capacity_factor · top_k · S / E)
+ 1, S)`` tokens per (batch row, expert), the first C routed tokens of each
(row, expert) by score gathered into a dispatch tensor, the experts' SwiGLU
MLPs as batched products, and the results summed back per token.  Tokens
past an expert's capacity are dropped (GShard).

Differences of form, none of result:

- ties: ``jax.lax.top_k`` puts the lower index first among equal values;
  here a stable descending sort, sliced, does the same (``torch.topk``
  promises no order);
- layout: the dispatch tensor is ``[E, B, C, D]`` (the reference's is
  ``[B, E, C, D]``), so each expert's rows are one contiguous batch of the
  products and no transpose is copied;
- the combine (the reference's ``segment_sum``) runs in
  :func:`repro_torch.kernels.segment_spmm.segment_spmm`: the hand-written
  row-sum kernel on the card, its plain version on the CPU.  A token's
  records are summed in (expert, slot) order from 0, the reference's order;
  no float atomics, so the output is the same bits from run to run.  The
  kernel sums fp32: where the experts' output is not fp32 (bf16 params) it
  is cast to fp32 for the sum and back after, where the reference sums in
  that dtype (a deliberate divergence, no config of the repo reaches it);
- the reference's sharding annotations (``ashard``) are not here (ROADMAP.md
  item 10g).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.segment_spmm import segment_spmm
from repro_torch.nn.layers import stacked_dense, swiglu


def init_moe(gen: torch.Generator, layers: int, d_model: int, d_ff: int, num_experts: int,
             dtype=torch.float32, num_shared: int = 0, shared_d_ff: int = 0
             ) -> Dict[str, torch.Tensor]:
    """The reference's ``init_moe`` on ``gen``'s device: the router ``[L, D, E]``
    (always fp32), ``wi``/``wg`` ``[L, E, D, F]`` with std ``D^-1/2``, ``wo``
    ``[L, E, F, D]`` with std ``F^-1/2`` and, with ``num_shared``, the dense
    ``shared_{wi,wg,wo}``.  Scaled in place: the expert stacks are the
    largest tensors of a model."""
    dev = gen.device

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev).mul_(std)

    p = {
        "router": stacked_dense(gen, layers, (d_model, num_experts), torch.float32),
        "wi": normal((layers, num_experts, d_model, d_ff), d_model ** -0.5),
        "wg": normal((layers, num_experts, d_model, d_ff), d_model ** -0.5),
        "wo": normal((layers, num_experts, d_ff, d_model), d_ff ** -0.5),
    }
    if num_shared:
        p["shared_wi"] = stacked_dense(gen, layers, (d_model, shared_d_ff), dtype)
        p["shared_wg"] = stacked_dense(gen, layers, (d_model, shared_d_ff), dtype)
        p["shared_wo"] = stacked_dense(gen, layers, (shared_d_ff, d_model), dtype)
    return p


def _top(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values, the lower
    index first among equal ones."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(capacity_factor: float, top_k: int, s: int, e: int) -> int:
    """Tokens an expert takes per batch row (``src/repro/nn/moe.py:84``)."""
    return min(int(capacity_factor * top_k * s / e) + 1, s)


class Routing(NamedTuple):
    sel_idx: torch.Tensor  # [E, B, C] token of each (expert, row, slot)
    sel_score: torch.Tensor  # [E, B, C] its normalised gate, 0 where the slot is empty
    valid: torch.Tensor  # [E, B, C] bool: sel_score > 0
    aux: torch.Tensor  # () fp32 Switch load-balancing loss


def route(router: torch.Tensor, x: torch.Tensor, top_k: int, capacity_factor: float) -> Routing:
    """Router, aux loss and per-(expert, row) token choice (the reference's
    ``:74-92``).  router ``[D, E]`` fp32; x ``[B, S, D]``."""
    b, s, _ = x.shape
    e = router.shape[1]
    probs = torch.softmax(x.float() @ router, dim=-1)  # [B, S, E]
    gate_vals, gate_idx = _top(probs, top_k)  # [B, S, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Switch: e · Σ_e (share of tokens whose top-1 is e) · (mean prob of e)
    frac = F.one_hot(gate_idx[..., 0], e).float().mean((0, 1))
    aux = e * torch.sum(frac * probs.mean((0, 1)))

    # [B, S, E] gate of each routed (token, expert), 0 elsewhere; the k
    # indices of a token are distinct, so the scatter writes each entry once
    routed = torch.zeros_like(probs).scatter(-1, gate_idx, gate_vals)
    sel_score, sel_idx = _top(routed.permute(2, 0, 1), capacity(capacity_factor, top_k, s, e))
    return Routing(sel_idx, sel_score, sel_score > 0.0, aux)


class _Combine(torch.autograd.Function):
    """``segment_spmm`` over a schedule, with the gradient of a gather: each
    record's gradient is its row's, 0 for a dropped record."""

    @staticmethod
    def forward(ctx, y, key, order, row_ptr):
        ctx.save_for_backward(key)
        return segment_spmm(y, row_ptr, order, row_ptr.shape[0] - 1)

    @staticmethod
    def backward(ctx, grad):
        (key,) = ctx.saved_tensors
        grad = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return grad[key], None, None, None


def combine(y: torch.Tensor, key: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``out[r] = Σ_{key[i] = r} y[i]``, each row summed in record order from
    0; records with ``key == num_rows`` are dropped.  y ``[N, D]`` fp32, key
    ``[N]`` int64 in ``[0, num_rows]``.

    The row schedule is built on y's device from integer ops, with no read
    back to the host: a stable sort of the keys (a row's records keep their
    order; dropped ones sort last), and ``row_ptr[r]`` = the number of keys
    below r, by ``searchsorted`` over the sorted keys (``bincount`` on the
    card reads its largest key back to size its output)."""
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_rows + 1, device=key.device, dtype=key.dtype)
    row_ptr = torch.searchsorted(sorted_key, bounds)
    return _Combine.apply(y, key, order, row_ptr)


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25):
    """One layer's MoE block: ``(out [B, S, D] in x's dtype, aux)``.  ``p`` is
    the layer's slice (``router`` ``[D, E]``, ``wi``/``wg`` ``[E, D, F]``,
    ``wo`` ``[E, F, D]``, optionally ``shared_*``); the batch row is the
    dispatch group, as in the reference."""
    b, s, d = x.shape
    r = route(p["router"], x, top_k, capacity_factor)
    e, _, c = r.sel_idx.shape
    dt = torch.promote_types(x.dtype, p["wi"].dtype)

    # group-local gather [E, B, C, D], empty slots masked to 0
    xs = x[torch.arange(b, device=x.device)[None, :, None], r.sel_idx]
    xs = (xs * r.valid[..., None].to(xs.dtype)).to(dt).reshape(e, b * c, d)
    h = F.silu(xs @ p["wg"]) * (xs @ p["wi"])  # [E, B·C, F]
    y = (h @ p["wo"]) * r.sel_score.reshape(e, b * c, 1).to(dt)  # [E, B·C, D]

    # combine: record (e, b, c) adds to token b·S + sel_idx; a token's records
    # come in (expert, slot) order, the reference's segment_sum order
    rows = torch.arange(b, device=x.device)[None, :, None] * s + r.sel_idx
    key = torch.where(r.valid, rows, b * s).reshape(-1)
    out = combine(y.reshape(-1, d).float(), key, b * s).reshape(b, s, d).to(dt)

    if "shared_wi" in p:
        out = out + swiglu(x.to(dt), p["shared_wg"], p["shared_wi"], p["shared_wo"])
    return out.to(x.dtype), r.aux
