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
- the dispatch gather has a backward of its own (:class:`_Dispatch`): each
  token's gradient is the sum of its records' gradients through the same
  :func:`combine`, so in ``segment_spmm`` in (expert, slot) order, with no
  ``index_put`` and no float atomics (autograd's gradient of an index is an
  accumulating ``index_put_``, whose order is not fixed);
- the Switch aux loss is ``e · Σ (top-1 count / B·S) · (prob sum / B·S)``,
  each factor a sum over the whole batch divided once (the reference takes
  two means; the same value to fp32 rounding);
- the reference's sharding annotations (``ashard``) of the dispatched
  tokens and the experts' outputs stand at its points, with the axes in the
  port's layout (experts over "tp", batch rows over "dp").  They are the
  identity outside a mesh.  Under one (:func:`moe_apply`) the routing, the
  gather and the combine run on each rank's batch rows, and the aux loss's
  two batch sums are reduced over the batch's split before their product.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist.ctx import ashard, local_apply
from repro_torch.kernels.segment_spmm import segment_spmm
from repro_torch.nn import param as pm
from repro_torch.nn.layers import swiglu


def init_moe(gen: torch.Generator, layers: int, d_model: int, d_ff: int, num_experts: int,
             dtype=torch.float32, num_shared: int = 0, shared_d_ff: int = 0
             ) -> Dict[str, pm.Param]:
    """The reference's ``init_moe`` on ``gen``'s device, with its logical
    axes: the router ``[L, D, E]`` (always fp32), ``wi``/``wg`` ``[L, E, D, F]``
    with std ``D^-1/2``, ``wo`` ``[L, E, F, D]`` with std ``F^-1/2`` and, with
    ``num_shared``, the dense ``shared_{wi,wg,wo}``."""
    experts = ("layers", "experts")
    p = {
        "router": pm.stacked_dense(gen, layers, (d_model, num_experts), ("embed", None),
                                   torch.float32),
        "wi": pm.normal(gen, (layers, num_experts, d_model, d_ff), d_model ** -0.5,
                        (*experts, "embed", "mlp"), dtype),
        "wg": pm.normal(gen, (layers, num_experts, d_model, d_ff), d_model ** -0.5,
                        (*experts, "embed", "mlp"), dtype),
        "wo": pm.normal(gen, (layers, num_experts, d_ff, d_model), d_ff ** -0.5,
                        (*experts, "mlp", "embed"), dtype),
    }
    if num_shared:
        p["shared_wi"] = pm.stacked_dense(gen, layers, (d_model, shared_d_ff), ("embed", "mlp"),
                                          dtype)
        p["shared_wg"] = pm.stacked_dense(gen, layers, (d_model, shared_d_ff), ("embed", "mlp"),
                                          dtype)
        p["shared_wo"] = pm.stacked_dense(gen, layers, (shared_d_ff, d_model), ("mlp", "embed"),
                                          dtype)
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


def _route_rows(router: torch.Tensor, x: torch.Tensor, top_k: int, cap: int):
    """The router and each (expert, row)'s choice of ``cap`` tokens, all of
    it local to a batch row: ``(sel_idx, sel_score [E, B, C], probs [B, S,
    E], top1 [B, S, E])``, ``top1`` the one-hot of each token's first expert
    as fp32 (the aux loss's batch sums are taken from the last two)."""
    e = router.shape[1]
    probs = torch.softmax(x.float() @ router, dim=-1)  # [B, S, E]
    gate_vals, gate_idx = _top(probs, top_k)  # [B, S, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # [B, S, E] gate of each routed (token, expert), 0 elsewhere; the k
    # indices of a token are distinct, so the scatter writes each entry once
    routed = torch.zeros_like(probs).scatter(-1, gate_idx, gate_vals)
    sel_score, sel_idx = _top(routed.permute(2, 0, 1), cap)
    return sel_idx, sel_score, probs, F.one_hot(gate_idx[..., 0], e).float()


def _switch_aux(probs: torch.Tensor, top1: torch.Tensor) -> torch.Tensor:
    """Switch: e · Σ_e (share of tokens whose top-1 is e) · (mean prob of e),
    each share a sum over the whole batch divided by its B·S tokens (under a
    mesh the sums are reduced over the batch's split before the product)."""
    b, s, e = probs.shape
    n = b * s
    return e * torch.sum((top1.sum((0, 1)) / n) * (probs.sum((0, 1)) / n))


def route(router: torch.Tensor, x: torch.Tensor, top_k: int, capacity_factor: float) -> Routing:
    """Router, aux loss and per-(expert, row) token choice (the reference's
    ``:74-92``).  router ``[D, E]`` fp32; x ``[B, S, D]``."""
    _, s, _ = x.shape
    e = router.shape[1]
    sel_idx, sel_score, probs, top1 = _route_rows(router, x, top_k,
                                                  capacity(capacity_factor, top_k, s, e))
    return Routing(sel_idx, sel_score, sel_score > 0.0, _switch_aux(probs, top1))


def _schedule(key: torch.Tensor, num_rows: int):
    """The row schedule of records keyed ``key`` (``num_rows`` = dropped),
    built on key's device from integer ops with no read back to the host: a
    stable sort (a row's records keep their order; dropped ones sort last)
    and ``row_ptr[r]`` = the number of keys below r, by ``searchsorted``
    over the sorted keys (``bincount`` on the card reads its largest key
    back to size its output)."""
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_rows + 1, device=key.device, dtype=key.dtype)
    return order, torch.searchsorted(sorted_key, bounds)


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
    ``[N]`` int64 in ``[0, num_rows]``; the schedule is :func:`_schedule`'s."""
    order, row_ptr = _schedule(key, num_rows)
    return _Combine.apply(y, key, order, row_ptr)


class _Dispatch(torch.autograd.Function):
    """The gather of each record's token, with the transposed sum as its
    gradient: ``xs[i] = x[key[i]]`` (0 for a dropped record, ``key[i] ==
    N``); the gradient of token r is the sum of its records' gradients, in
    record order from 0, through :func:`combine` (``segment_spmm``): the
    forward combine's sum the other way round, deterministic by
    construction, with no ``index_put`` and no float atomics.  The sum is
    taken in fp32 and cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, key):
        ctx.save_for_backward(key)
        ctx.rows = x.shape[0]
        return torch.cat([x, x.new_zeros((1, x.shape[1]))])[key]

    @staticmethod
    def backward(ctx, grad):
        (key,) = ctx.saved_tensors
        return combine(grad.float().contiguous(), key, ctx.rows).to(grad.dtype), None


def _record_keys(sel_idx: torch.Tensor, valid: torch.Tensor, s: int) -> torch.Tensor:
    """Record (e, b, c)'s token row ``b·S + sel_idx``, or ``B·S`` (dropped)
    where its slot is empty; flat, in (expert, row, slot) order."""
    b = sel_idx.shape[1]
    rows = torch.arange(b, device=sel_idx.device)[None, :, None] * s + sel_idx
    return torch.where(valid, rows, b * s).reshape(-1)


def _dispatch_rows(router: torch.Tensor, x: torch.Tensor, top_k: int, cap: int):
    """Routing and the group-local gather, local to a batch row: ``(xs [E, B,
    C, D] in x's dtype, empty slots 0; sel_idx, sel_score, valid [E, B, C];
    probs, top1 [B, S, E])``."""
    b, s, d = x.shape
    sel_idx, sel_score, probs, top1 = _route_rows(router, x, top_k, cap)
    valid = sel_score > 0.0
    xs = _Dispatch.apply(x.reshape(b * s, d), _record_keys(sel_idx, valid, s))
    return xs.reshape(*sel_idx.shape, d), sel_idx, sel_score, valid, probs, top1


def _combine_rows(y: torch.Tensor, sel_idx: torch.Tensor, valid: torch.Tensor, s: int):
    """The combine of y [E, B·C, D] (fp32) into [B, S, D], local to a batch row."""
    b = sel_idx.shape[1]
    key = _record_keys(sel_idx, valid, s)
    return combine(y.reshape(-1, y.shape[-1]).contiguous(), key, b * s).reshape(b, s, y.shape[-1])


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25):
    """One layer's MoE block: ``(out [B, S, D] in x's dtype, aux)``.  ``p`` is
    the layer's slice (``router`` ``[D, E]``, ``wi``/``wg`` ``[E, D, F]``,
    ``wo`` ``[E, F, D]``, optionally ``shared_*``); the batch row is the
    dispatch group, as in the reference.

    Under a mesh the routing, the gather and the combine run on each rank's
    batch rows (:func:`repro_torch.dist.ctx.local_apply`, the rows over
    "dp"); the experts' products run on DTensors with the experts over
    "tp"; the combine reads each row's records whole over "tp", so every
    token sums them in (expert, slot) order as on one device."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    cap = capacity(capacity_factor, top_k, s, e)
    dt = torch.promote_types(x.dtype, p["wi"].dtype)
    rows = ("dp",)
    records = (None, "dp")
    xs, sel_idx, sel_score, valid, probs, top1 = local_apply(
        lambda r, xx: _dispatch_rows(r, xx, top_k, cap), (p["router"], x), ((), rows),
        (records, records, records, records, rows, rows))
    xs = ashard(xs.to(dt).reshape(e, b * cap, d), "tp", "dp")
    h = F.silu(xs @ p["wg"]) * (xs @ p["wi"])  # [E, B·C, F]
    y = ashard((h @ p["wo"]) * sel_score.reshape(e, b * cap, 1).to(dt), "tp", "dp")  # [E, B·C, D]

    # combine: record (e, b, c) adds to token b·S + sel_idx; a token's records
    # come in (expert, slot) order, the reference's segment_sum order
    out = local_apply(lambda yy, si, va: _combine_rows(yy, si, va, s),
                      (y.float(), sel_idx, valid), (records, records, records), (rows,))
    out = out.to(dt)
    if "shared_wi" in p:
        out = out + swiglu(x.to(dt), p["shared_wg"], p["shared_wi"], p["shared_wo"])
    return out.to(x.dtype), _switch_aux(probs, top1)
