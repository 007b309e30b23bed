"""Functional NN building blocks: norms, MLPs, RoPE, embeddings, the loss.

The counterparts of ``repro.nn.layers`` with the same dtype behaviour:
:func:`rms_norm` normalises in fp32, casts back to x's dtype and then
multiplies by gamma, so a bf16 x times an fp32 gamma is fp32 (PyTorch
promotes as JAX does)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.ctx import ashard, local_apply, replicate_like, vocab_split


#: fp32 bytes of x that :func:`rms_norm` or :func:`apply_rope` converts at a time
#: when autograd records nothing
SLICE_BYTES = 1 << 26


def _slice_rows(x: torch.Tensor, *params: torch.Tensor) -> Optional[int]:
    """Rows along dim −2 of a slice of x for a function of each row alone, or
    None to run it whole: where autograd records nothing (serving) and x (a
    rank's shard of it under a mesh) holds more than :data:`SLICE_BYTES` of
    fp32, so that no whole fp32 copy of x is made (a 32k-token prefill's
    would outweigh its activations)."""
    if x.ndim < 2 or (torch.is_grad_enabled()
                      and any(t.requires_grad for t in (x, *params))):
        return None
    if any(pl.is_shard(x.ndim - 2) for pl in getattr(x, "placements", ())):
        return None
    local = getattr(x, "_local_tensor", x)
    row_bytes = 4 * local.numel() // max(local.shape[-2], 1)
    rows = max(SLICE_BYTES // max(row_bytes, 1), 1)
    return rows if rows < x.shape[-2] else None


def _rms(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x normalised over its last dim in fp32, in slices of rows where
    :func:`_slice_rows` gives them (the same ops on every row)."""
    rows = _slice_rows(x, gamma)
    if rows is None:
        return _rms(x, gamma, eps)
    return torch.cat([_rms(c, gamma, eps) for c in x.split(rows, dim=-2)], dim=-2)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = ashard(x @ w_gate, "dp", None, "tp")
    u = ashard(x @ w_up, "dp", None, "tp")
    del x  # a serving step frees its normed input before the reduction below
    # the product over the split features is a partial sum on each rank: reduced
    # here, or DTensor carries the partial into the next block's products, which
    # then run whole on every rank
    return ashard((F.silu(g) * u) @ w_down, "dp")


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor) -> torch.Tensor:
    """[*, head_dim/2] rotation angles for the given positions (fp32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    return positions[..., None].float() * inv


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, H, S, D]; angles: [S, D/2] or [B, S, D/2].  Rotates the two
    halves of the head dim (not interleaved pairs), in slices of positions
    where :func:`_slice_rows` gives them."""
    if angles.dim() == 2:
        cos, sin = torch.cos(angles)[None, None], torch.sin(angles)[None, None]
    else:
        cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    cos, sin = replicate_like(cos, x), replicate_like(sin, x)
    rows = _slice_rows(x)
    if rows is None:
        return _rotate(x, cos, sin)
    return torch.cat([_rotate(*parts) for parts in zip(x.split(rows, dim=-2),
                                                      cos.split(rows, dim=-2),
                                                      sin.split(rows, dim=-2))], dim=-2)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  Under a mesh (DTensors) the rows are read locally
    (:func:`repro_torch.dist.ctx.local_apply`): the ids batch over "dp" (the
    rest whole), the table gathered whole, each rank indexing its own rows;
    the table's gradient comes back as a partial sum over the ranks that
    split the ids, which the gather's backward reduces and scatters to the
    table's placements.  (DTensor's own strategy for the index's backward,
    ``index_put``, fails in PyTorch 2.11.)"""
    return local_apply(lambda t, i: t[i], (table, ids), ((), ("dp",)), (("dp",),))


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced with ``op`` ("max" or "sum") over ``group``; ``t`` itself
    when ``group`` is None."""
    if group is None:
        return t
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


def _label_index(labels: torch.Tensor, offset: int, v: int):
    """(each label's column in a vocab slice of ``v`` entries from ``offset``,
    clamped into it; whether the slice holds the label)."""
    idx = labels.long() - offset
    return idx.clamp(0, v - 1)[..., None], ((idx >= 0) & (idx < v))[..., None]


class _VocabXent(torch.autograd.Function):
    """Per-row ``logsumexp(x) − x[label]`` in fp32 over logits whose last dim
    is split over ``group`` (None: whole), this rank's slice starting at
    vocab entry ``offset``.  The forward all-reduces the row max, the sum of
    ``exp(x − max)`` and the label's logit (read on the rank that holds it);
    the backward is local, ``(exp(x − lse) − onehot) · g`` in one fp32
    buffer cast to the logits' dtype.  It saves the logits in their own
    dtype, the labels and ``lse``."""

    @staticmethod
    def forward(ctx, x, labels, offset, group):
        m = _all_reduce(x.amax(dim=-1).float(), "max", group)
        e = x.to(torch.float32, copy=True)
        s = _all_reduce(e.sub_(m[..., None]).exp_().sum(dim=-1), "sum", group)
        lse = m + torch.log(s)
        idx, own = _label_index(labels, offset, x.shape[-1])
        ll = torch.where(own, x.gather(-1, idx).float(), 0.0)[..., 0]
        ll = _all_reduce(ll, "sum", group)
        ctx.save_for_backward(x, labels, lse)
        ctx.offset = offset
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        x, labels, lse = ctx.saved_tensors
        d = x.to(torch.float32, copy=True)
        d.sub_(lse[..., None]).exp_()
        idx, own = _label_index(labels, ctx.offset, x.shape[-1])
        d.scatter_add_(-1, idx, -own.to(d.dtype))
        d.mul_(g[..., None])
        return d.to(x.dtype), None, None, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy; logits [.., V] in fp32 (log-sum-exp
    less the label's logit), averaged over ``mask`` where it is given.
    Under a mesh the logits stay split over the vocab ("tp", unevenly where
    it does not divide V) and each rank reads its own slice
    (:class:`_VocabXent` through :func:`repro_torch.dist.ctx.local_apply`,
    whose collectives run on plain local tensors): no rank holds a whole
    vocab row, and no DTensor op touches a vocab-split one."""
    logits, group, offset = vocab_split(logits)
    rows = ("dp",) + (None,) * (logits.ndim - 2)
    nll = local_apply(lambda x, y: _VocabXent.apply(x, y, offset, group), (logits, labels),
                      (rows + ("tp",), rows), (rows,), uneven=("tp",))
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
