"""Functional NN building blocks: norms, MLPs, RoPE, embeddings, the loss.

The counterparts of ``repro.nn.layers`` with the same dtype behaviour:
:func:`rms_norm` normalises in fp32, casts back to x's dtype and then
multiplies by gamma, so a bf16 x times an fp32 gamma is fp32 (PyTorch
promotes as JAX does)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.ctx import ashard, local_apply, replicate_like


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


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
    # the product over the split features is a partial sum on each rank: reduced
    # here, or DTensor carries the partial into the next block's products, which
    # then run whole on every rank
    return ashard((F.silu(g) * u) @ w_down, "dp")


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor) -> torch.Tensor:
    """[*, head_dim/2] rotation angles for the given positions (fp32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    return positions[..., None].float() * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, H, S, D]; angles: [S, D/2] or [B, S, D/2].  Rotates the two
    halves of the head dim (not interleaved pairs)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if angles.dim() == 2:
        cos, sin = torch.cos(angles)[None, None], torch.sin(angles)[None, None]
    else:
        cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    cos, sin = replicate_like(cos, x), replicate_like(sin, x)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  Under a mesh (DTensors) the rows are read locally
    (:func:`repro_torch.dist.ctx.local_apply`): the ids batch over "dp" (the
    rest whole), the table gathered whole, each rank indexing its own rows;
    the table's gradient comes back as a partial sum over the ranks that
    split the ids, which the gather's backward reduces and scatters to the
    table's placements.  (DTensor's own strategy for the index's backward,
    ``index_put``, fails in PyTorch 2.11.)"""
    return local_apply(lambda t, i: t[i], (table, ids), ((), ("dp",)), (("dp",),))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy; logits [.., V] in fp32 (log-sum-exp
    less the label's logit), averaged over ``mask`` where it is given.  Under
    a mesh the label's logit is read on each rank's rows
    (:func:`repro_torch.dist.ctx.local_apply`): DTensor's rule for the
    gather's backward builds a zero gradient of the global shape on every
    rank."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    rows = ("dp",) + (None,) * (lg.ndim - 1)
    ll = local_apply(lambda t, y: t.gather(-1, y[..., None].long())[..., 0], (lg, labels),
                     (rows, rows[:-1]), (rows[:-1],))
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
