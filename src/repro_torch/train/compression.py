"""Gradient compression for the data-parallel all-reduce: the counterpart of
``repro.train.compression``.

Two compressors, both with **error feedback** (the residual of the lossy
round is added back before the next compression, Karimireddy et al. 2019):

  * int8 per-tensor symmetric quantization (4× fewer wire bytes than fp32),
    rounding half to even (``torch.round``, as ``jnp.round``);
  * top-k magnitude sparsification, k a fraction of the elements
    (``torch.topk``).

``CompressedState`` carries the residuals as a tree shaped like the grads.
``compress_grads`` returns the grads after a round trip through the
compressor — what the receiving side of the all-reduce would apply — so
the optimizer sees the lossy gradient."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.train.tree import tree_leaves, tree_map, tree_unzip


class CompressedState(NamedTuple):
    residual: Any


def init_state(grads_template) -> CompressedState:
    return CompressedState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_template))


def _int8_roundtrip(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g - deq


def _topk_roundtrip(g: torch.Tensor, frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = torch.topk(flat.abs(), k).indices
    kept = torch.zeros_like(flat).index_put_((idx,), flat[idx]).reshape(g.shape)
    return kept, g - kept


@torch.no_grad()
def compress_grads(grads, state: CompressedState, method: str = "int8",
                   topk_frac: float = 0.05):
    """Returns (lossy grads as applied, new state, wire bytes estimate)."""

    def one(g, r):
        gf = g.float() + r
        if method == "int8":
            deq, res = _int8_roundtrip(gf)
            wire = gf.numel()  # 1 byte an element
        elif method == "topk":
            deq, res = _topk_roundtrip(gf, topk_frac)
            wire = int(gf.numel() * topk_frac) * 8  # value + index
        else:
            raise ValueError(method)
        return deq.to(g.dtype), res, wire

    lossy, res, wires = tree_unzip(tree_map(one, grads, state.residual), 3)
    return lossy, CompressedState(residual=res), sum(tree_leaves(wires))
