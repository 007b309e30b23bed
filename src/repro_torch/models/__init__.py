"""Model zoo API of the port: init / loss / forward / prefill / decode per
architecture, the counterpart of ``repro.models`` for the dense and MoE LMs.

``batch`` is a dict with ``"tokens"`` ``[B, S]`` (int tensor on the
parameters' device), as in the reference.  Configs of a family not ported
yet (encoder-decoder, hymba, xlstm, vlm) raise ``NotImplementedError``
naming their ROADMAP.md item."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm as _lm
from repro_torch.models.lm import LMCache


def init_model(gen: torch.Generator, cfg: ArchConfig):
    """Random parameters on ``gen``'s device (the reference's
    ``init_model(key, cfg)`` without the logical-axes tree)."""
    return _lm.init_lm(gen, cfg)


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, Any]):
    """``(loss, {"ce", "aux"})`` of a batch with ``tokens`` and ``labels``."""
    return _lm.lm_loss(params, cfg, batch)


def forward(params, cfg: ArchConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Logits [B, S, V]: the first of the reference's ``(logits, aux)``
    (``repro_torch.models.lm.forward_with_aux`` gives both)."""
    return _lm.forward(params, cfg, batch["tokens"])


def prefill(params, cfg: ArchConfig, batch: Dict[str, Any], s_max: int, cache_dtype=None):
    return _lm.prefill(params, cfg, batch["tokens"], s_max,
                       cache_dtype=cache_dtype or torch.bfloat16)


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: LMCache):
    return _lm.decode_step(params, cfg, token, cache)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=None, device="cuda") -> LMCache:
    return _lm.init_cache(cfg, batch, s_max, dtype or torch.bfloat16, device=device)


__all__ = ["LMCache", "init_model", "loss_fn", "forward", "prefill", "decode_step",
           "init_cache"]
