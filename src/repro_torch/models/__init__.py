"""Model zoo API of the port: init / loss / forward / prefill / decode per
architecture, the counterpart of ``repro.models`` for the dense, MoE, hymba,
xLSTM and encoder-decoder families.

``batch`` is a dict with ``"tokens"`` ``[B, S]`` (int tensor on the
parameters' device), as in the reference; an encoder-decoder config
(``cfg.encdec``) also takes ``"frames"`` ``[B, S_src, d_frontend]``, a vlm
(``cfg.num_patches``) ``"patches"`` ``[B, P, d_frontend]``, which stand
before the tokens (the logits cover the text only; a prefill's cache holds
P + S positions).  The decode cache is an :class:`LMCache` (K/V; hymba's
also its SSD states and convolution carries), for xLSTM an
:class:`XLSTMCache`, for the encoder-decoder an :class:`EncDecCache`."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as _encdec
from repro_torch.models import lm as _lm
from repro_torch.models.encdec import EncDecCache
from repro_torch.models.lm import LMCache, XLSTMCache


def init_model(gen: torch.Generator, cfg: ArchConfig):
    """Random parameters on ``gen``'s device (the reference's
    ``init_model(key, cfg)`` without the logical-axes tree)."""
    return init_model_with_axes(gen, cfg)[0]


def init_model_with_axes(gen: torch.Generator, cfg: ArchConfig):
    """``(params, axes)``, the reference's ``init_model(key, cfg)``: the
    parameters and the tree of their logical axes
    (:mod:`repro_torch.nn.param`), from the same calls."""
    if cfg.encdec:
        return _encdec.init_encdec_with_axes(gen, cfg)
    return _lm.init_lm_with_axes(gen, cfg)


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, Any]):
    """``(loss, metrics)`` of a batch with ``tokens`` and ``labels`` (and
    ``frames`` or ``patches``): ``{"ce", "aux"}``, for the encoder-decoder
    ``{"ce"}``."""
    if cfg.encdec:
        return _encdec.encdec_loss(params, cfg, batch)
    return _lm.lm_loss(params, cfg, batch)


def forward(params, cfg: ArchConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Logits [B, S, V]: the first of the reference's ``(logits, aux)``
    (``repro_torch.models.lm.forward_with_aux`` gives both)."""
    if cfg.encdec:
        return _encdec.forward(params, cfg, batch["frames"], batch["tokens"])
    return _lm.forward(params, cfg, batch["tokens"], batch.get("patches"))


def prefill(params, cfg: ArchConfig, batch: Dict[str, Any], s_max: int, cache_dtype=None):
    cache_dtype = cache_dtype or torch.bfloat16
    if cfg.encdec:
        return _encdec.prefill(params, cfg, batch["frames"], batch["tokens"], s_max,
                               cache_dtype=cache_dtype)
    return _lm.prefill(params, cfg, batch["tokens"], s_max, cache_dtype=cache_dtype,
                       patches=batch.get("patches"))


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache):
    if cfg.encdec:
        return _encdec.decode_step(params, cfg, token, cache)
    return _lm.decode_step(params, cfg, token, cache)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=None, device="cuda"):
    """An empty decode cache.  An encoder-decoder config raises
    ``ValueError``: its cache holds the cross memory, whose length comes from
    the frames, so :func:`prefill` builds it (the reference's ``init_cache``
    returns a decoder-only LM cache for it, which its decode cannot use)."""
    if cfg.encdec:
        raise ValueError(f"{cfg.name}: an encoder-decoder cache is built by prefill "
                         "(its cross memory's length comes from the frames)")
    return _lm.init_cache(cfg, batch, s_max, dtype or torch.bfloat16, device=device)


__all__ = ["LMCache", "XLSTMCache", "EncDecCache", "init_model", "init_model_with_axes",
           "loss_fn", "forward",
           "prefill", "decode_step", "init_cache"]
