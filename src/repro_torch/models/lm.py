"""Decoder-only LM: the dense GQA family (qwen2.5 / granite / llama3.2 /
minicpm) and the MoE family (qwen3-moe, moonshot).

The counterpart of the ``block_pattern == "attn"`` branch of
``repro.models.lm``, dense and MoE.  Parameters are a plain dict of tensors
with the reference's tree and layouts: stacked ``[L, …]`` layer weights under
``blocks`` (``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo[,bq,bk,bv][,q_norm,k_norm]}``,
and either ``mlp.{wg,wi,wo}`` or, for MoE, ``moe.{router,wi,wg,wo[,shared_*]}``
(:mod:`repro_torch.nn.moe`)), ``embed`` ``[V, D]``, ``final_norm`` and, when
the embeddings are not tied, ``lm_head`` ``[D, V]``.  Python loops over the
layers stand where the reference has ``lax.scan``.

Numerics follow the reference: the embedding rows are cast to
``compute_dtype`` and ``rms_norm`` multiplies by an fp32 gamma, so with the
configs' fp32 params the residual stream is fp32 from layer 0's attention
on; the KV cache is ``cache_dtype`` (bf16 unless asked).

Training: :func:`lm_loss` is the reference's next-token cross entropy
plus 0.01 · the MoE aux loss (the layers' mean; 0 for the dense family).
Its gradient flows through ``flash_attention``'s autograd Function, whose
backward is a hand-written kernel on the card, and the MoE combine's.  With ``cfg.remat`` and a gradient to
compute, :func:`forward` wraps each layer in
``torch.utils.checkpoint.checkpoint`` (the reference's ``jax.checkpoint``
of its scan body): only each layer's input is kept, and the backward
recomputes the layer.  Without a gradient, forward and prefill are the
serving path, unchanged.

Hymba and xlstm blocks, the encoder-decoder and the vlm patch frontend are
not ported yet (ROADMAP.md Queue 1 items 10d–10f).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.attention import (
    KVCache,
    attention_apply,
    attention_prefill_kv,
    init_attention,
)
from repro_torch.nn.layers import rms_norm, softmax_xent, stacked_dense, swiglu
from repro_torch.nn.moe import init_moe, moe_apply
from repro_torch.train.tree import tree_leaves

FULL_WINDOW = 1 << 30
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Params = Dict[str, object]


def _check_ported(cfg: ArchConfig) -> None:
    """Raise for a family the port does not serve yet, naming its ROADMAP item."""
    item = ("10e (encoder-decoder)" if cfg.encdec else
            "10d (hymba, xlstm)" if cfg.block_pattern != "attn" else
            "10f (vlm patches)" if cfg.num_patches else None)
    if item:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet (ROADMAP.md Queue 1 item {item})")


# ====================================================================== #
# init
# ====================================================================== #
def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters drawn from ``gen`` on its device, with the
    reference's scales: ``0.02 · normal`` for the embedding,
    ``normal · fan_in^-1/2`` for dense weights, ones for norms, zeros for
    biases."""
    _check_ported(cfg)
    dtype, dev = DTYPES[cfg.param_dtype], gen.device
    d, L = cfg.d_model, cfg.num_layers
    params: Params = {
        "embed": torch.randn(cfg.vocab_size, d, generator=gen, dtype=dtype, device=dev) * 0.02,
        "final_norm": torch.ones(d, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = stacked_dense(gen, 1, (d, cfg.vocab_size), dtype)[0]
    params["blocks"] = {
        "ln1": torch.ones(L, d, dtype=dtype, device=dev),
        "ln2": torch.ones(L, d, dtype=dtype, device=dev),
        "attn": init_attention(gen, L, d, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                               qk_norm=cfg.qk_norm, dtype=dtype),
    }
    if cfg.is_moe:
        params["blocks"]["moe"] = init_moe(gen, L, d, cfg.moe_d_ff, cfg.num_experts, dtype,
                                           num_shared=cfg.num_shared_experts,
                                           shared_d_ff=cfg.moe_d_ff)
    else:
        params["blocks"]["mlp"] = {
            "wg": stacked_dense(gen, L, (d, cfg.d_ff), dtype),
            "wi": stacked_dense(gen, L, (d, cfg.d_ff), dtype),
            "wo": stacked_dense(gen, L, (cfg.d_ff, d), dtype),
        }
    return params


def window_schedule(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window (FULL_WINDOW = unmasked)."""
    if cfg.window == 0:
        return np.full(cfg.num_layers, FULL_WINDOW, np.int32)
    w = np.full(cfg.num_layers, cfg.window, np.int32)
    for l in cfg.full_attn_layers:
        w[l] = FULL_WINDOW
    return w


def _windows(cfg: ArchConfig):
    """Per layer: the window as an int, or None where it is unmasked."""
    return [None if w >= FULL_WINDOW else int(w) for w in window_schedule(cfg)]


def _layer(tree, l: int):
    """Layer ``l``'s slice of the stacked ``blocks`` tree (views, no copy)."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l] for k, v in tree.items()}


# ====================================================================== #
# block bodies
# ====================================================================== #
def _attn_kwargs(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta, causal=True)


def _ffn(cfg: ArchConfig, p, x: torch.Tensor):
    """The block's second half: ``(x + ffn(ln2(x)), aux)``, aux None for a
    dense MLP."""
    h = rms_norm(x, p["ln2"])
    if cfg.is_moe:
        out, aux = moe_apply(p["moe"], h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        return x + out, aux
    return x + swiglu(h, p["mlp"]["wg"], p["mlp"]["wi"], p["mlp"]["wo"]), None


def _attn_block(cfg: ArchConfig, p, x: torch.Tensor, window: Optional[int],
                cache: Optional[KVCache], index: int):
    """``(x, new_cache, aux)`` of one layer."""
    out, new_cache = attention_apply(p["attn"], rms_norm(x, p["ln1"]), **_attn_kwargs(cfg),
                                     window=window, cache=cache, cache_index=index)
    x, aux = _ffn(cfg, p, x + out)
    return x, new_cache, aux


# ====================================================================== #
# caches
# ====================================================================== #
class LMCache(NamedTuple):
    """Stacked-per-layer decode state.  ``index`` is the next position to
    write, a host int: the decode loop needs no read-back from the card."""

    k: torch.Tensor  # [L, B, Hkv, S_cache, dh]
    v: torch.Tensor
    index: int


def cache_len(cfg: ArchConfig, s_max: int) -> int:
    """Per-layer KV length: the full context for the dense family (the
    reference's hymba ring buffer comes with hymba)."""
    return s_max


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device="cuda") -> LMCache:
    _check_ported(cfg)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, cache_len(cfg, s_max),
             cfg.resolved_head_dim)
    return LMCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), index=0)


# ====================================================================== #
# embedding / logits
# ====================================================================== #
def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(DTYPES[cfg.compute_dtype])


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ====================================================================== #
# full forward, prefill, decode
# ====================================================================== #
def forward_with_aux(params: Params, cfg: ArchConfig, tokens: torch.Tensor):
    """Full forward (no cache): ``(logits [B, S, V], aux)``, the reference's
    ``forward``; aux is the MoE aux loss averaged over the layers, 0 for the
    dense family.  With ``cfg.remat``, grad enabled and a parameter that
    requires it, each layer runs under ``checkpoint`` (recomputed in the
    backward)."""
    _check_ported(cfg)
    x = _embed(params, cfg, tokens)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))
    auxs = []
    for l, w in enumerate(_windows(cfg)):
        p = _layer(params["blocks"], l)
        if remat:
            x, aux = checkpoint(_remat_body, cfg, p, x, w, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, _, aux = _attn_block(cfg, p, x, w, None, 0)
        auxs.append(aux)
    logits = _logits(params, cfg, rms_norm(x, params["final_norm"]))
    aux = (torch.stack(auxs).mean() if cfg.is_moe else
           torch.zeros((), dtype=torch.float32, device=logits.device))
    return logits, aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The logits [B, S, V] of :func:`forward_with_aux`."""
    return forward_with_aux(params, cfg, tokens)[0]


def _remat_body(cfg: ArchConfig, p, x: torch.Tensor, window: Optional[int]):
    x, _, aux = _attn_block(cfg, p, x, window, None, 0)
    return x, aux


def lm_loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """Next-token cross entropy + 0.01 · the MoE aux loss: ``(loss, {"ce",
    "aux"})``.  batch: ``tokens`` and ``labels`` [B, S]."""
    logits, aux = forward_with_aux(params, cfg, batch["tokens"])
    ce = softmax_xent(logits, batch["labels"])
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, s_max: int,
            cache_dtype=torch.bfloat16):
    """Fill a decode cache from a prompt; returns (last-token logits
    [B, 1, V], cache).  Tokens occupy positions [0, S); cache.index = S."""
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, s_max, cache_dtype, device=x.device)
    for l, w in enumerate(_windows(cfg)):
        p = _layer(params["blocks"], l)
        out, k, v = attention_prefill_kv(p["attn"], rms_norm(x, p["ln1"]), **_attn_kwargs(cfg),
                                         window=w)
        x, _ = _ffn(cfg, p, x + out)
        # in place into the preallocated cache; [S, s_max) stays 0, as the
        # reference's padded copy
        cache.k[l, :, :, :s] = k
        cache.v[l, :, :, :s] = v
    x = rms_norm(x, params["final_norm"])
    return _logits(params, cfg, x[:, -1:]), cache._replace(index=s)


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor, cache: LMCache):
    """One decode step.  token [B, 1] int.  Returns (logits [B, 1, V], cache)
    with the cache written in place at ``cache.index`` and the index
    advanced.  As in the reference, dense decode attends without a window."""
    x = _embed(params, cfg, token)
    for l in range(cfg.num_layers):
        x, _, _ = _attn_block(cfg, _layer(params["blocks"], l), x, None,
                              KVCache(cache.k[l], cache.v[l]), cache.index)
    x = rms_norm(x, params["final_norm"])
    return _logits(params, cfg, x), cache._replace(index=cache.index + 1)
