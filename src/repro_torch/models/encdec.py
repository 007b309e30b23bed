"""Encoder-decoder transformer (the seamless-m4t backbone): the counterpart
of ``repro.models.encdec``.

The audio frontend is a stub, as in the reference: ``frames`` are
precomputed frame embeddings [B, S_src, d_frontend].  The encoder is a
bidirectional transformer over the projected frames, the decoder a causal
transformer with a cross attention to the encoder's output in every layer.
Serving keeps each layer's cross K/V (the memory) in the cache.

Parameters are a plain dict of tensors with the reference's tree:
``embed`` [V, D], ``lm_head`` [D, V], ``frame_proj`` [d_frontend, D],
``final_norm``, ``enc_final_norm``, ``enc_blocks`` {``ln1``, ``ln2``,
``attn.{wq,wk,wv,wo}``, ``mlp.{wg,wi,wo}``} stacked over ``enc_layers``,
and ``dec_blocks`` {``ln1``, ``ln_x``, ``ln2``, ``attn``, ``xattn.{wq,wk,wv,
wo}``, ``mlp``} stacked over ``num_layers``.  Python loops over the layers
stand where the reference has ``lax.scan``.

Numerics follow the reference: the frame projection multiplies both
operands rounded to ``compute_dtype`` (the one product of two bf16 operands
under the configs' bf16 compute); the embedding rows are cast to it; from
layer 0's attention on the residual streams are fp32 (``rms_norm``'s fp32
gamma).  Self attention applies RoPE from position 0 in both stacks, cross
attention none.  Every attention call with more than one query row goes to
``flash_attention``: the encoder's non-causal, the decoder's causal, the
cross attention non-causal with Sq ≠ Sk in general.

Which memory is read where: :func:`forward` recomputes each layer's cross
K/V from the encoder output; :func:`prefill` attends to them in the compute
dtype and stores them cast to ``cache_dtype``; :func:`decode_step` attends
to the stored ones, q cast to their dtype (the plain decode path of
:func:`repro_torch.nn.attention.attention_core`).

With ``cfg.remat`` and a gradient to compute, each encoder and decoder layer
runs under ``torch.utils.checkpoint.checkpoint``, as the reference's
``jax.checkpoint`` of its scan bodies.

Under a mesh (:mod:`repro_torch.dist`) the same functions run on DTensors,
as the decoder-only families do: :func:`prefill` makes its
:class:`EncDecCache` in its shards by ``cache_specs`` (the self K/V at
``num_kv_heads``, the cross memory at ``num_heads``, both batch over "dp"
and heads over "tp"), and :func:`encdec_loss` reads each rank's slice of
the vocab-split logits.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.ctx import ashard, cache_tensor
from repro_torch.models.lm import (
    DTYPES,
    _attn_kwargs,
    _embed,
    _ffn,
    _init_mlp,
    _layer,
    _logits,
    _remat_runner,
)
from repro_torch.nn import param as pm
from repro_torch.nn.attention import (
    KVCache,
    attention_apply,
    attention_prefill_kv,
    cross_attention_apply,
    cross_memory,
    init_attention,
    init_cross_attention,
)
from repro_torch.nn.layers import rms_norm, softmax_xent

Params = Dict[str, object]


class EncDecCache(NamedTuple):
    """Decode state: the decoder's self-attention K/V and each layer's cross
    memory.  ``index`` is the next decoder position to write, a host int."""

    k: torch.Tensor  # [L, B, Hkv, S_max, dh]
    v: torch.Tensor
    mem_k: torch.Tensor  # [L, B, H, S_src, dh]
    mem_v: torch.Tensor
    index: int


def init_encdec(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters drawn from ``gen`` on its device, with the
    reference's scales (``0.02 · normal`` for the embedding, ``normal ·
    fan_in^-1/2`` for dense weights, ones for the norms)."""
    return init_encdec_with_axes(gen, cfg)[0]


def init_encdec_with_axes(gen: torch.Generator, cfg: ArchConfig):
    """``(params, axes)``: :func:`init_encdec`'s parameters and the tree of
    their logical axes, the reference's ``init_encdec``."""
    dtype = DTYPES[cfg.param_dtype]
    d, hd = cfg.d_model, cfg.resolved_head_dim
    le, ld = cfg.enc_layers, cfg.num_layers

    def norms(layers):
        return pm.stacked_ones(layers, (d,), (None,), dtype, gen=gen)

    tree = {
        "embed": pm.normal(gen, (cfg.vocab_size, d), 0.02, ("vocab", "embed"), dtype),
        "lm_head": pm.dense(gen, (d, cfg.vocab_size), ("embed", "vocab"), dtype),
        "frame_proj": pm.dense(gen, (cfg.d_frontend, d), (None, "embed"), dtype),
        "final_norm": pm.ones((d,), (None,), dtype, gen=gen),
        "enc_final_norm": pm.ones((d,), (None,), dtype, gen=gen),
        "enc_blocks": {
            "ln1": norms(le), "ln2": norms(le),
            "attn": init_attention(gen, le, d, cfg.num_heads, cfg.num_kv_heads, hd, dtype=dtype),
            "mlp": _init_mlp(gen, le, d, cfg.d_ff, dtype),
        },
        "dec_blocks": {
            "ln1": norms(ld), "ln_x": norms(ld), "ln2": norms(ld),
            "attn": init_attention(gen, ld, d, cfg.num_heads, cfg.num_kv_heads, hd, dtype=dtype),
            "xattn": init_cross_attention(gen, ld, d, d, cfg.num_heads, hd, dtype=dtype),
            "mlp": _init_mlp(gen, ld, d, cfg.d_ff, dtype),
        },
    }
    return pm.unzip(tree)


def _cross(cfg: ArchConfig, p, x: torch.Tensor, mem_kv) -> torch.Tensor:
    hx = rms_norm(x, p["ln_x"])
    return x + cross_attention_apply(p["xattn"], hx, mem_kv, n_heads=cfg.num_heads,
                                     head_dim=cfg.resolved_head_dim)


def _enc_layer(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    out, _ = attention_apply(p["attn"], rms_norm(x, p["ln1"]), **_attn_kwargs(cfg),
                             causal=False)
    return _ffn(cfg, p, x + out)[0]


def _dec_layer(cfg: ArchConfig, p, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """One decoder layer of the full forward: the cross memory is made from
    the encoder output here, per layer."""
    out, _ = attention_apply(p["attn"], rms_norm(x, p["ln1"]), **_attn_kwargs(cfg),
                             causal=True)
    mem_kv = cross_memory(p["xattn"], memory, cfg.num_heads, cfg.resolved_head_dim)
    return _ffn(cfg, p, _cross(cfg, p, x + out, mem_kv))[0]


def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S_src, d_frontend] → encoder output [B, S_src, D]."""
    cdt = DTYPES[cfg.compute_dtype]
    x = frames.to(cdt) @ params["frame_proj"].to(cdt)
    run = _remat_runner(cfg, params)
    for l in range(cfg.enc_layers):
        x = run(_enc_layer, cfg, _layer(params["enc_blocks"], l), x)
    return rms_norm(x, params["enc_final_norm"])


def forward(params: Params, cfg: ArchConfig, frames: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Training forward: logits [B, S_dec, V] (the reference returns them
    with an aux of 0)."""
    memory = encode(params, cfg, frames)
    x = _embed(params, cfg, tokens)
    run = _remat_runner(cfg, params)
    for l in range(cfg.num_layers):
        x = run(_dec_layer, cfg, _layer(params["dec_blocks"], l), x, memory)
    return _logits(params, cfg, rms_norm(x, params["final_norm"]))


def encdec_loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """Next-token cross entropy: ``(loss, {"ce": loss})``.  batch:
    ``frames`` [B, S_src, d_frontend], ``tokens`` and ``labels`` [B, S]."""
    logits = forward(params, cfg, batch["frames"], batch["tokens"])
    loss = softmax_xent(logits, ashard(batch["labels"], "dp"))
    return loss, {"ce": loss}


def prefill(params: Params, cfg: ArchConfig, frames: torch.Tensor, tokens: torch.Tensor,
            s_max: int, cache_dtype=torch.bfloat16):
    """Encode the source and fill the decoder's positions [0, S_dec):
    (last-token logits [B, 1, V], :class:`EncDecCache` with index S_dec).
    Self K/V positions [S_dec, s_max) stay 0, as the reference's padding."""
    memory = encode(params, cfg, frames)
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    L, h, hd, dev = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim, x.device
    self_shape = (L, b, cfg.num_kv_heads, s_max, hd)
    mem_shape = (L, b, h, memory.shape[1], hd)
    cache = EncDecCache(*(cache_tensor(shape, 0.0, cache_dtype, dev, b)
                          for shape in (self_shape, self_shape, mem_shape, mem_shape)), index=s)
    for l in range(L):
        p = _layer(params["dec_blocks"], l)
        out, k, v = attention_prefill_kv(p["attn"], rms_norm(x, p["ln1"]), **_attn_kwargs(cfg),
                                         causal=True)
        mk, mv = cross_memory(p["xattn"], memory, h, hd)
        x, _ = _ffn(cfg, p, _cross(cfg, p, x + out, (mk, mv)))
        cache.k[l, :, :, :s] = k
        cache.v[l, :, :, :s] = v
        cache.mem_k[l] = mk
        cache.mem_v[l] = mv
    x = rms_norm(x, params["final_norm"])
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor, cache: EncDecCache):
    """One decode step of token [B, 1]: (logits [B, 1, V], cache) with the
    self K/V written in place at ``cache.index`` and the index advanced."""
    x = _embed(params, cfg, token)
    index = cache.index
    for l in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], l)
        out, _ = attention_apply(p["attn"], rms_norm(x, p["ln1"]), **_attn_kwargs(cfg),
                                 causal=True, cache=KVCache(cache.k[l], cache.v[l]),
                                 cache_index=index)
        x, _ = _ffn(cfg, p, _cross(cfg, p, x + out, (cache.mem_k[l], cache.mem_v[l])))
    x = rms_norm(x, params["final_norm"])
    return _logits(params, cfg, x), cache._replace(index=index + 1)
