"""GQA attention with RoPE, KV cache, sliding window, optional QK-norm.

The counterpart of ``repro.nn.attention`` for the dense LM, with the
reference's dispatch: every call with more than one query row (prefill and
the full forward) goes to the ``flash_attention`` kernel; a decode step
(one query row against the cache) takes the plain grouped-GQA path, as the
reference sends decode to XLA's einsum and not to its Pallas kernel.

Hymba's decode step attends to a ring-buffer window cache through
:func:`ring_decode_attention`, a plain grouped-GQA path as the reference's.
Its prefill and full forward reach ``flash_attention`` with each layer's
window as a Python int (1024, or ``None`` on the global layers); the
reference, whose layer scan traces hymba's mixed window schedule, takes its
einsum path there instead: the same function by another route.

Cross attention (the encoder-decoder): :func:`cross_memory` projects the
encoder output once into K/V of ``n_heads`` heads (no RoPE), and
:func:`cross_attention_apply` attends to them through :func:`attention_core`
unmasked: ``flash_attention`` non-causal with Sq ≠ Sk in a prefill or a full
forward, the plain grouped path at decode.

The reference's ``ashard`` annotations stand at its points: q, k and v
after the head split and after RoPE (batch over "dp", heads over "tp"),
and the prefill's output.  They are the identity outside an
``activation_sharding`` context.  Inside one the tensors are DTensors, and
:func:`attention_core` runs the attention on each rank's local batch rows
and heads through ``local_map`` (:func:`repro_torch.dist.ctx.local_apply`):
the kernel (and its autograd backward) sees plain local tensors, as the
reference's ``shard_map``-free Pallas call sees each device's shard.
:func:`ring_decode_attention` writes its ring slot into the placed cache
and attends on the local rows and heads the same way; :func:`cross_memory`
gives the memory's k and v batch over "dp" and heads over "tp", as
``cache_specs`` places the cache that keeps them.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.dist.ctx import (
    ashard,
    axis_size,
    local_apply,
    merge_heads,
    split_heads,
    tp_rank,
)
from repro_torch.kernels import ops as kops
from repro_torch.nn import param as pm
from repro_torch.nn.layers import apply_rope, rms_norm, rope_freqs


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, Hkv, S_max, Dh]
    v: torch.Tensor  # [B, Hkv, S_max, Dh]


def init_attention(gen: torch.Generator, layers: int, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, qkv_bias: bool = False, qk_norm: bool = False,
                   dtype=torch.float32) -> Dict[str, pm.Param]:
    """Stacked ``[layers, …]`` projections with their logical axes, drawn from
    ``gen`` on its device."""
    p = {
        "wq": pm.stacked_dense(gen, layers, (d_model, n_heads * head_dim), ("embed", "heads"),
                               dtype),
        "wk": pm.stacked_dense(gen, layers, (d_model, n_kv * head_dim), ("embed", "heads"), dtype),
        "wv": pm.stacked_dense(gen, layers, (d_model, n_kv * head_dim), ("embed", "heads"), dtype),
        "wo": pm.stacked_dense(gen, layers, (n_heads * head_dim, d_model), ("heads", "embed"),
                               dtype),
    }
    if qkv_bias:
        p["bq"] = pm.stacked_zeros(layers, (n_heads * head_dim,), ("heads",), dtype, gen=gen)
        p["bk"] = pm.stacked_zeros(layers, (n_kv * head_dim,), ("heads",), dtype, gen=gen)
        p["bv"] = pm.stacked_zeros(layers, (n_kv * head_dim,), ("heads",), dtype, gen=gen)
    if qk_norm:
        p["q_norm"] = pm.stacked_ones(layers, (head_dim,), (None,), dtype, gen=gen)
        p["k_norm"] = pm.stacked_ones(layers, (head_dim,), (None,), dtype, gen=gen)
    return p


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                   window: Optional[int], q_offset: int) -> torch.Tensor:
    """q [B, Hq, Sq, Dh] over k, v [B, Hkv, Sk, Dh] → [B, Hq, Sq, Dh] in q's
    dtype.  Under a mesh each rank attends with its local batch rows and
    heads (:func:`repro_torch.dist.ctx.local_apply`; sequence and head dims
    whole): the heads split where Hq and Hkv both divide, so that local q
    head j reads local KV head j // g as the kernel does.  On the kernel's
    path (Sq > 1), where "tp" divides Hq but not Hkv (8 KV heads over 16),
    each rank reads the KV heads whole and takes the ones its Hq / tp q
    heads read, repeated to one a q head: the reference's kernel wrapper
    repeats the KV heads to Hq, and its heads split.  The selection's
    backward sums each group's gradients into a partial sum over "tp".
    Decode keeps its grouped path."""
    hq, hkv, tp = q.shape[1], k.shape[1], axis_size("tp")
    heads = ("dp", "tp")
    if q.shape[2] > 1 and tp > 1 and hkv % tp and not hq % tp:
        local, first = hq // tp, tp_rank() * (hq // tp)

        def attend(a, b, c):
            idx = torch.arange(first, first + local, device=b.device) // (hq // hkv)
            return _attend(a, b.index_select(1, idx), c.index_select(1, idx), causal, window,
                           q_offset)

        return local_apply(attend, (q, k, v), (heads, ("dp",), ("dp",)), (heads,))
    return local_apply(lambda a, b, c: _attend(a, b, c, causal, window, q_offset), (q, k, v),
                       (heads, heads, heads), (heads,))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], q_offset: int) -> torch.Tensor:
    """:func:`attention_core` on plain tensors."""
    if q.shape[2] > 1:
        return kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=causal, window=window, q_offset=q_offset)
    # decode: grouped GQA without repeating KV heads.  As in the reference, q
    # is cast to the cache dtype and both products accumulate in fp32: the
    # operands are rounded first and multiplied as fp32, which is exact for
    # bf16 (a bf16 matmul in PyTorch would round its output to bf16).
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = q.reshape(b, hkv, hq // hkv, sq, d).to(k.dtype).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / math.sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    probs = torch.softmax(logits.masked_fill(~m, -1e30), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _split_heads(t: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    """[B, S, n·dh] → [B, n, S, dh] (:func:`repro_torch.dist.ctx.split_heads`)."""
    return split_heads(t, n, head_dim).transpose(1, 2)


def _qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int,
         rope_theta: float, start: int):
    """Projections, heads split to [B, H, S, Dh], QK-norm and RoPE at
    positions ``start + arange(S)``."""
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = ashard(_split_heads(q, n_heads, head_dim), "dp", "tp")
    k = ashard(_split_heads(k, n_kv, head_dim), "dp", "tp")
    v = ashard(_split_heads(v, n_kv, head_dim), "dp", "tp")
    if "q_norm" in p:
        q, k = rms_norm(q, p["q_norm"]), rms_norm(k, p["k_norm"])
    angles = rope_freqs(head_dim, rope_theta, start + torch.arange(s, device=x.device))
    return ashard(apply_rope(q, angles), "dp", "tp"), ashard(apply_rope(k, angles), "dp", "tp"), v


def _merge_heads(out: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The heads' outputs [B, H, S, dh] merged to [B·S, H·dh] @ wo, then
    [B, S, D].  A 2-D product: at S = 1 a DTensor's [B, 1, H·dh] view can
    carry a stride that keeps ``matmul`` from folding it into one ``mm``
    (it takes ``bmm``, which rounds otherwise), and a 1 × 1 mesh must give
    the plain path's bits."""
    b, h, s, dh = out.shape
    merged = merge_heads(out.transpose(1, 2)).reshape(b * s, h * dh)
    # a partial sum over the split heads: reduced here, as swiglu's output
    return ashard((merged @ p["wo"]).reshape(b, s, -1), "dp")


def attention_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, *, n_heads: int, n_kv: int,
                    head_dim: int, rope_theta: float = 1e6, causal: bool = True,
                    window: Optional[int] = None, cache: Optional[KVCache] = None,
                    cache_index: int = 0) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention over x [B, S, D] with one layer's ``p``.  If ``cache``
    is given:

    * S > 1 → prefill: writes positions [0, S) of the cache;
    * S = 1 → decode: writes position ``cache_index`` and attends to the
      whole cache with ``q_offset = cache_index``.

    The reference returns an updated copy of the cache; the port writes the
    preallocated one in place and returns it."""
    s = x.shape[1]
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, rope_theta, cache_index)
    if cache is None:
        return _merge_heads(attention_core(q, k, v, causal, window, 0), p), None
    if s == 1:
        cache.k[:, :, cache_index:cache_index + 1] = k
        cache.v[:, :, cache_index:cache_index + 1] = v
        out = attention_core(q, cache.k, cache.v, causal, window, cache_index)
    else:
        cache.k[:, :, :s] = k
        cache.v[:, :, :s] = v
        out = attention_core(q, k, v, causal, window, 0)
    return _merge_heads(out, p), cache


def attention_prefill_kv(p: Dict[str, torch.Tensor], x: torch.Tensor, *, n_heads: int,
                         n_kv: int, head_dim: int, rope_theta: float = 1e6,
                         causal: bool = True, window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill that also returns the (rope-applied) full-length K/V so the
    caller can fill its cache."""
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, rope_theta, 0)
    del x  # a caller that keeps no reference frees the normed input here
    out = ashard(attention_core(q, k, v, causal, window, 0), "dp", "tp")
    return _merge_heads(out, p), k, v


def init_cross_attention(gen: torch.Generator, layers: int, d_model: int, d_enc: int,
                         n_heads: int, head_dim: int, dtype=torch.float32
                         ) -> Dict[str, pm.Param]:
    """Stacked ``[layers, …]`` cross-attention projections: q from the
    decoder's width, k and v from the encoder's, all ``n_heads`` heads."""
    hd = n_heads * head_dim
    return {
        "wq": pm.stacked_dense(gen, layers, (d_model, hd), ("embed", "heads"), dtype),
        "wk": pm.stacked_dense(gen, layers, (d_enc, hd), ("embed", "heads"), dtype),
        "wv": pm.stacked_dense(gen, layers, (d_enc, hd), ("embed", "heads"), dtype),
        "wo": pm.stacked_dense(gen, layers, (hd, d_model), ("heads", "embed"), dtype),
    }


def cross_attention_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                          memory_kv: Tuple[torch.Tensor, torch.Tensor], *, n_heads: int,
                          head_dim: int) -> torch.Tensor:
    """x [B, Sq, D] over precomputed memory K/V ([B, H, Sk, dh] each),
    unmasked and without RoPE → [B, Sq, D]."""
    b, s, _ = x.shape
    q = ashard(_split_heads(x @ p["wq"], n_heads, head_dim), "dp", "tp")
    k, v = memory_kv
    return _merge_heads(attention_core(q, k, v, False, None, 0), p)


def cross_memory(p: Dict[str, torch.Tensor], enc: torch.Tensor, n_heads: int, head_dim: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output enc [B, Sk, D_enc] as cross-attention K/V, each
    [B, H, Sk, dh] (once per request)."""
    k = _split_heads(enc @ p["wk"], n_heads, head_dim)
    v = _split_heads(enc @ p["wv"], n_heads, head_dim)
    return ashard(k, "dp", "tp"), ashard(v, "dp", "tp")


def ring_decode_attention(p: Dict[str, torch.Tensor], x: torch.Tensor, ck: torch.Tensor,
                          cv: torch.Tensor, index: int, *, n_heads: int, n_kv: int,
                          head_dim: int, rope_theta: float = 1e6
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sliding-window decode of x [B, 1, D] at absolute position ``index``
    against a ring-buffer cache ck, cv [B, Hkv, W, dh] of rope-applied keys.
    Slot s holds position ``index − ((index − s) mod W)``; slots with a
    negative position (not written yet) are masked.  Writes slot ``index mod
    W`` in place and returns (out [B, 1, D], ck, cv).

    Unlike :func:`attention_core`'s decode, this is the reference's fp32
    path: q and the cache are read as fp32 (q is not rounded to the cache's
    dtype) and the probabilities are not rounded to v's dtype."""
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, rope_theta, index)
    slot = index % ck.shape[2]
    ck[:, :, slot:slot + 1] = k
    cv[:, :, slot:slot + 1] = v
    heads = ("dp", "tp")
    out = local_apply(lambda a, b, c: _ring_attend(a, b, c, index), (q, ck, cv),
                      (heads, heads, heads), (heads,))
    return _merge_heads(out.to(x.dtype), p), ck, cv


def _ring_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, index: int):
    """q [B, Hq, 1, dh] over the ring ck, cv [B, Hkv, W, dh] at absolute
    position ``index``, in fp32 (local to a batch row and a KV head's group
    under a mesh)."""
    b, hq, _, dh = q.shape
    hkv, w = ck.shape[1], ck.shape[2]
    pos = index - torch.remainder(index - torch.arange(w, device=q.device), w)
    qf = q.reshape(b, hkv, hq // hkv, 1, dh).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, ck.float()) / math.sqrt(dh)
    probs = torch.softmax(logits.masked_fill(pos < 0, -1e30), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, cv.float())
    return out.reshape(b, hq, 1, dh)
