"""Decoder-only LM: the dense GQA family (qwen2.5 / granite / llama3.2 /
minicpm), the MoE family (qwen3-moe, moonshot), hymba (parallel attention
and SSD heads), xLSTM (sLSTM-led groups of mLSTM blocks) and the vlm
(pixtral: the dense decoder behind a stubbed patch frontend).

The counterpart of ``repro.models.lm`` for these five families.  Parameters
are a plain dict of tensors with the reference's tree and layouts: stacked
``[L, …]`` layer weights under ``blocks`` (``ln1``, ``ln2``,
``attn.{wq,wk,wv,wo[,bq,bk,bv][,q_norm,k_norm]}``, and either
``mlp.{wg,wi,wo}`` or, for MoE, ``moe.{router,wi,wg,wo[,shared_*]}``
(:mod:`repro_torch.nn.moe`); hymba adds ``ssd.{w_in,conv_w,w_bc,w_dt,a_log,
dt_bias,d_skip,w_out,out_norm}``), ``embed`` ``[V, D]``, ``final_norm`` and,
when the embeddings are not tied, ``lm_head`` ``[D, V]``; a vlm adds
``patch_proj`` ``[d_frontend, D]``.  xLSTM has no
``blocks``: ``slstm_blocks`` ``[G, …]`` and ``mlstm_blocks`` ``[G, P−1, …]``
for G groups of P layers.  Python loops over the layers stand where the
reference has ``lax.scan``.

Numerics follow the reference: the embedding rows are cast to
``compute_dtype`` and ``rms_norm`` multiplies by an fp32 gamma, so with the
configs' fp32 params the residual stream is fp32 from layer 0's attention
on; the KV cache is ``cache_dtype`` (bf16 unless asked), and so are the
recurrent families' convolution carries (their matrix and scalar states are
fp32).

Attention dispatch: every call with more than one query row goes to
``flash_attention`` with the layer's window as a Python int, hymba's too
(1024, or ``None`` on its global layers 0, 15 and 31).  The reference's
layer scan traces hymba's mixed window schedule, and ``attention_core``
then takes its einsum path: the same function by another route; the port
keeps the hand-written kernel on the main path.  Hymba's decode attends to
a ring buffer of ``window`` slots in every layer, the global ones too
(:func:`repro_torch.nn.attention.ring_decode_attention`), as the
reference's: past the window, decode and the full forward differ by design
on those layers.

Training: :func:`lm_loss` is the reference's next-token cross entropy
plus 0.01 · the MoE aux loss (the layers' mean; 0 for the other families).
Its gradient flows through ``flash_attention``'s autograd Function, whose
backward is a hand-written kernel on the card, and the MoE combine's.  With
``cfg.remat`` and a gradient to compute, :func:`forward` wraps each layer
(each hymba layer; xLSTM's mLSTM blocks only, as the reference: a
checkpointed sLSTM step loop would recompute its full-sequence gates) in
``torch.utils.checkpoint.checkpoint``.  Without a gradient, forward and
prefill are the serving path, unchanged.

The encoder-decoder is :mod:`repro_torch.models.encdec` (the model zoo,
:mod:`repro_torch.models`, dispatches on ``cfg.encdec``); this module
refuses its configs.  That module builds its layers from seven helpers of
this one (``_attn_kwargs``, ``_embed``, ``_ffn``, ``_init_mlp``,
``_layer``, ``_logits``, ``_remat_runner``): a change to one of them must
keep both families, and ``tests/test_torch_encdec.py`` holds the
encoder-decoder against the reference through them.

Under a mesh (:mod:`repro_torch.dist`): with DTensor parameters and batch
inside ``activation_sharding``, the same functions run sharded; the
reference's ``ashard`` annotations stand in :mod:`repro_torch.nn.layers`,
:mod:`repro_torch.nn.attention` and :mod:`repro_torch.nn.moe`, the embedding
lookup reads local rows (:func:`repro_torch.nn.layers.embed_lookup`), the
logits stay split over the vocab into the loss, which reads each rank's
slice (:func:`repro_torch.nn.layers.softmax_xent`), and :func:`prefill`
makes its cache in its shards by ``cache_specs``.  Every family runs so:
the MoE routing and combine, the recurrences of :mod:`repro_torch.nn.ssm`,
hymba's ring attention and the gates' ``logsigmoid`` run on each rank's
local rows and heads through :func:`repro_torch.dist.ctx.local_apply`, and
a checkpointed layer's recomputation runs in the forward's mesh context (on
a card autograd recomputes on a thread of its own).

The vlm: ``patches`` ``[B, P, d_frontend]`` (the stubbed vision frontend's
precomputed patch embeddings) go through ``patch_proj`` in the compute dtype
and stand before the token embeddings, so the layers run over P + S
positions.  :func:`forward` drops the P patch positions after the final
norm (its logits and the loss cover the text only); :func:`prefill` fills
the cache over all P + S positions and sets ``index = P + S``, so decode's
RoPE position (``cache.index``) continues after the text.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.ctx import (
    ashard,
    cache_tensor,
    in_current_context,
    local_apply,
    merge_heads,
    replicate_like,
    split_heads,
)
from repro_torch.nn import param as pm
from repro_torch.nn.attention import (
    KVCache,
    attention_apply,
    attention_prefill_kv,
    init_attention,
    ring_decode_attention,
)
from repro_torch.nn.layers import embed_lookup, rms_norm, softmax_xent, swiglu
from repro_torch.nn.moe import init_moe, moe_apply
from repro_torch.nn.ssm import (
    MLSTMState,
    SLSTMState,
    causal_conv,
    mlstm_chunked,
    mlstm_step,
    slstm_seq,
    slstm_step,
    ssd_chunked,
    ssd_step,
)
from repro_torch.train.tree import tree_leaves

FULL_WINDOW = 1 << 30
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Params = Dict[str, object]


def _check_ported(cfg: ArchConfig) -> None:
    """Raise for a config this module does not serve: an encoder-decoder
    (:mod:`repro_torch.models.encdec` serves it)."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: an encoder-decoder config; use "
                                  "repro_torch.models.encdec (or repro_torch.models)")


# ====================================================================== #
# init
# ====================================================================== #
def _init_mlp(gen: torch.Generator, L: int, d: int, f: int, dtype):
    return {"wg": pm.stacked_dense(gen, L, (d, f), ("embed", "mlp"), dtype),
            "wi": pm.stacked_dense(gen, L, (d, f), ("embed", "mlp"), dtype),
            "wo": pm.stacked_dense(gen, L, (f, d), ("mlp", "embed"), dtype)}


def _init_ssd_branch(gen: torch.Generator, L: int, d: int, cfg: ArchConfig, dtype):
    """Mamba-2/SSD branch (hymba)."""
    di, h, n = cfg.ssm_expand * d, cfg.ssm_heads, cfg.ssm_state
    f32 = torch.float32
    return {
        "w_in": pm.stacked_dense(gen, L, (d, 2 * di), ("embed", "mlp"), dtype),
        "conv_w": pm.normal(gen, (L, cfg.conv_width, di), 0.2, ("layers", None, "mlp"), dtype),
        "w_bc": pm.stacked_dense(gen, L, (di, 2 * h * n), ("mlp", "heads"), dtype),
        "w_dt": pm.stacked_dense(gen, L, (di, h), ("mlp", None), dtype),
        "a_log": pm.stacked_zeros(L, (h,), (None,), f32, gen=gen),
        "dt_bias": pm.stacked_zeros(L, (h,), (None,), f32, gen=gen),
        "d_skip": pm.stacked_ones(L, (h,), (None,), f32, gen=gen),
        "w_out": pm.stacked_dense(gen, L, (di, d), ("mlp", "embed"), dtype),
        "out_norm": pm.stacked_ones(L, (di,), (None,), dtype, gen=gen),
    }


def _init_mlstm_blocks(gen: torch.Generator, groups: int, per: int, d: int, heads: int,
                       conv_width: int, dtype):
    lead = ("layers", "stack")

    def sd(shape, axes):
        return pm.normal(gen, (groups, per, *shape), shape[0] ** -0.5, (*lead, *axes), dtype)

    def const(fill, n, dt=dtype):
        return (pm.ones if fill else pm.zeros)((groups, per, n), (*lead, None), dt, gen=gen)

    return {
        "ln": const(1, d),
        "w_up": sd((d, 2 * d), ("embed", "mlp")),
        "conv_w": pm.normal(gen, (groups, per, conv_width, d), 0.2, (*lead, None, "mlp"), dtype),
        "wq": sd((d, d), ("embed", "heads")), "wk": sd((d, d), ("embed", "heads")),
        "wv": sd((d, d), ("embed", "heads")),
        "w_gates": sd((d, 2 * heads), ("embed", None)),
        "b_gates": const(0, 2 * heads, torch.float32),
        "w_down": sd((d, d), ("heads", "embed")),
        "out_norm": const(1, d),
    }


def _init_slstm_blocks(gen: torch.Generator, groups: int, d: int, dtype):
    return {
        "ln": pm.stacked_ones(groups, (d,), (None,), dtype, gen=gen),
        "wz": pm.stacked_dense(gen, groups, (d, d), ("embed", "heads"), dtype),
        "wif": pm.stacked_dense(gen, groups, (d, 2 * d), ("embed", "heads"), dtype),
        "wo_gate": pm.stacked_dense(gen, groups, (d, d), ("embed", "heads"), dtype),
        "w_down": pm.stacked_dense(gen, groups, (d, d), ("heads", "embed"), dtype),
    }


def _xlstm_groups(cfg: ArchConfig):
    """(groups, layers a group): one sLSTM and ``per − 1`` mLSTM blocks each."""
    per = cfg.slstm_every or cfg.num_layers
    if cfg.num_layers % per:
        raise ValueError("xlstm layers must divide into sLSTM-led groups")
    return cfg.num_layers // per, per


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters drawn from ``gen`` on its device, with the
    reference's scales: ``0.02 · normal`` for the embedding,
    ``normal · fan_in^-1/2`` for dense weights, ``0.2 · normal`` for the
    convolutions, ones for norms and ``d_skip``, zeros for biases,
    ``a_log`` and ``dt_bias``."""
    return init_lm_with_axes(gen, cfg)[0]


def init_lm_with_axes(gen: torch.Generator, cfg: ArchConfig):
    """``(params, axes)``: :func:`init_lm`'s parameters and the tree of their
    logical axes (:mod:`repro_torch.nn.param`), the reference's
    ``init_lm``."""
    _check_ported(cfg)
    dtype = DTYPES[cfg.param_dtype]
    d, L = cfg.d_model, cfg.num_layers
    tree = {
        "embed": pm.normal(gen, (cfg.vocab_size, d), 0.02, ("vocab", "embed"), dtype),
        "final_norm": pm.ones((d,), (None,), dtype, gen=gen),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = pm.dense(gen, (d, cfg.vocab_size), ("embed", "vocab"), dtype)
    if cfg.num_patches:
        tree["patch_proj"] = pm.dense(gen, (cfg.d_frontend, d), (None, "embed"), dtype)
    if cfg.block_pattern == "xlstm":
        groups, per = _xlstm_groups(cfg)
        tree["slstm_blocks"] = _init_slstm_blocks(gen, groups, d, dtype)
        tree["mlstm_blocks"] = _init_mlstm_blocks(gen, groups, per - 1, d, cfg.num_heads,
                                                  cfg.conv_width, dtype)
        return pm.unzip(tree)
    hymba = cfg.block_pattern == "hymba"
    blocks = tree["blocks"] = {
        "ln1": pm.stacked_ones(L, (d,), (None,), dtype, gen=gen),
        "ln2": pm.stacked_ones(L, (d,), (None,), dtype, gen=gen),
        "attn": init_attention(gen, L, d, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias and not hymba,
                               qk_norm=cfg.qk_norm and not hymba, dtype=dtype),
    }
    if hymba:
        blocks["ssd"] = _init_ssd_branch(gen, L, d, cfg, dtype)
    if cfg.is_moe:
        blocks["moe"] = init_moe(gen, L, d, cfg.moe_d_ff, cfg.num_experts, dtype,
                                 num_shared=cfg.num_shared_experts, shared_d_ff=cfg.moe_d_ff)
    else:
        blocks["mlp"] = _init_mlp(gen, L, d, cfg.d_ff, dtype)
    return pm.unzip(tree)


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
    """Layer ``l``'s slice of a stacked tree (views, no copy)."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l] for k, v in tree.items()}


# ====================================================================== #
# block bodies
# ====================================================================== #
def _attn_kwargs(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta)


def _ffn(cfg: ArchConfig, p, x: torch.Tensor):
    """The block's second half: ``(x + ffn(ln2(x)), aux)``, aux None for a
    dense MLP."""
    if cfg.is_moe:
        out, aux = moe_apply(p["moe"], rms_norm(x, p["ln2"]), top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
        return x + out, aux
    # no reference kept here: swiglu frees the normed input early
    return x + swiglu(rms_norm(x, p["ln2"]), p["mlp"]["wg"], p["mlp"]["wi"],
                      p["mlp"]["wo"]), None


def _attn_block(cfg: ArchConfig, p, x: torch.Tensor, window: Optional[int],
                cache: Optional[KVCache], index: int):
    """``(x, new_cache, aux)`` of one layer."""
    out, new_cache = attention_apply(p["attn"], rms_norm(x, p["ln1"]), **_attn_kwargs(cfg),
                                     causal=True, window=window, cache=cache,
                                     cache_index=index)
    x, aux = _ffn(cfg, p, x + out)
    return x, new_cache, aux


def _ssd_branch(cfg: ArchConfig, p, h: torch.Tensor, ssm_state: torch.Tensor,
                conv_carry: Optional[torch.Tensor], decoding: bool):
    """Mamba-2/SSD branch of h [B, S, D] (S = 1 when decoding): (out,
    state, conv carry).  k = B, q = C, v = the convolved input."""
    di = cfg.ssm_expand * cfg.d_model
    nh, ns = cfg.ssm_heads, cfg.ssm_state
    dh = di // nh
    xr, z = (h @ p["w_in"]).chunk(2, dim=-1)
    xr, conv_carry = causal_conv(xr, p["conv_w"], conv_carry)
    xr = F.silu(xr)
    bmat, cmat = (xr @ p["w_bc"]).chunk(2, dim=-1)  # [B, S, H·ns] each
    b, s, _ = h.shape
    k = split_heads(bmat, nh, ns)
    q = split_heads(cmat, nh, ns)
    v = split_heads(xr, nh, dh)
    # [B, S, H]; the product over the split channels reduced where it is made (as
    # swiglu's): PyTorch 2.11 otherwise splits its gradient's sequence dim, and
    # then cannot flatten (batch, sequence) in the product's backward
    dt = F.softplus(ashard(xr @ p["w_dt"], "dp") + p["dt_bias"])
    la = -dt * torch.exp(p["a_log"])  # log decay ≤ 0
    if decoding:
        ssm_state, y = ssd_step(ssm_state, q[:, 0], k[:, 0], v[:, 0], la[:, 0])
        y = y[:, None]
    else:
        y, ssm_state = ssd_chunked(q, k, v, la, s0=ssm_state, chunk=min(cfg.chunk, s))
    y = y + (p["d_skip"][None, None, :, None] * v).to(y.dtype)
    y = merge_heads(y).to(h.dtype)
    y = rms_norm(y, p["out_norm"]) * F.silu(z)
    return (y @ p["w_out"]).to(h.dtype), ssm_state, conv_carry


def _hymba_rest(cfg: ArchConfig, p, x: torch.Tensor, h: torch.Tensor, attn_out: torch.Tensor,
                ssm_state: torch.Tensor, conv_carry: Optional[torch.Tensor], decoding: bool):
    """A hymba layer after its attention: the SSD heads of the same input h,
    the two branches averaged into the residual, then the MLP."""
    ssd_out, ssm_state, conv_carry = _ssd_branch(cfg, p["ssd"], h, ssm_state, conv_carry,
                                                 decoding)
    x = x + 0.5 * (attn_out + ssd_out)
    x = x + swiglu(rms_norm(x, p["ln2"]), p["mlp"]["wg"], p["mlp"]["wi"], p["mlp"]["wo"])
    return x, ssm_state, conv_carry


def _hymba_layer(cfg: ArchConfig, p, x: torch.Tensor, window: Optional[int]):
    """One hymba layer of the full forward (no cache; the SSD state and the
    convolution carry start at 0): ``(x, None)``."""
    h = rms_norm(x, p["ln1"])
    attn_out, _ = attention_apply(p["attn"], h, **_attn_kwargs(cfg), causal=True, window=window)
    x, _, _ = _hymba_rest(cfg, p, x, h, attn_out, None, None, h.shape[1] == 1)
    return x, None


#: a [B, H, …] tensor under a mesh: rows over "dp", heads over "tp"
_HEADS = ("dp", "tp")


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid`` of [B, S, H, …] gates; under a mesh elementwise on the
    local shards (DTensor has no sharding rule for its backward)."""
    axes = ("dp", None, "tp")
    return local_apply(F.logsigmoid, (x,), (axes,), (axes,))


def _mlstm_block(cfg: ArchConfig, p, x: torch.Tensor, state: Optional[MLSTMState],
                 conv_carry: Optional[torch.Tensor], decoding: bool):
    """(x, state, conv carry).  q and k read the convolved input, v the
    input before the convolution; k is scaled by dh^-1/2."""
    d, nh = cfg.d_model, cfg.num_heads
    dh = d // nh
    b, s, _ = x.shape
    h = rms_norm(x, p["ln"])
    xm, zg = (h @ p["w_up"]).chunk(2, dim=-1)
    xc, conv_carry = causal_conv(xm, p["conv_w"], conv_carry)
    xc = F.silu(xc)
    q = split_heads(xc @ p["wq"], nh, dh)
    k = split_heads(xc @ p["wk"], nh, dh) / (dh ** 0.5)
    v = split_heads(xm @ p["wv"], nh, dh)
    gates = (h @ p["w_gates"]).float() + p["b_gates"]
    lf_raw, li = gates.chunk(2, dim=-1)  # [B, S, H]: forget first, then input
    lf = _logsigmoid(lf_raw)
    if decoding:
        state, y = mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], lf[:, 0], li[:, 0])
        y = y[:, None]
    else:
        y, state = mlstm_chunked(q, k, v, lf, li, st=state, chunk=min(cfg.chunk, s))
    y = merge_heads(y).to(x.dtype)
    y = rms_norm(y, p["out_norm"]) * F.silu(zg)
    return x + y @ p["w_down"], state, conv_carry


def _mlstm_layer(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """One mLSTM block of the full forward (initial state, no carry)."""
    return _mlstm_block(cfg, p, x, None, None, False)[0]


def _slstm_block(cfg: ArchConfig, p, x: torch.Tensor, state: Optional[SLSTMState],
                 decoding: bool):
    """(x, state).  The gate projection splits as (input, forget)."""
    d, nh = cfg.d_model, cfg.num_heads
    dh = d // nh
    h = rms_norm(x, p["ln"])
    z = split_heads(torch.tanh(h @ p["wz"]), nh, dh)
    li, lf_raw = split_heads((h @ p["wif"]).float(), nh, 2 * dh).chunk(2, dim=-1)
    lf = _logsigmoid(lf_raw)
    o = split_heads(torch.sigmoid(h @ p["wo_gate"]), nh, dh)
    if decoding:
        state, y = slstm_step(state, z[:, 0].float(), lf[:, 0], li[:, 0], o[:, 0].float())
        y = y[:, None]
    else:
        y, state = slstm_seq(z, lf, li, o, st=state)
    y = merge_heads(y).to(x.dtype)
    # bf16 y (layer 0 under bf16 compute) @ fp32 weights: JAX promotes the
    # product to fp32, torch.matmul would refuse it
    w = p["w_down"]
    return x + y.to(torch.promote_types(y.dtype, w.dtype)) @ w, state


# ====================================================================== #
# caches
# ====================================================================== #
class LMCache(NamedTuple):
    """Stacked-per-layer decode state of the attention families.  ``index``
    is the next position to write, a host int: the decode loop needs no
    read-back from the card.  Hymba adds its SSD states and convolution
    carries; its K/V are a ring of ``window`` slots once the context is
    longer than the window."""

    k: torch.Tensor  # [L, B, Hkv, S_cache, dh]
    v: torch.Tensor
    index: int
    ssm: Optional[torch.Tensor] = None  # [L, B, H_ssm, ns, dh_ssm] fp32 (hymba)
    conv: Optional[torch.Tensor] = None  # [L, B, kw-1, di] (hymba)


class XLSTMCache(NamedTuple):
    """xLSTM decode state: per group its sLSTM state, per mLSTM block its
    matrix state and convolution carry; no K/V.  ``index`` a host int."""

    s_c: torch.Tensor  # [G, B, H, dh]
    s_n: torch.Tensor
    s_m: torch.Tensor
    m_c: torch.Tensor  # [G, P-1, B, H, dh, dh]
    m_n: torch.Tensor  # [G, P-1, B, H, dh]
    m_m: torch.Tensor  # [G, P-1, B, H]
    conv: torch.Tensor  # [G, P-1, B, kw-1, D]
    index: int


def cache_len(cfg: ArchConfig, s_max: int) -> int:
    """Per-layer KV length: a ring buffer of ``window`` slots for hymba when
    the context is longer than the window, else the full context."""
    if cfg.block_pattern == "hymba" and cfg.window and s_max > cfg.window:
        return cfg.window
    return s_max


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, device="cuda"):
    """An empty :class:`LMCache` (:class:`XLSTMCache` for xLSTM) on ``device``;
    inside :func:`~repro_torch.dist.ctx.activation_sharding` each leaf is
    made in its shards (:func:`~repro_torch.dist.ctx.cache_tensor`)."""
    _check_ported(cfg)
    L, d, kw = cfg.num_layers, cfg.d_model, cfg.conv_width

    def zeros(*shape, dt=torch.float32):
        return cache_tensor(shape, 0.0, dt, device, batch)

    def init_m(*shape):
        return cache_tensor(shape, -1e30, torch.float32, device, batch)

    if cfg.block_pattern == "xlstm":
        g, per = _xlstm_groups(cfg)
        nh = cfg.num_heads
        dh = d // nh
        return XLSTMCache(s_c=zeros(g, batch, nh, dh), s_n=zeros(g, batch, nh, dh),
                          s_m=init_m(g, batch, nh, dh), m_c=zeros(g, per - 1, batch, nh, dh, dh),
                          m_n=zeros(g, per - 1, batch, nh, dh), m_m=init_m(g, per - 1, batch, nh),
                          conv=zeros(g, per - 1, batch, kw - 1, d, dt=dtype), index=0)
    shape = (L, batch, cfg.num_kv_heads, cache_len(cfg, s_max), cfg.resolved_head_dim)
    cache = LMCache(k=zeros(*shape, dt=dtype), v=zeros(*shape, dt=dtype), index=0)
    if cfg.block_pattern == "hymba":
        di = cfg.ssm_expand * d
        cache = cache._replace(
            ssm=zeros(L, batch, cfg.ssm_heads, cfg.ssm_state, di // cfg.ssm_heads),
            conv=zeros(L, batch, kw - 1, di, dt=dtype))
    return cache


# ====================================================================== #
# embedding / logits
# ====================================================================== #
def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
           patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embeddings in the compute dtype, after ``patches @
    patch_proj`` (both operands in the compute dtype) when ``patches`` are
    given.  Under a mesh both come out batch over "dp", the sequence whole
    (:func:`~repro_torch.nn.layers.embed_lookup`): the reference leaves
    their layout to GSPMD, and DTensor would carry the tokens' split of the
    sequence (``auto_spec`` puts "tp" there) into the residual stream, whose
    backward then flattens (batch, sequence) with the sequence split, which
    PyTorch 2.11 refuses."""
    cdt = DTYPES[cfg.compute_dtype]
    x = embed_lookup(params["embed"], tokens).to(cdt)
    if patches is not None:
        proj = ashard(patches.to(cdt) @ params["patch_proj"].to(cdt), "dp")
        x = torch.cat([proj, x], dim=1)
    return x


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """``x @ head``; under a mesh the head's vocab split over "tp", unevenly
    where "tp" does not divide it (DTensor's own choice for this product on
    a 16 × 16 mesh replicated both operands and computed every row of the
    global batch on each rank), so the logits come out vocab-split.  x comes
    in whole over "tp": a block that leaves a partial sum there (hymba's,
    xLSTM's) is reduced first, or the product runs over the whole vocab."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return ashard(x, "dp") @ ashard(head, None, "tp", uneven=("tp",)).to(x.dtype)


# ====================================================================== #
# full forward, prefill, decode
# ====================================================================== #
def forward_with_aux(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                     patches: Optional[torch.Tensor] = None):
    """Full forward (no cache): ``(logits [B, S, V], aux)``, the reference's
    ``forward``; aux is the MoE aux loss averaged over the layers, 0 for the
    other families.  ``patches`` [B, P, d_frontend] (a vlm) run before the
    tokens and their P positions are dropped after the final norm.  With
    ``cfg.remat``, grad enabled and a parameter that requires it, each layer
    (xLSTM: each mLSTM block) runs under ``checkpoint`` (recomputed in the
    backward)."""
    _check_ported(cfg)
    x = _embed(params, cfg, tokens, patches)
    n_patch = 0 if patches is None else patches.shape[1]
    run = _remat_runner(cfg, params)
    auxs = []
    if cfg.block_pattern == "xlstm":
        groups, per = _xlstm_groups(cfg)
        for g in range(groups):
            x, _ = _slstm_block(cfg, _layer(params["slstm_blocks"], g), x, None, False)
            mlstm = _layer(params["mlstm_blocks"], g)
            for j in range(per - 1):
                x = run(_mlstm_layer, cfg, _layer(mlstm, j), x)
    else:
        body = _hymba_layer if cfg.block_pattern == "hymba" else _attn_layer
        for l, w in enumerate(_windows(cfg)):
            x, aux = run(body, cfg, _layer(params["blocks"], l), x, w)
            auxs.append(aux)
    logits = _logits(params, cfg, rms_norm(x, params["final_norm"])[:, n_patch:])
    aux = (torch.stack(auxs).mean() if cfg.is_moe else
           replicate_like(torch.zeros((), dtype=torch.float32, device=logits.device), logits))
    return logits, aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The logits [B, S, V] of :func:`forward_with_aux` (the text positions)."""
    return forward_with_aux(params, cfg, tokens, patches)[0]


def _remat_runner(cfg: ArchConfig, params: Params):
    """``run(body, *args)``: ``body(*args)``, under ``checkpoint`` (recomputed
    in the backward, inside the mesh context of the forward) when
    ``cfg.remat``, grad is enabled and a parameter requires it."""
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))

    def run(body, *args):
        if remat:  # the recomputation runs in this mesh context too
            return checkpoint(in_current_context(body), *args, use_reentrant=False,
                              preserve_rng_state=False)
        return body(*args)

    return run


def _attn_layer(cfg: ArchConfig, p, x: torch.Tensor, window: Optional[int]):
    """One layer of the dense or MoE full forward: ``(x, aux)``."""
    x, _, aux = _attn_block(cfg, p, x, window, None, 0)
    return x, aux


def lm_loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """Next-token cross entropy + 0.01 · the MoE aux loss: ``(loss, {"ce",
    "aux"})``.  batch: ``tokens`` and ``labels`` [B, S], and ``patches`` for
    a vlm."""
    logits, aux = forward_with_aux(params, cfg, batch["tokens"], batch.get("patches"))
    ce = softmax_xent(logits, ashard(batch["labels"], "dp"))
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def ring_slots(s: int, slots: int) -> np.ndarray:
    """The prompt position a prefill of ``s`` tokens leaves in each of a
    ring's ``slots``: the latest p < s with p ≡ j (mod slots), clipped to
    [0, s − 1] (a slot no position reached holds position 0's K/V; decode
    masks it)."""
    j = np.arange(slots)
    return np.clip((s - 1) - np.mod(s - 1 - j, slots), 0, s - 1)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, s_max: int,
            cache_dtype=torch.bfloat16, patches: Optional[torch.Tensor] = None):
    """Fill a decode cache from a prompt; returns (last-token logits
    [B, 1, V], cache).  Tokens occupy positions [0, S); cache.index = S.  A
    vlm's ``patches`` [B, P, d_frontend] occupy [0, P) and the tokens [P, P +
    S); cache.index = P + S, and ``s_max`` counts the patches too."""
    x = _embed(params, cfg, tokens, patches)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, s_max, cache_dtype, device=x.device)
    if cfg.block_pattern == "xlstm":
        groups, per = _xlstm_groups(cfg)
        for g in range(groups):
            x, st = _slstm_block(cfg, _layer(params["slstm_blocks"], g), x, None, False)
            for dst, src in zip((cache.s_c, cache.s_n, cache.s_m), st):
                dst[g] = src
            mlstm = _layer(params["mlstm_blocks"], g)
            for j in range(per - 1):
                x, st, carry = _mlstm_block(cfg, _layer(mlstm, j), x, None, None, False)
                for dst, src in zip((cache.m_c, cache.m_n, cache.m_m, cache.conv),
                                    (*st, carry)):
                    dst[g, j] = src
    else:
        hymba = cfg.block_pattern == "hymba"
        if hymba:
            slots = torch.from_numpy(ring_slots(s, cache.k.shape[3])).to(x.device)
        for l, w in enumerate(_windows(cfg)):
            p = _layer(params["blocks"], l)
            if hymba:
                h = rms_norm(x, p["ln1"])
                out, k, v = attention_prefill_kv(p["attn"], h, **_attn_kwargs(cfg),
                                                 causal=True, window=w)
                x, cache.ssm[l], cache.conv[l] = _hymba_rest(cfg, p, x, h, out, None, None, False)
                cache.k[l], cache.v[l] = local_apply(
                    lambda a, c: (a.index_select(2, slots), c.index_select(2, slots)),
                    (k, v), (_HEADS, _HEADS), (_HEADS, _HEADS))
            else:
                # the normed input is handed over, not kept, so the attention frees it
                out, k, v = attention_prefill_kv(p["attn"], rms_norm(x, p["ln1"]),
                                                 **_attn_kwargs(cfg), causal=True, window=w)
                # in place into the preallocated cache; [S, s_max) stays 0, as the
                # reference's padded copy
                cache.k[l, :, :, :s] = k
                cache.v[l, :, :, :s] = v
                x = x + out
                del out, k, v  # freed before the MLP's temporaries are made
                x, _ = _ffn(cfg, p, x)
    x = rms_norm(x, params["final_norm"])
    return _logits(params, cfg, x[:, -1:]), cache._replace(index=s)


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor, cache):
    """One decode step.  token [B, 1] int.  Returns (logits [B, 1, V], cache)
    with the cache written in place at ``cache.index`` and the index
    advanced.  As in the reference, dense decode attends without a window
    and hymba's attends to its ring in every layer."""
    x = _embed(params, cfg, token)
    index = cache.index
    if cfg.block_pattern == "xlstm":
        groups, per = _xlstm_groups(cfg)
        for g in range(groups):
            x, st = _slstm_block(cfg, _layer(params["slstm_blocks"], g), x,
                                 SLSTMState(cache.s_c[g], cache.s_n[g], cache.s_m[g]), True)
            for dst, src in zip((cache.s_c, cache.s_n, cache.s_m), st):
                dst[g] = src
            mlstm = _layer(params["mlstm_blocks"], g)
            for j in range(per - 1):
                x, st, carry = _mlstm_block(
                    cfg, _layer(mlstm, j), x,
                    MLSTMState(cache.m_c[g, j], cache.m_n[g, j], cache.m_m[g, j]),
                    cache.conv[g, j].to(x.dtype), True)
                for dst, src in zip((cache.m_c, cache.m_n, cache.m_m, cache.conv),
                                    (*st, carry)):
                    dst[g, j] = src
    elif cfg.block_pattern == "hymba":
        for l in range(cfg.num_layers):
            p = _layer(params["blocks"], l)
            h = rms_norm(x, p["ln1"])
            out, _, _ = ring_decode_attention(p["attn"], h, cache.k[l], cache.v[l], index,
                                              **_attn_kwargs(cfg))
            x, cache.ssm[l], cache.conv[l] = _hymba_rest(
                cfg, p, x, h, out, cache.ssm[l], cache.conv[l].to(x.dtype), True)
    else:
        for l in range(cfg.num_layers):
            x, _, _ = _attn_block(cfg, _layer(params["blocks"], l), x, None,
                                  KVCache(cache.k[l], cache.v[l]), index)
    x = rms_norm(x, params["final_norm"])
    return _logits(params, cfg, x), cache._replace(index=index + 1)
