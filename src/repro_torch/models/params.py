"""Weights bridge: the JAX package's LM parameter tree, as numpy, into the
port's parameters.

    tree = jax.tree.map(np.asarray, repro.models.init_model(key, cfg)[0])
    params = lm_params_from_numpy(tree, "cuda")

Leaf by leaf, same names, shapes and dtypes (bf16 too: the reference's bf16
leaves, ``ml_dtypes``' bfloat16 in numpy, keep their bits).  The leaves a tree must have
depend on its family, which the tree shows: ``enc_blocks``/``dec_blocks``
(the encoder-decoder: ``frame_proj``, ``lm_head``, both final norms, the
encoder's self attention and MLP, the decoder's self and cross attention and
MLP; no optional leaf), ``slstm_blocks``/``mlstm_blocks`` (xLSTM, no
``blocks``), ``blocks/ssd`` (hymba: attention, SSD heads and a dense MLP),
else the dense or MoE transformer, whose feed-forward half is
either ``blocks/mlp`` or ``blocks/moe``, exactly one of them, whole.  The
dense family may have ``patch_proj`` (a vlm's patch frontend), a 2-D
``[d_frontend, D]`` leaf with D the embedding's width.  Any missing or extra
leaf raises; so does an optional group that is only partly there (the
attention biases, the QK norms, the MoE shared expert), and a ``patch_proj``
of another shape."""
from __future__ import annotations

from typing import Dict, FrozenSet, Mapping, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

_TOP = frozenset({"embed", "final_norm"})
_ATTN = frozenset({
    "blocks/ln1", "blocks/ln2",
    "blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv", "blocks/attn/wo",
})
_MLP = frozenset({"blocks/mlp/wg", "blocks/mlp/wi", "blocks/mlp/wo"})
_MOE = frozenset({"blocks/moe/router", "blocks/moe/wi", "blocks/moe/wg", "blocks/moe/wo"})
_SSD = frozenset(f"blocks/ssd/{k}" for k in (
    "w_in", "conv_w", "w_bc", "w_dt", "a_log", "dt_bias", "d_skip", "w_out", "out_norm"))
_XLSTM = frozenset(
    [f"slstm_blocks/{k}" for k in ("ln", "wz", "wif", "wo_gate", "w_down")]
    + [f"mlstm_blocks/{k}" for k in ("ln", "w_up", "conv_w", "wq", "wk", "wv", "w_gates",
                                     "b_gates", "w_down", "out_norm")])
_PROJ = ("wq", "wk", "wv", "wo")
_ENCDEC = frozenset(
    ["embed", "lm_head", "frame_proj", "final_norm", "enc_final_norm"]
    + [f"enc_blocks/{k}" for k in ("ln1", "ln2")]
    + [f"enc_blocks/attn/{k}" for k in _PROJ] + [f"enc_blocks/mlp/{k}" for k in ("wg", "wi", "wo")]
    + [f"dec_blocks/{k}" for k in ("ln1", "ln_x", "ln2")]
    + [f"dec_blocks/{a}/{k}" for a in ("attn", "xattn") for k in _PROJ]
    + [f"dec_blocks/mlp/{k}" for k in ("wg", "wi", "wo")])
#: optional leaves, each group present in full or not at all
_HEAD = frozenset({"lm_head"})  # untied embeddings
_PATCH = frozenset({"patch_proj"})  # a vlm's patch frontend (num_patches)
_ATTN_GROUPS = (
    frozenset({"blocks/attn/bq", "blocks/attn/bk", "blocks/attn/bv"}),  # qkv_bias
    frozenset({"blocks/attn/q_norm", "blocks/attn/k_norm"}),  # qk_norm
)
_SHARED = frozenset({"blocks/moe/shared_wi", "blocks/moe/shared_wg",
                     "blocks/moe/shared_wo"})  # num_shared_experts


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def _leaf_sets(names) -> Tuple[FrozenSet[str], Tuple[FrozenSet[str], ...]]:
    """The leaves a tree of this family must have, and its optional groups."""
    if any(n.startswith(("enc_blocks/", "dec_blocks/")) for n in names):
        return _ENCDEC, ()
    if any(n.startswith(("slstm_blocks/", "mlstm_blocks/")) for n in names):
        return _TOP | _XLSTM, (_HEAD,)
    if any(n.startswith("blocks/ssd/") for n in names):
        return _TOP | _ATTN | _SSD | _MLP, (_HEAD,)
    if any(n.startswith("blocks/moe/") for n in names):
        return _TOP | _ATTN | _MOE, (_HEAD, *_ATTN_GROUPS, _SHARED)
    return _TOP | _ATTN | _MLP, (_HEAD, *_ATTN_GROUPS, _PATCH)


def lm_params_from_numpy(tree: Mapping, device="cuda") -> dict:
    """Copy every leaf of ``tree`` to a tensor on ``device``; returns the
    port's nested parameter dict."""
    flat = _flatten(tree)
    names = set(flat)
    required, groups = _leaf_sets(names)
    missing = set(required - names)
    for group in groups:
        if names & group:
            missing |= group - names
    extra = names - required - frozenset().union(*groups)
    proj = flat.get("patch_proj")
    if proj is not None and "embed" in flat and (
            np.ndim(proj) != 2 or np.shape(proj)[1] != np.shape(flat["embed"])[1]):
        extra.add(f"patch_proj of shape {np.shape(proj)}")
    if missing or extra:
        raise ValueError(f"LM parameter tree does not fit the port: missing {sorted(missing)}, "
                         f"extra {sorted(extra)}")
    dev = resolve_device(device)
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = _tensor(leaf).to(dev)
    return out


def _tensor(leaf) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of its dtype.  numpy has no bf16 of its
    own: the JAX package's bf16 leaves (bf16 params) come as the 2-byte
    ``bfloat16`` of ``ml_dtypes``, which ``torch.from_numpy`` refuses; its
    bits are carried over as they are."""
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)
