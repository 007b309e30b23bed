"""Weights bridge: the JAX package's LM parameter tree, as numpy, into the
port's parameters.

    tree = jax.tree.map(np.asarray, repro.models.init_model(key, cfg)[0])
    params = lm_params_from_numpy(tree, "cuda")

Leaf by leaf, same names, shapes and dtypes.  Any missing or extra leaf
raises; so does an optional group that is only partly there (the attention
biases, the QK norms)."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

_REQUIRED = frozenset({
    "embed", "final_norm", "blocks/ln1", "blocks/ln2",
    "blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv", "blocks/attn/wo",
    "blocks/mlp/wg", "blocks/mlp/wi", "blocks/mlp/wo",
})
#: optional leaves, each group present in full or not at all
_GROUPS = (
    frozenset({"lm_head"}),  # untied embeddings
    frozenset({"blocks/attn/bq", "blocks/attn/bk", "blocks/attn/bv"}),  # qkv_bias
    frozenset({"blocks/attn/q_norm", "blocks/attn/k_norm"}),  # qk_norm
)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def lm_params_from_numpy(tree: Mapping, device="cuda") -> dict:
    """Copy every leaf of ``tree`` to a tensor on ``device``; returns the
    port's nested parameter dict."""
    flat = _flatten(tree)
    names = set(flat)
    missing = set(_REQUIRED - names)
    for group in _GROUPS:
        if names & group:
            missing |= group - names
    extra = names - _REQUIRED - frozenset().union(*_GROUPS)
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
        node[last] = torch.from_numpy(np.array(leaf, copy=True)).to(dev)
    return out
