"""Architecture registry of the port: the dense GQA transformers and the MoE
family.

The JAX package's registry (``repro.configs``) names ten architectures; the
port serves the four dense ones and the two MoE ones, which share its LM
path but for the feed-forward half of a block.  Naming one of the other four
raises ``NotImplementedError`` with the ROADMAP.md item that ports its
family."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-3-2b": "granite_3_2b",
    "llama3.2-1b": "llama3_2_1b",
    "minicpm-2b": "minicpm_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
}

#: architectures of the JAX package not ported yet → where ROADMAP.md queues them
NOT_PORTED = {
    "hymba-1.5b": "hybrid: ROADMAP.md Queue 1 item 10d (nn/ssm.py, ring decode)",
    "xlstm-1.3b": "ssm/xlstm: ROADMAP.md Queue 1 item 10d (nn/ssm.py)",
    "seamless-m4t-large-v2": "audio/encdec: ROADMAP.md Queue 1 item 10e (models/encdec.py)",
    "pixtral-12b": "vlm: ROADMAP.md Queue 1 item 10f (the patch frontend)",
}

ARCH_NAMES = list(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet ({NOT_PORTED[name]})")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}").CONFIG


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU tests: ``repro.configs.reduced_config``
    for the dense and MoE families."""
    kw = dict(
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
        chunk=16,
    )
    if cfg.is_moe:
        kw.update(num_experts=8, top_k=2, moe_d_ff=32, d_ff=0)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCH_NAMES", "NOT_PORTED", "get_arch",
           "reduced_config"]
