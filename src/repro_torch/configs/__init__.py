"""Architecture registry of the port: the dense GQA transformers, the MoE
family, the recurrent families (hymba, xlstm), the encoder-decoder
(seamless-m4t) and the vlm (pixtral-12b: the dense decoder behind a stubbed
patch frontend).

The JAX package's registry (``repro.configs``) names ten architectures; the
port serves all ten.  :data:`NOT_PORTED` stays, empty: a name in it would
raise ``NotImplementedError`` with the ROADMAP.md item that ports it."""
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
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-1.3b": "xlstm_1_3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "pixtral-12b": "pixtral_12b",
}

#: architectures of the JAX package not ported yet → where ROADMAP.md queues them
NOT_PORTED: dict = {}

ARCH_NAMES = list(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet ({NOT_PORTED[name]})")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}").CONFIG


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU tests: ``repro.configs.reduced_config``
    for the ported families."""
    kw = dict(
        num_layers=4 if cfg.block_pattern != "xlstm" else (cfg.slstm_every or 4),
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
    if cfg.block_pattern == "hymba":
        kw.update(ssm_heads=4, ssm_expand=2, ssm_state=4, window=16,
                  full_attn_layers=(0,), d_ff=128)
    if cfg.block_pattern == "xlstm":
        kw.update(slstm_every=4, d_ff=0)
    if cfg.encdec:
        kw.update(enc_layers=2, d_frontend=24)
    if cfg.num_patches:
        kw.update(num_patches=8, d_frontend=24)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCH_NAMES", "NOT_PORTED", "get_arch",
           "reduced_config"]
