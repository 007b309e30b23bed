"""Step builders and input specs for training and serving, on one device or
under a mesh: the counterpart of ``repro.launch.steps``.

One definition of ``train_step`` / ``prefill_step`` / ``serve_step`` per
architecture, and :func:`shardings_for_cell`, which derives every sharding a
cell needs from the logical-axis rules (:mod:`repro_torch.dist.sharding`).
The abstract inputs (:func:`batch_struct`, :func:`serve_cache_struct`,
:func:`params_struct`) are tensors on the ``meta`` device: shapes and
dtypes, no allocation.

Under a mesh the steps take DTensors (placed with
:func:`repro_torch.dist.sharding.distribute_tree`) and run inside
:func:`repro_torch.dist.ctx.activation_sharding`::

    mesh = init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model"))
    sh = shardings_for_cell(cfg, ShapeConfig("tiny", 16, 8, "train"), mesh)
    params = distribute_tree(params, sh["params_sharding"])
    opt = distribute_tree(adamw_init(params), sh["opt_sharding"])
    with activation_sharding(mesh, sh["shcfg"]):
        params, opt, metrics = make_train_step(cfg, opt_cfg)(params, opt, batch)
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist.sharding import (
    NamedSharding,
    ShardingConfig,
    auto_spec,
    batch_specs,
    cache_specs,
    mesh_axis_sizes,
    opt_state_specs,
    tree_shardings,
)
from repro_torch.models import decode_step, init_cache, init_model_with_axes, prefill
from repro_torch.models.encdec import EncDecCache
from repro_torch.train.optimizer import OptConfig, OptState, adamw_init, adamw_update
from repro_torch.train.trainer import value_and_grad
from repro_torch.train.tree import tree_map

_META = torch.device("meta")


# ---------------------------------------------------------------------- #
# abstract inputs (meta tensors: never allocates)
# ---------------------------------------------------------------------- #
def batch_struct(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    out = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device=_META),
        "labels": torch.empty((b, s), dtype=torch.int32, device=_META),
    }
    if cfg.encdec:
        out["frames"] = torch.empty((b, s, cfg.d_frontend), dtype=torch.bfloat16, device=_META)
    if cfg.num_patches:
        out["patches"] = torch.empty((b, cfg.num_patches, cfg.d_frontend), dtype=torch.bfloat16,
                                     device=_META)
    return out


def serve_cache_struct(cfg: ArchConfig, b: int, s_max: int):
    """Abstract bf16 decode cache (the encoder-decoder's cross memory spans
    ``s_max`` source frames)."""
    if cfg.encdec:
        hd, L = cfg.resolved_head_dim, cfg.num_layers

        def mk(heads):
            return torch.empty((L, b, heads, s_max, hd), dtype=torch.bfloat16, device=_META)

        return EncDecCache(k=mk(cfg.num_kv_heads), v=mk(cfg.num_kv_heads),
                           mem_k=mk(cfg.num_heads), mem_v=mk(cfg.num_heads), index=0)
    return init_cache(cfg, b, s_max, torch.bfloat16, device=_META)


def params_struct(cfg: ArchConfig) -> Tuple[Any, Any]:
    """(param tree of meta tensors, logical-axes tree) from one init of the
    full config on the ``meta`` device."""
    with torch.device(_META):
        return init_model_with_axes(torch.Generator(), cfg)


# ---------------------------------------------------------------------- #
# step functions
# ---------------------------------------------------------------------- #
def _like_params(grads, params):
    """Each DTensor gradient redistributed, in place in its tree, to its
    parameter's placements (the reduce-scatter of FSDP), so that the old
    layout is freed leaf by leaf; plain gradients stay as they are."""
    from torch.distributed.tensor import DTensor

    for k, g in grads.items():
        p = params[k]
        if isinstance(g, dict):
            _like_params(g, p)
        elif isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
            grads[k] = g.redistribute(p.device_mesh, p.placements)
    return grads


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig):
    """``train_step(params, opt_state, batch) → (params, opt_state, {"loss",
    "lr", "ce", "aux"})``."""

    def train_step(params, opt_state: OptState, batch):
        loss, metrics, grads = value_and_grad(params, cfg, batch)
        grads = _like_params(grads, params)
        new_params, new_state, lr = adamw_update(grads, opt_state, params, opt_cfg)
        return new_params, new_state, {"loss": loss, "lr": lr, **metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig, s_max: int):
    def prefill_step(params, batch):
        return prefill(params, cfg, batch, s_max)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, token):
        return decode_step(params, cfg, token, cache)

    return serve_step


# ---------------------------------------------------------------------- #
# sharding assembly
# ---------------------------------------------------------------------- #
def shardings_for_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, fsdp_train: bool = True):
    """Everything a cell's steps need, with the reference's keys: ``shcfg``,
    the abstract params and their shardings, the batch's, and the optimizer
    state's (train) or the cache's and the token's (prefill, decode).  The
    shardings are :class:`~repro_torch.dist.sharding.NamedSharding` s on
    ``mesh``: a ``DeviceMesh``, or for the specs alone any object with
    ``axis_names`` and ``devices``."""
    dp_axes = ("pod", "data") if "pod" in mesh_axis_sizes(mesh) else ("data",)
    # training shards params over data (FSDP); serving keeps TP-only params
    shcfg_train = ShardingConfig(fsdp=fsdp_train, dp_axes=dp_axes)
    shcfg_serve = ShardingConfig(fsdp=False, dp_axes=dp_axes)
    shcfg = shcfg_train if shape.kind == "train" else shcfg_serve

    pstruct, axes = params_struct(cfg)
    out: Dict[str, Any] = {
        "shcfg": shcfg,
        "params_struct": pstruct,
        "params_sharding": tree_shardings(axes, mesh, shcfg, shapes_tree=pstruct),
    }
    bstruct = batch_struct(cfg, shape)
    out["batch_struct"] = bstruct
    out["batch_sharding"] = {k: NamedSharding(mesh, s)
                             for k, s in batch_specs(bstruct, mesh, shcfg).items()}
    if shape.kind == "train":
        # ZeRO: moments always take the dp-sharded (FSDP) layout, even when
        # the params themselves are TP-only (opt_state_specs docstring)
        msharding = opt_state_specs(axes, mesh, shcfg, shapes_tree=pstruct)
        out["opt_struct"] = adamw_init(pstruct)
        out["opt_sharding"] = OptState(m=msharding, v=msharding, count=NamedSharding(mesh, ()))
    else:
        s_max = shape.seq_len + (cfg.num_patches or 0)
        cstruct = serve_cache_struct(cfg, shape.global_batch, s_max)
        out["cache_struct"] = cstruct
        out["cache_sharding"] = tree_map(lambda s: NamedSharding(mesh, s),
                                         cache_specs(cstruct, mesh, shcfg,
                                                     batch=shape.global_batch))
        out["token_struct"] = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                          device=_META)
        out["token_sharding"] = NamedSharding(
            mesh, auto_spec((shape.global_batch, 1), mesh, shcfg, batch_dim=0))
        out["s_max"] = s_max
    return out
