"""Activation-sharding context: :func:`activation_sharding` and :func:`ashard`,
the counterparts of ``repro.dist.ctx``.

Model code annotates activations with *logical* activation axes ("dp" =
batch-like, "tp" = head/feature-like, None = replicated) instead of mesh
names, so the same forward pass runs unmodified on one device or on a mesh.
:func:`ashard` returns its input itself unless the caller opened an
``activation_sharding(mesh, shcfg)`` context; single-device runs never pay
for it.

Inside a context the model runs on DTensors (``torch.distributed.tensor``):
the parameters and the batch are placed on the mesh
(:func:`repro_torch.dist.sharding.distribute`), DTensor's sharding
propagation picks each op's layout (PyTorch's form of the GSPMD propagation
the reference relies on), and :func:`ashard` redistributes an activation to
the divisibility-checked placements of its annotation: the counterpart of
``with_sharding_constraint``.  A plain tensor inside a context raises: the
caller forgot to place an input, and a silent unsharded run is what the
context exists to rule out.

The context is thread-local and eager: it applies to the ops run while it
is open, so there is no trace cache to get wrong.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

from repro_torch.dist.sharding import (
    NamedSharding,
    ShardingConfig,
    Spec,
    _as_tuple,
    _entry,
    _prod_size,
    cache_specs,
    distribute_tree,
    mesh_axis_sizes,
    placements,
)
from repro_torch.train.tree import tree_map

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_mesh_and_config() -> Optional[Tuple[object, ShardingConfig]]:
    """The innermost active (mesh, ShardingConfig), or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def activation_sharding(mesh, shcfg: ShardingConfig):
    """Activate :func:`ashard` for the ``DeviceMesh`` ``mesh`` under
    ``shcfg``'s rules::

        sh = shardings_for_cell(cfg, shape, mesh)
        with activation_sharding(mesh, sh["shcfg"]):
            params, opt, metrics = step(params, opt, batch)
    """
    _stack().append((mesh, shcfg))
    try:
        yield
    finally:
        _stack().pop()


def _activation_spec(shape, logical_axes, mesh, shcfg: ShardingConfig) -> Spec:
    """Map ("dp"|"tp"|None, ...) onto mesh axes, divisibility-checked.

    ``logical_axes`` may be shorter than the rank; trailing dims replicate.
    A mesh axis is used at most once (first dim wins), and any dim not
    divisible by its axes falls back to replicated, so the same annotation
    is valid for 4-head test models and 128-head production models.
    """
    sizes = mesh_axis_sizes(mesh)
    lookup = {
        "dp": tuple(a for a in shcfg.dp_axes if a in sizes),
        "tp": (shcfg.tp_axis,) if shcfg.tp_axis in sizes else (),
    }
    used: set = set()
    entries = []
    for i, dim in enumerate(shape):
        ax = logical_axes[i] if i < len(logical_axes) else None
        mesh_axes = _as_tuple(lookup.get(ax, ())) if ax is not None else ()
        if (mesh_axes and not any(m in used for m in mesh_axes)
                and dim % _prod_size(mesh_axes, sizes) == 0):
            used.update(mesh_axes)
            entries.append(_entry(mesh_axes))
        else:
            entries.append(None)
    return tuple(entries)


def activation_placements(shape, *logical_axes: Optional[str]) -> Optional[tuple]:
    """The placements :func:`ashard` gives a tensor of ``shape`` inside the
    current context, or None outside one."""
    ctx = current_mesh_and_config()
    if ctx is None:
        return None
    mesh, shcfg = ctx
    return placements(_activation_spec(tuple(shape), logical_axes, mesh, shcfg), mesh)


def replicate_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``x``'s mesh when ``x`` is a DTensor,
    else ``t`` itself: for a constant every rank computes alike (RoPE's
    angles, a zero aux loss) that meets a DTensor in one op."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def ashard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the logical axes, or pass through.

    Outside an :func:`activation_sharding` context this returns ``x`` itself,
    which keeps every single-device code path unchanged."""
    ctx = current_mesh_and_config()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError("ashard inside activation_sharding needs a DTensor (place the "
                        "parameters and the batch on the mesh first), got a "
                        f"{type(x).__name__}")
    mesh, _ = ctx
    target = activation_placements(x.shape, *logical_axes)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def place_cache(cache, batch: int):
    """A fresh decode cache (a NamedTuple of tensors, the index a host int)
    on the current context's mesh under :func:`cache_specs`; the cache itself
    outside a context."""
    ctx = current_mesh_and_config()
    if ctx is None:
        return cache
    mesh, shcfg = ctx
    specs = cache_specs(cache, mesh, shcfg, batch=batch)
    return distribute_tree(cache, tree_map(lambda s: NamedSharding(mesh, s), specs))
