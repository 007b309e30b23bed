"""Parameter trees with paired logical sharding axes: the counterpart of
``repro.nn.param``.

Every parameter is made as ``Param(value, axes)``, where ``axes`` is a tuple
of logical axis names (one per dim, ``None`` = replicated).  Model init
builds one tree; :func:`unzip` splits it into the value tree (for compute)
and the axes tree (for the rules of :mod:`repro_torch.dist.sharding`), so
the axes come from the same calls that make the values.

The reference draws from split ``jax.random`` keys; the port draws from one
``torch.Generator`` in the order the calls are made, on the generator's
device.  Inside ``with torch.device("meta")`` the values are made on the
``meta`` device instead: shapes and dtypes with no allocation
(:func:`repro_torch.launch.steps.params_struct`).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch


class Param(NamedTuple):
    value: Any
    axes: Tuple[Optional[str], ...]


def is_param(x) -> bool:
    return isinstance(x, Param)


def unzip(tree):
    """A tree of :class:`Param` → ``(values, axes)``, two trees of its shape."""
    if isinstance(tree, dict):
        parts = {k: unzip(v) for k, v in tree.items()}
        return {k: p[0] for k, p in parts.items()}, {k: p[1] for k, p in parts.items()}
    if not is_param(tree):
        raise TypeError(f"expected a Param or a dict of them, got {type(tree).__name__}")
    return tree.value, tree.axes


def device_of(gen: torch.Generator) -> torch.device:
    """Where the values go: ``meta`` inside ``with torch.device("meta")``,
    else ``gen``'s device."""
    if torch.get_default_device().type == "meta":
        return torch.device("meta")
    return gen.device


def normal(gen: torch.Generator, shape, std: float, axes, dtype=torch.float32) -> Param:
    """``std · normal`` (scaled in place: the expert stacks are the largest
    tensors of a model)."""
    return Param(torch.randn(tuple(shape), generator=gen, dtype=dtype,
                             device=device_of(gen)).mul_(std), tuple(axes))


def _fan_in_std(shape, scale: float) -> float:
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    return scale / (fan_in ** 0.5)


def dense(gen: torch.Generator, shape, axes, dtype=torch.float32, scale: float = 1.0) -> Param:
    """``scale · normal · fan_in^-1/2`` with fan_in = shape[0]."""
    return normal(gen, shape, _fan_in_std(shape, scale), axes, dtype)


def stacked_dense(gen: torch.Generator, layers: int, shape, axes, dtype=torch.float32,
                  scale: float = 1.0) -> Param:
    """``[layers, *shape]``, each layer as :func:`dense`; the leading axis's
    logical name is ``"layers"``."""
    return normal(gen, (layers, *shape), _fan_in_std(shape, scale), ("layers", *axes), dtype)


def zeros(shape, axes, dtype=torch.float32, *, gen: torch.Generator) -> Param:
    return Param(torch.zeros(tuple(shape), dtype=dtype, device=device_of(gen)), tuple(axes))


def ones(shape, axes, dtype=torch.float32, *, gen: torch.Generator) -> Param:
    return Param(torch.ones(tuple(shape), dtype=dtype, device=device_of(gen)), tuple(axes))


def stacked_zeros(layers: int, shape, axes, dtype=torch.float32, *,
                  gen: torch.Generator) -> Param:
    return zeros((layers, *shape), ("layers", *axes), dtype, gen=gen)


def stacked_ones(layers: int, shape, axes, dtype=torch.float32, *,
                 gen: torch.Generator) -> Param:
    return ones((layers, *shape), ("layers", *axes), dtype, gen=gen)
