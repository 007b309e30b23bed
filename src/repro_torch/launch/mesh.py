"""Production mesh construction: the counterpart of ``repro.launch.mesh``.

Single pod: 16 × 16 ``("data", "model")``; multi-pod: 2 × 16 × 16 ``("pod",
"data", "model")``.  ``pipeline_stages > 1`` carves a ``"stage"`` axis out of
the data axis for :func:`repro_torch.dist.pipeline.pipeline_apply`.  The
shape logic is the pure :func:`production_mesh_shape`; the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, which the caller initialises (NCCL across cards, gloo on the
CPU).  A function, not a module constant: importing this module touches no
process group.
"""
from __future__ import annotations

import math
from typing import Tuple


def production_mesh_shape(*, multi_pod: bool = False, pipeline_stages: int = 0
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of the production mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if pipeline_stages > 1:
        data_idx = len(shape) - 2
        if shape[data_idx] % pipeline_stages:
            raise ValueError(
                f"pipeline_stages={pipeline_stages} must divide data axis {shape[data_idx]}")
        shape = (*shape[:data_idx], pipeline_stages, shape[data_idx] // pipeline_stages,
                 shape[-1])
        axes = (*axes[:data_idx], "stage", "data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, pipeline_stages: int = 0,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over ranks 0 … n−1 of the default process
    group (n = the shape's product).  Raises when the group is not
    initialised or has fewer than n ranks; with more, the first n form the
    mesh, as the reference takes the first n devices."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape, axes = production_mesh_shape(multi_pod=multi_pod, pipeline_stages=pipeline_stages)
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"need an initialised torch.distributed process group of {n} ranks "
                           f"for mesh {shape}")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}; have {world}")
    if world == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)
