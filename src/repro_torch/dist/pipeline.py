"""Microbatched pipeline parallelism over a mesh's ``"stage"`` dim: the
counterpart of ``repro.dist.pipeline``.

:func:`pipeline_apply` runs a layer-stacked block function as a GPipe
pipeline: the rank at stage s of the mesh holds stage s's slice of the
stacked parameters, microbatches stream through, and each tick
``torch.distributed`` point-to-point (``batch_isend_irecv``) moves every
stage's output to stage s + 1.  The schedule is the classic (num_micro +
num_stages − 1)-tick fill and drain; every microbatch sees the same op
sequence as in :func:`sequential_reference`, on another rank per stage.
Forward only, as the reference's.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train.tree import tree_leaves, tree_map


def sequential_reference(block: Callable[[Any, torch.Tensor], torch.Tensor], params,
                         x: torch.Tensor) -> torch.Tensor:
    """Single-device reference: apply the S stacked stages in order.

    ``params`` is a tree whose leaves all carry a leading stage dim S; stage
    s runs ``block(params[s], x)``."""
    num_stages = tree_leaves(params)[0].shape[0]
    for s in range(num_stages):
        x = block(tree_map(lambda a: a[s], params), x)  # noqa: B023
    return x


def pipeline_apply(block: Callable[[Any, torch.Tensor], torch.Tensor], params,
                   x: torch.Tensor, mesh, stage_axis: str = "stage",
                   num_micro: int = 4) -> torch.Tensor:
    """Pipeline-parallel :func:`sequential_reference` over ``mesh``'s stage
    dim.

    Every rank passes the same ``params`` (the full stacked tree, or DTensors
    sharded on their leading dim over the stage dim) and the same ``x``, and
    gets the whole output.  The batch dim of ``x`` is split into
    ``num_micro`` microbatches; ``block`` must keep a microbatch's shape.  A
    rank's other mesh dims see the same data (compose tensor parallelism
    inside ``block`` if wanted).  The last stage's outputs reach every rank
    by a sum over the stage group in which the other stages add zeros, as
    the reference's masked ``psum``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    group = mesh.get_group(stage_axis)
    num_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    idx = mesh.get_local_rank(stage_axis)
    batch = x.shape[0]
    if batch % num_micro != 0:
        raise ValueError(f"batch {batch} not divisible by num_micro={num_micro}")
    leaves = tree_leaves(params)
    stage_dim = leaves[0].shape[0]
    if stage_dim != num_stages:
        raise ValueError(f"params leading dim {stage_dim} != mesh '{stage_axis}' size "
                         f"{num_stages}")
    stage_params = tree_map(lambda a: a.to_local()[0] if isinstance(a, DTensor) else a[idx],
                            params)
    xs = x.reshape(num_micro, batch // num_micro, *x.shape[1:])
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(idx + 1) % num_stages], ranks[(idx - 1) % num_stages]

    state = torch.zeros_like(xs[0])
    out_buf = torch.zeros_like(xs)
    for t in range(num_micro + num_stages - 1):
        # stage 0 injects microbatch t (clamped: ticks past the fill phase
        # recompute a stale microbatch whose output is never kept)
        inp = xs[min(t, num_micro - 1)] if idx == 0 else state
        y = block(stage_params, inp)
        m = t - (num_stages - 1)  # the microbatch the last stage finished
        if idx == num_stages - 1 and m >= 0:
            out_buf[m] = y
        if num_stages > 1:
            recv = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, recv, prv, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            state = recv
    # only the last stage holds real outputs; the sum broadcasts them
    if idx != num_stages - 1:
        out_buf.zero_()
    dist.all_reduce(out_buf, group=group)
    return out_buf.reshape(batch, *x.shape[1:])
