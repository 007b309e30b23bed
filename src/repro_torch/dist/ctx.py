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
is open, so there is no trace cache to get wrong.  A function that autograd
may call on another thread (a checkpointed layer's recomputation) takes the
context with it through :func:`in_current_context`.

Where a function's rows are independent (the MoE dispatch group, a
recurrence per batch row and head) :func:`local_apply` runs it on each
rank's local shards through ``local_map``, as
:func:`repro_torch.nn.attention.attention_core` runs the attention kernel.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch.dist.sharding import (
    ShardingConfig,
    Spec,
    _as_tuple,
    _entry,
    _prod_size,
    cache_spec,
    mesh_axis_sizes,
    placements,
)

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_mesh_and_config() -> Optional[Tuple[object, ShardingConfig]]:
    """The innermost active (mesh, ShardingConfig), or None."""
    stack = _stack()
    return stack[-1][:2] if stack else None


@contextlib.contextmanager
def activation_sharding(mesh, shcfg: ShardingConfig, constrain: bool = True):
    """Activate :func:`ashard` for the ``DeviceMesh`` ``mesh`` under
    ``shcfg``'s rules::

        sh = shardings_for_cell(cfg, shape, mesh)
        with activation_sharding(mesh, sh["shcfg"]):
            params, opt, metrics = step(params, opt, batch)

    ``constrain=False`` keeps the mesh for :func:`local_apply` but makes
    :func:`ashard` pass its DTensor through: DTensor's propagation alone
    lays the activations out, the reference's ``--mode baseline`` (XLA
    propagation without ``with_sharding_constraint``)."""
    _stack().append((mesh, shcfg, constrain))
    try:
        yield
    finally:
        _stack().pop()


def in_current_context(fn):
    """``fn`` bound to the context open now: it runs inside the same
    ``activation_sharding`` wherever it is called, or as it is when none is
    open.  A checkpointed layer needs this: on a card autograd runs its
    backward, and so the recomputation, on a thread of its own, where the
    caller's thread-local context is not seen."""
    stack = _stack()
    if not stack:
        return fn
    ctx = stack[-1]

    def bound(*args, **kwargs):
        now = _stack()
        if now and now[-1] is ctx:
            return fn(*args, **kwargs)
        with activation_sharding(*ctx):
            return fn(*args, **kwargs)

    return bound


def _logical_axes(mesh, shcfg: ShardingConfig) -> dict:
    """{"dp": its mesh axes, "tp": its mesh axis} on ``mesh`` (empty where the
    mesh lacks them)."""
    sizes = mesh_axis_sizes(mesh)
    return {"dp": tuple(a for a in shcfg.dp_axes if a in sizes),
            "tp": (shcfg.tp_axis,) if shcfg.tp_axis in sizes else ()}


def _splits(n: int, k: int, uneven: bool) -> bool:
    """Whether a dim of ``n`` splits over ``k`` ranks: evenly, or with
    ``uneven`` in DTensor's chunks (ceil(n / k) a rank, the last one shorter)
    as long as no rank's chunk is empty.  A dim of 1 never splits: over more
    than one rank it cannot, and over one DTensor's view rules drop it as a
    singleton, so a flatten across it (``[1, S, D] @ W``) is refused as a
    reshape of the sharded dim."""
    return n > 1 and (n % k == 0 or (uneven and -(-n // k) * (k - 1) < n))


def _activation_spec(shape, logical_axes, mesh, shcfg: ShardingConfig, uneven=()) -> Spec:
    """Map ("dp"|"tp"|None, ...) onto mesh axes, divisibility-checked.

    ``logical_axes`` may be shorter than the rank; trailing dims replicate.
    A mesh axis is used at most once (first dim wins), and any dim not
    divisible by its axes falls back to replicated, so the same annotation
    is valid for 4-head test models and 128-head production models.  A
    logical axis named in ``uneven`` also splits a dim it does not divide
    (:func:`_splits`).
    """
    sizes = mesh_axis_sizes(mesh)
    lookup = _logical_axes(mesh, shcfg)
    used: set = set()
    entries = []
    for i, dim in enumerate(shape):
        ax = logical_axes[i] if i < len(logical_axes) else None
        mesh_axes = _as_tuple(lookup.get(ax, ())) if ax is not None else ()
        if (mesh_axes and not any(m in used for m in mesh_axes)
                and _splits(dim, _prod_size(mesh_axes, sizes), ax in uneven)):
            used.update(mesh_axes)
            entries.append(_entry(mesh_axes))
        else:
            entries.append(None)
    return tuple(entries)


def activation_placements(shape, *logical_axes: Optional[str], uneven=()) -> Optional[tuple]:
    """The placements :func:`ashard` gives a tensor of ``shape`` inside the
    current context, or None outside one."""
    ctx = current_mesh_and_config()
    if ctx is None:
        return None
    mesh, shcfg = ctx
    return placements(_activation_spec(tuple(shape), logical_axes, mesh, shcfg, uneven), mesh)


def axis_size(name: str) -> int:
    """The number of ranks the logical axis ``name`` ("dp" or "tp") spans in
    the current context; 1 outside one."""
    ctx = current_mesh_and_config()
    if ctx is None:
        return 1
    mesh, shcfg = ctx
    axes = _logical_axes(mesh, shcfg)[name]
    return _prod_size(axes, mesh_axis_sizes(mesh)) if axes else 1


def tp_rank() -> int:
    """This rank's coordinate along the "tp" mesh axis of the current
    context; 0 outside one."""
    ctx = current_mesh_and_config()
    if ctx is None or ctx[1].tp_axis not in mesh_axis_sizes(ctx[0]):
        return 0
    return ctx[0].get_local_rank(ctx[1].tp_axis)


def replicate_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``x``'s mesh when ``x`` is a DTensor,
    else ``t`` itself: for a constant every rank computes alike (RoPE's
    angles, a zero aux loss) that meets a DTensor in one op."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def ashard(x: torch.Tensor, *logical_axes: Optional[str], uneven=()) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the logical axes, or pass through.
    The logical axes named in ``uneven`` split a dim they do not divide too
    (DTensor's uneven chunks).

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
    if not _stack()[-1][2]:  # constrain=False: propagation decides
        return x
    mesh, _ = ctx
    target = activation_placements(x.shape, *logical_axes, uneven=uneven)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def split_heads(t: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    """``t`` [..., n·head_dim] as [..., n, head_dim].  Under a mesh whose split
    of the last dim does not divide the n heads (8 KV heads, or hymba's 25,
    over a model axis of 16), DTensor refuses the uneven unflatten: that dim
    is gathered whole first, as the reference's divisibility check
    replicates such a head dim.  Outside :func:`activation_sharding` tensors
    reshape as they are."""
    if getattr(_state, "stack", None):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if isinstance(t, DTensor):
            last = t.ndim - 1
            cut = [isinstance(pl, Shard) and pl.dim == last for pl in t.placements]
            mesh = t.device_mesh
            if n % math.prod(mesh.size(i) for i, c in enumerate(cut) if c):
                t = t.redistribute(mesh, [Replicate() if c else pl
                                          for pl, c in zip(t.placements, cut)])
    return t.reshape(*t.shape[:-1], n, head_dim)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``t`` [B, …, n, head_dim] as [B, …, n·head_dim], :func:`split_heads`'s
    inverse.  Under a mesh it runs on each rank's heads (:func:`local_apply`),
    so that the gradient comes back in the heads' own layout: a gradient
    split over a model axis that does not divide n (hymba's 25 heads over 16)
    cannot be unflattened by DTensor."""
    if not getattr(_state, "stack", None):
        return t.reshape(*t.shape[:-2], -1)
    mid = (None,) * (t.ndim - 3)
    return local_apply(lambda x: x.reshape(*x.shape[:-2], -1), (t,),
                       (("dp", *mid, "tp", None),), (("dp", *mid, "tp"),))


def cache_tensor(shape, fill: float, dtype: torch.dtype, device, batch: int) -> torch.Tensor:
    """A decode-cache leaf of ``shape`` filled with ``fill``: a tensor on
    ``device`` outside a context; inside one, a DTensor made in its shards
    under :func:`~repro_torch.dist.sharding.cache_spec` (``batch`` locates
    the batch dim), so that each rank allocates its own shard and no rank
    ever holds the whole cache."""
    ctx = current_mesh_and_config()
    if ctx is None:
        return torch.full(tuple(shape), fill, dtype=dtype, device=device)
    from torch.distributed.tensor import full

    mesh, shcfg = ctx
    return full(tuple(shape), fill, dtype=dtype, device_mesh=mesh,
                placements=placements(cache_spec(shape, mesh, shcfg, batch), mesh))


def vocab_split(x: torch.Tensor):
    """``(x, group, offset)`` for a function that reads ``x`` [B, …, V] on
    each rank's slice of its last dim.  Outside a context ``(x, None, 0)``.
    Inside one, ``x`` redistributed to its batch over "dp" and its last dim
    over "tp", unevenly where "tp" does not divide it (the placements
    :func:`local_apply` gives ``("dp", …, "tp")`` with ``uneven=("tp",)``),
    the process group of that split (None where it spans one rank) and the
    index of this rank's first entry of the last dim, from DTensor's own
    layout."""
    ctx = current_mesh_and_config()
    if ctx is None:
        return x, None, 0
    from torch.distributed.tensor import Shard

    mesh, shcfg = ctx
    x = ashard(x, "dp", *(None,) * (x.ndim - 2), "tp", uneven=("tp",))
    tp = _logical_axes(mesh, shcfg)["tp"]
    last = x.ndim - 1
    dim = mesh.mesh_dim_names.index(tp[0]) if tp else None
    if dim is None or mesh.size(dim) == 1 or not x.placements[dim].is_shard(last):
        return x, None, 0
    # "tp" alone splits the last dim: this rank's chunk of it is DTensor's own
    _, offset = Shard.local_shard_size_and_offset(x.shape[last], mesh.size(dim),
                                                  mesh.get_local_rank(dim))
    return x, mesh.get_group(dim), offset


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flat(values, axes):
    """(leaves, their axes): a NamedTuple value is its fields, with a
    sequence of axes a field; anything else is one leaf."""
    leaves, leaf_axes = [], []
    for v, a in zip(values, axes):
        if _is_record(v):
            leaves.extend(v)
            leaf_axes.extend(a)
        else:
            leaves.append(v)
            leaf_axes.append(a)
    return leaves, leaf_axes


def _unflat(template, leaves):
    """``template``'s structure (a tuple of values and NamedTuples) over ``leaves``."""
    it = iter(leaves)
    return tuple(type(t)(*(next(it) for _ in t)) if _is_record(t) else next(it)
                 for t in template)


def local_apply(fn, args: tuple, in_axes: tuple, out_axes: tuple, uneven=()):
    """``fn(*args)`` on each rank's local shards, for a function whose rows
    along some logical axes are independent (a recurrence per batch row and
    head, the MoE's per-row dispatch).

    ``in_axes`` gives each argument's logical axes ("dp", "tp" or None a
    dim, as :func:`ashard` takes them; a NamedTuple argument takes a
    sequence of axes, one a field), ``out_axes`` each output's.  With no
    DTensor among the arguments this is ``fn(*args)``.  Otherwise a logical
    axis splits the work only if every argument dim it names divides over
    its mesh axes; each DTensor is redistributed to those placements (an
    argument without the axis whole), ``fn`` runs on the local tensors
    through ``local_map``, and the outputs come back as DTensors on the same
    split.  A whole argument's gradient is ``Partial`` over the mesh dims
    that split the work (each rank's rows add to it) and so is summed, as
    :func:`repro_torch.nn.layers.embed_lookup`'s table's.  Non-tensor
    arguments (None, ints) pass through.  A logical axis named in ``uneven``
    also splits a dim it does not divide, in DTensor's uneven chunks, for an
    input only: an output's global shape is taken from its local one.
    Outside :func:`activation_sharding` (no mesh) this is ``fn(*args)`` at
    once."""
    if not getattr(_state, "stack", None):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    leaves, leaf_axes = _flat(args, in_axes)
    dts = [x for x in leaves if isinstance(x, DTensor)]
    if not dts:
        return fn(*args)
    mesh, shcfg = current_mesh_and_config()
    sizes = mesh_axis_sizes(mesh)
    lookup = _logical_axes(mesh, shcfg)
    active = {}
    for name, axes in lookup.items():
        dims = [x.shape[d] for x, ax in zip(leaves, leaf_axes) if isinstance(x, DTensor)
                for d, a in enumerate(ax) if a == name]
        active[name] = bool(axes and dims) and all(
            _splits(n, _prod_size(axes, sizes), name in uneven) for n in dims)
    owner = {m: name for name, axes in lookup.items() if active[name] for m in axes}
    names = tuple(mesh.mesh_dim_names)

    def pl(ax):
        return tuple(Shard(ax.index(owner[m])) if m in owner and owner[m] in ax else Replicate()
                     for m in names)

    def grad_pl(ax):
        return tuple(Shard(ax.index(owner[m])) if m in owner and owner[m] in ax
                     else Partial() if m in owner else Replicate() for m in names)

    # local_map takes the leaves that are not None (a pytree's None has no leaf)
    given = [i for i, x in enumerate(leaves) if x is not None]
    in_pl = tuple(pl(leaf_axes[i]) if isinstance(leaves[i], DTensor) else None for i in given)
    in_grad = tuple(grad_pl(leaf_axes[i]) if isinstance(leaves[i], DTensor) else None
                    for i in given)
    placed = [leaves[i].redistribute(mesh, p)
              if p is not None and tuple(leaves[i].placements) != p else leaves[i]
              for i, p in zip(given, in_pl)]
    out_leaves_axes = []
    for a in out_axes:
        out_leaves_axes.extend(a if a and not isinstance(a[0], (str, type(None))) else [a])
    template = []

    def body(*local):
        full = [None] * len(leaves)
        for i, x in zip(given, local):
            full[i] = x
        out = fn(*_unflat(args, full))
        single = not isinstance(out, tuple) or _is_record(out)
        outs = (out,) if single else out
        template.append((single, outs))
        return tuple(_flat(outs, out_axes)[0])

    run = local_map(body, out_placements=tuple(pl(a) for a in out_leaves_axes),
                    in_placements=in_pl, in_grad_placements=in_grad, device_mesh=mesh)
    flat_out = run(*placed)
    single, outs = template[-1]
    rebuilt = _unflat(outs, flat_out)
    return rebuilt[0] if single else rebuilt
