"""Sharding rules: the counterpart of ``repro.dist.sharding``.

Two halves.  The LM half is the reference's logical-axis rule system
(MaxText pattern): every parameter carries a tuple of *logical* axis names
(:mod:`repro_torch.nn.param`), :meth:`ShardingConfig.rules` maps them to
mesh axes, and :func:`spec_for_axes`, :func:`auto_spec`,
:func:`tree_shardings`, :func:`batch_specs`, :func:`cache_specs` and
:func:`opt_state_specs` turn shapes into specs.  A spec is a tuple with one
entry per tensor dim, each ``None``, a mesh-axis name, or a tuple of names
(the entries of a ``PartitionSpec``).  The spec logic reads only a mesh's
axis names and sizes (:func:`mesh_axis_sizes`), so it takes a
``torch.distributed.device_mesh.DeviceMesh`` and the reference tests'
``FakeMesh`` (``axis_names`` and a ``devices`` array) alike.
:func:`placements` turns a spec on a ``DeviceMesh`` into DTensor placements,
one a mesh dim: ``Shard(d)`` where tensor dim d's entry names the mesh dim,
else ``Replicate()``; an entry of two names, ``("pod", "data")``, shards one
tensor dim over two mesh dims.

The GNN half holds the halo-exchange knobs of the row-sharded streaming
backends: :class:`CommsConfig` (with its validation), :func:`rotation_perm`,
and :func:`stream_shards`, the counterpart of ``stream_mesh``.  The
reference lays the ``S`` shards over a 1-D mesh of ``S`` devices.  The port
runs them through a :class:`~repro_torch.dist.exchange.HaloExchange`: all
``S`` in one process on one device
(:class:`~repro_torch.dist.exchange.LoopbackExchange`), or one shard per
``torch.distributed`` process (:class:`~repro_torch.dist.exchange.DistExchange`).
The reference's ``stream_state_specs`` places the engine's blocks on that
mesh; the port's backends hold their shards' blocks themselves, so it has
no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.train.tree import tree_map

# A rule maps a logical axis name to one mesh axis, a tuple of mesh axes
# (e.g. FSDP over ("pod", "data")), or None (replicated).
MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """How logical axes map onto the mesh.

    ``fsdp``    — shard the ``embed`` dim of every weight over ``dp_axes``
                  (ZeRO-3: params, grads and optimizer state all sharded).
                  With ``fsdp=False`` params are TP-only (serving layout);
                  optimizer state can still be dp-sharded via
                  :func:`opt_state_specs` (ZeRO-1).
    ``dp_axes`` — mesh axes that jointly form the data-parallel group
                  (("data",) single pod, ("pod", "data") multi-pod).
    ``tp_axis`` — the tensor-parallel mesh axis.
    """

    fsdp: bool = True
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"

    def rules(self) -> Rules:
        dp = tuple(self.dp_axes)
        return {
            # weight matrices: contracting/output dims over TP
            "vocab": self.tp_axis,
            "heads": self.tp_axis,
            "mlp": self.tp_axis,
            # FSDP shards the embed dim over the data axes; otherwise the
            # embed dim stays replicated (pure-TP serving layout)
            "embed": dp if self.fsdp else None,
            # stacked leading dims are never sharded
            "layers": None,
            "stack": None,
            # experts are local to each TP group (no expert-parallel axis yet)
            "experts": None,
            # streaming-graph state: vertex rows block-partitioned over the
            # data axes
            "graph_rows": dp,
        }


def _as_tuple(v: MeshAxes) -> Tuple[str, ...]:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


def _entry(axes: Tuple[str, ...]) -> MeshAxes:
    """Collapse a mesh-axes tuple into a spec entry."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def spec_for_axes(axes: Sequence[Optional[str]], rules: Rules) -> Spec:
    """Logical axes tuple → spec under ``rules``.

    Unknown logical names are replicated; a mesh axis already consumed by an
    earlier dim is dropped (first-dim-wins), never duplicated.
    """
    used: set = set()
    entries = []
    for ax in axes:
        mesh_axes = _as_tuple(rules.get(ax)) if ax is not None else ()
        if mesh_axes and not any(m in used for m in mesh_axes):
            used.update(mesh_axes)
            entries.append(_entry(mesh_axes))
        else:
            entries.append(None)
    return tuple(entries)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{mesh axis → size} of a ``DeviceMesh`` (``mesh_dim_names``, ``shape``)
    or of any object with ``axis_names`` and a ``devices`` array."""
    if hasattr(mesh, "axis_names"):
        return dict(zip(tuple(mesh.axis_names), np.shape(mesh.devices)))
    return dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))


def _prod_size(axes: Tuple[str, ...], sizes: Dict[str, int]) -> int:
    return math.prod(sizes[a] for a in axes)


def _drop_indivisible(spec: Spec, shape: Sequence[int], sizes: Dict[str, int]) -> Spec:
    """Replicate any dim whose size is not divisible by its assigned axes."""
    entries = []
    for dim, entry in zip(shape, spec):
        axes = _as_tuple(entry)
        if axes and dim % _prod_size(axes, sizes) != 0:
            entry = None
        entries.append(entry)
    return tuple(entries)


def auto_spec(shape: Sequence[int], mesh, shcfg: ShardingConfig, batch_dim: int = 0) -> Spec:
    """Divisibility-aware spec for an *input* tensor (batches, tokens).

    The dp axes land on ``batch_dim`` when its size divides the dp group;
    otherwise they move to the first other divisible dim.  The tp axis then
    takes the rightmost remaining divisible dim.  Anything left is
    replicated.
    """
    sizes = mesh_axis_sizes(mesh)
    dp = tuple(a for a in shcfg.dp_axes if a in sizes)
    entries: list = [None] * len(shape)
    if dp:
        dp_size = _prod_size(dp, sizes)
        dp_dim = None
        if shape[batch_dim] % dp_size == 0:
            dp_dim = batch_dim
        else:
            for i, d in enumerate(shape):
                if i != batch_dim and d % dp_size == 0:
                    dp_dim = i
                    break
        if dp_dim is not None:
            entries[dp_dim] = _entry(dp)
    if shcfg.tp_axis in sizes:
        tp_size = sizes[shcfg.tp_axis]
        for i in range(len(shape) - 1, -1, -1):
            if entries[i] is None and shape[i] % tp_size == 0:
                entries[i] = shcfg.tp_axis
                break
    return tuple(entries)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: for each
    mesh dim, ``Shard(d)`` where tensor dim d's entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {a: d for d, entry in enumerate(spec) for a in _as_tuple(entry)}
    unknown = set(owner) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} that the mesh "
                         f"{mesh.mesh_dim_names} does not have")
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the counterpart of ``jax.sharding.NamedSharding`` (a
    leaf of the port's trees, not a node)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _is_axes_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _map_axes(fn, axes_tree, *rest):
    """``fn`` over the axes tuples of a (dict) axes tree and the matching
    leaves of ``rest``."""
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, axes_tree[k], *(r[k] for r in rest)) for k in axes_tree}
    if not _is_axes_leaf(axes_tree):
        raise TypeError(f"not an axes leaf: {axes_tree!r}")
    return fn(axes_tree, *rest)


def tree_shardings(axes_tree, mesh, shcfg: ShardingConfig, shapes_tree=None) -> Any:
    """Map a logical-axes tree (from :func:`repro_torch.nn.param.unzip`) to
    :class:`NamedSharding` s.

    With ``shapes_tree`` (a matching tree of tensors, ``meta`` ones too)
    every spec is also divisibility-checked against the actual dims: the
    reduced test configs rely on this to fall back to replication.
    """
    rules = shcfg.rules()
    sizes = mesh_axis_sizes(mesh)

    def one(axes, shaped=None):
        spec = spec_for_axes(axes, rules)
        if shaped is not None:
            spec = _drop_indivisible(spec, tuple(shaped.shape), sizes)
        return NamedSharding(mesh, spec)

    if shapes_tree is None:
        return _map_axes(one, axes_tree)
    return _map_axes(one, axes_tree, shapes_tree)


def batch_specs(batch_struct: Dict[str, Any], mesh, shcfg: ShardingConfig,
                batch_dim: int = 0) -> Dict[str, Spec]:
    """Per-input specs for a {name: tensor} batch dict."""
    return {k: auto_spec(tuple(v.shape), mesh, shcfg, batch_dim=batch_dim)
            for k, v in batch_struct.items()}


def cache_spec(shape: Sequence[int], mesh, shcfg: ShardingConfig,
               batch: Optional[int] = None) -> Spec:
    """The spec of one decode-cache leaf of ``shape`` (:func:`cache_specs`)."""
    shape = tuple(shape)
    if len(shape) < 3:
        return (None,) * len(shape)
    sizes = mesh_axis_sizes(mesh)
    dp = tuple(a for a in shcfg.dp_axes if a in sizes)
    tp = shcfg.tp_axis if shcfg.tp_axis in sizes else None
    b_dim = 1
    if batch is not None:
        b_dim = next((i for i in range(1, len(shape)) if shape[i] == batch), 1)
    entries: list = [None] * len(shape)
    if dp and shape[b_dim] % _prod_size(dp, sizes) == 0:
        entries[b_dim] = _entry(dp)
    h_dim = b_dim + 1
    if tp and h_dim < len(shape) - 1 and shape[h_dim] % sizes[tp] == 0:
        entries[h_dim] = tp
    return tuple(entries)


def cache_specs(cache_struct, mesh, shcfg: ShardingConfig, batch: Optional[int] = None):
    """Spec tree for a decode-cache tree (a cache NamedTuple of tensors).

    Cache leaves are stacked state buffers with the batch dim somewhere
    after the leading stacked dims: ``[L, B, heads, ...]`` for KV caches,
    ``[G, P-1, B, ...]`` for xLSTM group state.  With ``batch`` given, the
    dp axes land on the first dim (past dim 0) whose size equals it; without
    it, dim 1 is assumed (the KV-cache layout).  The tp axis only ever takes
    the dim immediately after the batch (the heads dim): sharding the
    sequence dim would turn every decode step's write at the index into a
    collective.  Scalars (the ring index, a host int in the port) and short
    leaves replicate.
    """
    return tree_map(lambda leaf: cache_spec(getattr(leaf, "shape", ()), mesh, shcfg, batch),
                    cache_struct)


def opt_state_specs(axes_tree, mesh, shcfg: ShardingConfig, shapes_tree=None):
    """ZeRO-1/3 optimizer-moment shardings (:mod:`repro_torch.train.optimizer`).

    AdamW's ``m``/``v`` are copies of the params' tree, so they take the
    *FSDP* layout even when the params themselves are TP-only
    (``fsdp=False``): that is ZeRO-1 (replicated params, dp-sharded
    optimizer state).  With ``fsdp=True`` params and moments share one
    layout: ZeRO-3.
    """
    zcfg = shcfg if shcfg.fsdp else dataclasses.replace(shcfg, fsdp=True)
    return tree_shardings(axes_tree, mesh, zcfg, shapes_tree=shapes_tree)


def distribute(x, sharding: NamedSharding):
    """``x`` as a DTensor on ``sharding``'s mesh with its placements (every
    rank passes the same full tensor and keeps its shard: no collective).
    On a mesh of one rank the shard is the whole tensor, and one already on
    the mesh's device is wrapped as it is: ``distribute_tensor`` copies each
    leaf it shards, and a model whose weights fill most of the card (qwen3-moe
    at bf16 params, 61 GB on an 80 GB card) has no room for a copy of its
    largest leaf.  The result then shares ``x``'s storage."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = sharding.mesh
    if mesh.size() == 1 and not isinstance(x, DTensor) and x.device == _mesh_device(mesh):
        return DTensor.from_local(x.detach(), mesh, sharding.placements, run_check=False,
                                  shape=x.shape, stride=x.stride()
                                  ).requires_grad_(x.requires_grad)
    return distribute_tensor(x, mesh, sharding.placements, src_data_rank=None)


def _mesh_device(mesh):
    """The device a one-rank mesh's tensors live on (the current one of its type)."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute_tree(tree, shardings):
    """:func:`distribute` over a tree of tensors (dicts, NamedTuples) and the
    matching tree of :class:`NamedSharding` s; non-tensor leaves (a cache's
    host-int index) stay as they are."""
    import torch

    return tree_map(lambda x, s: distribute(x, s) if isinstance(x, torch.Tensor) else x,
                    tree, shardings)

#: halo exchange strategies for the row-sharded streaming backends
_HALO_MODES = ("psum", "ppermute", "auto")


@dataclasses.dataclass(frozen=True)
class CommsConfig:
    """Halo-exchange strategy for the row-sharded streaming backends.

    ``halo`` — how each layer's frontier halo moves between shards:

    * ``"psum"``     — the global broadcast: every shard contributes its
      owned halo rows to one sum over shards, so each shard's bytes scale
      with the *global* frontier.
    * ``"ppermute"`` — plan-time per-consumer partitioning: ``S − 1``
      rotation rounds deliver each halo row only to the shards that gather
      it, so traffic scales with each shard's own halo.  On the hybrid
      host-resident backend this also enables the device-served new-view
      patch (no staged ``h_new`` copy).
    * ``"auto"``     — resolved once at backend construction: ``ppermute``
      when there is more than one shard, else ``psum``.

    ``pair_capacity_hysteresis`` — headroom multiplier on the
    per-(owner, consumer) pair capacities before bucketing (``0.5`` pads
    each pair table 1.5× above its high-water mark).

    The reference's third knob, ``use_pallas_delta``, chose its Pallas
    step-1 scatter over XLA's; the port always runs step 1 in its
    ``delta_agg`` kernel, so it has no such knob.
    """

    halo: str = "auto"
    pair_capacity_hysteresis: float = 0.0

    def __post_init__(self):
        if self.halo not in _HALO_MODES:
            raise ValueError(
                f"CommsConfig.halo must be one of {_HALO_MODES}, got {self.halo!r}")
        if self.pair_capacity_hysteresis < 0:
            raise ValueError(
                "CommsConfig.pair_capacity_hysteresis must be >= 0, "
                f"got {self.pair_capacity_hysteresis!r}")

    def resolve_halo(self, num_shards: int) -> str:
        """Collapse ``"auto"`` for a concrete shard count (once per backend,
        so the mode never flips batch to batch)."""
        if self.halo != "auto":
            return self.halo
        return "ppermute" if num_shards > 1 else "psum"


def rotation_perm(num_shards: int, k: int = 1) -> List[Tuple[int, int]]:
    """(source, destination) pairs of a rotate-by-``k`` exchange round.

    One full exchange over ``S`` shards is ``S − 1`` rounds (``k = 1 …
    S−1``); the pair owner → consumer ``(o, c)`` rides round
    ``(c − o) mod S``."""
    return [(j, (j + k) % num_shards) for j in range(num_shards)]


def stream_shards(num_shards: Optional[int] = None, exchange=None) -> int:
    """Shard count of a row-sharded backend, checked: the counterpart of the
    reference's ``stream_mesh``.

    With an ``exchange`` the count is the exchange's own (``num_shards``, if
    given, must agree); otherwise ``num_shards`` (default 1) logical shards
    run through a loopback exchange in one process."""
    if exchange is not None:
        if num_shards is not None and num_shards != exchange.num_shards:
            raise ValueError(f"num_shards={num_shards} but the exchange runs "
                             f"{exchange.num_shards} shards")
        return exchange.num_shards
    n = 1 if num_shards is None else int(num_shards)
    if n < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return n
