"""``repro_torch.dist``: sharding rules, activation constraints, pipeline
parallelism, and the collectives of the sharded streaming engine; the
counterpart of ``repro.dist``.

- :mod:`repro_torch.dist.sharding`: logical-axis rules.  Params carry
  logical axis names (:mod:`repro_torch.nn.param`); ``ShardingConfig.rules()``
  maps them to mesh axes, ``tree_shardings`` turns a param tree into
  ``NamedSharding`` s (a spec on a ``DeviceMesh``, whose ``placements`` are
  DTensor placements), and ``auto_spec``/``batch_specs``/``cache_specs``
  cover inputs and decode caches.  Its GNN half holds the halo-exchange
  knobs of the row-sharded streaming backends.
- :mod:`repro_torch.dist.ctx`: activation constraints.  Inside
  ``activation_sharding(mesh, shcfg)`` the model runs on DTensors and every
  ``ashard(x, "dp", "tp")`` redistributes its activation; outside,
  ``ashard`` returns its input, so single-device runs are untouched.
- :mod:`repro_torch.dist.pipeline`: ``pipeline_apply``, GPipe over a mesh
  "stage" dim, with ``sequential_reference`` as the single-device oracle.
- :mod:`repro_torch.dist.exchange`: the collectives between the shards of
  the row-sharded streaming backends.

The reference's ``stream_mesh`` and ``stream_state_specs`` place the
streaming engine's blocks on a 1-D JAX mesh; the port's counterpart is
``stream_shards`` with a ``HaloExchange``.
"""
from repro_torch.dist.ctx import activation_sharding, ashard
from repro_torch.dist.exchange import DistExchange, HaloExchange, LoopbackExchange
from repro_torch.dist.pipeline import pipeline_apply, sequential_reference
from repro_torch.dist.sharding import (
    CommsConfig,
    NamedSharding,
    ShardingConfig,
    auto_spec,
    batch_specs,
    cache_specs,
    distribute_tree,
    opt_state_specs,
    rotation_perm,
    spec_for_axes,
    stream_shards,
    tree_shardings,
)

__all__ = [
    "CommsConfig",
    "DistExchange",
    "HaloExchange",
    "LoopbackExchange",
    "NamedSharding",
    "ShardingConfig",
    "activation_sharding",
    "ashard",
    "auto_spec",
    "batch_specs",
    "cache_specs",
    "distribute_tree",
    "opt_state_specs",
    "pipeline_apply",
    "rotation_perm",
    "sequential_reference",
    "spec_for_axes",
    "stream_shards",
    "tree_shardings",
]
