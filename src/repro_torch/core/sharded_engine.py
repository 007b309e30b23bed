"""Row-sharded streaming engine facade.  Mirrors ``repro.core.sharded_engine``.

A thin facade over :class:`~repro_torch.core.backend.StreamOrchestrator` +
:class:`~repro_torch.core.backend.ShardBackend`: the scratch-extended
per-layer state (h, a, nct) is block row-partitioned over ``S`` shards as
stacked ``[S, rows_per + 1, ·]`` tensors (one scratch row per shard), each
update batch is planned on the host (Alg. 4) and **partitioned per shard at
plan time** (:func:`~repro_torch.core.affected.shard_plan`), and the
reordered incremental workflow runs as one L-layer step per batch
(:func:`~repro_torch.core.incremental.sharded_step`):

* **owner-local scatters** — records are partitioned by destination-row
  owner, so every state write is local; only previous-layer *source*
  embeddings cross shards;
* **halo exchange** — governed by
  :class:`~repro_torch.dist.sharding.CommsConfig`: ``"ppermute"`` (the
  multi-shard default under ``"auto"``) moves each halo row from its owner
  to exactly the shards that gather it, in ``S − 1`` rotation rounds over
  plan-time schedules; ``"psum"`` sums every shard's owned halo rows into
  one buffer.  Both are bitwise equal; ``StreamStats.comms_halo_rows_sent``
  / ``comms_halo_bytes`` count the traffic;
* **one device or many processes** — the collectives run through a
  :class:`~repro_torch.dist.exchange.HaloExchange`: all shards in this
  process on one device (the default loopback), or one shard per
  ``torch.distributed`` process;
* **per-shard kernels** — step 1 of every layer launches ``delta_agg`` once
  per shard over the shard's own row schedule, so each row sums its records
  in the single-device engine's order: gcn is bitwise the device engine's.

Build it with ``repro_torch.serve.create_engine("sharded",
EngineConfig(..., num_shards=S))``.
"""
from __future__ import annotations

from repro_torch.core.backend import ShardBackend
from repro_torch.core.engine import RTECEngine


class ShardedRTECEngine(RTECEngine):
    """Facade of the row-sharded substrate.  The control, state and serving
    API is :class:`~repro_torch.core.engine.RTECEngine`'s; the state views
    (``h``, ``a``, ``nct``, ``embeddings``) assemble the blocks into
    ``[n, ·]`` tensors."""

    _backend: ShardBackend

    @property
    def S(self) -> int:
        return self._backend.S

    @property
    def rows_per(self) -> int:
        return self._backend.rows_per

    @property
    def halo_mode(self) -> str:
        return self._backend.halo_mode

    @property
    def halo_rows_total(self) -> int:
        """Live frontier rows of every dispatched plan, summed over layers."""
        return self._backend.halo_rows_total
