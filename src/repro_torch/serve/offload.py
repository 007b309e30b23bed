"""Out-of-memory embedding management (paper §V-B), in PyTorch.  Mirrors the
single-host part of ``repro.serve.offload``.

:class:`OffloadedRTECEngine` is the facade over
:class:`~repro_torch.core.backend.OffloadBackend` under a
:class:`~repro_torch.core.backend.StreamOrchestrator`.  NeutronRT offloads
intermediate embeddings to CPU memory; the port keeps the per-layer state
(h, a, nct) as **host numpy** and, per update batch, ships only the *compact
row sets the plan touches* to the device through pinned staging buffers,
runs the same ``incremental_layer`` over compact tensors, and groups all
write-backs.  Transfer accounting (:class:`TransferStats`) mirrors the
paper's access-volume metrics.  ``apply_stream`` returns the same
:class:`~repro_torch.core.backend.StreamStats` as the other engines, with
batch-t+1 planning overlapped with the device's execution of batch t's
final layer (deferred write-back).

Host↔device traffic runs through an asynchronous double-buffered
:class:`~repro_torch.serve.staging.HostStagingPipeline`: layer *l+1*'s host
gathers and layer *l-1*'s write-back scatters run on a background worker
while the device computes layer *l*.  ``StagingConfig(async_enabled=False)``
falls back to inline staging with bitwise-identical output; the overlap is
observable via ``StreamStats.staged_bytes`` / ``prefetch_hits`` /
``sync_wait_s`` vs ``compute_s``.  Build the engine with
``repro_torch.serve.create_engine("offload", EngineConfig(...))``.

:class:`ShardedOffloadRTECEngine` is the same engine over ``S`` row shards
(:class:`~repro_torch.core.backend.ShardedOffloadBackend`): each shard's
state is a host row block, each layer stages every shard's compact
``[halo | local]`` workspace, the halo rows gathered from the owners' host
blocks.  Build it with ``create_engine("sharded_offload",
EngineConfig(..., num_shards=S))``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.backend import (  # noqa: F401  (TransferStats re-export)
    OffloadBackend,
    ShardedOffloadBackend,
    TransferStats,
)
from repro_torch.core.engine import RTECEngine


class OffloadedRTECEngine(RTECEngine):
    """Incremental RTEC with host-resident state (the CPU-offload engine).
    The control and serving API is :class:`~repro_torch.core.engine.RTECEngine`'s;
    ``synchronize`` and the state views complete the deferred final-layer
    write-back first."""

    _backend: OffloadBackend

    @property
    def transfers(self) -> TransferStats:
        return self._backend.transfers

    @property
    def staging(self):
        """The backend's :class:`~repro_torch.serve.staging.HostStagingPipeline`."""
        return self._backend._staging

    @property
    def async_staging(self) -> bool:
        return self._backend.async_staging

    def staging_stats(self):
        """Snapshot of the host-staging counters (StagingStats)."""
        return self._backend.staging_snapshot()

    # state views flush the deferred final-layer write-back first, so they
    # can never disagree with `embeddings` mid-pipeline (block=False)
    @property
    def h(self) -> List[np.ndarray]:
        self._backend.flush()
        return self._backend.h

    @property
    def a(self) -> List[np.ndarray]:
        self._backend.flush()
        return self._backend.a

    @property
    def nct(self) -> List[np.ndarray]:
        self._backend.flush()
        return self._backend.nct


class ShardedOffloadRTECEngine(OffloadedRTECEngine):
    """Incremental RTEC with per-shard host-resident row blocks and compact
    per-layer device staging (the sharded offload hybrid).  The state views
    assemble the blocks into host ``[n, ·]`` arrays after the deferred
    write-back."""

    _backend: ShardedOffloadBackend

    @property
    def S(self) -> int:
        return self._backend.S

    @property
    def rows_per(self) -> int:
        return self._backend.rows_per

    @property
    def per_shard_rows(self) -> np.ndarray:
        """Per-shard H2D+D2H row volume (a function of the plans)."""
        return self._backend.per_shard_rows

    @property
    def peak_device_bytes(self) -> int:
        """Largest one-layer device footprint seen (the state stays on the
        host)."""
        return self._backend.peak_device_bytes

    @property
    def h(self) -> List[np.ndarray]:
        self._backend.flush()
        return [self._backend._from_blocks(v) for v in self._backend.h]

    @property
    def a(self) -> List[np.ndarray]:
        self._backend.flush()
        return [self._backend._from_blocks(v) for v in self._backend.a]

    @property
    def nct(self) -> List[np.ndarray]:
        self._backend.flush()
        return [self._backend._from_blocks(v) for v in self._backend.nct]
