"""Pipelined streaming incremental-RTEC engine facade (host/device
co-processing).  Mirrors ``repro.core.engine``.

A thin facade over :class:`~repro_torch.core.backend.StreamOrchestrator`
(plan/pack/overlap loop, honest timing, refresh cadence) and
:class:`~repro_torch.core.backend.DeviceBackend` (scratch-extended
``[N+1, ·]`` device tensors updated in place by one fused L-layer step per
batch).  Build it with ``repro_torch.serve.create_engine("device",
EngineConfig(...))``; :meth:`RTECEngine.serving_frontend` attaches the
versioned-read serving layer.

With ``store_h=False`` (paper §V-B) the engine caches only ``a``/``nct`` and
recomputes ``h^l = update(h^{l-1}, a^l)`` when it needs it, for about a third
less state.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.backend import (
    BatchStats,
    StateBackend,
    StreamOrchestrator,
    StreamStats,
)
from repro_torch.core.operators import GNNModel, Params
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.streaming import UpdateBatch


class RTECEngine:
    """Engine facade: control goes to the orchestrator, state to the
    backend.  The host-resident facades (``OffloadedRTECEngine``,
    ``ChunkedRTECEngine``) subclass it; their state views are host numpy."""

    def __init__(self, backend: StateBackend, orch: StreamOrchestrator):
        self._backend = backend
        self._orch = orch

    # ------------------------------------------------------------------ #
    # public API: delegates to orchestrator (control) + backend (state)
    # ------------------------------------------------------------------ #
    def apply_batch(self, batch: UpdateBatch, block: bool = True) -> BatchStats:
        return self._orch.apply_batch(batch, block=block)

    def apply_stream(self, batches) -> StreamStats:
        return self._orch.apply_stream(batches)

    def refresh(self) -> None:
        """Full recomputation (drift reset / MTEC-style refresh)."""
        self._orch.refresh()

    def snapshot_rows(self, rows) -> np.ndarray:
        """Host gather of final-layer embedding rows (consistent after a
        blocking ``apply_batch``)."""
        return self._backend.snapshot_rows(rows)

    def synchronize(self) -> None:
        """Wait for every dispatched batch to finish (on the device and, for
        the offload backend, its deferred host write-back)."""
        self._backend.synchronize()

    def serving_frontend(self, max_pending_reads: int = 64, max_versions: int = 8):
        """A :class:`~repro_torch.serve.frontend.ServingFrontend` over this
        engine: update-batch writes + embedding reads pinned to versions."""
        from repro_torch.serve.frontend import ServingFrontend

        return ServingFrontend(self, max_pending_reads=max_pending_reads,
                               max_versions=max_versions)

    # ------------------------------------------------------------------ #
    @property
    def model(self) -> GNNModel:
        return self._backend.model

    @property
    def params(self) -> List[Params]:
        return self._backend.params

    @property
    def L(self) -> int:
        return self._backend.L

    @property
    def device(self) -> torch.device:
        return self._backend.device

    @property
    def graph(self) -> CSRGraph:
        return self._orch.graph

    @graph.setter
    def graph(self, g: CSRGraph) -> None:
        self._orch.graph = g

    @property
    def refresh_every(self) -> int:
        return self._orch.refresh_every

    @property
    def store_h(self) -> bool:
        return self._backend.store_h

    @property
    def fused(self) -> bool:
        return self._backend.fused

    # ------------------------------------------------------------------ #
    # state views (no scratch rows)
    # ------------------------------------------------------------------ #
    @property
    def x(self) -> torch.Tensor:
        return self._backend.x

    @property
    def h(self) -> List[Optional[torch.Tensor]]:
        return self._backend.h

    @property
    def a(self) -> List[torch.Tensor]:
        return self._backend.a

    @property
    def nct(self) -> List[torch.Tensor]:
        return self._backend.nct

    @property
    def embeddings(self) -> torch.Tensor:
        return self._backend.embeddings

    def _reconstruct_h(self) -> List[torch.Tensor]:
        return self._backend.reconstruct_h()

    def state_bytes(self) -> int:
        return self._backend.state_bytes()

    def staging_stats(self):
        """Host-staging counters: None for the device backend (its state
        lives in device memory; there is no host staging to account)."""
        return None
