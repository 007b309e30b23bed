"""Pipelined streaming incremental-RTEC engine facade (host/device
co-processing).  Mirrors ``repro.core.engine``.

A thin facade over :class:`~repro_torch.core.backend.StreamOrchestrator`
(plan/pack/overlap loop, honest timing, refresh cadence) and
:class:`~repro_torch.core.backend.DeviceBackend` (scratch-extended
``[N+1, ·]`` device tensors updated in place by one fused L-layer step per
batch).  Build it with ``repro_torch.serve.create_engine("device",
EngineConfig(...))``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.backend import (
    BatchStats,
    DeviceBackend,
    StreamOrchestrator,
    StreamStats,
)
from repro_torch.core.operators import GNNModel, Params
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.streaming import UpdateBatch


class RTECEngine:
    """Device-resident engine facade: control goes to the orchestrator,
    state to the backend."""

    def __init__(self, backend: DeviceBackend, orch: StreamOrchestrator):
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
        """Wait for every dispatched batch to finish on the device."""
        self._backend.synchronize()

    # ------------------------------------------------------------------ #
    @property
    def model(self) -> GNNModel:
        return self._backend.model

    @property
    def params(self) -> List[Params]:
        return self._backend.params

    @property
    def device(self) -> torch.device:
        return self._backend.device

    @property
    def graph(self) -> CSRGraph:
        return self._orch.graph

    # ------------------------------------------------------------------ #
    # state views (no scratch rows)
    # ------------------------------------------------------------------ #
    @property
    def h(self) -> List[torch.Tensor]:
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

    def state_bytes(self) -> int:
        return self._backend.state_bytes()
