"""The port's public engine API: one config, one factory.  Mirrors
``repro.serve.api``.

``create_engine(backend, EngineConfig(...))`` builds a
:class:`~repro_torch.core.backend.StateBackend` substrate under a
:class:`~repro_torch.core.backend.StreamOrchestrator` (with the config's
execution policy and batch-window fusion) behind its facade:

* ``"device"`` — state in device memory, one fused in-place step a batch
  (:class:`~repro_torch.core.backend.DeviceBackend`,
  :class:`~repro_torch.core.engine.RTECEngine`);
* ``"offload"`` — host-resident state, compact per-layer staging through
  pinned buffers, optional device hot-row cache
  (:class:`~repro_torch.core.backend.OffloadBackend`,
  :class:`~repro_torch.serve.offload.OffloadedRTECEngine`; knobs
  ``staging=StagingConfig(...)``, ``cache=CacheConfig(...)``);
* ``"sharded"`` — state row-partitioned over ``num_shards`` shards as
  ``[S, rows_per + 1, ·]`` blocks, the halo exchanged per layer
  (:class:`~repro_torch.core.backend.ShardBackend`,
  :class:`~repro_torch.core.sharded_engine.ShardedRTECEngine`; knobs
  ``num_shards``, ``comms=CommsConfig(...)``, ``exchange``);
* ``"sharded_offload"`` — per-shard host-resident row blocks with compact
  per-shard staging (:class:`~repro_torch.core.backend.ShardedOffloadBackend`,
  :class:`~repro_torch.serve.offload.ShardedOffloadRTECEngine`; knobs
  ``num_shards``, ``comms``, ``staging``, ``cache``);
* ``"chunked"`` — host-resident state, every batch recomputed through the
  §V-C chunked scheduler (:class:`~repro_torch.core.backend.ChunkedBackend`,
  :class:`ChunkedRTECEngine`; knobs ``chunk_size``, ``chunk_reuse``).

Knobs a backend does not consume are ignored by it, so one config can drive
a backend sweep.  :func:`serving_frontend` (or ``engine.serving_frontend()``)
attaches the read/write serving layer with versioned snapshot reads.  The
port has no deprecated alias constructors: build every facade through
:func:`create_engine`.  The sharded backends run their ``S`` shards as
logical shards in this process on the config's device unless
``exchange`` names a :class:`~repro_torch.dist.exchange.DistExchange`
(one shard per ``torch.distributed`` process, ``"sharded"`` only).

The engine runs on ``EngineConfig.device``, ``"cuda"`` unless the caller
asks for the CPU; asking for ``"cuda"`` without a card raises.  The factory
computes in float32 with TF32 off: it sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False (process-wide), because TF32
keeps ~3 decimal digits and the engine is held to the full-recompute oracle
at 2e-4.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.affected import FusionConfig
from repro_torch.core.backend import (
    ChunkedBackend,
    DeviceBackend,
    OffloadBackend,
    ShardBackend,
    ShardedOffloadBackend,
    StreamOrchestrator,
)
from repro_torch.core.engine import RTECEngine
from repro_torch.core.operators import GNNModel, Params
from repro_torch.core.policy import DEFAULT_CHUNKED_WEIGHT, make_policy
from repro_torch.core.sharded_engine import ShardedRTECEngine
from repro_torch.device import resolve_device, set_fp32_precision
from repro_torch.dist.sharding import CommsConfig
from repro_torch.graph.csr import CSRGraph
from repro_torch.serve.hotcache import CacheConfig, HotRowCache
from repro_torch.serve.offload import OffloadedRTECEngine, ShardedOffloadRTECEngine
from repro_torch.serve.staging import StagingConfig

#: every backend name the reference's ``create_engine`` accepts
BACKENDS: Tuple[str, ...] = ("device", "offload", "sharded", "sharded_offload", "chunked")
#: the ones the port implements: all of them
PORTED_BACKENDS: Tuple[str, ...] = BACKENDS


@dataclasses.dataclass
class EngineConfig:
    """Construction knobs of every ported backend.

    Required: ``model``, ``graph``, ``x``, and either ``params`` or
    ``dims`` (+ ``seed``) to initialise them from a ``torch.Generator``.
    Backend-specific knobs are ignored by backends that do not consume them
    (``cache`` by everything but ``"offload"`` and ``"sharded_offload"``,
    ``num_shards`` by the unsharded backends)."""

    model: GNNModel
    graph: CSRGraph
    x: object  # [n, d0] numpy array or tensor
    params: Optional[Sequence[Params]] = None
    #: layer dims for parameter init when ``params`` is None, e.g. [16, 16]
    dims: Optional[Sequence[int]] = None
    seed: int = 0
    refresh_every: int = 0
    #: keep h[1..L]; False is the paper's §V-B recompute-h storage (only
    #: x, a and nct persist; h^l = update(h^{l-1}, a^l) is rebuilt on use)
    store_h: bool = True
    #: one fused in-place step per batch; False runs the per-layer reference
    fused: bool = True
    #: host-resident backend: staging pipeline + device hot-row cache.
    #: ``staging=None`` means ``StagingConfig()`` (async); ``cache=None`` (or
    #: ``CacheConfig(enabled=False)``) runs uncached
    staging: Optional[StagingConfig] = None
    cache: Optional[CacheConfig] = None
    #: chunked backend: destination rows per chunk, inter-chunk reuse
    chunk_size: int = 8192
    chunk_reuse: bool = True
    #: sharded backends: the shard count (default 1; with ``exchange`` the
    #: exchange's own), the halo-exchange strategy (``None`` means
    #: ``CommsConfig()``: ``halo="auto"``), and for ``"sharded"`` the
    #: collectives (``None`` → all shards in this process, a
    #: :class:`~repro_torch.dist.exchange.LoopbackExchange`)
    num_shards: Optional[int] = None
    comms: Optional[CommsConfig] = None
    exchange: Optional[object] = None
    #: where the kernels run (and, for "device", where the state lives; the
    #: host-resident backends keep it in host memory and stage to this device)
    device: str = "cuda"
    #: execution policy: None → every batch takes the incremental path;
    #: "adaptive" → per-batch cost-model choice of incremental / chunked /
    #: full; a mode name forces it on every batch; an ExecutionPolicy
    #: instance passes through as is (shared by every engine built from
    #: this config)
    policy: object = None
    policy_chunked_weight: float = DEFAULT_CHUNKED_WEIGHT
    #: relative hysteresis band for policy mode switches
    policy_hysteresis: float = 0.0
    #: online cost-weight calibration from measured per-batch times
    policy_calibrate: bool = False
    #: batch-window fusion: merge runs of consecutive batches with disjoint
    #: plan footprints into one packed plan and one device step.  None (or
    #: ``FusionConfig(enabled=False)`` / ``window < 2``) keeps the serial loop
    fusion: Optional[FusionConfig] = None

    def resolved_policy(self):
        return make_policy(self.policy, chunked_weight=self.policy_chunked_weight,
                           hysteresis=self.policy_hysteresis,
                           calibrate=self.policy_calibrate)

    def resolved_staging(self) -> StagingConfig:
        return self.staging if self.staging is not None else StagingConfig()

    def resolved_cache(self) -> Optional[HotRowCache]:
        """A fresh :class:`HotRowCache` per engine on the config's device
        (slot state is engine state), or None when caching is off."""
        if self.cache is None or not self.cache.enabled:
            return None
        return HotRowCache(self.cache, device=resolve_device(self.device))

    def resolved_params(self) -> Sequence[Params]:
        dev = resolve_device(self.device)
        if self.params is not None:
            return [{k: torch.as_tensor(v, dtype=torch.float32).to(dev) for k, v in p.items()}
                    for p in self.params]
        if self.dims is None:
            raise ValueError("EngineConfig needs params or dims")
        gen = torch.Generator().manual_seed(self.seed)
        return self.model.init_layers(gen, list(self.dims), device=dev)


class ChunkedRTECEngine(RTECEngine):
    """Facade of the chunked-recompute substrate
    (:class:`~repro_torch.core.backend.ChunkedBackend`): host-resident
    state, every batch executed through the §V-C
    :class:`~repro_torch.serve.scheduler.ChunkedLayerScheduler` so device
    residency is bounded by ``chunk_size``.  Output matches the incremental
    engines to numerical tolerance (recompute vs. incremental
    accumulation)."""

    _backend: ChunkedBackend

    @property
    def chunk_stats(self):
        """Chunk/transfer/reuse counters (:class:`ChunkStats`)."""
        return self._backend.scheduler.stats


def create_engine(backend: str, config: EngineConfig):
    """Construct a streaming engine for ``backend`` from one config.

    Every name in :data:`BACKENDS` is ported; unknown names raise
    ``ValueError``.  Turns TF32 off (see the module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    set_fp32_precision()
    dev = resolve_device(config.device)
    params = config.resolved_params()
    if backend == "device":
        x = torch.as_tensor(config.x, dtype=torch.float32).to(dev)
        sb = DeviceBackend(config.model, params, config.graph, x, store_h=config.store_h,
                           fused=config.fused)
        cls = RTECEngine
    elif backend == "offload":
        staging = config.resolved_staging()
        sb = OffloadBackend(config.model, params, config.graph, _host_array(config.x),
                            device=dev, async_staging=staging.async_enabled,
                            cache=config.resolved_cache())
        cls = OffloadedRTECEngine
    elif backend == "sharded":
        x = torch.as_tensor(config.x, dtype=torch.float32).to(dev)
        sb = ShardBackend(config.model, params, config.graph, x, num_shards=config.num_shards,
                          comms=config.comms, exchange=config.exchange)
        cls = ShardedRTECEngine
    elif backend == "sharded_offload":
        staging = config.resolved_staging()
        sb = ShardedOffloadBackend(config.model, params, config.graph, _host_array(config.x),
                                   device=dev, num_shards=config.num_shards, comms=config.comms,
                                   async_staging=staging.async_enabled,
                                   cache=config.resolved_cache())
        cls = ShardedOffloadRTECEngine
    else:
        sb = ChunkedBackend(config.model, params, config.graph, _host_array(config.x),
                            device=dev, chunk_size=config.chunk_size,
                            chunk_reuse=config.chunk_reuse)
        cls = ChunkedRTECEngine
    orch = StreamOrchestrator(sb, config.graph, refresh_every=config.refresh_every,
                              policy=config.resolved_policy(), fusion=config.fusion)
    return cls(sb, orch)


def _host_array(x) -> np.ndarray:
    """Features as a host float32 array (the host-resident state's h[0])."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, np.float32)


def serving_frontend(engine, max_pending_reads: int = 64, max_versions: int = 8):
    """Attach a :class:`~repro_torch.serve.frontend.ServingFrontend` to an
    engine (anything :func:`create_engine` returns, or a raw orchestrator)."""
    from repro_torch.serve.frontend import ServingFrontend

    return ServingFrontend(engine, max_pending_reads=max_pending_reads,
                           max_versions=max_versions)
