"""Residency-backend architecture of the port: one orchestrator, five state
substrates.  Mirrors ``repro.core.backend``.

    UpdateBatch stream → StreamOrchestrator  (plan t+1 on the host while the
                              │               device executes t; honest timing;
                              │               refresh cadence; execution
                              │               policy; batch-window fusion)
                              │  StateBackend protocol (plan / dispatch /
                              │  flush / synchronize + serving and policy
                              │  primitives)
        ┌──────────────┬──────┴───────┬─────────────────┬──────────────────┐
   DeviceBackend  OffloadBackend  ChunkedBackend   ShardBackend   ShardedOffloadBackend
   ([N+1, ·]      (host numpy,    (host numpy,     ([S, rows_per  (per-shard host
    tensors, one   compact staged  §V-C chunked     + 1, ·] row    row blocks,
    fused step)    layers)         recompute)       blocks, halo   compact per-shard
                                                    exchange)      staging)

Protocol contract (what ``StreamOrchestrator`` relies on):

* ``plan(g_old, g_new, batch)`` is host-only and **value-independent** (it
  may read graph structure and batch indices, never state values), so it can
  run while the device still executes the previous batch;
* ``dispatch(prep)`` is as asynchronous as the substrate allows;
* ``flush()`` + ``synchronize()`` is a full barrier: after it,
  ``embeddings`` reflects every dispatched batch.

On top of the per-batch loop the orchestrator carries the reference's
serving layer:

* an :class:`~repro_torch.core.policy.ExecutionPolicy` picks, per batch and
  from the plan alone, between the incremental step (``delta_agg``), a
  chunked recompute of the affected rows (§V-C,
  :class:`~repro_torch.serve.scheduler.ChunkedLayerScheduler`, sums through
  ``segment_spmm``) and a full recompute (``refresh`` → ``full_forward``);
  chunked and full run on any substrate through three primitives
  (``apply_feature_updates`` / ``layer_input_host`` / ``scatter_layer_rows``);
* batch-window fusion (:class:`~repro_torch.core.affected.FusionWindow`)
  merges runs of independent batches into one plan and one device step,
  bitwise-equal to the serial loop on the CPU and on a card (the models'
  products run in ``row_linear``, whose rows do not depend on how many rows
  a window puts into them);
* the serving API (``snapshot_rows`` / ``changed_rows``) on which
  :class:`repro_torch.serve.frontend.ServingFrontend` answers reads pinned
  to past versions.

``StreamStats`` keeps the reference's full ``as_dict()`` key namespace; the
host-resident substrates fill its staging and cache counters, the sharded
ones its halo counters.
"""
from __future__ import annotations

import abc
import dataclasses
import threading
import time
from functools import partial
from typing import TYPE_CHECKING, Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.affected import (
    BatchPlan,
    BucketHysteresis,
    FusionConfig,
    FusionWindow,
    HybridLayerPlan,
    PackedLayout,
    PackedPlan,
    ShardedPlan,
    build_packed_plan,
    build_plan,
    final_write_rows,
    hybrid_plan,
    pack_plan,
    remap_compact,
    shard_plan,
    shard_rows,
)
from repro_torch.core.full import full_forward
from repro_torch.core.incremental import (
    fused_stream_step,
    hybrid_layer_step,
    incremental_layer,
    incremental_layer_inplace,
    packed_fields,
    sharded_step,
    with_scratch,
)
from repro_torch.core.operators import GNNModel, Params
from repro_torch.core.policy import ExecutionPolicy, PlanCostEstimate
from repro_torch.device import Spec, byte_layout, carve, host_to_device
from repro_torch.dist.exchange import LoopbackExchange
from repro_torch.dist.sharding import CommsConfig, stream_shards
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.streaming import UpdateBatch
from repro_torch.kernels.segment_spmm import prepare_row_schedule
from repro_torch.serve.staging import HostStagingPipeline, StagingStats, StagingTicket

if TYPE_CHECKING:  # the backend takes a cache, never builds one
    from repro_torch.serve.hotcache import CacheStats, HotRowCache


# ====================================================================== #
# Stats (shared by every engine facade)
# ====================================================================== #
@dataclasses.dataclass
class BatchStats:
    inc_edges: int
    full_edges: int
    out_vertices: int
    plan_time_s: float
    exec_time_s: float
    graph_time_s: float
    #: execution shape the batch ran as: "incremental" (the backend's
    #: native dispatch), "chunked" (orchestrator-level §V-C subset
    #: recompute) or "full" (refresh over the post-batch graph).  Always
    #: "incremental" without an ExecutionPolicy.
    mode: str = "incremental"
    #: the policy cost model's raw edge-work for the chosen mode (0 without
    #: a policy)
    est_edges: int = 0
    #: the chosen mode's weighted cost (``PolicyDecision.costs[mode]``;
    #: 0.0 without a policy)
    est_cost: float = 0.0
    #: how many logical batches shared this batch's device dispatch: 1 =
    #: dispatched alone; k ≥ 2 on every constituent of a fused window (the
    #: window's one dispatch time is charged to its first constituent, the
    #: others report ``exec_time_s == 0``)
    fused_window: int = 1

    @property
    def edges_processed(self) -> int:
        return self.inc_edges + self.full_edges


@dataclasses.dataclass
class StreamStats:
    """Aggregate result of a pipelined ``apply_stream`` run.

    ``wall_s`` is honest end-to-end time including the final device
    synchronisation; per-batch ``exec_time_s`` entries are dispatch-only
    (execution overlaps the next batch's planning, so per-batch completion
    is unobservable without breaking the pipeline).  ``prefetch_hits``
    counts the batches whose plan completed with no intervening backend
    barrier — ``len(batches) - 1`` for a healthy pipeline.  The read-side
    fields are filled by :class:`repro_torch.serve.frontend.ServingFrontend`,
    the fusion fields by fused streams, the staging and cache fields by the
    host-resident substrates, the halo fields by the sharded substrates
    (plan-derived: :class:`CommsStats`)."""

    batches: List[BatchStats]
    wall_s: float
    plan_s: float  # total host planning time (hidden behind device exec)
    staged_bytes: int = 0
    prefetch_hits: int = 0
    sync_wait_s: float = 0.0
    compute_s: float = 0.0
    reads_served: int = 0
    reads_rejected: int = 0
    read_p50_s: float = 0.0
    read_p99_s: float = 0.0
    staleness_batches: int = 0
    cache_hit_rows: int = 0
    cache_miss_rows: int = 0
    cache_evictions: int = 0
    fusion_windows: int = 0
    fused_batches: int = 0
    fusion_fallbacks: int = 0
    comms_halo_rows_sent: int = 0
    comms_halo_bytes: int = 0

    @property
    def mean_batch_s(self) -> float:
        return self.wall_s / max(1, len(self.batches))

    def as_dict(self) -> dict:
        """Normalized scalar view, with the reference's documented keys:

        ==========================  =========================================
        key                         meaning (D = deterministic)
        ==========================  =========================================
        n_batches                   batches in the stream (D)
        wall_s                      honest end-to-end wall, incl. final sync
        plan_s                      host planning time (hidden behind exec)
        mean_batch_s                wall_s / n_batches
        inc_edges                   signed incremental records executed (D)
        full_edges                  constrained full-recompute edges (D)
        out_vertices                rows written, summed over layers (D)
        staged_bytes                bytes through host staging (D)
        prefetch_hits               plans built with no backend barrier (D)
        sync_wait_s                 caller time blocked on host staging
        compute_s                   caller time blocked on the device
        reads_served                frontend reads answered (D)
        reads_rejected              frontend reads shed by admission (D)
        read_p50_s / read_p99_s     read latency percentiles (telemetry)
        staleness_batches           versions behind head at serve time (D)
        cache_hit_rows              rows served from device cache slots (D)
        cache_miss_rows             rows staged from host (D)
        cache_evictions             cache capacity evictions (D)
        fusion_windows              fused multi-batch dispatches (D)
        fused_batches               batches absorbed into fused windows (D)
        fusion_fallbacks            windows broken up by overlap/policy (D)
        comms_halo_rows_sent        halo rows moved between shards (D)
        comms_halo_bytes            halo bytes moved between shards (D)
        policy_incremental_batches  batches decided incremental (D)
        policy_chunked_batches      batches decided chunked-subset (D)
        policy_full_batches         batches decided full recompute (D)
        policy_edges                cost model's raw edge-work estimate (D)
        policy_cost                 chosen-mode weighted cost total (D)
        ==========================  =========================================
        """
        return {
            "n_batches": len(self.batches),
            "wall_s": self.wall_s,
            "plan_s": self.plan_s,
            "mean_batch_s": self.mean_batch_s,
            "inc_edges": sum(b.inc_edges for b in self.batches),
            "full_edges": sum(b.full_edges for b in self.batches),
            "out_vertices": sum(b.out_vertices for b in self.batches),
            "staged_bytes": self.staged_bytes,
            "prefetch_hits": self.prefetch_hits,
            "sync_wait_s": self.sync_wait_s,
            "compute_s": self.compute_s,
            "reads_served": self.reads_served,
            "reads_rejected": self.reads_rejected,
            "read_p50_s": self.read_p50_s,
            "read_p99_s": self.read_p99_s,
            "staleness_batches": self.staleness_batches,
            "cache_hit_rows": self.cache_hit_rows,
            "cache_miss_rows": self.cache_miss_rows,
            "cache_evictions": self.cache_evictions,
            "fusion_windows": self.fusion_windows,
            "fused_batches": self.fused_batches,
            "fusion_fallbacks": self.fusion_fallbacks,
            "comms_halo_rows_sent": self.comms_halo_rows_sent,
            "comms_halo_bytes": self.comms_halo_bytes,
            "policy_incremental_batches": self._mode_count("incremental"),
            "policy_chunked_batches": self._mode_count("chunked"),
            "policy_full_batches": self._mode_count("full"),
            "policy_edges": sum(b.est_edges for b in self.batches),
            "policy_cost": sum(b.est_cost for b in self.batches),
        }

    def _mode_count(self, mode: str) -> int:
        return sum(1 for b in self.batches if b.mode == mode)


#: the complete documented ``StreamStats.as_dict`` key namespace
STREAM_STAT_KEYS: Tuple[str, ...] = tuple(StreamStats([], 0.0, 0.0).as_dict().keys())


@dataclasses.dataclass(frozen=True)
class CommsStats:
    """Cumulative halo-exchange volume of a sharded backend.

    Plan-derived — computed from the value-independent per-consumer
    delivery sets, never measured off the device — so the counters are
    bit-stable.  ``halo_rows_sent`` counts (row, consumer) deliveries: under
    ``halo="ppermute"`` each halo row once per shard that gathers it; under
    ``"psum"`` once per shard (the broadcast ceiling).  ``halo_bytes``
    weights each delivery by its payload (the old and new views)."""

    halo_rows_sent: int = 0
    halo_bytes: int = 0


# ====================================================================== #
# StateBackend protocol
# ====================================================================== #
class StateBackend(abc.ABC):
    """Execution substrate under a :class:`StreamOrchestrator`.

    A backend owns the residency of the per-layer historical state
    (h, a, nct) and knows how to (1) turn a batch into a substrate-specific
    prepared plan (host-only, value-independent), (2) dispatch that plan,
    and (3) surface the state back.  The returned prep object exposes
    ``n_inc_edges``/``n_full_edges``/``n_out_rows`` for :class:`BatchStats`."""

    model: GNNModel
    params: List[Params]
    L: int
    device: torch.device

    #: bumped by every ``flush()``: the orchestrator uses it to verify a
    #: batch's plan really was built with no intervening backend barrier
    barrier_epoch: int = 0

    @property
    def overlap_capable(self) -> bool:
        """Whether ``apply_stream``'s plan/execute overlap is supported."""
        return True

    @abc.abstractmethod
    def plan(self, g_old: CSRGraph, g_new: CSRGraph, batch: UpdateBatch,
             base_plan: Optional[BatchPlan] = None) -> Any:
        """Host-only, value-independent planning (may overlap execution).
        ``base_plan`` skips the Alg.-4 build when the caller already ran it
        (the policy path, fused windows)."""

    @abc.abstractmethod
    def dispatch(self, prep: Any) -> None:
        """Execute a prepared plan (as asynchronously as the substrate allows)."""

    def flush(self) -> None:
        """Complete any work ``dispatch`` deferred (a barrier: bump the
        epoch even when there is nothing to complete)."""
        self.barrier_epoch += 1

    def staging_snapshot(self) -> Optional[StagingStats]:
        """Snapshot of the backend's host-staging counters (None when the
        substrate has no :class:`HostStagingPipeline`)."""
        return None

    def cache_snapshot(self) -> Optional[CacheStats]:
        """Snapshot of the backend's device hot-row-cache counters (None
        when no :class:`HotRowCache` is attached)."""
        return None

    def comms_snapshot(self) -> Optional[CommsStats]:
        """Snapshot of the backend's halo-exchange counters (None for
        unsharded substrates: no traffic between shards exists)."""
        return None

    @abc.abstractmethod
    def synchronize(self) -> None:
        """Wait until the device has finished every dispatched batch."""

    # ------------------------------------------------------------------ #
    # Serving API: versioned snapshot reads.
    #
    # * a **version** is one flushed batch — after ``flush()`` +
    #   ``synchronize()`` the substrate's state *is* the post-batch state;
    # * ``snapshot_rows(rows)`` is a consistent host copy of final-layer
    #   embedding rows at such a boundary (a finished copy, never a view);
    # * ``changed_rows(prep)`` names, *before dispatch*, every final-layer
    #   row the prepared plan may write.  Snapshotting exactly these rows
    #   before dispatch yields a per-version undo record, which is how the
    #   front-end answers a read pinned to version v bitwise-equal to the
    #   post-batch-v state after later batches have run.
    # ------------------------------------------------------------------ #
    def snapshot_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host copy of final-layer embedding rows (consistent at a version
        boundary): an O(len(rows)) device gather and a synchronous copy,
        finished when this returns."""
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
        return self.embeddings[idx].cpu().numpy()

    def changed_rows(self, prep: Any) -> np.ndarray:
        """Global ids of final-layer rows ``dispatch(prep)`` may write
        (value-independent: derived from the plan, usable pre-dispatch)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose plan write sets; "
            "versioned serving reads are unsupported on this substrate")

    # ------------------------------------------------------------------ #
    # Policy-execution primitives: the orchestrator-level ExecutionPolicy
    # runs chunked-subset and full-recompute batches on any substrate
    # through these.  The caller flushes first.
    # ------------------------------------------------------------------ #
    @property
    def host_params(self) -> List[Params]:
        """Per-layer params as the chunked scheduler takes them."""
        return self.params

    def chunk_scheduler(self):
        """The substrate's own §V-C scheduler, if it has one.  None → the
        orchestrator creates a generic one on the backend's device."""
        return None

    def apply_feature_updates(self, rows: np.ndarray, vals: np.ndarray) -> None:
        """Persist a batch's layer-0 feature updates into the state."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the policy execution primitives")

    def layer_input_host(self, l: int) -> np.ndarray:
        """Layer ``l``'s input embeddings (h^l) as a host ``[n, d]`` array
        (no scratch row, a copy) — what the chunked scheduler recomputes from."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the policy execution primitives")

    def scatter_layer_rows(self, l: int, rows: np.ndarray, a_rows: np.ndarray,
                           nct_rows: np.ndarray, h_rows: np.ndarray) -> None:
        """Write one layer's recomputed (a, nct, h^{l+1}) rows back into the
        substrate's state at global ``rows``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the policy execution primitives")

    @abc.abstractmethod
    def refresh(self, graph: CSRGraph) -> None:
        """Full recomputation over ``graph`` and the *current* features."""

    @property
    @abc.abstractmethod
    def embeddings(self) -> torch.Tensor:
        """Final-layer embeddings for all n vertices."""

    @abc.abstractmethod
    def state_bytes(self) -> int:
        """Bytes of persistent cached state."""


# ====================================================================== #
# Policy execution payloads: when an ExecutionPolicy routes a batch away
# from the substrate's native incremental dispatch, the orchestrator
# carries one of these instead of a backend prep.  They expose the same
# n_inc_edges / n_full_edges / n_out_rows counters BatchStats reads.
# ====================================================================== #
@dataclasses.dataclass
class _PolicyChunkedPrep:
    """Chunked-subset recompute payload: the orchestrator drives the §V-C
    scheduler over the plan's live out rows through the backend's
    policy-execution primitives."""

    plan: BatchPlan
    batch: UpdateBatch
    g_new: CSRGraph
    rows_per_layer: List[np.ndarray]  # live out_rows per layer (global ids)
    est: PlanCostEstimate

    @property
    def n_inc_edges(self) -> int:
        return 0  # no signed delta records execute in this mode

    @property
    def n_full_edges(self) -> int:
        return self.est.chunked_edges

    @property
    def n_out_rows(self) -> int:
        return int(sum(r.shape[0] for r in self.rows_per_layer))


@dataclasses.dataclass
class _PolicyFullPrep:
    """Full-recompute payload: the batch runs as ``backend.refresh`` over the
    post-batch graph (after the feature scatter), the refresh-cadence path."""

    batch: UpdateBatch
    g_new: CSRGraph
    est: PlanCostEstimate

    @property
    def n_inc_edges(self) -> int:
        return 0

    @property
    def n_full_edges(self) -> int:
        return self.est.full_edges

    @property
    def n_out_rows(self) -> int:
        return self.est.n * self.est.L


@dataclasses.dataclass
class _PendingPlan:
    """One planned-but-not-dispatched batch in the fusion lookahead window.
    Everything here is host-only and value-independent, so the window may
    run arbitrarily far ahead of device execution."""

    batch: UpdateBatch
    g_old: CSRGraph
    g_new: CSRGraph
    plan: BatchPlan
    fp: np.ndarray  # sorted unique row footprint (FusionWindow.footprint)


def _override_rows(dst_vals: np.ndarray, dst_rows: np.ndarray,
                   src_rows: np.ndarray, src_vals: np.ndarray) -> None:
    """dst_vals[i] ← src_vals[j] where dst_rows[i] == src_rows[j] (vectorized)."""
    if not src_rows.size or not dst_rows.size:
        return
    order = np.argsort(src_rows)
    pos = np.searchsorted(src_rows[order], dst_rows)
    pos = np.clip(pos, 0, src_rows.size - 1)
    hit = src_rows[order][pos] == dst_rows
    dst_vals[hit] = src_vals[order][pos[hit]]


# ====================================================================== #
# StreamOrchestrator — the single plan/pack/overlap loop
# ====================================================================== #
class StreamOrchestrator:
    """Drives one :class:`StateBackend` over an update stream.

    Owns the evolving graph snapshot, the refresh cadence, the execution
    policy, batch-window fusion, and the paper's §V co-processing schedule:
    ``apply_stream`` dispatches batch t and then runs host planning of batch
    t+1 while the device executes, syncing only at the end of the stream
    (and around refreshes and policy-chosen chunked/full batches).
    ``apply_batch`` keeps the per-batch API with honest timing
    (``block=True`` synchronises at the timed boundary so ``exec_time_s``
    measures completion, not dispatch)."""

    def __init__(self, backend: StateBackend, graph: CSRGraph, refresh_every: int = 0,
                 policy: Optional[ExecutionPolicy] = None,
                 fusion: Optional[FusionConfig] = None):
        self.backend = backend
        self.graph = graph
        self.refresh_every = refresh_every
        self.policy = policy
        # fusion is inert unless a FusionConfig with window >= 2 is attached
        if fusion is not None and (not fusion.enabled or fusion.window < 2):
            fusion = None
        self.fusion = fusion
        # cumulative fusion counters (StreamStats reports per-stream deltas)
        self.fusion_windows = 0
        self.fused_batches = 0
        self.fusion_fallbacks = 0
        self._batches_seen = 0
        self._chunk_sched = None  # lazy generic §V-C scheduler (policy path)

    def refresh(self) -> None:
        """Full recomputation (drift reset / MTEC-style refresh)."""
        self.backend.refresh(self.graph)

    def _apply_graph(self, batch: UpdateBatch) -> CSRGraph:
        return self.graph.apply_updates(
            batch.ins_src, batch.ins_dst, batch.del_src, batch.del_dst,
            batch.ins_weights, batch.ins_etypes,
        )

    def _snapshots(self):
        return (self.backend.staging_snapshot(), self.backend.cache_snapshot(),
                self.backend.comms_snapshot())

    def _account(self, ss: StreamStats, snaps) -> StreamStats:
        """Fill a stream's staging, cache and halo fields: the counters'
        growth since ``snaps`` (taken by :meth:`_snapshots` at the stream's
        start)."""
        staging0, cache0, comms0 = snaps
        if staging0 is not None:
            s1 = self.backend.staging_snapshot()
            ss.staged_bytes = s1.staged_bytes - staging0.staged_bytes
            ss.sync_wait_s = ((s1.wait_gather_s + s1.drain_wait_s)
                              - (staging0.wait_gather_s + staging0.drain_wait_s))
            ss.compute_s = s1.wait_device_s - staging0.wait_device_s
        if cache0 is not None:
            c1 = self.backend.cache_snapshot()
            ss.cache_hit_rows = c1.hit_rows - cache0.hit_rows
            ss.cache_miss_rows = c1.miss_rows - cache0.miss_rows
            ss.cache_evictions = c1.evictions - cache0.evictions
        if comms0 is not None:
            m1 = self.backend.comms_snapshot()
            ss.comms_halo_rows_sent = m1.halo_rows_sent - comms0.halo_rows_sent
            ss.comms_halo_bytes = m1.halo_bytes - comms0.halo_bytes
        return ss

    def _after_batch(self, sync_before_refresh: bool = False) -> None:
        self._batches_seen += 1
        if self.refresh_every and self._batches_seen % self.refresh_every == 0:
            self.backend.flush()
            if sync_before_refresh:
                self.backend.synchronize()
            self.refresh()

    # ------------------------------------------------------------------ #
    # policy routing: per batch, score the three execution shapes on the
    # Alg.-4 plan and dispatch the winner.  Without a policy every batch
    # takes the incremental path.
    # ------------------------------------------------------------------ #
    def _prepare(self, g_new: CSRGraph, batch: UpdateBatch,
                 base: Optional[BatchPlan] = None):
        """Plan one batch → ``(mode, payload, decision)``.

        Host-only and value-independent (the decision reads plan counters
        and degree tables, never state values, and nothing here reads a
        device tensor), so ``apply_stream`` runs it behind the previous
        batch's device step.  ``base`` reuses a plan the caller already
        built (the fusion lookahead's serial fallback): ``build_plan`` is
        deterministic, so reusing it is bitwise-identical to rebuilding."""
        if self.policy is None:
            return "incremental", self.backend.plan(self.graph, g_new, batch,
                                                    base_plan=base), None
        if base is None:
            base = build_plan(self.backend.model, self.graph, g_new, batch, self.backend.L)
        decision = self.policy.decide(base)
        if decision.mode == "incremental":
            prep = self.backend.plan(self.graph, g_new, batch, base_plan=base)
            return "incremental", prep, decision
        if decision.mode == "chunked":
            rows = [np.unique(lp.out_rows[lp.out_mask].astype(np.int64))
                    for lp in base.layers]
            return "chunked", _PolicyChunkedPrep(
                plan=base, batch=batch, g_new=g_new, rows_per_layer=rows,
                est=decision.estimate), decision
        return "full", _PolicyFullPrep(batch=batch, g_new=g_new,
                                       est=decision.estimate), decision

    def _dispatch_mode(self, mode: str, prep: Any) -> None:
        if mode == "incremental":
            self.backend.dispatch(prep)
        elif mode == "chunked":
            self._execute_chunked(prep)
        else:
            self._execute_full(prep)

    def _chunk_scheduler(self):
        sched = self.backend.chunk_scheduler()
        if sched is not None:
            return sched
        if self._chunk_sched is None:
            # deferred import: repro_torch.serve pulls this module in
            from repro_torch.serve.scheduler import ChunkedLayerScheduler

            self._chunk_sched = ChunkedLayerScheduler(self.backend.model,
                                                      device=self.backend.device)
        return self._chunk_sched

    def _apply_features(self, batch: UpdateBatch) -> None:
        if batch.feat_vertices is not None and batch.feat_vertices.size:
            self.backend.apply_feature_updates(
                np.asarray(batch.feat_vertices, np.int64),
                np.asarray(batch.feat_values, np.float32))

    def _execute_chunked(self, prep: _PolicyChunkedPrep) -> None:
        """Chunked-subset recompute: per layer, recompute the plan's live out
        rows from the post-batch graph through the §V-C scheduler and
        scatter them back.  Layer ``l`` reads ``h[l]`` after the previous
        layer's scatter (and the feature scatter for layer 0), so the
        recompute sees exactly the incremental path's layer inputs."""
        self.backend.flush()
        self._apply_features(prep.batch)
        sched = self._chunk_scheduler()
        params = self.backend.host_params
        deg = prep.plan.deg_new[:-1]  # [n] new-graph degrees (drop scratch)
        for l in range(self.backend.L):
            rows = prep.rows_per_layer[l]
            if not rows.size:
                continue
            h_prev = self.backend.layer_input_host(l)
            a_r, nct_r, h_r = sched.run_layer(params[l], prep.g_new, h_prev, rows, deg)
            self.backend.scatter_layer_rows(l, rows, a_r, nct_r, h_r)

    def _execute_full(self, prep: _PolicyFullPrep) -> None:
        """Full recompute over the post-batch graph — the refresh-cadence
        path, with the batch's feature updates applied first so ``refresh``
        (which recomputes from the *current* h[0]) sees them."""
        self.backend.flush()
        self._apply_features(prep.batch)
        self.backend.refresh(prep.g_new)

    def write_set(self, prep: Any) -> np.ndarray:
        """Serving write set of one prepared batch payload, whatever mode the
        policy chose (full-recompute payloads never reach it: the frontend
        resets instead).  Inside a fused window the hook receives each
        constituent's raw :class:`BatchPlan`."""
        if isinstance(prep, BatchPlan):
            return final_write_rows(prep)
        if isinstance(prep, _PolicyChunkedPrep):
            return prep.rows_per_layer[-1]
        return self.backend.changed_rows(prep)

    @staticmethod
    def _stats(prep, mode: str, decision, plan_s: float, exec_s: float,
               graph_s: float) -> BatchStats:
        return BatchStats(
            inc_edges=prep.n_inc_edges,
            full_edges=prep.n_full_edges,
            out_vertices=prep.n_out_rows,
            plan_time_s=plan_s,
            exec_time_s=exec_s,
            graph_time_s=graph_s,
            mode=mode,
            est_edges=decision.est_edges if decision is not None else 0,
            est_cost=decision.costs[mode] if decision is not None else 0.0,
        )

    # ------------------------------------------------------------------ #
    # per-batch API (honest timing: block=True syncs at the boundary)
    # ------------------------------------------------------------------ #
    def apply_batch(self, batch: UpdateBatch, block: bool = True, on_plan=None) -> BatchStats:
        t0 = time.perf_counter()
        g_new = self._apply_graph(batch)
        t1 = time.perf_counter()
        mode, prep, decision = self._prepare(g_new, batch)
        t2 = time.perf_counter()
        if on_plan is not None and mode != "full":
            # serving hook: runs between plan and dispatch, while the
            # substrate still holds the pre-batch state.  Full-recompute
            # batches skip it (their pre-images would be a whole-state
            # copy); the front-end resets its history instead.
            on_plan(prep)
        self._dispatch_mode(mode, prep)
        if block:
            self.backend.flush()
            self.backend.synchronize()
        t3 = time.perf_counter()
        self.graph = g_new
        if decision is not None:
            # online cost-weight calibration (a no-op unless calibrate=True)
            self.policy.observe(decision, t3 - t2)
        self._after_batch()
        return self._stats(prep, mode, decision, t2 - t1, t3 - t2, t1 - t0)

    # ------------------------------------------------------------------ #
    # pipelined stream API: plan t+1 on host while the device runs t
    # ------------------------------------------------------------------ #
    def apply_stream(self, batches: Sequence[UpdateBatch]) -> StreamStats:
        """Double-buffered batch application (paper §V co-processing).

        Batch t is dispatched; Alg.-4 planning of batch t+1 (host numpy)
        then runs while the device executes.  The only full barrier is the
        end of the stream (and around refreshes)."""
        if not self.backend.overlap_capable:
            raise RuntimeError("apply_stream requires the fused engine (fused=True)")
        batches = list(batches)
        if not batches:
            return StreamStats([], 0.0, 0.0)
        if self._fusion_active():
            return self._apply_stream_fused(batches)
        t_start = time.perf_counter()
        stats: List[BatchStats] = []
        plan_total = 0.0
        prefetch_hits = 0  # batches whose plan was built behind execution
        snaps = self._snapshots()

        tp = time.perf_counter()
        g_new = self._apply_graph(batches[0])
        mode, prep, decision = self._prepare(g_new, batches[0])
        plan_total += time.perf_counter() - tp

        for i in range(len(batches)):
            epoch0 = self.backend.barrier_epoch
            td = time.perf_counter()
            # async for incremental; chunked/full execute synchronously (they
            # flush first), which honestly costs this batch its prefetch hit
            self._dispatch_mode(mode, prep)
            dispatch_s = time.perf_counter() - td
            self.graph = g_new
            stats.append(self._stats(prep, mode, decision, 0.0, dispatch_s, 0.0))
            if decision is not None:
                self.policy.observe(decision, dispatch_s)
            if i + 1 < len(batches):
                tp = time.perf_counter()  # overlapped with device execution
                nxt = self._apply_graph(batches[i + 1])
                mode, prep, decision = self._prepare(nxt, batches[i + 1])
                g_new = nxt
                plan_total += time.perf_counter() - tp
                # a real prefetch hit only if no backend barrier fired
                # between dispatch(i) and the completed plan(i+1)
                if self.backend.barrier_epoch == epoch0:
                    prefetch_hits += 1
            self._after_batch(sync_before_refresh=True)
        self.backend.flush()
        self.backend.synchronize()
        return self._account(StreamStats(stats, time.perf_counter() - t_start, plan_total,
                                         prefetch_hits=prefetch_hits), snaps)

    # ------------------------------------------------------------------ #
    # batch-window fusion: buffer up to fusion.window pending batches, fuse
    # the maximal independent prefix into ONE packed plan / ONE device
    # dispatch, fall back to serial on overlap.  Bitwise-equal to the
    # serial loop (the disjoint-footprint argument is on FusionWindow).
    # ------------------------------------------------------------------ #
    def _fusion_active(self) -> bool:
        """Fusion runs only when configured AND the policy allows it: a
        per-batch ``force_mode`` schedule is indexed by logical batch, so
        fusing under one would desynchronise it — those streams take the
        serial loop."""
        if self.fusion is None:
            return False
        if self.policy is not None and self.policy.force_mode is not None \
                and not isinstance(self.policy.force_mode, str):
            return False
        return True

    def _refresh_limit(self) -> int:
        """Batches until the next refresh boundary (windows must not span
        one: refresh recomputes state, so constituents after the boundary
        would fuse against pre-refresh values)."""
        if not self.refresh_every:
            return 1 << 30
        return self.refresh_every - self._batches_seen % self.refresh_every

    def _plan_pending(self, g_old: CSRGraph, batch: UpdateBatch) -> _PendingPlan:
        g_new = g_old.apply_updates(
            batch.ins_src, batch.ins_dst, batch.del_src, batch.del_dst,
            batch.ins_weights, batch.ins_etypes)
        plan = build_plan(self.backend.model, g_old, g_new, batch, self.backend.L)
        return _PendingPlan(batch=batch, g_old=g_old, g_new=g_new, plan=plan,
                            fp=FusionWindow.footprint(plan, batch))

    def _decide_window(self, merged_plan: BatchPlan):
        """Policy check for a fused window (None → no policy → fuse)."""
        if self.policy is None:
            return None, "incremental"
        decision = self.policy.decide_window(merged_plan)
        return decision, decision.mode

    def _fused_stats(self, group: List[_PendingPlan], dispatch_s: float,
                     decision) -> List[BatchStats]:
        """Per-constituent BatchStats of one fused dispatch: plan counters
        stay per logical batch, the window's one dispatch time and policy
        estimate are charged to the first."""
        k = len(group)
        out = []
        for j, p in enumerate(group):
            out.append(BatchStats(
                inc_edges=p.plan.total_inc_edges(),
                full_edges=p.plan.total_full_edges(),
                out_vertices=p.plan.total_vertices(),
                plan_time_s=0.0,
                exec_time_s=dispatch_s if j == 0 else 0.0,
                graph_time_s=0.0,
                mode="incremental",
                est_edges=(decision.est_edges
                           if decision is not None and j == 0 else 0),
                est_cost=(decision.costs["incremental"]
                          if decision is not None and j == 0 else 0.0),
                fused_window=k,
            ))
        return out

    def _apply_stream_fused(self, batches: List[UpdateBatch]) -> StreamStats:
        """The fused variant of :meth:`apply_stream`: the same overlap
        schedule (host planning of future batches runs behind the device
        step just issued), but each dispatch covers the maximal independent
        prefix of the lookahead window."""
        fw = FusionWindow(self.fusion)
        t_start = time.perf_counter()
        stats: List[BatchStats] = []
        plan_total = 0.0
        prefetch_hits = 0
        fusion0 = (self.fusion_windows, self.fused_batches, self.fusion_fallbacks)
        snaps = self._snapshots()

        pending: List[_PendingPlan] = []
        nxt = 0  # next batch index to plan
        g_plan = self.graph  # graph snapshot after every *planned* batch

        def top_up() -> int:
            """Fill the lookahead window (host-only; overlaps execution)."""
            nonlocal nxt, g_plan, plan_total
            planned = 0
            while len(pending) < self.fusion.window and nxt < len(batches):
                tp = time.perf_counter()
                pending.append(self._plan_pending(g_plan, batches[nxt]))
                g_plan = pending[-1].g_new
                nxt += 1
                plan_total += time.perf_counter() - tp
                planned += 1
            return planned

        top_up()
        while pending:
            limit = min(len(pending), self._refresh_limit())
            k = fw.select_prefix([p.fp for p in pending[:limit]])
            if k >= 2:
                tp = time.perf_counter()
                merged_plan, merged_batch = FusionWindow.merge(
                    [p.plan for p in pending[:k]], [p.batch for p in pending[:k]])
                decision, mode = self._decide_window(merged_plan)
                if mode == "incremental":
                    prep = self.backend.plan(pending[0].g_old, pending[k - 1].g_new,
                                             merged_batch, base_plan=merged_plan)
                    plan_total += time.perf_counter() - tp
                    group = pending[:k]
                    del pending[:k]
                    epoch0 = self.backend.barrier_epoch
                    td = time.perf_counter()
                    self.backend.dispatch(prep)
                    dispatch_s = time.perf_counter() - td
                    self.graph = group[-1].g_new
                    self.fusion_windows += 1
                    self.fused_batches += k
                    stats.extend(self._fused_stats(group, dispatch_s, decision))
                    if decision is not None:
                        self.policy.observe(decision, dispatch_s)
                    planned = top_up()  # overlapped with fused execution
                    if self.backend.barrier_epoch == epoch0:
                        prefetch_hits += planned
                    for _ in range(k):
                        self._after_batch(sync_before_refresh=True)
                    continue
                # the policy priced the fused unit off the incremental path:
                # break the window up, re-decide per batch below
                plan_total += time.perf_counter() - tp
                self.fusion_fallbacks += 1
            elif limit >= 2:
                self.fusion_fallbacks += 1  # head pair overlaps
            # serial dispatch of the window head (plan reused, not rebuilt)
            p = pending.pop(0)
            tp = time.perf_counter()
            mode, prep, decision = self._prepare(p.g_new, p.batch, base=p.plan)
            plan_total += time.perf_counter() - tp
            epoch0 = self.backend.barrier_epoch
            td = time.perf_counter()
            self._dispatch_mode(mode, prep)
            dispatch_s = time.perf_counter() - td
            self.graph = p.g_new
            stats.append(self._stats(prep, mode, decision, 0.0, dispatch_s, 0.0))
            if decision is not None:
                self.policy.observe(decision, dispatch_s)
            planned = top_up()
            if self.backend.barrier_epoch == epoch0:
                prefetch_hits += planned
            self._after_batch(sync_before_refresh=True)

        self.backend.flush()
        self.backend.synchronize()
        ss = StreamStats(stats, time.perf_counter() - t_start, plan_total,
                         prefetch_hits=prefetch_hits)
        ss.fusion_windows = self.fusion_windows - fusion0[0]
        ss.fused_batches = self.fused_batches - fusion0[1]
        ss.fusion_fallbacks = self.fusion_fallbacks - fusion0[2]
        return self._account(ss, snaps)

    def apply_window(self, batches: Sequence[UpdateBatch], on_plan=None) -> List[BatchStats]:
        """Blocking fused application of a *prefix* of ``batches``.

        The serving front-end's fused write path: plans batches one at a
        time from the current graph, stops at the first footprint overlap /
        window cap / refresh boundary, dispatches the accumulated prefix as
        one fused step (or one serial batch when the prefix is length 1),
        and blocks until the state reflects it.  Returns one
        :class:`BatchStats` per batch consumed.

        ``on_plan`` runs once per *constituent* batch — in stream order,
        before dispatch, with the constituent's own :class:`BatchPlan` —
        while the substrate still holds the pre-window state.  Disjoint
        write sets make the pre-window values on batch j's write set
        identical to the post-batch-(j-1) values there, so the front-end's
        per-version pre-images stay exact."""
        batches = list(batches)
        if not batches:
            return []
        fw = FusionWindow(self.fusion) if self._fusion_active() \
            else FusionWindow(FusionConfig(window=1))
        limit = min(len(batches), fw.config.window, self._refresh_limit())
        t0 = time.perf_counter()
        group = [self._plan_pending(self.graph, batches[0])]
        while len(group) < limit:
            p = self._plan_pending(group[-1].g_new, batches[len(group)])
            if not all(fw.disjoint(p.fp, q.fp) for q in group):
                break  # one wasted (deterministic, value-independent) plan
            group.append(p)
        k = len(group)
        decision, mode = None, "incremental"
        if k >= 2:
            merged_plan, merged_batch = FusionWindow.merge(
                [p.plan for p in group], [p.batch for p in group])
            decision, mode = self._decide_window(merged_plan)
            if mode != "incremental":
                self.fusion_fallbacks += 1
                group, k = group[:1], 1
        elif limit >= 2 and len(batches) >= 2:
            self.fusion_fallbacks += 1
        t1 = time.perf_counter()
        if k >= 2:
            prep = self.backend.plan(group[0].g_old, group[-1].g_new, merged_batch,
                                     base_plan=merged_plan)
            if on_plan is not None:
                for p in group:
                    on_plan(p.plan)
            td = time.perf_counter()
            self.backend.dispatch(prep)
            self.backend.flush()
            self.backend.synchronize()
            dispatch_s = time.perf_counter() - td
            self.graph = group[-1].g_new
            self.fusion_windows += 1
            self.fused_batches += k
            out = self._fused_stats(group, dispatch_s, decision)
            out[0].plan_time_s = t1 - t0
            if decision is not None:
                self.policy.observe(decision, dispatch_s)
            for _ in range(k):
                self._after_batch(sync_before_refresh=True)
            return out
        p = group[0]
        mode, prep, decision = self._prepare(p.g_new, p.batch, base=p.plan)
        if on_plan is not None and mode != "full":
            on_plan(prep)
        td = time.perf_counter()
        self._dispatch_mode(mode, prep)
        self.backend.flush()
        self.backend.synchronize()
        dispatch_s = time.perf_counter() - td
        self.graph = p.g_new
        if decision is not None:
            self.policy.observe(decision, dispatch_s)
        self._after_batch(sync_before_refresh=True)
        return [self._stats(prep, mode, decision, t1 - t0, dispatch_s, 0.0)]


def stage_packed(packed: PackedPlan, device) -> Tuple[torch.Tensor, ...]:
    """Ship a packed plan's buffers to ``device`` in one copy
    (:func:`~repro_torch.device.host_to_device`).  Returns device tensors
    (idx, flt, msk, sched, feat_vals); feat_vals is None without feature
    updates."""
    parts = [packed.idx, packed.flt, packed.msk, packed.sched]
    if packed.feat_vals is not None:
        parts.append(np.asarray(packed.feat_vals, np.float32))
    idx, flt, msk, sched, *feat = host_to_device(parts, device)
    return idx, flt, msk, sched, (feat[0] if feat else None)


# ====================================================================== #
# DeviceBackend — state in device memory, one fused in-place step / batch
# ====================================================================== #
class DeviceBackend(StateBackend):
    """All state device-resident as scratch-extended ``[N+1, ·]`` tensors;
    each batch runs as one fused L-layer step over a packed plan
    (:func:`repro_torch.core.incremental.fused_stream_step`), updating the
    state in place.

    ``fused=False`` runs the same packed plan one
    :func:`~repro_torch.core.incremental.incremental_layer` at a time on
    fresh tensors — the unfused reference.  Both see the same padded shapes,
    so fused ≡ unfused holds bit for bit on a card too, where some reductions
    pick their summation order by shape.

    ``store_h=False`` is the paper's recomputation-based storage option
    (§V-B): the backend keeps ``x``, ``a`` and ``nct`` only and rebuilds
    ``h^l = update(h^{l-1}, a^l)`` (:meth:`reconstruct_h`) when a step, a read
    or a policy primitive needs it — for a step: rebuild, step in place,
    drop.  The state shrinks by the ``h[1..L]`` share."""

    def __init__(
        self,
        model: GNNModel,
        params: Sequence[Params],
        graph: CSRGraph,
        x: torch.Tensor,
        store_h: bool = True,
        fused: bool = True,
    ):
        self.model = model
        self.params = list(params)
        self.L = len(self.params)
        self.store_h = store_h
        self.fused = fused
        self.device = x.device
        # high-water-mark capacity buckets: shrinking batches reuse the
        # previous PackedLayout (and buffer shapes)
        self.hwm = BucketHysteresis()
        self._init_state(graph, x)

    @property
    def overlap_capable(self) -> bool:
        return self.fused

    # ------------------------------------------------------------------ #
    # state: scratch-extended [N+1, ·] device tensors (index n = scratch)
    # ------------------------------------------------------------------ #
    def _init_state(self, graph: CSRGraph, x: torch.Tensor) -> None:
        states = full_forward(self.model, self.params, x, graph)
        self._h: List[Optional[torch.Tensor]] = [with_scratch(x)] + [
            with_scratch(s.h) for s in states]
        self._a: List[torch.Tensor] = [with_scratch(s.a) for s in states]
        self._nct: List[torch.Tensor] = [with_scratch(s.nct) for s in states]
        if not self.store_h:
            self._drop_h()

    def refresh(self, graph: CSRGraph) -> None:
        """Full recompute from the current features, written into the
        persistent tensors in place (they stay where every holder expects
        them, and the state is never allocated twice)."""
        states = full_forward(self.model, self.params, self.x, graph)
        for l, s in enumerate(states):
            self._a[l][:-1].copy_(s.a)
            self._nct[l][:-1].copy_(s.nct)
            if self._h[l + 1] is not None:
                self._h[l + 1][:-1].copy_(s.h)

    def _drop_h(self) -> None:
        self._h = [self._h[0]] + [None] * self.L

    def _restore_h(self) -> None:
        """store_h=False: rebuild ``h[1..L]`` as scratch-extended tensors
        before a step writes them in place."""
        if self._h[1] is None:
            self._h = [self._h[0]] + [with_scratch(v) for v in self.reconstruct_h()[1:]]

    def reconstruct_h(self) -> List[torch.Tensor]:
        """Recomputation-based storage (paper §V-B): rebuild
        ``h^l = update(h^{l-1}, a^l)`` over all rows from the cached
        aggregation states (a dense product, no kernel)."""
        h = [self.x]
        for l in range(self.L):
            h.append(self.model.update(self.params[l], h[l], self._a[l][:-1]))
        return h

    @property
    def x(self) -> torch.Tensor:
        return self._h[0][:-1]

    @property
    def h(self) -> List[Optional[torch.Tensor]]:
        """Per-layer embeddings without scratch rows (None where
        ``store_h=False`` dropped them)."""
        return [None if v is None else v[:-1] for v in self._h]

    @property
    def a(self) -> List[torch.Tensor]:
        return [v[:-1] for v in self._a]

    @property
    def nct(self) -> List[torch.Tensor]:
        return [v[:-1] for v in self._nct]

    @property
    def embeddings(self) -> torch.Tensor:
        if self._h[-1] is None:
            return self.reconstruct_h()[-1]
        return self._h[-1][:-1]

    def state_bytes(self) -> int:
        return sum((v.shape[0] - 1) * v[0].numel() * v.element_size()
                   for v in (*self._h, *self._a, *self._nct) if v is not None)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # serving API (snapshot_rows: the protocol's O(len(rows)) gather)
    # ------------------------------------------------------------------ #
    def changed_rows(self, prep: PackedPlan) -> np.ndarray:
        return prep.out_rows_final

    # ------------------------------------------------------------------ #
    # policy-execution primitives: in-place row writes into the
    # scratch-extended tensors (global rows < n: the scratch row stays 0)
    # ------------------------------------------------------------------ #
    def _rows_on_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)

    def apply_feature_updates(self, rows: np.ndarray, vals: np.ndarray) -> None:
        self._h[0][self._rows_on_device(rows)] = torch.from_numpy(
            np.asarray(vals, np.float32)).to(self.device)

    def layer_input_host(self, l: int) -> np.ndarray:
        h = self.reconstruct_h()[l] if self._h[l] is None else self._h[l][:-1]
        return h.to("cpu", copy=True).numpy()

    def scatter_layer_rows(self, l: int, rows: np.ndarray, a_rows: np.ndarray,
                           nct_rows: np.ndarray, h_rows: np.ndarray) -> None:
        idx = self._rows_on_device(rows)
        a_d, nct_d, h_d = host_to_device((a_rows, nct_rows, h_rows), self.device)
        self._a[l][idx] = a_d
        self._nct[l][idx] = nct_d
        if self._h[l + 1] is not None:  # store_h=False reconstructs instead
            self._h[l + 1][idx] = h_d

    # ------------------------------------------------------------------ #
    def plan(self, g_old: CSRGraph, g_new: CSRGraph, batch: UpdateBatch,
             base_plan: Optional[BatchPlan] = None) -> PackedPlan:
        if base_plan is not None:  # policy path / fused window: Alg. 4 already ran
            return pack_plan(base_plan, batch.feat_vertices, batch.feat_values, hwm=self.hwm)
        return build_packed_plan(self.model, g_old, g_new, batch, self.L, hwm=self.hwm)

    def dispatch(self, packed: PackedPlan) -> None:
        """One host→device copy for the whole plan, then the step."""
        if not self.store_h:
            self._restore_h()
        bufs = stage_packed(packed, self.device)
        if self.fused:
            fused_stream_step(self.model, packed.layout, self.params, self._h, self._a,
                              self._nct, *bufs)
        else:
            self._execute_unfused(packed.layout, *bufs)
        if not self.store_h:
            self._drop_h()

    # ------------------------------------------------------------------ #
    # unfused per-layer path — equivalence reference
    # ------------------------------------------------------------------ #
    def _execute_unfused(self, layout: PackedLayout, idx, flt, msk, sched, feat_vals) -> None:
        n = layout.n
        deg_old, deg_new = flt[: n + 1], flt[n + 1 : 2 * (n + 1)]
        h_old = self.h
        h0_new = h_old[0]
        if layout.feat_cap:
            frows, fmask = idx[: layout.feat_cap], msk[: layout.feat_cap]
            h0_new = with_scratch(h0_new)
            h0_new[frows] = torch.where(fmask[:, None], feat_vals, h0_new[frows])
            h0_new = h0_new[:n]
        h_new = [h0_new]
        a_new, nct_new = [], []
        for l, g in enumerate(packed_fields(layout, idx, flt, msk, sched)):
            an, nn, hn = incremental_layer(
                self.model, self.params[l], with_scratch(h_old[l]), with_scratch(h_new[l]),
                deg_old, deg_new, self.a[l], self.nct[l], h_old[l + 1], g)
            a_new.append(an)
            nct_new.append(nn)
            h_new.append(hn)
        self._h = [with_scratch(v) for v in h_new]
        self._a = [with_scratch(v) for v in a_new]
        self._nct = [with_scratch(v) for v in nct_new]


# ====================================================================== #
# OffloadBackend — host-resident state, compact per-layer staging (§V-B)
# ====================================================================== #
@dataclasses.dataclass
class TransferStats:
    rows_up: int = 0
    rows_down: int = 0
    bytes_up: int = 0
    bytes_down: int = 0

    @property
    def total_rows(self) -> int:
        """H2D+D2H row volume — deterministic (a function of the plans)."""
        return self.rows_up + self.rows_down


@dataclasses.dataclass
class _CacheLayerOps:
    """Plan-time device hot-row-cache schedule for one layer.

    Built by ``_plan_cache`` next to the transfer tables (value-independent,
    so it keeps the plan/execute overlap contract) and shipped with the
    layer's tables.  All ``*_pos`` arrays are positions in the layer's
    compact device workspace (``[nh]`` gather space, ``[ns]`` state space);
    ``h_miss_src``/``s_miss_src`` are the global row ids the staging worker
    still gathers (the cold misses); ``patch_src`` / ``*_wb_pos`` index the
    previous / current layer's compact device outputs."""

    # h^{l-1} gather space ("h", l): hits read device slots, misses stage
    h_hit_pos: np.ndarray
    h_hit_slots: np.ndarray
    h_miss_pos: np.ndarray
    h_miss_src: np.ndarray
    h_admit_midx: np.ndarray  # miss-buffer rows to install into fresh slots
    h_admit_slots: np.ndarray
    # device-side new-view patch (previous layer's still-resident outputs)
    patch_pos: np.ndarray
    patch_src: np.ndarray
    # state gather space ("s", l): a/nct/h_cur rows
    s_hit_pos: np.ndarray
    s_hit_slots: np.ndarray
    s_miss_pos: np.ndarray
    s_miss_src: np.ndarray
    # in-place slot refresh from this layer's kernel outputs
    s_wb_pos: np.ndarray
    s_wb_slots: np.ndarray
    hnext_wb_pos: np.ndarray
    hnext_wb_slots: np.ndarray

    #: the fields that ship to the device with the layer's tables
    DEVICE_FIELDS = ("h_hit_pos", "h_hit_slots", "h_miss_pos", "h_admit_midx",
                     "h_admit_slots", "patch_pos", "patch_src", "s_hit_pos", "s_hit_slots",
                     "s_miss_pos", "s_wb_pos", "s_wb_slots", "hnext_wb_pos", "hnext_wb_slots")


def _patch_positions(dst_keys: np.ndarray, src_rows: np.ndarray):
    """Workspace positions (and source indices) of the new-view patch —
    the same match :func:`_override_rows` performs on the host path, so
    the cached device patch is position-for-position identical."""
    idx = np.full(dst_keys.shape[0], -1, np.int64)
    _override_rows(idx, np.asarray(dst_keys, np.int64), src_rows,
                   np.arange(src_rows.shape[0], dtype=np.int64))
    pos = np.flatnonzero(idx >= 0).astype(np.int64)
    return pos, idx[pos]


def _cache_assemble(n_rows: int, dim: int, device, miss_pos: torch.Tensor,
                    miss_vals: torch.Tensor, hit_pos: torch.Tensor,
                    hit_vals: Optional[torch.Tensor]) -> torch.Tensor:
    """Device workspace assembly: a zeroed ``[n_rows + 1, dim]`` tensor (its
    last row the layer's scratch row) and two index writes, the staged cold
    misses and the cached hot rows.  Hit and miss positions partition the
    rows, so the result is bitwise the staged workspace it replaces."""
    out = torch.zeros((n_rows + 1, dim), dtype=torch.float32, device=device)
    if miss_pos.shape[0]:
        out[miss_pos] = miss_vals
    if hit_pos.shape[0]:
        out[hit_pos] = hit_vals
    return out


@dataclasses.dataclass
class _LayerTransfer:
    """Plan-time (value-independent) compact transfer tables for one layer.

    ``tables`` are the kernel's index tables in compact space under the
    field names ``incremental_layer`` reads (``touch_rows``/``f_rows``/
    ``out_rows`` in state space, ``f_rows_h``/``out_rows_h`` and the edge
    endpoints in the ``need_h`` gather space), the compact degree tables,
    the row schedules of ``delta_agg`` and ``segment_spmm``, and with the
    hot-row cache its positions and slots.  They ship with the layer's row
    blocks in one copy, laid out by ``layout``."""

    need_h: np.ndarray  # global ids of h^{l-1} rows the device needs
    srows: np.ndarray  # global ids of state rows updated (= out_rows live)
    tables: dict  # name → host array
    layout: Optional["_StagedLayout"] = None


@dataclasses.dataclass(frozen=True)
class _StagedLayout:
    """Byte layout of one layer's staging buffer: its index tables, then
    its float row blocks (``h_old``, ``h_new``, ``a``, ``nct``, ``h_cur``,
    each with one zeroed scratch row after its rows, so the layer updates
    them in place; with the cache, miss rows only, no scratch row and no
    ``h_new``)."""

    names: Tuple[str, ...]
    specs: Tuple[Spec, ...]
    offsets: Tuple[int, ...]
    total: int
    blocks: Tuple[str, ...]  # the float row blocks among ``names``

    @staticmethod
    def build(tables: dict, blocks: Sequence[Tuple[str, int, int]]) -> "_StagedLayout":
        names = tuple(tables) + tuple(b[0] for b in blocks)
        specs = tuple((a.shape, a.dtype) for a in tables.values()) + tuple(
            ((rows, width), np.dtype(np.float32)) for _, rows, width in blocks)
        offsets, total = byte_layout(specs)
        return _StagedLayout(names, specs, tuple(offsets), total, tuple(b[0] for b in blocks))


@dataclasses.dataclass
class _OffloadPrep:
    """Host-side output of the planning phase for one batch."""

    plan: BatchPlan
    batch: UpdateBatch
    transfers: List[_LayerTransfer]
    cache_ops: Optional[List[_CacheLayerOps]] = None

    @property
    def n_inc_edges(self) -> int:
        return self.plan.total_inc_edges()

    @property
    def n_full_edges(self) -> int:
        return self.plan.total_full_edges()

    @property
    def n_out_rows(self) -> int:
        return self.plan.total_vertices()


class _HostResidentBackend(StateBackend):
    """Host-numpy state shared by :class:`OffloadBackend` and
    :class:`ChunkedBackend`: ``h[0..L]``, ``a`` and ``nct`` come from
    ``full_forward`` on the backend's device at construction and at
    ``refresh``; the Serving API and the policy primitives gather and
    scatter host arrays directly.  With a hot-row cache attached (offload)
    the primitives invalidate the cached rows they rewrite (keyed by rows
    only, so value-independent)."""

    #: h^1..h^L are kept (no recompute-h option here); no fused device step
    store_h = True
    fused = False
    _cache: Optional["HotRowCache"] = None

    def __init__(self, model: GNNModel, params: Sequence[Params], graph: CSRGraph,
                 x: np.ndarray, device):
        self.model = model
        self.params = list(params)
        self.L = len(self.params)
        self.device = torch.device(device)
        self.x = np.asarray(x, np.float32)
        self._init_state(self.x.copy(), graph)

    def _init_state(self, h0: np.ndarray, graph: CSRGraph) -> None:
        """``(h, a, nct)`` from ``full_forward`` on the device over the
        features ``h0`` (kept as ``h[0]``).  The device tensors are dropped
        on return: the whole state sits on the device only for this call."""
        states = full_forward(self.model, self.params, torch.from_numpy(h0).to(self.device),
                              graph)

        def host(t: torch.Tensor) -> np.ndarray:
            return t.cpu().contiguous().numpy()

        self.h = [h0] + [host(s.h) for s in states]
        self.a = [host(s.a) for s in states]
        self.nct = [host(s.nct) for s in states]

    @property
    def embeddings(self) -> np.ndarray:
        self.flush()
        return self.h[-1]

    def state_bytes(self) -> int:
        return sum(t.nbytes for t in self.h + self.a + self.nct)

    def synchronize(self) -> None:
        """The host state is final after ``flush``; this also waits for the
        device work the cache stores may still have queued."""
        self.flush()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def refresh(self, graph: CSRGraph) -> None:
        self.flush()
        self._init_state(self.h[0], graph)
        if self._cache is not None:  # every cached row may now be stale
            self._cache.invalidate_all()

    # ------------------------------------------------------------------ #
    # Serving API: host-numpy gather; flush() first so a deferred final
    # write-back can never be missed (a no-op at a version boundary)
    # ------------------------------------------------------------------ #
    def snapshot_rows(self, rows: np.ndarray) -> np.ndarray:
        self.flush()
        return self.h[-1][np.asarray(rows, np.int64)]

    # ------------------------------------------------------------------ #
    # policy-execution primitives: direct host-numpy scatters (the
    # orchestrator flushes first, so no deferred write-back is in flight)
    # ------------------------------------------------------------------ #
    def apply_feature_updates(self, rows: np.ndarray, vals: np.ndarray) -> None:
        rows = np.asarray(rows, np.int64)
        self.h[0][rows] = np.asarray(vals, np.float32)
        if self._cache is not None:
            self._cache.invalidate(("h", 0), rows)

    def layer_input_host(self, l: int) -> np.ndarray:
        return self.h[l]  # host-resident already: no device copy

    def scatter_layer_rows(self, l: int, rows: np.ndarray, a_rows: np.ndarray,
                           nct_rows: np.ndarray, h_rows: np.ndarray) -> None:
        self.a[l][rows] = a_rows
        self.nct[l][rows] = nct_rows
        self.h[l + 1][rows] = h_rows
        if self._cache is not None:
            self._cache.invalidate(("s", l), rows)
            self._cache.invalidate(("h", l + 1), rows)


class _DeferredWritebackMixin:
    """Deferred final-layer write-back + staging barrier of the host-resident
    backend.  ``dispatch`` leaves the last layer's (device → host)
    write-back pending — a :class:`StagingTicket` in async-staging mode (the
    worker waits on the layer's D2H event and scatters), the raw payload in
    sync mode — and ``flush`` completes it and **drains the staging
    worker**, re-raising any worker exception on the caller thread.  The
    orchestrator's next plan (and, async, even the next batch's gathers,
    queued behind the write-back) runs while the device still executes the
    final layer."""

    _pending = None
    _staging: Optional[HostStagingPipeline] = None
    _cache: Optional["HotRowCache"] = None

    def flush(self) -> None:
        self.barrier_epoch += 1
        pending, self._pending = self._pending, None
        if pending is not None:
            if isinstance(pending, StagingTicket):
                pending.wait()
            else:
                self._final_writeback(pending)
        if self._staging is not None:
            self._staging.drain()

    def staging_snapshot(self) -> Optional[StagingStats]:
        return self._staging.stats.snapshot()

    def cache_snapshot(self) -> Optional["CacheStats"]:
        return None if self._cache is None else self._cache.stats.snapshot()

    @property
    def async_staging(self) -> bool:
        return self._staging.async_mode

    def _cache_layer_ops(self, l: int, n: int, rows_h: np.ndarray, rows_s: np.ndarray,
                         prev_rows: np.ndarray, deg: np.ndarray):
        """Per-layer cache planning: the read splits for the ``("h", l)`` /
        ``("s", l)`` spaces and the write-back slot refresh for ``("s", l)``
        and ``("h", l+1)``.  ``prev_rows`` (the rows the batch wrote earlier
        — layer l-1's scatter set, or the feature vertices for l=0) are
        excluded from hits *and* staged-value admission: their cached slots
        were just refreshed with post-write values, while layer l's old view
        needs the pristine pre-batch rows."""
        cache = self._cache
        h_split = cache.plan_reads(("h", l), n, rows_h, deg[rows_h], exclude_rows=prev_rows)
        s_split = cache.plan_reads(("s", l), n, rows_s, deg[rows_s], admit=False)
        s_wb = cache.plan_writeback(("s", l), n, rows_s, deg[rows_s])
        if l + 1 < self.L:
            hn_wb = cache.plan_writeback(("h", l + 1), n, rows_s, deg[rows_s])
        else:  # h^L is never re-read through the cache
            hn_wb = (np.zeros(0, np.int64), np.zeros(0, np.int32))
        return h_split, s_split, s_wb, hn_wb

    def _prewarm_cache(self, graph: CSRGraph) -> None:
        """Seed every cache row space from the base graph's top-degree rows
        before batch 0 (``CacheConfig.prewarm_rows``).  Runs at construction,
        after the initial full forward: the gathered values are the pristine
        base state, so the coherence invariant holds trivially.  Degree ties
        admit the smallest row id (stable argsort)."""
        cache = self._cache
        if cache is None or not cache.config.prewarm_rows:
            return
        k = min(int(cache.config.prewarm_rows), graph.n)
        deg = graph.in_degree().astype(np.int64)
        top = np.argsort(-deg, kind="stable")[:k].astype(np.int64)
        degs = deg[top].astype(np.float32)
        rows = self._gather_state_rows
        for l in range(self.L):
            cache.prewarm(("h", l), graph.n, top, degs, {"h": rows(self.h[l], top)})
            cache.prewarm(("s", l), graph.n, top, degs, {
                "a": rows(self.a[l], top), "nct": rows(self.nct[l], top),
                "h": rows(self.h[l + 1], top)})

    def _gather_state_rows(self, arr: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Global state rows of a host array (the sharded hybrid overrides
        this with its per-shard block gather)."""
        return arr[rows]

    def _cache_invalidate_feats(self, batch: UpdateBatch) -> np.ndarray:
        """Plan-time, value-independent invalidation for a batch's feature
        scatter (it rewrites h[0] rows outside the kernel write-back path);
        returns the feature rows as layer 0's exclusion set."""
        if batch.feat_vertices is not None and np.asarray(batch.feat_vertices).size:
            rows = np.asarray(batch.feat_vertices, np.int64)
            self._cache.invalidate(("h", 0), rows)
            return rows
        return np.zeros(0, np.int64)

    def _defer_final(self, payload) -> None:
        """Queue the final layer's write-back: on the worker (async) or as
        a raw pending payload completed inline at ``flush`` (sync)."""
        pipe = self._staging
        nb = 0 if payload is None or payload[-1] is None else payload[-1].nbytes
        if pipe.async_mode:
            self._pending = pipe.submit_writeback(
                partial(self._final_writeback, payload), nbytes=nb, tag="final")
        else:
            pipe.stats.staged_bytes += nb
            self._pending = payload


class OffloadBackend(_DeferredWritebackMixin, _HostResidentBackend):
    """Out-of-memory embedding management (paper §V-B).

    The per-layer state (h, a, nct) lives as **host numpy**; per batch only
    the compact row sets the plan touches go to the device, the port's own
    incremental layer (:func:`~repro_torch.core.incremental.incremental_layer_inplace`)
    runs in place on the shipped compact blocks (the layer is index-based,
    so a compact view with remapped indices is exactly equivalent: step 1
    launches ``delta_agg``, step 3's ``subset_layer`` ``segment_spmm``), and
    all write-backs are grouped.
    Host staging runs through a
    :class:`~repro_torch.serve.staging.HostStagingPipeline`: pristine
    per-layer gathers into pinned buffers prefetch on a background worker
    while the device computes the previous layer, write-back scatters retire
    there too, and the final layer's write-back is deferred to the worker
    (``flush`` is the barrier) so batch-t+1 planning — and its gathers —
    overlap the device's execution of batch t's last layer.
    ``async_staging=False`` runs the identical staging jobs inline
    (bitwise-identical output).

    Each layer ships in **one** host→device copy: its index tables and row
    schedules (built at plan time) and its float row blocks are laid end to
    end in the layer's pinned staging buffer (:class:`_StagedLayout`), and
    the outputs come back in one ``non_blocking`` D2H per tensor into pinned
    buffers.  CUDA work stays on the calling thread; the worker waits on
    events only."""

    def __init__(self, model: GNNModel, params: Sequence[Params], graph: CSRGraph,
                 x: np.ndarray, device="cuda", async_staging: bool = True,
                 cache: Optional["HotRowCache"] = None):
        self.transfers = TransferStats()
        self._cache = cache
        self._staging = HostStagingPipeline(len(params), async_mode=async_staging,
                                            name="offload",
                                            pinned=torch.device(device).type == "cuda")
        super().__init__(model, params, graph, x, device)
        self._prewarm_cache(graph)

    def changed_rows(self, prep: _OffloadPrep) -> np.ndarray:
        return np.unique(prep.transfers[-1].srows)

    # ------------------------------------------------------------------ #
    # planning phase (host only, value-independent)
    # ------------------------------------------------------------------ #
    def plan(self, g_old: CSRGraph, g_new: CSRGraph, batch: UpdateBatch,
             base_plan: Optional[BatchPlan] = None) -> _OffloadPrep:
        plan = (base_plan if base_plan is not None
                else build_plan(self.model, g_old, g_new, batch, self.L))
        n = g_old.n
        prev_rows = (
            np.asarray(batch.feat_vertices, np.int64)
            if batch.feat_vertices is not None and batch.feat_vertices.size
            else np.zeros(0, np.int64)
        )
        transfers: List[_LayerTransfer] = []
        for lp in plan.layers:
            need_h = np.unique(np.concatenate([
                lp.e_src[lp.e_mask].astype(np.int64),
                lp.e_dst[lp.e_mask].astype(np.int64),
                lp.f_src[lp.f_emask].astype(np.int64),
                lp.f_rows[lp.f_mask].astype(np.int64),
                lp.out_rows[lp.out_mask].astype(np.int64),
                prev_rows,
            ]))
            srows = lp.out_rows[lp.out_mask].astype(np.int64)
            transfers.append(_LayerTransfer(need_h=need_h, srows=srows,
                                            tables=_compact_tables(plan, lp, need_h, srows, n)))
            prev_rows = srows
        cache_ops = None
        if self._cache is not None:
            cache_ops = self._plan_cache(plan, batch, transfers)
        for l, tr in enumerate(transfers):
            tr.layout = self._layout(l, tr, None if cache_ops is None else cache_ops[l])
        return _OffloadPrep(plan=plan, batch=batch, transfers=transfers, cache_ops=cache_ops)

    def _layout(self, l: int, tr: _LayerTransfer, cops: Optional[_CacheLayerOps]) -> _StagedLayout:
        """The layer's staging byte layout: tables (+ the cache's device
        positions), then the float row blocks the worker gathers."""
        d_in, da = self.h[l].shape[1], self.a[l].shape[1]
        dc, d_out = self.nct[l].shape[1], self.h[l + 1].shape[1]
        tables = dict(tr.tables)
        if cops is None:  # + the scratch row
            nh, ns = tr.need_h.shape[0] + 1, tr.srows.shape[0] + 1
            blocks = [("h_old", nh, d_in), ("h_new", nh, d_in)]
        else:
            tables.update({f: getattr(cops, f) for f in _CacheLayerOps.DEVICE_FIELDS})
            nh, ns = cops.h_miss_src.shape[0], cops.s_miss_src.shape[0]
            blocks = [("h_old", nh, d_in)]
        blocks += [("a", ns, da), ("nct", ns, dc), ("h_cur", ns, d_out)]
        return _StagedLayout.build(tables, blocks)

    def _plan_cache(self, plan: BatchPlan, batch: UpdateBatch,
                    transfers: List[_LayerTransfer]) -> List[_CacheLayerOps]:
        """Plan-time residency split for every layer (host only,
        value-independent — it touches slot metadata and degree tables,
        never row values).  Runs after dispatch(t-1) returned, so all of
        batch t-1's cache-store updates are already recorded."""
        cache = self._cache
        n = plan.deg_old.shape[0] - 1  # deg tables carry a scratch slot
        deg = plan.deg_new
        cache.decay_tick()
        prev_rows = self._cache_invalidate_feats(batch)
        ops: List[_CacheLayerOps] = []
        for l, tr in enumerate(transfers):
            h_split, s_split, s_wb, hn_wb = self._cache_layer_ops(
                l, n, tr.need_h, tr.srows, prev_rows, deg)
            patch_pos, patch_src = _patch_positions(tr.need_h, prev_rows)
            ops.append(_CacheLayerOps(
                h_hit_pos=h_split.hit_pos, h_hit_slots=h_split.hit_slots,
                h_miss_pos=h_split.miss_pos, h_miss_src=h_split.miss_rows,
                h_admit_midx=h_split.admit_midx, h_admit_slots=h_split.admit_slots,
                patch_pos=patch_pos, patch_src=patch_src,
                s_hit_pos=s_split.hit_pos, s_hit_slots=s_split.hit_slots,
                s_miss_pos=s_split.miss_pos, s_miss_src=s_split.miss_rows,
                s_wb_pos=s_wb[0], s_wb_slots=s_wb[1],
                hnext_wb_pos=hn_wb[0], hnext_wb_slots=hn_wb[1]))
            prev_rows = tr.srows
        return ops

    # ------------------------------------------------------------------ #
    def dispatch(self, prep: _OffloadPrep) -> None:
        """Run all layers through the staging pipeline (see
        :mod:`repro_torch.serve.staging` for the schedule).  Pristine
        gathers for every layer enqueue up front — the in-order worker runs
        them after any still-in-flight write-back of the previous batch and
        before this batch's own write-backs, so each layer's staged
        ``h_old`` view is exactly the pre-batch state and the ``h_new`` view
        is the same rows patched with the previous layer's freshly computed
        outputs.  The final layer's grouped write-back (the paper's "group
        all updated embeddings and write them back in parallel") defers
        entirely to the worker, behind the final D2H's event."""
        pipe = self._staging
        if not pipe.async_mode:
            self.flush()  # inline staging jobs read host state directly
        pipe.begin_batch()
        batch = prep.batch

        # layer-0 "previous layer outputs" = the batch's feature updates
        if batch.feat_vertices is not None and batch.feat_vertices.size:
            prev_rows = np.asarray(batch.feat_vertices, np.int64)
            prev_new = np.asarray(batch.feat_values, np.float32)
        else:
            prev_rows = np.zeros(0, np.int64)
            prev_new = np.zeros((0, self.h[0].shape[1]), np.float32)

        ops = prep.cache_ops
        tickets = []
        for l, tr in enumerate(prep.transfers):
            bufs = pipe.buffers(l)
            # the caller takes (and may grow) the pinned buffer; the worker fills it
            buf = bufs.take("layer", tr.layout.total, (), np.uint8) if _staged(tr) else None
            tickets.append(pipe.submit_gather(
                partial(self._gather_layer, l, tr, bufs, buf, None if ops is None else ops[l]),
                tag=l))
        if prev_rows.size:
            # persist the feature update into h[0]; the in-order queue puts
            # it after gather(0)'s pristine read and before the next batch
            pipe.submit_writeback(partial(self._scatter_feats, prev_rows, prev_new),
                                  nbytes=int(prev_new.nbytes), tag="feat")

        # cached path: the previous layer's outputs stay device-resident so
        # the new-view patch happens on device instead of via staged h_new
        prev_dev = None
        if ops is not None and prev_rows.size:
            prev_dev = host_to_device([prev_new], self.device)[0]
        final = None
        for l, tr in enumerate(prep.transfers):
            bufs = pipe.buffers(l)
            staged = pipe.wait_gather(tickets[l])
            if ops is None:
                outs = self._layer_exec(l, tr, staged, prev_rows, prev_new)
            else:
                outs = self._layer_exec_cached(l, tr, staged, ops[l], prev_dev)
                prev_dev = None if outs is None else outs[2]
            copy = None
            if outs is not None:
                copy = pipe.copy_out(outs, bufs)
                bufs.mark_in_flight(copy.event)  # covers the H2D before it too
            # back to the allocator before the next layer: the stream orders
            # any reuse after the D2H just queued
            del outs
            if l + 1 < self.L:
                if copy is None:  # empty layer: nothing written back
                    prev_rows = tr.srows
                    prev_new = np.zeros((0, self.h[l + 1].shape[1]), np.float32)
                else:
                    a_np, nct_np, h_np = pipe.wait_device(copy)
                    pipe.submit_writeback(
                        partial(self._writeback_host, l, tr.srows, a_np, nct_np, h_np),
                        nbytes=copy.nbytes, tag=l)
                    prev_rows, prev_new = tr.srows, h_np
            else:
                final = (l, tr.srows, copy)
        self._defer_final(final)

    def _scatter_feats(self, rows: np.ndarray, vals: np.ndarray) -> None:
        self.h[0][rows] = vals

    def _gather_layer(self, l: int, tr: _LayerTransfer, bufs, buf: Optional[np.ndarray],
                      cops: Optional[_CacheLayerOps] = None):
        """Staging-worker job: copy layer ``l``'s tables into its staging
        buffer ``buf`` (of the set ``bufs``) and gather its compact rows
        pristine (``h_new`` starts as a copy of ``h_old``; the caller patches
        it before the H2D).  With the hot-row cache only the plan's cold
        misses stage and no ``h_new`` view stages at all (the new-view patch
        happens on the device).  Waits first until no queued copy still uses
        the buffer set; numpy only."""
        if buf is None:
            return None
        bufs.wait_free()
        lay = tr.layout
        views = dict(zip(lay.names, carve(buf, lay.specs, lay.offsets)))
        for name, arr in tr.tables.items():
            views[name][...] = arr
        if cops is not None:
            for name in _CacheLayerOps.DEVICE_FIELDS:
                views[name][...] = getattr(cops, name)
            h_src, s_src = cops.h_miss_src, cops.s_miss_src
        else:
            h_src, s_src = tr.need_h, tr.srows
        staged = {"_buf": buf}
        for name, src, rows in (("h_old", self.h[l], h_src), ("a", self.a[l], s_src),
                                ("nct", self.nct[l], s_src), ("h_cur", self.h[l + 1], s_src)):
            view = views[name]
            staged[name] = np.take(src, rows, axis=0, out=view[:rows.shape[0]])
            view[rows.shape[0]:] = 0  # the scratch row (uncached blocks)
        if cops is None:
            np.copyto(views["h_new"], views["h_old"])
            staged["h_new"] = views["h_new"][:h_src.shape[0]]
        return staged

    def _put(self, tr: _LayerTransfer, staged) -> dict:
        """The layer's one host→device copy (``non_blocking`` from the
        pinned staging buffer on a card); returns the device views by
        name.  On the CPU the views alias the staging buffer."""
        lay = tr.layout
        buf = torch.from_numpy(staged["_buf"])
        if self.device.type == "cuda":
            buf = buf.to(self.device, non_blocking=True)
        return dict(zip(lay.names, carve(buf, lay.specs, lay.offsets)))

    def _layer_exec(self, l: int, tr: _LayerTransfer, staged,
                    prev_rows: np.ndarray, prev_new: np.ndarray):
        """Patch the staged new-view rows with the previous layer's fresh
        outputs, ship the layer in one copy, run the layer in place on the
        shipped blocks; returns views of its ``a``/``nct``/``h_cur`` rows."""
        if staged is None:
            return None
        nh, ns = tr.need_h.shape[0], tr.srows.shape[0]
        h_new_rows = staged["h_new"]
        _override_rows(h_new_rows, tr.need_h, prev_rows, prev_new)
        self.transfers.rows_up += 2 * nh + 3 * ns
        self.transfers.bytes_up += (2 * h_new_rows.nbytes + staged["a"].nbytes
                                    + staged["nct"].nbytes + staged["h_cur"].nbytes)
        dev = self._put(tr, staged)
        incremental_layer_inplace(
            self.model, self.params[l], dev["h_old"], dev["h_new"], dev["deg_old"],
            dev["deg_new"], dev["a"], dev["nct"], dev["h_cur"],
            {name: dev[name] for name in tr.tables})
        return dev["a"][:ns], dev["nct"][:ns], dev["h_cur"][:ns]

    def _layer_exec_cached(self, l: int, tr: _LayerTransfer, staged,
                           cops: _CacheLayerOps, prev_dev: Optional[torch.Tensor]):
        """Cached variant of :meth:`_layer_exec`: assemble the device
        workspaces from staged cold misses + cached hot slots, patch the new
        view on device from the previous layer's still-resident outputs, run
        the identical layer, then refresh written slots in place from its
        outputs (bitwise-equal to the uncached path — hits/misses partition
        the rows, and the float32 round trip the uncached patch takes is
        value-preserving).  Every store is read before this layer writes
        it."""
        if staged is None:
            return None
        cache = self._cache
        nh, ns = tr.need_h.shape[0], tr.srows.shape[0]
        self.transfers.rows_up += staged["h_old"].shape[0] + 3 * staged["a"].shape[0]
        self.transfers.bytes_up += (staged["h_old"].nbytes + staged["a"].nbytes
                                    + staged["nct"].nbytes + staged["h_cur"].nbytes)
        dev = self._put(tr, staged)
        d_in = self.h[l].shape[1]

        def hits(key, name, width):
            """The hit rows of one store (read before any write to it)."""
            if not (cops.h_hit_pos if key[0] == "h" else cops.s_hit_pos).size:
                return None
            return cache.store(key, name, (width,))[dev[f"{key[0]}_hit_slots"]]

        h_old_d = _cache_assemble(nh, d_in, self.device, dev["h_miss_pos"], dev["h_old"],
                                  dev["h_hit_pos"], hits(("h", l), "h", d_in))
        # install freshly admitted rows from the staged pristine values
        if cops.h_admit_midx.size:
            cache.update_store(("h", l), "h", dev["h_admit_slots"],
                               dev["h_old"][dev["h_admit_midx"]])
        if cops.patch_pos.size:
            h_new_d = h_old_d.index_put((dev["patch_pos"],), prev_dev[dev["patch_src"]])
        else:
            h_new_d = h_old_d

        s_key = ("s", l)
        state = {}
        for name, width in (("a", self.a[l].shape[1]), ("nct", self.nct[l].shape[1]),
                            ("h", self.h[l + 1].shape[1])):
            state[name] = _cache_assemble(ns, width, self.device, dev["s_miss_pos"],
                                          dev["h_cur" if name == "h" else name],
                                          dev["s_hit_pos"], hits(s_key, name, width))
        incremental_layer_inplace(
            self.model, self.params[l], h_old_d, h_new_d, dev["deg_old"], dev["deg_new"],
            state["a"], state["nct"], state["h"], {name: dev[name] for name in tr.tables})
        outs = (state["a"][:ns], state["nct"][:ns], state["h"][:ns])
        # in-place slot refresh from the outputs: hot written rows skip the
        # D2H→host→H2D re-staging round trip on the next batch
        if cops.s_wb_pos.size:
            for name, o in zip(("a", "nct", "h"), outs):
                cache.update_store(s_key, name, dev["s_wb_slots"], o[dev["s_wb_pos"]])
        if cops.hnext_wb_pos.size:
            cache.update_store(("h", l + 1), "h", dev["hnext_wb_slots"],
                               outs[2][dev["hnext_wb_pos"]])
        return outs

    def _writeback_host(self, l: int, srows: np.ndarray, a_new: np.ndarray,
                        nct_new: np.ndarray, h_new: np.ndarray) -> None:
        """Grouped host scatter of one layer's written-back rows (runs on
        the staging worker in async mode)."""
        self.a[l][srows] = a_new
        self.nct[l][srows] = nct_new
        self.h[l + 1][srows] = h_new
        self.transfers.rows_down += 3 * srows.shape[0]
        self.transfers.bytes_down += int(a_new.nbytes + nct_new.nbytes + h_new.nbytes)

    def _final_writeback(self, payload) -> None:
        """Final layer's scatter, once its D2H has landed — runs on the
        staging worker (async) or at ``flush`` (sync escape hatch).  It
        waits on the copy's event and touches no tensor."""
        if payload is None:
            return
        l, srows, copy = payload
        if copy is None:
            return
        a_new, nct_new, h_new = copy.wait()
        self._writeback_host(l, srows, a_new, nct_new, h_new)


def _staged(tr: _LayerTransfer) -> bool:
    """Whether a layer has any row to stage (else it runs nothing)."""
    return tr.need_h.shape[0] > 0 or tr.srows.shape[0] > 0


def _compact_tables(plan: BatchPlan, lp, need_h: np.ndarray, srows: np.ndarray,
                    n: int) -> dict:
    """One layer's index tables in compact space, by the field names
    :func:`~repro_torch.core.incremental.incremental_layer` reads.  Vertex
    ids are remapped (gather space ``need_h``, state space ``srows``);
    ``e_rowidx``/``f_rowidx`` are not, so the row schedules — built from the
    same keys ``pack_plan`` uses — sum each row's records in the device
    backend's order."""
    nh, ns = need_h.shape[0], srows.shape[0]
    e_order, e_row_ptr = prepare_row_schedule(np.where(lp.e_mask, lp.e_rowidx, -1),
                                              lp.touch_rows.shape[0])
    f_order, f_row_ptr = prepare_row_schedule(np.where(lp.f_emask, lp.f_rowidx, -1),
                                              lp.f_rows.shape[0])
    return {
        "deg_old": np.concatenate([plan.deg_old[need_h], [0.0]]).astype(np.float32),
        "deg_new": np.concatenate([plan.deg_new[need_h], [0.0]]).astype(np.float32),
        "e_src": remap_compact(lp.e_src, need_h, nh, n),
        "e_dst": remap_compact(lp.e_dst, need_h, nh, n),
        "e_rowidx": lp.e_rowidx, "e_sign": lp.e_sign, "e_use_new": lp.e_use_new,
        "e_w": lp.e_w, "e_t": lp.e_t, "e_mask": lp.e_mask,
        "touch_rows": remap_compact(lp.touch_rows, srows, ns, n), "touch_mask": lp.touch_mask,
        "f_rows": remap_compact(lp.f_rows, srows, ns, n), "f_mask": lp.f_mask,
        "f_src": remap_compact(lp.f_src, need_h, nh, n), "f_rowidx": lp.f_rowidx,
        "f_w": lp.f_w, "f_t": lp.f_t, "f_emask": lp.f_emask,
        "out_rows": remap_compact(lp.out_rows, srows, ns, n), "out_mask": lp.out_mask,
        "f_rows_h": remap_compact(lp.f_rows, need_h, nh, n),
        "out_rows_h": remap_compact(lp.out_rows, need_h, nh, n),
        "e_order": e_order, "e_row_ptr": e_row_ptr,
        "f_order": f_order, "f_row_ptr": f_row_ptr,
    }


# ====================================================================== #
# ChunkedBackend — host-resident state, chunked full-recompute execution
# ====================================================================== #
@dataclasses.dataclass
class _ChunkedPrep:
    """Prepared plan for the chunked substrate: the Alg.-4 affected sets
    plus the post-batch graph (the chunk scheduler re-reads CSR edges at
    execution time instead of baking transfer tables at plan time)."""

    plan: BatchPlan
    batch: UpdateBatch
    g_new: CSRGraph
    rows_per_layer: List[np.ndarray]  # live out_rows per layer (global ids)

    @property
    def n_inc_edges(self) -> int:
        return self.plan.total_inc_edges()

    @property
    def n_full_edges(self) -> int:
        return self.plan.total_full_edges()

    @property
    def n_out_rows(self) -> int:
        return self.plan.total_vertices()


class ChunkedBackend(_HostResidentBackend):
    """Host-resident state executed through the §V-C chunked scheduler.

    The per-layer state lives as host numpy (like :class:`OffloadBackend`)
    but each batch executes by *constrained re-computation*: per layer, the
    planner's live ``out_rows`` (every row whose a/nct/h may change) are
    recomputed from the post-batch graph through
    :class:`repro_torch.serve.scheduler.ChunkedLayerScheduler` on the
    backend's device — destination-vertex chunks with inter-chunk
    shard-embedding reuse, each chunk's sums through ``segment_spmm``, so
    device residency is bounded by ``chunk_size`` however large a batch's
    affected subgraph grows.  Output matches the incremental substrates to
    numerical tolerance (recompute vs. signed incremental accumulation),
    not bitwise.

    Serving API: state is plain host numpy with no deferred write-back, so
    ``snapshot_rows`` is a direct gather and ``changed_rows`` is the final
    layer's planned recompute set."""

    def __init__(self, model: GNNModel, params: Sequence[Params], graph: CSRGraph,
                 x: np.ndarray, device="cuda", chunk_size: int = 8192,
                 chunk_reuse: bool = True):
        # deferred import: repro_torch.serve.scheduler pulls repro_torch.core.full
        # while this module may itself be mid-import under repro_torch.core
        from repro_torch.serve.scheduler import ChunkedLayerScheduler

        self.scheduler = ChunkedLayerScheduler(model, chunk_size=chunk_size,
                                               reuse=chunk_reuse, device=torch.device(device))
        super().__init__(model, params, graph, x, device)

    def changed_rows(self, prep: _ChunkedPrep) -> np.ndarray:
        return prep.rows_per_layer[-1]

    # ------------------------------------------------------------------ #
    # policy-execution primitives: this substrate's native dispatch *is*
    # the chunked mode — the policy path shares its scheduler (and its
    # reuse/transfer counters), so policy-chosen chunked batches are
    # bitwise-identical to native ones
    # ------------------------------------------------------------------ #
    def chunk_scheduler(self):
        return self.scheduler

    # ------------------------------------------------------------------ #
    def plan(self, g_old: CSRGraph, g_new: CSRGraph, batch: UpdateBatch,
             base_plan: Optional[BatchPlan] = None) -> _ChunkedPrep:
        plan = (base_plan if base_plan is not None
                else build_plan(self.model, g_old, g_new, batch, self.L))
        rows = [np.unique(lp.out_rows[lp.out_mask].astype(np.int64)) for lp in plan.layers]
        return _ChunkedPrep(plan=plan, batch=batch, g_new=g_new, rows_per_layer=rows)

    def dispatch(self, prep: _ChunkedPrep) -> None:
        """Layer-by-layer chunked recompute of the affected rows.  Layer
        ``l`` reads ``h[l]`` *after* the previous layer's write-back (and
        the batch's feature scatter for layer 0), so the recompute sees
        exactly the incremental substrates' layer inputs."""
        batch = prep.batch
        if batch.feat_vertices is not None and batch.feat_vertices.size:
            self.apply_feature_updates(batch.feat_vertices, batch.feat_values)
        deg = prep.plan.deg_new[:-1]  # [n] new-graph degrees (drop scratch)
        for l in range(self.L):
            rows = prep.rows_per_layer[l]
            if not rows.size:
                continue
            a_r, nct_r, h_r = self.scheduler.run_layer(self.params[l], prep.g_new,
                                                       self.h[l], rows, deg)
            self.scatter_layer_rows(l, rows, a_r, nct_r, h_r)


# ====================================================================== #
# Row-sharded substrates: S shards own contiguous row blocks
# ====================================================================== #
class _ShardedMixin:
    """Shard setup shared by the two row-sharded backends: the shard count
    ``S``, the block size ``rows_per``, the resolved halo mode, and the
    plan-derived halo counters (:class:`CommsStats`)."""

    def _init_shards(self, graph: CSRGraph, num_shards: Optional[int], comms,
                     exchange=None) -> None:
        self.n = graph.n
        self.S = stream_shards(num_shards, exchange)
        self.rows_per = shard_rows(graph.n, self.S)
        self.comms = comms if comms is not None else CommsConfig()
        # resolved once: the mode must not flip batch to batch
        self.halo_mode = self.comms.resolve_halo(self.S)
        self.hwm = BucketHysteresis()
        self._comms_rows_sent = 0
        self._comms_bytes = 0

    def comms_snapshot(self) -> CommsStats:
        return CommsStats(halo_rows_sent=self._comms_rows_sent, halo_bytes=self._comms_bytes)


class ShardBackend(_ShardedMixin, StateBackend):
    """Scratch-extended per-layer state row-partitioned over ``S`` shards as
    stacked ``[S, rows_per + 1, ·]`` device tensors (the last row of each
    block is that shard's scratch row).  Each batch's plan is partitioned
    per shard at plan time (:func:`~repro_torch.core.affected.shard_plan`)
    and runs as one L-layer step (:func:`~repro_torch.core.incremental.sharded_step`):
    per layer and shard one ``delta_agg`` launch over the shard's own row
    schedule; init and refresh run ``full_forward`` (``segment_spmm``).

    The halo moves through a :class:`~repro_torch.dist.exchange.HaloExchange`
    under :class:`~repro_torch.dist.sharding.CommsConfig`: ``"psum"``
    broadcasts the global frontier, ``"ppermute"`` (the ``"auto"`` choice
    for S > 1) runs the per-consumer rotation rounds; both are bitwise
    equal.  With the default :class:`~repro_torch.dist.exchange.LoopbackExchange`
    all S shards live in this process on one device; with a
    :class:`~repro_torch.dist.exchange.DistExchange` this process holds
    its rank's block only, and the state views gather every block."""

    store_h = True
    fused = True

    def __init__(self, model: GNNModel, params: Sequence[Params], graph: CSRGraph,
                 x: torch.Tensor, num_shards: Optional[int] = None, comms=None,
                 exchange=None):
        self.model = model
        self.params = list(params)
        self.L = len(self.params)
        self.device = x.device
        self._init_shards(graph, num_shards, comms, exchange)
        self.exchange = exchange if exchange is not None else LoopbackExchange(self.S)
        self._local = np.asarray(self.exchange.local_shards, np.int64)
        self.halo_rows_total = 0
        self._init_state(graph, x)

    # ------------------------------------------------------------------ #
    # state: this process's [S_loc, rows_per+1, ·] blocks (last row scratch)
    # ------------------------------------------------------------------ #
    def _to_blocks(self, t: torch.Tensor) -> torch.Tensor:
        out = t.new_zeros((len(self._local), self.rows_per + 1) + tuple(t.shape[1:]))
        for i, s in enumerate(self._local):
            lo = int(s) * self.rows_per
            hi = min(self.n, lo + self.rows_per)
            if hi > lo:
                out[i, : hi - lo] = t[lo:hi]
        return out

    def _from_blocks(self, blocks: torch.Tensor) -> torch.Tensor:
        full = self.exchange.all_gather(blocks)[:, : self.rows_per]
        return full.reshape((self.S * self.rows_per,) + tuple(full.shape[2:]))[: self.n]

    def _init_state(self, graph: CSRGraph, x: torch.Tensor) -> None:
        states = full_forward(self.model, self.params, x, graph)
        self._h: List[torch.Tensor] = [self._to_blocks(x)] + [self._to_blocks(s.h)
                                                             for s in states]
        self._a: List[torch.Tensor] = [self._to_blocks(s.a) for s in states]
        self._nct: List[torch.Tensor] = [self._to_blocks(s.nct) for s in states]

    def refresh(self, graph: CSRGraph) -> None:
        """Full recomputation over ``graph`` and the *current* features (the
        feature updates of the stream live in the h[0] blocks)."""
        self._init_state(graph, self.x)

    @property
    def x(self) -> torch.Tensor:
        return self._from_blocks(self._h[0])

    @property
    def h(self) -> List[torch.Tensor]:
        return [self._from_blocks(v) for v in self._h]

    @property
    def a(self) -> List[torch.Tensor]:
        return [self._from_blocks(v) for v in self._a]

    @property
    def nct(self) -> List[torch.Tensor]:
        return [self._from_blocks(v) for v in self._nct]

    @property
    def embeddings(self) -> torch.Tensor:
        return self._from_blocks(self._h[-1])

    def state_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in (*self._h, *self._a, *self._nct))

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # serving API: one gather over the blocks — row g lives at block
    # [g // rows_per, g % rows_per] (the scratch row is never read)
    # ------------------------------------------------------------------ #
    def _block_index(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(shard, row within the shard's block) of global rows."""
        r = np.asarray(rows, np.int64)
        return r // self.rows_per, r % self.rows_per

    def snapshot_rows(self, rows: np.ndarray) -> np.ndarray:
        shard, local = (torch.from_numpy(v).to(self.device) for v in self._block_index(rows))
        return self.exchange.all_gather(self._h[-1])[shard, local].cpu().numpy()

    def changed_rows(self, prep: ShardedPlan) -> np.ndarray:
        return prep.out_rows_final

    # ------------------------------------------------------------------ #
    # policy-execution primitives: in-place row writes into this process's
    # blocks (rows owned elsewhere belong to another rank's writes)
    # ------------------------------------------------------------------ #
    def _scatter(self, blocks: torch.Tensor, rows: np.ndarray, vals: np.ndarray) -> None:
        shard, local = self._block_index(rows)
        slot = np.full(self.S, -1, np.int64)  # shard → its block here, -1: another rank's
        slot[self._local] = np.arange(len(self._local))
        i = slot[shard]
        mine = i >= 0
        idx, vals_d = host_to_device(
            (np.stack([i[mine], local[mine]]), np.asarray(vals, np.float32)[mine]), self.device)
        blocks[idx[0], idx[1]] = vals_d

    def apply_feature_updates(self, rows: np.ndarray, vals: np.ndarray) -> None:
        self._scatter(self._h[0], rows, vals)

    def layer_input_host(self, l: int) -> np.ndarray:
        return self._from_blocks(self._h[l]).to("cpu", copy=True).numpy()

    def scatter_layer_rows(self, l: int, rows: np.ndarray, a_rows: np.ndarray,
                           nct_rows: np.ndarray, h_rows: np.ndarray) -> None:
        self._scatter(self._a[l], rows, a_rows)
        self._scatter(self._nct[l], rows, nct_rows)
        self._scatter(self._h[l + 1], rows, h_rows)

    # ------------------------------------------------------------------ #
    def plan(self, g_old: CSRGraph, g_new: CSRGraph, batch: UpdateBatch,
             base_plan: Optional[BatchPlan] = None) -> ShardedPlan:
        plan = (base_plan if base_plan is not None
                else build_plan(self.model, g_old, g_new, batch, self.L))
        return shard_plan(plan, self.S, batch.feat_vertices, batch.feat_values, hwm=self.hwm,
                          halo_mode=self.halo_mode,
                          pair_hysteresis=self.comms.pair_capacity_hysteresis)

    def dispatch(self, sp: ShardedPlan) -> None:
        """One host→device copy of this process's plan rows (and the
        replicated tables), then the step."""
        loc = self._local
        d0 = self._h[0].shape[2]
        fv = sp.feat_vals if sp.feat_vals is not None else np.zeros((0, d0), np.float32)
        arrays = [sp.idx_sh[loc], sp.flt_sh[loc], sp.msk_sh[loc], sp.sched_sh[loc],
                  sp.idx_rep, sp.msk_rep, fv]
        for send, recv in sp.comms_sh or ():
            arrays += [send[loc], recv[loc]]
        dev = host_to_device(arrays, self.device)
        idx, flt, msk, sched, idx_rep, msk_rep, feat_vals = dev[:7]
        comms = [(dev[7 + 2 * l], dev[8 + 2 * l]) for l in range(len(sp.comms_sh or ()))]
        # plan-derived halo traffic: each delivered row carries its old and
        # new previous-layer views
        for l, rows_l in enumerate(sp.comms_rows or ()):
            self._comms_rows_sent += rows_l
            self._comms_bytes += rows_l * 2 * int(self._h[l].shape[-1]) * 4
        self._h = sharded_step(self.model, sp.layout, self.params, self._h, self._a, self._nct,
                               idx, flt, msk, sched, idx_rep, msk_rep,
                               feat_vals if sp.layout.feat_cap else None, comms or None,
                               self.exchange)
        self.halo_rows_total += sp.n_halo_rows


@dataclasses.dataclass
class _HybridPrep:
    """Host-side output of hybrid planning for one batch: the per-shard
    compact tables, the cache schedule, and each layer's staging tables and
    byte layout."""

    plan: BatchPlan
    batch: UpdateBatch
    layers: List[HybridLayerPlan]
    tables: List[dict]  # per layer: name → host array shipped with the layer
    layouts: List["_StagedLayout"]
    cache_ops: Optional[List[_CacheLayerOps]] = None

    @property
    def n_inc_edges(self) -> int:
        return self.plan.total_inc_edges()

    @property
    def n_full_edges(self) -> int:
        return self.plan.total_full_edges()

    @property
    def n_out_rows(self) -> int:
        return self.plan.total_vertices()


def _scratch_pos(pos: np.ndarray, cap: int) -> np.ndarray:
    """Flat positions in ``[S·cap]`` → the same slots in ``[S·(cap+1)]``,
    where each shard's compact block carries its scratch row at ``cap``."""
    pos = np.asarray(pos, np.int64)
    return pos + pos // cap


class ShardedOffloadBackend(_ShardedMixin, _DeferredWritebackMixin, StateBackend):
    """Row sharding × host-resident state: every shard keeps **only its own
    row block** of the per-layer state in host memory (stacked ``[S,
    rows_per, ·]`` numpy).  Per batch and layer the plan is partitioned by
    destination-row owner (:func:`~repro_torch.core.affected.hybrid_plan`;
    scatters stay owner-local) and each shard stages a compact ``[halo |
    local]`` workspace: the rows it needs but does not own are gathered from
    the other shards' *host* blocks — the host is the exchange medium, so no
    device collective runs.  Device residency is O(per-shard affected
    subgraph), never O(V).

    Staging is :class:`OffloadBackend`'s: a
    :class:`~repro_torch.serve.staging.HostStagingPipeline` gathers each
    layer's tables and every shard's blocks (each with its zeroed scratch
    row) into one pinned buffer, shipped in one host→device copy; each
    shard then runs :func:`~repro_torch.core.incremental.incremental_layer_inplace`
    on its blocks (:func:`~repro_torch.core.incremental.hybrid_layer_step`:
    ``delta_agg`` per shard, a constrained model's ``segment_spmm`` too),
    and the write-back scatters into the host blocks retire on the worker.
    Under ``halo="ppermute"`` the new view is patched on the device from
    the previous layer's still-resident outputs (``patch_pos`` /
    ``patch_src``) instead of a staged ``h_new`` copy; bitwise the same.
    The device hot-row cache works as on :class:`OffloadBackend`, its
    positions in the flat ``[S·(cap+1)]`` workspaces."""

    store_h = True
    fused = False

    def __init__(self, model: GNNModel, params: Sequence[Params], graph: CSRGraph,
                 x: np.ndarray, device="cuda", num_shards: Optional[int] = None, comms=None,
                 async_staging: bool = True, cache: Optional["HotRowCache"] = None):
        self.model = model
        self.params = list(params)
        self.L = len(self.params)
        self.device = torch.device(device)
        self._init_shards(graph, num_shards, comms)
        self.transfers = TransferStats()
        self._cache = cache
        self._staging = HostStagingPipeline(self.L, async_mode=async_staging, name="hybrid",
                                            pinned=self.device.type == "cuda")
        # the caller (rows up) and the staging worker (rows down) both count
        self._acc_lock = threading.Lock()
        # per-shard H2D+D2H row volume: each shard's traffic is bounded by
        # its own affected subgraph
        self.per_shard_rows = np.zeros(self.S, np.int64)
        # largest one-layer device footprint (the state stays on the host)
        self.peak_device_bytes = 0
        self._init_state(graph, np.asarray(x, np.float32))
        self._prewarm_cache(graph)

    # ------------------------------------------------------------------ #
    # state: host-resident per-shard row blocks [S, rows_per, ·]
    # ------------------------------------------------------------------ #
    def _to_blocks(self, arr: np.ndarray) -> np.ndarray:
        flat = np.asarray(arr, np.float32)
        out = np.zeros((self.S, self.rows_per) + flat.shape[1:], np.float32)
        out.reshape((self.S * self.rows_per,) + flat.shape[1:])[: self.n] = flat
        return out

    def _from_blocks(self, blocks: np.ndarray) -> np.ndarray:
        return blocks.reshape((self.S * self.rows_per,) + blocks.shape[2:])[: self.n]

    def _flat(self, blocks: np.ndarray) -> np.ndarray:
        """The blocks as one ``[S·rows_per, ·]`` view: block-contiguous
        ownership makes the flat index the global row id."""
        return blocks.reshape((self.S * self.rows_per,) + blocks.shape[2:])

    def _gather_state_rows(self, arr: np.ndarray, rows: np.ndarray) -> np.ndarray:
        return self._flat(arr)[np.asarray(rows, np.int64)]

    def _scatter_rows(self, blocks: np.ndarray, rows: np.ndarray, vals: np.ndarray) -> None:
        self._flat(blocks)[np.asarray(rows, np.int64)] = vals

    def _init_state(self, graph: CSRGraph, x: Optional[np.ndarray] = None) -> None:
        if x is None:
            x = self._from_blocks(self.h[0]).copy()
        states = full_forward(self.model, self.params, torch.from_numpy(x).to(self.device),
                              graph)

        def blocks(t: torch.Tensor) -> np.ndarray:
            return self._to_blocks(t.cpu().numpy())

        self.h: List[np.ndarray] = [self._to_blocks(x)] + [blocks(s.h) for s in states]
        self.a: List[np.ndarray] = [blocks(s.a) for s in states]
        self.nct: List[np.ndarray] = [blocks(s.nct) for s in states]

    def refresh(self, graph: CSRGraph) -> None:
        self.flush()
        self._init_state(graph)
        if self._cache is not None:  # every cached row may now be stale
            self._cache.invalidate_all()

    @property
    def embeddings(self) -> np.ndarray:
        self.flush()
        return self._from_blocks(self.h[-1])

    def state_bytes(self) -> int:
        return sum(v.nbytes for v in (*self.h, *self.a, *self.nct))

    def synchronize(self) -> None:
        self.flush()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # serving API: flush first (a no-op at a version boundary), then gather
    # from the per-shard host blocks
    # ------------------------------------------------------------------ #
    def snapshot_rows(self, rows: np.ndarray) -> np.ndarray:
        self.flush()
        return self._gather_state_rows(self.h[-1], rows)

    def changed_rows(self, prep: _HybridPrep) -> np.ndarray:
        tr = prep.layers[-1]
        return np.unique(tr.srows[tr.srows_mask].astype(np.int64))

    # ------------------------------------------------------------------ #
    # policy-execution primitives (the orchestrator flushes first)
    # ------------------------------------------------------------------ #
    def apply_feature_updates(self, rows: np.ndarray, vals: np.ndarray) -> None:
        rows = np.asarray(rows, np.int64)
        self._scatter_rows(self.h[0], rows, np.asarray(vals, np.float32))
        if self._cache is not None:
            self._cache.invalidate(("h", 0), rows)

    def layer_input_host(self, l: int) -> np.ndarray:
        return self._from_blocks(self.h[l])

    def scatter_layer_rows(self, l: int, rows: np.ndarray, a_rows: np.ndarray,
                           nct_rows: np.ndarray, h_rows: np.ndarray) -> None:
        r = np.asarray(rows, np.int64)
        self._scatter_rows(self.a[l], r, a_rows)
        self._scatter_rows(self.nct[l], r, nct_rows)
        self._scatter_rows(self.h[l + 1], r, h_rows)
        if self._cache is not None:  # keyed by rows only: value-independent
            self._cache.invalidate(("s", l), r)
            self._cache.invalidate(("h", l + 1), r)

    # ------------------------------------------------------------------ #
    # planning phase (host only, value-independent)
    # ------------------------------------------------------------------ #
    def plan(self, g_old: CSRGraph, g_new: CSRGraph, batch: UpdateBatch,
             base_plan: Optional[BatchPlan] = None) -> _HybridPrep:
        plan = (base_plan if base_plan is not None
                else build_plan(self.model, g_old, g_new, batch, self.L))
        hp = hybrid_plan(plan, self.S, hwm=self.hwm, feat_vertices=batch.feat_vertices,
                         halo_mode=self.halo_mode)
        cache_ops = (self._plan_cache(plan, batch, hp.layers)
                     if self._cache is not None else None)
        tables_all, layouts = [], []
        prev_ns = None
        for l, tr in enumerate(hp.layers):
            tables = {"idx": tr.idx_sh, "flt": tr.flt_sh, "msk": tr.msk_sh,
                      "sched": tr.sched_sh}
            cops = None if cache_ops is None else cache_ops[l]
            if cops is not None:
                tables.update({f: getattr(cops, f) for f in _CacheLayerOps.DEVICE_FIELDS})
            elif self.halo_mode != "psum" and tr.patch_pos is not None:
                src = tr.patch_src if l == 0 else _scratch_pos(tr.patch_src, prev_ns)
                tables["patch_pos"] = _scratch_pos(tr.patch_pos, tr.nh_cap)
                tables["patch_src"] = src
            tables_all.append(tables)
            layouts.append(self._layout(l, tr, tables, cops))
            prev_ns = tr.ns_cap
        return _HybridPrep(plan=plan, batch=batch, layers=hp.layers, tables=tables_all,
                           layouts=layouts, cache_ops=cache_ops)

    def _layout(self, l: int, tr: HybridLayerPlan, tables: dict,
                cops: Optional[_CacheLayerOps]) -> _StagedLayout:
        """The layer's staging byte layout: its tables, then the float row
        blocks — every shard's ``cap + 1`` rows (scratch last) uncached, the
        cold misses only with the cache."""
        d_in, da = self.h[l].shape[2], self.a[l].shape[2]
        dc, d_out = self.nct[l].shape[2], self.h[l + 1].shape[2]
        if cops is None:
            nh, ns = self.S * (tr.nh_cap + 1), self.S * (tr.ns_cap + 1)
            blocks = [("h_old", nh, d_in)]
            if self.halo_mode == "psum":
                blocks.append(("h_new", nh, d_in))
        else:
            nh, ns = cops.h_miss_src.shape[0], cops.s_miss_src.shape[0]
            blocks = [("h_old", nh, d_in)]
        blocks += [("a", ns, da), ("nct", ns, dc), ("h_cur", ns, d_out)]
        return _StagedLayout.build(tables, blocks)

    def _plan_cache(self, plan: BatchPlan, batch: UpdateBatch,
                    layers: List[HybridLayerPlan]) -> List[_CacheLayerOps]:
        """Plan-time residency split over the stacked per-shard workspaces.
        Cache keys are global row ids (a hot halo row is cached once and
        served to every shard that stages it); positions are flat indices
        into the ``[S·(cap+1)]`` workspaces."""
        cache = self._cache
        n = plan.deg_old.shape[0] - 1  # deg tables carry a scratch slot
        deg = plan.deg_new
        cache.decay_tick()
        prev_rows = self._cache_invalidate_feats(batch)
        prev_live_pos: Optional[np.ndarray] = None
        ops: List[_CacheLayerOps] = []
        for l, tr in enumerate(layers):
            live_pos_h = np.flatnonzero(tr.need_mask.reshape(-1)).astype(np.int64)
            rows_h = tr.need_h.reshape(-1)[live_pos_h].astype(np.int64)
            live_pos_s = np.flatnonzero(tr.srows_mask.reshape(-1)).astype(np.int64)
            rows_s = tr.srows.reshape(-1)[live_pos_s].astype(np.int64)
            h_split, s_split, s_wb, hn_wb = self._cache_layer_ops(
                l, n, rows_h, rows_s, prev_rows, deg)
            dst_keys = np.where(tr.need_mask, tr.need_h, -1).reshape(-1)
            patch_pos, patch_src = _patch_positions(dst_keys, prev_rows)
            if l > 0:  # compose: index into the previous live srows → its slot
                patch_src = prev_live_pos[patch_src]
            hpos = partial(_scratch_pos, cap=tr.nh_cap)
            spos = partial(_scratch_pos, cap=tr.ns_cap)
            ops.append(_CacheLayerOps(
                h_hit_pos=hpos(live_pos_h[h_split.hit_pos]), h_hit_slots=h_split.hit_slots,
                h_miss_pos=hpos(live_pos_h[h_split.miss_pos]), h_miss_src=h_split.miss_rows,
                h_admit_midx=h_split.admit_midx, h_admit_slots=h_split.admit_slots,
                patch_pos=hpos(patch_pos), patch_src=patch_src,
                s_hit_pos=spos(live_pos_s[s_split.hit_pos]), s_hit_slots=s_split.hit_slots,
                s_miss_pos=spos(live_pos_s[s_split.miss_pos]), s_miss_src=s_split.miss_rows,
                s_wb_pos=spos(live_pos_s[s_wb[0]]), s_wb_slots=s_wb[1],
                hnext_wb_pos=spos(live_pos_s[hn_wb[0]]), hnext_wb_slots=hn_wb[1]))
            prev_rows, prev_live_pos = rows_s, spos(live_pos_s)
        return ops

    # ------------------------------------------------------------------ #
    def dispatch(self, prep: _HybridPrep) -> None:
        """:meth:`OffloadBackend.dispatch`'s staging schedule over per-shard
        stacked blocks: pristine gathers for every layer enqueue up front,
        each layer's new view is patched with the previous layer's fresh
        outputs, and the write-back scatters into the host blocks (the
        exchange medium between layers) retire on the worker while the
        device computes the next layer."""
        pipe = self._staging
        if not pipe.async_mode:
            self.flush()  # inline staging jobs read host state directly
        pipe.begin_batch()
        batch = prep.batch
        if batch.feat_vertices is not None and batch.feat_vertices.size:
            prev_rows = np.asarray(batch.feat_vertices, np.int64)
            prev_new = np.asarray(batch.feat_values, np.float32)
        else:
            prev_rows = np.zeros(0, np.int64)
            prev_new = np.zeros((0, self.h[0].shape[2]), np.float32)

        ops = prep.cache_ops
        tickets = []
        for l, tr in enumerate(prep.layers):
            bufs = pipe.buffers(l)
            buf = bufs.take("layer", prep.layouts[l].total, (), np.uint8)
            tickets.append(pipe.submit_gather(
                partial(self._gather_layer, l, tr, prep.tables[l], prep.layouts[l], bufs, buf,
                        None if ops is None else ops[l]), tag=l))
        if prev_rows.size:
            pipe.submit_writeback(partial(self._scatter_rows, self.h[0], prev_rows, prev_new),
                                  nbytes=int(prev_new.nbytes), tag="feat")

        # plan-derived halo traffic: every live need row with a remote owner
        # crosses the exchange medium once (psum twice: the staged h_new
        # copy ships the same remote rows again)
        copies = 1 if self.halo_mode == "ppermute" else 2
        for l, tr in enumerate(prep.layers):
            self._comms_rows_sent += tr.n_halo_remote * copies
            self._comms_bytes += tr.n_halo_remote * int(self.h[l].shape[2]) * 4 * copies

        # device-served and cached paths patch the new view on the device
        # from the previous layer's still-resident outputs
        device_patch = ops is not None or self.halo_mode != "psum"
        prev_dev = None
        if device_patch and prev_rows.size:
            prev_dev = host_to_device([prev_new], self.device)[0]
        final = None
        for l, tr in enumerate(prep.layers):
            bufs = pipe.buffers(l)
            staged = pipe.wait_gather(tickets[l])
            if ops is None:
                outs = self._layer_exec(l, tr, prep.layouts[l], staged, prev_rows, prev_new,
                                        prev_dev)
            else:
                outs = self._layer_exec_cached(l, tr, prep.layouts[l], staged, ops[l], prev_dev)
            if device_patch:
                prev_dev = outs[2].reshape(-1, outs[2].shape[2])
            copy = pipe.copy_out(tuple(o[:, : tr.ns_cap] for o in outs), bufs)
            bufs.mark_in_flight(copy.event)  # covers the H2D before it too
            del outs
            srows_flat = tr.srows[tr.srows_mask]
            if l + 1 < self.L:
                a_np, nct_np, h_np = pipe.wait_device(copy)
                pipe.submit_writeback(
                    partial(self._writeback_host, l, tr, srows_flat, a_np, nct_np, h_np),
                    nbytes=copy.nbytes, tag=l)
                prev_rows, prev_new = srows_flat, h_np[tr.srows_mask]
            else:
                final = (l, tr, srows_flat, copy)
        self._defer_final(final)

    def _gather_layer(self, l: int, tr: HybridLayerPlan, tables: dict, lay: _StagedLayout,
                      bufs, buf: np.ndarray, cops: Optional[_CacheLayerOps] = None):
        """Staging-worker job: copy layer ``l``'s tables into its staging
        buffer and gather every shard's compact rows pristine out of the
        per-shard host blocks (one fancy index each: the flat view's index
        is the global row id).  Dead slots and scratch rows are zeroed.
        Uncached psum mode stages an ``h_new`` copy the caller patches; it
        is keyed ``"_h_new"`` so ``staged_bytes`` counts only bytes read
        from host state.  With the cache only the cold misses stage.
        Numpy only; waits first until no queued copy uses the buffer set."""
        bufs.wait_free()
        views = dict(zip(lay.names, carve(buf, lay.specs, lay.offsets)))
        for name, arr in tables.items():
            views[name][...] = arr
        staged = {"_buf": buf}
        srcs = (("h_old", self.h[l]), ("a", self.a[l]), ("nct", self.nct[l]),
                ("h_cur", self.h[l + 1]))
        if cops is not None:
            for name, blocks in srcs:
                rows = cops.h_miss_src if name == "h_old" else cops.s_miss_src
                staged[name] = np.take(self._flat(blocks), rows, axis=0, out=views[name])
            return staged
        for name, blocks in srcs:
            rows, live = ((tr.need_h, tr.need_mask) if name == "h_old"
                          else (tr.srows, tr.srows_mask))
            cap = rows.shape[1]
            v = views[name].reshape(self.S, cap + 1, -1)
            v[:, :cap] = self._flat(blocks)[rows]
            v[:, :cap][~live] = 0.0
            v[:, cap] = 0.0  # each shard's scratch row
            staged[name] = v[:, :cap]
        if "h_new" in views:
            np.copyto(views["h_new"], views["h_old"])
            staged["_h_new"] = views["h_new"]
        return staged

    def _put(self, lay: _StagedLayout, staged) -> dict:
        """The layer's one host→device copy; device views by name."""
        buf = torch.from_numpy(staged["_buf"])
        if self.device.type == "cuda":
            buf = buf.to(self.device, non_blocking=True)
        return dict(zip(lay.names, carve(buf, lay.specs, lay.offsets)))

    def _count_up(self, h_rows: np.ndarray, s_rows: np.ndarray, nbytes: int) -> None:
        with self._acc_lock:
            self.transfers.rows_up += int(h_rows.sum() + 3 * s_rows.sum())
            self.transfers.bytes_up += int(nbytes)
            self.per_shard_rows += h_rows + 3 * s_rows

    def _step(self, l: int, tr: HybridLayerPlan, dev: dict, h_old: torch.Tensor,
              h_new: torch.Tensor, a: torch.Tensor, nct: torch.Tensor, h_cur: torch.Tensor):
        """The compact layer over ``[S, cap + 1, ·]`` views of the blocks."""
        S, nh, ns = self.S, tr.nh_cap + 1, tr.ns_cap + 1
        outs = (a.view(S, ns, -1), nct.view(S, ns, -1), h_cur.view(S, ns, -1))
        hybrid_layer_step(self.model, tr.layout, self.params[l], h_old.view(S, nh, -1),
                          h_new.view(S, nh, -1), *outs, dev["idx"], dev["flt"], dev["msk"],
                          dev["sched"])
        return outs

    def _layer_exec(self, l: int, tr: HybridLayerPlan, lay: _StagedLayout, staged,
                    prev_rows: np.ndarray, prev_new: np.ndarray,
                    prev_dev: Optional[torch.Tensor]):
        """Ship the layer in one copy and run it.  psum mode: the staged
        ``h_new`` copy is patched on the host first (and ships too).
        Device-served mode: the new view is the shipped old view with the
        previous layer's outputs written into ``patch_pos`` on the device —
        halo rows are pristine in the old view, and the patch covers every
        row the previous layer wrote, whichever shard owns it."""
        nh_live, ns_live = tr.need_mask.sum(axis=1), tr.srows_mask.sum(axis=1)
        payload = sum(staged[k].nbytes for k in ("h_old", "a", "nct", "h_cur"))
        if self.halo_mode == "psum":
            flat_new = staged["_h_new"]
            keys = np.full((self.S, tr.nh_cap + 1), -1, np.int64)
            keys[:, :-1] = np.where(tr.need_mask, tr.need_h, -1)
            _override_rows(flat_new, keys.reshape(-1), prev_rows, prev_new)
            self._count_up(2 * nh_live, ns_live, payload + staged["h_old"].nbytes)
            dev = self._put(lay, staged)
            h_new = dev["h_new"]
            extra = 0
        else:
            self._count_up(nh_live, ns_live, payload)
            dev = self._put(lay, staged)
            h_new = dev["h_old"]
            if "patch_pos" in dev and dev["patch_pos"].shape[0] and prev_dev is not None:
                h_new = h_new.index_put((dev["patch_pos"],), prev_dev[dev["patch_src"]])
            extra = 0 if h_new is dev["h_old"] else h_new.nbytes
        self.peak_device_bytes = max(self.peak_device_bytes, lay.total + extra)
        return self._step(l, tr, dev, dev["h_old"], h_new, dev["a"], dev["nct"], dev["h_cur"])

    def _layer_exec_cached(self, l: int, tr: HybridLayerPlan, lay: _StagedLayout, staged,
                           cops: _CacheLayerOps, prev_dev: Optional[torch.Tensor]):
        """Cached variant: assemble the flat ``[S·(cap+1)]`` workspaces from
        the staged cold misses and the cached hot slots (dead slots and
        scratch rows stay 0, as the uncached gather leaves them), patch the
        new view on the device, run the identical step, then refresh the
        written slots in place from its outputs."""
        cache = self._cache
        S, nh, ns = self.S, tr.nh_cap + 1, tr.ns_cap + 1
        self._count_up(np.bincount(cops.h_miss_pos // nh, minlength=S),
                       np.bincount(cops.s_miss_pos // ns, minlength=S),
                       sum(staged[k].nbytes for k in ("h_old", "a", "nct", "h_cur")))
        dev = self._put(lay, staged)
        d_in = self.h[l].shape[2]

        def hits(key, name, width):
            if not (cops.h_hit_pos if key[0] == "h" else cops.s_hit_pos).size:
                return None
            return cache.store(key, name, (width,))[dev[f"{key[0]}_hit_slots"]]

        h_old = _cache_assemble(S * nh - 1, d_in, self.device, dev["h_miss_pos"], dev["h_old"],
                                dev["h_hit_pos"], hits(("h", l), "h", d_in))
        if cops.h_admit_midx.size:
            cache.update_store(("h", l), "h", dev["h_admit_slots"],
                               dev["h_old"][dev["h_admit_midx"]])
        h_new = h_old
        if cops.patch_pos.size:
            h_new = h_old.index_put((dev["patch_pos"],), prev_dev[dev["patch_src"]])
        s_key = ("s", l)
        state = {}
        for name, width in (("a", self.a[l].shape[2]), ("nct", self.nct[l].shape[2]),
                            ("h", self.h[l + 1].shape[2])):
            state[name] = _cache_assemble(S * ns - 1, width, self.device, dev["s_miss_pos"],
                                          dev["h_cur" if name == "h" else name],
                                          dev["s_hit_pos"], hits(s_key, name, width))
        self.peak_device_bytes = max(
            self.peak_device_bytes,
            lay.total + sum(t.nbytes for t in (h_old, h_new, *state.values())))
        outs = self._step(l, tr, dev, h_old, h_new, state["a"], state["nct"], state["h"])
        if cops.s_wb_pos.size:
            for name, o in zip(("a", "nct", "h"), outs):
                cache.update_store(s_key, name, dev["s_wb_slots"],
                                   o.reshape(S * ns, -1)[dev["s_wb_pos"]])
        if cops.hnext_wb_pos.size:
            cache.update_store(("h", l + 1), "h", dev["hnext_wb_slots"],
                               outs[2].reshape(S * ns, -1)[dev["hnext_wb_pos"]])
        return outs

    def _writeback_host(self, l: int, tr: HybridLayerPlan, srows_flat: np.ndarray,
                        a_new: np.ndarray, nct_new: np.ndarray, h_new: np.ndarray) -> None:
        """Grouped per-shard host scatter of one layer's written-back rows
        (on the staging worker in async mode): the host blocks are the
        halo-exchange medium between layers."""
        live = tr.srows_mask
        rows = (a_new[live], nct_new[live], h_new[live])
        for blocks, vals in zip((self.a[l], self.nct[l], self.h[l + 1]), rows):
            self._scatter_rows(blocks, srows_flat, vals)
        with self._acc_lock:
            self.transfers.rows_down += 3 * int(srows_flat.shape[0])
            self.transfers.bytes_down += int(sum(v.nbytes for v in rows))
            self.per_shard_rows += 3 * live.sum(axis=1)

    def _final_writeback(self, payload) -> None:
        """The final layer's scatter once its D2H has landed (worker or
        ``flush``); waits on the copy's event, touches no tensor."""
        if payload is None:
            return
        l, tr, srows_flat, copy = payload
        a_new, nct_new, h_new = copy.wait()
        self._writeback_host(l, tr, srows_flat, a_new, nct_new, h_new)
