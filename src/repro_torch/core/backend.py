"""Residency-backend architecture of the port: one orchestrator, one state
substrate so far.  Mirrors the single-device part of ``repro.core.backend``.

    UpdateBatch stream → StreamOrchestrator  (plan t+1 on the host while the
                              │               device executes t; honest timing;
                              │               refresh cadence; execution
                              │               policy; batch-window fusion)
                              │  StateBackend protocol (plan / dispatch /
                              │  flush / synchronize + serving and policy
                              │  primitives)
                         DeviceBackend        (state in device memory as
                                               scratch-extended [N+1, ·]
                                               tensors; one fused in-place
                                               L-layer step per batch)

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
  merges runs of independent batches into one packed plan and one device
  step, bitwise-equal to the serial loop on the CPU; on a card every
  aggregation state stays bitwise, while h may differ in the last bits
  because cuBLAS picks the update matmul's kernel by row count;
* the serving API (``snapshot_rows`` / ``changed_rows``) on which
  :class:`repro_torch.serve.frontend.ServingFrontend` answers reads pinned
  to past versions.

The host-resident and sharded substrates of the reference are not ported
yet; ``StreamStats`` keeps the reference's full ``as_dict()`` key namespace,
with their staging, cache and halo counters at zero.
"""
from __future__ import annotations

import abc
import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.affected import (
    BatchPlan,
    BucketHysteresis,
    FusionConfig,
    FusionWindow,
    PackedLayout,
    PackedPlan,
    build_packed_plan,
    build_plan,
    final_write_rows,
    pack_plan,
)
from repro_torch.core.full import full_forward
from repro_torch.core.incremental import (
    fused_stream_step,
    incremental_layer,
    packed_fields,
    with_scratch,
)
from repro_torch.core.operators import GNNModel, Params
from repro_torch.core.policy import ExecutionPolicy, PlanCostEstimate
from repro_torch.device import host_to_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.streaming import UpdateBatch


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
    the fusion fields by fused streams.  The staging, cache and halo fields
    belong to substrates not ported yet and stay zero; they are kept so that
    :meth:`as_dict` has the reference's key namespace."""

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
        return StreamStats(stats, time.perf_counter() - t_start, plan_total,
                           prefetch_hits=prefetch_hits)

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
        return ss

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
