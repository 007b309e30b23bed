"""Residency-backend architecture of the port: one orchestrator, one state
substrate so far.  Mirrors the single-device part of ``repro.core.backend``.

    UpdateBatch stream → StreamOrchestrator  (plan t+1 on the host while the
                              │               device executes t; honest timing;
                              │               refresh cadence)
                              │  StateBackend protocol (plan / dispatch /
                              │  flush / synchronize)
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

The execution policy, batch-window fusion, the serving front-end and the
host-resident and sharded substrates of the reference are not ported yet;
``StreamStats`` keeps the reference's full ``as_dict()`` key namespace, with
their counters at zero.
"""
from __future__ import annotations

import abc
import dataclasses
import time
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.affected import BucketHysteresis, PackedLayout, PackedPlan, build_packed_plan
from repro_torch.core.full import full_forward
from repro_torch.core.incremental import (
    fused_stream_step,
    incremental_layer,
    packed_fields,
    with_scratch,
)
from repro_torch.core.operators import GNNModel, Params
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
    #: execution shape the batch ran as; always "incremental" until the
    #: execution policy is ported
    mode: str = "incremental"
    #: the policy cost model's raw edge-work / weighted cost (0 without one)
    est_edges: int = 0
    est_cost: float = 0.0
    #: logical batches that shared this batch's device dispatch (1 = alone)
    fused_window: int = 1


@dataclasses.dataclass
class StreamStats:
    """Aggregate result of a pipelined ``apply_stream`` run.

    ``wall_s`` is honest end-to-end time including the final device
    synchronisation; per-batch ``exec_time_s`` entries are dispatch-only
    (execution overlaps the next batch's planning, so per-batch completion
    is unobservable without breaking the pipeline).  ``prefetch_hits``
    counts the batches whose plan completed with no intervening backend
    barrier — ``len(batches) - 1`` for a healthy pipeline.  The staging,
    serving, cache, fusion, halo and policy fields belong to parts of the
    reference not ported yet and stay zero here; they are kept so that
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
    L: int

    #: bumped by every ``flush()``: the orchestrator uses it to verify a
    #: batch's plan really was built with no intervening backend barrier
    barrier_epoch: int = 0

    @property
    def overlap_capable(self) -> bool:
        """Whether ``apply_stream``'s plan/execute overlap is supported."""
        return True

    @abc.abstractmethod
    def plan(self, g_old: CSRGraph, g_new: CSRGraph, batch: UpdateBatch) -> Any:
        """Host-only, value-independent planning (may overlap execution)."""

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
# StreamOrchestrator — the single plan/pack/overlap loop
# ====================================================================== #
class StreamOrchestrator:
    """Drives one :class:`StateBackend` over an update stream.

    Owns the evolving graph snapshot, the refresh cadence, and the paper's
    §V co-processing schedule: ``apply_stream`` dispatches batch t and then
    runs host planning of batch t+1 while the device executes, syncing only
    at the end of the stream (and around refreshes).  ``apply_batch`` keeps
    the per-batch API with honest timing (``block=True`` synchronises at the
    timed boundary so ``exec_time_s`` measures completion, not dispatch)."""

    def __init__(self, backend: StateBackend, graph: CSRGraph, refresh_every: int = 0):
        self.backend = backend
        self.graph = graph
        self.refresh_every = refresh_every
        self._batches_seen = 0

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
    # per-batch API (honest timing: block=True syncs at the boundary)
    # ------------------------------------------------------------------ #
    def apply_batch(self, batch: UpdateBatch, block: bool = True) -> BatchStats:
        t0 = time.perf_counter()
        g_new = self._apply_graph(batch)
        t1 = time.perf_counter()
        prep = self.backend.plan(self.graph, g_new, batch)
        t2 = time.perf_counter()
        self.backend.dispatch(prep)
        if block:
            self.backend.flush()
            self.backend.synchronize()
        t3 = time.perf_counter()
        self.graph = g_new
        self._after_batch()
        return BatchStats(
            inc_edges=prep.n_inc_edges,
            full_edges=prep.n_full_edges,
            out_vertices=prep.n_out_rows,
            plan_time_s=t2 - t1,
            exec_time_s=t3 - t2,
            graph_time_s=t1 - t0,
        )

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
        t_start = time.perf_counter()
        stats: List[BatchStats] = []
        plan_total = 0.0
        prefetch_hits = 0  # batches whose plan was built behind execution

        tp = time.perf_counter()
        g_new = self._apply_graph(batches[0])
        prep = self.backend.plan(self.graph, g_new, batches[0])
        plan_total += time.perf_counter() - tp

        for i in range(len(batches)):
            epoch0 = self.backend.barrier_epoch
            td = time.perf_counter()
            self.backend.dispatch(prep)
            dispatch_s = time.perf_counter() - td
            self.graph = g_new
            stats.append(BatchStats(
                inc_edges=prep.n_inc_edges,
                full_edges=prep.n_full_edges,
                out_vertices=prep.n_out_rows,
                plan_time_s=0.0,
                exec_time_s=dispatch_s,  # dispatch-only; see StreamStats
                graph_time_s=0.0,
            ))
            if i + 1 < len(batches):
                tp = time.perf_counter()  # overlapped with device execution
                nxt = self._apply_graph(batches[i + 1])
                prep = self.backend.plan(self.graph, nxt, batches[i + 1])
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
    pick their summation order by shape."""

    def __init__(
        self,
        model: GNNModel,
        params: Sequence[Params],
        graph: CSRGraph,
        x: torch.Tensor,
        fused: bool = True,
    ):
        self.model = model
        self.params = list(params)
        self.L = len(self.params)
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
        self._h: List[torch.Tensor] = [with_scratch(x)] + [with_scratch(s.h) for s in states]
        self._a: List[torch.Tensor] = [with_scratch(s.a) for s in states]
        self._nct: List[torch.Tensor] = [with_scratch(s.nct) for s in states]

    def refresh(self, graph: CSRGraph) -> None:
        self._init_state(graph, self.x)

    @property
    def x(self) -> torch.Tensor:
        return self._h[0][:-1]

    @property
    def h(self) -> List[torch.Tensor]:
        """Per-layer embeddings without scratch rows."""
        return [v[:-1] for v in self._h]

    @property
    def a(self) -> List[torch.Tensor]:
        return [v[:-1] for v in self._a]

    @property
    def nct(self) -> List[torch.Tensor]:
        return [v[:-1] for v in self._nct]

    @property
    def embeddings(self) -> torch.Tensor:
        return self._h[-1][:-1]

    def state_bytes(self) -> int:
        return sum((v.shape[0] - 1) * v[0].numel() * v.element_size()
                   for v in (*self._h, *self._a, *self._nct))

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # reads: O(len(rows)) device gather + copy to the host
    # ------------------------------------------------------------------ #
    def snapshot_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host copy of final-layer embedding rows (consistent after a
        barrier)."""
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
        return self._h[-1][:-1][idx].cpu().numpy()

    # ------------------------------------------------------------------ #
    def plan(self, g_old: CSRGraph, g_new: CSRGraph, batch: UpdateBatch) -> PackedPlan:
        return build_packed_plan(self.model, g_old, g_new, batch, self.L, hwm=self.hwm)

    def dispatch(self, packed: PackedPlan) -> None:
        """One host→device copy for the whole plan, then the step."""
        bufs = self._stage(packed)
        if self.fused:
            fused_stream_step(self.model, packed.layout, self.params, self._h, self._a,
                              self._nct, *bufs)
        else:
            self._execute_unfused(packed.layout, *bufs)

    # ------------------------------------------------------------------ #
    def _stage(self, packed: PackedPlan) -> Tuple[torch.Tensor, ...]:
        """Ship the packed buffers to the device in one copy.

        The buffers are laid end to end in one fresh host byte buffer
        (4-byte fields first, the bool mask last) — pinned when the state
        lives on a card, so the copy is ``non_blocking`` and the host can
        plan the next batch meanwhile.  A fresh buffer per batch is never
        reused while its copy may be in flight: PyTorch's pinned-memory
        allocator holds a freed block until the copy's stream event has
        passed.  Returns device views (idx, flt, msk, sched, feat_vals)."""
        feat = packed.feat_vals
        parts = [packed.idx, packed.sched, packed.flt]
        if feat is not None:
            parts.append(np.ascontiguousarray(feat, np.float32).ravel())
        parts.append(packed.msk)
        sizes = [p.nbytes for p in parts]
        cuda = self.device.type == "cuda"
        host = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=cuda)
        host_np = host.numpy()
        off = 0
        for p, sz in zip(parts, sizes):
            host_np[off:off + sz] = p.view(np.uint8).ravel()
            off += sz
        dev = host.to(self.device, non_blocking=True) if cuda else host
        views = []
        off = 0
        for p, sz in zip(parts, sizes):
            views.append(dev[off:off + sz].view(_TORCH_DTYPE[p.dtype.str]))
            off += sz
        idx, sched, flt = views[:3]
        msk = views[-1]
        feat_vals = views[3].view(feat.shape) if feat is not None else None
        return idx, flt, msk, sched, feat_vals

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


_TORCH_DTYPE = {"<i4": torch.int32, "<f4": torch.float32, "|b1": torch.bool}
