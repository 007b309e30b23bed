"""Online serving front-end: versioned snapshot reads over a streaming engine.

The port's copy of ``repro.serve.frontend``, over the PyTorch backends: the
same contract, counters and errors.  The persistent state tensors are
updated in place on the device, so every undo pre-image is a finished host
copy (``snapshot_rows`` returns one) taken before the batch is dispatched.

The paper makes RTEC cheap enough to run *at serve time*; this module is the
deployment shape that exploits it.  A :class:`ServingFrontend` multiplexes
the two traffic classes a real deployment sees over one
:class:`~repro_torch.core.backend.StreamOrchestrator` + :class:`StateBackend`:

* **writes** — structural/feature :class:`UpdateBatch` streams, applied one
  flushed batch at a time;
* **reads** — "give me fresh embeddings for these vertices" queries,
  micro-batched between update batches and answered from versioned,
  consistent snapshot views.

Serving API — the version/consistency contract
----------------------------------------------

* The frontend maintains a monotone ``version`` counter: version 0 is the
  construction-time state and each flushed update batch bumps it by one.
  Every batch is applied with ``block=True`` (``flush()`` +
  ``synchronize()``), so a version is always a full
  barrier — the substrate's state *is* the post-batch state, bitwise.
* A read is **pinned** to a version at submit time (defaulting to the
  then-current version).  When served, its rows are **bitwise-equal** to
  the post-batch state at the pinned version, no matter how many batches
  have run since: between plan and dispatch of every batch the frontend
  snapshots the plan's final-layer write set
  (``StateBackend.changed_rows`` → ``snapshot_rows``) as a per-version
  *undo record*; a read pinned at v gathers current rows and overrides
  them with undo pre-images walking versions C→v+1.  Rows outside every
  write set are untouched by construction, so the reconstruction is exact.
* Undo history is bounded (``max_versions``).  A pin that falls below the
  retained floor is rejected with :class:`StaleVersionError`; a full
  pending-read queue evicts the oldest-pinned reads with
  :class:`ReadRejectedError` (admission control — the reads most likely to
  be unservably stale go first).
* An orchestrator ``refresh`` (drift reset) recomputes state from scratch
  — bitwise reconstruction across it is impossible, so the undo history is
  cleared and the floor jumps to the refresh version.
* Snapshot reads run at version boundaries, after the batch's device step
  has finished (see ``StateBackend.snapshot_rows``).

Read-side telemetry (``reads_served``, ``reads_rejected``, submit→serve
latency p50/p99, cumulative staleness in batches) reports through the same
:class:`StreamStats` every other entry point returns.

The frontend is deliberately single-threaded and deterministic: reads are
admitted any time, but service happens at micro-batch points (before each
update batch and at ``drain``), which is what makes the bitwise interleaving
tests and the CI-gated exact counters possible.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.backend import (
    BatchStats,
    StreamOrchestrator,
    StreamStats,
    _override_rows,
)
from repro_torch.graph.streaming import UpdateBatch


class ReadRejectedError(RuntimeError):
    """Read evicted by admission control (pending-read queue full)."""


class StaleVersionError(ReadRejectedError):
    """Read pinned below the retained undo-history floor."""


@dataclasses.dataclass
class ReadTicket:
    """One embedding-read query: global vertex ids pinned to a version."""

    rows: np.ndarray  # int64 global vertex ids (as submitted)
    version: int  # pinned version
    submitted_s: float
    result: Optional[np.ndarray] = None  # [len(rows), d] once served
    error: Optional[Exception] = None
    served_version: Optional[int] = None  # frontend version at service time

    @property
    def done(self) -> bool:
        return self.result is not None or self.error is not None

    @property
    def staleness(self) -> int:
        """Batches applied between the pin and service (0 = fresh)."""
        return (self.served_version - self.version
                if self.served_version is not None else 0)

    def value(self) -> np.ndarray:
        """The embedding rows at the pinned version (raises if rejected)."""
        if self.error is not None:
            raise self.error
        assert self.result is not None, "read not served yet"
        return self.result


@dataclasses.dataclass
class _UndoRecord:
    """Pre-images of the rows batch ``version`` wrote: applying this record
    on top of post-batch-``version`` state yields post-batch-``version-1``
    state, bitwise."""

    version: int
    rows: np.ndarray  # sorted unique int64
    vals: np.ndarray  # [len(rows), d] pre-batch values


class ServingFrontend:
    """Multiplexes update-batch writes and versioned embedding reads over
    any :class:`StateBackend` (see the module docstring for the contract).

    Parameters
    ----------
    engine:
        A :class:`StreamOrchestrator`, or any engine facade exposing
        ``_orch`` (everything :func:`repro_torch.serve.create_engine`
        returns).
    max_pending_reads:
        Admission-control bound on queued (unserved) reads; exceeding it
        evicts the oldest-pinned reads with :class:`ReadRejectedError`.
    max_versions:
        Retained undo-history depth — how many versions back a read may pin.
    """

    def __init__(self, engine, max_pending_reads: int = 64,
                 max_versions: int = 8):
        orch = engine if isinstance(engine, StreamOrchestrator) else engine._orch
        if max_pending_reads < 1:
            raise ValueError("max_pending_reads must be >= 1")
        if max_versions < 0:
            raise ValueError("max_versions must be >= 0")
        self._orch = orch
        self.max_pending_reads = max_pending_reads
        self.max_versions = max_versions
        self.version = 0
        self._floor = 0  # oldest version still bitwise-reconstructible
        self._undo: List[_UndoRecord] = []  # ascending by .version
        self._pending: List[ReadTicket] = []
        self._batch_stats: List[BatchStats] = []
        self._latencies: List[float] = []
        self._wall_s = 0.0
        self._plan_s = 0.0
        self.reads_served = 0
        self.reads_rejected = 0
        self.staleness_batches = 0
        # fusion counter baseline: stats() reports the deltas this
        # frontend's writes produced, not the orchestrator's lifetime totals
        self._fusion0 = (orch.fusion_windows, orch.fused_batches,
                         orch.fusion_fallbacks)

    # ------------------------------------------------------------------ #
    # read path
    # ------------------------------------------------------------------ #
    @property
    def min_version(self) -> int:
        """Oldest version a read may pin (the undo-history floor)."""
        return self._floor

    def submit_read(self, rows: Sequence[int],
                    version: Optional[int] = None) -> ReadTicket:
        """Enqueue an embedding read pinned to ``version`` (default: the
        current version).  Service happens at the next micro-batch point
        (:meth:`serve_reads`, called by :meth:`apply_batch`/:meth:`drain`).

        Raises :class:`StaleVersionError` immediately for pins below the
        retained floor; pins above the current version queue until the
        stream reaches them."""
        pin = self.version if version is None else int(version)
        if pin < self._floor:
            self.reads_rejected += 1
            raise StaleVersionError(
                f"read pinned at version {pin} but undo history floor is "
                f"{self._floor} (max_versions={self.max_versions})")
        t = ReadTicket(rows=np.asarray(rows, np.int64), version=pin,
                       submitted_s=time.perf_counter())
        self._pending.append(t)
        # admission control: evict the oldest-pinned reads first — they
        # are the ones most likely to fall below the floor anyway
        while len(self._pending) > self.max_pending_reads:
            evict = min(self._pending, key=lambda p: (p.version,
                                                      p.submitted_s))
            self._pending.remove(evict)
            evict.error = ReadRejectedError(
                f"read queue full (max_pending_reads="
                f"{self.max_pending_reads}); oldest-pinned read (version "
                f"{evict.version}) evicted")
            self.reads_rejected += 1
        return t

    def read(self, rows: Sequence[int],
             version: Optional[int] = None) -> np.ndarray:
        """Synchronous convenience wrapper: submit + serve immediately."""
        t = self.submit_read(rows, version=version)
        self.serve_reads()
        return t.value()

    def _reconstruct(self, rows: np.ndarray, pin: int) -> np.ndarray:
        """Rows at version ``pin``: gather current values, then walk the
        undo records C→pin+1 overriding any row they wrote."""
        vals = np.array(self._orch.backend.snapshot_rows(rows))
        for rec in reversed(self._undo):
            if rec.version <= pin:
                break
            _override_rows(vals, rows, rec.rows, rec.vals)
        return vals

    def serve_reads(self) -> int:
        """Serve every pending read pinned at or below the current version
        (micro-batched: one snapshot per distinct pinned version).  Returns
        the number of reads served."""
        due = [t for t in self._pending if t.version <= self.version]
        if not due:
            return 0
        served = 0
        for pin in sorted({t.version for t in due}):
            group = [t for t in due if t.version == pin]
            if pin < self._floor:  # floor moved while queued
                for t in group:
                    self._pending.remove(t)
                    t.error = StaleVersionError(
                        f"read pinned at version {pin} fell below the undo "
                        f"history floor {self._floor} while queued")
                    self.reads_rejected += 1
                continue
            # one gather for the union of the group's rows, scattered back
            union = np.unique(np.concatenate([t.rows for t in group]))
            union_vals = self._reconstruct(union, pin)
            now = time.perf_counter()
            for t in group:
                self._pending.remove(t)
                t.result = union_vals[np.searchsorted(union, t.rows)]
                t.served_version = self.version
                self._latencies.append(now - t.submitted_s)
                self.staleness_batches += t.staleness
                served += 1
        self.reads_served += served
        return served

    # ------------------------------------------------------------------ #
    # write path
    # ------------------------------------------------------------------ #
    def apply_batch(self, batch: UpdateBatch) -> BatchStats:
        """Serve due reads, then apply one update batch as a full version
        boundary (the undo pre-images are captured between the batch's plan
        and dispatch via the orchestrator's ``on_plan`` hook)."""
        self.serve_reads()
        t0 = time.perf_counter()
        captured: List[_UndoRecord] = []

        def on_plan(prep) -> None:
            # write_set resolves the plan's final-layer rows whatever
            # execution mode the orchestrator's policy chose; the hook is
            # never invoked for full-recompute batches (their pre-images
            # would be a whole-state copy) — those reset the history below
            rows = np.asarray(self._orch.write_set(prep), np.int64)
            captured.append(_UndoRecord(
                version=self.version + 1, rows=rows,
                vals=np.array(self._orch.backend.snapshot_rows(rows))))

        bs = self._orch.apply_batch(batch, block=True, on_plan=on_plan)
        self.version += 1
        orch = self._orch
        refreshed = (orch.refresh_every
                     and orch._batches_seen % orch.refresh_every == 0)
        if refreshed or bs.mode == "full":
            # a refresh — cadence-driven or policy-chosen full recompute —
            # rebuilt state from scratch: older versions are no longer
            # bitwise-reconstructible — drop the undo history
            self._undo.clear()
            self._floor = self.version
        else:
            self._undo.extend(captured)
            while len(self._undo) > self.max_versions:
                self._undo.pop(0)
                self._floor += 1
        self._wall_s += time.perf_counter() - t0
        self._plan_s += bs.plan_time_s
        self._batch_stats.append(bs)
        return bs

    def apply_window(self, batches: Sequence[UpdateBatch]) -> List[BatchStats]:
        """Serve due reads, then apply a fused *prefix* of ``batches``
        through :meth:`StreamOrchestrator.apply_window`: the
        orchestrator merges the maximal independent prefix into one device
        dispatch; the frontend still records **one version per logical
        batch**.  Pre-images are captured per constituent — in stream
        order, against the strictly pre-window state — which is exact
        because fused windows have pairwise-disjoint write sets (a row
        batch j writes is untouched by batches 0..j-1, so its pre-window
        value equals its post-batch-(j-1) value).  Returns the consumed
        batches' stats; ``len(result)`` tells the caller how far the
        stream advanced.  Falls back to plain serial single-batch behavior
        (bitwise, version-for-version) when fusion is off or the head
        batches overlap."""
        batches = list(batches)
        if not batches:
            return []
        self.serve_reads()
        t0 = time.perf_counter()
        captured: List[_UndoRecord] = []

        def on_plan(plan) -> None:
            # called once per constituent, before dispatch: version numbers
            # are assigned in stream order on top of the current version
            rows = np.asarray(self._orch.write_set(plan), np.int64)
            captured.append(_UndoRecord(
                version=self.version + 1 + len(captured), rows=rows,
                vals=np.array(self._orch.backend.snapshot_rows(rows))))

        out = self._orch.apply_window(batches, on_plan=on_plan)
        orch = self._orch
        ci = 0  # next captured pre-image (full-recompute batches skip one)
        for j, bs in enumerate(out):
            self.version += 1
            # _batches_seen already advanced by len(out); reconstruct this
            # constituent's post-batch count for the refresh-cadence check.
            # Fused windows never span a refresh boundary (the orchestrator
            # caps the window at it), so only the last constituent can land
            # on the cadence.
            seen = orch._batches_seen - (len(out) - 1 - j)
            refreshed = (orch.refresh_every
                         and seen % orch.refresh_every == 0)
            if refreshed or bs.mode == "full":
                self._undo.clear()
                self._floor = self.version
                if bs.mode != "full":
                    ci += 1  # captured, then invalidated by the refresh
            else:
                self._undo.append(captured[ci])
                ci += 1
                while len(self._undo) > self.max_versions:
                    self._undo.pop(0)
                    self._floor += 1
        self._wall_s += time.perf_counter() - t0
        self._plan_s += sum(bs.plan_time_s for bs in out)
        self._batch_stats.extend(out)
        return out

    def run_stream(self, batches: Sequence[UpdateBatch]) -> StreamStats:
        """Apply a whole update stream, serving reads between batches and
        draining the queue at the end.  When the engine was built with
        :class:`~repro_torch.core.affected.FusionConfig`, consecutive independent
        batches are fused into shared device dispatches — the
        version/consistency contract is unchanged: one version per logical
        batch, snapshot reads bitwise-equal to the serial path."""
        batches = list(batches)
        i = 0
        while i < len(batches):
            if self._orch._fusion_active():
                i += len(self.apply_window(batches[i:]))
            else:
                self.apply_batch(batches[i])
                i += 1
        self.drain()
        return self.stats()

    def drain(self) -> int:
        """Serve everything still pending (end-of-stream barrier)."""
        return self.serve_reads()

    # ------------------------------------------------------------------ #
    def stats(self) -> StreamStats:
        """The run so far as the repo's single result type."""
        lat = np.asarray(self._latencies, np.float64)
        orch = self._orch
        return StreamStats(
            batches=list(self._batch_stats),
            wall_s=self._wall_s,
            plan_s=self._plan_s,
            reads_served=self.reads_served,
            reads_rejected=self.reads_rejected,
            read_p50_s=float(np.percentile(lat, 50)) if lat.size else 0.0,
            read_p99_s=float(np.percentile(lat, 99)) if lat.size else 0.0,
            staleness_batches=self.staleness_batches,
            fusion_windows=orch.fusion_windows - self._fusion0[0],
            fused_batches=orch.fused_batches - self._fusion0[1],
            fusion_fallbacks=orch.fusion_fallbacks - self._fusion0[2],
        )
