"""Degree-aware device-resident hot-row cache for the host-resident
backend, in PyTorch.  Mirrors ``repro.serve.hotcache``.

The paper's §V co-processing argument is that communication-optimized
scheduling — not just overlap — keeps the device busy when the embedding
tables live in host memory, and the degree skew of real graphs makes a small
hot set absorb most row traffic.  This module pins that hot set on the
device so the :class:`~repro_torch.serve.staging.HostStagingPipeline`
gathers only cold misses per layer:

::

    plan (host, value-independent)           dispatch (device)
    ─────────────────────────────            ────────────────────────────
    need_h ──┬── [cached] ── slot ids ─────▶ store[slots] ──┐ index write
             └── [miss]   ── gather rows ──▶ H2D (staged) ──┤   ▼
                                                       workspace [nh, d]
    srows  ──┬── [cached] ── slot ids ─────▶ store[slots] ──┐ index write
             └── [miss]   ── gather rows ──▶ H2D (staged) ──┤   ▼
                                                       a/nct/h_cur [ns, ·]
                                             kernel outs ──▶ store[wb
                                             slots] = outs (in place; the
                                             host write-back is unchanged)

    admission  = frequency × (1 + degree), from the plan's degree tables
    eviction   = deterministic lowest-priority victim (ties: smallest row)
    invalidate = value-independent, driven by the plan's write sets
                 (feature updates, policy chunked scatters, full refresh)

Coherence invariant: *a cached slot always holds exactly the host-state
value of its row as of the last completed batch.*  It is maintained
without ever reading state values at plan time:

* The split of each layer's needed rows into ``[cached | miss]`` is
  computed at **plan time** (:func:`repro_torch.core.affected.split_residency`)
  from slot metadata only, so it keeps the §V overlap contract: all
  metadata mutation happens in ``plan`` and all device data movement in
  ``dispatch``, and the orchestrator serializes plan(t+1) after
  dispatch(t).
* Rows written *earlier in the same batch* (the previous layer's write set /
  the batch's feature vertices) are excluded from hits and from
  staged-value admission.  Their cached slots are instead updated **in
  place on the device from the kernel outputs** at write-back, so hot rows
  skip the D2H→host→H2D re-staging round trip (host state stays
  authoritative for snapshot reads and the serving undo log).
* Writes that do not flow through the incremental write-back (feature
  scatters, the policy's chunked ``scatter_layer_rows``, full refresh)
  **invalidate** instead — value-independent, driven by the same row sets
  ``changed_rows`` reports.

Row spaces: one per (kind, layer) — ``("h", l)`` caches rows of ``h[l]``
(the layer-``l`` gather view), ``("s", l)`` caches the ``(a[l], nct[l],
h[l+1])`` row triple (the layer-``l`` state view); keys are global row ids.
The slot metadata is numpy; the stores are ``[capacity, ·]`` float32
tensors on the backend's device, written in place by index.

Everything here is deterministic: admission order, eviction victims and the
hit/miss/eviction counters (``StreamStats.cache_hit_rows`` /
``cache_miss_rows`` / ``cache_evictions``) depend only on the update
stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.affected import ResidencySplit, split_residency

#: admission priority models ``CacheConfig.admission`` accepts
ADMISSION_POLICIES = ("freq_degree", "freq")


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Typed knobs for the device hot-row cache (nested in
    :class:`repro_torch.serve.api.EngineConfig` as ``cache=``).

    ``capacity_rows`` is the slot count *per row space* (2 spaces per
    layer); ``admission`` picks the priority model (``"freq_degree"`` —
    touch frequency × (1 + plan degree), the paper-motivated default — or
    ``"freq"`` — pure touch frequency); ``enabled=False`` keeps the
    config inert (identical to passing no cache at all).

    ``prewarm_rows`` seeds every row space from the top-degree
    rows of the base graph *before batch 0* instead of learning the hot
    set during the first batches — the degree skew the paper's §V argument
    rests on makes the static top of the degree distribution a strong
    prior for the streamed hot set.  ``decay`` is the per-batch
    LFU aging factor: each batch every space's frequency counters are
    multiplied by ``1 - decay`` at plan time, so a drifting hot set
    (feature_churn regime) can evict stale hubs.  Both default off
    (``0`` / ``0.0``: learned residency, no aging)."""

    capacity_rows: int = 256
    admission: str = "freq_degree"
    enabled: bool = True
    prewarm_rows: int = 0
    decay: float = 0.0

    def __post_init__(self) -> None:
        if self.capacity_rows <= 0:
            raise ValueError(f"capacity_rows must be positive, got "
                             f"{self.capacity_rows}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {self.admission!r}; "
                             f"expected one of {ADMISSION_POLICIES}")
        if self.prewarm_rows < 0:
            raise ValueError(f"prewarm_rows must be >= 0, got "
                             f"{self.prewarm_rows}")
        if not 0.0 <= self.decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {self.decay!r}")


@dataclasses.dataclass
class CacheStats:
    """Deterministic cache counters (documented subset surfaced through
    ``StreamStats.as_dict``; see the table there)."""

    hit_rows: int = 0  #: rows served from device slots instead of staging
    miss_rows: int = 0  #: rows staged from host (cold or excluded)
    evictions: int = 0  #: capacity evictions (invalidations counted apart)
    admitted_rows: int = 0
    invalidated_rows: int = 0

    def snapshot(self) -> "CacheStats":
        return dataclasses.replace(self)


class _Space:
    """Slot metadata for one cached row space (host-side, value-free)."""

    __slots__ = ("slot_of", "row_of", "freq", "degw", "free", "stores")

    def __init__(self, n_keys: int, capacity: int) -> None:
        self.slot_of = np.full(n_keys, -1, np.int32)
        self.row_of = np.full(capacity, -1, np.int64)
        # float64 so LFU decay (CacheConfig.decay) can age counters in
        # place; undecayed counters are small integers, exact in float64,
        # so decay=0.0 keeps every priority bit-identical to the old int64
        self.freq = np.zeros(n_keys, np.float64)
        self.degw = np.zeros(n_keys, np.float32)
        # grow-only slot table: pop() always yields the smallest free slot
        self.free = list(range(capacity - 1, -1, -1))
        self.stores: Dict[str, torch.Tensor] = {}  # name -> [cap, ·] on the device


class HotRowCache:
    """Pinned device hot-row cache: host-side slot metadata (this class)
    plus per-space ``[capacity, ·]`` float32 stores on ``device`` that the
    owning backend writes in place.  All admission/eviction/split decisions
    happen at plan time and are value-independent; the backend performs the
    corresponding device data movement at dispatch in the same order (see
    the module docstring's coherence invariant)."""

    def __init__(self, config: Optional[CacheConfig] = None, device="cuda") -> None:
        self.config = config or CacheConfig()
        self.device = torch.device(device)
        self.capacity = int(self.config.capacity_rows)
        self.stats = CacheStats()
        self._spaces: Dict[Tuple[str, int], _Space] = {}

    # ------------------------------------------------------------------ #
    # metadata (plan time, host only)
    # ------------------------------------------------------------------ #
    def _space(self, key: Tuple[str, int], n_keys: int) -> _Space:
        sp = self._spaces.get(key)
        if sp is None:
            sp = self._spaces[key] = _Space(n_keys, self.capacity)
        return sp

    def _priority(self, sp: _Space, rows: np.ndarray) -> np.ndarray:
        if self.config.admission == "freq":
            return sp.freq[rows].astype(np.float64)
        return sp.freq[rows] * (1.0 + sp.degw[rows].astype(np.float64))

    def _touch(self, sp: _Space, rows: np.ndarray, deg: np.ndarray) -> None:
        np.add.at(sp.freq, rows, 1)
        sp.degw[rows] = np.asarray(deg, np.float32)

    def decay_tick(self) -> None:
        """Age every space's frequency counters by ``1 - decay`` (LFU
        decay; the owning backend calls this once per batch at plan
        time).  With the default ``decay=0.0`` this returns immediately
        and every counter — and therefore every admission/eviction
        decision — is bit-for-bit the undecayed behavior."""
        d = self.config.decay
        if d <= 0.0:
            return
        f = 1.0 - d
        for sp in self._spaces.values():
            sp.freq *= f

    def _admit(self, sp: _Space, cand_rows: np.ndarray) -> np.ndarray:
        """Deterministically admit candidate rows (unique, uncached).

        Free slots fill first (highest priority first, ties to the
        smallest row); once full, a candidate evicts the lowest-priority
        cached victim only if strictly hotter (victim ties break to the
        smallest row).  Returns the admitted rows (slot assignment is in
        ``slot_of``)."""
        if not cand_rows.size:
            return cand_rows
        prio = self._priority(sp, cand_rows)
        order = np.lexsort((cand_rows, -prio))
        admitted = []
        for i in order:
            row = int(cand_rows[i])
            if sp.free:
                slot = sp.free.pop()
            else:
                occ = sp.row_of  # all slots occupied once free is empty
                vprio = self._priority(sp, occ)
                v = int(np.lexsort((occ, vprio))[0])
                if not prio[i] > vprio[v]:
                    # candidates are sorted by descending priority and the
                    # victim pool only gets hotter on eviction, so no later
                    # candidate can succeed either
                    break
                slot = v
                sp.slot_of[occ[v]] = -1
                self.stats.evictions += 1
            sp.slot_of[row] = slot
            sp.row_of[slot] = row
            admitted.append(row)
            self.stats.admitted_rows += 1
        return np.asarray(admitted, np.int64)

    def plan_reads(self, key: Tuple[str, int], n_keys: int, rows: np.ndarray,
                   deg: np.ndarray, exclude_rows: Optional[np.ndarray] = None,
                   admit: bool = True) -> ResidencySplit:
        """Plan-time ``[cached | miss]`` split of one layer's needed rows.

        Bumps the touch frequency, splits against the slot table
        (excluding rows written earlier in this batch — see module
        docstring), and optionally admits the hottest *non-excluded*
        misses so dispatch can fill their slots from the staged (pristine,
        pre-batch) values.  Returns the split with admission indices into
        its miss list."""
        sp = self._space(key, n_keys)
        self._touch(sp, rows, deg)
        split = split_residency(rows, sp.slot_of, exclude_rows=exclude_rows)
        self.stats.hit_rows += int(split.hit_pos.size)
        self.stats.miss_rows += int(split.miss_pos.size)
        if admit and split.miss_rows.size:
            cand, first = np.unique(split.miss_rows, return_index=True)
            if exclude_rows is not None and exclude_rows.size:
                keep = ~np.isin(cand, exclude_rows)
                cand, first = cand[keep], first[keep]
            got = self._admit(sp, cand)
            if got.size:
                sel = np.isin(cand, got)
                midx = np.sort(first[sel]).astype(np.int64)
                split = dataclasses.replace(
                    split,
                    admit_midx=midx,
                    admit_slots=sp.slot_of[split.miss_rows[midx]].astype(
                        np.int32),
                )
        return split

    def plan_writeback(self, key: Tuple[str, int], n_keys: int,
                       rows: np.ndarray, deg: np.ndarray,
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Plan the in-place device slot updates for one layer's written
        rows: already-cached rows refresh their slots from the kernel
        outputs, and the hottest uncached written rows are admitted (their
        fresh values are free — they are already on device).  Returns
        ``(positions into rows, slots)``."""
        sp = self._space(key, n_keys)
        self._touch(sp, rows, deg)
        uncached = rows[sp.slot_of[rows] < 0]
        if uncached.size:
            self._admit(sp, np.unique(uncached))
        pos = np.flatnonzero(sp.slot_of[rows] >= 0).astype(np.int64)
        return pos, sp.slot_of[rows[pos]].astype(np.int32)

    def prewarm(self, key: Tuple[str, int], n_keys: int, rows: np.ndarray,
                deg: np.ndarray, values: Dict[str, np.ndarray]) -> None:
        """Seed one row space before batch 0 (``CacheConfig.prewarm_rows``).

        ``rows``/``deg`` are the base graph's top-degree rows (unique, any
        order) with their degrees; ``values`` maps store names to arrays
        aligned with ``rows`` holding those rows' *current* state, which
        the owning backend gathers once at construction time.  Runs the
        ordinary touch → admit pipeline, so prewarmed slots are
        indistinguishable from learned ones (same priorities, same
        deterministic eviction order), then fills the admitted slots'
        device stores so batch 0 already hits."""
        rows = np.asarray(rows, np.int64)
        if not rows.size:
            return
        sp = self._space(key, n_keys)
        self._touch(sp, rows, deg)
        got = self._admit(sp, np.unique(rows))
        if not got.size:
            return
        pos_of = {int(r): i for i, r in enumerate(rows)}
        pos = np.array([pos_of[int(r)] for r in got], np.int64)
        slots = sp.slot_of[got].astype(np.int32)
        for name, vals in values.items():
            self.update_store(key, name,
                              slots, np.asarray(vals, np.float32)[pos])

    def invalidate(self, key: Tuple[str, int], rows: np.ndarray) -> None:
        """Value-independent invalidation of cached rows (feature scatters
        and the policy's chunked host scatters route here)."""
        sp = self._spaces.get(key)
        if sp is None or not np.asarray(rows).size:
            return
        rows = np.asarray(rows, np.int64)
        slots = sp.slot_of[rows]
        slots = np.unique(slots[slots >= 0])
        if not slots.size:
            return
        sp.row_of[slots] = -1
        sp.slot_of[rows] = -1
        # keep pop() = smallest-free deterministic after arbitrary frees
        sp.free = sorted(set(sp.free) | set(int(s) for s in slots),
                         reverse=True)
        self.stats.invalidated_rows += int(slots.size)

    def invalidate_all(self) -> None:
        """Full invalidation (refresh / policy-forced full recompute: the
        whole state is rewritten host-side)."""
        n = sum(int((sp.row_of >= 0).sum()) for sp in self._spaces.values())
        self.stats.invalidated_rows += n
        self._spaces.clear()

    # ------------------------------------------------------------------ #
    # device stores (dispatch time)
    # ------------------------------------------------------------------ #
    def store(self, key: Tuple[str, int], name: str, trailing: Tuple[int, ...]) -> torch.Tensor:
        """The device slot store for (space, tensor) — lazily allocated
        ``[capacity, ·]`` zeros on first use (capacity is fixed, rows
        recycle through the deterministic eviction order)."""
        sp = self._spaces[key]
        st = sp.stores.get(name)
        if st is None:
            st = sp.stores[name] = torch.zeros((self.capacity,) + tuple(trailing),
                                               dtype=torch.float32, device=self.device)
        return st

    def update_store(self, key: Tuple[str, int], name: str, slots, values) -> None:
        """Write fresh row values into their slots, in place on the device
        (``store[slots] = values``).  ``slots`` and ``values`` are tensors
        on the store's device or host arrays; the slots of one call are
        unique, so the write is deterministic."""
        st = self.store(key, name, tuple(values.shape[1:]))
        slots = torch.as_tensor(slots).to(self.device)
        st[slots.long()] = torch.as_tensor(values, dtype=torch.float32).to(self.device)

    def state_bytes(self) -> int:
        """Device bytes pinned by all slot stores (telemetry)."""
        return sum(st.numel() * st.element_size() for sp in self._spaces.values()
                   for st in sp.stores.values())
