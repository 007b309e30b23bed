"""Adaptive execution policy: incremental vs chunked-subset vs full recompute.

The port's own copy of ``repro.core.policy`` (numpy only): the same cost
model, weights, tie-breaks, hysteresis band and calibration, so decisions
are bit-for-bit the reference's on the same plans.

The paper's incremental RTEC wins only while the affected subgraph stays
small (InkStream's affected-area blow-up, PAPERS.md): a hub burst or a
delete-heavy batch drives the monotone frontier toward V and the signed
delta-record stream costs more than just recomputing the touched rows — or
the whole graph.  All three execution shapes already exist behind the
:class:`~repro_torch.core.backend.StateBackend` protocol; this module adds the
plan-time *choice*:

* :func:`estimate_plan_cost` — a :class:`PlanCostEstimate` derived from one
  Alg.-4 :class:`~repro_torch.core.affected.BatchPlan` and its degree tables.
  Everything is a deterministic integer count (record counts, per-row
  new-graph in-degrees, staged rows/bytes per mode) — no state values, no
  timings — so decisions are reproducible and CI can gate them exactly.
* :class:`ExecutionPolicy` — per batch, scores the three modes with the
  estimate and a small per-mode weight model, and returns a
  :class:`PolicyDecision`.  ``force_mode`` pins the decision (a single mode
  for a whole stream, or a per-batch schedule), which is how the bitwise
  policy≡forced equivalence tests and the best-fixed-mode CI baselines are
  built.

The cost model (edge-work units, value-independent):

* ``incremental`` — the signed delta records plus the constrained-branch
  full edges the plan would execute, plus one unit per written row.  The
  smallest raw count by construction (only changed contributions are
  touched), but the most expensive *per edge*: every record is a
  random-access gather + scatter-add (``incremental_weight``).
* ``chunked`` — Σ over layers of the *new-graph in-degree* of the planned
  out rows: constrained recompute of each affected row re-aggregates its
  whole in-neighborhood through the §V-C chunked scheduler, in dense
  gathered segments (``chunked_weight``, between the two).
* ``full`` — ``L·|E(g_new)|`` plus one unit per row: a dense
  :func:`~repro_torch.core.full.full_forward` over the post-batch graph.  Always
  an upper bound on chunked in raw edges, but the cheapest per edge
  (``full_weight``) — at frontier saturation the policy flips to it.

:class:`~repro_torch.core.backend.StreamOrchestrator` consults the policy between
graph apply and backend planning, records the decision in
``BatchStats.mode``/``est_edges`` (aggregated into ``StreamStats``), and
executes chunked/full batches through three substrate-generic backend
primitives (``apply_feature_updates`` / ``layer_input_host`` /
``scatter_layer_rows``) so every backend supports every mode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.affected import BatchPlan

#: execution modes, in tie-break preference order (cheapest-to-switch first)
MODES = ("incremental", "chunked", "full")

#: Default per-edge weights — the relative cost of one unit of edge-work in
#: each execution shape.  A signed delta record is a random-access gather +
#: scatter-add plus index bookkeeping (the most expensive per-edge shape);
#: the §V-C chunked scheduler re-gathers each affected row's whole
#: in-neighborhood through compact remap tables and pays per-chunk staging
#: but aggregates in dense segments; full_forward is one dense segment-sum
#: over CSR (the cheapest per edge).  The 2 : 1.5 : 1 ratio puts the
#: incremental→chunked flip where changed contributions cover ~3/4 of the
#: affected rows' in-edges, and the chunked→full flip where the affected
#: subgraph covers ~2/3 of all in-edges.
DEFAULT_INCREMENTAL_WEIGHT = 2.0
DEFAULT_CHUNKED_WEIGHT = 1.5
DEFAULT_FULL_WEIGHT = 1.0


@dataclasses.dataclass(frozen=True)
class PlanCostEstimate:
    """Deterministic per-mode cost counts for one batch plan.

    All fields derive from the Alg.-4 plan and its degree tables at plan
    time (value-independent, host-only): the estimate can be computed —
    and the mode decided — while the previous batch still executes."""

    inc_edges: int  #: signed records + constrained-branch edges (incremental)
    chunked_edges: int  #: Σ_l new-graph in-degree of the live out rows
    full_edges: int  #: L · |E(g_new)|
    affected_rows: int  #: Σ_l live out rows (rows written by inc/chunked)
    frontier_rows: int  #: final-layer live out rows (serving write set)
    n: int  #: vertices
    L: int  #: layers
    row_bytes: int  #: bytes per staged state row (h + a + nct, float32)

    def edges(self, mode: str) -> int:
        """Edge-work the mode would execute (raw counts, unweighted)."""
        return {"incremental": self.inc_edges, "chunked": self.chunked_edges,
                "full": self.full_edges}[mode]

    def staged_rows(self, mode: str) -> int:
        """State rows the mode moves between tiers (host↔device staging for
        the offload substrates; scatter volume for the resident ones)."""
        if mode == "incremental":
            # per layer: gather need_h (~affected + sources) + scatter out
            return 2 * self.affected_rows + min(self.inc_edges,
                                                self.n * self.L)
        if mode == "chunked":
            # each affected row plus its gathered in-neighborhood
            return self.affected_rows + self.chunked_edges
        return self.n * (self.L + 1)  # full: every layer state rewritten

    def staged_bytes(self, mode: str) -> int:
        return self.staged_rows(mode) * self.row_bytes

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def estimate_plan_cost(plan: BatchPlan, row_bytes: int = 0) -> PlanCostEstimate:
    """Build a :class:`PlanCostEstimate` from one Alg.-4 plan.

    ``chunked_edges`` sums the **new-graph** in-degree over each layer's
    live out rows — the §V-C scheduler recomputes exactly these rows from
    their full post-batch in-neighborhoods.  ``full_edges`` is the dense
    L-layer pass over the same degree table."""
    inc = plan.total_inc_edges() + plan.total_full_edges()
    deg_new = plan.deg_new[:-1]  # [n] (drop the scratch slot)
    n = int(deg_new.shape[0])
    L = len(plan.layers)
    chunked = 0
    affected = 0
    frontier = 0
    for lp in plan.layers:
        rows = np.unique(lp.out_rows[lp.out_mask].astype(np.int64))
        affected += int(rows.shape[0])
        frontier = int(rows.shape[0])
        if rows.size:
            chunked += int(deg_new[rows].sum())
    full = L * int(deg_new.sum())
    return PlanCostEstimate(
        inc_edges=int(inc), chunked_edges=chunked, full_edges=full,
        affected_rows=affected, frontier_rows=frontier, n=n, L=L,
        row_bytes=int(row_bytes),
    )


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    """One batch's mode choice plus the evidence it was made on."""

    mode: str
    estimate: PlanCostEstimate
    costs: Dict[str, float]  #: weighted edge-work per mode
    forced: bool = False  #: True when ``force_mode`` pinned the choice

    @property
    def est_edges(self) -> int:
        """Raw edge-work of the chosen mode (``StreamStats`` accounting)."""
        return self.estimate.edges(self.mode)


class ExecutionPolicy:
    """Plan-time per-batch mode selection over the three execution shapes.

    Cost of each mode is its raw edge-work plus one unit per written row,
    scaled by a per-mode weight; the argmin wins, ties resolved in
    :data:`MODES` order (incremental preferred — it is the only mode that
    keeps the serving undo log and the plan/execute overlap intact).

    ``force_mode`` pins decisions instead of scoring: a mode name applies
    to every batch (the fixed-mode CI baselines), a sequence is consumed
    one entry per batch (the bitwise policy≡forced equivalence tests replay
    an adaptive run's recorded decisions through it).  Estimates are still
    computed and recorded, so forced runs report the same ``est_edges``
    accounting as adaptive ones.

    ``hysteresis`` adds a relative switching band: after the
    first batch, the policy stays on the previously chosen mode unless the
    cheapest mode is at least ``hysteresis`` cheaper *relative to the
    previous mode's current cost* — i.e. it switches only when
    ``costs[best] < (1 - hysteresis) * costs[prev]``.  With the default
    ``0.0`` the argmin is taken every batch (the plain argmin, and the
    behavior the exact adversarial CI gates pin); a band of 0.1–0.3 damps
    mode flapping on regimes that oscillate around a cost crossover while
    still following genuine regime shifts.  Forced decisions bypass the
    band entirely and do not update its notion of "previous mode".

    ``calibrate`` turns on online cost-weight calibration: the
    orchestrator feeds each executed batch's measured wall back through
    :meth:`observe`, which maintains a per-mode cost-per-work-unit EMA
    (``calibrate_alpha``); :meth:`effective_weights` then blends the
    static weights with the measured ratios (``calibrate_blend``,
    rescaled so the blend perturbs *ratios*, not magnitudes) and
    :meth:`costs` scores with the blend.  With the default ``False`` the
    static 2.0/1.5/1.0 model is used untouched — bit-for-bit the
    deterministic decision surface the CI gates pin; calibration is the
    opt-in hardware-adaptive variant (wall times are nondeterministic, so
    a calibrated run's decisions are not CI-gateable by construction).
    """

    def __init__(
        self,
        incremental_weight: float = DEFAULT_INCREMENTAL_WEIGHT,
        chunked_weight: float = DEFAULT_CHUNKED_WEIGHT,
        full_weight: float = DEFAULT_FULL_WEIGHT,
        force_mode: Union[None, str, Sequence[str]] = None,
        hysteresis: float = 0.0,
        calibrate: bool = False,
        calibrate_alpha: float = 0.25,
        calibrate_blend: float = 0.5,
    ):
        self.weights = {"incremental": float(incremental_weight),
                        "chunked": float(chunked_weight),
                        "full": float(full_weight)}
        if isinstance(force_mode, str):
            _check_mode(force_mode)
        elif force_mode is not None:
            force_mode = tuple(force_mode)
            for m in force_mode:
                _check_mode(m)
        if not 0.0 <= float(hysteresis) < 1.0:
            raise ValueError(
                f"hysteresis must be in [0, 1), got {hysteresis!r}")
        if not 0.0 <= float(calibrate_blend) <= 1.0:
            raise ValueError(
                f"calibrate_blend must be in [0, 1], got {calibrate_blend!r}")
        if not 0.0 < float(calibrate_alpha) <= 1.0:
            raise ValueError(
                f"calibrate_alpha must be in (0, 1], got {calibrate_alpha!r}")
        self.force_mode = force_mode
        self.hysteresis = float(hysteresis)
        self.calibrate = bool(calibrate)
        self.calibrate_alpha = float(calibrate_alpha)
        self.calibrate_blend = float(calibrate_blend)
        #: per-mode measured cost-per-work-unit EMA (None until observed)
        self._ema: Dict[str, Optional[float]] = {m: None for m in MODES}
        self._prev_mode: Optional[str] = None
        self.decisions: Dict[str, int] = {m: 0 for m in MODES}
        self.history: List[PolicyDecision] = []

    # ------------------------------------------------------------------ #
    @staticmethod
    def _units(est: PlanCostEstimate, mode: str) -> int:
        """Work units of one mode: raw edge-work + one per written row
        (the unweighted quantity the weights multiply)."""
        per_row = {"incremental": est.affected_rows,
                   "chunked": est.affected_rows,
                   "full": est.n}
        return est.edges(mode) + per_row[mode]

    def effective_weights(self) -> Dict[str, float]:
        """The decision weights actually in force.

        Static (``self.weights``, returned as-is — same dict object, so
        the uncalibrated path is bit-identical to the static model) unless
        ``calibrate=True`` and at least one mode has been measured.  The
        measured EMAs are rescaled so their mean matches the static
        weights' mean over the measured modes — the blend moves the
        *ratios* toward hardware truth without inflating the absolute
        scale — and unmeasured modes keep their static weight."""
        if not self.calibrate:
            return self.weights
        measured = {m: v for m, v in self._ema.items() if v is not None}
        if not measured or sum(measured.values()) <= 0.0:
            return self.weights
        scale = (sum(self.weights[m] for m in measured)
                 / sum(measured.values()))
        b = self.calibrate_blend
        return {m: ((1.0 - b) * self.weights[m]
                    + b * measured[m] * scale) if m in measured
                else self.weights[m]
                for m in MODES}

    def observe(self, decision: PolicyDecision, wall_s: float) -> None:
        """Feed one executed batch's measured wall back into the per-mode
        cost-per-unit EMA.  A strict no-op unless
        ``calibrate=True`` — the static decision surface never moves."""
        if not self.calibrate or wall_s <= 0.0:
            return
        units = self._units(decision.estimate, decision.mode)
        if units <= 0:
            return
        cpu_ = wall_s / units
        prev = self._ema[decision.mode]
        a = self.calibrate_alpha
        self._ema[decision.mode] = (cpu_ if prev is None
                                    else (1.0 - a) * prev + a * cpu_)

    def costs(self, est: PlanCostEstimate) -> Dict[str, float]:
        """Weighted edge-work per mode (the decision surface)."""
        w = self.effective_weights()
        return {m: w[m] * self._units(est, m) for m in MODES}

    def decide(self, plan: BatchPlan) -> PolicyDecision:
        """Score one batch plan and record the decision."""
        est = estimate_plan_cost(plan)
        costs = self.costs(est)
        forced = self.force_mode is not None
        if isinstance(self.force_mode, str):
            mode = self.force_mode
        elif forced:
            i = len(self.history)
            if i >= len(self.force_mode):
                raise ValueError(
                    f"force_mode schedule exhausted after {i} batches")
            mode = self.force_mode[i]
        else:
            mode = min(MODES, key=lambda m: (costs[m], MODES.index(m)))
            # the band only engages when configured: hysteresis=0.0 must
            # reproduce the plain argmin bit-for-bit (exact-tie tie-breaks
            # included) — the adversarial CI gates pin those decisions
            if self.hysteresis > 0.0:
                prev = self._prev_mode
                if (prev is not None and mode != prev
                        and not costs[mode]
                        < (1.0 - self.hysteresis) * costs[prev]):
                    mode = prev  # inside the band: hold the previous mode
            self._prev_mode = mode
        decision = PolicyDecision(mode=mode, estimate=est, costs=costs,
                                  forced=forced)
        self.decisions[mode] += 1
        self.history.append(decision)
        return decision

    def decide_window(self, plan: BatchPlan) -> PolicyDecision:
        """Score a fused window's merged plan as ONE unit.

        Same surface as :meth:`decide` — the merged plan's counters *are*
        the window's total work, so one scoring prices the whole window —
        but bookkeeping differs: the decision is recorded (``decisions`` /
        ``history`` / the hysteresis band's previous mode) only when the
        window is **accepted** (``mode == "incremental"``, the only mode a
        fused dispatch exists for).  A declined window falls back to the
        serial loop, where ``decide`` re-scores each constituent batch
        individually — recording the declined window too would double-count
        it.  Per-batch ``force_mode`` schedules are indexed by logical
        batch and cannot price a window; the orchestrator disables fusion
        for them before ever calling this."""
        est = estimate_plan_cost(plan)
        costs = self.costs(est)
        forced = self.force_mode is not None
        if isinstance(self.force_mode, str):
            mode = self.force_mode
        elif forced:
            raise ValueError(
                "per-batch force_mode schedules cannot score a fused "
                "window; disable fusion for scheduled runs")
        else:
            mode = min(MODES, key=lambda m: (costs[m], MODES.index(m)))
            if self.hysteresis > 0.0:
                prev = self._prev_mode
                if (prev is not None and mode != prev
                        and not costs[mode]
                        < (1.0 - self.hysteresis) * costs[prev]):
                    mode = prev
        decision = PolicyDecision(mode=mode, estimate=est, costs=costs,
                                  forced=forced)
        if mode == "incremental":
            if not forced:
                self._prev_mode = mode
            self.decisions[mode] += 1
            self.history.append(decision)
        return decision


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown execution mode {mode!r}; "
                         f"expected one of {MODES}")


def make_policy(spec: Union[None, str, ExecutionPolicy],
                chunked_weight: float = DEFAULT_CHUNKED_WEIGHT,
                hysteresis: float = 0.0,
                calibrate: bool = False,
                ) -> Optional[ExecutionPolicy]:
    """Resolve an :class:`~repro_torch.serve.api.EngineConfig` policy knob.

    ``None`` → no policy (the pre-policy incremental-only orchestrator
    path, byte-identical behavior); ``"adaptive"`` → cost-model scoring
    with the given switching ``hysteresis`` band and optional online
    weight calibration (``calibrate``); a mode name → that mode forced on
    every batch; an :class:`ExecutionPolicy` instance passes through
    unchanged (``chunked_weight``/``hysteresis``/``calibrate`` ignored)."""
    if spec is None or isinstance(spec, ExecutionPolicy):
        return spec
    if spec == "adaptive":
        return ExecutionPolicy(chunked_weight=chunked_weight,
                               hysteresis=hysteresis, calibrate=calibrate)
    _check_mode(spec)
    return ExecutionPolicy(chunked_weight=chunked_weight, force_mode=spec)
