"""Fault tolerance for long-running training: the counterpart of
``repro.train.fault`` (host logic and numpy only).

:class:`FaultTolerantRunner` wraps a step function with

  * periodic async checkpoints (atomic, keep-K);
  * divergence detection — a NaN/Inf loss rolls back to the last checkpoint
    (with the data cursor restored, so the bad batch is drawn again);
  * worker-failure handling (``WorkerFailure``) → restart from the last
    checkpoint, optionally onto another device (``CheckpointManager.restore``);
  * straggler reporting — per-worker step-time EMAs; workers slower than
    ``straggler_factor`` × the median are reported.

The cluster's integration points (worker registry, heartbeats) are the
callbacks."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager


class WorkerFailure(RuntimeError):
    """Raised by the environment when a (simulated) worker dies."""


@dataclasses.dataclass
class FaultConfig:
    checkpoint_every: int = 50
    keep: int = 3
    max_restarts: int = 5
    straggler_factor: float = 2.0
    ema: float = 0.9


class StragglerMonitor:
    """Tracks per-worker step-time EMAs and flags outliers."""

    def __init__(self, num_workers: int, cfg: FaultConfig):
        self.cfg = cfg
        self.ema = np.zeros(num_workers)
        self.seen = np.zeros(num_workers, dtype=bool)

    def record(self, worker: int, dt: float) -> None:
        if not self.seen[worker]:
            self.ema[worker] = dt
            self.seen[worker] = True
        else:
            self.ema[worker] = self.cfg.ema * self.ema[worker] + (1 - self.cfg.ema) * dt

    def stragglers(self) -> List[int]:
        if not self.seen.any():
            return []
        med = float(np.median(self.ema[self.seen]))
        return [int(i) for i in
                np.nonzero(self.seen & (self.ema > self.cfg.straggler_factor * med))[0]]


class FaultTolerantRunner:
    def __init__(self, step_fn: Callable,  # (state, batch) -> (state, loss)
                 ckpt: CheckpointManager, cfg: FaultConfig = FaultConfig(),
                 on_restart: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.on_restart = on_restart
        self.restarts = 0
        self.events: List[str] = []

    def run(self, state, data_fn: Callable[[int], Any], num_steps: int, device=None):
        """``data_fn(step)`` must be deterministic in step (replay on rollback)."""
        step = 0
        self.ckpt.save(step, state, blocking=True)
        while step < num_steps:
            try:
                batch = data_fn(step)
                state2, loss = self.step_fn(state, batch)
                loss_v = float(loss)
                if not np.isfinite(loss_v):
                    raise FloatingPointError(f"non-finite loss at step {step}: {loss_v}")
                state = state2
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step, state, blocking=False)
            except (WorkerFailure, FloatingPointError) as e:
                self.restarts += 1
                self.events.append(f"step {step}: {type(e).__name__}: {e}")
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(f"exceeded max_restarts={self.cfg.max_restarts}; "
                                       f"events={self.events}") from e
                self.ckpt.wait()
                state, step = self.ckpt.restore(state, device=device)
                if self.on_restart:
                    self.on_restart(step)
        self.ckpt.wait()
        return state, step
