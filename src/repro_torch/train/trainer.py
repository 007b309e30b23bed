"""End-to-end trainer: synthetic LM data, microbatch gradient accumulation,
AdamW + WSD, the fault-tolerant runner, optional gradient compression — the
counterpart of ``repro.train.trainer``, run eagerly on one device (the card
unless the caller asks for the CPU).

Attention's gradient comes from ``flash_attention``'s backward kernels on the
card and from their plain versions on the CPU; the rest from autograd."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, set_fp32_precision
from repro_torch.models import init_model, loss_fn
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import compress_grads, init_state
from repro_torch.train.fault import FaultConfig, FaultTolerantRunner
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 64
    microbatches: int = 1  # gradient accumulation
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    compression: Optional[str] = None  # None | int8 | topk
    log_every: int = 10


def synthetic_batch(cfg: ArchConfig, tcfg: TrainConfig, step: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic-in-step synthetic LM data (replayable on rollback), the
    reference's tokens from the same numpy generator: next token = (token ·
    31 + position) mod min(vocab, 97); labels are the tokens shifted by one.
    An encoder-decoder config also gets ``frames`` [B, S, d_frontend], a vlm
    ``patches`` [B, num_patches, d_frontend], normal draws of the same
    generator after the tokens, as the reference's."""
    rng = np.random.default_rng(tcfg.seed + step)
    vocab_eff = min(cfg.vocab_size, 97)
    b, s = tcfg.batch, tcfg.seq_len
    toks = [rng.integers(0, vocab_eff, (b, 1))]
    for i in range(s - 1):
        toks.append((toks[-1] * 31 + i) % vocab_eff)
    tokens = np.concatenate(toks, axis=1).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)
    dev = resolve_device(device)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    if cfg.encdec:
        frames = rng.normal(size=(b, s, cfg.d_frontend)).astype(np.float32)
        batch["frames"] = torch.from_numpy(frames).to(dev)
    if cfg.num_patches:
        patches = rng.normal(size=(b, cfg.num_patches, cfg.d_frontend)).astype(np.float32)
        batch["patches"] = torch.from_numpy(patches).to(dev)
    return batch


def value_and_grad(params, cfg: ArchConfig, batch):
    """``(loss, metrics, grads)`` of :func:`repro_torch.models.loss_fn`: the
    loss and metrics detached, the grads a tree like ``params``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, iter(leaves)), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, iter(grads)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Trainer:
    """``Trainer(cfg, tcfg, opt_cfg, device="cuda", params=None)``: random
    parameters from a ``torch.Generator`` on ``device`` seeded with
    ``tcfg.seed`` unless ``params`` are given (e.g. bridged from the
    reference with ``lm_params_from_numpy``)."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig, opt_cfg: OptConfig = None, *,
                 device="cuda", params=None):
        set_fp32_precision()
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or OptConfig(warmup_steps=10, stable_steps=tcfg.steps,
                                            decay_steps=10)
        self.device = resolve_device(device)
        if params is None:
            params = init_model(torch.Generator(device=self.device).manual_seed(tcfg.seed), cfg)
        comp = init_state(params) if tcfg.compression else None
        self.state = {"params": params, "opt": adamw_init(params), "comp": comp,
                      "step": torch.zeros((), dtype=torch.int32, device=self.device)}
        #: one record a step of :meth:`train` without checkpoints: step, loss,
        #: synchronised host seconds
        self.history: list = []

    # ------------------------------------------------------------------ #
    def step(self, state, batch):
        """One optimizer step: ``(new_state, loss)``; ``state`` is not changed."""
        params, opt = state["params"], state["opt"]
        mb = self.tcfg.microbatches
        if mb > 1:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(mb):
                sub = {k: x[i * (x.shape[0] // mb):(i + 1) * (x.shape[0] // mb)]
                       for k, x in batch.items()}
                l_i, _, g_i = value_and_grad(params, self.cfg, sub)
                loss = loss + l_i / mb
                grads = tree_map(lambda a, g: a + g.float() / mb, grads, g_i)
        else:
            loss, _, grads = value_and_grad(params, self.cfg, batch)

        comp = state["comp"]
        if comp is not None:
            grads, comp, _ = compress_grads(grads, comp, method=self.tcfg.compression)
        new_params, new_opt, _ = adamw_update(grads, opt, params, self.opt_cfg)
        return {"params": new_params, "opt": new_opt, "comp": comp,
                "step": state["step"] + 1}, loss

    # ------------------------------------------------------------------ #
    def train(self) -> Dict[str, Any]:
        data = lambda s: synthetic_batch(self.cfg, self.tcfg, s, self.device)  # noqa: E731
        if self.tcfg.checkpoint_dir:
            ckpt = CheckpointManager(self.tcfg.checkpoint_dir, keep=3)
            runner = FaultTolerantRunner(
                self.step, ckpt, FaultConfig(checkpoint_every=self.tcfg.checkpoint_every))
            self.state, step = runner.run(self.state, data, self.tcfg.steps, device=self.device)
            return {"steps": step, "restarts": runner.restarts}
        losses = []
        t0 = time.perf_counter()
        for s in range(self.tcfg.steps):
            batch = data(s)
            t_step = time.perf_counter()
            self.state, loss = self.step(self.state, batch)
            _sync(self.device)
            self.history.append({"step": s, "loss": loss,
                                 "seconds": time.perf_counter() - t_step})
            if s % self.tcfg.log_every == 0 or s == self.tcfg.steps - 1:
                losses.append(float(loss))
        return {"losses": losses, "steps": self.tcfg.steps,
                "wall_s": time.perf_counter() - t0}
