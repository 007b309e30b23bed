"""AdamW with the WSD (warmup–stable–decay) schedule (MiniCPM
[arXiv:2404.06395]): the counterpart of ``repro.train.optimizer``,
functional over the nested parameter dict.

The state's moments are fp32 trees shaped like the parameters and
``count`` is a 0-d int32 tensor on their device.  Every update runs under
``torch.no_grad()`` and returns new tensors (the old state stays valid, as
the fault runner's rollback expects).  Weight decay follows the
reference's rule ``p.ndim >= 2`` on the stored tensors: the stacked
``[L, d]`` norm gammas are decayed, ``final_norm`` (``[d]``) is not."""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.train.tree import tree_leaves, tree_map, tree_unzip


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # WSD schedule
    warmup_steps: int = 100
    stable_steps: int = 1000
    decay_steps: int = 100
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def wsd_schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Warmup → stable plateau → linear decay to ``min_lr_frac`` (MiniCPM §4);
    fp32, on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    decay_pos = (s - cfg.warmup_steps - cfg.stable_steps) / max(cfg.decay_steps, 1)
    decay = 1.0 - (1.0 - cfg.min_lr_frac) * decay_pos.clamp(0.0, 1.0)
    one = torch.ones_like(s)
    lr = torch.where(s < cfg.warmup_steps, warm,
                     torch.where(s < cfg.warmup_steps + cfg.stable_steps, one, decay))
    return cfg.peak_lr * lr


def adamw_init(params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    device = tree_leaves(params)[0].device
    return OptState(m=zeros, v=tree_map(torch.clone, zeros),
                    count=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, cfg: OptConfig
                 ) -> Tuple[Any, OptState, torch.Tensor]:
    """Returns (new_params, new_state, lr).  Grad clip by global norm."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    lr = wsd_schedule(count, cfg)
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()

    def upd(g, m, v, p):
        # the same operations in the same order as the reference's, each result
        # written into a temporary of this leaf where it can be, so that at most
        # two of the leaf's temporaries are alive beside the new state
        g = g.float() * scale
        m = (cfg.b1 * m).add_((1 - cfg.b1) * g)
        v = (cfg.b2 * v).add_(((1 - cfg.b2) * g).mul_(g))
        del g
        den = (v / c2).sqrt_().add_(cfg.eps)
        step = (m / c1).div_(den)
        del den
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            step.add_(cfg.weight_decay * p.float())
        # p − lr · step, as −(step · lr) + p: the same rounding
        return step.mul_(lr).neg_().add_(p.float()).to(p.dtype), m, v

    new_params, m, v = tree_unzip(tree_map(upd, grads, state.m, state.v, params), 3)
    return new_params, OptState(m=m, v=v, count=count), lr
