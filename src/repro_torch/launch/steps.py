"""Step builders: the counterpart of ``repro.launch.steps``'s
``make_train_step``, on one device.  The reference's sharding assembly
(``shardings_for_cell``) comes with the distributed layer (ROADMAP.md Queue 1
item 10g)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.train.optimizer import OptConfig, OptState, adamw_update
from repro_torch.train.trainer import value_and_grad


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig):
    """``train_step(params, opt_state, batch) → (params, opt_state, {"loss",
    "lr", "ce", "aux"})``."""

    def train_step(params, opt_state: OptState, batch):
        loss, metrics, grads = value_and_grad(params, cfg, batch)
        new_params, new_state, lr = adamw_update(grads, opt_state, params, opt_cfg)
        return new_params, new_state, {"loss": loss, "lr": lr, **metrics}

    return train_step
