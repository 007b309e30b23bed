"""Halo-exchange knobs of the row-sharded streaming backends.  Mirrors the
GNN part of ``repro.dist.sharding``: :class:`CommsConfig` (with its
validation), :func:`rotation_perm`, and :func:`stream_shards`, the
counterpart of ``stream_mesh``.  The reference's logical-axis rules for the
LM (``ShardingConfig``, ``spec_for_axes`` and the rest) belong to the LM
zoo and are not needed here.

The reference lays the ``S`` shards over a 1-D mesh of ``S`` devices.  The
port runs them through a :class:`~repro_torch.dist.exchange.HaloExchange`:
all ``S`` in one process on one device
(:class:`~repro_torch.dist.exchange.LoopbackExchange`), or one shard per
``torch.distributed`` process (:class:`~repro_torch.dist.exchange.DistExchange`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

#: halo exchange strategies for the row-sharded streaming backends
_HALO_MODES = ("psum", "ppermute", "auto")


@dataclasses.dataclass(frozen=True)
class CommsConfig:
    """Halo-exchange strategy for the row-sharded streaming backends.

    ``halo`` — how each layer's frontier halo moves between shards:

    * ``"psum"``     — the global broadcast: every shard contributes its
      owned halo rows to one sum over shards, so each shard's bytes scale
      with the *global* frontier.
    * ``"ppermute"`` — plan-time per-consumer partitioning: ``S − 1``
      rotation rounds deliver each halo row only to the shards that gather
      it, so traffic scales with each shard's own halo.  On the hybrid
      host-resident backend this also enables the device-served new-view
      patch (no staged ``h_new`` copy).
    * ``"auto"``     — resolved once at backend construction: ``ppermute``
      when there is more than one shard, else ``psum``.

    ``pair_capacity_hysteresis`` — headroom multiplier on the
    per-(owner, consumer) pair capacities before bucketing (``0.5`` pads
    each pair table 1.5× above its high-water mark).

    The reference's third knob, ``use_pallas_delta``, chose its Pallas
    step-1 scatter over XLA's; the port always runs step 1 in its
    ``delta_agg`` kernel, so it has no such knob.
    """

    halo: str = "auto"
    pair_capacity_hysteresis: float = 0.0

    def __post_init__(self):
        if self.halo not in _HALO_MODES:
            raise ValueError(
                f"CommsConfig.halo must be one of {_HALO_MODES}, got {self.halo!r}")
        if self.pair_capacity_hysteresis < 0:
            raise ValueError(
                "CommsConfig.pair_capacity_hysteresis must be >= 0, "
                f"got {self.pair_capacity_hysteresis!r}")

    def resolve_halo(self, num_shards: int) -> str:
        """Collapse ``"auto"`` for a concrete shard count (once per backend,
        so the mode never flips batch to batch)."""
        if self.halo != "auto":
            return self.halo
        return "ppermute" if num_shards > 1 else "psum"


def rotation_perm(num_shards: int, k: int = 1) -> List[Tuple[int, int]]:
    """(source, destination) pairs of a rotate-by-``k`` exchange round.

    One full exchange over ``S`` shards is ``S − 1`` rounds (``k = 1 …
    S−1``); the pair owner → consumer ``(o, c)`` rides round
    ``(c − o) mod S``."""
    return [(j, (j + k) % num_shards) for j in range(num_shards)]


def stream_shards(num_shards: Optional[int] = None, exchange=None) -> int:
    """Shard count of a row-sharded backend, checked: the counterpart of the
    reference's ``stream_mesh``.

    With an ``exchange`` the count is the exchange's own (``num_shards``, if
    given, must agree); otherwise ``num_shards`` (default 1) logical shards
    run through a loopback exchange in one process."""
    if exchange is not None:
        if num_shards is not None and num_shards != exchange.num_shards:
            raise ValueError(f"num_shards={num_shards} but the exchange runs "
                             f"{exchange.num_shards} shards")
        return exchange.num_shards
    n = 1 if num_shards is None else int(num_shards)
    if n < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return n
