"""The collectives between the shards of a row-sharded backend: the port's
counterpart of ``shard_map``'s ``lax.psum`` and ``lax.ppermute`` in
``repro.core.incremental.sharded_step_fn``.

A :class:`HaloExchange` runs some of the ``S`` shards in this process (its
``local_shards``) and moves tensors between all of them.  Each method takes
one tensor per local shard, in ``local_shards`` order, and returns one per
local shard:

* :meth:`~HaloExchange.psum` — every shard receives the sum over all
  shards.  The halo buffer is a sum over the one-hot ownership partition
  (each position has one owner, the others contribute exact zeros), so
  every order of the sum gives the owner's bytes;
* :meth:`~HaloExchange.rotate` — shard ``j``'s tensor goes to shard
  ``(j + k) mod S`` (one rotation round, ``rotation_perm(S, k)``);
* :meth:`~HaloExchange.all_gather` — the ``[S, ·]`` stack of every shard's
  block (state views and serving reads).

Two implementations:

* :class:`LoopbackExchange` — all ``S`` shards in one process on one
  device; a round is an indexed pick, the sum runs in shard order 0 … S−1.
  ``chip_smoke.py`` runs ``S`` logical shards on one card this way.
* :class:`DistExchange` — one shard per ``torch.distributed`` process
  (rank = shard): ``batch_isend_irecv`` for a round, ``all_reduce`` for the
  sum, ``all_gather`` for the stack.  The caller initialises the process
  group (gloo on the CPU, NCCL on cards).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


class HaloExchange:
    """Interface of the collectives a row-sharded backend runs."""

    num_shards: int
    local_shards: Tuple[int, ...]

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def rotate(self, parts: Sequence[torch.Tensor], k: int) -> List[torch.Tensor]:
        raise NotImplementedError

    def all_gather(self, blocks: torch.Tensor) -> torch.Tensor:
        """``blocks`` is ``[len(local_shards), ·]``; returns ``[S, ·]``."""
        raise NotImplementedError


class LoopbackExchange(HaloExchange):
    """All ``num_shards`` shards in this process."""

    def __init__(self, num_shards: int):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self.local_shards = tuple(range(num_shards))

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        total = parts[0]
        for p in parts[1:]:  # fixed shard order
            total = total + p
        return [total] * len(parts)

    def rotate(self, parts: Sequence[torch.Tensor], k: int) -> List[torch.Tensor]:
        s = self.num_shards
        return [parts[(j - k) % s] for j in range(s)]

    def all_gather(self, blocks: torch.Tensor) -> torch.Tensor:
        return blocks


class DistExchange(HaloExchange):
    """One shard per ``torch.distributed`` process: shard = rank, ``S`` =
    world size of the (already initialised) default process group."""

    def __init__(self):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistExchange needs an initialised torch.distributed "
                               "process group")
        self._dist = dist
        self.num_shards = dist.get_world_size()
        self.local_shards = (dist.get_rank(),)

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        (part,) = parts
        total = part.clone()
        self._dist.all_reduce(total)
        return [total]

    def rotate(self, parts: Sequence[torch.Tensor], k: int) -> List[torch.Tensor]:
        (part,) = parts
        dist, s, me = self._dist, self.num_shards, self.local_shards[0]
        send = part.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (me + k) % s),
               dist.P2POp(dist.irecv, recv, (me - k) % s)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [recv]

    def all_gather(self, blocks: torch.Tensor) -> torch.Tensor:
        out = [torch.empty_like(blocks[0]) for _ in range(self.num_shards)]
        self._dist.all_gather(out, blocks[0].contiguous())
        return torch.stack(out)
