"""Sharding of the port's streaming engine: the halo-exchange knobs
(:mod:`repro_torch.dist.sharding`) and the collectives the row-sharded
backends run between shards (:mod:`repro_torch.dist.exchange`)."""
from repro_torch.dist.exchange import DistExchange, HaloExchange, LoopbackExchange
from repro_torch.dist.sharding import CommsConfig, rotation_perm, stream_shards

__all__ = ["CommsConfig", "rotation_perm", "stream_shards", "HaloExchange",
           "LoopbackExchange", "DistExchange"]
