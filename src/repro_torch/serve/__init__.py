"""Serving surface of the port: the engine factory (``create_engine``), the
online read/write front-end with versioned snapshot reads
(``ServingFrontend``), the §V-C chunked scheduler (``serve.scheduler``), the
host staging pipeline (``serve.staging``), the device hot-row cache
(``serve.hotcache``) and the host-resident engine facades
(``serve.offload``); ``CommsConfig`` configures the sharded backends.

Exports resolve lazily (PEP 562): ``repro_torch.core.backend`` imports
``repro_torch.serve.staging`` at module load, so an eager ``from .api import
…`` here would close an import cycle through the partially-initialised core
package."""
from __future__ import annotations

_API = ("BACKENDS", "PORTED_BACKENDS", "EngineConfig", "ChunkedRTECEngine",
        "create_engine", "resolve_device", "serving_frontend")
_FRONTEND = ("ServingFrontend", "ReadTicket", "ReadRejectedError", "StaleVersionError")
_CACHE = ("CacheConfig", "CacheStats", "HotRowCache")
_STAGING = ("StagingConfig", "StagingStats", "HostStagingPipeline")
_OFFLOAD = ("OffloadedRTECEngine", "ShardedOffloadRTECEngine", "TransferStats")
_AFFECTED = ("FusionConfig",)
_DIST = ("CommsConfig",)

__all__ = list(_API + _FRONTEND + _CACHE + _STAGING + _OFFLOAD + _AFFECTED + _DIST)


def __getattr__(name: str):
    if name in _API:
        from repro_torch.serve import api as mod
    elif name in _FRONTEND:
        from repro_torch.serve import frontend as mod
    elif name in _CACHE:
        from repro_torch.serve import hotcache as mod
    elif name in _STAGING:
        from repro_torch.serve import staging as mod
    elif name in _OFFLOAD:
        from repro_torch.serve import offload as mod
    elif name in _AFFECTED:
        from repro_torch.core import affected as mod
    elif name in _DIST:
        from repro_torch.dist import sharding as mod
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(mod, name)
