"""Serving surface of the port: the engine factory (``create_engine``), the
online read/write front-end with versioned snapshot reads
(``ServingFrontend``), and the §V-C chunked scheduler (``serve.scheduler``)."""

from repro_torch.core.affected import FusionConfig
from repro_torch.serve.api import (
    BACKENDS,
    EngineConfig,
    create_engine,
    resolve_device,
    serving_frontend,
)
from repro_torch.serve.frontend import (
    ReadRejectedError,
    ReadTicket,
    ServingFrontend,
    StaleVersionError,
)

__all__ = [
    "BACKENDS",
    "EngineConfig",
    "create_engine",
    "resolve_device",
    "serving_frontend",
    "FusionConfig",
    "ServingFrontend",
    "ReadTicket",
    "ReadRejectedError",
    "StaleVersionError",
]
