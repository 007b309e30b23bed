"""Serving surface of the port: the engine factory (``create_engine``)."""

from repro_torch.serve.api import BACKENDS, EngineConfig, create_engine, resolve_device

__all__ = ["BACKENDS", "EngineConfig", "create_engine", "resolve_device"]
