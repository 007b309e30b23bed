"""Core incremental-RTEC framework of the port, in PyTorch."""

from repro_torch.core.backend import (
    BatchStats,
    DeviceBackend,
    StateBackend,
    StreamOrchestrator,
    StreamStats,
)
from repro_torch.core.engine import RTECEngine
from repro_torch.core.full import LayerState, full_forward
from repro_torch.core.models import ALL_MODELS, make_model
from repro_torch.core.operators import GNNModel
from repro_torch.core.params import params_from_numpy

__all__ = [
    "GNNModel",
    "make_model",
    "ALL_MODELS",
    "params_from_numpy",
    "RTECEngine",
    "BatchStats",
    "StreamStats",
    "StateBackend",
    "StreamOrchestrator",
    "DeviceBackend",
    "full_forward",
    "LayerState",
]
