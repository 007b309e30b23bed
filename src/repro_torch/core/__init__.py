"""Core incremental-RTEC framework of the port, in PyTorch."""

from repro_torch.core.backend import (
    BatchStats,
    ChunkedBackend,
    CommsStats,
    DeviceBackend,
    OffloadBackend,
    ShardBackend,
    ShardedOffloadBackend,
    StateBackend,
    StreamOrchestrator,
    StreamStats,
    TransferStats,
)
from repro_torch.core.baselines import RTECUER, MTECPeriod, RTECFull, RTECSample
from repro_torch.core.conditions import ConditionReport, certify, validate_registration
from repro_torch.core.engine import RTECEngine
from repro_torch.core.full import LayerState, full_forward
from repro_torch.core.models import ALL_MODELS, make_model
from repro_torch.core.odec import odec_query, query_cone
from repro_torch.core.operators import GNNModel
from repro_torch.core.params import params_from_numpy
from repro_torch.core.sharded_engine import ShardedRTECEngine
from repro_torch.core.policy import (
    MODES,
    ExecutionPolicy,
    PlanCostEstimate,
    PolicyDecision,
    estimate_plan_cost,
    make_policy,
)

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
    "OffloadBackend",
    "ChunkedBackend",
    "ShardBackend",
    "ShardedOffloadBackend",
    "ShardedRTECEngine",
    "CommsStats",
    "TransferStats",
    "full_forward",
    "LayerState",
    "RTECFull",
    "RTECSample",
    "RTECUER",
    "MTECPeriod",
    "odec_query",
    "query_cone",
    "certify",
    "validate_registration",
    "ConditionReport",
    "MODES",
    "ExecutionPolicy",
    "PlanCostEstimate",
    "PolicyDecision",
    "estimate_plan_cost",
    "make_policy",
]
