"""The port's public engine API: one config, one factory.  Mirrors
``repro.serve.api``.

``create_engine("device", EngineConfig(...))`` builds the single-device
incremental engine: a :class:`~repro_torch.core.backend.DeviceBackend`
under a :class:`~repro_torch.core.backend.StreamOrchestrator`, behind the
:class:`~repro_torch.core.engine.RTECEngine` facade.  The other backends of
the reference (offload, sharded, sharded_offload, chunked) are not ported
yet; naming one raises ``NotImplementedError`` (ROADMAP.md, Queue 1 items
8–9, says where each comes).

The engine runs on ``EngineConfig.device``, ``"cuda"`` unless the caller
asks for the CPU; asking for ``"cuda"`` without a card raises.  The factory
computes in float32 with TF32 off: it sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False (process-wide), because TF32
keeps ~3 decimal digits and the engine is held to the full-recompute oracle
at 2e-4.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.backend import DeviceBackend, StreamOrchestrator
from repro_torch.core.engine import RTECEngine
from repro_torch.core.operators import GNNModel, Params
from repro_torch.device import resolve_device, set_fp32_precision
from repro_torch.graph.csr import CSRGraph

#: every backend name the reference's ``create_engine`` accepts
BACKENDS: Tuple[str, ...] = ("device", "offload", "sharded", "sharded_offload", "chunked")
#: the ones the port implements
PORTED_BACKENDS: Tuple[str, ...] = ("device",)


@dataclasses.dataclass
class EngineConfig:
    """Construction knobs of the device backend.

    Required: ``model``, ``graph``, ``x``, and either ``params`` or
    ``dims`` (+ ``seed``) to initialise them from a ``torch.Generator``."""

    model: GNNModel
    graph: CSRGraph
    x: object  # [n, d0] numpy array or tensor
    params: Optional[Sequence[Params]] = None
    #: layer dims for parameter init when ``params`` is None, e.g. [16, 16]
    dims: Optional[Sequence[int]] = None
    seed: int = 0
    refresh_every: int = 0
    #: one fused in-place step per batch; False runs the per-layer reference
    fused: bool = True
    #: where the state lives and the kernels run
    device: str = "cuda"

    def resolved_params(self) -> Sequence[Params]:
        dev = resolve_device(self.device)
        if self.params is not None:
            return [{k: torch.as_tensor(v, dtype=torch.float32).to(dev) for k, v in p.items()}
                    for p in self.params]
        if self.dims is None:
            raise ValueError("EngineConfig needs params or dims")
        gen = torch.Generator().manual_seed(self.seed)
        return self.model.init_layers(gen, list(self.dims), device=dev)


def create_engine(backend: str, config: EngineConfig) -> RTECEngine:
    """Construct a streaming engine for ``backend`` from one config.

    Only ``"device"`` is ported; the reference's other backend names raise
    ``NotImplementedError`` and unknown names ``ValueError``.  Turns TF32
    off (see the module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend not in PORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (see ROADMAP.md, Queue 1); "
            f"ported: {PORTED_BACKENDS}")
    set_fp32_precision()
    dev = resolve_device(config.device)
    params = config.resolved_params()
    x = torch.as_tensor(config.x, dtype=torch.float32).to(dev)
    sb = DeviceBackend(config.model, params, config.graph, x, fused=config.fused)
    orch = StreamOrchestrator(sb, config.graph, refresh_every=config.refresh_every)
    return RTECEngine(sb, orch)
