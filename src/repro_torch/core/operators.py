"""Fine-grained operator decoupling for incremental RTEC (paper §IV-A), in
PyTorch.  Mirrors ``repro.core.operators``.

A GNN layer is decomposed into (Eq. 5–9):

    mlc_uv = ms_local(h_u, h_v, s_u, s_v, w_uv, t_uv)        # edge-wise
    nct_v  = Σ_{u∈N(v)} ctx_contrib(mlc_uv)                  # nbr_ctx (assoc.)
    a_v    = ms_cbn(nct_v, Σ_{u∈N(v)} mlc_uv ⊙ f_nn(h_u))    # distributive
    h_v    = update(h_v, a_v)                                # vertex-wise

``nbr_ctx`` is a *signed sum* of per-edge contributions (``ctx_contrib``),
the associative + invertible form Theorem 1 conditions (1)–(2) require;
``ms_cbn`` is distributive over the sum and invertible in its second
argument (conditions 3–4).  See ``repro.core.operators`` for the full
discussion of the flags below.

Every operator works on tensors of any device and never reads a value back
to the host, so the incremental step can run without a device sync.
Parameters are plain ``dict``s of tensors (one per layer); initialisation
draws from an explicit ``torch.Generator`` on the CPU and moves the result to
the requested device, so the same seed gives the same weights on every
device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

Params = Dict[str, torch.Tensor]


class GNNModel:
    """Base class. Subclasses define the decoupled operators of Table II."""

    name: str = "base"
    dest_dependent: bool = False
    src_struct_dependent: bool = False
    update_uses_h: bool = False
    has_ctx: bool = True  # False → nbr_ctx ≡ 1 (Table II rows with nct = 1)

    # ------------------------------------------------------------------ #
    # shapes
    # ------------------------------------------------------------------ #
    def agg_dim(self, d_in: int, d_out: int) -> int:
        """Dimensionality of the aggregation state a_v for a (d_in→d_out) layer."""
        return d_in

    def ctx_dim(self, d_in: int, d_out: int) -> int:
        """Dimensionality of the neighborhood context nct_v."""
        return 1

    # ------------------------------------------------------------------ #
    # parameters
    # ------------------------------------------------------------------ #
    def init_params(self, gen: torch.Generator, d_in: int, d_out: int) -> Params:
        """One layer's parameters on the CPU, drawn from ``gen``."""
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # decoupled operators — all operate on batched edge/vertex tensors
    # ------------------------------------------------------------------ #
    def ms_local(self, p: Params, h_u, h_v, s_u, s_v, ew, et):
        """Edge-wise local message. [E, ...]"""
        raise NotImplementedError

    def ctx_contrib(self, p: Params, mlc, et):
        """Per-edge contribution to nbr_ctx; summed (signed) by the engine.

        Returns [E, C].  Default: count()."""
        return torch.ones((mlc.shape[0], 1), dtype=torch.float32, device=mlc.device)

    def f_nn(self, p: Params, h_u, et):
        """Source-feature transform. [E, ...]"""
        return h_u

    def edge_term(self, p: Params, mlc, z, et):
        """mlc ⊙ f_nn(h_u) → raw per-edge aggregation contribution [E, agg_dim]."""
        raise NotImplementedError

    def ms_cbn(self, p: Params, nct, x):
        """Apply neighborhood context to (aggregated) messages. Distributive."""
        return x

    def ms_cbn_inv(self, p: Params, nct, x):
        """Inverse of ms_cbn in x (condition 4)."""
        return x

    def update(self, p: Params, h_v, a_v):
        """Vertex-wise update producing h_v^l. [V, d_out]"""
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # convenience
    # ------------------------------------------------------------------ #
    def init_layers(
        self, gen: torch.Generator, dims: Sequence[int], device="cuda"
    ) -> List[Params]:
        """Per-layer parameters for ``dims`` (e.g. ``[d0, d1, d2]``), drawn
        from ``gen`` and moved to ``device``."""
        layers = [self.init_params(gen, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
        return [{k: v.to(device) for k, v in p.items()} for p in layers]


def glorot(gen: torch.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    s = scale * math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(shape, generator=gen, dtype=torch.float32) * s


def normal(gen: torch.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale
