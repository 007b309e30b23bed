"""Theorem-1 applicability-condition prober, in PyTorch.  Mirrors
``repro.core.conditions`` (the paper's LLM+SMT verifier, re-realized as a
randomized numerical certifier).

For a candidate decoupled model it certifies, over randomized inputs:

  (C1) nbr_ctx associativity — holds by construction here (signed-sum form),
       so ctx contributions are only checked to be well-defined;
  (C2) aggregate associativity — sum, by construction; checked for
       permutation invariance and splits;
  (C3) distributivity of ms_cbn over aggregate:
       ms_cbn(z, x + y) == ms_cbn(z, x) + ms_cbn(z, y);
  (C4) invertibility: ms_cbn_inv(z, ms_cbn(z, x)) == x;
  (C5) destination independence of ms_local (unless the model declares
       ``dest_dependent``, which routes it to constrained processing).

The random inputs come from a seeded ``torch.Generator`` on the CPU (the
reference draws from ``jax.random``) and are moved to ``device`` (the card
unless the caller asks for the CPU), where the operators are probed.  The
error magnitudes differ from the reference's while the verdicts — the
booleans of :class:`ConditionReport` — are the same.  :func:`validate_registration` is
the registration gate: it refuses models whose declared flags contradict
the probes (an undeclared destination dependence would silently corrupt
reuse — the failure mode the paper's SMT check guards against).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.operators import GNNModel


@dataclasses.dataclass
class ConditionReport:
    distributive: bool
    invertible: bool
    aggregate_assoc: bool
    dest_independent: bool
    struct_independent: bool
    max_err: Dict[str, float]

    @property
    def incrementalizable(self) -> bool:
        return self.distributive and self.invertible and self.aggregate_assoc


def _max_abs(t: torch.Tensor) -> float:
    return float(t.abs().max())


def certify(
    model: GNNModel,
    d_in: int = 8,
    d_out: int = 8,
    trials: int = 8,
    seed: int = 0,
    tol: float = 1e-4,
    device="cuda",
) -> ConditionReport:
    """Probe the model's operators on ``device`` over ``trials`` random
    draws; the draws come from a seeded CPU generator, so the same seed gives
    the same inputs on every device."""
    gen = torch.Generator().manual_seed(seed)
    p = {k: v.to(device) for k, v in model.init_params(gen, d_in, d_out).items()}
    agg = model.agg_dim(d_in, d_out)
    ctxd = model.ctx_dim(d_in, d_out)
    errs = {"distributive": 0.0, "invertible": 0.0, "agg_assoc": 0.0, "dest": 0.0, "struct": 0.0}

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(device)

    dest_indep = True
    struct_indep = True
    for _ in range(trials):
        # positive context (counts / attention sums are positive by nature)
        z = (0.5 + 4.5 * torch.rand((4, ctxd), generator=gen)).to(device)
        x, y = normal(4, agg), normal(4, agg)
        # C3 distributivity
        lhs = model.ms_cbn(p, z, x + y)
        rhs = model.ms_cbn(p, z, x) + model.ms_cbn(p, z, y)
        errs["distributive"] = max(errs["distributive"], _max_abs(lhs - rhs))
        # C4 invertibility
        back = model.ms_cbn_inv(p, z, model.ms_cbn(p, z, x))
        errs["invertible"] = max(errs["invertible"], _max_abs(back - x))
        # C2 aggregate associativity: sum over permuted splits
        xs = normal(6, agg)
        s1 = xs.sum(0)
        perm = torch.randperm(6, generator=gen).to(device)
        s2 = xs[perm[:3]].sum(0) + xs[perm[3:]].sum(0)
        errs["agg_assoc"] = max(errs["agg_assoc"], _max_abs(s1 - s2))
        # C5 destination / structural independence of ms_local
        hu, hv1, hv2 = normal(4, d_in), normal(4, d_in), normal(4, d_in)
        su, sv = normal(4).abs() * 3, normal(4).abs() * 3
        ew = torch.ones(4, device=device)
        et = torch.zeros(4, dtype=torch.int32, device=device)
        m1 = model.ms_local(p, hu, hv1, su, sv, ew, et)
        m2 = model.ms_local(p, hu, hv2, su, sv, ew, et)
        d_err = _max_abs(m1 - m2)
        errs["dest"] = max(errs["dest"], d_err)
        if d_err > tol:
            dest_indep = False
        m3 = model.ms_local(p, hu, hv1, su + 1.0, sv, ew, et)
        s_err = _max_abs(m1 - m3)
        errs["struct"] = max(errs["struct"], s_err)
        if s_err > tol:
            struct_indep = False

    return ConditionReport(
        distributive=errs["distributive"] < tol,
        invertible=errs["invertible"] < tol,
        aggregate_assoc=errs["agg_assoc"] < tol,
        dest_independent=dest_indep,
        struct_independent=struct_indep,
        max_err=errs,
    )


def validate_registration(model: GNNModel, **kw) -> ConditionReport:
    """Raise if the model's declared flags contradict the numeric probes."""
    rep = certify(model, **kw)
    if not rep.incrementalizable:
        raise ValueError(
            f"model {model.name!r} fails Theorem-1 conditions: {rep.max_err}"
        )
    if not rep.dest_independent and not model.dest_dependent:
        raise ValueError(
            f"model {model.name!r} has destination-dependent ms_local but does "
            f"not declare dest_dependent — unsafe for incremental reuse"
        )
    if not rep.struct_independent and not model.src_struct_dependent:
        raise ValueError(
            f"model {model.name!r} reads source structure in ms_local but does "
            f"not declare src_struct_dependent"
        )
    return rep
