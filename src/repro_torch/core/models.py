"""The Table-II model zoo, decoupled for incremental RTEC, in PyTorch.

Mirrors ``repro.core.models`` operator by operator: the same eleven models,
flags, empty-neighbourhood guards (``_COUNT_THRESH``, ``_ATTN_THRESH``) and
the ±30 attention-logit clip.  Parameter dictionaries use the same keys and
shapes, so ``repro_torch.core.params.params_from_numpy`` can carry the
reference's weights over unchanged.

One-hot relation encodings are built by comparison with ``arange`` rather
than ``torch.nn.functional.one_hot``, which validates its input against the
class count and so waits for the device.

Every dense product of a message or update function goes through
:func:`~repro_torch.kernels.row_linear.row_linear`, whose rows do not
depend on how many rows share the call: the engine's bitwise invariants
(fused ≡ serial, device ≡ offload, sharded ≡ device, hybrid ≡ offload) put
the same row into products of different sizes.  The relational models'
per-record weight stacks (``h_u[e] @ Wr[et[e]]``) take one such product per
relation and keep each record's own (:func:`_relation_linear`).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.operators import GNNModel, glorot, normal
from repro_torch.kernels.row_linear import row_linear

_EPS = 1e-12
# Empty-neighborhood guard thresholds: when a context sum drains to ~0 (all
# in-edges deleted), x/nct would amplify the fp residue of ms_cbn⁻¹ by
# 1/eps.  Both ms_cbn and ms_cbn⁻¹ therefore clamp to exactly 0 below the
# threshold — full and incremental paths share the same guard.
_COUNT_THRESH = 0.5  # counts are integers: <0.5 ⟺ empty
_ATTN_THRESH = 1e-10  # attention sums are ≥ exp(-30) ≈ 9e-14 per edge


def _div_guard(x, nct, thresh):
    live = nct > thresh
    return torch.where(live, x / torch.where(live, nct, 1.0), 0.0)


def _mul_guard(x, nct, thresh):
    live = nct > thresh
    return torch.where(live, x * nct, 0.0)


def _one_hot(et, num: int, dtype=torch.float32):
    return (et[:, None] == torch.arange(num, device=et.device)).to(dtype)


def _relation_linear(h, wr, et):
    """``out[e] = h[e] @ wr[et[e]]``: one row-independent product per
    relation, each record keeping its own relation's row."""
    out = row_linear(h, wr[0])
    for r in range(1, wr.shape[0]):
        out = torch.where((et == r)[:, None], row_linear(h, wr[r]), out)
    return out


# ====================================================================== #
# Fully incrementalizable models
# ====================================================================== #
class GCN(GNNModel):
    """msg_local = 1/sqrt(d̃_u); nbr_ctx = count; ms_cbn = x/sqrt(ñct)."""

    name = "gcn"
    src_struct_dependent = True

    def init_params(self, gen, d_in, d_out):
        return {"W": glorot(gen, (d_in, d_out)), "b": torch.zeros(d_out)}

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        return 1.0 / torch.sqrt(s_u + 1.0)

    def edge_term(self, p, mlc, z, et):
        return mlc[:, None] * z

    def ms_cbn(self, p, nct, x):
        return x / torch.sqrt(nct[:, :1] + 1.0)

    def ms_cbn_inv(self, p, nct, x):
        return x * torch.sqrt(nct[:, :1] + 1.0)

    def update(self, p, h_v, a_v):
        return torch.relu(row_linear(a_v, p["W"]) + p["b"])


class GraphSAGE(GNNModel):
    """Mean aggregation decomposed into sum / count (paper §IV-D)."""

    name = "sage"
    update_uses_h = True

    def init_params(self, gen, d_in, d_out):
        return {
            "W_self": glorot(gen, (d_in, d_out)),
            "W_nbr": glorot(gen, (d_in, d_out)),
            "b": torch.zeros(d_out),
        }

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        return torch.ones_like(s_u)

    def edge_term(self, p, mlc, z, et):
        return mlc[:, None] * z

    def ms_cbn(self, p, nct, x):
        return _div_guard(x, nct[:, :1], _COUNT_THRESH)

    def ms_cbn_inv(self, p, nct, x):
        return _mul_guard(x, nct[:, :1], _COUNT_THRESH)

    def update(self, p, h_v, a_v):
        return torch.relu(row_linear(h_v, p["W_self"]) + row_linear(a_v, p["W_nbr"]) + p["b"])


class GIN(GNNModel):
    """Constant message, sum aggregation, MLP update (Fig. 4)."""

    name = "gin"
    update_uses_h = True
    has_ctx = False

    def init_params(self, gen, d_in, d_out):
        dh = max(d_in, d_out)
        return {
            "W1": glorot(gen, (d_in, dh)),
            "b1": torch.zeros(dh),
            "W2": glorot(gen, (dh, d_out)),
            "b2": torch.zeros(d_out),
            "eps": torch.tensor(0.1, dtype=torch.float32),
        }

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        return torch.ones_like(s_u)

    def edge_term(self, p, mlc, z, et):
        return mlc[:, None] * z

    def update(self, p, h_v, a_v):
        x = (1.0 + p["eps"]) * h_v + a_v
        return torch.relu(row_linear(torch.relu(row_linear(x, p["W1"]) + p["b1"]), p["W2"]) + p["b2"])


class CommNet(GNNModel):
    name = "commnet"
    update_uses_h = True
    has_ctx = False

    def init_params(self, gen, d_in, d_out):
        return {"W1": glorot(gen, (d_in, d_out)), "W2": glorot(gen, (d_in, d_out))}

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        return torch.ones_like(s_u)

    def edge_term(self, p, mlc, z, et):
        return mlc[:, None] * z

    def update(self, p, h_v, a_v):
        return torch.tanh(row_linear(h_v, p["W1"]) + row_linear(a_v, p["W2"]))


class MoNet(GNNModel):
    """K Gaussian kernels over the source embedding (Table II row 1).

    edge_term lays the state out as [E, K*d_in]: kernel-weighted copies of
    h_u; update mixes them with a (K*d_in → d_out) linear layer."""

    name = "monet"
    has_ctx = False

    def __init__(self, kernels: int = 2):
        self.K = kernels

    def agg_dim(self, d_in, d_out):
        return self.K * d_in

    def init_params(self, gen, d_in, d_out):
        return {
            "mu": normal(gen, (self.K, d_in), 0.5),
            "sigma": torch.ones(self.K, d_in),
            "W": glorot(gen, (self.K * d_in, d_out)),
            "b": torch.zeros(d_out),
        }

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        # [E, K] gaussian kernel weights
        diff = h_u[:, None, :] - p["mu"][None, :, :]
        q = torch.sum((diff * p["sigma"][None]) ** 2, dim=-1)
        return torch.exp(-0.5 * q)

    def edge_term(self, p, mlc, z, et):
        # [E,K,1] * [E,1,D] → [E, K*D]
        out = mlc[:, :, None] * z[:, None, :]
        return out.reshape(z.shape[0], -1)

    def update(self, p, h_v, a_v):
        return torch.relu(row_linear(a_v, p["W"]) + p["b"])


class PinSAGE(GNNModel):
    """Importance-weighted (edge-weight α) message with mean decomposition."""

    name = "pinsage"
    update_uses_h = True

    def agg_dim(self, d_in, d_out):
        return d_out

    def init_params(self, gen, d_in, d_out):
        return {
            "Q": glorot(gen, (d_in, d_out)),
            "q": torch.zeros(d_out),
            "W": glorot(gen, (d_in + d_out, d_out)),
            "b": torch.zeros(d_out),
        }

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        # α_uv · σ(Q h_u + q) — [E, d_out]
        return ew[:, None] * torch.relu(row_linear(h_u, p["Q"]) + p["q"])

    def f_nn(self, p, h_u, et):
        return torch.ones((h_u.shape[0], 1), dtype=h_u.dtype, device=h_u.device)

    def edge_term(self, p, mlc, z, et):
        return mlc * z  # z is 1

    def ms_cbn(self, p, nct, x):
        return _div_guard(x, nct[:, :1], _COUNT_THRESH)

    def ms_cbn_inv(self, p, nct, x):
        return _mul_guard(x, nct[:, :1], _COUNT_THRESH)

    def update(self, p, h_v, a_v):
        return torch.relu(row_linear(torch.cat([h_v, a_v], dim=-1), p["W"]) + p["b"])


class RGCN(GNNModel):
    """Relational GCN: per-relation mean, state laid out as [V, R*d_out]."""

    name = "rgcn"
    update_uses_h = True

    def __init__(self, num_relations: int = 3):
        self.R = num_relations

    def agg_dim(self, d_in, d_out):
        return self.R * d_out

    def ctx_dim(self, d_in, d_out):
        return self.R

    def init_params(self, gen, d_in, d_out):
        return {
            "Wr": glorot(gen, (self.R, d_in, d_out)),
            "Wo": glorot(gen, (d_in, d_out)),
            "b": torch.zeros(d_out),
        }

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        return torch.ones_like(s_u)

    def ctx_contrib(self, p, mlc, et):
        # per-relation count: one-hot over relations [E, R]
        return _one_hot(et, self.R)

    def f_nn(self, p, h_u, et):
        return _relation_linear(h_u, p["Wr"], et)

    def edge_term(self, p, mlc, z, et):
        # route W_r h_u into its relation block: [E, R*d_out]
        oh = _one_hot(et, self.R, z.dtype)
        return (oh[:, :, None] * z[:, None, :]).reshape(z.shape[0], -1)

    def ms_cbn(self, p, nct, x):
        v, rd = x.shape
        xr = x.reshape(v, self.R, rd // self.R)
        return _div_guard(xr, nct[:, :, None], _COUNT_THRESH).reshape(v, rd)

    def ms_cbn_inv(self, p, nct, x):
        v, rd = x.shape
        xr = x.reshape(v, self.R, rd // self.R)
        return _mul_guard(xr, nct[:, :, None], _COUNT_THRESH).reshape(v, rd)

    def update(self, p, h_v, a_v):
        d_out = p["Wo"].shape[1]
        s = a_v.reshape(a_v.shape[0], self.R, d_out).sum(dim=1)
        return torch.relu(row_linear(h_v, p["Wo"]) + s + p["b"])


# ====================================================================== #
# Constrained incremental models (destination-dependent messages, §IV-C)
# ====================================================================== #
class GAT(GNNModel):
    """Multi-head attention; softmax decoupled into exp / sum / normalize
    (paper Alg. 2–3).  State a_v is [V, H*dh]; nct_v the per-head attention
    sum [V, H]."""

    name = "gat"
    dest_dependent = True

    def __init__(self, heads: int = 2):
        self.H = heads

    def agg_dim(self, d_in, d_out):
        return d_out  # d_out = H * dh

    def ctx_dim(self, d_in, d_out):
        return self.H

    def init_params(self, gen, d_in, d_out):
        if d_out % self.H:
            raise ValueError(f"d_out={d_out} must be divisible by heads={self.H}")
        dh = d_out // self.H
        return {
            "W": glorot(gen, (d_in, d_out)),
            "a_src": normal(gen, (self.H, dh), 0.1),
            "a_dst": normal(gen, (self.H, dh), 0.1),
        }

    def _logits(self, p, h_u, h_v):
        dh = p["a_src"].shape[1]
        wu = row_linear(h_u, p["W"]).reshape(-1, self.H, dh)
        wv = row_linear(h_v, p["W"]).reshape(-1, self.H, dh)
        lg = torch.sum(wu * p["a_src"][None], -1) + torch.sum(wv * p["a_dst"][None], -1)
        # bounded LeakyReLU keeps exp() in fp32 range
        return torch.clamp(F.leaky_relu(lg, 0.2), -30.0, 30.0)

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        return torch.exp(self._logits(p, h_u, h_v))  # [E, H]

    def ctx_contrib(self, p, mlc, et):
        return mlc  # attention sum

    def f_nn(self, p, h_u, et):
        return row_linear(h_u, p["W"])  # [E, H*dh]

    def edge_term(self, p, mlc, z, et):
        e = z.shape[0]
        zr = z.reshape(e, self.H, -1)
        return (mlc[:, :, None] * zr).reshape(e, -1)

    def ms_cbn(self, p, nct, x):
        v, d = x.shape
        xr = x.reshape(v, self.H, d // self.H)
        return _div_guard(xr, nct[:, :, None], _ATTN_THRESH).reshape(v, d)

    def ms_cbn_inv(self, p, nct, x):
        v, d = x.shape
        xr = x.reshape(v, self.H, d // self.H)
        return _mul_guard(xr, nct[:, :, None], _ATTN_THRESH).reshape(v, d)

    def update(self, p, h_v, a_v):
        return F.elu(a_v)


class AGNN(GNNModel):
    """Attention-free cosine-similarity propagation (Table II row A-GNN)."""

    name = "agnn"
    dest_dependent = True
    has_ctx = False

    def init_params(self, gen, d_in, d_out):
        return {"beta": torch.tensor(1.0, dtype=torch.float32), "W": glorot(gen, (d_in, d_out))}

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        nu = torch.linalg.vector_norm(h_u, dim=-1)
        nv = torch.linalg.vector_norm(h_v, dim=-1)
        cos = torch.sum(h_u * h_v, -1) / torch.clamp_min(nu * nv, _EPS)
        return p["beta"] * cos

    def edge_term(self, p, mlc, z, et):
        return mlc[:, None] * z

    def update(self, p, h_v, a_v):
        return torch.tanh(row_linear(a_v, p["W"]))


class GGCN(GNNModel):
    """Gated GCN: gate = σ(W1 h_u + W2 h_v) elementwise on the message."""

    name = "ggcn"
    dest_dependent = True
    has_ctx = False

    def init_params(self, gen, d_in, d_out):
        return {
            "W1": glorot(gen, (d_in, d_in)),
            "W2": glorot(gen, (d_in, d_in)),
            "W": glorot(gen, (d_in, d_out)),
            "b": torch.zeros(d_out),
        }

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        return torch.sigmoid(row_linear(h_u, p["W1"]) + row_linear(h_v, p["W2"]))  # [E, d_in]

    def edge_term(self, p, mlc, z, et):
        return mlc * z

    def update(self, p, h_v, a_v):
        return torch.tanh(row_linear(a_v, p["W"]) + p["b"])


class RGAT(GNNModel):
    """Relational GAT: per-relation attention; state [V, R*d_out], nct [V, R]."""

    name = "rgat"
    dest_dependent = True

    def __init__(self, num_relations: int = 3):
        self.R = num_relations

    def agg_dim(self, d_in, d_out):
        return self.R * d_out

    def ctx_dim(self, d_in, d_out):
        return self.R

    def init_params(self, gen, d_in, d_out):
        return {
            "Wr": glorot(gen, (self.R, d_in, d_out)),
            "a_src": normal(gen, (self.R, d_out), 0.1),
            "a_dst": normal(gen, (self.R, d_out), 0.1),
        }

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        et = et.long()
        wu = _relation_linear(h_u, p["Wr"], et)
        wv = _relation_linear(h_v, p["Wr"], et)
        lg = torch.sum(wu * p["a_src"][et], -1) + torch.sum(wv * p["a_dst"][et], -1)
        return torch.exp(torch.clamp(F.leaky_relu(lg, 0.2), -30.0, 30.0))  # [E]

    def ctx_contrib(self, p, mlc, et):
        return _one_hot(et, self.R) * mlc[:, None]

    def f_nn(self, p, h_u, et):
        return _relation_linear(h_u, p["Wr"], et)

    def edge_term(self, p, mlc, z, et):
        oh = _one_hot(et, self.R, z.dtype)
        return (oh[:, :, None] * (mlc[:, None] * z)[:, None, :]).reshape(z.shape[0], -1)

    def ms_cbn(self, p, nct, x):
        v, rd = x.shape
        xr = x.reshape(v, self.R, rd // self.R)
        return _div_guard(xr, nct[:, :, None], _ATTN_THRESH).reshape(v, rd)

    def ms_cbn_inv(self, p, nct, x):
        v, rd = x.shape
        xr = x.reshape(v, self.R, rd // self.R)
        return _mul_guard(xr, nct[:, :, None], _ATTN_THRESH).reshape(v, rd)

    def update(self, p, h_v, a_v):
        d_out = p["Wr"].shape[2]
        s = a_v.reshape(a_v.shape[0], self.R, d_out).sum(dim=1)
        return torch.tanh(s)


# ====================================================================== #
# registry
# ====================================================================== #
_REGISTRY: Dict[str, type] = {
    "gcn": GCN,
    "sage": GraphSAGE,
    "gin": GIN,
    "commnet": CommNet,
    "monet": MoNet,
    "pinsage": PinSAGE,
    "rgcn": RGCN,
    "gat": GAT,
    "agnn": AGNN,
    "ggcn": GGCN,
    "rgat": RGAT,
}

ALL_MODELS = list(_REGISTRY)


def make_model(name: str, **kw) -> GNNModel:
    if name not in _REGISTRY:
        raise KeyError(f"unknown GNN model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)
