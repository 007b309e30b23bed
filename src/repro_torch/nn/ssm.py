"""Recurrent sequence mixers: Mamba-2-style SSD and xLSTM (mLSTM/sLSTM).

The counterpart of ``repro.nn.ssm``.  The selective scans run in
*chunkwise parallel* form: within a chunk the recurrence becomes masked-decay
matmuls, across chunks a Python loop carries the matrix state (the
reference's ``lax.scan``).  The per-step sequential forms are kept as
oracles (``*_seq``) and as the O(1) decode steps (``*_step``).  None of this
is a TPU kernel in the JAX package (XLA computes its einsums), and none is a
hand-written kernel here: plain ``torch`` products and a step loop.

The arithmetic and its order are the reference's: the fp32 casts, the
identity padding of a length that is not a multiple of the chunk (k = v = 0,
log-decay 0, the mLSTM input gate at the sentinel ``-1e30``, not ``-inf``:
``-inf - -inf`` is NaN), the per-step stabiliser through a cumulative max,
the output cast to ``v``'s dtype.  One difference that no value shows: the
intra-chunk decay matrices take ``exp`` of the exponent with the entries
above the diagonal set to ``-inf`` (0 after ``exp``), where the reference
takes ``where(tri, exp(rel), 0)``; the same values, but the masked entries
no longer put ``0 · inf`` into a gradient when ``exp(rel)`` overflows there.

Shapes: q/k [B, S, H, dk], v [B, S, H, dv], log-decay la [B, S, H] (≤ 0),
optional log input gate li [B, S, H] (mLSTM).  State [B, H, dk, dv].

Under a mesh the entry points (``ssd_chunked``, ``ssd_step``,
``mlstm_chunked``, ``mlstm_step``, ``slstm_seq``, ``slstm_step``,
``causal_conv``) run their bodies (the same names with a leading ``_``) on
each rank's local tensors through :func:`repro_torch.dist.ctx.local_apply`:
every (batch row, head) is independent, so the batch goes over "dp", the
heads over "tp" where they divide (the channels for the depthwise
convolution), and the sequence stays whole; the recurrences' cumulative
sums and maxima and the sLSTM's step loop see plain tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.dist.ctx import local_apply

_F32 = torch.float32
#: logical axes of the recurrences' operands under a mesh (each (batch row,
#: head) is independent; the sequence stays whole): a per-step operand
#: [B, S, H, …], and a state or one step's operand [B, H, …]
_SEQ = ("dp", None, "tp")
_ROW = ("dp", "tp")


def _lower_exp(rel: torch.Tensor) -> torch.Tensor:
    """``exp(rel[b, t, s, h])`` for s ≤ t, 0 above the diagonal."""
    c = rel.shape[1]
    tri = torch.ones(c, c, dtype=torch.bool, device=rel.device).tril()
    return torch.exp(rel.masked_fill(~tri[None, :, :, None], float("-inf")))


def _pad_steps(a: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``a`` [B, S, …] followed by ``pad`` steps filled with ``value``."""
    fill = torch.full((a.shape[0], pad, *a.shape[2:]), value, dtype=a.dtype, device=a.device)
    return torch.cat([a, fill], 1)


# ====================================================================== #
# SSD (scalar-decay linear recurrence): S_t = a_t S_{t-1} + k_tᵀ v_t
#                                       y_t = q_t S_t
# ====================================================================== #
def ssd_seq(q, k, v, la, s0=None):
    """Per-step oracle.  Returns (y [B, S, H, dv], final state)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    state = torch.zeros(b, h, dk, dv, dtype=_F32, device=q.device) if s0 is None else s0
    ys = []
    for t in range(s):
        a = torch.exp(la[:, t])[..., None, None]
        state = a * state + k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
    return torch.stack(ys, 1), state


def _ssd_chunked(q, k, v, la, s0=None, chunk: int = 128):
    """Chunkwise-parallel SSD.  Returns (y [B, S, H, dv], final state).

    Non-multiple lengths are padded with identity steps (k = v = 0, decay
    1): they contribute nothing and leave the carried state untouched."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    pad = (-s) % chunk
    if pad:
        y, st = _ssd_chunked(_pad_steps(q, pad), _pad_steps(k, pad), _pad_steps(v, pad),
                            _pad_steps(la, pad), s0=s0, chunk=chunk)
        return y[:, :s], st
    nc = s // chunk
    qf = q.reshape(b, nc, chunk, h, dk).to(_F32)
    kf = k.reshape(b, nc, chunk, h, dk).to(_F32)
    vf = v.reshape(b, nc, chunk, h, dv).to(_F32)
    laf = la.reshape(b, nc, chunk, h).to(_F32)
    state = torch.zeros(b, h, dk, dv, dtype=_F32, device=q.device) if s0 is None else s0
    ys = []
    for c in range(nc):
        qc, kc, vc = qf[:, c], kf[:, c], vf[:, c]  # [B, c, H, *]
        cum = torch.cumsum(laf[:, c], dim=1)  # [B, c, H]
        total = cum[:, -1]  # [B, H]
        # intra-chunk: L[t, s] = exp(cum_t - cum_s) for s ≤ t
        L = _lower_exp(cum[:, :, None, :] - cum[:, None, :, :])  # [B, t, s, H]
        scores = torch.einsum("bthk,bshk->btsh", qc, kc) * L
        y_intra = torch.einsum("btsh,bshv->bthv", scores, vc)
        # inter-chunk: y += exp(cum_t) q_t S_prev
        y_inter = torch.einsum("bthk,bhkv->bthv", qc * torch.exp(cum)[..., None], state)
        # state update: S = exp(total) S + Σ_s exp(total - cum_s) k_s v_sᵀ
        w = torch.exp(total[:, None] - cum)  # [B, c, H]
        state = torch.exp(total)[..., None, None] * state + torch.einsum(
            "bshk,bshv->bhkv", kc * w[..., None], vc)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(b, s, h, dv)
    return y.to(v.dtype), state


def _ssd_step(state, qt, kt, vt, lat):
    """Single decode step.  state [B, H, dk, dv] (None: zeros); qt/kt [B, H,
    dk], vt [B, H, dv]."""
    if state is None:
        state = torch.zeros(*qt.shape, vt.shape[-1], dtype=_F32, device=qt.device)
    a = torch.exp(lat.to(_F32))[..., None, None]
    state = a * state + kt.to(_F32)[..., :, None] * vt.to(_F32)[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", qt.to(_F32), state)
    return state, y.to(vt.dtype)


# ====================================================================== #
# mLSTM (xLSTM): matrix memory + normalizer + exp input gate, stabilized
#   C_t = f_t C_{t-1} + i_t k_tᵀ v_t ;  n_t = f_t n_{t-1} + i_t k_t
#   h_t = (q_t C_t) / max(|q_t n_t|, exp(-m_t))
# with log-space gates lf = logsigmoid(f̂), li = î and the running max m.
# ====================================================================== #
class MLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, dk, dv]
    n: torch.Tensor  # [B, H, dk]
    m: torch.Tensor  # [B, H]


def mlstm_init_state(b, h, dk, dv, device="cpu") -> MLSTMState:
    return MLSTMState(c=torch.zeros(b, h, dk, dv, dtype=_F32, device=device),
                      n=torch.zeros(b, h, dk, dtype=_F32, device=device),
                      m=torch.full((b, h), -1e30, dtype=_F32, device=device))


def _mlstm_step(st: MLSTMState, qt, kt, vt, lft, lit):
    """One step of the stabilized recurrence: (new state, h_t [B, H, dv])."""
    qt, kt, vt = (a.to(_F32) for a in (qt, kt, vt))
    m_new = torch.maximum(st.m + lft, lit)
    fdec = torch.exp(st.m + lft - m_new)
    iexp = torch.exp(lit - m_new)
    c = fdec[..., None, None] * st.c + iexp[..., None, None] * (
        kt[..., :, None] * vt[..., None, :])
    n = fdec[..., None] * st.n + iexp[..., None] * kt
    num = torch.einsum("bhk,bhkv->bhv", qt, c)
    den = torch.abs(torch.einsum("bhk,bhk->bh", qt, n))
    h_t = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return MLSTMState(c, n, m_new), h_t


def mlstm_seq(q, k, v, lf, li, st: Optional[MLSTMState] = None):
    """Per-step oracle (stabilized exactly as the xLSTM paper)."""
    b, s, h, dk = q.shape
    st = st or mlstm_init_state(b, h, dk, v.shape[-1], q.device)
    ys = []
    for t in range(s):
        st, y = _mlstm_step(st, q[:, t], k[:, t], v[:, t], lf[:, t], li[:, t])
        ys.append(y)
    return torch.stack(ys, 1), st


def _mlstm_chunked(q, k, v, lf, li, st: Optional[MLSTMState] = None, chunk: int = 128):
    """Chunkwise mLSTM with the per-step-exact stabilizer computed through a
    cumulative max.  Non-multiple lengths are padded with identity steps
    (decay 1, input gate -1e30)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    pad = (-s) % chunk
    if pad:
        y, stf = _mlstm_chunked(_pad_steps(q, pad), _pad_steps(k, pad), _pad_steps(v, pad),
                               _pad_steps(lf, pad), _pad_steps(li, pad, -1e30), st=st,
                               chunk=chunk)
        return y[:, :s], stf
    nc = s // chunk
    st = st or mlstm_init_state(b, h, dk, dv, q.device)
    qf = q.reshape(b, nc, chunk, h, dk).to(_F32)
    kf = k.reshape(b, nc, chunk, h, dk).to(_F32)
    vf = v.reshape(b, nc, chunk, h, dv).to(_F32)
    lff = lf.reshape(b, nc, chunk, h).to(_F32)
    lif = li.reshape(b, nc, chunk, h).to(_F32)
    c_st, n_st, m_st = st
    ys = []
    for c in range(nc):
        qc, kc, vc, lic = qf[:, c], kf[:, c], vf[:, c], lif[:, c]
        cum = torch.cumsum(lff[:, c], dim=1)  # Σ_{r≤t} lf_r   [B, c, H]
        total = cum[:, -1]
        # per-step stabilizer: m_t = cum_t + max(m_0, cummax_s≤t(li_s - cum_s))
        zmax = torch.cummax(lic - cum, dim=1).values
        m_t = cum + torch.maximum(m_st[:, None], zmax)  # [B, c, H]
        # intra contributions: D[t, s] = exp(cum_t - cum_s + li_s - m_t), s ≤ t
        D = _lower_exp(cum[:, :, None, :] - cum[:, None, :, :] + lic[:, None, :, :]
                       - m_t[:, :, None, :])
        scores = torch.einsum("bthk,bshk->btsh", qc, kc) * D
        num_intra = torch.einsum("btsh,bshv->bthv", scores, vc)
        # the normalizer's contribution: Σ_s D[t, s] k_s
        n_intra = torch.einsum("btsh,bshk->bthk", D, kc)
        # inter: decay of the old state to step t: exp(cum_t + m_0 - m_t)
        dec = torch.exp(cum + m_st[:, None] - m_t)  # [B, c, H]
        num_inter = torch.einsum("bthk,bhkv->bthv", qc * dec[..., None], c_st)
        n_t = n_intra + dec[..., None] * n_st[:, None]
        num = num_intra + num_inter
        den = torch.abs(torch.einsum("bthk,bthk->bth", qc, n_t))
        ys.append(num / torch.maximum(den, torch.exp(-m_t))[..., None])
        # carry update (end of chunk, stabilized at m_end)
        m_end = m_t[:, -1]
        w = torch.exp(total[:, None] - cum + lic - m_end[:, None])  # [B, c, H]
        carry = torch.exp(total + m_st - m_end)
        c_st = carry[..., None, None] * c_st + torch.einsum("bshk,bshv->bhkv",
                                                           kc * w[..., None], vc)
        n_st = carry[..., None] * n_st + torch.einsum("bsh,bshk->bhk", w, kc)
        m_st = m_end
    y = torch.stack(ys, 1).reshape(b, s, h, dv)
    return y.to(v.dtype), MLSTMState(c_st, n_st, m_st)


# ====================================================================== #
# sLSTM (xLSTM): scalar memory per head-dim, sequential by nature
# ====================================================================== #
class SLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, dh]
    n: torch.Tensor  # [B, H, dh]
    m: torch.Tensor  # [B, H, dh]


def slstm_init_state(b, h, dh, device="cpu") -> SLSTMState:
    return SLSTMState(c=torch.zeros(b, h, dh, dtype=_F32, device=device),
                      n=torch.zeros(b, h, dh, dtype=_F32, device=device),
                      m=torch.full((b, h, dh), -1e30, dtype=_F32, device=device))


def _slstm_step(st: SLSTMState, zt, lft, lit, ot):
    """z: cell input [B, H, dh]; lf/li: log gates [B, H, dh]; o: output gate."""
    m_new = torch.maximum(st.m + lft, lit)
    fdec = torch.exp(st.m + lft - m_new)
    iexp = torch.exp(lit - m_new)
    c = fdec * st.c + iexp * zt
    n = fdec * st.n + iexp
    h = ot * c / torch.maximum(n, torch.exp(-m_new))
    return SLSTMState(c, n, m_new), h


def _slstm_seq(z, lf, li, o, st: Optional[SLSTMState] = None):
    """Sequential sLSTM over S steps (a host loop of :func:`slstm_step`;
    the reference's ``unroll`` has no counterpart)."""
    b, s, h, dh = z.shape
    st = st or slstm_init_state(b, h, dh, z.device)
    zf, lff, lif, of = (a.to(_F32) for a in (z, lf, li, o))
    ys = []
    for t in range(s):
        st, y = _slstm_step(st, zf[:, t], lff[:, t], lif[:, t], of[:, t])
        ys.append(y)
    return torch.stack(ys, 1).to(z.dtype), st


# ====================================================================== #
# causal depthwise conv (width kw) with carry for decode
# ====================================================================== #
def _causal_conv(x: torch.Tensor, w: torch.Tensor, carry: Optional[torch.Tensor] = None):
    """x [B, S, D], w [kw, D] depthwise.  Returns (y [B, S, D], new carry
    [B, kw-1, D]); the carry and x are concatenated with type promotion."""
    kw = w.shape[0]
    if carry is None:
        carry = torch.zeros(x.shape[0], kw - 1, x.shape[2], dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=1)
    ys = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kw))
    return ys, xp[:, -(kw - 1):]


# ====================================================================== #
# entry points: on each rank's batch rows and heads under a mesh
# ====================================================================== #
def ssd_chunked(q, k, v, la, s0=None, chunk: int = 128):
    """:func:`_ssd_chunked`; under a mesh on each rank's local rows and heads
    (:func:`repro_torch.dist.ctx.local_apply`)."""
    return local_apply(lambda *a: _ssd_chunked(*a, chunk=chunk), (q, k, v, la, s0),
                       (_SEQ, _SEQ, _SEQ, _SEQ, _ROW), (_SEQ, _ROW))


def ssd_step(state, qt, kt, vt, lat):
    """:func:`_ssd_step`, local under a mesh."""
    return local_apply(_ssd_step, (state, qt, kt, vt, lat), (_ROW,) * 5, (_ROW, _ROW))


def mlstm_chunked(q, k, v, lf, li, st: Optional[MLSTMState] = None, chunk: int = 128):
    """:func:`_mlstm_chunked`, local under a mesh."""
    return local_apply(lambda *a: _mlstm_chunked(*a, chunk=chunk), (q, k, v, lf, li, st),
                       (_SEQ,) * 5 + ([_ROW] * 3,), (_SEQ, [_ROW] * 3))


def mlstm_step(st: MLSTMState, qt, kt, vt, lft, lit):
    """:func:`_mlstm_step`, local under a mesh."""
    return local_apply(_mlstm_step, (st, qt, kt, vt, lft, lit), ([_ROW] * 3,) + (_ROW,) * 5,
                       ([_ROW] * 3, _ROW))


def slstm_seq(z, lf, li, o, st: Optional[SLSTMState] = None):
    """:func:`_slstm_seq`, local under a mesh: its host loop runs on plain
    tensors, with no DTensor dispatch a step."""
    return local_apply(_slstm_seq, (z, lf, li, o, st), (_SEQ,) * 4 + ([_ROW] * 3,),
                       (_SEQ, [_ROW] * 3))


def slstm_step(st: SLSTMState, zt, lft, lit, ot):
    """:func:`_slstm_step`, local under a mesh."""
    return local_apply(_slstm_step, (st, zt, lft, lit, ot), ([_ROW] * 3,) + (_ROW,) * 4,
                       ([_ROW] * 3, _ROW))


def causal_conv(x: torch.Tensor, w: torch.Tensor, carry: Optional[torch.Tensor] = None):
    """:func:`_causal_conv`, local under a mesh (rows over "dp", channels
    over "tp": the convolution is depthwise)."""
    return local_apply(_causal_conv, (x, w, carry), (_SEQ, (None, "tp"), _SEQ), (_SEQ, _SEQ))
