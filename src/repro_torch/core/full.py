"""Full-neighbor RTEC reference (paper Eq. 5–9 / Alg. 2 generalized), in
PyTorch.  Mirrors ``repro.core.full``.

This is (a) the from-scratch oracle against which incremental RTEC is proven
equivalent, (b) the engine's state initialiser and refresh, and (c) the
padded-subset layer used for the constrained-model full-recompute path.

Edge arrays may be padded (mask=False rows contribute nothing).  Gather
indices of padded entries point at a scratch row (index ``n``) so they never
alias real vertices.  Every destination sum goes through the
``segment_spmm`` kernel (its plain version on the CPU) as one call over the
``[ctx | raw]`` columns, with a row schedule: ``full_layer`` takes
dst-sorted edges and their row offsets, ``subset_layer`` the plan's
schedule of the ``f_rowidx`` records.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.operators import GNNModel, Params
from repro_torch.kernels.ops import segment_spmm


class LayerState(NamedTuple):
    """Cached per-layer results (the paper's 'historical results')."""

    a: torch.Tensor  # [N, agg_dim]  aggregated (context-applied) neighbor state
    nct: torch.Tensor  # [N, ctx_dim]  neighborhood context
    h: torch.Tensor  # [N, d_out]   layer output embedding


def edge_messages(
    model: GNNModel,
    p: Params,
    h_src: torch.Tensor,
    h_dst: torch.Tensor,
    s_src: torch.Tensor,
    s_dst: torch.Tensor,
    ew: torch.Tensor,
    et: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge (ctx_contrib, raw_term) under the decoupled abstraction."""
    mlc = model.ms_local(p, h_src, h_dst, s_src, s_dst, ew, et)
    ctx = model.ctx_contrib(p, mlc, et)
    z = model.f_nn(p, h_src, et)
    raw = model.edge_term(p, mlc, z, et)
    return ctx, raw


def masked_messages(ctx: torch.Tensor, raw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``[ctx | raw] * scale[:, None]`` written straight into one contiguous
    ``[E, C + agg]`` buffer — the layout the row-sum kernels take."""
    c = ctx.shape[1]
    msg = torch.empty((ctx.shape[0], c + raw.shape[1]), dtype=raw.dtype, device=raw.device)
    s = scale[:, None]
    torch.mul(ctx, s, out=msg[:, :c])
    torch.mul(raw, s, out=msg[:, c:])
    return msg


def zero_rows(h: torch.Tensor, e: int) -> torch.Tensor:
    """An ``[e, d]`` zero view with no storage behind it: the ``h[dst]``
    operand of a destination-independent ``ms_local``, which never reads it
    (Theorem 1) — so the gather is skipped entirely."""
    return h.new_zeros((1, h.shape[1])).expand(e, h.shape[1])


def full_layer(
    model: GNNModel,
    p: Params,
    h: torch.Tensor,  # [N, d_in] previous-layer embeddings
    src: torch.Tensor,  # [E] (padded ok; padded entries must index n)
    dst: torch.Tensor,  # [E] sorted ascending
    ew: torch.Tensor,
    et: torch.Tensor,
    mask: torch.Tensor,  # [E] bool
    deg: torch.Tensor,  # [N] float in-degrees of the *current* graph
    row_ptr: torch.Tensor,  # [n+1] offsets of each destination's edges in dst
) -> LayerState:
    """One full-neighbor layer over dst-sorted (possibly padded) edge arrays.

    ``row_ptr`` replaces the reference's ``num_segments=n + 1`` scatter:
    padded edges lie after ``row_ptr[n]`` and are never summed."""
    n = row_ptr.shape[0] - 1
    hs = h[src]
    hd = h[dst] if model.dest_dependent else zero_rows(h, src.shape[0])
    ss = deg[src]
    sd = deg[dst]
    ctx, raw = edge_messages(model, p, hs, hd, ss, sd, ew, et)
    del hs, hd
    msg = masked_messages(ctx, raw, mask.to(raw.dtype))
    c = ctx.shape[1]
    del ctx, raw
    sums = segment_spmm(msg, row_ptr, None, n)
    nct, s = sums[:, :c], sums[:, c:]
    a = model.ms_cbn(p, nct, s)
    h_out = model.update(p, h, a)
    return LayerState(a=a, nct=nct, h=h_out)


def full_forward(
    model: GNNModel,
    params: Sequence[Params],
    x: torch.Tensor,
    graph,
) -> List[LayerState]:
    """From-scratch L-layer forward over a CSRGraph snapshot, on ``x.device``."""
    dev = x.device
    src_np, dst_np, w_np, t_np = graph.edges_by_dst()
    deg = torch.from_numpy(graph.in_degree().astype(np.float32)).to(dev)
    src = torch.from_numpy(src_np).to(dev)
    dst = torch.from_numpy(dst_np).to(dev)
    ew = torch.from_numpy(w_np).to(dev)
    et = torch.from_numpy(t_np).to(dev)
    row_ptr = torch.from_numpy(graph.in_indptr.astype(np.int64)).to(dev)
    return full_forward_edges(model, params, x, src, dst, ew, et, deg, row_ptr)


def full_forward_edges(model: GNNModel, params: Sequence[Params], x: torch.Tensor,
                       src: torch.Tensor, dst: torch.Tensor, ew: torch.Tensor,
                       et: torch.Tensor, deg: torch.Tensor, row_ptr: torch.Tensor
                       ) -> List[LayerState]:
    """:func:`full_forward` over the snapshot's dst-sorted edge arrays, already
    on ``x.device`` (the dry run passes fake tensors of their shapes)."""
    mask = torch.ones(src.shape[0], dtype=torch.bool, device=x.device)
    h = x
    states = []
    for p in params:
        st = full_layer(model, p, h, src, dst, ew, et, mask, deg, row_ptr)
        states.append(st)
        h = st.h
    return states


def subset_layer(
    model: GNNModel,
    p: Params,
    h_prev: torch.Tensor,  # [N+1, d_in]   (mixed cached/new)
    rows: torch.Tensor,  # [R]  vertex ids to (re)compute (padded with n)
    rows_mask: torch.Tensor,  # [R]
    e_src: torch.Tensor,  # [E] sources (padded)
    e_rowidx: torch.Tensor,  # [E] index into rows (padded → R scratch row)
    e_w: torch.Tensor,
    e_t: torch.Tensor,
    e_mask: torch.Tensor,
    deg: torch.Tensor,  # [N+1] float degrees with scratch slot
    r_cap: int,
    order: torch.Tensor,  # [E] row schedule of the records: stable argsort
    row_ptr: torch.Tensor,  # [r_cap+1]   of the masked e_rowidx + row offsets
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-neighbor recompute restricted to a padded vertex subset.

    Returns (a_rows [R, agg], nct_rows [R, C], h_rows [R, d_out])."""
    rows_l = rows.long()
    # padded records carry e_rowidx = r_cap, one past the end: the reference's
    # gather clamps that to the last row, and so does this one (the records
    # are masked to 0 and left out of the schedule either way)
    ridx = e_rowidx.long().clamp_max(r_cap - 1)
    hs = h_prev[e_src]
    hd = h_prev[rows_l][ridx]
    ss = deg[e_src]
    sd = deg[rows_l][ridx]
    ctx, raw = edge_messages(model, p, hs, hd, ss, sd, e_w, e_t)
    msg = masked_messages(ctx, raw, e_mask.to(raw.dtype))
    c = ctx.shape[1]
    sums = segment_spmm(msg, row_ptr, order, r_cap)
    nct, s = sums[:, :c], sums[:, c:]
    a = model.ms_cbn(p, nct, s)
    h_rows = model.update(p, h_prev[rows_l], a)
    return a, nct, h_rows


def pad_to(arr: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full((cap,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def next_bucket(x: int, minimum: int = 16) -> int:
    """Power-of-two capacity bucketing to bound shape variety."""
    c = max(minimum, int(x))
    return 1 << int(np.ceil(np.log2(c))) if c > 0 else minimum
