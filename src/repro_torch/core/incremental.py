"""Device-side reordered incremental RTEC — paper Alg. 1, batched + fused,
in PyTorch.  Mirrors ``repro.core.incremental``.

Four entry points share one layer body (:func:`_layer_body`):

* :func:`incremental_layer` — the per-layer function over un-extended state
  (returns new tensors); the unfused reference the fused step is held
  against, bitwise.
* :func:`fused_stream_step` — the engine's single L-layer step over one
  :class:`~repro_torch.core.affected.PackedPlan`, updating the persistent
  scratch-extended ``(h, a, nct)`` tensors **in place**: O(affected) device
  memory traffic per layer, the counterpart of the reference's
  ``donate_argnums``.

The layer body per layer:

  1. recompute local messages for affected edges (old side / new side chosen
     per record) and add the *signed* ``[ctx | raw]`` deltas into the
     touched rows with the ``delta_agg`` kernel (Alg. 1 lines 1–3);
  2. strip the old neighborhood context from the cached aggregation state of
     the touched rows with ``ms_cbn⁻¹`` (the state ``delta_agg`` adds into),
     and re-apply the new context with ``ms_cbn`` (lines 4–6);
  3. full-neighborhood recompute for constrained destination-affected rows
     (paper §IV-C, ``segment_spmm`` inside ``subset_layer``), overwriting
     their (a, nct);
  4. vertex-wise ``update`` on every row whose output changes (line 7).

State tensors carry one scratch row at index ``n``; padded indices point
there, so padding never aliases a live vertex whatever order a scatter takes.
The fused step re-zeroes the scratch rows after each layer so the persistent
state stays inert across batches.

In-place state needs one reordering against the reference.  Step 1 of layer
l+1 reads h^{l+1} both before the batch (old side) and after it (new side);
the reference keeps both arrays, the port keeps one.  So the fused step
gathers layer l+1's old-side rows (``h[e_src]``, and ``h[e_dst]`` for
destination-dependent models) *before* layer l writes its output rows
(:func:`gather_old`).  Nothing in the step reads a value back to the host,
so the host can plan the next batch while the device runs this one.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.affected import (
    HybridLayerLayout,
    PackedLayout,
    ShardedLayout,
    hybrid_layout_slices,
    hybrid_sched_slices,
    layout_slices,
    sched_slices,
    sharded_layout_slices,
)
from repro_torch.core.full import edge_messages, masked_messages, subset_layer, zero_rows
from repro_torch.core.operators import GNNModel, Params
from repro_torch.kernels.ops import delta_agg

#: one layer's plan fields by name (LayerPlan / PackedPlan field names, plus
#: the row schedules e_order, e_row_ptr, f_order, f_row_ptr; and, in the
#: host-resident backend's compact spaces, f_rows_h / out_rows_h: f_rows and
#: out_rows remapped into the h^{l-1} workspace, which there is compacted
#: apart from the state rows)
Fields = Mapping[str, torch.Tensor]


def with_scratch(x: torch.Tensor) -> torch.Tensor:
    """Append one zero scratch row (index n) to a [N, ...] tensor."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)


def gather_old(model: GNNModel, h_prev_old: torch.Tensor, g: Fields):
    """Step 1's old-side gathers from h^{l-1} as it was before the batch."""
    old_src = h_prev_old[g["e_src"]]
    old_dst = h_prev_old[g["e_dst"]] if model.dest_dependent else None
    return old_src, old_dst


def _layer_body(
    model: GNNModel,
    p: Params,
    old_src: torch.Tensor,  # h^{l-1}_old[e_src]   (gather_old)
    old_dst: Optional[torch.Tensor],  # h^{l-1}_old[e_dst] (dest-dependent only)
    h_prev_new: torch.Tensor,  # [N+1, ·] new previous-layer embeddings
    deg_old: torch.Tensor,  # [N+1]
    deg_new: torch.Tensor,  # [N+1]
    a_ext: torch.Tensor,  # [N+1, agg]  cached state, updated in place
    nct_ext: torch.Tensor,  # [N+1, C]   cached state, updated in place
    g: Fields,
) -> torch.Tensor:
    """Steps 1–3 on ``a_ext``/``nct_ext`` in place; returns step 4's output
    rows ``h[out_rows]`` for the caller to write."""
    # ---------------- step 1: signed delta messages (Alg.1 l.1-3) -------
    e_src, e_dst, use = g["e_src"], g["e_dst"], g["e_use_new"]
    h_u = torch.where(use[:, None], h_prev_new[e_src], old_src)
    if model.dest_dependent:
        h_v = torch.where(use[:, None], h_prev_new[e_dst], old_dst)
    else:
        # Theorem 1 requires ms_local independent of the destination for
        # unconstrained models — skip the h[dst] gather entirely
        h_v = zero_rows(h_prev_new, e_src.shape[0])
    s_u = torch.where(use, deg_new[e_src], deg_old[e_src])
    s_v = torch.where(use, deg_new[e_dst], deg_old[e_dst])
    ctx, raw = edge_messages(model, p, h_u, h_v, s_u, s_v, g["e_w"], g["e_t"])
    msg = masked_messages(ctx, raw, g["e_sign"] * g["e_mask"].to(raw.dtype))

    # ---------------- step 2: cbn⁻¹ → delta-agg → cbn (Alg.1 l.4-6) -----
    # the touched rows' [nct | ms_cbn⁻¹(nct, a)] take the record sums in
    # place, in touched-row space (O(affected), not O(V))
    touch = g["touch_rows"]
    c = nct_ext.shape[1]
    nct_old_rows = nct_ext[touch]
    state = torch.cat([nct_old_rows, model.ms_cbn_inv(p, nct_old_rows, a_ext[touch])], dim=1)
    delta_agg(state, msg, g["e_row_ptr"], g["e_order"])
    nct_new_rows, s_rows = state[:, :c], state[:, c:]
    a_new_rows = model.ms_cbn(p, nct_new_rows, s_rows)
    # padded rows in touch_rows all point at the scratch slot n
    a_ext[touch] = a_new_rows
    nct_ext[touch] = nct_new_rows

    # ---------------- step 3: constrained full recompute (§IV-C) --------
    f_rows = g["f_rows"]
    if f_rows.shape[0] > 0:
        fa, fnct, _ = subset_layer(
            model, p, h_prev_new, g.get("f_rows_h", f_rows), g["f_mask"], g["f_src"], g["f_rowidx"],
            g["f_w"], g["f_t"], g["f_emask"], deg_new, f_rows.shape[0],
            g["f_order"], g["f_row_ptr"],
        )
        a_ext[f_rows] = fa
        nct_ext[f_rows] = fnct

    # ---------------- step 4: vertex-wise update (Alg.1 l.7) ------------
    out = g["out_rows"]
    return model.update(p, h_prev_new[g.get("out_rows_h", out)], a_ext[out])


def incremental_layer(
    model: GNNModel,
    p: Params,
    h_prev_old: torch.Tensor,  # WITH scratch row [N+1,·]
    h_prev_new: torch.Tensor,
    deg_old: torch.Tensor,  # [N+1]
    deg_new: torch.Tensor,  # [N+1]
    a: torch.Tensor,  # [N, agg]  cached layer state (no scratch row)
    nct: torch.Tensor,  # [N, C]
    h_cur_old: torch.Tensor,  # [N, d_out]
    g: Fields,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-layer API: returns new (a [N,agg], nct [N,C], h_cur [N,d_out])."""
    n = a.shape[0]
    a_ext, nct_ext, h_ext = with_scratch(a), with_scratch(nct), with_scratch(h_cur_old)
    incremental_layer_inplace(model, p, h_prev_old, h_prev_new, deg_old, deg_new,
                              a_ext, nct_ext, h_ext, g)
    return a_ext[:n], nct_ext[:n], h_ext[:n]


def incremental_layer_inplace(
    model: GNNModel,
    p: Params,
    h_prev_old: torch.Tensor,  # WITH scratch row [N+1,·]
    h_prev_new: torch.Tensor,  # WITH scratch row [N+1,·]
    deg_old: torch.Tensor,  # [N+1]
    deg_new: torch.Tensor,  # [N+1]
    a_ext: torch.Tensor,  # [N+1, agg]  cached layer state, updated in place
    nct_ext: torch.Tensor,  # [N+1, C]   updated in place
    h_ext: torch.Tensor,  # [N+1, d_out] updated in place
    g: Fields,
) -> None:
    """:func:`incremental_layer` on state that already carries its zeroed
    scratch row (index N), updated in place: no copy of the state is made.
    The host-resident backend stages its compact blocks this way."""
    old_src, old_dst = gather_old(model, h_prev_old, g)
    h_ext[g["out_rows"]] = _layer_body(model, p, old_src, old_dst, h_prev_new, deg_old,
                                       deg_new, a_ext, nct_ext, g)


def packed_fields(layout: PackedLayout, idx, flt, msk, sched) -> List[Dict[str, torch.Tensor]]:
    """Per-layer field views into the packed device buffers."""
    idx_sl, flt_sl, msk_sl, _ = layout_slices(layout)
    s_sl, _ = sched_slices(layout)
    out = []
    for l in range(len(layout.caps)):
        g = {name: idx[s] for name, s in idx_sl[l].items()}
        g.update({name: flt[s] for name, s in flt_sl[l].items()})
        g.update({name: msk[s] for name, s in msk_sl[l].items()})
        g.update({name: sched[s] for name, s in s_sl[l].items()})
        out.append(g)
    return out


def fused_stream_step(
    model: GNNModel,
    layout: PackedLayout,
    params: Sequence[Params],
    h_exts: Sequence[torch.Tensor],  # L+1 tensors [N+1,·] — updated in place
    a_exts: Sequence[torch.Tensor],  # L tensors [N+1,·] — updated in place
    nct_exts: Sequence[torch.Tensor],  # L tensors [N+1,·] — updated in place
    idx: torch.Tensor,  # int32 packed buffer
    flt: torch.Tensor,  # float32 packed buffer (leads with deg_old/deg_new)
    msk: torch.Tensor,  # bool packed buffer
    sched: torch.Tensor,  # int32 row schedules (sched_slices)
    feat_vals: Optional[torch.Tensor],  # [feat_cap, d0] when layout.feat_cap
) -> None:
    """One fused L-layer incremental step over a packed plan.

    Leaves the next batch's cached state in ``h_exts``/``a_exts``/
    ``nct_exts``, scratch rows re-zeroed."""
    n = layout.n
    deg_old = flt[: n + 1]
    deg_new = flt[n + 1 : 2 * (n + 1)]
    fields = packed_fields(layout, idx, flt, msk, sched)

    h0 = h_exts[0]
    old_src, old_dst = gather_old(model, h0, fields[0])
    if layout.feat_cap:
        frows = idx[: layout.feat_cap]
        fmask = msk[: layout.feat_cap]
        h0[frows] = torch.where(fmask[:, None], feat_vals.to(h0.dtype), h0[frows])
        # pads → scratch row, written with its own (zero) value

    for l in range(len(layout.caps)):
        g = fields[l]
        h_rows = _layer_body(model, params[l], old_src, old_dst, h_exts[l], deg_old, deg_new,
                             a_exts[l], nct_exts[l], g)
        if l + 1 < len(layout.caps):
            # layer l+1's old side must be read before this layer's writes
            old_src, old_dst = gather_old(model, h_exts[l + 1], fields[l + 1])
        h_exts[l + 1][g["out_rows"]] = h_rows
        # re-zero the scratch rows: padded scatters may have written
        # NaN-prone values (e.g. ms_cbn_inv(0, 0)) and the state persists
        a_exts[l][n] = 0.0
        nct_exts[l][n] = 0.0
        h_exts[l + 1][n] = 0.0


# ====================================================================== #
# Sharded step — the multi-shard analogue of fused_stream_step
# ====================================================================== #
def sharded_fields(layout: ShardedLayout, idx_sh, flt_sh, msk_sh, sched_sh):
    """Per local shard (rows of the stacked buffers), per layer: the field
    views of :func:`_layer_body` (with the workspace degree tables
    ``deg_old``/``deg_new``)."""
    idx_sl, flt_sl, msk_sl, _, _ = sharded_layout_slices(layout)
    s_sl, _ = sched_slices(layout)
    out = []
    for i in range(idx_sh.shape[0]):
        per_layer = []
        for l in range(len(layout.caps)):
            g = {name: idx_sh[i, sl] for name, sl in idx_sl[l].items()}
            g.update({name: flt_sh[i, sl] for name, sl in flt_sl[l].items()})
            g.update({name: msk_sh[i, sl] for name, sl in msk_sl[l].items()})
            g.update({name: sched_sh[i, sl] for name, sl in s_sl[l].items()})
            per_layer.append(g)
        out.append(per_layer)
    return out


def _halo(layout: ShardedLayout, l: int, exchange, h_old: torch.Tensor, h_new: torch.Tensor,
          idx_rep: torch.Tensor, comms) -> List[torch.Tensor]:
    """Each local shard's ``[halo_cap, 2·d]`` frontier buffer of layer
    ``l``: the ``[old | new]`` previous-layer rows of its halo slots.

    ``"ppermute"``: ``S − 1`` rotation rounds over the plan's per-consumer
    schedules; send pads gather the owner's scratch row, receive pads land in
    a dump row (index ``halo_cap``, cut off), and slots this shard never
    gathers stay 0.  ``"psum"``: each shard contributes the halo rows it owns
    (zeros elsewhere) to one sum over shards — a select of the owner's exact
    bytes, so both modes feed the layer the same values."""
    rows_per, s_total = layout.rows_per, layout.n_shards
    halo_cap = layout.caps[l][5]
    d = h_old.shape[2]
    local = exchange.local_shards
    if layout.halo_mode == "ppermute" and s_total > 1:
        send_pos, recv_pos = comms[l]
        bufs = [h_old.new_zeros((halo_cap + 1, 2 * d)) for _ in local]
        for k in range(1, s_total):
            parts = [torch.cat([h_old[i][send_pos[i, k - 1]], h_new[i][send_pos[i, k - 1]]], 1)
                     for i in range(len(local))]
            for i, rec in enumerate(exchange.rotate(parts, k)):
                bufs[i][recv_pos[i, k - 1]] = rec
        return [b[:halo_cap] for b in bufs]
    _, _, _, halo_sl, _ = sharded_layout_slices(layout)
    halo_rows = idx_rep[halo_sl[l]]  # global ids, pad → -1
    parts = []
    for i, s in enumerate(local):
        lo = s * rows_per
        own = (halo_rows >= lo) & (halo_rows < lo + rows_per)
        pos = torch.where(own, halo_rows - lo, rows_per)
        cat = torch.cat([h_old[i][pos], h_new[i][pos]], 1)
        parts.append(torch.where(own[:, None], cat, 0.0))
    return exchange.psum(parts)


def sharded_step(
    model: GNNModel,
    layout: ShardedLayout,
    params: Sequence[Params],
    h_blocks: Sequence[torch.Tensor],  # L+1 tensors [S_loc, rows_per+1, ·]
    a_blocks: Sequence[torch.Tensor],  # L tensors [S_loc, rows_per+1, ·], updated in place
    nct_blocks: Sequence[torch.Tensor],  # L tensors, updated in place
    idx_sh: torch.Tensor,  # int32 [S_loc, idx_len]
    flt_sh: torch.Tensor,  # float32 [S_loc, flt_len]
    msk_sh: torch.Tensor,  # bool [S_loc, msk_len]
    sched_sh: torch.Tensor,  # int32 [S_loc, sched_len]
    idx_rep: torch.Tensor,  # int32 [rep_len]: feature rows | halo rows
    msk_rep: torch.Tensor,  # bool [feat_cap]
    feat_vals: Optional[torch.Tensor],  # [feat_cap, d0] when layout.feat_cap
    comms,  # per layer (send_pos, recv_pos) [S_loc, S-1, pair_cap], or None
    exchange,
) -> List[torch.Tensor]:
    """One L-layer incremental step over row-sharded state.

    Per layer each local shard (1) gets its frontier buffer from
    :func:`_halo`, (2) runs the unmodified :func:`_layer_body` on its
    ``[halo | local]`` workspace — step 1 in ``delta_agg`` over the shard's
    own row schedule; every scatter is owner-local, destination rows are
    never remote — and (3) re-zeroes its scratch row.  ``a``/``nct`` blocks
    update in place; each layer's ``h`` is written into a copy of its block,
    because the next layer's exchange still reads the old block.  Returns
    the new ``h`` blocks (L+1)."""
    rows_per = layout.rows_per
    fields = sharded_fields(layout, idx_sh, flt_sh, msk_sh, sched_sh)
    local = exchange.local_shards

    h_old = h_blocks[0]
    h_new = h_old
    if layout.feat_cap:
        h_new = h_old.clone()
        fr = idx_rep[: layout.feat_cap]
        for i, s in enumerate(local):
            lo = s * rows_per
            fm = msk_rep & (fr >= lo) & (fr < lo + rows_per)
            li = torch.where(fm, fr - lo, rows_per)  # not owned → scratch
            h_new[i][li] = torch.where(fm[:, None], feat_vals.to(h_new.dtype), h_new[i][li])
    hs = [h_new]
    for l in range(len(layout.caps)):
        d = h_old.shape[2]
        halos = _halo(layout, l, exchange, h_old, h_new, idx_rep, comms)
        h_next = h_blocks[l + 1].clone()
        for i in range(len(local)):
            g = fields[i][l]
            ws_old = torch.cat([halos[i][:, :d], h_old[i]])
            ws_new = torch.cat([halos[i][:, d:], h_new[i]])
            old_src, old_dst = gather_old(model, ws_old, g)
            h_next[i][g["out_rows"]] = _layer_body(
                model, params[l], old_src, old_dst, ws_new, g["deg_old"], g["deg_new"],
                a_blocks[l][i], nct_blocks[l][i], g)
            a_blocks[l][i][rows_per] = 0.0  # re-zero the local scratch row
            nct_blocks[l][i][rows_per] = 0.0
            h_next[i][rows_per] = 0.0
        hs.append(h_next)
        h_old, h_new = h_blocks[l + 1], h_next
    return hs


# ====================================================================== #
# Hybrid compact layer step — the sharded-offload backend's device step
# ====================================================================== #
def hybrid_layer_step(
    model: GNNModel,
    layout: HybridLayerLayout,
    p: Params,
    h_old: torch.Tensor,  # [S, nh_cap+1, d_in] staged h^{l-1} (old view), scratch row last
    h_new: torch.Tensor,  # [S, nh_cap+1, d_in] (new view)
    a: torch.Tensor,  # [S, ns_cap+1, agg] staged state, updated in place
    nct: torch.Tensor,  # [S, ns_cap+1, C]
    h_cur: torch.Tensor,  # [S, ns_cap+1, d_out]
    idx_sh: torch.Tensor,  # int32 [S, idx_len]
    flt_sh: torch.Tensor,  # float32 [S, flt_len]
    msk_sh: torch.Tensor,  # bool [S, msk_len]
    sched_sh: torch.Tensor,  # int32 [S, sched_len]
) -> None:
    """Each shard runs :func:`incremental_layer_inplace` on its compact
    staged blocks (no collective: the halo rows were staged from the owning
    shards' host blocks).  Step 1 runs in ``delta_agg``, a constrained
    model's step 3 sums in ``segment_spmm``, each over the shard's own row
    schedules."""
    idx_sl, flt_sl, msk_sl, _ = hybrid_layout_slices(layout)
    s_sl, _ = hybrid_sched_slices(layout)
    for s in range(idx_sh.shape[0]):
        g = {name: idx_sh[s, sl] for name, sl in idx_sl.items()}
        g.update({name: flt_sh[s, sl] for name, sl in flt_sl.items()})
        g.update({name: msk_sh[s, sl] for name, sl in msk_sl.items()})
        g.update({name: sched_sh[s, sl] for name, sl in s_sl.items()})
        incremental_layer_inplace(model, p, h_old[s], h_new[s], g["deg_old"], g["deg_new"],
                                  a[s], nct[s], h_cur[s], g)
