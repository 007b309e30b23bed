"""Device-side reordered incremental RTEC — paper Alg. 1, batched + fused,
in PyTorch.  Mirrors the single-device part of ``repro.core.incremental``.

Two entry points share one layer body (:func:`_layer_body`):

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

from repro_torch.core.affected import PackedLayout, layout_slices, sched_slices
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
