"""Affected-subgraph construction — paper Alg. 4, host side (numpy).

The port's jax-free counterpart of ``repro.core.affected``: ``build_plan``
and ``pack_plan`` are the reference's own code, so the packed
``idx``/``flt``/``msk``/``feat_vals`` buffers and the layout are bitwise the
reference's ``pack_plan(pallas=False)``.  One thing is new: the reference's
TPU block-CSR schedule for the Pallas delta scatter (``TV=8/BE=128/BD=128``
one-hot tiles shaped for the matrix unit) is replaced by a plain row
schedule per layer — a stable argsort of the masked ``e_rowidx`` plus
``row_ptr[r_cap+1]``, and the same for the ``f_rowidx`` records — shipped in
its own int32 buffer (:attr:`PackedPlan.sched`).  Batch-window fusion
(:class:`FusionWindow`) merges independent plans into one :class:`BatchPlan`
that packs like any other.  The host-resident substrates' compact index
spaces (:func:`remap_compact`) and the hot-row cache's residency split
(:func:`split_residency`) close the module.  Sharded and hybrid planning are
not ported yet.

Per layer, the planner classifies work into:

  * **incremental records** — signed per-edge delta contributions
    (insert → (+, new side), delete → (−, old side), changed source /
    changed structural context → a (−, old) / (+, new) pair), consumed by
    the device-side Alg.-1 step; and
  * **full-recompute vertices** — for constrained (destination-dependent)
    models, vertices whose previous-layer embedding changed and that still
    have in-edges must be fully recomputed over their complete new
    in-neighborhood (paper Alg. 4 lines 5–7).  Incremental records targeting
    these vertices are suppressed to avoid double counting.

All index arrays are padded to power-of-two buckets (``next_bucket``).
Padded gather indices point at a scratch row (index n) and padded scatter
rows at the capacity slot, so they can never alias live data.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.full import next_bucket
from repro_torch.core.operators import GNNModel
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.streaming import UpdateBatch
from repro_torch.kernels.segment_spmm import prepare_row_schedule


@dataclasses.dataclass
class LayerPlan:
    # --- incremental signed records (padded to e_cap) ---
    e_src: np.ndarray  # int32 [Ecap], pad → n (scratch)
    e_dst: np.ndarray  # int32 [Ecap], pad → n
    e_rowidx: np.ndarray  # int32 [Ecap] index into touch_rows, pad → r_cap
    e_sign: np.ndarray  # float32 [Ecap]
    e_use_new: np.ndarray  # bool [Ecap]
    e_w: np.ndarray  # float32
    e_t: np.ndarray  # int32
    e_mask: np.ndarray  # bool
    # --- rows whose aggregation state is updated incrementally ---
    touch_rows: np.ndarray  # int32 [Rcap], pad → n
    touch_mask: np.ndarray  # bool
    # --- constrained full-recompute path ---
    f_rows: np.ndarray  # int32 [Fcap], pad → n
    f_mask: np.ndarray
    f_src: np.ndarray  # int32 [FEcap], pad → n
    f_rowidx: np.ndarray  # int32 [FEcap] into f_rows, pad → f_cap
    f_w: np.ndarray
    f_t: np.ndarray
    f_emask: np.ndarray
    # --- rows whose h^l changes ---
    out_rows: np.ndarray  # int32 [Ocap], pad → n
    out_mask: np.ndarray
    # --- accounting (paper Figs. 2/8/11 metrics) ---
    n_inc_edges: int = 0
    n_full_edges: int = 0
    n_touch_rows: int = 0
    n_full_rows: int = 0
    n_out_rows: int = 0
    n_src_accessed: int = 0


@dataclasses.dataclass
class BatchPlan:
    layers: List[LayerPlan]
    deg_old: np.ndarray  # float32 [n+1] (scratch slot appended)
    deg_new: np.ndarray
    changed0: np.ndarray  # vertices with feature updates

    def total_inc_edges(self) -> int:
        return sum(p.n_inc_edges for p in self.layers)

    def total_full_edges(self) -> int:
        return sum(p.n_full_edges for p in self.layers)

    def total_vertices(self) -> int:
        return sum(p.n_out_rows for p in self.layers)


def final_write_rows(plan: BatchPlan) -> np.ndarray:
    """Global ids of the final-layer rows a batch's execution may write.

    ``out_rows`` is the planner's "rows whose h^L changes" set: every row
    outside it keeps its pre-batch value untouched, so a serving layer can
    snapshot exactly these rows *before* dispatch."""
    lp = plan.layers[-1]
    return np.unique(lp.out_rows[lp.out_mask].astype(np.int64))


def _lookup_in_edge_data(g: CSRGraph, src: np.ndarray, dst: np.ndarray):
    """Vectorized (weight, etype) lookup for existing edges (u, v)."""
    w = np.empty(src.shape[0], np.float32)
    t = np.empty(src.shape[0], np.int32)
    for i, (u, v) in enumerate(zip(src, dst)):
        nbrs, ws, ts = g.in_edge_data(int(v))
        j = np.searchsorted(nbrs, u)
        assert j < nbrs.shape[0] and nbrs[j] == u, f"edge ({u},{v}) missing"
        w[i] = ws[j]
        t[i] = ts[j]
    return w, t


def _pad_records(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    sign: np.ndarray,
    use_new: np.ndarray,
    w: np.ndarray,
    t: np.ndarray,
) -> Tuple[np.ndarray, ...]:
    e = src.shape[0]
    e_cap = next_bucket(e)
    rows, rowinv = np.unique(dst, return_inverse=True) if e else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    r_cap = next_bucket(rows.shape[0])

    def pad(a, cap, fill, dt):
        out = np.full(cap, fill, dtype=dt)
        out[: a.shape[0]] = a
        return out

    return (
        pad(src, e_cap, n, np.int32),
        pad(dst, e_cap, n, np.int32),
        pad(rowinv, e_cap, r_cap, np.int32),
        pad(sign, e_cap, 0.0, np.float32),
        pad(use_new, e_cap, False, bool),
        pad(w, e_cap, 0.0, np.float32),
        pad(t, e_cap, 0, np.int32),
        pad(np.ones(e, bool), e_cap, False, bool),
        pad(rows, r_cap, n, np.int32),
        pad(np.ones(rows.shape[0], bool), r_cap, False, bool),
    )


def build_plan(
    model: GNNModel,
    g_old: CSRGraph,
    g_new: CSRGraph,
    batch: UpdateBatch,
    num_layers: int,
    restrict: Optional[List[set]] = None,
) -> BatchPlan:
    """Build per-layer incremental plans.

    ``restrict`` (ODEC, paper §V-D): optional per-layer vertex sets; layer
    l's work is intersected with ``restrict[l]`` (the query-induced K-hop
    cone), turning RTEC into on-demand embedding computation."""
    n = g_old.n
    deg_old = g_old.in_degree().astype(np.float32)
    deg_new = g_new.in_degree().astype(np.float32)
    deg_changed = np.nonzero(deg_old != deg_new)[0]

    ins_s = np.asarray(batch.ins_src, np.int64)
    ins_d = np.asarray(batch.ins_dst, np.int64)
    ins_w = (
        np.asarray(batch.ins_weights, np.float32)
        if batch.ins_weights is not None
        else np.ones(ins_s.shape[0], np.float32)
    )
    ins_t = (
        np.asarray(batch.ins_etypes, np.int32)
        if batch.ins_etypes is not None
        else np.zeros(ins_s.shape[0], np.int32)
    )
    del_s = np.asarray(batch.del_src, np.int64)
    del_d = np.asarray(batch.del_dst, np.int64)
    if del_s.size:
        del_w, del_t = _lookup_in_edge_data(g_old, del_s, del_d)
    else:
        del_w = np.zeros(0, np.float32)
        del_t = np.zeros(0, np.int32)
    inserted_keys = set(zip(ins_s.tolist(), ins_d.tolist()))

    changed0 = (
        np.asarray(batch.feat_vertices, np.int64)
        if batch.feat_vertices is not None
        else np.zeros(0, np.int64)
    )
    changed_h = changed0  # vertices whose h^{l-1} changed
    deg_new_int = g_new.in_degree()

    plans: List[LayerPlan] = []
    for layer_idx in range(num_layers):
        allowed = restrict[layer_idx] if restrict is not None else None
        changed_set = set(changed_h.tolist())
        # sources whose outgoing contributions changed
        c_src = set(changed_set)
        if model.src_struct_dependent:
            c_src |= set(deg_changed.tolist())
        # constrained full-recompute destinations
        if model.dest_dependent:
            v_full = np.array(
                sorted(
                    v
                    for v in changed_set
                    if deg_new_int[v] > 0 and (allowed is None or v in allowed)
                ),
                np.int64,
            )
        else:
            v_full = np.zeros(0, np.int64)
        v_full_set = set(v_full.tolist())

        # ---- incremental records ----
        rs, rd, rsign, rnew, rw, rt = [], [], [], [], [], []
        n_changed_edges = 0

        def _emit(s, d, sign, usenew, w, t):
            rs.append(s)
            rd.append(d)
            rsign.append(sign)
            rnew.append(usenew)
            rw.append(w)
            rt.append(t)

        def _allowed(d: int) -> bool:
            return allowed is None or d in allowed

        for i in range(ins_s.shape[0]):
            if int(ins_d[i]) not in v_full_set and _allowed(int(ins_d[i])):
                _emit(ins_s[i], ins_d[i], 1.0, True, ins_w[i], ins_t[i])
        for i in range(del_s.shape[0]):
            if int(del_d[i]) not in v_full_set and _allowed(int(del_d[i])):
                _emit(del_s[i], del_d[i], -1.0, False, del_w[i], del_t[i])
        for u in sorted(c_src):
            nbrs, ws, ts = g_new.out_edge_data(int(u))
            for j in range(nbrs.shape[0]):
                d = int(nbrs[j])
                if (int(u), d) in inserted_keys or d in v_full_set or not _allowed(d):
                    continue
                _emit(u, d, -1.0, False, ws[j], ts[j])
                _emit(u, d, 1.0, True, ws[j], ts[j])
                n_changed_edges += 1

        rec = _pad_records(
            n,
            np.array(rs, np.int64),
            np.array(rd, np.int64),
            np.array(rsign, np.float32),
            np.array(rnew, bool),
            np.array(rw, np.float32),
            np.array(rt, np.int32),
        )
        (e_src, e_dst, e_rowidx, e_sign, e_use_new, e_w, e_t, e_mask, touch_rows, touch_mask) = rec

        # ---- constrained full path ----
        f_srcs, f_ridx, f_ws, f_ts = [], [], [], []
        for ri, v in enumerate(v_full):
            nbrs, ws, ts = g_new.in_edge_data(int(v))
            f_srcs.extend(nbrs.tolist())
            f_ridx.extend([ri] * nbrs.shape[0])
            f_ws.extend(ws.tolist())
            f_ts.extend(ts.tolist())
        f_cap = next_bucket(v_full.shape[0])
        fe_cap = next_bucket(len(f_srcs))

        def padv(a, cap, fill, dt):
            out = np.full(cap, fill, dtype=dt)
            out[: len(a)] = a
            return out

        f_rows = padv(v_full, f_cap, n, np.int32)
        f_mask = padv(np.ones(v_full.shape[0], bool), f_cap, False, bool)
        f_src = padv(f_srcs, fe_cap, n, np.int32)
        f_rowidx = padv(f_ridx, fe_cap, f_cap, np.int32)
        f_w = padv(f_ws, fe_cap, 0.0, np.float32)
        f_t = padv(f_ts, fe_cap, 0, np.int32)
        f_emask = padv(np.ones(len(f_srcs), bool), fe_cap, False, bool)

        # ---- output rows ----
        out_set = set(touch_rows[touch_mask].tolist()) | v_full_set
        if model.update_uses_h:
            out_set |= changed_set if allowed is None else (changed_set & allowed)
        out = np.array(sorted(out_set), np.int64)
        o_cap = next_bucket(out.shape[0])
        out_rows = padv(out, o_cap, n, np.int32)
        out_mask = padv(np.ones(out.shape[0], bool), o_cap, False, bool)

        n_inc = ins_s.shape[0] + del_s.shape[0] + n_changed_edges
        srcs_accessed = len(set(rs) | set(f_srcs))
        plans.append(
            LayerPlan(
                e_src=e_src,
                e_dst=e_dst,
                e_rowidx=e_rowidx,
                e_sign=e_sign,
                e_use_new=e_use_new,
                e_w=e_w,
                e_t=e_t,
                e_mask=e_mask,
                touch_rows=touch_rows,
                touch_mask=touch_mask,
                f_rows=f_rows,
                f_mask=f_mask,
                f_src=f_src,
                f_rowidx=f_rowidx,
                f_w=f_w,
                f_t=f_t,
                f_emask=f_emask,
                out_rows=out_rows,
                out_mask=out_mask,
                n_inc_edges=n_inc,
                n_full_edges=len(f_srcs),
                n_touch_rows=int(touch_mask.sum()),
                n_full_rows=int(v_full.shape[0]),
                n_out_rows=int(out.shape[0]),
                n_src_accessed=srcs_accessed,
            )
        )
        changed_h = out

    deg_old_x = np.concatenate([deg_old, np.zeros(1, np.float32)])
    deg_new_x = np.concatenate([deg_new, np.zeros(1, np.float32)])
    return BatchPlan(layers=plans, deg_old=deg_old_x, deg_new=deg_new_x, changed0=changed0)


# ====================================================================== #
# Capacity hysteresis — high-water-mark pow-2 buckets (retrace damping)
# ====================================================================== #
class BucketHysteresis:
    """Per-field high-water-mark floors over :func:`next_bucket` capacities.

    Holding every field at its stream-high-water bucket makes capacities
    monotone, so the number of distinct layouts over a stream is bounded by
    the number of *growth* events only (and the packed buffers stay
    bitwise-equal to the reference planner's).  One instance per engine
    (capacities are stream state, not plan state)."""

    def __init__(self) -> None:
        self._caps: Dict[object, int] = {}

    def bucket(self, key, size: int, minimum: int = 16) -> int:
        cap = max(next_bucket(size, minimum=minimum), self._caps.get(key, 0))
        self._caps[key] = cap
        return cap

    def snapshot(self) -> Dict[object, int]:
        """Copy of the current per-field capacity floors (tests assert the
        marks stabilize — i.e. no growth event → no retrace)."""
        return dict(self._caps)


def _cap_of(hwm: Optional[BucketHysteresis], key, size: int, minimum: int = 16) -> int:
    if hwm is None:
        return next_bucket(size, minimum=minimum)
    return hwm.bucket(key, size, minimum=minimum)


# ====================================================================== #
# Packed plans — pipelined-engine transfer format (paper §V co-processing)
# ====================================================================== #
# Per-field capacity kind within a layer's cap tuple (e, r, f, fe, o).
IDX_FIELDS: Tuple[Tuple[str, int], ...] = (
    ("e_src", 0), ("e_dst", 0), ("e_rowidx", 0), ("e_t", 0),
    ("touch_rows", 1), ("f_rows", 2), ("f_src", 3), ("f_rowidx", 3),
    ("f_t", 3), ("out_rows", 4),
)
FLT_FIELDS: Tuple[Tuple[str, int], ...] = (("e_sign", 0), ("e_w", 0), ("f_w", 3))
MSK_FIELDS: Tuple[Tuple[str, int], ...] = (
    ("e_mask", 0), ("e_use_new", 0), ("touch_mask", 1), ("f_mask", 2),
    ("f_emask", 3), ("out_mask", 4),
)


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static (hashable) shape descriptor of a packed plan.

    The power-of-two bucketing in :func:`build_plan` and the high-water-mark
    hysteresis keep the number of distinct layouts, and so of distinct
    buffer shapes the device step sees, O(log) over a stream."""

    n: int  # vertex count (scratch row index)
    feat_cap: int  # 0 → batch has no feature updates (static branch)
    caps: Tuple[Tuple[int, int, int, int, int], ...]  # per layer (e, r, f, fe, o)


@lru_cache(maxsize=None)
def layout_slices(layout: PackedLayout):
    """Static offset table: per-layer field → slice into the packed buffers.

    Returns (idx_slices, flt_slices, msk_slices, totals) where each *_slices
    is a tuple (one per layer) of name → slice dicts, and totals are the
    buffer lengths (idx_len, flt_len, msk_len)."""
    idx_off = layout.feat_cap  # [feat_rows | per-layer idx fields]
    flt_off = 2 * (layout.n + 1)  # [deg_old | deg_new | per-layer flt fields]
    msk_off = layout.feat_cap  # [feat_mask | per-layer msk fields]
    idx_sl, flt_sl, msk_sl = [], [], []
    for caps in layout.caps:
        di: Dict[str, slice] = {}
        for name, kind in IDX_FIELDS:
            di[name] = slice(idx_off, idx_off + caps[kind])
            idx_off += caps[kind]
        df: Dict[str, slice] = {}
        for name, kind in FLT_FIELDS:
            df[name] = slice(flt_off, flt_off + caps[kind])
            flt_off += caps[kind]
        dm: Dict[str, slice] = {}
        for name, kind in MSK_FIELDS:
            dm[name] = slice(msk_off, msk_off + caps[kind])
            msk_off += caps[kind]
        idx_sl.append(di)
        flt_sl.append(df)
        msk_sl.append(dm)
    return tuple(idx_sl), tuple(flt_sl), tuple(msk_sl), (idx_off, flt_off, msk_off)


def sched_slices(layout: PackedLayout):
    """Static offset table of the schedule buffer: per layer, name → slice
    of ``e_order [e] | e_row_ptr [r+1] | f_order [fe] | f_row_ptr [f+1]``.
    Returns (per-layer dicts, total length)."""
    off = 0
    out = []
    for e, r, f, fe, _ in layout.caps:
        d: Dict[str, slice] = {}
        for name, size in (("e_order", e), ("e_row_ptr", r + 1),
                           ("f_order", fe), ("f_row_ptr", f + 1)):
            d[name] = slice(off, off + size)
            off += size
        out.append(d)
    return tuple(out), off


@dataclasses.dataclass
class PackedPlan:
    """A whole batch's plan flattened into contiguous host buffers.

    (idx, flt, msk, sched[, feat_vals]) ship to the device in one copy per
    batch instead of ~24×L small per-array transfers; the static offset
    tables (:func:`layout_slices`, :func:`sched_slices`) let the fused device
    step slice every field back out.  idx/flt/msk/feat_vals are bitwise the
    reference planner's ``pack_plan(pallas=False)`` buffers."""

    layout: PackedLayout
    idx: np.ndarray  # int32  [idx_len]
    flt: np.ndarray  # float32 [flt_len]  (leads with deg_old, deg_new)
    msk: np.ndarray  # bool   [msk_len]
    feat_vals: Optional[np.ndarray]  # float32 [feat_cap, d0] when feat_cap > 0
    # int32 row schedules of the step-1 records and the constrained-path
    # records, per layer [e_order | e_row_ptr | f_order | f_row_ptr]
    # (:func:`sched_slices`): what the delta_agg / segment_spmm kernels read
    sched: np.ndarray
    # accounting (aggregated over layers; feeds BatchStats)
    n_inc_edges: int
    n_full_edges: int
    n_out_rows: int
    # global ids of final-layer rows this plan may write (the serving
    # write set, see :func:`final_write_rows`)
    out_rows_final: Optional[np.ndarray] = None


def _idx_pad_value(name: str, n: int, caps: Tuple[int, ...]) -> int:
    """Pad value a hysteresis-grown idx field must be extended with (matches
    the :func:`build_plan` padding conventions)."""
    if name == "e_rowidx":
        return caps[1]
    if name == "f_rowidx":
        return caps[2]
    if name in ("e_t", "f_t"):
        return 0
    return n


def pack_plan(
    plan: BatchPlan,
    feat_vertices: Optional[np.ndarray] = None,
    feat_values: Optional[np.ndarray] = None,
    hwm: Optional[BucketHysteresis] = None,
) -> PackedPlan:
    """Flatten a :class:`BatchPlan` into the packed transfer format.

    With ``hwm`` every capacity is padded up to the stream's high-water-mark
    bucket (:class:`BucketHysteresis`), so shrinking batches reuse the
    previous layout instead of retracing the fused step mid-stream."""
    n = plan.deg_old.shape[0] - 1
    if feat_vertices is not None and np.asarray(feat_vertices).size:
        fr = np.asarray(feat_vertices, np.int64)
        fv = np.asarray(feat_values, np.float32)
        feat_cap = _cap_of(hwm, "feat", fr.shape[0])
    else:
        fr = np.zeros(0, np.int64)
        fv = None
        feat_cap = 0
    caps = tuple(
        (
            _cap_of(hwm, (l, 0), lp.e_src.shape[0]),
            _cap_of(hwm, (l, 1), lp.touch_rows.shape[0]),
            _cap_of(hwm, (l, 2), lp.f_rows.shape[0]),
            _cap_of(hwm, (l, 3), lp.f_src.shape[0]),
            _cap_of(hwm, (l, 4), lp.out_rows.shape[0]),
        )
        for l, lp in enumerate(plan.layers)
    )
    layout = PackedLayout(n=n, feat_cap=feat_cap, caps=caps)
    idx_sl, flt_sl, msk_sl, (idx_len, flt_len, msk_len) = layout_slices(layout)

    idx = np.full(idx_len, n, np.int32)  # default pad → scratch row
    flt = np.zeros(flt_len, np.float32)
    msk = np.zeros(msk_len, bool)
    flt[: n + 1] = plan.deg_old
    flt[n + 1 : 2 * (n + 1)] = plan.deg_new
    feat_vals = None
    if feat_cap:
        idx[: fr.shape[0]] = fr
        msk[: fr.shape[0]] = True
        feat_vals = np.zeros((feat_cap, fv.shape[1]), np.float32)
        feat_vals[: fv.shape[0]] = fv
    for l, lp in enumerate(plan.layers):
        for name, _ in IDX_FIELDS:
            sl, arr = idx_sl[l][name], getattr(lp, name)
            idx[sl.start : sl.start + arr.shape[0]] = arr
            if sl.start + arr.shape[0] < sl.stop:  # hysteresis-grown tail
                idx[sl.start + arr.shape[0] : sl.stop] = _idx_pad_value(
                    name, n, layout.caps[l]
                )
        for name, _ in FLT_FIELDS:
            sl, arr = flt_sl[l][name], getattr(lp, name)
            flt[sl.start : sl.start + arr.shape[0]] = arr  # tail stays 0.0
        for name, _ in MSK_FIELDS:
            sl, arr = msk_sl[l][name], getattr(lp, name)
            msk[sl.start : sl.start + arr.shape[0]] = arr  # tail stays False

    # row schedules (replace the TPU block-CSR schedule of the reference):
    # built from the packed buffers, so hysteresis-grown tails are covered
    s_sl, s_len = sched_slices(layout)
    sched = np.zeros(s_len, np.int32)
    for l, caps in enumerate(layout.caps):
        for kind, rowidx, mask, cap in (("e", "e_rowidx", "e_mask", caps[1]),
                                        ("f", "f_rowidx", "f_emask", caps[2])):
            keys = np.where(msk[msk_sl[l][mask]], idx[idx_sl[l][rowidx]], -1)
            order, row_ptr = prepare_row_schedule(keys, cap)
            sched[s_sl[l][f"{kind}_order"]] = order
            sched[s_sl[l][f"{kind}_row_ptr"]] = row_ptr
    return PackedPlan(
        layout=layout,
        idx=idx,
        flt=flt,
        msk=msk,
        feat_vals=feat_vals,
        sched=sched,
        n_inc_edges=plan.total_inc_edges(),
        n_full_edges=plan.total_full_edges(),
        n_out_rows=plan.total_vertices(),
        out_rows_final=final_write_rows(plan),
    )


def build_packed_plan(
    model: GNNModel,
    g_old: CSRGraph,
    g_new: CSRGraph,
    batch: UpdateBatch,
    num_layers: int,
    hwm: Optional[BucketHysteresis] = None,
) -> PackedPlan:
    """Alg.-4 planning straight into the packed transfer format."""
    plan = build_plan(model, g_old, g_new, batch, num_layers)
    return pack_plan(plan, batch.feat_vertices, batch.feat_values, hwm=hwm)


# ====================================================================== #
# Batch-window fusion — merge independent batch plans into one plan
# (DaCe state-fusion idiom: consecutive states with disjoint interstate
# dependencies collapse into one; here consecutive update batches with
# disjoint plan footprints collapse into one packed plan / device step)
# ====================================================================== #
@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Typed knobs for batch-window fusion (nested in
    :class:`repro_torch.serve.api.EngineConfig` as ``fusion=``).

    ``window`` is the orchestrator's lookahead depth — up to this many
    pending batches are planned ahead and the maximal *independent prefix*
    (pairwise-disjoint :meth:`FusionWindow.footprint` sets) is merged into
    one plan and dispatched as one device step.  ``window=1`` or
    ``enabled=False`` keeps the config inert (the serial per-batch loop,
    byte-identical behavior)."""

    window: int = 4
    enabled: bool = True

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


class FusionWindow:
    """Value-independent overlap test + plan concatenation for batch fusion.

    Two batches may execute as one device step iff their plan *footprints*
    are disjoint.  The footprint of a plan is every global row id the
    batch's execution reads or writes, taken from the plan's own index
    tables (never from state values — the §V overlap contract):

    * ``e_src`` / ``f_src`` — previous-layer rows gathered (and, for
      source-degree-dependent models, rows whose normalization a degree
      change would alter);
    * ``e_dst`` / ``touch_rows`` / ``f_rows`` / ``out_rows`` — rows whose
      aggregation state or embedding is written, per layer;
    * the batch's feature-update vertices;
    * every row whose in-degree the batch changes (``deg_old != deg_new``).

    Disjointness makes the merge exact (bitwise, not approximately): each
    row's records come from exactly one constituent batch in unchanged
    relative order, every gathered row's value is unchanged by the other
    constituents (any writer would put it in that constituent's next-layer
    record sets → overlap → no fusion), and the merged degree tables
    ``(plans[0].deg_old, plans[-1].deg_new)`` agree with every
    constituent's own view on every row it touches.  The merged plan is an
    ordinary :class:`BatchPlan`, so the backend's ``plan(base_plan=...)``
    path packs it unchanged — its row schedules for ``delta_agg`` come from
    the merged ``e_rowidx`` — and capacity hysteresis
    (:class:`BucketHysteresis`) keeps the grown fused shapes inside the
    per-batch layouts' buckets."""

    def __init__(self, config: Optional[FusionConfig] = None) -> None:
        self.config = config or FusionConfig()

    # ---------------------------------------------------------------- #
    # overlap test (plan time, value-independent)
    # ---------------------------------------------------------------- #
    @staticmethod
    def footprint(plan: BatchPlan, batch: UpdateBatch) -> np.ndarray:
        """Sorted unique global row ids the batch's execution touches."""
        parts = [
            np.flatnonzero(plan.deg_old[:-1] != plan.deg_new[:-1]).astype(
                np.int64)
        ]
        if batch.feat_vertices is not None:
            parts.append(np.asarray(batch.feat_vertices, np.int64))
        for lp in plan.layers:
            parts.append(lp.e_src[lp.e_mask].astype(np.int64))
            parts.append(lp.e_dst[lp.e_mask].astype(np.int64))
            parts.append(lp.touch_rows[lp.touch_mask].astype(np.int64))
            parts.append(lp.f_rows[lp.f_mask].astype(np.int64))
            parts.append(lp.f_src[lp.f_emask].astype(np.int64))
            parts.append(lp.out_rows[lp.out_mask].astype(np.int64))
        return np.unique(np.concatenate(parts))

    @staticmethod
    def disjoint(fp: np.ndarray, other: np.ndarray) -> bool:
        """True iff two footprints (sorted unique) share no row."""
        if not fp.size or not other.size:
            return True
        return not np.isin(fp, other, assume_unique=True).any()

    def select_prefix(self, footprints: List[np.ndarray]) -> int:
        """Length of the maximal independent prefix (capped at ``window``).

        Greedy left-to-right: batch j joins the window iff its footprint is
        disjoint from the union of batches 0..j-1 — execution order inside
        the window is irrelevant once that holds, but the *prefix* rule
        keeps batches FIFO (batch j never dispatches before batch i < j)."""
        limit = min(len(footprints), self.config.window)
        if limit <= 1:
            return limit
        acc = footprints[0]
        k = 1
        while k < limit and self.disjoint(footprints[k], acc):
            acc = np.union1d(acc, footprints[k])
            k += 1
        return k

    # ---------------------------------------------------------------- #
    # plan concatenation (plan time, host only)
    # ---------------------------------------------------------------- #
    @staticmethod
    def merge(plans: List[BatchPlan],
              batches: List[UpdateBatch]) -> Tuple[BatchPlan, UpdateBatch]:
        """Concatenate independent batch plans into one merged plan.

        Per layer, live incremental records concatenate in batch order
        (each touched row's records stay contiguous and ordered, so the
        ``delta_agg`` row sums accumulate bitwise-identically to the serial
        per-batch dispatches) and are re-padded through the standard
        :func:`_pad_records` bucketing; constrained rows / out rows are
        re-sorted unions (disjoint, so plain sorted concatenation) with
        ``f_rowidx`` re-based into the merged row list.  The merged
        :class:`UpdateBatch` carries the concatenated edge/feature updates
        so feature scatters and cache invalidation see one logical batch."""
        assert len(plans) == len(batches) and len(plans) >= 1
        n = int(plans[0].deg_old.shape[0]) - 1
        num_layers = len(plans[0].layers)
        layers: List[LayerPlan] = []
        for l in range(num_layers):
            lps = [p.layers[l] for p in plans]
            src = np.concatenate(
                [lp.e_src[lp.e_mask] for lp in lps]).astype(np.int64)
            dst = np.concatenate(
                [lp.e_dst[lp.e_mask] for lp in lps]).astype(np.int64)
            sign = np.concatenate(
                [lp.e_sign[lp.e_mask] for lp in lps]).astype(np.float32)
            use_new = np.concatenate(
                [lp.e_use_new[lp.e_mask] for lp in lps]).astype(bool)
            w = np.concatenate(
                [lp.e_w[lp.e_mask] for lp in lps]).astype(np.float32)
            t = np.concatenate(
                [lp.e_t[lp.e_mask] for lp in lps]).astype(np.int32)
            rec = _pad_records(n, src, dst, sign, use_new, w, t)
            (e_src, e_dst, e_rowidx, e_sign, e_use_new, e_w, e_t, e_mask,
             touch_rows, touch_mask) = rec

            # constrained full path: disjoint row sets → sorted union; each
            # row's in-edge segment stays contiguous in its original order
            vf = np.sort(np.concatenate(
                [lp.f_rows[lp.f_mask] for lp in lps]).astype(np.int64))
            f_srcs = np.concatenate(
                [lp.f_src[lp.f_emask] for lp in lps]).astype(np.int64)
            row_of = np.concatenate(
                [lp.f_rows[lp.f_rowidx[lp.f_emask]] for lp in lps]
            ).astype(np.int64)
            f_ridx = np.searchsorted(vf, row_of)
            f_cap = next_bucket(vf.shape[0])
            fe_cap = next_bucket(f_srcs.shape[0])

            def padv(a, cap, fill, dt):
                out = np.full(cap, fill, dtype=dt)
                out[: len(a)] = a
                return out

            f_ws = np.concatenate([lp.f_w[lp.f_emask] for lp in lps])
            f_ts = np.concatenate([lp.f_t[lp.f_emask] for lp in lps])
            out = np.sort(np.concatenate(
                [lp.out_rows[lp.out_mask] for lp in lps]).astype(np.int64))
            o_cap = next_bucket(out.shape[0])
            layers.append(LayerPlan(
                e_src=e_src, e_dst=e_dst, e_rowidx=e_rowidx, e_sign=e_sign,
                e_use_new=e_use_new, e_w=e_w, e_t=e_t, e_mask=e_mask,
                touch_rows=touch_rows, touch_mask=touch_mask,
                f_rows=padv(vf, f_cap, n, np.int32),
                f_mask=padv(np.ones(vf.shape[0], bool), f_cap, False, bool),
                f_src=padv(f_srcs, fe_cap, n, np.int32),
                f_rowidx=padv(f_ridx, fe_cap, f_cap, np.int32),
                f_w=padv(f_ws, fe_cap, 0.0, np.float32),
                f_t=padv(f_ts, fe_cap, 0, np.int32),
                f_emask=padv(np.ones(f_srcs.shape[0], bool), fe_cap, False,
                             bool),
                out_rows=padv(out, o_cap, n, np.int32),
                out_mask=padv(np.ones(out.shape[0], bool), o_cap, False,
                              bool),
                n_inc_edges=sum(lp.n_inc_edges for lp in lps),
                n_full_edges=sum(lp.n_full_edges for lp in lps),
                n_touch_rows=int(touch_mask.sum()),
                n_full_rows=int(vf.shape[0]),
                n_out_rows=int(out.shape[0]),
                n_src_accessed=sum(lp.n_src_accessed for lp in lps),
            ))
        merged_plan = BatchPlan(
            layers=layers,
            deg_old=plans[0].deg_old,
            deg_new=plans[-1].deg_new,
            changed0=np.concatenate([p.changed0 for p in plans]),
        )
        return merged_plan, _merge_batches(batches)


def _merge_batches(batches: List[UpdateBatch]) -> UpdateBatch:
    """Concatenate independent update batches into one logical batch."""
    def cat(arrs, dt):
        return np.concatenate([np.asarray(a, dt) for a in arrs])

    ins_n = [np.asarray(b.ins_src).shape[0] for b in batches]
    ins_w = None
    if any(b.ins_weights is not None for b in batches):
        ins_w = cat([b.ins_weights if b.ins_weights is not None
                     else np.ones(k, np.float32)
                     for b, k in zip(batches, ins_n)], np.float32)
    ins_t = None
    if any(b.ins_etypes is not None for b in batches):
        ins_t = cat([b.ins_etypes if b.ins_etypes is not None
                     else np.zeros(k, np.int32)
                     for b, k in zip(batches, ins_n)], np.int32)
    feat_v = feat_x = None
    featured = [b for b in batches if b.feat_vertices is not None]
    if featured:
        feat_v = cat([b.feat_vertices for b in featured], np.int64)
        feat_x = np.concatenate(
            [np.asarray(b.feat_values, np.float32) for b in featured])
    return UpdateBatch(
        ins_src=cat([b.ins_src for b in batches], np.int64),
        ins_dst=cat([b.ins_dst for b in batches], np.int64),
        del_src=cat([b.del_src for b in batches], np.int64),
        del_dst=cat([b.del_dst for b in batches], np.int64),
        ins_weights=ins_w,
        ins_etypes=ins_t,
        feat_vertices=feat_v,
        feat_values=feat_x,
    )


# ====================================================================== #
# Compact residency — the host-resident substrates' index spaces
# ====================================================================== #
def remap_compact(indices: np.ndarray, rows: np.ndarray, n_compact: int,
                  scratch: int) -> np.ndarray:
    """Map global vertex ids → compact positions; unmatched → n_compact."""
    lut = np.full(scratch + 1, n_compact, np.int32)
    if rows.size:
        lut[rows] = np.arange(rows.shape[0], dtype=np.int32)
    return lut[np.asarray(indices, np.int64)]


@dataclasses.dataclass(frozen=True)
class ResidencySplit:
    """Plan-time ``[cached | miss]`` partition of one layer's needed rows,
    consumed by the device hot-row cache (``repro_torch.serve.hotcache``).

    Positions index the *original* ``rows`` array; ``hit`` positions are
    served from device cache slots, ``miss`` positions from the host
    staging gather.  ``admit_midx``/``admit_slots`` (filled in by
    ``HotRowCache.plan_reads``) name the miss positions whose staged
    values should additionally be installed into fresh cache slots."""

    hit_pos: np.ndarray  # int64 positions into rows (cached)
    hit_slots: np.ndarray  # int32 device slot per hit position
    miss_pos: np.ndarray  # int64 positions into rows (staged from host)
    miss_rows: np.ndarray  # int64 global row ids, = rows[miss_pos]
    admit_midx: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    admit_slots: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))


def split_residency(rows: np.ndarray, slot_of: np.ndarray,
                    exclude_rows: Optional[np.ndarray] = None) -> ResidencySplit:
    """Split ``rows`` into cached hits and staged misses against a slot
    table (``slot_of[r] < 0`` → not cached).  Rows in ``exclude_rows`` are
    forced to miss even when cached — the cache uses this for rows written
    earlier in the same batch, whose cached value is mid-update.  Pure
    metadata: never reads state values, so it is safe on the plan side of
    the plan/execute overlap."""
    rows = np.asarray(rows, np.int64)
    slots = slot_of[rows]
    hit = slots >= 0
    if exclude_rows is not None and np.asarray(exclude_rows).size:
        hit &= ~np.isin(rows, np.asarray(exclude_rows, np.int64))
    hit_pos = np.flatnonzero(hit).astype(np.int64)
    miss_pos = np.flatnonzero(~hit).astype(np.int64)
    return ResidencySplit(
        hit_pos=hit_pos,
        hit_slots=slots[hit_pos].astype(np.int32),
        miss_pos=miss_pos,
        miss_rows=rows[miss_pos],
    )
