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
(:func:`split_residency`) follow, and the row-sharded planners close the
module: :func:`shard_plan` (the ``"sharded"`` backend's per-shard
``[halo | local]`` workspaces and halo schedules) and :func:`hybrid_plan`
(the ``"sharded_offload"`` backend's per-shard compact staging tables),
each with per-shard row schedules in place of the reference's per-shard
block-CSR ones.

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
import math
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


def sched_slices(layout):
    """Static offset table of the schedule buffer: per layer, name → slice
    of ``e_order [e] | e_row_ptr [r+1] | f_order [fe] | f_row_ptr [f+1]``.
    Returns (per-layer dicts, total length).  ``layout`` is a packed or a
    sharded layout: one cap tuple per layer, leading with ``(e, r, f, fe)``."""
    return _sched_table(layout.caps)


def _sched_table(caps_per_layer):
    """:func:`sched_slices` over per-layer cap tuples."""
    off = 0
    out = []
    for caps in caps_per_layer:
        e, r, f, fe = caps[:4]
        d: Dict[str, slice] = {}
        for name, size in (("e_order", e), ("e_row_ptr", r + 1),
                           ("f_order", fe), ("f_row_ptr", f + 1)):
            d[name] = slice(off, off + size)
            off += size
        out.append(d)
    return tuple(out), off


def row_schedules(caps_per_layer, idx_sl, msk_sl, idx: np.ndarray,
                  msk: np.ndarray) -> np.ndarray:
    """The ``delta_agg`` / ``segment_spmm`` row schedules of one packed
    buffer row (:func:`sched_slices` layout): per layer, a stable argsort
    of the live records' row keys (``e_rowidx`` under ``e_mask``,
    ``f_rowidx`` under ``f_emask``), so each row sums its records in plan
    order, and the row offsets."""
    s_sl, s_len = _sched_table(caps_per_layer)
    sched = np.zeros(s_len, np.int32)
    for l, caps in enumerate(caps_per_layer):
        for kind, rowidx, mask, cap in (("e", "e_rowidx", "e_mask", caps[1]),
                                        ("f", "f_rowidx", "f_emask", caps[2])):
            keys = np.where(msk[msk_sl[l][mask]], idx[idx_sl[l][rowidx]], -1)
            order, row_ptr = prepare_row_schedule(keys, cap)
            sched[s_sl[l][f"{kind}_order"]] = order
            sched[s_sl[l][f"{kind}_row_ptr"]] = row_ptr
    return sched


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
    sched = row_schedules(layout.caps, idx_sl, msk_sl, idx, msk)
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


# ====================================================================== #
# Sharded plans — row-partitioned transfer format (multi-shard co-processing)
# ====================================================================== #
# Every global row r < n is owned by exactly one shard: owner(r) = r // rows_per
# with rows_per = ceil(n / n_shards).  All *destination* work (touched rows,
# constrained full-recompute rows, output rows — and therefore every scatter)
# is local to the owning shard; only previous-layer *source* embeddings can be
# remote.  Per layer the plan carries one replicated ``halo_rows`` list — the
# union over shards of source rows each shard needs but does not own — and
# every h-space index is remapped into the per-shard **workspace**
#
#     [ halo rows (exchanged, 0..halo_cap) | local block (rows_per + 1) ]
#
# so the device step gathers owned rows locally and remote rows from the
# exchanged halo buffer.  Destination-independent models skip the h[dst]
# gather and dst rows are owned anyway, so the exchange is bounded to
# frontier source rows.  Degree lookups ship as per-shard workspace-space
# tables, so no global [N+1] array reaches a shard.

# Per-layer cap tuple kinds: (e, r, f, fe, o, halo, ws) with
# ws = halo + rows_per + 1 (the workspace length, scratch slot last).
SH_IDX_FIELDS: Tuple[Tuple[str, int], ...] = (
    ("e_src", 0), ("e_dst", 0), ("e_rowidx", 0), ("e_t", 0),
    ("touch_rows", 1), ("f_rows", 2), ("f_src", 3), ("f_rowidx", 3),
    ("f_t", 3), ("out_rows", 4), ("f_rows_h", 2), ("out_rows_h", 4),
)
SH_FLT_FIELDS: Tuple[Tuple[str, int], ...] = (
    ("e_sign", 0), ("e_w", 0), ("f_w", 3), ("deg_old", 6), ("deg_new", 6),
)
SH_MSK_FIELDS: Tuple[Tuple[str, int], ...] = MSK_FIELDS


def shard_rows(n: int, n_shards: int) -> int:
    """Rows per shard (block row-partition of the n live vertices)."""
    return -(-n // n_shards)


@dataclasses.dataclass(frozen=True)
class ShardedLayout:
    """Static (hashable) shape descriptor of a sharded plan."""

    n: int
    n_shards: int
    rows_per: int
    feat_cap: int  # 0 → no feature updates
    caps: Tuple[Tuple[int, int, int, int, int, int, int], ...]
    # halo exchange strategy: "psum" broadcasts the global frontier,
    # "ppermute" runs the per-consumer rotation-round send/recv schedules
    halo_mode: str = "psum"
    # per-layer (owner, consumer)-pair capacity of the ppermute schedules
    pair_caps: Optional[Tuple[int, ...]] = None


@lru_cache(maxsize=None)
def sharded_layout_slices(layout: ShardedLayout):
    """Static offset tables for the sharded buffers.

    Returns (idx_sl, flt_sl, msk_sl, halo_sl, totals): per-layer field →
    slice dicts into one shard's row of the stacked (idx, flt, msk) buffers,
    per-layer halo-row slices into the replicated idx buffer, and the buffer
    lengths (idx_len, flt_len, msk_len, rep_len)."""
    idx_off = flt_off = msk_off = 0
    rep_off = layout.feat_cap  # idx_rep = [feat rows | per-layer halo rows]
    idx_sl, flt_sl, msk_sl, halo_sl = [], [], [], []
    for caps in layout.caps:
        di: Dict[str, slice] = {}
        for name, kind in SH_IDX_FIELDS:
            di[name] = slice(idx_off, idx_off + caps[kind])
            idx_off += caps[kind]
        df: Dict[str, slice] = {}
        for name, kind in SH_FLT_FIELDS:
            df[name] = slice(flt_off, flt_off + caps[kind])
            flt_off += caps[kind]
        dm: Dict[str, slice] = {}
        for name, kind in SH_MSK_FIELDS:
            dm[name] = slice(msk_off, msk_off + caps[kind])
            msk_off += caps[kind]
        halo_sl.append(slice(rep_off, rep_off + caps[5]))
        rep_off += caps[5]
        idx_sl.append(di)
        flt_sl.append(df)
        msk_sl.append(dm)
    return (
        tuple(idx_sl), tuple(flt_sl), tuple(msk_sl), tuple(halo_sl),
        (idx_off, flt_off, msk_off, rep_off),
    )


@dataclasses.dataclass
class ShardedPlan:
    """A batch plan partitioned per shard: stacked ``[n_shards, ·]``
    buffers (each shard reads only its row — only the rows it touches) plus
    small replicated side tables (halo row lists, feature rows)."""

    layout: ShardedLayout
    idx_sh: np.ndarray  # int32  [S, idx_len] per-shard index fields
    flt_sh: np.ndarray  # float32 [S, flt_len] (incl. per-layer ws deg tables)
    msk_sh: np.ndarray  # bool   [S, msk_len]
    idx_rep: np.ndarray  # int32 [rep_len] replicated: feat rows | halo rows
    msk_rep: np.ndarray  # bool  [feat_cap] feature-row mask
    feat_vals: Optional[np.ndarray]  # float32 [feat_cap, d0] when feat_cap > 0
    # per-shard row schedules of step 1's and step 3's records, int32
    # [S, sched_len] in the :func:`sched_slices` layout (what each shard's
    # delta_agg / segment_spmm launch reads)
    sched_sh: np.ndarray
    # accounting
    n_inc_edges: int
    n_full_edges: int
    n_out_rows: int
    n_halo_rows: int  # live frontier rows exchanged, summed over layers
    # global ids of final-layer rows this plan may write (serving undo log)
    out_rows_final: Optional[np.ndarray] = None
    # per-consumer halo schedules ("ppermute" mode): one
    # (send_pos [S, S-1, pair_cap], recv_pos [S, S-1, pair_cap]) pair per
    # layer — round k moves pair (owner o → consumer (o+k) mod S)
    comms_sh: Optional[Tuple[Tuple[np.ndarray, np.ndarray], ...]] = None
    # per-layer halo rows this plan moves between shards under its mode:
    # ppermute → Σ per-pair remote deliveries; psum → halo_rows × S
    comms_rows: Optional[Tuple[int, ...]] = None


def _owner_runs(owners: np.ndarray, n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """Single-pass owner partition: one stable argsort, then contiguous-run
    boundaries.  ``order[starts[s]:starts[s+1]]`` are the indices owned by
    shard ``s``, in original record order (stable sort)."""
    order = np.argsort(owners, kind="stable")
    starts = np.searchsorted(owners[order], np.arange(n_shards + 1))
    return order, starts


def _live_owner_partition(lp: LayerPlan, rows_per: int) -> Dict[str, np.ndarray]:
    """Strip one layer plan to its live records/rows and tag each with the
    shard that owns its destination row — the common first pass of both the
    sharded (`shard_plan`) and the hybrid (`hybrid_plan`) partitioners."""
    live = lp.e_mask
    fe_live = lp.f_emask
    f_cap_old = lp.f_rows.shape[0]
    fe_rowg = lp.f_rows[np.minimum(lp.f_rowidx, f_cap_old - 1)].astype(np.int64)
    es = lp.e_src[live].astype(np.int64)
    ed = lp.e_dst[live].astype(np.int64)
    tr = lp.touch_rows[lp.touch_mask].astype(np.int64)
    f_rows = lp.f_rows[lp.f_mask].astype(np.int64)
    fs = lp.f_src[fe_live].astype(np.int64)
    fe_row = fe_rowg[fe_live]
    outr = lp.out_rows[lp.out_mask].astype(np.int64)
    return dict(
        es=es, ed=ed, d_own=ed // rows_per,
        e_sign=lp.e_sign[live], e_use_new=lp.e_use_new[live],
        e_w=lp.e_w[live], e_t=lp.e_t[live],
        tr=tr, tr_own=tr // rows_per,
        f_rows=f_rows, f_own=f_rows // rows_per,
        fs=fs, fe_row=fe_row, fe_own=fe_row // rows_per,
        f_w=lp.f_w[fe_live], f_t=lp.f_t[fe_live],
        outr=outr, o_own=outr // rows_per,
    )


def _shard_schedules(caps_per_layer, idx_sl, msk_sl, idx_sh: np.ndarray,
                     msk_sh: np.ndarray) -> np.ndarray:
    """Per-shard row schedules, stacked ``[S, sched_len]``: each shard's
    :func:`row_schedules` over its own row of the stacked buffers.  The
    owner partition is stable, so each row's records keep their relative
    plan order and sum as the single-device engine sums them."""
    return np.stack([row_schedules(caps_per_layer, idx_sl, msk_sl, idx_sh[s], msk_sh[s])
                     for s in range(idx_sh.shape[0])])


def shard_plan(
    plan: BatchPlan,
    n_shards: int,
    feat_vertices: Optional[np.ndarray] = None,
    feat_values: Optional[np.ndarray] = None,
    hwm: Optional[BucketHysteresis] = None,
    single_pass: bool = True,
    halo_mode: str = "psum",
    pair_hysteresis: float = 0.0,
) -> ShardedPlan:
    """Partition a :class:`BatchPlan` row-wise over ``n_shards`` and pack it
    into the sharded transfer format (see the section comment).

    ``single_pass=True`` (default) fills the stacked buffers by argsorting
    each live-record field by owner shard once and slicing contiguous runs
    (O(E log E + S·caps) host time).  ``False`` keeps the per-shard re-scan
    (O(S·E)) as the equality reference.  ``halo_mode="ppermute"``
    additionally emits the per-consumer rotation send/recv schedules
    (:func:`_sharded_comms_schedules`); ``pair_hysteresis`` pads each
    per-pair capacity ``(1 + pair_hysteresis)×`` before bucketing."""
    n = plan.deg_old.shape[0] - 1
    rows_per = shard_rows(n, n_shards)
    S = n_shards

    if feat_vertices is not None and np.asarray(feat_vertices).size:
        fr = np.asarray(feat_vertices, np.int64)
        fv = np.asarray(feat_values, np.float32)
        feat_cap = _cap_of(hwm, "feat", fr.shape[0])
    else:
        fr = np.zeros(0, np.int64)
        fv = None
        feat_cap = 0

    # ---- pass 1: per-layer live partitions + capacities ----
    layers = []
    caps_all = []
    halo_total = 0
    for l, lp in enumerate(plan.layers):
        art = _live_owner_partition(lp, rows_per)
        es, ed, fs = art["es"], art["ed"], art["fs"]

        # frontier rows: sources some consuming shard does not own
        halo_rows = np.unique(np.concatenate([
            es[es // rows_per != art["d_own"]],
            fs[fs // rows_per != art["fe_own"]],
        ]))
        halo_total += int(halo_rows.shape[0])
        halo_cap = _cap_of(hwm, (l, "halo"), halo_rows.shape[0])

        def per_shard_max(owners) -> int:
            return int(np.bincount(owners, minlength=S).max()) if owners.size else 0

        e_cap = _cap_of(hwm, (l, 0), per_shard_max(art["d_own"]))
        r_cap = _cap_of(hwm, (l, 1), per_shard_max(art["tr_own"]))
        f_cap = _cap_of(hwm, (l, 2), per_shard_max(art["f_own"]))
        fe_cap = _cap_of(hwm, (l, 3), per_shard_max(art["fe_own"]))
        o_cap = _cap_of(hwm, (l, 4), per_shard_max(art["o_own"]))
        ws = halo_cap + rows_per + 1
        caps_all.append((e_cap, r_cap, f_cap, fe_cap, o_cap, halo_cap, ws))
        art["halo_rows"] = halo_rows
        layers.append(art)

    layout = ShardedLayout(
        n=n, n_shards=S, rows_per=rows_per, feat_cap=feat_cap,
        caps=tuple(caps_all),
    )
    idx_sl, flt_sl, msk_sl, halo_sl, (idx_len, flt_len, msk_len, rep_len) = (
        sharded_layout_slices(layout)
    )

    # ---- pass 2: fill the stacked + replicated buffers ----
    idx_sh = np.zeros((S, idx_len), np.int32)
    flt_sh = np.zeros((S, flt_len), np.float32)
    msk_sh = np.zeros((S, msk_len), bool)
    idx_rep = np.full(rep_len, -1, np.int32)
    msk_rep = np.zeros(feat_cap, bool)
    feat_vals = None
    if feat_cap:
        idx_rep[: fr.shape[0]] = fr
        msk_rep[: fr.shape[0]] = True
        feat_vals = np.zeros((feat_cap, fv.shape[1]), np.float32)
        feat_vals[: fv.shape[0]] = fv

    fill = _fill_sharded_single_pass if single_pass else _fill_sharded_reference
    fill(plan, layout, layers, idx_sl, flt_sl, msk_sl, halo_sl,
         idx_sh, flt_sh, msk_sh, idx_rep)
    sched_sh = _shard_schedules(layout.caps, idx_sl, msk_sl, idx_sh, msk_sh)

    comms_sh = None
    if halo_mode == "ppermute":
        comms_sh, pair_caps, comms_rows = _sharded_comms_schedules(
            layout, layers, hwm, pair_hysteresis
        )
        layout = dataclasses.replace(
            layout, halo_mode="ppermute", pair_caps=pair_caps)
    else:
        # broadcast volume: every shard receives every layer's full halo
        comms_rows = tuple(
            int(art["halo_rows"].shape[0]) * S for art in layers)

    return ShardedPlan(
        layout=layout,
        idx_sh=idx_sh,
        flt_sh=flt_sh,
        msk_sh=msk_sh,
        idx_rep=idx_rep,
        msk_rep=msk_rep,
        feat_vals=feat_vals,
        sched_sh=sched_sh,
        n_inc_edges=plan.total_inc_edges(),
        n_full_edges=plan.total_full_edges(),
        n_out_rows=plan.total_vertices(),
        n_halo_rows=halo_total,
        out_rows_final=final_write_rows(plan),
        comms_sh=comms_sh,
        comms_rows=comms_rows,
    )


def _fill_sharded_reference(plan, layout, layers, idx_sl, flt_sl, msk_sl,
                            halo_sl, idx_sh, flt_sh, msk_sh, idx_rep) -> None:
    """Per-shard fill: each of the S iterations re-scans the full live-record
    arrays (O(S·E)) and re-runs ``searchsorted`` per field.  Kept as the
    equality reference for the single-pass fill."""
    S, rows_per, n = layout.n_shards, layout.rows_per, layout.n

    def fill_idx(s: int, sl: slice, vals: np.ndarray, pad: int) -> None:
        idx_sh[s, sl] = pad
        idx_sh[s, sl.start : sl.start + vals.shape[0]] = vals

    for l, (art, caps) in enumerate(zip(layers, layout.caps)):
        e_cap, r_cap, f_cap, fe_cap, o_cap, halo_cap, ws = caps
        ws_scratch = halo_cap + rows_per
        halo_rows = art["halo_rows"]
        idx_rep[halo_sl[l].start : halo_sl[l].start + halo_rows.shape[0]] = halo_rows

        deg_halo_old = np.zeros(halo_cap, np.float32)
        deg_halo_new = np.zeros(halo_cap, np.float32)
        deg_halo_old[: halo_rows.shape[0]] = plan.deg_old[halo_rows]
        deg_halo_new[: halo_rows.shape[0]] = plan.deg_new[halo_rows]

        for s in range(S):
            lo = s * rows_per

            def ws_of(rows: np.ndarray) -> np.ndarray:
                own = (rows >= lo) & (rows < lo + rows_per)
                hpos = np.searchsorted(halo_rows, rows)
                hpos = np.clip(hpos, 0, max(0, halo_rows.shape[0] - 1))
                return np.where(own, halo_cap + (rows - lo), hpos).astype(np.int32)

            sel = art["d_own"] == s
            ne = int(sel.sum())
            ed_s = art["ed"][sel]
            tr_s = art["tr"][art["tr_own"] == s]
            fr_s = art["f_rows"][art["f_own"] == s]
            fe_sel = art["fe_own"] == s
            fs_s = art["fs"][fe_sel]
            out_s = art["outr"][art["o_own"] == s]

            di, df, dm = idx_sl[l], flt_sl[l], msk_sl[l]
            fill_idx(s, di["e_src"], ws_of(art["es"][sel]), ws_scratch)
            fill_idx(s, di["e_dst"], ws_of(ed_s), ws_scratch)
            fill_idx(s, di["e_rowidx"],
                     np.searchsorted(tr_s, ed_s).astype(np.int32), r_cap)
            fill_idx(s, di["e_t"], art["e_t"][sel], 0)
            fill_idx(s, di["touch_rows"], (tr_s - lo).astype(np.int32), rows_per)
            fill_idx(s, di["f_rows"], (fr_s - lo).astype(np.int32), rows_per)
            fill_idx(s, di["f_src"], ws_of(fs_s), ws_scratch)
            fill_idx(s, di["f_rowidx"],
                     np.searchsorted(fr_s, art["fe_row"][fe_sel]).astype(np.int32),
                     f_cap)
            fill_idx(s, di["f_t"], art["f_t"][fe_sel], 0)
            fill_idx(s, di["out_rows"], (out_s - lo).astype(np.int32), rows_per)
            fill_idx(s, di["f_rows_h"], ws_of(fr_s), ws_scratch)
            fill_idx(s, di["out_rows_h"], ws_of(out_s), ws_scratch)

            flt_sh[s, df["e_sign"].start : df["e_sign"].start + ne] = art["e_sign"][sel]
            flt_sh[s, df["e_w"].start : df["e_w"].start + ne] = art["e_w"][sel]
            flt_sh[s, df["f_w"].start : df["f_w"].start + fs_s.shape[0]] = (
                art["f_w"][fe_sel])
            li = np.arange(lo, lo + rows_per)
            dl_old = np.where(li < n, plan.deg_old[np.minimum(li, n)], 0.0)
            dl_new = np.where(li < n, plan.deg_new[np.minimum(li, n)], 0.0)
            flt_sh[s, df["deg_old"]] = np.concatenate(
                [deg_halo_old, dl_old, [0.0]]).astype(np.float32)
            flt_sh[s, df["deg_new"]] = np.concatenate(
                [deg_halo_new, dl_new, [0.0]]).astype(np.float32)

            nr, nf, nfe, no = (tr_s.shape[0], fr_s.shape[0],
                               fs_s.shape[0], out_s.shape[0])
            msk_sh[s, dm["e_mask"].start : dm["e_mask"].start + ne] = True
            msk_sh[s, dm["e_use_new"].start : dm["e_use_new"].start + ne] = (
                art["e_use_new"][sel])
            msk_sh[s, dm["touch_mask"].start : dm["touch_mask"].start + nr] = True
            msk_sh[s, dm["f_mask"].start : dm["f_mask"].start + nf] = True
            msk_sh[s, dm["f_emask"].start : dm["f_emask"].start + nfe] = True
            msk_sh[s, dm["out_mask"].start : dm["out_mask"].start + no] = True


def _fill_sharded_single_pass(plan, layout, layers, idx_sl, flt_sl, msk_sl,
                              halo_sl, idx_sh, flt_sh, msk_sh, idx_rep) -> None:
    """Single-pass fill: every owner partition is one stable argsort +
    contiguous-run slicing (:func:`_owner_runs`), and every
    ``searchsorted`` runs once per field over the full array instead of
    once per shard, so host plan time stays flat in the shard count.
    Produces buffers bit-identical to :func:`_fill_sharded_reference`."""
    S, rows_per, n = layout.n_shards, layout.rows_per, layout.n

    def fill_idx(s: int, sl: slice, vals: np.ndarray, pad: int) -> None:
        idx_sh[s, sl] = pad
        idx_sh[s, sl.start : sl.start + vals.shape[0]] = vals

    for l, (art, caps) in enumerate(zip(layers, layout.caps)):
        e_cap, r_cap, f_cap, fe_cap, o_cap, halo_cap, ws = caps
        ws_scratch = halo_cap + rows_per
        halo_rows = art["halo_rows"]
        idx_rep[halo_sl[l].start : halo_sl[l].start + halo_rows.shape[0]] = halo_rows

        deg_halo_old = np.zeros(halo_cap, np.float32)
        deg_halo_new = np.zeros(halo_cap, np.float32)
        deg_halo_old[: halo_rows.shape[0]] = plan.deg_old[halo_rows]
        deg_halo_new[: halo_rows.shape[0]] = plan.deg_new[halo_rows]

        # ---- once per layer: owner runs + global lookups ----
        e_ord, e_st = _owner_runs(art["d_own"], S)
        fe_ord, fe_st = _owner_runs(art["fe_own"], S)
        # tr / f_rows / outr are sorted, so owner runs are already contiguous
        tr_st = np.searchsorted(art["tr_own"], np.arange(S + 1))
        f_st = np.searchsorted(art["f_own"], np.arange(S + 1))
        o_st = np.searchsorted(art["o_own"], np.arange(S + 1))

        # h-space fields: owned rows use a local offset, remote rows the
        # halo slot — resolved per shard below from these global tables
        def ws_split(rows: np.ndarray):
            hpos = np.searchsorted(halo_rows, rows)
            hpos = np.clip(hpos, 0, max(0, halo_rows.shape[0] - 1)).astype(np.int64)
            return hpos, rows // rows_per

        es_h, es_own = ws_split(art["es"])
        fs_h, fs_own = ws_split(art["fs"])
        e_row_g = np.searchsorted(art["tr"], art["ed"])
        fe_row_g = np.searchsorted(art["f_rows"], art["fe_row"])

        for s in range(S):
            lo = s * rows_per
            esel = e_ord[e_st[s] : e_st[s + 1]]
            fesel = fe_ord[fe_st[s] : fe_st[s + 1]]
            ne, nfe = esel.shape[0], fesel.shape[0]
            ed_s = art["ed"][esel]
            tr_s = art["tr"][tr_st[s] : tr_st[s + 1]]
            fr_s = art["f_rows"][f_st[s] : f_st[s + 1]]
            fs_s = art["fs"][fesel]
            out_s = art["outr"][o_st[s] : o_st[s + 1]]

            def ws_of(rows, hpos, own):
                return np.where(own == s, halo_cap + (rows - lo), hpos).astype(np.int32)

            di, df, dm = idx_sl[l], flt_sl[l], msk_sl[l]
            fill_idx(s, di["e_src"],
                     ws_of(art["es"][esel], es_h[esel], es_own[esel]), ws_scratch)
            # destination rows are owner-local by construction
            fill_idx(s, di["e_dst"], (halo_cap + ed_s - lo).astype(np.int32), ws_scratch)
            fill_idx(s, di["e_rowidx"], (e_row_g[esel] - tr_st[s]).astype(np.int32), r_cap)
            fill_idx(s, di["e_t"], art["e_t"][esel], 0)
            fill_idx(s, di["touch_rows"], (tr_s - lo).astype(np.int32), rows_per)
            fill_idx(s, di["f_rows"], (fr_s - lo).astype(np.int32), rows_per)
            fill_idx(s, di["f_src"], ws_of(fs_s, fs_h[fesel], fs_own[fesel]), ws_scratch)
            fill_idx(s, di["f_rowidx"], (fe_row_g[fesel] - f_st[s]).astype(np.int32), f_cap)
            fill_idx(s, di["f_t"], art["f_t"][fesel], 0)
            fill_idx(s, di["out_rows"], (out_s - lo).astype(np.int32), rows_per)
            fill_idx(s, di["f_rows_h"], (halo_cap + fr_s - lo).astype(np.int32), ws_scratch)
            fill_idx(s, di["out_rows_h"], (halo_cap + out_s - lo).astype(np.int32), ws_scratch)

            flt_sh[s, df["e_sign"].start : df["e_sign"].start + ne] = art["e_sign"][esel]
            flt_sh[s, df["e_w"].start : df["e_w"].start + ne] = art["e_w"][esel]
            flt_sh[s, df["f_w"].start : df["f_w"].start + nfe] = art["f_w"][fesel]
            li = np.arange(lo, lo + rows_per)
            dl_old = np.where(li < n, plan.deg_old[np.minimum(li, n)], 0.0)
            dl_new = np.where(li < n, plan.deg_new[np.minimum(li, n)], 0.0)
            flt_sh[s, df["deg_old"]] = np.concatenate(
                [deg_halo_old, dl_old, [0.0]]).astype(np.float32)
            flt_sh[s, df["deg_new"]] = np.concatenate(
                [deg_halo_new, dl_new, [0.0]]).astype(np.float32)

            nr, nf, no = tr_s.shape[0], fr_s.shape[0], out_s.shape[0]
            msk_sh[s, dm["e_mask"].start : dm["e_mask"].start + ne] = True
            msk_sh[s, dm["e_use_new"].start : dm["e_use_new"].start + ne] = (
                art["e_use_new"][esel])
            msk_sh[s, dm["touch_mask"].start : dm["touch_mask"].start + nr] = True
            msk_sh[s, dm["f_mask"].start : dm["f_mask"].start + nf] = True
            msk_sh[s, dm["f_emask"].start : dm["f_emask"].start + nfe] = True
            msk_sh[s, dm["out_mask"].start : dm["out_mask"].start + no] = True


def _remote_deliveries(art: Dict[str, np.ndarray], rows_per: int,
                       n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique (owner, consumer, row) halo deliveries of one layer: every
    source row some consuming shard gathers but does not own, deduplicated
    per consumer — the value-independent ground truth both the ppermute
    schedules and the coverage tests are built from."""
    es, fs = art["es"], art["fs"]
    re_m = es // rows_per != art["d_own"]
    rf_m = fs // rows_per != art["fe_own"]
    src = np.concatenate([es[re_m], fs[rf_m]])
    cons = np.concatenate([art["d_own"][re_m], art["fe_own"][rf_m]])
    key = np.unique(cons.astype(np.int64) * (n + 1) + src)
    cons_u, src_u = key // (n + 1), key % (n + 1)
    return src_u // rows_per, cons_u, src_u


def _sharded_comms_schedules(layout, layers, hwm: Optional[BucketHysteresis],
                             pair_hysteresis: float):
    """Per-consumer rotation send/recv schedules for the ppermute halo
    exchange, one (send_pos, recv_pos) pair of ``[S, S-1, pair_cap]`` int32
    tables per layer.

    Round ``k`` (1-based) moves shard ``j → (j+k) mod S``, so the pair
    (owner o → consumer c) rides round ``(c - o) mod S``: ``send_pos[o,
    k-1]`` holds the owner-local positions (pad → ``rows_per``, the block's
    scratch row) and ``recv_pos[c, k-1]`` the consumer's halo-slot
    positions (pad → ``halo_cap``, the receive buffer's dump row).  All
    shards and rounds of a layer share one hysteresis-held pair capacity."""
    S, rows_per, n = layout.n_shards, layout.rows_per, layout.n
    K = S - 1
    out, pair_caps, rows_sent = [], [], []
    for l, art in enumerate(layers):
        halo_rows = art["halo_rows"]
        halo_cap = layout.caps[l][5]
        own_u, cons_u, src_u = _remote_deliveries(art, rows_per, n)
        rows_sent.append(int(src_u.shape[0]))

        order = np.lexsort((src_u, cons_u, own_u))
        own_u, cons_u, src_u = own_u[order], cons_u[order], src_u[order]
        pair_key = own_u * S + cons_u
        starts = np.concatenate([
            [0], np.flatnonzero(np.diff(pair_key)) + 1, [pair_key.size],
        ]) if pair_key.size else np.zeros(1, np.int64)
        raw_max = int(np.diff(starts).max()) if pair_key.size else 0
        cap = _cap_of(hwm, (l, "pair"), int(math.ceil(raw_max * (1.0 + pair_hysteresis))))

        send = np.full((S, K, cap), rows_per, np.int32)
        recv = np.full((S, K, cap), halo_cap, np.int32)
        for a, b in zip(starts[:-1], starts[1:]):
            if b == a:
                continue
            o, c = int(own_u[a]), int(cons_u[a])
            k = (c - o) % S
            rows = src_u[a:b]
            send[o, k - 1, : b - a] = (rows - o * rows_per).astype(np.int32)
            recv[c, k - 1, : b - a] = np.searchsorted(halo_rows, rows).astype(np.int32)
        out.append((send, recv))
        pair_caps.append(cap)
    return tuple(out), tuple(pair_caps), tuple(rows_sent)


# ====================================================================== #
# Hybrid plans — sharded offload transfer format: per-shard *compact*
# [halo | local] workspaces (paper §V-B at multi-shard scale).  Unlike
# ShardedPlan, whose per-shard workspace embeds the full local block
# (rows_per + 1 rows), the hybrid stages only the rows each shard's plan
# touches, so a shard's device footprint is O(its affected subgraph) — the
# persistent state stays host-resident in per-shard row blocks.  No device
# collective is needed: halo rows are gathered from the owning shards' *host*
# blocks at staging time (the host is the exchange medium between layers).
# ====================================================================== #
def _remap_sorted(indices: np.ndarray, rows: np.ndarray, cap: int) -> np.ndarray:
    """:func:`remap_compact` for *sorted* ``rows``: O(k log k) searchsorted
    instead of an O(V) lookup table (hybrid planning calls this per shard per
    layer).  Unmatched values map to ``cap``."""
    v = np.asarray(indices, np.int64)
    if rows.size == 0:
        return np.full(v.shape, cap, np.int32)
    pos = np.clip(np.searchsorted(rows, v), 0, rows.shape[0] - 1)
    return np.where(rows[pos] == v, pos, cap).astype(np.int32)


# Per-layer cap tuple: (e, r, f, fe, o, nh, ns) — nh is the compact h^{l-1}
# workspace (gather space), ns the compact state workspace (scatter space);
# both get one scratch slot at index cap when staged.  Field kinds index the
# cap that gives the field's *length*; -1 means the nh+1 degree table.
HYB_IDX_FIELDS: Tuple[Tuple[str, int], ...] = SH_IDX_FIELDS
HYB_FLT_FIELDS: Tuple[Tuple[str, int], ...] = (
    ("e_sign", 0), ("e_w", 0), ("f_w", 3), ("deg_old", -1), ("deg_new", -1),
)
HYB_MSK_FIELDS: Tuple[Tuple[str, int], ...] = MSK_FIELDS


@dataclasses.dataclass(frozen=True)
class HybridLayerLayout:
    """Static (hashable) shape descriptor of one hybrid layer's staging."""

    n: int
    n_shards: int
    caps: Tuple[int, int, int, int, int, int, int]  # (e, r, f, fe, o, nh, ns)


@lru_cache(maxsize=None)
def hybrid_layout_slices(ll: HybridLayerLayout):
    """Static offset tables into one shard's row of the stacked hybrid
    buffers; returns (idx_sl, flt_sl, msk_sl, (idx_len, flt_len, msk_len))."""
    idx_off = flt_off = msk_off = 0
    di: Dict[str, slice] = {}
    for name, kind in HYB_IDX_FIELDS:
        di[name] = slice(idx_off, idx_off + ll.caps[kind])
        idx_off += ll.caps[kind]
    df: Dict[str, slice] = {}
    for name, kind in HYB_FLT_FIELDS:
        ln = ll.caps[5] + 1 if kind == -1 else ll.caps[kind]
        df[name] = slice(flt_off, flt_off + ln)
        flt_off += ln
    dm: Dict[str, slice] = {}
    for name, kind in HYB_MSK_FIELDS:
        dm[name] = slice(msk_off, msk_off + ll.caps[kind])
        msk_off += ll.caps[kind]
    return di, df, dm, (idx_off, flt_off, msk_off)


@dataclasses.dataclass
class HybridLayerPlan:
    """One layer's per-shard compact staging tables, stacked ``[S, ·]``.

    ``need_h``/``srows`` name the *global* rows each shard stages (gather /
    scatter sets); every plan index inside ``idx_sh`` is remapped into the
    matching compact space (pad → the space's scratch slot).  ``e_rowidx``
    and ``f_rowidx`` index the shard's touched and constrained row lists,
    whose orders the row schedules ``sched_sh`` follow."""

    layout: HybridLayerLayout
    need_h: np.ndarray  # int64 [S, nh_cap] global ids (pad rows → 0, masked)
    need_mask: np.ndarray  # bool [S, nh_cap]
    srows: np.ndarray  # int64 [S, ns_cap] global ids (pad rows → 0, masked)
    srows_mask: np.ndarray  # bool [S, ns_cap]
    idx_sh: np.ndarray  # int32 [S, idx_len]
    flt_sh: np.ndarray  # float32 [S, flt_len] (incl. compact deg tables)
    msk_sh: np.ndarray  # bool [S, msk_len]
    # per-shard row schedules of the layer's records, int32 [S, sched_len]
    # (the one-layer :func:`sched_slices` layout)
    sched_sh: np.ndarray = None
    # live need rows whose owner is another shard — the halo this layer
    # moves between shards regardless of serving path (comms counters)
    n_halo_remote: int = 0
    # device-served new-view patch (halo_mode="ppermute"): flat [S·nh_cap]
    # positions whose rows the *previous* layer just wrote, and the source
    # index into its device-resident outputs (l=0: into the batch's feature
    # rows) — these rows skip the staged h_new copy entirely
    patch_pos: Optional[np.ndarray] = None
    patch_src: Optional[np.ndarray] = None

    @property
    def nh_cap(self) -> int:
        return self.layout.caps[5]

    @property
    def ns_cap(self) -> int:
        return self.layout.caps[6]


@dataclasses.dataclass
class HybridPlan:
    layers: List[HybridLayerPlan]


def hybrid_sched_slices(ll: HybridLayerLayout):
    """One hybrid layer's schedule slices (name → slice) and length."""
    s_sl, s_len = _sched_table((ll.caps,))
    return s_sl[0], s_len


def _match_positions(dst_keys: np.ndarray, src_rows: np.ndarray):
    """Positions of ``dst_keys`` found in ``src_rows`` plus the matching
    source indices (``src_rows`` unique), so a device-side patch built from
    these tables is position-for-position the host override's."""
    if src_rows.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(src_rows)
    pos = np.searchsorted(src_rows[order], dst_keys)
    pos = np.clip(pos, 0, src_rows.size - 1)
    hit = src_rows[order][pos] == dst_keys
    return (np.flatnonzero(hit).astype(np.int64),
            order[pos[hit]].astype(np.int64))


def hybrid_plan(
    plan: BatchPlan,
    n_shards: int,
    hwm: Optional[BucketHysteresis] = None,
    feat_vertices: Optional[np.ndarray] = None,
    halo_mode: str = "psum",
) -> HybridPlan:
    """Partition a :class:`BatchPlan` by destination-row owner and emit the
    per-shard compact staging tables (see the section comment).  All
    scatters are owner-local by construction; the gather set (``need_h``)
    may span other shards' rows — those are served from host blocks at
    staging time.

    ``halo_mode="ppermute"`` additionally emits the device-served new-view
    patch tables (``patch_pos``/``patch_src``): the rows of each layer's
    gather set the previous layer just wrote are served from its
    still-device-resident outputs (l=0: from the batch's feature values), so
    the staged ``h_new`` copy disappears.  ``feat_vertices`` is the batch's
    feature-update row list (the l=0 patch source)."""
    n = plan.deg_old.shape[0] - 1
    rows_per = shard_rows(n, n_shards)
    S = n_shards
    out_layers: List[HybridLayerPlan] = []
    device_patch = halo_mode == "ppermute"
    if feat_vertices is not None and np.asarray(feat_vertices).size:
        prev_keys = np.asarray(feat_vertices, np.int64)
    else:
        prev_keys = np.zeros(0, np.int64)
    prev_live_pos: Optional[np.ndarray] = None

    for l, lp in enumerate(plan.layers):
        art = _live_owner_partition(lp, rows_per)
        es, ed, fs = art["es"], art["ed"], art["fs"]
        tr, f_rows, outr = art["tr"], art["f_rows"], art["outr"]
        fe_row = art["fe_row"]

        e_ord, e_st = _owner_runs(art["d_own"], S)
        fe_ord, fe_st = _owner_runs(art["fe_own"], S)
        tr_st = np.searchsorted(art["tr_own"], np.arange(S + 1))
        f_st = np.searchsorted(art["f_own"], np.arange(S + 1))
        o_st = np.searchsorted(art["o_own"], np.arange(S + 1))

        # per-shard gather/scatter row sets
        need_list, srow_list = [], []
        for s in range(S):
            esel = e_ord[e_st[s] : e_st[s + 1]]
            fesel = fe_ord[fe_st[s] : fe_st[s + 1]]
            out_s = outr[o_st[s] : o_st[s + 1]]
            need_list.append(np.unique(np.concatenate([
                es[esel], ed[esel], fs[fesel],
                f_rows[f_st[s] : f_st[s + 1]], out_s,
            ])))
            srow_list.append(out_s)

        def runmax(starts) -> int:
            return int(np.diff(starts).max()) if S else 0

        e_cap = _cap_of(hwm, (l, 0), runmax(e_st))
        r_cap = _cap_of(hwm, (l, 1), runmax(tr_st))
        f_cap = _cap_of(hwm, (l, 2), runmax(f_st))
        fe_cap = _cap_of(hwm, (l, 3), runmax(fe_st))
        o_cap = _cap_of(hwm, (l, 4), runmax(o_st))
        nh_cap = _cap_of(hwm, (l, "nh"), max(v.shape[0] for v in need_list))
        ns_cap = o_cap  # srows == live out rows, so the buckets coincide
        llayout = HybridLayerLayout(
            n=n, n_shards=S,
            caps=(e_cap, r_cap, f_cap, fe_cap, o_cap, nh_cap, ns_cap),
        )
        di, df, dm, (idx_len, flt_len, msk_len) = hybrid_layout_slices(llayout)

        need_h = np.zeros((S, nh_cap), np.int64)
        need_mask = np.zeros((S, nh_cap), bool)
        srows = np.zeros((S, ns_cap), np.int64)
        srows_mask = np.zeros((S, ns_cap), bool)
        idx_sh = np.zeros((S, idx_len), np.int32)
        flt_sh = np.zeros((S, flt_len), np.float32)
        msk_sh = np.zeros((S, msk_len), bool)

        def fill_idx(s: int, sl: slice, vals: np.ndarray, pad: int) -> None:
            idx_sh[s, sl] = pad
            idx_sh[s, sl.start : sl.start + vals.shape[0]] = vals

        for s in range(S):
            esel = e_ord[e_st[s] : e_st[s + 1]]
            fesel = fe_ord[fe_st[s] : fe_st[s + 1]]
            ne, nfe = esel.shape[0], fesel.shape[0]
            need = need_list[s]
            sr = srow_list[s]
            nh, ns_ = need.shape[0], sr.shape[0]
            tr_s = tr[tr_st[s] : tr_st[s + 1]]
            fr_s = f_rows[f_st[s] : f_st[s + 1]]
            need_h[s, :nh] = need
            need_mask[s, :nh] = True
            srows[s, :ns_] = sr
            srows_mask[s, :ns_] = True

            def rmap_h(v):
                return _remap_sorted(v, need, nh_cap)

            def rmap_s(v):
                return _remap_sorted(v, sr, ns_cap)

            fill_idx(s, di["e_src"], rmap_h(es[esel]), nh_cap)
            fill_idx(s, di["e_dst"], rmap_h(ed[esel]), nh_cap)
            fill_idx(s, di["e_rowidx"], np.searchsorted(tr_s, ed[esel]).astype(np.int32), r_cap)
            fill_idx(s, di["e_t"], art["e_t"][esel], 0)
            fill_idx(s, di["touch_rows"], rmap_s(tr_s), ns_cap)
            fill_idx(s, di["f_rows"], rmap_s(fr_s), ns_cap)
            fill_idx(s, di["f_src"], rmap_h(fs[fesel]), nh_cap)
            fill_idx(s, di["f_rowidx"],
                     np.searchsorted(fr_s, fe_row[fesel]).astype(np.int32), f_cap)
            fill_idx(s, di["f_t"], art["f_t"][fesel], 0)
            fill_idx(s, di["out_rows"], rmap_s(sr), ns_cap)
            fill_idx(s, di["f_rows_h"], rmap_h(fr_s), nh_cap)
            fill_idx(s, di["out_rows_h"], rmap_h(sr), nh_cap)

            flt_sh[s, df["e_sign"].start : df["e_sign"].start + ne] = art["e_sign"][esel]
            flt_sh[s, df["e_w"].start : df["e_w"].start + ne] = art["e_w"][esel]
            flt_sh[s, df["f_w"].start : df["f_w"].start + nfe] = art["f_w"][fesel]
            deg_o = np.zeros(nh_cap + 1, np.float32)
            deg_n = np.zeros(nh_cap + 1, np.float32)
            deg_o[:nh] = plan.deg_old[need]
            deg_n[:nh] = plan.deg_new[need]
            flt_sh[s, df["deg_old"]] = deg_o
            flt_sh[s, df["deg_new"]] = deg_n

            nr, nf, no = tr_s.shape[0], fr_s.shape[0], sr.shape[0]
            msk_sh[s, dm["e_mask"].start : dm["e_mask"].start + ne] = True
            msk_sh[s, dm["e_use_new"].start : dm["e_use_new"].start + ne] = (
                art["e_use_new"][esel])
            msk_sh[s, dm["touch_mask"].start : dm["touch_mask"].start + nr] = True
            msk_sh[s, dm["f_mask"].start : dm["f_mask"].start + nf] = True
            msk_sh[s, dm["f_emask"].start : dm["f_emask"].start + nfe] = True
            msk_sh[s, dm["out_mask"].start : dm["out_mask"].start + no] = True

        n_halo_remote = sum(int((need_list[s] // rows_per != s).sum()) for s in range(S))

        patch_pos = patch_src = None
        if device_patch:
            dst_keys = np.where(need_mask, need_h, -1).reshape(-1)
            patch_pos, patch_src = _match_positions(dst_keys, prev_keys)
            if l > 0:  # compose: index into live srows → flat ws position
                patch_src = prev_live_pos[patch_src]
            prev_keys = srows[srows_mask].astype(np.int64)
            prev_live_pos = np.flatnonzero(srows_mask.reshape(-1)).astype(np.int64)

        out_layers.append(HybridLayerPlan(
            layout=llayout,
            need_h=need_h, need_mask=need_mask,
            srows=srows, srows_mask=srows_mask,
            idx_sh=idx_sh, flt_sh=flt_sh, msk_sh=msk_sh,
            sched_sh=_shard_schedules((llayout.caps,), (di,), (dm,), idx_sh, msk_sh),
            n_halo_remote=n_halo_remote,
            patch_pos=patch_pos, patch_src=patch_src,
        ))

    return HybridPlan(layers=out_layers)
