"""Non-incremental RTEC baselines (paper §III / §VI "Baselines"), in PyTorch.
Mirrors ``repro.core.baselines``.

* **RTEC-Full (FN)** — full-neighbor recomputation of the L-hop *backward*
  computation graph of every final-layer affected vertex (the paper's naive
  RTEC; 2L-hop pattern).
* **RTEC-NS{f}** — the same backward graph, but every vertex's neighborhood
  is down-sampled to fanout f (Helios-style); biased to always retain
  updated edges so the change is visible at all.  Samples are drawn from
  ``np.random.default_rng(seed)`` in the reference's call order, so they
  are the reference's samples.
* **RTEC-UER** — unaffected-embedding reuse (λGrapher): recompute only the
  *forward-affected* vertices per layer, but each over its FULL
  in-neighborhood, reusing cached embeddings of unaffected vertices.
* **MTEC-Period** — periodic full recomputation every T batches; stale in
  between (industrial snapshot pipelines).

All baselines share the device compute core (:func:`subset_layer`, whose
destination sums run through the ``segment_spmm`` kernel on a host-built row
schedule; MTEC through :func:`full_forward`) and the padding/bucketing
discipline of the incremental engine, so the runtime comparison isolates the
algorithmic difference.  Each ``apply_batch`` synchronises the device at its
timed boundary and returns the engine's :class:`BatchStats` counters.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.backend import BatchStats
from repro_torch.core.full import full_forward, next_bucket, subset_layer
from repro_torch.core.incremental import with_scratch
from repro_torch.core.operators import GNNModel, Params
from repro_torch.device import host_to_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.streaming import UpdateBatch
from repro_torch.kernels.segment_spmm import prepare_row_schedule


def forward_affected_sets(
    model: GNNModel, g_old: CSRGraph, g_new: CSRGraph, batch: UpdateBatch, L: int
) -> List[np.ndarray]:
    """Forward frontier: vertices whose h^l changes, per layer (conservative,
    same propagation rule as the incremental planner)."""
    deg_changed = np.nonzero(g_old.in_degree() != g_new.in_degree())[0]
    changed = set(
        np.asarray(batch.feat_vertices, np.int64).tolist()
        if batch.feat_vertices is not None
        else []
    )
    out: List[np.ndarray] = []
    upd_dsts = set(np.concatenate([batch.ins_dst, batch.del_dst]).astype(np.int64).tolist())
    for _ in range(L):
        c_src = set(changed)
        if model.src_struct_dependent:
            c_src |= set(deg_changed.tolist())
        affected = set(upd_dsts)
        for u in c_src:
            affected |= set(g_new.out_neighbors(int(u)).tolist())
        if model.update_uses_h:
            affected |= changed
        changed = affected
        out.append(np.array(sorted(affected), np.int64))
    return out


def _gather_in_edges(
    g: CSRGraph, rows: np.ndarray, fanout: int = 0, rng: Optional[np.random.Generator] = None,
    must_keep: Optional[Set[Tuple[int, int]]] = None,
):
    srcs, ridx, ws, ts = [], [], [], []
    for i, v in enumerate(rows):
        nbrs, w, t = g.in_edge_data(int(v))
        k = nbrs.shape[0]
        if fanout and k > fanout and rng is not None:
            sel = rng.choice(k, size=fanout, replace=False)
            if must_keep:
                keep_idx = [j for j in range(k) if (int(nbrs[j]), int(v)) in must_keep]
                sel = np.unique(np.concatenate([sel, np.array(keep_idx, int)])) if keep_idx else sel
            nbrs, w, t = nbrs[sel], w[sel], t[sel]
        srcs.extend(nbrs.tolist())
        ridx.extend([i] * nbrs.shape[0])
        ws.extend(w.tolist())
        ts.extend(t.tolist())
    return srcs, ridx, ws, ts


def _run_subset_layers(
    model: GNNModel,
    params: Sequence[Params],
    h_layers: List[torch.Tensor],
    layer_rows: List[np.ndarray],
    g: CSRGraph,
    fanout: int = 0,
    rng: Optional[np.random.Generator] = None,
    must_keep: Optional[Set[Tuple[int, int]]] = None,
) -> Tuple[List[torch.Tensor], int, int]:
    """Recompute h^l for layer_rows[l], reading (possibly updated) h^{l-1}.

    Returns (new h list, edges_processed, vertices_touched).  Each layer's
    host tables and row schedule ship in one copy; the layer runs on the
    device of ``h_layers``."""
    n = g.n
    dev = h_layers[0].device
    deg_np = np.concatenate([g.in_degree().astype(np.float32), np.zeros(1, np.float32)])
    edges = 0
    verts = 0
    h_new = [h_layers[0]]
    for l, rows in enumerate(layer_rows):
        srcs, ridx, ws, ts = _gather_in_edges(g, rows, fanout, rng, must_keep)
        edges += len(srcs)
        verts += rows.shape[0]
        r_cap = next_bucket(rows.shape[0])
        e_cap = next_bucket(len(srcs))

        def pad(a, cap, fill, dt):
            out = np.full(cap, fill, dtype=dt)
            out[: len(a)] = a
            return out

        e_ridx = pad(ridx, e_cap, r_cap, np.int32)
        order, row_ptr = prepare_row_schedule(e_ridx, r_cap)  # pads (= r_cap) dropped
        (rows_p, rmask, e_src, e_ridx_d, e_w, e_t, e_mask, deg, order_d,
         row_ptr_d) = host_to_device((
             pad(rows, r_cap, n, np.int32),
             pad(np.ones(rows.shape[0], bool), r_cap, False, bool),
             pad(srcs, e_cap, n, np.int32),
             e_ridx,
             pad(ws, e_cap, 0.0, np.float32),
             pad(ts, e_cap, 0, np.int32),
             pad(np.ones(len(srcs), bool), e_cap, False, bool),
             deg_np, order, row_ptr), dev)
        _, _, h_rows = subset_layer(
            model, params[l], with_scratch(h_new[l]), rows_p, rmask, e_src, e_ridx_d,
            e_w, e_t, e_mask, deg, r_cap, order_d, row_ptr_d,
        )
        h_ext = with_scratch(h_layers[l + 1])
        h_ext[rows_p.long()] = h_rows  # padded rows land on the scratch row
        h_new.append(h_ext[:n])
    return h_new, edges, verts


def _sync(t: torch.Tensor) -> None:
    """Timed boundary: completion, not dispatch."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


# ====================================================================== #
class _BaseRTEC:
    def __init__(self, model: GNNModel, params: Sequence[Params], graph: CSRGraph,
                 x: torch.Tensor):
        self.model = model
        self.params = list(params)
        self.graph = graph
        self.x = x
        self.L = len(self.params)
        states = full_forward(self.model, self.params, self.x, self.graph)
        self.h: List[torch.Tensor] = [self.x] + [s.h for s in states]

    @property
    def embeddings(self) -> torch.Tensor:
        return self.h[-1]

    def _apply_graph(self, batch: UpdateBatch) -> CSRGraph:
        return self.graph.apply_updates(
            batch.ins_src, batch.ins_dst, batch.del_src, batch.del_dst,
            batch.ins_weights, batch.ins_etypes,
        )

    def _apply_features(self, batch: UpdateBatch) -> None:
        if batch.feat_vertices is not None and batch.feat_vertices.size:
            h0 = self.h[0].clone()
            rows, vals = host_to_device((np.asarray(batch.feat_vertices, np.int64),
                                         np.asarray(batch.feat_values, np.float32)),
                                        h0.device)
            h0[rows] = vals
            self.h[0] = h0


def _backward_closure(g: CSRGraph, finals: np.ndarray, L: int,
                      sample=None) -> List[np.ndarray]:
    """Per-layer rows of the backward L-hop computation graph of ``finals``:
    layer l needs the in-neighbors of layer l+1's rows (``sample`` thins
    each in-neighborhood, for RTEC-NS)."""
    layer_rows: List[np.ndarray] = [None] * L  # type: ignore
    need = set(finals.tolist())
    for l in range(L - 1, -1, -1):
        layer_rows[l] = np.array(sorted(need), np.int64)
        nxt = set(need)
        for v in need:
            nbrs = g.in_neighbors(int(v))
            if sample is not None:
                nbrs = sample(nbrs)
            nxt |= set(np.asarray(nbrs).tolist())
        need = nxt
    return layer_rows


class RTECFull(_BaseRTEC):
    """Naive full-neighbor RTEC: recompute the backward L-hop computation
    graph of all final-layer affected vertices from scratch."""

    def apply_batch(self, batch: UpdateBatch) -> BatchStats:
        t0 = time.perf_counter()
        g_new = self._apply_graph(batch)
        t1 = time.perf_counter()
        fwd = forward_affected_sets(self.model, self.graph, g_new, batch, self.L)
        layer_rows = _backward_closure(g_new, fwd[-1], self.L)
        t2 = time.perf_counter()
        self._apply_features(batch)
        self.h, edges, verts = _run_subset_layers(
            self.model, self.params, self.h, layer_rows, g_new
        )
        _sync(self.h[-1])
        t3 = time.perf_counter()
        self.graph = g_new
        return BatchStats(
            inc_edges=0, full_edges=edges, out_vertices=verts,
            plan_time_s=t2 - t1, exec_time_s=t3 - t2, graph_time_s=t1 - t0,
        )


class RTECSample(RTECFull):
    """RTEC with neighbor sampling (fanout-limited backward graph)."""

    def __init__(self, model, params, graph, x, fanout: int = 10, seed: int = 0):
        super().__init__(model, params, graph, x)
        self.fanout = fanout
        self.rng = np.random.default_rng(seed)

    def _sample(self, nbrs: np.ndarray) -> np.ndarray:
        if nbrs.shape[0] > self.fanout:
            return self.rng.choice(nbrs, size=self.fanout, replace=False)
        return nbrs

    def apply_batch(self, batch: UpdateBatch) -> BatchStats:
        t0 = time.perf_counter()
        g_new = self._apply_graph(batch)
        t1 = time.perf_counter()
        fwd = forward_affected_sets(self.model, self.graph, g_new, batch, self.L)
        must_keep = set(zip(batch.ins_src.tolist(), batch.ins_dst.tolist()))
        layer_rows = _backward_closure(g_new, fwd[-1], self.L, sample=self._sample)
        t2 = time.perf_counter()
        self._apply_features(batch)
        self.h, edges, verts = _run_subset_layers(
            self.model, self.params, self.h, layer_rows, g_new,
            fanout=self.fanout, rng=self.rng, must_keep=must_keep,
        )
        _sync(self.h[-1])
        t3 = time.perf_counter()
        self.graph = g_new
        return BatchStats(
            inc_edges=0, full_edges=edges, out_vertices=verts,
            plan_time_s=t2 - t1, exec_time_s=t3 - t2, graph_time_s=t1 - t0,
        )


class RTECUER(_BaseRTEC):
    """Unaffected-embedding reuse: recompute forward-affected vertices only,
    each over its full new in-neighborhood (λGrapher-style)."""

    def apply_batch(self, batch: UpdateBatch) -> BatchStats:
        t0 = time.perf_counter()
        g_new = self._apply_graph(batch)
        t1 = time.perf_counter()
        layer_rows = forward_affected_sets(self.model, self.graph, g_new, batch, self.L)
        t2 = time.perf_counter()
        self._apply_features(batch)
        self.h, edges, verts = _run_subset_layers(
            self.model, self.params, self.h, layer_rows, g_new
        )
        _sync(self.h[-1])
        t3 = time.perf_counter()
        self.graph = g_new
        return BatchStats(
            inc_edges=0, full_edges=edges, out_vertices=verts,
            plan_time_s=t2 - t1, exec_time_s=t3 - t2, graph_time_s=t1 - t0,
        )


class MTECPeriod(_BaseRTEC):
    """Periodic recomputation: refresh every `period` batches, stale between."""

    def __init__(self, model, params, graph, x, period: int = 10):
        super().__init__(model, params, graph, x)
        self.period = period
        self._seen = 0

    def apply_batch(self, batch: UpdateBatch) -> BatchStats:
        t0 = time.perf_counter()
        g_new = self._apply_graph(batch)
        self.graph = g_new
        self._apply_features(batch)
        self._seen += 1
        edges = 0
        verts = 0
        t1 = time.perf_counter()
        if self._seen % self.period == 0:
            states = full_forward(self.model, self.params, self.h[0], self.graph)
            self.h = [self.h[0]] + [s.h for s in states]
            _sync(self.h[-1])
            edges = self.graph.num_edges * self.L
            verts = self.graph.n * self.L
        t2 = time.perf_counter()
        return BatchStats(
            inc_edges=0, full_edges=edges, out_vertices=verts,
            plan_time_s=0.0, exec_time_s=t2 - t1, graph_time_s=t1 - t0,
        )
