"""On-Demand Embedding Computation (ODEC) — paper §V-D, in PyTorch.  Mirrors
``repro.core.odec``.

ODEC serves online queries for a small vertex set Q: the computation graph
is the *intersection* of the affected subgraph with the query-induced
K-hop-backward cone.  :func:`odec_query` computes the post-batch embeddings
of Q without committing engine state (queries are answered immediately from
the restricted cone while the full batch commit happens through
``engine.apply_batch``).

The restricted plan is packed like any batch (:func:`pack_plan`, which
builds the row schedule ``delta_agg`` reads) and run one
:func:`incremental_layer` at a time on fresh tensors: the engine's
persistent state is read, never written.

When Q covers all affected vertices, ODEC reduces to plain incremental RTEC
(paper Fig. 12.d "ALL").
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.affected import build_plan, pack_plan
from repro_torch.core.backend import BatchStats, stage_packed
from repro_torch.core.engine import RTECEngine
from repro_torch.core.incremental import incremental_layer, packed_fields, with_scratch
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.streaming import UpdateBatch


def query_cone(g: CSRGraph, query: np.ndarray, num_layers: int) -> List[set]:
    """Per-layer allowed-vertex sets: layer L = Q, layer l−1 = layer l ∪
    in-neighbors(layer l)."""
    need = set(np.asarray(query, np.int64).tolist())
    cones: List[set] = [None] * num_layers  # type: ignore
    for l in range(num_layers - 1, -1, -1):
        cones[l] = set(need)
        nxt = set(need)
        for v in need:
            nxt |= set(g.in_neighbors(int(v)).tolist())
        need = nxt
    return cones


def odec_query(
    engine: RTECEngine, batch: UpdateBatch, query: np.ndarray
) -> Tuple[torch.Tensor, BatchStats]:
    """Answer embeddings for ``query`` reflecting ``batch``, via the
    affected-subgraph ∩ query-cone restricted incremental computation.
    Synchronises the device before it returns (honest ``exec_time_s``)."""
    t0 = time.perf_counter()
    g_new = engine.graph.apply_updates(
        batch.ins_src, batch.ins_dst, batch.del_src, batch.del_dst,
        batch.ins_weights, batch.ins_etypes,
    )
    cones = query_cone(g_new, query, engine.L)
    plan = build_plan(engine.model, engine.graph, g_new, batch, engine.L, restrict=cones)
    # the features ride as in the reference (a scatter below), not in the plan
    packed = pack_plan(plan)
    t1 = time.perf_counter()

    n = packed.layout.n
    idx, flt, msk, sched, _ = stage_packed(packed, engine.device)
    deg_old, deg_new = flt[: n + 1], flt[n + 1 : 2 * (n + 1)]
    h = engine.h if engine.store_h else engine._reconstruct_h()
    h0_old = h[0]
    if batch.feat_vertices is not None and batch.feat_vertices.size:
        h0_new = h0_old.clone()
        h0_new[torch.from_numpy(np.asarray(batch.feat_vertices, np.int64)).to(h0_old.device)] = (
            torch.from_numpy(np.asarray(batch.feat_values, np.float32)).to(h0_old.device))
    else:
        h0_new = h0_old

    h_new = [h0_new]
    for l, g in enumerate(packed_fields(packed.layout, idx, flt, msk, sched)):
        _, _, hn = incremental_layer(
            engine.model, engine.params[l], with_scratch(h[l]), with_scratch(h_new[l]),
            deg_old, deg_new, engine.a[l], engine.nct[l], h[l + 1], g)
        h_new.append(hn)
    out = h_new[-1][torch.from_numpy(np.asarray(query, np.int64)).to(engine.device)]
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    t2 = time.perf_counter()
    stats = BatchStats(
        inc_edges=plan.total_inc_edges(),
        full_edges=plan.total_full_edges(),
        out_vertices=plan.total_vertices(),
        plan_time_s=t1 - t0,
        exec_time_s=t2 - t1,
        graph_time_s=0.0,
    )
    return out, stats
