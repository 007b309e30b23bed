"""Update-stream workloads: hybrid edge insertion/deletion batches.

The port's own copy of ``repro.graph.streaming`` (numpy only; the port
imports nothing of the JAX package).  ``make_adversarial_stream`` is not
copied yet.

Follows the paper's evaluation protocol (§VI): take a base graph, reserve the
most recent fraction of edges as the stream, split into batches; hybrid
workloads mix insertions of reserved edges with deletions of existing ones.
Batch sizes are expressed as a fraction of |E| (0.01% small / 0.001% large by
default in the paper).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class UpdateBatch:
    """One batch of structural updates (plus optional feature updates)."""

    ins_src: np.ndarray
    ins_dst: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray
    ins_weights: Optional[np.ndarray] = None
    ins_etypes: Optional[np.ndarray] = None
    feat_vertices: Optional[np.ndarray] = None  # vertices whose features change
    feat_values: Optional[np.ndarray] = None  # [len(feat_vertices), d]

    @property
    def num_updates(self) -> int:
        return int(self.ins_src.size + self.del_src.size)

    def updated_vertices(self) -> np.ndarray:
        parts = [self.ins_src, self.ins_dst, self.del_src, self.del_dst]
        if self.feat_vertices is not None:
            parts.append(self.feat_vertices)
        return np.unique(np.concatenate([np.asarray(p, np.int64) for p in parts]))


@dataclasses.dataclass
class StreamWorkload:
    base: CSRGraph
    batches: List[UpdateBatch]

    def __iter__(self) -> Iterator[UpdateBatch]:
        return iter(self.batches)


def make_stream(
    graph: CSRGraph,
    num_batches: int = 10,
    batch_edges: Optional[int] = None,
    batch_frac: float = 1e-4,
    delete_frac: float = 0.3,
    feature_dim: int = 0,
    feature_frac: float = 0.0,
    seed: int = 0,
) -> StreamWorkload:
    """Split the 'most recent' edges off `graph` into an insertion stream and
    mix in deletions of base edges.

    Returns a StreamWorkload whose .base is the trimmed graph; applying all
    batches in order never inserts a duplicate or deletes a missing edge.
    """
    rng = np.random.default_rng(seed)
    src, dst, w, t = graph.edges_by_dst()
    E = src.shape[0]
    if batch_edges is None:
        batch_edges = max(1, int(E * batch_frac))
    n_ins_total = int(num_batches * batch_edges * (1.0 - delete_frac) + 0.5)
    n_ins_total = min(n_ins_total, E // 2)
    # reserve a random subset as "future" insertions
    perm = rng.permutation(E)
    ins_pool = perm[:n_ins_total]
    keep = np.ones(E, dtype=bool)
    keep[ins_pool] = False
    base = CSRGraph.from_edges(graph.n, src[keep], dst[keep], w[keep], t[keep])

    # live edge set for deletions (start from base edges)
    live_src = src[keep].tolist()
    live_dst = dst[keep].tolist()
    live_set = set(zip(live_src, live_dst))

    batches: List[UpdateBatch] = []
    ins_cursor = 0
    for _ in range(num_batches):
        n_del = int(batch_edges * delete_frac)
        n_ins = batch_edges - n_del
        isrc: list[int] = []
        idst: list[int] = []
        iw: list[float] = []
        it: list[int] = []
        while n_ins > 0 and ins_cursor < ins_pool.shape[0]:
            e = ins_pool[ins_cursor]
            ins_cursor += 1
            pair = (int(src[e]), int(dst[e]))
            if pair in live_set:
                continue
            live_set.add(pair)
            isrc.append(pair[0])
            idst.append(pair[1])
            iw.append(float(w[e]))
            it.append(int(t[e]))
            n_ins -= 1
        dsrc: list[int] = []
        ddst: list[int] = []
        live_list = list(live_set)
        if n_del > 0 and live_list:
            picks = rng.choice(len(live_list), size=min(n_del, len(live_list)), replace=False)
            for p in picks:
                pair = live_list[p]
                if pair in live_set and (pair[0], pair[1]) not in zip(isrc, idst):
                    live_set.discard(pair)
                    dsrc.append(pair[0])
                    ddst.append(pair[1])
        fv = fx = None
        if feature_dim and feature_frac > 0:
            k = max(1, int(graph.n * feature_frac))
            fv = rng.choice(graph.n, size=k, replace=False).astype(np.int64)
            fx = rng.normal(0, 1, size=(k, feature_dim)).astype(np.float32)
        batches.append(
            UpdateBatch(
                ins_src=np.array(isrc, np.int64),
                ins_dst=np.array(idst, np.int64),
                del_src=np.array(dsrc, np.int64),
                del_dst=np.array(ddst, np.int64),
                ins_weights=np.array(iw, np.float32),
                ins_etypes=np.array(it, np.int32),
                feat_vertices=fv,
                feat_values=fx,
            )
        )
    return StreamWorkload(base=base, batches=batches)
