"""Update-stream workloads: hybrid edge insertion/deletion batches.

The port's own copy of ``repro.graph.streaming`` (numpy only; the port
imports nothing of the JAX package), with the seeded adversarial streams
(``make_adversarial_stream``) that the execution policy is tested on.

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


#: regimes `make_adversarial_stream` generates
ADVERSARIAL_REGIMES = ("hub_burst", "delete_heavy", "feature_churn")


def _ring_edges(n: int, k: int):
    """Ring-lattice in-edges: (i+j) % n → i for j in 1..k (in-degree k)."""
    src, dst = [], []
    for j in range(1, k + 1):
        for i in range(n):
            src.append((i + j) % n)
            dst.append(i)
    return src, dst


def make_adversarial_stream(
    regime: str,
    n: int = 256,
    num_batches: int = 6,
    feature_dim: int = 8,
    seed: int = 0,
) -> StreamWorkload:
    """Synthetic adversarial streams where a fixed execution mode loses.

    Each regime is a deterministic construction (the RNG only draws feature
    values): graph structure, batch composition, and therefore the Alg.-4
    plan counters the execution policy scores are identical run to run —
    which is what lets CI gate the per-batch mode decisions *exactly*.

    * ``hub_burst`` — quiet long-range inserts, periodically interrupted by
      bursts of insertions into a few hubs whose out-fan covers the whole
      graph.  A hub's in-degree change invalidates every contribution it
      sources (GCN-style degree normalization), so the burst's affected
      frontier is ≈ V at layer 2 (InkStream's affected-area blow-up): the
      signed incremental step costs more than a dense pass and the policy
      must flip to full recompute, then back to incremental on the next
      quiet batch.
    * ``delete_heavy`` — light insert batches alternating with batches that
      delete one whole ring layer (one in-edge of *every* vertex): every
      row is degree-changed → constrained, the chunked subset degenerates
      into the full graph, and full recompute wins on weight.
    * ``feature_churn`` — a dense bipartite cluster (48 leaves drawing
      almost all in-edges from 32 churn sources) whose sources' features
      all change at once: nearly every in-contribution of every affected
      row is re-signed (2 records per edge), so chunked-subset recompute
      (1 edge per in-edge, ×chunked_weight) beats the incremental step,
      while sparse-churn batches stay incremental.

    The live-edge invariant of :func:`make_stream` holds: applying all
    batches in order never inserts a duplicate or deletes a missing edge.
    """
    if regime not in ADVERSARIAL_REGIMES:
        raise ValueError(f"unknown adversarial regime {regime!r}; "
                         f"expected one of {ADVERSARIAL_REGIMES}")
    if n < 64:
        raise ValueError("adversarial streams need n >= 64")
    rng = np.random.default_rng(seed)

    def _feat(verts: list) -> tuple:
        fv = np.asarray(verts, np.int64)
        fx = rng.normal(0, 1, size=(fv.size, feature_dim)).astype(np.float32)
        return fv, fx

    def _batch(ins=None, dels=None, feats=None) -> UpdateBatch:
        isrc, idst = (np.array(ins[0], np.int64), np.array(ins[1], np.int64)) \
            if ins else (np.zeros(0, np.int64), np.zeros(0, np.int64))
        dsrc, ddst = (np.array(dels[0], np.int64), np.array(dels[1], np.int64)) \
            if dels else (np.zeros(0, np.int64), np.zeros(0, np.int64))
        fv, fx = _feat(feats) if feats else (None, None)
        return UpdateBatch(
            ins_src=isrc, ins_dst=idst, del_src=dsrc, del_dst=ddst,
            ins_weights=np.ones(isrc.size, np.float32),
            ins_etypes=np.zeros(isrc.size, np.int32),
            feat_vertices=fv, feat_values=fx,
        )

    batches: List[UpdateBatch] = []

    if regime == "hub_burst":
        hubs = list(range(4))
        src, dst = _ring_edges(n, 2)
        # hub out-fan: (almost) every non-hub vertex hears every hub; the
        # top two vertices are skipped — their ring in-edges wrap to hub ids
        for h in hubs:
            for v in range(8, n - 2):
                src.append(h)
                dst.append(v)
        base = _from_lists(n, src, dst)
        quiet_cursor = 8
        for b in range(num_batches):
            if b % 3 == 1:  # burst: 8 fresh feeders per hub, every hub
                feeders = range(8 + b * 8, 16 + b * 8)
                ins = ([f for f in feeders for _ in hubs],
                       [h for _ in feeders for h in hubs])
                batches.append(_batch(ins=ins))
            else:  # quiet: 3 long-range inserts between low-degree vertices
                pairs = [(quiet_cursor + i, (quiet_cursor + i + 5) % n)
                         for i in range(3)]
                quiet_cursor += 3
                batches.append(_batch(ins=([p[0] for p in pairs],
                                           [p[1] for p in pairs])))
        return StreamWorkload(base=base, batches=batches)

    if regime == "delete_heavy":
        k = 4  # ring in-degree; heavy batches delete one whole layer each
        src, dst = _ring_edges(n, k)
        base = _from_lists(n, src, dst)
        layer = 2  # layer 1 is never deleted (keeps the graph connected)
        ins_cursor = 0
        for b in range(num_batches):
            if b % 2 == 1 and layer <= k:  # heavy: one in-edge of every row
                dels = ([(i + layer) % n for i in range(n)], list(range(n)))
                layer += 1
                batches.append(_batch(dels=dels))
            else:  # light: 4 fresh medium-range inserts
                pairs = [((ins_cursor + i) % n,
                          (ins_cursor + i + k + 3 + b) % n)
                         for i in range(4)]
                ins_cursor += 4
                batches.append(_batch(ins=([p[0] for p in pairs],
                                           [p[1] for p in pairs])))
        return StreamWorkload(base=base, batches=batches)

    # feature_churn: ring (in-degree 4) + dense bipartite cluster
    # sources→leaves — leaves draw fan/(fan+4) of their in-edges from the
    # churn sources, so a cluster-wide churn re-signs nearly every
    # contribution of every affected row
    n_src, n_leaf, fan = 32, 48, 24
    sources = list(range(n_src))
    leaves = list(range(n_src, n_src + n_leaf))
    src, dst = _ring_edges(n, 4)
    for t_i, t in enumerate(leaves):  # each leaf hears `fan` of the sources
        for j in range(fan):
            src.append((t_i * 7 + j) % n_src)
            dst.append(t)
    base = _from_lists(n, src, dst)
    quiet_lo = n_src + n_leaf + 8
    quiet_span = n - quiet_lo
    for b in range(num_batches):
        if b % 2 == 1:  # churn: every cluster source's features change
            batches.append(_batch(feats=sources))
        else:  # sparse churn: 6 well-separated ring-only vertices, so no
            # affected row hears more than one churned source (c/d = 1/4)
            batches.append(_batch(
                feats=[quiet_lo + (b * 30 + i * 5) % quiet_span
                       for i in range(6)]))
    return StreamWorkload(base=base, batches=batches)


def _from_lists(n: int, src: list, dst: list) -> CSRGraph:
    s = np.asarray(src, np.int64)
    d = np.asarray(dst, np.int64)
    return CSRGraph.from_edges(n, s, d, np.ones(s.size, np.float32),
                               np.zeros(s.size, np.int32))


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
