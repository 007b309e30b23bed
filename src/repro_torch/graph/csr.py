"""Static CSR graph snapshot (host side, numpy).

The port's own copy of ``repro.graph.csr``: the port imports nothing of the
JAX package, so it keeps this numpy module as it is.

Directed multigraph-free graph with both in- and out-adjacency, optional
per-edge weights (PinSAGE alpha) and edge types (RGCN/RGAT).  GNN aggregation
in this codebase is over *in*-neighborhoods: destination v aggregates
messages from sources u for every directed edge (u, v).

The device-facing form is an edge list sorted by destination
(``edges_by_dst``) plus the destination indptr (``in_indptr``) — the row
offsets the CUDA ``segment_spmm`` kernel and its plain version consume.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Immutable snapshot of a directed graph.

    Attributes:
      n: number of vertices.
      in_indptr/in_indices: CSR over destinations; ``in_indices[in_indptr[v]:
        in_indptr[v+1]]`` are the sources of v's in-edges.
      out_indptr/out_indices: CSR over sources (mirror).
      in_weights / in_etypes: aligned with ``in_indices``.
    """

    n: int
    in_indptr: np.ndarray
    in_indices: np.ndarray
    out_indptr: np.ndarray
    out_indices: np.ndarray
    in_weights: np.ndarray
    in_etypes: np.ndarray
    out_weights: np.ndarray
    out_etypes: np.ndarray

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_edges(
        n: int,
        src: np.ndarray,
        dst: np.ndarray,
        weights: Optional[np.ndarray] = None,
        etypes: Optional[np.ndarray] = None,
    ) -> "CSRGraph":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.size:
            assert src.min() >= 0 and src.max() < n, "src out of range"
            assert dst.min() >= 0 and dst.max() < n, "dst out of range"
        if weights is None:
            weights = np.ones(src.shape[0], dtype=np.float32)
        if etypes is None:
            etypes = np.zeros(src.shape[0], dtype=np.int32)
        # sort by (dst, src) for the in-CSR; stable canonical order
        order = np.lexsort((src, dst))
        s, d = src[order], dst[order]
        w, t = weights[order], etypes[order]
        key = d * n + s
        if key.size and np.any(np.diff(key) == 0):
            raise ValueError("duplicate edges are not supported")
        in_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(in_indptr, d + 1, 1)
        in_indptr = np.cumsum(in_indptr)
        # out-CSR mirror
        order_o = np.lexsort((d, s))
        out_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(out_indptr, s[order_o] + 1, 1)
        out_indptr = np.cumsum(out_indptr)
        return CSRGraph(
            n=n,
            in_indptr=in_indptr,
            in_indices=s,
            out_indptr=out_indptr,
            out_indices=d[order_o],
            in_weights=w.astype(np.float32),
            in_etypes=t.astype(np.int32),
            out_weights=w[order_o].astype(np.float32),
            out_etypes=t[order_o].astype(np.int32),
        )

    # ------------------------------------------------------------------ #
    # basic queries
    # ------------------------------------------------------------------ #
    @property
    def num_edges(self) -> int:
        return int(self.in_indices.shape[0])

    def in_degree(self) -> np.ndarray:
        return np.diff(self.in_indptr).astype(np.int64)

    def out_degree(self) -> np.ndarray:
        return np.diff(self.out_indptr).astype(np.int64)

    def in_neighbors(self, v: int) -> np.ndarray:
        return self.in_indices[self.in_indptr[v] : self.in_indptr[v + 1]]

    def out_neighbors(self, v: int) -> np.ndarray:
        return self.out_indices[self.out_indptr[v] : self.out_indptr[v + 1]]

    def out_edge_data(self, v: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        lo, hi = self.out_indptr[v], self.out_indptr[v + 1]
        return self.out_indices[lo:hi], self.out_weights[lo:hi], self.out_etypes[lo:hi]

    def in_edge_data(self, v: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        lo, hi = self.in_indptr[v], self.in_indptr[v + 1]
        return self.in_indices[lo:hi], self.in_weights[lo:hi], self.in_etypes[lo:hi]

    def has_edge(self, u: int, v: int) -> bool:
        nbrs = self.in_neighbors(v)
        i = np.searchsorted(nbrs, u)
        return bool(i < nbrs.shape[0] and nbrs[i] == u)

    # ------------------------------------------------------------------ #
    # device-facing layout
    # ------------------------------------------------------------------ #
    def edges_by_dst(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, weight, etype) arrays sorted by (dst, src)."""
        dst = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.in_indptr))
        return self.in_indices.copy(), dst, self.in_weights.copy(), self.in_etypes.copy()

    # ------------------------------------------------------------------ #
    # functional mutation (returns new snapshot)
    # ------------------------------------------------------------------ #
    def apply_updates(
        self,
        ins_src: np.ndarray,
        ins_dst: np.ndarray,
        del_src: np.ndarray,
        del_dst: np.ndarray,
        ins_weights: Optional[np.ndarray] = None,
        ins_etypes: Optional[np.ndarray] = None,
    ) -> "CSRGraph":
        src, dst, w, t = self.edges_by_dst()
        if del_src.size:
            key = dst * self.n + src
            dkey = np.asarray(del_dst, np.int64) * self.n + np.asarray(del_src, np.int64)
            keep = ~np.isin(key, dkey)
            missing = np.isin(dkey, key, invert=True)
            if missing.any():
                raise ValueError(f"deleting {int(missing.sum())} non-existent edge(s)")
            src, dst, w, t = src[keep], dst[keep], w[keep], t[keep]
        if ins_src.size:
            iw = (
                np.ones(len(ins_src), np.float32)
                if ins_weights is None
                else np.asarray(ins_weights, np.float32)
            )
            it = (
                np.zeros(len(ins_src), np.int32)
                if ins_etypes is None
                else np.asarray(ins_etypes, np.int32)
            )
            src = np.concatenate([src, np.asarray(ins_src, np.int64)])
            dst = np.concatenate([dst, np.asarray(ins_dst, np.int64)])
            w = np.concatenate([w, iw])
            t = np.concatenate([t, it])
        return CSRGraph.from_edges(self.n, src, dst, w, t)
