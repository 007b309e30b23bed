"""Static CSR graph snapshot (host side, numpy).

The port's own copy of ``repro.graph.csr``: the port imports nothing of the
JAX package, so it keeps this numpy module, with one change:
``apply_updates`` merges a batch into the sorted arrays instead of sorting
every edge again through ``from_edges`` (the same arrays, bit for bit).

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
        dst = self._row_ids(self.in_indptr)
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
        """The snapshot after deleting the edges ``(del_src, del_dst)`` and
        then inserting ``(ins_src, ins_dst)``: the same arrays, bit for bit
        and dtype for dtype, as ``from_edges`` over the surviving and new
        edges, with its errors (a delete of an absent edge; an insert that
        duplicates a surviving edge or another insert; an endpoint out of
        range).  A delete listed twice deletes once; an edge deleted and
        inserted in one batch ends with the insert's weight and type.

        Both mirrors are already sorted (the in-CSR by ``dst·n + src``, the
        out-CSR by ``src·n + dst``), so each is updated in place of a
        re-sort: deletions at ``searchsorted`` positions, the sorted
        insertions merged in, the ``indptr`` moved by the degree changes."""
        n = self.n
        s_in = self._row_ids(self.in_indptr)  # dst of each in-CSR entry
        key_in = s_in * n + self.in_indices
        s_out = self._row_ids(self.out_indptr)  # src of each out-CSR entry
        key_out = s_out * n + self.out_indices
        gone_in = gone_out = np.zeros(0, np.int64)
        if del_src.size:
            dkey = np.asarray(del_dst, np.int64) * n + np.asarray(del_src, np.int64)
            pos = np.searchsorted(key_in, dkey)
            found = pos < key_in.size
            found[found] = key_in[pos[found]] == dkey[found]
            if not found.all():
                raise ValueError(f"deleting {int((~found).sum())} non-existent edge(s)")
            gone_in = np.unique(pos)
            gone = key_in[gone_in]
            gone_out = np.searchsorted(key_out, (gone % n) * n + gone // n)
        live_in = np.delete(key_in, gone_in)
        ins_key = np.zeros(0, np.int64)
        if ins_src.size:
            isrc = np.asarray(ins_src, np.int64)
            idst = np.asarray(ins_dst, np.int64)
            assert isrc.min() >= 0 and isrc.max() < n, "src out of range"
            assert idst.min() >= 0 and idst.max() < n, "dst out of range"
            iw = (np.ones(len(isrc), np.float32) if ins_weights is None
                  else np.asarray(ins_weights, np.float32))
            it = (np.zeros(len(isrc), np.int32) if ins_etypes is None
                  else np.asarray(ins_etypes, np.int32))
            order = np.argsort(idst * n + isrc, kind="stable")
            isrc, idst, iw, it = isrc[order], idst[order], iw[order], it[order]
            ins_key = idst * n + isrc
            at_in = np.searchsorted(live_in, ins_key)
            clash = at_in < live_in.size
            clash[clash] = live_in[at_in[clash]] == ins_key[clash]
            if clash.any() or np.any(np.diff(ins_key) == 0):
                raise ValueError("duplicate edges are not supported")
        in_indices = np.delete(self.in_indices, gone_in)
        in_w = np.delete(self.in_weights, gone_in)
        in_t = np.delete(self.in_etypes, gone_in)
        out_indices = np.delete(self.out_indices, gone_out)
        out_w = np.delete(self.out_weights, gone_out)
        out_t = np.delete(self.out_etypes, gone_out)
        deg_in = -np.bincount(s_in[gone_in], minlength=n)
        deg_out = -np.bincount(s_out[gone_out], minlength=n)
        if ins_key.size:
            in_indices = np.insert(in_indices, at_in, isrc)
            in_w = np.insert(in_w, at_in, iw)
            in_t = np.insert(in_t, at_in, it)
            o = np.argsort(isrc * n + idst, kind="stable")
            at = np.searchsorted(np.delete(key_out, gone_out), isrc[o] * n + idst[o])
            out_indices = np.insert(out_indices, at, idst[o])
            out_w = np.insert(out_w, at, iw[o])
            out_t = np.insert(out_t, at, it[o])
            deg_in += np.bincount(idst, minlength=n)
            deg_out += np.bincount(isrc, minlength=n)
        return CSRGraph(
            n=n,
            in_indptr=self.in_indptr + np.concatenate([[0], np.cumsum(deg_in)]),
            in_indices=in_indices,
            out_indptr=self.out_indptr + np.concatenate([[0], np.cumsum(deg_out)]),
            out_indices=out_indices,
            in_weights=in_w,
            in_etypes=in_t,
            out_weights=out_w,
            out_etypes=out_t,
        )

    def _row_ids(self, indptr: np.ndarray) -> np.ndarray:
        """The row of each entry of a CSR with these offsets (int64)."""
        return np.repeat(np.arange(self.n, dtype=np.int64), np.diff(indptr))
