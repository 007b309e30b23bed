"""Packed-Memory-Array (PMA) backed dynamic CSR (host side): the port's own
copy of ``repro.graph.pma`` (numpy, as the reference's), whose
:meth:`PMAGraph.snapshot` returns the port's
:class:`~repro_torch.graph.csr.CSRGraph`.  It is kept for parity: no engine
of the port calls it (nor does the reference's).

NeutronRT (paper §V-A) stores the evolving graph in a PMA-based CSR: all
vertex in-neighborhoods live in one packed array with adaptively balanced
gaps so edge insertions are O(log² n) amortized without rebuilding the CSR.

This is a faithful-but-compact PMA: the packed array is divided into leaf
segments of size ``seg``; density bounds (lo, hi) per level of an implicit
binary tree over segments trigger local rebalancing (redistribute the
occupied slots uniformly over a window).  Per-vertex neighborhood extents are
tracked with (start, end) offsets into the packed array; each neighborhood is
kept sorted so membership tests are O(log d).

The PMA is the *mutable* store; ``snapshot()`` exports an immutable
``CSRGraph`` for the device-facing engine.  Weights and edge types ride along
in parallel packed arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph

_EMPTY = np.int64(-1)


class PMAGraph:
    def __init__(self, n: int, capacity: int = 1024, seg: int = 64):
        self.n = n
        self.seg = seg
        capacity = max(seg, 1 << int(np.ceil(np.log2(max(capacity, seg)))))
        self._alloc(capacity)
        # per-vertex extent [start, end) in the packed array; end-start = degree
        self.vstart = np.zeros(n, dtype=np.int64)
        self.vend = np.zeros(n, dtype=np.int64)
        self.num_edges = 0
        self._layout_empty()

    # ------------------------------------------------------------------ #
    def _alloc(self, capacity: int) -> None:
        self.capacity = capacity
        self.nbr = np.full(capacity, _EMPTY, dtype=np.int64)
        self.wgt = np.zeros(capacity, dtype=np.float32)
        self.ety = np.zeros(capacity, dtype=np.int32)

    def _layout_empty(self) -> None:
        # spread empty vertices uniformly across the capacity
        pos = np.linspace(0, self.capacity, self.n + 1).astype(np.int64)
        self.vstart[:] = pos[:-1]
        self.vend[:] = pos[:-1]

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def in_degree(self, v: Optional[int] = None):
        if v is None:
            return (self.vend - self.vstart).copy()
        return int(self.vend[v] - self.vstart[v])

    def neighbors(self, v: int) -> np.ndarray:
        return self.nbr[self.vstart[v] : self.vend[v]]

    def has_edge(self, u: int, v: int) -> bool:
        nb = self.neighbors(v)
        i = np.searchsorted(nb, u)
        return bool(i < nb.shape[0] and nb[i] == u)

    def insert_edge(self, u: int, v: int, w: float = 1.0, t: int = 0) -> None:
        """Insert directed edge (u, v) into v's sorted in-neighborhood."""
        if self.has_edge(u, v):
            raise ValueError(f"edge ({u},{v}) already present")
        if self.num_edges + self.n >= self.capacity:  # global density too high
            self._grow()
        s, e = self.vstart[v], self.vend[v]
        i = s + np.searchsorted(self.nbr[s:e], u)
        if e >= self.capacity or (v + 1 < self.n and e >= self.vstart[v + 1]) or self.nbr[e] != _EMPTY:
            self._make_gap_after(v)
            s, e = self.vstart[v], self.vend[v]
            i = s + np.searchsorted(self.nbr[s:e], u)
        # shift [i, e) right by one (gap guaranteed at e)
        self.nbr[i + 1 : e + 1] = self.nbr[i:e]
        self.wgt[i + 1 : e + 1] = self.wgt[i:e]
        self.ety[i + 1 : e + 1] = self.ety[i:e]
        self.nbr[i] = u
        self.wgt[i] = w
        self.ety[i] = t
        self.vend[v] = e + 1
        self.num_edges += 1

    def delete_edge(self, u: int, v: int) -> None:
        s, e = self.vstart[v], self.vend[v]
        i = s + np.searchsorted(self.nbr[s:e], u)
        if i >= e or self.nbr[i] != u:
            raise ValueError(f"edge ({u},{v}) not present")
        self.nbr[i : e - 1] = self.nbr[i + 1 : e]
        self.wgt[i : e - 1] = self.wgt[i + 1 : e]
        self.ety[i : e - 1] = self.ety[i + 1 : e]
        self.nbr[e - 1] = _EMPTY
        self.vend[v] = e - 1
        self.num_edges -= 1

    def snapshot(self) -> CSRGraph:
        deg = self.vend - self.vstart
        total = int(deg.sum())
        src = np.empty(total, dtype=np.int64)
        wgt = np.empty(total, dtype=np.float32)
        ety = np.empty(total, dtype=np.int32)
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        for v in range(self.n):
            lo, hi = indptr[v], indptr[v + 1]
            src[lo:hi] = self.nbr[self.vstart[v] : self.vend[v]]
            wgt[lo:hi] = self.wgt[self.vstart[v] : self.vend[v]]
            ety[lo:hi] = self.ety[self.vstart[v] : self.vend[v]]
        dst = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        return CSRGraph.from_edges(self.n, src, dst, wgt, ety)

    # ------------------------------------------------------------------ #
    # internals: growth & gap rebalancing
    # ------------------------------------------------------------------ #
    def _grow(self) -> None:
        old = (self.nbr, self.wgt, self.ety, self.vstart.copy(), self.vend.copy())
        self._alloc(self.capacity * 2)
        self._redistribute(*old)

    def _redistribute(self, nbr, wgt, ety, vstart, vend) -> None:
        deg = vend - vstart
        total = int(deg.sum())
        # uniform gaps: allot each vertex deg + proportional slack
        slack = self.capacity - total
        extra = np.full(self.n, slack // self.n, dtype=np.int64)
        extra[: slack % self.n] += 1
        news = np.zeros(self.n, dtype=np.int64)
        np.cumsum((deg + extra)[:-1], out=news[1:])
        for v in range(self.n):
            d = int(deg[v])
            self.nbr[news[v] : news[v] + d] = nbr[vstart[v] : vend[v]]
            self.wgt[news[v] : news[v] + d] = wgt[vstart[v] : vend[v]]
            self.ety[news[v] : news[v] + d] = ety[vstart[v] : vend[v]]
        self.vstart[:] = news
        self.vend[:] = news + deg

    def _make_gap_after(self, v: int) -> None:
        """Local PMA rebalance: widen the window around v until a slot frees up
        after v's extent, then redistribute the window's neighborhoods."""
        lo_v, hi_v = v, v
        win = max(2, self.seg // 8)
        while True:
            lo_v = max(0, v - win)
            hi_v = min(self.n - 1, v + win)
            lo = self.vstart[lo_v]
            hi = self.vend[hi_v] if hi_v + 1 >= self.n else self.vstart[hi_v + 1]
            used = int(sum(self.vend[x] - self.vstart[x] for x in range(lo_v, hi_v + 1)))
            space = int(hi - lo)
            if space >= used + (hi_v - lo_v + 1) or (lo_v == 0 and hi_v == self.n - 1):
                break
            win *= 2
        if space < used + (hi_v - lo_v + 1):
            self._grow()
            return
        # redistribute window uniformly
        vs = slice(lo_v, hi_v + 1)
        deg = self.vend[vs] - self.vstart[vs]
        buf_n = np.concatenate([self.nbr[self.vstart[x] : self.vend[x]] for x in range(lo_v, hi_v + 1)])
        buf_w = np.concatenate([self.wgt[self.vstart[x] : self.vend[x]] for x in range(lo_v, hi_v + 1)])
        buf_t = np.concatenate([self.ety[self.vstart[x] : self.vend[x]] for x in range(lo_v, hi_v + 1)])
        self.nbr[lo:hi] = _EMPTY
        k = hi_v - lo_v + 1
        slack = space - int(deg.sum())
        extra = np.full(k, slack // k, dtype=np.int64)
        extra[: slack % k] += 1
        pos = lo
        off = 0
        for j in range(k):
            d = int(deg[j])
            self.nbr[pos : pos + d] = buf_n[off : off + d]
            self.wgt[pos : pos + d] = buf_w[off : off + d]
            self.ety[pos : pos + d] = buf_t[off : off + d]
            self.vstart[lo_v + j] = pos
            self.vend[lo_v + j] = pos + d
            pos += d + int(extra[j])
            off += d
