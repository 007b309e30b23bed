"""Chunked task scheduling with inter-chunk shard-embedding reuse (§V-C), in
PyTorch.  Mirrors ``repro.serve.scheduler``.

When a layer's computation graph exceeds device memory, NeutronRT splits it
into destination-vertex chunks and caches neighborhood intersections between
chunks in a device staging buffer so shared source embeddings transfer once.

:class:`ChunkedLayerScheduler` executes a (full or subset) layer over
host-resident embeddings in chunks: per chunk it gathers only the source rows
NOT already staged from the previous chunk (precomputed intersections — the
paper's mechanism), runs the compact :func:`~repro_torch.core.full.subset_layer`
(its destination sums through the ``segment_spmm`` kernel, on a row schedule
built on the host), and returns the results to the host.  Transfer accounting
exposes the reuse win.

Chunk execution is pipelined like the engine's plan/execute overlap: each
chunk's host tables (CSR gather, remap LUT, padding, row schedule, the
fresh-row split against the staging set) ship in **one** host→device copy,
the compact layer is launched asynchronously, and the *next* chunk's host
tables are prepared before this chunk's results are copied back — so host
preparation runs while the device computes.

The scheduler runs on the ``device`` it is given (the card unless the caller
asks for the CPU); the execution policy's ``chunked`` mode hands it the
engine's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.full import next_bucket, subset_layer
from repro_torch.core.operators import GNNModel, Params
from repro_torch.device import host_to_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.segment_spmm import prepare_row_schedule


@dataclasses.dataclass
class ChunkStats:
    chunks: int = 0
    rows_transferred: int = 0
    rows_reused: int = 0
    edges_processed: int = 0

    @property
    def reuse_frac(self) -> float:
        tot = self.rows_transferred + self.rows_reused
        return self.rows_reused / tot if tot else 0.0


@dataclasses.dataclass
class _ChunkPayload:
    """Host-prepared transfer tables for one chunk (value gathers included)."""

    chunk: np.ndarray
    allrows: np.ndarray  # rows resident on device after this chunk (sorted)
    shared_pos: np.ndarray  # positions of reused rows in the previous staging
    order: np.ndarray  # sort permutation merging [shared | fresh] → allrows
    h_fresh: np.ndarray  # host-gathered h rows not already staged
    n_shared: int
    n_edges: int
    # compact padded kernel inputs
    rows_c: np.ndarray
    rmask: np.ndarray
    e_src: np.ndarray
    e_ridx: np.ndarray
    e_w: np.ndarray
    e_t: np.ndarray
    e_mask: np.ndarray
    deg_c: np.ndarray
    r_cap: int
    # row schedule of the records for segment_spmm (prepare_row_schedule)
    s_order: np.ndarray
    s_row_ptr: np.ndarray


class ChunkedLayerScheduler:
    def __init__(self, model: GNNModel, chunk_size: int = 8192, reuse: bool = True,
                 device="cuda"):
        self.model = model
        self.chunk_size = chunk_size
        self.reuse = reuse
        self.device = torch.device(device)
        self.stats = ChunkStats()

    # ------------------------------------------------------------------ #
    def _host_payload(
        self,
        chunk: np.ndarray,
        g: CSRGraph,
        h_prev_host: np.ndarray,
        deg: np.ndarray,
        staged_rows: np.ndarray,
    ) -> _ChunkPayload:
        """All host work for one chunk: CSR gather, staging intersection,
        remap, padding, row schedule, and the fresh-row value gather."""
        n = g.n
        srcs, ridx, ws, ts = [], [], [], []
        for i, v in enumerate(chunk):
            nb, w, t = g.in_edge_data(int(v))
            srcs.extend(nb.tolist())
            ridx.extend([i] * nb.shape[0])
            ws.extend(w.tolist())
            ts.extend(t.tolist())
        need = np.unique(np.concatenate([np.asarray(srcs, np.int64), chunk]))
        if self.reuse and staged_rows.size:
            shared = np.intersect1d(need, staged_rows, assume_unique=True)
            fresh = np.setdiff1d(need, staged_rows, assume_unique=True)
        else:
            shared = np.zeros(0, np.int64)
            fresh = need
        if shared.size:
            shared_pos = np.searchsorted(staged_rows, shared)
            order = np.argsort(np.concatenate([shared, fresh]))
            allrows = np.concatenate([shared, fresh])[order]
        else:
            shared_pos = np.zeros(0, np.int64)
            order = np.arange(need.shape[0])
            allrows = need

        lut = np.full(n + 1, allrows.shape[0], np.int32)
        lut[allrows] = np.arange(allrows.shape[0], dtype=np.int32)
        r_cap = next_bucket(chunk.shape[0])
        e_cap = next_bucket(len(srcs))

        def pad(a, cap, fill, dt):
            out = np.full(cap, fill, dtype=dt)
            out[: len(a)] = a
            return out

        e_ridx = pad(ridx, e_cap, r_cap, np.int32)
        s_order, s_row_ptr = prepare_row_schedule(e_ridx, r_cap)  # pads (= r_cap) dropped
        return _ChunkPayload(
            chunk=chunk,
            allrows=allrows,
            shared_pos=shared_pos,
            order=order,
            h_fresh=h_prev_host[fresh],
            n_shared=int(shared.size),
            n_edges=len(srcs),
            rows_c=pad(lut[chunk], r_cap, allrows.shape[0], np.int32),
            rmask=pad(np.ones(chunk.shape[0], bool), r_cap, False, bool),
            e_src=pad(lut[np.asarray(srcs, np.int64)] if srcs else [], e_cap,
                      allrows.shape[0], np.int32),
            e_ridx=e_ridx,
            e_w=pad(ws, e_cap, 0.0, np.float32),
            e_t=pad(ts, e_cap, 0, np.int32),
            e_mask=pad(np.ones(len(srcs), bool), e_cap, False, bool),
            deg_c=np.concatenate([deg[allrows].astype(np.float32),
                                  np.zeros(1, np.float32)]),
            r_cap=r_cap,
            s_order=s_order,
            s_row_ptr=s_row_ptr,
        )

    # ------------------------------------------------------------------ #
    def run_layer(
        self,
        p: Params,
        g: CSRGraph,
        h_prev_host: np.ndarray,  # [N, d_in] host
        rows: np.ndarray,  # destination rows to compute
        deg: np.ndarray,  # [N] float
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (a_rows, nct_rows, h_rows) for `rows`, chunked + pipelined."""
        outs_a, outs_n, outs_h = [], [], []
        chunks = [rows[c0: c0 + self.chunk_size]
                  for c0 in range(0, rows.shape[0], self.chunk_size)]
        staged_vals: Optional[torch.Tensor] = None  # [len(staged), d] on device

        payload = (self._host_payload(chunks[0], g, h_prev_host, deg,
                                      np.zeros(0, np.int64)) if chunks else None)
        for ci in range(len(chunks)):
            pl = payload
            self.stats.edges_processed += pl.n_edges
            self.stats.rows_reused += pl.n_shared
            self.stats.rows_transferred += pl.allrows.shape[0] - pl.n_shared

            # one host→device copy per chunk
            (h_fresh, shared_pos, order, rows_c, rmask, e_src, e_ridx, e_w, e_t,
             e_mask, deg_c, s_order, s_row_ptr) = host_to_device((
                 pl.h_fresh, pl.shared_pos, pl.order, pl.rows_c, pl.rmask,
                 pl.e_src, pl.e_ridx, pl.e_w, pl.e_t, pl.e_mask, pl.deg_c,
                 pl.s_order, pl.s_row_ptr), self.device)
            if pl.n_shared and staged_vals is not None:
                buf = torch.cat([staged_vals[shared_pos], h_fresh], dim=0)[order]
            else:
                buf = h_fresh
            staged_vals = buf

            h_dev = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))])
            a_c, nct_c, h_c = subset_layer(
                self.model, p, h_dev, rows_c, rmask, e_src, e_ridx, e_w, e_t,
                e_mask, deg_c, pl.r_cap, s_order, s_row_ptr,
            )
            # prefetch: next chunk's host tables build while device computes
            if ci + 1 < len(chunks):
                payload = self._host_payload(chunks[ci + 1], g, h_prev_host,
                                             deg, pl.allrows)
            k = pl.chunk.shape[0]
            outs_a.append(a_c[:k].cpu().numpy())  # sync point
            outs_n.append(nct_c[:k].cpu().numpy())
            outs_h.append(h_c[:k].cpu().numpy())
            self.stats.chunks += 1

        return (
            np.concatenate(outs_a) if outs_a else np.zeros((0, 1), np.float32),
            np.concatenate(outs_n) if outs_n else np.zeros((0, 1), np.float32),
            np.concatenate(outs_h) if outs_h else np.zeros((0, 1), np.float32),
        )
