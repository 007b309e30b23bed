"""Synthetic graph generators (host side).

The port's own copy of ``repro.graph.generators`` (numpy only; the port
imports nothing of the JAX package).  Copied as it is:
``barabasi_albert`` is an O(n²) Python loop, so at a million vertices use
``make_graph("uniform", …)``.

Real-graph stand-ins for the paper's datasets (Table III): power-law graphs
(Barabási–Albert style preferential attachment → Twitter/Friendster/Products
analogue), uniform random graphs (Erdős–Rényi), and high-average-degree dense
community graphs (Reddit analogue).  Undirected workloads are materialized as
two directed edges.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph


def _dedup(src: np.ndarray, dst: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    key = dst.astype(np.int64) * n + src.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    return src[idx], dst[idx]


def barabasi_albert(
    n: int,
    m: int = 4,
    seed: int = 0,
    undirected: bool = True,
) -> CSRGraph:
    """Preferential-attachment power-law graph with ~m edges per new vertex."""
    rng = np.random.default_rng(seed)
    repeated: list[int] = list(range(m))
    src_l: list[int] = []
    dst_l: list[int] = []
    for v in range(m, n):
        chosen = rng.choice(repeated, size=m, replace=True)
        chosen = np.unique(chosen)
        for t in chosen:
            src_l.append(v)
            dst_l.append(int(t))
        repeated.extend(chosen.tolist())
        repeated.extend([v] * len(chosen))
    src = np.array(src_l, dtype=np.int64)
    dst = np.array(dst_l, dtype=np.int64)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    mask = src != dst
    src, dst = _dedup(src[mask], dst[mask], n)
    return CSRGraph.from_edges(n, src, dst)


def erdos_renyi(n: int, avg_degree: float = 8.0, seed: int = 0, undirected: bool = False) -> CSRGraph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree) // (2 if undirected else 1)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    mask = src != dst
    src, dst = _dedup(src[mask], dst[mask], n)
    return CSRGraph.from_edges(n, src, dst)


def make_graph(
    kind: str,
    n: int,
    avg_degree: float = 8.0,
    seed: int = 0,
    num_etypes: int = 1,
    weighted: bool = False,
) -> CSRGraph:
    """Unified entry: kind in {powerlaw, uniform, dense}."""
    if kind == "powerlaw":
        g = barabasi_albert(n, m=max(1, int(avg_degree) // 2), seed=seed)
    elif kind == "uniform":
        g = erdos_renyi(n, avg_degree=avg_degree, seed=seed)
    elif kind == "dense":
        g = erdos_renyi(n, avg_degree=max(avg_degree, 32.0), seed=seed)
    else:
        raise ValueError(f"unknown graph kind {kind!r}")
    rng = np.random.default_rng(seed + 1)
    src, dst, w, t = g.edges_by_dst()
    if weighted:
        w = rng.uniform(0.5, 1.5, size=src.shape[0]).astype(np.float32)
    if num_etypes > 1:
        t = rng.integers(0, num_etypes, size=src.shape[0]).astype(np.int32)
    return CSRGraph.from_edges(n, src, dst, w, t)


def random_features(
    n: int, d: int, num_labels: int = 0, seed: int = 0
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, size=(n, d)).astype(np.float32)
    y = rng.integers(0, num_labels, size=(n,)).astype(np.int32) if num_labels else None
    return x, y
