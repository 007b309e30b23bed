"""The port's ``graph/pma.py`` (``PMAGraph``): the reference's three PMA tests
(``tests/test_graph.py``) on the port, and each snapshot's arrays equal to
the reference's ``PMAGraph`` (``repro.graph.pma``) after the same inserts
and deletes, exactly (host numpy on both sides)."""
import numpy as np
import pytest

from repro.graph.pma import PMAGraph as RefPMAGraph
from repro_torch.graph import CSRGraph, PMAGraph

_CSR_FIELDS = ("in_indptr", "in_indices", "out_indptr", "out_indices", "in_weights",
               "in_etypes", "out_weights", "out_etypes")


def test_pma_insert_delete_snapshot():
    pma = PMAGraph(20, capacity=64, seg=16)
    rng = np.random.default_rng(1)
    edges = set()
    for _ in range(300):
        u, v = int(rng.integers(20)), int(rng.integers(20))
        if (u, v) in edges:
            pma.delete_edge(u, v)
            edges.discard((u, v))
        else:
            pma.insert_edge(u, v, w=0.5, t=1)
            edges.add((u, v))
    snap = pma.snapshot()
    assert isinstance(snap, CSRGraph)
    assert snap.num_edges == len(edges)
    for (u, v) in edges:
        assert snap.has_edge(u, v)
    assert pma.num_edges == len(edges)


def test_pma_growth_preserves_edges():
    pma = PMAGraph(5, capacity=8, seg=8)
    edges = [(i % 5, (i * 3 + 1) % 5) for i in range(20)]
    edges = list(dict.fromkeys((u, v) for u, v in edges if u != v))
    for u, v in edges:
        pma.insert_edge(u, v)
    snap = pma.snapshot()
    for u, v in edges:
        assert snap.has_edge(u, v)


def test_pma_errors():
    pma = PMAGraph(4)
    pma.insert_edge(0, 1)
    with pytest.raises(ValueError):
        pma.insert_edge(0, 1)
    with pytest.raises(ValueError):
        pma.delete_edge(1, 0)


@pytest.mark.parametrize("n,capacity,seg,ops,seed", [
    (20, 64, 16, 300, 1),  # the reference test's sequence: deletes and local rebalances
    (5, 8, 8, 40, 2),  # growth from a tiny array
    (200, 256, 32, 3000, 3),  # many vertices: window rebalances and several doublings
])
def test_pma_snapshots_equal_the_reference(n, capacity, seg, ops, seed):
    """The same insert/delete sequence (weights and types riding along) on
    both: the packed arrays, the extents and every snapshot's CSR arrays
    are equal after each tenth of the sequence."""
    port, ref = PMAGraph(n, capacity=capacity, seg=seg), RefPMAGraph(n, capacity=capacity, seg=seg)
    rng = np.random.default_rng(seed)
    edges = set()
    for i in range(ops):
        u, v = int(rng.integers(n)), int(rng.integers(n))
        if (u, v) in edges:
            port.delete_edge(u, v)
            ref.delete_edge(u, v)
            edges.discard((u, v))
        else:
            w, t = float(rng.random()), int(rng.integers(4))
            port.insert_edge(u, v, w=w, t=t)
            ref.insert_edge(u, v, w=w, t=t)
            edges.add((u, v))
        if (i + 1) % max(ops // 10, 1) == 0:
            for name in ("nbr", "wgt", "ety", "vstart", "vend"):
                np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
            assert port.capacity == ref.capacity and port.num_edges == ref.num_edges
            a, b = port.snapshot(), ref.snapshot()
            assert a.n == b.n
            for name in _CSR_FIELDS:
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
