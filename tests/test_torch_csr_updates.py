"""The port's merge-based ``CSRGraph.apply_updates`` against the JAX package's
(``repro.graph.csr``, which rebuilds the snapshot through ``from_edges``).

Every array of every snapshot must be equal bit for bit, with the same
dtype, to the reference's on the same stream; and to the port's own
``from_edges`` over the same edge set.  The reference's errors and its
handling of repeated deletes and of a delete and re-insert in one batch are
kept.
"""
import numpy as np
import pytest

from repro.graph import csr as jcsr  # noqa: E402
from repro_torch.graph import csr as tcsr  # noqa: E402
from repro_torch.graph import (  # noqa: E402
    ADVERSARIAL_REGIMES,
    make_adversarial_stream,
    make_graph,
    make_stream,
)

FIELDS = ("in_indptr", "in_indices", "out_indptr", "out_indices", "in_weights", "in_etypes",
          "out_weights", "out_etypes")


def _ref_graph(g):
    return jcsr.CSRGraph(n=g.n, **{f: getattr(g, f).copy() for f in FIELDS})


def _assert_same(port, ref, msg=""):
    assert port.n == ref.n
    for f in FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype, f"{msg} {f}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {f}")


def _apply(g, b):
    return g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst, b.ins_weights,
                           b.ins_etypes)


def _rebuilt(g):
    """The port's ``from_edges`` over ``g``'s edge set."""
    src, dst, w, t = g.edges_by_dst()
    return tcsr.CSRGraph.from_edges(g.n, src, dst, w, t)


@pytest.mark.parametrize("kind,etypes", [("uniform", 1), ("powerlaw", 3)])
def test_stream_snapshots_equal_reference(kind, etypes):
    g = make_graph(kind, 600, avg_degree=8, seed=3, num_etypes=etypes, weighted=True)
    wl = make_stream(g, num_batches=8, batch_edges=60, delete_frac=0.4, seed=4)
    port, ref = wl.base, _ref_graph(wl.base)
    for i, b in enumerate(wl.batches):
        port, ref = _apply(port, b), _apply(ref, b)
        _assert_same(port, ref, f"batch {i}")
        _assert_same(port, _rebuilt(port), f"batch {i} from_edges")


@pytest.mark.parametrize("regime", ADVERSARIAL_REGIMES)
def test_adversarial_snapshots_equal_reference(regime):
    wl = make_adversarial_stream(regime)
    port, ref = wl.base, _ref_graph(wl.base)
    for i, b in enumerate(wl.batches):
        port, ref = _apply(port, b), _apply(ref, b)
        _assert_same(port, ref, f"{regime} batch {i}")


def _small():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 20, 80), rng.integers(0, 20, 80)
    keep = np.unique(dst * 20 + src, return_index=True)[1]
    w = rng.uniform(0.5, 1.5, keep.size).astype(np.float32)
    t = rng.integers(0, 3, keep.size).astype(np.int32)
    g = tcsr.CSRGraph.from_edges(20, src[keep], dst[keep], w, t)
    return g, _ref_graph(g)


def _edge(g, i):
    src, dst, _, _ = g.edges_by_dst()
    return int(src[i]), int(dst[i])


def _arr(*xs, dt=np.int64):
    return np.asarray(xs, dt)


def _both(g, ref, *args, **kw):
    port = g.apply_updates(*args, **kw)
    _assert_same(port, ref.apply_updates(*args, **kw))
    _assert_same(port, _rebuilt(port))
    return port


def test_repeated_delete_deletes_once_and_reinsert_takes_the_new_weight():
    g, ref = _small()
    (u, v), (x, y) = _edge(g, 5), _edge(g, 30)
    none = _arr()
    out = _both(g, ref, none, none, _arr(u, u, x), _arr(v, v, y))
    assert out.num_edges == g.num_edges - 2
    out = _both(g, ref, _arr(u), _arr(v), _arr(u, u), _arr(v, v), ins_weights=_arr(7.5, dt=np.float32),
                ins_etypes=_arr(2, dt=np.int32))
    assert out.num_edges == g.num_edges and out.has_edge(u, v)
    lo, hi = out.in_indptr[v], out.in_indptr[v + 1]
    at = lo + int(np.searchsorted(out.in_indices[lo:hi], u))
    assert out.in_weights[at] == 7.5 and out.in_etypes[at] == 2
    _both(g, ref, none, none, none, none)  # an empty batch: the same snapshot
    # new edges only, unsorted, with default weights and types
    fresh = [(a, b) for a in range(20) for b in range(20) if not g.has_edge(a, b)][:7][::-1]
    _both(g, ref, _arr(*[a for a, _ in fresh]), _arr(*[b for _, b in fresh]), none, none)


@pytest.mark.parametrize("case", ["missing", "missing_twice", "dup_survivor", "dup_insert",
                                  "src_range", "dst_range"])
def test_errors_match_reference(case):
    g, ref = _small()
    (u, v) = _edge(g, 3)
    absent = next((a, b) for a in range(20) for b in range(20) if not g.has_edge(a, b))
    none = _arr()
    args = {
        "missing": (none, none, _arr(u, absent[0]), _arr(v, absent[1])),
        "missing_twice": (none, none, _arr(absent[0], absent[0]), _arr(absent[1], absent[1])),
        "dup_survivor": (_arr(u), _arr(v), none, none),
        "dup_insert": (_arr(absent[0], absent[0]), _arr(absent[1], absent[1]), none, none),
        "src_range": (_arr(20), _arr(0), none, none),
        "dst_range": (_arr(0), _arr(-1), none, none),
    }[case]
    err = AssertionError if case.endswith("range") else ValueError
    with pytest.raises(err) as ref_err:
        ref.apply_updates(*args)
    with pytest.raises(err) as port_err:
        g.apply_updates(*args)
    assert str(port_err.value) == str(ref_err.value)
