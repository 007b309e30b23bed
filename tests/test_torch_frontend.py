"""The port's serving front-end (versioned snapshot reads) against the JAX
package's, over the port's in-place device engine.

* every read pinned to version v is bitwise equal to the post-batch-v
  state of a serially driven engine (``np.array_equal``), at every
  retained version;
* admission control: ``StaleVersionError`` below the undo floor, eviction
  of the oldest pin with ``ReadRejectedError``, the floor after a refresh,
  future pins waiting for their version;
* the reference's smoke schedule (6 batches, a fresh read and one pinned
  two versions back) serves 10 reads with 8 batches of staleness, the same
  counters as the JAX frontend, and the JAX frontend's rows at 1e-5;
* reads across fused windows: one version per logical batch, bitwise.

The stream helper is a copy of tests/test_frontend.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.graph import make_graph as j_make_graph  # noqa: E402
from repro.graph import make_stream as j_make_stream  # noqa: E402
from repro.serve import ServingFrontend as JServingFrontend  # noqa: E402
from repro.serve.api import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.api import create_engine as j_create_engine  # noqa: E402
from repro_torch.core import make_model, params_from_numpy  # noqa: E402
from repro_torch.graph import make_graph, make_stream, random_features  # noqa: E402
from repro_torch.graph.csr import CSRGraph  # noqa: E402
from repro_torch.graph.streaming import UpdateBatch  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    EngineConfig,
    FusionConfig,
    ReadRejectedError,
    ServingFrontend,
    StaleVersionError,
    create_engine,
    serving_frontend,
)

TOL_BATCH = 1e-5  # port vs reference


def _mk_stream(make_graph, make_stream, n=150, num_batches=8, seed=0):
    g = make_graph("powerlaw", n, avg_degree=5, seed=seed, weighted=True)
    x, _ = random_features(n, 8, seed=seed)
    wl = make_stream(g, num_batches=num_batches, batch_edges=8, delete_frac=0.35,
                     seed=seed + 1, feature_dim=8, feature_frac=0.02)
    return x, wl


def _params_np(dims=(8, 8)):
    jp = j_make_model("gcn").init_layers(jax.random.PRNGKey(0), list(dims))
    return [{k: np.asarray(v) for k, v in p.items()} for p in jp]


def _engine(wl, x, params_np=None, **kw):
    model = make_model("gcn")
    return create_engine("device", EngineConfig(
        model=model, graph=wl.base, x=x, device="cpu",
        params=params_from_numpy(model, params_np or _params_np(), device="cpu"), **kw))


def _serial_reference(wl, x, rows, **kw):
    eng = _engine(wl, x, **kw)
    refs = [eng.snapshot_rows(rows)]
    for b in wl.batches:
        eng.apply_batch(b)
        refs.append(eng.snapshot_rows(rows))
    return refs


def test_pinned_reads_are_bitwise_the_snapshot_at_every_version():
    x, wl = _mk_stream(make_graph, make_stream)
    rows = np.arange(0, wl.base.n, 5)
    refs = _serial_reference(wl, x, rows)
    fr = ServingFrontend(_engine(wl, x), max_pending_reads=256,
                         max_versions=len(wl.batches) + 1)
    for b in wl.batches:
        fr.apply_batch(b)
        for v in range(fr.version + 1):
            np.testing.assert_array_equal(fr.read(rows, version=v), refs[v])
    ss = fr.stats()
    assert ss.reads_served == sum(i + 2 for i in range(len(wl.batches)))
    assert ss.reads_rejected == 0
    assert ss.read_p99_s >= ss.read_p50_s > 0.0


def test_snapshot_rows_is_a_finished_copy():
    """A pre-image must not change when the state tensors are written in
    place by the next batch."""
    x, wl = _mk_stream(make_graph, make_stream, num_batches=2)
    eng = _engine(wl, x)
    rows = np.arange(wl.base.n)
    snap = eng.snapshot_rows(rows)
    kept = snap.copy()
    eng.apply_batch(wl.batches[0])
    np.testing.assert_array_equal(snap, kept)
    assert not np.array_equal(eng.snapshot_rows(rows), kept)


def test_smoke_schedule_counters_equal_the_jax_frontend():
    """The reference's smoke_frontend schedule: 10 reads, 8 staleness."""
    x, wl = _mk_stream(make_graph, make_stream, num_batches=6)
    _, jwl = _mk_stream(j_make_graph, j_make_stream, num_batches=6)
    params = _params_np()
    fr = _engine(wl, x, params).serving_frontend(max_pending_reads=16, max_versions=4)
    jfr = JServingFrontend(j_create_engine("device", JEngineConfig(
        model=j_make_model("gcn"), graph=jwl.base, x=x, params=[dict(p) for p in params])),
        max_pending_reads=16, max_versions=4)
    rows = np.arange(0, wl.base.n, 17)
    tickets = []
    for b, jb in zip(wl.batches, jwl.batches, strict=True):
        for f in (fr, jfr):
            t = [f.submit_read(rows)]
            if f.version >= 2:
                t.append(f.submit_read(rows, version=f.version - 2))
            tickets.append(t)
        fr.apply_batch(b)
        jfr.apply_batch(jb)
    fr.drain()
    jfr.drain()
    ss, jss = fr.stats(), jfr.stats()
    assert (ss.reads_served, ss.staleness_batches, ss.reads_rejected) == \
        (jss.reads_served, jss.staleness_batches, jss.reads_rejected) == (10, 8, 0)
    for mine, ref in zip(tickets[0::2], tickets[1::2]):
        for t, jt in zip(mine, ref, strict=True):
            assert (t.version, t.staleness) == (jt.version, jt.staleness)
            np.testing.assert_allclose(t.value(), jt.value(), atol=TOL_BATCH, rtol=TOL_BATCH)


def test_reads_interleave_with_pending_writes():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=4)
    rows = np.arange(0, wl.base.n, 11)
    refs = _serial_reference(wl, x, rows)
    fr = ServingFrontend(_engine(wl, x))
    tickets = []
    for b in wl.batches:
        tickets.append(fr.submit_read(rows))
        fr.apply_batch(b)
    late = fr.submit_read(rows, version=1)
    fr.drain()
    for v, t in enumerate(tickets):
        assert t.version == v and t.staleness == 0
        np.testing.assert_array_equal(t.value(), refs[v])
    np.testing.assert_array_equal(late.value(), refs[1])
    assert late.staleness == len(wl.batches) - 1


def test_backpressure_evicts_the_oldest_pin():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=3)
    fr = ServingFrontend(_engine(wl, x), max_pending_reads=2)
    for b in wl.batches:
        fr.apply_batch(b)
    rows = np.arange(8)
    t0 = fr.submit_read(rows, version=0)
    t1 = fr.submit_read(rows, version=1)
    t2 = fr.submit_read(rows, version=2)
    assert t0.done and isinstance(t0.error, ReadRejectedError)
    with pytest.raises(ReadRejectedError):
        t0.value()
    assert not t1.done and not t2.done
    assert fr.drain() == 2
    ss = fr.stats()
    assert ss.reads_rejected == 1 and ss.reads_served == 2
    with pytest.raises(ValueError, match="max_pending_reads"):
        ServingFrontend(_engine(wl, x), max_pending_reads=0)


def test_stale_pin_is_rejected_below_the_floor():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=4)
    fr = ServingFrontend(_engine(wl, x), max_versions=2)
    for b in wl.batches:
        fr.apply_batch(b)
    assert fr.version == 4 and fr.min_version == 2
    with pytest.raises(StaleVersionError):
        fr.submit_read(np.arange(4), version=1)
    assert fr.stats().reads_rejected == 1
    assert fr.read(np.arange(4), version=2).shape == (4, 8)


def test_refresh_moves_the_floor():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=4)
    rows = np.arange(0, wl.base.n, 9)
    refs = _serial_reference(wl, x, rows, refresh_every=2)
    fr = ServingFrontend(_engine(wl, x, refresh_every=2), max_versions=8)
    fr.apply_batch(wl.batches[0])
    fr.apply_batch(wl.batches[1])  # the refresh fires after this batch
    assert fr.min_version == fr.version == 2
    with pytest.raises(StaleVersionError):
        fr.submit_read(rows, version=1)
    fr.apply_batch(wl.batches[2])
    np.testing.assert_array_equal(fr.read(rows, version=2), refs[2])
    np.testing.assert_array_equal(fr.read(rows, version=3), refs[3])


def test_future_pin_waits_for_its_version():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=3)
    rows = np.arange(0, wl.base.n, 13)
    refs = _serial_reference(wl, x, rows)
    fr = serving_frontend(_engine(wl, x))
    t = fr.submit_read(rows, version=2)
    fr.apply_batch(wl.batches[0])
    assert not t.done
    fr.apply_batch(wl.batches[1])
    fr.apply_batch(wl.batches[2])
    assert t.done and t.staleness == 0
    np.testing.assert_array_equal(t.value(), refs[2])


def _ring(n):
    src = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n]).astype(np.int64)
    return CSRGraph.from_edges(n, src, np.concatenate([np.arange(n)] * 2).astype(np.int64))


def _mixed_ring_stream(n=600, seed=13):
    rng = np.random.default_rng(seed)
    bases = [i * 60 % n for i in range(8)] + [15 + i for i in range(4)] \
        + [(i * 60 + 30) % n for i in range(8)]
    return [UpdateBatch(ins_src=np.array([(b + 1) % n], np.int64),
                        ins_dst=np.array([(b + 5) % n], np.int64),
                        del_src=np.array([], np.int64), del_dst=np.array([], np.int64),
                        feat_vertices=np.array([(b + 7) % n], np.int64),
                        feat_values=rng.standard_normal((1, 8)).astype(np.float32))
            for b in bases]


@pytest.mark.parametrize("refresh_every", [0, 4])
def test_reads_across_fused_windows(refresh_every):
    """One undo version per logical batch inside fused windows: every
    retained version reads bitwise as the serial engine's, and the floor
    after a refresh matches the serial frontend's."""
    n = 600
    g = _ring(n)
    x = np.random.default_rng(4).standard_normal((n, 8)).astype(np.float32)
    batches = _mixed_ring_stream(n)
    rows = np.arange(0, n, 13)
    model = make_model("gcn")
    params = params_from_numpy(model, _params_np(), device="cpu")

    def eng(fused):
        return create_engine("device", EngineConfig(
            model=model, graph=g, x=x, params=params, device="cpu",
            refresh_every=refresh_every, fusion=FusionConfig(window=4) if fused else None))

    serial = eng(False)
    refs = [serial.snapshot_rows(rows)]
    for b in batches:
        serial.apply_batch(b)
        refs.append(serial.snapshot_rows(rows))
    frs = {f: ServingFrontend(eng(f), max_pending_reads=512, max_versions=len(batches) + 1)
           for f in (False, True)}
    ss = {f: fr.run_stream(batches) for f, fr in frs.items()}
    assert ss[True].fusion_windows >= 4 and ss[True].fused_batches >= 12
    assert ss[False].fusion_windows == 0
    assert frs[True].version == len(batches)
    assert frs[True].min_version == frs[False].min_version
    for v in range(frs[True].min_version, len(batches) + 1):
        np.testing.assert_array_equal(frs[True].read(rows, version=v), refs[v])
    if frs[True].min_version:
        with pytest.raises(StaleVersionError):
            frs[True].read(rows, version=frs[True].min_version - 1)
