"""The port's host-resident substrates against the JAX package's, and their
own bitwise invariants.

* ``create_engine("offload", …)`` vs the reference's offload engine, batch
  by batch at 1e-5 (gcn and gat), with equal ``TransferStats``, and against
  full recomputation at the reference's ``TOL = 2e-4``;
* the fig7 smoke recipe (powerlaw n = 300, features 16, one layer, 6 batches
  of 8 edges): 2970 transfer rows and 145,560 staged bytes, equal to the
  reference's, and ``prefetch_hits`` 5 — the counters
  ``benchmarks/check_regression.py`` pins for the reference;
* ``prefetch_hits`` = batches − 1 async and 0 through the sync escape hatch;
* bitwise (``np.array_equal`` / ``torch.equal``): async ≡ sync over 20
  batches, device ≡ offload for gcn, a fused window ≡ the serial loop on the
  offload engine (the reference's ring cell: 3 windows / 12 fused batches /
  3 dispatches);
* ``create_engine("chunked", …)`` vs the reference's chunked engine at 1e-5
  with equal ``ChunkStats``;
* the execution policy and the serving front-end on the offload engine;
* the staging pipeline's unit behaviour (worker exceptions reach ``flush``
  and ``apply_batch``, in-order drain, sync mode inline, grow-only double
  buffers, the in-flight wait before a refill);
* the ``StreamStats.as_dict()`` keys stay the reference's.

Streams are copies of tests/test_staging.py's and tests/test_torch_engine.py's
(gat against the reference only on a stream where no destination drains,
seed 2: ROADMAP Queue 3).
"""
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.backend import STREAM_STAT_KEYS as J_STREAM_STAT_KEYS  # noqa: E402
from repro.core.full import full_forward as j_full_forward  # noqa: E402
from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.graph import make_graph as j_make_graph  # noqa: E402
from repro.graph import make_stream as j_make_stream  # noqa: E402
from repro.serve.api import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.api import create_engine as j_create_engine  # noqa: E402
from repro_torch.core import ExecutionPolicy, full_forward, make_model  # noqa: E402
from repro_torch.core.params import params_from_numpy  # noqa: E402
from repro_torch.graph import (  # noqa: E402
    make_adversarial_stream,
    make_graph,
    make_stream,
    random_features,
)
from repro_torch.graph.csr import CSRGraph  # noqa: E402
from repro_torch.graph.streaming import UpdateBatch  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    FusionConfig,
    HostStagingPipeline,
    StagingConfig,
    create_engine,
)
from repro_torch.serve.staging import StagingBuffers  # noqa: E402

TOL = 2e-4  # the reference's tests/test_backends.py tolerance vs full recompute
TOL_BATCH = 1e-5  # port vs reference engine, per batch
SEED = 2  # a stream on which no destination drains (tests/test_torch_engine.py)


def _mk_stream(make_graph, make_stream, n=150, num_batches=20, seed=0, batch_edges=8):
    g = make_graph("powerlaw", n, avg_degree=5, seed=seed, weighted=True)
    x, _ = random_features(n, 8, seed=seed)
    wl = make_stream(g, num_batches=num_batches, batch_edges=batch_edges,
                     delete_frac=0.35, seed=seed + 1, feature_dim=8, feature_frac=0.02)
    return x, wl


def _params_np(name, dims=(8, 8, 8)):
    jp = j_make_model(name).init_layers(jax.random.PRNGKey(0), list(dims))
    return [{k: np.asarray(v) for k, v in p.items()} for p in jp]


def _engine(backend, name, graph, x, params_np, **kw):
    model = make_model(name)
    return create_engine(backend, EngineConfig(
        model=model, graph=graph, x=x, params=params_from_numpy(model, params_np, device="cpu"),
        device="cpu", **kw))


def _final_state(x, wl):
    g, xc = wl.base, np.array(x)
    for b in wl.batches:
        g = g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst, b.ins_weights,
                            b.ins_etypes)
        if b.feat_vertices is not None:
            xc[b.feat_vertices] = b.feat_values
    return g, xc


def _same_state(u, v) -> bool:
    return all(np.array_equal(np.asarray(p), np.asarray(q))
               for kind in ("h", "a", "nct") for p, q in zip(getattr(u, kind), getattr(v, kind)))


# ---------------------------------------------------------------------- #
# offload vs the reference's offload engine
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_offload_matches_reference_offload_per_batch(name):
    x, wl = _mk_stream(make_graph, make_stream, seed=SEED, num_batches=8)
    _, jwl = _mk_stream(j_make_graph, j_make_stream, seed=SEED, num_batches=8)
    jmodel = j_make_model(name)
    jparams = jmodel.init_layers(jax.random.PRNGKey(0), [8, 8, 8])
    params_np = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    ref = j_create_engine("offload", JEngineConfig(model=jmodel, graph=jwl.base, x=x,
                                                   params=jparams))
    eng = _engine("offload", name, wl.base, x, params_np)
    np.testing.assert_allclose(eng.embeddings, np.asarray(ref.embeddings), atol=TOL_BATCH)
    for i, (b, jb) in enumerate(zip(wl.batches, jwl.batches)):
        eng.apply_batch(b)
        ref.apply_batch(jb)
        np.testing.assert_allclose(eng.embeddings, np.asarray(ref.embeddings), atol=TOL_BATCH,
                                   rtol=TOL_BATCH, err_msg=f"batch {i}")
    assert asdict(eng.transfers) == asdict(ref.transfers)
    g, xf = _final_state(x, wl)
    jg, _ = _final_state(x, jwl)
    oracle = np.asarray(j_full_forward(jmodel, jparams, jnp.asarray(xf), jg)[-1].h)
    assert float(np.abs(eng.embeddings - oracle).max()) < TOL
    own = full_forward(eng.model, eng.params, torch.from_numpy(xf), g)[-1].h.numpy()
    assert float(np.abs(eng.embeddings - own).max()) < TOL


def _fig7_smoke(make_graph, make_stream):
    """benchmarks/fig7_response_time.py ``smoke``: setup("powerlaw", n=300,
    avg_degree=4.0, num_batches=6, batch_edges=8), features 16, dims [16, 16]."""
    g = make_graph("powerlaw", 300, avg_degree=4.0, seed=0, weighted=True)
    x, _ = random_features(300, 16, seed=0)
    return x, make_stream(g, num_batches=6, batch_edges=8, delete_frac=0.3, seed=1)


def test_fig7_smoke_transfer_counters_equal_reference():
    x, wl = _fig7_smoke(make_graph, make_stream)
    _, jwl = _fig7_smoke(j_make_graph, j_make_stream)
    jmodel = j_make_model("gcn")
    jparams = jmodel.init_layers(jax.random.PRNGKey(0), [16, 16])
    ref = j_create_engine("offload", JEngineConfig(model=jmodel, graph=jwl.base, x=x,
                                                   params=jparams))
    jss = ref.apply_stream(jwl.batches)
    eng = _engine("offload", "gcn", wl.base, x, _params_np("gcn", (16, 16)))
    ss = eng.apply_stream(wl.batches)
    assert asdict(eng.transfers) == asdict(ref.transfers)
    assert eng.transfers.total_rows == 2970  # BENCH_baseline.json offload_transfer_rows
    assert ss.staged_bytes == jss.staged_bytes == 145_560
    assert ss.prefetch_hits == jss.prefetch_hits == len(wl.batches) - 1
    assert ss.sync_wait_s >= 0.0 and ss.compute_s >= 0.0


# ---------------------------------------------------------------------- #
# bitwise invariants inside the port
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_async_staging_bitwise_equals_sync_20_batches(name):
    x, wl = _mk_stream(make_graph, make_stream, n=120, seed=5)
    params = _params_np(name, (8, 8))
    sync = _engine("offload", name, wl.base, x, params,
                   staging=StagingConfig(async_enabled=False))
    asyn = _engine("offload", name, wl.base, x, params)
    assert sync.async_staging is False and asyn.async_staging is True
    for b in wl.batches:
        sync.apply_batch(b)
        asyn.apply_batch(b)
    assert _same_state(sync, asyn)
    assert sync.transfers == asyn.transfers
    assert sync.staging.stats.staged_bytes == asyn.staging.stats.staged_bytes
    assert sync.staging.stats.gather_jobs == asyn.staging.stats.gather_jobs


def test_stream_path_bitwise_and_prefetch_hits():
    """apply_stream (plan overlap + deferred final write-back on the worker)
    matches the sync path bit for bit; the sync escape hatch flushes in
    dispatch, so it scores no prefetch hit."""
    x, wl = _mk_stream(make_graph, make_stream, n=120, num_batches=8, seed=9)
    params = _params_np("gat")
    sync = _engine("offload", "gat", wl.base, x, params,
                   staging=StagingConfig(async_enabled=False))
    asyn = _engine("offload", "gat", wl.base, x, params)
    ss_sync = sync.apply_stream(wl.batches)
    ss = asyn.apply_stream(wl.batches)
    assert np.array_equal(sync.embeddings, asyn.embeddings)
    assert ss.prefetch_hits == len(wl.batches) - 1
    assert ss_sync.prefetch_hits == 0
    assert ss.staged_bytes == ss_sync.staged_bytes == asyn.staging.stats.staged_bytes > 0


def test_device_bitwise_equals_offload_gcn():
    x, wl = _mk_stream(make_graph, make_stream, seed=3)
    params = _params_np("gcn")
    dev = _engine("device", "gcn", wl.base, x, params)
    off = _engine("offload", "gcn", wl.base, x, params)
    for b in wl.batches:
        dev.apply_batch(b)
        off.apply_batch(b)
    for kind in ("h", "a", "nct"):
        for u, v in zip(getattr(dev, kind), getattr(off, kind)):
            assert np.array_equal(u.numpy(), v)


def _ring(n=600, num=12, seed=0):
    """benchmarks/fig7_response_time.py ``smoke_fusion``: a ring lattice and
    12 single-edge batches with one feature update, 45 rows apart."""
    idx = np.arange(n, dtype=np.int64)
    g = CSRGraph.from_edges(n, np.concatenate([(idx + 1) % n, (idx + 2) % n]),
                            np.concatenate([idx, idx]))
    rng = np.random.default_rng(seed)
    batches = [UpdateBatch(
        ins_src=np.array([(i * 45 + 1) % n], np.int64),
        ins_dst=np.array([(i * 45 + 5) % n], np.int64),
        del_src=np.array([], np.int64), del_dst=np.array([], np.int64),
        feat_vertices=np.array([(i * 45 + 7) % n], np.int64),
        feat_values=rng.standard_normal((1, 8)).astype(np.float32)) for i in range(num)]
    return g, batches


def test_fused_window_bitwise_equals_serial_on_offload():
    g, batches = _ring()
    x, _ = random_features(g.n, 8, seed=0)
    params = _params_np("gcn", (8, 8))
    serial = _engine("offload", "gcn", g, x, params)
    fused = _engine("offload", "gcn", g, x, params, fusion=FusionConfig(window=4))
    ss_s = serial.apply_stream(batches)
    ss = fused.apply_stream(batches)
    assert (ss.fusion_windows, ss.fused_batches, ss.fusion_fallbacks) == (3, 12, 0)
    assert len(batches) - (ss.fused_batches - ss.fusion_windows) == 3  # dispatches
    assert ss_s.fusion_windows == 0
    assert _same_state(serial, fused)


# ---------------------------------------------------------------------- #
# the chunked backend
# ---------------------------------------------------------------------- #
def test_chunked_matches_reference_chunked():
    x, wl = _mk_stream(make_graph, make_stream, seed=SEED, num_batches=4)
    _, jwl = _mk_stream(j_make_graph, j_make_stream, seed=SEED, num_batches=4)
    jmodel = j_make_model("gcn")
    jparams = jmodel.init_layers(jax.random.PRNGKey(0), [8, 8, 8])
    params_np = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    ref = j_create_engine("chunked", JEngineConfig(model=jmodel, graph=jwl.base, x=x,
                                                   params=jparams, chunk_size=64))
    eng = _engine("chunked", "gcn", wl.base, x, params_np, chunk_size=64)
    for i, (b, jb) in enumerate(zip(wl.batches, jwl.batches)):
        eng.apply_batch(b)
        ref.apply_batch(jb)
        np.testing.assert_allclose(eng.embeddings, np.asarray(ref.embeddings), atol=TOL_BATCH,
                                   rtol=TOL_BATCH, err_msg=f"batch {i}")
    assert asdict(eng.chunk_stats) == asdict(ref.chunk_stats)
    assert eng.chunk_stats.chunks > len(wl.batches)  # chunk_size 64 splits batches
    g, xf = _final_state(x, wl)
    own = full_forward(eng.model, eng.params, torch.from_numpy(xf), g)[-1].h.numpy()
    assert float(np.abs(eng.embeddings - own).max()) < TOL


# ---------------------------------------------------------------------- #
# policy and serving on the offload engine
# ---------------------------------------------------------------------- #
def test_policy_on_offload_matches_device_decisions():
    """feature_churn mixes incremental and chunked batches (one layer, the
    depth the reference pins its decisions at): the offload engine decides
    as the device engine does and lands on the same embeddings."""
    wl = make_adversarial_stream("feature_churn", num_batches=6)
    x, _ = random_features(wl.base.n, 8, seed=0)
    params = _params_np("gcn", (8, 8))
    runs = {}
    for backend in ("device", "offload"):
        eng = _engine(backend, "gcn", wl.base, x, params, policy="adaptive")
        runs[backend] = (eng, [eng.apply_batch(b).mode for b in wl.batches])
    (dev, dmodes), (off, omodes) = runs["device"], runs["offload"]
    assert omodes == dmodes and set(omodes) == {"incremental", "chunked"}
    np.testing.assert_allclose(off.embeddings, dev.embeddings.numpy(), atol=TOL_BATCH)
    replay = _engine("offload", "gcn", wl.base, x, params,
                     policy=ExecutionPolicy(force_mode=tuple(omodes)))
    for b in wl.batches:
        replay.apply_batch(b)
    assert _same_state(off, replay)


def test_frontend_reads_on_offload_equal_snapshots():
    x, wl = _mk_stream(make_graph, make_stream, n=120, num_batches=6, seed=5)
    eng = _engine("offload", "gcn", wl.base, x, _params_np("gcn", (8, 8)))
    fr = eng.serving_frontend(max_versions=len(wl.batches) + 1)
    rows = np.arange(0, wl.base.n, 7)
    snaps = [eng.snapshot_rows(rows)]
    for b in wl.batches:
        fr.apply_batch(b)
        snaps.append(eng.snapshot_rows(rows))
    for v in range(fr.version + 1):
        assert np.array_equal(np.asarray(fr.read(rows, version=v)), snaps[v])


def test_stream_stats_keys_stay_pinned():
    x, wl = _mk_stream(make_graph, make_stream, n=120, num_batches=2, seed=5)
    d = _engine("offload", "gcn", wl.base, x, _params_np("gcn", (8, 8))).apply_stream(
        wl.batches).as_dict()
    assert tuple(d) == J_STREAM_STAT_KEYS
    assert d["staged_bytes"] > 0 and d["prefetch_hits"] == 1


# ---------------------------------------------------------------------- #
# staging pipeline: worker faults, order, sync mode, buffers
# ---------------------------------------------------------------------- #
def test_worker_exception_propagates_out_of_flush():
    x, wl = _mk_stream(make_graph, make_stream, n=100, num_batches=2, seed=13)
    eng = _engine("offload", "gcn", wl.base, x, _params_np("gcn", (8, 8)))
    eng.apply_batch(wl.batches[0])

    def boom(tag):
        if tag == "final":
            raise ValueError("injected staging fault")

    eng.staging.writeback_hook = boom
    backend, orch = eng._backend, eng._orch
    b = wl.batches[1]
    prep = backend.plan(orch.graph, orch._apply_graph(b), b)
    backend.dispatch(prep)  # the final write-back fails on the worker thread
    with pytest.raises(RuntimeError, match="staging"):
        backend.flush()


def test_worker_exception_reaches_apply_batch_caller():
    x, wl = _mk_stream(make_graph, make_stream, n=100, num_batches=2, seed=17)
    eng = _engine("offload", "gcn", wl.base, x, _params_np("gcn", (8, 8)))
    eng.apply_batch(wl.batches[0])
    eng.staging.writeback_hook = lambda tag: (_ for _ in ()).throw(
        ValueError("injected staging fault"))
    with pytest.raises(RuntimeError, match="staging"):
        eng.apply_batch(wl.batches[1])


def test_pipeline_inorder_execution_and_drain():
    pipe = HostStagingPipeline(num_layers=2, async_mode=True)
    order = []
    tickets = [pipe.submit_gather(lambda i=i: order.append(("g", i)), tag=i) for i in range(3)]
    pipe.submit_writeback(lambda: order.append(("wb", 0)), nbytes=16)
    pipe.drain()
    assert order == [("g", 0), ("g", 1), ("g", 2), ("wb", 0)]
    assert all(t.done() for t in tickets) and pipe.idle
    assert pipe.stats.gather_jobs == 3 and pipe.stats.writeback_jobs == 1
    assert pipe.stats.staged_bytes == 16  # writeback nbytes; gathers returned None
    pipe.close()


def test_pipeline_sync_mode_runs_inline_and_raises_at_submit():
    pipe = HostStagingPipeline(num_layers=1, async_mode=False)
    seen = []
    t = pipe.submit_gather(lambda: seen.append(1) or np.zeros((2, 4), np.float32))
    assert t.done() and seen == [1]
    assert pipe.wait_gather(t).shape == (2, 4)
    assert pipe.stats.staged_bytes == 32
    with pytest.raises(RuntimeError, match="staging"):
        pipe.submit_writeback(lambda: 1 / 0)
    pipe.drain()  # the sync path raised at submit; drain stays clean


def test_staging_buffers_grow_only_and_double_buffering():
    def ptr(a):
        return a.__array_interface__["data"][0]

    bufs = StagingBuffers()
    v1 = bufs.take("h", 8, (4,))
    v2 = bufs.take("h", 6, (4,))  # shrink: same backing buffer
    assert ptr(v2) == ptr(v1) and v2.shape == (6, 4)
    v3 = bufs.take("h", 32, (4,))  # growth reallocates (grow-only, ≥ 2×)
    assert v3.shape == (32, 4) and ptr(v3) != ptr(v1)
    assert ptr(bufs.take("h", 20, (4,))) == ptr(v3)
    assert ptr(bufs.take("h", 8, (5,))) != ptr(v3)  # other trailing shape, own buffer
    assert not bufs.pinned

    pipe = HostStagingPipeline(num_layers=2, async_mode=False)
    a = pipe.buffers(0)
    pipe.begin_batch()
    b = pipe.buffers(0)
    pipe.begin_batch()
    assert a is not b and a is pipe.buffers(0)  # two sets per layer, alternated


def test_staging_buffers_wait_for_in_flight_copy_before_refill():
    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    bufs = StagingBuffers()
    bufs.wait_free()  # nothing in flight: returns at once
    bufs.mark_in_flight(Event())
    bufs.wait_free()
    bufs.wait_free()  # the event is consumed once
    assert Event.waited == 1


def test_copy_out_lands_in_the_set_and_counts_device_wait():
    pipe = HostStagingPipeline(num_layers=1, async_mode=False)
    outs = (torch.arange(6.0).reshape(3, 2), torch.ones(3, 1))
    copy = pipe.copy_out(outs, pipe.buffers(0))
    a, b = pipe.wait_device(copy)
    assert np.array_equal(a, outs[0].numpy()) and np.array_equal(b, outs[1].numpy())
    assert copy.event is None and copy.nbytes == 6 * 4 + 3 * 4


def test_offload_layers_make_no_scratch_copies(monkeypatch):
    """The staged blocks carry their zeroed scratch row and the layer runs
    in place on them: the offload path never calls ``with_scratch`` (a
    copy of a block), cached or not, and still equals the copying layer's
    result bit for bit."""
    import repro_torch.core.backend as backend
    import repro_torch.core.incremental as inc

    def refuse(x):
        raise AssertionError("the offload path copied a block to add its scratch row")

    x, wl = _mk_stream(make_graph, make_stream, seed=SEED, num_batches=4)
    params = _params_np("gat")
    want = _engine("device", "gat", wl.base, x, params)
    want.apply_stream(wl.batches)
    engines = [_engine("offload", "gat", wl.base, x, params, **kw)
               for kw in ({}, {"cache": CacheConfig(capacity_rows=32)})]
    monkeypatch.setattr(inc, "with_scratch", refuse)
    monkeypatch.setattr(backend, "with_scratch", refuse)
    for eng in engines:
        eng.apply_stream(wl.batches)
        for kind in ("h", "a", "nct"):
            for u, v in zip(getattr(want, kind), getattr(eng, kind)):
                assert np.array_equal(u.numpy(), v)


def test_synchronize_completes_the_deferred_writeback():
    """``synchronize`` on the offload engine is a full barrier by itself:
    the backend flushes the deferred final-layer write-back first."""
    x, wl = _mk_stream(make_graph, make_stream, seed=SEED, num_batches=3)
    params = _params_np("gcn")
    ref = _engine("offload", "gcn", wl.base, x, params)
    eng = _engine("offload", "gcn", wl.base, x, params)
    assert eng.async_staging and eng.store_h and not eng.fused
    for b in wl.batches:
        ref.apply_batch(b)
        eng.apply_batch(b, block=False)
        assert eng._backend._pending is not None
        eng.synchronize()
        assert eng._backend._pending is None
        assert np.array_equal(eng._backend.h[-1], ref.embeddings)
