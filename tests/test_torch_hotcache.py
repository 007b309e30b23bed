"""The port's device hot-row cache against the JAX package's.

* slot-table mechanics (admission, degree weighting, eviction, invalidation,
  write-back admission, prewarm, LFU decay) and the plan-time residency
  split, call for call the same as the reference's ``HotRowCache``;
* the hub_burst smoke cell (n = 256, 6 batches, features 8, one layer,
  ``CacheConfig(capacity_rows=256)``): hits/misses/evictions 580/504/0
  (``benchmarks/check_regression.CACHE_EXPECTED['smoke']``, which the
  reference's own tests pin), staged bytes 61,648 against 107,968 uncached
  (1.75×), cached ≡ uncached bitwise;
* cached ≡ uncached bitwise over 20-batch gcn and gat streams in both staging
  modes, with counters independent of the mode;
* engine-level prewarm and decay counters equal to the reference engine's;
* coherence: across a policy-forced full recompute, a refresh, and serving
  reads pinned at every retained version;
* ``EngineConfig`` cache resolution (a fresh cache per engine, on the
  config's device).

Streams are copies of tests/test_hotcache.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks.check_regression import CACHE_EXPECTED  # noqa: E402
from repro.core.affected import split_residency as j_split_residency  # noqa: E402
from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.graph import make_graph as j_make_graph  # noqa: E402
from repro.graph import make_stream as j_make_stream  # noqa: E402
from repro.serve import CacheConfig as JCacheConfig  # noqa: E402
from repro.serve import HotRowCache as JHotRowCache  # noqa: E402
from repro.serve.api import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.api import create_engine as j_create_engine  # noqa: E402
from repro_torch.core.affected import split_residency  # noqa: E402
from repro_torch.core.models import make_model  # noqa: E402
from repro_torch.core.params import params_from_numpy  # noqa: E402
from repro_torch.graph import (  # noqa: E402
    make_adversarial_stream,
    make_graph,
    make_stream,
    random_features,
)
from repro_torch.serve import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    HotRowCache,
    StagingConfig,
    create_engine,
)


def _mk_stream(make_graph, make_stream, n=120, num_batches=20, seed=5):
    g = make_graph("powerlaw", n, avg_degree=5, seed=seed, weighted=True)
    x, _ = random_features(n, 8, seed=seed)
    wl = make_stream(g, num_batches=num_batches, batch_edges=8, delete_frac=0.35,
                     seed=seed + 1, feature_dim=8, feature_frac=0.02)
    return x, wl


def _params_np(name, dims=(8, 8)):
    jp = j_make_model(name).init_layers(jax.random.PRNGKey(0), list(dims))
    return [{k: np.asarray(v) for k, v in p.items()} for p in jp]


def _engine(backend, name, graph, x, params_np, **kw):
    model = make_model(name)
    return create_engine(backend, EngineConfig(
        model=model, graph=graph, x=x, params=params_from_numpy(model, params_np, device="cpu"),
        device="cpu", **kw))


def _counters(d: dict):
    return d["cache_hit_rows"], d["cache_miss_rows"], d["cache_evictions"]


def _same_state(u, v) -> bool:
    return all(np.array_equal(p, q)
               for kind in ("h", "a", "nct") for p, q in zip(getattr(u, kind), getattr(v, kind)))


# ---------------------------------------------------------------------- #
# slot-table mechanics, against the reference's HotRowCache call for call
# ---------------------------------------------------------------------- #
def test_cache_config_validation():
    for bad, match in ((dict(capacity_rows=0), "capacity_rows"), (dict(admission="lru"), "admission"),
                       (dict(prewarm_rows=-1), "prewarm_rows"), (dict(decay=1.0), "decay"),
                       (dict(decay=-0.1), "decay")):
        with pytest.raises(ValueError, match=match):
            CacheConfig(**bad)
    cfg = CacheConfig()
    assert (cfg.enabled, cfg.capacity_rows, cfg.prewarm_rows, cfg.decay) == (True, 256, 0, 0.0)


def _replay(cache, calls):
    """Run one script of slot-table calls; returns every result as numpy."""
    out = []
    for op, args in calls:
        res = getattr(cache, op)(*args)
        if op == "plan_reads":
            out.append([res.hit_pos, res.hit_slots, res.miss_pos, res.miss_rows,
                        res.admit_midx, res.admit_slots])
        elif op == "plan_writeback":
            out.append(list(res))
    st = cache.stats
    out.append([st.hit_rows, st.miss_rows, st.evictions, st.admitted_rows, st.invalidated_rows])
    return out


_SCRIPTS = {
    "fill_then_evict_strictly_hotter": (dict(capacity_rows=2), [
        ("plan_reads", (("h", 0), 10, np.array([1, 2, 3]), np.zeros(3))),
        ("plan_reads", (("h", 0), 10, np.array([3]), np.zeros(1))),
        ("plan_reads", (("h", 0), 10, np.array([1, 2, 3]), np.zeros(3), None, False)),
    ]),
    "degree_weighted": (dict(capacity_rows=1, admission="freq_degree"), [
        ("plan_reads", (("h", 0), 10, np.array([2, 7]), np.array([1.0, 50.0]))),
        ("plan_reads", (("h", 0), 10, np.array([2, 7]), np.array([1.0, 50.0]), None, False)),
    ]),
    "pure_frequency": (dict(capacity_rows=1, admission="freq"), [
        ("plan_reads", (("h", 0), 10, np.array([2, 7]), np.array([1.0, 50.0]))),
    ]),
    "invalidate_keeps_free_list_deterministic": (dict(capacity_rows=4), [
        ("plan_reads", (("s", 1), 16, np.arange(4), np.zeros(4))),
        ("invalidate", (("s", 1), np.array([1, 3]))),
        ("plan_reads", (("s", 1), 16, np.arange(4), np.zeros(4), None, False)),
        ("plan_reads", (("s", 1), 16, np.array([8, 9]), np.zeros(2))),
        ("invalidate_all", ()),
    ]),
    "writeback_admits": (dict(capacity_rows=8), [
        ("plan_writeback", (("h", 1), 32, np.array([4, 9]), np.zeros(2))),
        ("plan_reads", (("h", 1), 32, np.array([4, 9]), np.zeros(2), None, False)),
    ]),
    "exclusion": (dict(capacity_rows=8), [
        ("plan_reads", (("h", 0), 16, np.array([2, 5, 7]), np.ones(3))),
        ("plan_reads", (("h", 0), 16, np.array([2, 3, 5, 7]), np.ones(4), np.array([5]))),
    ]),
    "lfu_decay": (dict(capacity_rows=1, decay=0.5), [
        ("plan_reads", (("h", 0), 16, np.array([5]), np.zeros(1))),
        ("plan_reads", (("h", 0), 16, np.array([5]), np.zeros(1))),
        ("decay_tick", ()), ("decay_tick", ()), ("decay_tick", ()),
        ("plan_reads", (("h", 0), 16, np.array([9]), np.zeros(1))),
    ]),
    "no_decay_pins_the_hub": (dict(capacity_rows=1), [
        ("plan_reads", (("h", 0), 16, np.array([5]), np.zeros(1))),
        ("plan_reads", (("h", 0), 16, np.array([5]), np.zeros(1))),
        ("decay_tick", ()),
        ("plan_reads", (("h", 0), 16, np.array([9]), np.zeros(1))),
    ]),
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_slot_table_matches_reference(script):
    cfg, calls = _SCRIPTS[script]
    ours = _replay(HotRowCache(CacheConfig(**cfg), device="cpu"), calls)
    ref = _replay(JHotRowCache(JCacheConfig(**cfg)), calls)
    for u, v in zip(ours, ref):
        for a, b in zip(u, v):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prewarm_fills_stores_and_serves_hits():
    cache = HotRowCache(CacheConfig(capacity_rows=4, prewarm_rows=4), device="cpu")
    key, n = ("h", 0), 32
    top = np.array([7, 3, 11, 20], np.int64)
    vals = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
    cache.prewarm(key, n, top, np.array([9.0, 8.0, 7.0, 6.0]), {"h": vals})
    assert cache.stats.admitted_rows == 4 and cache.stats.hit_rows == 0
    sp = cache.plan_reads(key, n, np.array([3, 7, 19]), np.zeros(3))
    np.testing.assert_array_equal(sp.miss_rows, [19])
    st = cache.store(key, "h", (8,))
    assert st.device.type == "cpu" and st.dtype == torch.float32
    slot_of = cache._spaces[key].slot_of
    assert np.array_equal(st[int(slot_of[7])].numpy(), vals[0])
    assert np.array_equal(st[int(slot_of[20])].numpy(), vals[3])
    assert cache.state_bytes() == 4 * 8 * 4


def test_update_store_writes_in_place_by_index():
    cache = HotRowCache(CacheConfig(capacity_rows=4), device="cpu")
    cache.plan_reads(("s", 0), 8, np.arange(4), np.zeros(4))
    st = cache.store(("s", 0), "a", (2,))
    cache.update_store(("s", 0), "a", torch.tensor([2, 0], dtype=torch.int32),
                       torch.tensor([[1.0, 2.0], [3.0, 4.0]]))
    assert cache.store(("s", 0), "a", (2,)) is st  # the same tensor, written in place
    assert st.tolist() == [[3.0, 4.0], [0.0, 0.0], [1.0, 2.0], [0.0, 0.0]]


def test_split_residency_matches_reference():
    slot_of = np.full(10, -1, np.int32)
    slot_of[[2, 5, 7]] = [0, 1, 2]
    rows = np.array([2, 3, 5, 7, 9], np.int64)
    for excl in (None, np.array([5], np.int64)):
        ours, ref = split_residency(rows, slot_of, excl), j_split_residency(rows, slot_of, excl)
        for f in ("hit_pos", "hit_slots", "miss_pos", "miss_rows"):
            np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))


# ---------------------------------------------------------------------- #
# the hub_burst smoke cell: the reference's exact counters
# ---------------------------------------------------------------------- #
def test_hub_burst_counters_and_staged_bytes():
    wl = make_adversarial_stream("hub_burst", num_batches=6)
    x, _ = random_features(wl.base.n, 8, seed=0)
    params = _params_np("gcn")
    runs = {}
    for cached in (False, True):
        eng = _engine("offload", "gcn", wl.base, x, params,
                      cache=CacheConfig(capacity_rows=256) if cached else None)
        runs[cached] = (eng, eng.apply_stream(wl.batches).as_dict())
    (base, d0), (hot, d1) = runs[False], runs[True]
    exp = CACHE_EXPECTED["smoke"]
    assert _counters(d1) == (exp["hit_rows"], exp["miss_rows"], exp["evictions"]) == (580, 504, 0)
    assert (d0["staged_bytes"], d1["staged_bytes"]) == (107_968, 61_648)  # 1.75×
    assert _same_state(base, hot)


# ---------------------------------------------------------------------- #
# cached ≡ uncached, bitwise
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["gcn", "gat"])
@pytest.mark.parametrize("async_staging", [False, True])
def test_cached_bitwise_equals_uncached_20_batches(name, async_staging):
    x, wl = _mk_stream(make_graph, make_stream)
    params = _params_np(name)
    runs = {}
    for cached in (False, True):
        eng = _engine("offload", name, wl.base, x, params,
                      staging=StagingConfig(async_enabled=async_staging),
                      cache=CacheConfig(capacity_rows=64) if cached else None)
        runs[cached] = (eng, eng.apply_stream(wl.batches).as_dict())
    (base, d0), (hot, d1) = runs[False], runs[True]
    assert _same_state(base, hot)
    assert _counters(d0) == (0, 0, 0) and d1["cache_hit_rows"] > 0
    assert d1["staged_bytes"] < d0["staged_bytes"]
    snap = hot._backend.cache_snapshot()
    assert (snap.hit_rows, snap.evictions) == (d1["cache_hit_rows"], d1["cache_evictions"])


def test_cache_counters_deterministic_across_async_modes():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=12)
    counts = []
    for async_staging in (False, True):
        eng = _engine("offload", "gcn", wl.base, x, _params_np("gcn"),
                      staging=StagingConfig(async_enabled=async_staging),
                      cache=CacheConfig(capacity_rows=64))
        d = eng.apply_stream(wl.batches).as_dict()
        counts.append(_counters(d) + (d["staged_bytes"],))
    assert counts[0] == counts[1]
    assert counts[0][2] > 0  # capacity 64 on this stream must evict


@pytest.mark.parametrize("cfg", [dict(capacity_rows=64, prewarm_rows=48),
                                 dict(capacity_rows=32, decay=0.5)],
                         ids=["prewarm", "decay"])
def test_prewarm_and_decay_counters_equal_reference(cfg):
    """Engine-level residency is a function of the plans only: the port's
    counters equal the reference engine's, and the cache stays invisible to
    the math (bitwise equal to the uncached port engine)."""
    x, wl = _mk_stream(make_graph, make_stream, num_batches=4)
    _, jwl = _mk_stream(j_make_graph, j_make_stream, num_batches=4)
    jmodel = j_make_model("gcn")
    jparams = jmodel.init_layers(jax.random.PRNGKey(0), [8, 8])
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    ref = j_create_engine("offload", JEngineConfig(model=jmodel, graph=jwl.base, x=x,
                                                   params=jparams, cache=JCacheConfig(**cfg)))
    d_ref = ref.apply_stream(jwl.batches).as_dict()
    eng = _engine("offload", "gcn", wl.base, x, params, cache=CacheConfig(**cfg))
    d = eng.apply_stream(wl.batches).as_dict()
    assert _counters(d) == _counters(d_ref) and d["staged_bytes"] == d_ref["staged_bytes"]
    ours, theirs = eng._backend.cache_snapshot(), ref._backend.cache_snapshot()
    assert (ours.admitted_rows, ours.invalidated_rows) == (theirs.admitted_rows,
                                                           theirs.invalidated_rows)
    cold = _engine("offload", "gcn", wl.base, x, params)
    cold.apply_stream(wl.batches)
    assert _same_state(cold, eng)


def test_prewarm_turns_early_misses_into_hits():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=10)
    runs = {}
    for pw in (0, 48):
        eng = _engine("offload", "gcn", wl.base, x, _params_np("gcn"),
                      cache=CacheConfig(capacity_rows=64, prewarm_rows=pw))
        runs[pw] = (eng, eng.apply_stream(wl.batches).as_dict())
    (cold, d0), (warm, d1) = runs[0], runs[48]
    assert _same_state(cold, warm)
    assert d1["cache_hit_rows"] > d0["cache_hit_rows"]
    assert d1["cache_miss_rows"] < d0["cache_miss_rows"]


# ---------------------------------------------------------------------- #
# coherence: policy full recompute, refresh, pinned serving reads
# ---------------------------------------------------------------------- #
def test_cache_coherent_across_policy_full_recompute():
    """hub_burst's adaptive schedule interleaves full-recompute batches
    (which rewrite the host state → invalidate_all) with incremental ones:
    cached vs uncached stays bitwise through the mode changes."""
    wl = make_adversarial_stream("hub_burst", num_batches=6)
    x, _ = random_features(wl.base.n, 8, seed=0)
    params = _params_np("gcn")
    runs = {}
    for cached in (False, True):
        eng = _engine("offload", "gcn", wl.base, x, params, policy="adaptive",
                      cache=CacheConfig(capacity_rows=256) if cached else None)
        runs[cached] = (eng, eng.apply_stream(wl.batches).as_dict())
    (base, d0), (hot, d1) = runs[False], runs[True]
    assert d1["policy_full_batches"] == d0["policy_full_batches"] == 2  # as the reference's
    assert d1["policy_incremental_batches"] == 4
    assert _same_state(base, hot)
    assert hot._backend.cache_snapshot().invalidated_rows > 0


def test_refresh_invalidates_cache_and_stays_bitwise():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=10)
    runs = {}
    for cached in (False, True):
        eng = _engine("offload", "gcn", wl.base, x, _params_np("gcn"), refresh_every=4,
                      cache=CacheConfig(capacity_rows=64) if cached else None)
        for b in wl.batches:
            eng.apply_batch(b)
        runs[cached] = eng
    assert _same_state(runs[False], runs[True])
    assert runs[True]._backend.cache_snapshot().invalidated_rows > 0


def test_snapshot_reads_at_retained_versions_with_cache():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=8)
    rows = np.arange(0, wl.base.n, 7)
    reads = {}
    for cached in (False, True):
        eng = _engine("offload", "gcn", wl.base, x, _params_np("gcn"),
                      cache=CacheConfig(capacity_rows=64) if cached else None)
        fe = eng.serving_frontend(max_versions=len(wl.batches) + 1)
        for b in wl.batches:
            fe.apply_batch(b)
        reads[cached] = [np.array(fe.read(rows, version=v)) for v in range(fe.version + 1)]
    assert len(reads[True]) == len(wl.batches) + 1
    for ru, rc in zip(reads[False], reads[True]):
        assert np.array_equal(ru, rc)


# ---------------------------------------------------------------------- #
# EngineConfig cache resolution
# ---------------------------------------------------------------------- #
def test_engine_config_cache_resolution():
    x, wl = _mk_stream(make_graph, make_stream, num_batches=1)
    params = _params_np("gcn")
    for cache in (None, CacheConfig(enabled=False)):
        eng = _engine("offload", "gcn", wl.base, x, params, cache=cache)
        assert eng._backend._cache is None and eng._backend.cache_snapshot() is None
    a = _engine("offload", "gcn", wl.base, x, params, cache=CacheConfig(capacity_rows=32))
    b = _engine("offload", "gcn", wl.base, x, params, cache=CacheConfig(capacity_rows=32))
    assert a._backend._cache is not b._backend._cache  # slot state is engine state
    assert a._backend._cache.capacity == 32 and a._backend._cache.device.type == "cpu"
    dev = _engine("device", "gcn", wl.base, x, params, cache=CacheConfig(capacity_rows=32))
    assert dev._backend.cache_snapshot() is None  # ignored without host staging
