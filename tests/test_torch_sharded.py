"""The port's row-sharded substrates against the JAX package's planners and
engines, and their own bitwise invariants.

* the host planners — ``shard_plan`` (single pass and reference fill, psum
  and ppermute schedules) and ``hybrid_plan`` (with the device-served patch
  tables) — equal to the reference's array for array on the same
  ``BatchPlan`` inputs at S ∈ {1, 3, 4, 8}; the reference's own plan checks,
  ported: every row covered exactly once, the halo is frontier sources
  only, single pass ≡ reference fill, exactly-once halo deliveries;
* bitwise (``torch.equal`` / ``np.array_equal``): sharded ≡ device engine
  for gcn at S ∈ {1, 3, 8} (widths 8 and 128), hybrid ≡ offload engine for
  gcn and gat, psum ≡ ppermute (sharded, hybrid, and under batch-window
  fusion), cached ≡ uncached and async ≡ sync on the hybrid, and a
  ``DistExchange`` over 3 gloo processes ≡ the loopback exchange;
* the reference's pinned counters (benchmarks/check_regression.py): the
  fig7 sharded cell's ``halo_rows_sent`` 157 and psum ceiling 584, the
  hybrid's 731 transfer rows per shard / 470,016 staged bytes / 5 prefetch
  hits, the hub_burst hybrid cache's 616/532/0;
* gat within the reference's 2e-4 of ``full_forward`` on a stream where no
  destination drains, and both sharded engines within 1e-5 of the
  reference's single-device engine on its exported weights (the
  reference's own sharded engines need S jax devices; this run has one).
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import affected as jaff  # noqa: E402
from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.graph import make_graph as j_make_graph  # noqa: E402
from repro.graph import make_stream as j_make_stream  # noqa: E402
from repro.serve.api import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.api import create_engine as j_create_engine  # noqa: E402
from repro_torch.core import affected as taff  # noqa: E402
from repro_torch.core import full_forward, make_model  # noqa: E402
from repro_torch.core.params import params_from_numpy  # noqa: E402
from repro_torch.dist import CommsConfig, rotation_perm  # noqa: E402
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
    StagingConfig,
    create_engine,
)

TOL = 2e-4  # the reference's tests/test_backends.py tolerance vs full recompute
TOL_REF = 1e-5  # port vs the reference's engine
SEED = 2  # a stream on which no destination drains (tests/test_torch_engine.py)
SHARDS = (1, 3, 4, 8)


def _mk_stream(make_graph, make_stream, n=150, num_batches=6, seed=SEED, batch_edges=8,
               delete_frac=0.35, feature_dim=8):
    g = make_graph("powerlaw", n, avg_degree=5, seed=seed, weighted=True)
    x, _ = random_features(n, 8, seed=seed)
    kw = dict(feature_dim=feature_dim, feature_frac=0.02) if feature_dim else {}
    wl = make_stream(g, num_batches=num_batches, batch_edges=batch_edges,
                     delete_frac=delete_frac, seed=seed + 1, **kw)
    return x, wl


def _plans(aff, model, wl, num_layers=2):
    """The Alg.-4 plan of every batch of ``wl``, each against its own
    predecessor graph."""
    g, out = wl.base, []
    for b in wl.batches:
        g_new = g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst, b.ins_weights,
                                b.ins_etypes)
        out.append((aff.build_plan(model, g, g_new, b, num_layers), b))
        g = g_new
    return out


def _both_plans(name, **kw):
    """The port's and the reference's plans of the same stream."""
    _, wl = _mk_stream(make_graph, make_stream, **kw)
    _, jwl = _mk_stream(j_make_graph, j_make_stream, **kw)
    return (_plans(taff, make_model(name), wl), _plans(jaff, j_make_model(name), jwl))


def _params_np(name, dims=(8, 8, 8)):
    jp = j_make_model(name).init_layers(jax.random.PRNGKey(0), list(dims))
    return [{k: np.asarray(v) for k, v in p.items()} for p in jp]


def _engine(backend, name, wl, x, params_np, **kw):
    model = make_model(name)
    return create_engine(backend, EngineConfig(
        model=model, graph=wl.base, x=x, params=params_from_numpy(model, params_np, device="cpu"),
        device="cpu", **kw))


def _state(eng) -> list:
    return [np.asarray(v) for kind in ("h", "a", "nct") for v in getattr(eng, kind)]


def _same_state(u, v) -> bool:
    return all(np.array_equal(p, q) for p, q in zip(_state(u), _state(v)))


# ---------------------------------------------------------------------- #
# host planners vs the reference's, array for array
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("S", SHARDS)
def test_shard_plan_matches_reference(S):
    """Same BatchPlan in, same stacked and replicated buffers, halo
    schedules and counters out (psum and ppermute, hysteresis held over the
    stream on both sides)."""
    for name in ("gcn", "gat"):
        ours, theirs = _both_plans(name)
        for mode in ("psum", "ppermute"):
            hwm, jhwm = taff.BucketHysteresis(), jaff.BucketHysteresis()
            for (plan, b), (jplan, _) in zip(ours, theirs):
                sp = taff.shard_plan(plan, S, b.feat_vertices, b.feat_values, hwm=hwm,
                                     halo_mode=mode)
                jp = jaff.shard_plan(jplan, S, b.feat_vertices, b.feat_values, hwm=jhwm,
                                     halo_mode=mode)
                for f in ("n", "n_shards", "rows_per", "feat_cap", "caps", "halo_mode",
                          "pair_caps"):
                    assert getattr(sp.layout, f) == getattr(jp.layout, f), f
                for f in ("idx_sh", "flt_sh", "msk_sh", "idx_rep", "msk_rep",
                          "out_rows_final"):
                    np.testing.assert_array_equal(getattr(sp, f), getattr(jp, f), err_msg=f)
                if jp.feat_vals is not None:
                    np.testing.assert_array_equal(sp.feat_vals, jp.feat_vals)
                assert (sp.n_halo_rows, sp.comms_rows) == (jp.n_halo_rows, jp.comms_rows)
                for ours_l, theirs_l in zip(sp.comms_sh or (), jp.comms_sh or ()):
                    for u, v in zip(ours_l, theirs_l):
                        np.testing.assert_array_equal(u, v)
                assert (sp.comms_sh is None) == (jp.comms_sh is None)


@pytest.mark.parametrize("S", SHARDS)
def test_hybrid_plan_matches_reference(S):
    """Same BatchPlan in, same per-shard compact tables, halo counts and
    device-served patch tables out."""
    for name in ("gcn", "gat"):
        ours, theirs = _both_plans(name)
        for mode in ("psum", "ppermute"):
            hwm, jhwm = taff.BucketHysteresis(), jaff.BucketHysteresis()
            for (plan, b), (jplan, _) in zip(ours, theirs):
                hp = taff.hybrid_plan(plan, S, hwm=hwm, feat_vertices=b.feat_vertices,
                                      halo_mode=mode)
                jhp = jaff.hybrid_plan(jplan, S, hwm=jhwm, feat_vertices=b.feat_vertices,
                                       halo_mode=mode)
                for tr, jtr in zip(hp.layers, jhp.layers):
                    assert tr.layout.caps == jtr.layout.caps
                    for f in ("need_h", "need_mask", "srows", "srows_mask", "idx_sh", "flt_sh",
                              "msk_sh"):
                        np.testing.assert_array_equal(getattr(tr, f), getattr(jtr, f),
                                                      err_msg=f)
                    assert tr.n_halo_remote == jtr.n_halo_remote
                    for f in ("patch_pos", "patch_src"):
                        u, v = getattr(tr, f), getattr(jtr, f)
                        assert (u is None) == (v is None)
                        if u is not None:
                            np.testing.assert_array_equal(u, v, err_msg=f)


def test_shard_row_schedules_follow_the_packed_keys():
    """Each shard's row schedules are ``prepare_row_schedule`` of its own
    live ``e_rowidx`` / ``f_rowidx`` keys, the keys ``pack_plan`` uses."""
    (plan, b), = _both_plans("gat", num_batches=1)[0]
    sp = taff.shard_plan(plan, 3, b.feat_vertices, b.feat_values)
    idx_sl, _, msk_sl, _, _ = taff.sharded_layout_slices(sp.layout)
    s_sl, _ = taff.sched_slices(sp.layout)
    for s in range(3):
        for l, caps in enumerate(sp.layout.caps):
            for kind, rowidx, mask, cap in (("e", "e_rowidx", "e_mask", caps[1]),
                                            ("f", "f_rowidx", "f_emask", caps[2])):
                keys = np.where(sp.msk_sh[s, msk_sl[l][mask]], sp.idx_sh[s, idx_sl[l][rowidx]],
                                -1)
                order, row_ptr = taff.prepare_row_schedule(keys, cap)
                np.testing.assert_array_equal(sp.sched_sh[s, s_sl[l][f"{kind}_order"]], order)
                np.testing.assert_array_equal(sp.sched_sh[s, s_sl[l][f"{kind}_row_ptr"]],
                                              row_ptr)


def test_comms_config_and_shard_count_are_checked():
    """``CommsConfig`` validates as the reference's; ``"auto"`` resolves to
    ppermute only with more than one shard; the shard count is checked."""
    from repro.dist.sharding import CommsConfig as JCommsConfig
    from repro_torch.dist import LoopbackExchange, stream_shards

    for bad in ({"halo": "allgather"}, {"pair_capacity_hysteresis": -0.5}):
        with pytest.raises(ValueError, match="CommsConfig"):
            CommsConfig(**bad)
        with pytest.raises(ValueError, match="CommsConfig"):
            JCommsConfig(**bad)
    for halo in ("psum", "ppermute", "auto"):
        for S in (1, 3):
            assert CommsConfig(halo=halo).resolve_halo(S) == JCommsConfig(halo=halo).resolve_halo(S)
    assert rotation_perm(4, 3) == [(0, 3), (1, 0), (2, 1), (3, 2)]
    assert stream_shards() == 1 and stream_shards(8) == 8
    assert stream_shards(exchange=LoopbackExchange(3)) == 3
    with pytest.raises(ValueError, match="num_shards"):
        stream_shards(0)
    with pytest.raises(ValueError, match="exchange runs 3"):
        stream_shards(4, LoopbackExchange(3))


# ---------------------------------------------------------------------- #
# the reference's plan checks (tests/test_sharded_engine.py, test_comms.py)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name,n_shards", [("gcn", 4), ("gat", 4), ("gat", 8)])
def test_shard_plan_covers_every_row_exactly_once(name, n_shards):
    """The union over shards of the live rows in the stacked buffers is the
    global plan's live set, with no overlap, and the record counts are the
    global plan's (each record follows its destination's owner)."""
    (plan, _), = _plans(taff, make_model(name), _mk_stream(make_graph, make_stream, seed=5,
                                                           num_batches=1)[1])
    sp = taff.shard_plan(plan, n_shards)
    rows_per = sp.layout.rows_per
    assert rows_per == taff.shard_rows(150, n_shards)
    idx_sl, _, msk_sl, _, _ = taff.sharded_layout_slices(sp.layout)
    for l, lp in enumerate(plan.layers):
        for field, mask_name in (("touch_rows", "touch_mask"), ("f_rows", "f_mask"),
                                 ("out_rows", "out_mask")):
            seen = []
            for s in range(n_shards):
                rows_l = sp.idx_sh[s, idx_sl[l][field]]
                live = sp.msk_sh[s, msk_sl[l][mask_name]]
                assert np.all(rows_l[live] < rows_per)
                seen.extend((rows_l[live].astype(np.int64) + s * rows_per).tolist())
            assert len(seen) == len(set(seen)), f"{field}: row appears twice"
            assert set(seen) == set(getattr(lp, field)[getattr(lp, mask_name)].tolist())
        for mask_name, glob in (("e_mask", lp.e_mask), ("f_emask", lp.f_emask)):
            assert sum(int(sp.msk_sh[s, msk_sl[l][mask_name]].sum())
                       for s in range(n_shards)) == int(glob.sum())


def test_shard_plan_halo_is_frontier_sources_only():
    """The replicated halo list holds only live source rows; one shard owns
    everything, so it exchanges nothing."""
    (plan, _), = _plans(taff, make_model("gat"), _mk_stream(make_graph, make_stream, seed=6,
                                                            num_batches=1)[1])
    sp = taff.shard_plan(plan, 4)
    _, _, _, halo_sl, _ = taff.sharded_layout_slices(sp.layout)
    for l, lp in enumerate(plan.layers):
        halo = sp.idx_rep[halo_sl[l]]
        halo = halo[halo >= 0].astype(np.int64)
        live_srcs = set(lp.e_src[lp.e_mask].tolist()) | set(lp.f_src[lp.f_emask].tolist())
        assert set(halo.tolist()) <= live_srcs
    assert sp.n_halo_rows == sum(int((sp.idx_rep[halo_sl[l]] >= 0).sum()) for l in range(2))
    assert taff.shard_plan(plan, 1).n_halo_rows == 0


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_shard_plan_single_pass_equals_reference_fill(name):
    _, wl = _mk_stream(make_graph, make_stream, seed=21, num_batches=4)
    for plan, b in _plans(taff, make_model(name), wl):
        for S in SHARDS:
            fast = taff.shard_plan(plan, S, b.feat_vertices, b.feat_values, single_pass=True)
            ref = taff.shard_plan(plan, S, b.feat_vertices, b.feat_values, single_pass=False)
            assert fast.layout == ref.layout
            for f in ("idx_sh", "flt_sh", "msk_sh", "idx_rep", "msk_rep", "sched_sh"):
                np.testing.assert_array_equal(getattr(fast, f), getattr(ref, f), err_msg=f)
            assert fast.n_halo_rows == ref.n_halo_rows


@pytest.mark.parametrize("S", SHARDS)
def test_ppermute_schedules_deliver_exactly_once(S):
    """Every remote source row a consumer shard's records reference arrives
    exactly once per (layer, consumer), from its owner, in the right halo
    slot, and never at a shard that does not gather it (delete-heavy
    stream)."""
    model = make_model("gcn")
    _, wl = _mk_stream(make_graph, make_stream, seed=3, delete_frac=0.5, feature_dim=None)
    for plan, _ in _plans(taff, model, wl):
        sp = taff.shard_plan(plan, S, halo_mode="ppermute")
        lay = sp.layout
        rows_per = lay.rows_per
        assert lay.halo_mode == "ppermute" and len(sp.comms_sh) == len(plan.layers)
        for l, lp in enumerate(plan.layers):
            es = lp.e_src[lp.e_mask].astype(np.int64)
            cons_e = lp.e_dst[lp.e_mask].astype(np.int64) // rows_per
            src, cons = es[es // rows_per != cons_e], cons_e[es // rows_per != cons_e]
            need = [set(src[cons == c].tolist()) for c in range(S)]
            halo_list = np.unique(src)
            halo_cap = lay.caps[l][5]
            send_pos, recv_pos = sp.comms_sh[l]
            delivered = [set() for _ in range(S)]
            total = 0
            for k in range(1, S):
                for o, c in rotation_perm(S, k):
                    sl, rl = send_pos[o, k - 1], recv_pos[c, k - 1]
                    pad = sl == rows_per
                    assert np.array_equal(pad, rl == halo_cap)
                    for r, hp in zip((o * rows_per + sl[~pad].astype(np.int64)).tolist(),
                                     rl[~pad].tolist()):
                        assert r // rows_per == o and r in need[c] and halo_list[hp] == r
                        assert r not in delivered[c], "duplicate delivery"
                        delivered[c].add(r)
                        total += 1
            assert delivered == need
            assert sp.comms_rows[l] == total <= halo_list.shape[0] * S


# ---------------------------------------------------------------------- #
# engines: bitwise invariants inside the port
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("S,width", [(1, 8), (3, 8), (8, 8), (3, 128)])
def test_sharded_matches_device_engine_bitwise(S, width):
    """gcn: every h, a and nct bitwise the device engine's, through
    ``apply_batch`` and ``apply_stream``, in both halo modes."""
    x, wl = _mk_stream(make_graph, make_stream, num_batches=6)
    dims = (8, width, width)
    params = _params_np("gcn", dims)
    dev = _engine("device", "gcn", wl, x, params)
    for b in wl.batches:
        dev.apply_batch(b)
    for mode in ("psum", "ppermute"):
        sh = _engine("sharded", "gcn", wl, x, params, num_shards=S,
                     comms=CommsConfig(halo=mode))
        if mode == "psum":
            for b in wl.batches:
                sh.apply_batch(b)
        else:
            sh.apply_stream(wl.batches)
        assert sh.S == S and (S == 1 or sh.halo_rows_total > 0)
        assert _same_state(sh, dev), (S, mode)


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_hybrid_matches_offload_engine_bitwise(name):
    """The hybrid ≡ the offload engine, every tensor bitwise, at S = 3 and 8
    in both halo modes; async ≡ sync staging."""
    x, wl = _mk_stream(make_graph, make_stream, num_batches=5)
    params = _params_np(name)
    off = _engine("offload", name, wl, x, params)
    off.apply_stream(wl.batches)
    for S, mode, staging in ((3, "ppermute", None), (8, "psum", None),
                             (8, "ppermute", StagingConfig(async_enabled=False))):
        hy = _engine("sharded_offload", name, wl, x, params, num_shards=S,
                     comms=CommsConfig(halo=mode), staging=staging)
        ss = hy.apply_stream(wl.batches)
        assert _same_state(hy, off), (S, mode)
        assert ss.prefetch_hits == (len(wl.batches) - 1 if staging is None else 0)


def test_psum_equals_ppermute_under_fusion():
    """The reference's ring cell (12 region-disjoint batches, window 4): 3
    windows / 12 fused batches on both sharded engines, each bitwise its
    serial loop and psum ≡ ppermute."""
    n = 600
    idx = np.arange(n, dtype=np.int64)
    g = CSRGraph.from_edges(n, np.concatenate([(idx + 1) % n, (idx + 2) % n]),
                            np.concatenate([idx, idx]))
    rng = np.random.default_rng(0)
    batches = [UpdateBatch(ins_src=np.array([(i * 45 + 1) % n]),
                           ins_dst=np.array([(i * 45 + 5) % n]),
                           del_src=np.array([], np.int64), del_dst=np.array([], np.int64),
                           feat_vertices=np.array([(i * 45 + 7) % n]),
                           feat_values=rng.standard_normal((1, 8)).astype(np.float32))
               for i in range(12)]
    x = rng.standard_normal((n, 8)).astype(np.float32)

    class _WL:
        base = g

    params = _params_np("gcn")
    for backend in ("sharded", "sharded_offload"):
        runs = {}
        for mode in ("psum", "ppermute"):
            for fused in (False, True):
                eng = _engine(backend, "gcn", _WL, x, params, num_shards=4,
                              comms=CommsConfig(halo=mode),
                              fusion=FusionConfig(window=4) if fused else None)
                runs[mode, fused] = (eng, eng.apply_stream(batches))
        ss = runs["ppermute", True][1]
        assert (ss.fusion_windows, ss.fused_batches, ss.fusion_fallbacks) == (3, 12, 0)
        base = runs["psum", False][0]
        for key, (eng, _) in runs.items():
            assert _same_state(eng, base), (backend, key)


def test_hybrid_cache_counters_and_cached_equals_uncached():
    """The reference's hub_burst cell at S = 8 (n = 256, features 8,
    ``CacheConfig(capacity_rows=256)``): hits/misses/evictions 616/532/0
    (``CACHE_EXPECTED['sharded']``), cached ≡ uncached bitwise, fewer staged
    bytes."""
    wl = make_adversarial_stream("hub_burst", num_batches=6)
    x, _ = random_features(wl.base.n, 8, seed=0)
    params = _params_np("gcn", (8, 8))
    runs = {}
    for cached in (False, True):
        eng = _engine("sharded_offload", "gcn", wl, x, params, num_shards=8,
                      cache=CacheConfig(capacity_rows=256) if cached else None)
        runs[cached] = (eng, eng.apply_stream(wl.batches))
    (u, ss_u), (c, ss_c) = runs[False], runs[True]
    assert (ss_c.cache_hit_rows, ss_c.cache_miss_rows, ss_c.cache_evictions) == (616, 532, 0)
    assert ss_c.staged_bytes < ss_u.staged_bytes
    assert _same_state(u, c)


def test_fig7_sharded_cell_counters():
    """The reference's fig7 sharded smoke cell (powerlaw n = 300, features
    16, one layer, 6 batches of 8 edges, S = 8): ppermute delivers 157 halo
    rows against the psum ceiling of 584 (``COMMS_EXPECTED``), bitwise
    equal; the hybrid moves at most 731 rows a shard, and its pipelined run
    stages 470,016 bytes with 5 prefetch hits."""
    g = make_graph("powerlaw", 300, avg_degree=4.0, seed=0, weighted=True)
    x, _ = random_features(300, 16, seed=0)
    wl = make_stream(g, num_batches=6, batch_edges=8, delete_frac=0.3, seed=1)
    params = _params_np("gcn", (16, 16))
    runs = {}
    for mode in ("psum", "ppermute"):
        eng = _engine("sharded", "gcn", wl, x, params, num_shards=8, comms=CommsConfig(halo=mode))
        runs[mode] = (eng, eng.apply_stream(wl.batches))
    assert runs["ppermute"][1].comms_halo_rows_sent == 157
    assert runs["psum"][1].comms_halo_rows_sent == 584
    assert _same_state(runs["psum"][0], runs["ppermute"][0])
    hy = _engine("sharded_offload", "gcn", wl, x, params, num_shards=8)
    for b in wl.batches:
        hy.apply_batch(b)
    assert int(hy.per_shard_rows.max()) == 731
    pipe = _engine("sharded_offload", "gcn", wl, x, params, num_shards=8)
    ss = pipe.apply_stream(wl.batches)
    assert (ss.staged_bytes, ss.prefetch_hits) == (470_016, 5)
    assert _same_state(hy, pipe) and _same_state(hy, runs["psum"][0])


# ---------------------------------------------------------------------- #
# against full recomputation and the reference's engine
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_sharded_engines_match_reference_engine(name):
    """Both sharded engines at S = 3 within 1e-5 of the reference's
    single-device engine on its exported weights after every batch, and
    within 2e-4 of the port's ``full_forward`` at the end."""
    x, wl = _mk_stream(make_graph, make_stream, num_batches=8)
    _, jwl = _mk_stream(j_make_graph, j_make_stream, num_batches=8)
    jmodel = j_make_model(name)
    jparams = jmodel.init_layers(jax.random.PRNGKey(0), [8, 8, 8])
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    ref = j_create_engine("device", JEngineConfig(model=jmodel, graph=jwl.base, x=x,
                                                  params=jparams))
    engs = [_engine("sharded", name, wl, x, params, num_shards=3),
            _engine("sharded_offload", name, wl, x, params, num_shards=3)]
    for b, jb in zip(wl.batches, jwl.batches):
        ref.apply_batch(jb)
        want = np.asarray(ref.embeddings)
        for eng in engs:
            eng.apply_batch(b)
            np.testing.assert_allclose(np.asarray(eng.embeddings), want, atol=TOL_REF, rtol=0)
    xf = np.array(x)
    for b in wl.batches:
        if b.feat_vertices is not None:
            xf[b.feat_vertices] = b.feat_values
    full = full_forward(engs[0].model, engs[0].params, torch.from_numpy(xf), engs[0].graph)
    for eng in engs:
        assert float(np.abs(np.asarray(eng.embeddings) - full[-1].h.numpy()).max()) < TOL


def test_sharded_policy_refresh_and_serving():
    """A forced incremental/chunked/full schedule and a refresh cadence run
    through the sharded substrates' policy primitives bitwise like the
    device engine's; versioned reads on the sharded engine equal its
    snapshots."""
    from repro_torch.core import ExecutionPolicy

    x, wl = _mk_stream(make_graph, make_stream, num_batches=6)
    params = _params_np("gcn")
    schedule = ("incremental", "chunked", "full", "incremental", "chunked", "incremental")
    kw = dict(policy=ExecutionPolicy(force_mode=schedule), refresh_every=4)
    dev = _engine("device", "gcn", wl, x, params, **kw)
    dev.apply_stream(wl.batches)
    for backend in ("sharded", "sharded_offload"):
        eng = _engine(backend, "gcn", wl, x, params, num_shards=3,
                      policy=ExecutionPolicy(force_mode=schedule), refresh_every=4)
        eng.apply_stream(wl.batches)
        assert _same_state(eng, dev), backend
    eng = _engine("sharded", "gcn", wl, x, params, num_shards=3)
    fr = eng.serving_frontend(max_pending_reads=8, max_versions=len(wl.batches) + 1)
    rows = np.arange(0, wl.base.n, 7)
    snaps = [eng.snapshot_rows(rows)]
    for b in wl.batches:
        fr.apply_batch(b)
        snaps.append(eng.snapshot_rows(rows))
    for v in range(fr.version + 1):
        np.testing.assert_array_equal(fr.read(rows, version=v), snaps[v])


# ---------------------------------------------------------------------- #
# DistExchange: one shard per torch.distributed process (gloo)
# ---------------------------------------------------------------------- #
def _gloo_worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.dist import DistExchange

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        x, wl = _mk_stream(make_graph, make_stream, num_batches=4)
        model = make_model("gcn")
        params = model.init_layers(torch.Generator().manual_seed(0), [8, 8, 8], device="cpu")
        out = {}
        for mode in ("psum", "ppermute"):
            eng = create_engine("sharded", EngineConfig(
                model=model, graph=wl.base, x=x, params=params, device="cpu",
                comms=CommsConfig(halo=mode), exchange=DistExchange()))
            eng.apply_stream(wl.batches)
            for i, v in enumerate(_state(eng)):
                out[f"{mode}_{i}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_dist_exchange_over_gloo_equals_loopback():
    """3 gloo processes, one shard each (``DistExchange``), bitwise the
    loopback exchange's 3 logical shards in one process, in both halo
    modes; every rank assembles the same full state."""
    import torch.multiprocessing as mp

    world = 3
    x, wl = _mk_stream(make_graph, make_stream, num_batches=4)
    model = make_model("gcn")
    params = model.init_layers(torch.Generator().manual_seed(0), [8, 8, 8], device="cpu")
    want = {}
    for mode in ("psum", "ppermute"):
        eng = create_engine("sharded", EngineConfig(
            model=model, graph=wl.base, x=x, params=params, device="cpu", num_shards=world,
            comms=CommsConfig(halo=mode)))
        eng.apply_stream(wl.batches)
        want[mode] = _state(eng)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_gloo_worker, args=(world, os.path.join(tmp, "store"), tmp), nprocs=world,
                 join=True)
        for rank in range(world):
            got = np.load(os.path.join(tmp, f"rank{rank}.npz"))
            for mode, vals in want.items():
                for i, v in enumerate(vals):
                    np.testing.assert_array_equal(got[f"{mode}_{i}"], v)
