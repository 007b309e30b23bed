"""The port's adaptive execution policy against the JAX package's.

* ``estimate_plan_cost`` on the same plans equals the reference's, field
  for field;
* per adversarial regime, the adaptive decision counts and
  ``policy_edges`` equal a JAX run's (and ``BENCH_baseline.json``'s rows);
* inside the port: adaptive ≡ the forced replay of its own decisions,
  bitwise (``torch.equal``);
* port engine ≡ JAX engine per batch at 1e-5 under ``policy="adaptive"``,
  and every mode within 2e-4 of the port's ``full_forward``;
* hysteresis damps feature_churn's flapping schedule and follows
  delete_heavy's genuine shifts, as in the reference;
* policy-chosen full-recompute batches reset the serving front-end's undo
  log; chunked batches keep it bitwise.

The regimes run at the reference's own size (n = 256, 6 batches, features
8, one layer: dims [8, 8]); the reference's weights cross over as numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.affected import build_plan as j_build_plan  # noqa: E402
from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.core.policy import estimate_plan_cost as j_estimate_plan_cost  # noqa: E402
from repro.graph import make_adversarial_stream as j_make_adversarial_stream  # noqa: E402
from repro.serve.api import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.api import create_engine as j_create_engine  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MODES,
    ExecutionPolicy,
    estimate_plan_cost,
    full_forward,
    make_model,
    make_policy,
    params_from_numpy,
)
from repro_torch.core.affected import build_plan  # noqa: E402
from repro_torch.graph import (  # noqa: E402
    ADVERSARIAL_REGIMES,
    make_adversarial_stream,
    random_features,
)
from repro_torch.serve import EngineConfig, StaleVersionError, create_engine  # noqa: E402

TOL = 2e-4  # the reference's tolerance vs full recompute
TOL_BATCH = 1e-5  # port vs reference engine, per batch
#: BENCH_baseline.json rows adversarial/<regime>/policy_*: (inc, chunked, full, edges)
EXPECTED = {"hub_burst": (4, 0, 2, 3168), "delete_heavy": (3, 0, 3, 1608),
            "feature_churn": (3, 3, 0, 4524)}


def _setup(regime, seed=0):
    wl = make_adversarial_stream(regime, seed=seed)
    x, _ = random_features(wl.base.n, 8, seed=seed)
    jparams = j_make_model("gcn").init_layers(jax.random.PRNGKey(0), [8, 8])
    params_np = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    return wl, x, params_np


def _engine(wl, x, params_np, **kw):
    model = make_model("gcn")
    return create_engine("device", EngineConfig(
        model=model, graph=wl.base, x=x, device="cpu",
        params=params_from_numpy(model, params_np, device="cpu"), **kw))


def _graphs_along(wl):
    g = wl.base
    for b in wl.batches:
        g_new = g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst,
                                b.ins_weights, b.ins_etypes)
        yield g, g_new, b
        g = g_new


def _final(wl, x):
    g, xf = wl.base, np.array(x)
    for b in wl.batches:
        g = g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst,
                            b.ins_weights, b.ins_etypes)
        if b.feat_vertices is not None:
            xf[b.feat_vertices] = b.feat_values
    return g, xf


def _counts(ss):
    d = ss.as_dict()
    return tuple(d[f"policy_{m}_batches"] for m in MODES) + (d["policy_edges"],)


def test_adversarial_streams_equal_the_reference():
    for regime in ADVERSARIAL_REGIMES:
        a = make_adversarial_stream(regime, seed=3)
        b = j_make_adversarial_stream(regime, seed=3)
        np.testing.assert_array_equal(a.base.in_indptr, b.base.in_indptr)
        np.testing.assert_array_equal(a.base.in_indices, b.base.in_indices)
        for ba, bb in zip(a.batches, b.batches, strict=True):
            for f in ("ins_src", "ins_dst", "del_src", "del_dst", "feat_vertices",
                      "feat_values"):
                va, vb = getattr(ba, f), getattr(bb, f)
                assert (va is None) == (vb is None)
                if va is not None:
                    np.testing.assert_array_equal(va, vb)
    with pytest.raises(ValueError, match="unknown adversarial regime"):
        make_adversarial_stream("calm")
    with pytest.raises(ValueError, match="n >= 64"):
        make_adversarial_stream("hub_burst", n=32)


@pytest.mark.parametrize("regime", ADVERSARIAL_REGIMES)
def test_estimate_plan_cost_equals_reference(regime):
    wl = make_adversarial_stream(regime)
    jwl = j_make_adversarial_stream(regime)
    model, jmodel = make_model("gcn"), j_make_model("gcn")
    for (g0, g1, b), (jg0, jg1, jb) in zip(_graphs_along(wl), _graphs_along(jwl), strict=True):
        for L in (1, 2):
            est = estimate_plan_cost(build_plan(model, g0, g1, b, L), row_bytes=1548)
            ref = j_estimate_plan_cost(j_build_plan(jmodel, jg0, jg1, jb, L), row_bytes=1548)
            assert est.as_dict() == ref.as_dict()
            for mode in MODES:
                assert est.staged_bytes(mode) == ref.staged_bytes(mode)


@pytest.mark.parametrize("regime", ADVERSARIAL_REGIMES)
def test_decision_counts_equal_reference_and_port_matches_jax_per_batch(regime):
    """Adaptive decisions, policy_edges and per-batch embeddings of the
    port's engine against the JAX device engine on the same stream."""
    wl, x, params_np = _setup(regime)
    jwl = j_make_adversarial_stream(regime)
    jmodel = j_make_model("gcn")
    ref = j_create_engine("device", JEngineConfig(
        model=jmodel, graph=jwl.base, x=x, params=[dict(p) for p in params_np],
        policy="adaptive"))
    eng = _engine(wl, x, params_np, policy="adaptive")
    for i, (b, jb) in enumerate(zip(wl.batches, jwl.batches, strict=True)):
        bs, jbs = eng.apply_batch(b), ref.apply_batch(jb)
        assert (bs.mode, bs.est_edges, bs.inc_edges, bs.full_edges, bs.out_vertices) == (
            jbs.mode, jbs.est_edges, jbs.inc_edges, jbs.full_edges, jbs.out_vertices), i
        assert bs.est_cost == pytest.approx(jbs.est_cost)
        np.testing.assert_allclose(eng.embeddings.numpy(), np.asarray(ref.embeddings),
                                   atol=TOL_BATCH, rtol=TOL_BATCH, err_msg=f"batch {i}")
    modes = [d.mode for d in eng._orch.policy.history]
    assert modes == [d.mode for d in ref._orch.policy.history]
    counts = tuple(modes.count(m) for m in MODES)
    edges = sum(d.est_edges for d in eng._orch.policy.history)
    assert counts + (edges,) == EXPECTED[regime]


@pytest.mark.parametrize("regime", ADVERSARIAL_REGIMES)
def test_adaptive_equals_forced_replay_bitwise(regime):
    wl, x, params_np = _setup(regime)
    adaptive = _engine(wl, x, params_np, policy="adaptive")
    ss = adaptive.apply_stream(wl.batches)
    assert _counts(ss) == EXPECTED[regime]
    schedule = tuple(d.mode for d in adaptive._orch.policy.history)
    assert len(set(schedule)) > 1  # a mixed schedule, or the test is vacuous
    forced = _engine(wl, x, params_np, policy=ExecutionPolicy(force_mode=schedule))
    forced.apply_stream(wl.batches)
    assert all(d.forced for d in forced._orch.policy.history)
    assert torch.equal(adaptive.embeddings, forced.embeddings)
    for l in range(2):
        assert torch.equal(adaptive.h[l], forced.h[l])
    assert torch.equal(adaptive.a[0], forced.a[0])
    assert torch.equal(adaptive.nct[0], forced.nct[0])


@pytest.mark.parametrize("spec", ["incremental", "chunked", "full", "adaptive"])
def test_every_mode_matches_full_forward(spec):
    """Each execution shape over the mixed hub_burst stream lands within the
    reference's tolerance of a from-scratch recompute; forced incremental is
    bitwise the no-policy path."""
    wl, x, params_np = _setup("hub_burst")
    eng = _engine(wl, x, params_np, policy=spec)
    eng.apply_stream(wl.batches)
    g, xf = _final(wl, x)
    ref = full_forward(eng.model, eng.params, torch.from_numpy(xf), g)[-1].h
    assert float((eng.embeddings - ref).abs().max()) < TOL
    if spec == "incremental":
        plain = _engine(wl, x, params_np)
        plain.apply_stream(wl.batches)
        assert torch.equal(plain.embeddings, eng.embeddings)


def test_chunked_scheduler_runs_on_the_engine_device_and_counts():
    wl, x, params_np = _setup("feature_churn")
    eng = _engine(wl, x, params_np, policy="chunked")
    eng.apply_stream(wl.batches)
    sched = eng._orch._chunk_sched
    assert sched.device == eng.device
    assert sched.stats.chunks >= len(wl.batches)
    assert sched.stats.edges_processed > 0


def _adaptive_modes(regime, hysteresis):
    wl, x, params_np = _setup(regime)
    eng = _engine(wl, x, params_np, policy="adaptive", policy_hysteresis=hysteresis)
    eng.apply_stream(wl.batches)
    return [d.mode for d in eng._orch.policy.history], eng.embeddings


def _flips(modes):
    return sum(a != b for a, b in zip(modes, modes[1:]))


def test_hysteresis_damps_flapping_and_follows_genuine_shifts():
    modes0, emb0 = _adaptive_modes("feature_churn", 0.0)
    assert _flips(modes0) == 5
    modes_h, emb_h = _adaptive_modes("feature_churn", 0.15)
    assert _flips(modes_h) == 0 and set(modes_h) == {"incremental"}
    torch.testing.assert_close(emb_h, emb0, atol=5e-6, rtol=0)
    dh0, _ = _adaptive_modes("delete_heavy", 0.0)
    dh, _ = _adaptive_modes("delete_heavy", 0.3)
    assert dh == dh0 and _flips(dh) == 5


def test_policy_knobs_validation_and_threading():
    with pytest.raises(ValueError, match="hysteresis"):
        ExecutionPolicy(hysteresis=1.0)
    with pytest.raises(ValueError, match="unknown execution mode"):
        make_policy("sideways")
    with pytest.raises(ValueError, match="calibrate_blend"):
        ExecutionPolicy(calibrate=True, calibrate_blend=1.5)
    assert make_policy(None) is None
    pol = ExecutionPolicy()
    assert make_policy(pol) is pol
    assert make_policy("incremental", calibrate=True).calibrate is False
    wl, x, params_np = _setup("hub_burst")
    eng = _engine(wl, x, params_np, policy="adaptive", policy_hysteresis=0.3,
                  policy_calibrate=True, policy_chunked_weight=1.25)
    p = eng._orch.policy
    assert (p.hysteresis, p.calibrate, p.weights["chunked"]) == (0.3, True, 1.25)
    eng.apply_stream(wl.batches)
    assert any(v is not None for v in p._ema.values())  # measured times fed back
    sched = ExecutionPolicy(force_mode=["incremental"])
    g0, g1, b = next(_graphs_along(wl))
    sched.decide(build_plan(make_model("gcn"), g0, g1, b, 1))
    with pytest.raises(ValueError, match="exhausted"):
        sched.decide(build_plan(make_model("gcn"), g0, g1, b, 1))


def test_no_policy_keeps_policy_counters_at_zero():
    wl, x, params_np = _setup("hub_burst")
    d = _engine(wl, x, params_np).apply_stream(wl.batches).as_dict()
    assert d["policy_incremental_batches"] == len(wl.batches)
    assert (d["policy_chunked_batches"], d["policy_full_batches"], d["policy_edges"],
            d["policy_cost"]) == (0, 0, 0, 0.0)


def test_frontend_resets_undo_log_on_policy_full_recompute():
    """hub_burst makes the policy pick full recompute: the frontend's floor
    jumps to that version; later versions stay bitwise-readable."""
    wl, x, params_np = _setup("hub_burst")
    eng = _engine(wl, x, params_np, policy="adaptive")
    fe = eng.serving_frontend(max_versions=8)
    rows = np.arange(0, wl.base.n, 7)
    snaps = {0: eng.snapshot_rows(rows)}
    full_versions = []
    for v, b in enumerate(wl.batches, start=1):
        bs = fe.apply_batch(b)
        snaps[v] = eng.snapshot_rows(rows)
        if bs.mode == "full":
            full_versions.append(v)
            assert fe.min_version == v
    assert full_versions
    last = full_versions[-1]
    for stale in range(last):
        with pytest.raises(StaleVersionError):
            fe.read(rows, version=stale)
    for v in range(last, fe.version + 1):
        np.testing.assert_array_equal(fe.read(rows, version=v), snaps[v])
    assert fe.reads_served == fe.version + 1 - last


def test_frontend_reads_stay_bitwise_across_chunked_batches():
    wl, x, params_np = _setup("feature_churn")
    eng = _engine(wl, x, params_np, policy="adaptive")
    fe = eng.serving_frontend(max_versions=len(wl.batches) + 1)
    rows = np.arange(0, wl.base.n, 3)
    snaps = {0: eng.snapshot_rows(rows)}
    modes = set()
    for v, b in enumerate(wl.batches, start=1):
        modes.add(fe.apply_batch(b).mode)
        snaps[v] = eng.snapshot_rows(rows)
    assert modes == {"incremental", "chunked"}
    assert fe.min_version == 0
    for v in range(fe.version + 1):
        np.testing.assert_array_equal(fe.read(rows, version=v), snaps[v])
