"""The port's baselines, ODEC, Theorem-1 certifier and §V-B recompute
storage against the JAX package's.

* ``RTECFull`` / ``RTECUER`` for sage, gcn and gat: within 2e-4 of the
  port's ``full_forward`` (the reference's own tolerance) and within 1e-5
  of the reference's baselines;
* ``RTECSample`` draws from ``np.random.default_rng(seed)`` in the
  reference's call order: its embeddings equal the reference's at 1e-5;
* ``MTECPeriod`` stays stale, then refreshes;
* ``edges_processed`` of every baseline and the engine equal the
  reference's counts exactly, and order Inc < UER ≤ Full;
* ``odec_query`` against the committed engine and the JAX ``odec_query``
  at 1e-5, leaving every persistent tensor of the engine bitwise unchanged;
* ``certify`` / ``validate_registration``: the booleans equal the
  reference's for all 11 models (the random draws differ: a seeded
  ``torch.Generator`` replaces ``jax.random``, so ``max_err`` is not
  compared), and the gate rejects an undeclared destination dependence and
  a non-distributive ``ms_cbn``;
* ``store_h=False`` ≡ ``store_h=True`` within 2e-4, with the ``h`` share of
  ``state_bytes`` gone.

The streams are those of tests/test_baselines.py; gat meets the
incremental engine only on streams where no destination drains (ROADMAP
Queue 3), which ``_assert_no_draining_destination`` checks.
"""
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import ALL_MODELS as J_ALL_MODELS  # noqa: E402
from repro.core import RTECUER as JRTECUER  # noqa: E402
from repro.core import MTECPeriod as JMTECPeriod  # noqa: E402
from repro.core import RTECFull as JRTECFull  # noqa: E402
from repro.core import RTECSample as JRTECSample  # noqa: E402
from repro.core import certify as j_certify  # noqa: E402
from repro.core import odec_query as j_odec_query  # noqa: E402
from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.graph import make_graph as j_make_graph  # noqa: E402
from repro.graph import make_stream as j_make_stream  # noqa: E402
from repro.serve.api import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.api import create_engine as j_create_engine  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ALL_MODELS,
    RTECUER,
    ExecutionPolicy,
    MTECPeriod,
    RTECFull,
    RTECSample,
    certify,
    full_forward,
    make_model,
    odec_query,
    params_from_numpy,
    validate_registration,
)
from repro_torch.core.operators import GNNModel  # noqa: E402
from repro_torch.graph import make_graph, make_stream, random_features  # noqa: E402
from repro_torch.serve import EngineConfig, create_engine  # noqa: E402

TOL = 2e-4  # the reference's tests/test_baselines.py tolerance vs full recompute
TOL_REF = 1e-5  # port vs reference, same inputs


def _mk(name, make=make_model):
    return make(name, **({"num_relations": 3} if name in ("rgcn", "rgat") else {}))


def _setup(make_graph, make_stream, n=120, num_batches=3, seed=0):
    g = make_graph("powerlaw", n, avg_degree=6, seed=seed)
    x, _ = random_features(n, 8, seed=seed)
    wl = make_stream(g, num_batches=num_batches, batch_edges=10, delete_frac=0.3, seed=seed + 1)
    return x, wl


def _params(name, seed=0, dims=(8, 8, 8)):
    """The reference's weights, and the same as port tensors."""
    jp = j_make_model(name).init_layers(jax.random.PRNGKey(seed), list(dims))
    params_np = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return jp, params_from_numpy(make_model(name), params_np, device="cpu"), params_np


def _final_graph(wl):
    g = wl.base
    for b in wl.batches:
        g = g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst, b.ins_weights,
                            b.ins_etypes)
    return g


def _assert_no_draining_destination(wl):
    g = wl.base
    for b in wl.batches:
        g2 = g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst, b.ins_weights,
                             b.ins_etypes)
        assert not np.any((g.in_degree() > 0) & (g2.in_degree() == 0))
        g = g2


@pytest.mark.parametrize("cls,jcls", [(RTECFull, JRTECFull), (RTECUER, JRTECUER)])
@pytest.mark.parametrize("name", ["sage", "gcn", "gat"])
def test_exact_baselines_match_full_forward_and_reference(cls, jcls, name):
    x, wl = _setup(make_graph, make_stream)
    _, jwl = _setup(j_make_graph, j_make_stream)
    jp, p, _ = _params(name)
    bl = cls(make_model(name), p, wl.base, torch.from_numpy(x))
    ref = jcls(j_make_model(name), jp, jwl.base, jnp.asarray(x))
    for b, jb in zip(wl.batches, jwl.batches, strict=True):
        bs, jbs = bl.apply_batch(b), ref.apply_batch(jb)
        assert (bs.edges_processed, bs.out_vertices) == (jbs.edges_processed, jbs.out_vertices)
        np.testing.assert_allclose(bl.embeddings.numpy(), np.asarray(ref.embeddings),
                                   atol=TOL_REF, rtol=TOL_REF)
    own = full_forward(bl.model, p, torch.from_numpy(x), _final_graph(wl))[-1].h
    assert float((bl.embeddings - own).abs().max()) < TOL


@pytest.mark.parametrize("name", ["sage", "gcn"])
def test_sampling_draws_the_reference_samples(name):
    x, wl = _setup(make_graph, make_stream)
    _, jwl = _setup(j_make_graph, j_make_stream)
    jp, p, _ = _params(name)
    bl = RTECSample(make_model(name), p, wl.base, torch.from_numpy(x), fanout=2, seed=0)
    ref = JRTECSample(j_make_model(name), jp, jwl.base, jnp.asarray(x), fanout=2, seed=0)
    for b, jb in zip(wl.batches, jwl.batches, strict=True):
        assert bl.apply_batch(b).edges_processed == ref.apply_batch(jb).edges_processed
        np.testing.assert_allclose(bl.embeddings.numpy(), np.asarray(ref.embeddings),
                                   atol=TOL_REF, rtol=TOL_REF)
    own = full_forward(bl.model, p, torch.from_numpy(x), _final_graph(wl))[-1].h
    err = float((bl.embeddings - own).abs().max())
    assert np.isfinite(err) and err > 1e-6  # approximate, visibly so at fanout 2


def test_mtec_period_stale_then_fresh():
    x, wl = _setup(make_graph, make_stream, num_batches=4)
    _, jwl = _setup(j_make_graph, j_make_stream, num_batches=4)
    jp, p, _ = _params("sage")
    bl = MTECPeriod(make_model("sage"), p, wl.base, torch.from_numpy(x), period=4)
    ref = JMTECPeriod(j_make_model("sage"), jp, jwl.base, jnp.asarray(x), period=4)
    emb0 = bl.embeddings.clone()
    for b, jb in zip(wl.batches[:3], jwl.batches[:3]):
        assert bl.apply_batch(b).edges_processed == ref.apply_batch(jb).edges_processed == 0
        torch.testing.assert_close(bl.embeddings, emb0, atol=1e-6, rtol=0)
    assert bl.apply_batch(wl.batches[3]).edges_processed == \
        ref.apply_batch(jwl.batches[3]).edges_processed > 0
    own = full_forward(bl.model, p, torch.from_numpy(x), _final_graph(wl))[-1].h
    assert float((bl.embeddings - own).abs().max()) < TOL
    np.testing.assert_allclose(bl.embeddings.numpy(), np.asarray(ref.embeddings),
                               atol=TOL_REF, rtol=TOL_REF)


def test_edges_processed_order_and_equal_the_reference():
    """Paper Figs. 2/8: Inc < UER <= Full, with the reference's counts."""
    x, wl = _setup(make_graph, make_stream, n=300, seed=3)
    _, jwl = _setup(j_make_graph, j_make_stream, n=300, seed=3)
    jp, p, params_np = _params("sage", seed=3)
    model, jmodel = make_model("sage"), j_make_model("sage")
    inc = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=p,
                                               device="cpu"))
    jinc = j_create_engine("device", JEngineConfig(model=jmodel, graph=jwl.base, x=x, params=jp))
    mine = [inc, RTECUER(model, p, wl.base, torch.from_numpy(x)),
            RTECFull(model, p, wl.base, torch.from_numpy(x))]
    refs = [jinc, JRTECUER(jmodel, jp, jwl.base, jnp.asarray(x)),
            JRTECFull(jmodel, jp, jwl.base, jnp.asarray(x))]
    e_mine, e_ref = [0, 0, 0], [0, 0, 0]
    for b, jb in zip(wl.batches, jwl.batches):
        for i in range(3):
            e_mine[i] += mine[i].apply_batch(b).edges_processed
            e_ref[i] += refs[i].apply_batch(jb).edges_processed
    assert e_mine == e_ref
    assert e_mine[0] < e_mine[1] <= e_mine[2]


def _state(eng):
    return [t.clone() for t in (*eng.h, *eng.a, *eng.nct) if t is not None]


@pytest.mark.parametrize("name,n,seed,query", [
    ("gcn", 150, 5, [3, 17, 42, 99]),
    ("gat", 150, 5, [3, 17, 42, 99]),
    ("sage", 100, 6, list(range(100))),  # all vertices: ODEC reduces to RTEC
])
@pytest.mark.parametrize("store_h", [True, False])
def test_odec_matches_committed_engine_and_reference(name, n, seed, query, store_h):
    x, wl = _setup(make_graph, make_stream, n=n, num_batches=1, seed=seed)
    _, jwl = _setup(j_make_graph, j_make_stream, n=n, num_batches=1, seed=seed)
    if name == "gat":
        _assert_no_draining_destination(wl)
    jp, p, _ = _params(name, seed=seed)
    eng = create_engine("device", EngineConfig(model=make_model(name), graph=wl.base, x=x,
                                               params=p, device="cpu", store_h=store_h))
    jeng = j_create_engine("device", JEngineConfig(model=j_make_model(name), graph=jwl.base,
                                                   x=x, params=jp, store_h=store_h))
    q = np.array(query, np.int64)
    before = _state(eng)
    emb_q, stats = odec_query(eng, wl.batches[0], q)
    for u, v in zip(before, _state(eng), strict=True):
        assert torch.equal(u, v)  # the query committed nothing
    j_emb, j_stats = j_odec_query(jeng, jwl.batches[0], q)
    assert (stats.inc_edges, stats.full_edges, stats.out_vertices) == (
        j_stats.inc_edges, j_stats.full_edges, j_stats.out_vertices)
    np.testing.assert_allclose(emb_q.numpy(), np.asarray(j_emb), atol=TOL_REF, rtol=TOL_REF)
    eng.apply_batch(wl.batches[0])
    torch.testing.assert_close(emb_q, eng.embeddings[torch.from_numpy(q)], atol=TOL_REF,
                               rtol=0)
    assert stats.edges_processed <= eng.graph.num_edges


@pytest.mark.parametrize("name", ALL_MODELS)
def test_certify_verdicts_equal_the_reference(name):
    assert set(ALL_MODELS) == set(J_ALL_MODELS)
    rep, jrep = certify(_mk(name), device="cpu"), j_certify(_mk(name, j_make_model))
    for field in ("distributive", "invertible", "aggregate_assoc", "dest_independent",
                  "struct_independent"):
        assert getattr(rep, field) == getattr(jrep, field), field
    assert rep.incrementalizable == jrep.incrementalizable
    assert set(rep.max_err) == set(jrep.max_err)
    assert validate_registration(_mk(name), device="cpu").incrementalizable


def test_certify_probes_on_the_card_by_default():
    assert inspect.signature(certify).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):  # no card: it does not fall back
            certify(_mk("gcn"))


class _BadMean(GNNModel):
    """Non-distributive ms_cbn (a running mean) — must fail Theorem 1."""

    name = "badmean"

    def init_params(self, gen, d_in, d_out):
        return {"W": torch.eye(d_in, d_out)}

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        return torch.ones_like(s_u)

    def edge_term(self, p, mlc, z, et):
        return mlc[:, None] * z

    def ms_cbn(self, p, nct, x):
        return torch.sqrt(x.abs() + 1.0)

    def ms_cbn_inv(self, p, nct, x):
        return x**2 - 1.0

    def update(self, p, h_v, a_v):
        return a_v @ p["W"]


class _UndeclaredGAT(GNNModel):
    """Destination-dependent message without the dest_dependent flag."""

    name = "undeclared"

    def init_params(self, gen, d_in, d_out):
        return {"W": torch.eye(d_in, d_out)}

    def ms_local(self, p, h_u, h_v, s_u, s_v, ew, et):
        return (h_u * h_v).sum(-1)

    def edge_term(self, p, mlc, z, et):
        return mlc[:, None] * z

    def update(self, p, h_v, a_v):
        return a_v @ p["W"]


def test_registration_gate_rejects_contradicted_flags():
    with pytest.raises(ValueError, match="fails Theorem-1"):
        validate_registration(_BadMean(), device="cpu")
    with pytest.raises(ValueError, match="destination-dependent"):
        validate_registration(_UndeclaredGAT(), device="cpu")
    rep = certify(_UndeclaredGAT(), device="cpu")
    assert rep.incrementalizable and not rep.dest_independent


@pytest.mark.parametrize("name", ["gcn", "sage"])
def test_store_h_false_matches_store_h_true(name):
    """§V-B recompute storage: same embeddings within 2e-4, a third less
    state for dims [8, 8, 8] (h[1..2] dropped, x, a and nct kept)."""
    x, wl = _setup(make_graph, make_stream, n=100, num_batches=5, seed=11)
    _, p, _ = _params(name, seed=2)
    engines = {s: create_engine("device", EngineConfig(model=make_model(name), graph=wl.base,
                                                       x=x, params=p, device="cpu", store_h=s))
               for s in (True, False)}
    assert engines[False].h[1] is None and engines[False].store_h is False
    for b in wl.batches:
        for e in engines.values():
            e.apply_batch(b)
        assert float((engines[True].embeddings - engines[False].embeddings).abs().max()) < TOL
    for l in range(2):
        assert float((engines[True].a[l] - engines[False].a[l]).abs().max()) < TOL
    assert engines[False].h[1] is None  # dropped again after every step
    rows = np.arange(0, 100, 7)
    np.testing.assert_allclose(engines[False].snapshot_rows(rows),
                               engines[True].snapshot_rows(rows), atol=TOL, rtol=0)
    h_share = 2 * 100 * 8 * 4  # h[1], h[2]: [100, 8] float32
    assert engines[True].state_bytes() - engines[False].state_bytes() == h_share
    ref = full_forward(engines[False].model, p, torch.from_numpy(x), _final_graph(wl))[-1].h
    assert float((engines[False].embeddings - ref).abs().max()) < TOL


def test_store_h_false_under_every_policy_mode():
    """The chunked and full modes read and write state through the policy
    primitives, which rebuild h where ``store_h=False`` dropped it."""
    x, wl = _setup(make_graph, make_stream, n=100, num_batches=5, seed=11)
    _, p, _ = _params("gcn", seed=2)
    schedule = ("incremental", "chunked", "full", "chunked", "incremental")
    emb = {}
    for s in (True, False):
        e = create_engine("device", EngineConfig(
            model=make_model("gcn"), graph=wl.base, x=x, params=p, device="cpu", store_h=s,
            policy=ExecutionPolicy(force_mode=schedule)))
        modes = [b.mode for b in e.apply_stream(wl.batches).batches]
        assert tuple(modes) == schedule
        emb[s] = e.embeddings
    assert float((emb[True] - emb[False]).abs().max()) < TOL


def test_new_modules_are_inside_the_import_guard():
    """tests/test_torch_engine.py::test_port_imports_neither_jax_nor_repro
    imports every module ``pkgutil`` finds under repro_torch with jax and
    repro blocked; this slice's modules must be among them."""
    import repro_torch

    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.core.policy", "repro_torch.core.conditions",
            "repro_torch.core.baselines", "repro_torch.core.odec",
            "repro_torch.serve.frontend", "repro_torch.serve.scheduler"} <= mods
