"""The port's single-device engine against the JAX package's, and its own
bitwise invariants.

* port ``create_engine("device", …)`` vs the reference's device engine with
  the Pallas delta scatter (``CommsConfig(use_pallas_delta=True)``, interpret
  mode on the CPU), batch by batch at 1e-5, and against full recomputation
  at the reference's ``TOL = 2e-4`` after a 20-batch gcn and gat stream;
* inside the port: fused ≡ unfused and ``apply_stream`` ≡ ``apply_batch``,
  bitwise (``torch.equal``);
* ``StreamStats.as_dict()`` keys equal the reference's;
* the port and ``chip_smoke.py`` import neither ``jax`` nor ``repro``.

The stream helpers are copies of tests/test_backends.py's.  Its gat stream
(seed 3) has a destination whose last in-edge is deleted at batch 17; the
reference's attention sum then drains to a float residue instead of 0 (a
known reference-side drift, ROADMAP Queue 3).  The port sums in another
order, so gat is compared only on a stream where no destination drains
(``SEED``), which ``test_stream_has_no_draining_destination`` asserts.
"""
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.backend import STREAM_STAT_KEYS as J_STREAM_STAT_KEYS  # noqa: E402
from repro.core.full import full_forward as j_full_forward  # noqa: E402
from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.dist.sharding import CommsConfig  # noqa: E402
from repro.graph import make_graph as j_make_graph  # noqa: E402
from repro.graph import make_stream as j_make_stream  # noqa: E402
from repro.serve.api import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.api import create_engine as j_create_engine  # noqa: E402
from repro_torch.core.backend import STREAM_STAT_KEYS  # noqa: E402
from repro_torch.core.full import full_forward  # noqa: E402
from repro_torch.core.models import make_model  # noqa: E402
from repro_torch.core.params import params_from_numpy  # noqa: E402
from repro_torch.graph import make_graph, make_stream, random_features  # noqa: E402
from repro_torch.serve import BACKENDS, PORTED_BACKENDS, EngineConfig, create_engine  # noqa: E402

TOL = 2e-4  # the reference's tests/test_backends.py tolerance vs full recompute
TOL_BATCH = 1e-5  # port vs reference engine, per batch
SEED = 2  # a stream on which no destination drains (see module docstring)
ROOT = Path(__file__).resolve().parents[1]


def _mk_stream(make_graph, make_stream, n=150, num_batches=20, seed=0, feature_dim=8,
               batch_edges=8):
    g = make_graph("powerlaw", n, avg_degree=5, seed=seed, weighted=True)
    x, _ = random_features(n, 8, seed=seed)
    wl = make_stream(g, num_batches=num_batches, batch_edges=batch_edges,
                     delete_frac=0.35, seed=seed + 1,
                     feature_dim=feature_dim, feature_frac=0.02)
    return x, wl


def _final_features(x, wl):
    x_cur = np.array(x)
    for b in wl.batches:
        if b.feat_vertices is not None:
            x_cur[b.feat_vertices] = b.feat_values
    return x_cur


def _final_reference(model, params, x, wl):
    """From-scratch recomputation over the post-stream snapshot/features."""
    g_cur = wl.base
    for b in wl.batches:
        g_cur = g_cur.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst,
                                    b.ins_weights, b.ins_etypes)
    return np.asarray(j_full_forward(model, params, jnp.asarray(_final_features(x, wl)),
                                     g_cur)[-1].h)


def _port_engine(name, wl, x, params_np, **kw):
    model = make_model(name)
    return create_engine("device", EngineConfig(
        model=model, graph=wl.base, x=x,
        params=params_from_numpy(model, params_np, device="cpu"), device="cpu", **kw))


def _emb(eng):
    return eng.embeddings.numpy()


def test_stream_has_no_draining_destination():
    _, wl = _mk_stream(make_graph, make_stream, seed=SEED)
    g = wl.base
    for b in wl.batches:
        g2 = g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst,
                             b.ins_weights, b.ins_etypes)
        assert not np.any((g.in_degree() > 0) & (g2.in_degree() == 0))
        g = g2


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_port_engine_matches_reference_engine_20_batches(name):
    x, wl = _mk_stream(make_graph, make_stream, seed=SEED)
    _, jwl = _mk_stream(j_make_graph, j_make_stream, seed=SEED)
    jmodel = j_make_model(name)
    jparams = jmodel.init_layers(jax.random.PRNGKey(0), [8, 8, 8])
    params_np = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    ref_eng = j_create_engine("device", JEngineConfig(
        model=jmodel, graph=jwl.base, x=x, params=jparams,
        comms=CommsConfig(use_pallas_delta=True)))
    eng = _port_engine(name, wl, x, params_np)
    np.testing.assert_allclose(_emb(eng), np.asarray(ref_eng.embeddings), atol=TOL_BATCH,
                               rtol=TOL_BATCH)
    for i, (b, jb) in enumerate(zip(wl.batches, jwl.batches)):
        eng.apply_batch(b)
        ref_eng.apply_batch(jb)
        np.testing.assert_allclose(_emb(eng), np.asarray(ref_eng.embeddings),
                                   atol=TOL_BATCH, rtol=TOL_BATCH, err_msg=f"batch {i}")
    ref = _final_reference(jmodel, jparams, x, jwl)
    assert float(np.abs(_emb(eng) - ref).max()) < TOL
    own = full_forward(eng.model, eng.params, torch.from_numpy(_final_features(x, wl)),
                       eng.graph)[-1].h.numpy()
    assert float(np.abs(_emb(eng) - own).max()) < TOL


def _params_np(name, dims=(8, 8, 8)):
    jparams = j_make_model(name).init_layers(jax.random.PRNGKey(0), list(dims))
    return [{k: np.asarray(v) for k, v in p.items()} for p in jparams]


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_fused_equals_unfused_bitwise(name):
    x, wl = _mk_stream(make_graph, make_stream, seed=3)
    params = _params_np(name)
    fused = _port_engine(name, wl, x, params)
    unfused = _port_engine(name, wl, x, params, fused=False)
    for b in wl.batches:
        fused.apply_batch(b)
        unfused.apply_batch(b)
        for l in range(3):
            assert torch.equal(fused.h[l], unfused.h[l])
        for l in range(2):
            assert torch.equal(fused.a[l], unfused.a[l])
            assert torch.equal(fused.nct[l], unfused.nct[l])


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_apply_stream_equals_apply_batch_bitwise(name):
    x, wl = _mk_stream(make_graph, make_stream, seed=SEED, num_batches=12)
    params = _params_np(name)
    streamed = _port_engine(name, wl, x, params)
    serial = _port_engine(name, wl, x, params)
    ss = streamed.apply_stream(wl.batches)
    for b in wl.batches:
        serial.apply_batch(b)
    assert torch.equal(streamed.embeddings, serial.embeddings)
    assert ss.prefetch_hits == len(wl.batches) - 1
    assert ss.as_dict()["n_batches"] == len(wl.batches)


def test_stream_stats_keys_match_reference():
    assert STREAM_STAT_KEYS == J_STREAM_STAT_KEYS


def test_refresh_cadence_recomputes_from_current_graph():
    x, wl = _mk_stream(make_graph, make_stream, seed=SEED, num_batches=6)
    eng = _port_engine("gcn", wl, x, _params_np("gcn"), refresh_every=4)
    eng.apply_stream(wl.batches)
    ref = full_forward(eng.model, eng.params, torch.from_numpy(_final_features(x, wl)),
                       eng.graph)[-1].h
    assert float((eng.embeddings - ref).abs().max()) < TOL


def test_factory_device_and_backend_errors():
    x, wl = _mk_stream(make_graph, make_stream, seed=SEED, num_batches=1)
    cfg = EngineConfig(model=make_model("gcn"), graph=wl.base, x=x, dims=[8, 8])
    assert cfg.device == "cuda"  # the card unless the caller asks for the CPU
    assert PORTED_BACKENDS == BACKENDS  # every substrate of the reference is ported
    if not torch.cuda.is_available():
        for backend in BACKENDS:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                create_engine(backend, cfg)
    with pytest.raises(ValueError, match="unknown backend"):
        create_engine("nope", cfg)
    eng = create_engine("device", EngineConfig(model=make_model("gcn"), graph=wl.base, x=x,
                                               dims=[8, 8], device="cpu"))
    assert eng.device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module and chip_smoke.py import with ``jax`` and
    ``repro`` blocked (an import of either raises ImportError)."""
    import repro_torch

    mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
    code = textwrap.dedent(f"""
        import importlib, importlib.util, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {str(ROOT / "src")!r})
        for m in {mods!r}:
            importlib.import_module(m)
        spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
               and sys.modules[m] is not None]
        assert not bad, bad
        print(len({mods!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
