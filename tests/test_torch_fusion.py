"""The port's batch-window fusion against the JAX package's.

* ``FusionWindow.footprint`` and ``FusionWindow.merge`` on the same plans
  equal the reference's, array for array;
* inside the port: a fused stream ≡ the serial loop, bitwise
  (``torch.equal`` on embeddings and every per-layer state tensor), on a
  stream with fusable and overlapping runs, gcn and gat;
* the reference's ring cell (12 region-disjoint batches, window 4) gives
  exactly 3 windows, 12 fused batches and 3 dispatches, the same counters
  as the JAX engine, and the embeddings of the JAX engine at 1e-5;
* windows never span a refresh; the off switches are inert; a per-batch
  force schedule turns fusion off; fused shapes go through the shared
  ``BucketHysteresis`` (no new layout after the first period).

The streams are copies of tests/test_fusion.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.affected import FusionConfig as JFusionConfig  # noqa: E402
from repro.core.affected import FusionWindow as JFusionWindow  # noqa: E402
from repro.core.affected import build_plan as j_build_plan  # noqa: E402
from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.graph.csr import CSRGraph as JCSRGraph  # noqa: E402
from repro.graph.streaming import UpdateBatch as JUpdateBatch  # noqa: E402
from repro.serve.api import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.api import create_engine as j_create_engine  # noqa: E402
from repro_torch.core import ExecutionPolicy, make_model, params_from_numpy  # noqa: E402
from repro_torch.core.affected import (  # noqa: E402
    BucketHysteresis,
    FusionConfig,
    FusionWindow,
    build_plan,
    pack_plan,
)
from repro_torch.graph.csr import CSRGraph  # noqa: E402
from repro_torch.graph.streaming import UpdateBatch  # noqa: E402
from repro_torch.serve import EngineConfig, create_engine  # noqa: E402

TOL_BATCH = 1e-5  # port vs reference engine
N = 600


def _ring_graph(n, csr=CSRGraph):
    src = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n]).astype(np.int64)
    dst = np.concatenate([np.arange(n), np.arange(n)]).astype(np.int64)
    return csr.from_edges(n, src, dst)


def _region_batch(n, base, rng, ub=UpdateBatch, d=8):
    return ub(ins_src=np.array([(base + 1) % n], np.int64),
              ins_dst=np.array([(base + 5) % n], np.int64),
              del_src=np.array([], np.int64), del_dst=np.array([], np.int64),
              feat_vertices=np.array([(base + 7) % n], np.int64),
              feat_values=rng.standard_normal((1, d)).astype(np.float32))


def _mixed_stream(n=N, seed=0, ub=UpdateBatch):
    """fusable (regions 60 apart), overlapping (one hub region), fusable."""
    rng = np.random.default_rng(seed)
    bases = [i * 60 % n for i in range(8)] + [15 + i for i in range(4)] \
        + [(i * 60 + 30) % n for i in range(8)]
    return [_region_batch(n, b, rng, ub) for b in bases]


def _fusable_stream(n=N, seed=0, num=12, ub=UpdateBatch):
    rng = np.random.default_rng(seed)
    return [_region_batch(n, (i * 45) % n, rng, ub) for i in range(num)]


def _params_np(name, dims=(8, 8, 8)):
    jp = j_make_model(name).init_layers(jax.random.PRNGKey(0), list(dims))
    return [{k: np.asarray(v) for k, v in p.items()} for p in jp]


def _engine(name, g, x, params_np, fused, **kw):
    model = make_model(name)
    return create_engine("device", EngineConfig(
        model=model, graph=g, x=x, device="cpu",
        params=params_from_numpy(model, params_np, device="cpu"),
        fusion=FusionConfig(window=4) if fused else None, **kw))


def _x(seed, n=N):
    return np.random.default_rng(seed).standard_normal((n, 8)).astype(np.float32)


def _state(eng):
    return [*eng.h, *eng.a, *eng.nct]


def _plans_along(model, g, batches, build):
    out = []
    for b in batches:
        g2 = g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst, b.ins_weights,
                             b.ins_etypes)
        out.append(build(model, g, g2, b, 2))
        g = g2
    return out


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_footprints_and_merge_equal_reference(name):
    batches = _mixed_stream(seed=5)
    jbatches = _mixed_stream(seed=5, ub=JUpdateBatch)
    plans = _plans_along(make_model(name), _ring_graph(N), batches, build_plan)
    jplans = _plans_along(j_make_model(name), _ring_graph(N, JCSRGraph), jbatches, j_build_plan)
    for p, jp, b, jb in zip(plans, jplans, batches, jbatches, strict=True):
        np.testing.assert_array_equal(FusionWindow.footprint(p, b),
                                      JFusionWindow.footprint(jp, jb))
    fps = [FusionWindow.footprint(p, b) for p, b in zip(plans, batches)]
    jfps = [JFusionWindow.footprint(p, b) for p, b in zip(jplans, jbatches)]
    for i in range(len(fps) - 3):
        assert FusionWindow(FusionConfig(window=4)).select_prefix(fps[i:i + 4]) == \
            JFusionWindow(JFusionConfig(window=4)).select_prefix(jfps[i:i + 4])
    merged, mb = FusionWindow.merge(plans[:4], batches[:4])
    jmerged, jmb = JFusionWindow.merge(jplans[:4], jbatches[:4])
    for lp, jlp in zip(merged.layers, jmerged.layers, strict=True):
        for f in ("e_src", "e_dst", "e_rowidx", "e_sign", "e_use_new", "e_w", "e_t",
                  "e_mask", "touch_rows", "touch_mask", "f_rows", "f_mask", "f_src",
                  "f_rowidx", "f_w", "f_t", "f_emask", "out_rows", "out_mask"):
            np.testing.assert_array_equal(getattr(lp, f), getattr(jlp, f), err_msg=f)
    for f in ("ins_src", "ins_dst", "feat_vertices", "feat_values"):
        np.testing.assert_array_equal(getattr(mb, f), getattr(jmb, f))


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_fused_equals_serial_bitwise(name):
    batches = _mixed_stream(seed=11)
    params = _params_np(name)
    serial = _engine(name, _ring_graph(N), _x(1), params, fused=False)
    fused = _engine(name, _ring_graph(N), _x(1), params, fused=True)
    ss_s = serial.apply_stream(batches)
    ss_f = fused.apply_stream(batches)
    for u, v in zip(_state(serial), _state(fused), strict=True):
        assert torch.equal(u, v)
    assert (ss_s.fusion_windows, ss_s.fused_batches) == (0, 0)
    assert ss_f.fusion_windows >= 4 and ss_f.fused_batches >= 16
    assert ss_f.fusion_fallbacks > 0  # the overlapping run fell back to serial
    widths = [b.fused_window for b in ss_f.batches]
    assert sum(1.0 / w for w in widths) == pytest.approx(
        len(batches) - (ss_f.fused_batches - ss_f.fusion_windows))


def test_ring_cell_counters_and_embeddings_equal_the_jax_engine():
    """The reference's fusion smoke cell: 3 windows / 12 fused / 3 dispatches."""
    params = _params_np("gcn", (8, 8))
    x = _x(0)
    eng = _engine("gcn", _ring_graph(N), x, params, fused=True)
    ref = j_create_engine("device", JEngineConfig(
        model=j_make_model("gcn"), graph=_ring_graph(N, JCSRGraph), x=x,
        params=[dict(p) for p in params], fusion=JFusionConfig(window=4)))
    ss = eng.apply_stream(_fusable_stream(seed=0))
    jss = ref.apply_stream(_fusable_stream(seed=0, ub=JUpdateBatch))
    got = (ss.fusion_windows, ss.fused_batches, ss.fusion_fallbacks)
    assert got == (jss.fusion_windows, jss.fused_batches, jss.fusion_fallbacks) == (3, 12, 0)
    assert len(ss.batches) - (ss.fused_batches - ss.fusion_windows) == 3
    assert [b.fused_window for b in ss.batches] == [4] * 12
    np.testing.assert_allclose(eng.embeddings.numpy(), np.asarray(ref.embeddings),
                               atol=TOL_BATCH, rtol=TOL_BATCH)


def test_fusion_never_spans_a_refresh_boundary():
    params = _params_np("gcn")
    batches = _fusable_stream(seed=9, num=9)
    runs = {}
    for fused in (False, True):
        eng = _engine("gcn", _ring_graph(N), _x(5), params, fused, refresh_every=3)
        runs[fused] = (eng, eng.apply_stream(batches))
    assert torch.equal(runs[False][0].embeddings, runs[True][0].embeddings)
    ss = runs[True][1]
    assert all(b.fused_window <= 3 for b in ss.batches)
    assert (ss.fusion_windows, ss.fused_batches) == (3, 9)


def test_off_switches_are_inert():
    params = _params_np("gcn")
    batches = _fusable_stream(n=300, seed=3, num=4)
    ref = None
    for fusion in (None, FusionConfig(window=1), FusionConfig(window=4, enabled=False)):
        model = make_model("gcn")
        eng = create_engine("device", EngineConfig(
            model=model, graph=_ring_graph(300), x=_x(6, 300), device="cpu",
            params=params_from_numpy(model, params, device="cpu"), fusion=fusion))
        ss = eng.apply_stream(batches)
        assert (ss.fusion_windows, ss.fused_batches, ss.fusion_fallbacks) == (0, 0, 0)
        if ref is None:
            ref = eng.embeddings
        assert torch.equal(ref, eng.embeddings)
    with pytest.raises(ValueError, match="window"):
        FusionConfig(window=0)


def test_per_batch_force_schedule_turns_fusion_off():
    params = _params_np("gcn")
    batches = _fusable_stream(n=300, seed=2, num=4)
    pol = ExecutionPolicy(force_mode=["incremental"] * 4)
    eng = _engine("gcn", _ring_graph(300), _x(8, 300), params, fused=True, policy=pol)
    ss = eng.apply_stream(batches)
    assert (ss.fusion_windows, ss.fused_batches) == (0, 0)
    assert len(pol.history) == 4
    g2 = _ring_graph(300).apply_updates(batches[0].ins_src, batches[0].ins_dst,
                                        batches[0].del_src, batches[0].del_dst)
    with pytest.raises(ValueError, match="force_mode"):
        ExecutionPolicy(force_mode=["incremental"]).decide_window(
            build_plan(make_model("gcn"), _ring_graph(300), g2, batches[0], 2))


def test_fused_shapes_flow_through_the_shared_hysteresis():
    model = make_model("gcn")
    batches = _fusable_stream(seed=6, num=12)
    plans = _plans_along(model, _ring_graph(N), batches, build_plan)
    hwm = BucketHysteresis()
    layouts, prev = [], None
    for lo in (0, 6):
        merged, mb = FusionWindow.merge(plans[lo:lo + 4], batches[lo:lo + 4])
        for plan, b in [(merged, mb)] + list(zip(plans[lo + 4:lo + 6], batches[lo + 4:lo + 6])):
            packed = pack_plan(plan, b.feat_vertices, b.feat_values, hwm=hwm)
            if prev is not None:
                for caps, p in zip(packed.layout.caps, prev):
                    assert all(c >= q for c, q in zip(caps, p)), "a cap shrank"
            prev = packed.layout.caps
            layouts.append(packed.layout)
    assert set(layouts[3:]) <= set(layouts[:3])
    # engine level: after a warm-up period the high-water marks stop growing
    rng = np.random.default_rng(21)
    stream = [_region_batch(N, (i * 60 + rep * 7) % N, rng) for rep in range(4) for i in range(4)]
    eng = _engine("gcn", _ring_graph(N), _x(12), _params_np("gcn"), fused=True)
    eng.apply_stream(stream[:4])
    caps = eng._backend.hwm.snapshot()
    assert eng.apply_stream(stream[4:]).fused_batches == 12
    assert eng._backend.hwm.snapshot() == caps
