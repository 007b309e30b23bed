"""The port's 11 models against ``repro.core.models``, operator by operator,
and ``full_forward``'s per-layer ``(a, nct, h)`` against the reference's.

Both sides get the same numpy inputs and the reference's own weights
(``init_layers`` exported to numpy, carried over by ``params_from_numpy``).
Tolerance ``atol = rtol = 1e-5``: fp32, different matmul kernels and sum
orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.full import full_forward as j_full_forward  # noqa: E402
from repro.core.models import ALL_MODELS as J_MODELS  # noqa: E402
from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.graph import make_graph as j_make_graph  # noqa: E402
from repro_torch.core.full import full_forward  # noqa: E402
from repro_torch.core.models import ALL_MODELS, make_model  # noqa: E402
from repro_torch.core.params import params_from_numpy  # noqa: E402
from repro_torch.graph import make_graph  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
D_IN, D_OUT = 8, 16


def _pair(name, dims):
    jm, tm = j_make_model(name), make_model(name)
    jl = jm.init_layers(jax.random.PRNGKey(1), dims)
    np_layers = [{k: np.asarray(v) for k, v in p.items()} for p in jl]
    return jm, tm, jl, params_from_numpy(tm, np_layers, device="cpu")


def _close(t_out, j_out):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **TOL)


def test_registry_and_flags_match_reference():
    assert ALL_MODELS == J_MODELS
    for name in ALL_MODELS:
        jm, tm = j_make_model(name), make_model(name)
        for flag in ("dest_dependent", "src_struct_dependent", "update_uses_h", "has_ctx"):
            assert getattr(tm, flag) == getattr(jm, flag), (name, flag)
        assert tm.agg_dim(D_IN, D_OUT) == jm.agg_dim(D_IN, D_OUT)
        assert tm.ctx_dim(D_IN, D_OUT) == jm.ctx_dim(D_IN, D_OUT)


@pytest.mark.parametrize("name", ALL_MODELS)
def test_operators_match_reference(name):
    jm, tm, jl, tl = _pair(name, [D_IN, D_OUT])
    jp, tp = jl[0], tl[0]
    rng = np.random.default_rng(7)
    e, v = 40, 20
    h_u = rng.normal(size=(e, D_IN)).astype(np.float32)
    h_v = rng.normal(size=(e, D_IN)).astype(np.float32)
    s_u = rng.integers(0, 6, e).astype(np.float32)
    s_v = rng.integers(0, 6, e).astype(np.float32)
    ew = rng.uniform(0.5, 1.5, e).astype(np.float32)
    et = rng.integers(0, 3, e).astype(np.int32)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = torch.from_numpy

    j_mlc = jm.ms_local(jp, J(h_u), J(h_v), J(s_u), J(s_v), J(ew), J(et))
    t_mlc = tm.ms_local(tp, T(h_u), T(h_v), T(s_u), T(s_v), T(ew), T(et))
    _close(t_mlc, j_mlc)
    mlc = np.asarray(j_mlc)  # feed both the same mlc downstream
    _close(tm.ctx_contrib(tp, T(mlc), T(et)), jm.ctx_contrib(jp, J(mlc), J(et)))
    j_z = jm.f_nn(jp, J(h_u), J(et))
    _close(tm.f_nn(tp, T(h_u), T(et)), j_z)
    z = np.asarray(j_z)
    _close(tm.edge_term(tp, T(mlc), T(z), T(et)), jm.edge_term(jp, J(mlc), J(z), J(et)))

    agg, c = jm.agg_dim(D_IN, D_OUT), jm.ctx_dim(D_IN, D_OUT)
    x = rng.normal(size=(v, agg)).astype(np.float32)
    nct = np.abs(rng.normal(size=(v, c))).astype(np.float32) * 3
    nct[:3] = 0.0  # drained rows: the empty-neighbourhood guards
    nct[3, :] = 1e-12  # below _ATTN_THRESH
    _close(tm.ms_cbn(tp, T(nct), T(x)), jm.ms_cbn(jp, J(nct), J(x)))
    _close(tm.ms_cbn_inv(tp, T(nct), T(x)), jm.ms_cbn_inv(jp, J(nct), J(x)))
    hv = rng.normal(size=(v, D_IN)).astype(np.float32)
    _close(tm.update(tp, T(hv), T(x)), jm.update(jp, J(hv), J(x)))


@pytest.mark.parametrize("name", ALL_MODELS)
def test_full_forward_states_match_reference(name):
    jm, tm, jl, tl = _pair(name, [8, 8, 8])
    kw = dict(avg_degree=4, seed=2, weighted=True, num_etypes=3)
    g_np = make_graph("powerlaw", 60, **kw)
    g_ref = j_make_graph("powerlaw", 60, **kw)
    x = np.random.default_rng(3).normal(size=(60, 8)).astype(np.float32)
    t_states = full_forward(tm, tl, torch.from_numpy(x), g_np)
    j_states = j_full_forward(jm, jl, jnp.asarray(x), g_ref)
    for ts, js in zip(t_states, j_states):
        _close(ts.a, js.a)
        _close(ts.nct, js.nct)
        _close(ts.h, js.h)


def test_params_from_numpy_rejects_foreign_keys():
    with pytest.raises(KeyError):
        params_from_numpy(make_model("gcn"), [{"W": np.zeros((2, 2))}], device="cpu")
