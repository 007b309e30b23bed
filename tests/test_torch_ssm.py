"""The port's recurrent mixers (``repro_torch.nn.ssm``) against the JAX
package's (``repro.nn.ssm``), on the same inputs made with numpy from a seed.

Both run on the CPU in fp32.  Tolerance 1e-5 (abs and rel): another
summation order in the products, the same arithmetic.  Inside the port, the
chunked forms equal the per-step oracles and a chain of decode steps equals
the sequence form, at the same tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
B, H, DK, DV = 2, 3, 4, 5


def _close(port, ref, msg=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), err_msg=msg, **TOL)


def _inputs(seed, s, gate="mixed"):
    """q, k [B, S, H, dk], v [B, S, H, dv], log-decay la ≤ 0 and log input gate
    li [B, S, H].  ``gate="negative"``: input gates down to about -60, where
    only the stabiliser keeps exp(li) from underflowing."""
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, s, H, DK)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, s, H, DV)).astype(np.float32)
    la = -np.abs(rng.normal(size=(B, s, H))).astype(np.float32)
    li = rng.normal(size=(B, s, H)) * 3
    if gate == "negative":
        li = li * 4 - 40
    return q, k, v, la, li.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _state_close(port, ref, msg):
    for name, a, r in zip(getattr(port, "_fields", ("state",)),
                          port if isinstance(port, tuple) else (port,),
                          ref if isinstance(ref, tuple) else (ref,)):
        _close(a, r, f"{msg} {name}")


# ---------------------------------------------------------------------- #
# SSD
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("s", [32, 37])  # a multiple of the chunk, and not
def test_ssd_matches_reference(s):
    q, k, v, la, _ = _inputs(0, s)
    jy, js = jssm.ssd_chunked(*_j(q, k, v, la), chunk=8)
    ty, ts = tssm.ssd_chunked(*_t(q, k, v, la), chunk=8)
    assert ty.shape == (B, s, H, DV) and ts.dtype == torch.float32
    _close(ty, jy, "chunked y")
    _close(ts, js, "chunked state")
    jy, js = jssm.ssd_seq(*_j(q, k, v, la))
    sy, ss = tssm.ssd_seq(*_t(q, k, v, la))
    _close(sy, jy, "seq y")
    _close(ss, js, "seq state")
    _close(ty, sy.numpy(), "chunked ≡ seq")
    _close(ts, ss.numpy(), "chunked ≡ seq state")


def test_ssd_carries_its_state_between_calls_and_steps_equal_seq():
    q, k, v, la, _ = _inputs(1, 40)
    jy1, js = jssm.ssd_chunked(*_j(q[:, :21], k[:, :21], v[:, :21], la[:, :21]), chunk=8)
    jy2, js = jssm.ssd_chunked(*_j(q[:, 21:], k[:, 21:], v[:, 21:], la[:, 21:]), s0=js, chunk=8)
    ty1, ts = tssm.ssd_chunked(*_t(q[:, :21], k[:, :21], v[:, :21], la[:, :21]), chunk=8)
    ty2, ts = tssm.ssd_chunked(*_t(q[:, 21:], k[:, 21:], v[:, 21:], la[:, 21:]), s0=ts, chunk=8)
    _close(torch.cat([ty1, ty2], 1), jnp.concatenate([jy1, jy2], 1), "two calls")
    _close(ts, js, "carried state")
    whole, _ = tssm.ssd_chunked(*_t(q, k, v, la), chunk=8)
    _close(torch.cat([ty1, ty2], 1), whole.numpy(), "two calls ≡ one")
    st, jst = torch.zeros(B, H, DK, DV), jnp.zeros((B, H, DK, DV), jnp.float32)
    ys = []
    for t in range(40):
        st, y = tssm.ssd_step(st, *_t(q[:, t], k[:, t], v[:, t], la[:, t]))
        jst, jy = jssm.ssd_step(jst, *_j(q[:, t], k[:, t], v[:, t], la[:, t]))
        _close(y, jy, f"step {t}")
        ys.append(y)
    _close(st, jst, "stepped state")
    _close(torch.stack(ys, 1), whole.numpy(), "steps ≡ seq")


# ---------------------------------------------------------------------- #
# mLSTM
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("gate", ["mixed", "negative"])
@pytest.mark.parametrize("s", [32, 37])
def test_mlstm_matches_reference(s, gate):
    q, k, v, lf, li = _inputs(2, s, gate)
    jy, jst = jssm.mlstm_chunked(*_j(q, k, v, lf, li), chunk=8)
    ty, tst = tssm.mlstm_chunked(*_t(q, k, v, lf, li), chunk=8)
    assert ty.shape == (B, s, H, DV) and np.isfinite(ty.numpy()).all()
    _close(ty, jy, "chunked y")
    _state_close(tst, jst, "chunked")
    jy, jst = jssm.mlstm_seq(*_j(q, k, v, lf, li))
    sy, sst = tssm.mlstm_seq(*_t(q, k, v, lf, li))
    _close(sy, jy, "seq y")
    _state_close(sst, jst, "seq")
    _close(ty, sy.numpy(), "chunked ≡ seq")
    _state_close(tst, tuple(a.numpy() for a in sst), "chunked ≡ seq")


def test_mlstm_carries_its_state_between_calls_and_steps_equal_seq():
    q, k, v, lf, li = _inputs(3, 40, "negative")
    cut = 19
    head = [a[:, :cut] for a in (q, k, v, lf, li)]
    tail = [a[:, cut:] for a in (q, k, v, lf, li)]
    jy1, jst = jssm.mlstm_chunked(*_j(*head), chunk=8)
    jy2, jst = jssm.mlstm_chunked(*_j(*tail), st=jst, chunk=8)
    ty1, tst = tssm.mlstm_chunked(*_t(*head), chunk=8)
    ty2, tst = tssm.mlstm_chunked(*_t(*tail), st=tst, chunk=8)
    _close(torch.cat([ty1, ty2], 1), jnp.concatenate([jy1, jy2], 1), "two calls")
    _state_close(tst, jst, "carried")
    whole, _ = tssm.mlstm_seq(*_t(q, k, v, lf, li))
    _close(torch.cat([ty1, ty2], 1), whole.numpy(), "two calls ≡ seq")
    st, jst = tssm.mlstm_init_state(B, H, DK, DV), jssm.mlstm_init_state(B, H, DK, DV)
    ys = []
    for t in range(40):
        st, y = tssm.mlstm_step(st, *_t(q[:, t], k[:, t], v[:, t], lf[:, t], li[:, t]))
        jst, jy = jssm.mlstm_step(jst, *_j(q[:, t], k[:, t], v[:, t], lf[:, t], li[:, t]))
        _close(y, jy, f"step {t}")
        ys.append(y)
    _state_close(st, jst, "stepped")
    _close(torch.stack(ys, 1), whole.numpy(), "steps ≡ seq")


def test_mlstm_padding_sentinel_is_finite_not_inf():
    """The padded input gate is -1e30: with -inf the stabiliser's
    ``-inf - -inf`` would put NaN into a padded step."""
    q, k, v, lf, li = _inputs(4, 9)
    y, st = tssm.mlstm_chunked(*_t(q, k, v, lf, li), chunk=8)
    assert np.isfinite(y.numpy()).all() and all(np.isfinite(a.numpy()).all() for a in st)


# ---------------------------------------------------------------------- #
# sLSTM and the causal convolution
# ---------------------------------------------------------------------- #
def _slstm_inputs(seed, s, gate):
    rng = np.random.default_rng(seed)
    z = np.tanh(rng.normal(size=(B, s, H, DK))).astype(np.float32)
    lf = -np.abs(rng.normal(size=(B, s, H, DK))).astype(np.float32)
    li = rng.normal(size=(B, s, H, DK)) * 3
    if gate == "negative":
        li = li * 4 - 40
    o = rng.random(size=(B, s, H, DK)).astype(np.float32)
    return z, lf, li.astype(np.float32), o


@pytest.mark.parametrize("gate", ["mixed", "negative"])
def test_slstm_matches_reference_and_steps_equal_seq(gate):
    z, lf, li, o = _slstm_inputs(5, 33, gate)
    jy, jst = jssm.slstm_seq(*_j(z, lf, li, o))
    ty, tst = tssm.slstm_seq(*_t(z, lf, li, o))
    assert ty.dtype == torch.float32 and np.isfinite(ty.numpy()).all()
    _close(ty, jy, "seq y")
    _state_close(tst, jst, "seq")
    # a carried state between two calls
    jy1, jst = jssm.slstm_seq(*_j(*(a[:, :14] for a in (z, lf, li, o))))
    jy2, jst = jssm.slstm_seq(*_j(*(a[:, 14:] for a in (z, lf, li, o))), st=jst)
    ty1, tst2 = tssm.slstm_seq(*_t(*(a[:, :14] for a in (z, lf, li, o))))
    ty2, tst2 = tssm.slstm_seq(*_t(*(a[:, 14:] for a in (z, lf, li, o))), st=tst2)
    _close(torch.cat([ty1, ty2], 1), jnp.concatenate([jy1, jy2], 1), "two calls")
    _state_close(tst2, jst, "carried")
    st, ys = tssm.slstm_init_state(B, H, DK), []
    for t in range(33):
        st, y = tssm.slstm_step(st, *_t(z[:, t], lf[:, t], li[:, t], o[:, t]))
        ys.append(y)
    _close(torch.stack(ys, 1), ty.numpy(), "steps ≡ seq")
    _state_close(st, tuple(a.numpy() for a in tst), "stepped")


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_reference(carry):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 11, 8)).astype(np.float32)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    c = rng.normal(size=(B, 3, 8)).astype(np.float32) if carry else None
    jy, jc = jssm.causal_conv(*_j(x, w), None if c is None else jnp.asarray(c))
    ty, tc = tssm.causal_conv(*_t(x, w), None if c is None else torch.from_numpy(c))
    _close(ty, jy, "y")
    _close(tc, jc, "carry")
    # one call ≡ a prefix, then the rest from its carry (decode's use)
    y1, c1 = tssm.causal_conv(*_t(x[:, :6], w), None if c is None else torch.from_numpy(c))
    y2, c2 = tssm.causal_conv(torch.from_numpy(x[:, 6:]), torch.from_numpy(w), c1)
    _close(torch.cat([y1, y2], 1), ty.numpy(), "split")
    _close(c2, tc.numpy(), "split carry")
