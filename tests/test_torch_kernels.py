"""The port's kernel ops against the JAX package's, on the same numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode
(``FORCE_PALLAS_INTERPRET``) and its pure-jnp oracles.  Tolerance
``atol = rtol = 1e-5``: fp32 sums taken in a different order.  The CUDA
kernels themselves are held against the plain versions by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.delta_agg import delta_agg  # noqa: E402
from repro_torch.kernels.segment_spmm import prepare_row_schedule, segment_spmm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# (records, width, rows, Pallas tile sizes tv/be/bd)
CASES = [
    (700, 96, 40, (8, 128, 32)),
    (64, 32, 8, (8, 64, 32)),
    (33, 160, 100, (8, 64, 32)),  # sparse: many rows no record visits
]


@pytest.fixture
def pallas_interpret():
    old = jops.FORCE_PALLAS_INTERPRET
    jops.FORCE_PALLAS_INTERPRET = True
    yield
    jops.FORCE_PALLAS_INTERPRET = old


def _sorted_dst(rng, e, v, pad=5):
    """Ascending destination ids with a -1 padded tail; rows ≡ 1 (mod 3)
    are never visited."""
    pool = np.setdiff1d(np.arange(v), np.arange(1, v, 3))
    dst = np.sort(rng.choice(pool, e)).astype(np.int32)
    dst[e - pad:] = -1
    return dst


@pytest.mark.parametrize("e,d,v,tiles", CASES)
def test_segment_sum_edges_matches_reference(e, d, v, tiles, pallas_interpret):
    rng = np.random.default_rng(e + d)
    dst = _sorted_dst(rng, e, v)
    msg = rng.normal(size=(e, d)).astype(np.float32)
    tv, be, bd = tiles
    out = tops.segment_sum_edges(torch.from_numpy(msg), dst, v).numpy()
    pallas = np.asarray(jops.segment_sum_edges(jnp.asarray(msg), dst, v, tv=tv, be=be, bd=bd))
    oracle = np.asarray(jref.segment_spmm_ref(jnp.asarray(msg), jnp.asarray(dst), v))
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)
    unvisited = np.setdiff1d(np.arange(v), dst[dst >= 0])
    assert unvisited.size and np.all(out[unvisited] == 0.0)


@pytest.mark.parametrize("e,d,v,tiles", CASES)
def test_delta_agg_update_matches_reference(e, d, v, tiles, pallas_interpret):
    rng = np.random.default_rng(e * 3 + d)
    dst = _sorted_dst(rng, e, v)
    msg = rng.normal(size=(e, d)).astype(np.float32)
    state = rng.normal(size=(v, d)).astype(np.float32)
    tv, be, bd = tiles
    out = tops.delta_agg_update(torch.from_numpy(state), torch.from_numpy(msg), dst).numpy()
    pallas = np.asarray(jops.delta_agg_update(jnp.asarray(state), jnp.asarray(msg), dst,
                                              tv=tv, be=be, bd=bd))
    oracle = np.asarray(jref.delta_agg_ref(jnp.asarray(state), jnp.asarray(msg),
                                           jnp.asarray(dst)))
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)


def _plan_order_inputs(seed, e, d, r):
    """Records in plan order (unsorted row keys, -1 padding mixed in) and
    their row schedule — the layout the packed plan ships."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, r, e)
    keys[keys % 5 == 2] = -1  # rows ≡ 2 (mod 5) get no records
    keys[rng.random(e) < 0.2] = -1
    msg = rng.normal(size=(e, d)).astype(np.float32)
    order, row_ptr = prepare_row_schedule(keys, r)
    return keys, msg, torch.from_numpy(order), torch.from_numpy(row_ptr)


@pytest.mark.parametrize("e,d,r", [(300, 33, 64), (17, 129, 16)])
def test_segment_spmm_schedule_matches_oracle(e, d, r):
    keys, msg, order, row_ptr = _plan_order_inputs(e + d, e, d, r)
    out = segment_spmm(torch.from_numpy(msg), row_ptr, order, r).numpy()
    oracle = np.asarray(jref.segment_spmm_ref(jnp.asarray(msg), jnp.asarray(keys, jnp.int32), r))
    np.testing.assert_allclose(out, oracle, **TOL)
    empty = np.setdiff1d(np.arange(r), keys[keys >= 0])
    assert np.all(out[empty] == 0.0)


@pytest.mark.parametrize("e,d,r", [(300, 33, 64), (17, 129, 16)])
def test_delta_agg_schedule_matches_oracle_and_skips_untouched_rows(e, d, r):
    keys, msg, order, row_ptr = _plan_order_inputs(e * 7 + d, e, d, r)
    state0 = np.random.default_rng(d).normal(size=(r, d)).astype(np.float32)
    state = torch.from_numpy(state0.copy())
    out = delta_agg(state, torch.from_numpy(msg), row_ptr, order)
    assert out is state  # in place
    oracle = np.asarray(jref.delta_agg_ref(jnp.asarray(state0), jnp.asarray(msg),
                                           jnp.asarray(keys, jnp.int32)))
    np.testing.assert_allclose(out.numpy(), oracle, **TOL)
    untouched = np.setdiff1d(np.arange(r), keys[keys >= 0])
    assert untouched.size
    np.testing.assert_array_equal(out.numpy()[untouched], state0[untouched])


def test_row_schedule_covers_each_live_record_once_in_order():
    rng = np.random.default_rng(0)
    keys = rng.integers(-1, 20, 500)  # -1 = dropped
    order, row_ptr = prepare_row_schedule(keys, 20)
    assert row_ptr[0] == 0 and row_ptr[-1] == np.count_nonzero(keys >= 0)
    seen = order[: row_ptr[-1]]
    np.testing.assert_array_equal(np.sort(seen), np.nonzero(keys >= 0)[0])
    for r in range(20):
        run = order[row_ptr[r]:row_ptr[r + 1]]
        assert np.all(keys[run] == r)
        assert np.all(np.diff(run) > 0)  # stable: each row keeps record order


def test_wrappers_reject_unsupported_devices_and_shapes():
    msg = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segment_spmm(msg, torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        delta_agg(torch.zeros(2, 3, device="meta"), msg,
                  torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="expected 3"):
        segment_spmm(torch.zeros(4, 3), torch.zeros(5, dtype=torch.int32), None, 2)
