"""The port on a CUDA card: each kernel against its plain version, and the
engine's invariants with the kernels on its path.

Every test here needs a card and is marked ``gpu``; on a host without one
each skips with its reason.  The file imports neither ``jax`` nor ``repro``
(a GPU machine need not have them), so on a card it runs as

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: kernel vs plain version 1e-5 (fp32, different summation order);
engine on the card vs the same engine on the CPU 1e-5 per batch (different
matmul kernels); the invariants inside the port are bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.models import make_model  # noqa: E402
from repro_torch.graph import make_graph, make_stream, random_features  # noqa: E402
from repro_torch.kernels import delta_agg as dmod  # noqa: E402
from repro_torch.kernels import segment_spmm as smod  # noqa: E402
from repro_torch.serve import EngineConfig, create_engine  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, e, d, r, idx_dtype=torch.int32):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, r, e)
    keys[rng.random(e) < 0.2] = -1
    order, row_ptr = smod.prepare_row_schedule(keys, r)
    msg = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).cuda()
    return (msg, torch.from_numpy(row_ptr).to("cuda", idx_dtype),
            torch.from_numpy(order).to("cuda", idx_dtype))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_segment_spmm_kernel_matches_plain_and_repeats_bitwise(cuda, idx_dtype):
    msg, row_ptr, order = _inputs(1, 5000, 129, 700, idx_dtype)
    n0 = smod.KERNEL.launches
    out = smod.segment_spmm(msg, row_ptr, order, 700)
    assert smod.KERNEL.launches == n0 + 1
    torch.testing.assert_close(out, smod.segment_spmm_plain(msg, row_ptr, order, 700), **TOL)
    assert torch.equal(out, smod.segment_spmm(msg, row_ptr, order, 700))  # no atomics
    ident = smod.segment_spmm(msg, row_ptr, None, 700)  # order omitted = identity
    torch.testing.assert_close(ident, smod.segment_spmm_plain(msg, row_ptr, None, 700), **TOL)


def test_delta_agg_kernel_matches_plain_and_skips_untouched_rows(cuda):
    msg, row_ptr, order = _inputs(2, 5000, 130, 700)
    state = torch.randn(700, 130, device=cuda)
    out = dmod.delta_agg(state.clone(), msg, row_ptr, order)
    torch.testing.assert_close(out, dmod.delta_agg_plain(state.clone(), msg, row_ptr, order),
                               **TOL)
    untouched = (row_ptr[1:] == row_ptr[:-1]).nonzero().squeeze(1)
    assert untouched.numel() and torch.equal(out[untouched], state[untouched])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    msg, row_ptr, order = _inputs(3, 100, 8, 10)
    with pytest.raises(ValueError, match="float32"):
        smod.segment_spmm(msg.double(), row_ptr, order, 10)
    with pytest.raises(ValueError, match="order must be"):
        smod.segment_spmm(msg, row_ptr, order.long(), 10)
    with pytest.raises(ValueError, match="all inputs"):
        smod.segment_spmm(msg, row_ptr.cpu(), order, 10)
    with pytest.raises(ValueError, match="contiguous"):
        dmod.delta_agg(torch.zeros(8, 10, device=cuda).t(), msg, row_ptr, order)


def _stream(seed=2):
    g = make_graph("powerlaw", 150, avg_degree=5, seed=seed, weighted=True)
    x, _ = random_features(150, 16, seed=seed)
    wl = make_stream(g, num_batches=10, batch_edges=8, delete_frac=0.35, seed=seed + 1,
                     feature_dim=16, feature_frac=0.02)
    return x, wl


def _engine(name, wl, x, device, **kw):
    return create_engine("device", EngineConfig(
        model=make_model(name), graph=wl.base, x=x, dims=[16, 16, 16], seed=0,
        device=device, **kw))


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_engine_on_card_matches_cpu_and_launches_both_kernels(cuda, name):
    x, wl = _stream()
    gpu, cpu = _engine(name, wl, x, "cuda"), _engine(name, wl, x, "cpu")
    n_seg, n_delta = smod.KERNEL.launches, dmod.KERNEL.launches
    for i, b in enumerate(wl.batches):
        gpu.apply_batch(b)
        cpu.apply_batch(b)
        np.testing.assert_allclose(gpu.embeddings.cpu().numpy(), cpu.embeddings.numpy(),
                                   err_msg=f"batch {i}", **TOL)
    assert smod.KERNEL.launches > n_seg and dmod.KERNEL.launches > n_delta


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_fused_equals_unfused_and_stream_equals_batch_on_card(cuda, name):
    x, wl = _stream(seed=3)
    fused, unfused = _engine(name, wl, x, "cuda"), _engine(name, wl, x, "cuda", fused=False)
    streamed = _engine(name, wl, x, "cuda")
    for b in wl.batches:
        fused.apply_batch(b)
        unfused.apply_batch(b)
        for l in range(3):
            assert torch.equal(fused.h[l], unfused.h[l])
    streamed.apply_stream(wl.batches)
    assert torch.equal(streamed.embeddings, fused.embeddings)
