"""The port on a CUDA card: each kernel against its plain version, the
engine's invariants with the kernels on its path, the host-resident engines
(offload with pinned staging and the hot-row cache, chunked) against the
same engines on the CPU, the row-sharded engines against the unsharded
ones, and the reduced LM on the card against the same LM on the CPU.

Every test here needs a card and is marked ``gpu``; on a host without one
each skips with its reason.  The file imports neither ``jax`` nor ``repro``
(a GPU machine need not have them), so on a card it runs as

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: kernel vs plain version 1e-5 (fp32, different summation order);
flash_attention, its lse and its backward vs their plain versions 2e-5/2e-3
in fp32 and 3e-2 in bf16 (the reference's tests/test_kernels.py);
edge_softmax_normalize exactly (one IEEE division per element on both sides); engine on the card vs the same engine
on the CPU 1e-5 per batch (different matmul kernels); the reduced LM on the
card vs the CPU 1e-4 (fp32 cache and compute), the MoE combine bitwise the
CPU's; the invariants inside the port are bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as lm_models  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core.models import make_model  # noqa: E402
from repro_torch.graph import make_graph, make_stream, random_features  # noqa: E402
from repro_torch.kernels import delta_agg as dmod  # noqa: E402
from repro_torch.kernels import edge_softmax as emod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import row_linear as rmod  # noqa: E402
from repro_torch.kernels import segment_spmm as smod  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
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


#: row lengths at the kernels' chunk edges (``ROW_SUM_CHUNK`` = 512) and a hub row
CHUNK_EDGES = (511, 512, 513, 1024, 1025)
HUB = 100_000


def _chunked_inputs(seed, d, ordered, idx_dtype):
    """Short rows (0–30 records) around rows at the chunk edges and one
    100,000-record row, Gaussian messages; dst-sorted, or (``ordered``) in a
    random record order with a row schedule."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 31, 400)
    lengths[[7, 50, 51, 120, 399]] = CHUNK_EDGES
    lengths[200] = HUB
    keys = np.repeat(np.arange(len(lengths)), lengths)
    order = None
    if ordered:
        order, row_ptr = smod.prepare_row_schedule(keys[rng.permutation(len(keys))], len(lengths))
        order = torch.from_numpy(order).to("cuda", idx_dtype)
    else:
        row_ptr = np.concatenate([[0], np.cumsum(lengths)])
    msg = torch.from_numpy(rng.normal(size=(len(keys), d)).astype(np.float32)).cuda()
    return msg, torch.from_numpy(row_ptr).to("cuda", idx_dtype), order


@pytest.mark.parametrize("d", [2, 129, 300])  # an edge softmax's heads, [ctx | raw], past 256
@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_sum_kernels_are_bitwise_the_chunked_order(cuda, idx_dtype, ordered, d):
    """``segment_spmm`` and ``delta_agg`` equal ``row_sum_chunked_plain`` at
    ``ROW_SUM_CHUNK`` bit for bit, at the chunk edges and for a hub row among
    short ones; ``delta_agg`` adds each touched row's sum once and leaves
    every untouched row's bits; one launch a call."""
    msg, row_ptr, order = _chunked_inputs(d, d, ordered, idx_dtype)
    r = row_ptr.shape[0] - 1
    ref = smod.row_sum_chunked_plain(msg, row_ptr, order, smod.ROW_SUM_CHUNK)
    n0 = smod.KERNEL.launches
    out = smod.segment_spmm(msg, row_ptr, order, r)
    assert smod.KERNEL.launches == n0 + 1
    assert torch.equal(out, ref)
    state = torch.randn(r, d, device=cuda)
    n0 = dmod.KERNEL.launches
    got = dmod.delta_agg(state.clone(), msg, row_ptr, order)
    assert dmod.KERNEL.launches == n0 + 1
    touched = row_ptr[1:] != row_ptr[:-1]
    assert bool((~touched).any())
    want = state.clone()
    want[touched] = state[touched] + ref[touched]
    assert torch.equal(got, want)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_sum_kernel_row_bits_do_not_depend_on_row_count_or_offset(cuda, idx_dtype):
    """Rows of a sub-schedule (other first row, so another offset in the
    record array; fewer rows) are bitwise the same rows of the whole one, and
    so is a hub row whose records moved behind other rows."""
    msg, row_ptr, _ = _chunked_inputs(7, 129, False, idx_dtype)
    r = row_ptr.shape[0] - 1
    full = smod.segment_spmm(msg, row_ptr, None, r)
    for a, b in ((0, 1), (1, r), (51, 201), (199, 200), (200, 201), (200, r), (7, 52)):
        assert torch.equal(smod.segment_spmm(msg, row_ptr[a:b + 1], None, b - a), full[a:b]), (a, b)
    lo, hi = int(row_ptr[200]), int(row_ptr[201])  # the hub, its records after 3 rows of 300
    moved = torch.cat([torch.randn(900, 129, device=cuda), msg[lo:hi]])
    rp = torch.tensor([0, 300, 600, 900, 900 + hi - lo], dtype=idx_dtype, device=cuda)
    assert torch.equal(smod.segment_spmm(moved, rp, None, 4)[3], full[200])


#: the row-count probe: both sides of the wrapper's switch to the tiled kernel
ROW_PROBE = (1, 2, 15, 16, 17, 32, 33, 1000, rmod.TILED_MIN_ROWS - 1, rmod.TILED_MIN_ROWS, 20_000)
GENERAL, TILED = rmod.ENTRIES


def _row_linear_inputs(rng, m, k, n):
    """Glorot-scaled W, Gaussian A with a fifth of its entries, one row of A
    and one column of W exact zeros."""
    a = rng.normal(size=(m, k)).astype(np.float32)
    a[rng.random((m, k)) < 0.2] = 0.0
    a[m // 2] = 0.0
    w = (rng.normal(size=(k, n)) * np.sqrt(2 / (k + n))).astype(np.float32)
    w[:, n // 3] = 0.0
    return torch.from_numpy(a).cuda(), torch.from_numpy(w).cuda()


@pytest.mark.parametrize("k,n", [(128, 128), (256, 128), (129, 130)])
def test_row_linear_kernel_rows_do_not_depend_on_the_row_count(cuda, k, n):
    """Rows of ``A[:m] @ W`` bitwise rows of ``A @ W`` for every m (cuBLAS
    picks another kernel above 16 rows), one launch a call, within 1e-5 of
    the plain version.  At (128, 128) and (256, 128) the wrapper switches
    from the general to the tiled kernel at ``TILED_MIN_ROWS``, inside the
    probe; each kernel is probed on its own too.  (129, 130) stays general."""
    rng = np.random.default_rng(k)
    a, w = _row_linear_inputs(rng, ROW_PROBE[-1], k, n)
    n0 = rmod.KERNEL.launches
    full = rmod.row_linear(a, w)
    assert rmod.KERNEL.launches == n0 + 1
    assert rmod.kernel_entry(len(a), k, n) == (TILED if n == 128 else GENERAL)
    for m in ROW_PROBE:
        assert torch.equal(rmod.row_linear(a[:m], w), full[:m]), m
    for entry in rmod.ENTRIES if n == 128 else (GENERAL,):
        assert torch.equal(rmod.row_linear(a, w, entry=entry), full), entry
        for m in ROW_PROBE[:8]:
            assert torch.equal(rmod.row_linear(a[:m], w, entry=entry), full[:m]), (entry, m)
    torch.testing.assert_close(full, rmod.row_linear_plain(a, w), **TOL)
    with pytest.raises(ValueError, match="float32"):
        rmod.row_linear(a.double(), w.double())


@pytest.mark.parametrize("k", [16, 128, 144, 176, 256])
def test_row_linear_tiled_kernel_is_bitwise_the_general_kernel(cuda, k):
    """The tiled kernel (N = 128, K ≡ 0 mod 16, K ≤ 256) runs the general
    kernel's fmaf chain, so every output bit agrees, at row-tile tails (M not
    a multiple of 128), with K tails (144, 176: a last slice of 16 or 48 k)
    and with exact zeros in A and W; one launch a call."""
    rng = np.random.default_rng(100 + k)
    a, w = _row_linear_inputs(rng, 70_000, k, 128)
    for m in (1, 2, 15, 16, 17, 127, 128, 129, 1000, 70_000):
        n0 = rmod.KERNEL.launches
        tiled = rmod.row_linear(a[:m], w, entry=TILED)
        general = rmod.row_linear(a[:m], w, entry=GENERAL)
        assert rmod.KERNEL.launches == n0 + 2
        assert torch.equal(tiled.view(torch.int32), general.view(torch.int32)), m
    torch.testing.assert_close(tiled, rmod.row_linear_plain(a, w), **TOL)


def test_row_linear_tiled_kernel_refuses_what_it_does_not_take(cuda):
    """Shapes outside the tiled kernel's and views that are not 16-byte
    aligned raise when forced on it; the wrapper's own choice sends a
    misaligned view to the general kernel, with the same bits."""
    rng = np.random.default_rng(5)
    for k, n in ((129, 128), (272, 128), (128, 64), (8, 128)):
        a, w = _row_linear_inputs(rng, 300, k, n)
        with pytest.raises(RuntimeError, match="launch failed"):
            rmod.row_linear(a, w, entry=TILED)
    a, w = _row_linear_inputs(rng, rmod.TILED_MIN_ROWS, 128, 128)
    shifted = torch.empty(a.numel() + 1, device=cuda)[1:].view_as(a).copy_(a)
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        rmod.row_linear(shifted, w, entry=TILED)
    assert torch.equal(rmod.row_linear(shifted, w), rmod.row_linear(a, w))
    with pytest.raises(ValueError, match="entry"):
        rmod.row_linear(a, w, entry="cublas")


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


# ---------------------------------------------------------------------- #
# flash_attention, edge_softmax_normalize and the LM
# ---------------------------------------------------------------------- #
def _attn_inputs(b, hq, hkv, sq, sk, dh, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(b, hq, sq, dh, device="cuda", generator=g).to(dtype),
            torch.randn(b, hkv, sk, dh, device="cuda", generator=g).to(dtype),
            torch.randn(b, hkv, sk, dh, device="cuda", generator=g).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", fmod.HEAD_DIMS)
@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,causal,window,q_offset",
    [
        (2, 4, 4, 128, 128, True, None, 0),  # MHA, causal
        (1, 8, 2, 200, 200, True, None, 0),  # GQA g = 4, ragged S
        (2, 4, 1, 257, 257, True, 48, 0),  # MQA, window, ragged
        (1, 2, 2, 100, 77, False, None, 0),  # not causal, Sq ≠ Sk
        (2, 4, 2, 5, 300, True, None, 295),  # a few rows at the end of a cache
        (1, 2, 1, 70, 70, True, 16, -20),  # rows that see no key give 0
        (1, 2, 1, 2049, 2049, True, None, 0),  # one row past 16 query tiles of 128
    ],
)
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, sq, sk, causal, window,
                                              q_offset, dh, dtype):
    q, k, v = _attn_inputs(b, hq, hkv, sq, sk, dh, dtype)
    n0 = fmod.KERNEL.launches
    out = fmod.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert fmod.KERNEL.launches == n0 + 1 and out.dtype == dtype
    ref = kref.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    tol = dict(atol=3e-2, rtol=3e-2) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=2e-3)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.equal(out, fmod.flash_attention(q, k, v, causal=causal, window=window,
                                                 q_offset=q_offset))  # bitwise repeat


_EDGES = (63, 64, 65, 127, 128, 129)  # around the 64-key tiles and 128-row query tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", fmod.HEAD_DIMS)
@pytest.mark.parametrize("sq,sk,causal",
                         [(n, n, True) for n in _EDGES]
                         + [(a, b_, False) for a, b_ in zip(_EDGES, reversed(_EDGES))])
def test_flash_attention_kernel_matches_plain_at_tile_edges(cuda, sq, sk, causal, dh, dtype):
    q, k, v = _attn_inputs(1, 4, 2, sq, sk, dh, dtype, seed=sq * 1000 + sk)
    out = fmod.flash_attention(q, k, v, causal=causal)
    ref = kref.flash_attention_ref(q, k, v, causal=causal)
    tol = dict(atol=3e-2, rtol=3e-2) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=2e-3)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _attn_inputs(1, 4, 2, 64, 64, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fmod.flash_attention(q, k, v)
    q, k, v = _attn_inputs(1, 4, 2, 64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        fmod.flash_attention(q, k.half(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fmod.flash_attention(q.transpose(2, 3), k, v)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view_as(q)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        fmod.flash_attention(shifted, k, v)


# ---------------------------------------------------------------------- #
# flash_attention's lse output and its backward kernels
# ---------------------------------------------------------------------- #
def _bwd_check(q, k, v, causal=True, window=None, q_offset=0, seed=1):
    """lse and o against the plain version (o with lse is o without, bit for
    bit), then the two backward kernels against ``flash_attention_bwd_ref``
    on the kernel's o and lse, and a second launch bitwise the first."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fmod.flash_attention_lse(q, k, v, causal, window, q_offset)
    assert torch.equal(o, fmod.flash_attention(q, k, v, **kw))
    o_ref, lse_ref = kref.flash_attention_lse_ref(q, k, v, causal, window, q_offset)
    seen = torch.isfinite(lse_ref)
    assert torch.equal(seen, torch.isfinite(lse))  # −inf exactly where no key is seen
    torch.testing.assert_close(lse[seen], lse_ref[seen], atol=2e-5, rtol=2e-3)
    g = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(q.shape, device="cuda", generator=g).to(q.dtype)
    n0 = dict(fmod.BWD_KERNEL.entry_launches)
    grads = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    t = "f32" if q.dtype == torch.float32 else "bf16"
    for entry in fmod.BWD_ENTRIES:
        sym = f"flash_attention_bwd_{entry}_{t}"
        assert fmod.BWD_KERNEL.entry_launches[sym] == n0[sym] + 1
    ref = kref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    tol = dict(atol=3e-2, rtol=3e-2) if q.dtype == torch.bfloat16 else dict(atol=2e-5, rtol=2e-3)
    for name, a, r, x in zip(("dq", "dk", "dv"), grads, ref, (q, k, v)):
        assert a.dtype == x.dtype and a.shape == x.shape
        torch.testing.assert_close(a.float(), r.float(), **tol, msg=lambda m, n=name: f"{n}: {m}")
    again = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", fmod.HEAD_DIMS)
@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,causal,window,q_offset",
    [
        (2, 4, 4, 128, 128, True, None, 0),  # MHA, causal
        (1, 8, 2, 200, 200, True, None, 0),  # GQA g = 4, ragged S
        (2, 4, 1, 257, 257, True, 48, 0),  # MQA, window, ragged
        (1, 2, 2, 100, 77, False, None, 0),  # not causal, Sq ≠ Sk
        (2, 4, 2, 5, 300, True, None, 295),  # a few rows at the end of a cache
        (1, 2, 1, 70, 70, True, 16, -20),  # rows that see no key: zero gradients
    ],
)
def test_flash_attention_bwd_kernels_match_plain(cuda, b, hq, hkv, sq, sk, causal, window,
                                                 q_offset, dh, dtype):
    _bwd_check(*_attn_inputs(b, hq, hkv, sq, sk, dh, dtype), causal, window, q_offset)


#: the backward's loop steps: 64 keys or query rows, 32 in fp32 at dh 64, 16 in
#: fp32 at dh 128 (its blocks: 128 query rows or keys, 64 in fp32 at dh 128)
_BWD_STEP_EDGES = (15, 16, 17, 31, 32, 33)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", fmod.HEAD_DIMS)
@pytest.mark.parametrize("sq,sk,causal",
                         [(n, n, True) for n in _EDGES]
                         + [(a, b_, False) for a, b_ in zip(_EDGES, reversed(_EDGES))]
                         + [(n, n, True) for n in _BWD_STEP_EDGES]
                         + [(a, b_, False) for a in (15, 33, 129) for b_ in (17, 31, 64)])
def test_flash_attention_bwd_kernels_match_plain_at_tile_edges(cuda, sq, sk, causal, dh, dtype):
    """Sq and Sk at a tile − 1, the tile and the tile + 1 of the backward's
    blocks and loop steps (and the forward's tiles)."""
    _bwd_check(*_attn_inputs(1, 4, 2, sq, sk, dh, dtype, seed=sq * 1000 + sk), causal)


def test_flash_attention_autograd_on_card_matches_cpu(cuda):
    q, k, v = _attn_inputs(1, 8, 2, 150, 150, 64, torch.float32, seed=3)
    do = torch.randn(q.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(4))
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out = fmod.flash_attention(*leaves, causal=True, window=64)
        grads[dev] = torch.autograd.grad(out, leaves, do.to(dev))
    for a, c in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), c, atol=2e-5, rtol=2e-3)


def test_flash_attention_bwd_rejects_what_the_kernels_do_not_take(cuda):
    q, k, v = _attn_inputs(1, 4, 2, 64, 64, 64, torch.float32)
    o, lse = fmod.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="dtype"):
        fmod.flash_attention_bwd(q, k, v, o.bfloat16(), lse, o)
    with pytest.raises(ValueError, match="contiguous"):
        fmod.flash_attention_bwd(q, k, v, o, lse, o.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="head dim"):
        q48, k48, v48 = _attn_inputs(1, 4, 2, 64, 64, 48, torch.float32)
        fmod.flash_attention_bwd(q48, k48, v48, q48, lse, q48)


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2.5-3b", "qwen3-moe-30b-a3b"])
def test_reduced_lm_loss_and_grads_on_card_match_cpu(cuda, name):
    """The training path on the card: the loss and every gradient leaf against
    the same model on the CPU (fp32, 1e-4 relative to the leaf's largest
    entry); each backward kernel once a layer, the forward twice under remat."""
    from repro_torch.train.trainer import TrainConfig, synthetic_batch, value_and_grad
    from repro_torch.train.tree import tree_paths

    cfg = dataclasses.replace(reduced_config(get_arch(name)), remat=True)
    params = lm_models.init_model(torch.Generator().manual_seed(0), cfg)
    batch = synthetic_batch(cfg, TrainConfig(batch=2, seq_len=100), 0, device="cpu")
    n_fwd, n_bwd = fmod.KERNEL.launches, fmod.BWD_KERNEL.launches
    loss, _, grads = value_and_grad(_to(params, "cuda"), cfg,
                                    {k: v.cuda() for k, v in batch.items()})
    assert fmod.KERNEL.launches - n_fwd == 2 * cfg.num_layers
    assert fmod.BWD_KERNEL.launches - n_bwd == 2 * cfg.num_layers  # dQ and dK/dV a layer
    loss_cpu, _, grads_cpu = value_and_grad(params, cfg, batch)
    assert abs(float(loss) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    for (key, a), (_, c) in zip(tree_paths(grads), tree_paths(grads_cpu)):
        assert float((a.cpu() - c).abs().max()) <= 1e-4 * float(c.abs().max()), key


@pytest.mark.parametrize("h", [1, 2, 3, 4, 8])  # vector widths and the generic loop
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_edge_softmax_kernel_matches_plain_and_op_matches_reference(cuda, idx_dtype, h):
    rng = np.random.default_rng(5 + h)
    e, r = 20011, 3000  # E not a multiple of the edges a block or a thread takes
    dst = np.sort(rng.integers(0, r, e))
    dst[rng.random(e) < 0.05] = -1
    scores = torch.from_numpy(np.exp(rng.uniform(size=(e, h))).astype(np.float32)).cuda()
    sums = kref.segment_spmm_ref(scores, torch.from_numpy(dst).cuda(), r)
    dst_t = torch.from_numpy(dst).to("cuda", idx_dtype)
    n0 = emod.KERNEL.launches
    out = emod.edge_softmax_normalize(scores, dst_t, sums)
    assert emod.KERNEL.launches == n0 + 1
    assert torch.equal(out, emod.edge_softmax_normalize_plain(scores, dst_t, sums))
    live = dst >= 0
    n, s = ops.edge_softmax(scores[live], dst[live], r)
    n_ref, s_ref = kref.edge_softmax_ref(scores[live], torch.from_numpy(dst[live]).cuda(), r)
    torch.testing.assert_close(n, n_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2.5-3b"])
def test_reduced_lm_on_card_matches_cpu(cuda, name):
    cfg = reduced_config(get_arch(name))
    params = lm_models.init_model(torch.Generator().manual_seed(0), cfg)
    on_card = _to(params, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    n0 = fmod.KERNEL.launches
    full = lm_models.forward(on_card, cfg, {"tokens": tokens.cuda()})
    assert fmod.KERNEL.launches == n0 + cfg.num_layers  # one launch per layer
    torch.testing.assert_close(full.cpu(), lm_models.forward(params, cfg, {"tokens": tokens}),
                               atol=1e-4, rtol=1e-4)
    card = _serve_steps(on_card, cfg, tokens.cuda())
    for i, (a, c) in enumerate(zip(card, _serve_steps(params, cfg, tokens))):
        torch.testing.assert_close(a.cpu(), c, atol=1e-4, rtol=1e-4, msg=f"step {i}")
    res = serve(cfg, on_card, tokens[:, :8], 6)
    assert res.tokens.is_cuda and res.tokens.shape == (2, 7)
    torch.testing.assert_close(res.tokens.cpu(), serve(cfg, params, tokens[:, :8], 6).tokens)


def test_moe_combine_kernel_matches_cpu_and_repeats_bitwise(cuda):
    """The MoE combine (``nn/moe.py`` ``combine``: its device-built schedule,
    then ``segment_spmm``) on the card: one kernel launch, the CPU's sums bit
    for bit (each row one chain in record order from 0, at most top_k = 8
    records a row), the same bits from launch to launch, and the gradient of
    a gather."""
    from repro_torch.nn import moe as moe_mod

    rng = np.random.default_rng(7)
    b, s, e, c, d = 4, 300, 16, 40, 2048
    sel = np.stack([np.stack([rng.permutation(s)[:c] for _ in range(b)]) for _ in range(e)])
    valid = rng.random((e, b, c)) < 0.7
    key = np.where(valid, np.arange(b)[None, :, None] * s + sel, b * s).reshape(-1)
    y = torch.from_numpy(rng.normal(size=(e * b * c, d)).astype(np.float32))
    key_t = torch.from_numpy(key)
    n0 = smod.KERNEL.launches
    out = moe_mod.combine(y.cuda(), key_t.cuda(), b * s)
    assert smod.KERNEL.launches == n0 + 1
    assert torch.equal(out, moe_mod.combine(y.cuda(), key_t.cuda(), b * s))
    assert torch.equal(out.cpu(), moe_mod.combine(y, key_t, b * s))
    yg = y.cuda().requires_grad_()
    g = torch.randn(b * s, d, device="cuda")
    (moe_mod.combine(yg, key_t.cuda(), b * s) * g).sum().backward()
    assert torch.equal(yg.grad, torch.cat([g, g.new_zeros(1, d)])[key_t.cuda()])


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"])
def test_reduced_moe_on_card_matches_cpu(cuda, name):
    """The reduced MoE LM on the card against the CPU (fp32 cache and compute,
    1e-4): forward, prefill and teacher-forced decode at dropless capacity,
    and ``serve``'s tokens; the combine runs in ``segment_spmm`` once a
    layer, the attention in ``flash_attention`` once a layer of the forward."""
    cfg = reduced_config(get_arch(name))
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    params = lm_models.init_model(torch.Generator().manual_seed(0), cfg)
    on_card = _to(params, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    n_attn, n_comb = fmod.KERNEL.launches, smod.KERNEL.launches
    full = lm_models.forward(on_card, cfg, {"tokens": tokens.cuda()})
    assert fmod.KERNEL.launches == n_attn + cfg.num_layers
    assert smod.KERNEL.launches == n_comb + cfg.num_layers
    torch.testing.assert_close(full.cpu(), lm_models.forward(params, cfg, {"tokens": tokens}),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(full, lm_models.forward(on_card, cfg, {"tokens": tokens.cuda()}))
    card = _serve_steps(on_card, cfg, tokens.cuda())
    for i, (a, c) in enumerate(zip(card, _serve_steps(params, cfg, tokens))):
        torch.testing.assert_close(a.cpu(), c, atol=1e-4, rtol=1e-4, msg=f"step {i}")
        torch.testing.assert_close(a[:, 0], full[:, 35 + i], atol=1e-4, rtol=1e-4)
    res = serve(cfg, on_card, tokens[:, :8], 6)
    assert res.tokens.is_cuda and res.tokens.shape == (2, 7)
    torch.testing.assert_close(res.tokens.cpu(), serve(cfg, params, tokens[:, :8], 6).tokens)


def _serve_steps(params, cfg, tokens, prompt=36):
    """Logits of a prefill into an fp32 cache and teacher-forced decode steps."""
    logits, cache = lm_models.prefill(params, cfg, {"tokens": tokens[:, :prompt]},
                                      s_max=tokens.shape[1], cache_dtype=torch.float32)
    steps = [logits]
    for i in range(prompt, tokens.shape[1]):
        logits, cache = lm_models.decode_step(params, cfg, tokens[:, i:i + 1], cache)
        steps.append(logits)
    return steps


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


# ---------------------------------------------------------------------- #
# the serving layer on the card: policy, fusion, front-end, storage,
# baselines, ODEC
# ---------------------------------------------------------------------- #
def _adversarial(regime):
    from repro_torch.graph import make_adversarial_stream

    wl = make_adversarial_stream(regime, feature_dim=16)
    x, _ = random_features(wl.base.n, 16, seed=0)
    return x, wl


@pytest.mark.parametrize("regime", ["hub_burst", "delete_heavy", "feature_churn"])
def test_policy_on_card_matches_cpu_and_replays_bitwise(cuda, regime):
    from repro_torch.core import ExecutionPolicy

    x, wl = _adversarial(regime)
    gpu = _engine("gcn", wl, x, "cuda", policy="adaptive")
    cpu = _engine("gcn", wl, x, "cpu", policy="adaptive")
    n_seg, n_delta = smod.KERNEL.launches, dmod.KERNEL.launches
    for b in wl.batches:
        assert gpu.apply_batch(b).mode == cpu.apply_batch(b).mode
        np.testing.assert_allclose(gpu.embeddings.cpu().numpy(), cpu.embeddings.numpy(), **TOL)
    assert smod.KERNEL.launches > n_seg and dmod.KERNEL.launches > n_delta
    schedule = [d.mode for d in gpu._orch.policy.history]
    assert len(set(schedule)) > 1
    replay = _engine("gcn", wl, x, "cuda", policy=ExecutionPolicy(force_mode=schedule))
    replay.apply_stream(wl.batches)
    assert torch.equal(replay.embeddings, gpu.embeddings)


def _ring_cell(n=600):
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.streaming import UpdateBatch

    idx = np.arange(n, dtype=np.int64)
    g = CSRGraph.from_edges(n, np.concatenate([(idx + 1) % n, (idx + 2) % n]),
                            np.concatenate([idx, idx]))
    rng = np.random.default_rng(0)
    batches = [UpdateBatch(ins_src=np.array([(i * 45 + 1) % n]), ins_dst=np.array([(i * 45 + 5) % n]),
                           del_src=np.array([], np.int64), del_dst=np.array([], np.int64),
                           feat_vertices=np.array([(i * 45 + 7) % n]),
                           feat_values=rng.standard_normal((1, 16)).astype(np.float32))
               for i in range(12)]
    x = rng.standard_normal((n, 16)).astype(np.float32)
    return g, batches, x


def test_fusion_on_card_counts_and_matches_serial(cuda):
    """3 windows / 12 fused / 3 dispatches; every h, a and nct bitwise the
    serial loop's: the update's product runs on more rows in a window, and
    ``row_linear``'s rows do not depend on the row count."""
    from repro_torch.serve import FusionConfig

    g, batches, x = _ring_cell()
    runs = {}
    for fused in (False, True):
        eng = create_engine("device", EngineConfig(
            model=make_model("gcn"), graph=g, x=x, dims=[16, 16, 16], seed=0, device="cuda",
            fusion=FusionConfig(window=4) if fused else None))
        runs[fused] = (eng, eng.apply_stream(batches))
    (serial, _), (fused, ss) = runs[False], runs[True]
    assert (ss.fusion_windows, ss.fused_batches, ss.fusion_fallbacks) == (3, 12, 0)
    for u, v in zip([*serial.h, *serial.a, *serial.nct], [*fused.h, *fused.a, *fused.nct]):
        assert torch.equal(u, v)


def test_frontend_reads_on_card_are_bitwise_snapshots(cuda):
    x, wl = _stream()
    eng = _engine("gcn", wl, x, "cuda")
    fr = eng.serving_frontend(max_pending_reads=64, max_versions=len(wl.batches) + 1)
    rows = np.arange(0, wl.base.n, 5)
    snaps = [eng.snapshot_rows(rows)]
    for b in wl.batches:
        fr.apply_batch(b)
        snaps.append(eng.snapshot_rows(rows))
    for v in range(fr.version + 1):
        np.testing.assert_array_equal(fr.read(rows, version=v), snaps[v])


def test_store_h_false_on_card(cuda):
    x, wl = _stream()
    engines = {s: _engine("gcn", wl, x, "cuda", store_h=s) for s in (True, False)}
    for e in engines.values():
        e.apply_stream(wl.batches)
    torch.testing.assert_close(engines[False].embeddings, engines[True].embeddings,
                               atol=2e-4, rtol=0)
    assert engines[False].state_bytes() < engines[True].state_bytes()


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_baselines_and_odec_on_card_match_cpu(cuda, name):
    from repro_torch.core import RTECUER, RTECFull, RTECSample, odec_query

    x, wl = _stream()
    model = make_model(name)
    params = model.init_layers(torch.Generator().manual_seed(0), [16, 16, 16], device="cpu")
    on_card = [{k: v.cuda() for k, v in p.items()} for p in params]
    xt = torch.from_numpy(x)
    for cls, kw in ((RTECFull, {}), (RTECUER, {}), (RTECSample, {"fanout": 3})):
        gpu = cls(model, on_card, wl.base, xt.cuda(), **kw)
        cpu = cls(model, params, wl.base, xt, **kw)
        n_seg = smod.KERNEL.launches
        for b in wl.batches[:4]:
            assert gpu.apply_batch(b).edges_processed == cpu.apply_batch(b).edges_processed
        assert smod.KERNEL.launches > n_seg
        np.testing.assert_allclose(gpu.embeddings.cpu().numpy(), cpu.embeddings.numpy(), **TOL)
    eng = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=on_card,
                                               device="cuda"))
    q = np.arange(0, wl.base.n, 9)
    before = [t.clone() for t in (*eng.h, *eng.a, *eng.nct)]
    n_delta = dmod.KERNEL.launches
    emb_q, _ = odec_query(eng, wl.batches[0], q)
    assert dmod.KERNEL.launches > n_delta
    assert all(torch.equal(u, v) for u, v in zip(before, (*eng.h, *eng.a, *eng.nct)))
    eng.apply_batch(wl.batches[0])
    torch.testing.assert_close(emb_q, eng.embeddings[torch.from_numpy(q).cuda()],
                               atol=1e-5, rtol=0)


def test_certify_on_card_gives_the_cpu_verdicts(cuda):
    from repro_torch.core import ALL_MODELS, certify, validate_registration

    for name in ALL_MODELS:
        card, cpu = certify(make_model(name)), certify(make_model(name), device="cpu")
        assert (card.distributive, card.invertible, card.aggregate_assoc, card.dest_independent,
                card.struct_independent) == (cpu.distributive, cpu.invertible,
                                             cpu.aggregate_assoc, cpu.dest_independent,
                                             cpu.struct_independent), name
        assert validate_registration(make_model(name)).incrementalizable


# ---------------------------------------------------------------------- #
# the host-resident substrates on the card: offload (pinned staging, the
# hot-row cache) and the chunked backend
# ---------------------------------------------------------------------- #
def _host_engine(backend, name, wl, x, device, **kw):
    return create_engine(backend, EngineConfig(
        model=make_model(name), graph=wl.base, x=x, dims=[16, 16, 16], seed=0,
        device=device, **kw))


def _host_state(eng):
    return [v.cpu().numpy() if torch.is_tensor(v) else np.array(v)
            for kind in ("h", "a", "nct") for v in getattr(eng, kind)]


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_offload_on_card_matches_cpu_and_launches_its_kernels(cuda, name):
    x, wl = _stream()
    gpu, cpu = _host_engine("offload", name, wl, x, "cuda"), _host_engine("offload", name, wl, x,
                                                                           "cpu")
    for i, b in enumerate(wl.batches):
        n_seg, n_delta = smod.KERNEL.launches, dmod.KERNEL.launches
        gpu.apply_batch(b)
        cpu.apply_batch(b)
        assert dmod.KERNEL.launches - n_delta == gpu.L  # step 1, once per layer
        if name == "gat":
            assert smod.KERNEL.launches > n_seg  # step 3's subset_layer
        np.testing.assert_allclose(gpu.embeddings, cpu.embeddings, **TOL, err_msg=f"batch {i}")
    assert gpu.transfers == cpu.transfers


def test_chunked_on_card_matches_cpu(cuda):
    x, wl = _stream()
    gpu = _host_engine("chunked", "gcn", wl, x, "cuda", chunk_size=32)
    cpu = _host_engine("chunked", "gcn", wl, x, "cpu", chunk_size=32)
    for b in wl.batches[:4]:
        n_seg = smod.KERNEL.launches
        gpu.apply_batch(b)
        cpu.apply_batch(b)
        assert smod.KERNEL.launches > n_seg
        np.testing.assert_allclose(gpu.embeddings, cpu.embeddings, **TOL)
    assert gpu.chunk_stats == cpu.chunk_stats


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_offload_on_card_cached_and_sync_are_bitwise(cuda, name):
    from repro_torch.serve import CacheConfig, StagingConfig

    x, wl = _stream()
    runs = [_host_engine("offload", name, wl, x, "cuda", **kw) for kw in (
        {}, {"cache": CacheConfig(capacity_rows=64)},
        {"staging": StagingConfig(async_enabled=False)})]
    stats = [eng.apply_stream(wl.batches) for eng in runs]
    base = _host_state(runs[0])
    for eng in runs[1:]:
        assert all(np.array_equal(u, v) for u, v in zip(base, _host_state(eng)))
    assert stats[1].cache_hit_rows > 0 and stats[1].staged_bytes < stats[0].staged_bytes
    assert (stats[0].prefetch_hits, stats[2].prefetch_hits) == (len(wl.batches) - 1, 0)


def test_offload_staging_buffers_are_pinned(cuda):
    x, wl = _stream()
    eng = _host_engine("offload", "gcn", wl, x, "cuda")
    eng.apply_batch(wl.batches[0])
    bufs = eng.staging.buffers(0)
    assert bufs.pinned and bufs._bufs
    for arr in bufs._bufs.values():
        assert torch.from_numpy(arr).is_pinned()


def test_offload_slow_gather_never_reuses_a_buffer_in_flight(cuda):
    """A gather slowed on the worker shifts every buffer refill against the
    device's copies: the state stays the sync engine's, bit for bit (a
    refill that overran an in-flight copy would corrupt it)."""
    import time

    from repro_torch.serve import StagingConfig

    x, wl = _stream()
    slow = _host_engine("offload", "gat", wl, x, "cuda")
    slow.staging.gather_hook = lambda tag: time.sleep(0.005)
    sync = _host_engine("offload", "gat", wl, x, "cuda", staging=StagingConfig(async_enabled=False))
    slow.apply_stream(wl.batches)
    sync.apply_stream(wl.batches)
    assert all(np.array_equal(u, v) for u, v in zip(_host_state(slow), _host_state(sync)))


# ---------------------------------------------------------------------- #
# the row-sharded engines (S logical shards on the one card)
# ---------------------------------------------------------------------- #
def _sharded(backend, name, wl, x, S, **kw):
    from repro_torch.serve import CommsConfig

    return _host_engine(backend, name, wl, x, "cuda", num_shards=S,
                        comms=CommsConfig(halo=kw.pop("halo", "auto")), **kw)


@pytest.mark.parametrize("S", [1, 3, 8])
def test_sharded_on_card_equals_device_engine(cuda, S):
    """gcn: every h, a and nct bitwise the device engine's on the card, in
    both halo modes; ``delta_agg`` once per shard and layer a batch."""
    x, wl = _stream()
    dev = _host_engine("device", "gcn", wl, x, "cuda")
    dev.apply_stream(wl.batches)
    want = _host_state(dev)
    for halo in ("psum", "ppermute"):
        sh = _sharded("sharded", "gcn", wl, x, S, halo=halo)
        for b in wl.batches:
            n_delta = dmod.KERNEL.launches
            sh.apply_batch(b)
            assert dmod.KERNEL.launches - n_delta == S * sh.L
        assert all(np.array_equal(u, v) for u, v in zip(want, _host_state(sh)))


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_hybrid_on_card_equals_offload_engine(cuda, name):
    """The sharded-offload hybrid at S = 8 bitwise the offload engine on the
    card, psum ≡ ppermute, cached ≡ uncached."""
    from repro_torch.serve import CacheConfig

    x, wl = _stream()
    off = _host_engine("offload", name, wl, x, "cuda")
    off.apply_stream(wl.batches)
    want = _host_state(off)
    for kw in ({"halo": "psum"}, {"halo": "ppermute"},
               {"cache": CacheConfig(capacity_rows=64)}):
        hy = _sharded("sharded_offload", name, wl, x, 8, **kw)
        hy.apply_stream(wl.batches)
        assert all(np.array_equal(u, v) for u, v in zip(want, _host_state(hy))), kw
