"""The port on a CUDA card: each kernel against its plain version, the
engine's invariants with the kernels on its path, and the reduced LM on the
card against the same LM on the CPU.

Every test here needs a card and is marked ``gpu``; on a host without one
each skips with its reason.  The file imports neither ``jax`` nor ``repro``
(a GPU machine need not have them), so on a card it runs as

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: kernel vs plain version 1e-5 (fp32, different summation order);
flash_attention vs its plain version 2e-5/2e-3 in fp32 and 3e-2 in bf16 (the
reference's tests/test_kernels.py); edge_softmax_normalize exactly (one IEEE
division per element on both sides); engine on the card vs the same engine
on the CPU 1e-5 per batch (different matmul kernels); the reduced LM on the
card vs the CPU 1e-4 (fp32 cache and compute); the invariants inside the
port are bitwise.
"""
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
    """3 windows / 12 fused / 3 dispatches; every aggregation state bitwise
    the serial loop's, h within 1e-6: the update's matmul runs on more rows
    in a window and cuBLAS picks its kernel by row count (chip_smoke.py,
    ``TOL_FUSED_CARD``)."""
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
    for u, v in zip([*serial.a, *serial.nct], [*fused.a, *fused.nct]):
        assert torch.equal(u, v)
    for u, v in zip(serial.h, fused.h):
        torch.testing.assert_close(u, v, atol=1e-6, rtol=0)


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
