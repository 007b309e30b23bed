#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # full size: n = 1,000,000 vertices, ~10M edges
    python3 chip_smoke.py --n 20000  # a quick rehearsal at a smaller graph (the LM stays full)

Phases, one JSON line each:

1. build   — compile the four CUDA kernels (``src/repro_torch/csrc``), one
             ``nvcc`` per source, started together; count the tensor-core
             instructions (``HGMMA``) in each library's SASS
             (``cuobjdump --dump-sass``): ``flash_attention`` must have some;
2. engine  — ``create_engine("device", …)`` for gcn and then gat (heads=2) on
             ``make_graph("uniform", n, avg_degree=10, weighted=True)`` with
             128-wide random features and dims [128, 128, 128], driven by a
             6-batch stream (1000 edge updates a batch, 30% deletions,
             feature updates): 2 batches through ``apply_batch``, 4 through
             ``apply_stream`` (traced with ``torch.profiler`` for the device's
             busy time); the final embeddings are held against the
             port's own ``full_forward`` over the post-stream graph at 2e-4.
             Kernel launch counts are zeroed before and read after these
             runs: each kernel must have launched on the main path;
3. edge_softmax_op — the standalone op ``ops.edge_softmax`` (no main path
             calls it) on the base graph's ≈10M in-edges with H = 2 (gat's
             heads), counts zeroed before and read after; held against
             ``kref.edge_softmax_ref`` (normalized 1e-5, sums 1e-4);
4. lm_serve — the LM serving path, ``repro_torch.launch.serve.serve``, on
             llama3.2-1b at full width (16 × 2048, vocab 128,256; random
             weights from a seeded CUDA generator): batch 8, prompt 2048, 32
             greedy decode steps, counts zeroed before and read after
             (``flash_attention`` must launch, 16 times: once per layer of
             the prefill); then a profiled prefill and decode for the
             device-time split (attention kernel, matmuls, the rest);
5. lm_consistency — teacher-forced: prefill of 256 tokens into an fp32
             cache, 4 decode steps, and ``forward`` over the same 260 tokens
             (batch 2); logits within 2e-2 (the reference's own tolerance,
             tests/test_archs_smoke.py);
6. kernels — each kernel against its plain PyTorch version at the shapes its
             path gave it (segment_spmm/delta_agg max |Δ| ≤ 1e-5;
             flash_attention at the prefill shape, atol 2e-5 + rtol 2e-3 in
             fp32 and 3e-2 in bf16; edge_softmax_normalize exactly), timed
             with CUDA events beside its
             plain version, a PyTorch yardstick where one call computes the
             same function (``index_add_``; ``scaled_dot_product_attention``)
             and its bound.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero.  It imports neither ``jax`` nor the
JAX package ``repro``.  Full ``nvcc`` logs go to ``build/repro_torch/logs/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores (data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores (data sheet)
SPLIT_TF32 = 3  # TF32 products per fp32 product in flash_attention (hi·hi + hi·lo + lo·hi)
TOL_KERNEL = 1e-5  # kernel vs plain version: fp32, different summation order
TOL_ENGINE = 2e-4  # engine vs full recompute: the reference's tests/test_backends.py TOL
TOL_ATTN = (2e-5, 2e-3)  # flash vs plain (atol, rtol): the reference's tests/test_kernels.py
TOL_ATTN_BF16 = (3e-2, 3e-2)  # the same in bf16
TOL_SUMS = 1e-4  # edge-softmax sums: the reference's tests/test_kernels.py
TOL_TEACHER = 2e-2  # teacher-forced logits: the reference's tests/test_archs_smoke.py
WIDTH = 128  # the lane width both TPU kernels were tiled for (BD = 128)
GAT_HEADS = 2
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "llama3.2-1b", 8, 2048, 32
KERNEL_INFO = {  # TPU kernel name → its library (csrc/<lib>.cu), source and TPU kernel
    "segment_spmm": {
        "lib": "segment_spmm",
        "source": "src/repro_torch/csrc/segment_spmm.cu",
        "replaces": "src/repro/kernels/segment_spmm.py:131",
    },
    "delta_agg": {
        "lib": "delta_agg",
        "source": "src/repro_torch/csrc/delta_agg.cu",
        "replaces": "src/repro/kernels/delta_agg.py:74",
    },
    "flash_attention": {
        "lib": "flash_attention",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:103",
    },
    "edge_softmax_normalize": {
        "lib": "edge_softmax",
        "source": "src/repro_torch/csrc/edge_softmax.cu",
        "replaces": "src/repro/kernels/edge_softmax.py:60",
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> None:
    from repro_torch.kernels._build import BUILD_DIR, _lib_path, build_all

    libs = [info["lib"] for info in KERNEL_INFO.values()]
    res = build_all(libs)
    logdir = BUILD_DIR / "logs"
    logdir.mkdir(parents=True, exist_ok=True)
    regs = {}
    for name, r in res.items():
        (logdir / f"nvcc_{name}.log").write_text(r["log"])
        regs[name] = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
    hgmma = {name: _sass_count(_lib_path(name), "HGMMA") for name in libs}
    emit({"phase": "build", "seconds": {k: v["seconds"] for k, v in res.items()},
          "ptxas": regs, "sass_hgmma": hgmma})
    if not hgmma["flash_attention"]:
        raise AssertionError("flash_attention's SASS has no HGMMA: it misses the tensor cores")


def _sass_count(lib: Path, opcode: str) -> int:
    """Instructions of one opcode in a library's SASS (``cuobjdump``)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return sum(opcode in ln for ln in sass.splitlines())


def final_features(x: np.ndarray, wl) -> np.ndarray:
    xc = np.array(x)
    for b in wl.batches:
        if b.feat_vertices is not None:
            xc[b.feat_vertices] = b.feat_values
    return xc


def phase_engine(model_name: str, x, wl, seed: int, kernels: dict) -> dict:
    """One run of the main path.  Launch counts are set to 0 just before
    the engine is built and read just after its stream has finished
    (``row["launches"]``); the full_forward check afterwards is not counted."""
    import torch

    from repro_torch.core import full_forward, make_model
    from repro_torch.serve import EngineConfig, create_engine

    model = make_model(model_name)
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = create_engine("device", EngineConfig(
        model=model, graph=wl.base, x=x, dims=[WIDTH, WIDTH, WIDTH], seed=seed,
        device="cuda"))
    eng.synchronize()
    init_s = time.perf_counter() - t0
    per_batch = [eng.apply_batch(b) for b in wl.batches[:2]]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ss = eng.apply_stream(wl.batches[2:])
    launches = {name: k.launches for name, k in kernels.items()}
    busy_s = _device_busy_s(prof)
    emb = eng.embeddings
    if emb.shape != (wl.base.n, WIDTH) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"{model_name}: bad embeddings {tuple(emb.shape)}")
    t1 = time.perf_counter()
    xf = torch.from_numpy(final_features(x, wl)).cuda()
    ref = full_forward(model, eng.params, xf, eng.graph)[-1].h
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t1
    err = float((emb - ref).abs().max())
    row = {
        "phase": f"engine_{model_name}",
        "n": wl.base.n, "edges": wl.base.num_edges, "width": WIDTH, "layers": 2,
        "init_s": init_s, "full_forward_s": ref_s,
        "apply_batch": [{"plan_time_s": b.plan_time_s, "exec_time_s": b.exec_time_s,
                         "graph_time_s": b.graph_time_s, "inc_edges": b.inc_edges,
                         "full_edges": b.full_edges, "out_vertices": b.out_vertices}
                        for b in per_batch],
        "apply_stream_exec_s": [b.exec_time_s for b in ss.batches],
        "stream": ss.as_dict(),
        # the apply_stream above ran traced: device busy time (kernels and
        # copies) over its wall; None when the trace held no device time
        "stream_device_busy_s": busy_s,
        "stream_device_idle_share": None if busy_s is None else 1.0 - busy_s / ss.wall_s,
        "caps": _caps(eng._backend.hwm.snapshot()),
        "state_bytes": eng.state_bytes(),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "max_abs_err_vs_full_forward": err,
        "launches": launches,
    }
    emit(row)
    if not err <= TOL_ENGINE:
        raise AssertionError(f"{model_name}: engine vs full_forward max|Δ| {err} > {TOL_ENGINE}")
    return row


def _device_busy_s(prof):
    """Seconds of device activity in a ``torch.profiler`` trace, or None."""
    from torch.autograd import DeviceType

    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e6 if us > 0 else None


def _caps(snapshot: dict) -> dict:
    """Largest packed-plan capacity per field kind over the layers."""
    names = ("e", "r", "f", "fe", "o")
    out = {}
    for key, cap in snapshot.items():
        if isinstance(key, tuple):
            out[names[key[1]]] = max(out.get(names[key[1]], 0), cap)
    return out


def _bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def kernel_segment_spmm(graph, d: int, gen) -> dict:
    """full_forward's shape: dst-sorted edges, in_indptr offsets, no order."""
    import torch

    from repro_torch.kernels.segment_spmm import segment_spmm, segment_spmm_plain

    e, r = graph.num_edges, graph.n
    row_ptr = torch.from_numpy(graph.in_indptr.astype(np.int64)).cuda()
    dst = torch.repeat_interleave(torch.arange(r, device="cuda"), row_ptr.diff())
    msg = torch.randn(e, d, device="cuda", generator=gen)
    out = segment_spmm(msg, row_ptr, None, r)
    ref = segment_spmm_plain(msg, row_ptr, None, r)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    del out, ref
    ms = cuda_time_ms(lambda: segment_spmm(msg, row_ptr, None, r), 10)
    plain_ms = cuda_time_ms(lambda: segment_spmm_plain(msg, row_ptr, None, r), 3)
    lib_ms = cuda_time_ms(
        lambda: torch.zeros(r, d, device="cuda").index_add_(0, dst, msg), 10)
    bound_ms, by = _bound(e * d * 4 + (r + 1) * 8 + r * d * 4, e * d)
    return {"name": "segment_spmm", "shape": {"E": e, "D": d, "R": r, "order": False},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms}


def _scheduled_inputs(e_cap: int, r_cap: int, live: int, d: int, gen, rng):
    """Records in plan order with row keys in [0, r_cap), a -1 padded tail,
    and their row schedule — the layout the packed plan ships."""
    import torch

    from repro_torch.kernels.segment_spmm import prepare_row_schedule

    keys = np.full(e_cap, -1, np.int64)
    keys[:live] = rng.integers(0, r_cap, live)
    order, row_ptr = prepare_row_schedule(keys, r_cap)
    msg = torch.randn(e_cap, d, device="cuda", generator=gen)
    msg[live:] = 0.0  # padded records are masked to 0 on the main path
    return (keys, msg, torch.from_numpy(order).cuda(), torch.from_numpy(row_ptr).cuda())


def kernel_segment_spmm_subset(fe_cap: int, f_cap: int, d: int, gen, rng) -> dict:
    """subset_layer's shape (gat's constrained path), with a row order."""
    import torch

    from repro_torch.kernels.segment_spmm import segment_spmm, segment_spmm_plain

    live = fe_cap * 3 // 4
    keys, msg, order, row_ptr = _scheduled_inputs(fe_cap, f_cap, live, d, gen, rng)
    out = segment_spmm(msg, row_ptr, order, f_cap)
    ref = segment_spmm_plain(msg, row_ptr, order, f_cap)
    torch.cuda.synchronize()
    return {"name": "segment_spmm", "shape": {"E": fe_cap, "D": d, "R": f_cap, "order": True},
            "max_abs_err": float((out - ref).abs().max()),
            "ms": cuda_time_ms(lambda: segment_spmm(msg, row_ptr, order, f_cap), 100)}


def kernel_delta_agg(e_cap: int, r_cap: int, d: int, gen, rng) -> dict:
    """Step 1 of the incremental layer: the touched rows' state takes the
    scheduled record sums in place."""
    import torch

    from repro_torch.kernels.delta_agg import delta_agg, delta_agg_plain

    live = e_cap * 3 // 4
    keys, msg, order, row_ptr = _scheduled_inputs(e_cap, r_cap, live, d, gen, rng)
    state0 = torch.randn(r_cap, d, device="cuda", generator=gen)
    out = delta_agg(state0.clone(), msg, row_ptr, order)
    ref = delta_agg_plain(state0.clone(), msg, row_ptr, order)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    state = state0.clone()
    ms = cuda_time_ms(lambda: delta_agg(state, msg, row_ptr, order), 200)
    plain_ms = cuda_time_ms(lambda: delta_agg_plain(state, msg, row_ptr, order), 20)
    keys_live = torch.from_numpy(keys[:live]).cuda()
    msg_live = msg[:live].contiguous()
    lib_ms = cuda_time_ms(lambda: state.index_add_(0, keys_live, msg_live), 200)
    touched = int(np.unique(keys[:live]).size)
    nbytes = live * d * 4 + (r_cap + 1) * 4 + live * 4 + 2 * touched * d * 4
    bound_ms, by = _bound(nbytes, live * d)
    return {"name": "delta_agg", "shape": {"E": e_cap, "live": live, "D": d, "R": r_cap,
                                           "touched": touched},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms}


def _in_edges(graph):
    """The base graph's in-edges, dst-sorted: host ids, and on the card the
    ids and the ``in_indptr`` row offsets."""
    import torch

    dst_host = np.repeat(np.arange(graph.n), np.diff(graph.in_indptr))
    return dst_host, torch.from_numpy(dst_host).cuda(), torch.from_numpy(graph.in_indptr).cuda()


def phase_edge_softmax_op(graph, gen, kernels: dict) -> dict:
    """The standalone op ``ops.edge_softmax`` on the base graph's in-edges,
    H = gat's heads.  Counts are set to 0 just before the op and read just
    after; the reference check afterwards is not counted."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    dst_host, dst, _ = _in_edges(graph)
    scores = torch.rand(graph.num_edges, GAT_HEADS, device="cuda", generator=gen).exp_()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    normed, sums = ops.edge_softmax(scores, dst_host, graph.n)
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    n_ref, s_ref = kref.edge_softmax_ref(scores, dst, graph.n)
    row = {"phase": "edge_softmax_op", "E": graph.num_edges, "H": GAT_HEADS, "R": graph.n,
           # host seconds, synchronised: row schedule on the host + both kernels
           "op_s": op_s,
           "max_abs_err_normalized": float((normed - n_ref).abs().max()),
           "max_abs_err_sums": float((sums - s_ref).abs().max()), "launches": launches}
    emit(row)
    if not (row["max_abs_err_normalized"] <= TOL_KERNEL and row["max_abs_err_sums"] <= TOL_SUMS):
        raise AssertionError(f"edge_softmax vs edge_softmax_ref: {row}")
    return row


def _device_split_ms(prof) -> dict:
    """Device milliseconds of a ``torch.profiler`` trace by kernel kind."""
    from torch.autograd import DeviceType

    split = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = e.key.lower()
        kind = ("flash_attention" if "flash_attention" in name else
                "matmul" if any(w in name for w in ("gemm", "gemv", "splitk")) else "other")
        split[kind] += e.self_device_time_total / 1e3
    return split


def _profiled(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall, device time by
    kind, and the device's idle share of the wall."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = _device_split_ms(prof)
    busy = sum(split.values())
    return {"wall_ms": wall_ms, "device_ms": split,
            "device_idle_share": 1.0 - busy / wall_ms if busy > 0 else None}


def phase_lm_serve(seed: int, kernels: dict):
    """One run of the LM serving path at full width.  Counts are set to 0
    just before ``serve`` and read just after it; a short warm-up serve
    before that takes the lazy CUDA/cuBLAS set-up out of the timed run."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_model, prefill

    cfg = get_arch(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    serve(cfg, params, tokens[:, :64], 2)  # warm-up
    for k in kernels.values():
        k.launches = 0
    res = serve(cfg, params, tokens, LM_GEN)
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    out = res.tokens
    if out.shape != (LM_BATCH, LM_GEN + 1) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"lm_serve: bad tokens {tuple(out.shape)}")

    tok_t = torch.from_numpy(tokens).cuda()
    pre = _profiled(lambda: prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN))
    _, cache = prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN)
    first = out[:, :1]

    def decode_steps():
        nonlocal cache
        tok = first
        for _ in range(8):
            logits, cache = decode_step(params, cfg, tok, cache)
            tok = logits[:, -1].argmax(-1, keepdim=True)

    dec = _profiled(decode_steps)
    dec["steps"] = 8
    del cache
    row = {"phase": "lm_serve", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN, "init_s": init_s,
           "prefill_s": res.prefill_s, "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / res.prefill_s,
           "decode_ms_per_token": res.decode_s / LM_GEN * 1e3,
           "decode_tokens_per_s": LM_BATCH * LM_GEN / res.decode_s,
           "peak_mem_bytes": peak, "launches": launches,
           "profiled_prefill": pre, "profiled_decode": dec,
           "sample": out[0, :8].tolist()}
    emit(row)
    if launches["flash_attention"] < cfg.num_layers:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} times "
                             f"on the prefill path, expected {cfg.num_layers}")
    return row, cfg, params


def phase_lm_consistency(cfg, params, seed: int) -> dict:
    """Teacher-forced: prefill into an fp32 cache + decode steps reproduce
    the full forward's logits at the same positions."""
    import torch

    from repro_torch.models import decode_step, forward, prefill

    b, s, steps = 2, 256, 4
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + steps))).cuda()
    full = forward(params, cfg, {"tokens": tokens})
    logits, cache = prefill(params, cfg, {"tokens": tokens[:, :s]}, s_max=s + steps,
                            cache_dtype=torch.float32)
    errs = [float((logits[:, 0] - full[:, s - 1]).abs().max())]
    for i in range(steps):
        logits, cache = decode_step(params, cfg, tokens[:, s + i:s + i + 1], cache)
        errs.append(float((logits[:, 0] - full[:, s + i]).abs().max()))
    row = {"phase": "lm_consistency", "batch": b, "prompt": s, "steps": steps,
           "finite": bool(torch.isfinite(full).all()),
           "max_abs_logit": float(full.abs().max()), "max_abs_err": max(errs), "per_step": errs}
    emit(row)
    if not (row["finite"] and row["max_abs_err"] <= TOL_TEACHER):
        raise AssertionError(f"teacher-forced logits: max|Δ| {row['max_abs_err']} > {TOL_TEACHER}")
    return row


def kernel_flash_attention(cfg, gen, dtype: str = "float32") -> dict:
    """The prefill shape of ``cfg`` (causal, GQA) in fp32, the main path's
    dtype, or in bf16.  The bound is the design's: fp32 runs three TF32
    products per product (split TF32), bf16 one bf16 product."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import flash_attention

    b, hq, hkv, s, dh = (LM_BATCH, cfg.num_heads, cfg.num_kv_heads, LM_PROMPT,
                         cfg.resolved_head_dim)
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, s, dh, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, hkv, s, dh, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, hkv, s, dh, device="cuda", generator=gen).to(dt)
    out = flash_attention(q, k, v, causal=True).float()
    ref = kref.flash_attention_ref(q, k, v, causal=True).float()
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True).float()
    atol, rtol = TOL_ATTN if dtype == "float32" else TOL_ATTN_BF16
    within = bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())
    err, lib_err = float((out - ref).abs().max()), float((lib - ref).abs().max())
    del out, ref, lib
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    plain_ms = cuda_time_ms(lambda: kref.flash_attention_ref(q, k, v, causal=True), 3, warmup=1)
    lib_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True), 10)
    flops = 4 * dh * b * hq * (s * (s + 1) // 2)  # q·k and p·v over the visible pairs
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    if dtype == "float32":
        bound_ms, by = _bound(nbytes, SPLIT_TF32 * flops, TF32_FLOPS)
    else:
        bound_ms, by = _bound(nbytes, flops, BF16_FLOPS)
    row = {"name": "flash_attention",
           "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "dh": dh, "causal": True,
                     "dtype": dtype},
           "max_abs_err": err, "within_tol": within, "library_max_abs_err": lib_err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
           "library_ms": lib_ms, "flops": flops,
           "fp32_simt_bound_ms": flops / FP32_FLOPS * 1e3}
    if dtype != "float32":
        row["variant"] = dtype  # a check beside the main path's dtype, not a summary row
    return row


def kernel_edge_softmax(graph, gen) -> dict:
    """``edge_softmax_normalize`` at the op's shape on the base graph: H =
    gat's heads, sums from ``segment_spmm`` (phase 1).  No single PyTorch
    call computes this function, so there is no library yardstick."""
    import torch

    from repro_torch.kernels.edge_softmax import (
        edge_softmax_normalize,
        edge_softmax_normalize_plain,
    )
    from repro_torch.kernels.segment_spmm import segment_spmm

    _, dst, row_ptr = _in_edges(graph)
    e, r, h = graph.num_edges, graph.n, GAT_HEADS
    scores = torch.rand(e, h, device="cuda", generator=gen).exp_()
    sums = segment_spmm(scores, row_ptr, None, r)
    out = edge_softmax_normalize(scores, dst, sums)
    ref = edge_softmax_normalize_plain(scores, dst, sums)
    err, exact = float((out - ref).abs().max()), bool(torch.equal(out, ref))
    del out, ref
    ms = cuda_time_ms(lambda: edge_softmax_normalize(scores, dst, sums), 50)
    plain_ms = cuda_time_ms(lambda: edge_softmax_normalize_plain(scores, dst, sums), 10)
    nbytes = 2 * e * h * 4 + e * dst.element_size() + r * h * 4
    bound_ms, by = _bound(nbytes, e * h)
    return {"name": "edge_softmax_normalize", "shape": {"E": e, "H": h, "R": r},
            "max_abs_err": err, "within_tol": exact,  # the same IEEE division: bit for bit
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes the gather-and-divide"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="vertices (default 1,000,000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch.device import set_fp32_precision
        from repro_torch.graph import make_graph, make_stream, random_features
        from repro_torch.kernels import delta_agg as dmod
        from repro_torch.kernels import edge_softmax as emod
        from repro_torch.kernels import flash_attention as fmod
        from repro_torch.kernels import segment_spmm as smod
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2
    set_fp32_precision()
    kernels = {"segment_spmm": smod.KERNEL, "delta_agg": dmod.KERNEL,
               "flash_attention": fmod.KERNEL, "edge_softmax_normalize": emod.KERNEL}

    phase_build()

    t0 = time.perf_counter()
    graph = make_graph("uniform", args.n, avg_degree=10, seed=args.seed, weighted=True)
    x, _ = random_features(args.n, WIDTH, seed=args.seed)
    wl = make_stream(graph, num_batches=6, batch_edges=1000, delete_frac=0.3,
                     feature_dim=WIDTH, feature_frac=1e-4, seed=args.seed + 1)
    emit({"phase": "data", "n": args.n, "edges": graph.num_edges,
          "base_edges": wl.base.num_edges, "setup_s": time.perf_counter() - t0})

    # each path: counts set to 0 just before it is driven, read just after
    engine_rows = [phase_engine(m, x, wl, args.seed, kernels) for m in ("gcn", "gat")]
    gnn = {name: sum(row["launches"][name] for row in engine_rows)
           for name in ("segment_spmm", "delta_agg")}
    emit({"phase": "main_path_launches", **gnn})
    for name, cnt in gnn.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    es = phase_edge_softmax_op(wl.base, gen, kernels)
    lm, cfg, params = phase_lm_serve(args.seed, kernels)
    phase_lm_consistency(cfg, params, args.seed)
    del params
    launches = {**gnn, "flash_attention": lm["launches"]["flash_attention"],
                "edge_softmax_normalize": es["launches"]["edge_softmax_normalize"]}
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on its path")

    # kernels at the shapes their paths used (GNN: largest layer caps over both runs)
    caps = {k: max(row["caps"][k] for row in engine_rows) for k in ("e", "r", "f", "fe")}
    rng = np.random.default_rng(args.seed)
    results = [
        kernel_segment_spmm(wl.base, WIDTH + 1, gen),  # gcn: [ctx (1) | raw (128)]
        kernel_segment_spmm_subset(caps["fe"], caps["f"], WIDTH + 2, gen, rng),  # gat
        kernel_delta_agg(caps["e"], caps["r"], WIDTH + 1, gen, rng),
        kernel_flash_attention(cfg, gen),
        kernel_flash_attention(cfg, gen, "bfloat16"),
        kernel_edge_softmax(wl.base, gen),
    ]
    for res in results:
        emit({"phase": "kernel", **res})
        ok = res.get("within_tol", res["max_abs_err"] <= TOL_KERNEL)
        if not ok:
            raise AssertionError(f"{res['name']}: kernel vs plain max|Δ| {res['max_abs_err']}")

    summary = []
    for res in results:
        if "plain_ms" not in res or "variant" in res:
            continue
        name = res["name"]
        info = {k: KERNEL_INFO[name][k] for k in ("source", "replaces")}
        entry = {"name": name, "route": "cuda", **info,
                 "launches": launches[name], "max_abs_err": res["max_abs_err"],
                 "ms": res["ms"], "plain_ms": res["plain_ms"],
                 "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                 "library_ms": res["library_ms"]}
        if "fp32_simt_bound_ms" in res:
            entry["fp32_simt_bound_ms"] = res["fp32_simt_bound_ms"]
        others = [{k: r[k] for k in ("variant", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}
                  for r in results if r["name"] == name and "variant" in r]
        if others:
            entry["variants"] = others
        summary.append(entry)
    emit({"kernels": summary})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
