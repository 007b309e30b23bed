#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # full size: n = 1,000,000 vertices, ~10M edges
    python3 chip_smoke.py --n 20000  # a quick rehearsal at smaller graphs (the LM stays full)

Phases, one JSON line each:

1. build   — compile the six CUDA kernel libraries (``src/repro_torch/csrc``),
             one ``nvcc`` per source, started together; count the tensor-core
             instructions (``HGMMA``) in each library's SASS
             (``cuobjdump --dump-sass``): ``flash_attention`` and
             ``flash_attention_bwd`` must have some, and ptxas must report no
             spills for ``flash_attention_bwd``;
2. engine  — ``create_engine("device", …)`` for gcn and then gat (heads=2) on
             ``make_graph("uniform", n, avg_degree=10, weighted=True)`` with
             128-wide random features and dims [128, 128, 128], driven by a
             6-batch stream (1000 edge updates a batch, 30% deletions,
             feature updates): 2 batches through ``apply_batch``, 4 through
             ``apply_stream`` (traced with ``torch.profiler`` for the device's
             busy time); the final embeddings are held against the
             port's own ``full_forward`` over the post-stream graph at 2e-4.
             Kernel launch counts are zeroed before and read after these
             runs: each GNN kernel (``delta_agg``, ``segment_spmm``,
             ``row_linear``: every model product) must have launched on the
             main path;
2b. engine_skewed — ``create_engine("device", …)`` for gcn on a graph whose
             in-degrees are ``zipf_in_indptr(n, seed)`` (sources uniform,
             duplicates and self-loops removed; hub rows of 10^4 to 10^5
             in-edges, which the uniform graph lacks), widths as above, init
             and 2 batches of 1000 updates through ``apply_batch``, held
             against ``full_forward`` at 2e-4; counts zeroed before and read
             after: ``segment_spmm`` (init) and ``delta_agg`` must launch;
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
5b. lm_train — the LM training path, ``repro_torch.train.trainer.Trainer.train``,
             on llama3.2-1b at full width (fp32 params, bf16 compute, remat;
             random weights from a seeded CUDA generator; the serve phase's
             weights freed first): 4 AdamW steps of 4 × 2048 synthetic
             tokens, ``OptConfig(peak_lr=3e-3, warmup_steps=10,
             stable_steps=4, decay_steps=10)`` as ``launch/train.py`` sets
             them; counts zeroed before and read after: the forward
             ``flash_attention`` at least twice a layer a step (remat
             recomputes it) and each backward entry (dQ, dK/dV) once a layer
             a step; every loss finite; seconds a step, tokens/s, peak
             memory, model FLOPs a step beside the fp32 peak; then one
             profiled step for the device-time split;
5c. lm_train_consistency — the same config at 2 layers (full width), batch 1
             × 512, weights made with numpy from the seed: ``loss_fn`` and
             every gradient leaf on the card (the kernels) against the CPU
             (the plain versions), loss within 1e-4 relative and each leaf's
             max |Δ| within 1e-3 of its largest entry (the embedding, whose
             gathered rows' gradient is rounded to bf16 on the way, within
             2^-7, one bf16 step; under compute_dtype fp32, where nothing
             rounds it, within 1e-3 too);
5d. lm_moe_serve — the serving path on the MoE family: qwen3-moe-30b-a3b at
             full width (d_model 2048, 32/4 heads of 128, QK norm, 128 experts,
             top-8, expert width 768, vocab 151,936; fp32 params, bf16
             compute and KV cache; random weights from a seeded CUDA
             generator), cut in depth from 48 to 12 layers (48 are 122 GB in
             fp32): batch 8, prompt 2048, 32 greedy steps through ``serve``,
             counts zeroed before and read after; then a prefill alone, counted
             the same way (``flash_attention`` and ``segment_spmm``, the MoE
             combine, must each launch at least once a layer), with the
             assignments each layer's capacity (161 tokens an expert and batch
             row) kept and dropped; a profiled prefill and decode (matmuls,
             attention, the combine, the rest);
5e. lm_moe_consistency — the same weights at dropless capacity
             (``capacity_factor = E / top_k``: which tokens overflow depends
             on the context): teacher-forced as in phase 5, within 2e-2;
6. kernels — each kernel against its plain PyTorch version at the shapes its
             path gave it (segment_spmm/delta_agg max |Δ| ≤ 1e-5;
             flash_attention at the prefill shape, atol 2e-5 + rtol 2e-3 in
             fp32 and 3e-2 in bf16; edge_softmax_normalize exactly;
             ``flash_attention_lse``'s o bitwise ``flash_attention``'s and its
             lse against ``flash_attention_lse_ref`` at the forward's
             tolerance; ``flash_attention_bwd`` at the training shape (B 4,
             Hq 32, Hkv 8, S 2048, dh 64, causal) in fp32 against
             ``flash_attention_bwd_ref`` at atol 2e-5 + rtol 2e-3 and in bf16
             (a variant row) at 3e-2, each with a second launch bitwise the
             first, timed beside the backward of
             ``scaled_dot_product_attention`` in the same dtype;
             row_linear ≤ 1e-5 at M = n, where the wrapper takes the tiled
             kernel, and bitwise the general kernel there, at gat's per-edge
             M = E and at the incremental step's row cap; rows of
             ``A[:m] @ W`` bitwise rows of ``A @ W`` for m from 1 to 20,000,
             across the wrapper's switch between the two kernels, at K = N =
             128 and K = 256), timed with CUDA events beside its plain
             version, a PyTorch yardstick where one call computes the same
             function (``index_add_``; ``scaled_dot_product_attention``;
             ``torch.matmul``) and its bound; ``segment_spmm`` and
             ``delta_agg`` also at a skewed shape (a Zipf in-degree sequence
             over n rows, ≈ 10M records, hub rows of 10^4 to 10^5 records;
             integer-valued messages, so every summation order is exact and
             each kernel must equal its plain version bit for bit; and
             Gaussian messages, where each kernel must equal
             ``row_sum_chunked_plain``, the kernels' documented order of
             additions, bit for bit).  The two row-sum kernels' rows carry
             their share of the bound and the longest chain a warp walks
             (``longest_chain_records``, at most ``ROW_SUM_CHUNK``) beside
             the most chunk sums a row adds (``most_chunks_a_row``), and
             the wrapper's host time a call (``host_us_per_call``: where it
             reaches ``ms``, the timed loop is host-bound).

The serving layer of the GNN engine runs on its own
``make_graph("uniform", 100_000, avg_degree=10, weighted=True)`` graph
(≈ 1M edges, features and dims 128, 2 layers; ``--n`` below 100,000 shrinks it too),
with launch counts zeroed before each phase and read after its drives,
before its checks against ``full_forward``:

7. policy — the three ``ADVERSARIAL_REGIMES`` at the reference's size (n =
             256, 6 batches, one layer; features 128): decision counts and
             ``policy_edges`` equal to ``BENCH_baseline.json``'s, and the
             forced replay of each mixed schedule bitwise equal; then on the
             100k graph, gcn, 6 batches of 1000 edge updates:
             ``policy="adaptive"``, the forced replay of its decisions
             (bitwise equal), and a forced incremental/chunked/full schedule
             (the chunked and full modes at full size, with the chunked
             mode's layer-to-host copy timed), each within 2e-4 of
             ``full_forward``.  Launches are counted per batch: every
             chunked or full batch must launch ``segment_spmm``, every
             incremental one on the 100k graph ``delta_agg``;
8. fusion_frontend — the reference's ring-lattice fusion cell at n =
             100,000: 12 single-edge batches 45 rows apart under
             ``FusionConfig(window=4)``: exactly 3 windows, 12 fused batches,
             3 dispatches; the same state as the serial loop, every h, a and
             nct bitwise (``row_linear``'s rows do not depend on how many
             rows a window puts into the update's product); then a
             ``ServingFrontend`` on the reference's 6-batch read schedule:
             10 reads, 8 batches of staleness, every read bitwise equal to
             the snapshot at its pinned version;
9. storage — ``store_h=False`` (paper §V-B) against ``store_h=True`` on the
             same stream: within 2e-4 of each other and of
             ``full_forward``; the ``state_bytes()`` ratio;
10. baselines_odec — gcn and gat over 3 batches of 100 edge updates:
             ``RTECFull`` and ``RTECUER`` within 2e-4 of ``full_forward``,
             ``RTECSample(fanout=10)`` finite, ``MTECPeriod(period=3)`` stale
             then fresh, edges processed Inc < UER ≤ Full, per-batch times
             beside the engine's; ``odec_query`` for 64 vertices within 1e-5
             of the committed engine with the engine's state unchanged;
             ``validate_registration`` over all 11 models;
11. offload — ``create_engine("offload")`` (host-resident state, pinned
             async staging) for gcn and gat (heads 2) on the 6-batch stream
             through ``apply_stream``, each within 2e-4 of ``full_forward``;
             gcn with ``StagingConfig(async_enabled=False)`` bitwise equal to
             async (``prefetch_hits`` 5 and 0); gcn on the device engine
             bitwise equal (the equal tensors printed); transfer
             rows, staged bytes, staging waits, exec seconds a batch, and the
             stream's peak device bytes beside the device engine's state
             bytes, with each batch's largest staged layer (rows, buffer
             bytes); gcn again on 3 batches of 10 updates, where the
             affected rows are a small share of V.  Every batch must launch
             ``delta_agg`` once per layer, and gat's ``segment_spmm`` too;
12. hot_cache — the reference's exact counters at its own sizes: the fig7
             smoke cell (2970 transfer rows, 145,560 staged bytes, 5 prefetch
             hits) and the hub_burst cell (580/504/0 hits/misses/evictions,
             61,648 staged bytes against 107,968 uncached, cached ≡
             uncached); then gcn at full width with
             ``CacheConfig(capacity_rows=8192, prewarm_rows=8192)`` bitwise
             equal to uncached, each run's stream peak device bytes printed;
13. chunked_backend — ``create_engine("chunked", chunk_size=8192)`` on the
             stream's first 3 batches within 2e-4 of ``full_forward``, every
             batch launching ``segment_spmm``; then the ring cell of phase 8
             through a fused window on the offload engine: 3/12/3, every
             tensor bitwise the serial offload loop's;
14. sharded — ``create_engine("sharded")`` with S logical shards on the
             card (the loopback exchange): the reference's fig7 sharded
             cell at its own size (powerlaw n = 300, dims [16, 16], S = 8):
             ``halo_rows_sent`` 157 under ppermute and 584 under psum
             (``benchmarks/check_regression.py`` ``COMMS_EXPECTED``), psum ≡
             ppermute ≡ the device engine bitwise; then the serving graph at
             full width, gcn and gat at S = 8 and S = 1: gcn bitwise the
             device engine, gat within 2e-4 of ``full_forward``; every
             batch launches ``delta_agg`` once per shard and layer, init
             ``segment_spmm``; exec seconds a batch, halo rows and bytes,
             state bytes;
15. sharded_offload — ``create_engine("sharded_offload")`` at S = 8: the
             fig7 cell's 731 transfer rows a shard, 470,016 staged bytes and
             5 prefetch hits; hub_burst cached 616/532/0 (``CACHE_EXPECTED``)
             and bitwise the uncached run; at full width gcn and gat bitwise
             the offload engine, psum ≡ ppermute; staged bytes, transfer rows
             a shard, ``sync_wait_s``, and the stream's peak device bytes
             beside the offload engine's.

The kernel checks include ``delta_agg`` at the offload path's largest
compact shape (a variant beside the engine's), ``segment_spmm`` at the MoE
combine's prefill shape on the records phase 5d's first layer gave it (16,384
rows, 164,864 records, D 2048; also bitwise ``row_sum_chunked_plain`` and
bitwise from launch to launch; timed beside ``index_add_``), and
``flash_attention`` at the MoE prefill's shape (Hq 32, Hkv 4, dh 128).  Then a ``{"kernels":
[...]}`` line (launches summed over every path that launched each kernel),
the ``nvidia-smi`` name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero.  It imports neither ``jax`` nor the
JAX package ``repro``.  Full ``nvcc`` logs go to ``build/repro_torch/logs/``.
"""
from __future__ import annotations

import argparse
import dataclasses
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
TOL_ODEC = 1e-5  # ODEC vs the committed engine: the reference's tests/test_baselines.py
TOL_STALE = 1e-6  # MTEC between refreshes vs its initial state: tests/test_baselines.py
#: per-regime adaptive decisions (incremental, chunked, full) and policy_edges,
#: the rows ``adversarial/<regime>/policy_*`` of BENCH_baseline.json
ADVERSARIAL_EXPECTED = {"hub_burst": (4, 0, 2, 3168), "delete_heavy": (3, 0, 3, 1608),
                        "feature_churn": (3, 3, 0, 4524)}
FORCED_SCHEDULE = ("incremental", "chunked", "full", "incremental", "chunked", "full")
SERVE_N = 100_000  # vertices of the serving phases' graph (at most --n)
WIDTH = 128  # the lane width both TPU kernels were tiled for (BD = 128)
GAT_HEADS = 2
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "llama3.2-1b", 8, 2048, 32
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 2048  # lm_train: 8,192 tokens a step
CONSIST_LAYERS, CONSIST_SEQ = 2, 512  # lm_train_consistency: 2 layers, batch 1 × 512
#: lm_moe_serve: qwen3-moe-30b-a3b at full width, cut in depth 48 → 12 layers (all 48 are
#: 30.5B parameters, 122 GB in fp32, more than the card's 80 GB; 12 are 8.10B, 32.4 GB)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-30b-a3b", 12
TOL_TRAIN_LOSS = 1e-4  # lm_train_consistency: loss, relative
TOL_TRAIN_GRAD = 1e-3  # lm_train_consistency: each leaf's max |Δ| / its max |entry|
#: the same for the embedding under compute_dtype bf16: the gradient of its gathered rows
#: is rounded to bf16 (the backward of the cast to compute_dtype), where one bf16 step is
#: 2^-8 to 2^-7 of a value; the card and the CPU round sums taken in other orders, so
#: an entry may land one step apart (measured: 2.4e-3 of the largest entry, PERF.md)
TOL_TRAIN_GRAD_BF16_CAST = 2.0 ** -7
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
    "flash_attention_bwd": {  # no TPU kernel: the Pallas flash kernel has no VJP
        "lib": "flash_attention_bwd",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "none (the JAX package differentiates src/repro/kernels/ref.py "
                    "flash_attention_ref; the Pallas flash_attention at "
                    "src/repro/kernels/flash_attention.py:103 has no backward)",
    },
    "row_linear": {  # no TPU kernel: the models' fp32 products, left to XLA by the reference
        "lib": "row_linear",
        "source": "src/repro_torch/csrc/row_linear.cu",
        "replaces": "none (port-only: the dense products of src/repro/core/models.py)",
    },
}
#: row_linear's row-count probe: the wrapper switches from the general to the tiled
#: kernel at 16,896 rows (``kernels/row_linear.py`` ``TILED_MIN_ROWS``)
ROW_COUNTS = (1, 2, 15, 16, 17, 32, 33, 1000, 16_895, 16_896, 20_000)
ZIPF_EXPONENT, ZIPF_MAX_DEGREE = 1.97, 100_000  # the skewed kernel shape: zipf_in_indptr
SHARDS = 8  # logical shards of the sharded phases (the reference's CI mesh)


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


def host_us_per_call(fn, iters: int) -> float:
    """The host time of a call of ``fn`` (enqueue only, not synchronised).
    Where it reaches the time :func:`cuda_time_ms` reads for the same
    calls, back-to-back calls are host-bound and that time is the host's
    rate, not the kernel's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / iters * 1e6


def phase_build() -> None:
    from repro_torch.kernels._build import BUILD_DIR, _lib_path, build_all

    libs = [info["lib"] for info in KERNEL_INFO.values()]
    res = build_all(libs)
    logdir = BUILD_DIR / "logs"
    logdir.mkdir(parents=True, exist_ok=True)
    regs, spills = {}, {}
    for name, r in res.items():
        (logdir / f"nvcc_{name}.log").write_text(r["log"])
        lines = [ln.strip() for ln in r["log"].splitlines()]
        regs[name] = [ln for ln in lines if "registers" in ln]
        spills[name] = [ln for ln in lines if "spill" in ln and "0 bytes spill stores, 0 bytes "
                        "spill loads" not in ln]  # the kernels that spill, if any
    hgmma = {name: _sass_count(_lib_path(name), "HGMMA") for name in libs}
    emit({"phase": "build", "seconds": {k: v["seconds"] for k, v in res.items()},
          "ptxas": regs, "ptxas_spills": spills, "sass_hgmma": hgmma})
    for name in ("flash_attention", "flash_attention_bwd"):
        if not hgmma[name]:
            raise AssertionError(f"{name}'s SASS has no HGMMA: it misses the tensor cores")
    if spills["flash_attention_bwd"]:
        raise AssertionError(f"flash_attention_bwd spills: {spills['flash_attention_bwd']}")


def _sass_count(lib: Path, opcode: str) -> int:
    """Instructions of one opcode in a library's SASS (``cuobjdump``)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return sum(opcode in ln for ln in sass.splitlines())


def final_features(x: np.ndarray, batches) -> np.ndarray:
    """The features after ``batches``' feature updates."""
    xc = np.array(x)
    for b in batches:
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
        k.reset_counts()
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
    xf = torch.from_numpy(final_features(x, wl.batches)).cuda()
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


def skewed_graph(n: int, seed: int):
    """A graph whose in-degrees are ``zipf_in_indptr(n, seed)``: each
    in-edge's source uniform over the vertices, duplicate edges and
    self-loops removed, weights uniform in [0.5, 1.5) (as ``make_graph``'s
    ``weighted``)."""
    from repro_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(seed + 2)
    indptr = zipf_in_indptr(n, seed)
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    src = rng.integers(0, n, len(dst), dtype=np.int64)
    key = np.unique((dst * n + src)[src != dst])
    w = rng.uniform(0.5, 1.5, len(key)).astype(np.float32)
    return CSRGraph.from_edges(n, key % n, key // n, w)


def phase_engine_skewed(n: int, seed: int, kernels: dict, uniform: dict) -> dict:
    """gcn on the skewed graph: init and 2 batches through ``apply_batch``.
    Counts are set to 0 just before the engine is built and read just after
    its batches; the full_forward check afterwards is not counted.  The
    uniform graph's gcn run (``uniform``) is printed beside it."""
    import torch

    from repro_torch.core import full_forward, make_model
    from repro_torch.graph import make_stream, random_features
    from repro_torch.serve import EngineConfig, create_engine

    t0 = time.perf_counter()
    graph = skewed_graph(n, seed)
    x, _ = random_features(n, WIDTH, seed=seed)
    wl = make_stream(graph, num_batches=2, batch_edges=1000, delete_frac=0.3,
                     feature_dim=WIDTH, feature_frac=1e-4, seed=seed + 1)
    setup_s = time.perf_counter() - t0
    del graph
    model = make_model("gcn")
    _zero_counts(kernels)
    t0 = time.perf_counter()
    eng = create_engine("device", EngineConfig(
        model=model, graph=wl.base, x=x, dims=[WIDTH, WIDTH, WIDTH], seed=seed,
        device="cuda"))
    eng.synchronize()
    init_s = time.perf_counter() - t0
    per_batch = [eng.apply_batch(b) for b in wl.batches]
    launches = _counts(kernels)
    emb = eng.embeddings
    if emb.shape != (n, WIDTH) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"engine_skewed: bad embeddings {tuple(emb.shape)}")
    xf = torch.from_numpy(final_features(x, wl.batches)).cuda()
    err = float((emb - full_forward(model, eng.params, xf, eng.graph)[-1].h).abs().max())
    in_deg = np.diff(wl.base.in_indptr)
    row = {
        "phase": "engine_skewed", "model": "gcn", "n": n, "edges": wl.base.num_edges,
        "max_in_degree": int(in_deg.max()), "rows_over_512": int((in_deg > 512).sum()),
        "width": WIDTH, "layers": 2, "setup_s": setup_s, "init_s": init_s,
        "apply_batch": [_batch_row(b) for b in per_batch],
        "uniform_gcn": {"init_s": uniform["init_s"],
                        "exec_time_s": [b["exec_time_s"] for b in uniform["apply_batch"]]},
        "max_abs_err_vs_full_forward": err, "launches": launches,
    }
    emit(row)
    _require_launched(row, ("segment_spmm", "delta_agg"))
    if not err <= TOL_ENGINE:
        raise AssertionError(f"engine_skewed: vs full_forward max|Δ| {err} > {TOL_ENGINE}")
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


def _messages(e: int, d: int, gen, integer: bool = False):
    """Gaussian messages, or with ``integer`` whole numbers in [-8, 8]: every
    partial sum of up to 10^6 of them is exact in fp32, so every summation
    order gives the same bits and a kernel is held to its plain version
    exactly, whatever the number of records a row (the skewed shape's hubs
    sum 10^5; with Gaussian messages two fp32 orders differ there by ~1e-2)."""
    import torch

    if integer:
        return torch.randint(-8, 9, (e, d), device="cuda", generator=gen).float()
    return torch.randn(e, d, device="cuda", generator=gen)


def _chains(max_records_a_row: int) -> dict:
    """The row-sum kernels' serial work at a shape: the longest chain one
    warp walks and the most chunk sums pass 2 adds for one row."""
    from repro_torch.kernels.segment_spmm import ROW_SUM_CHUNK

    return {"longest_chain_records": min(max_records_a_row, ROW_SUM_CHUNK),
            "most_chunks_a_row": -(-max_records_a_row // ROW_SUM_CHUNK)}


def kernel_segment_spmm(in_indptr: np.ndarray, d: int, gen, iters: int = 10,
                        integer: bool = False) -> dict:
    """full_forward's shape: dst-sorted edges, ``in_indptr`` offsets, no order
    (``integer``: see :func:`_messages`)."""
    import torch

    from repro_torch.kernels.segment_spmm import segment_spmm, segment_spmm_plain

    r, e = len(in_indptr) - 1, int(in_indptr[-1])
    row_ptr = torch.from_numpy(in_indptr.astype(np.int64)).cuda()
    dst = torch.repeat_interleave(torch.arange(r, device="cuda"), row_ptr.diff())
    msg = _messages(e, d, gen, integer)
    out = segment_spmm(msg, row_ptr, None, r)
    ref = segment_spmm_plain(msg, row_ptr, None, r)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    del out, ref
    ms = cuda_time_ms(lambda: segment_spmm(msg, row_ptr, None, r), iters)
    plain_ms = cuda_time_ms(lambda: segment_spmm_plain(msg, row_ptr, None, r), 3)
    lib_ms = cuda_time_ms(
        lambda: torch.zeros(r, d, device="cuda").index_add_(0, dst, msg), iters)
    host_us = host_us_per_call(lambda: segment_spmm(msg, row_ptr, None, r), iters)
    bound_ms, by = _bound(e * d * 4 + (r + 1) * 8 + r * d * 4, e * d)
    longest = int(np.diff(in_indptr).max())
    return {"name": "segment_spmm", "shape": {"E": e, "D": d, "R": r, "order": False,
                                              "max_records_a_row": longest, **_chains(longest)},
            "max_abs_err": err, **({"within_tol": err == 0.0, "values": "integers"}
                                   if integer else {}),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bound_share": bound_ms / ms, "library_ms": lib_ms,
            "host_us_per_call": host_us}


def _uniform_keys(e_cap: int, r_cap: int, live: int, rng) -> np.ndarray:
    """``live`` record keys uniform over ``[0, r_cap)`` and a -1 padded tail,
    as the packed plan ships them."""
    keys = np.full(e_cap, -1, np.int64)
    keys[:live] = rng.integers(0, r_cap, live)
    return keys


def zipf_in_indptr(n: int, seed: int) -> np.ndarray:
    """Row offsets of a skewed in-degree sequence over ``n`` rows: Zipf
    degrees (exponent ``ZIPF_EXPONENT``) clipped at ``ZIPF_MAX_DEGREE``, so at
    n = 1M about 10M records with hub rows of 10^4 to 10^5.  Built from the
    degrees directly: the preferential-attachment generator is quadratic in
    n on the host."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(ZIPF_EXPONENT, n), ZIPF_MAX_DEGREE)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr


def _scheduled_inputs(keys: np.ndarray, r_cap: int, d: int, gen, integer: bool = False):
    """Messages for records with row ``keys`` (-1: padding) and their row
    schedule — the layout the packed plan ships."""
    import torch

    from repro_torch.kernels.segment_spmm import prepare_row_schedule

    order, row_ptr = prepare_row_schedule(keys, r_cap)
    msg = _messages(len(keys), d, gen, integer)
    msg[torch.from_numpy(keys < 0).cuda()] = 0.0  # padded records are masked to 0 on the main path
    return msg, torch.from_numpy(order).cuda(), torch.from_numpy(row_ptr).cuda()


def kernel_segment_spmm_subset(fe_cap: int, f_cap: int, d: int, gen, rng) -> dict:
    """subset_layer's shape (gat's constrained path), with a row order."""
    import torch

    from repro_torch.kernels.segment_spmm import segment_spmm, segment_spmm_plain

    msg, order, row_ptr = _scheduled_inputs(
        _uniform_keys(fe_cap, f_cap, fe_cap * 3 // 4, rng), f_cap, d, gen)
    out = segment_spmm(msg, row_ptr, order, f_cap)
    ref = segment_spmm_plain(msg, row_ptr, order, f_cap)
    torch.cuda.synchronize()
    return {"name": "segment_spmm", "shape": {"E": fe_cap, "D": d, "R": f_cap, "order": True},
            "max_abs_err": float((out - ref).abs().max()),
            "ms": cuda_time_ms(lambda: segment_spmm(msg, row_ptr, order, f_cap), 100),
            "host_us_per_call": host_us_per_call(
                lambda: segment_spmm(msg, row_ptr, order, f_cap), 100)}


def kernel_delta_agg(keys: np.ndarray, r_cap: int, d: int, gen, iters: int = 200,
                     integer: bool = False) -> dict:
    """Step 1 of the incremental layer: the touched rows' state takes the
    scheduled record sums in place (records with key -1 are padding;
    ``integer``: see :func:`_messages`, the state too)."""
    import torch

    from repro_torch.kernels.delta_agg import delta_agg, delta_agg_plain

    msg, order, row_ptr = _scheduled_inputs(keys, r_cap, d, gen, integer)
    live_keys = keys[keys >= 0]
    live = len(live_keys)
    state0 = _messages(r_cap, d, gen, integer)
    out = delta_agg(state0.clone(), msg, row_ptr, order)
    ref = delta_agg_plain(state0.clone(), msg, row_ptr, order)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    del out, ref
    state = state0.clone()
    ms = cuda_time_ms(lambda: delta_agg(state, msg, row_ptr, order), iters)
    plain_ms = cuda_time_ms(lambda: delta_agg_plain(state, msg, row_ptr, order),
                            max(3, iters // 10))
    keys_live = torch.from_numpy(live_keys).cuda()
    msg_live = msg[torch.from_numpy(keys >= 0).cuda()]
    lib_ms = cuda_time_ms(lambda: state.index_add_(0, keys_live, msg_live), iters)
    host_us = host_us_per_call(lambda: delta_agg(state, msg, row_ptr, order), iters)
    counts = np.bincount(live_keys, minlength=r_cap)
    touched = int((counts > 0).sum())
    nbytes = live * d * 4 + (r_cap + 1) * 4 + live * 4 + 2 * touched * d * 4
    bound_ms, by = _bound(nbytes, live * d)
    longest = int(counts.max())
    return {"name": "delta_agg", "shape": {"E": len(keys), "live": live, "D": d, "R": r_cap,
                                           "touched": touched, "max_records_a_row": longest,
                                           **_chains(longest)},
            "max_abs_err": err, **({"within_tol": err == 0.0, "values": "integers"}
                                   if integer else {}),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bound_share": bound_ms / ms, "library_ms": lib_ms,
            "host_us_per_call": host_us}


def kernel_row_sum_chunked(in_indptr: np.ndarray, keys: np.ndarray, d: int, gen) -> list:
    """Both row-sum kernels at a skewed shape with Gaussian messages, where
    two summation orders of a hub row differ: each is held bit for bit to
    ``row_sum_chunked_plain``, the order ``csrc/row_sum.cuh`` documents
    (``segment_spmm`` on dst-sorted records, ``delta_agg`` on records with
    row ``keys`` in a random order and their row schedule)."""
    import torch

    from repro_torch.kernels.delta_agg import delta_agg
    from repro_torch.kernels.segment_spmm import (
        ROW_SUM_CHUNK,
        row_sum_chunked_plain,
        segment_spmm,
    )

    rows = []
    r, e = len(in_indptr) - 1, int(in_indptr[-1])
    row_ptr = torch.from_numpy(in_indptr.astype(np.int64)).cuda()
    msg = _messages(e, d, gen)
    out = segment_spmm(msg, row_ptr, None, r)
    ref = row_sum_chunked_plain(msg, row_ptr, None, ROW_SUM_CHUNK)
    rows.append(("segment_spmm", {"E": e, "D": d, "R": r, "order": False}, out, ref))
    del msg
    msg, order, row_ptr = _scheduled_inputs(keys, r, d, gen)
    state0 = _messages(r, d, gen)
    out = delta_agg(state0.clone(), msg, row_ptr, order)
    ref = state0
    touched = row_ptr[1:] != row_ptr[:-1]
    ref[touched] += row_sum_chunked_plain(msg, row_ptr, order, ROW_SUM_CHUNK)[touched]
    rows.append(("delta_agg", {"E": len(keys), "D": d, "R": r, "order": True}, out, ref))
    del msg
    torch.cuda.synchronize()
    return [{"name": name, "variant": "zipf_gaussian", "shape": shape,
             "max_abs_err": float((out - ref).abs().max()),
             "within_tol": bool(torch.equal(out, ref)), "values": "gaussian",
             "held_to": "row_sum_chunked_plain, bitwise"}
            for name, shape, out, ref in rows]


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
        k.reset_counts()
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


def _zero_counts(kernels: dict) -> None:
    import torch

    for k in kernels.values():
        k.reset_counts()
    torch.cuda.synchronize()


def _counts(kernels: dict) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def _require_launched(row: dict, names) -> None:
    for name in names:
        if row["launches"][name] <= 0:
            raise AssertionError(f"{row['phase']}: {name} was not launched")


def _layer_params(model, seed: int):
    """dims [128, 128, 128] from a seeded CPU generator, on the card."""
    import torch

    return model.init_layers(torch.Generator().manual_seed(seed), [WIDTH] * 3, device="cuda")


def _err_vs_full_forward(emb, model, params, x_final: np.ndarray, graph) -> float:
    import torch

    from repro_torch.core import full_forward

    ref = full_forward(model, params, torch.from_numpy(x_final).cuda(), graph)[-1].h
    return float((emb - ref).abs().max())


def _batch_row(b) -> dict:
    return {"mode": b.mode, "graph_time_s": b.graph_time_s, "plan_time_s": b.plan_time_s,
            "exec_time_s": b.exec_time_s, "inc_edges": b.inc_edges,
            "full_edges": b.full_edges, "out_vertices": b.out_vertices}


def _delta(after: dict, before: dict) -> dict:
    return {name: after[name] - before[name] for name in after}


def _drive_batches(eng, batches, kernels: dict):
    """``apply_batch`` each batch (each exec time synchronised); per batch its
    stats row with the kernel launches it made."""
    stats, rows = [], []
    for b in batches:
        c0 = _counts(kernels)
        bs = eng.apply_batch(b)
        stats.append(bs)
        rows.append({**_batch_row(bs), "launches": _delta(_counts(kernels), c0)})
    return stats, rows


def _require_mode_launches(where: str, rows: list, incremental_delta_agg: bool) -> None:
    """Chunked and full batches must launch segment_spmm (subset_layer,
    full_forward); incremental ones delta_agg where asked."""
    for i, r in enumerate(rows):
        if r["mode"] in ("chunked", "full") and r["launches"]["segment_spmm"] <= 0:
            raise AssertionError(f"{where} batch {i} ({r['mode']}): segment_spmm not launched")
        if (incremental_delta_agg and r["mode"] == "incremental"
                and r["launches"]["delta_agg"] <= 0):
            raise AssertionError(f"{where} batch {i} (incremental): delta_agg not launched")


def phase_policy(serve: dict, seed: int, kernels: dict) -> dict:
    """The execution policy: the adversarial regimes' decision counts and
    the forced replay of their mixed schedules, then adaptive, its forced
    replay and a forced mixed schedule on the serving graph (gcn,
    ``apply_batch``: each exec time synchronised).  Every run is driven and
    its launches read before the checks against ``full_forward``."""
    import torch

    from repro_torch.core import MODES, ExecutionPolicy, make_model
    from repro_torch.graph import ADVERSARIAL_REGIMES, make_adversarial_stream, random_features
    from repro_torch.serve import EngineConfig, create_engine

    model = make_model("gcn")
    wl, x = serve["wl"], serve["x"]
    params = _layer_params(model, seed)
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    regimes, regime_rows = {}, {}
    for regime in ADVERSARIAL_REGIMES:
        awl = make_adversarial_stream(regime, n=256, num_batches=6, feature_dim=WIDTH, seed=seed)
        ax, _ = random_features(awl.base.n, WIDTH, seed=seed)

        def run_regime(policy):
            # one layer, as the reference's adversarial cells (dims [8, 8]):
            # the pinned decisions are for that depth
            eng = create_engine("device", EngineConfig(
                model=model, graph=awl.base, x=ax, dims=[WIDTH] * 2, seed=seed, policy=policy,
                device="cuda"))
            return eng, *_drive_batches(eng, awl.batches, kernels)

        adaptive, a_stats, a_rows = run_regime("adaptive")
        modes = tuple(b.mode for b in a_stats)
        replay, _, r_rows = run_regime(ExecutionPolicy(force_mode=modes))
        regimes[regime] = {"decisions": [modes.count(m) for m in MODES],
                           "policy_edges": sum(b.est_edges for b in a_stats), "modes": modes,
                           "replay_bitwise": all(bool(torch.equal(u, v)) for u, v in zip(
                               _state_tensors(adaptive), _state_tensors(replay))),
                           "launches": [r["launches"] for r in a_rows],
                           "replay_launches": [r["launches"] for r in r_rows]}
        regime_rows[regime] = a_rows + r_rows

    def run(policy):
        eng = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                   policy=policy, device="cuda"))
        return eng, *_drive_batches(eng, wl.batches, kernels)

    adaptive, a_stats, a_rows = run("adaptive")
    schedule = tuple(b.mode for b in a_stats)
    replay, _, r_rows = run(ExecutionPolicy(force_mode=schedule))
    forced, _, f_rows = run(ExecutionPolicy(force_mode=FORCED_SCHEDULE))
    launches = _counts(kernels)
    bitwise = all(bool(torch.equal(u, v))
                  for u, v in zip(_state_tensors(adaptive), _state_tensors(replay)))
    x_final = final_features(x, wl.batches)
    err_adaptive = _err_vs_full_forward(adaptive.embeddings, model, params, x_final,
                                        adaptive.graph)
    err_forced = _err_vs_full_forward(forced.embeddings, model, params, x_final, forced.graph)
    # the chunked mode's layer-to-host copy (layer_input_host) at this size
    copy_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = forced._backend.layer_input_host(1)
        copy_s.append(time.perf_counter() - t0)
    chunk = forced._orch._chunk_sched.stats
    row = {"phase": "policy", "seconds": time.perf_counter() - t_phase,
           "regimes": regimes, "n": wl.base.n, "edges": wl.base.num_edges,
           "adaptive": a_rows, "replay_bitwise": bitwise, "max_abs_err_adaptive": err_adaptive,
           "forced": f_rows, "max_abs_err_forced": err_forced,
           "layer_input_host": {"bytes": host.nbytes, "seconds": copy_s},
           "chunks": {"chunks": chunk.chunks, "rows_transferred": chunk.rows_transferred,
                      "rows_reused": chunk.rows_reused,
                      "edges_processed": chunk.edges_processed},
           "launches": launches}
    emit(row)
    for regime, got in regimes.items():
        want = ADVERSARIAL_EXPECTED[regime]
        if tuple(got["decisions"]) + (got["policy_edges"],) != want:
            raise AssertionError(f"policy {regime}: {got} != {want}")
        if len(set(got["modes"])) < 2 or not got["replay_bitwise"]:
            raise AssertionError(f"policy {regime}: mixed schedule not replayed bitwise: {got}")
        _require_mode_launches(f"policy {regime}", regime_rows[regime], False)
    if not bitwise:
        raise AssertionError("policy: adaptive != forced replay of its decisions")
    if not (err_adaptive <= TOL_ENGINE and err_forced <= TOL_ENGINE):
        raise AssertionError(f"policy vs full_forward: {err_adaptive}, {err_forced} > {TOL_ENGINE}")
    for where, rows in (("adaptive", a_rows), ("replay", r_rows), ("forced", f_rows)):
        _require_mode_launches(f"policy {where}", rows, True)
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def _ring_stream(n: int, seed: int):
    """The reference's fusion cell (benchmarks/fig7_response_time.py
    ``smoke_fusion``) at n rows: a ring lattice (in-edges from i+1, i+2) and
    12 single-edge batches with one feature update, 45 rows apart."""
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.streaming import UpdateBatch

    idx = np.arange(n, dtype=np.int64)
    g = CSRGraph.from_edges(n, np.concatenate([(idx + 1) % n, (idx + 2) % n]),
                            np.concatenate([idx, idx]))
    rng = np.random.default_rng(seed)
    batches = []
    for i in range(12):
        base = (i * 45) % n
        batches.append(UpdateBatch(
            ins_src=np.array([(base + 1) % n], np.int64),
            ins_dst=np.array([(base + 5) % n], np.int64),
            del_src=np.array([], np.int64), del_dst=np.array([], np.int64),
            feat_vertices=np.array([(base + 7) % n], np.int64),
            feat_values=rng.standard_normal((1, WIDTH)).astype(np.float32)))
    return g, batches


def phase_fusion_frontend(serve: dict, seed: int, kernels: dict) -> dict:
    """Batch-window fusion on the ring cell (fused ≡ serial, bitwise), then
    the serving front-end's versioned reads on the serving stream."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.graph import random_features
    from repro_torch.serve import EngineConfig, FusionConfig, create_engine

    model = make_model("gcn")
    params = _layer_params(model, seed)
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    n = serve["n"]
    g, batches = _ring_stream(n, seed)
    rx, _ = random_features(n, WIDTH, seed=seed)
    runs = {}
    for fused in (False, True):
        eng = create_engine("device", EngineConfig(
            model=model, graph=g, x=rx, params=params, device="cuda",
            fusion=FusionConfig(window=4) if fused else None))
        runs[fused] = (eng, eng.apply_stream(batches))
    (serial, ss_s), (fused_eng, ss_f) = runs[False], runs[True]
    pairs = {f"{kind}{l}": (u, v) for kind in ("h", "a", "nct")
             for l, (u, v) in enumerate(zip(getattr(serial, kind), getattr(fused_eng, kind)))}
    equal = {k: bool(torch.equal(u, v)) for k, (u, v) in pairs.items()}
    bitwise = all(equal.values())
    max_diff = max(float((u - v).abs().max()) for u, v in pairs.values())
    dispatches = len(batches) - (ss_f.fused_batches - ss_f.fusion_windows)
    fusion = {"n": n, "batches": len(batches), "windows": ss_f.fusion_windows,
              "fused_batches": ss_f.fused_batches, "fallbacks": ss_f.fusion_fallbacks,
              "dispatches": dispatches, "bitwise_fused_vs_serial": bitwise,
              "equal_fused_vs_serial": equal, "max_abs_diff_fused_vs_serial": max_diff,
              "wall_s_fused": ss_f.wall_s, "wall_s_serial": ss_s.wall_s}
    del runs, serial, fused_eng, pairs

    wl, x = serve["wl"], serve["x"]
    eng = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                               device="cuda"))
    fr = eng.serving_frontend(max_pending_reads=16, max_versions=4)
    rows = np.arange(0, wl.base.n, 17)
    snaps = {0: eng.snapshot_rows(rows)}
    tickets = []
    for b in wl.batches:  # the reference's smoke_frontend schedule
        tickets.append(fr.submit_read(rows))
        if fr.version >= 2:
            tickets.append(fr.submit_read(rows, version=fr.version - 2))
        fr.apply_batch(b)
        snaps[fr.version] = eng.snapshot_rows(rows)
    fr.drain()
    st = fr.stats()
    reads_bitwise = all(np.array_equal(t.value(), snaps[t.version]) for t in tickets)
    row = {"phase": "fusion_frontend", "seconds": time.perf_counter() - t_phase,
           "fusion": fusion,
           "frontend": {"rows_per_read": int(rows.size), "reads_served": st.reads_served,
                        "staleness_batches": st.staleness_batches,
                        "reads_rejected": st.reads_rejected, "reads_bitwise": reads_bitwise,
                        "read_p50_s": st.read_p50_s, "read_p99_s": st.read_p99_s,
                        "wall_s": st.wall_s,
                        "exec_time_s": [b.exec_time_s for b in st.batches]},
           "launches": _counts(kernels)}
    emit(row)
    if (fusion["windows"], fusion["fused_batches"], dispatches, fusion["fallbacks"]) != (3, 12, 3, 0):
        raise AssertionError(f"fusion counters: {fusion}")
    if not bitwise:
        raise AssertionError(f"fused != serial: {equal}, max|Δ| {max_diff}")
    if (st.reads_served, st.staleness_batches) != (10, 8) or not reads_bitwise:
        raise AssertionError(f"frontend: {row['frontend']}")
    _require_launched(row, ("delta_agg",))
    return row


def phase_storage(serve: dict, seed: int, kernels: dict) -> dict:
    """§V-B recompute storage: ``store_h=False`` against ``store_h=True``."""
    from repro_torch.core import make_model
    from repro_torch.serve import EngineConfig, create_engine

    model = make_model("gcn")
    params = _layer_params(model, seed)
    wl, x = serve["wl"], serve["x"]
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    out = {}
    for store_h in (True, False):
        eng = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                   store_h=store_h, device="cuda"))
        ss = eng.apply_stream(wl.batches)
        out[store_h] = {"emb": eng.embeddings.clone(), "state_bytes": eng.state_bytes(),
                        "wall_s": ss.wall_s, "graph": eng.graph}
    launches = _counts(kernels)
    err = float((out[True]["emb"] - out[False]["emb"]).abs().max())
    x_final = final_features(x, wl.batches)
    err_full = max(_err_vs_full_forward(out[k]["emb"], model, params, x_final, out[k]["graph"])
                   for k in (True, False))
    row = {"phase": "storage", "seconds": time.perf_counter() - t_phase,
           "state_bytes": {"store_h": out[True]["state_bytes"],
                           "recompute_h": out[False]["state_bytes"]},
           "state_bytes_ratio": out[False]["state_bytes"] / out[True]["state_bytes"],
           "wall_s": {"store_h": out[True]["wall_s"], "recompute_h": out[False]["wall_s"]},
           "max_abs_diff_store_vs_recompute": err, "max_abs_err_vs_full_forward": err_full,
           "launches": launches}
    emit(row)
    if not (err <= TOL_ENGINE and err_full <= TOL_ENGINE):
        raise AssertionError(f"storage: {err}, {err_full} > {TOL_ENGINE}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def _state_tensors(eng) -> list:
    return [v for v in (*eng.h, *eng.a, *eng.nct) if v is not None]


def phase_baselines_odec(serve: dict, seed: int, kernels: dict) -> dict:
    """The fig7 baselines beside the engine, ODEC, and the Theorem-1 gate."""
    import torch

    from repro_torch.core import (
        ALL_MODELS,
        RTECUER,
        MTECPeriod,
        RTECFull,
        RTECSample,
        make_model,
        odec_query,
        validate_registration,
    )
    from repro_torch.serve import EngineConfig, create_engine

    wl, x = serve["wl_small"], serve["x"]
    xt = torch.from_numpy(x).cuda()
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    launches = _counts(kernels)
    models = {}
    for name in ("gcn", "gat"):
        model = make_model(name)
        params = _layer_params(model, seed)
        c0 = _counts(kernels)
        eng = create_engine("device", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                   device="cuda"))
        systems = {"RTECFull": RTECFull(model, params, wl.base, xt),
                   "RTECUER": RTECUER(model, params, wl.base, xt),
                   "RTECSample": RTECSample(model, params, wl.base, xt, fanout=10, seed=seed),
                   "MTECPeriod": MTECPeriod(model, params, wl.base, xt, period=3)}
        mtec0 = systems["MTECPeriod"].embeddings.clone()
        per = {k: [] for k in ("engine", *systems)}
        stale = []
        for i, b in enumerate(wl.batches):
            if i == 0:
                q = np.unique(np.concatenate([b.ins_dst, b.del_dst]))[:64]
                before = [v.clone() for v in _state_tensors(eng)]
                emb_q, ost = odec_query(eng, b, q)
                unchanged = all(bool(torch.equal(u, v)) for u, v in zip(before, _state_tensors(eng)))
                del before
            per["engine"].append(eng.apply_batch(b))
            if i == 0:
                odec_err = float((emb_q - eng.embeddings[torch.from_numpy(q).cuda()]).abs().max())
            for k, sysm in systems.items():
                per[k].append(sysm.apply_batch(b))
            if i < 2:
                stale.append(float((systems["MTECPeriod"].embeddings - mtec0).abs().max()))
        # this model's drives, read before the checks against full_forward
        launches = {k: launches[k] + d for k, d in _delta(_counts(kernels), c0).items()}
        errs = {k: _err_vs_full_forward(systems[k].embeddings, model, params, x, eng.graph)
                for k in systems}
        edges = {k: sum(b.edges_processed for b in v) for k, v in per.items()}
        models[name] = {
            "exec_time_s": {k: [b.exec_time_s for b in v] for k, v in per.items()},
            "plan_time_s": {k: [b.plan_time_s for b in v] for k, v in per.items()},
            "edges_processed": edges, "max_abs_err_vs_full_forward": errs,
            "sample_finite": bool(torch.isfinite(systems["RTECSample"].embeddings).all()),
            "mtec_stale_max_abs_diff": stale,
            "odec": {"query": int(q.size), "max_abs_err_vs_engine": odec_err,
                     "engine_state_unchanged": unchanged, "exec_time_s": ost.exec_time_s,
                     "plan_time_s": ost.plan_time_s, "edges_processed": ost.edges_processed}}
        del eng, systems
    certified = {}
    for name in ALL_MODELS:
        rep = validate_registration(make_model(name))  # raises on a contradicted flag
        certified[name] = {"incrementalizable": rep.incrementalizable,
                           "dest_independent": rep.dest_independent,
                           "struct_independent": rep.struct_independent}
    row = {"phase": "baselines_odec", "seconds": time.perf_counter() - t_phase,
           "n": wl.base.n, "batches": len(wl.batches),
           "updates_per_batch": int(wl.batches[0].num_updates), "models": models,
           "certify": certified, "launches": launches}
    emit(row)
    for name, m in models.items():
        e = m["edges_processed"]
        errs = m["max_abs_err_vs_full_forward"]
        if not all(errs[k] <= TOL_ENGINE for k in ("RTECFull", "RTECUER", "MTECPeriod")):
            raise AssertionError(f"{name} baselines vs full_forward: {errs}")
        if not m["sample_finite"] or not all(d <= TOL_STALE for d in m["mtec_stale_max_abs_diff"]):
            raise AssertionError(f"{name}: RTECSample not finite or MTEC not stale: {m}")
        if not e["engine"] < e["RTECUER"] <= e["RTECFull"]:
            raise AssertionError(f"{name}: edges processed not Inc < UER <= Full: {e}")
        if not (m["odec"]["engine_state_unchanged"]
                and m["odec"]["max_abs_err_vs_engine"] <= TOL_ODEC):
            raise AssertionError(f"{name} ODEC: {m['odec']}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def _host_state(eng) -> dict:
    """An engine's state by tensor name (h0.., a0.., nct0..) as host arrays."""
    return {f"{kind}{l}": v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
            for kind in ("h", "a", "nct") for l, v in enumerate(getattr(eng, kind))}


def _compare(u: dict, v: dict):
    """Per tensor: bitwise equal?  And the max |Δ| over all of them."""
    equal = {k: bool(np.array_equal(u[k], v[k])) for k in u}
    return equal, max(float(np.abs(u[k] - v[k]).max()) for k in u)


def _count_dispatches(eng, kernels: dict, rows: list, shapes: list = None) -> None:
    """Record the kernel launches of each ``dispatch`` of ``eng``'s backend
    (one per batch in ``apply_stream``) into ``rows``, with an offload
    batch's footprint (its largest layer's staged rows and staging-buffer
    bytes), and each layer's compact ``delta_agg`` shape (e_cap, r_cap, live
    records) into ``shapes``."""
    backend = eng._backend
    inner = backend.dispatch

    def dispatch(prep):
        c0 = _counts(kernels)
        inner(prep)
        rows.append(_delta(_counts(kernels), c0))
        if hasattr(prep, "transfers"):
            rows[-1]["staged_rows_max"] = max(tr.need_h.shape[0] for tr in prep.transfers)
            rows[-1]["layer_buffer_bytes_max"] = max(tr.layout.total for tr in prep.transfers)
        if shapes is not None:
            shapes.extend((lp.e_src.shape[0], lp.touch_rows.shape[0], int(lp.e_mask.sum()))
                          for lp in prep.plan.layers)

    backend.dispatch = dispatch


def _stream_row(ss, eng=None) -> dict:
    d = ss.as_dict()
    row = {k: d[k] for k in ("wall_s", "plan_s", "staged_bytes", "prefetch_hits", "sync_wait_s",
                             "compute_s", "cache_hit_rows", "cache_miss_rows", "cache_evictions")}
    row["exec_time_s"] = [b.exec_time_s for b in ss.batches]
    if eng is not None and hasattr(eng, "transfers"):
        row["transfer_rows"] = eng.transfers.total_rows
    return row


def phase_offload(serve: dict, seed: int, kernels: dict) -> dict:
    """The §V-B offload engine at full width: gcn and gat through
    ``apply_stream`` (pinned async staging), gcn again with inline staging
    (bitwise equal to async), on the device engine (bitwise equal), and
    on a stream of 10-update batches, whose affected rows are a small share
    of V (the device footprint then follows the affected set).  Every drive
    is counted before the checks against ``full_forward``."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.graph import make_stream
    from repro_torch.serve import EngineConfig, StagingConfig, create_engine

    wl, x = serve["wl"], serve["x"]
    small = make_stream(wl.base, num_batches=3, batch_edges=10, delete_frac=0.3,
                        seed=seed + 3)
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    runs, per_batch, shapes = {}, {}, []
    for key, name, backend, kw, w in (
            ("gcn", "gcn", "offload", {}, wl), ("gat", "gat", "offload", {}, wl),
            ("gcn_sync", "gcn", "offload", {"staging": StagingConfig(async_enabled=False)}, wl),
            ("gcn_device", "gcn", "device", {}, wl),
            ("gcn_small_batches", "gcn", "offload", {}, small)):
        model = make_model(name)
        params = _layer_params(model, seed)
        t0 = time.perf_counter()
        eng = create_engine(backend, EngineConfig(model=model, graph=w.base, x=x, params=params,
                                                  device="cuda", **kw))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        per_batch[key] = []
        _count_dispatches(eng, kernels, per_batch[key], shapes if key == "gcn" else None)
        ss = eng.apply_stream(w.batches)
        torch.cuda.synchronize()
        runs[key] = {"eng": eng, "model": model, "params": params, "ss": ss, "init_s": init_s,
                     "batches": w.batches,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "stream_mem_bytes": torch.cuda.max_memory_allocated() - base}
    launches = _counts(kernels)
    streams = {}
    for key, r in runs.items():
        eng = r["eng"]
        emb = eng.embeddings
        emb = torch.from_numpy(np.asarray(emb)).cuda() if not torch.is_tensor(emb) else emb
        if emb.shape != (wl.base.n, WIDTH) or not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"offload {key}: bad embeddings {tuple(emb.shape)}")
        streams[key] = {**_stream_row(r["ss"], eng), "init_s": r["init_s"],
                        "peak_mem_bytes": r["peak_mem_bytes"],
                        "stream_mem_bytes": r["stream_mem_bytes"],
                        "launches_per_batch": per_batch[key],
                        "max_abs_err_vs_full_forward": _err_vs_full_forward(
                            emb, r["model"], r["params"], final_features(x, r["batches"]),
                            eng.graph)}
    dev = runs["gcn_device"]["eng"]
    dev_state = _host_state(dev)
    sync_equal, sync_diff = _compare(_host_state(runs["gcn"]["eng"]),
                                     _host_state(runs["gcn_sync"]["eng"]))
    dev_equal, dev_diff = _compare(dev_state, _host_state(runs["gcn"]["eng"]))
    row = {"phase": "offload", "seconds": time.perf_counter() - t_phase, "n": wl.base.n,
           "edges": wl.base.num_edges, "width": WIDTH, "layers": 2, "streams": streams,
           "device_state_bytes": dev.state_bytes(),
           "bitwise_async_vs_sync": all(sync_equal.values()),
           "max_abs_diff_async_vs_sync": sync_diff,
           "equal_device_vs_offload": dev_equal, "max_abs_diff_device_vs_offload": dev_diff,
           "delta_agg_compact_shapes": shapes, "launches": launches}
    emit(row)
    for key in runs:
        if not streams[key]["max_abs_err_vs_full_forward"] <= TOL_ENGINE:
            raise AssertionError(f"offload {key} vs full_forward: {streams[key]}")
    if (streams["gcn"]["prefetch_hits"], streams["gcn_sync"]["prefetch_hits"]) != (
            len(wl.batches) - 1, 0):
        raise AssertionError(f"offload prefetch_hits: {streams['gcn']}, {streams['gcn_sync']}")
    if not row["bitwise_async_vs_sync"]:
        raise AssertionError(f"offload async != sync: {sync_equal}")
    if not all(dev_equal.values()):
        raise AssertionError(f"device vs offload: {dev_equal}, max|Δ| {dev_diff}")
    for key in ("gcn", "gat", "gcn_sync", "gcn_small_batches"):
        for i, c in enumerate(per_batch[key]):
            # step 1 once per layer (2 layers); gat's step 3 sums through segment_spmm
            if c["delta_agg"] != 2 or (key == "gat" and c["segment_spmm"] <= 0):
                raise AssertionError(f"offload {key} batch {i}: launches {c}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def _hub_burst():
    """The reference's hub_burst cache cell (benchmarks/fig7_response_time.py
    ``smoke_cache``): the adversarial stream, 6 batches, features 8."""
    from repro_torch.graph import make_adversarial_stream, random_features

    wl = make_adversarial_stream("hub_burst", num_batches=6)
    x, _ = random_features(wl.base.n, 8, seed=0)
    return x, wl


def _fig7_smoke():
    """The reference's fig7 smoke cell (benchmarks/fig7_response_time.py
    ``smoke`` and ``benchmarks/common.py`` ``setup``): powerlaw n = 300,
    average degree 4, features 16, 6 batches of 8 edge updates."""
    from repro_torch.graph import make_graph, make_stream, random_features

    g = make_graph("powerlaw", 300, avg_degree=4.0, seed=0, weighted=True)
    x, _ = random_features(300, 16, seed=0)
    return x, make_stream(g, num_batches=6, batch_edges=8, delete_frac=0.3, seed=1)


def phase_hot_cache(serve: dict, seed: int, kernels: dict) -> dict:
    """The reference's exact offload and cache counters at its own sizes,
    then the hot-row cache at full width against the uncached engine."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.serve import CacheConfig, EngineConfig, create_engine

    model = make_model("gcn")
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    fx, fwl = _fig7_smoke()
    fig7 = create_engine("offload", EngineConfig(model=model, graph=fwl.base, x=fx, dims=[16, 16],
                                                 seed=seed, device="cuda"))
    fig7_ss = fig7.apply_stream(fwl.batches)
    hx, hwl = _hub_burst()
    hub, hub_ss = {}, {}
    for cached in (False, True):
        hub[cached] = create_engine("offload", EngineConfig(
            model=model, graph=hwl.base, x=hx, dims=[8, 8], seed=seed, device="cuda",
            cache=CacheConfig(capacity_rows=256) if cached else None))
        hub_ss[cached] = hub[cached].apply_stream(hwl.batches)
    wl, x = serve["wl"], serve["x"]
    params = _layer_params(model, seed)
    full, full_ss, full_mem = {}, {}, {}
    for cached in (False, True):
        full[cached] = create_engine("offload", EngineConfig(
            model=model, graph=wl.base, x=x, params=params, device="cuda",
            cache=CacheConfig(capacity_rows=8192, prewarm_rows=8192) if cached else None))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the cache's stores, when cached
        full_ss[cached] = full[cached].apply_stream(wl.batches)
        torch.cuda.synchronize()
        full_mem[cached] = torch.cuda.max_memory_allocated() - base
    launches = _counts(kernels)
    hub_equal, hub_diff = _compare(_host_state(hub[False]), _host_state(hub[True]))
    full_equal, full_diff = _compare(_host_state(full[False]), _host_state(full[True]))
    h_u, h_c = hub_ss[False].staged_bytes, hub_ss[True].staged_bytes
    f_u, f_c = full_ss[False].staged_bytes, full_ss[True].staged_bytes
    row = {"phase": "hot_cache", "seconds": time.perf_counter() - t_phase,
           "fig7_smoke": {"n": fwl.base.n, **_stream_row(fig7_ss, fig7)},
           "hub_burst": {"n": hwl.base.n, "uncached": _stream_row(hub_ss[False], hub[False]),
                         "cached": _stream_row(hub_ss[True], hub[True]),
                         "staged_bytes_ratio": h_u / max(h_c, 1),
                         "bitwise_cached_vs_uncached": all(hub_equal.values()),
                         "max_abs_diff": hub_diff},
           "full_width": {"n": wl.base.n, "capacity_rows": 8192, "prewarm_rows": 8192,
                          "uncached": {**_stream_row(full_ss[False], full[False]),
                                       "stream_mem_bytes": full_mem[False]},
                          "cached": {**_stream_row(full_ss[True], full[True]),
                                     "stream_mem_bytes": full_mem[True]},
                          "staged_bytes_ratio": f_u / max(f_c, 1),
                          "cache_store_bytes": full[True]._backend._cache.state_bytes(),
                          "bitwise_cached_vs_uncached": all(full_equal.values()),
                          "max_abs_diff": full_diff},
           "launches": launches}
    emit(row)
    got = (fig7.transfers.total_rows, fig7_ss.staged_bytes, fig7_ss.prefetch_hits)
    if got != (2970, 145_560, 5):
        raise AssertionError(f"fig7 smoke offload counters {got} != (2970, 145560, 5)")
    got = (hub_ss[True].cache_hit_rows, hub_ss[True].cache_miss_rows,
           hub_ss[True].cache_evictions, h_c, h_u)
    if got != (580, 504, 0, 61_648, 107_968):
        raise AssertionError(f"hub_burst cache counters {got} != (580, 504, 0, 61648, 107968)")
    if not (all(hub_equal.values()) and all(full_equal.values())):
        raise AssertionError(f"cached != uncached: {hub_equal}, {full_equal}")
    if not full_ss[True].cache_hit_rows > 0 or not f_c < f_u:
        raise AssertionError(f"full-width cache: {row['full_width']}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def phase_chunked_backend(serve: dict, seed: int, kernels: dict) -> dict:
    """The chunked-recompute backend on the serving stream's first 3
    batches, then one fused offload window (the ring cell of phase 8)."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.graph import random_features
    from repro_torch.serve import EngineConfig, FusionConfig, create_engine

    model = make_model("gcn")
    params = _layer_params(model, seed)
    wl, x = serve["wl"], serve["x"]
    batches = wl.batches[:3]
    t_phase = time.perf_counter()
    _zero_counts(kernels)
    eng = create_engine("chunked", EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                chunk_size=8192, device="cuda"))
    _, rows = _drive_batches(eng, batches, kernels)
    g, ring_batches = _ring_stream(serve["n"], seed)
    rx, _ = random_features(serve["n"], WIDTH, seed=seed)
    ring = {}
    for fused in (False, True):
        e = create_engine("offload", EngineConfig(
            model=model, graph=g, x=rx, params=params, device="cuda",
            fusion=FusionConfig(window=4) if fused else None))
        ring[fused] = (e, e.apply_stream(ring_batches))
    launches = _counts(kernels)
    emb = torch.from_numpy(np.asarray(eng.embeddings)).cuda()
    err = _err_vs_full_forward(emb, model, params, final_features(x, batches), eng.graph)
    (serial, ss_s), (fused_eng, ss_f) = ring[False], ring[True]
    equal, max_diff = _compare(_host_state(serial), _host_state(fused_eng))
    dispatches = len(ring_batches) - (ss_f.fused_batches - ss_f.fusion_windows)
    st = eng.chunk_stats
    row = {"phase": "chunked_backend", "seconds": time.perf_counter() - t_phase,
           "n": wl.base.n, "chunk_size": 8192, "batches": rows,
           "chunk_stats": {"chunks": st.chunks, "rows_transferred": st.rows_transferred,
                           "rows_reused": st.rows_reused, "reuse_frac": st.reuse_frac,
                           "edges_processed": st.edges_processed},
           "max_abs_err_vs_full_forward": err,
           "offload_fusion": {"windows": ss_f.fusion_windows, "fused_batches": ss_f.fused_batches,
                              "fallbacks": ss_f.fusion_fallbacks, "dispatches": dispatches,
                              "equal_fused_vs_serial": equal,
                              "max_abs_diff_fused_vs_serial": max_diff,
                              "wall_s_fused": ss_f.wall_s, "wall_s_serial": ss_s.wall_s},
           "launches": launches}
    emit(row)
    if not err <= TOL_ENGINE:
        raise AssertionError(f"chunked backend vs full_forward: {err} > {TOL_ENGINE}")
    for i, r in enumerate(rows):
        if r["launches"]["segment_spmm"] <= 0:
            raise AssertionError(f"chunked backend batch {i}: segment_spmm not launched")
    if (ss_f.fusion_windows, ss_f.fused_batches, dispatches, ss_f.fusion_fallbacks) != (3, 12, 3, 0):
        raise AssertionError(f"offload fusion counters: {row['offload_fusion']}")
    if not all(equal.values()):
        raise AssertionError(f"offload fused != serial: {equal}, max|Δ| {max_diff}")
    _require_launched(row, ("delta_agg", "segment_spmm"))
    return row


def phase_sharded(serve: dict, seed: int, kernels: dict) -> dict:
    """The row-sharded engine, S logical shards on the card: the
    reference's fig7 sharded cell at its own size, then the serving graph
    at full width against the device engine and ``full_forward``.  Every
    drive is counted before the checks."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.serve import CommsConfig, EngineConfig, create_engine

    t_phase = time.perf_counter()
    _zero_counts(kernels)
    gcn = make_model("gcn")
    fx, fwl = _fig7_smoke()
    fparams = gcn.init_layers(torch.Generator().manual_seed(seed), [16, 16], device="cuda")
    fig7 = {}
    for key, backend, kw in (("device", "device", {}),
                             ("psum", "sharded", {"comms": CommsConfig(halo="psum")}),
                             ("ppermute", "sharded", {"comms": CommsConfig(halo="ppermute")})):
        if backend == "sharded":
            kw["num_shards"] = SHARDS
        eng = create_engine(backend, EngineConfig(model=gcn, graph=fwl.base, x=fx, params=fparams,
                                                  device="cuda", **kw))
        fig7[key] = (eng, eng.apply_stream(fwl.batches))
    wl, x = serve["wl"], serve["x"]
    runs = {}
    for key, name, shards in (("gcn_device", "gcn", None), ("gcn_s8", "gcn", SHARDS),
                              ("gcn_s1", "gcn", 1), ("gat_s8", "gat", SHARDS),
                              ("gat_s1", "gat", 1)):
        model = make_model(name)
        params = _layer_params(model, seed)
        kw = {} if shards is None else {"num_shards": shards}
        c0 = _counts(kernels)
        t0 = time.perf_counter()
        eng = create_engine("device" if shards is None else "sharded", EngineConfig(
            model=model, graph=wl.base, x=x, params=params, device="cuda", **kw))
        torch.cuda.synchronize()
        run = {"eng": eng, "model": model, "params": params, "shards": shards,
               "init_s": time.perf_counter() - t0, "init_launches": _delta(_counts(kernels), c0)}
        _, run["batches"] = _drive_batches(eng, wl.batches, kernels)  # each exec synchronised
        runs[key] = run
    launches = _counts(kernels)

    fig7_state = {k: _host_state(e) for k, (e, _) in fig7.items()}
    fig7_eq = {k: _compare(fig7_state["device"], fig7_state[k])[0] for k in ("psum", "ppermute")}
    dev_state = _host_state(runs["gcn_device"]["eng"])
    x_final = final_features(x, wl.batches)
    full = {}
    for key, r in runs.items():
        eng = r["eng"]
        comms = eng._backend.comms_snapshot()
        row = {"shards": r["shards"], "init_s": r["init_s"], "init_launches": r["init_launches"],
               "batches": r["batches"], "state_bytes": eng.state_bytes(),
               "max_abs_err_vs_full_forward": _err_vs_full_forward(
                   eng.embeddings, r["model"], r["params"], x_final, eng.graph)}
        if comms is not None:
            row.update(halo_rows=eng.halo_rows_total, halo_rows_sent=comms.halo_rows_sent,
                       halo_bytes=comms.halo_bytes, halo_mode=eng.halo_mode)
        if key.startswith("gcn_s"):
            row["equal_vs_device"], row["max_abs_diff_vs_device"] = _compare(
                dev_state, _host_state(eng))
        full[key] = row
    row = {"phase": "sharded", "seconds": time.perf_counter() - t_phase,
           "fig7": {"n": fwl.base.n, "shards": SHARDS,
                    "halo_rows_sent": {k: fig7[k][1].comms_halo_rows_sent
                                       for k in ("psum", "ppermute")},
                    "halo_bytes": {k: fig7[k][1].comms_halo_bytes for k in ("psum", "ppermute")},
                    "wall_s": {k: fig7[k][1].wall_s for k in fig7},
                    "equal_vs_device": fig7_eq},
           "n": wl.base.n, "edges": wl.base.num_edges, "width": WIDTH, "layers": 2,
           "full_width": full, "launches": launches}
    emit(row)
    got = (fig7["ppermute"][1].comms_halo_rows_sent, fig7["psum"][1].comms_halo_rows_sent)
    if got != (157, 584):
        raise AssertionError(f"fig7 sharded halo rows {got} != (157, 584)")
    if not all(all(eq.values()) for eq in fig7_eq.values()):
        raise AssertionError(f"fig7 sharded != device engine: {fig7_eq}")
    for key in ("gcn_s8", "gcn_s1"):
        if not all(full[key]["equal_vs_device"].values()):
            raise AssertionError(f"sharded {key} != device engine: {full[key]['equal_vs_device']}")
    for key, r in full.items():
        if not r["max_abs_err_vs_full_forward"] <= TOL_ENGINE:
            raise AssertionError(f"sharded {key} vs full_forward: {r['max_abs_err_vs_full_forward']}")
        if r["init_launches"]["segment_spmm"] <= 0:
            raise AssertionError(f"sharded {key}: init did not launch segment_spmm")
        per = runs[key]["shards"] or 1
        for i, b in enumerate(r["batches"]):
            if b["launches"]["delta_agg"] != per * 2:
                raise AssertionError(f"sharded {key} batch {i}: launches {b['launches']}")
    _require_launched(row, ("delta_agg", "segment_spmm", "row_linear"))
    return row


def phase_sharded_offload(serve: dict, seed: int, kernels: dict) -> dict:
    """The sharded-offload hybrid at S = 8: the reference's fig7 and
    hub_burst counters at their own sizes, then the serving graph at full
    width against the offload engine (bitwise) in both halo modes."""
    import torch

    from repro_torch.core import make_model
    from repro_torch.serve import CacheConfig, CommsConfig, EngineConfig, create_engine

    t_phase = time.perf_counter()
    _zero_counts(kernels)
    gcn = make_model("gcn")
    fx, fwl = _fig7_smoke()
    fig7_kw = dict(model=gcn, graph=fwl.base, x=fx, dims=[16, 16], seed=seed, device="cuda",
                   num_shards=SHARDS)
    fig7 = create_engine("sharded_offload", EngineConfig(**fig7_kw))
    for b in fwl.batches:
        fig7.apply_batch(b)
    fig7_pipe = create_engine("sharded_offload", EngineConfig(**fig7_kw))
    fig7_ss = fig7_pipe.apply_stream(fwl.batches)
    hx, hwl = _hub_burst()
    hub, hub_ss = {}, {}
    for cached in (False, True):
        hub[cached] = create_engine("sharded_offload", EngineConfig(
            model=gcn, graph=hwl.base, x=hx, dims=[8, 8], seed=seed, device="cuda",
            num_shards=SHARDS, cache=CacheConfig(capacity_rows=256) if cached else None))
        hub_ss[cached] = hub[cached].apply_stream(hwl.batches)
    wl, x = serve["wl"], serve["x"]
    runs, per_batch = {}, {}
    for key, name, backend, halo in (
            ("gcn_offload", "gcn", "offload", None), ("gcn_hybrid", "gcn", "sharded_offload", "ppermute"),
            ("gcn_hybrid_psum", "gcn", "sharded_offload", "psum"),
            ("gat_offload", "gat", "offload", None), ("gat_hybrid", "gat", "sharded_offload", "ppermute"),
            ("gat_hybrid_psum", "gat", "sharded_offload", "psum")):
        model = make_model(name)
        params = _layer_params(model, seed)
        kw = {} if halo is None else {"num_shards": SHARDS, "comms": CommsConfig(halo=halo)}
        eng = create_engine(backend, EngineConfig(model=model, graph=wl.base, x=x, params=params,
                                                  device="cuda", **kw))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        per_batch[key] = []
        _count_dispatches(eng, kernels, per_batch[key])
        ss = eng.apply_stream(wl.batches)
        torch.cuda.synchronize()
        runs[key] = {"eng": eng, "ss": ss,
                     "stream_mem_bytes": torch.cuda.max_memory_allocated() - base}
    launches = _counts(kernels)

    hub_equal, hub_diff = _compare(_host_state(hub[False]), _host_state(hub[True]))
    states = {key: _host_state(r["eng"]) for key, r in runs.items()}
    full = {}
    for key, r in runs.items():
        eng = r["eng"]
        full[key] = {**_stream_row(r["ss"], eng), "stream_mem_bytes": r["stream_mem_bytes"],
                     "launches_per_batch": per_batch[key], "state_bytes": eng.state_bytes()}
        if "hybrid" in key:
            full[key].update(
                transfer_rows_per_shard=eng.per_shard_rows.tolist(),
                peak_device_bytes=eng.peak_device_bytes,
                halo_rows_sent=r["ss"].comms_halo_rows_sent,
                halo_bytes=r["ss"].comms_halo_bytes)
            ref = key.split("_")[0] + "_offload"
            full[key]["equal_vs_offload"], full[key]["max_abs_diff_vs_offload"] = _compare(
                states[ref], states[key])
    row = {"phase": "sharded_offload", "seconds": time.perf_counter() - t_phase,
           "fig7": {"n": fwl.base.n, "shards": SHARDS,
                    "transfer_rows_per_shard_max": int(fig7.per_shard_rows.max()),
                    **_stream_row(fig7_ss, fig7_pipe)},
           "hub_burst": {"n": hwl.base.n, "uncached": _stream_row(hub_ss[False], hub[False]),
                         "cached": _stream_row(hub_ss[True], hub[True]),
                         "bitwise_cached_vs_uncached": all(hub_equal.values()),
                         "max_abs_diff": hub_diff},
           "n": wl.base.n, "edges": wl.base.num_edges, "width": WIDTH, "layers": 2,
           "full_width": full, "launches": launches}
    emit(row)
    got = (row["fig7"]["transfer_rows_per_shard_max"], fig7_ss.staged_bytes,
           fig7_ss.prefetch_hits)
    if got != (731, 470_016, 5):
        raise AssertionError(f"fig7 hybrid counters {got} != (731, 470016, 5)")
    got = (hub_ss[True].cache_hit_rows, hub_ss[True].cache_miss_rows,
           hub_ss[True].cache_evictions)
    if got != (616, 532, 0) or not all(hub_equal.values()):
        raise AssertionError(f"hub_burst hybrid cache {got} != (616, 532, 0) or cached != "
                             f"uncached: {hub_equal}")
    for key in ("gcn_hybrid", "gcn_hybrid_psum", "gat_hybrid", "gat_hybrid_psum"):
        if not all(full[key]["equal_vs_offload"].values()):
            raise AssertionError(f"hybrid {key} != offload: {full[key]['equal_vs_offload']}")
        for i, c in enumerate(per_batch[key]):
            # step 1 once per shard and layer; gat's step 3 through segment_spmm
            if c["delta_agg"] != SHARDS * 2 or (key.startswith("gat") and c["segment_spmm"] <= 0):
                raise AssertionError(f"hybrid {key} batch {i}: launches {c}")
    _require_launched(row, ("delta_agg", "segment_spmm", "row_linear"))
    return row


def serving_data(n: int, seed: int) -> dict:
    """The serving phases' graph, features and streams."""
    from repro_torch.graph import make_graph, make_stream, random_features

    t0 = time.perf_counter()
    graph = make_graph("uniform", n, avg_degree=10, seed=seed, weighted=True)
    x, _ = random_features(n, WIDTH, seed=seed)
    wl = make_stream(graph, num_batches=6, batch_edges=1000, delete_frac=0.3,
                     feature_dim=WIDTH, feature_frac=1e-4, seed=seed + 1)
    wl_small = make_stream(graph, num_batches=3, batch_edges=100, delete_frac=0.3,
                           seed=seed + 2)
    emit({"phase": "serving_data", "n": n, "edges": graph.num_edges,
          "base_edges": wl.base.num_edges, "setup_s": time.perf_counter() - t0})
    return {"n": n, "x": x, "wl": wl, "wl_small": wl_small}


def _device_split_ms(prof) -> dict:
    """Device milliseconds of a ``torch.profiler`` trace by kernel kind."""
    from torch.autograd import DeviceType

    split = {"flash_attention": 0.0, "flash_attention_bwd": 0.0, "matmul": 0.0,
             "segment_spmm": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = e.key.lower()
        kind = ("flash_attention" if "flash_attention" in name else
                "flash_attention_bwd" if "bwd_dq_kernel" in name or "bwd_dkdv_kernel" in name
                else "segment_spmm" if "row_sum" in name  # the MoE combine on the LM path
                else "matmul" if any(w in name for w in ("gemm", "gemv", "splitk")) else "other")
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
        k.reset_counts()
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


def phase_lm_consistency(cfg, params, seed: int, phase: str = "lm_consistency") -> dict:
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
    row = {"phase": phase, "batch": b, "prompt": s, "steps": steps,
           "finite": bool(torch.isfinite(full).all()),
           "max_abs_logit": float(full.abs().max()), "max_abs_err": max(errs), "per_step": errs}
    emit(row)
    if not (row["finite"] and row["max_abs_err"] <= TOL_TEACHER):
        raise AssertionError(f"{phase}: teacher-forced logits: max|Δ| {row['max_abs_err']} > "
                             f"{TOL_TEACHER}")
    return row


def phase_lm_moe_serve(seed: int, kernels: dict):
    """The serving path on the MoE family: qwen3-moe-30b-a3b at full width
    (the depth cut to ``MOE_LAYERS``), ``serve`` with counts set to 0 just
    before it and read just after.  Then a prefill alone, counted the same
    way, with the combine's inputs read at each layer (assignments kept and
    dropped by the capacity; the first layer's records, for the kernel row),
    a profiled prefill and a profiled decode.  Returns the row, the config,
    the weights and the first combine's ``(y, key, num_rows)``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_model, prefill
    from repro_torch.nn import moe as moe_mod

    cfg = dataclasses.replace(get_arch(MOE_ARCH), num_layers=MOE_LAYERS)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    serve(cfg, params, tokens[:, :64], 2)  # warm-up
    _zero_counts(kernels)
    res = serve(cfg, params, tokens, LM_GEN)
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    out = res.tokens
    if out.shape != (LM_BATCH, LM_GEN + 1) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"lm_moe_serve: bad tokens {tuple(out.shape)}")

    # the prefill path alone: its launches, and what each layer's combine was given
    tok_t = torch.from_numpy(tokens).cuda()
    kept, first_layer = [], {}
    orig = moe_mod.combine

    def reading_combine(y, key, num_rows):
        kept.append((key < num_rows).sum())
        if not first_layer:  # with random weights, the layer that keeps the most records
            first_layer.update(y=y, key=key, num_rows=num_rows)
        return orig(y, key, num_rows)

    _zero_counts(kernels)
    moe_mod.combine = reading_combine
    try:
        logits, _ = prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN)
        torch.cuda.synchronize()
    finally:
        moe_mod.combine = orig
    prefill_launches = _counts(kernels)
    assignments = LM_BATCH * LM_PROMPT * cfg.top_k
    kept = [int(k) for k in kept]
    pre = _profiled(lambda: prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN))
    _, cache = prefill(params, cfg, {"tokens": tok_t}, s_max=LM_PROMPT + LM_GEN)
    first = out[:, :1]

    def decode_steps():
        nonlocal cache
        tok = first
        for _ in range(8):
            step_logits, cache = decode_step(params, cfg, tok, cache)
            tok = step_logits[:, -1].argmax(-1, keepdim=True)

    dec = _profiled(decode_steps)
    dec["steps"] = 8
    del cache
    cap = moe_mod.capacity(cfg.capacity_factor, cfg.top_k, LM_PROMPT, cfg.num_experts)
    row = {"phase": "lm_moe_serve", "arch": cfg.name, "layers": cfg.num_layers,
           "layers_published": get_arch(MOE_ARCH).num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "experts": cfg.num_experts, "top_k": cfg.top_k,
           "moe_d_ff": cfg.moe_d_ff, "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(), "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "capacity_factor": cfg.capacity_factor,
           "capacity_tokens": cap, "dispatch_shape": [cfg.num_experts, LM_BATCH, cap,
                                                      cfg.d_model],
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN, "init_s": init_s,
           "prefill_s": res.prefill_s, "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / res.prefill_s,
           "decode_ms_per_token": res.decode_s / LM_GEN * 1e3,
           "decode_tokens_per_s": LM_BATCH * LM_GEN / res.decode_s,
           "peak_mem_bytes": peak, "launches": launches, "prefill_launches": prefill_launches,
           "prefill_assignments_a_layer": assignments, "prefill_kept_by_layer": kept,
           "prefill_dropped_by_layer": [assignments - k for k in kept],
           "prefill_dropped_share": 1.0 - sum(kept) / (assignments * len(kept)),
           "prefill_logits_finite": bool(torch.isfinite(logits).all()),
           "profiled_prefill": pre, "profiled_decode": dec, "sample": out[0, :8].tolist()}
    emit(row)
    for name in ("flash_attention", "segment_spmm"):
        if prefill_launches[name] < cfg.num_layers:
            raise AssertionError(f"lm_moe_serve: {name} launched {prefill_launches[name]} "
                                 f"times on the prefill path, expected {cfg.num_layers}")
    if len(kept) != cfg.num_layers or not row["prefill_logits_finite"]:
        raise AssertionError(f"lm_moe_serve: {len(kept)} combines, finite logits "
                             f"{row['prefill_logits_finite']}")
    return row, cfg, params, (first_layer["y"], first_layer["key"], first_layer["num_rows"])


def kernel_moe_combine(y, key, num_rows: int) -> dict:
    """``segment_spmm`` at the MoE combine's prefill shape, on the records the
    first layer of ``lm_moe_serve``'s prefill gave it (the schedule built as
    ``nn/moe.py`` ``combine`` builds it): against its plain version, bitwise
    ``row_sum_chunked_plain`` (its documented order) and bitwise from one
    launch to the next; timed beside ``index_add_`` over the unsorted keys
    (dropped records into a spare row).  The bound counts the live records."""
    import torch

    from repro_torch.kernels.segment_spmm import (
        row_sum_chunked_plain,
        segment_spmm,
        segment_spmm_plain,
    )

    sorted_key, order = torch.sort(key, stable=True)
    row_ptr = torch.searchsorted(sorted_key, torch.arange(num_rows + 1, device="cuda"))
    out = segment_spmm(y, row_ptr, order, num_rows)
    again = segment_spmm(y, row_ptr, order, num_rows)
    ref = segment_spmm_plain(y, row_ptr, order, num_rows)
    chained = row_sum_chunked_plain(y, row_ptr, order)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    repeat_bitwise, chained_bitwise = bool(torch.equal(out, again)), bool(torch.equal(out, chained))
    del out, again, ref, chained
    d, live = y.shape[1], int(row_ptr[-1])
    most = int(row_ptr.diff().max())
    ms = cuda_time_ms(lambda: segment_spmm(y, row_ptr, order, num_rows), 20)
    plain_ms = cuda_time_ms(lambda: segment_spmm_plain(y, row_ptr, order, num_rows), 5)
    lib_ms = cuda_time_ms(
        lambda: torch.zeros(num_rows + 1, d, device="cuda").index_add_(0, key, y), 20)
    host_us = host_us_per_call(lambda: segment_spmm(y, row_ptr, order, num_rows), 20)
    bound_ms, by = _bound(live * d * 4 + live * 8 + (num_rows + 1) * 8 + num_rows * d * 4,
                          live * d)
    return {"name": "segment_spmm", "variant": "moe_combine",
            "shape": {"E": y.shape[0], "live": live, "D": d, "R": num_rows, "order": True,
                      "max_records_a_row": most, **_chains(most)},
            "max_abs_err": err, "repeat_bitwise": repeat_bitwise,
            "chunked_order_bitwise": chained_bitwise,
            "within_tol": err <= TOL_KERNEL and repeat_bitwise and chained_bitwise,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "bound_share": bound_ms / ms, "library_ms": lib_ms, "host_us_per_call": host_us}


def _entries(kernel) -> dict:
    """A kernel library's launches by entry (dQ, dK/dV), summed over dtypes."""
    from repro_torch.kernels.flash_attention import BWD_ENTRIES

    return {e: sum(n for sym, n in kernel.entry_launches.items() if f"_{e}_" in sym)
            for e in BWD_ENTRIES}


def _free_cuda() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_lm_train(seed: int, kernels: dict) -> dict:
    """The training path at full width through ``Trainer.train`` (counts set
    to 0 just before it and read just after), then one profiled step."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer, synthetic_batch

    cfg = get_arch(LM_ARCH)
    tcfg = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed,
                       log_every=1)
    opt = OptConfig(peak_lr=3e-3, warmup_steps=10, stable_steps=TRAIN_STEPS, decay_steps=10)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, opt, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _zero_counts(kernels)
    out = trainer.train()
    launches, entries = _counts(kernels), _entries(kernels["flash_attention_bwd"])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(h["loss"]) for h in trainer.history]
    step_s = [h["seconds"] for h in trainer.history]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady_s = sum(step_s[1:]) / len(step_s[1:])  # the first step pays the lazy set-up
    dh, L = cfg.resolved_head_dim, cfg.num_layers
    attn_fwd = 4 * dh * TRAIN_BATCH * cfg.num_heads * (TRAIN_SEQ * (TRAIN_SEQ + 1) // 2) * L
    model_flops = 6 * cfg.param_count() * tokens + 3 * attn_fwd  # forward + 2 × backward
    batch = synthetic_batch(cfg, tcfg, TRAIN_STEPS, device="cuda")
    prof = _profiled(lambda: trainer.step(trainer.state, batch))
    row = {"phase": "lm_train", "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
           "params": cfg.param_count(), "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "steps": out["steps"], "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "tokens_per_step": tokens, "init_s": init_s, "losses": losses,
           "step_s": step_s, "wall_s": out["wall_s"], "steady_step_s": steady_s,
           "tokens_per_s": tokens / steady_s, "peak_mem_bytes": peak,
           "model_flops_per_step": model_flops,
           "model_flops_share_of_fp32_peak": model_flops / steady_s / FP32_FLOPS,
           "launches": launches, "bwd_launches_by_entry": entries,
           "profiled_step": prof}
    emit(row)
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"lm_train: losses {losses}")
    if launches["flash_attention"] < 2 * L * TRAIN_STEPS:
        raise AssertionError(f"lm_train: flash_attention launched {launches['flash_attention']} "
                             f"times, expected at least {2 * L * TRAIN_STEPS}")
    if any(n != L * TRAIN_STEPS for n in entries.values()):
        raise AssertionError(f"lm_train: backward entries launched {entries}, expected "
                             f"{L * TRAIN_STEPS} each")
    del trainer, batch
    _free_cuda()
    return row


def _numpy_lm_tree(cfg, seed: int) -> dict:
    """Dense-LM weights made with numpy from ``seed`` at the init's scales
    (embedding 0.02, dense fan_in^-1/2, norms 1), tied embeddings, no biases."""
    if not cfg.tie_embeddings or cfg.qkv_bias or cfg.qk_norm:
        raise ValueError(f"{cfg.name}: the numpy weights cover tied, bias-free configs only")
    rng = np.random.default_rng(seed)
    d, L, f, hd = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    return {"embed": normal((cfg.vocab_size, d), 0.02), "final_norm": np.ones(d, np.float32),
            "blocks": {"ln1": np.ones((L, d), np.float32), "ln2": np.ones((L, d), np.float32),
                       "attn": {"wq": normal((L, d, hq), d ** -0.5),
                                "wk": normal((L, d, hkv), d ** -0.5),
                                "wv": normal((L, d, hkv), d ** -0.5),
                                "wo": normal((L, hq, d), hq ** -0.5)},
                       "mlp": {"wg": normal((L, d, f), d ** -0.5),
                               "wi": normal((L, d, f), d ** -0.5),
                               "wo": normal((L, f, d), f ** -0.5)}}}


def phase_lm_train_consistency(seed: int, kernels: dict) -> dict:
    """``loss_fn`` and every gradient leaf of a 2-layer full-width llama3.2-1b on
    the card (the kernels) against the CPU (the plain versions), from the
    same numpy weights and tokens."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.params import lm_params_from_numpy
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.train.tree import tree_paths

    cfg = dataclasses.replace(get_arch(LM_ARCH), num_layers=CONSIST_LAYERS)
    tree = _numpy_lm_tree(cfg, seed + 2)
    rng = np.random.default_rng(seed + 3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CONSIST_SEQ)))
             for k in ("tokens", "labels")}
    _zero_counts(kernels)
    loss, _, grads = value_and_grad(lm_params_from_numpy(tree, "cuda"), cfg,
                                    {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = _counts(kernels)
    t0 = time.perf_counter()
    loss_cpu, _, grads_cpu = value_and_grad(lm_params_from_numpy(tree, "cpu"), cfg, batch)
    cpu_s = time.perf_counter() - t0
    rel, limit = {}, {}
    for (key, a), (_, c) in zip(tree_paths(grads), tree_paths(grads_cpu)):
        rel[key] = _rel_err(a, c)
        limit[key] = (TOL_TRAIN_GRAD_BF16_CAST if key == "['embed']"
                      and cfg.compute_dtype == "bfloat16" else TOL_TRAIN_GRAD)
    loss_rel = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    del grads, grads_cpu
    # the embedding again under compute_dtype fp32, where no cast rounds its
    # gradient: it must then hold the common limit
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    embed32 = _rel_err(
        value_and_grad(lm_params_from_numpy(tree, "cuda"), cfg32,
                       {k: v.cuda() for k, v in batch.items()})[2]["embed"],
        value_and_grad(lm_params_from_numpy(tree, "cpu"), cfg32, batch)[2]["embed"])
    row = {"phase": "lm_train_consistency", "layers": CONSIST_LAYERS, "batch": 1,
           "seq_len": CONSIST_SEQ, "loss": float(loss), "loss_cpu": float(loss_cpu),
           "loss_rel_err": loss_rel, "grad_rel_err": rel, "grad_rel_limit": limit,
           "embed_rel_err_fp32_compute": embed32, "cpu_s": cpu_s, "launches": launches}
    emit(row)
    if not (np.isfinite(float(loss)) and loss_rel <= TOL_TRAIN_LOSS
            and all(rel[k] <= limit[k] for k in rel) and embed32 <= TOL_TRAIN_GRAD):
        raise AssertionError(f"lm_train_consistency: loss {loss_rel}, grads {rel}, "
                             f"embedding under fp32 compute {embed32}")
    if launches["flash_attention_bwd"] != 2 * CONSIST_LAYERS:
        raise AssertionError(f"lm_train_consistency: backward launches {launches}")
    _free_cuda()
    return row


def _rel_err(card, cpu) -> float:
    """max |card − cpu| over max |cpu|."""
    return float((card.cpu() - cpu).abs().max()) / max(float(cpu.abs().max()), 1e-30)


def kernel_flash_attention(cfg, gen, dtype: str = "float32") -> dict:
    """The prefill shape of ``cfg`` (causal, GQA) in fp32, the main path's
    dtype, or in bf16.  The bound is the design's: fp32 runs three TF32
    products per product (split TF32), bf16 one bf16 product."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_lse

    b, hq, hkv, s, dh = (LM_BATCH, cfg.num_heads, cfg.num_kv_heads, LM_PROMPT,
                         cfg.resolved_head_dim)
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, s, dh, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, hkv, s, dh, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, hkv, s, dh, device="cuda", generator=gen).to(dt)
    out = flash_attention(q, k, v, causal=True)
    o_lse, lse = flash_attention_lse(q, k, v, causal=True)
    lse_same_o = bool(torch.equal(o_lse, out))  # the lse output leaves o's bits alone
    out = out.float()
    ref, lse_ref = kref.flash_attention_lse_ref(q, k, v, causal=True)
    ref = ref.float()
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True).float()
    atol, rtol = TOL_ATTN if dtype == "float32" else TOL_ATTN_BF16
    lse_err = float((lse - lse_ref).abs().max())
    lse_ok = bool(((lse - lse_ref).abs() <= TOL_ATTN[0] + TOL_ATTN[1] * lse_ref.abs()).all())
    within = bool(((out - ref).abs() <= atol + rtol * ref.abs()).all()) and lse_same_o and lse_ok
    err, lib_err = float((out - ref).abs().max()), float((lib - ref).abs().max())
    del out, ref, lib, o_lse, lse, lse_ref
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
           "lse_same_o_bits": lse_same_o, "lse_max_abs_err": lse_err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
           "library_ms": lib_ms, "flops": flops,
           "fp32_simt_bound_ms": flops / FP32_FLOPS * 1e3}
    if dtype != "float32":
        row["variant"] = dtype  # a check beside the main path's dtype, not a summary row
    return row


def kernel_flash_attention_bwd(cfg, gen, dtype: str = "float32") -> dict:
    """The backward kernels at the training shape of ``cfg`` (causal, GQA)
    in fp32, the training step's dtype (fp32 params keep the residual
    stream fp32), or in bf16, which no main path runs: against
    ``flash_attention_bwd_ref`` on the kernel's o and lse, a second launch
    bitwise the first, timed (both entries a call) beside the plain version
    and the backward of ``scaled_dot_product_attention`` in the same dtype
    (one forward kept, ``torch.autograd.grad`` timed).  The bound is that of
    the five products, 2.5 × the forward's operations: in fp32 at 3 TF32
    products a product (split TF32, as the forward), in bf16 at one."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_lse

    b, hq, hkv, s, dh = (TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads, TRAIN_SEQ,
                         cfg.resolved_head_dim)
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, s, dh, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, hkv, s, dh, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, hkv, s, dh, device="cuda", generator=gen).to(dt)
    do = torch.randn(b, hq, s, dh, device="cuda", generator=gen).to(dt)
    o, lse = flash_attention_lse(q, k, v, causal=True)

    def run():
        return flash_attention_bwd(q, k, v, o, lse, do, causal=True)

    grads = run()
    ref = kref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    atol, rtol = TOL_ATTN if dtype == "float32" else TOL_ATTN_BF16
    within = all(bool(((g.float() - r.float()).abs() <= atol + rtol * r.float().abs()).all())
                 for g, r in zip(grads, ref))
    errs = {n: float((g.float() - r.float()).abs().max())
            for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
    bitwise = all(bool(torch.equal(a, c)) for a, c in zip(grads, run()))
    del grads, ref
    ms = cuda_time_ms(run, 10)
    plain_ms = cuda_time_ms(lambda: kref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True),
                            2, warmup=1)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 10)
    del out, leaves
    flops = 10 * dh * b * hq * (s * (s + 1) // 2)  # S, dP, dV, dK, dQ over the visible pairs
    # q o dO dq, k v dk dv in the dtype; lse in fp32
    nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    if dtype == "float32":
        bound_ms, by = _bound(nbytes, SPLIT_TF32 * flops, TF32_FLOPS)
    else:
        bound_ms, by = _bound(nbytes, flops, BF16_FLOPS)
    row = {"name": "flash_attention_bwd",
           "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "dh": dh, "causal": True,
                     "dtype": dtype},
           "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "within_tol": within and bitwise, "bitwise_repeat": bitwise,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
           "bound_share": bound_ms / ms, "library_ms": lib_ms,
           "library": "backward of F.scaled_dot_product_attention(is_causal, enable_gqa)",
           "flops": flops, "fp32_simt_bound_ms": flops / FP32_FLOPS * 1e3}
    if dtype != "float32":
        row["variant"] = dtype  # a check beside the fp32 row, not a summary row
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


def _row_linear_inputs(m: int, k: int, n: int, gen):
    """Embedding-like rows and a glorot weight, as the models' products get."""
    import torch

    a = torch.randn(m, k, device="cuda", generator=gen)
    w = torch.randn(k, n, device="cuda", generator=gen) * (2.0 / (k + n)) ** 0.5
    return a, w


def _bitwise(x, y) -> bool:
    import torch

    return bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))


def _row_linear_bound(m: int, k: int, n: int):
    return _bound((m * k + k * n + m * n) * 4, 2 * m * k * n)


def kernel_row_linear(m: int, e: int, r_cap: int, gen) -> list:
    """``row_linear`` at the update's shape on the main path (``a @ W`` over
    all n rows in ``full_forward``, K = N = 128), where the wrapper takes the
    tiled kernel: bitwise the general kernel, within 1e-5 of the plain
    version, the row-count probe at K = N = 128 and K = 256 across the
    wrapper's switch between the kernels, both kernels timed beside
    ``torch.matmul`` (TF32 off) and the bound, and both kernels at a few M
    around the switch.  Variant rows: gat's per-edge product (M = E, no plain
    version: seconds for nothing) and the incremental step's update (M =
    the largest row cap), each bitwise the general kernel."""
    import torch

    from repro_torch.kernels.row_linear import (
        ENTRIES,
        TILED_MIN_ROWS,
        kernel_entry,
        row_linear,
        row_linear_plain,
    )

    general = ENTRIES[0]
    probe = {}
    for k, n in ((WIDTH, WIDTH), (2 * WIDTH, WIDTH)):
        a, w = _row_linear_inputs(ROW_COUNTS[-1], k, n, gen)
        full = row_linear(a, w)
        probe[f"K{k}_N{n}"] = {
            "entry_at_full": kernel_entry(ROW_COUNTS[-1], k, n),
            "rows_independent": all(bool(torch.equal(row_linear(a[:r], w), full[:r]))
                                    for r in ROW_COUNTS),
            "matmul_max_row_diff": max(float(((a[:r] @ w) - (a @ w)[:r]).abs().max())
                                       for r in ROW_COUNTS)}
    del a, w, full

    a, w = _row_linear_inputs(m, WIDTH, WIDTH, gen)
    out = row_linear(a, w)
    same = _bitwise(out, row_linear(a, w, entry=general))
    err = float((out - row_linear_plain(a, w)).abs().max())
    del out
    ms = cuda_time_ms(lambda: row_linear(a, w), 20)
    general_ms = cuda_time_ms(lambda: row_linear(a, w, entry=general), 20)
    plain_ms = cuda_time_ms(lambda: row_linear_plain(a, w), 3, warmup=1)
    lib_ms = cuda_time_ms(lambda: torch.matmul(a, w), 20)
    bound_ms, by = _row_linear_bound(m, WIDTH, WIDTH)
    del a
    switch = {}  # both kernels on each side of the wrapper's switch between them
    for k in (WIDTH, 2 * WIDTH):
        a, wk = _row_linear_inputs(4 * TILED_MIN_ROWS, k, WIDTH, gen)
        for rows in (TILED_MIN_ROWS // 16, TILED_MIN_ROWS // 4, TILED_MIN_ROWS,
                     4 * TILED_MIN_ROWS):
            switch[f"K{k}_M{rows}"] = {
                entry: cuda_time_ms(lambda: row_linear(a[:rows], wk, entry=entry), 50)
                for entry in ENTRIES}
        del a
    main = {"name": "row_linear", "shape": {"M": m, "K": WIDTH, "N": WIDTH},
            "entry": kernel_entry(m, WIDTH, WIDTH), "max_abs_err": err,
            "bitwise_general": same,
            "within_tol": err <= TOL_KERNEL and same and all(
                p["rows_independent"] for p in probe.values()),
            "row_count_probe": probe, "ms": ms, "general_ms": general_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "torch.matmul (TF32 off)", "entries_at_switch_ms": switch}

    rows = [main]
    for variant, rows_m, iters in (("gat_per_edge", e, 5), ("incremental_update", r_cap, 50)):
        a = torch.randn(rows_m, WIDTH, device="cuda", generator=gen)
        out = row_linear(a, w)
        same = _bitwise(out, row_linear(a, w, entry=general))
        err = float((out - row_linear_plain(a, w)).abs().max()) if rows_m <= m else None
        del out
        bound_ms, by = _row_linear_bound(rows_m, WIDTH, WIDTH)
        rows.append({
            "name": "row_linear", "variant": variant,
            "shape": {"M": rows_m, "K": WIDTH, "N": WIDTH},
            "entry": kernel_entry(rows_m, WIDTH, WIDTH),
            # the plain version is skipped at M = E: its K steps take seconds there
            "max_abs_err": err, "bitwise_general": same,
            "within_tol": same and (err is None or err <= TOL_KERNEL),
            "ms": cuda_time_ms(lambda: row_linear(a, w), iters),
            "general_ms": cuda_time_ms(lambda: row_linear(a, w, entry=general), iters),
            "plain_ms": None, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": cuda_time_ms(lambda: torch.matmul(a, w), iters)})
        del a
    return rows


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
        from repro_torch.core.full import next_bucket
        from repro_torch.device import set_fp32_precision
        from repro_torch.graph import make_graph, make_stream, random_features
        from repro_torch.kernels import delta_agg as dmod
        from repro_torch.kernels import edge_softmax as emod
        from repro_torch.kernels import flash_attention as fmod
        from repro_torch.kernels import row_linear as rmod
        from repro_torch.kernels import segment_spmm as smod
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2
    set_fp32_precision()
    kernels = {"segment_spmm": smod.KERNEL, "delta_agg": dmod.KERNEL,
               "flash_attention": fmod.KERNEL, "flash_attention_bwd": fmod.BWD_KERNEL,
               "edge_softmax_normalize": emod.KERNEL, "row_linear": rmod.KERNEL}

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
           for name in ("segment_spmm", "delta_agg", "row_linear")}
    emit({"phase": "main_path_launches", **gnn})
    for name, cnt in gnn.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    skewed_row = phase_engine_skewed(args.n, args.seed, kernels, engine_rows[0])
    del graph
    serve = serving_data(min(args.n, SERVE_N), args.seed)
    serving_rows = [phase(serve, args.seed, kernels) for phase in (
        phase_policy, phase_fusion_frontend, phase_storage, phase_baselines_odec,
        phase_offload, phase_hot_cache, phase_chunked_backend, phase_sharded,
        phase_sharded_offload)]
    del serve
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    es = phase_edge_softmax_op(wl.base, gen, kernels)
    lm, cfg, params = phase_lm_serve(args.seed, kernels)
    phase_lm_consistency(cfg, params, args.seed)
    del params
    train = phase_lm_train(args.seed, kernels)
    train_check = phase_lm_train_consistency(args.seed, kernels)
    moe, moe_cfg, moe_params, combine_in = phase_lm_moe_serve(args.seed, kernels)
    phase_lm_consistency(dataclasses.replace(  # dropless: what overflows depends on context
        moe_cfg, capacity_factor=moe_cfg.num_experts / moe_cfg.top_k), moe_params, args.seed,
        phase="lm_moe_consistency")
    del moe_params
    _free_cuda()
    # every path's launches: the engine phases, the serving phases, the op, the LM
    path_rows = engine_rows + [skewed_row] + serving_rows + [es, lm, train, train_check, moe]
    launches = {name: sum(row["launches"][name] for row in path_rows) for name in kernels}
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on its path")

    # kernels at the shapes their paths used (GNN: largest layer caps over both runs)
    caps = {k: max(row["caps"][k] for row in engine_rows) for k in ("e", "r", "f", "fe")}
    rng = np.random.default_rng(args.seed)
    serving = {row["phase"]: row for row in serving_rows}
    chunk = serving["policy"]["chunks"]  # the policy's chunked mode: a mean chunk's shape
    # the offload path's largest compact delta_agg call (gcn, phase offload)
    off_e, off_r, off_live = max(serving["offload"]["delta_agg_compact_shapes"])
    off_check = kernel_delta_agg(_uniform_keys(off_e, off_r, off_live, rng), off_r,
                                 WIDTH + 1, gen)
    off_check["variant"] = "offload_compact"
    results = [
        kernel_segment_spmm(wl.base.in_indptr, WIDTH + 1, gen),  # gcn: [ctx (1) | raw (128)]
        kernel_segment_spmm_subset(caps["fe"], caps["f"], WIDTH + 2, gen, rng),  # gat
        kernel_segment_spmm_subset(next_bucket(chunk["edges_processed"] // chunk["chunks"]),
                                   8192, WIDTH + 1, gen, rng),  # chunked scheduler, gcn
        kernel_delta_agg(_uniform_keys(caps["e"], caps["r"], caps["e"] * 3 // 4, rng),
                         caps["r"], WIDTH + 1, gen),
        off_check,
    ]
    # the skewed shape: a Zipf in-degree sequence over the engine's n rows
    zipf = zipf_in_indptr(args.n, args.seed)
    skew_spmm = kernel_segment_spmm(zipf, WIDTH + 1, gen, integer=True)
    zipf_keys = np.repeat(np.arange(args.n), np.diff(zipf))[rng.permutation(int(zipf[-1]))]
    skew_delta = kernel_delta_agg(zipf_keys, args.n, WIDTH + 1, gen, iters=20, integer=True)
    for row in (skew_spmm, skew_delta):
        row["variant"] = "zipf"
    results += [
        skew_spmm,
        skew_delta,
        kernel_moe_combine(*combine_in),
        kernel_flash_attention(cfg, gen),
        kernel_flash_attention(cfg, gen, "bfloat16"),
        {**kernel_flash_attention(moe_cfg, gen), "variant": "moe_prefill"},  # dh 128
        kernel_flash_attention_bwd(cfg, gen),
        kernel_flash_attention_bwd(cfg, gen, "bfloat16"),
        kernel_edge_softmax(wl.base, gen),
        *kernel_row_linear(wl.base.n, wl.base.num_edges, caps["r"], gen),
        *kernel_row_sum_chunked(zipf, zipf_keys, WIDTH + 1, gen),
    ]
    del zipf_keys
    for res in results:
        emit({"phase": "kernel", **res})
        ok = res["within_tol"] if "within_tol" in res else res["max_abs_err"] <= TOL_KERNEL
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
        for extra in ("bound_share", "host_us_per_call", "fp32_simt_bound_ms", "general_ms"):
            if extra in res:
                entry[extra] = res[extra]
        if name in ("segment_spmm", "flash_attention"):  # of which the MoE serve path's
            entry["launches_lm_moe_serve"] = moe["launches"][name]
        if name == "flash_attention_bwd":  # two entries a backward, and the paths that ran it
            entry["launches_by_entry"] = train["bwd_launches_by_entry"]
            entry["launches_by_path"] = {row["phase"]: row["launches"][name]
                                         for row in (train, train_check)}
        others = [{k: r[k] for k in ("variant", "shape", "max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "bound_share", "library_ms",
                                     "general_ms", "within_tol", "host_us_per_call",
                                     "repeat_bitwise", "chunked_order_bitwise")
                   if k in r}
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
