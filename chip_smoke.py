#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # full size: n = 1,000,000 vertices, ~10M edges
    python3 chip_smoke.py --n 20000  # a quick rehearsal at a smaller graph

Phases, one JSON line each:

1. build   — compile both CUDA kernels (``src/repro_torch/csrc``), one
             ``nvcc`` per source, started together;
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
3. kernels — each kernel against its plain PyTorch version at the shapes the
             engine gave it (max |Δ| ≤ 1e-5), timed with CUDA events beside
             its plain version, the ``index_add_`` yardstick and its bound.

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
TOL_KERNEL = 1e-5  # kernel vs plain version: fp32, different summation order
TOL_ENGINE = 2e-4  # engine vs full recompute: the reference's tests/test_backends.py TOL
WIDTH = 128  # the lane width both TPU kernels were tiled for (BD = 128)
KERNEL_INFO = {
    "segment_spmm": {
        "source": "src/repro_torch/csrc/segment_spmm.cu",
        "replaces": "src/repro/kernels/segment_spmm.py:131",
    },
    "delta_agg": {
        "source": "src/repro_torch/csrc/delta_agg.cu",
        "replaces": "src/repro/kernels/delta_agg.py:74",
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
    from repro_torch.kernels._build import BUILD_DIR, build_all

    res = build_all(KERNEL_INFO)
    logdir = BUILD_DIR / "logs"
    logdir.mkdir(parents=True, exist_ok=True)
    regs = {}
    for name, r in res.items():
        (logdir / f"nvcc_{name}.log").write_text(r["log"])
        regs[name] = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": {k: v["seconds"] for k, v in res.items()},
          "ptxas": regs})


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


def _bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
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
        from repro_torch.graph import make_graph, make_stream, random_features
        from repro_torch.kernels import delta_agg as dmod
        from repro_torch.kernels import segment_spmm as smod
        from repro_torch.serve.api import set_fp32_precision
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2
    set_fp32_precision()
    kernels = {"segment_spmm": smod.KERNEL, "delta_agg": dmod.KERNEL}

    phase_build()

    t0 = time.perf_counter()
    graph = make_graph("uniform", args.n, avg_degree=10, seed=args.seed, weighted=True)
    x, _ = random_features(args.n, WIDTH, seed=args.seed)
    wl = make_stream(graph, num_batches=6, batch_edges=1000, delete_frac=0.3,
                     feature_dim=WIDTH, feature_frac=1e-4, seed=args.seed + 1)
    emit({"phase": "data", "n": args.n, "edges": graph.num_edges,
          "base_edges": wl.base.num_edges, "setup_s": time.perf_counter() - t0})

    engine_rows = [phase_engine(m, x, wl, args.seed, kernels) for m in ("gcn", "gat")]
    launches = {name: sum(row["launches"][name] for row in engine_rows) for name in kernels}
    emit({"phase": "main_path_launches", **launches})
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # kernels at the shapes the engine used (largest layer caps over both runs)
    caps = {k: max(row["caps"][k] for row in engine_rows) for k in ("e", "r", "f", "fe")}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    results = [
        kernel_segment_spmm(wl.base, WIDTH + 1, gen),  # gcn: [ctx (1) | raw (128)]
        kernel_segment_spmm_subset(caps["fe"], caps["f"], WIDTH + 2, gen, rng),  # gat
        kernel_delta_agg(caps["e"], caps["r"], WIDTH + 1, gen, rng),
    ]
    for res in results:
        emit({"phase": "kernel", **res})
        if not res["max_abs_err"] <= TOL_KERNEL:
            raise AssertionError(f"{res['name']}: kernel vs plain max|Δ| "
                                 f"{res['max_abs_err']} > {TOL_KERNEL}")

    summary = []
    for res in results:
        if "plain_ms" not in res:
            continue
        name = res["name"]
        summary.append({"name": name, "route": "cuda", **KERNEL_INFO[name],
                        "launches": launches[name], "max_abs_err": res["max_abs_err"],
                        "ms": res["ms"], "plain_ms": res["plain_ms"],
                        "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                        "library_ms": res["library_ms"]})
    emit({"kernels": summary})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
