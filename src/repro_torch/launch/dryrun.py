"""Multi-pod dry run: the counterpart of ``repro.launch.dryrun``.

For every (architecture × input shape × production mesh) cell it runs the
port's own step (``make_train_step``, ``make_prefill_step`` or
``make_serve_step``) once, as one rank of the production mesh: a fake
process group of 256 ranks (16 × 16) or 512 (2 × 16 × 16) in this process,
``FakeTensorMode`` (shapes and dtypes, no allocation, no device), the
cell's params, AdamW state, batch and cache placed as DTensors through
:func:`repro_torch.launch.steps.shardings_for_cell`.  The hand-written
kernels take their fake route (:mod:`repro_torch.kernels._fake`).
:class:`repro_torch.launch.op_analysis.OpAnalysis` watches the run and
gives, per device, what the reference reads from its compiled XLA program:

* ``memory_analysis`` — the peak of live storages, split into params,
  optimizer state, inputs, activations and temporaries, and the largest
  storages live at the peak with the op and source line that made them;
* ``ops_per_device`` — the reference's ``hlo_per_device`` fields: FLOPs,
  HBM bytes, collective wire bytes and counts;
* ``roofline`` — compute, memory and collective seconds at the H100 SXM
  data sheet's rates (:data:`CONSTANTS`), ``dominant`` and ``bound_s``;
* ``model_flops`` — 6 · N_active · tokens to train, 2 · N_active · tokens
  otherwise, and their share of the counted FLOPs (``useful_fraction``);

beside the shape-only bytes a device holds (``per_device_bytes``).  The
reference records ``lower_s`` and ``compile_s``; the port ``trace_s``, the
fake run's seconds.

``--mode opt`` runs the step inside ``activation_sharding(mesh, shcfg)``,
as the reference, so every ``ashard`` redistributes; ``--mode baseline``
opens the context with ``constrain=False``: DTensor's propagation alone
lays the activations out (the reference's XLA propagation without
``with_sharding_constraint``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mode opt]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-1.3b --shape train_4k \
        --layers 2 --seq 256    # cut in depth and sequence, as "reduced" records

Results go to ``experiments/dryrun/torch/<mode>/<cell>.json``.  A process
holds one fake group at a time; :func:`fake_world` opens and closes it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.steps import shardings_for_cell
from repro_torch.train.tree import tree_leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun" / "torch"

# NVIDIA H100 SXM data sheet (per card, dense)
PEAK_FLOPS = 989e12  # bf16
HBM_BYTES = 80e9
HBM_BW = 3.35e12
NVLINK_BW = 450e9  # each way, a group inside one 8-card node
NETWORK_BW = 50e9  # InfiniBand NDR, 400 Gb/s a card: a group across nodes
CONSTANTS = {"source": "NVIDIA H100 SXM data sheet (not measured)",
             "peak_flops_bf16": PEAK_FLOPS, "hbm_bytes": HBM_BYTES,
             "hbm_bytes_per_s": HBM_BW, "nvlink_bytes_per_s": NVLINK_BW,
             "network_bytes_per_s": NETWORK_BW}
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


class ShapeMesh:
    """A mesh of axis names and sizes only: what the spec logic reads."""

    def __init__(self, shape, axis_names):
        self.axis_names = tuple(axis_names)
        self.devices = np.empty(shape, dtype=np.int8)


def production_shape_mesh(multi_pod: bool) -> ShapeMesh:
    return ShapeMesh(*production_mesh_shape(multi_pod=multi_pod))


def cell_skipped(arch: str, shape_name: str) -> str:
    cfg = get_arch(arch)
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch — long_500k needs sub-quadratic attention "
                "(DESIGN.md §5)")
    return ""


def production_cfg(arch: str, layers: int = 0):
    """``arch``'s config with bf16 params, cut in depth to ``layers`` decoder
    layers (and at most as many encoder layers) when ``layers`` is set:
    hymba keeps its global-attention layers below the cut, xlstm one group
    (its sLSTM and the mLSTMs after it)."""
    cfg = dataclasses.replace(get_arch(arch), param_dtype="bfloat16")
    if not layers:
        return cfg
    return dataclasses.replace(
        cfg, num_layers=layers, enc_layers=min(cfg.enc_layers, layers),
        slstm_every=min(cfg.slstm_every, layers),
        full_attn_layers=tuple(i for i in cfg.full_attn_layers if i < layers))


def per_device_bytes(tensors, shardings, mesh) -> int:
    """Σ over the leaves of ``tensors`` of the bytes of one device's shard
    under the matching :class:`~repro_torch.dist.sharding.NamedSharding` s
    (the specs are divisibility-checked, so every shard is whole)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for t, sh in zip(tree_leaves(tensors), tree_leaves(shardings)):
        if not isinstance(t, torch.Tensor):  # a cache's index: a host int
            continue
        local = 1
        for i, dim in enumerate(t.shape):
            entry = sh.spec[i] if i < len(sh.spec) else None
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            local *= dim // math.prod(sizes[a] for a in axes)
        total += local * t.element_size()
    return total


# ---------------------------------------------------------------------- #
# the fake world
# ---------------------------------------------------------------------- #
@contextlib.contextmanager
def fake_world(n_ranks: int):
    """This process as rank 0 of a fake process group of ``n_ranks``: every
    collective returns at once and moves nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already: the dry run needs a "
                           "process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(shape, axes):
    """A ``DeviceMesh`` over the fake group's ranks; its tensors live on the CPU
    device (autograd on a CPU build runs no fake CUDA tensor)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def place_fake(struct, shardings):
    """Fake DTensors shaped like ``struct``'s (meta) tensors, each rank's shard
    of its :class:`~repro_torch.dist.sharding.NamedSharding`; call inside
    ``FakeTensorMode``.  Non-tensor leaves (a cache's index) pass through."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, s):
        if not isinstance(t, torch.Tensor):
            return t
        full = torch.empty(t.shape, dtype=t.dtype)
        return distribute_tensor(full, s.mesh, s.placements, src_data_rank=None)

    return tree_map(one, struct, shardings)


def analyse(step, args, inputs: Dict[str, Any], ctx=None) -> Dict[str, Any]:
    """Run ``step(*args)`` once under an :class:`OpAnalysis` (inside the
    caller's ``FakeTensorMode``), with ``inputs`` (category → tree) live
    from the start; returns the counts, the memory and ``trace_s``."""
    from repro_torch.launch.op_analysis import OpAnalysis

    an = OpAnalysis()
    with an:
        arg_bytes = sum(an.track(cat, tree) for cat, tree in inputs.items())
        t0 = time.perf_counter()
        with ctx if ctx is not None else contextlib.nullcontext():
            out = step(*args)
        trace_s = time.perf_counter() - t0
        mem = an.memory()
        del out
    return {"stats": an.stats(), "memory": mem, "argument_bytes": arg_bytes,
            "trace_s": trace_s}


# ---------------------------------------------------------------------- #
# one cell
# ---------------------------------------------------------------------- #
def step_and_inputs(cfg, shape, sh, opt_cfg=None):
    """The cell's step, its placed fake arguments and the categories of its
    inputs (inside ``FakeTensorMode``)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.train.optimizer import OptConfig

    params = place_fake(sh["params_struct"], sh["params_sharding"])
    if shape.kind == "train":
        opt = place_fake(sh["opt_struct"], sh["opt_sharding"])
        batch = place_fake(sh["batch_struct"], sh["batch_sharding"])
        step = make_train_step(cfg, opt_cfg or OptConfig())
        return step, (params, opt, batch), {"params": params, "optimizer_state": opt,
                                            "inputs": batch}
    if shape.kind == "prefill":
        bstruct = {k: v for k, v in sh["batch_struct"].items() if k != "labels"}
        bsh = {k: v for k, v in sh["batch_sharding"].items() if k != "labels"}
        batch = place_fake(bstruct, bsh)
        return (make_prefill_step(cfg, sh["s_max"]), (params, batch),
                {"params": params, "inputs": batch})
    cache = place_fake(sh["cache_struct"], sh["cache_sharding"])
    token = place_fake(sh["token_struct"], sh["token_sharding"])
    return (make_serve_step(cfg), (params, cache, token),
            {"params": params, "inputs": (cache, token)})


def estimate(cfg, shape, mesh, mode: str = "opt", opt_cfg=None) -> Dict[str, Any]:
    """The fake run of one cell's step on ``mesh`` (a fake-group
    ``DeviceMesh``): :func:`analyse`'s result."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.ctx import activation_sharding

    sh = shardings_for_cell(cfg, shape, mesh)
    with FakeTensorMode():
        step, args, inputs = step_and_inputs(cfg, shape, sh, opt_cfg)
        ctx = activation_sharding(mesh, sh["shcfg"], constrain=(mode == "opt"))
        return analyse(step, args, inputs, ctx)


def roofline(stats) -> Dict[str, Any]:
    compute_s = stats.flops / PEAK_FLOPS
    memory_s = stats.hbm_bytes_flash_adjusted / HBM_BW
    collective_s = sum(b / LINK_BW[link] for link, b in stats.collective_bytes_by_link.items())
    dominant = max([("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)], key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s,
            "dominant": dominant, "bound_s": max(compute_s, memory_s, collective_s)}


def memory_analysis(res: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's ``memory_analysis`` keys from a fake run, and the split."""
    mem = res["memory"]
    by = mem["peak_by_category"]
    peak = mem["peak_bytes"]
    return {
        "argument_bytes_per_device": res["argument_bytes"],
        "output_bytes_per_device": mem["current_bytes"] - res["argument_bytes"],
        "temp_bytes_per_device": peak - res["argument_bytes"],
        "alias_bytes_per_device": 0,  # eager PyTorch donates nothing
        "peak_bytes_per_device": peak,
        "peak_est_gb": round(peak / 1e9, 3),
        "peak_split_bytes": {k: by.get(k, 0) for k in
                             ("params", "optimizer_state", "inputs", "activations",
                              "temporaries")},
        "peak_top_storages": mem["peak_top_storages"],
        "method": "fake-tensor run: each storage live from the op that made it until "
                  "Python frees it, rounded up to 512 B (the CUDA caching allocator's block)",
    }


def ops_per_device(stats) -> Dict[str, Any]:
    return {
        "flops": stats.flops,
        "hbm_bytes_raw": stats.hbm_bytes,
        "hbm_bytes_flash_adjusted": stats.hbm_bytes_flash_adjusted,
        "attn_matrix_bytes_excluded": stats.attn_matrix_bytes,
        "collective_wire_bytes": stats.collective_bytes,
        "collective_counts": stats.collective_counts,
        "per_collective_bytes": stats.per_collective_bytes,
        "collective_bytes_by_link": stats.collective_bytes_by_link,
        "kernel_calls": stats.kernel_calls,
        "kernel_flops": stats.kernel_flops,
        "top_flops": stats.top_flops,
    }


def shape_figures(cfg, shape, smesh) -> Dict[str, Any]:
    """The bytes each device holds under the cell's shardings on ``smesh`` (a
    :class:`ShapeMesh`), and the model FLOPs: shapes alone, no process group."""
    sh = shardings_for_cell(cfg, shape, smesh)
    mem = {"params": per_device_bytes(sh["params_struct"], sh["params_sharding"], smesh),
           "batch": per_device_bytes(sh["batch_struct"], sh["batch_sharding"], smesh)}
    if shape.kind == "train":
        opt, osh = sh["opt_struct"], sh["opt_sharding"]
        mem["adamw_moments"] = (per_device_bytes(opt.m, osh.m, smesh)
                                + per_device_bytes(opt.v, osh.v, smesh))
    else:
        mem["cache"] = per_device_bytes(sh["cache_struct"], sh["cache_sharding"], smesh)
        mem["token"] = per_device_bytes(sh["token_struct"], sh["token_sharding"], smesh)
    total = sum(mem.values())
    n_chips = int(smesh.devices.size)
    n, n_active = cfg.param_count(), cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    return {
        "n_chips": n_chips,
        "kind": shape.kind,
        "per_device_bytes": {**mem, "total": total},
        "fits_hbm": total <= HBM_BYTES,
        "model_flops": {
            "params": n,
            "active_params": n_active,
            "model_flops": model_flops,
            # the least time the step's model FLOPs take at the bf16 peak
            "compute_floor_s": model_flops / (n_chips * PEAK_FLOPS),
        },
        "constants": CONSTANTS,
    }


def fake_figures(cfg, shape, mesh, mode: str, model_flops: float) -> Dict[str, Any]:
    """The fake run's figures of one cell on ``mesh`` (a ``DeviceMesh`` of the
    open fake group): memory, counts, roofline and ``useful_fraction``."""
    res = estimate(cfg, shape, mesh, mode)
    return figures(res, mesh.size(), model_flops)


def figures(res: Dict[str, Any], n_chips: int, model_flops: float) -> Dict[str, Any]:
    """The output keys of an :func:`analyse` result on ``n_chips`` ranks."""
    stats = res["stats"]
    ops_total = stats.flops * n_chips
    return {
        "trace_s": round(res["trace_s"], 1),
        "fits_hbm": res["memory"]["peak_bytes"] <= HBM_BYTES,
        "memory_analysis": memory_analysis(res),
        "ops_per_device": ops_per_device(stats),
        "roofline": roofline(stats),
        "model_flops": {"model_flops": model_flops, "ops_flops_total": ops_total,
                        "useful_fraction": model_flops / ops_total if ops_total else 0.0},
    }


def production_shape(shape_name: str, seq: int = 0):
    """The input shape ``shape_name``, its sequence cut to ``seq`` tokens
    when ``seq`` is set and the shape trains or prefills (a decode shape's
    sequence is its cache, which stays)."""
    shape = SHAPES[shape_name]
    if seq and shape.kind != "decode":
        shape = dataclasses.replace(shape, seq_len=seq)
    return shape


def shape_cell(arch: str, shape_name: str, multi_pod: bool, mode: str = "opt",
               layers: int = 0, seq: int = 0) -> dict:
    """A production cell's figures from shapes alone (:func:`shape_figures`);
    ``layers`` and ``seq`` cut its depth and its sequence
    (:func:`production_cfg`, :func:`production_shape`), as ``"reduced"`` says."""
    smesh = production_shape_mesh(multi_pod)
    shape = production_shape(shape_name, seq)
    out = {"arch": arch, "shape": shape_name, "mode": mode,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    reduced = {"num_layers": layers} if layers else {}
    if shape.seq_len != SHAPES[shape_name].seq_len:
        reduced["seq_len"] = shape.seq_len
    if reduced:
        out["reduced"] = reduced
    return {**out, **shape_figures(production_cfg(arch, layers), shape, smesh)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, mode: str = "opt",
             layers: int = 0, seq: int = 0) -> dict:
    """:func:`shape_cell` and the fake run of the cell's step on the production
    mesh (a fake group of its size, opened and closed here)."""
    out = shape_cell(arch, shape_name, multi_pod, mode, layers, seq)
    mesh_shape, axes = production_mesh_shape(multi_pod=multi_pod)
    with fake_world(out["n_chips"]):
        fig = fake_figures(production_cfg(arch, layers), production_shape(shape_name, seq),
                           fake_mesh(mesh_shape, axes), mode,
                           out["model_flops"]["model_flops"])
    out["model_flops"].update(fig.pop("model_flops"))
    out.update(fig)
    return out


def cell_tag(arch: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"


def sweep(cells, mode: str, out_dir: Path, force: bool = False,
          run=run_cell, tag=cell_tag, skipped=cell_skipped) -> Dict[str, Any]:
    """Run ``cells`` (argument tuples of ``run``), one JSON each under
    ``out_dir``; a cell for which ``skipped(*cell[:2])`` names a reason writes it,
    a failed cell its traceback, and the sweep goes on.  Returns the counts
    of cells done, skipped and failed, and the seconds."""
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = {"done": 0, "skipped": 0, "failed": 0, "cached": 0}
    t0 = time.perf_counter()
    for cell in cells:
        name = tag(*cell)
        out_path = out_dir / f"{name}.json"
        if out_path.exists() and not force:
            print(f"[skip cached] {name}")
            counts["cached"] += 1
            continue
        skip = skipped(*cell[:2])
        if skip:
            out_path.write_text(json.dumps({"arch": cell[0], "shape": cell[1],
                                            "mesh": "2x16x16" if cell[2] else "16x16",
                                            "skipped": skip}, indent=2))
            print(f"[skip] {name}: {skip}")
            counts["skipped"] += 1
            continue
        print(f"[run ] {name} ...", flush=True)
        try:
            res = run(*cell, mode=mode)
        except Exception as e:  # noqa: BLE001 - one failed cell must not stop the sweep
            out_path.with_suffix(".err").write_text(traceback.format_exc())
            print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
            counts["failed"] += 1
            continue
        out_path.write_text(json.dumps(res, indent=2))
        out_path.with_suffix(".err").unlink(missing_ok=True)
        r, m = res["roofline"], res["memory_analysis"]
        print(f"[done] {name}: trace={res['trace_s']}s peak={m['peak_est_gb']}GB "
              f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
              f"coll={r['collective_s']:.2e}s dominant={r['dominant']}", flush=True)
        counts["done"] += 1
    counts["seconds"] = time.perf_counter() - t0
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--mode", choices=["baseline", "opt"], default="baseline")
    ap.add_argument("--layers", type=int, default=0, help="cut each cell to this depth")
    ap.add_argument("--seq", type=int, default=0,
                    help="cut each train or prefill cell's sequence to this many tokens")
    ap.add_argument("--out-dir", type=Path, default=None,
                    help=f"results directory (default {OUT_DIR}/<mode>)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, mp) for a in ARCH_NAMES for s in SHAPES for mp in (False, True)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape, args.multi_pod)]
    run = functools.partial(run_cell, layers=args.layers, seq=args.seq)
    counts = sweep(cells, args.mode, args.out_dir or OUT_DIR / args.mode, args.force, run=run)
    print(json.dumps({"sweep": counts}))
    return counts


if __name__ == "__main__":
    main()
