"""Multi-pod dry-run, the part of ``repro.launch.dryrun`` that has a PyTorch
meaning: for every (architecture × input shape × production mesh) cell, the
bytes each device holds under :func:`repro_torch.launch.steps.shardings_for_cell`
(params; AdamW's two moments when training; the decode cache when serving;
the batch), computed from shapes alone, with no process group and no
allocation, and the model FLOPs as the reference counts them (6 · N_active ·
tokens to train, 2 · N_active · tokens otherwise) beside the H100's
data-sheet peaks.

Not ported: the reference lowers and compiles each cell for 512 forced host
devices and reads XLA's ``memory_analysis`` (temporaries, aliasing), the
HLO's FLOPs and bytes and its collectives' wire bytes
(``repro.launch.hlo_analysis``).  All of it comes from a compiled XLA
program, which eager PyTorch does not have.  ``--mode`` is kept for the
reference's command line; it changed how the reference lowered activations
and changes none of the numbers here.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Results go to ``experiments/dryrun/torch/<mode>/<cell>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.steps import shardings_for_cell
from repro_torch.train.tree import tree_leaves

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun" / "torch"

# NVIDIA H100 SXM data sheet (per card, dense)
PEAK_FLOPS = 989e12  # bf16
HBM_BYTES = 80e9


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


def production_cfg(arch: str):
    return dataclasses.replace(get_arch(arch), param_dtype="bfloat16")


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


def run_cell(arch: str, shape_name: str, multi_pod: bool, mode: str = "opt") -> dict:
    cfg = production_cfg(arch)
    shape = SHAPES[shape_name]
    mesh = production_shape_mesh(multi_pod)
    n_chips = int(mesh.devices.size)
    sh = shardings_for_cell(cfg, shape, mesh)

    mem = {"params": per_device_bytes(sh["params_struct"], sh["params_sharding"], mesh),
           "batch": per_device_bytes(sh["batch_struct"], sh["batch_sharding"], mesh)}
    if shape.kind == "train":
        opt, osh = sh["opt_struct"], sh["opt_sharding"]
        mem["adamw_moments"] = (per_device_bytes(opt.m, osh.m, mesh)
                                + per_device_bytes(opt.v, osh.v, mesh))
    else:
        mem["cache"] = per_device_bytes(sh["cache_struct"], sh["cache_sharding"], mesh)
        mem["token"] = per_device_bytes(sh["token_struct"], sh["token_sharding"], mesh)
    total = sum(mem.values())

    n, n_active = cfg.param_count(), cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    return {
        "arch": arch,
        "shape": shape_name,
        "mode": mode,
        "mesh": "2x16x16" if multi_pod else "16x16",
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
        "not_ported": "XLA memory_analysis, HLO FLOPs/bytes and collective wire bytes: "
                      "they come from a compiled XLA program, which eager PyTorch does not "
                      "have",
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--mode", choices=["baseline", "opt"], default="baseline")
    args = ap.parse_args(argv)

    out_dir = OUT_DIR / args.mode
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s, mp) for a in ARCH_NAMES for s in SHAPES for mp in (False, True)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape, args.multi_pod)]

    for arch, shape_name, mp in cells:
        tag = f"{arch}__{shape_name}__{'pod2' if mp else 'pod1'}"
        out_path = out_dir / f"{tag}.json"
        if out_path.exists() and not args.force:
            print(f"[skip cached] {tag}")
            continue
        skip = cell_skipped(arch, shape_name)
        if skip:
            out_path.write_text(json.dumps({"arch": arch, "shape": shape_name,
                                            "mesh": "2x16x16" if mp else "16x16",
                                            "skipped": skip}, indent=2))
            print(f"[skip] {tag}: {skip}")
            continue
        try:
            res = run_cell(arch, shape_name, mp, mode=args.mode)
            out_path.write_text(json.dumps(res, indent=2))
            b = res["per_device_bytes"]
            print(f"[done] {tag}: {b['total'] / 1e9:.3f} GB a device "
                  f"(params {b['params'] / 1e9:.3f}), fits={res['fits_hbm']}, "
                  f"compute floor {res['model_flops']['compute_floor_s']:.2e} s", flush=True)
        except Exception as e:  # noqa: BLE001 - one failed cell must not stop the sweep
            out_path.with_suffix(".err").write_text(traceback.format_exc())
            print(f"[FAIL] {tag}: {e}")


if __name__ == "__main__":
    main()
