"""Distributed GNN dry run: the counterpart of ``repro.launch.gnn_dryrun``,
the paper-representative cells at the reference's sizes.

Each cell is one rank's shard of the port's own distributed GNN on the
production mesh's ranks (256 and 512, both meshes): a fake process
group in this process, ``FakeTensorMode`` (shapes only: no host graph, no
plan, no allocation), the hand-written kernels on their fake route, the
collectives through :class:`repro_torch.dist.exchange.DistExchange`.  The
vertices are split in row blocks over *every* rank, the features whole
(the port's row-sharded layout; the reference's XLA cells split vertices
over "data" and features over "model", so the two layouts differ; each
JSON records its ``layout``).  Everything is sized from the constants
below, never from a host graph of 2^30 edges: a rank's records, rows and
row schedules are the global capacities over the ranks.

  * ``gnn_full_layer`` — one full-neighbor layer
    (:func:`repro_torch.core.full.full_layer`) over the rank's E/S
    in-edges: the previous layer's rows and degrees all-gathered (every
    source may be anywhere), messages, ``segment_spmm``, ``ms_cbn``, the
    update in ``row_linear``;
  * ``gnn_rtec_inc`` — one incremental RTEC layer (Alg. 1) of the sharded
    substrate (:func:`repro_torch.core.incremental.sharded_step`): its halo
    in S − 1 rotation rounds (``ppermute``: each rank's frontier, sized by
    its records' sources), then ``delta_agg`` on the rank's touched rows,
    the constrained rows' ``segment_spmm`` and the update;
  * ``gnn_rtec_inc_compact`` — the offload formulation:
    :func:`repro_torch.core.incremental.incremental_layer_inplace` on the
    compact blocks the host planner ships (no collective), the halo
    embeddings in bf16 as the reference's compact cell (widened to fp32 on
    arrival: the layer body computes in fp32).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.gnn_dryrun [--cell NAME]

Results go to ``experiments/dryrun/torch/<mode>/gnn_*.json`` with the LM
cells' keys.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch.launch import dryrun as lm_dry
from repro_torch.launch.mesh import production_mesh_shape

V = 1 << 26  # 67M vertices
E = 1 << 30  # 1B edges
D = 128
E_AFF = 1 << 22  # affected-edge records per batch
V_AFF = 1 << 20  # touched rows
F_CAP = 1 << 16  # constrained full-recompute rows
FE_CAP = 1 << 20

CELLS = ("gnn_rtec_inc", "gnn_full_layer", "gnn_rtec_inc_compact")


def _per(n: int, s: int) -> int:
    return -(-n // s)


def gcn_params(d_in: int = D, d_out: int = D):
    from repro_torch.core.models import make_model

    model = make_model("gcn")
    with torch.device("meta"):
        meta = model.init_params(torch.Generator(), d_in, d_out)
    return model, {k: torch.empty(v.shape, dtype=v.dtype) for k, v in meta.items()}


def _empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype)


# ---------------------------------------------------------------------- #
# the cells: (step, args, inputs by category, layout)
# ---------------------------------------------------------------------- #
def full_layer_cell(s: int, v: int = V, e: int = E, d: int = D):
    """One rank's rows of a full-neighbor layer."""
    from repro_torch.core.full import full_layer
    from repro_torch.dist.exchange import DistExchange

    model, p = gcn_params(d, d)
    rows, edges = _per(v, s), _per(e, s)
    h = _empty(rows, d)
    deg = _empty(rows)
    src = _empty(edges, dtype=torch.int64)  # global ids
    dst = _empty(edges, dtype=torch.int64)  # local rows, sorted
    ew, et = _empty(edges), _empty(edges, dtype=torch.int32)
    row_ptr = _empty(rows + 1, dtype=torch.int64)
    exchange = DistExchange()

    def step(p, h, deg, src, dst, ew, et, row_ptr):
        h_all = exchange.all_gather(h[None]).reshape(-1, d)  # every rank's rows
        deg_all = exchange.all_gather(deg[None]).reshape(-1)
        mask = torch.ones(src.shape[0], dtype=torch.bool)
        # GCN's update reads its aggregation alone, so the gathered rows serve as h
        st = full_layer(model, p, h_all, src, dst, ew, et, mask, deg_all, row_ptr)
        return st.a, st.nct, st.h

    args = (p, h, deg, src, dst, ew, et, row_ptr)
    inputs = {"params": p, "inputs": args[1:]}
    layout = {"vertices": f"row blocks of {rows} over all {s} ranks", "features": "whole",
              "edges": f"{edges} a rank, by destination", "gathered": "h and degrees"}
    return step, args, inputs, layout


def _sharded_layout(s: int, v: int, e_aff: int, v_aff: int, f_cap: int, fe_cap: int):
    """A one-layer :class:`ShardedLayout` from the global capacities: each
    rank's share of them, its frontier its records' sources (a record's
    source lies on another rank with probability (S − 1)/S) and each
    (owner, consumer) pair twice its even share."""
    from repro_torch.core.affected import ShardedLayout
    from repro_torch.core.full import next_bucket

    rows = _per(v, s)
    e, r, f, fe, o = (next_bucket(_per(x, s)) for x in (e_aff, v_aff, f_cap, fe_cap, v_aff))
    halo = next_bucket(_per(e_aff, s) * (s - 1) // s + 1)
    pair = next_bucket(2 * _per(halo, max(s - 1, 1)), minimum=1)
    ws = halo + rows + 1
    return ShardedLayout(n=v, n_shards=s, rows_per=rows, feat_cap=0,
                         caps=((e, r, f, fe, o, halo, ws),), halo_mode="ppermute",
                         pair_caps=(pair,))


def rtec_inc_cell(s: int, v: int = V, d: int = D, e_aff: int = E_AFF, v_aff: int = V_AFF,
                  f_cap: int = F_CAP, fe_cap: int = FE_CAP):
    """One rank's shard of an incremental layer of the sharded substrate."""
    from repro_torch.core.affected import sched_slices, sharded_layout_slices
    from repro_torch.core.incremental import sharded_step
    from repro_torch.dist.exchange import DistExchange

    model, p = gcn_params(d, d)
    layout = _sharded_layout(s, v, e_aff, v_aff, f_cap, fe_cap)
    rows = layout.rows_per
    _, _, _, _, (idx_len, flt_len, msk_len, rep_len) = sharded_layout_slices(layout)
    _, s_len = sched_slices(layout)
    pair = layout.pair_caps[0]
    h_blocks = [_empty(1, rows + 1, d), _empty(1, rows + 1, d)]
    a_blocks, nct_blocks = [_empty(1, rows + 1, d)], [_empty(1, rows + 1, 1)]
    idx_sh = _empty(1, idx_len, dtype=torch.int32)
    flt_sh = _empty(1, flt_len)
    msk_sh = _empty(1, msk_len, dtype=torch.bool)
    sched_sh = _empty(1, s_len, dtype=torch.int32)
    idx_rep = _empty(rep_len, dtype=torch.int32)
    msk_rep = _empty(0, dtype=torch.bool)
    comms = [(_empty(1, s - 1, pair, dtype=torch.int64),
              _empty(1, s - 1, pair, dtype=torch.int64))]
    exchange = DistExchange()

    def step(p, h_blocks, a_blocks, nct_blocks, idx_sh, flt_sh, msk_sh, sched_sh, idx_rep,
             msk_rep, comms):
        return sharded_step(model, layout, [p], h_blocks, a_blocks, nct_blocks, idx_sh,
                            flt_sh, msk_sh, sched_sh, idx_rep, msk_rep, None, comms, exchange)

    args = (p, h_blocks, a_blocks, nct_blocks, idx_sh, flt_sh, msk_sh, sched_sh, idx_rep,
            msk_rep, comms)
    inputs = {"params": p, "inputs": args[1:]}
    e, r, f, fe, o, halo, ws = layout.caps[0]
    out = {"vertices": f"row blocks of {rows} over all {s} ranks", "features": "whole",
           "records": f"{e} a rank", "touched_rows": r, "constrained_rows": f,
           "constrained_records": fe, "out_rows": o, "halo_rows": halo,
           "halo": f"ppermute: {s - 1} rotation rounds of {pair} rows"}
    return step, args, inputs, out


def rtec_inc_compact_cell(s: int, d: int = D, e_aff: int = E_AFF, v_aff: int = V_AFF,
                          f_cap: int = F_CAP, fe_cap: int = FE_CAP):
    """One rank's compact blocks of the offload formulation: the compact h
    rows (RH = E_AFF, the records' endpoints at most) and state rows (RS =
    V_AFF), each over the ranks."""
    from repro_torch.core.affected import SH_FLT_FIELDS, SH_IDX_FIELDS, SH_MSK_FIELDS
    from repro_torch.core.incremental import incremental_layer_inplace

    model, p = gcn_params(d, d)
    rh, rs = _per(e_aff, s), _per(v_aff, s)
    e, r, f, fe, o = (_per(x, s) for x in (e_aff, v_aff, f_cap, fe_cap, v_aff))
    caps = (e, r, f, fe, o, 0, rh + 1)
    h_old, h_new = _empty(rh + 1, d, dtype=torch.bfloat16), _empty(rh + 1, d,
                                                                  dtype=torch.bfloat16)
    a, nct, h_cur = _empty(rs + 1, d), _empty(rs + 1, 1), _empty(rs + 1, d)
    g = {name: _empty(caps[k], dtype=torch.int32) for name, k in SH_IDX_FIELDS}
    g.update({name: _empty(caps[k]) for name, k in SH_FLT_FIELDS})
    g.update({name: _empty(caps[k], dtype=torch.bool) for name, k in SH_MSK_FIELDS})
    g.update(e_order=_empty(e, dtype=torch.int32), e_row_ptr=_empty(r + 1, dtype=torch.int32),
             f_order=_empty(fe, dtype=torch.int32), f_row_ptr=_empty(f + 1, dtype=torch.int32))

    def step(p, h_old, h_new, a, nct, h_cur, g):
        incremental_layer_inplace(model, p, h_old.float(), h_new.float(), g["deg_old"],
                                  g["deg_new"], a, nct, h_cur, g)
        return a, nct, h_cur

    args = (p, h_old, h_new, a, nct, h_cur, g)
    inputs = {"params": p, "inputs": args[1:]}
    layout = {"compact_h_rows": rh, "compact_state_rows": rs, "records": e,
              "halo": "shipped by the host planner in bf16: no collective"}
    return step, args, inputs, layout


_CELLS = {"gnn_full_layer": full_layer_cell, "gnn_rtec_inc": rtec_inc_cell,
          "gnn_rtec_inc_compact": rtec_inc_compact_cell}


def model_flops(name: str, s: int, d: int = D) -> float:
    """The cell's necessary FLOPs over all ranks: one add a record element of
    the row sums (the messages' ``[ctx | raw]`` columns) and the update's
    2 · rows · d · d."""
    if name == "gnn_full_layer":
        return E * (d + 1) + 2.0 * V * d * d
    return (E_AFF + FE_CAP) * (d + 1) + 2.0 * V_AFF * d * d


def estimate_cell(name: str, s: int, **sizes) -> Dict[str, Any]:
    """The fake run of one GNN cell as rank 0 of the current fake group of
    ``s`` ranks: :func:`repro_torch.launch.dryrun.analyse`'s result and the
    cell's layout."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        step, args, inputs, layout = _CELLS[name](s, **sizes)
        res = lm_dry.analyse(step, args, inputs)
    res["layout"] = layout
    return res


def run_cell(name: str, multi_pod: bool, mode: str = "opt") -> dict:
    mesh_shape, _ = production_mesh_shape(multi_pod=multi_pod)
    n_chips = math.prod(mesh_shape)
    with lm_dry.fake_world(n_chips):
        res = estimate_cell(name, n_chips)
    fig = lm_dry.figures(res, n_chips, model_flops(name, n_chips))
    fig["model_flops"]["counted"] = ("row-sum adds (records × (d + 1)) and the update's "
                                     "2 · rows · d²")
    return {"arch": name, "shape": f"V{V}_E{E if name == 'gnn_full_layer' else E_AFF}_D{D}",
            "mode": mode, "mesh": "2x16x16" if multi_pod else "16x16", "n_chips": n_chips,
            "kind": "gnn", "layout": res["layout"], **fig, "constants": lm_dry.CONSTANTS}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="opt")
    ap.add_argument("--cell", choices=CELLS, default=None, help="one cell (default: all)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", type=Path, default=None)
    args = ap.parse_args(argv)
    names = (args.cell,) if args.cell else CELLS
    cells = [(n, mp) for n in names for mp in (False, True)]
    counts = lm_dry.sweep(cells, args.mode, args.out_dir or lm_dry.OUT_DIR / args.mode,
                          args.force, run=run_cell,
                          tag=lambda n, mp: f"{n}__{'pod2' if mp else 'pod1'}",
                          skipped=lambda n, mp: "")
    print(json.dumps({"sweep": counts}))
    return counts


if __name__ == "__main__":
    main()
