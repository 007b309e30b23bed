"""Time the host graph update, ``CSRGraph.apply_updates``, of the port
against a rebuild of the snapshot through ``CSRGraph.from_edges`` (how the
update was made before it merged into the sorted arrays), on the graph and
stream of ``chip_smoke.py``'s engine phases, and check that both give the
same arrays bit for bit.

    PYTHONPATH=src python scripts/graph_update_ab.py [--n 1000000] [--batches 6]

Both run on the host (numpy), in turns a batch (rebuild, merge, merge,
rebuild).  Prints one JSON line: n, edges, the seconds of each call by
batch, and whether every snapshot was equal.
"""
import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, "src")

from repro_torch.graph import make_graph, make_stream  # noqa: E402
from repro_torch.graph.csr import CSRGraph  # noqa: E402

FIELDS = ("in_indptr", "in_indices", "out_indptr", "out_indices", "in_weights", "in_etypes",
          "out_weights", "out_etypes")


def rebuild(g: CSRGraph, b) -> CSRGraph:
    """The update as a full rebuild: delete by ``np.isin`` over all keys,
    append the inserts, sort everything again in ``from_edges``."""
    src, dst, w, t = g.edges_by_dst()
    if b.del_src.size:
        key = dst * g.n + src
        keep = ~np.isin(key, b.del_dst.astype(np.int64) * g.n + b.del_src.astype(np.int64))
        src, dst, w, t = src[keep], dst[keep], w[keep], t[keep]
    if b.ins_src.size:
        iw = (np.ones(len(b.ins_src), np.float32) if b.ins_weights is None
              else np.asarray(b.ins_weights, np.float32))
        it = (np.zeros(len(b.ins_src), np.int32) if b.ins_etypes is None
              else np.asarray(b.ins_etypes, np.int32))
        src = np.concatenate([src, b.ins_src.astype(np.int64)])
        dst = np.concatenate([dst, b.ins_dst.astype(np.int64)])
        w, t = np.concatenate([w, iw]), np.concatenate([t, it])
    return CSRGraph.from_edges(g.n, src, dst, w, t)


def merge(g: CSRGraph, b) -> CSRGraph:
    return g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst, b.ins_weights,
                           b.ins_etypes)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    graph = make_graph("uniform", args.n, avg_degree=10, seed=args.seed, weighted=True)
    wl = make_stream(graph, num_batches=args.batches, batch_edges=1000, delete_frac=0.3,
                     seed=args.seed + 1)
    g = wl.base
    rebuild_s, merge_s, equal = [], [], True
    for i, b in enumerate(wl.batches):
        order = (rebuild, merge, merge, rebuild) if i % 2 == 0 else (merge, rebuild, rebuild, merge)
        times = {rebuild: [], merge: []}
        outs = {}
        for fn in order:
            outs[fn], sec = timed(fn, g, b)
            times[fn].append(sec)
        equal &= all(np.array_equal(getattr(outs[rebuild], f), getattr(outs[merge], f))
                     and getattr(outs[rebuild], f).dtype == getattr(outs[merge], f).dtype
                     for f in FIELDS)
        rebuild_s.append(min(times[rebuild]))
        merge_s.append(min(times[merge]))
        g = outs[merge]
    print(json.dumps({"n": args.n, "edges": wl.base.num_edges, "batches": args.batches,
                      "rebuild_s": rebuild_s, "merge_s": merge_s, "bitwise_equal": equal}),
          flush=True)


if __name__ == "__main__":
    main()
