"""The port's dry run: ``launch/op_analysis.py`` (the counterpart of
``repro.launch.hlo_analysis``), the fake-tensor half of ``launch/dryrun.py``,
``launch/gnn_dryrun.py`` and the kernel wrappers' fake routes.

Everything that opens a fake process group runs in child processes (a
process holds one group, and other test files assert that none is open),
spawned once for the file and read by the tests below:

* the hand-counted cases: a ``Shard(0) → Replicate`` redistribute and a
  ``Shard(0) × Replicate`` product on 8 fake ranks;
* the reference's own program (``tests/test_hlo_analysis.py``'s scan of
  L = 4 relu-matmul layers and its gradient, on a 2 × 4 mesh), through
  the port's analysis beside the reference's ``analyze_hlo`` figure for it;
* a reduced LM train cell on a fake 2 × 4 mesh in both modes and on an
  8 × 1 mesh (FSDP alone, against a hand count of its collectives), and the
  production llama3.2-1b ``train_4k`` cell through the command line;
* reduced GNN cells on 4 fake ranks against a hand count, and one
  production GNN cell through the command line.

The fake routes run here, under ``FakeTensorMode`` with fake CUDA tensors:
no process group, no card.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.launch.hlo_analysis import _WIRE_FACTOR as J_WIRE_FACTOR  # noqa: E402
from repro_torch.kernels import _fake  # noqa: E402
from repro_torch.kernels import delta_agg as dmod  # noqa: E402
from repro_torch.kernels import edge_softmax as emod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import row_linear as rmod  # noqa: E402
from repro_torch.kernels import segment_spmm as smod  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import op_analysis as oa  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4, num_kv_heads=2, head_dim=8,
            vocab_size=128)
TINY_SHAPE = (16, 8)  # seq_len, global batch
L_REF, B_REF, D_REF = 4, 32, 64  # tests/test_hlo_analysis.py's scan
GNN_SMALL = {"full": dict(v=64, e=512, d=8),
             "inc": dict(v=64, d=8, e_aff=256, v_aff=64, f_cap=16, fe_cap=64)}


# ---------------------------------------------------------------------- #
# the children
# ---------------------------------------------------------------------- #
def _child_counts(out_path: str) -> None:
    """Hand-counted cases and the reference's program, on fake groups; the
    reference's figure from JAX on 8 forced host devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import dryrun, gnn_dryrun

    out = {}
    with dryrun.fake_world(8):
        mesh = dryrun.fake_mesh((8,), ("x",))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(1024, 64), mesh, [Shard(0)], src_data_rank=None)
            with oa.OpAnalysis() as an:
                x.redistribute(mesh, [Replicate()])
            out["redistribute"] = vars(an.stats())
            a = distribute_tensor(torch.empty(1024, 64), mesh, [Shard(0)], src_data_rank=None)
            w = distribute_tensor(torch.empty(64, 32), mesh, [Replicate()], src_data_rank=None)
            with oa.OpAnalysis() as an:
                a @ w
            out["matmul"] = vars(an.stats())
    with dryrun.fake_world(8):
        mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
        with FakeTensorMode():
            ws = distribute_tensor(torch.empty(L_REF, D_REF, D_REF), mesh,
                                   [Shard(1), Shard(2)], src_data_rank=None)
            xs = distribute_tensor(torch.empty(B_REF, D_REF), mesh, [Shard(0), Replicate()],
                                   src_data_rank=None)
            with oa.OpAnalysis() as an:
                w = ws.detach().requires_grad_()
                h = xs
                for layer in range(L_REF):
                    h = torch.relu(h @ w[layer])
                torch.autograd.grad(h.sum(), [w])
            out["scan"] = vars(an.stats())
    with dryrun.fake_world(4):
        for name, sizes in GNN_SMALL.items():
            cell = "gnn_full_layer" if name == "full" else "gnn_rtec_inc"
            res = gnn_dryrun.estimate_cell(cell, 4, **sizes)
            out[f"gnn_{name}"] = {"stats": vars(res["stats"]), "layout": res["layout"],
                                  "peak": res["memory"]["peak_bytes"]}
    layout = gnn_dryrun._sharded_layout(4, **{k: v for k, v in GNN_SMALL["inc"].items()
                                              if k != "d"})
    out["gnn_inc_caps"] = list(layout.caps[0])

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.launch.hlo_analysis import analyze_hlo

    jmesh = jax.make_mesh((2, 4), ("data", "model"))

    def f(ws, x):
        def body(x, w):
            return jax.nn.relu(x @ w), None
        x, _ = jax.lax.scan(body, x, ws)
        return x.sum()

    g = jax.jit(jax.grad(f), in_shardings=(NamedSharding(jmesh, P(None, "data", "model")),
                                           NamedSharding(jmesh, P("data", None))))
    comp = g.lower(jax.ShapeDtypeStruct((L_REF, D_REF, D_REF), jnp.float32),
                   jax.ShapeDtypeStruct((B_REF, D_REF), jnp.float32)).compile()
    out["scan_reference_flops"] = analyze_hlo(comp.as_text(), default_trip_count=L_REF,
                                              total_devices=8).flops
    Path(out_path).write_text(json.dumps(out))


def _child_cells(out_path: str, tmp: str) -> None:
    """A reduced LM train cell in both modes, and production cells through
    the command lines."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, gnn_dryrun

    cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), **TINY)
    shape = ShapeConfig("tiny", *TINY_SHAPE, "train")
    out = {"shape_only": dryrun.shape_figures(cfg, shape, dryrun.ShapeMesh((2, 4),
                                                                          ("data", "model")))}
    for mode, mesh_shape in (("opt", (2, 4)), ("baseline", (2, 4)), ("fsdp", (8, 1))):
        with dryrun.fake_world(8):
            out[mode] = dryrun.fake_figures(cfg, shape, dryrun.fake_mesh(mesh_shape,
                                                                       ("data", "model")),
                                            "baseline" if mode == "baseline" else "opt",
                                            out["shape_only"]["model_flops"]["model_flops"])
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--mode", "opt",
                 "--out-dir", tmp, "--force"])
    gnn_dryrun.main(["--cell", "gnn_rtec_inc_compact", "--out-dir", tmp, "--force"])
    out["files"] = {p.name: json.loads(p.read_text()) for p in Path(tmp).glob("*.json")}
    Path(out_path).write_text(json.dumps(out))


def _spawn(fn: str, *args: str) -> subprocess.Popen:
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
            f"sys.path.insert(0, {str(ROOT / 'tests')!r}); import test_torch_dryrun as t; "
            f"t.{fn}(*{list(args)!r})")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)


@pytest.fixture(scope="module")
def children():
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"counts": f"{tmp}/counts.json", "cells": f"{tmp}/cells.json"}
        procs = {"counts": _spawn("_child_counts", paths["counts"]),
                 "cells": _spawn("_child_cells", paths["cells"], f"{tmp}/out")}
        results = {}
        for name, proc in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            assert proc.returncode == 0, f"{name}:\n{stdout[-3000:]}\n{stderr[-6000:]}"
            results[name] = json.loads(Path(paths[name]).read_text())
        yield results


# ---------------------------------------------------------------------- #
# the analysis
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("op", sorted(J_WIRE_FACTOR))
def test_wire_factors_equal_the_references(op):
    assert sorted(oa._WIRE_FACTOR) == sorted(J_WIRE_FACTOR)
    for g in (2, 4, 8, 16, 256):
        assert oa._WIRE_FACTOR[op](g) == J_WIRE_FACTOR[op](g), (op, g)


def test_redistribute_is_one_all_gather_of_seven_eighths(children):
    st = children["counts"]["redistribute"]
    assert st["collective_counts"] == {"all-gather": 1}
    assert st["collective_bytes"] == 7 / 8 * 1024 * 64 * 4
    assert st["flops"] == 0


def test_sharded_matmul_counts_one_ranks_share(children):
    st = children["counts"]["matmul"]
    assert st["flops"] == 2 * (1024 // 8) * 64 * 32
    assert st["collective_counts"] == {}


def test_reference_scan_program_flops_in_the_references_band(children):
    """The reference's own band, 0.6–1.7 × the analytic per-device count
    (3 products a layer), and exactly the products the gradient needs: all
    but layer 0's input gradient (the input takes none), 3L − 1."""
    c = children["counts"]
    product = 2 * B_REF * D_REF * D_REF / 8
    analytic = 3 * L_REF * product
    ratio = c["scan"]["flops"] / analytic
    print(f"per-device FLOPs: port {c['scan']['flops']:.0f}, reference analyze_hlo "
          f"{c['scan_reference_flops']:.0f}, analytic {analytic:.0f}")
    assert 0.6 < ratio < 1.7, (c["scan"]["flops"], analytic)
    assert c["scan"]["flops"] == (3 * L_REF - 1) * product
    assert c["scan"]["collective_bytes"] > 0


def test_reduced_train_cell_peak_and_model_flops(children):
    c = children["cells"]
    shape_only = c["shape_only"]["per_device_bytes"]
    jcfg = dataclasses.replace(j_reduced_config(j_get_arch("llama3.2-1b")), **TINY)
    tokens = TINY_SHAPE[0] * TINY_SHAPE[1]
    for mode in ("opt", "baseline"):
        fig = c[mode]
        mem = fig["memory_analysis"]
        assert mem["peak_bytes_per_device"] >= (shape_only["params"] + shape_only["adamw_moments"]
                                                + shape_only["batch"]), mode
        assert fig["model_flops"]["model_flops"] == 6 * jcfg.active_param_count() * tokens
        assert fig["ops_per_device"]["flops"] > 0 and fig["roofline"]["bound_s"] > 0
        calls = fig["ops_per_device"]["kernel_calls"]
        assert calls["flash_attention_bwd"] == TINY["num_layers"]
        assert calls["flash_attention"] == TINY["num_layers"] * (2 if jcfg.remat else 1)


def test_reduced_train_cell_wire_bytes_match_a_hand_count(children):
    """The reduced cell under FSDP alone (8 × 1): each layer's weights are
    gathered in the forward and again in the backward, the tied table twice
    (lookup and head); each stacked gradient is reduce-scattered once, the
    table's twice (its two uses); the norms' gradients and the loss's two
    sums are all-reduced.  Wire bytes: the reference's ring factors."""
    ops = children["cells"]["fsdp"]["ops_per_device"]
    g, f32, n_l, d = 8, 4, TINY["num_layers"], TINY["d_model"]
    hq, hkv = TINY["num_heads"] * TINY["head_dim"], TINY["num_kv_heads"] * TINY["head_dim"]
    layer = f32 * d * (2 * hq + 2 * hkv + 3 * TINY["d_ff"])  # wq wo wk wv wg wi wo
    table = f32 * TINY["vocab_size"] * d
    norms = f32 * (2 * n_l * d + d)  # the stacked attention and MLP norms, the final norm
    assert ops["collective_counts"] == {"all-gather": 2 + 2 * 7 * n_l,
                                        "reduce-scatter": 2 + 7, "all-reduce": 3 + 2}
    assert ops["per_collective_bytes"] == {
        "all-gather": (g - 1) / g * (2 * table + 2 * n_l * layer),
        "reduce-scatter": (g - 1) * (2 * table + n_l * layer) / g,
        "all-reduce": 2 * (g - 1) / g * (norms + 2 * f32)}


def test_modes_differ_in_collective_bytes(children):
    c = children["cells"]
    assert (c["opt"]["ops_per_device"]["collective_wire_bytes"]
            != c["baseline"]["ops_per_device"]["collective_wire_bytes"])


@pytest.mark.parametrize("name", ["llama3.2-1b__train_4k__pod1.json",
                                  "gnn_rtec_inc_compact__pod1.json",
                                  "gnn_rtec_inc_compact__pod2.json"])
def test_production_cells_write_every_key(children, name):
    res = children["cells"]["files"][name]
    assert "not_ported" not in res
    mem, ops, roof = res["memory_analysis"], res["ops_per_device"], res["roofline"]
    assert mem["peak_bytes_per_device"] > 0 and ops["flops"] > 0 and ops["hbm_bytes_raw"] > 0
    assert set(roof) == {"compute_s", "memory_s", "collective_s", "dominant", "bound_s"}
    assert "collective_counts" in ops and "collective_wire_bytes" in ops
    assert 0 < res["model_flops"]["useful_fraction"]
    if name.startswith("llama"):
        assert res["n_chips"] == 256 and ops["collective_wire_bytes"] > 0
        assert res["per_device_bytes"]["total"] < mem["peak_bytes_per_device"]


def test_cut_cells_record_their_cut():
    """``--layers`` and ``--seq``: xlstm keeps one sLSTM-led group, hymba its
    global layer 0, seamless as many encoder layers; a train or prefill
    shape's sequence is cut, a decode shape's cache is not; the model FLOPs
    are the cut cell's."""
    res = tdry.shape_cell("xlstm-1.3b", "train_4k", True, layers=2, seq=256)
    assert res["reduced"] == {"num_layers": 2, "seq_len": 256}
    cfg = tdry.production_cfg("xlstm-1.3b", 2)
    assert (cfg.num_layers, cfg.slstm_every) == (2, 2)
    assert res["model_flops"]["model_flops"] == 6 * cfg.active_param_count() * 256 * 256
    assert tdry.production_cfg("hymba-1.5b", 2).full_attn_layers == (0,)
    assert tdry.production_cfg("seamless-m4t-large-v2", 2).enc_layers == 2
    dec = tdry.shape_cell("llama3.2-1b", "decode_32k", False, layers=2, seq=256)
    assert dec["reduced"] == {"num_layers": 2}
    assert "reduced" not in tdry.shape_cell("llama3.2-1b", "train_4k", False)


def test_gnn_cells_flops_match_a_hand_count(children):
    """full layer: the rank's records × (d + 1) row-sum adds and its rows'
    update product; incremental: the delta_agg records and the constrained
    records × (d + 1), the out rows' and the constrained rows' updates."""
    c = children["counts"]
    s = 4
    full = GNN_SMALL["full"]
    d = full["d"]
    rows, edges = math.ceil(full["v"] / s), math.ceil(full["e"] / s)
    assert c["gnn_full"]["stats"]["flops"] == edges * (d + 1) + 2 * rows * d * d
    e, r, f, fe, o, halo, ws = c["gnn_inc_caps"]
    d = GNN_SMALL["inc"]["d"]
    st = c["gnn_inc"]["stats"]
    assert st["flops"] == (e + fe) * (d + 1) + 2 * (o + f) * d * d
    assert st["kernel_calls"] == {"delta_agg": 1, "segment_spmm": 1, "row_linear": 2}
    assert st["collective_counts"] == {"collective-permute": s - 1}


# ---------------------------------------------------------------------- #
# the fake routes
# ---------------------------------------------------------------------- #
def _rounded(*tensors):
    return sum(oa._rounded(t.numel() * t.element_size()) for t in tensors)


def _route_cases():
    """name → (make real inputs, call, plain call, kernel, expected outputs'
    shapes/dtypes from the inputs, extra scratch bytes)."""
    g = torch.Generator().manual_seed(0)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    def sched(e, r):
        keys = torch.randint(0, r, (e,), generator=g).numpy()
        order, row_ptr = smod.prepare_row_schedule(keys, r)
        return torch.from_numpy(row_ptr), torch.from_numpy(order)

    def scratch(records, d):
        w = -(-records // smod.ROW_SUM_CHUNK)
        return oa._rounded((2 * w * d + 2 * w) * 4) if records > smod.ROW_SUM_CHUNK else 0

    qkv = (rn(2, 4, 33, 16), rn(2, 2, 33, 16), rn(2, 2, 33, 16))
    rp, order = sched(1200, 40)
    return {
        "flash_attention": (
            qkv, lambda q, k, v: fmod.flash_attention(q, k, v, True, None, 0),
            lambda q, k, v: kref.flash_attention_ref(q, k, v, causal=True),
            fmod.KERNEL, lambda q, k, v: [(tuple(q.shape), q.dtype)], 0),
        "flash_attention_lse": (
            qkv, lambda q, k, v: fmod.flash_attention_lse(q, k, v, True, 8, 0),
            lambda q, k, v: kref.flash_attention_lse_ref(q, k, v, True, 8, 0),
            fmod.KERNEL, lambda q, k, v: [(tuple(q.shape), q.dtype),
                                          (tuple(q.shape[:3]), torch.float32)], 0),
        "flash_attention_bwd": (
            qkv + (rn(2, 4, 33, 16), rn(2, 4, 33).abs(), rn(2, 4, 33, 16)),
            lambda q, k, v, o, lse, do: fmod.flash_attention_bwd(q, k, v, o, lse, do, False),
            lambda q, k, v, o, lse, do: kref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                                     False, None, 0),
            fmod.BWD_KERNEL, lambda q, k, v, *_: [(tuple(q.shape), q.dtype),
                                                  (tuple(k.shape), k.dtype),
                                                  (tuple(v.shape), v.dtype)],
            oa._rounded(2 * 4 * 33 * 4)),
        "segment_spmm": (
            (rn(1200, 8), rp, order), lambda m, p, o: smod.segment_spmm(m, p, o, 40),
            lambda m, p, o: smod.segment_spmm_plain(m, p, o, 40), smod.KERNEL,
            lambda m, p, o: [((40, 8), torch.float32)], scratch(1200, 8)),
        "delta_agg": (
            (rn(40, 8), rn(1200, 8), rp, order), dmod.delta_agg,
            lambda s, m, p, o: dmod.delta_agg_plain(s.clone(), m, p, o), dmod.KERNEL,
            lambda s, *_: [((40, 8), torch.float32)], scratch(1200, 8)),
        "row_linear": (
            (rn(70, 24), rn(24, 16)), rmod.row_linear, rmod.row_linear_plain, rmod.KERNEL,
            lambda a, w: [((70, 16), torch.float32)], 0),
        "edge_softmax_normalize": (
            (rn(90, 2).abs(), torch.randint(-1, 30, (90,), generator=g), rn(30, 2).abs()),
            emod.edge_softmax_normalize, emod.edge_softmax_normalize_plain, emod.KERNEL,
            lambda s, d, m: [((90, 2), torch.float32)], 0),
    }


ROUTES = sorted(_route_cases())


@pytest.mark.parametrize("name", ROUTES)
def test_fake_route_allocates_the_cuda_routes_outputs_and_launches_nothing(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    inputs, call, _, kernel, expect, scratch = _route_cases()[name]
    before = kernel.launches
    with FakeTensorMode():
        fake = [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in inputs]
        with oa.OpAnalysis() as an:
            out = call(*fake)
            outs = [t for t in (out if isinstance(out, tuple) else (out,)) if t is not None]
            if name == "delta_agg":  # in place: no new output
                assert out is fake[0]
                outs = []
        mem = an.memory()
        stats = an.stats()
    want = expect(*fake)
    got = [(tuple(t.shape), t.dtype) for t in (outs or [out])]
    assert got == want
    assert all(isinstance(t, _fake.FakeTensor) and t.device.type == "cuda" for t in outs)
    assert mem["peak_bytes"] == _rounded(*outs) + scratch
    assert kernel.launches == before
    kname = "flash_attention" if name == "flash_attention_lse" else name
    assert stats.kernel_calls == {kname: 1} and stats.flops > 0 and stats.hbm_bytes > 0


@pytest.mark.parametrize("name", ROUTES)
def test_real_cpu_tensor_takes_the_plain_version(name):
    inputs, call, plain, kernel, _, _ = _route_cases()[name]
    before = kernel.launches
    args = [t.clone() for t in inputs]
    out, ref = call(*args), plain(*[t.clone() for t in inputs])
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert len(outs) == len(refs)
    for a, b in zip(outs, refs):
        assert not isinstance(a, _fake.FakeTensor)
        assert torch.equal(a, b)
    assert kernel.launches == before


def test_flash_fake_route_reports_the_visible_pairs():
    """4 · dh FLOPs a visible pair: causal with a window and an offset,
    against a count over an explicit mask."""
    sq, sk, window, off = 7, 19, 5, 9
    qpos = np.arange(sq)[:, None] + off
    kpos = np.arange(sk)[None, :]
    want = int(((kpos <= qpos) & (kpos > qpos - window)).sum())
    assert _fake.visible_pairs(sq, sk, True, window, off) == want
    assert _fake.visible_pairs(sq, sk, False, None, 0) == sq * sk
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), oa.OpAnalysis() as an:
        q = torch.empty(2, 4, sq, 16, device="cuda")
        k = torch.empty(2, 2, sk, 16, device="cuda")
        fmod.flash_attention(q, k, k, True, window, off)
    assert an.stats().flops == 4 * 16 * 2 * 4 * want
