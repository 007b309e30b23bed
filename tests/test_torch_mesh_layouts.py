"""The reference's production-mesh layouts in the port: decode caches made in
their shards, KV heads read repeated where "tp" does not divide them, and
the production dry run's cells that these layouts bring within the card.

* On a 2 × 2 ``("data", "model")`` mesh of 4 gloo processes (spawned once
  for the file, ``init_method="file://…"``): a prefill of each cache family
  (the dense LM's, hymba's with its SSM state, xLSTM's with its −1e30
  fields, the encoder-decoder's with its cross memory) on the mesh.  Each
  leaf's local storage holds exactly the whole leaf's bytes over its split,
  no op made a tensor of a split leaf's whole shape (a dispatch mode records
  every factory op's shape), and the cache equals the plain prefill's
  (fp32 caches, 1e-5 of each leaf's largest entry).
* On the same mesh, each family's logits split over the vocab, and an MQA
  attention (Hkv = 1, Hq = 4, "model" 2) against
  the plain path, forward and the gradients of q, k and v (1e-5 of each
  one's largest entry), with the heads each rank's kernel call saw.
* In a child process (a fake process group is process-wide): the vocab-
  parallel loss's three all-reduces counted by the dry run's analysis on a
  fake 2 × 2 group, and the production dry run
  (``repro_torch.launch.dryrun``) of llama3.2-1b
  ``train_4k`` and ``prefill_32k`` on 16 × 16.  Training fits the card's 80
  GB, holds no whole-vocab row at its peak, and its ``flash_attention``
  forward and backward count 2 of the 32 heads a rank; the prefill holds no
  whole cache and peaks within 1.15 × the reference's ``--mode baseline``
  figure for the cell, 2.906 GB (its XLA program's peak on the same mesh).
"""
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: family → (arch, changes to its reduced config)
FAMILIES = {
    "dense": ("llama3.2-1b", dict(num_layers=2)),
    "hymba": ("hymba-1.5b", dict(num_layers=2, window=8, full_attn_layers=(0,))),
    "xlstm": ("xlstm-1.3b", dict(num_layers=2, slstm_every=2)),
    "encdec": ("seamless-m4t-large-v2", dict(num_layers=2, enc_layers=2, d_frontend=16)),
}
BATCH, PROMPT, S_MAX = 4, 12, 20
MQA = dict(b=2, hq=4, hkv=1, s=24, dh=16)
XENT = (4, 6, 257)  # the loss's logits in the dry run's count: V uneven over "model" 2
REF_PREFILL_PEAK = 2.906e9  # the reference's --mode baseline, llama3.2-1b prefill_32k, 16 × 16
HBM = 80e9


def _cfg(family):
    arch, changes = FAMILIES[family]
    return dataclasses.replace(reduced_config(get_arch(arch)), **changes)


# ---------------------------------------------------------------------- #
# the gloo group
# ---------------------------------------------------------------------- #
def _factory_shapes():
    """A dispatch mode recording the shape of every tensor an op made from
    no tensor (a factory: zeros, full, empty) with storage behind it
    (DTensor's sharding propagation makes fake tensors of global shapes)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Factories(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if not any(isinstance(t, torch.Tensor) for t in tree_leaves((args, kwargs))):
                self.shapes += [tuple(t.shape) for t in tree_leaves(out)
                                if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor)
                                and t.device.type != "meta"]
            return out

    return Factories()


def _cache_case(family, mesh):
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.launch.steps import shardings_for_cell
    from repro_torch.models import init_model, prefill

    cfg = _cfg(family)
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)}
    if cfg.encdec:
        batch["frames"] = torch.randn(BATCH, PROMPT + 3, cfg.d_frontend, generator=gen)
    sh = shardings_for_cell(cfg, ShapeConfig("tiny", S_MAX, BATCH, "decode"), mesh)
    _, plain = prefill(params, cfg, batch, S_MAX, cache_dtype=torch.float32)
    dparams = distribute_tree(params, sh["params_sharding"])
    dbatch = distribute_tree(batch, {k: sh["batch_sharding"][k] for k in batch})
    with activation_sharding(mesh, sh["shcfg"]), _factory_shapes() as seen:
        _, cache = prefill(dparams, cfg, dbatch, S_MAX, cache_dtype=torch.float32)
    leaves = {}
    for name, whole, leaf in zip(plain._fields, plain, cache):
        if not isinstance(whole, torch.Tensor):  # the host-int index, an absent leaf
            leaves[name] = {"not_a_tensor": (whole, leaf)}
            continue
        split = math.prod(mesh.size(i) for i, pl in enumerate(leaf.placements)
                          if isinstance(pl, Shard))
        local = leaf.to_local()
        leaves[name] = {
            "dtensor": isinstance(leaf, DTensor), "split": split,
            "whole_bytes": whole.numel() * whole.element_size(),
            "local_storage_bytes": local.untyped_storage().nbytes(),
            "whole_made": tuple(whole.shape) in seen.shapes,
            "err": float((leaf.full_tensor() - whole).abs().max()
                         / max(float(whole.abs().max()), 1e-30))}
    return leaves


def _logits_case(family, mesh):
    """The placements of the logits of a forward on the mesh."""
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.launch.steps import shardings_for_cell
    from repro_torch.models import encdec, init_model, lm

    cfg = _cfg(family)
    gen = torch.Generator().manual_seed(1)
    params = init_model(gen, cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)}
    if cfg.encdec:
        batch["frames"] = torch.randn(BATCH, PROMPT, cfg.d_frontend, generator=gen)
    sh = shardings_for_cell(cfg, ShapeConfig("tiny", PROMPT, BATCH, "train"), mesh)
    dparams = distribute_tree(params, sh["params_sharding"])
    dbatch = distribute_tree(batch, {k: sh["batch_sharding"][k] for k in batch})
    with activation_sharding(mesh, sh["shcfg"]), torch.no_grad():
        logits = (encdec.forward(dparams, cfg, dbatch["frames"], dbatch["tokens"]) if cfg.encdec
                  else lm.forward(dparams, cfg, dbatch["tokens"]))
    return str(tuple(logits.placements))


def _mqa_case(inp, mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import activation_sharding
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.nn.attention import attention_core

    q, k, v, w = (torch.from_numpy(inp[n]) for n in ("q", "k", "v", "w"))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention_core(*qkv, True, None, 0)
    grads = torch.autograd.grad((out * w).sum(), qkv)
    seen = []
    orig = kops.flash_attention

    def spy(a, b, c, *args, **kwargs):
        seen.append((a.shape[1], b.shape[1]))
        return orig(a, b, c, *args, **kwargs)

    kops.flash_attention = spy
    try:
        dq = distribute_tensor(q, mesh, [Shard(0), Shard(1)], src_data_rank=None)
        dk, dv = (distribute_tensor(t, mesh, [Shard(0), Replicate()], src_data_rank=None)
                  for t in (k, v))
        dqkv = [t.detach().requires_grad_() for t in (dq, dk, dv)]
        with activation_sharding(mesh, ShardingConfig()):
            dout = attention_core(*dqkv, True, None, 0)
            dw = distribute_tensor(w, mesh, [Shard(0), Shard(1)], src_data_rank=None)
            dgrads = torch.autograd.grad((dout * dw).sum(), dqkv)
    finally:
        kops.flash_attention = orig

    def err(a, b):
        return float((a - b.full_tensor()).abs().max() / a.abs().max())

    return {"out_err": err(out, dout), "grad_err": [err(a, b) for a, b in zip(grads, dgrads)],
            "kernel_heads": seen, "out_placements": str(tuple(dout.placements))}


def _mesh_worker(rank: int, world: int, init: str, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {name: _cache_case(name, mesh) for name in FAMILIES}
        res["logits"] = {name: _logits_case(name, mesh) for name in FAMILIES}
        res["mqa"] = _mqa_case(inp, mesh)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------- #
# the dry run's child
# ---------------------------------------------------------------------- #
def _child_cells(out_path: str) -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import activation_sharding
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.nn.layers import softmax_xent

    out = {shape: dryrun.run_cell("llama3.2-1b", shape, False, "opt")
           for shape in ("train_4k", "prefill_32k")}
    with dryrun.fake_world(4):
        mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(*XENT), mesh, [Shard(0), Shard(2)],
                                  src_data_rank=None)
            y = distribute_tensor(torch.empty(*XENT[:2], dtype=torch.int64), mesh,
                                  [Shard(0), Replicate()], src_data_rank=None)
            with activation_sharding(mesh, ShardingConfig()), OpAnalysis() as an:
                softmax_xent(x, y)
    out["xent"] = vars(an.stats())
    Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def runs():
    """The gloo group's results by rank and the dry run's cells, run side by
    side."""
    import torch.multiprocessing as mp

    rng = np.random.default_rng(5)
    m = MQA
    inp = {"q": rng.normal(size=(m["b"], m["hq"], m["s"], m["dh"])).astype(np.float32),
           "k": rng.normal(size=(m["b"], m["hkv"], m["s"], m["dh"])).astype(np.float32),
           "v": rng.normal(size=(m["b"], m["hkv"], m["s"], m["dh"])).astype(np.float32),
           "w": rng.normal(size=(m["b"], m["hq"], m["s"], m["dh"])).astype(np.float32)}
    with tempfile.TemporaryDirectory() as tmp:
        cells = f"{tmp}/cells.json"
        code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
                f"sys.path.insert(0, {str(ROOT / 'tests')!r}); "
                f"import test_torch_mesh_layouts as t; t._child_cells({cells!r})")
        child = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, cwd=ROOT)
        try:
            with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
                pickle.dump(inp, f)
            mp.spawn(_mesh_worker, args=(4, f"file://{os.path.join(tmp, 'store')}", tmp),
                     nprocs=4, join=True)
            out = {}
            for rank in range(4):
                with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                    out[rank] = pickle.load(f)
            stdout, stderr = child.communicate(timeout=240)
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()
        assert child.returncode == 0, f"{stdout[-3000:]}\n{stderr[-6000:]}"
        out["cells"] = json.loads(Path(cells).read_text())
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cache_is_made_in_its_shards(runs, family):
    for rank in range(4):
        leaves = runs[rank][family]
        split = [r["split"] for r in leaves.values() if "split" in r]
        assert max(split) == 4, leaves  # batch over "data" and heads over "model"
        for name, r in leaves.items():
            if "not_a_tensor" in r:
                want = PROMPT if name == "index" else None
                assert r["not_a_tensor"] == (want, want), (name, r)
                continue
            assert r["dtensor"], name
            assert r["local_storage_bytes"] * r["split"] == r["whole_bytes"], (name, r)
            assert not (r["split"] > 1 and r["whole_made"]), (name, r)
            assert r["err"] <= 1e-5, (name, r)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_stay_split_over_the_vocab(runs, family):
    """Batch over "data", vocab over "model", whatever the last block leaves
    over "model" (hymba's and xLSTM's leave a partial sum)."""
    for rank in range(4):
        assert runs[rank]["logits"][family] == "(Shard(dim=0), Shard(dim=2))", family


def test_mqa_attention_on_a_mesh_matches_plain_with_its_heads_split(runs):
    """Hkv = 1 does not divide "model" 2, Hq = 4 does: each rank's kernel
    call sees 2 q heads and the 2 KV heads they read (the one KV head
    repeated), and the output stays split over the heads."""
    for rank in range(4):
        r = runs[rank]["mqa"]
        assert r["kernel_heads"] == [(2, 2)], r
        assert r["out_placements"] == "(Shard(dim=0), Shard(dim=1))", r
        assert r["out_err"] <= 1e-5, r
        assert max(r["grad_err"]) <= 1e-5, r


def test_production_train_cell_fits_without_a_whole_vocab_row(runs):
    res = runs["cells"]["train_4k"]
    mem = res["memory_analysis"]
    cfg = get_arch("llama3.2-1b")
    assert res["fits_hbm"] and mem["peak_bytes_per_device"] <= HBM, mem["peak_est_gb"]
    shapes = [s["made_by"].split(")")[0] for s in mem["peak_top_storages"]]
    assert not any(s.endswith(f", {cfg.vocab_size}") for s in shapes), shapes
    # 2 of the 32 heads a rank: 4 · dh FLOPs a visible pair forward and 10 · dh backward,
    # 16 local rows, causal over 4096
    ops = res["ops_per_device"]
    s, rows, heads = 4096, 256 // 16, cfg.num_heads // 16
    pairs = s * (s + 1) // 2
    for name, per_pair in (("flash_attention", 4), ("flash_attention_bwd", 10)):
        got = [v for k, v in ops["top_flops"].items() if k.startswith(f"{name} at")]
        calls = ops["kernel_calls"][name]
        want = calls * per_pair * cfg.resolved_head_dim * rows * heads * pairs
        assert got == [want], (name, got, calls)


def test_production_prefill_cell_holds_no_whole_cache(runs):
    res = runs["cells"]["prefill_32k"]
    mem = res["memory_analysis"]
    cfg = get_arch("llama3.2-1b")
    whole = (cfg.num_layers, 32, cfg.num_kv_heads, 32768, cfg.resolved_head_dim)
    shard = (cfg.num_layers, 2, cfg.num_kv_heads, 32768, cfg.resolved_head_dim)
    made = [s["made_by"] for s in mem["peak_top_storages"]]
    assert not any(str(whole) in m for m in made), made
    assert sum(str(shard) in m for m in made) == 2, made  # k and v, batch over "data"
    assert mem["peak_bytes_per_device"] <= 1.15 * REF_PREFILL_PEAK, mem["peak_est_gb"]


def test_loss_all_reduces_are_counted_by_the_dry_run(runs):
    """The vocab-parallel loss's forward on a fake 2 × 2 group: three
    all-reduces over "model" (row max, exp sum, the label's logit), each of
    one fp32 value a local row, at the ring's 2 · (g − 1) / g."""
    st = runs["cells"]["xent"]
    rows = XENT[0] // 2 * XENT[1]
    assert st["collective_counts"] == {"all-reduce": 3}, st
    assert st["per_collective_bytes"] == {"all-reduce": 3 * 2 * (2 - 1) / 2 * 4 * rows}, st
