"""The MoE, encoder-decoder, hymba and xLSTM families under a mesh: the
port's launch layer (``shardings_for_cell``, ``make_train_step``,
``make_prefill_step``, ``make_serve_step``) on DTensors inside
``activation_sharding``, against the unsharded port on the same weights.

One group of 4 gloo processes is spawned for the file (``init_method=
"file://…"`` in a temporary directory, so no port is needed) and runs every
family on a 2 × 2 ``("data", "model")`` mesh; parametrised tests read its
results.  The configs are tiny versions of the four: qwen3-moe with 4
experts, top 2 (capacity 11 of 16 tokens, so records drop); seamless with
2 + 2 layers and ``d_frontend`` 16; hymba with 2 layers, layer 0 global and
layer 1 windowed at 8 over 16 tokens; xlstm as one group of 1 sLSTM + 1
mLSTM.  Their weights are the reference's (``init_model`` in JAX, exported
as numpy, bridged by ``lm_params_from_numpy``).

Tolerances, the ones ``tests/test_torch_dist.py`` holds the dense family and
the vlm to: the mesh's loss 1e-6 relative to the unsharded one, each
gradient leaf 1e-5 of its largest entry, the losses of two AdamW steps 1e-6
and 1e-5; a prefill (``make_prefill_step``'s call of ``prefill``, with an
fp32 cache: a bf16 one would round fp32 noise of another summation order
into bf16 steps of the keys) and 4 decode steps through
``make_serve_step``, logits 1e-5 and greedy tokens equal; the unsharded
loss against the reference's in JAX 1e-5 relative (each family's port
test).  MoE also: the
mesh's Switch aux loss within 1e-6 of the unsharded one (the batch sums are
reduced before their product), the dispatch gather's gradient against
``jax.grad`` of the reference's ``moe_apply`` (1e-4 of its largest entry,
``tests/test_torch_moe.py``'s gradient tolerance), and that gradient
bitwise from run to run, on one process and on the mesh.
"""
import dataclasses
import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.params import lm_params_from_numpy  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.train.trainer import TrainConfig, synthetic_batch, value_and_grad  # noqa: E402

#: family → (arch, changes to its reduced config)
FAMILIES = {
    "moe": ("qwen3-moe-30b-a3b", dict(num_experts=4, top_k=2)),
    "encdec": ("seamless-m4t-large-v2", dict(num_layers=2, enc_layers=2, d_frontend=16)),
    "hymba": ("hymba-1.5b", dict(num_layers=2, window=8, full_attn_layers=(0,))),
    "xlstm": ("xlstm-1.3b", dict(num_layers=2, slstm_every=2)),
}
TRAIN = ShapeConfig("tiny", 16, 4, "train")
SERVE = ShapeConfig("tinydec", 16, 4, "decode")  # s_max 16: a 12-token prompt, 4 steps
PROMPT, STEPS = 12, 4
TOL_LOSS, TOL_GRAD, TOL_LOGITS, TOL_REF = 1e-6, 1e-5, 1e-5, 1e-5
TOL_DISPATCH_GRAD = 1e-4
TOP_K, CAPACITY_FACTOR = 2, 1.25  # the MoE layer of the dispatch tests


def _cfg(get, reduced, family):
    arch, kw = FAMILIES[family]
    return dataclasses.replace(reduced(get(arch)), **kw)


def _batch(cfg):
    """The trainer's synthetic batch (tokens, labels, and frames for the
    encoder-decoder) as numpy."""
    return {k: v.numpy() for k, v in synthetic_batch(
        cfg, TrainConfig(batch=TRAIN.global_batch, seq_len=TRAIN.seq_len), 0,
        device="cpu").items()}


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _train_case(cfg, tree, batch_np, mesh):
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.tree import tree_paths

    params = lm_params_from_numpy(tree, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    step = tsteps.make_train_step(cfg, OptConfig(warmup_steps=1, stable_steps=10,
                                                 decay_steps=1))
    loss0, met0, g0 = value_and_grad(params, cfg, batch)
    p1, o1, m1 = step(params, adamw_init(params), batch)
    _, _, m2 = step(p1, o1, batch)

    sh = tsteps.shardings_for_cell(cfg, TRAIN, mesh)
    dparams = distribute_tree(params, sh["params_sharding"])
    dopt = distribute_tree(adamw_init(params), sh["opt_sharding"])
    dbatch = distribute_tree(batch, sh["batch_sharding"])
    with activation_sharding(mesh, sh["shcfg"]):
        loss1, met1, g1 = value_and_grad(dparams, cfg, dbatch)
        dp1, do1, dm1 = step(dparams, dopt, dbatch)
        _, _, dm2 = step(dp1, do1, dbatch)
    grad_err = {path: float((a - b.full_tensor()).abs().max() / a.abs().max().clamp_min(1e-30))
                for (path, a), (_, b) in zip(tree_paths(g0), tree_paths(g1))}
    return {"loss": float(loss0), "loss_mesh": float(loss1.full_tensor()),
            "aux": float(met0.get("aux", 0.0)), "aux_mesh": float(_full(met1.get("aux", 0.0))),
            "step1": float(m1["loss"]), "step1_mesh": float(dm1["loss"].full_tensor()),
            "step2": float(m2["loss"]), "step2_mesh": float(dm2["loss"].full_tensor()),
            "grad_err": grad_err}


def _serve_case(cfg, tree, batch_np, mesh):
    """A prefill of ``PROMPT`` tokens and ``STEPS`` greedy decode steps into an
    fp32 cache, unsharded and on the mesh; and whether the mesh's cache sits
    at ``cache_specs``' placements with its host-int index."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.dist.sharding import cache_specs, placements

    from repro_torch.models import prefill as model_prefill

    params = lm_params_from_numpy(tree, "cpu")
    sh = tsteps.shardings_for_cell(cfg, SERVE, mesh)

    def prefill(ps, batch):  # make_prefill_step's call, with an fp32 cache
        return model_prefill(ps, cfg, batch, sh["s_max"], cache_dtype=torch.float32)

    serve = tsteps.make_serve_step(cfg)
    prompt = {k: torch.from_numpy(v[:, :PROMPT]) for k, v in batch_np.items() if k != "labels"}
    caches = []

    def run(ps, place):
        logits, cache = prefill(ps, place(prompt, {k: sh["batch_sharding"][k] for k in prompt}))
        caches.append(cache)
        outs = [logits]
        for _ in range(STEPS):
            tok = place(_full(logits)[:, -1:].argmax(-1).int(), sh["token_sharding"])
            logits, cache = serve(ps, cache, tok)
            outs.append(logits)
        return [_full(o) for o in outs], cache

    plain, _ = run(params, lambda x, s: x)
    with activation_sharding(mesh, sh["shcfg"]):
        sharded, last = run(distribute_tree(params, sh["params_sharding"]), distribute_tree)
        specs = cache_specs(caches[1], mesh, sh["shcfg"], batch=SERVE.global_batch)
    placed = all(tuple(leaf.placements) == placements(spec, mesh)
                 for leaf, spec in zip(caches[1], specs) if isinstance(leaf, DTensor))
    n_tensors = sum(isinstance(leaf, torch.Tensor) for leaf in caches[1])
    return {"logit_err": [float((a - b).abs().max()) for a, b in zip(plain, sharded)],
            "tokens_equal": [bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                             for a, b in zip(plain, sharded)],
            "cache_placed": placed and n_tensors == sum(isinstance(leaf, DTensor)
                                                        for leaf in caches[1]),
            "cache_type": type(caches[1]).__name__,
            "index": (type(last.index).__name__, last.index)}


def _dispatch_case(mesh, layer_np, x_np, g_np):
    """The MoE layer's gradient of x (through the dispatch gather's
    backward) twice on the mesh, x's rows over "data"; and a DTensor handed
    to segment_spmm."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import activation_sharding
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.kernels.segment_spmm import segment_spmm

    def grad_x():
        whole, rows = [Replicate(), Replicate()], [Shard(0), Replicate()]
        p = {k: distribute_tensor(torch.from_numpy(v), mesh, whole) for k, v in layer_np.items()}
        x = distribute_tensor(torch.from_numpy(x_np), mesh, rows).requires_grad_()
        g = distribute_tensor(torch.from_numpy(g_np), mesh, rows)
        with activation_sharding(mesh, ShardingConfig()):
            out, aux = tmoe.moe_apply(p, x, TOP_K, CAPACITY_FACTOR)
            (gx,) = torch.autograd.grad((out * g).sum() + aux, [x])
        return gx.full_tensor()

    a, b = grad_x(), grad_x()
    try:
        segment_spmm(distribute_tensor(torch.zeros(4, 3), mesh, [Shard(0), Replicate()]),
                     torch.zeros(2, dtype=torch.int32), None, 1)
        refused = False
    except TypeError as exc:
        refused = "DTensor" in str(exc)
    return {"grad_x": a.numpy(), "bitwise": bool(torch.equal(a, b)), "refused": refused}


def _mesh_worker(rank: int, world: int, init: str, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {}
        for family in FAMILIES:
            cfg = _cfg(get_arch, reduced_config, family)
            tree, batch = inp[family]
            res[family] = {"train": _train_case(cfg, tree, batch, mesh),
                           "serve": _serve_case(cfg, tree, batch, mesh)}
        res["dispatch"] = _dispatch_case(mesh, *inp["dispatch"])
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _moe_layer_inputs():
    """One MoE layer of the reference's ``init_moe`` (as numpy, D 32, E 4,
    F 16), x [4, 16, 32] and an output cotangent, from seeds."""
    tree = jmoe.init_moe(jax.random.PRNGKey(7), 1, 32, 16, 4)
    layer = {k: np.array(v.value)[0] for k, v in tree.items()}
    rng = np.random.default_rng(8)
    return (layer, rng.normal(size=(4, 16, 32)).astype(np.float32),
            rng.normal(size=(4, 16, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def family_runs():
    """Spawn the 4-process gloo group once; {rank: results, "inputs": …}."""
    import torch.multiprocessing as mp

    inp = {}
    for family in FAMILIES:
        jcfg = _cfg(j_get_arch, j_reduced_config, family)
        tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0), jcfg)[0])
        inp[family] = (tree, _batch(_cfg(get_arch, reduced_config, family)))
    inp["dispatch"] = _moe_layer_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(inp, f)
        mp.spawn(_mesh_worker, args=(4, f"file://{os.path.join(tmp, 'store')}", tmp), nprocs=4,
                 join=True)
        out = {}
        for rank in range(4):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out[rank] = pickle.load(f)
    out["inputs"] = inp
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_train_step_matches_unsharded(family_runs, family):
    """FSDP + TP on 2 × 2: the loss, every gradient leaf and two AdamW steps
    against the unsharded port."""
    for rank in range(4):
        r = family_runs[rank][family]["train"]
        assert abs(r["loss_mesh"] - r["loss"]) <= TOL_LOSS * abs(r["loss"]), r
        assert abs(r["step1_mesh"] - r["step1"]) <= TOL_LOSS * abs(r["step1"]), r
        assert abs(r["step2_mesh"] - r["step2"]) <= TOL_GRAD * abs(r["step2"]), r
        assert np.isfinite(r["step2_mesh"])
        bad = {k: e for k, e in r["grad_err"].items() if not e <= TOL_GRAD}
        assert not bad, bad
        assert len(r["grad_err"]) == len(jax.tree.leaves(family_runs["inputs"][family][0]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_prefill_and_decode_match_unsharded(family_runs, family):
    """A prefill and 4 decode steps (hymba's ring of 8 slots wraps: the
    steps run at positions 12–15) on the mesh against the unsharded port;
    the cache sits at ``cache_specs``' placements, its index a host int."""
    want_cache = {"moe": "LMCache", "encdec": "EncDecCache", "hymba": "LMCache",
                  "xlstm": "XLSTMCache"}[family]
    for rank in range(4):
        r = family_runs[rank][family]["serve"]
        assert len(r["logit_err"]) == STEPS + 1
        assert max(r["logit_err"]) <= TOL_LOGITS, r["logit_err"]
        assert all(r["tokens_equal"])
        assert r["cache_placed"] and r["cache_type"] == want_cache
        assert r["index"] == ("int", PROMPT + STEPS)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_unsharded_loss_matches_the_references(family_runs, family):
    """The port's loss (no mesh) on the bridged weights against the
    reference's ``loss_fn`` in JAX on the same weights and batch; the mesh's
    loss equals it (the test above), so the mesh is held to the reference
    too."""
    tree, batch = family_runs["inputs"][family]
    jcfg = _cfg(j_get_arch, j_reduced_config, family)
    jloss, _ = j_loss_fn(jax.tree.map(jnp.asarray, tree), jcfg,
                         {k: jnp.asarray(v) for k, v in batch.items()})
    loss = family_runs[0][family]["train"]["loss"]
    assert abs(loss - float(jloss)) <= TOL_REF * abs(float(jloss)), (loss, float(jloss))


def test_moe_aux_on_the_mesh_equals_unsharded(family_runs):
    """The Switch aux loss is a product of two batch means: on the mesh each
    is reduced over the batch's split before the product."""
    for rank in range(4):
        r = family_runs[rank]["moe"]["train"]
        assert r["aux"] > 0
        assert abs(r["aux_mesh"] - r["aux"]) <= TOL_LOSS, (r["aux_mesh"], r["aux"])


def _ref_grad_x(layer, x, g):
    def f(xx):
        out, aux = jmoe.moe_apply({k: jnp.asarray(v) for k, v in layer.items()}, xx,
                                  top_k=TOP_K, capacity_factor=CAPACITY_FACTOR)
        return jnp.sum(out * jnp.asarray(g)) + aux

    return np.asarray(jax.grad(f)(jnp.asarray(x)))


def _port_grad_x(layer, x, g):
    p = {k: torch.from_numpy(v) for k, v in layer.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_apply(p, xt, TOP_K, CAPACITY_FACTOR)
    (gx,) = torch.autograd.grad((out * torch.from_numpy(g)).sum() + aux, [xt])
    return gx


def test_moe_dispatch_gradient_matches_the_references_grad(family_runs):
    """The gradient of x through the dispatch gather (summed per token in
    ``segment_spmm``) and the router, against ``jax.grad`` of the
    reference's ``moe_apply``; on one process and on the mesh."""
    layer, x, g = family_runs["inputs"]["dispatch"]
    want = _ref_grad_x(layer, x, g)
    scale = float(np.abs(want).max())
    port = _port_grad_x(layer, x, g).numpy()
    assert float(np.abs(port - want).max()) <= TOL_DISPATCH_GRAD * scale
    for rank in range(4):
        mesh = family_runs[rank]["dispatch"]["grad_x"]
        assert float(np.abs(mesh - want).max()) <= TOL_DISPATCH_GRAD * scale


def test_moe_dispatch_gradient_is_bitwise_from_run_to_run(family_runs):
    layer, x, g = family_runs["inputs"]["dispatch"]
    runs = [_port_grad_x(layer, x, g) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    assert all(family_runs[rank]["dispatch"]["bitwise"] for rank in range(4))


def test_segment_spmm_refuses_a_dtensor(family_runs):
    assert all(family_runs[rank]["dispatch"]["refused"] for rank in range(4))


def test_dispatch_backward_sums_each_tokens_records_in_record_order():
    """``_Dispatch``: the gather with 0 for a dropped record; its gradient
    per token is the chain of its records' gradients in record order."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32)).requires_grad_()
    key = torch.from_numpy(rng.integers(0, 7, 30))  # 6 rows; key 6 is dropped
    xs = tmoe._Dispatch.apply(x, key)
    assert torch.equal(xs, torch.cat([x.detach(), torch.zeros(1, 5)])[key])
    g = torch.from_numpy(rng.normal(size=(30, 5)).astype(np.float32))
    (gx,) = torch.autograd.grad((xs * g).sum(), [x])
    ref = torch.zeros(6, 5)
    for i in range(30):
        if key[i] < 6:
            ref[key[i]] = ref[key[i]] + g[i]
    assert torch.equal(gx, ref)
