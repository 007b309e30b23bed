"""The vocab-parallel cross entropy (``repro_torch.nn.layers.softmax_xent``)
against the reference's ``repro.nn.layers.softmax_xent`` and, under a mesh,
against the port's own plain path.

* On one device: the loss and its gradient (``jax.grad`` on the reference's
  side) for fp32 and bf16 logits, with and without a mask: the loss at 1e-6
  relative, the gradient at 1e-5 of its largest entry.
* On a 2 × 2 ``("data", "model")`` mesh of 4 gloo processes (spawned once
  for the file, ``init_method="file://…"``): the loss alone over a vocab
  of 257 (uneven over "model": 129 and 128 entries a rank) with and
  without a mask, and the training loss and gradients of a tiny llama with
  tied embeddings and of a tiny qwen2.5 with its own head, both at V = 257:
  loss 1e-6 relative, each gradient leaf 1e-5 of its largest entry, the
  existing mesh tolerances.  Each rank also reports the vocab slice it
  read and the logits' local width.
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
from repro.nn import layers as jlayers  # noqa: E402
from repro_torch.nn import layers as tlayers  # noqa: E402

V = 257  # uneven over a model axis of 2
TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4, num_kv_heads=2, head_dim=8,
            vocab_size=V)
MODELS = {"llama_tied": "llama3.2-1b", "qwen_untied": "qwen2.5-3b"}
TRAIN_B, TRAIN_S = 8, 16
XENT_SHAPE = (4, 6, V)


def _xent_inputs(seed: int, shape=(3, 5, 67)):
    rng = np.random.default_rng(seed)
    x = (4 * rng.normal(size=shape)).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    mask = (rng.random(shape[:-1]) < 0.7).astype(np.float32)
    return x, labels, mask


# ---------------------------------------------------------------------- #
# one device, against the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("masked", [False, True], ids=["mean", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradient_match_the_reference(dtype, masked):
    x, labels, mask = _xent_inputs(3)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jm = jnp.asarray(mask) if masked else None
    ref, ref_g = jax.value_and_grad(
        lambda t: jlayers.softmax_xent(t, jnp.asarray(labels), jm))(jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss = tlayers.softmax_xent(tx, torch.from_numpy(labels),
                                torch.from_numpy(mask) if masked else None)
    (grad,) = torch.autograd.grad(loss, tx)
    assert loss.dim() == 0 and loss.dtype == torch.float32
    assert grad.dtype == tx.dtype
    ref = float(ref)
    loss = float(loss.detach())
    assert abs(loss - ref) <= 1e-6 * abs(ref), (loss, ref)
    ref_g = np.asarray(ref_g.astype(jnp.float32))
    err = np.abs(grad.float().numpy() - ref_g).max() / np.abs(ref_g).max()
    assert err <= 1e-5, err


def test_gradient_is_softmax_less_onehot_and_saves_no_fp32_copy():
    """The backward is ``(softmax(x) − onehot(label)) · g`` (g = 1/N for the
    mean), and the forward saves the bf16 logits themselves, not an fp32
    copy of them."""
    x, labels, _ = _xent_inputs(5)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        loss = tlayers.softmax_xent(tx, torch.from_numpy(labels))
    (grad,) = torch.autograd.grad(loss, tx)
    n = labels.size
    want = (torch.softmax(tx.detach().float(), -1)
            - torch.nn.functional.one_hot(torch.from_numpy(labels).long(), x.shape[-1])) / n
    assert (grad.float() - want).abs().max() <= 2 ** -8 * want.abs().max()
    big = [t for t in saved if t.numel() == tx.numel()]
    assert big and all(t.dtype == torch.bfloat16 for t in big)


# ---------------------------------------------------------------------- #
# a 2 × 2 mesh of gloo processes, against the plain path
# ---------------------------------------------------------------------- #
def _tiny(get, reduced, name):
    return dataclasses.replace(reduced(get(name)), **TINY)


def _xent_case(inp, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist import activation_sharding, ashard
    from repro_torch.dist.ctx import vocab_split
    from repro_torch.dist.sharding import ShardingConfig

    out = {}
    for masked in (False, True):
        x = torch.from_numpy(inp["x"]).requires_grad_()
        y, m = torch.from_numpy(inp["labels"]), torch.from_numpy(inp["mask"])
        loss = tlayers.softmax_xent(x, y, m if masked else None)
        (grad,) = torch.autograd.grad(loss, x)

        def place(t):
            return distribute_tensor(t, mesh, [Replicate(), Replicate()], src_data_rank=None)

        dx = place(torch.from_numpy(inp["x"])).requires_grad_()
        with activation_sharding(mesh, ShardingConfig()):
            dm = ashard(place(m), "dp") if masked else None
            dloss = tlayers.softmax_xent(dx, ashard(place(y), "dp"), dm)
            split, group, offset = vocab_split(dx)
        (dgrad,) = torch.autograd.grad(dloss, dx)
        out["mask" if masked else "mean"] = {
            "loss": float(loss), "loss_mesh": float(dloss.full_tensor()),
            "grad_err": float((grad - dgrad.full_tensor()).abs().max() / grad.abs().max()),
            "local_width": split.to_local().shape[-1], "offset": offset,
            "group_size": None if group is None else group.size()}
    return out


def _train_case(cfg, tree, batch_np, mesh):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.launch.steps import shardings_for_cell
    from repro_torch.models.lm import forward
    from repro_torch.models.params import lm_params_from_numpy
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.train.tree import tree_paths

    params = lm_params_from_numpy(tree, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    loss0, _, g0 = value_and_grad(params, cfg, batch)
    sh = shardings_for_cell(cfg, ShapeConfig("tiny", TRAIN_S, TRAIN_B, "train"), mesh)
    dparams = distribute_tree(params, sh["params_sharding"])
    dbatch = distribute_tree(batch, sh["batch_sharding"])
    with activation_sharding(mesh, sh["shcfg"]):
        loss1, _, g1 = value_and_grad(dparams, cfg, dbatch)
        with torch.no_grad():
            logits = forward(dparams, cfg, dbatch["tokens"])
    grad_err = {path: float((a - b.full_tensor()).abs().max() / a.abs().max())
                for (path, a), (_, b) in zip(tree_paths(g0), tree_paths(g1))}
    return {"loss": float(loss0), "loss_mesh": float(loss1.full_tensor()), "grad_err": grad_err,
            "logits_placements": str(tuple(logits.placements)),
            "logits_local_width": logits.to_local().shape[-1]}


def _mesh_worker(rank: int, world: int, init: str, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch, reduced_config

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {"coord": mesh.get_coordinate(), "xent": _xent_case(inp["xent"], mesh)}
        for key, name in MODELS.items():
            res[key] = _train_case(_tiny(get_arch, reduced_config, name), inp[key],
                                   inp["batch"], mesh)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs():
    """Spawn the 4-process gloo group once; {rank: results}."""
    import torch.multiprocessing as mp

    rng = np.random.default_rng(11)
    x, labels, mask = _xent_inputs(7, XENT_SHAPE)
    inp = {"xent": {"x": x, "labels": labels, "mask": mask},
           "batch": {"tokens": rng.integers(0, V, (TRAIN_B, TRAIN_S)),
                     "labels": rng.integers(0, V, (TRAIN_B, TRAIN_S))}}
    for key, name in MODELS.items():
        cfg = _tiny(j_get_arch, j_reduced_config, name)
        inp[key] = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0), cfg)[0])
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(inp, f)
        mp.spawn(_mesh_worker, args=(4, f"file://{os.path.join(tmp, 'store')}", tmp), nprocs=4,
                 join=True)
        out = {}
        for rank in range(4):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out[rank] = pickle.load(f)
    return out


@pytest.mark.parametrize("case", ["mean", "mask"])
def test_uneven_vocab_loss_on_a_mesh_matches_plain(mesh_runs, case):
    """V = 257 over "model" 2: the rank at model coordinate c reads 129 − c
    entries from 129 · c, over a group of 2; loss and gradient as plain."""
    for rank in range(4):
        r = mesh_runs[rank]["xent"][case]
        c = mesh_runs[rank]["coord"][1]
        assert (r["local_width"], r["offset"], r["group_size"]) == (129 - c, 129 * c, 2), r
        assert abs(r["loss_mesh"] - r["loss"]) <= 1e-6 * abs(r["loss"]), r
        assert r["grad_err"] <= 1e-5, r


@pytest.mark.parametrize("model", sorted(MODELS))
def test_uneven_vocab_train_loss_and_grads_on_a_mesh_match_plain(mesh_runs, model):
    """Tied embeddings (the table is the head) and an untied head, both at
    V = 257: the logits stay split over "model" (129 or 128 entries a
    rank), the loss is the plain path's at 1e-6 relative and every gradient
    leaf within 1e-5 of its largest entry."""
    for rank in range(4):
        r = mesh_runs[rank][model]
        assert r["logits_placements"] == "(Shard(dim=0), Shard(dim=2))", r
        assert r["logits_local_width"] == 129 - mesh_runs[rank]["coord"][1]
        assert abs(r["loss_mesh"] - r["loss"]) <= 1e-6 * abs(r["loss"]), r
        bad = {k: e for k, e in r["grad_err"].items() if not e <= 1e-5}
        assert not bad, bad
