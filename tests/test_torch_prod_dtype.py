"""The port at the reference's production dtype (bf16 params, bf16 compute:
``launch/dryrun.py`` ``production_cfg``) against the JAX package's, on the
same weights: reduced pixtral-12b, llama3.2-1b, qwen3-moe-30b-a3b (dropless, so
that no token's fate depends on the order of its batch), hymba-1.5b (layer 0
global, layer 1 windowed, over a prompt past the window) and
seamless-m4t-large-v2 (2 + 2 layers, a source of other length than the
prompt), each cut to 2 layers.

The reference's bf16 parameters go to numpy (``ml_dtypes``' bfloat16) and
through the weights bridge (``lm_params_from_numpy``) bit for bit; tokens
and patches or frames are made with numpy from a seed.  At bf16 params the reference's
layer scan runs with bf16 compute (the carry stays bf16), so its own
``prefill`` and ``loss_fn`` are the reference here.  XLA's optimisations are
off for this file (compiling the reference's gradient takes ~17 s with them
and ~7 s without); the functions are the same.

Tolerances, bf16 throughout: the two frameworks round to bf16 at other
places (XLA's fusions keep some intermediates in fp32; the port rounds every
product's output), so values land a few bf16 steps apart.  The reference
against itself in fp32 on the same weights moves its gradient leaves by 1–3%
of each leaf's largest entry (measured on this file's configs).  So: the
prefill's last-token logits and each cache leaf within 2^-5 of their largest
|entry| (4 bf16 steps at it); the loss 1e-3 relative (an fp32 mean of bf16
logits: measured 1.2e-4); each gradient leaf within 2^-4 of its largest
entry (twice the reference's own bf16 noise).  On a 1 × 1 gloo mesh one
``make_train_step`` step is held bit for bit to the plain path (the same
aten ops on one rank).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.models.params import _flatten, lm_params_from_numpy  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

ARCHS = ("pixtral-12b", "llama3.2-1b", "qwen3-moe-30b-a3b", "hymba-1.5b",
         "seamless-m4t-large-v2")
PROD = dict(param_dtype="bfloat16", compute_dtype="bfloat16", num_layers=2)
B, S = 2, 16
S_HYMBA = 24  # past the reduced hymba's window of 16: layer 1's band is cut
S_SRC = 13  # the encoder-decoder's source frames
TOL_ACT = 2.0 ** -5  # logits and cache: of the largest |entry|
TOL_LOSS = 1e-3  # relative
TOL_GRAD = 2.0 ** -4  # each gradient leaf: of its largest |entry|


@pytest.fixture(scope="module", autouse=True)
def _xla_quick_compile():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _cfgs(arch, **kw):
    kw = {**PROD, **kw}
    tcfg = tconfigs.reduced_config(tconfigs.get_arch(arch))
    if tcfg.is_moe:  # dropless: every assignment kept, whatever the order
        kw.setdefault("capacity_factor", tcfg.num_experts / tcfg.top_k)
    return (dataclasses.replace(jconfigs.reduced_config(jconfigs.get_arch(arch)), **kw),
            dataclasses.replace(tcfg, **kw))


def _seq(cfg) -> int:
    return S_HYMBA if cfg.block_pattern == "hymba" else S


def _tree(jcfg, seed=1):
    return jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(seed), jcfg)[0])


def _batch(cfg, seed=0):
    """int32 tokens and their next-token labels, then a vlm's patches or an
    encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, _seq(cfg)))
    batch = {"tokens": tokens.astype(np.int32),
             "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}
    if cfg.num_patches:
        batch["patches"] = rng.normal(size=(B, cfg.num_patches, cfg.d_frontend)).astype(
            np.float32)
    if cfg.encdec:
        batch["frames"] = rng.normal(size=(B, S_SRC, cfg.d_frontend)).astype(np.float32)
    return batch


def _rel(port, ref) -> float:
    """max |port − ref| over max |ref|, in fp32."""
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.float().numpy() - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def test_bf16_leaves_cross_the_bridge_bit_for_bit():
    """Every bf16 leaf of the reference's tree arrives as a bf16 tensor with
    the same bits (numpy has no bf16 of its own: ``ml_dtypes``' bfloat16)."""
    jcfg, tcfg = _cfgs("pixtral-12b")
    tree = _tree(jcfg)
    params = lm_params_from_numpy(tree, "cpu")
    ref, got = _flatten(tree), _flatten(params)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        assert r.dtype.name == "bfloat16" and got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy(), r.view(np.int16), k)
    init = tmodels.init_model(torch.Generator().manual_seed(0), tcfg)
    assert {t.dtype for t in _flatten(init).values()} == {torch.bfloat16}  # the port's own init


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch):
    """The prefill over the prompt (after pixtral's patches; the
    encoder-decoder's over its frames) into a cache of P + S + 4 positions:
    the last-token logits, every cache leaf (k and v; hymba's SSM state and
    conv carry, the encoder-decoder's cross memory) and ``index`` against the
    reference's ``prefill``."""
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg, seed=2)
    prompt = {k: v for k, v in _batch(tcfg, seed=3).items() if k != "labels"}
    s_max = (tcfg.num_patches or 0) + _seq(tcfg) + 4
    jlogits, jcache = jmodels.prefill(jax.tree.map(jnp.asarray, tree), jcfg,
                                      {k: jnp.asarray(v) for k, v in prompt.items()}, s_max)
    logits, cache = tmodels.prefill(lm_params_from_numpy(tree, "cpu"), tcfg,
                                    {k: torch.from_numpy(v) for k, v in prompt.items()}, s_max)
    assert logits.shape == (B, 1, tcfg.vocab_size) and logits.dtype == torch.bfloat16
    assert cache.index == int(jcache.index) == s_max - 4
    assert _rel(logits, jlogits) <= TOL_ACT
    names = [n for n in cache._fields if n != "index"]
    assert names == [n for n in jcache._fields if n != "index"]
    for name in names:
        leaf, ref = getattr(cache, name), getattr(jcache, name)
        assert (leaf is None) == (ref is None), name
        if leaf is None:  # a leaf the family does not have (hymba's SSM state elsewhere)
            continue
        assert tuple(leaf.shape) == ref.shape, name
        assert str(leaf.dtype).removeprefix("torch.") == ref.dtype.name, name
        assert _rel(leaf, ref) <= TOL_ACT, name


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``lm_loss`` and its gradient (each leaf in its param's dtype: bf16, but
    for the fp32 leaves the reference keeps at bf16 params, the MoE router and
    hymba's SSD ``a_log``, ``d_skip`` and ``dt_bias``) against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg, seed=4)
    batch = _batch(tcfg, seed=5)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    loss, _, grads = ttrainer.value_and_grad(lm_params_from_numpy(tree, "cpu"), tcfg,
                                             {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= TOL_LOSS * abs(float(jloss))
    fp, fr, ft = _flatten(grads), _flatten(jax.tree.map(np.asarray, jgrads)), _flatten(tree)
    assert fp.keys() == fr.keys()
    for k, r in fr.items():
        assert str(fp[k].dtype) == f"torch.{ft[k].dtype.name}" and r.dtype == ft[k].dtype, k
        assert _rel(fp[k], r) <= TOL_GRAD, k
    if arch in ("pixtral-12b", "llama3.2-1b"):  # no fp32 leaf in these trees
        assert {t.dtype for t in fp.values()} == {torch.bfloat16}


def test_train_step_on_a_one_by_one_gloo_mesh_is_bitwise_plain():
    """pixtral (remat, patches in the batch) through ``make_train_step`` on a
    ``("data", "model")`` mesh of 1 × 1 (gloo at world size 1), placed by
    ``shardings_for_cell``: the loss and the updated bf16 params equal the
    plain step's bit for bit, and every param keeps its placement and dtype."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.launch.steps import make_train_step, shardings_for_cell
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, synthetic_batch
    from repro_torch.train.tree import tree_leaves, tree_paths

    _, cfg = _cfgs("pixtral-12b", remat=True)
    step = make_train_step(cfg, OptConfig(warmup_steps=1, stable_steps=10, decay_steps=1))
    batch = synthetic_batch(cfg, TrainConfig(batch=2, seq_len=24), 0, device="cpu")

    def weights():
        return tmodels.init_model(torch.Generator().manual_seed(0), cfg)

    plain = weights()
    new_p, _, met_p = step(plain, adamw_init(plain), batch)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        sh = shardings_for_cell(cfg, ShapeConfig("tiny", 24, 2, "train"), mesh)
        params = distribute_tree(weights(), sh["params_sharding"])
        opt = distribute_tree(adamw_init(params), sh["opt_sharding"])
        with activation_sharding(mesh, sh["shcfg"]):
            new_m, _, met_m = step(params, opt, distribute_tree(batch, sh["batch_sharding"]))
        assert torch.equal(met_m["loss"].full_tensor(), met_p["loss"])
        for (key, m), (_, p), (_, s) in zip(tree_paths(new_m), tree_paths(new_p),
                                            tree_paths(sh["params_sharding"])):
            assert isinstance(m, DTensor) and tuple(m.placements) == s.placements, key
            assert m.dtype == p.dtype == torch.bfloat16, key
            assert torch.equal(m.full_tensor(), p), key
        assert len(tree_leaves(new_m)) == len(tree_leaves(new_p))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama3.2-1b"])
def test_one_rank_placement_wraps_each_leaf_without_a_copy(arch):
    """``distribute_tree`` on a ``("data", "model")`` mesh of 1 × 1 places the
    bf16 params and the fp32 moments at ``shardings_for_cell``'s placements,
    sharded ones included, with no second allocation: each DTensor's local
    shard is the leaf itself (its storage, shape and strides), and keeps the
    leaf's ``requires_grad``.  (``distribute_tensor`` copies each leaf it
    shards: qwen3-moe's 61 GB of bf16 weights and a copy of their largest leaf
    did not fit an 80 GB card.)"""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import distribute_tree
    from repro_torch.launch.steps import shardings_for_cell
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.tree import tree_paths

    _, cfg = _cfgs(arch)
    params = tmodels.init_model(torch.Generator().manual_seed(0), cfg)
    opt = adamw_init(params)
    next(iter(tree_paths(params)))[1].requires_grad_(True)  # one leaf that requires grad
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        sh = shardings_for_cell(cfg, ShapeConfig("tiny", S, 2, "train"), mesh)
        n_shard = 0
        for tree, shardings in ((params, sh["params_sharding"]), (opt, sh["opt_sharding"])):
            placed = distribute_tree(tree, shardings)
            for (key, x), (_, d), (_, s) in zip(tree_paths(tree), tree_paths(placed),
                                                tree_paths(shardings)):
                assert isinstance(d, DTensor) and tuple(d.placements) == s.placements, key
                local = d.to_local()
                assert local.untyped_storage().data_ptr() == x.untyped_storage().data_ptr(), key
                assert (local.shape, local.stride(), local.dtype) == \
                    (x.shape, x.stride(), x.dtype), key
                assert d.shape == x.shape and d.requires_grad == x.requires_grad, key
                assert d.is_leaf, key
                n_shard += any(isinstance(p, Shard) for p in d.placements)
        assert n_shard > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama3.2-1b"])
def test_prefill_and_decode_at_batch_one_on_a_one_by_one_mesh_are_bitwise_plain(arch):
    """``make_prefill_step`` and one ``make_serve_step`` at batch 1 (the full-depth
    qwen3-moe prefill's batch on one card) on a ``("data", "model")`` mesh of 1 ×
    1, placed by ``shardings_for_cell``: the logits and every cache leaf equal
    the plain path's bit for bit.  The batch dim of 1 is not split over the data
    axis of 1 (``dist/ctx.py`` ``_splits``): split, DTensor's view rules dropped
    it as a singleton and refused the flatten of ``x @ wq``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.dist.ctx import _activation_spec
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, shardings_for_cell

    _, cfg = _cfgs(arch)
    s_max = S + 2
    params = tmodels.init_model(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(_batch(cfg, seed=7)["tokens"][:1])
    step, serve_step = make_prefill_step(cfg, s_max), make_serve_step(cfg)
    logits, cache = step(params, {"tokens": tokens})
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    logits2, cache2 = serve_step(params, cache, tok)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        sh = shardings_for_cell(cfg, ShapeConfig("tiny", S, 1, "prefill"), mesh)
        assert _activation_spec((1, S, cfg.d_model), ("dp", None, "tp"), mesh, sh["shcfg"]) \
            == (None, None, "model")
        dparams = distribute_tree(params, sh["params_sharding"])
        with activation_sharding(mesh, sh["shcfg"]):
            mlogits, mcache = step(dparams, distribute_tree({"tokens": tokens},
                                                            sh["batch_sharding"]))
            assert torch.equal(mlogits.full_tensor(), logits)
            mlogits2, mcache2 = serve_step(dparams, mcache,
                                           distribute_tree(tok, sh["token_sharding"]))
        assert torch.equal(mlogits2.full_tensor(), logits2)
        for name in ("k", "v"):
            assert torch.equal(getattr(mcache2, name).full_tensor(), getattr(cache2, name)), name
        assert mcache2.index == cache2.index == S + 1
    finally:
        dist.destroy_process_group()
