"""The port's distributed and launch layer against the reference's:
``nn/param.py``'s logical-axes tree, the LM half of ``dist/sharding.py``,
``dist/ctx.py``, ``launch/mesh.py``, ``launch/steps.py``'s
``shardings_for_cell``, ``launch/dryrun.py``'s per-device bytes and
``dist/pipeline.py``.

The spec logic is pure: it is held against the reference's pure functions
entry by entry on ``FakeMesh`` es (axis names and a ``devices`` array, the
reference's own test idiom), including meshes this machine cannot build.
The reference's ``shardings_for_cell`` builds ``jax.sharding.NamedSharding``
objects, which refuse a fake mesh; the tests swap in a plain holder of
``(mesh, spec)`` for it, in the reference's modules, for the test's
duration (nothing in the JAX package changes).

Execution under a mesh runs in one group of 4 gloo processes, spawned once
for the file (``init_method="file://…"`` in a temporary directory, so no
port is needed): the sharded train step of a tiny llama and of the reduced
pixtral on a 2 × 2 ``("data", "model")`` mesh against the port's unsharded
step on the same bridged weights (loss 1e-6 relative, each gradient leaf
1e-5 of its largest entry), the sharded prefill and 4 decode steps of a
tiny qwen2.5 (logits 1e-5, greedy tokens equal), ``pipeline_apply`` on a
``("stage",)`` mesh of 4 against the reference's ``sequential_reference``
run in JAX (1e-5, the reference's tolerance) and ``ashard`` inside a
context.  Parametrised tests read the group's results.
"""
import dataclasses
import functools
import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.dist.ctx as jctx  # noqa: E402
import repro.dist.sharding as jsh  # noqa: E402
import repro.launch.steps as jsteps  # noqa: E402
from repro.configs import ARCH_NAMES as J_ARCH_NAMES  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.dist.pipeline import sequential_reference as j_sequential_reference  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.dist import ashard  # noqa: E402
from repro_torch.dist import ctx as tctx  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402


class FakeMesh:
    def __init__(self, shape, axis_names):
        self.axis_names = tuple(axis_names)
        self.devices = np.zeros(shape)


MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def test_arch_names_are_the_references():
    assert sorted(ARCH_NAMES) == sorted(J_ARCH_NAMES) and list(SHAPES) == list(J_SHAPES)


# ---------------------------------------------------------------------- #
# nn/param.py: the logical-axes tree
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _ref_axes(name):
    return j_init_model(jax.random.PRNGKey(0), j_reduced_config(j_get_arch(name)))[1]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_axes_tree_equals_the_references(name):
    """The tree from the port's init (on the meta device: ``params_struct``)
    equals the reference's ``init_model(key, reduced_config(cfg))[1]`` leaf
    by leaf, for the reduced and the full config."""
    ref = _ref_axes(name)
    assert tsteps.params_struct(reduced_config(get_arch(name)))[1] == ref
    shapes, axes = tsteps.params_struct(get_arch(name))
    assert axes == ref
    assert all(t.device.type == "meta" for t in _flat(shapes).values())


def test_init_model_with_axes_values_are_init_models():
    from repro_torch.models import init_model, init_model_with_axes
    from repro_torch.train.tree import tree_paths

    cfg = reduced_config(get_arch("qwen2.5-3b"))
    a = init_model(torch.Generator().manual_seed(5), cfg)
    b, axes = init_model_with_axes(torch.Generator().manual_seed(5), cfg)
    assert axes == _ref_axes("qwen2.5-3b")
    for (pa, x), (pb, y) in zip(tree_paths(a), tree_paths(b)):
        assert pa == pb and torch.equal(x, y)


# ---------------------------------------------------------------------- #
# dist/sharding.py and dist/ctx.py: the pure spec functions
# ---------------------------------------------------------------------- #
def _axes_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _axes_leaves(v)
    else:
        yield tree


_SHCFGS = [tsh.ShardingConfig(fsdp=f, dp_axes=dp) for f in (True, False)
           for dp in (("data",), ("pod", "data"))]


@pytest.mark.parametrize("shcfg", _SHCFGS, ids=lambda c: f"fsdp{c.fsdp}-{'+'.join(c.dp_axes)}")
def test_rules_and_spec_for_axes_equal_the_references(shcfg):
    """``rules()`` and ``spec_for_axes`` of every axes leaf of every config."""
    jcfg = jsh.ShardingConfig(fsdp=shcfg.fsdp, dp_axes=shcfg.dp_axes, tp_axis=shcfg.tp_axis)
    assert shcfg.rules() == jcfg.rules()
    extra = [("heads", "mlp"), ("embed", "embed"), ("vocab", None, "unknown"), ()]
    for name in ARCH_NAMES:
        for axes in [*_axes_leaves(_ref_axes(name)), *extra]:
            assert tsh.spec_for_axes(axes, shcfg.rules()) == tuple(
                jsh.spec_for_axes(axes, jcfg.rules())), axes


_SHAPES_GRID = [(16, 64), (3, 64), (3, 5), (8, 16, 24), (2, 256, 1), (256, 4, 32, 16), (1,),
                (32,), (512, 4096), (4, 2, 2)]


@pytest.mark.parametrize("mesh", list(MESHES), ids=str)
def test_auto_spec_and_activation_spec_equal_the_references(mesh):
    """``auto_spec`` (every batch dim) and ``_activation_spec`` (the model's
    annotations and more) on a grid of shapes, for each dp configuration."""
    m = FakeMesh(*MESHES[mesh])
    annotations = [("dp", "tp"), ("dp", None, "tp"), ("tp", "dp"), ("dp",), ("tp", "tp"),
                   (None, "dp", "tp"), ()]
    for dp in (("data",), ("pod", "data")):
        shcfg = tsh.ShardingConfig(dp_axes=dp)
        jcfg = jsh.ShardingConfig(dp_axes=dp)
        for shape in _SHAPES_GRID:
            for bd in range(len(shape)):
                assert tsh.auto_spec(shape, m, shcfg, batch_dim=bd) == tuple(
                    jsh.auto_spec(shape, m, jcfg, batch_dim=bd)), (shape, bd)
            for ann in annotations:
                assert tctx._activation_spec(shape, ann, m, shcfg) == tuple(
                    jctx._activation_spec(shape, ann, m, jcfg)), (shape, ann)


def test_auto_spec_divisibility_as_the_references_test():
    m = FakeMesh((4, 8), ("data", "model"))
    sh = tsh.ShardingConfig(dp_axes=("data",))
    assert tsh.auto_spec((16, 64), m, sh, batch_dim=0) == ("data", "model")
    assert tsh.auto_spec((3, 64), m, sh, batch_dim=0)[0] is None
    assert tsh.auto_spec((3, 5), m, sh, batch_dim=0) == (None, None)


class _Holder:
    """Stands in for ``jax.sharding.NamedSharding`` in the reference's
    modules: a fake mesh is all it needs to hold."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


@functools.lru_cache(maxsize=None)
def _ref_params_struct(cfg):
    return _REF_PARAMS_STRUCT(cfg)


_REF_PARAMS_STRUCT = jsteps.params_struct


@pytest.fixture
def ref_steps(monkeypatch):
    """The reference's ``shardings_for_cell`` on fake meshes: its
    ``NamedSharding`` swapped for :class:`_Holder` and its ``params_struct``
    cached per config (each call traces a full-size init)."""
    monkeypatch.setattr(jsteps, "NamedSharding", _Holder)
    monkeypatch.setattr(jsh, "NamedSharding", _Holder)
    monkeypatch.setattr(jsteps, "params_struct", _ref_params_struct)
    return jsteps


def _flat(tree, prefix=""):
    """{path: leaf}: dicts by key, NamedTuples by field name, None skipped."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}.{k}"))
        return out
    return {} if tree is None else {prefix: tree}


def _struct(x):
    """(shape, dtype name) of an abstract leaf of either package; a host int
    (the port's cache index) counts as a 0-d int32."""
    if isinstance(x, int):
        return (), "int32"
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("mesh", list(MESHES), ids=str)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_shardings_for_cell_equal_the_references(ref_steps, name, mesh):
    """Every key of ``shardings_for_cell`` and every leaf of its abstract
    inputs (shape, dtype) and shardings (spec), for every ``SHAPES`` entry
    with FSDP on and off."""
    m = FakeMesh(*MESHES[mesh])
    for shape_name, shape in SHAPES.items():
        for fsdp in (True, False):
            tshape = ShapeConfig(shape.name, shape.seq_len, shape.global_batch, shape.kind)
            got = tsteps.shardings_for_cell(get_arch(name), tshape, m, fsdp_train=fsdp)
            ref = ref_steps.shardings_for_cell(j_get_arch(name), J_SHAPES[shape_name], m,
                                               fsdp_train=fsdp)
            where = f"{name} {shape_name} fsdp={fsdp}"
            assert set(got) == set(ref), where
            assert dataclasses.astuple(got["shcfg"]) == dataclasses.astuple(ref["shcfg"]), where
            assert got.get("s_max") == ref.get("s_max"), where
            for key in got:
                if key.endswith("_struct"):
                    g, r = _flat(got[key]), _flat(ref[key])
                    assert set(g) == set(r), (where, key)
                    for path in g:
                        assert _struct(g[path]) == _struct(r[path]), (where, key, path)
                elif key.endswith("_sharding"):
                    g, r = _flat(got[key]), _flat(ref[key])
                    assert set(g) == set(r), (where, key)
                    for path in g:
                        assert g[path].spec == tuple(r[path].spec), (where, key, path)


def test_cache_specs_with_and_without_batch_equal_the_references():
    """``cache_specs`` of each family's cache tree (hymba's ring, xLSTM's
    states) with the batch given and with the default (dim 1)."""
    from repro.launch.steps import serve_cache_struct as j_cache

    for mesh in MESHES.values():
        m = FakeMesh(*mesh)
        shcfg, jcfg = tsh.ShardingConfig(fsdp=False), jsh.ShardingConfig(fsdp=False)
        for name in ("qwen2.5-3b", "hymba-1.5b", "xlstm-1.3b", "seamless-m4t-large-v2"):
            for b in (16, 32, 3):
                got = tsh.cache_specs(tsteps.serve_cache_struct(get_arch(name), b, 2048), m,
                                      shcfg, batch=b)
                ref = jsh.cache_specs(j_cache(j_get_arch(name), b, 2048), m, jcfg, batch=b)
                assert _flat(got) == {k: tuple(v) for k, v in _flat(ref).items()}, (name, b)
            got = tsh.cache_specs(tsteps.serve_cache_struct(get_arch("qwen2.5-3b"), 16, 64), m,
                                  shcfg)
            ref = jsh.cache_specs(j_cache(j_get_arch("qwen2.5-3b"), 16, 64), m, jcfg)
            assert got.k == tuple(ref.k) and got.v == tuple(ref.v)


def test_opt_state_specs_are_zero_one_and_equal_the_references():
    for mesh in MESHES.values():
        m = FakeMesh(*mesh)
        dp = ("pod", "data") if "pod" in mesh[1] else ("data",)
        for name in ("llama3.2-1b", "qwen3-moe-30b-a3b"):
            cfg = get_arch(name)
            pstruct, axes = tsteps.params_struct(cfg)
            jstruct = _ref_params_struct(j_get_arch(name))[0]
            got = tsh.opt_state_specs(axes, m, tsh.ShardingConfig(fsdp=False, dp_axes=dp),
                                      shapes_tree=pstruct)
            fsdp = tsh.tree_shardings(axes, m, tsh.ShardingConfig(fsdp=True, dp_axes=dp),
                                      shapes_tree=pstruct)
            rules = jsh.ShardingConfig(fsdp=True, dp_axes=dp).rules()
            sizes = jsh._axis_sizes(m)
            ref_axes = _ref_axes(name)
            for (path, g), (_, f) in zip(_flat(got).items(), _flat(fsdp).items()):
                assert g.spec == f.spec, path
            flat_axes = _flat(ref_axes)
            flat_struct = {k: v for k, v in _flat(jstruct).items()}
            for path, g in _flat(got).items():
                ref = jsh._drop_indivisible(jsh.spec_for_axes(flat_axes[path], rules),
                                            flat_struct[path].shape, sizes)
                assert g.spec == tuple(ref), path


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert tsh.placements(("model", ("pod", "data")), Mesh()) == (Shard(1), Shard(1), Shard(0))
    assert tsh.placements((None, "data", None), Mesh()) == (Replicate(), Shard(1), Replicate())
    assert tsh.placements((), Mesh()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="stage"):
        tsh.placements(("stage",), Mesh())


def test_ashard_is_its_input_outside_a_context():
    x = torch.arange(12.0).reshape(3, 4)
    assert ashard(x, "dp", "tp") is x
    assert ashard(x) is x
    assert tctx.current_mesh_and_config() is None


def test_ashard_inside_a_context_refuses_a_plain_tensor():
    m = FakeMesh((2, 2), ("data", "model"))
    with tctx.activation_sharding(m, tsh.ShardingConfig()):
        assert tctx.current_mesh_and_config()[0] is m
        with pytest.raises(TypeError, match="DTensor"):
            ashard(torch.zeros(4, 4), "dp", "tp")
    assert tctx.current_mesh_and_config() is None


# ---------------------------------------------------------------------- #
# launch/mesh.py and launch/dryrun.py
# ---------------------------------------------------------------------- #
def test_production_mesh_shapes():
    """The reference's shapes and names; the stage carve out of the data
    axis; a stage count that does not divide 16 raises."""
    s = tmesh.production_mesh_shape
    assert s() == ((16, 16), ("data", "model"))
    assert s(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    assert s(pipeline_stages=4) == ((4, 4, 16), ("stage", "data", "model"))
    assert s(multi_pod=True, pipeline_stages=2) == ((2, 2, 8, 16),
                                                   ("pod", "stage", "data", "model"))
    assert s(pipeline_stages=1) == s()
    with pytest.raises(ValueError, match="divide"):
        s(pipeline_stages=3)


def test_make_production_mesh_raises_without_enough_ranks():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_dryrun_param_bytes_equal_the_references_spec_divided_shapes(ref_steps, name):
    """Per-device param bytes (bf16 production config) = Σ over the leaves
    of the reference's spec-divided shapes, on both production meshes; the
    model FLOPs are the reference's count."""
    for mp in (False, True):
        res = tdry.shape_cell(name, "train_4k", mp)
        m = FakeMesh(*MESHES["2x16x16" if mp else "16x16"])
        jcfg = dataclasses.replace(j_get_arch(name), param_dtype="bfloat16")
        ref = ref_steps.shardings_for_cell(jcfg, J_SHAPES["train_4k"], m)
        sizes = jsh._axis_sizes(m)
        want = 0
        for path, st in _flat(ref["params_struct"]).items():
            spec = _flat(ref["params_sharding"])[path].spec
            n = 1
            for d, e in zip(st.shape, tuple(spec) + (None,) * len(st.shape)):
                n *= d // int(np.prod([sizes[a] for a in jsh._as_tuple(e)]))
            want += n * st.dtype.itemsize
        assert res["per_device_bytes"]["params"] == want, mp
        assert res["n_chips"] == (512 if mp else 256)
        tokens = 256 * 4096
        assert res["model_flops"]["model_flops"] == 6 * jcfg.active_param_count() * tokens


def test_dryrun_cells_and_skips():
    assert tdry.cell_skipped("llama3.2-1b", "long_500k")
    assert not tdry.cell_skipped("hymba-1.5b", "long_500k")
    res = tdry.shape_cell("qwen2.5-3b", "decode_32k", False)
    assert res["per_device_bytes"]["cache"] > 0 and res["kind"] == "decode"
    assert res["per_device_bytes"]["total"] == sum(
        v for k, v in res["per_device_bytes"].items() if k != "total")


# ---------------------------------------------------------------------- #
# execution under a mesh: one group of 4 gloo processes for the file
# ---------------------------------------------------------------------- #
def _tiny(get, reduced, name):
    return dataclasses.replace(reduced(get(name)), num_layers=2, d_model=32, d_ff=64,
                               num_heads=4, num_kv_heads=2, head_dim=8, vocab_size=128)


def _train_case(cfg, tree, batch_np, mesh, shape):
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.models.params import lm_params_from_numpy
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.train.tree import tree_paths

    params = lm_params_from_numpy(tree, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    step = tsteps.make_train_step(cfg, OptConfig(warmup_steps=1, stable_steps=10,
                                                 decay_steps=1))
    loss0, _, g0 = value_and_grad(params, cfg, batch)
    p1, o1, m1 = step(params, adamw_init(params), batch)
    _, _, m2 = step(p1, o1, batch)

    sh = tsteps.shardings_for_cell(cfg, shape, mesh)
    dparams = distribute_tree(params, sh["params_sharding"])
    dopt = distribute_tree(adamw_init(params), sh["opt_sharding"])
    dbatch = distribute_tree(batch, sh["batch_sharding"])
    with activation_sharding(mesh, sh["shcfg"]):
        loss1, _, g1 = value_and_grad(dparams, cfg, dbatch)
        dp1, do1, dm1 = step(dparams, dopt, dbatch)
        dp2, _, dm2 = step(dp1, do1, dbatch)
    grad_err = {}
    for (path, a), (_, b) in zip(tree_paths(g0), tree_paths(g1)):
        grad_err[path] = float((a - b.full_tensor()).abs().max() / a.abs().max())
    placed = all(isinstance(p, DTensor) and tuple(p.placements) == s.placements
                 for (_, p), (_, s) in zip(tree_paths(dp2), tree_paths(sh["params_sharding"])))
    return {
        "loss": float(loss0), "loss_mesh": float(loss1.full_tensor()),
        "step1_loss": float(m1["loss"]), "step1_loss_mesh": float(dm1["loss"].full_tensor()),
        "step2_loss": float(m2["loss"]), "step2_loss_mesh": float(dm2["loss"].full_tensor()),
        "grad_err": grad_err, "placed": placed,
        "embed_placements": tuple(dp2["embed"].placements),
        "embed_spec_placements": tsh.placements(("model", "data"), mesh),
    }


def _serve_case(cfg, tree, tokens_np, mesh):
    from repro_torch.dist import activation_sharding, distribute_tree
    from repro_torch.models.params import lm_params_from_numpy

    params = lm_params_from_numpy(tree, "cpu")
    shape = ShapeConfig("tinydec", 64, 8, "decode")
    sh = tsteps.shardings_for_cell(cfg, shape, mesh)
    prefill = tsteps.make_prefill_step(cfg, sh["s_max"])
    serve = tsteps.make_serve_step(cfg)

    def run(ps, place):
        logits, cache = prefill(ps, place({"tokens": torch.from_numpy(tokens_np)},
                                          {"tokens": sh["batch_sharding"]["tokens"]}))
        outs = [logits]
        for _ in range(4):
            full = logits.full_tensor() if hasattr(logits, "full_tensor") else logits
            tok = place(full[:, -1:].argmax(-1), sh["token_sharding"])
            logits, cache = serve(ps, cache, tok)
            outs.append(logits)
        return [o.full_tensor() if hasattr(o, "full_tensor") else o for o in outs]

    plain = run(params, lambda x, s: x)
    with activation_sharding(mesh, sh["shcfg"]):
        dparams = distribute_tree(params, sh["params_sharding"])
        sharded = run(dparams, distribute_tree)
    return {"logit_err": [float((a - b).abs().max()) for a, b in zip(plain, sharded)],
            "tokens_equal": [bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                             for a, b in zip(plain, sharded)]}


def _ashard_case(mesh):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist import activation_sharding, distribute_tree

    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    dx = distribute_tree(x, tsh.NamedSharding(mesh, (None, None, None)))
    out = {}
    with activation_sharding(mesh, tsh.ShardingConfig()):
        for ann, want in [(("dp", None, "tp"), (Shard(0), Shard(2))),
                          (("tp", "dp"), (Shard(1), Shard(0))),
                          ((None, "tp", "dp"), (Shard(2), Shard(1))),
                          (("dp", "tp"), (Shard(0), Shard(1)))]:
            y = ashard(dx, *ann)
            out[ann] = (tuple(y.placements) == want, bool(torch.equal(y.full_tensor(), x)))
        # 3 rows do not divide over "data": replicated there
        y = ashard(distribute_tree(x[:3], tsh.NamedSharding(mesh, (None, None, None))),
                   "dp", "tp")
        out["indivisible"] = (tuple(y.placements) == (Replicate(), Shard(1)),
                              bool(torch.equal(y.full_tensor(), x[:3])))
    return out


def _pipeline_case(stage_mesh, pipe):
    from repro_torch.dist import pipeline_apply

    params = {k: torch.from_numpy(v) for k, v in pipe["params"].items()}
    x = torch.from_numpy(pipe["x"])

    def block(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = pipeline_apply(block, params, x, stage_mesh, num_micro=4)
    dparams = {k: tsh.distribute(v, tsh.NamedSharding(stage_mesh, ("stage", None, None)[:v.dim()]))
               for k, v in params.items()}
    out_d = pipeline_apply(block, dparams, x, stage_mesh, num_micro=2)
    return {"out": out.numpy(), "out_dtensor_params": out_d.numpy()}


def _mesh_worker(rank: int, world: int, init: str, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch as g, reduced_config as r

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        stage_mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
        res = {
            "llama": _train_case(_tiny(g, r, "llama3.2-1b"), inp["llama"], inp["llama_batch"],
                                 mesh, ShapeConfig("tiny", 16, 8, "train")),
            "pixtral": _train_case(r(g("pixtral-12b")), inp["pixtral"], inp["pixtral_batch"],
                                   mesh, ShapeConfig("tiny", 16, 4, "train")),
            "qwen_serve": _serve_case(_tiny(g, r, "qwen2.5-3b"), inp["qwen"], inp["qwen_tokens"],
                                      mesh),
            "ashard": _ashard_case(mesh),
            "pipeline": _pipeline_case(stage_mesh, inp["pipe"]),
        }
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _np_tree(cfg):
    return jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0), cfg)[0])


@pytest.fixture(scope="module")
def mesh_runs():
    """Spawn the 4-process gloo group once; {rank: results}."""
    import torch.multiprocessing as mp

    rng = np.random.default_rng(0)
    jp = j_reduced_config(j_get_arch("pixtral-12b"))
    pipe_params = {"w": rng.normal(size=(4, 16, 16)).astype(np.float32) * 0.3,
                   "b": rng.normal(size=(4, 16)).astype(np.float32) * 0.1}
    inp = {
        "llama": _np_tree(_tiny(j_get_arch, j_reduced_config, "llama3.2-1b")),
        "llama_batch": {"tokens": rng.integers(0, 128, (8, 16)),
                        "labels": rng.integers(0, 128, (8, 16))},
        "pixtral": _np_tree(jp),
        "pixtral_batch": {
            "tokens": rng.integers(0, jp.vocab_size, (4, 16)),
            "labels": rng.integers(0, jp.vocab_size, (4, 16)),
            "patches": rng.normal(size=(4, jp.num_patches, jp.d_frontend)).astype(np.float32)},
        "qwen": _np_tree(_tiny(j_get_arch, j_reduced_config, "qwen2.5-3b")),
        "qwen_tokens": rng.integers(0, 128, (8, 16)),
        "pipe": {"params": pipe_params, "x": rng.normal(size=(8, 16)).astype(np.float32)},
    }
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


@pytest.mark.parametrize("model", ["llama", "pixtral"])
def test_sharded_train_step_matches_unsharded(mesh_runs, model):
    """FSDP + TP on 2 × 2: loss 1e-6 relative, every gradient leaf within
    1e-5 of its largest entry, the first step's loss the same, a second step
    that runs with every param still in its sharding, and ``embed`` at
    spec ("model", "data")."""
    for rank in range(4):
        r = mesh_runs[rank][model]
        assert abs(r["loss_mesh"] - r["loss"]) <= 1e-6 * abs(r["loss"]), r
        assert abs(r["step1_loss_mesh"] - r["step1_loss"]) <= 1e-6 * abs(r["step1_loss"])
        bad = {k: e for k, e in r["grad_err"].items() if not e <= 1e-5}
        assert not bad, bad
        assert np.isfinite(r["step2_loss_mesh"]) and r["step2_loss_mesh"] < r["step1_loss_mesh"] + 1
        assert abs(r["step2_loss_mesh"] - r["step2_loss"]) <= 1e-5 * abs(r["step2_loss"])
        assert r["placed"]
        assert r["embed_placements"] == r["embed_spec_placements"]


def test_sharded_prefill_and_decode_match_unsharded(mesh_runs):
    for rank in range(4):
        r = mesh_runs[rank]["qwen_serve"]
        assert len(r["logit_err"]) == 5
        assert max(r["logit_err"]) <= 1e-5, r["logit_err"]
        assert all(r["tokens_equal"])


def test_pipeline_apply_matches_the_references_sequential_reference(mesh_runs):
    pipe = mesh_runs["inputs"]["pipe"]

    def block(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    want = np.asarray(j_sequential_reference(
        block, jax.tree.map(jnp.asarray, pipe["params"]), jnp.asarray(pipe["x"])))
    for rank in range(4):
        r = mesh_runs[rank]["pipeline"]
        np.testing.assert_allclose(r["out"], want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["out_dtensor_params"], want, atol=1e-5, rtol=1e-5)


def test_ashard_inside_a_context_gives_its_specs_placements(mesh_runs):
    for rank in range(4):
        for ann, (placed, same) in mesh_runs[rank]["ashard"].items():
            assert placed and same, ann
