"""The port's LM training against the JAX package's, on the same weights and data.

Weights come from the reference's init through the weights bridge
(``lm_params_from_numpy``), gradients and inputs from numpy; both packages
run on the CPU, where the port's attention runs its plain versions (forward
and backward) and the reference differentiates its plain
``flash_attention_ref``.  Tolerances: loss 1e-5 and gradients 1e-4 relative
to the leaf's largest entry (fp32, another summation order); AdamW and the
compressors 1e-6 (the same elementwise fp32 steps); the trainer's losses
1e-4 over 5 steps (Adam's first steps are ≈ sign(g), so near-zero grads may
flip: losses, not parameters, are compared); microbatch 4 against 1 at the
reference's own 0.15 (tests/test_train_infra.py); under compute_dtype bf16
the embedding's gradient, rounded to bf16 on its way back, 2^-7 (one bf16
step).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.params import _flatten, lm_params_from_numpy  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.fault import (  # noqa: E402
    FaultConfig,
    FaultTolerantRunner,
    StragglerMonitor,
    WorkerFailure,
)
from repro_torch.train.tree import tree_paths  # noqa: E402

SMALL = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, head_dim=16)
OPT = dict(peak_lr=3e-3, warmup_steps=10, stable_steps=20, decay_steps=10)


def _cfgs(name="llama3.2-1b", **kw):
    """The reduced config shrunk as tests/test_train_infra.py does, in both packages."""
    kw = {**SMALL, **kw}
    return (dataclasses.replace(jconfigs.reduced_config(jconfigs.get_arch(name)), **kw),
            dataclasses.replace(tconfigs.reduced_config(tconfigs.get_arch(name)), **kw))


def _ref_params(jcfg, seed=0):
    """The reference's init as numpy (the reference Trainer's own, at ``seed``)."""
    return jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(seed), jcfg)[0])


def _batch(seed, b=2, s=24, vocab=256):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32) for k in ("tokens", "labels")}


def _assert_tree_close(port, ref, rel, what):
    fp, fr = _flatten(port), _flatten(ref)
    assert fp.keys() == fr.keys(), what
    for k, r in fr.items():
        r = np.asarray(r, np.float32)
        p = fp[k].detach().float().numpy()
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(p - r).max()) <= rel * scale, f"{what} {k}"


# ---------------------------------------------------------------------- #
# the loss and its gradient
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", [("llama3.2-1b", {}),  # tied embeddings, MHA
                                     ("llama3.2-1b", {"num_heads": 4}),  # GQA g = 2
                                     ("qwen2.5-3b", {"num_heads": 4})])  # lm_head, qkv bias
def test_loss_and_grads_match_reference(name, kw):
    jcfg, tcfg = _cfgs(name, **kw)
    tree = _ref_params(jcfg, seed=1)
    batch = _batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, jbatch), has_aux=True)(jax.tree.map(jnp.asarray, tree))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met, grads = ttrainer.value_and_grad(lm_params_from_numpy(tree, "cpu"), tcfg, tbatch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    assert abs(float(met["ce"]) - float(jmet["ce"])) <= 1e-5 * abs(float(jmet["ce"]))
    _assert_tree_close(grads, jax.tree.map(np.asarray, jgrads), 1e-4, "grad")
    # loss_fn itself, without a gradient, gives the same loss
    loss2, _ = tmodels.loss_fn(lm_params_from_numpy(tree, "cpu"), tcfg, tbatch)
    assert float(loss2) == float(loss)


def test_bf16_compute_loss_and_grads_match_reference_layer_loop():
    """compute_dtype bf16 (the full configs' setting), against the reference's
    block bodies run one layer at a time (its ``lax.scan`` refuses a bf16
    carry that turns fp32: ROADMAP.md Queue 3 item 4).  Only the embedding's
    gathered rows are cast to bf16, so its gradient is rounded to bf16 on the
    way back and may land one bf16 step (≤ 2^-7 of a value) apart; every
    other leaf holds 1e-4."""
    jcfg, tcfg = _cfgs(num_heads=4, compute_dtype="bfloat16")
    tree = _ref_params(jcfg, seed=2)
    batch = _batch(3)

    def ref_loss(params):
        x = jlm._embed(params, jcfg, jnp.asarray(batch["tokens"]))
        for layer in range(jcfg.num_layers):
            p = jax.tree.map(lambda a, i=layer: a[i], params["blocks"])
            x, _, _ = jlm._attn_block(jcfg, p, x, None, None, 0)
        logits = jlm._logits(params, jcfg, jlayers.rms_norm(x, params["final_norm"]))
        return jlayers.softmax_xent(logits, jnp.asarray(batch["labels"]))

    jloss, jgrads = jax.jit(jax.value_and_grad(ref_loss))(jax.tree.map(jnp.asarray, tree))
    loss, _, grads = ttrainer.value_and_grad(lm_params_from_numpy(tree, "cpu"), tcfg,
                                             {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref = jax.tree.map(np.asarray, jgrads)
    embed = {"embed": grads.pop("embed")}
    _assert_tree_close(embed, {"embed": ref.pop("embed")}, 2.0 ** -7, "bf16-cast grad")
    _assert_tree_close(grads, ref, 1e-4, "grad")


def test_remat_equals_no_remat_bitwise():
    """``torch.utils.checkpoint`` recomputes each layer in the backward: on
    the CPU the loss and every gradient are the same bits."""
    jcfg, tcfg = _cfgs(num_heads=4)
    params = lm_params_from_numpy(_ref_params(jcfg), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    out = [ttrainer.value_and_grad(params, dataclasses.replace(tcfg, remat=r), batch)
           for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for (k, a), (_, b) in zip(tree_paths(out[0][2]), tree_paths(out[1][2])):
        assert torch.equal(a, b), k


def test_remat_recomputes_attention_in_the_backward():
    """Under remat the forward attention runs twice a layer (forward, then the
    recompute in the backward), and the serving path stays off autograd."""
    jcfg, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, remat=True)
    params = lm_params_from_numpy(_ref_params(jcfg), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    calls = []
    orig = fmod.flash_attention_lse
    fmod.flash_attention_lse = lambda *a: calls.append(1) or orig(*a)
    try:
        ttrainer.value_and_grad(params, tcfg, batch)
        assert len(calls) == 2 * tcfg.num_layers
        calls.clear()
        logits = tmodels.forward(params, tcfg, batch)
        assert not calls and not logits.requires_grad
    finally:
        fmod.flash_attention_lse = orig


# ---------------------------------------------------------------------- #
# optimizer, schedule, compression: the same numpy grads into both
# ---------------------------------------------------------------------- #
def _grad_trees(seed, n):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "gamma": (3, 4), "b": (7,), "nested": {"u": (2, 3, 4)}}

    def draw(sh):
        if isinstance(sh, dict):
            return {k: draw(v) for k, v in sh.items()}
        return (0.3 * rng.normal(size=sh)).astype(np.float32)

    return [draw(shapes) for _ in range(n + 1)]  # the params, then n grads


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_wsd_schedule_matches_reference_at_every_phase_boundary():
    cfg = dict(peak_lr=2.5e-3, warmup_steps=10, stable_steps=20, decay_steps=8, min_lr_frac=0.1)
    jcfg, tcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    steps = [0, 1, 9, 10, 11, 29, 30, 31, 34, 37, 38, 39, 100]
    for s in steps:
        ref = float(jopt.wsd_schedule(jnp.asarray(s), jcfg))
        assert float(topt.wsd_schedule(torch.tensor(s, dtype=torch.int32), tcfg)) == \
            pytest.approx(ref, rel=1e-6, abs=1e-12), s
    assert float(topt.wsd_schedule(0, tcfg)) == 0.0
    assert float(topt.wsd_schedule(20, tcfg)) == pytest.approx(2.5e-3)
    assert float(topt.wsd_schedule(38, tcfg)) == pytest.approx(2.5e-4)


@pytest.mark.parametrize("clip", [1.0, 100.0])  # the global-norm clip active, and not
def test_adamw_update_matches_reference(clip):
    params, *grads = _grad_trees(3, 4)
    cfg = dict(peak_lr=0.05, warmup_steps=2, stable_steps=3, decay_steps=2, grad_clip=clip)
    jp, js = jax.tree.map(jnp.asarray, params), jopt.adamw_init(jax.tree.map(jnp.asarray, params))
    tp = _to_torch(params)
    ts = topt.adamw_init(tp)
    for g in grads:
        jp, js, jlr = jopt.adamw_update(jax.tree.map(jnp.asarray, g), js, jp, jopt.OptConfig(**cfg))
        tp, ts, tlr = topt.adamw_update(_to_torch(g), ts, tp, topt.OptConfig(**cfg))
        assert float(tlr) == pytest.approx(float(jlr), rel=1e-6)
        assert int(ts.count) == int(js.count)
        for port, ref in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for (k, a), (_, b) in zip(tree_paths(port), tree_paths(jax.tree.map(np.asarray, ref))):
                np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-6, err_msg=k)
    # decay follows p.ndim ≥ 2: a stacked [L, d] gamma is decayed, a [d] vector is not
    zero = jax.tree.map(np.zeros_like, params)
    tp2, _, _ = topt.adamw_update(_to_torch(zero), topt.adamw_init(_to_torch(params)),
                                  _to_torch(params), topt.OptConfig(**cfg, weight_decay=0.5))
    assert torch.equal(tp2["b"], torch.from_numpy(params["b"]))
    assert not torch.equal(tp2["gamma"], torch.from_numpy(params["gamma"]))


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compress_grads_matches_reference(method):
    _, *grads = _grad_trees(4, 3)
    js = jcomp.init_state(jax.tree.map(jnp.asarray, grads[0]))
    ts = tcomp.init_state(_to_torch(grads[0]))
    for g in grads:  # three rounds: the residuals feed back
        jl, js, jw = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), js, method=method,
                                          topk_frac=0.25)
        tl, ts, tw = tcomp.compress_grads(_to_torch(g), ts, method=method, topk_frac=0.25)
        assert tw == jw
        for port, ref in ((tl, jl), (ts.residual, js.residual)):
            for (k, a), (_, b) in zip(tree_paths(port), tree_paths(jax.tree.map(np.asarray, ref))):
                np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-6, err_msg=k)


def test_int8_rounds_half_to_even_and_counts_one_byte_an_element():
    g = {"w": torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5, 63.5])}
    lossy, state, wire = tcomp.compress_grads(g, tcomp.init_state(g), method="int8")
    scale = 127.0 / 127.0 + 1e-12
    np.testing.assert_allclose(lossy["w"].numpy(), np.array([127, 0, 2, 2, -2, 64]) * scale)
    assert wire == 6


# ---------------------------------------------------------------------- #
# the trainer
# ---------------------------------------------------------------------- #
def test_synthetic_batch_equals_reference():
    jcfg, tcfg = _cfgs()
    for step in (0, 7):
        ref = jtrainer.synthetic_batch(jcfg, jtrainer.TrainConfig(batch=4, seq_len=16), step)
        port = ttrainer.synthetic_batch(tcfg, ttrainer.TrainConfig(batch=4, seq_len=16), step,
                                        device="cpu")
        for k in ("tokens", "labels"):
            assert port[k].dtype == torch.int32
            np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference Trainer: its initial params, its losses over 5 steps,
    and a checkpoint of its state after 3 steps (its fault-tolerant path)."""
    jcfg, _ = _cfgs()
    tc = dict(batch=4, seq_len=16, seed=0)
    t = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(steps=5, log_every=1, **tc),
                         jopt.OptConfig(**OPT))
    init = jax.tree.map(np.asarray, t.state["params"])
    losses = t.train()["losses"]
    ckpt_dir = tmp_path_factory.mktemp("ref_ckpt")
    out = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(steps=3, checkpoint_dir=str(ckpt_dir),
                                                      checkpoint_every=3, **tc),
                           jopt.OptConfig(**OPT)).train()
    assert out == {"steps": 3, "restarts": 0}
    return {"init": init, "losses": losses, "ckpt": ckpt_dir}


def _port_trainer(tcfg, init, steps=5, **kw):
    return ttrainer.Trainer(tcfg, ttrainer.TrainConfig(steps=steps, batch=4, seq_len=16,
                                                       log_every=1, **kw),
                            topt.OptConfig(**OPT), device="cpu",
                            params=lm_params_from_numpy(init, "cpu"))


def test_trainer_losses_match_reference(reference_run):
    _, tcfg = _cfgs()
    t = _port_trainer(tcfg, reference_run["init"])
    out = t.train()
    assert set(out) == {"losses", "steps", "wall_s"} and out["steps"] == 5
    np.testing.assert_allclose(out["losses"], reference_run["losses"], atol=1e-4, rtol=1e-4)
    assert [h["step"] for h in t.history] == list(range(5))
    assert all(h["seconds"] > 0 for h in t.history)


def test_reference_checkpoint_restores_into_the_port_trainer(reference_run, tmp_path):
    """The reference Trainer's checkpoint (params, moments, count, step) restores
    into the port's trainer, which goes on with the reference's next losses;
    the port's own checkpoint restores into the reference's manager."""
    jcfg, tcfg = _cfgs()
    t = _port_trainer(tcfg, reference_run["init"])
    state, step = CheckpointManager(str(reference_run["ckpt"])).restore(t.state)
    assert step == 3 and int(state["step"]) == 3 and int(state["opt"].count) == 3
    assert state["comp"] is None and state["params"]["embed"].dtype == torch.float32
    losses = []
    for s in (3, 4):
        state, loss = t.step(state, ttrainer.synthetic_batch(tcfg, t.tcfg, s, device="cpu"))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, reference_run["losses"][3:], atol=1e-4, rtol=1e-4)

    CheckpointManager(str(tmp_path)).save(5, state)
    manifest = json.loads((tmp_path / "step_5" / "manifest.json").read_text())["leaves"]
    assert "['opt'].m['blocks']['attn']['wq']" in manifest and "['opt'].count" in manifest
    template = {"params": jax.tree.map(jnp.asarray, reference_run["init"]),
                "opt": jopt.adamw_init(jax.tree.map(jnp.asarray, reference_run["init"])),
                "comp": None, "step": jnp.zeros((), jnp.int32)}
    ref_state, ref_step = jckpt.CheckpointManager(str(tmp_path)).restore(template)
    assert ref_step == 5 and int(ref_state["step"]) == 5
    for (k, a), (_, b) in zip(tree_paths(state), tree_paths(jax.tree.map(np.asarray, ref_state))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


def test_trainer_microbatch_equivalence(reference_run):
    """Gradient accumulation must not change the loss trajectory (much)."""
    _, tcfg = _cfgs(num_layers=1)
    init = _ref_params(_cfgs(num_layers=1)[0])
    o1 = _port_trainer(tcfg, init, steps=6, microbatches=1).train()
    o4 = _port_trainer(tcfg, init, steps=6, microbatches=4).train()
    assert abs(o1["losses"][-1] - o4["losses"][-1]) < 0.15
    assert o1["losses"][0] == pytest.approx(o4["losses"][0], rel=1e-5)  # same params, mean loss


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_trainer_with_compression_matches_reference(method):
    jcfg, tcfg = _cfgs(num_layers=1)
    tc = dict(steps=3, batch=4, seq_len=16, log_every=1, compression=method)
    ref = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(**tc), jopt.OptConfig(**OPT))
    init = jax.tree.map(np.asarray, ref.state["params"])
    port = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(**tc), topt.OptConfig(**OPT),
                            device="cpu", params=lm_params_from_numpy(init, "cpu"))
    np.testing.assert_allclose(port.train()["losses"], ref.train()["losses"], atol=1e-4,
                               rtol=1e-4)


def test_trainer_with_checkpointing(tmp_path):
    _, tcfg = _cfgs()
    t = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(steps=6, batch=4, seq_len=16,
                                                    checkpoint_dir=str(tmp_path),
                                                    checkpoint_every=3), device="cpu")
    assert t.train() == {"steps": 6, "restarts": 0}
    assert CheckpointManager(str(tmp_path)).all_steps() == [0, 3, 6]
    assert int(t.state["step"]) == 6


def test_make_train_step_matches_the_trainer_step():
    jcfg, tcfg = _cfgs()
    init = _ref_params(jcfg)
    t = _port_trainer(tcfg, init)
    batch = ttrainer.synthetic_batch(tcfg, t.tcfg, 0, device="cpu")
    state, loss = t.step(t.state, batch)
    step = tsteps.make_train_step(tcfg, topt.OptConfig(**OPT))
    params, opt, metrics = step(t.state["params"], t.state["opt"], batch)
    assert set(metrics) == {"loss", "lr", "ce", "aux"} and float(metrics["loss"]) == float(loss)
    for (k, a), (_, b) in zip(tree_paths(params), tree_paths(state["params"])):
        assert torch.equal(a, b), k
    assert int(opt.count) == 1


# ---------------------------------------------------------------------- #
# checkpoints and the fault-tolerant runner (tests/test_train_infra.py's cases)
# ---------------------------------------------------------------------- #
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 6, generator=g), "b": {"c": torch.arange(5.0)},
            "opt": topt.OptState(m={"x": torch.ones(2)}, v={"x": torch.zeros(2)},
                                 count=torch.tensor(seed, dtype=torch.int32))}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(3)
    mgr.save(3, t)
    restored, step = mgr.restore(_tree())
    assert step == 3 and isinstance(restored["opt"], topt.OptState)
    for (k, a), (_, b) in zip(tree_paths(restored), tree_paths(t)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    bf = {"w": torch.randn(3, 2).to(torch.bfloat16)}  # stored as fp32, restored as bf16
    mgr.save(4, bf)
    back, _ = mgr.restore(bf)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], bf["w"])


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    r, s = mgr.restore(_tree())
    assert s == 4 and torch.equal(r["a"], _tree(4)["a"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_tree())


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1), blocking=False)
    mgr.save(2, _tree(2), blocking=False)  # waits for the first: one write in flight
    mgr.wait()
    assert mgr.all_steps() == [1, 2] and not list(tmp_path.glob("*.tmp"))


def test_runner_rolls_back_on_nan(tmp_path):
    injected = {"done": False}

    def step(state, batch):
        if int(state["s"]) == 7 and not injected["done"]:  # a NaN once, at step 7
            injected["done"] = True
            return state, torch.tensor(float("nan"))
        return {"s": state["s"] + 1}, torch.tensor(1.0)

    runner = FaultTolerantRunner(step, CheckpointManager(str(tmp_path)),
                                 FaultConfig(checkpoint_every=5))
    state, n = runner.run({"s": torch.tensor(0)}, lambda s: None, 10)
    assert n == 10 and runner.restarts == 1 and int(state["s"]) == 10
    assert "FloatingPointError" in runner.events[0]


def test_runner_survives_worker_failure(tmp_path):
    fail_at = {"left": 2}
    restarted = []

    def step(state, batch):
        if int(state["s"]) == 4 and fail_at["left"] > 0:
            fail_at["left"] -= 1
            raise WorkerFailure("node-17 heartbeat lost")
        return {"s": state["s"] + 1}, torch.tensor(0.5)

    runner = FaultTolerantRunner(step, CheckpointManager(str(tmp_path)),
                                 FaultConfig(checkpoint_every=2), on_restart=restarted.append)
    state, n = runner.run({"s": torch.tensor(0)}, lambda s: None, 8)
    assert n == 8 and runner.restarts == 2 and restarted == [4, 4]


def test_runner_gives_up_after_max_restarts(tmp_path):
    def step(state, batch):
        raise WorkerFailure("flapping node")

    runner = FaultTolerantRunner(step, CheckpointManager(str(tmp_path)),
                                 FaultConfig(max_restarts=2))
    with pytest.raises(RuntimeError, match="max_restarts"):
        runner.run({"s": torch.tensor(0)}, lambda s: None, 5)


def test_straggler_monitor():
    mon = StragglerMonitor(4, FaultConfig(straggler_factor=2.0, ema=0.5))
    assert mon.stragglers() == []
    for _ in range(10):
        for w, dt in enumerate([0.1, 0.1, 0.1, 0.5]):
            mon.record(w, dt)
    assert mon.stragglers() == [3]


# ---------------------------------------------------------------------- #
# the entry point
# ---------------------------------------------------------------------- #
def test_train_cli_runs_reduced_on_cpu_and_defaults_to_the_card(capsys):
    out = tlaunch.main(["--device", "cpu", "--reduced", "--steps", "3", "--batch", "2",
                        "--seq-len", "16", "--compression", "int8", "--microbatches", "2"])
    assert out["steps"] == 3 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    assert "arch=llama3.2-1b device=cpu" in capsys.readouterr().out
    assert not torch.backends.cuda.matmul.allow_tf32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--reduced", "--steps", "1"])
