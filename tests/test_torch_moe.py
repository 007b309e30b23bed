"""The port's MoE family against the JAX package's, on the same weights and tokens.

The reference's parameters go to numpy and through the weights bridge
(``lm_params_from_numpy``); inputs are made with numpy from a seed.  Both
run on the CPU: the port's combine runs ``segment_spmm``'s plain version
there.  Tolerances as in tests/test_torch_lm.py: 1e-5 for one MoE layer
(fp32, another summation order in the products), 1e-4 for the whole
reduced model in fp32, 2e-2 where a bf16 rounding can land on the other side
in one framework; gradients 1e-4 of each leaf's largest entry, the loss 1e-5
relative, as tests/test_torch_train.py.  The MoE tests of the serve path run
at dropless capacity (``capacity_factor = E / top_k``) where they compare a
prefill and decode with a full forward: which tokens overflow depends on
the context, by GShard's design (tests/test_archs_smoke.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.params import _flatten, lm_params_from_numpy  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

MOE = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
B, S, STEPS = 2, 32, 4
D, F, E, K = 64, 32, 8, 2


def _close(port, ref, tol, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _layer_params(seed=0, shared=0):
    """One layer of the reference's ``init_moe`` as numpy, [D, E] router."""
    tree = jmoe.init_moe(jax.random.PRNGKey(seed), 1, D, F, E, num_shared=shared, shared_d_ff=F)
    return {k: np.array(v.value)[0] for k, v in tree.items()}


def _both(p, x, cf):
    jo, ja = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                            top_k=K, capacity_factor=cf)
    to, ta = tmoe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), K, cf)
    return (jo, ja), (to, ta)


def _routed_counts(p, x):
    """Tokens routed to each (batch row, expert) by the reference's top-k."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), axis=-1)
    idx = np.asarray(jax.lax.top_k(probs, K)[1])
    return np.stack([np.bincount(idx[b].ravel(), minlength=E) for b in range(x.shape[0])])


# ---------------------------------------------------------------------- #
# one MoE layer
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cf", [1.25, E / K], ids=["capacity", "dropless"])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_matches_reference(cf, shared):
    p = _layer_params(shared=shared)
    x = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)
    cap = tmoe.capacity(cf, K, S, E)
    assert cap == min(int(cf * K * S / E) + 1, S)
    overflow = (_routed_counts(p, x) > cap).any()
    assert overflow == (cf == 1.25)  # capacity 11 drops some assignments here, dropless none
    (jo, ja), (to, ta) = _both(p, x, cf)
    assert to.shape == (B, S, D) and to.dtype == torch.float32 and ta.dtype == torch.float32
    _close(to, jo, 1e-5, "out")
    _close(ta, ja, 1e-5, "aux")


@pytest.mark.parametrize("tie", ["tokens", "experts"])
def test_ties_give_the_reference_selection(tie):
    """Equal scores at the capacity boundary (every token of a row the same)
    and equal router probabilities (a zero router): the lower index wins, as
    in ``jax.lax.top_k``."""
    p = _layer_params()
    rng = np.random.default_rng(2)
    if tie == "tokens":
        x = np.repeat(rng.normal(size=(B, 1, D)).astype(np.float32), S, axis=1)
    else:
        x = rng.normal(size=(B, S, D)).astype(np.float32)
        p["router"] = np.zeros_like(p["router"])
    (jo, _), (to, _) = _both(p, x, 1.25)
    _close(to, jo, 1e-5)
    cap = tmoe.capacity(1.25, K, S, E)
    kept = to.abs().sum(-1) > 0
    # every token routes to the same K experts: the first ``cap`` tokens are kept
    assert kept[:, :cap].all() and not kept[:, cap:].any()
    r = tmoe.route(torch.from_numpy(p["router"]), torch.from_numpy(x), K, 1.25)
    used = torch.nonzero(r.valid.any(-1))  # (expert, row) pairs that took tokens
    assert len(used) == K * B
    for e, b in used.tolist():
        assert r.valid[e, b].all() and torch.equal(r.sel_idx[e, b], torch.arange(cap))
    if tie == "experts":  # uniform probabilities: experts 0 .. K-1
        assert sorted(set(used[:, 0].tolist())) == list(range(K))


def test_moe_apply_is_bitwise_from_run_to_run():
    p = {k: torch.from_numpy(v) for k, v in _layer_params(3, shared=1).items()}
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(B, S, D)).astype(np.float32))
    outs = [tmoe.moe_apply(p, x, K, 1.25) for _ in range(3)]
    for o, a in outs[1:]:
        assert torch.equal(o, outs[0][0]) and torch.equal(a, outs[0][1])


def test_combine_sums_each_row_in_record_order_and_drops_the_sentinel():
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.normal(size=(40, 6)).astype(np.float32))
    key = torch.from_numpy(rng.integers(0, 9, 40))  # 8 rows; key 8 is dropped
    out = tmoe.combine(y, key, 8)
    ref = torch.zeros(8, 6)
    for i in range(40):  # one chain per row, in record order, from 0
        if key[i] < 8:
            ref[key[i]] = ref[key[i]] + y[i]
    assert torch.equal(out, ref)
    g = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    yg = y.clone().requires_grad_()
    (tmoe.combine(yg, key, 8) * g).sum().backward()
    assert torch.equal(yg.grad, torch.cat([g, torch.zeros(1, 6)])[key])


# ---------------------------------------------------------------------- #
# configs and the weights bridge
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", MOE)
def test_moe_configs_and_parameter_counts_equal_reference(name):
    port, ref = tconfigs.get_arch(name), jconfigs.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for p, r in ((port, ref), (tconfigs.reduced_config(port), jconfigs.reduced_config(ref))):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.param_count() == r.param_count()
        assert p.active_param_count() == r.active_param_count()
    red = tconfigs.reduced_config(port)
    assert (red.num_experts, red.top_k, red.moe_d_ff, red.d_ff) == (8, 2, 32, 0)
    if name == "qwen3-moe-30b-a3b":  # "a3b": about 3B active (tests/test_archs_smoke.py)
        assert 2e9 < port.active_param_count() < 5e9


def _cfgs(name, **kw):
    return (dataclasses.replace(jconfigs.reduced_config(jconfigs.get_arch(name)), **kw),
            dataclasses.replace(tconfigs.reduced_config(tconfigs.get_arch(name)), **kw))


def _ref_tree(jcfg, seed=1):
    return jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(seed), jcfg)[0])


@pytest.mark.parametrize("shared", [0, 1])
def test_weights_bridge_maps_every_moe_leaf(shared):
    jcfg, tcfg = _cfgs(MOE[0], num_shared_experts=shared)
    tree = _ref_tree(jcfg)
    params = lm_params_from_numpy(tree, "cpu")
    flat_ref, flat_port = _flatten(tree), _flatten(params)
    assert flat_ref.keys() == flat_port.keys()
    assert "mlp" not in params["blocks"]
    assert {k for k in flat_port if k.startswith("blocks/moe/")} == (
        {f"blocks/moe/{k}" for k in ("router", "wi", "wg", "wo")}
        | ({f"blocks/moe/shared_{k}" for k in ("wi", "wg", "wo")} if shared else set()))
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_port[k].numpy(), v, err_msg=k)
    # the port's own init has the same tree, shapes and dtypes
    own = _flatten(tmodels.init_model(torch.Generator().manual_seed(0), tcfg))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in flat_port.items()}


def test_weights_bridge_rejects_a_partial_moe_group():
    jcfg, _ = _cfgs(MOE[0], num_shared_experts=1)
    tree = _ref_tree(jcfg)
    dense = _ref_tree(_cfgs("llama3.2-1b")[0])
    cases = {
        "no router": lambda t: t["blocks"]["moe"].pop("router"),
        "partial shared": lambda t: t["blocks"]["moe"].pop("shared_wo"),
        "moe and mlp": lambda t: t["blocks"].update(mlp=dense["blocks"]["mlp"]),
        "neither": lambda t: t["blocks"].pop("moe"),
    }
    for what, edit in cases.items():
        t = jax.tree.map(lambda a: a, tree)
        edit(t)
        with pytest.raises(ValueError, match="does not fit"):
            lm_params_from_numpy(t, "cpu")


# ---------------------------------------------------------------------- #
# the reduced MoE models: forward, serve path, loss and gradients
# ---------------------------------------------------------------------- #
def _tokens(seed=0, s=S):
    return np.random.default_rng(seed).integers(0, 256, (B, s))


def _serve_path(params, cfg, models, tokens, cache_dtype, to_tok):
    logits, cache = models.prefill(params, cfg, {"tokens": to_tok(tokens[:, :S - STEPS])},
                                   s_max=S, cache_dtype=cache_dtype)
    outs = [logits]
    for i in range(S - STEPS, S):
        logits, cache = models.decode_step(params, cfg, to_tok(tokens[:, i:i + 1]), cache)
        outs.append(logits)
    return outs, cache


@pytest.mark.parametrize("name", MOE)
def test_moe_lm_forward_and_serve_match_reference(name):
    """At the configs' capacity (1.25): forward logits and aux, and prefill
    + teacher-forced decode into an fp32 cache, against the reference."""
    jcfg, tcfg = _cfgs(name)
    tree = _ref_tree(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")
    toks = _tokens()
    jl, ja = jmodels.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, ta = tlm.forward_with_aux(tp, tcfg, torch.from_numpy(toks))
    assert tl.shape == (B, S, tcfg.vocab_size) and float(ta) > 0
    _close(tl, jl, 1e-4, "forward")
    _close(ta, ja, 1e-5, "aux")
    assert torch.equal(tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}), tl)
    jouts, jc = _serve_path(jp, jcfg, jmodels, toks, jnp.float32, jnp.asarray)
    touts, tc = _serve_path(tp, tcfg, tmodels, toks, torch.float32, torch.from_numpy)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        _close(t, j, 1e-4, f"serve step {i}")
    assert tc.index == int(jc.index) == S
    _close(tc.k, jc.k, 1e-4, "cache k")


@pytest.mark.parametrize("name", MOE)
def test_moe_teacher_forced_decode_matches_forward_dropless(name):
    """Inside the port and in the reference, at dropless capacity: prefill
    and teacher-forced decode reproduce the full forward (the reference's
    check, tests/test_archs_smoke.py; fp32 here, so at 1e-4)."""
    jcfg, tcfg = _cfgs(name, capacity_factor=8 / 2)
    tree = _ref_tree(jcfg, seed=2)
    tp = lm_params_from_numpy(tree, "cpu")
    toks = _tokens(5)
    full = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    ref = jmodels.forward(jax.tree.map(jnp.asarray, tree), jcfg, {"tokens": jnp.asarray(toks)})[0]
    _close(full, ref, 1e-4, "forward")
    outs, _ = _serve_path(tp, tcfg, tmodels, toks, torch.float32, torch.from_numpy)
    for i, logits in enumerate(outs):
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, S - STEPS - 1 + i].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {i}")


def _assert_tree_close(port, ref, rel, what):
    fp, fr = _flatten(port), _flatten(ref)
    assert fp.keys() == fr.keys(), what
    for k, r in fr.items():
        r = np.asarray(r, np.float32)
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(fp[k].float().numpy() - r).max()) <= rel * scale, f"{what} {k}"


@pytest.mark.parametrize("name", MOE)
def test_moe_loss_and_grads_match_reference(name):
    """``lm_loss`` (CE + 0.01 · aux) and its gradient through the combine's
    autograd Function, against ``jax.value_and_grad`` of the reference's
    ``loss_fn``, at the configs' capacity."""
    jcfg, tcfg = _cfgs(name, num_layers=2)
    tree = _ref_tree(jcfg, seed=3)
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, 256, (B, 24)).astype(np.int32) for k in ("tokens", "labels")}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    loss, met, grads = ttrainer.value_and_grad(lm_params_from_numpy(tree, "cpu"), tcfg,
                                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(met["aux"]) > 0
    for port, ref in ((loss, jloss), (met["ce"], jmet["ce"]), (met["aux"], jmet["aux"])):
        assert abs(float(port) - float(ref)) <= 1e-5 * abs(float(ref))
    assert abs(float(loss) - float(met["ce"]) - 0.01 * float(met["aux"])) <= 1e-6
    _assert_tree_close(grads, jax.tree.map(np.asarray, jgrads), 1e-4, "grad")
    assert float(grads["blocks"]["moe"]["router"].abs().max()) > 0


def _jax_layer_loop(params, cfg, tokens):
    """The reference's MoE block bodies (forward; prefill + teacher-forced
    decode into a bf16 cache), one layer at a time in Python: with
    compute_dtype bf16 and fp32 params its ``lax.scan`` refuses to run
    (ROADMAP.md Queue 3 item 4)."""
    layers = [jax.tree.map(lambda a, l=l: a[l], params["blocks"])
              for l in range(cfg.num_layers)]
    x = jlm._embed(params, cfg, tokens)
    for p in layers:
        x, _, _ = jlm._attn_block(cfg, p, x, None, None, 0)
    full = jlm._logits(params, cfg, jlayers.rms_norm(x, params["final_norm"]))

    x = jlm._embed(params, cfg, tokens[:, :S - STEPS])
    caches = []
    for p in layers:
        out, k, v = jattn.attention_prefill_kv(
            p["attn"], jlayers.rms_norm(x, p["ln1"]), n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
        x = x + out
        mo, _ = jmoe.moe_apply(p["moe"], jlayers.rms_norm(x, p["ln2"]), top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor)
        x = x + mo
        pad = ((0, 0), (0, 0), (0, STEPS), (0, 0))
        caches.append(jattn.KVCache(jnp.pad(k, pad).astype(jnp.bfloat16),
                                    jnp.pad(v, pad).astype(jnp.bfloat16)))
    outs = [jlm._logits(params, cfg, jlayers.rms_norm(x, params["final_norm"])[:, -1:])]
    for i in range(S - STEPS, S):
        x = jlm._embed(params, cfg, tokens[:, i:i + 1])
        for l, p in enumerate(layers):
            x, caches[l], _ = jlm._attn_block(cfg, p, x, None, caches[l], jnp.asarray(i))
        outs.append(jlm._logits(params, cfg, jlayers.rms_norm(x, params["final_norm"])))
    return full, outs


@pytest.mark.parametrize("name", MOE)
def test_moe_bf16_compute_matches_reference_layer_loop(name):
    """compute_dtype bf16 with the default bf16 cache: the embedding rows are
    rounded to bf16 and the residual stream is fp32 from layer 0 on (fp32
    gamma), so the MoE block and its combine run in fp32, as the reference's."""
    jcfg, tcfg = _cfgs(name, compute_dtype="bfloat16")
    tree = _ref_tree(jcfg)
    tp = lm_params_from_numpy(tree, "cpu")
    toks = _tokens()
    full, outs = _jax_layer_loop(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks))
    port = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert port.dtype == torch.float32
    _close(port, full, 2e-2, "forward")
    touts, _ = _serve_path(tp, tcfg, tmodels, toks, None, torch.from_numpy)
    for i, (t, j) in enumerate(zip(touts, outs)):
        _close(t, j, 2e-2, f"serve step {i}")


def test_moe_serve_cli_runs_reduced_on_cpu(capsys):
    tserve.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--reduced", "--batch", "2",
                 "--prompt-len", "8", "--gen", "2"])
    out = capsys.readouterr().out
    assert "arch=qwen3-moe-30b-a3b device=cpu" in out and "sample:" in out
