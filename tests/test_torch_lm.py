"""The port's dense LM against the JAX package's, on the same weights and tokens.

The reference's parameters go to numpy and through the weights bridge
(``repro_torch.models.params.lm_params_from_numpy``); tokens and inputs are
made with numpy from a seed.  Both run on the CPU: the port's attention
kernel runs its plain version there.  Tolerances: 1e-6 for the layers and
1e-5 for one attention layer (fp32, another summation order), 1e-4 for the
whole reduced model in fp32, 2e-2 wherever a bf16 rounding can land on the
other side in one framework (the reference's own tolerance for its
teacher-forced check, tests/test_archs_smoke.py).
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.params import _flatten, lm_params_from_numpy  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import layers as tlayers  # noqa: E402

DENSE = ["llama3.2-1b", "qwen2.5-3b"]  # tied / untied with qkv bias
B, S, STEPS = 2, 32, 4


def _cfgs(name, **kw):
    """The reduced config in both packages, with the same overrides."""
    return (dataclasses.replace(jconfigs.reduced_config(jconfigs.get_arch(name)), **kw),
            dataclasses.replace(tconfigs.reduced_config(tconfigs.get_arch(name)), **kw))


def _weights(jcfg, seed=1):
    """The reference's init, as numpy; zero-initialised biases get values so
    that the bias path is exercised."""
    tree = jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(seed), jcfg)[0])
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv"):
        if k in tree["blocks"]["attn"]:
            leaf = tree["blocks"]["attn"][k]
            tree["blocks"]["attn"][k] = (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")


def _tokens(seed=0, s=S):
    return np.random.default_rng(seed).integers(0, 256, (B, s))


def _close(port, ref, tol, msg=""):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


# ---------------------------------------------------------------------- #
# configs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", tconfigs.ARCH_NAMES)
def test_dense_configs_equal_reference(name):
    port, ref = tconfigs.get_arch(name), jconfigs.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert (dataclasses.asdict(tconfigs.reduced_config(port))
            == dataclasses.asdict(jconfigs.reduced_config(ref)))


def test_unported_families_raise():
    assert set(tconfigs.ARCH_NAMES) | set(tconfigs.NOT_PORTED) == set(jconfigs.ARCH_NAMES)
    for name in tconfigs.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 10"):
            tconfigs.get_arch(name)
    with pytest.raises(KeyError):
        tconfigs.get_arch("gpt-5")
    assert len(tconfigs.NOT_PORTED) == 4 and not any(
        jconfigs.get_arch(n).is_moe for n in tconfigs.NOT_PORTED)
    # the MoE family builds (tests/test_torch_moe.py holds it to the reference)
    moe = tconfigs.reduced_config(tconfigs.get_arch("qwen3-moe-30b-a3b"))
    assert "moe" in tmodels.init_model(torch.Generator().manual_seed(0), moe)["blocks"]
    dense = tconfigs.reduced_config(tconfigs.get_arch("llama3.2-1b"))
    for what, kw in (("10d", dict(block_pattern="hymba")), ("10d", dict(block_pattern="xlstm")),
                     ("10f", dict(num_patches=8)), ("10e", dict(encdec=True))):
        with pytest.raises(NotImplementedError, match=what):
            tmodels.init_model(torch.Generator().manual_seed(0), dataclasses.replace(dense, **kw))
        with pytest.raises(NotImplementedError, match=what):
            tmodels.init_cache(dataclasses.replace(moe, **kw), 1, 8, device="cpu")


def test_llama_full_width_is_1_236b_parameters():
    assert round(tconfigs.get_arch("llama3.2-1b").param_count() / 1e6) == 1236


# ---------------------------------------------------------------------- #
# layers and attention
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["rms_norm", "rms_norm_bf16", "rope", "rope_batched",
                                  "swiglu", "layer_norm", "softmax_xent", "softmax_xent_mask"])
def test_layers_match_reference(case):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 4, 32, 16)).astype(np.float32)
    if case == "layer_norm":
        gamma, beta = (rng.normal(size=16).astype(np.float32) for _ in range(2))
        ref = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
        port = tlayers.layer_norm(*map(torch.from_numpy, (x, gamma, beta)))
    elif case.startswith("softmax_xent"):
        labels = rng.integers(0, 16, x.shape[:-1]).astype(np.int32)
        mask = (rng.random(x.shape[:-1]) < 0.7).astype(np.float32) if case.endswith("mask") \
            else None
        ref = jlayers.softmax_xent(jnp.asarray(4 * x), jnp.asarray(labels),
                                   None if mask is None else jnp.asarray(mask))
        port = tlayers.softmax_xent(torch.from_numpy(4 * x), torch.from_numpy(labels),
                                    None if mask is None else torch.from_numpy(mask))
        assert port.dim() == 0 and port.dtype == torch.float32
    elif case.startswith("rms_norm"):
        gamma = rng.normal(size=16).astype(np.float32)
        dt = "bfloat16" if case.endswith("bf16") else "float32"
        ref = jlayers.rms_norm(jnp.asarray(x, getattr(jnp, dt)), jnp.asarray(gamma))
        port = tlayers.rms_norm(torch.from_numpy(x).to(getattr(torch, dt)),
                                torch.from_numpy(gamma))
        assert port.dtype == torch.float32 and ref.dtype == jnp.float32  # bf16 · fp32 gamma
    elif case.startswith("rope"):
        pos = rng.integers(0, 64, (2, 32)) if case == "rope_batched" else np.arange(32)
        ref = jlayers.apply_rope(jnp.asarray(x), jlayers.rope_freqs(16, 5e5, jnp.asarray(pos)))
        angles = tlayers.rope_freqs(16, 5e5, torch.from_numpy(pos))
        np.testing.assert_allclose(angles.numpy(),
                                   np.asarray(jlayers.rope_freqs(16, 5e5, jnp.asarray(pos))),
                                   atol=1e-6, rtol=1e-6)
        port = tlayers.apply_rope(torch.from_numpy(x), angles)
    else:
        w = [rng.normal(size=s).astype(np.float32) / 4 for s in ((16, 24), (16, 24), (24, 16))]
        ref = jlayers.swiglu(jnp.asarray(x), *map(jnp.asarray, w))
        port = tlayers.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w))
    _close(port, ref, 1e-6)


@pytest.mark.parametrize("extra", [{}, {"qkv_bias": True}, {"qk_norm": True}])
def test_attention_apply_prefill_and_decode_match_reference(extra):
    """One layer: prefill S rows into an fp32 cache, then decode steps
    against it (the kernel path, then the grouped-GQA path)."""
    d, hq, hkv, dh, s_max, s = 64, 4, 2, 16, 24, 20
    kw = dict(n_heads=hq, n_kv=hkv, head_dim=dh, rope_theta=1e4)
    p = {k: np.array(par.value)[0] for k, par in jattn.init_attention(
        jax.random.PRNGKey(3), 1, d, hq, hkv, dh, dtype=jnp.float32, **extra).items()}
    rng = np.random.default_rng(4)
    for k in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if k in p:
            p[k] = (p[k] + 0.1 * rng.normal(size=p[k].shape)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = rng.normal(size=(B, s_max, d)).astype(np.float32)

    zeros = np.zeros((B, hkv, s_max, dh), np.float32)
    jc = jattn.KVCache(jnp.asarray(zeros), jnp.asarray(zeros))
    tc = tattn.KVCache(torch.zeros(B, hkv, s_max, dh), torch.zeros(B, hkv, s_max, dh))
    jo, jc = jattn.attention_apply(jp, jnp.asarray(x[:, :s]), cache=jc, **kw)
    to, tc = tattn.attention_apply(tp, torch.from_numpy(x[:, :s]), cache=tc, **kw)
    _close(to, jo, 1e-5, "prefill")
    _close(tc.k, jc.k, 1e-5, "prefill cache")
    for i in range(s, s_max):
        jo, jc = jattn.attention_apply(jp, jnp.asarray(x[:, i:i + 1]), cache=jc,
                                       cache_index=jnp.asarray(i), **kw)
        to, tc = tattn.attention_apply(tp, torch.from_numpy(x[:, i:i + 1]), cache=tc,
                                       cache_index=i, **kw)
        _close(to, jo, 1e-5, f"decode {i}")
    _close(tc.v, jc.v, 1e-5, "decoded cache")
    jo, _, _ = jattn.attention_prefill_kv(jp, jnp.asarray(x), window=8, **kw)
    to, _, _ = tattn.attention_prefill_kv(tp, torch.from_numpy(x), window=8, **kw)
    _close(to, jo, 1e-5, "windowed prefill")


# ---------------------------------------------------------------------- #
# weights bridge
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", DENSE)
def test_weights_bridge_maps_every_leaf(name):
    jcfg, _ = _cfgs(name)
    tree = jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(0), jcfg)[0])
    params = lm_params_from_numpy(tree, "cpu")
    flat_ref, flat_port = _flatten(tree), _flatten(params)
    assert flat_ref.keys() == flat_port.keys()
    for k, v in flat_ref.items():
        assert flat_port[k].dtype == torch.float32
        np.testing.assert_array_equal(flat_port[k].numpy(), v, err_msg=k)
    assert ("lm_head" in params) == (not jcfg.tie_embeddings)
    assert ("bq" in params["blocks"]["attn"]) == jcfg.qkv_bias


def test_weights_bridge_rejects_missing_or_extra_leaf():
    jcfg, _ = _cfgs("qwen2.5-3b")
    tree = jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(0), jcfg)[0])
    cases = {
        "missing": lambda t: t["blocks"]["mlp"].pop("wi"),
        "partial bias": lambda t: t["blocks"]["attn"].pop("bk"),
        "extra": lambda t: t["blocks"]["attn"].update(wz=np.zeros(3, np.float32)),
        "extra top": lambda t: t.update(patch_proj=np.zeros(3, np.float32)),
    }
    for what, edit in cases.items():
        t = jax.tree.map(lambda a: a, tree)
        edit(t)
        with pytest.raises(ValueError, match="does not fit"):
            lm_params_from_numpy(t, "cpu")


# ---------------------------------------------------------------------- #
# the model: forward, prefill, decode
# ---------------------------------------------------------------------- #
def _serve_path(params, cfg, models, tokens, cache_dtype, to_tok):
    """prefill S - STEPS tokens, then decode the last STEPS teacher-forced;
    returns [prefill logits, decode logits …] and the final cache."""
    logits, cache = models.prefill(params, cfg, {"tokens": to_tok(tokens[:, :S - STEPS])},
                                   s_max=S, cache_dtype=cache_dtype)
    outs = [logits]
    for i in range(S - STEPS, S):
        logits, cache = models.decode_step(params, cfg, to_tok(tokens[:, i:i + 1]), cache)
        outs.append(logits)
    return outs, cache


def _both_serve(name, jcfg, tcfg, jcache, tcache):
    jp, tp = _weights(jcfg)
    toks = _tokens()
    jouts, jc = _serve_path(jp, jcfg, jmodels, toks, jcache, jnp.asarray)
    touts, tc = _serve_path(tp, tcfg, tmodels, toks, tcache, torch.from_numpy)
    return jp, tp, toks, jouts, touts, jc, tc


@pytest.mark.parametrize("name", DENSE)
def test_lm_matches_reference_fp32(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp, toks, jouts, touts, jc, tc = _both_serve(name, jcfg, tcfg, jnp.float32,
                                                     torch.float32)
    ref = jmodels.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})[0]
    port = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert port.shape == (B, S, tcfg.vocab_size)
    _close(port, ref, 1e-4, "forward")
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert t.shape == (B, 1, tcfg.vocab_size)
        _close(t, j, 1e-4, f"serve step {i}")
    assert tc.index == int(jc.index) == S
    _close(tc.k, jc.k, 1e-4, "cache k")
    _close(tc.v, jc.v, 1e-4, "cache v")


@pytest.mark.parametrize("name", DENSE)
def test_lm_bf16_cache_matches_reference(name):
    """The default cache dtype is bf16 in both; decode casts q to it."""
    jcfg, tcfg = _cfgs(name)
    _, _, _, jouts, touts, jc, tc = _both_serve(name, jcfg, tcfg, None, None)
    assert tc.k.dtype == torch.bfloat16 and jc.k.dtype == jnp.bfloat16
    for i, (t, j) in enumerate(zip(touts, jouts)):
        _close(t, j, 2e-2, f"serve step {i}")
    _close(tc.k, jc.k, 2e-2, "cache k")


def _jax_layer_loop(params, cfg, tokens):
    """The reference's scan bodies (forward; prefill + teacher-forced decode),
    run one layer at a time in Python.  With compute_dtype bf16 and fp32
    params the reference's own ``lax.scan`` refuses to run: its carry turns
    fp32 after layer 0's ``rms_norm`` (ROADMAP.md Queue 3)."""
    from repro.nn.layers import rms_norm, swiglu

    layers = [jax.tree.map(lambda a, l=l: a[l], params["blocks"])
              for l in range(cfg.num_layers)]
    x = jlm._embed(params, cfg, tokens)
    for p in layers:
        x, _, _ = jlm._attn_block(cfg, p, x, None, None, 0)
    full = jlm._logits(params, cfg, rms_norm(x, params["final_norm"]))

    x = jlm._embed(params, cfg, tokens[:, :S - STEPS])
    caches = []
    for p in layers:
        out, k, v = jattn.attention_prefill_kv(
            p["attn"], rms_norm(x, p["ln1"]), n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
        x = x + out
        x = x + swiglu(rms_norm(x, p["ln2"]), p["mlp"]["wg"], p["mlp"]["wi"], p["mlp"]["wo"])
        pad = ((0, 0), (0, 0), (0, STEPS), (0, 0))
        caches.append(jattn.KVCache(jnp.pad(k, pad).astype(jnp.bfloat16),
                                    jnp.pad(v, pad).astype(jnp.bfloat16)))
    outs = [jlm._logits(params, cfg, rms_norm(x, params["final_norm"])[:, -1:])]
    for i in range(S - STEPS, S):
        x = jlm._embed(params, cfg, tokens[:, i:i + 1])
        for l, p in enumerate(layers):
            x, caches[l], _ = jlm._attn_block(cfg, p, x, None, caches[l], jnp.asarray(i))
        outs.append(jlm._logits(params, cfg, rms_norm(x, params["final_norm"])))
    return full, outs


@pytest.mark.parametrize("name", DENSE)
def test_lm_bf16_compute_matches_reference_layer_loop(name):
    """compute_dtype bf16 (the full configs' setting) with the default bf16
    cache: the embedding rows and layer 0's normalised input are rounded to
    bf16, the residual stream is fp32 from there on, as in the reference."""
    jcfg, tcfg = _cfgs(name, compute_dtype="bfloat16")
    jp, tp = _weights(jcfg)
    toks = _tokens()
    full, outs = _jax_layer_loop(jp, jcfg, jnp.asarray(toks))
    port = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert port.dtype == torch.float32
    _close(port, full, 2e-2, "forward")
    touts, _ = _serve_path(tp, tcfg, tmodels, toks, None, torch.from_numpy)
    for i, (t, j) in enumerate(zip(touts, outs)):
        _close(t, j, 2e-2, f"serve step {i}")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_teacher_forced_decode_matches_forward(name, compute):
    """Inside the port: prefill into an fp32 cache and teacher-forced decode
    reproduce the full forward's logits at the same positions (the
    reference's check, tests/test_archs_smoke.py, at its 2e-2; both paths
    round to bf16 at the same places, so the fp32 tolerance holds too)."""
    _, tcfg = _cfgs(name, compute_dtype=compute)
    _, tp = _weights(_cfgs(name)[0])
    toks = _tokens(5)
    full = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    outs, _ = _serve_path(tp, tcfg, tmodels, toks, torch.float32, torch.from_numpy)
    for i, logits in enumerate(outs):
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, S - STEPS - 1 + i].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {i}")


# ---------------------------------------------------------------------- #
# the serving entry point
# ---------------------------------------------------------------------- #
def test_serve_tokens_equal_reference_greedy_loop():
    jcfg, tcfg = _cfgs("llama3.2-1b")
    jp, tp = _weights(jcfg, seed=2)
    prompt, gen = _tokens(3, 12), 8
    res = tserve.serve(tcfg, tp, prompt, gen)
    assert res.tokens.shape == (B, gen + 1) and res.prefill_s > 0 and res.decode_s > 0

    logits, cache = jmodels.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                    s_max=prompt.shape[1] + gen)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    ref = [tok]
    for _ in range(gen):
        logits, cache = jmodels.decode_step(jp, jcfg, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        ref.append(tok)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jnp.concatenate(ref, 1)))


def test_serve_cli_runs_reduced_on_cpu_and_defaults_to_the_card(capsys):
    tserve.main(["--device", "cpu", "--reduced", "--batch", "2", "--prompt-len", "8",
                 "--gen", "2"])
    out = capsys.readouterr().out
    assert "arch=llama3.2-1b device=cpu" in out and "sample:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--reduced"])
