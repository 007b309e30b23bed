"""The port's vlm (pixtral-12b, reduced) against the JAX package's, on the same
weights, patches and tokens.

The reduced pixtral: 4 layers, d 64, 4 query and 2 KV heads of 16, 8 patches
of width 24 in front of the text.  The reference's parameters go to numpy
and through the weights bridge (``lm_params_from_numpy``); patches and
tokens are made with numpy from a seed.  Both run on the CPU: the port's
attention kernel runs its plain version there, over P + S positions.

Tolerances (fp32 unless said): 1e-5 for the embedding and the forward's
logits (another summation order); 1e-4 for the prefill's logits, the cache
and the decode steps (as tests/test_torch_lm.py); the loss 1e-5 relative and
each gradient leaf 1e-4 of its largest entry (as tests/test_torch_moe.py);
2e-2 where a bf16 rounding can land on the other side in one framework (the
bf16 cache, bf16 compute: the reference's own tolerance for its
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
from repro.nn.layers import rms_norm as jrms  # noqa: E402
from repro.nn.layers import swiglu as jswiglu  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.params import _flatten, lm_params_from_numpy  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

ARCH = "pixtral-12b"
B, S, STEPS = 2, 20, 4


def _cfgs(**kw):
    """The reduced config in both packages, with the same overrides."""
    return (dataclasses.replace(jconfigs.reduced_config(jconfigs.get_arch(ARCH)), **kw),
            dataclasses.replace(tconfigs.reduced_config(tconfigs.get_arch(ARCH)), **kw))


def _ref_tree(jcfg, seed=1):
    """The reference's init, as numpy; its norms (all ones) get values, so
    that a norm read in the wrong place shows."""
    tree = jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(seed), jcfg)[0])
    rng = np.random.default_rng(seed)
    for node, keys in ((tree["blocks"], ("ln1", "ln2")), (tree, ("final_norm",))):
        for k in keys:
            node[k] = (node[k] + 0.2 * rng.normal(size=node[k].shape)).astype(node[k].dtype)
    return tree


def _weights(jcfg, seed=1):
    tree = _ref_tree(jcfg, seed)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")


def _data(cfg, seed=0, s=S):
    """Tokens, then the patches drawn after them (as ``serve``'s CLI and the trainer do)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s))
    patches = rng.normal(size=(B, cfg.num_patches, cfg.d_frontend)).astype(np.float32)
    return patches, tokens


def _close(port, ref, tol, msg=""):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


# ---------------------------------------------------------------------- #
# config, init and the weights bridge
# ---------------------------------------------------------------------- #
def test_config_resolves_and_its_tree_is_the_reference_tree():
    port, ref = tconfigs.get_arch(ARCH), jconfigs.get_arch(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.resolved_head_dim, port.num_patches, port.d_frontend) == (160, 256, 1024)
    jcfg, tcfg = _cfgs()
    assert (tcfg.num_patches, tcfg.d_frontend, tcfg.num_layers) == (8, 24, 4)
    ref = _flatten(jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(0), jcfg)[0]))
    params = tmodels.init_model(torch.Generator().manual_seed(0), tcfg)
    got = _flatten(params)
    assert got.keys() == ref.keys() and "patch_proj" in got
    for k, r in ref.items():
        p = got[k].numpy()
        assert p.shape == r.shape and p.dtype == r.dtype, k
        if k.endswith(("ln1", "ln2", "norm")):
            np.testing.assert_array_equal(p, r, err_msg=k)
        else:  # the same scale: std within 20% (normal draws of another generator)
            assert 0.8 < p.std() / r.std() < 1.2, k
    proj = params["patch_proj"]
    assert proj.shape == (24, 64)
    assert 0.9 < float(proj.std()) * 24 ** 0.5 < 1.1  # normal · d_frontend^-1/2


def test_weights_bridge_with_and_without_patch_proj():
    """A vlm tree maps leaf for leaf, ``patch_proj`` included; without
    ``patch_proj`` it is a text tree; a ``patch_proj`` that is not 2-D of the
    embedding's width raises."""
    jcfg, _ = _cfgs()
    tree = jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(0), jcfg)[0])
    params = lm_params_from_numpy(tree, "cpu")
    flat_ref, flat_port = _flatten(tree), _flatten(params)
    assert flat_ref.keys() == flat_port.keys() and "patch_proj" in flat_port
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_port[k].numpy(), v, err_msg=k)
    without = {k: v for k, v in tree.items() if k != "patch_proj"}
    assert "patch_proj" not in lm_params_from_numpy(without, "cpu")  # a text tree
    for bad in (np.zeros(3, np.float32), np.zeros((24, 32), np.float32)):
        with pytest.raises(ValueError, match="does not fit"):
            lm_params_from_numpy({**tree, "patch_proj": bad}, "cpu")


def test_embed_puts_the_projected_patches_before_the_tokens():
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    patches, tokens = _data(tcfg)
    ref = jlm._embed(jp, jcfg, jnp.asarray(tokens), jnp.asarray(patches))
    port = tlm._embed(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(patches))
    assert port.shape == (B, tcfg.num_patches + S, tcfg.d_model)
    _close(port, ref, 1e-5, "embed")
    np.testing.assert_array_equal(  # the text rows are the embedding rows as they are
        port[:, tcfg.num_patches:].numpy(), tp["embed"][torch.from_numpy(tokens)].numpy())


# ---------------------------------------------------------------------- #
# forward, prefill, decode
# ---------------------------------------------------------------------- #
def _serve_path(params, cfg, models, patches, tokens, cache_dtype, to):
    """prefill the patches and S - STEPS tokens into a cache of P + S
    positions, then decode the last STEPS teacher-forced; returns [prefill
    logits, decode logits …] and the final cache."""
    logits, cache = models.prefill(params, cfg, {"patches": to(patches),
                                                 "tokens": to(tokens[:, :S - STEPS])},
                                   s_max=cfg.num_patches + S, cache_dtype=cache_dtype)
    outs = [logits]
    for i in range(S - STEPS, S):
        logits, cache = models.decode_step(params, cfg, to(tokens[:, i:i + 1]), cache)
        outs.append(logits)
    return outs, cache


def test_forward_logits_cover_the_text_only_and_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    patches, tokens = _data(tcfg)
    ref, aux = jmodels.forward(jp, jcfg, {"patches": jnp.asarray(patches),
                                          "tokens": jnp.asarray(tokens)})
    port = tmodels.forward(tp, tcfg, {"patches": torch.from_numpy(patches),
                                      "tokens": torch.from_numpy(tokens)})
    assert port.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    _close(port, ref, 1e-5, "forward")
    text_only = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert float((text_only - port).abs().max()) > 1e-2  # the patches reach the text


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_prefill_cache_and_decode_match_reference(cache):
    """The prefill's logits, every cache leaf over all P + S positions and
    ``index == P + S``, then 4 decode steps (their RoPE position is
    ``cache.index``, after the patches and the prompt) against the
    reference's; 1e-4 with the fp32 cache, 2e-2 with the bf16 one (the
    leaves and the decode steps, q cast to bf16)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    patches, tokens = _data(tcfg)
    jdt, tdt = getattr(jnp, cache), getattr(torch, cache)
    jouts, jc = _serve_path(jp, jcfg, jmodels, patches, tokens, jdt, jnp.asarray)
    touts, tc = _serve_path(tp, tcfg, tmodels, patches, tokens, tdt, torch.from_numpy)
    p = tcfg.num_patches
    assert isinstance(tc, tmodels.LMCache) and tc.index == int(jc.index) == p + S
    assert tc.k.shape == (tcfg.num_layers, B, tcfg.num_kv_heads, p + S, tcfg.resolved_head_dim)
    tol = 1e-4 if cache == "float32" else 2e-2
    _close(touts[0], jouts[0], 1e-4 if cache == "float32" else 2e-2, "prefill logits")
    for name in ("k", "v"):
        leaf = getattr(tc, name)
        assert leaf.dtype == tdt, name
        _close(leaf, getattr(jc, name), tol, f"cache {name}")
        assert float(leaf[:, :, :, :p].abs().max()) > 0  # the patch positions are filled
    for i, (t, j) in enumerate(zip(touts[1:], jouts[1:])):
        assert t.shape == (B, 1, tcfg.vocab_size)
        _close(t, j, tol, f"decode step {i}")


def test_teacher_forced_decode_matches_forward():
    """Inside the port, fp32: the prefill over the patches and the prompt and
    teacher-forced decode reproduce the full forward's text logits at the
    same positions, so decode's positions continue after the patches."""
    _, tcfg = _cfgs()
    _, tp = _weights(_cfgs()[0])
    patches, tokens = _data(tcfg, seed=5)
    full = tmodels.forward(tp, tcfg, {"patches": torch.from_numpy(patches),
                                      "tokens": torch.from_numpy(tokens)})
    outs, _ = _serve_path(tp, tcfg, tmodels, patches, tokens, torch.float32, torch.from_numpy)
    for i, logits in enumerate(outs):
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, S - STEPS - 1 + i].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {i}")


def test_flash_attention_runs_once_a_layer_over_patches_and_text():
    """The forward and the prefill reach ``flash_attention`` once a layer,
    causal, over Sq = Sk = P + S positions."""
    _, tcfg = _cfgs()
    params = tmodels.init_model(torch.Generator().manual_seed(0), tcfg)
    patches, tokens = _data(tcfg)
    seen, orig = [], kops.flash_attention

    def reading(q, k, v, causal=True, window=None, q_offset=0):
        seen.append((causal, window, q.shape[2], k.shape[2], q.shape[3]))
        return orig(q, k, v, causal=causal, window=window, q_offset=q_offset)

    kops.flash_attention = reading
    try:
        batch = {"patches": torch.from_numpy(patches), "tokens": torch.from_numpy(tokens)}
        tmodels.forward(params, tcfg, batch)
        tmodels.prefill(params, tcfg, batch, s_max=tcfg.num_patches + S + 4)
    finally:
        kops.flash_attention = orig
    n = tcfg.num_patches + S
    assert seen == [(True, None, n, n, tcfg.resolved_head_dim)] * (2 * tcfg.num_layers)


# ---------------------------------------------------------------------- #
# bf16 compute: the reference's bodies one layer at a time
# ---------------------------------------------------------------------- #
def _jax_layer_loop(params, cfg, patches, tokens):
    """The reference's scan bodies (forward; prefill into a bf16 cache +
    teacher-forced decode), one layer at a time in Python: with
    compute_dtype bf16 and fp32 params its ``lax.scan`` refuses to run, the
    carry turning fp32 after layer 0's ``rms_norm`` (ROADMAP.md Queue 3
    item 4)."""
    p_n = patches.shape[1]
    kw = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
              rope_theta=cfg.rope_theta)
    layers = [jax.tree.map(lambda a, l=l: a[l], params["blocks"])
              for l in range(cfg.num_layers)]
    x = jlm._embed(params, cfg, tokens, patches)
    for p in layers:
        x, _, _ = jlm._attn_block(cfg, p, x, None, None, 0)
    full = jlm._logits(params, cfg, jrms(x, params["final_norm"])[:, p_n:])

    x = jlm._embed(params, cfg, tokens[:, :S - STEPS], patches)
    caches = []
    for p in layers:
        out, k, v = jattn.attention_prefill_kv(p["attn"], jrms(x, p["ln1"]), **kw)
        x = x + out
        x = x + jswiglu(jrms(x, p["ln2"]), p["mlp"]["wg"], p["mlp"]["wi"], p["mlp"]["wo"])
        pad = ((0, 0), (0, 0), (0, STEPS), (0, 0))
        caches.append(jattn.KVCache(jnp.pad(k, pad).astype(jnp.bfloat16),
                                    jnp.pad(v, pad).astype(jnp.bfloat16)))
    outs = [jlm._logits(params, cfg, jrms(x, params["final_norm"])[:, -1:])]
    for i in range(S - STEPS, S):
        x = jlm._embed(params, cfg, tokens[:, i:i + 1])
        for l, p in enumerate(layers):
            x, caches[l], _ = jlm._attn_block(cfg, p, x, None, caches[l], jnp.asarray(p_n + i))
        outs.append(jlm._logits(params, cfg, jrms(x, params["final_norm"])))
    return full, outs


def test_bf16_compute_matches_reference_layer_loop():
    """compute_dtype bf16 (the full config's setting) with the default bf16
    cache: the patch projection of two bf16 operands and the embedding rows
    are rounded to bf16, the residual stream is fp32 from layer 0's
    attention on, as in the reference."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jp, tp = _weights(jcfg)
    patches, tokens = _data(tcfg)
    full, outs = _jax_layer_loop(jp, jcfg, jnp.asarray(patches), jnp.asarray(tokens))
    port = tmodels.forward(tp, tcfg, {"patches": torch.from_numpy(patches),
                                      "tokens": torch.from_numpy(tokens)})
    assert port.dtype == torch.float32 and port.shape == (B, S, tcfg.vocab_size)
    _close(port, full, 2e-2, "forward")
    touts, tc = _serve_path(tp, tcfg, tmodels, patches, tokens, None, torch.from_numpy)
    assert tc.k.dtype == torch.bfloat16
    for i, (t, j) in enumerate(zip(touts, outs)):
        _close(t, j, 2e-2, f"serve step {i}")


# ---------------------------------------------------------------------- #
# the loss and its gradients
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    """``lm_loss`` over the text and its gradient against ``jax.value_and_grad``
    of the reference's ``loss_fn``, ``patch_proj`` included; with ``remat``
    the port recomputes each layer in the backward."""
    jcfg, tcfg = _cfgs(remat=remat)
    tree = _ref_tree(jcfg, seed=3)
    patches, tokens = _data(tcfg, seed=6)
    batch = {"patches": patches, "tokens": tokens.astype(np.int32),
             "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    loss, met, grads = ttrainer.value_and_grad(lm_params_from_numpy(tree, "cpu"), tcfg,
                                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(met) == set(jmet) == {"ce", "aux"} and float(met["aux"]) == 0.0
    fp, fr = _flatten(grads), _flatten(jax.tree.map(np.asarray, jgrads))
    assert fp.keys() == fr.keys() and "patch_proj" in fp
    for k, r in fr.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(fp[k].numpy() - r).max()) <= 1e-4 * scale, k
    assert float(grads["patch_proj"].abs().max()) > 0  # the loss reaches the frontend


# ---------------------------------------------------------------------- #
# the serving entry point and the trainer's data
# ---------------------------------------------------------------------- #
def test_serve_tokens_equal_reference_greedy_loop():
    """``serve`` against a greedy loop over the reference's ``prefill`` and
    ``decode_step`` with ``repro.launch.serve``'s ``s_max`` (patches + prompt
    + gen); a vlm without patches raises."""
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg, seed=2)
    patches, prompt = _data(tcfg, seed=3, s=12)
    gen = 8
    res = tserve.serve(tcfg, tp, prompt, gen, patches=patches)
    assert res.tokens.shape == (B, gen + 1) and res.prefill_s > 0 and res.decode_s > 0
    logits, cache = jmodels.prefill(jp, jcfg, {"patches": jnp.asarray(patches),
                                               "tokens": jnp.asarray(prompt)},
                                    s_max=tcfg.num_patches + prompt.shape[1] + gen)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    ref = [tok]
    for _ in range(gen):
        logits, cache = jmodels.decode_step(jp, jcfg, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        ref.append(tok)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jnp.concatenate(ref, 1)))
    with pytest.raises(ValueError, match="needs its patches"):
        tserve.serve(tcfg, tp, prompt, gen)


def test_serve_cli_runs_reduced_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch", "2",
                 "--prompt-len", "8", "--gen", "2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} device=cpu" in out and "sample:" in out


def test_synthetic_batch_patches_equal_reference():
    jcfg, tcfg = _cfgs()
    kw = dict(batch=3, seq_len=16, seed=4)
    ref = jtrainer.synthetic_batch(jcfg, jtrainer.TrainConfig(**kw), 2)
    port = ttrainer.synthetic_batch(tcfg, ttrainer.TrainConfig(**kw), 2, device="cpu")
    assert set(port) == set(ref) == {"tokens", "labels", "patches"}
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert port["patches"].shape == (3, tcfg.num_patches, tcfg.d_frontend)
