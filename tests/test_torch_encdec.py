"""The port's encoder-decoder (seamless-m4t-large-v2, reduced) against the JAX
package's, on the same weights, frames and tokens.

The reference's parameters go to numpy and through the weights bridge
(``lm_params_from_numpy``); frames and tokens are made with numpy from a
seed, with a source length (37 frames) other than the decoder's (20
tokens), so that the cross attention runs Sq ≠ Sk.  Both run on the CPU:
the port's attention kernel runs its plain version there, non-causal in
the encoder and the cross attention.

Tolerances (fp32 unless said): 1e-5 for one cross attention (another
summation order), 1e-4 for the whole reduced model (as
tests/test_torch_lm.py); the loss 1e-5 relative and each gradient leaf 1e-4
of its largest entry (as tests/test_torch_moe.py); 2e-2 where a bf16
rounding can land on the other side in one framework (the bf16 cache, bf16
compute: the reference's own tolerance for its teacher-forced check,
tests/test_archs_smoke.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn.layers import rms_norm as jrms  # noqa: E402
from repro.nn.layers import swiglu as jswiglu  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models.params import _flatten, lm_params_from_numpy  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

ARCH = "seamless-m4t-large-v2"
B, S_SRC, S, STEPS = 2, 37, 20, 4


def _cfgs(**kw):
    """The reduced config in both packages, with the same overrides."""
    return (dataclasses.replace(jconfigs.reduced_config(jconfigs.get_arch(ARCH)), **kw),
            dataclasses.replace(tconfigs.reduced_config(tconfigs.get_arch(ARCH)), **kw))


def _ref_tree(jcfg, seed=1):
    """The reference's init, as numpy; its norms (all ones) get values, so
    that a norm read in the wrong place shows."""
    tree = jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(seed), jcfg)[0])
    rng = np.random.default_rng(seed)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k.startswith(("ln", "final_norm", "enc_final_norm")):
                node[k] = (v + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)

    perturb(tree)
    return tree


def _weights(jcfg, seed=1):
    tree = _ref_tree(jcfg, seed)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")


def _data(cfg, seed=0, s=S, s_src=S_SRC):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s))
    frames = rng.normal(size=(B, s_src, cfg.d_frontend)).astype(np.float32)
    return frames, tokens


def _close(port, ref, tol, msg=""):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


# ---------------------------------------------------------------------- #
# configs and the zoo's dispatch
# ---------------------------------------------------------------------- #
def test_config_resolves_and_only_pixtral_is_not_ported():
    """Named when pixtral-12b was the one architecture left; the vlm is
    ported now (tests/test_torch_vlm.py) and ``NOT_PORTED`` is empty."""
    port, ref = tconfigs.get_arch(ARCH), jconfigs.get_arch(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count() == 2_034_659_328
    assert tconfigs.NOT_PORTED == {}
    assert tconfigs.get_arch("pixtral-12b").family == "vlm"
    red = tconfigs.reduced_config(port)
    assert (red.enc_layers, red.d_frontend) == (2, 24)
    with pytest.raises(ValueError, match="built by prefill"):
        tmodels.init_cache(red, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="repro_torch.models.encdec"):
        tmodels.lm.init_lm(torch.Generator().manual_seed(0), red)


def test_init_has_the_reference_tree_and_scales():
    jcfg, tcfg = _cfgs()
    ref = _flatten(jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(0), jcfg)[0]))
    port = _flatten(tmodels.init_model(torch.Generator().manual_seed(0), tcfg))
    assert port.keys() == ref.keys()
    for k, r in ref.items():
        p = port[k].numpy()
        assert p.shape == r.shape and p.dtype == r.dtype, k
        if k.endswith(("ln1", "ln2", "ln_x", "norm")):
            np.testing.assert_array_equal(p, r, err_msg=k)
        else:  # the same scale: std within 20% (normal draws of another generator)
            assert 0.8 < p.std() / r.std() < 1.2, k


# ---------------------------------------------------------------------- #
# cross attention
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sq", [S, 1])  # the kernel's path (non-causal), the decode path
def test_cross_attention_matches_reference(sq):
    d, h, dh = 64, 4, 16
    p = {k: np.array(v.value)[0] for k, v in jattn.init_cross_attention(
        jax.random.PRNGKey(3), 1, d, d, h, dh, dtype=jnp.float32).items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, sq, d)).astype(np.float32)
    enc = rng.normal(size=(B, S_SRC, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jk, jv = jattn.cross_memory(jp, jnp.asarray(enc), h, dh)
    tk, tv = tattn.cross_memory(tp, torch.from_numpy(enc), h, dh)
    assert tk.shape == (B, h, S_SRC, dh)
    _close(tk, jk, 1e-5, "memory k")
    _close(tv, jv, 1e-5, "memory v")
    ref = jattn.cross_attention_apply(jp, jnp.asarray(x), (jk, jv), n_heads=h, head_dim=dh)
    port = tattn.cross_attention_apply(tp, torch.from_numpy(x), (tk, tv), n_heads=h, head_dim=dh)
    assert port.shape == (B, sq, d)
    _close(port, ref, 1e-5, "cross attention")


def test_flash_attention_calls_of_a_forward_and_a_prefill():
    """The encoder's self attention and the cross attention reach
    ``flash_attention`` non-causal, the decoder's causal, with the cross
    attention's Sk the source length."""
    _, tcfg = _cfgs()
    params = tmodels.init_model(torch.Generator().manual_seed(0), tcfg)
    frames, tokens = _data(tcfg)
    seen, orig = [], kops.flash_attention

    def reading(q, k, v, causal=True, window=None, q_offset=0):
        seen.append((causal, q.shape[2], k.shape[2]))
        return orig(q, k, v, causal=causal, window=window, q_offset=q_offset)

    kops.flash_attention = reading
    try:
        batch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}
        tmodels.forward(params, tcfg, batch)
        tmodels.prefill(params, tcfg, batch, s_max=S + 4)
    finally:
        kops.flash_attention = orig
    calls = ([(False, S_SRC, S_SRC)] * tcfg.enc_layers
             + [(True, S, S), (False, S, S_SRC)] * tcfg.num_layers)
    assert seen == calls * 2


# ---------------------------------------------------------------------- #
# the model: encode, forward, prefill, decode
# ---------------------------------------------------------------------- #
def _serve_path(params, cfg, models, frames, tokens, cache_dtype, to):
    """prefill S - STEPS tokens, then decode the last STEPS teacher-forced;
    returns [prefill logits, decode logits …] and the final cache."""
    logits, cache = models.prefill(params, cfg, {"frames": to(frames),
                                                 "tokens": to(tokens[:, :S - STEPS])},
                                   s_max=S, cache_dtype=cache_dtype)
    outs = [logits]
    for i in range(S - STEPS, S):
        logits, cache = models.decode_step(params, cfg, to(tokens[:, i:i + 1]), cache)
        outs.append(logits)
    return outs, cache


def test_encode_and_forward_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    frames, tokens = _data(tcfg)
    ref = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    port = tencdec.encode(tp, tcfg, torch.from_numpy(frames))
    assert port.shape == (B, S_SRC, tcfg.d_model)
    _close(port, ref, 1e-4, "encode")
    ref, aux = jmodels.forward(jp, jcfg, {"frames": jnp.asarray(frames),
                                          "tokens": jnp.asarray(tokens)})
    port = tmodels.forward(tp, tcfg, {"frames": torch.from_numpy(frames),
                                      "tokens": torch.from_numpy(tokens)})
    assert port.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    _close(port, ref, 1e-4, "forward")


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_prefill_cache_and_decode_match_reference(cache):
    """The prefill's logits (it attends to the compute-dtype memory, so
    1e-4 in both cache dtypes) and every cache leaf, then 4 decode steps
    against the reference's; with the bf16 cache the leaves and the decode
    steps (q cast to bf16) at 2e-2."""
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    frames, tokens = _data(tcfg)
    jdt, tdt = getattr(jnp, cache), getattr(torch, cache)
    jouts, jc = _serve_path(jp, jcfg, jmodels, frames, tokens, jdt, jnp.asarray)
    touts, tc = _serve_path(tp, tcfg, tmodels, frames, tokens, tdt, torch.from_numpy)
    assert isinstance(tc, tmodels.EncDecCache) and tc.index == int(jc.index) == S
    hd = tcfg.resolved_head_dim
    assert tc.k.shape == (tcfg.num_layers, B, tcfg.num_kv_heads, S, hd)
    assert tc.mem_k.shape == (tcfg.num_layers, B, tcfg.num_heads, S_SRC, hd)
    tol = 1e-4 if cache == "float32" else 2e-2
    _close(touts[0], jouts[0], 1e-4, "prefill logits")
    for name in ("k", "v", "mem_k", "mem_v"):
        leaf = getattr(tc, name)
        assert leaf.dtype == tdt, name
        _close(leaf, getattr(jc, name), tol, f"cache {name}")
    for i, (t, j) in enumerate(zip(touts[1:], jouts[1:])):
        assert t.shape == (B, 1, tcfg.vocab_size)
        _close(t, j, tol, f"decode step {i}")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_forward(compute):
    """Inside the port: prefill into an fp32 cache and teacher-forced decode
    reproduce the full forward's logits at the same positions (both paths
    round to bf16 at the same places, so 1e-4 holds in bf16 compute too)."""
    jcfg, tcfg = _cfgs(compute_dtype=compute)
    _, tp = _weights(_cfgs()[0])
    frames, tokens = _data(tcfg, seed=5)
    full = tmodels.forward(tp, tcfg, {"frames": torch.from_numpy(frames),
                                      "tokens": torch.from_numpy(tokens)})
    outs, _ = _serve_path(tp, tcfg, tmodels, frames, tokens, torch.float32, torch.from_numpy)
    for i, logits in enumerate(outs):
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, S - STEPS - 1 + i].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {i}")


# ---------------------------------------------------------------------- #
# bf16 compute: the reference's bodies one layer at a time
# ---------------------------------------------------------------------- #
def _jax_layer_loop(params, cfg, frames, tokens):
    """The reference's encoder and decoder scan bodies (forward; prefill into
    a bf16 cache + teacher-forced decode), one layer at a time in Python:
    with compute_dtype bf16 and fp32 params its ``lax.scan`` refuses to run,
    the carry turning fp32 after layer 0's ``rms_norm`` (ROADMAP.md Queue 3
    item 4)."""
    cdt = jnp.bfloat16
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    kw = dict(n_heads=h, n_kv=cfg.num_kv_heads, head_dim=hd, rope_theta=cfg.rope_theta)

    def layers(tree, n):
        return [jax.tree.map(lambda a, l=l: a[l], tree) for l in range(n)]

    def mlp(p, x):
        return x + jswiglu(jrms(x, p["ln2"]), p["mlp"]["wg"], p["mlp"]["wi"], p["mlp"]["wo"])

    def cross(p, x, mem):
        return x + jattn.cross_attention_apply(p["xattn"], jrms(x, p["ln_x"]), mem, n_heads=h,
                                               head_dim=hd)

    x = frames.astype(cdt) @ params["frame_proj"].astype(cdt)
    for p in layers(params["enc_blocks"], cfg.enc_layers):
        out, _ = jattn.attention_apply(p["attn"], jrms(x, p["ln1"]), causal=False, **kw)
        x = mlp(p, x + out)
    memory = jrms(x, params["enc_final_norm"])
    dec = layers(params["dec_blocks"], cfg.num_layers)

    x = jnp.take(params["embed"], tokens, axis=0).astype(cdt)
    for p in dec:
        out, _ = jattn.attention_apply(p["attn"], jrms(x, p["ln1"]), causal=True, **kw)
        x = mlp(p, cross(p, x + out, jattn.cross_memory(p["xattn"], memory, h, hd)))
    full = jlm._logits(params, cfg, jrms(x, params["final_norm"]))

    x = jnp.take(params["embed"], tokens[:, :S - STEPS], axis=0).astype(cdt)
    caches = []
    for p in dec:
        out, k, v = jattn.attention_prefill_kv(p["attn"], jrms(x, p["ln1"]), causal=True, **kw)
        mk, mv = jattn.cross_memory(p["xattn"], memory, h, hd)
        x = mlp(p, cross(p, x + out, (mk, mv)))
        pad = ((0, 0), (0, 0), (0, STEPS), (0, 0))
        caches.append([jattn.KVCache(jnp.pad(k, pad).astype(cdt), jnp.pad(v, pad).astype(cdt)),
                       (mk.astype(cdt), mv.astype(cdt))])
    outs = [jlm._logits(params, cfg, jrms(x, params["final_norm"])[:, -1:])]
    for i in range(S - STEPS, S):
        x = jnp.take(params["embed"], tokens[:, i:i + 1], axis=0).astype(cdt)
        for c, p in zip(caches, dec):
            out, c[0] = jattn.attention_apply(p["attn"], jrms(x, p["ln1"]), causal=True,
                                              cache=c[0], cache_index=jnp.asarray(i), **kw)
            x = mlp(p, cross(p, x + out, c[1]))
        outs.append(jlm._logits(params, cfg, jrms(x, params["final_norm"])))
    return full, outs


def test_bf16_compute_matches_reference_layer_loop():
    """compute_dtype bf16 (the full config's setting) with the default bf16
    cache: the frame projection of two bf16 operands and the embedding rows
    are rounded to bf16, the residual streams are fp32 from layer 0's
    attention on, as in the reference."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jp, tp = _weights(jcfg)
    frames, tokens = _data(tcfg)
    full, outs = _jax_layer_loop(jp, jcfg, jnp.asarray(frames), jnp.asarray(tokens))
    port = tmodels.forward(tp, tcfg, {"frames": torch.from_numpy(frames),
                                      "tokens": torch.from_numpy(tokens)})
    assert port.dtype == torch.float32
    _close(port, full, 2e-2, "forward")
    touts, tc = _serve_path(tp, tcfg, tmodels, frames, tokens, None, torch.from_numpy)
    assert tc.mem_k.dtype == torch.bfloat16
    for i, (t, j) in enumerate(zip(touts, outs)):
        _close(t, j, 2e-2, f"serve step {i}")


# ---------------------------------------------------------------------- #
# the loss and its gradients
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    """``encdec_loss`` and its gradient against ``jax.value_and_grad`` of the
    reference's ``loss_fn``; with ``remat`` the port recomputes each encoder
    and decoder layer in the backward."""
    jcfg, tcfg = _cfgs(remat=remat)
    tree = _ref_tree(jcfg, seed=3)
    frames, tokens = _data(tcfg, seed=6)
    batch = {"frames": frames, "tokens": tokens.astype(np.int32),
             "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    loss, met, grads = ttrainer.value_and_grad(lm_params_from_numpy(tree, "cpu"), tcfg,
                                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(met) == set(jmet) == {"ce"} and float(met["ce"]) == float(loss)
    fp, fr = _flatten(grads), _flatten(jax.tree.map(np.asarray, jgrads))
    assert fp.keys() == fr.keys()
    for k, r in fr.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(fp[k].numpy() - r).max()) <= 1e-4 * scale, k
    assert float(grads["frame_proj"].abs().max()) > 0  # the gradient reaches the encoder


# ---------------------------------------------------------------------- #
# weights bridge
# ---------------------------------------------------------------------- #
def test_weights_bridge_maps_every_leaf():
    jcfg, _ = _cfgs()
    tree = jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(0), jcfg)[0])
    params = lm_params_from_numpy(tree, "cpu")
    flat_ref, flat_port = _flatten(tree), _flatten(params)
    assert flat_ref.keys() == flat_port.keys() and len(flat_ref) == 28
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_port[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("case", ["missing", "partial", "extra", "extra top", "lm leaf"])
def test_weights_bridge_rejects_a_tree_that_does_not_fit(case):
    jcfg, _ = _cfgs()
    tree = jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(0), jcfg)[0])
    edit = {
        "missing": lambda t: t["enc_blocks"]["mlp"].pop("wi"),
        "partial": lambda t: t["dec_blocks"].pop("xattn"),
        "extra": lambda t: t["dec_blocks"]["attn"].update(bq=np.zeros(3, np.float32)),
        "extra top": lambda t: t.update(patch_proj=np.zeros(3, np.float32)),
        "lm leaf": lambda t: t.update(blocks={"ln1": np.zeros(3, np.float32)}),
    }[case]
    edit(tree)
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_numpy(tree, "cpu")


# ---------------------------------------------------------------------- #
# the serving entry point and the trainer's data
# ---------------------------------------------------------------------- #
def test_serve_tokens_equal_reference_greedy_loop():
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg, seed=2)
    frames, prompt = _data(tcfg, seed=3, s=12, s_src=29)
    gen = 8
    res = tserve.serve(tcfg, tp, prompt, gen, frames)
    assert res.tokens.shape == (B, gen + 1) and res.prefill_s > 0 and res.decode_s > 0
    logits, cache = jmodels.prefill(jp, jcfg, {"frames": jnp.asarray(frames),
                                               "tokens": jnp.asarray(prompt)},
                                    s_max=prompt.shape[1] + gen)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    ref = [tok]
    for _ in range(gen):
        logits, cache = jmodels.decode_step(jp, jcfg, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        ref.append(tok)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jnp.concatenate(ref, 1)))
    with pytest.raises(ValueError, match="needs its frames"):
        tserve.serve(tcfg, tp, prompt, gen)


def test_serve_cli_runs_reduced_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch", "2",
                 "--prompt-len", "8", "--gen", "2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} device=cpu" in out and "sample:" in out


def test_synthetic_batch_frames_equal_reference():
    jcfg, tcfg = _cfgs()
    kw = dict(batch=3, seq_len=16, seed=4)
    ref = jtrainer.synthetic_batch(jcfg, jtrainer.TrainConfig(**kw), 2)
    port = ttrainer.synthetic_batch(tcfg, ttrainer.TrainConfig(**kw), 2, device="cpu")
    assert set(port) == set(ref) == {"tokens", "labels", "frames"}
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert port["frames"].shape == (3, 16, tcfg.d_frontend)
