"""The port's recurrent LM families (hymba-1.5b, xlstm-1.3b) against the JAX
package's, on the same weights and tokens.

The reference's parameters go to numpy and through the weights bridge
(``lm_params_from_numpy``); tokens are made with numpy from a seed.  Both
run on the CPU: the port's attention kernel runs its plain version there.

Tolerances (fp32 unless said): 1e-4 for the reduced hymba model (forward,
prefill logits and every cache leaf, decode steps), as the dense family's
tests/test_torch_lm.py.  3e-4 for the reduced xlstm model: its fp32
computation is itself about 1.4e-4 away from the same model in float64 (the
reference's, measured over six weight seeds; the port's likewise), through
the normalizer divisions of the m/sLSTM and the ``out_norm`` of rows whose
norm is ~1e-3, so two fp32 orders of it may differ by twice that; each of
its blocks is held at 1e-5 on the reference's inputs below.  The loss 1e-5
relative and each gradient leaf 1e-4 of its largest entry, as
tests/test_torch_moe.py.  2e-2 where a bf16 rounding can land on the
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
from repro.nn import ssm as jssm  # noqa: E402
from repro.nn.layers import rms_norm as jrms  # noqa: E402
from repro.nn.layers import swiglu as jswiglu  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.params import _flatten, lm_params_from_numpy  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

HYMBA, XLSTM = "hymba-1.5b", "xlstm-1.3b"
ARCHS = [HYMBA, XLSTM]
TOL = {HYMBA: 1e-4, XLSTM: 3e-4}
B = 2


def _cfgs(name, **kw):
    """The reduced config in both packages, with the same overrides."""
    return (dataclasses.replace(jconfigs.reduced_config(jconfigs.get_arch(name)), **kw),
            dataclasses.replace(tconfigs.reduced_config(tconfigs.get_arch(name)), **kw))


def _ref_tree(jcfg, seed=1):
    """The reference's init as numpy; hymba's zero-initialised ``a_log`` and
    ``dt_bias`` get values, so that the decay path is exercised."""
    tree = jax.tree.map(np.asarray, jmodels.init_model(jax.random.PRNGKey(seed), jcfg)[0])
    if "blocks" in tree and "ssd" in tree["blocks"]:
        rng = np.random.default_rng(seed)
        for k in ("a_log", "dt_bias"):
            leaf = tree["blocks"]["ssd"][k]
            tree["blocks"]["ssd"][k] = (0.5 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
    return tree


def _tokens(seed, s):
    return np.random.default_rng(seed).integers(0, 256, (B, s))


def _close(port, ref, tol, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _caches_close(tc, jc, tol, msg):
    assert tc.index == int(jc.index)
    for f in tc._fields:
        if f != "index" and getattr(tc, f) is not None:
            assert tuple(getattr(tc, f).shape) == tuple(getattr(jc, f).shape), f
            _close(getattr(tc, f), getattr(jc, f), tol, f"{msg} cache {f}")


# ---------------------------------------------------------------------- #
# configs and the weights bridge
# ---------------------------------------------------------------------- #
def test_full_width_parameter_counts():
    hymba, xlstm = tconfigs.get_arch(HYMBA), tconfigs.get_arch(XLSTM)
    assert round(hymba.param_count() / 1e6) == round(jconfigs.get_arch(HYMBA).param_count() / 1e6)
    assert 1.6e9 < hymba.param_count() < 1.8e9 and 1.3e9 < xlstm.param_count() < 1.5e9
    red = tconfigs.reduced_config(xlstm)  # 2 groups of an sLSTM and 3 mLSTM blocks
    assert (red.num_layers, red.slstm_every) == (8, 4)
    assert tconfigs.reduced_config(hymba).full_attn_layers == (0,)


@pytest.mark.parametrize("name", ARCHS)
def test_weights_bridge_maps_every_leaf(name):
    jcfg, tcfg = _cfgs(name)
    tree = _ref_tree(jcfg)
    params = lm_params_from_numpy(tree, "cpu")
    flat_ref, flat_port = _flatten(tree), _flatten(params)
    assert flat_ref.keys() == flat_port.keys()
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_port[k].numpy(), v, err_msg=k)
    assert ("blocks" in params) == (name == HYMBA)
    # the port's own init has the same tree, shapes and dtypes
    own = _flatten(tmodels.init_model(torch.Generator().manual_seed(0), tcfg))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in flat_port.items()}


@pytest.mark.parametrize("case", ["hymba missing ssd leaf", "hymba no mlp", "hymba extra",
                                  "xlstm missing slstm leaf", "xlstm missing mlstm leaf",
                                  "xlstm extra", "xlstm with blocks"])
def test_weights_bridge_rejects_missing_or_extra_leaf(case):
    name = HYMBA if case.startswith("hymba") else XLSTM
    tree = _ref_tree(_cfgs(name)[0])
    dense = _ref_tree(_cfgs("llama3.2-1b")[0])
    edit = {
        "hymba missing ssd leaf": lambda t: t["blocks"]["ssd"].pop("a_log"),
        "hymba no mlp": lambda t: t["blocks"].pop("mlp"),
        "hymba extra": lambda t: t["blocks"]["attn"].update(bq=np.zeros(3, np.float32)),
        "xlstm missing slstm leaf": lambda t: t["slstm_blocks"].pop("wif"),
        "xlstm missing mlstm leaf": lambda t: t["mlstm_blocks"].pop("b_gates"),
        "xlstm extra": lambda t: t["mlstm_blocks"].update(wz=np.zeros(3, np.float32)),
        "xlstm with blocks": lambda t: t.update(blocks=dense["blocks"]),
    }[case]
    edit(tree)
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_numpy(tree, "cpu")


# ---------------------------------------------------------------------- #
# blocks one at a time, on the same input
# ---------------------------------------------------------------------- #
def test_xlstm_blocks_match_reference():
    jcfg, tcfg = _cfgs(XLSTM)
    tree = _ref_tree(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")
    x = np.random.default_rng(1).normal(size=(B, 37, jcfg.d_model)).astype(np.float32)
    nh, dh = jcfg.num_heads, jcfg.d_model // jcfg.num_heads
    ps = jax.tree.map(lambda a: a[1], jp["slstm_blocks"])
    jy, jst = jlm._slstm_block(jcfg, ps, jnp.asarray(x), jssm.slstm_init_state(B, nh, dh), False)
    ty, tst = tlm._slstm_block(tcfg, tlm._layer(tp["slstm_blocks"], 1), torch.from_numpy(x),
                               None, False)
    _close(ty, jy, 1e-5, "slstm")
    for a, r in zip(tst, jst):
        _close(a, r, 1e-5, "slstm state")
    pm = jax.tree.map(lambda a: a[1, 2], jp["mlstm_blocks"])
    jy, jst, jc = jlm._mlstm_block(jcfg, pm, jnp.asarray(x), jssm.mlstm_init_state(B, nh, dh, dh),
                                   None, False)
    ty, tst, tc = tlm._mlstm_block(tcfg, tlm._layer(tlm._layer(tp["mlstm_blocks"], 1), 2),
                                   torch.from_numpy(x), None, None, False)
    _close(ty, jy, 1e-5, "mlstm")
    _close(tc, jc, 1e-5, "mlstm conv carry")
    for a, r in zip(tst, jst):
        _close(a, r, 1e-5, "mlstm state")


# ---------------------------------------------------------------------- #
# the model: forward, prefill (every cache leaf), decode
# ---------------------------------------------------------------------- #
def _serve_path(params, cfg, models, tokens, prompt, cache_dtype, to_tok):
    """Prefill ``prompt`` tokens into a cache of len(tokens) positions, then
    decode the rest teacher-forced: ([prefill logits, decode logits …],
    [the cache after the prefill, after the last step])."""
    s = tokens.shape[1]
    logits, cache = models.prefill(params, cfg, {"tokens": to_tok(tokens[:, :prompt])},
                                   s_max=s, cache_dtype=cache_dtype)
    snapshot = cache if to_tok is jnp.asarray else cache._replace(**{  # decode writes in place
        f: t.clone() for f, t in cache._asdict().items() if isinstance(t, torch.Tensor)})
    outs, caches = [logits], [snapshot]
    for i in range(prompt, s):
        logits, cache = models.decode_step(params, cfg, to_tok(tokens[:, i:i + 1]), cache)
        outs.append(logits)
    return outs, caches + [cache]


@pytest.mark.parametrize("name,s,prompt,kw", [
    (HYMBA, 32, 28, {}),  # s_max 32 > window 16: a ring; the prompt wraps it
    (HYMBA, 16, 12, {}),  # s_max = window: no ring, slots [12, 16) hold position 0
    (HYMBA, 48, 40, {"full_attn_layers": ()}),  # pure SWA, decode wraps the ring
    (XLSTM, 37, 30, {}),  # lengths off the chunk (16)
])
def test_model_matches_reference_fp32(name, s, prompt, kw):
    jcfg, tcfg = _cfgs(name, **kw)
    tree = _ref_tree(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")
    toks, tol = _tokens(0, s), TOL[name]
    ref = jmodels.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})[0]
    port = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert port.shape == (B, s, tcfg.vocab_size)
    _close(port, ref, tol, "forward")
    jouts, jcaches = _serve_path(jp, jcfg, jmodels, toks, prompt, jnp.float32, jnp.asarray)
    touts, tcaches = _serve_path(tp, tcfg, tmodels, toks, prompt, torch.float32, torch.from_numpy)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert t.shape == (B, 1, tcfg.vocab_size)
        _close(t, j, tol, f"serve step {i}")
    for tc, jc, when in zip(tcaches, jcaches, ("prefill", "decode")):
        _caches_close(tc, jc, tol, when)
    if name == HYMBA:
        assert tcaches[0].k.shape[3] == tlm.cache_len(tcfg, s) == min(s, tcfg.window)


def test_hymba_prefill_ring_slots_follow_the_reference():
    """Slot j holds clip((s−1) − ((s−1−j) mod W), 0, s−1): the latest prompt
    position ≡ j (mod W), or position 0 where none is."""
    np.testing.assert_array_equal(tlm.ring_slots(5, 8), [0, 1, 2, 3, 4, 0, 0, 0])
    np.testing.assert_array_equal(tlm.ring_slots(11, 4), [8, 9, 10, 7])
    np.testing.assert_array_equal(tlm.ring_slots(8, 8), np.arange(8))


def test_hymba_attention_goes_to_flash_attention_with_each_layers_window(monkeypatch):
    """Every hymba call with more than one query row reaches the kernel op,
    with the window as an int on the windowed layers and None on the global
    ones (the reference's traced schedule takes its einsum path instead)."""
    _, tcfg = _cfgs(HYMBA)
    params = tmodels.init_model(torch.Generator().manual_seed(0), tcfg)
    seen, orig = [], kops.flash_attention

    def spy(q, k, v, causal=True, window=None, q_offset=0):
        seen.append(window)
        return orig(q, k, v, causal=causal, window=window, q_offset=q_offset)

    monkeypatch.setattr(kops, "flash_attention", spy)
    toks = torch.from_numpy(_tokens(1, 24))
    tmodels.forward(params, tcfg, {"tokens": toks})
    tmodels.prefill(params, tcfg, {"tokens": toks}, s_max=30)
    assert seen == [None, 16, 16, 16] * 2


# ---------------------------------------------------------------------- #
# the loss and its gradients
# ---------------------------------------------------------------------- #
def _assert_tree_close(port, ref, rel, what):
    fp, fr = _flatten(port), _flatten(ref)
    assert fp.keys() == fr.keys(), what
    for k, r in fr.items():
        r = np.asarray(r, np.float32)
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(fp[k].float().numpy() - r).max()) <= rel * scale, f"{what} {k}"


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name, remat):
    """``lm_loss`` and its gradient against ``jax.value_and_grad`` of the
    reference's ``loss_fn``; with ``remat`` the port recomputes each hymba
    layer (xlstm: each mLSTM block) in the backward."""
    jcfg, tcfg = _cfgs(name)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    tree = _ref_tree(jcfg, seed=3)
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, 256, (B, 24)).astype(np.int32) for k in ("tokens", "labels")}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    loss, met, grads = ttrainer.value_and_grad(lm_params_from_numpy(tree, "cpu"), tcfg,
                                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(met["aux"]) == 0.0 == float(jmet["aux"])
    _assert_tree_close(grads, jax.tree.map(np.asarray, jgrads), 1e-4, "grad")


# ---------------------------------------------------------------------- #
# bf16 compute: the reference's block bodies one layer at a time
# ---------------------------------------------------------------------- #
def _jax_hymba_loop(p_all, cfg, tokens, prompt):
    """The reference's hymba scan bodies (forward; prefill into a bf16 ring +
    decode), one layer at a time in Python: with compute_dtype bf16 and fp32
    params its ``lax.scan`` refuses to run (ROADMAP.md Queue 3 item 4)."""
    L, b = cfg.num_layers, tokens.shape[0]
    layers = [jax.tree.map(lambda a, l=l: a[l], p_all["blocks"]) for l in range(L)]
    wins = [None if w >= jlm.FULL_WINDOW else int(w) for w in jlm.window_schedule(cfg)]
    di = cfg.ssm_expand * cfg.d_model
    ssm0 = jnp.zeros((b, cfg.ssm_heads, cfg.ssm_state, di // cfg.ssm_heads), jnp.float32)
    x = jlm._embed(p_all, cfg, tokens)
    for p, w in zip(layers, wins):
        x, _, _, _ = jlm._hymba_block(cfg, p, x, w, None, ssm0, None, 0)
    full = jlm._logits(p_all, cfg, jrms(x, p_all["final_norm"]))

    s_max = tokens.shape[1]
    sc = jlm.cache_len(cfg, s_max)
    x = jlm._embed(p_all, cfg, tokens[:, :prompt])
    caches = []
    for p, w in zip(layers, wins):
        h = jrms(x, p["ln1"])
        out, kf, vf = jattn.attention_prefill_kv(
            p["attn"], h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta, window=w)
        cc0 = jnp.zeros((b, cfg.conv_width - 1, di), x.dtype)
        so, ssm, cc = jlm._ssd_branch(cfg, p["ssd"], h, ssm0, cc0, False)
        x = x + 0.5 * (out + so)
        x = x + jswiglu(jrms(x, p["ln2"]), p["mlp"]["wg"], p["mlp"]["wi"], p["mlp"]["wo"])
        slot = jnp.clip((prompt - 1) - jnp.mod(prompt - 1 - jnp.arange(sc), sc), 0, prompt - 1)
        caches.append([jnp.take(kf, slot, axis=2).astype(jnp.bfloat16),
                       jnp.take(vf, slot, axis=2).astype(jnp.bfloat16), ssm,
                       cc.astype(jnp.bfloat16)])
    outs = [jlm._logits(p_all, cfg, jrms(x, p_all["final_norm"])[:, -1:])]
    for i in range(prompt, s_max):
        x = jlm._embed(p_all, cfg, tokens[:, i:i + 1])
        for l, p in enumerate(layers):
            ck, cv, ssm, conv = caches[l]
            h = jrms(x, p["ln1"])
            out, ck, cv = jattn.ring_decode_attention(
                p["attn"], h, ck, cv, jnp.asarray(i), n_heads=cfg.num_heads,
                n_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
            so, ssm, conv_new = jlm._ssd_branch(cfg, p["ssd"], h, ssm, conv.astype(x.dtype), True)
            x = x + 0.5 * (out + so)
            x = x + jswiglu(jrms(x, p["ln2"]), p["mlp"]["wg"], p["mlp"]["wi"], p["mlp"]["wo"])
            caches[l] = [ck, cv, ssm, conv_new.astype(conv.dtype)]
        outs.append(jlm._logits(p_all, cfg, jrms(x, p_all["final_norm"])))
    return full, outs


def _jax_xlstm_loop(p_all, cfg, tokens, prompt):
    """The same for xlstm: its sLSTM and mLSTM block bodies one at a time."""
    b, nh = tokens.shape[0], cfg.num_heads
    dh, kw = cfg.d_model // nh, cfg.conv_width
    groups = cfg.num_layers // cfg.slstm_every
    per = cfg.slstm_every - 1
    ps = [jax.tree.map(lambda a, g=g: a[g], p_all["slstm_blocks"]) for g in range(groups)]
    pm = [[jax.tree.map(lambda a, g=g, j=j: a[g, j], p_all["mlstm_blocks"]) for j in range(per)]
          for g in range(groups)]

    def run(x, states, decoding):
        new = []
        for g in range(groups):
            s_st = states[g][0] if states else jssm.slstm_init_state(b, nh, dh)
            x, s_st = jlm._slstm_block(cfg, ps[g], x, s_st, decoding)
            row = [s_st]
            for j in range(per):
                if states:
                    m_st, cc = states[g][1 + j]
                    cc = cc.astype(x.dtype)
                else:
                    m_st = jssm.mlstm_init_state(b, nh, dh, dh)
                    cc = jnp.zeros((b, kw - 1, cfg.d_model), x.dtype)
                x, m_st, cc = jlm._mlstm_block(cfg, pm[g][j], x, m_st, cc, decoding)
                row.append((m_st, cc.astype(jnp.bfloat16)))
            new.append(row)
        return x, new

    x, _ = run(jlm._embed(p_all, cfg, tokens), None, False)
    full = jlm._logits(p_all, cfg, jrms(x, p_all["final_norm"]))
    x, states = run(jlm._embed(p_all, cfg, tokens[:, :prompt]), None, False)
    outs = [jlm._logits(p_all, cfg, jrms(x, p_all["final_norm"])[:, -1:])]
    for i in range(prompt, tokens.shape[1]):
        x, states = run(jlm._embed(p_all, cfg, tokens[:, i:i + 1]), states, True)
        outs.append(jlm._logits(p_all, cfg, jrms(x, p_all["final_norm"])))
    return full, outs


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_compute_matches_reference_layer_loop(name):
    """compute_dtype bf16 (the full configs' setting) with the default bf16
    cache and carries: the embedding rows are rounded to bf16, the residual
    stream is fp32 from layer 0 on, as in the reference."""
    jcfg, tcfg = _cfgs(name, compute_dtype="bfloat16")
    tree = _ref_tree(jcfg)
    tp = lm_params_from_numpy(tree, "cpu")
    s, prompt = 40, 34
    toks = _tokens(2, s)
    loop = _jax_hymba_loop if name == HYMBA else _jax_xlstm_loop
    full, outs = loop(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks), prompt)
    port = tmodels.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert port.dtype == torch.float32
    _close(port, full, 2e-2, "forward")
    touts, _ = _serve_path(tp, tcfg, tmodels, toks, prompt, None, torch.from_numpy)
    for i, (t, j) in enumerate(zip(touts, outs)):
        _close(t, j, 2e-2, f"serve step {i}")


# ---------------------------------------------------------------------- #
# the port's own checks (the reference's tests/test_archs_smoke.py)
# ---------------------------------------------------------------------- #
def test_hymba_ring_cache_matches_window_attention():
    """Long decode with the ring cache ≡ forward with the sliding-window mask
    (pure SWA, so that no layer differs by design)."""
    _, tcfg = _cfgs(HYMBA, full_attn_layers=())
    params = lm_params_from_numpy(_ref_tree(_cfgs(HYMBA)[0], seed=2), "cpu")
    s, steps = 48, 8  # > window (16): the ring wraps
    toks = torch.from_numpy(_tokens(3, s))
    full = tmodels.forward(params, tcfg, {"tokens": toks})
    logits, cache = tmodels.prefill(params, tcfg, {"tokens": toks[:, :s - steps]}, s_max=s,
                                    cache_dtype=torch.float32)
    assert cache.k.shape[3] == tcfg.window  # a ring buffer, not the full length
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, s - steps - 1].numpy(), atol=1e-4,
                               rtol=1e-4)
    for i in range(s - steps, s):
        logits, cache = tmodels.decode_step(params, tcfg, toks[:, i:i + 1], cache)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, i].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f"ring step {i}")


@pytest.mark.parametrize("name", ARCHS)
def test_teacher_forced_decode_matches_forward(name):
    """Prefill and teacher-forced decode reproduce the full forward (hymba
    pure SWA; the reference's tests/test_archs_smoke.py check)."""
    kw = {"full_attn_layers": ()} if name == HYMBA else {}
    _, tcfg = _cfgs(name, **kw)
    params = lm_params_from_numpy(_ref_tree(_cfgs(name, **kw)[0], seed=4), "cpu")
    toks = _tokens(5, 32)
    full = tmodels.forward(params, tcfg, {"tokens": torch.from_numpy(toks)})
    outs, _ = _serve_path(params, tcfg, tmodels, toks, 28, torch.float32, torch.from_numpy)
    for i, logits in enumerate(outs):
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 27 + i].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {i}")


@pytest.mark.parametrize("name", ARCHS)
def test_long_context_archs_state_bounded(name):
    """Sub-quadratic archs: the decode state does not grow with the context."""
    cfg = tconfigs.reduced_config(tconfigs.get_arch(name))
    assert cfg.supports_long_context

    def size(cache):
        return sum(t.numel() for t in cache if isinstance(t, torch.Tensor))

    small = size(tmodels.init_cache(cfg, 1, 64, device="cpu"))
    large = size(tmodels.init_cache(cfg, 1, 4096, device="cpu"))
    if name == XLSTM:
        assert small == large  # pure state, no KV at all
        assert isinstance(tmodels.init_cache(cfg, 1, 64, device="cpu"), tmodels.XLSTMCache)
    else:
        assert large <= small * (cfg.window / 16)  # bounded by the ring's size


# ---------------------------------------------------------------------- #
# the serving entry point
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ARCHS)
def test_serve_tokens_equal_reference_greedy_loop(name):
    jcfg, tcfg = _cfgs(name)
    tree = _ref_tree(jcfg, seed=2)
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")
    prompt, gen = _tokens(3, 12), 8  # hymba: s_max 20 > window 16, a ring
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


@pytest.mark.parametrize("name", ARCHS)
def test_serve_cli_runs_reduced_on_cpu(name, capsys):
    tserve.main(["--arch", name, "--device", "cpu", "--reduced", "--batch", "2",
                 "--prompt-len", "20", "--gen", "3"])
    out = capsys.readouterr().out
    assert f"arch={name} device=cpu" in out and "sample:" in out
