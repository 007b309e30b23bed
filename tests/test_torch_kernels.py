"""The port's kernel ops against the JAX package's, on the same numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode
(``FORCE_PALLAS_INTERPRET``) and its pure-jnp oracles.  Tolerance
``atol = rtol = 1e-5``: fp32 sums taken in a different order.  The CUDA
kernels themselves are held against the plain versions by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on a card.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.delta_agg import delta_agg  # noqa: E402
from repro_torch.kernels.edge_softmax import edge_softmax_normalize  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.row_linear import (  # noqa: E402
    ENTRIES,
    TILED_MIN_ROWS,
    kernel_entry,
    row_linear,
    row_linear_plain,
)
from repro_torch.kernels.segment_spmm import (  # noqa: E402
    ROW_SUM_CHUNK,
    _row_sum_scratch,
    prepare_row_schedule,
    row_sum_chunked_plain,
    segment_spmm,
    segment_spmm_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)

# (records, width, rows, Pallas tile sizes tv/be/bd)
CASES = [
    (700, 96, 40, (8, 128, 32)),
    (64, 32, 8, (8, 64, 32)),
    (33, 160, 100, (8, 64, 32)),  # sparse: many rows no record visits
]


@pytest.fixture
def pallas_interpret():
    old = jops.FORCE_PALLAS_INTERPRET
    jops.FORCE_PALLAS_INTERPRET = True
    yield
    jops.FORCE_PALLAS_INTERPRET = old


def _sorted_dst(rng, e, v, pad=5):
    """Ascending destination ids with a -1 padded tail; rows ≡ 1 (mod 3)
    are never visited."""
    pool = np.setdiff1d(np.arange(v), np.arange(1, v, 3))
    dst = np.sort(rng.choice(pool, e)).astype(np.int32)
    dst[e - pad:] = -1
    return dst


@pytest.mark.parametrize("e,d,v,tiles", CASES)
def test_segment_sum_edges_matches_reference(e, d, v, tiles, pallas_interpret):
    rng = np.random.default_rng(e + d)
    dst = _sorted_dst(rng, e, v)
    msg = rng.normal(size=(e, d)).astype(np.float32)
    tv, be, bd = tiles
    out = tops.segment_sum_edges(torch.from_numpy(msg), dst, v).numpy()
    pallas = np.asarray(jops.segment_sum_edges(jnp.asarray(msg), dst, v, tv=tv, be=be, bd=bd))
    oracle = np.asarray(jref.segment_spmm_ref(jnp.asarray(msg), jnp.asarray(dst), v))
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)
    unvisited = np.setdiff1d(np.arange(v), dst[dst >= 0])
    assert unvisited.size and np.all(out[unvisited] == 0.0)


@pytest.mark.parametrize("e,d,v,tiles", CASES)
def test_delta_agg_update_matches_reference(e, d, v, tiles, pallas_interpret):
    rng = np.random.default_rng(e * 3 + d)
    dst = _sorted_dst(rng, e, v)
    msg = rng.normal(size=(e, d)).astype(np.float32)
    state = rng.normal(size=(v, d)).astype(np.float32)
    tv, be, bd = tiles
    out = tops.delta_agg_update(torch.from_numpy(state), torch.from_numpy(msg), dst).numpy()
    pallas = np.asarray(jops.delta_agg_update(jnp.asarray(state), jnp.asarray(msg), dst,
                                              tv=tv, be=be, bd=bd))
    oracle = np.asarray(jref.delta_agg_ref(jnp.asarray(state), jnp.asarray(msg),
                                           jnp.asarray(dst)))
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)


def _plan_order_inputs(seed, e, d, r):
    """Records in plan order (unsorted row keys, -1 padding mixed in) and
    their row schedule — the layout the packed plan ships."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, r, e)
    keys[keys % 5 == 2] = -1  # rows ≡ 2 (mod 5) get no records
    keys[rng.random(e) < 0.2] = -1
    msg = rng.normal(size=(e, d)).astype(np.float32)
    order, row_ptr = prepare_row_schedule(keys, r)
    return keys, msg, torch.from_numpy(order), torch.from_numpy(row_ptr)


@pytest.mark.parametrize("e,d,r", [(300, 33, 64), (17, 129, 16)])
def test_segment_spmm_schedule_matches_oracle(e, d, r):
    keys, msg, order, row_ptr = _plan_order_inputs(e + d, e, d, r)
    out = segment_spmm(torch.from_numpy(msg), row_ptr, order, r).numpy()
    oracle = np.asarray(jref.segment_spmm_ref(jnp.asarray(msg), jnp.asarray(keys, jnp.int32), r))
    np.testing.assert_allclose(out, oracle, **TOL)
    empty = np.setdiff1d(np.arange(r), keys[keys >= 0])
    assert np.all(out[empty] == 0.0)


@pytest.mark.parametrize("e,d,r", [(300, 33, 64), (17, 129, 16)])
def test_delta_agg_schedule_matches_oracle_and_skips_untouched_rows(e, d, r):
    keys, msg, order, row_ptr = _plan_order_inputs(e * 7 + d, e, d, r)
    state0 = np.random.default_rng(d).normal(size=(r, d)).astype(np.float32)
    state = torch.from_numpy(state0.copy())
    out = delta_agg(state, torch.from_numpy(msg), row_ptr, order)
    assert out is state  # in place
    oracle = np.asarray(jref.delta_agg_ref(jnp.asarray(state0), jnp.asarray(msg),
                                           jnp.asarray(keys, jnp.int32)))
    np.testing.assert_allclose(out.numpy(), oracle, **TOL)
    untouched = np.setdiff1d(np.arange(r), keys[keys >= 0])
    assert untouched.size
    np.testing.assert_array_equal(out.numpy()[untouched], state0[untouched])


def test_row_schedule_covers_each_live_record_once_in_order():
    rng = np.random.default_rng(0)
    keys = rng.integers(-1, 20, 500)  # -1 = dropped
    order, row_ptr = prepare_row_schedule(keys, 20)
    assert row_ptr[0] == 0 and row_ptr[-1] == np.count_nonzero(keys >= 0)
    seen = order[: row_ptr[-1]]
    np.testing.assert_array_equal(np.sort(seen), np.nonzero(keys >= 0)[0])
    for r in range(20):
        run = order[row_ptr[r]:row_ptr[r + 1]]
        assert np.all(keys[run] == r)
        assert np.all(np.diff(run) > 0)  # stable: each row keeps record order


def test_wrappers_reject_unsupported_devices_and_shapes():
    msg = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segment_spmm(msg, torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        delta_agg(torch.zeros(2, 3, device="meta"), msg,
                  torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="expected 3"):
        segment_spmm(torch.zeros(4, 3), torch.zeros(5, dtype=torch.int32), None, 2)


# ---------------------------------------------------------------------- #
# the kernels' chunked order of additions (row_sum_chunked_plain)
# ---------------------------------------------------------------------- #
CHUNK = 4  # a small chunk, so that short rows cross it
#: row lengths around the chunk's edges, and rows without records
EDGE_LENGTHS = (0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK, 2 * CHUNK + 1, 3 * CHUNK + 2, 0, 13)


def _chains(msg, rows, chunk):
    """The documented order, one element at a time: each chunk a chain
    from 0 in record order, then the chunk sums in chunk order."""
    out = []
    for recs in rows:
        parts = []
        for j in range(0, len(recs), chunk):
            acc = np.zeros(msg.shape[1], np.float32)
            for e in recs[j:j + chunk]:
                acc = acc + msg[e]
            parts.append(acc)
        total = parts[0] if parts else np.zeros(msg.shape[1], np.float32)
        for p in parts[1:]:
            total = total + p
        out.append(total)
    return np.stack(out)


def _chunked_inputs(lengths, d, seed, ordered):
    """Records of rows with ``lengths``, dst-sorted or (``ordered``) in a
    random record order with a row schedule; also each row's record ids."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    keys = np.repeat(np.arange(len(lengths)), lengths)
    if ordered:
        keys = keys[rng.permutation(len(keys))]
        order, row_ptr = prepare_row_schedule(keys, len(lengths))
    else:
        order, row_ptr = None, np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    msg = rng.normal(size=(len(keys), d)).astype(np.float32)
    ids = order if ordered else np.arange(len(keys))
    rows = [ids[row_ptr[r]:row_ptr[r + 1]] for r in range(len(lengths))]
    return (keys, msg, torch.from_numpy(row_ptr),
            None if order is None else torch.from_numpy(order), rows)


def test_row_sum_chunk_is_the_kernel_constant():
    """``ROW_SUM_CHUNK`` mirrors ``kChunk`` of ``csrc/row_sum.cuh``; the
    kernels' scratch exists only when a row can be longer than a chunk."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "row_sum.cuh").read_text()
    assert re.findall(r"constexpr int kChunk = (\d+);", src) == [str(ROW_SUM_CHUNK)]
    assert _row_sum_scratch(ROW_SUM_CHUNK, 129, "cpu") is None
    windows = 2  # ⌈513 / 512⌉: 2 windows of 2 slots of 129 floats, 2 int64 hub-row ids
    assert _row_sum_scratch(ROW_SUM_CHUNK + 1, 129, "cpu").numel() == 2 * windows * 129 + 2 * windows


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("d", [1, 33, 129])
def test_row_sum_chunked_plain_is_the_documented_order(ordered, d):
    """Bitwise the per-element chains at the chunk's edges (lengths chunk - 1,
    chunk, chunk + 1, 2·chunk, 2·chunk + 1, and rows without records)."""
    _, msg, row_ptr, order, rows = _chunked_inputs(EDGE_LENGTHS, d, d, ordered)
    out = row_sum_chunked_plain(torch.from_numpy(msg), row_ptr, order, CHUNK)
    np.testing.assert_array_equal(out.numpy(), _chains(msg, rows, CHUNK))


@pytest.mark.parametrize("ordered", [False, True])
def test_row_sum_chunked_plain_matches_plain_and_reference(ordered, pallas_interpret):
    """Rows of at most a chunk: bitwise ``segment_spmm_plain`` (one chain in
    record order).  Longer rows: within 1e-5 of it, of the reference's oracle
    and of its Pallas kernel in interpret mode."""
    lengths = list(EDGE_LENGTHS) + list(np.random.default_rng(5).integers(0, 3 * CHUNK, 30))
    keys, msg, row_ptr, order, _ = _chunked_inputs(lengths, 40, 11, ordered)
    r = len(lengths)
    out = row_sum_chunked_plain(torch.from_numpy(msg), row_ptr, order, CHUNK)
    plain = segment_spmm_plain(torch.from_numpy(msg), row_ptr, order, r)
    short = torch.from_numpy(np.asarray(lengths) <= CHUNK)
    assert torch.equal(out[short], plain[short])
    assert not torch.equal(out[~short], plain[~short])  # the long rows' order differs
    torch.testing.assert_close(out, plain, **TOL)
    oracle = np.asarray(jref.segment_spmm_ref(jnp.asarray(msg), jnp.asarray(keys, jnp.int32), r))
    np.testing.assert_allclose(out.numpy(), oracle, **TOL)
    if not ordered:  # the Pallas kernel takes dst-sorted records
        pallas = np.asarray(jops.segment_sum_edges(jnp.asarray(msg), keys.astype(np.int32), r,
                                                   tv=8, be=64, bd=32))
        np.testing.assert_allclose(out.numpy(), pallas, **TOL)


@pytest.mark.parametrize("ordered", [False, True])
def test_row_sum_chunked_row_bits_depend_on_its_own_records_only(ordered):
    """A row's bits stay when other rows are added around it, when its
    records sit at another offset of the record array, and when the row
    count changes."""
    rng = np.random.default_rng(3)
    d, target = 24, 2 * CHUNK + 3
    own = rng.normal(size=(target, d)).astype(np.float32)

    def row_bits(before, after, pad):
        lengths = list(before) + [target] + list(after)
        keys, msg, row_ptr, order, rows = _chunked_inputs(lengths, d, len(lengths), ordered)
        msg = np.concatenate([msg, np.zeros((pad, d), np.float32)])  # records past the schedule
        msg[rows[len(before)]] = own  # the row's own records, wherever they sit
        out = row_sum_chunked_plain(torch.from_numpy(msg), row_ptr, order, CHUNK)
        return out[len(before)]

    ref = row_bits([], [], 0)
    np.testing.assert_array_equal(ref.numpy(), _chains(own, [np.arange(target)], CHUNK)[0])
    for before, after, pad in [([3], [], 0), ([CHUNK + 1, 0, 2], [7, 1], 5),
                               ([1] * 17, [2 * CHUNK], 0), ([], [CHUNK] * 9, 3)]:
        assert torch.equal(row_bits(before, after, pad), ref), (before, after, pad)


# ---------------------------------------------------------------------- #
# edge_softmax and flash_attention
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("e,h,v", [(700, 4, 40), (120, 1, 16), (1024, 8, 128)])
def test_edge_softmax_matches_reference(e, h, v, pallas_interpret):
    """The reference test's sweep (tests/test_kernels.py) and tolerances:
    normalized scores 1e-5, sums 1e-4."""
    rng = np.random.default_rng(e)
    dst = np.sort(rng.integers(0, v, e)).astype(np.int32)
    sc = rng.uniform(0.05, 5.0, size=(e, h)).astype(np.float32)
    n, s = tops.edge_softmax(torch.from_numpy(sc), dst, v)
    for n_ref, s_ref in (jops.edge_softmax(jnp.asarray(sc), dst, v, tv=8, be=128, bh=32),
                         jref.edge_softmax_ref(jnp.asarray(sc), jnp.asarray(dst), v)):
        np.testing.assert_allclose(n.numpy(), np.asarray(n_ref), atol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    sums = np.zeros((v, h))
    np.add.at(sums, dst, n.numpy())
    np.testing.assert_allclose(sums[np.unique(dst)], 1.0, atol=1e-4)


def test_edge_softmax_padding_and_empty_rows():
    """-1 padded edges normalize to 0 (the reference's kernel path), rows no
    edge reaches have sum 0, and ids outside [-1, num_rows) raise."""
    dst = np.array([0, 0, 2, -1, 2, -1])
    sc = torch.arange(1.0, 13.0).reshape(6, 2)
    n, s = tops.edge_softmax(sc, dst, 4)
    assert torch.all(n[dst < 0] == 0) and torch.all(s[[1, 3]] == 0)
    torch.testing.assert_close(n[[0, 1]].sum(0), torch.ones(2))
    with pytest.raises(ValueError, match=r"\[-1, 4\)"):
        tops.edge_softmax(sc, np.array([0, 0, 4, 1, 1, 1]), 4)


def _tol_attn(dtype):
    # the reference test's tolerances (tests/test_kernels.py)
    return dict(atol=3e-2, rtol=3e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-3)


def _qkv(seed, b, hq, hkv, sq, sk, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, dh)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,hq,hkv,s,dh,bq,bk,causal,window",
    [
        (2, 4, 2, 256, 64, 128, 128, True, None),
        (1, 2, 2, 128, 32, 64, 64, False, None),
        (2, 4, 1, 256, 64, 128, 64, True, 64),
        (1, 8, 4, 512, 128, 256, 256, True, None),
        (2, 8, 2, 200, 160, 512, 100, True, None),  # pixtral's dh 160, ragged S, GQA g = 4
    ],
)
def test_flash_attention_matches_reference(b, hq, hkv, s, dh, bq, bk, causal, window, dtype,
                                           pallas_interpret):
    """The reference test's sweep: the port against the Pallas kernel
    (interpret mode) and the reference oracle, on the same bf16/fp32 values."""
    arrs = _qkv(s + dh, b, hq, hkv, s, s, dh)
    out = tops.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
                               causal=causal, window=window).float().numpy()
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    for ref in (jops.flash_attention(jq, jk, jv, causal=causal, window=window, bq=bq, bk=bk),
                jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(out, np.asarray(ref, np.float32), **_tol_attn(dtype))


def test_flash_attention_decode_shape_matches_reference(pallas_interpret):
    """q_len = 1 against a full KV cache at q_offset = 255."""
    q, k, v = _qkv(9, 2, 4, 2, 1, 256, 64)
    out = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=True, q_offset=255).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for ref in (jops.flash_attention(jq, jk, jv, causal=True, q_offset=255, bq=1, bk=128),
                jref.flash_attention_ref(jq, jk, jv, causal=True, q_offset=255)):
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)


def test_flash_attention_long_prefill_chunks_and_empty_rows():
    """Sq = 4096 takes the 2048-row chunked path of the plain version and
    equals one unchunked call; a row that sees no key is 0."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 1, 4096, 4096, 16))
    out = tops.flash_attention(q, k, v, causal=True, window=32)
    whole = torch.cat([tops.flash_attention(q[:, :, :2048 + 1], k, v, causal=True, window=32),
                       tops.flash_attention(q[:, :, 2049:], k, v, causal=True, window=32,
                                            q_offset=2049)], dim=2)
    torch.testing.assert_close(out, whole, atol=2e-5, rtol=2e-3)
    empty = tops.flash_attention(q[:, :, :4], k, v, causal=True, q_offset=-2)
    assert torch.all(empty[:, :, :2] == 0) and torch.all(empty[:, :, 2:] != 0)


def test_attention_wrappers_reject_what_no_path_takes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="window"):
        tops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="do not fit"):
        tops.flash_attention(q, k[:, :, :, :8], v[:, :, :, :8])
    with pytest.raises(ValueError, match="do not fit"):
        tops.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    sc, dst = torch.ones(6, 2, device="meta"), torch.zeros(6, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        edge_softmax_normalize(sc, dst, torch.ones(3, 2, device="meta"))
    with pytest.raises(ValueError, match="expected scores"):
        edge_softmax_normalize(torch.ones(6, 2), torch.zeros(5, dtype=torch.int64),
                               torch.ones(3, 2))


# ---------------------------------------------------------------------- #
# flash_attention's backward: the plain version and the autograd Function
# ---------------------------------------------------------------------- #
BWD_CASES = [  # b, hq, hkv, sq, sk, dh, causal, window, q_offset
    (2, 4, 4, 64, 64, 16, True, None, 0),  # MHA (g = 1), causal
    (1, 8, 2, 70, 70, 64, True, None, 0),  # GQA g = 4, ragged S
    (1, 4, 1, 100, 77, 16, False, None, 0),  # not causal, Sq ≠ Sk
    (2, 4, 1, 130, 130, 16, True, 48, 0),  # window
    (1, 4, 4, 5, 150, 64, True, None, 145),  # the last rows of a cache
    (1, 4, 1, 70, 70, 16, True, 16, -20),  # rows that see no key: zero gradients
    (1, 4, 1, 40, 40, 160, True, None, 0),  # pixtral's dh 160, GQA g = 4, causal
    (1, 2, 2, 33, 21, 160, False, None, 0),  # dh 160, not causal, Sq ≠ Sk
]


def _bwd_inputs(case, seed=0):
    b, hq, hkv, sq, sk, dh = case[:6]
    q, k, v = _qkv(seed + sq + dh, b, hq, hkv, sq, sk, dh)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_ref_matches_reference_vjp_and_autograd(case):
    """``flash_attention_bwd_ref`` (from the saved o and lse) against
    ``jax.vjp`` of the reference's ``flash_attention_ref`` and against torch
    autograd through the port's ``flash_attention_ref``, at 1e-5."""
    causal, window, q_offset = case[6:]
    q, k, v, do = _bwd_inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = kref.flash_attention_lse_ref(tq, tk, tv, causal, window, q_offset)
    assert lse.dtype == torch.float32 and lse.shape == tq.shape[:3]
    grads = kref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal, window, q_offset)

    _, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(
        a, b_, c, causal=causal, window=window, q_offset=q_offset), *map(jnp.asarray, (q, k, v)))
    ref_jax = vjp(jnp.asarray(do))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = kref.flash_attention_ref(*leaves, causal=causal, window=window, q_offset=q_offset)
    ref_torch = torch.autograd.grad(out, leaves, tdo)
    for name, g, rj, rt in zip(("dq", "dk", "dv"), grads, ref_jax, ref_torch):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(rj), **TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), rt.numpy(), **TOL, err_msg=name)
    if q_offset < 0:  # rows 0, 1 see no key: lse −inf, zero dq
        assert torch.all(torch.isneginf(lse[:, :, :2])) and torch.all(grads[0][:, :, :2] == 0)


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (False, None, 0),
                                                    (True, 32, 0), (True, None, 4096)])
def test_flash_attention_lse_ref_o_is_flash_attention_ref_bitwise(causal, window, q_offset):
    """The same o bits with and without lse, through the 2048-row chunked
    path too (Sq = 4096); lse = logsumexp of the scaled, masked scores
    (checked on the first 64 rows, which also agree with the chunked call)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 2, 1, 4096, 4096 + q_offset, 16))
    o, lse = kref.flash_attention_lse_ref(q, k, v, causal, window, q_offset)
    assert torch.equal(o, kref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                                   q_offset=q_offset))
    o2, lse2 = tops.flash_attention_lse(q[:, :, :64], k, v, causal, window, q_offset)
    s = torch.einsum("bhqd,bkd->bhqk", q[:, :, :64], k[:, 0]) / 4.0
    qpos, kpos = q_offset + torch.arange(64)[:, None], torch.arange(k.shape[2])[None, :]
    ok = (kpos <= qpos) if causal else torch.ones(64, k.shape[2], dtype=torch.bool)
    if window is not None:
        ok &= kpos > qpos - window
    torch.testing.assert_close(lse2, torch.logsumexp(s.masked_fill(~ok, -torch.inf), -1),
                               **TOL)
    torch.testing.assert_close(lse2, lse[:, :, :64], **TOL)
    torch.testing.assert_close(o2, o[:, :, :64], **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES[:3])
def test_flash_attention_autograd_function_on_cpu(case, dtype):
    """With inputs that require grad, ``flash_attention`` goes through the
    autograd Function: its output is the plain forward's bit for bit and its
    gradients are ``flash_attention_bwd``'s (the plain version on the CPU)."""
    causal, window, q_offset = case[6:]
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in _bwd_inputs(case, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=causal, window=window, q_offset=q_offset)
    assert out.grad_fn is not None and out.dtype == dt
    assert torch.equal(out.detach(), tops.flash_attention(q, k, v, causal=causal, window=window,
                                                          q_offset=q_offset))
    grads = torch.autograd.grad(out, leaves, do)
    o, lse = tops.flash_attention_lse(q, k, v, causal, window, q_offset)
    expect = flash_attention_bwd(q, k, v, o, lse, do, causal, window, q_offset)
    for g, e in zip(grads, expect):
        assert g.dtype == dt and torch.equal(g, e)
    with torch.no_grad():  # the serving path: no Function, no lse
        assert tops.flash_attention(*leaves, causal=causal).grad_fn is None


def test_flash_attention_bwd_rejects_what_no_path_takes():
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(BWD_CASES[0]))
    o, lse = tops.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="shaped like q"):
        flash_attention_bwd(q, k, v, o, lse[:, :, :3], do)
    with pytest.raises(ValueError, match="shaped like q"):
        flash_attention_bwd(q, k, v, o, lse, do[:, :, :3])
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd(*(t.to("meta") for t in (q, k, v, o, lse, do)))


# ---------------------------------------------------------------------- #
# the CUDA flash kernel's precision: split TF32 on the tensor cores
# ---------------------------------------------------------------------- #
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)  # & 0xFFFFE000


def _split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's wgmma chains form it: x = hi + lo with hi =
    tf32(x), lo = tf32(x - hi); lo·hi + hi·lo first, then hi·hi, fp32 sums."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _tensor_core_attention(q, k, v, causal, window, mm):
    """The kernel's arithmetic on the CPU: S = mm(Q, Kᵀ)·scale, masked,
    P = exp(S - rowmax) unnormalised, O = mm(P, V) / rowsum(P)."""
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    sq, sk = q.shape[2], k.shape[2]
    s = mm(q, k.transpose(2, 3)) / np.sqrt(q.shape[3])
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = s.masked_fill(~ok, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize(
    "b,hq,hkv,s,dh,causal,window",
    [
        (2, 4, 2, 256, 64, True, None),  # the reference's flash sweep (tests/test_kernels.py)
        (1, 2, 2, 128, 32, False, None),
        (2, 4, 1, 256, 64, True, 64),
        (1, 8, 4, 512, 128, True, None),
        (1, 4, 1, 512, 64, True, None),  # the LM's head dim and GQA at a longer row
    ],
)
def test_split_tf32_attention_holds_the_fp32_tolerance(b, hq, hkv, s, dh, causal, window):
    """The CUDA kernel multiplies fp32 inputs as three TF32 products
    (hi·hi + hi·lo + lo·hi).  Emulated on the CPU bit for bit in its
    operands, that arithmetic holds the fp32 tolerance against the
    reference's ``flash_attention_ref``; plain TF32 (hi·hi alone) does not."""
    arrs = _qkv(s + dh + 1, b, hq, hkv, s, s, dh)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    ref = np.asarray(jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs), causal=causal,
                                              window=window))
    out = _tensor_core_attention(q, k, v, causal, window, _split_mm).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-3)
    plain = _tensor_core_attention(q, k, v, causal, window,
                                   lambda a, b_: _tf32(a) @ _tf32(b_)).numpy()
    assert not np.allclose(plain, ref, atol=2e-5, rtol=2e-3)


def _tensor_core_attention_bwd(q, k, v, do, causal, window, mm):
    """The backward kernels' arithmetic on the CPU, product by product: the
    dQ kernel's S = mm(Q, Kᵀ), dP = mm(dO, Vᵀ), dQ = mm(dS, K)·scale and the
    dK/dV kernel's Sᵀ = mm(K, Qᵀ), dPᵀ = mm(V, dOᵀ), dV = mm(Pᵀ, dO), dK =
    mm(dSᵀ, Q)·scale (P and dS go into the products as they are, split when
    ``mm`` splits), P = exp(S·scale − lse) on the visible keys, D =
    rowsum(dO ∘ O); dK and dV summed over each KV head's query heads."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    o, lse = kref.flash_attention_lse_ref(q, k, v, causal, window)
    kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    scale = 1.0 / np.sqrt(dh)
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    d = (do * o).sum(-1, keepdim=True)

    def p_ds(s, dp):  # [.., Sq, Sk]
        p = torch.where(ok, torch.exp(s * scale - lse[..., None]), 0.0)
        return p, p * (dp - d)

    _, ds = p_ds(mm(q, kr.transpose(2, 3)), mm(do, vr.transpose(2, 3)))  # dQ kernel
    dq = mm(ds, kr) * scale
    pt, dst = (x.transpose(2, 3) for x in p_ds(mm(kr, q.transpose(2, 3)).transpose(2, 3),
                                                 mm(vr, do.transpose(2, 3)).transpose(2, 3)))
    dv = mm(pt, do).reshape(b, hkv, g, sk, dh).sum(2)  # dK/dV kernel
    dk = (mm(dst, q) * scale).reshape(b, hkv, g, sk, dh).sum(2)
    return dq, dk, dv


@pytest.mark.parametrize(
    "b,hq,hkv,s,dh,causal,window",
    [
        (2, 4, 2, 256, 64, True, None),  # the shapes of the forward's split-TF32 test
        (1, 2, 2, 128, 32, False, None),
        (2, 4, 1, 256, 64, True, 64),
        (1, 8, 4, 512, 128, True, None),
        (1, 4, 1, 512, 64, True, None),
    ],
)
def test_split_tf32_attention_bwd_holds_the_fp32_tolerance(b, hq, hkv, s, dh, causal, window):
    """The backward kernels multiply fp32 as three TF32 products per product,
    P and dS split like every other operand.  Emulated on the CPU, their seven
    products hold dq, dk and dv to ``jax.vjp`` of the reference's
    ``flash_attention_ref`` at the fp32 tolerance; plain TF32 misses it."""
    arrs = _qkv(s + dh + 1, b, hq, hkv, s, s, dh)
    do = np.random.default_rng(s + dh).normal(size=arrs[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(a, b_, c, causal=causal,
                                                                 window=window),
                     *map(jnp.asarray, arrs))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(do))]
    q, k, v, tdo = (torch.from_numpy(a) for a in (*arrs, do))
    out = _tensor_core_attention_bwd(q, k, v, tdo, causal, window, _split_mm)
    for name, a, r in zip(("dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(a.numpy(), r, atol=2e-5, rtol=2e-3, err_msg=name)
    plain = _tensor_core_attention_bwd(q, k, v, tdo, causal, window,
                                       lambda a, b_: _tf32(a) @ _tf32(b_))
    for name, a, r in zip(("dq", "dk", "dv"), plain, ref):
        assert not np.allclose(a.numpy(), r, atol=2e-5, rtol=2e-3), name


_REORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])  # each 8-group of the B operand's K


def _accumulator(p: np.ndarray) -> np.ndarray:
    """A [64, N] tile as a wgmma accumulator holds it: thread t = 32·warp +
    lane has, at index 4i + 2h + e, row 16·warp + lane // 4 + 8h and column
    8i + 2·(lane % 4) + e."""
    acc = np.empty((128, p.shape[1] // 2), p.dtype)
    for t in range(128):
        r0, tig = 16 * (t // 32) + (t % 32) // 4, t % 4
        for i in range(p.shape[1] // 8):
            for h in range(2):
                for e in range(2):
                    acc[t, 4 * i + 2 * h + e] = p[r0 + 8 * h, 8 * i + 2 * tig + e]
    return acc


def _a_operand(frag: np.ndarray, bf16: bool) -> np.ndarray:
    """The [64, K] A operand that per-thread wgmma A fragments stand for, K
    in the order the hardware reads it.  TF32 (m64k8, 4 registers a step):
    (row r0, column tig), (r0 + 8, tig), (r0, tig + 4), (r0 + 8, tig + 4);
    bf16 (m64k16, 4 registers of two values, the first in the low half):
    (r0, 2·tig), (r0 + 8, 2·tig), (r0, 2·tig + 8), (r0 + 8, 2·tig + 8)."""
    step = 16 if bf16 else 8
    kd = frag.shape[1] // (8 if bf16 else 4) * step
    a = np.empty((64, kd), frag.dtype)
    for t in range(128):
        r0, tig = 16 * (t // 32) + (t % 32) // 4, t % 4
        for i in range(kd // step):
            for j in range(4):
                row = r0 + 8 * (j & 1)
                if bf16:
                    col = 16 * i + 2 * tig + 8 * (j >> 1)
                    a[row, col:col + 2] = frag[t, 8 * i + 2 * j:8 * i + 2 * j + 2]
                else:
                    a[row, 8 * i + tig + 4 * (j >> 1)] = frag[t, 4 * i + j]
    return a


def _to_frags(acc: np.ndarray, bf16: bool) -> np.ndarray:
    """The kernel's ``to_frags``: TF32 takes a thread's values of step i in
    the order 0, 2, 1, 3; bf16 takes its pairs as they are (pair j of step i
    is values 8i + 4·(j // 2) + 2·(j % 2) and the next)."""
    if bf16:
        idx = [8 * i + 4 * (j >> 1) + 2 * (j & 1) + e
               for i in range(acc.shape[1] // 8) for j in range(4) for e in range(2)]
    else:
        idx = [4 * i + (0, 2, 1, 3)[j] for i in range(acc.shape[1] // 4) for j in range(4)]
    return acc[:, idx]


@pytest.mark.parametrize("kd", [8, 16, 64])
def test_accumulator_to_a_fragment_reorder_keeps_the_product(kd):
    """P and dS go from a product's accumulator straight into the next
    product's A fragments.  In TF32 the accumulator gives a thread columns
    2t, 2t + 1 of each 8-group where the fragment wants t, t + 4, so the A
    operand the hardware reads is P with each 8-group of columns in the order
    0 2 4 6 1 3 5 7; the kernel stores the B operand's K dimension in that
    order, and A·B equals P·B exactly (integer values).  In bf16 the
    fragment matches the accumulator: A is P itself."""
    rng = np.random.default_rng(kd)
    p = rng.integers(-8, 9, size=(64, kd)).astype(np.float64)
    bmat = rng.integers(-8, 9, size=(kd, 24)).astype(np.float64)
    order = (np.arange(kd) // 8) * 8 + _REORDER[np.arange(kd) % 8]
    a = _a_operand(_to_frags(_accumulator(p), bf16=False), bf16=False)
    np.testing.assert_array_equal(a, p[:, order])
    np.testing.assert_array_equal(a @ bmat[order], p @ bmat)
    assert not np.array_equal(a @ bmat, p @ bmat)  # B left in order would be wrong
    if kd % 16 == 0:
        np.testing.assert_array_equal(_a_operand(_to_frags(_accumulator(p), bf16=True),
                                                 bf16=True), p)


def test_tf32_rounding_matches_cvt_rna():
    """Ties round away from zero; the low 13 bits of the result are 0."""
    one = 1.0 + 2.0 ** -11  # exactly half a TF32 step above 1
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    out = _tf32(x)
    assert out.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    assert torch.all(out.view(torch.int32) & 0x1FFF == 0)


# ---------------------------------------------------------------------- #
# row_linear: the models' dense product, rows independent of the row count
# ---------------------------------------------------------------------- #
ROW_COUNTS = (1, 2, 15, 16, 17, 32, 33, 1000)


def _row_linear_inputs(k, n, seed=0):
    rng = np.random.default_rng(seed + k)
    a = rng.normal(size=(1000, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * np.sqrt(2.0 / (k + n))).astype(np.float32)  # glorot
    return a, w


@pytest.mark.parametrize("k,n", [(128, 128), (256, 128)])
def test_row_linear_rows_do_not_depend_on_the_row_count(k, n):
    """Row i of ``A[:m] @ W`` is bitwise row i of ``A @ W`` for every m (the
    CPU's own matmul fails this at m = 1)."""
    a, w = (torch.from_numpy(v) for v in _row_linear_inputs(k, n))
    full = row_linear(a, w)
    for m in ROW_COUNTS:
        assert torch.equal(row_linear(a[:m], w), full[:m]), m


@pytest.mark.parametrize("k,n", [(128, 128), (256, 128), (8, 8)])
def test_row_linear_matches_reference_product(k, n):
    """Within 1e-5 of the reference's ``jnp`` product on the same inputs
    (fp32, another summation order)."""
    a, w = _row_linear_inputs(k, n)
    out = row_linear(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, np.asarray(jnp.asarray(a) @ jnp.asarray(w)), **TOL)
    assert torch.equal(row_linear_plain(torch.from_numpy(a), torch.from_numpy(w)),
                       torch.from_numpy(out))
    with pytest.raises(ValueError, match="K"):
        row_linear(torch.from_numpy(a), torch.from_numpy(w[:-1]))


GENERAL, TILED = ENTRIES


@pytest.mark.parametrize("m,k,n,aligned,entry", [
    (1_000_000, 128, 128, True, TILED),  # the update in full_forward at n = 1M
    (9_995_744, 128, 128, True, TILED),  # gat's per-edge product at E of the 1M graph
    (TILED_MIN_ROWS, 256, 128, True, TILED),
    (TILED_MIN_ROWS - 1, 128, 128, True, GENERAL),  # fewer tiles than an H100's SMs
    (12, 128, 128, True, GENERAL),  # a fused window of the ring cell
    (1_000_000, 16, 128, True, TILED),
    (1_000_000, 144, 128, True, TILED),  # a K tail of 16
    (1_000_000, 272, 128, True, GENERAL),  # W past 128 KB of shared memory
    (1_000_000, 129, 128, True, GENERAL),  # K not a multiple of 16
    (1_000_000, 8, 128, True, GENERAL),
    (1_000_000, 128, 130, True, GENERAL),  # N is the tiled kernel's whole tile
    (1_000_000, 128, 64, True, GENERAL),
    (1_000_000, 128, 128, False, GENERAL),  # a view not 16-byte aligned
    (1_000_000, 0, 128, True, GENERAL),
])
def test_row_linear_dispatch_is_a_function_of_the_shape(m, k, n, aligned, entry):
    """Which kernel ``row_linear`` launches on a card, from (M, K, N) and the
    pointers' alignment alone; both run the same chain, so this moves time,
    never bits (``tests/test_torch_gpu.py`` holds the two bitwise)."""
    assert kernel_entry(m, k, n, aligned) == entry


def test_row_linear_rejects_an_unknown_entry():
    a, w = (torch.from_numpy(v) for v in _row_linear_inputs(128, 128))
    with pytest.raises(ValueError, match="entry"):
        row_linear(a, w, entry="cublas")
