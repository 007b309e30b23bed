"""Time the serving path's fp32 ``flash_attention`` forward (no lse) of the
checkout whose root is the current directory, at the llama3.2-1b prefill
shape (B 8, Hq 32, Hkv 8, S 2048, dh 64, causal), and hash its output; time
the bf16 instantiations of the production dtype's path (bf16 params), each
beside ``scaled_dot_product_attention`` (forward, or its backward, on the same
inputs): at dh 64 the llama3.2-1b prefill (B 8, S 2048) and train_4k (B 2, S
4,096) forwards and the training backwards (B 4, S 2048, and B 2, S 4,096); at
dh 128 qwen3-moe-30b-a3b's prefill forward (B 8, Hq 32, Hkv 4, S 2048) and its
training backward (B 2, S 4,096); at dh 160 pixtral-12b's vlm prefill forward
(B 8, Hq 32, Hkv 8, S 2,304) and training backward (B 2, S 2,304); all causal,
each backward both entries a call.  Then hash the forward's outputs at every
head dim and dtype the checkout's wrapper takes, on a fixed set of shapes (o
without ``lse``, o with it, and ``lse``), and the backward's dq, dk and dv
from that o and lse.

Compare two checkouts on one card, one after the other in turns (parent,
change, change, parent), each from its own root:

    (cd <checkout> && python <this repo>/scripts/flash_forward_ab.py)

A change that must leave some instantiations bit for bit as they were is
checked by comparing the two checkouts' ``hashes`` at those head dims.

Prints one JSON line: the checkout's directory name, the card and its power
limit, the mean ms of 50 launches in each of 5 repetitions (CUDA events; the
first repetition warms up), the first 16 hex digits of the timed output's
SHA-256, the same repetitions for each bf16 shape (``bf16``: 20 launches a
repetition for a forward, 10 for a backward; SDPA's under ``sdpa``), and for
each ``dh/dtype/SqxSk`` those of the six outputs' SHA-256 (``hashes``: o, o
with lse, lse, dq, dk, dv).
"""
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.kernels import flash_attention as fmod  # noqa: E402

#: (B, Hq, Hkv, Sq, Sk, causal, window, q_offset): GQA and MHA, ragged ends, a
#: window, a non-causal Sq ≠ Sk, a prefill's shape and a few rows at a cache's end
SHAPES = [(2, 8, 2, 333, 333, True, None, 0), (1, 4, 4, 200, 150, False, None, 0),
          (2, 4, 1, 257, 257, True, 48, 0), (1, 32, 8, 2048, 2048, True, None, 0),
          (2, 4, 2, 5, 300, True, None, 295)]


def _hash(t: torch.Tensor) -> str:
    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def _reps(fn, iters: int) -> list:
    """Mean ms of ``iters`` launches of ``fn``, in each of 5 repetitions."""
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def _inputs(b, hq, hkv, sq, sk, dh, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, h, s, dh, device="cuda", generator=g).to(dt)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk), (hq, sq))]  # q, k, v, dO


def _time() -> dict:
    q, k, v, _ = _inputs(8, 32, 8, 2048, 2048, 64, torch.float32, 0)
    out = fmod.flash_attention(q, k, v)
    return {"ms": _reps(lambda: fmod.flash_attention(q, k, v), 50), "sha256": _hash(out)}


#: the bf16 shapes: name → (B, Hq, Hkv, S, dh, backward?)
BF16_SHAPES = {
    "fwd_dh64_B8_S2048": (8, 32, 8, 2048, 64, False),  # llama3.2-1b prefill
    "fwd_dh64_B2_S4096": (2, 32, 8, 4096, 64, False),  # llama3.2-1b train_4k
    "fwd_dh128_B8_S2048": (8, 32, 4, 2048, 128, False),  # qwen3-moe-30b-a3b prefill
    "fwd_dh160_B8_S2304": (8, 32, 8, 2304, 160, False),  # pixtral-12b vlm prefill
    "bwd_dh64_B4_S2048": (4, 32, 8, 2048, 64, True),  # llama3.2-1b training
    "bwd_dh64_B2_S4096": (2, 32, 8, 4096, 64, True),  # llama3.2-1b train_4k
    "bwd_dh128_B2_S4096": (2, 32, 4, 4096, 128, True),  # qwen3-moe-30b-a3b train_4k
    "bwd_dh160_B2_S2304": (2, 32, 8, 2304, 160, True),  # pixtral-12b vlm training
}


def _time_bf16() -> dict:
    import torch.nn.functional as F

    out, sdpa = {}, {}
    for i, (name, (b, hq, hkv, s, dh, bwd)) in enumerate(BF16_SHAPES.items()):
        q, k, v, do = _inputs(b, hq, hkv, s, s, dh, torch.bfloat16, i + 1)
        if not bwd:
            out[name] = _reps(lambda: fmod.flash_attention(q, k, v), 20)
            sdpa[name] = _reps(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 20)
            continue
        o, lse = fmod.flash_attention_lse(q, k, v)
        out[name] = _reps(lambda: fmod.flash_attention_bwd(q, k, v, o, lse, do), 10)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
        sdpa[name] = _reps(lambda: torch.autograd.grad(y, leaves, do, retain_graph=True), 10)
        del y, leaves
    return {**out, "sdpa": sdpa}


def _hashes() -> dict:
    out = {}
    for dh in fmod.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            for b, hq, hkv, sq, sk, causal, window, q_offset in SHAPES:
                q, k, v, do = _inputs(b, hq, hkv, sq, sk, dh, dt, sq + dh)
                o = fmod.flash_attention(q, k, v, causal=causal, window=window,
                                         q_offset=q_offset)
                o_lse, lse = fmod.flash_attention_lse(q, k, v, causal, window, q_offset)
                grads = fmod.flash_attention_bwd(q, k, v, o_lse, lse, do, causal, window,
                                                 q_offset)
                key = f"{dh}/{str(dt).removeprefix('torch.')}/{sq}x{sk}"
                out[key] = [_hash(x) for x in (o, o_lse, lse, *grads)]
    return out


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"tree": os.path.basename(os.getcwd()), "card": card, **_time(),
                      "bf16": _time_bf16(), "hashes": _hashes()}))


if __name__ == "__main__":
    main()
