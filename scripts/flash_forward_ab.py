"""Time the serving path's fp32 ``flash_attention`` forward (no lse) of the
checkout whose root is the current directory, at the llama3.2-1b prefill
shape (B 8, Hq 32, Hkv 8, S 2048, dh 64, causal), and hash its output; then
hash the forward's outputs at every head dim and dtype the checkout's wrapper
takes, on a fixed set of shapes: o without ``lse``, o with it, and ``lse``.

Compare two checkouts on one card, one after the other in turns (parent,
change, change, parent), each from its own root:

    (cd <checkout> && python <this repo>/scripts/flash_forward_ab.py)

A change that must leave some instantiations bit for bit as they were is
checked by comparing the two checkouts' ``hashes`` at those head dims.

Prints one JSON line: the checkout's directory name, the card, the mean ms
of 50 launches in each of 5 repetitions (CUDA events; the first repetition
warms up), the first 16 hex digits of the timed output's SHA-256, and for
each ``dh/dtype/SqxSk`` those of the three outputs' SHA-256.
"""
import hashlib
import json
import os
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


def _time() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(8, 32, 2048, 64, device="cuda", generator=g)
    k = torch.randn(8, 8, 2048, 64, device="cuda", generator=g)
    v = torch.randn(8, 8, 2048, 64, device="cuda", generator=g)
    out = fmod.flash_attention(q, k, v)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(50):
            fmod.flash_attention(q, k, v)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 50)
    return {"ms": times, "sha256": _hash(out)}


def _hashes() -> dict:
    out = {}
    for dh in fmod.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            for b, hq, hkv, sq, sk, causal, window, q_offset in SHAPES:
                g = torch.Generator(device="cuda").manual_seed(sq + dh)
                q = torch.randn(b, hq, sq, dh, device="cuda", generator=g).to(dt)
                k = torch.randn(b, hkv, sk, dh, device="cuda", generator=g).to(dt)
                v = torch.randn(b, hkv, sk, dh, device="cuda", generator=g).to(dt)
                o = fmod.flash_attention(q, k, v, causal=causal, window=window,
                                         q_offset=q_offset)
                o_lse, lse = fmod.flash_attention_lse(q, k, v, causal, window, q_offset)
                key = f"{dh}/{str(dt).removeprefix('torch.')}/{sq}x{sk}"
                out[key] = [_hash(o), _hash(o_lse), _hash(lse)]
    return out


def main() -> None:
    print(json.dumps({"tree": os.path.basename(os.getcwd()),
                      "device": torch.cuda.get_device_name(0), **_time(),
                      "hashes": _hashes()}))


if __name__ == "__main__":
    main()
