"""Time the serving path's fp32 ``flash_attention`` forward (no lse) of the
checkout whose root is the current directory, at the llama3.2-1b prefill
shape (B 8, Hq 32, Hkv 8, S 2048, dh 64, causal), and hash its output.

Compare two checkouts on one card, one after the other in turns (parent,
change, change, parent), each from its own root:

    (cd <checkout> && python <this repo>/scripts/flash_forward_ab.py)

Prints one JSON line: the checkout's directory name, the mean ms of 50
launches in each of 5 repetitions (CUDA events; the first repetition
warms up), and the first 16 hex digits of the output's SHA-256.
"""
import hashlib
import json
import os
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402


def main() -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(8, 32, 2048, 64, device="cuda", generator=g)
    k = torch.randn(8, 8, 2048, 64, device="cuda", generator=g)
    v = torch.randn(8, 8, 2048, 64, device="cuda", generator=g)
    out = flash_attention(q, k, v)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(50):
            flash_attention(q, k, v)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 50)
    print(json.dumps({"tree": os.path.basename(os.getcwd()), "ms": times,
                      "sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]}))


if __name__ == "__main__":
    main()
