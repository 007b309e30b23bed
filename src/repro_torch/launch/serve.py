"""Serving entry point: batched prefill + greedy decode loop for a dense or MoE LM.

    python -m repro_torch.launch.serve --arch llama3.2-1b        # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
        --reduced --device cpu

Weights are random, from a seeded ``torch.Generator``; prompt tokens from
``numpy.random.default_rng(0)``.  Only ``--reduced`` cuts the config.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, ArchConfig, get_arch, reduced_config
from repro_torch.device import resolve_device, set_fp32_precision
from repro_torch.models import decode_step, init_model, prefill


class ServeResult(NamedTuple):
    tokens: torch.Tensor  # [B, gen + 1]: the prefill's greedy token, then one per step
    prefill_s: float  # host seconds, synchronised, of the prefill
    decode_s: float  # host seconds, synchronised, of the ``gen`` decode steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ArchConfig, params, tokens, gen: int) -> ServeResult:
    """Prefill ``tokens`` [B, S] into a bf16 cache of ``S + gen`` positions,
    then ``gen`` greedy decode steps.  Runs where ``params`` lie; the loop
    keeps the tokens on that device (argmax there, no read-back per step)."""
    set_fp32_precision()
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, {"tokens": tokens}, s_max=tokens.shape[1] + gen)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    _sync(dev)
    return ServeResult(torch.cat(out, dim=1), prefill_s, time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dev = resolve_device(args.device)
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    res = serve(cfg, params, tokens, args.gen)
    print(f"arch={cfg.name} device={dev} prefill={res.prefill_s * 1e3:.1f}ms "
          f"decode={res.decode_s / max(args.gen, 1) * 1e3:.2f}ms/tok "
          f"throughput={args.batch * args.gen / res.decode_s:.1f}tok/s")
    print("sample:", res.tokens[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()
