"""Training entry point: the dense LM on synthetic data with AdamW + WSD.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 4 \\
        --batch 4 --seq-len 2048                          # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 20

Weights are random, from a seeded ``torch.Generator``.  Only ``--reduced``
cuts the config.  fp32 matmuls run in full fp32 (TF32 off).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_NAMES, get_arch, reduced_config
from repro_torch.device import set_fp32_precision
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", help="the CPU-scale reduced config")
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--compression", choices=["int8", "topk"], default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    set_fp32_precision()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    tcfg = TrainConfig(steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                       checkpoint_dir=args.checkpoint_dir, compression=args.compression,
                       microbatches=args.microbatches)
    t = Trainer(cfg, tcfg, OptConfig(peak_lr=3e-3, warmup_steps=10, stable_steps=args.steps,
                                     decay_steps=10), device=args.device)
    out = t.train()
    print(f"arch={cfg.name} device={t.device}", out)
    return out


if __name__ == "__main__":
    main()
