"""Time variants of the bf16 attention kernels on one card: copies of
``csrc/flash_attention.cu`` (``fwd``) or ``csrc/flash_attention_bwd.cu``
(``bwd``) with text replaced, each built with the package's ``nvcc`` flags
into ``build/variants/`` and called through ctypes beside the unchanged
source, in turns.  An ablation (an instruction taken out) gives wrong outputs
and shows what a part of the kernel costs.

    PYTHONPATH=src python scripts/flash_variants.py fwd NAME='OLD>>>NEW' ...

Each ``NAME='OLD>>>NEW'`` replaces the text OLD (which must occur in the
source; ``\\n`` for a newline; several replacements joined by ``&&&``) with
NEW.  The forward is timed at llama3.2-1b's prefill (B 8, Hq 32, Hkv 8, S
2048, dh 64) and train_4k (B 2, S 4,096) shapes and qwen3-moe-30b-a3b's
prefill (B 8, Hq 32, Hkv 4, S 2048, dh 128); the backward's two entries at
the training shapes (B 4, S 2048 and B 2, S 4,096 at dh 64; B 2, S 4,096,
Hkv 4 at dh 128), all causal: the mean ms of 20 launches (10 for an entry of
the backward), CUDA events, two turns of every variant.

Prints one JSON line: the card and its power limit, each variant's ptxas
spill lines, and per shape each variant's ms in each turn and its largest
difference from the unchanged source's output.
"""
import ctypes
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402

FWD_SHAPES = [(8, 32, 8, 2048, 64), (2, 32, 8, 4096, 64), (8, 32, 4, 2048, 128)]
BWD_SHAPES = [(4, 32, 8, 2048, 64), (2, 32, 8, 4096, 64), (2, 32, 4, 4096, 128)]


def _variants(which: str, specs) -> dict:
    """Build ``as_is`` and each spec's variant, all at once; name → loaded library."""
    src_name = "flash_attention" if which == "fwd" else "flash_attention_bwd"
    src = (_build.CSRC / f"{src_name}.cu").read_text()
    variants = {"as_is": []}
    for spec in specs:
        name, rest = spec.split("=", 1)
        variants[name] = [tuple(part.replace("\\n", "\n") for part in pair.split(">>>"))
                          for pair in rest.split("&&&")]
    out_dir = _build.BUILD_DIR.parent / "variants"
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, patches in variants.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in {src_name}.cu")
            text = text.replace(old, new)
        path = out_dir / f"{which}_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"lib{which}_{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, spills = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-3000:]}")
        spills[name] = [ln.strip() for ln in log.splitlines()
                        if "spill" in ln and " 0 bytes spill stores" not in ln]
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{which}_{name}.so"))
    return libs, spills


def _ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _fwd_call(lib, q, k, v, o):
    fn = lib.flash_attention_bf16
    fn.argtypes, fn.restype = list(fmod.ARGTYPES), ctypes.c_int
    b, hq, s, dh = q.shape

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, b, hq,
                k.shape[1], s, s, dh, 1.0 / math.sqrt(dh), 1, 0, 0,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
    return call


def _bwd_calls(lib, q, k, v, o, lse, do, outs):
    dq, dk, dv, delta = outs
    b, hq, s, dh = q.shape
    sizes = (b, hq, k.shape[1], s, s, dh, 1.0 / math.sqrt(dh), 1, 0, 0)
    fq, fk = lib.flash_attention_bwd_dq_bf16, lib.flash_attention_bwd_dkdv_bf16
    for fn in (fq, fk):
        fn.argtypes, fn.restype = list(fmod.BWD_ARGTYPES), ctypes.c_int

    def dq_call():
        fq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
           dq.data_ptr(), delta.data_ptr(), *sizes, torch.cuda.current_stream().cuda_stream)

    def dkdv_call():
        fk(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
           delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *sizes,
           torch.cuda.current_stream().cuda_stream)
    return dq_call, dkdv_call


def main(argv) -> None:
    which, specs = argv[0], argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    libs, spills = _variants(which, specs)
    out = {}
    for i, (b, hq, hkv, s, dh) in enumerate(FWD_SHAPES if which == "fwd" else BWD_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(i)
        q, k, v, do = [torch.randn(b, h, s, dh, device="cuda", generator=g).to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq)]
        o, lse = fmod.flash_attention_lse(q, k, v)
        row, ref = {}, None
        for _ in range(2):
            for name, lib in libs.items():
                if which == "fwd":
                    res = [torch.empty_like(q)]
                    t = _ms(_fwd_call(lib, q, k, v, res[0]), 20)
                else:
                    res = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
                           torch.empty(b, hq, s, device="cuda")]
                    calls = _bwd_calls(lib, q, k, v, o, lse, do, res)
                    t = [_ms(c, 10) for c in calls]
                ref = res if name == "as_is" else ref
                err = max(float((x.float() - r.float()).abs().max()) for x, r in zip(res, ref))
                row.setdefault(name, {"ms": [], "max_abs_diff_from_as_is": err})["ms"].append(t)
        out[f"B{b}_Hq{hq}_Hkv{hkv}_S{s}_dh{dh}"] = row
    print(json.dumps({"card": card, "which": which, "spills": spills, "shapes": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
