"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers are compiled, so a build takes seconds.  Libraries go to
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing is built when a module is imported: the first
launch (or :func:`build_all`) builds.  A missing ``nvcc``, a failed build
or a failed launch raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes argument types for the C entry points: ``PTR`` for every pointer and
# the stream (a bare Python int would be cut to 32 bits), ``I64``/``I32`` for
# sizes and flags, ``F32`` for a scale.  Every entry point returns a
# ``cudaError_t`` as ``int``.
PTR, I64, I32, F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float

#: int fn(const void* msg, const void* row_ptr, const void* order, void* out,
#:        long long num_rows, long long d, long long num_records, void* scratch, void* stream)
ROW_SUM_ARGTYPES = (PTR, PTR, PTR, PTR, I64, I64, I64, PTR, PTR)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for one source unless its library exists already."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path = out, tmp
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)
    return log


def build_all(names: Iterable[str]) -> Dict[str, dict]:
    """Build the named kernels, one ``nvcc`` each, all started together.

    Returns ``{name: {"seconds": wall seconds until that build finished,
    "log": nvcc's output (register and spill report)}}``."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names}
    out = {}
    for n, p in procs.items():
        log = _finish(n, p)
        out[n] = {"seconds": time.perf_counter() - t0, "log": log}
    return out


class CudaKernel:
    """One kernel library: built and loaded at first use, with a launch count.

    ``launches`` is a plain integer that the module's wrapper raises by one
    each time it launches the kernel, and nowhere else; ``entry_launches``
    splits it by C entry point (a library with several kernels)."""

    def __init__(self, name: str, symbols: Mapping[str, Sequence]):
        """``symbols`` maps each C entry point of ``csrc/<name>.cu`` to its
        ctypes ``argtypes``."""
        self.name = name
        self.symbols = {sym: tuple(argtypes) for sym, argtypes in symbols.items()}
        self.launches = 0
        self.entry_launches = dict.fromkeys(self.symbols, 0)
        self._lib = None

    def _load(self):
        if self._lib is None:
            _finish(self.name, _start(self.name))
            lib = ctypes.CDLL(str(_lib_path(self.name)))
            for sym, argtypes in self.symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_torch_error_string.argtypes = [ctypes.c_int]
            lib.repro_torch_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, symbol: str, *args) -> None:
        """Call one C entry point; raise if the launch was refused."""
        lib = self._load()
        rc = getattr(lib, symbol)(*args)
        if rc != 0:
            msg = lib.repro_torch_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error {rc}: {msg}")
        self.launches += 1
        self.entry_launches[symbol] += 1

    def reset_counts(self) -> None:
        self.launches = 0
        self.entry_launches = dict.fromkeys(self.symbols, 0)
