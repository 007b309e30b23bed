"""Atomic, async checkpointing with restore onto any device: the counterpart
of ``repro.train.checkpoint``, with the reference's on-disk layout.

* **atomic** — writes land in ``step_K.tmp/`` and are renamed to ``step_K/``
  only when complete, so a killed writer never corrupts the latest state;
* **async** — ``save(..., blocking=False)`` hands the host copy to a writer
  thread (at most one write in flight);
* **restore onto a device** — ``restore(..., device=...)`` puts every leaf on
  the given device (the reference's ``shardings`` re-placement);
* keep-last-K garbage collection.

Leaves are stored as one ``.npy`` per leaf plus ``manifest.json``, keyed by
the reference's ``jax.tree_util.keystr`` path strings
(``['params']['blocks']['attn']['wq']``, ``['opt'].m[...]``, ``['opt'].count``):
a training state that ``repro.train``'s manager wrote restores into the
port's trainer, and the other way round.  bf16 leaves are stored as fp32
(numpy has no bf16) and cast back to the template's dtype on restore."""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.tree import tree_paths, tree_unflatten


def _host(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        # snapshot to host memory synchronously (the copy from the card is
        # the cheap part); write on a thread when not blocking
        flat = {k: _host(v) for k, v in tree_paths(tree)}
        self.wait()  # at most one async write in flight
        if blocking:
            self._write(step, flat)
        else:
            self._thread = threading.Thread(target=self._write, args=(step, flat))
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat) -> None:
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {}
        for i, (k, v) in enumerate(flat.items()):
            fname = f"leaf_{i}.npy"
            np.save(tmp / fname, v)
            manifest[k] = fname
        (tmp / "manifest.json").write_text(json.dumps({"step": step, "leaves": manifest}))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------------ #
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None, device=None):
        """Load into ``template``'s structure and dtypes; each leaf goes to
        ``device`` if given, else to the template leaf's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())["leaves"]
        leaves = []
        for key, tleaf in tree_paths(template):
            arr = torch.from_numpy(np.load(d / manifest[key]))
            leaves.append(arr.to(device=device if device is not None else tleaf.device,
                                 dtype=tleaf.dtype))
        return tree_unflatten(template, iter(leaves)), step
