"""Parameter bridge: the reference's per-layer weights → the port's tensors.

The JAX package initialises weights with ``jax.random``, which the port
does not reproduce.  To compare the two on the same model, a caller exports
the reference's ``init_layers`` result as lists of dicts of numpy arrays
(``jax.tree.map(np.asarray, layers)``) and hands them to
:func:`params_from_numpy`.  The port's models use the same keys and shapes
(``repro_torch.core.models``), so the dictionaries carry over unchanged.
"""
from __future__ import annotations

from typing import List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.operators import GNNModel, Params


def params_from_numpy(
    model: GNNModel,
    layers: Sequence[Mapping[str, np.ndarray]],
    device="cuda",
) -> List[Params]:
    """Per-layer numpy dicts → per-layer dicts of float32 tensors on ``device``.

    Raises ``KeyError`` when a layer's keys differ from those of the port's
    own ``model.init_params``."""
    probe = model.init_params(torch.Generator().manual_seed(0), 4, 4)
    out: List[Params] = []
    for l, layer in enumerate(layers):
        if set(layer) != set(probe):
            raise KeyError(
                f"layer {l}: keys {sorted(layer)} != {model.name} keys {sorted(probe)}")
        out.append({
            k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in layer.items()
        })
    return out
