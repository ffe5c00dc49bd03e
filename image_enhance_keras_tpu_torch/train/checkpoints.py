"""Params npz loading (mirror of ``train/checkpoints.load_params_npz``).

The npz holds one array per flax leaf under its slash-joined path
(``body53_0/conv_a1/kernel``).  The committed demo checkpoints store fp16;
``models.weights.params_from_numpy`` restores float32.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def load_params_npz(path: str) -> dict[str, Any]:
    """Nested dict of numpy arrays rebuilt from the slash-joined names."""
    out: dict[str, Any] = {}
    with np.load(path) as data:
        for name in data.files:
            node = out
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[name]
    return out
