"""Checkpoints: full train state, params npz, and the best/latest manager (mirror of ``train/checkpoints.py``).

The full train state (params, optimizer state, step, EMA) goes through
``torch.save`` into ``<dir>/state.pt``, where the JAX package writes an
orbax directory; the layout around it is the same: ``<root>/latest``,
``<root>/best`` and ``<root>/index.json`` with the same keys.  The npz (one
array per leaf under its slash-joined path, ``body53_0/conv_a1/kernel``) is
the format that crosses between the two packages; the committed demo
checkpoints store fp16, and ``models.weights.params_from_numpy`` restores
float32.  Orbax directories are not read: orbax imports JAX.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

__all__ = [
    "CheckpointManager",
    "STATE_FILE",
    "export_params_npz",
    "load_params_npz",
    "restore_params",
    "save_params",
]

#: the file of a full-state checkpoint directory
STATE_FILE = "state.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_params(path: str, tree: Any) -> None:
    """Persist a tree of dicts, tensors and numbers (a train state's
    ``state_dict()``) into the directory ``path``, replacing what was there;
    tensors are copied to the CPU first."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def restore_params(path: str) -> Any:
    """The tree :func:`save_params` wrote into ``path``, on the CPU."""
    f = os.path.join(path, STATE_FILE)
    if not os.path.isfile(f):
        raise NotImplementedError(
            f"{path!r} holds no {STATE_FILE}: an orbax checkpoint directory takes JAX (orbax) to read, and "
            f"image_enhance_keras_tpu_torch imports no JAX (export an npz from the JAX package instead)"
        )
    return torch.load(f, map_location="cpu", weights_only=True)


def export_params_npz(path: str, params: Any, dtype: Any = None) -> None:
    """Distribution format: one .npz of named param arrays (no optimizer
    state), a leaf per slash-joined path of the nested dict ``params``
    (tensors or arrays).  ``dtype`` (e.g. np.float16) casts the stored
    arrays, as the committed demo checkpoints are stored; loading restores
    float32."""
    flat = {}

    def walk(node, prefix):
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            a = node.detach().cpu().numpy() if isinstance(node, torch.Tensor) else np.asarray(node)
            flat[prefix] = a.astype(dtype) if dtype is not None else a

    walk(params, "")
    np.savez_compressed(path, **flat)


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


class CheckpointManager:
    """Best and latest checkpoints with an index file.

    Directory layout:
      <root>/latest/state.pt  the most recent full train state
      <root>/best/state.pt    the full train state of the best val metric
      <root>/index.json       step/epoch/metric bookkeeping
    """

    def __init__(self, root: str, monitor: str = "val_psnr", mode: str = "max"):
        self.root = root
        self.monitor = monitor
        self.mode = mode
        os.makedirs(root, exist_ok=True)
        self._index_path = os.path.join(root, "index.json")
        self.index = {"best_metric": None, "best_epoch": None, "epochs": []}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self.index = json.load(f)

    def _better(self, a: float, b: float | None) -> bool:
        if b is None:
            return True
        return a > b if self.mode == "max" else a < b

    def save_epoch(self, state: Any, epoch: int, metrics: dict[str, float]) -> bool:
        """Save ``latest``; promote to ``best`` when the monitored metric
        improves.  ``state`` is a tree for :func:`save_params` (a train
        state's ``state_dict()``).  True when this epoch became the new best."""
        val = float(metrics.get(self.monitor, float("nan")))
        save_params(os.path.join(self.root, "latest"), state)
        self.index["epochs"].append({"epoch": epoch, **metrics})
        # NaN is never "best": it would export NaN weights as best_ema.npz
        is_best = val == val and self._better(val, self.index.get("best_metric"))
        if is_best:
            save_params(os.path.join(self.root, "best"), state)
            self.index["best_metric"] = val
            self.index["best_epoch"] = epoch
        with open(self._index_path, "w") as f:
            json.dump(self.index, f, indent=2)
        return is_best

    def restore_latest(self) -> Any | None:
        p = os.path.join(self.root, "latest")
        return restore_params(p) if os.path.exists(p) else None

    def restore_best(self) -> Any | None:
        p = os.path.join(self.root, "best")
        return restore_params(p) if os.path.exists(p) else None
