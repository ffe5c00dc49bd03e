"""Disk-backed batch generator over materialised ``X/`` / ``y/`` patch dirs (mirror of ``data/generator.py``).

Yields float32 [0,1] (batch_x, batch_y) pairs over shuffled epochs with an
optional seed, as the reference's ``image_generator`` does, over the
directories that ``cli/prepare_data.py`` writes.  The trainer samples
patches on the fly instead (``data/pipeline.py``).
"""

from __future__ import annotations

import os

import numpy as np

from image_enhance_keras_tpu_torch.data.io import imread

__all__ = ["image_count", "paired_patch_generator"]


def image_count(dir_path: str) -> int:
    """Number of patch files in ``<dir>/X`` (the reference's steps per epoch)."""
    x_dir = os.path.join(dir_path, "X")
    return len([f for f in os.listdir(x_dir) if f.endswith(".png")])


def paired_patch_generator(dir_path: str, batch_size: int = 10, shuffle: bool = True, seed: int | None = None):
    """Infinite generator of ((B,h,w,3), (B,H,W,3)) float32 [0,1] batches."""
    x_dir = os.path.join(dir_path, "X")
    y_dir = os.path.join(dir_path, "y")
    names = sorted(f for f in os.listdir(x_dir) if f.endswith(".png"))
    if not names:
        raise ValueError(f"no patches in {x_dir}")
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(names)) if shuffle else np.arange(len(names))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            bx = np.stack([imread(os.path.join(x_dir, names[i])) for i in idx])
            by = np.stack([imread(os.path.join(y_dir, names[i])) for i in idx])
            yield bx.astype(np.float32) / 255.0, by.astype(np.float32) / 255.0
