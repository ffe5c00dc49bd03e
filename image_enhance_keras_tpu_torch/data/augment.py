"""CutBlur-family ("MoA") augmentation for SR training (mirror of ``data/augment.py``).

The mixture-of-augmentations suite of "Rethinking Data Augmentation for
Image Super-Resolution" (Yoo et al., CVPR 2020): per sample, with
probability ``prob``, apply ONE op drawn uniformly from the enabled set.
The ops run on the host, on the uint8 HR batch, before the degradation
(``data/pipeline.degrade_batch_on_device``), which derives the LR input
from the augmented HR, so every op yields consistent (LR, HR) pairs.  Pure
numpy: the same ``np.random.Generator`` state gives the JAX package's bytes.

Op parameters follow the paper's released defaults:
  blend     a ~ U(0.6, 1), solid random color          (their alpha=0.6)
  rgb_perm  random channel permutation of the pair
  mixup     lam ~ Beta(1.2, 1.2), partner from batch    (their alpha=1.2)
  cutmix    cut side ratio ~ N(0.7, 0.01) of the patch  (their alpha=0.7)
  cutmixup  mixup inside a cutmix window
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["MOA_OPS", "moa_augment"]

#: the default op suite (uniform choice per augmented sample)
MOA_OPS: tuple[str, ...] = ("blend", "rgb_perm", "mixup", "cutmix", "cutmixup")


def _cut_window(rng: np.random.Generator, h: int, w: int) -> tuple[slice, slice]:
    """Random cutmix window: side ratio ~ N(0.7, 0.01) clipped to [0.1, 0.9]."""
    ratio = float(np.clip(rng.normal(0.7, 0.01), 0.1, 0.9))
    ch, cw = max(1, int(h * ratio)), max(1, int(w * ratio))
    y = int(rng.integers(0, h - ch + 1))
    x = int(rng.integers(0, w - cw + 1))
    return slice(y, y + ch), slice(x, x + cw)


def moa_augment(
    batch: np.ndarray,
    rng: np.random.Generator,
    prob: float = 1.0,
    ops: Sequence[str] = MOA_OPS,
) -> np.ndarray:
    """Apply the MoA suite to a uint8 HR batch (B, H, W, C) -> uint8 copy.

    Per sample i: with probability ``prob``, one op drawn uniformly from
    ``ops`` is applied; pairwise ops (mixup/cutmix/cutmixup) take their
    partner from a random OTHER batch index, matching the paper's
    within-batch pairing.  Deterministic given ``rng``'s state.
    """
    if prob <= 0.0 or not ops:
        return batch
    bad = set(ops) - set(MOA_OPS)
    if bad:
        raise ValueError(f"unknown MoA ops {sorted(bad)}; valid: {MOA_OPS}")
    b, h, w, _c = batch.shape
    src = batch.astype(np.float32)  # pristine partners (pre-augmentation)
    out = src.copy()
    for i in range(b):
        if rng.random() >= prob:
            continue
        op = ops[int(rng.integers(0, len(ops)))]
        if op == "blend":
            a = float(rng.uniform(0.6, 1.0))
            color = rng.uniform(0.0, 255.0, size=3).astype(np.float32)
            out[i] = a * out[i] + (1.0 - a) * color
        elif op == "rgb_perm":
            out[i] = out[i][..., rng.permutation(3)]
        else:
            j = int(rng.integers(0, b - 1)) if b > 1 else 0
            j = j + 1 if j >= i else j  # partner != self when possible
            if op == "mixup":
                lam = float(rng.beta(1.2, 1.2))
                out[i] = lam * out[i] + (1.0 - lam) * src[j]
            elif op == "cutmix":
                ys, xs = _cut_window(rng, h, w)
                out[i][ys, xs] = src[j][ys, xs]
            elif op == "cutmixup":
                ys, xs = _cut_window(rng, h, w)
                lam = float(rng.beta(1.2, 1.2))
                out[i][ys, xs] = (
                    lam * out[i][ys, xs] + (1.0 - lam) * src[j][ys, xs]
                )
    return np.clip(np.round(out), 0.0, 255.0).astype(np.uint8)
