"""Dense sliding-window patches and overlap-averaged reconstruction (mirror
of ``tiling/dense.py``), for ``SuperResolver.upscale_patch_average``.

Extraction is two separable gathers on a stride-``step`` grid; the
reconstruction adds every patch into a float32 canvas (``index_add_``) and
divides by a precomputed hit count.  Index plans are built in numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["dense_patch_grid", "extract_dense_patches", "reconstruct_average"]


def dense_patch_grid(h: int, w: int, patch: int, step: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Top-left corners of a stride-``step`` grid (rows outer, columns inner,
    sklearn's order), every position where the patch fits."""
    return np.arange(0, h - patch + 1, step), np.arange(0, w - patch + 1, step)


def extract_dense_patches(img: torch.Tensor, patch: int, step: int = 1) -> torch.Tensor:
    """(H, W, C) -> (N, patch, patch, C) in sklearn ``extract_patches_2d`` order."""
    h, w, c = img.shape
    ys, xs = dense_patch_grid(h, w, patch, step)
    rows = torch.from_numpy((ys[:, None] + np.arange(patch)[None, :]).reshape(-1)).to(img.device)
    cols = torch.from_numpy((xs[:, None] + np.arange(patch)[None, :]).reshape(-1)).to(img.device)
    g = img.index_select(0, rows).index_select(1, cols)
    g = g.reshape(len(ys), patch, len(xs), patch, c)
    return g.permute(0, 2, 1, 3, 4).reshape(len(ys) * len(xs), patch, patch, c)


@functools.lru_cache(maxsize=None)
def _scatter_plan(h: int, w: int, patch: int, step: int, pad: int):
    """Flat output index of every (patch, pixel), its 0/1 weight, and the hit
    counts.  An interior patch adds only its central (patch - 2*pad)^2
    window; a patch at the first or last grid position of either axis adds
    all of it (the reference's edge exemption, the last *stride* position
    counting as last, as in the JAX package)."""
    ys, xs = dense_patch_grid(h, w, patch, step)
    n = len(ys) * len(xs)
    idx = np.zeros((n, patch, patch), np.int64)
    mask = np.zeros((n, patch, patch), np.float32)
    k = 0
    for y in ys:
        for x in xs:
            trim = 0 if (y == 0 or x == 0 or y == ys[-1] or x == xs[-1]) else pad
            idx[k] = (y + np.arange(patch))[:, None] * w + (x + np.arange(patch))[None, :]
            mask[k, trim : patch - trim, trim : patch - trim] = 1.0
            k += 1
    counts = np.zeros((h * w,), np.float32)
    np.add.at(counts, idx.reshape(-1), mask.reshape(-1))
    return idx.reshape(-1), mask.reshape(-1, 1), np.maximum(counts, 1.0)


def reconstruct_average(patches: torch.Tensor, out_hw: tuple[int, int], step: int = 1,
                        pad: int = 0) -> torch.Tensor:
    """(N, p, p, C) -> (H, W, C) overlap-averaged reconstruction, summed in
    float32; returns the patches' float dtype (float32 for integer patches).

    pad=0 is sklearn ``reconstruct_from_patches_2d``; pad=4 on a stride grid
    the reference's ``reconstruct_from_patches_2dlocal``."""
    h, w = out_hw
    _, p, _, c = patches.shape
    idx, mask, counts = (torch.from_numpy(a).to(patches.device) for a in _scatter_plan(h, w, p, step, pad))
    vals = patches.reshape(-1, c).to(torch.float32) * mask
    acc = torch.zeros((h * w, c), dtype=torch.float32, device=patches.device).index_add_(0, idx, vals)
    out = (acc / counts[:, None]).reshape(h, w, c)
    return out.to(patches.dtype) if patches.dtype.is_floating_point else out
