"""Structured synthetic photographs, numpy only: the benchmark's image content.

A frozen copy of the port's procedural generators
(``image_enhance_keras_tpu_torch/data/pipeline.py``: ``synthetic_images``,
``pink_noise_images``, ``dead_leaves_images`` without a palette, and the mix
of ``rich_synthetic_images``), kept here so that a change to the program
cannot change the benchmark's inputs.  Deterministic per (n, size, seed).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_images", "pink_noise_images", "dead_leaves_images", "rich_images", "crop_center"]


def synthetic_images(n: int, size: int, seed: int) -> list[np.ndarray]:
    """Sinusoid and stripe textures with noise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        img = np.stack(
            [
                127 + 80 * np.sin(2 * np.pi * (rng.uniform(1, 4) * xx + rng.uniform())),
                127 + 80 * np.cos(2 * np.pi * (rng.uniform(1, 4) * yy + rng.uniform())),
                255 * ((xx * rng.uniform(2, 8)).astype(int) % 2 == 0),
            ],
            axis=-1,
        )
        img += rng.normal(0, 8, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def pink_noise_images(n: int, size: int, seed: int) -> list[np.ndarray]:
    """1/f^alpha random fields with channel-correlated colour."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.rfftfreq(size)[None, :]
    rad = np.sqrt(fy * fy + fx * fx)
    rad[0, 0] = 1.0
    out = []
    for _ in range(n):
        amp = rad ** (-rng.uniform(0.8, 1.5))
        fields = []
        for _c in range(3):
            f = np.fft.irfft2(np.fft.rfft2(rng.standard_normal((size, size))) * amp, s=(size, size))
            fields.append((f - f.mean()) / (f.std() + 1e-8))
        fields = np.stack(fields, axis=-1)
        w = rng.uniform(0.6, 0.95)
        img = 127.0 + rng.uniform(30, 55) * (w * fields[..., :1] + (1.0 - w) * fields)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _blur121(img: np.ndarray) -> np.ndarray:
    k = np.array([0.25, 0.5, 0.25], np.float32)
    img = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), 0, img)
    return np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), 1, img)


def dead_leaves_images(n: int, size: int, seed: int, textured: bool = True) -> list[np.ndarray]:
    """Occluding disks with r^-3 radii painted back to front, shaded by a
    random ramp when ``textured``; about half get a 0.5 px blur."""
    rng = np.random.default_rng(seed)
    rmin, rmax = 4.0, size / 2.0
    a2, b2 = rmin**-2, rmax**-2
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = []
    for _ in range(n):
        img = np.empty((size, size, 3), np.float32)
        img[:] = rng.uniform(0, 255, 3)
        covered = np.zeros((size, size), bool)
        for d in range(600):
            r = float((a2 - rng.random() * (a2 - b2)) ** -0.5)
            cy, cx = rng.uniform(-r, size + r), rng.uniform(-r, size + r)
            y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, size)
            x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, size)
            if y0 >= y1 or x0 >= x1:
                continue
            m = (yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2 <= r * r
            if not m.any():
                continue
            col = rng.uniform(0, 255, 3).astype(np.float32)
            patch = np.broadcast_to(col, (y1 - y0, x1 - x0, 3)).copy()
            if textured:
                gy, gx = rng.uniform(-1, 1, 2)
                ramp = (gy * (yy[y0:y1, x0:x1] - cy) + gx * (xx[y0:y1, x0:x1] - cx)) / max(r, 1.0)
                patch = patch + rng.uniform(5, 30) * ramp[..., None]
            img[y0:y1, x0:x1][m] = patch[m]
            covered[y0:y1, x0:x1] |= m
            if d % 50 == 49 and covered.all():
                break
        if rng.random() < 0.5:
            img = _blur121(img)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def rich_images(n: int, size: int, seed: int) -> list[np.ndarray]:
    """The rich procedural mix: 1/2 textured dead leaves, 1/4 pink noise,
    1/8 sharp dead leaves, the rest sinusoid and stripe textures."""
    n_dl, n_pink, n_sharp = n // 2, n // 4, n // 8
    return (dead_leaves_images(n_dl, size, seed, textured=True)
            + pink_noise_images(n_pink, size, seed + 1)
            + dead_leaves_images(n_sharp, size, seed + 2, textured=False)
            + synthetic_images(n - n_dl - n_pink - n_sharp, size, seed + 3))


def crop_center(img: np.ndarray, h: int, w: int) -> np.ndarray:
    y0, x0 = (img.shape[0] - h) // 2, (img.shape[1] - w) // 2
    return np.ascontiguousarray(img[y0 : y0 + h, x0 : x0 + w])
