"""The training data plane and the bundled and procedural images (mirror of ``data/pipeline.py``).

The host slices uint8 HR patches out of decoded images (``PatchSampler``,
numpy: the same seed gives the JAX package's bytes); the degradation (blur
sigma=0.5, then PIL-bicubic /scale with uint8 rounding per pass, then /255)
runs on the device inside the train step (``degrade_batch_on_device``), so
LR/HR pairs are always consistent.  ``builtin_photos`` reads the port's
copies of the real photographs that ship inside installed packages;
``synthetic_images`` and ``rich_synthetic_images`` (dead leaves, pink noise,
fibers) are numpy, deterministic per (n, size, seed).  Int8 calibration
uses them too.
"""

from __future__ import annotations

import numpy as np
import torch

from image_enhance_keras_tpu_torch.data.io import imread, list_images

__all__ = [
    "PatchSampler",
    "builtin_photos",
    "degrade_batch_on_device",
    "load_image_dir",
    "pinned_mass_weights",
    "synthetic_images",
    "pink_noise_images",
    "dead_leaves_images",
    "fiber_images",
    "rich_synthetic_images",
]


#: real photographs that ship inside installed Python packages, which the
#: JAX package's ``builtin_photos`` reads from there.  The port carries
#: their decoded pixels as 8-bit RGB PNGs under ``photos/`` (so calibration
#: does not depend on what a machine has installed), in the same order.
#: Each entry: (file under photos/, source package, resource path, licence).
_BUILTIN_PHOTO_SOURCES: tuple[tuple[str, str, str, str], ...] = (
    # Temple of Heaven — architecture, roof-tile texture, foliage (640x427)
    ("china.png", "sklearn", "datasets/images/china.jpg", "CC BY 2.0, danielbuechele"),
    # flower macro — saturated color, soft gradients, fine stamens (640x427)
    ("flower.png", "sklearn", "datasets/images/flower.jpg", "CC BY 2.0, vultilion"),
    # Grace Hopper portrait — face, skin, hair, glasses, fabric (512x600);
    # the face/hair statistics the procedural corpus cannot synthesise
    ("grace_hopper.png", "matplotlib", "mpl-data/sample_data/grace_hopper.jpg", "public domain"),
    # real photographic material textures bundled as simulator assets
    # (RGB photos, not game art): leather/skin pore texture 1024²
    ("skin.png", "gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/skin.png", "MIT"),
    # bamboo wood grain 1024² — fine directional high-frequency texture
    ("wood1.png", "gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/wood1.png", "MIT"),
    # blue mosaic tile 512² — saturated regular pattern with sharp edges
    ("tile1.png", "gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/tile1.png", "MIT"),
    # grass 512² — chaotic fine natural texture (fur/feather statistics)
    ("grass.png", "dm_control",
     "locomotion/arenas/assets/outdoor_natural/OutdoorGrassFloorD.png", "Apache-2.0"),
)


def load_image_dir(path: str, limit: int | None = None) -> list[np.ndarray]:
    files = list_images(path)
    if limit:
        files = files[:limit]
    return [imread(f) for f in files]


def builtin_photos(min_side: int = 96) -> list[np.ndarray]:
    """The package-bundled real photographs (``_BUILTIN_PHOTO_SOURCES``), as
    RGB uint8 arrays read from the port's own copies.  These are not
    evaluation images (Set5 stays the only eval set).
    """
    import os

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "photos")
    out = [imread(os.path.join(here, name)) for name, *_ in _BUILTIN_PHOTO_SOURCES]
    return [img for img in out if img.ndim == 3 and min(img.shape[:2]) >= min_side]


def synthetic_images(n: int = 8, size: int = 128, seed: int = 0) -> list[np.ndarray]:
    """Structured synthetic HR images (gradients + edges + texture) for smoke
    training when no dataset is mounted."""
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


def pink_noise_images(
    n: int = 8, size: int = 256, seed: int = 0
) -> list[np.ndarray]:
    """1/f^alpha ("pink") random fields with channel-correlated color.

    Natural images have ~1/f amplitude spectra; training a restorer on
    spectra-matched noise teaches broadband texture statistics that the
    sinusoid/stripe corpus (synthetic_images) lacks.
    """
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.rfftfreq(size)[None, :]
    rad = np.sqrt(fy * fy + fx * fx)
    rad[0, 0] = 1.0
    out = []
    for _ in range(n):
        alpha = rng.uniform(0.8, 1.5)
        amp = rad ** (-alpha)
        fields = []
        for _c in range(3):
            phase = rng.standard_normal((size, size))
            f = np.fft.irfft2(np.fft.rfft2(phase) * amp, s=(size, size))
            f = (f - f.mean()) / (f.std() + 1e-8)
            fields.append(f)
        fields = np.stack(fields, axis=-1)
        # luminance-correlated color: mostly-shared field + per-channel part
        w = rng.uniform(0.6, 0.95)
        shared = fields[..., :1]
        img = 127.0 + rng.uniform(30, 55) * (
            w * shared + (1.0 - w) * fields
        )
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def dead_leaves_images(
    n: int = 8,
    size: int = 256,
    seed: int = 0,
    palette_images: list[np.ndarray] | None = None,
    textured: bool = True,
) -> list[np.ndarray]:
    """Dead-leaves occlusion images: disks with a power-law (r^-3) radius
    distribution painted back-to-front — the classic scale-invariant model
    of natural-image edge/occlusion statistics (used for fully-synthetic
    restoration training).  ``palette_images`` supplies realistic colors
    (pixels sampled from those images — pass the TRAIN-side images only in
    held-out protocols); ``textured`` shades each disk with a random linear
    gradient so cells carry low-frequency content, and ~half the images get
    a 0.5 px blur so edges are not all perfectly sharp.
    """
    rng = np.random.default_rng(seed)
    rmin, rmax = 4.0, size / 2.0
    a2, b2 = rmin**-2, rmax**-2
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    pal = None
    if palette_images:
        cols = [
            im.reshape(-1, 3)[rng.integers(0, im.shape[0] * im.shape[1], 4096)]
            for im in palette_images
        ]
        pal = np.concatenate(cols, axis=0).astype(np.float32)
    out = []
    for _ in range(n):
        img = np.empty((size, size, 3), np.float32)
        img[:] = rng.uniform(0, 255, 3)
        covered = np.zeros((size, size), bool)
        for _d in range(600):
            u = rng.random()
            r = float((a2 - u * (a2 - b2)) ** -0.5)
            cy, cx = rng.uniform(-r, size + r), rng.uniform(-r, size + r)
            y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, size)
            x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, size)
            if y0 >= y1 or x0 >= x1:
                continue
            m = (yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2 <= r * r
            if not m.any():
                continue
            if pal is not None:
                col = pal[rng.integers(0, len(pal))]
            else:
                col = rng.uniform(0, 255, 3).astype(np.float32)
            patch = np.broadcast_to(col, (y1 - y0, x1 - x0, 3)).copy()
            if textured:
                gy, gx = rng.uniform(-1, 1, 2)
                ramp = (
                    gy * (yy[y0:y1, x0:x1] - cy) + gx * (xx[y0:y1, x0:x1] - cx)
                ) / max(r, 1.0)
                patch = patch + rng.uniform(5, 30) * ramp[..., None]
            img[y0:y1, x0:x1][m] = patch[m]
            covered[y0:y1, x0:x1] |= m
            if _d % 50 == 49 and covered.all():
                break
        if rng.random() < 0.5:
            # separable [1 2 1]/4 blur ~ 0.5 px: sub-pixel-soft edges
            k = np.array([0.25, 0.5, 0.25], np.float32)
            img = np.apply_along_axis(
                lambda v: np.convolve(v, k, mode="same"), 0, img
            )
            img = np.apply_along_axis(
                lambda v: np.convolve(v, k, mode="same"), 1, img
            )
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def fiber_images(
    n: int = 8,
    size: int = 256,
    seed: int = 0,
    palette_images: list[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """Hair/fur-like fiber fields: anti-aliased strands integrated along a
    smooth orientation field over a soft skin-tone background.

    Motivation: the LOO "head" fold (skin + fine hair) is the held-out
    floor (EVAL.md) — dead-leaves/pink-noise statistics carry occlusion
    edges and broadband texture but no long thin ANISOTROPIC structures,
    which is exactly what x4 SR must hallucinate on hair.  Strand colors
    jitter around a base sampled from ``palette_images`` (train-side only
    in held-out protocols) or a brown/grey range.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    pal = None
    if palette_images:
        cols = [
            im.reshape(-1, 3)[rng.integers(0, im.shape[0] * im.shape[1], 2048)]
            for im in palette_images
        ]
        pal = np.concatenate(cols, axis=0).astype(np.float32)
    out = []
    for _ in range(n):
        # soft background: two palette (or skin-range) colors in a smooth ramp
        if pal is not None:
            c0, c1 = pal[rng.integers(0, len(pal), 2)]
        else:
            c0 = np.array([rng.uniform(120, 220)] * 3) * np.array([1.0, 0.85, 0.7])
            c1 = c0 * rng.uniform(0.6, 1.1)
        gdir = rng.uniform(0, 2 * np.pi)
        t = (np.cos(gdir) * xx + np.sin(gdir) * yy)[..., None]
        t = (t - t.min()) / (np.ptp(t) + 1e-8)
        img = (1 - t) * c0 + t * c1
        # smooth orientation field: low-frequency sinusoid mix
        th0 = rng.uniform(0, np.pi)
        theta = th0 + rng.uniform(0.2, 0.9) * (
            np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx + rng.uniform()))
            + np.cos(2 * np.pi * (rng.uniform(0.5, 2) * yy + rng.uniform()))
        ) * 0.5
        # strand base color: dark fiber tone (palette-shaded)
        if pal is not None:
            base = pal[rng.integers(0, len(pal))] * rng.uniform(0.25, 0.7)
        else:
            base = np.array([rng.uniform(20, 90)]) * np.array([1.0, 0.8, 0.6])
        n_strands = int(rng.integers(250, 500))
        length = int(rng.integers(60, 160))
        pos = rng.uniform(0, size - 1, (n_strands, 2)).astype(np.float32)
        shade = rng.uniform(0.6, 1.5, (n_strands, 1)).astype(np.float32)
        cols_s = np.clip(base[None, :] * shade, 0, 255)
        alpha = rng.uniform(0.25, 0.6)
        canvas = img.copy()
        for _step in range(length):
            iy = np.clip(pos[:, 0].astype(np.int32), 0, size - 1)
            ix = np.clip(pos[:, 1].astype(np.int32), 0, size - 1)
            ang = theta[iy, ix] + rng.normal(0, 0.03, n_strands)
            pos[:, 0] += np.sin(ang)
            pos[:, 1] += np.cos(ang)
            fy, fx = pos[:, 0], pos[:, 1]
            inside = (fy >= 0) & (fy < size - 1) & (fx >= 0) & (fx < size - 1)
            if not inside.any():
                break
            fy, fx, c = fy[inside], fx[inside], cols_s[inside]
            y0, x0 = fy.astype(np.int32), fx.astype(np.int32)
            wy, wx = fy - y0, fx - x0
            # bilinear splat (anti-aliased sub-pixel strand deposition)
            for dy, dx, w in (
                (0, 0, (1 - wy) * (1 - wx)),
                (0, 1, (1 - wy) * wx),
                (1, 0, wy * (1 - wx)),
                (1, 1, wy * wx),
            ):
                a = (alpha * w)[:, None]
                np.add.at(
                    canvas,
                    (y0 + dy, x0 + dx),
                    a * (c - canvas[y0 + dy, x0 + dx]),
                )
        # half get sub-pixel softening like the dead-leaves corpus
        if rng.random() < 0.5:
            k = np.array([0.25, 0.5, 0.25], np.float32)
            canvas = np.apply_along_axis(
                lambda v: np.convolve(v, k, mode="same"), 0, canvas
            )
            canvas = np.apply_along_axis(
                lambda v: np.convolve(v, k, mode="same"), 1, canvas
            )
        out.append(np.clip(canvas, 0, 255).astype(np.uint8))
    return out


def rich_synthetic_images(
    n: int = 48,
    size: int = 256,
    seed: int = 0,
    palette_images: list[np.ndarray] | None = None,
    fibers: bool = False,
) -> list[np.ndarray]:
    """Mixed procedural corpus for training without a mounted dataset:
    1/2 textured dead-leaves (occlusion edges at all scales), 1/4 pink
    noise (natural spectra), 1/8 sharp dead-leaves, 1/8 legacy
    sinusoid/stripe textures.  Deterministic per (n, size, seed).

    ``fibers=True`` re-allocates a quarter of the dead-leaves share to
    hair/fur-like fiber fields (fiber_images) — anisotropic thin
    structures the default mix lacks; kept opt-in so recorded protocols
    (EVAL_LOO_RICH.json) stay reproducible."""
    n_fib = n // 4 if fibers else 0
    n_dl = n // 2 - n_fib
    n_pink = n // 4
    n_sharp = n // 8
    n_legacy = n - n_dl - n_fib - n_pink - n_sharp
    imgs = (
        dead_leaves_images(n_dl, size, seed, palette_images, textured=True)
        + fiber_images(n_fib, size, seed + 4, palette_images)
        + pink_noise_images(n_pink, size, seed + 1)
        + dead_leaves_images(
            n_sharp, size, seed + 2, palette_images, textured=False
        )
        + synthetic_images(n_legacy, size, seed + 3)
    )
    return imgs


def pinned_mass_weights(n_real: int, n_synth: int, real_mass: float) -> list[float] | None:
    """PatchSampler weights pinning the real corpus to ``real_mass`` of the
    sampling probability, the synthetic images sharing the rest, so that a
    large synthetic corpus does not dilute a small real one.  Order: real
    images first, synthetic after.  None (uniform) when either side is
    empty; ``real_mass`` is clamped to [0, 1]."""
    if n_real <= 0 or n_synth <= 0:
        return None
    g = min(max(float(real_mass), 0.0), 1.0)
    return [g / n_real] * n_real + [(1.0 - g) / n_synth] * n_synth


class PatchSampler:
    """Random HR patch batches from a list of uint8 images (host side)."""

    def __init__(
        self,
        images: list[np.ndarray],
        hr_patch: int = 96,
        batch_size: int = 10,
        seed: int = 0,
        augment: bool = False,
        weights: list[float] | None = None,
        moa: float = 0.0,
        moa_ops: tuple[str, ...] | None = None,
    ):
        if not images:
            raise ValueError("no training images")
        if weights is not None and len(weights) != len(images):
            raise ValueError(f"weights ({len(weights)}) must match images ({len(images)})")
        keep = [i for i, im in enumerate(images) if im.shape[0] >= hr_patch and im.shape[1] >= hr_patch]
        self.images = [images[i] for i in keep]
        if not self.images:
            raise ValueError(f"no image is at least {hr_patch}px on both sides")
        #: optional per-image sampling mass, renormalised over the images
        #: that survive the size filter
        self.p = None
        if weights is not None:
            w = np.asarray([weights[i] for i in keep], np.float64)
            if w.sum() <= 0:
                raise ValueError("weights sum to zero over usable images")
            self.p = w / w.sum()
        self.hr_patch = hr_patch
        self.batch_size = batch_size
        self.augment = augment
        #: mixture-of-augmentations probability (data/augment.py), applied
        #: after the geometric flips, on the assembled batch
        self.moa = float(moa)
        self.moa_ops = moa_ops
        self.rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        """-> uint8 (B, hr_patch, hr_patch, 3)."""
        p = self.hr_patch
        out = np.empty((self.batch_size, p, p, 3), np.uint8)
        if self.p is not None:
            idx = self.rng.choice(len(self.images), self.batch_size, p=self.p)
        else:
            idx = self.rng.integers(0, len(self.images), self.batch_size)
        for i, k in enumerate(idx):
            im = self.images[k]
            y = self.rng.integers(0, im.shape[0] - p + 1)
            x = self.rng.integers(0, im.shape[1] - p + 1)
            patch = im[y : y + p, x : x + p]
            if self.augment:
                if self.rng.random() < 0.5:
                    patch = patch[:, ::-1]
                if self.rng.random() < 0.5:
                    patch = patch[::-1]
                if self.rng.random() < 0.5:
                    patch = patch.transpose(1, 0, 2)
            out[i] = patch
        if self.moa > 0.0:
            from image_enhance_keras_tpu_torch.data.augment import MOA_OPS, moa_augment

            out = moa_augment(out, self.rng, prob=self.moa, ops=self.moa_ops or MOA_OPS)
        return out

    def __iter__(self):
        while True:
            yield self.sample()


def degrade_batch_on_device(hr_u8: torch.Tensor, scale: int = 4, blur_sigma: float = 0.5) -> torch.Tensor:
    """HR uint8 batch -> LR float32 in [0,1] on the batch's device.

    The reference degradation: gaussian blur (``blur_sigma``; 0 skips it)
    on the uint8 image, rounded and clipped, then PIL-bicubic /``scale``
    with uint8 rounding per pass, then /255 (divided by a tensor, as
    ``ops.color.im2double`` does, not multiplied by a reciprocal).
    """
    from image_enhance_keras_tpu_torch.ops.color import im2double
    from image_enhance_keras_tpu_torch.ops.filters import gaussian_blur
    from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8

    x = hr_u8.to(torch.float32)
    if blur_sigma > 0:
        x = torch.clamp(torch.round(gaussian_blur(x, blur_sigma)), 0.0, 255.0)
    h, w = int(x.shape[-3]), int(x.shape[-2])
    return im2double(resize_pil_uint8(x, (h // scale, w // scale)))
