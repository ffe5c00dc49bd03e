"""Dataset preparation CLI (mirror of ``cli/prepare_data.py``): materialise
paired LR/HR patch directories from a folder of source images.

    python -m image_enhance_keras_tpu_torch.cli.prepare_data <input_dir> <output_dir> [--scale 2] ...

Per source image: resize to ``img_size`` square (PIL bicubic), sharpen (PIL
SHARPEN), a stride-16 HR patch grid; per patch: the HR to ``y/``, then
gaussian blur sigma=0.5 and a bicubic downsample by the scale (re-upsampled
to HR size unless ``--true-upscale``) to ``X/``, named
``<imgidx>_<patchidx>.png``.  For disk-based training flows
(``data/generator.py``); the trainer samples patches on the fly instead.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from image_enhance_keras_tpu_torch.data.io import imread, imwrite, list_images
from image_enhance_keras_tpu_torch.ops.filters import gaussian_blur, sharpen_pil
from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8
from image_enhance_keras_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _u8(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint8)


def prepare(
    input_dir: str,
    output_dir: str,
    scale: int = 2,
    img_size: int = 256,
    stride: int = 16,
    patch_hr: int | None = None,
    true_upscale: bool = False,
    sharpen: bool = True,
    max_images: int | None = None,
    device: str | torch.device = "cuda",
) -> int:
    """Returns the number of patch pairs written.  ``max_images`` caps the
    number of source images processed."""
    from image_enhance_keras_tpu_torch.engine import resolve_device

    dev = resolve_device(device)
    x_dir = os.path.join(output_dir, "X")
    y_dir = os.path.join(output_dir, "y")
    os.makedirs(x_dir, exist_ok=True)
    os.makedirs(y_dir, exist_ok=True)
    patch_hr = patch_hr or 16 * scale
    count = 0
    paths = list_images(input_dir)
    if max_images is not None and max_images >= 0:
        paths = paths[:max_images]
    for idx, path in enumerate(paths):
        img = torch.from_numpy(np.array(imread(path))).to(dev)
        img = _u8(resize_pil_uint8(img, (img_size, img_size)))
        if sharpen:
            img = _u8(sharpen_pil(torch.from_numpy(img).to(dev).to(torch.float32)))
        pidx = 0
        for y0 in range(0, img_size - patch_hr + 1, stride):
            for x0 in range(0, img_size - patch_hr + 1, stride):
                hr = img[y0 : y0 + patch_hr, x0 : x0 + patch_hr]
                hr_t = torch.from_numpy(np.ascontiguousarray(hr)).to(dev).to(torch.float32)
                blurred = torch.clamp(torch.round(gaussian_blur(hr_t, 0.5)), 0, 255).to(torch.uint8)
                lr = resize_pil_uint8(blurred, (patch_hr // scale, patch_hr // scale)).to(torch.uint8)
                if not true_upscale:
                    lr = resize_pil_uint8(lr, (patch_hr, patch_hr))
                name = f"{idx}_{pidx}.png"
                imwrite(os.path.join(y_dir, name), hr)
                imwrite(os.path.join(x_dir, name), _u8(lr))
                pidx += 1
                count += 1
        log.info("%s: %d patches", os.path.basename(path), pidx)
    return count


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="materialise LR/HR patch dirs (PyTorch/CUDA)")
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--scale", type=int, default=2)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--stride", type=int, default=16)
    p.add_argument("--true-upscale", action="store_true")
    p.add_argument("--no-sharpen", action="store_true")
    p.add_argument("--max-images", type=int, default=None, help="process at most N source images")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (cuda must be present unless cpu is asked for)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    n = prepare(
        args.input_dir,
        args.output_dir,
        scale=args.scale,
        img_size=args.img_size,
        stride=args.stride,
        true_upscale=args.true_upscale,
        sharpen=not args.no_sharpen,
        max_images=args.max_images,
        device=args.device,
    )
    log.info("wrote %d patch pairs", n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
