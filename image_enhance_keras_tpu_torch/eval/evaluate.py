"""Model evaluation loop (mirror of ``eval/evaluate.py``): bicubic-degrade each
ground truth by the scale factor, run the resolver, score the reconstruction
against the ground truth with the NTIRE protocol, optionally save the
outputs.  Degradation and scoring run on the resolver's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from image_enhance_keras_tpu_torch.data.io import imread, imwrite, list_images
from image_enhance_keras_tpu_torch.eval.scorer import PairScore, mean_scores, print_score, score_pair
from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8
from image_enhance_keras_tpu_torch.utils.logging import get_logger

__all__ = [
    "BicubicResolver",
    "degrade",
    "evaluate_resolver_on_dir",
    "evaluate_resolver_on_dir_divisible",
    "evaluate_model",
]

log = get_logger(__name__)


def _resize_u8(img: np.ndarray, out_hw: tuple[int, int], device) -> np.ndarray:
    out = resize_pil_uint8(torch.from_numpy(np.array(img)).to(device), out_hw)
    return out.cpu().numpy().astype(np.uint8)


def degrade(gt: np.ndarray, scale: int = 4, device: str | torch.device = "cuda") -> np.ndarray:
    """GT -> LR with uint8 PIL-bicubic semantics (scipy imresize in the reference)."""
    from image_enhance_keras_tpu_torch.engine import resolve_device

    h, w = gt.shape[:2]
    return _resize_u8(gt, (h // scale, w // scale), resolve_device(device))


class BicubicResolver:
    """Upscales by plain PIL-bicubic, the classical baseline every SR paper
    (and the NTIRE protocol) compares against.  Same .upscale contract."""

    def __init__(self, scale: int = 4, device: str | torch.device = "cuda"):
        from image_enhance_keras_tpu_torch.engine import resolve_device

        self.scale = scale
        self.device = resolve_device(device)

    def upscale(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        return _resize_u8(img, (h * self.scale, w * self.scale), self.device)


def _score_and_report(resolver, gt: np.ndarray, sr: np.ndarray, path: str, crop_border: int,
                      with_gmsd: bool, verbose: bool) -> PairScore:
    s = score_pair(gt, sr, name=os.path.basename(path), crop_border=crop_border, with_gmsd=with_gmsd,
                   device=resolver.device)
    if verbose:
        print_score(s)
    return s


def _means(scores: list[PairScore], with_gmsd: bool, verbose: bool) -> dict[str, float]:
    means = mean_scores(scores, with_gmsd)
    if verbose and scores:
        print(f"MEAN over {len(scores)}: PSNR-Y {means['psnr_y']:.4f}  "
              f"SSIM-Y {means['ssim_y']:.4f}  SSIM-RGB {means['ssim_rgb']:.4f}")
    return means


def evaluate_resolver_on_dir(resolver, gt_dir: str, scale: int = 4, crop_border: int = 10,
                             save_dir: str | None = None, suffix_filter: str = "scaled",
                             verbose: bool = True,
                             with_gmsd: bool = False) -> tuple[list[PairScore], dict[str, float]]:
    """Degrade -> super-resolve -> score every ground-truth image in a dir."""
    scores = []
    tag = f"_{suffix_filter}("
    for path in list_images(gt_dir):
        if tag in os.path.basename(path):
            continue
        gt = imread(path)
        # crop GT to a multiple of scale so LR*scale == GT exactly
        h, w = (gt.shape[0] // scale) * scale, (gt.shape[1] // scale) * scale
        gt = gt[:h, :w]
        sr = resolver.upscale(degrade(gt, scale, resolver.device))
        scores.append(_score_and_report(resolver, gt, sr, path, crop_border, with_gmsd, verbose))
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            stem, ext = os.path.splitext(os.path.basename(path))
            imwrite(os.path.join(save_dir, f"{stem}_generated{ext}"), sr)
    return scores, _means(scores, with_gmsd, verbose)


def evaluate_resolver_on_dir_divisible(resolver, gt_dir: str, scale: int = 4, crop_border: int = 10,
                                       save_dir: str | None = None, suffix_filter: str = "scaled",
                                       verbose: bool = True, model_name: str = "model",
                                       with_gmsd: bool = False) -> tuple[list[PairScore], dict[str, float]]:
    """The reference's ``_evaluate_denoise`` driver, for models flagged
    ``requires_divisible_shape``: ground truths whose sides are not multiples
    of 4*scale are bicubic-RESIZED (not cropped) to the nearest lower
    multiple, the forward is whole-frame (``upscale_frame`` where the
    resolver has it), and outputs land in ``save_dir`` as
    ``<model>_<stem>_generated.png``."""
    scores = []
    tag = f"_{suffix_filter}("
    unit = 4 * scale
    for path in list_images(gt_dir):
        if tag in os.path.basename(path):
            continue
        gt = imread(path)
        h, w = gt.shape[:2]
        if h % unit or w % unit:
            h2, w2 = (h // unit) * unit, (w // unit) * unit
            if verbose:
                print(f"{os.path.basename(path)}: coercing to divisible size ({h}x{w}) -> ({h2}x{w2})")
            gt = _resize_u8(gt, (h2, w2), resolver.device)
        lr = degrade(gt, scale, resolver.device)
        spec = getattr(resolver, "spec", None)
        if (spec is None or not spec.pre_upscaled_input) and hasattr(resolver, "upscale_frame"):
            sr = resolver.upscale_frame(lr)  # whole-frame single forward, never tiled
        else:
            sr = resolver.upscale(lr)
        scores.append(_score_and_report(resolver, gt, sr, path, crop_border, with_gmsd, verbose))
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            stem = os.path.splitext(os.path.basename(path))[0]
            imwrite(os.path.join(save_dir, f"{model_name}_{stem}_generated.png"), sr)
    return scores, _means(scores, with_gmsd, verbose)


def evaluate_model(resolver, gt_dir: str, **kw):
    """The reference ``evaluate`` dispatch: the divisible-shape driver for
    flagged models, the standard loop otherwise."""
    spec = getattr(resolver, "spec", None)
    if spec is not None and getattr(spec, "requires_divisible_shape", False):
        kw.setdefault("model_name", spec.name)
        return evaluate_resolver_on_dir_divisible(resolver, gt_dir, **kw)
    kw.pop("model_name", None)
    return evaluate_resolver_on_dir(resolver, gt_dir, **kw)
