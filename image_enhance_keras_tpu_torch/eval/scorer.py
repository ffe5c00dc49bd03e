"""NTIRE-2017 evaluation harness, the scorpath protocol (mirror of ``eval/scorer.py``).

Protocol:
  * walk a directory; ground truth = files without the suffix tag;
    prediction = the ``<stem>_<suffix>(<k>x)<ext>`` sibling;
  * crop a 10-px border from both;
  * Y channel via skimage ``rgb2ycbcr``;
  * PSNR = the NTIRE formulation on Y;
  * SSIM-Y with data_range=255;
  * SSIM-RGB multichannel on the cropped colour images;
  * print per-image and mean scores.

The metric math runs in float32 on the scorer's device; only decode
happens on the host.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from image_enhance_keras_tpu_torch.data.io import imread, list_images
from image_enhance_keras_tpu_torch.ops.color import rgb2ycbcr
from image_enhance_keras_tpu_torch.ops.metrics import gmsd, psnr_nitre, ssim
from image_enhance_keras_tpu_torch.utils.logging import get_logger

__all__ = ["PairScore", "score_pair", "find_pairs", "score_directory"]

log = get_logger(__name__)


@dataclasses.dataclass
class PairScore:
    name: str
    psnr_y: float
    ssim_y: float
    ssim_rgb: float
    #: perceptual extension (lower = better); None unless with_gmsd was set
    gmsd_y: float | None = None


def _score(gt: torch.Tensor, pred: torch.Tensor, with_gmsd: bool) -> list[float]:
    gt_y = rgb2ycbcr(gt)[..., 0]
    pr_y = rgb2ycbcr(pred)[..., 0]
    vals = [
        psnr_nitre(pr_y, gt_y, 0),
        ssim(pr_y, gt_y, data_range=255.0),
        ssim(pred.to(torch.float32), gt.to(torch.float32), data_range=255.0),
    ]
    if with_gmsd:
        vals.append(gmsd(pr_y, gt_y))
    return [float(v) for v in torch.stack(vals).cpu()]


def _crop_border(img: np.ndarray, border: int) -> np.ndarray:
    if border <= 0:
        return img
    return img[border:-border, border:-border]


def score_pair(gt: np.ndarray, pred: np.ndarray, name: str = "", crop_border: int = 10,
               allow_shape_mismatch: bool = False, with_gmsd: bool = False,
               device: str | torch.device = "cuda") -> PairScore:
    """Score one uint8 RGB prediction against its ground truth on ``device``."""
    from image_enhance_keras_tpu_torch.engine import resolve_device

    dev = resolve_device(device)
    if gt.shape != pred.shape:
        # a wrongly-scaled prediction must be an error, not a plausible mean;
        # cropping to the common region is opt-in
        if not allow_shape_mismatch:
            raise ValueError(
                f"{name or 'pair'}: shape mismatch gt={gt.shape} pred={pred.shape}; pass "
                f"allow_shape_mismatch=True to score the top-left common region"
            )
        h, w = min(gt.shape[0], pred.shape[0]), min(gt.shape[1], pred.shape[1])
        log.warning("%s: shape mismatch gt=%s pred=%s; scoring common %dx%d",
                    name, gt.shape, pred.shape, h, w)
        gt, pred = gt[:h, :w], pred[:h, :w]
    gt_c = torch.from_numpy(np.array(_crop_border(gt, crop_border))).to(dev)
    pr_c = torch.from_numpy(np.array(_crop_border(pred, crop_border))).to(dev)
    vals = _score(gt_c, pr_c, with_gmsd)
    return PairScore(name, vals[0], vals[1], vals[2], gmsd_y=vals[3] if with_gmsd else None)


def find_pairs(dir_path: str, suffix: str = "scaled", scale_label: int = 1) -> list[tuple[str, str]]:
    """(ground truth, prediction) paths of a directory, by the naming contract."""
    tag = f"_{suffix}("
    pairs = []
    for path in list_images(dir_path):
        base = os.path.basename(path)
        if tag in base:
            continue
        stem, ext = os.path.splitext(path)
        pred = f"{stem}_{suffix}({scale_label}x){ext}"
        if os.path.exists(pred):
            pairs.append((path, pred))
        else:
            log.warning("no prediction for %s (expected %s)", base, os.path.basename(pred))
    return pairs


def print_score(s: PairScore) -> None:
    extra = f"  GMSD-Y {s.gmsd_y:.4f}" if s.gmsd_y is not None else ""
    print(f"{s.name}: PSNR-Y {s.psnr_y:.4f}  SSIM-Y {s.ssim_y:.4f}  SSIM-RGB {s.ssim_rgb:.4f}{extra}")


def mean_scores(scores: list[PairScore], with_gmsd: bool) -> dict[str, float]:
    """Means of the per-image scores (empty for no scores)."""
    if not scores:
        return {}
    means = {k: float(np.mean([getattr(s, k) for s in scores])) for k in ("psnr_y", "ssim_y", "ssim_rgb")}
    if with_gmsd:
        means["gmsd_y"] = float(np.mean([s.gmsd_y for s in scores]))
    return means


def score_directory(dir_path: str, suffix: str = "scaled", scale_label: int = 1, crop_border: int = 10,
                    verbose: bool = True, allow_shape_mismatch: bool = False, with_gmsd: bool = False,
                    device: str | torch.device = "cuda") -> tuple[list[PairScore], dict[str, float]]:
    """Score every ground truth of a directory that has a prediction beside it."""
    scores = []
    for gt_path, pred_path in find_pairs(dir_path, suffix, scale_label):
        s = score_pair(imread(gt_path), imread(pred_path), name=os.path.basename(gt_path),
                       crop_border=crop_border, allow_shape_mismatch=allow_shape_mismatch,
                       with_gmsd=with_gmsd, device=device)
        scores.append(s)
        if verbose:
            print_score(s)
    means = mean_scores(scores, with_gmsd)
    if verbose and scores:
        print(f"MEAN over {len(scores)} images: PSNR-Y {means['psnr_y']:.4f}  "
              f"SSIM-Y {means['ssim_y']:.4f}  SSIM-RGB {means['ssim_rgb']:.4f}")
    return scores, means
