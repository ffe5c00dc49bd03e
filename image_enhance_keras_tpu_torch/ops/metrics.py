"""PSNR / SSIM / GMSD with the reference's formulations (mirror of ``ops/metrics.py``).

PSNR family (reference PSNR.py):
  * :func:`psnr_nitre`  - the NTIRE/Matlab form of the scoring script:
    optional border shave, scale-to-[0,1] if data > 1,
    ``10*log10(N / sum(diff^2))``;
  * :func:`psnr_vdsr`   - 255 peak with a ``scale``-pixel shave;
  * :func:`psnr_shave`  - 255 peak with a configurable shave;
  * :func:`psnr_peak1`  - im2double + ``-10*log10(mse)``.

SSIM: skimage ``compare_ssim`` semantics (uniform 7x7 window by default,
K1=0.01 / K2=0.03, sample covariance N/(N-1), edge-cropped mean);
multichannel input gives the per-channel SSIM averaged.  Everything runs in
float32 on the inputs' device and returns 0-d tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from image_enhance_keras_tpu_torch.ops.color import im2double
from image_enhance_keras_tpu_torch.ops.filters import _gaussian_kernel1d, separable_filter2d

__all__ = ["psnr_nitre", "psnr_vdsr", "psnr_shave", "psnr_peak1", "ssim", "mse", "gmsd"]


def _shave(x: torch.Tensor, border: int) -> torch.Tensor:
    """Crop ``border`` px from the spatial axes of (H, W), (H, W, C) or (N, H, W, C)."""
    if border <= 0:
        return x
    if x.dim() == 2:
        return x[border:-border, border:-border]
    return x[..., border:-border, border:-border, :]


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred.to(torch.float32) - target.to(torch.float32)
    return torch.mean(d * d)


def psnr_nitre(pred: torch.Tensor, target: torch.Tensor, shave_border: int = 0) -> torch.Tensor:
    """NTIRE-2017 PSNR; data whose max is > 1 is treated as 0..255 and rescaled (per input)."""
    p = _shave(pred.to(torch.float32), shave_border)
    t = _shave(target.to(torch.float32), shave_border)
    p = torch.where(p.max() > 1.0, im2double(p), p)
    t = torch.where(t.max() > 1.0, im2double(t), t)
    d = (p - t).reshape(-1)
    return 10.0 * torch.log10(d.numel() / torch.sum(d * d))


def psnr_vdsr(pred: torch.Tensor, target: torch.Tensor, scale_border: int = 4) -> torch.Tensor:
    """255-peak PSNR with a ``scale``-pixel shave."""
    return psnr_shave(pred, target, shave_border=scale_border)


def psnr_shave(pred: torch.Tensor, target: torch.Tensor, shave_border: int = 0) -> torch.Tensor:
    """255-peak PSNR with a configurable border shave."""
    m = mse(_shave(pred.to(torch.float32), shave_border), _shave(target.to(torch.float32), shave_border))
    return 20.0 * torch.log10(255.0 / torch.sqrt(m))


def psnr_peak1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """im2double + -10*log10(mse)."""
    return -10.0 * torch.log10(mse(im2double(pred), im2double(target)))


def _ssim_single(x: torch.Tensor, y: torch.Tensor, data_range: float, win_size: int, k1: float,
                 k2: float, gaussian_weights: bool, sigma: float,
                 use_sample_covariance: bool) -> torch.Tensor:
    """SSIM over one 2-D channel; skimage compare_ssim semantics."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if gaussian_weights:
        kern = _gaussian_kernel1d(sigma, truncate=3.5)
        win_size = len(kern)
    else:
        kern = np.full((win_size,), 1.0 / win_size, dtype=np.float32)

    def filt(a):
        return separable_filter2d(a, kern, kern, pad_mode="symmetric")

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    if use_sample_covariance:
        np_pts = win_size * win_size
        cov_norm = np_pts / (np_pts - 1.0)
    else:
        cov_norm = 1.0
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    pad = (win_size - 1) // 2
    return torch.mean(s[pad : s.shape[0] - pad, pad : s.shape[1] - pad])


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03, gaussian_weights: bool = False, sigma: float = 1.5,
         use_sample_covariance: bool = True, multichannel: bool | None = None) -> torch.Tensor:
    """skimage ``compare_ssim`` parity.

    2-D inputs: plain SSIM.  3-D (H, W, C) inputs with ``multichannel``
    truthy (or left None): per-channel SSIM averaged."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    if win_size < 3 or win_size % 2 == 0:
        raise ValueError(f"win_size must be odd and >= 3, got {win_size}")
    kwargs = dict(data_range=data_range, win_size=win_size, k1=k1, k2=k2,
                  gaussian_weights=gaussian_weights, sigma=sigma,
                  use_sample_covariance=use_sample_covariance)
    if x.dim() == 2:
        return _ssim_single(x, y, **kwargs)
    if x.dim() == 3:
        if multichannel is False:
            raise ValueError("3-D input requires multichannel SSIM")
        return torch.mean(torch.stack([_ssim_single(x[..., c], y[..., c], **kwargs)
                                       for c in range(x.shape[-1])]))
    raise ValueError(f"expected 2-D or 3-D input, got {x.dim()}-D")


def _conv3x3_same(a: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """2-D SAME correlation with a 3x3 kernel (zero padding), as shifted-slice sums."""
    h, w = a.shape
    ap = torch.nn.functional.pad(a, (1, 1, 1, 1))
    out = torch.zeros_like(a)
    for dy in range(3):
        for dx in range(3):
            if k[dy, dx] != 0.0:
                out = out + ap[dy : dy + h, dx : dx + w] * float(k[dy, dx])
    return out


def gmsd(x: torch.Tensor, y: torch.Tensor, c: float = 170.0) -> torch.Tensor:
    """Gradient Magnitude Similarity Deviation (Xue et al. 2013), lower is better.

    Luminance in [0, 255]; both images mean-pooled 2x2, Prewitt gradient
    magnitudes, similarity ``(2 m1 m2 + c)/(m1^2 + m2^2 + c)``, its standard
    deviation."""
    if x.shape != y.shape or x.dim() != 2:
        raise ValueError(f"expected equal 2-D luminance inputs, got {tuple(x.shape)} vs {tuple(y.shape)}")

    def pool2(a):
        h, w = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
        a = a[:h, :w].to(torch.float32)
        return (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]) / 4.0

    px = np.array([[1, 0, -1], [1, 0, -1], [1, 0, -1]], np.float32) / 3.0

    def grad_mag(a):
        gx, gy = _conv3x3_same(a, px), _conv3x3_same(a, px.T)
        return torch.sqrt(gx ** 2 + gy ** 2)

    m1 = grad_mag(pool2(x))
    m2 = grad_mag(pool2(y))
    gms = (2.0 * m1 * m2 + c) / (m1 ** 2 + m2 ** 2 + c)
    return torch.std(gms, correction=0)
