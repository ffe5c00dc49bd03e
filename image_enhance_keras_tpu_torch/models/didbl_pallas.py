"""Kernel forward of the didbl generator (mirror of ``apply_didbl_pallas``).

Runs the DifvdsrDouble graph over the same parameter tree with the 16
Light53 and 6 Light LR blocks on the CUDA kernels of ``ops/cuda/blocks.py``.
The 1x1 ``level1`` conv, the TF1 x4 (as two dense contractions), the two
HR Light53 blocks and the 3x3 ``out`` conv are plain torch, as the JAX
version leaves them to XLA.  On CPU tensors the block wrappers run their
plain versions.
"""

from __future__ import annotations

from typing import Any

import torch

from image_enhance_keras_tpu_torch.models.blocks import check_profile
from image_enhance_keras_tpu_torch.ops.conv import conv2d_nhwc
from image_enhance_keras_tpu_torch.ops.cuda.blocks import fused_light53_block, fused_light_block
from image_enhance_keras_tpu_torch.ops.resize import resize_bilinear_tf1

__all__ = ["apply_didbl_pallas"]


def _conv(x: torch.Tensor, p: dict) -> torch.Tensor:
    return conv2d_nhwc(x, p["kernel"]) + p["bias"]


def _light53(x: torch.Tensor, p: dict) -> torch.Tensor:
    return fused_light53_block(
        x,
        p["conv_a1"]["kernel"], p["conv_a1"]["bias"],
        p["conv_a2"]["kernel"], p["conv_a2"]["bias"],
        p["conv_b1"]["kernel"], p["conv_b1"]["bias"],
        p["conv_b2"]["kernel"], p["conv_b2"]["bias"],
        res_scale=0.1,
        identity_scale=0.9,
    )


def _light53_xla(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Plain light53 for the post-upsample blocks."""
    a = _conv(torch.relu(_conv(x, p["conv_a1"])), p["conv_a2"])
    b = _conv(torch.relu(_conv(x, p["conv_b1"])), p["conv_b2"])
    return 0.9 * x + 0.1 * (a + b)


def apply_didbl_pallas(params: Any, x: torch.Tensor, dtype: Any = None, n_body53: int = 16,
                       n_light: int = 6, n_tail53: int = 2, scale: int = 4,
                       chain: bool = False) -> torch.Tensor:
    """(N, H, W, 3) [0,1] -> (N, 4H, 4W, 3); same math as DifvdsrDouble."""
    if chain:
        raise NotImplementedError("chain=True (pallas_chain) is not yet ported in image_enhance_keras_tpu_torch")
    check_profile(dtype, False)
    h = torch.relu(_conv(x.to(torch.float32), params["level1"]))
    for i in range(n_body53):
        h = _light53(h, params[f"body53_{i}"])
    for i in range(n_light):
        p = params[f"light_{i}"]
        h = fused_light_block(
            h,
            p["conv_a"]["kernel"], p["conv_a"]["bias"],
            p["conv_b"]["kernel"], p["conv_b"]["bias"],
            res_scale=0.1,
        )
    h = resize_bilinear_tf1(h, (scale * h.shape[-3], scale * h.shape[-2]))
    for i in range(n_tail53):
        h = _light53_xla(h, params[f"tail53_{i}"])
    return torch.relu(_conv(h, params["out"]))
