"""SAME convolution on NHWC activations with HWIO weights, through ``F.conv2d``.

The JAX package keeps activations NHWC and kernels HWIO; the port keeps
both layouts and permutes views for ``F.conv2d`` (NCHW / OIHW), so the
result comes back NHWC with channels-last memory.

bf16 tensors convolve as JAX's bf16 ``lax.conv`` does: the products of the
bf16 values summed in float32 and the result rounded once to bf16.  On CUDA
that is cuDNN's bf16 convolution; on the CPU, where torch's bf16
convolution sums in another order, the float32 convolution of the same
values as contiguous NCHW / OIHW tensors (the CPU's channels-last float32
path sums several times less accurately), rounded once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def disable_tf32() -> None:
    """Full float32 convs and matmuls on the card, and bf16 matmuls that sum in
    float32 throughout: the parity bounds assume it (process-wide switches,
    set by every engine and by a loaded exported program)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def conv2d_nhwc(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """(N, H, W, Cin) * (kh, kw, Cin, Cout) -> (N, H, W, Cout), SAME zero padding."""
    kh, kw = int(kernel.shape[0]), int(kernel.shape[1])
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME padding needs odd kernel sizes, got {kh}x{kw}")
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        y = F.conv2d(x.float().permute(0, 3, 1, 2).contiguous(), kernel.float().permute(3, 2, 0, 1).contiguous(),
                     None if bias is None else bias.float(), padding=(kh // 2, kw // 2))
        return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias, padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1).contiguous()
