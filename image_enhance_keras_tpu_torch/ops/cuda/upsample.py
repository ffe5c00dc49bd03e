"""TF1 integer-factor bilinear upsample: the CUDA kernel (K3).

Counterpart of ``ops/pallas/upsample.py``.  The op ``iek::upsample_phase_tf1``
(``ops/cuda/library.py``) runs :func:`_launch` on CUDA tensors: (N, H, W,
C) float32 or bfloat16, any factor and any H and W, one launch of
``csrc/upsample.cu``, bit-identical to the plain phase construction
``ops.resize.upsample_phase_plain``, which is the op's CPU implementation.
``upsample_phase_tf1_kernel`` calls the op on CUDA tensors only and counts
its launches in ``.launches``, those on bf16 tensors also in
``.bf16_launches``; ``ops.resize.upsample_phase_tf1`` calls the op for
every tensor.  The kernel's interpolation weights come from
:func:`weight_table` (computed here for every factor, passed to the launch
as a small device tensor), so the kernel divides nothing.

K3q, the quantizing form (``IEK_INT8_UPQ``): :func:`upsample_quant_tf1`
calls ``iek::upsample_quant_tf1``, K3's bf16 x4 with the per-channel int8
quantize of the first HR block in its epilogue (``csrc/upsample.cu``,
:func:`_launch_quant`, counted in ``upsample_quant_tf1.launches``); its
plain version :func:`upsample_quant_plain` is the op's CPU implementation.

The op is linear and JAX has no backward kernel for it (``_upsample_pallas_ad``
differentiates the XLA construction); likewise the op's registered backward
is the transpose of the plain construction, taken by autograd.
"""

from __future__ import annotations

import functools

import torch

from image_enhance_keras_tpu_torch.ops.cuda import _build, library

__all__ = ["upsample_phase_tf1_kernel", "upsample_quant_tf1", "upsample_quant_plain", "weight_table",
           "weight_tensor"]


@functools.lru_cache(maxsize=None)
def weight_table(factor: int, dtype: torch.dtype) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """(w0, w1): ``dtype``'s rounding of ``1 - r/f`` and ``r/f`` for r < f, as
    float32 values, exactly the weights ``upsample_phase_plain`` multiplies by."""
    f = int(factor)
    w0 = tuple(torch.tensor(1.0 - r / f, dtype=dtype).item() for r in range(f))
    w1 = tuple(torch.tensor(r / f, dtype=dtype).item() for r in range(f))
    return w0, w1


@functools.lru_cache(maxsize=None)
def weight_tensor(factor: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The table the kernel reads: float32 ``w0 + w1`` of :func:`weight_table`
    (2f values) on ``device``, made once per factor, dtype and device."""
    w0, w1 = weight_table(factor, dtype)
    return torch.tensor(w0 + w1, dtype=torch.float32, device=device)


def _launch(x: torch.Tensor, f: int) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the upsample kernel runs on cuda tensors, not {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the upsample kernel takes float32 or bfloat16, got {x.dtype}")
    n, h, w, c = (int(s) for s in x.shape)
    vec = 16 // x.element_size()
    if c % vec:
        raise ValueError(f"the upsample kernel needs C % {vec} == 0 for {x.dtype}, got C={c}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the upsample kernel takes contiguous, 16-byte aligned tensors")
    lib = _build.library("upsample")
    wt = weight_tensor(f, x.dtype, x.device)
    out = torch.empty((n, f * h, f * w, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.iek_upsample_phase_tf1(
            x.data_ptr(), out.data_ptr(), n, h, w, c, f, int(x.dtype == torch.bfloat16), wt.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "upsample_phase_tf1")
    upsample_phase_tf1_kernel.launches += 1
    upsample_phase_tf1_kernel.bf16_launches += int(x.dtype == torch.bfloat16)
    return out


def upsample_phase_tf1_kernel(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, f*H, f*W, C) on the CUDA kernel, differentiable;
    raises for a tensor off CUDA."""
    f = int(factor)
    if f == 1:
        return x
    if x.device.type != "cuda":
        raise ValueError(f"the upsample kernel runs on cuda tensors, not {x.device}")
    return library.upsample_phase_tf1(x, f)


def upsample_quant_plain(x: torch.Tensor, factor: int, scales: torch.Tensor) -> torch.Tensor:
    """int8 codes clamp(round(y * (1 / s_c)), +-127) of y, the bf16 x4 of x
    (``upsample_phase_plain``): JAX's ``_quant_c(upsample_phase_tf1(h, f), s)``."""
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain

    y = upsample_phase_plain(x, factor).to(torch.float32)
    return torch.clamp(torch.round(y * (1.0 / scales)), -127.0, 127.0).to(torch.int8)


def _launch_quant(x: torch.Tensor, f: int, scales: torch.Tensor) -> torch.Tensor:
    """K3q on CUDA tensors: the CUDA implementation of ``iek::upsample_quant_tf1``."""
    n, h, w, c = (int(s) for s in x.shape)
    lib = _build.library("upsample")
    wt = weight_tensor(f, x.dtype, x.device)
    out = torch.empty((n, f * h, f * w, c), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.iek_upsample_quant_tf1(
            x.data_ptr(), out.data_ptr(), n, h, w, c, f, wt.data_ptr(), scales.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "upsample_quant_tf1")
    upsample_quant_tf1.launches += 1
    return out


def upsample_quant_tf1(x: torch.Tensor, factor: int, scales: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) bf16 -> (N, fH, fW, C) int8: the x4 and the per-channel
    quantize at ``scales`` (C,) float32 in one pass (K3q on a CUDA tensor,
    :func:`upsample_quant_plain` on a CPU tensor)."""
    f = int(factor)
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise TypeError(f"the quantizing upsample takes (N, H, W, C) bfloat16, got {x.dtype} {tuple(x.shape)}")
    c = int(x.shape[-1])
    if tuple(scales.shape) != (c,) or scales.dtype != torch.float32 or scales.device != x.device:
        raise ValueError(f"scales must be float32 ({c},) on {x.device}")
    if f < 2:
        raise ValueError(f"the quantizing upsample takes a factor of at least 2, got {f}")
    if x.device.type == "cuda":
        if c % 8 or not x.is_contiguous() or x.data_ptr() % 16 or not scales.is_contiguous():
            raise ValueError("the quantizing upsample kernel takes contiguous, 16-byte aligned x with C % 8 == 0")
    elif x.device.type != "cpu":
        raise ValueError(f"the quantizing upsample runs on cpu or cuda tensors, not {x.device}")
    return library.upsample_quant_tf1(x, f, scales)


upsample_phase_tf1_kernel.launches = 0
upsample_phase_tf1_kernel.bf16_launches = 0
upsample_quant_tf1.launches = 0
