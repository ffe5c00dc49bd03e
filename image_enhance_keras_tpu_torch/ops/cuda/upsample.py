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

The op is linear and JAX has no backward kernel for it (``_upsample_pallas_ad``
differentiates the XLA construction); likewise the op's registered backward
is the transpose of the plain construction, taken by autograd.
"""

from __future__ import annotations

import functools

import torch

from image_enhance_keras_tpu_torch.ops.cuda import _build, library

__all__ = ["upsample_phase_tf1_kernel", "weight_table", "weight_tensor"]


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


upsample_phase_tf1_kernel.launches = 0
upsample_phase_tf1_kernel.bf16_launches = 0
