"""X4, the 3x3 int8 convolution of the zoo's ``--forward int8``: CUDA kernel and plain version.

The JAX package runs these convolutions as XLA ops over quantized tensors
(``models/didbl_pallas.py``: ``_deqf(_qconv_xla(_quant_c(x, s), qf), p)``,
and after ``_quant_dyn_sample(x)`` the dynamic ``_deq_dyn``), with the
block's activation after them (``models/zoo_int8.py``).  The port runs
each on one launch of ``csrc/int8_conv.cu``:

* :func:`int8_conv3` (static per-channel scales): x (N, H, W, C_in) bf16
  or float32 quantized as ``clamp(round(x * (1/s_c)), +-127)`` with the
  calibrated (C_in,) vector ``s_in``, the weights with those scales folded
  in ("qf") and a per-output-channel dequant scale ("sf"):
  ``act(A(acc) * sf + bias)``;
* :func:`int8_conv3_dyn` (the subpixel head under ``int8_dynamic_tail``):
  every sample quantized with its own scale ``max(abs-max, 1e-6) / 127.0``
  (divided, not multiplied), the unfolded weights ("q") and their scales
  ("s"): ``act(A(acc) * (s_w * s_x) + bias)``.

``A(acc)`` is the exact s32 sum as float32 (``acc="s32"`` or ``"f32"``)
or as float32 then bf16 (``"bf16"``, the default, as XLA converts it);
each product and add is rounded on its own, as JAX computes them one op
at a time (``jax.disable_jit()``); ``act`` is None, ``"relu"`` or a
float leaky slope (``where(y >= 0, y, slope * y)``).  The output is
float32 (N, H, W, C_out).

The wrappers check their arguments and call the ops ``iek::int8_conv3``
and ``iek::int8_conv3_dyn`` (``ops/cuda/library.py``, the activation as a
kind and a slope, :func:`act_code`): on a CUDA tensor the op launches the
kernel (C_in a multiple of 32 up to 256, C_out a multiple of 64; the
weights in the layout of :func:`packed`) or raises; on a CPU tensor it runs
the plain versions, which convolve the codes exactly in float64 and round
every float step as above, so that kernel and plain version agree bit for
bit.  Each wrapper counts in ``.launches`` the convolutions its op ran on
the kernel.
"""

from __future__ import annotations

import torch

from image_enhance_keras_tpu_torch.ops.cuda import _build, library
from image_enhance_keras_tpu_torch.ops.cuda.int8_blocks import _stream
from image_enhance_keras_tpu_torch.ops.cuda.int8_xla import _F32, _acc, _c, _check_acc, _quant_c, _quant_dyn_sample

__all__ = ["int8_conv3", "int8_conv3_dyn", "int8_conv3_dyn_banded", "int8_conv3_plain", "int8_conv3_dyn_plain", "packed",
           "launch_int8_conv3", "launch_int8_conv3_dyn"]

#: the activations' dtypes the kernel takes
_DTYPES = (torch.bfloat16, torch.float32)
#: the widest C_in the kernel stages in shared memory
CUDA_MAX_CIN = 256


def _act(y: torch.Tensor, act) -> torch.Tensor:
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    return torch.where(y >= 0, y, _c(float(act)) * y)


def int8_conv3_plain(x, wq, sf, bias, s_in, acc: str = "bf16", act=None) -> torch.Tensor:
    """act(A(conv(clamp(round(x * (1/s_in)), +-127), wq)) * sf + bias), float32."""
    return _act(_acc(_quant_c(x, s_in), wq, acc) * sf + bias, act)


def int8_conv3_dyn_plain(x, wq, s_w, bias, acc: str = "bf16", act=None, amax=None) -> torch.Tensor:
    """act(A(conv(q(x), wq)) * (s_w * s_x) + bias) with x's per-sample scale s_x, float32;
    ``amax`` (N,) gives the samples' abs-maxes in place of x's own."""
    xq, sx = _quant_dyn_sample(x.to(_F32), amax)
    return _act(_acc(xq, wq, acc) * (s_w * sx) + bias, act)


def _nt(cout: int) -> int:
    """Output channels a thread block computes (the kernel's NT, passed to it):
    128 where they divide C_out, else 64."""
    return 128 if cout % 128 == 0 else 64


def packed(wq: torch.Tensor) -> torch.Tensor:
    """HWIO int8 (3, 3, C_in, C_out) -> [9][C_in/32][C_out/NT][2][NT][16], the kernel's B operand.

    Each (tap, 32-input-channel step, NT-channel column block) is one
    contiguous NT x 32 tile, K-major: the two 16-byte halves of the step are
    NT*16 bytes apart.  Cached on the weight tensor (inference tensors carry
    no version counter: they are not repacked after an in-place change)."""
    version = None if wq.is_inference() else wq._version
    cached = getattr(wq, "_iek_packed_x4", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    _, _, cin, cout = (int(s) for s in wq.shape)
    nt = _nt(cout)
    out = wq.reshape(9, cin // 32, 2, 16, cout // nt, nt).permute(0, 1, 4, 2, 5, 3).contiguous()
    wq._iek_packed_x4 = (version, out)
    return out


def _check(x, wq, vectors, acc: str, act) -> None:
    _check_acc(acc)
    if not (act is None or act == "relu" or isinstance(act, float)):
        raise ValueError(f"act must be None, 'relu' or a float leaky slope, got {act!r}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be bfloat16 or float32 (N, H, W, C), got {x.dtype} {tuple(x.shape)}")
    cin = int(x.shape[-1])
    if wq.dtype != torch.int8 or wq.dim() != 4 or tuple(wq.shape[:3]) != (3, 3, cin):
        raise ValueError(f"weights must be int8 (3, 3, {cin}, C_out), got {wq.dtype} {tuple(wq.shape)}")
    cout = int(wq.shape[3])
    for v, n in vectors:
        if tuple(v.shape) != (n,) or v.dtype != _F32:
            raise ValueError(f"scales and biases must be float32 ({n},), got {v.dtype} {tuple(v.shape)}")
    for t in [wq, *(v for v, _ in vectors)]:
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one on {t.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3 runs on cpu or cuda tensors, not {x.device}")
    if cin % 32 or cin > CUDA_MAX_CIN or cout % 64:
        raise ValueError(f"the CUDA kernel takes C_in a multiple of 32 up to {CUDA_MAX_CIN} and C_out "
                         f"a multiple of 64, got {cin} -> {cout}")
    for t in [x, wq, *(v for v, _ in vectors)]:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")


def act_code(act) -> tuple[int, float]:
    """``act`` as the ops take it: (kind, slope), kind 0 none, 1 relu, 2 leaky."""
    if act is None:
        return 0, 0.0
    return (1, 0.0) if act == "relu" else (2, float(act))


def act_of(kind: int, slope: float):
    """The inverse of :func:`act_code`."""
    return (None, "relu", float(slope))[int(kind)]


def _launch(x, wp, s_in, sf, bias, acc, kind: int, slope: float) -> torch.Tensor:
    _build.check_aligned(x, wp, s_in, sf, bias)
    lib = _build.library("int8_conv")
    n, h, w, cin = (int(s) for s in x.shape)
    cout = int(sf.shape[0])
    out = torch.empty((n, h, w, cout), dtype=_F32, device=x.device)
    amax = torch.empty(n, dtype=_F32, device=x.device) if s_in is None else None
    with torch.cuda.device(x.device):
        code = lib.iek_int8_conv3(
            x.data_ptr(), int(x.dtype == _F32), None if s_in is None else s_in.data_ptr(),
            wp.data_ptr(), sf.data_ptr(), bias.data_ptr(),
            None if amax is None else amax.data_ptr(), out.data_ptr(), n, h, w, cin, cout, _nt(cout),
            int(acc == "bf16"), int(kind), float(slope), _stream(x))
    _build.check(lib, code, "int8_conv3")
    return out


def launch_int8_conv3(x, wp, sf, bias, s_in, acc: str, kind: int, slope: float) -> torch.Tensor:
    """X4 on CUDA tensors, the codes packed: the CUDA implementation of ``iek::int8_conv3``."""
    out = _launch(x, wp, s_in, sf, bias, acc, kind, slope)
    int8_conv3.launches += 1
    return out


def launch_int8_conv3_dyn(x, wp, s_w, bias, acc: str, kind: int, slope: float) -> torch.Tensor:
    """X4's dynamic form on CUDA tensors: the CUDA implementation of ``iek::int8_conv3_dyn``."""
    out = _launch(x, wp, None, s_w, bias, acc, kind, slope)
    int8_conv3_dyn.launches += 1
    return out


def _dyn_step(step: int, x, wp, s_w, bias, amax, out, acc: str, kind: int, slope: float) -> None:
    _build.check_aligned(x, wp, s_w, bias, amax, out)
    lib = _build.library("int8_conv")
    n, h, w, cin = (int(s) for s in x.shape)
    cout = int(s_w.shape[0])
    with torch.cuda.device(x.device):
        code = lib.iek_int8_conv3_dyn_step(
            step, x.data_ptr(), int(x.dtype == _F32), wp.data_ptr(), s_w.data_ptr(), bias.data_ptr(),
            amax.data_ptr(), None if out is None else out.data_ptr(), n, h, w, cin, cout, _nt(cout),
            int(acc == "bf16"), int(kind), float(slope), _stream(x))
    _build.check(lib, code, f"int8_conv3_dyn step {step}")


def launch_int8_conv3_absmax(x, wp, s_w, bias) -> torch.Tensor:
    """X4's dynamic step 0 on CUDA tensors: each sample's abs-max of x, (N,)."""
    amax = torch.zeros(int(x.shape[0]), dtype=_F32, device=x.device)
    _dyn_step(0, x, wp, s_w, bias, amax, None, "bf16", 0, 0.0)
    return amax


def launch_int8_conv3_dyn_given(x, wp, s_w, bias, amax, acc: str, kind: int, slope: float) -> torch.Tensor:
    """X4's dynamic step 1 on CUDA tensors: the conv at the given abs-maxes (a banded frame's)."""
    out = torch.empty((*x.shape[:3], int(s_w.shape[0])), dtype=_F32, device=x.device)
    _dyn_step(1, x, wp, s_w, bias, amax.to(_F32).contiguous(), out, acc, kind, slope)
    int8_conv3_dyn.launches += 1
    return out


def int8_conv3_dyn_banded(x, window, wq, s_w, bias, acc: str = "bf16", act=None):
    """:func:`int8_conv3_dyn` on one band of a frame whose abs-max is reduced
    over its bands: a generator that yields this band's abs-max of x over
    ``window`` (its own pixels, (y0, y1, x0, x1)), is sent the frame's, and
    returns the conv over the whole band."""
    cout = int(wq.shape[-1])
    _check(x, wq, [(s_w, cout), (bias, cout)], acc, act)
    (wq,) = library.device_layout(x, packed, wq)
    y0, y1, x0, x1 = (int(v) for v in window)
    amax = yield library.int8_conv3_absmax(x[:, y0:y1, x0:x1].contiguous(), wq, s_w, bias)
    return library.int8_conv3_dyn_given(x, wq, s_w, bias, amax, acc, *act_code(act))


def int8_conv3(x, wq, sf, bias, s_in, acc: str = "bf16", act=None) -> torch.Tensor:
    """Static-scale int8 3x3 SAME conv (X4): x quantized per input channel
    with ``s_in``, the folded weights ``wq`` ("qf"), ``sf``, ``bias``; float32 out."""
    cin, cout = int(x.shape[-1]), int(wq.shape[-1])
    _check(x, wq, [(sf, cout), (bias, cout), (s_in, cin)], acc, act)
    (wq,) = library.device_layout(x, packed, wq)
    return library.int8_conv3(x, wq, sf, bias, s_in, acc, *act_code(act))


def int8_conv3_dyn(x, wq, s_w, bias, acc: str = "bf16", act=None) -> torch.Tensor:
    """Per-sample dynamic int8 3x3 SAME conv (X4, dynamic form): the unfolded
    weights ``wq`` ("q") and their scales ``s_w`` ("s"); float32 out."""
    cout = int(wq.shape[-1])
    _check(x, wq, [(s_w, cout), (bias, cout)], acc, act)
    (wq,) = library.device_layout(x, packed, wq)
    return library.int8_conv3_dyn(x, wq, s_w, bias, acc, *act_code(act))


int8_conv3.launches = 0
int8_conv3_dyn.launches = 0
