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

The zoo's blocks run on four more forms of the same kernel, so that no
float32 activation between two convs of a block leaves the chip (JAX's
``_light_i8`` and ``_diff_i8`` op by op, ``models/zoo_int8.py``):

* :func:`int8_conv3_codes`: the int8 codes ``_quant_c(act(y), s_out)`` of
  the conv's output, from x quantized with ``s_in`` or from int8 codes
  (``s_in=None``): a LightBlock's conv_a, a DiffBlock's conv_a and conv_c;
* :func:`int8_conv3_light`: ``(x + 0.1 * y).to(x.dtype)`` from the codes
  of t, x the block input (a LightBlock's conv_b);
* :func:`int8_conv3_diff_b`: ``t = y`` (float32) and the codes of
  ``d = t - x`` (a DiffBlock's conv_b);
* :func:`int8_conv3_diff_d`: ``(x + 0.1 * ((d + y) + t)).to(x.dtype)``
  with ``d = t - x`` recomputed (a DiffBlock's conv_d).

Here y is ``A(acc) * sf + bias`` without an activation, and the rounding
is JAX's, op by op, as above.
"""

from __future__ import annotations

import torch

from image_enhance_keras_tpu_torch.ops.cuda import _build, library
from image_enhance_keras_tpu_torch.ops.cuda.int8_blocks import _stream
from image_enhance_keras_tpu_torch.ops.cuda.int8_xla import _F32, _acc, _c, _check_acc, _quant_c, _quant_dyn_sample
from image_enhance_keras_tpu_torch.ops.cuda.tf32x3 import cached_pack

__all__ = ["int8_conv3", "int8_conv3_dyn", "int8_conv3_dyn_banded", "int8_conv3_plain", "int8_conv3_dyn_plain", "packed",
           "launch_int8_conv3", "launch_int8_conv3_dyn", "int8_conv3_codes", "int8_conv3_light", "int8_conv3_diff_b",
           "int8_conv3_diff_d", "int8_conv3_codes_plain", "int8_conv3_light_plain", "int8_conv3_diff_b_plain",
           "int8_conv3_diff_d_plain"]

#: the activations' dtypes the kernel takes
_DTYPES = (torch.bfloat16, torch.float32)
#: the widest C_in the kernel stages in shared memory
CUDA_MAX_CIN = 256
#: the widest C_out of the forms that emit codes (their 1 / s_out sit in shared memory)
CUDA_MAX_COUT_CODES = 1024
#: the epilogues and dynamic steps of ``iek_int8_conv3x`` (csrc/int8_conv.cu's EPI_* and DYN_*)
_EPI_F32, _EPI_CODES, _EPI_LIGHT, _EPI_DIFF_B, _EPI_DIFF_D = 0, 1, 2, 3, 4
_DYN_FULL, _DYN_ABSMAX, _DYN_GIVEN = 1, 2, 3


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


def _codes(x: torch.Tensor, s_in) -> torch.Tensor:
    """The conv input's codes as float32: x quantized with ``s_in``, or x
    itself when it is int8 codes (``s_in`` None)."""
    return x.to(_F32) if s_in is None else _quant_c(x, s_in)


def int8_conv3_codes_plain(x, wq, sf, bias, s_in, s_out, acc: str = "bf16", act=None) -> torch.Tensor:
    """clamp(round(act(A(conv(q)) * sf + bias) * (1/s_out)), +-127), int8; q
    the codes of x at ``s_in``, or x itself (int8, ``s_in`` None)."""
    return _quant_c(_act(_acc(_codes(x, s_in), wq, acc) * sf + bias, act), s_out).to(torch.int8)


def int8_conv3_light_plain(xq, wq, sf, bias, x, acc: str = "bf16") -> torch.Tensor:
    """(x + 0.1 * (A(conv(xq)) * sf + bias)) in x's dtype: a LightBlock's second conv and combine."""
    u = _acc(xq.to(_F32), wq, acc) * sf + bias
    return (x.to(_F32) + _c(0.1) * u).to(x.dtype)


def int8_conv3_diff_b_plain(xq, wq, sf, bias, x, s_d, acc: str = "bf16"):
    """(t, codes of d): t = A(conv(xq)) * sf + bias (float32), d = t - x at the scales ``s_d``."""
    t = _acc(xq.to(_F32), wq, acc) * sf + bias
    return t, _quant_c(t - x.to(_F32), s_d).to(torch.int8)


def int8_conv3_diff_d_plain(xq, wq, sf, bias, x, t, acc: str = "bf16") -> torch.Tensor:
    """(x + 0.1 * ((d + u) + t)) in x's dtype, u = A(conv(xq)) * sf + bias, d = t - x."""
    u = _acc(xq.to(_F32), wq, acc) * sf + bias
    xf = x.to(_F32)
    return (xf + _c(0.1) * ((t - xf) + u + t)).to(x.dtype)


def _nt(cout: int) -> int:
    """Output channels of a column block (the kernel's NT, passed to it):
    128 where they divide C_out, else 96 where they do, else 64."""
    return 128 if cout % 128 == 0 else 96 if cout % 96 == 0 else 64


def packed(wq: torch.Tensor, nt: int | None = None) -> torch.Tensor:
    """HWIO int8 (k, k, C_in, C_out) -> [k*k][C_in/32][C_out/NT][2][NT][16], the kernel's B operand.

    Each (tap, 32-input-channel step, NT-channel column block) is one
    contiguous NT x 32 tile, K-major: the two 16-byte halves of the step are
    NT*16 bytes apart.  ``nt``: the output channels of a column block, by
    default :func:`_nt` of C_out (X4's 3 x 3 convs); X1's launches take 128
    and 64.  Cached on the weight tensor, one pack per ``nt``
    (``tf32x3.cached_pack``)."""
    k, _, cin, cout = (int(s) for s in wq.shape)
    nt = _nt(cout) if nt is None else int(nt)
    return cached_pack(wq, f"_iek_packed_x4_{nt}", lambda w: w.reshape(k * k, cin // 32, 2, 16, cout // nt, nt)
                       .permute(0, 1, 4, 2, 5, 3).contiguous())


def _check(x, wq, vectors, acc: str, act, codes: bool = False, like: tuple = ()) -> None:
    """Arguments of a conv of x: bf16 / float32, or int8 codes where
    ``codes``; ``like``: tensors of the output's (N, H, W, C_out) shape with
    their allowed dtypes."""
    _check_acc(acc)
    if not (act is None or act == "relu" or isinstance(act, float)):
        raise ValueError(f"act must be None, 'relu' or a float leaky slope, got {act!r}")
    if x.dim() != 4 or not (x.dtype in _DTYPES or (codes and x.dtype == torch.int8)):
        kinds = "bfloat16 or float32" + (" values or int8 codes" if codes else "")
        raise ValueError(f"x must be {kinds} (N, H, W, C), got {x.dtype} {tuple(x.shape)}")
    cin = int(x.shape[-1])
    if wq.dtype != torch.int8 or wq.dim() != 4 or tuple(wq.shape[:3]) != (3, 3, cin):
        raise ValueError(f"weights must be int8 (3, 3, {cin}, C_out), got {wq.dtype} {tuple(wq.shape)}")
    cout = int(wq.shape[3])
    for v, n in vectors:
        if tuple(v.shape) != (n,) or v.dtype != _F32:
            raise ValueError(f"scales and biases must be float32 ({n},), got {v.dtype} {tuple(v.shape)}")
    for t, dtypes in like:
        if tuple(t.shape) != (*x.shape[:3], cout) or t.dtype not in dtypes:
            raise ValueError(f"the block's tensors must be {dtypes} {(*x.shape[:3], cout)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    tensors = [x, wq, *(v for v, _ in vectors), *(t for t, _ in like)]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one on {t.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3 runs on cpu or cuda tensors, not {x.device}")
    if cin % 32 or cin > CUDA_MAX_CIN or cout % 64 and cout % 96:
        raise ValueError(f"the CUDA kernel takes C_in a multiple of 32 up to {CUDA_MAX_CIN} and C_out "
                         f"a multiple of 64 or 96, got {cin} -> {cout}")
    if codes and cout > CUDA_MAX_COUT_CODES:
        raise ValueError(f"the CUDA kernel's block forms take C_out up to {CUDA_MAX_COUT_CODES}, got {cout}")
    for t in tensors:
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


def launch_int8_conv3x(epi: int, x, wp, sf, bias, s_in=None, s_out=None, xr=None, t=None, amax=None,
                       dyn: int = 0, acc: str = "bf16", kind: int = 0, slope: float = 0.0):
    """One launch of X4 on CUDA tensors (``iek_int8_conv3x``: epilogue ``epi``,
    dynamic step ``dyn``, csrc/int8_conv.cu's EPI_* and DYN_*); returns what
    the epilogue writes (nothing for the abs-max step, which fills ``amax``).
    Not counted: the ``launch_int8_conv3*`` functions below count."""
    n, h, w, cin = (int(s) for s in x.shape)
    cout = int(sf.shape[0])
    dev = x.device
    out_q = torch.empty((n, h, w, cout), dtype=torch.int8, device=dev) if epi in (_EPI_CODES, _EPI_DIFF_B) else None
    out_f = (torch.empty((n, h, w, cout), dtype=_F32, device=dev)
             if epi in (_EPI_F32, _EPI_DIFF_B) and dyn != _DYN_ABSMAX else None)
    out_x = torch.empty_like(xr) if epi in (_EPI_LIGHT, _EPI_DIFF_D) else None
    _build.check_aligned(x, wp, sf, bias, s_in, amax, s_out, xr, t, out_q, out_f, out_x)
    lib = _build.library("int8_conv")
    src = 2 if x.dtype == torch.int8 else int(x.dtype == _F32)

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(dev):
        code = lib.iek_int8_conv3x(
            x.data_ptr(), src, ptr(s_in), ptr(amax), dyn, wp.data_ptr(), sf.data_ptr(), bias.data_ptr(),
            ptr(s_out), ptr(xr), int(xr is not None and xr.dtype == _F32), ptr(t), ptr(out_f), ptr(out_q),
            ptr(out_x), epi, n, h, w, cin, cout, _nt(cout), int(acc == "bf16"), int(kind), float(slope), _stream(x))
    _build.check(lib, code, f"int8_conv3x epilogue {epi} dynamic step {dyn}")
    if epi == _EPI_CODES:
        return out_q
    if epi == _EPI_DIFF_B:
        return out_f, out_q
    return out_f if epi == _EPI_F32 else out_x


def launch_int8_conv3(x, wp, sf, bias, s_in, acc: str, kind: int, slope: float) -> torch.Tensor:
    """X4 on CUDA tensors, the codes packed: the CUDA implementation of ``iek::int8_conv3``."""
    out = launch_int8_conv3x(_EPI_F32, x, wp, sf, bias, s_in=s_in, acc=acc, kind=kind, slope=slope)
    int8_conv3.launches += 1
    return out


def launch_int8_conv3_dyn(x, wp, s_w, bias, acc: str, kind: int, slope: float) -> torch.Tensor:
    """X4's dynamic form on CUDA tensors: the CUDA implementation of ``iek::int8_conv3_dyn``."""
    amax = torch.empty(int(x.shape[0]), dtype=_F32, device=x.device)
    out = launch_int8_conv3x(_EPI_F32, x, wp, s_w, bias, amax=amax, dyn=_DYN_FULL, acc=acc, kind=kind, slope=slope)
    int8_conv3_dyn.launches += 1
    return out


def launch_int8_conv3_absmax(x, wp, s_w, bias) -> torch.Tensor:
    """X4's dynamic step 0 on CUDA tensors: each sample's abs-max of x, (N,)."""
    amax = torch.zeros(int(x.shape[0]), dtype=_F32, device=x.device)
    launch_int8_conv3x(_EPI_F32, x, wp, s_w, bias, amax=amax, dyn=_DYN_ABSMAX)
    return amax


def launch_int8_conv3_dyn_given(x, wp, s_w, bias, amax, acc: str, kind: int, slope: float) -> torch.Tensor:
    """X4's dynamic step 1 on CUDA tensors: the conv at the given abs-maxes (a banded frame's)."""
    out = launch_int8_conv3x(_EPI_F32, x, wp, s_w, bias, amax=amax.to(_F32).contiguous(), dyn=_DYN_GIVEN, acc=acc,
                             kind=kind, slope=slope)
    int8_conv3_dyn.launches += 1
    return out


def launch_int8_conv3_codes(x, wp, sf, bias, s_in, s_out, acc: str, kind: int, slope: float) -> torch.Tensor:
    """The codes-emitting form on CUDA tensors: the CUDA implementation of ``iek::int8_conv3_codes``."""
    out = launch_int8_conv3x(_EPI_CODES, x, wp, sf, bias, s_in=s_in, s_out=s_out, acc=acc, kind=kind, slope=slope)
    int8_conv3_codes.launches += 1
    return out


def launch_int8_conv3_light(xq, wp, sf, bias, x, acc: str) -> torch.Tensor:
    """The LightBlock combine form on CUDA tensors: ``iek::int8_conv3_light``."""
    out = launch_int8_conv3x(_EPI_LIGHT, xq, wp, sf, bias, xr=x, acc=acc)
    int8_conv3_light.launches += 1
    return out


def launch_int8_conv3_diff_b(xq, wp, sf, bias, x, s_d, acc: str):
    """The DiffBlock conv_b form on CUDA tensors: ``iek::int8_conv3_diff_b``."""
    out = launch_int8_conv3x(_EPI_DIFF_B, xq, wp, sf, bias, s_out=s_d, xr=x, acc=acc)
    int8_conv3_diff_b.launches += 1
    return out


def launch_int8_conv3_diff_d(xq, wp, sf, bias, x, t, acc: str) -> torch.Tensor:
    """The DiffBlock combine form on CUDA tensors: ``iek::int8_conv3_diff_d``."""
    out = launch_int8_conv3x(_EPI_DIFF_D, xq, wp, sf, bias, xr=x, t=t, acc=acc)
    int8_conv3_diff_d.launches += 1
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


def int8_conv3_codes(x, wq, sf, bias, s_in, s_out, acc: str = "bf16", act=None) -> torch.Tensor:
    """X4 emitting the int8 codes of act(y) at the (C_out,) scales ``s_out``:
    from x (bf16 / float32) quantized with ``s_in``, or from x's int8 codes
    (``s_in`` None); int8 (N, H, W, C_out) out."""
    cin, cout = int(x.shape[-1]), int(wq.shape[-1])
    vectors = [(sf, cout), (bias, cout), (s_out, cout)] + ([] if s_in is None else [(s_in, cin)])
    _check(x, wq, vectors, acc, act, codes=True)
    if (s_in is None) != (x.dtype == torch.int8):
        raise ValueError("int8_conv3_codes takes int8 codes without s_in, or bf16 / float32 x with s_in")
    (wq,) = library.device_layout(x, packed, wq)
    return library.int8_conv3_codes(x, wq, sf, bias, s_in, s_out, acc, *act_code(act))


def _check_block(xq, wq, sf, bias, x, acc: str, vectors=(), like=()) -> None:
    cout = int(wq.shape[-1])
    if xq.dtype != torch.int8:
        raise ValueError(f"the block forms take the int8 codes of the conv's input, got {xq.dtype}")
    _check(xq, wq, [(sf, cout), (bias, cout), *vectors], acc, None, codes=True, like=[(x, _DTYPES), *like])


def int8_conv3_light(xq, wq, sf, bias, x, acc: str = "bf16") -> torch.Tensor:
    """X4 from the int8 codes ``xq`` of a LightBlock's t, with the block's
    combine: (x + 0.1 * y) in x's dtype, x the block input (N, H, W, C_out)."""
    _check_block(xq, wq, sf, bias, x, acc)
    (wq,) = library.device_layout(xq, packed, wq)
    return library.int8_conv3_light(xq, wq, sf, bias, x, acc)


def int8_conv3_diff_b(xq, wq, sf, bias, x, s_d, acc: str = "bf16"):
    """X4 from the codes of a DiffBlock's t1: (t float32, the int8 codes of
    d = t - x at the scales ``s_d``)."""
    _check_block(xq, wq, sf, bias, x, acc, vectors=[(s_d, int(wq.shape[-1]))])
    (wq,) = library.device_layout(xq, packed, wq)
    return library.int8_conv3_diff_b(xq, wq, sf, bias, x, s_d, acc)


def int8_conv3_diff_d(xq, wq, sf, bias, x, t, acc: str = "bf16") -> torch.Tensor:
    """X4 from the codes of a DiffBlock's u1, with the block's combine:
    (x + 0.1 * ((d + u) + t)) in x's dtype, d = t - x, t float32."""
    _check_block(xq, wq, sf, bias, x, acc, like=[(t, (_F32,))])
    (wq,) = library.device_layout(xq, packed, wq)
    return library.int8_conv3_diff_d(xq, wq, sf, bias, x, t, acc)


int8_conv3.launches = 0
int8_conv3_dyn.launches = 0
int8_conv3_codes.launches = 0
int8_conv3_light.launches = 0
int8_conv3_diff_b.launches = 0
int8_conv3_diff_d.launches = 0
