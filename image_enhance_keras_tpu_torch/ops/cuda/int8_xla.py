"""int8 residual blocks of the ``--forward int8`` serving path: CUDA kernels and plain versions.

The JAX package runs these blocks as XLA convolutions over quantized
tensors (``models/didbl_pallas.py``, ``_light53_i8_xla``, ``_light_i8_xla``,
``_light53_i8_xla_dyn``), not as Pallas kernels.  Torch has no int8
convolution on CUDA, so the port runs them on s8 ``wgmma`` implicit GEMMs
written for Hopper:

* :func:`light53_int8_xla`, :func:`light_int8_xla` (static per-channel
  scales): x (N, H, W, C) bf16 quantized as ``clamp(rint(x * (1/s_c)),
  +-127)`` with the (C,) calibrated vectors of ``act_scales`` (rows: input,
  then the branch intermediates), weights with those scales folded into them
  ("qf") and a per-output-channel dequant scale ("sf").  Each runs on two
  launches of the persistent, warp-specialised ``xla_block_kernel`` of
  ``csrc/int8_conv.cu`` (X4's machinery): X1 both first convs over one
  staged window into the branch codes, then per 64 output channels both
  second convs into two sets of sums in registers and the combine; X2 its
  conv into t's codes, then its second conv and the combine.  Their weights
  are packed by ``int8_conv.packed`` (128 output channels a column block;
  64 for X1's second convs);
* :func:`light53_int8_xla_dyn` (the HR tail under ``int8_dynamic_tail``):
  every sample quantized with its own scale ``max(abs-max, 1e-6) / 127.0``
  (divided, not multiplied), the unfolded weights ("q", "s"), dequant
  ``acc * (s_w * s_in) + bias``; each branch intermediate requantized with
  its own per-sample abs-max over the whole sample, once, by a pass of its
  own between the two conv launches (:func:`dyn_requant_plain` is its plain
  version, :func:`light53_int8_xla_dyn_codes_plain` that of the second
  convs over the codes); on ``csrc/int8_blocks.cu``;
* :func:`light53_int8_xla_upq` (X1u, the first HR block under
  ``IEK_INT8_UPQ``): X1 whose input arrives as int8 codes (the x f with
  the quantize fused, ``upsample.upsample_quant_tf1``, K3q) and whose
  identity leg is the float32 x f of ``0.9 * h_lr`` (:func:`upq_skip_plain`,
  K3's float32 arithmetic), formed from the LR map ``h_lr`` itself:
  ``bf16(skip + 0.1 * (a + b))``.  Two launches of ``xla_block_kernel`` as
  X1's: both first convs over a staged window of the codes, then both
  second convs and the combine, which computes each output's skip from
  four LR pixels (the HR skip map is never written); weights packed as X1's.

``merge55`` (``IEK_INT8_MERGE55``) makes the plain versions of X1 and X3
run a block's two first convs as JAX does under it: one 5x5 conv with 2C
outputs over the 3x3 weights zero-padded beside the 5x5 ones
(:func:`merged_w55`), its sums split into the two branch epilogues.  The
conv is exact, so this equals the unmerged block bit for bit in every
accumulator mode.  The kernels ignore the flag: their first launch already
stages x once for both first convs, which is what the merge buys XLA, and
they multiply no zero taps.

Every float step rounds where JAX rounds when it runs these ops one at a
time (``jax.disable_jit()``): the accumulator becomes float32 (``acc="s32"``
or ``"f32"``) or float32 and then bf16 (``"bf16"``, the default: XLA
converts the s32 sum to float32 before bf16), each product and each add of
the dequant and of the residual combine is rounded on its own (no fused
multiply-add), and the output is rounded once to x's dtype.  The
convolutions themselves are exact; XLA on the CPU sums the ``f32`` and
``bf16`` modes in float32, which is exact only below 2^24.  The jitted JAX
forward differs again: XLA folds the accumulator's conversion into the
conv and contracts the dequant into FMAs (ROADMAP.md §3).

The wrappers check their arguments and call the ops ``iek::light53_int8_xla``,
``iek::light53_int8_xla_upq``, ``iek::light_int8_xla`` and ``iek::light53_int8_xla_dyn``
(``ops/cuda/library.py``): on a CUDA tensor the op launches the kernels
(bf16 x, C = 128; ``launch_*`` below, the weights packed as above) or
raises; on a CPU tensor it runs the plain
versions, which compute the convolutions exactly in float64 and every
float step in the order above, so that kernels and plain versions agree
bit for bit.  Each wrapper counts in ``.launches`` the blocks its op ran on
the kernels.
"""

from __future__ import annotations

import torch

from image_enhance_keras_tpu_torch.ops.cuda import _build, library
from image_enhance_keras_tpu_torch.ops.cuda.int8_blocks import _check, _conv_s32, _packed, _stream

__all__ = [
    "ACC_MODES",
    "light53_int8_xla",
    "light_int8_xla",
    "light53_int8_xla_dyn",
    "light53_int8_xla_dyn_banded",
    "light53_int8_xla_upq",
    "merged_w55",
    "sample_absmax",
    "launch_light53_int8_xla",
    "launch_light_int8_xla",
    "launch_light53_int8_xla_dyn",
    "light53_int8_xla_plain",
    "light_int8_xla_plain",
    "light53_int8_xla_dyn_plain",
    "light53_int8_xla_upq_plain",
    "upq_skip_plain",
    "launch_light53_int8_xla_upq",
    "dyn_requant_plain",
    "light53_int8_xla_dyn_codes_plain",
]

#: accumulator modes (``IEK_INT8_ACC``): the conv output's type before the dequant
ACC_MODES = ("bf16", "s32", "f32")
_F32 = torch.float32
#: the activation dtype the kernels of the int8 forward take (its blocks run on bf16)
_BF16 = (torch.bfloat16,)


def _c(v: float) -> torch.Tensor:
    """A float32 scalar, as JAX's weakly typed Python constants become."""
    return torch.tensor(v, dtype=_F32)


def _acc(q: torch.Tensor, wq: torch.Tensor, acc: str) -> torch.Tensor:
    """The conv's accumulator as float32: the exact s32 sum rounded to
    float32, then to bf16 under ``acc="bf16"`` (the s32 -> bf16 conversion
    goes through float32, so sums above 2^24 round twice)."""
    y = _conv_s32(q, wq)
    return y.to(torch.bfloat16).to(_F32) if acc == "bf16" else y


def _quant_c(x: torch.Tensor, s_c: torch.Tensor) -> torch.Tensor:
    """Per-channel symmetric codes (as float32): clamp(round(x * (1/s_c)), +-127)."""
    return torch.clamp(torch.round(x.to(_F32) * (1.0 / s_c)), -127.0, 127.0)


def _requant_c(y: torch.Tensor, s_out: torch.Tensor) -> torch.Tensor:
    """The fused requantization (``IEK_INT8_EMIT=s8``): clamp(round(y *
    (1/s)), 0, 127) of the dequantized sums, which subsumes the relu."""
    return torch.clamp(torch.round(y * (1.0 / s_out)), 0.0, 127.0)


def _codes(y, s_next, emit_s8: bool) -> torch.Tensor:
    """Codes of relu(y) at the next conv's scales (the fused emission or the unfused chain)."""
    return _requant_c(y, s_next) if emit_s8 else _quant_c(torch.relu(y), s_next)


def _first(xq, w, sf, b, s_next, acc: str, emit_s8: bool) -> torch.Tensor:
    """Codes of relu(dequant(conv(xq, w))) at the next conv's scales."""
    return _codes(_acc(xq, w, acc) * sf + b, s_next, emit_s8)


def merged_w55(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """JAX's ``_merged_w55``: the two first-conv kernels (HWIO) concatenated
    on the output channels, the smaller zero-padded to the larger, centred."""
    kh, kw = max(wa.shape[0], wb.shape[0]), max(wa.shape[1], wb.shape[1])

    def padto(w):
        out = w.new_zeros((kh, kw, *w.shape[2:]))
        ph, pw = (kh - w.shape[0]) // 2, (kw - w.shape[1]) // 2
        out[ph : ph + w.shape[0], pw : pw + w.shape[1]] = w
        return out

    return torch.cat([padto(wa), padto(wb)], dim=-1)


def _first_pair(xq, wa1, wb1, acc: str, merge55: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The two first convs' accumulators (as float32): two convs, or under
    ``merge55`` one conv over :func:`merged_w55` split on its channels."""
    if not merge55:
        return _acc(xq, wa1, acc), _acc(xq, wb1, acc)
    c = int(wa1.shape[-1])
    both = _acc(xq, merged_w55(wa1, wb1), acc)
    return both[..., :c], both[..., c:]


def _check_acc(acc: str) -> None:
    if acc not in ACC_MODES:
        raise ValueError(f"int8 accumulator must be one of {ACC_MODES}, got {acc!r}")


def light53_int8_xla_plain(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                           act_scales, acc: str = "bf16", emit_s8: bool = False,
                           res_scale: float = 0.1, identity_scale: float = 0.9, merge55: bool = False):
    """The static Light53 block: ``act_scales`` (3, C) holds s_x, s_a, s_b;
    the weights are the folded "qf" codes and the scales their "sf"."""
    _check_acc(acc)
    xf = x.to(_F32)
    a1, b1 = _first_pair(_quant_c(xf, act_scales[0]), wa1, wb1, acc, merge55)
    aq = _codes(a1 * sa1 + ba1, act_scales[1], emit_s8)
    bq = _codes(b1 * sb1 + bb1, act_scales[2], emit_s8)
    a = _acc(aq, wa2, acc) * sa2 + ba2
    b = _acc(bq, wb2, acc) * sb2 + bb2
    return (_c(identity_scale) * xf + _c(res_scale) * (a + b)).to(x.dtype)


#: X1u's identity scale: the skip is the x f of 0.9 * h_lr (JAX's ``_light53_i8_xla_upfused``)
UPQ_IDENTITY = 0.9


def upq_skip_plain(h_lr: torch.Tensor, factor: int) -> torch.Tensor:
    """X1u's identity leg: the float32 x f (``upsample_phase_plain``, K3's
    arithmetic) of ``float32(h_lr) * 0.9``, (N, f H, f W, C)."""
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain

    return upsample_phase_plain(h_lr.to(_F32) * UPQ_IDENTITY, factor)


def light53_int8_xla_upq_plain(xq, h_lr, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                               act_scales, acc: str = "bf16", emit_s8: bool = False, res_scale: float = 0.1,
                               factor: int | None = None):
    """X1u: the static Light53 block from the given codes ``xq`` (int8, (N, f H,
    f W, C)) of its input, the x f of the bf16 LR map ``h_lr`` (N, H, W, C);
    ``act_scales`` (2, C) holds s_a, s_b; out = bf16(skip + res * (a + b)),
    skip = :func:`upq_skip_plain` of ``h_lr`` (JAX's ``_light53_i8_xla_upfused``).
    ``factor``: f, by default xq's height over h_lr's."""
    _check_acc(acc)
    skip = upq_skip_plain(h_lr, int(xq.shape[-3]) // int(h_lr.shape[-3]) if factor is None else factor)
    q = xq.to(_F32)
    aq = _first(q, wa1, sa1, ba1, act_scales[0], acc, emit_s8)
    bq = _first(q, wb1, sb1, bb1, act_scales[1], acc, emit_s8)
    a = _acc(aq, wa2, acc) * sa2 + ba2
    b = _acc(bq, wb2, acc) * sb2 + bb2
    return (skip + _c(res_scale) * (a + b)).to(torch.bfloat16)


def light_int8_xla_plain(x, w1, s1, b1, w2, s2, b2, act_scales, acc: str = "bf16",
                         emit_s8: bool = False, res_scale: float = 0.1):
    """The static Light block: ``act_scales`` (2, C) holds s_x, s_t."""
    _check_acc(acc)
    xf = x.to(_F32)
    tq = _first(_quant_c(xf, act_scales[0]), w1, s1, b1, act_scales[1], acc, emit_s8)
    u = _acc(tq, w2, acc) * s2 + b2
    return (xf + _c(res_scale) * u).to(x.dtype)


def sample_absmax(t: torch.Tensor) -> torch.Tensor:
    """Each sample's abs-max over (H, W, C), float32 (N,)."""
    return t.to(_F32).abs().amax(dim=(1, 2, 3))


def _quant_dyn_sample(t: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample codes and scale: s = max(abs-max over (H, W, C), 1e-6) / 127.0
    (a division), codes clamp(round(t / s), +-127), both float32.  ``amax``
    (N,) gives the samples' abs-maxes (a banded frame's, reduced over its
    bands) in place of t's own."""
    m = (sample_absmax(t) if amax is None else amax).reshape(-1, 1, 1, 1)
    m = torch.clamp_min(m, 1e-6)
    s = m / torch.full_like(m, 127.0)  # see int8_blocks.quantize_weights_per_channel
    return torch.clamp(torch.round(t / s), -127.0, 127.0), s


def light53_int8_xla_dyn_first_plain(x, wa1, sa1, ba1, wb1, sb1, bb1, amax_x, acc: str, window,
                                     merge55: bool = False):
    """X3's first convs: ta = relu(dequant(conv3(q(x)))), tb the same of conv5,
    x quantized with the samples' abs-maxes ``amax_x`` (N,); returns ta, tb
    and their abs-maxes (2, N) over ``window`` (y0, y1, x0, x1)."""
    _check_acc(acc)
    xq, sx = _quant_dyn_sample(x.to(_F32), amax_x)
    a1, b1 = _first_pair(xq, wa1, wb1, acc, merge55)
    ta = torch.relu(a1 * (sa1 * sx) + ba1)
    tb = torch.relu(b1 * (sb1 * sx) + bb1)
    y0, y1, x0, x1 = window
    return ta, tb, torch.stack([sample_absmax(t[:, y0:y1, x0:x1]) for t in (ta, tb)])


def light53_int8_xla_dyn_second_plain(x, ta, tb, wa2, sa2, ba2, wb2, sb2, bb2, amax_ab, acc: str,
                                      res_scale: float, identity_scale: float):
    """X3's second convs from ta, tb quantized with the abs-maxes ``amax_ab``
    (2, N), and the residual combine."""
    _check_acc(acc)

    def branch(t, w2, s2, b2, amax):
        tq, st = _quant_dyn_sample(t, amax)
        return _acc(tq, w2, acc) * (s2 * st) + b2

    a = branch(ta, wa2, sa2, ba2, amax_ab[0])
    b = branch(tb, wb2, sb2, bb2, amax_ab[1])
    return (_c(identity_scale) * x.to(_F32) + _c(res_scale) * (a + b)).to(x.dtype)


def dyn_requant_plain(t: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """X3's requantization pass: the int8 codes of t (N, H, W, C) at each
    sample's scale from the abs-maxes ``amax`` (N,)."""
    return _quant_dyn_sample(t, amax)[0].to(torch.int8)


def light53_int8_xla_dyn_codes_plain(x, qa, qb, wa2, sa2, ba2, wb2, sb2, bb2, amax_ab, acc: str,
                                     res_scale: float, identity_scale: float):
    """X3's second convs over the requantization pass's codes ``qa``, ``qb``
    (int8) with the branch scales from ``amax_ab`` (2, N), and the residual
    combine: :func:`light53_int8_xla_dyn_second_plain` as the kernel splits it."""
    _check_acc(acc)

    def branch(q, w2, s2, b2, amax):
        m = torch.clamp_min(amax.reshape(-1, 1, 1, 1), 1e-6)
        return _acc(q.to(_F32), w2, acc) * (s2 * (m / torch.full_like(m, 127.0))) + b2

    a = branch(qa, wa2, sa2, ba2, amax_ab[0])
    b = branch(qb, wb2, sb2, bb2, amax_ab[1])
    return (_c(identity_scale) * x.to(_F32) + _c(res_scale) * (a + b)).to(x.dtype)


def light53_int8_xla_dyn_plain(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                               acc: str = "bf16", res_scale: float = 0.1, identity_scale: float = 0.9,
                               merge55: bool = False):
    """The per-sample dynamic Light53 block over the unfolded weights "q" / "s":
    its two steps over whole samples.

    ``IEK_INT8_EMIT=s8`` (``_requant_dyn``) runs the same float ops in JAX,
    so one version serves both emissions."""
    ta, tb, amax_ab = light53_int8_xla_dyn_first_plain(x, wa1, sa1, ba1, wb1, sb1, bb1, sample_absmax(x), acc,
                                                       (0, x.shape[1], 0, x.shape[2]), merge55)
    return light53_int8_xla_dyn_second_plain(x, ta, tb, wa2, sa2, ba2, wb2, sb2, bb2, amax_ab, acc, res_scale,
                                             identity_scale)


def _light53_layout(x, wa1, wa2, wb1, wb2) -> list:
    """X1's and X1u's weights in the layout of the implementation that runs
    on x's device: HWIO for the plain versions; for the kernels packed with
    128 output channels a column block for the first convs' launch, 64 for
    the second's."""
    if x.device.type != "cuda":
        return [wa1, wa2, wb1, wb2]
    from image_enhance_keras_tpu_torch.ops.cuda.int8_conv import packed

    return [packed(wa1, 128), packed(wa2, 64), packed(wb1, 128), packed(wb2, 64)]


def light53_int8_xla(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, act_scales,
                     acc: str = "bf16", emit_s8: bool = False, res_scale: float = 0.1,
                     identity_scale: float = 0.9, merge55: bool = False):
    """int8 Light53 block with static per-channel scales (X1), SAME, output in x's dtype.

    ``act_scales``: (3, C) float32, the calibrated s_x, s_a, s_b.  The kernel
    always hands the branch codes from its first launch to its second, which
    is the fused ``emit_s8`` emission; ``emit_s8`` and ``merge55`` only
    select the plain version's form (bit-equal either way)."""
    _check_acc(acc)
    _check(x, [(wa1, 3), (wa2, 5), (wb1, 5), (wb2, 3)],
           [sa1, ba1, sa2, ba2, sb1, bb1, sb2, bb2], act_scales, (3, "C"), _BF16)
    wa1, wa2, wb1, wb2 = _light53_layout(x, wa1, wa2, wb1, wb2)
    return library.light53_int8_xla(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, act_scales,
                                    acc, bool(emit_s8), float(res_scale), float(identity_scale), bool(merge55))


def light53_int8_xla_upq(xq, h_lr, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, act_scales,
                         acc: str = "bf16", emit_s8: bool = False, res_scale: float = 0.1):
    """X1u: the static Light53 block from the int8 codes ``xq`` (N, f H, f W,
    C) of its input, the x f of the bf16 LR map ``h_lr`` (N, H, W, C), whose
    identity leg is the float32 x f of 0.9 * h_lr; ``act_scales``: (2, C)
    float32, s_a and s_b.  Output bf16 (N, f H, f W, C).  The kernels take
    an even f."""
    _check_acc(acc)
    _check(h_lr, [(wa1, 3), (wa2, 5), (wb1, 5), (wb2, 3)],
           [sa1, ba1, sa2, ba2, sb1, bb1, sb2, bb2], act_scales, (2, "C"), _BF16)
    n, h, w, c = (int(s) for s in h_lr.shape)
    f = int(xq.shape[1]) // h if xq.dim() == 4 else 0
    if (h_lr.dtype != torch.bfloat16 or xq.dtype != torch.int8 or f < 2 or tuple(xq.shape) != (n, f * h, f * w, c)
            or xq.device != h_lr.device):
        raise ValueError(f"X1u takes int8 codes (N, f H, f W, C), f >= 2, and the bf16 LR map (N, H, W, C), got "
                         f"{xq.dtype} {tuple(xq.shape)} and {h_lr.dtype} {tuple(h_lr.shape)}")
    if xq.device.type == "cuda":
        if not xq.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if f % 2:
            raise ValueError(f"the X1u kernel takes an even factor, got {f}")
    wa1, wa2, wb1, wb2 = _light53_layout(xq, wa1, wa2, wb1, wb2)
    return library.light53_int8_xla_upq(xq, h_lr, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                                        act_scales, acc, bool(emit_s8), float(res_scale), f)


def light_int8_xla(x, w1, s1, b1, w2, s2, b2, act_scales, acc: str = "bf16", emit_s8: bool = False,
                   res_scale: float = 0.1):
    """int8 Light block with static per-channel scales (X2); ``act_scales``: (2, C) s_x, s_t."""
    _check_acc(acc)
    _check(x, [(w1, 3), (w2, 3)], [s1, b1, s2, b2], act_scales, (2, "C"), _BF16)
    from image_enhance_keras_tpu_torch.ops.cuda.int8_conv import packed

    w1, w2 = library.device_layout(x, packed, w1, w2)
    return library.light_int8_xla(x, w1, s1, b1, w2, s2, b2, act_scales, acc, bool(emit_s8), float(res_scale))


def light53_int8_xla_dyn(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                         acc: str = "bf16", res_scale: float = 0.1, identity_scale: float = 0.9,
                         merge55: bool = False):
    """int8 Light53 block with per-sample dynamic scales (X3), over the unfolded "q" / "s".

    Four launches: each sample's abs-max of x; the first convs from x
    quantized with its sample's scale into float32 intermediates with their
    per-sample abs-maxes; the requantization pass, which turns the
    intermediates into int8 codes once; the second convs over the codes,
    and the residual combine."""
    _check_acc(acc)
    _check(x, [(wa1, 3), (wa2, 5), (wb1, 5), (wb2, 3)],
           [sa1, ba1, sa2, ba2, sb1, bb1, sb2, bb2], None, (), _BF16)
    wa1, wa2, wb1, wb2 = library.device_layout(x, _packed, wa1, wa2, wb1, wb2)
    return library.light53_int8_xla_dyn(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, acc,
                                        float(res_scale), float(identity_scale), bool(merge55))


def light53_int8_xla_dyn_banded(x, window, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                                acc: str = "bf16", res_scale: float = 0.1, identity_scale: float = 0.9,
                                merge55: bool = False):
    """X3 on one band of a frame whose abs-maxes are reduced over its bands:
    a generator that yields this band's abs-max of x over ``window`` (its
    own pixels, (y0, y1, x0, x1)) and is sent the frame's, then yields the
    branch intermediates' abs-maxes (2, N) over the window and is sent the
    frame's, and returns the block's output over the whole band (halo rows
    included).  Driven over a single band that is the whole frame, it is
    :func:`light53_int8_xla_dyn`."""
    _check_acc(acc)
    _check(x, [(wa1, 3), (wa2, 5), (wb1, 5), (wb2, 3)],
           [sa1, ba1, sa2, ba2, sb1, bb1, sb2, bb2], None, (), _BF16)
    wa1, wa2, wb1, wb2 = library.device_layout(x, _packed, wa1, wa2, wb1, wb2)
    y0, y1, x0, x1 = (int(v) for v in window)
    amax_x = yield library.light53_int8_xla_dyn_absmax(x[:, y0:y1, x0:x1].contiguous())
    ta, tb, amax_ab = library.light53_int8_xla_dyn_first(x, wa1, sa1, ba1, wb1, sb1, bb1, amax_x, acc,
                                                         [y0, y1, x0, x1], bool(merge55))
    amax_ab = yield amax_ab
    return library.light53_int8_xla_dyn_second(x, ta, tb, wa2, sa2, ba2, wb2, sb2, bb2, amax_ab, acc,
                                               float(res_scale), float(identity_scale))


def launch_light53_int8_xla(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, act_scales,
                            acc: str, res_scale: float, identity_scale: float) -> torch.Tensor:
    """X1 on CUDA tensors, the weights packed: the CUDA implementation of
    ``iek::light53_int8_xla`` (two launches of ``csrc/int8_conv.cu``, the
    branch codes ta, tb between them)."""
    convs = (wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2)
    _build.check_aligned(x, act_scales, *convs)
    lib = _build.library("int8_conv")
    n, h, w, c = (int(s) for s in x.shape)
    ta = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    tb = torch.empty_like(ta)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.iek_light53_int8_xla(
            x.data_ptr(), act_scales.data_ptr(), *(t.data_ptr() for t in convs), ta.data_ptr(), tb.data_ptr(),
            out.data_ptr(), n, h, w, c, int(acc == "bf16"), float(res_scale), float(identity_scale), _stream(x))
    _build.check(lib, code, "light53_int8_xla")
    light53_int8_xla.launches += 1
    return out


def launch_light53_int8_xla_upq(xq, h_lr, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                                act_scales, acc: str, res_scale: float, factor: int) -> torch.Tensor:
    """X1u on CUDA tensors, the weights packed: the CUDA implementation of
    ``iek::light53_int8_xla_upq`` (two launches of ``csrc/int8_conv.cu``, the
    branch codes ta, tb between them)."""
    from image_enhance_keras_tpu_torch.ops.cuda.upsample import weight_tensor

    convs = (wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2)
    _build.check_aligned(xq, h_lr, act_scales, *convs)
    lib = _build.library("int8_conv")
    n, h, w, c = (int(s) for s in h_lr.shape)
    wt = weight_tensor(factor, _F32, h_lr.device)
    ta = torch.empty(xq.shape, dtype=torch.int8, device=xq.device)
    tb = torch.empty_like(ta)
    out = torch.empty(xq.shape, dtype=torch.bfloat16, device=xq.device)
    with torch.cuda.device(xq.device):
        code = lib.iek_light53_int8_xla_upq(
            xq.data_ptr(), h_lr.data_ptr(), act_scales.data_ptr(), *(t.data_ptr() for t in convs), ta.data_ptr(),
            tb.data_ptr(), out.data_ptr(), wt.data_ptr(), n, h, w, c, int(factor), int(acc == "bf16"),
            float(res_scale), float(UPQ_IDENTITY), _stream(xq))
    _build.check(lib, code, "light53_int8_xla_upq")
    light53_int8_xla_upq.launches += 1
    return out


def launch_light_int8_xla(x, w1, s1, b1, w2, s2, b2, act_scales, acc: str, res_scale: float) -> torch.Tensor:
    """X2 on CUDA tensors, the weights packed: the CUDA implementation of
    ``iek::light_int8_xla`` (two launches of ``csrc/int8_conv.cu``, t's codes
    between them)."""
    convs = (w1, s1, b1, w2, s2, b2)
    _build.check_aligned(x, act_scales, *convs)
    lib = _build.library("int8_conv")
    n, h, w, c = (int(s) for s in x.shape)
    t = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.iek_light_int8_xla(
            x.data_ptr(), act_scales.data_ptr(), *(v.data_ptr() for v in convs), t.data_ptr(), out.data_ptr(),
            n, h, w, c, int(acc == "bf16"), float(res_scale), _stream(x))
    _build.check(lib, code, "light_int8_xla")
    light_int8_xla.launches += 1
    return out


def launch_light53_int8_xla_dyn(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, acc: str,
                                res_scale: float, identity_scale: float) -> torch.Tensor:
    """X3 on CUDA tensors, the codes packed: the CUDA implementation of ``iek::light53_int8_xla_dyn``."""
    convs = (wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2)
    _build.check_aligned(x, *convs)
    lib = _build.library("int8_blocks")
    n, h, w, c = (int(s) for s in x.shape)
    amax = torch.empty((3, n), dtype=_F32, device=x.device)
    ta = torch.empty(x.shape, dtype=_F32, device=x.device)
    tb = torch.empty_like(ta)
    qa = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    qb = torch.empty_like(qa)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.iek_light53_int8_xla_dyn(
            x.data_ptr(), *(t.data_ptr() for t in convs), amax.data_ptr(), ta.data_ptr(), tb.data_ptr(),
            qa.data_ptr(), qb.data_ptr(), out.data_ptr(), n, h, w, c, int(acc == "bf16"), float(res_scale),
            float(identity_scale), _stream(x))
    _build.check(lib, code, "light53_int8_xla_dyn")
    light53_int8_xla_dyn.launches += 1
    return out


def _dyn_step(step: int, x, convs, amax, ta, tb, out, window, acc: str, res_scale: float = 0.0,
              identity_scale: float = 0.0, qa=None, qb=None) -> None:
    """One step of ``iek_light53_int8_xla_dyn_step``; ``convs``: the 12 conv
    arguments, None where the step does not read them; qa, qb: step 2's
    int8 scratch for the codes of ta, tb."""
    _build.check_aligned(x, amax, ta, tb, qa, qb, out, *convs)
    lib = _build.library("int8_blocks")
    n, h, w, c = (int(s) for s in x.shape)
    ptr = [None if t is None else t.data_ptr() for t in (*convs, amax, ta, tb, qa, qb, out)]
    with torch.cuda.device(x.device):
        code = lib.iek_light53_int8_xla_dyn_step(step, x.data_ptr(), *ptr, n, h, w, c, *window,
                                                 int(acc == "bf16"), float(res_scale), float(identity_scale),
                                                 _stream(x))
    _build.check(lib, code, f"light53_int8_xla_dyn step {step}")


def launch_light53_int8_xla_dyn_absmax(x) -> torch.Tensor:
    """X3's step 0 on CUDA tensors: each sample's abs-max of x, (N,)."""
    amax = torch.zeros(int(x.shape[0]), dtype=_F32, device=x.device)
    _dyn_step(0, x, [None] * 12, amax, None, None, None, (0, 0, 0, 0), "bf16")
    return amax


def launch_light53_int8_xla_dyn_first(x, wa1, sa1, ba1, wb1, sb1, bb1, amax_x, acc: str, window):
    """X3's step 1 on CUDA tensors: ta, tb and their abs-maxes (2, N) over ``window``."""
    n = int(x.shape[0])
    amax = torch.cat([amax_x.reshape(1, n).to(_F32), torch.zeros((2, n), dtype=_F32, device=x.device)])
    ta = torch.empty(x.shape, dtype=_F32, device=x.device)
    tb = torch.empty_like(ta)
    _dyn_step(1, x, [wa1, sa1, ba1, None, None, None, wb1, sb1, bb1, None, None, None], amax, ta, tb, None,
              tuple(window), acc)
    return ta, tb, amax[1:].clone()


def launch_light53_int8_xla_dyn_second(x, ta, tb, wa2, sa2, ba2, wb2, sb2, bb2, amax_ab, acc: str,
                                       res_scale: float, identity_scale: float) -> torch.Tensor:
    """X3's step 2 on CUDA tensors (the block's output): counted as one X3 block."""
    n = int(x.shape[0])
    amax = torch.cat([torch.zeros((1, n), dtype=_F32, device=x.device), amax_ab.reshape(2, n).to(_F32)])
    out = torch.empty_like(x)
    qa = torch.empty(ta.shape, dtype=torch.int8, device=x.device)
    qb = torch.empty_like(qa)
    _dyn_step(2, x, [None, None, None, wa2, sa2, ba2, None, None, None, wb2, sb2, bb2], amax, ta, tb, out,
              (0, 0, 0, 0), acc, res_scale, identity_scale, qa, qb)
    light53_int8_xla_dyn.launches += 1
    return out


light53_int8_xla.launches = 0
light53_int8_xla_upq.launches = 0
light_int8_xla.launches = 0
light53_int8_xla_dyn.launches = 0
