"""A frame cut into bands of rows (or columns), one band a device, each
forward run stage by stage with a halo exchange before each stage.

JAX shards a frame's height over its mesh and lets XLA's SPMD partitioner
exchange each conv's boundary rows between the chips.  Here the exchange
is explicit: a forward is a list of :class:`Stage` (a residual block, a
chain kernel, the entry conv, the x4, ...), each with its receptive radius
``radius`` in its input's rows and its ``scale``.  Before a stage, each
band takes ``radius`` rows from its neighbours on each side (fewer at the
frame's true top and bottom, where the stage's own zero padding or edge
clamp is the frame's); it runs the stage on ``band + 2 * radius`` rows,
whose outer ``radius`` rows the padding at the cut corrupts, and keeps its
own ``scale * band`` rows.  The result equals the whole-frame forward
wherever the stage's arithmetic does not depend on the array's extent.

A stage whose arithmetic reduces over the whole sample (the per-sample
abs-max of the int8 dynamic tail: X3, and X4 on the subpixel head) is a
generator (``banded=True``): it yields its band's partial abs-max over its
own pixels, is sent the maximum over all bands, and so on, then returns its
output; :func:`run_bands` reduces between the bands, so that every band
quantizes with the frame's scale, as XLA's all-reduce makes JAX's do.

:func:`forward_stages` gives the stages of each forward of the engine
(``xla``, ``pallas``, ``pallas_chain``, ``pallas_int8``, ``int8``) for each
model of the zoo, as (body, tail): split mode runs the body banded by rows
and each tail stripe banded by columns.  They call the same blocks, kernel
wrappers and helpers as the forwards they mirror.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Stage", "Weights", "forward_stages", "run_bands", "split_sizes"]


class Weights(NamedTuple):
    """What a stage reads on one device: the module (a replica there) and the forward's weight tree."""

    module: Any
    params: Any


@dataclasses.dataclass(frozen=True)
class Stage:
    """``fn(w, x)`` -> y over one band (``banded``: ``fn(w, x, window)``, a
    generator, see the module docstring); ``radius``: the rows of x an
    output row depends on, each side; ``scale``: y's rows per row of x."""

    fn: Callable
    radius: int = 0
    scale: int = 1
    banded: bool = False


def split_sizes(total: int, parts: int) -> list[int]:
    """``total`` rows in at most ``parts`` bands that differ by at most one row, none empty."""
    parts = max(1, min(int(parts), int(total)))
    q, r = divmod(int(total), parts)
    return [q + (i < r) for i in range(parts)]


def _window(axis: int, x: torch.Tensor, lo: int, hi: int) -> tuple[int, int, int, int]:
    if axis == 1:
        return lo, hi, 0, int(x.shape[2])
    return 0, int(x.shape[1]), lo, hi


def _drive(gens: list, devices: list[torch.device]) -> list:
    """Run banded generators in lockstep, sending each the maximum of all
    their yields (gathered on the first band's device); their return values."""
    vals = [next(g) for g in gens]
    while True:
        red = torch.stack([v.to(devices[0]) for v in vals]).amax(0)
        outs, nxt = [], []
        for g, dev in zip(gens, devices):
            try:
                nxt.append(g.send(red.to(dev)))
            except StopIteration as stop:
                outs.append(stop.value)
        if outs:
            if len(outs) != len(gens):
                raise RuntimeError("banded stage: the bands' generators yielded unequal numbers of times")
            return outs
        vals = nxt


def run_bands(stages: list[Stage], bands: list[torch.Tensor], weights: list[Weights],
              axis: int = 1) -> list[torch.Tensor]:
    """Run ``stages`` over ``bands`` (NHWC, adjacent along ``axis``: 1 rows,
    2 columns; each on its device, read with ``weights[i]``): each band's own
    part of every stage's output, as contiguous tensors on the bands' devices.

    No host synchronisation: a halo is a device-to-device copy and every
    launch is queued on its band's device."""
    devices = [b.device for b in bands]
    for st in stages:
        sizes = [int(b.shape[axis]) for b in bands]
        starts = [sum(sizes[:i]) for i in range(len(sizes) + 1)]
        total, r = starts[-1], int(st.radius)
        exts, tops = [], []
        for i, b in enumerate(bands):
            lo, hi = max(starts[i] - r, 0), min(starts[i + 1] + r, total)
            pieces = []
            for j, bj in enumerate(bands):
                a, z = max(lo, starts[j]), min(hi, starts[j + 1])
                if a < z:
                    piece = bj if z - a == sizes[j] else bj.narrow(axis, a - starts[j], z - a)
                    pieces.append(piece.to(devices[i]))  # this band, or halo rows from a neighbour
            exts.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, axis))
            tops.append(starts[i] - lo)
        if st.banded:
            gens = [st.fn(w, e, _window(axis, e, t, t + n)) for w, e, t, n in zip(weights, exts, tops, sizes)]
            outs = _drive(gens, devices)
        else:
            outs = [st.fn(w, e) for w, e in zip(weights, exts)]
        s = int(st.scale)
        bands = [o.narrow(axis, s * t, s * n).contiguous() for o, t, n in zip(outs, tops, sizes)]
    return bands


# -- the stages of each forward ------------------------------------------------------

def _k(p: dict) -> int:
    """A conv's radius from its kernel ("kernel", or the int8 "q") in a weight tree."""
    return int((p["kernel"] if "kernel" in p else p["q"]).shape[0]) // 2


def _kc(conv) -> int:
    """A conv module's radius."""
    return int(conv.kernel.shape[0]) // 2


def _r_light53(p: dict) -> int:
    return max(_k(p["conv_a1"]) + _k(p["conv_a2"]), _k(p["conv_b1"]) + _k(p["conv_b2"]))


def _r_light(p: dict) -> int:
    return _k(p["conv_a"]) + _k(p["conv_b"])


def _r_diff(p: dict) -> int:
    return _k(p["conv_a"]) + _k(p["conv_b"]) + _k(p["conv_c"]) + _k(p["conv_d"])


def _r_block(block) -> int:
    """A residual block module's radius, from its convs."""
    name = type(block).__name__
    if name == "Light53Block":
        return max(_kc(block.conv_a1) + _kc(block.conv_a2), _kc(block.conv_b1) + _kc(block.conv_b2))
    if name == "LightBlock":
        return _kc(block.conv_a) + _kc(block.conv_b)
    return _kc(block.conv_a) + _kc(block.conv_b) + _kc(block.conv_c) + _kc(block.conv_d)


def _blocks(prefix: str, n: int, module) -> list[Stage]:
    return [Stage(lambda w, h, name=f"{prefix}_{i}": getattr(w.module, name)(h),
                  _r_block(getattr(module, f"{prefix}_{i}"))) for i in range(n)]


def _cast(w, h):
    """The module profiles' cast of a body's or a tail's input (none under ``mixed``)."""
    return h if w.module.mixed else h.to(w.module.dtype)


def _module_stages(m) -> tuple[list[Stage], list[Stage]]:
    """``forward='xla'``: the module's own submodules, as its body and tail call them."""
    from image_enhance_keras_tpu_torch.ops.pixel_shuffle import depth_to_space
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_tf1

    name = type(m).__name__
    entry = Stage(lambda w, x: torch.relu(w.module.level1(_cast(w, x))), _kc(m.level1))
    out = Stage(lambda w, h: torch.relu(w.module.out(h)).to(torch.float32), _kc(m.out))
    if name == "DifvdsrDouble":
        body = [entry, *_blocks("body53", m.n_body53, m), *_blocks("light", m.n_light, m)]
        if m.upsampler == "tf1_bilinear":
            head = Stage(lambda w, h: upsample_phase_tf1(_cast(w, h), w.module.scale), 1, m.scale)
        else:
            head = Stage(lambda w, h: depth_to_space(w.module.subpixel_conv(_cast(w, h)), w.module.scale,
                                                     order="dcr"), _kc(m.subpixel_conv), m.scale)
        return body, [head, *_blocks("tail53", m.n_tail53, m), out]
    if name == "Difvdsr4":
        def mid(w, h):
            skip = h
            for i in range(w.module.n_mid):
                h = getattr(w.module, f"mid_{i}")(h)
            return h + skip

        r_mid = sum(_r_block(getattr(m, f"mid_{i}")) for i in range(m.n_mid))
        body = [entry, *_blocks("head", m.n_head, m),
                Stage(lambda w, h: upsample_phase_tf1(h, 2), 1, 2), Stage(mid, r_mid)]
        if m.scale == 4:
            first = Stage(lambda w, h: upsample_phase_tf1(_cast(w, h), 2), 1, 2)
        else:
            first = Stage(_cast)
        return body, [first, *_blocks("tail", m.n_tail, m), out]
    if name == "Difvdsr":
        return [entry, *_blocks("diff", m.n_blocks, m), out], []
    raise ValueError(f"no banded forward for {name}")


def _pallas_stages(m, dtype, chain: bool) -> tuple[list[Stage], list[Stage]]:
    """``forward='pallas'`` / ``'pallas_chain'``: ``apply_didbl_pallas`` in its
    stages, K1/K2 a block each, K6/K7 a chain each (their summed radius)."""
    from image_enhance_keras_tpu_torch.models import didbl_pallas as dp
    from image_enhance_keras_tpu_torch.models.blocks import profile_dtype
    from image_enhance_keras_tpu_torch.ops.cuda.blocks import fused_light_block
    from image_enhance_keras_tpu_torch.ops.cuda.tower import fused_light53_chain, fused_light_chain
    from image_enhance_keras_tpu_torch.ops.resize import resize_bilinear_tf1

    dt = profile_dtype(dtype)
    stages = [Stage(lambda w, x: torch.relu(dp._conv(x.to(dt), w.params["level1"])))]
    if chain:
        def k6(w, h):
            b53 = [w.params[f"body53_{i}"] for i in range(m.n_body53)]
            return fused_light53_chain(h, *dp._stacked(b53, ("conv_a1", "conv_a2", "conv_b1", "conv_b2")),
                                       res_scale=0.1, identity_scale=0.9)

        def k7(w, h):
            bl = [w.params[f"light_{i}"] for i in range(m.n_light)]
            return fused_light_chain(h, *dp._stacked(bl, ("conv_a", "conv_b")), res_scale=0.1)

        stages += [Stage(k6, sum(_r_block(getattr(m, f"body53_{i}")) for i in range(m.n_body53))),
                   Stage(k7, sum(_r_block(getattr(m, f"light_{i}")) for i in range(m.n_light)))]
    else:
        stages += [Stage(lambda w, h, i=i: dp._light53(h, w.params[f"body53_{i}"]),
                         _r_block(getattr(m, f"body53_{i}"))) for i in range(m.n_body53)]

        def light(w, h, i):
            p = w.params[f"light_{i}"]
            return fused_light_block(h, p["conv_a"]["kernel"], p["conv_a"]["bias"], p["conv_b"]["kernel"],
                                     p["conv_b"]["bias"], res_scale=0.1)

        stages += [Stage(lambda w, h, i=i: light(w, h, i), _r_block(getattr(m, f"light_{i}")))
                   for i in range(m.n_light)]
    stages.append(Stage(lambda w, h: resize_bilinear_tf1(h, (m.scale * h.shape[-3], m.scale * h.shape[-2])),
                        1, m.scale))
    stages += [Stage(lambda w, h, i=i: dp._light53_xla(h, w.params[f"tail53_{i}"]),
                     _r_block(getattr(m, f"tail53_{i}"))) for i in range(m.n_tail53)]
    stages.append(Stage(lambda w, h: torch.relu(dp._conv(h, w.params["out"])).to(torch.float32), _kc(m.out)))
    return stages, []


def _int8_kernel_stages(m) -> tuple[list[Stage], list[Stage]]:
    """``forward='pallas_int8'``: ``apply_didbl_int8_body`` / ``_tail`` in their
    stages (K4 / K5 a block each, static calibrated scales)."""
    from image_enhance_keras_tpu_torch.models import didbl_pallas as dp
    from image_enhance_keras_tpu_torch.ops.cuda.int8_blocks import light_int8
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_tf1

    tile = (64, 128)

    def k5(w, h, i):
        p = w.params[f"light_{i}"]
        return light_int8(h, p["conv_a"]["q"], p["conv_a"]["s"], p["conv_a"]["bias"], p["conv_b"]["q"],
                          p["conv_b"]["s"], p["conv_b"]["bias"], res_scale=0.1, tile=tile, act_scales=p["act"])

    def k4(w, h, name):
        if "act" not in w.params[name]:
            raise ValueError("a banded pallas_int8 forward needs calibrated activation scales")
        return dp._light53_i8(h, w.params[name], tile)

    body = [Stage(lambda w, x: torch.relu(dp._conv(x.to(torch.bfloat16), w.params["level1"])))]
    body += [Stage(lambda w, h, i=i: k4(w, h, f"body53_{i}"), _r_block(getattr(m, f"body53_{i}")))
             for i in range(m.n_body53)]
    body += [Stage(lambda w, h, i=i: k5(w, h, i), _r_block(getattr(m, f"light_{i}"))) for i in range(m.n_light)]
    tail = [Stage(lambda w, h: upsample_phase_tf1(h.to(torch.bfloat16), m.scale), 1, m.scale)]
    tail += [Stage(lambda w, h, i=i: k4(w, h, f"tail53_{i}"), _r_block(getattr(m, f"tail53_{i}")))
             for i in range(m.n_tail53)]
    tail.append(Stage(lambda w, h: torch.relu(dp._conv(h, w.params["out"])).to(torch.float32), _kc(m.out)))
    return body, tail


def _int8_xla_stages(m, dynamic: bool) -> tuple[list[Stage], list[Stage]]:
    """``forward='int8'``: ``apply_didbl_int8_xla`` (and its dynamic tail),
    ``apply_difv4_int8`` and ``apply_difvdsr_int8`` in their stages.  Under
    the int8 body tile (``int8_body_tile``) the body runs per band and block,
    which is the tiled body's output."""
    from image_enhance_keras_tpu_torch.models import didbl_pallas as dp
    from image_enhance_keras_tpu_torch.models import zoo_int8 as zi
    from image_enhance_keras_tpu_torch.ops.cuda.int8_conv import int8_conv3, int8_conv3_dyn_banded
    from image_enhance_keras_tpu_torch.ops.cuda.int8_xla import light53_int8_xla_dyn_banded
    from image_enhance_keras_tpu_torch.ops.pixel_shuffle import depth_to_space
    from image_enhance_keras_tpu_torch.ops.resize import resize_bilinear_tf1, upsample_phase_tf1

    bf16, f32 = torch.bfloat16, torch.float32
    name = type(m).__name__
    out = Stage(lambda w, h: torch.relu(dp._conv(h, w.params["out"])).to(f32), _kc(m.out))
    if name == "DifvdsrDouble":
        def entry(w, x):
            dp._require_act(w.params)
            return torch.relu(dp._conv(x.to(bf16), w.params["level1"]))

        body = [Stage(entry)]
        body += [Stage(lambda w, h, i=i: dp._light53_i8_xla(h, w.params[f"body53_{i}"]),
                       _r_block(getattr(m, f"body53_{i}"))) for i in range(m.n_body53)]
        body += [Stage(lambda w, h, i=i: dp._light_i8_xla(h, w.params[f"light_{i}"]),
                       _r_block(getattr(m, f"light_{i}"))) for i in range(m.n_light)]
        start = 0
        if m.upsampler == "subpixel":
            def sub_static(w, h):
                p = w.params["subpixel_conv"]
                t = int8_conv3(h.to(bf16), p["qf"], p["sf"], p["bias"], p["actc"]["x"], acc=dp._int8_acc())
                return depth_to_space(t.to(bf16), m.scale, order="dcr")

            def sub_dyn(w, h, window):
                p = w.params["subpixel_conv"]
                t = yield from int8_conv3_dyn_banded(h.to(bf16), window, p["q"], p["s"], p["bias"],
                                                     acc=dp._int8_acc())
                return depth_to_space(t.to(bf16), m.scale, order="dcr")

            head = Stage(sub_dyn, 1, m.scale, banded=True) if dynamic else Stage(sub_static, 1, m.scale)
        elif not dynamic and m.n_tail53 >= 1 and dp._knob("IEK_INT8_UPQ"):
            # the x4 fused into the first HR block: its radius in LR rows is
            # the x4's one row and the block's HR rows, rounded up to LR rows
            r_up = 1 + -(-_r_block(m.tail53_0) // m.scale)
            head = Stage(lambda w, h: dp._light53_i8_xla_upfused(h.to(bf16), w.params["tail53_0"], m.scale),
                         r_up, m.scale)
            start = 1
        else:
            def up(w, h):
                h = h.to(bf16)
                if dp._knob("IEK_INT8_UPMM"):
                    return resize_bilinear_tf1(h, (m.scale * int(h.shape[1]), m.scale * int(h.shape[2]))).contiguous()
                return upsample_phase_tf1(h, m.scale)

            head = Stage(up, 1, m.scale)

        def x3(w, h, window, name):
            p = w.params[name]
            convs = [p[c][k] for c in ("conv_a1", "conv_a2", "conv_b1", "conv_b2") for k in ("q", "s", "bias")]
            return (yield from light53_int8_xla_dyn_banded(h, window, *convs, acc=dp._int8_acc(),
                                                           merge55=dp._knob("IEK_INT8_MERGE55")))

        if dynamic:
            blocks = [Stage(lambda w, h, win, i=i: x3(w, h, win, f"tail53_{i}"),
                            _r_block(getattr(m, f"tail53_{i}")), banded=True) for i in range(start, m.n_tail53)]
        else:
            blocks = [Stage(lambda w, h, i=i: dp._light53_i8_xla(h, w.params[f"tail53_{i}"]),
                            _r_block(getattr(m, f"tail53_{i}"))) for i in range(start, m.n_tail53)]
        return body, [head, *blocks, out]
    entry = Stage(lambda w, x: torch.relu(dp._conv(x.to(bf16), w.params["level1"])), _kc(m.level1))
    if name == "Difvdsr4":
        def lights(prefix, n, leaky):
            return [Stage(lambda w, h, i=i: zi._light_i8(h, w.params[f"{prefix}_{i}"], leaky),
                          _r_block(getattr(m, f"{prefix}_{i}"))) for i in range(n)]

        def mid(w, h):
            skip = h
            for i in range(m.n_mid):
                h = zi._light_i8(h, w.params[f"mid_{i}"], None)
            return h + skip

        r_mid = sum(_r_block(getattr(m, f"mid_{i}")) for i in range(m.n_mid))
        body = [entry, *lights("head", m.n_head, zi._DIFV4_LEAKY_HEAD),
                Stage(lambda w, h: upsample_phase_tf1(h, 2), 1, 2), Stage(mid, r_mid)]
        first = (Stage(lambda w, h: upsample_phase_tf1(h.to(bf16), 2), 1, 2) if m.scale == 4
                 else Stage(lambda w, h: h.to(bf16)))
        return body, [first, *lights("tail", m.n_tail, None), out]
    if name == "Difvdsr":
        blocks = [Stage(lambda w, h, i=i: zi._diff_i8(h, w.params[f"diff_{i}"]), _r_block(getattr(m, f"diff_{i}")))
                  for i in range(m.n_blocks)]
        return [entry, *blocks, out], []
    raise ValueError(f"no banded int8 forward for {name}")


def forward_stages(resolver) -> tuple[list[Stage], list[Stage]]:
    """(body, tail) stages of the resolver's forward; body + tail is the
    whole forward, and the split is the one split mode uses (a model
    without a split has every stage in its body)."""
    m, fm = resolver.module, resolver.forward_mode
    if fm == "xla":
        return _module_stages(m)
    if fm in ("pallas", "pallas_chain"):
        return _pallas_stages(m, resolver._dtype, fm == "pallas_chain")
    if fm == "pallas_int8":
        return _int8_kernel_stages(m)
    return _int8_xla_stages(m, bool(resolver.int8_dynamic_tail))
