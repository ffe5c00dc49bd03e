"""Exported serving artifacts (mirror of ``runtime/export.py``), on ``torch.export``.

The JAX package serializes its compiled serving program as StableHLO; the
port serializes the same uint8 HWC -> uint8 HWC program for one input-size
bucket as a ``torch.export`` archive, the weights baked in as constants:

    export_forward(resolver, (512, 512), "didbl_512.iekx")
    fn = load_forward("didbl_512.iekx")       # uint8 HWC -> uint8 HWC x4

An ``.iekx`` file is JAX's magic ``IEKX0001`` followed by the archive of
``torch.export.save``.  The program calls every kernel as its ``iek::`` op
(``ops/cuda/library.py``): on the card the kernels, on the CPU their plain
versions.  The kernels' packed weights, the stacked chain weights and the
stacked int8 scales are made by one eager run of the program before the
trace, so the trace takes them as constants and the loaded program never
repacks them.

``export_forward`` serializes the whole-frame fast forward;
``export_pipeline`` the resolver's configured serving program (fast, the
striped split or the 2-D tiled split, the patch pipeline) in any forward,
with back-projection baked in.  ``load_forward`` needs torch and the op
library only: it imports no model and no engine.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from image_enhance_keras_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["export_forward", "export_pipeline", "load_forward"]

_MAGIC = b"IEKX0001"


class _Program(torch.nn.Module):
    """``run`` as a module: uint8 (H, W, 3) -> uint8 (sH, sW, 3)."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def forward(self, img_u8: torch.Tensor) -> torch.Tensor:
        return self.run(img_u8)


def _save(run, hw: tuple[int, int], device: torch.device, path: str) -> int:
    """Trace ``run`` at one (H, W) bucket and write the artifact; returns its bytes."""
    example = torch.zeros((int(hw[0]), int(hw[1]), 3), dtype=torch.uint8, device=device)
    with torch.inference_mode():
        run(example)  # the eager run that makes the kernels' packed weights the trace then takes as constants
        program = torch.export.export(_Program(run), (example,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = _MAGIC + buf.getvalue()
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def export_forward(resolver, input_hw: tuple[int, int], path: str) -> int:
    """Serialize the resolver's whole-frame uint8 -> uint8 forward (weights
    baked in, ``round_mode`` honoured) for the given input size.  Returns the
    artifact's size in bytes."""
    params = resolver._fwd_params()
    inner = resolver._fast_fn(input_hw)
    return _save(lambda img: inner(params, img), input_hw, resolver.device, path)


def export_pipeline(resolver, input_hw: tuple[int, int], path: str) -> int:
    """Serialize the resolver's configured uint8 -> uint8 serving program for
    one input-size bucket, weights baked in; returns the artifact's bytes.

    Dispatch as ``SuperResolver.upscale``: mode='split' exports the striped
    split or (with ``split_tile_w``) the 2-D tiled split; mode='fast' the
    whole-frame forward up to ``fast_max_pixels``; otherwise the
    overlapped-tile patch pipeline.  Any forward: the int8 forwards' one-time
    quantized tree is made here and baked in.

    For pre-upscaled-input models (difvdsr) the artifact takes the
    bicubic-upscaled serving input, as the engine's program does, and
    ``input_hw`` is that size.  ``self_ensemble`` is not baked in (a host-side
    x8 wrapper around the program), and is warned about.  ``back_projection``
    is baked in, except for pre-upscaled-input models, whose program input
    is not the LR frame it projects against (warned).
    """
    from image_enhance_keras_tpu_torch.ops.backproject import back_project

    if getattr(resolver, "self_ensemble", False):
        log.warning(
            "export_pipeline: resolver has self_ensemble=True but the artifact is the SINGLE-pass "
            "program — loaded outputs will differ from resolver.upscale (wrap the loaded fn in the x8 "
            "transform average to reproduce it)"
        )
    hw = (int(input_hw[0]), int(input_hw[1]))
    params = resolver._fwd_params()
    if resolver.mode == "split" and resolver._supports_split():
        inner = resolver._split_fn(hw)
    elif resolver.mode == "fast" and hw[0] * hw[1] <= resolver.fast_max_pixels:
        inner = resolver._fast_fn(hw)
    else:
        if resolver.mode == "split":
            log.warning(
                "export_pipeline: %r has no body/tail decomposition — exporting the overlapped-TILE "
                "pipeline (border semantics differ from a whole-frame program)", resolver.model_name,
            )
        elif resolver.mode == "fast":
            log.warning(
                "export_pipeline: %dx%d exceeds fast_max_pixels=%d — exporting the overlapped-TILE "
                "pipeline (border semantics differ from the whole-frame fast program)",
                hw[0], hw[1], resolver.fast_max_pixels,
            )
        inner = resolver._pipeline_for(resolver.plan_for(*hw))

    bp = int(getattr(resolver, "back_projection", 0) or 0)
    if bp and resolver.spec.pre_upscaled_input:
        log.warning(
            "export_pipeline: back_projection=%d is NOT baked in for a pre-upscaled-input model — the "
            "program input is the bicubic-upscaled frame, not the LR frame IBP projects against; apply "
            "IBP against the original LR around the loaded fn", bp,
        )
        bp = 0

    def run(img):
        out = inner(params, img)
        return back_project(out, img, iters=bp) if bp else out

    return _save(run, hw, resolver.device, path)


def _input_device(program) -> torch.device:
    """The device of the program's image input, as it was traced."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == name)
    return node.meta["val"].device


def load_forward(path: str):
    """Load an artifact; returns ``fn(uint8 HWC) -> uint8 HWC`` (numpy in and
    out) on the device it was exported on, with ``fn.program`` the loaded
    ``ExportedProgram``.  Needs torch and the op library only; sets the
    precision switches the engines set (TF32 off).  A file without the magic
    raises ValueError."""
    from image_enhance_keras_tpu_torch.ops.conv import disable_tf32
    from image_enhance_keras_tpu_torch.ops.cuda import library  # noqa: F401 - registers the iek:: ops

    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_MAGIC):
        raise ValueError(f"{path}: not an IEKX artifact")
    program = torch.export.load(io.BytesIO(blob[len(_MAGIC):]))
    module = program.module()
    device = _input_device(program)
    disable_tf32()

    def fn(img):
        x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.uint8)).to(device)
        with torch.inference_mode():
            return module(x).cpu().numpy()

    fn.program = program
    return fn
