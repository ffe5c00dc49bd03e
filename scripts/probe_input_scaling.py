"""How many output bytes the engines' input scaling moves on the card.

    python3 scripts/probe_input_scaling.py [--size 128]

The engines scale uint8 inputs to [0, 1] with ``ops.color.im2double``,
which divides by a tensor as JAX divides.  A division by the Python
scalar 255.0 on a CUDA tensor is a product with its float32 reciprocal,
one ulp off the quotient for 126 of the 256 uint8 values.  This script
counts those values, then upscales one seeded image with each model's
demo checkpoint through ``--forward xla`` and ``--forward int8`` (fast
mode), once with ``im2double`` and once with the scalar division patched
in, and prints how many uint8 output values differ.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    import numpy as np
    import torch

    import image_enhance_keras_tpu_torch.engine as eng
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights
    from image_enhance_keras_tpu_torch.ops.color import im2double

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("this probe needs a CUDA card", file=sys.stderr)
        return 1
    v = torch.arange(256, dtype=torch.uint8, device="cuda")
    scalar = v.float() / 255.0
    print(f"card: {torch.cuda.get_device_name(0)}; uint8 values whose x / 255.0 differs from im2double: "
          f"{int((scalar != im2double(v)).sum())} of 256; differing from the CPU's quotient: "
          f"{int((scalar.cpu() != torch.arange(256).float() / 255.0).sum())}")
    img = np.random.default_rng(0).integers(0, 256, (args.size, args.size, 3), dtype=np.uint8)
    for model in ("didbl", "didbl_subpixel", "difv4", "difvdsr"):
        weights = resolve_default_weights(MODEL_REGISTRY[model])
        for forward in ("xla", "int8"):
            r = eng.SuperResolver(model=model, weights=weights, forward=forward, mode="fast", device="cuda")
            got = r.upscale(img)
            eng.im2double = lambda x: x.to(torch.float32) / 255.0
            try:
                old = r.upscale(img)
            finally:
                eng.im2double = im2double
            d = np.abs(got.astype(np.int16) - old.astype(np.int16))
            print(f"{model} --forward {forward}, {args.size}x{args.size} fast: {int((d > 0).sum())} of {d.size} "
                  f"uint8 values moved by the division (max {int(d.max())})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
