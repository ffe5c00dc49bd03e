"""Set5 x4 in the bf16 and mixed profiles, scored from JAX's own forwards on the CPU.

    python3 scripts/eval_bf16_set5_cpu.py [--out EVAL_BF16_CPU.json]

Runs the JAX package's ``SuperResolver(mode="fast", dtype=bfloat16)`` with
the demo weights (``weights_Double/didbl_set5demo.npz``) over ``data_set5``
(ground truths cropped to a multiple of 4, PIL-bicubic degraded by 4, as
``eval.evaluate`` does) for ``--forward xla``, ``pallas`` and
``pallas_chain`` (the Pallas kernels in interpret mode), and the ``xla``
forward under the mixed profiles (``mixed=True``, the CLI's ``--dtype
mixed``; ``mixed="tail"``, ``--dtype mixed-tail``), and scores each
reconstruction under the NTIRE protocol (crop 10) with the exact float32 Y
and with the Y a TPU's default-precision einsum gives: x/255 and the BT.601
row rounded to bf16, summed in float32 (as ``chip_smoke._y_tpu_default``,
which reproduces the recorded rows of ``EVAL_PROFILES.json``).  Writes the
means per forward as JSON: the rows ``chip_smoke.py`` holds the port's bf16
and mixed forwards on the card against.  The recorded ``bf16_fast_5img``,
``mixed_fast_5img`` and ``mixedtail_fast_5img`` rows came from a TPU, whose
bf16 arithmetic is not JAX's on the CPU.  A few minutes on 8 cores;
imports JAX only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

#: row name -> (forward, the engine's ``mixed``): bf16, then the mixed profiles
ROWS = {"xla": ("xla", False), "pallas": ("pallas", False), "pallas_chain": ("pallas_chain", False),
        "xla_mixed": ("xla", True), "xla_mixedtail": ("xla", "tail")}


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from image_enhance_keras_tpu.data.io import imread, list_images
    from image_enhance_keras_tpu.engine import SuperResolver
    from image_enhance_keras_tpu.eval.evaluate import degrade
    from image_enhance_keras_tpu.ops.color import rgb2ycbcr
    from image_enhance_keras_tpu.ops.metrics import psnr_nitre, ssim

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "EVAL_BF16_CPU.json"))
    args = ap.parse_args(argv)
    weights = os.path.join(ROOT, "weights_Double", "didbl_set5demo.npz")

    def y_exact(rgb):
        return rgb2ycbcr(jnp.asarray(rgb))[..., 0]

    def y_tpu_default(rgb):
        x = (rgb.astype(np.float32) / 255.0).astype(jnp.bfloat16).astype(np.float32)
        m = np.array([65.481, 128.553, 24.966], np.float32).astype(jnp.bfloat16).astype(np.float32)
        return jnp.asarray(x[..., 0] * m[0] + x[..., 1] * m[1] + x[..., 2] * m[2] + np.float32(16.0))

    def scores(gt, sr, y):
        g, s = y(gt[10:-10, 10:-10]), y(sr[10:-10, 10:-10])
        return float(psnr_nitre(s, g)), float(ssim(s, g, data_range=255.0))

    pairs = []
    for path in list_images(os.path.join(ROOT, "data_set5")):
        gt = np.asarray(imread(path))
        gt = gt[: gt.shape[0] // 4 * 4, : gt.shape[1] // 4 * 4]
        pairs.append((os.path.basename(path), gt, np.asarray(degrade(gt, 4))))

    out = {"what": "Set5 x4, fast mode, bf16 and mixed profiles, demo weights, JAX on the CPU: per forward "
                   "and profile the mean PSNR-Y / SSIM-Y with the exact float32 Y and with the TPU's "
                   "default-precision Y",
           "script": "scripts/eval_bf16_set5_cpu.py"}
    for key, (forward, mixed) in ROWS.items():
        r = SuperResolver(weights=weights, forward=forward, mode="fast", dtype=jnp.bfloat16, mixed=mixed)
        exact, tpu = [], []
        for name, gt, lr in pairs:
            sr = np.asarray(r.upscale(lr))
            exact.append(scores(gt, sr, y_exact))
            tpu.append(scores(gt, sr, y_tpu_default))
            print(f"jax {key} {name}: {exact[-1]} exact Y, {tpu[-1]} TPU Y", flush=True)
        row = {name: {"psnr_y": float(np.mean([p for p, _ in v])), "ssim_y": float(np.mean([s for _, s in v]))}
               for name, v in (("exact", exact), ("tpu_default_y", tpu))}
        out[f"jax_{key}"] = row
        print(f"jax {key}: {row}", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
