"""Set5 x4 of the rest of the zoo in the ``--forward int8`` profile, scored from JAX's own forward on the CPU.

    python3 scripts/eval_zoo_int8_set5_cpu.py [--out EVAL_ZOO_INT8_CPU.json] [--models didbl_subpixel,difv4,difvdsr] [--n 2]

For each model, the JAX package's ``SuperResolver(model, mode="fast")``
with its committed demo checkpoint, over the first ``--n`` images of
``data_set5`` (ground truths cropped to a multiple of 4, PIL-bicubic
degraded by 4, as ``eval.evaluate`` does): the float32 forward (jitted),
and ``forward="int8"`` calibrated by the engine's default (the
package-bundled photos), run op by op (``jax.disable_jit()``: the
arithmetic the port follows, the accumulator rounded by ``IEK_INT8_ACC``,
bf16 here, and every product and add rounded on its own).  Each row is
scored under the NTIRE protocol (crop 10) with the exact float32 Y and with
the Y a TPU's default-precision einsum gives (``chip_smoke._y_tpu_default``),
with per-image scores.  ``chip_smoke.py`` holds the port's zoo forwards on
the card against these rows.  Imports JAX only; XLA's s32 convolutions on
the CPU are slow: tens of minutes a model at full width.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

MODELS = ("didbl_subpixel", "difv4", "difvdsr")


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from image_enhance_keras_tpu.data.io import imread, list_images
    from image_enhance_keras_tpu.engine import SuperResolver
    from image_enhance_keras_tpu.eval.evaluate import degrade
    from image_enhance_keras_tpu.models.zoo import MODEL_REGISTRY
    from image_enhance_keras_tpu.ops.color import rgb2ycbcr
    from image_enhance_keras_tpu.ops.metrics import psnr_nitre, ssim

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "EVAL_ZOO_INT8_CPU.json"))
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--n", type=int, default=2, help="the first N Set5 images")
    args = ap.parse_args(argv)

    def y_exact(rgb):
        return rgb2ycbcr(jnp.asarray(rgb))[..., 0]

    def y_tpu_default(rgb):
        x = (rgb.astype(np.float32) / 255.0).astype(jnp.bfloat16).astype(np.float32)
        m = np.array([65.481, 128.553, 24.966], np.float32).astype(jnp.bfloat16).astype(np.float32)
        return jnp.asarray(x[..., 0] * m[0] + x[..., 1] * m[1] + x[..., 2] * m[2] + np.float32(16.0))

    def scores(gt, sr, y):
        g, s = y(gt[10:-10, 10:-10]), y(sr[10:-10, 10:-10])
        return float(psnr_nitre(s, g)), float(ssim(s, g, data_range=255.0))

    def means(v):
        return {"psnr_y": float(np.mean([p for p, _ in v])), "ssim_y": float(np.mean([s for _, s in v]))}

    pairs = []
    for path in [p for p in list_images(os.path.join(ROOT, "data_set5")) if "scaled" not in p][: args.n]:
        gt = np.asarray(imread(path))
        gt = gt[: gt.shape[0] // 4 * 4, : gt.shape[1] // 4 * 4]
        pairs.append((os.path.basename(path), gt, np.asarray(degrade(gt, 4))))

    out = {"what": f"Set5 x4 (the first {args.n} images), fast mode, demo checkpoints, JAX on the CPU: the "
                   "float32 forward (jitted) and --forward int8 (calibrated on the package-bundled photos, "
                   "IEK_INT8_ACC=bf16) run op by op (jax.disable_jit), mean and per-image PSNR-Y / SSIM-Y "
                   "with the exact float32 Y and with the TPU's default-precision Y",
           "script": "scripts/eval_zoo_int8_set5_cpu.py", "images": [n for n, _, _ in pairs]}
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        if prev.get("images") == out["images"]:
            out.update({k: v for k, v in prev.items() if k in MODELS})
    os.environ["IEK_INT8_ACC"] = "bf16"
    for model in args.models.split(","):
        weights = os.path.join(ROOT, MODEL_REGISTRY[model].default_weights)
        row = {}
        for forward in ("xla", "int8"):
            t0 = time.time()
            r = SuperResolver(model=model, weights=weights, forward=forward, mode="fast")
            if forward == "int8":
                with jax.disable_jit():
                    r._qparams = r._fwd_params()
            ex, tp, per = [], [], {}
            for name, gt, lr in pairs:
                if forward == "int8":
                    with jax.disable_jit():
                        sr = np.asarray(r.upscale(lr))
                else:
                    sr = np.asarray(r.upscale(lr))
                ex.append(scores(gt, sr, y_exact))
                tp.append(scores(gt, sr, y_tpu_default))
                per[name] = {"exact": ex[-1], "tpu_default_y": tp[-1]}
                print(f"jax {model} {forward} {name}: {ex[-1]} (exact Y), {time.time() - t0:.0f} s", flush=True)
            row[forward] = {"exact": means(ex), "tpu_default_y": means(tp), "per_image": per,
                            "seconds": time.time() - t0}
        out[model] = row
        print(f"jax {model}: {json.dumps({k: v['exact'] for k, v in row.items()})}", flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    os.environ.pop("IEK_INT8_ACC", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
