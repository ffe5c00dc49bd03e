"""Set5 x4 in the ``--forward int8`` profile, scored from JAX's own forward on the CPU.

    python3 scripts/eval_int8_set5_cpu.py [--out EVAL_INT8_CPU.json] [--rows default,dyntail,s32acc]

Runs the JAX package's ``SuperResolver(mode="fast", forward="int8")`` with
the demo weights (``weights_Double/didbl_set5demo.npz``), calibrated by the
engine's default (the package-bundled photos), over ``data_set5`` (ground
truths cropped to a multiple of 4, PIL-bicubic degraded by 4, as
``eval.evaluate`` does), in three rows: the default (``IEK_INT8_ACC=bf16``),
``int8_dynamic_tail`` and ``IEK_INT8_ACC=s32``.  Each row runs the forward
op by op (``jax.disable_jit()``: the arithmetic the port follows, the
accumulator rounded by its mode and every product and add rounded on its
own) and jitted (XLA on the CPU folds the accumulator's rounding into the
conv and fuses the dequant into FMAs) on the same quantized tree, and
scores both under the NTIRE protocol (crop 10) with the exact float32 Y and
with the Y a TPU's default-precision einsum gives (x/255 and the BT.601 row
rounded to bf16, summed in float32, as ``chip_smoke._y_tpu_default``).
Writes the means per row as JSON: the op-by-op rows are what
``chip_smoke.py`` holds the port's int8 forward on the card against, the
jitted ones record the standing difference.  The recorded
``int8_fast_5img``, ``int8_fast_dyntail_5img`` and ``int8_fast_s32acc_5img``
rows came from a TPU.  Imports JAX only; about a quarter of an hour on 8
cores (XLA's s32 convolutions on the CPU are slow).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

#: row name -> (IEK_INT8_ACC, the engine's int8_dynamic_tail)
ROWS = {"default": ("bf16", False), "dyntail": ("bf16", True), "s32acc": ("s32", False)}


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
    ap.add_argument("--out", default=os.path.join(ROOT, "EVAL_INT8_CPU.json"))
    ap.add_argument("--rows", default=",".join(ROWS), help="comma-separated subset of " + ", ".join(ROWS))
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

    def means(v):
        return {"psnr_y": float(np.mean([p for p, _ in v])), "ssim_y": float(np.mean([s for _, s in v]))}

    pairs = []
    for path in list_images(os.path.join(ROOT, "data_set5")):
        gt = np.asarray(imread(path))
        gt = gt[: gt.shape[0] // 4 * 4, : gt.shape[1] // 4 * 4]
        pairs.append((os.path.basename(path), gt, np.asarray(degrade(gt, 4))))

    out = {"what": "Set5 x4, fast mode, --forward int8 (calibrated on the package-bundled photos), demo "
                   "weights, JAX on the CPU: per row the mean PSNR-Y / SSIM-Y of the op-by-op forward "
                   "(jax.disable_jit) and of the jitted one on the same quantized tree, with the exact "
                   "float32 Y and with the TPU's default-precision Y, and the share of uint8 values where "
                   "the two forwards differ",
           "script": "scripts/eval_int8_set5_cpu.py"}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out.update({k: v for k, v in json.load(f).items() if k.startswith("jax_int8_")})
    qp = None
    for key in args.rows.split(","):
        acc, dyn = ROWS[key]
        os.environ["IEK_INT8_ACC"] = acc
        r = SuperResolver(weights=weights, forward="int8", mode="fast")
        r.int8_dynamic_tail = dyn
        if qp is None:
            with jax.disable_jit():
                qp = r._fwd_params()
        r._qparams = qp
        res = {"op_by_op": ([], []), "jitted": ([], [])}
        differ = []
        for name, gt, lr in pairs:
            with jax.disable_jit():
                sr = np.asarray(r.upscale(lr))
            srj = np.asarray(r.upscale(lr))
            differ.append(float((sr != srj).mean()))
            for how, img in (("op_by_op", sr), ("jitted", srj)):
                res[how][0].append(scores(gt, img, y_exact))
                res[how][1].append(scores(gt, img, y_tpu_default))
            print(f"jax int8 {key} {name}: op by op {res['op_by_op'][1][-1]}, jitted {res['jitted'][1][-1]} "
                  f"(TPU Y); {differ[-1]:.4f} of the uint8 values differ", flush=True)
        row = {how: {"exact": means(e), "tpu_default_y": means(t)} for how, (e, t) in res.items()}
        row["u8_differing_op_by_op_vs_jitted"] = float(np.mean(differ))
        out[f"jax_int8_{key}"] = row
        print(f"jax int8 {key}: {row}", flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    os.environ.pop("IEK_INT8_ACC", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
