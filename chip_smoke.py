#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its elapsed seconds):
  0. the card's name and power limit; TF32 off;
  1. build the CUDA kernels from ``image_enhance_keras_tpu_torch/csrc``;
  2. each kernel at the main path's shape (9 tiles of 96x96x128, float32,
     demo weights, inputs taken from the main path itself) against its plain
     PyTorch version, with its time, the plain version's, one F.conv2d
     formulation's and the card's bound;
  3. the main path: ``cli.main_dirpath`` with ``--forward pallas`` on a
     seeded 128x128 BMP (9 tiles at 96/64/8, 512x512 out), with the kernel
     launches counted, then ``--forward xla`` and a CPU run on a crop as
     references.
Prints the kernels as one JSON line, then the card's name and power limit,
then the ``{"ok": true, ...}`` line last.  Exits non-zero, before printing
any of those, when CUDA is missing, the package is not beside this script,
or any check fails.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SHAPE = (9, 96, 96, 128)
#: kernel vs plain version on the card: float32 sums over 128*68 terms in
#: another order, on activations of order 1-10
KERNEL_ATOL = 2e-5
#: uint8 outputs of two float32 forwards that sum in other orders
U8_MAX_DIFF = 1
U8_MAX_FRAC = 1e-3
#: H100 SXM data sheet: float32 on the CUDA cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
MIN_TIMED = 12


def _phase(name: str, t0: float) -> None:
    print(f"[chip_smoke] {name}: {time.time() - t0:.2f} s", flush=True)


def _gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _time_ms(fn, iters: int = MIN_TIMED, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _seeded_image(h: int, w: int, seed: int):
    """Smooth colour gradients and stripes plus noise, uint8 RGB."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 40 + 170 * xx / max(w - 1, 1)
    g = 40 + 170 * yy / max(h - 1, 1)
    b = 128 + 90 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    img = np.stack([r, g, b], axis=-1) + rng.normal(0.0, 12.0, (h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _u8_agreement(a, b) -> tuple[int, float]:
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch.nn.functional as F

    from image_enhance_keras_tpu_torch.cli import main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread, imwrite
    from image_enhance_keras_tpu_torch.engine import SuperResolver, disable_tf32
    from image_enhance_keras_tpu_torch.models.didbl_pallas import _conv
    from image_enhance_keras_tpu_torch.models.weights import params_from_numpy
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights
    from image_enhance_keras_tpu_torch.ops.cuda import _build
    from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
    from image_enhance_keras_tpu_torch.tiling.tiles import extract_tiles, pad_to_plan, plan_tiles
    from image_enhance_keras_tpu_torch.train.checkpoints import load_params_npz

    failures: list[str] = []
    t_all = time.time()

    # -- 0. the card -------------------------------------------------------
    t0 = time.time()
    gpu = _gpu_name_power()
    kind = torch.cuda.get_device_name(0)
    disable_tf32()
    print(f"[chip_smoke] card: {gpu} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)
    _phase("0 card", t0)

    # -- 1. build ----------------------------------------------------------
    t0 = time.time()
    _build.build_all()
    for stem, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[chip_smoke] nvcc {stem}: {line.strip()}", flush=True)
    build_s = time.time() - t0
    _phase(f"1 build ({build_s:.2f} s)", t0)

    # -- 2. kernels against their plain versions ------------------------------
    t0 = time.time()
    dev = torch.device("cuda")
    weights = resolve_default_weights(MODEL_REGISTRY["didbl"])
    params = params_from_numpy(load_params_npz(weights), dev)
    img = _seeded_image(128, 128, SEED)
    plan = plan_tiles(128, 128, patch=96, step=64, scale=4, crop=8)
    with torch.inference_mode():
        tiles = extract_tiles(pad_to_plan(torch.from_numpy(img).to(dev).float(), plan), plan) / 255.0
        x53 = torch.relu(_conv(tiles, params["level1"])).contiguous()
        h = x53
        for i in range(16):
            p = params[f"body53_{i}"]
            h = kb.light53_block_plain(h, *(p[c][k] for c in ("conv_a1", "conv_a2", "conv_b1", "conv_b2")
                                            for k in ("kernel", "bias")))
        xl = h.contiguous()
    if tuple(x53.shape) != SHAPE:
        failures.append(f"main-path block input shape {tuple(x53.shape)} != {SHAPE}")
    print(f"[chip_smoke] block inputs: light53 max|x|={x53.abs().max().item():.4g}, "
          f"light max|x|={xl.abs().max().item():.4g}", flush=True)

    p53, pl = params["body53_0"], params["light_0"]
    a53 = [p53[c][k] for c in ("conv_a1", "conv_a2", "conv_b1", "conv_b2") for k in ("kernel", "bias")]
    al = [pl[c][k] for c in ("conv_a", "conv_b") for k in ("kernel", "bias")]

    def oihw(w):
        return w.permute(3, 2, 0, 1).contiguous()

    def lib53(xc, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2):
        a = F.conv2d(F.relu(F.conv2d(xc, wa1, ba1, padding=1)), wa2, ba2, padding=2)
        b = F.conv2d(F.relu(F.conv2d(xc, wb1, bb1, padding=2)), wb2, bb2, padding=1)
        return 0.9 * xc + 0.1 * (a + b)

    def libl(xc, w1, b1, w2, b2):
        return xc + 0.1 * F.conv2d(F.relu(F.conv2d(xc, w1, b1, padding=1)), w2, b2, padding=1)

    n, hh, ww, c = SHAPE
    specs = [
        ("light53_block", kb.fused_light53_block, kb.light53_block_plain, lib53, x53, a53, 68,
         "image_enhance_keras_tpu/ops/pallas/blocks.py:181"),
        ("light_block", kb.fused_light_block, kb.light_block_plain, libl, xl, al, 18,
         "image_enhance_keras_tpu/ops/pallas/blocks.py:154"),
    ]
    rows = []
    with torch.inference_mode():
        for name, kern, plain, lib, x, args, taps, replaces in specs:
            got = kern(x, *args)
            want = plain(x, *args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not (err <= KERNEL_ATOL):
                failures.append(f"{name}: max |kernel - plain| = {err:.3g} > {KERNEL_ATOL}")
            ms = _time_ms(lambda: kern(x, *args))
            plain_ms = _time_ms(lambda: plain(x, *args))
            xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
            largs = [oihw(a) if a.dim() == 4 else a for a in args]
            lib_out = lib(xc, *largs).permute(0, 2, 3, 1)
            lib_err = (lib_out - want).abs().max().item()
            library_ms = _time_ms(lambda: lib(xc, *largs))
            flops = 2.0 * taps * c * c * n * hh * ww
            nbytes = 4.0 * (2 * x.numel() + sum(a.numel() for a in args))
            t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
            rows.append({
                "name": name, "route": "cuda",
                "source": "image_enhance_keras_tpu_torch/csrc/blocks.cu",
                "replaces": replaces, "launches": None, "max_abs_err": err,
                "tolerance": KERNEL_ATOL, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": library_ms,
                "tflops": flops / (ms * 1e-3) / 1e12,
            })
            print(f"[chip_smoke] {name}: err {err:.3g} (F.conv2d formulation vs plain {lib_err:.3g}), "
                  f"{ms:.3f} ms kernel, {plain_ms:.3f} ms plain, {library_ms:.3f} ms F.conv2d, "
                  f"{rows[-1]['bound_ms']:.3f} ms bound, {rows[-1]['tflops']:.2f} TFLOP/s", flush=True)
    del x53, xl, h, tiles
    _phase("2 kernels", t0)

    # -- 3. the main path ----------------------------------------------------
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_")
    try:
        dirs = {f: os.path.join(tmp, f) for f in ("pallas", "xla")}
        for d in dirs.values():
            os.makedirs(d)
            imwrite(os.path.join(d, "img.bmp"), img)
        kb.fused_light53_block.launches = 0
        kb.fused_light_block.launches = 0
        torch.cuda.synchronize()
        t1 = time.time()
        rc = main_dirpath.main([dirs["pallas"], "--forward", "pallas"])
        torch.cuda.synchronize()
        cli_s = time.time() - t1
        launches = {"light53_block": kb.fused_light53_block.launches,
                    "light_block": kb.fused_light_block.launches}
        print(f"[chip_smoke] main_dirpath --forward pallas: rc {rc}, {cli_s:.2f} s, launches {launches}",
              flush=True)
        for row in rows:
            row["launches"] = launches[row["name"]]
        if rc != 0:
            failures.append(f"main_dirpath --forward pallas returned {rc}")
        if launches != {"light53_block": 16, "light_block": 6}:
            failures.append(f"kernel launches on the main path {launches} != 16 Light53 + 6 Light")
        out_p = imread(os.path.join(dirs["pallas"], "img_scaled(1x).bmp"))
        if out_p.shape != (512, 512, 3):
            failures.append(f"pallas output shape {out_p.shape} != (512, 512, 3)")

        rc = main_dirpath.main([dirs["xla"], "--forward", "xla", "--suffix", "xla"])
        out_x = imread(os.path.join(dirs["xla"], "img_xla(1x).bmp"))
        if rc != 0 or out_x.shape != out_p.shape:
            failures.append(f"main_dirpath --forward xla: rc {rc}, shape {out_x.shape}")
        else:
            dmax, frac = _u8_agreement(out_p, out_x)
            print(f"[chip_smoke] pallas vs xla uint8: max diff {dmax}, differing fraction {frac:.3g} "
                  f"(bound {U8_MAX_DIFF} on {U8_MAX_FRAC})", flush=True)
            if dmax > U8_MAX_DIFF or frac > U8_MAX_FRAC:
                failures.append(f"pallas vs xla outputs differ: max {dmax}, fraction {frac:.3g}")
        if float(out_p.astype(np.float64).std()) < 1.0:
            failures.append("pallas output is flat")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _phase("3a main path (CLI)", t0)

    # timing of the engine alone (weights loaded once), in turns, and a CPU
    # reference on a crop (plain torch on the CPU, no CUDA kernel involved)
    t0 = time.time()
    res = {f: SuperResolver(weights=weights, forward=f, device="cuda") for f in ("pallas", "xla")}
    secs = {"pallas": [], "xla": []}
    for f in ("pallas", "xla", "xla", "pallas"):
        torch.cuda.synchronize()
        t1 = time.time()
        res[f].upscale(img)
        torch.cuda.synchronize()
        secs[f].append(time.time() - t1)
    mpix = 512 * 512 / 1e6
    for f, s in secs.items():
        print(f"[chip_smoke] engine --forward {f}, 128x128 -> 512x512 patch mode: "
              f"{min(s):.3f} s, {mpix / min(s):.3f} out-Mpix/s on {gpu}", flush=True)
    crop = np.ascontiguousarray(img[:20, :24])
    ref = SuperResolver(weights=weights, forward="xla", mode="fast", device="cpu").upscale(crop)
    got = SuperResolver(weights=weights, forward="pallas", mode="fast", device="cuda").upscale(crop)
    dmax, frac = _u8_agreement(got, ref)
    print(f"[chip_smoke] fast mode 20x24 crop, card pallas vs cpu xla: max diff {dmax}, "
          f"differing fraction {frac:.3g}", flush=True)
    if dmax > U8_MAX_DIFF or frac > U8_MAX_FRAC:
        failures.append(f"card vs CPU reference differ: max {dmax}, fraction {frac:.3g}")
    _phase("3b engine timing and CPU reference", t0)
    _phase("total", t_all)

    if failures:
        for f in failures:
            print(f"[chip_smoke] FAIL: {f}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": rows, "build_s": build_s, "card": gpu}), flush=True)
    print(_gpu_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
