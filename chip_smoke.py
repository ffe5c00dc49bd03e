#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its elapsed seconds):
  0. the card's name and power limit; TF32 off;
  1. build the CUDA kernels from ``image_enhance_keras_tpu_torch/csrc``
     (one nvcc per source, all started together);
  2. each kernel at the main paths' shapes against its plain PyTorch
     version, with its time, the plain version's, a library call's where
     one computes the same function, and the card's bound:
       float32 (9 tiles of 96x96x128, demo weights, inputs from the pallas
       path itself): the Light53 and Light blocks (K1, K2);
       int8 path (the demo weights quantized by the port's calibration,
       bf16 inputs from the int8 path itself): the int8 Light53 block at
       (9,96,96,128) and at the tail's (9,384,384,128) (K4), the int8 Light
       block (K5), and the TF1 x4 upsample in bf16 and float32 (K3);
  3. the main paths through ``cli.main_dirpath`` on a seeded 128x128 BMP
     (9 tiles at 96/64/8, 512x512 out), each with its kernel launches
     counted: ``--forward pallas`` (K1, K2), ``--forward xla`` as its
     reference, ``--forward pallas_int8`` (K3, K4, K5; calibration
     included), and the int8 run again with the plain x4 in place of K3
     (byte-equal); then the engines timed in turns and CPU references on a
     crop.
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
#: int8 kernels and the upsample against their plain versions: they repeat
#: the same integer sums and rounded float steps, so they are expected to
#: agree bit for bit; the bound is the CPU tests' (at most 0.1% of values
#: differ, none by more than 1% of max|plain|)
INT8_MAX_FRAC, INT8_MAX_REL = 1e-3, 1e-2
#: uint8 outputs of two int8 forwards (tests/test_split_mode.py:97-98)
INT8_U8_MAX_DIFF, INT8_U8_MAX_FRAC = 3, 0.05
#: H100 SXM data sheet: float32 on the CUDA cores, dense int8 tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
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


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _bound(ops: float, peak_ops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card (ms) and what bounds it."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
    from image_enhance_keras_tpu_torch.models import didbl_pallas
    from image_enhance_keras_tpu_torch.models.didbl_pallas import _conv
    from image_enhance_keras_tpu_torch.models.weights import params_from_numpy
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights
    from image_enhance_keras_tpu_torch.ops.cuda import _build
    from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as ki8
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain, upsample_phase_tf1
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
    del x53, xl, h

    # int8 path: the demo weights quantized by the port's own calibration on
    # the card, the kernels' inputs taken from the int8 path itself
    res8 = SuperResolver(weights=weights, forward="pallas_int8", device="cuda")
    with torch.inference_mode():
        qp = res8._fwd_params()
    print(f"[chip_smoke] int8 calibration source: {res8.int8_calib_source}", flush=True)
    l53_names = ("conv_a1", "conv_a2", "conv_b1", "conv_b2")

    def i8_args(p, convs):
        return [p[c][k] for c in convs for k in ("q", "s", "bias")]

    with torch.inference_mode():
        x8 = torch.relu(_conv(tiles.to(torch.bfloat16), qp["level1"])).contiguous()
        h = x8
        for i in range(16):
            p = qp[f"body53_{i}"]
            h = ki8.light53_int8_plain(h, *i8_args(p, l53_names), p["act"])
        xl8 = h
        for i in range(6):
            p = qp[f"light_{i}"]
            h = ki8.light_int8_plain(h, *i8_args(p, ("conv_a", "conv_b")), p["act"])
        xu8 = h
        xh8 = upsample_phase_plain(xu8, 4).contiguous()
    del tiles, h
    p53, pl8, pt8 = qp["body53_0"], qp["light_0"], qp["tail53_0"]
    i8_specs = [
        # name, kernel call, plain call, input, ops, peak, bytes, iters of the plain timing
        ("light53_int8",
         lambda x: ki8.light53_int8(x, *i8_args(p53, l53_names), act_scales=p53["act"]),
         lambda x: ki8.light53_int8_plain(x, *i8_args(p53, l53_names), p53["act"]),
         x8, 2.0 * 68 * c * c * x8[..., 0].numel(), PEAK_INT8_OPS,
         4.0 * x8.numel() + 68 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:263"),
        ("light_int8",
         lambda x: ki8.light_int8(x, *i8_args(pl8, ("conv_a", "conv_b")), act_scales=pl8["act"]),
         lambda x: ki8.light_int8_plain(x, *i8_args(pl8, ("conv_a", "conv_b")), pl8["act"]),
         xl8, 2.0 * 18 * c * c * xl8[..., 0].numel(), PEAK_INT8_OPS,
         4.0 * xl8.numel() + 18 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:335"),
        ("light53_int8_hr",
         lambda x: ki8.light53_int8(x, *i8_args(pt8, l53_names), act_scales=pt8["act"]),
         lambda x: ki8.light53_int8_plain(x, *i8_args(pt8, l53_names), pt8["act"]),
         xh8, 2.0 * 68 * c * c * xh8[..., 0].numel(), PEAK_INT8_OPS,
         4.0 * xh8.numel() + 68 * c * c, 3,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:263"),
        ("upsample_phase_tf1",
         lambda x: kup.upsample_phase_tf1_kernel(x, 4),
         lambda x: upsample_phase_plain(x, 4),
         xu8, 9.0 * 16 * xu8.numel(), PEAK_F32_FLOPS, 2.0 * 17 * xu8.numel(), MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/upsample.py:94"),
        ("upsample_phase_tf1_f32",
         lambda x: kup.upsample_phase_tf1_kernel(x, 4),
         lambda x: upsample_phase_plain(x, 4),
         xu8.float().contiguous(), 9.0 * 16 * xu8.numel(), PEAK_F32_FLOPS,
         4.0 * 17 * xu8.numel(), MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/upsample.py:94"),
    ]
    i8_rows = {}
    with torch.inference_mode():
        for name, kern, plain, x, ops, peak, nbytes, plain_iters, replaces in i8_specs:
            got, want = kern(x), plain(x)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            err = d.max().item()
            frac = (d > 0).float().mean().item()
            rel = err / max(want.float().abs().max().item(), 1e-30)
            exact = bool(torch.equal(got, want))
            if name.startswith("upsample") and not exact:
                failures.append(f"{name}: kernel not bit-equal to plain (max |diff| {err:.3g})")
            if frac > INT8_MAX_FRAC or rel > INT8_MAX_REL:
                failures.append(f"{name}: kernel vs plain differ on {frac:.3g} of values, "
                                f"max {rel:.3g} of max|plain|")
            ms = _time_ms(lambda: kern(x))
            plain_ms = _time_ms(lambda: plain(x), iters=plain_iters, warmup=1)
            bound_ms, bound_by = _bound(ops, peak, nbytes)
            i8_rows[name] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": err, "bit_equal": exact, "shape": list(x.shape),
                "dtype": str(x.dtype).replace("torch.", ""), "replaces": replaces,
                "tops": ops / (ms * 1e-3) / 1e12,
            }
            print(f"[chip_smoke] {name} {tuple(x.shape)} {x.dtype}: bit-equal {exact}, max |diff| "
                  f"{err:.3g}, {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, {bound_ms:.4f} ms bound "
                  f"({bound_by}), {ops / (ms * 1e-3) / 1e12:.2f} T(FL)OP/s", flush=True)
    del x8, xl8, xu8, xh8
    up32, hr = i8_rows.pop("upsample_phase_tf1_f32"), i8_rows.pop("light53_int8_hr")
    for name, row in i8_rows.items():
        extra = {}
        if name == "light53_int8":
            extra = {f"hr_{k}": hr[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err", "shape")}
        if name == "upsample_phase_tf1":
            extra = {f"f32_{k}": up32[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
        rows.append({
            "name": name, "route": "cuda",
            "source": "image_enhance_keras_tpu_torch/csrc/"
                      + ("upsample.cu" if name.startswith("upsample") else "int8_blocks.cu"),
            "replaces": row["replaces"], "launches": None, "max_abs_err": row["max_abs_err"],
            "tolerance": 0.0 if name.startswith("upsample") else f"{INT8_MAX_FRAC} of values, "
                                                                    f"{INT8_MAX_REL} of max|plain|",
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "shape": row["shape"],
            "dtype": row["dtype"], "bit_equal": row["bit_equal"], **extra,
        })
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
            if row["name"] in launches:
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
        _phase("3a pallas and xla paths (CLI)", t0)

        # the int8 path: calibration, quantization and the forward, all in the
        # CLI run; K3 takes the x4 (one launch in calibration, one per chunk of
        # tiles).  Then the same run with the plain x4 in place of K3, which
        # must give the same bytes (its launches are not the main path's).
        t0 = time.time()
        outs8 = {}
        for up in ("kernel", "plain"):
            d = os.path.join(tmp, f"int8_{up}")
            os.makedirs(d)
            imwrite(os.path.join(d, "img.bmp"), img)
            ki8.light53_int8.launches = 0
            ki8.light_int8.launches = 0
            kup.upsample_phase_tf1_kernel.launches = 0
            if up == "plain":
                didbl_pallas.upsample_phase_tf1 = upsample_phase_plain
            try:
                torch.cuda.synchronize()
                t1 = time.time()
                rc = main_dirpath.main([d, "--forward", "pallas_int8"])
                torch.cuda.synchronize()
                cli_s = time.time() - t1
            finally:
                didbl_pallas.upsample_phase_tf1 = upsample_phase_tf1
            launches8 = {"light53_int8": ki8.light53_int8.launches,
                         "light_int8": ki8.light_int8.launches,
                         "upsample_phase_tf1": kup.upsample_phase_tf1_kernel.launches}
            print(f"[chip_smoke] main_dirpath --forward pallas_int8, {up} x4: rc {rc}, "
                  f"{cli_s:.2f} s (calibration included), launches {launches8}", flush=True)
            want8 = {"light53_int8": 18, "light_int8": 6, "upsample_phase_tf1": 2 if up == "kernel" else 0}
            if rc != 0:
                failures.append(f"main_dirpath --forward pallas_int8 ({up} x4) returned {rc}")
            if launches8 != want8:
                failures.append(f"int8 path launches {launches8} != {want8}")
            if up == "kernel":
                for row in rows:
                    if row["name"] in launches8:
                        row["launches"] = launches8[row["name"]]
            outs8[up] = imread(os.path.join(d, "img_scaled(1x).bmp"))
        out_8 = outs8["kernel"]
        if out_8.shape != (512, 512, 3) or float(out_8.astype(np.float64).std()) < 1.0:
            failures.append(f"int8 output shape {out_8.shape} or flat")
        same8 = bool(np.array_equal(outs8["kernel"], outs8["plain"]))
        if not same8:
            dmax, frac = _u8_agreement(outs8["kernel"], outs8["plain"])
            failures.append(f"int8 outputs with the upsample kernel and with the plain x4 differ: "
                            f"max {dmax}, fraction {frac:.3g}")
        psnr8 = _psnr(out_8, out_p)
        dmax, frac = _u8_agreement(out_8, out_p)
        print(f"[chip_smoke] int8 output byte-equal with the upsample kernel and with the plain x4: "
              f"{same8}; PSNR of int8 against the float32 pallas "
              f"output {psnr8:.2f} dB (max diff {dmax}, differing fraction {frac:.3g})", flush=True)
        if psnr8 < 30.0:
            failures.append(f"int8 output is far from the float32 output: PSNR {psnr8:.2f} dB")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _phase("3a' pallas_int8 path (CLI)", t0)

    # timing of the engine alone (weights loaded once), in turns, and a CPU
    # reference on a crop (plain torch on the CPU, no CUDA kernel involved)
    t0 = time.time()
    res = {f: SuperResolver(weights=weights, forward=f, device="cuda") for f in ("pallas", "xla")}
    res["pallas_int8"] = res8  # weights quantized in phase 2
    secs = {f: [] for f in res}
    for f in ("pallas_int8", "pallas", "xla", "xla", "pallas", "pallas_int8"):
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
    # the int8 forward on the CPU with the card's quantized tree (no CPU
    # calibration at full width)
    cpu8 = SuperResolver(weights=weights, forward="pallas_int8", mode="fast", device="cpu")
    cpu8._qparams = _tree_to(qp, "cpu")
    card8 = SuperResolver(weights=weights, forward="pallas_int8", mode="fast", device="cuda")
    card8._qparams = qp
    dmax, frac = _u8_agreement(card8.upscale(crop), cpu8.upscale(crop))
    print(f"[chip_smoke] fast mode 20x24 crop, card pallas_int8 vs cpu pallas_int8 (card's quantized "
          f"tree): max diff {dmax}, differing fraction {frac:.3g} (bound {INT8_U8_MAX_DIFF} on under "
          f"{INT8_U8_MAX_FRAC})", flush=True)
    if dmax > INT8_U8_MAX_DIFF or frac >= INT8_U8_MAX_FRAC:
        failures.append(f"int8 card vs CPU reference differ: max {dmax}, fraction {frac:.3g}")
    _phase("3b engine timing and CPU references", t0)
    _phase("total", t_all)

    if failures:
        for f in failures:
            print(f"[chip_smoke] FAIL: {f}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": rows, "build_s": build_s, "card": gpu,
                      "int8_calib_source": res8.int8_calib_source, "int8_psnr_vs_f32": psnr8,
                      "engine_s_per_image": {f: min(v) for f, v in secs.items()}}), flush=True)
    print(_gpu_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
