"""Probe of the block and chain kernels' conv tile on the card: offsets, error, time.

    python3 scripts/probe_tf32x3.py

Builds ``scripts/probe_tf32x3.cu`` (one SAME conv on
``image_enhance_keras_tpu_torch/csrc/conv_tf32x3.cuh``) with the port's nvcc
flags and runs a 3x3 and a 5x5 conv, C = 128, at (1,96,96,128) and
(9,96,96,128), on signed inputs and on relu'd ones (as the chain's second
convs see), weights He-scaled, all from seed 0.  For each it prints the
largest distance from the float64 convolution of: cuDNN's float32
``F.conv2d`` (TF32 off), the split alone (hi and lo operands, lo*lo dropped,
summed in float64), the tile's conv (each step's wgmma sum added with
rounded float32 adds) and the same products summed by the tensor cores
alone; and at (9,96,96,128) the time of each (median of 12 per-call
CUDA-event pairs) beside the 3xTF32 bound.  Then the same convs on bf16
activations under the tile's bf16 policy (weights cast to bf16): the largest
and mean distance from the float64 convolution of the bf16 values, and the
share of sums that round to another bf16 value than the float64 sum's, for
cuDNN's float32 ``F.conv2d`` of the bf16 values (TF32 off), the plain
versions' per-tap float32 sums (``bf16.conv_exact``), the tile's conv (each
tap's wgmma sum added with rounded float32 adds) and the tensor cores
summing the whole conv; and at (9,96,96,128) the times beside the bf16
bound and cuDNN's bf16 ``F.conv2d``.  Prints the card's name and power
limit first and one JSON line last.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from image_enhance_keras_tpu_torch.ops.cuda import _build, bf16, tf32x3  # noqa: E402

PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12


def _build_probe() -> ctypes.CDLL:
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libprobe_tf32x3.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, os.path.join(HERE, "probe_tf32x3.cu")],
                          capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"nvcc: {line.strip()}", flush=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on scripts/probe_tf32x3.cu:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.probe_conv.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.probe_conv_bf16.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.probe_error_string.argtypes = [ctypes.c_int]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def _conv(x, w):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=w.shape[0] // 2).permute(0, 2, 3, 1)


def _time_ms(fn, iters: int = 12) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_tf32x3: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    lib = _build_probe()
    rng = np.random.default_rng(0)
    rows = []
    for kind in ("signed", "relu"):
        for shape in ((1, 96, 96, 128), (9, 96, 96, 128)):
            for k in (3, 5):
                x = rng.normal(0.0, 0.5, shape).astype(np.float32)
                if kind == "relu":
                    x = np.maximum(x, 0.0) * 2.0
                w = (rng.normal(size=(k, k, 128, 128)) * (2.0 / (k * k * 128)) ** 0.5).astype(np.float32)
                xt, wt = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
                packed = tf32x3.packed(wt)
                ref = _conv(xt.double(), wt.double())
                xh, xl = tf32x3.split_tf32(xt)
                wh, wl = tf32x3.split_tf32(wt)
                xl, wl = tf32x3.round_tf32(xl), tf32x3.round_tf32(wl)
                split = (_conv(xl.double(), wh.double()) + _conv(xh.double(), wl.double())
                         + _conv(xh.double(), wh.double()))
                row = {"input": kind, "shape": list(shape), "k": k,
                       "plain_err": (_conv(xt, wt).double() - ref).abs().max().item(),
                       "split_err": (split - ref).abs().max().item()}
                out = torch.empty_like(xt)

                def run(promoted):
                    code = lib.probe_conv(xt.data_ptr(), packed.data_ptr(), out.data_ptr(), *shape[:3], k,
                                          int(promoted), torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(lib.probe_error_string(code).decode())

                for name, promoted in (("tile", True), ("unpromoted", False)):
                    run(promoted)
                    torch.cuda.synchronize()
                    d = out.double() - ref
                    row[f"{name}_err"] = d.abs().max().item()
                    row[f"{name}_mean_err"] = d.mean().item()
                    if shape[0] == 9:
                        row[f"{name}_ms"] = _time_ms(lambda: run(promoted))
                if shape[0] == 9:
                    row["plain_ms"] = _time_ms(lambda: _conv(xt, wt))
                    row["bound_ms"] = 3 * 2.0 * k * k * 128 * 128 * 9 * 96 * 96 / PEAK_TF32_FLOPS * 1e3
                rows.append(row)
                print(" ".join(f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
                               for key, val in row.items()), flush=True)
    bf16_rows = _probe_bf16(lib, rng)
    print(json.dumps({"probe_tf32x3": rows, "probe_bf16": bf16_rows}), flush=True)
    return 0


def _probe_bf16(lib, rng) -> list:
    """The tile's bf16 policy: each tap's products summed by the tensor cores
    and added with rounded float32 adds, or the whole conv summed there."""
    rows = []
    for kind in ("signed", "relu"):
        for shape in ((1, 96, 96, 128), (9, 96, 96, 128)):
            for k in (3, 5):
                x = rng.normal(0.0, 0.5, shape).astype(np.float32)
                if kind == "relu":
                    x = np.maximum(x, 0.0) * 2.0
                w = (rng.normal(size=(k, k, 128, 128)) / np.sqrt(k * k * 128)).astype(np.float32)
                xb, wt = torch.from_numpy(x).cuda().to(torch.bfloat16), torch.from_numpy(w).cuda()
                packed = bf16.packed(wt)
                ref = bf16.conv_exact(xb, wt, torch.float64).double()
                ref16 = ref.to(torch.bfloat16)

                def stats(name, y):
                    d = y.double() - ref
                    row[f"{name}_err"] = d.abs().max().item()
                    row[f"{name}_mean_abs_err"] = d.abs().mean().item()
                    row[f"{name}_bf16_flips"] = (y.to(torch.bfloat16) != ref16).float().mean().item()

                row = {"input": kind, "shape": list(shape), "k": k}
                stats("cudnn_f32", _conv(xb.float(), wt.to(torch.bfloat16).float()))
                stats("plain", bf16.conv_exact(xb, wt))
                out = torch.empty(shape, dtype=torch.float32, device="cuda")

                def run(promoted):
                    code = lib.probe_conv_bf16(xb.data_ptr(), packed.data_ptr(), out.data_ptr(), *shape[:3], k,
                                               int(promoted), torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(lib.probe_error_string(code).decode())

                for name, promoted in (("tile", True), ("unpromoted", False)):
                    run(promoted)
                    torch.cuda.synchronize()
                    stats(name, out)
                    if shape[0] == 9:
                        row[f"{name}_ms"] = _time_ms(lambda: run(promoted))
                if shape[0] == 9:
                    wb = wt.to(torch.bfloat16)
                    row["cudnn_bf16_ms"] = _time_ms(lambda: _conv(xb, wb))
                    row["bound_ms"] = 2.0 * k * k * 128 * 128 * 9 * 96 * 96 / PEAK_BF16_FLOPS * 1e3
                rows.append(row)
                print("bf16 " + " ".join(f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
                                         for key, val in row.items()), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
