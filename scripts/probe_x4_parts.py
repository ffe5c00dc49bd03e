"""Probe of X4 (``csrc/int8_conv.cu``) on the card: where a launch's time goes.

    python3 scripts/probe_x4_parts.py

Builds the kernel four times from the checkout's source with the port's
nvcc flags: as it is; without its epilogue ("no epilogue": the consumers go
from one column block's products to the next); without its products ("no
products": the consumers wait for the weight tiles and the windows, release
them, and run the epilogue on zero sums); and without both (the producer's
weight stream and window staging alone).  Each is timed (median of 10
CUDA-event pairs around one launch) at difv4's mid shape (9,192,192,256)
and difvdsr's (16,96,96,192) in the five block forms the zoo runs: codes
from codes, codes from bf16 x (quantized while staged), a LightBlock's
conv_b + combine, a DiffBlock's conv_b (t and the codes of d) and conv_d +
combine; inputs from seed 0, the bf16 accumulator.  The variants' outputs
are not held to anything: only the unchanged build is a kernel of the port.
Prints the card's name and power limit first and one JSON line last.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from image_enhance_keras_tpu_torch.ops.cuda import _build, int8_blocks  # noqa: E402
from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k  # noqa: E402

EPILOGUE = "      epilogue<S, NT, DYN>(p, acc, t, nb, s, inv_out, cw);\n"
PRODUCTS = "        for (int j = 0; j < MT; ++j) wgmma_s8<NT>(acc[j], a_hi | ((a + 2 * k * plane + j * dm) >> 4), db);\n"
VARIANTS = {
    "kernel": [],
    "no epilogue": [(EPILOGUE, "")],
    "no products": [(PRODUCTS, "        (void)db;\n")],
    "no products, no epilogue": [(PRODUCTS, "        (void)db;\n"), (EPILOGUE, "")],
}
SHAPES = {"difv4 mid": ((9, 192, 192), 256), "difvdsr": ((16, 96, 96), 192)}


def _build_variants(tmp: str) -> dict:
    src = open(os.path.join(_build.CSRC, "int8_conv.cu")).read()
    procs = {}
    for name, reps in VARIANTS.items():
        s = src
        for a, b in reps:
            if a not in s:
                raise RuntimeError(f"variant {name!r}: the source no longer has {a.strip()!r}")
            s = s.replace(a, b)
        cu, so = os.path.join(tmp, f"v{len(procs)}.cu"), os.path.join(tmp, f"v{len(procs)}.so")
        open(cu, "w").write(s)
        procs[name] = (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{out[-3000:]}")
        lib = ctypes.CDLL(so)
        lib.iek_int8_conv3x.argtypes = _build.SIGNATURES["int8_conv"]["iek_int8_conv3x"]
        libs[name] = lib
    return libs


def _ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _launch(lib, epi, x, wp, sf, bias, s_in=None, s_out=None, xr=None, t=None, out_f=None, out_q=None, out_x=None):
    n, h, w, cin = (int(v) for v in x.shape)
    cout = int(sf.shape[0])

    def ptr(v):
        return None if v is None else v.data_ptr()

    src = 2 if x.dtype == torch.int8 else int(x.dtype == torch.float32)
    code = lib.iek_int8_conv3x(x.data_ptr(), src, ptr(s_in), None, 0, wp.data_ptr(), sf.data_ptr(),
                               bias.data_ptr(), ptr(s_out), ptr(xr), 0, ptr(t), ptr(out_f), ptr(out_q), ptr(out_x),
                               epi, n, h, w, cin, cout, k._nt(cout), 1, 1 if epi == 1 else 0, 0.0,
                               torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"iek_int8_conv3x: CUDA error {code}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_x4_parts needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)
    result = {"gpu": gpu, "ms": {}}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = _build_variants(tmp)
        g = torch.Generator(device="cuda").manual_seed(0)
        with torch.inference_mode():
            for shape_name, ((n, h, w), c) in SHAPES.items():
                x = torch.randn((n, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
                q, sf = int8_blocks.quantize_weights_per_channel(
                    torch.randn((3, 3, c, c), generator=g, device="cuda") * 0.05)
                bias = torch.randn(c, generator=g, device="cuda") * 0.01
                s_in = (x.float().abs().amax(dim=(0, 1, 2)) / 100).contiguous()
                s_out = (s_in * 3).contiguous()
                wp = k.packed(q)
                xq = k.int8_conv3_codes(x, q, sf, bias, s_in, s_out, act="relu")
                t = torch.empty(x.shape, dtype=torch.float32, device="cuda")
                out_q, out_x = torch.empty_like(xq), torch.empty_like(x)
                forms = {
                    "codes from codes": lambda lib: _launch(lib, 1, xq, wp, sf, bias, s_out=s_out, out_q=out_q),
                    "codes from bf16 x": lambda lib: _launch(lib, 1, x, wp, sf, bias, s_in=s_in, s_out=s_out,
                                                             out_q=out_q),
                    "light": lambda lib: _launch(lib, 2, xq, wp, sf, bias, xr=x, out_x=out_x),
                    "diff_b": lambda lib: _launch(lib, 3, xq, wp, sf, bias, s_out=s_out, xr=x, out_f=t, out_q=out_q),
                    "diff_d": lambda lib: _launch(lib, 4, xq, wp, sf, bias, xr=x, t=t, out_x=out_x),
                }
                bound = 2.0 * 9 * c * c * n * h * w / 1979e12 * 1e3
                rows = {}
                for vname, lib in libs.items():
                    rows[vname] = {f: _ms(lambda fn=fn: fn(lib)) for f, fn in forms.items()}
                    print(f"{shape_name} {(n, h, w, c)} -> {c} (operations bound {bound:.4f} ms), {vname}: " +
                          "; ".join(f"{f} {v:.4f} ms" for f, v in rows[vname].items()) + f" on {gpu}", flush=True)
                result["ms"][shape_name] = rows
                del x, xq, t, out_q, out_x
                torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
