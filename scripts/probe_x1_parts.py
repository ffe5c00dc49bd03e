"""Probe of X1 (``xla_block_kernel`` in ``csrc/int8_conv.cu``) on the card: where its launches' time goes.

    python3 scripts/probe_x1_parts.py [--parent DIR]

X1, the ``--forward int8`` static Light53 block, is two launches: the codes
launch (both first convs over one staged window of bf16 x, the branch codes
out) and the light53 launch (both second convs per 64 output channels, the
combine).  This script builds ``csrc/int8_conv.cu`` from the checkout with
the port's nvcc flags in four forms: as it is; without its epilogues ("no
epilogue": no codes and no combine leave the registers); without its
products ("no products": the consumers wait for the weight tiles and the
windows, release them, and run the epilogues on zero sums); and without both
(the producer's weight stream and window staging alone).  Each form is also
built with only its codes launch and with only its light53 launch, so that
every cell is one launch.  Each is timed by 20 calls queued behind a spin
kernel between two CUDA events (device ms a call) at the LR shape
(9,96,96,128) and the HR shape (9,384,384,128), inputs from seed 0 at the
scales of tests/test_torch_cuda.py, the bf16 accumulator.  The variants'
outputs are not held to anything: only the unchanged build is a kernel of
the port, and the script checks it bit-equal to ``light53_int8_xla_plain``.

``--parent DIR``: a checkout (or ``git archive``) of an earlier commit whose
``image_enhance_keras_tpu_torch/csrc/int8_blocks.cu`` still holds X1 and X2
as C entries (``iek_light53_int8_xla``, ``iek_light_int8_xla``, K4/K5's
weight pack): their device ms are timed the same way on the same inputs,
beside X1's and X2's of this checkout.

Prints the card's name and power limit first and one JSON line last.  Needs
a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from image_enhance_keras_tpu_torch.ops.cuda import _build, int8_blocks, int8_conv, int8_xla  # noqa: E402

C = 128
EPILOGUES = [
    ("      xla_codes<E>(p, acc, t, cw, dq, dq + X_C, inv_a, p.out_q);\n", ""),
    ("      xla_codes<E>(p, acc, t, cw, dq + 2 * X_C, dq + 3 * X_C, inv_b, p.out_q2);\n", ""),
    ("        if (p.acc_bf16) xla_combine<NT, E, true, true>(p, acc_a, acc_b, xv, dq, t, cw, nb);\n"
     "        else xla_combine<NT, E, false, true>(p, acc_a, acc_b, xv, dq, t, cw, nb);\n", ""),
]
PRODUCTS = [("        for (int j = 0; j < MT; ++j) wgmma_s8<NT>(acc[j], a_hi | ((a + 2 * k * plane + j * dm) >> 4), db);\n",
             "        (void)db;\n")]
PARTS = {"kernel": [], "no epilogue": EPILOGUES, "no products": PRODUCTS, "no products, no epilogue": PRODUCTS + EPILOGUES}
LAUNCHES = {"codes": [("  return launch_xla<PAIR_LIGHT53>(b, st);\n", "  return 0;\n")],
            "light53": [("  const int code = launch_xla<PAIR_CODES>(a, st);\n", "  const int code = 0;\n")],
            "both": []}
SHAPES = {"LR": (9, 96, 96), "HR": (9, 384, 384)}


def _compile(src: str, path: str) -> subprocess.Popen:
    open(path + ".cu", "w").write(src)
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", path + ".so", path + ".cu"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _build_variants(tmp: str, parent: str | None) -> dict:
    src = open(os.path.join(_build.CSRC, "int8_conv.cu")).read()
    procs = {}
    for part, reps in PARTS.items():
        for launch, lreps in LAUNCHES.items():
            s = src
            for a, b in reps + lreps:
                if a not in s:
                    raise RuntimeError(f"variant {part!r} / {launch!r}: the source no longer has {a.strip()!r}")
                s = s.replace(a, b)
            procs[(part, launch)] = _compile(s, os.path.join(tmp, f"v{len(procs)}"))
    if parent is not None:
        procs[("parent", "both")] = _compile(
            open(os.path.join(parent, "image_enhance_keras_tpu_torch", "csrc", "int8_blocks.cu")).read(),
            os.path.join(tmp, "parent"))
    libs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {key}:\n{out[-3000:]}")
        lib = ctypes.CDLL(proc.args[-1][:-3] + ".so")
        if key[0] == "parent":
            lib.iek_light53_int8_xla.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [
                ctypes.c_void_p]
            lib.iek_light_int8_xla.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                                             ctypes.c_void_p]
        else:
            lib.iek_light53_int8_xla.argtypes = _build.SIGNATURES["int8_conv"]["iek_light53_int8_xla"]
        libs[key] = lib
    return libs


def _queued_ms(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _inputs(shape, kernels, seed: int):
    """bf16 x, per conv (int8 weights, float32 "sf", bias), (len(act), C) scales."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, C)).astype(np.float32) * np.exp(rng.normal(size=C)).astype(np.float32) * 0.3
    x = torch.from_numpy(x).cuda().to(torch.bfloat16)
    convs = []
    for k in kernels:
        q, s = int8_blocks.quantize_weights_per_channel(
            torch.from_numpy((rng.normal(size=(k, k, C, C)) * 0.05).astype(np.float32)).cuda())
        convs += [q, s, torch.from_numpy((rng.normal(size=C) * 0.01).astype(np.float32)).cuda()]
    rows = [x.float().abs().amax(dim=(0, 1, 2)) / 100.0]
    rows += [torch.from_numpy((0.02 + 0.03 * rng.random(C)).astype(np.float32)).cuda() for _ in kernels[1::2]]
    return x, convs, torch.stack(rows).contiguous()


def _x1_call(lib, x, convs, act):
    """One call of X1's C entry in lib on this checkout's weight pack."""
    wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2 = convs
    packs = [int8_conv.packed(wa1, 128), sa1, ba1, int8_conv.packed(wa2, 64), sa2, ba2,
             int8_conv.packed(wb1, 128), sb1, bb1, int8_conv.packed(wb2, 64), sb2, bb2]
    ta = torch.empty(x.shape, dtype=torch.int8, device="cuda")
    tb, out = torch.empty_like(ta), torch.empty_like(x)
    n, h, w, c = (int(v) for v in x.shape)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        code = lib.iek_light53_int8_xla(x.data_ptr(), act.data_ptr(), *(t.data_ptr() for t in packs), ta.data_ptr(),
                                        tb.data_ptr(), out.data_ptr(), n, h, w, c, 1, 0.1, 0.9, stream)
        if code != 0:
            raise RuntimeError(f"iek_light53_int8_xla: CUDA error {code}")
        return out

    return run


def _parent_calls(lib, x, convs53, act53, convs, act):
    """The parent's X1 and X2 C entries (K4/K5's weight pack)."""
    n, h, w, c = (int(v) for v in x.shape)
    stream = torch.cuda.current_stream().cuda_stream
    p53 = [int8_blocks._packed(t) if t.dtype == torch.int8 else t for t in convs53]
    p2 = [int8_blocks._packed(t) if t.dtype == torch.int8 else t for t in convs]
    ta = torch.empty(x.shape, dtype=torch.int8, device="cuda")
    tb, out53, out2 = torch.empty_like(ta), torch.empty_like(x), torch.empty_like(x)

    def x1():
        code = lib.iek_light53_int8_xla(x.data_ptr(), act53.data_ptr(), *(t.data_ptr() for t in p53), ta.data_ptr(),
                                        tb.data_ptr(), out53.data_ptr(), n, h, w, c, 1, 0.1, 0.9, stream)
        if code != 0:
            raise RuntimeError(f"parent iek_light53_int8_xla: CUDA error {code}")
        return out53

    def x2():
        code = lib.iek_light_int8_xla(x.data_ptr(), act.data_ptr(), *(t.data_ptr() for t in p2), ta.data_ptr(),
                                      out2.data_ptr(), n, h, w, c, 1, 0.1, stream)
        if code != 0:
            raise RuntimeError(f"parent iek_light_int8_xla: CUDA error {code}")
        return out2

    return x1, x2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit whose int8_blocks.cu holds X1 and X2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_x1_parts needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)
    result = {"gpu": gpu, "ms": {}, "bound_ms": {}}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = _build_variants(tmp, args.parent)
        with torch.inference_mode():
            for shape_name, shape in SHAPES.items():
                x, convs53, act53 = _inputs(shape, (3, 5, 5, 3), 0)
                got = _x1_call(libs[("kernel", "both")], x, convs53, act53)()
                want = int8_xla.light53_int8_xla_plain(x, *convs53, act53, acc="bf16")
                if not torch.equal(got, want):
                    raise RuntimeError(f"X1 at {shape}: the kernel is not bit-equal to light53_int8_xla_plain")
                n, h, w = shape
                bound = 2.0 * 68 * C * C * n * h * w / 1979e12 * 1e3
                result["bound_ms"][shape_name] = bound
                rows = {}
                for (part, launch), lib in libs.items():
                    if part == "parent":
                        continue
                    rows[f"{part} / {launch}"] = _queued_ms(_x1_call(lib, x, convs53, act53))
                if ("parent", "both") in libs:
                    _, convs2, act2 = _inputs(shape, (3, 3), 1)
                    x1, x2 = _parent_calls(libs[("parent", "both")], x, convs53, act53, convs2, act2)
                    if not torch.equal(x1(), want):
                        raise RuntimeError(f"the parent's X1 at {shape} differs from light53_int8_xla_plain")
                    rows["parent X1"] = _queued_ms(x1)
                    rows["X1"] = _queued_ms(_x1_call(libs[("kernel", "both")], x, convs53, act53))
                    if shape_name == "LR":
                        want2 = int8_xla.light_int8_xla_plain(x, *convs2, act2, acc="bf16")
                        if not torch.equal(x2(), want2) or not torch.equal(
                                int8_xla.light_int8_xla(x, *convs2, act2, acc="bf16"), want2):
                            raise RuntimeError("X2 (parent or this checkout) differs from light_int8_xla_plain")
                        rows["parent X2"] = _queued_ms(x2)
                        rows["X2"] = _queued_ms(lambda: int8_xla.light_int8_xla(x, *convs2, act2, acc="bf16"))
                        rows["parent X2 again"] = _queued_ms(x2)
                    rows["parent X1 again"] = _queued_ms(x1)
                print(f"{shape_name} {(n, h, w, C)} (operations bound {bound:.4f} ms): " +
                      "; ".join(f"{k} {v:.4f} ms" for k, v in rows.items()) + f" on {gpu}", flush=True)
                result["ms"][shape_name] = rows
                del x, convs53, got, want
                torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
