"""Probe of X1u (``IEK_INT8_UPQ``'s first HR Light53 block, ``xla_block_kernel`` forms 4 and 5 in ``csrc/int8_conv.cu``) on the card.

    python3 scripts/probe_x1u.py [--parent DIR]

X1u is two launches: the codes launch (both first convs over one staged
window of the int8 codes K3q writes) and the light53 launch (both second
convs per 64 output channels, then the combine, which forms each output's
float32 skip, the x4 of 0.9 * h_lr, from the LR map).  This script builds
``csrc/int8_conv.cu`` as the port does and in three variants: only the
codes launch, only the light53 launch, and the light53 launch without the
skip (its LR loads and arithmetic taken out: the combine adds 0).  It times
each by 20 calls queued behind a spin kernel between two CUDA events
(device ms a call) at the LR map (9,96,96,128) -> (9,384,384,128), inputs
from seed 0, the bf16 accumulator, beside X1 at the HR shape (the same
machinery with the skip 0.9 * x) and the HR head, K3q then X1u, with its
peak device memory.  It holds X1u bit-equal to its plain version in both
accumulators.  The variants' outputs are not held to anything.

``--parent DIR``: a ``git archive`` of an earlier commit whose
``image_enhance_keras_tpu_torch/csrc/int8_blocks.cu`` holds X1u as the C
entry ``iek_light53_int8_xla_upq`` taking the codes and a float32 skip
(K4/K5's weight pack): its X1u and its head (K3q, the float32 pass 0.9 *
h_lr, K3's float32 x4 for the skip, X1u) are timed the same way on the same
inputs, in turns with this checkout's (parent, this, this, parent), and
this checkout's output is held bit-equal to the parent's.

Prints the card's name and power limit first, ptxas's stack, spill and
register lines of every ``xla_block_kernel`` form, and one JSON line last.  Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from image_enhance_keras_tpu_torch.ops.cuda import _build, int8_blocks, int8_conv, int8_xla, upsample  # noqa: E402
from probe_x1_parts import _compile, _inputs, _queued_ms  # noqa: E402

SHAPE = (9, 96, 96)  # the LR map: 9 patches of 96 x 96, the int8 forward's chunk
NO_SKIP = [
    ("        const float s0 = lerp_rn(lerp_rn(q[0].x, us.wr0[j], q[1].x, us.wr1[j]), us.ws0[h],\n"
     "                                 lerp_rn(q[2].x, us.wr0[j], q[3].x, us.wr1[j]), us.ws1[h]);\n"
     "        const float s1 = lerp_rn(lerp_rn(q[0].y, us.wr0[j], q[1].y, us.wr1[j]), us.ws0[h],\n"
     "                                 lerp_rn(q[2].y, us.wr0[j], q[3].y, us.wr1[j]), us.ws1[h]);\n",
     "        const float s0 = 0.f, s1 = 0.f;\n        (void)q;\n"),
]
CODES_ONLY = [("  return launch_xla<PAIR_LIGHT53_UP>(b, st);\n", "  return 0;\n")]
LIGHT53_ONLY = [("  const int code = launch_xla<PAIR_CODES_I8>(a, st);\n", "  const int code = 0;\n")]
VARIANTS = {"codes launch": CODES_ONLY, "light53 launch": LIGHT53_ONLY,
            "light53 launch, no skip": LIGHT53_ONLY + NO_SKIP}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _build_variants(tmp: str, parent: str | None) -> dict:
    src = open(os.path.join(_build.CSRC, "int8_conv.cu")).read()
    procs = {}
    for name, reps in VARIANTS.items():
        s = src
        for a, b in reps:
            if a not in s:
                raise RuntimeError(f"variant {name!r}: the source no longer has {a.strip()!r}")
            s = s.replace(a, b)
        procs[name] = _compile(s, os.path.join(tmp, f"v{len(procs)}"))
    if parent is not None:
        procs["parent"] = _compile(
            open(os.path.join(parent, "image_enhance_keras_tpu_torch", "csrc", "int8_blocks.cu")).read(),
            os.path.join(tmp, "parent"))
    libs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {key}:\n{out[-3000:]}")
        lib = ctypes.CDLL(proc.args[-1][:-3] + ".so")
        if key == "parent":
            lib.iek_light53_int8_xla_upq.argtypes = [_P] * 18 + [_I] * 5 + [_F, _P]
        else:
            lib.iek_light53_int8_xla_upq.argtypes = _build.SIGNATURES["int8_conv"]["iek_light53_int8_xla_upq"]
        libs[key] = lib
    return libs


def _x1u_call(lib, xq, h, convs, act):
    """One call of X1u's C entry in lib (this checkout's signature and weight pack)."""
    wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2 = convs
    packs = [int8_conv.packed(wa1, 128), sa1, ba1, int8_conv.packed(wa2, 64), sa2, ba2,
             int8_conv.packed(wb1, 128), sb1, bb1, int8_conv.packed(wb2, 64), sb2, bb2]
    ta = torch.empty(xq.shape, dtype=torch.int8, device="cuda")
    tb, out = torch.empty_like(ta), torch.empty(xq.shape, dtype=torch.bfloat16, device="cuda")
    wt = upsample.weight_tensor(4, torch.float32, h.device)
    n, lh, lw, c = (int(v) for v in h.shape)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        code = lib.iek_light53_int8_xla_upq(xq.data_ptr(), h.data_ptr(), act.data_ptr(), *(t.data_ptr() for t in packs),
                                            ta.data_ptr(), tb.data_ptr(), out.data_ptr(), wt.data_ptr(), n, lh, lw, c,
                                            4, 1, 0.1, 0.9, stream)
        if code != 0:
            raise RuntimeError(f"iek_light53_int8_xla_upq: CUDA error {code}")
        return out

    return run


def _parent_call(lib, xq, skip, convs, act):
    """The parent's X1u C entry: the codes and a float32 skip (K4/K5's weight pack)."""
    packs = [int8_blocks._packed(t) if t.dtype == torch.int8 else t for t in convs]
    ta = torch.empty(xq.shape, dtype=torch.int8, device="cuda")
    tb, out = torch.empty_like(ta), torch.empty(xq.shape, dtype=torch.bfloat16, device="cuda")
    n, hh, ww, c = (int(v) for v in xq.shape)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        code = lib.iek_light53_int8_xla_upq(xq.data_ptr(), skip.data_ptr(), act.data_ptr(),
                                            *(t.data_ptr() for t in packs), ta.data_ptr(), tb.data_ptr(),
                                            out.data_ptr(), n, hh, ww, c, 1, 0.1, stream)
        if code != 0:
            raise RuntimeError(f"parent iek_light53_int8_xla_upq: CUDA error {code}")
        return out

    return run


def _peak_mb(fn) -> float:
    """Device memory a call allocates at its peak above what was allocated before it, MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del y
    return peak / 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a git archive of an earlier commit whose int8_blocks.cu holds X1u")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_x1u needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)
    _build.build_all()
    log = _build.build_log.get("int8_conv", "").splitlines()
    # each xla_block_kernel form's stack and spills, then its registers
    ptxas = [f"xla_block_kernel<{a.split('xla_block_kernelILi')[1][0]}>: {b.strip()} | {c.strip()}"
             for a, b, c in zip(log, log[1:] + [""], log[2:] + ["", ""])
             if "Function properties" in a and "xla_block_kernelILi" in a]
    for line in ptxas:
        print(f"ptxas: {line}", flush=True)
    result = {"gpu": gpu, "shape_lr": list(SHAPE), "ptxas": ptxas, "ms": {}, "peak_mb": {}}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp, torch.inference_mode():
        libs = _build_variants(tmp, args.parent)
        h, convs, act = _inputs(SHAPE, (3, 5, 5, 3), 0)
        sx, act_ab = act[0].contiguous(), act[1:].contiguous()
        xq = upsample.upsample_quant_tf1(h, 4, sx)
        n, lh, lw, c = (int(v) for v in h.shape)
        ops = 2.0 * 68 * c * c * n * 16 * lh * lw
        result["bound_ms"] = max(ops / 1979e12, (3.0 * xq.numel() + 2.0 * h.numel() + 68 * c * c) / 3.35e12) * 1e3
        for acc in ("bf16", "s32"):
            got = int8_xla.light53_int8_xla_upq(xq, h, *convs, act_ab, acc=acc)
            want = int8_xla.light53_int8_xla_upq_plain(xq, h, *convs, act_ab, acc=acc)
            if not torch.equal(got, want):
                raise RuntimeError(f"X1u (acc {acc}) is not bit-equal to light53_int8_xla_upq_plain")
        result["bit_equal_plain"] = True
        x1u = lambda: int8_xla.light53_int8_xla_upq(xq, h, *convs, act_ab)  # noqa: E731

        def head():
            return int8_xla.light53_int8_xla_upq(upsample.upsample_quant_tf1(h, 4, sx), h, *convs, act_ab)

        rows = {}
        parent = "parent" in libs
        if parent:
            skip = upsample.upsample_phase_tf1_kernel(h.float() * 0.9, 4)
            old = _parent_call(libs["parent"], xq, skip, convs, act_ab)
            result["bit_equal_parent"] = bool(torch.equal(old(), x1u()))
            if not result["bit_equal_parent"]:
                raise RuntimeError("X1u differs from the parent's X1u over its float32 skip")

            def old_head():
                q = upsample.upsample_quant_tf1(h, 4, sx)
                s = upsample.upsample_phase_tf1_kernel(h.float() * 0.9, 4)
                return _parent_call(libs["parent"], q, s, convs, act_ab)()

            rows["parent X1u"] = _queued_ms(old)
        rows["X1u"] = _queued_ms(x1u)
        for name in VARIANTS:
            rows[f"X1u {name}"] = _queued_ms(_x1u_call(libs[name], xq, h, convs, act_ab))
        rows["X1u again"] = _queued_ms(x1u)
        if parent:
            rows["parent X1u again"] = _queued_ms(old)
            del skip, old
            rows["parent head"] = _queued_ms(old_head)
            rows["parent head: the float32 pass 0.9 * h"] = _queued_ms(lambda: h.float() * 0.9)
            h9 = h.float() * 0.9
            rows["parent head: K3 float32"] = _queued_ms(lambda: upsample.upsample_phase_tf1_kernel(h9, 4))
            del h9
        rows["head (K3q + X1u)"] = _queued_ms(head)
        rows["head: K3q"] = _queued_ms(lambda: upsample.upsample_quant_tf1(h, 4, sx))
        rows["head again"] = _queued_ms(head)
        if parent:
            rows["parent head again"] = _queued_ms(old_head)
            result["peak_mb"]["parent head"] = _peak_mb(old_head)
        result["peak_mb"]["head"] = _peak_mb(head)
        # X1 at the HR shape on the same machinery, x the bf16 x4 of h
        x = upsample.upsample_phase_tf1_kernel(h, 4)
        rows["X1 at the HR shape"] = _queued_ms(lambda: int8_xla.light53_int8_xla(x, *convs, act))
        print(f"{tuple(h.shape)} -> {tuple(xq.shape)} (bound {result['bound_ms']:.4f} ms): "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in rows.items())
              + f"; peak MB {result['peak_mb']} on {gpu}", flush=True)
        result["ms"] = rows
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
