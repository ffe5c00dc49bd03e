"""Probe of the bf16 block and chain kernels on the card: where their time goes, and the parent's beside them.

    python3 scripts/probe_bf16_parts.py [--parent DIR] [--forms "kernel;no epilogue;..."] [--forwards]

K1 bf16 (the Light53 block, two launches of ``csrc/blocks.cu`` on the tile
of ``csrc/conv_bf16.cuh``) and K6 bf16 (16 Light53 blocks in one launch of
``csrc/tower.cu``) at (9,96,96,128), inputs from seed 0 at the scales of
``tests/test_torch_cuda.py``.  The script builds the checkout's
``blocks.cu`` and ``tower.cu`` with the port's nvcc flags in four forms: as
they are; without their epilogues ("no epilogue": no tile leaves the
registers, and the combines' arithmetic falls away with them); without
their products ("no products": the consumers wait for the weight slots and
the windows, release them, and run the epilogues on whatever the sums
hold); and without both (the producer's weight and window streams alone).
K1 is also built with only its first and with only its second launch, so
that every cell of K1 is one launch.  All of these libraries are loaded in
this one process: after them the unchanged build must still give its first
output bit for bit, and the "no products" K1 an output of its own (each
library launches its own kernels).  Each cell is timed by 20 calls queued
behind a spin kernel between two CUDA events (device ms a call, as
``chip_smoke._queued_ms``; the host's microseconds to issue a call beside
it), with K2 bf16, K7 bf16 (6 blocks) and cuDNN's bf16 ``F.conv2d``
formulation of K1 and K6.  Only the unchanged build is a kernel of the
port: its outputs are held to the plain versions (``bf16.ulp_gaps``, the
bounds of ``tests/test_torch_cuda.py``); the other forms' outputs are not
held to anything.

``--parent DIR``: a checkout (or ``git archive``) of an earlier commit.  Its
``blocks.cu`` and ``tower.cu`` (with its ``conv_tf32x3.cuh``) are built in
the same call; K1, K2, K6 and K7 bf16 of this checkout must be bit-equal
(``torch.equal``) to the parent's, and so must the float32 K1 and K6, and
the parent's bf16 kernels are timed the same way, in turns with this
checkout's (parent, kernel, kernel, parent).  ``--forms``: the forms to
build, separated by ``;`` (default all four).  ``--forwards``: the bf16
``pallas`` and ``pallas_chain`` forwards of the demo didbl on a seeded
128x128 image in patch mode, wall ms, device ms and idle share a image
under ``torch.profiler`` (``utils.profiling.profile_upscale``, 10 images
after a warm-up), each run in a process of its own, in turns with the
parent's where ``--parent`` is given (parent, this, this, parent).

Prints the card's name and power limit first and one JSON line last; exits
1 where an output disagrees.  Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from image_enhance_keras_tpu_torch.ops.cuda import _build, bf16, blocks, tf32x3, tower  # noqa: E402

C = 128
SHAPE = (9, 96, 96)
CHAIN_K, LIGHT_K = 16, 6
SOURCES = ("blocks.cu", "tower.cu", "conv_bf16.cuh", "conv_tf32x3.cuh")
EPILOGUE = [("                                           int W, int cw) {\n",
             "                                           int W, int cw) {\n  return;\n")]
PRODUCTS = [("    wgmma_bf16(p, a_hi | desc_addr(a + 2 * kk * PLANE), b_hi | desc_addr(b + kk * KTILE), (h | kk) != 0);\n",
             "    (void)a_hi, (void)b_hi;\n")]
#: form -> replacements in conv_bf16.cuh
FORMS = {"kernel": [], "no epilogue": EPILOGUE, "no products": PRODUCTS, "no products, no epilogue": PRODUCTS + EPILOGUE}
_FIRST = "  err = launch(first_kernel_bf16<kLight53>, a, tiles * (kLight53 ? 2 : 1), false, fit1, st);\n"
_SECOND = "  if (err == cudaSuccess) err = launch(second_kernel_bf16<kLight53>, a, tiles, false, fit2, st);\n"
LAUNCHES = {"both": [], "first": [(_SECOND, "")], "second": [(_FIRST, "  err = cudaSuccess;\n")]}
#: the plain versions' bounds (tests/test_torch_cuda.py): share of elements, ulps, near-zero scale
BLOCK_BOUND = (1e-3, 1.0, 2.0 ** -6)
CHAIN_BOUND_K1 = (1e-3, 2.0, 0.1)


def _compile(tmp: str, name: str, sources: dict, stem: str) -> subprocess.Popen:
    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    for fn, text in sources.items():
        with open(os.path.join(d, fn), "w") as f:
            f.write(text)
    out = os.path.join(d, f"lib{stem}.so")
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, os.path.join(d, f"{stem}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _replaced(text: str, reps: list, what: str) -> str:
    for a, b in reps:
        if a not in text:
            raise RuntimeError(f"{what}: the source no longer has {a.strip()!r}")
        text = text.replace(a, b)
    return text


def _load(path: str, stem: str, parent: bool = False):
    lib = ctypes.CDLL(path)
    sig = dict(_build.SIGNATURES[stem])
    if parent and stem == "blocks":  # the parent's bf16 K1 entry took a float32 park scratch
        sig["iek_light53_block_bf16"] = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [
            ctypes.c_void_p]
    for name, argtypes in sig.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _build_libs(tmp: str, parent: str | None, forms: list) -> tuple[dict, dict]:
    """(library paths by (form, launches, stem), nvcc's output of the unchanged build)."""
    src = {fn: open(os.path.join(_build.CSRC, fn)).read() for fn in SOURCES}
    procs = {}
    for form in forms:
        base = dict(src, **{"conv_bf16.cuh": _replaced(src["conv_bf16.cuh"], FORMS[form], form)})
        for launch, reps in LAUNCHES.items():
            srcs = dict(base, **{"blocks.cu": _replaced(base["blocks.cu"], reps, launch)})
            procs[(form, launch, "blocks")] = _compile(tmp, f"v{len(procs)}", srcs, "blocks")
        procs[(form, "both", "tower")] = _compile(tmp, f"v{len(procs)}", base, "tower")
    if parent is not None:
        pdir = os.path.join(parent, "image_enhance_keras_tpu_torch", "csrc")
        psrc = {fn: open(os.path.join(pdir, fn)).read() for fn in ("blocks.cu", "tower.cu", "conv_tf32x3.cuh")}
        for stem in ("blocks", "tower"):
            procs[("parent", "both", stem)] = _compile(tmp, f"v{len(procs)}", psrc, stem)
    paths, logs = {}, {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{out[-6000:]}")
        if key[:2] == ("kernel", "both"):
            logs[key[2]] = out
        paths[key] = proc.args[-2]
    return paths, logs


def _inputs():
    """bf16 and float32 x, and the weights of K1, K2, K6 and K7, from seed 0."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(*SHAPE, C)).astype(np.float32)).cuda()
    return (x, x.to(torch.bfloat16), _weights(rng, (3, 5, 5, 3)), _weights(rng, (3, 3)),
            _weights(rng, (3, 5, 5, 3), (CHAIN_K,)), _weights(rng, (3, 3), (LIGHT_K,)))


def _queued_ms(fn, n: int = 20) -> tuple[float, float]:
    """(device ms, host microseconds) a call of fn: n calls queued behind a
    spin kernel between two CUDA events, and the host's time to issue them."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, host / n * 1e6


#: run with the root of a checkout and the weights: the bf16 forwards' wall
#: ms, device ms and idle share a image, as JSON (imports that checkout's package)
_FORWARDS = """
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from image_enhance_keras_tpu_torch.engine import SuperResolver
from image_enhance_keras_tpu_torch.utils.profiling import profile_upscale
img = np.random.default_rng(0).integers(0, 256, (128, 128, 3), dtype=np.uint8)
out = {}
for f in ("pallas", "pallas_chain"):
    res = SuperResolver(weights=sys.argv[2], forward=f, dtype=torch.bfloat16, device="cuda")
    wall, rows = profile_upscale(res, img, 10)
    busy = sum(ms for _, ms, _ in rows) / 10
    out[f] = {"wall_ms": wall * 1e3, "device_ms": busy, "idle_share": max(0.0, 1.0 - busy / (wall * 1e3))}
print(json.dumps(out))
"""


def _forwards(root: str, weights: str) -> dict:
    got = subprocess.run([sys.executable, "-c", _FORWARDS, os.path.abspath(root), weights], capture_output=True,
                         text=True, timeout=900)
    if got.returncode != 0:
        raise RuntimeError(f"the bf16 forwards of {root}: {got.stderr[-3000:]}")
    return json.loads(got.stdout.strip().splitlines()[-1])


def _weights(rng, sizes, lead=()):
    out = []
    for k in sizes:
        out.append(torch.from_numpy((rng.normal(size=(*lead, k, k, C, C)) / np.sqrt(k * k * C))
                                    .astype(np.float32)).cuda())
        out.append(torch.from_numpy((rng.normal(size=(*lead, C)) * 0.05).astype(np.float32)).cuda())
    return out


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _block_call(lib, x, args, light53: bool, parent: bool = False):
    """One call of K1 (light53) or K2 in lib, x's dtype: bf16 or float32."""
    pack = bf16.packed if x.dtype == torch.bfloat16 else tf32x3.packed
    ptrs = [(pack(a) if a.dim() == 4 else a).data_ptr() for a in args]
    ta, tb, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    park = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    n, h, w, c = (int(v) for v in x.shape)
    stream = torch.cuda.current_stream().cuda_stream
    is_bf16 = x.dtype == torch.bfloat16

    def run():
        if light53:
            fn = lib.iek_light53_block_bf16 if is_bf16 else lib.iek_light53_block
            scratch = [ta.data_ptr(), tb.data_ptr()] + ([park.data_ptr()] if parent and is_bf16 else [])
            code = fn(x.data_ptr(), *ptrs, *scratch, out.data_ptr(), n, h, w, c, 0.1, 9.0, stream)
        else:
            fn = lib.iek_light_block_bf16 if is_bf16 else lib.iek_light_block
            code = fn(x.data_ptr(), *ptrs, ta.data_ptr(), out.data_ptr(), n, h, w, c, 0.1, stream)
        _check(code, f"{'parent ' if parent else ''}{'K1' if light53 else 'K2'}")
        return out

    return run


def _chain_call(lib, x, args, light53: bool):
    """One call of K6 (light53) or K7 in lib over stacked weights."""
    is_bf16 = x.dtype == torch.bfloat16
    pack = bf16.packed if is_bf16 else tf32x3.packed
    ptrs = [(pack(a) if a.dim() == 5 else a).data_ptr() for a in args]
    act, ta, tb, out = (torch.empty_like(x) for _ in range(4))
    k = int(args[1].shape[0])
    n, h, w, c = (int(v) for v in x.shape)
    stream = torch.cuda.current_stream().cuda_stream
    res, ident = (bf16.scalar(0.1), bf16.scalar(0.9)) if is_bf16 else (0.1, 0.9)

    def run():
        if light53:
            fn = lib.iek_light53_chain_bf16 if is_bf16 else lib.iek_light53_chain
            code = fn(x.data_ptr(), *ptrs, act.data_ptr(), ta.data_ptr(), tb.data_ptr(), out.data_ptr(),
                      k, n, h, w, c, res, ident, stream)
        else:
            fn = lib.iek_light_chain_bf16 if is_bf16 else lib.iek_light_chain
            code = fn(x.data_ptr(), *ptrs, act.data_ptr(), ta.data_ptr(), out.data_ptr(), k, n, h, w, c, res, stream)
        _check(code, "K6" if light53 else "K7")
        return out

    return run


def _cudnn(x, args, light53: bool, k_blocks: int):
    """cuDNN's bf16 F.conv2d formulation of the same blocks (channels-last)."""
    xc = x.permute(0, 3, 1, 2)
    stacked = args[0].dim() == 5
    la = [(a.permute(*((0, 4, 3, 1, 2) if stacked else (3, 2, 0, 1))).contiguous() if a.dim() >= 4 else a)
          .to(torch.bfloat16) for a in args]

    def block(h, a):
        if light53:
            wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2 = a
            ya = F.conv2d(F.relu(F.conv2d(h, wa1, ba1, padding=1)), wa2, ba2, padding=2)
            yb = F.conv2d(F.relu(F.conv2d(h, wb1, bb1, padding=2)), wb2, bb2, padding=1)
            return 0.9 * h + 0.1 * (ya + yb)
        w1, b1, w2, b2 = a
        return h + 0.1 * F.conv2d(F.relu(F.conv2d(h, w1, b1, padding=1)), w2, b2, padding=1)

    def run():
        h = xc
        for i in range(k_blocks):
            h = block(h, [v[i] for v in la] if stacked else la)
        return h

    return run


def _gaps(got, want, bound) -> dict:
    frac, ulps = bf16.ulp_gaps(got, want, bound[2])
    return {"differing_share": frac, "max_gap_ulp": ulps,
            "ok": frac <= max(bound[0], 64 / got.numel()) and ulps <= bound[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit, built and timed beside this one")
    ap.add_argument("--forms", default=";".join(FORMS), help="forms to build, separated by ';': " + "; ".join(FORMS))
    ap.add_argument("--forwards", action="store_true",
                    help="also profile the bf16 pallas and pallas_chain forwards (and the parent's)")
    args = ap.parse_args(argv)
    forms = list(dict.fromkeys(f.strip() for f in args.forms.split(";")))
    if "kernel" not in forms or any(f not in FORMS for f in forms):
        ap.error(f"--forms takes 'kernel' and any of {sorted(FORMS)}")
    if not torch.cuda.is_available():
        print("probe_bf16_parts needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"gpu": gpu, "shape": [*SHAPE, C], "ms": {}, "checks": {}, "failures": []}
    fails = result["failures"]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        paths, logs = _build_libs(tmp, args.parent, forms)
        for stem, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "arning" in line:
                    print(f"nvcc {stem}: {line.strip()}", flush=True)
        x, xb, a53, al, s53, sl = _inputs()
        kern = {stem: _load(paths[("kernel", "both", stem)], stem) for stem in ("blocks", "tower")}
        with torch.inference_mode():
            runs = {
                "K1 bf16": _block_call(kern["blocks"], xb, a53, True),
                "K2 bf16": _block_call(kern["blocks"], xb, al, False),
                "K6 bf16": _chain_call(kern["tower"], xb, s53, True),
                "K7 bf16": _chain_call(kern["tower"], xb, sl, False),
            }
            plains = {
                "K1 bf16": lambda: blocks.light53_block_bf16(xb, *a53),
                "K2 bf16": lambda: blocks.light_block_bf16(xb, *al),
                "K6 bf16": lambda: tower.light53_chain_bf16(xb, *[v[:1] for v in s53]),
                "K7 bf16": lambda: tower.light_chain_bf16(xb, *[v[:1] for v in sl]),
            }
            outs = {name: run().clone() for name, run in runs.items()}
            torch.cuda.synchronize()
            for name, plain in plains.items():
                if name in ("K6 bf16", "K7 bf16"):  # a chain of one block against its plain version
                    got = _chain_call(kern["tower"], xb, [v[:1].contiguous() for v in (s53 if name == "K6 bf16"
                                                                                      else sl)],
                                      name == "K6 bf16")()
                    bound = CHAIN_BOUND_K1
                else:
                    got, bound = outs[name], BLOCK_BOUND
                check = _gaps(got, plain(), bound)
                result["checks"][f"{name} vs plain"] = check
                print(f"{name} vs its plain version: {check}", flush=True)
                if not check["ok"]:
                    fails.append(f"{name}: beyond the plain version's bounds {check}")
            if args.parent is not None:
                par = {stem: _load(paths[("parent", "both", stem)], stem, parent=True) for stem in ("blocks", "tower")}
                pruns = {
                    "K1 bf16": _block_call(par["blocks"], xb, a53, True, parent=True),
                    "K2 bf16": _block_call(par["blocks"], xb, al, False, parent=True),
                    "K6 bf16": _chain_call(par["tower"], xb, s53, True),
                    "K7 bf16": _chain_call(par["tower"], xb, sl, False),
                }
                for name, prun in pruns.items():
                    same = torch.equal(prun(), outs[name])
                    result["checks"][f"{name} bit-equal to the parent's"] = same
                    print(f"{name} bit-equal to the parent's: {same}", flush=True)
                    if not same:
                        fails.append(f"{name} differs from the parent's kernel")
                f32 = {"K1 float32": (_block_call(kern["blocks"], x, a53, True),
                                      _block_call(par["blocks"], x, a53, True, parent=True)),
                       "K6 float32": (_chain_call(kern["tower"], x, s53, True),
                                      _chain_call(par["tower"], x, s53, True))}
                for name, (mine, theirs) in f32.items():
                    same = torch.equal(mine().clone(), theirs())
                    result["checks"][f"{name} bit-equal to the parent's"] = same
                    print(f"{name} bit-equal to the parent's: {same}", flush=True)
                    if not same:
                        fails.append(f"{name} differs from the parent's kernel")
            rows, host_us = {}, {}
            # parent, kernel, kernel, parent
            order = ["parent", "kernel", "kernel again", "parent again"] if args.parent else ["kernel", "kernel again"]
            for who in order:
                src_runs = pruns if who.startswith("parent") else runs
                for name, run in src_runs.items():
                    rows[f"{who} {name}"], host_us[f"{who} {name}"] = _queued_ms(run)
            # every variant in this process, beside the unchanged build
            variant_out = {}
            for (form, launch, stem), path in paths.items():
                if form == "parent" or (form, launch) == ("kernel", "both"):
                    continue
                lib = _load(path, stem)
                run = _block_call(lib, xb, a53, True) if stem == "blocks" else _chain_call(lib, xb, s53, True)
                name = f"K1 bf16 {form} / {launch}" if stem == "blocks" else f"K6 bf16 {form}"
                rows[name], host_us[name] = _queued_ms(run)
                variant_out[name] = run().clone()
            same = torch.equal(runs["K1 bf16"](), outs["K1 bf16"])
            result["checks"]["K1 bf16 unchanged beside the variants"] = same
            print(f"K1 bf16 bit-equal to its first output with every variant loaded: {same}", flush=True)
            if not same:
                fails.append("K1 bf16 changed its output once the variants were loaded")
            own = variant_out.get("K1 bf16 no products / both")
            if own is not None:
                differs = not torch.equal(own, outs["K1 bf16"])
                result["checks"]["K1 bf16 no products launches its own kernels"] = differs
                print(f"K1 bf16 'no products' differs from the kernel: {differs}", flush=True)
                if not differs:
                    fails.append("the 'no products' K1 gave the kernel's output: it did not launch its own code")
            rows["cuDNN bf16 K1"], host_us["cuDNN bf16 K1"] = _queued_ms(_cudnn(xb, a53, True, 1))
            rows["cuDNN bf16 K6"], host_us["cuDNN bf16 K6"] = _queued_ms(_cudnn(xb, s53, True, CHAIN_K))
            n, h, w = SHAPE
            result["bound_ms"] = {"K1 bf16": 2.0 * 68 * C * C * n * h * w / 989e12 * 1e3,
                                  "K6 bf16": CHAIN_K * 2.0 * 68 * C * C * n * h * w / 989e12 * 1e3,
                                  "K2 bf16": 2.0 * 18 * C * C * n * h * w / 989e12 * 1e3,
                                  "K7 bf16": LIGHT_K * 2.0 * 18 * C * C * n * h * w / 989e12 * 1e3}
            for k, v in rows.items():
                print(f"{k}: {v:.4f} ms device, {host_us[k]:.1f} us host a call on {gpu}", flush=True)
            result["ms"], result["host_us"] = rows, host_us
        if args.forwards:
            from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights

            weights = os.path.abspath(resolve_default_weights(MODEL_REGISTRY["didbl"]))
            here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            turns = [("parent", args.parent), ("this", here), ("this again", here), ("parent again", args.parent)]
            result["forwards"] = {}
            for who, root in (turns if args.parent else turns[1:3]):
                got = _forwards(root, weights)
                for f, row in got.items():
                    result["forwards"][f"{who} {f}"] = row
                    print(f"{who} --forward {f} --dtype bfloat16, 128x128 patch mode: {row['wall_ms']:.3f} ms wall, "
                          f"{row['device_ms']:.3f} ms device, idle share {row['idle_share']:.3f} on {gpu}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(result))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
