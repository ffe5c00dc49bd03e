"""One run of one cell: set-up, the measured window, the traced layers, the check against the reference.

Everything that belongs to a cell is found by name: ``BENCHMARK.json``
names the cell's configuration and traffic, ``configs/<config>.json`` holds
the configuration as it is run, ``traffic/<traffic>.json`` the traffic's
parameters, ``workloads/<cell>.json`` how the program is set up for the
cell and the limit of each number compared, ``reference/<config>.py`` the
plain reference, ``metrics/<metric>.py`` each per-layer metric's reader.

The system under test is ``image_enhance_keras_tpu_torch``'s
``SuperResolver.upscale``, driven by one client in a closed loop: the next
image goes in when the previous output is back on the host as uint8.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import counting, traffic as traffic_mod
from benchmark.devtrace import IMAGE_SPAN, WINDOW_SPAN, DeviceTrace
from benchmark.reference import common
from benchmark.weights import make_weights

__all__ = ["ROOT", "Cell", "load_cell", "setup", "run_window", "reference_numbers", "run_cell", "log"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "image_enhance_keras_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list
    root: str = ROOT

    @property
    def resolver(self) -> dict:
        return self.workload["resolver"]

    @property
    def geometry(self) -> dict:
        r = self.resolver
        return {"patch": r.get("patch", 96), "step": r.get("step", 64), "crop": r.get("crop", 8)}


def load_cell(name: str, overrides: dict | None = None, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; ``overrides``
    ({"config": .., "traffic": .., "workload": ..}) are merged in (tests)."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, "benchmark")
    over = overrides or {}
    config = _merge(_json(os.path.join(root, conf["file"])), over.get("config", {}))
    tr = _merge(traffic_mod.load(entry["traffic"], root), over.get("traffic", {}))
    wl = _merge(_json(os.path.join(here, "workloads", f"{name}.json")), over.get("workload", {}))

    def applies(m):
        return name in m.get("workloads", [name])

    return Cell(name, config, tr, wl, [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)], root)


_MODULES: dict = {}


def _module(root: str, kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` under ``root``, loaded by its path."""
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reference_module(cell: "Cell"):
    """The plain reference of the cell's configuration."""
    return _module(cell.root, "reference", cell.config["name"])


def metric_reader(cell: "Cell", name: str):
    """The reader of the per-layer metric ``name``: ``read(run)`` -> a number or None."""
    return _module(cell.root, "metrics", name)


# -- set-up -------------------------------------------------------------------

@dataclasses.dataclass
class Setup:
    traffic: traffic_mod.Traffic
    weights: dict
    resolver: object
    calib_x: torch.Tensor | None
    image_s: float


def calibration_input(cell: Cell, tr: traffic_mod.Traffic) -> torch.Tensor | None:
    """The int8 calibration batch both sides use: the program's
    ``first_frame`` rule (a central crop of at most 128x128 of the first image
    it serves, request 0, /255), worked out here from the same image."""
    if cell.resolver.get("forward") not in ("int8", "pallas_int8"):
        return None
    if cell.workload.get("resolver_attrs", {}).get("int8_calib") != "first_frame":
        raise ValueError("int8 cells calibrate on the first frame, so that the reference can use the same crop")
    img = tr.image(0)
    h, w = img.shape[:2]
    ch, cw = min(h, 128), min(w, 128)
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    return common.im2double(torch.from_numpy(np.asarray(img[y0 : y0 + ch, x0 : x0 + cw], np.float32)))[None]


def setup(cell: Cell, seed: int, device: str = "cuda") -> Setup:
    """Traffic and weights from the seed, the program built on them, every
    shape the traffic uses warmed up (request 0 first: it calibrates)."""
    from image_enhance_keras_tpu_torch.engine import SuperResolver

    cfg = cell.config
    tr = traffic_mod.Traffic(cell.traffic, seed)
    ref = reference_module(cell)
    weights = make_weights(ref.param_shapes(cfg), cfg["init"], seed, device)
    res = SuperResolver(model=cfg["model"], params=weights, model_kwargs=cfg["model_kwargs"], device=device,
                        **cell.resolver)
    for k, v in cell.workload.get("resolver_attrs", {}).items():
        setattr(res, k, v)
    image_s = 0.0
    for i in range(int(cell.workload.get("warmup", 1))):
        t0 = time.perf_counter()
        res.upscale(tr.image(i))
        image_s = time.perf_counter() - t0
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    return Setup(tr, weights, res, calibration_input(cell, tr), image_s)


# -- the window -----------------------------------------------------------------

@dataclasses.dataclass
class Window:
    seconds: float
    latencies_s: list
    out_pixels: int
    completed: int
    attempted: int
    failed: int
    shapes: dict
    kept: dict
    error: str | None = None


def run_window(s: Setup, seconds: float, keep: set, trace: bool = False) -> Window:
    """Closed loop for ``seconds``: request i goes in when request i-1's uint8
    output is on the host.  As ``main_dirpath`` writes an output out and
    drops it before the next image, the loop holds no output across calls:
    the outputs of requests in ``keep`` (and of request 0, the fallback
    when the window ends before them) are copied.  With ``trace`` every
    call sits in a span."""
    from torch.profiler import record_function

    lat, kept = [], {}
    out_px = failed = 0
    shapes: dict = {}
    error = None
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_end = t0
    with record_function(WINDOW_SPAN) if trace else contextlib.nullcontext():
        while time.perf_counter() < deadline:
            img = s.traffic.image(i)
            ta = time.perf_counter()
            try:
                with record_function(IMAGE_SPAN) if trace else contextlib.nullcontext():
                    out = s.resolver.upscale(img)
            except Exception as e:  # a request that raises is a failed request: stop and report it
                failed, error = 1, f"{type(e).__name__}: {e}"
                i += 1
                break
            t_end = time.perf_counter()
            lat.append(t_end - ta)
            out_px += int(out.shape[0]) * int(out.shape[1])
            shapes[img.shape[:2]] = shapes.get(img.shape[:2], 0) + 1
            if i in keep or i == 0:
                kept[i] = out.copy()
            del out
            i += 1
    return Window(t_end - t0, lat, out_px, len(lat), i, failed, shapes, kept, error)


def _scale(cell: Cell) -> int:
    return int(cell.config["model_kwargs"].get("scale", 4))


def window_work(cell: Cell, shapes: dict) -> dict:
    """The forwards' work over the completed images, {(h, w): count}: input
    ``pixels``, ``ops_s`` (operations at peak) and ``bound_s`` (roofline
    least time), each forward call counted with its own weights' bytes."""
    peaks = counting.load_peaks()
    r = cell.resolver
    work = {"pixels": 0, "ops_s": 0.0, "bound_s": 0.0}
    for (h, w), n in shapes.items():
        for px in counting.forward_calls(int(h), int(w), r.get("mode", "patch"), scale=_scale(cell),
                                         tile_chunk=int(r.get("tile_chunk", 16)), **cell.geometry):
            one = counting.image_work(cell.config, r["forward"], px, peaks)
            work["pixels"] += n * px
            work["ops_s"] += n * one["ops_s"]
            work["bound_s"] += n * one["bound_s"]
    return work


def check_indices(cell: Cell, seed: int, image_s: float, seconds: float) -> list[int]:
    """``check_images`` consecutive requests from a start drawn from the seed
    in the first half of the requests the window should complete."""
    n = int(cell.workload["check_images"])
    expect = max(1, int(seconds / max(image_s, 1e-3)))
    start = int(np.random.default_rng(int(seed) % (1 << 63)).integers(0, max(1, expect // 2)))
    return list(range(start, start + n))


# -- the check ------------------------------------------------------------------

def compare(out: np.ndarray, ref: np.ndarray) -> dict:
    """diff_share: the share of uint8 values that differ from the reference's;
    max_gap: the largest difference in levels (information)."""
    if out.shape != ref.shape:
        return {"diff_share": 1.0, "max_gap": 255}
    d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    return {"diff_share": float(np.count_nonzero(d)) / d.size, "max_gap": int(d.max())}


def reference_outputs(cell: Cell, weights: dict, tr: traffic_mod.Traffic, calib_x, indices, device: str,
                      num: common.Numerics) -> dict:
    """Request index -> the reference's uint8 output, computed in ``num``."""
    cfg = cell.config
    ref = reference_module(cell)
    r = cell.resolver
    fwd = ref.prepare(weights, cfg, r["forward"], None if calib_x is None else calib_x.to(device), num)
    outs = {}
    for i in indices:
        img = torch.from_numpy(np.ascontiguousarray(tr.image(i))).to(device)
        outs[i] = common.upscale(fwd, img, r.get("mode", "patch"), scale=_scale(cell),
                                 chunk=int(cell.workload.get("reference_chunk", 8)), **cell.geometry).cpu().numpy()
        del img
    return outs


def reference_numbers(cell: Cell, weights: dict, tr, calib_x, outs: dict, device: str,
                      num: common.Numerics = common.Numerics()) -> dict:
    """Each number compared, the worst over the checked outputs."""
    with torch.inference_mode():
        refs = reference_outputs(cell, weights, tr, calib_x, sorted(outs), device, num)
    worst: dict = {}
    for i, out in outs.items():
        for k, v in compare(out, refs[i]).items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def control_numeric(cell: Cell) -> common.Numerics:
    """The precision step below the configuration's: ``workload["control"]``."""
    return common.Numerics(**cell.workload["control"])


# -- a whole run ------------------------------------------------------------------

def _smi() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
                            "temperature.gpu", "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run: the result object the harness prints last (``checks`` last in it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")
    build_s = 0.0
    if cuda:
        from image_enhance_keras_tpu_torch.ops.cuda import _build

        tb = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - tb
        log(f"build_s {build_s:.3f} (csrc built into the package's _build/; near 0 when already built)")
    with torch.inference_mode():
        s = setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f} (build {build_s:.3f}); one warm image {1e3 * s.image_s:.3f} ms")
    keep = set(check_indices(cell, seed, s.image_s, seconds))
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        log(f"card before the window: {_smi()}")
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        w = run_window(s, seconds, keep, trace=trace)
        if cuda:
            torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        log(f"card after the window: {_smi()}")
    log(f"window {w.seconds:.3f} s: {w.completed} images completed of {w.attempted} attempted, {w.failed} failed"
        + (f" ({w.error})" if w.error else ""))

    metrics: dict = {}
    breakdown = None
    device_info: dict = {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak)) if cuda else 0}
    work = window_work(cell, w.shapes)
    lat_ms = 1e3 * np.asarray(w.latencies_s) if w.latencies_s else np.zeros(1)
    p95 = float(np.percentile(lat_ms, 95))
    e2e = {"out_mpix_s": w.out_pixels / w.seconds / 1e6 if w.seconds > 0 else 0.0,
           "image_p95_ms": p95,
           "peak_mem_gib": window_peak / 2**30,
           "setup_s": setup_s}
    names = {m["name"] for m in cell.end_to_end}
    log(f"image latency ms: median {float(np.median(lat_ms)):.3f}, p95 {p95:.3f} over {w.completed} images"
        + ("" if "image_p95_ms" in names else " (information only in this cell)"))
    log(f"work in the window: {work['pixels']} forward input pixels, {1e3 * work['ops_s']:.3f} ms of "
        f"operations at peak, roofline least time {1e3 * work['bound_s']:.3f} ms")

    if trace:
        tr = _read_trace(prof) if cuda else None
        n_dev = 0 if tr is None else tr.n_device
        log(f"device events the profiler returned in the window: {n_dev}")
        if not n_dev:
            raise RuntimeError("the traced window holds no device event: no per-layer metric can be read")
        run = _Run(tr, work, w.seconds)
        for m in cell.per_layer:
            v = metric_reader(cell, m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update({"busy_s": tr.busy_s, "window_s": tr.window_s})
        breakdown = {"device_ops": [[n[:200], v] for n, v in tr.top_ops],
                     "idle_gaps": [[n[:200], v] for n, v in tr.idle_gaps]}
        log(f"device busy {tr.busy_s:.6f} s of the traced window {tr.window_s:.6f} s; glue {tr.glue_s:.6f} s, "
            f"compute {tr.compute_s:.6f} s")
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    # the check: the program's state freed first, so the reference cannot set the peak
    outs = {i: w.kept[i] for i in sorted(keep) if i in w.kept} or {i: o for i, o in w.kept.items()}
    sat = [float(np.mean((o == 0) | (o == 255))) for o in outs.values()]
    log(f"checked requests {sorted(outs)}; share of their uint8 values at 0 or 255: "
        + ", ".join(f"{v:.6f}" for v in sat))
    weights, tr_imgs, calib_x = s.weights, s.traffic, s.calib_x
    del s
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    numbers = reference_numbers(cell, weights, tr_imgs, calib_x, outs, device) if outs else {}
    log(f"reference check {time.perf_counter() - tc:.3f} s; max level gap {numbers.get('max_gap')}")
    limits = cell.workload["limits"]
    # a number that could not be read (no output kept) reads as every value differing
    checks = [{"name": k, "value": numbers.get(k, 1.0), "limit": float(v)} for k, v in limits.items()]
    correct = bool(outs) and w.failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": w.attempted, "failed": w.failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        log(f"check {c['name']} {c['value']!r} limit {c['limit']!r}")
    return result


@dataclasses.dataclass
class _Run:
    """What a per-layer reader reads: the window's trace, the work its
    forwards did (``ops_s``, ``bound_s``) and its wall time."""

    trace: DeviceTrace | None
    work: dict
    window_s: float


def _read_trace(prof) -> DeviceTrace:
    """The profiler's Chrome trace of the window, written to a temporary file and read back."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "window.json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        tr = DeviceTrace.from_file(path)
    log(f"trace: {size / 2**20:.1f} MiB exported and read in {time.perf_counter() - t0:.3f} s")
    return tr
