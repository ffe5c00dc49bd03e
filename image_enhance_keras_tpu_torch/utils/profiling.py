"""Profiling: stage timers, a trace context, and where the device time of the main path goes.

``StageTimer`` accumulates wall-clock time by stage name, ``trace(log_dir)``
records a ``torch.profiler`` trace (CPU activity, and CUDA activity when a
card is present) and writes it as a Chrome trace under ``log_dir``, and
``mpix_per_s`` is the throughput of n pixels in a time.  As a script:

    python -m image_enhance_keras_tpu_torch.utils.profiling [--size 128] [--iters 3] [--model didbl]
        [--forwards int8 pallas_int8 pallas pallas_chain xla]

Upscales one seeded ``size`` x ``size`` image in patch mode (96/64/8, the
model's committed demo weights) with each of ``--forwards`` (the pallas
forwards are the TF1-head didbl's only) under ``torch.profiler``, after a
warm-up (which also builds the kernels and, for the int8 forwards, calibrates
and quantizes the weights), and prints for each forward the wall time per
image, the device time of every kernel (summed over the timed images), and
the share of the wall time in which no kernel ran.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["StageTimer", "trace", "mpix_per_s", "device_kernel_times", "profile_upscale", "main"]


class StageTimer:
    """Accumulating wall-clock stage timer.

    >>> t = StageTimer()
    >>> with t("decode"): ...
    >>> print(t.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def report(self) -> str:
        """One line a stage, longest total first: ``name: T.TTTs / Nx (M.M ms avg)``."""
        return "\n".join(
            f"{k}: {self.totals[k]:.3f}s / {self.counts[k]}x "
            f"({1e3 * self.totals[k] / max(self.counts[k], 1):.1f} ms avg)"
            for k in sorted(self.totals, key=self.totals.get, reverse=True)
        )


@contextlib.contextmanager
def trace(log_dir: str = "iek_torch_trace"):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity when
    a card is present); on exit writes ``<log_dir>/trace_<pid>_<ns>.json``, a
    Chrome trace (chrome://tracing, Perfetto).  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def mpix_per_s(n_pixels: int, seconds: float) -> float:
    return n_pixels / seconds / 1e6


def device_kernel_times(prof) -> list[tuple[str, float, int]]:
    """(kernel name, device ms, calls) for every kernel the profiler saw, longest first."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((evt.key, us / 1e3, evt.count))
    return sorted(rows, key=lambda r: -r[1])


def profile_upscale(resolver, img: np.ndarray, iters: int) -> tuple[float, list]:
    """Wall seconds per image and the kernel table over ``iters`` upscales."""
    from torch.profiler import ProfilerActivity, profile

    resolver.upscale(img)  # warm-up: cuDNN algorithm choice, kernel build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(iters):
            resolver.upscale(img)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
    return wall, device_kernel_times(prof)


def main(argv=None) -> int:
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--model", default="didbl", choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--forwards", nargs="+", default=["int8", "pallas_int8", "pallas", "pallas_chain", "xla"],
                    choices=["int8", "pallas_int8", "pallas", "pallas_chain", "xla"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling needs a CUDA card", file=sys.stderr)
        return 1
    weights = resolve_default_weights(MODEL_REGISTRY[args.model])
    img = np.random.default_rng(0).integers(0, 256, (args.size, args.size, 3), dtype=np.uint8)
    print(f"card: {torch.cuda.get_device_name(0)}; image {args.size}x{args.size}, patch mode 96/64/8")
    for forward in args.forwards:
        res = SuperResolver(model=args.model, weights=weights, forward=forward, device="cuda")
        wall, rows = profile_upscale(res, img, args.iters)
        busy = sum(ms for _, ms, _ in rows) / args.iters
        print(f"--forward {forward}: {wall * 1e3:.3f} ms per image wall, {busy:.3f} ms device busy, "
              f"idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
        for name, ms, calls in rows[: args.top]:
            print(f"  {ms / args.iters:9.3f} ms/image {100 * ms / args.iters / busy:5.1f}%  "
                  f"{calls // args.iters:4d} calls/image  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
