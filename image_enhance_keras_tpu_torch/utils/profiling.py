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
image, the device time of every kernel (summed over the timed images), the
share of the wall time in which no kernel, copy or memset ran (one minus the
union of their intervals over the wall time), and each ``iek.*`` stage's
host self time per image.  Needs a CUDA card.

Stage spans and counters of the program: ``span(name)`` is a
``torch.profiler.record_function`` while a profiler session records, and
does nothing else (one flag read), so the spans land on the profiler's clock,
beside the device's kernels, exactly when someone profiles.  The engine and
the forwards open the spans named ``SPAN_*`` below; nesting on the calling
thread gives each span its parent, and ``iek.upscale`` is a request's root.
``count(key, n)`` adds to one process-wide ``Counter`` (always
on: a few integer adds an image) and ``counters()`` returns a snapshot of it,
with the launches the hand kernels' wrappers have counted.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from collections import Counter, defaultdict

import numpy as np
import torch
from torch.profiler import record_function

__all__ = ["StageTimer", "trace", "mpix_per_s", "device_kernel_times", "device_busy_ms", "stage_self_ms",
           "profile_upscale", "main", "span", "tracing", "count", "counters"]

#: ``upscale``: the request's root; its self time is the host path outside the other stages
SPAN_UPSCALE = "iek.upscale"
#: the input's copy to the device
SPAN_H2D = "iek.h2d"
#: pad, tile extraction and ``im2double`` (patch mode); the 2-D tail tiles' extraction (split)
SPAN_EXTRACT = "iek.extract"
#: one call of the forward: a chunk of tiles, the frame, the body or a tail stripe
SPAN_FORWARD = "iek.forward"
#: ``torch.cat``, ``* 255``, stitch and crop
SPAN_STITCH = "iek.stitch"
#: round, clip and the uint8 cast
SPAN_FINALIZE = "iek.finalize"
#: the wait for the device before the output copy, issued only while a profiler records
SPAN_WAIT = "iek.wait"
#: the output's copy to the host
SPAN_D2H = "iek.d2h"
#: a run of residual blocks inside a forward
SPAN_BLOCK = "iek.block"
#: the TF1 phase upsample inside a forward
SPAN_UPSAMPLE = "iek.upsample"

#: counter keys: images served by ``upscale``, forward calls, the input
#: pixels of the forward calls that start from the image (a chunk of tiles,
#: the frame, split mode's body), and bytes copied to the host
COUNT_IMAGES = "images"
COUNT_FORWARD_CALLS = "forward_calls"
COUNT_FORWARD_PIXELS = "forward_pixels"
COUNT_D2H_BYTES = "d2h_bytes"

_COUNTS: Counter = Counter()
_NO_SPAN = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else a shared no-op context."""
    return record_function(name) if torch.autograd._profiler_enabled() else _NO_SPAN


def count(key: str, n: int = 1) -> None:
    _COUNTS[key] += n


def counters() -> dict[str, int]:
    """A snapshot of the counters, with ``hand_launches``: the launches the
    hand kernels' wrappers have counted in their ``.launches``."""
    from image_enhance_keras_tpu_torch.ops.cuda import hand_launches

    return {**_COUNTS, "hand_launches": hand_launches()}


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
    """(kernel name, device ms, calls) for every kernel, copy and memset the
    profiler saw, longest first; the device's record of a span is not one."""
    spans = _span_names(prof)
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key in spans:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((evt.key, us / 1e3, evt.count))
    return sorted(rows, key=lambda r: -r[1])


def _span_names(prof) -> set[str]:
    """Names of the session's spans (``record_function``), which the profiler
    records on the device's timeline too."""
    return {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}


def device_busy_ms(prof) -> float:
    """Device busy time of the session in ms: the union of the intervals of
    every kernel, copy and memset, so overlapping work counts once."""
    spans = _span_names(prof)
    busy = end = 0.0
    for s, t in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy / 1e3


def stage_self_ms(prof) -> dict[str, float]:
    """Host self time of each ``iek.*`` span in ms, summed over the session:
    its duration less the part of it that its child spans cover."""
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("iek.")),
                   key=lambda v: (v[0], -v[1]))
    out: dict[str, float] = defaultdict(float)
    stack: list = []
    for s, t, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            out[stack[-1][2]] -= t - s
        out[name] += t - s
        stack.append((s, t, name))
    return {k: v / 1e3 for k, v in out.items()}


def _profiled(resolver, img: np.ndarray, iters: int):
    """(wall seconds per image, the profiler) over ``iters`` upscales after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    resolver.upscale(img)  # warm-up: cuDNN algorithm choice, kernel build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(iters):
            resolver.upscale(img)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
    return wall, prof


def profile_upscale(resolver, img: np.ndarray, iters: int) -> tuple[float, list]:
    """Wall seconds per image and the kernel table over ``iters`` upscales."""
    wall, prof = _profiled(resolver, img, iters)
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
        wall, prof = _profiled(res, img, args.iters)
        rows = device_kernel_times(prof)
        busy = device_busy_ms(prof) / args.iters
        kernels = sum(ms for _, ms, _ in rows) / args.iters
        print(f"--forward {forward}: {wall * 1e3:.3f} ms per image wall, {busy:.3f} ms device busy, "
              f"idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
        for name, ms, calls in rows[: args.top]:
            print(f"  {ms / args.iters:9.3f} ms/image {100 * ms / args.iters / kernels:5.1f}%  "
                  f"{calls // args.iters:4d} calls/image  {name[:100]}")
        for name, ms in sorted(stage_self_ms(prof).items(), key=lambda kv: -kv[1]):
            print(f"  {ms / args.iters:9.3f} ms/image host self time of {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
