"""What the device did in the measured window, read from a ``torch.profiler`` Chrome trace.

The window is the span the harness records around it
(``record_function("benchmark.window")``).  Device events are kernels,
memory copies and memsets; each is clipped to the window.  The busy time
is the union of their intervals (overlapping launches and copies count
once); the idle share is the rest of the window.  Glue is the work of
PyTorch's own kernels (``at::native`` elementwise, copy, cat, index, pad
and reduce kernels, and the cub reductions torch ships) and every memcpy
and memset: tile extraction and stitching, casts, the finalize, the host
copies.  Every other kernel (the port's hand kernels under any name,
cuDNN's) is compute.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["DeviceTrace", "is_glue", "WINDOW_SPAN", "IMAGE_SPAN"]

WINDOW_SPAN = "benchmark.window"
IMAGE_SPAN = "benchmark.upscale"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_CATS = {"cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver"}
_GLUE_NAMES = ("at::native::", "at_cuda_detail::")


def is_glue(name: str, cat: str) -> bool:
    """PyTorch's own kernels, copies and memsets."""
    return cat != "kernel" or any(g in name for g in _GLUE_NAMES)


class DeviceTrace:
    """Device intervals of one window: ``n_device``, ``window_s``,
    ``busy_s`` (union), ``total_s``, ``glue_s`` and ``compute_s`` (sums of
    durations), and for the breakdown ``top_ops`` and ``idle_gaps``."""

    def __init__(self, events: list[dict]):
        win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
               and str(e.get("cat", "")).lower() == "user_annotation"]
        if not win:
            raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            if cat in _DEVICE_CATS:
                s, t = max(s, w0), min(t, w1)
                if t > s:
                    dev.append((s, t, str(e.get("name", "")), cat))
            elif cat in _HOST_CATS and e.get("name") != WINDOW_SPAN and t > w0 and s < w1:
                host.append((s, t, str(e.get("name", ""))))
        self.n_device = len(dev)
        self.total_s = sum(t - s for s, t, _, _ in dev) * 1e-6
        self.glue_s = sum(t - s for s, t, n, c in dev if is_glue(n, c)) * 1e-6
        self.compute_s = self.total_s - self.glue_s
        by_name: dict[str, float] = {}
        for s, t, n, _ in dev:
            by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
        self.top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        segs = self._union(dev)
        self.busy_s = sum(t - s for s, t in segs) * 1e-6
        self.idle_gaps = self._gaps(segs, w0, w1, host)

    @staticmethod
    def _union(dev) -> list[tuple[float, float]]:
        segs: list[list[float]] = []
        for s, t, _, _ in sorted(dev):
            if segs and s <= segs[-1][1]:
                segs[-1][1] = max(segs[-1][1], t)
            else:
                segs.append([s, t])
        return [(s, t) for s, t in segs]

    @staticmethod
    def _gaps(segs, w0: float, w1: float, host, longest: int = 500) -> list[tuple[str, float]]:
        """The idle time of the ``longest`` gaps, summed by what the host was
        doing at each gap's middle (its innermost span), the ten largest."""
        edges = [w0] + [v for st in segs for v in st] + [w1]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]
        gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:longest]
        if host:
            hs = np.array([h[0] for h in host])
            he = np.array([h[1] for h in host])
        by_label: dict[str, float] = {}
        for d, s, t in gaps:
            label = "(no host span)"
            if host:
                m = 0.5 * (s + t)
                idx = np.nonzero((hs <= m) & (he >= m))[0]
                if idx.size:
                    label = host[int(idx[np.argmax(hs[idx])])][2]
            by_label[label] = by_label.get(label, 0.0) + d * 1e-6
        return sorted(by_label.items(), key=lambda kv: -kv[1])[:10]

    @classmethod
    def from_file(cls, path: str) -> "DeviceTrace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)
