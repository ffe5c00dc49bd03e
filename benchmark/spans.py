"""The program's own stage spans in the window's trace, and what the span metrics read from them.

The port opens ``torch.profiler`` user annotations named ``iek.*`` while a
profiler records (``image_enhance_keras_tpu_torch/utils/profiling.py``):
``iek.upscale`` around a request, the engine's stages inside it, ``iek.forward``
around each forward call, ``iek.block`` and ``iek.upsample`` inside the
forwards.  One client thread opens them, so they nest on one timeline.
``SpanTrace`` reads them from the window's Chrome trace beside the device's
events:

- each kernel, copy and memset (clipped to the window, as ``DeviceTrace``
  clips it) belongs to the innermost ``iek.*`` span that encloses its launch:
  the start of the host op or span whose ``External id`` it carries (the
  innermost one open on the host when it was launched); one launched outside
  every ``iek.*`` span is unattributed;
- the device's idle time (the window less the union of the device intervals)
  is split by the host's innermost ``iek.*`` span at each instant; the
  engine's idle time is the part under an engine stage (``ENGINE_SPANS``:
  every span but ``iek.forward`` and what it encloses);
- a span's self time is the part of the window in which it is the innermost.

``of(run)`` gives a reader the ``SpanView`` of its run: the ``SpanTrace``, the
roofline least time of the window's forwards by layer group, and the output
bytes the program counted in the window.  A run that carries ``spans`` is read
as it is (the tests build one).  Otherwise the view is built once a run from
what ``harness.run_cell`` holds as locals when it calls the readers: the
profiler, the cell, the set-up and the window, since ``harness._Run`` passes
a reader neither the trace's events nor the window's shapes.  The events
then come from the profiler's own records, put in the Chrome trace's form:
the harness has exported the trace already, and a profiler exports it once.  A
program that opens no ``iek.*`` span gives no view, and its span metrics
read nothing.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import os
import sys
import time
import traceback

from benchmark.devtrace import WINDOW_SPAN

__all__ = ["SpanTrace", "SpanView", "of", "group_bound_s", "ENGINE_SPANS", "GROUPS"]

PREFIX = "iek."
BLOCK_SPAN = "iek.block"
UPSAMPLE_SPAN = "iek.upsample"
D2H_SPAN = "iek.d2h"
ENGINE_SPANS = ("iek.upscale", "iek.h2d", "iek.extract", "iek.stitch", "iek.finalize", "iek.wait", D2H_SPAN)
#: the configuration's layer groups whose device time has a span
GROUPS = {"block": BLOCK_SPAN, "upsample": UPSAMPLE_SPAN}
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_OP_CATS = {"cpu_op", "user_annotation"}


def _timeline(spans) -> tuple[list[float], list[str | None]]:
    """Boundaries and, from each, the innermost span's name (None: no span)
    up to the next boundary.  A span that outlasts its parent is cut at the
    parent's end, so that the spans nest."""
    bounds: list[float] = []
    labels: list[str | None] = []

    def mark(t: float, label: str | None) -> None:
        if bounds and bounds[-1] == t:
            labels[-1] = label
        else:
            bounds.append(t)
            labels.append(label)

    stack: list[tuple[float, str]] = []
    for s, t, name in sorted(spans, key=lambda v: (v[0], -v[1])):
        while stack and stack[-1][0] <= s:
            end, _ = stack.pop()
            mark(end, stack[-1][1] if stack else None)
        if stack:
            t = min(t, stack[-1][0])
        if t > s:
            stack.append((t, name))
            mark(s, name)
    while stack:
        end, _ = stack.pop()
        mark(end, stack[-1][1] if stack else None)
    return bounds, labels


def _by_label(intervals, bounds, labels) -> dict:
    """The length of each interval, split by the label of the timeline under it."""
    edges = [-math.inf] + bounds + [math.inf]
    labs = [None] + labels
    out: dict = collections.defaultdict(float)
    for a, b in intervals:
        i = bisect.bisect_right(edges, a) - 1
        while edges[i] < b:
            lo, hi = max(a, edges[i]), min(b, edges[i + 1])
            if hi > lo:
                out[labs[i]] += hi - lo
            i += 1
    return out


def _union(intervals) -> list[tuple[float, float]]:
    segs: list[list[float]] = []
    for s, t in sorted(intervals):
        if segs and s <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], t)
        else:
            segs.append([s, t])
    return [(s, t) for s, t in segs]


class SpanTrace:
    """The ``iek.*`` spans of one window and the device's time by span.

    Seconds: ``window_s``; ``device_s`` (device time launched inside each
    innermost span, None for none), ``device_total_s``, ``engine_device_s``,
    ``unattributed_s``; ``idle_s`` (device idle time by the host's innermost
    span), ``engine_idle_s``; ``span_s`` (summed duration of each span in the
    window), ``self_s`` (its self time); ``span_n`` (spans of each name);
    ``n_spans``, ``n_device``, ``n_unmatched`` (device events whose launching
    op is not in the trace)."""

    def __init__(self, events: list[dict]):
        win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
               and str(e.get("cat", "")).lower() == "user_annotation"]
        if not win:
            raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        spans, dev = [], []
        launches: dict = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            name = str(e.get("name", ""))
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in _OP_CATS:
                if cat == "user_annotation" and name.startswith(PREFIX):
                    spans.append((s, t, name))
                if "External id" in args:
                    launches.setdefault(args["External id"], s)
            elif cat in _DEVICE_CATS:
                s, t = max(s, w0), min(t, w1)
                if t > s:
                    dev.append((s, t, args.get("External id")))
        self.n_spans = len(spans)
        self.n_device = len(dev)
        bounds, labels = _timeline(spans)
        self.device_s: dict = collections.defaultdict(float)
        self.n_unmatched = 0
        for s, t, ext in dev:
            at = launches.get(ext)
            if at is None:
                self.n_unmatched += 1
                label = None
            else:
                i = bisect.bisect_right(bounds, at) - 1
                label = labels[i] if i >= 0 else None
            self.device_s[label] += (t - s) * 1e-6
        self.device_total_s = sum(self.device_s.values())
        self.unattributed_s = self.device_s.get(None, 0.0)
        self.engine_device_s = sum(v for k, v in self.device_s.items() if k in ENGINE_SPANS)
        busy = _union((s, t) for s, t, _ in dev)
        edges = [w0] + [v for st in busy for v in st] + [w1]
        idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        self.idle_s = {k: v * 1e-6 for k, v in _by_label(idle, bounds, labels).items()}
        self.engine_idle_s = sum(v for k, v in self.idle_s.items() if k in ENGINE_SPANS)
        self.self_s = {k: v * 1e-6 for k, v in _by_label([(w0, w1)], bounds, labels).items() if k is not None}
        self.span_s: dict = collections.defaultdict(float)
        self.span_n: dict = collections.Counter()
        for s, t, name in spans:
            if min(t, w1) > max(s, w0):
                self.span_s[name] += (min(t, w1) - max(s, w0)) * 1e-6
                self.span_n[name] += 1


@dataclasses.dataclass
class SpanView:
    """What the span metrics read: the window's ``SpanTrace``, the roofline
    least time of the window's forwards by layer group (``bound_s``), and the
    bytes the program copied to the host in the window (``d2h_bytes``, None
    when the program counts none)."""

    trace: SpanTrace
    bound_s: dict
    d2h_bytes: int | None


def group_bound_s(cell, shapes: dict, group: str) -> float:
    """The roofline least time of the layers of ``group`` over the forwards of
    the images ``shapes`` ({(h, w): count}), counted as ``harness.window_work``
    counts every layer."""
    from benchmark import harness

    layers = [lay for lay in cell.config["layers"] if lay["group"] == group]
    return harness.window_work(dataclasses.replace(cell, config={**cell.config, "layers": layers}), shapes)["bound_s"]


_LAST: list = [None, None]  # the last run asked for and its view: five readers, one reading


def of(run) -> SpanView | None:
    """The span view of ``run``, or None when there is nothing to read."""
    given = getattr(run, "spans", None)
    if given is not None:
        return given
    if run.trace is None or run.trace.n_device == 0:
        return None
    if _LAST[0] is run:
        return _LAST[1]
    view = None
    loc = _run_cell_locals()
    if loc is not None:
        try:
            view = _view(loc, run)
        except Exception:  # a span metric that cannot be read must not end the run: report it
            _log("span metrics: could not read the spans:\n" + traceback.format_exc())
    _LAST[:] = [run, view]
    return view


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _run_cell_locals() -> dict | None:
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run_cell" and f.f_code.co_filename.endswith(os.path.join("benchmark", "harness.py")):
            loc = f.f_locals
            return loc if all(k in loc for k in ("prof", "cell", "s", "w")) else None
        f = f.f_back
    return None


def _events(prof) -> list[dict]:
    """The profiler's own records in the Chrome trace's form: host ops and
    spans with their correlation id as ``External id``, each device event
    with its launching op's (its linked correlation id).  The runtime calls
    are left out: their op stands for the launch."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    out = []
    for e in prof.profiler.kineto_results.events():
        linked = e.linked_correlation_id()
        device = e.device_type()
        name = e.name()
        if device == DeviceType.CPU and not linked:
            cat = "user_annotation" if e.is_user_annotation() else "cpu_op"
            ext = e.correlation_id()
        elif device == DeviceType.CUDA and linked and not e.is_user_annotation() and not name.startswith(
                (PREFIX, "benchmark.", "[memory]")):
            cat = "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
            ext = linked
        else:
            continue
        out.append({"ph": "X", "cat": cat, "name": name, "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3,
                    "args": {"External id": ext}})
    _log(f"span metrics: {len(out)} events from the profiler in {time.perf_counter() - t0:.3f} s")
    return out


def _window_counts(cell, s, w, run) -> int | None:
    """The program's output bytes in the window: its counters less what the
    set-up's warm-up images added, with the forwards' input pixels checked
    against the benchmark's own count.  None when the program counts nothing."""
    from benchmark import harness
    from image_enhance_keras_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    warm = collections.Counter(tuple(s.traffic.image(i).shape[:2])
                               for i in range(int(cell.workload.get("warmup", 1))))
    scale = int(cell.config["model_kwargs"].get("scale", 4))
    warm_px = harness.window_work(cell, warm)["pixels"]
    px = int(c.get("forward_pixels", 0)) - warm_px
    d2h = int(c.get("d2h_bytes", 0)) - sum(n * 3 * scale * scale * h * ww for (h, ww), n in warm.items())
    _log(f"span metrics: forward input pixels in the window, the program's count {px}, the benchmark's "
         f"{run.work['pixels']} ({'equal' if px == run.work['pixels'] else 'DIFFERENT: the counts are stale'}); "
         f"images {int(c.get('images', 0)) - sum(warm.values())} of {w.attempted} attempted; output bytes "
         f"{d2h} (the window's outputs: {3 * w.out_pixels}); hand kernel launches {c.get('hand_launches')} "
         f"in the process")
    return d2h


def _view(loc: dict, run) -> SpanView | None:
    prof, cell, s, w = loc["prof"], loc["cell"], loc["s"], loc["w"]
    tr = SpanTrace(_events(prof))
    if tr.n_spans == 0:
        _log("span metrics: the window's trace holds no iek.* span (a program without spans): none is read")
        return None
    view = SpanView(tr, {g: group_bound_s(cell, w.shapes, g) for g in GROUPS}, _window_counts(cell, s, w, run))
    n = max(1, tr.span_n.get("iek.upscale", 0))

    def ms(v: float) -> str:
        return f"{1e3 * v / n:.3f}"

    _log(f"span metrics: {tr.n_spans} spans, {tr.n_device} device events ({tr.n_unmatched} without their "
         f"launching op); device time {tr.device_total_s:.6f} s, unattributed to an iek.* span "
         f"{tr.unattributed_s:.6f} s ({100 * tr.unattributed_s / max(tr.device_total_s, 1e-12):.3f}%)")
    names = sorted(set(tr.self_s) | {k for k in tr.device_s if k}, key=lambda k: -tr.self_s.get(k, 0.0))
    _log("span metrics, ms an image by innermost span (host self / device launched / device idle): "
         + "; ".join(f"{k} {ms(tr.self_s.get(k, 0.0))} / {ms(tr.device_s.get(k, 0.0))} / {ms(tr.idle_s.get(k, 0.0))}"
                     for k in names)
         + f"; no span - / {ms(tr.device_s.get(None, 0.0))} / {ms(tr.idle_s.get(None, 0.0))}")
    _log(f"span metrics: roofline least time in the window, block {view.bound_s['block']:.6f} s, upsample "
         f"{view.bound_s['upsample']:.6f} s; device time in the Chrome trace's reading {run.trace.total_s:.6f} s")
    return view
