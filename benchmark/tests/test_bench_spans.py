"""The program's spans in a synthetic Chrome trace, the span metrics read from
them, and the program's count of forward input pixels against the benchmark's."""

import collections
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from benchmark import counting, harness, spans  # noqa: E402
from benchmark.devtrace import WINDOW_SPAN, DeviceTrace  # noqa: E402

SPAN_METRICS = ("engine_idle_share", "engine_device_share", "d2h_gbps", "block_roofline", "upsample_roofline")


def _x(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _launch(ts, ext, device_cat, start, dur, name="k"):
    """A host op at ``ts`` and the device event it launched, sharing the ``External id`` ``ext``."""
    return [_x("aten::op", "cpu_op", ts, 5.0, **{"External id": ext}),
            _x(name, device_cat, start, dur, **{"External id": ext})]


def _trace(with_spans=True):
    """A 1000 us window.  Host spans: iek.upscale 50-950 holding iek.h2d
    60-100, iek.forward 120-600 (iek.block 130-400, iek.upsample 400-450),
    iek.stitch 600-650, iek.finalize 650-680, iek.wait 680-700, iek.d2h
    700-900.  Device: H2D 80-110, a block kernel 150-450, K3 450-500, the out
    conv 500-560 (launched in the forward), glue 620-640 and 660-670, D2H
    710-810, a kernel 970-990 launched outside every iek.* span,
    and one 20-30 whose launch is not in the trace."""
    ev = [_x(WINDOW_SPAN, "user_annotation", 0.0, 1000.0), _x("benchmark.upscale", "user_annotation", 40.0, 955.0)]
    if with_spans:
        ev += [_x(n, "user_annotation", s, d) for n, s, d in [
            ("iek.upscale", 50.0, 900.0), ("iek.h2d", 60.0, 40.0), ("iek.forward", 120.0, 480.0),
            ("iek.block", 130.0, 270.0), ("iek.upsample", 400.0, 50.0), ("iek.stitch", 600.0, 50.0),
            ("iek.finalize", 650.0, 30.0), ("iek.wait", 680.0, 20.0), ("iek.d2h", 700.0, 200.0)]]
    ev += _launch(70.0, 1, "gpu_memcpy", 80.0, 30.0, "Memcpy HtoD (Pageable -> Device)")
    ev += _launch(140.0, 2, "kernel", 150.0, 300.0, "xla_block_kernel<0>")
    ev += _launch(410.0, 3, "kernel", 450.0, 50.0, "upsample_phase_tf1_kernel")
    ev += _launch(460.0, 4, "kernel", 500.0, 60.0, "sm90_xmma_fprop")
    ev += _launch(610.0, 5, "kernel", 620.0, 20.0, "at::native::elementwise_kernel")
    ev += _launch(655.0, 6, "kernel", 660.0, 10.0, "at::native::round_kernel")
    ev += _launch(705.0, 7, "gpu_memcpy", 710.0, 100.0, "Memcpy DtoH (Device -> Pageable)")
    ev += _launch(960.0, 8, "kernel", 970.0, 20.0, "at::native::fill_kernel")
    ev.append(_x("orphan_kernel", "kernel", 20.0, 10.0, **{"External id": 99}))
    return ev


def test_span_trace_by_hand():
    t = spans.SpanTrace(_trace())
    us = 1e-6
    assert t.window_s == pytest.approx(1000 * us)
    assert t.n_spans == 9 and t.n_device == 9 and t.n_unmatched == 1
    assert t.device_total_s == pytest.approx(600 * us)
    want_dev = {None: 30, "iek.h2d": 30, "iek.block": 300, "iek.upsample": 50, "iek.forward": 60,
                "iek.stitch": 20, "iek.finalize": 10, "iek.d2h": 100}
    assert {k: v / us for k, v in t.device_s.items()} == pytest.approx(want_dev)
    assert t.unattributed_s == pytest.approx(30 * us)
    assert t.engine_device_s == pytest.approx(160 * us)
    # idle 400 us: 0-20, 30-80, 110-150, 560-620, 640-660, 670-710, 810-970, 990-1000
    want_idle = {None: 70, "iek.upscale": 70, "iek.h2d": 20, "iek.forward": 50, "iek.block": 20,
                 "iek.stitch": 30, "iek.finalize": 20, "iek.wait": 20, "iek.d2h": 100}
    assert {k: v / us for k, v in t.idle_s.items()} == pytest.approx(want_idle)
    assert t.engine_idle_s == pytest.approx(260 * us)
    assert t.self_s["iek.upscale"] == pytest.approx(80 * us)  # 50-60, 100-120, 900-950
    assert t.self_s["iek.forward"] == pytest.approx(160 * us)  # 120-130, 450-600
    assert sum(t.self_s.values()) == pytest.approx(900 * us)
    assert t.span_s["iek.d2h"] == pytest.approx(200 * us) and t.span_n["iek.forward"] == 1


def _run(events, view):
    run = harness._Run(DeviceTrace(events), {"ops_s": 2e-4, "bound_s": 3e-4, "pixels": 0}, 1e-3)
    if view is not None:
        run.spans = view
    return run


def _read(run):
    cell = harness.load_cell("didbl-int8-fast512")
    return {m: harness.metric_reader(cell, m).read(run) for m in SPAN_METRICS}


def test_span_metrics_on_synthetic_trace():
    view = spans.SpanView(spans.SpanTrace(_trace()), {"block": 150e-6, "upsample": 40e-6}, 4000)
    v = _read(_run(_trace(), view))
    assert v["engine_idle_share"] == pytest.approx(26.0)
    assert v["engine_device_share"] == pytest.approx(100 * 160 / 600)
    assert v["d2h_gbps"] == pytest.approx(4000 / 200e-6 / 1e9)
    assert v["block_roofline"] == pytest.approx(50.0)
    assert v["upsample_roofline"] == pytest.approx(80.0)


def test_no_spans_reads_nothing():
    events = _trace(with_spans=False)
    assert spans.SpanTrace(events).n_spans == 0
    assert all(v is None for v in _read(_run(events, None)).values())  # outside run_cell: no view
    assert spans.of(_run(events, None)) is None


class _Record:
    """Stands for one of the profiler's records (a ``KinetoEvent``)."""

    def __init__(self, name, ts, dur, host, annotation, corr, linked):
        from torch.autograd import DeviceType

        self.name = lambda: name
        self.start_ns = lambda: int(1e3 * ts)
        self.duration_ns = lambda: int(1e3 * dur)
        self.device_type = lambda: DeviceType.CPU if host else DeviceType.CUDA
        self.is_user_annotation = lambda: annotation
        self.correlation_id = lambda: corr
        self.linked_correlation_id = lambda: linked


class _Prof:
    """Stands for the profiler: its records of Chrome trace events, each op,
    span and device event, and a runtime launch call (a host record linked
    to its op) beside each op."""

    def __init__(self, events):
        records = []
        for i, e in enumerate(events):
            ext = (e.get("args") or {}).get("External id", 10_000 + i)
            host = e["cat"] in ("cpu_op", "user_annotation")
            records.append(_Record(e["name"], e["ts"], e["dur"], host, e["cat"] == "user_annotation",
                                   ext if host else 20_000 + i, 0 if host else ext))
            if e["cat"] == "cpu_op":
                records.append(_Record("cudaLaunchKernel", e["ts"] + 1, 2.0, True, False, 30_000 + i, ext))
        self.profiler = types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: records))


class _Traffic:
    def image(self, i):
        return np.zeros((512, 512, 3), np.uint8)


def _locals(events, n_images=3):
    cell = harness.load_cell("didbl-int8-fast512")
    setup = harness.Setup(_Traffic(), {}, None, None, 0.035)
    window = harness.Window(0.1, [0.03] * n_images, n_images * 2048 * 2048, n_images, n_images, 0,
                            {(512, 512): n_images}, {})
    return {"prof": _Prof(events), "cell": cell, "s": setup, "w": window}


def test_view_from_run_cell_locals():
    """The view built as ``of`` builds it inside ``run_cell``: the group
    bounds of the window's forwards, and none for a trace without spans."""
    loc = _locals(_trace())
    run = _run(_trace(), None)
    view = spans._view(loc, run)
    cell = loc["cell"]
    per_image = {g: counting.image_work(dict(cell.config, layers=[x for x in cell.config["layers"] if x["group"] == g]),
                                        "int8", 512 * 512, counting.load_peaks())["bound_s"] for g in spans.GROUPS}
    assert view.bound_s == pytest.approx({g: 3 * v for g, v in per_image.items()})
    assert view.trace.device_s == pytest.approx(spans.SpanTrace(_trace()).device_s)
    assert view.trace.idle_s == pytest.approx(spans.SpanTrace(_trace()).idle_s)
    assert spans._view(_locals(_trace(with_spans=False)), run) is None


def test_events_of_a_cpu_profiler():
    """The profiler's parsed events, as ``of`` reads them after the harness has
    exported the trace: the program's spans inside the window, with their self times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from image_enhance_keras_tpu_torch.engine import SuperResolver

    res = SuperResolver(model="didbl", model_kwargs=_NARROW["didbl"], device="cpu", mode="fast")
    img = np.zeros((16, 16, 3), np.uint8)
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW_SPAN):
            res.upscale(img)
    t = spans.SpanTrace(spans._events(prof))
    assert t.n_device == 0 and t.span_n["iek.upscale"] == 1 and t.span_n["iek.forward"] == 1
    assert {"iek.h2d", "iek.block", "iek.upsample", "iek.d2h"} <= set(t.self_s)
    assert sum(t.self_s.values()) == pytest.approx(t.span_s["iek.upscale"])


@pytest.mark.parametrize("cell_name", ["didbl-int8-fast512", "difv4-int8-fast512", "didbl-f32-patch"])
def test_group_bounds_add_up(cell_name):
    cell = harness.load_cell(cell_name)
    shapes = collections.Counter({tuple(hw): 2 for hw in cell.traffic["sizes"]})
    groups = {lay["group"] for lay in cell.config["layers"]}
    total = sum(spans.group_bound_s(cell, shapes, g) for g in groups)
    assert total == pytest.approx(harness.window_work(cell, shapes)["bound_s"])
    assert spans.group_bound_s(cell, shapes, "block") > 0.5 * total


_NARROW = {"didbl": dict(features=4, n_body53=1, n_light=1, n_tail53=1),
           "difv4": dict(features=4, n_head=1, n_mid=1, n_tail=1)}


@pytest.mark.parametrize("cell_name,sizes", [
    ("didbl-int8-fast512", [(40, 56)]),
    ("difv4-int8-fast512", [(32, 24)]),
    ("didbl-f32-patch", [(96, 96), (100, 130), (330, 140)]),  # 4, 9 and 18 tiles: 16 and a remainder
])
def test_program_forward_pixels_match_counting(cell_name, sizes):
    """The program's ``forward_pixels`` and ``forward_calls`` for each cell's
    mode and geometry (a narrow model on the CPU) equal ``counting.forward_calls``."""
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.utils import profiling

    cell = harness.load_cell(cell_name)
    r = cell.resolver
    res = SuperResolver(model=cell.config["model"], model_kwargs=_NARROW[cell.config["model"]], device="cpu",
                        forward="xla", mode=r["mode"], tile_chunk=int(r.get("tile_chunk", 16)),
                        **{k: r[k] for k in ("patch", "step", "crop") if k in r})
    for h, w in sizes:
        want = counting.forward_calls(h, w, r["mode"], tile_chunk=int(r.get("tile_chunk", 16)), **cell.geometry)
        before = profiling.counters()
        res.upscale(np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8))
        after = profiling.counters()
        assert after["forward_pixels"] - before.get("forward_pixels", 0) == sum(want)
        assert after["forward_calls"] - before.get("forward_calls", 0) == len(want)
